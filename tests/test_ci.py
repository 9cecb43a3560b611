"""ANI confidence intervals (est_ci) — engine, API and CLI surface.

The reference pins ``CommandParams.est_ci`` to its default-off value
(/root/reference/src/pyskani/_skani/lib.rs:592); skani itself exposes it
as ``--ci`` ([5%, 95%] percentile bootstrap over per-fragment ANIs).
These tests pin the device engine's implementation: deterministic, bounds
bracket the mean, off by default.
"""

import numpy as np
import pytest

import pyskani_tpu
from pyskani_tpu import cli
from conftest import mutate, random_genome


@pytest.fixture(scope="module")
def db_and_query():
    rng = np.random.default_rng(23)
    base = random_genome(rng, 120_000)
    db = pyskani_tpu.Database()
    db.sketch("ref", base)
    return db, mutate(rng, base, 0.02)


def test_ci_off_by_default(db_and_query):
    db, q = db_and_query
    hits = db.query("q", q, learned_ani=False)
    assert len(hits) == 1
    assert hits[0].ci_low is None and hits[0].ci_high is None


def test_ci_brackets_mean(db_and_query):
    db, q = db_and_query
    hits = db.query("q", q, learned_ani=False, est_ci=True)
    assert len(hits) == 1
    h = hits[0]
    assert h.ci_low is not None and h.ci_high is not None
    assert 0.0 < h.ci_low <= h.identity <= h.ci_high <= 1.0
    # a 2%-mutated 120 kb genome has ~6 fragments; the CI should be
    # informative but not degenerate
    assert h.ci_high - h.ci_low < 0.05


def test_ci_deterministic(db_and_query):
    db, q = db_and_query
    a = db.query("q", q, learned_ani=False, est_ci=True)[0]
    b = db.query("q", q, learned_ani=False, est_ci=True)[0]
    assert (a.ci_low, a.ci_high) == (b.ci_low, b.ci_high)


def test_hit_ci_validation():
    with pytest.raises(ValueError):
        pyskani_tpu.Hit(0.9, "q", 0.9, "r", 0.9, ci_low=1.5)
    h = pyskani_tpu.Hit(0.9, "q", 0.9, "r", 0.9, ci_low=0.88, ci_high=0.92)
    assert h.ci_low == pytest.approx(0.88)


@pytest.fixture(scope="module")
def fasta_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("ci_fasta")
    rng = np.random.default_rng(7)
    base = random_genome(rng, 80_000)
    (d / "a.fa").write_bytes(b">a\n" + base + b"\n")
    (d / "b.fa").write_bytes(b">b\n" + mutate(rng, base, 0.02) + b"\n")
    return str(d / "a.fa"), str(d / "b.fa")


def test_cli_dist_ci_columns(fasta_pair, capsys):
    a, b = fasta_pair
    rc = cli.main(["dist", "-q", b, "-r", a, "--learned-ani", "no", "--ci"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].endswith("ANI_5_percentile\tANI_95_percentile")
    row = lines[1].split("\t")
    assert len(row) == 7
    lo, ani, hi = float(row[5]), float(row[2]), float(row[6])
    assert lo <= ani <= hi


def test_cli_output_file(fasta_pair, tmp_path):
    a, b = fasta_pair
    out = tmp_path / "res.tsv"
    rc = cli.main(["dist", "-q", b, "-r", a, "--learned-ani", "no",
                   "-o", str(out)])
    assert rc == 0
    text = out.read_text()
    assert text.startswith("Ref_file\t")
    assert len(text.strip().splitlines()) == 2


def test_cli_max_results(fasta_pair, tmp_path, capsys):
    a, b = fasta_pair
    # two references, cap at 1 result
    rc = cli.main(["dist", "-q", b, "-r", a, b, "--learned-ani", "no",
                   "-n", "1"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2  # header + best hit only
    assert float(lines[1].split("\t")[2]) > 99.0  # self-ish match wins


def test_cli_triangle_full_matrix(fasta_pair, capsys):
    a, b = fasta_pair
    rc = cli.main(["triangle", a, b, "--full-matrix", "--learned-ani", "no"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "2"
    assert lines[1].split("\t")[0] == "a.fa"
    row2 = lines[2].split("\t")
    assert row2[0] == "b.fa"
    assert float(row2[1]) > 90.0     # off-diagonal ANI percent
    assert float(row2[2]) == 100.0   # diagonal


def test_cli_triangle_distance(fasta_pair, capsys):
    a, b = fasta_pair
    rc = cli.main(["triangle", a, b, "--distance", "--learned-ani", "no"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    d = float(lines[1].split("\t")[2])
    assert 0.0 < d < 10.0            # 100 - ANI for a ~98% pair
