"""Arbitrary-k sketching, the seed kwarg, and API-parity details.

Generalised k, the seed kwarg, the save() signature and Sketch wiring.
"""

import dataclasses

import numpy as np
import pytest

import pyskani_tpu
from pyskani_tpu.oracle.chain import ChainConfig, chain_seeds
from pyskani_tpu.oracle.seeding import sketch_genome
from pyskani_tpu.params import SketchParams


def _pair(rng, n=60000, subs=600):
    acgt = np.frombuffer(b"ACGT", np.uint8)
    a = rng.choice(acgt, size=n)
    b = a.copy()
    idx = rng.integers(0, n, subs)
    b[idx] = rng.choice(acgt, size=subs)
    return a.tobytes(), b.tobytes()


@pytest.mark.parametrize("k", [11, 13, 16])
def test_seed_table_matches_oracle_small_k(k):
    """For 2k <= 32 the device seed table must EXACTLY match the oracle
    (same canonical k-mers, positions, strands)."""
    from pyskani_tpu.ops.sketch import sketch_genome_device

    rng = np.random.default_rng(5)
    g, _ = _pair(rng)
    params = SketchParams(k=k)
    host = sketch_genome_device("g", [g], params)
    dev = host.device
    n = int(dev.n_seeds)
    oracle = sketch_genome("g", [g], params)
    assert n == len(oracle.kmers)
    np.testing.assert_array_equal(np.asarray(dev.kmers[:n], np.uint64),
                                  oracle.kmers & np.uint64(0xFFFFFFFF))
    np.testing.assert_array_equal(np.asarray(dev.positions[:n]),
                                  oracle.positions)
    np.testing.assert_array_equal(np.asarray(dev.strands[:n]),
                                  oracle.strands)


@pytest.mark.parametrize("k", [17, 21])
def test_ani_matches_oracle_large_k(k):
    """For k > 16 the device uses 32-bit hash fingerprints as seed keys;
    ANI/AF must still match the full-width oracle (collisions are
    ~N^2/2^33 per sketch — nil at this scale)."""
    rng = np.random.default_rng(6)
    a, b = _pair(rng)
    db = pyskani_tpu.Database(k=k)
    db.sketch("a", a)
    hits = db.query("b", b, learned_ani=False)
    assert len(hits) == 1

    params = SketchParams(k=k)
    cfg = dataclasses.replace(ChainConfig(), k=k, extend_right=k - 1)
    r = sketch_genome("a", [a], params)
    q = sketch_genome("b", [b], params)
    res = chain_seeds(r, q, cfg)
    assert hits[0].identity == pytest.approx(res.ani, abs=1e-4)
    assert hits[0].query_fraction == pytest.approx(
        res.align_fraction_query, abs=1e-4)
    assert hits[0].reference_fraction == pytest.approx(
        res.align_fraction_ref, abs=1e-4)


def test_database_k21_roundtrip(tmp_path):
    """Database(k=21) works end-to-end incl. persistence."""
    rng = np.random.default_rng(7)
    a, b = _pair(rng)
    db = pyskani_tpu.Database(tmp_path / "db", k=21)
    db.sketch("a", a)
    db.flush()
    re = pyskani_tpu.Database.open(tmp_path / "db")
    hits = re.query("b", b, learned_ani=False)
    assert len(hits) == 1 and hits[0].identity > 0.97


def test_invalid_k_rejected():
    with pytest.raises(ValueError):
        pyskani_tpu.Database(k=3)
    with pytest.raises(ValueError):
        pyskani_tpu.Database(k=40)


def test_seed_false_reference():
    """A reference sketched with seed=False screens but never chains
    (no seed positions recorded — reference lib.rs:474-475)."""
    rng = np.random.default_rng(8)
    a, b = _pair(rng)
    db = pyskani_tpu.Database()
    db.sketch("a", a, seed=False)
    assert db.query("b", b, learned_ani=False) == []
    # a position-carrying sketch in the same db still hits
    db.sketch("a2", a)
    hits = db.query("b", b, learned_ani=False)
    assert [h.reference_name for h in hits] == ["a2"]


def test_seed_false_query():
    rng = np.random.default_rng(9)
    a, b = _pair(rng)
    db = pyskani_tpu.Database()
    db.sketch("a", a)
    assert db.query("b", b, seed=False, learned_ani=False) == []


def test_sketch_wrapper():
    """pyskani_tpu.Sketch parity surface (sketch.rs:4-38 getters)."""
    rng = np.random.default_rng(10)
    a, _ = _pair(rng)
    db = pyskani_tpu.Database()
    sk = db._sketch("gen", [a])
    assert isinstance(sk, pyskani_tpu.Sketch)
    assert sk.name == "gen"
    assert sk.c == 125
    assert sk.amino_acid is False
    assert "gen" in repr(sk)


def test_save_signature_runtime_parity(tmp_path):
    """save() positional order matches the reference RUNTIME signature
    `(path, overwrite=false, format=None)` (lib.rs:663; the reference's
    own .pyi stub omits overwrite and disagrees with its runtime)."""
    rng = np.random.default_rng(11)
    a, _ = _pair(rng)
    db = pyskani_tpu.Database()
    db.sketch("a", a)
    db.save(tmp_path / "d1", False, "separated")     # positional, runtime order
    assert (tmp_path / "d1" / "a.sketch").exists()
    with pytest.raises(FileExistsError):
        db.save(tmp_path / "d1")
    db.save(tmp_path / "d1", True)                   # overwrite positional


def test_asymmetric_lengths_match_oracle():
    """A reference much longer than the query: the ref-side estimation
    grid (est_side='both') must not truncate — Database results equal
    the oracle."""
    rng = np.random.default_rng(12)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    long_ref = rng.choice(acgt, size=300_000)
    short_q = long_ref[:40_000].copy()
    idx = rng.integers(0, len(short_q), 400)
    short_q[idx] = rng.choice(acgt, size=400)
    ref_b, q_b = long_ref.tobytes(), short_q.tobytes()

    db = pyskani_tpu.Database()
    db.sketch("r", ref_b)
    hits = db.query("q", q_b, learned_ani=False)
    assert len(hits) == 1

    params = SketchParams()
    cfg = ChainConfig()
    r = sketch_genome("r", [ref_b], params)
    q = sketch_genome("q", [q_b], params)
    res = chain_seeds(r, q, cfg)
    assert hits[0].identity == pytest.approx(res.ani, abs=2e-6)
    assert hits[0].query_fraction == pytest.approx(
        res.align_fraction_query, abs=2e-6)
    assert hits[0].reference_fraction == pytest.approx(
        res.align_fraction_ref, abs=2e-6)
