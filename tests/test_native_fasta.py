"""Native (C++) FASTA reader parity vs the pure-Python parser.

Skipped when no C++ toolchain / prebuilt .so is available (the CLI falls
back transparently, cli.py).
"""

import gzip

import numpy as np
import pytest

from pyskani_tpu.io import native
from pyskani_tpu.io.fasta import parse

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native reader not built")


@pytest.fixture()
def multi_fasta(tmp_path):
    rng = np.random.default_rng(21)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    contigs = [rng.choice(acgt, size=n).tobytes() for n in (5000, 130, 7001)]
    # mixed-case, wrapped lines, comments and blank lines
    lines = [b"; leading comment"]
    for i, seq in enumerate(contigs):
        lines.append(f">contig{i} description {i}".encode())
        body = seq.lower() if i == 1 else seq
        lines += [body[j:j + 61] for j in range(0, len(body), 61)]
        lines.append(b"")
    path = tmp_path / "multi.fa"
    path.write_bytes(b"\n".join(lines) + b"\n")
    return path, contigs


def test_native_matches_python(multi_fasta):
    path, contigs = multi_fasta
    out = native.read_genome_native(path)
    assert out is not None
    seq, starts, names = out

    records = list(parse(str(path)))
    assert names == [r.id for r in records]
    assert len(starts) == len(contigs) + 1
    for i, r in enumerate(records):
        got = seq[starts[i]:starts[i + 1]].tobytes()
        assert got.upper() == r.seq.upper() == contigs[i]


def test_native_min_contig_filter(multi_fasta):
    path, contigs = multi_fasta
    out = native.read_genome_native(path, min_contig_len=1000)
    assert out is not None
    seq, starts, names = out
    keep = [c for c in contigs if len(c) >= 1000]
    assert len(names) == len(keep)
    for i, c in enumerate(keep):
        assert seq[starts[i]:starts[i + 1]].tobytes().upper() == c


def test_native_missing_file(tmp_path):
    assert native.read_genome_native(tmp_path / "nope.fa") is None
