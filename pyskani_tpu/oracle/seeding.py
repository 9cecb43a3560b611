"""NumPy oracle for FracMinHash seeding (spec for the Pallas kernels).

Re-implements the behaviour of ``skani::seeding::fmh_seeds`` as invoked by
the reference at /root/reference/src/pyskani/_skani/lib.rs:165-171: the
contig is scanned with a rolling 2-bit encoding; the canonical k-mer at
every position is hashed with an invertible 64-bit mix, and kept iff
``hash < u64::MAX / c`` (FracMinHash).  Marker k-mers use a longer k and the
heavier ``marker_c`` compression; they form the screening sketch that
``Sketch::get_markers_only`` derives (lib.rs:495).

Everything here is vectorised NumPy — this module is the *semantic oracle*
against which the device kernels are tested, not the production path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..params import MIN_LENGTH_CONTIG, SketchParams

_U64 = np.uint64

# 2-bit encoding: A=0, C=1, G=2, T=3 (upper and lower case); every other
# byte (incl. N) maps to 0, matching skani's BYTE_TO_SEQ table. [RECON]
BYTE_TO_SEQ = np.zeros(256, dtype=np.uint8)
for _b, _v in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"Tt", 3)):
    for _ch in _b:
        BYTE_TO_SEQ[_ch] = _v


def mm_hash64(key: np.ndarray) -> np.ndarray:
    """Thomas Wang 64-bit invertible hash (as used for k-mer hashing).

    Matches the minimap2-style ``hash64`` with wrapping arithmetic.
    """
    key = key.astype(_U64, copy=True)
    key = (~key) + (key << _U64(21))
    key = key ^ (key >> _U64(24))
    key = (key + (key << _U64(3))) + (key << _U64(8))
    key = key ^ (key >> _U64(14))
    key = (key + (key << _U64(2))) + (key << _U64(4))
    key = key ^ (key >> _U64(28))
    key = key + (key << _U64(31))
    return key


def encode_seq(contig: bytes | np.ndarray) -> np.ndarray:
    """Encode ASCII nucleotides to 2-bit codes (uint8 array)."""
    arr = np.frombuffer(contig, dtype=np.uint8) if isinstance(contig, (bytes, bytearray, memoryview)) else np.asarray(contig, dtype=np.uint8)
    return BYTE_TO_SEQ[arr]


def rolling_kmers(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All forward and reverse-complement k-mers of a 2-bit coded sequence.

    Returns ``(fwd, rev)`` of length ``len(codes) - k + 1`` where entry ``i``
    is the k-mer covering ``codes[i : i + k]``.  Forward packs the newest
    base in the low bits; reverse-complement packs complement bases in
    reverse order, mirroring the rolling registers in skani's seeding loop.
    """
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, _U64), np.zeros(0, _U64)
    c = codes.astype(_U64)
    fwd = np.zeros(n, dtype=_U64)
    rev = np.zeros(n, dtype=_U64)
    for j in range(k):
        # base j of each window (0 = leftmost/oldest)
        b = c[j : j + n]
        fwd |= b << _U64(2 * (k - 1 - j))
        rev |= (_U64(3) - b) << _U64(2 * j)
    return fwd, rev


@dataclasses.dataclass
class Sketch:
    """Dense array sketch of one genome (oracle layout).

    The device engine uses the same logical content padded to buckets; see
    pyskani_tpu.engine.  Mirrors skani::types::Sketch fields observed at
    lib.rs:147-161 / sketch.rs:17-32.
    """

    name: str
    c: int
    marker_c: int
    k: int
    marker_k: int
    amino_acid: bool = False
    contigs: List[str] = dataclasses.field(default_factory=list)
    contig_lengths: List[int] = dataclasses.field(default_factory=list)
    total_sequence_length: int = 0
    # Seed table (all occurrences), sorted by (kmer, contig, pos):
    kmers: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, _U64))
    positions: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.uint32))
    contig_ids: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.uint32))
    strands: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, bool))
    # Marker k-mer set (sorted unique hashes of canonical marker k-mers):
    markers: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, _U64))

    def __len__(self) -> int:
        return len(self.kmers)


def fmh_seeds(
    codes: np.ndarray,
    params: SketchParams,
    contig_index: int,
    seed: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """FracMinHash seeds of one contig.

    Returns ``(kmers, positions, strands, marker_kmers)``.  Positions are
    the *end* index of each k-mer (the index of its last base), matching
    the rolling-scan convention.  ``marker_kmers`` are canonical marker-k
    k-mers passing the marker threshold (not deduplicated).
    """
    k, c = params.k, params.c
    mk, mc = params.marker_k, params.marker_c
    thr = _U64(0xFFFFFFFFFFFFFFFF // c)
    mthr = _U64(0xFFFFFFFFFFFFFFFF // mc)

    fwd, rev = rolling_kmers(codes, k)
    canonical_fwd = fwd < rev
    canon = np.where(canonical_fwd, fwd, rev)
    h = mm_hash64(canon)
    keep = h < thr
    idx = np.nonzero(keep)[0]
    kmers = canon[idx]
    positions = (idx + (k - 1)).astype(np.uint32)
    strands = canonical_fwd[idx]

    mfwd, mrev = rolling_kmers(codes, mk)
    mcanon = np.minimum(mfwd, mrev) if mk != k else canon
    mh = mm_hash64(mcanon)
    markers = mcanon[mh < mthr]
    return kmers, positions, strands, markers


def sketch_genome(
    name: str,
    contigs: Sequence[bytes],
    params: SketchParams,
    seed: bool = True,
) -> Sketch:
    """Sketch a genome from raw contig byte strings.

    Mirrors Database::_sketch (lib.rs:140-185): contigs shorter than
    MIN_LENGTH_CONTIG are skipped entirely (name/length not recorded).
    """
    sk = Sketch(name=name, c=params.c, marker_c=params.marker_c, k=params.k,
                marker_k=params.marker_k)
    all_kmers, all_pos, all_cid, all_strand, all_markers = [], [], [], [], []
    contig_count = 0
    for i, contig in enumerate(contigs):
        if len(contig) < MIN_LENGTH_CONTIG:
            continue
        sk.contigs.append(f"{name}_{i}")
        sk.contig_lengths.append(len(contig))
        sk.total_sequence_length += len(contig)
        codes = encode_seq(contig)
        kmers, pos, strands, markers = fmh_seeds(codes, params, contig_count, seed)
        all_kmers.append(kmers)
        all_pos.append(pos)
        all_cid.append(np.full(len(kmers), contig_count, np.uint32))
        all_strand.append(strands)
        all_markers.append(markers)
        contig_count += 1
    if all_kmers:
        kmers = np.concatenate(all_kmers)
        pos = np.concatenate(all_pos)
        cid = np.concatenate(all_cid)
        strand = np.concatenate(all_strand)
        order = np.lexsort((pos, cid, kmers))
        sk.kmers = kmers[order]
        sk.positions = pos[order]
        sk.contig_ids = cid[order]
        sk.strands = strand[order]
        sk.markers = np.unique(np.concatenate(all_markers))
    return sk


def get_markers_only(sk: Sketch) -> Sketch:
    """Derive the marker-only sketch (reference: lib.rs:495)."""
    return Sketch(
        name=sk.name, c=sk.c, marker_c=sk.marker_c, k=sk.k, marker_k=sk.marker_k,
        amino_acid=sk.amino_acid, contigs=list(sk.contigs),
        contig_lengths=list(sk.contig_lengths),
        total_sequence_length=sk.total_sequence_length,
        markers=sk.markers.copy(),
    )
