"""Device-side FracMinHash sketching (XLA/JAX compute path).

Accelerator equivalent of ``skani::seeding::fmh_seeds`` (reference call
site: /root/reference/src/pyskani/_skani/lib.rs:165-171).  Design
departures from the Rust original, for static-shape device compute:

* all contigs of a genome are concatenated into ONE fixed-size buffer with
  per-position contig ids; k-mers spanning contig boundaries are masked
  instead of looping per contig (single jit, static shapes);
* the hash-threshold test runs on every position as a dense vector op
  (mm_hash64 on emulated u32-pair lanes, see pyskani_tpu.ops.u64), followed
  by compaction into a fixed seed budget;
* the resulting seed table is sorted by (kmer, contig, position) so that
  anchor finding is a sorted-array join, and a second position-sorted view
  is kept for per-fragment denominator counting;
* marker k-mers (k=21, compression marker_c) are deduplicated on device
  into a sorted (hi, lo) pair table used by the screening op.

Semantics match pyskani_tpu.oracle.seeding exactly (tested in
tests/test_device_sketch.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import u64
from ..oracle.seeding import BYTE_TO_SEQ
from ..params import MIN_LENGTH_CONTIG, SketchParams

# numpy scalars, NOT jnp: a module-level jnp constant would initialise
# the XLA backend at import (breaks multi-host jax.distributed init)
U32_SENTINEL = np.uint32(0xFFFFFFFF)
I32_SENTINEL = np.int32(0x7FFFFFFF)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "kmers", "positions", "contig_ids", "strands", "own_mult",
        "p_positions", "p_contig_ids", "p_own_mult",
        "markers_hi", "markers_lo",
        "n_seeds", "n_markers",
        "contig_lengths", "n_contigs", "total_len",
    ],
    meta_fields=[],
)
@dataclasses.dataclass
class DeviceSketch:
    """Padded dense-array sketch of one genome (registered pytree).

    Functional equivalent of ``skani::types::Sketch`` (fields observed at
    reference lib.rs:147-161) re-laid-out for static-shape device compute.
    Leaves may be device arrays (inside jitted pipelines, stacked
    batches) or numpy (host-resident sketches fresh off the kernel) —
    jit uploads numpy leaves at dispatch.
    """

    # seed table, sorted by (kmer, contig, position); padding = sentinels
    kmers: jax.Array        # uint32 [S]
    positions: jax.Array    # int32 [S] (end index of k-mer within contig)
    contig_ids: jax.Array   # int32 [S]
    strands: jax.Array      # bool  [S] (canonical == forward)
    own_mult: jax.Array     # int32 [S] (occurrences of this k-mer here)
    # position-sorted view of the same table
    p_positions: jax.Array  # int32 [S]
    p_contig_ids: jax.Array # int32 [S]
    p_own_mult: jax.Array   # int32 [S]
    # marker sketch (sorted unique 42-bit canonical k-mers as u32 pairs)
    markers_hi: jax.Array   # uint32 [M]
    markers_lo: jax.Array   # uint32 [M]
    n_seeds: jax.Array      # int32 []
    n_markers: jax.Array    # int32 []
    contig_lengths: jax.Array  # int32 [C]
    n_contigs: jax.Array    # int32 []
    total_len: jax.Array    # uint32 [] (aggregate genome length: uint32 so
                            # multi-Gbp many-contig genomes don't overflow;
                            # per-contig coordinates stay 32-bit)

    @property
    def seed_budget(self) -> int:
        return self.kmers.shape[0]

    @property
    def marker_budget(self) -> int:
        return self.markers_hi.shape[0]


def _rolling_windows(codes: jax.Array):
    """All rolling k-mer windows needed by the scan, via log-doubling.

    Returns (fwd15, rev15, marker_fwd: U64, marker_rev: U64) where entry i
    covers the window ending at position i.  Doubling halves the op count
    versus per-base accumulation (important for both compile time and HBM
    traffic): w_{2n}[i] combines w_n[i] and w_n[i-n] with one shift+or.
    Forward k-mers pack the newest base in the low bits; reverse
    complements pack the newest base's complement in the high bits
    (matching pyskani_tpu.oracle.seeding.rolling_kmers).
    """
    c = codes.astype(jnp.uint32)
    sh = lambda x, n: jnp.roll(x, n)

    f2 = (sh(c, 1) << jnp.uint32(2)) | c
    f4 = (sh(f2, 2) << jnp.uint32(4)) | f2
    f8 = (sh(f4, 4) << jnp.uint32(8)) | f4
    f16 = (sh(f8, 8) << jnp.uint32(16)) | f8
    fwd15 = f16 & jnp.uint32(0x3FFFFFFF)
    f5 = f8 & jnp.uint32(0x3FF)               # newest 5 bases
    m_f = u64.U64(sh(f5, 16), f16)            # 42-bit forward marker k-mer

    r1 = jnp.uint32(3) - c
    r2 = (r1 << jnp.uint32(2)) | sh(r1, 1)
    r4 = (r2 << jnp.uint32(4)) | sh(r2, 2)
    r8 = (r4 << jnp.uint32(8)) | sh(r4, 4)
    r16 = (r8 << jnp.uint32(16)) | sh(r8, 8)
    rev15 = r16 >> jnp.uint32(2)
    r5 = r8 >> jnp.uint32(6)                  # newest 5 complements (top)
    m_r = u64.U64(r5, sh(r16, 5))             # 42-bit reverse marker k-mer
    return fwd15, rev15, m_f, m_r


def _rollu(a: u64.U64, n: int) -> u64.U64:
    return u64.U64(jnp.roll(a.hi, n), jnp.roll(a.lo, n))


def _canonical_u64(fwd: u64.U64, rev: u64.U64) -> u64.U64:
    is_fwd = u64.lt(fwd, rev)
    return u64.U64(jnp.where(is_fwd, fwd.hi, rev.hi),
                   jnp.where(is_fwd, fwd.lo, rev.lo))


def _windows_generic(codes: jax.Array, k: int):
    """(fwd, rev) U64 k-mer windows ending at each position, any k <= 32.

    Log-doubling with binary composition: power-of-two windows are built
    by doubling (w_{2n}[i] combines w_n[i] and w_n[i-n]), then k is
    assembled from its binary decomposition — O(log k) vector ops instead
    of k per-base accumulations.  Bit layout matches the oracle
    (pyskani_tpu.oracle.seeding.rolling_kmers): forward packs the newest
    base in the low bits; reverse complement packs the newest base's
    complement in the high bits.
    """
    assert 1 <= k <= 32
    c = codes.astype(jnp.uint32)
    pows = []                       # (n, fwd_n, rev_n)
    f = u64.from_u32(c)
    r = u64.from_u32(jnp.uint32(3) - c)
    n = 1
    while True:
        pows.append((n, f, r))
        if 2 * n > k:
            break
        f = u64.or_(u64.shl(_rollu(f, n), 2 * n), f)
        r = u64.or_(u64.shl(r, 2 * n), _rollu(r, n))
        n *= 2
    # compose: acc holds the newest `width` bases; prepend older chunks
    acc_f = acc_r = None
    width = 0
    for n, pf, pr in reversed(pows):
        if width + n > k:
            continue
        if acc_f is None:
            acc_f, acc_r = pf, pr
        else:
            acc_f = u64.or_(u64.shl(_rollu(pf, width), 2 * width), acc_f)
            acc_r = u64.or_(u64.shl(acc_r, 2 * n), _rollu(pr, width))
        width += n
    assert width == k
    return acc_f, acc_r


_COMPACT_BLOCK = 8192


def _compact_idx(mask: jax.Array, budget: int):
    """(count, src_indices [budget]) of the set positions of ``mask``,
    ascending; padding slots point at index 0 (callers mask by count).

    Large masks compact HIERARCHICALLY: the mask is reshaped to
    [L/B, B] blocks, each ROW is index-sorted independently (one XLA
    sort along the minor axis — log^2(B) compare stages instead of
    log^2(L), vectorized across rows), and the per-block survivors are
    stitched into the global ascending stream with budget-scale
    arithmetic (block offsets by cumsum; slot -> block via the
    scatter+cummax inversion; payload via one [budget] gather).  A
    genome-length single sort costs log^2(L) compare stages over the
    whole mask; the blocked form needs log^2(B).  Small inputs keep the
    single sort.
    """
    L = mask.shape[0]
    B = _COMPACT_BLOCK
    if L < (1 << 18) or L % B:
        i = jax.lax.iota(jnp.uint32, L)
        key = jnp.where(mask, i, jnp.uint32(0xFFFFFFFF))
        key_s = jax.lax.sort(key, is_stable=False)[:budget]
        valid = key_s != jnp.uint32(0xFFFFFFFF)
        src = jnp.where(valid, key_s, jnp.uint32(0)).astype(jnp.int32)
        count = jnp.minimum(jnp.sum(mask, dtype=jnp.int32), budget)
        return count, src

    NB = L // B
    m2 = mask.reshape(NB, B)
    iota = jax.lax.broadcasted_iota(jnp.uint32, (NB, B), 1)
    key = jnp.where(m2, iota, jnp.uint32(0xFFFFFFFF))
    (key_s,) = jax.lax.sort((key,), dimension=1, is_stable=False,
                            num_keys=1)
    counts = jnp.sum(m2, axis=1, dtype=jnp.int32)          # [NB]
    offs = jnp.cumsum(counts) - counts                     # exclusive
    total = offs[-1] + counts[-1]
    count = jnp.minimum(total, budget)

    t = jnp.arange(budget, dtype=jnp.int32)
    slot0 = jnp.where(counts > 0, jnp.minimum(offs, budget), budget)
    blk_map = jnp.zeros(budget + 1, jnp.int32).at[slot0].max(
        jnp.arange(NB, dtype=jnp.int32))
    blk = jax.lax.cummax(blk_map[:budget])
    j = t - offs[blk]
    local = key_s.reshape(-1)[blk * B + jnp.clip(j, 0, B - 1)]
    src = jnp.where(t < count,
                    blk * B + local.astype(jnp.int32), 0)
    return count, src


def _compact(mask: jax.Array, budget: int, arrays: Sequence[jax.Array],
             sentinels: Sequence) -> tuple:
    """Gather ``arrays`` at positions where ``mask`` is set, padded to
    ``budget`` with per-array sentinels.  Returns (count, gathered...).

    Implementation: ONE single-operand u32 sort of the masked indices
    (set positions sort first, in ascending order — :func:`_compact_idx`),
    then budget-sized gathers of the payload arrays at the surviving
    indices.  A genome-length ``lax.top_k`` selects the same survivors
    but is a slow custom call at large k; the index sort streams, and
    the payload gathers touch only ``budget`` elements.
    """
    count, src = _compact_idx(mask, budget)
    valid = jnp.arange(budget) < count
    # ONE stacked u32 gather: random-access cost is per resolved index,
    # so W arrays gathered separately pay W index resolutions — bitcast
    # everything through one [n, W] u32 matrix instead
    cols = []
    for arr in arrays:
        if arr.dtype == jnp.int32:
            cols.append(jax.lax.bitcast_convert_type(arr, jnp.uint32))
        elif arr.dtype == jnp.bool_:
            cols.append(arr.astype(jnp.uint32))
        else:
            cols.append(arr)
    g = jnp.stack(cols, axis=1)[src]              # [budget, W]
    out = []
    for w, (arr, sent) in enumerate(zip(arrays, sentinels)):
        col = g[:, w]
        if arr.dtype == jnp.int32:
            col = jax.lax.bitcast_convert_type(col, jnp.int32)
        elif arr.dtype == jnp.bool_:
            col = col != 0
        out.append(jnp.where(valid, col, jnp.asarray(sent, arr.dtype)))
    return (count, *out)


def encode_pack_host(raw: np.ndarray) -> np.ndarray:
    """ASCII bytes -> 2-bit codes packed 4/byte (host side, vectorised).

    Shrinks the host->device transfer 4x.  Length must be a multiple of
    4 (length buckets are).
    """
    codes = BYTE_TO_SEQ[raw]
    q = codes.reshape(-1, 4)
    return (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) |
            (q[:, 3] << 6)).astype(np.uint8)


@functools.partial(jax.jit, static_argnames=("k", "marker_k", "c", "marker_c",
                                             "seed_budget", "marker_budget"))
def sketch_kernel(
    packed_codes: jax.Array,   # uint8 [L//4] 2-bit codes, 4 bases per byte
                               # (encode_pack_host; oldest base in bits 1:0)
    contig_starts: jax.Array,  # int32 [C+1] global start of each contig,
                               # with contig_starts[n_contigs] = total_len
    n_contigs: jax.Array,      # int32 []
    valid_floor: jax.Array | None = None,
                               # int32 [C+1] global window-end floor per
                               # contig (start + min valid in-contig end
                               # index).  Used by the chunked giant-genome
                               # path: continuation slices of a split
                               # contig feed a K-1 overlap and mask the
                               # overlap's window ends so chunk outputs
                               # tile exactly.  None = no extra floor.
    *,
    k: int, marker_k: int, c: int, marker_c: int,
    seed_budget: int, marker_budget: int,
):
    """All-positions FracMinHash scan + compaction for one genome.

    Host ships 2-bit-packed sequence codes (4 bases/byte); per-position
    contig ids and in-contig positions are derived on device with
    scatter+scan (no host-side 8N-byte index arrays, no large gathers).
    """
    thr = u64.from_int((2**64 - 1) // c)
    mthr = u64.from_int((2**64 - 1) // marker_c)
    L = packed_codes.shape[0] * 4
    C = contig_starts.shape[0] - 1

    codes = ((packed_codes[:, None] >>
              (jnp.arange(4, dtype=jnp.uint8) * 2)[None, :])
             & jnp.uint8(3)).reshape(L)
    # in-contig position: i - (global start of my contig), via segmented
    # cummax of scattered start values.  Contigs are packed contiguously
    # (padding only past the total), so per-position contig IDS need no
    # L-scale array at all: the validity masks only need pos_in_contig
    # and i < total, and survivors recover their contig by a budget-scale
    # searchsorted over the (tiny) starts table below.
    ii = jnp.arange(L, dtype=jnp.int32)
    start_marks = jnp.zeros(L + 1, jnp.int32).at[contig_starts].max(
        jnp.where(jnp.arange(C + 1) <= n_contigs, contig_starts, 0))
    my_start = jax.lax.cummax(start_marks[:L])
    pos_in_contig = ii - my_start
    total_len = contig_starts[jnp.clip(n_contigs, 0, C)]
    in_seq = ii < total_len
    if valid_floor is None:
        floor_ok = jnp.ones(L, bool)
    else:
        # per-contig global floors are strictly increasing (floor <
        # next contig's start), so the same scatter+cummax fill applies
        floor_marks = jnp.zeros(L + 1, jnp.int32).at[contig_starts].max(
            jnp.where(jnp.arange(C + 1) <= n_contigs, valid_floor, 0))
        floor_ok = ii >= jax.lax.cummax(floor_marks[:L])

    if k == 15 and marker_k == 21:
        # fused fast path: seed and marker windows share the doubling
        # intermediates in pure u32 lanes (the defaults, lib.rs:369)
        fwd, rev, mfwd, mrev = _rolling_windows(codes)
        strand = fwd < rev
        canon = jnp.where(strand, fwd, rev)
        h = u64.mm_hash64(u64.from_u32(canon))
        mcanon = _canonical_u64(mfwd, mrev)
    else:
        if not (4 <= k <= 32 and 4 <= marker_k <= 32):
            raise ValueError(f"k={k} / marker_k={marker_k} outside the "
                             f"supported [4, 32] range")
        fU, rU = _windows_generic(codes, k)
        strand = u64.lt(fU, rU)
        canonU = _canonical_u64(fU, rU)
        h = u64.mm_hash64(canonU)
        if 2 * k <= 32:
            canon = canonU.lo
        else:
            # k > 16: the seed table carries a 32-bit key; use the low
            # hash word as a fingerprint (uniform; equal k-mers map
            # equal).  Cross-k-mer collisions are ~N^2/2^33 per sketch
            # (~0.2 for a 5 Mbp genome) and isolated false anchors are
            # discarded by the chain filters.  0xFFFFFFFF is remapped so
            # the padding sentinel stays unambiguous.
            canon = jnp.where(h.lo == U32_SENTINEL,
                              jnp.uint32(0xFFFFFFFE), h.lo)
        if marker_k == k:
            mcanon = canonU           # oracle: marker set reuses canon
        else:
            mfU, mrU = _windows_generic(codes, marker_k)
            mcanon = _canonical_u64(mfU, mrU)
    valid_seed = in_seq & (pos_in_contig >= k - 1) & floor_ok
    seed_mask = valid_seed & u64.lt(h, thr)

    mh = u64.mm_hash64(mcanon)
    valid_marker = in_seq & (pos_in_contig >= marker_k - 1) & floor_ok
    marker_mask = valid_marker & u64.lt(mh, mthr)

    # ---- ONE stacked survivor table + ONE genome-length compaction ----
    # Everything a survivor needs rides ONE [L, 4] table (canonical
    # k-mer, packed flags, marker k-mer hi/lo) so the whole expensive
    # producer chain (windows, two u64 hashes, masks) is materialised
    # EXACTLY ONCE and survivors cost one stacked gather — 7 separate
    # L-scale gathers would each re-materialise parts of the chain.
    # The union mask is compacted with the
    # blocked index sort (_compact_idx); the per-table splits then run
    # at compacted (~L/117) scale.  When the union prefix clips
    # (possible once either table overflows its budget — a sizing
    # failure; budgets carry 25-35% slack), the split counts below
    # still reflect exactly what survived into each table.
    meta = (marker_mask.astype(jnp.uint32) << 2) | \
        (seed_mask.astype(jnp.uint32) << 1) | strand.astype(jnp.uint32)
    S = jax.lax.optimization_barrier(
        jnp.stack([canon, meta, mcanon.hi, mcanon.lo], axis=1))
    union_budget = seed_budget + marker_budget
    n_union, u_src = _compact_idx((S[:, 1] & 6) != 0, union_budget)
    g = S[u_src]                                   # [union_budget, 4]
    in_pref = jnp.arange(union_budget) < n_union
    g_meta = g[:, 1]
    u_seed = ((g_meta & 2) != 0) & in_pref
    u_marker = ((g_meta & 4) != 0) & in_pref
    # survivor contig id / in-contig position at budget scale: u_src IS
    # the global position, contigs are contiguous.  The contig lookup is
    # a compare-count over the tiny starts table: one fused [budget, C+1]
    # compare reduction instead of jnp.searchsorted's binary-search loop
    in_table = jnp.arange(C + 1) <= n_contigs
    cid_u = jnp.clip(
        jnp.sum((u_src[:, None] >= contig_starts[None, :]) &
                in_table[None, :], axis=1, dtype=jnp.int32) - 1,
        0, C - 1)
    pos_u = u_src - contig_starts[cid_u]

    # n_seeds from _compact counts the seed rows ACTUALLY in the table
    # (min(sum(u_seed), seed_budget)) — under one-sided clipping, fewer
    # genuine seeds than seed_budget may survive the union prefix, and
    # reporting the full-mask count would make consumers treat sentinel
    # rows as seeds
    n_seeds, s_kmer, s_pos, s_cid, s_strand = _compact(
        u_seed, seed_budget,
        (g[:, 0], pos_u, cid_u, (g_meta & 1) != 0),
        (U32_SENTINEL, I32_SENTINEL, I32_SENTINEL, False),
    )
    s_kmer, s_cid, s_pos, s_strand = jax.lax.sort(
        (s_kmer, s_cid, s_pos, s_strand), num_keys=3)
    # own multiplicity = run length in the kmer-sorted table, via run
    # start/end scans — the searchsorted formulation this replaces
    # lowered to 15-step binary-search while-loops costing 47 ms per
    # 8-genome stack (2x23 ms, the top kernel cost after the union sort)
    ii = jnp.arange(seed_budget, dtype=jnp.int32)
    edge = s_kmer[1:] != s_kmer[:-1]
    first = jnp.concatenate([jnp.ones(1, bool), edge])
    last = jnp.concatenate([edge, jnp.ones(1, bool)])
    run_start = jax.lax.cummax(jnp.where(first, ii, 0))
    run_end = jax.lax.cummin(
        jnp.where(last, ii, seed_budget - 1)[::-1])[::-1]
    own_mult = run_end - run_start + 1

    p_cid, p_pos, p_own = jax.lax.sort((s_cid, s_pos, own_mult), num_keys=2)

    # ---- compact markers, dedupe ----
    _, m_hi, m_lo = _compact(
        u_marker, marker_budget,
        (g[:, 2], g[:, 3]),
        (U32_SENTINEL, U32_SENTINEL),
    )
    m_hi, m_lo = jax.lax.sort((m_hi, m_lo), num_keys=2)
    prev_same = jnp.concatenate([
        jnp.zeros(1, bool),
        (m_hi[1:] == m_hi[:-1]) & (m_lo[1:] == m_lo[:-1]),
    ])
    is_sentinel = (m_hi == U32_SENTINEL) & (m_lo == U32_SENTINEL)
    first = (~prev_same) & (~is_sentinel)
    n_markers, mu_hi, mu_lo = _compact(
        first, marker_budget, (m_hi, m_lo), (U32_SENTINEL, U32_SENTINEL))

    # budget-saturation diagnostics: the union compaction
    # couples the two tables, so once EITHER mask outgrows its budget the
    # other may silently lose rows past the union prefix — report the
    # raw mask populations so callers can warn/raise instead of
    # degrading screen/ANI estimates quietly.  Both counts reduce over
    # the MATERIALISED flag plane of S (reducing the raw masks would
    # re-derive the whole hash chain a second time).
    flag_plane = S[:, 1]
    n_seeds_want = jnp.sum((flag_plane >> 1) & 1, dtype=jnp.uint32
                           ).astype(jnp.int32)
    n_markers_want = jnp.sum((flag_plane >> 2) & 1, dtype=jnp.uint32
                             ).astype(jnp.int32)

    return dict(
        n_seeds=n_seeds, kmers=s_kmer, positions=s_pos, contig_ids=s_cid,
        strands=s_strand, own_mult=own_mult,
        p_positions=p_pos, p_contig_ids=p_cid, p_own_mult=p_own,
        n_markers=n_markers, markers_hi=mu_hi, markers_lo=mu_lo,
        n_seeds_want=n_seeds_want, n_markers_want=n_markers_want,
    )


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _warn_sketch_overflow(name: str, want_seeds: int, want_markers: int,
                          seed_budget: int, marker_budget: int) -> None:
    """Loudly report sketch-budget saturation: when either
    mask outgrows its budget, rows are dropped (and the union compaction
    may clip the OTHER table's tail too), degrading screen estimates and
    ANI denominators silently otherwise."""
    import warnings
    if want_seeds > seed_budget or want_markers > marker_budget:
        warnings.warn(
            f"sketch {name!r} saturated its budgets (seeds "
            f"{want_seeds}/{seed_budget}, markers "
            f"{want_markers}/{marker_budget}): rows were dropped — "
            f"raise seed_budget/marker_budget", RuntimeWarning,
            stacklevel=3)


# Hard ceiling on contigs per genome: contig ids ride 14-bit fields in the
# chain engine's packed sort keys ((rowid|frag)<<14 | rcid, qcid<<17 in
# meta, g<<15|cid<<1 in the join payloads).  The reference has no explicit
# cap (lib.rs:155-173 loops a Vec), but 16384 contigs covers even highly
# fragmented MAGs.
MAX_CONTIGS_HARD = 1 << 14


def contig_budget_for(n: int) -> int:
    """Power-of-two contig-table budget for a genome with ``n`` contigs.

    Bucketing keeps jit shapes stable across genomes with similar contig
    counts (draft assemblies vary run to run) while letting single-contig
    isolates stay tiny — the budget also sets how many bits of the packed
    block-grid word go to the contig id (ops.chain.rcid_bits_for), so a
    smaller bucket buys longer representable contigs.
    """
    if n > MAX_CONTIGS_HARD:
        raise ValueError(
            f"genome has {n} contigs (>= MIN_LENGTH_CONTIG), above the "
            f"engine's {MAX_CONTIGS_HARD} hard limit")
    b = 8
    while b < n:
        b *= 2
    return b


def _blank_seed_table(dev: "DeviceSketch") -> "DeviceSketch":
    """Drop the seed-position table (``seed=False`` sketches record only
    markers + metadata; reference lib.rs:474-475: "Compute seed positions
    while sketching").  Such sketches screen normally but produce no
    anchors when chained."""
    S = dev.seed_budget
    return dataclasses.replace(
        dev,
        kmers=np.full((S,), 0xFFFFFFFF, np.uint32),
        positions=np.full((S,), 0x7FFFFFFF, np.int32),
        contig_ids=np.full((S,), 0x7FFFFFFF, np.int32),
        strands=np.zeros((S,), bool),
        own_mult=np.zeros((S,), np.int32),
        p_positions=np.full((S,), 0x7FFFFFFF, np.int32),
        p_contig_ids=np.full((S,), 0x7FFFFFFF, np.int32),
        p_own_mult=np.zeros((S,), np.int32),
        n_seeds=np.int32(0),
    )


def seed_budget_for(total_len: int, c: int) -> int:
    """Default seed-table budget: mean + generous slack, lane aligned."""
    expect = max(total_len // c, 256)
    return round_up(int(expect * 1.25) + 1024, 1024)


def marker_budget_for(total_len: int, marker_c: int) -> int:
    expect = max(total_len // marker_c, 64)
    return round_up(int(expect * 1.35) + 512, 512)


# per-call sequence budget for chunked giant-genome sketching: a kernel
# call materialises ~15 L-sized u32 intermediates, so one monolithic
# multi-Gbp call would need hundreds of GB — giants stream through
# fixed-size calls instead (the reference streams contig-by-contig,
# lib.rs:155-173; totals there are unbounded usize, lib.rs:160)
GIANT_SKETCH_BUFFER = 1 << 27


def _plan_sketch_pieces(kept: Sequence[bytes], K: int, max_buffer: int):
    """Split contigs into fed pieces of <= max_buffer bytes each and pack
    them into kernel calls.

    A piece is (true_cid, src_start, src_end, floor): the kernel is fed
    ``contig[src_start:src_end]``; continuation pieces of a split contig
    lead with a K-1-byte overlap (K = max(k, marker_k)) and mask window
    ends below ``floor`` so the chunk outputs tile the contig's windows
    exactly once.  Returns a list of calls, each a list of pieces.
    """
    if max_buffer < 4 * K:
        # a continuation piece must make progress past its K-1 overlap
        raise ValueError(f"max_buffer={max_buffer} too small for "
                         f"k-mer windows of up to {K} bases (need >= "
                         f"{4 * K})")
    pieces = []
    for cid, contig in enumerate(kept):
        n = len(contig)
        pos = 0
        while pos < n:
            lead = 0 if pos == 0 else K - 1
            new = min(n - pos, max_buffer - lead)
            pieces.append((cid, pos - lead, pos + new, lead))
            pos += new
    calls, cur, cur_len = [], [], 0
    for p in pieces:
        fed = p[2] - p[1]
        if cur and cur_len + fed > max_buffer:
            calls.append(cur)
            cur, cur_len = [], 0
        cur.append(p)
        cur_len += fed
    if cur:
        calls.append(cur)
    return calls


def _sketch_genome_chunked(
    name: str, kept: List[bytes], contig_names: List[str],
    params: SketchParams, seed_budget: int | None,
    marker_budget: int | None, length_bucket: int, max_contigs: int,
    max_buffer: int, seed: bool,
) -> "HostSketch":
    """Chunked sketching for genomes too large for one kernel call.

    Each call sketches a piece-group through the normal kernel (with
    ``valid_floor`` masking split-contig overlaps); the per-call tables
    are merged on the host: one lexsort by (kmer, contig, position),
    own-multiplicity from k-mer run lengths over the UNION, a
    position-sorted view, and marker dedup over the combined u64 set.
    Numerically identical to a single-call sketch (pinned by
    tests/test_device_sketch.py::test_chunked_*)."""
    lengths = [len(c) for c in kept]
    total = sum(lengths)
    K = max(params.k, params.marker_k)
    calls = _plan_sketch_pieces(kept, K, max_buffer)

    kmer_l, pos_l, cid_l, str_l, mark_l = [], [], [], [], []
    for pieces in calls:
        fed_total = sum(p[2] - p[1] for p in pieces)
        L = max(round_up(fed_total, length_bucket), length_bucket)
        mc = contig_budget_for(len(pieces))
        raw = np.zeros(L, dtype=np.uint8)
        starts = np.zeros(mc + 1, dtype=np.int32)
        floors = np.zeros(mc + 1, dtype=np.int32)
        off = 0
        for i, (cid, s0, s1, floor) in enumerate(pieces):
            n = s1 - s0
            raw[off:off + n] = np.frombuffer(kept[cid][s0:s1],
                                             dtype=np.uint8)
            starts[i] = off
            floors[i] = off + floor
            off += n
        starts[len(pieces):] = off
        floors[len(pieces):] = off
        sb_c = seed_budget_for(fed_total, params.c)
        mb_c = marker_budget_for(fed_total, params.marker_c)
        out = sketch_kernel(
            jnp.asarray(encode_pack_host(raw)), jnp.asarray(starts),
            jnp.int32(len(pieces)), jnp.asarray(floors),
            k=params.k, marker_k=params.marker_k, c=params.c,
            marker_c=params.marker_c, seed_budget=sb_c, marker_budget=mb_c)
        out = jax.device_get(out)
        _warn_sketch_overflow(name, int(out["n_seeds_want"]),
                              int(out["n_markers_want"]), sb_c, mb_c)
        ns, nm = int(out["n_seeds"]), int(out["n_markers"])
        piece_cid = np.array([p[0] for p in pieces], np.int32)
        piece_off = np.array([p[1] for p in pieces], np.int32)
        pidx = out["contig_ids"][:ns]
        kmer_l.append(out["kmers"][:ns])
        pos_l.append(out["positions"][:ns] + piece_off[pidx])
        cid_l.append(piece_cid[pidx])
        str_l.append(out["strands"][:ns])
        mark_l.append((out["markers_hi"][:nm].astype(np.uint64) << 32)
                      | out["markers_lo"][:nm].astype(np.uint64))

    kmer = np.concatenate(kmer_l)
    pos = np.concatenate(pos_l)
    cid = np.concatenate(cid_l)
    strand = np.concatenate(str_l)
    order = np.lexsort((pos, cid, kmer))
    kmer, pos, cid, strand = (a[order] for a in (kmer, pos, cid, strand))
    _, inv, cnt = np.unique(kmer, return_inverse=True, return_counts=True)
    own = cnt[inv].astype(np.int32)
    p_order = np.lexsort((pos, cid))
    markers = np.unique(np.concatenate(mark_l))

    n = len(kmer)
    m = len(markers)
    sb = seed_budget or seed_budget_for(total, params.c)
    mb = marker_budget or marker_budget_for(total, params.marker_c)
    if n > sb or m > mb:
        raise ValueError(f"chunked sketch {name!r} outgrew its budgets "
                         f"({n}>{sb} or {m}>{mb})")

    def pad(a, size, fill, dtype=None):
        out_a = np.full(size, fill, dtype=dtype or a.dtype)
        out_a[:len(a)] = a
        return out_a

    clens = np.zeros(max_contigs, dtype=np.int32)
    clens[:len(lengths)] = lengths
    dev = DeviceSketch(
        kmers=pad(kmer, sb, 0xFFFFFFFF),
        positions=pad(pos, sb, 0x7FFFFFFF),
        contig_ids=pad(cid, sb, 0x7FFFFFFF),
        strands=pad(strand, sb, False),
        own_mult=pad(own, sb, 0),
        p_positions=pad(pos[p_order], sb, 0x7FFFFFFF),
        p_contig_ids=pad(cid[p_order], sb, 0x7FFFFFFF),
        p_own_mult=pad(own[p_order], sb, 0),
        markers_hi=pad((markers >> 32).astype(np.uint32), mb, 0xFFFFFFFF),
        markers_lo=pad(markers.astype(np.uint32), mb, 0xFFFFFFFF),
        n_seeds=np.int32(n), n_markers=np.int32(m),
        contig_lengths=clens,
        n_contigs=np.int32(len(lengths)),
        # uint32 total saturates at 2^32-1 for >4.3 Gbp genomes; the
        # full-range chain path never reads it (AF denominators come
        # from contig_lengths) and the packed paths only test >= 2^30
        total_len=np.uint32(min(total, 2**32 - 1)),
    )
    if not seed:
        dev = _blank_seed_table(dev)
    return HostSketch(name=name, contig_names=contig_names, device=dev,
                      lengths=lengths)


def sketch_genome_device(
    name: str,
    contigs: Sequence[bytes],
    params: SketchParams,
    seed_budget: int | None = None,
    marker_budget: int | None = None,
    length_bucket: int = 1 << 20,
    max_contigs: int | None = None,
    seed: bool = True,
    max_buffer: int = GIANT_SKETCH_BUFFER,
) -> "HostSketch":
    """Host wrapper: encode contigs, pad, run the device kernel.

    Mirrors Database::_sketch (reference lib.rs:140-185): contigs shorter
    than MIN_LENGTH_CONTIG are skipped entirely.  ``max_contigs`` defaults
    to a power-of-two bucket sized from the input (any contig count up to
    MAX_CONTIGS_HARD works, matching the reference's unbounded Vec loop).
    Genomes larger than ``max_buffer`` stream through chunked kernel
    calls (:func:`_sketch_genome_chunked`) — multi-Gbp genomes sketch in
    bounded memory, like the reference's per-contig loop.
    """
    kept = [c for c in contigs if len(c) >= MIN_LENGTH_CONTIG]
    contig_names = [f"{name}_{i}" for i, c in enumerate(contigs)
                    if len(c) >= MIN_LENGTH_CONTIG]
    if max_contigs is None:
        max_contigs = contig_budget_for(len(kept))
    elif max_contigs > MAX_CONTIGS_HARD:
        raise ValueError(f"max_contigs={max_contigs} exceeds the engine's "
                         f"{MAX_CONTIGS_HARD} hard limit (contig ids ride "
                         f"14-bit fields in the chain sort keys)")
    elif len(kept) > max_contigs:
        raise ValueError(f"genome {name!r} has {len(kept)} contigs, more "
                         f"than the max_contigs={max_contigs} budget")
    lengths = [len(c) for c in kept]
    total = sum(lengths)
    if total > max_buffer:
        return _sketch_genome_chunked(
            name, kept, contig_names, params, seed_budget, marker_budget,
            length_bucket, max_contigs, max_buffer, seed)
    L = max(round_up(max(total, 1), length_bucket), length_bucket)

    raw = np.zeros(L, dtype=np.uint8)
    starts = np.zeros(max_contigs + 1, dtype=np.int32)
    off = 0
    for i, contig in enumerate(kept):
        n = len(contig)
        raw[off:off + n] = np.frombuffer(contig, dtype=np.uint8)
        starts[i] = off
        off += n
    starts[len(kept):] = off

    sb = seed_budget or seed_budget_for(total, params.c)
    mb = marker_budget or marker_budget_for(total, params.marker_c)
    out = sketch_kernel(
        jnp.asarray(encode_pack_host(raw)), jnp.asarray(starts),
        jnp.int32(len(kept)),
        k=params.k, marker_k=params.marker_k, c=params.c,
        marker_c=params.marker_c, seed_budget=sb, marker_budget=mb)
    out = jax.device_get(out)  # one batched fetch; sketches live on host
    _warn_sketch_overflow(name, int(out.pop("n_seeds_want")),
                          int(out.pop("n_markers_want")), sb, mb)

    clens = np.zeros(max_contigs, dtype=np.int32)
    clens[:len(lengths)] = lengths
    dev = DeviceSketch(
        kmers=out["kmers"], positions=out["positions"],
        contig_ids=out["contig_ids"], strands=out["strands"],
        own_mult=out["own_mult"],
        p_positions=out["p_positions"], p_contig_ids=out["p_contig_ids"],
        p_own_mult=out["p_own_mult"],
        markers_hi=out["markers_hi"], markers_lo=out["markers_lo"],
        n_seeds=out["n_seeds"], n_markers=out["n_markers"],
        contig_lengths=clens,
        n_contigs=np.int32(len(lengths)),
        total_len=np.uint32(total),
    )
    if not seed:
        dev = _blank_seed_table(dev)
    return HostSketch(name=name, contig_names=contig_names, device=dev,
                      lengths=lengths)


def sketch_genomes_device(
    named_contigs: Sequence[tuple],
    params: SketchParams,
    seed_budget: int | None = None,
    marker_budget: int | None = None,
    length_bucket: int = 1 << 20,
    max_contigs: int | None = None,
    device_batch: int = 8,
    seed: bool = True,
    max_buffer: int = GIANT_SKETCH_BUFFER,
) -> List["HostSketch"]:
    """Sketch MANY genomes with vmapped kernel dispatches.

    ``named_contigs`` is a list of (name, [contig bytes...]).  Per-genome
    dispatch (sketch_genome_device) pays one host->device round trip per
    genome; this variant stacks up to ``device_batch`` genomes into one
    [B, L] buffer and runs the kernel once per stack.  Genomes are grouped
    into near-homogeneous stacks BY SIZE (all stack members share the max
    member's padded length and budgets, so one large genome in a stack of
    small ones would inflate every member's padding); input order is
    restored on return.  Genomes above ``max_buffer`` stream through the
    chunked single-genome path instead.
    """
    items = []
    for name, contigs in named_contigs:
        kept = [c for c in contigs if len(c) >= MIN_LENGTH_CONTIG]
        names = [f"{name}_{i}" for i, c in enumerate(contigs)
                 if len(c) >= MIN_LENGTH_CONTIG]
        lengths = [len(c) for c in kept]
        items.append((name, kept, names, lengths, sum(lengths)))

    by_slot: dict = {}
    small = [j for j, it in enumerate(items) if it[4] <= max_buffer]
    for j, it in enumerate(items):
        if it[4] > max_buffer:
            by_slot[j] = _sketch_genome_chunked(
                it[0], it[1], it[2], params, seed_budget, marker_budget,
                length_bucket, contig_budget_for(len(it[1])), max_buffer,
                seed)
    # near-homogeneous stacks: ascending size, ties broken by input
    # order (stable), so a mixed-size batch packs same-scale genomes
    # together instead of padding every stack to its largest member
    small.sort(key=lambda j: items[j][4])

    for lo in range(0, len(small), device_batch):
        slot_ids = small[lo:lo + device_batch]
        group = [items[j] for j in slot_ids]
        B = len(group)
        max_total = max(g[4] for g in group)
        L = max(round_up(max(max_total, 1), length_bucket), length_bucket)
        sb = seed_budget or seed_budget_for(max_total, params.c)
        mb = marker_budget or marker_budget_for(max_total, params.marker_c)
        mc = max_contigs if max_contigs is not None else \
            contig_budget_for(max(len(g[1]) for g in group))
        if mc > MAX_CONTIGS_HARD:
            raise ValueError(f"max_contigs={mc} exceeds the engine's "
                             f"{MAX_CONTIGS_HARD} hard limit")
        for gname, kept, _, _, _ in group:
            if len(kept) > mc:
                raise ValueError(
                    f"genome {gname!r} has {len(kept)} contigs, more than "
                    f"the max_contigs={mc} budget")

        packed = np.zeros((B, L // 4), dtype=np.uint8)
        starts = np.zeros((B, mc + 1), dtype=np.int32)
        ncon = np.zeros(B, dtype=np.int32)
        raw = np.zeros(L, dtype=np.uint8)
        for b, (_, kept, _, _, _) in enumerate(group):
            raw[:] = 0
            off = 0
            for i, contig in enumerate(kept):
                n = len(contig)
                raw[off:off + n] = np.frombuffer(contig, dtype=np.uint8)
                starts[b, i] = off
                off += n
            packed[b] = encode_pack_host(raw)
            starts[b, len(kept):] = off
            ncon[b] = len(kept)

        kern = functools.partial(
            sketch_kernel, k=params.k, marker_k=params.marker_k,
            c=params.c, marker_c=params.marker_c,
            seed_budget=sb, marker_budget=mb)
        res = jax.vmap(kern)(jnp.asarray(packed), jnp.asarray(starts),
                             jnp.asarray(ncon))
        # fetch the whole batched result with ONE device_get: slicing the
        # device arrays per genome/field would dispatch 13*B tiny device
        # programs, each a round trip; host sketches are numpy-resident
        # and re-uploaded in one device_put when stacked
        # (engine/batch.py)
        res = jax.device_get(res)
        ws, wm = res.pop("n_seeds_want"), res.pop("n_markers_want")
        for b, (gname, *_rest) in enumerate(group):
            _warn_sketch_overflow(gname, int(ws[b]), int(wm[b]), sb, mb)

        for b, (name, kept, cnames, lengths, total) in enumerate(group):
            clens = np.zeros(mc, dtype=np.int32)
            clens[:len(lengths)] = lengths
            dev = DeviceSketch(
                kmers=res["kmers"][b], positions=res["positions"][b],
                contig_ids=res["contig_ids"][b], strands=res["strands"][b],
                own_mult=res["own_mult"][b],
                p_positions=res["p_positions"][b],
                p_contig_ids=res["p_contig_ids"][b],
                p_own_mult=res["p_own_mult"][b],
                markers_hi=res["markers_hi"][b],
                markers_lo=res["markers_lo"][b],
                n_seeds=res["n_seeds"][b], n_markers=res["n_markers"][b],
                contig_lengths=clens,
                n_contigs=np.int32(len(lengths)),
                total_len=np.uint32(total),
            )
            if not seed:
                dev = _blank_seed_table(dev)
            by_slot[slot_ids[b]] = HostSketch(
                name=name, contig_names=cnames, device=dev, lengths=lengths)
    return [by_slot[j] for j in range(len(items))]


@dataclasses.dataclass
class HostSketch:
    """A named genome sketch: host metadata + host-resident arrays.

    Counterpart of the reference's ``Sketch`` pyclass
    (/root/reference/src/pyskani/_skani/sketch.rs:4-38).  The ``device``
    pytree holds numpy arrays (fetched in one batched transfer right
    after the sketch kernel); they are shipped back to the device in one
    ``device_put`` when stacked into a batch (engine/batch.py).
    """

    name: str
    contig_names: List[str]
    device: DeviceSketch
    lengths: List[int] = dataclasses.field(default_factory=list)

    @property
    def total_len(self) -> int:
        return sum(self.lengths)

    def n_fragments(self, fl: int) -> int:
        return sum(max(1, -(-length // fl)) for length in self.lengths)
