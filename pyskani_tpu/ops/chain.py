"""Device-side anchor chaining + ANI/AF estimation (the flagship op).

Device equivalent of ``skani::chain::chain_seeds`` (reference call
site: /root/reference/src/pyskani/_skani/lib.rs:646-653), with semantics
defined by the fitted NumPy oracle (pyskani_tpu.oracle.chain).  Design:

* anchors come from a vectorised sorted-join of the two seed tables with
  a static anchor budget (no hash maps);
* the 5 anchor sort keys (frag, rcid, rpos, qcid, qpos) are packed into
  3 machine words — (frag<<14|rcid, rpos, global-qpos·4+rev·2+valid) —
  so the big per-pair sort moves 3 operands instead of 7 and compares 3
  keys instead of 5 (global qpos is monotone in (qcid, qpos), making the
  packed order identical);
* anchors are scattered into a [fragments, anchors-per-fragment] grid;
  the banded chain DP advances every fragment in lockstep along the
  anchor axis (the sequential dependency is per fragment, so all
  fragments x band slots are processed in parallel at each step);
* the DP runs ONCE per *batch* of pairs: each pair's fragment rows are
  independent, so a chunk of B pairs is reshaped to one [B*NF, PF] grid
  and the Pallas kernel (GPU) or the lax.scan reference walks PF steps
  with B*NF lanes — B times fewer sequential steps than vmapping the DP;
* chains are identified by the DP's union roots (each anchor adopts its
  chosen predecessor's root), so per-chain statistics are plain masked
  segment reductions on the grid — no host-side union-find;
* interval unions (aligned fraction) are computed in global genome
  coordinates via sort + exclusive running max;
* the three estimators (mean / 10-90% trimmed mean / median) are all
  produced in one pass from the sorted per-fragment ANI vector.

Everything is static-shape and jit/vmap/shard_map compatible.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .sketch import DeviceSketch, I32_SENTINEL
from ..oracle.chain import ChainConfig

# numpy scalars, NOT jnp: module-level jnp constants would initialise
# the XLA backend at import time, breaking jax.distributed.initialize
# (which must run before any backend touch on multi-host pods)
NEG_BIG = np.int32(-(2**30))
POS_BIG = np.int32(2**30)


@dataclasses.dataclass(frozen=True)
class EngineBudgets:
    """Static shape budgets for the pair pipeline."""

    max_anchors: int = 65536
    max_fragments: int = 384
    max_anchors_per_fragment: int = 512
    # kept chains per pair in the block tail (chain_block only): kept
    # chains need >= 3 anchors (min_chain_score), so real pairs have at
    # most a few hundred; overflow is reported via the n_chains output.
    max_chains_per_pair: int = 2048


def _check_supported(cfg: ChainConfig):
    if cfg.chunk_side != "query" or (cfg.chain_group_side not in ("", "query")):
        raise NotImplementedError("engine implements query-side fragments")
    if cfg.nonoverlap_side != "none":
        raise NotImplementedError("engine implements nonoverlap_side='none'")
    if cfg.denom_mode != "span":
        # "fragment" used to be accepted here but raised at runtime on
        # the per-pair path while the block path silently computed span
        # semantics — reject any non-span mode up front so both
        # pipelines agree on every accepted config
        raise NotImplementedError("engine implements the span denominator")
    if cfg.numer_mode != "anchors":
        raise NotImplementedError("engine implements anchors numerator")
    if cfg.sort_by != "ref":
        raise NotImplementedError("engine implements ref-sorted chaining")
    if cfg.chain_scope != "fragment":
        raise NotImplementedError("engine implements fragment-scoped chains")
    if cfg.bridge_gap != 0 or cfg.weighted_mean or not cfg.ani_cap:
        raise NotImplementedError
    if cfg.span_source != "kept" or cfg.span_extend != 0:
        raise NotImplementedError("engine implements kept-chain spans")
    if cfg.est_side not in ("chunk", "both"):
        raise NotImplementedError("engine implements chunk/both est_side")
    if cfg.min_span_cover != 0:
        raise NotImplementedError("engine implements min_span_cover=0")


def _contig_layout(sk: DeviceSketch, fl: int):
    """(contig_starts, frag_offsets) in global coordinates, plus counts."""
    clens = sk.contig_lengths
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32),
                              jnp.cumsum(clens, dtype=jnp.int32)])
    nfr = jnp.where(jnp.arange(clens.shape[0]) < sk.n_contigs,
                    -(-clens // fl), 0).astype(jnp.int32)
    frag_offs = jnp.concatenate([jnp.zeros(1, jnp.int32),
                                 jnp.cumsum(nfr, dtype=jnp.int32)])
    return starts, frag_offs


def _join_anchors(ref: DeviceSketch, query: DeviceSketch, cfg: ChainConfig,
                  budgets: EngineBudgets):
    """Cartesian anchors of shared non-repetitive k-mers (static budget).

    Sort-based merge join: the two seed tables are concatenated with a
    source tag and sorted ONCE by (kmer, tag, index); run arithmetic on
    the sorted stream (cummax/cumsum segmented ops) yields, for every
    query occurrence, the position and length of its kmer's reference run
    — no binary searches.  Output slots are in query-occurrence-major
    order, matching the oracle's join order so later stable sorts
    tie-break identically.
    """
    Sq, Sr = query.seed_budget, ref.seed_budget
    n = Sq + Sr
    kmer = jnp.concatenate([ref.kmers, query.kmers])
    # pack (tag, original index) into one sort payload: tag in bit 30
    packed = jnp.concatenate([
        jnp.arange(Sr, dtype=jnp.int32),
        jnp.arange(Sq, dtype=jnp.int32) | jnp.int32(1 << 30),
    ])
    kmer_s, packed_s = jax.lax.sort((kmer, packed), num_keys=2)
    tag_q = packed_s >= (1 << 30)
    orig = packed_s & jnp.int32((1 << 30) - 1)

    i = jnp.arange(n, dtype=jnp.int32)
    first = jnp.concatenate([jnp.ones(1, bool), kmer_s[1:] != kmer_s[:-1]])
    run_start = jax.lax.cummax(jnp.where(first, i, 0))
    # within a run all ref entries precede all query entries (tag order),
    # so a query entry's ref-run is [run_start, run_start + rc)
    r_excl = jnp.cumsum((~tag_q).astype(jnp.int32)) - (~tag_q).astype(jnp.int32)
    # ref entries before me within my run (= the whole ref run, since all
    # ref entries of a run sort before its query entries);
    # r_excl[run_start] via cummax fill — r_excl is non-decreasing, so
    # the running max of its run-start samples equals the gather
    rc = jnp.where(
        tag_q, r_excl - jax.lax.cummax(jnp.where(first, r_excl, 0)),
        0).astype(jnp.int32)
    is_sent = kmer_s == jnp.uint32(0xFFFFFFFF)
    own_mult_q = query.own_mult[jnp.minimum(orig, Sq - 1)]
    ok = tag_q & (~is_sent) & (own_mult_q <= cfg.max_seed_multiplicity) & \
        (rc > 0) & (rc <= cfg.max_seed_multiplicity)
    counts = jnp.where(ok, rc, 0)
    offs = jnp.cumsum(counts) - counts          # exclusive prefix
    want = offs[-1] + counts[-1]
    total = jnp.minimum(want, budgets.max_anchors)

    A = budgets.max_anchors
    t = jnp.arange(A, dtype=jnp.int32)
    # invert the prefix: source tagged position for each output slot via
    # scatter of run offsets + cummax (no binary search)
    slot0 = jnp.where(ok, offs, A)
    src_map = jnp.zeros(A + 1, jnp.int32).at[slot0].max(i)
    src = jax.lax.cummax(src_map[:A])
    j = t - offs[src]
    a_valid = t < total
    q_orig = orig[src]
    r_sorted_idx = jnp.minimum(run_start[src] + j, n - 1)
    r_orig = jnp.minimum(orig[r_sorted_idx], Sr - 1)

    return dict(
        qpos=jnp.where(a_valid, query.positions[q_orig], I32_SENTINEL),
        qcid=jnp.where(a_valid, query.contig_ids[q_orig], I32_SENTINEL),
        rpos=jnp.where(a_valid, ref.positions[r_orig], I32_SENTINEL),
        rcid=jnp.where(a_valid, ref.contig_ids[r_orig], I32_SENTINEL),
        rev=query.strands[q_orig] != ref.strands[r_orig],
        valid=a_valid,
        n_anchors=total,
        anchors_overflow=want > budgets.max_anchors,
    )


def _pre_dp(ref: DeviceSketch, query: DeviceSketch, cfg: ChainConfig,
            budgets: EngineBudgets):
    """Anchors -> sorted -> [NF, PF] grid (everything before the DP).

    Returns (grid dict, n_anchors).  Grid fields qpos/rpos/meta feed the
    DP; qcid/rcid/rev/valid are unpacked views of meta for the stats.
    """
    fl = cfg.fragment_length
    NF = budgets.max_fragments
    PF = budgets.max_anchors_per_fragment
    C = query.contig_lengths.shape[0]

    _, q_frag_offs = _contig_layout(query, fl)
    a = _join_anchors(ref, query, cfg, budgets)

    cid_safe = jnp.clip(a["qcid"], 0, C - 1)
    frag = q_frag_offs[cid_safe] + a["qpos"] // fl
    valid = a["valid"]
    # anchors whose fragment exceeds the grid budget are silently
    # dropped by the row-bounded grid build below — report it loudly
    # (check_overflow raises: results would be truncated).  This is the
    # full-range path's only budget-bound coordinate, so callers with
    # multi-Gbp genomes must size max_fragments to the genome.
    frag_overflow = jnp.any(valid & (frag >= NF))

    # ---- sort anchors by (frag, rcid, rpos, qpos): the full-range
    # ("wide") order.  The query contig id is constant within a fragment,
    # so this equals the stable 5-key (frag, rcid, rpos, qcid, qpos)
    # order, and (frag, rcid, rpos, qpos) is unique per anchor so the
    # non-stable 4-key sort is total and deterministic.  All operands are
    # plain per-contig int32 coordinates — NO packing, so this path has
    # no genome-total or contig-length coordinate cap (reference
    # contract: positions are full-width GnPosition and totals are usize,
    # lib.rs:160; the packed block/triangle paths cap query totals at
    # 2^30 and route larger genomes here).
    frag_k = jnp.where(valid, frag, I32_SENTINEL)
    rcid_k = jnp.where(valid, a["rcid"], I32_SENTINEL)
    rpos_k = jnp.where(valid, a["rpos"], I32_SENTINEL)
    qpos_k = jnp.where(valid, a["qpos"], I32_SENTINEL)
    flags = (a["rev"].astype(jnp.int32) << 1) | valid.astype(jnp.int32)
    frag_s, rcid_s, rpos_s, qpos_s, flags_s = jax.lax.sort(
        (frag_k, rcid_k, rpos_k, qpos_k, flags), num_keys=4)

    valid_s = (flags_s & 1) == 1
    rev_s = (flags_s & 2) == 2
    frag_s = jnp.where(valid_s, frag_s, I32_SENTINEL)
    # fragment -> query contig lookup table (also used post-DP)
    frag_ids = jnp.arange(NF, dtype=jnp.int32)
    frag_cid_tab = jnp.clip(
        (jnp.searchsorted(q_frag_offs, frag_ids, side="right") - 1
         ).astype(jnp.int32), 0, C - 1)
    qcid_s = frag_cid_tab[jnp.clip(frag_s, 0, NF - 1)]

    # the stream is sorted by fragment (k1's high bits), so each grid
    # row is a contiguous run: build the planes by per-row sliced gather
    # (same trick as _grid_from_sorted_stream; anchors past a row's
    # first PF are simply never read)
    A = frag_s.shape[0]
    # small fields packed: qcid[30:17] rcid[16:3] rev[1] valid[0]
    # (contig ids < 16384 by budget)
    meta = jnp.where(
        valid_s,
        (qcid_s.astype(jnp.int32) << 17) | (rcid_s.astype(jnp.int32) << 3)
        | (rev_s.astype(jnp.int32) << 1) | 1,
        0)
    row_bounds = jnp.searchsorted(
        frag_s, jnp.arange(NF + 1, dtype=jnp.int32),
        side="left").astype(jnp.int32)
    starts_r = row_bounds[:-1]
    counts_r = row_bounds[1:] - starts_r
    cols = jnp.arange(PF, dtype=jnp.int32)
    idx = jnp.minimum(starts_r[:, None] + cols[None, :], A - 1)
    ok_g = cols[None, :] < jnp.minimum(counts_r, PF)[:, None]
    stacked = jnp.stack([qpos_s, rpos_s, meta], axis=1)   # [A, 3]
    g = stacked[idx]                                      # [NF, PF, 3]
    grid = {
        "qpos": jnp.where(ok_g, g[:, :, 0], I32_SENTINEL),
        "rpos": jnp.where(ok_g, g[:, :, 1], I32_SENTINEL),
        "meta": jnp.where(ok_g, g[:, :, 2], 0),
    }
    return grid, a["n_anchors"], a["anchors_overflow"], frag_overflow


def _unpack_meta(grid):
    meta_g = grid["meta"]
    return dict(
        qpos=grid["qpos"], rpos=grid["rpos"], meta=meta_g,
        qcid=jnp.where(meta_g != 0, meta_g >> 17, I32_SENTINEL),
        rcid=jnp.where(meta_g != 0, (meta_g >> 3) & 0x3FFF, I32_SENTINEL),
        rev=((meta_g >> 1) & 1).astype(bool),
        valid=(meta_g & 1).astype(bool),
    )


def _dp_dispatch(grid, cfg: ChainConfig, budgets: EngineBudgets):
    """Pick the DP implementation: the compiled Pallas kernel on a GPU,
    the ``lax.scan`` reference everywhere else.

    ``grid`` rows (fragments) are independent, so callers may pass any
    number of rows — including several pairs' grids stacked together.
    """
    if jax.default_backend() == "gpu":
        from . import chain_dp_pallas
        score_t, root_t = chain_dp_pallas.dp_pallas(
            grid["qpos"].T, grid["rpos"].T, grid["meta"].T, cfg,
            interpret=False)
        return score_t.T, root_t.T
    return _dp_scan(_unpack_meta(grid), cfg, budgets)


def _dp_scan(grid, cfg: ChainConfig, budgets: EngineBudgets):
    """Banded chain DP over the [NF, PF] anchor grid.

    Returns (scores [NF, PF], roots [NF, PF]): roots are the grid column
    index of each anchor's chain head (oracle: union-find component).
    """
    NF, PF = grid["qpos"].shape
    band = cfg.chain_band

    def step(carry, xs):
        # carry: dict of [NF, band] windows (slot 0 = most recent)
        cur = xs  # dict of [NF]
        w = carry
        dr = cur["rpos"][:, None] - w["rpos"]
        dq_f = cur["qpos"][:, None] - w["qpos"]
        dq = jnp.where(cur["rev"][:, None], -dq_f, dq_f)
        same = (w["rcid"] == cur["rcid"][:, None]) & \
               (w["qcid"] == cur["qcid"][:, None]) & \
               (w["rev"] == cur["rev"][:, None]) & w["valid"] & \
               cur["valid"][:, None]
        gap = jnp.abs(dr - dq)
        ok = same & (dr > 0) & (dq > 0) & (gap < cfg.max_gap_length)
        cand = w["score"] + cfg.anchor_score - gap.astype(jnp.float32) * cfg.gap_cost_scale
        cand = jnp.where(ok, cand, -jnp.inf)
        best = jnp.max(cand, axis=1)
        extend = best > cfg.anchor_score
        # tie-break: the oracle scans predecessors nearest-first and keeps
        # the first strict improvement, so ties resolve to the most recent
        # predecessor = smallest window slot index.
        is_best = cand == best[:, None]
        slot_ids = jnp.arange(band, dtype=jnp.int32)[None, :]
        best_slot = jnp.min(jnp.where(is_best, slot_ids, band), axis=1)
        best_slot = jnp.minimum(best_slot, band - 1)
        root_of_best = jnp.take_along_axis(w["root"], best_slot[:, None],
                                           axis=1)[:, 0]
        score = jnp.where(extend, best, cfg.anchor_score)
        root = jnp.where(extend & cur["valid"], root_of_best, cur["col"])
        # push current anchor into window slot 0
        new_w = {}
        for key in ("rpos", "qpos", "rcid", "qcid"):
            new_w[key] = jnp.concatenate(
                [cur[key][:, None], w[key][:, :-1]], axis=1)
        new_w["rev"] = jnp.concatenate([cur["rev"][:, None], w["rev"][:, :-1]],
                                       axis=1)
        new_w["valid"] = jnp.concatenate(
            [cur["valid"][:, None], w["valid"][:, :-1]], axis=1)
        new_w["score"] = jnp.concatenate([score[:, None], w["score"][:, :-1]],
                                         axis=1)
        new_w["root"] = jnp.concatenate([root[:, None], w["root"][:, :-1]],
                                        axis=1)
        return new_w, (score, root)

    init = {
        "rpos": jnp.full((NF, band), I32_SENTINEL),
        "qpos": jnp.full((NF, band), I32_SENTINEL),
        "rcid": jnp.full((NF, band), I32_SENTINEL),
        "qcid": jnp.full((NF, band), I32_SENTINEL),
        "rev": jnp.zeros((NF, band), bool),
        "valid": jnp.zeros((NF, band), bool),
        "score": jnp.full((NF, band), -jnp.inf, jnp.float32),
        "root": jnp.zeros((NF, band), jnp.int32),
    }
    xs = {
        "rpos": grid["rpos"].T, "qpos": grid["qpos"].T,
        "rcid": grid["rcid"].T, "qcid": grid["qcid"].T,
        "rev": grid["rev"].T, "valid": grid["valid"].T,
        "col": jnp.broadcast_to(jnp.arange(PF, dtype=jnp.int32)[:, None],
                                (PF, NF)),
    }
    _, (scores, roots) = jax.lax.scan(step, init, xs)
    return scores.T, roots.T  # [NF, PF]


def _union_length(lo: jax.Array, hi: jax.Array, valid: jax.Array) -> jax.Array:
    """Total length of the union of inclusive intervals [lo, hi] (global
    coordinates; intervals never span contigs)."""
    lo_s = jnp.where(valid, lo, POS_BIG)
    hi_s = jnp.where(valid, hi, NEG_BIG)
    # order within equal-lo ties is irrelevant to the union: non-stable
    lo_s, hi_s = jax.lax.sort((lo_s, hi_s), num_keys=1, is_stable=False)
    cmax = jax.lax.cummax(hi_s)
    prev = jnp.concatenate([jnp.full(1, NEG_BIG), cmax[:-1]])
    contrib = jnp.maximum(0, hi_s - jnp.maximum(lo_s - 1, prev))
    contrib = jnp.where(hi_s == NEG_BIG, 0, contrib)
    return jnp.sum(contrib)


def _union_length_seg(cid: jax.Array, lo: jax.Array, hi: jax.Array,
                      valid: jax.Array) -> jax.Array:
    """Total length of the union of inclusive intervals [lo, hi], grouped
    by contig id (intervals never span contigs).

    Full-range variant of :func:`_union_length`: coordinates stay
    per-contig int32 (no genome-global cumsum), so it is exact for
    genomes of any total length — the reference has no coordinate cap
    (lib.rs:160).  The segmented running max is one associative scan;
    the final sum accumulates in f32 (exact for unions < 2^24 bp, i.e.
    every golden fixture; beyond that the relative error is ~1e-7, far
    inside the 4-decimal AF contract).
    """
    cid_s = jnp.where(valid, cid, I32_SENTINEL)
    lo_s = jnp.where(valid, lo, I32_SENTINEL)
    hi_s = jnp.where(valid, hi, NEG_BIG)
    cid_s, lo_s, hi_s = jax.lax.sort((cid_s, lo_s, hi_s), num_keys=2,
                                     is_stable=False)

    # segmented inclusive running max of hi within each contig run
    def comb(a, b):
        return (b[0], jnp.where(a[0] == b[0], jnp.maximum(a[1], b[1]), b[1]))

    _, cmax = jax.lax.associative_scan(comb, (cid_s, hi_s))
    first = jnp.concatenate([jnp.ones(1, bool), cid_s[1:] != cid_s[:-1]])
    prev = jnp.where(first, NEG_BIG,
                     jnp.concatenate([jnp.full(1, NEG_BIG), cmax[:-1]]))
    contrib = jnp.maximum(0, hi_s - jnp.maximum(lo_s - 1, prev))
    contrib = jnp.where(hi_s == NEG_BIG, 0, contrib)
    return jnp.sum(contrib.astype(jnp.float32))


def _searchsorted_bounded(arr: jax.Array, lo_b: jax.Array, hi_b: jax.Array,
                          vals: jax.Array, side: str = "left") -> jax.Array:
    """Binary search of ``vals`` within per-element segments
    [lo_b, hi_b) of the ascending array ``arr`` (same manual-gather
    formulation as :func:`_searchsorted_rows`)."""
    S = arr.shape[0]
    if S == 0:
        return jnp.zeros(vals.shape, jnp.int32)
    lo = jnp.broadcast_to(lo_b, vals.shape).astype(jnp.int32)
    hi = jnp.broadcast_to(hi_b, vals.shape).astype(jnp.int32)
    for _ in range(max(1, int(np.ceil(np.log2(S + 1))))):
        go = lo < hi
        mid = (lo + hi) >> 1
        tv = arr[jnp.clip(mid, 0, S - 1)]
        pred = (tv < vals) if side == "left" else (tv <= vals)
        lo = jnp.where(go & pred, mid + 1, lo)
        hi = jnp.where(go & ~pred, mid, hi)
    return lo


def _denom_tables(sk: DeviceSketch, cfg: ChainConfig):
    """(contig segment bounds [C+1], eligible-seed prefix [S+1]) over the
    position-sorted seed view — the full-range counterpart of
    :func:`_denom_prefix`.  The p-view is sorted by (contig, position)
    with sentinel padding last, so seg[c] is the first row of contig c
    and denominator counts become per-contig bounded binary searches;
    no genome-global coordinate is ever formed."""
    C = sk.contig_lengths.shape[0]
    denom_thr = cfg.denom_mask_mult or cfg.max_seed_multiplicity
    p_valid = jnp.arange(sk.seed_budget) < sk.n_seeds
    if cfg.mask_repetitive_denom == "none":
        p_ok = p_valid
    else:
        p_ok = p_valid & (sk.p_own_mult <= denom_thr)
    seg = jnp.searchsorted(
        sk.p_contig_ids, jnp.arange(C + 1, dtype=jnp.int32),
        side="left").astype(jnp.int32)
    prefix = jnp.concatenate([jnp.zeros(1, jnp.int32),
                              jnp.cumsum(p_ok.astype(jnp.int32))])
    return seg, prefix


def _count_seeds_in_spans(sk: DeviceSketch, seg: jax.Array, prefix: jax.Array,
                          cid: jax.Array, lo: jax.Array, hi: jax.Array):
    """Denominator-eligible seeds of contig ``cid`` with position in
    [lo, hi], per element (shapes broadcast together)."""
    C = sk.contig_lengths.shape[0]
    cid_c = jnp.clip(cid, 0, C - 1)
    s_lo, s_hi = seg[cid_c], seg[cid_c + 1]
    i_lo = _searchsorted_bounded(sk.p_positions, s_lo, s_hi, lo)
    i_hi = _searchsorted_bounded(sk.p_positions, s_lo, s_hi, hi + 1)
    return prefix[i_hi] - prefix[i_lo]


def _interp_quantile(sorted_vals: jax.Array, n: jax.Array, q: float) -> jax.Array:
    """Linear-interpolation quantile of the first n entries (np.quantile)."""
    pos = q * (n.astype(jnp.float32) - 1.0)
    lo = jnp.floor(pos).astype(jnp.int32)
    hi = jnp.minimum(lo + 1, n - 1)
    w = pos - lo.astype(jnp.float32)
    return sorted_vals[lo] * (1 - w) + sorted_vals[hi] * w


def _searchsorted_rows(table: jax.Array, rows: jax.Array, vals: jax.Array,
                       side: str = "left") -> jax.Array:
    """Vectorized ``searchsorted(table[rows[i]], vals[i])`` without
    materializing a table row per query.

    ``table`` is [G, S] with each row ascending; ``rows``/``vals`` share
    an arbitrary shape.  A manual binary search costs log2(S) gathers of
    ``vals.size`` elements — the vmapped alternative gathers a full [S]
    row per query, which dominated the estimator tail (one seed-table
    gather per PAIR for only NF searches each).
    """
    S = table.shape[-1]
    if S == 0:  # e.g. a store of seed=False sketches (no positions)
        return jnp.zeros(vals.shape, jnp.int32)
    lo = jnp.zeros(vals.shape, jnp.int32)
    hi = jnp.full(vals.shape, S, jnp.int32)
    for _ in range(max(1, int(np.ceil(np.log2(S + 1))))):
        mid = (lo + hi) >> 1
        tv = table[rows, jnp.clip(mid, 0, S - 1)]
        pred = (tv < vals) if side == "left" else (tv <= vals)
        go = lo < hi
        lo = jnp.where(go & pred, mid + 1, lo)
        hi = jnp.where(go & ~pred, mid, hi)
    return lo


def _denom_prefix(sk: DeviceSketch, starts: jax.Array, cfg: ChainConfig):
    """(sorted global seed positions, prefix counts of denominator-eligible
    seeds) for one sketch — shared by both estimation grids."""
    C = sk.contig_lengths.shape[0]
    denom_thr = cfg.denom_mask_mult or cfg.max_seed_multiplicity
    p_valid = jnp.arange(sk.seed_budget) < sk.n_seeds
    if cfg.mask_repetitive_denom == "none":
        p_ok = p_valid
    else:
        p_ok = p_valid & (sk.p_own_mult <= denom_thr)
    p_cid_safe = jnp.clip(sk.p_contig_ids, 0, C - 1)
    p_gpos = jnp.where(p_valid, starts[p_cid_safe] + sk.p_positions, POS_BIG)
    prefix = jnp.concatenate([jnp.zeros(1, jnp.int32),
                              jnp.cumsum(p_ok.astype(jnp.int32))])
    return p_gpos, prefix


_REF_SPAN_PIECES = 4  # a chain's ref interval can cross ref-fragment
                      # boundaries (chains are query-fragment scoped);
                      # spans <= ~fragment_length+drift fit in 4 pieces


def _ref_spans(clens_r: jax.Array, r_fo: jax.Array, keep_f: jax.Array,
               rmn_f: jax.Array, rmx_f: jax.Array, rcid_f: jax.Array,
               cfg: ChainConfig, NF: int):
    """Kept-chain coverage spans over the REFERENCE fragment grid for one
    pair — the span-scatter half of :func:`_ref_grid_estimates` (the
    denominator half runs batched over per-genome tables in the block
    tail).  Returns (span_lo [NF], span_hi [NF]) in contig-local
    coordinates."""
    fl = cfg.fragment_length
    Cr = clens_r.shape[0]
    rcid_safe = jnp.clip(rcid_f, 0, Cr - 1)
    lo = jnp.maximum(rmn_f - cfg.extend_left, 0)
    hi = jnp.minimum(rmx_f + cfg.extend_right, clens_r[rcid_safe] - 1)
    f0_local = lo // fl
    # min-identity is I32_SENTINEL, not POS_BIG: contig-local positions
    # go up to 2^31 on the full-range path, so a 2^30 fill value would
    # shadow real coordinates beyond 1 Gbp
    span_lo = jnp.full(NF + 1, I32_SENTINEL)
    span_hi = jnp.full(NF + 1, NEG_BIG)
    for j in range(_REF_SPAN_PIECES):
        base = (f0_local + j) * fl
        plo = jnp.maximum(lo, base)
        phi = jnp.minimum(hi, base + fl - 1)
        fj = r_fo[rcid_safe] + f0_local + j
        okp = keep_f & (plo <= phi) & (fj < NF)
        slot = jnp.where(okp, fj, NF)
        span_lo = span_lo.at[slot].min(jnp.where(okp, plo, I32_SENTINEL))
        span_hi = span_hi.at[slot].max(jnp.where(okp, phi, NEG_BIG))
    return span_lo[:NF], span_hi[:NF]


def _ref_grid_estimates(ref: DeviceSketch, keep_f: jax.Array,
                        rmn_f: jax.Array, rmx_f: jax.Array,
                        rcid_f: jax.Array, numer_r: jax.Array,
                        cfg: ChainConfig, NF: int):
    """Fragment-ANI estimates over the REFERENCE fragment grid.

    est_side="both" (oracle ChainConfig): the ANI is estimated on the
    fragment grids of BOTH genomes and pooled — kept-chain anchors are
    binned by ref fragment (``numer_r``, caller-computed) and the span
    denominator counts ref seeds between the first and last kept-chain
    coverage inside each ref fragment.  Chains arrive as flat arrays
    (``keep_f``/``rmn_f``/``rmx_f``/``rcid_f``); their ref intervals are
    split across fragment boundaries into <= _REF_SPAN_PIECES pieces,
    mirroring the oracle's _span_per_fragment.

    Returns (frag_ani [NF] with +inf at uncovered slots, covered [NF]).
    """
    fl = cfg.fragment_length
    Cr = ref.contig_lengths.shape[0]
    _, r_frag_offs = _contig_layout(ref, fl)
    span_lo, span_hi = _ref_spans(ref.contig_lengths, r_frag_offs,
                                  keep_f, rmn_f, rmx_f, rcid_f, cfg, NF)

    # full-range denominator: per-contig bounded searches over the
    # position-sorted seed view (no genome-global coordinates)
    seg, prefix = _denom_tables(ref, cfg)
    frag_ids = jnp.arange(NF, dtype=jnp.int32)
    frag_cid = jnp.clip(
        (jnp.searchsorted(r_frag_offs, frag_ids, side="right") - 1
         ).astype(jnp.int32), 0, Cr - 1)
    denom = _count_seeds_in_spans(ref, seg, prefix, frag_cid,
                                  span_lo, span_hi)

    covered = numer_r >= jnp.maximum(1, cfg.min_frag_anchors)
    ratio = jnp.minimum(numer_r.astype(jnp.float32) /
                        jnp.maximum(denom.astype(jnp.float32), 1.0), 1.0)
    frag_ani = jnp.where(covered, ratio ** (1.0 / float(cfg.k)), jnp.inf)
    return frag_ani, covered


def _pooled_estimators(fa: jax.Array, covered: jax.Array,
                       cfg: ChainConfig):
    """mean / 10-90% trimmed mean / median (+ optional bootstrap CI) of
    the covered entries of ``fa`` (+inf at uncovered slots)."""
    M = fa.shape[0]
    n_cov = jnp.sum(covered, dtype=jnp.int32)
    s = jnp.sort(fa)
    mean = jnp.sum(jnp.where(covered, fa, 0.0)) / \
        jnp.maximum(n_cov.astype(jnp.float32), 1.0)
    q10 = _interp_quantile(s, n_cov, 0.1)
    q90 = _interp_quantile(s, n_cov, 0.9)
    in_win = (s >= q10) & (s <= q90) & (jnp.arange(M) < n_cov)
    robust = jnp.sum(jnp.where(in_win, s, 0.0)) / \
        jnp.maximum(jnp.sum(in_win, dtype=jnp.float32), 1.0)
    mid_hi = jnp.clip(n_cov // 2, 0, M - 1)
    mid_lo = jnp.clip((n_cov - 1) // 2, 0, M - 1)
    med = 0.5 * (s[mid_lo] + s[mid_hi])
    no_cov = n_cov == 0
    out = dict(
        ani_mean=jnp.where(no_cov, 0.0, mean),
        ani_robust=jnp.where(no_cov, 0.0, robust),
        ani_median=jnp.where(no_cov, 0.0, med),
        n_fragments=n_cov,
    )
    if cfg.est_ci:
        R = cfg.ci_iterations
        key = jax.random.PRNGKey(1539)
        idx = jax.random.randint(key, (R, M), 0, jnp.maximum(n_cov, 1))
        cols = jnp.arange(M, dtype=jnp.int32)[None, :] < n_cov
        boot = jnp.sum(jnp.where(cols, s[idx], 0.0), axis=1) / \
            jnp.maximum(n_cov.astype(jnp.float32), 1.0)
        boot_s = jnp.sort(boot)
        out["ani_ci_low"] = jnp.where(
            no_cov, 0.0, _interp_quantile(boot_s, jnp.int32(R), 0.05))
        out["ani_ci_high"] = jnp.where(
            no_cov, 0.0, _interp_quantile(boot_s, jnp.int32(R), 0.95))
    return out


def _post_dp(ref: DeviceSketch, query: DeviceSketch, grid, scores, roots,
             cfg: ChainConfig, budgets: EngineBudgets):
    """Chain stats, estimators and aligned fractions (after the DP).

    Full-range: every coordinate stays per-contig int32 (denominators via
    per-contig bounded searches, AF via the segmented interval union), so
    this path supports genomes of any total length and contigs up to
    2^31 bp — matching the reference's full-width GnPosition / usize
    totals (lib.rs:160).
    """
    fl = cfg.fragment_length
    NF = budgets.max_fragments
    PF = budgets.max_anchors_per_fragment

    _, q_frag_offs = _contig_layout(query, fl)
    grid = _unpack_meta(grid)

    # ---- per-chain stats: scatter into [NF, PF] bins keyed by root ----
    rows = jnp.broadcast_to(jnp.arange(NF, dtype=jnp.int32)[:, None], (NF, PF))
    v = grid["valid"]
    rootc = jnp.where(v, roots, PF)
    c_count = jnp.zeros((NF, PF + 1), jnp.int32).at[rows, rootc].add(
        v.astype(jnp.int32))[:, :PF]
    c_score = jnp.full((NF, PF + 1), -jnp.inf).at[rows, rootc].max(
        jnp.where(v, scores, -jnp.inf))[:, :PF]
    c_qmin = jnp.full((NF, PF + 1), I32_SENTINEL).at[rows, rootc].min(
        jnp.where(v, grid["qpos"], I32_SENTINEL))[:, :PF]
    c_qmax = jnp.full((NF, PF + 1), NEG_BIG).at[rows, rootc].max(
        jnp.where(v, grid["qpos"], NEG_BIG))[:, :PF]
    c_rmin = jnp.full((NF, PF + 1), I32_SENTINEL).at[rows, rootc].min(
        jnp.where(v, grid["rpos"], I32_SENTINEL))[:, :PF]
    c_rmax = jnp.full((NF, PF + 1), NEG_BIG).at[rows, rootc].max(
        jnp.where(v, grid["rpos"], NEG_BIG))[:, :PF]
    # all anchors of a chain share (qcid, rcid): pack both into ONE
    # scatter (qcid<<14|rcid, both < 2^14)
    qrcid = (grid["qcid"] << 14) | grid["rcid"]
    c_qrcid = jnp.full((NF, PF + 1), I32_SENTINEL).at[rows, rootc].min(
        jnp.where(v, qrcid, I32_SENTINEL))[:, :PF]
    c_qcid = jnp.where(c_qrcid == I32_SENTINEL, I32_SENTINEL, c_qrcid >> 14)
    c_rcid = jnp.where(c_qrcid == I32_SENTINEL, I32_SENTINEL,
                       c_qrcid & 0x3FFF)

    keep = (c_count >= cfg.min_anchors_chain)
    if cfg.min_chain_score > 0:
        keep &= c_score >= cfg.min_chain_score
    if cfg.keep_long_span > 0:
        # low-score chains bridging a long near-diagonal gap survive
        # (oracle ChainConfig.keep_long_span; pinned by the golden af_ref)
        keep |= (c_count >= 2) & ((c_qmax - c_qmin) >= cfg.keep_long_span)
    keep &= c_count > 0

    # ---- per-fragment numerator / span denominator ----
    numer = jnp.sum(jnp.where(keep, c_count, 0), axis=1)  # [NF]

    frag_ids = jnp.arange(NF, dtype=jnp.int32)
    # contig id of each fragment + its base position (query side)
    frag_cid = (jnp.searchsorted(q_frag_offs, frag_ids, side="right") - 1
                ).astype(jnp.int32)
    frag_cid = jnp.clip(frag_cid, 0, query.contig_lengths.shape[0] - 1)
    frag_base = (frag_ids - q_frag_offs[frag_cid]) * fl
    frag_clen = query.contig_lengths[frag_cid]
    frag_end = jnp.minimum(frag_base + fl - 1, frag_clen - 1)

    ext_l, ext_r = cfg.extend_left, cfg.extend_right
    span_lo = jnp.min(jnp.where(keep, c_qmin - ext_l, I32_SENTINEL), axis=1)
    span_hi = jnp.max(jnp.where(keep, c_qmax + ext_r, NEG_BIG), axis=1)
    span_lo = jnp.maximum(span_lo, frag_base)
    span_hi = jnp.minimum(span_hi, frag_end)

    # denom_mode == "span" (the only supported mode, _check_supported):
    # count denominator-eligible seeds of the fragment's contig with
    # position in [lo, hi] — per-contig bounded searches, full-range
    seg_q, prefix_q = _denom_tables(query, cfg)
    denom = _count_seeds_in_spans(query, seg_q, prefix_q, frag_cid,
                                  span_lo, span_hi)

    covered = numer >= jnp.maximum(1, cfg.min_frag_anchors)
    ratio = jnp.minimum(numer.astype(jnp.float32) /
                        jnp.maximum(denom.astype(jnp.float32), 1.0), 1.0)
    frag_ani = jnp.where(covered, ratio ** (1.0 / cfg_k(query, cfg)), jnp.inf)

    if cfg.est_side == "both":
        # ---- ref-side fragment grid (pooled with the query grid) ----
        Cr = ref.contig_lengths.shape[0]
        _, r_frag_offs = _contig_layout(ref, fl)
        rc2 = jnp.minimum(rootc, PF - 1)
        keep_a = keep[rows, rc2] & v                    # [NF, PF]
        refrag = r_frag_offs[jnp.clip(grid["rcid"], 0, Cr - 1)] + \
            jnp.maximum(grid["rpos"], 0) // fl
        ok_a = keep_a & (refrag < NF)
        numer_r = jnp.zeros(NF + 1, jnp.int32).at[
            jnp.where(ok_a, refrag, NF).reshape(-1)].add(
            ok_a.astype(jnp.int32).reshape(-1))[:NF]
        fa_r, cov_r = _ref_grid_estimates(
            ref, keep.reshape(-1), c_rmin.reshape(-1),
            c_rmax.reshape(-1), c_rcid.reshape(-1), numer_r, cfg, NF)
        fa_all = jnp.concatenate([frag_ani, fa_r])
        cov_all = jnp.concatenate([covered, cov_r])
    else:
        fa_all, cov_all = frag_ani, covered
    est = _pooled_estimators(fa_all, cov_all, cfg)
    n_cov = est["n_fragments"]

    # ---- aligned fractions (per-contig segmented union, full-range) ----
    kf = keep.reshape(-1)
    qcid_safe = jnp.clip(c_qcid.reshape(-1), 0,
                         query.contig_lengths.shape[0] - 1)
    rcid_safe = jnp.clip(c_rcid.reshape(-1), 0,
                         ref.contig_lengths.shape[0] - 1)
    q_lo = jnp.maximum(c_qmin.reshape(-1) - ext_l, 0)
    q_hi = jnp.minimum(c_qmax.reshape(-1) + ext_r,
                       query.contig_lengths[qcid_safe] - 1)
    r_lo = jnp.maximum(c_rmin.reshape(-1) - ext_l, 0)
    r_hi = jnp.minimum(c_rmax.reshape(-1) + ext_r,
                       ref.contig_lengths[rcid_safe] - 1)
    # denominator = sum of contig lengths (padding rows are 0), not the
    # uint32 total_len scalar: exact in f32 below 2^24 bp and correct for
    # genomes beyond the uint32 range
    q_total = jnp.sum(query.contig_lengths.astype(jnp.float32))
    r_total = jnp.sum(ref.contig_lengths.astype(jnp.float32))
    af_q = _union_length_seg(qcid_safe, q_lo, q_hi, kf) / \
        jnp.maximum(q_total, 1.0)
    af_r = _union_length_seg(rcid_safe, r_lo, r_hi, kf) / \
        jnp.maximum(r_total, 1.0)

    out = dict(est, af_query=af_q, af_ref=af_r)
    return out


@functools.partial(jax.jit, static_argnames=("cfg", "budgets"))
def chain_pairs(refs: DeviceSketch, queries: DeviceSketch, *,
                cfg: ChainConfig, budgets: EngineBudgets):
    """Batched pair pipeline: ``refs``/``queries`` are stacked
    DeviceSketch pytrees with leading axis B (pair i = refs[i] vs
    queries[i]).

    Pre-DP (join/sort/grid) and post-DP (stats) are vmapped; the DP
    itself runs ONCE on the merged [B*NF, PF] grid so its sequential
    anchor walk is paid once per batch, not once per pair.  Returns a
    dict of [B] arrays.
    """
    _check_supported(cfg)
    grids, n_anchors, overflow, frag_overflow = jax.vmap(
        lambda r, q: _pre_dp(r, q, cfg, budgets))(refs, queries)
    B, NF, PF = grids["qpos"].shape
    merged = jax.tree.map(lambda x: x.reshape(B * NF, PF), grids)
    scores, roots = _dp_dispatch(merged, cfg, budgets)
    scores = scores.reshape(B, NF, PF)
    roots = roots.reshape(B, NF, PF)
    out = jax.vmap(
        lambda r, q, g, s, ro: _post_dp(r, q, g, s, ro, cfg, budgets))(
        refs, queries, grids, scores, roots)
    out["n_anchors"] = n_anchors
    out["anchors_overflow"] = overflow
    out["frag_overflow"] = frag_overflow
    return out


def rcid_bits_for(C: int) -> int:
    """Bits of the packed block-grid word w2 allotted to the ref contig id.

    Sized from the static contig-table budget ``C`` (a power of two, see
    ops.sketch.contig_budget_for): the remaining ``32 - bits`` go to the
    in-contig position, so single-contig isolates (C=8 -> 3 bits) support
    contigs up to 2^29 bp while 16384-contig MAGs (14 bits) still allow
    256 kbp contigs.  The reference has neither cap (lib.rs:160 GnPosition
    is full-width); genomes outside the packed range are routed through
    the full-range per-pair path by Database.query.
    """
    return max(1, (C - 1).bit_length())


def _pack_grid_words(qpos, rpos, rcid, rev, ok, rcid_bits: int):
    """Pack an anchor into two uint32 grid words:

      w1 = qpos << 2 | rev << 1 | valid          (qpos < 2^30)
      w2 = rpos << rcid_bits | rcid              (rpos < 2^(32-rcid_bits))

    Within a chain, rev and rcid are constant (the DP's same-chain
    predicate requires them equal), so segment min/max of w1/w2 recover
    exact qpos/rpos extrema by shifting.  Contigs >= 2^(32-rcid_bits) bp
    overflow w2 — reported loudly via the pos_overflow output (the
    per-pair chain_pairs path has no such cap).
    """
    rmask = jnp.uint32((1 << rcid_bits) - 1)
    w1 = jnp.where(ok, (qpos.astype(jnp.uint32) << 2) |
                   (rev.astype(jnp.uint32) << 1) | jnp.uint32(1),
                   jnp.uint32(0))
    w2 = jnp.where(ok, (rpos.astype(jnp.uint32) << rcid_bits) |
                   (rcid.astype(jnp.uint32) & rmask), jnp.uint32(0))
    return w1, w2


def _dp_grid_from_words(w1g: jax.Array, w2g: jax.Array,
                        rcid_bits: int) -> dict:
    """Elementwise-derived DP input planes from the packed grid words.

    The synthetic meta keeps the kernel contract (same-chain predicate =
    ``meta >> 1`` equality, valid = bit 0): rcid<<3 | rev<<1 | valid.
    The query contig id is constant within a grid row, so its omission
    cannot split or merge chains.
    """
    rmask = jnp.uint32((1 << rcid_bits) - 1)
    return {"qpos": (w1g >> 2).astype(jnp.int32),
            "rpos": (w2g >> rcid_bits).astype(jnp.int32),
            "meta": (((w2g & rmask) << 3) | (w1g & 3)).astype(jnp.int32)}


def _grid_from_sorted_stream(rowid_s: jax.Array, w1: jax.Array,
                             w2: jax.Array, P: int, NF: int, PF: int):
    """[P*NF, PF] packed grid planes from the rowid-SORTED anchor stream.

    The stream is sorted by rowid (primary sort key; invalid anchors
    carry a sentinel rowid and sort last), so each grid row is a
    contiguous stream run: row r occupies [bounds[r], bounds[r+1]) and
    grid[r, c] = stream[bounds[r] + c] for c < min(count, PF).  Building
    the grid as a per-row sliced GATHER replaces a full-stream scatter:
    each row reads one contiguous slice instead of one random-access
    write per anchor.  Returns (w1g, w2g, row_bounds [P*NF+1]).
    """
    A = rowid_s.shape[0]
    row_bounds = jnp.searchsorted(
        rowid_s, jnp.arange(P * NF + 1, dtype=jnp.int32),
        side="left").astype(jnp.int32)
    starts_r = row_bounds[:-1]
    counts_r = row_bounds[1:] - starts_r
    cols = jnp.arange(PF, dtype=jnp.int32)
    idx = jnp.minimum(starts_r[:, None] + cols[None, :], A - 1)
    ok_g = cols[None, :] < jnp.minimum(counts_r, PF)[:, None]
    # ONE stacked gather moves both words per resolved index (the
    # per-element index resolution dominates gather cost, so two
    # separate plane gathers pay it twice)
    w12 = jnp.stack([w1, w2], axis=1)                # [A, 2]
    g = w12[idx]                                     # [P*NF, PF, 2]
    w1g = jnp.where(ok_g, g[:, :, 0], jnp.uint32(0))
    w2g = jnp.where(ok_g, g[:, :, 1], jnp.uint32(0))
    return w1g, w2g, row_bounds


def _seg_scan_stats(first: jax.Array, fields: dict, axis: int = 0) -> dict:
    """Fused segmented reduction scan: within each segment (delimited by
    ``first`` flags), running count/min/max/sum per field.  Values at the
    LAST element of each segment are the per-segment reductions.  One
    associative_scan over the whole pytree — linear HBM passes instead of
    the random-access scatters the per-pair stats used.  ``axis`` selects
    the scan dimension (row-wise scans over 2D grids pay log2(PF) levels
    instead of log2(R*PF))."""
    ops = {"cnt": lambda a, b: a + b, "qmn": jnp.minimum,
           "qmx": jnp.maximum, "rmn": jnp.minimum, "rmx": jnp.maximum,
           "smx": jnp.maximum}

    def comb(a, b):
        f = b["flag"]
        out = {"flag": a["flag"] | f}
        for k, v in b.items():
            if k == "flag":
                continue
            out[k] = jnp.where(f, v, ops[k](a[k], v))
        return out

    return jax.lax.associative_scan(comb, dict(fields, flag=first),
                                    axis=axis)


def _post_dp_block(refs: DeviceSketch, queries: DeviceSketch,
                   w1g: jax.Array, w2g: jax.Array,
                   scores: jax.Array, roots: jax.Array, q_starts: jax.Array,
                   q_frag_offs: jax.Array, cfg: ChainConfig,
                   budgets: EngineBudgets, tail_r: jax.Array,
                   tail_q: jax.Array,
                   r_frag_offs: jax.Array | None = None,
                   frag_cid_g: jax.Array | None = None,
                   rcid_bits: int = 8) -> dict:
    """Per-chain statistics + estimators for a block of P pairs.

    ``tail_r``/``tail_q`` [P] map each pair slot to its genome index in
    ``refs``/``queries`` (row-major grid for chain_block, upper-triangle
    list for chain_triangle).

    Replaces the vmapped per-pair scatter reductions (7 scatter ops over
    [NF, PF+1] grids) with a PER-ROW sort of the [R, PF] anchor grid by
    chain root followed by fused per-row segmented scans; per-chain values
    sit at segment ends, and row-level aggregates (fragment numerators,
    spans) are masked row reductions.  Chain segments never span rows, so
    every scan/sort runs along axis -1 (log2(PF) levels, vectorized across
    rows) instead of over the flattened R*PF stream.

    The per-pair tail (AF interval unions, estimators) never touches the
    full anchor stream: kept chain ends are compacted into a
    [P, max_chains_per_pair] table with ONE packed scatter (rank within
    pair via segmented cumsum), so all tail gathers/sorts run on ~1000x
    fewer elements than the padded grid.  Numerically identical to
    _post_dp as long as no pair overflows max_chains_per_pair (overflow
    reported in the n_chains output) — pinned by tests/test_block_join.py.
    """
    fl = cfg.fragment_length
    NF = budgets.max_fragments
    PF = budgets.max_anchors_per_fragment
    P = tail_r.shape[0]
    R = P * NF
    ext_l, ext_r = cfg.extend_left, cfg.extend_right
    rmask = (1 << rcid_bits) - 1

    valid2 = (w1g & 1) == 1
    root2 = jnp.clip(roots, 0, PF - 1)
    # per-row chain key: root slot; invalid anchors go to the per-row
    # overflow bucket PF.  The old global sort key row*(PF+1)+key was
    # row-dominated, so sorting each row independently along axis -1
    # yields the IDENTICAL flattened stream (stable sort, rows already in
    # order) for log^2(PF) compare stages instead of log^2(R*PF) — ~7x
    # fewer passes over the payload arrays.
    inkey = jnp.where(valid2, root2, PF)
    inkey_s, w1_s, w2_s, score_s = jax.lax.sort(
        (inkey, w1g, w2g, scores), dimension=1, num_keys=1)

    seg_edge = inkey_s[:, 1:] != inkey_s[:, :-1]
    first = jnp.concatenate([jnp.ones((R, 1), bool), seg_edge], axis=1)
    # segment min/max run on the PACKED words: rev/rcid (the low bits)
    # are constant within a chain, so shifting the extrema recovers the
    # exact qpos/rpos extrema — half the scan payload of separate planes
    scan = _seg_scan_stats(first, dict(
        cnt=jnp.ones((R, PF), jnp.int32), qmn=w1_s, qmx=w1_s,
        rmn=w2_s, rmx=w2_s, smx=score_s), axis=1)
    is_last = jnp.concatenate([seg_edge, jnp.ones((R, 1), bool)], axis=1)
    chain_end = is_last & (inkey_s != PF)
    c_count = scan["cnt"]
    c_score = scan["smx"]
    c_qmn = (scan["qmn"] >> 2).astype(jnp.int32)
    c_qmx = (scan["qmx"] >> 2).astype(jnp.int32)
    keep = chain_end & (c_count >= cfg.min_anchors_chain)
    if cfg.min_chain_score > 0:
        keep &= c_score >= cfg.min_chain_score
    if cfg.keep_long_span > 0:
        keep |= chain_end & (c_count >= 2) & \
            ((c_qmx - c_qmn) >= cfg.keep_long_span)

    # ---- row-level aggregates: masked reductions along the row axis ----
    numer = jnp.sum(jnp.where(keep, c_count, 0), axis=1)           # [R]
    span_lo = jnp.min(jnp.where(keep, c_qmn - ext_l, POS_BIG), axis=1)
    span_hi = jnp.max(jnp.where(keep, c_qmx + ext_r, NEG_BIG), axis=1)

    # ---- compact kept chain ends into [P, CE] tables ----
    # Left-compact kept ends within each row with one cheap row sort
    # (key: exclusive kept rank within the row; non-ends sort right),
    # then pick chain c of pair p at (row, column) located by prefix
    # arithmetic — a [P, CE]-sized gather instead of a full-grid scatter.
    CE = budgets.max_chains_per_pair
    keep_i = keep.astype(jnp.int32)
    row_kc = jnp.sum(keep_i, axis=1)                               # [R]
    rk = row_kc.reshape(P, NF)
    # kept ends before this row within its pair (exclusive row prefix)
    rb2 = jnp.cumsum(rk, axis=1) - rk                              # [P, NF]
    in_row = jnp.cumsum(keep_i, axis=1) - keep_i                   # excl
    pair_of_row = jnp.arange(R, dtype=jnp.int32) // NF             # [R]
    cmp_key = jnp.where(keep, in_row, PF)
    _, s_qmn, s_qmx, s_rmn, s_rmx = jax.lax.sort(
        (cmp_key, scan["qmn"], scan["qmx"], scan["rmn"], scan["rmx"]),
        dimension=1, num_keys=1)
    ce_ids = jnp.broadcast_to(jnp.arange(CE, dtype=jnp.int32)[None, :],
                              (P, CE))
    p_rows = jnp.broadcast_to(jnp.arange(P, dtype=jnp.int32)[:, None],
                              (P, CE))
    # last row of the pair whose kept-prefix is <= c holds chain c:
    # scatter each NON-EMPTY row's id at its kept-prefix offset and
    # cummax-fill along the chain axis.  The binary-search formulation
    # this replaces paid log2(NF) gathers per [P, CE] slot; rows with no
    # kept chains never own a slot, so the fill lands on the true owner
    # for every c < the pair's total (and end_valid rejects the rest,
    # exactly as the search did).
    rows_nf = jnp.broadcast_to(jnp.arange(NF, dtype=jnp.int32)[None, :],
                               (P, NF))
    p_nf = jnp.broadcast_to(jnp.arange(P, dtype=jnp.int32)[:, None],
                            (P, NF))
    slot_ce = jnp.where(rk > 0, jnp.minimum(rb2, CE), CE)
    row_map = jnp.zeros((P, CE + 1), jnp.int32).at[p_nf, slot_ce].max(
        rows_nf)
    row_sel = jax.lax.cummax(row_map[:, :CE], axis=1)
    col_sel = ce_ids - jnp.take_along_axis(rb2, row_sel, axis=1)
    end_valid = (col_sel >= 0) & \
        (col_sel < jnp.take_along_axis(rk, row_sel, axis=1))
    src_row = p_rows * NF + row_sel
    col_cl = jnp.clip(col_sel, 0, PF - 1)
    # ONE stacked gather for the four end planes (per-element index
    # resolution dominates gather cost)
    s4 = jnp.stack([s_qmn, s_qmx, s_rmn, s_rmx], axis=2)  # [R, PF, 4]
    g4 = s4[src_row, col_cl]                              # [P, CE, 4]
    qmn_w, qmx_w, rmn_w, rmx_w = (g4[:, :, w] for w in range(4))
    end_qmn, end_qmx = (
        jnp.where(end_valid, (w >> 2).astype(jnp.int32), I32_SENTINEL)
        for w in (qmn_w, qmx_w))
    end_rmn, end_rmx = (
        jnp.where(end_valid, (w >> rcid_bits).astype(jnp.int32),
                  I32_SENTINEL)
        for w in (rmn_w, rmx_w))
    # rcid rides the low bits of w2 (constant within a chain); the query
    # contig id is a function of the chain's row (fragment), looked up in
    # the tail
    end_rcid = jnp.where(end_valid, (rmn_w & rmask).astype(jnp.int32), 0)
    # kept-chain count per pair (for overflow diagnostics)
    n_chains = jnp.sum(rk, axis=1)                                 # [P]

    if cfg.est_side == "both":
        # ---- ref-fragment numerators over the sorted anchor grid ----
        # each element's chain keep flag lives at its segment END; chain
        # segments never span rows, so propagate the flag backwards with
        # a reversed PER-ROW segmented scan, then bin kept anchors by
        # (pair, ref fragment).
        Cr = refs.contig_lengths.shape[1]
        rev_start = is_last[:, ::-1]
        rev_val = jnp.where(rev_start, keep[:, ::-1], False)

        def _carry(a, b):
            return (a[0] | b[0], jnp.where(b[0], b[1], a[1]))

        _, keep_fill = jax.lax.associative_scan(
            _carry, (rev_start, rev_val), axis=1)
        keep_elem = keep_fill[:, ::-1] & ((w1_s & 1) == 1)
        rcid_el = jnp.clip((w2_s & rmask).astype(jnp.int32), 0, Cr - 1)
        g_of = tail_r[pair_of_row]                    # [R] ref genome id
        flat_off = g_of[:, None] * r_frag_offs.shape[1] + rcid_el
        tab = r_frag_offs.reshape(-1)
        # the per-element fragment-offset lookup and the (pair, refrag)
        # binning run as FUSED compare-reductions when the offset table
        # and the bin axis are small: a K-way masked sum streams the grid
        # with no random access, where a scatter-add + table gather pay
        # one random access per element.  The reduction scales linearly
        # in K and NF though, so for fragmented many-contig stores (large
        # contig buckets / many fragments) the gather + scatter-add
        # formulation wins and is kept as the fallback — both are exact.
        if tab.shape[0] <= 512 and NF <= 512:
            base = jnp.sum(
                jnp.where(flat_off[:, :, None] ==
                          jnp.arange(tab.shape[0], dtype=jnp.int32),
                          tab, 0),
                axis=-1)
            refrag = base + (w2_s >> rcid_bits).astype(jnp.int32) // fl
            ok_el = keep_elem & (refrag < NF)
            row_hist = jnp.sum(
                (ok_el[:, :, None] &
                 (refrag[:, :, None] == jnp.arange(NF, dtype=jnp.int32))
                 ).astype(jnp.int32), axis=1)         # [R, NF]
            numer_r = jnp.sum(row_hist.reshape(P, NF, NF), axis=1)
        else:
            refrag = tab[flat_off] + \
                (w2_s >> rcid_bits).astype(jnp.int32) // fl
            ok_el = keep_elem & (refrag < NF)
            numer_r = jnp.zeros(P * NF + 1, jnp.int32).at[
                jnp.where(ok_el, pair_of_row[:, None] * NF + refrag,
                          P * NF).reshape(-1)].add(
                ok_el.astype(jnp.int32).reshape(-1))[:P * NF].reshape(P,
                                                                      NF)
    else:
        numer_r = jnp.zeros((P, NF), jnp.int32)

    # ---- per-pair tail (denominators, estimators, AF unions) ----
    # The seed-table work (denominator prefixes) is computed ONCE PER
    # GENOME and searched with batched binary search — the old per-pair
    # vmap re-gathered a full seed table per pair (G_r x more data moved
    # than needed) and was the dominant tail cost.
    C = queries.contig_lengths.shape[1]
    Cr = refs.contig_lengths.shape[1]
    frag_ids = jnp.arange(NF, dtype=jnp.int32)

    q_pg, q_pref = jax.vmap(
        lambda q, st: _denom_prefix(q, st, cfg))(queries, q_starts)
    r_starts_all = jax.vmap(lambda r: _contig_layout(r, fl)[0])(refs)
    if cfg.est_side == "both":
        r_pg, r_pref = jax.vmap(
            lambda r, st: _denom_prefix(r, st, cfg))(refs, r_starts_all)

    # query fragment windows, per query genome then indexed per pair
    if frag_cid_g is None:
        frag_cid_g = jnp.clip(jax.vmap(
            lambda fo: jnp.searchsorted(fo, frag_ids, side="right"))(
            q_frag_offs).astype(jnp.int32) - 1, 0, C - 1)    # [G_q, NF]
    frag_base_g = (frag_ids[None, :] - jnp.take_along_axis(
        q_frag_offs, frag_cid_g, axis=1)) * fl
    frag_clen_g = jnp.take_along_axis(queries.contig_lengths,
                                      frag_cid_g, axis=1)
    frag_end_g = jnp.minimum(frag_base_g + fl - 1, frag_clen_g - 1)
    qst_frag_g = jnp.take_along_axis(q_starts, frag_cid_g, axis=1)

    lo = jnp.maximum(span_lo.reshape(P, NF), frag_base_g[tail_q])
    hi = jnp.minimum(span_hi.reshape(P, NF), frag_end_g[tail_q])
    g_lo = qst_frag_g[tail_q] + lo
    g_hi = qst_frag_g[tail_q] + hi
    rows_q = jnp.broadcast_to(tail_q[:, None], (P, NF))
    q_denom = (
        q_pref[rows_q, _searchsorted_rows(q_pg, rows_q, g_hi + 1)] -
        q_pref[rows_q, _searchsorted_rows(q_pg, rows_q, g_lo)])
    numer_p = numer.reshape(P, NF)
    covered_q = numer_p >= jnp.maximum(1, cfg.min_frag_anchors)
    ratio_q = jnp.minimum(numer_p.astype(jnp.float32) /
                          jnp.maximum(q_denom.astype(jnp.float32), 1.0), 1.0)
    frag_ani_q = jnp.where(covered_q, ratio_q ** (1.0 / float(cfg.k)),
                           jnp.inf)

    rcid_e = jnp.clip(end_rcid, 0, Cr - 1)
    # query contig of each chain end: from its row (fragment) via the
    # per-genome fragment->contig table — qcid no longer rides the grid
    qcid_e = frag_cid_g[jnp.broadcast_to(tail_q[:, None], (P, CE)),
                        row_sel]
    if cfg.est_side == "both":
        # ref-fragment coverage spans per pair (small per-pair scatters),
        # then batched denominators over the per-genome ref seed tables
        span_lo_r, span_hi_r = jax.vmap(
            lambda cl, fo, k, rmn, rmx, rc: _ref_spans(
                cl, fo, k, rmn, rmx, rc, cfg, NF))(
            refs.contig_lengths[tail_r], r_frag_offs[tail_r],
            end_valid, end_rmn, end_rmx, rcid_e)
        frag_cid_r = jnp.clip(jax.vmap(
            lambda fo: jnp.searchsorted(fo, frag_ids, side="right"))(
            r_frag_offs).astype(jnp.int32) - 1, 0, Cr - 1)   # [G_r, NF]
        rst_frag_g = jnp.take_along_axis(r_starts_all, frag_cid_r, axis=1)
        g_lo_r = rst_frag_g[tail_r] + span_lo_r
        g_hi_r = rst_frag_g[tail_r] + span_hi_r
        rows_r = jnp.broadcast_to(tail_r[:, None], (P, NF))
        r_denom = (
            r_pref[rows_r, _searchsorted_rows(r_pg, rows_r, g_hi_r + 1)] -
            r_pref[rows_r, _searchsorted_rows(r_pg, rows_r, g_lo_r)])
        covered_r = numer_r >= jnp.maximum(1, cfg.min_frag_anchors)
        ratio_r = jnp.minimum(
            numer_r.astype(jnp.float32) /
            jnp.maximum(r_denom.astype(jnp.float32), 1.0), 1.0)
        fa_r = jnp.where(covered_r, ratio_r ** (1.0 / float(cfg.k)),
                         jnp.inf)
        fa_all = jnp.concatenate([frag_ani_q, fa_r], axis=1)
        cov_all = jnp.concatenate([covered_q, covered_r], axis=1)
    else:
        fa_all, cov_all = frag_ani_q, covered_q

    def tail(qi_idx, g_idx, fa_row, cov_row, keep_e,
             qmn_e, qmx_e, rmn_e, rmx_e, qcid_row, rcid_row):
        q_st = q_starts[qi_idx]
        q_clens = queries.contig_lengths[qi_idx]
        r_st = r_starts_all[g_idx]
        r_clens = refs.contig_lengths[g_idx]

        est = _pooled_estimators(fa_row, cov_row, cfg)

        q_lo = q_st[qcid_row] + jnp.maximum(qmn_e - ext_l, 0)
        q_hi = q_st[qcid_row] + jnp.minimum(
            qmx_e + ext_r, q_clens[qcid_row] - 1)
        r_lo = r_st[rcid_row] + jnp.maximum(rmn_e - ext_l, 0)
        r_hi = r_st[rcid_row] + jnp.minimum(
            rmx_e + ext_r, r_clens[rcid_row] - 1)
        af_q = _union_length(q_lo, q_hi, keep_e).astype(jnp.float32) / \
            jnp.maximum(queries.total_len[qi_idx].astype(jnp.float32), 1.0)
        af_r = _union_length(r_lo, r_hi, keep_e).astype(jnp.float32) / \
            jnp.maximum(refs.total_len[g_idx].astype(jnp.float32), 1.0)

        return dict(est, af_query=af_q, af_ref=af_r)

    out = jax.vmap(tail)(
        tail_q, tail_r, fa_all, cov_all,
        end_valid, end_qmn, end_qmx, end_rmn, end_rmx, qcid_e, rcid_e)
    out["n_chains"] = n_chains
    return out


def _block_join(refs: DeviceSketch, queries: DeviceSketch, cfg: ChainConfig,
                total_anchors: int, q_starts: jax.Array,
                q_frag_offs: jax.Array, NF: int):
    """Anchors for EVERY (ref genome, query genome) pair in ONE sort.

    The per-pair join (_join_anchors) pays a stream sort per pair; here
    the G_r ref seed tables and G_q query seed tables go into a single
    tagged stream, and every query occurrence expands against the whole
    ref run — which contains the matching occurrences of ALL ref genomes,
    each carrying its genome id.  The per-pair multiplicity cap
    (rc <= max_seed_multiplicity) is applied by pre-masking seeds whose
    own within-genome multiplicity exceeds the cap: a k-mer's run length
    within one genome IS its multiplicity there, so dropping over-cap
    seeds up front removes exactly the runs the per-pair join rejects.

    Random-access gathers cost more per element than riding a sort that
    runs anyway, so the per-seed payloads RIDE THE SORT as value operands
    and everything the downstream pipeline needs is packed into two i32
    payload words per seed, precomputed at stream-build time on the (much
    smaller) seed tables:
      ref  entry: p1 = in-contig position, p2 = g<<15 | rcid<<1 | strand
      query entry: p1 = gq<<1 | strand  (gq = genome-global position),
                   p2 = qi*NF + fragment  (-1 if the fragment overflows)
    so each expanded anchor costs 4 payload gathers + 1 run_start gather
    instead of 12 scattered lookups.
    """
    G_r, Sr = refs.kmers.shape
    G_q, Sq = queries.kmers.shape
    C = queries.contig_lengths.shape[1]
    fl = cfg.fragment_length
    cap = cfg.max_seed_multiplicity
    SENT = jnp.uint32(0xFFFFFFFF)
    r_kmers = jnp.where(refs.own_mult <= cap, refs.kmers, SENT).reshape(-1)
    q_kmers = jnp.where(queries.own_mult <= cap, queries.kmers,
                        SENT).reshape(-1)
    NR = G_r * Sr
    NQ = G_q * Sq
    assert NR < (1 << 30) and NQ < (1 << 30) and G_r < (1 << 15)
    n = NR + NQ

    # --- per-seed payload words (seed-table sized, cheap) ---
    g_id = jnp.arange(NR, dtype=jnp.int32) // Sr
    r_p1 = refs.positions.reshape(-1)
    r_p2 = (g_id << 15) | \
        (refs.contig_ids.reshape(-1).astype(jnp.int32) << 1) | \
        refs.strands.reshape(-1).astype(jnp.int32)
    qi_id = jnp.arange(NQ, dtype=jnp.int32) // Sq
    q_cid = jnp.clip(queries.contig_ids.reshape(-1), 0, C - 1)
    q_pos = queries.positions.reshape(-1)
    flat = qi_id * (C + 1) + q_cid
    frag = q_frag_offs.reshape(-1)[flat] + q_pos // fl
    # q_p1 carries the CONTIG-LOCAL position: within a fragment the
    # query contig is fixed, so ordering by qpos equals ordering by
    # (qcid, qpos) and the genome-global coordinate never needs to be
    # formed (carrying it would cost a per-anchor table gather after the
    # rowid sort to convert back to qpos)
    q_p1 = (q_pos << 1) | queries.strands.reshape(-1).astype(jnp.int32)
    q_p2 = jnp.where(frag < NF, qi_id * NF + frag, -1)

    kmer = jnp.concatenate([r_kmers, q_kmers])
    tag = jnp.concatenate([jnp.zeros(NR, jnp.uint8),
                           jnp.ones(NQ, jnp.uint8)])
    p1 = jnp.concatenate([r_p1, q_p1])
    p2 = jnp.concatenate([r_p2, q_p2])
    # keys (kmer, tag): refs sort before queries inside each k-mer run,
    # so a query's preceding-ref count IS the run's full ref count
    kmer_s, tag_s, p1_s, p2_s = jax.lax.sort((kmer, tag, p1, p2),
                                             num_keys=2)
    tag_q = tag_s == 1

    i = jnp.arange(n, dtype=jnp.int32)
    first = jnp.concatenate([jnp.ones(1, bool), kmer_s[1:] != kmer_s[:-1]])
    run_start = jax.lax.cummax(jnp.where(first, i, 0))
    r_excl = jnp.cumsum((~tag_q).astype(jnp.int32)) - (~tag_q).astype(jnp.int32)
    # r_excl[run_start] via a cummax fill instead of an n-scale gather:
    # r_excl is non-decreasing, so the running max of its run-start
    # samples reproduces the gather exactly
    r_excl_rs = jax.lax.cummax(jnp.where(first, r_excl, 0))
    rc = jnp.where(tag_q, r_excl - r_excl_rs, 0).astype(jnp.int32)
    is_sent = kmer_s == SENT
    ok = tag_q & (~is_sent) & (rc > 0)
    counts = jnp.where(ok, rc, 0)
    offs = jnp.cumsum(counts) - counts
    want = offs[-1] + counts[-1]
    total = jnp.minimum(want, total_anchors)

    A = total_anchors
    t = jnp.arange(A, dtype=jnp.int32)
    slot0 = jnp.where(ok, offs, A)
    if cap * (G_r + G_q) <= 255 and n < (1 << 23):
        # ONE packed scatter for (source index, run offset): within a
        # k-mer run every genome contributes at most `cap` premasked
        # occurrences, so i - run_start < cap * (G_r + G_q) fits 8 bits
        # and (i << 8 | delta) stays monotone in i — one scatter instead
        # of two for the anchor inversion
        pm = jnp.zeros(A + 1, jnp.int32).at[slot0].max(
            jnp.where(ok, (i << 8) | (i - run_start), 0))
        fill = jax.lax.cummax(pm[:A])
        src = fill >> 8
        rs_fill = src - (fill & 255)
    else:
        src_map = jnp.zeros(A + 1, jnp.int32).at[slot0].max(i)
        src = jax.lax.cummax(src_map[:A])
        # run_start[src] via a second scatter+cummax instead of a
        # gather: run_start is non-decreasing in i, so the cummax fill
        # between consecutive ok slots reproduces the gather exactly
        rs_map = jnp.zeros(A + 1, jnp.int32).at[slot0].max(
            jnp.where(ok, run_start, 0))
        rs_fill = jax.lax.cummax(rs_map[:A])
    # j = slot rank within its source query = t - (first slot of src),
    # computed scan-style instead of gathering offs[src]
    src_first = jnp.concatenate([jnp.ones(1, bool), src[1:] != src[:-1]])
    j = t - jax.lax.cummax(jnp.where(src_first, t, 0))
    a_valid = t < total
    r_sorted_idx = jnp.minimum(rs_fill + j, n - 1)

    # paired payload tables: one gather moves both words per side
    p12_s = jnp.stack([p1_s, p2_s], axis=1)          # [n, 2]
    qp = p12_s[src]
    rp = p12_s[r_sorted_idx]
    q1, q2 = qp[:, 0], qp[:, 1]
    r1, r2 = rp[:, 0], rp[:, 1]

    qpos_a = q1 >> 1
    ftab = q2                                # qi*NF + frag, or -1
    rpos = r1
    g = r2 >> 15
    rcid = (r2 >> 1) & 0x3FFF
    rev = (q1 & 1) != (r2 & 1)
    a_valid = a_valid & (ftab >= 0)
    qi = jnp.clip(ftab, 0, NQ) // NF
    rowid = g * (G_q * NF) + jnp.maximum(ftab, 0)
    return dict(
        qpos=qpos_a,
        rowid=rowid,
        rpos=jnp.where(a_valid, rpos, I32_SENTINEL),
        rcid=jnp.where(a_valid, rcid, I32_SENTINEL),
        rev=rev,
        valid=a_valid,
        pair=jnp.where(a_valid, g * G_q + qi, (1 << 30)),  # row-major [Gr,Gq]
        n_anchors=total,
        anchors_overflow=want > total_anchors,
    )


@functools.partial(jax.jit,
                   static_argnames=("cfg", "budgets", "total_anchors"))
def chain_block(refs: DeviceSketch, queries: DeviceSketch, *,
                cfg: ChainConfig, budgets: EngineBudgets,
                total_anchors: int | None = None):
    """All-pairs [G_r x G_q] pipeline with ONE join sort and ONE DP.

    ``refs``/``queries`` are stacked DeviceSketch pytrees.  All
    G_r*G_q*NF fragment rows go through the chain DP as lanes of a
    single kernel; per-pair statistics are vmapped.  Returns a dict of
    [G_r, G_q] arrays.

    ``total_anchors`` is the anchor budget for the WHOLE block (default:
    per-pair budget x number of pairs, matching chain_pairs exactly as
    long as no single pair overflows its share of the shared pool).
    """
    _check_supported(cfg)
    fl = cfg.fragment_length
    NF = budgets.max_fragments
    PF = budgets.max_anchors_per_fragment
    G_r = refs.kmers.shape[0]
    G_q = queries.kmers.shape[0]
    P = G_r * G_q
    if P * NF > (1 << 17):
        raise ValueError(f"block too large: pairs*max_fragments = {P * NF} "
                         f"exceeds 2^17 (shrink the block or fragments)")
    if total_anchors is None:
        total_anchors = P * budgets.max_anchors
    C = queries.contig_lengths.shape[1]

    q_starts, q_frag_offs = jax.vmap(
        lambda q: _contig_layout(q, fl))(queries)        # [G_q, C+1]
    a = _block_join(refs, queries, cfg, total_anchors, q_starts,
                    q_frag_offs, NF)
    valid = a["valid"]
    rowid = a["rowid"]                                   # < P*NF <= 2^17

    # key 1 is sorted as uint32 with an all-ones sentinel: the max valid
    # key (rowid<<14)|rcid is 2^31-1 (rowid < 2^17), which EXCEEDS the old
    # int32 POS_BIG=2^30 sentinel once rowid >= 2^16 — an int32 sentinel
    # would sort invalid anchors mid-stream and corrupt rank/scatter slots
    k1 = jnp.where(valid, ((rowid << 14) | a["rcid"]).astype(jnp.uint32),
                   jnp.uint32(0xFFFFFFFF))
    k2 = jnp.where(valid, a["rpos"], POS_BIG)
    # payload carries the CONTIG-LOCAL qpos (the query contig is fixed
    # within a fragment, so the 3-key (k1, k2, qpos) order equals the
    # stable 5-key order, exactly as in chain_triangle)
    payload = jnp.where(
        valid,
        (a["qpos"].astype(jnp.uint32) << 2)
        | (a["rev"].astype(jnp.uint32) << 1) | jnp.uint32(1),
        jnp.uint32(0xFFFFFFFC))
    k1, k2, payload = jax.lax.sort((k1, k2, payload), num_keys=3)

    valid_s = (payload & 1) == 1
    rev_s = (payload & 2) == 2
    qpos_s = (payload >> 2).astype(jnp.int32)
    rowid_s = jnp.where(valid_s, (k1 >> 14).astype(jnp.int32), I32_SENTINEL)
    rcid_s = (k1 & 0x3FFF).astype(jnp.int32)
    rpos_s = k2
    # fragment -> query contig lookup per query genome (post-DP tables)
    frag_ids = jnp.arange(NF, dtype=jnp.int32)
    frag_cid_tab = jnp.clip(
        (jax.vmap(lambda fo: jnp.searchsorted(fo, frag_ids, side="right"))(
            q_frag_offs) - 1).astype(jnp.int32), 0, C - 1)  # [G_q, NF]

    rbits = rcid_bits_for(refs.contig_lengths.shape[1])
    okv = valid_s & (rowid_s < P * NF)
    # anchors beyond a row's first PF never enter the grid (the gather
    # below reads only each row's leading slice), so the packed valid
    # bit needs no rank test
    w1, w2 = _pack_grid_words(qpos_s, rpos_s, rcid_s, rev_s, okv, rbits)
    # positions past the packed w1/w2 ranges corrupt results: ref
    # contigs >= 2^(32-rbits) bp, query contigs >= 2^30 bp (qpos rides
    # w1 as qpos<<2).  Query TOTALS >= 2^30 bp are also flagged: the
    # block post-DP (_denom_prefix/_post_dp_block) works in
    # genome-global int32 coordinates with a 2^30 padding sentinel, so
    # larger totals would silently corrupt span denominators even when
    # every contig fits the packed word.  All are reported loudly
    # (check_overflow raises) — Database.query pre-checks and reroutes
    # such genomes through the full-range per-pair path instead.
    pos_overflow = jnp.any(valid_s & (rpos_s >= (1 << (32 - rbits)))) | \
        jnp.any(queries.contig_lengths.astype(jnp.uint32) >=
                jnp.uint32(1 << 30)) | \
        jnp.any(queries.total_len.astype(jnp.uint32) >= jnp.uint32(1 << 30))
    # TWO uint32 grid planes (qpos/rev/valid in w1, rpos/rcid in w2),
    # built by per-row sliced gather from the sorted stream
    w1g, w2g, row_bounds = _grid_from_sorted_stream(
        rowid_s, w1, w2, P, NF, PF)

    scores, roots = _dp_dispatch(_dp_grid_from_words(w1g, w2g, rbits), cfg,
                                 budgets)
    pair_ids = jnp.arange(P, dtype=jnp.int32)
    _, r_frag_offs = jax.vmap(lambda r: _contig_layout(r, fl))(refs)
    out = _post_dp_block(refs, queries, w1g, w2g, scores, roots, q_starts,
                         q_frag_offs, cfg, budgets,
                         pair_ids // G_q, pair_ids % G_q,
                         r_frag_offs=r_frag_offs,
                         frag_cid_g=frag_cid_tab, rcid_bits=rbits)
    out["pos_overflow"] = jnp.broadcast_to(pos_overflow, (P,))
    # per-pair anchor counts: row-bound differences at pair boundaries
    # (rowid_s ascends; invalid anchors sentinel-last).  The shared-pool
    # overflow flag is broadcast to every pair of the block (the pool is
    # shared, so any pair may be the one truncated).
    bounds = row_bounds[jnp.arange(P + 1, dtype=jnp.int32) * NF]
    n_anchors = (bounds[1:] - bounds[:-1]).astype(jnp.int32)
    out["n_anchors"] = n_anchors
    out["anchors_overflow"] = jnp.broadcast_to(a["anchors_overflow"], (P,))
    return jax.tree.map(lambda x: x.reshape((G_r, G_q) + x.shape[1:]), out)


def triu_pairs(G: int):
    """(ref_idx, query_idx) int32 arrays over the strict upper triangle,
    in the same order chain_triangle emits its [P] outputs (ref < query,
    row-major)."""
    ri, qi = np.triu_indices(G, k=1)
    return ri.astype("int32"), qi.astype("int32")


def _triangle_self_join(gs: DeviceSketch, cfg: ChainConfig,
                        total_anchors: int, q_frag_offs: jax.Array, NF: int):
    """Anchors for EVERY unordered pair (i < j) of one genome stack from a
    single self-join sort — each seed table enters one sort ONCE (the
    blocked path re-sorts each genome's table in every tile it touches).

    The stream holds one copy of every seed occurrence; within a k-mer
    run, occurrences sort by genome id, so an occurrence acting as the
    QUERY (genome j) expands against exactly the run prefix that belongs
    to genomes i < j — the refs of all its upper-triangle pairs at once.
    The i=j self-matches are excluded by the same prefix arithmetic, and
    the per-pair multiplicity cap is enforced by the own-multiplicity
    premask exactly as in _block_join (a k-mer's run length within one
    genome IS its multiplicity there).

    Each occurrence carries one payload word per role-independent fact:
      pos   — in-contig k-mer end position (query AND ref role)
      gcs   — g<<15 | cid<<1 | strand  (sort key 2: genome-major runs)
      fragw — g*NF + fragment, or -1 if the fragment overflows NF
    so the stream sort moves 4 operands and the expansion gathers two
    3-word payload rows per anchor (one per role).
    """
    G, S = gs.kmers.shape
    C = gs.contig_lengths.shape[1]
    fl = cfg.fragment_length
    cap = cfg.max_seed_multiplicity
    SENT = jnp.uint32(0xFFFFFFFF)
    kmer = jnp.where(gs.own_mult <= cap, gs.kmers, SENT).reshape(-1)
    n = G * S
    assert G < (1 << 15)

    g_id = jnp.arange(n, dtype=jnp.int32) // S
    cid = jnp.clip(gs.contig_ids.reshape(-1), 0, C - 1)
    pos = gs.positions.reshape(-1)
    gcs = (g_id << 15) | (cid.astype(jnp.int32) << 1) | \
        gs.strands.reshape(-1).astype(jnp.int32)
    flat = g_id * (C + 1) + cid
    frag = q_frag_offs.reshape(-1)[flat] + pos // fl
    fragw = jnp.where(frag < NF, g_id * NF + frag, -1)

    kmer_s, gcs_s, pos_s, fragw_s = jax.lax.sort(
        (kmer, gcs, pos, fragw), num_keys=2)

    i = jnp.arange(n, dtype=jnp.int32)
    first = jnp.concatenate([jnp.ones(1, bool), kmer_s[1:] != kmer_s[:-1]])
    run_start = jax.lax.cummax(jnp.where(first, i, 0))
    # first index of MY genome's group within the run: genome boundaries
    # inside a run start a new group
    gchg = jnp.concatenate([jnp.ones(1, bool),
                            first[1:] | ((gcs_s[1:] >> 15) !=
                                         (gcs_s[:-1] >> 15))])
    gfirst = jax.lax.cummax(jnp.where(gchg, i, 0))
    rc = gfirst - run_start          # entries of strictly-smaller genomes
    is_sent = kmer_s == SENT
    ok = (~is_sent) & (rc > 0) & (fragw_s >= 0)
    counts = jnp.where(ok, rc, 0)
    offs = jnp.cumsum(counts) - counts
    want = offs[-1] + counts[-1]
    total = jnp.minimum(want, total_anchors)

    A = total_anchors
    t = jnp.arange(A, dtype=jnp.int32)
    slot0 = jnp.where(ok, offs, A)
    if cap * G <= 255 and n < (1 << 23):
        # packed single-scatter inversion (see _block_join): run length
        # <= cap * G, so the run offset rides 8 low bits
        pm = jnp.zeros(A + 1, jnp.int32).at[slot0].max(
            jnp.where(ok, (i << 8) | (i - run_start), 0))
        fill = jax.lax.cummax(pm[:A])
        src = fill >> 8
        rs_fill = src - (fill & 255)
    else:
        src_map = jnp.zeros(A + 1, jnp.int32).at[slot0].max(i)
        src = jax.lax.cummax(src_map[:A])
        rs_map = jnp.zeros(A + 1, jnp.int32).at[slot0].max(
            jnp.where(ok, run_start, 0))
        rs_fill = jax.lax.cummax(rs_map[:A])
    src_first = jnp.concatenate([jnp.ones(1, bool), src[1:] != src[:-1]])
    j = t - jax.lax.cummax(jnp.where(src_first, t, 0))
    a_valid = t < total
    r_idx = jnp.minimum(rs_fill + j, n - 1)

    p3 = jnp.stack([pos_s, gcs_s, fragw_s], axis=1)      # [n, 3]
    qp = p3[src]
    rp = p3[r_idx]
    qpos, qgcs, qfragw = qp[:, 0], qp[:, 1], qp[:, 2]
    rpos, rgcs = rp[:, 0], rp[:, 1]

    g_r = rgcs >> 15
    g_q = qgcs >> 15
    rcid = (rgcs >> 1) & 0x3FFF
    qcid = (qgcs >> 1) & 0x3FFF
    rev = (qgcs & 1) != (rgcs & 1)
    a_valid = a_valid & (qfragw >= 0)
    frag_a = jnp.maximum(qfragw, 0) - jnp.maximum(g_q, 0) * NF
    # strict-upper-triangle pair index (ref = smaller genome id)
    tri = g_r * G - (g_r * (g_r + 1)) // 2 + (g_q - g_r - 1)
    P = (G * (G - 1)) // 2
    tri = jnp.clip(tri, 0, P - 1)
    rowid = tri * NF + jnp.clip(frag_a, 0, NF - 1)
    return dict(
        qpos=jnp.where(a_valid, qpos, I32_SENTINEL),
        qcid=jnp.where(a_valid, qcid, I32_SENTINEL),
        rowid=rowid,
        rpos=jnp.where(a_valid, rpos, I32_SENTINEL),
        rcid=jnp.where(a_valid, rcid, I32_SENTINEL),
        rev=rev,
        valid=a_valid,
        pair=jnp.where(a_valid, tri, (1 << 30)),
        n_anchors=total,
        anchors_overflow=want > total_anchors,
    )


@functools.partial(jax.jit,
                   static_argnames=("cfg", "budgets", "total_anchors"))
def chain_triangle(genomes: DeviceSketch, *, cfg: ChainConfig,
                   budgets: EngineBudgets,
                   total_anchors: int | None = None):
    """All unordered pairs of a genome stack: ONE join sort, ONE DP.

    Device `skani triangle` core (reference mode listed at
    /root/reference/src/pyskani/_skani/lib.rs Mode::Search analogue; the
    reference has no batched mode at all).  Versus tiling the triangle
    with chain_block, the self-join sorts each seed table once instead of
    once per tile, and no lower-triangle/diagonal grid rows are wasted:
    pair p corresponds to (triu_pairs(G)[0][p], triu_pairs(G)[1][p]).

    Returns a dict of [G*(G-1)/2] arrays, numerically identical to
    chain_pair on each pair (pinned by tests/test_block_join.py).
    """
    _check_supported(cfg)
    fl = cfg.fragment_length
    NF = budgets.max_fragments
    PF = budgets.max_anchors_per_fragment
    G = genomes.kmers.shape[0]
    P = (G * (G - 1)) // 2
    if P * NF > (1 << 17):
        raise ValueError(f"triangle too large: pairs*max_fragments = "
                         f"{P * NF} exceeds 2^17 (split the genome set)")
    if total_anchors is None:
        total_anchors = P * budgets.max_anchors
    C = genomes.contig_lengths.shape[1]

    q_starts, q_frag_offs = jax.vmap(
        lambda q: _contig_layout(q, fl))(genomes)        # [G, C+1]
    a = _triangle_self_join(genomes, cfg, total_anchors, q_frag_offs, NF)
    valid = a["valid"]
    rowid = a["rowid"]

    # sort by (rowid, rcid, rpos); qpos+rev+valid ride in ONE payload
    # word (the query contig id is a function of the row, so it no
    # longer rides the sort at all).  (rowid, rcid, rpos, qpos) is
    # unique per anchor, so the 3-key order is total and deterministic.
    # Key 1 sorts as uint32 with an all-ones sentinel: valid keys reach
    # 2^31-1 (rowid < 2^17), which exceeds any positive int32 sentinel
    # once rowid >= 2^16.
    k1 = jnp.where(valid, ((rowid << 14) | a["rcid"]).astype(jnp.uint32),
                   jnp.uint32(0xFFFFFFFF))
    k2 = jnp.where(valid, a["rpos"], POS_BIG)
    pay1 = jnp.where(
        valid,
        (a["qpos"].astype(jnp.uint32) << 2)
        | (a["rev"].astype(jnp.uint32) << 1) | jnp.uint32(1),
        jnp.uint32(0xFFFFFFFC))
    k1, k2, pay1 = jax.lax.sort((k1, k2, pay1), num_keys=3)

    valid_s = (pay1 & 1) == 1
    rev_s = (pay1 & 2) == 2
    qpos_s = (pay1 >> 2).astype(jnp.int32)
    rowid_s = jnp.where(valid_s, (k1 >> 14).astype(jnp.int32), I32_SENTINEL)
    rcid_s = (k1 & 0x3FFF).astype(jnp.int32)
    rpos_s = k2

    rbits = rcid_bits_for(genomes.contig_lengths.shape[1])
    okv = valid_s & (rowid_s < P * NF)
    w1, w2 = _pack_grid_words(qpos_s, rpos_s, rcid_s, rev_s, okv, rbits)
    # see chain_block: w2 caps ref positions at 2^(32-rbits); w1 caps
    # contig-local query positions at 2^30; genome TOTALS >= 2^30 are
    # flagged too (the block post-DP uses genome-global coordinates)
    pos_overflow = jnp.any(valid_s & (rpos_s >= (1 << (32 - rbits)))) | \
        jnp.any(genomes.contig_lengths.astype(jnp.uint32) >=
                jnp.uint32(1 << 30)) | \
        jnp.any(genomes.total_len.astype(jnp.uint32) >= jnp.uint32(1 << 30))
    # per-row sliced gather from the sorted stream (see chain_block)
    w1g, w2g, row_bounds = _grid_from_sorted_stream(
        rowid_s, w1, w2, P, NF, PF)

    scores, roots = _dp_dispatch(_dp_grid_from_words(w1g, w2g, rbits), cfg,
                                 budgets)
    tri_r, tri_q = triu_pairs(G)
    out = _post_dp_block(genomes, genomes, w1g, w2g, scores, roots,
                         q_starts, q_frag_offs, cfg, budgets,
                         jnp.asarray(tri_r), jnp.asarray(tri_q),
                         r_frag_offs=q_frag_offs, rcid_bits=rbits)
    out["pos_overflow"] = jnp.broadcast_to(pos_overflow, (P,))
    # per-pair anchor counts: row-bound differences at pair boundaries
    bounds = row_bounds[jnp.arange(P + 1, dtype=jnp.int32) * NF]
    out["n_anchors"] = (bounds[1:] - bounds[:-1]).astype(jnp.int32)
    out["anchors_overflow"] = jnp.broadcast_to(a["anchors_overflow"], (P,))
    return out


@functools.partial(jax.jit, static_argnames=("cfg", "budgets"))
def chain_pair(ref: DeviceSketch, query: DeviceSketch, *,
               cfg: ChainConfig, budgets: EngineBudgets):
    """Full pair pipeline on device: anchors -> chains -> ANI/AF.

    Returns a dict of scalars: ani_mean, ani_robust, ani_median, af_query,
    af_ref, n_anchors, n_fragments (all device arrays).
    """
    rb = jax.tree.map(lambda x: x[None], ref)
    qb = jax.tree.map(lambda x: x[None], query)
    out = chain_pairs(rb, qb, cfg=cfg, budgets=budgets)
    return jax.tree.map(lambda x: x[0], out)


def cfg_k(query: DeviceSketch, cfg: ChainConfig) -> float:
    # k is carried statically by the engine config (ChainConfig.k;
    # Database threads SketchParams.k through, default 15)
    return float(cfg.k)
