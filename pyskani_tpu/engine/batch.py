"""Batched pair engine: many-to-many ANI over stacked sketch tensors.

The reference computes one pair at a time in a serial loop
(/root/reference/src/pyskani/_skani/lib.rs:639-657).  On the device the
unit of work is a *batch of pairs*: sketches are stacked (leading axis)
into one pytree, and the pair pipeline is vmapped so every pair's
fragments advance in lockstep.  Memory is bounded by mapping over
ref-chunks with an inner vmap (lax.map), so arbitrarily large triangles
stream through a fixed working set.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..oracle.chain import ChainConfig
from ..ops.chain import (EngineBudgets, chain_block, chain_pair, chain_pairs,
                         chain_triangle)
from ..ops.sketch import (DeviceSketch, HostSketch, contig_budget_for,
                          round_up)


def _repad_host(dev, name: str, seed_budget: int, marker_budget: int,
                max_contigs: int | None = None) -> DeviceSketch:
    """Pad a host-fetched sketch pytree to common budgets (pure numpy).

    ``dev`` must already live on the host (``jax.device_get`` of a
    ``DeviceSketch`` or a disk-loaded one) — no per-field transfers.
    ``max_contigs=None`` keeps the sketch's own contig-table size.
    """
    n = int(dev.n_seeds)
    m = int(dev.n_markers)
    nc = int(dev.n_contigs)
    if max_contigs is None:
        max_contigs = dev.contig_lengths.shape[0]
    if n > seed_budget or m > marker_budget:
        raise ValueError(f"sketch {name} exceeds budgets "
                         f"({n}>{seed_budget} or {m}>{marker_budget})")
    if nc > max_contigs:
        raise ValueError(f"sketch {name} has {nc} contigs, more than the "
                         f"max_contigs={max_contigs} budget")

    def pad(arr, size, fill):
        a = np.asarray(arr)
        out = np.full(size, fill, dtype=a.dtype)
        k = min(len(a), size)
        out[:k] = a[:k]
        return out

    return DeviceSketch(
        kmers=pad(dev.kmers[:n], seed_budget, 0xFFFFFFFF),
        positions=pad(dev.positions[:n], seed_budget, 0x7FFFFFFF),
        contig_ids=pad(dev.contig_ids[:n], seed_budget, 0x7FFFFFFF),
        strands=pad(dev.strands[:n], seed_budget, False),
        own_mult=pad(dev.own_mult[:n], seed_budget, 0),
        p_positions=pad(dev.p_positions[:n], seed_budget, 0x7FFFFFFF),
        p_contig_ids=pad(dev.p_contig_ids[:n], seed_budget, 0x7FFFFFFF),
        p_own_mult=pad(dev.p_own_mult[:n], seed_budget, 0),
        markers_hi=pad(dev.markers_hi[:m], marker_budget, 0xFFFFFFFF),
        markers_lo=pad(dev.markers_lo[:m], marker_budget, 0xFFFFFFFF),
        n_seeds=np.asarray(dev.n_seeds), n_markers=np.asarray(dev.n_markers),
        contig_lengths=pad(dev.contig_lengths, max_contigs, 0),
        n_contigs=np.asarray(dev.n_contigs),
        total_len=np.asarray(dev.total_len),
    )


def repad_sketch(host: HostSketch, seed_budget: int, marker_budget: int,
                 max_contigs: int | None = None) -> DeviceSketch:
    """Re-pad a sketch's arrays to common budgets.

    Fetches the sketch to the host in ONE batched transfer, pads in
    numpy, and re-uploads with ONE ``device_put`` instead of one round
    trip per field.
    """
    fetched = jax.device_get(host.device)
    return jax.device_put(
        _repad_host(fetched, host.name, seed_budget, marker_budget,
                    max_contigs))


def stack_sketches_host(sketches: Sequence[HostSketch],
                        seed_budget: int | None = None,
                        marker_budget: int | None = None,
                        contig_budget: int | None = None) -> DeviceSketch:
    """Stack sketches into one batched numpy pytree (leading axis N).

    All device arrays are fetched with a single ``jax.device_get`` of the
    whole list — N sketches cost one round trip, not 13*N.  The result
    stays on the host; callers ship it with one ``device_put`` (see
    :func:`stack_sketches`) or shard it over a mesh.
    """
    fetched = jax.device_get([s.device for s in sketches])
    if seed_budget is None:
        seed_budget = round_up(max(int(d.n_seeds) for d in fetched), 1024)
    if marker_budget is None:
        marker_budget = round_up(
            max(int(d.n_markers) for d in fetched), 512)
    # common contig-table bucket: sized from the largest member (sketches
    # arrive with per-genome power-of-two buckets, see contig_budget_for)
    cb = contig_budget if contig_budget is not None else \
        max(contig_budget_for(int(d.n_contigs)) for d in fetched)
    padded = [_repad_host(d, s.name, seed_budget, marker_budget, cb)
              for d, s in zip(fetched, sketches)]
    return jax.tree.map(lambda *xs: np.stack(xs), *padded)


def stack_sketches(sketches: Sequence[HostSketch],
                   seed_budget: int | None = None,
                   marker_budget: int | None = None,
                   contig_budget: int | None = None) -> DeviceSketch:
    """Stack sketches into one batched DeviceSketch (leading axis N)."""
    return jax.device_put(
        stack_sketches_host(sketches, seed_budget, marker_budget,
                            contig_budget))


def take_sketch(batch: DeviceSketch, idx) -> DeviceSketch:
    """Select sketch(es) ``idx`` from a stacked batch (jit-safe gather)."""
    return jax.tree.map(lambda x: jnp.take(x, idx, axis=0), batch)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "budgets", "chunk"))
def pairs_ani(batch: DeviceSketch, ref_idx: jax.Array, query_idx: jax.Array,
              *, cfg: ChainConfig, budgets: EngineBudgets, chunk: int = 8):
    """ANI/AF for an arbitrary list of (ref, query) index pairs.

    Streams through the pair list in chunks of ``chunk`` batched pipelines
    to bound peak memory (the chain DP runs once per chunk with all the
    chunk's fragments in lanes).  Returns dict of [P] arrays.
    """
    def one_chunk(pair_chunk):  # [chunk, 2]
        r = take_sketch(batch, pair_chunk[:, 0])
        q = take_sketch(batch, pair_chunk[:, 1])
        return chain_pairs(r, q, cfg=cfg, budgets=budgets)

    pairs = jnp.stack([ref_idx, query_idx], axis=1)
    P = pairs.shape[0]
    pad = (-P) % chunk
    pairs = jnp.concatenate(
        [pairs, jnp.zeros((pad, 2), pairs.dtype)]) if pad else pairs
    chunked = pairs.reshape(-1, chunk, 2)
    out = jax.lax.map(one_chunk, chunked)
    return jax.tree.map(lambda x: x.reshape(-1)[:P], out)


@functools.partial(jax.jit, static_argnames=("cfg", "budgets", "chunk"))
def one_vs_many(refs: DeviceSketch, query: DeviceSketch, ref_idx: jax.Array,
                *, cfg: ChainConfig, budgets: EngineBudgets, chunk: int = 8):
    """One query against selected references of a stacked DB tensor.

    ``refs`` is the stacked (possibly db-sharded) reference store; the
    query sketch stays separate so the store is transferred/stacked once
    per database, not per query.  Chunks of ``chunk`` references run as
    one block join (one sort + one DP per chunk).  Returns dict of
    [len(ref_idx)] arrays.
    """
    q1 = jax.tree.map(lambda x: x[None], query)

    def one_chunk(idx_chunk):
        r = take_sketch(refs, idx_chunk)
        out = chain_block(r, q1, cfg=cfg, budgets=budgets)
        return jax.tree.map(lambda x: x[:, 0], out)

    P = ref_idx.shape[0]
    pad = (-P) % chunk
    idx = jnp.concatenate([ref_idx, jnp.zeros(pad, ref_idx.dtype)]) \
        if pad else ref_idx
    out = jax.lax.map(one_chunk, idx.reshape(-1, chunk))
    return jax.tree.map(lambda x: x.reshape(-1)[:P], out)


@functools.partial(jax.jit, static_argnames=("cfg", "budgets", "chunk"))
def one_vs_many_pairs(refs: DeviceSketch, query: DeviceSketch,
                      ref_idx: jax.Array, *, cfg: ChainConfig,
                      budgets: EngineBudgets, chunk: int = 4):
    """Full-range variant of :func:`one_vs_many` built on ``chain_pairs``.

    The per-pair pipeline keeps every coordinate in per-contig int32
    planes (no packing), so it has none of the packed block-grid caps:
    contigs up to 2^31 bp on either side and genomes of ANY total length
    (reference contract: GnPosition is full-width and totals are usize,
    lib.rs:160).  ``Database.query`` routes references whose contigs
    exceed the packed range — and queries >= 2^30 bp total — here
    instead of erroring.  Returns dict of [len(ref_idx)] arrays.
    """
    def one_chunk(idx_chunk):
        r = take_sketch(refs, idx_chunk)
        q = jax.tree.map(
            lambda x: jnp.broadcast_to(x[None], (chunk,) + x.shape), query)
        return chain_pairs(r, q, cfg=cfg, budgets=budgets)

    P = ref_idx.shape[0]
    pad = (-P) % chunk
    idx = jnp.concatenate([ref_idx, jnp.zeros(pad, ref_idx.dtype)]) \
        if pad else ref_idx
    out = jax.lax.map(one_chunk, idx.reshape(-1, chunk))
    return jax.tree.map(lambda x: x.reshape(-1)[:P], out)


def default_budgets(sketches: List[HostSketch], batch: DeviceSketch,
                    cfg: ChainConfig) -> EngineBudgets:
    fl = cfg.fragment_length
    nf = round_up(max(s.n_fragments(fl) for s in sketches) + 2, 128)
    return EngineBudgets(
        max_anchors=round_up(batch.kmers.shape[1] * 3 // 2 + 4096, 8192),
        max_fragments=nf,
        max_anchors_per_fragment=256)


def max_triangle_group(budgets: EngineBudgets, cap: int = 32) -> int:
    """Largest genome-group size whose triangle fits the pair-grid limit
    (pairs * max_fragments <= 2^17, see chain_triangle)."""
    g = cap
    while g > 2 and (g * (g - 1) // 2) * budgets.max_fragments > (1 << 17):
        g -= 1
    return g


def triangle(sketches: List[HostSketch], cfg: ChainConfig | None = None,
             budgets: EngineBudgets | None = None, block: int | None = None,
             anchors_per_pair: int | None = None, group: int = 32):
    """All-vs-all ANI over a genome set (reference `skani triangle` mode).

    Genomes are split into groups of up to ``group``: each group's
    internal triangle runs as ONE chain_triangle call (single self-join
    sort, no wasted grid rows), and each cross-group rectangle as
    chain_block tiles of ``block`` x ``block`` (default: the group size,
    shrunk to the pair-grid limit).  All tiles are dispatched before any
    result is fetched, so host dispatch overlaps device compute.

    ``anchors_per_pair`` sizes each call's shared anchor pool (default:
    the per-pair budget — exact chain_pairs parity at higher memory).

    Returns (ref_idx, query_idx, results-dict of numpy arrays) over the
    N(N-1)/2 unordered pairs.
    """
    cfg = cfg or ChainConfig()
    n = len(sketches)
    batch = stack_sketches(sketches)
    if budgets is None:
        budgets = default_budgets(sketches, batch, cfg)
    group = max_triangle_group(budgets, min(group, n))
    app = anchors_per_pair or budgets.max_anchors
    if block is None:
        # largest square cross tile within the same pair-grid limit
        block = group
        while block > 1 and block * block * budgets.max_fragments > (1 << 17):
            block //= 2

    # genomes whose contigs exceed the packed block-grid position range
    # route through the full-range per-pair pipeline (reference
    # contract: GnPosition is full-width, lib.rs:160) — same reroute
    # Database.query applies
    from ..ops.chain import rcid_bits_for
    cap = 1 << (32 - rcid_bits_for(batch.contig_lengths.shape[1]))
    giant = {i for i, s in enumerate(sketches)
             if max(s.lengths, default=0) >= cap
             or s.total_len >= (1 << 30)}
    pk = np.array([i for i in range(n) if i not in giant], np.int32)

    starts = list(range(0, len(pk), group))
    pending = []  # (ridx, qidx, device-result dict of [.,.] or [P] arrays)
    for a in starts:
        gidx = pk[a:a + group]
        if len(gidx) < 2:
            # a single-genome group has no internal pairs (and zero-pair
            # grids would crash the kernel); cross-group rectangles below
            # still cover all its inter-group pairs
            continue
        out = chain_triangle(
            take_sketch(batch, jnp.asarray(gidx)), cfg=cfg, budgets=budgets,
            total_anchors=round_up(
                len(gidx) * (len(gidx) - 1) // 2 * app, 8192))
        tri_r, tri_q = np.triu_indices(len(gidx), k=1)
        pending.append((gidx[tri_r], gidx[tri_q], out))
    fb_pairs = [(i, j) for i in range(n) for j in range(i + 1, n)
                if i in giant or j in giant]
    if fb_pairs:
        # pairs touching a giant genome: full-range per-pair pipeline,
        # canonical orientation (ref = smaller index)
        ri_f = np.array([p[0] for p in fb_pairs], np.int32)
        qi_f = np.array([p[1] for p in fb_pairs], np.int32)
        out = pairs_ani(batch, jnp.asarray(ri_f), jnp.asarray(qi_f),
                        cfg=cfg, budgets=budgets, chunk=4)
        pending.append((ri_f, qi_f, out))
    for a in starts:                        # cross-group rectangles
        ridx_g = pk[a:a + group]
        for b in starts:
            if b <= a:
                continue
            qidx_g = pk[b:b + group]
            for bi in range(0, len(ridx_g), block):
                for bj in range(0, len(qidx_g), block):
                    ridx = ridx_g[bi:bi + block]
                    qidx = qidx_g[bj:bj + block]
                    rpad = np.concatenate(
                        [ridx, np.full(block - len(ridx), ridx[0])])
                    qpad = np.concatenate(
                        [qidx, np.full(block - len(qidx), qidx[0])])
                    out = chain_block(
                        take_sketch(batch, jnp.asarray(rpad)),
                        take_sketch(batch, jnp.asarray(qpad)),
                        cfg=cfg, budgets=budgets,
                        total_anchors=round_up(block * block * app, 8192))
                    rr, qq = np.meshgrid(ridx, qidx, indexing="ij")
                    out = {k: v[:len(ridx), :len(qidx)].reshape(-1)
                           for k, v in out.items()}
                    pending.append((rr.reshape(-1), qq.reshape(-1), out))

    mats = {}
    for ridx, qidx, out in pending:         # fetch (device already running)
        for key, val in out.items():
            arr = np.asarray(val)
            if key not in mats:
                mats[key] = np.zeros((n, n), arr.dtype)
            mats[key][ridx, qidx] = arr
    ri, qi = np.triu_indices(n, k=1)
    out = {k: v[ri, qi] for k, v in mats.items()}
    check_overflow(out, budgets)
    return ri, qi, out


def check_overflow(out: dict, budgets: EngineBudgets,
                   raise_on_overflow: bool = False) -> None:
    """Surface silent budget saturation to the caller.

    ``anchors_overflow`` means a shared anchor pool clipped its join (the
    tail anchors were dropped — ANI may be underestimated for the pairs
    owning them); ``n_chains > max_chains_per_pair`` means a pair's kept
    chains overflowed the compaction table (AF may be underestimated).
    Either condition warns (or raises) instead of passing quietly wrong
    results.
    """
    import warnings

    # collect EVERY diagnostic before acting so that a raising condition
    # does not hide the budget problems a caller would want to retune
    problems = []
    pos_over = "pos_overflow" in out and bool(np.any(np.asarray(
        out["pos_overflow"])))
    if pos_over:
        # not a budget issue: the packed block/triangle grid caps ref
        # coordinates at 2^(32-rcid_bits) bp per contig and query genomes
        # at 2^30 bp total — results for such pairs are WRONG, so this
        # condition always raises (the full-range per-pair chain_pairs
        # path handles such genomes; Database.query reroutes them
        # automatically)
        problems.append(
            "contig coordinate overflow: a position exceeds the packed "
            "block-grid range (ref contigs >= 2^(32-rcid_bits) bp or a "
            "query genome >= 2^30 bp) — use the per-pair path for such "
            "genomes")
    frag_over = "frag_overflow" in out and bool(np.any(np.asarray(
        out["frag_overflow"])))
    if frag_over:
        # anchors past the fragment-grid budget were DROPPED — results
        # for the owning pairs are truncated, so this raises like
        # pos_overflow (size max_fragments to the largest genome's
        # fragment count)
        problems.append(
            "fragment budget overflow: a genome has anchors beyond "
            "max_fragments * fragment_length — raise max_fragments to "
            "cover the largest genome")
    if "anchors_overflow" in out and bool(np.any(np.asarray(
            out["anchors_overflow"]))):
        problems.append("anchor budget overflow: the shared anchor pool "
                        "clipped the join (raise total_anchors / "
                        "max_anchors)")
    if "n_chains" in out:
        mx = int(np.max(np.asarray(out["n_chains"]), initial=0))
        if mx > budgets.max_chains_per_pair:
            problems.append(
                f"chain table overflow: a pair kept {mx} chains > "
                f"max_chains_per_pair={budgets.max_chains_per_pair}")
    if problems and (pos_over or frag_over or raise_on_overflow):
        raise RuntimeError("; ".join(problems))
    for msg in problems:
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
