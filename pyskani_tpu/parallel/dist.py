"""Multi-device / multi-host distribution of the ANI engine.

The reference is strictly single-process (SURVEY.md §2.3: no distributed
code of any kind).  This layer spreads the engine over several GPUs:

* a 2-D device mesh ``("db", "batch")`` — the reference-database sketch
  store is sharded over ``db`` (the tensor-parallel analog: each device
  owns a slice of the database) and query genomes are sharded over
  ``batch`` (data parallelism).  The cards of one host are joined all to
  all, so the mesh follows the algorithm, not a physical topology;
* ``shard_map`` steps compute local [R_shard, Q_shard] result blocks;
  collective reductions (``psum`` over the mesh, lowered to NCCL) produce
  global hit statistics, and shortlist bitmaps travel by ``all_gather``
  when a globally consistent shortlist is needed;
* several hosts join through ``jax.distributed.initialize`` (see
  :func:`initialize_multihost`) and place each host's database shard with
  ``device_put``; the on-disk consolidated store is the restart
  checkpoint (deterministic resharding on reload).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map as _shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..oracle.chain import ChainConfig
from ..ops.chain import EngineBudgets, chain_block, chain_pair, chain_pairs
from ..ops.screen import screen_pass
from ..ops.sketch import DeviceSketch
from .mesh import make_mesh  # re-export


def shard_map(f, **kw):
    """``jax.shard_map`` without the replication check (the steps below
    reduce with explicit collectives)."""
    return _shard_map(f, check_vma=False, **kw)


def shard_leading(mesh: Mesh, tree, axis: str):
    """Place a stacked pytree with its leading axis sharded over ``axis``."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def replicate(mesh: Mesh, tree):
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def _take(batch: DeviceSketch, idx) -> DeviceSketch:
    return jax.tree.map(lambda x: jax.lax.dynamic_index_in_dim(
        x, idx, axis=0, keepdims=False), batch)


def make_sharded_search(mesh: Mesh, cfg: ChainConfig, budgets: EngineBudgets,
                        screen_val: float = 0.8, marker_k: int = 21,
                        rescue_small: bool = True, chunk: int = 4):
    """Build the jitted multi-chip many-to-many search step.

    Arguments at call time:
      refs    — stacked DeviceSketch [R, ...], leading axis sharded "db"
      queries — stacked DeviceSketch [Q, ...], leading axis sharded "batch"

    Returns a dict of [R, Q] result arrays (sharded over both axes) plus
    mesh-global scalars reduced with psum over ICI.
    """

    def local_block(refs: DeviceSketch, queries: DeviceSketch):
        Rl = refs.kmers.shape[0]
        Ql = queries.kmers.shape[0]
        NP = Rl * Ql

        # --- phase 1: marker screen, all local pairs at once (the
        # semantics live in ops.screen.screen_pass — one implementation
        # shared with Database.query's screen_batch) ---
        def screen_one(qi, ri):
            q = _take(queries, qi)
            r = _take(refs, ri)
            ok, _ = screen_pass(
                q.markers_hi, q.markers_lo, q.n_markers,
                r.markers_hi, r.markers_lo, r.n_markers, screen_val,
                marker_k=marker_k, rescue_small=rescue_small)
            return ok
        rr, qq = jnp.meshgrid(jnp.arange(Rl), jnp.arange(Ql), indexing="ij")
        passes = jax.vmap(screen_one)(qq.reshape(-1), rr.reshape(-1))
        passes = passes.reshape(Rl, Ql)

        # --- phase 2: chain ONLY the shortlisted pairs ---
        # The screen now pays for itself (reference semantics AND its
        # compute saving, lib.rs:616-657): passing pair ids are
        # compacted with top_k, and a lax.while_loop walks
        # ceil(n_pass/chunk) fixed-shape chunks through the batched pair
        # pipeline — compiled once, compute proportional to the actual
        # pass count instead of Rl*Ql.
        def _gather(batch, idx):
            return jax.tree.map(lambda x: jnp.take(x, idx, axis=0), batch)

        flat = passes.reshape(-1)
        i = jnp.arange(NP, dtype=jnp.int32)
        floor = jnp.int32(-(2**31 - 2))
        topv, _ = jax.lax.top_k(jnp.where(flat, -i, floor), NP)
        pid = jnp.where(topv > floor, -topv, -1)       # ascending pair ids
        n_pass = jnp.sum(flat, dtype=jnp.int32)
        pad = (-NP) % chunk
        pid = jnp.concatenate([pid, jnp.full(pad, -1, jnp.int32)]) \
            if pad else pid
        n_iter = -(-n_pass // chunk)

        # dense result planes, dtypes taken from the pair pipeline
        shapes = jax.eval_shape(
            lambda r, q: chain_pairs(r, q, cfg=cfg, budgets=budgets),
            jax.eval_shape(lambda t: _gather(t, jnp.zeros(chunk, jnp.int32)),
                           refs),
            jax.eval_shape(lambda t: _gather(t, jnp.zeros(chunk, jnp.int32)),
                           queries))
        planes0 = {k: jnp.zeros(NP + 1, v.dtype) for k, v in shapes.items()}

        def body(carry):
            it, planes = carry
            pc = jax.lax.dynamic_slice(pid, (it * chunk,), (chunk,))
            ok = pc >= 0
            pc_safe = jnp.maximum(pc, 0)
            out = chain_pairs(_gather(refs, pc_safe // Ql),
                              _gather(queries, pc_safe % Ql),
                              cfg=cfg, budgets=budgets)
            slot = jnp.where(ok, pc_safe, NP)           # NP = dump slot
            planes = {k: planes[k].at[slot].set(out[k])
                      for k in planes}
            return it + 1, planes

        _, planes = jax.lax.while_loop(
            lambda c: c[0] < n_iter, body, (jnp.int32(0), planes0))
        out = {k: v[:NP].reshape(Rl, Ql) for k, v in planes.items()}
        out["screen_pass"] = passes

        # --- collectives: global statistics ride ICI ---
        local_hits = jnp.sum((out["ani_mean"] > 0.1) & passes,
                             dtype=jnp.int32)
        out["total_hits"] = jax.lax.psum(
            jax.lax.psum(local_hits, "db"), "batch")[None]
        out["n_chained"] = jax.lax.psum(
            jax.lax.psum(n_pass, "db"), "batch")[None]
        return out

    out_specs = {
        "ani_mean": P("db", "batch"), "ani_robust": P("db", "batch"),
        "ani_median": P("db", "batch"), "af_query": P("db", "batch"),
        "af_ref": P("db", "batch"), "n_anchors": P("db", "batch"),
        "anchors_overflow": P("db", "batch"),
        "frag_overflow": P("db", "batch"),
        "n_fragments": P("db", "batch"),
        "screen_pass": P("db", "batch"),
        "total_hits": P(),
        "n_chained": P(),
    }
    if cfg.est_ci:
        out_specs["ani_ci_low"] = P("db", "batch")
        out_specs["ani_ci_high"] = P("db", "batch")
    step = shard_map(
        local_block, mesh=mesh,
        in_specs=(P("db"), P("batch")),
        out_specs=out_specs,
    )
    return jax.jit(step)


def make_sharded_triangle(mesh: Mesh, cfg: ChainConfig,
                          budgets: EngineBudgets, block: int,
                          total_anchors: int):
    """Build the jitted mesh-parallel all-vs-all triangle step.

    The strict upper triangle of the G x G pair matrix is tiled into
    ``block`` x ``block`` chain_block tiles; tiles are distributed
    round-robin over EVERY device of the mesh (both axes flattened — an
    all-vs-all triangle has no ref/query asymmetry to map onto
    ("db", "batch") separately).  The genome stack is replicated; each
    device runs its tile share with ``lax.map`` (one compiled program,
    same static shape for every tile).  Diagonal tiles compute their
    full block and the host keeps only the upper triangle — bounded
    waste ((G/block) of ~(G/block)^2/2 tiles) for a single program
    shape.

    Called with (batch, ridx [T, block], qidx [T, block]) where T is a
    multiple of the device count; returns dict of [T, block, block]
    arrays sharded on the tile axis.
    """
    def local(batch: DeviceSketch, r_t: jax.Array, q_t: jax.Array):
        def one(tile):
            r_ids, q_ids = tile
            r = jax.tree.map(lambda x: jnp.take(x, r_ids, axis=0), batch)
            q = jax.tree.map(lambda x: jnp.take(x, q_ids, axis=0), batch)
            return chain_block(r, q, cfg=cfg, budgets=budgets,
                               total_anchors=total_anchors)

        return jax.lax.map(one, (r_t, q_t))

    step = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(("db", "batch")), P(("db", "batch"))),
        out_specs=P(("db", "batch")),
    )
    return jax.jit(step)


def _giant_mask(batch: DeviceSketch) -> np.ndarray:
    """Per-genome bool mask: contigs beyond the packed block-grid range
    or totals >= 2^30 bp (both route through the full-range per-pair
    pipeline; reference contract: no coordinate caps, lib.rs:160)."""
    from ..ops.chain import rcid_bits_for

    cl = np.asarray(jax.device_get(batch.contig_lengths)).astype(np.int64)
    cap = 1 << (32 - rcid_bits_for(cl.shape[1]))
    return (cl.max(axis=1) >= cap) | (cl.sum(axis=1) >= (1 << 30))


def _triangle_with_giants(batch: DeviceSketch, mesh: Mesh, mask: np.ndarray,
                          clean_fn, *, cfg: ChainConfig,
                          budgets: EngineBudgets, **kw):
    """Mesh triangle over a stack containing giant genomes: the clean
    subset runs through ``clean_fn`` (the mesh path), pairs touching a
    giant run through the full-range per-pair pipeline, and the two
    result sets merge in triu order — the same reroute the single-device
    ``engine.batch.triangle`` applies.

    ``budgets.max_fragments`` must cover the giant genomes' fragment
    counts (as on every per-pair call).
    """
    from ..engine.batch import check_overflow, pairs_ani

    G = batch.kmers.shape[0]
    giants = set(np.where(mask)[0].tolist())
    keep = np.array([i for i in range(G) if i not in giants], np.int32)
    host = jax.device_get(batch)
    # NOTE on budgets: the per-pair fallback drops anchors whose
    # fragment index exceeds budgets.max_fragments — chain_pairs
    # reports that through its frag_overflow output, which the
    # check_overflow below RAISES on, so an undersized mesh budget
    # fails loudly instead of silently truncating giant-pair ANI/AF
    parts = []
    if len(keep) >= 2:
        sub = jax.tree.map(lambda x: np.asarray(x)[keep], host)
        ri_s, qi_s, res_s = clean_fn(sub, mesh, cfg=cfg, budgets=budgets,
                                     **kw)
        parts.append((keep[ri_s], keep[qi_s], res_s))
    fb = [(i, j) for i in range(G) for j in range(i + 1, G)
          if i in giants or j in giants]
    if fb:
        ri_f = np.array([p[0] for p in fb], np.int32)
        qi_f = np.array([p[1] for p in fb], np.int32)
        out = jax.device_get(pairs_ani(host, jnp.asarray(ri_f),
                                       jnp.asarray(qi_f), cfg=cfg,
                                       budgets=budgets, chunk=4))
        check_overflow(out, budgets)
        parts.append((ri_f, qi_f, out))

    mats = {}
    for ri_p, qi_p, res in parts:
        for key, val in res.items():
            arr = np.asarray(val)
            if key not in mats:
                mats[key] = np.zeros((G, G), arr.dtype)
            mats[key][ri_p, qi_p] = arr
    ri, qi = np.triu_indices(G, k=1)
    return ri.astype(np.int32), qi.astype(np.int32), \
        {k: v[ri, qi] for k, v in mats.items()}


def sharded_triangle(batch: DeviceSketch, mesh: Mesh, *, cfg: ChainConfig,
                     budgets: EngineBudgets, block: int = 8,
                     anchors_per_pair: Optional[int] = None):
    """All-vs-all ANI over a genome stack, parallelised over a mesh.

    Mesh-scaled counterpart of ``engine.batch.triangle`` (the reference
    has no distributed mode at all, SURVEY.md §2.3); results are
    numerically identical to the single-device triangle because every
    tile runs the same chain_block program.  BASELINE.md asks for the
    all-vs-all metric "measured at 1 chip, 1 host, >= 2 hosts" — this is
    that scaling path.

    Returns (ref_idx, query_idx, dict of [P] numpy arrays) over the
    strict upper triangle, in triu order.

    Genomes beyond the packed block-grid range (contigs >=
    2^(32-rcid_bits) bp or totals >= 2^30 bp) are pre-partitioned out
    and their pairs run through the full-range per-pair pipeline, same
    as the single-device triangle.
    """
    from ..ops.sketch import round_up

    mask = _giant_mask(batch)
    if mask.any():
        return _triangle_with_giants(
            batch, mesh, mask, sharded_triangle, cfg=cfg, budgets=budgets,
            block=block, anchors_per_pair=anchors_per_pair)

    G = batch.kmers.shape[0]
    n_dev = mesh.size
    while block > 1 and block * block * budgets.max_fragments > (1 << 17):
        block //= 2
    app = anchors_per_pair or budgets.max_anchors
    # diagonal tiles also join their self-pairs (discarded on assembly),
    # and a self-pair's anchor count is the full seed count — give the
    # shared pool two extra per-pair shares per row of headroom
    total = round_up(block * (block + 2) * app, 8192)

    starts = list(range(0, G, block))
    tiles = []   # (a, b, ridx, qidx, rpad, qpad)
    for a in starts:
        for b in starts:
            if b < a:
                continue
            ridx = np.arange(a, min(a + block, G))
            qidx = np.arange(b, min(b + block, G))
            rpad = np.concatenate([ridx,
                                   np.full(block - len(ridx), ridx[0])])
            qpad = np.concatenate([qidx,
                                   np.full(block - len(qidx), qidx[0])])
            tiles.append((a, b, ridx, qidx, rpad, qpad))
    T = len(tiles)
    Tp = -(-T // n_dev) * n_dev
    r_arr = np.zeros((Tp, block), np.int32)
    q_arr = np.zeros((Tp, block), np.int32)
    for t, (_, _, _, _, rp, qp) in enumerate(tiles):
        r_arr[t] = rp
        q_arr[t] = qp
    # padding tiles recompute tile 0 (discarded on assembly)
    for t in range(T, Tp):
        r_arr[t] = tiles[0][4]
        q_arr[t] = tiles[0][5]

    step = make_sharded_triangle(mesh, cfg, budgets, block, total)
    rep = replicate(mesh, batch)
    out = step(rep, jnp.asarray(r_arr), jnp.asarray(q_arr))
    fetched = jax.device_get(out)

    mats = {}
    for t, (a, b, ridx, qidx, _, _) in enumerate(tiles):
        for key, val in fetched.items():
            tile_val = val[t][:len(ridx), :len(qidx)]
            if key not in mats:
                mats[key] = np.zeros((G, G), tile_val.dtype)
            mats[key][np.ix_(ridx, qidx)] = tile_val
    ri, qi = np.triu_indices(G, k=1)
    result = {k: v[ri, qi] for k, v in mats.items()}
    from ..engine.batch import check_overflow
    check_overflow(result, budgets)
    return ri, qi, result


def ring_triangle(batch: DeviceSketch, mesh: Mesh, *, cfg: ChainConfig,
                  budgets: EngineBudgets,
                  anchors_per_pair: Optional[int] = None):
    """Memory-scalable all-vs-all: genome blocks ride an ICI ring.

    ``sharded_triangle`` replicates the whole stack on every device —
    fastest for modest G, but per-device memory grows with G.  Here the
    stack is SHARDED into D blocks (one per device); each round, every
    device receives its neighbour's block over the interconnect
    (``jax.lax.ppermute`` ring shift — the blockwise/ring long-sequence
    analog of SURVEY.md §2.3) and chains its resident block against the
    visitor, so per-device memory is TWO blocks regardless of G.  Rounds
    ``s = 1 .. ceil((D-1)/2)`` cover every unordered block pair exactly
    once (the final round is computed twice when D is even — both
    owners produce the identical canonically-oriented tile).  Tile
    orientation follows the single-device convention (ref = the block
    with smaller global ids), selected per-device by input swap, so
    results are bit-identical to ``engine.batch.triangle``.

    Returns (ref_idx, query_idx, dict of [P] numpy arrays) in triu
    order over the G genomes.  Giant genomes (packed-range overflow or
    totals >= 2^30 bp) are pre-partitioned onto the full-range per-pair
    pipeline, as in :func:`sharded_triangle`.
    """
    from ..ops.sketch import round_up

    mask = _giant_mask(batch)
    if mask.any():
        return _triangle_with_giants(
            batch, mesh, mask, ring_triangle, cfg=cfg, budgets=budgets,
            anchors_per_pair=anchors_per_pair)

    G = batch.kmers.shape[0]
    D = mesh.size
    ring = Mesh(mesh.devices.reshape(-1), ("ring",))
    Bl = -(-G // D)
    if Bl * Bl * budgets.max_fragments > (1 << 17):
        raise ValueError(
            f"block of {Bl} genomes exceeds the pair-grid limit; use "
            f"more devices or smaller max_fragments")
    app = anchors_per_pair or budgets.max_anchors
    total = round_up(Bl * (Bl + 2) * app, 8192)
    S = D // 2  # rounds; the final one is duplicated when D is even

    # pad to D*Bl genomes with repeats of genome 0 (discarded on host)
    pad = D * Bl - G
    if pad:
        batch = jax.tree.map(
            lambda x: jnp.concatenate([x] + [x[:1]] * pad), batch)
    sharded = shard_leading(ring, batch, "ring")

    def local(block: DeviceSketch):
        d = jax.lax.axis_index("ring")
        diag = chain_block(block, block, cfg=cfg, budgets=budgets,
                           total_anchors=total)
        outs = [jax.tree.map(lambda x: x[None], diag)]
        buf = block
        for s in range(1, S + 1):
            # receive the block of device (d + s) — shift the ring by
            # one each round (source i+1 -> dest i)
            buf = jax.tree.map(
                lambda x: jax.lax.ppermute(
                    x, "ring", [((i + 1) % D, i) for i in range(D)]),
                buf)
            e = (d + s) % D
            mine_is_ref = d < e    # canonical orientation: smaller block
            r_in = jax.tree.map(
                lambda a, b: jnp.where(mine_is_ref, a, b), block, buf)
            q_in = jax.tree.map(
                lambda a, b: jnp.where(mine_is_ref, b, a), block, buf)
            out = chain_block(r_in, q_in, cfg=cfg, budgets=budgets,
                              total_anchors=total)
            outs.append(jax.tree.map(lambda x: x[None], out))
        return jax.tree.map(lambda *xs: jnp.concatenate(xs), *outs)

    step = shard_map(local, mesh=ring, in_specs=(P("ring"),),
                     out_specs=P("ring"))
    fetched = jax.device_get(jax.jit(step)(sharded))

    # host assembly: device d's rows sit at [d*(S+1), (d+1)*(S+1))
    mats = {}
    for d in range(D):
        for s in range(0, S + 1):
            e = (d + s) % D
            lo_b, hi_b = min(d, e), max(d, e)
            ridx = np.arange(lo_b * Bl, (lo_b + 1) * Bl)
            qidx = np.arange(hi_b * Bl, (hi_b + 1) * Bl)
            rk = ridx < G
            qk = qidx < G
            for key, val in fetched.items():
                tile = val[d * (S + 1) + s]
                if key not in mats:
                    mats[key] = np.zeros((G, G), tile.dtype)
                mats[key][np.ix_(ridx[rk], qidx[qk])] = \
                    tile[np.ix_(rk.nonzero()[0], qk.nonzero()[0])]
    ri, qi = np.triu_indices(G, k=1)
    result = {k: v[ri, qi] for k, v in mats.items()}
    from ..engine.batch import check_overflow
    check_overflow(result, budgets)
    return ri, qi, result


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Initialise the JAX distributed runtime across several GPU hosts.

    Pass the coordinator's ``host:port``, the process count and this
    process's id; they may be left out only where a cluster launcher
    (for example SLURM) already tells JAX.  After this, ``jax.devices()``
    spans every host, and meshes built by ``make_mesh`` lay the ``db``
    axis across hosts and ``batch`` within them in device order.
    """
    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
