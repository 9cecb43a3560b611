"""Benchmark: all-vs-all ANI throughput on one GPU.

Workload (BASELINE.md config 3): sketch N synthetic bacterial-scale
genomes (~2.3 Mbp, ~99% pairwise ANI family), then run the batched
all-vs-all triangle — N*(N-1)/2 pairs — through the jitted pair pipeline.

Prints exactly ONE JSON line:
  {"metric": ..., "value": pairs/s, "unit": "pairs/s", "vs_baseline": x}

Default path: BLOCK x BLOCK chain_block tiles.  Every tile shares ONE
static shape (same total_anchors, same budgets), so the whole run
compiles exactly ONE XLA program, reused across all tiles and cached
persistently.  Set BENCH_MODE=triangle to opt into the grouped
self-join path.

Baseline: the reference publishes no throughput numbers (SURVEY.md §6).
``vs_baseline`` divides by 30 genome-pairs/s, an estimate of single-core
skani for genomes of this size, not a measurement.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

SINGLE_CORE_SKANI_PAIRS_PER_S = 30.0  # estimate, not a measurement

N_GENOMES = int(os.environ.get("BENCH_GENOMES", "32"))
GENOME_LEN = int(os.environ.get("BENCH_GENOME_LEN", str(2_300_000)))
BLOCK = int(os.environ.get("BENCH_BLOCK", "16"))
MODE = os.environ.get("BENCH_MODE", "block")  # "block" | "triangle"


def make_genomes(n, length, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=length)
    out = []
    for _ in range(n):
        arr = base.copy()
        idx = rng.integers(0, length, length // 100)  # ~1% substitutions
        arr[idx] = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                              size=len(idx))
        out.append(arr.tobytes())
    return out


def make_batch_on_device(n, length, params, device_batch=8, seed=0,
                         n_related=None):
    """Generate the ~99%-ANI genome family ON DEVICE, sketch it there,
    and return the stacked DeviceSketch batch — zero sequence uploads.

    The genomes are drawn from the same distribution as
    :func:`make_genomes` (one random base + ~1% substitutions per
    genome).

    ``n_related`` (default: all) makes only the first stacks related to
    the base; the remaining genomes are fresh random sequence (the
    BENCH mixed-family workload — unrelated pairs are screened out).
    Must be a multiple of ``device_batch``.

    Returns (batch DeviceSketch [n, ...],
             sketch_seconds_per_stack_fn, kernel_rate_fn).
    """
    import functools

    import jax
    import jax.numpy as jnp

    from pyskani_tpu.ops.sketch import (DeviceSketch, marker_budget_for,
                                        round_up, seed_budget_for,
                                        sketch_kernel)

    assert length % 4 == 0
    L = max(round_up(length, 1 << 20), 1 << 20)
    sb = seed_budget_for(length, params.c)
    mb = marker_budget_for(length, params.marker_c)
    MC = 8  # single-contig genomes: minimum contig bucket (r4: dynamic)
    starts = np.zeros(MC + 1, np.int32)
    starts[1:] = length
    starts_d = jnp.asarray(np.broadcast_to(starts,
                                           (device_batch, MC + 1)).copy())
    ncon = jnp.ones(device_batch, jnp.int32)
    kern = functools.partial(
        sketch_kernel, k=params.k, marker_k=params.marker_k,
        c=params.c, marker_c=params.marker_c,
        seed_budget=sb, marker_budget=mb)

    def _pack(codes):
        codes = jnp.pad(codes, ((0, 0), (0, L - length)))
        q = codes.reshape(device_batch, L // 4, 4)
        return (q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) |
                (q[..., 3] << 6)).astype(jnp.uint8)

    @functools.partial(jax.jit, static_argnames=("related",))
    def gen_packed(base_key, stack_key, related=True):
        base = jax.random.randint(base_key, (length,), 0, 4,
                                  dtype=jnp.uint8)

        def mut(k):
            ki, kv = jax.random.split(k)
            idx = jax.random.randint(ki, (length // 100,), 0, length)
            vals = jax.random.randint(kv, (length // 100,), 0, 4,
                                      dtype=jnp.uint8)
            return base.at[idx].set(vals)

        def fresh(k):
            return jax.random.randint(k, (length,), 0, 4, dtype=jnp.uint8)

        codes = jax.vmap(mut if related else fresh)(
            jax.random.split(stack_key, device_batch))
        return _pack(codes)

    @jax.jit
    def kernel_only(packed):
        return jax.vmap(kern)(packed, starts_d, ncon)

    @jax.jit
    def sketch_stack(base_key, stack_key):
        return jax.vmap(kern)(gen_packed(base_key, stack_key), starts_d,
                              ncon)

    base_key = jax.random.PRNGKey(seed)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1),
                            -(-n // device_batch))
    if n_related is None:
        n_related = n
    rel_stacks = n_related // device_batch
    outs = [sketch_stack(base_key, k) if i < rel_stacks else
            kernel_only(gen_packed(base_key, k, related=False))
            for i, k in enumerate(keys)]
    res = jax.tree.map(lambda *xs: jnp.concatenate(xs)[:n], *outs)
    batch = DeviceSketch(
        kmers=res["kmers"], positions=res["positions"],
        contig_ids=res["contig_ids"], strands=res["strands"],
        own_mult=res["own_mult"], p_positions=res["p_positions"],
        p_contig_ids=res["p_contig_ids"], p_own_mult=res["p_own_mult"],
        markers_hi=res["markers_hi"], markers_lo=res["markers_lo"],
        n_seeds=res["n_seeds"], n_markers=res["n_markers"],
        contig_lengths=jnp.zeros((n, MC), jnp.int32).at[:, 0].set(length),
        n_contigs=jnp.ones(n, jnp.int32),
        total_len=jnp.full(n, length, jnp.uint32),
    )

    def resketch_one_stack():
        out = sketch_stack(base_key, keys[0])
        jax.device_get(out["n_seeds"])
        return device_batch * length

    def kernel_rate(reps: int = 8):
        """Steady-state PIPELINED sketch-kernel throughput (Mbp/s):
        pre-generated packed codes, ``reps`` kernel dispatches in
        flight, one fetch — genome generation and the round trip
        amortise away, so this measures the kernel's device rate (the
        throughput limit when many stacks stream through)."""
        packed = gen_packed(base_key, keys[0])
        jax.device_get(kernel_only(packed)["n_seeds"])  # warm + drain
        t0 = time.time()
        outs = [kernel_only(packed) for _ in range(reps)]
        jax.device_get([o["n_seeds"] for o in outs])
        return device_batch * length * reps / (time.time() - t0) / 1e6

    return batch, resketch_one_stack, kernel_rate


def main():
    import jax

    from pyskani_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from pyskani_tpu.oracle.chain import ChainConfig
    from pyskani_tpu.ops.chain import EngineBudgets
    from pyskani_tpu.ops.sketch import round_up

    from pyskani_tpu.params import SketchParams

    dev = jax.devices()[0]
    params = SketchParams()

    # --- sketching (device-generated family; dispatched ASYNC so the
    # chain-program compiles below overlap the device-side sketch work) ---
    t0 = time.time()
    batch, resketch, kernel_rate = make_batch_on_device(
        N_GENOMES, GENOME_LEN, params)

    cfg = ChainConfig()
    nf = round_up(-(-GENOME_LEN // cfg.fragment_length) + 2, 128)
    budgets = EngineBudgets(
        max_anchors=round_up(batch.kmers.shape[1] * 3 // 2 + 4096, 8192),
        max_fragments=nf,
        max_anchors_per_fragment=256,
        # the ~99%-ANI family keeps <= ~115 chains/pair (measured); the
        # library default 2048 sizes for fragmented drafts.  run(check=
        # True) asserts n_chains <= this, so saturation fails loudly
        # instead of degrading results.
        max_chains_per_pair=256)
    ri, qi = np.triu_indices(N_GENOMES, k=1)
    n_pairs = len(ri)

    # shared anchor pool: ~pairs x typical anchors/pair (seed count bounds
    # the anchors of a non-repetitive pair)
    app = round_up(batch.kmers.shape[1] * 3 // 4, 1024)

    if MODE == "triangle":
        run, n_dispatch, prime = build_triangle_runner(
            batch, cfg, budgets, app, nf)
    else:
        run, n_dispatch, prime = build_block_runner(batch, cfg, budgets, app)

    primed = prime()  # compile both program shapes CONCURRENTLY (XLA
    #          compile releases the GIL; two threads overlap the two
    #          compiles, and both overlap the async sketching above)
    jax.device_get(batch.n_seeds[:1])
    t_sketch_all = time.time() - t0  # sketch-all + compiles, overlapped
    # drain the priming executions before timing the steady-state
    # sketch rate
    jax.device_get([a.reshape(-1)[:1] for a in primed])
    # re-sketch one stack without compile cost for the steady-state
    # rate; min of 3 reps
    times = []
    for _ in range(3):
        t0 = time.time()
        bases = resketch()
        times.append(time.time() - t0)
    sketch_mbps = bases / min(times) / 1e6
    sketch_kernel_mbps = kernel_rate()

    t0 = time.time()
    out = run(check=True)  # first full run + overflow asserts
    t_first = time.time() - t0

    t0 = time.time()
    reps = 3
    for _ in range(reps):
        out = run()
    t_steady = (time.time() - t0) / reps
    pairs_per_s = n_pairs / t_steady

    mean_ani = float(np.mean(out["ani_mean"][ri, qi]))
    sys.stderr.write(
        f"device={dev} mode={MODE} genomes={N_GENOMES}x{GENOME_LEN/1e6:.1f}"
        f"Mbp pairs={n_pairs} tiles={n_dispatch} first={t_first:.1f}s "
        f"steady={t_steady:.2f}s sketch={sketch_mbps:.1f}Mbp/s "
        f"sketch_kernel={sketch_kernel_mbps:.1f}Mbp/s "
        f"sketch_all={t_sketch_all:.1f}s mean_ani={mean_ani:.4f}\n")

    # --- mixed-family variant: half the genomes unrelated, so the
    # marker screen's compute saving is exercised end-to-end (screen ->
    # shortlist -> chain; the homogeneous family passes every pair so
    # the screen never pays for itself there) ---
    mixed = {}
    if os.environ.get("BENCH_MIXED", "1") != "0" and MODE == "block":
        mixed = run_mixed_family(params, cfg, budgets, app)
        sys.stderr.write(
            f"mixed: {mixed['mixed_pairs_per_s']} pairs/s, screened_out="
            f"{mixed['mixed_screened_out']} mean_kin_ani="
            f"{mixed.pop('_mean_kin_ani'):.4f}\n")

    print(json.dumps({
        "metric": (f"genome-pairs/s per chip (all-vs-all ANI, "
                   f"{N_GENOMES}x{GENOME_LEN / 1e6:.1f}Mbp)"),
        "value": round(pairs_per_s, 2),
        "unit": "pairs/s",
        "vs_baseline": round(pairs_per_s / SINGLE_CORE_SKANI_PAIRS_PER_S, 2),
        # BASELINE.md's second north-star metric.
        # sketch_mbps = end-to-end one-stack rate (incl. on-device genome
        # generation + round trip); sketch_kernel_mbps = pipelined
        # kernel-only device rate
        "sketch_mbps": round(sketch_mbps, 1),
        "sketch_kernel_mbps": round(sketch_kernel_mbps, 1),
        "sketch_all_s": round(t_sketch_all, 1),
        **mixed,
    }))


def run_mixed_family(params, cfg, budgets, app):
    """Screen-gated all-vs-all over a half-related family:
    marker-screen all pairs on device, then chain ONLY the
    tiles containing a passing pair — the reference's search semantics
    (lib.rs:616-657) at bench scale.  Reuses the homogeneous run's tile
    program shapes (one compile).  Reported pairs/s covers ALL
    N*(N-1)/2 pairs: screened-out pairs are decided by the screen, so
    they count toward throughput exactly as in `skani search`."""
    import jax
    import jax.numpy as jnp

    from pyskani_tpu.engine.batch import take_sketch
    from pyskani_tpu.ops.chain import chain_block, chain_triangle, triu_pairs
    from pyskani_tpu.ops.screen import screen_batch
    from pyskani_tpu.ops.sketch import round_up
    from pyskani_tpu.params import SEARCH_ANI_CUTOFF_DEFAULT

    N = N_GENOMES
    n_kin = (N // 2) // 8 * 8 or 8
    batch, _, _ = make_batch_on_device(N, GENOME_LEN, params, seed=11,
                                       n_related=n_kin)

    @jax.jit
    def screen_all(b):
        return jax.vmap(
            lambda qh, ql, qn: screen_batch(
                qh, ql, qn, b.markers_hi, b.markers_lo, b.n_markers,
                SEARCH_ANI_CUTOFF_DEFAULT,
                marker_k=params.marker_k, rescue_small=True)[0]
        )(b.markers_hi, b.markers_lo, b.n_markers)   # [query, ref]

    total = round_up(BLOCK * BLOCK * app, 8192)
    tri_total = round_up(BLOCK * (BLOCK - 1) // 2 * app, 8192)
    passes = np.asarray(jax.device_get(screen_all(batch)))  # warm + result

    def run():
        t0 = time.time()
        P = np.asarray(jax.device_get(screen_all(batch)))
        starts = list(range(0, N, BLOCK))
        pend = []
        chained = 0
        for a in starts:
            gidx = np.arange(a, min(a + BLOCK, N))
            tr, tq = triu_pairs(len(gidx))
            if len(gidx) >= 2 and P[gidx[tq], gidx[tr]].any():
                out = chain_triangle(
                    take_sketch(batch, jnp.asarray(gidx)), cfg=cfg,
                    budgets=budgets, total_anchors=tri_total)
                pend.append((gidx[tr], gidx[tq], out["ani_mean"]))
                chained += len(tr)
            for b in starts:
                if b <= a:
                    continue
                qidx = np.arange(b, min(b + BLOCK, N))
                if not P[np.ix_(qidx, gidx)].any():
                    continue
                out = chain_block(take_sketch(batch, jnp.asarray(gidx)),
                                  take_sketch(batch, jnp.asarray(qidx)),
                                  cfg=cfg, budgets=budgets,
                                  total_anchors=total)
                rr, qq = np.meshgrid(gidx, qidx, indexing="ij")
                pend.append((rr.reshape(-1), qq.reshape(-1),
                             out["ani_mean"].reshape(-1)))
                chained += rr.size
        ani = np.zeros((N, N), np.float32)
        for rr, qq, vals in pend:
            ani[rr, qq] = np.asarray(jax.device_get(vals))
        return time.time() - t0, ani, chained

    run()                       # compile anything not yet cached
    t, ani, chained = run()     # steady state
    ri, qi = np.triu_indices(N, k=1)
    n_pairs = len(ri)
    pass_tri = passes[qi, ri]
    kin_mask = (ri < n_kin) & (qi < n_kin)
    mean_kin = float(ani[ri[kin_mask], qi[kin_mask]].mean())
    assert mean_kin > 0.9, f"mixed kin pairs did not chain: {mean_kin}"
    return {
        "mixed_pairs_per_s": round(n_pairs / t, 2),
        "mixed_screened_out": round(1.0 - pass_tri.mean(), 3),
        "mixed_tiles_chained_pairs": int(chained),
        "_mean_kin_ani": mean_kin,
    }


def build_block_runner(batch, cfg, budgets, app):
    """All-vs-all via BLOCK x BLOCK chain_block tiles for the strict
    upper off-diagonal blocks plus one small chain_triangle shape for
    each diagonal block — exactly N*(N-1)/2 useful pair slots with TWO
    program shapes total (a full-diagonal block tile would waste half
    its slots on the lower triangle + self pairs).

    Tiles beyond N are padded with genome index repeats and sliced off
    on readback.
    """
    import jax.numpy as jnp

    from pyskani_tpu.engine.batch import take_sketch
    from pyskani_tpu.ops.chain import chain_block, chain_triangle, triu_pairs
    from pyskani_tpu.ops.sketch import round_up

    total = round_up(BLOCK * BLOCK * app, 8192)
    tri_total = round_up(BLOCK * (BLOCK - 1) // 2 * app, 8192)
    starts = list(range(0, N_GENOMES, BLOCK))
    rect_tiles = []  # (ridx, qidx, padded ref ids, padded query ids)
    tri_tiles = []   # (pair ref ids, pair query ids, keep, padded ids)
    for a in starts:
        gidx = np.arange(a, min(a + BLOCK, N_GENOMES))
        if len(gidx) >= 2:
            gpad = np.concatenate([gidx,
                                   np.full(BLOCK - len(gidx), gidx[0])])
            tr, tq = triu_pairs(BLOCK)
            keep = (tr < len(gidx)) & (tq < len(gidx))
            tri_tiles.append((gpad[tr[keep]], gpad[tq[keep]], keep,
                              jnp.asarray(gpad)))
        for b in starts:
            if b <= a:
                continue
            ridx = gidx
            qidx = np.arange(b, min(b + BLOCK, N_GENOMES))
            rpad = np.concatenate([ridx, np.full(BLOCK - len(ridx), ridx[0])])
            qpad = np.concatenate([qidx, np.full(BLOCK - len(qidx), qidx[0])])
            rect_tiles.append((ridx, qidx, jnp.asarray(rpad),
                               jnp.asarray(qpad)))

    import jax

    def run(check=False):
        # dispatch every tile asynchronously, then fetch ALL results with
        # ONE device_get — per-tile np.asarray would pay one round trip
        # per array
        want = ("ani_mean", "anchors_overflow", "n_chains",
                "pos_overflow") if check \
            else ("ani_mean",)
        touts = [(pr, pq, keep,
                  chain_triangle(take_sketch(batch, g), cfg=cfg,
                                 budgets=budgets, total_anchors=tri_total))
                 for pr, pq, keep, g in tri_tiles]
        routs = [(ridx, qidx,
                  chain_block(take_sketch(batch, rp),
                              take_sketch(batch, qp),
                              cfg=cfg, budgets=budgets, total_anchors=total))
                 for ridx, qidx, rp, qp in rect_tiles]
        fetched = jax.device_get(
            [{k: o[k] for k in want} for *_, o in touts] +
            [{k: o[k] for k in want} for *_, o in routs])
        ani = np.zeros((N_GENOMES, N_GENOMES), np.float32)
        for (pr, pq, keep, _), o in zip(touts, fetched):
            ani[pr, pq] = o["ani_mean"][keep]
            if check:
                assert not bool(np.any(o["pos_overflow"])), \
                    "contig coordinate overflow (packed grid cap)"
                assert not bool(np.any(o["anchors_overflow"])), \
                    "anchor pool overflow — raise BENCH app budget"
                assert int(np.max(o["n_chains"])) <= \
                    budgets.max_chains_per_pair, "chain table overflow"
        for (ridx, qidx, _), o in zip(routs, fetched[len(touts):]):
            ani[np.ix_(ridx, qidx)] = o["ani_mean"][:len(ridx), :len(qidx)]
            if check:
                assert not bool(np.any(o["pos_overflow"])), \
                    "contig coordinate overflow (packed grid cap)"
                assert not bool(np.any(o["anchors_overflow"])), \
                    "anchor pool overflow — raise BENCH app budget"
                assert int(np.max(o["n_chains"])) <= \
                    budgets.max_chains_per_pair, "chain table overflow"
        return {"ani_mean": ani}

    def prime():
        return _prime_concurrent(
            ([lambda: chain_triangle(take_sketch(batch, tri_tiles[0][3]),
                                     cfg=cfg, budgets=budgets,
                                     total_anchors=tri_total)["ani_mean"]]
             if tri_tiles else []) +
            ([lambda: chain_block(take_sketch(batch, rect_tiles[0][2]),
                                  take_sketch(batch, rect_tiles[0][3]),
                                  cfg=cfg, budgets=budgets,
                                  total_anchors=total)["ani_mean"]]
             if rect_tiles else []))

    return run, len(tri_tiles) + len(rect_tiles), prime


def _prime_concurrent(thunks):
    """First-call each jitted program from its own thread so the XLA
    compiles overlap (compilation happens in C++ with the GIL released;
    degrades harmlessly to sequential if not).

    Returns the result arrays — callers drain them with a fetch
    (``jax.device_get``) before any timed region, so the priming
    executions are not still queued on the device in the next
    measurement.
    """
    import concurrent.futures as cf

    if not thunks:
        return []
    with cf.ThreadPoolExecutor(len(thunks)) as ex:
        return list(ex.map(lambda f: f(), thunks))


def build_triangle_runner(batch, cfg, budgets, app, nf):
    """Opt-in grouped self-join path (BENCH_MODE=triangle)."""
    import jax.numpy as jnp

    from pyskani_tpu.engine.batch import max_triangle_group, take_sketch
    from pyskani_tpu.ops.chain import chain_block, chain_triangle, triu_pairs
    from pyskani_tpu.ops.sketch import round_up

    GROUP = max_triangle_group(budgets, min(32, N_GENOMES))
    tri_total = round_up(GROUP * (GROUP - 1) // 2 * app, 8192)
    rect_total = round_up(BLOCK * BLOCK * app, 8192)
    starts = list(range(0, N_GENOMES, GROUP))
    tri_tiles = []
    rect_tiles = []
    for a in starts:
        gidx = np.arange(a, min(a + GROUP, N_GENOMES))
        if len(gidx) < 2:
            continue
        # pad the group to GROUP genomes so every triangle tile shares one
        # program shape; pairs involving pad repeats are sliced off
        gpad = np.concatenate([gidx, np.full(GROUP - len(gidx), gidx[0])])
        tr, tq = triu_pairs(GROUP)
        keep = (tr < len(gidx)) & (tq < len(gidx))
        tri_tiles.append((gpad[tr[keep]], gpad[tq[keep]], keep,
                          jnp.asarray(gpad)))
    for a in starts:
        for b in starts:
            if b <= a:
                continue
            for bi in range(a, min(a + GROUP, N_GENOMES), BLOCK):
                for bj in range(b, min(b + GROUP, N_GENOMES), BLOCK):
                    ridx = np.arange(bi, min(bi + BLOCK, N_GENOMES))
                    qidx = np.arange(bj, min(bj + BLOCK, N_GENOMES))
                    rpad = np.concatenate(
                        [ridx, np.full(BLOCK - len(ridx), ridx[0])])
                    qpad = np.concatenate(
                        [qidx, np.full(BLOCK - len(qidx), qidx[0])])
                    rect_tiles.append((ridx, qidx, jnp.asarray(rpad),
                                       jnp.asarray(qpad)))

    import jax

    def run(check=False):
        want = ("ani_mean", "anchors_overflow", "pos_overflow") if check \
            else ("ani_mean",)
        outs = [(pr, pq, keep,
                 chain_triangle(take_sketch(batch, g), cfg=cfg,
                                budgets=budgets, total_anchors=tri_total))
                for pr, pq, keep, g in tri_tiles]
        rect_outs = [(ridx, qidx,
                      chain_block(take_sketch(batch, rp),
                                  take_sketch(batch, qp), cfg=cfg,
                                  budgets=budgets,
                                  total_anchors=rect_total))
                     for ridx, qidx, rp, qp in rect_tiles]
        fetched = jax.device_get(
            [{k: o[k] for k in want} for *_, o in outs] +
            [{k: o[k] for k in want} for *_, o in rect_outs])
        ani = np.zeros((N_GENOMES, N_GENOMES), np.float32)
        for (pr, pq, keep, _), o in zip(outs, fetched):
            ani[pr, pq] = o["ani_mean"][keep]
            if check:
                assert not bool(np.any(o["pos_overflow"]))
                assert not bool(np.any(o["anchors_overflow"]))
        for (ridx, qidx, _), o in zip(rect_outs, fetched[len(outs):]):
            ani[np.ix_(ridx, qidx)] = o["ani_mean"][:len(ridx), :len(qidx)]
            if check:
                assert not bool(np.any(o["pos_overflow"]))
                assert not bool(np.any(o["anchors_overflow"]))
        return {"ani_mean": ani}

    def prime():
        return _prime_concurrent(
            ([lambda: chain_triangle(take_sketch(batch, tri_tiles[0][3]),
                                     cfg=cfg, budgets=budgets,
                                     total_anchors=tri_total)["ani_mean"]]
             if tri_tiles else []) +
            ([lambda: chain_block(take_sketch(batch, rect_tiles[0][2]),
                                  take_sketch(batch, rect_tiles[0][3]),
                                  cfg=cfg, budgets=budgets,
                                  total_anchors=rect_total)["ani_mean"]]
             if rect_tiles else []))

    return run, len(tri_tiles) + len(rect_tiles), prime


if __name__ == "__main__":
    main()
