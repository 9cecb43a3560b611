"""Device chaining pipeline vs the NumPy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from pyskani_tpu.oracle import seeding as oseed
from pyskani_tpu.oracle.chain import ChainConfig, chain_seeds
from pyskani_tpu.ops.chain import EngineBudgets, chain_pair
from pyskani_tpu.ops.sketch import sketch_genome_device
from pyskani_tpu.params import SketchParams

from conftest import mutate, random_genome

CFG = ChainConfig()
BUDGETS = EngineBudgets(max_anchors=16384, max_fragments=64,
                        max_anchors_per_fragment=512)


def _oracle_all(ref_contigs, query_contigs):
    params = SketchParams()
    r = oseed.sketch_genome("ref", ref_contigs, params)
    q = oseed.sketch_genome("query", query_contigs, params)
    out = chain_seeds(r, q, CFG)
    fa = out.fragment_anis
    res = {"af_query": out.align_fraction_query, "af_ref": out.align_fraction_ref}
    if fa is None or not len(fa):
        res.update(ani_mean=0.0, ani_robust=0.0, ani_median=0.0)
        return res
    lo, hi = np.quantile(fa, [0.1, 0.9])
    sel = (fa >= lo) & (fa <= hi)
    res["ani_mean"] = fa.mean()
    res["ani_robust"] = fa[sel].mean() if sel.any() else fa.mean()
    res["ani_median"] = np.median(fa)
    return res


def _device_all(ref_contigs, query_contigs, budgets=BUDGETS):
    params = SketchParams()
    r = sketch_genome_device("ref", ref_contigs, params, length_bucket=1 << 17)
    q = sketch_genome_device("query", query_contigs, params, length_bucket=1 << 17)
    out = chain_pair(r.device, q.device, cfg=CFG, budgets=budgets)
    return {k: float(v) for k, v in out.items()}


def _compare(ref_contigs, query_contigs, tol=5e-6):
    o = _oracle_all(ref_contigs, query_contigs)
    d = _device_all(ref_contigs, query_contigs)
    for key in ("ani_mean", "ani_robust", "ani_median", "af_query", "af_ref"):
        assert abs(o[key] - d[key]) <= tol, (key, o[key], d[key])


def test_mutated_pair():
    rng = np.random.default_rng(7)
    g = random_genome(rng, 120_000)
    m = mutate(rng, g, sub_rate=0.01, indel_rate=0.0005)
    _compare([g], [m])


def test_higher_divergence():
    rng = np.random.default_rng(8)
    g = random_genome(rng, 100_000)
    m = mutate(rng, g, sub_rate=0.05, indel_rate=0.002)
    _compare([g], [m])


def test_multi_contig_query():
    rng = np.random.default_rng(9)
    g = random_genome(rng, 90_000)
    m = mutate(rng, g, sub_rate=0.02, indel_rate=0.001)
    # split the mutated genome into contigs; also reverse-complement one
    rc = m[30000:60000][::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))
    contigs = [m[:30000], rc, m[60000:]]
    _compare([g], contigs)


def test_unrelated_pair():
    rng = np.random.default_rng(10)
    a = random_genome(rng, 60_000)
    b = random_genome(rng, 60_000)
    o = _oracle_all([a], [b])
    d = _device_all([a], [b])
    assert d["ani_mean"] == pytest.approx(o["ani_mean"], abs=1e-5)
    assert d["af_query"] == pytest.approx(o["af_query"], abs=1e-6)


def test_searchsorted_rows_matches_numpy():
    """_searchsorted_rows == np.searchsorted row-wise, both sides."""
    from pyskani_tpu.ops.chain import _searchsorted_rows

    rng = np.random.default_rng(11)
    G, S, N = 5, 37, 400
    table = np.sort(rng.integers(0, 1000, (G, S)), axis=1).astype(np.int32)
    rows = rng.integers(0, G, N).astype(np.int32)
    vals = rng.integers(-5, 1005, N).astype(np.int32)
    for side in ("left", "right"):
        got = np.asarray(_searchsorted_rows(
            jnp.asarray(table), jnp.asarray(rows), jnp.asarray(vals), side))
        want = np.array([np.searchsorted(table[r], v, side=side)
                         for r, v in zip(rows, vals)])
        assert np.array_equal(got, want), side
    # zero-width table guard (seed=False stores)
    empty = jnp.zeros((G, 0), jnp.int32)
    out = np.asarray(_searchsorted_rows(
        empty, jnp.asarray(rows), jnp.asarray(vals)))
    assert np.array_equal(out, np.zeros(N, np.int32))


def _random_dp_grid(rng, NF, PF, rbits=3):
    """DP input planes for random near-diagonal anchors with mixed
    contigs/orientations and ragged per-row fill, rows sorted by
    (rcid, rpos) like the engine."""
    from pyskani_tpu.ops.chain import _dp_grid_from_words, _pack_grid_words

    qpos = np.zeros((NF, PF), np.int32)
    rpos = np.zeros((NF, PF), np.int32)
    rcid = np.zeros((NF, PF), np.int32)
    rev = np.zeros((NF, PF), bool)
    ok = np.zeros((NF, PF), bool)
    for r in range(NF):
        k = int(rng.integers(0, PF + 1))
        rp = np.sort(rng.integers(0, 1 << 14, k))
        qp = np.clip(rp + rng.integers(-2000, 2000, k), 0, (1 << 14) - 1)
        cid = np.sort(rng.integers(0, 6, k))
        order = np.lexsort((rp, cid))
        rpos[r, :k] = rp[order]
        qpos[r, :k] = qp[order]
        rcid[r, :k] = cid[order]
        rev[r, :k] = rng.random(k) < 0.3
        ok[r, :k] = True
    w1, w2 = _pack_grid_words(jnp.asarray(qpos), jnp.asarray(rpos),
                              jnp.asarray(rcid), jnp.asarray(rev),
                              jnp.asarray(ok), rbits)
    return _dp_grid_from_words(w1, w2, rbits)


@pytest.mark.parametrize("PF", [64, 100])
@pytest.mark.parametrize("lanes", ["ragged", "block_multiple"])
@pytest.mark.parametrize("band", [8, 25, 33])
def test_pallas_dp_matches_scan(band, lanes, PF):
    """The GPU Pallas DP kernel (Triton route, interpret mode) must equal
    the XLA lax.scan reference bit-for-bit — on CPU the kernel runs only
    here; chip_smoke.py compares the compiled kernel on the card.  Covers
    rings smaller than, equal to and past a power of two (band 8/25/33),
    lane counts that need padding, and an anchor axis that is not a
    power of two."""
    from pyskani_tpu.ops.chain import _dp_scan, _unpack_meta
    from pyskani_tpu.ops.chain_dp_pallas import LANE_BLOCK, dp_pallas

    NF = 2 * LANE_BLOCK if lanes == "block_multiple" else LANE_BLOCK + 72
    rng = np.random.default_rng(band * 1000 + PF + NF)
    cfg = ChainConfig(chain_band=band)
    grid = _random_dp_grid(rng, NF, PF)
    budgets = EngineBudgets(max_fragments=NF, max_anchors_per_fragment=PF)
    s_scan, r_scan = _dp_scan(_unpack_meta(grid), cfg, budgets)
    # the grid must exercise chaining, not only singleton anchors
    assert int((np.asarray(r_scan) != np.arange(PF)).sum()) > NF
    s_pal, r_pal = dp_pallas(grid["qpos"].T, grid["rpos"].T,
                             grid["meta"].T, cfg, interpret=True)
    np.testing.assert_array_equal(np.asarray(s_pal.T), np.asarray(s_scan))
    np.testing.assert_array_equal(np.asarray(r_pal.T), np.asarray(r_scan))


@pytest.mark.parametrize("backend,kernel", [("gpu", True), ("cpu", False)])
def test_dp_dispatch_picks_kernel_on_gpu(monkeypatch, backend, kernel):
    """On a GPU the DP runs the compiled kernel (never interpret mode);
    on the CPU it runs the lax.scan reference."""
    import jax

    from pyskani_tpu.ops import chain, chain_dp_pallas

    calls = []

    def stub(qpos_t, rpos_t, meta_t, cfg, interpret=False):
        calls.append(interpret)
        return (jnp.zeros(qpos_t.shape, jnp.float32),
                jnp.zeros(qpos_t.shape, jnp.int32))

    monkeypatch.setattr(chain_dp_pallas, "dp_pallas", stub)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    NF, PF = 24, 16
    grid = _random_dp_grid(np.random.default_rng(5), NF, PF)
    score, root = chain._dp_dispatch(grid, ChainConfig(), EngineBudgets())
    assert score.shape == root.shape == (NF, PF)
    assert calls == ([False] if kernel else [])
    if not kernel:
        want = chain._dp_scan(chain._unpack_meta(grid), ChainConfig(),
                              EngineBudgets())
        np.testing.assert_array_equal(np.asarray(root), np.asarray(want[1]))


def test_dp_dispatch_lowers_to_triton_for_cuda(monkeypatch):
    """Lowered for CUDA, the GPU branch is one compiled Triton kernel
    call — not the interpreter's unrolled HLO."""
    import jax

    from pyskani_tpu.ops import chain

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    grid = _random_dp_grid(np.random.default_rng(6), 200, 64)
    lowered = jax.jit(
        lambda g: chain._dp_dispatch(g, ChainConfig(), EngineBudgets())
    ).trace(grid).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert "while" not in text
