"""Multi-chip sharding tests on the 8-virtual-device CPU mesh.

Shard-invariance is the key property (SURVEY.md §7.3 hard part 5): the
sharded many-to-many search must produce the same ANI/AF as the
single-device pair pipeline regardless of mesh shape.
"""

import jax
import numpy as np
import pytest

from pyskani_tpu.engine.batch import stack_sketches, take_sketch
from pyskani_tpu.oracle.chain import ChainConfig
from pyskani_tpu.ops.chain import EngineBudgets, chain_pair
from pyskani_tpu.ops.sketch import sketch_genome_device
from pyskani_tpu.parallel.dist import make_sharded_search, shard_leading
from pyskani_tpu.parallel.mesh import make_mesh
from pyskani_tpu.params import SketchParams

from conftest import mutate, random_genome

CFG = ChainConfig()
BUDGETS = EngineBudgets(max_anchors=4096, max_fragments=128,
                        max_anchors_per_fragment=128)


@pytest.fixture(scope="module")
def family():
    rng = np.random.default_rng(21)
    base = random_genome(rng, 40_000)
    genomes = [mutate(rng, base, 0.005 + 0.005 * i) for i in range(12)]
    params = SketchParams()
    return [sketch_genome_device(f"g{i}", [g], params,
                                 length_bucket=1 << 16,
                                 seed_budget=1024, marker_budget=512)
            for i, g in enumerate(genomes)]


def _reference_results(sketches, R, Q):
    """Dense [R, Q] results via the single-device pair pipeline."""
    out = np.zeros((R, Q))
    afq = np.zeros((R, Q))
    for i in range(R):
        for j in range(Q):
            r = chain_pair(sketches[i].device, sketches[R + j].device,
                           cfg=CFG, budgets=BUDGETS)
            out[i, j] = float(r["ani_mean"])
            afq[i, j] = float(r["af_query"])
    return out, afq


@pytest.mark.parametrize("db,batch", [(8, 1), (4, 2), (2, 4)])
def test_shard_invariance(family, db, batch):
    R, Q = 8, 4
    refs = stack_sketches(family[:R])
    queries = stack_sketches(family[R:R + Q])
    want_ani, want_afq = _reference_results(family, R, Q)

    mesh = make_mesh(db=db, batch=batch)
    step = make_sharded_search(mesh, CFG, BUDGETS, chunk=2)
    r_sh = shard_leading(mesh, refs, "db")
    q_sh = shard_leading(mesh, queries, "batch")
    # pad the ref/query axes to multiples of the mesh axes
    def pad_axis(tree, n, total):
        return jax.tree.map(
            lambda x: np.concatenate(
                [np.asarray(x)] + [np.asarray(x[:1])] * (total - n)), tree)
    if R % db or Q % batch:
        pytest.skip("axis not divisible for this mesh")
    out = step(r_sh, q_sh)
    got_ani = np.asarray(out["ani_mean"])
    got_afq = np.asarray(out["af_query"])
    sp = np.asarray(out["screen_pass"])
    assert got_ani.shape == (R, Q)
    # screened-in entries must match the dense reference exactly
    np.testing.assert_allclose(got_ani[sp], want_ani[sp], atol=2e-6)
    np.testing.assert_allclose(got_afq[sp], want_afq[sp], atol=2e-6)
    # the whole family is closely related: everything passes the screen
    assert sp.all()
    hits = int(np.asarray(out["total_hits"])[0])
    assert hits == int((want_ani > 0.1).sum())


def test_screen_saves_compute():
    """Screened-out pairs are never chained.  With a
    mostly-unrelated reference set the shortlist pass count (n_chained)
    must be far below R*Q, while screened-in pairs still match the dense
    per-pair reference exactly."""
    rng = np.random.default_rng(33)
    params = SketchParams()
    base = random_genome(rng, 40_000)
    related = [mutate(rng, base, 0.01) for _ in range(2)]
    unrelated = [random_genome(rng, 40_000) for _ in range(6)]
    genomes = related + unrelated          # refs 0-7
    queries = [mutate(rng, base, 0.02)]    # 1 query, kin of refs 0-1 only
    sk = [sketch_genome_device(f"g{i}", [g], params, length_bucket=1 << 16,
                               seed_budget=1024, marker_budget=512)
          for i, g in enumerate(genomes + queries)]
    refs = stack_sketches(sk[:8])
    qs = stack_sketches(sk[8:9] * 1)

    mesh = make_mesh(db=8, batch=1)
    step = make_sharded_search(mesh, CFG, BUDGETS, chunk=1)
    out = step(shard_leading(mesh, refs, "db"),
               shard_leading(mesh, qs, "batch"))
    sp = np.asarray(out["screen_pass"])
    n_chained = int(np.asarray(out["n_chained"])[0])
    assert n_chained == int(sp.sum())
    assert n_chained <= 2                   # only the related refs pass
    assert n_chained < 8                    # strictly fewer than R*Q
    # screened-in results equal the dense pair pipeline
    for i in np.nonzero(sp[:, 0])[0]:
        ref = chain_pair(sk[i].device, sk[8].device, cfg=CFG,
                         budgets=BUDGETS)
        np.testing.assert_allclose(np.asarray(out["ani_mean"])[i, 0],
                                   float(ref["ani_mean"]), atol=2e-6)
    # screened-out pairs were never chained: planes stay zero
    assert (np.asarray(out["ani_mean"])[~sp] == 0).all()
    assert (np.asarray(out["n_anchors"])[~sp] == 0).all()


def test_restart_reshard_deterministic(tmp_path):
    """Elastic-restart contract (SURVEY §5): the on-disk database is the
    checkpoint; after save -> reopen, sharded search on ANY mesh shape
    yields identical hits (shard assignment is a pure function of marker
    order and mesh shape)."""
    import pyskani_tpu
    from pyskani_tpu.parallel.search import ShardedDatabaseSearch

    rng = np.random.default_rng(41)
    base = random_genome(rng, 30_000)
    db = pyskani_tpu.Database(tmp_path / "db")
    for i in range(6):
        db.sketch(f"g{i}", mutate(rng, base, 0.01))
    db.flush()

    queries = [(f"q{i}", [mutate(rng, base, 0.02)]) for i in range(2)]

    def hits_on(mesh_shape):
        re = pyskani_tpu.Database.load(tmp_path / "db")  # restart
        m = make_mesh(db=mesh_shape[0], batch=mesh_shape[1])
        s = ShardedDatabaseSearch(re, m, chunk=2, learned_ani=False)
        return [[(h.reference_name, round(h.identity, 6),
                  round(h.query_fraction, 6)) for h in hs]
                for hs in s.query_many(queries)]

    a = hits_on((4, 2))
    b = hits_on((2, 4))
    assert a == b
    assert all(len(hs) == 6 for hs in a)


def test_streamed_sharded_search_matches_memory(tmp_path):
    """Disk-backed (open) stores STREAM ref chunks through the mesh:
    results must equal the in-memory preplaced-stack path for any
    chunking, peak ref memory bounded by one chunk."""
    import pyskani_tpu
    from pyskani_tpu.parallel.search import ShardedDatabaseSearch

    rng = np.random.default_rng(43)
    base = random_genome(rng, 30_000)
    db = pyskani_tpu.Database(tmp_path / "sdb")
    for i in range(10):
        db.sketch(f"g{i}", mutate(rng, base, 0.005 + 0.002 * i))
    db.flush()

    queries = [(f"q{i}", [mutate(rng, base, 0.02)]) for i in range(3)]
    mesh = make_mesh(db=4, batch=2)

    mem = pyskani_tpu.Database.load(tmp_path / "sdb")   # memory storage
    s_mem = ShardedDatabaseSearch(mem, mesh, chunk=2, learned_ani=False)
    want = [[(h.reference_name, round(h.identity, 6),
              round(h.query_fraction, 6)) for h in hs]
            for hs in s_mem.query_many(queries)]

    lazy = pyskani_tpu.Database.open(tmp_path / "sdb")  # disk-backed
    # stream_refs_per_device=1 -> chunks of 4 refs: 3 chunks for 10 refs
    s_str = ShardedDatabaseSearch(lazy, mesh, chunk=2, learned_ani=False,
                                  stream_refs_per_device=1)
    assert s_str._streaming and len(s_str._ref_name_chunks) == 3
    got = [[(h.reference_name, round(h.identity, 6),
             round(h.query_fraction, 6)) for h in hs]
           for hs in s_str.query_many(queries)]
    assert got == want
    assert all(len(hs) == 10 for hs in got)


def test_sharded_search_oversized_query_fallback():
    """A query whose fragment count exceeds the searcher's store-sized
    budget reroutes through the single-device Database.query path
    instead of raising; results slot back into
    input order alongside mesh-path queries."""
    import pyskani_tpu
    from pyskani_tpu.parallel.search import ShardedDatabaseSearch

    rng = np.random.default_rng(47)
    base_big = random_genome(rng, 1_988_000)     # 71 x 28 kb slices
    slices = [base_big[i * 28_000:(i + 1) * 28_000] for i in range(71)]
    db = pyskani_tpu.Database()
    for i in range(4):
        # each reference matches ONE slice of the big query
        db.sketch(f"g{i}", mutate(rng, slices[i], 0.01))

    # an oversized query: 71 distinct contigs -> far more fragments
    # than the 28 kb references budget for.  The query is mostly novel
    # sequence, so the screen needs a low cutoff (applied identically
    # on both paths).
    big = [mutate(rng, s_, 0.02) for s_ in slices]
    small = [mutate(rng, slices[0], 0.02)]

    mesh = make_mesh(db=4, batch=2)
    s = ShardedDatabaseSearch(db, mesh, chunk=2, learned_ani=False,
                              cutoff=0.01)
    nfrag = sum(max(1, -(-len(c) // s._fl)) for c in big)
    assert nfrag + 2 > s._nf, "fixture must exceed the searcher budget"

    res = s.query_many([("big", big), ("small", small)])
    assert len(res) == 2
    want_big = db.query("big", *big, learned_ani=False, cutoff=0.01)
    got = {h.reference_name: h for h in res[0]}
    want = {h.reference_name: h for h in want_big}
    assert set(got) == set(want) and len(want) == 4
    for name in want:
        assert abs(got[name].identity - want[name].identity) < 1e-6
    # the regular query still went through the mesh and found its ref
    assert "g0" in {h.reference_name for h in res[1]}
