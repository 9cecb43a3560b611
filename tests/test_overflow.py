"""Budget-overflow reporting.

Deliberately overflow the shared anchor pool and the per-pair chain
table and observe the report — saturation must never pass silently.
"""

import numpy as np
import pytest

from pyskani_tpu.engine.batch import check_overflow, stack_sketches
from pyskani_tpu.oracle.chain import ChainConfig
from pyskani_tpu.ops.chain import EngineBudgets, chain_block, chain_triangle
from pyskani_tpu.ops.sketch import sketch_genome_device
from pyskani_tpu.params import SketchParams

from conftest import mutate, random_genome

CFG = ChainConfig()


@pytest.fixture(scope="module")
def pairbatch():
    rng = np.random.default_rng(55)
    base = random_genome(rng, 40_000)
    genomes = [base, mutate(rng, base, 0.01)]
    params = SketchParams()
    sk = [sketch_genome_device(f"g{i}", [g], params, length_bucket=1 << 16,
                               seed_budget=1024, marker_budget=512)
          for i, g in enumerate(genomes)]
    return stack_sketches(sk)


def test_anchor_pool_overflow_reported(pairbatch):
    budgets = EngineBudgets(max_anchors=4096, max_fragments=128,
                            max_anchors_per_fragment=128)
    import jax

    refs = jax.tree.map(lambda x: x[:1], pairbatch)
    queries = jax.tree.map(lambda x: x[1:], pairbatch)
    # a related 40 kb pair shares ~300 seeds; a 128-anchor pool clips
    out = chain_block(refs, queries, cfg=CFG, budgets=budgets,
                      total_anchors=128)
    assert bool(np.asarray(out["anchors_overflow"]).any())
    with pytest.warns(RuntimeWarning, match="anchor budget overflow"):
        check_overflow(out, budgets)
    with pytest.raises(RuntimeError, match="anchor budget overflow"):
        check_overflow(out, budgets, raise_on_overflow=True)
    # an adequate pool does not warn
    ok = chain_block(refs, queries, cfg=CFG, budgets=budgets,
                     total_anchors=8192)
    assert not bool(np.asarray(ok["anchors_overflow"]).any())
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        check_overflow(ok, budgets)


def test_chain_table_overflow_reported(pairbatch):
    budgets = EngineBudgets(max_anchors=4096, max_fragments=128,
                            max_anchors_per_fragment=128,
                            max_chains_per_pair=1)
    out = chain_triangle(pairbatch, cfg=CFG, budgets=budgets,
                         total_anchors=8192)
    assert int(np.asarray(out["n_chains"]).max()) > 1
    with pytest.warns(RuntimeWarning, match="chain table overflow"):
        check_overflow(out, budgets)


def test_pos_overflow_raises():
    """pos_overflow (contig > 2^24 bp in the packed block grid) is a
    hard error, not a warning — results for such pairs are wrong."""
    from pyskani_tpu.ops.chain import EngineBudgets

    out = {"pos_overflow": np.array([True]),
           "n_chains": np.array([1])}
    with pytest.raises(RuntimeError, match="contig coordinate overflow"):
        check_overflow(out, EngineBudgets())


def test_frag_overflow_raises(pairbatch):
    """Anchors beyond the fragment-grid budget are DROPPED on the
    full-range per-pair path — chain_pairs must report it and
    check_overflow must raise (truncated results), instead of silently
    underestimating ANI/AF (code-review r5 finding)."""
    from pyskani_tpu.engine.batch import take_sketch
    from pyskani_tpu.ops.chain import chain_pairs

    r = take_sketch(pairbatch, np.array([0], np.int32))
    q = take_sketch(pairbatch, np.array([1], np.int32))
    # genomes in this fixture span several fragments; max_fragments=1
    # guarantees real anchors land beyond the grid
    budgets = EngineBudgets(max_anchors=4096, max_fragments=1,
                            max_anchors_per_fragment=128)
    out = chain_pairs(r, q, cfg=CFG, budgets=budgets)
    assert bool(np.asarray(out["frag_overflow"]).any())
    with pytest.raises(RuntimeError, match="fragment budget overflow"):
        check_overflow(out, budgets)
