"""Config honesty: every ChainConfig accepted by _check_supported must
produce identical results on the per-pair and block pipelines, and
rejected configs must be rejected up front on BOTH (denom_mode="fragment"
used to pass validation, then raise at runtime on one path while
silently computing span semantics on the other)."""

import dataclasses

import numpy as np
import pytest

from conftest import mutate, random_genome
from pyskani_tpu.engine.batch import stack_sketches, take_sketch
from pyskani_tpu.oracle.chain import ChainConfig
from pyskani_tpu.ops.chain import (EngineBudgets, chain_block, chain_pairs)
from pyskani_tpu.ops.sketch import sketch_genome_device
from pyskani_tpu.params import SketchParams


@pytest.fixture(scope="module")
def pair_batch():
    rng = np.random.default_rng(11)
    base = random_genome(rng, 400_000)
    sketches = [
        sketch_genome_device("a", [base], SketchParams()),
        sketch_genome_device("b", [mutate(rng, base, 0.03)], SketchParams()),
    ]
    return stack_sketches(sketches)


# the accepted surface of _check_supported, axis by axis
ACCEPTED_VARIANTS = [
    {},
    {"chain_group_side": "query"},
    {"est_side": "chunk"},
    {"est_ci": True},
    {"mask_repetitive_denom": "none"},
]

REJECTED = [
    {"denom_mode": "fragment"},
    {"denom_mode": "length"},
    {"nonoverlap_side": "ref"},
    {"sort_by": "query"},
    {"numer_mode": "distinct"},
    {"chain_scope": "global"},
    {"span_source": "all"},
    {"est_side": "other"},
    {"min_span_cover": 0.5},
]


@pytest.mark.parametrize("overrides", ACCEPTED_VARIANTS,
                         ids=[str(sorted(v)) for v in ACCEPTED_VARIANTS])
def test_accepted_config_block_equals_pairs(pair_batch, overrides):
    cfg = dataclasses.replace(ChainConfig(), **overrides)
    budgets = EngineBudgets(max_fragments=128,
                            max_anchors_per_fragment=256)
    r = take_sketch(pair_batch, np.array([0], np.int32))
    q = take_sketch(pair_batch, np.array([1], np.int32))
    pp = chain_pairs(r, q, cfg=cfg, budgets=budgets)
    bb = chain_block(r, q, cfg=cfg, budgets=budgets)
    for key in ("ani_mean", "ani_robust", "ani_median", "af_query",
                "af_ref", "n_fragments"):
        np.testing.assert_allclose(
            np.asarray(pp[key])[0], np.asarray(bb[key])[0, 0],
            rtol=0, atol=1e-6, err_msg=f"{key} for {overrides}")


@pytest.mark.parametrize("overrides", REJECTED,
                         ids=[str(sorted(v.items())) for v in REJECTED])
def test_rejected_config_raises_on_both_paths(pair_batch, overrides):
    cfg = dataclasses.replace(ChainConfig(), **overrides)
    budgets = EngineBudgets(max_fragments=128,
                            max_anchors_per_fragment=256)
    r = take_sketch(pair_batch, np.array([0], np.int32))
    q = take_sketch(pair_batch, np.array([1], np.int32))
    with pytest.raises(NotImplementedError):
        chain_pairs(r, q, cfg=cfg, budgets=budgets)
    with pytest.raises(NotImplementedError):
        chain_block(r, q, cfg=cfg, budgets=budgets)
