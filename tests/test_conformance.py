"""ANI abs-error conformance across the 80-100% identity range.

CI subset of scripts/run_conformance.py (which writes the full 32-pair
CONFORMANCE.md table): derived real-genome fixtures — slices of the
vendored E. coli EC590 mutated at known substitution rates — give each
pair an oracle-independent expected ANI (the realized per-base
identity), widening the accuracy net beyond the single golden pair
(BASELINE.md north-star "ANI abs error").
"""

import numpy as np
import pytest

import pyskani_tpu
from pyskani_tpu.oracle import seeding as oseed
from pyskani_tpu.oracle.chain import chain_seeds
from pyskani_tpu.params import SketchParams

ACGT = np.frombuffer(b"ACGT", np.uint8)
SLICE_LEN = 600_000


def _mutate_subs(rng, arr, rate):
    out = arr.copy()
    n = int(len(arr) * rate)
    if n:
        idx = rng.integers(0, len(arr), n)
        out[idx] = rng.choice(ACGT, size=n)
    return out


@pytest.fixture(scope="module")
def slices(ecoli_ec590):
    ec = np.frombuffer(ecoli_ec590, np.uint8)
    return [ec[i * SLICE_LEN:(i + 1) * SLICE_LEN].copy() for i in (0, 2)]


@pytest.mark.parametrize("rate,tol", [
    (0.01, 0.004), (0.05, 0.008), (0.12, 0.010), (0.20, 0.012),
])
def test_ani_abs_error_vs_substitution_process(slices, rate, tol):
    """Engine ANI within a documented tolerance of the analytic
    substitution-process expectation (full grid: CONFORMANCE.md —
    max |err| 0.0063 at >= 90% identity, 0.0089 over 80-90%)."""
    rng = np.random.default_rng(int(rate * 1000) + 17)
    for si, sl in enumerate(slices):
        q = _mutate_subs(rng, sl, rate)
        realized = 1.0 - float(np.mean(q != sl))
        db = pyskani_tpu.Database()
        db.sketch("s", sl.tobytes())
        hits = db.query("q", q.tobytes(), learned_ani=False, cutoff=0.01)
        assert len(hits) == 1, f"slice {si} rate {rate}: no hit"
        err = hits[0].identity - realized
        assert abs(err) < tol, \
            f"slice {si} rate {rate}: ani={hits[0].identity:.4f} " \
            f"expected={realized:.4f} err={err:+.4f}"


def test_engine_equals_oracle_on_derived_fixture(slices):
    """Engine == NumPy oracle on a real-genome-derived 12%-mutated pair
    (method fidelity beyond the synthetic-random fixtures)."""
    from pyskani_tpu.oracle.chain import ChainConfig
    from pyskani_tpu.ops.chain import EngineBudgets, chain_pair
    from pyskani_tpu.ops.sketch import sketch_genome_device

    rng = np.random.default_rng(3)
    sl = slices[0]
    q = _mutate_subs(rng, sl, 0.12)
    params = SketchParams()
    cfg = ChainConfig()

    r_o = oseed.sketch_genome("ref", [sl.tobytes()], params)
    q_o = oseed.sketch_genome("query", [q.tobytes()], params)
    oracle = chain_seeds(r_o, q_o, cfg)

    budgets = EngineBudgets(max_anchors=16384, max_fragments=64,
                            max_anchors_per_fragment=512)
    r_d = sketch_genome_device("ref", [sl.tobytes()], params)
    q_d = sketch_genome_device("query", [q.tobytes()], params)
    out = chain_pair(r_d.device, q_d.device, cfg=cfg, budgets=budgets)

    fa = oracle.fragment_anis
    assert fa is not None and len(fa)
    np.testing.assert_allclose(float(out["ani_mean"]), fa.mean(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(out["af_query"]),
                               oracle.align_fraction_query,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(out["af_ref"]),
                               oracle.align_fraction_ref,
                               rtol=0, atol=1e-6)
