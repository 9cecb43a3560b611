"""Learned-ANI (GBDT) regression: bundled model + inference machinery.

The reference loads skani's MAG-trained GBDT via regression::get_model
(/root/reference/src/pyskani/_skani/lib.rs:611-614).  This build bundles
a model RETRAINED on synthetic pairs with exactly-known ANI
(scripts/train_learned_ani.py); these tests pin the weight-file contract
and the behavioral rules around when the correction applies.
"""

import numpy as np
import pytest

from pyskani_tpu import regression
from pyskani_tpu.params import use_learned_ani


def test_bundled_model_loads():
    model = regression.get_model(125, True)
    assert model is not None
    assert model.features == ["ani", "af_query", "af_ref"]
    assert model.feature.ndim == 2 and model.feature.shape[0] >= 50


def test_model_correction_is_small_and_monotone_neighborhood():
    model = regression.get_model(125, True)
    # the correction is a debiasing step: it must stay close to the raw
    # value across the trained range and preserve coarse ordering
    raw = np.linspace(0.85, 1.0, 16)
    x = np.stack([raw, np.full(16, 0.9), np.full(16, 0.9)], axis=1)
    pred = model.predict(x)
    assert np.all(np.abs(pred - raw) < 0.02)
    assert pred[-1] > pred[0]


def test_get_model_disabled():
    assert regression.get_model(125, False) is None


def test_use_learned_ani_rule():
    # reference rule (lib.rs:524-528): c >= 70 and not median
    assert use_learned_ani(125, False, False, False)
    assert not use_learned_ani(125, False, False, True)   # median
    assert not use_learned_ani(30, False, False, False)   # c < 70


def test_apply_model_identity_without_model():
    assert regression.apply_model(None, 0.95, 0.9, 0.9) == 0.95


# ---- off-anchor validation of the applied correction ----
# apply_model (not raw model.predict) is what Database.query uses; its
# safety rails make it monotone, bounded, and exact at the golden anchor.


def test_applied_correction_monotone_over_range():
    """Corrected ANI is non-decreasing in raw ANI over [0.8, 1.0] for any
    aligned-fraction combination (isotonic knot projection)."""
    model = regression.get_model(125, True)
    for afq in (0.2, 0.5, 0.9):
        for afr in (0.3, 0.7, 1.0):
            raw = np.arange(0.80, 1.0001, 0.0025)
            out = np.array([regression.apply_model(model, a, afq, afr)
                            for a in raw])
            assert np.all(np.diff(out) >= -1e-12), (afq, afr)


def test_applied_correction_delta_bounded():
    """|corrected - raw| <= MAX_LEARNED_DELTA everywhere."""
    model = regression.get_model(125, True)
    raw = np.arange(0.75, 1.0001, 0.005)
    for afq, afr in ((0.2, 0.2), (0.6, 0.9), (1.0, 1.0)):
        out = np.array([regression.apply_model(model, a, afq, afr)
                        for a in raw])
        assert np.all(np.abs(out - raw) <=
                      regression.MAX_LEARNED_DELTA + 1e-9)


def test_applied_correction_fades_below_training_range():
    """Below the model's high-identity training range the raw estimate is
    returned unchanged (trees extrapolate flatly there)."""
    model = regression.get_model(125, True)
    for a in (0.5, 0.7, 0.84):
        assert regression.apply_model(model, a, 0.8, 0.8) == a


def test_second_synthetic_pair_direction(ecoli_k12):
    """A second pair with known identity: the correction must not move
    the estimate AWAY from the truth by more than it could help
    (reference contract test_ani.py:42-47 pins only the anchor; this
    pins behaviour off-anchor)."""
    import pyskani_tpu
    from conftest import mutate

    rng = np.random.default_rng(77)
    # substitutions only (no indels): true ANI is exactly the fraction of
    # unchanged positions (a substitution draws uniformly from ACGT, so
    # ~1/4 of drawn sites keep their base)
    sub = 0.015
    base = ecoli_k12[:1_000_000]
    arr = np.frombuffer(base, np.uint8).copy()
    idx = rng.integers(0, len(arr), int(len(arr) * sub))
    new = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=len(idx))
    changed = np.unique(idx[new != arr[idx]]).size
    arr[idx] = new
    true_ani = 1.0 - changed / len(arr)

    db = pyskani_tpu.Database()
    db.sketch("ref", arr.tobytes())
    raw = db.query("q", base, learned_ani=False)[0].identity
    corrected = db.query("q", base, learned_ani=True)[0].identity
    # the correction is bounded, so the corrected estimate can be at most
    # MAX_LEARNED_DELTA further from the truth than the raw one
    assert abs(corrected - true_ani) <= \
        abs(raw - true_ani) + regression.MAX_LEARNED_DELTA + 1e-9
    # and at this operating point (high identity, like the anchor) it
    # must actually move TOWARD the truth or stay put
    if raw != corrected:
        assert abs(corrected - true_ani) <= abs(raw - true_ani) + 1e-9
