"""Generate CONFORMANCE.md: ANI abs error across the 80-100% identity range.

BASELINE.md names "ANI abs error vs skani" a north-star metric, but only
one real genome pair can be validated offline (the vendored E. coli
golden pair).  This script widens the net with DERIVED real-genome
fixtures: slices of the vendored E. coli EC590
genome are mutated with uniform random substitutions at known rates, so
each pair has an ORACLE-INDEPENDENT expected ANI — the realized
per-base identity (1 - hamming/len), which the skani method estimates
via k-mer survival ((1-r)^k)^(1/k) = 1-r.

Run on CPU:  python scripts/run_conformance.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

import pyskani_tpu
from pyskani_tpu.io.fasta import parse

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "data")
ACGT = np.frombuffer(b"ACGT", np.uint8)

SLICE_LEN = 600_000
N_SLICES = 4
RATES = [0.0, 0.01, 0.02, 0.05, 0.08, 0.12, 0.16, 0.20]


def mutate_subs(rng, arr, rate):
    """Uniform substitutions at ``rate`` positions (draws may repeat a
    base — the REALIZED identity is measured afterwards)."""
    out = arr.copy()
    n = int(len(arr) * rate)
    if n:
        idx = rng.integers(0, len(arr), n)
        out[idx] = rng.choice(ACGT, size=n)
    return out


def main():
    ec = np.frombuffer(
        next(iter(parse(os.path.join(DATA, "e.coli-EC590.fasta.gz")))).seq,
        np.uint8)
    rng = np.random.default_rng(20260821)
    slices = [ec[i * SLICE_LEN:(i + 1) * SLICE_LEN].copy()
              for i in range(N_SLICES)]

    rows = []
    t0 = time.time()
    for si, sl in enumerate(slices):
        db = pyskani_tpu.Database()
        db.sketch(f"slice{si}", sl.tobytes())
        for rate in RATES:
            q = mutate_subs(rng, sl, rate)
            realized = 1.0 - float(np.mean(q != sl))
            hits = db.query(f"m{rate}", q.tobytes(), learned_ani=False,
                            cutoff=0.01)
            if hits:
                ani = hits[0].identity
                afq = hits[0].query_fraction
            else:
                ani, afq = float("nan"), 0.0
            rows.append((si, rate, realized, ani, afq,
                         ani - realized if hits else float("nan")))
            print(f"slice{si} rate={rate:.2f} expected={realized:.4f} "
                  f"ani={ani:.4f} err={ani - realized:+.4f} af_q={afq:.3f}",
                  file=sys.stderr)
    dt = time.time() - t0

    hi = [r for r in rows if r[2] >= 0.90]
    lo = [r for r in rows if r[2] < 0.90]
    max_hi = max(abs(r[5]) for r in hi)
    max_lo = max(abs(r[5]) for r in lo if not np.isnan(r[5]))

    with open(os.path.join(os.path.dirname(DATA), "..",
                           "CONFORMANCE.md"), "w") as f:
        f.write(
            "# CONFORMANCE — ANI abs error across the identity range\n\n"
            "Derived real-genome fixtures: 600 kb slices of the vendored\n"
            "E. coli EC590 genome, mutated with uniform random\n"
            "substitutions at known rates (seed 20260821,\n"
            "scripts/run_conformance.py).  Expected ANI is the REALIZED\n"
            "per-base identity of each pair — an oracle-independent\n"
            "analytic target (the FracMinHash estimator measures k-mer\n"
            f"survival^(1/k) = per-base identity).  {len(rows)} pairs,\n"
            "engine `learned_ani=False` (raw estimator), defaults\n"
            "c=125 / k=15.\n\n"
            "| slice | sub rate | expected ANI | engine ANI | error | "
            "AF query |\n|---|---|---|---|---|---|\n")
        for si, rate, realized, ani, afq, err in rows:
            f.write(f"| {si} | {rate:.2f} | {realized:.4f} | {ani:.4f} | "
                    f"{err:+.4f} | {afq:.3f} |\n")
        f.write(
            f"\n**Max abs error: {max_hi:.4f} at >= 90% identity; "
            f"{max_lo:.4f} over 80-90%** (the skani method is documented\n"
            "for the >= ~82% range; accuracy degrades as anchors thin\n"
            "out below ~88%).  The five golden E. coli values\n"
            "additionally pin the real-pair contract to 4 decimals\n"
            "(tests/test_ani.py).  tests/test_conformance.py re-checks a\n"
            "subset of this grid in CI.\n")
    print(f"wrote CONFORMANCE.md ({len(rows)} pairs, {dt:.0f}s); "
          f"max|err| >=0.90: {max_hi:.4f}, 0.80-0.90: {max_lo:.4f}")


if __name__ == "__main__":
    main()
