"""Test configuration: force CPU with 8 virtual devices so multi-device
sharding paths are exercised without a GPU (SURVEY.md §4)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gzip
import functools

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@functools.lru_cache(maxsize=None)
def _genome(filename: str) -> bytes:
    from pyskani_tpu.io.fasta import parse
    path = os.path.join(DATA, filename)
    return next(iter(parse(path))).seq


@pytest.fixture(scope="session")
def ecoli_k12() -> bytes:
    return _genome("e.coli-K12.fasta.gz")


@pytest.fixture(scope="session")
def ecoli_ec590() -> bytes:
    return _genome("e.coli-EC590.fasta.gz")


def random_genome(rng: np.random.Generator, length: int) -> bytes:
    return rng.choice(np.frombuffer(b"ACGT", np.uint8), size=length).tobytes()


def mutate(rng: np.random.Generator, genome: bytes, sub_rate: float = 0.02,
           indel_rate: float = 0.001) -> bytes:
    """Apply random substitutions and short indels (test-data helper)."""
    arr = np.frombuffer(genome, np.uint8).copy()
    nsub = int(len(arr) * sub_rate)
    idx = rng.integers(0, len(arr), nsub)
    arr[idx] = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=nsub)
    out = []
    prev = 0
    for cut in sorted(rng.integers(0, len(arr), int(len(arr) * indel_rate))):
        out.append(arr[prev:cut].tobytes())
        if rng.random() < 0.5:
            out.append(random_genome(rng, int(rng.integers(1, 30))))
        else:
            cut = min(cut + int(rng.integers(1, 30)), len(arr))
        prev = cut
    out.append(arr[prev:].tobytes())
    return b"".join(out)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables + tracing caches after each module.

    The suite compiles hundreds of XLA:CPU programs in one process;
    without this, accumulated compiler/executable state occasionally
    segfaults LLVM mid-compile late in the run (observed twice in
    test_params_api after ~110 green tests — never reproducible in
    isolation).  Costs a few re-compiles for the handful of shapes
    shared across modules.
    """
    yield
    import jax

    jax.clear_caches()
