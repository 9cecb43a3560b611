"""Device sketching vs the NumPy oracle: exact equality of seed tables."""

import numpy as np
import pytest

from pyskani_tpu.oracle import seeding as oracle
from pyskani_tpu.ops.sketch import sketch_genome_device
from pyskani_tpu.params import SketchParams

from conftest import random_genome


def _check(contigs, params=SketchParams()):
    name = "g"
    osk = oracle.sketch_genome(name, contigs, params)
    dsk = sketch_genome_device(name, contigs, params).device

    n = int(dsk.n_seeds)
    assert n == len(osk.kmers), (n, len(osk.kmers))
    np.testing.assert_array_equal(np.asarray(dsk.kmers[:n], np.uint64),
                                  osk.kmers & np.uint64(0xFFFFFFFF))
    np.testing.assert_array_equal(np.asarray(dsk.positions[:n]), osk.positions)
    np.testing.assert_array_equal(np.asarray(dsk.contig_ids[:n]), osk.contig_ids)
    np.testing.assert_array_equal(np.asarray(dsk.strands[:n]), osk.strands)

    m = int(dsk.n_markers)
    assert m == len(osk.markers), (m, len(osk.markers))
    got = (np.asarray(dsk.markers_hi[:m], np.uint64) << np.uint64(32)) | \
        np.asarray(dsk.markers_lo[:m], np.uint64)
    np.testing.assert_array_equal(got, osk.markers)

    assert int(dsk.total_len) == osk.total_sequence_length
    assert int(dsk.n_contigs) == len(osk.contigs)


def test_single_contig_random():
    rng = np.random.default_rng(0)
    _check([random_genome(rng, 50_000)])


def test_multi_contig():
    rng = np.random.default_rng(1)
    contigs = [random_genome(rng, 20_000), random_genome(rng, 7_000),
               b"ACGT" * 10,  # below MIN_LENGTH_CONTIG -> skipped
               random_genome(rng, 3_000)]
    _check(contigs)


def test_lowercase_and_n():
    rng = np.random.default_rng(2)
    g = bytearray(random_genome(rng, 30_000))
    g[100:200] = b"n" * 100
    g[5000:5100] = random_genome(rng, 100).lower()
    _check([bytes(g)])


@pytest.mark.slow
def test_ecoli(ecoli_k12):
    _check([ecoli_k12])


def test_batched_sketch_matches_single():
    """sketch_genomes_device (vmapped, one dispatch per stack) must equal
    the per-genome path exactly."""
    import numpy as np

    from pyskani_tpu.ops.sketch import (sketch_genome_device,
                                        sketch_genomes_device)
    from pyskani_tpu.params import SketchParams

    rng = np.random.default_rng(21)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genomes = []
    for i in range(3):
        n = int(rng.integers(30000, 60000))
        genomes.append((f"g{i}", [rng.choice(acgt, size=n).tobytes()]))
    params = SketchParams()

    batched = sketch_genomes_device(genomes, params, device_batch=2)
    for (name, contigs), got in zip(genomes, batched):
        # same budgets as the batched group for array-exact comparison
        want = sketch_genome_device(
            name, contigs, params,
            seed_budget=got.device.seed_budget,
            marker_budget=got.device.marker_budget)
        assert got.name == want.name
        assert int(got.device.n_seeds) == int(want.device.n_seeds)
        n = int(want.device.n_seeds)
        np.testing.assert_array_equal(np.asarray(got.device.kmers[:n]),
                                      np.asarray(want.device.kmers[:n]))
        np.testing.assert_array_equal(np.asarray(got.device.positions[:n]),
                                      np.asarray(want.device.positions[:n]))
        m = int(want.device.n_markers)
        assert int(got.device.n_markers) == m
        np.testing.assert_array_equal(np.asarray(got.device.markers_lo[:m]),
                                      np.asarray(want.device.markers_lo[:m]))


def test_sketch_many_groups_by_size():
    """Mixed-size batches stack near-homogeneous groups: a large genome must
    not inflate the small genomes' padded budgets, and input order is
    restored on return."""
    from pyskani_tpu.ops.sketch import (seed_budget_for,
                                        sketch_genomes_device)

    rng = np.random.default_rng(9)
    genomes = [
        ("big0", [random_genome(rng, 2_300_000)]),
        ("small0", [random_genome(rng, 120_000)]),
        ("big1", [random_genome(rng, 2_200_000)]),
        ("small1", [random_genome(rng, 130_000)]),
    ]
    params = SketchParams()
    out = sketch_genomes_device(genomes, params, device_batch=2)
    assert [s.name for s in out] == [n for n, _ in genomes]
    by_name = {s.name: s for s in out}
    # the smalls grouped together: their budgets are sized from the
    # larger SMALL genome, far below the big genomes' budgets
    assert by_name["small0"].device.seed_budget == \
        by_name["small1"].device.seed_budget
    assert by_name["small0"].device.seed_budget <= \
        seed_budget_for(130_000, params.c)
    assert by_name["big0"].device.seed_budget >= \
        seed_budget_for(2_200_000, params.c)
    # and the padded sequence length followed suit: budgets imply it
    assert by_name["small0"].device.seed_budget < \
        by_name["big0"].device.seed_budget // 4
