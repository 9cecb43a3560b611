"""Mesh-parallel all-vs-all triangle == single-device triangle.

BASELINE.md measures the all-vs-all headline metric at 1 chip / 1 host /
>= 2 hosts; parallel.dist.sharded_triangle is that scaling path.  Every
tile runs the same chain_block program, so results must be IDENTICAL
across mesh shapes.
"""

import numpy as np
import pytest

from conftest import mutate, random_genome
from pyskani_tpu.engine.batch import stack_sketches, triangle
from pyskani_tpu.oracle.chain import ChainConfig
from pyskani_tpu.ops.chain import EngineBudgets
from pyskani_tpu.ops.sketch import sketch_genome_device
from pyskani_tpu.parallel.dist import sharded_triangle
from pyskani_tpu.parallel.mesh import make_mesh
from pyskani_tpu.params import SketchParams

CFG = ChainConfig()
BUDGETS = EngineBudgets(max_anchors=2048, max_fragments=64,
                        max_anchors_per_fragment=128)


@pytest.fixture(scope="module")
def family32():
    rng = np.random.default_rng(13)
    base = random_genome(rng, 20_000)
    params = SketchParams()
    sketches = []
    for i in range(32):
        g = mutate(rng, base, 0.01 + 0.001 * (i % 7)) if i % 5 else \
            random_genome(rng, 20_000)
        sketches.append(sketch_genome_device(
            f"g{i}", [g], params, seed_budget=512, marker_budget=512,
            length_bucket=1 << 15))
    return sketches


@pytest.mark.parametrize("mesh_shape", [(8, 1), (2, 4)])
def test_sharded_triangle_matches_single_device(family32, mesh_shape):
    batch = stack_sketches(family32)
    ri0, qi0, single = triangle(family32, CFG, BUDGETS, block=4, group=8,
                                anchors_per_pair=2048)
    mesh = make_mesh(db=mesh_shape[0], batch=mesh_shape[1])
    ri, qi, out = sharded_triangle(batch, mesh, cfg=CFG, budgets=BUDGETS,
                                   block=4, anchors_per_pair=2048)
    assert len(ri) == 32 * 31 // 2
    np.testing.assert_array_equal(ri, ri0)
    np.testing.assert_array_equal(qi, qi0)
    for key in ("ani_mean", "ani_robust", "ani_median", "af_query",
                "af_ref"):
        np.testing.assert_allclose(out[key], single[key], rtol=0,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("n", [32, 29])
def test_ring_triangle_matches_single_device(family32, n):
    """Sharded-memory ring all-vs-all (ppermute block rotation) equals
    the single-device triangle bit-for-bit, including ragged G that
    pads the last block."""
    from pyskani_tpu.parallel.dist import ring_triangle

    sketches = family32[:n]
    batch = stack_sketches(sketches)
    ri0, qi0, single = triangle(sketches, CFG, BUDGETS, block=4, group=8,
                                anchors_per_pair=2048)
    mesh = make_mesh(db=4, batch=2)
    ri, qi, out = ring_triangle(batch, mesh, cfg=CFG, budgets=BUDGETS,
                                anchors_per_pair=2048)
    assert len(ri) == n * (n - 1) // 2
    np.testing.assert_array_equal(ri, ri0)
    np.testing.assert_array_equal(qi, qi0)
    for key in ("ani_mean", "ani_robust", "ani_median", "af_query",
                "af_ref"):
        np.testing.assert_allclose(out[key], single[key], rtol=0,
                                   atol=1e-6, err_msg=key)


def test_sharded_triangle_with_giant_genome(family32):
    """A genome beyond the packed range (here: total >= 2^30 bp) no
    longer raises on the mesh paths: its pairs reroute through the
    full-range per-pair pipeline and merge with the mesh tiles,
    matching the single-device triangle."""
    import dataclasses

    import jax
    from pyskani_tpu.ops.sketch import HostSketch
    from pyskani_tpu.parallel.dist import ring_triangle

    sketches = list(family32[:8])
    # fabricate a giant-total genome from sketch 0: two fat seedless
    # contigs push the total over 2^30 while seeds stay test-sized
    dev = jax.device_get(sketches[0].device)
    nc = int(dev.n_contigs)
    pad_len = 550_000_000
    clens = np.zeros(8, np.int32)
    clens[:nc] = np.asarray(dev.contig_lengths)[:nc]
    clens[nc:nc + 2] = pad_len
    lengths = list(sketches[0].lengths) + [pad_len, pad_len]
    dev2 = dataclasses.replace(
        dev, contig_lengths=clens, n_contigs=np.int32(nc + 2),
        total_len=np.uint32(sum(lengths)))
    sketches[0] = HostSketch(name="giant",
                             contig_names=sketches[0].contig_names,
                             device=dev2, lengths=lengths)
    assert sketches[0].total_len >= (1 << 30)

    batch = stack_sketches(sketches)
    ri0, qi0, single = triangle(sketches, CFG, BUDGETS, block=4, group=8,
                                anchors_per_pair=2048)
    mesh = make_mesh(db=4, batch=2)
    for fn in (sharded_triangle, ring_triangle):
        ri, qi, out = fn(batch, mesh, cfg=CFG, budgets=BUDGETS,
                         anchors_per_pair=2048)
        assert len(ri) == 8 * 7 // 2
        np.testing.assert_array_equal(ri, ri0)
        for key in ("ani_mean", "ani_robust", "ani_median", "af_query",
                    "af_ref"):
            np.testing.assert_allclose(out[key], single[key], rtol=0,
                                       atol=1e-6, err_msg=f"{key} {fn}")
