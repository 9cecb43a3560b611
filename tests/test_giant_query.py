"""Full-range coordinate tests: genomes beyond the packed 2^30 bp caps.

The reference has no coordinate limits at all — positions are full-width
GnPosition and genome totals are usize
(/root/reference/src/pyskani/_skani/lib.rs:160) — so multi-Gbp queries must
work.  The packed block/triangle pipelines cap query totals at 2^30 (gq<<2
payload) and the engine routes larger genomes through the full-range
per-pair path; these tests pin that routing and the correctness of the
unpacked coordinate handling, plus the chunked sketching that lets giants
sketch in bounded memory.
"""

import dataclasses

import jax
import numpy as np
import pytest

import pyskani_tpu
import pyskani_tpu.database
from pyskani_tpu.ops.sketch import (HostSketch, contig_budget_for,
                                    sketch_genome_device)
from pyskani_tpu.params import SketchParams

from conftest import random_genome


def test_chunked_sketch_equals_single():
    """A genome above the kernel-call buffer streams through chunked
    calls (including an intra-contig split with valid_floor overlap
    masking) and produces the bit-identical sketch."""
    rng = np.random.default_rng(7)
    contigs = [random_genome(rng, 1_700_000),   # split across 2 calls
               random_genome(rng, 700_000),
               random_genome(rng, 900_000)]
    params = SketchParams()
    a = sketch_genome_device("g", contigs, params)
    b = sketch_genome_device("g", contigs, params, max_buffer=1_000_000)
    da, db_ = jax.device_get([a.device, b.device])
    assert int(da.n_seeds) == int(db_.n_seeds)
    assert int(da.n_markers) == int(db_.n_markers)
    n, m = int(da.n_seeds), int(da.n_markers)
    for f in ("kmers", "positions", "contig_ids", "strands", "own_mult",
              "p_positions", "p_contig_ids", "p_own_mult"):
        np.testing.assert_array_equal(
            np.asarray(getattr(da, f))[:n], np.asarray(getattr(db_, f))[:n],
            err_msg=f)
    for f in ("markers_hi", "markers_lo"):
        np.testing.assert_array_equal(
            np.asarray(getattr(da, f))[:m], np.asarray(getattr(db_, f))[:m],
            err_msg=f)


def _embed_giant(host: HostSketch, pre: int, post: int,
                 pad_len: int) -> HostSketch:
    """Fabricate a giant multi-contig genome: ``host``'s contigs (with
    their seeds) placed after ``pre`` fat seedless contigs of
    ``pad_len`` bp, followed by ``post`` more.  Seeds/markers are
    host's; only contig ids shift — the engine never reads sequence."""
    dev = jax.device_get(host.device)
    nc = int(dev.n_contigs)
    total_c = pre + nc + post
    cb = contig_budget_for(total_c)
    clens = np.zeros(cb, np.int32)
    clens[:pre] = pad_len
    clens[pre:pre + nc] = np.asarray(dev.contig_lengths)[:nc]
    clens[pre + nc:pre + nc + post] = pad_len
    n = int(dev.n_seeds)
    shift = lambda a: np.where(np.arange(len(a)) < n,
                               np.asarray(a) + pre, np.asarray(a))
    lengths = [pad_len] * pre + list(host.lengths) + [pad_len] * post
    total = sum(lengths)
    dev2 = dataclasses.replace(
        dev,
        contig_ids=shift(dev.contig_ids).astype(np.int32),
        p_contig_ids=shift(dev.p_contig_ids).astype(np.int32),
        contig_lengths=clens,
        n_contigs=np.int32(total_c),
        total_len=np.uint32(min(total, 2**32 - 1)),
    )
    names = ([f"pad_{i}" for i in range(pre)] + host.contig_names +
             [f"pad_{pre + i}" for i in range(post)])
    return HostSketch(name=host.name, contig_names=names, device=dev2,
                      lengths=lengths)


def test_giant_total_query_routes_and_matches(ecoli_ec590, ecoli_k12,
                                              monkeypatch):
    """A >=2.2 Gbp multi-contig query goes through Database.query (no
    raise), routes onto the full-range per-pair path, and returns the
    same hit as the ordinary-size control (AF rescaled by the total)."""
    db = pyskani_tpu.Database()
    db.sketch("EC590", ecoli_ec590)
    # coarser fragments keep the giant's fragment grid test-sized; the
    # control uses the identical config so the comparison is exact
    db._chain_cfg = dataclasses.replace(db._chain_cfg,
                                        fragment_length=200_000)

    control = db.query("K12", ecoli_k12, learned_ani=False)
    assert len(control) == 1

    k12 = sketch_genome_device("K12", [ecoli_k12], SketchParams())
    giant = _embed_giant(k12, pre=30, post=10, pad_len=56_000_000)
    assert giant.total_len >= 2_200_000_000 > (1 << 30)

    monkeypatch.setattr(pyskani_tpu.database, "sketch_genome_device",
                        lambda *a, **k: giant)
    hits = db.query("K12giant", b"A" * 600, learned_ani=False)
    assert len(hits) == 1
    h, c = hits[0], control[0]
    assert abs(h.identity - c.identity) < 2e-6
    assert abs(h.reference_fraction - c.reference_fraction) < 2e-6
    scale = k12.total_len / giant.total_len
    assert h.query_fraction == pytest.approx(c.query_fraction * scale,
                                             rel=1e-5)


def test_contig_positions_beyond_2pow30(ecoli_ec590, ecoli_k12):
    """In-contig coordinates above 2^30 (possible on the full-range path
    only) chain identically to the unshifted control: the old POS_BIG
    min-sentinels would have shadowed such positions."""
    from pyskani_tpu.ops.chain import EngineBudgets, chain_pair
    from pyskani_tpu.oracle.chain import ChainConfig

    params = SketchParams()
    ref = sketch_genome_device("EC590", [ecoli_ec590], params)
    query = sketch_genome_device("K12", [ecoli_k12], params)

    SHIFT = 1_500_000_000              # multiple of fragment_length below
    rdev = jax.device_get(ref.device)
    n = int(rdev.n_seeds)
    mask = np.arange(rdev.positions.shape[0]) < n
    clens = np.asarray(rdev.contig_lengths).copy()
    clens[0] += SHIFT
    rdev_shift = dataclasses.replace(
        rdev,
        positions=np.where(mask, np.asarray(rdev.positions) + SHIFT,
                           np.asarray(rdev.positions)).astype(np.int32),
        p_positions=np.where(mask, np.asarray(rdev.p_positions) + SHIFT,
                             np.asarray(rdev.p_positions)).astype(np.int32),
        contig_lengths=clens,
        total_len=np.uint32(int(rdev.total_len) + SHIFT),
    )

    cfg = dataclasses.replace(ChainConfig(), k=params.k,
                              extend_right=params.k - 1,
                              fragment_length=2_000_000)
    budgets = EngineBudgets(max_fragments=1024,
                            max_anchors_per_fragment=256)
    out0 = jax.device_get(chain_pair(rdev, query.device, cfg=cfg,
                                     budgets=budgets))
    out1 = jax.device_get(chain_pair(rdev_shift, query.device, cfg=cfg,
                                     budgets=budgets))
    # coarse 2 Mbp fragments dilute the mean (span denominators cover
    # unaligned stretches) — the point here is shift-invariance, the
    # sanity bar just confirms the pair really chained
    assert float(out0["ani_mean"]) > 0.8
    for key in ("ani_mean", "ani_robust", "ani_median", "af_query"):
        assert abs(float(out0[key]) - float(out1[key])) < 1e-6, key
    scale = int(rdev.total_len) / (int(rdev.total_len) + SHIFT)
    assert float(out1["af_ref"]) == pytest.approx(
        float(out0["af_ref"]) * scale, rel=1e-5)


def test_triangle_giant_total_reroutes(ecoli_ec590, ecoli_k12):
    """engine.batch.triangle with a genome >= 2^30 bp total reroutes its
    pairs through the per-pair pipeline instead of raising."""
    from pyskani_tpu.engine.batch import triangle
    from pyskani_tpu.oracle.chain import ChainConfig

    params = SketchParams()
    ec = sketch_genome_device("EC590", [ecoli_ec590], params)
    k12 = sketch_genome_device("K12", [ecoli_k12], params)
    giant = _embed_giant(k12, pre=2, post=0, pad_len=540_000_000)
    assert giant.total_len >= (1 << 30)

    cfg = dataclasses.replace(ChainConfig(), k=params.k,
                              extend_right=params.k - 1,
                              fragment_length=2_000_000)
    ri, qi, out = triangle([ec, giant], cfg)
    assert len(ri) == 1
    # control: the same pair at ordinary size
    ri2, qi2, out2 = triangle([ec, k12], cfg)
    assert abs(float(out["ani_mean"][0]) -
               float(out2["ani_mean"][0])) < 2e-6
    scale = k12.total_len / giant.total_len
    assert float(out["af_query"][0]) == pytest.approx(
        float(out2["af_query"][0]) * scale, rel=1e-5)
