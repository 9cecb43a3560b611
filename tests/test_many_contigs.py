"""Arbitrary contig counts + giant-contig fallback.

The reference sketches any number of contigs (lib.rs:155-173 loops a
Vec) and uses full-width positions (GnPosition, lib.rs:160).  These
tests pin the device engine's equivalents: dynamically-sized contig-table
buckets (ops.sketch.contig_budget_for), the dynamic rcid bit split of
the packed block grid (ops.chain.rcid_bits_for), and Database.query's
automatic rerouting of out-of-range references through the full-range
per-pair path.
"""

import dataclasses

import numpy as np
import pytest

from conftest import mutate, random_genome
import pyskani_tpu
from pyskani_tpu.engine.batch import stack_sketches, take_sketch
from pyskani_tpu.oracle.chain import ChainConfig
from pyskani_tpu.ops.chain import (EngineBudgets, chain_block, chain_pair,
                                   rcid_bits_for)
from pyskani_tpu.ops.sketch import (MAX_CONTIGS_HARD, contig_budget_for,
                                    sketch_genome_device)
from pyskani_tpu.params import SketchParams


def split_contigs(genome: bytes, n: int):
    """Cut a genome into n roughly-equal contigs."""
    step = -(-len(genome) // n)
    return [genome[i:i + step] for i in range(0, len(genome), step)]


def test_contig_budget_buckets():
    assert contig_budget_for(0) == 8
    assert contig_budget_for(8) == 8
    assert contig_budget_for(9) == 16
    assert contig_budget_for(300) == 512
    assert contig_budget_for(MAX_CONTIGS_HARD) == MAX_CONTIGS_HARD
    with pytest.raises(ValueError, match="hard limit"):
        contig_budget_for(MAX_CONTIGS_HARD + 1)


def test_rcid_bits_split():
    # single-contig isolates leave almost the full word to the position
    assert rcid_bits_for(8) == 3
    assert rcid_bits_for(256) == 8
    assert rcid_bits_for(512) == 9
    assert rcid_bits_for(16384) == 14


def test_explicit_max_contigs_guard():
    rng = np.random.default_rng(0)
    contigs = [random_genome(rng, 200) for _ in range(9)]
    with pytest.raises(ValueError, match="more than"):
        sketch_genome_device("g", contigs, SketchParams(), max_contigs=4)


def test_300_contig_draft_query():
    """Crash repro: an ordinary 300-contig draft assembly
    must sketch and be findable (previously IndexError at sketch)."""
    rng = np.random.default_rng(7)
    base = random_genome(rng, 600_000)
    draft = split_contigs(base, 300)
    assert len(draft) == 300
    db = pyskani_tpu.Database()
    db.sketch("draft", *draft)
    hits = db.query("q", mutate(rng, base, 0.01))
    assert len(hits) == 1
    assert hits[0].reference_name == "draft"
    assert hits[0].identity > 0.95
    assert hits[0].query_fraction > 0.5


@pytest.fixture(scope="module")
def many_contig_stack():
    rng = np.random.default_rng(11)
    base = random_genome(rng, 400_000)
    params = SketchParams()
    genomes = [
        ("whole", [base]),
        ("draft300", split_contigs(mutate(rng, base, 0.01), 300)),
        ("mut", [mutate(rng, base, 0.03)]),
    ]
    sketches = [sketch_genome_device(n, c, params, seed_budget=8192,
                                     marker_budget=512,
                                     length_bucket=1 << 18)
                for n, c in genomes]
    return stack_sketches(sketches)


def test_block_matches_pairwise_beyond_256_contigs(many_contig_stack):
    """Packed block grid with rcid_bits > 8 must equal the per-pair path."""
    assert many_contig_stack.contig_lengths.shape[1] == 512
    cfg = ChainConfig()
    budgets = EngineBudgets(max_anchors=16384, max_fragments=384,
                            max_anchors_per_fragment=256)
    out = chain_block(many_contig_stack, many_contig_stack, cfg=cfg,
                      budgets=budgets)
    n = many_contig_stack.kmers.shape[0]
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            single = chain_pair(take_sketch(many_contig_stack, i),
                                take_sketch(many_contig_stack, j),
                                cfg=cfg, budgets=budgets)
            for key in ("ani_mean", "ani_robust", "ani_median",
                        "af_query", "af_ref"):
                np.testing.assert_allclose(
                    np.asarray(out[key])[i, j], np.asarray(single[key]),
                    rtol=0, atol=1e-6, err_msg=f"{key} pair ({i},{j})")
    assert not bool(np.asarray(out["pos_overflow"]).any())


def test_split_vs_whole_ecoli(ecoli_k12, ecoli_ec590):
    """A 1,000-contig split of E. coli K-12 must query like the
    single-contig genome.
    Values differ only by the k-mer windows lost at the 999 cut points
    (~0.3% of seeds), so ANI/AF agree tightly but not bit-exactly."""
    db = pyskani_tpu.Database()
    db.sketch("EC590", ecoli_ec590)
    whole = db.query("K12", ecoli_k12, learned_ani=False)
    split = db.query("K12-split", *split_contigs(ecoli_k12, 1000),
                     learned_ani=False)
    assert len(whole) == 1 and len(split) == 1
    assert abs(whole[0].identity - split[0].identity) < 2e-3
    # aligned fraction drops slightly on the split genome: chains cannot
    # span contig boundaries, and each of the 999 cuts loses roughly one
    # seed spacing (c=125 bp) of coverage per edge — ~250/4641 = 5.4% —
    # an effect inherent to the method, not an engine artifact
    assert 0 < whole[0].query_fraction - split[0].query_fraction < 7e-2
    assert 0 < (whole[0].reference_fraction -
                split[0].reference_fraction) < 7e-2


def test_giant_contig_fallback_memory():
    """A reference whose contig exceeds the packed range (cap shrunk by a
    many-contig co-resident genome) is rerouted through the full-range
    per-pair path and still hits, with the same values it gets in a
    store where no fallback is needed."""
    rng = np.random.default_rng(23)
    base = random_genome(rng, 600_000)        # single 600 kb contig
    # the draft is RELATED to the query so both genomes shortlist
    # together: the packed cap is sized from the shortlist's contig
    # buckets (an unrelated fragmented genome in the store must not
    # force the fallback for anyone).  1 kb contigs chain normally; the
    # random filler contigs push the count over 4096 -> bucket 8192.
    draft = split_contigs(mutate(rng, base, 0.04), 600) + \
        [random_genome(rng, 1000) for _ in range(3500)]
    assert contig_budget_for(len(draft)) == 8192

    # store WITHOUT the fragmented genome: cap is huge, block path runs
    db0 = pyskani_tpu.Database()
    db0.sketch("giant", base)
    q = mutate(rng, base, 0.01)
    ref_hits = {h.reference_name: h for h in db0.query("q", q)}
    assert "giant" in ref_hits

    # store WITH it: shortlist = {giant, draft} -> C bucket 8192 ->
    # rcid_bits 13 -> cap 2^19 bp, so the 600 kb contig of "giant" must
    # take the full-range per-pair fallback while "draft" chains on the
    # block path
    db = pyskani_tpu.Database()
    db.sketch("giant", base)
    db.sketch("draft", *draft)
    cap = 1 << (32 - rcid_bits_for(8192))
    assert len(base) >= cap
    hits = {h.reference_name: h for h in db.query("q", q)}
    assert "giant" in hits and "draft" in hits
    h0, h1 = ref_hits["giant"], hits["giant"]
    assert abs(h0.identity - h1.identity) < 1e-6
    assert abs(h0.query_fraction - h1.query_fraction) < 1e-6
    assert abs(h0.reference_fraction - h1.reference_fraction) < 1e-6


def test_total_len_uint32_roundtrip(tmp_path):
    """Aggregate genome lengths are uint32 (multi-Gbp many-contig genomes
    must not wrap int32)."""
    from pyskani_tpu.db.storage import sketch_from_bytes, sketch_to_bytes
    from pyskani_tpu.ops.sketch import HostSketch

    rng = np.random.default_rng(3)
    sk = sketch_genome_device("big", [random_genome(rng, 1000)],
                              SketchParams(), length_bucket=1 << 12)
    big_total = 3_000_000_000  # > 2^31
    dev = dataclasses.replace(sk.device, total_len=np.uint32(big_total))
    host = HostSketch(name="big", contig_names=sk.contig_names, device=dev,
                      lengths=[big_total])
    assert host.total_len == big_total
    rt, _ = sketch_from_bytes(sketch_to_bytes(host, SketchParams()))
    assert int(np.asarray(rt.device.total_len)) == big_total


def test_triangle_mixed_draft_and_giant():
    """All-vs-all triangle over a store mixing a fragmented draft (which
    shrinks the packed position cap) with an ordinary complete genome
    whose contig exceeds that cap: pairs touching the giant genome are
    rerouted through the full-range per-pair pipeline instead of
    erroring (code-review r4 finding #4)."""
    from pyskani_tpu.engine.batch import (take_sketch, triangle,
                                          stack_sketches)
    from pyskani_tpu.ops.chain import chain_pair
    from pyskani_tpu.oracle.chain import ChainConfig
    from pyskani_tpu.ops.sketch import sketch_genome_device

    rng = np.random.default_rng(31)
    base = random_genome(rng, 1_200_000)
    params = SketchParams()
    genomes = [
        ("giant", [base]),                              # 1.2 Mbp contig
        ("draft", split_contigs(mutate(rng, base[:315_000], 0.02), 2100)),
        ("small", [mutate(rng, base[:800_000], 0.01)]),
    ]
    sketches = [sketch_genome_device(nm, c, params) for nm, c in genomes]
    # the draft forces contig bucket 4096 -> rcid_bits 12 -> cap 2^20,
    # which the giant contig exceeds while "small" and the draft fit
    assert contig_budget_for(2100) == 4096
    assert len(base) >= (1 << 20) > 800_000

    cfg = ChainConfig()
    ri, qi, out = triangle(sketches, cfg)
    assert len(ri) == 3
    batch = stack_sketches(sketches)
    from pyskani_tpu.engine.batch import default_budgets
    budgets = default_budgets(sketches, batch, cfg)
    for p in range(3):
        single = chain_pair(take_sketch(batch, int(ri[p])),
                            take_sketch(batch, int(qi[p])),
                            cfg=cfg, budgets=budgets)
        for key in ("ani_mean", "af_query", "af_ref"):
            np.testing.assert_allclose(
                np.asarray(out[key])[p], np.asarray(single[key]),
                rtol=0, atol=1e-6, err_msg=f"{key} pair {p}")


def test_triangle_single_giant_genome():
    """Degenerate input: a lone genome whose contig exceeds the packed
    cap must return an empty triangle, not crash (r4 review #2
    finding)."""
    from pyskani_tpu.engine.batch import triangle
    from pyskani_tpu.ops.sketch import sketch_genome_device

    rng = np.random.default_rng(5)
    contigs = split_contigs(random_genome(rng, 300_000), 2100)
    contigs[0] = random_genome(rng, 4000)
    sk = sketch_genome_device("only", contigs, SketchParams())
    # force the giant classification by monkeying a huge contig length
    sk.lengths[0] = 1 << 21
    ri, qi, out = triangle([sk])
    assert len(ri) == 0
