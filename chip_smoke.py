"""Smoke test of the served paths on NVIDIA GPUs, in one process.

    python chip_smoke.py              # phases a-e on one GPU
    python chip_smoke.py --chips 4    # phases a and f on four GPUs

Phases:
  a. device: the card's name and power limit, JAX's devices; no CPU
     fallback.
  b. goldens: E. coli EC590 vs K-12 through ``Database.sketch``/``query``
     at the reference's 4-decimal rule; the NumPy oracle on that pair
     (ANI at 2e-6, see ``goldens``) and on tests/test_conformance.py's
     derived 600 kb fixture at 1e-6.
  c. chain DP: the compiled Pallas kernel against the ``lax.scan``
     reference at PF 256 and 512 over 32,768 lanes of near-diagonal
     anchors; both timed.
  d. all-vs-all: 32 genomes of 2.3 Mbp (a ~99% ANI family) written as
     FASTA, ``skani-tpu sketch`` and ``skani-tpu triangle`` through
     ``cli.main``; two pairs against the oracle (AFs at 1e-6, ANI at
     5e-5, see ``all_vs_all``).
  e. search: ``skani-tpu search`` over the stored database (the lazy
     ``Database.open`` path) for two kin and two unrelated queries, equal
     to an in-memory ``Database.query`` over the same references.
  f. (--chips 4 only) ``search --mesh 4x1`` and ``triangle --mesh 4x1``
     and the sharded library paths, each equal to the one-device result
     at 1e-6, with the reference shards on four distinct devices.

Every phase raises on failure, so the script exits nonzero and prints no
result line.  The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "tests", "data")
ACGT = np.frombuffer(b"ACGT", np.uint8)
GENOME_LEN = 2_300_000
N_GENOMES = 32
BIG_STORE = 1024          # references in phase f's in-memory store
BIG_STORE_LEN = 100_000   # bp per reference there


def phase(name):
    """Decorator: time a phase and print its result line."""
    def wrap(fn):
        def run(*args):
            t0 = time.perf_counter()
            detail = fn(*args)
            print(f"phase {name}: ok {time.perf_counter() - t0:.1f} s "
                  f"{detail or ''}", flush=True)
        return run
    return wrap


def device_check(n_chips: int):
    """Phase a; returns the device record of the result line."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs}")
    if len(devs) != n_chips:
        raise SystemExit(f"expected {n_chips} GPUs, JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    print(f"phase a: ok devices={devs} kind={devs[0].device_kind}",
          flush=True)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def mutants(base: np.ndarray, n: int, rng, rate: float = 0.01):
    """``n`` copies of ``base``, each with ``rate`` random substitutions."""
    out = []
    for _ in range(n):
        arr = base.copy()
        idx = rng.integers(0, len(base), int(len(base) * rate))
        arr[idx] = rng.choice(ACGT, size=len(idx))
        out.append(arr.tobytes())
    return out


def family(n: int, length: int, seed: int):
    """(base, ``n`` genomes at ~99% ANI): one random base, ~1%
    substitutions each (the same generator as bench.py's family)."""
    rng = np.random.default_rng(seed)
    base = rng.choice(ACGT, size=length)
    return base, mutants(base, n, rng)


def write_fasta(path: str, name: str, seq: bytes) -> str:
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80] + b"\n")
    return path


def run_cli(argv) -> str:
    """``cli.main`` in this process; returns what it wrote to stdout."""
    from pyskani_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"skani-tpu {argv[0]} exited {rc}")
    return buf.getvalue()


def tsv_rows(text: str):
    lines = text.strip().splitlines()
    assert lines and lines[0].startswith("Ref_file"), text[:200]
    return [ln.split("\t") for ln in lines[1:]]


def oracle(ref: bytes, query: bytes):
    """(ani_mean, af_query, af_ref) of the NumPy oracle."""
    from pyskani_tpu.database import _chain_cfg_for
    from pyskani_tpu.oracle import seeding as oseed
    from pyskani_tpu.oracle.chain import chain_seeds
    from pyskani_tpu.params import SketchParams

    params = SketchParams()
    out = chain_seeds(oseed.sketch_genome("r", [ref], params),
                      oseed.sketch_genome("q", [query], params),
                      _chain_cfg_for(params))
    return (float(out.fragment_anis.mean()), out.align_fraction_query,
            out.align_fraction_ref)


def close(got, want, what: str, atol: float = 1e-6):
    if not np.allclose(got, want, rtol=0, atol=atol):
        raise AssertionError(f"{what}: got {got}, want {want}")


@phase("b")
def goldens():
    import pyskani_tpu
    from pyskani_tpu.io.fasta import parse

    ec590 = next(parse(os.path.join(DATA, "e.coli-EC590.fasta.gz"))).seq
    k12 = next(parse(os.path.join(DATA, "e.coli-K12.fasta.gz"))).seq
    db = pyskani_tpu.Database()
    db.sketch("EC590", ec590)

    def one(**kw):
        hits = db.query("K12", k12, **kw)
        assert len(hits) == 1, (kw, hits)
        h = hits[0]
        # the reference asserts both fractions at 4 decimals in every mode
        assert round(h.query_fraction - 0.9189, 4) == 0, (kw, h)
        assert round(h.reference_fraction - 0.9246, 4) == 0, (kw, h)
        return h

    raw = one(learned_ani=False)
    assert round(raw.identity - 0.9946, 4) == 0, raw
    assert round(one(robust=True).identity - 0.9977, 4) == 0
    assert round(one(median=True).identity - 0.9995, 4) == 0
    learned = one(learned_ani=True)
    assert round(learned.identity - 0.9939, 4) == 0, learned
    assert one().identity == learned.identity
    # the engine averages ~460 fragment ANIs in float32, the oracle in
    # float64: on this pair they part by 1.2e-6 on the CPU backend too
    o_ani, o_afq, o_afr = oracle(ec590, k12)
    close(raw.identity, o_ani, "EC590/K12 ANI vs oracle", atol=2e-6)
    close(raw.query_fraction, o_afq, "EC590/K12 AF query vs oracle")
    close(raw.reference_fraction, o_afr, "EC590/K12 AF ref vs oracle")

    # tests/test_conformance.py's derived fixture at 1e-6: the first
    # 600 kb of EC590 against a copy with 12% substitutions
    sl = np.frombuffer(ec590, np.uint8)[:600_000]
    mut = mutants(sl, 1, np.random.default_rng(3), rate=0.12)[0]
    db_sl = pyskani_tpu.Database()
    db_sl.sketch("slice", sl.tobytes())
    (h,) = db_sl.query("mutant", mut, learned_ani=False, cutoff=0.01)
    s_ani, s_afq, s_afr = oracle(sl.tobytes(), mut)
    close(h.identity, s_ani, "derived slice ANI vs oracle")
    close(h.query_fraction, s_afq, "derived slice AF query vs oracle")
    close(h.reference_fraction, s_afr, "derived slice AF ref vs oracle")
    return (f"identity={raw.identity!r} oracle={o_ani!r} "
            f"learned={learned.identity!r} slice={h.identity!r} "
            f"slice_oracle={s_ani!r}")


def dp_grid(n_lanes: int, pf: int, seed: int = 0):
    """Near-diagonal anchor grid [n_lanes, pf] as the packed block path
    builds it: per-row sorted reference positions ~125 bp apart, query
    positions on a drifting diagonal (20% reverse strand, 5% spurious),
    20% of rows crossing into a second reference contig, ragged fill."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    col = np.arange(pf)[None, :]
    fill = rng.integers(pf // 3, pf + 1, n_lanes)
    fill[rng.random(n_lanes) < 0.1] = 0
    valid = col < fill[:, None]
    rpos = rng.integers(0, 1 << 20, n_lanes)[:, None] + np.cumsum(
        rng.geometric(1 / 125, (n_lanes, pf)), axis=1)
    drift = np.cumsum(rng.choice([-3, 0, 0, 0, 0, 0, 0, 0, 0, 2],
                                 (n_lanes, pf)), axis=1)
    rev = rng.random(n_lanes) < 0.2
    qpos = np.where(rev[:, None], (1 << 23) - rpos,
                    rpos + rng.integers(-5000, 5000, n_lanes)[:, None])
    qpos = qpos + drift
    spurious = rng.random((n_lanes, pf)) < 0.05
    qpos = np.clip(np.where(spurious, rng.integers(0, 1 << 23, qpos.shape),
                            qpos), 0, (1 << 29) - 1)
    split = (fill // 2)[:, None]
    rcid = np.where((rng.random(n_lanes) < 0.2)[:, None] & (col >= split),
                    1, 0)
    rpos = np.where(rcid == 1, rpos - np.take_along_axis(
        rpos, np.clip(split, 0, pf - 1), axis=1) + 7, rpos)
    meta = np.where(valid, (rcid << 3) | (rev[:, None] << 1) | 1, 0)
    return {"qpos": jnp.asarray(np.where(valid, qpos, 0), jnp.int32),
            "rpos": jnp.asarray(np.where(valid, rpos, 0), jnp.int32),
            "meta": jnp.asarray(meta, jnp.int32)}


def timed(fn, arg, reps: int = 5):
    """(result, compile+first-call seconds, median steady seconds)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(arg))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arg))
        times.append(time.perf_counter() - t0)
    return out, first, float(np.median(times))


@phase("c")
def dp_kernel():
    import jax

    from pyskani_tpu.ops.chain import (EngineBudgets, _dp_dispatch,
                                       _dp_scan, _unpack_meta)
    from pyskani_tpu.oracle.chain import ChainConfig

    cfg = ChainConfig()
    kernel = jax.jit(lambda g: _dp_dispatch(g, cfg, EngineBudgets()))
    scan = jax.jit(lambda g: _dp_scan(_unpack_meta(g), cfg,
                                      EngineBudgets()))
    lines = []
    for pf in (256, 512):
        grid = dp_grid(32768, pf)
        (s_k, r_k), c_k, t_k = timed(kernel, grid)
        (s_s, r_s), c_s, t_s = timed(scan, grid)
        s_k, r_k, s_s, r_s = map(np.asarray, (s_k, r_k, s_s, r_s))
        chained = int((r_s != np.arange(pf)).sum())
        assert chained > 0, "degenerate grid: nothing chained"
        np.testing.assert_array_equal(r_k, r_s, f"roots PF={pf}")
        np.testing.assert_array_equal(s_k, s_s, f"scores PF={pf}")
        lines.append(f"PF={pf} lanes={len(r_k)} kernel={t_k * 1e3:.3f}ms "
                     f"scan={t_s * 1e3:.3f}ms (first call {c_k:.1f}s / "
                     f"{c_s:.1f}s) chained={chained}")
    return "; ".join(lines)


def write_family(tmp: str):
    """The phase-d genome family as FASTA files; returns (paths, seqs)."""
    _, seqs = family(N_GENOMES, GENOME_LEN, seed=0)
    paths = [write_fasta(os.path.join(tmp, f"g{i:02d}.fa"), f"g{i:02d}", s)
             for i, s in enumerate(seqs)]
    return paths, seqs


@phase("d")
def all_vs_all(tmp: str, dbdir: str, paths, seqs):
    from pyskani_tpu.engine.batch import triangle
    from pyskani_tpu.ops.sketch import sketch_genomes_device
    from pyskani_tpu.params import SketchParams

    run_cli(["sketch", "-o", dbdir, *paths])
    rows = tsv_rows(run_cli(["triangle", *paths]))
    n_pairs = N_GENOMES * (N_GENOMES - 1) // 2
    assert len(rows) == n_pairs, f"{len(rows)} triangle rows"
    anis = np.array([float(r[2]) for r in rows])
    assert anis.min() > 98.0, f"min ANI {anis.min()}"

    names = [os.path.basename(p) for p in paths]
    sks = sketch_genomes_device([(n, [s]) for n, s in zip(names, seqs)],
                                SketchParams())
    ri, qi, out = triangle(sks)
    lib = {(names[r], names[q]): f"{100 * a:.2f}"
           for r, q, a in zip(ri, qi, out["ani_mean"])}
    assert {(r[0], r[1]): r[2] for r in rows} == lib, "CLI != library"
    # at this genome size the engine's ANI and the oracle's part by up
    # to 1.4e-5 on the CPU backend too (pair 30/31): a pre-existing
    # method difference, so the ANI is held to 5e-5 and the AFs to 1e-6
    for p in (0, n_pairs - 1):
        o_ani, o_afq, o_afr = oracle(seqs[ri[p]], seqs[qi[p]])
        close(out["ani_mean"][p], o_ani, f"pair {p} ANI vs oracle",
              atol=5e-5)
        close(out["af_query"][p], o_afq, f"pair {p} AF query vs oracle")
        close(out["af_ref"][p], o_afr, f"pair {p} AF ref vs oracle")
    last = float(out["ani_mean"][-1])
    return (f"pairs={len(rows)} ani=[{anis.min():.2f}, {anis.max():.2f}] "
            f"pair {n_pairs - 1}: {last!r} oracle {o_ani!r}")


def search_queries(tmp: str):
    """Two kin queries (new ~1% mutants of the family base) and two
    unrelated random genomes, as FASTA; returns (paths, seqs)."""
    base, _ = family(0, GENOME_LEN, seed=0)
    rng = np.random.default_rng(5)
    seqs = mutants(base, 2, rng)
    seqs += [rng.choice(ACGT, size=GENOME_LEN).tobytes() for _ in range(2)]
    names = ["kin0", "kin1", "unrelated0", "unrelated1"]
    paths = [write_fasta(os.path.join(tmp, f"{n}.fa"), n, s)
             for n, s in zip(names, seqs)]
    return paths, seqs


def hit_rows(hits_per_query):
    """Hits as the CLI prints them (min AF 15%, best ANI first)."""
    from pyskani_tpu import cli

    buf = io.StringIO()
    for hits in hits_per_query:
        hits = sorted((h for h in hits if max(
            h.query_fraction, h.reference_fraction) * 100 >= 15.0),
            key=lambda h: -h.identity)
        for h in hits:
            cli._emit(buf, h.reference_name, h.query_name, h.identity,
                      h.reference_fraction, h.query_fraction)
    return sorted(ln.split("\t") for ln in buf.getvalue().splitlines())


@phase("e")
def search(tmp: str, dbdir: str):
    import pyskani_tpu

    qpaths, qseqs = search_queries(tmp)
    rows = sorted(tsv_rows(run_cli(["search", "-d", dbdir, *qpaths])))
    by_query = {}
    for r in rows:
        by_query.setdefault(r[1], []).append(r)
    assert set(by_query) == {"kin0.fa", "kin1.fa"}, sorted(by_query)
    assert all(len(v) == N_GENOMES for v in by_query.values())
    mem = pyskani_tpu.Database.load(dbdir)
    want = hit_rows(mem.query(os.path.basename(p), s)
                    for p, s in zip(qpaths, qseqs))
    assert rows == want, "stored-database search != in-memory query"
    return f"hits={len(rows)} queries={len(qpaths)}"


@phase("f")
def mesh_paths(tmp: str):
    import jax

    import pyskani_tpu
    from pyskani_tpu.engine.batch import default_budgets, stack_sketches
    from pyskani_tpu.engine.batch import triangle
    from pyskani_tpu.oracle.chain import ChainConfig
    from pyskani_tpu.ops.sketch import sketch_genomes_device
    from pyskani_tpu.parallel.dist import sharded_triangle
    from pyskani_tpu.parallel.mesh import make_mesh
    from pyskani_tpu.parallel.search import ShardedDatabaseSearch
    from pyskani_tpu.params import SketchParams

    mesh = make_mesh(db=4, batch=1)
    assert len({d.id for d in mesh.devices.flat}) == 4, mesh

    def same_hits(a, b, what):
        for ha, hb in zip(a, b, strict=True):
            ka = sorted((h.reference_name, h.identity, h.query_fraction,
                         h.reference_fraction) for h in ha)
            kb = sorted((h.reference_name, h.identity, h.query_fraction,
                         h.reference_fraction) for h in hb)
            assert [k[0] for k in ka] == [k[0] for k in kb], what
            close([k[1:] for k in ka], [k[1:] for k in kb], what)

    # search over the phase-e store: CLI, then the library, vs one device
    paths, seqs = write_family(tmp)
    dbdir = os.path.join(tmp, "db")
    run_cli(["sketch", "-o", dbdir, *paths])
    qpaths, qseqs = search_queries(tmp)
    search_rows = sorted(tsv_rows(run_cli(["search", "-d", dbdir, *qpaths])))
    four = sorted(tsv_rows(run_cli(["search", "--mesh", "4x1", "-d", dbdir,
                                    *qpaths])))
    assert search_rows == four, "search --mesh 4x1 != one-device search"
    named = [(os.path.basename(p), [s]) for p, s in zip(qpaths, qseqs)]
    stored = pyskani_tpu.Database.open(dbdir)
    same_hits(ShardedDatabaseSearch(stored, mesh).query_many(named),
              [stored.query(n, *c) for n, c in named], "stored search")

    # a 1,024-reference in-memory store: 16 kin, the rest unrelated
    rng = np.random.default_rng(77)
    base = rng.choice(ACGT, size=BIG_STORE_LEN)
    refs = [(f"kin{i}", [s])
            for i, s in enumerate(mutants(base, 16, rng, 0.02))]
    refs += [(f"bg{i}", [rng.choice(ACGT, size=BIG_STORE_LEN).tobytes()])
             for i in range(BIG_STORE - 16)]
    big = pyskani_tpu.Database()
    big.sketch_many(refs)
    searcher = ShardedDatabaseSearch(big, mesh, learned_ani=False)
    shard_devs = {d for leaf in jax.tree.leaves(searcher._refs)
                  for d in leaf.sharding.device_set}
    assert len(shard_devs) == 4, f"reference shards on {shard_devs}"
    queries = [(f"q{i}", [s]) for i, s in enumerate(mutants(base, 4, rng))]
    got = searcher.query_many(queries)
    same_hits(got, [big.query(n, *c, learned_ani=False)
                    for n, c in queries], "1,024-reference search")
    assert all(h and {x.reference_name for x in h} <=
               {f"kin{i}" for i in range(16)} for h in got), "kin hits"

    # all-vs-all: CLI, then the library, vs one device
    tri_rows = sorted(tsv_rows(run_cli(["triangle", *paths])))
    four = sorted(tsv_rows(run_cli(["triangle", "--mesh", "4x1", *paths])))
    assert tri_rows == four, "triangle --mesh 4x1 != one-device triangle"
    sks = sketch_genomes_device(
        [(os.path.basename(p), [s]) for p, s in zip(paths, seqs)],
        SketchParams())
    ri0, qi0, single = triangle(sks)
    batch = stack_sketches(sks)
    ri, qi, sharded = sharded_triangle(
        batch, mesh, cfg=ChainConfig(),
        budgets=default_budgets(sks, batch, ChainConfig()))
    np.testing.assert_array_equal(ri, ri0)
    np.testing.assert_array_equal(qi, qi0)
    for key in ("ani_mean", "af_query", "af_ref"):
        close(sharded[key], single[key], f"sharded triangle {key}")
    return (f"search rows={len(search_rows)} big-store hits="
            f"{[len(h) for h in got]} triangle pairs={len(ri)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-device mesh phase")
    args = ap.parse_args(argv)
    device = device_check(args.chips)

    sys.path.insert(0, HERE)
    from pyskani_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    with tempfile.TemporaryDirectory() as tmp:
        if args.chips == 4:
            mesh_paths(tmp)
        else:
            goldens()
            dp_kernel()
            dbdir = os.path.join(tmp, "db")
            paths, seqs = write_family(tmp)
            all_vs_all(tmp, dbdir, paths, seqs)
            search(tmp, dbdir)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
