"""Database: the pyskani-compatible user API over the device engine.

API-parity port of the reference ``Database`` pyclass
(/root/reference/src/pyskani/_skani/lib.rs:132-741): same constructor
signature and defaults (lib.rs:369), same classmethods (open/load), same
sketch/query/save/flush methods, storage formats, exception types and
context-manager semantics.  The compute underneath is the JAX device
engine (device sketching, batched marker screening, jitted chain
pipeline) instead of a per-pair Rust loop.
"""

from __future__ import annotations

import os
import pathlib
from typing import List, Optional, Sequence, Union

import numpy as np

from . import regression
from .hit import Hit
from .utils import profiling
from .oracle.chain import ChainConfig
from .db import storage as dbstorage
from .db.storage import (ConsolidatedStorage, FolderStorage, MarkerSketch,
                         MemoryStorage, load_index, load_markers)
from .ops.chain import EngineBudgets
from .ops.screen import screen_batch
from .ops.sketch import HostSketch, round_up, sketch_genome_device
from .params import (MIN_ANI_KEEP, CommandParams,
                     SEARCH_ANI_CUTOFF_DEFAULT, SketchParams)

_Sequence = Union[str, bytes, bytearray, memoryview]


def _as_bytes(contig: _Sequence) -> bytes:
    """Accept str/bytes/bytearray/memoryview/buffer (reference utils.rs
    Text semantics, utils.rs:74-102)."""
    if isinstance(contig, str):
        return contig.encode("utf-8")
    if isinstance(contig, (bytes, bytearray)):
        return bytes(contig)
    return bytes(memoryview(contig))


class Sketch:
    """A sketched genome (parity with the reference Sketch pyclass,
    sketch.rs:4-38: name/c/amino_acid getters, no public constructor).

    Instances wrap the engine's :class:`HostSketch`; ``Database`` holds
    one per sketched genome (``Database._sketch`` returns them, mirroring
    the reference's internal ``_sketch`` at lib.rs:140-185).
    """

    def __init__(self, host_sketch: HostSketch, c: int, amino_acid: bool = False):
        self._host = host_sketch
        self._c = c
        self._amino_acid = amino_acid

    @property
    def name(self) -> str:
        return self._host.name

    @property
    def c(self) -> int:
        return self._c

    @property
    def amino_acid(self) -> bool:
        return self._amino_acid

    def __repr__(self) -> str:
        return f"<Sketch name={self.name!r} c={self.c}>"


def _chain_cfg_for(params: SketchParams) -> ChainConfig:
    """Chain config derived from the sketch params: the ANI exponent is
    1/k and chain intervals extend by k-1 (the un-hashed tail of the
    terminal k-mer)."""
    import dataclasses
    return dataclasses.replace(ChainConfig(), k=params.k,
                               extend_right=params.k - 1)


def _partition_blockable(by_name, shortlist, query_total: int = 0):
    """Split a shortlist into (block_names, fb_names, cb, cap).

    ``block_names`` chain on the packed block pipeline whose contig
    bucket ``cb`` (max over block members) gives the position cap
    ``2^(32-rcid_bits)``; ``fb_names`` exceed the cap and reroute
    through the full-range per-pair pipeline.  Iterated to a fixed
    point: a genome that itself falls back must not shrink the cap for
    the remaining block-path references (its bucket leaves ``cb`` once
    it is excluded, which can only GROW the cap, so the loop converges).

    Queries >= 2^30 bp total route EVERY reference through the
    full-range path: the block pipeline's POST-DP stage works in
    genome-global int32 coordinates with a 2^30 padding sentinel
    (_denom_prefix / _post_dp_block), so larger totals would corrupt
    span denominators there even though the grid payload itself is
    contig-local; the per-pair pipeline keeps per-contig coordinates
    end to end and has no total-length cap (reference contract: totals
    are usize, lib.rs:160).  chain_block flags such totals via
    pos_overflow as a backstop for direct callers.
    """
    from .ops.chain import rcid_bits_for
    from .ops.sketch import contig_budget_for

    if query_total >= (1 << 30):
        return [], list(shortlist), 8, 1 << (32 - rcid_bits_for(8))

    block = list(shortlist)
    while True:
        cb = max((contig_budget_for(len(by_name[rn].contig_lengths))
                  for rn in block), default=8)
        cap = 1 << (32 - rcid_bits_for(cb))
        viol = {rn for rn in block
                if max(by_name[rn].contig_lengths, default=0) >= cap}
        if not viol:
            break
        block = [rn for rn in block if rn not in viol]
    blocked = set(block)
    return block, [rn for rn in shortlist if rn not in blocked], cb, cap


def _pow2_chunk(n: int, cap: int = 16) -> int:
    """Bucket a chunk size to a power of two so jit shapes are stable
    across queries with different shortlist lengths."""
    p = 1
    while p < min(max(n, 1), cap):
        p *= 2
    return p


class Database:
    """A database storing sketched genomes.

    The database contains two different sketch collections with different
    compression levels: marker sketches, which are heavily compressed and
    always kept in memory, and genome sketches, which take more memory but
    may be stored inside an external file.  (Reference docstring,
    lib.rs:125-131.)
    """

    def __init__(self, path=None, *, compression: int = 125,
                 marker_compression: int = 1000, k: int = 15,
                 format: Optional[str] = None):
        self._params = SketchParams(c=compression,
                                    marker_c=marker_compression, k=k)
        self._markers: List[MarkerSketch] = []
        self._chain_cfg = _chain_cfg_for(self._params)
        self._screen_cache = None
        self._stack_cache = None
        if path is None:
            self._storage = MemoryStorage()
        else:
            folder = pathlib.Path(os.fsdecode(path))
            if not folder.exists():
                try:
                    folder.mkdir(parents=True)
                except OSError as err:
                    raise OSError(err.errno,
                                  f"Failed to create {folder}") from None
            if (folder / "markers.bin").exists():
                raise FileExistsError(str(folder / "markers.bin"))
            fmt = format if format is not None else "consolidated"
            if fmt == "consolidated":
                self._storage = ConsolidatedStorage(folder)
            elif fmt == "separated":
                self._storage = FolderStorage(folder)
            else:
                raise ValueError(f"invalid format: {fmt}")

    # -- classmethods -----------------------------------------------------

    @classmethod
    def open(cls, path) -> "Database":
        """Open a database folder, loading only markers into memory
        (lazy sketch loads; reference lib.rs:277-337)."""
        folder = pathlib.Path(os.fsdecode(path))
        markers_path = folder / "markers.bin"
        if not markers_path.exists():
            raise OSError(2, f"Failed to open {markers_path}")
        params, markers = load_markers(markers_path)
        self = cls.__new__(cls)
        self._params = params
        self._markers = markers
        self._chain_cfg = _chain_cfg_for(params)
        self._screen_cache = None
        self._stack_cache = None
        if (folder / "index.db").exists() and (folder / "sketches.db").exists():
            self._storage = ConsolidatedStorage(folder, load_index(folder))
        else:
            self._storage = FolderStorage(folder)
        return self

    @classmethod
    def load(cls, path) -> "Database":
        """Open a database folder and eagerly load every sketch in memory
        (fast queries, more RAM; reference lib.rs:232-275)."""
        self = cls.open(path)
        mem = MemoryStorage()
        for marker in self._markers:
            name = os.path.basename(marker.name)
            mem.store(self._storage.load(name), self._params)
        self._storage = mem
        return self

    # -- properties -------------------------------------------------------

    @property
    def path(self) -> Optional[pathlib.Path]:
        return getattr(self._storage, "path", None)

    @property
    def compression(self) -> int:
        return self._params.c

    @property
    def marker_compression(self) -> int:
        return self._params.marker_c

    # -- context manager --------------------------------------------------

    def __enter__(self) -> "Database":
        return self

    def __exit__(self, exc_type, exc_value, traceback) -> bool:
        self.flush()
        return False

    # -- core methods -----------------------------------------------------

    def sketch(self, name: str, *contigs: _Sequence, seed: bool = True) -> None:
        """Add a reference genome to the database (reference
        lib.rs:466-510).

        ``seed=False`` skips seed-position recording (reference
        lib.rs:474-475): the sketch screens normally but cannot be
        chained, so queries will never report it as a hit.
        """
        self._sketch(name, [_as_bytes(c) for c in contigs], seed)

    def _sketch(self, name: str, data, seed: bool = True) -> Sketch:
        """Sketch + register one genome; returns the Sketch wrapper
        (mirror of the reference's internal ``_sketch``, lib.rs:140-185)."""
        with profiling.scope("sketch"):
            host = sketch_genome_device(name, data, self._params, seed=seed)
        if profiling.enabled():
            profiling.stats().add("bases_sketched", sum(map(len, data)))
        self._register_sketch(host)
        return Sketch(host, self._params.c)

    def sketch_many(self, named_contigs) -> None:
        """Add many reference genomes with batched device dispatches.

        ``named_contigs`` is an iterable of (name, [contig, ...]).  New
        capability over the reference (which sketches serially per call,
        lib.rs:477-510): genomes are stacked and the sketch kernel runs
        once per stack, amortising host->device round trips.
        """
        from .ops.sketch import sketch_genomes_device
        items = [(name, [_as_bytes(c) for c in contigs])
                 for name, contigs in named_contigs]
        with profiling.scope("sketch"):
            hosts = sketch_genomes_device(items, self._params)
        if profiling.enabled():
            profiling.stats().add(
                "bases_sketched",
                sum(len(c) for _, cs in items for c in cs))
        for host in hosts:
            self._register_sketch(host)

    def _register_sketch(self, host: HostSketch) -> None:
        dev = host.device
        m = int(dev.n_markers)
        self._markers.append(MarkerSketch(
            name=host.name, total_len=host.total_len,
            contig_names=host.contig_names,
            contig_lengths=list(host.lengths),
            hi=np.asarray(dev.markers_hi[:m]),
            lo=np.asarray(dev.markers_lo[:m])))
        self._screen_cache = None
        self._stack_cache = None
        self._storage.store(host, self._params)

    def _marker_matrix(self):
        """Stacked, padded marker matrix for batched device screening."""
        if self._screen_cache is None:
            n = len(self._markers)
            M = round_up(max((len(m.hi) for m in self._markers), default=1),
                         512)
            hi = np.full((n, M), 0xFFFFFFFF, np.uint32)
            lo = np.full((n, M), 0xFFFFFFFF, np.uint32)
            counts = np.zeros(n, np.int32)
            for i, m in enumerate(self._markers):
                hi[i, :len(m.hi)] = m.hi
                lo[i, :len(m.lo)] = m.lo
                counts[i] = len(m.hi)
            self._screen_cache = (hi, lo, counts)
        return self._screen_cache

    def _budgets_for(self, query: HostSketch,
                     shortlist=None) -> EngineBudgets:
        fl = self._chain_cfg.fragment_length
        # the fragment budget must cover BOTH estimation grids
        # (est_side="both" bins anchors on the ref grid too): size it to
        # the larger of the query and the longest SHORTLISTED reference.
        # Fragments are per-contig (every contig contributes >= 1), so
        # fragmented drafts need far more than total_len/fl.
        nf_q = query.n_fragments(fl)
        markers = self._markers if shortlist is None else \
            [m for m in self._markers
             if os.path.basename(m.name) in shortlist]
        nf_r = max((sum(max(1, -(-L // fl)) for L in m.contig_lengths)
                    for m in markers), default=1)
        nf = round_up(max(nf_q, nf_r) + 2, 128)
        # budgets are static jit arguments: bucket the fragment count to
        # powers of two above 384 so shortlist-dependent sizing produces
        # only a handful of distinct compiled shapes per database
        if nf > 384:
            p = 512
            while p < nf:
                p *= 2
            nf = p
        qa = query.device.seed_budget
        return EngineBudgets(
            max_anchors=round_up(int(qa * 1.5) + 4096, 8192),
            max_fragments=nf,
            max_anchors_per_fragment=256,
        )

    def _ref_stack(self):
        """(names, stacked DeviceSketch, seed_bucket, marker_bucket) for
        the whole reference store; cached for in-memory databases."""
        from .engine.batch import stack_sketches

        if self._stack_cache is not None:
            return self._stack_cache
        names = [os.path.basename(m.name) for m in self._markers]
        refs = [self._storage.load(n) for n in names]
        # one batched fetch for every count scalar (vs 2 device round
        # trips per reference)
        import jax as _jax
        counts = _jax.device_get([(r.device.n_seeds, r.device.n_markers)
                                  for r in refs])
        bucket = round_up(max(int(n) for n, _ in counts), 8192)
        mbucket = round_up(max(int(m) for _, m in counts), 512)
        stack = stack_sketches(refs, seed_budget=bucket,
                               marker_budget=mbucket)
        out = (names, stack, bucket, mbucket)
        if isinstance(self._storage, MemoryStorage):
            self._stack_cache = out
        return out

    def query(self, name: str, *contigs: _Sequence, seed: bool = True,
              learned_ani: Optional[bool] = None, median: bool = False,
              robust: bool = False, cutoff: Optional[float] = None,
              faster_small: bool = False, est_ci: bool = False) -> List[Hit]:
        """Query the database with a genome (reference lib.rs:512-660).

        ``est_ci=True`` additionally computes a [5%, 95%]
        percentile-bootstrap confidence interval on the ANI (skani's
        --ci / CommandParams.est_ci; the reference fixes est_ci to its
        default-off value, lib.rs:592) and populates ``Hit.ci_low`` /
        ``Hit.ci_high``.
        """
        data = [_as_bytes(c) for c in contigs]
        with profiling.scope("sketch"):
            query = sketch_genome_device(name, data, self._params, seed=seed)
        if profiling.enabled():
            profiling.stats().add("bases_sketched", sum(map(len, data)))

        learned = learned_ani if learned_ani is not None else \
            regression.use_learned_ani(self._params.c, False, False, median)
        # fixed Search-mode command surface (reference lib.rs:573-601)
        cmd = CommandParams(
            screen_val=(cutoff if cutoff is not None
                        else SEARCH_ANI_CUTOFF_DEFAULT),
            robust=robust, median=median, learned_ani=learned,
            rescue_small=not faster_small, est_ci=est_ci)
        screen_val = cmd.screen_val
        model = regression.get_model(self._params.c, cmd.learned_ani)

        hits: List[Hit] = []
        if not self._markers:
            return hits

        # phase 1 — batched marker screen (one op, all references)
        hi, lo, counts = self._marker_matrix()
        qdev = query.device
        with profiling.scope("screen"):
            passes, _ = screen_batch(
                qdev.markers_hi, qdev.markers_lo, qdev.n_markers,
                hi, lo, counts, screen_val,
                marker_k=self._params.marker_k,
                rescue_small=cmd.rescue_small)
            passes = np.asarray(passes)
        if profiling.enabled():
            profiling.stats().add("refs_screened", len(self._markers))
            profiling.stats().add("screen_passed", int(passes.sum()))
        # shortlist preserves marker insertion order, deduplicated — the
        # reference iterates markers in order and returns hits in that
        # order (lib.rs:616-657)
        shortlist = list(dict.fromkeys(
            os.path.basename(self._markers[i].name)
            for i in np.nonzero(passes)[0]))

        # phase 2 — batched chain pipeline over the shortlist.  In-memory
        # stores keep the whole reference set as one cached device tensor
        # and chain every shortlisted pair in one dispatch; disk-backed
        # stores stream ONLY the shortlisted sketches through the device
        # in double-buffered chunks, so memory stays bounded and the
        # lazy `open()` contract holds (the reference instead loads each
        # sketch serially inside the pair loop, lib.rs:639-657).
        # References whose contigs exceed the packed block-grid range are
        # automatically rerouted through the full-range per-pair path
        # (reference contract: GnPosition is full-width, lib.rs:160).
        maf = cmd.min_aligned_frac
        from .engine.batch import (check_overflow, one_vs_many,
                                   one_vs_many_pairs, repad_sketch,
                                   stack_sketches)

        cfg = self._chain_cfg
        if est_ci:
            import dataclasses
            cfg = dataclasses.replace(cfg, est_ci=True)

        by_name = {os.path.basename(m.name): m for m in self._markers}
        out: dict = {}
        order = {rn: i for i, rn in enumerate(shortlist)}

        def merge(partial, names_part):
            for k, v in partial.items():
                arr = np.asarray(v)
                if k not in out:
                    out[k] = np.zeros((len(shortlist),) + arr.shape[1:],
                                      arr.dtype)
                for j, rn in enumerate(names_part):
                    out[k][order[rn]] = arr[j]

        if isinstance(self._storage, MemoryStorage):
            import dataclasses as _dc

            names_all, stack, bucket, mbucket = self._ref_stack()
            # packed-range cap from the BLOCK PARTITION's own contig
            # buckets (fixed point): neither a fragmented genome
            # elsewhere in the store nor one that itself falls back may
            # shrink the packed position range for the ordinary
            # references.  The stacked contig axis is sliced down to the
            # partition bucket for the block call — every block-routed
            # genome's contigs fit it by construction.
            block_names, fb_names, cb, cap = _partition_blockable(
                by_name, shortlist, query.total_len)
            stack_block = stack if cb == stack.contig_lengths.shape[1] \
                else _dc.replace(stack,
                                 contig_lengths=stack.contig_lengths[:, :cb])
            qpad = repad_sketch(query, max(bucket, query.device.seed_budget),
                                max(mbucket, query.device.marker_budget))
            with profiling.scope("chain"):
                if block_names:
                    # per-partition budgets: a giant fallback-routed ref
                    # must not inflate the block path's fragment budget.
                    # The block pipeline caps pairs*max_fragments at 2^17
                    # (grid-lane limit): chunk accordingly.
                    budgets = self._budgets_for(query, set(block_names))
                    bcap = max(1, min(16,
                                      (1 << 17) // budgets.max_fragments))
                    idx = np.array([names_all.index(rn)
                                    for rn in block_names], np.int32)
                    part = one_vs_many(stack_block, qpad, idx, cfg=cfg,
                                       budgets=budgets,
                                       chunk=_pow2_chunk(len(idx),
                                                         cap=bcap))
                    check_overflow(part, budgets)
                    merge(part, block_names)
                if fb_names:
                    budgets = self._budgets_for(query, set(fb_names))
                    idx = np.array([names_all.index(rn)
                                    for rn in fb_names], np.int32)
                    part = one_vs_many_pairs(
                        stack, qpad, idx, cfg=cfg, budgets=budgets,
                        chunk=_pow2_chunk(len(idx), cap=4))
                    check_overflow(part, budgets)
                    merge(part, fb_names)
        else:
            from .engine.stream import stream_one_vs_many
            from .ops.sketch import marker_budget_for, seed_budget_for

            tl = max((by_name[rn].total_len for rn in shortlist), default=0)
            bucket = max(seed_budget_for(tl, self._params.c),
                         query.device.seed_budget)
            mbucket = max(marker_budget_for(tl, self._params.marker_c),
                          query.device.marker_budget)
            block_names, fb_names, cb, cap = _partition_blockable(
                by_name, shortlist, query.total_len)
            qpad = repad_sketch(query, bucket, mbucket)
            with profiling.scope("chain"):
                if block_names:
                    budgets = self._budgets_for(query, set(block_names))
                    bcap = max(1, min(16,
                                      (1 << 17) // budgets.max_fragments))
                    part = stream_one_vs_many(
                        self._storage.load, list(block_names), qpad,
                        cfg=cfg, budgets=budgets, seed_budget=bucket,
                        marker_budget=mbucket, contig_budget=cb,
                        chunk=_pow2_chunk(len(block_names), cap=bcap))
                    check_overflow(part, budgets)
                    merge(part, block_names)
                if fb_names:
                    budgets = self._budgets_for(query, set(fb_names))
                    fb_stack = stack_sketches(
                        [self._storage.load(rn) for rn in fb_names],
                        bucket, mbucket)
                    part = one_vs_many_pairs(
                        fb_stack, qpad,
                        np.arange(len(fb_names), dtype=np.int32),
                        cfg=cfg, budgets=budgets,
                        chunk=_pow2_chunk(len(fb_names), cap=4))
                    check_overflow(part, budgets)
                    merge(part, fb_names)
        if profiling.enabled():
            profiling.stats().add("pairs_chained", len(shortlist))
        key = "ani_median" if median else \
            "ani_robust" if robust else "ani_mean"
        for i, ref_name in enumerate(shortlist):
            ani = float(out[key][i])
            af_q = float(out["af_query"][i])
            af_r = float(out["af_ref"][i])
            # the correction targets the MEAN estimator only.  Evidence:
            # the reference's test_robust (test_ani.py:49-54) runs with
            # learned ANI at its DEFAULT (ON, since c=125 >= 70 and not
            # median — lib.rs:611-613) yet its golden 0.9977 equals the
            # raw trimmed mean; likewise test_median's 0.9995 equals the
            # raw median (median mode disables learned ANI outright)
            if model is not None and not median and not robust:
                ani = regression.apply_model(model, ani, af_q, af_r)
            # min_aligned_frac gate (CommandParams.min_aligned_frac =
            # 0.15, lib.rs:589-590); both_min_aligned_frac is -0.01
            if af_q < maf and af_r < maf:
                continue
            if ani > MIN_ANI_KEEP:
                ci = {}
                if est_ci:
                    clamp = lambda v: min(max(float(v), 0.0), 1.0)
                    ci = dict(ci_low=clamp(out["ani_ci_low"][i]),
                              ci_high=clamp(out["ani_ci_high"][i]))
                hits.append(Hit(min(max(ani, 0.0), 1.0), name, af_q,
                                ref_name, af_r, **ci))
        return hits

    # -- persistence ------------------------------------------------------

    def save(self, path, overwrite: bool = False,
             format: Optional[str] = None) -> None:
        """Save the database to the given path.

        Note: unlike the reference (which inverts the format names in
        ``save`` relative to ``__init__`` — lib.rs:696-699 vs 400-411),
        this implementation follows the *documented* semantics:
        ``consolidated`` writes sketches.db/index.db, ``separated`` writes
        one file per sketch.
        """
        folder = pathlib.Path(os.fsdecode(path))
        if not folder.exists():
            try:
                folder.mkdir(parents=True)
            except OSError as err:
                raise OSError(err.errno,
                              f"Failed to create {folder}") from None
        markers_path = folder / "markers.bin"
        if not overwrite and markers_path.exists():
            raise FileExistsError(str(markers_path))
        fmt = format if format is not None else "consolidated"
        if fmt == "consolidated":
            out = ConsolidatedStorage(folder)
        elif fmt == "separated":
            out = FolderStorage(folder)
        else:
            raise ValueError(f"invalid format: {fmt}")
        for marker in self._markers:
            name = os.path.basename(marker.name)
            out.store(self._storage.load(name), self._params)
        out.flush(self._params, self._markers)

    def flush(self) -> None:
        """Flush the database buffers to disk (markers.bin for folder
        storage, plus index.db for consolidated; reference
        lib.rs:728-741)."""
        self._storage.flush(self._params, self._markers)
