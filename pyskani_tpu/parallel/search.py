"""End-to-end sharded database search: Database x device mesh.

Scales the pyskani ``Database.query`` semantics across a multi-device mesh
(BASELINE config 4/5): the reference store is sharded over the ``db``
axis, query genomes stream through the ``batch`` axis in fixed-size
groups, and each step screens, shortlists and chains only the passing
pairs on-device (parallel.dist.make_sharded_search).

Memory stays bounded on BOTH sides: in-memory stores place the whole
(cached) ref stack on the mesh once, while disk-backed ``open()`` stores
STREAM the reference store through the mesh in fixed-size chunks of
``db_axis * stream_refs_per_device`` sketches with software double
buffering — while chunk *i* is being screened/chained on the devices,
chunk *i+1* is already being deserialised and transferred (stacking the
entire store host-side would defeat the lazy ``open()`` contract).

The reference has no distributed layer at all (SURVEY.md §2.3); this is
the multi-device form of its serial query loop (lib.rs:616-657).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from .. import regression
from ..hit import Hit
from ..engine.batch import stack_sketches_host
from ..ops.sketch import (contig_budget_for, marker_budget_for,
                          round_up, seed_budget_for, sketch_genomes_device)
from ..params import SEARCH_ANI_CUTOFF_DEFAULT, MIN_ANI_KEEP
from .dist import make_sharded_search, shard_leading


class ShardedDatabaseSearch:
    """Reusable sharded searcher over a Database's reference store.

    Build once (compiles the step; in-memory stores also place the
    sharded ref stack on the mesh), then call :meth:`query_many` with
    streams of query genomes.

    ``stream_refs_per_device`` bounds per-device reference memory: the
    store is processed in chunks of ``db_axis * stream_refs_per_device``
    sketches.  It defaults to streaming for disk-backed stores (8 refs
    per device per chunk) and to the single preplaced stack for
    in-memory stores; pass a value to force chunking either way.
    """

    def __init__(self, database, mesh: Mesh, *, chunk: int = 4,
                 queries_per_device: int = 1,
                 cutoff: Optional[float] = None,
                 learned_ani: Optional[bool] = None,
                 median: bool = False, robust: bool = False,
                 faster_small: bool = False,
                 stream_refs_per_device: Optional[int] = None):
        from ..db.storage import MemoryStorage
        from ..ops.chain import EngineBudgets

        self._db = database
        self._mesh = mesh
        self._median = median
        self._robust = robust
        self._cutoff = cutoff
        self._faster_small = faster_small
        self._learned_arg = learned_ani
        ndb = mesh.shape["db"]
        self._ndb = ndb
        self._nbatch = mesh.shape["batch"]
        self._qg = self._nbatch * queries_per_device

        markers = database._markers
        names = [os.path.basename(m.name) for m in markers]
        self._names = names
        self._R = len(names)
        in_memory = isinstance(database._storage, MemoryStorage)
        if stream_refs_per_device is None and not in_memory:
            stream_refs_per_device = 8
        self._streaming = stream_refs_per_device is not None

        if self._streaming:
            # budgets from marker METADATA — no sketch is loaded here
            tl = max(m.total_len for m in markers)
            self._bucket = seed_budget_for(tl, database._params.c)
            self._mbucket = marker_budget_for(tl, database._params.marker_c)
            self._cb = max(contig_budget_for(len(m.contig_lengths))
                           for m in markers)
            # never chunk larger than the store itself (small DBs would
            # otherwise pad to ndb * stream_refs_per_device dummy slots)
            rc = ndb * min(stream_refs_per_device,
                           max(1, -(-self._R // ndb)))
            self._ref_name_chunks = [names[i:i + rc]
                                     for i in range(0, len(names), rc)]
            self._rchunk = rc
            self._refs = None
        else:
            _, stack, bucket, mbucket = database._ref_stack()
            self._bucket = bucket
            self._mbucket = mbucket
            self._cb = stack.contig_lengths.shape[1]
            pad = (-self._R) % ndb
            if pad:
                stack = jax.tree.map(
                    lambda x: jnp.concatenate([x] + [x[:1]] * pad), stack)
            self._rchunk = self._R + pad
            self._ref_name_chunks = [names]
            self._refs = shard_leading(mesh, stack, "db")

        fl = database._chain_cfg.fragment_length
        self._fl = fl
        # fragments are per-contig (every contig contributes >= 1)
        nf = round_up(max(sum(max(1, -(-L // fl)) for L in m.contig_lengths)
                          for m in markers) + 2, 128)
        self._nf = nf
        self._budgets = EngineBudgets(
            max_anchors=round_up(int(self._bucket * 1.5) + 4096, 8192),
            max_fragments=nf, max_anchors_per_fragment=256)
        screen_val = cutoff if cutoff is not None \
            else SEARCH_ANI_CUTOFF_DEFAULT
        self._learned = learned_ani if learned_ani is not None else \
            regression.use_learned_ani(database._params.c, False, False,
                                       median)
        self._model = regression.get_model(database._params.c, self._learned)
        self._step = make_sharded_search(
            mesh, database._chain_cfg, self._budgets,
            screen_val=screen_val,
            marker_k=database._params.marker_k,
            rescue_small=not faster_small, chunk=chunk)

    def _ship_ref_chunk(self, chunk_names: List[str]):
        """Load + stack + mesh-place one reference chunk (async H2D)."""
        hosts = [self._db._storage.load(n) for n in chunk_names]
        while len(hosts) < self._rchunk:   # ragged tail: repeat, discard
            hosts.append(hosts[0])
        stack = stack_sketches_host(hosts, self._bucket, self._mbucket,
                                    self._cb)
        return shard_leading(self._mesh, stack, "db")

    def query_many(self, named_queries: Sequence[Tuple[str, Sequence[bytes]]]
                   ) -> List[List[Hit]]:
        """Hits for each (name, [contig bytes...]) query genome.

        Queries stream through the mesh in groups of
        ``batch_axis * queries_per_device``; the reference store streams
        through in ``db_axis * stream_refs_per_device`` chunks
        (double-buffered) when the searcher is in streaming mode.
        """
        db = self._db
        qg = self._qg
        all_items = list(named_queries)

        # queries whose fragment count exceeds the searcher's store-sized
        # budget (e.g. multi-Gbp genomes) reroute through the
        # single-device Database.query path, which sizes budgets per
        # query and has no coordinate caps — the
        # searcher used to raise here.  Checked on raw contig lengths so
        # no sketch work is wasted.
        def _nfrag(contigs) -> int:
            from ..params import MIN_LENGTH_CONTIG
            return sum(max(1, -(-len(c) // self._fl)) for c in contigs
                       if len(c) >= MIN_LENGTH_CONTIG)

        fb_slots = {i for i, (_, cs) in enumerate(all_items)
                    if _nfrag(cs) + 2 > self._nf}
        results_by_slot: dict = {}
        for i in sorted(fb_slots):
            nm, cs = all_items[i]
            results_by_slot[i] = db.query(
                nm, *cs, learned_ani=self._learned_arg,
                median=self._median, robust=self._robust,
                cutoff=self._cutoff, faster_small=self._faster_small)
        items = [it for i, it in enumerate(all_items) if i not in fb_slots]
        reg_slots = [i for i in range(len(all_items)) if i not in fb_slots]
        if not items:
            return [results_by_slot[i] for i in range(len(all_items))]

        # sketch, stack and mesh-place every query group up front
        # (queries are the small side; the ref store streams in the
        # outer loop below so each ref chunk is deserialised ONCE for
        # all query groups).  Query-side device memory therefore scales
        # with THIS CALL's query count — stream very large query
        # workloads through multiple query_many calls.
        qgroups = []   # (group items, sharded query stack)
        for lo in range(0, len(items), qg):
            group = items[lo:lo + qg]
            n = len(group)
            sk = sketch_genomes_device(group, db._params)
            qstack = stack_sketches_host(
                sk,
                max(self._bucket,
                    max(s.device.seed_budget for s in sk)),
                max(self._mbucket,
                    max(s.device.marker_budget for s in sk)))
            if n < qg:
                qstack = jax.tree.map(
                    lambda x: np.concatenate([x] + [x[:1]] * (qg - n)),
                    qstack)
            qgroups.append((group, shard_leading(self._mesh, qstack,
                                                 "batch")))

        keys = ("ani_mean", "ani_robust", "ani_median", "af_query",
                "af_ref", "screen_pass", "anchors_overflow")
        # planes[g][k] assembles the full [R, Q_group] result per group
        planes = [{k: None for k in keys} for _ in qgroups]

        def dispatch(refs_c):
            # async: dispatch every query group's step before anything
            # blocks, so device compute overlaps host work
            return [self._step(refs_c, qsh) for _, qsh in qgroups]

        def collect(pend, row_lo: int, n_rows: int):
            fetched = jax.device_get([{k: o[k] for k in keys}
                                      for o in pend])
            for g, out in enumerate(fetched):
                for k in keys:
                    if planes[g][k] is None:
                        planes[g][k] = np.zeros(
                            (self._R,) + out[k].shape[1:], out[k].dtype)
                    planes[g][k][row_lo:row_lo + n_rows] = \
                        out[k][:n_rows]

        if self._streaming:
            chunks = self._ref_name_chunks
            pend = dispatch(self._ship_ref_chunk(chunks[0]))
            row = 0
            for ci in range(len(chunks)):
                nxt_pend = None
                if ci + 1 < len(chunks):
                    # deserialise + transfer + ENQUEUE the next chunk
                    # while the devices chew on the current one (peak
                    # device memory: two ref chunks — double buffering)
                    nxt_pend = dispatch(
                        self._ship_ref_chunk(chunks[ci + 1]))
                collect(pend, row, len(chunks[ci]))
                row += len(chunks[ci])
                pend = nxt_pend
        else:
            collect(dispatch(self._refs), 0, self._R)

        key = "ani_median" if self._median else \
            "ani_robust" if self._robust else "ani_mean"
        maf = 0.15
        # shared-pool clipping in any chunk means some pair's join was
        # truncated (ANI may be underestimated) — surface it like every
        # other path does instead of passing silently
        from ..engine.batch import check_overflow
        check_overflow(
            {"anchors_overflow": np.concatenate(
                [np.asarray(p["anchors_overflow"]).reshape(-1)
                 for p in planes])},
            self._budgets)
        out_hits: List[List[Hit]] = []
        for g, (group, _) in enumerate(qgroups):
            ani = planes[g][key]
            afq = planes[g]["af_query"]
            afr = planes[g]["af_ref"]
            sp = planes[g]["screen_pass"]
            for qi, (qname, _) in enumerate(group):
                hits: List[Hit] = []
                for ri in range(self._R):
                    if not sp[ri, qi]:
                        continue
                    a = float(ani[ri, qi])
                    fq, fr = float(afq[ri, qi]), float(afr[ri, qi])
                    if self._model is not None and not self._median \
                            and not self._robust:
                        a = regression.apply_model(self._model, a, fq, fr)
                    if fq < maf and fr < maf:
                        continue
                    if a > MIN_ANI_KEEP:
                        hits.append(Hit(min(max(a, 0.0), 1.0), qname, fq,
                                        self._names[ri], fr))
                out_hits.append(hits)
        for slot, hits in zip(reg_slots, out_hits):
            results_by_slot[slot] = hits
        return [results_by_slot[i] for i in range(len(all_items))]
