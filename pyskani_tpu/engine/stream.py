"""Out-of-core streaming search: the pipeline-parallel analog.

The reference holds every sketch it compares against in memory for the
duration of a query (Memory storage) or loads each shortlisted sketch
from disk serially inside the query loop
(/root/reference/src/pyskani/_skani/lib.rs:639-657).  Neither scales to
databases larger than device memory.

This module streams the reference store through the device in
fixed-size chunks with software double-buffering: while chunk *i* is
being chained on the device, chunk *i+1* is already being deserialised
on the host and transferred (``jax.device_put`` is asynchronous, and jit
dispatch returns before the compute finishes, so host IO, the PCIe
transfer and device compute overlap).  This is the program-phase /
pipeline-parallel capability called out in SURVEY.md §2.3 ("absent in
reference").
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..oracle.chain import ChainConfig
from ..ops.chain import EngineBudgets, chain_block
from ..ops.sketch import HostSketch, round_up
from .batch import stack_sketches_host


def _host_stack(sketches: Sequence[HostSketch], seed_budget: int,
                marker_budget: int, contig_budget: int | None):
    """Stack sketches on the HOST (numpy) so one device_put moves the
    whole chunk (a single large async transfer beats N small ones)."""
    return stack_sketches_host(sketches, seed_budget, marker_budget,
                               contig_budget)


def stream_one_vs_many(load: Callable[[str], HostSketch], names: List[str],
                       query, *, cfg: ChainConfig, budgets: EngineBudgets,
                       seed_budget: int, marker_budget: int,
                       contig_budget: int | None = None,
                       chunk: int = 16) -> Dict[str, np.ndarray]:
    """Chain ``query`` against references loaded lazily by name.

    ``load`` deserialises one sketch (disk-backed storage); chunks of
    ``chunk`` references are stacked host-side, shipped asynchronously,
    and joined against the query with one block join each.  Peak device
    memory is two chunks regardless of database size.

    Returns a dict of [len(names)] numpy arrays in ``names`` order.
    """
    if not names:
        return {}
    q1 = jax.tree.map(lambda x: x[None], query)

    def ship(chunk_names: List[str]):
        hosts = [load(n) for n in chunk_names]
        # ragged last chunk: repeat the first name to fill the bucket
        while len(hosts) < chunk:
            hosts.append(hosts[0])
        stack = _host_stack(hosts, seed_budget, marker_budget,
                            contig_budget)
        return jax.tree.map(jnp.asarray, stack)  # async H2D

    groups = [names[i:i + chunk] for i in range(0, len(names), chunk)]
    outs = []
    nxt = ship(groups[0])
    for gi in range(len(groups)):
        cur, nxt = nxt, None
        out = chain_block(cur, q1, cfg=cfg, budgets=budgets)  # async dispatch
        outs.append(jax.tree.map(lambda x: x[:, 0], out))
        if gi + 1 < len(groups):
            # host deserialisation + H2D of the next chunk runs while the
            # device chews on the dispatch above
            nxt = ship(groups[gi + 1])

    P = len(names)
    merged = jax.tree.map(lambda *xs: jnp.concatenate(xs)[:P], *outs)
    return {k: np.asarray(v) for k, v in merged.items()}
