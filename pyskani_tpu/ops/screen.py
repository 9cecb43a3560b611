"""Device-side batched marker screening.

Device replacement for the reference's serial per-reference screen loop
(/root/reference/src/pyskani/_skani/lib.rs:616-637): ONE query's marker set
is intersected with a whole batch of reference marker sets at once.  The
marker matrix is the natural "db"-sharded tensor for multi-device scaling
(each device screens its shard of references; shortlist bitmaps are gathered
over the mesh — see pyskani_tpu.parallel).

Intersection strategy: concatenate (query, ref) marker pair-arrays, sort,
count adjacent equal pairs from different sources — exact, static-shape,
and vmappable over the reference batch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..params import MIN_MARKERS_RESCUE


def _shared_count(q_hi, q_lo, n_q, r_hi, r_lo, n_r):
    Mq = q_hi.shape[0]
    hi = jnp.concatenate([q_hi, r_hi])
    lo = jnp.concatenate([q_lo, r_lo])
    src = jnp.concatenate([jnp.zeros(Mq, jnp.int32),
                           jnp.ones(r_hi.shape[0], jnp.int32)])
    valid = jnp.concatenate([jnp.arange(Mq) < n_q,
                             jnp.arange(r_hi.shape[0]) < n_r])
    # sentinel-out invalid entries so they sort to the end
    hi = jnp.where(valid, hi, jnp.uint32(0xFFFFFFFF))
    lo = jnp.where(valid, lo, jnp.uint32(0xFFFFFFFF))
    hi, lo, src, valid = jax.lax.sort((hi, lo, src, valid), num_keys=2)
    same = (hi[1:] == hi[:-1]) & (lo[1:] == lo[:-1]) & \
        (src[1:] != src[:-1]) & valid[1:] & valid[:-1]
    return jnp.sum(same, dtype=jnp.int32)


def screen_pass(q_hi, q_lo, n_q, r_hi, r_lo, n_r, screen_val,
                *, marker_k: int, rescue_small: bool):
    """One-pair marker containment screen (jit/vmap/shard_map safe).

    The single source of truth for the screen semantics (reference
    ``check_markers_quickly``, lib.rs:623-628): containment^(1/marker_k)
    vs ``screen_val``, the <MIN_MARKERS_RESCUE rescue clause, and the
    ``screen_val <= 0`` pass-all clause.  Both :func:`screen_batch` and
    the sharded search (parallel.dist) call this, so the cutoff/rescue
    rules cannot drift between paths.  Returns (pass bool, est f32).
    """
    shared = _shared_count(q_hi, q_lo, n_q, r_hi, r_lo, n_r)
    ratio = shared.astype(jnp.float32) / \
        jnp.maximum(n_q.astype(jnp.float32), 1.0)
    est = ratio ** (1.0 / marker_k)
    est = jnp.where((n_q > 0) & (n_r > 0), est, 0.0)
    passes = est > screen_val
    if rescue_small:
        passes = passes | (n_r < MIN_MARKERS_RESCUE)
    passes = passes | (jnp.asarray(screen_val) <= 0.0)
    return passes, est


@functools.partial(jax.jit, static_argnames=("marker_k", "rescue_small"))
def screen_batch(
    q_hi, q_lo, n_q,                 # query marker set (sorted unique)
    refs_hi, refs_lo, refs_n,        # [N, M] batch of reference marker sets
    screen_val,                      # scalar threshold (fraction)
    *, marker_k: int, rescue_small: bool,
):
    """Returns (pass [N] bool, est [N] f32) for one query vs N references."""
    return jax.vmap(
        lambda rh, rl, rn: screen_pass(
            q_hi, q_lo, n_q, rh, rl, rn, screen_val,
            marker_k=marker_k, rescue_small=rescue_small)
    )(refs_hi, refs_lo, refs_n)
