"""Banded chain DP as a Pallas kernel for NVIDIA GPUs (Triton route).

The XLA ``lax.scan`` formulation (ops/chain.py::_dp_scan) launches
several kernels per anchor step and rewrites every band window in device
memory between steps.  This kernel walks the whole anchor axis in one
in-kernel loop and keeps each fragment column's band window on-chip.

Layout: anchor grids are transposed to [PF, NL] so each DP step reads
one contiguous [NL] row.  NL is the *lane* axis: every fragment column
is an independent recurrence, so callers stack many pairs' fragment rows
side by side (see ops/chain.py::chain_pairs) and the sequential PF walk
is paid once per batch.  Each program owns ``LANE_BLOCK`` lanes, one
per thread; programs share nothing, so they run in any order.

The band window is a ring of ``ring`` slots per lane (``band`` rounded
up to a power of two, as Triton wants power-of-two tensor shapes): step
``t`` writes slot ``t % ring``, and slots whose recency is ``band`` or
more are masked out.  Semantics are bit-identical to _dp_scan (tested in
tests/test_device_chain.py and on the card by chip_smoke.py).

Packed meta layout (must match ops/chain.py): qcid[30:17] rcid[16:3]
rev[1] valid[0] — chain-compatibility of two anchors is equality of
``meta >> 1`` (same query contig, ref contig and orientation) plus both
valid bits.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..oracle.chain import ChainConfig

NEG = -1e30
# one lane per thread: each thread keeps its lane's whole ring in
# registers, so the slot reductions need no cross-thread traffic (two
# lanes per thread ran at half the speed on an H100, PERF.md)
NUM_WARPS = 4
LANE_BLOCK = 32 * NUM_WARPS


def _ring_size(band: int) -> int:
    """Ring slots: ``band`` rounded up to a power of two."""
    return 1 << max(0, (band - 1).bit_length())


def _dp_kernel(qpos_ref, rpos_ref, meta_ref, score_ref, root_ref,
               *, band: int, anchor_score: float, gap_scale: float,
               max_gap: int):
    PF, L = qpos_ref.shape
    ring = _ring_size(band)
    slot = jax.lax.broadcasted_iota(jnp.int32, (ring, L), 0)
    zero = jnp.zeros((ring, L), jnp.int32)
    win0 = (zero, zero, zero, jnp.full((ring, L), NEG, jnp.float32), zero)

    def step(t, win):
        wq, wr, wm, ws, wt = win
        cur_q = qpos_ref[t, :]
        cur_r = rpos_ref[t, :]
        cur_m = meta_ref[t, :]
        cur_valid = (cur_m & 1) == 1
        cur_rev = (cur_m & 2) == 2

        # recency of each slot: 0 = the previous anchor (t - 1)
        rec = (t - 1 - slot) & (ring - 1)
        dr = cur_r[None, :] - wr
        dq_f = cur_q[None, :] - wq
        dq = jnp.where(cur_rev[None, :], -dq_f, dq_f)
        same = ((wm >> 1) == (cur_m >> 1)[None, :]) & \
            ((wm & 1) == 1) & cur_valid[None, :]
        gap = jnp.abs(dr - dq)
        ok = same & (dr > 0) & (dq > 0) & (gap < max_gap) & (rec < band)
        cand = ws + anchor_score - gap.astype(jnp.float32) * gap_scale
        cand = jnp.where(ok, cand, NEG)
        best = jnp.max(cand, axis=0)
        extend = best > anchor_score

        # tie-break to the most recent predecessor (min recency among
        # the argmax slots; recencies are distinct, so one slot wins)
        is_best = cand == best[None, :]
        best_rec = jnp.min(jnp.where(is_best, rec, ring), axis=0)
        chosen = is_best & (rec == best_rec[None, :])
        root_best = jnp.max(jnp.where(chosen, wt, 0), axis=0)

        score_cur = jnp.where(extend, best, anchor_score).astype(jnp.float32)
        root_cur = jnp.where(extend & cur_valid, root_best, t)
        score_ref[t, :] = score_cur
        root_ref[t, :] = root_cur

        put = slot == (t & (ring - 1))
        return (jnp.where(put, cur_q[None, :], wq),
                jnp.where(put, cur_r[None, :], wr),
                jnp.where(put, cur_m[None, :], wm),
                jnp.where(put, score_cur[None, :], ws),
                jnp.where(put, root_cur[None, :], wt))

    jax.lax.fori_loop(0, PF, step, win0)


def dp_pallas(qpos_t, rpos_t, meta_t, cfg: ChainConfig,
              interpret: bool = False):
    """Run the DP over transposed grids [PF, NL] -> (score, root) [PF, NL].

    ``meta`` packs (qcid, rcid, rev, valid) as in ops/chain.py.  NL may be
    any lane count; it is padded to a LANE_BLOCK multiple with invalid
    lanes (meta 0).  The anchor axis PF needs no padding: the kernel walks
    it with a dynamic loop.

    ``interpret=True`` runs the kernel through the Pallas interpreter, so
    the GPU code path is equivalence-tested on CPU
    (tests/test_device_chain.py::test_pallas_dp_matches_scan).
    """
    PF, NL = qpos_t.shape
    pad = (-NL) % LANE_BLOCK
    if pad:
        qpos_t, rpos_t, meta_t = (jnp.pad(x, ((0, 0), (0, pad)))
                                  for x in (qpos_t, rpos_t, meta_t))
    nl_padded = NL + pad

    kern = functools.partial(
        _dp_kernel, band=cfg.chain_band, anchor_score=cfg.anchor_score,
        gap_scale=cfg.gap_cost_scale, max_gap=cfg.max_gap_length)
    block = pl.BlockSpec((PF, LANE_BLOCK), lambda i: (0, i))
    score, root = pl.pallas_call(
        kern,
        grid=(nl_padded // LANE_BLOCK,),
        out_shape=(jax.ShapeDtypeStruct((PF, nl_padded), jnp.float32),
                   jax.ShapeDtypeStruct((PF, nl_padded), jnp.int32)),
        in_specs=[block] * 3,
        out_specs=(block, block),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="chain_dp",
    )(qpos_t, rpos_t, meta_t)
    if pad:
        score = score[:, :NL]
        root = root[:, :NL]
    return score, root
