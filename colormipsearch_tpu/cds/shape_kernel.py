"""Shape/gradient scorer kernel: dense, batched, fused XLA.

Accelerator re-design of Shape2DMatchColorDepthSearchAlgorithm
(cds/Shape2DMatchColorDepthSearchAlgorithm.java:23-247). The reference
evaluates two lazy-closure image folds per match per orientation; here a
match is two fused elementwise+reduce passes over precomputed integer
planes:

query side (once per mask, host/NumPy — see shape_oracle.py):
  q_nonzero, q_slice (depth-slice numbers via the precomputed LUT),
  q_mask, high_expr
target side (once per target, cacheable):
  grad (u16), z_nonzero, z_slice, t_above

Mirror-pass equivalence (proof in shape_oracle.py): the mirrored
orientation only flips the gradient plane (gap sum) and the target plane
(high-expression sum), so both orientations run over the same query
planes: 4 reductions total, fully fused by XLA.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

GAP_THRESHOLD = 3


@functools.partial(jax.jit, static_argnames=("mirror",))
def shape_score_kernel(q_nonzero, q_slice, q_mask, high_expr,
                       grad, z_nonzero, z_slice, t_above,
                       mirror: bool) -> Tuple[jnp.ndarray, ...]:
    """Batched shape scores: query planes [H, W], target planes [T, H, W].

    Returns per-ROW int32 partial sums [T, H] for (gaps_id, high_id,
    gaps_m, high_m). Per-pixel gaps are bounded by max(slice-gap 215,
    q_mask*grad <= 65535), so a full-image sum can exceed int32
    (~4.5e10) but a row sum cannot (1210 * 65535 < 2^31); the final
    cross-row accumulation happens on host in int64
    (finish_shape_scores), keeping the device kernel pure int32.
    """
    q_nonzero = q_nonzero[None]
    q_slice = q_slice.astype(jnp.int32)[None]
    q_mask = q_mask.astype(jnp.int32)[None]
    high_expr = high_expr.astype(bool)[None]

    grad = grad.astype(jnp.int32)
    z_slice = z_slice.astype(jnp.int32)

    def gap_rows(grad_plane):
        both = q_nonzero & z_nonzero
        sg = jnp.abs(q_slice - z_slice)
        sg = jnp.where(q_slice == 0, z_slice, sg)
        sg = jnp.where(z_slice == 0, 0, sg)
        default = q_mask * grad_plane
        gap = jnp.where(both & (sg - 40 >= 40), sg - 40, default)
        gap = jnp.where(gap > GAP_THRESHOLD, gap, 0)
        return gap.sum(axis=2, dtype=jnp.int32)  # [T, H] row sums

    def high_rows(t_above_plane):
        return (high_expr & t_above_plane).sum(axis=2, dtype=jnp.int32)

    gaps_id = gap_rows(grad)
    high_id = high_rows(t_above)
    if mirror:
        gaps_m = gap_rows(grad[:, :, ::-1])
        high_m = high_rows(t_above[:, :, ::-1])
    else:
        gaps_m = gaps_id
        high_m = high_id
    return gaps_id, high_id, gaps_m, high_m


@functools.partial(jax.jit, static_argnames=("r0", "r1", "mirror"))
def shape_score_stacked(q_nonzero, q_slice, q_mask, high_expr,
                        t_above_list, grad_list, znz_list, zsl_list,
                        *, r0: int, r1: int, mirror: bool):
    """ONE device dispatch per batch: stack per-target planes, crop to
    the query's active row band, score.

    The naive path (host-side jnp.stack of cached per-target crops +
    kernel call) issues ~6 ops per target per batch, each paying the
    per-dispatch latency. Here the stack/crop/score pipeline is
    a single XLA program: per-target planes come in as a pytree of
    [H, W] device arrays and everything after is fused. Compile count
    is bounded by (batch size, 64-row crop bucket, mirror) — the same
    static space the kernel already had."""
    q_nonzero = q_nonzero[r0:r1]
    q_slice = q_slice[r0:r1]
    q_mask = q_mask[r0:r1]
    high_expr = high_expr[r0:r1]
    grad = jnp.stack(grad_list)[:, r0:r1]
    znz = jnp.stack(znz_list)[:, r0:r1]
    zsl = jnp.stack(zsl_list)[:, r0:r1]
    tab = jnp.stack(t_above_list)[:, r0:r1]
    return shape_score_kernel(q_nonzero, q_slice, q_mask, high_expr,
                              grad, znz, zsl, tab, mirror=mirror)


def finish_shape_scores(gaps_id, high_id, gaps_m, high_m, mirror: bool):
    """Host-side final reduction and orientation choice
    (Shape2DMatchColorDepthSearchAlgorithm.java:171-185: keep the mirrored
    result only when its combined score is strictly lower)."""
    gaps_id = np.asarray(gaps_id, dtype=np.int64).sum(axis=1)
    high_id = np.asarray(high_id, dtype=np.int64).sum(axis=1)
    score_id = gaps_id + high_id // 3
    if not mirror:
        return gaps_id, high_id, score_id, np.zeros(len(gaps_id), dtype=bool)
    gaps_m = np.asarray(gaps_m, dtype=np.int64).sum(axis=1)
    high_m = np.asarray(high_m, dtype=np.int64).sum(axis=1)
    score_m = gaps_m + high_m // 3
    use_m = score_m < score_id
    gaps = np.where(use_m, gaps_m, gaps_id)
    high = np.where(use_m, high_m, high_id)
    score = np.where(use_m, score_m, score_id)
    return gaps, high, score, use_m
