"""Mesh-sharded mask x target pair sweeps.

Accelerator-native replacement for the reference's three scale-out layers
(SURVEY.md 2d): Reactor thread pools (P1), Spark RDD partitioning (P2),
and LSF job-array static grid blocks (P3). The pair grid is
block-partitioned over a ("mask", "target") mesh via shard_map; each
device scores its (query block x target block) with the dense packed
kernel, and per-mask cross-target maxima (needed for normalization and
best-match selection) are jax.lax.pmax collectives over the "target"
axis — replacing the reference's driver-side collect()
(SparkColorMIPSearchProcessor.java:73) and Mongo-mediated reductions.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..cds.pixel_kernel import pixel_match_packed


def local_pixel_sweep(q_words, t_padded, t_flipped, shifts, zt9: int,
                      mirror: bool):
    """Single-device pair block: scores [B, T], mirrored [B, T]."""
    return pixel_match_packed(q_words, t_padded, t_flipped, shifts,
                              zt9=zt9, mirror=mirror)


def sharded_pixel_sweep(mesh: Mesh, q_words, t_padded, t_flipped, shifts,
                        zt9: int, mirror: bool
                        ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Pair sweep sharded over the mesh.

    Args:
      q_words: [B, H, W] query planes, B divisible by mesh "mask" size
      t_padded/t_flipped: [T, Hp, Wp] target planes, T divisible by
        mesh "target" size
    Returns (scores [B, T], mirrored [B, T], per_mask_max [B]) with the
    score grid sharded (mask, target) and per_mask_max replicated over
    the target axis (a cross-chip pmax).
    """

    def block(q_blk, t_blk, tf_blk, shifts_blk):
        scores, mirrored = pixel_match_packed(
            q_blk, t_blk, tf_blk, shifts_blk, zt9=zt9, mirror=mirror)
        local_max = scores.max(axis=1)
        global_max = jax.lax.pmax(local_max, axis_name="target")
        return scores, mirrored, global_max

    fn = jax.shard_map(
        block, mesh=mesh,
        in_specs=(P("mask", None, None), P("target", None, None),
                  P("target", None, None), P(None, None)),
        out_specs=(P("mask", "target"), P("mask", "target"), P("mask")),
        check_vma=False,
    )
    return jax.jit(fn)(q_words, t_padded, t_flipped, shifts)


def sharded_pixel_sweep_topk(mesh: Mesh, q_words, t_padded, t_flipped,
                             shifts, zt9: int, mirror: bool, k: int):
    """Pair sweep returning per-mask top-k survivors instead of the full
    score grid: each device keeps its local top-k (lax.top_k over its
    target shard), so only B x k x devices scores leave the device —
    the host merge finishes the global top-k. This is the device-side
    reduction the reference approximates with driver-side collect +
    sort (SparkColorMIPSearchProcessor.java:73,
    ItemsHandling.selectTopRankedElements).

    Returns (top_scores [B, P, k], top_target_idx [B, P, k], mirrored
    [B, P, k]) with P = number of target shards; global indices refer to
    the full target axis. Use merge_topk to finish on host.
    """
    t_shards = mesh.devices.shape[1]
    t_local = t_padded.shape[0] // t_shards

    def block(q_blk, t_blk, tf_blk, shifts_blk):
        scores, mirrored = pixel_match_packed(
            q_blk, t_blk, tf_blk, shifts_blk, zt9=zt9, mirror=mirror)
        kk = min(k, scores.shape[1])
        top, idx = jax.lax.top_k(scores, kk)
        shard = jax.lax.axis_index("target")
        gidx = idx + shard * t_local
        mtop = jnp.take_along_axis(mirrored, idx, axis=1)
        return top[:, None, :], gidx[:, None, :], mtop[:, None, :]

    fn = jax.shard_map(
        block, mesh=mesh,
        in_specs=(P("mask", None, None), P("target", None, None),
                  P("target", None, None), P(None, None)),
        out_specs=(P("mask", "target", None), P("mask", "target", None),
                   P("mask", "target", None)),
        check_vma=False,
    )
    return jax.jit(fn)(q_words, t_padded, t_flipped, shifts)


def merge_topk(top_scores, top_idx, top_mirrored, k: int):
    """Host-side merge of per-shard top-k into the global per-mask top-k.
    Returns (scores [B, k], target_idx [B, k], mirrored [B, k])."""
    import numpy as np
    s = np.asarray(top_scores).reshape(top_scores.shape[0], -1)
    i = np.asarray(top_idx).reshape(s.shape)
    m = np.asarray(top_mirrored).reshape(s.shape)
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    take = np.take_along_axis
    return take(s, order, 1), take(i, order, 1), take(m, order, 1)


def sharded_shape_scores(mesh: Mesh, q_nonzero, q_slice, q_mask, high_expr,
                         grad, z_nonzero, z_slice, t_above, mirror: bool):
    """Shape-score re-ranking sharded over the "target" mesh axis.

    Query planes are replicated; target planes [T, H, W] are
    target-sharded. Returns per-target (gaps, high, score, mirrored)
    plus the cross-chip minimum combined score per mask (a pmin over
    the target axis — the collective the per-mask best-match selection
    rides when a mask's matches span chips)."""
    from ..cds.shape_kernel import shape_score_kernel

    def block(qnz, qsl, qm, he, g, znz, zsl, ta):
        gaps_id, high_id, gaps_m, high_m = shape_score_kernel(
            qnz, qsl, qm, he, g, znz, zsl, ta, mirror=mirror)
        # finish per-target sums on device (int32 row sums -> totals)
        def tot(x):
            return x.sum(axis=1)
        score_id = tot(gaps_id) + tot(high_id) // 3
        score_m = tot(gaps_m) + tot(high_m) // 3
        use_m = mirror & (score_m < score_id)
        score = jnp.where(use_m, score_m, score_id)
        best_local = score.min()
        best_global = jax.lax.pmin(best_local, axis_name="target")
        return score, use_m, best_global[None]

    fn = jax.shard_map(
        block, mesh=mesh,
        in_specs=(P(), P(), P(), P(),
                  P("target", None, None), P("target", None, None),
                  P("target", None, None), P("target", None, None)),
        out_specs=(P("target"), P("target"), P(None)),
        check_vma=False,
    )
    return jax.jit(fn)(q_nonzero, q_slice, q_mask, high_expr,
                       grad, z_nonzero, z_slice, t_above)
