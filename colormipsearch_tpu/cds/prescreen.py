"""Prescreen: a provable upper bound on pixel-match scores.

Two-phase exact search (ROADMAP item 1). Phase 1 bounds every
(mask, target) pair's best-variant score with one matmul; only
pairs whose bound clears the keep threshold (score > 0 and
ratio > pctPositivePixels/100, ColorMIPSearch.java:42-46) reach the
exact active-tile kernel. Phase 2 is unchanged, so results are
bit-identical with the screen on or off.

The bound: quantize each pixel's hue state into B_SECT x NB bins
(sector, ratio decile). For any shift/mirror variant,

  score = sum_p [qsel(p)] [tsel(p+o)] [gap-ok(q(p), t(p+o))]
       <= sum_{tiles τ} sum_{bins j} u[τ, j] * w01[τ, j]

where u[τ, j] counts query pixels of bin j in 8x128 tile τ, and
w01[τ, j] = 1 iff the shift-expanded tile τ⊕xyshift contains ANY
above-threshold target pixel whose bin is gap-compatible with j (the
compat relation is a superset of the exact predicate by interval
arithmetic over bin edges — see compat_matrix). The right side is the
inner product of a per-mask feature vector and a per-target 0/1 feature
vector: bounds for a (mask block x target block) are one
[B, F] @ [F, T] matmul, F = ntiles * n_bins. Mirror variants use the
same u against features of the x-flipped target.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .pixel_kernel import PAIR_K9

# ratio bins per sector. Bin width 1/NB must stay >= zTolerance
# (compat_matrix asserts); finer bins shrink the compat relation's
# relative breadth (same-sector compat spans bins within zTol, so the
# compatible fraction is ~(1 + 2*NB*zTol)/NB) at linear feature-size
# cost — the single biggest tightness lever for dense-overlap pairs.
NB = int(__import__("os").environ.get("CMS_PRESCREEN_NB", "10"))
N_SECT = 6
N_BINS = N_SECT * NB
TILE_H = 8
TILE_W = 128
# spatial feature granularity: SUBTILE_H x SUBTILE_W cells of the frame
# (SUBTILE_H divides TILE_H, SUBTILE_W divides TILE_W so cells tile the
# 8x128 feature tiles exactly). The exact kernel's shifts reach only
# +-xyShift (2) pixels, so a coarse presence cell lets target signal far
# from a query pixel validate it; finer cells cut that spatial slack at
# linear feature-size cost. Counts per cell stay <= SUBTILE_H*SUBTILE_W
# <= 128, which bf16 represents exactly — the bound matmul runs in bf16
# with f32 accumulation (exact: integer products, partial sums < 2^24).
SUBTILE_W = int(__import__("os").environ.get("CMS_PRESCREEN_SUBW", "16"))
SUBTILE_H = int(__import__("os").environ.get("CMS_PRESCREEN_SUBH", "8"))
assert TILE_H % SUBTILE_H == 0 and TILE_W % SUBTILE_W == 0


def _cell_grid(grid_hw):
    """(rows, cols) of the cell grid for a (gh, gw) 8x128-tile grid."""
    gh, gw = grid_hw
    return gh * (TILE_H // SUBTILE_H), gw * (TILE_W // SUBTILE_W)


@functools.lru_cache(maxsize=8)
def compat_matrix(zt9: int) -> np.ndarray:
    """bool [N_BINS, N_BINS]: could ANY query pixel in bin jq match ANY
    target pixel in bin jt under the exact gap predicate? Computed with
    interval arithmetic over bin edges, erring on the inclusive side.

    Exact predicate recap (AbstractColorDepthSearchAlgorithm.java:260-388):
    - same sector: |r1 - r2| <= zTol, both ratios > 0
    - adjacent (lo, lo+1): side preconditions and
        lo odd:  r_lo-side < c_lo, r_hi-side < c_hi, r1 + r2 <= 2K + zTol
        lo even: both > 0.8,                      r1 + r2 >= 2K - zTol
      with (c_lo, c_hi) = (0.44, 0.54) for pair (1,2) and 0.7/0.7 for
      pairs (3,4), (5,6).
    """
    zt = zt9 / 1e9
    if zt > 1.0 / NB:
        raise ValueError("zTolerance exceeds the prescreen bin width")
    delta = 1.0 / NB
    compat = np.zeros((N_BINS, N_BINS), dtype=bool)

    def bin_range(j):
        rb = j % NB
        return rb * delta, (rb + 1) * delta  # [lo, hi)

    pair_k = {lo: PAIR_K9[lo - 1] / 1e9 for lo in range(1, 6)}
    for jq in range(N_BINS):
        sq = jq // NB + 1
        q_lo, q_hi = bin_range(jq)
        for jt in range(N_BINS):
            st = jt // NB + 1
            t_lo, t_hi = bin_range(jt)
            if sq == st:
                # |r1 - r2| <= zt possible iff intervals within zt
                # (inclusive comparisons: over-inclusion is free)
                if q_lo - zt <= t_hi and t_lo - zt <= q_hi:
                    compat[jq, jt] = True
                continue
            if abs(sq - st) != 1:
                continue
            lo = min(sq, st)
            k2 = 2 * pair_k[lo]
            if lo in (2, 4):
                # both ratios > 0.8 and r1 + r2 >= 2K - zt
                if q_hi >= 0.8 and t_hi >= 0.8 and q_hi + t_hi >= k2 - zt:
                    compat[jq, jt] = True
            else:
                if lo == 1:
                    c_q = 0.44 if sq == 1 else 0.54
                    c_t = 0.44 if st == 1 else 0.54
                else:
                    c_q = c_t = 0.7
                # both below their cutoffs and r1 + r2 <= 2K + zt
                if q_lo <= c_q and t_lo <= c_t and q_lo + t_lo <= k2 + zt:
                    compat[jq, jt] = True
    return compat


def bin_plane_from_words(words, xp=jnp):
    """Per-pixel bin id in [0, N_BINS) or -1 for unselected/no-sector
    pixels. `words` are packed scorer words (pixel_kernel layout)."""
    b = words & 0xFF
    a = (words >> 8) & 0xFF
    s = (words >> 16) & 0x7
    sel = (words >> 19) & 1
    # rbin via integer arithmetic: floor(a/b * NB) (b >= 1); clamp to NB-1
    rb = xp.minimum((a * NB) // xp.maximum(b, 1), NB - 1)
    bins = (s - 1) * NB + rb
    return xp.where((sel > 0) & (s > 0), bins, -1)


def query_features(words: np.ndarray) -> np.ndarray:
    """[npos * N_BINS] subtile-bin counts for a query (host);
    npos = cell-grid rows x cols row-major positions (_cell_grid).
    uint8 when the cell size guarantees counts <= 255 (4x cheaper to
    upload/store than f32; the bound matmul upcasts on device)."""
    h, w = words.shape
    gh = -(-h // TILE_H)
    gw = -(-w // TILE_W)
    ghn, gwn = _cell_grid((gh, gw))
    padded = np.full((gh * TILE_H, gw * TILE_W), -1, dtype=np.int64)
    padded[:h, :w] = bin_plane_from_words(words.astype(np.int64), xp=np)
    tiles = padded.reshape(ghn, SUBTILE_H, gwn, SUBTILE_W).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(ghn * gwn, SUBTILE_H * SUBTILE_W)
    dt = np.uint8 if SUBTILE_H * SUBTILE_W <= 255 else np.float32
    feats = np.zeros((ghn * gwn, N_BINS), dtype=dt)
    for j in range(N_BINS):
        feats[:, j] = (tiles == j).sum(axis=1).astype(dt)
    return feats.reshape(-1)


@functools.partial(jax.jit,
                   static_argnames=("zt9", "xy_shift", "grid_hw", "flip"))
def target_features(t_words, zt9: int, xy_shift: int, grid_hw,
                    flip: bool = False) -> jnp.ndarray:
    """f32 [T, ntiles * N_BINS] compat-presence features (device).

    t_words: [T, H, W] packed target planes (unpadded frame).
    w01[τ, j] = 1 iff the (tile ⊕ xy_shift) region holds a target pixel
    whose bin k has compat[j, k]. flip=True computes the features of the
    x-mirrored frame (fused in-jit: the flipped frame is never
    materialized in HBM).
    """
    gh, gw = grid_hw
    tsz, h, w = t_words.shape
    pad = max(xy_shift, 0)
    # bin presence as int32 bitmask planes (30 bins per plane): one
    # OR-reduction over the expanded tile replaces N_BINS boolean passes
    words2 = _bitmask_planes(t_words, flip)  # [T, N_PLANES, H, W]
    if pad:
        # rectangular OR-dilation is separable: two 1-D passes do
        # 2*(2p+1) reads/px instead of (2p+1)^2
        words2 = jax.lax.reduce_window(
            words2, 0, jax.lax.bitwise_or,
            (1, 1, 2 * pad + 1, 1), (1, 1, 1, 1), "same")
        words2 = jax.lax.reduce_window(
            words2, 0, jax.lax.bitwise_or,
            (1, 1, 1, 2 * pad + 1), (1, 1, 1, 1), "same")
    ghn, gwn = _cell_grid(grid_hw)
    padded = jnp.zeros((tsz, N_PLANES, gh * TILE_H, gw * TILE_W), jnp.int32)
    padded = padded.at[:, :, :h, :w].set(words2)
    tiles = padded.reshape(tsz, N_PLANES, ghn, SUBTILE_H, gwn, SUBTILE_W)
    tile_or = jax.lax.reduce(tiles, np.int32(0), jax.lax.bitwise_or, (3, 5))
    tile_or = tile_or.reshape(tsz, N_PLANES, ghn * gwn)  # [T, P, npos]
    w01 = _compat_presence(_presence_from_bits(tile_or), zt9)     # [T, npos, J]
    # bf16 halves feature memory; exact because the stored values are
    # 0/1 (and the matched query counts are <= 256)
    dt = jnp.bfloat16 if SUBTILE_H * SUBTILE_W <= 256 else jnp.float32
    return w01.astype(dt).reshape(tsz, -1)


N_PLANES = -(-N_BINS // 30)  # 30 presence bits per int32 plane


def _bitmask_planes(t_words, flip: bool):
    """[T, N_PLANES, H, W] int32 bin-presence bitmask planes (bins
    packed 30 per plane), undilated."""
    if flip:
        t_words = t_words[:, :, ::-1]
    bins = bin_plane_from_words(t_words)
    valid = bins >= 0
    planes = []
    for p in range(N_PLANES):
        lo, hi = 30 * p, 30 * (p + 1)
        here = valid & (bins >= lo) & (bins < hi)
        planes.append(jnp.where(
            here, jnp.int32(1) << jnp.where(here, bins - lo, 0), 0))
    return jnp.stack(planes, axis=1)


def _presence_from_bits(tile_or):
    """[T, npos, N_BINS] bf16 0/1 presence from [T, N_PLANES, npos]
    bitmasks."""
    k_ids = jnp.arange(30, dtype=jnp.int32)
    parts = [(tile_or[:, p, :, None] >> k_ids) & 1 for p in range(N_PLANES)]
    return jnp.concatenate(parts, axis=-1)[..., :N_BINS].astype(jnp.bfloat16)


def _compat_presence(pres, zt9: int):
    """[..., N_BINS] bool: any present bin compatible with each query bin.
    bf16 0/1 operands and f32 accumulation make the product exact (sums
    <= N_BINS) whatever the platform's default matmul precision."""
    compat = jnp.asarray(compat_matrix(zt9), jnp.bfloat16)       # [J, K]
    return jnp.matmul(pres, compat.T, preferred_element_type=jnp.float32) > 0


def _sliding_cell_stats(t_words, flip: bool, pad: int, grid_hw):
    """Sliding-window (SUBTILE_H x SUBTILE_W) statistics over the
    pad-ringed tile-aligned frame, computed ONCE, sliced per offset:
      or_full  [T, P, Hc-SUBTILE_H+1, Wc-SUBTILE_W+1]  presence bitmasks
      cnt_full [T,    Hc-SUBTILE_H+1, Wc-SUBTILE_W+1]  bin-valid counts
    (separable two-pass reductions; replaces one full reduce per offset).
    """
    gh, gw = grid_hw
    tsz, h, w = t_words.shape
    words2 = _bitmask_planes(t_words, flip)               # [T, 2, H, W]
    hc = gh * TILE_H + 2 * pad
    wc = gw * TILE_W + 2 * pad
    canvas = jnp.zeros((tsz, N_PLANES, hc, wc), jnp.int32)
    canvas = canvas.at[:, :, pad:pad + h, pad:pad + w].set(words2)
    cnt = (jax.lax.reduce(canvas, np.int32(0), jax.lax.bitwise_or, (1,))
           != 0).astype(jnp.int32)
    or_full = jax.lax.reduce_window(
        canvas, 0, jax.lax.bitwise_or,
        (1, 1, SUBTILE_H, 1), (1, 1, 1, 1), "valid")
    or_full = jax.lax.reduce_window(
        or_full, 0, jax.lax.bitwise_or,
        (1, 1, 1, SUBTILE_W), (1, 1, 1, 1), "valid")
    cnt_full = jax.lax.reduce_window(
        cnt, 0, jax.lax.add, (1, SUBTILE_H, 1), (1, 1, 1), "valid")
    cnt_full = jax.lax.reduce_window(
        cnt_full, 0, jax.lax.add, (1, 1, SUBTILE_W), (1, 1, 1), "valid")
    return or_full, cnt_full


def _cell_slice(full, pad: int, dx: int, dy: int, grid_hw):
    """Strided slice picking the cell grid shifted by (dx, dy)."""
    ghn, gwn = _cell_grid(grid_hw)
    r0, c0 = pad + dy, pad + dx
    lead = full.ndim - 2
    start = (0,) * lead + (r0, c0)
    stop = full.shape[:lead] + (r0 + (ghn - 1) * SUBTILE_H + 1,
                                c0 + (gwn - 1) * SUBTILE_W + 1)
    strides = (1,) * lead + (SUBTILE_H, SUBTILE_W)
    out = jax.lax.slice(full, start, stop, strides)
    return out.reshape(full.shape[:lead - 1] + (-1, ghn * gwn))


@functools.partial(jax.jit, static_argnames=("zt9", "offsets", "grid_hw",
                                             "flip"))
def _variant_block_bounds_capped(u3, t_words, zt9: int, offsets, grid_hw,
                                 flip: bool) -> jnp.ndarray:
    """Count-capped per-offset-max upper bounds [B, T'].

    Strictly tighter than _variant_block_bounds: with one GLOBAL offset
    o the sampling map p -> p+o is injective, so a cell's contribution
    is also bounded by the number of bin-valid target pixels in the
    shifted cell:

      score_o <= sum_C min( sum_j u[C, j] * w01[C+o, j],  tcnt[C+o] )

    The presence bound alone lets ONE compatible target pixel validate
    up to SUBTILE_H*SUBTILE_W query pixels of its cell; the count cap
    removes exactly that slack, which dominates for the sparse-overlap
    pairs that make up most of a diverse library. All arithmetic is
    integer-exact (counts <= SUBTILE_H*SUBTILE_W in bf16, f32 accum,
    partial sums < 2^24), so the bound never rounds below the score.
    """
    tsz = t_words.shape[0]
    pad = max((max(abs(dx), abs(dy)) for dx, dy in offsets), default=0)
    or_full, cnt_full = _sliding_cell_stats(t_words, flip, pad, grid_hw)
    ub = u3.astype(jnp.bfloat16)              # [B, npos, N_BINS], exact
    bsz, npos = ub.shape[0], ub.shape[1]
    # chunk the per-cell [B, T', chunk] temp to ~128 MB
    chunk = max(1, min(npos, (128 << 20) // max(bsz * tsz * 4, 1)))
    best = None
    for dx, dy in offsets:
        tile_or = _cell_slice(or_full, pad, dx, dy, grid_hw)  # [T, P, npos]
        cnts = _cell_slice(cnt_full, pad, dx, dy, grid_hw)    # [T, npos]
        pres = _presence_from_bits(tile_or)                   # [T, npos, K]
        w01 = _compat_presence(pres, zt9).astype(jnp.bfloat16)  # [T,npos,J]
        cnts_f = cnts.astype(jnp.float32)
        bound_o = jnp.zeros((bsz, tsz), jnp.float32)
        for p0 in range(0, npos, chunk):
            s = jnp.einsum("bpj,tpj->btp",
                           ub[:, p0:p0 + chunk], w01[:, p0:p0 + chunk],
                           preferred_element_type=jnp.float32)
            capped = jnp.minimum(s, cnts_f[None, :, p0:p0 + chunk])
            bound_o = bound_o + capped.sum(axis=2)
        best = bound_o if best is None else jnp.maximum(best, bound_o)
    return best


@functools.partial(jax.jit, static_argnames=("zt9", "offsets", "grid_hw",
                                             "flip"))
def _variant_block_bounds(u, t_words, zt9: int, offsets, grid_hw,
                          flip: bool) -> jnp.ndarray:
    """Per-variant-max upper bounds [B, T'] for one target block.

    Tighter than the dilated single bound: for each shift offset
    o=(dx,dy) the exact kernel samples t(p.y+dy, p.x+dx), so
      score_o <= sum_C sum_j u[C, j] * [compat px present in C + (dy,dx)]
    and score = max_o score_o. The dilated bound lets every query PIXEL
    pick its own offset from the (2s+1)^2 window; taking the max of
    per-offset bounds enforces one global offset, which prunes pairs
    whose cells only match under inconsistent shifts. Per-offset
    features stay jit-internal (never materialized in HBM).
    """
    gh, gw = grid_hw
    tsz, h, w = t_words.shape
    words2 = _bitmask_planes(t_words, flip)
    pad = max((max(abs(dx), abs(dy)) for dx, dy in offsets), default=0)
    ghn, gwn = _cell_grid(grid_hw)
    # one padded canvas; each offset is a static slice of it
    canvas = jnp.zeros((tsz, N_PLANES, gh * TILE_H + 2 * pad,
                        gw * TILE_W + 2 * pad), jnp.int32)
    canvas = canvas.at[:, :, pad:pad + h, pad:pad + w].set(words2)
    ub = u.astype(jnp.bfloat16)  # exact: integer counts <= 256
    best = None
    for dx, dy in offsets:
        sh = canvas[:, :, pad + dy:pad + dy + gh * TILE_H,
                    pad + dx:pad + dx + gw * TILE_W]
        tiles = sh.reshape(tsz, N_PLANES, ghn, SUBTILE_H, gwn, SUBTILE_W)
        tile_or = jax.lax.reduce(tiles, np.int32(0), jax.lax.bitwise_or,
                                 (3, 5)).reshape(tsz, N_PLANES, ghn * gwn)
        pres = _presence_from_bits(tile_or)                       # [T,np,K]
        w01 = _compat_presence(pres, zt9).astype(jnp.bfloat16)
        b = jnp.matmul(ub, w01.reshape(tsz, -1).T,
                       preferred_element_type=jnp.float32)        # [B, T']
        best = b if best is None else jnp.maximum(best, b)
    return best


@jax.jit
def _bounds_matmul(u, wd, wm):
    # The bound must never round BELOW the true value or a matching pair
    # could be wrongly screened out. Exactness argument: inputs are
    # integer-valued (subtile-bin counts <= 256, 0/1 weights), products
    # are exact in bf16/f32, the matmul accumulates in f32, and every
    # partial sum < 2^24. bf16 features take the bf16 path with f32
    # accumulation; f32 features ask for full f32 precision (a GPU would
    # otherwise run an f32 matmul in TF32).
    if wd.dtype == jnp.bfloat16:
        ub = u.astype(jnp.bfloat16)  # exact: counts <= 256
        bd = jnp.matmul(ub, wd.T, preferred_element_type=jnp.float32)
        bm = jnp.matmul(ub, wm.T, preferred_element_type=jnp.float32)
    else:
        u = u.astype(jnp.float32)
        hp = jax.lax.Precision.HIGHEST
        bd = jnp.matmul(u, wd.T, precision=hp)
        bm = jnp.matmul(u, wm.T, precision=hp)
    return jnp.maximum(bd, bm)


class PairPrescreen:
    """Block-level screen: survivors(mask, targets) -> boolean [T].

    Target features are computed on device (the dilations/reductions are
    image-sized). The bound matmul [B, F] @ [F, T] (F ~ 43K) runs on the
    device by default — pulling only the [B, T] bounds to host instead of
    the ~F*4-bytes-per-target feature matrix; `device=False` keeps the
    original host-NumPy path (used when features must cross hosts)."""

    def __init__(self, zt9: int, xy_shift: int, height: int, width: int,
                 device: bool = True):
        self.zt9 = zt9
        self.xy_shift = xy_shift
        self.grid_hw = (-(-height // TILE_H), -(-width // TILE_W))
        self.height = height
        self.width = width
        self.device = device

    # feature sub-block: bounds the multi-GB bin-plane temporaries of
    # target_features (padded planes are ~6 MB/target x several temps)
    FEATURE_BLOCK = 64

    def target_features(self, t_words, t_words_flipped=None):
        """Compat-presence features for both orientations, computed in
        target sub-blocks to bound device temp memory. When
        t_words_flipped is None the mirror features come from an in-jit
        flip (no materialized flipped frame)."""
        tsz = t_words.shape[0]
        blk = self.FEATURE_BLOCK
        outs_d, outs_m = [], []
        for i in range(0, tsz, blk):
            wd_blk = t_words[i:i + blk]
            outs_d.append(target_features(wd_blk, self.zt9, self.xy_shift,
                                          self.grid_hw))
            if t_words_flipped is None:
                outs_m.append(target_features(wd_blk, self.zt9,
                                              self.xy_shift, self.grid_hw,
                                              flip=True))
            else:
                outs_m.append(target_features(t_words_flipped[i:i + blk],
                                              self.zt9, self.xy_shift,
                                              self.grid_hw))
        wd = outs_d[0] if len(outs_d) == 1 else jnp.concatenate(outs_d)
        wm = outs_m[0] if len(outs_m) == 1 else jnp.concatenate(outs_m)
        if self.device:
            return wd, wm  # stay device-resident for the bound matmul
        return (np.asarray(wd).astype(np.float32),
                np.asarray(wm).astype(np.float32))

    def query_features(self, words: np.ndarray) -> np.ndarray:
        return query_features(words)

    def bounds(self, u_block: np.ndarray, tfeats) -> np.ndarray:
        wd, wm = tfeats
        if self.device:
            return np.asarray(_bounds_matmul(jnp.asarray(u_block), wd, wm))
        return np.maximum(u_block @ wd.T, u_block @ wm.T)

    # count-capped per-cell bound (default; CMS_PRESCREEN_CAP=0 reverts
    # to the pure presence bound for comparison)
    USE_COUNT_CAP = __import__("os").environ.get(
        "CMS_PRESCREEN_CAP", "1") == "1"

    def bounds_from_words(self, u_matrix, t_words, device=None) -> np.ndarray:
        """Variant-consistent bounds [B, T] straight from packed words.

        Tighter than target_features + bounds (see
        _variant_block_bounds_capped) and never materializes target
        features in HBM; computed in FEATURE_BLOCK target sub-blocks
        padded to one static shape. `device` pins the computation to one
        local device (multi-device sweeps screen each target shard on
        the device that will score it)."""
        import contextlib
        ctx = (jax.default_device(device) if device is not None
               else contextlib.nullcontext())
        offsets = _ring_offsets(self.xy_shift)
        with ctx:
            u_dev = jnp.asarray(u_matrix)
            if self.USE_COUNT_CAP:
                u_dev = u_dev.reshape(u_dev.shape[0], -1, N_BINS)
            tsz = t_words.shape[0]
            blk = self.FEATURE_BLOCK
            outs = []
            shorts = []
            for i in range(0, tsz, blk):
                wb = t_words[i:i + blk]
                short = blk - wb.shape[0]
                if short:  # pad to the one compiled shape; word 0 = unsel
                    wb = jnp.concatenate(
                        [wb, jnp.zeros((short,) + wb.shape[1:], wb.dtype)])
                fn = (_variant_block_bounds_capped if self.USE_COUNT_CAP
                      else _variant_block_bounds)
                bd = fn(u_dev, wb, self.zt9, offsets, self.grid_hw, False)
                bm = fn(u_dev, wb, self.zt9, offsets, self.grid_hw, True)
                # keep per-block bounds on device; ONE batched pull at the
                # end (a per-block np.asarray would serialize every block
                # behind a device round-trip)
                outs.append(jnp.maximum(bd, bm))
                shorts.append(short)
        hosts = jax.device_get(outs)
        return np.concatenate(
            [b[:, :blk - s] if s else b for b, s in zip(hosts, shorts)],
            axis=1)


@functools.lru_cache(maxsize=8)
def _ring_offsets(xy_shift: int):
    from .oracle import shift_ring_offsets
    return tuple(shift_ring_offsets(xy_shift))
