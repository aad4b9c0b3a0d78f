"""Active-tile exact pixel-match scorer: the GPU hot path.

Neuron masks cover a few percent of the 1210x566 frame. The dense XLA
kernel (pixel_kernel.py) pays for every pixel of every pair; this scorer
touches only each mask's ACTIVE tiles, and only for the (mask, target)
pairs that survive the prescreen (prescreen.py):

- Host decomposes each mask's packed query plane into TILE_H x TILE_W
  tiles and keeps those holding a selected pixel. The tiles of every
  mask of a sweep go into ONE flat table (tiles, origins) with a
  per-mask (first tile, tile count) span.
- Targets are packed once per partition into a frame padded by the
  shift radius (pack_targets' layout, rounded up to whole tiles) plus
  its x-flipped copy for the mirror variants.
- ONE kernel launch scores a flat survivor list [(mask, target)] that
  spans many masks. Each program owns one pair: it loads its own
  indices, loops over its mask's active tiles, reads every shift
  variant's window straight from the frame at an unaligned offset,
  evaluates the exact integer predicate and writes its per-variant
  int32 sums once. Nothing carries across programs.

The kernel is Pallas through Triton (`backend="triton"`), compiled for
CUDA GPUs, with an interpret mode for CPU tests. `tile_sums_xla` is the
same computation in plain XLA (a vmapped dynamic-slice gather); it is
the reference the kernel is checked and timed against.

Exactness is identical to the dense kernel: the same integer hue-gap
predicate (pixel_kernel.match_unpacked), validated against the oracle
goldens in tests.

Reference counterpart: the scalar position-list loop in
cds/PixelMatchColorDepthSearchAlgorithm.java:221-263 (and its thread-
pool fan-out, cmd/cdsprocess/LocalColorMIPSearchProcessor.java:93-112).
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..imageproc.io import Image
from .oracle import shift_ring_offsets
from .pixel_kernel import (QueryPlanes, _unpack, match_unpacked, pack_planes,
                           prepare_query_planes, z_tolerance_to_zt9)

# 32x32 tiles cover the fixture masks' selected pixels with ~3x fewer
# wasted lanes than 8x128 strips (thin fibres run in every direction);
# Triton blocks must be powers of two.
TILE_H = 32
TILE_W = 32

# targets per device-side pack program (bounds the int32 temporaries of
# one dense pack); CMS_DEVICE_BLOCK tunes it. CMS_SPARSE_FEED=0 uploads
# whole frames instead of above-threshold pixels. Both wait for a
# measurement on the card (ROADMAP A2).
DEVICE_BLOCK = int(__import__("os").environ.get("CMS_DEVICE_BLOCK", "64"))
SPARSE_FEED = __import__("os").environ.get("CMS_SPARSE_FEED", "1") == "1"


@dataclass
class ActiveTiles:
    """Host-prepared active-tile decomposition of one query."""
    q_tiles: np.ndarray   # int32 [n_active, TILE_H, TILE_W] packed words
    origins: np.ndarray   # int32 [n_active, 2] tile (row, col) origin
    n_active: int
    query_size: int
    height: int
    width: int


def build_active_tiles(planes: QueryPlanes) -> ActiveTiles:
    """Decompose packed query planes into the tiles holding a selected
    pixel. Pixels past the frame edge pad as word 0 (never selected)."""
    words = planes.words
    h, w = words.shape
    gh, gw = -(-h // TILE_H), -(-w // TILE_W)
    padded = np.zeros((gh * TILE_H, gw * TILE_W), dtype=np.int32)
    padded[:h, :w] = words
    tiles = padded.reshape(gh, TILE_H, gw, TILE_W).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(gh * gw, TILE_H, TILE_W)
    idx = np.nonzero(((tiles >> 19) & 1).any(axis=(1, 2)))[0]
    ty, tx = np.divmod(idx, gw)
    origins = np.stack([ty * TILE_H, tx * TILE_W], axis=1).astype(np.int32)
    return ActiveTiles(q_tiles=np.ascontiguousarray(tiles[idx]),
                       origins=origins.reshape(-1, 2), n_active=len(idx),
                       query_size=planes.query_size, height=h, width=w)


def frame_shape(height: int, width: int, pad: int) -> Tuple[int, int]:
    """Padded target frame: every tile window of every shift in bounds."""
    return (-(-height // TILE_H) * TILE_H + 2 * pad,
            -(-width // TILE_W) * TILE_W + 2 * pad)


def _dev_ctx(device):
    """Placement context: arrays created/jitted inside go to `device`
    (None = the process default device)."""
    return (jax.default_device(device) if device is not None
            else contextlib.nullcontext())


def check_platform(interpret: bool, device=None) -> None:
    """Interpret mode is for CPU tests only; the compiled kernel needs a
    CUDA GPU. Neither case falls back to the other."""
    platform = (device.platform if device is not None
                else jax.devices()[0].platform)
    if interpret and platform == "gpu":
        raise RuntimeError("Pallas interpret mode was requested on a GPU; "
                           "the compiled kernel runs there")
    if not interpret and platform != "gpu":
        raise RuntimeError(
            f"the active-tile kernel compiles only for CUDA GPUs, not for "
            f"platform {platform!r}; use the dense engine (or interpret "
            f"mode in tests)")


# --- the kernel -------------------------------------------------------

def _n_out(n_variants: int) -> int:
    """Output row width: Triton stores power-of-two blocks."""
    return max(8, 1 << (n_variants - 1).bit_length())


def _make_kernel(shifts, pad: int, zt9: int, mirror: bool, nvp: int):
    n_frames = 2 if mirror else 1
    n_var = n_frames * len(shifts)

    def kernel(pairs_ref, spans_ref, org_ref, q_ref, td_ref, tm_ref, out_ref):
        i = pl.program_id(0)
        m = pairs_ref[i, 0]
        t = pairs_ref[i, 1]
        start = spans_ref[m, 0]
        count = spans_ref[m, 1]

        def tile(k, acc):
            j = start + k
            r0 = org_ref[j, 0] + pad
            c0 = org_ref[j, 1] + pad
            q = _unpack(q_ref[j])
            acc = list(acc)
            for f, frame in enumerate((td_ref, tm_ref)[:n_frames]):
                for s, (dx, dy) in enumerate(shifts):
                    w = frame[t, pl.ds(r0 + dy, TILE_H),
                              pl.ds(c0 + dx, TILE_W)]
                    v = f * len(shifts) + s
                    hit = match_unpacked(q, _unpack(w), zt9)
                    acc[v] = acc[v] + jnp.sum(hit.astype(jnp.int32))
            return tuple(acc)

        acc = jax.lax.fori_loop(0, count, tile,
                                (jnp.int32(0),) * n_var)
        lane = jax.lax.broadcasted_iota(jnp.int32, (nvp,), 0)
        row = jnp.zeros((nvp,), jnp.int32)
        for v, a in enumerate(acc):
            row = jnp.where(lane == v, a, row)
        out_ref[...] = row

    return kernel


@functools.partial(jax.jit, static_argnames=("shifts", "pad", "zt9",
                                             "mirror", "interpret"))
def tile_sums(pairs, spans, origins, q_tiles, t_padded, t_flipped, *,
              shifts, pad: int, zt9: int, mirror: bool, interpret: bool):
    """Per-variant match counts [P, nvp] int32 for survivor pairs.

    pairs [P, 2] (mask, target) rows; spans [M+1, 2] (first tile, tile
    count) per mask, row M the empty sentinel for padding pairs;
    origins/q_tiles the flat tile table (packed query words);
    t_padded/t_flipped [T, Hp, Wp] frames. Columns [0, S) are the direct
    shifts, [S, 2S) the mirrored ones when mirror is set; the rest is 0.
    """
    n_var = (2 if mirror else 1) * len(shifts)
    nvp = _n_out(n_var)
    return pl.pallas_call(
        _make_kernel(shifts, pad, zt9, mirror, nvp),
        grid=(pairs.shape[0],),
        out_specs=pl.BlockSpec((None, nvp), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((pairs.shape[0], nvp), jnp.int32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="active_tile_sums",
    )(pairs, spans, origins, q_tiles, t_padded, t_flipped)


@functools.partial(jax.jit, static_argnames=("shifts", "pad", "zt9",
                                             "mirror", "k_max"))
def tile_sums_xla(pairs, spans, origins, q_tiles, t_padded, t_flipped, *,
                  shifts, pad: int, zt9: int, mirror: bool, k_max: int):
    """Plain-XLA version of tile_sums: every pair's tiles (padded to
    k_max, the largest span) gathered by a vmapped dynamic_slice, the
    same predicate, a sum. Same output layout."""
    m, t = pairs[:, 0], pairs[:, 1]
    start, count = spans[m, 0], spans[m, 1]
    k = jnp.arange(k_max, dtype=jnp.int32)
    valid = k[None, :] < count[:, None]                  # [P, K]
    j = jnp.where(valid, start[:, None] + k[None, :], 0)
    q = _unpack(q_tiles[j])                              # [P, K, TH, TW]
    r0 = origins[j, 0] + pad
    c0 = origins[j, 1] + pad
    tt = jnp.broadcast_to(t[:, None], j.shape)
    sums = []
    for frame in (t_padded, t_flipped)[:2 if mirror else 1]:
        for dx, dy in shifts:
            def window(ti, r, c, frame=frame, dx=dx, dy=dy):
                return jax.lax.dynamic_slice(
                    frame, (ti, r + dy, c + dx), (1, TILE_H, TILE_W))[0]
            w = jax.vmap(jax.vmap(window))(tt, r0, c0)  # [P, K, TH, TW]
            hit = match_unpacked(q, _unpack(w), zt9) & valid[..., None, None]
            sums.append(hit.sum(axis=(1, 2, 3), dtype=jnp.int32))
    out = jnp.stack(sums, axis=1)
    return jnp.pad(out, ((0, 0), (0, _n_out(len(sums)) - len(sums))))


# --- target packing ----------------------------------------------------

@functools.partial(jax.jit, static_argnames=("n_flat",))
def _scatter_words(idx, vals, n_flat):
    # empty/sub-threshold pixels pack to word 1 (bden clamps to 1), so
    # the scatter fill is 1; padding entries repeat the last real pair
    # (same index, same value — order-independent)
    base = jnp.full((n_flat,), 1, jnp.int32)
    return base.at[idx].set(vals, indices_are_sorted=True)


@functools.partial(jax.jit, donate_argnums=(0,))
def _place_block(out, block, start):
    return jax.lax.dynamic_update_slice(
        out, block, (start,) + (0,) * (out.ndim - 1))


@functools.partial(jax.jit, static_argnames=("threshold",))
def _pack_dense(t_u8, threshold: int):
    r = t_u8[..., 0].astype(jnp.int32)
    g = t_u8[..., 1].astype(jnp.int32)
    b = t_u8[..., 2].astype(jnp.int32)
    above = (r > threshold) | (g > threshold) | (b > threshold)
    return pack_planes(r, g, b, above, jnp)


@functools.partial(jax.jit, static_argnames=("spec",))
def _frames(words, spec):
    # the flip acts on the raw w-wide plane BEFORE the asymmetric round-up
    # padding, so mirror sampling maps to t[w-1-x-dx] exactly as in the
    # dense kernel's symmetric frame
    return (jnp.pad(words, spec, constant_values=1),
            jnp.pad(words[:, :, ::-1], spec, constant_values=1))


def pack_words(targets_u8, threshold: int, device=None,
               sparse: Optional[bool] = None):
    """Device-packed [T, H, W] scorer words (unpadded frame); also the
    input of the prescreen bounds. CDM frames are a few percent
    occupied, so by default only (flat index, word) pairs of the
    above-threshold pixels cross to the device and a scatter rebuilds
    the frame (sub-threshold words canonicalize to the empty word 1,
    which every consumer gates out through the sel bit). Dense blocks
    upload whole, in DEVICE_BLOCK-target programs."""
    from ..native.mipops import sparse_pack_block
    tsz, h, w = targets_u8.shape[:3]
    sparse = SPARSE_FEED if sparse is None else sparse
    sparse = (sparse and isinstance(targets_u8, np.ndarray)
              and targets_u8.dtype == np.uint8)

    def block(tb):
        if sparse:
            idx, vals = sparse_pack_block(tb, threshold)
            n = len(idx)
            if n <= tb.size // 12:  # a quarter of the pixels or fewer
                cap = max(4096, 1 << int(np.ceil(np.log2(max(n, 1)))))
                idx_p = np.full(cap, idx[-1] if n else 0, np.int32)
                vals_p = np.full(cap, vals[-1] if n else 1, np.int32)
                idx_p[:n] = idx
                vals_p[:n] = vals
                return _scatter_words(jnp.asarray(idx_p), jnp.asarray(vals_p),
                                      tb.shape[0] * h * w
                                      ).reshape(tb.shape[:3])
        return _pack_dense(jnp.asarray(tb), threshold)

    with _dev_ctx(device):
        if tsz <= DEVICE_BLOCK:
            return block(targets_u8)
        out = jnp.zeros((tsz, h, w), jnp.int32)
        for i in range(0, tsz, DEVICE_BLOCK):
            out = _place_block(out, block(targets_u8[i:i + DEVICE_BLOCK]), i)
        return out


def frames_from_words(words, pad: int, device=None):
    """(padded, x-flipped) [T, Hp, Wp] scoring frames from raw words."""
    tsz, h, w = words.shape
    hp, wp = frame_shape(h, w, pad)
    spec = ((0, 0), (pad, hp - h - pad), (pad, wp - w - pad))
    with _dev_ctx(device):
        if tsz <= DEVICE_BLOCK:
            return _frames(words, spec)
        padded = jnp.zeros((tsz, hp, wp), jnp.int32)
        flipped = jnp.zeros((tsz, hp, wp), jnp.int32)
        for i in range(0, tsz, DEVICE_BLOCK):
            pb, fb = _frames(words[i:i + DEVICE_BLOCK], spec)
            padded = _place_block(padded, pb, i)
            flipped = _place_block(flipped, fb, i)
        return padded, flipped


# --- engines ------------------------------------------------------------

class ActiveTilePixelEngine:
    """Active-tile pixel-match scorer for one query.

    Same scoring semantics and API as pixel_kernel.PixelMatchEngine;
    targets must be packed with this engine's prepare_targets.
    """

    def __init__(self, query: Image, query_threshold: int, mirror_query: bool,
                 target_threshold: int, pix_color_fluctuation: float,
                 xy_shift: int, excluded: Optional[np.ndarray] = None,
                 interpret: bool = False):
        self.planes = prepare_query_planes(query, query_threshold, excluded)
        self.tiles = build_active_tiles(self.planes)
        self.mirror_query = mirror_query
        self.target_threshold = target_threshold
        self.zt9 = z_tolerance_to_zt9(pix_color_fluctuation)
        self.xy_shift = xy_shift
        self.pad = max(xy_shift, 1)
        self.shifts = tuple(shift_ring_offsets(xy_shift))
        self.interpret = interpret
        self._scorer = None

    def pack_raw_words(self, targets_u8, device=None):
        return pack_words(targets_u8, self.target_threshold, device)

    def pad_from_words(self, words, device=None):
        return frames_from_words(words, self.pad, device)

    def prepare_targets(self, targets_u8, device=None):
        return self.pad_from_words(self.pack_raw_words(targets_u8, device),
                                   device)

    def score_packed(self, packed, survivors=None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(scores int64 [T], ratios f64 [T], mirrored bool [T]);
        targets zeroed in the optional survivors bitmap are not scored
        and report 0."""
        tsz = packed[0].shape[0]
        keep = (np.ones(tsz, bool) if survivors is None
                else np.asarray(survivors) != 0)
        pairs = np.stack([np.zeros(int(keep.sum()), np.int64),
                          np.nonzero(keep)[0]], axis=1)
        if self._scorer is None:
            self._scorer = TileScorer([self], interpret=self.interpret)
        best, mirrored = self._scorer.collect(
            [(self._scorer.launch(packed, pairs), pairs)], 1, tsz)
        scores, mirrored = best[0], mirrored[0]
        if self.tiles.query_size == 0:
            return scores, np.zeros(tsz), mirrored
        return scores, scores / float(self.tiles.query_size), mirrored

    def score_batch(self, targets_u8: np.ndarray):
        return self.score_packed(self.prepare_targets(targets_u8))


def _bucket(n: int) -> int:
    """Pair-count bucket: few distinct kernel shapes, < 2x padding."""
    return max(64, 1 << (max(n, 1) - 1).bit_length())


class TileScorer:
    """Exact scorer for the engines of one sweep (shared CDS params):
    one flat tile table, one kernel launch per survivor list."""

    def __init__(self, engines: Sequence[ActiveTilePixelEngine],
                 interpret: bool = False):
        e0 = engines[0]
        for e in engines:
            if (e.zt9, e.shifts, e.mirror_query) != (e0.zt9, e0.shifts,
                                                     e0.mirror_query):
                raise ValueError("engines of one sweep must share the CDS "
                                 "parameters")
        self.zt9, self.shifts, self.pad = e0.zt9, e0.shifts, e0.pad
        self.mirror = e0.mirror_query
        self.interpret = interpret
        counts = np.array([e.tiles.n_active for e in engines], np.int32)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        self.spans = np.zeros((len(engines) + 1, 2), np.int32)
        self.spans[:-1, 0] = starts
        self.spans[:-1, 1] = counts
        self.k_max = int(max(counts.max(initial=0), 1))
        self.origins = np.concatenate(
            [e.tiles.origins for e in engines]
            + [np.zeros((1, 2), np.int32)])  # keeps the table non-empty
        self.q_tiles = np.concatenate(
            [e.tiles.q_tiles for e in engines]
            + [np.zeros((1, TILE_H, TILE_W), np.int32)])
        self.n_masks = len(engines)
        self._dev = {}

    def table(self, device=None):
        """(spans, origins, q_tiles) on `device`, uploaded once."""
        got = self._dev.get(device)
        if got is None:
            with _dev_ctx(device):
                got = tuple(jnp.asarray(a) for a in
                            (self.spans, self.origins, self.q_tiles))
            self._dev[device] = got
        return got

    def pad_pairs(self, pairs: np.ndarray) -> np.ndarray:
        """int32 [bucket, 2]; padding rows score the empty sentinel mask."""
        out = np.zeros((_bucket(len(pairs)), 2), np.int32)
        out[:, 0] = self.n_masks
        out[:len(pairs)] = pairs
        return out

    def launch(self, packed, pairs: np.ndarray, device=None):
        """Enqueue the exact sums of `pairs` [P, 2] (mask, target index
        into `packed`); returns the device array, or None for no pairs."""
        if len(pairs) == 0:
            return None
        check_platform(self.interpret, device)
        t_padded, t_flipped = packed
        with _dev_ctx(device):
            return tile_sums(
                jnp.asarray(self.pad_pairs(pairs)), *self.table(device),
                t_padded, t_flipped, shifts=self.shifts, pad=self.pad,
                zt9=self.zt9, mirror=self.mirror, interpret=self.interpret)

    def collect(self, launched: List[Tuple[Optional[jax.Array], np.ndarray]],
                n_masks: int, n_targets: int, target_offsets=None):
        """Drain launches with one device_get. launched: [(device sums,
        pairs)]; target_offsets shifts each launch's target indices.
        Returns (best int64 [B, T], mirrored bool [B, T]); pairs never
        scored report 0."""
        best = np.zeros((n_masks, n_targets), np.int64)
        mirrored = np.zeros((n_masks, n_targets), bool)
        hosts = jax.device_get([d for d, _ in launched if d is not None])
        hosts = iter(hosts)
        n = len(self.shifts)
        for li, (dev, pairs) in enumerate(launched):
            if dev is None:
                continue
            sums = np.asarray(next(hosts))[:len(pairs)].astype(np.int64)
            direct = sums[:, :n].max(axis=1)
            mir = sums[:, n:2 * n].max(axis=1) if self.mirror else direct
            off = 0 if target_offsets is None else target_offsets[li]
            rows, cols = pairs[:, 0], pairs[:, 1] + off
            best[rows, cols] = np.maximum(direct, mir)
            mirrored[rows, cols] = mir > direct
        return best, mirrored
