"""Dense pixel-match CDS kernel: batched, exact-integer XLA.

Accelerator re-design of the reference's sparse position-list scorer
(cds/PixelMatchColorDepthSearchAlgorithm.java:20-265). Design:

- Dense packed planes, not position lists. Each image pixel becomes one
  int32 word packing (sector, ratio numerator a, denominator b,
  selection flag, adjacency precondition flags). The hue gap test
  (AbstractColorDepthSearchAlgorithm.java:157-390) is evaluated
  branchlessly with exact int32 rational comparisons (exact_ratio.py) —
  no float drift, no data-dependent control flow, vector-friendly, one
  word of HBM traffic per pixel per side.
- The xy-shift variants (PixelMatchColorDepthSearchAlgorithm.java:113-144)
  become dynamic slices of a zero-padded target plane under a lax.scan
  (out-of-bounds sampling == zero pixel == fails the target threshold,
  identical to the reference's -1 position sentinel).
- Mirroring (mirrorMask, :146-158) uses the identity
    sum_p f(q(p), t(mirror(p+s))) = sum_p f(q(p), flip_x(t)(p+s))
  so the mirror pass reads a flipped copy of the packed target plane
  with the same query planes and shift set.
- Masks are batched: scores for a [B] query block against a [T] target
  block compute as one [B, T] fused map-reduce per shift; target planes
  are packed once per block and stay device-resident across query blocks
  (the HBM-residency plan in SURVEY.md §2d-P1).

Word layout (bit 0 = LSB):
  [0:8)  b  ratio denominator (max channel, >= 1)
  [8:16) a  ratio numerator (0 if either channel is 0)
  [16:19) sector 0..6
  [19]   sel: query mask-selected / target above-threshold
  [20]   cl: adjacency precondition toward sector-1 pair
  [21]   cu: adjacency precondition toward sector+1 pair
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..imageproc.io import Image
from .exact_ratio import c9_split
from .oracle import shift_ring_offsets

# boundary constants scaled by 1e9 (AbstractColorDepthSearchAlgorithm.java:183-187)
BR_BG_9 = 354_862_745
BG_GB_9 = 996_078_431
GB_GR_9 = 505_882_353
GR_RG_9 = 996_078_431
RG_RB_9 = 505_882_353
PAIR_K9 = (BR_BG_9, BG_GB_9, GB_GR_9, GR_RG_9, RG_RB_9)  # by lo sector 1..5


def z_tolerance_to_zt9(pix_color_fluctuation: float) -> int:
    """zTolerance = pixColorFluctuation / 100 as an exact 1e-9 rational
    (ColorDepthSearchAlgorithmProviderFactory.java:55-56)."""
    return round(pix_color_fluctuation * 10_000_000)


def pack_planes(r, g, b, sel, xp):
    """Pack per-pixel scorer state into one int32 word (see module doc).

    Branch structure of AbstractColorDepthSearchAlgorithm.java:195-257:
    strict max classification into 6 hue sectors; ratio = second/first
    with 0 sentinel when either channel is 0.
    """
    b_max = (b > r) & (b > g)
    g_max = (g > b) & (g > r)
    r_max = (r > b) & (r > g)
    s1 = b_max & (r > g)
    s2 = b_max & ~(r > g)
    s3 = g_max & (b > r)
    s4 = g_max & ~(b > r)
    s5 = r_max & (g > b)
    s6 = r_max & ~(g > b)
    sector = (s1 * 1 + s2 * 2 + s3 * 3 + s4 * 4 + s5 * 5 + s6 * 6).astype(xp.int32)

    first = xp.where(s1 | s2, b, xp.where(s3 | s4, g, xp.where(s5 | s6, r, 0)))
    second = xp.where(s1, r, xp.where(s2, g, xp.where(s3, b, xp.where(
        s4, r, xp.where(s5, g, xp.where(s6, b, 0))))))
    a = xp.where((first != 0) & (second != 0), second, 0).astype(xp.int32)
    bden = xp.maximum(first, 1).astype(xp.int32)

    # adjacency preconditions, resolved per own sector
    # (AbstractColorDepthSearchAlgorithm.java:260-388):
    # pair (1,2): sector-1 side < 0.44, sector-2 side < 0.54
    # pairs (2,3)/(4,5): both sides > 0.8 ; pairs (3,4)/(5,6): both < 0.7
    lt044 = a * 25 < 11 * bden
    lt054 = a * 50 < 27 * bden
    lt07 = a * 10 < 7 * bden
    gt08 = a * 5 > 4 * bden
    # cl: condition toward the (sector-1, sector) pair
    cl = ((sector == 2) & lt054) | ((sector == 3) & gt08) \
        | ((sector == 4) & lt07) | ((sector == 5) & gt08) | ((sector == 6) & lt07)
    # cu: condition toward the (sector, sector+1) pair
    cu = ((sector == 1) & lt044) | ((sector == 2) & gt08) \
        | ((sector == 3) & lt07) | ((sector == 4) & gt08) | ((sector == 5) & lt07)

    word = (bden | (a << 8) | (sector << 16)
            | (sel.astype(xp.int32) << 19)
            | (cl.astype(xp.int32) << 20)
            | (cu.astype(xp.int32) << 21))
    return word.astype(xp.int32)


def _unpack(word):
    b = word & 0xFF
    a = (word >> 8) & 0xFF
    s = (word >> 16) & 0x7
    sel = (word >> 19) & 1
    cl = (word >> 20) & 1
    cu = (word >> 21) & 1
    return b, a, s, sel, cl, cu


def _leq_geq_chain(u, v, q, r_hi, r_lo):
    """Shared staging for exact u/v <=|>= C9/1e9 with per-pixel constants
    (see exact_ratio.py for the int32 range proof). Returns (leq, geq).
    Boolean algebra only, so it lowers inside Pallas kernels too."""
    d = u * 1000 - q * v
    e = d * 15625 - r_hi * v
    in_d = (d >= 0) & (d <= 65601)
    in_e = (e >= 0) & (e <= 65601)
    e_band = 64 * jnp.where(in_e, e, 0)
    rv = r_lo * v
    leq_e = (e < 0) | (in_e & (e_band <= rv))
    geq_e = (e >= 0) & ((e_band >= rv) | ~in_e)
    leq = (d < 0) | (in_d & leq_e)
    geq = (d >= 0) & (geq_e | ~in_d)
    return leq, geq


def _select_by_lo(lo, values):
    """values[lo-1] via selects (lo in 1..5)."""
    out = jnp.full_like(lo, values[0])
    for i in (2, 3, 4, 5):
        out = jnp.where(lo == i, values[i - 1], out)
    return out


def _match_general(q, t, zt9: int):
    """Exact per-pixel match predicate on unpacked (b, a, s, sel, cl, cu)
    tuples, general two-chain staging (any zt9)."""
    b1, a1, s1, qsel, qcl, qcu = q
    b2, a2, s2, tsel, tcl, tcu = t

    p = b1 * b2
    # same sector: |a2*b1 - a1*b2| / p <= zTol, both ratios > 0
    zq, zrh, zrl = c9_split(zt9)
    diff = jnp.abs(a2 * b1 - a1 * b2)
    same_leq, _ = _leq_geq_chain(diff, p, zq, zrh, zrl)
    same_ok = (s1 == s2) & (s1 > 0) & (a1 > 0) & (a2 > 0) & same_leq

    # adjacent sectors: pair lo = min(s1, s2); preconditions cl/cu; gap:
    #   lo odd  (1,3,5): r1 + r2 <= 2K + zTol  (gap = (r1-K)+(r2-K))
    #   lo even (2,4):   r1 + r2 >= 2K - zTol  (gap = (K-r1)+(K-r2))
    up = s2 == s1 + 1     # query is the lower sector
    down = s1 == s2 + 1   # target is the lower sector
    adj = (up | down) & (jnp.minimum(s1, s2) > 0)
    lo = jnp.where(up, s1, s2)
    cond = (up & ((qcu & tcl) > 0)) | (down & ((qcl & tcu) > 0))

    leq_splits = [c9_split(2 * k + zt9) for k in PAIR_K9]
    geq_splits = [c9_split(max(2 * k - zt9, 0)) for k in PAIR_K9]
    is_even = (lo == 2) | (lo == 4)
    q_c = jnp.where(is_even, _select_by_lo(lo, [g[0] for g in geq_splits]),
                    _select_by_lo(lo, [l[0] for l in leq_splits]))
    rh_c = jnp.where(is_even, _select_by_lo(lo, [g[1] for g in geq_splits]),
                     _select_by_lo(lo, [l[1] for l in leq_splits]))
    rl_c = jnp.where(is_even, _select_by_lo(lo, [g[2] for g in geq_splits]),
                     _select_by_lo(lo, [l[2] for l in leq_splits]))
    u = a1 * b2 + a2 * b1
    leq, geq = _leq_geq_chain(u, p, q_c, rh_c, rl_c)
    gap_ok = (is_even & geq) | (~is_even & leq)
    return ((qsel & tsel) > 0) & (same_ok | (adj & cond & gap_ok))


# --- packed-constant fast predicate -----------------------------------
# The staged-quotient triple (Q, Rhi, Rlo) of every comparison constant
# fits one int32 as (Q<<20)|(Rhi<<6)|Rlo when Q <= 2047 (Rhi < 15625
# needs 14 bits, Rlo < 64 needs 6). Q = c9 // 1e6 and the largest c9 is
# 2*max(PAIR_K9) + zt9 = 1_992_156_862 + zt9, so the packing is valid
# for zt9 <= 54_000_000 (pixColorFluctuation <= 5.4 — every production
# config; 1.0/2.0 are the reference CLI values). Larger zt9 falls back
# to the general predicate. Packing lets ONE 4-select chain deliver all
# three constants (instead of three chains), and the same/adjacent cases
# share ONE staged comparison by selecting (input, constant) pairs.
_PACK_ZT9_MAX = 54_000_000


def _pack_c9(c9: int) -> int:
    q, rh, rl = c9_split(c9)
    assert q <= 2047, c9
    return (q << 20) | (rh << 6) | rl


def _match_fast(q, t, zt9: int):
    """Exact-match predicate, packed-constant form (zt9 <= _PACK_ZT9_MAX).

    Identical results to _match_general (pinned by the predicate and
    engine crosscheck tests) with ~35 fewer integer ops per (pixel,
    variant):
    - same-sector and adjacent-pair comparisons share one staged
      rational chain by selecting the (numerator, constant) inputs;
    - the per-lo constants arrive via one packed-int32 select chain.
    """
    b1, a1, s1, qsel, qcl, qcu = q
    b2, a2, s2, tsel, tcl, tcu = t
    p = b1 * b2
    x = a1 * b2
    y = a2 * b1
    same = s1 == s2
    up = s2 == s1 + 1
    down = s1 == s2 + 1
    adj = (up | down) & (jnp.minimum(s1, s2) > 0)
    lo = jnp.where(up, s1, s2)

    # merged per-lo constants: even lo compares >= (2k - zt9), odd lo
    # compares <= (2k + zt9)  [see _match_general]
    packed = [
        _pack_c9(max(2 * k - zt9, 0)) if (i % 2 == 0)
        else _pack_c9(2 * k + zt9)
        for i, k in enumerate(PAIR_K9, start=1)
    ]
    cpk = _select_by_lo(lo, packed)
    cpk = jnp.where(same, _pack_c9(zt9), cpk)
    qc = cpk >> 20
    rhc = (cpk >> 6) & 0x3FFF
    rlc = cpk & 0x3F

    # shared staged chain on selected numerator: |y-x| <= zt9*p (same)
    # vs (x+y) <=/>= c*p (adjacent)
    num = jnp.where(same, jnp.abs(y - x), x + y)
    leq, geq = _leq_geq_chain(num, p, qc, rhc, rlc)

    same_ok = same & (s1 > 0) & (a1 > 0) & (a2 > 0) & leq
    cond = (up & ((qcu & tcl) > 0)) | (down & ((qcl & tcu) > 0))
    is_even = (lo == 2) | (lo == 4)
    gap_ok = (is_even & geq) | (~is_even & leq)
    return ((qsel & tsel) > 0) & (same_ok | (adj & cond & gap_ok))


def match_unpacked(q, t, zt9: int):
    """Exact per-pixel match predicate on unpacked tuples: the
    packed-constant form inside its zt9 range, the general form beyond
    it (identical results either way)."""
    if zt9 <= _PACK_ZT9_MAX:
        return _match_fast(q, t, zt9)
    return _match_general(q, t, zt9)


def _match_words(qw, tw, zt9: int):
    """Exact per-pixel match predicate on packed words (broadcastable)."""
    return match_unpacked(_unpack(qw), _unpack(tw), zt9)


@functools.partial(jax.jit, static_argnames=("zt9", "mirror"))
def pixel_match_packed(q_words, t_padded, t_padded_flipped, shifts,
                       zt9: int, mirror: bool):
    """Scores for a query block against a target block.

    Args:
      q_words: [B, H, W] int32 packed query planes
      t_padded: [T, H+2p, W+2p] int32 packed target planes (zero padded)
      t_padded_flipped: same, flipped in x (pass t_padded when mirror=False)
      shifts: [S, 2] int32 (dx, dy) shift offsets
      returns (best [B, T] i32, mirrored [B, T] bool)
    """
    bsz, h, w = q_words.shape
    tsz = t_padded.shape[0]
    pad_h = t_padded.shape[1] - h
    pad_w = t_padded.shape[2] - w
    pad = pad_w // 2
    assert pad_h == pad_w, "symmetric padding expected"

    q = q_words[:, None]  # [B, 1, H, W]

    def variant_scores(t_plane, dx, dy):
        sl = jax.lax.dynamic_slice(
            t_plane, (0, pad + dy, pad + dx), (tsz, h, w))
        m = _match_words(q, sl[None], zt9)
        return m.sum(axis=(2, 3), dtype=jnp.int32)  # [B, T]

    def body(carry, shift):
        best_d, best_m = carry
        dx, dy = shift[0], shift[1]
        best_d = jnp.maximum(best_d, variant_scores(t_padded, dx, dy))
        if mirror:
            best_m = jnp.maximum(best_m, variant_scores(t_padded_flipped, dx, dy))
        return (best_d, best_m), None

    init = (jnp.zeros((bsz, tsz), jnp.int32), jnp.zeros((bsz, tsz), jnp.int32))
    (best_d, best_m), _ = jax.lax.scan(body, init, shifts)
    if mirror:
        best = jnp.maximum(best_d, best_m)
        is_mirrored = best_m > best_d
    else:
        best = best_d
        is_mirrored = jnp.zeros_like(best_d, dtype=bool)
    return best, is_mirrored


@functools.partial(jax.jit, static_argnames=("target_threshold", "pad"))
def pack_targets(t_rgb_u8, target_threshold: int, pad: int):
    """Pack a u8 RGB target batch [T, H, W, 3] into padded plane + flip."""
    r = t_rgb_u8[..., 0].astype(jnp.int32)
    g = t_rgb_u8[..., 1].astype(jnp.int32)
    b = t_rgb_u8[..., 2].astype(jnp.int32)
    above = (r > target_threshold) | (g > target_threshold) | (b > target_threshold)
    words = pack_planes(r, g, b, above, jnp)
    padded = jnp.pad(words, ((0, 0), (pad, pad), (pad, pad)),
                     constant_values=1)  # b=1, sel=0: never matches
    return padded, padded[:, :, ::-1]


@dataclass
class QueryPlanes:
    """Host-prepared packed query planes for one mask."""
    words: np.ndarray  # int32 [H, W]
    query_size: int
    height: int
    width: int


def prepare_query_planes(query: Image, query_threshold: int,
                         excluded: Optional[np.ndarray] = None) -> QueryPlanes:
    """Host-side query prep (getMaskPosArray dense analogue,
    AbstractColorDepthSearchAlgorithm.java:96-126). Uses the native
    mipops packer when available (parity asserted in tests)."""
    from ..native import pack_planes_native
    rgb = query.rgb_i32()
    qsel = (rgb > query_threshold).any(axis=2)
    if excluded is not None:
        qsel = qsel & ~excluded
    words = pack_planes_native(rgb.astype(np.uint8), query_threshold,
                               excluded)
    if words is None:
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        words = pack_planes(r, g, b, qsel, np)
    return QueryPlanes(words=words, query_size=int(qsel.sum()),
                       height=query.height, width=query.width)


class PixelMatchEngine:
    """One query vs device-resident target batches.

    Mirrors ColorMIPSearch + PixelMatchColorDepthSearchAlgorithm for a
    single mask; for multi-mask blocked sweeps use parallel.sweep.
    """

    def __init__(self, query: Image, query_threshold: int, mirror_query: bool,
                 target_threshold: int, pix_color_fluctuation: float,
                 xy_shift: int, excluded: Optional[np.ndarray] = None):
        self.planes = prepare_query_planes(query, query_threshold, excluded)
        self.mirror_query = mirror_query
        self.target_threshold = target_threshold
        self.zt9 = z_tolerance_to_zt9(pix_color_fluctuation)
        self.xy_shift = xy_shift
        self.shifts = np.asarray(shift_ring_offsets(xy_shift), dtype=np.int32)
        self.pad = max(xy_shift, 1)

    def prepare_targets(self, targets_u8: np.ndarray):
        """Pack + pad a target batch on device; reusable across queries."""
        return pack_targets(jnp.asarray(targets_u8), self.target_threshold,
                            self.pad)

    def score_packed(self, packed_targets) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        t_padded, t_flipped = packed_targets
        best, mirrored = pixel_match_packed(
            jnp.asarray(self.planes.words)[None], t_padded, t_flipped,
            jnp.asarray(self.shifts), zt9=self.zt9, mirror=self.mirror_query)
        best = np.asarray(best[0])
        mirrored = np.asarray(mirrored[0])
        if self.planes.query_size == 0:
            best = np.zeros_like(best)
            return best, np.zeros_like(best, dtype=np.float64), mirrored
        ratios = best.astype(np.float64) / float(self.planes.query_size)
        return best, ratios, mirrored

    def score_batch(self, targets_u8: np.ndarray):
        """targets_u8: [T, H, W, 3] uint8. Returns (scores, ratios, mirrored)."""
        return self.score_packed(self.prepare_targets(targets_u8))
