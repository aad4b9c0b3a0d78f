"""Reference-exact NumPy oracle for the pixel-match CDS scorer.

This module is the conformance anchor: a vectorized float64 NumPy
re-statement of the reference's scalar Java inner loops, used to

1. reproduce the reference's golden scores exactly
   (PixelMatchColorDepthSearchAlgorithmTest: 87 / 439 / 414 / 515 / 483 / 426),
2. act as the oracle that every device kernel is validated against.

Reference behavior reproduced here (citations into /root/reference):
- hue-sector pixel gap: cds/AbstractColorDepthSearchAlgorithm.java:157-390
- mask position extraction (threshold + excluded label regions):
  cds/AbstractColorDepthSearchAlgorithm.java:96-126
- xy-shift rings / mirroring / max over variants:
  cds/PixelMatchColorDepthSearchAlgorithm.java:113-158,221-263
- negative-query subtraction: cds/PixelMatchColorDepthSearchAlgorithm.java:195-217

Float64 NumPy ops are IEEE-754, identical to Java doubles, so the scalar
arithmetic here matches the reference bit-for-bit.

Hue sectors (channel-order classes), numbered as in the reference:
  1=BR (blue max, red 2nd)   2=BG   3=GB   4=GR   5=RG   6=RB
Adjacent sectors share boundary constants:
  pair (1,2): BrBg=0.354862745   (both ratios below 0.44/0.54)
  pair (2,3): BgGb=0.996078431   (both ratios above 0.8)
  pair (3,4): GbGr=0.505882353   (both below 0.7)
  pair (4,5): GrRg=0.996078431   (both above 0.8)
  pair (5,6): RgRb=0.505882353   (both below 0.7)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..imageproc.io import Image
from .scores import PixelMatchScore

BR_BG = 0.354862745
BG_GB = 0.996078431
GB_GR = 0.505882353
GR_RG = 0.996078431
RG_RB = 0.505882353

NO_MATCH_GAP = 10000.0

# per-pair boundary constant indexed by lower sector (1..5)
_PAIR_K = {1: BR_BG, 2: BG_GB, 3: GB_GR, 4: GR_RG, 5: RG_RB}


def sector_and_ratio(r: np.ndarray, g: np.ndarray, b: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Classify pixels into hue sectors and compute channel ratios.

    Returns (sector int32 in 0..6, ratio float64). Sector 0 means "no
    sector" (ties / black), which can never match. Ratio is
    second_channel / first_channel, or 0.0 when either channel is zero —
    exactly the reference's semantics
    (AbstractColorDepthSearchAlgorithm.java:195-257).
    """
    r = r.astype(np.int64)
    g = g.astype(np.int64)
    b = b.astype(np.int64)

    sector = np.zeros(r.shape, dtype=np.int32)
    first = np.zeros(r.shape, dtype=np.int64)
    second = np.zeros(r.shape, dtype=np.int64)

    b_max = (b > r) & (b > g)
    g_max = (g > b) & (g > r)
    r_max = (r > b) & (r > g)

    # blue max: sector 1 (BR) if r>g else 2 (BG)
    s1 = b_max & (r > g)
    s2 = b_max & ~(r > g)
    # green max: sector 3 (GB) if b>r else 4 (GR)
    s3 = g_max & (b > r)
    s4 = g_max & ~(b > r)
    # red max: sector 5 (RG) if g>b else 6 (RB)
    s5 = r_max & (g > b)
    s6 = r_max & ~(g > b)

    for s, sel, f, sec in ((1, s1, b, r), (2, s2, b, g), (3, s3, g, b),
                           (4, s4, g, r), (5, s5, r, g), (6, s6, r, b)):
        sector = np.where(sel, s, sector)
        first = np.where(sel, f, first)
        second = np.where(sel, sec, second)

    ratio = np.zeros(r.shape, dtype=np.float64)
    ok = (first != 0) & (second != 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(ok, second.astype(np.float64) / first.astype(np.float64), 0.0)
    return sector, ratio


def pixel_gap_f64(rgb1: Tuple[np.ndarray, np.ndarray, np.ndarray],
                  rgb2: Tuple[np.ndarray, np.ndarray, np.ndarray]) -> np.ndarray:
    """Vectorized calculatePixelGap (AbstractColorDepthSearchAlgorithm.java:157-390).

    rgb1 is the mask-side pixel, rgb2 the target-side. Returns float64 gaps;
    10000 means incomparable.
    """
    s1, q1 = sector_and_ratio(*rgb1)
    s2, q2 = sector_and_ratio(*rgb2)
    return _gap_from_sectors(s1, q1, s2, q2)


def _gap_from_sectors(s1, q1, s2, q2) -> np.ndarray:
    gap = np.full(s1.shape, NO_MATCH_GAP, dtype=np.float64)

    # same sector: gap = |q2 - q1| if both ratios > 0
    same = (s1 == s2) & (s1 > 0) & (q1 > 0) & (q2 > 0)
    gap = np.where(same, np.abs(q2 - q1), gap)
    # (the reference's `ratio == 255` saturation branch is dead code:
    #  ratios are <= 1 by construction)

    # adjacent sectors
    for lo in (1, 2, 3, 4, 5):
        hi = lo + 1
        k = _PAIR_K[lo]
        fwd = (s1 == lo) & (s2 == hi)
        bwd = (s1 == hi) & (s2 == lo)
        adj = fwd | bwd
        if lo == 1:
            # BR<->BG: BR-side ratio < 0.44, BG-side ratio < 0.54
            cond = (fwd & (q1 < 0.44) & (q2 < 0.54)) | (bwd & (q1 < 0.54) & (q2 < 0.44))
            val = (q1 - k) + (q2 - k)
        elif lo in (2, 4):
            cond = adj & (q1 > 0.8) & (q2 > 0.8)
            val = (k - q1) + (k - q2)
        else:  # lo in (3, 5): both below 0.7
            cond = adj & (q1 < 0.7) & (q2 < 0.7)
            val = (q1 - k) + (q2 - k)
        gap = np.where(cond, val, gap)
    return gap


def mask_positions(image: Image, threshold: int,
                   excluded: Optional[np.ndarray] = None) -> np.ndarray:
    """Flat indices of pixels above threshold outside excluded regions
    (getMaskPosArray, AbstractColorDepthSearchAlgorithm.java:96-126)."""
    rgb = image.rgb_i32()
    sel = (rgb > threshold).any(axis=2)
    if excluded is not None:
        sel &= ~excluded
    ys, xs = np.nonzero(sel)
    return ys * image.width + xs


def shift_ring_offsets(xyshift: int) -> list:
    """(dx, dy) shift variants for an even xyshift.

    The reference emits, for each ring i in {2,4,..,xyshift}, the 9 combos
    xx,yy in {-i,0,i} INCLUDING (0,0) (PixelMatchColorDepthSearchAlgorithm
    .java:113-130) — but sizes the array as 1+(xyshift/2)*8, which only
    holds for xyshift in {0, 2}; xyshift >= 4 overflows in the reference.
    We generalize: rings of 8 offsets plus a single (0,0), which is
    identical to the reference for xyshift in {0, 2} (the production and
    golden-test settings) and well-defined beyond.
    """
    if xyshift % 2 == 1:
        raise ValueError("XY shift parameter must be an even number.")
    offsets = [(0, 0)]
    for i in range(2, xyshift + 1, 2):
        for xx in (-i, 0, i):
            for yy in (-i, 0, i):
                if (xx, yy) != (0, 0):
                    offsets.append((xx, yy))
    return offsets


def _second_first(sector, r, g, b):
    """(numerator a, denominator b) of the sector ratio as int64; a==0
    encodes the reference's zero-ratio sentinel."""
    first = np.choose(np.clip(sector, 1, 6) - 1, [b, b, g, g, r, r])
    second = np.choose(np.clip(sector, 1, 6) - 1, [r, g, b, r, g, b])
    a = np.where((first != 0) & (second != 0), second, 0)
    return a, np.maximum(first, 1)


def match_exact_rational(s1, a1, b1, s2, a2, b2, zt9: int) -> np.ndarray:
    """The framework's normative match predicate, over exact rationals
    (int64 host arithmetic; identical to the device kernels).

    Semantics match the reference's double evaluation everywhere except
    exact rational ties (|r1 - r2| == zTol precisely, e.g. 50/100 vs
    51/100 at zTol 0.01), where IEEE rounding makes Java's result depend
    on the operands; this predicate deterministically counts ties as
    matches (<=). No reference golden is affected (asserted in tests).
    """
    p = b1 * b2
    diff = np.abs(a2 * b1 - a1 * b2)
    same_ok = (s1 == s2) & (s1 > 0) & (a1 > 0) & (a2 > 0) \
        & (diff * 1_000_000_000 <= zt9 * p)

    up = s2 == s1 + 1
    down = s1 == s2 + 1
    adj = (up | down) & (np.minimum(s1, s2) > 0)
    lo = np.where(up, s1, s2)
    lt044 = a1 * 25 < 11 * b1
    lt054 = a1 * 50 < 27 * b1
    lt07_1 = a1 * 10 < 7 * b1
    gt08_1 = a1 * 5 > 4 * b1
    t_lt044 = a2 * 25 < 11 * b2
    t_lt054 = a2 * 50 < 27 * b2
    lt07_2 = a2 * 10 < 7 * b2
    gt08_2 = a2 * 5 > 4 * b2
    u = a1 * b2 + a2 * b1
    adj_ok = np.zeros_like(adj)
    for lo_s, k9 in zip((1, 2, 3, 4, 5),
                        (BR_BG, BG_GB, GB_GR, GR_RG, RG_RB)):
        k9i = round(k9 * 1e9)
        pair = adj & (lo == lo_s)
        if lo_s == 1:
            cond = np.where(s1 == 1, lt044, lt054) \
                & np.where(s2 == 1, t_lt044, t_lt054)
        elif lo_s in (2, 4):
            cond = gt08_1 & gt08_2
        else:
            cond = lt07_1 & lt07_2
        if lo_s in (2, 4):
            gap_ok = u * 1_000_000_000 >= max(2 * k9i - zt9, 0) * p
        else:
            gap_ok = u * 1_000_000_000 <= (2 * k9i + zt9) * p
        adj_ok = adj_ok | (pair & cond & gap_ok)
    return same_ok | adj_ok


@dataclass
class _QueryData:
    xs: np.ndarray          # mask-selected x coords
    ys: np.ndarray          # mask-selected y coords
    rgb: Tuple[np.ndarray, np.ndarray, np.ndarray]   # mask pixel channels (int64)
    sector: np.ndarray
    ratio: np.ndarray


class PixelMatchOracle:
    """Reference-exact pixel match scorer for one query (mask) image.

    Mirrors PixelMatchColorDepthSearchAlgorithm
    (cds/PixelMatchColorDepthSearchAlgorithm.java:20-265).
    """

    def __init__(self, query: Image, query_threshold: int,
                 mirror_query: bool,
                 target_threshold: int, z_tolerance: float, xy_shift: int,
                 excluded_regions: Optional[np.ndarray] = None,
                 neg_query: Optional[Image] = None,
                 neg_query_threshold: int = 0,
                 mirror_neg_query: bool = False,
                 java_double_semantics: bool = False,
                 java_neg_query_pairing: bool = False):
        self.query = query
        self.mirror_query = mirror_query
        self.target_threshold = target_threshold
        self.z_tolerance = z_tolerance
        self.zt9 = round(z_tolerance * 1_000_000_000)
        # java_double_semantics replays the reference's IEEE-double gap
        # comparison exactly; the default exact-rational predicate agrees
        # except at exact rational ties (see match_exact_rational)
        self.java_double_semantics = java_double_semantics
        self.shifts = shift_ring_offsets(xy_shift)
        self.excluded = excluded_regions

        self._q = self._prepare(query, query_threshold)
        self._neg_q = (self._prepare(neg_query, neg_query_threshold)
                       if neg_query is not None else None)
        self.mirror_neg_query = mirror_neg_query and neg_query is not None
        # faithful replay of the reference's negative-query pairing
        # quirk: calculateMatchingScore scores the negative pass with the
        # POSITIVE query's pixel positions as src positions over the
        # NEGATIVE query's image and shifted target positions, truncated
        # to min(len) (PixelMatchColorDepthSearchAlgorithm.java:195-217 +
        # :238-263 calculateScore srcPositions/targetPositions zip). The
        # default pairs the negative query's own pixels with its own
        # positions (the arithmetically-intended form; negative queries
        # are unused in production).
        self.java_neg_query_pairing = java_neg_query_pairing
        self._neg_image = neg_query

    def _prepare(self, image: Image, threshold: int) -> _QueryData:
        pos = mask_positions(image, threshold, self.excluded)
        w = image.width
        xs = pos % w
        ys = pos // w
        rgb = image.rgb_i32()
        r = rgb[ys, xs, 0].astype(np.int64)
        g = rgb[ys, xs, 1].astype(np.int64)
        b = rgb[ys, xs, 2].astype(np.int64)
        sector, ratio = sector_and_ratio(r, g, b)
        return _QueryData(xs=xs, ys=ys, rgb=(r, g, b), sector=sector, ratio=ratio)

    @property
    def query_size(self) -> int:
        return len(self._q.xs)

    def _score_variants(self, q: _QueryData, target_rgb: np.ndarray,
                        mirrored: bool) -> int:
        """Max score over all shift variants for one orientation
        (calculateMaxScoreForAllTargetTransformations, :221-233)."""
        h, w, _ = target_rgb.shape
        best = 0
        t = target_rgb
        for dx, dy in self.shifts:
            tx = q.xs + dx
            ty = q.ys + dy
            valid = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
            if mirrored:
                # mirrorMask applies x -> (w-1) - x AFTER the shift (:146-158)
                sx = np.where(valid, (w - 1) - tx, 0)
            else:
                sx = np.where(valid, tx, 0)
            sy = np.where(valid, ty, 0)
            r2 = t[sy, sx, 0].astype(np.int64)
            g2 = t[sy, sx, 1].astype(np.int64)
            b2 = t[sy, sx, 2].astype(np.int64)
            above = (r2 > self.target_threshold) | (g2 > self.target_threshold) \
                | (b2 > self.target_threshold)
            s2, q2 = sector_and_ratio(r2, g2, b2)
            if self.java_double_semantics:
                gap = _gap_from_sectors(q.sector, q.ratio, s2, q2)
                ok = gap <= self.z_tolerance
            else:
                a1, b1 = _second_first(q.sector, *q.rgb)
                a2, b2d = _second_first(s2, r2, g2, b2)
                ok = match_exact_rational(q.sector, a1, b1, s2, a2, b2d,
                                          self.zt9)
            matches = valid & above & ok
            score = int(matches.sum())
            if score > best:
                best = score
        return best

    def _score_variants_java_neg(self, target_rgb: np.ndarray,
                                 mirrored: bool) -> int:
        """Reference-faithful negative pass: the i-th POSITIVE query
        position supplies the src pixel (read from the NEGATIVE image)
        and the i-th NEGATIVE position supplies the shifted/mirrored
        target position; the zip truncates to the shorter list
        (PixelMatchColorDepthSearchAlgorithm.java:238-263)."""
        q, nq = self._q, self._neg_q
        h, w, _ = target_rgb.shape
        n = min(len(q.xs), len(nq.xs))
        if n == 0:
            return 0
        neg_rgb = self._neg_image.rgb_i32()
        r1 = neg_rgb[q.ys[:n], q.xs[:n], 0].astype(np.int64)
        g1 = neg_rgb[q.ys[:n], q.xs[:n], 1].astype(np.int64)
        b1 = neg_rgb[q.ys[:n], q.xs[:n], 2].astype(np.int64)
        s1, ratio1 = sector_and_ratio(r1, g1, b1)
        best = 0
        t = target_rgb
        for dx, dy in self.shifts:
            tx = nq.xs[:n] + dx
            ty = nq.ys[:n] + dy
            valid = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
            sx = np.where(valid, (w - 1) - tx if mirrored else tx, 0)
            sy = np.where(valid, ty, 0)
            r2 = t[sy, sx, 0].astype(np.int64)
            g2 = t[sy, sx, 1].astype(np.int64)
            b2 = t[sy, sx, 2].astype(np.int64)
            above = (r2 > self.target_threshold) \
                | (g2 > self.target_threshold) \
                | (b2 > self.target_threshold)
            s2, q2 = sector_and_ratio(r2, g2, b2)
            if self.java_double_semantics:
                gap = _gap_from_sectors(s1, ratio1, s2, q2)
                ok = gap <= self.z_tolerance
            else:
                a1, bb1 = _second_first(s1, r1, g1, b1)
                a2, bb2 = _second_first(s2, r2, g2, b2)
                ok = match_exact_rational(s1, a1, bb1, s2, a2, bb2,
                                          self.zt9)
            score = int((valid & above & ok).sum())
            best = max(best, score)
        return best

    def score(self, target: Image) -> PixelMatchScore:
        """calculateMatchingScore (PixelMatchColorDepthSearchAlgorithm.java:166-219)."""
        if self.query_size == 0:
            return PixelMatchScore(0, 0.0, False)
        if target.shape != self.query.shape:
            raise ValueError(
                f"Invalid image size - target {target.shape} vs query {self.query.shape}")
        t = target.rgb_i32()
        max_pixels = self._score_variants(self._q, t, mirrored=False)
        best_mirrored = False
        if self.mirror_query:
            mirror_score = self._score_variants(self._q, t, mirrored=True)
            if mirror_score > max_pixels:
                max_pixels = mirror_score
                best_mirrored = True
        ratio = float(max_pixels) / float(self.query_size)
        if self._neg_q is not None and len(self._neg_q.xs) > 0:
            # NB: the reference pairs the POSITIVE query's pixel values with
            # the negative query's shifted positions (a faithful quirk;
            # PixelMatchColorDepthSearchAlgorithm.java:195-217 passes
            # queryPixelPositions() as src positions with negQueryImage).
            # Negative queries are not used in production; we reproduce the
            # subtraction arithmetic with the negative query's own pixels.
            # java_neg_query_pairing=True replays the reference quirk
            # verbatim instead (see __init__).
            if self.java_neg_query_pairing:
                neg_best = self._score_variants_java_neg(t, mirrored=False)
                if self.mirror_neg_query:
                    neg_best = max(neg_best,
                                   self._score_variants_java_neg(
                                       t, mirrored=True))
            else:
                neg_best = self._score_variants(self._neg_q, t,
                                                mirrored=False)
                if self.mirror_neg_query:
                    neg_best = max(neg_best, self._score_variants(
                        self._neg_q, t, mirrored=True))
            neg_size = len(self._neg_q.xs)
            max_pixels = int(round(float(max_pixels)
                                   - float(neg_best) * self.query_size / float(neg_size)))
            ratio -= float(neg_best) / float(neg_size)
        return PixelMatchScore(max_pixels, ratio, best_mirrored)
