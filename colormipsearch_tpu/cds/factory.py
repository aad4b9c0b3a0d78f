"""Algorithm factories — the library-facing construction API.

Counterpart of cds/ColorDepthSearchAlgorithmProviderFactory.java:30-127
and the ColorMIPSearch facade (cds/ColorMIPSearch.java:12-47): one place
that applies the reference's parameter conventions (zTolerance =
pixColorFluctuation / 100, even xyShift validation, label-region
exclusion) and picks the right engine for the platform.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..imageproc.io import Image
from ..imageproc.regions import label_regions_mask, no_regions_mask


def create_pixel_match_engine(query: Image,
                              query_threshold: int = 100,
                              mirror_mask: bool = False,
                              data_threshold: int = 100,
                              pix_color_fluctuation: float = 2.0,
                              xy_shift: int = 0,
                              use_label_regions: bool = True,
                              excluded: Optional[np.ndarray] = None,
                              engine: str = "auto",
                              neg_query: Optional[Image] = None,
                              neg_query_threshold: int = 0,
                              mirror_neg_query: bool = False,
                              interpret: bool = False):
    """Build a pixel-match engine with the reference's defaults
    (cmd/AbstractColorDepthMatchArgs.java:18-43).

    engine: "auto" (the active-tile kernel on a CUDA GPU, dense on a
    CPU), "dense", "pallas"; interpret runs the kernel in Pallas
    interpret mode (CPU tests only). A negative query composes two
    engines with the reference's score subtraction
    (PixelMatchColorDepthSearchAlgorithm.java:195-217).
    """
    if xy_shift % 2:
        raise ValueError("XY shift parameter must be an even number.")
    if excluded is None and use_label_regions:
        excluded = label_regions_mask(query.height, query.width)
    if engine == "auto":
        import jax
        engine = "pallas" if jax.devices()[0].platform == "gpu" else "dense"

    def build(img, thr, mirror):
        if engine == "pallas":
            from .active_tile import ActiveTilePixelEngine, check_platform
            check_platform(interpret)
            return ActiveTilePixelEngine(img, thr, mirror, data_threshold,
                                         pix_color_fluctuation, xy_shift,
                                         excluded, interpret=interpret)
        from .pixel_kernel import PixelMatchEngine
        return PixelMatchEngine(img, thr, mirror, data_threshold,
                                pix_color_fluctuation, xy_shift, excluded)

    pos = build(query, query_threshold, mirror_mask)
    if neg_query is None:
        return pos
    neg = build(neg_query, neg_query_threshold, mirror_neg_query)
    return NegQueryPixelMatchEngine(pos, neg)


class NegQueryPixelMatchEngine:
    """Positive/negative engine pair with the reference's subtraction
    (PixelMatchColorDepthSearchAlgorithm.java:195-217):
    pixels -= round(negPixels * querySize / negQuerySize),
    ratio  -= negPixels / negQuerySize."""

    def __init__(self, pos, neg):
        self.pos = pos
        self.neg = neg

    @property
    def query_size(self) -> int:
        return self.pos.planes.query_size

    def score_batch(self, targets_u8: np.ndarray):
        pixels, ratios, mirrored = self.pos.score_batch(targets_u8)
        neg_pixels, _, _ = self.neg.score_batch(targets_u8)
        neg_size = self.neg.planes.query_size
        if neg_size <= 0:
            return pixels, ratios, mirrored
        qsize = self.query_size
        adj = np.asarray([
            int(round(float(p) - float(n) * qsize / float(neg_size)))
            for p, n in zip(pixels, neg_pixels)])
        ratios = ratios - neg_pixels.astype(np.float64) / float(neg_size)
        return adj, ratios, mirrored


def create_shape_match_scorer(query: Image,
                              query_threshold: int = 20,
                              mirror_mask: bool = True,
                              use_label_regions: bool = True,
                              excluded: Optional[np.ndarray] = None,
                              roi_mask: Optional[Image] = None,
                              border: int = 0):
    """Build query-side shape planes + a scoring closure
    (createShapeMatchCDSAlgorithmProvider,
    ColorDepthSearchAlgorithmProviderFactory.java:76-127; border =
    queryBorderSize threaded from --border,
    CalculateGradientScoresCmd.java:478)."""
    from .shape_oracle import ShapeScoreOracle
    if excluded is None and use_label_regions:
        excluded = label_regions_mask(query.height, query.width)
    return ShapeScoreOracle(query, query_threshold, mirror_mask,
                            excluded, roi_mask, border)


def is_match(matching_pixels: int, matching_pixels_ratio: float,
             pct_positive_pixels: float = 0.0) -> bool:
    """ColorMIPSearch.isMatch (cds/ColorMIPSearch.java:42-46)."""
    return (matching_pixels > 0
            and matching_pixels_ratio > pct_positive_pixels / 100.0)
