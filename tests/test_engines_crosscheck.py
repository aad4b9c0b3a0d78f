"""Randomized triple equality: oracle == dense kernel == active-tile
kernel (interpret mode) across parameter combinations the goldens don't
cover."""

import numpy as np
import pytest

from colormipsearch_tpu.imageproc.io import image_from_array
from colormipsearch_tpu.cds.oracle import PixelMatchOracle
from colormipsearch_tpu.cds.pixel_kernel import PixelMatchEngine
from colormipsearch_tpu.cds.active_tile import ActiveTilePixelEngine

CONFIGS = [
    # (mirror, data_thr, fluct, xyshift)
    (True, 20, 1.0, 2),
    (False, 20, 2.0, 0),
    (True, 0, 2.0, 0),
    (True, 100, 1.0, 2),
    (False, 20, 10.0, 2),
]


@pytest.mark.parametrize("mirror,thr,fluct,shift", CONFIGS)
def test_triple_equality(mirror, thr, fluct, shift):
    rng = np.random.default_rng(hash((mirror, thr, int(fluct * 10), shift)) % 2**32)
    h, w = 56, 200
    q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    q[rng.random((h, w)) < 0.75] = 0
    t = rng.integers(0, 256, size=(6, h, w, 3)).astype(np.uint8)
    t[rng.random((6, h, w)) < 0.5] = 0
    query = image_from_array(q)

    dense = PixelMatchEngine(query, 20, mirror, thr, fluct, shift)
    pallas = ActiveTilePixelEngine(query, 20, mirror, thr, fluct, shift,
                                   interpret=True)
    oracle = PixelMatchOracle(query, 20, mirror, thr, fluct / 100.0, shift)

    ds, dr, dm = dense.score_batch(t)
    ps, pr, pm = pallas.score_batch(t)
    np.testing.assert_array_equal(ds, ps)
    np.testing.assert_array_equal(dm, pm)
    for i in range(len(t)):
        expected = oracle.score(image_from_array(t[i]))
        assert int(ds[i]) == expected.matching_pixels, (i, mirror, thr, fluct, shift)
        assert bool(dm[i]) == expected.mirrored
