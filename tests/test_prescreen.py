"""Prescreen validity: the bound must dominate the exact score."""

import numpy as np
import pytest

from colormipsearch_tpu.imageproc import load_image, label_regions_mask
from colormipsearch_tpu.imageproc.io import image_from_array
from colormipsearch_tpu.cds.oracle import PixelMatchOracle
from colormipsearch_tpu.cds.pixel_kernel import (prepare_query_planes,
                                                 pack_planes,
                                                 z_tolerance_to_zt9)
from colormipsearch_tpu.cds.prescreen import PairPrescreen, compat_matrix
from colormipsearch_tpu.cds.oracle import sector_and_ratio, _gap_from_sectors


def _target_words(imgs, threshold=20):
    rgb = np.stack([im.astype(np.int32) for im in imgs])
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    sel = (rgb > threshold).any(axis=3)
    return pack_planes(r, g, b, sel, np)


def test_compat_superset_random_pixels():
    """exact gap-ok(p1, p2) => compat[bin(p1), bin(p2)]."""
    rng = np.random.default_rng(2)
    n = 200_000
    rgb1 = rng.integers(0, 256, size=(n, 3)).astype(np.int64)
    rgb2 = rng.integers(0, 256, size=(n, 3)).astype(np.int64)
    for fluct in (1.0, 2.0):
        zt9 = z_tolerance_to_zt9(fluct)
        s1, q1 = sector_and_ratio(rgb1[:, 0], rgb1[:, 1], rgb1[:, 2])
        s2, q2 = sector_and_ratio(rgb2[:, 0], rgb2[:, 1], rgb2[:, 2])
        gap = _gap_from_sectors(s1, q1, s2, q2)
        exact_ok = gap <= (zt9 / 1e9)
        # bins (same integer arithmetic as bin_plane_from_words)
        from colormipsearch_tpu.cds.prescreen import NB

        def bins(s, rgb):
            first = np.choose(np.clip(s, 1, 6) - 1,
                              [rgb[:, 2], rgb[:, 2], rgb[:, 1],
                               rgb[:, 1], rgb[:, 0], rgb[:, 0]])
            second = np.choose(np.clip(s, 1, 6) - 1,
                               [rgb[:, 0], rgb[:, 1], rgb[:, 2],
                                rgb[:, 0], rgb[:, 1], rgb[:, 2]])
            a = np.where((first != 0) & (second != 0), second, 0)
            b = np.maximum(first, 1)
            rb = np.minimum((a * NB) // b, NB - 1)
            return (s - 1) * NB + rb

        b1 = bins(s1, rgb1)
        b2 = bins(s2, rgb2)
        compat = compat_matrix(zt9)
        both = (s1 > 0) & (s2 > 0) & exact_ok
        assert compat[b1[both], b2[both]].all(), \
            f"compat misses exact matches at fluct={fluct}"


@pytest.mark.parametrize("em", ["12191_JRC2018U.tif", "12191_JRC2018U_FL.tif"])
def test_bound_dominates_exact_fixtures(fixtures_dir, em):
    import os
    query = load_image(fixtures_dir / "ems" / em)
    excluded = label_regions_mask(query.height, query.width)
    qp = prepare_query_planes(query, 20, excluded)

    lm_names = sorted(os.listdir(fixtures_dir / "lms"))
    targets = [load_image(fixtures_dir / "lms" / n) for n in lm_names]
    t_words = _target_words([t.pixels for t in targets])

    screen = PairPrescreen(z_tolerance_to_zt9(1.0), 2,
                           query.height, query.width)
    tfeats = screen.target_features(t_words, t_words[:, :, ::-1])
    u = screen.query_features(qp.words)
    bounds = screen.bounds(u[None], tfeats)[0]

    oracle = PixelMatchOracle(query, 20, True, 20, 0.01, 2, excluded)
    for i, t in enumerate(targets):
        exact = oracle.score(t).matching_pixels
        assert bounds[i] >= exact, (em, lm_names[i], bounds[i], exact)


def test_bound_dominates_exact_random():
    rng = np.random.default_rng(9)
    h, w = 48, 160
    q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    q[rng.random((h, w)) < 0.7] = 0
    t = rng.integers(0, 256, size=(4, h, w, 3)).astype(np.uint8)
    t[rng.random((4, h, w)) < 0.5] = 0
    query = image_from_array(q)
    qp = prepare_query_planes(query, 20, None)
    t_words = _target_words(list(t))
    screen = PairPrescreen(z_tolerance_to_zt9(2.0), 2, h, w)
    tfeats = screen.target_features(t_words, t_words[:, :, ::-1])
    bounds = screen.bounds(screen.query_features(qp.words)[None], tfeats)[0]
    oracle = PixelMatchOracle(query, 20, True, 20, 0.02, 2, None)
    for i in range(4):
        exact = oracle.score(image_from_array(t[i])).matching_pixels
        assert bounds[i] >= exact, (i, bounds[i], exact)


@pytest.mark.parametrize("em", ["12191_JRC2018U.tif"])
def test_variant_bound_dominates_exact_fixtures(fixtures_dir, em):
    """bounds_from_words (per-shift max, undilated windows) >= exact."""
    import os
    query = load_image(fixtures_dir / "ems" / em)
    excluded = label_regions_mask(query.height, query.width)
    qp = prepare_query_planes(query, 20, excluded)

    lm_names = sorted(os.listdir(fixtures_dir / "lms"))
    targets = [load_image(fixtures_dir / "lms" / n) for n in lm_names]
    t_words = _target_words([t.pixels for t in targets])

    screen = PairPrescreen(z_tolerance_to_zt9(1.0), 2,
                           query.height, query.width)
    u = screen.query_features(qp.words)
    bounds = screen.bounds_from_words(u[None], t_words)[0]

    # tightness: never looser than the dilated single bound
    tfeats = screen.target_features(t_words, t_words[:, :, ::-1])
    dilated = screen.bounds(u[None], tfeats)[0]
    assert (bounds <= dilated + 1e-3).all(), (bounds, dilated)

    oracle = PixelMatchOracle(query, 20, True, 20, 0.01, 2, excluded)
    for i, t in enumerate(targets):
        exact = oracle.score(t).matching_pixels
        assert bounds[i] >= exact, (em, lm_names[i], bounds[i], exact)


def test_variant_bound_dominates_exact_random():
    rng = np.random.default_rng(17)
    h, w = 48, 160
    q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    q[rng.random((h, w)) < 0.7] = 0
    t = rng.integers(0, 256, size=(5, h, w, 3)).astype(np.uint8)
    t[rng.random((5, h, w)) < 0.5] = 0
    query = image_from_array(q)
    qp = prepare_query_planes(query, 20, None)
    t_words = _target_words(list(t))
    for fluct, xy in ((2.0, 2), (1.0, 0), (1.0, 4)):
        screen = PairPrescreen(z_tolerance_to_zt9(fluct), xy, h, w)
        bounds = screen.bounds_from_words(
            screen.query_features(qp.words)[None], t_words)[0]
        oracle = PixelMatchOracle(query, 20, True, 20, fluct / 100, xy, None)
        for i in range(len(t)):
            exact = oracle.score(image_from_array(t[i])).matching_pixels
            assert bounds[i] >= exact, (fluct, xy, i, bounds[i], exact)
