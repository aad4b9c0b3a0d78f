"""Survivor-bitmap path in the active-tile kernel + screen equivalence."""

import numpy as np

from colormipsearch_tpu.imageproc import load_image, label_regions_mask
from colormipsearch_tpu.cds.active_tile import (ActiveTilePixelEngine,
                                                pack_words)
from colormipsearch_tpu.cds.pixel_kernel import z_tolerance_to_zt9
from colormipsearch_tpu.cds.prescreen import PairPrescreen, query_features


def query_features_of(engine):
    return query_features(engine.planes.words)


def test_survivor_bitmap_and_screen_equivalence(fixtures_dir):
    query = load_image(fixtures_dir / "ems" / "12191_JRC2018U.tif")
    excluded = label_regions_mask(query.height, query.width)
    engine = ActiveTilePixelEngine(query, 20, True, 20, 1.0, 2, excluded,
                                   interpret=True)
    lms = ["VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01.tif",
           "BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x_HR-2483089192251293794-CH2-01_CDM.tif"]
    targets = np.stack([load_image(fixtures_dir / "lms" / n).pixels
                        for n in lms])

    words = engine.pack_raw_words(targets)
    packed = engine.pad_from_words(words)

    # all-ones bitmap == no bitmap
    s0, _, m0 = engine.score_packed(packed)
    s1, _, m1 = engine.score_packed(packed, survivors=np.ones(2, np.int32))
    np.testing.assert_array_equal(s0, s1)
    assert list(s0) == [439, 414]

    # zeroed target skipped
    s2, _, _ = engine.score_packed(packed, survivors=np.array([1, 0], np.int32))
    assert list(s2) == [439, 0]

    # the screen keeps both golden pairs at the production 1% threshold
    screen = PairPrescreen(z_tolerance_to_zt9(1.0), 2,
                           engine.tiles.height, engine.tiles.width)
    tfeats = screen.target_features(words, words[:, :, ::-1])
    bounds = screen.bounds(screen.query_features(engine.planes.words)[None],
                           tfeats)[0]
    thr = max(0.01 * engine.tiles.query_size, 0.5)
    survivors = (bounds > thr).astype(np.int32)
    assert survivors.all(), bounds
    s3, _, _ = engine.score_packed(packed, survivors=survivors)
    np.testing.assert_array_equal(s3, s0)


def test_device_bounds_match_host_bounds(fixtures_dir):
    query = load_image(fixtures_dir / "ems" / "12191_JRC2018U.tif")
    excluded = label_regions_mask(query.height, query.width)
    engine = ActiveTilePixelEngine(query, 20, True, 20, 1.0, 2, excluded,
                                   interpret=True)
    lms = ["VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01.tif",
           "BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x_HR-2483089192251293794-CH2-01_CDM.tif"]
    targets = np.stack([load_image(fixtures_dir / "lms" / n).pixels
                        for n in lms])
    words = engine.pack_raw_words(targets)
    u_mat = np.stack([query_features_of(engine)] * 3)
    dev = PairPrescreen(z_tolerance_to_zt9(1.0), 2, engine.tiles.height,
                        engine.tiles.width, device=True)
    host = PairPrescreen(z_tolerance_to_zt9(1.0), 2, engine.tiles.height,
                         engine.tiles.width, device=False)
    b_dev = dev.bounds(u_mat, dev.target_features(words, words[:, :, ::-1]))
    b_host = host.bounds(u_mat, host.target_features(words, words[:, :, ::-1]))
    np.testing.assert_array_equal(np.asarray(b_dev), b_host)


def test_survivor_compaction_equals_bitmap_path(fixtures_dir):
    """A survivor subset scores exactly the full-block scores of those
    targets (the kernel scores only the listed pairs) and 0 elsewhere."""
    query = load_image(fixtures_dir / "ems" / "12191_JRC2018U.tif")
    excluded = label_regions_mask(query.height, query.width)
    engine = ActiveTilePixelEngine(query, 20, True, 20, 1.0, 2, excluded,
                                   interpret=True)
    lms = ["VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01.tif",
           "BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x_HR-2483089192251293794-CH2-01_CDM.tif"]
    base = np.stack([load_image(fixtures_dir / "lms" / n).pixels
                     for n in lms])
    # 8 targets: the two goldens + rolled decoys
    targets = np.concatenate([base] + [np.roll(base, 97 * (i + 1), axis=2)
                                       for i in range(3)])
    packed = engine.pad_from_words(engine.pack_raw_words(targets))
    survivors = np.array([1, 1, 0, 0, 0, 1, 0, 0], np.int32)
    full, _, mf = engine.score_packed(packed)
    compact, _, mc = engine.score_packed(packed, survivors=survivors)
    np.testing.assert_array_equal(compact, np.where(survivors, full, 0))
    np.testing.assert_array_equal(mc, mf & (survivors > 0))
    assert full[0] == 439 and full[1] == 414


def test_sparse_feed_equals_dense_feed(fixtures_dir):
    """Sparse (idx, word) upload must reproduce the dense pack's scores
    and prescreen features exactly (sub-threshold words canonicalize to
    the empty word 1, which every consumer gates out via the sel bit)."""
    import jax.numpy as jnp
    query = load_image(fixtures_dir / "ems" / "12191_JRC2018U.tif")
    excluded = label_regions_mask(query.height, query.width)
    engine = ActiveTilePixelEngine(query, 20, True, 20, 1.0, 2, excluded,
                                   interpret=True)
    lms = ["VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01.tif",
           "BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x_HR-2483089192251293794-CH2-01_CDM.tif"]
    targets = np.stack([load_image(fixtures_dir / "lms" / n).pixels
                        for n in lms])
    words_sparse = np.asarray(pack_words(targets, 20, sparse=True))
    words_dense = np.asarray(pack_words(targets, 20, sparse=False))
    sel = (words_dense >> 19) & 1
    np.testing.assert_array_equal(words_sparse[sel > 0], words_dense[sel > 0])
    assert (words_sparse[sel == 0] == 1).all()
    # scores identical through the kernel
    s_sparse, _, m_sparse = engine.score_packed(
        engine.pad_from_words(jnp.asarray(words_sparse)))
    s_dense, _, m_dense = engine.score_packed(
        engine.pad_from_words(jnp.asarray(words_dense)))
    np.testing.assert_array_equal(s_sparse, s_dense)
    np.testing.assert_array_equal(m_sparse, m_dense)
    assert list(s_sparse) == [439, 414]
    # prescreen features identical
    screen = PairPrescreen(z_tolerance_to_zt9(1.0), 2,
                           engine.tiles.height, engine.tiles.width)
    fd_s = screen.target_features(jnp.asarray(words_sparse))
    fd_d = screen.target_features(jnp.asarray(words_dense))
    np.testing.assert_array_equal(np.asarray(fd_s[0]), np.asarray(fd_d[0]))
    np.testing.assert_array_equal(np.asarray(fd_s[1]), np.asarray(fd_d[1]))
