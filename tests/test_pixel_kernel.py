"""Device pixel-match kernel vs oracle and reference goldens."""

import numpy as np
import pytest

from colormipsearch_tpu.imageproc import load_image, label_regions_mask
from colormipsearch_tpu.cds.oracle import PixelMatchOracle
from colormipsearch_tpu.cds.pixel_kernel import PixelMatchEngine

LMS = ["VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01.tif",
       "BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x_HR-2483089192251293794-CH2-01_CDM.tif",
       "VT016795_115C08_AE_01-20200221_61_I2-m-CH1_01.tif",
       "GMR_31G04_AE_01-20190813_66_F3-40x-Brain-JRC2018_Unisex_20x_HR-2704505419467849826-CH2-07_CDM.tif"]
EMS = ["12191_JRC2018U.tif", "12191_JRC2018U_FL.tif", "1752016801-LPLC2-RT_18U.tif"]


@pytest.fixture(scope="module")
def target_batch(fixtures_dir):
    imgs = [load_image(fixtures_dir / "lms" / n) for n in LMS]
    return np.stack([im.pixels for im in imgs])


@pytest.mark.parametrize("em", EMS)
def test_kernel_matches_oracle_all_pairs(fixtures_dir, em, target_batch):
    query = load_image(fixtures_dir / "ems" / em)
    excluded = label_regions_mask(query.height, query.width)
    engine = PixelMatchEngine(query, 20, True, 20, 1.0, 2, excluded)
    scores, ratios, mirrored = engine.score_batch(target_batch)

    oracle = PixelMatchOracle(query, 20, True, 20, 0.01, 2, excluded)
    for i, lm in enumerate(LMS):
        target = load_image(fixtures_dir / "lms" / lm)
        expected = oracle.score(target)
        assert scores[i] == expected.matching_pixels, (em, lm)
        assert bool(mirrored[i]) == expected.mirrored, (em, lm)
        assert ratios[i] == pytest.approx(expected.matching_pixels_ratio)


def test_kernel_goldens(fixtures_dir, target_batch):
    """Direct golden check: EM 12191 vs the 3 scored LMs -> 439/414/426."""
    query = load_image(fixtures_dir / "ems" / "12191_JRC2018U.tif")
    excluded = label_regions_mask(query.height, query.width)
    engine = PixelMatchEngine(query, 20, True, 20, 1.0, 2, excluded)
    scores, _, mirrored = engine.score_batch(target_batch)
    assert scores[0] == 439 and not mirrored[0]
    assert scores[1] == 414 and not mirrored[1]
    assert scores[2] == 426 and mirrored[2]


def test_kernel_random_images_vs_oracle(fixtures_dir):
    """Randomized cross-validation on synthetic images (no shift for speed)."""
    rng = np.random.default_rng(0)
    h, w = 64, 96
    from colormipsearch_tpu.imageproc.io import image_from_array
    # mix of black, low, high pixels to hit thresholds and all sectors
    q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    q[rng.random((h, w)) < 0.5] = 0
    t = rng.integers(0, 256, size=(3, h, w, 3)).astype(np.uint8)
    t[0][rng.random((h, w)) < 0.5] = 0
    query = image_from_array(q)
    engine = PixelMatchEngine(query, 20, True, 20, 2.0, 2, None)
    scores, _, mirrored = engine.score_batch(t)
    oracle = PixelMatchOracle(query, 20, True, 20, 0.02, 2, None)
    for i in range(3):
        expected = oracle.score(image_from_array(t[i]))
        assert scores[i] == expected.matching_pixels, i
        assert bool(mirrored[i]) == expected.mirrored, i


def _predicate_words(rng, n):
    """Packed words: the (a, b) edge lattice of every sector and flag
    combination, random interiors, and the canonical empty word."""
    edge_ab = [(0, 1), (1, 1), (0, 255), (1, 255), (254, 255), (255, 255),
               (1, 2), (127, 255), (128, 255), (51, 100), (102, 200),
               (11, 25), (27, 50), (7, 10), (4, 5), (255, 1)]
    words = [b | (a << 8) | (s << 16) | (fl << 19)
             for s in range(7) for fl in range(8) for a, b in edge_ab]
    a = rng.integers(0, 256, n)
    b = rng.integers(1, 256, n)
    s = rng.integers(0, 7, n)
    fl = rng.integers(0, 8, n)
    words.extend((b | (a << 8) | (s << 16) | (fl << 19)).tolist())
    words.append(1)
    return np.array(words, dtype=np.int32)


@pytest.mark.parametrize("zt9", [0, 7_654_321, 10_000_000, 20_000_000,
                                 54_000_000])
def test_fast_predicate_equals_general(zt9):
    """The packed-constant predicate (dense engine and active-tile
    kernel) decides every word pair like the general staged form, up to
    the packing gate."""
    from colormipsearch_tpu.cds.pixel_kernel import (_match_fast,
                                                     _match_general, _unpack)
    rng = np.random.default_rng(zt9 % 1009)
    qw = _predicate_words(rng, 300)[:, None]
    tw = _predicate_words(rng, 300)[None, :]
    got = np.asarray(_match_fast(_unpack(qw), _unpack(tw), zt9))
    want = np.asarray(_match_general(_unpack(qw), _unpack(tw), zt9))
    np.testing.assert_array_equal(got, want)


def test_match_unpacked_gate():
    """Beyond the packing range the dispatcher takes the general form
    (whose constants would not fit the packed layout)."""
    from colormipsearch_tpu.cds.pixel_kernel import (_PACK_ZT9_MAX,
                                                     _match_general, _unpack,
                                                     match_unpacked)
    rng = np.random.default_rng(4)
    qw = _predicate_words(rng, 100)[:, None]
    tw = _predicate_words(rng, 100)[None, :]
    zt9 = 100_000_000
    assert zt9 > _PACK_ZT9_MAX
    np.testing.assert_array_equal(
        np.asarray(match_unpacked(_unpack(qw), _unpack(tw), zt9)),
        np.asarray(_match_general(_unpack(qw), _unpack(tw), zt9)))
