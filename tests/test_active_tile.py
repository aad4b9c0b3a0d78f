"""Active-tile engine: kernel parity in interpret mode (against the f64
oracle, the dense engine and the plain-XLA version), the wrapper's
padding and shapes, and the engine/platform choice. The compiled kernel
itself is checked on the card by the `chip` test at the end."""

import numpy as np
import pytest

import jax

from colormipsearch_tpu.cds import active_tile as at
from colormipsearch_tpu.cds.oracle import PixelMatchOracle
from colormipsearch_tpu.cds.pixel_kernel import (PixelMatchEngine,
                                                 pack_targets)
from colormipsearch_tpu.imageproc.io import image_from_array


def _images(seed, n_targets=4, h=40, w=100, q_empty=0.8, t_empty=0.5):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    q[rng.random((h, w)) < q_empty] = 0
    t = rng.integers(0, 256, size=(n_targets, h, w, 3)).astype(np.uint8)
    t[rng.random((n_targets, h, w)) < t_empty] = 0
    return q, t


@pytest.mark.parametrize("fluct", [1.0, 2.0, 10.0])
@pytest.mark.parametrize("shift", [0, 2, 4])
@pytest.mark.parametrize("mirror", [True, False])
def test_kernel_matches_oracle_and_dense(mirror, shift, fluct):
    """zTolerance 10 lies beyond the packed-constant range of the dense
    engine's predicate, so its general path is the comparison there."""
    q, t = _images(hash((mirror, shift, fluct)) % 2**32)
    query = image_from_array(q)
    eng = at.ActiveTilePixelEngine(query, 20, mirror, 20, fluct, shift,
                                   interpret=True)
    ks, kr, km = eng.score_batch(t)
    ds, dr, dm = PixelMatchEngine(query, 20, mirror, 20, fluct,
                                  shift).score_batch(t)
    np.testing.assert_array_equal(ks, ds)
    np.testing.assert_array_equal(km, dm)
    np.testing.assert_allclose(kr, dr)
    oracle = PixelMatchOracle(query, 20, mirror, 20, fluct / 100.0, shift)
    for i in range(len(t)):
        want = oracle.score(image_from_array(t[i]))
        assert int(ks[i]) == want.matching_pixels
        assert bool(km[i]) == want.mirrored


def _multi_mask_setup(n_masks=5, n_targets=6, mirror=True):
    rng = np.random.default_rng(11)
    h, w = 48, 96
    engines = []
    for i in range(n_masks):
        q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        # masks of very different sizes: from one tile to all of them
        q[rng.random((h, w)) < [0.999, 0.9, 0.5, 0.0, 0.95][i % 5]] = 0
        engines.append(at.ActiveTilePixelEngine(
            image_from_array(q), 20, mirror, 20, 1.0, 2, interpret=True))
        engines[-1].query = image_from_array(q)
    t = rng.integers(0, 256, size=(n_targets, h, w, 3)).astype(np.uint8)
    t[rng.random((n_targets, h, w)) < 0.6] = 0
    return engines, t


@pytest.mark.parametrize("mirror", [True, False])
def test_kernel_equals_xla_version(mirror):
    """The Triton kernel and the plain-XLA gather version produce the
    same per-variant sums for a survivor list spanning many masks."""
    engines, t = _multi_mask_setup(mirror=mirror)
    sc = at.TileScorer(engines, interpret=True)
    packed = engines[0].prepare_targets(t)
    pairs = np.argwhere(np.random.default_rng(2).random(
        (len(engines), len(t))) < 0.6)
    got = sc.launch(packed, pairs)
    want = at.tile_sums_xla(
        sc.pad_pairs(pairs), *sc.table(), *packed, shifts=sc.shifts,
        pad=sc.pad, zt9=sc.zt9, mirror=mirror, k_max=sc.k_max)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    n_var = (2 if mirror else 1) * len(sc.shifts)
    assert not np.asarray(got)[:, n_var:].any()


def test_survivor_list_spanning_many_masks_matches_dense():
    engines, t = _multi_mask_setup()
    sc = at.TileScorer(engines, interpret=True)
    packed = engines[0].prepare_targets(t)
    keep = np.random.default_rng(5).random((len(engines), len(t))) < 0.5
    pairs = np.argwhere(keep)
    best, mirrored = sc.collect([(sc.launch(packed, pairs), pairs)],
                                len(engines), len(t))
    dense_packed = pack_targets(jax.numpy.asarray(t), 20, 2)
    for i, e in enumerate(engines):
        dense = PixelMatchEngine(e.query, 20, True, 20, 1.0, 2)
        ds, _, dm = dense.score_packed(dense_packed)
        np.testing.assert_array_equal(best[i], np.where(keep[i], ds, 0))
        np.testing.assert_array_equal(mirrored[i], keep[i] & dm)


def test_empty_mask_scores_zero():
    q = np.zeros((40, 100, 3), np.uint8)
    _, t = _images(3)
    eng = at.ActiveTilePixelEngine(image_from_array(q), 20, True, 20, 1.0, 2,
                                   interpret=True)
    assert eng.tiles.n_active == 0 and eng.tiles.query_size == 0
    s, r, m = eng.score_batch(t)
    assert not s.any() and not r.any() and not m.any()


def test_zero_survivors_launch_nothing():
    engines, t = _multi_mask_setup()
    sc = at.TileScorer(engines, interpret=True)
    packed = engines[0].prepare_targets(t)
    empty = np.zeros((0, 2), np.int64)
    assert sc.launch(packed, empty) is None
    best, mirrored = sc.collect([(None, empty)], len(engines), len(t))
    assert best.shape == (len(engines), len(t)) and not best.any()
    s, _, _ = engines[0].score_packed(packed, survivors=np.zeros(len(t)))
    assert not s.any()


def test_fixture_goldens_interpret(fixtures_dir):
    from colormipsearch_tpu.imageproc import label_regions_mask, load_image
    query = load_image(fixtures_dir / "ems" / "12191_JRC2018U.tif")
    eng = at.ActiveTilePixelEngine(
        query, 20, True, 20, 1.0, 2,
        label_regions_mask(query.height, query.width), interpret=True)
    lms = ["VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01.tif",
           "VT016795_115C08_AE_01-20200221_61_I2-m-CH1_01.tif"]
    t = np.stack([load_image(fixtures_dir / "lms" / n).pixels for n in lms])
    s, _, m = eng.score_batch(t)
    assert list(s) == [439, 426] and list(m) == [False, True]


@pytest.mark.parametrize("n,bucket", [(1, 64), (64, 64), (65, 128),
                                      (1000, 1024), (4097, 8192)])
def test_pad_pairs_bucket_and_sentinel(n, bucket):
    engines, _ = _multi_mask_setup(n_masks=3)
    sc = at.TileScorer(engines, interpret=True)
    pairs = np.stack([np.arange(n) % 3, np.arange(n) % 7], axis=1)
    out = sc.pad_pairs(pairs)
    assert out.shape == (bucket, 2) and out.dtype == np.int32
    np.testing.assert_array_equal(out[:n], pairs)
    assert (out[n:, 0] == 3).all()          # the empty sentinel mask
    assert tuple(sc.spans[3]) == (0, 0)


def test_tile_table_spans_and_origins():
    engines, _ = _multi_mask_setup()
    sc = at.TileScorer(engines, interpret=True)
    counts = [e.tiles.n_active for e in engines]
    np.testing.assert_array_equal(sc.spans[:-1, 1], counts)
    np.testing.assert_array_equal(sc.spans[:-1, 0],
                                  np.cumsum([0] + counts[:-1]))
    assert sc.q_tiles.shape == (sum(counts) + 1, at.TILE_H, at.TILE_W)
    assert not sc.q_tiles[-1].any()         # the sentinel's empty tile
    assert sc.k_max == max(counts)
    assert (sc.origins[:, 0] % at.TILE_H == 0).all()
    assert (sc.origins[:, 1] % at.TILE_W == 0).all()


def test_scorer_rejects_mixed_cds_params():
    q, _ = _images(1)
    a = at.ActiveTilePixelEngine(image_from_array(q), 20, True, 20, 1.0, 2)
    b = at.ActiveTilePixelEngine(image_from_array(q), 20, True, 20, 2.0, 2)
    with pytest.raises(ValueError):
        at.TileScorer([a, b])


@pytest.mark.parametrize("h,w", [(40, 100), (566, 1210), (32, 32)])
def test_active_tiles_cover_every_selected_pixel(h, w):
    rng = np.random.default_rng(h * w)
    q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    q[rng.random((h, w)) < 0.995] = 0
    eng = at.ActiveTilePixelEngine(image_from_array(q), 20, True, 20, 1.0, 2)
    tiles = eng.tiles
    rebuilt = np.zeros((h + at.TILE_H, w + at.TILE_W), np.int32)
    for tile, (r, c) in zip(tiles.q_tiles, tiles.origins):
        assert ((tile >> 19) & 1).any()     # only active tiles are kept
        rebuilt[r:r + at.TILE_H, c:c + at.TILE_W] = tile
    sel = ((eng.planes.words >> 19) & 1) > 0
    np.testing.assert_array_equal(rebuilt[:h, :w][sel],
                                  eng.planes.words[sel])
    assert ((rebuilt >> 19) & 1).sum() == sel.sum() == tiles.query_size


@pytest.mark.parametrize("shift", [0, 2, 4])
def test_frames_match_dense_layout(shift):
    """The kernel frame is pack_targets' shift-padded frame (and its
    flip), rounded up to whole tiles with empty words."""
    _, t = _images(7, n_targets=2, h=37, w=70)
    pad = max(shift, 1)
    words = at.pack_words(t, 20, sparse=False)
    fp, ff = at.frames_from_words(words, pad)
    dp, df = pack_targets(jax.numpy.asarray(t), 20, pad)
    hp, wp = at.frame_shape(37, 70, pad)
    assert fp.shape == ff.shape == (2, hp, wp)
    assert (hp - 2 * pad) % at.TILE_H == 0
    assert (wp - 2 * pad) % at.TILE_W == 0
    sh, sw = dp.shape[1:]
    np.testing.assert_array_equal(np.asarray(fp)[:, :sh, :sw],
                                  np.asarray(dp))
    np.testing.assert_array_equal(np.asarray(ff)[:, :sh, :sw],
                                  np.asarray(df))
    assert (np.asarray(fp)[:, sh:, :] == 1).all()
    assert (np.asarray(ff)[:, :, sw:] == 1).all()


def test_blocked_pack_equals_single_block(monkeypatch):
    """Targets beyond DEVICE_BLOCK pack and frame in placed blocks with
    the same result as one program."""
    _, t = _images(9, n_targets=5)
    one = at.pack_words(t, 20)
    f_one = at.frames_from_words(one, 2)
    monkeypatch.setattr(at, "DEVICE_BLOCK", 2)
    blk = at.pack_words(t, 20)
    f_blk = at.frames_from_words(blk, 2)
    np.testing.assert_array_equal(np.asarray(one), np.asarray(blk))
    for a, b in zip(f_one, f_blk):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize("platform,kind,interpret,want", [
    ("cpu", "auto", False, "dense"),
    ("gpu", "auto", False, "pallas"),
    ("cpu", "pallas", True, "pallas"),
    ("gpu", "dense", False, "dense"),
    ("cpu", "pallas", False, SystemExit),
    ("gpu", "auto", True, SystemExit),
])
def test_engine_choice_by_platform(monkeypatch, platform, kind, interpret,
                                   want):
    from colormipsearch_tpu.cmd import colordepthsearch_cmd as cds
    monkeypatch.setattr(jax, "devices", lambda: [_FakeDevice(platform)])
    if want is SystemExit:
        with pytest.raises(SystemExit):
            cds._pick_engine(kind, interpret)
    else:
        assert cds._pick_engine(kind, interpret) == want


@pytest.mark.parametrize("platform,interpret,ok", [
    ("gpu", True, False), ("gpu", False, True),
    ("cpu", True, True), ("cpu", False, False)])
def test_check_platform(platform, interpret, ok):
    if ok:
        at.check_platform(interpret, _FakeDevice(platform))
    else:
        with pytest.raises(RuntimeError):
            at.check_platform(interpret, _FakeDevice(platform))


def test_factory_auto_engine_on_cpu_is_dense():
    from colormipsearch_tpu.cds.factory import create_pixel_match_engine
    q, _ = _images(4)
    eng = create_pixel_match_engine(image_from_array(q), engine="auto")
    assert isinstance(eng, PixelMatchEngine)
    with pytest.raises(RuntimeError):
        create_pixel_match_engine(image_from_array(q), engine="pallas")
    eng = create_pixel_match_engine(image_from_array(q), engine="pallas",
                                    interpret=True)
    assert isinstance(eng, at.ActiveTilePixelEngine)


@pytest.mark.chip
def test_compiled_kernel_matches_xla_on_gpu(gpu):
    """On the card: the compiled Triton kernel == the XLA version."""
    engines, t = _multi_mask_setup()
    for e in engines:
        e.interpret = False
    sc = at.TileScorer(engines)
    packed = engines[0].prepare_targets(t, device=gpu)
    pairs = np.argwhere(np.ones((len(engines), len(t)), bool))
    got = sc.launch(packed, pairs, device=gpu)
    want = at.tile_sums_xla(
        sc.pad_pairs(pairs), *sc.table(gpu), *packed, shifts=sc.shifts,
        pad=sc.pad, zt9=sc.zt9, mirror=True, k_max=sc.k_max)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
