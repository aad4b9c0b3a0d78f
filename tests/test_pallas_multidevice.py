"""Multi-device production engine: the prescreen + active-tile sweep
sharded over local devices must score bit-identically to the
single-device path (the reference runs the same
algorithm locally and on the cluster,
SparkColorMIPSearchProcessor.java:27-84)."""

import numpy as np
import pytest

import jax


@pytest.fixture(scope="module")
def small_library():
    rng = np.random.default_rng(7)
    h, w = 48, 160
    masks = []
    for i in range(3):
        q = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        q[rng.random((h, w)) < 0.8] = 0
        masks.append(q)
    targets = rng.integers(0, 256, size=(13, h, w, 3)).astype(np.uint8)
    targets[rng.random((13, h, w)) < 0.7] = 0
    return masks, targets


def _engines(masks):
    from colormipsearch_tpu.cds.active_tile import ActiveTilePixelEngine
    from colormipsearch_tpu.imageproc.io import image_from_array
    return [ActiveTilePixelEngine(image_from_array(q), 20, True, 20, 1.0, 2,
                                  None, interpret=True) for q in masks]


def test_multidevice_two_phase_matches_single_device(small_library):
    from colormipsearch_tpu.cds.pixel_kernel import z_tolerance_to_zt9
    from colormipsearch_tpu.cds.prescreen import PairPrescreen
    from colormipsearch_tpu.parallel.pallas_sweep import TwoPhaseSweep

    masks, targets = small_library
    engines = _engines(masks)
    h, w = targets.shape[1:3]
    screen = PairPrescreen(z_tolerance_to_zt9(1.0), 2, h, w)
    u = np.stack([screen.query_features(e.planes.words) for e in engines])
    thr = np.maximum(0.01 * np.array([e.tiles.query_size for e in engines]),
                     0.5)

    assert len(jax.local_devices()) >= 8, "conftest must force 8 devices"
    multi = TwoPhaseSweep(engines, screen, u, thr,
                          devices=jax.local_devices())
    stage = {}
    s_multi, m_multi = multi.sweep(targets, stage)
    assert stage["screened"] >= 0

    single = TwoPhaseSweep(engines, screen, u, thr,
                           devices=jax.local_devices()[:1])
    s_one, m_one = single.sweep(targets)
    np.testing.assert_array_equal(s_multi, s_one)
    np.testing.assert_array_equal(m_multi, m_one)

    # ground truth: the dense oracle-checked engine path, no screen
    noscreen = TwoPhaseSweep(engines, None, None, None,
                             devices=jax.local_devices()[:3])
    s_ns, m_ns = noscreen.sweep(targets)
    # screened-out pairs report 0, which the keep threshold would drop
    # anyway; every pair at/above threshold must be identical
    keep = s_ns > np.maximum((0.01 * np.array(
        [e.tiles.query_size for e in engines]))[:, None], 0.5)
    np.testing.assert_array_equal(s_multi[keep], s_ns[keep])
    assert (s_multi <= s_ns).all()


def test_shards_score_on_their_own_devices(small_library):
    """Each target shard's kernel output sits on the device that scored
    it (no array strays to the default device)."""
    from colormipsearch_tpu.cds.pixel_kernel import z_tolerance_to_zt9
    from colormipsearch_tpu.cds.prescreen import PairPrescreen
    from colormipsearch_tpu.parallel.pallas_sweep import TwoPhaseSweep

    masks, targets = small_library
    engines = _engines(masks)
    devices = jax.local_devices()[1:5]
    sweep = TwoPhaseSweep(engines, None, None, None, devices=devices)
    _, launched, _ = sweep.launch(targets)
    homes = [next(iter(out.devices())) for out, _ in launched]
    assert homes == devices
    for dev in devices:
        assert all(next(iter(a.devices())) == dev
                   for a in sweep.scorer.table(dev))


def test_device_blocks_cover_and_balance():
    from colormipsearch_tpu.parallel.pallas_sweep import device_blocks
    for n in (0, 1, 7, 8, 13, 64):
        for d in (1, 3, 8):
            blocks = device_blocks(n, d)
            assert len(blocks) == d
            covered = [i for off, ln in blocks for i in range(off, off + ln)]
            assert covered == list(range(n))
            lens = [ln for _, ln in blocks]
            assert max(lens) - min(lens) <= 1
