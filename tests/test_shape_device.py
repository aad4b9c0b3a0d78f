"""Device-resident target-plane builder vs the host oracle.

The device path (cds/shape_device.py) must be bit-identical to
shape_oracle.build_target_shape_planes in every mode: precomputed-zgap
files, on-the-fly 10px zgap dilation, RGB vs gray gradient images, with
and without label-region exclusion. Plus the exact-integer gray
conversion proof and the dilation geometry parity.
"""

import argparse
import os

import numpy as np
import pytest

from colormipsearch_tpu.imageproc import load_image, label_regions_mask
from colormipsearch_tpu.imageproc.io import Image, ImageKind
from colormipsearch_tpu.imageproc.filters import max_filter_rgb
from colormipsearch_tpu.imageproc import colors
from colormipsearch_tpu.cds import shape_device
from colormipsearch_tpu.cds.lut import slice_plane
from colormipsearch_tpu.cds.shape_oracle import build_target_shape_planes

LM_VT033614 = "VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01"
LM_BJD = ("BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x_"
          "HR-2483089192251293794-CH2-01_CDM")


def test_gray_no_gamma_exact_exhaustive():
    """floor((2(r+g+b)+3)/6) == the reference's double expression for
    EVERY u8 triple (sum-exhaustive: the double expr depends on the
    channel values; cover all 256^2 (r, g) x sampled b plus all sums)."""
    r = np.arange(256).repeat(256)
    g = np.tile(np.arange(256), 256)
    for b in (0, 1, 2, 3, 84, 85, 86, 127, 128, 170, 200, 254, 255):
        rgb = np.stack([r, g, np.full_like(r, b)], axis=1).reshape(256, 256, 3)
        host = colors.rgb_to_gray_no_gamma(rgb.astype(np.uint8))
        s = rgb[:, :, 0] + rgb[:, :, 1] + rgb[:, :, 2]
        np.testing.assert_array_equal((2 * s + 3) // 6, host)


def test_device_slice_plane_random():
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, size=(64, 257, 3), dtype=np.uint8)
    # include exact ties and saturated rows (classification branch edges)
    rgb[0] = rgb[0, 0] = 200
    rgb[1, :, 0] = rgb[1, :, 1]
    dev = np.asarray(shape_device.slice_plane_device(rgb))
    np.testing.assert_array_equal(dev, slice_plane(rgb))


@pytest.mark.parametrize("radius", [1.5, 2.5, 3.0, 10.0])
def test_device_dilation_matches_host(radius):
    rng = np.random.default_rng(11)
    x = rng.integers(0, 256, size=(2, 40, 53, 3), dtype=np.uint8)
    x[:, :, ::7] = 0  # sparse structure
    dev = np.asarray(shape_device._dilate_rgb(x, radius))
    for t in range(x.shape[0]):
        np.testing.assert_array_equal(dev[t], max_filter_rgb(x[t], radius))


def _fixture_images(fixtures_dir):
    cdm = load_image(fixtures_dir / "lms" / f"{LM_BJD}.tif")
    grad = load_image(fixtures_dir / "grad" / f"{LM_BJD}.png")
    zgap = load_image(fixtures_dir / "zgap" / f"{LM_BJD}.tif")
    return cdm, grad, zgap


@pytest.mark.parametrize("mode", ["file", "otf"])
@pytest.mark.parametrize("use_excluded", [True, False])
def test_device_planes_match_oracle(fixtures_dir, mode, use_excluded):
    cdm, grad, zgap = _fixture_images(fixtures_dir)
    excluded = (label_regions_mask(cdm.height, cdm.width)
                if use_excluded else None)
    zgap_img = zgap if mode == "file" else None
    host = build_target_shape_planes(cdm, grad, zgap_img, 20, excluded)

    grad_is_rgb = grad.kind == ImageKind.RGB
    grad_raw = (grad.pixels if grad_is_rgb
                else grad.pixels.astype(np.uint16))
    import jax.numpy as jnp
    t_above, g, z_nonzero, z_slice = shape_device.build_target_planes_device(
        cdm.pixels[None], grad_raw[None],
        zgap.pixels[None] if mode == "file" else None,
        jnp.asarray(excluded) if excluded is not None else None,
        thr=20, zgap_mode=mode, grad_is_rgb=grad_is_rgb)
    np.testing.assert_array_equal(np.asarray(t_above[0]), host.t_above)
    np.testing.assert_array_equal(np.asarray(g[0]), host.grad)
    np.testing.assert_array_equal(np.asarray(z_nonzero[0]), host.z_nonzero)
    np.testing.assert_array_equal(np.asarray(z_slice[0]), host.z_slice)


def test_device_planes_rgb_gradient():
    """RGB gradient images go through the exact-integer gray path."""
    rng = np.random.default_rng(3)
    h, w = 48, 64
    cdm = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    grad_rgb = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    host = build_target_shape_planes(
        Image(ImageKind.RGB, cdm), Image(ImageKind.RGB, grad_rgb),
        None, 20, None)
    _, g, _, _ = shape_device.build_target_planes_device(
        cdm[None], grad_rgb[None], None, None,
        thr=20, zgap_mode="otf", grad_is_rgb=True)
    np.testing.assert_array_equal(np.asarray(g[0]), host.grad)


def test_prefetch_device_equals_host_path(fixtures_dir, tmp_path,
                                          monkeypatch):
    """The command-level prefetch produces identical scores through the
    device-plane path and the host fallback (CMS_DEVICE_PLANES=0)."""
    from colormipsearch_tpu.cmd import gradientscores_cmd as gc
    from colormipsearch_tpu.cds.shape_oracle import build_query_shape_planes
    from colormipsearch_tpu.mips import MIPsCache
    from colormipsearch_tpu.model import (CDMatchEntity, ComputeFileType,
                                          EMNeuronEntity, FileData,
                                          LMNeuronEntity)

    query = load_image(fixtures_dir / "ems" / "12191_JRC2018U.tif")
    excluded = label_regions_mask(query.height, query.width)
    qplanes = build_query_shape_planes(query, excluded)
    args = argparse.Namespace(maskThreshold=20, mirrorMask=True,
                              computeZGapOnTheFly=True, targetsPerBatch=4,
                              queryROIMaskName=None, planes_threads=2)
    em = EMNeuronEntity(entity_id=1, mip_id="em-1")
    matches = []
    lms = [LM_VT033614, LM_BJD]
    for i, lm_name in enumerate(lms):
        lm = LMNeuronEntity(entity_id=100 + i, mip_id=f"lm-{i}")
        lm.compute_files[ComputeFileType.InputColorDepthImage] = \
            FileData.from_string(str(fixtures_dir / "lms" / f"{lm_name}.tif"))
        lm.compute_files[ComputeFileType.GradientImage] = \
            FileData.from_string(str(fixtures_dir / "grad" / f"{lm_name}.png"))
        m = CDMatchEntity()
        m.mask_image, m.matched_image = em, lm
        matches.append(m)

    def run():
        cache = MIPsCache(16)
        scored = gc._score_batch(list(matches), qplanes, cache, args,
                                 excluded, {})
        return [(m.gradient_area_gap, m.high_expression_area)
                for m in scored]

    monkeypatch.setenv("CMS_DEVICE_PLANES", "1")
    dev = run()
    monkeypatch.setenv("CMS_DEVICE_PLANES", "0")
    host = run()
    assert dev == host
    # golden anchor (Shape2DMatchColorDepthSearchAlgorithmTest values)
    assert dev[0] == (21365, 731)


def test_prefetch_groups_mixed_shapes(tmp_path):
    """Targets with different frame sizes in one prefetch must group
    into separate device builds (one static shape each); a target whose
    planes mismatch the mask frame is skipped with -1 scores."""
    from PIL import Image as PILImage
    from colormipsearch_tpu.cds.shape_oracle import build_query_shape_planes
    from colormipsearch_tpu.cmd import gradientscores_cmd as gc
    from colormipsearch_tpu.imageproc.io import Image, ImageKind
    from colormipsearch_tpu.mips import MIPsCache
    from colormipsearch_tpu.model import (CDMatchEntity, ComputeFileType,
                                          EMNeuronEntity, FileData,
                                          LMNeuronEntity)

    rng = np.random.default_rng(5)
    h, w = 48, 64
    mask_px = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    qplanes = build_query_shape_planes(Image(ImageKind.RGB, mask_px), None)
    em = EMNeuronEntity(entity_id=1, mip_id="em")
    matches = []
    for i, (th, tw) in enumerate([(h, w), (h, w), (h + 16, w + 32)]):
        cdm = rng.integers(0, 256, size=(th, tw, 3), dtype=np.uint8)
        grad = rng.integers(0, 200, size=(th, tw), dtype=np.uint8)
        cp, gp = tmp_path / f"t{i}.png", tmp_path / f"t{i}_g.png"
        PILImage.fromarray(cdm).save(cp)
        PILImage.fromarray(grad, mode="L").save(gp)
        lm = LMNeuronEntity(entity_id=10 + i, mip_id=f"lm-{i}")
        lm.compute_files[ComputeFileType.InputColorDepthImage] = \
            FileData.from_string(str(cp))
        lm.compute_files[ComputeFileType.GradientImage] = \
            FileData.from_string(str(gp))
        m = CDMatchEntity()
        m.mask_image, m.matched_image = em, lm
        matches.append(m)
    args = argparse.Namespace(maskThreshold=20, mirrorMask=True,
                              computeZGapOnTheFly=True, targetsPerBatch=4,
                              queryROIMaskName=None, planes_threads=2)
    os.environ["CMS_DEVICE_PLANES"] = "1"
    scored = gc._score_batch(list(matches), qplanes, MIPsCache(8), args,
                             None, {})
    assert len(scored) == 2  # the mismatched frame is skipped
    assert matches[2].gradient_area_gap == -1
    assert all(m.gradient_area_gap >= 0 for m in scored)


def test_device_planes_fuzz_threshold_edges():
    """Randomized device-vs-oracle plane fuzz with values clustered at
    the threshold boundaries (thr-1/thr/thr+1) and saturated channels —
    the edges where an off-by-one in the device path would hide."""
    import jax.numpy as jnp
    rng = np.random.default_rng(97)
    h, w = 40, 136
    thr = 20
    for trial in range(6):
        pool = np.array([0, 1, thr - 1, thr, thr + 1, 127, 254, 255],
                        dtype=np.uint8)
        cdm = pool[rng.integers(0, len(pool), size=(h, w, 3))]
        zgap = pool[rng.integers(0, len(pool), size=(h, w, 3))]
        grad = rng.integers(0, 65535, size=(h, w)).astype(np.uint16)
        excluded = rng.random((h, w)) < 0.1 if trial % 2 else None
        mode = "file" if trial % 3 else "otf"
        host = build_target_shape_planes(
            Image(ImageKind.RGB, cdm),
            Image(ImageKind.GRAY16, grad),
            Image(ImageKind.RGB, zgap) if mode == "file" else None,
            thr, excluded)
        out = shape_device.build_target_planes_device(
            cdm[None], grad[None],
            zgap[None] if mode == "file" else None,
            jnp.asarray(excluded) if excluded is not None else None,
            thr=thr, zgap_mode=mode, grad_is_rgb=False)
        for got, want in zip(out, (host.t_above, host.grad,
                                   host.z_nonzero, host.z_slice)):
            np.testing.assert_array_equal(np.asarray(got[0]), want)


def test_plane_cache_byte_budget(monkeypatch):
    """The plane cache evicts by BYTES (device-HBM safety), not just
    entry count."""
    from types import SimpleNamespace
    from colormipsearch_tpu.cmd import gradientscores_cmd as gc
    mb = 1  # 1 MB budget
    monkeypatch.setattr(gc, "_PLANES_CACHE_MB", mb)
    cache = {}
    h, w = 64, 512  # ~0.19 MB/entry at 6 B/pixel
    def planes(i):
        return SimpleNamespace(
            t_above=np.zeros((h, w), bool),
            grad=np.zeros((h, w), np.uint16),
            z_nonzero=np.zeros((h, w), bool),
            z_slice=np.zeros((h, w), np.uint16))
    per = gc._planes_nbytes(planes(0))
    fit = (mb << 20) // per
    for i in range(fit + 4):
        gc._insert_plane(cache, f"k{i}", planes(i))
        total = sum(gc._planes_nbytes(p) for p in cache.values())
        assert total <= (mb << 20)
    assert len(cache) == fit
    # oldest evicted, newest kept
    assert f"k{fit + 3}" in cache and "k0" not in cache
    # None entries cost nothing
    gc._insert_plane(cache, "none", None)
    assert "none" in cache


@pytest.mark.parametrize("use_excluded", [False, True])
@pytest.mark.parametrize("border", [0, 60])
def test_device_query_planes_match_oracle(fixtures_dir, use_excluded,
                                          border):
    """Device query-plane build == host oracle bit-for-bit on the golden
    EM fixture (the r5 GA host bottleneck: two 60px/20px dilations per
    mask, now reduce_window on device)."""
    import numpy as np
    from colormipsearch_tpu.imageproc import load_image, label_regions_mask
    from colormipsearch_tpu.cds.shape_device import build_query_planes_device
    from colormipsearch_tpu.cds.shape_oracle import build_query_shape_planes
    q = load_image(fixtures_dir / "ems" / "12191_JRC2018U_FL.tif")
    excluded = label_regions_mask(q.height, q.width) if use_excluded \
        else None
    host = build_query_shape_planes(q, excluded, None, border)
    dev = build_query_planes_device(q.pixels, excluded, border,
                                    pull_host=True)
    np.testing.assert_array_equal(np.asarray(dev.q_nonzero), host.q_nonzero)
    np.testing.assert_array_equal(np.asarray(dev.q_slice), host.q_slice)
    np.testing.assert_array_equal(np.asarray(dev.q_mask), host.q_mask)
    np.testing.assert_array_equal(np.asarray(dev.high_expr), host.high_expr)
    assert dev.active_row_range() == host.active_row_range()


def test_device_query_planes_mask_statistics(fixtures_dir):
    """The reference's mask-statistics invariants hold on the device
    build (overExpressesMaskExpression: 17340 mask px / 70640
    high-expression px for 12191_JRC2018U_FL)."""
    from colormipsearch_tpu.imageproc import load_image, label_regions_mask
    from colormipsearch_tpu.cds.shape_device import build_query_planes_device
    q = load_image(fixtures_dir / "ems" / "12191_JRC2018U_FL.tif")
    excluded = label_regions_mask(q.height, q.width)
    planes = build_query_planes_device(q.pixels, excluded,
                                       pull_host=True)
    assert int(planes.q_mask.sum()) == 17340
    assert int(planes.high_expr.sum()) == 70640


def test_device_query_planes_resident_scoring(fixtures_dir):
    """The default (device-RESIDENT) query-plane build scores
    identically to host-built planes through score_tplanes_batched —
    no host round-trip of the 7 MB plane set."""
    import types
    import numpy as np
    import colormipsearch_tpu.cmd.gradientscores_cmd as gc
    from colormipsearch_tpu.imageproc import load_image, label_regions_mask
    from colormipsearch_tpu.cds.shape_device import build_query_planes_device
    from colormipsearch_tpu.cds.shape_oracle import build_query_shape_planes
    q = load_image(fixtures_dir / "ems" / "12191_JRC2018U.tif")
    excluded = label_regions_mask(q.height, q.width)
    rng = np.random.default_rng(3)
    raws = []
    for _ in range(3):
        cdm = rng.integers(0, 256, size=(q.height, q.width, 3)).astype(
            np.uint8)
        cdm[rng.random((q.height, q.width)) < 0.8] = 0
        grad = rng.integers(0, 300, size=(q.height, q.width)).astype(
            np.uint16)
        raws.append((cdm, (grad, False), None))
    tplanes = gc._build_planes_device(
        raws, types.SimpleNamespace(maskThreshold=20), excluded)
    host = build_query_shape_planes(q, excluded)
    resident = build_query_planes_device(q.pixels, excluded)  # default
    assert resident.q_nonzero is None          # stayed on device
    assert resident.active_row_range() == host.active_row_range()
    r0, r1 = host.active_row_range()
    g_h, h_h, m_h = gc.score_tplanes_batched(
        host, tplanes, mirror=True, targets_per_batch=4, r0=r0, r1=r1)
    g_r, h_r, m_r = gc.score_tplanes_batched(
        resident, tplanes, mirror=True, targets_per_batch=4, r0=r0, r1=r1)
    np.testing.assert_array_equal(g_h, g_r)
    np.testing.assert_array_equal(h_h, h_r)
    np.testing.assert_array_equal(m_h, m_r)
