"""Multi-device gradient phase: the production GA
engine — device plane build (cds/shape_device.py) + fused
shape_score_stacked — spread over all local devices, with a 1-vs-N
equality guarantee. Runs on the 8-virtual-CPU-device mesh
(tests/conftest.py). Reference analogue: the LSF GA job fan-out
(CalculateGradientScoresCmd.java:304-312), here driven by one process
over every local chip.
"""

import types

import numpy as np
import pytest

import colormipsearch_tpu.cmd.gradientscores_cmd as gc
from colormipsearch_tpu.cds.shape_oracle import build_query_shape_planes
from colormipsearch_tpu.imageproc.io import image_from_array

H, W, T = 64, 128, 6


def _raws(rng):
    """Synthetic raw frames in the exact _decode_raw output format:
    (cdm u8 [H,W,3], (grad u16, is_rgb=False), zgap=None -> otf)."""
    out = []
    for _ in range(T):
        cdm = rng.integers(0, 256, size=(H, W, 3)).astype(np.uint8)
        cdm[rng.random((H, W)) < 0.6] = 0
        grad = rng.integers(0, 300, size=(H, W)).astype(np.uint16)
        out.append((cdm, (grad, False), None))
    return out


def _qplanes(rng):
    # one isolated bright blob: its dilate60 ring minus dilate20 core
    # gives a NONEMPTY high-expression mask (scattered noise would let
    # dilate20 cover the whole frame and zero it out)
    q = np.zeros((H, W, 3), dtype=np.uint8)
    q[8:14, 12:18] = rng.integers(100, 256, size=(6, 6, 3))
    return build_query_shape_planes(image_from_array(q), None)


def _build_and_score(raws, qplanes, monkeypatch, n_devices):
    if n_devices is None:
        monkeypatch.delenv("CMS_GRAD_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CMS_GRAD_DEVICES", str(n_devices))
    args = types.SimpleNamespace(maskThreshold=20)
    tplanes = gc._build_planes_device(raws, args, excluded=None)
    assert all(t is not None for t in tplanes)
    gaps, high, use_m = gc.score_tplanes_batched(
        qplanes, tplanes, mirror=True, targets_per_batch=4, r0=0, r1=H)
    return tplanes, gaps, high, use_m


def test_one_vs_all_devices_equal(monkeypatch):
    """Same raws, same mask: 1 device vs all 8 — identical scores, and
    the 8-device run actually spreads planes over multiple devices."""
    import jax
    assert len(jax.local_devices()) >= 8
    # one target per build block so the round-robin spreads blocks
    monkeypatch.setattr(gc, "_PLANES_BLOCK", 1)
    rng = np.random.default_rng(7)
    raws = _raws(rng)
    qp1 = _qplanes(np.random.default_rng(8))
    t1, g1, h1, m1 = _build_and_score(raws, qp1, monkeypatch, 1)
    qp8 = _qplanes(np.random.default_rng(8))   # fresh per-device caches
    t8, g8, h8, m8 = _build_and_score(raws, qp8, monkeypatch, None)
    np.testing.assert_array_equal(g1, g8)
    np.testing.assert_array_equal(h1, h8)
    np.testing.assert_array_equal(m1, m8)
    devs1 = {next(iter(t.grad.devices())) for t in t1}
    devs8 = {next(iter(t.grad.devices())) for t in t8}
    assert len(devs1) == 1
    assert len(devs8) > 1          # round-robin engaged
    # scores are real (nonzero) so the equality is meaningful
    assert int(np.sum(g8)) > 0 and int(np.sum(h8)) > 0


def test_mixed_residency_batch(monkeypatch):
    """A batch whose targets live on DIFFERENT devices scores correctly:
    per-device groups dispatch independently and reassemble in order."""
    monkeypatch.setattr(gc, "_PLANES_BLOCK", 1)
    rng = np.random.default_rng(21)
    raws = _raws(rng)
    qp = _qplanes(np.random.default_rng(22))
    monkeypatch.delenv("CMS_GRAD_DEVICES", raising=False)
    args = types.SimpleNamespace(maskThreshold=20)
    tplanes = gc._build_planes_device(raws, args, excluded=None)
    # reversed order must give reversed results (order-stable routing)
    g_f, h_f, _ = gc.score_tplanes_batched(
        qp, tplanes, mirror=True, targets_per_batch=4, r0=0, r1=H)
    g_r, h_r, _ = gc.score_tplanes_batched(
        qp, list(reversed(tplanes)), mirror=True, targets_per_batch=4,
        r0=0, r1=H)
    np.testing.assert_array_equal(g_f, g_r[::-1])
    np.testing.assert_array_equal(h_f, h_r[::-1])


def test_grad_devices_cap(monkeypatch):
    monkeypatch.setenv("CMS_GRAD_DEVICES", "2")
    assert len(gc.grad_devices()) == 2
    monkeypatch.setenv("CMS_GRAD_DEVICES", "1")
    assert len(gc.grad_devices()) == 1
    monkeypatch.delenv("CMS_GRAD_DEVICES", raising=False)
    assert len(gc.grad_devices()) >= 8
