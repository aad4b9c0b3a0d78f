"""Device-resident target shape-plane builder (gradient phase).

The host path (shape_oracle.py) builds each target's planes on the CPU
(decode + zgap dilation + slice-LUT algebra per target), work that
grows with the number of targets while the device shape kernel waits;
the split of GA time on the GPU host is not measured yet.
This module moves everything after decode onto the device: raw u8
frames upload once per target and ONE jitted XLA program derives all
four target planes (t_above, grad, z_nonzero, z_slice) that
shape_kernel.shape_score_kernel consumes.

Behavioral contracts (all integer-exact, see proofs inline):
- plane algebra: Shape2DMatchColorDepthSearchAlgorithm.java:150-161
  (target CDM above-threshold plane, z-gap masking at queryThreshold)
- slice numbers: GradientAreaGapUtils.java:107-197 via the precomputed
  6x256x256 table (cds/lut.py) as a device gather
- gray conversion of RGB gradient images:
  ColorTransformation.java:40-54, reformulated as exact integer
  arithmetic (proof at _gray_no_gamma_exact)
- on-the-fly z-gap: 10px circular dilation with ImageJ's exact
  makeLineRadii footprint (ImageTransformation.java:549-572),
  decomposed into per-extent horizontal running maxima + vertical
  shifted maxima — identical to the dense footprint max because every
  footprint row is an interval [-dx, dx]
  (Shape2DMatchColorDepthSearchAlgorithmTest.java:338-343 recipe:
  clearRegions -> mask(queryThreshold) -> unsafeMaxFilter(10)).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..imageproc.filters import make_line_radii
from .lut import slice_number_table


@functools.lru_cache(maxsize=1)
def _flat_slice_table() -> np.ndarray:
    """int16 [6*256*256] flat slice table (host constant). NB kept as
    NumPy: a jnp.asarray here could first be reached INSIDE a jit trace
    and the cache would capture a leaked tracer; callers that want a
    device-resident copy upload it outside the trace
    (_device_slice_table)."""
    return slice_number_table().reshape(-1)


def _device_slice_table(device=None) -> jnp.ndarray:
    """Device copy of the flat slice table, uploaded once per process
    PER DEVICE (the multi-device gradient phase round-robins plane
    builds over local devices; a jit dispatch needs all its inputs on
    one device). Must be called OUTSIDE any jit trace."""
    t = _DEVICE_TABLES.get(device)
    if t is None:
        t = (jnp.asarray(_flat_slice_table()) if device is None
             else jax.device_put(_flat_slice_table(), device))
        _DEVICE_TABLES[device] = t
    return t


_DEVICE_TABLES: dict = {}


def _classify_index(rgb_i32: jnp.ndarray) -> jnp.ndarray:
    """Flat (order, max, second) table index per pixel.

    Classification replicates the reference's >=-comparison branch order
    (GradientAreaGapUtils.java:31-93): R-max checked first, then G,
    then B; within each branch the second channel by >=.
    """
    r = rgb_i32[..., 0]
    g = rgb_i32[..., 1]
    b = rgb_i32[..., 2]
    r_branch = (r >= g) & (r >= b)
    g_branch = (~r_branch) & (g >= r) & (g >= b)
    b_branch = (~r_branch) & (~g_branch)
    ge_gb = g >= b
    ge_rb = r >= b
    ge_rg = r >= g
    # order ids match cds/lut.py: 0:(R,G) 1:(R,B) 2:(G,R) 3:(G,B)
    # 4:(B,R) 5:(B,G)
    order = jnp.where(
        r_branch, jnp.where(ge_gb, 0, 1),
        jnp.where(g_branch, jnp.where(ge_rb, 2, 3),
                  jnp.where(ge_rg, 4, 5)))
    maxv = jnp.where(r_branch, r, jnp.where(g_branch, g, b))
    secv = jnp.where(r_branch, jnp.where(ge_gb, g, b),
                     jnp.where(g_branch, jnp.where(ge_rb, r, b),
                               jnp.where(ge_rg, r, g)))
    return (order * 256 + maxv) * 256 + secv


def slice_plane_device(rgb_u8: jnp.ndarray, table=None) -> jnp.ndarray:
    """Per-pixel depth-slice numbers [..,] int32 for RGB u8 [..., 3].

    `table` is the flat slice table; inside a jit trace pass it in as an
    argument/constant (tracer-safe) — standalone calls embed the host
    constant."""
    if table is None:
        table = _flat_slice_table()
    idx = _classify_index(rgb_u8.astype(jnp.int32))
    return jnp.take(table, idx.reshape(-1),
                    mode="clip").reshape(idx.shape).astype(jnp.int32)


def _gray_no_gamma_exact(rgb_i32: jnp.ndarray) -> jnp.ndarray:
    """rgbToGrayNoGammaCorrection (ColorTransformation.java:40-54) as
    exact integer arithmetic.

    Java computes floor(r/3 + g/3 + b/3 + 0.5) in double with
    maxGray=255 (scale exactly 1.0). The true rational value
    (r+g+b)/3 + 1/2 is NEVER an integer: (r+g+b)/3 + 1/2 = m would
    need 2(r+g+b) + 3 = 6m, impossible by parity (LHS odd, RHS even).
    The nearest integer is therefore at distance >= 1/6, while the
    double rounding error of the Java expression is < 1e-12 — so
    floor((2(r+g+b) + 3) / 6) is bit-identical to the reference for
    every u8 triple (exhaustively verified in
    tests/test_shape_device.py).
    """
    s = rgb_i32[..., 0] + rgb_i32[..., 1] + rgb_i32[..., 2]
    return (2 * s + 3) // 6


def _dilate_rgb(x_u8: jnp.ndarray, radius: float) -> jnp.ndarray:
    """Circular-footprint dilation of u8 [T, H, W, 3], borders clip to 0.

    Exact makeLineRadii geometry: per distinct row half-extent e, a
    width-(2e+1) horizontal running max (reduce_window), then the
    vertical max of the shifted per-row results. Identical to the dense
    footprint max since footprint rows are the intervals [-dx, dx].
    """
    dxs = make_line_radii(radius)
    k_radius = (len(dxs) - 1) // 2
    by_extent: dict = {}
    for row, dx in enumerate(dxs):
        by_extent.setdefault(int(dx), []).append(row - k_radius)
    h = x_u8.shape[1]
    out = None
    for extent, offsets in by_extent.items():
        hmax = jax.lax.reduce_window(
            x_u8, np.uint8(0), jax.lax.max,
            window_dimensions=(1, 1, 2 * extent + 1, 1),
            window_strides=(1, 1, 1, 1),
            padding=((0, 0), (0, 0), (extent, extent), (0, 0)))
        for off in offsets:
            if off == 0:
                shifted = hmax
            elif off > 0:
                # out[y] takes hmax[y + off]
                shifted = jnp.pad(hmax[:, off:], ((0, 0), (0, off),
                                                  (0, 0), (0, 0)))
            else:
                shifted = jnp.pad(hmax[:, :h + off], ((0, 0), (-off, 0),
                                                      (0, 0), (0, 0)))
            out = shifted if out is None else jnp.maximum(out, shifted)
    return out


@functools.partial(jax.jit, static_argnames=("thr", "zgap_mode",
                                             "grad_is_rgb"))
def _build_target_planes_jit(cdm_u8, grad_raw, zgap_u8, excluded,
                             slice_table, *, thr: int, zgap_mode: str,
                             grad_is_rgb: bool):
    """Derive all four target shape planes on device.

    cdm_u8   u8  [T, H, W, 3]  raw target CDM frames
    grad_raw u16 [T, H, W] (gray) or u8 [T, H, W, 3] (RGB gradient)
    zgap_u8  u8  [T, H, W, 3] precomputed z-gap frames (zgap_mode
             "file") or ignored (zgap_mode "otf": derived from the CDM
             by the production 10px-dilation recipe)
    excluded bool [H, W] label-region mask or None

    Returns (t_above bool, grad u16, z_nonzero bool, z_slice u16), each
    [T, H, W] — the exact planes of
    shape_oracle.build_target_shape_planes.
    """
    cdm_i = cdm_u8.astype(jnp.int32)
    if excluded is not None:
        t_clear = jnp.where(excluded[None, :, :, None], 0, cdm_i)
    else:
        t_clear = cdm_i
    t_above = (t_clear > thr).any(axis=-1)

    if grad_is_rgb:
        grad = _gray_no_gamma_exact(grad_raw.astype(jnp.int32))
    else:
        grad = grad_raw.astype(jnp.int32)
    grad = grad.astype(jnp.uint16)

    if zgap_mode == "file":
        z_rgb = zgap_u8.astype(jnp.int32)
    elif zgap_mode == "otf":
        # compute_zgap_image: clearRegions -> maskRGB(thr) -> dilate(10)
        keep = (t_clear > thr).any(axis=-1)
        masked = jnp.where(keep[..., None], t_clear, 0).astype(jnp.uint8)
        z_rgb = _dilate_rgb(masked, 10.0).astype(jnp.int32)
    else:  # pragma: no cover - guarded by callers
        raise ValueError(f"unknown zgap_mode {zgap_mode!r}")

    # targetZGapMaskImage = zgap masked at queryThreshold
    # (Shape2DMatchColorDepthSearchAlgorithm.java:161)
    z_nonzero = (z_rgb > thr).any(axis=-1)
    z_slice = jnp.where(z_nonzero, slice_plane_device(z_rgb, slice_table), 0)
    return t_above, grad, z_nonzero.astype(bool), z_slice.astype(jnp.uint16)


@functools.partial(jax.jit, static_argnames=("border", "has_excluded"))
def _build_query_planes_jit(rgb_u8, excluded, slice_table, *,
                            border: int, has_excluded: bool):
    """Derive the per-mask QUERY shape planes on device
    (ColorDepthSearchAlgorithmProviderFactory.java:96-121):
      cleared   = clearRegions(query)
      high_expr = signal0(gray16(where(dilate20 != 0, black, dilate60)))
      q_mask    = signal2(gray16(cleared))
      q_nonzero = any-channel > 0; q_slice = depth-slice LUT
    The 60px/20px dilations are the exact makeLineRadii reduce_window
    form (_dilate_rgb — the same code the 10px on-the-fly zgap uses);
    gray conversion is the proven-exact integer form
    (_gray_no_gamma_exact). The host build runs two large dilations per
    mask; at production mask counts (1.5K+ per GA process) that serial
    host cost dominated the gradient phase wall."""
    rgb_i = rgb_u8.astype(jnp.int32)
    if has_excluded:
        rgb_i = jnp.where(excluded[:, :, None], 0, rgb_i)
    cleared_u8 = rgb_i.astype(jnp.uint8)
    d60 = _dilate_rgb(cleared_u8[None], 60.0)[0].astype(jnp.int32)
    d20 = _dilate_rgb(cleared_u8[None], 20.0)[0]
    hem = jnp.where((d20 > 0).any(axis=-1)[..., None], 0, d60)
    high_expr = (_gray_no_gamma_exact(hem) > 0).astype(jnp.int32)
    q_mask = (_gray_no_gamma_exact(rgb_i) > 2).astype(jnp.int32)
    q_nonzero = (rgb_i > 0).any(axis=-1)
    q_slice = slice_plane_device(cleared_u8, slice_table)
    if border > 0:
        h, w = q_nonzero.shape
        frame = jnp.zeros((h, w), dtype=bool).at[
            border:h - border, border:w - border].set(True)
        q_nonzero = q_nonzero & frame
        q_mask = jnp.where(frame, q_mask, 0)
    # [H] active-rows vector: the ONLY thing the host needs for the
    # scoring path (active_row_range); the planes themselves stay
    # device-resident
    row_any = q_nonzero.any(axis=1) | (high_expr > 0).any(axis=1)
    return q_nonzero, q_slice, q_mask, high_expr, row_any


def build_query_planes_device(query_rgb_u8, excluded=None, border: int = 0,
                              pull_host: bool = False):
    """Device query-plane build -> QueryShapePlanes whose [H, W] planes
    stay RESIDENT on the build device (attached as the scorer's
    per-device upload cache) — only the [H] active-rows vector comes to
    the host; pulling the four planes (7 MB) and re-uploading them would
    cost more than the warm scoring itself at realistic (~18)
    matches/mask. `pull_host=True` additionally
    materializes the NumPy planes (parity tests, host consumers).
    ROI-mask runs keep the host oracle path (rare; exact-ROI mirror
    semantics need separate plane sets anyway)."""
    from .shape_oracle import QueryShapePlanes
    has_ex = excluded is not None
    ex = jnp.asarray(excluded.astype(bool)) if has_ex else \
        jnp.zeros((1, 1), dtype=bool)
    q_nonzero, q_slice, q_mask, high_expr, row_any = _build_query_planes_jit(
        jnp.asarray(query_rgb_u8), ex, _device_slice_table(),
        border=border, has_excluded=has_ex)
    planes = QueryShapePlanes(
        q_nonzero=np.asarray(q_nonzero) if pull_host else None,
        q_slice=np.asarray(q_slice).astype(np.int32) if pull_host else None,
        q_mask=np.asarray(q_mask).astype(np.int32) if pull_host else None,
        high_expr=(np.asarray(high_expr).astype(np.int32)
                   if pull_host else None),
        height=int(query_rgb_u8.shape[0]),
        width=int(query_rgb_u8.shape[1]),
        row_any=np.asarray(row_any))
    # seed the scorer's per-device cache with the resident arrays
    # (gradientscores_cmd._qplanes_device dtype contract:
    # bool/int32/int32/bool), keyed by their actual device
    dev = next(iter(q_nonzero.devices()))
    planes._dev = {dev: (q_nonzero, q_slice, q_mask, high_expr > 0)}
    return planes


def build_target_planes_device(cdm_u8, grad_raw, zgap_u8, excluded,
                               *, thr: int, zgap_mode: str,
                               grad_is_rgb: bool, device=None):
    """Public entry: uploads the slice table once (outside the trace)
    and dispatches the jitted plane builder. With `device` set, the raw
    frames upload to that device and the program runs there (the
    multi-device gradient phase round-robins blocks over
    jax.local_devices(); the output planes stay resident where they
    were built and the batch scorer dispatches to them)."""
    if device is not None:
        cdm_u8 = jax.device_put(cdm_u8, device)
        grad_raw = jax.device_put(grad_raw, device)
        if zgap_u8 is not None:
            zgap_u8 = jax.device_put(zgap_u8, device)
        if excluded is not None:
            excluded = jax.device_put(excluded, device)
    return _build_target_planes_jit(cdm_u8, grad_raw, zgap_u8, excluded,
                                    _device_slice_table(device), thr=thr,
                                    zgap_mode=zgap_mode,
                                    grad_is_rgb=grad_is_rgb)
