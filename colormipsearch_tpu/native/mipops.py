"""ctypes bindings for the mipops native library.

The shared library is built on demand from mipops.cpp with g++ (-O3,
OpenMP) and cached next to the source; every entry point has a NumPy
fallback so the package works without a toolchain. Parity between the
native and NumPy paths is asserted in tests.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

LOG = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "mipops.cpp")
_LIB_PATH = os.path.join(_HERE, "_mipops.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-fopenmp",
           "-o", _LIB_PATH, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        LOG.warning("native mipops build failed (%s); using NumPy fallbacks", e)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) or \
                os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            LOG.warning("native mipops load failed: %s", e)
            return None
        lib.max_filter_rgb.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_double]
        lib.max_filter_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_double]
        lib.pack_planes_rgb.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p]
        lib.packbits_decode_range.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.packbits_decode_range.restype = ctypes.c_int64
        lib.rgb_gray_signal.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
        lib.png_unfilter.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int]
        lib.sparse_pack_block.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def max_filter_rgb_native(rgb: np.ndarray, radius: float) -> Optional[np.ndarray]:
    """Circular per-channel dilation; None if native lib unavailable."""
    lib = _load()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    out = np.empty_like(rgb)
    lib.max_filter_rgb(rgb.ctypes.data, out.ctypes.data, h, w,
                       ctypes.c_double(radius))
    return out


def pack_planes_native(rgb: np.ndarray, threshold: int,
                       excluded: Optional[np.ndarray] = None
                       ) -> Optional[np.ndarray]:
    """Packed scorer words from interleaved RGB u8 [H, W, 3]."""
    lib = _load()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    out = np.empty((h, w), dtype=np.int32)
    exc_ptr = None
    if excluded is not None:
        excluded = np.ascontiguousarray(excluded, dtype=np.uint8)
        exc_ptr = excluded.ctypes.data
    lib.pack_planes_rgb(rgb.ctypes.data, out.ctypes.data, h * w,
                        threshold, exc_ptr)
    return out


def packbits_decode_range_native(data: bytes, out_len: int,
                                 start: int = 0, end: int = 0
                                 ) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.zeros(out_len, dtype=np.uint8)
    lib.packbits_decode_range(buf.ctypes.data, len(buf), out.ctypes.data,
                              out_len, 0, start, end)
    return out


def png_unfilter_native(raw: bytes, h: int, stride: int, bpp: int
                        ) -> Optional[np.ndarray]:
    """Unfiltered PNG scanlines (uint8 [h, stride]); None if the native
    lib is unavailable. Raises ValueError on an unknown filter type."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(raw, dtype=np.uint8)
    out = np.empty((h, stride), dtype=np.uint8)
    if lib.png_unfilter(buf.ctypes.data, out.ctypes.data, h, stride,
                        bpp) != 0:
        raise ValueError("PNG: unknown scanline filter")
    return out


def rgb_gray_signal_native(rgb: np.ndarray, threshold: int
                           ) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    out = np.empty((h, w), dtype=np.uint8)
    lib.rgb_gray_signal(rgb.ctypes.data, out.ctypes.data, h * w, threshold)
    return out


def sparse_pack_block_native(rgb_block: np.ndarray, threshold: int):
    """(flat_idx int32, words int32) for above-threshold pixels of a
    [T, H, W, 3] u8 target block, row-major sorted; None if the native
    lib is unavailable. Sub-threshold pixels canonicalize to word 1 on
    the device scatter fill (score-invariant; see mipops.cpp)."""
    lib = _load()
    if lib is None:
        return None
    rgb_block = np.ascontiguousarray(rgb_block, dtype=np.uint8)
    t, h, w, _ = rgb_block.shape
    px = h * w
    idx_buf = np.empty(t * px, dtype=np.int32)
    word_buf = np.empty(t * px, dtype=np.int32)
    counts = np.empty(t, dtype=np.int64)
    lib.sparse_pack_block(rgb_block.ctypes.data, t, px, threshold,
                          idx_buf.ctypes.data, word_buf.ctypes.data,
                          counts.ctypes.data)
    segs_i = [idx_buf[ti * px: ti * px + int(counts[ti])] for ti in range(t)]
    segs_w = [word_buf[ti * px: ti * px + int(counts[ti])] for ti in range(t)]
    return np.concatenate(segs_i), np.concatenate(segs_w)


def sparse_pack_block_numpy(rgb_block: np.ndarray, threshold: int):
    """NumPy fallback with identical output to sparse_pack_block_native."""
    from ..cds.pixel_kernel import pack_planes
    t, h, w, _ = rgb_block.shape
    r = rgb_block[..., 0].astype(np.int32)
    g = rgb_block[..., 1].astype(np.int32)
    b = rgb_block[..., 2].astype(np.int32)
    above = (r > threshold) | (g > threshold) | (b > threshold)
    flat_idx = np.flatnonzero(above.reshape(-1)).astype(np.int32)
    words = pack_planes(r, g, b, above, np).reshape(-1)[flat_idx]
    return flat_idx, words.astype(np.int32)


def sparse_pack_block(rgb_block: np.ndarray, threshold: int):
    out = sparse_pack_block_native(rgb_block, threshold)
    if out is None:
        out = sparse_pack_block_numpy(rgb_block, threshold)
    return out
