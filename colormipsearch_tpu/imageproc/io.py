"""Image decoding into dense NumPy planes.

Counterpart of the reference's image decoding layer
(colormipsearch-api imageprocessing/ImageArrayUtils.java:98-121 and the
ImageArray family, imageprocessing/ImageArray.java) — but instead of flat
packed-int buffers we decode straight into dense NumPy arrays, the layout
the device compute path wants:

- RGB   -> uint8  [H, W, 3]
- GRAY8 -> uint8  [H, W]
- GRAY16-> uint16 [H, W]

TIFF and PNG, the formats the pipeline reads (colour-depth MIPs are RGB
TIFFs, raw or PackBits; gradient and z-gap images are grey PNG/TIFF),
decode here with NumPy and zlib: TIFF strips, uncompressed or PackBits,
8/16-bit RGB(A) and 8/16-bit grey; PNG 8/16-bit grey and RGB(A) with all
five scanline filters (16-bit colour keeps its high byte, as Pillow
does). Pillow is optional: it serves BMP, GIF and JPEG, and the TIFF and
PNG variants this decoder does not handle (LZW or Deflate TIFFs,
palette, sub-8-bit, grey+alpha or interlaced PNGs). The reference's special ranged packbits TIFF read
(ImageArrayUtils.java:184-258) is an I/O optimization for reading a pixel
strip; here full decode feeds a packed preprocessed cache (see
imageproc.store) so steady-state runs never re-decode.
"""

from __future__ import annotations

import enum
import io as _io
import os
import struct
import zlib
from dataclasses import dataclass
from typing import Union

import numpy as np


class UnsupportedImage(ValueError):
    """A TIFF/PNG variant the NumPy decoder does not handle."""


class ImageKind(enum.Enum):
    RGB = "rgb"
    GRAY8 = "gray8"
    GRAY16 = "gray16"


@dataclass
class Image:
    """A decoded image: dense pixels + pixel kind.

    Mirrors the role of the reference's ImageArray (ImageArray.java:1-68),
    with numpy arrays instead of packed-int buffers.
    """

    kind: ImageKind
    pixels: np.ndarray  # [H, W, 3] u8 for RGB; [H, W] u8/u16 for gray

    @property
    def height(self) -> int:
        return self.pixels.shape[0]

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    @property
    def shape(self):
        return (self.height, self.width)

    def rgb_i32(self) -> np.ndarray:
        """RGB channels as int32 [H, W, 3] (zeros-extended for gray)."""
        if self.kind == ImageKind.RGB:
            return self.pixels.astype(np.int32)
        raise ValueError(f"not an RGB image: {self.kind}")

    def gray_i32(self) -> np.ndarray:
        if self.kind == ImageKind.RGB:
            raise ValueError("not a gray image")
        return self.pixels.astype(np.int32)


IMAGE_EXTENSIONS = (".bmp", ".gif", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".wbmp")


def is_image_file(name: str) -> bool:
    """Extension-based image sniff (ImageArrayUtils.isImageFile, :68-87)."""
    return name.lower().endswith(IMAGE_EXTENSIONS)


def image_from_array(arr: np.ndarray) -> Image:
    if arr.ndim == 3 and arr.shape[2] in (3, 4):
        if arr.shape[2] == 4:
            arr = arr[:, :, :3]
        return Image(ImageKind.RGB, np.ascontiguousarray(arr.astype(np.uint8)))
    if arr.ndim == 2:
        if arr.dtype == np.uint16:
            return Image(ImageKind.GRAY16, np.ascontiguousarray(arr))
        return Image(ImageKind.GRAY8, np.ascontiguousarray(arr.astype(np.uint8)))
    raise ValueError(f"unsupported array shape {arr.shape}")


# --- TIFF ---------------------------------------------------------------

_TIFF_TYPES = {1: "B", 3: "H", 4: "I", 16: "Q"}  # BYTE SHORT LONG LONG8


def _tiff_tags(data: bytes):
    bo = {b"II": "<", b"MM": ">"}[data[:2]]
    magic, ifd = struct.unpack(bo + "HI", data[2:8])
    if magic != 42:
        raise UnsupportedImage("TIFF: BigTIFF and other variants are "
                               "unsupported")
    n, = struct.unpack(bo + "H", data[ifd:ifd + 2])
    tags = {}
    for i in range(n):
        e = ifd + 2 + 12 * i
        tag, typ, count = struct.unpack(bo + "HHI", data[e:e + 8])
        fmt = _TIFF_TYPES.get(typ)
        if fmt is None:
            continue  # rationals, ASCII: nothing the decoder needs
        size = struct.calcsize(fmt) * count
        off = e + 8 if size <= 4 else struct.unpack(
            bo + "I", data[e + 8:e + 12])[0]
        tags[tag] = struct.unpack(bo + fmt * count, data[off:off + size])
    return bo, tags


def _packbits_decode(src: bytes, out_len: int) -> np.ndarray:
    from ..native import packbits_decode_range_native
    out = packbits_decode_range_native(src, out_len)
    if out is not None:
        return out
    out = bytearray()
    i = 0
    while i < len(src) and len(out) < out_len:
        n = src[i] - 256 if src[i] > 127 else src[i]
        i += 1
        if n >= 0:
            out += src[i:i + n + 1]
            i += n + 1
        elif n != -128:
            out += src[i:i + 1] * (1 - n)
            i += 1
    out = np.frombuffer(bytes(out[:out_len]), np.uint8)
    return np.pad(out, (0, out_len - len(out)))


def _decode_tiff(data: bytes) -> Image:
    bo, tags = _tiff_tags(data)
    w, h = tags[256][0], tags[257][0]
    spp = tags.get(277, (1,))[0]
    bits = tags.get(258, (1,))[0]
    comp = tags.get(259, (1,))[0]
    photometric = tags.get(262, (1,))[0]
    if comp not in (1, 32773):
        raise UnsupportedImage(f"TIFF: compression {comp} is unsupported "
                               "(raw and PackBits are)")
    if 322 in tags or tags.get(284, (1,))[0] != 1 or \
            tags.get(317, (1,))[0] != 1:
        raise UnsupportedImage("TIFF: tiled, planar or predictor layouts "
                               "are unsupported")
    if photometric not in (1, 2) or bits not in (8, 16) or \
            (photometric == 2 and spp not in (3, 4)) or \
            (photometric == 1 and spp != 1):
        raise UnsupportedImage(f"TIFF: photometric {photometric}, {spp} x "
                               f"{bits}-bit samples are unsupported")
    dtype = np.dtype(np.uint8 if bits == 8 else bo + "u2")
    row_bytes = w * spp * dtype.itemsize
    rows_per_strip = tags.get(278, (h,))[0]
    strips = []
    for i, (off, n) in enumerate(zip(tags[273], tags[279])):
        nbytes = min(rows_per_strip, h - i * rows_per_strip) * row_bytes
        raw = data[off:off + n]
        strips.append(_packbits_decode(raw, nbytes) if comp == 32773
                      else np.frombuffer(raw[:nbytes], np.uint8))
    px = np.concatenate(strips).view(dtype)
    if photometric == 2:
        return Image(ImageKind.RGB, _rgb8(px.reshape(h, w, spp)))
    px = px.reshape(h, w).astype(dtype.newbyteorder("="))
    return Image(ImageKind.GRAY8 if bits == 8 else ImageKind.GRAY16, px)


def write_tiff(path: Union[str, os.PathLike], pixels: np.ndarray) -> None:
    """Write an uncompressed single-strip TIFF: uint8 [H, W, 3] RGB or
    uint8/uint16 [H, W] grey (what _decode_tiff reads back)."""
    px = np.ascontiguousarray(pixels)
    h, w = px.shape[:2]
    spp = 3 if px.ndim == 3 else 1
    bits = px.dtype.itemsize * 8
    data = px.astype(px.dtype.newbyteorder("<")).tobytes()
    n_tags = 9
    ifd = 8 + len(data)
    extra = ifd + 2 + 12 * n_tags + 4          # BitsPerSample values (RGB)
    entries = [
        (256, 4, 1, w), (257, 4, 1, h),
        (258, 3, spp, extra if spp > 1 else bits),
        (259, 3, 1, 1), (262, 3, 1, 2 if spp > 1 else 1),
        (273, 4, 1, 8), (277, 3, 1, spp), (278, 4, 1, h),
        (279, 4, 1, len(data))]
    out = [b"II*\x00", struct.pack("<I", ifd), data,
           struct.pack("<H", n_tags)]
    for tag, typ, count, value in entries:
        fmt = "<HHIHH" if typ == 3 and count == 1 else "<HHII"
        out.append(struct.pack(fmt, tag, typ, count, value, 0)
                   if fmt == "<HHIHH" else
                   struct.pack(fmt, tag, typ, count, value))
    out.append(struct.pack("<I", 0))
    if spp > 1:
        out.append(struct.pack("<HHH", bits, bits, bits))
    with open(path, "wb") as f:
        f.write(b"".join(out))


# --- PNG ----------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # grey, RGB, RGBA


def _rgb8(px: np.ndarray) -> np.ndarray:
    """[H, W, 3|4] samples -> u8 RGB; 16-bit samples keep their high
    byte (Pillow's RGB;16 unpacking)."""
    px = px[:, :, :3]
    if px.dtype.itemsize == 2:
        px = px >> 8
    return np.ascontiguousarray(px.astype(np.uint8))


def _png_unfilter_numpy(raw: np.ndarray, h: int, stride: int, bpp: int):
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 1:   # Sub: running sum per byte lane
            cur = np.cumsum(np.pad(line, (0, -stride % bpp)).reshape(
                -1, bpp), axis=0).reshape(-1)[:stride]
        elif f == 2:   # Up
            cur = line + prev
        elif f in (3, 4):  # Average, Paeth: left-to-right recurrence
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] & 0xFF if x >= bpp else 0
                b = prev[x]
                if f == 3:
                    cur[x] += (a + b) >> 1
                    continue
                c = prev[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                cur[x] += a if pa <= pb and pa <= pc else (
                    b if pb <= pc else c)
        else:
            raise ValueError("PNG: unknown scanline filter")
        out[y] = cur & 0xFF
        prev = out[y].astype(np.int32)
    return out


def _decode_png(data: bytes) -> Image:
    from ..native.mipops import png_unfilter_native
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, typ = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if typ == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif typ == b"IDAT":
            idat.append(body)
        elif typ == b"IEND":
            break
        pos += 12 + n
    w, h, bits, ctype, _, _, interlace = hdr
    if ctype not in _PNG_CHANNELS or bits not in (8, 16) or interlace:
        raise UnsupportedImage(f"PNG: colour type {ctype}, {bits}-bit, "
                               f"interlace {interlace} is unsupported")
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * bits // 8
    raw = zlib.decompress(b"".join(idat))
    rows = png_unfilter_native(raw, h, w * bpp, bpp)
    if rows is None:
        rows = _png_unfilter_numpy(np.frombuffer(raw, np.uint8), h, w * bpp,
                                   bpp)
    px = rows.reshape(h, w, ch) if bits == 8 else \
        rows.view(">u2").reshape(h, w, ch).astype(np.uint16)
    if ctype in (2, 6):
        return Image(ImageKind.RGB, _rgb8(px))
    px = np.ascontiguousarray(px[:, :, 0])
    return Image(ImageKind.GRAY8 if bits == 8 else ImageKind.GRAY16, px)


def _from_pil(img) -> Image:
    if img.mode in ("I;16", "I;16B", "I;16L"):
        arr = np.array(img, dtype=np.uint16)
        return Image(ImageKind.GRAY16, arr)
    if img.mode == "I":
        # 32-bit integer gray (PIL may promote 16-bit PNG): clamp to u16
        arr = np.array(img, dtype=np.int32)
        return Image(ImageKind.GRAY16, arr.astype(np.uint16))
    if img.mode == "L":
        return Image(ImageKind.GRAY8, np.array(img, dtype=np.uint8))
    if img.mode in ("RGB", "RGBA", "P", "CMYK", "YCbCr"):
        rgb = img.convert("RGB")
        return Image(ImageKind.RGB, np.array(rgb, dtype=np.uint8))
    # Fall back: let PIL pick a conversion
    return Image(ImageKind.RGB, np.array(img.convert("RGB"), dtype=np.uint8))


def load_image(src: Union[str, bytes, os.PathLike, _io.IOBase]) -> Image:
    """Decode an image from a path, bytes, or stream.

    Counterpart of ImageArrayUtils.readImageArray (ImageArrayUtils.java:98-121).
    TIFF and PNG decode here; other formats, and TIFF/PNG variants the
    NumPy decoder does not handle, need the optional Pillow.
    """
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            data = f.read()
    elif isinstance(src, bytes):
        data = src
    else:
        data = src.read()
    decode = (_decode_tiff if data[:4] in (b"II*\x00", b"MM\x00*") else
              _decode_png if data[:8] == _PNG_SIG else None)
    unsupported = None
    if decode is not None:
        try:
            return decode(data)
        except UnsupportedImage as e:
            unsupported = e
    try:
        from PIL import Image as PILImage
    except ImportError:
        if unsupported is not None:
            raise UnsupportedImage(f"{unsupported}; decoding it needs "
                                   "Pillow (pip install pillow)") from None
        raise ValueError("not a TIFF or PNG image; decoding BMP, GIF or "
                         "JPEG needs Pillow (pip install pillow)") from None
    with PILImage.open(_io.BytesIO(data)) as img:
        img.load()
        return _from_pil(img)
