"""Pillow-free TIFF/PNG decoding and the compile-cache location.

The NumPy + zlib decoder serves every .tif/.png the pipeline reads; it
must reproduce Pillow's decode exactly (Pillow stays a test-only
reference here and an optional dependency for BMP/GIF/JPEG)."""

import io
import pathlib
import sys

import numpy as np
import pytest

from colormipsearch_tpu.imageproc import io as imio

FIXTURE_ROOT = pathlib.Path(__file__).parent / "fixtures"
IMAGES = sorted(str(p.relative_to(FIXTURE_ROOT))
                for p in FIXTURE_ROOT.rglob("*")
                if p.suffix in (".tif", ".png"))


@pytest.mark.parametrize("rel", IMAGES)
def test_decoder_matches_pillow_on_fixture(rel):
    PIL = pytest.importorskip("PIL.Image")
    got = imio.load_image(FIXTURE_ROOT / rel)
    with PIL.open(FIXTURE_ROOT / rel) as im:
        im.load()
        want = imio._from_pil(im)
    assert got.kind == want.kind
    assert got.pixels.dtype == want.pixels.dtype
    np.testing.assert_array_equal(got.pixels, want.pixels)


def _pil_bytes(arr, fmt, **kw):
    PIL = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    PIL.fromarray(arr).save(buf, format=fmt, **kw)
    return buf.getvalue()


def _smooth(shape, dtype, seed):
    """Images with smooth runs, so the PNG encoder picks every filter."""
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    arr = (rng.random(shape) * top).astype(dtype)
    arr[4:12] = arr[4:5]
    ramp = np.linspace(0, top, shape[1]).astype(dtype)
    arr[12:20] = ramp[None, :, None] if arr.ndim == 3 else ramp[None]
    return arr


def _png16_colour(arr):
    """A 16-bit RGB/RGBA PNG (Pillow cannot write one), filter 0."""
    import struct
    import zlib
    h, w, c = arr.shape

    def chunk(typ, body):
        return (struct.pack(">I", len(body)) + typ + body
                + struct.pack(">I", zlib.crc32(typ + body)))
    raw = b"".join(b"\0" + row.astype(">u2").tobytes() for row in arr)
    return (imio._PNG_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16,
                                         {3: 2, 4: 6}[c], 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape,dtype", [
    ((23, 41, 3), np.uint8), ((23, 41), np.uint8), ((23, 41), np.uint16),
    ((23, 41, 4), np.uint8), ((23, 41, 3), np.uint16),
    ((23, 41, 4), np.uint16)])
def test_png_all_filters_match_pillow(shape, dtype):
    arr = _smooth(shape, dtype, 1)
    if arr.ndim == 3 and dtype == np.uint16:
        data = _png16_colour(arr)
        want = (arr[..., :3] >> 8).astype(np.uint8)  # the RGB u8 contract
    else:
        data = _pil_bytes(arr, "PNG")
        want = arr[..., :3] if arr.ndim == 3 else arr
    got = imio.load_image(data)
    assert got.pixels.dtype == want.dtype
    np.testing.assert_array_equal(got.pixels, want)
    PIL = pytest.importorskip("PIL.Image")
    with PIL.open(io.BytesIO(data)) as im:
        im.load()
        np.testing.assert_array_equal(imio._from_pil(im).pixels, want)


def test_numpy_unfilter_equals_native():
    import zlib
    from colormipsearch_tpu.native.mipops import png_unfilter_native
    arr = _smooth((23, 41, 3), np.uint8, 2)
    data = _pil_bytes(arr, "PNG")
    idat = b"".join(data[p + 8:p + 8 + n] for p, n in _chunks(data, b"IDAT"))
    raw = zlib.decompress(idat)
    filters = {raw[y * (41 * 3 + 1)] for y in range(23)}
    assert len(filters) > 1
    want = png_unfilter_native(raw, 23, 41 * 3, 3)
    if want is None:
        pytest.skip("native helper unavailable")
    got = imio._png_unfilter_numpy(np.frombuffer(raw, np.uint8), 23,
                                   41 * 3, 3)
    np.testing.assert_array_equal(got, want)


def _chunks(data, typ):
    import struct
    pos = 8
    while pos < len(data):
        n, t = struct.unpack(">I4s", data[pos:pos + 8])
        if t == typ:
            yield pos, n
        pos += 12 + n


@pytest.mark.parametrize("shape,dtype,compression", [
    ((19, 33, 3), np.uint8, "raw"), ((19, 33, 3), np.uint8, "packbits"),
    ((19, 33), np.uint8, "raw"), ((19, 33), np.uint8, "packbits"),
    ((19, 33), np.uint16, "raw")])
def test_tiff_variants_match_pillow(shape, dtype, compression):
    arr = _smooth(shape, dtype, 3)
    data = _pil_bytes(arr, "TIFF", compression=compression)
    np.testing.assert_array_equal(imio.load_image(data).pixels, arr)


def test_numpy_packbits_matches_native():
    from colormipsearch_tpu.native import packbits_decode_range_native
    raw = (FIXTURE_ROOT / "imageprocessing" / "compressed_pack1.tif"
           ).read_bytes()
    _, tags = imio._tiff_tags(raw)
    off, n = tags[273][0], tags[279][0]
    strip = raw[off:off + n]
    out_len = 256 * 3 * tags.get(278, (256,))[0]
    want = packbits_decode_range_native(strip, out_len)
    if want is None:
        pytest.skip("native helper unavailable")
    import colormipsearch_tpu.native as native
    orig = native.packbits_decode_range_native
    native.packbits_decode_range_native = lambda *a, **k: None
    try:
        got = imio._packbits_decode(strip, out_len)
    finally:
        native.packbits_decode_range_native = orig
    np.testing.assert_array_equal(got, want)


def test_other_formats_need_pillow(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="Pillow"):
        imio.load_image(b"BM" + b"\0" * 64)


def test_unsupported_tiff_compression_is_an_error(monkeypatch):
    """An LZW TIFF decodes through Pillow when it is installed and is an
    error naming the compression when it is not."""
    arr = _smooth((8, 8, 3), np.uint8, 4)
    data = _pil_bytes(arr, "TIFF", compression="tiff_lzw")
    np.testing.assert_array_equal(imio.load_image(data).pixels, arr)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="compression.*Pillow"):
        imio.load_image(data)


@pytest.mark.parametrize("variant", ["palette", "grey_alpha", "one_bit",
                                     "deflate_tiff"])
def test_unsupported_variants_fall_back_to_pillow(variant, monkeypatch):
    """Variants the NumPy decoder leaves out decode as Pillow decodes
    them, and need Pillow."""
    PIL = pytest.importorskip("PIL.Image")
    rgb = _smooth((16, 24, 3), np.uint8, 6)
    buf = io.BytesIO()
    if variant == "palette":
        PIL.fromarray(rgb).quantize(16).save(buf, format="PNG")
    elif variant == "grey_alpha":
        PIL.fromarray(rgb).convert("LA").save(buf, format="PNG")
    elif variant == "one_bit":
        PIL.fromarray(rgb).convert("1").save(buf, format="PNG")
    else:
        PIL.fromarray(rgb).save(buf, format="TIFF",
                                compression="tiff_adobe_deflate")
    data = buf.getvalue()
    with PIL.open(io.BytesIO(data)) as im:
        im.load()
        want = imio._from_pil(im)
    got = imio.load_image(data)
    assert got.kind == want.kind
    np.testing.assert_array_equal(got.pixels, want.pixels)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(imio.UnsupportedImage, match="Pillow"):
        imio.load_image(data)


def test_cli_pipeline_without_pillow(tmp_path, fixtures_dir, monkeypatch):
    """colorDepthSearch + gradientScores on the fixtures with Pillow
    unimportable: the production inputs decode without it."""
    import json
    import os
    from colormipsearch_tpu.cmd.main import main
    from colormipsearch_tpu.dataio import JSONCDMIPsWriter
    from colormipsearch_tpu.model import (ComputeFileType, EMNeuronEntity,
                                          FileData, LMNeuronEntity)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    name = "VT016795_115C08_AE_01-20200221_61_I2-m-CH1_01"
    em = EMNeuronEntity(entity_id=1, mip_id="em",
                        alignment_space="JRC2018_Unisex_20x_HR",
                        library_name="em", published_name="12191")
    em.compute_files[ComputeFileType.InputColorDepthImage] = \
        FileData.from_string(str(fixtures_dir / "ems" / "12191_JRC2018U.tif"))
    lm = LMNeuronEntity(entity_id=2, mip_id="lm",
                        alignment_space="JRC2018_Unisex_20x_HR",
                        library_name="lm", published_name="VT016795",
                        slide_code="sc", anatomical_area="Brain")
    lm.compute_files[ComputeFileType.InputColorDepthImage] = \
        FileData.from_string(str(fixtures_dir / "lms" / f"{name}.tif"))
    lm.compute_files[ComputeFileType.GradientImage] = \
        FileData.from_string(str(fixtures_dir / "grad" / f"{name}.png"))
    for fname, ents in (("masks.json", [em]), ("targets.json", [lm])):
        w = JSONCDMIPsWriter(str(tmp_path / fname))
        w.open()
        w.write(ents)
        w.close()
    out = str(tmp_path / "out")
    assert main(["colorDepthSearch", "-m", str(tmp_path / "masks.json"),
                 "-i", str(tmp_path / "targets.json"),
                 "--maskThreshold", "20", "--dataThreshold", "20",
                 "--pixColorFluctuation", "1", "--xyShift", "2",
                 "--mirrorMask", "-od", out]) == 0
    per_mask = os.path.join(out, "masks")
    assert main(["gradientScores", "-md", per_mask, "--maskThreshold", "20",
                 "--mirrorMask", "--computeZGapOnTheFly"]) == 0
    with open(os.path.join(per_mask, "em.json")) as f:
        res = json.load(f)["results"][0]
    assert res["matchingPixels"] == 426 and res["mirrored"] is True
    assert res["gradientAreaGap"] == 40696


def test_compile_cache_defaults_to_repo(monkeypatch):
    import jax
    from colormipsearch_tpu.utils import compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.configure_compile_cache()
        repo = pathlib.Path(__file__).resolve().parents[1]
        assert path == str(repo / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    import jax
    from colormipsearch_tpu.utils import compile_cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.configure_compile_cache() == str(tmp_path)
        # nothing set in code: JAX's own reading of the variable stands
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_tiff_16bit_rgb_keeps_high_byte(tmp_path):
    """16-bit RGB TIFF samples become u8 RGB by their high byte, as
    Pillow reads them."""
    arr = _smooth((17, 29, 3), np.uint16, 7)
    path = tmp_path / "x.tif"
    imio.write_tiff(path, arr)
    got = imio.load_image(path)
    assert got.kind == imio.ImageKind.RGB and got.pixels.dtype == np.uint8
    np.testing.assert_array_equal(got.pixels, (arr >> 8).astype(np.uint8))
    PIL = pytest.importorskip("PIL.Image")
    with PIL.open(path) as im:
        im.load()
        np.testing.assert_array_equal(imio._from_pil(im).pixels, got.pixels)


@pytest.mark.parametrize("shape,dtype", [((17, 29, 3), np.uint8),
                                         ((17, 29), np.uint8),
                                         ((17, 29), np.uint16)])
def test_write_tiff_round_trip(tmp_path, shape, dtype):
    """write_tiff (used to stage libraries without Pillow) reads back
    through the decoder and through Pillow unchanged."""
    arr = _smooth(shape, dtype, 5)
    path = tmp_path / "x.tif"
    imio.write_tiff(path, arr)
    np.testing.assert_array_equal(imio.load_image(path).pixels, arr)
    PIL = pytest.importorskip("PIL.Image")
    with PIL.open(path) as im:
        np.testing.assert_array_equal(np.array(im), arr)
