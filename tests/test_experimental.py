"""Experimental features (mirror of experimental_features.rs): deep pixels,
HDR tonemap, adjustment layers, PFE v3 round-trip, 16-bit export, dirty
region sync."""

import numpy as np
import pytest

from paintfe_tpu.core.canvas import Canvas, Layer, LayerFolder
from paintfe_tpu.core.deep import (
    AdjustmentKind,
    AdjustmentLayerData,
    DeepRgbaBuffer,
    HdrMetadata,
    ImageMetadata,
    PixelFormat,
    f16_bits_to_f32,
    f32_to_f16_bits,
    reinhard_tone_map,
)
from paintfe_tpu.core import fixtures
from paintfe_tpu.io import pfe


def test_deep_formats_round_trip():
    # experimental_features.rs:11-28: 17/128/251/255 round-trips within 1
    img = np.zeros((2, 2, 4), np.uint8)
    img[...] = [17, 128, 251, 255]
    for fmt in PixelFormat:
        deep = DeepRgbaBuffer.from_rgba8(img, fmt)
        assert PixelFormat(deep.format) == fmt
        back = deep.to_rgba8(2, 2)
        px = back[0, 0]
        assert abs(int(px[0]) - 17) <= 1
        assert abs(int(px[1]) - 128) <= 1
        assert abs(int(px[2]) - 251) <= 1
        assert px[3] == 255


def test_f16_bits_conversion():
    vals = np.array([0.0, 0.5, 1.0, 0.12345], np.float32)
    bits = f32_to_f16_bits(vals)
    back = f16_bits_to_f32(bits)
    assert np.abs(back - vals).max() < 1e-3
    assert bits[0] == 0 and bits[2] == 0x3C00  # 1.0 in f16


def test_reinhard_tonemap():
    # experimental_features.rs:33-38
    px = reinhard_tone_map(np.array([4.0, 1.0, 0.0, 0.5019608], np.float32), 1.0)
    assert px[0] > px[1]
    assert px[2] == 0
    assert px[3] == 128
    assert px[0] < 255


def test_adjustment_layer_composite():
    # experimental_features.rs:42-56
    c = Canvas.from_image(fixtures.solid(4, 4, (10, 20, 30, 255)))
    adj = Layer.new("invert", 4, 4)
    adj.content = "adjustment"
    adj.adjustment = AdjustmentLayerData(kind=AdjustmentKind.INVERT)
    c.layers.append(adj)
    out = c.composite()
    np.testing.assert_array_equal(out[0, 0], [245, 235, 225, 255])
    np.testing.assert_array_equal(c.layers[0].pixels[0, 0], [10, 20, 30, 255])


def test_adjustment_layer_opacity():
    # experimental_features.rs:60-69: invert at 50% over (10,20,30) -> gray mix
    c = Canvas.from_image(fixtures.solid(4, 4, (128, 128, 128, 255)))
    adj = Layer.new("invert", 4, 4)
    adj.content = "adjustment"
    adj.adjustment = AdjustmentLayerData(kind=AdjustmentKind.INVERT)
    adj.opacity = 0.5
    c.layers.append(adj)
    np.testing.assert_array_equal(c.composite()[0, 0], [128, 128, 128, 255])


def test_exposure_adjustment_layer():
    c = Canvas.from_image(fixtures.solid(4, 4, (50, 100, 200, 255)))
    adj = Layer.new("exp", 4, 4)
    adj.content = "adjustment"
    adj.adjustment = AdjustmentLayerData(kind=AdjustmentKind.EXPOSURE, ev=1.0)
    c.layers.append(adj)
    np.testing.assert_array_equal(c.composite()[0, 0], [100, 200, 255, 255])


def test_pfe3_round_trip(tmp_path):
    # experimental_features.rs:86-117
    c = Canvas.from_image(fixtures.test_gradient(64, 64))
    c.folders.append(LayerFolder(id=3, name="group", visible=True))
    c.layers[0].folder_id = 3
    c.layers[0].pixel_format = PixelFormat.RGBA_F32
    c.layers[0].deep_pixels = DeepRgbaBuffer.from_rgba8(
        c.layers[0].pixels, PixelFormat.RGBA_F32
    )
    c.layers[0].hdr_metadata = HdrMetadata(enabled=True, max_luminance_nits=1000.0)
    c.layers[0].source_metadata = ImageMetadata(source_format="png")
    adj = Layer.new("bc", 64, 64)
    adj.content = "adjustment"
    adj.adjustment = AdjustmentLayerData(
        kind=AdjustmentKind.BRIGHTNESS_CONTRAST, brightness=10.0, contrast=5.0
    )
    c.layers.append(adj)

    p = tmp_path / "exp.pfe"
    pfe.save_pfe(c, str(p))
    loaded = pfe.load_pfe(str(p))

    assert loaded.layers[0].pixel_format == PixelFormat.RGBA_F32
    assert loaded.layers[0].hdr_metadata.enabled
    assert loaded.layers[0].hdr_metadata.max_luminance_nits == 1000.0
    assert loaded.layers[0].folder_id == 3
    assert loaded.folders[0].name == "group"
    assert loaded.layers[1].content == "adjustment"
    assert loaded.layers[1].adjustment.kind == AdjustmentKind.BRIGHTNESS_CONTRAST
    assert loaded.layers[1].adjustment.brightness == 10.0
    np.testing.assert_array_equal(
        loaded.layers[0].deep_pixels.data, c.layers[0].deep_pixels.data
    )
    np.testing.assert_array_equal(loaded.layers[0].pixels, c.layers[0].pixels)


def test_16bit_deep_preserved_through_pfe(tmp_path):
    # 16-bit payload round-trips exactly (experimental_features.rs:120-163)
    c = Canvas.from_image(fixtures.test_gradient(8, 8))
    c.layers[0].pixel_format = PixelFormat.RGBA_U16
    deep = DeepRgbaBuffer.from_rgba8(c.layers[0].pixels, PixelFormat.RGBA_U16)
    deep.data[0:4] = [12345, 23456, 34567, 45678]  # non-u8-representable values
    c.layers[0].deep_pixels = deep
    p = tmp_path / "u16.pfe"
    pfe.save_pfe(c, str(p))
    loaded = pfe.load_pfe(str(p))
    np.testing.assert_array_equal(loaded.layers[0].deep_pixels.data[0:4],
                                  [12345, 23456, 34567, 45678])


def test_dirty_region_deep_sync():
    # experimental_features.rs:199-222: editing syncs only the dirty region
    img = fixtures.test_gradient(8, 8)
    deep = DeepRgbaBuffer.from_rgba8(img, PixelFormat.RGBA_U16)
    orig = deep.data.copy()
    edited = img.copy()
    edited[0, 0] = [10, 20, 30, 40]
    deep.sync_region_from_u8(edited, 0, 0, 1, 1)
    np.testing.assert_array_equal(deep.data[0:4], [2570, 5140, 7710, 10280])
    np.testing.assert_array_equal(deep.data[4:8], orig[4:8])


# -- deep export pipeline (io.rs:1413-1631, experimental_features.rs:120-297) --


def _deep_canvas(img, fmt):
    from paintfe_tpu.core.canvas import Canvas
    from paintfe_tpu.core.deep import DeepRgbaBuffer

    c = Canvas.from_image(img)
    c.layers[0].pixel_format = fmt
    c.layers[0].deep_pixels = DeepRgbaBuffer.from_rgba8(img, fmt)
    return c


def test_prepare_export_single_deep_u16(tmp_path):
    from paintfe_tpu.core.deep import PixelFormat
    from paintfe_tpu.io import deep_export as de

    img = np.random.default_rng(1).integers(0, 256, (12, 10, 4), np.uint8)
    prep = de.prepare_export_image(_deep_canvas(img, PixelFormat.RGBA_U16))
    assert prep.kind == "rgba16"
    np.testing.assert_array_equal(
        prep.data.reshape(12, 10, 4), img.astype(np.uint16) * 257
    )


def test_png16_roundtrip(tmp_path):
    from paintfe_tpu.io import deep_export as de

    u16 = np.random.default_rng(2).integers(0, 65536, (9, 7, 4), np.uint16)
    path = tmp_path / "x.png"
    de.write_png16(path, 7, 9, u16)
    np.testing.assert_array_equal(de.read_png16(path), u16)
    # loads back as a deep layer with round(v*255/65535) preview
    preview, fmt, buf = de.load_deep_image(path)
    np.testing.assert_array_equal(buf.data.reshape(9, 7, 4), u16)
    np.testing.assert_array_equal(
        preview, ((u16.astype(np.uint32) + 128) // 257).astype(np.uint8)
    )


@pytest.mark.parametrize("comp", ["none", "lzw", "deflate"])
def test_tiff16_roundtrip(tmp_path, comp):
    from paintfe_tpu.io import deep_export as de

    u16 = np.random.default_rng(3).integers(0, 65536, (8, 8, 4), np.uint16)
    path = tmp_path / f"x_{comp}.tiff"
    de.write_tiff16(path, 8, 8, u16, comp)
    np.testing.assert_array_equal(de.read_tiff_deep(path), u16)
    # PIL can open the container (depth is flattened, but it must decode)
    from PIL import Image

    assert Image.open(path).size == (8, 8)


def test_tiff_f32_roundtrip(tmp_path):
    from paintfe_tpu.io import deep_export as de

    f = np.random.default_rng(4).random((6, 5, 4), np.float32) * 2.0
    path = tmp_path / "x.tiff"
    de.write_tiff_f32(path, 5, 6, f)
    np.testing.assert_array_equal(de.read_tiff_deep(path), f)


def test_adjusted_deep_export_applies_in_f32():
    from paintfe_tpu.core.canvas import Layer
    from paintfe_tpu.core.deep import (
        AdjustmentKind, AdjustmentLayerData, PixelFormat,
    )
    from paintfe_tpu.io import deep_export as de

    img = np.random.default_rng(5).integers(0, 256, (8, 8, 4), np.uint8)
    c = _deep_canvas(img, PixelFormat.RGBA_U16)
    adj = Layer.new("adj", 8, 8)
    adj.content = "adjustment"
    adj.adjustment = AdjustmentLayerData(kind=AdjustmentKind.EXPOSURE, ev=1.0)
    c.layers.append(adj)
    prep = de.prepare_export_image(c)
    assert prep.kind == "rgba16"
    f = img.astype(np.float32) / np.float32(255.0)
    expected = f * np.array([2, 2, 2, 1], np.float32)
    expected = np.floor(np.clip(expected, 0, 1) * 65535.0 + 0.5).astype(np.uint16)
    np.testing.assert_array_equal(prep.data, expected)


def test_composite_promotion_and_rgba8_fallbacks():
    from paintfe_tpu.core.canvas import Canvas
    from paintfe_tpu.core.deep import PixelFormat
    from paintfe_tpu.io import deep_export as de

    img = np.random.default_rng(6).integers(0, 256, (8, 8, 4), np.uint8)
    c = Canvas.from_image(img)
    c.layers[0].pixel_format = PixelFormat.RGBA_U16  # no deep buffer in sync
    prep = de.prepare_export_image(c)
    assert prep.kind == "rgba16"
    np.testing.assert_array_equal(
        prep.data, np.asarray(c.composite()).astype(np.uint16) * 257
    )
    # u16 -> u8 via (v+128)/257
    down = de.prepared_to_rgba8(prep)
    np.testing.assert_array_equal(down, np.asarray(c.composite()))
    # f32 HDR pixels tone-map with Reinhard, SDR pixels round directly
    hdr = de.PreparedExport(
        "rgbaf32", 2, 1,
        np.array([[[2.0, 0.5, 0.1, 1.0], [0.5, 0.5, 0.5, 1.0]]], np.float32),
    )
    out = de.prepared_to_rgba8(hdr)
    np.testing.assert_array_equal(out[0, 0], [170, 85, 23, 255])  # 2/(1+2)*255
    np.testing.assert_array_equal(out[0, 1], [128, 128, 128, 255])


def test_cli_deep_png_to_tiff(tmp_path):
    """16-bit PNG in -> 16-bit TIFF out through the CLI, depth preserved."""
    from paintfe_tpu.cli import main
    from paintfe_tpu.io import deep_export as de

    u16 = np.random.default_rng(7).integers(0, 65536, (8, 8, 4), np.uint16)
    src = tmp_path / "in.png"
    de.write_png16(src, 8, 8, u16)
    rc = main(["-i", str(src), "--output-dir", str(tmp_path / "out"),
               "-f", "tiff", "--tiff-compression", "lzw"])
    assert rc == 0
    back = de.read_tiff_deep(tmp_path / "out" / "in.tiff")
    np.testing.assert_array_equal(back, u16)


# -- native byte codecs (native/bytecodec.cpp) vs the Python oracles ---------


def _forward_filter_png16(pixels: np.ndarray, filters) -> bytes:
    """Test-side encoder: apply the PNG forward filters per row (the spec's
    inverse of read_png16's reconstruction) so foreign adaptive-filtered
    files are representable."""
    h, w = pixels.shape[:2]
    data = np.ascontiguousarray(pixels, dtype=">u2").reshape(h, w * 4)
    rows = data.view(np.uint8).reshape(h, w * 8).astype(np.int32)
    bpp = 8
    raw = bytearray()
    prev = np.zeros(w * 8, np.int32)
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        f = filters[y % len(filters)]
        if f == 0:
            enc = cur
        elif f == 1:
            enc = cur - left
        elif f == 2:
            enc = cur - prev
        elif f == 3:
            enc = cur - ((left + prev) >> 1)
        else:  # Paeth
            pa = np.abs(prev - upleft)
            pb = np.abs(left - upleft)
            pc = np.abs(left + prev - 2 * upleft)
            pr = np.where((pa <= pb) & (pa <= pc), left,
                          np.where(pb <= pc, prev, upleft))
            enc = cur - pr
        raw.append(f)
        raw += (enc & 0xFF).astype(np.uint8).tobytes()
        prev = cur
    return bytes(raw)


def _write_png16_filtered(path, pixels: np.ndarray, filters):
    import struct as _struct
    import zlib as _zlib

    from paintfe_tpu.io.png import chunk

    h, w = pixels.shape[:2]
    raw = _forward_filter_png16(pixels, filters)
    ihdr = _struct.pack(">IIBBBBB", w, h, 16, 6, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", ihdr))
        fh.write(chunk(b"IDAT", _zlib.compress(raw, 6)))
        fh.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
def test_png16_adaptive_filters_native_matches_oracle(tmp_path, filters,
                                                      monkeypatch):
    """Foreign 16-bit PNGs use filters 1-4; the native defilter and the
    Python oracle must reconstruct identical pixels."""
    from paintfe_tpu.io import deep_export as de
    from paintfe_tpu.io import png

    rng = np.random.default_rng(sum(filters) + 11)
    u16 = rng.integers(0, 65536, (10, 13, 4), np.uint16)
    path = tmp_path / "f.png"
    _write_png16_filtered(path, u16, filters)
    native_out = de.read_png16(path)
    np.testing.assert_array_equal(native_out, u16)
    # force the Python oracle and compare
    monkeypatch.setattr(png, "_defilter_native", lambda *a: None)
    np.testing.assert_array_equal(de.read_png16(path), u16)


def test_lzw_native_matches_python_oracle(monkeypatch):
    from paintfe_tpu.io import deep_export as de

    rng = np.random.default_rng(5)
    cases = [
        b"",
        b"\x00" * 5000,                                   # long run
        bytes(rng.integers(0, 256, 4096, dtype=np.uint8).tolist()),  # noise
        bytes((rng.integers(0, 4, 70000, dtype=np.uint8) * 64).tolist()),
        # enough repetition to overflow the 12-bit table and force a
        # mid-stream Clear
        bytes(rng.integers(0, 256, 200000, dtype=np.uint8).tolist()),
    ]
    for data in cases:
        fast = de._lzw_encode(data)
        monkeypatch.setattr(de, "_lzw_encode_native", lambda d: None)
        slow = de._lzw_encode(data)
        monkeypatch.undo()
        assert fast == slow, f"native/python LZW divergence on {len(data)}B"


# -- PFE V2 (text layers) + V3 metadata promotion ----------------------------


def test_pfe_v2_text_layer_roundtrip(tmp_path):
    from paintfe_tpu.ops.text_layer import (
        ArcWarp, OutlineEffect, OutlinePosition, ParagraphStyle, ShadowEffect,
        TextAlignment, TextBlock, TextEffects, TextLayerData, TextRun,
        TextStyle,
    )

    c = Canvas.from_image(fixtures.test_gradient(64, 64))
    tl = Layer.new("caption", 64, 64)
    tl.content = "text"
    td = TextLayerData()
    block = TextBlock(
        position=(5.0, 7.0), rotation=12.5,
        runs=[TextRun(text="Hi", style=TextStyle(font_size=18.0,
                                                 color=(10, 20, 30, 255),
                                                 italic=True))],
        paragraph=ParagraphStyle(alignment=TextAlignment.CENTER,
                                 line_spacing=1.5),
        max_width=120.0, warp=ArcWarp(bend=0.25),
    )
    td.add_block(block)
    td.effects = TextEffects(
        outline=OutlineEffect(color=(1, 2, 3, 255), width=3.0,
                              position=OutlinePosition.CENTER),
        shadow=ShadowEffect(offset_x=4.0, blur_radius=1.5),
    )
    tl.text_data = td
    tl.pixels = td.rasterize(64, 64)
    c.layers.append(tl)

    p = tmp_path / "text.pfe"
    pfe.save_pfe(c, str(p))
    with open(p, "rb") as fh:
        assert fh.read(12)[8:] == b"PFE2"  # text-only canvas selects V2

    loaded = pfe.load_pfe(str(p))
    lt = loaded.layers[1]
    assert lt.content == "text"
    assert lt.text_data is not None
    blk = lt.text_data.blocks[0]
    assert blk.position == (5.0, 7.0) and blk.rotation == 12.5
    assert blk.runs[0].text == "Hi"
    assert blk.runs[0].style.font_size == 18.0
    assert blk.runs[0].style.color == (10, 20, 30, 255)
    assert blk.runs[0].style.italic
    assert blk.paragraph.alignment == TextAlignment.CENTER
    assert blk.max_width == 120.0
    assert type(blk.warp).__name__ == "ArcWarp" and blk.warp.bend == 0.25
    eff = lt.text_data.effects
    assert eff.outline.position == OutlinePosition.CENTER
    assert eff.outline.width == 3.0
    assert eff.shadow.offset_x == 4.0 and eff.shadow.blur_radius == 1.5
    np.testing.assert_array_equal(lt.pixels, tl.pixels)


def test_pfe_v3_promotion_on_source_metadata(tmp_path):
    """source_metadata (source_format / png_text_chunks) promotes to V3 like
    build_pfe's has_experimental_layers (io.rs:257-276); a V1 write would
    silently drop it."""
    c = Canvas.from_image(fixtures.test_gradient(32, 32))
    c.layers[0].source_metadata = ImageMetadata(
        source_format="png", png_text_chunks=[("Title", "x")])
    p = tmp_path / "meta.pfe"
    pfe.save_pfe(c, str(p))
    with open(p, "rb") as fh:
        assert fh.read(12)[8:] == b"PFE3"
    loaded = pfe.load_pfe(str(p))
    assert loaded.layers[0].source_metadata.source_format == "png"
    assert loaded.layers[0].source_metadata.png_text_chunks == [("Title", "x")]


def test_pfe_v3_text_layer_keeps_text_data(tmp_path):
    from paintfe_tpu.ops.text_layer import TextBlock, TextLayerData, TextRun

    c = Canvas.from_image(fixtures.test_gradient(32, 32))
    c.layers[0].source_metadata = ImageMetadata(source_format="png")  # force V3
    tl = Layer.new("t", 32, 32)
    tl.content = "text"
    td = TextLayerData()
    td.add_block(TextBlock(position=(1.0, 2.0), runs=[TextRun(text="v3")]))
    tl.text_data = td
    c.layers.append(tl)
    p = tmp_path / "t3.pfe"
    pfe.save_pfe(c, str(p))
    loaded = pfe.load_pfe(str(p))
    assert loaded.layers[1].content == "text"
    assert loaded.layers[1].text_data.blocks[0].runs[0].text == "v3"
