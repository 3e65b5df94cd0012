"""The zlib + numpy PNG codec (io/png.py) and the Pillow-free CLI path.

Pillow is installed in the test environment, so it serves as the
independent oracle: it decodes what the codec writes, and writes the
adaptive-filtered, RGB and palette files the codec (or its Pillow
fallback) must read.
"""

import io
import os
import pathlib
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from paintfe_tpu.io import codecs, png

REPO = pathlib.Path(__file__).resolve().parent.parent


def _image(h, w, channels, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([xx * 7, yy * 5, xx + yy, xx * yy][:channels], -1)
    noise = rng.integers(0, 24, (h, w, channels))
    return ((smooth + noise) % 256).astype(np.uint8)


def _forward_filter(pixels: np.ndarray, filters) -> bytes:
    """PNG filter types applied per row (spec §9), cycling `filters`."""
    h = pixels.shape[0]
    bpp = pixels.shape[2] * pixels.itemsize
    rows = np.ascontiguousarray(pixels).view(np.uint8).reshape(h, -1)
    rows = rows.astype(np.int32)
    prev = np.zeros(rows.shape[1], np.int32)
    raw = bytearray()
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
        else:
            pa = np.abs(prev - upleft)
            pb = np.abs(left - upleft)
            pc = np.abs(left + prev - 2 * upleft)
            enc = cur - np.where((pa <= pb) & (pa <= pc), left,
                                 np.where(pb <= pc, prev, upleft))
        raw.append(f)
        raw += (enc & 0xFF).astype(np.uint8).tobytes()
        prev = cur
    return bytes(raw)


def _png_bytes(pixels: np.ndarray, filters) -> bytes:
    h, w, c = pixels.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    return (png.SIGNATURE + png.chunk(b"IHDR", ihdr)
            + png.chunk(b"IDAT", zlib.compress(_forward_filter(pixels, filters)))
            + png.chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("channels", [3, 4])
def test_decode_every_filter_type(filters, channels):
    """Each filter type, and a per-row mix, reconstructs the pixels in RGB
    and RGBA files; Pillow agrees on the same bytes."""
    img = _image(19, 23, channels, seed=sum(filters) + channels)
    blob = _png_bytes(img, filters)
    assert png.is_plain(blob)
    got = png.decode(blob)
    want = img if channels == 4 else np.concatenate(
        [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)
    np.testing.assert_array_equal(got, want)
    pil = np.asarray(Image.open(io.BytesIO(blob)).convert("RGBA"))
    np.testing.assert_array_equal(got, pil)


@pytest.mark.parametrize("filters", [(3,), (4,), (0, 1, 2, 3, 4)])
def test_serial_filters_without_native_library(filters, monkeypatch):
    """Average and Paeth rows decode identically through the Python
    fallback when the native defilter is unavailable."""
    img = _image(9, 11, 4, seed=7)
    blob = _png_bytes(img, filters)
    monkeypatch.setattr(png, "_defilter_native", lambda *a: None)
    np.testing.assert_array_equal(png.decode(blob), img)


@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (64, 300)])
def test_encode_roundtrip_and_pillow_reads_it(tmp_path, shape):
    img = _image(*shape, 4, seed=shape[1])
    path = tmp_path / "o.png"
    codecs.save_image(img, path, "png")
    np.testing.assert_array_equal(codecs.load_image(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_u16_roundtrip():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 65536, (13, 17, 4), np.uint16)
    np.testing.assert_array_equal(png.decode(png.encode(img)), img)


def test_pillow_written_files_load_identically(tmp_path):
    """Pillow's own adaptive-filtered RGBA/RGB and its palette output:
    the first two take the codec, the palette file the Pillow fallback."""
    img = _image(40, 50, 4, seed=1)
    for mode in ("RGBA", "RGB", "P"):
        pim = Image.fromarray(img, "RGBA")
        pim = pim.convert(mode) if mode != "RGBA" else pim
        path = tmp_path / f"{mode}.png"
        pim.save(path)
        want = np.asarray(Image.open(path).convert("RGBA"))
        np.testing.assert_array_equal(codecs.load_image(path), want)
        assert png.is_plain(path.read_bytes()) == (mode != "P")


@pytest.mark.parametrize("damage", ["crc", "truncate"])
def test_damaged_png_raises_codec_error(tmp_path, damage):
    blob = bytearray(png.encode(_image(16, 16, 4, seed=2)))
    if damage == "crc":
        blob[-20] ^= 0xFF  # inside the IDAT payload
    else:
        blob = blob[:len(blob) // 2]
    path = tmp_path / "bad.png"
    path.write_bytes(bytes(blob))
    with pytest.raises(codecs.CodecError):
        codecs.load_image(path)


_NO_PILLOW = (
    "import sys; sys.modules['PIL'] = None;"
    "import jax; jax.config.update('jax_platforms', 'cpu');"
    "from paintfe_tpu.cli import main; sys.exit(main(sys.argv[1:]))"
)


def _cli_without_pillow(tmp_path, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", _NO_PILLOW, *args],
                          capture_output=True, text=True, env=env,
                          cwd=str(tmp_path), timeout=600)


def test_cli_png_batch_without_pillow(tmp_path):
    """With Pillow unimportable the CLI still converts a PNG batch; the
    outputs match the same script run in-process."""
    from paintfe_tpu.parallel.pipeline import compile_pipeline, trace_script

    script = "apply_brightness_contrast(10.0, 20.0);\napply_sepia(0.5);\n"
    (tmp_path / "s.rhai").write_text(script)
    imgs = [_image(24, 40, 4, seed=k) for k in range(2)]
    for k, img in enumerate(imgs):
        png.write(tmp_path / f"in{k}.png", img)
    proc = _cli_without_pillow(tmp_path, "-i", "in*.png", "-s", "s.rhai",
                               "--output-dir", "out", "-f", "png")
    assert proc.returncode == 0, proc.stderr
    chain = compile_pipeline(trace_script(script))
    for k, img in enumerate(imgs):
        got = png.read(tmp_path / "out" / f"in{k}.png")
        np.testing.assert_array_equal(got, np.asarray(chain(img)))


def test_cli_jpeg_without_pillow_names_it(tmp_path):
    png.write(tmp_path / "in.png", _image(8, 8, 4, seed=0))
    proc = _cli_without_pillow(tmp_path, "-i", "in.png", "-o", "out.jpg")
    assert proc.returncode == 1
    assert "Pillow" in proc.stderr
    assert not (tmp_path / "out.jpg").exists()
