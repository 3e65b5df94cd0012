"""High-bit-depth export: 16-bit PNG and 16/32-bit TIFF.

Behavioral contract: src/io.rs — `prepare_export_image` picks the export
depth from the visible layers (:1413-1453): two lossless fast paths (an
adjustment-only stack over a deep base :1456-1523, a single exact deep layer
:1541-1585), then composite-based promotion (any HDR/F16/F32 layer -> f32,
any U16 layer -> u16 = u8*257).  `encode_prepared_and_write` (:1588-1631)
routes Rgba16 to 16-bit PNG/TIFF and RgbaF32 to float TIFF; everything else
downconverts (u16 -> (v+128)/257, f32 -> Reinhard when any channel > 1).

The PNG and TIFF encoders here are self-contained (the environment's PIL
cannot write 16-bit RGBA), matching the reference's png/tiff crate output:
PNG bit depth 16 color type 6 big-endian, TIFF little-endian with
none/LZW/deflate strips.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Optional

import numpy as np

from paintfe_tpu.core.canvas import Canvas
from paintfe_tpu.core.deep import PixelFormat, f16_bits_to_f32
from paintfe_tpu.io import png

f32 = np.float32


@dataclasses.dataclass
class PreparedExport:
    kind: str  # 'rgba8' | 'rgba16' | 'rgbaf32'
    width: int
    height: int
    data: np.ndarray  # u8 / u16 / f32, [H, W, 4]


def _deep_to_f32(deep, width: int, height: int) -> Optional[np.ndarray]:
    """DeepRgbaBuffer -> [H, W, 4] f32 in 0..1 (io.rs:1524-1540)."""
    if deep.data.size != width * height * 4:
        return None
    fmt = PixelFormat(deep.format)
    if fmt == PixelFormat.RGBA_U8:
        out = deep.data.astype(f32) / f32(255.0)
    elif fmt == PixelFormat.RGBA_U16:
        out = deep.data.astype(f32) / f32(65535.0)
    elif fmt == PixelFormat.RGBA_F16:
        out = f16_bits_to_f32(deep.data)
    else:
        out = deep.data.astype(f32)
    return out.reshape(height, width, 4)


def _visible_layers(canvas: Canvas):
    return [
        l for i, l in enumerate(canvas.layers) if canvas.layer_effectively_visible(i)
    ]


def _layer_is_plain_base(layer) -> bool:
    from paintfe_tpu.core.blend import BlendMode

    return (
        layer.content == "raster"
        and layer.opacity >= 0.999
        and layer.blend_mode == BlendMode.NORMAL
        and layer.mask is None
    )


def _deep_matches_preview(layer, w: int, h: int) -> bool:
    if layer.deep_pixels.data.size != w * h * 4:
        return False  # stale element count (canvas resized since sync)
    preview = layer.deep_pixels.to_rgba8(w, h)
    return bool(np.array_equal(preview, np.asarray(layer.pixels, np.uint8)))


def _adjusted_deep_export(canvas: Canvas) -> Optional[PreparedExport]:
    """Deep base + adjustment-only stack applied in f32 (io.rs:1456-1523)."""
    vis = _visible_layers(canvas)
    if len(vis) < 2:
        return None
    base = vis[0]
    if not _layer_is_plain_base(base) or base.deep_pixels is None:
        return None
    if not all(l.content == "adjustment" for l in vis[1:]):
        return None
    pixels = _deep_to_f32(base.deep_pixels, canvas.width, canvas.height)
    if pixels is None or not _deep_matches_preview(base, canvas.width, canvas.height):
        return None
    for layer in vis[1:]:
        if layer.adjustment is None:
            return None
        pixels = layer.adjustment.apply_to_f32_with_opacity(pixels, layer.opacity)
    hdr = getattr(base, "hdr_metadata", None)
    fmt = (PixelFormat(base.pixel_format) if base.pixel_format is not None
           else PixelFormat.RGBA_U8)
    if (hdr is not None and hdr.enabled) or fmt in (
        PixelFormat.RGBA_F16,
        PixelFormat.RGBA_F32,
    ):
        return PreparedExport("rgbaf32", canvas.width, canvas.height, pixels)
    if fmt == PixelFormat.RGBA_U16:
        u16 = np.floor(np.clip(pixels, 0.0, 1.0) * f32(65535.0) + f32(0.5)).astype(
            np.uint16
        )
        return PreparedExport("rgba16", canvas.width, canvas.height, u16)
    return None


def _exact_single_layer_deep_export(canvas: Canvas) -> Optional[PreparedExport]:
    """One visible deep layer, preview in sync: export losslessly
    (io.rs:1541-1585)."""
    vis = _visible_layers(canvas)
    if len(vis) != 1:
        return None
    layer = vis[0]
    if not _layer_is_plain_base(layer) or layer.deep_pixels is None:
        return None
    if not _deep_matches_preview(layer, canvas.width, canvas.height):
        return None
    fmt = PixelFormat(layer.deep_pixels.format)
    shape = (canvas.height, canvas.width, 4)
    if fmt == PixelFormat.RGBA_U8:
        return PreparedExport(
            "rgba8", canvas.width, canvas.height,
            layer.deep_pixels.data.astype(np.uint8).reshape(shape),
        )
    if fmt == PixelFormat.RGBA_U16:
        return PreparedExport(
            "rgba16", canvas.width, canvas.height,
            layer.deep_pixels.data.astype(np.uint16).reshape(shape),
        )
    if fmt == PixelFormat.RGBA_F16:
        return PreparedExport(
            "rgbaf32", canvas.width, canvas.height,
            f16_bits_to_f32(layer.deep_pixels.data).reshape(shape),
        )
    return PreparedExport(
        "rgbaf32", canvas.width, canvas.height,
        layer.deep_pixels.data.astype(f32).reshape(shape),
    )


def needs_deep_export(canvas: Canvas) -> bool:
    """True when any visible layer carries depth the u8 path would lose."""
    for i, l in enumerate(canvas.layers):
        if not canvas.layer_effectively_visible(i):
            continue
        if l.deep_pixels is not None:
            return True
        if l.pixel_format is not None and PixelFormat(l.pixel_format) != PixelFormat.RGBA_U8:
            return True
        hdr = getattr(l, "hdr_metadata", None)
        if hdr is not None and hdr.enabled:
            return True
    return False


def prepare_export_image(canvas: Canvas) -> PreparedExport:
    """Pick the widest export depth the document warrants (io.rs:1413-1453)."""
    prep = _adjusted_deep_export(canvas)
    if prep is not None:
        return prep
    prep = _exact_single_layer_deep_export(canvas)
    if prep is not None:
        return prep

    composite = np.asarray(canvas.composite(), np.uint8)
    vis = _visible_layers(canvas)

    def _fmt(l):
        return PixelFormat(l.pixel_format) if l.pixel_format is not None else PixelFormat.RGBA_U8

    if any(
        (getattr(l, "hdr_metadata", None) is not None and l.hdr_metadata.enabled)
        or _fmt(l) in (PixelFormat.RGBA_F16, PixelFormat.RGBA_F32)
        for l in vis
    ):
        return PreparedExport(
            "rgbaf32", canvas.width, canvas.height,
            composite.astype(f32) / f32(255.0),
        )
    if any(_fmt(l) == PixelFormat.RGBA_U16 for l in vis):
        return PreparedExport(
            "rgba16", canvas.width, canvas.height,
            composite.astype(np.uint16) * 257,
        )
    return PreparedExport("rgba8", canvas.width, canvas.height, composite)


def prepared_to_rgba8(prep: PreparedExport) -> np.ndarray:
    """Downconvert for 8-bit formats (io.rs:1371-1410): u16 rounds via
    (v+128)/257; f32 Reinhard-tone-maps any pixel with a channel > 1."""
    if prep.kind == "rgba8":
        return np.asarray(prep.data, np.uint8)
    if prep.kind == "rgba16":
        return ((prep.data.astype(np.uint32) + 128) // 257).astype(np.uint8)
    from paintfe_tpu.core.deep import reinhard_tone_map

    px = prep.data.astype(f32)
    over = (px[..., 0:3] > 1.0).any(axis=-1)
    # plain path: round(clamp(v)*255)
    plain = np.floor(np.clip(px, 0.0, 1.0) * f32(255.0) + f32(0.5)).astype(np.uint8)
    # Reinhard x/(1+x) at exposure 1.0 for HDR pixels — the shared parity
    # mirror of experimental.rs:59-70 (an inline copy here once drifted
    # from it; keep ONE implementation)
    toned = reinhard_tone_map(px, 1.0)
    return np.where(over[..., None], toned, plain)


# ---------------------------------------------------------------------------
# 16-bit PNG writer (bit depth 16, color type 6 RGBA, big-endian samples)
# ---------------------------------------------------------------------------


def write_png16(path, width: int, height: int, pixels: np.ndarray):
    """io.rs:1651-1668 — RGBA 16-bit PNG."""
    png.write(path, np.asarray(pixels, np.uint16).reshape(height, width, 4))


def read_png16(path) -> np.ndarray:
    """Decode a 16-bit RGB(A) PNG -> u16 [H, W, 4] (RGB gets opaque alpha,
    io.rs:606-617)."""
    arr = png.read(path)
    if arr.dtype != np.uint16:
        raise ValueError("not a 16-bit PNG")
    return arr


# ---------------------------------------------------------------------------
# TIFF writer (little-endian, single strip, none/LZW/deflate)
# ---------------------------------------------------------------------------


def _lzw_encode_native(data: bytes):
    """C++ LZW fast path (native/bytecodec.cpp); None -> Python oracle."""
    import ctypes

    from paintfe_tpu import native

    lib = native.load()
    if lib is None:
        return None
    cap = 2 * len(data) + 64
    out = bytearray(cap)
    n = lib.tiff_lzw_encode(
        (ctypes.c_uint8 * len(data)).from_buffer_copy(data), len(data),
        (ctypes.c_uint8 * cap).from_buffer(out), cap)
    return bytes(out[:n]) if n >= 0 else None


def _lzw_encode(data: bytes) -> bytes:
    """TIFF-flavor LZW: MSB-first bit packing, Clear=256, EOI=257, 9->12 bit
    codes with the TIFF 'early change' (width bumps one code early)."""
    fast = _lzw_encode_native(data)
    if fast is not None:
        return fast
    CLEAR, EOI = 256, 257
    out = bytearray()
    bitbuf = 0
    bitcnt = 0
    width = 9

    def emit(code):
        nonlocal bitbuf, bitcnt
        bitbuf = (bitbuf << width) | code
        bitcnt += width
        while bitcnt >= 8:
            bitcnt -= 8
            out.append((bitbuf >> bitcnt) & 0xFF)

    table = {bytes([i]): i for i in range(256)}
    next_code = 258
    emit(CLEAR)
    w = b""
    for byte in data:
        c = bytes([byte])
        wc = w + c
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = next_code
        next_code += 1
        # TIFF early change: the decoder grows its code width when its next
        # free slot hits 2^n - 1, which on the encoder side (one entry ahead)
        # lands exactly when next_code reaches 2^n.  Verified against libtiff.
        if next_code == (1 << width):
            if width < 12:
                width += 1
            else:
                emit(CLEAR)
                table = {bytes([i]): i for i in range(256)}
                next_code = 258
                width = 9
        w = c
    if w:
        emit(table[w])
    emit(EOI)
    if bitcnt:
        out.append((bitbuf << (8 - bitcnt)) & 0xFF)
    return bytes(out)


def _write_tiff(path, width: int, height: int, payload: bytes, *,
                bits: int, sample_format: int, compression: str):
    comp_tag = {"none": 1, "lzw": 5, "deflate": 8}[compression]
    if compression == "lzw":
        strip = _lzw_encode(payload)
    elif compression == "deflate":
        strip = zlib.compress(payload, 6)
    else:
        strip = payload

    entries = []  # (tag, type, count, value_or_offset_payload)
    extra = bytearray()
    header_size = 8
    n_tags = 12
    ifd_size = 2 + n_tags * 12 + 4
    data_start = header_size + ifd_size

    def short_arr(vals):
        return struct.pack("<%dH" % len(vals), *vals)

    def add(tag, typ, count, value_bytes, inline_ok):
        nonlocal extra
        if inline_ok and len(value_bytes) <= 4:
            entries.append((tag, typ, count, value_bytes.ljust(4, b"\0")))
        else:
            off = data_start + len(extra)
            entries.append((tag, typ, count, struct.pack("<I", off)))
            extra += value_bytes
            if len(extra) % 2:
                extra += b"\0"

    add(256, 4, 1, struct.pack("<I", width), True)          # ImageWidth
    add(257, 4, 1, struct.pack("<I", height), True)         # ImageLength
    add(258, 3, 4, short_arr([bits] * 4), False)            # BitsPerSample
    add(259, 3, 1, struct.pack("<H", comp_tag), True)       # Compression
    add(262, 3, 1, struct.pack("<H", 2), True)              # Photometric RGB
    add(277, 3, 1, struct.pack("<H", 4), True)              # SamplesPerPixel
    add(278, 4, 1, struct.pack("<I", height), True)         # RowsPerStrip
    add(338, 3, 1, struct.pack("<H", 2), True)              # ExtraSamples: alpha
    add(339, 3, 4, short_arr([sample_format] * 4), False)   # SampleFormat
    add(284, 3, 1, struct.pack("<H", 1), True)              # PlanarConfig chunky
    strip_off = data_start + len(extra)
    add(273, 4, 1, struct.pack("<I", strip_off), True)      # StripOffsets
    add(279, 4, 1, struct.pack("<I", len(strip)), True)     # StripByteCounts
    assert len(entries) == n_tags

    with open(path, "wb") as fh:
        fh.write(b"II*\0" + struct.pack("<I", 8))
        fh.write(struct.pack("<H", n_tags))
        for tag, typ, count, val in sorted(entries):
            fh.write(struct.pack("<HHI", tag, typ, count) + val)
        fh.write(struct.pack("<I", 0))  # next IFD
        fh.write(bytes(extra))
        fh.write(strip)


def write_tiff16(path, width: int, height: int, pixels: np.ndarray,
                 compression: str = "none"):
    """io.rs:1670-1706 — RGBA 16-bit TIFF with the CLI's compression modes."""
    payload = np.ascontiguousarray(pixels, dtype="<u2").tobytes()
    _write_tiff(path, width, height, payload, bits=16, sample_format=1,
                compression=compression)


def write_tiff_f32(path, width: int, height: int, pixels: np.ndarray):
    """io.rs:1708-1720 — RGBA float32 TIFF (uncompressed)."""
    payload = np.ascontiguousarray(pixels, dtype="<f4").tobytes()
    _write_tiff(path, width, height, payload, bits=32, sample_format=3,
                compression="none")


def _lzw_decode(data: bytes, max_bytes: Optional[int] = None) -> bytes:
    """Inverse of _lzw_encode (TIFF early-change variant).

    `max_bytes` reproduces libtiff's contract: the decoder stops once the
    expected strip size is produced and never reads further.  This is
    load-bearing at the early-change boundary — when the FINAL data code
    lands the table on exactly 2^width - 1 entries, the early-change bump
    fires but the encoder's EOI was written at the old width (our encoder
    and libtiff's agree; fuzz-verified: PIL decodes such strips), so
    reading on would misparse EOI as a data code and append garbage.
    Real consumers always know the strip size; pass it."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    width = 9
    bitbuf = 0
    bitcnt = 0
    prev = None
    i = 0
    n = len(data)
    while max_bytes is None or len(out) < max_bytes:
        while bitcnt < width and i < n:
            bitbuf = (bitbuf << 8) | data[i]
            bitcnt += 8
            i += 1
        if bitcnt < width:
            break
        bitcnt -= width
        code = (bitbuf >> bitcnt) & ((1 << width) - 1)
        if code == EOI:
            break
        if code == CLEAR:
            table = [bytes([j]) for j in range(256)] + [b"", b""]
            width = 9
            prev = None
            continue
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # decoder grows one slot early (TIFF early change)
        if len(table) == (1 << width) - 1 and width < 12:
            width += 1
    if max_bytes is not None:
        return bytes(out[:max_bytes])
    return bytes(out)


def read_tiff_deep(path) -> np.ndarray:
    """Read an RGBA TIFF written by write_tiff16/write_tiff_f32 back as
    u16 or f32 [H, W, 4] (PIL flattens 16-bit RGBA to 8 bits, so deep TIFF
    import needs its own reader)."""
    # one TIFF IFD parser for the whole package: raw.py's _parse_ifd
    # (full type table incl. rationals/doubles; the private subset this
    # function used to carry drifted from it).  Imported lazily — raw.py
    # imports _lzw_decode from this module.
    from paintfe_tpu.io.raw import _parse_ifd

    with open(path, "rb") as fh:
        blob = fh.read()
    if blob[:4] == b"II*\0":
        end = "<"
    elif blob[:4] == b"MM\0*":
        end = ">"
    else:
        raise ValueError("not a TIFF")
    (ifd_off,) = struct.unpack(end + "I", blob[4:8])
    tags, _next = _parse_ifd(blob, end, ifd_off)
    w = tags[256][0]
    h = tags[257][0]
    bits_all = tags[258]
    bits = bits_all[0]
    if any(b != bits for b in bits_all):
        raise ValueError("mixed per-channel TIFF bit depths are not supported")
    comp = tags.get(259, (1,))[0]
    sample_fmt = tags.get(339, (1,))[0]
    spp = tags.get(277, (4,))[0]
    if tags.get(284, (1,))[0] != 1:
        # PlanarConfiguration=2 stores channel-planar strips; reading it
        # as chunky would silently scramble channels
        raise ValueError("planar TIFF layout is not supported")
    offs = tags[273]
    counts = tags[279]
    payload = b"".join(blob[o:o + c] for o, c in zip(offs, counts))
    expected = h * w * spp * (4 if (sample_fmt == 3 or bits == 32)
                              else 2 if bits == 16 else 1)
    if comp == 5:
        # expected-size contract like libtiff's strip decode: at the LZW
        # early-change boundary the stream legally ends with an EOI at the
        # pre-bump width, which an unbounded decode misparses as data
        payload = _lzw_decode(payload, expected)
    elif comp == 8:
        payload = zlib.decompress(payload)
    elif comp != 1:
        raise ValueError(f"unsupported TIFF compression {comp}")
    if sample_fmt == 3:
        arr = np.frombuffer(payload, end + "f4", count=h * w * spp).astype(f32)
    elif bits == 16:
        arr = np.frombuffer(payload, end + "u2",
                            count=h * w * spp).astype(np.uint16)
    else:
        arr = np.frombuffer(payload, end + "u1",
                            count=h * w * spp).astype(np.uint8)
    arr = arr.reshape(h, w, spp)
    if spp == 3:
        opaque = (np.float32(1.0) if sample_fmt == 3 else
                  np.uint16(65535) if bits == 16 else np.uint8(255))
        arr = np.concatenate([arr, np.full((h, w, 1), opaque, arr.dtype)], axis=-1)
    return arr


def load_deep_image(path):
    """If `path` is a 16-bit PNG or a 16/32-bit TIFF, return
    (preview_rgba8, PixelFormat, DeepRgbaBuffer); else None (load the file
    through the normal codec).  Mirrors dynamic_image_to_rgba_and_deep
    (io.rs:588-640): deep payload kept, u8 preview = round(v*255/65535)."""
    from paintfe_tpu.core.deep import DeepRgbaBuffer

    p = str(path).lower()
    try:
        if p.endswith(".png"):
            with open(path, "rb") as fh:
                head = fh.read(33)
            if len(head) < 33 or head[24] != 16:  # IHDR bit depth byte
                return None
            deep16 = read_png16(path)
        elif p.endswith((".tif", ".tiff")):
            arr = read_tiff_deep(path)
            if arr.dtype == np.uint8:
                return None
            if arr.dtype == np.float32:
                buf = DeepRgbaBuffer(PixelFormat.RGBA_F32, arr.reshape(-1).astype(f32))
                return buf.to_rgba8(arr.shape[1], arr.shape[0]), PixelFormat.RGBA_F32, buf
            deep16 = arr
        else:
            return None
    except Exception:
        return None
    h, w = deep16.shape[:2]
    buf = DeepRgbaBuffer(PixelFormat.RGBA_U16, deep16.reshape(-1).astype(np.uint16))
    return buf.to_rgba8(w, h), PixelFormat.RGBA_U16, buf


def encode_prepared_and_write(prep: PreparedExport, path, fmt: str,
                              quality: int = 90, tiff_compression: str = "none",
                              webp_lossless: bool = True):
    """Route deep exports to the 16/32-bit writers (io.rs:1588-1631)."""
    from paintfe_tpu.io import codecs

    fmt = fmt.lower()
    if prep.kind == "rgba16" and fmt == "png":
        return write_png16(path, prep.width, prep.height, prep.data)
    if prep.kind == "rgba16" and fmt == "tiff":
        return write_tiff16(path, prep.width, prep.height, prep.data,
                            tiff_compression)
    if prep.kind == "rgbaf32" and fmt == "tiff":
        return write_tiff_f32(path, prep.width, prep.height, prep.data)
    return codecs.save_image(
        prepared_to_rgba8(prep), path, fmt, quality=quality,
        webp_lossless=webp_lossless, tiff_compression=tiff_compression,
    )
