"""Self-contained PNG codec: zlib + numpy, no imaging library.

Covers what the headless pipeline reads and writes on its main path:
non-interlaced truecolor PNGs (color type 2 RGB or 6 RGBA) at 8 or 16 bits
per sample, every filter type on decode.  The encoder writes RGBA with the
Up filter on every row (vectorised, and it compresses photographic and
synthetic frames about as well as adaptive filtering) at zlib level 6.
Palette, grayscale, interlaced, transparency-keyed (tRNS) and animated
(acTL) files are outside this codec: `is_plain` says which files it takes,
and io/codecs.py sends the rest to Pillow.

Pure numpy/zlib on purpose: the encode workers of the sharded batch runner
import this module and must never pull in JAX.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _chunks(blob: bytes):
    """Yield (tag, payload) for every chunk; CRCs are checked."""
    if blob[:8] != SIGNATURE:
        raise ValueError("not a PNG")
    pos = 8
    while pos + 12 <= len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        payload = blob[pos + 8:pos + 8 + length]
        crc = blob[pos + 8 + length:pos + 12 + length]
        if len(payload) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {tag!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(tag + payload) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {tag!r} fails its CRC")
        yield tag, payload
        if tag == b"IEND":
            return
        pos += 12 + length
    raise ValueError("truncated PNG: no IEND chunk")


def header(blob: bytes):
    """(width, height, bit depth, color type, interlace) from the IHDR."""
    if blob[:8] != SIGNATURE or blob[12:16] != b"IHDR" or len(blob) < 29:
        raise ValueError("not a PNG")
    w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(
        ">IIBBBBB", blob[16:29])
    return w, h, depth, ctype, interlace


def is_plain(blob: bytes) -> bool:
    """True for the files this codec decodes exactly as Pillow would."""
    try:
        _w, _h, depth, ctype, interlace = header(blob)
    except (ValueError, struct.error):
        return False
    if depth not in (8, 16) or ctype not in (2, 6) or interlace != 0:
        return False
    # ancillary chunks that change the decoded pixels or the frame count
    return b"tRNS" not in blob and b"acTL" not in blob


def _defilter_native(raw: bytes, h: int, stride: int, bpp: int):
    """C++ defilter (native/bytecodec.cpp), the fast path for the
    byte-serial Average and Paeth filters; None when the native library
    is unavailable."""
    import ctypes

    from paintfe_tpu import native

    lib = native.load()
    if lib is None or len(raw) < h * (stride + 1):
        return None
    out = bytearray(h * stride)
    rc = lib.png_defilter(
        (ctypes.c_uint8 * len(raw)).from_buffer_copy(raw),
        (ctypes.c_uint8 * len(out)).from_buffer(out),
        h, stride, bpp)
    return np.frombuffer(bytes(out), np.uint8) if rc == 0 else None


def _defilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """PNG spec §9 filter reconstruction -> u8 [h * stride]."""
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1))
    rows = rows.reshape(h, stride + 1)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {int(kinds.max())}")
    if (kinds > 2).any():
        fast = _defilter_native(raw, h, stride, bpp)
        if fast is not None:
            return fast
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        line = rows[y, 1:]
        f = kinds[y]
        if f == 0:
            cur = line
        elif f == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif f == 2:
            cur = line + prev
        else:
            cur = _defilter_row_serial(line, prev, bpp, f)
        out[y] = cur
        prev = out[y]
    return out.reshape(-1)


def _defilter_row_serial(line, prev, bpp: int, f: int) -> np.ndarray:
    """Average (3) and Paeth (4): each byte depends on the one decoded bpp
    bytes before it, so this runs byte by byte."""
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if f == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = up[i - bpp] if i >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            cur[i] = (cur[i] + pr) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def decode(blob: bytes) -> np.ndarray:
    """PNG bytes -> RGBA [H, W, 4]: u8 for 8-bit files, u16 for 16-bit.
    RGB files get an opaque alpha channel.  Raises ValueError for files
    outside `is_plain`."""
    w, h, depth, ctype, interlace = header(blob)
    if interlace != 0:
        # Adam7 lays rows out in 7 passes; the sequential defilter would
        # silently scramble pixels
        raise ValueError("interlaced (Adam7) PNGs are not supported")
    if depth not in (8, 16) or ctype not in (2, 6):
        raise ValueError(f"not RGB(A) 8/16-bit: depth={depth} ctype={ctype}")
    idat = b"".join(p for tag, p in _chunks(blob) if tag == b"IDAT")
    raw = zlib.decompress(idat)
    channels = 4 if ctype == 6 else 3
    bpp = channels * depth // 8
    stride = w * bpp
    if len(raw) < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    data = _defilter(raw, h, stride, bpp)
    if depth == 16:
        arr = data.view(">u2").astype(np.uint16).reshape(h, w, channels)
        opaque = np.uint16(65535)
    else:
        arr = data.reshape(h, w, channels)
        opaque = np.uint8(255)
    if channels == 3:
        arr = np.concatenate([arr, np.full((h, w, 1), opaque, arr.dtype)],
                             axis=-1)
    return arr


def encode(pixels: np.ndarray, level: int = 6) -> bytes:
    """RGBA u8 or u16 [H, W, 4] -> PNG bytes (Up filter on every row)."""
    pixels = np.asarray(pixels)
    h, w = pixels.shape[:2]
    depth = 16 if pixels.dtype == np.uint16 else 8
    if depth == 16:
        rows = np.ascontiguousarray(pixels, ">u2").view(np.uint8)
    else:
        rows = np.ascontiguousarray(pixels, np.uint8)
    rows = rows.reshape(h, -1)
    filtered = np.empty((h, rows.shape[1] + 1), np.uint8)
    filtered[:, 0] = 2
    filtered[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=filtered[1:, 1:])
    ihdr = struct.pack(">IIBBBBB", w, h, depth, 6, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(filtered.tobytes(), level))
            + chunk(b"IEND", b""))


def read(path) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode(fh.read())


def write(path, pixels: np.ndarray) -> None:
    data = encode(pixels)
    with open(path, "wb") as fh:
        fh.write(data)
