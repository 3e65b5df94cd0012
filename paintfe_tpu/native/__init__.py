"""Native (C++) runtime components, built on demand with g++ + ctypes.

The compute path is JAX/XLA; these are the host-runtime pieces that
are data-dependent and iterative (the parts the reference also keeps in
native code): PatchMatch inpainting, instant-brush fill.

Built with -ffp-contract=off so f32 results match the reference's strict
(non-FMA) float semantics bit-for-bit.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import threading

_DIR = pathlib.Path(__file__).resolve().parent
_LIB_PATH = _DIR / "libpaintfe_native.so"
_SOURCES = [_DIR / "inpaint.cpp", _DIR / "ljpeg.cpp", _DIR / "jpegdct.cpp",
            _DIR / "bytecodec.cpp", _DIR / "neuquant.cpp"]
_lock = threading.Lock()
_lib = None
_build_error = None


def _build():
    # compile to a per-process temp name, then os.replace (atomic on POSIX):
    # concurrent processes rebuilding in place could dlopen a partially
    # written .so — and the load failure would be cached for the process
    import os as _os

    tmp = _LIB_PATH.with_suffix(f".so.tmp{_os.getpid()}")
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-ffp-contract=off", "-std=c++17",
        "-o", str(tmp),
    ] + [str(s) for s in _SOURCES]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        _os.replace(tmp, _LIB_PATH)
    finally:
        if tmp.exists():
            tmp.unlink()


def load():
    """Return the loaded native library, building it if needed.
    Returns None (and remembers the error) when no toolchain is available."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        try:
            newest_src = max(s.stat().st_mtime for s in _SOURCES)
            if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < newest_src:
                _build()
            lib = ctypes.CDLL(str(_LIB_PATH))
        except Exception as e:  # no g++ / load failure -> python fallback
            _build_error = e
            return None

        lib.patchmatch_fill.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.patchmatch_fill.restype = None
        lib.inpaint_instant_brush.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float,
        ]
        lib.inpaint_instant_brush.restype = None
        lib.ljpeg_info.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.ljpeg_info.restype = ctypes.c_int
        lib.ljpeg_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_uint64,
        ]
        lib.ljpeg_decode.restype = ctypes.c_int
        lib.jpegdct_info.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.jpegdct_info.restype = ctypes.c_int
        lib.jpegdct_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
        ]
        lib.jpegdct_decode.restype = ctypes.c_int
        lib.png_defilter.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.png_defilter.restype = ctypes.c_int
        lib.tiff_lzw_encode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
        ]
        lib.tiff_lzw_encode.restype = ctypes.c_int64
        _lib = lib
        return _lib


def build_error():
    return _build_error
