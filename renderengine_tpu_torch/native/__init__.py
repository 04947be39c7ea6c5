"""ctypes bindings for the native host-runtime helpers.

Builds ``librenderengine_native.so`` into the package's ``build/``
directory on first use (make + g++). These are host asset parsers (PNG
unfiltering, OBJ tokenizing, JPEG decoding), not a device path: PNG and
OBJ keep the JAX package's pure-Python fallbacks, so the package works
without a toolchain, just slower at asset load; a JPEG without the
library is refused, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_LIB_PATH = _DIR.parent / "build" / "librenderengine_native.so"
_lib = None
_tried = False


def load_library():
    """Returns the ctypes library or None (fallbacks engage)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists():
        try:
            subprocess.run(["make", "-C", str(_DIR), f"OUT={_LIB_PATH}"],
                           check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.unfilter_png.restype = ctypes.c_int
    lib.obj_parse.restype = ctypes.c_void_p
    lib.obj_parse.argtypes = [ctypes.c_char_p]
    lib.obj_n_tris.argtypes = [ctypes.c_void_p]
    lib.obj_n_tris.restype = ctypes.c_int32
    lib.obj_n_mats.argtypes = [ctypes.c_void_p]
    lib.obj_n_mats.restype = ctypes.c_int32
    lib.obj_names_len.argtypes = [ctypes.c_void_p]
    lib.obj_names_len.restype = ctypes.c_int64
    lib.obj_mtllibs_len.argtypes = [ctypes.c_void_p]
    lib.obj_mtllibs_len.restype = ctypes.c_int64
    lib.obj_fetch.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
    lib.obj_free.argtypes = [ctypes.c_void_p]
    lib.jpeg_parse.restype = ctypes.c_void_p
    lib.jpeg_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.jpeg_width.argtypes = [ctypes.c_void_p]
    lib.jpeg_width.restype = ctypes.c_int32
    lib.jpeg_height.argtypes = [ctypes.c_void_p]
    lib.jpeg_height.restype = ctypes.c_int32
    lib.jpeg_fetch_rgba.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.jpeg_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def unfilter_png(raw: bytes, h: int, stride: int, bpp: int):
    """Native PNG unfilter; returns uint8 [h, stride] or None if the
    library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    out = np.empty((h, stride), np.uint8)
    rc = lib.unfilter_png(raw, len(raw), h, stride, bpp,
                          out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"PNG unfilter failed ({rc})")
    return out


def decode_jpeg(data: bytes):
    """Native JPEG decode (baseline SOF0/1 + progressive SOF2); returns
    uint8 [h, w, 4] RGBA or None if the library is unavailable or the
    stream is malformed/unsupported (e.g. arithmetic coding, 12-bit)."""
    lib = load_library()
    if lib is None:
        return None
    h = lib.jpeg_parse(data, len(data))
    if not h:
        return None
    try:
        height, width = lib.jpeg_height(h), lib.jpeg_width(h)
        out = np.empty((height, width, 4), np.uint8)
        lib.jpeg_fetch_rgba(h, out.ctypes.data_as(ctypes.c_void_p))
        return out
    finally:
        lib.jpeg_free(h)


def parse_obj(path: str):
    """Native OBJ tokenize; returns dict of flat per-corner arrays or None.

    keys: pos [T,3,3], nrm [T,3,3], uv [T,3,2], mat [T] (usemtl order
    index, -1 before the first usemtl), mat_names list[str], mtllibs
    list[str].
    """
    lib = load_library()
    if lib is None:
        return None
    h = lib.obj_parse(str(path).encode())
    if not h:
        return None
    try:
        t = lib.obj_n_tris(h)
        pos = np.empty((t, 3, 3), np.float32)
        nrm = np.empty((t, 3, 3), np.float32)
        uv = np.empty((t, 3, 2), np.float32)
        mat = np.empty(t, np.int32)
        names_len = lib.obj_names_len(h)
        libs_len = lib.obj_mtllibs_len(h)
        names_buf = ctypes.create_string_buffer(max(1, names_len))
        libs_buf = ctypes.create_string_buffer(max(1, libs_len))
        lib.obj_fetch(h, pos.ctypes.data_as(ctypes.c_void_p),
                      nrm.ctypes.data_as(ctypes.c_void_p),
                      uv.ctypes.data_as(ctypes.c_void_p),
                      mat.ctypes.data_as(ctypes.c_void_p),
                      names_buf, libs_buf)
        names = names_buf.raw[:names_len].split(b"\x00")[:-1] if names_len else []
        libs = libs_buf.raw[:libs_len].split(b"\x00")[:-1] if libs_len else []
        return {
            "pos": pos, "nrm": nrm, "uv": uv, "mat": mat,
            "mat_names": [n.decode("utf-8", "replace") for n in names],
            "mtllibs": [n.decode("utf-8", "replace") for n in libs],
        }
    finally:
        lib.obj_free(h)
