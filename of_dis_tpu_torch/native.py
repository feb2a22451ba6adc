"""ctypes bindings to the port's C++ host codecs (csrc/ofdis_native.cpp),
the counterpart of of_dis_tpu/native.py with its API: available,
write_flo, read_flo, write_pfm, read_pfm, read_pnm, gray_from_rgb_u8.

The library builds with the host compiler at first use
(ops/build.py::build_host, `$CXX` or g++) and loads once.  io.py uses it
where of_dis_tpu/io.py uses the JAX package's codec (write_flo, read_flo,
write_pfm, PNM input); its NumPy code stays as the plain version, which
writes the same bytes.  OF_DIS_NATIVE=0 turns the library off: then
available() is false, the writers return False and the readers None, and
io.py runs NumPy.  Otherwise a build that fails raises with the compiler's
output; nothing falls back to NumPy.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from .ops import build

_i32 = ctypes.c_int32
_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(_i32)
_SIGNATURES = {
    "ofdis_write_flo": ([ctypes.c_char_p, _f32p, _i32, _i32, _i32], ctypes.c_int),
    "ofdis_flo_dims": ([ctypes.c_char_p, _i32p, _i32p], ctypes.c_int),
    "ofdis_read_flo": ([ctypes.c_char_p, _f32p, _i32, _i32, _i32], ctypes.c_int),
    "ofdis_write_pfm": ([ctypes.c_char_p, _f32p, _i32, _i32, _i32], ctypes.c_int),
    "ofdis_pfm_dims": ([ctypes.c_char_p, _i32p, _i32p, ctypes.POINTER(ctypes.c_float)],
                       ctypes.c_int),
    "ofdis_read_pfm": ([ctypes.c_char_p, _f32p, _i32, _i32, _i32], ctypes.c_int),
    "ofdis_gray_from_rgb_u8": ([_u8p, _f32p, ctypes.c_int64], None),
    "ofdis_pnm_dims": ([ctypes.c_char_p, _i32p, _i32p, _i32p], ctypes.c_int),
    "ofdis_read_pnm": ([ctypes.c_char_p, _u8p, _i32, _i32, _i32], ctypes.c_int),
}


_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    """The library (built and loaded at the first call, then kept: a build
    check hashes the source and looks for the library on disk, which is
    too slow for every frame), or None under OF_DIS_NATIVE=0."""
    global _lib
    if os.environ.get("OF_DIS_NATIVE", "1") == "0":
        return None
    if _lib is None:
        lib = build.build_host("ofdis_native")
        for fn, (args, res) in _SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


def _fail(path, mode: str, what: str):
    """Raise for a call that returned non-zero: the OS's own error (missing
    file, no permission) where the file cannot be opened, else ValueError."""
    with open(path, mode):
        pass
    raise ValueError(f"{what} {path}")


def write_flo(path, flow: np.ndarray) -> bool:
    """(H, W, nc) float32 as .flo; False when the library is off."""
    lib = _load()
    if lib is None:
        return False
    flow = np.ascontiguousarray(flow, dtype=np.float32)
    h, w, nc = flow.shape
    if lib.ofdis_write_flo(os.fsencode(path), _fp(flow), w, h, nc) != 0:
        _fail(path, "wb", "cannot write")
    return True


def read_flo(path) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    w, h = _i32(), _i32()
    if lib.ofdis_flo_dims(os.fsencode(path), ctypes.byref(w), ctypes.byref(h)) != 0:
        _fail(path, "rb", "bad .flo file")
    out = np.empty((h.value, w.value, 2), np.float32)
    if lib.ofdis_read_flo(os.fsencode(path), _fp(out), w, h, 2) != 0:
        _fail(path, "rb", "truncated .flo file")
    return out


def write_pfm(path, disp: np.ndarray, negate: bool = True) -> bool:
    """(H, W) float32 as grayscale .pfm; False when the library is off."""
    lib = _load()
    if lib is None:
        return False
    disp = np.ascontiguousarray(disp, dtype=np.float32)
    h, w = disp.shape
    if lib.ofdis_write_pfm(os.fsencode(path), _fp(disp), w, h, int(negate)) != 0:
        _fail(path, "wb", "cannot write")
    return True


def read_pfm(path, negate: bool = False) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    w, h, scale = _i32(), _i32(), ctypes.c_float()
    if lib.ofdis_pfm_dims(os.fsencode(path), ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(scale)) != 0:
        _fail(path, "rb", "bad .pfm file")
    out = np.empty((h.value, w.value), np.float32)
    if lib.ofdis_read_pfm(os.fsencode(path), _fp(out), w, h, int(negate)) != 0:
        _fail(path, "rb", "truncated .pfm file")
    return out


def gray_from_rgb_u8(rgb: np.ndarray) -> Optional[np.ndarray]:
    """OpenCV's fixed-point gray of an (H, W, 3) uint8 image, as float32."""
    lib = _load()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape}")
    out = np.empty(rgb.shape[:2], np.float32)
    lib.ofdis_gray_from_rgb_u8(rgb.ctypes.data_as(_u8p), _fp(out), out.size)
    return out


def read_pnm(path) -> Optional[np.ndarray]:
    """A binary P5 / P6 file (maxval <= 255) as (H, W, C) uint8."""
    lib = _load()
    if lib is None:
        return None
    w, h, c = _i32(), _i32(), _i32()
    if lib.ofdis_pnm_dims(os.fsencode(path), ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(c)) != 0:
        _fail(path, "rb", "bad PNM file")
    out = np.empty((h.value, w.value, c.value), np.uint8)
    if lib.ofdis_read_pnm(os.fsencode(path), out.ctypes.data_as(_u8p), w, h, c) != 0:
        _fail(path, "rb", "truncated PNM file")
    return out
