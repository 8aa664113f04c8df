"""Host-side C++ helpers, built with g++ at first use and loaded through
ctypes (isdf_tpu/utils/native.py).

``csrc/marching_tets.cpp`` (a copy of isdf_tpu's),
``csrc/image_codec.cpp`` (the PNG/JPEG byte work of utils/image_io.py) and
``csrc/raster.cpp`` (the fill of vis/raster.py's 3-D renders) and
``csrc/plot2d.cpp`` (the fill of vis/plot.py's 2-D figures) are
compiled with -O3 into the port's build directory (utils/nvcc.py::
build_dir, which .gitignore lists), keyed by the hash of the source.
Without a compiler marching tets falls back to its numpy implementation,
as isdf_tpu's does, and ``CALLS`` counts the calls the native library
served, so a caller can tell which ran; the codec and the rasterisers
have no fallback and raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from isdf_tpu_torch.utils.nvcc import CSRC, build_dir

_libs = {}
_lock = threading.Lock()
CALLS = {"marching_tets": 0}


def load(name: str) -> Optional[ctypes.CDLL]:
    """The library built from csrc/<name>.cpp, or None if it cannot be
    built or loaded."""
    with _lock:
        if name not in _libs:
            _libs[name] = _build(name)
        return _libs[name]


def _build(name: str) -> Optional[ctypes.CDLL]:
    src = os.path.join(CSRC, name + ".cpp")
    if not os.path.exists(src):
        return None
    with open(src, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"lib{name}_{tag}.so")
    if not os.path.exists(so):
        # build beside the target and rename: concurrent builds (test
        # workers) never load a half-written library
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", "-O3", "-march=native", "-shared",
                            "-fPIC", "-o", tmp, src],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except (OSError, subprocess.SubprocessError):
            if os.path.exists(tmp):
                os.remove(tmp)
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    if name == "marching_tets":
        lib.marching_tets.restype = ctypes.c_int
        lib.marching_tets.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_long)]
        lib.free_tris.argtypes = [ctypes.POINTER(ctypes.c_float)]
    if name == "image_codec":
        u8 = ctypes.POINTER(ctypes.c_uint8)
        i16 = ctypes.POINTER(ctypes.c_int16)
        lib.png_unfilter.restype = ctypes.c_int
        lib.png_unfilter.argtypes = [u8, ctypes.c_int, ctypes.c_long,
                                     ctypes.c_int, u8]
        lib.jpeg_decode_scan.restype = ctypes.c_long
        lib.jpeg_decode_scan.argtypes = [
            u8, ctypes.c_long, ctypes.c_long, ctypes.c_int, u8,
            ctypes.c_int, u8, ctypes.c_int, i16]
        lib.jpeg_idct_islow.restype = None
        lib.jpeg_idct_islow.argtypes = [
            i16, ctypes.c_long, ctypes.POINTER(ctypes.c_uint16), u8]
        lib.jpeg_encode_scan.restype = ctypes.c_long
        lib.jpeg_encode_scan.argtypes = [
            i16, ctypes.c_long, ctypes.c_int, u8, ctypes.c_int, u8, u8,
            ctypes.c_long]
    if name == "raster":
        f32 = ctypes.POINTER(ctypes.c_float)
        f64 = ctypes.POINTER(ctypes.c_double)
        i, n = ctypes.c_int, ctypes.c_long
        for fn, args in (
                ("raster_tris", [f32, i, i, f64,
                                 ctypes.POINTER(ctypes.c_int64),
                                 ctypes.POINTER(ctypes.c_int64), f32, n]),
                ("raster_discs", [f32, i, i, f64, f32, n,
                                  ctypes.c_double]),
                ("raster_polyline", [f32, i, i, f64, n, ctypes.c_double,
                                     f32, i]),
                ("raster_segments", [f32, i, i, f64, n, ctypes.c_double,
                                     f32])):
            getattr(lib, fn).restype = None
            getattr(lib, fn).argtypes = args
    if name == "plot2d":
        f32 = ctypes.POINTER(ctypes.c_float)
        f64 = ctypes.POINTER(ctypes.c_double)
        lp = ctypes.POINTER(ctypes.c_long)
        ip = ctypes.POINTER(ctypes.c_int)
        i, n, d = ctypes.c_int, ctypes.c_long, ctypes.c_double
        lib.plot_fill.restype = None
        lib.plot_fill.argtypes = [f32, i, i, f64, lp, n, f32, d, ip]
        lib.plot_stroke.restype = None
        lib.plot_stroke.argtypes = [f32, i, i, f64, lp, n, d, f32, d, i, i,
                                    ip]
    return lib


def marching_tets_native(sdf: np.ndarray, level: float = 0.0
                         ) -> Optional[np.ndarray]:
    """Triangle soup [T, 3, 3] in grid-index coordinates, or None if the
    native library is unavailable."""
    lib = load("marching_tets")
    if lib is None:
        return None
    sdf = np.ascontiguousarray(sdf, np.float32)
    out_p = ctypes.POINTER(ctypes.c_float)()
    out_n = ctypes.c_long(0)
    rc = lib.marching_tets(
        sdf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        sdf.shape[0], sdf.shape[1], sdf.shape[2], ctypes.c_float(level),
        ctypes.byref(out_p), ctypes.byref(out_n))
    if rc != 0:
        return None
    CALLS["marching_tets"] += 1
    n = out_n.value
    if n == 0:
        lib.free_tris(out_p)
        return np.zeros((0, 3, 3), np.float32)
    tris = np.ctypeslib.as_array(out_p, shape=(n, 3, 3)).copy()
    lib.free_tris(out_p)
    return tris
