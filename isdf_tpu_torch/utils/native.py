"""Host-side C++ helpers, built with g++ at first use and loaded through
ctypes (isdf_tpu/utils/native.py).

``csrc/marching_tets.cpp`` (a copy of isdf_tpu's) is compiled with -O3
into the port's build directory (utils/nvcc.py::build_dir, which .gitignore
lists), keyed by the hash of the source. Without a compiler the callers
fall back to the numpy implementations; ``CALLS`` counts the calls that
the native library served, so a caller can tell which ran.
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
