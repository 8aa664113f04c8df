"""Build the port's CUDA sources at first use and load them through ctypes.

Each source ``csrc/<name>.cu`` is compiled by nvcc for sm_90a into a shared
library with a plain C interface, ``lib<name>_<hash>.so`` in a build
directory that .gitignore lists. The hash covers every source and header
of csrc/ (a source may include another, as the ``*_f32.cu`` sources
include their bf16 twins), so an edited kernel is rebuilt and a built one
is reused. ``load_all`` starts one nvcc per missing library at once and
waits for all of them; a failed build raises with nvcc's output.

Every entry point of a library takes (ptrs, knobs, ints, stream): three
arrays and PyTorch's current stream. ``call`` declares those argument types,
launches, and raises if the C function returns a CUDA error code.

Launch counts: each kernel's wrapper adds one to its count by
``count_launch`` where it launches. Inside a CUDA graph capture
(``capture_tally``) nothing launches, so the launch is noted in the
capture's tally instead, and the graph's owner adds the tally once per
replay (``add_tally``).
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from isdf_tpu_torch.utils.profiling import span

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")

# nvcc's output (its -Xptxas -v report) and build seconds, per (source
# dir, library) built by this process
BUILD_INFO = {}
_LIBS = {}
_LOCK = threading.Lock()
_SRC_DIR = [CSRC]
# the tally of the capture in progress in this process, else None
_TALLY = [None]


def build_dir() -> str:
    return os.environ.get("ISDF_TORCH_BUILD_DIR", os.path.join(PKG, "_build"))


@contextlib.contextmanager
def sources_from(src_dir: str):
    """Build and load libraries from another copy of csrc/ inside the
    block (chip_smoke.py's planted-fault checks)."""
    old = _SRC_DIR[0]
    _SRC_DIR[0] = src_dir
    try:
        yield
    finally:
        _SRC_DIR[0] = old


def _target(src_dir: str, name: str) -> str:
    h = hashlib.sha1(name.encode())
    for path in sorted(glob.glob(os.path.join(src_dir, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(build_dir(), f"lib{name}_{h.hexdigest()[:12]}.so")


def _build(pairs):
    """Compile the (src_dir, name) libraries not built yet, one nvcc each,
    all at once; traced, the span ``nvcc.build`` with the count of
    libraries compiled and their sources' names (``built``, comma-separated:
    "train_mlp_384" is K1's 384-lane build)."""
    with span("nvcc.build") as sp:
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        procs = {}
        for src_dir, name in pairs:
            out = _target(src_dir, name)
            if os.path.exists(out) or out in procs:
                continue
            os.makedirs(build_dir(), exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            src = os.path.join(src_dir, f"{name}.cu")
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-I", src_dir, "-o", tmp, src]
            procs[out] = (name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, time.perf_counter())
        sp.count(libs=len(procs),
                 built=",".join(name for name, *_ in procs.values()))
        failed = []
        for out, (name, proc, tmp, t0) in procs.items():
            log, _ = proc.communicate()
            BUILD_INFO[(os.path.dirname(proc.args[-1]), name)] = {
                "nvcc_log": log, "build_s": time.perf_counter() - t0}
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {name}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))


def build(pairs):
    """Compile the (src_dir, name) libraries not built yet, all at once."""
    with _LOCK:
        _build(pairs)


def load_all(names):
    """Build (in parallel) and load the named libraries; returns them."""
    with _LOCK:
        src_dir = _SRC_DIR[0]
        missing = [(src_dir, n) for n in names if (src_dir, n) not in _LIBS]
        if missing:  # the wrappers call this on every launch
            _build(missing)
            for key in missing:
                _LIBS[key] = ctypes.CDLL(_target(*key))
        return [_LIBS[(src_dir, n)] for n in names]


def load(name: str):
    return load_all([name])[0]


def call(lib, fn_name: str, ptrs, knobs, ints, device) -> None:
    """Launch ``fn_name`` on the current stream of ``device``. ``ptrs``:
    tensors or None (a null pointer), in the order the C side declares
    them; ``knobs``: floats; ``ints``: ints. The caller keeps the tensors
    alive until the kernels are done (the caching allocator does so for
    tensors it still references)."""
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    p_arr = (ctypes.c_longlong * len(ptrs))(
        *[0 if t is None else t.data_ptr() for t in ptrs])
    k_arr = (ctypes.c_float * max(len(knobs), 1))(*knobs)
    i_arr = (ctypes.c_int * len(ints))(*ints)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(p_arr, k_arr, i_arr, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn_name}: kernel launch failed, CUDA error {rc}")


def count_launch(counter: dict, key: str) -> None:
    """Add one launch of ``key`` to ``counter``; during a capture with a
    tally, note it in the tally (the graph launches it at each replay)."""
    tally = _TALLY[0]
    if tally is not None and torch.cuda.is_current_stream_capturing():
        tally.append((counter, key))
    else:
        counter[key] += 1


@contextlib.contextmanager
def capture_tally():
    """Collect the launches of the kernels captured inside the block:
    yields the list of (counter, key) they add at each replay."""
    old, tally = _TALLY[0], []
    _TALLY[0] = tally
    try:
        yield tally
    finally:
        _TALLY[0] = old


def add_tally(tally, times: int = 1) -> None:
    """Count ``times`` replays of a graph whose capture noted ``tally``."""
    for counter, key in tally:
        counter[key] += times
