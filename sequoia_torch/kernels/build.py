"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` source has a plain C interface. `load()` compiles each one
to an object with `nvcc` (all at once, one process per source), links them
into one shared library under `<checkout>/build/kernels/`, and loads it with
`ctypes`. The library's name carries a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the cached file. Nothing
is built when this module is imported: only the first kernel launch on a
CUDA tensor calls `load()`.

The launch counters live here too: each wrapper adds one to its count where
it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# No --use_fast_math: the top-p kernel's softmax must use expf and a true
# division by T to agree with torch.softmax in the accept walk.
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_c_void_p, _c_int, _c_float, _c_double = (ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_float, ctypes.c_double)
# name -> argtypes of every exported C function (restype is int: a
# cudaError_t, 0 on success).
SIGNATURES = {
    "sequoia_tree_attention": [_c_void_p] * 8 + [_c_int] * 6
    + [_c_float, _c_int, _c_void_p],
    "sequoia_top_p_from_logits": [_c_void_p, _c_void_p, _c_int, _c_int,
                                  _c_double, _c_float, _c_void_p],
    "sequoia_top_p_fused": [_c_void_p, _c_void_p, _c_int, _c_int, _c_double,
                            _c_void_p],
    "sequoia_top_p_max_vocab": [],
}

launches = {"tree_attention": 0, "top_p_threshold_from_logits": 0,
            "top_p_threshold_fused": 0}

_lib = None
_lock = threading.Lock()
build_seconds = None   # wall time of the build this process did, if any
build_log = ""         # nvcc's output (ptxas -v lines when verbose)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(sources, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd):
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stdout}"
                           f"{res.stderr}")
    return res.stdout + res.stderr


def build(verbose: bool = False) -> Path:
    """Compile every source into one shared library; returns its path.
    `verbose` adds `-Xptxas -v` (registers, shared memory and spills of
    each kernel, kept in `build_log`)."""
    global build_seconds, build_log
    sources = _sources()
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    lib_path = BUILD_DIR / f"libsequoia_kernels-{_digest(sources, flags)}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [
            subprocess.Popen([nvcc, *flags, "-c", str(s), "-o", str(o)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for s, o in zip(sources, objs)
        ]
        logs, failed = [], []
        for s, p in zip(sources, procs):
            out, _ = p.communicate()
            logs.append(f"== {s.name}\n{out}")
            if p.returncode != 0:
                failed.append(s.name)
        build_log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp_lib = Path(tmp) / lib_path.name
        build_log += _run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                           *map(str, objs)])
        os.replace(tmp_lib, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def load(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(verbose)))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
