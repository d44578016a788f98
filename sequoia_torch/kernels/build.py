"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` source has a plain C interface. `load()` compiles each one
to an object with `nvcc` (all at once, one process per source), links them
into one shared library under `<checkout>/build/kernels/`, and loads it with
`ctypes`. The library's name carries a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the cached file. Nothing
is built when this module is imported: only the first kernel launch on a
CUDA tensor calls `load()`.

The launch counters live here too: each wrapper adds one to its count where
it launches its kernel, and nowhere else. So does `refuse_grad`, which every
wrapper calls before a launch: the kernels write raw device pointers and have
no backward, so a grad-requiring input raises rather than come back detached
(tree attention's float route has an autograd Function of its own).
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

import torch

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
    "sequoia_tree_attention": [_c_void_p] * 11 + [_c_int] * 8
    + [_c_float, _c_int, _c_int, _c_void_p],
    "sequoia_tree_attention_sm90": [_c_void_p] * 10 + [_c_int] * 7
    + [_c_float, _c_int, _c_int, _c_void_p],
    "sequoia_top_p_from_logits": [_c_void_p, _c_void_p, _c_int, _c_int,
                                  _c_double, _c_float, _c_int, _c_void_p],
    "sequoia_top_p_fused": [_c_void_p, _c_void_p, _c_int, _c_int, _c_double,
                            _c_int, _c_void_p],
    "sequoia_top_p_empty": [_c_int, _c_int, _c_int, _c_void_p],
    "sequoia_split_bf16x3": [_c_void_p] * 2 + [_c_int] * 2 + [_c_void_p],
    "sequoia_quantize_activations": [_c_void_p] * 4 + [_c_int] * 3 + [_c_void_p],
    "sequoia_empty_kernel": [_c_int, _c_int, _c_void_p],
    "sequoia_qmm8_sm90": [_c_void_p] * 5 + [_c_int] * 8 + [_c_void_p],
    "sequoia_qmm8_sm90_max_clusters": [_c_int] * 3,
    "sequoia_qmm4_sm90": [_c_void_p] * 5 + [_c_int] * 9 + [_c_void_p],
    "sequoia_qmm4_sm90_max_clusters": [_c_int] * 3,
}

launches = dict.fromkeys((
    "tree_attention", "tree_attention_kv8", "tree_attention_kv4_head",
    "tree_attention_kv4_dsplit", "tree_attention_f32", "tree_attention_kv8_f32",
    "tree_attention_kv4_head_f32", "tree_attention_kv4_dsplit_f32",
    "tree_attention_batched", "tree_attention_batched_kv8", "tree_attention_batched_kv4_head",
    "tree_attention_batched_kv4_dsplit", "tree_attention_batched_f32",
    "tree_attention_batched_kv8_f32", "tree_attention_batched_kv4_head_f32",
    "tree_attention_batched_kv4_dsplit_f32", "tree_attention_batched_sm90",
    "tree_attention_batched_sm90_kv8", "tree_attention_batched_sm90_kv4_head",
    "tree_attention_batched_sm90_kv4_dsplit", "tree_attention_batched_sm90_f32",
    "tree_attention_batched_sm90_kv8_f32", "tree_attention_batched_sm90_kv4_head_f32",
    "tree_attention_batched_sm90_kv4_dsplit_f32", "top_p_threshold_from_logits",
    "top_p_threshold_fused", "top_p_threshold_from_logits_cluster",
    "top_p_threshold_fused_cluster", "quant_matmul_int8", "quant_matmul_int8_wgmma",
    "quant_matmul_int4", "quant_matmul_int4_wgmma", "quant_matmul_tiled",
    "quant_matmul_tiled_wgmma", "quantize_activations", "quant_matmul_w8a8_wgmma",
    "quant_matmul_w4a8", "split_bf16x3"), 0)

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
    for src in sources + sorted(CSRC.glob("*.cuh")):
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


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would need a gradient through kernel `name`: grad
    mode is on and one of `tensors` (None skipped) requires grad. A launch
    returns a tensor with no history, which would cut the graph."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; call it under "
                           "torch.no_grad() or on inputs that do not require grad")


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
