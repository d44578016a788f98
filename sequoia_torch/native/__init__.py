"""Native (C++) host helpers over ctypes (the port's copy of
`sequoia_tpu/native/__init__.py`): the planner DP's table fill.

A library is compiled with the system `g++` at first use into `_build/`
beside its source (listed in the repo's `.gitignore`) and rebuilt when
the source is newer. Without a compiler `load_library` returns None and the callers fall
back to numpy (`planner/dp.py::fill_table`, `backend="auto"`); a caller
that needs the native table asks for `backend="native"`, which raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_SRC_DIR, "_build")
_lock = threading.Lock()
_cache: dict = {}


def _compile(name: str) -> str:
    src = os.path.join(_SRC_DIR, f"{name}.cpp")
    out = os.path.join(_BUILD_DIR, f"lib{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # Built under a name of this process's own and renamed into place, so a
    # process that loads the library never reads one half written.
    tmp = f"{out}.{os.getpid()}.tmp"
    # -ffp-contract=off: no FMA contraction, so the table (and with it the
    # argmax tie-breaking) is bit-identical to the numpy path's.
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
           "-ffp-contract=off", "-o", tmp, src]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def load_library(name: str) -> Optional[ctypes.CDLL]:
    """Compile (if stale) and dlopen `native/<name>.cpp`; None when it cannot
    be compiled (no g++)."""
    with _lock:
        if name in _cache:
            return _cache[name]
        try:
            lib = ctypes.CDLL(_compile(name))
        except (subprocess.CalledProcessError, FileNotFoundError, OSError):
            lib = None
        _cache[name] = lib
        return lib


def planner_dp_lib() -> Optional[ctypes.CDLL]:
    lib = load_library("planner_dp")
    if lib is not None and not getattr(lib, "_configured", False):
        lib.sequoia_fill_table.restype = ctypes.c_int
        lib.sequoia_fill_table.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # p
            ctypes.c_int32,                   # max_branch
            ctypes.c_int32,                   # max_budget
            ctypes.c_int32,                   # max_depth
            ctypes.POINTER(ctypes.c_double),  # T out
            ctypes.POINTER(ctypes.c_int32),   # Y out
        ]
        lib._configured = True
    return lib
