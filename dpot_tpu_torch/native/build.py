"""Build the port's host preprocessing library with g++ at first use.

`preprocess.cc` beside this file becomes one shared library with a plain C
interface, loaded with ctypes, in `build/dpot_tpu_torch/native/` at the
repository root. The library's name carries a digest of the source, the
flags, the machine and the host CPU's model and flags: a `-march=native`
library built on one host can die of SIGILL on another, and `CDLL` would
still load it. Builds hold an `fcntl` lock and land by an atomic rename, so
processes that build at once (the test workers) all load one library.

A failed build raises with g++'s output; nothing falls back to numpy. The
numpy path runs only when the caller asks for it: `DPOT_DISABLE_NATIVE=1`,
read at every `get_library()` call. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "preprocess.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dpot_tpu_torch" / "native"
CXX = "g++"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def cpu_identity() -> str:
    """The host CPU's model name and feature flags (/proc/cpuinfo's first
    processor), or platform.processor() where there is no /proc."""
    keys = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                k, _, v = line.partition(":")
                keys[k.strip()] = v.strip()
    except OSError:
        return platform.processor()
    return f"{keys.get('model name', '')}|{keys.get('flags', '')}"


def digest() -> str:
    h = hashlib.sha256(SOURCE.read_bytes())
    for part in (" ".join(GXX_FLAGS), platform.machine(), cpu_identity()):
        h.update(b"\0" + part.encode())
    return h.hexdigest()[:16]


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    return Path(build_dir) / f"libdpot_native-{digest()}.so"


def build_library(cxx: str = CXX, build_dir: Path = BUILD_DIR) -> Path:
    """Compile the library unless it is there; return its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    so = library_path(build_dir)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():  # another process built it while this one waited
            return so
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [cxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"native build: cannot run {cxx!r} ({e}): {' '.join(cmd)}") from e
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native build failed (exit {r.returncode}): {' '.join(cmd)}\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(tmp, so)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, fp = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    u16p, ptrs = ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_void_p)
    n_thr = ctypes.c_int
    sigs = {
        "resize_bilinear_2d": [fp, fp, i64, i64, i64, i64, i64, n_thr],
        "pad_data_2d": [fp, fp, i64, i64, i64, i64, i64, i64, n_thr],
        "resize_trilinear_3d": [fp, fp, i64, i64, i64, i64, i64, i64, i64, n_thr],
        "assemble_windows_f32": [ptrs, fp, fp, i64, i64, i64, n_thr],
        "assemble_windows_bf16": [ptrs, u16p, u16p, i64, i64, i64, n_thr],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def get_library() -> Optional[ctypes.CDLL]:
    """The loaded library (built on first use), or None when
    DPOT_DISABLE_NATIVE=1 asks for the numpy path."""
    global _lib
    if os.environ.get("DPOT_DISABLE_NATIVE", "0") == "1":
        return None
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build_library())))
        return _lib
