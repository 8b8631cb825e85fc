"""Build the port's CUDA kernels with nvcc at first use.

Every `dpot_tpu_torch/csrc/*.cu` becomes its own shared library with a plain
C interface, loaded with ctypes. All sources compile at once, one nvcc
process each, into `build/dpot_tpu_torch/` at the repository root; a library
is rebuilt when the hash of the sources or of the flags changes. A failed
build raises with nvcc's output. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "dpot_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_paths() -> dict[str, Path]:
    """Kernel name (the source's stem) -> path of its shared library."""
    digest = _digest()
    return {
        src.stem: BUILD_DIR / f"lib{src.stem}-{digest}.so"
        for src in sorted(SRC_DIR.glob("*.cu"))
    }


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel."""
    paths = library_paths()
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
        )
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, built if needed."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build_all()[name]))
        return _libs[name]
