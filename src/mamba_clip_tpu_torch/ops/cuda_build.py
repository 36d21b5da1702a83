"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` exposes a plain C interface. At first use it
is compiled with ``nvcc`` for ``sm_90a`` into a shared library under the
repository's ``build/kernels/``, named by a hash of the source, the headers
(``csrc/*.cuh``) and the flags, and loaded with ``ctypes``; a later process finds the library and
skips the compile. A missing ``nvcc`` or a failed compile raises: there is
no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas' report (registers, spills) of each compile made by this process.
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(home, "bin", "nvcc")
        nvcc = candidate if os.path.exists(candidate) else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
            "built from csrc/ at first use")
    return nvcc


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build(name: str, nvcc: Optional[str] = None) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc or find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    build_logs[name] = proc.stdout + proc.stderr
    os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build(name)))
        return lib
