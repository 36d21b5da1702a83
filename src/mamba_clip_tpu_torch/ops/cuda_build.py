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
import re
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


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_REGS = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_SMEM = re.compile(r"(\d+) bytes smem")


def ptxas_report(log: str) -> Dict[str, dict]:
    """Each kernel's registers, spill stores and loads (bytes) and static
    shared memory (bytes) from ptxas' ``-v`` report, by mangled name."""
    out: Dict[str, dict] = {}
    entry = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = out.setdefault(m.group(1), {"registers": None, "spill_stores": 0,
                                                "spill_loads": 0, "static_smem": 0})
            continue
        if entry is None:
            continue
        if (m := _SPILL.search(line)):
            entry["spill_stores"], entry["spill_loads"] = int(m.group(1)), int(m.group(2))
        if (m := _REGS.search(line)):
            entry["registers"] = int(m.group(1))
            if (sm := _SMEM.search(line)):
                entry["static_smem"] = int(sm.group(1))
    return out


def sass_counts(library: Path, opcode: str) -> Dict[str, int]:
    """How many instructions of ``opcode`` (``"HMMA"``) each kernel of a
    built library holds, from ``cuobjdump -sass``, by mangled name."""
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, check=True)
    out: Dict[str, int] = {}
    fn = None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, 0)
        elif fn is not None and re.search(rf"\b{opcode}\b", line):
            out[fn] += 1
    return out
