"""ctypes bindings for the native JPEG decode/staging module.

The port's own copy of ``mamba_clip_tpu/data/fastimage.py``. Builds
``native/fastimage.cpp`` on first use (``g++ -O3 -ljpeg``) into the
repository's ``build/fastimage/``. Falls back cleanly when libjpeg or a
compiler is unavailable: callers check ``available()`` and decode with PIL
otherwise (``data/dataset.py::_decode_to_square``), as the JAX package
does.

The C call is made with the GIL released (ctypes default), so threads
decode in parallel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_ROOT = Path(__file__).resolve().parents[3]
_SRC = _ROOT / "native" / "fastimage.cpp"
_BUILD_DIR = _ROOT / "build" / "fastimage"
_SO = _BUILD_DIR / "libfastimage.so"


def _build() -> Optional[Path]:
    if not _SRC.exists():
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if _SO.exists() and _SO.stat().st_mtime >= _SRC.stat().st_mtime:
        return _SO
    # compile to a temporary name, then rename: processes building at once
    # each load a whole library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-ljpeg", "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
        return _SO
    except (OSError, subprocess.CalledProcessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
            lib.fastimage_decode_resize.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.fastimage_decode_resize.restype = ctypes.c_int
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def decode_resize(jpeg_bytes: bytes, side: int) -> Optional[np.ndarray]:
    """JPEG bytes -> (side, side, 3) uint8 staging square, or None on
    failure (the caller falls back to PIL)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((side, side, 3), np.uint8)
    rc = lib.fastimage_decode_resize(
        jpeg_bytes, len(jpeg_bytes), side,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        return None
    return out
