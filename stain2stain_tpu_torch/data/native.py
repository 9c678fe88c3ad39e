"""ctypes bindings for the native batch tile decoder ``native/s2s_loader.cc``
(the port's own copy of ``stain2stain_tpu/data/native.py``).

One extern-C call decodes and resizes a whole batch into a contiguous uint8
array with an internal C++ thread pool; ctypes releases the interpreter lock
for its duration. The library is built on first use with ``make -C native``
(g++, libpng, libjpeg); where that fails, or ``S2S_DISABLE_NATIVE=1``,
:func:`available` is False and the datasets decode tile by tile.
:func:`probe` reads an image's (height, width) through the library's
``s2s_probe``, or through PIL where the library is not there.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libs2s_loader.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    with _lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        if not _LIB_PATH.exists() and (_NATIVE_DIR / "Makefile").exists():
            try:
                subprocess.run(["make", "-C", str(_NATIVE_DIR)], capture_output=True, timeout=180, check=True)
            except (OSError, subprocess.SubprocessError):
                return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None
        lib.s2s_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),  # paths
            ctypes.c_int,  # n
            ctypes.POINTER(ctypes.c_uint8),  # out
            ctypes.c_int,  # size
            ctypes.c_int,  # channels
            ctypes.c_int,  # nearest
            ctypes.c_int,  # n_threads
        ]
        lib.s2s_decode_batch.restype = ctypes.c_int
        lib.s2s_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.s2s_probe.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native decoder can be used (built or buildable, not disabled)."""
    if os.environ.get("S2S_DISABLE_NATIVE") == "1":
        return False
    return _load() is not None


def decode_batch(paths: Sequence[str], size: int, channels: int = 3, nearest: bool = False) -> np.ndarray:
    """Decode and resize ``paths`` into one ``(n, size, size, channels)`` uint8 array
    (bilinear with cv2's half-pixel centres, or nearest). Raises if any file fails."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native tile decoder unavailable (check native.available() first)")
    n = len(paths)
    out = np.zeros((n, size, size, channels), dtype=np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    ok = lib.s2s_decode_batch(
        c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), size, channels, int(nearest), 0
    )
    if ok != n:
        raise RuntimeError(f"native decode failed for {n - ok}/{n} tiles, e.g. among {list(paths)[:3]}")
    return out


def probe(path: str) -> Optional[tuple[int, int]]:
    """(height, width) of an image file, or None if it cannot be read: the
    native library's header read when it is there, else (or where it fails)
    PIL's, as JAX ``src/data_sanity.py:65-75`` falls back."""
    lib = _load() if available() else None
    if lib is not None:
        dims = (ctypes.c_int * 2)()
        if lib.s2s_probe(os.fsencode(str(path)), dims):
            return int(dims[0]), int(dims[1])
    try:
        from PIL import Image

        with Image.open(path) as im:
            return int(im.height), int(im.width)
    except Exception:
        return None


__all__ = ["available", "decode_batch", "probe"]
