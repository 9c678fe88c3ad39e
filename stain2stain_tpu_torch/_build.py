"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Each ``csrc/*.cu`` source compiles on first use into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds). The
libraries go to ``csrc/build/`` (listed in ``.gitignore``, or
``$S2S_TORCH_BUILD_DIR``) under a name that carries a hash of the source, of
every shared header ``csrc/*.cuh`` and of the flags, so an edited source or
header rebuilds and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU tests import every module of the
port, and ``nvcc`` is needed only when a kernel first launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("attention_fwd.cu", "attention_bwd.cu", "conv3x3_fwd.cu", "prologue_grad.cu", "conv3x3_wgrad.cu",
           "dropout.cu", "layer_norm_modulate.cu")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(os.environ.get("S2S_TORCH_BUILD_DIR") or CSRC / "build")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (put the CUDA toolkit's bin/ on PATH or set CUDA_HOME)")


def _lib_path(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # any source may include any header
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build_all(sources=SOURCES) -> dict[str, str]:
    """Compile every source whose library is missing, all ``nvcc``s at once.

    Returns nvcc's output (ptxas' registers and spills) for each source it
    compiled; raises with that output if any compile failed.
    """
    with _lock:
        jobs = []
        for source in sources:
            out = _lib_path(source)
            if out.is_file():
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((source, out, tmp, proc))
        logs, errors = {}, []
        for source, out, tmp, proc in jobs:
            logs[source], _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                errors.append(f"nvcc failed on {source} (exit {proc.returncode}):\n{logs[source]}")
            else:
                os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
        if errors:
            raise RuntimeError("\n".join(errors))
        return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _lock:
        lib = _libs.get(source)
    if lib is not None:
        return lib
    build_all((source,))
    with _lock:
        if source not in _libs:
            _libs[source] = ctypes.CDLL(str(_lib_path(source)))
        return _libs[source]


__all__ = ["build_all", "build_dir", "load", "SOURCES"]
