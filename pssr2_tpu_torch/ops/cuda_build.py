"""Build a CUDA source of ``pssr2_tpu_torch/csrc`` into a shared library
with ``nvcc`` and load it with ``ctypes``.

Each source exposes plain ``extern "C"`` launch functions (pointers, sizes,
the stream; the return value is the ``cudaGetLastError()`` code), so the
build includes no PyTorch header and takes seconds.  The library lands in
``pssr2_tpu_torch/_build/`` (listed in ``.gitignore``) under a name keyed
by :func:`digest`, so a stale build is never loaded.  Nothing is
built when a module is imported: only when a kernel is first launched.
"""

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return nvcc


def digest(src: Path) -> str:
    """Key of a build: the source, the ``csrc`` headers it includes
    (``#include "..."``) and the flags."""
    headers = [src.parent / h for h in re.findall(r'^#include "([^"]+)"', src.read_text(), re.M)]
    data = b"".join(f.read_bytes() for f in [src, *headers]) + " ".join(NVCC_FLAGS).encode()
    return hashlib.sha256(data).hexdigest()[:16]


@functools.cache
def build(name: str):
    """Compile ``csrc/<name>.cu`` (once per process and source) and return
    ``(path, seconds, ptxas_log)``; the log holds ``-Xptxas -v``'s
    registers, shared memory and spills for each kernel."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}-{digest(src)}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename: a concurrent build never sees half a file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    start = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, time.perf_counter() - start, proc.stderr


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, loaded once per process."""
    path, _, _ = build(name)
    return ctypes.CDLL(str(path))
