"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers, ints and
the CUDA stream; every entry returns ``cudaGetLastError()``).  At first
use it is compiled for Hopper into ``build/kernels/`` at the repository
root::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so

The library name carries a hash of the source and of the shared
headers (``csrc/*.cuh``), so an edited kernel is rebuilt and a stale one
is never loaded; ``ptxas``' register and
shared-memory report lands beside it as ``<lib>.log``.  Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("crossbar_gemm", "fb_epilogue", "flash_attention",
           "fused_gemm_epilogue", "packed_gemm", "quantize_layout")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels build only where the CUDA "
                           "toolkit is installed")
    return nvcc


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (hash of its source, the shared
    headers and the flags in the name)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    Compiles to a temporary name and renames, so concurrent builders
    never load a half-written library.
    """
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    Path(f"{out}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s shared library."""
    return ctypes.CDLL(str(build(name)))


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a C entry of ``csrc/<name>.cu`` returned a CUDA error."""
    if err != 0:
        describe = getattr(lib, f"{name}_error_string")
        describe.restype = ctypes.c_char_p
        describe.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name}: CUDA error {err} at launch: "
                           f"{describe(err).decode()}")


def stream_handle() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, as the C entries take it."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
