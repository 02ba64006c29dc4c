"""Build the TLB-sweep CUDA kernel with ``nvcc`` and load it with ctypes.

The kernel (``csrc/tlb_sweep.cu`` + ``csrc/tlb_lane.cuh``) has a plain C
interface, so it is compiled straight into a shared library — no PyTorch
headers, a few seconds of ``nvcc`` — at first use, into ``build/`` at the
root of the checkout.  The library's name carries a hash of the sources
and flags, so an edited kernel is rebuilt and a built one is reused.  Nothing here runs at import
time: machines without ``nvcc`` import the package and use the plain
version on CPU tensors.
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
SOURCES = ("tlb_sweep.cu", "tlb_lane.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_LIB = None
_LOCK = threading.Lock()


# src/repro_torch/kernels/tlb_sweep/_build.py -> <checkout>/build
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin); the TLB-sweep kernel cannot be "
                       "built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libtlb_sweep_{_digest()}.so"


def build() -> Path:
    """Compile the kernel if this source version is not built yet; returns
    the library path.  ``nvcc``'s ``-Xptxas -v`` report (registers, shared
    memory, spills) is kept beside it as ``<lib>.ptxas.txt``."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / "tlb_sweep.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed to build the TLB-sweep kernel:\n"
                           + " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    Path(str(lib) + ".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def ptxas_report() -> str:
    """What ``-Xptxas -v`` said when the current library was built."""
    p = Path(str(library_path()) + ".ptxas.txt")
    return p.read_text() if p.exists() else ""


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with argtypes set."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.tlb_sweep_launch.argtypes = [ptr] * 13 + [i32] * 12 + [ptr]
            lib.tlb_sweep_launch.restype = i32
            lib.tlb_sweep_smem_bytes.argtypes = [i32] * 5
            lib.tlb_sweep_smem_bytes.restype = i32
            lib.tlb_sweep_error_string.argtypes = [i32]
            lib.tlb_sweep_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB
