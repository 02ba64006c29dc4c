"""Build a kernel library with ``nvcc`` and load it with ctypes.

Every kernel of the port has a plain C interface, so it is compiled
straight into a shared library — no PyTorch headers, a few seconds of
``nvcc`` — at first use, into ``build/`` at the root of the checkout.  The
library's name carries a hash of its sources and flags, so an edited
kernel is rebuilt and a built one is reused.  Nothing here runs at import
time: machines without ``nvcc`` import the package and use the plain
versions on CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence, Union

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

# src/repro_torch/kernels/_nvcc.py -> <checkout>/build
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


class NvccLibrary:
    """One kernel library: ``main`` (a ``.cu`` file in ``csrc``, or a
    tuple of them, compiled and linked by one ``nvcc`` run) compiled
    with :data:`NVCC_FLAGS`; ``sources`` are every file whose content the
    build depends on (hashed into the library's name); ``declare`` sets
    ``argtypes``/``restype`` of the loaded library's functions."""

    def __init__(self, name: str, csrc: Path, main: Union[str, Sequence[str]],
                 sources: Sequence[str],
                 declare: Callable[[ctypes.CDLL], None]):
        self.name, self.csrc = name, Path(csrc)
        self.mains = (main,) if isinstance(main, str) else tuple(main)
        self.sources = tuple(sources)
        self.declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def _digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for name in self.sources:
            h.update((self.csrc / name).read_bytes())
        return h.hexdigest()[:16]

    def library_path(self) -> Path:
        return BUILD_DIR / f"lib{self.name}_{self._digest()}.so"

    def build(self) -> Path:
        """Compile the kernel if this source version is not built yet;
        returns the library path.  ``nvcc``'s ``-Xptxas -v`` report
        (registers, shared memory, spills) is kept beside it as
        ``<lib>.ptxas.txt``."""
        lib = self.library_path()
        if lib.exists():
            return lib
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".tmp{os.getpid()}_{threading.get_ident()}.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(self.csrc / m) for m in self.mains]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build the {self.name} "
                               "kernel:\n" + " ".join(cmd) + "\n"
                               + proc.stdout + proc.stderr)
        Path(str(lib) + ".ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
        return lib

    def ptxas_report(self) -> str:
        """What ``-Xptxas -v`` said when the current library was built."""
        p = Path(str(self.library_path()) + ".ptxas.txt")
        return p.read_text() if p.exists() else ""

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library, with argtypes set."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self.declare(lib)
                self._lib = lib
            return self._lib
