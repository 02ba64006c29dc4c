"""Build the paged-attention CUDA kernel with ``nvcc`` and load it with
ctypes (plain C interface; :class:`repro_torch.kernels._nvcc.NvccLibrary`
compiles it at first use into ``build/`` at the root of the checkout)."""
from __future__ import annotations

import ctypes
from pathlib import Path

from .._nvcc import NvccLibrary

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("paged_attention.cu",)


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_class_pass.argtypes = (
        [ptr] * 10 + [i32] * 6 + [ctypes.c_float, i32, i32, ptr])
    lib.paged_attention_class_pass.restype = i32
    lib.paged_attention_error_string.argtypes = [i32]
    lib.paged_attention_error_string.restype = ctypes.c_char_p


LIBRARY = NvccLibrary("paged_attention", CSRC, "paged_attention.cu",
                      SOURCES, _declare)
library_path = LIBRARY.library_path
build = LIBRARY.build
ptxas_report = LIBRARY.ptxas_report
load = LIBRARY.load
