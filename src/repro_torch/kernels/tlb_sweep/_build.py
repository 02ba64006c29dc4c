"""Build the TLB-sweep CUDA kernels with ``nvcc`` and load them with ctypes.

The sweep kernel (``csrc/tlb_sweep.cu`` + ``csrc/tlb_lane.cuh``) and the
kernel that builds its fill and cluster records (``csrc/tlb_records.cu``
+ ``csrc/tlb_records.cuh``) have a plain C interface;
:class:`repro_torch.kernels._nvcc.NvccLibrary` compiles both into one
library, in one ``nvcc`` run, at first use into ``build/`` at the root of
the checkout.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from .._nvcc import BUILD_DIR, NVCC_FLAGS, NvccLibrary, find_nvcc  # noqa: F401

CSRC = Path(__file__).resolve().parent / "csrc"
MAINS = ("tlb_sweep.cu", "tlb_records.cu")
SOURCES = ("tlb_sweep.cu", "tlb_lane.cuh", "tlb_records.cu",
           "tlb_records.cuh")


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tlb_sweep_launch.argtypes = [ptr] * 14 + [i32] * 12 + [ptr]
    lib.tlb_sweep_launch.restype = i32
    lib.tlb_round_launch.argtypes = [i32, ptr, ptr]
    lib.tlb_round_launch.restype = i32
    lib.tlb_sweep_smem_bytes.argtypes = [i32] * 5
    lib.tlb_sweep_smem_bytes.restype = i32
    lib.tlb_records_launch.argtypes = ([ptr, i32, i32, i32, ptr, i32, i32,
                                        ptr, ptr, ptr])
    lib.tlb_records_launch.restype = i32
    lib.tlb_sweep_error_string.argtypes = [i32]
    lib.tlb_sweep_error_string.restype = ctypes.c_char_p


LIBRARY = NvccLibrary("tlb_sweep", CSRC, MAINS, SOURCES, _declare)
library_path = LIBRARY.library_path
build = LIBRARY.build
ptxas_report = LIBRARY.ptxas_report
load = LIBRARY.load
