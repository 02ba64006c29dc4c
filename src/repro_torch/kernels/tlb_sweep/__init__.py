"""TLB-sweep kernel: lanes -> thread blocks, state in shared memory.

The port of the JAX package's Pallas ``_tlb_sweep_kernel``: a CUDA C++
kernel for Hopper (``csrc/tlb_sweep.cu``, built by :mod:`._build`), its
plain PyTorch version (:mod:`.ref`) and the op that dispatches between
them by the device of the tensors (:func:`.ops.run_lanes`).
"""
from .ops import LAUNCHES, run_lanes  # noqa: F401
from .ref import run_lanes_ref  # noqa: F401
