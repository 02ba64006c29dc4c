"""PyTorch/CUDA port of the K-bit Aligned TLB reproduction.

A second package beside the JAX one (``src/repro``), mirroring its layout
module for module.  It imports ``torch`` and numpy only — never ``jax``
and nothing of the JAX package.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.

Ported so far: the batched TLB sweep (:func:`repro_torch.core.sweep.
run_sweep`) with its per-lane kernel written in CUDA C++ for Hopper
(``kernels/tlb_sweep/csrc/tlb_sweep.cu``), the per-call entry points
built on it (``run_method``, ``anchor_static``, ``standard_suite``), the
pure-python segment oracle and the scenario registry
(:mod:`repro_torch.scenarios`); paged decode serving of the dense models
(:class:`repro_torch.serve.ServingEngine`) with the class-k
paged-attention kernel (``kernels/paged_attention/csrc/
paged_attention.cu``) and prefill through the flash-attention kernel
(``kernels/flash_attention/csrc/flash_attention.cu``).
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
