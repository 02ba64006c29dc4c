"""Coalesced paged decode attention: one class-k pass per alignment class.

The port of the JAX package's Pallas ``_class_kernel``: a CUDA C++ kernel
for Hopper (``csrc/paged_attention.cu``, built by :mod:`._build`), its plain
PyTorch version (:mod:`.ref`) and the op that dispatches between them by
the device of the tensors (:func:`.ops.paged_attention`).
"""
from .ops import (CLASS_LAUNCHES, LAUNCHES, build_descriptors, dma_stats,
                  merge_partials, paged_attention,
                  paged_attention_class_pass, prepare_descriptors)
from .ref import (gather_kv, paged_attention_class_pass_ref,
                  paged_attention_ref)
