"""Prefill (flash) attention: tiled forward attention with online softmax.

The port of the JAX package's Pallas ``_flash_kernel``: a CUDA C++ kernel
for Hopper (``csrc/flash_attention.cu``, built by :mod:`._build`), its plain
PyTorch versions (:mod:`.ref`) and the op that dispatches between them by
the device of the tensors (:func:`.ops.flash_attention_gqa`).
"""
from .ops import LAUNCHES, flash_attention_gqa
from .ref import (attention_ref, flash_attention_ref, flash_attention_tc_ref,
                  split_bf16)
