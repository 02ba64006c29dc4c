"""Public op: forward flash attention, GQA-aware.

:func:`flash_attention_gqa` is the JAX op of that name without its tile
sizes and ``interpret`` (the kernel's tiles are its own and change only
the order of the f32 sums) and with the JAX ``flash_attention``'s
``scale``. It dispatches on the device of ``q``: CUDA tensors launch a
CUDA kernel (``csrc/flash_attention.cu``) or raise, CPU tensors run the
plain version (:func:`.ref.flash_attention_ref`), as every kernel
wrapper of the port does, so that one call holds the kernel's contract
on either device; there is no fallback from one to the other. On the
card the dtype alone picks the kernel: f32 inputs go to the FMA kernel
(f32 products, no TF32), bf16 inputs to the tensor-core kernel (bf16
operands and f32 sums: ``wgmma`` fed by TMA from a producer warpgroup at
head dims 32, 64, 80 and 128 (80 staged as 128, the extra columns zero),
its tensor maps built on the host per call; p kept in f32 as a bf16 hi/lo
pair). The model's
prefill does not come here on the CPU (``layers.prefill_attention``
keeps the chunked path the JAX prefill computes). The kernel reads each
query head's KV head in place, so the GQA repeat of the JAX op is never
materialised. With ``q_offset`` the queries are rows ``q_offset ..`` of a
sequence whose keys are all given (a later chunk of a chunked prefill
attending over the cache filled so far; the same kernels, their causal
test and tile bounds moved by the offset). ``LAUNCHES["flash_attention"]``
counts the kernels' launches (one per call).

The op is a forward only, as the Pallas kernel is: no kernel of the JAX
package has a backward, and its training differentiates the plain
chunked attention (``models.layers.chunked_attention``).  Called with
grad mode on and an input that requires grad, it raises rather than hand
back an output with no graph (whose gradients would silently be zero).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from .ref import flash_attention_ref

#: kernel launches so far (plain-version runs not counted)
LAUNCHES: Dict[str, int] = {"flash_attention": 0}
HEAD_DIMS = (32, 64, 80, 128)       # the kernel's instantiations (D)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError("flash_attention: " + msg)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_offset: int = 0) -> None:
    """Raise ``ValueError`` on what the kernel does not take: one device
    and dtype (f32 or bf16), q ``[B, Sq, H, D]`` and k, v ``[B, q_offset +
    Sq, KVH, D]`` with ``H % KVH == 0`` and D in :data:`HEAD_DIMS`, the head dim
    contiguous and every row on a 16-byte boundary: a 16-byte-aligned base
    and strides that are multiples of 16 bytes, which both the kernels'
    16-byte ``cp.async`` copies and TMA's tensor maps demand."""
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
           "q, k and v must be [B, S, heads, D]")
    B, S, H, D = q.shape
    KVH = k.shape[2]
    _check(isinstance(q_offset, int) and q_offset >= 0,
           f"q_offset must be an int >= 0, not {q_offset!r}")
    _check(k.shape == v.shape and k.shape[:2] == (B, q_offset + S)
           and k.shape[3] == D,
           f"k {tuple(k.shape)} and v {tuple(v.shape)} must be [B, q_offset "
           f"+ Sq, KVH, D] with q's B, Sq and D {(B, S, D)} and q_offset "
           f"{q_offset}")
    _check(B >= 1 and S >= 1 and KVH >= 1 and H % KVH == 0,
           f"H={H} query heads must group over KVH={KVH}")
    _check(B * H <= 65535, f"B * H = {B * H} exceeds the kernel's grid")
    _check(D in HEAD_DIMS, f"head dim {D} not in {HEAD_DIMS}")
    _check(q.dtype in _DTYPE_CODE and k.dtype == q.dtype
           and v.dtype == q.dtype,
           f"q, k and v must share one dtype of {list(_DTYPE_CODE)}; got "
           f"{q.dtype}, {k.dtype}, {v.dtype}")
    _check(q.device == k.device == v.device,
           "q, k and v must lie on one device")
    elt = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.stride(3) == 1, f"{name}'s head dim must be contiguous")
        _check(t.data_ptr() % 16 == 0
               and all(s * elt % 16 == 0 for n, s in zip(t.shape[:3],
                                                        t.stride()[:3])
                       if n > 1),
               f"{name}'s rows must start on 16-byte boundaries (strides "
               f"{t.stride()})")


def _launch(q, k, v, causal: bool, scale: float,
            q_offset: int) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors; returns o [B, Sq, H, D]."""
    from . import _build

    B, S, H, D = q.shape
    KVH, Skv = k.shape[2], k.shape[1]
    lib = _build.load()
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S,
            Skv, q_offset, H, KVH, D, ctypes.cast(strides, ctypes.c_void_p),
            float(scale),
            int(causal), _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    LAUNCHES["flash_attention"] += 1
    return o


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k, v: [B, q_offset + Sq, KVH, D] with ``Hq % KVH
    == 0`` → [B, Sq, Hq, D] in q's dtype; query head h attends over KV
    head ``h // (Hq // KVH)``, as after the JAX op's ``jnp.repeat``, and
    query row i sits at position ``q_offset + i`` (under ``causal`` it
    sees keys ``0 .. q_offset + i``).  ``scale`` defaults to ``1 /
    sqrt(D)``.  Forward only: raises ``ValueError`` with grad mode on and
    an input that requires grad."""
    _check(not (torch.is_grad_enabled()
                and any(t.requires_grad for t in (q, k, v))),
           "forward only (no backward, as the Pallas kernel has none): "
           "call it under torch.no_grad(), or differentiate "
           "models.layers.chunked_attention as the training path does")
    check_inputs(q, k, v, q_offset)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   q_offset=q_offset)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, scale, q_offset)
    raise ValueError(f"flash_attention: no implementation for {q.device}")
