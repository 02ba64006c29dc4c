"""Mamba-1 selective SSM block (for the Jamba hybrid).

The port of the JAX package's ``models/mamba.py``: ``mamba_specs``,
``_causal_conv`` (with its conv state) and ``mamba_layer``.  Decode keeps
O(1) state per layer, ``(conv_state [B, d_conv - 1, d_inner], ssm_state
[B, d_inner, d_state])``; a decode step (``S == 1``) takes the closed-form
single update.  Prefill runs the scan chunk by chunk over
``RunConfig.scan_chunk`` steps, the last chunk padded with zero ``dt``
(``abar = exp(0) = 1`` and ``bx = 0``: padded steps leave the state as it
is), so that no more than one chunk's ``[B, Q, d_inner, d_state]`` terms
exist at once.  Inside a chunk the JAX package runs
``jax.lax.associative_scan``; here the same combine ``(a1, b1) ∘ (a2, b2)
= (a1 a2, a2 b1 + b2)`` runs as a Hillis-Steele scan over the chunk's
steps (log2 Q whole-tensor passes), whose f32 sums are taken in another
tree order than XLA's.

Tensor-parallel (``mg``, where the leaves arrive as this model rank's
``"mlp"`` shards): ``in_proj`` through
:func:`..distributed.tensor_parallel.paired_halves` (the rank's x and z
channels), the conv, ``dt_proj``, ``dt_bias``, ``A_log``, ``D`` and the
scan on the rank's ``d_inner / tp`` channels, ``x_proj`` row-parallel
(its small ``dt_rank + 2 d_state`` projection summed over the model
ranks, and its gradient likewise, since every rank's channels read all
of it), ``out_proj`` row-parallel.  The decode state is then the rank's
channel slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as TP
from ..distributed.tensor_parallel import ModelGroup
from .common import Spec
from .config import ModelConfig


def mamba_specs(cfg: ModelConfig) -> dict:
    mc = cfg.mamba
    d = cfg.d_model
    d_in = mc.expand * d
    dtr = mc.resolved_dt_rank(d)
    return {
        "in_proj": Spec((d, 2 * d_in), ("embed", "mlp")),
        "conv_w": Spec((mc.d_conv, d_in), (None, "mlp")),
        "conv_b": Spec((d_in,), ("mlp",), init="zeros"),
        "x_proj": Spec((d_in, dtr + 2 * mc.d_state), ("mlp", None)),
        "dt_proj": Spec((dtr, d_in), (None, "mlp")),
        "dt_bias": Spec((d_in,), ("mlp",), init="zeros"),
        "A_log": Spec((d_in, mc.d_state), ("mlp", None), init="ones"),
        "D": Spec((d_in,), ("mlp",), init="ones"),
        "out_proj": Spec((d_in, d), ("mlp", "embed")),
    }


def _ssm_chunk(h0: torch.Tensor, abar: torch.Tensor, bx: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``h_t = abar_t * h_{t-1} + bx_t`` over one chunk.

    abar, bx: [B, Q, d_in, N]; h0: [B, d_in, N].  Returns (h_Q, h_1..Q)."""
    a = abar
    b = bx.clone()
    b[:, 0] += abar[:, 0] * h0            # fold h0 into the first element
    Q = a.shape[1]
    off = 1
    while off < Q:
        # element t takes (a_{t-off}, b_{t-off}) ∘ (a_t, b_t)
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return b[:, -1], b


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time. x: [B, S, d_in]; w: [K, d_in].
    Returns (out, the last K - 1 inputs: the next call's conv state)."""
    K = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(K - 1):] if K > 1 else pad
    return out + b, new_state


def mamba_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                scan_chunk: int = 128,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                return_state: bool = False, mg: Optional[ModelGroup] = None):
    """x: [B, S, d_model] → [B, S, d_model] (+ the updated decode state
    ``(conv_state, ssm_state)`` with ``return_state``); on this model
    rank's channels where the leaves are its shards (the module's
    docstring; the state is then the rank's channels too)."""
    mc = cfg.mamba
    B, S, d = x.shape
    d_in = p["out_proj"].shape[0]          # this rank's channels
    split = TP.splits(mg, d_in, mc.expand * d)
    dtr = mc.resolved_dt_rank(d)
    N = mc.d_state

    if split:
        x = TP.copy_to_model(x, mg)
        xz = x @ TP.paired_halves(p["in_proj"], mg)
    else:
        xz = x @ p["in_proj"]
    xr, z = xz.split(d_in, dim=-1)
    conv_state = state[0] if state is not None else None
    xr, new_conv_state = _causal_conv(xr, p["conv_w"], p["conv_b"],
                                      conv_state)
    xr = F.silu(xr)

    proj = xr @ p["x_proj"]
    if split:
        proj = TP.copy_to_model(TP.reduce_from_model(proj, mg), mg)
    dt_r, Bc, Cc = proj.split([dtr, N, N], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"])      # [B,S,d_in]
    A = -torch.exp(p["A_log"].float())                         # [d_in, N]

    dt32 = dt.float()
    xr32 = xr.float()
    h0 = (state[1].float() if state is not None
          else torch.zeros((B, d_in, N), dtype=torch.float32,
                           device=x.device))

    if S == 1:  # decode step: closed-form single update
        abar = torch.exp(dt32[:, 0, :, None] * A)             # [B,d_in,N]
        bx = (dt32[:, 0, :, None] * Bc[:, 0, None, :].float()
              * xr32[:, 0, :, None])
        h = abar * h0 + bx
        y = torch.einsum("ben,bn->be", h, Cc[:, 0].float())
        y = y + p["D"].float() * xr32[:, 0]
        y = y[:, None, :]
        states_h = h
    else:
        Q = min(scan_chunk, S)
        pad = (-S) % Q
        Bf, Cf = Bc.float(), Cc.float()
        h, ys = h0, []
        for c0 in range(0, S + pad, Q):
            def chunk(a):                  # [B, Q, ...], zero past S
                part = a[:, c0:c0 + Q]
                if part.shape[1] < Q:
                    part = F.pad(part, (0, 0, 0, Q - part.shape[1]))
                return part
            dtc, xc, Bq, Cq = map(chunk, (dt32, xr32, Bf, Cf))
            abar = torch.exp(dtc[..., None] * A)              # [B,Q,d_in,N]
            bx = dtc[..., None] * Bq[:, :, None, :] * xc[..., None]
            h, hs = _ssm_chunk(h, abar, bx)
            ys.append(torch.einsum("bqen,bqn->bqe", hs, Cq))
        y = torch.cat(ys, dim=1)[:, :S]
        y = y + p["D"].float() * xr32
        states_h = h

    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ p["out_proj"]
    if split:
        out = TP.reduce_from_model(out, mg)
    if return_state:
        return out, (new_conv_state, states_h)
    return out
