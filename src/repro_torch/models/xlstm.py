"""xLSTM blocks (mLSTM + sLSTM) [Beck et al., arXiv:2405.04517].

The port of the JAX package's ``models/xlstm.py``.  xlstm-350m interleaves
mLSTM blocks (matrix memory ``C`` of ``dh x dh`` per head, no hidden-state
recurrence) with sLSTM blocks (scalar memory, a true hidden-state
recurrence through block-diagonal per-head ``R``).  Both gate
exponentially with the max-stabiliser state ``m``, which starts at
``-1e30``, and both normalise their output per head (a multi-head group
norm).  Decode carries O(1) state.

The JAX package walks both recurrences one step at a time over chunks of
``scan_chunk`` steps, the last chunk padded with zero inputs; the padded
steps still run, and leave their mark on the state (the mLSTM's ``m``
rises to at least 0 and rescales ``C`` and ``n``; the sLSTM's gates see
``R h``), so the port pads and runs them too.

* sLSTM: step by step, as the reference (its gates read the previous h).
* mLSTM decode (``S == 1``): :func:`_mlstm_step`, the reference's step.
* mLSTM prefill: the chunkwise form of the same recurrence — per chunk of
  Q steps, with ``F_t = f_1 + .. + f_t`` (log forget gates),
  ``m_t = F_t + max(m_0, max_{s<=t} (i_s - F_s))`` (the stabiliser the
  step recursion ``m_t = max(f_t + m_{t-1}, i_t)`` reaches), weights
  ``D_ts = exp(i_s + F_t - F_s - m_t)`` for ``s <= t`` and ``decay_t =
  exp(m_0 + F_t - m_t)``, ``h_t = (decay_t C_0 q_t + sum_s D_ts (k_s . q_t)
  v_s) / max(|decay_t n_0 . q_t + sum_s D_ts (k_s . q_t)|, 1)`` — one
  chunk's products instead of Q dependent steps; its f32 rounding differs
  from the step order's.

Tensor-parallel (``mg``, where the leaves arrive as this model rank's
shards; every head's recurrence is its own, so a rank runs its ``H /
tp`` heads):

* mLSTM: ``up_proj`` through
  :func:`..distributed.tensor_parallel.paired_halves` (the rank's x and
  z channels, which are its heads' channels) and the conv on them;
  ``wq``, ``wk``, ``wv``, ``w_i`` and ``w_f`` row-parallel (the rules put
  ``"mlp"`` on their input dimension), their partial products
  reduce-scattered onto the rank's heads; the recurrence and the group
  norm on those heads, ``down_proj`` row-parallel;
* sLSTM: ``w_*`` column-parallel by heads; the replicated ``r_*``,
  ``b_*`` and ``norm`` taken at the rank's heads after ``copy_to_model``
  (so each rank ends with their whole gradient); ``out_proj``
  row-parallel.

The decode state is then the rank's heads (channels).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as TP
from ..distributed.tensor_parallel import ModelGroup
from .common import Spec
from .config import ModelConfig

NEG_INF = -1e30


def _pad_time(a: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 (time) of ``a`` by ``pad`` steps."""
    if not pad:
        return a
    return torch.cat([a, a.new_zeros((a.shape[0], pad) + a.shape[2:])], 1)


def _group_norm(h: torch.Tensor, H: int, gamma: torch.Tensor
                ) -> torch.Tensor:
    """Per-head layer norm of f32 ``h`` [B, S, H * dh], times ``gamma``."""
    B, S, dd = h.shape
    hr = h.reshape(B, S, H, dd // H)
    mu = hr.mean(-1, keepdim=True)
    var = hr.var(-1, keepdim=True, unbiased=False)
    hn = ((hr - mu) * torch.rsqrt(var + 1e-6)).reshape(B, S, dd)
    return hn * gamma.float()


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_in = 2 * d
    H = cfg.n_heads
    return {
        "up_proj": Spec((d, 2 * d_in), ("embed", "mlp")),
        "conv_w": Spec((4, d_in), (None, "mlp")),
        "conv_b": Spec((d_in,), ("mlp",), init="zeros"),
        "wq": Spec((d_in, d_in), ("mlp", "q_heads")),
        "wk": Spec((d_in, d_in), ("mlp", "q_heads")),
        "wv": Spec((d_in, d_in), ("mlp", "q_heads")),
        "w_i": Spec((d_in, H), ("mlp", None)),
        "w_f": Spec((d_in, H), ("mlp", None)),
        "norm": Spec((d_in,), ("mlp",), init="ones"),
        "down_proj": Spec((d_in, d), ("mlp", "embed")),
    }


class MLSTMState(NamedTuple):
    conv: torch.Tensor   # [B, 3, d_in]
    C: torch.Tensor      # [B, H, dh, dh]
    n: torch.Tensor      # [B, H, dh]
    m: torch.Tensor      # [B, H]


def _mlstm_step(carry, qkvif):
    """One step of the recurrence: q, k, v [B, H, dh]; it, ft [B, H]."""
    C, n, m = carry
    q, k, v, it, ft = qkvif
    m_new = torch.maximum(ft + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + m - m_new)
    C = f_p[..., None, None] * C + i_p[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = f_p[..., None] * n + i_p[..., None] * k
    denom = torch.clamp_min(torch.einsum("bhd,bhd->bh", n, q).abs(), 1.0)
    h = torch.einsum("bhde,bhe->bhd", C, q) / denom[..., None]
    return (C, n, m_new), h


def _mlstm_chunk(carry, q, k, v, it, ft):
    """The chunkwise form over one chunk: q, k, v [B, H, Q, dh]; it, ft
    [B, H, Q] → ((C, n, m) after the chunk, h [B, H, Q, dh])."""
    C0, n0, m0 = carry
    Q = q.shape[2]
    Fc = torch.cumsum(ft, dim=-1)                           # [B, H, Q]
    m = Fc + torch.maximum(m0[..., None],
                           torch.cummax(it - Fc, dim=-1).values)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
    log_d = ((Fc[..., :, None] - Fc[..., None, :]) + it[..., None, :]
             - m[..., :, None])                             # [B, H, t, s]
    D = torch.where(causal, torch.exp(torch.clamp_max(log_d, 0.0)), 0.0)
    decay = torch.exp(m0[..., None] + Fc - m)               # [B, H, Q]
    W = D * torch.einsum("bhtd,bhsd->bhts", q, k)
    num = (decay[..., None] * torch.einsum("bhde,bhte->bhtd", C0, q)
           + W @ v)
    den = decay * torch.einsum("bhd,bhtd->bht", n0, q) + W.sum(-1)
    h = num / torch.clamp_min(den.abs(), 1.0)[..., None]
    w_end = D[..., -1, :]                                   # [B, H, s]
    C = (decay[..., -1, None, None] * C0
         + torch.einsum("bhs,bhsd,bhse->bhde", w_end, v, k))
    n = decay[..., -1, None] * n0 + torch.einsum("bhs,bhsd->bhd", w_end, k)
    return (C, n, m[..., -1]), h


def mlstm_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                scan_chunk: int = 128,
                state: Optional[MLSTMState] = None,
                return_state: bool = False, mg: Optional[ModelGroup] = None):
    """x: [B, S, d_model] → [B, S, d_model] (+ the new :class:`MLSTMState`
    with ``return_state``); on this model rank's heads where the leaves
    are its shards (the module's docstring)."""
    B, S, d = x.shape
    d_in = p["down_proj"].shape[0]         # this rank's channels
    split = TP.splits(mg, d_in, 2 * d)
    dh = 2 * d // cfg.n_heads
    H = d_in // dh                         # this rank's heads
    dev = x.device

    if split:
        x = TP.copy_to_model(x, mg)
        xz = x @ TP.paired_halves(p["up_proj"], mg)
    else:
        xz = x @ p["up_proj"]
    xm, z = xz.split(d_in, dim=-1)
    conv_state = (state.conv if state is not None else
                  torch.zeros((B, 3, d_in), dtype=x.dtype, device=dev))
    xp = torch.cat([conv_state.to(xm.dtype), xm], dim=1)
    xc = xp[:, 0:S] * p["conv_w"][0]
    for i in range(1, 4):
        xc = xc + xp[:, i:i + S] * p["conv_w"][i]
    xc = F.silu(xc + p["conv_b"])
    new_conv = xp[:, -3:]

    def mine(a, w):
        """a @ w; row-parallel, reduced onto the rank's heads."""
        out = a @ w
        return TP.reduce_scatter_to_model(out, mg) if split else out

    def heads(a):
        return a.reshape(B, S, H, dh).float()
    q = heads(mine(xc, p["wq"])) / math.sqrt(dh)
    k = heads(mine(xc, p["wk"])) / math.sqrt(dh)
    v = heads(mine(xm, p["wv"]))
    it = mine(xc, p["w_i"]).float()
    ft = F.logsigmoid(mine(xc, p["w_f"]).float())

    if state is not None:
        carry = (state.C.float(), state.n.float(), state.m.float())
    else:
        carry = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev),
                 torch.zeros((B, H, dh), dtype=torch.float32, device=dev),
                 torch.full((B, H), NEG_INF, dtype=torch.float32,
                            device=dev))

    if S == 1:
        carry, h1 = _mlstm_step(carry, (q[:, 0], k[:, 0], v[:, 0], it[:, 0],
                                        ft[:, 0]))
        h = h1[:, None].reshape(B, 1, d_in)
    else:
        Q = min(scan_chunk, S)
        pad = (-S) % Q
        # [B, H, T, ...] with the last chunk zero-padded, as the reference
        qs, ks, vs = (_pad_time(a, pad).transpose(1, 2) for a in (q, k, v))
        its, fts = (_pad_time(a, pad).transpose(1, 2) for a in (it, ft))
        hs = []
        for c0 in range(0, S + pad, Q):
            sl = slice(c0, c0 + Q)
            carry, hc = _mlstm_chunk(carry, qs[:, :, sl], ks[:, :, sl],
                                     vs[:, :, sl], its[..., sl], fts[..., sl])
            hs.append(hc)
        h = torch.cat(hs, dim=2).transpose(1, 2)[:, :S].reshape(B, S, d_in)

    hn = _group_norm(h, H, p["norm"])
    y = (hn * F.silu(z.float())).to(x.dtype)
    out = y @ p["down_proj"]
    if split:
        out = TP.reduce_from_model(out, mg)
    if return_state:
        return out, MLSTMState(new_conv, *carry)
    return out


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

GATES = ("i", "f", "z", "o")


def slstm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    gates = {}
    for g in GATES:
        gates[f"w_{g}"] = Spec((d, d), ("embed", "q_heads"))
        gates[f"r_{g}"] = Spec((H, dh, dh), (None, None, None), scale=0.5)
        gates[f"b_{g}"] = Spec((d,), (None,), init="zeros")
    gates["norm"] = Spec((d,), (None,), init="ones")
    gates["out_proj"] = Spec((d, d), ("q_heads", "embed"))
    return gates


class SLSTMState(NamedTuple):
    c: torch.Tensor   # [B, d]
    n: torch.Tensor   # [B, d]
    m: torch.Tensor   # [B, d]
    h: torch.Tensor   # [B, d]


def slstm_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                scan_chunk: int = 128,
                state: Optional[SLSTMState] = None,
                return_state: bool = False, mg: Optional[ModelGroup] = None):
    """x: [B, S, d_model] → [B, S, d_model] (+ the new :class:`SLSTMState`
    with ``return_state``); on this model rank's heads where the leaves
    are its shards (the module's docstring: ``d`` below is then the
    rank's ``d_model / tp`` channels)."""
    B, S, d_model = x.shape
    d = p["out_proj"].shape[0]             # this rank's channels
    split = TP.splits(mg, d, d_model)
    dh = d_model // cfg.n_heads
    H = d // dh                            # this rank's heads
    dev = x.device
    p = dict(p)
    if split:
        x = TP.copy_to_model(x, mg)
        for key in [f"r_{g}" for g in GATES]:
            p[key] = TP.copy_to_model(p[key], mg).narrow(0, mg.rank * H, H)
        for key in [f"b_{g}" for g in GATES] + ["norm"]:
            p[key] = TP.copy_to_model(p[key], mg).narrow(0, mg.rank * d, d)

    # input contributions of all gates, [B, S, 4, d] (in parallel)
    pre = torch.stack([(x @ p[f"w_{g}"]).float() + p[f"b_{g}"].float()
                       for g in GATES], dim=2)
    if state is None:
        c = torch.zeros((B, d), dtype=torch.float32, device=dev)
        n = torch.zeros((B, d), dtype=torch.float32, device=dev)
        m = torch.full((B, d), NEG_INF, dtype=torch.float32, device=dev)
        h = torch.zeros((B, d), dtype=torch.float32, device=dev)
    else:
        c, n, m, h = (a.float() for a in state)
    # the four gates' block-diagonal R side by side: [H, dh, 4 dh]
    R = torch.cat([p[f"r_{g}"].float() for g in GATES], dim=-1)

    Q = min(scan_chunk, S)
    pad = (-S) % Q
    pre = _pad_time(pre, pad)
    hs = []
    for t in range(S + pad):
        r = torch.bmm(h.view(B, H, dh).transpose(0, 1), R)   # [H, B, 4dh]
        r = r.view(H, B, 4, dh).permute(1, 2, 0, 3).reshape(B, 4, d)
        g = pre[:, t] + r
        it = g[:, 0]
        ft = F.logsigmoid(g[:, 1])
        zt = torch.tanh(g[:, 2])
        ot = torch.sigmoid(g[:, 3])
        m_new = torch.maximum(ft + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(ft + m - m_new)
        c = f_p * c + i_p * zt
        n = f_p * n + i_p
        h = ot * c / torch.clamp_min(n, 1.0)
        m = m_new
        if t < S:
            hs.append(h)
    hseq = torch.stack(hs, dim=1)                            # [B, S, d]

    hn = _group_norm(hseq, H, p["norm"])
    out = hn.to(x.dtype) @ p["out_proj"]
    if split:
        out = TP.reduce_from_model(out, mg)
    if return_state:
        return out, SLSTMState(c, n, m, h)
    return out
