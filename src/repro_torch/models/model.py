"""Model assembly: config → specs, the full-sequence forward and training
loss, prefill, chunked prefill, dense and paged decode.

The port of the JAX package's ``models/model.py`` for every family:
``dense``, ``moe``, ``hybrid``, ``xlstm``, the ``encoder`` (frame
embeddings in through ``input_embeds``, non-causal, never decoded: the
engine refuses it as the JAX engine does) and the ``vlm`` (patch
embeddings written over the first ``n_patches`` positions through
``patch_embeds``).  Layers are
grouped into *superblocks* of ``block_period`` layers (the lcm of the
architecture's interleave periods: jamba 8, xlstm 6, homogeneous 1), and a
superblock's position j decides the layer's mixer (attention, Mamba,
mLSTM or sLSTM) and FFN (SwiGLU MLP, MoE, or none).  Parameters keep the
JAX layout at every public function: ``{"embed" [V, d], "blocks":
{"pos{j}": {...}}, "final_norm", "lm_head" [d, V]}`` with every block leaf
stacked over superblocks.  PyTorch runs eagerly, so the JAX scan over the
stack is a Python loop over superblocks and positions.

Decode state is per position, stacked over superblocks: attention
positions hold the dense KV cache ``{"k", "v"}`` (``[nsb, B, max_seq, KVH,
D]``) or, in the paged step, the pools ``{"pool_k", "pool_v"}``; recurrent
positions hold their layer's state (Mamba ``conv``/``ssm``, mLSTM
``conv``/``C``/``n``/``m``, sLSTM ``c``/``n``/``m``/``h``).  It is updated
in place (JAX returns a new pytree; here the cache or pool would otherwise
be copied every step): ``decode_step``, ``decode_step_paged`` and
``prefill_chunked`` write into ``state`` and return it.  Every attention
position runs the port's kernels on the card: the flash-attention kernel
in prefill (with a query offset in the later chunks of
``prefill_chunked``) and in ``forward`` / ``backbone``, the paged kernel
in ``decode_step_paged``.  Every pass goes through one superblock loop,
``_layers``.

Training (``loss``, which calls ``backbone(train=True)``) is the JAX
training's function written for autograd: each stacked leaf is unbound
once a step and superblock i's slices cast to the compute dtype inside the
step, so gradients reach the stored (f32) parameters; each superblock is
recomputed in backward under ``RunConfig.remat == "full"``
(``torch.utils.checkpoint``, the JAX ``jax.checkpoint``); attention is the plain ``layers.chunked_attention``,
which the JAX training differentiates, on the CPU and on the card alike
(the flash kernel is a forward only, as the Pallas kernel is); the
recurrent layers run from a zero state and write none (the in-place
state writes of the inference passes stay off the graph); cross-entropy
is taken per sequence chunk, each chunk recomputed in backward.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from . import mamba as M
from . import moe as MoE
from . import xlstm as X
from .._device import resolve_device
from ..distributed.sharding import (batch_axes, is_device_mesh, sum_over,
                                    with_logical_constraint)
from .common import Spec, count_params, init_params_numpy, tree_map
from .config import ModelConfig, RunConfig
from ..kernels.paged_attention.ops import (classes_of, paged_attention,
                                           prepare_descriptors)

PyTree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_vocab(cfg: ModelConfig) -> int:
    return _round_up(cfg.vocab, 256)


def block_period(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return int(np.lcm(cfg.attn_every, cfg.moe_every))
    if cfg.family == "xlstm" and cfg.slstm_every:
        return cfg.slstm_every
    return 1


def n_superblocks(cfg: ModelConfig) -> int:
    per = block_period(cfg)
    assert cfg.n_layers % per == 0, (cfg.n_layers, per)
    return cfg.n_layers // per


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _mixer_kind(cfg: ModelConfig, j: int) -> str:
    if cfg.family == "xlstm":
        return "slstm" if cfg.is_slstm_layer(j) else "mlstm"
    if cfg.family == "hybrid" and not cfg.is_attn_layer(j):
        return "mamba"
    return "attn"


def _ffn_kind(cfg: ModelConfig, j: int) -> str:
    if cfg.d_ff <= 0:
        return "none"
    return "moe" if cfg.is_moe_layer(j) else "mlp"


def attn_positions(cfg: ModelConfig) -> List[int]:
    """The superblock positions whose mixer is attention."""
    return [j for j in range(block_period(cfg))
            if _mixer_kind(cfg, j) == "attn"]


def _position_specs(cfg: ModelConfig, rc: RunConfig, j: int) -> dict:
    d = cfg.d_model
    b: dict = {"ln1": Spec((d,), (None,), init="ones")}
    mk = _mixer_kind(cfg, j)
    if mk == "attn":
        b["attn"] = L.attention_specs(cfg)
    elif mk == "mamba":
        b["mamba"] = M.mamba_specs(cfg)
    elif mk == "mlstm":
        b["mlstm"] = X.mlstm_specs(cfg)
    elif mk == "slstm":
        b["slstm"] = X.slstm_specs(cfg)
    fk = _ffn_kind(cfg, j)
    if fk != "none":
        b["ln2"] = Spec((d,), (None,), init="ones")
        b["moe" if fk == "moe" else "mlp"] = (
            MoE.moe_specs(cfg, rc) if fk == "moe" else L.mlp_specs(cfg))
    return b


def _stack(tree: PyTree, n: int) -> PyTree:
    if isinstance(tree, dict):
        return {k: _stack(v, n) for k, v in tree.items()}
    return Spec((n,) + tree.shape, ("layers",) + tree.logical,
                init=tree.init, scale=tree.scale, dtype=tree.dtype)


def model_specs(cfg: ModelConfig, rc: RunConfig) -> dict:
    d, V = cfg.d_model, padded_vocab(cfg)
    nsb = n_superblocks(cfg)
    blocks = {f"pos{j}": _position_specs(cfg, rc, j)
              for j in range(block_period(cfg))}
    s: dict = {
        "embed": Spec((V, d), ("vocab", "embed"), init="embed", scale=0.02),
        "blocks": _stack(blocks, nsb),
        "final_norm": Spec((d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = Spec((d, V), ("embed", "vocab"))
    return s


# ---------------------------------------------------------------------------
# decode-state structure
# ---------------------------------------------------------------------------

def decode_state_shapes(cfg: ModelConfig, batch: int, max_seq: int,
                        dtype=torch.bfloat16
                        ) -> Dict[str, Dict[str, Tuple[tuple, torch.dtype]]]:
    """``{pos: {name: (shape, dtype)}}`` of the decode state, stacked over
    superblocks: KV caches and conv states in ``dtype`` (the compute
    dtype), the recurrent ``ssm``, ``C``, ``n``, ``m``, ``c`` and ``h`` in
    f32, as the JAX package keeps them."""
    nsb = n_superblocks(cfg)
    f32 = torch.float32
    out: dict = {}
    for j in range(block_period(cfg)):
        mk = _mixer_kind(cfg, j)
        if mk == "attn":
            kv = ((nsb, batch, max_seq, cfg.n_kv_heads, cfg.head_dim), dtype)
            out[f"pos{j}"] = {"k": kv, "v": kv}
        elif mk == "mamba":
            mc = cfg.mamba
            d_in = mc.expand * cfg.d_model
            out[f"pos{j}"] = {
                "conv": ((nsb, batch, mc.d_conv - 1, d_in), dtype),
                "ssm": ((nsb, batch, d_in, mc.d_state), f32)}
        elif mk == "mlstm":
            d_in = 2 * cfg.d_model
            H = cfg.n_heads
            dh = d_in // H
            out[f"pos{j}"] = {
                "conv": ((nsb, batch, 3, d_in), dtype),
                "C": ((nsb, batch, H, dh, dh), f32),
                "n": ((nsb, batch, H, dh), f32),
                "m": ((nsb, batch, H), f32)}
        elif mk == "slstm":
            out[f"pos{j}"] = {key: ((nsb, batch, cfg.d_model), f32)
                              for key in ("c", "n", "m", "h")}
    return out


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device="cuda") -> dict:
    """Zero decode state for :meth:`Model.decode_step` on ``device`` (the
    card unless ``"cpu"`` is asked for; raises without a card); the
    xLSTM stabilisers ``m`` start at ``-1e30``, not 0."""
    device = resolve_device(device)
    state = {pos: {name: torch.zeros(shape, dtype=dt, device=device)
                   for name, (shape, dt) in leaves.items()}
             for pos, leaves in decode_state_shapes(cfg, batch, max_seq,
                                                    dtype).items()}
    for st in state.values():
        if "m" in st and ("C" in st or "h" in st):
            st["m"].fill_(X.NEG_INF)
    return state


def decode_state_logical(cfg: ModelConfig) -> dict:
    """Logical axes of the decode state (:func:`decode_state_shapes`'
    tree), for its shardings."""
    out: dict = {}
    for j in range(block_period(cfg)):
        mk = _mixer_kind(cfg, j)
        if mk == "attn":
            kv = ("layers", "batch", "kv_seq", "kv_heads", "kv_head_dim")
            out[f"pos{j}"] = {"k": kv, "v": kv}
        elif mk == "mamba":
            out[f"pos{j}"] = {
                "conv": ("layers", "batch", None, "kv_head_dim"),
                "ssm": ("layers", "batch", "kv_head_dim", None)}
        elif mk == "mlstm":
            out[f"pos{j}"] = {
                "conv": ("layers", "batch", None, None),
                "C": ("layers", "batch", None, None, None),
                "n": ("layers", "batch", None, None),
                "m": ("layers", "batch", None)}
        elif mk == "slstm":
            out[f"pos{j}"] = {k: ("layers", "batch", None)
                              for k in ("c", "n", "m", "h")}
    return out


def _write_state(dst: dict, i: int, new: dict) -> None:
    """Superblock i's slice of the stacked state ``dst`` := ``new``."""
    for key, val in new.items():
        dst[key][i].copy_(val)


def _slice_state(st: dict, i: int) -> dict:
    return {key: val[i] for key, val in st.items()}


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Model:
    """``mesh`` (a ``DeviceMesh``) and ``act_rules`` make the model one
    data-parallel rank's: the batch it is given is this rank's rows of a
    global batch split over the mesh axes of ``ACT_RULES[act_rules]``'s
    "batch" rule, and the statistics of the global batch — the loss's
    token sum and mask count, the MoE balance loss's means — are summed
    over those ranks (where a gradient flows through the sum, its backward
    sums the gradient over the same ranks: each rank's gradient is then
    the number of data ranks times its share, and their mean the global
    batch's, :func:`..train.train_step.make_train_step`).  Activations go
    through ``with_logical_constraint``, the identity on the plain tensors
    the port computes on."""
    cfg: ModelConfig
    rc: RunConfig
    mesh: Optional[Any] = None
    act_rules: str = "default"

    # ---- params ----
    def specs(self) -> dict:
        return model_specs(self.cfg, self.rc)

    def n_params(self) -> int:
        return count_params(self.specs())

    def init_numpy(self, seed: int = 0) -> PyTree:
        """Seeded numpy weights (:func:`.common.init_params_numpy`)."""
        return init_params_numpy(self.specs(), seed=seed,
                                 dtype=self.rc.param_dtype)

    def init_on_device(self, seed: int = 0, device="cuda") -> PyTree:
        """The weights of :meth:`init_numpy`, drawn slice by slice and
        stored in ``param_dtype`` on ``device`` (the card unless ``"cpu"``
        is asked for): :func:`.convert.init_params_on_device`."""
        from .convert import init_params_on_device
        return init_params_on_device(self.specs(), seed=seed,
                                     dtype=torch_dtype(self.rc.param_dtype),
                                     device=device)

    @property
    def cdt(self) -> torch.dtype:
        return torch_dtype(self.rc.compute_dtype)

    def compute_params(self, params: PyTree) -> PyTree:
        """The weights the passes multiply with: ``embed``, ``lm_head`` and
        every block leaf in the compute dtype (``final_norm`` stays as it
        is).  The JAX package casts these inside every call; the port
        casts once, and each pass's own cast is then a no-op."""
        return {k: (tree_map(self._cast, v)
                    if k in ("embed", "lm_head", "blocks")
                    else v) for k, v in params.items()}

    # ---- helpers ----
    def _constrain(self, x, logical):
        return with_logical_constraint(x, logical, self.mesh, self.act_rules)

    def _batch_sum(self, x: torch.Tensor, autograd: bool = False
                   ) -> torch.Tensor:
        """``x`` summed over the data ranks (:class:`Model`); unchanged
        without a ``DeviceMesh``."""
        if not is_device_mesh(self.mesh):
            return x
        return sum_over(x, self.mesh, batch_axes(self.mesh, self.act_rules),
                        autograd=autograd)

    def _cast(self, a: torch.Tensor) -> torch.Tensor:
        return a.to(self.cdt) if a.is_floating_point() else a

    def _embed(self, params, tokens, patch_embeds=None):
        """tokens [B, S] → [B, S, d] in the compute dtype; a VLM's
        ``patch_embeds`` [B, n_patches, d] take the first ``min(n_patches,
        S)`` positions (cast to the compute dtype), as the JAX package's
        ``dynamic_update_slice`` writes them."""
        x = params["embed"].to(self.cdt)[tokens.long()]
        if self.cfg.n_patches and patch_embeds is not None:
            n = min(self.cfg.n_patches, x.shape[1])
            x = torch.cat([patch_embeds[:, :n].to(self.cdt), x[:, n:]], 1)
        return x

    def _inputs(self, params, tokens, patch_embeds, input_embeds):
        """The first hidden state [B, S, d]: ``input_embeds`` cast to the
        compute dtype (the encoder's frames; tokens are not read), else
        :meth:`_embed` of ``tokens`` and ``patch_embeds``."""
        if input_embeds is not None:
            x = input_embeds.to(self.cdt)
        else:
            x = self._embed(params, tokens, patch_embeds)
        return self._constrain(x, ("batch", "seq", "embed"))

    def _logits(self, params, x):
        head = params.get("lm_head")
        if head is None:
            head = params["embed"].T
        logits = x @ head.to(x.dtype)
        V = padded_vocab(self.cfg)
        if V != self.cfg.vocab:  # mask padding classes
            pad = torch.arange(V, device=x.device) >= self.cfg.vocab
            logits = torch.where(pad, -1e9, logits.float())
        return logits

    def _mixer(self, j: int, p: dict, h: torch.Tensor,
               state: Optional[dict]):
        """A recurrent position's mixer over h [B, S, d] from ``state`` (one
        superblock's slice) → (out, new state); from a zero state, and with
        no state out, where ``state`` is None."""
        cfg, sc = self.cfg, self.rc.scan_chunk
        mk = _mixer_kind(cfg, j)
        if state is None:
            layer = {"mamba": M.mamba_layer, "mlstm": X.mlstm_layer,
                     "slstm": X.slstm_layer}[mk]
            return layer(cfg, p[mk], h, scan_chunk=sc), None
        if mk == "mamba":
            out, (cs, ss) = M.mamba_layer(
                cfg, p["mamba"], h, scan_chunk=sc,
                state=(state["conv"], state["ssm"]), return_state=True)
            return out, {"conv": cs, "ssm": ss}
        if mk == "mlstm":
            st = X.MLSTMState(state["conv"], state["C"], state["n"],
                              state["m"])
            out, s = X.mlstm_layer(cfg, p["mlstm"], h, scan_chunk=sc,
                                   state=st, return_state=True)
            return out, {"conv": s.conv, "C": s.C, "n": s.n, "m": s.m}
        if mk == "slstm":
            st = X.SLSTMState(state["c"], state["n"], state["m"], state["h"])
            out, s = X.slstm_layer(cfg, p["slstm"], h, scan_chunk=sc,
                                   state=st, return_state=True)
            return out, {"c": s.c, "n": s.n, "m": s.m, "h": s.h}
        raise ValueError(mk)

    def _ffn(self, j: int, p: dict, x: torch.Tensor):
        """Residual FFN half of position j (none where ``d_ff == 0``) →
        (x, the MoE aux loss, or None at a position without MoE)."""
        fk = _ffn_kind(self.cfg, j)
        if fk == "none":
            return x, None
        h = L.rms_norm(x, p["ln2"], self.cfg.rms_eps)
        if fk == "moe":
            f, aux = MoE.moe_ffn(self.cfg, self.rc, p["moe"], h,
                                 mesh=self.mesh, act_rules=self.act_rules)
            return x + f, aux
        return x + L.mlp(p["mlp"], h), None

    def _layers(self, params, x: torch.Tensor, state: Optional[dict],
                attend: Callable, remat: bool = False):
        """x [B, S, d] through every superblock and position, as the JAX
        package's ``_superblock`` → (x, the MoE aux loss summed over layers,
        f32): the mixer (``attend(i, p_attn, st, h)`` → [B, S, d] at
        attention positions, which reads and writes superblock i's slice of
        the position's state ``st`` itself; the recurrent layer from its
        state slice, written back in place, elsewhere), then the position's
        FFN.  ``state=None``: no state read or written (``st`` is None, the
        recurrent layers start from zero).  Superblock i's leaves are cast
        to the compute dtype inside the pass (a no-op on
        :meth:`compute_params`'s), so gradients reach stored f32
        parameters; ``remat`` recomputes each superblock in backward
        (``torch.utils.checkpoint``, the JAX ``jax.checkpoint``)."""
        cfg = self.cfg
        # each stacked leaf split once: a slice a[i] per superblock would
        # make autograd add nsb zero-padded full-size gradients per leaf;
        # unbind's backward stacks them once
        blocks = tree_map(lambda a: a.unbind(0), params["blocks"])

        def superblock(x, i):
            p_sb = tree_map(lambda ts: self._cast(ts[i]), blocks)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for j in range(block_period(cfg)):
                p = p_sb[f"pos{j}"]
                st = None if state is None else state[f"pos{j}"]
                h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
                if _mixer_kind(cfg, j) == "attn":
                    mix = attend(i, p["attn"], st, h)
                else:
                    mix, new = self._mixer(
                        j, p, h, None if st is None else _slice_state(st, i))
                    if new is not None:
                        _write_state(st, i, new)
                x, a = self._ffn(j, p, x + mix)
                if a is not None:
                    aux = aux + a
            return self._constrain(x, ("batch", "seq", "embed")), aux

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(n_superblocks(cfg)):
            if remat:
                x, a = checkpoint(superblock, x, i, use_reentrant=False)
            else:
                x, a = superblock(x, i)
            aux = aux + a
        return x, aux

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        return self._logits(params, L.rms_norm(x, params["final_norm"],
                                               self.cfg.rms_eps))

    # ---- public passes ----
    def backbone(self, params, tokens: Optional[torch.Tensor] = None, *,
                 patch_embeds=None, input_embeds=None, positions=None,
                 train: bool = False):
        """Full-sequence forward → (final hidden [B, S, d] after the final
        norm, the MoE aux loss summed over layers, f32).

        Inputs as :meth:`_inputs`; ``positions`` [B, S] default to ``0 ..
        S - 1``.  Attention is ``layers.prefill_attention`` (the flash
        kernel on the card) with ``causal=cfg.causal``.  ``train=True``
        (:meth:`loss`) is the training forward of the module's docstring:
        attention by ``chunked_attention``, each superblock recomputed in
        backward under ``remat == "full"`` while grad mode is on."""
        cfg, rc = self.cfg, self.rc
        x = self._inputs(params, tokens, patch_embeds, input_embeds)
        B, S = x.shape[:2]
        if positions is None:
            positions = torch.arange(S, device=x.device).expand(B, S)

        def attend(i, p, st, h):
            q, k, v = L.attention_qkv(cfg, p, h, positions)
            if train:
                o = L.chunked_attention(q, k, v, causal=cfg.causal,
                                        q_chunk=rc.attn_q_chunk,
                                        kv_chunk=rc.attn_kv_chunk)
            else:
                o = L.prefill_attention(q, k, v, causal=cfg.causal, rc=rc)
            return o.reshape(B, S, cfg.q_dim) @ p["wo"]

        remat = train and rc.remat == "full" and torch.is_grad_enabled()
        x, aux = self._layers(params, x, None, attend, remat=remat)
        return L.rms_norm(x, params["final_norm"], cfg.rms_eps), aux

    def forward(self, params, tokens: Optional[torch.Tensor] = None, *,
                patch_embeds=None, input_embeds=None, positions=None):
        """Full-sequence forward → (logits [B, S, V], aux) (inference and
        tests; :meth:`backbone`'s inputs)."""
        x, aux = self.backbone(params, tokens, patch_embeds=patch_embeds,
                               input_embeds=input_embeds,
                               positions=positions)
        return self._logits(params, x), aux

    def loss(self, params, tokens: Optional[torch.Tensor], labels, *,
             mask=None, patch_embeds=None, input_embeds=None,
             xent_chunk: int = 512):
        """Training loss → (mean masked cross-entropy, the MoE aux loss).

        The lm head and the cross-entropy are taken ``xent_chunk`` positions
        at a time, each chunk recomputed in backward, so ``[B, S, V]``
        logits never exist at once; padded vocabulary classes get a
        ``-1e9`` bias; the sum of ``mask``-weighted token losses (``mask``
        defaults to ones) is divided by ``max(mask.sum(), 1)``, both summed
        over the data ranks on a mesh (:class:`Model`)."""
        cfg = self.cfg
        x, aux = self.backbone(params, tokens, patch_embeds=patch_embeds,
                               input_embeds=input_embeds, train=True)
        B, S, _ = x.shape
        head = params.get("lm_head")
        if head is None:
            head = params["embed"].T
        head = head.to(x.dtype)
        V = padded_vocab(cfg)
        pad_bias = torch.where(torch.arange(V, device=x.device) >= cfg.vocab,
                               -1e9, 0.0).float()
        labels = labels.long()
        if mask is None:
            mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
        mask = mask.float()

        def chunk_nll(xc, lc, mc, head):
            logits = (xc @ head).float() + pad_bias
            lse = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, lc[..., None])[..., 0]
            return ((lse - ll) * mc).sum()

        C = min(xent_chunk, S)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, S, C):
            part = (x[:, c0:c0 + C], labels[:, c0:c0 + C],
                    mask[:, c0:c0 + C], head)
            if torch.is_grad_enabled():
                total = total + checkpoint(chunk_nll, *part,
                                           use_reentrant=False)
            else:
                total = total + chunk_nll(*part)
        total = self._batch_sum(total, autograd=True)
        return total / torch.clamp_min(self._batch_sum(mask.sum()), 1.0), aux

    @torch.no_grad()
    def prefill(self, params, tokens: Optional[torch.Tensor], *,
                patch_embeds=None, input_embeds=None,
                max_seq: Optional[int] = None):
        """tokens [B, S] (or ``input_embeds`` [B, S, d]; a VLM's
        ``patch_embeds`` over the first positions, as :meth:`_embed`) →
        (logits [B, S, V], decode state filled to S tokens: the dense KV
        cache ``{"k", "v"}`` of ``[nsb, B, max_seq, KVH, D]`` at attention
        positions, each recurrent layer's state after the S tokens at the
        others).  :meth:`prefill_chunked` in one chunk."""
        return self.prefill_chunked(params, tokens, n_chunks=1,
                                    patch_embeds=patch_embeds,
                                    input_embeds=input_embeds,
                                    max_seq=max_seq)

    @torch.no_grad()
    def prefill_chunked(self, params, tokens: Optional[torch.Tensor], *,
                        n_chunks: int, patch_embeds=None, input_embeds=None,
                        max_seq: Optional[int] = None):
        """Sarathi-style chunked prefill: the S tokens in ``n_chunks``
        passes of ``S / n_chunks``, each through every layer; the whole
        prompt is embedded first (:meth:`_inputs`: ``input_embeds``, or
        the tokens with a VLM's ``patch_embeds``), as the JAX package
        embeds it before chunking.  A chunk
        writes its K/V into the cache prefix and attends over ``[0, off +
        Sc)`` with its queries at ``off ..`` (the flash-attention kernel's
        query offset on the card, ``chunked_attention`` on the CPU);
        recurrent positions carry their state from chunk to chunk, and
        each chunk's MoE dispatch takes its own capacity.  Returns
        (logits [B, S, V], decode state) as :meth:`prefill`."""
        cfg, rc = self.cfg, self.rc
        x_full = self._inputs(params, tokens, patch_embeds, input_embeds)
        B, S = x_full.shape[:2]
        if S % n_chunks:
            raise ValueError(f"{S} tokens do not split into {n_chunks} "
                             "chunks")
        Sc = S // n_chunks
        dev = x_full.device
        state = init_decode_state(cfg, B, max_seq or S, self.cdt, dev)
        hidden = []
        for off in range(0, S, Sc):
            positions = (off + torch.arange(Sc, device=dev)).expand(B, Sc)

            def attend(i, p, st, h, off=off, positions=positions):
                q, k, v = L.attention_qkv(cfg, p, h, positions)
                kc, vc = st["k"][i], st["v"][i]
                kc[:, off:off + Sc] = k.to(kc.dtype)
                vc[:, off:off + Sc] = v.to(vc.dtype)
                o = L.prefill_attention(
                    q, kc[:, :off + Sc].to(q.dtype),
                    vc[:, :off + Sc].to(q.dtype), causal=cfg.causal, rc=rc,
                    q_offset=off)
                return o.reshape(B, Sc, cfg.q_dim) @ p["wo"]

            hidden.append(self._layers(params, x_full[:, off:off + Sc],
                                       state, attend)[0])
        x = hidden[0] if n_chunks == 1 else torch.cat(hidden, dim=1)
        return self._head(params, x), state

    @torch.no_grad()
    def decode_step(self, params, state, tokens: torch.Tensor,
                    kv_len: torch.Tensor):
        """One decode step against the dense KV cache: tokens [B, 1],
        kv_len [B] → (logits [B, 1, V], state).  Writes the step's K/V at
        position ``kv_len`` and each recurrent layer's new state into
        ``state`` in place."""
        cfg = self.cfg
        B = tokens.shape[0]
        dev = tokens.device
        kv_len = torch.as_tensor(kv_len, device=dev).long()
        bidx = torch.arange(B, device=dev)

        def attend(i, p, st, h):
            q, k, v = L.attention_qkv(cfg, p, h, kv_len[:, None])
            kc, vc = st["k"][i], st["v"][i]
            kc[bidx, kv_len] = k[:, 0].to(kc.dtype)
            vc[bidx, kv_len] = v[:, 0].to(vc.dtype)
            o = L.decode_attention(q, kc.to(q.dtype), vc.to(q.dtype),
                                   kv_len + 1)
            return o.reshape(B, 1, cfg.q_dim) @ p["wo"]

        x, _ = self._layers(params, self._embed(params, tokens), state,
                            attend)
        return self._head(params, x), state

    @torch.no_grad()
    def decode_step_paged(self, params, state, tokens: torch.Tensor,
                          kv_len, block_tables: np.ndarray, descriptors, *,
                          page_size: int, K_classes: Sequence[int]):
        """One decode step against the PAGED KV cache (the paper's path).

        ``state``: as :meth:`decode_step`'s, but attention positions hold
        ``{"pool_k", "pool_v"}`` of shape ``[nsb, n_pages, T, KVH, D]``;
        ``kv_len`` [B] and ``block_tables`` [B, max_pages] (shared by all
        layers) are host arrays; ``descriptors``: the per-class host tables
        of ``kernels.paged_attention.ops.build_descriptors``, checked and
        uploaded once for all layers (not at all where the model has no
        attention position).  Writes the step's K/V into the pools and each
        recurrent layer's new state into ``state`` in place; a batch slot
        whose page is ``-1`` (an inactive slot) writes no K/V — a raw index
        -1 would wrap to the last pool page, which a live sequence may own
        — and steps its recurrent state on its junk token, as the
        reference does (its slot is overwritten when a request is
        admitted)."""
        cfg = self.cfg
        B = tokens.shape[0]
        dev = tokens.device
        kv_host = np.asarray(kv_len.cpu() if isinstance(kv_len, torch.Tensor)
                             else kv_len, dtype=np.int64)
        positions = torch.from_numpy(kv_host).to(dev)[:, None]
        attn = attn_positions(cfg)
        if attn:
            n_pool = state[f"pos{attn[0]}"]["pool_k"].shape[1]
            prep = prepare_descriptors(descriptors, classes_of(K_classes),
                                       n_pool, dev)
            page_of = np.asarray(block_tables)[np.arange(B),
                                               kv_host // page_size]
            rows = np.flatnonzero(page_of >= 0)
            rows_t = torch.from_numpy(rows).to(dev)
            pages_t = torch.from_numpy(page_of[rows].astype(np.int64)).to(dev)
            offs_t = torch.from_numpy(kv_host[rows] % page_size).to(dev)
            lens_t = torch.from_numpy((kv_host + 1).astype(np.int32)).to(dev)

        def attend(i, p, st, h):
            q, k, v = L.attention_qkv(cfg, p, h, positions)
            pk, pv = st["pool_k"][i], st["pool_v"][i]
            pk[pages_t, offs_t] = k[rows_t, 0].to(pk.dtype)
            pv[pages_t, offs_t] = v[rows_t, 0].to(pv.dtype)
            o = paged_attention(q[:, 0].contiguous(), pk, pv, None, lens_t,
                                page_size=page_size, descriptors=prep)
            return o.to(h.dtype).reshape(B, 1, cfg.q_dim) @ p["wo"]

        x, _ = self._layers(params, self._embed(params, tokens), state,
                            attend)
        return self._head(params, x), state


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy of ``logits`` [..., V] (in f32) at
    ``labels``; with ``mask``, the masked sum over ``max(mask.sum(),
    1)``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return -ll.mean()
