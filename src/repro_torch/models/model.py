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

On a ``DeviceMesh`` with a ``"model"`` dimension every pass but the paged
decode step computes tensor-parallel where a weight arrives as this
model rank's shard (:meth:`Model.local_params`, the sharded train step):
attention on the rank's heads (``wq`` column-parallel, ``wo``
row-parallel, the flash kernel launched on the rank's heads on the card),
the SwiGLU MLP and the MoE experts on the rank's ``d_ff`` columns, the
Mamba, mLSTM and sLSTM mixers on the rank's channels or heads
(:mod:`.mamba`, :mod:`.xlstm`), and the embedding, the logits and the
cross-entropy on the rank's rows of the (padded) vocabulary
(:mod:`..distributed.tensor_parallel`).  A weight that arrives whole is
computed with whole, with no collective: a layer whose heads or channels
do not split evenly over the model ranks (:func:`whole_along_model`),
and every weight of the unsharded model, which so runs the same code.

The cached passes on such a mesh (``prefill``, ``prefill_chunked``,
``decode_step``: :meth:`Model._cache_pass`) take this rank's rows of the
batch and keep the decode state as DTensors placed by
``decode_state_logical`` under ``act_rules``
(:func:`..distributed.sharding.decode_state_sharding`): under
``"default"`` the KV cache is split on its head dimension over
``"model"`` and the Mamba state on its channels; under ``"decode"`` the
cache is split along the sequence over ``"model"`` (the decode attention
combines each rank's softmax partials, :func:`.layers.decode_attention`)
and the recurrent states are replicated, each rank updating its part and
all-gathering it (:func:`_fit_state`).  A state placed otherwise is
redistributed once on entry (DTensor's ``redistribute``: on NCCL one
all-to-all where a split moves from one dimension to another).  Between
passes a rank keeps only its shard of a KV cache.  Within a prefill it
computes the K/V of every KV head of its rows (``wk``, ``wv`` are
replicated), and a chunked prefill whose cache does not hold the rank's
KV heads whole keeps them for the prompt's positions until the pass ends
(:meth:`KVSlot.prefix`; every KV head where the query heads do not split
over the model ranks).
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
from ..checkpoint.checkpointer import leaf_paths, rebuild
from ..distributed import tensor_parallel as TP
from ..distributed.sharding import (MODEL_AXIS, Sharding, axes_index,
                                    batch_axes, decode_state_sharding,
                                    from_local, gather, gather_data,
                                    is_device_mesh, is_dtensor, local_slices,
                                    mesh_shape, model_group, model_range,
                                    sum_over,
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


#: logical axes whose model shard a layer computes on
TP_AXES = ("q_heads", "mlp", "vocab")
#: mixers computed on a model rank's heads
HEADED_MIXERS = ("attn", "mlstm", "slstm")


def whole_along_model(cfg: ModelConfig, path: str, tp: int
                      ) -> Optional[str]:
    """Why the leaf at ``path`` (``"blocks/pos0/attn/wq"``) is gathered
    whole along a model axis of ``tp`` ranks for the compute, or None
    where its layer computes on its model shard: attention, the mLSTM and
    the sLSTM whose ``n_heads`` do not split evenly over ``tp`` (a shard
    would end mid-head; the reduced xLSTM's 2 heads over 4 ranks), and
    the Mamba mixer whose ``d_inner`` channels do not (its fused ``[x |
    z]`` in-projection has no paired halves then)."""
    parts = path.split("/")
    if parts[0] == "blocks" and len(parts) > 2:
        if parts[2] in HEADED_MIXERS and cfg.n_heads % tp:
            return (f"{cfg.n_heads} heads do not split over {tp} model "
                    "ranks")
        if parts[2] == "mamba" and (cfg.mamba.expand * cfg.d_model) % tp:
            return (f"{cfg.mamba.expand * cfg.d_model} Mamba channels do "
                    f"not split over {tp} model ranks")
    return None


def keeps_model_shard(cfg: ModelConfig, path: str,
                      logical: Sequence[Optional[str]], shape,
                      sharding: Sharding) -> bool:
    """Whether the leaf at ``path`` (``logical`` axes, global ``shape``,
    placed by ``sharding``) is computed on as this rank's model shard: the
    model axis alone splits one of its :data:`TP_AXES` dimensions, and
    :func:`whole_along_model` names no reason to gather it whole."""
    ms = mesh_shape(sharding.mesh)
    r = model_range(shape, sharding, (0,) * len(ms.sizes))
    if r is None:
        return False
    d = r[0]
    alone = all(not (pl.is_shard() and pl.dim == d)
                for a, pl in zip(ms.axis_names, sharding.placements)
                if a != MODEL_AXIS)
    return (alone and logical[d] in TP_AXES
            and whole_along_model(cfg, path, ms.shape[MODEL_AXIS]) is None)


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
    return _zero_state(decode_state_shapes(cfg, batch, max_seq, dtype),
                       resolve_device(device))


def _zero_state(shapes: dict, device) -> dict:
    """The zero decode state of ``shapes`` (``{pos: {name: (shape,
    dtype)}}``: :func:`decode_state_shapes`' tree, or a rank's part of it)
    on ``device``, the xLSTM stabilisers ``m`` at ``-1e30``."""
    state = {pos: {name: torch.zeros(shape, dtype=dt, device=device)
                   for name, (shape, dt) in leaves.items()}
             for pos, leaves in shapes.items()}
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


#: the dimension of a recurrent state leaf (one superblock's slice: no
#: "layers" dimension) that holds its layer's channels or heads
STATE_SPLIT_DIM = {"conv": -1, "ssm": 1, "C": 1, "n": 1, "m": 1, "c": 1,
                   "h": 1}
#: each recurrent mixer's output projection, whose rows are the channels
#: the layer computes on
_OUT_PROJ = {"mamba": "out_proj", "mlstm": "down_proj", "slstm": "out_proj"}


def _mixer_channels(cfg: ModelConfig, mk: str) -> int:
    return {"mamba": lambda: cfg.mamba.expand * cfg.d_model,
            "mlstm": lambda: 2 * cfg.d_model,
            "slstm": lambda: cfg.d_model}[mk]()


def _fit_state(cfg: ModelConfig, mk: str, p: dict, state: dict,
               mg) -> Tuple[dict, Callable[[dict], dict]]:
    """A recurrent layer's state slice as the layer computes on it, and
    the function that takes the layer's new state back to the widths it
    arrived in.  The layer computes on ``1 / tp`` of its channels where its
    weights are this model rank's shards (else on all); a state leaf the
    rules replicate over the model ranks is then cut to the rank's part
    and the layer's new part all-gathered (no collective where the widths
    agree: always at one rank, and where the rules split the leaf as they
    split the weights)."""
    if mg is None or mg.size == 1:
        return state, lambda new: new
    full, local = _mixer_channels(cfg, mk), p[_OUT_PROJ[mk]].shape[0]
    gathered, out = set(), {}
    for key, x in state.items():
        dim = STATE_SPLIT_DIM[key]
        # the leaf's whole extent there: the mLSTM's heads, else channels
        f = cfg.n_heads if mk == "mlstm" and key != "conv" else full
        have, want = x.shape[dim], f * local // full
        if have != want:
            if have != f:
                raise ValueError(f"a {mk} state leaf {key} of {have} along "
                                 f"dimension {dim} for a layer on {want}")
            gathered.add(key)
            x = x.narrow(dim, mg.rank * want, want)
        out[key] = x

    def back(new: dict) -> dict:
        return {key: TP.gather_from_model(x, mg, STATE_SPLIT_DIM[key])
                if key in gathered else x for key, x in new.items()}
    return out, back


def _write_state(dst: dict, i: int, new: dict) -> None:
    """Superblock i's slice of the stacked state ``dst`` := ``new``."""
    for key, val in new.items():
        dst[key][i].copy_(val)


def _slice_state(st: dict, i: int) -> dict:
    return {key: val[i] for key, val in st.items()}


@dataclasses.dataclass
class KVSlot:
    """One attention position's KV cache in a cached pass: this rank's
    shards ``k``, ``v`` of the stacked ``[nsb, B, max_seq, KVH, D]``
    leaves (its rows of the batch), ``max_seq``, the positions ``seq`` and
    the part ``dim`` of the head dimension they hold, and ``split``, the
    :class:`.layers.CacheSplit` of the mesh dimensions of more than one
    rank that split the sequence or the head dimension (None where none
    does: the whole cache, and the plain decode attention).  ``work``:
    :meth:`prefix`'s keys and values of the prompt's earlier chunks where
    the cache does not hold the rank's KV heads whole (None once the pass
    has ended)."""
    k: torch.Tensor
    v: torch.Tensor
    max_seq: int
    seq: slice
    dim: slice
    split: Optional[L.CacheSplit] = None
    axes: Tuple[str, ...] = ()
    work: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @classmethod
    def whole(cls, k, v) -> "KVSlot":
        return cls(k, v, k.shape[2], slice(0, k.shape[2]),
                   slice(0, k.shape[4]))

    @classmethod
    def of(cls, k, v, shape, sharding: Sharding) -> "KVSlot":
        """The slot of this rank's shards ``k``, ``v`` of leaves of global
        ``shape`` placed by ``sharding``."""
        sl = local_slices(shape, sharding)
        if sl[3] != slice(0, shape[3]):
            raise ValueError("a KV cache split over its KV heads")
        ms = mesh_shape(sharding.mesh)
        seq_groups, dim_groups, axes = [], [], []
        for m, pl in enumerate(sharding.placements):
            if ms.sizes[m] == 1 or not pl.is_shard() or pl.dim < 2:
                continue
            group = sharding.mesh.get_group(m)
            (seq_groups if pl.dim == 2 else dim_groups).append(group)
            axes.append(ms.axis_names[m])
        split = (L.CacheSplit(sl[2].start, tuple(seq_groups),
                              tuple(dim_groups), sl[4])
                 if seq_groups or dim_groups else None)
        return cls(k, v, shape[2], sl[2], sl[4], split, tuple(axes))

    def split_over(self, axis: str) -> bool:
        return axis in self.axes

    def _all_positions(self) -> bool:
        return self.seq == slice(0, self.max_seq)

    def write(self, i: int, k, v, off: int) -> None:
        """Superblock i's K/V of positions ``off ..`` [B, Sc, KVH, D] (every
        KV head, whole) into the part of the cache this rank holds."""
        lo = max(off, self.seq.start)
        hi = min(off + k.shape[1], self.seq.stop)
        if lo < hi:
            s0 = self.seq.start
            for dst, src in ((self.k[i], k), (self.v[i], v)):
                dst[:, lo - s0:hi - s0] = src[:, lo - off:hi - off, :,
                                              self.dim].to(dst.dtype)

    def write_step(self, i: int, k, v, kv_len) -> None:
        """One decode step's K/V [B, 1, KVH, D] at positions ``kv_len``
        [B], on the rank that holds each row's position."""
        if self._all_positions():
            rows, at = torch.arange(k.shape[0], device=k.device), kv_len
        else:
            rows = torch.nonzero((kv_len >= self.seq.start)
                                 & (kv_len < self.seq.stop))[:, 0]
            at = kv_len[rows] - self.seq.start
        for dst, src in ((self.k[i], k), (self.v[i], v)):
            dst[rows, at] = src[rows, 0, :, self.dim].to(dst.dtype)

    def prefix(self, i: int, k, v, off: int, prompt: int, heads=None):
        """The keys and values ``[B, >= off + Sc, KVH_r, D]`` that this
        rank's query heads attend over in the chunk at ``off`` of a prompt
        of ``prompt`` positions (``k``, ``v``: the chunk's, every KV head;
        ``heads``: ``(h0, n, group)``, the rank's query heads ``h0 .. h0 +
        n`` of groups of ``group``, or None for all): the cache itself
        where it holds every position and the whole head dimension (the
        rank's KV heads' view of it); else the chunk's own where it is the
        whole prompt, and otherwise the rank's KV heads of the prompt so
        far, kept whole in ``work`` (``prompt`` positions, dropped at the
        pass's end)."""
        def mine(a):
            return a if heads is None else L.kv_heads_of(a, *heads)
        if self._all_positions() and self.dim == slice(0, k.shape[-1]):
            return mine(self.k[i]), mine(self.v[i])
        k, v = mine(k), mine(v)
        Sc = k.shape[1]
        if Sc == prompt:
            return k, v
        if self.work is None:
            nsb, B = self.k.shape[0], k.shape[0]
            self.work = tuple(torch.empty((nsb, B, prompt)
                                          + tuple(k.shape[2:]),
                                          dtype=self.k.dtype,
                                          device=k.device) for _ in "kv")
        kw, vw = self.work[0][i], self.work[1][i]
        kw[:, off:off + Sc] = k.to(kw.dtype)
        vw[:, off:off + Sc] = v.to(vw.dtype)
        return kw, vw


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Model:
    """``mesh`` (a ``DeviceMesh``) and ``act_rules`` make the model one
    rank's of a mesh.  Along the data axes (``ACT_RULES[act_rules]``'s
    "batch" rule) the batch it is given is this rank's rows of a global
    batch, and the statistics of the global batch — the loss's token sum
    and mask count, the MoE balance loss's means — are summed over those
    ranks (where a gradient flows through the sum, its backward sums the
    gradient over the same ranks: each rank's gradient is then the number
    of data ranks times its share, and their mean the global batch's,
    :func:`..train.train_step.make_train_step`).  Along ``"model"`` the
    passes compute tensor-parallel on the weights' model shards (the
    module's docstring; :meth:`local_params`); the cached passes keep the
    decode state as DTensors placed under ``act_rules``.  The compute
    runs on plain tensors: DTensor parameters are turned into this rank's
    local tensors first, and activations go through
    ``with_logical_constraint``, the identity on plain tensors."""
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

    def local_params(self, params: PyTree) -> PyTree:
        """The tensors the passes compute on: each DTensor leaf gathered
        over the data axes only, keeping this rank's model shard where
        :func:`keeps_model_shard` says its layer computes on it, and
        gathered whole (``gather``) otherwise; plain tensors as they
        are."""
        leaves = leaf_paths(params)
        if not any(is_dtensor(x) for _, x in leaves):
            return params
        logical = {path: sp.logical for path, sp in leaf_paths(self.specs())}

        def one(path, x):
            if not is_dtensor(x):
                return x
            sh = Sharding(x.device_mesh, tuple(x.placements))
            if keeps_model_shard(self.cfg, path, logical[path], x.shape, sh):
                return gather_data(x)
            return gather(x)
        return rebuild(params, {path: one(path, x) for path, x in leaves})

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
        table = params["embed"].to(self.cdt)
        mg = model_group(self.mesh)
        if TP.splits(mg, table.shape[0], padded_vocab(self.cfg)):
            x = TP.vocab_parallel_embed(table, tokens, mg)
        else:
            x = table[tokens.long()]
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

    def _head_of(self, params, dtype):
        """(the lm head [d, V_l] in ``dtype``: ``lm_head``, or the tied
        ``embed``'s transpose, which shares the embedding's vocabulary
        shard; whether it holds this model rank's vocabulary shard; the
        global class of its first column)."""
        head = params.get("lm_head")
        if head is None:
            head = params["embed"].T
        mg = model_group(self.mesh)
        split = TP.splits(mg, head.shape[-1], padded_vocab(self.cfg))
        return head.to(dtype), split, mg.rank * head.shape[-1] if split else 0

    def _pad_classes(self, n: int, start: int, device) -> torch.Tensor:
        """Which of classes ``start .. start + n`` are vocabulary padding
        (by global class index)."""
        return torch.arange(start, start + n, device=device) >= self.cfg.vocab

    def _logits(self, params, x):
        """x [B, S, d] → logits [B, S, V] (padding classes ``-1e9``); on a
        vocabulary-split head, this rank's columns gathered over the model
        ranks."""
        head, split, start = self._head_of(params, x.dtype)
        mg = model_group(self.mesh) if split else None
        logits = TP.copy_to_model(x, mg) @ head
        if padded_vocab(self.cfg) != self.cfg.vocab:  # mask padding classes
            pad = self._pad_classes(head.shape[-1], start, x.device)
            logits = torch.where(pad, -1e9, logits.float())
        return TP.gather_from_model(logits, mg)

    def _mixer(self, j: int, p: dict, h: torch.Tensor,
               state: Optional[dict]):
        """A recurrent position's mixer over h [B, S, d] from ``state`` (one
        superblock's slice) → (out, new state); from a zero state, and with
        no state out, where ``state`` is None.  On this model rank's
        channels or heads where its weights are the rank's shards, the
        state fitted to them (:func:`_fit_state`)."""
        cfg, sc = self.cfg, self.rc.scan_chunk
        mk = _mixer_kind(cfg, j)
        mg = model_group(self.mesh)
        if state is None:
            layer = {"mamba": M.mamba_layer, "mlstm": X.mlstm_layer,
                     "slstm": X.slstm_layer}[mk]
            return layer(cfg, p[mk], h, scan_chunk=sc, mg=mg), None
        state, back = _fit_state(cfg, mk, p[mk], state, mg)
        if mk == "mamba":
            out, (cs, ss) = M.mamba_layer(
                cfg, p["mamba"], h, scan_chunk=sc,
                state=(state["conv"], state["ssm"]), return_state=True,
                mg=mg)
            return out, back({"conv": cs, "ssm": ss})
        if mk == "mlstm":
            st = X.MLSTMState(state["conv"], state["C"], state["n"],
                              state["m"])
            out, s = X.mlstm_layer(cfg, p["mlstm"], h, scan_chunk=sc,
                                   state=st, return_state=True, mg=mg)
            return out, back({"conv": s.conv, "C": s.C, "n": s.n, "m": s.m})
        if mk == "slstm":
            st = X.SLSTMState(state["c"], state["n"], state["m"], state["h"])
            out, s = X.slstm_layer(cfg, p["slstm"], h, scan_chunk=sc,
                                   state=st, return_state=True, mg=mg)
            return out, back({"c": s.c, "n": s.n, "m": s.m, "h": s.h})
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
        return x + L.mlp(p["mlp"], h, model_group(self.mesh),
                         self.cfg.d_ff), None

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
        params = self.local_params(params)
        mg = model_group(self.mesh)
        x = self._inputs(params, tokens, patch_embeds, input_embeds)
        B, S = x.shape[:2]
        if positions is None:
            positions = torch.arange(S, device=x.device).expand(B, S)

        def attend(i, p, st, h):
            q, k, v = L.attention_qkv(cfg, p, h, positions, mg)
            if train:
                o = L.chunked_attention(q, k, v, causal=cfg.causal,
                                        q_chunk=rc.attn_q_chunk,
                                        kv_chunk=rc.attn_kv_chunk)
            else:
                o = L.prefill_attention(q, k, v, causal=cfg.causal, rc=rc)
            return L.attention_out(cfg, p, o, mg)

        remat = train and rc.remat == "full" and torch.is_grad_enabled()
        x, aux = self._layers(params, x, None, attend, remat=remat)
        return L.rms_norm(x, params["final_norm"], cfg.rms_eps), aux

    def forward(self, params, tokens: Optional[torch.Tensor] = None, *,
                patch_embeds=None, input_embeds=None, positions=None):
        """Full-sequence forward → (logits [B, S, V], aux) (inference and
        tests; :meth:`backbone`'s inputs)."""
        params = self.local_params(params)
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
        over the data ranks on a mesh (:class:`Model`).  Each chunk's
        cross-entropy is :func:`..distributed.tensor_parallel.
        vocab_parallel_nll`: over this rank's vocabulary shard with the
        max, the sum of exponentials and the label's logit combined over
        the model ranks on a split head, ``log sum exp(z - m) + m -
        z[label]`` on a whole one."""
        params = self.local_params(params)
        x, aux = self.backbone(params, tokens, patch_embeds=patch_embeds,
                               input_embeds=input_embeds, train=True)
        B, S, _ = x.shape
        head, split, start = self._head_of(params, x.dtype)
        mg = model_group(self.mesh) if split else None
        pad_bias = torch.where(self._pad_classes(head.shape[-1], start,
                                                 x.device), -1e9, 0.0).float()
        labels = labels.long()
        if mask is None:
            mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
        mask = mask.float()

        def chunk_nll(xc, lc, mc, head):
            logits = (TP.copy_to_model(xc, mg) @ head).float() + pad_bias
            return (TP.vocab_parallel_nll(logits, lc, mg, start) * mc).sum()

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
        (logits [B, S, V], decode state) as :meth:`prefill`.

        On a ``DeviceMesh`` (:meth:`_cache_pass`) the inputs are this
        rank's rows, the compute is tensor-parallel on the weights' model
        shards, and the state comes back as DTensors placed by
        ``decode_state_logical`` under ``act_rules``: under ``"default"``
        each rank computes every KV head (``wk``, ``wv`` are replicated)
        and keeps its part of the head dimension, and the chunks attend
        over the rank's own KV heads, kept whole beside the cache for the
        prompt's positions until the pass ends (:meth:`KVSlot.prefix`)."""
        cfg, rc = self.cfg, self.rc
        params = self.local_params(params)
        mg = model_group(self.mesh)
        x_full = self._inputs(params, tokens, patch_embeds, input_embeds)
        B, S = x_full.shape[:2]
        if S % n_chunks:
            raise ValueError(f"{S} tokens do not split into {n_chunks} "
                             "chunks")
        Sc = S // n_chunks
        dev = x_full.device
        group = cfg.n_heads // cfg.n_kv_heads
        slots, finish = self._cache_pass(None, B, max_seq or S, dev)
        hidden = []
        for off in range(0, S, Sc):
            positions = (off + torch.arange(Sc, device=dev)).expand(B, Sc)

            def attend(i, p, slot, h, off=off, positions=positions):
                q, k, v = L.attention_qkv(cfg, p, h, positions, mg,
                                          all_kv=True)
                slot.write(i, k, v, off)
                n = q.shape[2]
                kc, vc = slot.prefix(i, k, v, off, S,
                                     None if n == cfg.n_heads
                                     else (mg.rank * n, n, group))
                o = L.prefill_attention(
                    q, kc[:, :off + Sc].to(q.dtype),
                    vc[:, :off + Sc].to(q.dtype), causal=cfg.causal, rc=rc,
                    q_offset=off)
                return L.attention_out(cfg, p, o, mg)

            hidden.append(self._layers(params, x_full[:, off:off + Sc],
                                       slots, attend)[0])
        x = hidden[0] if n_chunks == 1 else torch.cat(hidden, dim=1)
        return self._head(params, x), finish()

    @torch.no_grad()
    def decode_step(self, params, state, tokens: torch.Tensor,
                    kv_len: torch.Tensor):
        """One decode step against the dense KV cache: tokens [B, 1],
        kv_len [B] → (logits [B, 1, V], state).  Writes the step's K/V at
        position ``kv_len`` and each recurrent layer's new state into
        ``state`` in place.

        On a ``DeviceMesh`` (:meth:`_cache_pass`) tokens and kv_len are
        this rank's rows and ``state`` is placed by ``decode_state_logical``
        under ``act_rules`` (redistributed once on entry where it arrives
        otherwise; returned as DTensors).  Under ``"decode"`` the cache is
        split along the sequence over ``"model"``: the rank that holds
        position ``kv_len`` writes the step's K/V, the query heads are
        all-gathered over the model ranks, each rank takes the softmax's
        partial over its positions for every head and the partials combine
        (:func:`.layers.decode_attention`), and the rank keeps its heads
        for the row-parallel ``wo``."""
        cfg = self.cfg
        params = self.local_params(params)
        mg = model_group(self.mesh)
        B = tokens.shape[0]
        dev = tokens.device
        kv_len = torch.as_tensor(kv_len, device=dev).long()
        slots, finish = self._cache_pass(state, B, None, dev)

        def attend(i, p, slot, h):
            q, k, v = L.attention_qkv(cfg, p, h, kv_len[:, None], mg,
                                      all_kv=True)
            slot.write_step(i, k, v, kv_len)
            n = q.shape[2]
            every = n != cfg.n_heads and slot.split_over(MODEL_AXIS)
            if every:                  # the partials cover every head
                q = TP.gather_from_model(q, mg, dim=2)
            kc, vc = slot.k[i], slot.v[i]
            if n != cfg.n_heads and not every:
                group = cfg.n_heads // cfg.n_kv_heads
                kc = L.kv_heads_of(kc, mg.rank * n, n, group)
                vc = L.kv_heads_of(vc, mg.rank * n, n, group)
            o = L.decode_attention(q, kc.to(q.dtype), vc.to(q.dtype),
                                   kv_len + 1, split=slot.split)
            if every:
                o = o[:, :, mg.rank * n:(mg.rank + 1) * n]
            return L.attention_out(cfg, p, o, mg)

        x, _ = self._layers(params, self._embed(params, tokens), slots,
                            attend)
        return self._head(params, x), finish()

    def _cache_pass(self, state: Optional[dict], batch: int,
                    max_seq: Optional[int], dev):
        """The decode state of one cached pass → (the tree :meth:`_layers`
        runs on: a :class:`KVSlot` at each attention position, the local
        leaves elsewhere; the function that returns the pass's state).
        ``state=None``: a new zero state for ``batch`` rows and
        ``max_seq`` positions (:meth:`prefill_chunked`).  Without a
        ``DeviceMesh`` the state is plain tensors, whole, as before; on
        one, this rank's shards of the leaves placed by
        :func:`..distributed.sharding.decode_state_sharding` under
        ``act_rules`` (``batch`` is this rank's rows of the global
        batch), redistributed where the given DTensors sit otherwise, and
        the state is returned as DTensors over them."""
        cfg = self.cfg
        if not is_device_mesh(self.mesh):
            if state is None:
                state = init_decode_state(cfg, batch, max_seq, self.cdt, dev)
            slots = {pos: (KVSlot.whole(st["k"], st["v"]) if "k" in st
                           else st) for pos, st in state.items()}
            return slots, lambda: state
        axes = batch_axes(self.mesh, self.act_rules)
        n_rows = axes_index(self.mesh, axes)[1] if axes else 1
        if state is None:
            shapes = decode_state_shapes(cfg, batch * n_rows, max_seq,
                                         self.cdt)
        else:
            shapes = {pos: {name: (tuple(x.shape), x.dtype)
                            for name, x in leaves.items()}
                      for pos, leaves in state.items()}
        some = next(iter(next(iter(shapes.values())).values()))[0]
        seq = max((sh[2] for leaves in shapes.values()
                   for name, (sh, _) in leaves.items() if name == "k"),
                  default=1)
        places = decode_state_sharding(cfg, some[1], seq, self.mesh,
                                       self.act_rules)
        if state is None:
            local = _zero_state(
                {pos: {name: (tuple(sl.stop - sl.start for sl in
                                    local_slices(shape, places[pos][name])),
                              dt) for name, (shape, dt) in leaves.items()}
                 for pos, leaves in shapes.items()}, dev)
        else:
            local = {pos: {name: x.redistribute(
                places[pos][name].mesh,
                tuple(places[pos][name].placements)).to_local()
                for name, x in leaves.items()}
                for pos, leaves in state.items()}
        slots = {pos: (KVSlot.of(st["k"], st["v"], shapes[pos]["k"][0],
                                 places[pos]["k"]) if "k" in st else st)
                 for pos, st in local.items()}

        def finish():
            for slot in slots.values():
                if isinstance(slot, KVSlot):
                    slot.work = None
            return {pos: {name: from_local(x, places[pos][name],
                                           shapes[pos][name][0])
                          for name, x in leaves.items()}
                    for pos, leaves in local.items()}
        return slots, finish

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
