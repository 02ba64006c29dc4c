"""Model / run configuration dataclasses — a copy of the JAX package's
``models/config.py`` (plain dataclasses, field for field).

``ModelConfig`` describes an architecture (one per arch in
``repro_torch.configs``); ``RunConfig`` describes execution choices (dtypes,
chunking, microbatching, sharding rule set).  Every field is kept so that a
config converts field for field; the training and sharding fields wait for
the port's training and distributed slices (ROADMAP A11, A12).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0          # 0 → ceil(d_model/16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | hybrid | xlstm | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0  # qwen2-moe style shared experts
    moe_every: int = 1         # a layer is MoE iff layer % moe_every == moe_offset
    moe_offset: int = 0
    # --- hybrid (jamba) ---
    attn_every: int = 1        # attention on layer i iff i % attn_every == attn_offset
    attn_offset: int = 0
    mamba: Optional[MambaConfig] = None
    # --- xlstm ---
    slstm_every: int = 0       # sLSTM on layer i iff slstm_every and i % slstm_every == 0
    # --- features ---
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    causal: bool = True        # False → encoder-only (hubert)
    tie_embeddings: bool = False
    # --- vlm ---
    n_patches: int = 0         # >0 → patch-embedding injection (llava stub)
    # --- norm ---
    rms_eps: float = 1e-6

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def is_moe_layer(self, i: int) -> bool:
        return (self.n_experts > 0
                and i % self.moe_every == self.moe_offset % self.moe_every)

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "xlstm":
            return False
        return i % self.attn_every == self.attn_offset % self.attn_every

    def is_slstm_layer(self, i: int) -> bool:
        return bool(self.slstm_every) and i % self.slstm_every == 0

    @property
    def n_attn_layers(self) -> int:
        return sum(self.is_attn_layer(i) for i in range(self.n_layers))

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS and sanity checks)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        for i in range(self.n_layers):
            total += 2 * d                     # pre-norms (mixer + ffn)
            if self.family == "xlstm":
                total += _xlstm_layer_params(self, i)
                continue
            if self.is_attn_layer(i):
                total += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if self.qk_norm:
                    total += 2 * self.head_dim
            elif self.mamba is not None:
                total += _mamba_layer_params(self, self.mamba)
            if ff <= 0:
                continue
            if self.is_moe_layer(i):
                total += d * self.n_experts            # router
                total += self.n_experts * 3 * d * ff   # routed experts
                total += self.n_shared_experts * 3 * d * ff
                if self.n_shared_experts:
                    total += d                         # shared-expert gate
            else:
                total += 3 * d * ff
        total += d                                     # final norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        inactive_experts = self.n_experts - self.top_k
        n_moe_layers = sum(self.is_moe_layer(i) for i in range(self.n_layers))
        return self.param_count() - n_moe_layers * inactive_experts * 3 * d * ff


def _mamba_layer_params(cfg: ModelConfig, mc: MambaConfig) -> int:
    d = cfg.d_model
    d_in = mc.expand * d
    dtr = mc.resolved_dt_rank(d)
    return (d * 2 * d_in               # in_proj (x and z)
            + d_in * mc.d_conv         # depthwise conv
            + d_in * (dtr + 2 * mc.d_state)   # x_proj → dt, B, C
            + dtr * d_in + d_in        # dt_proj + bias
            + d_in * mc.d_state        # A_log
            + d_in                     # D
            + d_in * d)                # out_proj


def _xlstm_layer_params(cfg: ModelConfig, i: int) -> int:
    d = cfg.d_model
    if cfg.is_slstm_layer(i):
        # 4 gates × (input + recurrent block-diag per head) + out
        dh = d // cfg.n_heads
        return 4 * (d * d + cfg.n_heads * dh * dh) + d * d
    d_in = 2 * d
    return (d * 2 * d_in              # up-proj (x and z)
            + d_in * 4                # causal conv (k=4)
            + 3 * d_in * d_in // cfg.n_heads * 0  # (qkv are per-head proj below)
            + 3 * d_in * d_in         # q, k, v projections
            + 3 * d_in                # i, f gate projections (per unit) + o
            + d_in * d)               # down-proj


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution knobs — the surface the §Perf hillclimb iterates on."""

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # attention chunking (memory-efficient attention block sizes)
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    # Sarathi-style chunked prefill (1 = single pass)
    prefill_seq_chunks: int = 1
    # mamba / xlstm recurrence chunk (checkpoint boundary)
    scan_chunk: int = 128
    # training
    microbatches: int = 1              # gradient-accumulation steps
    remat: str = "full"                # full | none
    optimizer: str = "adamw"           # adamw | adamw8bit | adafactor
    grad_dtype: str = "float32"        # grad-accumulator dtype (bf16 for
                                       # memory-extreme models, e.g. jamba)
    capacity_factor: float = 1.25
    # distribution
    expert_sharding: str = "tensor"    # tensor | expert
    moe_weight_gather: bool = False    # inference-only: gather small expert
                                       # stacks at use (FSDP semantics);
                                       # hurts training (full-size grad RS)
    rules: str = "default"             # sharding rule-set name
    seq_shard_decode: bool = False     # shard KV seq over data axis (long ctx)
    # kv cache / paging
    kv_page_size: int = 64             # pages of the paged KV cache (tokens)

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
