"""The port's full-sequence forward and its encoder / VLM input paths
against the JAX package's, on the CPU.

Same numpy weights (the port's seeded ``init_params_numpy``, handed to
both packages) and the same inputs through ``repro.models`` and
``repro_torch.models``: ``Model.forward`` of every arch at its reduced
size (``input_embeds`` for the encoder, ``patch_embeds`` for the VLM),
a reduced HuBERT with its published head dim of 80 (the flash kernel's
new instantiation), and ``Model.prefill`` / ``prefill_chunked`` with
either input.  Tolerance: ``atol = rtol = 5e-5`` on f32 logits (the same
f32 products summed in another order).  The hybrid Jamba stack is marked
slow, as ``tests/test_models.py`` marks it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import all_cells as j_all_cells
from repro.configs import get_config as j_config
from repro.models import Model as JModel
from repro.models import RunConfig as JRunConfig
from repro_torch.configs import (ARCH_IDS, SHAPES, all_cells, cell_status,
                                 get_config)
from repro_torch.models import Model, RunConfig, params_from_numpy
from repro_torch.models.common import tree_leaves

TOL = dict(atol=5e-5, rtol=5e-5)
CHUNKS = dict(attn_q_chunk=32, attn_kv_chunk=32, scan_chunk=16,
              compute_dtype="float32")
HEAVY_ARCHS = {"jamba-1.5-large-398b"}


def _arch_params(archs):
    return [pytest.param(a, marks=pytest.mark.slow) if a in HEAVY_ARCHS
            else a for a in archs]


def _pair(cfg_t, cfg_j, **rc):
    """(port model, JAX model, numpy weights of the port's seeded init)."""
    tm = Model(cfg_t, RunConfig(**dict(CHUNKS, **rc)))
    jm = JModel(cfg_j, JRunConfig(**dict(CHUNKS, **rc)))
    return tm, jm, tm.init_numpy(0)


def _inputs(cfg, B, S, seed=0):
    """tokens (None for the encoder) and the keyword inputs, as numpy."""
    rng = np.random.default_rng(seed)
    kw = {}
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.family == "encoder":
        kw["input_embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
        toks = None
    if cfg.family == "vlm":
        kw["patch_embeds"] = (rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
    return toks, kw


def _run_both(tm, jm, P, toks, kw, method="forward", **extra):
    jout = getattr(jm, method)(
        jax.tree.map(jnp.asarray, P),
        None if toks is None else jnp.asarray(toks),
        **{k: jnp.asarray(v) for k, v in kw.items()}, **extra)
    with torch.no_grad():
        tout = getattr(tm, method)(
            params_from_numpy(P, device="cpu"),
            None if toks is None else torch.from_numpy(toks),
            **{k: torch.from_numpy(v) for k, v in kw.items()}, **extra)
    return tout, jout


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("arch", _arch_params(ARCH_IDS))
def test_forward_matches_jax(arch):
    """``Model.forward`` of every arch at its reduced size == the JAX
    package's, logits and the MoE aux loss."""
    tm, jm, P = _pair(get_config(arch, True), j_config(arch, True))
    toks, kw = _inputs(tm.cfg, 2, 48)
    (tl, ta), (jl, ja) = _run_both(tm, jm, P, toks, kw)
    assert tl.shape == (2, 48, jl.shape[-1])
    _close(tl, jl)
    assert abs(float(ta) - float(ja)) <= 5e-5 * (1 + abs(float(ja)))


@pytest.mark.parametrize("causal", [False, True])
def test_forward_at_head_dim_80_matches_jax(causal):
    """Reduced HuBERT with HuBERT-XLarge's head dim of 80 (the reduced
    config's is 32), non-causal as published and causal: the attention
    at D = 80 == the JAX package's."""
    cfg_t = dataclasses.replace(get_config("hubert-xlarge", True),
                                head_dim=80, causal=causal)
    cfg_j = dataclasses.replace(j_config("hubert-xlarge", True),
                                head_dim=80, causal=causal)
    tm, jm, P = _pair(cfg_t, cfg_j)
    assert P["blocks"]["pos0"]["attn"]["wq"].shape == (2, 128, 4 * 80)
    toks, kw = _inputs(tm.cfg, 2, 70, seed=1)
    (tl, _), (jl, _) = _run_both(tm, jm, P, toks, kw)
    _close(tl, jl)


@pytest.mark.parametrize("S", [8, 40])
def test_patch_embeds_take_the_first_positions(S):
    """A VLM's patch embeddings overwrite positions ``0 .. min(n_patches,
    S) - 1`` of the token embeddings (cast to the compute dtype), as the
    JAX ``_embed``'s ``dynamic_update_slice`` writes them; the rest are
    the tokens' rows."""
    tm, jm, P = _pair(get_config("llava-next-34b", True),
                      j_config("llava-next-34b", True))
    toks, kw = _inputs(tm.cfg, 2, S, seed=2)
    tp = params_from_numpy(P, device="cpu")
    pe = torch.from_numpy(kw["patch_embeds"])
    x = tm._embed(tp, torch.from_numpy(toks), pe)
    n = min(tm.cfg.n_patches, S)
    assert torch.equal(x[:, :n], pe[:, :n])
    assert torch.equal(x[:, n:], tp["embed"][torch.from_numpy(toks)[:, n:]
                                             .long()])
    want = jm._embed(jax.tree.map(jnp.asarray, P), jnp.asarray(toks),
                     jnp.asarray(kw["patch_embeds"]))
    _close(x, want, dict(atol=0, rtol=0))


@pytest.mark.parametrize("arch,n_chunks", [("llava-next-34b", 1),
                                           ("llava-next-34b", 2),
                                           ("hubert-xlarge", 1),
                                           ("hubert-xlarge", 3)])
def test_prefill_with_input_paths_matches_jax(arch, n_chunks):
    """``prefill`` / ``prefill_chunked`` with ``patch_embeds`` (the VLM)
    or ``input_embeds`` (the encoder, non-causal) == the JAX package's:
    logits and every KV cache; the whole prompt is embedded before it is
    chunked."""
    tm, jm, P = _pair(get_config(arch, True), j_config(arch, True))
    toks, kw = _inputs(tm.cfg, 2, 36, seed=3)
    method = "prefill" if n_chunks == 1 else "prefill_chunked"
    extra = dict(max_seq=40)
    if n_chunks > 1:
        extra["n_chunks"] = n_chunks
    (tl, ts), (jl, js) = _run_both(tm, jm, P, toks, kw, method, **extra)
    _close(tl, jl)
    for pos, leaves in ts.items():
        for key, val in leaves.items():
            _close(val, js[pos][key])


def test_input_embeds_prefill_equals_patch_prefill():
    """The VLM's prefill with ``patch_embeds`` equals, bit for bit, its
    prefill of the same rows given as ``input_embeds`` (the check V1 of
    ``chip_smoke.py`` makes at full width on the card)."""
    tm, _, P = _pair(get_config("llava-next-34b", True),
                     j_config("llava-next-34b", True))
    toks, kw = _inputs(tm.cfg, 1, 30, seed=4)
    tp = params_from_numpy(P, device="cpu")
    t, pe = torch.from_numpy(toks), torch.from_numpy(kw["patch_embeds"])
    n = tm.cfg.n_patches
    a, sa = tm.prefill(tp, t, patch_embeds=pe)
    ie = torch.cat([pe, tp["embed"][t[:, n:].long()]], 1)
    b, sb = tm.prefill(tp, None, input_embeds=ie)
    assert torch.equal(a, b)
    assert all(torch.equal(sa[p][k], sb[p][k]) for p in sa for k in sa[p])


def test_forward_takes_prefill_attention_and_loss_chunked(monkeypatch):
    """``forward`` attends through ``layers.prefill_attention`` (the flash
    kernel on the card) whatever the grad mode; only ``loss`` (the
    training forward, ``backbone(train=True)``) attends through
    ``layers.chunked_attention``, which autograd differentiates.  On the
    CPU both give the same logits."""
    from repro_torch.models import layers as TL
    tm, _, P = _pair(get_config("hubert-xlarge", True),
                     j_config("hubert-xlarge", True))
    _, kw = _inputs(tm.cfg, 1, 20, seed=5)
    tp = params_from_numpy(P, device="cpu")
    x = torch.from_numpy(kw["input_embeds"])
    calls, plain = [], []
    orig, orig_plain = TL.prefill_attention, TL.chunked_attention
    monkeypatch.setattr(TL, "prefill_attention",
                        lambda *a, **k: calls.append(k) or orig(*a, **k))
    with torch.no_grad():
        a, _ = tm.forward(tp, input_embeds=x)
    assert len(calls) == tm.cfg.n_layers
    assert all(c["causal"] is False for c in calls)
    b, _ = tm.forward(tp, input_embeds=x)
    assert len(calls) == 2 * tm.cfg.n_layers
    _close(a, b.detach(), dict(atol=1e-6, rtol=1e-6))
    monkeypatch.setattr(TL, "chunked_attention",
                        lambda *a, **k: plain.append(k) or orig_plain(*a,
                                                                      **k))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()
              if k != "blocks"}
    labels = torch.zeros(x.shape[:2], dtype=torch.long)
    loss, _ = tm.loss(dict(tp, **leaves), None, labels, input_embeds=x)
    loss.backward()
    assert len(calls) == 2 * tm.cfg.n_layers
    assert len(plain) >= tm.cfg.n_layers
    assert all(c["causal"] is False for c in plain)
    assert leaves["final_norm"].grad is not None


def test_shapes_and_cells_match_jax():
    """The port's shape set and cell table are the JAX registry's."""
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    assert [(a, s, r is None) for a, s, r in all_cells()] == \
        [(a, s, r is None) for a, s, r in j_all_cells()]
    assert cell_status("hubert-xlarge", "decode_32k") == \
        "encoder-only: no decode step"
    assert cell_status("xlstm-350m", "long_500k") is None


@pytest.mark.parametrize("arch", ["hubert-xlarge", "llava-next-34b"])
def test_jax_init_converts_leaf_for_leaf(arch):
    """The JAX package's own ``init`` (``jax.random``) converts leaf for
    leaf to the port's tree (the encoder's ``embed`` and ``lm_head``
    included) and gives the JAX forward's logits."""
    cfg_t, cfg_j = get_config(arch, True), j_config(arch, True)
    tm = Model(cfg_t, RunConfig(**CHUNKS))
    jm = JModel(cfg_j, JRunConfig(**CHUNKS))
    jp = jm.init(0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    specs = dict(tree_leaves(tm.specs()))
    got = dict(tree_leaves(tp))
    assert sorted(got) == sorted(specs)
    assert {("embed",), ("lm_head",)} <= set(got)
    for path, spec in specs.items():
        assert tuple(got[path].shape) == spec.shape, path
    toks, kw = _inputs(cfg_t, 2, 24, seed=6)
    jl, _ = jm.forward(jp, None if toks is None else jnp.asarray(toks),
                       **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        tl, _ = tm.forward(tp, None if toks is None
                           else torch.from_numpy(toks),
                           **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(tl, jl)
