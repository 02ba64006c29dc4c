"""The port's dense model against the JAX package's, on the CPU.

Same numpy weights (``params_from_numpy`` of the JAX package's own
``init_params``, or the port's seeded ``init_params_numpy`` handed to
both) and the same tokens through ``repro.models`` and
``repro_torch.models``.  Tolerances: f32 compute ``atol = rtol = 5e-5``
(the same f32 products summed in another order); bf16 compute ``atol =
rtol = 2e-2`` on single layers and ``atol = 0.1`` on logits and KV
caches after whole layers (the two frameworks round to bf16 at different
places — after each matmul, inside SiLU — so values of magnitude ~5 drift
by a few bf16 ulps).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.models import Model as JModel
from repro.models import RunConfig as JRunConfig
from repro.models import init_decode_state as j_init_decode_state
from repro.models import layers as JL
from repro.models import model_specs as j_model_specs
from repro_torch.configs import ARCH_IDS, NOT_PORTED, get_config
from repro_torch.kernels.paged_attention.ops import build_descriptors
from repro_torch.models import (Model, RunConfig, init_decode_state,
                                model_specs, params_from_numpy)
from repro_torch.models import layers as TL
from repro_torch.models.common import _walk, tree_leaves

TOL = dict(atol=5e-5, rtol=5e-5)
TOL_BF16 = dict(atol=2e-2, rtol=2e-2)
LOGIT_TOL = {"float32": TOL, "bfloat16": dict(atol=0.1, rtol=0)}
CHUNKS = dict(attn_q_chunk=32, attn_kv_chunk=32, scan_chunk=16)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _models(arch, cdt="float32"):
    jm = JModel(j_config(arch, reduced=True),
                JRunConfig(compute_dtype=cdt, **CHUNKS))
    tm = Model(get_config(arch, reduced=True),
               RunConfig(compute_dtype=cdt, **CHUNKS))
    return jm, tm


@pytest.fixture(scope="module")
def weights():
    """The JAX package's own init, as numpy: the port must compute the
    same function on converted parameters."""
    out = {}
    for arch in ("internlm2-1.8b", "qwen3-32b"):
        jm, _ = _models(arch)
        out[arch] = jax.tree.map(np.asarray, jm.init(0))
    return out


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------

def _spec_list(tree):
    """Either package's spec tree as sorted ``(path, fields)`` pairs (the
    JAX package's ``_stack`` re-orders keys through ``jax.tree.map``)."""
    return sorted((p, (s.shape, s.logical, s.init, s.scale, s.dtype))
                  for p, s in tree_leaves(tree))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_and_specs_match_jax(arch):
    for reduced in (False, True):
        assert get_config(arch, reduced) == j_config(arch, reduced) or \
            vars(get_config(arch, reduced)) == vars(j_config(arch, reduced))
    assert (_spec_list(model_specs(get_config(arch), RunConfig()))
            == _spec_list(j_model_specs(j_config(arch), JRunConfig())))


def test_non_dense_families_are_refused():
    for arch in NOT_PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP A8"):
            get_config(arch)
    moe = j_config("qwen2-moe-a2.7b", reduced=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        Model(moe, RunConfig())


def test_init_params_numpy_is_seeded_and_scaled():
    _, tm = _models("internlm2-1.8b")
    a = tm.init_numpy(3)
    b = _walk(tm.specs(), lambda *_: None)      # structure only
    c = Model(tm.cfg, tm.rc).init_numpy(3)
    serial = __import__("repro_torch.models.common", fromlist=["x"]) \
        .init_params_numpy(tm.specs(), seed=3, workers=1)
    for (pa, xa), (pc, xc), (ps, xs) in zip(tree_leaves(a), tree_leaves(c),
                                            tree_leaves(serial)):
        assert pa == pc == ps
        np.testing.assert_array_equal(xa, xc)
        np.testing.assert_array_equal(xa, xs)
    assert set(dict(tree_leaves(b))) == set(dict(tree_leaves(a)))
    d = tm.init_numpy(4)
    assert not np.array_equal(a["embed"], d["embed"])
    assert np.all(a["final_norm"] == 1)
    wq = a["blocks"]["pos0"]["attn"]["wq"]
    assert wq.dtype == np.float32
    assert abs(wq.std() * np.sqrt(tm.cfg.d_model) - 1) < 0.05
    assert abs(a["embed"].std() / 0.02 - 1) < 0.05
    assert not np.array_equal(wq[0], wq[1])     # each layer its own stream


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,q_offset", [(True, 0), (False, 0),
                                             (True, 40)])
def test_chunked_attention_matches_jax(causal, q_offset):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 72, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 72 + q_offset, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 72 + q_offset, 2, 32)).astype(np.float32)
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                q_offset=q_offset, q_chunk=32, kv_chunk=16)
    got = TL.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               q_offset=q_offset, q_chunk=32, kv_chunk=16)
    _close(got, want, TOL)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_layers_match_jax(cdt):
    rng = np.random.default_rng(2)
    jdt, tdt = jnp.dtype(cdt), getattr(torch, cdt)
    tol = TOL if cdt == "float32" else TOL_BF16
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    _close(TL.rms_norm(tx, torch.from_numpy(g)),
           JL.rms_norm(jx, jnp.asarray(g)), tol)
    h = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(9) + 30])
    _close(TL.apply_rope(torch.from_numpy(h).to(tdt), torch.from_numpy(pos),
                         1e6),
           JL.apply_rope(jnp.asarray(h, jdt), jnp.asarray(pos), 1e6), tol)
    qd = rng.standard_normal((2, 1, 4, 32)).astype(np.float32)
    kc = rng.standard_normal((2, 20, 2, 32)).astype(np.float32)
    vc = rng.standard_normal((2, 20, 2, 32)).astype(np.float32)
    lens = np.array([7, 20], np.int32)
    _close(TL.decode_attention(*(torch.from_numpy(a).to(tdt)
                                 for a in (qd, kc, vc)),
                               torch.from_numpy(lens)),
           JL.decode_attention(*(jnp.asarray(a, jdt) for a in (qd, kc, vc)),
                               jnp.asarray(lens)), tol)
    for arch in ("internlm2-1.8b", "qwen3-32b"):          # qwen3: qk_norm
        jm, tm = _models(arch, cdt)
        p = jax.tree.map(np.asarray, jm.init(5))["blocks"]["pos0"]
        pj = jax.tree.map(lambda a: jnp.asarray(a[0], jdt), p)
        pt = jax.tree.map(lambda a: torch.tensor(a[0]).to(tdt), p)
        xx = rng.standard_normal((2, 5, tm.cfg.d_model)).astype(np.float32)
        pp = np.stack([np.arange(5), np.arange(5) + 11])
        for a, b in zip(TL.attention_qkv(tm.cfg, pt["attn"],
                                         torch.from_numpy(xx).to(tdt),
                                         torch.from_numpy(pp)),
                        JL.attention_qkv(jm.cfg, pj["attn"],
                                         jnp.asarray(xx, jdt),
                                         jnp.asarray(pp))):
            _close(a, b, tol)
        _close(TL.mlp(pt["mlp"], torch.from_numpy(xx).to(tdt)),
               JL.mlp(pj["mlp"], jnp.asarray(xx, jdt)), tol)


# ---------------------------------------------------------------------------
# prefill, decode_step, decode_step_paged
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-32b"])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(weights, arch, cdt):
    jm, tm = _models(arch, cdt)
    npp = weights[arch]
    jp = jax.tree.map(jnp.asarray, npp)
    tp = tm.compute_params(params_from_numpy(npp, device="cpu"))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tm.cfg.vocab, size=(2, 19))
    jl, js = jm.prefill(jp, jnp.asarray(toks, jnp.int32), max_seq=40)
    tl, ts = tm.prefill(tp, torch.from_numpy(toks), max_seq=40)
    _close(tl, jl, LOGIT_TOL[cdt])
    for key in ("k", "v"):
        _close(ts["pos0"][key], js["pos0"][key], LOGIT_TOL[cdt])
    # two dense decode steps continuing the prefilled cache
    for step in range(2):
        nxt = rng.integers(0, tm.cfg.vocab, size=(2, 1))
        lens = np.array([19 + step, 19 + step], np.int32)
        jl, js = jm.decode_step(jp, js, jnp.asarray(nxt, jnp.int32),
                                jnp.asarray(lens))
        tl, ts = tm.decode_step(tp, ts, torch.from_numpy(nxt),
                                torch.from_numpy(lens))
        _close(tl, jl, LOGIT_TOL[cdt])


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_decode_step_paged_matches_jax(weights, cdt):
    """One paged decode step over a pool with mixed contiguity, classes
    K = (2, 1), an inactive slot (block table all -1), and rows whose
    reserved pages run past kv_len: logits and the written pools equal
    the JAX step's, and the inactive slot writes nothing."""
    jm, tm = _models("internlm2-1.8b", cdt)
    npp = weights["internlm2-1.8b"]
    jp = jax.tree.map(jnp.asarray, npp)
    tp = tm.compute_params(params_from_numpy(npp, device="cpu"))
    rng = np.random.default_rng(4)
    cfg, T, n_pages = tm.cfg, 8, 32
    shape = (cfg.n_layers, n_pages, T, cfg.n_kv_heads, cfg.head_dim)
    pool = rng.standard_normal((2,) + shape).astype(np.float32)
    bt = np.array([[4, 5, 6, 7, 12, -1, -1, -1],
                   [16, 17, 18, 19, 20, 21, 22, 23],
                   [-1] * 8], np.int32)
    lens = np.array([35, 41, 0], np.int32)
    toks = rng.integers(0, cfg.vocab, size=(3, 1))
    K = (2, 1)
    desc = build_descriptors(bt, K)
    jdt = jnp.dtype(cdt)
    jstate = {"pos0": {"pool_k": jnp.asarray(pool[0], jdt),
                       "pool_v": jnp.asarray(pool[1], jdt)}}
    tstate = {"pos0": {"pool_k": torch.from_numpy(pool[0]).to(tm.cdt),
                       "pool_v": torch.from_numpy(pool[1]).to(tm.cdt)}}
    before = tstate["pos0"]["pool_k"][:, -1].clone()
    jl, jst = jm.decode_step_paged(jp, jstate, jnp.asarray(toks, jnp.int32),
                                   jnp.asarray(lens), bt, desc,
                                   page_size=T, K_classes=K)
    tl, tst = tm.decode_step_paged(tp, tstate, torch.from_numpy(toks), lens,
                                   bt, desc, page_size=T, K_classes=K)
    _close(tl, jl, LOGIT_TOL[cdt])
    for key in ("pool_k", "pool_v"):
        _close(tst["pos0"][key], jst["pos0"][key], LOGIT_TOL[cdt])
    assert torch.equal(tstate["pos0"]["pool_k"][:, -1], before)


def test_paged_step_equals_dense_step(weights):
    """The paged step and the dense step are one function: the same
    tokens over the same cache contents give the same logits."""
    _, tm = _models("internlm2-1.8b")
    tp = tm.compute_params(params_from_numpy(weights["internlm2-1.8b"],
                                             device="cpu"))
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, tm.cfg.vocab, size=(1, 21)))
    _, dense = tm.prefill(tp, toks, max_seq=32)
    T, n_pages = 8, 16
    cfg = tm.cfg
    shape = (cfg.n_layers, n_pages, T, cfg.n_kv_heads, cfg.head_dim)
    pools = {"pool_k": torch.zeros(shape), "pool_v": torch.zeros(shape)}
    pages = [8, 9, 10, 11]                 # one aligned class-2 window
    for key, pk in (("k", "pool_k"), ("v", "pool_v")):
        pools[pk][:, pages] = dense["pos0"][key][:, 0].reshape(
            cfg.n_layers, 4, T, cfg.n_kv_heads, cfg.head_dim)
    nxt = torch.tensor([[5]])
    bt = np.array([pages], np.int32)
    lp, _ = tm.decode_step_paged(tp, {"pos0": pools}, nxt, [21], bt,
                                 build_descriptors(bt, (2,)), page_size=T,
                                 K_classes=(2,))
    ld, _ = tm.decode_step(tp, dense, nxt, torch.tensor([21]))
    np.testing.assert_allclose(lp.numpy(), ld.numpy(), **TOL)


def test_init_decode_state_shape_matches_jax():
    jm, tm = _models("internlm2-1.8b")
    js = j_init_decode_state(jm.cfg, jm.rc, 2, 24, jnp.float32)
    ts = init_decode_state(tm.cfg, 2, 24, torch.float32, device="cpu")
    assert tuple(ts["pos0"]["k"].shape) == js["pos0"]["k"].shape


@pytest.mark.parametrize("entry", ["params_from_numpy", "init_decode_state"])
def test_weights_and_decode_state_default_to_the_card(entry):
    """Without a ``device`` both helpers put their tensors on the card, as
    every entry point of the port does: with no card they raise instead
    of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    tm = Model(get_config("internlm2-1.8b", reduced=True), RunConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "params_from_numpy":
            params_from_numpy({"w": np.zeros((2, 3), np.float32)})
        else:
            init_decode_state(tm.cfg, 1, 8)


def test_models_import_leaves_jax_out():
    code = ("import sys, repro_torch.models, repro_torch.configs, "
            "repro_torch.kernels.paged_attention, "
            "repro_torch.kernels.flash_attention; "
            "assert 'jax' not in sys.modules; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'imported the JAX package'")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO)
