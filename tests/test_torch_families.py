"""The port's MoE, hybrid (Mamba + attention) and xLSTM families against
the JAX package's, on the CPU.

The same numpy weights (the port's seeded ``init_params_numpy``, handed to
both packages) and the same tokens through ``repro.models`` /
``repro.serve`` and ``repro_torch.models`` / ``repro_torch.serve``, at the
configs' reduced sizes, in f32 compute.  Tolerance: ``atol = rtol = 1e-4``
(``tests/test_recurrent.py``'s): the same f32 arithmetic, summed in
another order (the Mamba scan in another tree order than
``jax.lax.associative_scan``, the mLSTM prefill in its chunkwise form);
integers (dispatch slots, tokens, classes, descriptor counts) exactly.
"""
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.models import Model as JModel
from repro.models import RunConfig as JRunConfig
from repro.models import init_decode_state as j_init_decode_state
from repro.models import mamba as JM
from repro.models import moe as JMoE
from repro.models import xlstm as JX
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention.ops import build_descriptors
from repro_torch.models import (Model, RunConfig, decode_state_shapes,
                                init_decode_state, init_params_on_device,
                                params_from_numpy)
from repro_torch.models import mamba as TM
from repro_torch.models import moe as TMoE
from repro_torch.models import xlstm as TX
from repro_torch.models.common import init_params_numpy, tree_leaves
from repro_torch.serve import EngineConfig, ServingEngine

TOL = dict(atol=1e-4, rtol=1e-4)
RC = dict(attn_q_chunk=32, attn_kv_chunk=32, scan_chunk=16,
          compute_dtype="float32")
MOE_ARCHS = ("qwen2-moe-a2.7b", "granite-moe-3b-a800m")
ARCHS = MOE_ARCHS + ("jamba-1.5-large-398b", "xlstm-350m")
REPO = Path(__file__).resolve().parents[1]
FAMILY_REF = REPO / "tests" / "data" / "port_family_reference.json"


def _models(arch, **rc):
    kw = dict(RC, **rc)
    return (JModel(j_config(arch, reduced=True), JRunConfig(**kw)),
            Model(get_config(arch, reduced=True), RunConfig(**kw)))


@pytest.fixture(scope="module")
def weights():
    """The port's seeded draw of each reduced model, as numpy."""
    return {arch: _models(arch)[1].init_numpy(0)
            for arch in ARCHS + ("internlm2-1.8b",)}


def _both(npp, tm):
    return (jax.tree.map(jnp.asarray, npp),
            tm.compute_params(params_from_numpy(npp, device="cpu")))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _close_states(ts, js, prefix=None):
    """Every leaf of the port's decode state against the JAX one's, KV
    caches over their first ``prefix`` positions."""
    assert sorted(ts) == sorted(js)
    for pos in js:
        assert sorted(ts[pos]) == sorted(js[pos]), pos
        for key, want in js[pos].items():
            got = ts[pos][key]
            want = np.asarray(want, np.float32)
            if key in ("k", "v") and prefix is not None:
                got, want = got[:, :, :prefix], want[:, :, :prefix]
            _close(got, want)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,cap", [(8, 5), (4, 2), (60, 4), (16, 1)])
def test_dispatch_indices_match_jax(E, cap):
    rng = np.random.default_rng(E * 100 + cap)
    ids = rng.integers(0, E, size=(3, 48)).astype(np.int32)
    want = jax.vmap(lambda e: JMoE._dispatch_indices(e, E, cap))(
        jnp.asarray(ids))
    got = TMoE._dispatch_indices(torch.from_numpy(ids), E, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    one = TMoE._dispatch_indices(torch.from_numpy(ids[0]), E, cap)
    np.testing.assert_array_equal(one[0].numpy(), got[0][0].numpy())


@pytest.mark.parametrize("cf", [1.25, 8.0, 1e-9])   # default, high, zero
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_jax(arch, cf):
    cfg = get_config(arch, reduced=True)
    rc, jrc = RunConfig(capacity_factor=cf), JRunConfig(capacity_factor=cf)
    p = init_params_numpy(TMoE.moe_specs(cfg, rc), seed=2)
    x = np.random.default_rng(3).standard_normal(
        (3, 23, cfg.d_model)).astype(np.float32)
    jy, ja = JMoE.moe_ffn(j_config(arch, reduced=True), jrc,
                          jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    ty, ta = TMoE.moe_ffn(cfg, rc, jax.tree.map(torch.from_numpy, p),
                          torch.from_numpy(x))
    _close(ty, jy)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    assert TMoE.capacity_of(cfg, rc, 23) == max(
        int(np.ceil(23 * cfg.top_k * cf / cfg.n_experts)), 4)


def test_moe_top_k_breaks_ties_to_the_lower_index():
    """A router whose columns repeat gives every token tied probabilities:
    the experts taken must be the lowest indices, as ``jax.lax.top_k``
    takes them."""
    cfg = get_config("qwen2-moe-a2.7b", reduced=True)
    rc = RunConfig()
    p = init_params_numpy(TMoE.moe_specs(cfg, rc), seed=4)
    p["router"][:, 4:] = p["router"][:, :4]       # experts e and e + 4 tie
    x = np.random.default_rng(5).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    jy, _ = JMoE.moe_ffn(j_config("qwen2-moe-a2.7b", reduced=True),
                         JRunConfig(), jax.tree.map(jnp.asarray, p),
                         jnp.asarray(x))
    ty, _ = TMoE.moe_ffn(cfg, rc, jax.tree.map(torch.from_numpy, p),
                         torch.from_numpy(x))
    _close(ty, jy)


# ---------------------------------------------------------------------------
# recurrent layers
# ---------------------------------------------------------------------------

_LAYERS = {
    "mamba": ("jamba-1.5-large-398b", TM.mamba_specs, JM.mamba_layer,
              TM.mamba_layer, lambda *a: a, lambda *a: a),
    "mlstm": ("xlstm-350m", TX.mlstm_specs, JX.mlstm_layer, TX.mlstm_layer,
              JX.MLSTMState, TX.MLSTMState),
    "slstm": ("xlstm-350m", TX.slstm_specs, JX.slstm_layer, TX.slstm_layer,
              JX.SLSTMState, TX.SLSTMState),
}


@pytest.mark.parametrize("S", [1, 37])
@pytest.mark.parametrize("kind", sorted(_LAYERS))
def test_recurrent_layer_matches_jax(kind, S):
    """Prefill of S tokens from zero state (S = 37: two chunks of 16 and a
    padded third), its state, then two decode steps from that state."""
    arch, specs, jf, tf, jst, tst = _LAYERS[kind]
    cfg = get_config(arch, reduced=True)
    p = init_params_numpy(specs(cfg), seed=1)
    jp, tp = jax.tree.map(jnp.asarray, p), jax.tree.map(torch.from_numpy, p)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jo, js = jf(j_config(arch, reduced=True), jp, jnp.asarray(x),
                scan_chunk=16, return_state=True)
    to, ts = tf(cfg, tp, torch.from_numpy(x), scan_chunk=16,
                return_state=True)
    _close(to, jo)
    for a, b in zip(ts, js):
        _close(a, b)
    for _ in range(2):
        x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jo, js = jf(j_config(arch, reduced=True), jp, jnp.asarray(x1),
                    state=jst(*js), return_state=True)
        to, ts = tf(cfg, tp, torch.from_numpy(x1), state=tst(*ts),
                    return_state=True)
        _close(to, jo)
        for a, b in zip(ts, js):
            _close(a, b)


# ---------------------------------------------------------------------------
# specs, decode state, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_matches_jax(arch):
    """Keys, shapes, dtypes and the -1e30 stabilisers of the zero state."""
    jm, tm = _models(arch)
    js = j_init_decode_state(jm.cfg, jm.rc, 3, 24, jnp.bfloat16)
    ts = init_decode_state(tm.cfg, 3, 24, torch.bfloat16, device="cpu")
    shapes = decode_state_shapes(tm.cfg, 3, 24, torch.bfloat16)
    assert sorted(ts) == sorted(js) == sorted(shapes)
    for pos in js:
        assert sorted(ts[pos]) == sorted(js[pos]) == sorted(shapes[pos])
        for key, want in js[pos].items():
            got = ts[pos][key]
            assert tuple(got.shape) == want.shape == shapes[pos][key][0]
            assert str(got.dtype).replace("torch.", "") == str(want.dtype)
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_on_device_streams_the_numpy_draw(arch, weights):
    """The streaming initialiser equals the numpy draw leaf for leaf, in
    f32 and cast to bf16."""
    tm = _models(arch)[1]
    want = dict(tree_leaves(weights[arch]))
    for dt in (torch.float32, torch.bfloat16):
        got = init_params_on_device(tm.specs(), seed=0, dtype=dt,
                                    device="cpu", workers=3)
        leaves = dict(tree_leaves(got))
        assert sorted(leaves) == sorted(want)
        for path, a in leaves.items():
            assert a.dtype == dt
            assert torch.equal(a, torch.from_numpy(want[path]).to(dt)), path


# ---------------------------------------------------------------------------
# whole models: prefill, decode_step, decode_step_paged, prefill_chunked
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(weights, arch):
    """Prefill of 19 tokens (logits and every state), then two dense
    decode steps continuing it."""
    jm, tm = _models(arch)
    jp, tp = _both(weights[arch], tm)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tm.cfg.vocab, size=(2, 19))
    jl, js = jm.prefill(jp, jnp.asarray(toks, jnp.int32), max_seq=40)
    tl, ts = tm.prefill(tp, torch.from_numpy(toks), max_seq=40)
    _close(tl, jl)
    _close_states(ts, js)
    for step in range(2):
        nxt = rng.integers(0, tm.cfg.vocab, size=(2, 1))
        lens = np.array([19 + step, 19 + step], np.int32)
        jl, js = jm.decode_step(jp, js, jnp.asarray(nxt, jnp.int32),
                                jnp.asarray(lens))
        tl, ts = tm.decode_step(tp, ts, torch.from_numpy(nxt),
                                torch.from_numpy(lens))
        _close(tl, jl)
        _close_states(ts, js)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_paged_matches_jax(weights, arch):
    """One paged step: random pools at the attention positions under
    classes K = (2, 1), recurrent states from a prefill (the port's, handed
    to both), an inactive slot (block table all -1): logits and every new
    state equal the JAX step's, and the inactive slot writes no K/V."""
    jm, tm = _models(arch)
    jp, tp = _both(weights[arch], tm)
    rng = np.random.default_rng(4)
    cfg, T, n_pages = tm.cfg, 8, 32
    toks = rng.integers(0, cfg.vocab, size=(3, 11))
    _, tpre = tm.prefill(tp, torch.from_numpy(toks))
    # copies: the port's step updates its state in place, and a JAX array
    # made from a numpy view may share that buffer
    jpre = jax.tree.map(lambda a: jnp.array(a.numpy(), copy=True), tpre)
    nsb = cfg.n_layers // len(jpre)
    shape = (nsb, n_pages, T, cfg.n_kv_heads, cfg.head_dim)
    jstate, tstate = {}, {}
    for pos in jpre:
        if "k" in jpre[pos]:
            pool = rng.standard_normal((2,) + shape).astype(np.float32)
            jstate[pos] = {"pool_k": jnp.asarray(pool[0]),
                           "pool_v": jnp.asarray(pool[1])}
            tstate[pos] = {"pool_k": torch.from_numpy(pool[0].copy()),
                           "pool_v": torch.from_numpy(pool[1].copy())}
        else:
            jstate[pos] = jpre[pos]
            tstate[pos] = tpre[pos]
    bt = np.array([[4, 5, 6, 7, 12, -1, -1, -1],
                   [16, 17, 18, 19, 20, 21, 22, 23],
                   [-1] * 8], np.int32)
    lens = np.array([35, 41, 0], np.int32)
    nxt = rng.integers(0, cfg.vocab, size=(3, 1))
    K = (2, 1)
    desc = build_descriptors(bt, K)
    last = {pos: st["pool_k"][:, -1].clone() for pos, st in tstate.items()
            if "pool_k" in st}
    jl, jst = jm.decode_step_paged(jp, jstate, jnp.asarray(nxt, jnp.int32),
                                   jnp.asarray(lens), bt, desc,
                                   page_size=T, K_classes=K)
    tl, tst = tm.decode_step_paged(tp, tstate, torch.from_numpy(nxt), lens,
                                   bt, desc, page_size=T, K_classes=K)
    _close(tl, jl)
    _close_states(tst, jst)
    for pos, before in last.items():
        assert torch.equal(tst[pos]["pool_k"][:, -1], before)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "jamba-1.5-large-398b",
                                  "xlstm-350m"])
def test_prefill_chunked_matches_jax(weights, arch):
    """Two chunks of 18 tokens (each over two scan chunks of 16, the second
    padded) at the default capacity factor (each chunk's MoE dispatch
    drops tokens by its own capacity) against JAX's own
    ``prefill_chunked``: logits and the state after the last chunk."""
    jm, tm = _models(arch)
    jp, tp = _both(weights[arch], tm)
    toks = np.random.default_rng(8).integers(0, tm.cfg.vocab, size=(2, 36))
    jl, js = jm.prefill_chunked(jp, jnp.asarray(toks, jnp.int32),
                                n_chunks=2, max_seq=40)
    tl, ts = tm.prefill_chunked(tp, torch.from_numpy(toks), n_chunks=2,
                                max_seq=40)
    _close(tl, jl)
    _close_states(ts, js)
    with pytest.raises(ValueError, match="chunks"):
        tm.prefill_chunked(tp, torch.from_numpy(toks), n_chunks=5)


def test_prefill_chunked_of_one_chunk_is_prefill(weights):
    _, tm = _models("jamba-1.5-large-398b")
    tp = tm.compute_params(params_from_numpy(
        weights["jamba-1.5-large-398b"], device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, tm.cfg.vocab, size=(1, 24)))
    la, sa = tm.prefill(tp, toks)
    lb, sb = tm.prefill_chunked(tp, toks, n_chunks=1)
    assert torch.equal(la, lb)
    for pos in sa:
        for key in sa[pos]:
            assert torch.equal(sa[pos][key], sb[pos][key]), (pos, key)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ENGINE = dict(page_size=8, num_pages=64, max_batch=2, max_seq=64)
METRICS = ("steps", "tokens", "dma_descriptors",
           "dma_descriptors_page_granular", "preemptions", "stalled",
           "descriptor_reduction", "K")


@pytest.mark.parametrize("arch", ["xlstm-350m"])
def test_engine_matches_jax(weights, arch):
    """Three requests through two slots (a slot is reused, so its
    recurrent state must be overwritten at prefill): every token, K and
    every counter equal the JAX engine's, live, and the xLSTM engine
    serves with no pool.  (Two new tokens each: the JAX engine traces
    every step anew.  The fixture test below holds the MoE and hybrid
    engines, four new tokens each, to the JAX engine's recorded run.)"""
    jm, tm = _models(arch)
    rng = np.random.default_rng(10)
    prompts = [[int(t) for t in rng.integers(0, tm.cfg.vocab, size=n)]
               for n in (13, 21, 9)]
    out = []
    for eng in (JServingEngine(jm, jax.tree.map(jnp.asarray, weights[arch]),
                               JEngineConfig(**ENGINE)),
                ServingEngine(tm, params_from_numpy(weights[arch], "cpu"),
                              EngineConfig(**ENGINE), device="cpu")):
        for p in prompts:
            eng.add_request(p, max_new_tokens=2)
        m = eng.run_to_completion()
        out.append(([eng.requests[i].generated for i in range(3)],
                    {k: m[k] for k in METRICS}))
    assert out[1] == out[0]
    if arch == "xlstm-350m":
        assert not any("pool_k" in st for st in eng.state.values())


# ---------------------------------------------------------------------------
# the M1 fixture (chip_smoke.py holds the card to it)
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-1.5-large-398b",
                                  "xlstm-350m"])
def test_port_engine_matches_family_fixture_on_the_cpu(arch):
    """``chip_smoke.py``'s phase M1 on the CPU: the port's engine over the
    fixture's three requests (four new tokens each, a slot reused) equals
    the JAX engine's recorded tokens, logits (within ``LOGIT_ATOL``),
    classes and descriptor counts; a changed token is caught."""
    cs = _chip_smoke()
    rec = json.loads(FAMILY_REF.read_text())["models"][arch]
    res = cs.serve_against_fixture(rec, torch.device("cpu"))
    assert res["max_abs_err"] <= 1e-4 and res["prefills"] == 3
    assert res["tokens_total"] == 12 and not res["diverged"]
    assert res["generated"] == [r["generated"] for r in rec["requests"]]
    # the token with the widest top-2 gap, changed, must be caught
    wide = max(rec["logits"], key=lambda r: r["top_logits"][0]
               - r["top_logits"][1])
    rec["requests"][wide["request"]]["generated"][wide["index"]] += 1
    with pytest.raises(ValueError, match=f"request {wide['request']} token "
                       f"{wide['index']}"):
        cs.serve_against_fixture(rec, torch.device("cpu"),
                                 params=res["params"])


def test_family_fixture_is_consistent():
    ref = json.loads(FAMILY_REF.read_text())
    assert sorted(ref["models"]) == sorted(
        ("qwen2-moe-a2.7b", "jamba-1.5-large-398b", "xlstm-350m"))
    for arch, rec in ref["models"].items():
        assert rec["compute_dtype"] == "float32"
        n = len(rec["requests"])
        assert 2 <= n <= 3
        for r in rec["requests"]:
            assert 20 <= len(r["prompt"]) <= 60
            assert len(r["generated"]) == r["max_new_tokens"] == 4
        assert len(rec["logits"]) == 4 * n
        assert rec["stalled"] == 0


@pytest.mark.slow
def test_family_fixture_regenerates():
    """The JAX package still produces the committed fixture (about a
    minute of JAX on the CPU)."""
    spec = importlib.util.spec_from_file_location(
        "make_port_family_reference",
        REPO / "scripts" / "make_port_family_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert json.loads(mod.dumps(mod.reference())) == json.loads(
        FAMILY_REF.read_text())


def test_chip_smoke_batched_dense_check_on_the_cpu(weights):
    """The M2/M3 token check: the engine's bf16 tokens against the dense
    decode of ``chip_smoke.yardstick``, rows batched as the engine ran
    them: every token of the reduced xLSTM equal, and a changed token
    caught."""
    import dataclasses
    cs = _chip_smoke()
    tm = Model(get_config("xlstm-350m", reduced=True),
               RunConfig(param_dtype="bfloat16"))
    params = tm.init_on_device(0, "cpu")
    eng = ServingEngine(tm, params, EngineConfig(**ENGINE), device="cpu")
    rng = np.random.default_rng(12)
    for n, new in ((17, 6), (30, 4), (9, 6)):
        eng.add_request([int(t) for t in rng.integers(0, 512, size=n)],
                        max_new_tokens=new)
    eng.run_to_completion()
    reqs = [eng.requests[i] for i in range(3)]
    res = cs.dense_check(cs.yardstick(tm), eng.params, reqs,
                         torch.device("cpu"), 1e-3, batched=True)
    assert res["checked"] == 16 and res["equal"] == 16
    reqs[2] = dataclasses.replace(reqs[2], generated=list(reqs[2].generated))
    reqs[2].generated[3] = (reqs[2].generated[3] + 1) % 512
    with pytest.raises(ValueError, match="request 2: token 3"):
        cs.dense_check(tm, eng.params, reqs, torch.device("cpu"), 1e-3,
                       batched=True)


def test_chip_smoke_yardstick_keeps_p_in_f32(weights):
    """``chip_smoke.yardstick``'s decode step is ``Model.decode_step`` with
    the softmax weights kept in f32: bit for bit where the cache is f32
    (nothing to round), and not where the cache is bf16 (the model
    rounds p to bf16 there)."""
    cs = _chip_smoke()
    arch = "jamba-1.5-large-398b"
    out = {}
    for cdt in ("float32", "bfloat16"):
        _, tm = _models(arch, compute_dtype=cdt)
        tp = tm.compute_params(params_from_numpy(weights[arch], "cpu"))
        toks = torch.from_numpy(np.random.default_rng(13).integers(
            0, tm.cfg.vocab, size=(2, 20)))
        for name, m in (("model", tm), ("yardstick", cs.yardstick(tm))):
            _, st = m.prefill(tp, toks, max_seq=24)
            out[cdt, name] = m.decode_step(
                tp, st, toks[:, -1:], torch.tensor([20, 20]))[0].float()
    assert torch.equal(out["float32", "model"], out["float32", "yardstick"])
    assert not torch.equal(out["bfloat16", "model"],
                           out["bfloat16", "yardstick"])


def test_chip_smoke_route_tape_replays_the_engine_routings(weights):
    """M2's route tape on the CPU: a reduced MoE model's engine run with a
    recording ``yardstick`` gives the plain engine's tokens, and the dense
    check replays every decode-time routing (one call per MoE layer and
    step) with every token equal."""
    cs = _chip_smoke()
    arch = "qwen2-moe-a2.7b"
    _, tm = _models(arch)
    params = params_from_numpy(weights[arch], "cpu")
    prompts = [[int(t) for t in np.random.default_rng(14).integers(
        0, tm.cfg.vocab, size=n)] for n in (11, 19)]
    tape = cs.RouteTape()
    runs = []
    for model in (tm, cs.yardstick(tm, tape)):
        eng = ServingEngine(model, params, EngineConfig(**ENGINE),
                            device="cpu")
        for p in prompts:
            eng.add_request(p, max_new_tokens=4)
        eng.run_to_completion()
        runs.append([eng.requests[i] for i in range(2)])
    assert [r.generated for r in runs[0]] == [r.generated for r in runs[1]]
    n_moe = sum(tm.cfg.is_moe_layer(j) for j in range(tm.cfg.n_layers))
    assert len(tape.ids) == 3 * n_moe        # decode steps 2..4 of each
    tape.replay = True
    res = cs.dense_check(cs.yardstick(tm, tape), params, runs[1],
                         torch.device("cpu"), 1e-3, batched=True)
    assert res["checked"] == res["equal"] == 8
    assert tape.pos == len(tape.ids) and tape.flips == 0
