"""The port's serving engine against the JAX package's, on the CPU.

The workloads of ``tests/test_serve.py`` through both engines on the
reduced InternLM2 with the JAX package's own weights (converted with
``params_from_numpy``), in f32 compute so that no near-tie between the
top two logits can flip a greedy token: every generated token, Algorithm
3's classes ``K`` and every scheduling and descriptor counter must be
equal (tolerance 0).  The port runs on the CPU (``device="cpu"``), where
the paged op takes its plain version.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.models import Model as JModel
from repro.models import RunConfig as JRunConfig
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.models import Model, RunConfig, params_from_numpy
from repro_torch.serve import EngineConfig, ServingEngine

REPO = Path(__file__).resolve().parents[1]
SERVE_REF = REPO / "tests" / "data" / "port_serve_reference.json"
RC = dict(attn_q_chunk=32, attn_kv_chunk=32, scan_chunk=16,
          compute_dtype="float32")
METRICS = ("steps", "tokens", "dma_descriptors",
           "dma_descriptors_page_granular", "preemptions", "stalled",
           "descriptor_reduction", "K")


def _prompts(seed, sizes, vocab=512):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, size=n)] for n in sizes]


#: ``tests/test_serve.py``'s workloads: (engine config, prompts, max_new)
WORKLOADS = {
    "paged_equals_dense": (dict(page_size=8, num_pages=64, max_batch=1,
                                max_seq=64), _prompts(0, [13]), 5),
    "continuous_batching": (dict(page_size=8, num_pages=96, max_batch=2,
                                 max_seq=64),
                            _prompts(1, [10, 13, 16, 19]), 4),
    "descriptor_reduction": (dict(page_size=8, num_pages=128, max_batch=2,
                                  max_seq=128), _prompts(2, [30] * 3), 4),
    "fragmented_pool": (dict(page_size=8, num_pages=64, max_batch=1,
                             max_seq=64, alloc_policy="page"),
                        _prompts(3, [11]), 3),
    "page_boundary": (dict(page_size=8, num_pages=64, max_batch=1,
                           max_seq=64), _prompts(4, [7]), 4),
    "preemption": (dict(page_size=8, num_pages=16, max_batch=3, max_seq=64),
                   _prompts(2024, [45] * 3), 3),
}


@pytest.fixture(scope="module")
def models():
    jm = JModel(j_config("internlm2-1.8b", reduced=True), JRunConfig(**RC))
    tm = Model(get_config("internlm2-1.8b", reduced=True), RunConfig(**RC))
    params = jax.tree.map(np.asarray, jm.init(0))
    return jm, tm, params


def _serve(engine, prompts, max_new):
    for p in prompts:
        engine.add_request(p, max_new_tokens=max_new)
    m = engine.run_to_completion()
    return ([engine.requests[i].generated for i in range(len(prompts))],
            {k: m[k] for k in METRICS})


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_engine_matches_jax(models, workload):
    jm, tm, params = models
    ec, prompts, max_new = WORKLOADS[workload]
    want = _serve(JServingEngine(jm, jax.tree.map(jax.numpy.asarray, params),
                                 JEngineConfig(**ec, interpret=True)),
                  prompts, max_new)
    got = _serve(ServingEngine(tm, params_from_numpy(params),
                               EngineConfig(**ec), device="cpu"),
                 prompts, max_new)
    assert got == want
    if workload == "preemption":
        assert got[1]["preemptions"] >= 1
    if workload == "descriptor_reduction":
        assert got[1]["descriptor_reduction"] > 0.3


def test_engine_defaults_to_the_card():
    tm = Model(get_config("internlm2-1.8b", reduced=True), RunConfig(**RC))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(tm, params_from_numpy(tm.init_numpy(0)),
                      EngineConfig())


def test_add_request_rejects_what_can_never_be_served(models):
    _, tm, params = models
    eng = ServingEngine(tm, params_from_numpy(params), EngineConfig(
        page_size=8, num_pages=4, max_batch=1, max_seq=64), device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        eng.add_request([1] * 60, max_new_tokens=5)
    with pytest.raises(ValueError, match="pool"):
        eng.add_request([1] * 40, max_new_tokens=5)
    assert not eng.requests


def test_quarantine_recomputes_token_exactly(models):
    """Poisoning a live request's KV pages and quarantining them preempts
    it; re-prefill rebuilds its KV elsewhere and it finishes with the
    fault-free tokens; the retired pages leave the pool."""
    _, tm, params = models
    tp = params_from_numpy(params)
    ec = EngineConfig(page_size=8, num_pages=32, max_batch=2, max_seq=64)
    prompts, max_new = _prompts(9, [20, 12]), 5
    clean, _ = _serve(ServingEngine(tm, tp, ec, device="cpu"), prompts,
                      max_new)
    eng = ServingEngine(tm, tp, ec, device="cpu")
    for p in prompts:
        eng.add_request(p, max_new_tokens=max_new)
    eng.step()
    eng.step()
    bad = list(eng.allocator.seqs[0].pages[:2])
    for key in ("pool_k", "pool_v"):
        eng.state["pos0"][key][:, bad] = 1e4
    assert eng.quarantine_pages(bad) == [0]
    m = eng.run_to_completion()
    assert [eng.requests[i].generated for i in range(2)] == clean
    assert m["kv_quarantined_pages"] == 2 and m["stalled"] == 0
    assert eng.allocator.utilization() > 0          # retired pages held


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_dense_check_on_the_cpu(models):
    """``chip_smoke.dense_check`` (phase S3's check of the engine against
    the dense-cache decode) passes on a real run and catches a wrong
    token."""
    cs = _chip_smoke()
    _, tm, params = models
    tp = tm.compute_params(params_from_numpy(params))
    prompts = _prompts(5, [9, 21, 14])
    eng = ServingEngine(tm, tp, EngineConfig(page_size=8, num_pages=64,
                                             max_batch=2, max_seq=64),
                        device="cpu")
    for p in prompts:
        eng.add_request(p, max_new_tokens=4)
    eng.run_to_completion()
    reqs = [eng.requests[i] for i in range(3)]
    res = cs.dense_check(tm, tp, reqs, torch.device("cpu"), margin=1e-3)
    assert res["checked"] == 12 and res["equal"] == 12
    reqs[1] = dataclasses.replace(reqs[1], generated=list(reqs[1].generated))
    reqs[1].generated[2] = (reqs[1].generated[2] + 1) % 512
    with pytest.raises(ValueError, match="request 1"):
        cs.dense_check(tm, tp, reqs, torch.device("cpu"), margin=1e-3)


def test_chip_smoke_s3_requests_follow_the_trace_medians():
    """Phase S3's requests: the same from one seed, each within the
    engine's ``max_seq`` and pool, lengths log-normal around the
    conversation trace's medians (checked on a large draw) and clipped."""
    cs = _chip_smoke()
    reqs = cs.s3_requests(1000)
    assert reqs == cs.s3_requests(1000) and len(reqs) == cs.S3_REQUESTS
    eng = cs.S3_ENGINE
    for prompt, n_new in reqs:
        assert len(prompt) + n_new <= eng["max_seq"]
        assert -(-(len(prompt) + n_new) // eng["page_size"]) \
            <= eng["num_pages"]
        assert all(0 <= t < 1000 for t in prompt)
    big = cs.s3_requests(2, n=4000, seed=1)
    plen = np.array([len(p) for p, _ in big])
    olen = np.array([n for _, n in big])
    for x, d in ((plen, cs.S3_PROMPT), (olen, cs.S3_OUTPUT)):
        assert abs(np.median(x) / d["median"] - 1) < 0.1
        assert x.min() >= d["lo"] and x.max() <= d["hi"]
        assert np.mean(x) > np.median(x)                  # a heavy right tail


def test_chip_smoke_paged_bound_counts_live_tokens():
    """``chip_smoke.paged_bound`` charges the K/V of live tokens only: every
    token before a row's kv_len lies in exactly one covered window, and
    the pages reserved past it are not charged."""
    from repro_torch.kernels.paged_attention import build_descriptors
    from repro_torch.kvcache import PagedKVAllocator
    cs = _chip_smoke()
    T, B, H, KVH, D = 16, 3, 4, 2, 8
    alloc = PagedKVAllocator(64, max_order=5)
    lens = np.array([37, 100, 0], np.int32)
    for b, L in enumerate(lens[:2]):
        alloc.allocate(b, -(-int(L) // T) + 3)      # reserved past kv_len
    bt = np.stack([alloc.block_table(b, 16) for b in range(2)]
                  + [np.full(16, -1, np.int32)])
    K = (2, 1)
    desc = build_descriptors(bt, K)
    classes = (2, 1, 0)
    live = cs.live_tokens(desc, classes, lens, T)
    slots = sum(int(desc[k][1].astype(bool).sum()) * (1 << k) * T
                for k in classes)
    assert live == int(lens.sum()) < slots
    ms, by, n_bytes, flops, t_b, t_o = cs.paged_bound(
        desc, classes, lens, B, H, KVH, D, T, 2)
    assert n_bytes == (2 * live * KVH * D * 2 + B * H * D * 2
                       + 3 * (B * H * D * 4 + 2 * B * H * 4))
    assert flops == 4 * live * H * D and by == "bytes" and ms == t_b


def test_serve_fixture_is_consistent():
    """The committed full-width fixture records what ``chip_smoke.py``
    checks: two requests, every generated token's top-8 logits, the
    classes and descriptor counts of Algorithm 3."""
    ref = json.loads(SERVE_REF.read_text())
    cs = _chip_smoke()
    assert ref["arch"] == cs.SERVE_ARCH and ref["weight_seed"] == 0
    n_tok = sum(len(r["generated"]) for r in ref["requests"])
    assert len(ref["logits"]) == n_tok == 8
    for rec in ref["logits"]:
        req = ref["requests"][rec["request"]]
        assert req["generated"][rec["index"]] == rec["top_ids"][0]
        assert rec["top_logits"] == sorted(rec["top_logits"], reverse=True)
    assert ref["K"] == [2, 1] and 0 < ref["descriptor_reduction"] < 1


def test_serve_imports_leave_jax_out():
    code = ("import sys, repro_torch.serve, repro_torch.kvcache; "
            "assert 'jax' not in sys.modules; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'imported the JAX package'")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(REPO))


@pytest.mark.slow
def test_serve_fixture_regenerates():
    """The JAX package still produces the committed full-width fixture
    (about 40 s of JAX on the CPU, ~13 GB)."""
    spec = importlib.util.spec_from_file_location(
        "make_port_serve_reference",
        REPO / "scripts" / "make_port_serve_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh, _ = mod.reference()
    assert json.loads(json.dumps(fresh)) == json.loads(SERVE_REF.read_text())


@pytest.mark.slow
def test_port_matches_serve_fixture_on_the_cpu():
    """``chip_smoke.py``'s phase S2 on the CPU: the port's engine at full
    width (f32) equals the JAX fixture within the stated tolerance."""
    cs = _chip_smoke()
    res = cs.serve_against_fixture(json.loads(SERVE_REF.read_text()),
                                   torch.device("cpu"))
    assert res["max_abs_err"] <= cs.LOGIT_ATOL
