"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test takes the ``cuda`` fixture, which skips when
``torch.cuda.is_available()`` is False (decided in the fixture, never at
import, so every xdist worker collects the same tests).  On a machine with
a card run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The TLB-sweep kernel must equal the plain version bit for bit — counters,
coverage samples and the whole ``[L, T]`` ppn array — on static, dynamic,
multi-tenant, nested and parity-fault batches covering all 10 method kinds
and every policy knob and on ``chip_smoke.edge_batches``, count one launch
per batch, report every lane's cycles, and refuse L2s wider than a warp;
``run_sweep``, ``run_method`` and ``standard_suite`` on the card launch it
and equal the oracle and the CPU on the fuzz twin's random worlds.  The
paged-attention kernels must equal their plain version per class pass
(o, m, l) and merged, f32 within 5e-5 and bf16 within 2e-2, at any split
of a row's windows over blocks, keep the -1e30 semantics of wholly masked
windows, refuse a window index outside the pool, and serve the reduced
InternLM2 token for token like the CPU; ``run_sweep``'s recovery ladder
must recover an injected launch failure by bisection and a cursed cell by
the oracle, and an engine's bf16 pools must round-trip a snapshot.  The
flash kernels must equal their plain version (bf16 also within one bf16
ulp), give the same bits twice and from strided views, and refuse rows
off 16-byte boundaries; at a query offset (the later chunks of a chunked
prefill) they must equal their plain version and, causal, the whole
call's rows bit for bit.  The
reduced MoE, hybrid and xLSTM models must prefill, prefill in chunks and
decode on the card as on the CPU, and serve as the JAX engine's fixture
records.  On an NCCL group of one rank, the reduced InternLM2's sharded
train step (parameters and optimizer state as DTensors) must equal the
unsharded step bit for bit per optimizer kind, and a sharded trainer's
checkpoint must restore into an unsharded trainer, and the reverse, bit
for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from _torch_helpers import WORLDS, pkg, world_cells
from repro_torch.core.lane_program import needs_switch_pass
from repro_torch.core.sweep import batches_of, pack_batch, run_sweep
from repro_torch.kernels.tlb_sweep import LAUNCHES, run_lanes, run_lanes_ref
from repro_torch.kernels.tlb_sweep.ops import as_tensors

pytestmark = pytest.mark.cuda

P = pkg(tcore)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _kernel_vs_plain(cells, dev):
    switched = False
    for group in batches_of(cells, range(len(cells))):
        lanes, stacks, st0, sb = pack_batch([cells[i] for i in group])
        switched |= needs_switch_pass(lanes)
        lt, stt, s0t = as_tensors(lanes, stacks, st0, dev)
        n0 = LAUNCHES["tlb_sweep"]
        k_st, k_pp = run_lanes(lt, stt, s0t, sb)
        torch.cuda.synchronize()
        assert LAUNCHES["tlb_sweep"] == n0 + 1
        r_st, r_pp = run_lanes_ref(lt, stt, s0t, sb)
        assert LAUNCHES["tlb_sweep"] == n0 + 1     # plain runs not counted
        for key in ("counters", "cov_samples"):
            np.testing.assert_array_equal(k_st[key].cpu().numpy(),
                                          r_st[key].cpu().numpy(), key)
        np.testing.assert_array_equal(k_pp.cpu().numpy(), r_pp.cpu().numpy())
    return switched


@pytest.mark.parametrize("world", WORLDS)
def test_kernel_matches_plain(cuda, world):
    switched = _kernel_vs_plain(world_cells(P, world), cuda)
    # the multi-tenant batch compiles and runs the switch template
    assert switched == (world in ("multitenant", "nested"))


def test_run_sweep_on_card_translates_every_access(cuda):
    cells = world_cells(P, "static")
    n0 = LAUNCHES["tlb_sweep"]
    res = run_sweep(cells, cache=False, device="cuda")
    assert LAUNCHES["tlb_sweep"] == n0 + 1
    m, tr = cells[0].mapping, cells[0].trace
    for r in res:
        np.testing.assert_array_equal(r.ppn, np.asarray(m.ppn)[tr])
        assert (r.l1_hits + r.l2_regular_hits + r.l2_coalesced_hits
                + r.walks) == r.accesses


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EDGE_BATCHES = ("chain", "short-lanes", "small-l2")


@pytest.mark.parametrize("name", EDGE_BATCHES)
def test_kernel_edge_batches_match_plain(cuda, name):
    """``chip_smoke.edge_batches``: unusual probe orders, t_real = 0,
    short lanes before a later shootdown, padded ways — bit for bit, and
    every lane's block reports its cycles."""
    from repro_torch.core.sweep import SweepCell
    from repro_torch.kernels.tlb_sweep.ops import prepare_cuda
    edges = _chip_smoke().edge_batches(tcore, SweepCell, np)
    assert tuple(edges) == EDGE_BATCHES
    lanes, stacks, st0, sb = edges[name]
    lt, stt, s0t = as_tensors(lanes, stacks, st0, cuda)
    prep = prepare_cuda(lt, stt, s0t, sb)
    k_st, k_pp = prep()
    torch.cuda.synchronize()
    r_st, r_pp = run_lanes_ref(lt, stt, s0t, sb)
    for key in ("counters", "cov_samples"):
        np.testing.assert_array_equal(k_st[key].cpu().numpy(),
                                      r_st[key].cpu().numpy(), key)
    np.testing.assert_array_equal(k_pp.cpu().numpy(), r_pp.cpu().numpy())
    cyc = prep.cycles.cpu().numpy()
    assert cyc.shape == (lanes["t_real"].size,) and (cyc > 0).all()


def test_kernel_refuses_more_ways_than_a_warp(cuda):
    """One way per thread of a warp: 32 L2 ways run, 33 are refused with
    the reason."""
    cells = world_cells(P, "static")[:2]
    for ways in (32, 33):
        cs = [dataclasses.replace(c, spec=dataclasses.replace(
            c.spec, l2_ways=ways)) for c in cells]
        lanes, stacks, st0, sb = pack_batch(cs)
        lt, stt, s0t = as_tensors(lanes, stacks, st0, cuda)
        if ways == 32:
            k_st, k_pp = run_lanes(lt, stt, s0t, sb)
            r_st, r_pp = run_lanes_ref(lt, stt, s0t, sb)
            assert torch.equal(k_pp.cpu(), r_pp.cpu())
            assert torch.equal(k_st["counters"].cpu(),
                               r_st["counters"].cpu())
        else:
            with pytest.raises(ValueError,
                               match=r"L2 ways \(33\) must be at most 32"):
                run_lanes(lt, stt, s0t, sb)


def test_round_cycles_is_a_shared_memory_latency(cuda):
    """The chain floor's round: a dependent shared-memory load, compare
    and store take tens of cycles, not one and not thousands."""
    from repro_torch.kernels.tlb_sweep.ops import round_cycles
    assert 10 < round_cycles(cuda) < 500


def test_kernel_rejects_out_of_range_trace(cuda):
    cells = world_cells(P, "static")[:2]
    lanes, stacks, st0, sb = pack_batch(cells)
    stacks = dict(stacks, trace=stacks["trace"].copy())
    stacks["trace"][0, 5] = stacks["maps"].shape[1]        # vpn == P
    lt, stt, s0t = as_tensors(lanes, stacks, st0, cuda)
    with pytest.raises(ValueError, match="trace vpn"):
        run_lanes(lt, stt, s0t, sb)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("world_kind", ("dynamic", "multitenant", "nested"))
def test_fuzz_twin_kernel_leg_equals_the_oracle(cuda, world_kind, seed):
    """The kernel leg of the fuzz twin (``tests/test_torch_oracle.py``):
    random segmented worlds, every kind under every policy of the world
    kind, ``run_sweep`` on the card equal to the port's oracle."""
    from _torch_helpers import fuzz_cells, oracle
    from repro_torch.core import simulator as tsim
    cells = fuzz_cells(P, world_kind, seed)
    if not cells:
        return                       # degenerate draw: nothing mapped
    n0 = LAUNCHES["tlb_sweep"]
    got = run_sweep(cells, cache=False, device="cuda")
    assert LAUNCHES["tlb_sweep"] == n0 + got.stats["n_batches"]
    for c, r in zip(cells, got):
        want = oracle(tsim, c)
        for f in ("accesses", "l1_hits", "l2_regular_hits",
                  "l2_coalesced_hits", "walks", "aligned_probes",
                  "pred_correct", "cycles", "coverage_mean", "shootdowns",
                  "name"):
            assert getattr(r, f) == getattr(want, f), (c.spec, f)
        np.testing.assert_array_equal(r.ppn, want.ppn)


def test_run_method_and_standard_suite_launch_the_kernel(cuda):
    """``run_method`` and ``standard_suite`` on ``"cuda"`` each launch the
    TLB kernel once (the suite's 18 runs are one batch) and equal their
    CPU runs."""
    m = tcore.demand_mapping(1 << 12, seed=3)
    tr = tcore.generate_trace("multiscale", 0, 600, seed=4, mapping=m)
    for spec in (tcore.kaligned_spec([9, 6, 4]),
                 P.baselines.cache_tlb_spec()):
        n0 = LAUNCHES["tlb_sweep"]
        r = tcore.run_method(spec, m, tr, device="cuda")
        assert LAUNCHES["tlb_sweep"] == n0 + 1
        want = tcore.run_method(spec, m, tr, device="cpu")
        assert LAUNCHES["tlb_sweep"] == n0 + 1
        assert (r.name, r.walks, r.cycles) == (want.name, want.walks,
                                               want.cycles)
        np.testing.assert_array_equal(r.ppn, want.ppn)
    n0 = LAUNCHES["tlb_sweep"]
    suite = tcore.standard_suite(m, tr, device="cuda")
    assert LAUNCHES["tlb_sweep"] == n0 + 1
    want = tcore.standard_suite(m, tr, device="cpu")
    assert [(r.name, r.walks, r.cycles, r.coverage_mean) for r in suite] == \
        [(r.name, r.walks, r.cycles, r.coverage_mean) for r in want]


def test_recovery_ladder_on_the_card(cuda):
    """``run_sweep``'s ladder on the card: one injected launch failure is
    recovered by launching the halves (one launch more than the clean
    run), a cursed cell by the oracle; both equal the clean run."""
    import warnings
    from _torch_helpers import world_cells
    from repro_torch.robustness import backend_fault_injection
    cells = world_cells(P, "multitenant")[:6]
    n0 = LAUNCHES["tlb_sweep"]
    clean = run_sweep(cells, cache=False, device="cuda")
    n_clean = LAUNCHES["tlb_sweep"] - n0
    assert n_clean == clean.stats["n_batches"] == 1
    cursed = cells[1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        n0 = LAUNCHES["tlb_sweep"]
        with backend_fault_injection(n_failures=1) as st:
            bis = run_sweep(cells, cache=False, device="cuda")
        n_bis = LAUNCHES["tlb_sweep"] - n0
        with backend_fault_injection(
                n_failures=10_000,
                predicate=lambda sub, bk: any(c is cursed for c in sub)):
            orc = run_sweep(cells, cache=False, device="cuda")
    assert st["injected"] == 1 and n_bis == n_clean + 1
    assert (bis.stats["bisections"], bis.stats["oracle_fallbacks"]) == (1, 0)
    assert orc.stats["bisections"] >= 1 and orc.stats["oracle_fallbacks"] == 1
    for res in (bis, orc):
        for r, want in zip(res, clean):
            assert (r.name, r.walks, r.cycles, r.shootdowns,
                    r.coverage_mean) == (want.name, want.walks, want.cycles,
                                         want.shootdowns, want.coverage_mean)
            np.testing.assert_array_equal(r.ppn, want.ppn)


def test_snapshot_restore_round_trips_a_bf16_pool(cuda, tmp_path):
    """A bf16 engine on the card snapshots mid-serve; a fresh engine
    restores its pools bit for bit, in place, and finishes with the
    uninterrupted run's tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, RunConfig, params_from_numpy
    from repro_torch.serve import EngineConfig, ServingEngine
    model = Model(get_config("internlm2-1.8b", reduced=True),
                  RunConfig(attn_q_chunk=32, attn_kv_chunk=32))
    params = params_from_numpy(model.init_numpy(0), "cuda")
    ec = EngineConfig(page_size=8, num_pages=64, max_batch=2, max_seq=64)
    rng = np.random.default_rng(2024)
    prompts = [list(rng.integers(0, 512, size=n)) for n in (45, 30, 13)]

    def engine():
        eng = ServingEngine(model, params, ec, device="cuda")
        for p in prompts:
            eng.add_request(p, max_new_tokens=4)
        return eng

    straight = engine()
    straight.run_to_completion()
    eng = engine()
    eng.step()
    eng.step()
    eng.snapshot(str(tmp_path))
    fresh = ServingEngine(model, params, ec, device="cuda")
    ptrs = {k: t.data_ptr() for k, t in fresh.state["pos0"].items()}
    fresh.restore(str(tmp_path))
    for k, t in fresh.state["pos0"].items():
        assert t.dtype == torch.bfloat16 and t.is_cuda
        assert t.data_ptr() == ptrs[k]
        assert torch.equal(t, eng.state["pos0"][k])
    fresh.run_to_completion()
    assert [fresh.requests[i].generated for i in range(3)] == \
        [straight.requests[i].generated for i in range(3)]


# ---------------------------------------------------------------------------
# Paged attention: the class-k CUDA kernel against its plain version
# ---------------------------------------------------------------------------

PA_TOL = {torch.float32: dict(atol=5e-5, rtol=5e-5),
          torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _pa_case(dev, dtype, B, H, KVH, D, T, seed=0, frag=0.3, n_pages=128):
    from _torch_helpers import random_pool_case
    from repro_torch.kvcache import PagedKVAllocator
    q, kp, vp, bt, lens = random_pool_case(np.random.default_rng(seed),
                                           PagedKVAllocator, B, H, KVH, D,
                                           T, n_pages, frag)
    to = lambda a: torch.from_numpy(a).to(dev, dtype)  # noqa: E731
    return to(q), to(kp), to(vp), bt, lens


def _assert_close(a, b, dtype, what):
    torch.testing.assert_close(a.float().cpu(), b.float().cpu(),
                               **PA_TOL[dtype], msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 2, 64, 16), (3, 8, 8, 32, 8),
                                   (1, 8, 1, 128, 16), (3, 16, 8, 128, 16),
                                   (2, 64, 8, 128, 16)])
def test_paged_class_pass_matches_plain(cuda, dtype, shape):
    """Every class pass: (o, m, l) of the kernel == the plain version's,
    f32 5e-5 / bf16 2e-2, and the merged op == the plain op."""
    from repro_torch.kernels.paged_attention import (
        CLASS_LAUNCHES, LAUNCHES, build_descriptors, paged_attention,
        paged_attention_class_pass, paged_attention_class_pass_ref)
    B, H, KVH, D, T = shape
    q, kp, vp, bt, lens = _pa_case(cuda, dtype, B, H, KVH, D, T)
    K = (3, 2, 1)
    desc = build_descriptors(bt, K)
    for k in (3, 2, 1, 0):
        wi, cov = desc[k]
        n0, c0 = LAUNCHES["paged_attention"], CLASS_LAUNCHES.get(k, 0)
        got = paged_attention_class_pass(q, kp, vp, wi, cov, lens,
                                         pages_per_block=1 << k, page_size=T)
        torch.cuda.synchronize()
        assert LAUNCHES["paged_attention"] == n0 + 1
        assert CLASS_LAUNCHES[k] == c0 + 1
        want = paged_attention_class_pass_ref(
            q, kp, vp, wi, cov, lens, pages_per_block=1 << k, page_size=T)
        assert LAUNCHES["paged_attention"] == n0 + 1   # plain not counted
        for name, a, b in zip("oml", got, want):
            _assert_close(a, b, torch.float32 if name == "m" else dtype,
                          f"class {k} {name}")
    cpu = [t.cpu() for t in (q, kp, vp)]
    out = paged_attention(q, kp, vp, bt, lens, page_size=T, K_classes=K)
    ref = paged_attention(*cpu, bt, lens, page_size=T, K_classes=K)
    _assert_close(out, ref, dtype, "merged")


def test_paged_kernel_junk_window_and_inactive_row(cuda):
    """A covered window wholly past kv_lens keeps the -1e30 semantics
    (m = -1e30, finite l and o), an inactive row yields (0, -1e30, 0), and
    the merge weights the junk class by 0."""
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_class_pass,
        paged_attention_class_pass_ref)
    rng = np.random.default_rng(1)
    T, KVH, D, H = 16, 2, 64, 4
    kp = torch.from_numpy(rng.standard_normal((32, T, KVH, D)).astype(
        np.float32)).to(cuda)
    vp = torch.from_numpy(rng.standard_normal((32, T, KVH, D)).astype(
        np.float32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((3, H, D)).astype(
        np.float32)).to(cuda)
    # row 0: pages 0..3 as one class-2 window + page 9, kv_len 20 (the
    # class-2 window is live); row 1: pages 8..11 class-2, kv_len 0 (all
    # junk); row 2: inactive
    bt = np.array([[0, 1, 2, 3, 9, -1, -1, -1], [8, 9, 10, 11, -1, -1, -1, -1],
                   [-1] * 8], np.int32)
    bt[1, :4] = [12, 13, 14, 15]
    lens = np.array([20, 0, 0], np.int32)
    wi = np.array([[0, 0], [3, 0], [0, 0]], np.int32)
    cov = np.array([[1, 0], [1, 0], [0, 0]], np.int8)
    got = paged_attention_class_pass(q, kp, vp, wi, cov, lens,
                                     pages_per_block=4, page_size=T)
    want = paged_attention_class_pass_ref(q, kp, vp, wi, cov, lens,
                                          pages_per_block=4, page_size=T)
    o, m, l = (t.cpu() for t in got)
    assert torch.all(m[1] == -1e30) and torch.all(l[1] == 4 * T)
    assert torch.all(o[2] == 0) and torch.all(m[2] == -1e30) \
        and torch.all(l[2] == 0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b.cpu(), atol=5e-5, rtol=5e-5)
    out = paged_attention(q[:2], kp, vp, bt[:2], lens[:2], page_size=T,
                          K_classes=(2,))
    assert torch.isfinite(out).all()


def _junk_case(dev):
    """``test_paged_kernel_junk_window_and_inactive_row``'s pool and class-2
    tables: row 0 live, row 1 covered but wholly past kv_lens (junk), row
    2 inactive; 2 windows, so every split count 1 .. 2 is tried."""
    rng = np.random.default_rng(1)
    T, KVH, D, H = 16, 2, 64, 4
    pool = [torch.from_numpy(rng.standard_normal((32, T, KVH, D)).astype(
        np.float32)).to(dev) for _ in range(2)]
    q = torch.from_numpy(rng.standard_normal((3, H, D)).astype(
        np.float32)).to(dev)
    lens = np.array([20, 0, 0], np.int32)
    wi = np.array([[0, 0], [3, 0], [0, 0]], np.int32)
    cov = np.array([[1, 0], [1, 0], [0, 0]], np.int8)
    return q, pool[0], pool[1], wi, cov, lens, T


@pytest.mark.parametrize("n_split", ["1", "2", "3", "7", "chosen", "n_win"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_forced_splits_match_plain(cuda, dtype, n_split):
    """The windows of a row split over any number of blocks: every class
    pass (o, m, l) == the plain version (f32 5e-5 / bf16 2e-2), on a
    fragmented pool case whose class 0 has 64 windows and on the
    junk-window and inactive-row case, one wrapper launch each."""
    from repro_torch.kernels.paged_attention import (
        LAUNCHES, build_descriptors, choose_splits,
        paged_attention_class_pass, paged_attention_class_pass_ref)
    q, kp, vp, bt, lens = _pa_case(cuda, dtype, 3, 16, 8, 128, 16)
    desc = build_descriptors(bt, (3, 1))
    cases = [(q, kp, vp, *desc[k], lens, 1 << k, 16) for k in (3, 1, 0)]
    jq, jk, jv, jwi, jcov, jlens, T = _junk_case(cuda)
    cases.append((jq.to(dtype), jk.to(dtype), jv.to(dtype), jwi, jcov,
                  jlens, 4, T))
    for q_, kp_, vp_, wi, cov, lens_, P2, T_ in cases:
        n_win = wi.shape[1]
        n = dict(chosen=choose_splits(q_.shape[0], kp_.shape[2], n_win),
                 n_win=n_win).get(n_split) or min(int(n_split), n_win)
        n0 = LAUNCHES["paged_attention"]
        got = paged_attention_class_pass(q_, kp_, vp_, wi, cov, lens_,
                                         pages_per_block=P2, page_size=T_,
                                         n_split=n)
        torch.cuda.synchronize()
        assert LAUNCHES["paged_attention"] == n0 + 1
        want = paged_attention_class_pass_ref(q_, kp_, vp_, wi, cov, lens_,
                                              pages_per_block=P2,
                                              page_size=T_)
        for name, a, b in zip("oml", got, want):
            _assert_close(a, b, torch.float32 if name == "m" else dtype,
                          f"class {P2} n_split {n} {name}")
        if P2 == 4:
            o, m, l = (t.cpu() for t in got)
            assert torch.all(m[1] == -1e30) and torch.all(l[1] == 4 * T_)
            assert torch.all(o[2] == 0) and torch.all(m[2] == -1e30) \
                and torch.all(l[2] == 0)


def test_paged_kernel_rejects_out_of_range_window(cuda):
    from repro_torch.kernels.paged_attention import (
        LAUNCHES, paged_attention_class_pass)
    q, kp, vp, bt, lens = _pa_case(cuda, torch.float32, 2, 4, 2, 64, 16)
    wi = np.zeros((2, 4), np.int32)
    cov = np.ones((2, 4), np.int8)
    wi[1, 2] = kp.shape[0] // 4                       # one past the pool
    n0 = LAUNCHES["paged_attention"]
    with pytest.raises(ValueError, match="outside"):
        paged_attention_class_pass(q, kp, vp, wi, cov, lens,
                                   pages_per_block=4, page_size=16)
    with pytest.raises(ValueError, match="tokens"):
        paged_attention_class_pass(q, kp, vp, wi * 0, cov, lens,
                                   pages_per_block=4, page_size=8)
    assert LAUNCHES["paged_attention"] == n0


def test_serving_engine_on_card_matches_cpu(cuda):
    """The reduced InternLM2 served on the card (f32 compute) generates
    the CPU engine's tokens, through the kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import LAUNCHES
    from repro_torch.models import Model, RunConfig, params_from_numpy
    from repro_torch.serve import EngineConfig, ServingEngine
    model = Model(get_config("internlm2-1.8b", reduced=True),
                  RunConfig(attn_q_chunk=32, attn_kv_chunk=32,
                            compute_dtype="float32"))
    params = params_from_numpy(model.init_numpy(0))
    rng = np.random.default_rng(2024)
    prompts = [list(rng.integers(0, 512, size=n)) for n in (45, 30, 13)]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(model, params, EngineConfig(
            page_size=8, num_pages=64, max_batch=2, max_seq=64), device=dev)
        for p in prompts:
            eng.add_request(p, max_new_tokens=4)
        n0 = LAUNCHES["paged_attention"]
        m = eng.run_to_completion()
        out[dev] = [eng.requests[i].generated for i in range(3)], m
        if dev == "cuda":
            assert LAUNCHES["paged_attention"] > n0
        else:
            assert LAUNCHES["paged_attention"] == n0
    assert out["cuda"][0] == out["cpu"][0]
    assert out["cuda"][1]["K"] == out["cpu"][1]["K"]


# ---------------------------------------------------------------------------
# Flash attention: the prefill kernel against its plain version
# ---------------------------------------------------------------------------

#: (B, S, H, KVH, D, causal): ``tests/test_kernels.py``'s four shapes, a
#: ragged full-width InternLM2 layer, a ragged non-causal GQA case, and
#: HuBERT-XLarge's head dim 80 (non-causal, and causal at its 16 heads)
FLASH_SHAPES = [(2, 128, 4, 2, 64, True), (1, 200, 4, 4, 32, True),
                (2, 96, 8, 2, 64, False), (1, 64, 2, 1, 128, True),
                (1, 333, 16, 8, 128, True), (2, 77, 8, 2, 32, False),
                (2, 96, 4, 4, 80, False), (1, 300, 16, 16, 80, True)]


def _flash_case(dev, dtype, B, S, H, KVH, D, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev, dtype)
        for shape in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, dtype, shape):
    """The kernel == ``flash_attention_ref`` on the same card tensors, f32
    within 5e-5 and bf16 within 2e-2; one launch, the plain run not
    counted."""
    from repro_torch.kernels.flash_attention import (
        LAUNCHES, flash_attention_gqa, flash_attention_ref)
    B, S, H, KVH, D, causal = shape
    q, k, v = _flash_case(cuda, dtype, B, S, H, KVH, D)
    n0 = LAUNCHES["flash_attention"]
    got = flash_attention_gqa(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == n0 + 1
    want = flash_attention_ref(q, k, v, causal=causal)
    assert LAUNCHES["flash_attention"] == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    _assert_close(got, want, dtype, f"flash {shape}")


def test_flash_kernel_is_deterministic_and_reads_strided_views(cuda):
    """Two calls give the same bits; q, k, v as strided views of one packed
    [B, S, H + 2 KVH, D] projection give the contiguous inputs' bits."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    B, S, H, KVH, D = 2, 257, 16, 8, 128
    for dtype in (torch.float32, torch.bfloat16):
        qkv = _flash_case(cuda, dtype, B, S, H + 2 * KVH, 1, D)[0]
        q, k, v = qkv.split([H, KVH, KVH], dim=2)
        assert not q.is_contiguous()
        a = flash_attention_gqa(q, k, v, causal=True)
        b = flash_attention_gqa(q, k, v, causal=True)
        c = flash_attention_gqa(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True)
        assert torch.equal(a, b) and torch.equal(a, c)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.flash_attention import (
        LAUNCHES, flash_attention_gqa)
    n0 = LAUNCHES["flash_attention"]
    q, k, v = _flash_case(cuda, torch.float32, 1, 64, 4, 2, 48)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_gqa(q, k, v)
    q, k, v = _flash_case(cuda, torch.float64, 1, 64, 4, 2, 64)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_gqa(q, k, v)
    q, k, v = _flash_case(cuda, torch.float32, 1, 64, 4, 2, 64)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_gqa(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="group"):
        flash_attention_gqa(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="device"):
        flash_attention_gqa(q, k.cpu(), v)
    assert LAUNCHES["flash_attention"] == n0


#: one bf16 ulp of the output: 2^-7 |plain| + 1e-2 rms(plain), the limit
#: ``chip_smoke.py`` holds the bf16 kernel to
BF16_ULP_RTOL, BF16_RMS_ATOL = 2.0 ** -7, 1e-2


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64, 80, 128])
def test_flash_bf16_kernel_within_one_ulp_twice_and_strided(cuda, D,
                                                            causal):
    """The tensor-core kernel at every head dim, S not a multiple of its
    64-row tile, GQA: within one bf16 ulp of the plain version, the same
    bits twice, and the same bits from strided views of one packed
    projection."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_gqa, flash_attention_ref)
    B, S, H, KVH = 2, 333, 8, 2
    qkv = _flash_case(cuda, torch.bfloat16, B, S, H + 2 * KVH, 1, D,
                      seed=D)[0]
    q, k, v = qkv.split([H, KVH, KVH], dim=2)
    assert not q.is_contiguous()
    a = flash_attention_gqa(q, k, v, causal=causal)
    b = flash_attention_gqa(q, k, v, causal=causal)
    c = flash_attention_gqa(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal)
    assert torch.equal(a, b) and torch.equal(a, c)
    want = flash_attention_ref(q, k, v, causal=causal).float()
    rms = want.square().mean().sqrt()
    limit = BF16_ULP_RTOL * want.abs() + BF16_RMS_ATOL * rms
    assert bool(((a.float() - want).abs() <= limit).all())


def test_flash_wrapper_refuses_autograd_on_the_card(cuda):
    """Forward only: an input that requires grad, with grad mode on, raises
    before any launch; under ``torch.no_grad`` the same call launches."""
    from repro_torch.kernels.flash_attention import (
        LAUNCHES, flash_attention_gqa)
    n0 = LAUNCHES["flash_attention"]
    q, k, v = _flash_case(cuda, torch.bfloat16, 1, 64, 4, 2, 80)
    q.requires_grad_(True)
    with pytest.raises(ValueError, match="forward only"):
        flash_attention_gqa(q, k, v)
    assert LAUNCHES["flash_attention"] == n0
    with torch.no_grad():
        flash_attention_gqa(q, k, v)
    assert LAUNCHES["flash_attention"] == n0 + 1


def test_encoder_forward_on_card_at_head_dim_80(cuda):
    """The reduced HuBERT with its published head dim of 80, f32 (TF32
    off): ``Model.forward(input_embeds=...)`` under ``torch.no_grad``
    launches the D = 80 kernel once per layer, non-causal, and gives the
    CPU forward's logits (5e-5)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import LAUNCHES
    from repro_torch.models import Model, RunConfig, params_from_numpy
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("hubert-xlarge", reduced=True),
                              head_dim=80)
    model = Model(cfg, RunConfig(compute_dtype="float32"))
    host = model.init_numpy(0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 150, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        want, _ = model.forward(params_from_numpy(host, "cpu"),
                                input_embeds=x)
        n0 = LAUNCHES["flash_attention"]
        got, _ = model.forward(params_from_numpy(host, cuda),
                               input_embeds=x.to(cuda))
        torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == n0 + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "hubert-xlarge"])
def test_reduced_train_step_on_card_matches_cpu(cuda, arch):
    """The reduced model's gradients and one AdamW ``train_step`` (two
    microbatches) on the card, f32 (TF32 off), against the CPU's: the
    loss, the grad norm and every gradient leaf (within ``atol`` = 2e-4
    of the leaf's largest + 1e-6, the tolerance against JAX), the
    parameters after the step within 1e-4 wherever the step's gradient
    (the mean of the two microbatches' gradients, each loss over its own
    mask) is settled (|g| above 10 ``atol``, so that the gradient's
    tolerance moves the update by at most a few hundredths of lr) and
    within 1.5 lr elsewhere (one AdamW step moves a weight by ~0.73 lr,
    either way, whatever |g|); no kernel launched (training
    differentiates the plain chunked attention)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, _batch_at
    from repro_torch.kernels.flash_attention import LAUNCHES
    from repro_torch.models import Model, RunConfig, params_from_numpy
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import OptConfig, init_opt
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import grads_of
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, reduced=True)
    model = Model(cfg, RunConfig(compute_dtype="float32", microbatches=2,
                                 attn_q_chunk=32, attn_kv_chunk=32))
    host = model.init_numpy(0)
    batch = _batch_at(cfg, PipelineConfig(batch=4, seq=48), 2)
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(model, oc)
    grads, out = {}, {}
    n0 = LAUNCHES["flash_attention"]
    for dev in ("cpu", cuda):
        p = params_from_numpy(host, dev)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        grads[str(dev)] = grads_of(model, p, b)
        out[str(dev)] = step(p, init_opt(oc, p), b, 1)
    p = params_from_numpy(host, "cpu")
    micro = [dict(tree_leaves(grads_of(model, p, {
        k: torch.from_numpy(v[2 * i:2 * i + 2]) for k, v in batch.items()})[0]))
        for i in range(2)]
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == n0
    (gc, lc), (gg, lg) = grads["cpu"], grads[str(cuda)]
    assert abs(float(lg["loss"]) - float(lc["loss"])) <= 5e-5
    g_cpu = dict(tree_leaves(gc))
    atol = {path: 2e-4 * float(g.abs().max()) + 1e-6
            for path, g in g_cpu.items()}
    for path, g in tree_leaves(gg):
        torch.testing.assert_close(g.cpu(), g_cpu[path], atol=atol[path],
                                   rtol=0, msg=str(path))
    (pc, _, mc), (pg, _, mg) = out["cpu"], out[str(cuda)]
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 5e-5
    assert abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) <= \
        1e-4 * float(mc["grad_norm"])
    for (path, a), (_, b) in zip(tree_leaves(pg), tree_leaves(pc)):
        g_step = (micro[0][path] + micro[1][path]) / 2
        settled = g_step.abs() > 10 * atol[path]
        diff = (a.cpu() - b).abs()
        assert not bool((diff[settled] > 1e-4).any()), path
        assert float(diff.max()) <= 1.5 * oc.lr, path


def test_flash_wrapper_rejects_unaligned_strides(cuda):
    """The kernels copy rows 16 bytes at a time: a base or a row stride
    that is not a multiple of 16 bytes raises before any launch."""
    from repro_torch.kernels.flash_attention import (
        LAUNCHES, flash_attention_gqa)
    n0 = LAUNCHES["flash_attention"]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _flash_case(cuda, dtype, 1, 64, 4, 2, 64)
        wide = torch.zeros((1, 64, 2 * 64 + 1), dtype=dtype, device=cuda)
        k_odd = wide[..., :128].unflatten(2, (2, 64))    # row stride 129
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention_gqa(q, k_odd, v)
        flat = torch.zeros(q.numel() + 1, dtype=dtype, device=cuda)
        q_off = flat[1:].view(q.shape)                   # base off by 1 elt
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention_gqa(q_off, k, v)
    assert LAUNCHES["flash_attention"] == n0


def test_model_prefill_on_card_runs_the_flash_kernel(cuda, monkeypatch):
    """``Model.prefill`` of the reduced InternLM2 on the card launches the
    kernel once per layer, never calls ``chunked_attention``, and gives
    the CPU prefill's logits and KV cache (f32, 5e-5)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import LAUNCHES
    from repro_torch.models import Model, RunConfig, params_from_numpy
    from repro_torch.models import layers as TL
    from repro_torch.models.common import tree_map
    model = Model(get_config("internlm2-1.8b", reduced=True),
                  RunConfig(attn_q_chunk=32, attn_kv_chunk=32,
                            compute_dtype="float32"))
    params = model.compute_params(params_from_numpy(model.init_numpy(0),
                                                    device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, model.cfg.vocab, size=(2, 45)))
    want_logits, want_state = model.prefill(params, toks, max_seq=64)

    def refuse(*a, **kw):
        raise AssertionError("the card prefill called chunked_attention")
    monkeypatch.setattr(TL, "chunked_attention", refuse)
    gpu = tree_map(lambda a: a.to(cuda), params)
    n0 = LAUNCHES["flash_attention"]
    logits, state = model.prefill(gpu, toks.to(cuda), max_seq=64)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == n0 + model.cfg.n_layers
    torch.testing.assert_close(logits.cpu(), want_logits, atol=5e-5,
                               rtol=5e-5)
    for key in ("k", "v"):
        torch.testing.assert_close(state["pos0"][key].cpu(),
                                   want_state["pos0"][key], atol=5e-5,
                                   rtol=5e-5)


# ---------------------------------------------------------------------------
# Chunked prefill: the flash kernel at a query offset; the model families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernel_at_a_query_offset_matches_plain(cuda, dtype, shape):
    """Each of 4 chunks of a prefill (q's rows ``off ..``, k and v's first
    ``off + Sc`` rows, ``q_offset = off``) through the kernel == the plain
    version with the same offset, f32 within 5e-5 and bf16 within 2e-2;
    one launch a chunk."""
    from repro_torch.kernels.flash_attention import (
        LAUNCHES, flash_attention_gqa, flash_attention_ref)
    B, S, H, KVH, D, causal = shape
    q, k, v = _flash_case(cuda, dtype, B, S, H, KVH, D, seed=3)
    Sc = S // 4
    for ci in range(4):
        off = ci * Sc
        qc, kc, vc = q[:, off:off + Sc], k[:, :off + Sc], v[:, :off + Sc]
        n0 = LAUNCHES["flash_attention"]
        got = flash_attention_gqa(qc, kc, vc, causal=causal, q_offset=off)
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention"] == n0 + 1
        want = flash_attention_ref(qc, kc, vc, causal=causal, q_offset=off)
        assert got.shape == qc.shape
        _assert_close(got, want, dtype, f"flash {shape} chunk {ci}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_offset_chunks_equal_the_whole_call(cuda, dtype):
    """``q_offset=0`` gives the default call's bits, and every causal chunk
    (on the 128-row q tiles or off them) gives the whole call's rows bit
    for bit: a row walks the same key tiles in the same order, the tiles
    past its diagonal wholly masked, which leaves its state as it was."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    q, k, v = _flash_case(cuda, dtype, 2, 512, 8, 2, 64, seed=4)
    whole = flash_attention_gqa(q, k, v, causal=True)
    assert torch.equal(whole, flash_attention_gqa(q, k, v, causal=True,
                                                  q_offset=0))
    for off, n in ((128, 128), (256, 128), (100, 77), (333, 179)):
        got = flash_attention_gqa(q[:, off:off + n], k[:, :off + n],
                                  v[:, :off + n], causal=True,
                                  q_offset=off)
        assert torch.equal(got, whole[:, off:off + n]), off


def test_flash_wrapper_rejects_a_wrong_offset(cuda):
    from repro_torch.kernels.flash_attention import (
        LAUNCHES, flash_attention_gqa)
    n0 = LAUNCHES["flash_attention"]
    q, k, v = _flash_case(cuda, torch.bfloat16, 1, 64, 4, 2, 64)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention_gqa(q[:, 32:], k, v, q_offset=16)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention_gqa(q, k, v, q_offset=-1)
    assert LAUNCHES["flash_attention"] == n0


#: reduced families whose head dims the flash kernel takes (granite-moe's
#: reduced head dim, 24, is not one of 32, 64, 128)
FAMILIES = ("qwen2-moe-a2.7b", "jamba-1.5-large-398b", "xlstm-350m")


@pytest.mark.parametrize("arch", FAMILIES)
def test_families_prefill_and_decode_on_card_match_cpu(cuda, arch):
    """A reduced model of each family (f32, TF32 off) on the card:
    ``prefill``, ``prefill_chunked`` (two chunks, the second through the
    kernel's query offset) and two dense decode steps give the CPU's
    logits and states within 1e-4; every attention layer's prefill
    launches the flash kernel once a chunk."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import LAUNCHES
    from repro_torch.models import Model, RunConfig, params_from_numpy
    from repro_torch.models.common import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    model = Model(get_config(arch, reduced=True),
                  RunConfig(compute_dtype="float32", scan_chunk=16,
                            attn_q_chunk=32, attn_kv_chunk=32))
    cpu = model.compute_params(params_from_numpy(model.init_numpy(0),
                                                 device="cpu"))
    gpu = tree_map(lambda a: a.to(cuda), cpu)
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, model.cfg.vocab, size=(2, 36)))
    tol = dict(atol=1e-4, rtol=1e-4)
    for run in (lambda p, t: model.prefill(p, t, max_seq=40),
                lambda p, t: model.prefill_chunked(p, t, n_chunks=2,
                                                   max_seq=40)):
        want_l, want_s = run(cpu, toks)
        n0 = LAUNCHES["flash_attention"]
        got_l, got_s = run(gpu, toks.to(cuda))
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention"] - n0 in (
            model.cfg.n_attn_layers, 2 * model.cfg.n_attn_layers)
        torch.testing.assert_close(got_l.cpu(), want_l, **tol)
        for pos in want_s:
            for key in want_s[pos]:
                torch.testing.assert_close(got_s[pos][key].cpu(),
                                           want_s[pos][key], **tol)
    for step in range(2):
        nxt = torch.tensor([[5 + step], [9]])
        lens = torch.tensor([36 + step, 36 + step])
        want_l, want_s = model.decode_step(cpu, want_s, nxt, lens)
        got_l, got_s = model.decode_step(gpu, got_s, nxt.to(cuda),
                                         lens.to(cuda))
        torch.testing.assert_close(got_l.cpu(), want_l, **tol)


@pytest.mark.parametrize("arch", FAMILIES)
def test_families_serve_on_card_like_the_jax_engine(cuda, arch):
    """``chip_smoke.py``'s phase M1 for one model: the engine on the card
    (f32, TF32 off) equals the JAX engine's fixture — tokens past the
    margin, logits within 1e-3, K and the descriptor counts exactly — and
    launches the paged kernel only where the model has attention."""
    import importlib.util
    import json
    from pathlib import Path
    from repro_torch.kernels.paged_attention import LAUNCHES
    repo = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  repo / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = json.loads((repo / "tests" / "data" /
                      "port_family_reference.json").read_text())
    n0 = LAUNCHES["paged_attention"]
    res = cs.serve_against_fixture(rec["models"][arch], cuda)
    assert res["max_abs_err"] <= cs.LOGIT_ATOL
    assert (LAUNCHES["paged_attention"] > n0) == (arch != "xlstm-350m")


# ---------------------------------------------------------------------------
# the distributed layer at world size 1 on NCCL (the gloo tests' twins)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_mesh(cuda, tmp_path_factory):
    """A ("data", "model") (1, 1) mesh over an NCCL group of one rank
    (every collective a real NCCL call), deterministic algorithms on for
    the bit-for-bit checks; torn down after the module."""
    import datetime
    import os

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    # deterministic cuBLAS needs its workspace fixed
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    rdzv = tmp_path_factory.mktemp("nccl") / "rdzv"
    dist.init_process_group(
        "nccl", init_method=f"file://{rdzv}", world_size=1, rank=0,
        device_id=torch.device("cuda", torch.cuda.current_device()),
        timeout=datetime.timedelta(seconds=60))
    torch.use_deterministic_algorithms(True)
    try:
        yield make_test_mesh((1, 1), ("data", "model"))
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()


def _reduced_train(kind):
    from repro_torch.configs import get_config
    from repro_torch.models import Model, RunConfig
    from repro_torch.optim import OptConfig
    model = Model(get_config("internlm2-1.8b", reduced=True),
                  RunConfig(compute_dtype="float32", microbatches=2,
                            attn_q_chunk=32, attn_kv_chunk=32))
    return model, OptConfig(kind=kind, lr=1e-3, warmup_steps=1,
                            total_steps=10)


def _tree_bits_equal(a, b) -> bool:
    from repro_torch.checkpoint.checkpointer import leaf_paths
    from repro_torch.distributed.sharding import gather
    la, lb = dict(leaf_paths(a)), dict(leaf_paths(b))
    return sorted(la) == sorted(lb) and all(
        gather(la[p]).dtype == lb[p].dtype
        and torch.equal(gather(la[p]).view(torch.uint8),
                        gather(lb[p]).view(torch.uint8)) for p in la)


@pytest.mark.parametrize("kind", ["adamw", "adamw8bit", "adafactor"])
def test_sharded_step_on_nccl_equals_unsharded(cuda, nccl_mesh, kind):
    """One step of the reduced InternLM2 (2 microbatches, f32) with
    parameters and optimizer state as DTensors on the one-rank NCCL mesh
    equals the unsharded step on the card bit for bit: metrics, every
    parameter and every state leaf."""
    from repro_torch.data.pipeline import PipelineConfig, _batch_at
    from repro_torch.distributed.sharding import param_sharding
    from repro_torch.models import params_from_numpy
    from repro_torch.models.common import logical_tree, spec_shapes
    from repro_torch.optim import init_opt
    from repro_torch.train import make_train_step
    from repro_torch.train.trainer import opt_sharding, shard_state
    torch.backends.cuda.matmul.allow_tf32 = False
    model, oc = _reduced_train(kind)
    host = model.init_numpy(0)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in _batch_at(
        model.cfg, PipelineConfig(batch=4, seq=48), 2).items()}
    specs = model.specs()
    psh = param_sharding(logical_tree(specs), spec_shapes(specs), nccl_mesh)
    p = params_from_numpy(host, cuda)
    plain = make_train_step(model, oc)(p, init_opt(oc, p), batch, 1)
    sp, so = shard_state(oc, params_from_numpy(host, cuda), psh,
                         opt_sharding(model, oc, nccl_mesh))
    sharded = make_train_step(model, oc, psh)(sp, so, batch, 1)
    assert {k: float(v) for k, v in sharded[2].items()} == \
        {k: float(v) for k, v in plain[2].items()}
    assert _tree_bits_equal(sharded[0], plain[0])
    assert _tree_bits_equal(sharded[1], plain[1])


def test_checkpoints_restore_across_sharding_on_nccl(cuda, nccl_mesh,
                                                     tmp_path):
    """A sharded Trainer's checkpoint (AdamW8bit: f32, int8 and bf16
    leaves) restores into an unsharded trainer, and an unsharded one's
    into a sharded trainer, every leaf equal to the run's final state bit
    for bit; the two runs log the same losses and grad norms."""
    from repro_torch.data import DataPipeline, PipelineConfig
    from repro_torch.distributed.sharding import is_dtensor, param_sharding
    from repro_torch.models.common import logical_tree, spec_shapes
    from repro_torch.train import Trainer, TrainerConfig
    model, oc = _reduced_train("adamw8bit")
    specs = model.specs()
    psh = param_sharding(logical_tree(specs), spec_shapes(specs), nccl_mesh)

    def trainer(name, sharded):
        pipe = DataPipeline(model.cfg, PipelineConfig(batch=4, seq=48),
                            device=cuda)
        return Trainer(model, oc, TrainerConfig(
            ckpt_dir=str(tmp_path / name), total_steps=3, ckpt_every=3,
            log_every=1), pipe, param_shardings=psh if sharded else None,
            device=cuda)

    out = {}
    for name, sharded in (("sharded", True), ("plain", False)):
        tr = trainer(name, sharded)
        out[name] = tr.run()
        tr.pipeline.close()
    assert [(m["loss"], m["grad_norm"]) for m in out["sharded"]["metrics"]] \
        == [(m["loss"], m["grad_norm"]) for m in out["plain"]["metrics"]]
    want = {"params": out["plain"]["params"], "opt": out["plain"]["opt"]}
    for src, sharded in (("sharded", False), ("plain", True)):
        tr = trainer(src, sharded)
        tr.pipeline.close()
        p, o, step = tr.try_restore()
        assert step == 3 and is_dtensor(p["embed"]) == sharded
        assert _tree_bits_equal({"params": p, "opt": o}, want)
