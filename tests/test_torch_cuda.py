"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test takes the ``cuda`` fixture, which skips when
``torch.cuda.is_available()`` is False (decided in the fixture, never at
import, so every xdist worker collects the same tests).  On a machine with
a card run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The TLB-sweep kernel must equal the plain version bit for bit — counters,
coverage samples and the whole ``[L, T]`` ppn array — on static, dynamic,
multi-tenant, nested and parity-fault batches covering all 10 method kinds
and every policy knob, and it must count one launch per batch.  The
paged-attention kernels must equal their plain version per class pass
(o, m, l) and merged, f32 within 5e-5 and bf16 within 2e-2, at any split
of a row's windows over blocks, keep the -1e30 semantics of wholly masked
windows, refuse a window index outside the pool, and serve the reduced
InternLM2 token for token like the CPU.  The flash kernels must equal
their plain version (bf16 also within one bf16 ulp), give the same bits
twice and from strided views, and refuse rows off 16-byte boundaries.
"""
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


def test_kernel_rejects_out_of_range_trace(cuda):
    cells = world_cells(P, "static")[:2]
    lanes, stacks, st0, sb = pack_batch(cells)
    stacks = dict(stacks, trace=stacks["trace"].copy())
    stacks["trace"][0, 5] = stacks["maps"].shape[1]        # vpn == P
    lt, stt, s0t = as_tensors(lanes, stacks, st0, cuda)
    with pytest.raises(ValueError, match="trace vpn"):
        run_lanes(lt, stt, s0t, sb)


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
#: ragged full-width InternLM2 layer, and a ragged non-causal GQA case
FLASH_SHAPES = [(2, 128, 4, 2, 64, True), (1, 200, 4, 4, 32, True),
                (2, 96, 8, 2, 64, False), (1, 64, 2, 1, 128, True),
                (1, 333, 16, 8, 128, True), (2, 77, 8, 2, 32, False)]


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
@pytest.mark.parametrize("D", [32, 64, 128])
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
