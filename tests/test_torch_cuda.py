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
paged-attention kernel must equal its plain version per class pass
(o, m, l) and merged, f32 within 5e-5 and bf16 within 2e-2, keep the
-1e30 semantics of wholly masked windows, refuse a window index outside
the pool, and serve the reduced InternLM2 token for token like the CPU.
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
