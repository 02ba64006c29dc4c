"""The port's prefill (flash) attention against the JAX package's, on the CPU.

Same numpy inputs through ``repro.kernels.flash_attention`` (the Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` runs it, and its
naive oracle) and ``repro_torch.kernels.flash_attention`` (whose CPU path
is the plain version with the CUDA kernel's exact contract).  Tolerances
are ``tests/test_kernels.py``'s: ``atol = rtol = 5e-5`` in f32 (the same
f32 products summed in another order), ``2e-2`` in bf16 (both round the
output once to bf16 from f32), and ``1e-4`` against the chunked path, as
``test_flash_matches_chunked_jnp_path`` allows.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention_gqa as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (LAUNCHES, attention_ref,
                                                 flash_attention_gqa,
                                                 flash_attention_ref,
                                                 flash_attention_tc_ref,
                                                 split_bf16)
from repro_torch.models import RunConfig
from repro_torch.models import layers as TL

TOL = dict(atol=5e-5, rtol=5e-5)
TOL_BF16 = dict(atol=2e-2, rtol=2e-2)
REPO = Path(__file__).resolve().parents[1]

#: ``tests/test_kernels.py::test_flash_attention``'s parametrisation:
#: (B, S, H, KVH, D, causal, block_q, block_k)
KERNEL_SHAPES = [(2, 128, 4, 2, 64, True, 64, 64),
                 (1, 200, 4, 4, 32, True, 64, 32),    # ragged block boundary
                 (2, 96, 8, 2, 64, False, 32, 64),
                 (1, 64, 2, 1, 128, True, 64, 64)]    # MQA, D=128


def _inputs(B, S, H, KVH, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, KVH, D)).astype(np.float32),
            rng.standard_normal((B, S, KVH, D)).astype(np.float32))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _close(a, b, tol):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)


@pytest.mark.parametrize("B,S,H,KVH,D,causal,bq,bk", KERNEL_SHAPES)
def test_flash_ref_matches_jax_kernel(B, S, H, KVH, D, causal, bq, bk):
    """``flash_attention_ref`` and the CPU op == the Pallas kernel (with
    its GQA repeat) on the same inputs, f32."""
    arrs = _inputs(B, S, H, KVH, D)
    want = j_flash(*_j(*arrs), causal=causal, block_q=bq, block_k=bk)
    q, k, v = _t(*arrs)
    _close(flash_attention_ref(q, k, v, causal=causal), want, TOL)
    got = flash_attention_gqa(q, k, v, causal=causal)
    _close(got, want, TOL)


def test_flash_ref_matches_jax_kernel_bf16():
    """In bf16 both read bf16, compute in f32 and round the output once."""
    arrs = _inputs(2, 128, 4, 2, 64, seed=1)
    want = j_flash(*_j(*arrs, dtype=jnp.bfloat16), causal=True, block_q=64,
                   block_k=64)
    got = flash_attention_ref(*_t(*arrs, dtype=torch.bfloat16), causal=True)
    assert got.dtype == torch.bfloat16
    _close(got, want.astype(jnp.float32), TOL_BF16)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_at_full_width_heads_matches_jax_oracle(causal):
    """InternLM2-1.8B's attention heads (16 over 8, D = 128) at a ragged S:
    the grouped plain version == the JAX oracle on repeated K/V."""
    cfg = get_config("internlm2-1.8b")
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _inputs(1, 300, H, KVH, D, seed=2)
    kr, vr = (np.repeat(a, H // KVH, axis=2) for a in (k, v))
    want = j_attention_ref(*_j(q, kr, vr), causal=causal)
    _close(flash_attention_ref(*_t(q, k, v), causal=causal, kv_block=128),
           want, TOL)
    _close(attention_ref(*_t(q, kr, vr), causal=causal), want, TOL)


def test_flash_ref_matches_chunked_attention():
    """``tests/test_kernels.py::test_flash_matches_chunked_jnp_path`` for the
    port: the CPU prefill's chunked attention and the plain version agree."""
    q, k, v = _t(*_inputs(2, 96, 4, 2, 32, seed=3))
    a = TL.chunked_attention(q, k, v, causal=True, q_chunk=32, kv_chunk=32)
    b = flash_attention_gqa(q, k, v, causal=True)
    _close(a, b, dict(atol=1e-4, rtol=1e-4))


@pytest.mark.parametrize("kv_block", [1, 7, 64, 4096])
def test_flash_ref_blocking_does_not_change_the_function(kv_block):
    q, k, v = _t(*_inputs(1, 150, 8, 2, 32, seed=4))
    want = attention_ref(q, k.repeat_interleave(4, 2),
                         v.repeat_interleave(4, 2), causal=True)
    _close(flash_attention_ref(q, k, v, causal=True, kv_block=kv_block),
           want, TOL)


def test_flash_op_on_cpu_takes_the_plain_version():
    """CPU tensors run ``flash_attention_ref`` (same bits), with its scale
    argument, and launch nothing."""
    q, k, v = _t(*_inputs(1, 70, 4, 2, 64, seed=5))
    n0 = LAUNCHES["flash_attention"]
    got = flash_attention_gqa(q, k, v, causal=False, scale=0.3)
    assert torch.equal(got, flash_attention_ref(q, k, v, causal=False,
                                                scale=0.3))
    assert LAUNCHES["flash_attention"] == n0


@pytest.mark.parametrize("case,match", [
    ("head_dim", "head dim"), ("dtype", "dtype"), ("mixed", "dtype"),
    ("groups", "group"), ("shape", "must be"), ("rank", "must be"),
    ("device", "no implementation")])
def test_flash_op_rejects_what_the_kernel_does_not_take(case, match):
    q, k, v = _t(*_inputs(1, 32, 4, 2, 64, seed=6))
    if case == "head_dim":
        q, k, v = _t(*_inputs(1, 32, 4, 2, 48))
    elif case == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "mixed":
        k = k.to(torch.bfloat16)
    elif case == "groups":
        q = q[:, :, :3]
    elif case == "shape":
        k = k[:, :16]
    elif case == "rank":
        q = q[0]
    elif case == "device":
        q, k, v = (t.to("meta") for t in (q, k, v))
    with pytest.raises(ValueError, match=match):
        flash_attention_gqa(q, k, v)


# ---------------------------------------------------------------------------
# The bf16 tensor-core kernel's arithmetic, emulated plainly
# ---------------------------------------------------------------------------

def _ulp_used(got, want):
    """The largest share of one bf16 ulp of the output (``chip_smoke.py``'s
    ``BF16_ULP_RTOL * |want| + BF16_RMS_ATOL * rms(want)``) an element of
    ``got`` differs from ``want`` by."""
    cs = _chip_smoke()
    want = want.float()
    rms = want.square().mean().sqrt()
    limit = cs.BF16_ULP_RTOL * want.abs() + cs.BF16_RMS_ATOL * rms
    return float(((got.float() - want).abs() / limit).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_split_bf16_keeps_p_to_2_16(seed):
    """``p_hi = bf16(p)`` exactly, and ``p_hi + p_lo`` keeps p to 2^-16 of
    its magnitude over the whole range softmax weights take."""
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(np.exp(-rng.uniform(0, 80, 10_000)).astype(
        np.float32))
    hi, lo = split_bf16(p)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, p.to(torch.bfloat16))
    err = (hi.double() + lo.double() - p.double()).abs()
    assert bool((err <= 2.0 ** -16 * p.double()).all())
    assert float((hi.double() - p.double()).abs().max() / p.max()) > 2 ** -12


#: (B, S, H, KVH, D, causal): every head dim, ragged S, GQA 1/2/4 and MQA
TC_SHAPES = [(1, 100, 4, 4, 32, True), (2, 77, 4, 2, 64, False),
             (1, 150, 8, 2, 128, True), (1, 90, 4, 1, 64, True),
             (2, 130, 8, 2, 32, False), (1, 200, 2, 1, 128, False)]


@pytest.mark.parametrize("B,S,H,KVH,D,causal", TC_SHAPES)
def test_tensor_core_arithmetic_within_one_ulp(B, S, H, KVH, D, causal):
    """bf16 scores with f32 sums, 64-key tiles and hi/lo ``p @ v``: the
    bf16 kernel's arithmetic equals the contract within one bf16 ulp of
    the output, the limit the card holds the kernel to."""
    q, k, v = _t(*_inputs(B, S, H, KVH, D, seed=S), dtype=torch.bfloat16)
    want = flash_attention_ref(q, k, v, causal=causal)
    got = flash_attention_tc_ref(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _ulp_used(got, want) <= 1.0


def test_one_ulp_limit_catches_p_rounded_once():
    """A case built to show it: keys in pairs whose scores differ by ~1e-2
    and whose values cancel, so the output is a small difference of large
    terms.  p rounded once to bf16 (2^-9) moves it by several bf16 ulps,
    past the limit; the hi/lo pair (2^-16) stays inside."""
    rng = np.random.default_rng(0)
    B, S, H, KVH, D = 1, 128, 2, 1, 32
    q = np.zeros((B, S, H, D), np.float32)
    q[..., 0] = 1.0
    q[..., 1] = rng.uniform(0.5, 1.5, (B, S, H))
    k = np.zeros((B, S, KVH, D), np.float32)
    first = rng.uniform(1.0, 2.0, S // 2)
    k[0, 0::2, 0, 0], k[0, 1::2, 0, 0] = first, first + 1 / 16
    k[0, :, 0, 1] = rng.uniform(-1, 1, S)
    u = rng.standard_normal((S // 2, D)).astype(np.float32)
    v = np.zeros((B, S, KVH, D), np.float32)
    v[0, 0::2, 0], v[0, 1::2, 0] = u, -u
    q, k, v = _t(q, k, v, dtype=torch.bfloat16)
    want = flash_attention_ref(q, k, v, causal=False)
    assert _ulp_used(flash_attention_tc_ref(q, k, v, causal=False),
                     want) <= 1.0
    assert _ulp_used(flash_attention_tc_ref(q, k, v, causal=False,
                                            p_terms=1), want) > 2.0


def test_prefill_attention_on_cpu_is_chunked_attention():
    """On the CPU the prefill's attention is exactly the chunked path the
    JAX prefill computes (so ``Model.prefill`` stays what
    ``tests/test_torch_model.py`` holds to the JAX prefill)."""
    q, k, v = _t(*_inputs(2, 45, 4, 2, 32, seed=7))
    rc = RunConfig(attn_q_chunk=16, attn_kv_chunk=8)
    n0 = LAUNCHES["flash_attention"]
    got = TL.prefill_attention(q, k, v, causal=True, rc=rc)
    want = TL.chunked_attention(q, k, v, causal=True, q_chunk=16, kv_chunk=8)
    assert torch.equal(got, want)
    assert LAUNCHES["flash_attention"] == n0


# ---------------------------------------------------------------------------
# chip_smoke.py's prefill helpers (the phases themselves need a card)
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_flash_bound_counts_the_causal_work():
    """One InternLM2-1.8B layer in bf16 at S = 3,072: 4 D H S (S + 1) / 2
    flop (3.87e10) and q, k, v, o once (37.7 MB); compute-bound at the
    bf16 rate.  Non-causal work is S^2 pairs."""
    cs = _chip_smoke()
    ms, by, n_bytes, flops, t_bytes, t_ops = cs.flash_bound(
        1, 3072, 16, 8, 128, 2)
    assert flops == 4 * 128 * 16 * 3072 * 3073 // 2
    assert n_bytes == 2 * 3072 * 128 * (2 * 16 + 2 * 8)
    assert by == "operations" and ms == t_ops > t_bytes
    assert abs(t_ops - flops / 989e12 * 1e3) < 1e-12
    assert cs.flash_bound(1, 64, 2, 1, 32, 4, causal=False)[3] == \
        4 * 32 * 2 * 64 * 64


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chip_smoke_flash_vs_plain_on_the_cpu(dtype):
    """``flash_vs_plain`` holds the op to the plain version and to itself;
    on the CPU the op is the plain version, so the error is 0."""
    cs = _chip_smoke()
    q, k, v = cs.flash_inputs((1, 40, 4, 2, 32), dtype, "cpu")
    assert q.shape == (1, 40, 4, 32) and k.shape == (1, 40, 2, 32)
    got = cs.flash_vs_plain(q, k, v, causal=True)
    assert got["max_abs_err"] == 0.0 and got["limit_used"] == 0.0
    assert got["rms"] > 0


def test_chip_smoke_flash_vs_plain_catches_a_misweighted_long_walk(
        monkeypatch):
    """A kernel whose late causal rows are 3 % off passes the 2e-2 contract
    tolerance (late outputs are ~sqrt(e / n) for n keys) but not the bf16
    one-ulp limit (2^-7 of |plain|), which ``flash_vs_plain`` also holds."""
    import repro_torch.kernels.flash_attention as fa
    cs = _chip_smoke()
    q, k, v = cs.flash_inputs((1, 1024, 2, 1, 32), torch.bfloat16, "cpu")

    def misweighted(q, k, v, *, causal=True):
        o = flash_attention_ref(q, k, v, causal=causal)
        o[:, 512:] = (o[:, 512:].float() * 1.03).to(o.dtype)
        return o
    monkeypatch.setattr(fa, "flash_attention_gqa", misweighted)
    want = flash_attention_ref(q, k, v, causal=True).float()
    diff = (misweighted(q, k, v).float() - want).abs()
    assert bool((diff <= 2e-2 + 2e-2 * want.abs()).all())
    with pytest.raises(ValueError, match="one bf16 ulp"):
        cs.flash_vs_plain(q, k, v, causal=True)


def test_chip_smoke_f3_request_fits_its_engine():
    """Phase F3's request is admitted by its engine configuration: the
    32,720 tokens fit ``max_seq``, the buddy allocator gives the 2,045
    pages from 256-page blocks down as one run, Algorithm 3 picks its
    largest class (6, ``max_class``) alone, and every covered window lies
    in the pool."""
    from repro_torch.kernels.paged_attention.ops import (
        build_descriptors, check_descriptor, classes_of)
    from repro_torch.kvcache import PagedKVAllocator
    from repro_torch.kvcache.block_table import choose_kernel_classes
    cs = _chip_smoke()
    ec = cs.F3_ENGINE
    total = cs.F3_PROMPT + cs.F3_NEW
    assert total <= ec["max_seq"]
    need = -(-total // ec["page_size"])
    alloc = PagedKVAllocator(ec["num_pages"])
    seq = alloc.allocate(0, need)
    assert seq is not None and len(seq.pages) == need
    assert max(o for _, o in seq.blocks) == alloc.max_order == 8
    assert alloc.contiguity_histogram() == {need: 1}
    bt = alloc.block_table(0, ec["max_seq"] // ec["page_size"])[None]
    K = choose_kernel_classes(alloc.contiguity_histogram(), psi=3)
    assert K == [6]
    desc = build_descriptors(bt, K)
    for k in classes_of(K):
        check_descriptor(*desc[k], ec["num_pages"], k)


@pytest.mark.parametrize("dropped_profiles", [0, 1, 3])
def test_chip_smoke_kernel_rows_expects_the_wrapper_count(
        monkeypatch, dropped_profiles):
    """``kernel_rows`` expects as many events of the port's kernel as its
    launch count grew by, takes a profile short of them again (3 tries),
    and after that keeps the mean of the recorded launches with
    ``recorded < expected`` saying so.  The profiler is replaced here by a
    script of what it records: 3 calls of 2 ms each, the last dropped."""
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    counts = dict(flash_attention=0)
    monkeypatch.setattr(cs, "launch_counts", lambda: dict(counts))
    profiles = []

    def fake_times(f):
        n0 = counts["flash_attention"]
        f()
        n = counts["flash_attention"] - n0
        if n == 0:                                     # the flush alone
            return {"fill": [0.01, 1]}
        profiles.append(n)
        short = len(profiles) <= dropped_profiles
        kept = n - 1 if short else n
        return {"fill": [0.01 * n, n], "flash_attention_fwd_kernel":
                [2.0 * kept, kept]}
    monkeypatch.setattr(cs, "_kernel_times", fake_times)

    def fn():
        counts["flash_attention"] += 1
    rows = cs.kernel_rows(fn, 3, lambda: None, "flash_attention_fwd",
                          "flash_attention")
    assert list(rows) == ["flash_attention_fwd_kernel"]
    row = rows["flash_attention_fwd_kernel"]
    assert len(profiles) == min(dropped_profiles + 1, 3)
    assert row["expected"] == 3 and abs(row["ms"] - 2.0) < 1e-12
    assert row["recorded"] == (2 if dropped_profiles >= 3 else 3)
    assert cs.events_note(row) == (
        "2/3 (MISSING: mean of the recorded launches)"
        if dropped_profiles >= 3 else "3/3")


def test_chip_smoke_kernel_rows_expects_each_kernel_of_a_launch(
        monkeypatch):
    """The paged wrapper launches a split and a combine kernel per call:
    with both name fragments, each kernel is expected as many events as
    the wrapper's count grew by; a profile that never records one of them
    raises."""
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    counts = dict(paged_attention=0)
    monkeypatch.setattr(cs, "launch_counts", lambda: dict(counts))
    recorded = {"paged_class_split_kernel<bf16, 128>": 1.0,
                "paged_class_combine_kernel": 0.01}

    def fake_times(f):
        n0 = counts["paged_attention"]
        f()
        n = counts["paged_attention"] - n0
        rows = {"fill": [0.01 * max(n, 1), max(n, 1)]}
        if n:
            rows.update({name: [ms * n, n] for name, ms in recorded.items()})
        return rows
    monkeypatch.setattr(cs, "_kernel_times", fake_times)

    def fn():
        counts["paged_attention"] += 1
    got = cs.device_ms(fn, 4, lambda: None, cs.PA_KERNELS,
                       "paged_attention")
    assert got["recorded"] == got["expected"] == 8
    assert abs(got["ms"] - 1.01) < 1e-12
    del recorded["paged_class_combine_kernel"]
    with pytest.raises(ValueError, match="no device time"):
        cs.device_ms(fn, 4, lambda: None, cs.PA_KERNELS, "paged_attention")


#: what ``cuobjdump -sass`` prints, cut down: the flash kernels at a few
#: head dims (wgmma products in bf16, FMAs in f32)
SASS = """
        Function : _ZN51_GLOBAL__N__x2wg29flash_attention_fwd_wg_kernelILi128EEEvPK13__nv_bfloat16
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/              @!PT LDS RZ, [RZ] ;
        /*0020*/                   HGMMA.64x128x16.F32.BF16 R24, R4, gdesc[UR4], R24 ;
        /*0030*/               @P0 HGMMA.64x128x16.F32.BF16 R28, R4, gdesc[UR8], R28 ;
        /*0040*/                   FFMA R2, R3, R4, R2 ;
        Function : _ZN51_GLOBAL__N__x2wg29flash_attention_fwd_wg_kernelILi64EEEvPK13__nv_bfloat16
        /*0000*/                   HGMMA.64x64x16.F32.BF16 R24, R4, gdesc[UR4], R24 ;
        /*0010*/                   HGMMA.64x64x16.F32.BF16 R24, R8, gdesc[UR8], R24, gsb0 ;
        Function : _ZN51_GLOBAL__N__x26flash_attention_fwd_kernelIfLi128EEEvPKT_S3_S3_PS1_
        /*0000*/                   FFMA R2, R3, R4, R2 ;
        /*0010*/                   FFMA.FTZ R5, R3, R4, R5 ;
        /*0020*/                   FMUL R2, R3, R4 ;
"""


@pytest.mark.parametrize("case", ["ok", "bf16_on_cuda_cores", "f32_tf32"])
def test_chip_smoke_flash_sass_mix(case):
    """Phase 1's SASS line: HGMMA, HMMA and FFMA counted per
    instantiation (predicated and dotted opcodes too); a bf16 kernel
    without wgmma products, or an f32 one with a tensor-core product,
    fails."""
    cs = _chip_smoke()
    sass = SASS
    if case == "bf16_on_cuda_cores":
        sass = sass.replace("HGMMA.64x64x16.F32.BF16", "FFMA")
    elif case == "f32_tf32":
        sass = sass.replace("FMUL R2", "HMMA.1684.F32.TF32 R2")
    if case != "ok":
        with pytest.raises(ValueError, match="bf16|f32"):
            cs.flash_sass_mix(sass)
        return
    assert cs.flash_sass_mix(sass) == {
        "bf16 D=128": {"HGMMA": 2, "HMMA": 0, "FFMA": 1},
        "bf16 D=64": {"HGMMA": 2, "HMMA": 0, "FFMA": 0},
        "f32 D=128": {"HGMMA": 0, "HMMA": 0, "FFMA": 2}}
