"""The port's paged decode attention against the JAX package's, on the CPU.

Same numpy inputs through ``repro.kernels.paged_attention`` (Pallas in
interpret mode) and ``repro_torch.kernels.paged_attention`` (its plain
version, which the op takes for CPU tensors; the CUDA kernel is held to
that plain version on the card in ``tests/test_torch_cuda.py``).
Tolerances are ``tests/test_kernels.py``'s: f32 ``atol = rtol = 5e-5``
(sums in another order), bf16 ``2e-2`` (inputs rounded to bf16 on both
sides, the output rounded to bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import PAGED_K_CLASSES, PAGED_SHAPES, random_pool_case
from repro.kernels.paged_attention import ops as j_ops
from repro.kernels.paged_attention import paged_attention as j_pa
from repro.kernels.paged_attention import ref as j_ref
from repro.kvcache.block_table import choose_kernel_classes
from repro_torch.kernels.paged_attention import ops as t_ops
from repro_torch.kernels.paged_attention import ref as t_ref
from repro_torch.kvcache import PagedKVAllocator

TOL = dict(atol=5e-5, rtol=5e-5)
TOL_BF16 = dict(atol=2e-2, rtol=2e-2)


def _case(seed, B, H, KVH, D, T, n_pages=128, frag=0.3):
    return random_pool_case(np.random.default_rng(seed), PagedKVAllocator,
                            B, H, KVH, D, T, n_pages, frag)


def _both(arrays, jdtype=jnp.float32, tdtype=torch.float32):
    return ([jnp.asarray(a, jdtype) for a in arrays],
            [torch.from_numpy(a).to(tdtype) for a in arrays])


@pytest.mark.parametrize("B,H,KVH,D,T", PAGED_SHAPES)
@pytest.mark.parametrize("K_classes", PAGED_K_CLASSES)
def test_paged_attention_matches_jax(B, H, KVH, D, T, K_classes):
    q, kp, vp, bt, lens = _case(B * 100 + D, B, H, KVH, D, T)
    (jq, jk, jv), (tq, tk, tv) = _both((q, kp, vp))
    want = j_ops.paged_attention(jq, jk, jv, bt, jnp.asarray(lens),
                                 page_size=T, K_classes=K_classes,
                                 interpret=True)
    got = t_ops.paged_attention(tq, tk, tv, bt, lens, page_size=T,
                                K_classes=K_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dense = t_ref.paged_attention_ref(tq, tk, tv, bt, lens, T)
    np.testing.assert_allclose(
        dense.numpy(), np.asarray(j_ref.paged_attention_ref(
            jq, jk, jv, jnp.asarray(bt), jnp.asarray(lens), T)), **TOL)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_dtypes_match_jax(dtype):
    q, kp, vp, bt, lens = _case(5, 2, 4, 2, 64, 16, frag=0.2)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    (jq, jk, jv), (tq, tk, tv) = _both((q, kp, vp), jdt, tdt)
    want = j_ops.paged_attention(jq, jk, jv, bt, jnp.asarray(lens),
                                 page_size=16, K_classes=(2,),
                                 interpret=True)
    got = t_ops.paged_attention(tq, tk, tv, bt, lens, page_size=16,
                                K_classes=(2,))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(TOL if dtype == "float32" else TOL_BF16))


@pytest.mark.parametrize("seed", range(6))
def test_paged_attention_any_fragmentation(seed):
    """``test_paged_attention_any_fragmentation``'s property on seeded
    draws of (fragmentation, psi): exact for any contiguity pattern and any
    K Algorithm 3 picks, in both packages."""
    rng = np.random.default_rng(seed)
    frag, psi = float(rng.random()), int(rng.integers(1, 5))
    q, kp, vp, bt, lens = _case(1000 + seed, 2, 4, 2, 32, 8, 64, frag)
    runs = np.diff(np.flatnonzero(np.diff(np.concatenate(
        [[-9], bt[0][bt[0] >= 0]])) != 1))
    K = tuple(choose_kernel_classes(
        {int(s): 1 for s in runs if s > 0} or {1: 1}, psi=psi))
    (jq, jk, jv), (tq, tk, tv) = _both((q, kp, vp))
    want = j_ops.paged_attention(jq, jk, jv, bt, jnp.asarray(lens),
                                 page_size=8, K_classes=K, interpret=True)
    got = t_ops.paged_attention(tq, tk, tv, bt, lens, page_size=8,
                                K_classes=K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref = t_ref.paged_attention_ref(tq, tk, tv, bt, lens, 8)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("B,H,KVH,D,T", PAGED_SHAPES)
def test_class_pass_matches_jax_kernel(B, H, KVH, D, T):
    """Each class's unnormalised (o, m, l) — the contract the CUDA kernel
    is held to — equals the Pallas kernel's, with rows whose last covered
    windows lie wholly past kv_lens (pages reserved for tokens not yet
    generated: m = -1e30 semantics) and an inactive row."""
    q, kp, vp, bt, lens = _case(7 + D, B, H, KVH, D, T)
    bt = np.concatenate([bt, np.full((1, bt.shape[1]), -1, bt.dtype)])
    q = np.concatenate([q, q[:1]])
    lens = np.concatenate([lens // 3, [0]]).astype(np.int32)
    (jq, jk, jv), (tq, tk, tv) = _both((q, kp, vp))
    desc = t_ops.build_descriptors(bt, (3, 1))
    for k, (wi, cov) in desc.items():
        want = j_pa.paged_attention_class_pass(
            jq, jk, jv, jnp.asarray(wi), jnp.asarray(cov),
            jnp.asarray(lens), pages_per_block=1 << k, page_size=T,
            interpret=True)
        got = t_ops.paged_attention_class_pass(
            tq, tk, tv, wi, cov, lens, pages_per_block=1 << k, page_size=T)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        o, m, l = got
        assert torch.all(o[-1] == 0) and torch.all(m[-1] == -1e30) \
            and torch.all(l[-1] == 0)
    parts_t = [t_ops.paged_attention_class_pass(
        tq, tk, tv, *desc[k], lens, pages_per_block=1 << k, page_size=T)
        for k in (3, 1, 0)]
    parts_j = [tuple(jnp.asarray(x.numpy()) for x in p) for p in parts_t]
    np.testing.assert_allclose(t_ops.merge_partials(parts_t).numpy(),
                               np.asarray(j_pa.merge_partials(parts_j)),
                               **TOL)


def test_gather_kv_matches_jax():
    q, kp, vp, bt, lens = _case(3, 2, 4, 2, 32, 8)
    want = j_ref.gather_kv(jnp.asarray(kp), jnp.asarray(bt), 8)
    got = t_ref.gather_kv(torch.from_numpy(kp), bt, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_host_checks_reject_what_the_kernel_cannot_take():
    wi = np.array([[0, 3], [1, 0]], np.int32)
    cov = np.array([[1, 1], [1, 0]], np.int8)
    t_ops.check_descriptor(wi, cov, 16, 2)            # 4 windows: in range
    with pytest.raises(ValueError, match="outside"):
        t_ops.check_descriptor(wi, cov, 12, 2)        # 3 windows
    wi[1, 1] = 99                                     # uncovered: not read
    t_ops.check_descriptor(wi, cov, 16, 2)
    with pytest.raises(ValueError, match="split"):
        t_ops.check_descriptor(wi, cov, 18, 2)
    with pytest.raises(ValueError, match="shape"):
        t_ops.check_descriptor(wi, cov[:, :1], 16, 2)
    with pytest.raises(ValueError, match="pool size"):
        prep = t_ops.prepare_descriptors({0: (wi * 0, cov)}, (0,), 16,
                                         "cpu")
        z = torch.zeros((2, 4, 16))
        t_ops.paged_attention(z, torch.zeros((8, 4, 1, 16)),
                              torch.zeros((8, 4, 1, 16)), None, [1, 1],
                              page_size=4, descriptors=prep)


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, kp, vp, bt, lens = _case(11, 2, 4, 2, 32, 8)
    n0 = t_ops.LAUNCHES["paged_attention"]
    t_ops.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                          torch.from_numpy(vp), bt, lens, page_size=8,
                          K_classes=(2,))
    assert t_ops.LAUNCHES["paged_attention"] == n0
    assert t_ops.classes_of((2, 1, 2)) == (2, 1, 0)
