"""The port's tensor-parallel pieces in one process, against plain torch
and the JAX package.

Without a group, or with a group of one rank, every Megatron operator of
``repro_torch.distributed.tensor_parallel`` is the identity (the
unsharded model runs the same code); the vocabulary-parallel
cross-entropy equals JAX's ``cross_entropy`` and its gradient
``jax.grad``'s, padding classes included; ``kv_heads_of`` gives the KV
heads a rank's query heads read in each GQA case (a slice of whole
groups, one head shared by several ranks, one head per query head where
neither count divides the other), and attention over a rank's heads
equals the whole attention's heads; ``paired_halves``' exchange plan
(``paired_plan``) at tp 1-4 against numpy slicing of the fused leaf;
the sharded step's plan (``keeps_model_shard``) keeps each leaf's model
shard, the Mamba, mLSTM and sLSTM mixers' included, except attention
and xLSTM mixers whose heads split mid-head and leaves the model axis
splits on a dimension the layers do not split
(``whole_along_model``'s reasons).  The same
operators across gloo ranks are in ``tests/test_torch_distributed.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import cross_entropy as j_cross_entropy
from repro_torch.checkpoint.checkpointer import leaf_paths
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as TS
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import RunConfig, model_specs
from repro_torch.models import model as TM
from repro_torch.models.common import logical_tree, spec_shapes
from repro_torch.models.layers import chunked_attention, kv_heads_of

ONE = TP.ModelGroup(group=None, size=1, rank=0)


@pytest.mark.parametrize("mg", [None, ONE])
def test_operators_are_identity_without_a_group(mg):
    """No group, or one rank: every operator returns its plain
    counterpart's values and gradients, with no collective."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    for op in (TP.copy_to_model, TP.reduce_from_model,
               TP.gather_from_model):
        a = x.clone().requires_grad_(True)
        y = op(a, mg)
        assert torch.equal(y, x)
        (y * 2.0).sum().backward()
        assert torch.equal(a.grad, torch.full_like(x, 2.0))
    table = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 16, (2, 7)))
    assert torch.equal(TP.vocab_parallel_embed(table, tokens, mg),
                       table[tokens])


@pytest.mark.parametrize("pad", [0, 24])
def test_vocab_parallel_nll_matches_jax_cross_entropy(pad):
    """The cross-entropy per position, ``log sum exp(z - m) + m -
    z[label]`` with ``m`` outside the graph, equals JAX's
    ``cross_entropy`` (mean and masked mean) within 1e-6 relative, and
    its gradient ``jax.grad``'s within 1e-7, with ``pad`` classes at the
    model's ``-1e9`` padding bias."""
    rng = np.random.default_rng(1)
    V = 40 + pad
    z = (rng.standard_normal((2, 9, V)) * 3).astype(np.float32)
    z[..., V - pad:] += -1e9
    labels = rng.integers(0, V - pad, (2, 9))
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32)
    zt = torch.from_numpy(z).requires_grad_(True)
    nll = TP.vocab_parallel_nll(zt, torch.from_numpy(labels), None)
    got = (nll * torch.from_numpy(mask)).sum() / float(mask.sum())
    got.backward()
    jz, jl, jm = jnp.asarray(z), jnp.asarray(labels), jnp.asarray(mask)
    want = float(j_cross_entropy(jz, jl, jm))
    assert abs(got.item() - want) <= 1e-6 * abs(want)
    assert abs(nll.mean().item() - float(j_cross_entropy(jz, jl))) <= \
        1e-6 * abs(want)
    grad = np.asarray(jax.grad(lambda a: j_cross_entropy(a, jl, jm))(jz))
    np.testing.assert_allclose(zt.grad.numpy(), grad, rtol=0, atol=1e-7)


@pytest.mark.parametrize("mg", [None, ONE])
def test_paired_halves_and_reduce_scatter_are_identity_without_a_group(mg):
    """No group, or one rank: ``paired_halves`` returns the fused leaf
    itself (its x and z halves are the whole ones) and
    ``reduce_scatter_to_model`` its input, values and gradients, and
    ``gather_from_model`` along any dimension likewise."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32))
    a = w.clone().requires_grad_(True)
    y = TP.paired_halves(a, mg)
    assert y is a or torch.equal(y, w)
    (y * 3.0).sum().backward()
    assert torch.equal(a.grad, torch.full_like(w, 3.0))
    x = torch.from_numpy(rng.standard_normal((2, 5, 4)).astype(np.float32))
    for dim in (0, 1, -1):
        for op in (TP.reduce_scatter_to_model, TP.gather_from_model):
            a = x.clone().requires_grad_(True)
            y = op(a, mg, dim)
            assert torch.equal(y, x)
            (y * 2.0).sum().backward()
            assert torch.equal(a.grad, torch.full_like(x, 2.0))


@pytest.mark.parametrize("tp", [1, 2, 3, 4])
def test_paired_plan_matches_numpy_slicing(tp):
    """``paired_plan``'s all-to-all, played out in numpy on a fused ``[d,
    2 n]`` leaf cut into ``tp`` contiguous column shards (as the rules
    place it): rank s receives, in rank order, exactly the columns of its
    x block ``[s u, (s + 1) u)`` followed by its z block ``[n + s u, n +
    (s + 1) u)``; every column of a shard goes to one rank (a rank sends
    its own shard, no more); the reverse exchange puts each column back
    where it came from (the backward).  tp 3 splits x and z across a
    shard; n not divisible by tp raises."""
    d, n = 3, 12
    w = np.arange(d * 2 * n, dtype=np.float32).reshape(d, 2 * n)
    width, u = 2 * n // tp, n // tp
    shards = [w[:, r * width:(r + 1) * width] for r in range(tp)]
    plan = TP.paired_plan(2 * n, tp)
    got = [[] for _ in range(tp)]
    for r in range(tp):
        sent = [c for parts in plan[r] for a, b in parts
                for c in range(a, b)]
        assert sorted(sent) == list(range(width))
        for s_ in range(tp):
            for a, b in plan[r][s_]:
                got[s_].append(shards[r][:, a:b])
    for s_ in range(tp):
        want = np.concatenate([w[:, s_ * u:(s_ + 1) * u],
                               w[:, n + s_ * u:n + (s_ + 1) * u]], axis=1)
        mine = np.concatenate(got[s_], axis=1)
        assert np.array_equal(mine, want), (tp, s_)
        # the reverse exchange: each received block back to its owner
        i = 0
        for r in range(tp):
            for a, b in plan[r][s_]:
                assert np.array_equal(mine[:, i:i + b - a],
                                      shards[r][:, a:b])
                i += b - a
    if tp == 3:     # rank 1's shard: rank 2's x block, rank 0's z block
        assert plan[1] == [[(u, 2 * u)], [], [(0, u)]]
    with pytest.raises(ValueError):
        TP.paired_plan(2 * 10, 4)


def test_whole_along_model_reasons():
    """The reasons left: heads that do not split over the model ranks
    (attention, mLSTM, sLSTM: the reduced xLSTM's 2 heads over 4 ranks),
    Mamba channels that do not (the reduced Jamba's 256 over 3); none for
    a recurrent mixer whose heads or channels divide, nor outside the
    blocks."""
    x = get_config("xlstm-350m", True)
    j = get_config("jamba-1.5-large-398b", True)
    for path in ("blocks/pos0/mlstm/up_proj", "blocks/pos5/slstm/w_i"):
        assert TM.whole_along_model(x, path, 2) is None
        assert "2 heads do not split over 4" in TM.whole_along_model(
            x, path, 4)
    assert TM.whole_along_model(j, "blocks/pos0/mamba/in_proj", 4) is None
    assert TM.whole_along_model(j, "blocks/pos0/mamba/in_proj", 2) is None
    assert "256 Mamba channels do not split over 3" in TM.whole_along_model(
        j, "blocks/pos0/mamba/in_proj", 3)
    assert "do not split" in TM.whole_along_model(j, "blocks/pos4/attn/wq",
                                                  3)
    assert TM.whole_along_model(j, "embed", 3) is None
    assert TM.whole_along_model(j, "blocks/pos1/moe/w_up", 3) is None


def test_splits_says_whole_or_shard():
    """A weight dimension arrives whole (no split) or as one model rank's
    shard; any other width raises."""
    four = TP.ModelGroup(group=None, size=4, rank=1)
    assert not TP.splits(None, 8, 8) and not TP.splits(four, 8, 8)
    assert TP.splits(four, 2, 8)
    for mg, local in ((four, 3), (None, 4), (ONE, 4)):
        with pytest.raises(ValueError):
            TP.splits(mg, local, 8)


@pytest.mark.parametrize("heads", [(16, 8, 4), (4, 2, 4), (6, 2, 3),
                                   (4, 4, 2)])
def test_kv_heads_of_each_rank_attends_like_the_whole(heads):
    """Query heads split over ``tp`` ranks (H / tp each): InternLM2's
    16 / 8 at tp 4 (each rank reads 2 KV heads), the reduced 4 / 2 at tp 4
    (2 ranks share each KV head), 6 / 2 at tp 3 (groups of 3 over ranks
    of 2: a KV head per query head), MHA.  A rank's KV heads are views
    where whole groups or one shared head serve it; its attention equals
    the whole attention's heads, causal and not."""
    H, KVH, tp = heads
    G, Hl = H // KVH, H // tp
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 24, n, 16))
                                .astype(np.float32)) for n in (H, KVH, KVH))
    for causal in (True, False):
        whole = chunked_attention(q, k, v, causal=causal, q_chunk=8,
                                  kv_chunk=8)
        for r in range(tp):
            kl = kv_heads_of(k, r * Hl, Hl, G)
            vl = kv_heads_of(v, r * Hl, Hl, G)
            if Hl % G == 0 or G % Hl == 0:
                assert kl.untyped_storage().data_ptr() == \
                    k.untyped_storage().data_ptr()
            reads = [(r * Hl + j) // G for j in range(Hl)]
            per = Hl // kl.shape[2]
            for j, kv in enumerate(reads):
                assert torch.equal(kl[:, :, j // per], k[:, :, kv])
            got = chunked_attention(q[:, :, r * Hl:(r + 1) * Hl], kl, vl,
                                    causal=causal, q_chunk=8, kv_chunk=8)
            np.testing.assert_allclose(
                got.numpy(), whole[:, :, r * Hl:(r + 1) * Hl].numpy(),
                rtol=0, atol=1e-6)


def _plan(cfg, sizes, rules="default"):
    """``{path: kept}`` of ``keeps_model_shard`` over every leaf of the
    reduced arch's specs on a ("data", "model") mesh of ``sizes``, and
    which leaves the model axis splits at all."""
    specs = model_specs(cfg, RunConfig())
    mesh = TS.MeshShape(("data", "model"), sizes)
    psh = dict(leaf_paths(TS.param_sharding(logical_tree(specs),
                                            spec_shapes(specs), mesh, rules)))
    kept, split = {}, set()
    for path, sp in leaf_paths(specs):
        if TS.model_range(sp.shape, psh[path], (0, 0)) is not None:
            split.add(path)
        kept[path] = TM.keeps_model_shard(cfg, path, sp.logical, sp.shape,
                                          psh[path])
    return kept, split


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_keeps_model_shards(arch):
    """On (2,4) and (1,2): every leaf the model axis splits is computed on
    as the rank's shard (the Mamba, mLSTM and sLSTM mixers' too), except,
    where ``n_heads`` does not split over the model ranks, those of
    attention and of the xLSTM mixers (the reduced xLSTM's 2 heads over 4
    ranks); no leaf the model axis leaves whole is marked kept."""
    cfg = get_config(arch, True)
    for sizes in ((2, 4), (1, 2)):
        kept, split = _plan(cfg, sizes)
        assert split, arch
        for path, k in kept.items():
            headed = any(f"/{m}/" in path for m in TM.HEADED_MIXERS)
            mid = headed and cfg.n_heads % sizes[1]
            assert k == (path in split and not mid), path
        mixers = [p for p in split if any(f"/{m}/" in p for m in
                                          ("mamba", "mlstm", "slstm"))]
        assert bool(mixers) == (cfg.family in ("hybrid", "xlstm"))
        if mixers:
            assert all(kept[p] for p in mixers) == (
                cfg.family == "hybrid" or sizes[1] == 2), arch
        assert kept["embed"] and kept.get("lm_head", True)


def test_plan_mid_head_and_other_rules():
    """6 heads of 32 over 4 model ranks: the rules split ``wq`` / ``wo`` by
    ``q_dim`` (192 into 48 columns, a head and a half), and the plan
    gathers both whole while the MLP keeps its shards.  Under the
    ``embed_2d`` rules the model axis splits ``embed``, a dimension no
    layer splits: those leaves (the MLP's, ``lm_head``, which the rules
    split on ``embed`` before ``vocab``) are gathered whole, the
    embedding's vocabulary shard kept."""
    cfg = dataclasses.replace(get_config("internlm2-1.8b", True),
                              n_heads=6, n_kv_heads=2)
    kept, split = _plan(cfg, (1, 4))
    for name in ("wq", "wo"):
        path = f"blocks/pos0/attn/{name}"
        assert path in split and not kept[path]
        assert "do not split" in TM.whole_along_model(cfg, path, 4)
    assert kept["blocks/pos0/mlp/w_down"] and kept["embed"]
    cfg = get_config("internlm2-1.8b", True)
    kept, split = _plan(cfg, (2, 2), "embed_2d")
    assert not kept["blocks/pos0/mlp/w_gate"]
    assert "blocks/pos0/mlp/w_gate" in split
    assert kept["embed"] and "lm_head" in split and not kept["lm_head"]


def test_model_range_is_local_slices():
    """``model_range`` is the model axis's dimension and, at every
    coordinate, ``local_slices``' slice of it; None where the model axis
    splits nothing."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = TS.MeshShape(("data", "model"), (2, 4))
    sh = TS.Sharding(mesh, (Shard(0), Shard(1)))
    for c in ((0, 0), (1, 3), (0, 2)):
        dim, sl = TS.model_range((8, 16), sh, c)
        assert dim == 1 and sl == TS.local_slices((8, 16), sh, c)[1]
        assert sl == slice(4 * c[1], 4 * c[1] + 4)
    assert TS.model_range((8, 16), TS.Sharding(mesh, (Shard(0),
                                                      Replicate())),
                          (0, 0)) is None
