"""The port's training stack against the JAX package's, on the CPU.

Same numpy weights (the port's seeded ``init_params_numpy``) and the same
batches (the data pipeline's ``_batch_at``, which both packages draw
alike) through ``repro.models`` / ``repro.optim`` / ``repro.train`` and
their ports: the loss and its gradients (the global norm and every leaf
by path), one ``train_step`` per optimizer kind with and without
microbatches, the pipeline's batches, the checkpointer (round trip,
atomicity, GC) and the trainer's crash/restart continuation at
``tests/test_train.py``'s sizes.  Tolerances, f32: losses ``5e-5``; a
gradient leaf within ``2e-4`` of its largest element plus ``1e-6`` (the
mLSTM's chunkwise form rounds its sums otherwise than the reference's
steps); a parameter after one step within ``1e-4`` (a tenth of the
learning rate: AdamW moves a weight by about lr whatever the size of its
gradient, so a gradient near 0 summed in another order can move it
otherwise).  Archs marked slow as ``tests/test_models.py`` marks them.
"""
import functools
import json
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.data import PipelineConfig as JPipelineConfig
from repro.data.pipeline import _batch_at as j_batch_at
from repro.models import Model as JModel
from repro.models import RunConfig as JRunConfig
from repro.optim import OptConfig as JOptConfig
from repro.optim import apply_opt as j_apply_opt
from repro.optim import init_opt as j_init_opt
from repro.optim import optimizer as JO
from repro.train import make_train_step as j_make_train_step
from repro.train.train_step import loss_fn as j_loss_fn
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import DataPipeline, PipelineConfig
from repro_torch.data.pipeline import _batch_at
from repro_torch.models import Model, RunConfig, params_from_numpy
from repro_torch.distributed.sharding import MeshShape, param_sharding
from repro_torch.models.common import logical_tree, spec_shapes, tree_leaves
from repro_torch.optim import OptConfig, apply_opt, init_opt
from repro_torch.optim import optimizer as TO
from repro_torch.train import (SimulatedFailure, Trainer, TrainerConfig,
                               make_train_step)
from repro_torch.train.train_step import grads_of

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNKS = dict(attn_q_chunk=32, attn_kv_chunk=32, scan_chunk=16,
              compute_dtype="float32")
HEAVY_ARCHS = {"jamba-1.5-large-398b"}
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _arch_params(archs, extra_slow=()):
    return [pytest.param(a, marks=pytest.mark.slow)
            if (a in HEAVY_ARCHS or a in extra_slow) else a for a in archs]


def _setup(arch, **rc):
    tm = Model(get_config(arch, True), RunConfig(**dict(CHUNKS, **rc)))
    jm = JModel(j_config(arch, True), JRunConfig(**dict(CHUNKS, **rc)))
    P = tm.init_numpy(0)
    b = _batch_at(tm.cfg, PipelineConfig(batch=2, seq=32), 3)
    return tm, jm, P, b


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _leaf_map(tree):
    return dict(tree_leaves(jax.tree.map(np.asarray, tree)))


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", _arch_params(ARCH_IDS))
def test_loss_and_grads_match_jax(arch):
    """``loss_fn`` and its gradients == ``jax.value_and_grad`` of the JAX
    package's: the loss, the MoE aux loss, the global norm and every leaf
    by path (the encoder's unused token embedding gets zeros, as there)."""
    tm, jm, P, b = _setup(arch)
    (_, jmet), jg = jax.value_and_grad(
        functools.partial(j_loss_fn, jm), has_aux=True)(
            jax.tree.map(jnp.asarray, P), _jb(b))
    tg, tmet = grads_of(tm, params_from_numpy(P, device="cpu"), _tb(b))
    for key in ("loss", "aux"):
        assert abs(float(tmet[key]) - float(jmet[key])) <= 5e-5 * (
            1 + abs(float(jmet[key])))
    jn = float(JO.global_norm(jg))
    assert abs(float(TO.global_norm(tg)) - jn) <= 1e-4 * jn
    want = _leaf_map(jg)
    got = dict(tree_leaves(tg))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = want[path]
        assert g.shape == w.shape and g.dtype == torch.float32, path
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=2e-4 * float(np.abs(w).max()) + 1e-6, err_msg=str(path))
    if tm.cfg.family == "encoder":
        assert not bool(got[("embed",)].any())


def test_loss_is_chunked_cross_entropy():
    """The chunked loss == ``cross_entropy`` of the whole logits with the
    padded vocabulary masked, for any chunk size, and its backward
    reaches the same gradients (each chunk recomputed)."""
    from repro_torch.models.model import cross_entropy
    tm, _, P, b = _setup("internlm2-1.8b")
    tp = params_from_numpy(P, device="cpu")
    toks, labels = torch.from_numpy(b["tokens"]), torch.from_numpy(
        b["labels"])
    mask = torch.from_numpy((np.arange(64).reshape(2, 32) % 3 > 0)
                            .astype(np.float32))
    with torch.no_grad():
        logits, _ = tm.forward(tp, toks)
        want = cross_entropy(logits, labels, mask)
    grads = []
    for chunk in (5, 32, 512):
        leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()
                  if k != "blocks"}
        leaves["blocks"] = tp["blocks"]
        loss, _ = tm.loss(leaves, toks, labels, mask=mask, xent_chunk=chunk)
        assert abs(float(loss.detach()) - float(want)) <= 1e-5
        loss.backward()
        grads.append(leaves["lm_head"].grad)
    for g in grads[1:]:
        torch.testing.assert_close(g, grads[0], atol=1e-7, rtol=1e-5)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((6, 300)) * scale).astype(np.float32),
            "blk": {"b": (rng.standard_normal(7) * scale).astype(np.float32),
                    "m": (rng.standard_normal((2, 5, 9)) * scale).astype(
                        np.float32)}}


@pytest.mark.parametrize("kind", ["adamw", "adamw8bit", "adafactor"])
def test_optimizer_steps_match_jax(kind):
    """Three ``apply_opt`` steps from the same params and gradients ==
    the JAX package's: params, state and the pre-clip norm (the first
    step's gradient clipped by the global norm)."""
    rng = np.random.default_rng(0)
    P = _tree(rng)
    G = [_tree(rng, scale) for scale in (3.0, 0.1, 0.01)]
    kw = dict(OPT, kind=kind, weight_decay=0.1, clip_norm=1.0)
    joc, toc = JOptConfig(**kw), OptConfig(**kw)
    jp, tp = jax.tree.map(jnp.asarray, P), params_from_numpy(P, "cpu")
    js, ts = j_init_opt(joc, jp), init_opt(toc, tp)
    for step, g in enumerate(G):
        jp, js, jn = j_apply_opt(joc, jax.tree.map(jnp.asarray, g), js, jp,
                                 jnp.int32(step + 1))
        tp, ts, tn = apply_opt(toc, params_from_numpy(g, "cpu"), ts, tp,
                               step + 1)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    want, got = _leaf_map(jp), dict(tree_leaves(tp))
    for path in want:
        np.testing.assert_allclose(got[path].numpy(), want[path], atol=2e-6,
                                   rtol=0, err_msg=str(path))
    for field, jleaf in zip(ts._fields, js):
        if jleaf is None:
            assert getattr(ts, field) is None
            continue
        w, g_ = _leaf_map(jleaf), dict(tree_leaves(getattr(ts, field)))
        for path in w:
            np.testing.assert_allclose(g_[path].float().numpy(),
                                       np.asarray(w[path], np.float32),
                                       atol=1e-5, rtol=1e-3,
                                       err_msg=f"{field} {path}")


@pytest.mark.parametrize("n", [5, 255, 256, 600])
def test_q8_equals_jax_bit_for_bit(n):
    """int8 blocks of 256 with per-block scales, ``round`` half to even
    (exact halves included): q and scale equal the JAX package's."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((3, n)) * 10).astype(np.float32)
    # row 0's first block: amax 63.5, so scale 0.5 and x / scale lands on
    # halves 2.5, 3.5, -0.5 (half to even: 2, 4, -0)
    x[0, :5] = [63.5, 1.25, 1.75, -0.25, 0.75]
    x[0, 5:] = np.clip(x[0, 5:], -60, 60)
    jq, js = JO._q8(jnp.asarray(x))
    tq, ts = TO._q8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TO._dq8(tq, ts, x.shape).numpy(),
        np.asarray(JO._dq8(jq, js, x.shape)))


def test_schedule_and_global_norm_match_jax():
    """The warmup-cosine schedule and the global norm, leaves summed in the
    JAX leaf order (dict keys sorted)."""
    oc = dict(lr=3e-4, warmup_steps=7, total_steps=50, min_lr_frac=0.1)
    for step in (0, 1, 6, 7, 8, 30, 49, 50, 80):
        want = float(JO.schedule(JOptConfig(**oc), jnp.int32(step)))
        assert float(TO.schedule(OptConfig(**oc), step)) == \
            pytest.approx(want, rel=1e-6, abs=1e-12)
    tree = {"z": np.full(3, 2.0, np.float32), "a": {"y": np.ones(4,
                                                                 np.float32),
                                                    "b": np.zeros(2,
                                                                  np.float32)}}
    assert [float(x.sum()) for x in TO.sorted_leaves(
        params_from_numpy(tree, "cpu"))] == [0.0, 4.0, 6.0]
    assert float(TO.global_norm(params_from_numpy(tree, "cpu"))) == \
        pytest.approx(float(JO.global_norm(jax.tree.map(jnp.asarray,
                                                        tree))), rel=1e-7)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _train_step_both(arch, kind, micro):
    tm, jm, P, b = _setup(arch, microbatches=micro)
    joc, toc = JOptConfig(kind=kind, **OPT), OptConfig(kind=kind, **OPT)
    jp = jax.tree.map(jnp.asarray, P)
    jp2, _, jmet = j_make_train_step(jm, joc)(jp, j_init_opt(joc, jp),
                                              _jb(b), jnp.int32(1))
    tp = params_from_numpy(P, device="cpu")
    tp2, _, tmet = make_train_step(tm, toc)(tp, init_opt(toc, tp), _tb(b), 1)
    for key in ("loss", "aux"):
        assert abs(float(tmet[key]) - float(jmet[key])) <= 5e-5 * (
            1 + abs(float(jmet[key])))
    assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) <= \
        1e-4 * float(jmet["grad_norm"])
    want, got = _leaf_map(jp2), dict(tree_leaves(tp2))
    moved = False
    for path, w in want.items():
        np.testing.assert_allclose(got[path].numpy(), w, atol=1e-4, rtol=0,
                                   err_msg=str(path))
        moved |= not np.array_equal(got[path].numpy(), P_leaf(P, path))
    assert moved


def P_leaf(P, path):
    for part in path:
        P = P[part]
    return P


@pytest.mark.parametrize("arch", _arch_params(
    ARCH_IDS, extra_slow=("xlstm-350m",)))
def test_train_step_matches_jax(arch):
    """One AdamW ``train_step`` of every arch == the JAX package's:
    metrics and every parameter after the step."""
    _train_step_both(arch, "adamw", 1)


@pytest.mark.parametrize("kind", ["adamw", "adamw8bit", "adafactor"])
@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_per_optimizer_and_microbatches(kind, micro):
    """One ``train_step`` per optimizer kind, with and without
    microbatches (gradients accumulated in ``grad_dtype``, then divided),
    == the JAX package's; the encoder's masked loss with two."""
    _train_step_both("internlm2-1.8b", kind, micro)
    if micro == 2 and kind == "adamw":
        _train_step_both("hubert-xlarge", kind, micro)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["internlm2-1.8b", "hubert-xlarge",
                                  "llava-next-34b"])
def test_pipeline_batches_equal_jax(arch):
    """``_batch_at`` and the prefetching pipeline give the JAX package's
    batches element for element (token, encoder and VLM batches), and a
    restore continues from the restored step."""
    cfg = get_config(arch, True)
    pc = dict(batch=3, seq=20, seed=4, prefetch=2)
    for step in (0, 5):
        want = j_batch_at(j_config(arch, True), JPipelineConfig(**pc), step)
        got = _batch_at(cfg, PipelineConfig(**pc), step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    pipe = DataPipeline(cfg, PipelineConfig(**pc), device="cpu")
    try:
        first = [next(pipe) for _ in range(3)]
        assert pipe.state() == {"step": 3}
        pipe.restore({"step": 1})
        again = next(pipe)
        pipe.restore({"step": 5})
        later = next(pipe)
    finally:
        pipe.close()
    assert pipe._thread is None
    for k in first[1]:
        assert torch.equal(first[1][k], again[k])
        np.testing.assert_array_equal(
            later[k].numpy(), j_batch_at(j_config(arch, True),
                                         JPipelineConfig(**pc), 5)[k])


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_gc():
    """Leaves of every dtype the trainer keeps (f32, bf16, int8; a
    NamedTuple with a None field) come back equal, into ``target``'s
    structure or as nested dicts of the saved paths; ``keep`` drops the
    oldest complete checkpoint."""
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2)
        tree = {"a": torch.arange(10, dtype=torch.bfloat16),
                "b": {"c": torch.ones((3, 3), dtype=torch.int8),
                      "d": torch.randn(2, 5)},
                "opt": TO.AdamState({"x": torch.zeros(4)}, {"x": torch.ones(4)},
                                    None)}
        for step in (1, 2, 3):
            ck.save(step, tree, extras={"step": step}, blocking=True)
        assert ck.latest_step() == 3
        got, extras = ck.restore(target=tree, device="cpu")
        assert extras["step"] == 3
        assert isinstance(got["opt"], TO.AdamState) and got["opt"].m_scale \
            is None
        for (pa, a), (pb, b) in zip(tree_leaves(got["b"]),
                                    tree_leaves(tree["b"])):
            assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)
        assert got["a"].dtype == torch.bfloat16 and torch.equal(got["a"],
                                                                tree["a"])
        assert torch.equal(got["opt"].v["x"], tree["opt"].v["x"])
        plain, _ = ck.restore(2, device="cpu")
        assert torch.equal(plain["opt"]["m"]["x"], torch.zeros(4))
        assert not os.path.exists(os.path.join(d, "step_00000001"))
        with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
            paths = [x["path"] for x in json.load(f)["leaves"]]
        assert paths == ["a", "b/c", "b/d", "opt/m/x", "opt/v/x"]


def test_checkpoint_atomicity_tmp_cleanup_and_async_copy():
    """A partial save (a ``.tmp-`` directory) is invisible and collected;
    an async save writes the values the tree held when ``save`` was
    called, even if the caller then changes its tensors in place."""
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(os.path.join(d, "step_00000009.tmp-deadbeef"))
        ck = Checkpointer(d)
        assert ck.latest_step() is None
        assert not any(".tmp-" in n for n in os.listdir(d))
        t = {"w": torch.zeros(1000)}
        ck.save(4, t)
        t["w"].fill_(7.0)
        ck.wait()
        got, _ = ck.restore(4, target=t, device="cpu")
        assert not bool(got["w"].any())


@pytest.mark.parametrize("entry", ["restore", "pipeline", "trainer"])
def test_training_entry_points_default_to_the_card(entry):
    """Without a ``device`` the checkpointer's restore, the data pipeline
    and the trainer put their tensors on the card, as every entry point of
    the port does: with no card they raise instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = get_config("internlm2-1.8b", reduced=True)
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        ck.save(1, {"w": torch.zeros(3)}, blocking=True)
        with pytest.raises(RuntimeError, match="cuda"):
            if entry == "restore":
                ck.restore()
            elif entry == "pipeline":
                DataPipeline(cfg, PipelineConfig(batch=2, seq=16))
            else:
                pipe = DataPipeline(cfg, PipelineConfig(batch=2, seq=16),
                                    device="cpu")
                try:
                    Trainer(Model(cfg, RunConfig()), OptConfig(),
                            TrainerConfig(ckpt_dir=d), pipe)
                finally:
                    pipe.close()


# ---------------------------------------------------------------------------
# trainer fault tolerance (tests/test_train.py's sizes)
# ---------------------------------------------------------------------------

def _make_trainer(d, total, fail_at=None):
    cfg = get_config("internlm2-1.8b", reduced=True)
    model = Model(cfg, RunConfig(attn_q_chunk=32, attn_kv_chunk=32,
                                 scan_chunk=16))
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    tc = TrainerConfig(total_steps=total, ckpt_every=3, ckpt_dir=d,
                       log_every=1)
    hook = None
    if fail_at is not None:
        def hook(step):
            if step == fail_at:
                raise SimulatedFailure(f"injected at {step}")
    pipe = DataPipeline(cfg, PipelineConfig(batch=2, seq=16), device="cpu")
    return Trainer(model, oc, tc, pipe, failure_hook=hook, device="cpu")


def test_restart_is_a_deterministic_continuation():
    """Crash at step 4, restart from the step-3 checkpoint: the resumed
    run logs steps 3-5 and its losses and grad norms equal the straight
    run's bit for bit on the CPU."""
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        t0 = _make_trainer(d1, total=6)
        full = t0.run()
        t0.pipeline.close()
        t1 = _make_trainer(d2, total=6, fail_at=4)
        with pytest.raises(SimulatedFailure):
            t1.run()
        t1.ckpt.wait()
        t1.pipeline.close()
        assert t1.ckpt.latest_step() == 3
        t2 = _make_trainer(d2, total=6)
        resumed = t2.run()
        t2.pipeline.close()
        assert [m["step"] for m in resumed["metrics"]] == [3, 4, 5]
        a = {m["step"]: (m["loss"], m["grad_norm"]) for m in full["metrics"]}
        for m in resumed["metrics"]:
            assert (m["loss"], m["grad_norm"]) == a[m["step"]]
        assert t2.ckpt.latest_step() == 6


def test_straggler_watchdog_and_sharding_refused():
    """A step slower than ``straggler_factor`` times the EWMA is recorded;
    ``param_shardings`` that place nothing (built over a ``MeshShape``,
    which has no devices) are refused: sharded training needs a
    ``DeviceMesh`` (``tests/test_torch_distributed.py`` trains on one)."""
    with tempfile.TemporaryDirectory() as d:
        tr = _make_trainer(d, total=8)
        orig, calls = tr.train_step, {"n": 0}

        def slow(*a, **k):
            calls["n"] += 1
            if calls["n"] == 6:
                time.sleep(1.0)
            return orig(*a, **k)
        tr.train_step = slow
        tr.run()
        tr.pipeline.close()
        assert len(tr.straggler_steps) >= 1
        specs = tr.model.specs()
        shapes_only = param_sharding(logical_tree(specs), spec_shapes(specs),
                                     MeshShape(("data", "model"), (1, 1)))
        with pytest.raises(ValueError, match="DeviceMesh"):
            Trainer(tr.model, tr.opt_cfg, tr.tc, tr.pipeline,
                    param_shardings=shapes_only, device="cpu")


# ---------------------------------------------------------------------------
# chip_smoke.py's T0 on the CPU, and the fixture
# ---------------------------------------------------------------------------

def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "hubert-xlarge"])
def test_chip_smoke_trains_like_the_fixture_on_the_cpu(arch):
    """``chip_smoke.train_against_fixture`` (phase T0) on the CPU: the
    port's Trainer from the fixture's numpy draw gives the JAX run's losses
    and grad norms within T0's limits; a wrong learning rate does not."""
    cs = _chip_smoke()
    ref = json.load(open(cs.TRAIN_REF_JSON))
    rec = ref["models"][arch]
    with tempfile.TemporaryDirectory() as d:
        res = cs.train_against_fixture(rec, ref["opt"], ref["trainer"],
                                       "cpu", d)
    assert res["steps"] == [0, 1, 2, 3]
    assert res["loss_err"] <= cs.T0_LOSS_ATOL
    with tempfile.TemporaryDirectory() as d, \
            pytest.raises(ValueError, match="differ from JAX"):
        cs.train_against_fixture(rec, dict(ref["opt"], lr=3e-3),
                                 ref["trainer"], "cpu", d)


@pytest.mark.slow
def test_train_fixture_regenerates():
    """The committed fixture is what the script writes now."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_port_train_reference",
        os.path.join(REPO, "scripts", "make_port_train_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(_chip_smoke().TRAIN_REF_JSON) as f:
        assert json.load(f) == json.loads(json.dumps(mod.reference()))
