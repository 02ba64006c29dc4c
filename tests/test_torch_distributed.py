"""The port's distributed layer against the JAX package's, on the CPU.

(a) The sharding rules: the port's per-dimension axis assignment equals
JAX ``logical_to_pspec`` for every leaf of every reduced arch's specs,
decode state and batch, under every rule set, on the meshes ``(2,4)``,
``(4,2)``, ``(8,1)`` and ``(2,2,2)`` with ``pod`` (JAX is called with a
duck-typed mesh: its rule code reads only ``axis_names`` and ``shape``),
and the placements say the same.  (b) The trees (``logical_tree``,
``spec_shapes``, ``abstract_opt`` / ``opt_logical`` per optimizer kind,
``batch_logical_axes``, ``decode_state_logical``) equal JAX's by path.
(c) The dry-run's ``cell_runconfig``, ``act_rules_for`` and
``analytic_memory_bytes`` equal JAX's for every cell, to 1e-12 relative.

(d) Multi-rank checks in ``gloo`` spawns (``tests/_dist_ranks.py``: 4
ranks, then 2, one thread each, a 60 s collective timeout, ranks killed
past the join timeout).  A sharded train step of reduced InternLM2-1.8B
on ``(2,2)`` and ``(4,1)`` per optimizer kind, of reduced HuBERT (masked,
2 microbatches) and of reduced Qwen1.5-MoE (balance loss) on ``(2,1)``,
equals the port's unsharded step within 1e-6 (metrics relative, every
parameter absolute) and JAX's single-device step within T0's 2e-4
(losses absolute, grad norm relative, parameters absolute).  A 4-rank
Trainer whose hook fails on rank 0 alone stops on every rank and resumes
to the straight run bit for bit; its checkpoint restores onto 2 ranks
and onto one process bit for bit.  ``ef_allreduce`` on 4 ranks: payload
and residual equal JAX ``_quant`` / ``_dequant`` per shard bit for bit,
the mean within 1e-6.  GPipe over 4 stages equals JAX's sequential
``tanh(x @ w)`` within 1e-5, and decode attention with the KV sequence
split over 4 ranks JAX ``decode_attention`` within 1e-5.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import DictKey, GetAttrKey, tree_flatten_with_path

import _dist_ranks as R
from repro.configs import SHAPES as J_SHAPES
from repro.configs import all_cells
from repro.configs import get_config as j_config
from repro.distributed import grad_compress as JG
from repro.distributed import sharding as JS
from repro.models import Model as JModel
from repro.models import RunConfig as JRunConfig
from repro.models.common import logical_tree as j_logical_tree
from repro.models.common import spec_shapes as j_spec_shapes
from repro.models.layers import decode_attention as j_decode_attention
from repro.models.model import decode_state_logical as j_decode_logical
from repro.models.model import model_specs as j_model_specs
from repro.optim import OptConfig as JOptConfig
from repro.optim import abstract_opt as j_abstract_opt
from repro.optim import init_opt as j_init_opt
from repro.optim import opt_logical as j_opt_logical
from repro.train import make_train_step as j_make_train_step
from repro.train.train_step import batch_logical_axes as j_batch_logical
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import leaf_paths
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.distributed import sharding as TS
from repro_torch.launch import dryrun as TD
from repro_torch.models import (RunConfig, decode_state_logical,
                                decode_state_shapes, model_specs,
                                params_from_numpy)
from repro_torch.models.common import logical_tree, spec_shapes
from repro_torch.optim import OptConfig, abstract_opt, init_opt, opt_logical
from repro_torch.train import make_train_step
from repro_torch.train.train_step import (_accumulate, _split_micro,
                                          batch_logical_axes, make_batch_shapes)

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "8x1": ((8, 1), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
KINDS = ("adamw", "adamw8bit", "adafactor")
STEP_TOL = 1e-6          # sharded vs the port's unsharded step
JAX_TOL = 2e-4           # T0's tolerance against JAX
EPS_FLOOR = 1e-6         # |g| past which AdamW's step is well-conditioned


def _mesh(name):
    sizes, axes = MESHES[name]
    return TS.MeshShape(axes, sizes)


def _norm(ax):
    """JAX's ``PartitionSpec`` prints ``("data",)`` as ``"data"``."""
    return ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax


def _jpaths(tree, is_leaf=None) -> dict:
    out = {}
    for path, leaf in tree_flatten_with_path(tree, is_leaf=is_leaf)[0]:
        parts = [str(k.key) if isinstance(k, DictKey) else
                 k.name if isinstance(k, GetAttrKey) else str(k.idx)
                 for k in path]
        out["/".join(parts)] = leaf
    return out


def _is_logical(x):
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, str) for a in x)


def _lpaths(tree, prefix="") -> dict:
    """``{path: logical}`` of a tree of logical-axis tuples (the port's)."""
    if tree is None:
        return {}
    if _is_logical(tree):
        return {prefix: tree}
    kids = (tree.items() if isinstance(tree, dict)
            else zip(tree._fields, tree))
    out = {}
    for k, v in kids:
        out.update(_lpaths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


# ---------------------------------------------------------------------------
# (a) the rules
# ---------------------------------------------------------------------------

def _rule_cases(arch):
    """(logical, shape) of every spec leaf, decode-state leaf and batch
    leaf of the reduced arch, and which rule table each takes."""
    cfg = get_config(arch, True)
    out = [("param", s.logical, s.shape)
           for _, s in leaf_paths(model_specs(cfg, RunConfig()))]
    st_lg = decode_state_logical(cfg)
    for pos, leaves in decode_state_shapes(cfg, 8, 64).items():
        for name, (shape, _) in leaves.items():
            out.append(("act", st_lg[pos][name], shape))
    shapes = make_batch_shapes(cfg, 8, 32)
    for k, lg in batch_logical_axes(cfg).items():
        out.append(("act", lg, shapes[k][0]))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_equal_jax(arch, mesh):
    """``logical_to_pspec`` == JAX's for every leaf under every rule set
    (with and without the shape's divisibility check), and the placements
    put ``Shard(d)`` on exactly the mesh axes of dimension d."""
    from torch.distributed.tensor import Replicate, Shard
    ms = _mesh(mesh)
    n = 0
    for table, logical, shape in _rule_cases(arch):
        rules = TS.PARAM_RULES if table == "param" else TS.ACT_RULES
        jrules = JS.PARAM_RULES if table == "param" else JS.ACT_RULES
        for name, rs in rules.items():
            assert rs == jrules[name]
            for shp in (shape, None):
                got = TS.logical_to_pspec(logical, ms, rs, shp)
                want = tuple(JS.logical_to_pspec(logical, ms, jrules[name],
                                                 shp))
                assert tuple(map(_norm, got)) == tuple(map(_norm, want)), (
                    name, logical, shp)
                n += 1
            spec = TS.logical_to_pspec(logical, ms, rs, shape)
            pls = TS.logical_to_placements(logical, ms, rs, shape)
            for axis, pl in zip(ms.axis_names, pls):
                dims = [d for d, ax in enumerate(spec) if ax is not None
                        and axis in (ax if isinstance(ax, tuple) else (ax,))]
                assert pl == (Shard(dims[0]) if dims else Replicate())
    assert n > 100


def test_rules_traps():
    """The JAX package's own rule checks, and the three traps: an axis
    product that does not divide drops the outermost axis first, a tuple
    axis shards its dimension on both mesh dimensions, a mesh axis is
    used once."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = TS.MeshShape(("data", "model"), (2, 4))
    rules = TS.PARAM_RULES["default"]
    assert TS.logical_to_pspec(("embed", "mlp"), mesh, rules, (8, 16)) == \
        (("data",), "model")
    assert TS.logical_to_pspec(("embed", "mlp"), mesh, rules, (8, 6))[1] \
        is None
    assert TS.logical_to_pspec(("q_heads", "q_heads"), mesh, rules,
                               (8, 8))[1] is None
    pod = TS.MeshShape(("pod", "data", "model"), (2, 2, 2))
    assert TS.logical_to_pspec(("embed",), pod, rules, (8,)) == \
        (("pod", "data"),)
    assert TS.logical_to_pspec(("embed",), pod, rules, (6,)) == (("data",),)
    assert TS.logical_to_placements(("embed", "mlp"), pod, rules,
                                    (8, 4)) == (Shard(0), Shard(0), Shard(1))
    assert TS.logical_to_placements(("embed",), pod, rules, (3,)) == \
        (Replicate(),) * 3
    assert TS.dp_axis_names(pod) == ("pod", "data") and TS.dp_size(pod) == 4
    assert TS.dp_size(mesh) == JS.dp_size(mesh) == 2


# ---------------------------------------------------------------------------
# (b) the trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_trees_equal_jax(arch):
    """``logical_tree``, ``spec_shapes``, ``opt_logical`` / ``abstract_opt``
    per optimizer kind, ``batch_logical_axes`` and ``decode_state_logical``
    equal JAX's, compared by path."""
    cfg, jcfg = get_config(arch, True), j_config(arch, True)
    rc, jrc = RunConfig(), JRunConfig()
    specs, jspecs = model_specs(cfg, rc), j_model_specs(jcfg, jrc)
    lg, jlg = logical_tree(specs), j_logical_tree(jspecs)
    assert _lpaths(lg) == _jpaths(jlg, _is_logical)
    for dt in ("float32", "bfloat16"):
        got = {p: (tuple(x.shape), str(x.dtype).split(".")[1])
               for p, x in leaf_paths(spec_shapes(specs, dt))}
        assert all(x.is_meta for _, x in leaf_paths(spec_shapes(specs, dt)))
        want = {p: (tuple(x.shape), str(x.dtype))
                for p, x in _jpaths(j_spec_shapes(jspecs, dt)).items()}
        assert got == want
    for kind in KINDS:
        oc, joc = OptConfig(kind=kind), JOptConfig(kind=kind)
        got = _lpaths(opt_logical(oc, lg))
        assert got == _jpaths(j_opt_logical(joc, jlg), _is_logical), kind
        ab = abstract_opt(oc, spec_shapes(specs))
        jab = j_abstract_opt(joc, j_spec_shapes(jspecs))
        got = {p: (tuple(x.shape), str(x.dtype).split(".")[1])
               for p, x in leaf_paths(ab)}
        want = {p: (tuple(x.shape), str(x.dtype))
                for p, x in _jpaths(jab).items()}
        assert got == want, kind
        assert type(ab).__name__ == type(jab).__name__
    assert batch_logical_axes(cfg) == j_batch_logical(jcfg)
    assert _lpaths(decode_state_logical(cfg)) == _jpaths(
        j_decode_logical(jcfg), _is_logical)


# ---------------------------------------------------------------------------
# (c) the dry-run helpers
# ---------------------------------------------------------------------------

def _jax_dryrun():
    """The JAX dry-run module, imported without keeping the device count
    it sets for its own process (the backend is up first)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


def test_dryrun_helpers_equal_jax():
    """``cell_runconfig``, ``act_rules_for`` and ``analytic_memory_bytes``
    == JAX's for every cell of ``all_cells()`` on the production meshes,
    to 1e-12 relative; the port copies no hardware constant."""
    JD = _jax_dryrun()
    assert not any(hasattr(TD, k) for k in ("PEAK_FLOPS", "HBM_BW", "ICI_BW",
                                            "HBM_PER_CHIP"))
    meshes = [TS.MeshShape(("data", "model"), (16, 16)),
              TS.MeshShape(("pod", "data", "model"), (2, 16, 16))]
    n = 0
    for arch, shape, status in all_cells():
        cfg, jcfg = get_config(arch), j_config(arch)
        sh, jsh = SHAPES[shape], J_SHAPES[shape]
        assert TD.act_rules_for(sh) == JD.act_rules_for(jsh)
        for mesh in meshes:
            rc = TD.cell_runconfig(cfg, sh, mesh)
            jrc = JD.cell_runconfig(jcfg, jsh, mesh)
            assert dataclasses.asdict(rc) == dataclasses.asdict(jrc)
            n_chips = int(np.prod(mesh.sizes))
            dp = TS.dp_size(mesh)
            got = TD.analytic_memory_bytes(cfg, sh, rc, n_chips, dp)
            want = JD.analytic_memory_bytes(jcfg, jsh, jrc, n_chips, dp)
            assert sorted(got) == sorted(want)
            for k, w in want.items():
                assert abs(got[k] - w) <= 1e-12 * abs(w), (arch, shape, k)
            n += 1
    assert n == 2 * len(all_cells())


# ---------------------------------------------------------------------------
# (d) multi-rank checks on gloo
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The 4-rank spawn's directory; the references it is held to are
    computed here while the ranks run."""
    tmp = str(tmp_path_factory.mktemp("four"))
    ctx = R.start(R.ranks_four, 4, tmp)
    for kind in KINDS:
        _references("internlm2-1.8b", kind)
    R.join(ctx)
    return tmp


@pytest.fixture(scope="module")
def two(four, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("two"))
    os.symlink(os.path.join(four, "ckpt4"), os.path.join(tmp, "ckpt4"))
    ctx = R.start(R.ranks_two, 2, tmp)
    for name in ("hubert-xlarge", "qwen2-moe-a2.7b"):
        _references(name, "adamw")
    R.join(ctx)
    return tmp


def _load(tmp, name):
    return torch.load(os.path.join(tmp, f"{name}.pt"), weights_only=False)


_REF: dict = {}


def _references(name, kind):
    """(port unsharded metrics and params, JAX's) of one step at step 1
    from the rank helpers' weights and batch."""
    key = (name, kind)
    if key not in _REF:
        model, oc, P, b = R.train_setup(name, kind)
        tp = params_from_numpy(P, device="cpu")
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        tp2, _, tmet = make_train_step(model, oc)(tp, init_opt(oc, tp), tb,
                                                  1)
        n = model.rc.microbatches
        micro = _split_micro(tb, n)
        g, _ = _accumulate(model, tp, lambda i: {k: v[i] for k, v
                                                 in micro.items()}, n)
        port = ({k: float(v) for k, v in tmet.items()},
                {p: x.numpy() for p, x in leaf_paths(tp2)},
                {p: x.numpy() for p, x in leaf_paths(g)})
        arch, micro, _, _ = R.TRAIN_CASES[name]
        jm = JModel(j_config(arch, True),
                    JRunConfig(microbatches=micro, **R.CHUNKS))
        joc = JOptConfig(kind=kind, **R.OPT)
        jp = jax.tree.map(jnp.asarray, P)
        jp2, _, jmet = jax.jit(j_make_train_step(jm, joc))(
            jp, j_init_opt(joc, jp), {k: jnp.asarray(v)
                                      for k, v in b.items()}, jnp.int32(1))
        _REF[key] = port, ({k: float(v) for k, v in jmet.items()},
                           {p: np.asarray(x) for p, x in _jpaths(jp2).items()})
    return _REF[key]


def _check_step(got, name, kind):
    met, params = got
    (pmet, pparams, pgrads), (jmet, jparams) = _references(name, kind)
    for k in ("loss", "aux", "grad_norm"):
        assert abs(met[k] - pmet[k]) <= STEP_TOL * max(1.0, abs(pmet[k])), k
    assert abs(met["loss"] - jmet["loss"]) <= JAX_TOL
    assert abs(met["aux"] - jmet["aux"]) <= JAX_TOL
    assert abs(met["grad_norm"] - jmet["grad_norm"]) <= \
        JAX_TOL * jmet["grad_norm"]
    assert sorted(params) == sorted(pparams) == sorted(jparams)
    for p, x in params.items():
        # AdamW's first step is lr * g / (|g| + eps): where |g| is within a
        # few hundred eps, the summation-order noise of another reduction
        # (~1e-11) moves it by up to lr * 1e-3; a tenth of lr bounds it
        well = np.abs(pgrads[p]) > EPS_FLOOR
        np.testing.assert_allclose(x[well], pparams[p][well], rtol=0,
                                   atol=STEP_TOL, err_msg=p)
        np.testing.assert_allclose(x, pparams[p], rtol=0,
                                   atol=R.OPT["lr"] / 10, err_msg=p)
        np.testing.assert_allclose(x, jparams[p], rtol=0, atol=JAX_TOL,
                                   err_msg=p)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_sharded_step_equals_unsharded_and_jax(four, shape, kind):
    """Reduced InternLM2-1.8B, one step on 4 gloo ranks: parameters and
    optimizer state held as DTensors (FSDP over data, the model axis
    sharding heads, mlp and vocab; AdamW8bit's quantised moments split on
    a last axis that is not a multiple of 256 on (2,2)), the batch a
    DTensor from the sharded pipeline's placements."""
    cfg = get_config("internlm2-1.8b", True)
    if shape == (2, 2):
        assert cfg.d_ff % 2 == 0 and (cfg.d_ff // 2) % 256
    _check_step(_load(four, "steps")[(shape, kind)], "internlm2-1.8b", kind)


@pytest.mark.parametrize("name", ["hubert-xlarge", "qwen2-moe-a2.7b"])
def test_sharded_step_masked_encoder_and_moe(two, name):
    """On (2,1): the encoder's masked mean over 2 microbatches (its mask
    differs row to row: the denominator is the global microbatch's) and
    the MoE balance loss (means over the global batch) equal the
    unsharded and the JAX steps."""
    _check_step(_load(two, "steps2")[name], name, "adamw")


def test_trainer_failure_on_one_rank_resumes_like_straight_run(four):
    """A hook raising on rank 0 alone at step 3 stops all four ranks
    there (none hangs in a collective); the resume from the step-2
    checkpoint logs steps 2-4 equal to the straight run's bit for bit,
    and ends with the same parameters and optimizer state."""
    out = _load(four, "trainer")
    raised, latest, logged = out["failing"]
    assert raised and latest == 2 and logged == [0, 1, 2]
    straight, resumed = out["straight"], out["resumed"]
    assert [m[0] for m in resumed[0]] == [2, 3, 4]
    want = {m[0]: m for m in straight[0]}
    for m in resumed[0]:
        assert m == want[m[0]]
    for a, b in ((straight[1], resumed[1]), (straight[2], resumed[2])):
        assert sorted(a) == sorted(b)
        for p in a:
            assert np.array_equal(a[p], b[p]), p


def test_checkpoint_restores_across_world_sizes(four, two):
    """The 4-rank (2,2) checkpoint (f32 params, int8 and bf16 AdamW8bit
    state) restores onto 2 ranks on (2,1) as DTensors and onto one process
    without a mesh, every leaf bit for bit."""
    straight = _load(four, "trainer")["straight"]
    want = {**{f"params/{p}": x for p, x in straight[1].items()},
            **{f"opt/{p}": x for p, x in straight[2].items()}}
    on2 = _load(two, "restore2")
    assert on2["step"] == 5 and all(on2["dtensor"].values())
    got2 = {**{f"params/{p}": x for p, x in on2["params"].items()},
            **{f"opt/{p}": x for p, x in on2["opt"].items()}}
    tree, extras = Checkpointer(os.path.join(four, "ckpt4")).restore(
        device="cpu")
    assert extras["step"] == 5
    got1 = {}
    for p, x in leaf_paths(tree):
        got1[p] = (x.view(torch.int16) if x.dtype == torch.bfloat16
                   else x).numpy()
    assert sorted(got1) == sorted(got2) == sorted(want)
    for p, w in want.items():
        assert np.array_equal(got1[p], w) and np.array_equal(got2[p], w), p


def test_with_logical_constraint(four):
    """A replicated DTensor of activations is redistributed to the
    activation rules' placements (batch over data, the rest replicated);
    a plain tensor, or no mesh, is left as it is."""
    from torch.distributed.tensor import Replicate, Shard
    d = _load(four, "constraint")
    x = np.arange(8 * 3 * 4, dtype=np.float32).reshape(8, 3, 4)
    assert d["placements"] == (Shard(0), Replicate())
    assert np.array_equal(d["full"], x) and d["local"].shape == (4, 3, 4)
    t = torch.ones(2, 3)
    mesh = TS.MeshShape(("data", "model"), (2, 2))
    assert TS.with_logical_constraint(t, ("batch", None), mesh) is t
    assert TS.with_logical_constraint(t, ("batch", None), None) is t


def test_ef_allreduce_matches_jax_per_shard(four):
    """Each rank's int8 payload, scales and residual equal JAX
    ``_quant`` / ``_dequant`` of its ``g + r`` bit for bit, and every
    rank's mean is the mean of JAX's dequantised payloads within 1e-6."""
    ranks = _load(four, "ef")
    deqs = []
    for r in ranks:
        x = jnp.asarray(r["g"][0]) + jnp.asarray(r["r"][0])
        q, s = JG._quant(x)
        deq = np.asarray(JG._dequant(q, s, x.shape))
        assert np.array_equal(r["q"], np.asarray(q))
        assert np.array_equal(r["s"], np.asarray(s))
        assert np.array_equal(r["new_r"][0], np.asarray(x) - deq)
        deqs.append(deq)
    want = np.mean(deqs, axis=0)
    for r in ranks:
        np.testing.assert_allclose(r["mean"][0], want, rtol=0, atol=1e-6)
        assert np.array_equal(r["mean"], ranks[0]["mean"])


def test_pipeline_matches_sequential(four):
    """GPipe over 4 stages, 8 microbatches of 2 x 16, == JAX's sequential
    ``tanh(x @ w)`` stage after stage."""
    d = _load(four, "pipeline")
    want = jnp.asarray(d["x"])
    for s in range(4):
        want = jnp.tanh(want @ jnp.asarray(d["w"][s]))
    np.testing.assert_allclose(d["out"], np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_decode_split_sequence_matches_jax(four):
    """Decode attention over a KV cache split along the sequence over 4
    ranks (the ``decode_long`` rules) == JAX ``decode_attention`` on the
    whole cache (``tests/test_distributed.py``'s case)."""
    d = _load(four, "decode")
    want = j_decode_attention(jnp.asarray(d["q"]), jnp.asarray(d["k"]),
                              jnp.asarray(d["v"]), jnp.asarray([50]))
    np.testing.assert_allclose(d["out"], np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.slow
def test_train_step_full_mesh_grid(tmp_path):
    """The twin of ``tests/test_distributed.py``'s full grid: the sharded
    step on 8 ranks on (2,4), (4,2) and (8,1) equals the unsharded and
    the JAX steps, per optimizer kind."""
    R.spawn(R.ranks_eight, 8, str(tmp_path), timeout=600)
    steps = _load(str(tmp_path), "steps8")
    assert len(steps) == 9
    for (_, kind), got in steps.items():
        _check_step(got, "internlm2-1.8b", kind)


def test_distributed_layer_imports_light():
    """Importing the distributed layer, the launch helpers, the trainer
    and the rank helpers imports neither JAX, nor the JAX package, nor
    DTensor (collectives are imported by the functions that run them)."""
    import subprocess
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, repro_torch.distributed, repro_torch.launch.mesh, "
            "repro_torch.launch.dryrun, repro_torch.train, _dist_ranks; "
            "assert 'jax' not in sys.modules; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules); "
            "assert 'torch.distributed.tensor' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(repo, "src"), os.path.join(repo, "tests")]))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=repo)
