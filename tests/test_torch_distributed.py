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

(e) Tensor parallelism over "model": steps of reduced InternLM2, HuBERT,
Qwen-MoE, Jamba and xLSTM against the unsharded and JAX steps, each rank
on its heads, columns, channels and vocabulary rows (nothing gathered
whole but where heads split mid-head); each recurrent mixer (Mamba,
mLSTM, sLSTM) in float64 on 2 model ranks against the whole layer; the
cached passes (``prefill``, ``prefill_chunked``, greedy decode steps) of
five reduced families on (1,2), (2,2) and (1,4) against the unsharded
port (1e-5; ``CACHE_TOL`` for the recurrent families) and JAX (2e-4),
their states placed by the rules.
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
from repro_torch.models import model as TM
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
    computed here while the ranks run (the cached passes' and the
    xLSTM's on a second thread)."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = str(tmp_path_factory.mktemp("four"))
    ctx = R.start(R.ranks_four, 4, tmp)
    with ThreadPoolExecutor(1) as ex:   # JAX compiles on both threads
        cached = ex.submit(lambda: ([_cache_references(a)
                                     for a in R.CACHE_ARCHS],
                                    _references("xlstm-350m", "adafactor")))
        for kind in KINDS:
            _references("internlm2-1.8b", kind)
        for name in ("hubert-xlarge", "qwen2-moe-a2.7b",
                     "internlm2-6-heads"):
            _references(name, R.TP_KINDS.get(name, "adamw"))
        cached.result()
    R.join(ctx)
    return tmp


@pytest.fixture(scope="module")
def two(four, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("two"))
    os.symlink(os.path.join(four, "ckpt4"), os.path.join(tmp, "ckpt4"))
    ctx = R.start(R.ranks_two, 2, tmp)
    for name in ("hubert-xlarge", "qwen2-moe-a2.7b"):
        _references(name, "adamw")
    _references("jamba-1.5-large-398b", "adafactor")
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
        jm = JModel(dataclasses.replace(j_config(arch, True),
                                        **R.OVERRIDES.get(name, {})),
                    JRunConfig(microbatches=micro, **R.CHUNKS))
        joc = JOptConfig(kind=kind, **R.OPT)
        jp = jax.tree.map(jnp.asarray, P)
        jp2, _, jmet = jax.jit(j_make_train_step(jm, joc))(
            jp, j_init_opt(joc, jp), {k: jnp.asarray(v)
                                      for k, v in b.items()}, jnp.int32(1))
        _REF[key] = port, ({k: float(v) for k, v in jmet.items()},
                           {p: np.asarray(x) for p, x in _jpaths(jp2).items()})
    return _REF[key]


_CACHE_REF: dict = {}


def _numpy_state(js) -> dict:
    return {path: np.asarray(x, np.float32) for path, x in _jpaths(js).items()}


def _cache_references(arch):
    """(the port's unsharded passes, JAX's) of ``R.cached_passes``' case:
    ``{"prefill" | "chunked": (logits, state), "decode": ([(tokens,
    logits)] per step, state)}``, as numpy; JAX decodes the port's
    greedy tokens."""
    if arch in _CACHE_REF:
        return _CACHE_REF[arch]
    import functools
    model, P, toks = R.cache_setup(arch)
    c = R.CACHE
    tp = params_from_numpy(P, device="cpu")
    tt = torch.from_numpy(toks)
    port = {}
    with torch.no_grad():
        lg, st = model.prefill(tp, tt, max_seq=c["max_seq"])
        port["prefill"] = (lg.numpy(), {p: x.numpy().copy()
                                        for p, x in leaf_paths(st)})
        lc, sc = model.prefill_chunked(tp, tt, n_chunks=c["chunks"],
                                       max_seq=c["max_seq"])
        port["chunked"] = (lc.numpy(), {p: x.numpy()
                                        for p, x in leaf_paths(sc)})
        nxt, steps = R.greedy(lg), []
        for step in range(c["steps"]):
            lens = torch.full((c["batch"],), c["seq"] + step)
            l2, st = model.decode_step(tp, st, nxt, lens)
            steps.append((nxt.numpy(), l2.numpy()))
            nxt = R.greedy(l2)
        port["decode"] = (steps, {p: x.numpy() for p, x in leaf_paths(st)})
    jm = JModel(j_config(arch, True), JRunConfig(**R.CHUNKS))
    jp = jax.tree.map(jnp.asarray, P)
    jt = jnp.asarray(toks, jnp.int32)
    want = {}
    jl, js = jax.jit(functools.partial(jm.prefill, max_seq=c["max_seq"]))(
        jp, jt)
    want["prefill"] = (np.asarray(jl), _numpy_state(js))
    jlc, jsc = jax.jit(functools.partial(
        jm.prefill_chunked, n_chunks=c["chunks"], max_seq=c["max_seq"]))(
        jp, jt)
    want["chunked"] = (np.asarray(jlc), _numpy_state(jsc))
    step_fn, jsteps = jax.jit(jm.decode_step), []
    for step, (nxt, _) in enumerate(port["decode"][0]):
        lens = jnp.full((c["batch"],), c["seq"] + step, jnp.int32)
        jl, js = step_fn(jp, js, jnp.asarray(nxt, jnp.int32), lens)
        jsteps.append((nxt, np.asarray(jl)))
    want["decode"] = (jsteps, _numpy_state(js))
    _CACHE_REF[arch] = port, want
    return _CACHE_REF[arch]


def _check_step(got, name, kind, norm_tol=STEP_TOL, noise=0.0):
    """``got``'s metrics and parameters against the unsharded port's step
    and JAX's; ``norm_tol``: the grad norm's relative bound against the
    port; parameters whose unsharded gradient is at most ``noise`` are
    not compared (their step is the optimizer's normalised rounding
    noise)."""
    met, params = got[:2]
    (pmet, pparams, pgrads), (jmet, jparams) = _references(name, kind)
    for k, tol in (("loss", STEP_TOL), ("aux", STEP_TOL),
                   ("grad_norm", norm_tol)):
        assert abs(met[k] - pmet[k]) <= tol * max(1.0, abs(pmet[k])), k
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
        live = np.abs(pgrads[p]) > noise if noise else np.ones_like(well)
        np.testing.assert_allclose(x[well], pparams[p][well], rtol=0,
                                   atol=STEP_TOL, err_msg=p)
        np.testing.assert_allclose(x[live], pparams[p][live], rtol=0,
                                   atol=R.OPT["lr"] / 10, err_msg=p)
        np.testing.assert_allclose(x[live], jparams[p][live], rtol=0,
                                   atol=JAX_TOL, err_msg=p)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
def test_sharded_step_equals_unsharded_and_jax(four, shape, kind):
    """Reduced InternLM2-1.8B, one step on 4 gloo ranks: parameters and
    optimizer state held as DTensors (FSDP over data, the model axis
    sharding heads, mlp and vocab; AdamW8bit's quantised moments split on
    a last axis that is not a multiple of 256 on (2,2)), the batch a
    DTensor from the sharded pipeline's placements; on (2,2) and (1,4)
    the step computes tensor-parallel over the model ranks (GQA on (1,4):
    one query head a rank, two ranks reading each KV head)."""
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


def _tp_case(four, two, shape, name):
    tmp, key = (four, "tp4") if np.prod(shape) == 4 else (two, "tp2")
    if name == "internlm2-1.8b":
        return _load(four, "steps")[(shape, "adamw")]
    return _load(tmp, key)[(shape, name)]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("name", ["hubert-xlarge", "qwen2-moe-a2.7b"])
def test_tp_step_encoder_and_moe(four, two, name, shape):
    """The encoder (masked, 2 microbatches, non-causal) and the MoE model
    (experts' d_ff and the shared experts split, the balance loss over
    the data ranks) computed tensor-parallel over 2 model ranks, alone
    and beside 2 data ranks, equal the unsharded and the JAX steps.

    The encoder steps with Adafactor (``R.TP_KINDS``): the tensor-
    parallel products sum their inner dimension in another order, which
    moves gradients by f32 rounding (up to 5.4e-8 where 1e-7 < |g| <
    1e-5 on (1,2); 4.7e-9 data-parallel), and AdamW's first step g / (|g|
    + eps), on gradients clipped by 1/15.5 to a few eps, blows that past
    1e-6 at 3 of the encoder's 393,856 parameters (up to 1.8e-6); under
    Adafactor every parameter is within 1.2e-7
    (``scripts/tp_step_vs_unsharded.py``)."""
    _check_step(_tp_case(four, two, shape, name), name,
                R.TP_KINDS.get(name, "adamw"))


def _widths(name, tp):
    """What each rank of a ``tp``-way model axis computes on: query heads,
    MLP hidden width (the shared experts' for the MoE model), expert
    hidden width, logits' vocabulary width."""
    cfg = dataclasses.replace(get_config(R.TRAIN_CASES[name][0], True),
                              **R.OVERRIDES.get(name, {}))
    mlp = {cfg.n_shared_experts * cfg.d_ff // tp} if cfg.n_shared_experts \
        else set()
    if any(TM._ffn_kind(cfg, j) == "mlp" for j in range(TM.block_period(cfg))):
        mlp.add(cfg.d_ff // tp)
    return dict(q_heads={cfg.n_heads // tp}, mlp=mlp,
                expert={cfg.d_ff // tp} if cfg.n_experts else set(),
                vocab={TM.padded_vocab(cfg) // tp})


@pytest.mark.parametrize("case", [
    ((1, 4), "internlm2-1.8b"), ((2, 2), "internlm2-1.8b"),
    ((1, 2), "hubert-xlarge"), ((2, 2), "hubert-xlarge"),
    ((1, 2), "qwen2-moe-a2.7b"), ((2, 2), "qwen2-moe-a2.7b")])
def test_tp_ranks_compute_their_shards(four, two, case):
    """Each rank computed on H / tp query heads, d_ff / tp MLP and expert
    columns and V_pad / tp logits (read where the model computes), and
    no parameter sharded over "model" was gathered whole in the step."""
    shape, name = case
    probes = _tp_case(four, two, shape, name)[2]
    assert len(probes) == int(np.prod(shape))
    want = _widths(name, shape[1])
    for rec in probes:
        assert rec["model_gathers"] == 0
        for k, w in want.items():
            assert rec[k] == w, (k, rec[k], w)


def test_tp_mid_head_split_gathers_attention(four):
    """6 heads over 4 model ranks: the rules shard ``wq`` / ``wo`` by
    ``q_dim`` = 192 into 48 columns, a head and a half.  The step gathers
    those two leaves whole and computes attention whole (all 6 heads on
    every rank), the MLP and the vocabulary still split; it equals the
    unsharded and the JAX steps."""
    got = _load(four, "tp4")[((1, 4), "internlm2-6-heads")]
    _check_step(got, "internlm2-6-heads", "adamw")
    cfg = dataclasses.replace(get_config("internlm2-1.8b", True),
                              **R.OVERRIDES["internlm2-6-heads"])
    assert cfg.q_dim % 4 == 0 and cfg.n_heads % 4
    assert TM.whole_along_model(cfg, "blocks/pos0/attn/wq", 4)
    for rec in got[2]:
        assert rec["model_gathers"] == 2          # wq and wo
        assert rec["q_heads"] == {6}
        assert rec["mlp"] == {cfg.d_ff // 4}
        assert rec["vocab"] == {TM.padded_vocab(cfg) // 4}


def test_tp_recurrent_mixers_on_shards(four, two):
    """Reduced Jamba and xLSTM on (1,2) and (2,2): every Mamba, mLSTM and
    sLSTM leaf that the rules shard over "model" is computed on as the
    rank's shard (none gathered whole), each mixer on half its channels
    (Jamba's 256 Mamba channels, the xLSTM's 128 mLSTM and 64 sLSTM ones),
    beside attention, MoE and the vocabulary split likewise."""
    for name in ("jamba-1.5-large-398b", "xlstm-350m"):
        cfg = get_config(name, True)
        specs = model_specs(cfg, RunConfig())
        mesh = TS.MeshShape(("data", "model"), (1, 2))
        psh = dict(leaf_paths(TS.param_sharding(logical_tree(specs),
                                                spec_shapes(specs), mesh)))
        mixers = {p: sp for p, sp in leaf_paths(specs)
                  if any(f"/{m}/" in p for m in ("mamba", "mlstm", "slstm"))
                  and TS.model_range(sp.shape, psh[p], (0, 0)) is not None}
        assert len(mixers) >= 6
        assert all(TM.keeps_model_shard(cfg, p, sp.logical, sp.shape, psh[p])
                   for p, sp in mixers.items())
        want = ({("mamba", cfg.mamba.expand * cfg.d_model // 2)}
                if cfg.family == "hybrid" else
                {("mlstm", cfg.d_model), ("slstm", cfg.d_model // 2)})
        for shape in ((1, 2), (2, 2)):
            probes = _tp_case(four, two, shape, name)[2]
            assert len(probes) == int(np.prod(shape))
            for rec in probes:
                assert rec["model_gathers"] == 0
                assert rec["mixer"] == want, (name, shape, rec["mixer"])
                assert rec["vocab"] == {TM.padded_vocab(cfg) // 2}
                if cfg.family == "hybrid":
                    assert rec["q_heads"] == {cfg.n_heads // 2}
                    assert rec["expert"] == {cfg.d_ff // 2}


#: the Mamba leaves whose gradient flows through the scan's f32 sums over
#: the channels (B's and C's gradients: the layer casts the scan to f32,
#: as the JAX package does, whatever its inputs), which each rank takes
#: over its half: f32 rounding, not f64's
F32_SUMMED = {"mamba": ("in_proj", "conv_w", "conv_b", "x_proj", "x")}


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_tp_mixers_exact_in_f64(two, kind):
    """Each recurrent mixer on 2 model ranks in float64, from a state and
    with ``scan_chunk`` 4 over 7 steps (a padded chunk), equals the whole
    layer: its output on both ranks, each rank's slice of the new state,
    each rank's gradient of its shard of every leaf (the whole gradient
    of a replicated one: the sLSTM's ``r_*``, ``b_*``, ``norm``) and of
    the input, within 1e-10 of the largest entry (``F32_SUMMED``: 1e-6).
    Only the order of sums differs, so a disagreement past that is an
    error of the split, not rounding."""
    from repro_torch.configs import get_config as cfg_of
    from repro_torch.models import mamba as M
    from repro_torch.models import xlstm as X
    ranks = _load(two, "mixers_f64")["ranks"]
    cfg = cfg_of(R.MIXERS[kind], True)
    d = ranks[0][1][kind]
    leaves = {p: torch.from_numpy(a).requires_grad_(True)
              for p, a in d["full"].items()}
    xt = torch.from_numpy(d["x"]).requires_grad_(True)
    st = tuple(torch.from_numpy(a) for a in d["state"])
    if kind != "mamba":
        st = (X.MLSTMState if kind == "mlstm" else X.SLSTMState)(*st)
    layer = {"mamba": M.mamba_layer, "mlstm": X.mlstm_layer,
             "slstm": X.slstm_layer}[kind]
    y, new = layer(cfg, leaves, xt, scan_chunk=4, state=st,
                   return_state=True)
    (y * torch.from_numpy(d["r"])).sum().backward()
    assert sorted(r for r, _ in ranks) == [0, 1]

    def close(a, want, what=""):
        tol = 1e-6 if what in F32_SUMMED.get(kind, ()) else 1e-10
        np.testing.assert_allclose(a, want, rtol=0,
                                   atol=tol * float(np.abs(want).max()),
                                   err_msg=what)
    for r, out in ranks:
        got = out[kind]
        close(got["y"], y.detach().numpy())
        close(got["gx"], xt.grad.numpy(), "x")
        for a, want, dim in zip(got["new"], new, R.state_dims(kind)):
            w = want.shape[dim] // 2
            close(a, want.detach().narrow(dim, r * w, w).numpy())
        for p, t in leaves.items():
            sl = got["slices"][p]
            assert got["grads"][p].shape == t.grad[sl].shape, p
            close(got["grads"][p], t.grad[sl].numpy(), p)
        split = [p for p in leaves
                 if got["grads"][p].shape != d["full"][p].shape]
        assert len(split) >= {"mamba": 9, "mlstm": 10, "slstm": 5}[kind]


#: the recurrent mixers' tensor-parallel steps: (the grad norm's relative
#: bound against the unsharded step, the gradient at or under which a
#: parameter's step is rounding noise).  Their f32 gradients move by more
#: than the other cases' (grad norm 1.8e-6 relative for Jamba, 6.9e-6 for
#: the xLSTM, on (1,2) and (2,2); 1.2e-7 and 8.2e-8 data-parallel on
#: (2,1)): a forward value moved by an ulp of another summation order
#: flips a max (the stabilisers ``m``, the normaliser's ``max(|n q|,
#: 1)``) and routes a gradient elsewhere; ``test_tp_mixers_exact_in_f64``
#: holds the split itself exact.  The sLSTM's input-gate biases have a
#: gradient that is zero but for rounding (a shift of every input gate of
#: a channel moves ``m`` with it and leaves c / n, so h, unchanged):
#: |g| <= 4e-9, which Adafactor normalises into steps of up to 6.6e-3
#: (5.5e-3 between the unsharded port and JAX).
TP_RECURRENT = {"jamba-1.5-large-398b": (1e-5, 0.0),
                "xlstm-350m": (1e-5, 1e-8)}


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("name", ["jamba-1.5-large-398b", "xlstm-350m"])
def test_tp_step_recurrent_mixers(four, two, name, shape):
    """The Mamba hybrid and the xLSTM computed tensor-parallel over 2
    model ranks (``paired_halves`` into the fused in-projections, the
    mLSTM's projections reduce-scattered onto the rank's heads, the
    sLSTM's gates on them), alone and beside 2 data ranks, equal the
    unsharded and the JAX steps, under Adafactor (``R.TP_KINDS``: AdamW's
    first step moves 190 of the xLSTM's parameters with |g| > 1e-6 past
    1e-6, and three of Jamba's by up to 2.8e-6 even data-parallel on
    (2,1)), within :data:`TP_RECURRENT`'s bounds."""
    norm_tol, noise = TP_RECURRENT[name]
    _check_step(_tp_case(four, two, shape, name), name,
                R.TP_KINDS.get(name, "adamw"), norm_tol, noise)


@pytest.mark.parametrize("case", [((2, 2), "qwen2-moe-a2.7b"),
                                  ((1, 2), "qwen2-moe-a2.7b"),
                                  ((1, 2), "jamba-1.5-large-398b")])
def test_tp_router_ids_identical_across_model_ranks(four, two, case):
    """Every routing call (forward and each recomputation in backward)
    sends each token to the same experts on every model rank of a data
    coordinate: the router's input is the residual stream, equal bit for
    bit on the model ranks after each all-reduce."""
    shape, name = case
    probes = _tp_case(four, two, shape, name)[2]
    by_data = {}
    for rec in probes:
        by_data.setdefault(rec["coordinate"][0], []).append(rec["routes"])
    assert len(by_data) == shape[0]
    for routes in by_data.values():
        assert len(routes) == shape[1] and len(routes[0]) >= 2
        for other in routes[1:]:
            assert len(other) == len(routes[0])
            for a, b in zip(routes[0], other):
                assert np.array_equal(a, b)


def test_tp_forward_equals_unsharded_and_jax(four):
    """``Model.forward`` of reduced InternLM2 on (1,4) from DTensor
    parameters (each rank one query head, a quarter of the MLP and of the
    vocabulary, the logits gathered) equals the unsharded forward within
    1e-5 and JAX's within the forward tolerance, on every rank alike."""
    ranks = _load(four, "tp_forward")
    model, _, P, b = R.train_setup("internlm2-1.8b", "adamw")
    with torch.no_grad():
        want, _ = model.forward(params_from_numpy(P, device="cpu"),
                                torch.from_numpy(b["tokens"]))
    jm = JModel(j_config("internlm2-1.8b", True), JRunConfig(**R.CHUNKS))
    jl, _ = jm.forward(jax.tree.map(jnp.asarray, P),
                       jnp.asarray(b["tokens"]))
    w = _widths("internlm2-1.8b", 4)
    for logits, rec in ranks:
        assert np.array_equal(logits, ranks[0][0])
        np.testing.assert_allclose(logits, want.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(logits, np.asarray(jl), rtol=5e-5,
                                   atol=5e-5)
        assert rec["q_heads"] == w["q_heads"] and rec["mlp"] == w["mlp"]
        assert rec["model_gathers"] == 0


def _plain_ops(d):
    """Each operator's plain counterpart on rank r's inputs → (output,
    gradient) as numpy."""
    n = d["n"]
    out = {}
    for r in range(n):
        x = torch.from_numpy(d["x"]).requires_grad_(True)
        y = x * torch.from_numpy(d["parts"][r])
        # every rank's loss term reads x: the gradient is their sum
        g = sum(d["parts"])
        out[(r, "copy_to_model")] = (y.detach().numpy(), g)
        out[(r, "reduce_from_model")] = (sum(d["parts"]), d["x"])
        up = d["up"]
        out[(r, "gather_from_model")] = (
            np.concatenate(list(d["parts"]), -1), up[:, 5 * r:5 * (r + 1)])
        t = torch.from_numpy(d["table"]).requires_grad_(True)
        e = t[torch.from_numpy(d["tokens"])]
        (e * torch.from_numpy(d["up_e"])).sum().backward()
        out[(r, "vocab_parallel_embed")] = (
            e.detach().numpy(), t.grad.numpy()[4 * r:4 * (r + 1)])
    return out


@pytest.mark.parametrize("op", ["copy_to_model", "reduce_from_model",
                                "gather_from_model", "vocab_parallel_embed",
                                "vocab_parallel_nll"])
def test_tp_operators_match_plain(four, op):
    """Each Megatron operator on 4 model ranks, forward and backward,
    equals its plain counterpart on the whole tensors; the vocabulary-
    parallel cross-entropy equals JAX's ``cross_entropy`` and its
    gradient ``jax.grad``'s, each rank's slice of it."""
    from repro.models.model import cross_entropy as j_xent
    d = _load(four, "tp_ops")
    n = d["n"]
    assert n == 4 and sorted(r for r, _ in d["ranks"]) == list(range(n))
    if op == "vocab_parallel_nll":
        z, labels = jnp.asarray(d["z"]), jnp.asarray(d["labels"])
        want = float(j_xent(z, labels))
        grad = np.asarray(jax.grad(lambda a: j_xent(a, labels))(z))
        for r, out in d["ranks"]:
            y, g = out[op]
            assert abs(float(y.mean()) - want) <= 1e-6 * abs(want)
            np.testing.assert_allclose(g, grad[..., 8 * r:8 * (r + 1)],
                                       rtol=0, atol=1e-7)
        return
    plain = _plain_ops(d)
    for r, out in d["ranks"]:
        y, g = out[op]
        wy, wg = plain[(r, op)]
        np.testing.assert_allclose(y, wy, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g, wg, rtol=1e-6, atol=1e-6)


#: the cached passes' bound against the unsharded port: the Mamba hybrid
#: and the xLSTM move by up to 7.3e-5 (states) and 6.0e-5 (logits) on
#: these meshes under f32 rounding through their 8 and 6 recurrent
#: layers, and by up to 6.7e-5 / 5.0e-5 even data-parallel on (2,1),
#: where no sum changes order: the products run on fewer rows
#: (``scripts/cached_vs_unsharded.py``)
CACHE_TOL = {"jamba-1.5-large-398b": 1e-4, "xlstm-350m": 1e-4}


_LOADED: dict = {}


def _cached(four, two, shape):
    tmp, key = (two, "cached2") if shape == (1, 2) else (four, "cached4")
    if (tmp, key) not in _LOADED:
        _LOADED[(tmp, key)] = _load(tmp, key)
    return _LOADED[(tmp, key)]


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("pass_", ["prefill", "chunked", "decode"])
@pytest.mark.parametrize("arch", R.CACHE_ARCHS)
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_cached_passes_on_mesh(four, two, shape, arch, pass_):
    """``prefill`` and ``prefill_chunked`` (2 chunks) under "default" and
    8 greedy ``decode_step``s under "decode" (from the prefill's state,
    redistributed on entry) on the mesh, each rank on its rows and its
    model shards: the logits equal the unsharded port's within 1e-5
    (``CACHE_TOL`` for the recurrent families) on every model rank alike
    and JAX's within 2e-4, the greedy tokens are the same, every gathered
    state leaf likewise, each placed as ``decode_state_logical`` under the
    pass's rules, and no rank holds more than its share of a KV cache;
    no leaf is gathered whole along "model" but the xLSTM's at tp 4 (2
    heads)."""
    got = _cached(four, two, shape)[(shape, arch)]
    _check_cached(got, shape, arch, pass_,
                  "decode" if pass_ == "decode" else "default")


@pytest.mark.parametrize("arch", R.LONG_ARCHS)
def test_cached_decode_long_on_mesh(four, arch):
    """8 greedy ``decode_step``s under "decode_long" on (2,2) from the
    prefill's state under "default" (the cache's batch split over "data"
    redistributed to a sequence split): every rank decodes the whole
    batch, the sequence's softmax partials combining over "data" and the
    scores' partial sums over the head dimension's split over "model";
    held as :func:`test_cached_passes_on_mesh` holds "decode", every rank
    alike."""
    got = _cached(four, four, (2, 2))[((2, 2), arch, "decode_long")]
    _check_cached(got, (2, 2), arch, "decode", "decode_long")


def _check_cached(got, shape, arch, pass_, rules):
    """``got`` (:func:`R.cached_passes`), its ``pass_`` run under
    ``rules``, against the unsharded port and JAX."""
    from torch.distributed.tensor import Replicate
    port, jx = _cache_references(arch)
    tol = CACHE_TOL.get(arch, 1e-5)
    cfg = get_config(arch, True)
    by_rows = {}              # the ranks of each part of the batch
    for mine, rec in got["ranks"]:
        rows = rec["coordinate"][0] if rules != "decode_long" else 0
        by_rows.setdefault(rows, []).append(mine[pass_])
        whole = cfg.family == "xlstm" and shape[1] == 4
        assert (rec["model_gathers"] > 0) == whole, rec["model_gathers"]
    assert sorted(by_rows) == list(range(len(by_rows)))
    if pass_ == "decode":
        for s in range(R.CACHE["steps"]):
            for outs in by_rows.values():
                for o in outs[1:]:
                    assert np.array_equal(o[s][1], outs[0][s][1])
            toks = np.concatenate([by_rows[d][0][s][0] for d in
                                   sorted(by_rows)])
            lg = np.concatenate([by_rows[d][0][s][1] for d in
                                 sorted(by_rows)])
            assert np.array_equal(toks, port["decode"][0][s][0]), s
            _close(lg, port["decode"][0][s][1], tol, f"step {s}")
            _close(lg, jx["decode"][0][s][1], JAX_TOL, f"step {s} vs JAX")
    else:
        for outs in by_rows.values():
            for o in outs[1:]:
                assert np.array_equal(o, outs[0])
        lg = np.concatenate([by_rows[d][0] for d in sorted(by_rows)])
        _close(lg, port[pass_][0], tol, pass_)
        _close(lg, jx[pass_][0], JAX_TOL, f"{pass_} vs JAX")
    mesh = TS.MeshShape(("data", "model"), shape)
    lg_tree = dict(_lpaths(decode_state_logical(cfg)))
    state = got[pass_]
    assert sorted(state) == sorted(port[pass_][1]) == sorted(jx[pass_][1])
    for path, (pls, local, x) in state.items():
        spec = TS.act_pspec(lg_tree[path], mesh, rules, x.shape)
        assert pls == TS.spec_to_placements(spec, mesh), (path, pls, spec)
        if path.endswith(("/k", "/v")):
            assert np.prod(local) * np.prod(shape) == x.size, (path, local)
            assert all(pl != Replicate() for pl in pls)
        _close(x, port[pass_][1][path], tol, path)
        _close(x, jx[pass_][1][path], JAX_TOL, f"{path} vs JAX")


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
