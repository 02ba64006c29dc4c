"""The PyTorch port's core modules against the JAX package, on the CPU.

* the copied numpy/stdlib modules (page tables, mappings, traces,
  Algorithm 3, packing, the block plan, constants) give the same output
  as the reference on the same seeds;
* one batched torch ``step_access`` / ``shoot_lane`` / ``switch_lane``
  call equals ``jax.vmap`` of the reference function on the same random
  packed state, for all 10 method kinds — including states where several
  ways match (first-index semantics) and LRU ties (first-minimum victims);
* the CUDA kernel's constants (``csrc/tlb_lane.cuh``) equal the Python
  layout they mirror, and the kernel's warp step, compiled by the host
  C++ compiler with its 32 way threads emulated, equals the plain version
  bit for bit on the test worlds and on ``chip_smoke.edge_batches``;
* the port stays free of JAX.

Tolerance is 0 everywhere: every quantity here is an integer (or a mean of
integers computed the same way).
"""
import ctypes
import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from _torch_helpers import WORLDS, convert_spec, pkg, world_cells
from repro.core import lane_program as jlp
from repro.core import plane_layout as jpl
from repro.core import simulator as jsim
from repro.core.sweep import SweepCell as JCell
from repro_torch.core import lane_program as tlp
from repro_torch.core import plane_layout as tpl
from repro_torch.core import simulator as tsim
from repro_torch.core.sweep import batches_of, pack_batch
from repro_torch.kernels.tlb_sweep import ops as tops
from repro_torch.kernels.tlb_sweep import run_lanes, run_lanes_ref

# the plain version runs thousands of tiny ops: one intra-op thread is the
# fastest, and keeps six test workers from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
CSRC = PORT / "kernels" / "tlb_sweep" / "csrc"
J, T = pkg(jcore), pkg(tcore)


def _eq_mapping(a, b):
    for f in ("ppn", "run_start", "run_len"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert a.n_pages == b.n_pages and a.name == b.name


# ---------------------------------------------------------------------------
# Copied numpy modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["small", "medium", "large", "mixed"])
def test_synthetic_mapping_equal(kind):
    _eq_mapping(jcore.synthetic_mapping(kind, 1 << 13, seed=1),
                tcore.synthetic_mapping(kind, 1 << 13, seed=1))


@pytest.mark.parametrize("thp", [False, True])
def test_demand_mapping_equal(thp):
    _eq_mapping(jcore.demand_mapping(1 << 12, seed=5, thp=thp),
                tcore.demand_mapping(1 << 12, seed=5, thp=thp))


@pytest.mark.parametrize("pattern", sorted(T.traces.PATTERNS))
def test_generate_trace_equal(pattern):
    assert sorted(J.traces.PATTERNS) == sorted(T.traces.PATTERNS)
    m = jcore.demand_mapping(1 << 11, seed=2)
    tm = tcore.demand_mapping(1 << 11, seed=2)
    np.testing.assert_array_equal(
        jcore.generate_trace(pattern, 0, 3000, seed=9, mapping=m),
        tcore.generate_trace(pattern, 0, 3000, seed=9, mapping=tm))
    np.testing.assert_array_equal(
        jcore.generate_trace(pattern, 1 << 12, 3000, seed=9),
        tcore.generate_trace(pattern, 1 << 12, 3000, seed=9))
    assert J.traces.BENCHMARKS == T.traces.BENCHMARKS


def test_determine_k_equal():
    """Algorithm 3 (θ inclusive) and the histogram-driven spec factories,
    over every synthetic family and a spread of θ/ψ."""
    assert jcore.SIZE_RANGE_TABLE == tcore.SIZE_RANGE_TABLE
    for kind in ("small", "medium", "large", "mixed"):
        m = jcore.synthetic_mapping(kind, 1 << 13, seed=3)
        tm = tcore.synthetic_mapping(kind, 1 << 13, seed=3)
        h = J.page_table.contiguity_histogram(m)
        assert h == T.page_table.contiguity_histogram(tm)
        for theta in (0.5, 0.9, 1.0):
            for psi in (1, 2, 3, 4):
                assert (jcore.determine_k(h, theta=theta, psi=psi)
                        == tcore.determine_k(h, theta=theta, psi=psi))
                js = J.baselines.kaligned_for_mapping(m, psi, theta)
                assert convert_spec(js, tsim) == \
                    T.baselines.kaligned_for_mapping(tm, psi, theta)
    for size in range(1, 3000, 7):
        assert jcore.f_alignment(size) == tcore.f_alignment(size)


def test_constants_specs_and_layout_equal():
    names = [n for n in dir(tsim) if n.isupper()]
    assert len(names) > 25
    for n in names:
        assert getattr(tsim, n) == getattr(jsim, n), n
    assert [f.name for f in dataclasses.fields(tsim.MethodSpec)] == \
        [f.name for f in dataclasses.fields(jsim.MethodSpec)]
    assert [f.name for f in dataclasses.fields(tsim.SimResult)] == \
        [f.name for f in dataclasses.fields(jsim.SimResult)]
    jspecs = [getattr(J.baselines, f)() for f in (
        "base_spec", "thp_spec", "colt_spec", "cluster_spec", "rmm_spec",
        "subregion_spec", "cache_tlb_spec", "dead_protect_spec")]
    jspecs += [J.baselines.anchor_spec(d) for d in (2, 6, 11)]
    jspecs += [J.baselines.kaligned_spec(k) for k in ([9, 6, 4], [4], [])]
    tspecs = [getattr(T.baselines, f)() for f in (
        "base_spec", "thp_spec", "colt_spec", "cluster_spec", "rmm_spec",
        "subregion_spec", "cache_tlb_spec", "dead_protect_spec")]
    tspecs += [T.baselines.anchor_spec(d) for d in (2, 6, 11)]
    tspecs += [T.baselines.kaligned_spec(k) for k in ([9, 6, 4], [4], [])]
    for js, ts in zip(jspecs, tspecs):
        assert convert_spec(js, tsim) == ts
        assert jsim.miss_chain_cycles(js) == tsim.miss_chain_cycles(ts)
    for n in ("PLANE_FIELDS", "SIDECAR_FIELDS", "MAP_REC_FIELDS",
              "FILL_REC_FIELDS", "MISC_FIELDS", "PLANE_WIDTH"):
        assert getattr(tpl, n) == getattr(jpl, n), n
    for n in ("TAG", "KCLS", "CONTIG", "PPN", "LRU", "L2_ASID", "AUX", "BIG",
              "N_COUNTERS", "C_SHOOT", "C_COV", "STEP_KEYS", "TRACE_FLOOR",
              "LANE_FLOOR", "LANE_BUCKET", "LANE_SHARE_MAX", "KMIN_SLOTS",
              "FILL_REC_FLOOR", "REC_FLOOR", "REC_PAD_BUDGET"):
        assert getattr(tlp, n) == getattr(jlp, n), n
    from repro.kernels.tlb_sweep import tlb_sweep as jk
    assert tops.PARAM_KEYS == jk.PARAM_KEYS


@pytest.mark.parametrize("world", WORLDS)
def test_pack_lanes_equal(world):
    """``pack_lanes`` + ``init_batched_state`` + ``needs_switch_pass``
    give the same arrays key for key in both packages."""
    tcells = world_cells(T, world)
    jm, jtr = _jax_world(world)
    jcells = [JCell(convert_spec(c.spec, jsim), jm, jtr) for c in tcells]
    jl, js, jgeo, jb = jlp.pack_lanes(jcells)
    tl, ts, tgeo, tb = tlp.pack_lanes(tcells)
    assert jgeo == tgeo and jb == tb
    assert jl.keys() == tl.keys() and js.keys() == ts.keys()
    for d1, d2 in ((jl, tl), (js, ts)):
        for k in d1:
            assert d1[k].dtype == d2[k].dtype, k
            np.testing.assert_array_equal(d1[k], d2[k], k)
    assert jlp.needs_switch_pass(jl) == tlp.needs_switch_pass(tl)
    L, s, w = tgeo
    for flags in ((False, False), (True, True)):
        a = jlp.init_batched_state(L, s, w, jl["pred0"], jl["asid0"],
                                   with_ctlb=flags[0], with_dp=flags[1])
        b = tlp.init_batched_state(L, s, w, tl["pred0"], tl["asid0"],
                                   with_ctlb=flags[0], with_dp=flags[1])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], k)
    for tb_ in (1, 3, 8, 32):
        pa, pb = jlp.build_block_plan(jb, tb_), tlp.build_block_plan(tb, tb_)
        for f in dataclasses.fields(pa):
            np.testing.assert_array_equal(getattr(pa, f.name),
                                          getattr(pb, f.name), f.name)


def _jax_world(world):
    from _torch_helpers import (dynamic_world, multitenant_world,
                                nested_world, parity_world, static_world)
    return {"static": static_world, "dynamic": dynamic_world,
            "multitenant": multitenant_world, "nested": nested_world,
            "parity": parity_world}[world](J)


# ---------------------------------------------------------------------------
# One batched step against jax.vmap of the reference step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def packed():
    """A 64-lane batch holding all 10 kinds (both predictor settings, both
    context-switch policies) — the lane scalars of real packed lanes."""
    cells = world_cells(T, "multitenant") + world_cells(T, "static")
    lanes, stacks, st0, sb = pack_batch(cells)
    assert len({c.spec.kind for c in cells}) == 10
    return lanes, st0


def _random_state(st0, rng, L):
    """Random state on the packed geometry, drawn so that probes hit:
    small tag/vpn ranges (several matching ways, hence first-index
    semantics), a handful of LRU values (ties, hence first-minimum
    victims), every k-class the step knows, two ASIDs."""
    st = {}
    for k, v in st0.items():
        v = np.asarray(v)
        if v.ndim < 2 or k in ("counters", "cov_samples"):
            continue
        st[k] = rng.integers(-1, 24, size=v.shape).astype(np.int32)
    l2 = st["l2"]
    l2[..., tlp.KCLS] = rng.choice([-2, -2, -1, -1, 3, 4, 6, 9, 10],
                                   size=l2.shape[:-1])
    l2[..., tlp.CONTIG] = rng.integers(0, 40, size=l2.shape[:-1])
    l2[..., tlp.LRU] = rng.integers(0, 3, size=l2.shape[:-1])
    l2[..., tlp.L2_ASID] = rng.integers(0, 2, size=l2.shape[:-1])
    l2[..., tlp.AUX] = rng.integers(0, 1 << 16, size=l2.shape[:-1])
    for k in ("l1", "l1h", "ctlb", "clus"):
        st[k][..., -1] = rng.integers(0, 2, size=st[k].shape[:-1])
        st[k][..., 2] = rng.integers(0, 3, size=st[k].shape[:-1])
    st["clus"][..., 1] = rng.integers(0, 256, size=st["clus"].shape[:-1])
    st["rmm"][..., 1] = rng.integers(-1, 30, size=st["rmm"].shape[:-1])
    st["rmm"][..., 3] = rng.integers(0, 3, size=st["rmm"].shape[:-1])
    st["rmm"][..., 4] = rng.integers(0, 2, size=st["rmm"].shape[:-1])
    st["dp"] = rng.integers(0, 4, size=np.asarray(st0["dp"]).shape)
    st["t"] = rng.integers(0, 5000, size=L)
    st["pred"] = rng.choice([0, 3, 4, 6, 9], size=L)
    st["asid"] = rng.integers(0, 2, size=L)
    st["counters"] = rng.integers(0, 1000, size=(L, tlp.N_COUNTERS))
    st["cov_samples"] = rng.integers(0, 1000, size=(L, 64))
    return {k: np.asarray(v, np.int32) for k, v in st.items()}


def _lane_inputs(lanes):
    jl = {k: jnp.asarray(lanes[k]) for k in jlp.STEP_KEYS}
    tl = {k: torch.from_numpy(np.ascontiguousarray(
        lanes[k] if lanes[k].dtype == np.bool_
        else lanes[k].astype(np.int32))) for k in tlp.STEP_KEYS}
    return jl, tl


def _t(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            d.items()}


def _assert_state_equal(jst, tst, ctx):
    assert set(jst) == set(tst), ctx
    for k in jst:
        assert tst[k].dtype == torch.int32, (ctx, k, tst[k].dtype)
        np.testing.assert_array_equal(np.asarray(jst[k]), tst[k].numpy(),
                                      err_msg=f"{ctx}: {k}")


@pytest.mark.parametrize("seed", range(6))
def test_step_access_matches_jax(packed, seed):
    lanes, st0 = packed
    L = lanes["t_real"].shape[0]
    rng = np.random.default_rng(seed)
    st = _random_state(st0, rng, L)
    vpn = rng.integers(0, 24, size=L).astype(np.int32)
    mrec = rng.integers(-1, 40, size=(L, 4)).astype(np.int32)
    frec = np.stack([rng.integers(-1, 24, size=L),
                     rng.choice([-1, 3, 4, 6, 9, 10], size=L),
                     rng.integers(1, 40, size=L),
                     rng.integers(0, 100, size=L),
                     rng.integers(0, 1 << 16, size=L)], 1).astype(np.int32)
    bm = rng.integers(0, 256, size=L).astype(np.int32)
    active = rng.random(L) < 0.8
    jl, tl = _lane_inputs(lanes)
    jst, jpp = jax.vmap(jlp.step_access)(jl, {k: jnp.asarray(v) for k, v in
                                              st.items()},
                                         vpn, mrec, frec, bm, active)
    tst, tpp = tlp.step_access(tl, _t(st), torch.from_numpy(vpn),
                               torch.from_numpy(mrec), torch.from_numpy(frec),
                               torch.from_numpy(bm), torch.from_numpy(active))
    _assert_state_equal(jst, tst, f"step seed {seed}")
    assert tpp.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jpp), tpp.numpy())


@pytest.mark.parametrize("seed", range(3))
def test_shoot_and_switch_lane_match_jax(packed, seed):
    lanes, st0 = packed
    L = lanes["t_real"].shape[0]
    rng = np.random.default_rng(100 + seed)
    st = _random_state(st0, rng, L)
    jl, tl = _lane_inputs(lanes)
    P = 32
    dirty = rng.random((L, P)) < 0.3
    dc = np.zeros((L, P + 1), np.int32)
    dc[:, 1:] = np.cumsum(dirty, 1)
    do = rng.random(L) < 0.7
    jst = jax.vmap(jlp.shoot_lane)(jl, {k: jnp.asarray(v) for k, v in
                                        st.items()}, dc, do)
    tst = tlp.shoot_lane(tl, _t(st), torch.from_numpy(dc),
                         torch.from_numpy(do))
    _assert_state_equal(jst, tst, f"shoot seed {seed}")

    new_asid = rng.integers(0, 2, size=L).astype(np.int32)
    flags = [rng.random(L) < 0.5 for _ in range(3)]
    jst = jax.vmap(jlp.switch_lane)({k: jnp.asarray(v) for k, v in
                                     st.items()}, new_asid, *flags)
    tst = tlp.switch_lane(_t(st), torch.from_numpy(new_asid),
                          *[torch.from_numpy(f) for f in flags])
    _assert_state_equal(jst, tst, f"switch seed {seed}")


# ---------------------------------------------------------------------------
# The op, the kernel's constants, its lane arithmetic on the host compiler
# ---------------------------------------------------------------------------


def test_run_lanes_on_cpu_tensors_is_the_plain_version():
    cells = [dataclasses.replace(c, trace=c.trace[:60])
             for c in world_cells(T, "static")[:3]]
    lanes, stacks, st0, sb = pack_batch(cells)
    n0 = tops.LAUNCHES["tlb_sweep"]
    a_st, a_pp = run_lanes(lanes, stacks, st0, sb, device="cpu")
    lt, stt, s0t = tops.as_tensors(lanes, stacks, st0, "cpu")
    b_st, b_pp = run_lanes_ref(lt, stt, s0t, sb)
    assert tops.LAUNCHES["tlb_sweep"] == n0          # no kernel launch
    assert torch.equal(a_pp, b_pp) and a_pp.dtype == torch.int32
    assert torch.equal(a_st["counters"], b_st["counters"])


def _cuh_defines():
    text = (CSRC / "tlb_lane.cuh").read_text()
    out = {}
    for name, val in re.findall(r"^#define (\w+) (\(?-?[\w ()<-]+\)?)",
                                text, re.M):
        try:
            out[name] = eval(val, {})      # integer literals and shifts
        except Exception:
            pass
    return out


def test_kernel_constants_match_python():
    d = _cuh_defines()
    for i, f in enumerate(tpl.PLANE_FIELDS["l2"]):
        assert d[f"L2_{f.upper()}"] == i
    assert d["L2_W"] == tpl.PLANE_WIDTH["l2"]
    assert d["L1_W"] == tpl.PLANE_WIDTH["l1"] == tpl.PLANE_WIDTH["l1h"]
    assert d["RMM_W"] == tpl.PLANE_WIDTH["rmm"]
    assert d["CLUS_W"] == tpl.PLANE_WIDTH["clus"]
    assert d["CTLB_W"] == tpl.PLANE_WIDTH["ctlb"]
    assert d["MAP_W"] == tpl.MAP_REC_WIDTH
    assert d["FILL_W"] == tpl.FILL_REC_WIDTH
    assert d["MISC_W"] == tpl.MISC_WIDTH
    for i, f in enumerate(tpl.MISC_FIELDS):
        assert d[f"M_{f.upper()}"] == i
    for i, k in enumerate(tops.PARAM_KEYS):
        assert d[f"F_{k.upper()}"] == i, k
    assert d["N_PARAM_FIELDS"] == tops.N_PARAM_FIELDS
    for i, k in enumerate(tops.SEG_KEYS):
        assert d["S_" + k[len("seg_"):].upper()] == i, k
    assert d["MAXK_CAP"] == tops.MAXK_CAP
    for n in ("C_L1", "C_REG", "C_COAL", "C_WALK", "C_PROBE", "C_PRED",
              "C_CYC", "C_COV", "C_SHOOT", "N_COUNTERS"):
        assert d[n] == getattr(tlp, n), n
    for n in ("L1_SETS", "L1_WAYS", "L1H_SETS", "L1H_WAYS", "RMM_ENTRIES",
              "CLUS_SETS", "CLUS_WAYS", "N_COV_SAMPLES", "SUBR_PAGES",
              "LAT_L2_REG", "LAT_COAL", "LAT_EXTRA_PROBE", "LAT_WALK",
              "LAT_CTLB", "LAT_SHOOTDOWN", "LAT_INVALIDATE",
              "LAT_CTX_SWITCH"):
        assert d[n] == getattr(tsim, n), n
    assert (d["K_REGULAR"], d["K_HUGE"], d["K_SUBR"], d["K_INVALID"]) == \
        (tsim.REGULAR, tsim.HUGE, tsim.KSUBR, tsim.INVALID)
    assert (d["SCORE_NEG"], d["SCORE_BIG"]) == (tsim.NEG, tlp.BIG)


@pytest.fixture(scope="module")
def host_lane_lib(tmp_path_factory):
    """The kernel's lane arithmetic (``tlb_lane.cuh``) built by the host
    C++ compiler behind a driver that walks lanes the way the CUDA kernel
    does (``tests/csrc/tlb_lane_host.cpp``)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("lane") / "libtlb_lane_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-Wall", "-Werror", "-shared",
                    "-fPIC", f"-I{CSRC}", "-o", str(out),
                    str(REPO / "tests" / "csrc" / "tlb_lane_host.cpp")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def _host_run(lib, lanes, stacks, st0, sb, nthr, all_kinds=False):
    L = lanes["t_real"].shape[0]
    arrays = [tops.pack_params(lanes).numpy(),
              np.asarray(lanes["kvals"], np.int32),
              np.stack([np.asarray(lanes[k], np.int32)
                        for k in tops.SEG_KEYS]),
              np.asarray(sb, np.int32),
              np.asarray(lanes["trace_id"], np.int32),
              *[np.asarray(stacks[k], np.int32)
                for k in ("trace", "maps", "fills", "clus", "dirty")]]
    arrays = [np.ascontiguousarray(a) for a in arrays]
    T_ = stacks["trace"].shape[1]
    ppn = np.zeros((L, T_), np.int32)
    cnt = np.zeros((L, 9), np.int32)
    cov = np.zeros((L, 64), np.int32)
    _, sets, ways, _ = st0["l2"].shape
    _, cs, cw, _ = st0["ctlb"].shape
    ints = (L, arrays[1].shape[1], len(sb) - 1, T_,
            stacks["maps"].shape[1], stacks["clus"].shape[1], sets, ways,
            cs, cw, st0["dp"].shape[1], int(tlp.needs_switch_pass(lanes)),
            nthr, int(all_kinds))
    rc = lib.tlb_lane_host(*[a.ctypes.data_as(ctypes.c_void_p)
                             for a in (*arrays, ppn, cnt, cov)],
                           *[ctypes.c_int(x) for x in ints])
    assert rc == 0
    return cnt, cov, ppn


def _host_vs_plain(lib, lanes, stacks, st0, sb):
    """The host build against the plain version twice: each lane's step
    compiled for its kind with the entry passes over 32 'threads' (the
    kernel's way), and the FT_ALL step, which reads the lane's flags at
    run time, with the passes over 3 (uneven shares)."""
    r_st, r_pp = run_lanes(lanes, stacks, st0, sb, device="cpu")
    for nthr, all_kinds in ((32, False), (3, True)):
        cnt, cov, ppn = _host_run(lib, lanes, stacks, st0, sb, nthr,
                                  all_kinds)
        np.testing.assert_array_equal(cnt, r_st["counters"].numpy())
        np.testing.assert_array_equal(cov, r_st["cov_samples"].numpy())
        np.testing.assert_array_equal(ppn, r_pp.numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_kernel_lane_logic_on_host_matches_plain(host_lane_lib, world):
    """Counters, coverage samples and the whole ppn array of every batch:
    the kernel's warp step with its 32 way threads emulated."""
    cells = world_cells(T, world)
    for group in batches_of(cells, range(len(cells))):
        _host_vs_plain(host_lane_lib,
                       *pack_batch([cells[i] for i in group]))


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EDGE_BATCHES = ("chain", "short-lanes", "small-l2")


@pytest.fixture(scope="module")
def edge_batches():
    """``chip_smoke.edge_batches``: the batches phase 3 and the card tests
    also hold the kernel to."""
    from repro_torch.core.sweep import SweepCell
    out = _chip_smoke().edge_batches(tcore, SweepCell, np)
    assert tuple(out) == EDGE_BATCHES
    return out


@pytest.mark.parametrize("name", EDGE_BATCHES)
def test_kernel_lane_logic_on_host_edge_batches(host_lane_lib, edge_batches,
                                                name):
    """The probe-chain and victim edge cases, bit for bit."""
    _host_vs_plain(host_lane_lib, *edge_batches[name])


def test_edge_batches_hold_their_cases(edge_batches):
    """Each edge the batches are meant to pin is really in them."""
    lanes, stacks, st0, sb = edge_batches["chain"]
    st, _ = run_lanes(lanes, stacks, st0, sb, device="cpu")
    cnt = st["counters"].numpy()
    kv, pred0, pred = lanes["kvals"], lanes["pred0"], lanes["use_pred"]
    assert pred[0] and pred0[0] == -1                      # pred = -1
    for i in (1, 7):                                       # pred not in K
        assert pred[i] and pred0[i] not in kv[i]
    assert (kv[7] >= 0).all()                 # ... with a full kvals row
    for i in (2, 3):                                       # duplicates
        live = kv[i][kv[i] >= 0]
        assert len(set(live.tolist())) < live.size
    assert (kv[4] == -1).sum() == 2 and kv[4][-1] == 4     # -1 holes
    # coalesced hits past the first position (probes > hits), on lanes
    # with and without the predictor; the no-predictor lane probes its
    # smallest class last
    for i in (2, 6):
        assert cnt[i, tlp.C_PROBE] > cnt[i, tlp.C_COAL] > 0
    assert kv[6].tolist() == [12, 10, 8, 4] and not pred[6]
    assert cnt[:8, tlp.C_REG].sum() + cnt[9:13, tlp.C_REG].sum() > 0
    assert lanes["t_real"][8] == 0 and cnt[8].sum() == 0   # t_real = 0
    # kinds with no instance of their own take the general step
    assert lanes["use_pred"][13] and lanes["has_rmm"][13]
    assert lanes["use_pred"][14] and lanes["is_thp"][14]
    assert cnt[13, tlp.C_COAL] > 0 and cnt[14, tlp.C_WALK] > 0

    lanes, stacks, st0, sb = edge_batches["short-lanes"]
    st, _ = run_lanes(lanes, stacks, st0, sb, device="cpu")
    cnt = st["counters"].numpy()
    shoot = lanes["seg_shoot"]
    late = [i for i in range(lanes["t_real"].size)
            if any(shoot[i, s] and sb[s] >= lanes["t_real"][i]
                   for s in range(len(sb) - 1))]
    assert late and any(cnt[i, tlp.C_SHOOT] > 0 for i in late)

    lanes, stacks, st0, sb = edge_batches["small-l2"]
    assert st0["l2"].shape[2] == 8 and {2, 3, 8} <= set(lanes["n_ways"])
    assert lanes["seg_fall"].any() and tlp.needs_switch_pass(lanes)


def test_prepare_cuda_refuses_more_ways_than_a_warp():
    """The kernel probes one way per thread of a warp: 33 L2 ways are
    refused before anything is built or launched."""
    c = world_cells(T, "static")[0]
    cell = dataclasses.replace(c, spec=dataclasses.replace(c.spec,
                                                           l2_ways=33))
    lanes, stacks, st0, sb = pack_batch([cell])
    lt, stt, s0t = tops.as_tensors(lanes, stacks, st0, "cpu")
    with pytest.raises(ValueError, match=r"L2 ways \(33\) must be at most 32"):
        tops.prepare_cuda(lt, stt, s0t, sb)


# ---------------------------------------------------------------------------
# Devices and the JAX-free rule
# ---------------------------------------------------------------------------


def test_resolve_device():
    from repro_torch import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.core, "
            "repro_torch.kernels.tlb_sweep.ops, repro_torch.scenarios, "
            "repro_torch.core.sweep; "
            "assert 'jax' not in sys.modules; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'imported the JAX package'")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(REPO))


@pytest.mark.parametrize("first", ["repro_torch.kernels.tlb_sweep",
                                   "repro_torch.core.sweep"])
def test_packages_import_in_either_order(first):
    """The kernel package builds on the lane program and the sweep builds
    on the kernel package: either may be imported first."""
    code = (f"import {first}, repro_torch.kernels.tlb_sweep.ops, "
            "repro_torch.core.sweep as s; assert callable(s.run_sweep)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(REPO))


def test_no_source_mentions_jax_or_the_jax_package():
    bad = re.compile(r"\bimport jax\b|\bfrom jax\b|\brepro\.")
    files = [p for p in PORT.rglob("*") if p.is_file()
             and p.suffix in (".py", ".cu", ".cuh")]
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for p in files:
        for i, line in enumerate(p.read_text().splitlines(), 1):
            assert not bad.search(line), f"{p.relative_to(REPO)}:{i}: {line}"
