"""The sweep's fill and cluster records built from the map records, on the
CPU.

On the card, ``pack_lanes(..., record_plan=True)`` packs a record plan in
place of the ``fills`` and ``clus`` stacks, and ``ops.build_records``
builds them beside the uploaded map records.  Here:

* the plain version (``ops.build_records_ref``) and the kernel's
  arithmetic (``csrc/tlb_records.cuh``, built by the host C++ compiler
  behind ``tests/csrc/tlb_records_host.cpp``) give the host packing's
  stacks bit for bit, pad records included, on every world kind under
  rosters holding every profile (regular, several K tuples, COLT, THP,
  subregion, cluster);
* the plan leaves every other stack and lane table as the host packs it;
* ``run_sweep`` on the CPU still packs every record on the host, through
  ``lane_program._fill_profile``;
* the kernel's plan columns and codes equal the Python ones.

The kernel itself is held to the plain version in
``tests/test_torch_cuda.py``, on the card.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from _torch_helpers import WORLDS, pkg, world_cells
from repro_torch.core import lane_program as tlp
from repro_torch.core import page_table as tpt
from repro_torch.core import simulator as tsim
from repro_torch.core.sweep import SweepCell, batches_of, pack_batch, run_sweep
from repro_torch.kernels.tlb_sweep import ops as tops

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "src" / "repro_torch" / "kernels" / "tlb_sweep" / "csrc"
T = pkg(tcore)


def _batches(world):
    cells = world_cells(T, world)
    return [[cells[i] for i in g] for g in batches_of(cells, range(len(cells)))]


def _both(cells):
    """``pack_lanes`` as the host packs and as it packs for the card."""
    return tlp.pack_lanes(cells), tlp.pack_lanes(cells, record_plan=True)


def _maps(stacks):
    return torch.from_numpy(stacks["maps"])


def _assert_records_equal(got, want):
    for k in ("fills", "clus"):
        g = got[k].cpu().numpy() if isinstance(got[k], torch.Tensor) \
            else got[k]
        assert g.dtype == want[k].dtype == np.int32, k
        assert g.shape == want[k].shape, k
        np.testing.assert_array_equal(g, want[k], k)


@pytest.mark.parametrize("world", WORLDS)
def test_plain_records_equal_the_host_packing(world):
    """``build_records`` on CPU tensors (the plain version) from the
    card path's plan and maps equals ``pack_lanes``' fills and clus
    stacks array for array, pad records included."""
    for cells in _batches(world):
        (_, host, _, _), (_, card, _, _) = _both(cells)
        n0 = tops.LAUNCHES["tlb_records"]
        got = tops.build_records(card["plan"], _maps(card))
        assert tops.LAUNCHES["tlb_records"] == n0      # plain: not counted
        _assert_records_equal(got, host)


@pytest.mark.parametrize("world", WORLDS)
def test_plan_leaves_the_other_stacks_and_lanes_equal(world):
    for cells in _batches(world):
        (hl, hs, hgeo, hb), (cl, cs, cgeo, cb) = _both(cells)
        assert (hgeo, hb) == (cgeo, cb)
        assert hl.keys() == cl.keys()
        for k in hl:
            assert hl[k].dtype == cl[k].dtype, k
            np.testing.assert_array_equal(hl[k], cl[k], k)
        assert set(hs) - {"fills", "clus"} == set(cs) - {"plan"}
        for k in set(cs) - {"plan"}:
            np.testing.assert_array_equal(hs[k], cs[k], k)
        plan = cs["plan"]
        assert plan.n_fill == hs["fills"].shape[0]
        assert plan.rows.shape[0] == plan.n_fill + hs["clus"].shape[0]
        assert plan.clus_width == hs["clus"].shape[1]


def test_worlds_hold_every_profile():
    codes = set()
    for world in WORLDS:
        for cells in _batches(world):
            codes |= set(_both(cells)[1][1]["plan"].rows[:, tlp.PLAN_CODE])
    assert codes == set(range(len(tlp.REC_CODES)))
    ks = {tlp._fill_profile_key(c.spec) for c in world_cells(T, "static")}
    assert len({k for k in ks if k[0] == "ka"}) >= 3


@pytest.fixture(scope="module")
def host_records_lib(tmp_path_factory):
    """The record kernel's arithmetic (``tlb_records.cuh``) built by the
    host C++ compiler behind a loop over every (record, vpn)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("records") / "libtlb_records_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-Wall", "-Werror", "-shared",
                    "-fPIC", f"-I{CSRC}", "-o", str(out),
                    str(REPO / "tests" / "csrc" / "tlb_records_host.cpp")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def _host_build(lib, plan, maps):
    R, P, _ = maps.shape
    rows = np.ascontiguousarray(plan.rows, np.int32)
    maps = np.ascontiguousarray(maps, np.int32)
    n_clus = rows.shape[0] - plan.n_fill
    fills = np.full((plan.n_fill, P, tlp.FILL_REC_WIDTH), 7, np.int32)
    clus = np.full((n_clus, plan.clus_width), 7, np.int32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    rc = lib.tlb_records_host(ptr(rows), ctypes.c_int(plan.n_fill),
                              ctypes.c_int(n_clus),
                              ctypes.c_int(rows.shape[1]), ptr(maps),
                              ctypes.c_int(P), ctypes.c_int(plan.clus_width),
                              ptr(fills), ptr(clus))
    assert rc == 0
    return dict(fills=fills, clus=clus)


@pytest.mark.parametrize("world", WORLDS)
def test_record_kernel_arithmetic_on_host_equals_the_host_packing(
        host_records_lib, world):
    for cells in _batches(world):
        (_, host, _, _), (_, card, _, _) = _both(cells)
        _assert_records_equal(
            _host_build(host_records_lib, card["plan"], card["maps"]), host)


def _edge_mapping(n, seed):
    """Runs of every length around the windows' edges, unmapped pages,
    frames aligned and not: a mapping whose records exercise the 2MB
    window, the subregion bitmap and the cluster windows at their rims."""
    rng = np.random.default_rng(seed)
    ppn = np.full(n, -1, np.int64)
    v, frame = 0, 4096
    while v < n:
        run = int(rng.choice([1, 2, 3, 7, 8, 9, 15, 17, 511, 512, 700]))
        if rng.random() < 0.2:
            v += run                       # an unmapped stretch
            continue
        if rng.random() < 0.5:
            frame = -(-frame // 512) * 512  # a 2MB-aligned frame
        if rng.random() < 0.3:
            frame = v - (v % 512) + 512 * 64 + (v % 512)  # vpn-aligned
        run = min(run, n - v)
        ppn[v: v + run] = np.arange(frame, frame + run)
        frame += run + int(rng.integers(0, 9))
        v += run
    return tpt.make_mapping(ppn, name=f"edge{seed}")


@pytest.mark.parametrize("n", [3, 8, 600, 1536, 2050])
def test_records_at_the_rims_of_odd_sizes(host_records_lib, n):
    """Sizes that are not a power of two or below a window: rows past
    n_pages, clipped windows, pages of a window past the end."""
    b = T.baselines
    specs = [b.base_spec(), b.thp_spec(), b.colt_spec(), b.cluster_spec(),
             b.subregion_spec(), b.anchor_spec(2),
             b.kaligned_spec([9, 6, 4, 1]), b.kaligned_spec([0, 3])]
    m1, m2 = _edge_mapping(n, 1), _edge_mapping(max(n // 2, 1), 2)
    tr = np.zeros(4, np.int64)
    cells = [SweepCell(s, m, tr) for m in (m1, m2) for s in specs]
    (_, host, _, _), (_, card, _, _) = _both(cells)
    _assert_records_equal(tops.build_records(card["plan"], _maps(card)),
                          host)
    _assert_records_equal(
        _host_build(host_records_lib, card["plan"], card["maps"]), host)


def test_record_kernel_constants_match_python():
    text = (CSRC / "tlb_records.cuh").read_text()
    d = {n: int(v) for n, v in re.findall(r"^#define (\w+) (-?\d+)", text,
                                          re.M)}
    for i, f in enumerate(tlp.PLAN_FIELDS):
        assert d[f"PLAN_{'PAGES' if f == 'n_pages' else f.upper()}"] == i
    assert d["PLAN_K"] == len(tlp.PLAN_FIELDS)
    names = {"zero": "ZERO", "regular": "REGULAR", "kaligned": "KALIGNED",
             "colt": "COLT", "thp": "THP", "subregion": "SUBR",
             "cluster": "CLUSTER"}
    for i, code in enumerate(tlp.REC_CODES):
        assert d[f"REC_{names[code]}"] == i, code
    # COLT's class and window, and the cluster bitmap's window, as the
    # host packing computes them
    m = tpt.make_mapping(np.arange(64, dtype=np.int64) + 8)
    rec = tlp._fill_profile(m, ("colt",), 64)
    assert rec[5, 1] == d["K_COLT"] and rec[5, 2] == d["COLT_SPAN"]
    assert tpt.cluster_bitmap(m)[5] == (1 << (1 << d["CLUS_BITS"])) - 1


def test_pack_batch_packs_a_plan_only_for_the_card():
    cells = world_cells(T, "static")
    lanes, stacks, st0, sb = pack_batch(cells)
    assert {"fills", "clus"} <= set(stacks) and "plan" not in stacks
    for dev in ("cpu", torch.device("cpu")):
        assert "plan" not in pack_batch(cells, dev)[1]
    c_lanes, c_stacks, c_st0, c_sb = pack_batch(cells, "cuda")
    assert set(c_stacks) == {"maps", "dirty", "trace", "plan"}
    plan = c_stacks["plan"]
    n_prof = len({tlp._fill_profile_key(c.spec) for c in cells})
    n_clus = int(any(c.spec.side == "cluster" for c in cells))
    assert plan.n_real == n_prof + n_clus
    assert plan.nbytes == plan.rows.nbytes < 4096
    assert c_sb == sb
    for a, b in ((lanes, c_lanes), (st0, c_st0)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], k)


def test_plan_pads_like_the_stacks_at_paper_scale():
    """At 2^16 pages and 36 profiles the padding budget, not the
    power-of-two bucket, sets the fill count; the plan pads to the same
    counts as ``_pad_stack`` would."""
    P = 1 << 16
    m = tpt.make_mapping(np.arange(P, dtype=np.int64))
    rows = [tlp._plan_row(0, m, ("ka", (k,))) for k in range(36)]
    clus = [tlp._ZERO_ROW] + [tlp._plan_row(0, m, ("clus",))] * 4
    plan = tlp._record_plan(rows, clus, P, P)
    rec = np.zeros((P, tlp.FILL_REC_WIDTH), np.int32)
    assert plan.n_fill == tlp._pad_stack([rec] * 36, floor=tlp.FILL_REC_FLOOR
                                         ).shape[0] == 36
    assert plan.rows.shape[0] - plan.n_fill == tlp._pad_stack(
        [np.zeros(P, np.int32)] * 5).shape[0] == 8
    assert plan.n_real == 40


def test_build_records_refuses_what_it_cannot_index():
    cells = world_cells(T, "static")
    _, stacks, _, _ = tlp.pack_lanes(cells, record_plan=True)
    plan, maps = stacks["plan"], _maps(stacks)
    R = maps.shape[0]

    def bad(col, value):
        rows = plan.rows.copy()
        real = np.flatnonzero(rows[:, tlp.PLAN_CODE]
                              == tlp.REC_CODE["kaligned"])[0]
        rows[real, col] = value
        return tlp.RecordPlan(rows, plan.n_fill, plan.clus_width)

    for col, value in ((tlp.PLAN_MAP, R), (tlp.PLAN_MAP, -1),
                       (tlp.PLAN_PAGES, maps.shape[1] + 1),
                       (tlp.PLAN_CODE, tlp.REC_CODE["cluster"]),
                       (tlp.PLAN_CODE, len(tlp.REC_CODES)),
                       (len(tlp.PLAN_FIELDS), tops.MAX_CLASS + 1)):
        with pytest.raises(ValueError):
            tops.build_records(bad(col, value), maps)
    with pytest.raises(ValueError):
        tops.build_records(plan, maps.to(torch.int64))
    for width in (1, 2):           # real cluster rows are P wide
        with pytest.raises(ValueError):
            tops.build_records(tlp.RecordPlan(plan.rows, plan.n_fill, width),
                               maps)


def test_as_tensors_builds_the_plan_where_the_stacks_were():
    """The upload builds the records right after the map records, so the
    stacks come out (and are allocated) in the host packing's order."""
    cells = world_cells(T, "static")
    lanes, host, st0, _ = pack_batch(cells)
    c_lanes, card, c_st0, _ = pack_batch(cells, "cuda")
    _, got, _ = tops.as_tensors(c_lanes, card, c_st0, "cpu")
    assert list(got) == list(host) == ["maps", "fills", "clus", "dirty",
                                       "trace"]
    for k in host:
        np.testing.assert_array_equal(got[k].numpy(), host[k], k)


def test_run_lanes_with_a_plan_equals_host_records_on_cpu():
    """The plain sweep over records built from the plan gives the host
    records' results (a short trace: the plain sweep is slow)."""
    cells = [SweepCell(c.spec, c.mapping, c.trace[:48])
             for c in world_cells(T, "static")]
    lanes, stacks, st0, sb = pack_batch(cells)
    _, c_stacks, _, _ = pack_batch(cells, "cuda")
    a_st, a_pp = tops.run_lanes(lanes, stacks, st0, sb, device="cpu")
    b_st, b_pp = tops.run_lanes(lanes, c_stacks, st0, sb, device="cpu")
    for k in ("counters", "cov_samples"):
        np.testing.assert_array_equal(a_st[k].numpy(), b_st[k].numpy(), k)
    np.testing.assert_array_equal(a_pp.numpy(), b_pp.numpy())


def test_run_sweep_on_cpu_packs_every_record_on_the_host(monkeypatch):
    """The CPU path reaches ``_fill_profile`` and ``cluster_bitmap``
    through the module's attributes (a test of the benchmark patches the
    first there) and builds nothing from a plan."""
    calls = {"_fill_profile": 0, "cluster_bitmap": 0}
    for name in calls:
        real = getattr(tlp, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(tlp, name, counted)
    built = []
    monkeypatch.setattr(tops, "build_records",
                        lambda *a, **k: built.append(1))
    cells = [SweepCell(c.spec, c.mapping, c.trace[:32])
             for c in world_cells(T, "static")]
    res = run_sweep(cells, cache=False, device="cpu")
    n_prof = len({tlp._fill_profile_key(c.spec) for c in cells})
    assert calls == {"_fill_profile": n_prof, "cluster_bitmap": 1}
    assert not built
    assert res.stats["records_on_card"] == 0
    assert len(res.results) == len(cells)


def test_thp_record_matches_huge_page_backed():
    """The plain version's 2MB test is ``page_table.huge_page_backed``."""
    m = _edge_mapping(1 << 12, 5)
    cells = [SweepCell(T.baselines.thp_spec(), m, np.zeros(2, np.int64))]
    _, card, _, _ = tlp.pack_lanes(cells, record_plan=True)
    fills = tops.build_records(card["plan"], _maps(card))["fills"][0]
    huge = tpt.huge_page_backed(m)
    assert huge.any() and not huge.all()
    np.testing.assert_array_equal(
        fills[: m.n_pages, 1].numpy() == tsim.HUGE, huge)


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_pack_breakdown_adds_up_on_the_card_path():
    """``chip_smoke.pack_breakdown`` of the card path times the plan's
    functions in place of the record functions, adds up, and packs what
    ``pack_batch(cells, "cuda")`` packs."""
    cs = _chip_smoke()
    cells = world_cells(T, "static")
    (lanes, stacks, st0, sb), spent = cs.pack_breakdown(cells, "cuda")
    want = pack_batch(cells, "cuda")
    assert set(stacks) == set(want[1]) and sb == want[3]
    for k in stacks:
        got = stacks[k].rows if k == "plan" else stacks[k]
        np.testing.assert_array_equal(
            got, want[1][k].rows if k == "plan" else want[1][k], k)
    for d, w in ((lanes, want[0]), (st0, want[2])):
        for k in d:
            np.testing.assert_array_equal(d[k], w[k], k)
    parts = [v for k, v in spent.items() if k != "total"]
    assert spent["total"] == pytest.approx(sum(parts))
    assert spent["_fill_profile"] == spent["cluster_bitmap"] == 0
    assert spent["_plan_row"] > 0 and spent["_record_plan"] > 0
    assert min(v for k, v in spent.items() if k != "rest") >= 0


def test_chip_smoke_records_bound_counts_every_byte_built():
    cs = _chip_smoke()
    cells = world_cells(T, "multitenant")
    _, card, _, _ = pack_batch(cells, "cuda")
    plan, maps = card["plan"], _maps(card)
    built = tops.build_records(plan, maps)
    n_maps = len({int(r[tlp.PLAN_MAP]) for r in plan.rows
                  if r[tlp.PLAN_CODE] != tlp.REC_CODE["zero"]})
    assert n_maps == 3
    assert cs.records_bound_bytes(plan, maps.shape[1]) == (
        built["fills"].numel() * 4 + built["clus"].numel() * 4
        + n_maps * maps[0].numel() * 4)
