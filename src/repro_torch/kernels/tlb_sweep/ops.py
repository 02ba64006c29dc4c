"""Public op: run a packed sweep batch through the TLB-sweep kernel.

:func:`run_lanes` takes the packed ``(lanes, stacks, st0, seg_bounds)`` of
:func:`repro_torch.core.lane_program.pack_lanes` /
:func:`~repro_torch.core.lane_program.init_batched_state` and returns
``(final_state, ppns)``: ``final_state`` holds ``counters [L, 9]`` and
``cov_samples [L, 64]``, ``ppns [L, T]`` is in trace order.  It dispatches
on the device of its tensors: CPU tensors run the plain version
(:func:`.ref.run_lanes_ref`), CUDA tensors launch the CUDA kernel
(``csrc/tlb_sweep.cu``) or raise — there is no fallback from one to the
other.  ``LAUNCHES["tlb_sweep"]`` counts the kernel's launches.
:func:`prepare_cuda` also keeps the cycles each lane's block took
(``PreparedBatch.cycles``), and :func:`round_cycles` measures the card's
dependent shared-memory round, the floor of one serial step.

A batch packed for the card (``pack_lanes(..., record_plan=True)``) holds
a :class:`~repro_torch.core.lane_program.RecordPlan` under
``stacks["plan"]`` in place of the ``fills`` and ``clus`` stacks:
:func:`as_tensors` builds those two stacks where the map records now
lie as soon as they are uploaded, with :func:`build_records` (the
``tlb_records_kernel`` on the card, counted in ``LAUNCHES
["tlb_records"]``; :func:`build_records_ref`, the plain version, on the
CPU).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ...core.lane_program import (PLAN_CODE, PLAN_FIELDS, PLAN_MAP,
                                  PLAN_PAGES, REC_CODE, REC_CODES,
                                  RecordPlan, needs_switch_pass)
from ...core.plane_layout import FILL_REC_WIDTH, MAP_REC_WIDTH
from ...core.simulator import HUGE, KSUBR, REGULAR, SUBR_PAGES
from .ref import run_lanes_ref

# params row layout (int32): one row per lane, in this order; the kernel
# reads it through the F_* indices of csrc/tlb_lane.cuh (held against this
# tuple by tests/test_torch_core.py).
PARAM_KEYS = ("is_colt", "is_thp", "has_rmm", "has_cluster", "use_pred",
              "set_mask", "n_ways", "k_hat", "miss_chain", "pred0",
              "asid0", "t_real", "sample_every", "is_subr", "has_ctlb",
              "use_dead", "coh_hw")
N_PARAM_FIELDS = len(PARAM_KEYS)
# the per-(lane, segment) planes, stacked [9, L, n_segs] for the kernel
# (csrc/tlb_lane.cuh S_* indices)
SEG_KEYS = ("seg_map", "seg_fill", "seg_clus", "seg_dirty", "seg_shoot",
            "seg_asid", "seg_switch", "seg_fall", "seg_fasid")
MAXK_CAP = 16                 # widest kvals row the kernel takes
WARP = 32                     # widest structure: one way per thread of a warp
MAX_CLASS = 30                # largest alignment class the kernel takes
SMEM_LIMIT = 232_448          # bytes of shared memory a block may use (H100)

#: kernel launches so far, by kernel name (plain-version runs not counted)
LAUNCHES: Dict[str, int] = {"tlb_sweep": 0, "tlb_records": 0}


def pack_params(lanes) -> torch.Tensor:
    """[L, N_PARAM_FIELDS] int32 per-lane scalar block for the kernel, on
    the device of ``lanes`` (tensors) or the CPU (numpy arrays)."""
    return torch.stack([torch.as_tensor(lanes[k]).to(torch.int32)
                        for k in PARAM_KEYS], 1).contiguous()


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        t = a.to(device)
    else:
        a = np.asarray(a)
        t = torch.from_numpy(np.ascontiguousarray(
            a if a.dtype == np.bool_ else a.astype(np.int32, copy=False)))
        t = t.to(device)
    if t.dtype not in (torch.bool, torch.int32):
        t = t.to(torch.int32)
    return t.contiguous()


def as_tensors(lanes, stacks, st0, device):
    """The packed batch as contiguous tensors on ``device``: bool planes
    stay bool, everything else is int32.  A record plan in
    ``stacks["plan"]`` is built into the ``fills`` and ``clus`` stacks
    (:func:`build_records`) as soon as the map records are on ``device``,
    so the built stacks take the uploaded ones' place in the order of
    allocation."""
    conv = lambda d: {k: _tensor(v, device) for k, v in d.items()}  # noqa: E731
    out = {}
    for k, v in stacks.items():
        if k != "plan":
            out[k] = _tensor(v, device)
        if k == "maps" and "plan" in stacks:
            out.update(build_records(stacks["plan"], out["maps"]))
    return conv(lanes), out, conv(st0)


def run_lanes(lanes, stacks, st0, seg_bounds,
              device: Optional[torch.device] = None):
    """Simulate one packed batch.  With ``device`` the arrays (numpy or
    tensors) are moved there first; the run then goes wherever the
    tensors lie — the plain version on the CPU, the kernel on CUDA.  A
    record plan in ``stacks["plan"]`` is built into the ``fills`` and
    ``clus`` stacks beside the map records (:func:`as_tensors`)."""
    if device is None and "plan" in stacks:
        device = stacks["maps"].device
    if device is not None:
        lanes, stacks, st0 = as_tensors(lanes, stacks, st0, device)
    dev = stacks["trace"].device
    if dev.type == "cpu":
        return run_lanes_ref(lanes, stacks, st0, tuple(seg_bounds))
    if dev.type == "cuda":
        return prepare_cuda(lanes, stacks, st0, tuple(seg_bounds))()
    raise ValueError(f"no TLB-sweep implementation for device {dev}")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError("tlb_sweep: " + msg)


# ---------------------------------------------------------------------------
# The fill and cluster records, built from the map records
# ---------------------------------------------------------------------------


def build_records(plan: RecordPlan, maps: torch.Tensor):
    """The ``fills [n_fill, P, FILL_REC_WIDTH]`` and ``clus [n_clus,
    clus_width]`` stacks of ``plan`` (a
    :class:`~repro_torch.core.lane_program.RecordPlan`, host data) from
    the ``maps [R, P, 4]`` stack, on the device of ``maps``: CUDA tensors
    launch ``tlb_records_kernel`` (``csrc/tlb_records.cu``) once, and
    count it in ``LAUNCHES["tlb_records"]``, or raise; CPU tensors run
    :func:`build_records_ref`.  Either equals the host packing's stacks
    (``pack_lanes`` without ``record_plan``) bit for bit."""
    _check_plan(plan, maps)
    if maps.device.type == "cpu":
        return build_records_ref(plan, maps)
    if maps.device.type != "cuda":
        raise ValueError(f"no way to build records on device {maps.device}")
    from . import _build

    R, P, _ = maps.shape
    # pinned, so the copy queues behind the stream's work and the host
    # does not wait for it
    rows = torch.from_numpy(np.ascontiguousarray(plan.rows, np.int32)
                            ).pin_memory().to(maps.device, non_blocking=True)
    n_clus = rows.shape[0] - plan.n_fill
    fills = torch.empty((plan.n_fill, P, FILL_REC_WIDTH), dtype=torch.int32,
                        device=maps.device)
    clus = torch.empty((n_clus, plan.clus_width), dtype=torch.int32,
                       device=maps.device)
    lib = _build.load()
    with torch.cuda.device(maps.device):
        stream = torch.cuda.current_stream(maps.device).cuda_stream
        rc = lib.tlb_records_launch(
            rows.data_ptr(), plan.n_fill, n_clus, rows.shape[1],
            maps.data_ptr(), P, plan.clus_width, fills.data_ptr(),
            clus.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("tlb_records kernel launch failed: "
                           + lib.tlb_sweep_error_string(rc).decode())
    LAUNCHES["tlb_records"] += 1
    return dict(fills=fills, clus=clus)


def _check_plan(plan: RecordPlan, maps: torch.Tensor) -> None:
    """Every index the record kernel and its plain version follow is in
    range (host data only: no read from the card)."""
    _check(maps.dtype == torch.int32 and maps.dim() == 3
           and maps.shape[2] == MAP_REC_WIDTH and maps.is_contiguous(),
           "maps must be a contiguous int32 [R, P, 4]")
    R, P, _ = maps.shape
    rows = np.asarray(plan.rows)
    nf = len(PLAN_FIELDS)
    _check(rows.dtype == np.int32 and rows.ndim == 2 and rows.shape[1] >= nf
           and 0 <= plan.n_fill <= rows.shape[0],
           "the plan must be int32 [n_fill + n_clus, >= 3] rows")
    code, real = rows[:, PLAN_CODE], rows[:, PLAN_CODE] != REC_CODE["zero"]
    fill_codes = [REC_CODE[c] for c in REC_CODES if c != "cluster"]
    _check(np.isin(code[: plan.n_fill], fill_codes).all()
           and np.isin(code[plan.n_fill:], [REC_CODE["zero"],
                                             REC_CODE["cluster"]]).all(),
           "a fill row has a fill profile, a cluster row the cluster code")
    _check(plan.clus_width == P
           or (plan.clus_width == 1 and not real[plan.n_fill:].any()),
           "a cluster record is P wide (1 when every one is a pad)")
    _check(((rows[real, PLAN_MAP] >= 0) & (rows[real, PLAN_MAP] < R)).all()
           and ((rows[real, PLAN_PAGES] >= 0)
                & (rows[real, PLAN_PAGES] <= P)).all(),
           "plan rows name a map record of the stack and at most P pages")
    ks = rows[:, nf:]
    _check(((ks >= -1) & (ks <= MAX_CLASS)).all(),
           f"plan classes must lie in -1..{MAX_CLASS}")


@torch.no_grad()
def build_records_ref(plan: RecordPlan, maps: torch.Tensor):
    """Plain PyTorch version of :func:`build_records`, on the device of
    ``maps``: each record's rows computed at once over its ``n_pages``
    vpns from its map record."""
    R, P, _ = maps.shape
    dev = maps.device
    rows = np.asarray(plan.rows).tolist()
    nf = len(PLAN_FIELDS)
    fills = torch.zeros((plan.n_fill, P, FILL_REC_WIDTH), dtype=torch.int32,
                        device=dev)
    clus = torch.zeros((len(rows) - plan.n_fill, plan.clus_width),
                       dtype=torch.int32, device=dev)
    for r, row in enumerate(rows):
        mid, n, code = row[PLAN_MAP], row[PLAN_PAGES], row[PLAN_CODE]
        if code == REC_CODE["zero"]:
            continue
        if r >= plan.n_fill:
            if n:
                clus[r - plan.n_fill, :n] = _cluster_ref(maps[mid, :n])
            continue
        fills[r, :, 1] = REGULAR
        if n:
            ks = []
            for k in row[nf:]:
                if k < 0:
                    break
                ks.append(k)
            fills[r, :n] = _fill_ref(maps[mid, :n], code, ks)
    return dict(fills=fills, clus=clus)


def _fill_ref(m: torch.Tensor, code: int, ks) -> torch.Tensor:
    """[n, FILL_REC_WIDTH] rows of one fill record from its map rows."""
    ppn, rs, rl = (m[:, i].long() for i in range(3))
    n = ppn.shape[0]
    vpn = torch.arange(n, device=m.device)

    def at(v):
        return v.clamp(0, n - 1)

    def contig_at(v):
        v = at(v)
        return torch.where(ppn[v] >= 0, rs[v] + rl[v] - v, 0)

    tag, kcls = vpn.clone(), torch.full_like(vpn, REGULAR)
    contig, fppn, aux = torch.ones_like(vpn), ppn.clone(), torch.zeros_like(
        vpn)
    if code == REC_CODE["kaligned"]:
        chosen = torch.zeros(n, dtype=torch.bool, device=m.device)
        for k in ks:
            vk = vpn & ~((1 << k) - 1)
            sc = torch.minimum(contig_at(vk), torch.full_like(vk, 1 << k))
            take = (sc > vpn - vk) & ~chosen
            tag = torch.where(take, vk, tag)
            kcls = torch.where(take, k, kcls)
            contig = torch.where(take, sc, contig)
            fppn = torch.where(take, ppn[at(vk)], fppn)
            chosen |= take
    elif code == REC_CODE["colt"]:
        span = 8
        w8 = vpn & ~(span - 1)
        tag = torch.maximum(rs, w8)
        contig = (torch.minimum(rs + rl, w8 + span) - tag).clamp_min(1)
        kcls = torch.where(contig > 1, 3, REGULAR)
        fppn = ppn[at(tag)]
    elif code == REC_CODE["thp"]:
        # a 2MB window backs vpn when it is whole, contiguous from its
        # base and 2MB-aligned in physical memory
        pages = 1 << HUGE
        base = vpn & ~(pages - 1)
        b = base.clamp_max(n - 1)
        huge = ((base + pages <= n) & (contig_at(b) >= pages)
                & ((ppn[b] & (pages - 1)) == 0))
        tag = torch.where(huge, vpn >> HUGE, vpn)
        kcls = torch.where(huge, HUGE, REGULAR)
        contig = torch.where(huge, 1 << HUGE, 1)
        fppn = ppn[at(torch.where(huge, (vpn >> HUGE) << HUGE, vpn))]
    elif code == REC_CODE["subregion"]:
        base = vpn & ~(SUBR_PAGES - 1)
        bitmap = torch.zeros_like(vpn)
        for j in range(SUBR_PAGES):
            pj = at(base + j)
            ok = (base + j < n) & (ppn[pj] >= 0) & (ppn[pj] - pj == ppn - vpn)
            bitmap |= ok.long() << j
        mapped = ppn >= 0
        popc = sum((bitmap >> j) & 1 for j in range(SUBR_PAGES))
        tag = torch.where(mapped, base, tag)
        kcls = torch.where(mapped, KSUBR, kcls)
        contig = torch.where(mapped, popc, contig)
        fppn = torch.where(mapped, ppn - (vpn - base), fppn)
        aux = torch.where(mapped, bitmap, 0)
    return torch.stack([tag, kcls, contig, fppn, aux], 1).to(torch.int32)


def _cluster_ref(m: torch.Tensor) -> torch.Tensor:
    """[n] words of one cluster record from its map rows: bit j of vpn's
    word says page j of its 8-page window maps into vpn's 8-frame
    physical cluster."""
    ppn = m[:, 0].long()
    n = ppn.shape[0]
    win = 1 << 3
    vpn = torch.arange(n, device=m.device)
    base = vpn & ~(win - 1)
    word = torch.zeros_like(vpn)
    for j in range(win):
        pj = (base + j).clamp(0, n - 1)
        ok = (base + j < n) & (ppn[pj] != -1) & (ppn[pj] >> 3 == ppn >> 3)
        word |= ok.long() << j
    return torch.where(ppn != -1, word, 0).to(torch.int32)


class PreparedBatch:
    """One checked batch laid out on the card (see :func:`prepare_cuda`).
    Calling it launches the kernel once, counts the launch and returns
    ``(final_state, ppns)``; ``cycles`` is then the ``[L]`` int64 tensor of
    the clock64() cycles each lane's block took in that launch."""

    def __init__(self, lib, ptrs, ints, shape):
        self.lib, self.ptrs, self.ints = lib, ptrs, ints
        self.L, self.T, self.device = shape
        self.cycles: Optional[torch.Tensor] = None

    def __call__(self):
        L, T, dev = self.L, self.T, self.device
        ppn = torch.empty((L, T), dtype=torch.int32, device=dev)
        counters = torch.empty((L, 9), dtype=torch.int32, device=dev)
        cov = torch.empty((L, 64), dtype=torch.int32, device=dev)
        cycles = torch.empty(L, dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = self.lib.tlb_sweep_launch(
                *[t.data_ptr() for t in self.ptrs], ppn.data_ptr(),
                counters.data_ptr(), cov.data_ptr(), cycles.data_ptr(),
                *self.ints, stream)
        if rc != 0:
            raise RuntimeError("tlb_sweep kernel launch failed: "
                               + self.lib.tlb_sweep_error_string(rc).decode())
        LAUNCHES["tlb_sweep"] += 1
        self.cycles = cycles
        return dict(counters=counters, cov_samples=cov), ppn


@torch.no_grad()
def prepare_cuda(lanes, stacks, st0, seg_bounds) -> PreparedBatch:
    """Check and lay out one packed batch of CUDA tensors for the kernel;
    returns a :class:`PreparedBatch` that launches it (and counts the
    launch) when called — so a timing loop measures the launch alone,
    without the host-side checks.

    ``st0`` must be the fresh state of ``init_batched_state``: the kernel
    builds that state itself in shared memory and reads only its geometry
    (L2 sets/ways, cache-backed tier, dead-entry table) from ``st0``.  A
    structure probed one way per thread must fit the warp: more than 32
    L2 or cache-tier ways are refused, as are classes outside -1..30."""
    from . import _build

    dev = stacks["trace"].device
    tensors = [*lanes.values(), *stacks.values(), *st0.values()]
    _check(all(t.device == dev for t in tensors),
           "every tensor must lie on one CUDA device")
    _check(all(t.is_contiguous() for t in tensors),
           "every tensor must be contiguous")
    maps, fills = stacks["maps"], stacks["fills"]
    clus, dirty, trace = stacks["clus"], stacks["dirty"], stacks["trace"]
    for name, t in stacks.items():
        _check(t.dtype == torch.int32, f"stacks[{name!r}] must be int32")
    L = lanes["t_real"].shape[0]
    R, P, mw = maps.shape
    _check(mw == 4 and fills.dim() == 3 and fills.shape[1:] == (P, 5),
           "maps must be [R, P, 4] and fills [R', P, 5]")
    _check(dirty.dim() == 2 and dirty.shape[1] == P + 1,
           "dirty must be [R, P + 1]")
    Pc = clus.shape[1]
    n_tr, T = trace.shape
    n_segs = len(seg_bounds) - 1
    _check(seg_bounds[0] == 0 and seg_bounds[-1] == T
           and all(a < b for a, b in zip(seg_bounds, seg_bounds[1:])),
           "seg_bounds must rise strictly from 0 to the trace length")
    _, sets, ways, _ = st0["l2"].shape
    _, ctlb_sets, ctlb_ways, _ = st0["ctlb"].shape
    dp_n = st0["dp"].shape[1]
    for n, what in ((sets, "L2 sets"), (ctlb_sets, "cache-tier sets"),
                    (dp_n, "dead-entry table")):
        _check(n & (n - 1) == 0, f"{what} ({n}) must be a power of two")
    for n, what in ((ways, "L2 ways"), (ctlb_ways, "cache-tier ways")):
        _check(n <= WARP, f"{what} ({n}) must be at most {WARP}: the kernel "
               "probes one way per thread of a warp")
    kvals = lanes["kvals"].to(torch.int32).contiguous()
    maxk = kvals.shape[1]
    _check(maxk <= MAXK_CAP, f"at most {MAXK_CAP} alignment classes")

    params = pack_params(lanes)
    segs = torch.stack([lanes[k].to(torch.int32) for k in SEG_KEYS]
                       ).contiguous()
    _check(segs.shape == (len(SEG_KEYS), L, n_segs),
           "seg_* planes must be [L, n_segs]")
    trace_id = lanes["trace_id"].to(torch.int32).contiguous()

    # JAX clamps an out-of-range gather; a CUDA load reads garbage.  Check
    # on the host that every index the kernel follows is in range.
    set_mask = params[:, PARAM_KEYS.index("set_mask")]
    n_ways = params[:, PARAM_KEYS.index("n_ways")]
    lim = torch.stack([
        trace.min(), trace.max() - (P - 1),
        trace_id.min(), trace_id.max() - (n_tr - 1),
        segs[0].min(), segs[0].max() - (R - 1),
        segs[1].min(), segs[1].max() - (fills.shape[0] - 1),
        segs[2].min(), segs[2].max() - (clus.shape[0] - 1),
        segs[3].min(), segs[3].max() - (dirty.shape[0] - 1),
        set_mask.min(), set_mask.max() - (sets - 1),
        n_ways.min() - 1, n_ways.max() - ways,
        kvals.min() + 1, kvals.max() - MAX_CLASS,
    ]).cpu().tolist()
    names = ("trace vpn", "trace_id", "seg_map", "seg_fill", "seg_clus",
             "seg_dirty", "set_mask", "n_ways", "kvals")
    for i, name in enumerate(names):
        _check(lim[2 * i] >= 0 and lim[2 * i + 1] <= 0,
               f"{name} out of range for the packed stacks")

    lib = _build.load()
    smem = lib.tlb_sweep_smem_bytes(sets, ways, ctlb_sets, ctlb_ways, dp_n)
    _check(smem <= SMEM_LIMIT,
           f"one lane's state needs {smem} B of shared memory, more than "
           f"the {SMEM_LIMIT} B a block may use")

    bounds = torch.tensor(seg_bounds, dtype=torch.int32, device=dev)
    with_switch = int(needs_switch_pass(
        {k: lanes[k].cpu().numpy() for k in
         ("seg_switch", "seg_fall", "seg_fasid", "seg_asid", "asid0")}))
    ptrs = (params, kvals, segs, bounds, trace_id, trace, maps, fills, clus,
            dirty)
    ints = (L, maxk, n_segs, T, P, Pc, sets, ways, ctlb_sets, ctlb_ways,
            dp_n, with_switch)
    return PreparedBatch(lib, ptrs, ints, (L, T, dev))


def round_cycles(device="cuda", n: int = 1 << 16) -> float:
    """Cycles (clock64) of one dependent shared-memory load -> compare ->
    store round on the card, the floor of one step of a serial chain:
    ``tlb_round_kernel`` runs ``n`` such rounds on one thread."""
    from . import _build

    lib = _build.load()
    out = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        for _ in range(2):                     # the first run warms up
            rc = lib.tlb_round_launch(n, out.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError("tlb_round kernel launch failed: "
                                   + lib.tlb_sweep_error_string(rc).decode())
        cyc, word = out.cpu().tolist()
    if word != n:
        raise RuntimeError(f"tlb_round kernel ended on {word}, not {n}")
    return cyc / n
