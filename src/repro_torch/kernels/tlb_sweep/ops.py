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
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ...core.lane_program import needs_switch_pass
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
LAUNCHES: Dict[str, int] = {"tlb_sweep": 0}


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
    stay bool, everything else is int32."""
    conv = lambda d: {k: _tensor(v, device) for k, v in d.items()}  # noqa: E731
    return conv(lanes), conv(stacks), conv(st0)


def run_lanes(lanes, stacks, st0, seg_bounds,
              device: Optional[torch.device] = None):
    """Simulate one packed batch.  With ``device`` the arrays (numpy or
    tensors) are moved there first; the run then goes wherever the
    tensors lie — the plain version on the CPU, the kernel on CUDA."""
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
