"""The plain PyTorch version of the TLB-sweep kernel.

:func:`run_lanes_ref` has the contract of the kernel's wrapper
(:func:`repro_torch.kernels.tlb_sweep.ops.run_lanes`): it takes the packed
batch of :func:`repro_torch.core.lane_program.pack_lanes` as tensors on one
device and returns ``(final_state, ppns)``, where ``final_state`` carries
``counters [L, 9]`` and ``cov_samples [L, 64]`` and ``ppns [L, T]`` is in
trace order.  It is the reference's step-at-a-time executor
(``kernels/tlb_sweep/ref.py::run_lanes_ref`` of the JAX package) with the
``vmap`` written out as the lane axis: a Python loop over segments and
steps calling the batched :func:`~repro_torch.core.lane_program.
step_access`, with :func:`~repro_torch.core.lane_program.switch_lane` and
:func:`~repro_torch.core.lane_program.shoot_lane` at every segment entry.

It runs on whatever device its tensors are on: the CPU tests use it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch

from ...core.lane_program import (STEP_KEYS, shoot_lane, step_access,
                                  switch_lane)


@torch.no_grad()
def run_lanes_ref(lanes, stacks, st0, seg_bounds):
    """Step-at-a-time plain version; ``lanes``/``stacks``/``st0`` are
    dicts of tensors on one device (see ``ops.as_tensors``)."""
    map_stack = stacks["maps"]
    fill_stack = stacks["fills"]
    clus_map = stacks["clus"]
    dirty_stack = stacks["dirty"]
    trace_stack = stacks["trace"]
    Pc = clus_map.shape[1]
    params = {k: lanes[k] for k in STEP_KEYS}
    trace = trace_stack[lanes["trace_id"].long()]          # [L, T]
    t_real = lanes["t_real"]
    st = dict(st0)
    outs = []
    for seg, (lo, hi) in enumerate(zip(seg_bounds, seg_bounds[1:])):
        if seg > 0:
            st = switch_lane(st, lanes["seg_asid"][:, seg],
                             lanes["seg_switch"][:, seg],
                             lanes["seg_fall"][:, seg],
                             lanes["seg_fasid"][:, seg])
            st = shoot_lane(params, st,
                            dirty_stack[lanes["seg_dirty"][:, seg].long()],
                            lanes["seg_shoot"][:, seg])
        smap = lanes["seg_map"][:, seg].long()
        sfill = lanes["seg_fill"][:, seg].long()
        sclus = lanes["seg_clus"][:, seg].long()
        for t in range(lo, hi):
            vpn = trace[:, t]
            v = vpn.long()
            mrec = map_stack[smap, v]
            frec = fill_stack[sfill, v]
            bm = clus_map[sclus, v.clamp(0, Pc - 1)]
            st, pp = step_access(params, st, vpn, mrec, frec, bm, t < t_real)
            outs.append(pp)
    return st, torch.stack(outs, 1)
