"""How far a sharded (tensor-parallel) train step of a reduced case moves
from the port's unsharded step, on gloo ranks on the CPU.

    PYTHONPATH=src python scripts/tp_step_vs_unsharded.py \
        --mesh 1,2 --case hubert-xlarge --kind adamw

Spawns one gloo rank per mesh position (``tests/_dist_ranks.py``'s
cases, weights and batch), runs one sharded step at step 1, and prints one
JSON line: both steps' metrics; the gradients' largest difference overall
and where the unsharded |g| is between 1e-7 and 1e-5; and the parameters'
largest difference overall and where |g| > 1e-6, with the number of such
parameters past 1e-6 (the bounds ``tests/test_torch_distributed.py``'s
``_check_step`` holds a step to).  A CPU measurement: no device number.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(HERE, "src"), os.path.join(HERE, "tests")]

import _dist_ranks as R  # noqa: E402


def _ranks(rank, world, tmp, shape, case, kind):
    from repro_torch.checkpoint.checkpointer import leaf_paths
    from repro_torch.distributed.sharding import (batch_axes, gather,
                                                  param_sharding,
                                                  reduce_grad)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import params_from_numpy
    from repro_torch.models.common import logical_tree, spec_shapes
    from repro_torch.train.train_step import _accumulate, _split_micro
    R.init(rank, world, tmp)
    mesh = make_test_mesh(shape, device_type="cpu")
    step = R.sharded_step(case, kind, mesh)
    # the step's gradients: each rank's rows of each global microbatch
    model, _, P, b = R.train_setup(case, kind)
    model = dataclasses.replace(model, mesh=mesh)
    specs = model.specs()
    psh = dict(leaf_paths(param_sharding(logical_tree(specs),
                                         spec_shapes(specs), mesh)))
    full = params_from_numpy(P, device="cpu")
    local = model.local_params(_sharded(full, psh))
    axes = batch_axes(mesh)
    n = model.rc.microbatches
    idx = mesh.get_coordinate()[0]
    n_dp = mesh.shape[0]
    micro = _split_micro({k: torch.from_numpy(v) for k, v in b.items()}, n)

    def rows(i):
        out = {}
        for k, v in micro.items():
            bm = v.shape[1] // n_dp
            out[k] = v[i, idx * bm:(idx + 1) * bm]
        return out
    g, _ = _accumulate(model, local, rows, n)
    grads = {p: gather(reduce_grad(x, psh[p], axes, full_leaf.shape))
             .numpy() for (p, x), (_, full_leaf)
             in zip(leaf_paths(g), leaf_paths(full))}
    R.save(tmp, "out", (step, grads))
    R.done()


def _sharded(full, psh):
    from repro_torch.checkpoint.checkpointer import leaf_paths, rebuild
    from repro_torch.distributed.sharding import shard_local
    return rebuild(full, {p: shard_local(x, psh[p])
                          for p, x in leaf_paths(full)})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="1,2", help="data,model sizes")
    ap.add_argument("--case", default="hubert-xlarge",
                    choices=sorted(R.TRAIN_CASES))
    ap.add_argument("--kind", default="adamw",
                    choices=("adamw", "adamw8bit", "adafactor"))
    args = ap.parse_args()
    shape = tuple(int(a) for a in args.mesh.split(","))
    from repro_torch.checkpoint.checkpointer import leaf_paths
    from repro_torch.models import params_from_numpy
    from repro_torch.optim import init_opt
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import _accumulate, _split_micro
    with tempfile.TemporaryDirectory() as tmp:
        R.spawn(_ranks, int(np.prod(shape)), tmp, shape, args.case,
                args.kind)
        (met, params), grads = torch.load(os.path.join(tmp, "out.pt"),
                                          weights_only=False)
    model, oc, P, b = R.train_setup(args.case, args.kind)
    tp = params_from_numpy(P, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want_p, _, want_met = make_train_step(model, oc)(tp, init_opt(oc, tp),
                                                     tb, 1)
    n = model.rc.microbatches
    micro = _split_micro(tb, n)
    want_g, _ = _accumulate(model, tp, lambda i: {k: v[i] for k, v
                                                  in micro.items()}, n)
    want_g = {p: x.numpy() for p, x in leaf_paths(want_g)}
    g_all = g_small = p_all = p_well = 0.0
    past = 0
    for p, x in leaf_paths(want_p):
        w, gw = x.numpy(), want_g[p]
        dg = np.abs(grads[p] - gw)
        small = (np.abs(gw) > 1e-7) & (np.abs(gw) < 1e-5)
        g_all = max(g_all, float(dg.max()))
        if small.any():
            g_small = max(g_small, float(dg[small].max()))
        dp = np.abs(params[p] - w)
        well = np.abs(gw) > 1e-6
        p_all = max(p_all, float(dp.max()))
        if well.any():
            p_well = max(p_well, float(dp[well].max()))
            past += int((dp[well] > 1e-6).sum())
    print(json.dumps(dict(
        mesh=shape, case=args.case, kind=args.kind, metrics=met,
        unsharded_metrics={k: float(v) for k, v in want_met.items()},
        grad_max_diff=g_all, grad_max_diff_small=g_small,
        param_max_diff=p_all, param_max_diff_well=p_well,
        params_past_1e6_where_well=past,
        n_params=int(sum(x.numel() for _, x in leaf_paths(want_p))))))


if __name__ == "__main__":
    main()
