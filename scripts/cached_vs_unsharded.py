"""How far the cached passes on a mesh move from the port's unsharded ones,
on gloo ranks on the CPU.

    PYTHONPATH=src python scripts/cached_vs_unsharded.py --mesh 2,1

Spawns one gloo rank per mesh position and runs ``tests/_dist_ranks.py``'s
``cached_passes`` for each reduced family of ``CACHE_ARCHS`` (prefill and
prefill_chunked under "default", greedy decode steps under "decode", from
the same seeded weights and prompt), then the same passes unsharded in
this process, and prints one JSON line per family: the largest logit
difference of each pass, the largest difference of any state leaf after
each pass, and whether every greedy token is the same (the bounds
``tests/test_torch_distributed.py``'s ``test_cached_passes_on_mesh``
holds them to).  A CPU measurement: no device number.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(HERE, "src"), os.path.join(HERE, "tests")]

import _dist_ranks as R  # noqa: E402


def _ranks(rank, world, tmp, shape, archs):
    from repro_torch.launch.mesh import make_test_mesh
    R.init(rank, world, tmp)
    mesh = make_test_mesh(shape, device_type="cpu")
    R.save(tmp, "out", {arch: R.cached_passes(arch, mesh) for arch in archs})
    R.done()


def _unsharded(arch):
    """The unsharded port's passes of ``R.cached_passes``' case: logits
    per pass (decode: per step) and each pass's state, as numpy."""
    from repro_torch.checkpoint.checkpointer import leaf_paths
    from repro_torch.models import params_from_numpy
    model, P, toks = R.cache_setup(arch)
    c = R.CACHE
    p = params_from_numpy(P, device="cpu")
    t = torch.from_numpy(toks)

    def state(st):
        return {k: x.numpy().copy() for k, x in leaf_paths(st)}
    out = {}
    with torch.no_grad():
        lg, st = model.prefill(p, t, max_seq=c["max_seq"])
        out["prefill"] = (lg.numpy(), state(st))
        lc, sc = model.prefill_chunked(p, t, n_chunks=c["chunks"],
                                       max_seq=c["max_seq"])
        out["chunked"] = (lc.numpy(), state(sc))
        nxt, steps = R.greedy(lg), []
        for step in range(c["steps"]):
            l2, st = model.decode_step(p, st, nxt, torch.full(
                (c["batch"],), c["seq"] + step))
            steps.append((nxt.numpy(), l2.numpy()))
            nxt = R.greedy(l2)
        out["decode"] = (steps, state(st))
    return out


def _rows(got, key):
    """Rank outputs of pass ``key`` in data-coordinate order (model rank
    0 of each)."""
    by = {}
    for mine, rec in got["ranks"]:
        by.setdefault(rec["coordinate"][0], mine[key])
    return [by[d] for d in sorted(by)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="1,2", help="data,model sizes")
    ap.add_argument("--arch", action="append", choices=R.CACHE_ARCHS,
                    help="a family (repeatable; default all)")
    args = ap.parse_args()
    shape = tuple(int(a) for a in args.mesh.split(","))
    archs = tuple(args.arch or R.CACHE_ARCHS)
    with tempfile.TemporaryDirectory() as tmp:
        R.spawn(_ranks, int(np.prod(shape)), tmp, shape, archs, timeout=900)
        got = torch.load(os.path.join(tmp, "out.pt"), weights_only=False)
    for arch in archs:
        want = _unsharded(arch)
        res = dict(mesh=shape, arch=arch)
        for key in ("prefill", "chunked"):
            lg = np.concatenate(_rows(got[arch], key))
            res[f"{key}_logits"] = float(np.abs(lg - want[key][0]).max())
        steps = _rows(got[arch], "decode")
        same, worst = True, 0.0
        for s, (toks, lg) in enumerate(want["decode"][0]):
            mine = np.concatenate([r[s][1] for r in steps])
            same &= np.array_equal(np.concatenate([r[s][0] for r in steps]),
                                   toks)
            worst = max(worst, float(np.abs(mine - lg).max()))
        res["decode_logits"], res["tokens_equal"] = worst, bool(same)
        for key in ("prefill", "chunked", "decode"):
            res[f"{key}_state"] = max(
                float(np.abs(x - want[key][1][path]).max())
                for path, (_, _, x) in got[arch][key].items())
        print(json.dumps(res))


if __name__ == "__main__":
    main()
