"""Time this checkout's flash-attention kernel against other checkouts'
builds of it, interleaved in one process on one card.

Each library is built from its checkout's
``src/repro_torch/kernels/flash_attention/csrc`` with the port's own nvcc
flags and loaded side by side; its C interface is read from the source:
``flash_attention_fwd(q, k, v, o, B, S, H, KVH, D, ...)`` up to the query
offset, ``(..., B, Sq, Skv, q_off, H, KVH, D, ...)`` since.  Every library
runs the same causal bf16 inputs at ``q_offset = 0`` (one InternLM2-1.8B
layer: B = 1, H = 16, KVH = 8, D = 128) at each ``--seq``; the outputs
must agree bit for bit.  A round times every library once with CUDA
events behind a queued spin (``chip_smoke.cuda_time_ms``), in the order
A B .. B A, so that a drift of the card's clock falls on both sides; the
report gives each library's median over the rounds and the spread of its
timings, and calls this library slower or faster than another only where
it loses (or wins) at least nine in ten of the pairs (each of this
library's timings against the other's in the same round and position)
and the medians differ by more than the other's interquartile distance;
otherwise the difference is within noise.

    python scripts/flash_ab.py --other base=DIR [--other NAME=DIR ...]

with DIR a checkout (e.g. ``git archive <commit>`` unpacked into
``build/``).  Writes ``chiprun_out/flash_ab.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CSRC = Path("src/repro_torch/kernels/flash_attention/csrc")
B, H, KVH, D = 1, 16, 8, 128


def _declare(with_offset: bool):
    def declare(lib):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = (
            [ptr] * 4 + [i32] * (7 if with_offset else 5)
            + [ptr, ctypes.c_float, i32, i32, ptr])
        lib.flash_attention_fwd.restype = i32
    return declare


def library(name: str, root: Path):
    """(NvccLibrary, with_offset) of the flash kernel in checkout ``root``."""
    from repro_torch.kernels._nvcc import NvccLibrary
    src = (root / CSRC / "flash_attention.cu").read_text()
    with_offset = bool(re.search(r"int flash_attention_fwd\([^)]*int Sq",
                                 src, re.S))
    return NvccLibrary(f"flash_attention_ab_{name}", root / CSRC,
                       "flash_attention.cu", ("flash_attention.cu",),
                       _declare(with_offset)), with_offset


def call(lib, with_offset, q, k, v, o):
    import torch
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    S = q.shape[1]
    dims = (B, S, S, 0, H, KVH, D) if with_offset else (B, S, H, KVH, D)
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *dims,
        ctypes.cast(strides, ctypes.c_void_p), 1.0 / math.sqrt(D), 1, 1,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd returned {rc}")


def verdict(this, other):
    """(this's wins of the pairs, the pairs, the other's interquartile
    distance, "slower" / "faster" / "within noise")."""
    wins = sum(a < b for a, b in zip(this, other))
    q1, _, q3 = statistics.quantiles(other, n=4)
    diff = statistics.median(this) - statistics.median(other)
    n = len(other)
    if abs(diff) > q3 - q1 and max(wins, n - wins) >= 0.9 * n:
        return wins, n, q3 - q1, "slower" if diff > 0 else "faster"
    return wins, n, q3 - q1, "within noise"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR", help="another checkout to time")
    ap.add_argument("--seq", type=int, nargs="+", default=[3072, 32768])
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE / "src"))
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    roots = {"this": HERE}
    for spec in args.other:
        name, _, d = spec.partition("=")
        roots[name] = Path(d).resolve()
    libs = {name: library(name, root) for name, root in roots.items()}
    with ThreadPoolExecutor(len(libs)) as ex:
        list(ex.map(lambda nl: nl[0].build(), libs.values()))
    loaded = {name: (nl.load(), off) for name, (nl, off) in libs.items()}
    card = cs.smi("name,power.limit")
    out = dict(card=card, shape=dict(B=B, H=H, KVH=KVH, D=D, causal=True,
                                     dtype="bfloat16", q_offset=0),
               libraries={n: str(r) for n, r in roots.items()},
               ptxas={n: [ln.strip() for ln in nl.ptxas_report().splitlines()
                          if "entry function" in ln or "registers" in ln
                          or "spill" in ln]
                      for n, (nl, _) in libs.items()}, seq={})
    print(f"card: {card}")
    names = list(loaded)
    order = names + names[::-1]
    for S in args.seq:
        g = torch.Generator(device="cuda").manual_seed(S)
        q, k, v = (torch.randn((B, S, h, D), generator=g, device="cuda",
                               dtype=torch.bfloat16) for h in (H, KVH, KVH))
        outs = {}
        for n, (lib, off) in loaded.items():
            outs[n] = torch.empty_like(q)
            call(lib, off, q, k, v, outs[n])
        torch.cuda.synchronize()
        same = {n: bool(torch.equal(outs[n], outs[names[0]])) for n in names}
        reps = 20 if S <= 4096 else 5
        times = {n: [] for n in names}
        for _ in range(args.rounds):
            for n in order:
                lib, off = loaded[n]
                o = outs[n]
                times[n].append(cs.cuda_time_ms(
                    lambda: call(lib, off, q, k, v, o), reps))
        med = {n: statistics.median(t) for n, t in times.items()}
        rows = {}
        for n in names:
            wins, pairs, iqr, word = verdict(times["this"], times[n])
            rows[n] = dict(median_ms=med[n], min_ms=min(times[n]),
                           max_ms=max(times[n]), iqr_ms=iqr,
                           this_over_it=med["this"] / med[n],
                           this_wins=wins, pairs=pairs, this_is=word,
                           bits_equal_this=same[n], timings_ms=times[n])
            print(f"S={S} {n:>6}: median {med[n]:.5f} ms of {pairs} "
                  f"timings (min {min(times[n]):.5f}, max "
                  f"{max(times[n]):.5f}, interquartile {iqr:.5f}); output "
                  f"== this one's bit for bit {same[n]}"
                  + (f"; this / it {med['this'] / med[n]:.4f}, this wins "
                     f"{wins} of {pairs} pairs: {word}"
                     if n != "this" else ""))
        out["seq"][str(S)] = rows
        if not all(same.values()):
            print(f"S={S}: outputs differ", file=sys.stderr)
            return 1
    os.makedirs(HERE / "chiprun_out", exist_ok=True)
    with open(HERE / "chiprun_out" / "flash_ab.json", "w") as f:
        json.dump(out, f, indent=1)
    for n, lines in out["ptxas"].items():
        print(f"ptxas {n}: " + " | ".join(lines[:40]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
