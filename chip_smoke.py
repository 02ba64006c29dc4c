"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

The main path is the batched TLB sweep, ``repro_torch.core.sweep.run_sweep``,
whose every batch is one launch of the CUDA TLB-sweep kernel
(``src/repro_torch/kernels/tlb_sweep/csrc/tlb_sweep.cu``).  Five phases,
each fatal on failure:

1. build — compile the kernel with ``nvcc`` and print what ``-Xptxas -v``
   says (registers, shared memory, spills);
2. the paper's Table 4 batch at full size — four synthetic mappings of 2^19
   pages, 150,000 multiscale accesses each, the 12-method roster: 48 cells,
   one 64-lane batch.  The kernel's launch count must rise, every
   translation must be the mapping's, the hit/walk counters must add up to
   the accesses, and every counter and ppn digest must equal the JAX
   package's results in ``tests/data/port_table4_reference.json``;
3. kernel vs plain PyTorch version on the card, bit for bit (tolerance 0):
   the first 2,048 accesses of the four full-footprint worlds under the 12
   methods plus the subregion, cache-TLB and dead-protect kinds; a small
   dynamic world under both coherence policies; a small multi-tenant
   world under both context-switch policies (the switch template).  The
   plain version issues every step as many small torch operations, about
   10 ms a step on the card, so the Table 4 batch's 163,840 steps would
   take it close to half an hour: at that shape the kernel is held to the
   JAX package's results instead (phase 2);
4. timing with CUDA events (median of 5 after a warm-up) of the kernel on
   the phase-2 batch and of kernel and plain version on the phase-3 batch;
5. the kernel line, the card line, and the ``{"ok": true, ...}`` line.

It exits non-zero, printing no result, without a card or outside a
checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REF_JSON = os.path.join(HERE, "tests", "data", "port_table4_reference.json")
KERNEL_SRC = "src/repro_torch/kernels/tlb_sweep/csrc/tlb_sweep.cu"
REPLACES = "src/repro/kernels/tlb_sweep/tlb_sweep.py:72"
N_PAGES, TRACE_LEN, PREFIX = 1 << 19, 150_000, 2048
KINDS = ("small", "medium", "large", "mixed")
ANCHOR_GRID = (4, 6, 8, 10)
# entries of the structures an access probes (csrc/tlb_lane.cuh)
L1_WAYS, CLUS_WAYS, RANGE_ENTRIES = 4, 5, 32
# H100 SXM HBM rate (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
# Hopper SMs issue 64 int32 operations per clock (16 INT32 units in each of
# four partitions, NVIDIA's Hopper whitepaper); the card's int32 rate is
# that times its SMs and its highest SM clock
INT32_OPS_PER_SM_CLOCK = 64


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str):
    print(f"\n=== {name} ===", flush=True)
    return time.time()


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi --query-gpu={query} failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def int32_rate() -> float:
    """The card's peak int32 operations per second, from its SM count and
    its highest SM clock."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smi("clocks.max.sm").split()[0])
    return INT32_OPS_PER_SM_CLOCK * sms * mhz * 1e6


def roster(m, tc):
    """``benchmarks/tlb_suite.py::_add_suite``'s 12 methods."""
    b = tc.baselines
    specs = [b.base_spec(), b.thp_spec(), b.rmm_spec(), b.colt_spec(),
             b.cluster_spec()] + [b.anchor_spec(d) for d in ANCHOR_GRID]
    for psi in (2, 3, 4):
        specs.append(b.kaligned_for_mapping(
            m, psi=psi, theta=1.0 if psi > 2 else 0.9))
    return specs


def cuda_time_ms(fn, reps: int) -> float:
    """Median over ``reps`` runs of ``fn`` between CUDA events, after one
    warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(lanes, stacks, st0, seg_bounds, results, ops_per_s):
    """Least time the card could take for this batch's work: the larger of
    (bytes it must move) / HBM rate and (operations) / int32 rate.

    Bytes, counting each needed input word once: every trace up to its
    longest real lane (4 B per access), the distinct (record, vpn) map and
    fill records the real accesses touch (16 and 20 B), the distinct
    cluster words of cluster lanes (4 B), and the outputs (ppn 4 B per
    real access, counters and coverage samples).

    Operations: 3 int32 operations (two compares and a select) per entry
    an access must examine, counted per lane from its flags and from the
    counters this run gave it (``results``, one ``SimResult`` per real
    lane): every access probes the L1 set (and the 2MB L1 set on THP
    lanes); an L1 miss probes the L2 set (and the huge row on THP lanes)
    and picks an L1 victim; on K-aligned and Anchor lanes the aligned
    probes of the coalesced hits (``aligned_probes``) and every live K
    slot on a walk probe one L2 row each; an access that misses L1 and L2
    probes the range table, cluster set or cache tier its lane has; a walk
    scans for an L2 victim (and a range-table victim on RMM lanes).  Work
    the kernel does but these inputs do not need is left out: the probes
    it runs on L1 hits, the chain on side-structure hits, the cluster and
    cache-tier victim scans."""
    import numpy as np
    t_real = np.asarray(lanes["t_real"])
    real = np.flatnonzero(t_real > 0)
    trace = np.asarray(stacks["trace"])
    touched = {"maps": {}, "fills": {}, "clus": {}}
    trace_len = {}
    for i in real:
        tid = int(lanes["trace_id"][i])
        trace_len[tid] = max(trace_len.get(tid, 0), int(t_real[i]))
        for s, (lo, hi) in enumerate(zip(seg_bounds, seg_bounds[1:])):
            v = trace[tid, lo:min(hi, int(t_real[i]))]
            for plane, key in (("maps", "seg_map"), ("fills", "seg_fill"),
                               ("clus", "seg_clus")):
                if plane == "clus" and not lanes["has_cluster"][i]:
                    continue
                rec = int(lanes[key][i, s])
                touched[plane].setdefault(rec, []).append(v)

    def distinct(plane):
        return sum(np.unique(np.concatenate(vs)).size
                   for vs in touched[plane].values())
    acc = int(t_real[real].sum())
    n_bytes = (4 * sum(trace_len.values()) + 16 * distinct("maps")
               + 20 * distinct("fills") + 4 * distinct("clus")
               + 4 * acc + 4 * (9 + 64) * real.size)

    if len(results) != real.size:
        fail("bound: one result per real lane expected")
    ctlb_ways = st0["ctlb"].shape[2]
    entries = 0
    for i, r in zip(real, results):
        flag = {k: bool(lanes[k][i]) for k in (
            "is_thp", "is_colt", "is_subr", "has_rmm", "has_cluster",
            "has_ctlb")}
        ways = int(lanes["n_ways"][i])
        live_k = int((np.asarray(lanes["kvals"][i]) >= 0).sum())
        generic = not (flag["is_thp"] or flag["is_colt"] or flag["is_subr"])
        side = (RANGE_ENTRIES * flag["has_rmm"] + CLUS_WAYS
                * flag["has_cluster"] + ctlb_ways * flag["has_ctlb"])
        # a lane that cannot coalesce in L2 counts its side hits there
        side_hits = (r.l2_coalesced_hits if side and generic and live_k == 0
                     else 0)
        rows = 2 if flag["is_thp"] else 1
        l1_miss = r.accesses - r.l1_hits
        entries += (L1_WAYS * rows * r.accesses
                    + (ways * rows + L1_WAYS) * l1_miss
                    + (ways * (r.aligned_probes + live_k * r.walks)
                       if generic else 0)
                    + side * (r.walks + side_hits)
                    + (ways + RANGE_ENTRIES * flag["has_rmm"]) * r.walks)
    n_ops = 3 * entries
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", n_bytes, n_ops, t_bytes, t_ops)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import numpy as np
        import repro_torch.core as tc
        from repro_torch.core.lane_program import needs_switch_pass
        from repro_torch.core.sweep import (SweepCell, batches_of,
                                            pack_batch, run_sweep)
        from repro_torch.kernels.tlb_sweep import (LAUNCHES, _build,
                                                   run_lanes, run_lanes_ref)
        from repro_torch.kernels.tlb_sweep.ops import (as_tensors,
                                                       prepare_cuda)
    except ImportError as e:
        fail(f"cannot import the port from {HERE}/src ({e}); run this "
             "script from a checkout of the repository")
    if "jax" in sys.modules:
        fail("the port imported jax")
    if not os.path.exists(REF_JSON):
        fail(f"missing the JAX reference fixture {REF_JSON}")
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ------------------------------------------------------------ 1. build
    t0 = phase("1. build (nvcc, sm_90a)")
    try:
        lib = _build.build()
    except Exception as e:  # the build must not fail
        fail(f"kernel build failed: {e}")
    print(f"built {os.path.relpath(str(lib), HERE)} in {time.time() - t0:.1f} s")
    for line in _build.ptxas_report().splitlines():
        if ("Compiling" in line or "registers" in line or "spill" in line
                or "smem" in line):
            print("  " + line.strip())

    # ----------------------------------------------- 2. Table 4, full size
    t0 = phase("2. Table 4 batch: 4 mappings x 2^19 pages x 150k accesses, "
               "12 methods")
    worlds = []
    for kind in KINDS:
        m = tc.mappings.synthetic_mapping(kind, N_PAGES, seed=1)
        tr = tc.traces.generate_trace("multiscale", 0, TRACE_LEN, seed=2,
                                      mapping=m)
        worlds.append((kind, m, tr))
    cells = [SweepCell(s, m, tr) for kind, m, tr in worlds
             for s in roster(m, tc)]
    kinds_of = [kind for kind, m, tr in worlds for _ in range(12)]
    print(f"built worlds and {len(cells)} cells in {time.time() - t0:.1f} s")
    ref = json.load(open(REF_JSON))
    if len(ref["cells"]) != len(cells):
        fail("reference fixture has another cell count")
    for c, rc in zip(cells, ref["cells"]):
        spec = json.loads(json.dumps(dataclasses.asdict(c.spec)))
        if spec != rc["spec"]:
            fail(f"roster differs from the fixture: {spec} vs {rc['spec']}")

    torch.cuda.synchronize()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t1 = time.time()
    sweep = run_sweep(cells, cache=False, device="cuda")
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    wall = time.time() - t1
    print(f"run_sweep(device='cuda'): {wall:.2f} s wall, stats "
          f"{sweep.stats}, launches {launches}")
    if launches.get("tlb_sweep", 0) < 1:
        fail("the main path did not launch the tlb_sweep kernel")
    walks = {}
    for c, r, rc, kind in zip(cells, sweep.results, ref["cells"], kinds_of):
        want = np.asarray(c.mapping.ppn)[c.trace]
        if r.ppn.shape != want.shape or not np.array_equal(r.ppn, want):
            fail(f"{kind}/{r.name}: a translation differs from the mapping")
        if (r.l1_hits + r.l2_regular_hits + r.l2_coalesced_hits + r.walks
                != r.accesses):
            fail(f"{kind}/{r.name}: hits + walks != accesses")
        for f in ("accesses", "l1_hits", "l2_regular_hits",
                  "l2_coalesced_hits", "walks", "aligned_probes",
                  "pred_correct", "cycles", "shootdowns"):
            if getattr(r, f) != rc[f]:
                fail(f"{kind}/{r.name}: {f} = {getattr(r, f)}, JAX "
                     f"reference {rc[f]}")
        if r.coverage_mean != rc["coverage_mean"]:
            fail(f"{kind}/{r.name}: coverage_mean differs from the JAX "
                 "reference")
        digest = hashlib.sha256(np.ascontiguousarray(
            r.ppn, dtype=np.int32).tobytes()).hexdigest()
        if digest != rc["ppn_sha256"]:
            fail(f"{kind}/{r.name}: ppn digest differs from the JAX reference")
        walks.setdefault(kind, {})
        label = rc["label"]
        if label != "Anchor-Static" or label not in walks[kind] \
                or r.walks < walks[kind][label]:
            walks[kind][label] = r.walks
    print("all 48 cells: translations right, counters add up, equal to the "
          "JAX reference (counters, coverage, ppn sha256)")
    print("Table 4, relative misses (walks / Base walks):")
    labels = list(walks[KINDS[0]])
    print("  " + "mapping".ljust(8) + "".join(x.rjust(15) for x in labels))
    for kind in KINDS:
        base = max(walks[kind]["Base"], 1)
        print("  " + kind.ljust(8) + "".join(
            f"{walks[kind][x] / base:15.4f}" for x in labels))

    # ------------------------------------------- 3. kernel vs plain, card
    t0 = phase("3. kernel vs plain version on the card (bit for bit)")
    b = tc.baselines
    accel = [b.subregion_spec(), b.cache_tlb_spec(), b.dead_protect_spec()]
    prefix_cells = [SweepCell(s, m, pre) for kind, m, tr in worlds
                    for pre in (tr[:PREFIX],) for s in roster(m, tc) + accel]
    dyn_cells, mt_cells = small_worlds(tc, SweepCell, np)
    max_err = 0
    plain_batch = None
    for name, cs in (("3a full-footprint prefix", prefix_cells),
                     ("3b dynamic", dyn_cells), ("3c multi-tenant", mt_cells)):
        kinds = sorted({c.spec.kind for c in cs})
        for group in batches_of(cs, range(len(cs))):
            lanes, stacks, st0, sb = pack_batch([cs[i] for i in group])
            lt, stt, s0t = as_tensors(lanes, stacks, st0, dev)
            k_st, k_pp = run_lanes(lt, stt, s0t, sb)
            torch.cuda.synchronize()
            r_st, r_pp = run_lanes_ref(lt, stt, s0t, sb)
            torch.cuda.synchronize()
            for a_, b_ in ((k_st["counters"], r_st["counters"]),
                           (k_st["cov_samples"], r_st["cov_samples"]),
                           (k_pp, r_pp)):
                if a_.shape != b_.shape:
                    fail(f"{name}: kernel and plain shapes differ")
                err = int((a_.long() - b_.long()).abs().max().item())
                max_err = max(max_err, err)
                if err != 0:
                    fail(f"{name}: kernel differs from the plain version "
                         f"(max abs err {err})")
            if plain_batch is None:
                plain_batch = (lt, stt, s0t, sb)
            print(f"{name}: L={lanes['t_real'].shape[0]} T={sb[-1]} "
                  f"segments={len(sb) - 1} kinds={len(kinds)} switch-"
                  f"template={needs_switch_pass(lanes)}: equal")
    print(f"kernel == plain on every batch (max abs err {max_err}) in "
          f"{time.time() - t0:.1f} s")

    # -------------------------------------------------------- 4. timing
    t0 = phase("4. timing (CUDA events, median of 5 after a warm-up)")
    # host clock: where run_sweep's wall goes besides the kernel
    t1 = time.time()
    lanes, stacks, st0, sb = pack_batch(cells)
    t_pack = time.time() - t1
    t1 = time.time()
    lt, stt, s0t = as_tensors(lanes, stacks, st0, dev)
    torch.cuda.synchronize()
    t_upload = time.time() - t1
    t1 = time.time()
    launch = prepare_cuda(lt, stt, s0t, sb)
    torch.cuda.synchronize()
    t_checks = time.time() - t1
    print(f"host, Table 4 batch: pack_batch {t_pack:.3f} s, upload "
          f"{t_upload:.3f} s, launch checks {t_checks:.3f} s (run_sweep "
          f"wall {wall:.3f} s)")
    ms = cuda_time_ms(launch, 5)
    ops_per_s = int32_rate()
    bound_ms, bound_by, n_bytes, n_ops, t_bytes, t_ops = bound(
        lanes, stacks, st0, sb, sweep.results, ops_per_s)
    pl, ps, p0, psb = plain_batch
    ms_prefix = cuda_time_ms(prepare_cuda(pl, ps, p0, psb), 5)
    plain_ms = cuda_time_ms(lambda: run_lanes_ref(pl, ps, p0, psb), 3)
    print(f"kernel, Table 4 batch (L=64, T={sb[-1]}): {ms:.3f} ms; bound "
          f"{bound_ms:.4f} ms by {bound_by} (bytes: {n_bytes} B, "
          f"{t_bytes:.4f} ms at {HBM_BYTES_PER_S:.3g} B/s; operations: "
          f"{n_ops} int32, {t_ops:.4f} ms at {ops_per_s:.4g} int32 op/s)")
    print(f"3a batch (L=64, T={psb[-1]}): kernel {ms_prefix:.3f} ms, plain "
          f"version {plain_ms:.1f} ms (median of 3)")
    print(f"card: {card}")

    # ----------------------------------------------------------- 5. report
    kernel = dict(
        name="tlb_sweep", route="cuda", source=KERNEL_SRC,
        replaces=REPLACES, launches=launches["tlb_sweep"],
        max_abs_err=max_err, bit_exact=max_err == 0,
        ms=round(ms, 4), plain_ms=round(plain_ms, 3),
        bound_ms=round(bound_ms, 6), bound_by=bound_by, library_ms=None,
        ms_shape=f"Table 4 batch, L=64 x T={sb[-1]}",
        plain_shape=f"3a batch, L=64 x T={psb[-1]}",
        ms_on_plain_shape=round(ms_prefix, 4))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kernels=[kernel], run_sweep_wall_s=wall,
                       bound=dict(bytes=n_bytes, bytes_ms=t_bytes,
                                  int32_ops=n_ops, ops_ms=t_ops,
                                  int32_ops_per_s=ops_per_s),
                       host_s=dict(pack_batch=t_pack, upload=t_upload,
                                   launch_checks=t_checks)), f, indent=1)
    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def small_worlds(tc, SweepCell, np):
    """A small dynamic world (``build_dynamic_mapping``) under both
    coherence policies and a small multi-tenant world
    (``build_multitenant_mapping``) under both context-switch policies,
    all 11 specs each — the worlds of ``tests/test_backends.py`` and
    ``tests/test_multitenant.py``."""
    b, pt = tc.baselines, tc.page_table
    specs = [b.base_spec(), b.thp_spec(), b.colt_spec(), b.cluster_spec(),
             b.rmm_spec(), b.anchor_spec(6), b.kaligned_spec([9, 6, 4]),
             b.kaligned_spec([6, 4], use_predictor=False, name="ka-nopred"),
             b.subregion_spec(), b.cache_tlb_spec(), b.dead_protect_spec()]
    n = 1 << 10
    dyn = pt.build_dynamic_mapping(
        np.arange(n, dtype=np.int64) + 7,
        [(150, [pt.MappingEvent("remap", 0, 128, ppn=100_000)]),
         (370, [pt.MappingEvent("split", 128, 64, ppn=np.arange(
             200_000, 200_000 + 64 * 3, 3)),
                pt.MappingEvent("unmap", 768, 32)])], name="hot")
    dtr = np.random.default_rng(3).integers(0, 512, size=520)
    dyn_cells = [SweepCell(dataclasses.replace(s, coh_policy=p), dyn, dtr)
                 for p in ("shootdown", "hw-coherence") for s in specs]
    ta = tc.mappings.demand_mapping(n, seed=1)
    tb = pt.make_mapping(np.arange(n, dtype=np.int64) + 3, name="contig")
    tcm = tc.mappings.demand_mapping(n // 2, seed=7, thp=True)
    mt = pt.build_multitenant_mapping(
        [ta, tb, tcm], [(0, 0, 0), (60, 1, 1), (130, 0, 0), (200, 1, 1),
                        (260, 2, 0), (330, 1, 1), (400, 2, 0)],
        name="mt-hand")
    rng = np.random.default_rng(5)
    bounds = list(mt.boundaries) + [470]
    parts = []
    for s in range(mt.n_segments):
        mv = np.flatnonzero(mt.tenants[mt.tenant_ids[s]].ppn >= 0)
        parts.append(mv[rng.integers(0, mv.size, bounds[s + 1] - bounds[s])])
    mtr = np.concatenate(parts).astype(np.int64)
    mt_cells = [SweepCell(dataclasses.replace(s, ctx_policy=p), mt, mtr)
                for p in ("flush", "tag") for s in specs]
    return dyn_cells, mt_cells


if __name__ == "__main__":
    sys.exit(main())
