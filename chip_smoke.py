"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

The port has two main paths, each through its hand-written CUDA kernel:

* the batched TLB sweep, ``repro_torch.core.sweep.run_sweep``, whose every
  batch is one launch of the TLB-sweep kernel
  (``src/repro_torch/kernels/tlb_sweep/csrc/tlb_sweep.cu``);
* paged decode serving, ``repro_torch.serve.ServingEngine``, whose every
  decode step runs the class-k paged-attention kernel
  (``src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu``)
  once per layer and alignment class.

Phases, each fatal on failure:

1. build — compile both kernels with ``nvcc`` at once (one process per
   source) and print what ``-Xptxas -v`` says for the TLB sweep
   (registers, shared memory, spills);
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

S1. the paged-attention kernel's ``-Xptxas -v`` report;
S2. InternLM2-1.8B at full width (24 layers, d_model 2048, 16 heads over 8
    KV heads, vocab 92,544), weights drawn with the port's seeded numpy
    init and checked against the digest in the fixture, served in f32
    compute (TF32 off) on the card: the generated tokens, the logits, the
    classes K and the descriptor counts must equal the JAX engine's in
    ``tests/data/port_serve_reference.json`` (tokens wherever the
    fixture's top-1/top-2 gap exceeds twice the logit tolerance, logits
    within ``LOGIT_ATOL``, integers exactly);
S3. the slice at conversation-trace lengths: default bf16 compute, 16
    requests whose prompt and answer lengths are drawn from a seed around
    the medians of the Azure LLM inference trace's conversation set (see
    ``s3_requests``), queued at once, through ``EngineConfig(page_size=16,
    num_pages=2048, max_batch=8, max_seq=4096)``; every request finishes
    (``stalled == 0``), the kernel ran with a class k >= 1, descriptors
    were coalesced, and every token equals the dense-cache decode's
    wherever the margin allows;
S4. the kernel against its plain version on the card — the class passes of
    one S3 decode step (bf16 and f32) and ``tests/test_kernels.py``'s shape
    sweep: per class (o, m, l) and the merged output, f32 within 5e-5,
    bf16 within 2e-2;
S5. timing, L2 flushed before each call: device time from
    ``torch.profiler`` (the kernel line's ``ms`` and ``library_ms``; the
    phase fails where the profiler records no such kernel) and CUDA events
    (host launch cost included) of the class passes of the S3 step and of
    one ``scaled_dot_product_attention`` call on the same K/V gathered
    dense (the library yardstick, gather excluded); the plain version by
    CUDA events; the host clock of S3's prefills and decode steps and of
    the descriptor building; a profiler trace of one decode step;
5. the kernel line, the card line, and the ``{"ok": true, ...}`` line.

It exits non-zero, printing no result, without a card or outside a
checkout of the repository.  The serving helpers below also run on the
CPU (``tests/test_torch_serve.py`` drives them there).
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
# H100 SXM dense bf16 tensor rate (NVIDIA's data sheet)
BF16_FLOP_PER_S = 989e12

# ----------------------------------------------------------- serving part
SERVE_REF_JSON = os.path.join(HERE, "tests", "data",
                              "port_serve_reference.json")
SERVE_ARCH = "internlm2-1.8b"
PA_SRC = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
PA_REPLACES = "src/repro/kernels/paged_attention/paged_attention.py:38"
# f32 logits against the JAX fixture: the same f32 products summed in
# another order (cuBLAS vs XLA on the CPU) through 24 layers.  On the CPU
# the port agrees with the fixture to 8.1e-6 on logits of magnitude ~4;
# the tolerance leaves a hundred times that.
LOGIT_ATOL = 1e-3
# bf16 paged decode vs bf16 dense decode: the paged op merges its classes
# in f32 and rounds once, the dense path rounds its softmax weights to
# bf16, so logits differ by a few bf16 ulps (ulp 1/32 at magnitude 4-8);
# a token may differ only where the dense decode's own top-1 lead over it
# is within this margin.
DENSE_MARGIN = 0.125
# kernel vs plain version (tests/test_kernels.py's tolerances)
PA_TOL = {"float32": 5e-5, "bfloat16": 2e-2}
S3_ENGINE = dict(page_size=16, num_pages=2048, max_batch=8, max_seq=4096)
S3_REQUESTS, S3_SEED = 16, 11
# S3's lengths: the Azure LLM inference trace 2023, conversation set
# (github.com/Azure/AzurePublicDataset; its medians as Splitwise,
# arXiv:2311.18677, reports them: 1,020 prompt and 129 output tokens).
# Drawn log-normal around those medians; the spreads (sigma) and the
# clips to max_seq are this script's choice, not the trace's.
S3_PROMPT = dict(median=1020, sigma=0.8, lo=16, hi=3072)
S3_OUTPUT = dict(median=129, sigma=1.0, lo=8, hi=1024)
# tests/test_kernels.py's paged-attention shapes (B, H, KVH, D, T)
PAGED_SHAPES = ((2, 4, 2, 64, 16), (3, 8, 8, 32, 8), (1, 8, 1, 128, 16))


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


def cuda_time_ms(fn, reps: int, flush=None) -> float:
    """Median over ``reps`` runs of ``fn`` between CUDA events, after one
    warm-up run; each run after ``flush()`` where one is given (outside the
    events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
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


# ---------------------------------------------------------------------------
# Serving helpers (run on the card here, on the CPU in the tests)
# ---------------------------------------------------------------------------

class EngineProbe:
    """Stands in for a ``ServingEngine``'s model: times every prefill and
    decode step on the host clock (ending in a synchronise on the card),
    keeps the host inputs of every decode step, and with ``keep_logits``
    the f32 logits row behind every generated token, keyed by (request,
    token index)."""

    def __init__(self, model, engine, keep_logits=False):
        self._model, self._engine, self._keep = model, engine, keep_logits
        self.prefill_s, self.decode_s, self.steps = [], [], []
        self.logits = {}

    def __getattr__(self, name):
        return getattr(self._model, name)

    def _sync(self):
        import torch
        if self._engine.device.type == "cuda":
            torch.cuda.synchronize()

    def prefill(self, params, tokens, **kw):
        self._sync()
        t = time.perf_counter()
        logits, state = self._model.prefill(params, tokens, **kw)
        self._sync()
        self.prefill_s.append((tokens.shape[1], time.perf_counter() - t))
        if self._keep:
            seq = tokens[0].tolist()
            for rid, req in self._engine.requests.items():
                if req.state == "running" and req.prompt + req.generated \
                        == seq:
                    self.logits[(rid, len(req.generated))] = \
                        logits[0, -1].float().cpu().numpy()
        return logits, state

    def decode_step_paged(self, params, state, tokens, kv_len, tables,
                          descriptors, **kw):
        import numpy as np
        self._sync()
        t = time.perf_counter()
        logits, state = self._model.decode_step_paged(
            params, state, tokens, kv_len, tables, descriptors, **kw)
        self._sync()
        self.decode_s.append(time.perf_counter() - t)
        self.steps.append(dict(lens=np.array(kv_len), tables=np.array(tables),
                               K=tuple(kw["K_classes"])))
        if self._keep:
            rows = logits[:, 0].float().cpu().numpy()
            for rid in self._engine.running:
                self.logits[(rid, len(self._engine.requests[rid].generated))] \
                    = rows[self._engine.sched.slot_of(rid)]
        return logits, state


def _digest_leaf(tree, name):
    path, _, idx = name.partition("[")
    for part in path.split("/"):
        tree = tree[part]
    return tree[int(idx[:-1])] if idx else tree


def load_weights(model, ref, device):
    """The fixture's weights: the port's seeded numpy init, checked value
    for value against the digest the fixture kept (a numpy stream that
    differs between machines shows here), then moved to ``device``."""
    import numpy as np
    from repro_torch.models import params_from_numpy
    tree = model.init_numpy(ref["weight_seed"])
    for name, want in ref["weight_digest"].items():
        got = np.asarray(_digest_leaf(tree, name)).reshape(-1)[:len(want)]
        if [float(x) for x in got] != want:
            raise ValueError(f"weights differ from the fixture's at {name}: "
                             f"{got.tolist()} vs {want}")
    params = params_from_numpy(tree, device)
    del tree
    return params


def serve_against_fixture(ref, device, params=None):
    """Phase S2: the port's engine in f32 over the fixture's requests, held
    to the JAX engine's tokens, logits, classes and descriptor counts.
    Returns what it measured; raises ``ValueError`` on a difference."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Model, RunConfig
    from repro_torch.serve import EngineConfig, ServingEngine
    model = Model(get_config(ref["arch"]),
                  RunConfig(compute_dtype=ref["compute_dtype"]))
    if params is None:
        params = load_weights(model, ref, device)
    eng = ServingEngine(model, params, EngineConfig(**ref["engine"]),
                        device=device)
    probe = EngineProbe(model, eng, keep_logits=True)
    eng.model = probe
    for r in ref["requests"]:
        eng.add_request(r["prompt"], max_new_tokens=r["max_new_tokens"])
    t0 = time.perf_counter()
    m = eng.run_to_completion()
    wall = time.perf_counter() - t0
    for key, want in (("K", ref["K"]), ("steps", ref["engine_steps"]),
                      ("dma_descriptors", ref["dma_descriptors"]),
                      ("dma_descriptors_page_granular",
                       ref["dma_descriptors_page_granular"]),
                      ("descriptor_reduction", ref["descriptor_reduction"]),
                      ("stalled", 0)):
        if m[key] != want:
            raise ValueError(f"{key} = {m[key]}, the JAX engine's {want}")
    vocab, stride = model.cfg.vocab, ref["sample_stride"]
    max_err, checked, diverged = 0.0, 0, set()
    for rec in sorted(ref["logits"], key=lambda r: (r["request"],
                                                   r["index"])):
        rid, idx = rec["request"], rec["index"]
        if rid in diverged:
            continue            # a near-tie went the other way: new context
        row = probe.logits.get((rid, idx))
        if row is None:
            raise ValueError(f"no logits for request {rid} token {idx}")
        err = max(np.abs(row[rec["top_ids"]]
                         - np.asarray(rec["top_logits"])).max(),
                  np.abs(row[:vocab:stride]
                         - np.asarray(rec["sample"])).max())
        max_err = max(max_err, float(err))
        got = eng.requests[rid].generated[idx]
        want = ref["requests"][rid]["generated"][idx]
        gap = rec["top_logits"][0] - rec["top_logits"][1]
        if gap > 2 * LOGIT_ATOL:
            if got != want:
                raise ValueError(f"request {rid} token {idx}: {got}, the JAX "
                                 f"engine's {want} (top-2 gap {gap:.4g})")
            checked += 1
        elif got != want:
            diverged.add(rid)
    if max_err > LOGIT_ATOL:
        raise ValueError(f"logits differ from the JAX engine's by {max_err:.3g}"
                         f" > {LOGIT_ATOL}")
    return dict(max_abs_err=max_err, tokens_checked=checked,
                tokens_total=len(ref["logits"]), diverged=sorted(diverged),
                generated=[eng.requests[i].generated
                           for i in range(len(ref["requests"]))],
                K=m["K"], descriptor_reduction=m["descriptor_reduction"],
                wall_s=wall, params=params)


def dense_check(model, params, reqs, device, margin):
    """Each request's generated tokens against the dense-cache decode
    (``Model.prefill`` + ``Model.decode_step``), teacher-forced on the
    engine's own tokens so that one near-tie cannot cascade.  A token may
    differ from the dense argmax only where the dense logits put it within
    ``margin`` of their top-1.  Returns the counts; raises ``ValueError``
    on a token outside the margin."""
    import torch
    params = model.compute_params(params)
    vocab = model.cfg.vocab
    out = dict(checked=0, equal=0, max_gap=0.0)
    for req in reqs:
        prompt, gen = list(req.prompt), list(req.generated)
        S = len(prompt)
        logits, st = model.prefill(
            params, torch.tensor([prompt], device=device),
            max_seq=S + len(gen))
        rows = [logits[0, S - 1]]
        for i in range(1, len(gen)):
            logits, st = model.decode_step(
                params, st, torch.tensor([[gen[i - 1]]], device=device),
                torch.tensor([S + i - 1], device=device))
            rows.append(logits[0, 0])
        for i, row in enumerate(rows):
            row = row[:vocab].float()
            best = int(row.argmax())
            out["checked"] += 1
            if best == gen[i]:
                out["equal"] += 1
                continue
            gap = float(row[best] - row[gen[i]])
            out["max_gap"] = max(out["max_gap"], gap)
            if gap > margin:
                raise ValueError(
                    f"request {req.req_id}: token {i} is {gen[i]}, the dense "
                    f"decode's is {best}, ahead by {gap:.4g} > {margin}")
    return out


def _lognormal_lengths(rng, n, median, sigma, lo, hi):
    import numpy as np
    x = np.round(rng.lognormal(np.log(median), sigma, n))
    return np.clip(x, lo, hi).astype(int)


def s3_requests(vocab, n=S3_REQUESTS, seed=S3_SEED):
    """S3's requests, ``[(prompt token ids, max_new_tokens)]``: prompt and
    answer lengths log-normal around the conversation trace's medians
    (``S3_PROMPT``, ``S3_OUTPUT``), token ids uniform, all from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    plen = _lognormal_lengths(rng, n, **S3_PROMPT)
    olen = _lognormal_lengths(rng, n, **S3_OUTPUT)
    return [([int(t) for t in rng.integers(0, vocab, size=p)], int(o))
            for p, o in zip(plen, olen)]


def pool_case(rng, B, H, KVH, D, T, n_pages=128, frag=0.3):
    """``tests/test_kernels.py::_random_pool_case`` in numpy (the port's
    allocator under seeded churn)."""
    import numpy as np
    from repro_torch.kvcache import PagedKVAllocator
    alloc = PagedKVAllocator(n_pages, max_order=5)
    for i in range(int(frag * 10)):
        alloc.allocate(1000 + i, int(rng.integers(1, 6)))
    for i in range(int(frag * 10)):
        if rng.random() < 0.5:
            alloc.free(1000 + i)
    lens, tables = [], []
    for b in range(B):
        L = int(rng.integers(T, T * (n_pages // 2) // 2))
        alloc.allocate(b, -(-L // T))
        lens.append(L)
        tables.append(alloc.block_table(b, n_pages // 2))
    f32 = np.float32
    return (rng.standard_normal((B, H, D)).astype(f32),
            rng.standard_normal((n_pages, T, KVH, D)).astype(f32),
            rng.standard_normal((n_pages, T, KVH, D)).astype(f32),
            np.stack(tables), np.asarray(lens, np.int32))


def kernel_vs_plain(q, kp, vp, tables, lens, K, page_size):
    """Every class pass of ``K ∪ {0}`` through the kernel and through the
    plain version on the same card tensors, then both merges.  Returns
    the largest absolute error of (o, m, l) and of the merged output;
    raises ``ValueError`` past the dtype's tolerance."""
    import torch
    from repro_torch.kernels.paged_attention import (
        build_descriptors, merge_partials, paged_attention_class_pass,
        paged_attention_class_pass_ref)
    from repro_torch.kernels.paged_attention.ops import classes_of
    tol = PA_TOL[str(q.dtype).replace("torch.", "")]
    desc = build_descriptors(tables, K)
    errs = dict(o=0.0, m=0.0, l=0.0, merged=0.0)
    kparts, pparts = [], []
    for k in classes_of(K):
        wi, cov = desc[k]
        got = paged_attention_class_pass(q, kp, vp, wi, cov, lens,
                                         pages_per_block=1 << k,
                                         page_size=page_size)
        want = paged_attention_class_pass_ref(q, kp, vp, wi, cov, lens,
                                              pages_per_block=1 << k,
                                              page_size=page_size)
        torch.cuda.synchronize()
        for name, a, b in zip("oml", got, want):
            diff = (a - b).abs()
            errs[name] = max(errs[name], float(diff.max()))
            if not bool((diff <= tol + tol * b.abs()).all()):
                raise ValueError(f"class {k} {name}: kernel differs from the "
                                 f"plain version by {float(diff.max()):.3g}")
        kparts.append(got)
        pparts.append(want)
    a, b = merge_partials(kparts), merge_partials(pparts)
    diff = (a - b).abs()
    errs["merged"] = float(diff.max())
    if not bool((diff <= tol + tol * b.abs()).all()):
        raise ValueError(f"merged output differs by {errs['merged']:.3g}")
    return errs


def _kernel_times(fn):
    """``{kernel name: [total device ms, launches]}`` of what ``fn()``
    launches, from ``torch.profiler``'s kernel events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            r = out.setdefault(ev.name, [0.0, 0])
            r[0] += ev.time_range.elapsed_us() / 1e3
            r[1] += 1
    return out


def device_ms(fn, reps, flush, expect=""):
    """Mean device time of the kernels ``fn`` launches over ``reps`` calls,
    each after ``flush()`` (kernels named as the flush's own are left
    out), from ``torch.profiler``.  Raises ``ValueError`` where the
    profiler records no kernel whose name holds ``expect``."""
    import torch
    fn()
    torch.cuda.synchronize()
    flush_names = set(_kernel_times(flush))

    def runs():
        for _ in range(reps):
            flush()
            fn()
    rows = {name: t for name, (t, _) in _kernel_times(runs).items()
            if name not in flush_names}
    if not any(expect in name and t > 0 for name, t in rows.items()):
        raise ValueError(f"the profiler recorded no device time for a "
                         f"kernel named {expect!r}: {sorted(rows)[:8]}")
    return sum(rows.values()) / reps


def live_tokens(desc, classes, kv_lens, page_size):
    """Tokens the class passes must read: in each covered window, those
    before its row's ``kv_lens`` (pages reserved past it for tokens not yet
    generated, and the rest of a row's last page, are not needed)."""
    import numpy as np
    lens = np.asarray(kv_lens, np.int64)[:, None]
    n = 0
    for k in classes:
        cov = np.asarray(desc[k][1]).astype(bool)
        W = (1 << k) * page_size
        start = np.arange(cov.shape[1], dtype=np.int64)[None, :] * W
        n += int((np.clip(lens - start, 0, W) * cov).sum())
    return n


def paged_bound(desc, classes, kv_lens, B, H, KVH, D, page_size, elt):
    """Least time the card could take for one layer's class passes: bytes
    of the live K/V tokens of the covered windows (``live_tokens``, read
    once), q (read once) and every pass's (o, m, l) written once, at the
    HBM rate; operations (a multiply-add each for q.k and p.v per live
    token, query row and head dim) at the bf16 tensor rate.  Returns (ms,
    by, bytes, flops, bytes_ms, ops_ms)."""
    G = H // KVH
    tokens = live_tokens(desc, classes, kv_lens, page_size)
    n_bytes = (2 * tokens * KVH * D * elt + B * H * D * elt
               + len(classes) * (B * H * D * 4 + 2 * B * H * 4))
    flops = 4 * tokens * KVH * G * D
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", n_bytes, flops, t_bytes, t_ops)


def profile_decode_step(model, eng, step, dev):
    """Device time by kernel over one replayed S3 decode step, from
    ``torch.profiler``'s kernel events, and the step's host-clock wall, for
    the device's busy share.  Raises ``ValueError`` where the trace holds
    no paged-attention kernel."""
    import torch
    from repro_torch.kernels.paged_attention import build_descriptors
    B = eng.ec.max_batch
    toks = torch.zeros((B, 1), dtype=torch.long, device=dev)
    wall = []

    def run():
        t0 = time.perf_counter()
        desc = build_descriptors(step["tables"], step["K"])
        model.decode_step_paged(eng.params, eng.state, toks, step["lens"],
                                step["tables"], desc,
                                page_size=eng.ec.page_size,
                                K_classes=step["K"])
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    run()                                          # warm
    rows = _kernel_times(run)
    wall_ms = wall[-1]
    total = sum(r[0] for r in rows.values())
    pa = sum(r[0] for n, r in rows.items() if "class_pass_kernel" in n)
    if not pa > 0:
        raise ValueError("the profiler recorded no paged-attention kernel in "
                         "a decode step")
    gemm = sum(r[0] for n, r in rows.items() if any(w in n.lower() for w in (
        "gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_")))
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:12]
    return dict(wall_ms=wall_ms, device_ms=total, busy_share=total / wall_ms,
                paged_attention_ms=pa, matmul_ms=gemm,
                other_ms=total - pa - gemm, kernels=sum(
                    r[1] for r in rows.values()),
                top=[dict(name=n[:120], ms=r[0], count=r[1])
                     for n, r in top])


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
        from repro_torch.kernels.paged_attention import _build as pa_build
        from repro_torch.kernels.paged_attention import ops as pa_ops
    except ImportError as e:
        fail(f"cannot import the port from {HERE}/src ({e}); run this "
             "script from a checkout of the repository")
    if "jax" in sys.modules:
        fail("the port imported jax")
    for ref_file in (REF_JSON, SERVE_REF_JSON):
        if not os.path.exists(ref_file):
            fail(f"missing the JAX reference fixture {ref_file}")
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ------------------------------------------------------------ 1. build
    t0 = phase("1. build (nvcc, sm_90a; both kernels at once)")
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as ex:
        builds = [(b, ex.submit(b.build)) for b in (_build, pa_build)]
        for b, fut in builds:
            try:
                lib = fut.result()
            except Exception as e:  # the build must not fail
                fail(f"kernel build failed: {e}")
            print(f"built {os.path.relpath(str(lib), HERE)}")
    print(f"both kernels built in {time.time() - t0:.1f} s")
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
    pa_ops.reset_launch_counts()
    t1 = time.time()
    sweep = run_sweep(cells, cache=False, device="cuda")
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    wall = time.time() - t1
    print(f"run_sweep(device='cuda'): {wall:.2f} s wall, stats "
          f"{sweep.stats}, launches {launches}")
    if launches.get("tlb_sweep", 0) < 1:
        fail("the main path did not launch the tlb_sweep kernel")
    if pa_ops.LAUNCHES["paged_attention"] != 0:
        fail("the sweep launched the paged-attention kernel")
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

    tlb = dict(
        name="tlb_sweep", route="cuda", source=KERNEL_SRC,
        replaces=REPLACES, launches=launches["tlb_sweep"],
        max_abs_err=max_err, bit_exact=max_err == 0,
        ms=round(ms, 4), plain_ms=round(plain_ms, 3),
        bound_ms=round(bound_ms, 6), bound_by=bound_by, library_ms=None,
        ms_shape=f"Table 4 batch, L=64 x T={sb[-1]}",
        plain_shape=f"3a batch, L=64 x T={psb[-1]}",
        ms_on_plain_shape=round(ms_prefix, 4))
    tlb_out = dict(run_sweep_wall_s=wall,
                   bound=dict(bytes=n_bytes, bytes_ms=t_bytes,
                              int32_ops=n_ops, ops_ms=t_ops,
                              int32_ops_per_s=ops_per_s),
                   host_s=dict(pack_batch=t_pack, upload=t_upload,
                               launch_checks=t_checks))
    del (sweep, cells, worlds, lanes, stacks, st0, lt, stt, s0t, launch,
         plain_batch, pl, ps, p0, prefix_cells, dyn_cells, mt_cells)
    torch.cuda.empty_cache()

    pa, serve_out = serve_phases(torch, np, dev, pa_build, pa_ops)

    # ----------------------------------------------------------- 5. report
    phase("5. report")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kernels=[tlb, pa], tlb_sweep=tlb_out,
                       serving=serve_out), f, indent=1)
    print(json.dumps({"kernels": [tlb, pa]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def serve_phases(torch, np, dev, pa_build, pa_ops):
    """Phases S1-S5 (paged decode serving); returns the paged-attention
    kernel's line and the numbers for ``chip_smoke.json``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import (
        build_descriptors, dma_stats, gather_kv, merge_partials,
        paged_attention_class_pass_ref, prepare_descriptors)
    from repro_torch.models import Model, RunConfig
    from repro_torch.serve import EngineConfig, ServingEngine
    out = {}

    # ------------------------------------------------------------ S1. build
    phase("S1. paged-attention kernel (built in phase 1): ptxas")
    for line in pa_build.ptxas_report().splitlines():
        if ("Compiling" in line or "registers" in line or "spill" in line
                or "smem" in line):
            print("  " + line.strip())

    # ------------------------------------------- S2. f32 vs the JAX engine
    t0 = phase("S2. InternLM2-1.8B at full width, f32, vs the JAX engine")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    ref = json.load(open(SERVE_REF_JSON))
    model32 = Model(get_config(SERVE_ARCH), RunConfig(compute_dtype="float32"))
    try:
        t1 = time.time()
        params = load_weights(model32, ref, dev)
        t_weights = time.time() - t1
        s2 = serve_against_fixture(ref, dev, params)
    except ValueError as e:
        fail(f"S2: {e}")
    s2.pop("params")
    print(f"{model32.n_params():,} parameters drawn, checked against the "
          f"fixture's digest and moved to the card in {t_weights:.1f} s")
    print(f"tokens {s2['generated']} == JAX ({s2['tokens_checked']} of "
          f"{s2['tokens_total']} past the margin), logits max abs err "
          f"{s2['max_abs_err']:.3g} <= {LOGIT_ATOL}, K={s2['K']}, descriptor "
          f"reduction {s2['descriptor_reduction']:.4f} == JAX; engine "
          f"{s2['wall_s']:.2f} s ({time.time() - t0:.1f} s in all)")
    out["s2"] = s2

    # ------------------------- S3. the slice at conversation-trace lengths
    t0 = phase("S3. serving, bf16: 16 requests at the Azure conversation "
               "trace's length medians, 2048 pages x 16 tokens, batch 8")
    model = Model(get_config(SERVE_ARCH), RunConfig())
    eng = ServingEngine(model, params, EngineConfig(**S3_ENGINE), device=dev)
    del params
    torch.cuda.empty_cache()
    probe = EngineProbe(model, eng)
    eng.model = probe
    requests = s3_requests(model.cfg.vocab)
    for p, n_new in requests:
        eng.add_request(p, max_new_tokens=n_new)
    print(f"prompt lengths {[len(p) for p, _ in requests]}, answer lengths "
          f"{[n for _, n in requests]}")
    torch.cuda.synchronize()
    from repro_torch.kernels.tlb_sweep import LAUNCHES as TLB_LAUNCHES
    for k in TLB_LAUNCHES:
        TLB_LAUNCHES[k] = 0
    pa_ops.reset_launch_counts()
    t1 = time.time()
    m = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.time() - t1
    launches = pa_ops.LAUNCHES["paged_attention"]
    by_class = dict(pa_ops.CLASS_LAUNCHES)
    print(f"engine wall {wall:.2f} s: {m['steps']} steps, {m['tokens']} "
          f"decoded tokens, K={m['K']}, descriptor reduction "
          f"{m['descriptor_reduction']:.4f}, preemptions "
          f"{m['preemptions']}, stalled {m['stalled']}; kernel launches "
          f"{launches} by class {by_class}")
    if m["stalled"] != 0 or any(r.state != "done"
                                for r in eng.requests.values()):
        fail("S3: not every request finished")
    if [len(eng.requests[i].generated) for i in range(S3_REQUESTS)] != [
            n for _, n in requests]:
        fail("S3: a request did not get all its tokens")
    if launches < 1 or not any(k >= 1 and n > 0 for k, n in by_class.items()):
        fail("S3: the paged-attention kernel did not run a class k >= 1")
    if sum(TLB_LAUNCHES.values()) != 0:
        fail("S3: the serving path launched the TLB kernel")
    if not m["descriptor_reduction"] > 0:
        fail("S3: no descriptor was coalesced")
    try:
        dc = dense_check(model, eng.params,
                         [eng.requests[i] for i in range(S3_REQUESTS)], dev,
                         DENSE_MARGIN)
    except ValueError as e:
        fail(f"S3 vs dense decode: {e}")
    print(f"vs the dense-cache decode_step (teacher-forced): {dc['equal']} of "
          f"{dc['checked']} tokens equal, the rest within {DENSE_MARGIN} of "
          f"the dense top-1 (largest lead {dc['max_gap']:.4g}) "
          f"({time.time() - t0:.1f} s in all)")
    pre = [t for _, t in probe.prefill_s]
    out["s3"] = dict(
        engine_wall_s=wall, steps=m["steps"], tokens=m["tokens"], K=m["K"],
        descriptor_reduction=m["descriptor_reduction"],
        preemptions=m["preemptions"], launches=launches,
        launches_by_class={str(k): n for k, n in by_class.items()},
        prefill_s=dict(n=len(pre), total=sum(pre),
                       median=statistics.median(pre),
                       by_tokens=probe.prefill_s),
        decode_step_s=dict(n=len(probe.decode_s), total=sum(probe.decode_s),
                           median=statistics.median(probe.decode_s)),
        dense_check=dc, prompt_lens=[len(p) for p, _ in requests],
        answer_lens=[n for _, n in requests])

    # ------------------------------------ S4. kernel vs plain on the card
    t0 = phase("S4. paged-attention kernel vs plain version on the card")
    cfg = model.cfg
    T = S3_ENGINE["page_size"]
    # the S3 decode step that reads the most covered K/V: all rows live
    step = max(probe.steps, key=lambda s: (int((s["lens"] > 0).sum()),
                                           int(s["lens"].sum())))
    K = step["K"]
    classes = pa_ops.classes_of(K)
    rng = np.random.default_rng(5)
    B, H, KVH, D = S3_ENGINE["max_batch"], cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim
    q_np = rng.standard_normal((B, H, D)).astype(np.float32)
    lens = (step["lens"] + 1).astype(np.int32)     # the step's own token too
    kp16 = eng.state["pos0"]["pool_k"][0]          # layer 0, real K/V
    vp16 = eng.state["pos0"]["pool_v"][0]
    errs = {}
    try:
        for dt in (torch.bfloat16, torch.float32):
            q = torch.from_numpy(q_np).to(dev, dt)
            kp, vp = kp16.to(dt), vp16.to(dt)
            errs[f"s3_step_{str(dt)[6:]}"] = kernel_vs_plain(
                q, kp, vp, step["tables"], lens, K, T)
            del kp, vp
        for i, (b_, h_, kvh_, d_, t_) in enumerate(PAGED_SHAPES):
            case = pool_case(np.random.default_rng(i), b_, h_, kvh_, d_, t_)
            for dt in (torch.float32, torch.bfloat16):
                q, kp, vp = (torch.from_numpy(a).to(dev, dt)
                             for a in case[:3])
                errs[f"shape{i}_{str(dt)[6:]}"] = kernel_vs_plain(
                    q, kp, vp, case[3], case[4], (3, 2, 1), t_)
    except ValueError as e:
        fail(f"S4: {e}")
    for name, e in errs.items():
        print(f"  {name}: max abs err o {e['o']:.3g}, m {e['m']:.3g}, l "
              f"{e['l']:.3g}, merged {e['merged']:.3g}")
    err32 = max(max(e.values()) for n, e in errs.items() if "float32" in n)
    err16 = max(max(e.values()) for n, e in errs.items() if "bfloat16" in n)
    print(f"kernel == plain version within atol + rtol * |plain| (atol = "
          f"rtol = {PA_TOL['float32']} f32, {PA_TOL['bfloat16']} bf16): max "
          f"abs err {err32:.3g} (f32), {err16:.3g} (bf16); S3 launched it "
          f"{launches} times "
          f"({time.time() - t0:.1f} s)")
    out["s4"] = errs

    # ------------------------------------------------------------ S5. timing
    t0 = phase("S5. timing (L2 flushed before each call: device time from "
               "the profiler, mean of 20; CUDA events, median of 20)")
    desc = build_descriptors(step["tables"], K)
    q = torch.from_numpy(q_np).to(dev, torch.bfloat16)
    lens_t = torch.from_numpy(lens).to(dev)
    prep = prepare_descriptors(desc, classes, kp16.shape[0], dev)
    scale = 1.0 / float(np.sqrt(D))
    # overwriting 64 MB (more than the 50 MB L2) before each timed call puts
    # its inputs back in device memory, as a decode step's layers find them
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
    per_class, per_class_ev, plain_class = {}, {}, {}
    try:
        for k in classes:
            run = (lambda k=k: pa_ops._class_pass(
                q, kp16, vp16, *prep.tables[k], lens_t, k, T, scale))
            per_class[k] = device_ms(run, 20, flush, "class_pass_kernel")
            per_class_ev[k] = cuda_time_ms(run, 20, flush)
            plain_class[k] = cuda_time_ms(
                lambda k=k: paged_attention_class_pass_ref(
                    q, kp16, vp16, *prep.tables[k], lens_t,
                    pages_per_block=1 << k, page_size=T), 5, flush)
    except ValueError as e:
        fail(f"S5: {e}")
    ms_pa = sum(per_class.values())
    ms_pa_ev = sum(per_class_ev.values())
    plain_pa = sum(plain_class.values())
    parts = [pa_ops._class_pass(q, kp16, vp16, *prep.tables[k], lens_t, k,
                                T, scale) for k in classes]
    merge_ms = cuda_time_ms(lambda: merge_partials(parts), 20, flush)
    n_live = int((step["lens"] > 0).sum())
    b_ms, b_by, b_bytes, b_flops, b_tb, b_to = paged_bound(
        desc, classes, lens, B, H, KVH, D, T, 2)
    all_tokens = sum(int(np.asarray(desc[k][1]).astype(bool).sum())
                     * (1 << k) * T for k in classes)
    # library yardstick: one SDPA call over K/V already gathered dense
    import torch.nn.functional as F
    kd = gather_kv(kp16, step["tables"], T).transpose(1, 2).contiguous()
    vd = gather_kv(vp16, step["tables"], T).transpose(1, 2).contiguous()
    S = kd.shape[2]
    mask = (torch.arange(S, device=dev)[None, :] < lens_t[:, None].long()
            )[:, None, None, :]
    q4 = q[:, :, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask,
                                              enable_gqa=True)
    try:
        library_ms = device_ms(sdpa, 20, flush)
    except ValueError as e:
        fail(f"S5 library yardstick: {e}")
    library_ev = cuda_time_ms(sdpa, 20, flush)
    lib_note = (f"scaled_dot_product_attention(enable_gqa=True) on K/V "
                f"gathered dense [B={B}, KVH={KVH}, S={S}, D={D}], gather "
                f"excluded, device time (profiler)")
    del kd, vd
    print(f"class passes of one layer at the S3 step (B={B}, {n_live} live "
          f"rows, K={K}, kv_lens {int(step['lens'].min())}-"
          f"{int(step['lens'].max())}), device time (profiler): kernel "
          + ", ".join(f"k={k} {t:.4f} ms" for k, t in per_class.items())
          + f" = {ms_pa:.4f} ms; CUDA events (host launch included) "
          f"{ms_pa_ev:.4f} ms, merge {merge_ms:.4f} ms; plain version "
          f"{plain_pa:.3f} ms (CUDA events); library {library_ms:.5f} ms "
          f"(CUDA events {library_ev:.5f} ms; {lib_note})")
    print(f"bound {b_ms:.5f} ms by {b_by} ({b_bytes} B of live K/V tokens, "
          f"q and outputs at {HBM_BYTES_PER_S:.3g} B/s = {b_tb:.5f} ms; "
          f"{b_flops} flop at {BF16_FLOP_PER_S:.3g}/s = {b_to:.6f} ms); the "
          f"covered windows hold {all_tokens} token slots, "
          f"{live_tokens(desc, classes, lens, T)} of them live")
    t1 = time.perf_counter()
    for s in probe.steps:
        build_descriptors(s["tables"], s["K"])
        dma_stats(s["tables"], s["K"])
    host_desc = (time.perf_counter() - t1) / len(probe.steps)
    dec = out["s3"]["decode_step_s"]
    pf = out["s3"]["prefill_s"]
    print(f"S3 host clock: {pf['n']} prefills {pf['total']:.3f} s (median "
          f"{pf['median'] * 1e3:.1f} ms), {dec['n']} decode steps "
          f"{dec['total']:.3f} s (median {dec['median'] * 1e3:.2f} ms), "
          f"descriptor building {host_desc * 1e3:.3f} ms a step, engine "
          f"wall {out['s3']['engine_wall_s']:.3f} s; kernel "
          f"{cfg.n_layers} x {ms_pa:.4f} = {cfg.n_layers * ms_pa:.3f} ms "
          f"a step (device time, L2 flushed)")
    try:
        prof = profile_decode_step(model, eng, step, dev)
    except ValueError as e:
        fail(f"S5 decode-step profile: {e}")
    print(f"profiler, one S3 decode step replayed: {prof['kernels']} "
          f"kernels, device {prof['device_ms']:.3f} ms = paged attention "
          f"{prof['paged_attention_ms']:.3f} + matmuls "
          f"{prof['matmul_ms']:.3f} + other {prof['other_ms']:.3f} ms, "
          f"of {prof['wall_ms']:.3f} ms host wall (device busy "
          f"{100 * prof['busy_share']:.1f} %)")
    for r in prof["top"][:8]:
        print(f"  {r['ms']:8.3f} ms  x{r['count']:<4d} {r['name']}")
    out["s5"] = dict(
        step=dict(B=B, live_rows=n_live, K=list(K),
                  kv_lens=[int(x) for x in step["lens"]]),
        kernel_ms_by_class={str(k): t for k, t in per_class.items()},
        kernel_events_ms_by_class={str(k): t for k, t in
                                   per_class_ev.items()},
        plain_ms_by_class={str(k): t for k, t in plain_class.items()},
        merge_events_ms=merge_ms, library_ms=library_ms,
        library_events_ms=library_ev, library=lib_note,
        bound=dict(ms=b_ms, by=b_by, bytes=b_bytes, flops=b_flops,
                   bytes_ms=b_tb, ops_ms=b_to, token_slots=all_tokens,
                   live_tokens=live_tokens(desc, classes, lens, T)),
        host_descriptor_ms_per_step=host_desc * 1e3, profile=prof)
    kernel = dict(
        name="paged_attention", route="cuda", source=PA_SRC,
        replaces=PA_REPLACES, launches=launches, max_abs_err=err32,
        max_abs_err_bf16=err16, ms=round(ms_pa, 5),
        plain_ms=round(plain_pa, 4), bound_ms=round(b_ms, 6),
        bound_by=b_by, library_ms=round(library_ms, 5),
        ms_shape=(f"one layer's class passes of an S3 decode step, bf16, "
                  f"B={B} H={H} KVH={KVH} D={D} T={T} K={list(K)}"),
        ms_source="device time (profiler)", ms_events=round(ms_pa_ev, 5),
        library_ms_events=round(library_ev, 5),
        plain_ms_source="CUDA events",
        launches_by_class={str(k): n for k, n in by_class.items()})
    return kernel, out


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
