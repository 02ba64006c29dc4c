"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

The port has three main paths, each through its hand-written CUDA kernel:

* the batched TLB sweep, ``repro_torch.core.sweep.run_sweep``, whose every
  batch is one launch of the TLB-sweep kernel
  (``src/repro_torch/kernels/tlb_sweep/csrc/tlb_sweep.cu``);
* paged decode serving, ``repro_torch.serve.ServingEngine``, whose every
  decode step runs the class-k paged-attention kernels
  (``src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu``:
  a split kernel over each row's windows, then a combine kernel, from one
  wrapper call) once per layer and alignment class;
* prefill, ``Model.prefill`` (which the engine calls for every admitted
  request), whose every layer is one launch of the flash-attention kernel
  (``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``:
  the tensor-core kernel in bf16, the FMA kernel in f32).

Every kernel's launch count is set to 0 just before a path is driven and
read just after it.  Phases, each fatal on failure:

1. build — compile the three kernels with ``nvcc`` at once (one process
   per source) and print what ``-Xptxas -v`` says for the TLB sweep
   (registers, shared memory, spills); print the flash library's SASS
   instruction mix (``cuobjdump -sass``: HGMMA, HMMA and FFMA per
   instantiation), failing where a bf16 instantiation has no wgmma
   product (HGMMA) or an f32 one has a tensor-core product (TF32) or no
   FFMA;
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
4. timing with CUDA events (median of 5 after a warm-up; every CUDA-events
   time here is taken behind a ~1 ms spin queued on the stream, so that
   it holds no host launch cost) of the kernel on the phase-2 batch and of
   kernel and plain version on the phase-3 batch;

S1. the paged-attention kernel's ``-Xptxas -v`` report;
S2. InternLM2-1.8B at full width (24 layers, d_model 2048, 16 heads over 8
    KV heads, vocab 92,544), weights drawn with the port's seeded numpy
    init and checked against the digest in the fixture, served in f32
    compute (TF32 off) on the card: the generated tokens, the logits, the
    classes K and the descriptor counts must equal the JAX engine's in
    ``tests/data/port_serve_reference.json`` (tokens wherever the
    fixture's top-1/top-2 gap exceeds twice the logit tolerance, logits
    within ``LOGIT_ATOL``, integers exactly); every prefill launches the
    flash-attention kernel once per layer;
S3. the slice at conversation-trace lengths: default bf16 compute, 16
    requests whose prompt and answer lengths are drawn from a seed around
    the medians of the Azure LLM inference trace's conversation set (see
    ``s3_requests``), queued at once, through ``EngineConfig(page_size=16,
    num_pages=2048, max_batch=8, max_seq=4096)``; every request finishes
    (``stalled == 0``), the kernel ran with a class k >= 1, descriptors
    were coalesced, every prefill ran the flash-attention kernel once per
    layer, and every token equals the dense-cache decode's wherever the
    margin allows;
S4. the kernels against their plain version on the card — the class
    passes of one S3 decode step (bf16 and f32), ``tests/test_kernels.py``'s
    shape sweep and a junk-window and inactive-row case, each row's windows
    split 1, 2 and ``choose_splits`` ways: per class (o, m, l) and the
    merged output, f32 within 5e-5, bf16 within 2e-2, the -1e30 semantics
    of junk and inactive rows kept;
S5. the class passes of the S3 step against their plain version (per
    class (o, m, l) and the merged output, as in S4), then timed, L2
    flushed before each call: CUDA events behind the queued spin (the
    kernel line's ``ms`` and ``library_ms``) and device time from
    ``torch.profiler`` (split and combine kernel apart; the phase fails
    where the profiler records no such kernel, and reports the events it
    recorded against the launches, two per wrapper call for the port's
    kernels) of the class passes and of one
    ``scaled_dot_product_attention`` call on the same K/V gathered dense
    (the library yardstick, gather excluded); the plain version by CUDA
    events; the host clock of S3's prefills and decode steps and of the
    descriptor building; a profiler trace of one decode step;
F1. the flash-attention kernel against its plain version on the card:
    ``tests/test_kernels.py``'s four shapes, an InternLM2-1.8B layer at S3's
    longest prompt (3,072 tokens), non-causal at 2,048, and at its
    32,768-token context, each in f32 and bf16: f32 within 5e-5 and bf16
    within 2e-2 (atol + rtol * |plain|), and bf16 also within one bf16 ulp
    of the output (``BF16_ULP_RTOL``); two calls must give the same bits;
F3. long-context serving at full width: one request of 32,704 prompt and 16
    answer tokens through ``EngineConfig(page_size=16, num_pages=2112,
    max_batch=1, max_seq=32768)`` in bf16: one prefill through the kernel
    (24 launches), decode steps whose every class-6 pass walks the
    32k-token row split over at least as many blocks as the card has SMs
    (the grids the wrapper launched), the answer against the dense-cache
    decode as in S3, a profile of the prefill and of one decode step, and
    one layer's class passes at the last decode step held to their plain
    version and timed as in S5, with their bound and SDPA on the gathered
    K/V;
F4. timing of one InternLM2-1.8B layer's kernel at S = 3,072 and 32,768
    (bf16, causal: the tensor-core kernel), L2 flushed before each call:
    CUDA events (behind the queued spin, so the host launch is left out;
    the kernel line's times) and device time (profiler) of the kernel and
    of one
    ``scaled_dot_product_attention`` call on the same q and K/V repeated to
    16 heads (the library yardstick, repeat excluded), the plain version by
    CUDA events, and the bound;
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
# clock cycles of the spin queued before a CUDA-events timing (~1.1 ms at
# the H100's 1.755 GHz boost clock): longer than the host takes to queue a
# kernel wrapper's launch (~0.1 ms)
SLEEP_CYCLES = 2_000_000

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
# the two device kernels of one paged class pass (split, combine) and the
# fragment both their names hold
PA_KERNELS = ("paged_class_split_kernel", "paged_class_combine_kernel")
PA_NAME = "paged_class_"
# split counts S4 forces on every case (None: as choose_splits picks)
PA_SPLITS = (1, 2, None)
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

# ------------------------------------------------------------ prefill part
FA_SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:25"
# H100 SXM f32 rate outside the tensor cores (NVIDIA's data sheet): the
# peak for f32 inputs, which this repository never multiplies in TF32
F32_FLOP_PER_S = 67e12
# tests/test_kernels.py's flash-attention shapes (B, S, H, KVH, D, causal)
FLASH_SHAPES = ((2, 128, 4, 2, 64, True), (1, 200, 4, 4, 32, True),
                (2, 96, 8, 2, 64, False), (1, 64, 2, 1, 128, True))
# bf16 flash kernel vs plain version, beside PA_TOL's 2e-2 (which is as
# large as a typical output of a long causal row, ~sqrt(e / n) for n keys
# of standard normal inputs): both multiply and sum in f32 and round the
# output once to bf16, their f32 sums differing only in order, so they may
# differ by one bf16 ulp of the output, at most 2^-7 of |plain|; the
# absolute term, 1e-2 of the plain output's rms, covers outputs near 0
BF16_ULP_RTOL = 2.0 ** -7
BF16_RMS_ATOL = 1e-2
# prompt lengths of F1/F4 at InternLM2-1.8B's layer: S3's longest prompt
# and the model's published context (arXiv:2403.17297)
FLASH_LENS = (3072, 32768)
# F3: one request filling InternLM2-1.8B's 32k context, 16 answer tokens;
# 2,112 pages hold its 2,045 with the buddy allocator's slack
F3_ENGINE = dict(page_size=16, num_pages=2112, max_batch=1, max_seq=32768)
F3_PROMPT, F3_NEW, F3_SEED = 32704, 16, 13


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
    events).  A spin of ``SLEEP_CYCLES`` (~1 ms) is queued on the stream
    before the start event, so that the host has queued the event, ``fn``'s
    launches and the end event before the start event fires: a call whose
    launches the host issues faster than the card runs them is timed by
    its device time, without its host launch cost."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(SLEEP_CYCLES)
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
                prefills=len(probe.prefill_s),
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


def err_vs_plain(got, want, tol, what):
    """Largest absolute error of the kernels' tensor ``got`` against the
    plain version's ``want``; raises ``ValueError`` where an element lies
    past ``tol + tol * |want|``."""
    diff = (got - want).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if not bool((diff <= tol + tol * want.abs()).all()):
        raise ValueError(f"{what}: kernel differs from the plain version by "
                         f"{err:.3g}")
    return err


def parts_vs_plain(classes, got, want, tol, what=""):
    """Per-class ``(o, m, l)`` lists of the kernels (``got``) and of the
    plain version (``want``), for the classes ``classes`` in that order,
    then both merges
    (``merge_partials``): the largest absolute error of each of o, m, l
    and of the merged output; raises ``ValueError`` past ``tol``
    (:func:`err_vs_plain`)."""
    from repro_torch.kernels.paged_attention import merge_partials
    errs = dict(o=0.0, m=0.0, l=0.0)
    for k, g, w in zip(classes, got, want, strict=True):
        for name, a, b in zip("oml", g, w):
            errs[name] = max(errs[name], err_vs_plain(
                a, b, tol, f"{what}class {k} {name}"))
    errs["merged"] = err_vs_plain(merge_partials(got), merge_partials(want),
                                  tol, f"{what}merged output")
    return errs


def kernel_vs_plain(q, kp, vp, tables, lens, K, page_size, n_split=None):
    """Every class pass of ``K ∪ {0}`` through the kernels (each row's
    windows split ``min(n_split, n_win)`` ways, or as ``choose_splits``
    picks where ``n_split`` is None) and through the plain version on the
    same card tensors, then both merges.  Returns the largest absolute
    error of (o, m, l) and of the merged output; raises ``ValueError``
    past the dtype's tolerance."""
    from repro_torch.kernels.paged_attention import (
        build_descriptors, paged_attention_class_pass,
        paged_attention_class_pass_ref)
    from repro_torch.kernels.paged_attention.ops import classes_of
    tol = PA_TOL[str(q.dtype).replace("torch.", "")]
    desc = build_descriptors(tables, K)
    kparts, pparts = [], []
    classes = classes_of(K)
    for k in classes:
        wi, cov = desc[k]
        n = None if n_split is None else min(n_split, max(wi.shape[1], 1))
        kparts.append(paged_attention_class_pass(
            q, kp, vp, wi, cov, lens, pages_per_block=1 << k,
            page_size=page_size, n_split=n))
        pparts.append(paged_attention_class_pass_ref(
            q, kp, vp, wi, cov, lens, pages_per_block=1 << k,
            page_size=page_size))
    return parts_vs_plain(classes, kparts, pparts, tol)


def junk_vs_plain(dev, dtype, n_split):
    """``tests/test_torch_cuda.py::test_paged_kernel_junk_window_and_
    inactive_row`` at a forced split count: one class-2 pass over three
    rows — row 0 live, row 1 covered but wholly past its kv_len of 0
    (junk), row 2 inactive — through the kernels and the plain version.
    The junk row must keep m = -1e30 and l = its 64 token slots, the
    inactive row (0, -1e30, 0), and (o, m, l) equal the plain version's
    within the dtype's tolerance.  Returns the largest absolute error;
    raises ``ValueError``."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_attention_class_pass, paged_attention_class_pass_ref)
    rng = np.random.default_rng(1)
    T, KVH, D, H = 16, 2, 64, 4
    kp, vp = (torch.from_numpy(rng.standard_normal((32, T, KVH, D)).astype(
        np.float32)).to(dev, dtype) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((3, H, D)).astype(
        np.float32)).to(dev, dtype)
    lens = np.array([20, 0, 0], np.int32)
    wi = np.array([[0, 0], [3, 0], [0, 0]], np.int32)
    cov = np.array([[1, 0], [1, 0], [0, 0]], np.int8)
    tol = PA_TOL[str(dtype).replace("torch.", "")]
    got = paged_attention_class_pass(q, kp, vp, wi, cov, lens,
                                     pages_per_block=4, page_size=T,
                                     n_split=min(n_split, 2))
    want = paged_attention_class_pass_ref(q, kp, vp, wi, cov, lens,
                                          pages_per_block=4, page_size=T)
    o, m, l = (t.cpu() for t in got)
    if not (bool(torch.all(m[1] == -1e30)) and bool(torch.all(l[1] == 4 * T))
            and bool(torch.all(o[2] == 0)) and bool(torch.all(m[2] == -1e30))
            and bool(torch.all(l[2] == 0))):
        raise ValueError(f"n_split {n_split}: the junk or inactive row lost "
                         f"the -1e30 semantics (m {m[1:].tolist()}, l "
                         f"{l[1:].tolist()})")
    return max(err_vs_plain(a, b, tol, f"n_split {n_split} {name}")
               for name, a, b in zip("oml", got, want))


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


def kernel_rows(fn, reps, flush, expect="", counter=None, tries=3):
    """``{kernel name: {"ms", "recorded", "expected"}}`` of what ``fn``
    launches over ``reps`` calls, each after ``flush()`` (kernels named as
    the flush's own are left out), from ``torch.profiler``: ``ms`` is the
    mean device time per call.  ``expect`` is a name fragment, or a tuple
    of them, one for each device kernel the port's wrapper launches per
    counted launch (the paged wrapper launches a split and a combine
    kernel).  ``expected`` counts the events the calls launched: for each
    kernel of the port (the one name holding each fragment) the growth of
    its wrapper's launch count ``launch_counts()[counter]`` over the
    profiled calls, exactly; for a kernel without a count (a library
    call's) ``reps`` times its recorded events per call, rounded, at least
    one a call.  The profiler has been seen to lose events on the card
    (the flush's single call; one of three calls at 32k tokens), so the
    flush is profiled over ``reps`` calls and a profile short of events is
    taken again, up to ``tries`` times; a kernel still short after that is
    timed as its mean recorded launch times its expected launches per
    call, its ``recorded`` below its ``expected`` saying so.  Raises
    ``ValueError`` where no profile records a kernel for each fragment of
    ``expect``, or the flush's kernel."""
    import torch
    frags = (expect,) if isinstance(expect, str) else tuple(expect)
    fn()
    torch.cuda.synchronize()

    def flushes():
        for _ in range(reps):
            flush()
    for _ in range(tries):
        flush_names = set(_kernel_times(flushes))
        if flush_names:
            break
    else:
        raise ValueError("the profiler recorded no kernel of the L2 flush")

    def runs():
        for _ in range(reps):
            flush()
            fn()

    def timed(rows):
        return all(any(f in name and r["ms"] > 0 for name, r in rows.items())
                   for f in frags)
    for _ in range(tries):
        n0 = launch_counts()[counter] if counter else 0
        times = {name: r for name, r in _kernel_times(runs).items()
                 if name not in flush_names}
        own = launch_counts()[counter] - n0 if counter else 0
        for f in frags:
            mine = [name for name in times if f in name]
            if counter and len(mine) > 1:
                raise ValueError(f"{len(mine)} kernels hold {f!r}: "
                                 f"{mine[:4]}")
        rows = {}
        for name, (t, n) in times.items():
            e = (own if counter and any(f in name for f in frags)
                 else reps * max(1, round(n / reps)))
            rows[name] = dict(ms=t / n * e / reps, recorded=n, expected=e)
        if timed(rows) and all(r["recorded"] >= r["expected"]
                               for r in rows.values()):
            break
    if not timed(rows):
        raise ValueError(f"the profiler recorded no device time for a "
                         f"kernel named {frags!r}: {sorted(rows)[:8]}")
    return rows


def device_ms(fn, reps, flush, expect="", counter=None):
    """Mean device time of the kernels ``fn`` launches per call, with the
    events the profiler recorded and those the calls launched
    (:func:`kernel_rows`, ``expect`` a fragment or a tuple of them):
    ``{"ms", "recorded", "expected"}``."""
    rows = kernel_rows(fn, reps, flush, expect, counter).values()
    return {key: sum(r[key] for r in rows)
            for key in ("ms", "recorded", "expected")}


def events_note(*timed) -> str:
    """``"recorded/expected"`` profiler events over ``timed``
    (:func:`device_ms` results), marked where events are missing."""
    rec = sum(t["recorded"] for t in timed)
    exp = sum(t["expected"] for t in timed)
    return f"{rec}/{exp}" + ("" if rec >= exp else
                             " (MISSING: mean of the recorded launches)")


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


def time_class_passes(step, kp, vp, H, flush, reps=20, plain_reps=5,
                      seed=5):
    """One layer's class passes at a recorded decode step
    (``EngineProbe.steps``: its block tables, K and kv_lens), over the
    pools ``kp``/``vp`` of one layer, q drawn from ``seed``: first each
    class through the kernels (windows split as ``choose_splits`` picks;
    the grid read back from ``CLASS_GRIDS``) against the plain version
    (:func:`parts_vs_plain`, ``PA_TOL``), then timed, the L2 flushed before
    each call (``flush``): per class the kernels' CUDA-events time (median
    of ``reps``, behind a queued spin: the kernel line's ``ms``) and
    profiler device time (split + combine, mean of ``reps``, with the
    events recorded against the launches) and the plain version (CUDA
    events, median of ``plain_reps``); the merge; the bound
    (``paged_bound``); the library yardstick, one
    ``scaled_dot_product_attention`` call on K/V gathered dense (gather
    excluded); and ``line``, the kernel line's numbers.  Raises
    ``ValueError`` where the kernels disagree with the plain version or
    the profiler records no kernel or SDPA time."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (
        build_descriptors, gather_kv, merge_partials,
        paged_attention_class_pass_ref, prepare_descriptors)
    from repro_torch.kernels.paged_attention import ops as pa_ops
    dev = kp.device
    n_pages, T, KVH, D = kp.shape
    lens = (np.asarray(step["lens"]) + 1).astype(np.int32)  # own token too
    B = lens.shape[0]
    K = step["K"]
    classes = pa_ops.classes_of(K)
    q = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, H, D)).astype(np.float32)).to(dev, kp.dtype)
    desc = build_descriptors(step["tables"], K)
    prep = prepare_descriptors(desc, classes, n_pages, dev)
    lens_t = torch.from_numpy(lens).to(dev)
    scale = 1.0 / float(np.sqrt(D))

    def kernels(k):
        return pa_ops._class_pass(q, kp, vp, *prep.tables[k], lens_t, k, T,
                                  scale)

    def plain(k):
        return paged_attention_class_pass_ref(
            q, kp, vp, *prep.tables[k], lens_t, pages_per_block=1 << k,
            page_size=T, scale=scale)
    grids, parts = {}, []
    for k in classes:
        pa_ops.CLASS_GRIDS.pop(k, None)
        parts.append(kernels(k))
        (grids[k],) = pa_ops.CLASS_GRIDS[k]
    errs = parts_vs_plain(classes, parts, [plain(k) for k in classes],
                          PA_TOL[str(kp.dtype)[6:]])
    per, per_ev, plain_ms, timed = {}, {}, {}, {}
    for k in classes:
        timed[k] = device_ms(lambda k=k: kernels(k), reps, flush, PA_KERNELS,
                             "paged_attention")
        per[k] = timed[k]["ms"]
        per_ev[k] = cuda_time_ms(lambda k=k: kernels(k), reps, flush)
        plain_ms[k] = cuda_time_ms(lambda k=k: plain(k), plain_reps, flush)
    merge_ms = cuda_time_ms(lambda: merge_partials(parts), reps, flush)
    b_ms, b_by, b_bytes, b_flops, b_tb, b_to = paged_bound(
        desc, classes, lens, B, H, KVH, D, T, kp.element_size())
    slots = sum(int(np.asarray(desc[k][1]).astype(bool).sum())
                * (1 << k) * T for k in classes)
    kd = gather_kv(kp, step["tables"], T).transpose(1, 2).contiguous()
    vd = gather_kv(vp, step["tables"], T).transpose(1, 2).contiguous()
    S = kd.shape[2]
    mask = (torch.arange(S, device=dev)[None, :] < lens_t[:, None].long()
            )[:, None, None, :]
    q4 = q[:, :, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask,
                                              enable_gqa=True)
    lib_timed = device_ms(sdpa, reps, flush)
    lib_ev = cuda_time_ms(sdpa, reps, flush)
    del kd, vd
    lib_note = (f"scaled_dot_product_attention(enable_gqa=True) on K/V "
                f"gathered dense [B={B}, KVH={KVH}, S={S}, D={D}], gather "
                f"excluded")
    ms_ev = sum(per_ev.values())
    splits = {str(k): g[2] for k, g in grids.items()}
    return dict(
        dtype=str(kp.dtype)[6:],
        step=dict(B=B, live_rows=int((lens > 1).sum()), K=list(K),
                  kv_lens=[int(x) for x in lens]),
        ms=ms_ev, kernel_ms_by_class={str(k): t for k, t in per.items()},
        kernel_events_ms_by_class={str(k): t for k, t in per_ev.items()},
        plain_ms_by_class={str(k): t for k, t in plain_ms.items()},
        n_split_by_class=splits,
        blocks_by_class={str(k): g[0] * g[1] * g[2]
                         for k, g in grids.items()},
        vs_plain=errs, merge_events_ms=merge_ms,
        library_ms=lib_ev, library_device_ms=lib_timed["ms"],
        library=lib_note,
        profiler_events=dict(kernel=events_note(*timed.values()),
                             library=events_note(lib_timed)),
        bound=dict(ms=b_ms, by=b_by, bytes=b_bytes, flops=b_flops,
                   bytes_ms=b_tb, ops_ms=b_to, token_slots=slots,
                   live_tokens=live_tokens(desc, classes, lens, T)),
        line=dict(
            ms=round(ms_ev, 5), plain_ms=round(sum(plain_ms.values()), 4),
            bound_ms=round(b_ms, 6), bound_by=b_by,
            library_ms=round(lib_ev, 5),
            vs_plain_max_abs_err=max(errs.values()),
            ms_shape=(f"one layer's class passes of a decode step, "
                      f"{str(kp.dtype)[6:]}, B={B} H={H} KVH={KVH} D={D} "
                      f"T={T} K={list(K)}, n_split by class {splits}"),
            ms_source="CUDA events behind a queued spin (host launch "
                      "excluded)",
            ms_profiler=round(sum(per.values()), 5),
            library_ms_profiler=round(lib_timed["ms"], 5),
            profiler_events=events_note(*timed.values()),
            library_profiler_events=events_note(lib_timed),
            plain_ms_source="CUDA events behind a queued spin"))


def print_class_passes(what, tp):
    """Lines of :func:`time_class_passes`' numbers: the check against the
    plain version, the times, and the bound."""
    line, b = tp["line"], tp["bound"]
    print(f"class passes of one layer at {what}, n_split by class "
          f"{tp['n_split_by_class']} ({tp['blocks_by_class']} blocks): "
          f"kernels == plain version within atol + rtol * |plain| (atol = "
          f"rtol = {PA_TOL[tp['dtype']]}), max abs err "
          + ", ".join(f"{key} {val:.3g}" for key, val in tp["vs_plain"].items()))
    print(f"CUDA events behind a queued spin: kernel "
          + ", ".join(f"k={k} {t:.4f} ms"
                      for k, t in tp["kernel_events_ms_by_class"].items())
          + f" = {tp['ms']:.5f} ms, merge {tp['merge_events_ms']:.4f} ms, "
          f"library {tp['library_ms']:.5f} ms ({tp['library']}); plain "
          f"version {line['plain_ms']:.3f} ms; profiler device time (split "
          f"+ combine): kernel "
          + ", ".join(f"k={k} {t:.4f} ms"
                      for k, t in tp["kernel_ms_by_class"].items())
          + f", library {tp['library_device_ms']:.5f} ms; profiler events "
          f"recorded/launched: kernel {tp['profiler_events']['kernel']}, "
          f"library {tp['profiler_events']['library']}")
    print(f"bound {b['ms']:.5f} ms by {b['by']} ({b['bytes']} B of live K/V "
          f"tokens, q and outputs at {HBM_BYTES_PER_S:.3g} B/s = "
          f"{b['bytes_ms']:.5f} ms; {b['flops']} flop at "
          f"{BF16_FLOP_PER_S:.3g}/s = {b['ops_ms']:.6f} ms); the covered "
          f"windows hold {b['token_slots']} token slots, "
          f"{b['live_tokens']} of them live")


def profile_breakdown(fn, kernel, label):
    """Device time by kernel over one call of ``fn`` (after a warm-up
    call), from ``torch.profiler``'s kernel events, split into the port's
    kernel (names holding ``kernel``, reported as ``<label>_ms``), matrix
    products and the rest, beside the call's host-clock wall for the
    device's busy share.  Raises ``ValueError`` where the trace holds no
    such kernel."""
    import torch
    wall = []

    def run():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    run()                                          # warm
    rows = _kernel_times(run)
    wall_ms = wall[-1]
    total = sum(r[0] for r in rows.values())
    own = sum(r[0] for n, r in rows.items() if kernel in n)
    if not own > 0:
        raise ValueError(f"the profiler recorded no {label} kernel")
    gemm = sum(r[0] for n, r in rows.items() if any(w in n.lower() for w in (
        "gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_")))
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms": wall_ms, "device_ms": total,
            "busy_share": total / wall_ms, f"{label}_ms": own,
            "matmul_ms": gemm, "other_ms": total - own - gemm,
            "kernels": sum(r[1] for r in rows.values()),
            "top": [dict(name=n[:120], ms=r[0], count=r[1])
                    for n, r in top]}


def profile_decode_step(model, eng, step, dev):
    """:func:`profile_breakdown` of one replayed decode step (host
    descriptor building included in its wall)."""
    import torch
    from repro_torch.kernels.paged_attention import build_descriptors
    B = eng.ec.max_batch
    toks = torch.zeros((B, 1), dtype=torch.long, device=dev)

    def run():
        desc = build_descriptors(step["tables"], step["K"])
        model.decode_step_paged(eng.params, eng.state, toks, step["lens"],
                                step["tables"], desc,
                                page_size=eng.ec.page_size,
                                K_classes=step["K"])
    return profile_breakdown(run, PA_NAME, "paged_attention")


#: opcodes counted in the flash library's SASS: the tensor cores' two
#: forms (wgmma; mma.sync, which an f32 kernel would use for TF32) and f32
#: FMAs on the CUDA cores
SASS_OPS = ("HGMMA", "HMMA", "FFMA")


def sass_counts(sass: str) -> dict:
    """``{function: {opcode: count}}`` of ``SASS_OPS`` in ``cuobjdump
    -sass`` output, an instruction's opcode being the word before its
    first dot (``HMMA.16816.F32.BF16`` counts as ``HMMA``), after any
    predicate (``@P0``, ``@!PT``)."""
    import re
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), dict.fromkeys(SASS_OPS, 0))
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if cur is not None and m and m.group(1) in cur:
            cur[m.group(1)] += 1
    return out


def flash_sass_mix(sass: str) -> dict:
    """The flash library's instantiations as ``{"bf16 D=128": {op: n},
    "f32 D=128": ...}`` (from :func:`sass_counts`): the tensor-core
    kernel (``_wg``: wgmma) is the bf16 one, the FMA kernel the f32 one.
    Raises ``ValueError`` where a bf16 instantiation has no HGMMA, or an
    f32 one has no FFMA or any tensor-core product (TF32)."""
    import re
    mix = {}
    for fn, ops in sass_counts(sass).items():
        m = re.search(r"flash_attention_fwd(_wg)?_kernelI(f)?Li(\d+)E", fn)
        if not m:
            continue
        dt = "bf16" if m.group(1) else ("f32" if m.group(2) else None)
        if dt is None:
            raise ValueError(f"unexpected flash instantiation {fn}")
        mix[f"{dt} D={m.group(3)}"] = ops
    for dt in ("bf16", "f32"):
        if not any(k.startswith(dt) for k in mix):
            raise ValueError(f"no {dt} instantiation in the flash library's "
                             f"SASS: {sorted(mix)}")
    for name, ops in mix.items():
        tensor = ops["HGMMA"] + ops["HMMA"]
        if name.startswith("bf16") and ops["HGMMA"] == 0:
            raise ValueError(f"{name}: no HGMMA, so its products do not run "
                             f"on the tensor cores through wgmma ({ops})")
        if name.startswith("f32") and (tensor or not ops["FFMA"]):
            raise ValueError(f"{name}: f32 must multiply in FFMA, with no "
                             f"tensor-core (TF32) product ({ops})")
    return mix


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.tlb_sweep import LAUNCHES as TLB_LAUNCHES
    for k in TLB_LAUNCHES:
        TLB_LAUNCHES[k] = 0
    pa_ops.reset_launch_counts()
    fa_ops.LAUNCHES["flash_attention"] = 0


def launch_counts() -> dict:
    """Every kernel's launch count."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.tlb_sweep import LAUNCHES as TLB_LAUNCHES
    return dict(tlb_sweep=TLB_LAUNCHES.get("tlb_sweep", 0),
                paged_attention=pa_ops.LAUNCHES["paged_attention"],
                flash_attention=fa_ops.LAUNCHES["flash_attention"])


def flash_bound(B, S, H, KVH, D, elt, causal=True):
    """Least time the card could take for one forward attention: bytes of
    q, k, v read once and o written once at the HBM rate; operations (a
    multiply-add each for q.k and p.v per head dim, query head and (query,
    key) pair the mask keeps: S(S+1)/2 pairs causal, S^2 not) at the peak
    rate of the inputs' type (bf16 tensor rate for 2-byte types, the f32
    rate otherwise).  Returns (ms, by, bytes, flops, bytes_ms, ops_ms)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * D * B * H * pairs
    n_bytes = elt * B * S * D * (2 * H + 2 * KVH)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_FLOP_PER_S if elt == 2 else F32_FLOP_PER_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", n_bytes, flops, t_bytes, t_ops)


def flash_inputs(shape, dtype, device, seed=0):
    """q [B, S, H, D] and k, v [B, S, KVH, D], standard normal from a numpy
    seed, in ``dtype`` on ``device``."""
    import numpy as np
    import torch
    B, S, H, KVH, D = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(
        device, dtype) for sh in ((B, S, H, D), (B, S, KVH, D),
                                  (B, S, KVH, D))]


def flash_vs_plain(q, k, v, causal):
    """The flash-attention kernel against ``flash_attention_ref`` on the same
    card tensors, and against itself (a second call must give the same
    bits).  Holds every element to ``atol + rtol * |plain|`` with the
    dtype's tolerance (``PA_TOL``) and, in bf16, to one bf16 ulp of the
    output (``BF16_ULP_RTOL * |plain| + BF16_RMS_ATOL * rms(plain)``).
    Returns ``{"max_abs_err", "rms", "limit_used"}``: the largest
    absolute error, the plain output's rms and the largest share of the
    tighter limit an element uses; raises ``ValueError`` past a limit or on
    differing bits."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_gqa,
                                                     flash_attention_ref)
    tol = PA_TOL[str(q.dtype).replace("torch.", "")]
    got = flash_attention_gqa(q, k, v, causal=causal)
    again = flash_attention_gqa(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    if q.device.type == "cuda":
        torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise ValueError("two calls of the kernel gave different bits")
    want = want.float()
    diff = (got.float() - want).abs()
    err = float(diff.max())
    rms = float(want.square().mean().sqrt())
    if not bool((diff <= tol + tol * want.abs()).all()):
        raise ValueError(f"kernel differs from the plain version by {err:.3g}"
                         f" (atol = rtol = {tol})")
    if q.dtype == torch.bfloat16:
        limit = BF16_ULP_RTOL * want.abs() + BF16_RMS_ATOL * rms
    else:
        limit = tol + tol * want.abs()
    used = float((diff / limit).max())
    if used > 1:
        raise ValueError(f"kernel differs from the plain version by more "
                         f"than one bf16 ulp: {used:.3g} of 2^-7 |plain| + "
                         f"{BF16_RMS_ATOL} rms (rms {rms:.3g}, max abs err "
                         f"{err:.3g})")
    return dict(max_abs_err=err, rms=rms, limit_used=used)


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
        from repro_torch.kernels.tlb_sweep import (_build, run_lanes,
                                                   run_lanes_ref)
        from repro_torch.kernels.tlb_sweep.ops import (as_tensors,
                                                       prepare_cuda)
        from repro_torch.kernels.paged_attention import _build as pa_build
        from repro_torch.kernels.paged_attention import ops as pa_ops
        from repro_torch.kernels.flash_attention import _build as fa_build
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
    t0 = phase("1. build (nvcc, sm_90a; the three kernels at once)")
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(3) as ex:
        builds = [(b, ex.submit(b.build))
                  for b in (_build, pa_build, fa_build)]
        for b, fut in builds:
            try:
                lib = fut.result()
            except Exception as e:  # the build must not fail
                fail(f"kernel build failed: {e}")
            print(f"built {os.path.relpath(str(lib), HERE)}")
    print(f"the three kernels built in {time.time() - t0:.1f} s")
    for line in _build.ptxas_report().splitlines():
        if ("Compiling" in line or "registers" in line or "spill" in line
                or "smem" in line):
            print("  " + line.strip())
    from repro_torch.kernels._nvcc import find_nvcc
    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    proc = subprocess.run([cuobjdump, "-sass", str(fa_build.library_path())],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump -sass failed: {proc.stderr.strip()[:500]}")
    try:
        sass_mix = flash_sass_mix(proc.stdout)
    except ValueError as e:
        fail(f"flash SASS: {e}")
    print("flash-attention SASS, instructions per instantiation: " + "; ".join(
        f"{name} " + " ".join(f"{op} {n}" for op, n in ops.items())
        for name, ops in sorted(sass_mix.items())))

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
    reset_counts()
    t1 = time.time()
    sweep = run_sweep(cells, cache=False, device="cuda")
    torch.cuda.synchronize()
    launches = launch_counts()
    wall = time.time() - t1
    print(f"run_sweep(device='cuda'): {wall:.2f} s wall, stats "
          f"{sweep.stats}, launches {launches}")
    if launches["tlb_sweep"] < 1:
        fail("the main path did not launch the tlb_sweep kernel")
    if launches["paged_attention"] or launches["flash_attention"]:
        fail("the sweep launched an attention kernel")
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

    pa, serve_out, params = serve_phases(torch, np, dev, pa_build, pa_ops)
    fa, flash_out = flash_phases(torch, np, dev, params, fa_build,
                                 serve_out)
    del params
    fa["sass"] = sass_mix
    pa["at_f3_step"] = flash_out["f3"]["paged_layer"]["line"]

    # ----------------------------------------------------------- 5. report
    phase("5. report")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kernels=[tlb, pa, fa], tlb_sweep=tlb_out,
                       serving=serve_out, prefill=flash_out,
                       flash_sass=sass_mix), f, indent=1)
    print(json.dumps({"kernels": [tlb, pa, fa]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def serve_phases(torch, np, dev, pa_build, pa_ops):
    """Phases S1-S5 (paged decode serving); returns the paged-attention
    kernel's line, the numbers for ``chip_smoke.json`` and the bf16 weights
    on the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import (build_descriptors,
                                                     dma_stats)
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
        torch.cuda.synchronize()
        reset_counts()
        s2 = serve_against_fixture(ref, dev, params)
        torch.cuda.synchronize()
    except ValueError as e:
        fail(f"S2: {e}")
    s2["launches"] = launch_counts()
    s2.pop("params")
    n_layers = model32.cfg.n_layers
    if (s2["launches"]["flash_attention"] != n_layers * s2["prefills"]
            or s2["launches"]["paged_attention"] < 1):
        fail(f"S2: {s2['prefills']} prefills and the decode steps launched "
             f"{s2['launches']}; want {n_layers} flash-attention launches a "
             "prefill and a paged-attention launch")
    print(f"{model32.n_params():,} parameters drawn, checked against the "
          f"fixture's digest and moved to the card in {t_weights:.1f} s")
    print(f"tokens {s2['generated']} == JAX ({s2['tokens_checked']} of "
          f"{s2['tokens_total']} past the margin), logits max abs err "
          f"{s2['max_abs_err']:.3g} <= {LOGIT_ATOL}, K={s2['K']}, descriptor "
          f"reduction {s2['descriptor_reduction']:.4f} == JAX; engine "
          f"{s2['wall_s']:.2f} s ({time.time() - t0:.1f} s in all); launches "
          f"{s2['launches']} ({s2['prefills']} prefills x {n_layers} "
          "layers through the flash-attention kernel)")
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
    reset_counts()
    t1 = time.time()
    m = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.time() - t1
    counts = launch_counts()
    launches = counts["paged_attention"]
    fa_launches = counts["flash_attention"]
    by_class = dict(pa_ops.CLASS_LAUNCHES)
    print(f"engine wall {wall:.2f} s: {m['steps']} steps, {m['tokens']} "
          f"decoded tokens, K={m['K']}, descriptor reduction "
          f"{m['descriptor_reduction']:.4f}, preemptions "
          f"{m['preemptions']}, stalled {m['stalled']}; paged-attention "
          f"launches {launches} by class {by_class}; flash-attention "
          f"launches {fa_launches} ({len(probe.prefill_s)} prefills x "
          f"{model.cfg.n_layers} layers)")
    if m["stalled"] != 0 or any(r.state != "done"
                                for r in eng.requests.values()):
        fail("S3: not every request finished")
    if [len(eng.requests[i].generated) for i in range(S3_REQUESTS)] != [
            n for _, n in requests]:
        fail("S3: a request did not get all its tokens")
    if launches < 1 or not any(k >= 1 and n > 0 for k, n in by_class.items()):
        fail("S3: the paged-attention kernel did not run a class k >= 1")
    if counts["tlb_sweep"] != 0:
        fail("S3: the serving path launched the TLB kernel")
    if fa_launches != model.cfg.n_layers * len(probe.prefill_s):
        fail(f"S3: {len(probe.prefill_s)} prefills launched the "
             f"flash-attention kernel {fa_launches} times")
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
        flash_launches=fa_launches,
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
        for ns in PA_SPLITS:
            tag = f"n_split_{ns or 'chosen'}"
            for dt in (torch.bfloat16, torch.float32):
                q = torch.from_numpy(q_np).to(dev, dt)
                kp, vp = kp16.to(dt), vp16.to(dt)
                errs[f"s3_step_{str(dt)[6:]}_{tag}"] = kernel_vs_plain(
                    q, kp, vp, step["tables"], lens, K, T, ns)
                del kp, vp
                errs[f"junk_{str(dt)[6:]}_{tag}"] = dict(
                    oml=junk_vs_plain(dev, dt, ns or 2))
            for i, (b_, h_, kvh_, d_, t_) in enumerate(PAGED_SHAPES):
                case = pool_case(np.random.default_rng(i), b_, h_, kvh_, d_,
                                 t_)
                for dt in (torch.float32, torch.bfloat16):
                    q, kp, vp = (torch.from_numpy(a).to(dev, dt)
                                 for a in case[:3])
                    errs[f"shape{i}_{str(dt)[6:]}_{tag}"] = kernel_vs_plain(
                        q, kp, vp, case[3], case[4], (3, 2, 1), t_, ns)
    except ValueError as e:
        fail(f"S4: {e}")
    for name, e in errs.items():
        print(f"  {name}: max abs err " + ", ".join(
            f"{key} {val:.3g}" for key, val in e.items()))
    err32 = max(max(e.values()) for n, e in errs.items() if "float32" in n)
    err16 = max(max(e.values()) for n, e in errs.items() if "bfloat16" in n)
    print(f"kernel == plain version within atol + rtol * |plain| (atol = "
          f"rtol = {PA_TOL['float32']} f32, {PA_TOL['bfloat16']} bf16) at "
          f"every split count (1, 2, choose_splits'), the -1e30 semantics "
          f"kept: max abs err {err32:.3g} (f32), {err16:.3g} (bf16); S3 "
          f"launched it {launches} times ({time.time() - t0:.1f} s)")
    out["s4"] = errs

    # ------------------------------------------------------------ S5. timing
    t0 = phase("S5. the S3 step's class passes vs plain, then timing (L2 "
               "flushed before each call: CUDA events, median of 20; device "
               "time from the profiler, mean of 20)")
    # overwriting 64 MB (more than the 50 MB L2) before each timed call puts
    # its inputs back in device memory, as a decode step's layers find them
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
    try:
        tp = time_class_passes(step, kp16, vp16, H, flush)
    except ValueError as e:
        fail(f"S5: {e}")
    print_class_passes(f"the S3 step (B={B}, "
                       f"{int((step['lens'] > 0).sum())} live rows, K={K}, "
                       f"kv_lens {int(step['lens'].min())}-"
                       f"{int(step['lens'].max())})", tp)
    ms_pa = tp["ms"]
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
          f"a step (CUDA events, L2 flushed)")
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
    out["s5"] = dict(tp, host_descriptor_ms_per_step=host_desc * 1e3,
                     profile=prof)
    kernel = dict(
        name="paged_attention", route="cuda", source=PA_SRC,
        replaces=PA_REPLACES, launches=launches, max_abs_err=err32,
        max_abs_err_bf16=err16, **tp["line"],
        launches_by_class={str(k): n for k, n in by_class.items()},
        device_kernels_per_launch=len(PA_KERNELS))
    return kernel, out, eng.params


def flash_phases(torch, np, dev, params, fa_build, serve_out):
    """Phases F1, F3 and F4 (prefill attention; S2 and S3 drove it through
    the engine already, ``serve_out`` holds their launch counts); returns
    the flash-attention kernel's line and the numbers for
    ``chip_smoke.json``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_gqa,
                                                     flash_attention_ref)
    from repro_torch.models import Model, RunConfig
    from repro_torch.serve import EngineConfig, ServingEngine
    out = {}
    model = Model(get_config(SERVE_ARCH), RunConfig())
    cfg = model.cfg
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    # --------------------------------------- F1. kernel vs plain, the card
    t0 = phase("F1. flash-attention kernel vs plain version on the card")
    for line in fa_build.ptxas_report().splitlines():
        if "Compiling" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in f32
    cases = [(f"test_kernels{i}", shape[:5], shape[5], dt)
             for i, shape in enumerate(FLASH_SHAPES)
             for dt in (torch.float32, torch.bfloat16)]
    layer = lambda S: (1, S, H, KVH, D)  # noqa: E731
    cases += [(f"internlm2_S{FLASH_LENS[0]}", layer(FLASH_LENS[0]), True, dt)
              for dt in (torch.float32, torch.bfloat16)]
    cases += [("internlm2_S2048_noncausal", layer(2048), False, dt)
              for dt in (torch.float32, torch.bfloat16)]
    cases += [(f"internlm2_S{FLASH_LENS[1]}", layer(FLASH_LENS[1]), True, dt)
              for dt in (torch.float32, torch.bfloat16)]
    errs = {}
    try:
        for name, shape, causal, dt in cases:
            q, k, v = flash_inputs(shape, dt, dev)
            t1 = time.time()
            errs[f"{name}_{str(dt)[6:]}"] = e = flash_vs_plain(q, k, v,
                                                               causal)
            print(f"  {name} {str(dt)[6:]} {shape} causal={causal}: max abs "
                  f"err {e['max_abs_err']:.3g}, output rms {e['rms']:.3g}, "
                  f"{100 * e['limit_used']:.1f} % of the tighter limit, "
                  f"deterministic ({time.time() - t1:.1f} s)")
            del q, k, v
    except ValueError as e:
        fail(f"F1 {name} {dt}: {e}")
    torch.cuda.empty_cache()
    err32, err16 = (max(e["max_abs_err"] for n, e in errs.items()
                        if n.endswith(dt)) for dt in ("float32", "bfloat16"))
    used32, used16 = (max(e["limit_used"] for n, e in errs.items()
                          if n.endswith(dt)) for dt in ("float32", "bfloat16"))
    print(f"kernel == plain version within atol + rtol * |plain| (atol = "
          f"rtol = {PA_TOL['float32']} f32, {PA_TOL['bfloat16']} bf16) and, "
          f"in bf16, within one ulp ({BF16_ULP_RTOL:.6g} |plain| + "
          f"{BF16_RMS_ATOL} rms): max abs err {err32:.3g} (f32, "
          f"{100 * used32:.1f} % of its limit), {err16:.3g} (bf16, "
          f"{100 * used16:.1f} % of the ulp limit); two calls equal bit for "
          f"bit ({time.time() - t0:.1f} s)")
    out["f1"] = errs

    # ------------------------------ F3. long-context serving at full width
    t0 = phase(f"F3. serving, bf16: one request of {F3_PROMPT} prompt and "
               f"{F3_NEW} answer tokens, {F3_ENGINE['num_pages']} pages x "
               f"{F3_ENGINE['page_size']} tokens")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(model, params, EngineConfig(**F3_ENGINE), device=dev)
    probe = EngineProbe(model, eng)
    eng.model = probe
    rng = np.random.default_rng(F3_SEED)
    eng.add_request([int(t) for t in rng.integers(0, cfg.vocab, F3_PROMPT)],
                    max_new_tokens=F3_NEW)
    from repro_torch.kernels.paged_attention import ops as pa_ops
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.time()
    m = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.time() - t1
    counts = launch_counts()
    by_class = dict(pa_ops.CLASS_LAUNCHES)
    grids6 = sorted(pa_ops.CLASS_GRIDS.get(6, ()))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    req = eng.requests[0]
    pre = probe.prefill_s
    print(f"engine wall {wall:.2f} s: {m['steps']} steps, K={m['K']}, "
          f"descriptor reduction {m['descriptor_reduction']:.4f}, stalled "
          f"{m['stalled']}; launches {counts}, paged by class {by_class}; "
          f"prefill {pre[0][1]:.3f} s for {pre[0][0]} tokens, decode steps "
          f"median {statistics.median(probe.decode_s) * 1e3:.2f} ms "
          f"({len(probe.decode_s)} steps); peak device memory {peak_gb:.2f} "
          "GB")
    if m["stalled"] != 0 or req.state != "done" \
            or len(req.generated) != F3_NEW:
        fail("F3: the long request did not finish with all its tokens")
    if counts["flash_attention"] != cfg.n_layers * len(pre) or len(pre) != 1:
        fail(f"F3: {len(pre)} prefills launched the flash-attention kernel "
             f"{counts['flash_attention']} times")
    if counts["paged_attention"] < 1 or counts["tlb_sweep"] != 0:
        fail(f"F3: launches {counts}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if not grids6 or min(a * b * c for a, b, c in grids6) < sms:
        fail(f"F3: the class-6 passes launched the grids (KVH, B, n_split) "
             f"{grids6}, not one of at least the card's {sms} SMs")
    print(f"class-6 grids (KVH, B, n_split) launched: {grids6}")
    try:
        dc = dense_check(model, eng.params, [req], dev, DENSE_MARGIN)
    except ValueError as e:
        fail(f"F3 vs dense decode: {e}")
    print(f"vs the dense-cache decode_step (teacher-forced): {dc['equal']} of "
          f"{dc['checked']} tokens equal, the rest within {DENSE_MARGIN} "
          f"(largest lead {dc['max_gap']:.4g})")
    toks = torch.tensor([req.prompt], device=dev)
    try:
        prof_pre = profile_breakdown(
            lambda: model.prefill(eng.params, toks), "flash_attention_fwd",
            "flash_attention")
        prof_dec = profile_decode_step(model, eng, probe.steps[-1], dev)
    except ValueError as e:
        fail(f"F3 profile: {e}")
    for what, pr, own in (("prefill", prof_pre, "flash_attention"),
                          ("decode step", prof_dec, "paged_attention")):
        print(f"profiler, the {what} replayed: {pr['kernels']} kernels, "
              f"device {pr['device_ms']:.3f} ms = {own.replace('_', ' ')} "
              f"{pr[own + '_ms']:.3f} + matmuls {pr['matmul_ms']:.3f} + other "
              f"{pr['other_ms']:.3f} ms, of {pr['wall_ms']:.3f} ms host wall "
              f"(device busy {100 * pr['busy_share']:.1f} %)")
    out["f3"] = dict(
        engine_wall_s=wall, steps=m["steps"], K=m["K"],
        descriptor_reduction=m["descriptor_reduction"], launches=counts,
        launches_by_class={str(k): n for k, n in by_class.items()},
        prefill_s=pre[0][1], prompt_tokens=pre[0][0],
        decode_step_s=dict(n=len(probe.decode_s), total=sum(probe.decode_s),
                           median=statistics.median(probe.decode_s)),
        peak_memory_gb=peak_gb, class6_grids=grids6, dense_check=dc,
        profile_prefill=prof_pre,
        profile_decode_step=prof_dec)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
    step = probe.steps[-1]
    try:
        tp = time_class_passes(step, eng.state["pos0"]["pool_k"][0],
                               eng.state["pos0"]["pool_v"][0], H, flush)
    except ValueError as e:
        fail(f"F3 paged timing: {e}")
    print_class_passes(f"F3's last decode step (kv_len "
                       f"{int(step['lens'][0])}, K={step['K']})", tp)
    out["f3"]["paged_layer"] = tp
    print(f"({time.time() - t0:.1f} s in all)")
    del eng, probe, req, toks
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ F4. timing
    t0 = phase("F4. timing of one InternLM2-1.8B layer, bf16, causal (L2 "
               "flushed before each call)")
    timings = {}
    try:
        for S, reps, plain_reps in ((FLASH_LENS[0], 20, 5),
                                    (FLASH_LENS[1], 3, 2)):
            q, k, v = flash_inputs(layer(S), torch.bfloat16, dev, seed=1)
            run = lambda: flash_attention_gqa(q, k, v, causal=True)  # noqa: E731
            timed = device_ms(run, reps, flush, "flash_attention_fwd",
                              "flash_attention")
            ms = timed["ms"]
            ms_ev = cuda_time_ms(run, reps, flush)
            plain = cuda_time_ms(lambda: flash_attention_ref(
                q, k, v, causal=True), plain_reps, flush)
            # the library yardstick on [B, H, S, D], K/V repeated to H heads
            qt = q.transpose(1, 2).contiguous()
            kt = k.repeat_interleave(H // KVH, 2).transpose(1, 2).contiguous()
            vt = v.repeat_interleave(H // KVH, 2).transpose(1, 2).contiguous()

            def sdpa():
                with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                                  SDPBackend.EFFICIENT_ATTENTION]):
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True)
            lib_rows = kernel_rows(sdpa, reps, flush)
            lib_timed = {key: sum(r[key] for r in lib_rows.values())
                         for key in ("ms", "recorded", "expected")}
            lib = lib_timed["ms"]
            lib_ev = cuda_time_ms(sdpa, reps, flush)
            lib_names = sorted(n[:80] for n in lib_rows)
            b_ms, b_by, b_bytes, b_flops, b_tb, b_to = flash_bound(
                1, S, H, KVH, D, 2)
            timings[S] = dict(
                ms=ms_ev, ms_profiler=ms, plain_ms=plain, library_ms=lib_ev,
                library_ms_profiler=lib, library_kernels=lib_names,
                bound_ms=b_ms, bound_by=b_by, bytes=b_bytes, flops=b_flops,
                bytes_ms=b_tb, ops_ms=b_to,
                tflops=b_flops / (ms_ev * 1e-3) / 1e12,
                profiler_events=events_note(timed),
                library_profiler_events=events_note(lib_timed))
            print(f"S={S}: kernel {ms_ev:.5f} ms CUDA events behind a "
                  f"queued spin ({timings[S]['tflops']:.2f} Tflop/s), "
                  f"{ms:.5f} ms device time (profiler); plain version "
                  f"{plain:.3f} ms (CUDA events); library {lib_ev:.5f} ms "
                  f"CUDA events, {lib:.5f} ms device time "
                  f"({', '.join(lib_names)}); bound {b_ms:.5f} ms by "
                  f"{b_by} ({b_flops:.4g} flop at {BF16_FLOP_PER_S:.3g}/s = "
                  f"{b_to:.5f} ms; {b_bytes} B at {HBM_BYTES_PER_S:.3g} B/s "
                  f"= {b_tb:.5f} ms); profiler events recorded/launched: "
                  f"kernel {events_note(timed)}, library "
                  f"{events_note(lib_timed)}")
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
    except ValueError as e:
        fail(f"F4: {e}")
    print(f"({time.time() - t0:.1f} s)")
    out["f4"] = {str(S): t for S, t in timings.items()}
    t3, t32 = timings[FLASH_LENS[0]], timings[FLASH_LENS[1]]
    launches = dict(S2=serve_out["s2"]["launches"]["flash_attention"],
                    S3=serve_out["s3"]["flash_launches"],
                    F3=out["f3"]["launches"]["flash_attention"])
    kernel = dict(
        name="flash_attention", route="cuda", source=FA_SRC,
        replaces=FA_REPLACES, launches=launches["S3"],
        launches_by_path=launches, max_abs_err=err32,
        max_abs_err_bf16=err16, limit_used=round(used32, 4),
        limit_used_bf16=round(used16, 4), ms=round(t3["ms"], 5),
        plain_ms=round(t3["plain_ms"], 4), bound_ms=round(t3["bound_ms"], 6),
        bound_by=t3["bound_by"], library_ms=round(t3["library_ms"], 5),
        ms_shape=(f"one InternLM2-1.8B layer's prefill attention, bf16, "
                  f"causal, B=1 S={FLASH_LENS[0]} H={H} KVH={KVH} D={D}"),
        ms_source="CUDA events behind a queued spin (host launch excluded)",
        ms_profiler=round(t3["ms_profiler"], 5),
        library_ms_profiler=round(t3["library_ms_profiler"], 5),
        profiler_events=t3["profiler_events"],
        library_profiler_events=t3["library_profiler_events"],
        plain_ms_source="CUDA events behind a queued spin",
        library=("scaled_dot_product_attention(is_causal=True) on the same "
                 "q and K/V repeated to H heads, [B, H, S, D], repeat "
                 "excluded"),
        at_32768={key: (round(t32[key], 5) if isinstance(t32[key], float)
                        else t32[key])
                  for key in ("ms", "ms_profiler", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "library_ms_profiler",
                              "profiler_events", "library_profiler_events")})
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
