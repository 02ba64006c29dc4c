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
  request), whose every attention layer is one launch of the
  flash-attention kernel
  (``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``:
  the tensor-core kernel in bf16, the FMA kernel in f32), and
  ``Model.prefill_chunked``, one launch a chunk at the chunk's query
  offset.

The MoE, Mamba-hybrid and xLSTM families run the same two attention
kernels at their attention positions (none in the xLSTM); their MoE
dispatch and recurrences are plain torch.  The encoder (HuBERT) runs the
flash kernel at head dim 80 in ``Model.forward(input_embeds=...)``, the
VLM (LLaVA-NeXT) both kernels at 56 query heads over 8 KV heads; training
(``repro_torch.train.Trainer``) runs no kernel: it differentiates the
plain chunked attention, as the JAX package's training does.

Every kernel's launch count is set to 0 just before a path is driven and
read just after it.  Phases, each fatal on failure:

0. contracts — the port's static contract checker
   (``src/repro_torch/analysis/``, loaded as
   ``scripts/check_port_contracts.py`` loads it) runs every pass over this
   checkout before anything is built: one line per finding, a summary
   line, and the run fails on any error finding (or a pass that raises),
   so the card never builds or times a tree that breaks its contracts;
1. build — compile the three kernels with ``nvcc`` at once (one process
   per source) and print what ``-Xptxas -v`` says for the TLB sweep's four
   templates (registers, stack frame, spills), failing where any has a
   local-memory stack frame or spills; print the flash library's SASS
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
   world under both context-switch policies (the switch template); the
   edge batches of ``edge_batches`` (probe orders with pred = -1, pred
   outside kvals, duplicate classes and -1 holes, hits at the last
   position, a lane with t_real = 0, short lanes whose t_real falls
   before a later shootdown, 2- and 3-way L2s beside 8).  The
   plain version issues every step as many small torch operations, about
   10 ms a step on the card, so the Table 4 batch's 163,840 steps would
   take it close to half an hour: at that shape the kernel is held to the
   JAX package's results instead (phase 2);
4. timing with CUDA events (median of 5 after a warm-up; every CUDA-events
   time here is taken behind a ~1 ms spin queued on the stream, so that
   it holds no host launch cost) of the kernel on the phase-2 batch and of
   kernel and plain version on the phase-3 batch; the clock64 cycles each
   lane's block took (min, median, max, and the slowest lane's method and
   mapping); the roofline bound and the chain floor (the longest lane's
   steps times one dependent shared-memory round, measured on the card);
   ``pack_batch`` split by function on the host clock;

W1. the five scenario sections of ``benchmarks/tlb_suite.py`` at its
    defaults, built through the port's scenario registry by this script's
    twins of its ``SweepPlan`` and ``_add_suite``: every workload and
    adversarial scenario at 2^19 pages (``bench_scenarios``), the dynamic
    ones at 2^16 (``bench_dynamic``, the shoot pass), the multi-tenant
    ones at 2^15 under both context-switch policies (one ``run_sweep`` per
    world; the switch template), the nested ones at 2^15 under both
    coherence policies (one per world; the union grids of guest and host
    epochs) and the accelerator ones at 2^19 (Base, |K|=3, Subregion,
    Cache-TLB, Dead-Protect; the victim tier and the refault table), all
    at 120,000 accesses: 20 worlds and 274 cells.  Every world's digests
    (trace, ppn arrays, boundaries) must equal the JAX package's in
    ``tests/data/port_scenario_reference.json`` before any sweep, and the
    roster its cells; then each section runs through
    ``run_sweep(device="cuda", cache=False)``: the TLB kernel's launch
    count must rise by the number of batches, every translation must be
    the live mapping's, hits and walks must add up to the accesses, and
    every cell must equal the fixture's (counters, coverage, ppn digest;
    tolerance 0).  Each section's derived rows (relative misses,
    invalidated entries, stall cycles, cycles per access) are printed as
    its bench function returns them, with its host-clock wall, its
    ``pack_batch`` time, its batches' kernel time (CUDA events behind the
    queued spin) and clock64 cycles per lane (min, median, max, the
    slowest lane); the host's launch of each batch must take less time
    than the spin;
W2. ``standard_suite(device="cuda")`` on the W1 ``kv-churn`` world (18
    runs in one launch) must equal the fixture's JAX ``standard_suite``,
    names included; ``run_method(device="cuda")`` for each accelerator
    kind on ``accel-gather-x1024`` must equal the fixture's W1 cell over
    the whole trace and the port's oracle over its first 4,096 accesses;

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
R.  the robustness harness (``repro_torch.robustness``), run right after
    S2 on its f32 weights; ``run_sweep``'s recovery ladder catches only
    the injected ``BackendFault``, so it can be taken nowhere but in R2's
    two injected runs (a real launch failure raises), and the stats of
    phase 2's, R1's and R3's sweeps must show no rung:
R1. TLB parity faults at bench size (``chaos.parity_sweeps``): the
    ``mt-serve-mix`` and ``nested-vm-mix`` worlds at 2^15 pages and
    60,000 accesses, each with ``make_parity_world(seed=1908,
    n_faults=3)``, Base / COLT / K-aligned psi = 3 under ``par_policy``
    parity and ecc and fault-free: 18 cells, one launch a world; worlds,
    fault schedules and every cell equal to the JAX package's in
    ``tests/data/port_chaos_reference.json``, every translation the live
    mapping's, ecc equal to fault-free bit for bit; the rows' invalidated
    entries and extra walks printed;
R2. the ladder on the card (``chaos.backend_sweeps``): the
    ``mt-serve-mix`` suite with one injected launch failure must recover
    by bisection (bisections >= 1, no oracle fallback) and with a cursed
    cell by the oracle (one fallback), both equal to the clean run bit for
    bit, the kernel launched once more than the clean run for the halves;
R3. sweep-cache corruption (truncate, garbage, schema): 3 entries
    quarantined, results equal;
R4. the chaos bench's serve rows on the card: the reduced InternLM2-1.8B
    in f32, page 8, 256 pages, batch 3, 4 requests of 12 + 5 tokens,
    fault-free and through a crash at step 3, KV corruption at step 2 and
    page loss at step 1: tokens and report counts equal to the JAX
    engine's in the fixture;
R5. InternLM2-1.8B at full width in f32 (S2's weights), S3's first 4
    requests with answers capped at 32, ``EngineConfig(page_size=16,
    num_pages=512, max_batch=3, max_seq=4096)`` (the f32 pool is 1.61 GB):
    fault-free, then a crash at step 20 (a snapshot every 16 steps), KV
    corruption of 2 pages at step 6 and 8 pages drawn for loss at step 3
    (seed 1908; the free ones are retired); the crash row equal to the
    fault-free run bit for bit (tokens and every logits row), the other
    two by S2's rule (tokens equal where the fault-free top-1 leads by
    more than 2e-3, logits within ``LOGIT_ATOL`` while the tokens agree);
    each row's engine wall, the classes K over the run, snapshot save and
    restore seconds and bytes;
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
C1. the flash-attention kernel at a query offset (the later chunks of a
    chunked prefill: q's rows ``off ..``, k and v's first ``off + Sc``)
    against its plain version, every chunk of ``tests/test_kernels.py``'s
    four shapes and of an InternLM2-1.8B layer at 3,072 and 32,704 tokens
    cut in 4, f32 and bf16, with F1's tolerances; ``q_offset=0`` must give
    the default call's bits and every causal chunk the whole call's rows
    bit for bit; the last chunk of the 32,704 (offset 24,528) timed by
    CUDA events behind the queued spin, beside its plain version,
    ``scaled_dot_product_attention`` with an explicit causal mask at the
    offset, and its bound;
C2. ``Model.prefill_chunked`` of F3's 32,704-token prompt in 4 chunks at
    full width (bf16, InternLM2-1.8B) against ``Model.prefill``: the last
    position's top-1 where the top-2 gap exceeds ``DENSE_MARGIN``, every
    logit within ``C2_LOGIT_ATOL``, the KV cache within ``C2_KV_RTOL``;
    96 flash launches;
M1. the reduced ``qwen2-moe-a2.7b``, ``jamba-1.5-large-398b`` and
    ``xlstm-350m`` served on the card in f32 (TF32 off) against the JAX
    engine's ``tests/data/port_family_reference.json`` as S2 is held to its
    fixture, the weights checked against its digests; the flash kernel
    launched once per attention layer and prefill, the paged kernel only
    where the model has attention;
M2. Qwen1.5-MoE-A2.7B at full width (d_model 2048, 60 routed experts
    top-4 plus 4 shared, vocab 151,936) and 6 of its 24 layers
    (``M_LAYERS``: 4.0 B of its 14.3 B parameters), its weights drawn by
    the streaming initialiser into bf16 on the card, S3's first 8 requests
    with answers capped at 32 tokens through S3's engine configuration:
    every request finishes, one flash launch a layer and prefill, a
    paged class k >= 1, coalesced descriptors, one decode step's class
    passes against their plain version, a profile of one decode step,
    peak memory; then a second, untimed engine run with the same tokens
    that records its routings, and every token against the dense-cache
    decode (``dense_check`` of a ``yardstick``: batched as the engine ran,
    f32 softmax weights, the engine's experts replayed);
M3. xLSTM-350M at full width (d_model 1024, sLSTM every 6th) and 6 of
    its 24 layers, in bf16 with M2's requests: no pool, no flash or paged
    launch, every token against the dense-cache decode as in M2; then in f32 (TF32 off)
    through the engine, each request decoded alone by the dense decode,
    every token equal past a 2e-3 margin;
E1. the flash kernel at D = 80 against its plain version (``FLASH_SHAPES``
    at D = 80 and HuBERT-XLarge's layer, 4 x 1,500 frames x 16 heads,
    causal and not, f32 and bf16 as F1), then HuBERT-XLarge at full width
    (48 layers, d_model 1,280, 16 heads of 80, non-causal, vocab 504;
    seeded weights, a bf16 copy): ``Model.forward(input_embeds=...)`` on
    4 x 1,500 frames (30 s of audio at 50 Hz): 48 flash launches, finite
    logits within ``E1_LOGIT_ATOL`` of the same forward through the plain
    chunked attention; the forward's wall, peak memory, and the kernel at
    the layer's shape by CUDA events beside SDPA, its plain version and
    its bound;
T0. the reduced ``internlm2-1.8b`` and ``hubert-xlarge`` trained on the card
    in f32 (TF32 off) by the port's ``Trainer``, ``DataPipeline`` and AdamW,
    4 steps each, losses and grad norms against the JAX run in
    ``tests/data/port_train_reference.json`` (``T0_LOSS_ATOL``,
    ``T0_GNORM_RTOL``), no kernel launched;
T1. HuBERT-XLarge trained at full width and 12 of its 48 layers
    (``T1_LAYERS``): f32 parameters (E1's first 12 layers), bf16
    compute, AdamW, remat full, 8 x 1,024 frames in 2 microbatches, 6
    steps with a checkpoint every 3, under
    ``torch.use_deterministic_algorithms(True)``: straight through, then
    with a ``SimulatedFailure`` at step 4 and a resume from the step-3
    checkpoint, whose losses and grad norms must equal the straight run's
    bit for bit; the step-time median, frames/s, peak memory, the
    checkpoint's save and restore seconds, and a profile of one more step;
D1. InternLM2-1.8B trained at full width and depth (24 layers, d_model
    2,048, vocab 92,544; f32 parameters, bf16 compute, AdamW, remat full)
    through the distributed layer on an NCCL process group of one rank
    (no gloo fallback: NCCL must initialise) under T1's deterministic
    algorithms: 3 steps of 4 x 1,024 tokens by ``Trainer(param_shardings=
    ...)`` on a ``("data", "model")`` (1, 1) mesh under
    ``PARAM_RULES["default"]`` (parameters and AdamW state as DTensors,
    every collective a real NCCL call on the one rank), then the same 3
    steps by the unsharded trainer: losses, grad norms and every parameter
    and state leaf equal bit for bit; the sharded run's checkpoint
    restored into an unsharded trainer and the unsharded run's into a
    sharded one, every leaf equal bit for bit; ``ef_allreduce`` of a 2^20
    f32 gradient equal to the plain quantise-dequantise and its residual
    to the remainder, and ``pipeline_forward`` at one stage equal to the
    block applied in order, bit for bit.  The sharded trainer runs the
    tensor-parallel compute (each parameter gathered over the data axes
    only, the model shard kept: at (1, 1) the whole leaf, every
    tensor-parallel operator the identity); then one bf16
    ``Model.forward`` of 1 x 1,024 tokens through the tensor-parallel
    backbone on the (1, 1) mesh from the final parameters as DTensors: 24
    flash launches, logits equal bit for bit to the unsharded forward's;
    and the flash kernel on each model rank's heads of one InternLM2
    layer (S 3,072, H 16 / KVH 8, D 128, causal, bf16) at tp 2, 4 and 8,
    and of one HuBERT-XLarge layer (4 x 1,500, 16 / 16 heads, D = 80,
    non-causal) at tp 4: q's heads and the KV heads they read passed as
    strided views (no copy), each equal bit for bit to the whole call's
    heads (``D1_HEAD_SLICES``); then the cached passes on the (1, 1)
    mesh against the unsharded ones, bit for bit (``D1_CACHED``, with
    deterministic algorithms off: the mLSTM takes a float cumsum): the
    trained InternLM2-1.8B, xLSTM-350M at full width and depth (24
    layers, seeded) and the reduced Jamba, each ``prefill`` of a 1 x
    1,024 (InternLM2) or 1 x 256 prompt and ``prefill_chunked`` (2
    chunks) under "default" (logits and every cache leaf; one flash
    launch per attention layer and prefill chunk: 24 and 48 for
    InternLM2), then 16 greedy ``decode_step``s under "decode" from the
    prefill's state (tokens, logits, the final state), and the forward of
    the xLSTM and Jamba; each check's seconds; the phase's wall, both
    runs' step medians, the checkpoint's GB and its save and restore
    seconds, peak memory;
V1. LLaVA-NeXT-34B at full width (60 layers, d_model 7,168, 56 / 8 heads,
    d_ff 20,480, vocab 64,000, 2,880 patches; 34.4 B parameters drawn by
    the streaming initialiser into bf16, 68.8 GB), every earlier model
    freed first: one request of 2,880 patch embeddings and 128 text tokens
    through ``Model.prefill(patch_embeds=...)`` (60 flash launches at H 56
    / KVH 8), its logits and cache equal bit for bit to the prefill of the
    same rows as ``input_embeds``, 16 greedy ``decode_step``s (the first
    against the prefill of the prompt and its token); the flash kernel at
    the request's layer shape timed as E1; then S3's first 4 requests
    (text only: the engine takes no patches, as the JAX engine), answers
    capped at 32, through ``ServingEngine``: the paged kernel at G = 7,
    one step's class passes against their plain version and timed as S5,
    every token against the batched dense decode as in M2; init, prefill
    and decode-step times, peak memory;
5. the kernel line (the TLB kernel's ``launches`` are phase 2's, its
   ``launches_by_path`` also W1's and W2's; the attention kernels'
   ``launches_by_path`` also C1's comparisons, C2's, M1-M3's, E1's,
   D1's (the tensor-parallel forward, and the head slices held to the
   whole call) and V1's; the flash line's ``at_q_offset`` C1's timing, ``at_d80`` E1's and
   ``at_llava`` V1's, the paged line's ``at_v1_step`` V1's; R1-R3's TLB
   launches and R4's and R5's attention launches in ``launches_by_path``),
   the script's wall, the card line, and the ``{"ok": true, ...}`` line.

It exits non-zero, printing no result, without a card or outside a
checkout of the repository.  The serving helpers below also run on the
CPU (``tests/test_torch_serve.py`` drives them there).
"""
from __future__ import annotations

import dataclasses
import gc
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
# clock cycles of the spin queued before a CUDA-events timing: about 1.0 ms
# at the H100 SXM's 1,980 MHz clocks.max.sm (PERF.md), longer than the host
# takes to queue a kernel wrapper's launch (0.1-0.2 ms; W1 measures the TLB
# wrapper's and fails where it reaches the spin)
SLEEP_CYCLES = 2_000_000

# ------------------------------------------------ scenario sweeps, W1 + W2
SCEN_REF_JSON = os.path.join(HERE, "tests", "data",
                             "port_scenario_reference.json")
# benchmarks/tlb_suite.py's scenario sections at their defaults: section ->
# (scenario families, page cap under W1_MAX_PAGES; None: no cap of its own)
W1_SECTIONS = {"scenarios": (("workload", "adversarial"), None),
               "dynamic": (("dynamic",), 1 << 16),
               "multitenant": (("multitenant",), 1 << 15),
               "nested": (("nested",), 1 << 15),
               "accelerator": (("accelerator",), None)}
W1_MAX_PAGES, W1_TRACE_LEN = 1 << 19, 120_000
W1_SEEDS = dict(map_seed=0, trace_seed=8)     # tlb_suite.SCENARIO_SEEDS
# W2: standard_suite's world, and the accesses run_method is held to the
# oracle over
W2_WORLD, W2_PREFIX = "kv-churn", 4096

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

# -------------------------------------------------- chunked prefill, C1-C2
# chunks of C1's and C2's chunked prefills (Sarathi-style, as the JAX
# package's tests/test_models.py splits its prompts)
C_CHUNKS = 4
# C1 at InternLM2-1.8B's layer: S3's longest prompt (chunks of 768) and
# F3's (chunks of 8,176)
C1_LENS = (3072, F3_PROMPT)
# C2, chunked vs whole prefill of F3's prompt, bf16: both run the same
# bf16 products; only the flash kernel's f32 sums over a row's keys take
# another tile order, which can move an attention output by one bf16 ulp
# and, through 24 layers of a bf16 residual stream, a logit by a few ulps
# (1/32 at magnitude 4-8).  Logits: within C2_LOGIT_ATOL (DENSE_MARGIN, the
# margin the dense-decode checks allow a token); the KV cache: within
# C2_KV_RTOL * |whole| + C2_KV_ATOL * rms (four bf16 ulps, and 1/32 of the
# cache's rms for values near 0).
C2_LOGIT_ATOL = DENSE_MARGIN
C2_KV_RTOL, C2_KV_ATOL = 2.0 ** -6, 2.0 ** -5

# ------------------------------------------- MoE, hybrid and xLSTM, M1-M3
FAMILY_REF_JSON = os.path.join(HERE, "tests", "data",
                               "port_family_reference.json")
# M2: Qwen1.5-MoE-A2.7B (hf:Qwen/Qwen1.5-MoE-A2.7B) at full width, bf16
# weights; M3: xLSTM-350M (arXiv:2405.04517) at full width, bf16.  Both
# serve S3's first 8 requests with their answers capped (a cut of the
# trace's answer lengths, to keep the phase short)
M2_ARCH, M3_ARCH = "qwen2-moe-a2.7b", "xlstm-350m"
M_REQUESTS, M_ANSWER_CAP = 8, 32
# M2 and M3 run 6 of their 24 layers (a cut of depth, widths kept) so
# that the whole script stays well inside its time limit beside E1-V1 and
# R1-R5
M_LAYERS = 6

# ------------------------------- encoder, VLM and training, E1, T0, T1, V1
TRAIN_REF_JSON = os.path.join(HERE, "tests", "data",
                              "port_train_reference.json")
# HuBERT-XLarge (arXiv:2106.07447) and LLaVA-NeXT-34B
# (hf:llava-hf/llava-v1.6-34b-hf), both at full width
E_ARCH, V_ARCH = "hubert-xlarge", "llava-next-34b"
# E1: 4 clips of 30 s of audio at HuBERT's 50 Hz frame rate
E1_BATCH, E1_FRAMES = 4, 1500
# E1's forward against the same forward with attention by the plain
# chunked attention (which rounds p to bf16 where the kernel keeps f32):
# both bf16, 48 layers apart in the order and rounding of their sums, as
# C2's chunked and whole prefills: within DENSE_MARGIN
E1_LOGIT_ATOL = DENSE_MARGIN
# T0 vs the JAX fixture, f32 on both sides (TF32 off): the same f32
# function with its sums in another order.  AdamW moves a parameter by
# about lr whatever the size of its gradient, so a sum that rounds the
# other way for a near-zero gradient moves the next step's loss: the
# limits are 2e-4 (about 0.2 lr over the 4 steps' updates) on losses and
# on grad norms relative to theirs, where the port on the CPU comes
# within 1.5e-6 and 1.5e-7
T0_LOSS_ATOL, T0_GNORM_RTOL = 2e-4, 2e-4
# T1: 8 clips of 20.48 s (1,024 frames) in 2 microbatches, 6 steps, a
# checkpoint every 3, a failure injected at step 4; 12 of HuBERT-XLarge's
# 48 layers (a cut of depth, widths kept, E1's first 12 layers: D1 trains
# a model at full depth through the same trainer, and the whole script
# must stay inside its time limit with D1 added)
T1_BATCH, T1_FRAMES, T1_MICRO, T1_LAYERS = 8, 1024, 2, 12
T1_STEPS, T1_CKPT_EVERY, T1_FAIL_AT = 6, 3, 4
# V1: LLaVA-NeXT's anyres image (2,880 patch embeddings) and 128 text
# tokens, 16 greedy decode steps; then S3's first 4 requests (answers
# capped at M_ANSWER_CAP) through an engine whose pool holds them at once
# (1,024 pages: 4.0 GB over 60 layers)
V1_TEXT, V1_DECODE, V1_SEED, V1_REQUESTS = 128, 16, 23, 4
V1_ENGINE = dict(page_size=16, num_pages=1024, max_batch=4, max_seq=4096)

# ------------------------------------------- the distributed layer, D1
# InternLM2-1.8B (arXiv:2403.17297) at full width and depth, trained 3
# steps of 4 x 1,024 tokens sharded (a (1, 1) mesh on one NCCL rank: the
# card machine has one card) and unsharded
D_ARCH = "internlm2-1.8b"
D1_BATCH, D1_SEQ, D1_STEPS = 4, 1024, 3
# the EF all-reduce's gradient, and pipeline_forward's microbatches
# [n_micro, Bm, d] through one stage of tanh(x @ w)
D1_EF_N = 1 << 20
D1_PIPE = (8, 4, 2048)
# the tensor-parallel forward's tokens; the flash kernel on each model
# rank's heads: (B, S, H, KVH, D, causal) of one layer, and the tp sizes
D1_FWD_SEQ = 1024
D1_HEAD_SLICES = (((1, 3072, 16, 8, 128, True), (2, 4, 8)),
                  ((E1_BATCH, E1_FRAMES, 16, 16, 80, False), (4,)))
# the cached passes on the (1, 1) mesh against the unsharded ones: (arch,
# reduced, prompt tokens, whether the forward too); each prompt is then
# decoded D1_DECODE greedy steps.  xLSTM-350M (arXiv:2405.04517) at full
# width and depth, seeded weights, a short prompt: its sLSTM runs a step
# at a time
D1_DECODE = 16
D1_CACHED = (("internlm2-1.8b", False, 1024, False),
             ("xlstm-350m", False, 256, True),
             ("jamba-1.5-large-398b", True, 256, True))

# ------------------------------------------------- the chaos rows, R1-R5
CHAOS_REF_JSON = os.path.join(HERE, "tests", "data",
                              "port_chaos_reference.json")
# R1-R3 at benchmarks/chaos.py's defaults: 60,000 accesses, 2^15 pages
R_TRACE_LEN, R_MAX_PAGES = 60_000, 1 << 15
# R5: InternLM2-1.8B at full width in f32 (S2's weights), S3's first 4
# requests with answers capped at M_ANSWER_CAP, an engine of 512 pages of
# 16 (8,192 tokens: the first 3 of the 4 at once) and batch 3
R5_REQUESTS = 4
R5_ENGINE = dict(page_size=16, num_pages=512, max_batch=3, max_seq=4096)
R5_MAX_STEPS = 256
# the crash row snapshots every 16 steps; the others only at step 0
R5_SNAPSHOT_EVERY = 16
# the faults, (engine step, pages): 2 live pages corrupted at step 6; 8
# pages drawn for loss at step 3, of which the free ones are retired.  (Of
# 3 draws, pages 29, 136 and 36, all are owned at step 3 and would be
# skipped; 8 draws add 359 and 371 of the free block 320-383, which the
# fourth request's buddy blocks then have to avoid.)
R5_CRASH, R5_KV, R5_LOSS = 20, (6, 2), (3, 8)
# a token of a faulted row must equal the fault-free run's wherever the
# fault-free top-1 leads its top-2 by more than this (S2's rule)
R5_MARGIN = 2 * LOGIT_ATOL


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str):
    print(f"\n=== {name} ===", flush=True)
    return time.time()


def contracts_phase() -> None:
    """Phase 0: ``scripts/check_port_contracts.py`` run in this process
    over this checkout (the checker loaded as a package of its own,
    stdlib only): one line per finding and a summary line; fails on any
    error finding and on a checker that cannot run (exit code 2)."""
    import importlib.util
    path = os.path.join(HERE, "scripts", "check_port_contracts.py")
    spec = importlib.util.spec_from_file_location("check_port_contracts",
                                                  path)
    script = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(script)
    except OSError as e:
        fail(f"cannot load the contract checker: {e}")
    rc = script.main(["--root", HERE])
    if rc != 0:
        fail(f"the contract checker exited {rc}: the tree breaks the "
             "port's contracts (python scripts/check_port_contracts.py)")


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


def roster(m):
    """The specs of ``benchmarks/tlb_suite.py::_add_suite``'s 12 methods
    over the static mapping ``m`` (Table 4's roster)."""
    return [spec for spec, _, _ in suite_specs(m, ANCHOR_GRID)]


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


def ptxas_functions(report: str) -> dict:
    """Per entry function of an ``-Xptxas -v`` report: registers, stack
    frame, spill stores and loads (bytes) and static shared memory."""
    import re
    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), dict(
                registers=0, stack=0, spill_stores=0, spill_loads=0,
                smem=0))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["smem"] = int(m.group(1))
    return out


#: tlb_sweep_kernel<WITH_SWITCH, GENERAL>: with and without the switch
#: pass, for the compiled lane kinds and for the general step
TLB_TEMPLATES = 4


def check_tlb_ptxas(report: str) -> dict:
    """The TLB kernel's templates from the ptxas report; raises
    ``ValueError`` where one is missing or any uses local memory (a stack
    frame or spills)."""
    funcs = {k: v for k, v in ptxas_functions(report).items()
             if "tlb_sweep_kernel" in k}
    if len(funcs) != TLB_TEMPLATES:
        raise ValueError(f"expected the {TLB_TEMPLATES} tlb_sweep_kernel "
                         f"templates in the ptxas report, found "
                         f"{sorted(funcs)}")
    for name, f in funcs.items():
        if f["stack"] or f["spill_stores"] or f["spill_loads"]:
            raise ValueError(f"{name} uses local memory: {f}")
    return funcs


def chain_floor(lanes, round_cycles: float, sm_mhz: float):
    """The least time a serial chain of the batch could take: the longest
    real lane's steps, one dependent shared-memory round each, at the SM
    clock.  Returns (ms, longest t_real)."""
    import numpy as np
    steps = int(np.asarray(lanes["t_real"]).max())
    return steps * round_cycles / (sm_mhz * 1e3), steps


def lane_spread(cycles, cells, kinds_of, sm_mhz: float) -> dict:
    """Per-lane clock64 cycles of one launch: min, median and max over the
    real lanes, in cycles and in ms at the SM clock, the slowest lane's
    method and mapping, and the mean cycles per access of each method kind
    (``+pred``: with the predictor)."""
    import numpy as np
    c = np.asarray(cycles)[:len(cells)].astype(np.int64)
    j = int(c.argmax())
    ms = lambda x: float(x) / (sm_mhz * 1e3)  # noqa: E731
    per_access = {}
    for cyc, cell in zip(c, cells):
        kind = cell.spec.kind + ("+pred" if cell.spec.use_predictor else "")
        per_access.setdefault(kind, []).append(cyc / cell.trace.shape[0])
    return dict(min_cycles=int(c.min()), median_cycles=float(np.median(c)),
                max_cycles=int(c.max()), min_ms=ms(c.min()),
                median_ms=ms(np.median(c)), max_ms=ms(c.max()),
                slowest_lane=j, slowest_method=cells[j].spec.name,
                slowest_kind=cells[j].spec.kind, slowest_mapping=kinds_of[j],
                pad_lanes_max_cycles=int(np.asarray(cycles)[len(cells):].max())
                if len(cycles) > len(cells) else None,
                cycles_per_access={k: float(np.mean(v))
                                   for k, v in per_access.items()})


#: the packing functions ``pack_breakdown`` times, by module (the host
#: path builds the records with ``_fill_profile`` and ``cluster_bitmap``,
#: the card path their plan rows with ``_plan_row`` and ``_record_plan``)
PACK_PARTS = (("lane_program", "_map_record"), ("lane_program", "_fill_profile"),
              ("lane_program", "_pad_stack"), ("lane_program", "cluster_bitmap"),
              ("lane_program", "_plan_row"), ("lane_program", "_record_plan"),
              ("sweep", "init_batched_state"))


def pack_breakdown(cells, device=None):
    """``pack_batch(cells, device)`` timed by the host clock and split by
    function: the seconds spent in each of ``PACK_PARTS`` (``_pad_stack``
    holds the stacking of the record stacks) and the rest.  Wraps the
    functions for the one call and puts them back.  Returns ``(packed,
    seconds)``."""
    import importlib
    spent, saved = {}, []

    def timed(f, key):
        def g(*a, **k):
            t = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t
        return g
    try:
        for mod_name, name in PACK_PARTS:
            mod = importlib.import_module(f"repro_torch.core.{mod_name}")
            f = getattr(mod, name)
            saved.append((mod, name, f))
            spent[name] = 0.0
            setattr(mod, name, timed(f, name))
        sweep = importlib.import_module("repro_torch.core.sweep")
        t = time.perf_counter()
        packed = sweep.pack_batch(cells, device)
        total = time.perf_counter() - t
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)
    spent["rest"] = total - sum(spent.values())
    spent["total"] = total
    return packed, spent


def records_bound_bytes(plan, P: int) -> int:
    """Bytes the record kernel must move for ``plan``: every fill row
    (``FILL_REC_WIDTH`` int32) and cluster word it writes, pads included,
    and each map record its real rows read, once."""
    import numpy as np
    from repro_torch.core import lane_program as lp
    rows = np.asarray(plan.rows)
    real = rows[:, lp.PLAN_CODE] != lp.REC_CODE["zero"]
    n_maps = np.unique(rows[real, lp.PLAN_MAP]).size
    n_clus = rows.shape[0] - plan.n_fill
    return 4 * (plan.n_fill * P * lp.FILL_REC_WIDTH
                + n_clus * plan.clus_width
                + n_maps * P * lp.MAP_REC_WIDTH)


def records_timing(plan, maps, built) -> dict:
    """The record kernel (``ops.build_records``) on the card at the
    batch's shapes: its time (CUDA events, median of 5), its byte bound
    at ``HBM_BYTES_PER_S``, the plain version's time on the card (median
    of 3), and the plain version's stacks equal to ``built``, the stacks
    the kernel built for the sweep.  Fails where they differ."""
    import torch
    from repro_torch.kernels.tlb_sweep.ops import (build_records,
                                                   build_records_ref)
    ms = cuda_time_ms(lambda: build_records(plan, maps), 5)
    plain_ms = cuda_time_ms(lambda: build_records_ref(plan, maps), 3)
    ref = build_records_ref(plan, maps)
    for k in ("fills", "clus"):
        if built[k].shape != ref[k].shape or not torch.equal(built[k],
                                                             ref[k]):
            fail(f"record kernel: the {k} stack differs from the plain "
                 "version")
    n_bytes = records_bound_bytes(plan, maps.shape[1])
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bytes=n_bytes, of_bound=ms / bound_ms,
                records=plan.n_real, rows=int(plan.rows.shape[0]))


# ---------------------------------------------------------------------------
# Scenario sweeps, W1 and W2 (the roster helpers also run on the CPU in
# the tests)
# ---------------------------------------------------------------------------

class SweepPlan:
    """Twin of ``benchmarks/tlb_suite.py::SweepPlan``: sweep cells tagged
    ``(row, label, group)``.  ``reduce`` keeps one result per row and
    label; in group ``"anchor"`` the one with the fewest walks (the first
    on ties), the Anchor-Static policy of the paper's §4.1."""

    def __init__(self):
        self.cells, self.tags = [], []

    def add(self, spec, mapping, trace, row: str, label: str,
            group: str = "plain") -> None:
        from repro_torch.core.sweep import SweepCell
        self.cells.append(SweepCell(spec, mapping, trace))
        self.tags.append((row, label, group))

    def reduce(self, results) -> dict:
        out: dict = {}
        for (row, label, group), r in zip(self.tags, results):
            cols = out.setdefault(row, {})
            if group == "anchor" and label in cols:
                if r.walks < cols[label].walks:
                    cols[label] = r
            else:
                cols[label] = r
        return out


def suite_specs(k_mapping, anchor_grid, psis=(2, 3, 4), k_hist=None):
    """``benchmarks/tlb_suite.py::_add_suite``'s roster as ``(spec, label,
    group)``: Base, THP, RMM, COLT, Cluster, Anchor over ``anchor_grid``
    (group ``"anchor"``) and |K| = psi Aligned for each psi (theta 1.0
    above psi 2, else 0.9), K from ``k_hist`` or else from the histogram
    of the static mapping ``k_mapping``."""
    from repro_torch.core import baselines as b
    out = [(b.base_spec(), "Base", "plain"), (b.thp_spec(), "THP", "plain"),
           (b.rmm_spec(), "RMM", "plain"), (b.colt_spec(), "COLT", "plain"),
           (b.cluster_spec(), "Cluster", "plain")]
    out += [(b.anchor_spec(d), "Anchor-Static", "anchor")
            for d in anchor_grid]
    for psi in psis:
        theta = 1.0 if psi > 2 else 0.9
        spec = (b.kaligned_for_histogram(k_hist, psi=psi, theta=theta)
                if k_hist is not None
                else b.kaligned_for_mapping(k_mapping, psi=psi, theta=theta))
        out.append((spec, f"|K|={psi}", "plain"))
    return out


def add_suite(plan: SweepPlan, m, tr, row: str, anchor_grid,
              psis=(2, 3, 4), k_mapping=None, k_hist=None,
              transform=None) -> None:
    """Twin of ``benchmarks/tlb_suite.py::_add_suite``: the cells of
    ``suite_specs`` over world ``m`` (static or segmented) and ``tr``, K
    read from ``k_hist`` or ``k_mapping`` (default ``m``); ``transform``
    rewrites every spec."""
    tx = transform if transform is not None else (lambda s: s)
    k_src = k_mapping if k_mapping is not None else m
    for spec, label, group in suite_specs(k_src, anchor_grid, psis, k_hist):
        plan.add(tx(spec), m, tr, row, label, group)


def w1_runs(section: str, max_pages: int = W1_MAX_PAGES,
            trace_len: int = W1_TRACE_LEN):
    """One W1 section's ``run_sweep`` calls as ``[(plan, [(name, data)])]``,
    built as ``benchmarks/tlb_suite.py``'s bench function for the section
    builds its plans (``bench_scenarios`` with ``quick=False``,
    ``bench_dynamic``, ``bench_multitenant``, ``bench_nested``,
    ``bench_accelerator``), through the port's scenario registry."""
    from repro_torch.core import baselines as b
    from repro_torch.scenarios import get_scenario, list_scenarios
    families, cap = W1_SECTIONS[section]
    pages = max_pages if cap is None else min(max_pages, cap)

    def world(name):
        return get_scenario(name).materialize(
            n_pages=pages, trace_len=trace_len, **W1_SEEDS)
    names = [sc.name for fam in families for sc in list_scenarios(fam)]
    runs = []
    if section in ("scenarios", "dynamic", "accelerator"):
        plan, worlds = SweepPlan(), []
        for name in names:
            d = world(name)
            if section == "scenarios":
                add_suite(plan, d.mapping, d.trace, name, ANCHOR_GRID,
                          psis=(2, 3))
            elif section == "dynamic":
                add_suite(plan, d.world, d.trace, name, ANCHOR_GRID,
                          psis=(2, 3), k_mapping=d.mapping)
            else:
                m, tr = d.mapping, d.trace
                plan.add(b.base_spec(), m, tr, name, "Base")
                plan.add(b.kaligned_for_histogram(
                    d.meta["contiguity_histogram"], psi=3, theta=1.0),
                    m, tr, name, "|K|=3")
                plan.add(b.subregion_spec(), m, tr, name, "Subregion")
                plan.add(b.cache_tlb_spec(), m, tr, name, "Cache-TLB")
                plan.add(b.dead_protect_spec(), m, tr, name, "Dead-Protect")
            worlds.append((name, d))
        runs.append((plan, worlds))
    else:
        # one run_sweep per world, so that no lane is padded to another
        # world's segment grid
        psis, field, policies = (
            ((2, 3, 4), "ctx_policy", ("flush", "tag"))
            if section == "multitenant" else
            ((2, 3), "coh_policy", ("shootdown", "hw-coherence")))
        for name in names:
            d = world(name)
            plan = SweepPlan()
            for policy in policies:
                add_suite(plan, d.world, d.trace, f"{name}::{policy}",
                          ANCHOR_GRID, psis=psis,
                          k_hist=d.meta["contiguity_histogram"],
                          transform=lambda s, p=policy: dataclasses.replace(
                              s, **{field: p}))
            runs.append((plan, [(name, d)]))
    return runs


def _sha(a) -> str:
    import numpy as np
    return hashlib.sha256(
        np.ascontiguousarray(a, dtype=np.int64).tobytes()).hexdigest()


def ppn_digest(ppn) -> str:
    """SHA-256 of translated ppns as int32 bytes (the fixtures' digest)."""
    import numpy as np
    return hashlib.sha256(
        np.ascontiguousarray(ppn, dtype=np.int32).tobytes()).hexdigest()


def world_record(name: str, data) -> dict:
    """A materialized world's class, the digests of its trace and of every
    ppn array it holds, and its segment boundaries: the fields of a world
    in ``tests/data/port_scenario_reference.json``."""
    w = data.world
    cls = type(w).__name__
    rec = dict(scenario=name, cls=cls, n_pages=int(data.mapping.n_pages),
               trace_sha256=_sha(data.trace))
    if cls == "DynamicMapping":
        rec.update(ppn_sha256=[_sha(m.ppn) for m in w.epochs],
                   boundaries=list(w.boundaries))
    elif cls == "MultiTenantMapping":
        rec.update(ppn_sha256=[_sha(m.ppn) for m in w.tenants],
                   boundaries=list(w.boundaries),
                   tenant_ids=list(w.tenant_ids), asids=list(w.asids))
    elif cls == "NestedMapping":
        segs = w.plan_segments()
        rec.update(ppn_sha256=[_sha(m.ppn) for g in w.guests
                               for m in g.epochs],
                   host_ppn_sha256=[_sha(m.ppn) for m in w.host.epochs],
                   composed_ppn_sha256=[_sha(s.mapping.ppn) for s in segs],
                   boundaries=[int(s.lo) for s in segs],
                   guest_ids=list(w.guest_ids), asids=list(w.asids))
    else:
        rec.update(ppn_sha256=[_sha(w.ppn)], boundaries=[0])
    return rec


def world_translations(world, trace):
    """The ppn each access of ``trace`` must translate to: that of the
    mapping live at its step (epoch, scheduled tenant or composed view)."""
    import numpy as np
    cls = type(world).__name__
    if cls == "DynamicMapping":
        views = list(zip(world.boundaries, world.epochs))
    elif cls == "MultiTenantMapping":
        views = [(lo, world.tenants[t])
                 for lo, t in zip(world.boundaries, world.tenant_ids)]
    elif cls == "NestedMapping":
        views = [(s.lo, s.mapping) for s in world.plan_segments()]
    elif cls == "ParityWorld":
        return world_translations(world.base, trace)
    else:
        views = [(0, world)]
    trace = np.asarray(trace)
    out = np.empty(trace.shape[0], np.int64)
    ends = [lo for lo, _ in views[1:]] + [trace.shape[0]]
    for (lo, m), hi in zip(views, ends):
        out[lo:hi] = np.asarray(m.ppn)[trace[lo:hi]]
    return out


def section_rows(section: str, cols_by_row: dict) -> list:
    """The rows the section's bench function returns, from its reduced
    results ``{row: {label: SimResult}}``: relative misses (walks / Base
    walks) for every section; invalidated entries on dynamic, multi-tenant
    and nested worlds; translation stall cycles on nested worlds; cycles
    per access on the accelerator worlds."""
    rows = []
    for row, cols in cols_by_row.items():
        name, _, policy = row.partition("::")
        key = dict(scenario=name)
        if policy:
            key["policy"] = policy
        base = cols["Base"].walks
        rel = {k: round(v.walks / max(base, 1), 4) for k, v in cols.items()}
        if section == "scenarios":
            rows.append(dict(key, **rel))
            continue
        rows.append(dict(key, metric="rel_misses", **rel))
        if section in ("dynamic", "multitenant", "nested"):
            rows.append(dict(key, metric="shootdowns",
                             **{k: v.shootdowns for k, v in cols.items()}))
        if section == "nested":
            rows.append(dict(key, metric="stall_cycles",
                             **{k: v.cycles for k, v in cols.items()}))
        if section == "accelerator":
            rows.append(dict(key, metric="cycles_per_access",
                             **{k: round(v.cpi, 3) for k, v in cols.items()}))
    return rows


CELL_FIELDS = ("accesses", "l1_hits", "l2_regular_hits", "l2_coalesced_hits",
               "walks", "aligned_probes", "pred_correct", "cycles",
               "shootdowns")


def check_against_record(r, rec: dict, what: str) -> None:
    """Hold one ``SimResult`` to a fixture record: name, every counter,
    ``coverage_mean`` and the ppn digest, tolerance 0; raises
    ``ValueError`` naming the first field that differs."""
    if r.name != rec["name"]:
        raise ValueError(f"{what}: name {r.name!r}, JAX {rec['name']!r}")
    for f in CELL_FIELDS:
        if getattr(r, f) != rec[f]:
            raise ValueError(f"{what}: {f} = {getattr(r, f)}, JAX {rec[f]}")
    if r.coverage_mean != rec["coverage_mean"]:
        raise ValueError(f"{what}: coverage_mean {r.coverage_mean}, JAX "
                         f"{rec['coverage_mean']}")
    if ppn_digest(r.ppn) != rec["ppn_sha256"]:
        raise ValueError(f"{what}: ppn digest differs from the JAX one")


def w1_roster(max_pages: int = W1_MAX_PAGES, trace_len: int = W1_TRACE_LEN):
    """Every W1 section's runs, ``{section: [(plan, [(name, data)])]}``,
    and the roster as the fixture lists it: ``(section, run, row, label,
    group, spec as a dict)`` per cell, in order."""
    runs = {s: w1_runs(s, max_pages, trace_len) for s in W1_SECTIONS}
    roster_ = [(s, i, row, label, group,
                json.loads(json.dumps(dataclasses.asdict(c.spec))))
               for s, rs in runs.items() for i, (plan, _) in enumerate(rs)
               for c, (row, label, group) in zip(plan.cells, plan.tags)]
    return runs, roster_


def w1_phase(ref: dict, dev, sm_mhz: float) -> dict:
    """W1 on the card: every section built through the port's registry,
    its worlds held to the fixture's digests, its roster to the fixture's
    cells; then each section's ``run_sweep(device="cuda", cache=False)``
    calls, timed on the host clock (ending in a synchronise), with the
    launch count, the translations, hits + walks and every cell held to
    the fixture; then every batch of the section re-launched for CUDA
    events (behind the queued spin) and clock64 cycles per lane.  Raises
    ``ValueError`` on any difference.  Returns the per-section numbers,
    the materialized worlds and the TLB kernel's launches over the
    sweeps."""
    import numpy as np
    import torch
    from repro_torch.core import sweep as sweep_mod
    from repro_torch.kernels.tlb_sweep.ops import as_tensors, prepare_cuda

    t0 = time.time()
    runs, roster_ = w1_roster()
    t_build = time.time() - t0
    worlds = [(s, name, d) for s, rs in runs.items() for _, ws in rs
              for name, d in ws]
    if len(worlds) != len(ref["worlds"]):
        raise ValueError(f"{len(worlds)} worlds, the fixture has "
                         f"{len(ref['worlds'])}")
    for (s, name, d), want in zip(worlds, ref["worlds"]):
        got = dict(section=s, **world_record(name, d))
        for k in want:
            if got.get(k) != want[k]:
                raise ValueError(f"world {s}/{name}: {k} differs from the "
                                 "JAX package's (compared before any sweep)")
    want_roster = [(c["section"], c["run"], c["row"], c["label"], c["group"],
                    c["spec"]) for c in ref["cells"]]
    if roster_ != want_roster:
        raise ValueError("the W1 roster differs from the fixture's cells")
    print(f"built {len(worlds)} worlds and {len(roster_)} cells in "
          f"{t_build:.1f} s; every world's trace, ppn arrays and boundaries "
          "equal the JAX package's (SHA-256)")

    recs = iter(ref["cells"])
    out, launches = {}, 0
    for section, rs in runs.items():
        # pack_batch is wrapped for the section's sweeps to take its host
        # time and keep each packed batch for the timed launches below
        packed = []
        real_pack = sweep_mod.pack_batch

        def timed_pack(sub, device=None):
            t = time.perf_counter()
            p = real_pack(sub, device)
            packed.append((p, time.perf_counter() - t, list(sub)))
            return p
        n_batches = sum(len(sweep_mod.batches_of(plan.cells,
                                                 range(len(plan.cells))))
                        for plan, _ in rs)
        torch.cuda.synchronize()
        reset_counts()
        sweep_mod.pack_batch = timed_pack
        try:
            t1 = time.time()
            results = [sweep_mod.run_sweep(plan.cells, cache=False,
                                           device="cuda").results
                       for plan, _ in rs]
            torch.cuda.synchronize()
            wall = time.time() - t1
        finally:
            sweep_mod.pack_batch = real_pack
        counts = launch_counts()
        if counts["tlb_sweep"] != n_batches:
            raise ValueError(f"{section}: {counts['tlb_sweep']} TLB kernel "
                             f"launches for {n_batches} batches")
        if counts["tlb_records"] != n_batches:
            raise ValueError(f"{section}: {counts['tlb_records']} record "
                             f"kernel launches for {n_batches} batches")
        if counts["paged_attention"] or counts["flash_attention"]:
            raise ValueError(f"{section}: the sweep launched an attention "
                             "kernel")
        launches += counts["tlb_sweep"]

        cols, row_of = {}, {}
        for (plan, ws), res in zip(rs, results):
            want_ppn = {}
            for c, (row, label, _), r in zip(plan.cells, plan.tags, res):
                what = f"{section}/{row}/{label} ({c.spec.name})"
                key = (id(c.mapping), id(c.trace))
                if key not in want_ppn:
                    want_ppn[key] = world_translations(c.mapping, c.trace)
                if not np.array_equal(r.ppn, want_ppn[key]):
                    raise ValueError(f"{what}: a translation is not the "
                                     "world's")
                if (r.l1_hits + r.l2_regular_hits + r.l2_coalesced_hits
                        + r.walks != r.accesses):
                    raise ValueError(f"{what}: hits + walks != accesses")
                check_against_record(r, next(recs), what)
                row_of[id(c)] = row
            for row, c_ in plan.reduce(res).items():
                cols[row] = c_
        rows = section_rows(section, cols)

        # timed launches of the section's batches, after the checks
        t_pack = sum(s for _, s, _ in packed)
        kernel_ms, host_launch_ms, real_cyc, pad_cyc = 0.0, 0.0, [], []
        cells_all, rows_all = [], []
        for (lanes, stacks, st0, sb), _, sub in packed:
            lt, stt, s0t = as_tensors(lanes, stacks, st0, dev)
            launch = prepare_cuda(lt, stt, s0t, sb)
            torch.cuda.synchronize()
            t = time.perf_counter()
            launch()
            host_launch_ms = max(host_launch_ms,
                                 (time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            kernel_ms += cuda_time_ms(launch, 3)
            cyc = launch.cycles.cpu().numpy()
            real_cyc.append(cyc[:len(sub)])
            pad_cyc.append(cyc[len(sub):])
            cells_all += sub
            rows_all += [row_of[id(c)] for c in sub]
            del lt, stt, s0t, launch
        torch.cuda.empty_cache()
        spread = lane_spread(np.concatenate(real_cyc + pad_cyc), cells_all,
                             rows_all, sm_mhz)
        out[section] = dict(
            wall_s=wall, pack_batch_s=t_pack, kernel_ms=kernel_ms,
            batches=n_batches, cells=sum(len(r) for r in results),
            max_host_launch_ms=host_launch_ms, lane_cycles=spread,
            steps=[int(sb[-1]) for (_, _, _, sb), _, _ in packed],
            segments=[len(sb) - 1 for (_, _, _, sb), _, _ in packed],
            rows=rows)
        print(f"{section}: {out[section]['cells']} cells in {n_batches} "
              f"batches (T = {out[section]['steps']}, segments "
              f"{out[section]['segments']}); run_sweep {wall:.3f} s wall, "
              f"pack_batch {t_pack:.3f} s, kernel {kernel_ms:.3f} ms (CUDA "
              f"events behind the queued spin, summed over the batches); "
              f"all cells equal the JAX fixture")
        print(f"  per-lane cycles (clock64): min {spread['min_cycles']}, "
              f"median {spread['median_cycles']:.0f}, max "
              f"{spread['max_cycles']} = {spread['min_ms']:.3f} / "
              f"{spread['median_ms']:.3f} / {spread['max_ms']:.3f} ms at "
              f"{sm_mhz:.0f} MHz; slowest lane {spread['slowest_method']} "
              f"({spread['slowest_kind']}) on {spread['slowest_mapping']}; "
              f"pad lanes at most {spread['pad_lanes_max_cycles']} cycles; "
              f"host launch at most {host_launch_ms:.3f} ms")
        for row in rows:
            print("  " + json.dumps(row))
        if host_launch_ms >= SLEEP_CYCLES / (sm_mhz * 1e3):
            raise ValueError(f"{section}: a launch took the host "
                             f"{host_launch_ms:.3f} ms, longer than the "
                             "spin queued before a timing")
    return dict(sections=out, launches=launches, build_s=t_build,
                worlds={name: d for _, name, d in worlds})


def w2_phase(ref: dict, worlds: dict) -> dict:
    """W2 on the card: ``standard_suite(device="cuda")`` on the W1
    ``kv-churn`` world against the fixture's JAX ``standard_suite``
    (names, counters, coverage, ppn digests), then ``run_method`` on the
    card for each accelerator kind on ``accel-gather-x1024``: the whole
    trace against the fixture's W1 cell, the first ``W2_PREFIX`` accesses
    against the port's own oracle (``run_method_dynamic``).  Raises
    ``ValueError`` on any difference; returns the launches and times."""
    import torch
    from repro_torch.core import baselines as b
    from repro_torch.core.simulator import run_method, run_method_dynamic

    d = worlds[W2_WORLD]
    want = ref["standard_suite"]
    if want["scenario"] != W2_WORLD:
        raise ValueError("the fixture's standard suite ran on another world")
    torch.cuda.synchronize()
    reset_counts()
    t = time.time()
    suite = b.standard_suite(d.mapping, d.trace, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t
    n_suite = launch_counts()["tlb_sweep"]
    if n_suite != 1:
        raise ValueError(f"standard_suite launched the TLB kernel "
                         f"{n_suite} times, not once")
    if len(suite) != len(want["results"]):
        raise ValueError(f"standard_suite gave {len(suite)} results, JAX "
                         f"{len(want['results'])}")
    for r, rec in zip(suite, want["results"]):
        check_against_record(r, rec, f"standard_suite {rec['name']}")
    print(f"standard_suite(device='cuda') on {W2_WORLD}: "
          f"{len(b.ANCHOR_GRID) + 8} runs in one launch, {wall:.3f} s wall; "
          "names, counters, coverage and ppn equal the JAX standard_suite: "
          + ", ".join(f"{r.name} {r.walks}" for r in suite))

    name = "accel-gather-x1024"
    acc = worlds[name]
    cells = {(c["row"], c["label"]): c for c in ref["cells"]
             if c["section"] == "accelerator"}
    reset_counts()
    checked = []
    for spec in (b.subregion_spec(), b.cache_tlb_spec(),
                 b.dead_protect_spec()):
        r = run_method(spec, acc.mapping, acc.trace, device="cuda")
        check_against_record(r, cells[(name, spec.name)],
                             f"run_method {spec.name} on {name}")
        pre = acc.trace[:W2_PREFIX]
        got = run_method(spec, acc.mapping, pre, device="cuda")
        oracle = run_method_dynamic(spec, acc.mapping, pre)
        for f in CELL_FIELDS + ("coverage_mean", "name"):
            if getattr(got, f) != getattr(oracle, f):
                raise ValueError(f"run_method {spec.name}, first "
                                 f"{W2_PREFIX} accesses: {f} = "
                                 f"{getattr(got, f)}, oracle "
                                 f"{getattr(oracle, f)}")
        if not (got.ppn == oracle.ppn).all():
            raise ValueError(f"run_method {spec.name}, first {W2_PREFIX} "
                             "accesses: ppn differs from the oracle's")
        checked.append(spec.name)
    n_method = launch_counts()["tlb_sweep"]
    if n_method != 2 * len(checked):
        raise ValueError(f"run_method launched the TLB kernel {n_method} "
                         f"times for {2 * len(checked)} calls")
    print(f"run_method(device='cuda') on {name} for {', '.join(checked)}: "
          f"the whole trace equals the JAX fixture's cell, the first "
          f"{W2_PREFIX} accesses equal the port's oracle")
    return dict(launches=n_suite + n_method, suite_wall_s=wall,
                suite=[(r.name, r.walks) for r in suite])


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
    """Phases S2 and M1: the port's engine in f32 over the fixture's
    requests (one model's record: its arch, reduced or not, and its
    ``RunConfig``), held to the JAX engine's tokens, logits, classes and
    descriptor counts.  Returns what it measured; raises ``ValueError`` on
    a difference."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Model, RunConfig
    from repro_torch.serve import EngineConfig, ServingEngine
    model = Model(get_config(ref["arch"], reduced=ref.get("reduced", False)),
                  RunConfig(**ref.get("run_config", dict(
                      compute_dtype=ref["compute_dtype"]))))
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


class RouteTape:
    """The MoE routings of an engine run, for M2's dense check: while a
    :func:`yardstick` model holding the tape serves, every decode-time
    MoE FFN (S == 1) records the experts it picks; with ``replay`` set,
    the dense decode gets them back call by call, its gates taken from its
    own probabilities at those experts.  ``flips`` counts the replayed
    rows whose own top-k differed from the recorded one (of
    ``decisions``)."""

    def __init__(self):
        self.ids, self.pos, self.flips, self.decisions = [], 0, 0, 0
        self.replay = False

    def experts(self, cfg, rc, p, h):
        """The MoE FFN of ``h`` [B, 1, d], its routing recorded or
        replayed."""
        import torch
        from repro_torch.models import moe
        probs = moe.router_probs(p, h)
        gates, ids = moe.route(probs, cfg.top_k)
        if not self.replay:
            self.ids.append(ids.clone())
        else:
            want = self.ids[self.pos]
            self.pos += 1
            self.decisions += ids.shape[0]
            self.flips += int((ids.sort(-1).values != want.sort(-1).values)
                              .any(-1).sum())
            gates = torch.gather(probs, -1, want)
            gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
            ids = want
        return moe.moe_experts(cfg, rc, p, h, probs, gates, ids)[0]


def yardstick(model, tape=None):
    """``model`` as M2's and M3's dense check decodes: its
    ``decode_step`` keeps the softmax weights in f32, as the paged kernel
    keeps them (``Model.decode_step`` rounds them to bf16 before ``p @
    v``, as the JAX package does; in an MoE model that alone can move a
    router logit across a tie), and, given a :class:`RouteTape`, every
    decode-time MoE FFN records or replays its routing.  Prefill is the
    model's own."""
    import math
    import torch
    from repro_torch.models import layers as L
    cfg = model.cfg

    def attention_p_f32(q, kc, vc, kv_len):
        B, _, H, D = q.shape
        S, KVH = kc.shape[1], kc.shape[2]
        s = torch.einsum("bcgd,bscd->bcgs",
                         q.reshape(B, KVH, H // KVH, D).float(),
                         kc.float()) * (1.0 / math.sqrt(D))
        live = torch.arange(S, device=q.device)[None, :] < kv_len[:, None]
        p = torch.softmax(torch.where(live[:, None, None, :], s, L.NEG_INF),
                          dim=-1)
        o = torch.einsum("bcgs,bscd->bcgd", p, vc.float())
        return o.reshape(B, 1, H, D).to(q.dtype)

    class Yardstick(type(model)):
        @torch.no_grad()
        def decode_step(self, params, state, tokens, kv_len):
            B = tokens.shape[0]
            kv_len = torch.as_tensor(kv_len, device=tokens.device).long()
            bidx = torch.arange(B, device=tokens.device)

            def attend(i, p, st, h):
                q, k, v = L.attention_qkv(cfg, p, h, kv_len[:, None])
                kc, vc = st["k"][i], st["v"][i]
                kc[bidx, kv_len] = k[:, 0].to(kc.dtype)
                vc[bidx, kv_len] = v[:, 0].to(vc.dtype)
                o = attention_p_f32(q, kc.to(q.dtype), vc.to(q.dtype),
                                    kv_len + 1)
                return o.reshape(B, 1, cfg.q_dim) @ p["wo"]

            x, _ = self._layers(params, self._embed(params, tokens), state,
                                attend)
            return self._head(params, x), state

        def _ffn(self, j, p, x):
            if tape is None or "moe" not in p or x.shape[1] != 1:
                return super()._ffn(j, p, x)
            h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
            return x + tape.experts(cfg, self.rc, p["moe"], h), None

    return Yardstick(cfg, model.rc)


def dense_check(model, params, reqs, device, margin, batched=False):
    """Each request's generated tokens against the dense-cache decode
    (``model.prefill`` + ``model.decode_step``), teacher-forced on the
    engine's own tokens so that one near-tie cannot cascade.  A token may
    differ from the dense argmax only where the dense logits put it within
    ``margin`` of their top-1.

    Each request decodes alone unless ``batched``: then all of them decode
    in one batch, in lockstep, each row continuing its own prefill (the
    engine's batch, where every request was admitted at once), so that the
    dense decode's products have the engine's shapes — bf16 products at
    batch 1 and batch 8 round differently, which a recurrent model's state
    carries from step to step.  ``model`` may be a :func:`yardstick`.
    Returns the counts; raises ``ValueError`` on a token outside the
    margin."""
    params = model.compute_params(params)
    vocab = model.cfg.vocab
    out = dict(checked=0, equal=0, max_gap=0.0)
    for group in ([list(reqs)] if batched else [[r] for r in reqs]):
        for req, rows in zip(group, _dense_rows(model, params, group,
                                                device)):
            gen = req.generated
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
                        f"request {req.req_id}: token {i} is {gen[i]}, the "
                        f"dense decode's is {best}, ahead by {gap:.4g} > "
                        f"{margin}")
    return out


def _dense_rows(model, params, reqs, device):
    """The dense decode's logit row behind every generated token of each of
    ``reqs``: each prompt prefilled alone, then all rows decoded together,
    teacher-forced on the engine's tokens (a row past its last token keeps
    decoding its last one, which is not compared)."""
    import torch
    from repro_torch.models.model import init_decode_state
    B = len(reqs)
    lens = [len(r.prompt) for r in reqs]
    n_gen = [len(r.generated) for r in reqs]
    max_seq = max(S + n for S, n in zip(lens, n_gen))
    state = init_decode_state(model.cfg, B, max_seq, model.cdt, device)
    rows = [[] for _ in reqs]
    for b, req in enumerate(reqs):
        logits, st = model.prefill(
            params, torch.tensor([list(req.prompt)], device=device),
            max_seq=max_seq)
        rows[b].append(logits[0, lens[b] - 1])
        for pos, leaves in st.items():
            for key, val in leaves.items():
                state[pos][key][:, b] = val[:, 0]
        del logits, st
    for i in range(1, max(n_gen)):
        j = [min(i, n - 1) for n in n_gen]          # a finished row idles
        toks = torch.tensor([[req.generated[j[b] - 1 if j[b] else 0]]
                             for b, req in enumerate(reqs)], device=device)
        kv_len = torch.tensor([lens[b] + j[b] - 1 if j[b] else lens[b]
                               for b in range(B)], device=device)
        logits, state = model.decode_step(params, state, toks, kv_len)
        for b in range(B):
            if i < n_gen[b]:
                rows[b].append(logits[b, 0])
    return rows


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


#: the kernels of each L2 flush (by the flush's name: every flush here is
#: one ``Tensor.zero_`` over 64 MB), named once per process: the profiler
#: has lost every event of a flush's profile three times in a row (in
#: F3), and the names do not change
_FLUSH_NAMES: dict = {}


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
    (the flush's single call; one of three calls at 32k tokens; all of a
    flush's calls, three profiles in a row), so the flush is profiled over
    ``reps`` calls until its kernels are named (at most ``tries`` times,
    once per process: :data:`_FLUSH_NAMES`) and a profile short of events
    is taken again, up to ``tries`` times; a kernel still short after that is
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
    flush_names = _FLUSH_NAMES.get(flush.__name__, set())
    for _ in range(0 if flush_names else tries):
        flush_names = set(_kernel_times(flushes))
        if flush_names:
            _FLUSH_NAMES[flush.__name__] = flush_names
            break
    else:
        if not flush_names:
            raise ValueError("the profiler recorded no kernel of the L2 "
                             "flush")

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
    "bf16 D=128 q_off": ..., "f32 D=128": ...}`` (from
    :func:`sass_counts`): the tensor-core kernel (``_wg``: wgmma) is the
    bf16 one, built for offset 0 and, ``q_off``, for a runtime query
    offset; the FMA kernel is the f32 one.
    Raises ``ValueError`` where a bf16 instantiation has no HGMMA, or an
    f32 one has no FFMA or any tensor-core product (TF32)."""
    import re
    mix = {}
    for fn, ops in sass_counts(sass).items():
        m = re.search(r"flash_attention_fwd(_wg)?_kernelI(f)?Li(\d+)E"
                      r"(Lb1E)?", fn)
        if not m:
            continue
        dt = "bf16" if m.group(1) else ("f32" if m.group(2) else None)
        if dt is None:
            raise ValueError(f"unexpected flash instantiation {fn}")
        mix[f"{dt} D={m.group(3)}" + (" q_off" if m.group(4) else "")] = ops
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
                tlb_records=TLB_LAUNCHES.get("tlb_records", 0),
                paged_attention=pa_ops.LAUNCHES["paged_attention"],
                flash_attention=fa_ops.LAUNCHES["flash_attention"])


def flash_bound(B, S, H, KVH, D, elt, causal=True, q_offset=0):
    """Least time the card could take for one forward attention of S query
    rows at positions ``q_offset ..`` over ``q_offset + S`` keys: bytes of
    q, k, v read once and o written once at the HBM rate; operations (a
    multiply-add each for q.k and p.v per head dim, query head and (query,
    key) pair the mask keeps: S q_offset + S(S+1)/2 pairs causal, S
    (q_offset + S) not) at the peak rate of the inputs' type (bf16 tensor
    rate for 2-byte types, the f32 rate otherwise).  Returns (ms, by,
    bytes, flops, bytes_ms, ops_ms)."""
    Skv = q_offset + S
    pairs = S * q_offset + S * (S + 1) // 2 if causal else S * Skv
    flops = 4 * D * B * H * pairs
    n_bytes = elt * B * D * (2 * H * S + 2 * KVH * Skv)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_FLOP_PER_S if elt == 2 else F32_FLOP_PER_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", n_bytes, flops, t_bytes, t_ops)


def flash_inputs(shape, dtype, device, seed=0):
    """q [B, S, H, D] and k, v [B, S, KVH, D], standard normal from a numpy
    seed, in ``dtype`` on ``device`` (a chunk at ``q_offset`` takes q's
    rows ``q_offset ..`` and k, v's first ``q_offset + Sq``)."""
    import numpy as np
    import torch
    B, S, H, KVH, D = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(
        device, dtype) for sh in ((B, S, H, D), (B, S, KVH, D),
                                  (B, S, KVH, D))]


def flash_vs_plain(q, k, v, causal, q_offset=0):
    """The flash-attention kernel against ``flash_attention_ref`` on the same
    card tensors (queries at ``q_offset ..``), and against itself (a second
    call must give the same bits).  Holds every element to ``atol + rtol * |plain|`` with the
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
    got = flash_attention_gqa(q, k, v, causal=causal, q_offset=q_offset)
    again = flash_attention_gqa(q, k, v, causal=causal, q_offset=q_offset)
    want = flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
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
    t_start = time.time()
    # cuBLAS is deterministic only with a fixed workspace, which it reads
    # when it starts (T1 runs with deterministic algorithms on)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
        from repro_torch.kernels.tlb_sweep.ops import (
            round_cycles as tlb_round_cycles)
        from repro_torch.kernels.paged_attention import _build as pa_build
        from repro_torch.kernels.paged_attention import ops as pa_ops
        from repro_torch.kernels.flash_attention import _build as fa_build
    except ImportError as e:
        fail(f"cannot import the port from {HERE}/src ({e}); run this "
             "script from a checkout of the repository")
    if "jax" in sys.modules:
        fail("the port imported jax")
    for ref_file in (REF_JSON, SERVE_REF_JSON, SCEN_REF_JSON,
                     FAMILY_REF_JSON, TRAIN_REF_JSON, CHAOS_REF_JSON):
        if not os.path.exists(ref_file):
            fail(f"missing the JAX reference fixture {ref_file}")
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -------------------------------------------------------- 0. contracts
    t0 = phase("0. contracts (the port's static contract checker)")
    contracts_phase()
    contracts = dict(wall_s=round(time.time() - t0, 3))
    print(f"phase 0 wall {contracts['wall_s']:.3f} s")

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
    try:
        tlb_ptxas = check_tlb_ptxas(_build.ptxas_report())
    except ValueError as e:
        fail(f"TLB kernel ptxas: {e}")
    rec_ptxas = {k: v for k, v in ptxas_functions(
        _build.ptxas_report()).items() if "tlb_records_kernel" in k}
    if len(rec_ptxas) != 1:
        fail(f"expected the tlb_records_kernel in the ptxas report, found "
             f"{sorted(rec_ptxas)}")
    for name, f in sorted({**tlb_ptxas, **rec_ptxas}.items()):
        print(f"  {name}: {f['registers']} registers, {f['stack']} B stack "
              f"frame, {f['spill_stores']}/{f['spill_loads']} B spill "
              f"stores/loads")
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
             for s in roster(m)]
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
    if launches["tlb_records"] != launches["tlb_sweep"] or \
            sweep.stats["records_on_card"] < 1:
        fail("the card path did not build each batch's records on the card "
             f"once ({launches}, stats {sweep.stats})")
    if launches["paged_attention"] or launches["flash_attention"]:
        fail("the sweep launched an attention kernel")
    check_no_rung("phase 2", sweep.stats)
    walks = {}
    for c, r, rc, kind in zip(cells, sweep.results, ref["cells"], kinds_of):
        want = np.asarray(c.mapping.ppn)[c.trace]
        if r.ppn.shape != want.shape or not np.array_equal(r.ppn, want):
            fail(f"{kind}/{r.name}: a translation differs from the mapping")
        if (r.l1_hits + r.l2_regular_hits + r.l2_coalesced_hits + r.walks
                != r.accesses):
            fail(f"{kind}/{r.name}: hits + walks != accesses")
        try:
            check_against_record(r, rc, f"{kind}/{r.name}")
        except ValueError as e:
            fail(str(e))
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
                    for pre in (tr[:PREFIX],) for s in roster(m) + accel]
    dyn_cells, mt_cells = small_worlds(tc, SweepCell, np)
    edges = edge_batches(tc, SweepCell, np)
    max_err = 0
    plain_batch = None
    batches = [(name, pack_batch([cs[i] for i in group]),
                sorted({c.spec.kind for c in cs}))
               for name, cs in (("3a full-footprint prefix", prefix_cells),
                                ("3b dynamic", dyn_cells),
                                ("3c multi-tenant", mt_cells))
               for group in batches_of(cs, range(len(cs)))]
    batches += [(f"3d edge batch {name}", packed, None)
                for name, packed in edges.items()]
    for name, (lanes, stacks, st0, sb), kinds in batches:
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
              f"segments={len(sb) - 1} kinds="
              f"{len(kinds) if kinds else '-'} switch-"
              f"template={needs_switch_pass(lanes)}: equal")
    print(f"kernel == plain on every batch (max abs err {max_err}) in "
          f"{time.time() - t0:.1f} s")

    # -------------------------------------------------------- 4. timing
    t0 = phase("4. timing (CUDA events, median of 5 after a warm-up)")
    # host clock: where run_sweep's wall goes besides the kernel (the card
    # path: the host packs a record plan, the card builds the records)
    (lanes, stacks, st0, sb), pack_s = pack_breakdown(cells, dev)
    t_pack = pack_s["total"]
    t1 = time.time()
    lt, stt, s0t = as_tensors(lanes, stacks, st0, dev)  # builds the records
    torch.cuda.synchronize()
    t_upload = time.time() - t1
    t1 = time.time()
    launch = prepare_cuda(lt, stt, s0t, sb)
    torch.cuda.synchronize()
    t_checks = time.time() - t1
    print(f"host, Table 4 batch: pack_batch {t_pack:.3f} s, upload and "
          f"records {t_upload:.3f} s, launch checks {t_checks:.3f} s "
          f"(run_sweep wall {wall:.3f} s)")
    print("pack_batch by function (host clock, s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in pack_s.items()))
    rec = records_timing(stacks["plan"], stt["maps"], stt)
    print(f"record kernel, Table 4 batch ({rec['records']} records, "
          f"{rec['rows']} rows with pads, P={stt['maps'].shape[1]}): "
          f"{rec['ms']:.4f} ms; bound {rec['bound_ms']:.4f} ms by bytes "
          f"({rec['bytes']} B at {HBM_BYTES_PER_S:.3g} B/s), "
          f"{rec['of_bound']:.2f}x; plain version on the card "
          f"{rec['plain_ms']:.1f} ms (median of 3); equal to the plain "
          "version")
    ms = cuda_time_ms(launch, 5)
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    spread = lane_spread(launch.cycles.cpu().numpy(), cells, kinds_of,
                         sm_mhz)
    round_cyc = tlb_round_cycles(dev)
    floor_ms, floor_steps = chain_floor(lanes, round_cyc, sm_mhz)
    print(f"per-lane cycles (clock64, the timed launch): min "
          f"{spread['min_cycles']}, median {spread['median_cycles']:.0f}, "
          f"max {spread['max_cycles']} = {spread['min_ms']:.3f} / "
          f"{spread['median_ms']:.3f} / {spread['max_ms']:.3f} ms at "
          f"{sm_mhz:.0f} MHz; slowest lane {spread['slowest_lane']}: "
          f"{spread['slowest_method']} ({spread['slowest_kind']}) on the "
          f"{spread['slowest_mapping']} mapping, "
          f"{spread['max_cycles'] / floor_steps:.1f} cycles per access; "
          f"pad lanes at most {spread['pad_lanes_max_cycles']} cycles")
    print("mean cycles per access by method kind: " + ", ".join(
        f"{k} {v:.1f}" for k, v in spread["cycles_per_access"].items()))
    print(f"chain floor: {floor_steps} steps x {round_cyc:.2f} cycles (one "
          f"dependent shared-memory load -> compare -> store round, "
          f"tlb_round_kernel, clock64 over 65,536 rounds on one thread) at "
          f"{sm_mhz:.0f} MHz = {floor_ms:.4f} ms")
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
        ms_on_plain_shape=round(ms_prefix, 4),
        chain_floor_ms=round(floor_ms, 4))
    tlb_out = dict(run_sweep_wall_s=wall,
                   bound=dict(bytes=n_bytes, bytes_ms=t_bytes,
                              int32_ops=n_ops, ops_ms=t_ops,
                              int32_ops_per_s=ops_per_s),
                   chain_floor=dict(ms=floor_ms, steps=floor_steps,
                                    round_cycles=round_cyc,
                                    sm_mhz=sm_mhz),
                   lane_cycles=spread,
                   host_s=dict(pack_batch=t_pack, upload=t_upload,
                               launch_checks=t_checks),
                   records=rec,
                   pack_batch_s=pack_s,
                   ptxas=tlb_ptxas)
    del (sweep, cells, worlds, lanes, stacks, st0, lt, stt, s0t, launch,
         plain_batch, pl, ps, p0, prefix_cells, dyn_cells, mt_cells)
    torch.cuda.empty_cache()

    # --------------------------------- W1. scenario sweeps at bench size
    t0 = phase("W1. the scenario sections of benchmarks/tlb_suite.py at "
               "bench size through the TLB kernel, vs the JAX fixture")
    scen_ref = json.load(open(SCEN_REF_JSON))
    try:
        w1 = w1_phase(scen_ref, dev, sm_mhz)
    except ValueError as e:
        fail(f"W1: {e}")
    print(f"({time.time() - t0:.1f} s in all)")

    # ------------------------------ W2. the per-call entry points, card
    t0 = phase("W2. standard_suite and run_method on the card")
    try:
        w2 = w2_phase(scen_ref, w1.pop("worlds"))
    except ValueError as e:
        fail(f"W2: {e}")
    print(f"({time.time() - t0:.1f} s in all)")
    print(f"card: {card}")
    from repro_torch.scenarios import clear_materialized_cache
    clear_materialized_cache()
    tlb["launches_by_path"] = dict(table4=launches["tlb_sweep"],
                                   w1=w1["launches"], w2=w2["launches"])
    tlb_out["w1"], tlb_out["w2"] = w1, w2

    pa, serve_out, params = serve_phases(torch, np, dev, pa_build, pa_ops)
    fa, flash_out = flash_phases(torch, np, dev, params, fa_build,
                                 serve_out)
    chunk_out = chunked_phases(torch, np, dev, params)
    del params
    torch.cuda.empty_cache()
    fam_out = family_phases(torch, np, dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
    ev_out = encoder_vlm_phases(torch, np, dev, flush)
    e1, v1 = ev_out["e1"], ev_out["v1"]
    fa["sass"] = sass_mix
    pa["at_f3_step"] = flash_out["f3"]["paged_layer"]["line"]
    m_launches = {tag: {k: sum(r["launches"][k]
                               for r in fam_out["m1"].values())
                        if tag == "M1" else fam_out[tag.lower()]["launches"][k]
                        for k in ("flash_attention", "paged_attention")}
                  for tag in ("M1", "M2", "M3")}
    fa["launches_by_path"].update(
        C1_vs_plain=chunk_out["c1"]["launches"],
        C2=chunk_out["c2"]["chunked_flash_launches"],
        **{tag: n["flash_attention"] for tag, n in m_launches.items()},
        E1_vs_plain=e1["vs_plain_launches"],
        E1=e1["launches"]["flash_attention"],
        D1_tensor_parallel_forward=ev_out["d1"]["tensor_parallel"][
            "forward"]["flash_launches"],
        D1_head_slices_vs_whole=sum(
            r["launches"] for r in ev_out["d1"]["tensor_parallel"][
                "head_slices"]),
        D1_cached_prefills=sum(
            sum(r["flash_launches"].values())
            for r in ev_out["d1"]["tensor_parallel"]["cached"]),
        V1_prefill=v1["prefill_launches"]["flash_attention"],
        V1_engine=v1["engine"]["launches"]["flash_attention"])
    pa["launches_by_path"] = dict(
        S3=pa["launches"], F3=flash_out["f3"]["launches"]["paged_attention"],
        **{tag: n["paged_attention"] for tag, n in m_launches.items()},
        V1=v1["engine"]["launches"]["paged_attention"])
    pa["at_v1_step"] = v1["paged_layer"]["line"]
    r_launches = serve_out["chaos"]["launches"]
    tlb["launches_by_path"].update(
        {tag: r_launches[tag]["tlb_sweep"] for tag in ("R1", "R2", "R3")})
    for line, key in ((pa, "paged_attention"), (fa, "flash_attention")):
        line["launches_by_path"].update(
            {tag: r_launches[tag][key] for tag in ("R4", "R5")})
    for key, t, errs in (("at_d80", e1["layer_timing"], e1["vs_plain"]),
                         ("at_llava", v1["flash_layer"], None)):
        fa[key] = dict(shape=t["shape"], ms=round(t["ms"], 5),
                       plain_ms=round(t["plain_ms"], 4),
                       bound_ms=round(t["bound_ms"], 6),
                       bound_by=t["bound_by"],
                       library_ms=round(t["library_ms"], 5))
        if errs:
            fa[key]["max_abs_err"] = max(
                r["max_abs_err"] for k, r in errs.items() if "float32" in k)
            fa[key]["max_abs_err_bf16"] = max(
                r["max_abs_err"] for k, r in errs.items() if "bfloat16" in k)
    t = chunk_out["c1"]["timing"]
    fa["at_q_offset"] = {key: (round(t[key], 5) if isinstance(t[key], float)
                               else t[key])
                         for key in ("q_offset", "Sq", "Skv", "ms",
                                     "ms_profiler", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms",
                                     "profiler_events")}
    fa["at_q_offset"]["max_abs_err"] = max(
        e["max_abs_err"] for e in chunk_out["c1"]["errs"].values())

    # ----------------------------------------------------------- 5. report
    phase("5. report")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, contracts=contracts,
                       kernels=[tlb, pa, fa], tlb_sweep=tlb_out,
                       serving=serve_out, prefill=flash_out,
                       chunked_prefill=chunk_out, families=fam_out,
                       encoder_vlm_training=ev_out,
                       flash_sass=sass_mix), f, indent=1, default=float)
    print(f"chip_smoke wall {time.time() - t_start:.1f} s (the kernels' "
          "build included)")
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
    # phase R runs here, on S2's f32 weights
    out["chaos"] = chaos_phases(torch, np, dev, model32, params)

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


# ---------------------------------------------------------------------------
# Chunked prefill (C1, C2) and the MoE, hybrid and xLSTM families (M1-M3)
# ---------------------------------------------------------------------------

def chunk_of(q, k, v, n_chunks, ci):
    """Chunk ``ci`` of ``n_chunks`` of a whole prefill's attention inputs:
    q's rows ``off .. off + Sc`` and k, v's first ``off + Sc`` rows, with
    ``off = ci * Sc`` (views, no copies).  Returns (q, k, v, off)."""
    Sc = q.shape[1] // n_chunks
    off = ci * Sc
    return q[:, off:off + Sc], k[:, :off + Sc], v[:, :off + Sc], off


def chunked_vs_plain(q, k, v, causal, n_chunks):
    """Every chunk of a whole prefill's attention (:func:`chunk_of`) through
    the kernel at its query offset against the plain version
    (:func:`flash_vs_plain`), and, causal, the chunks' rows against the
    whole call's (kernel at offset 0): a row walks the same key tiles in
    the same order either way, the tiles it walks past its diagonal being
    wholly masked, which leaves its state's bits as they were (``alpha =
    exp(0) = 1``, weights ``exp(-1e30 - m) = 0``), so they must be equal
    bit for bit.  Returns ``{"chunks": [flash_vs_plain results],
    "max_abs_err", "limit_used", "bits_equal_whole": [bool per chunk, or
    None non-causal]}``; raises ``ValueError`` past a limit, where a causal
    chunk's bits differ from the whole call's, or where the kernel's
    explicit ``q_offset=0`` gives other bits than its default call."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    whole = flash_attention_gqa(q, k, v, causal=causal)
    if not torch.equal(whole, flash_attention_gqa(q, k, v, causal=causal,
                                                  q_offset=0)):
        raise ValueError("q_offset=0 gave other bits than the default call")
    res = dict(chunks=[], bits_equal_whole=[])
    for ci in range(n_chunks):
        qc, kc, vc, off = chunk_of(q, k, v, n_chunks, ci)
        res["chunks"].append(flash_vs_plain(qc, kc, vc, causal, off))
        got = flash_attention_gqa(qc, kc, vc, causal=causal, q_offset=off)
        same = bool(torch.equal(got, whole[:, off:off + qc.shape[1]]))
        if causal and not same:
            raise ValueError(f"chunk {ci} (q_offset {off}): other bits than "
                             "the whole call's rows")
        res["bits_equal_whole"].append(same if causal else None)
    res["max_abs_err"] = max(c["max_abs_err"] for c in res["chunks"])
    res["limit_used"] = max(c["limit_used"] for c in res["chunks"])
    return res


def prefill_chunked_vs_whole(model, params, toks, n_chunks, block=1024):
    """``Model.prefill_chunked`` against ``Model.prefill`` on the same
    tokens (phase C2): the last position's top-1 equal wherever the whole
    prefill's top-2 gap exceeds ``DENSE_MARGIN``; every logit within
    ``C2_LOGIT_ATOL``; the KV cache's filled prefix within ``C2_KV_RTOL *
    |whole| + C2_KV_ATOL * rms(whole)``, compared ``block`` positions at a
    time.  Returns the errors, walls and flash launches of both passes;
    raises ``ValueError`` past a limit."""
    import torch
    out = {}
    runs = {}
    for name, fn in (("whole", lambda: model.prefill(params, toks)),
                     ("chunked", lambda: model.prefill_chunked(
                         params, toks, n_chunks=n_chunks))):
        if toks.device.type == "cuda":
            torch.cuda.synchronize()
        n0 = launch_counts()["flash_attention"]
        t0 = time.perf_counter()
        runs[name] = fn()
        if toks.device.type == "cuda":
            torch.cuda.synchronize()
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"{name}_flash_launches"] = (launch_counts()["flash_attention"]
                                         - n0)
    (lw, sw), (lc, sc) = runs["whole"], runs["chunked"]
    S, vocab = toks.shape[1], model.cfg.vocab
    row_w, row_c = lw[0, -1, :vocab].float(), lc[0, -1, :vocab].float()
    top2 = row_w.topk(2).values
    gap = float(top2[0] - top2[1])
    out["last_top1_gap"] = gap
    out["last_top1_equal"] = bool(row_w.argmax() == row_c.argmax())
    if gap > DENSE_MARGIN and not out["last_top1_equal"]:
        raise ValueError(f"last position: top-1 {int(row_c.argmax())}, the "
                         f"whole prefill's {int(row_w.argmax())} leads by "
                         f"{gap:.4g} > {DENSE_MARGIN}")
    err = 0.0
    for r0 in range(0, S, block):
        err = max(err, float((lc[0, r0:r0 + block, :vocab].float()
                              - lw[0, r0:r0 + block, :vocab].float())
                             .abs().max()))
    out["logits_max_abs_err"] = err
    if err > C2_LOGIT_ATOL:
        raise ValueError(f"logits differ from the whole prefill's by "
                         f"{err:.4g} > {C2_LOGIT_ATOL}")
    used, kv_err = 0.0, 0.0
    for pos, st in sw.items():
        for key, whole in st.items():
            for i in range(whole.shape[0]):
                w = whole[i, :, :S].float()
                d = (sc[pos][key][i, :, :S].float() - w).abs()
                rms = float(w.square().mean().sqrt())
                kv_err = max(kv_err, float(d.max()))
                used = max(used, float((d / (C2_KV_RTOL * w.abs()
                                             + C2_KV_ATOL * rms)).max()))
    out["kv_max_abs_err"], out["kv_limit_used"] = kv_err, used
    if used > 1:
        raise ValueError(f"the KV cache differs from the whole prefill's by "
                         f"{kv_err:.4g}, {used:.3g} of its limit")
    return out


def m_config(arch):
    """M2's and M3's config: the published one at ``M_LAYERS`` layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=M_LAYERS)


def family_requests(vocab):
    """M2's and M3's requests: S3's first ``M_REQUESTS``, answers capped at
    ``M_ANSWER_CAP`` tokens."""
    return [(p, min(n, M_ANSWER_CAP))
            for p, n in s3_requests(vocab)[:M_REQUESTS]]


def chunked_phases(torch, np, dev, params):
    """Phases C1 and C2 (chunked prefill; ``params``: InternLM2-1.8B's bf16
    weights on the card); returns the numbers for ``chip_smoke.json`` and
    the flash line's additions."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_gqa,
                                                     flash_attention_ref)
    from repro_torch.models import Model, RunConfig
    out = {}
    model = Model(get_config(SERVE_ARCH), RunConfig())
    cfg = model.cfg
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    # ------------------------------- C1. the q-offset kernel vs plain
    t0 = phase(f"C1. flash-attention kernel at a query offset (chunked "
               f"prefill, {C_CHUNKS} chunks) vs plain version on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [(f"test_kernels{i}", shape[:5], shape[5], dt)
             for i, shape in enumerate(FLASH_SHAPES)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(f"internlm2_S{S}", (1, S, H, KVH, D), True, dt)
              for S in C1_LENS for dt in (torch.float32, torch.bfloat16)]
    errs = {}
    reset_counts()
    try:
        for name, shape, causal, dt in cases:
            q, k, v = flash_inputs(shape, dt, dev)
            t1 = time.time()
            errs[f"{name}_{str(dt)[6:]}"] = e = chunked_vs_plain(
                q, k, v, causal, C_CHUNKS)
            print(f"  {name} {str(dt)[6:]} {shape} causal={causal}, "
                  f"{C_CHUNKS} chunks of {shape[1] // C_CHUNKS} (last "
                  f"q_offset {(C_CHUNKS - 1) * (shape[1] // C_CHUNKS)}): max "
                  f"abs err {e['max_abs_err']:.3g}, "
                  f"{100 * e['limit_used']:.1f} % of the tighter limit; "
                  f"chunk rows == whole call's bit for bit "
                  f"{e['bits_equal_whole']} ({time.time() - t1:.1f} s)")
            del q, k, v
    except ValueError as e:
        fail(f"C1 {name} {dt}: {e}")
    c1_launches = launch_counts()["flash_attention"]
    err32, err16 = (max(e["max_abs_err"] for n, e in errs.items()
                        if n.endswith(dt)) for dt in ("float32", "bfloat16"))
    used16 = max(e["limit_used"] for n, e in errs.items()
                 if n.endswith("bfloat16"))
    print(f"kernel == plain version at every offset: max abs err "
          f"{err32:.3g} (f32), {err16:.3g} (bf16, {100 * used16:.1f} % of "
          f"the one-ulp limit); causal chunks == the whole call's rows and "
          f"q_offset=0 == the default call, bit for bit; {c1_launches} "
          "kernel launches (comparisons)")
    # the last chunk of F3's prompt, timed (bf16, causal)
    S = C1_LENS[1]
    q, k, v = flash_inputs((1, S, H, KVH, D), torch.bfloat16, dev, seed=1)
    qc, kc, vc, off = chunk_of(q, k, v, C_CHUNKS, C_CHUNKS - 1)
    Sq = qc.shape[1]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
    run = lambda: flash_attention_gqa(qc, kc, vc, causal=True,  # noqa: E731
                                      q_offset=off)
    try:
        timed = device_ms(run, 5, flush, "flash_attention_fwd",
                          "flash_attention")
    except ValueError as e:
        fail(f"C1 timing: {e}")
    ms = cuda_time_ms(run, 10, flush)
    plain = cuda_time_ms(lambda: flash_attention_ref(
        qc, kc, vc, causal=True, q_offset=off), 2, flush)
    # the library yardstick on [B, H, S, D], K/V repeated to H heads and an
    # explicit mask (is_causal aligns the diagonal to the top left)
    qt = qc.transpose(1, 2).contiguous()
    kt = kc.repeat_interleave(H // KVH, 2).transpose(1, 2).contiguous()
    vt = vc.repeat_interleave(H // KVH, 2).transpose(1, 2).contiguous()
    mask = ((off + torch.arange(Sq, device=dev))[:, None]
            >= torch.arange(off + Sq, device=dev)[None, :])

    def sdpa():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask)
    lib = cuda_time_ms(sdpa, 10, flush)
    lib_err = float((sdpa().transpose(1, 2).float() - run().float()).abs()
                    .max())
    b_ms, b_by, b_bytes, b_flops, b_tb, b_to = flash_bound(
        1, Sq, H, KVH, D, 2, q_offset=off)
    c1_time = dict(
        q_offset=off, Sq=Sq, Skv=off + Sq, ms=ms, ms_profiler=timed["ms"],
        profiler_events=events_note(timed), plain_ms=plain, library_ms=lib,
        library_vs_kernel_max_abs_err=lib_err, bound_ms=b_ms, bound_by=b_by,
        bytes=b_bytes, flops=b_flops, tflops=b_flops / (ms * 1e-3) / 1e12,
        library=("scaled_dot_product_attention(attn_mask=causal at the "
                 "offset) on the same q and K/V repeated to H heads, [B, H, "
                 "S, D], repeat excluded"))
    print(f"last chunk (Sq {Sq}, q_offset {off}, Skv {off + Sq}, bf16): "
          f"kernel {ms:.5f} ms CUDA events behind a queued spin "
          f"({c1_time['tflops']:.2f} Tflop/s), {timed['ms']:.5f} ms device "
          f"time (profiler, events {events_note(timed)}); plain version "
          f"{plain:.3f} ms; SDPA with the explicit mask {lib:.5f} ms (vs the "
          f"kernel max abs err {lib_err:.3g}); bound {b_ms:.5f} ms by {b_by} "
          f"({b_flops:.4g} flop, {b_bytes} B) ({time.time() - t0:.1f} s in "
          "all)")
    out["c1"] = dict(errs=errs, launches=c1_launches, timing=c1_time)
    del q, k, v, qc, kc, vc, qt, kt, vt, mask
    torch.cuda.empty_cache()

    # ------------------------- C2. prefill_chunked at full width
    t0 = phase(f"C2. Model.prefill_chunked at full width, bf16: "
               f"InternLM2-1.8B, F3's {F3_PROMPT}-token prompt in "
               f"{C_CHUNKS} chunks, vs Model.prefill")
    rng = np.random.default_rng(F3_SEED)
    toks = torch.tensor([[int(t) for t in rng.integers(0, cfg.vocab,
                                                       F3_PROMPT)]],
                        device=dev)
    reset_counts()
    try:
        c2 = prefill_chunked_vs_whole(model, params, toks, C_CHUNKS)
    except ValueError as e:
        fail(f"C2: {e}")
    want = cfg.n_layers * C_CHUNKS
    if c2["chunked_flash_launches"] != want or \
            c2["whole_flash_launches"] != cfg.n_layers:
        fail(f"C2: the chunked prefill launched the flash kernel "
             f"{c2['chunked_flash_launches']} times (want {want}), the "
             f"whole one {c2['whole_flash_launches']}")
    print(f"prefill_chunked {c2['chunked_s']:.3f} s ({want} flash "
          f"launches), prefill {c2['whole_s']:.3f} s; last position top-1 "
          f"equal {c2['last_top1_equal']} (whole top-2 gap "
          f"{c2['last_top1_gap']:.4g}); logits max abs err "
          f"{c2['logits_max_abs_err']:.4g} <= {C2_LOGIT_ATOL}; KV cache max "
          f"abs err {c2['kv_max_abs_err']:.4g} "
          f"({100 * c2['kv_limit_used']:.1f} % of its limit) "
          f"({time.time() - t0:.1f} s in all)")
    out["c2"] = c2
    del toks
    torch.cuda.empty_cache()
    return out


def family_phases(torch, np, dev):
    """Phases M1-M3 (the MoE, hybrid and xLSTM families through the
    engine); returns the numbers for ``chip_smoke.json``."""
    return dict(m1=m1_phase(torch, dev), m2=m2_phase(torch, np, dev),
                m3=m3_phase(torch, np, dev))


def m3_phase(torch, np, dev):
    """M3: xLSTM-350M at full width through the engine, no attention; then
    the f32 witness."""
    from repro_torch.models import Model, RunConfig
    t0 = phase(f"M3. xLSTM-350M at full width, bf16: S3's first "
               f"{M_REQUESTS} requests, answers capped at {M_ANSWER_CAP} "
               "tokens (no attention position)")
    model = Model(m_config(M3_ARCH), RunConfig(param_dtype="bfloat16"))
    free_earlier_phases(torch)
    params = model.init_on_device(0, dev)
    m3 = serve_family(torch, np, dev, model, params, "M3")
    eng = m3.pop("engine")
    m3.pop("probe")
    if m3["launches"]["flash_attention"] or m3["launches"]["paged_attention"]:
        fail(f"M3: a model with no attention launched {m3['launches']}")
    if any("pool_k" in st for st in eng.state.values()):
        fail("M3: the engine holds a KV pool for a model with no attention")
    m3["dense_check"] = batched_dense_check(
        dev, model, params, [eng.requests[i] for i in range(M_REQUESTS)],
        "M3")
    m3["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del eng, params
    m3["f32_witness"] = m3_f32_witness(torch, np, dev)
    print(f"no flash or paged launch, no pool; peak device memory "
          f"{m3['peak_memory_gb']:.2f} GB in bf16 ({time.time() - t0:.1f} s "
          "in all)")
    torch.cuda.empty_cache()
    return m3


def m3_f32_witness(torch, np, dev):
    """M3's check with nothing batched: xLSTM-350M at full width in f32
    (TF32 off) through the same engine and requests, each request then
    decoded alone by the dense decode, every token equal wherever the
    dense top-2 gap exceeds ``2 * LOGIT_ATOL`` (f32 rounding at batch 1
    and 8 moves a logit by far less)."""
    from repro_torch.models import Model, RunConfig
    from repro_torch.serve import EngineConfig, ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    model = Model(m_config(M3_ARCH), RunConfig(compute_dtype="float32"))
    params = model.init_on_device(0, dev)
    eng = ServingEngine(model, params, EngineConfig(**S3_ENGINE), device=dev)
    for p, n_new in family_requests(model.cfg.vocab):
        eng.add_request(p, max_new_tokens=n_new)
    torch.cuda.synchronize()
    t1 = time.time()
    eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.time() - t1
    reqs = [eng.requests[i] for i in range(M_REQUESTS)]
    try:
        dc = dense_check(model, eng.params, reqs, dev, 2 * LOGIT_ATOL)
    except ValueError as e:
        fail(f"M3 f32 vs the dense decode, each request alone: {e}")
    dc["engine_wall_s"] = wall
    print(f"f32 witness (weights {model.n_params() * 4 / 1e9:.2f} GB, TF32 "
          f"off): engine {wall:.2f} s; vs the dense-cache decode_step, "
          f"each request alone, teacher-forced: {dc['equal']} of "
          f"{dc['checked']} tokens equal, the rest within "
          f"{2 * LOGIT_ATOL} (largest lead {dc['max_gap']:.4g})")
    del eng, params
    return dc


def free_earlier_phases(torch):
    """Collect what earlier phases left (an engine and its probe refer to
    each other, so only the cycle collector frees their pools), return it
    to the card and restart the peak-memory count; prints what stays."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"device memory held before the phase: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")


def m1_phase(torch, dev):
    """M1: the reduced families in f32 against the JAX engine's fixture."""
    from repro_torch.configs import get_config
    t0 = phase("M1. qwen2-moe, jamba and xlstm (reduced), f32, vs the JAX "
               "engine")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = json.load(open(FAMILY_REF_JSON))
    out = {}
    for arch, rec in ref["models"].items():
        cfg = get_config(arch, reduced=True)
        reset_counts()
        try:
            res = serve_against_fixture(rec, dev)
            torch.cuda.synchronize()
        except ValueError as e:
            fail(f"M1 {arch}: {e}")
        res.pop("params")
        res["launches"] = counts = launch_counts()
        n_attn = cfg.n_attn_layers
        if (counts["flash_attention"] != n_attn * res["prefills"]
                or (counts["paged_attention"] > 0) != (n_attn > 0)
                or counts["tlb_sweep"]):
            fail(f"M1 {arch}: {res['prefills']} prefills and the decode "
                 f"steps launched {counts}; want {n_attn} flash launches a "
                 f"prefill and paged launches iff the model has attention")
        print(f"{arch}: tokens {res['generated']} == JAX "
              f"({res['tokens_checked']} of {res['tokens_total']} past the "
              f"margin), logits max abs err {res['max_abs_err']:.3g} <= "
              f"{LOGIT_ATOL}, K={res['K']}, descriptor reduction "
              f"{res['descriptor_reduction']:.4f} == JAX; launches {counts}")
        out[arch] = res
    print(f"({time.time() - t0:.1f} s in all)")
    return out


def m2_phase(torch, np, dev):
    """M2: Qwen1.5-MoE-A2.7B at full width through the engine."""
    from repro_torch.models import Model, RunConfig
    from repro_torch.serve import EngineConfig, ServingEngine
    t0 = phase("M2. Qwen1.5-MoE-A2.7B at full width, bf16 weights: S3's "
               f"first {M_REQUESTS} requests, answers capped at "
               f"{M_ANSWER_CAP} tokens")
    model = Model(m_config(M2_ARCH), RunConfig(param_dtype="bfloat16"))
    cfg = model.cfg
    free_earlier_phases(torch)
    t1 = time.time()
    params = model.init_on_device(0, dev)
    torch.cuda.synchronize()
    t_init = time.time() - t1
    print(f"{model.n_params():,} parameters drawn slice by slice and stored "
          f"in bf16 on the card in {t_init:.1f} s "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB)")
    m2 = serve_family(torch, np, dev, model, params, "M2")
    m2["init_s"] = t_init
    if m2["launches"]["flash_attention"] != cfg.n_layers * m2["prefills"]:
        fail(f"M2: {m2['prefills']} prefills launched the flash kernel "
             f"{m2['launches']['flash_attention']} times")
    by_class = m2["launches_by_class"]
    if m2["launches"]["paged_attention"] < 1 or not any(
            int(k) >= 1 and n > 0 for k, n in by_class.items()):
        fail("M2: the paged kernel did not run a class k >= 1")
    if not m2["descriptor_reduction"] > 0:
        fail("M2: no descriptor was coalesced")
    eng, probe = m2.pop("engine"), m2.pop("probe")
    step = max(probe.steps, key=lambda s: (int((s["lens"] > 0).sum()),
                                           int(s["lens"].sum())))
    q = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (S3_ENGINE["max_batch"], cfg.n_heads, cfg.head_dim)).astype(
            np.float32)).to(dev, torch.bfloat16)
    try:
        m2["class_passes_vs_plain"] = kernel_vs_plain(
            q, eng.state["pos0"]["pool_k"][0], eng.state["pos0"]["pool_v"][0],
            step["tables"], (step["lens"] + 1).astype(np.int32), step["K"],
            S3_ENGINE["page_size"])
        m2["profile_decode_step"] = prof = profile_decode_step(
            model, eng, step, dev)
    except ValueError as e:
        fail(f"M2 class passes / profile: {e}")
    print(f"one decode step's class passes (K={step['K']}, layer 0) vs "
          f"plain: max abs err " + ", ".join(
              f"{k} {v:.3g}" for k, v in m2["class_passes_vs_plain"].items()))
    print(f"profiler, one M2 decode step replayed: {prof['kernels']} "
          f"kernels, device {prof['device_ms']:.3f} ms = paged attention "
          f"{prof['paged_attention_ms']:.3f} + matmuls "
          f"{prof['matmul_ms']:.3f} + other {prof['other_ms']:.3f} ms, of "
          f"{prof['wall_ms']:.3f} ms host wall (device busy "
          f"{100 * prof['busy_share']:.1f} %)")
    for r in prof["top"][:8]:
        print(f"  {r['ms']:8.3f} ms  x{r['count']:<4d} {r['name']}")
    reqs = [eng.requests[i] for i in range(M_REQUESTS)]
    del eng, probe, q
    gc.collect()                     # the engine and its probe: a cycle
    torch.cuda.empty_cache()
    # the routings behind the timed run's tokens, from a second, untimed
    # run of the same requests with the recording yardstick as its model
    tape = RouteTape()
    eng = ServingEngine(yardstick(model, tape), params,
                        EngineConfig(**S3_ENGINE), device=dev)
    for r in reqs:
        eng.add_request(r.prompt, max_new_tokens=r.max_new_tokens)
    eng.run_to_completion()
    if [eng.requests[i].generated for i in range(M_REQUESTS)] != [
            r.generated for r in reqs]:
        fail("M2: a second engine run of the same requests gave other "
             "tokens")
    tape.replay = True
    m2["dense_check"] = batched_dense_check(dev, model, params, reqs, "M2",
                                            tape)
    m2["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"peak device memory over the phase {m2['peak_memory_gb']:.2f} GB "
          f"({time.time() - t0:.1f} s in all)")
    del eng, params
    torch.cuda.empty_cache()
    return m2


def serve_family(torch, np, dev, model, params, tag):
    """M2 / M3: ``family_requests`` through ``ServingEngine(S3_ENGINE)``,
    timed, and every request finished with all its tokens.  Returns the
    numbers, the engine and its probe."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.serve import EngineConfig, ServingEngine
    eng = ServingEngine(model, params, EngineConfig(**S3_ENGINE), device=dev)
    probe = EngineProbe(model, eng)
    eng.model = probe
    requests = family_requests(model.cfg.vocab)
    for p, n_new in requests:
        eng.add_request(p, max_new_tokens=n_new)
    print(f"prompt lengths {[len(p) for p, _ in requests]}, answer lengths "
          f"{[n for _, n in requests]} (S3's, capped at {M_ANSWER_CAP}: a "
          "cut)")
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.time()
    m = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.time() - t1
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    pre = [t for _, t in probe.prefill_s]
    print(f"engine wall {wall:.2f} s: {m['steps']} steps, {m['tokens']} "
          f"decoded tokens, K={m['K']}, descriptor reduction "
          f"{m['descriptor_reduction']:.4f}, stalled {m['stalled']}; "
          f"launches {counts}, paged by class {dict(pa_ops.CLASS_LAUNCHES)}; "
          f"{len(pre)} prefills {sum(pre):.3f} s (median "
          f"{statistics.median(pre) * 1e3:.1f} ms), decode steps median "
          f"{statistics.median(probe.decode_s) * 1e3:.2f} ms; peak device "
          f"memory {peak:.2f} GB")
    if m["stalled"] != 0 or [len(eng.requests[i].generated)
                             for i in range(len(requests))] != [
                                 n for _, n in requests]:
        fail(f"{tag}: not every request finished with all its tokens")
    if counts["tlb_sweep"]:
        fail(f"{tag}: the serving path launched the TLB kernel")
    if list(probe.steps[0]["lens"]) != [len(p) for p, _ in requests]:
        fail(f"{tag}: the first decode step's slots do not hold the "
             "requests in order, which the batched dense check mirrors")
    return dict(
        engine_wall_s=wall, steps=m["steps"], tokens=m["tokens"], K=m["K"],
        descriptor_reduction=m["descriptor_reduction"], launches=counts,
        launches_by_class={str(k): n for k, n in
                           pa_ops.CLASS_LAUNCHES.items()},
        prefills=len(pre), prefill_s=dict(total=sum(pre),
                                          median=statistics.median(pre),
                                          by_tokens=probe.prefill_s),
        decode_step_s=dict(n=len(probe.decode_s), total=sum(probe.decode_s),
                           median=statistics.median(probe.decode_s)),
        engine_peak_memory_gb=peak,
        prompt_lens=[len(p) for p, _ in requests],
        answer_lens=[n for _, n in requests], engine=eng, probe=probe)


def batched_dense_check(dev, model, params, reqs, tag, tape=None):
    """M2 / M3: the engine's tokens against the dense-cache decode of
    :func:`yardstick` (``tape`` replaying the engine's routings), the
    requests in one batch as the engine ran them: bf16 products at other
    batch shapes, p rounded to bf16, and a router tie that either rounding
    tips move these models' logits by more than ``DENSE_MARGIN``, the
    xLSTM's through its recurrent state, the MoE's through another
    expert."""
    try:
        dc = dense_check(yardstick(model, tape), params, reqs, dev,
                         DENSE_MARGIN, batched=True)
    except ValueError as e:
        fail(f"{tag} vs dense decode: {e}")
    if tape and tape.pos != len(tape.ids):
        fail(f"{tag}: the dense decode made {tape.pos} routing calls, the "
             f"engine {len(tape.ids)}")
    if tape:
        dc["route_flips"], dc["route_decisions"] = tape.flips, tape.decisions
    print(f"vs the dense-cache decode_step, teacher-forced, the "
          f"{len(reqs)} rows in one batch as the engine ran them"
          + (", softmax weights in f32 as the paged kernel keeps them"
             if model.cfg.n_attn_layers else "")
          + (f", the engine's experts replayed (the dense decode's own "
             f"top-k differed in {tape.flips} of {tape.decisions} decode "
             "routings)" if tape else "")
          + f": {dc['equal']} of {dc['checked']} tokens equal, the rest "
          f"within {DENSE_MARGIN} (largest lead {dc['max_gap']:.4g})")
    return dc


# ---------------------------------------------------------------------------
# The encoder and VLM input paths and the training stack (E1, T0, T1, V1)
# ---------------------------------------------------------------------------

def flash_timing(torch, dev, shape, causal, flush, reps=20, plain_reps=3):
    """The flash kernel at one layer's shape ``(B, S, H, KVH, D)``, bf16,
    inputs from a seed: CUDA events behind a queued spin (median of
    ``reps``, L2 flushed before each call), its plain version (median of
    ``plain_reps``), one ``scaled_dot_product_attention`` call on the same
    q and K/V repeated to H heads (``[B, H, S, D]``, the repeat excluded;
    the library yardstick) and the bound."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import (flash_attention_gqa,
                                                     flash_attention_ref)
    B, S, H, KVH, D = shape
    q, k, v = flash_inputs(shape, torch.bfloat16, dev, seed=1)
    ms = cuda_time_ms(lambda: flash_attention_gqa(q, k, v, causal=causal),
                      reps, flush)
    plain = cuda_time_ms(lambda: flash_attention_ref(q, k, v, causal=causal),
                         plain_reps, flush)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // KVH, 2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // KVH, 2).transpose(1, 2).contiguous()

    def sdpa():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)
    lib = cuda_time_ms(sdpa, reps, flush)
    b_ms, b_by, b_bytes, b_flops, b_tb, b_to = flash_bound(B, S, H, KVH, D,
                                                           2, causal)
    return dict(shape=dict(B=B, S=S, H=H, KVH=KVH, D=D, causal=causal),
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, bytes=b_bytes, flops=b_flops, bytes_ms=b_tb,
                ops_ms=b_to, tflops=b_flops / (ms * 1e-3) / 1e12,
                library=("scaled_dot_product_attention on the same q and "
                         "K/V repeated to H heads, [B, H, S, D], repeat "
                         "excluded"))


def print_flash_timing(what, t):
    print(f"{what}: kernel {t['ms']:.5f} ms (CUDA events behind a queued "
          f"spin, {t['tflops']:.2f} Tflop/s), plain version "
          f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.5f} ms; bound "
          f"{t['bound_ms']:.5f} ms by {t['bound_by']} ({t['flops']:.4g} flop"
          f" = {t['ops_ms']:.5f} ms; {t['bytes']} B = {t['bytes_ms']:.5f} "
          f"ms)")


def train_against_fixture(rec, opt, trainer, device, ckpt_dir):
    """T0 (and ``tests/test_torch_train.py`` on the CPU): one model of
    ``tests/data/port_train_reference.json`` trained by the port's
    ``Trainer``, ``DataPipeline`` and optimizer as the fixture's JAX run
    was, checkpoints into ``ckpt_dir``.  The weight digest must equal the
    fixture's; returns ``{"losses", "grad_norms", "aux", "loss_err",
    "grad_norm_rel_err", "steps"}`` (the errors against the fixture)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline, PipelineConfig
    from repro_torch.models import Model, RunConfig
    from repro_torch.optim import OptConfig
    from repro_torch.train import Trainer, TrainerConfig
    cfg = get_config(rec["arch"], reduced=rec["reduced"])
    model = Model(cfg, RunConfig(**rec["run_config"]))
    host = model.init_numpy(rec["weight_seed"])
    for name, want in rec["weight_digest"].items():
        got = np.asarray(_digest_leaf(host, name)).reshape(-1)[:len(want)]
        if [float(x) for x in got] != want:
            raise ValueError(f"{rec['arch']}: weight leaf {name} differs "
                             "from the fixture's draw")
    del host
    pipe = DataPipeline(cfg, PipelineConfig(**rec["pipeline"]),
                        device=device)
    try:
        tr = Trainer(model, OptConfig(**opt),
                     TrainerConfig(ckpt_dir=ckpt_dir, **trainer), pipe,
                     device=device)
        out = tr.run(seed=rec["weight_seed"])
    finally:
        pipe.close()
    got = {m["step"]: m for m in out["metrics"]}
    want = {s["step"]: s for s in rec["steps"]}
    if sorted(got) != sorted(want):
        raise ValueError(f"{rec['arch']}: steps {sorted(got)} logged, the "
                         f"fixture has {sorted(want)}")
    loss_err = max(abs(got[s]["loss"] - want[s]["loss"]) for s in want)
    gn_err = max(abs(got[s]["grad_norm"] - want[s]["grad_norm"])
                 / want[s]["grad_norm"] for s in want)
    aux_err = max(abs(got[s]["aux"] - want[s]["aux"]) for s in want)
    if loss_err > T0_LOSS_ATOL or aux_err > T0_LOSS_ATOL:
        raise ValueError(f"{rec['arch']}: losses differ from JAX's by "
                         f"{loss_err:.3g} (aux {aux_err:.3g}) > "
                         f"{T0_LOSS_ATOL}")
    if gn_err > T0_GNORM_RTOL:
        raise ValueError(f"{rec['arch']}: grad norms differ from JAX's by "
                         f"{gn_err:.3g} of theirs > {T0_GNORM_RTOL}")
    return dict(losses=[got[s]["loss"] for s in sorted(want)],
                grad_norms=[got[s]["grad_norm"] for s in sorted(want)],
                aux=[got[s]["aux"] for s in sorted(want)],
                loss_err=loss_err, grad_norm_rel_err=gn_err,
                steps=sorted(want))


def encoder_vlm_phases(torch, np, dev, flush):
    """Phases E1, T0, T1, D1 and V1; returns the numbers for
    ``chip_smoke.json``."""
    out = dict(e1=e1_phase(torch, np, dev, flush))
    out["t0"] = t0_phase(torch, dev)
    out["t1"] = t1_phase(torch, np, dev, out["e1"].pop("params"))
    out["d1"] = d1_phase(torch, np, dev)
    out["v1"] = v1_phase(torch, np, dev, flush)
    return out


def e1_phase(torch, np, dev, flush):
    """E1: the flash kernel at D = 80 against its plain version, then
    HuBERT-XLarge's encoder forward at full width; returns the numbers and
    the model's f32 parameters (T1 trains them)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, _batch_at
    from repro_torch.models import Model, RunConfig
    t0 = phase(f"E1. HuBERT-XLarge's encoder at full width: the flash kernel"
               f" at D = 80, then Model.forward(input_embeds) on "
               f"[{E1_BATCH}, {E1_FRAMES}, 1280]")
    model = Model(get_config(E_ARCH), RunConfig())
    cfg = model.cfg
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layer = (E1_BATCH, E1_FRAMES, H, KVH, D)
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version
    cases = [(f"test_kernels{i}", shape[:4] + (D,), shape[5], dt)
             for i, shape in enumerate(FLASH_SHAPES)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(f"hubert layer causal={c}", layer, c, dt)
              for c in (False, True)
              for dt in (torch.float32, torch.bfloat16)]
    errs = {}
    reset_counts()
    for name, shape, causal, dt in cases:
        q, k, v = flash_inputs(shape, dt, dev)
        try:
            r = flash_vs_plain(q, k, v, causal)
        except ValueError as e:
            fail(f"E1 {name} {shape} {dt}: {e}")
        errs[f"{name} {str(dt)[6:]}"] = r
        print(f"{name} (B, S, H, KVH, D) = {shape} causal={causal} "
              f"{str(dt)[6:]}: max abs err {r['max_abs_err']:.3g}, "
              f"{100 * r['limit_used']:.1f} % of the "
              + ("one-ulp limit" if dt == torch.bfloat16 else "5e-5 limit")
              + ", the same bits twice")
        del q, k, v
    cmp_launches = launch_counts()["flash_attention"]
    free_earlier_phases(torch)
    t1 = time.time()
    params = model.init_on_device(0, dev)
    torch.cuda.synchronize()
    t_init = time.time() - t1
    cp = model.compute_params(params)
    print(f"{model.n_params():,} parameters drawn in {t_init:.1f} s, f32 "
          f"on the card, and a bf16 copy for the forward")
    x = torch.from_numpy(_batch_at(cfg, PipelineConfig(
        batch=E1_BATCH, seq=E1_FRAMES), 0)["input_embeds"]).to(dev)
    walls = []
    for i in range(3):
        torch.cuda.synchronize()
        if i == 0:
            reset_counts()
        t1 = time.perf_counter()
        with torch.no_grad():
            logits, aux = model.forward(cp, input_embeds=x)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        if i == 0:
            launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if launches["flash_attention"] != cfg.n_layers or \
            launches["paged_attention"] or launches["tlb_sweep"]:
        fail(f"E1: the forward launched {launches}; want "
             f"{cfg.n_layers} flash launches and nothing else")
    if tuple(logits.shape) != (E1_BATCH, E1_FRAMES, 512) or not bool(
            torch.isfinite(logits).all()):
        fail(f"E1: logits {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    # the same forward with attention by the plain chunked attention (the
    # training forward, backbone(train=True), run without a graph)
    class PlainAttention(Model):
        def backbone(self, params, tokens=None, **kw):
            return super().backbone(params, tokens, train=True, **kw)

    with torch.no_grad():
        plain_logits, _ = PlainAttention(cfg, model.rc).forward(
            cp, input_embeds=x)
    ref = plain_logits[..., :cfg.vocab].float()
    diff = (logits[..., :cfg.vocab].float() - ref).abs()
    err = float(diff.max())
    rms = float(ref.square().mean().sqrt())
    if err > E1_LOGIT_ATOL:
        fail(f"E1: the flash forward's logits differ from the plain "
             f"attention's by {err:.4g} > {E1_LOGIT_ATOL} (rms {rms:.4g})")
    timing = flash_timing(torch, dev, layer, False, flush)
    print(f"forward wall {statistics.median(walls):.3f} s median of "
          f"{len(walls)} (host clock ending in a synchronise; first "
          f"{walls[0]:.3f} s), launches {launches}, peak device memory "
          f"{peak:.2f} GB; logits {tuple(logits.shape)} finite, within "
          f"{err:.4g} of the forward through the plain chunked attention "
          f"(<= {E1_LOGIT_ATOL}; logit rms {rms:.4g})")
    print_flash_timing(f"one HuBERT layer (B, S, H, KVH, D) = {layer}, "
                       "bf16, non-causal", timing)
    print(f"({time.time() - t0:.1f} s in all)")
    del logits, plain_logits, cp, x, diff, ref
    torch.cuda.empty_cache()
    return dict(vs_plain=errs, vs_plain_launches=cmp_launches,
                init_s=t_init, forward_s=walls,
                forward_median_s=statistics.median(walls),
                launches=launches, peak_memory_gb=peak,
                vs_plain_attention=dict(max_abs_err=err, rms=rms,
                                        atol=E1_LOGIT_ATOL),
                layer_timing=timing, params=params)


def t0_phase(torch, dev):
    """T0: the reduced InternLM2-1.8B and HuBERT-XLarge trained on the card
    in f32 (TF32 off) by the port's Trainer, against the JAX fixture."""
    import shutil
    t0 = phase("T0. reduced internlm2-1.8b and hubert-xlarge trained on the "
               "card in f32 (Trainer, AdamW), vs the JAX fixture")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = json.load(open(TRAIN_REF_JSON))
    out = {}
    for arch, rec in ref["models"].items():
        d = os.path.join(HERE, "build", "ckpt_t0", arch)
        shutil.rmtree(d, ignore_errors=True)
        reset_counts()
        try:
            res = train_against_fixture(rec, ref["opt"], ref["trainer"], dev,
                                        d)
        except ValueError as e:
            fail(f"T0 {arch}: {e}")
        finally:
            shutil.rmtree(d, ignore_errors=True)
        res["launches"] = counts = launch_counts()
        if any(counts.values()):
            fail(f"T0 {arch}: training launched {counts}; no training path "
                 "may reach a kernel (the flash kernel is a forward only)")
        print(f"{arch}: {len(res['steps'])} steps, losses "
              f"{[round(x, 6) for x in res['losses']]}, within "
              f"{res['loss_err']:.3g} of JAX's (<= {T0_LOSS_ATOL}); grad "
              f"norms within {res['grad_norm_rel_err']:.3g} of theirs (<= "
              f"{T0_GNORM_RTOL}); no kernel launched")
        out[arch] = res
    print(f"({time.time() - t0:.1f} s in all)")
    return out


def profile_train_step(fn):
    """Device time by kernel over one training step ``fn()``, from
    ``torch.profiler``'s kernel events (CUDA activity alone: a step's
    ~70,000 kernels with their host-side events took ~40 s to profile):
    matrix products, fills (of new tensors: zeros, and the NaN fills of
    deterministic algorithms), everything else, and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            r = rows.setdefault(ev.name, [0.0, 0])
            r[0] += ev.time_range.elapsed_us() / 1e3
            r[1] += 1
    total = sum(r[0] for r in rows.values())

    def gemm(n):
        return any(w in n.lower() for w in ("gemm", "gemv", "nvjet", "xmma",
                                            "cutlass", "sm90_"))
    mm = sum(r[0] for n, r in rows.items() if gemm(n))
    fill = sum(r[0] for n, r in rows.items()
               if not gemm(n) and "fill" in n.lower())
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:12]
    return dict(device_ms=total, matmul_ms=mm, fill_ms=fill, other_ms=total - mm - fill,
                kernels=sum(r[1] for r in rows.values()),
                top=[dict(name=n[:120], ms=r[0], count=r[1])
                     for n, r in top])


class _TimedCheckpointer:
    """Wraps a Trainer's checkpointer: the seconds from each ``save`` call
    to the ``wait`` that joins its write (the host copy and the file
    writes; the trainer waits at once after its closing save)."""

    def __init__(self, ckpt):
        self._ckpt, self.saves, self._t = ckpt, [], None

    def __getattr__(self, name):
        return getattr(self._ckpt, name)

    def save(self, *a, **kw):
        self._ckpt.wait()
        self._t = time.perf_counter()
        self._ckpt.save(*a, **kw)
        if kw.get("blocking"):
            self.saves.append(time.perf_counter() - self._t)
            self._t = None

    def wait(self):
        self._ckpt.wait()
        if self._t is not None:
            self.saves.append(time.perf_counter() - self._t)
            self._t = None


def t1_phase(torch, np, dev, params):
    """T1: HuBERT-XLarge trained at full width (f32 parameters, bf16
    compute, AdamW, remat full), straight through and through a failure
    and a resume, deterministic algorithms on."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline, PipelineConfig
    from repro_torch.models import Model, RunConfig
    from repro_torch.models.common import tree_map
    from repro_torch.optim import OptConfig
    from repro_torch.train import SimulatedFailure, Trainer, TrainerConfig
    t0 = phase(f"T1. HuBERT-XLarge trained at full width and "
               f"{T1_LAYERS} of its 48 layers: {T1_BATCH} x "
               f"{T1_FRAMES} frames in {T1_MICRO} microbatches, "
               f"{T1_STEPS} steps, a checkpoint every {T1_CKPT_EVERY}, a "
               f"failure at step {T1_FAIL_AT} and a resume")
    model = Model(dataclasses.replace(get_config(E_ARCH),
                                      n_layers=T1_LAYERS),
                  RunConfig(microbatches=T1_MICRO))
    cfg = model.cfg
    root = os.path.join(HERE, "build", "ckpt_t1")
    shutil.rmtree(root, ignore_errors=True)
    opt = OptConfig(lr=1e-4, warmup_steps=2, total_steps=T1_STEPS)
    pc = PipelineConfig(batch=T1_BATCH, seq=T1_FRAMES, seed=7)
    # the straight run takes E1's first T1_LAYERS layers over (each
    # layer's draw is its own stream: the T1_LAYERS-layer draw itself)
    first = {"params": {k: (tree_map(lambda a: a[:T1_LAYERS].clone(), v)
                            if k == "blocks" else v)
                        for k, v in params.items()}}
    del params

    class T1Trainer(Trainer):
        def init_state(self, seed=0):      # E1's draw, not a second one
            from repro_torch.optim import init_opt
            p = first.pop("params", None)
            if p is None:
                return super().init_state(seed)
            return p, init_opt(self.opt_cfg, p), 0

        def try_restore(self):
            t = time.perf_counter()
            r = super().try_restore()
            torch.cuda.synchronize()
            self.restore_s = time.perf_counter() - t if r else None
            return r

    def trainer(name, hook=None):
        pipe = DataPipeline(cfg, pc, device=dev)
        tr = T1Trainer(model, opt, TrainerConfig(
            total_steps=T1_STEPS, ckpt_every=T1_CKPT_EVERY,
            ckpt_dir=os.path.join(root, name), keep=1, log_every=1), pipe,
            failure_hook=hook, device=dev)
        tr.ckpt = _TimedCheckpointer(tr.ckpt)
        return tr, pipe

    def fail_at(step):
        if step == T1_FAIL_AT:
            raise SimulatedFailure(f"injected at step {step}")

    free_earlier_phases(torch)
    torch.use_deterministic_algorithms(True)
    runs = {}
    try:
        straight, pipe = trainer("straight")
        t1 = time.time()
        out = straight.run()
        runs["straight"] = dict(wall_s=time.time() - t1,
                                saves_s=straight.ckpt.saves,
                                metrics=out["metrics"])
        peak = torch.cuda.max_memory_allocated() / 1e9
        # one more step from the straight run's state, profiled
        batch = next(pipe)
        pipe.close()
        prof = profile_train_step(lambda: straight.train_step(
            out["params"], out["opt"], batch, T1_STEPS))
        del batch
        del out, straight
        shutil.rmtree(os.path.join(root, "straight"), ignore_errors=True)
        # the failing run starts from the same draw: E1's parameters are
        # gone into the straight run, so it draws them again (seed 0)
        failing, pipe = trainer("resumed", fail_at)
        t1 = time.time()
        try:
            failing.run()
            fail("T1: the failure hook did not stop the run")
        except SimulatedFailure:
            pass
        failing.ckpt.wait()
        pipe.close()
        runs["failing"] = dict(wall_s=time.time() - t1,
                               saves_s=failing.ckpt.saves,
                               metrics=failing.metrics_log)
        del failing
        resumed, pipe = trainer("resumed")
        t1 = time.time()
        out = resumed.run()
        pipe.close()
        runs["resumed"] = dict(wall_s=time.time() - t1,
                               saves_s=resumed.ckpt.saves,
                               restore_s=resumed.restore_s,
                               metrics=out["metrics"])
        del out, resumed
    except RuntimeError as e:
        fail(f"T1: {e}")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    loss = {name: {m["step"]: m["loss"] for m in r["metrics"]}
            for name, r in runs.items()}
    gnorm = {name: {m["step"]: m["grad_norm"] for m in r["metrics"]}
             for name, r in runs.items()}
    if sorted(loss["resumed"]) != list(range(T1_CKPT_EVERY, T1_STEPS)):
        fail(f"T1: the resumed run logged steps {sorted(loss['resumed'])}")
    for name in ("failing", "resumed"):
        for s, x in loss[name].items():
            if x != loss["straight"][s] or \
                    gnorm[name][s] != gnorm["straight"][s]:
                fail(f"T1: the {name} run's step {s} (loss {x!r}, grad "
                     f"norm {gnorm[name][s]!r}) differs from the straight "
                     f"run's ({loss['straight'][s]!r}, "
                     f"{gnorm['straight'][s]!r})")
    vals = [v for r in runs.values() for m in r["metrics"]
            for v in (m["loss"], m["grad_norm"])]
    if not all(np.isfinite(vals)):
        fail("T1: a loss or grad norm is not finite")
    times = [m["time"] for m in runs["straight"]["metrics"]][1:]
    step_s = statistics.median(times)
    frames_s = T1_BATCH * T1_FRAMES / step_s
    save_s = runs["straight"]["saves_s"][-1]
    print(f"straight run: losses {[round(loss['straight'][s], 5) for s in sorted(loss['straight'])]}, "
          f"grad norms {[round(gnorm['straight'][s], 4) for s in sorted(gnorm['straight'])]}; "
          f"the failing run's steps 0-{T1_FAIL_AT - 1} and the resumed "
          f"run's steps {T1_CKPT_EVERY}-{T1_STEPS - 1} equal them bit for "
          "bit (deterministic algorithms on)")
    print(f"step time median {step_s:.3f} s (steps 1-{T1_STEPS - 1}, host "
          f"clock ending in the metrics' copy to the host; step 0 "
          f"{runs['straight']['metrics'][0]['time']:.3f} s), "
          f"{frames_s:,.0f} frames/s; peak device memory {peak:.2f} GB; "
          f"checkpoint save {save_s:.2f} s (host copy and write of "
          f"params + AdamW state), restore {runs['resumed']['restore_s']:.2f}"
          f" s; walls straight {runs['straight']['wall_s']:.1f} s, failing "
          f"{runs['failing']['wall_s']:.1f} s, resumed "
          f"{runs['resumed']['wall_s']:.1f} s")
    print(f"profiler, one more step: {prof['kernels']} kernels, device "
          f"{prof['device_ms']:.1f} ms ({100 * prof['device_ms'] / 1e3 / step_s:.1f} "
          f"% of the step median) = matmuls {prof['matmul_ms']:.1f} + "
          f"fills {prof['fill_ms']:.1f} + other {prof['other_ms']:.1f} ms")
    for r in prof["top"][:8]:
        print(f"  {r['ms']:9.3f} ms  x{r['count']:<5d} {r['name']}")
    print(f"({time.time() - t0:.1f} s in all)")
    torch.cuda.empty_cache()
    return dict(runs=runs, step_median_s=step_s, frames_per_s=frames_s,
                peak_memory_gb=peak, save_s=save_s,
                restore_s=runs["resumed"]["restore_s"],
                deterministic=True, profile_step=prof)


def _bits_equal(a, b) -> bool:
    """Two tensors of the same dtype, shape and bits (NaNs and signed
    zeros included)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a = a.contiguous().view(as_int[a.element_size()])
        b = b.contiguous().view(as_int[b.element_size()])
    return torch.equal(a, b)


def _leaves_equal(a, b) -> list:
    """Paths of two trees (DTensors gathered) whose leaves differ in a
    bit, shape or dtype, or which one of them lacks."""
    from repro_torch.checkpoint.checkpointer import leaf_paths
    from repro_torch.distributed.sharding import gather
    la, lb = dict(leaf_paths(a)), dict(leaf_paths(b))
    bad = sorted(set(la) ^ set(lb))
    for p in sorted(set(la) & set(lb)):
        x, y = gather(la[p]), gather(lb[p])
        if not _bits_equal(x, y):
            bad.append(p)
    return bad


def d1_tensor_parallel(torch, np, dev, model, mesh, psh, params):
    """D1's tensor-parallel checks on the card: ``Model.forward`` through
    the tensor-parallel backbone on ``mesh`` from ``params`` placed as
    DTensors by ``psh`` (no copy at one rank) against the unsharded
    forward, bit for bit, its flash launches counted; then the flash
    kernel on each model rank's heads (``D1_HEAD_SLICES``) as strided
    views against the whole call, bit for bit."""
    import dataclasses
    from repro_torch.checkpoint.checkpointer import leaf_paths, rebuild
    from repro_torch.distributed.sharding import from_local
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    from repro_torch.models.layers import kv_heads_of
    places = dict(leaf_paths(psh))
    sp = rebuild(params, {p: from_local(x, places[p], x.shape)
                          for p, x in leaf_paths(params)})
    tp_model = dataclasses.replace(model, mesh=mesh)
    tokens = torch.from_numpy(np.random.default_rng(D1_STEPS).integers(
        0, model.cfg.vocab, (1, D1_FWD_SEQ))).to(dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        t1 = time.time()
        reset_counts()
        got, _ = tp_model.forward(sp, tokens)
        torch.cuda.synchronize()
        n = launch_counts()["flash_attention"]
        t2 = time.time()
        want, _ = model.forward(params, tokens)
        torch.cuda.synchronize()
        t3 = time.time()
    if n != model.cfg.n_layers:
        fail(f"D1: the tensor-parallel forward launched the flash kernel "
             f"{n} times, not once per layer ({model.cfg.n_layers})")
    if not (_bits_equal(got, want) and torch.isfinite(got).all()):
        fail("D1: the tensor-parallel forward's logits differ from the "
             "unsharded forward's (max |diff| "
             f"{(got.float() - want.float()).abs().max().item():.3g})")
    forward = dict(flash_launches=n, seconds=t2 - t1,
                   unsharded_seconds=t3 - t2, logits=tuple(got.shape))
    del got, want, sp
    slices = []
    for (B, S, H, KVH, D, causal), tps in D1_HEAD_SLICES:
        q, k, v = flash_inputs((B, S, H, KVH, D), torch.bfloat16, dev)
        whole = flash_attention_gqa(q, k, v, causal=causal)
        group = H // KVH
        for tp in tps:
            hl = H // tp
            n0 = launch_counts()["flash_attention"]
            for r in range(tp):
                qr = q[:, :, r * hl:(r + 1) * hl]
                kr = kv_heads_of(k, r * hl, hl, group)
                vr = kv_heads_of(v, r * hl, hl, group)
                if any(t.is_contiguous() or t.untyped_storage().data_ptr()
                       != base.untyped_storage().data_ptr()
                       for t, base in ((qr, q), (kr, k), (vr, v))):
                    fail(f"D1: rank {r}'s heads at tp {tp} are not strided "
                         "views of the layer's q, k, v")
                o = flash_attention_gqa(qr, kr, vr, causal=causal)
                if not _bits_equal(o, whole[:, :, r * hl:(r + 1) * hl]):
                    fail(f"D1: the flash kernel on rank {r}'s heads at tp "
                         f"{tp}, {(B, S, H, KVH, D)} causal={causal}, "
                         "differs from the whole call's heads")
            slices.append(dict(shape=(B, S, H, KVH, D), causal=causal,
                               tp=tp, launches=launch_counts()[
                                   "flash_attention"] - n0))
        del q, k, v, whole
    return dict(forward=forward, head_slices=slices)


def d1_cached(torch, np, dev, model, mesh, params, seq: int,
              forward: bool) -> dict:
    """One model's passes on ``mesh`` (a (1, 1) NCCL mesh) from ``params``
    placed as DTensors by the rules (no copy at one rank) against the
    unsharded passes on the same tensors, bit for bit: the forward (with
    ``forward``), ``prefill`` and ``prefill_chunked`` (2 chunks) of a 1 x
    ``seq`` prompt under "default" (logits and every cache leaf), then
    ``D1_DECODE`` greedy ``decode_step``s under "decode" from the
    prefill's state (redistributed on entry: no collective at one rank):
    tokens, logits and the final state.  Counts the flash launches of
    each mesh prefill (one per attention layer; two per layer chunked).
    Returns each check's seconds, mesh and unsharded."""
    import dataclasses
    from repro_torch.checkpoint.checkpointer import leaf_paths, rebuild
    from repro_torch.distributed.sharding import from_local, param_sharding
    from repro_torch.models.common import logical_tree, spec_shapes
    from repro_torch.models.model import attn_positions, n_superblocks
    t0 = time.time()
    cfg = model.cfg
    name = cfg.name
    specs = model.specs()
    places = dict(leaf_paths(param_sharding(logical_tree(specs),
                                            spec_shapes(specs), mesh)))
    sp = rebuild(params, {p: from_local(x, places[p], x.shape)
                          for p, x in leaf_paths(params)})
    pre = dataclasses.replace(model, mesh=mesh, act_rules="default")
    dec = dataclasses.replace(model, mesh=mesh, act_rules="decode")
    tokens = torch.from_numpy(np.random.default_rng(seq).integers(
        0, cfg.vocab, (1, seq))).to(dev)
    max_seq = seq + D1_DECODE
    per_pass = len(attn_positions(cfg)) * n_superblocks(cfg)
    seconds, launches = {}, {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t = time.time()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        seconds[key] = time.time() - t
        launches[key] = launch_counts()["flash_attention"]
        return out

    def same(what, got, want):
        if not (_bits_equal(got, want) and torch.isfinite(got).all()):
            fail(f"D1: {name}'s {what} on the (1, 1) mesh differs from the "
                 "unsharded pass's (max |diff| "
                 f"{(got.float() - want.float()).abs().max().item():.3g})")

    def same_state(what, got, want):
        bad = _leaves_equal(got, want)
        if bad:
            fail(f"D1: {name}'s state after {what} on the (1, 1) mesh "
                 f"differs from the unsharded pass's at {bad[:5]}")

    with torch.no_grad():
        if forward:
            got = timed("forward", lambda: pre.forward(sp, tokens)[0])
            want = timed("forward_unsharded",
                         lambda: model.forward(params, tokens)[0])
            same("forward", got, want)
            del got, want
        lg, st = timed("prefill", lambda: pre.prefill(sp, tokens,
                                                      max_seq=max_seq))
        wl, ws = timed("prefill_unsharded", lambda: model.prefill(
            params, tokens, max_seq=max_seq))
        same("prefill logits", lg, wl)
        same_state("prefill", st, ws)
        got = timed("prefill_chunked", lambda: pre.prefill_chunked(
            sp, tokens, n_chunks=2, max_seq=max_seq))
        want = timed("prefill_chunked_unsharded", lambda: (
            model.prefill_chunked(params, tokens, n_chunks=2,
                                  max_seq=max_seq)))
        same("chunked prefill logits", got[0], want[0])
        same_state("the chunked prefill", got[1], want[1])
        del got, want
        for key, n in (("prefill", per_pass), ("prefill_chunked",
                                               2 * per_pass)):
            for k in (key, key + "_unsharded"):
                if launches[k] != n:
                    fail(f"D1: {name}'s {k} launched the flash kernel "
                         f"{launches[k]} times, not {n}")
        nxt, wnxt = lg[:, -1:].argmax(-1), wl[:, -1:].argmax(-1)
        tokens_out = []

        def decode():
            nonlocal st, ws, nxt, wnxt
            for step in range(D1_DECODE):
                kv = torch.full((1,), seq + step, device=dev)
                lg2, st = dec.decode_step(sp, st, nxt, kv)
                wl2, ws = model.decode_step(params, ws, wnxt, kv)
                same(f"decode step {step}'s logits", lg2, wl2)
                nxt, wnxt = lg2[:, -1:].argmax(-1), wl2[:, -1:].argmax(-1)
                if not torch.equal(nxt, wnxt):
                    fail(f"D1: {name}'s greedy token at decode step {step} "
                         "differs from the unsharded one's")
                tokens_out.append(int(nxt[0, 0]))
        timed("decode_both", decode)
        same_state(f"{D1_DECODE} decode steps", st, ws)
    del sp, st, ws, lg, wl
    return dict(arch=name, seq=seq, seconds=seconds,
                wall_s=time.time() - t0,
                flash_launches={k: launches[k]
                                for k in ("prefill", "prefill_chunked")},
                tokens=tokens_out)


def d1_cached_phase(torch, np, dev, model, mesh, params) -> list:
    """D1's cached-pass checks (``D1_CACHED``): :func:`d1_cached` of the
    trained InternLM2-1.8B weights, then of xLSTM-350M and the reduced
    Jamba drawn from seeds; prints each check's seconds."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, RunConfig
    out = []
    for arch, reduced, seq, forward in D1_CACHED:
        t = time.time()
        if arch == model.cfg.name and not reduced:
            m, p = model, params
        else:
            m = Model(get_config(arch, reduced), RunConfig())
            p = m.init_on_device(0, dev)
        drawn = time.time() - t
        r = d1_cached(torch, np, dev, m, mesh, p, seq, forward)
        r["draw_s"] = drawn
        out.append(r)
        del p
        torch.cuda.empty_cache()
        print(f"{arch}{' (reduced)' if reduced else ''} on the (1, 1) mesh "
              f"vs unsharded, bit for bit: " + ", ".join(
                  f"{k} {v:.3f} s" for k, v in r["seconds"].items())
              + f"; flash launches {r['flash_launches']}; weights drawn in "
              f"{drawn:.1f} s; {r['wall_s']:.1f} s with the comparisons")
    return out


def d1_phase(torch, np, dev):
    """D1: InternLM2-1.8B at full width trained through the sharded
    (tensor-parallel) trainer on one NCCL rank and through the unsharded
    one, bit for bit; the checkpoints restored across the two; the
    tensor-parallel forward and the flash kernel on each rank's heads
    (:func:`d1_tensor_parallel`); the EF all-reduce and the pipeline on
    card tensors."""
    import datetime
    import shutil
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline, PipelineConfig
    from repro_torch.distributed.grad_compress import (_dequant, _quant,
                                                       ef_allreduce)
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.distributed.sharding import param_sharding
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import Model, RunConfig
    from repro_torch.models.common import logical_tree, spec_shapes
    from repro_torch.optim import OptConfig, init_opt
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.trainer import shard_state
    t0 = phase(f"D1. {D_ARCH} trained at full width through the sharded "
               f"trainer on one NCCL rank and unsharded: {D1_BATCH} x "
               f"{D1_SEQ} tokens, {D1_STEPS} steps each; checkpoints "
               "restored across; the tensor-parallel forward and the flash "
               "kernel on each rank's heads; EF all-reduce and GPipe on "
               "the card")
    free_earlier_phases(torch)
    root = os.path.join(HERE, "build", "d1")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    model = Model(get_config(D_ARCH), RunConfig())
    cfg = model.cfg
    ckpt_gb = model.n_params() * 4 * 3 / 1e9     # f32 params, m and v
    free_gb = shutil.disk_usage(root).free / 1e9
    if free_gb < 2.5 * ckpt_gb:
        fail(f"D1: {free_gb:.1f} GB free under build/, the two "
             f"checkpoints need {2 * ckpt_gb:.1f}")
    try:
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(root, 'rdzv')}",
            world_size=1, rank=0, device_id=dev,
            timeout=datetime.timedelta(seconds=120))
    except RuntimeError as e:       # DistBackendError among them
        fail(f"D1: NCCL did not initialise ({type(e).__name__}: {e})")
    opt = OptConfig(lr=1e-4, warmup_steps=1, total_steps=D1_STEPS)
    pc = PipelineConfig(batch=D1_BATCH, seq=D1_SEQ, seed=11)
    runs, restores, marks = {}, {}, [("start", time.time())]
    torch.use_deterministic_algorithms(True)
    try:
        if dist.get_backend() != "nccl":
            fail(f"D1: the process group runs {dist.get_backend()}")
        mesh = make_test_mesh((1, 1), ("data", "model"))
        specs = model.specs()
        psh = param_sharding(logical_tree(specs), spec_shapes(specs), mesh,
                             "default")
        marks.append(("NCCL and the mesh", time.time()))
        first = {"params": model.init_on_device(0, dev)}
        marks.append(("the draw", time.time()))

        class D1Trainer(Trainer):
            def init_state(self, seed=0):
                """The one draw, for both runs: sharded, its shards;
                unsharded (the second run), the drawn tree itself."""
                if self.param_shardings is not None:
                    return (*shard_state(self.opt_cfg, first["params"],
                                         self.param_shardings,
                                         self.opt_shardings), 0)
                p = first.pop("params")
                return p, init_opt(self.opt_cfg, p), 0

        def trainer(name, sharded):
            pipe = DataPipeline(cfg, pc, device=dev)
            tr = D1Trainer(model, opt, TrainerConfig(
                total_steps=D1_STEPS, ckpt_every=D1_STEPS,
                ckpt_dir=os.path.join(root, name), keep=1, log_every=1),
                pipe, param_shardings=psh if sharded else None, device=dev)
            tr.ckpt = _TimedCheckpointer(tr.ckpt)
            return tr, pipe

        finals = {}
        for name, sharded in (("sharded", True), ("unsharded", False)):
            torch.cuda.reset_peak_memory_stats()
            tr, pipe = trainer(name, sharded)
            t1 = time.time()
            out = tr.run()
            pipe.close()
            runs[name] = dict(wall_s=time.time() - t1,
                              saves_s=tr.ckpt.saves, metrics=out["metrics"],
                              peak_memory_gb=torch.cuda.max_memory_allocated()
                              / 1e9)
            finals[name] = {"params": out["params"], "opt": out["opt"]}
            del out, tr
            if sharded:     # its checkpoint holds it: free the card
                finals.pop(name)
                torch.cuda.empty_cache()
            marks.append((f"the {name} run", time.time()))
        want = finals.pop("unsharded")
        # each run's checkpoint restored into the other kind of trainer
        for src, sharded in (("sharded", False), ("unsharded", True)):
            tr, pipe = trainer(src, sharded)
            pipe.close()
            t1 = time.time()
            p, o, step = tr.try_restore()
            torch.cuda.synchronize()
            restores[src] = dict(seconds=time.time() - t1, step=step,
                                 into="sharded" if sharded else "unsharded")
            bad = _leaves_equal({"params": p, "opt": o}, want)
            if bad or step != D1_STEPS:
                fail(f"D1: the {src} run's checkpoint restored into the "
                     f"{restores[src]['into']} trainer differs from the "
                     f"unsharded run's state at {bad[:5]} (step {step})")
            del p, o, tr
            marks.append((f"the {src} restore and comparison", time.time()))
        tp = d1_tensor_parallel(torch, np, dev, model, mesh, psh,
                                want["params"])
        marks.append(("the tensor-parallel forward and head slices",
                      time.time()))
        # the mLSTM's chunkwise prefill takes a float cumsum, which
        # deterministic mode refuses on the card; both sides of each
        # comparison launch the same kernels on the same inputs
        torch.use_deterministic_algorithms(False)
        tp["cached"] = d1_cached_phase(torch, np, dev, model, mesh,
                                       want["params"])
        torch.use_deterministic_algorithms(True)
        marks.append(("the cached passes on the mesh", time.time()))
        del want
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(os.path.join(root,
                                                              "sharded"))
                         for f in fs)

        # the EF all-reduce and the pipeline on card tensors
        dmesh = make_test_mesh((1,), ("data",))
        g = torch.randn(D1_EF_N, device=dev, generator=torch.Generator(
            dev).manual_seed(5))
        r = torch.randn(D1_EF_N, device=dev, generator=torch.Generator(
            dev).manual_seed(6)) * 1e-3
        mean, new_r = ef_allreduce({"g": g[None]}, {"g": r[None]}, dmesh,
                                   "data")
        x = g + r
        q, sc = _quant(x)
        deq = _dequant(q, sc, x.shape)
        if not (_bits_equal(mean["g"][0], deq)
                and _bits_equal(new_r["g"][0], x - deq)):
            fail("D1: ef_allreduce at one rank differs from the plain "
                 "quantise-dequantise or its residual")
        pmesh = make_test_mesh((1,), ("pod",))
        n_micro, bm, d = D1_PIPE
        w = torch.randn((1, d, d), device=dev, generator=torch.Generator(
            dev).manual_seed(7)) / d ** 0.5
        xs = torch.randn((n_micro, bm, d), device=dev,
                         generator=torch.Generator(dev).manual_seed(8))
        got = pipeline_forward(pmesh, "pod",
                               lambda w_s, xb: torch.tanh(xb @ w_s), w, xs)
        if not _bits_equal(got, torch.stack([torch.tanh(xs[i] @ w[0])
                                            for i in range(n_micro)])):
            fail("D1: pipeline_forward at one stage differs from the block "
                 "applied in order")
        marks.append(("EF all-reduce and GPipe", time.time()))
    except (RuntimeError, ValueError) as e:
        fail(f"D1: {type(e).__name__}: {e}")
    finally:
        torch.use_deterministic_algorithms(False)
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    marks.append(("teardown", time.time()))
    timeline = {name: t - marks[i][1]
                for i, (name, t) in enumerate(marks[1:])}
    ms = {name: [(m["loss"], m["grad_norm"]) for m in r["metrics"]]
          for name, r in runs.items()}
    if ms["sharded"] != ms["unsharded"] or len(ms["sharded"]) != D1_STEPS:
        fail(f"D1: the sharded run's losses and grad norms {ms['sharded']} "
             f"differ from the unsharded run's {ms['unsharded']}")
    if not all(np.isfinite([v for m in ms["sharded"] for v in m])):
        fail("D1: a loss or grad norm is not finite")
    step_s = {name: statistics.median([m["time"] for m in r["metrics"]][1:])
              for name, r in runs.items()}
    out = dict(runs=runs, restores=restores, step_median_s=step_s,
               tensor_parallel=tp, checkpoint_gb=ckpt_bytes / 1e9,
               tokens_per_s={k: D1_BATCH * D1_SEQ / v
                             for k, v in step_s.items()},
               timeline_s=timeline, wall_s=time.time() - t0)
    print(f"losses {[round(m[0], 5) for m in ms['sharded']]}, grad norms "
          f"{[round(m[1], 4) for m in ms['sharded']]}: sharded = unsharded "
          "bit for bit, every parameter and AdamW leaf too")
    for name, r in runs.items():
        print(f"{name}: step median {step_s[name]:.3f} s (steps 1-"
              f"{D1_STEPS - 1}; step 0 {r['metrics'][0]['time']:.3f} s), "
              f"{out['tokens_per_s'][name]:,.0f} tokens/s; run wall "
              f"{r['wall_s']:.1f} s; checkpoint save {r['saves_s'][-1]:.2f} "
              f"s; peak device memory {r['peak_memory_gb']:.2f} GB")
    for src, r in restores.items():
        print(f"the {src} run's checkpoint ({out['checkpoint_gb']:.2f} GB) "
              f"restored into the {r['into']} trainer in "
              f"{r['seconds']:.2f} s, every leaf equal")
    print(f"ef_allreduce of {D1_EF_N:,} f32 and pipeline_forward "
          f"{D1_PIPE} at one NCCL rank: bit for bit")
    f = tp["forward"]
    print(f"tensor-parallel forward of 1 x {D1_FWD_SEQ} tokens on the (1, 1)"
          f" mesh: {f['flash_launches']} flash launches, logits equal to the "
          f"unsharded forward's bit for bit ({f['seconds']:.3f} s, unsharded "
          f"{f['unsharded_seconds']:.3f} s)")
    for r in tp["head_slices"]:
        print(f"flash on each rank's heads, {r['shape']} causal="
              f"{r['causal']} at tp {r['tp']}: {r['launches']} strided "
              "launches, each equal to the whole call's heads bit for bit")
    print("timeline: " + ", ".join(f"{k} {v:.1f} s"
                                   for k, v in timeline.items()))
    print(f"({out['wall_s']:.1f} s in all)")
    torch.cuda.empty_cache()
    return out


def v1_phase(torch, np, dev, flush):
    """V1: LLaVA-NeXT-34B at full width: one patch-embedding request
    through ``Model.prefill`` and 16 greedy dense decode steps, then four
    text-only requests through the engine."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, RunConfig
    from repro_torch.serve import EngineConfig, ServingEngine
    t0 = phase(f"V1. LLaVA-NeXT-34B at full width, bf16 weights: "
               f"{V1_TEXT} text tokens after the patch embeddings, "
               f"{V1_DECODE} greedy steps; {V1_REQUESTS} text requests "
               "through the engine")
    model = Model(get_config(V_ARCH), RunConfig(param_dtype="bfloat16"))
    cfg = model.cfg
    free_earlier_phases(torch)
    t1 = time.time()
    params = model.init_on_device(0, dev)
    torch.cuda.synchronize()
    t_init = time.time() - t1
    print(f"{model.n_params():,} parameters drawn slice by slice and stored "
          f"in bf16 on the card in {t_init:.1f} s "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB)")
    out = dict(init_s=t_init, n_params=model.n_params(),
               weights_gb=torch.cuda.memory_allocated() / 1e9)
    # (a) one request with its patch embeddings
    rng = np.random.default_rng(V1_SEED)
    n_p, S = cfg.n_patches, cfg.n_patches + V1_TEXT
    pe = torch.from_numpy(rng.standard_normal(
        (1, n_p, cfg.d_model), dtype=np.float32) * 0.02).to(dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S))).to(dev)
    max_seq = S + V1_DECODE
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    logits, state = model.prefill(params, toks, patch_embeds=pe,
                                  max_seq=max_seq)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    launches = launch_counts()
    if launches["flash_attention"] != cfg.n_layers or \
            launches["paged_attention"] or launches["tlb_sweep"]:
        fail(f"V1: the prefill launched {launches}; want {cfg.n_layers} "
             "flash launches")
    ie = torch.cat([pe.to(model.cdt),
                    params["embed"].to(model.cdt)[toks[:, n_p:]]], 1)
    logits_ie, state_ie = model.prefill(params, None, input_embeds=ie,
                                        max_seq=max_seq)
    if not torch.equal(logits, logits_ie) or any(
            not torch.equal(state[p][k], state_ie[p][k])
            for p in state for k in state[p]):
        fail("V1: the patch_embeds prefill and the input_embeds prefill of "
             "the same rows differ")
    del logits_ie, state_ie, ie
    if not bool(torch.isfinite(logits[0, -1]).all()):
        fail("V1: the prefill's last logits are not finite")
    tok = logits[:, -1, :cfg.vocab].argmax(-1)
    gen, dec_s, first_row = [int(tok)], [], None
    for i in range(V1_DECODE):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lg, state = model.decode_step(params, state, tok[:, None],
                                      torch.tensor([S + i], device=dev))
        torch.cuda.synchronize()
        dec_s.append(time.perf_counter() - t1)
        if first_row is None:
            first_row = lg[0, 0, :cfg.vocab].float()
        tok = lg[:, 0, :cfg.vocab].argmax(-1)
        gen.append(int(tok))
    # the first decode step against the prefill of the prompt and its token
    lg1, _ = model.prefill(params, torch.cat([toks, torch.tensor(
        [[gen[0]]], device=dev)], 1), patch_embeds=pe)
    want = lg1[0, -1, :cfg.vocab].float()
    step_err = float((first_row - want).abs().max())
    best = int(want.argmax())
    lead = float(want[best] - want[gen[1]])
    if best != gen[1] and lead > DENSE_MARGIN:
        fail(f"V1: the first decode step's token {gen[1]} trails the "
             f"extended prefill's top-1 {best} by {lead:.4g} > "
             f"{DENSE_MARGIN}")
    print(f"one request, {n_p} patch embeddings + {V1_TEXT} text tokens: "
          f"prefill {prefill_s:.3f} s ({cfg.n_layers} flash launches at H "
          f"{cfg.n_heads} / KVH {cfg.n_kv_heads}), logits and cache equal "
          f"bit for bit to the input_embeds prefill of the same rows; "
          f"{V1_DECODE} greedy decode steps, median "
          f"{statistics.median(dec_s) * 1e3:.2f} ms, tokens {gen}; the "
          f"first step's logits within {step_err:.4g} of the extended "
          f"prefill's last row (its top-1 "
          + ("equal)" if best == gen[1] else f"{best}, ahead by {lead:.4g} "
             f"<= {DENSE_MARGIN})"))
    out.update(prefill_s=prefill_s, prefill_launches=launches,
               decode_s=dec_s, decode_median_s=statistics.median(dec_s),
               tokens=gen, first_step_vs_prefill=dict(
                   max_abs_err=step_err, top1_equal=best == gen[1]))
    del logits, state, lg, lg1, pe, toks, first_row, want
    torch.cuda.empty_cache()
    out["flash_layer"] = timing = flash_timing(
        torch, dev, (1, S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim), True,
        flush)
    print_flash_timing(f"one LLaVA layer's prefill attention (B, S, H, KVH, "
                       f"D) = {(1, S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)}, bf16, causal",
                       timing)
    # (b) text-only requests through the engine (it takes no patches)
    from repro_torch.kernels.paged_attention import ops as pa_ops
    eng = ServingEngine(model, params, EngineConfig(**V1_ENGINE), device=dev)
    probe = EngineProbe(model, eng)
    eng.model = probe
    requests = family_requests(cfg.vocab)[:V1_REQUESTS]
    for p, n_new in requests:
        eng.add_request(p, max_new_tokens=n_new)
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.time()
    m = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.time() - t1
    counts = launch_counts()
    pre = [t for _, t in probe.prefill_s]
    by_class = {str(k): n for k, n in pa_ops.CLASS_LAUNCHES.items()}
    print(f"engine: prompts {[len(p) for p, _ in requests]}, answers "
          f"{[n for _, n in requests]} (S3's, capped at {M_ANSWER_CAP}); "
          f"wall {wall:.2f} s, {m['steps']} steps, K={m['K']}, descriptor "
          f"reduction {m['descriptor_reduction']:.4f}, stalled "
          f"{m['stalled']}; launches {counts}, paged by class {by_class}; "
          f"{len(pre)} prefills {sum(pre):.3f} s, decode steps median "
          f"{statistics.median(probe.decode_s) * 1e3:.2f} ms")
    if m["stalled"] or [len(eng.requests[i].generated)
                        for i in range(len(requests))] != [
                            n for _, n in requests]:
        fail("V1: not every request finished with all its tokens")
    if counts["flash_attention"] != cfg.n_layers * len(pre) or \
            counts["paged_attention"] < 1 or counts["tlb_sweep"]:
        fail(f"V1: {len(pre)} prefills and the decode steps launched "
             f"{counts}")
    if not any(int(k) >= 1 and n > 0 for k, n in by_class.items()):
        fail("V1: the paged kernel did not run a class k >= 1")
    step = max(probe.steps, key=lambda s: (int((s["lens"] > 0).sum()),
                                           int(s["lens"].sum())))
    try:
        tp = time_class_passes(step, eng.state["pos0"]["pool_k"][0],
                               eng.state["pos0"]["pool_v"][0], cfg.n_heads,
                               flush)
    except ValueError as e:
        fail(f"V1 class passes at G = {cfg.n_heads // cfg.n_kv_heads}: {e}")
    print_class_passes(f"an engine step, G = {cfg.n_heads // cfg.n_kv_heads}"
                       f" (H {cfg.n_heads} over KVH {cfg.n_kv_heads})", tp)
    reqs = [eng.requests[i] for i in range(len(requests))]
    out.update(engine=dict(
        wall_s=wall, steps=m["steps"], K=m["K"],
        descriptor_reduction=m["descriptor_reduction"], launches=counts,
        launches_by_class=by_class, prefills=len(pre),
        prefill_s=sum(pre), decode_step_median_s=statistics.median(
            probe.decode_s), prompt_lens=[len(p) for p, _ in requests],
        answer_lens=[n for _, n in requests]), paged_layer=tp)
    del eng, probe
    gc.collect()
    torch.cuda.empty_cache()
    out["dense_check"] = batched_dense_check(dev, model, params, reqs, "V1")
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"peak device memory over the phase {out['peak_memory_gb']:.2f} "
          f"GB ({time.time() - t0:.1f} s in all)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The chaos rows, R1-R5: the robustness harness on the card (the checks
# and the serving helper also run on the CPU in the tests)
# ---------------------------------------------------------------------------

def check_no_rung(where: str, stats: dict) -> None:
    """Fail where a ``run_sweep``'s stats show a rung of the recovery
    ladder: only R2's injected runs may take one."""
    if stats["bisections"] or stats["oracle_fallbacks"]:
        fail(f"{where}: run_sweep took the recovery ladder ({stats})")


def _same_bits(a, b) -> bool:
    import numpy as np
    return (all(getattr(a, f) == getattr(b, f) for f in CELL_FIELDS)
            and a.coverage_mean == b.coverage_mean
            and np.array_equal(a.ppn, b.ppn))


def check_parity_sweeps(sweeps, ref: dict) -> int:
    """R1: ``chaos.parity_sweeps``' runs against the fixture's parity part:
    each world's digests and fault schedule, then every cell (spec, name,
    counters, coverage, ppn digest; tolerance 0), every translation the
    live mapping's, and ``ecc`` equal to fault-free bit for bit.  Returns
    the cells checked; raises ``ValueError`` on a difference."""
    import numpy as np
    if [sw["scenario"] for sw in sweeps] != [w["scenario"]
                                              for w in ref["worlds"]]:
        raise ValueError("the parity worlds differ from the fixture's")
    n = 0
    for sw, wrec in zip(sweeps, ref["worlds"]):
        name = sw["scenario"]
        want = dict(wrec)
        faults = want.pop("faults")
        if world_record(name, sw["data"]) != want:
            raise ValueError(f"{name}: the world differs from the JAX one")
        if [list(f) for f in sw["world"].faults] != faults:
            raise ValueError(f"{name}: fault schedule {sw['world'].faults}, "
                             f"JAX {faults}")
        recs = [c for c in ref["cells"] if c["scenario"] == name]
        res = sw["result"]
        if len(recs) != len(sw["cells"]):
            raise ValueError(f"{name}: {len(sw['cells'])} cells, JAX "
                             f"{len(recs)}")
        want_ppn = world_translations(sw["data"].world, sw["data"].trace)
        for c, r, rec in zip(sw["cells"], res, recs):
            what = f"{name}/{r.name}/{rec['policy']}"
            spec = json.loads(json.dumps(dataclasses.asdict(c.spec)))
            if spec != rec["spec"]:
                raise ValueError(f"{what}: spec differs from the JAX one")
            check_against_record(r, rec, what)
            if not np.array_equal(r.ppn, want_ppn):
                raise ValueError(f"{what}: a translation is not the live "
                                 "mapping's")
            n += 1
        k = len(sw["specs"])
        for j, s in enumerate(sw["specs"]):
            if not _same_bits(res[k + j], res[2 * k + j]):
                raise ValueError(f"{name}/{s.name}: ecc differs from the "
                                 "fault-free run")
    return n


def check_serve_fixture(runs: dict, ref: dict) -> None:
    """R4: each run of ``chaos.serve_runs`` against the fixture's serve
    part: the generated tokens and the report's counts; raises
    ``ValueError`` on a difference."""
    for kind, want in ref["runs"].items():
        got = runs[kind]
        out = [got["outputs"][rid] for rid in sorted(got["outputs"])]
        if out != want["outputs"]:
            raise ValueError(f"{kind}: tokens {out}, the JAX engine's "
                             f"{want['outputs']}")
        rep = {k: got["report"][k] for k in want["report"]}
        if rep != want["report"]:
            raise ValueError(f"{kind}: report {rep}, the JAX engine's "
                             f"{want['report']}")


def faulted_serve(model, params, engine_kw, requests, plans, ckpt_root,
                  device, max_steps, snapshot_every):
    """R5's runs: ``chaos.serve_runs`` over ``plans``, each engine behind
    an :class:`EngineProbe` that keeps the f32 logits row behind every
    generated token and each decode step's classes K, snapshot and restore
    timed on the host clock (ending in a synchronise).  Returns ``{kind:
    dict(outputs, report, wall_s, logits, K, save_s, restore_s,
    snapshot_bytes, decode_s, prefill_s)}``."""
    import torch
    from repro_torch.checkpoint.checkpointer import leaf_paths
    from repro_torch.robustness import chaos
    from repro_torch.serve import EngineConfig, ServingEngine

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    recs = {}

    def on_run(kind):
        recs[kind] = dict(logits={}, steps=[], prefill_s=[], decode_s=[],
                          save_s=[], restore_s=[], snapshot_bytes=0)

    def rec():
        """The record of the run under way (the last one begun)."""
        return recs[next(reversed(recs))]

    class TimedEngine(ServingEngine):
        def snapshot(self, ckpt_dir, step=None):
            sync()
            t = time.perf_counter()
            step = super().snapshot(ckpt_dir, step)
            rec()["save_s"].append(time.perf_counter() - t)
            rec()["snapshot_bytes"] = sum(x.numel() * x.element_size()
                                          for _, x in leaf_paths(self.state))
            return step

        def restore(self, ckpt_dir, step=None):
            t = time.perf_counter()
            step = super().restore(ckpt_dir, step)
            sync()
            rec()["restore_s"].append(time.perf_counter() - t)
            return step

    def make_engine():
        r = rec()
        eng = TimedEngine(model, params, EngineConfig(**engine_kw),
                          device=device)
        probe = EngineProbe(model, eng, keep_logits=True)
        probe.logits, probe.steps = r["logits"], r["steps"]
        probe.prefill_s, probe.decode_s = r["prefill_s"], r["decode_s"]
        eng.model = probe
        return eng

    runs = chaos.serve_runs(make_engine, requests, plans, ckpt_root,
                            max_steps, snapshot_every, sync, on_run)
    for kind, run in runs.items():
        ks = []
        for st in recs[kind].pop("steps"):
            if not ks or ks[-1] != list(st["K"]):
                ks.append(list(st["K"]))
        run.update(recs[kind], K=ks)
    return runs


def hold_faulted_row(base: dict, row: dict, vocab: int, exact: bool,
                     margin: float = R5_MARGIN, atol: float = LOGIT_ATOL
                     ) -> dict:
    """A faulted run of :func:`faulted_serve` against the fault-free one.
    ``exact``: the tokens and every logits row equal bit for bit.  Else
    S2's rule: each token equal wherever the fault-free top-1 leads its
    top-2 by more than ``margin`` (a request that differs at a near-tie
    is left out from there on, and counted), and each logits row within
    ``atol`` of the fault-free one while the tokens agree.  Returns the
    counts; raises ``ValueError`` on a difference."""
    import numpy as np
    out = dict(checked=0, left_out=0, diverged=[], max_abs_err=0.0)
    if row["outputs"].keys() != base["outputs"].keys():
        raise ValueError("the faulted run served other requests")
    if exact:
        if row["outputs"] != base["outputs"]:
            raise ValueError("tokens differ from the fault-free run's")
        if row["logits"].keys() != base["logits"].keys():
            raise ValueError("logits kept for other tokens")
        for key, want in base["logits"].items():
            if row["logits"][key].tobytes() != want.tobytes():
                raise ValueError(f"request {key[0]} token {key[1]}: logits "
                                 "differ from the fault-free run's bits")
        out["checked"] = len(base["logits"])
        return out
    for rid, want in base["outputs"].items():
        got = row["outputs"][rid]
        if len(got) != len(want):
            raise ValueError(f"request {rid}: {len(got)} tokens, the "
                             f"fault-free run {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            ref_row = base["logits"][(rid, i)][:vocab]
            second, first = np.partition(ref_row, -2)[-2:]
            if g != w:
                if first - second > margin:
                    raise ValueError(
                        f"request {rid} token {i}: {g}, the fault-free "
                        f"run's {w} (top-1 lead {first - second:.4g} > "
                        f"{margin})")
                out["left_out"] += len(want) - i
                out["diverged"].append(rid)
                break
            err = float(np.abs(row["logits"][(rid, i)][:vocab]
                               - ref_row).max())
            out["max_abs_err"] = max(out["max_abs_err"], err)
            if err > atol:
                raise ValueError(f"request {rid} token {i}: logits differ "
                                 f"from the fault-free run's by {err:.3g} "
                                 f"> {atol}")
            out["checked"] += 1
    return out


def r5_plans():
    """R5's faulted runs, ``[(kind, plan, snapshot_every)]``: a crash, KV
    corruption and page loss (seed 1908); the fault-free run that
    ``chaos.serve_runs`` puts first snapshots every ``R5_MAX_STEPS``."""
    from repro_torch.robustness import (EngineCrash, FaultPlan,
                                        KVCorruption, PageLoss)
    from repro_torch.robustness.chaos import CHAOS_SEED
    return [
        ("engine-crash", FaultPlan(CHAOS_SEED, (EngineCrash(R5_CRASH),)),
         R5_SNAPSHOT_EVERY),
        ("kv-corruption", FaultPlan(CHAOS_SEED, (KVCorruption(*R5_KV),)),
         R5_MAX_STEPS),
        ("page-loss", FaultPlan(CHAOS_SEED, (PageLoss(*R5_LOSS),)),
         R5_MAX_STEPS)]


def chaos_phases(torch, np, dev, model32, params32):
    """Phase R (R1-R5), the robustness harness on the card; ``model32`` /
    ``params32`` are S2's full-width f32 model and weights.  Returns the
    numbers for ``chip_smoke.json``, with each row's launch counts."""
    import shutil
    import warnings
    from repro_torch.robustness import chaos
    ref = json.load(open(CHAOS_REF_JSON))
    out, launches = {}, {}

    def print_rows(rows):
        for r in rows:
            print(f"  {r['fault']:16s} {r['scenario']:14s} {r['cell']:28s} "
                  f"{r['status']:9s} {r['detail']}")
        lost = [r for r in rows if r["status"] != "recovered"]
        if lost:
            fail(f"rows not recovered: {lost}")

    # --------------------------------------------------------- R1. parity
    t0 = phase(f"R1. TLB parity faults at bench size: mt-serve-mix and "
               f"nested-vm-mix, 2^15 pages, {R_TRACE_LEN:,} accesses, 3 "
               "flips; Base / COLT / |K|=3 x parity / ecc / fault-free")
    torch.cuda.synchronize()
    reset_counts()
    sweeps = chaos.parity_sweeps(R_TRACE_LEN, R_MAX_PAGES, dev)
    torch.cuda.synchronize()
    launches["R1"] = launch_counts()
    try:
        n = check_parity_sweeps(sweeps, ref["parity"])
    except ValueError as e:
        fail(f"R1: {e}")
    for sw in sweeps:
        check_no_rung(f"R1 {sw['scenario']}", sw["result"].stats)
    n_batches = sum(sw["result"].stats["n_batches"] for sw in sweeps)
    if launches["R1"] != dict(tlb_sweep=n_batches, tlb_records=n_batches,
                              paged_attention=0, flash_attention=0):
        fail(f"R1: launches {launches['R1']}, want {n_batches} of the TLB "
             "kernel and of the record kernel only")
    rows = chaos.parity_rows(sweeps)
    print(f"{n} cells equal to the JAX fixture (counters, coverage, ppn "
          f"sha256), every translation the live mapping's, ecc == "
          f"fault-free bit for bit; launches {launches['R1']}; run_sweep "
          f"walls {[sw['result'].stats['wall_s'] for sw in sweeps]} s")
    print_rows(rows)
    out["r1"] = dict(rows=rows, cells=n, faults={
        sw["scenario"]: [list(f) for f in sw["world"].faults]
        for sw in sweeps}, wall_s=time.time() - t0)
    del sweeps

    # ---------------------------------------------------------- R2. ladder
    t0 = phase("R2. the recovery ladder on the card: one injected launch "
               "failure (bisection), a cursed cell (the oracle)")
    reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        b = chaos.backend_sweeps(R_TRACE_LEN, R_MAX_PAGES, dev)
    torch.cuda.synchronize()
    launches["R2"] = launch_counts()
    (clean, n_clean, _), (bis, n_bis, inj_bis), (orc, n_orc, inj_orc) = \
        b["clean"], b["bisection"], b["oracle"]
    check_no_rung("R2 clean", clean.stats)
    if not (bis.stats["bisections"] >= 1
            and bis.stats["oracle_fallbacks"] == 0 and inj_bis == 1):
        fail(f"R2: one injected failure gave {bis.stats}, {inj_bis} "
             "injected; want bisections >= 1 and no oracle fallback")
    if not (orc.stats["bisections"] >= 1
            and orc.stats["oracle_fallbacks"] == 1):
        fail(f"R2: the cursed cell gave {orc.stats}; want one oracle "
             "fallback")
    for res, what in ((bis, "bisection"), (orc, "oracle")):
        for r, c in zip(res, clean):
            if not _same_bits(r, c):
                fail(f"R2 {what}: {r.name} differs from the clean run")
    if not (n_clean >= 1 and n_bis > n_clean and n_orc >= 1
            and launches["R2"]["tlb_sweep"] == n_clean + n_bis + n_orc
            and launches["R2"]["tlb_records"] == n_clean + n_bis + n_orc):
        fail(f"R2: launches clean {n_clean}, bisection {n_bis}, oracle "
             f"{n_orc}, in all {launches['R2']}: the re-launches do not "
             "show")
    for w in caught:
        if issubclass(w.category, RuntimeWarning):
            print(f"  warning: {w.message}")
    rows = chaos.backend_rows(b)
    print(f"both runs equal the clean run bit for bit; TLB launches clean "
          f"{n_clean}, one failure {n_bis}, cursed cell {n_orc}")
    print_rows(rows)
    out["r2"] = dict(rows=rows, launches=dict(clean=n_clean, bisection=n_bis,
                                              oracle=n_orc),
                     stats=dict(bisection=bis.stats, oracle=orc.stats),
                     wall_s=time.time() - t0)
    del b

    # ----------------------------------------------------------- R3. cache
    t0 = phase("R3. sweep-cache corruption: truncate, garbage, schema")
    reset_counts()
    c = chaos.cache_sweeps(R_TRACE_LEN, R_MAX_PAGES, dev)
    torch.cuda.synchronize()
    launches["R3"] = launch_counts()
    check_no_rung("R3 first", c["first"].stats)
    check_no_rung("R3 again", c["again"].stats)
    again = c["again"]
    if again.stats["cache_quarantined"] != 3 or not all(
            _same_bits(a, f) for a, f in zip(again, c["first"])):
        fail(f"R3: {again.stats}; want 3 entries quarantined and the "
             "results equal")
    rows = chaos.cache_rows(c)
    print(f"3 entries quarantined and recomputed, results equal; launches "
          f"{launches['R3']}")
    print_rows(rows)
    out["r3"] = dict(rows=rows, stats=again.stats, wall_s=time.time() - t0)
    del c

    # ---------------------------------------- R4. the reference's serve rows
    t0 = phase("R4. the chaos bench's serve rows on the card (reduced "
               "InternLM2-1.8B, f32) vs the JAX fixture")
    make_engine, cfg = chaos.tiny_engine_factory(dev)
    requests = chaos.serve_requests(cfg.vocab)
    if [[list(p), n] for p, n in requests] != ref["serve"]["requests"]:
        fail("R4: the requests differ from the fixture's")
    torch.cuda.synchronize()
    reset_counts()
    ckpt_root = os.path.join(HERE, "build", "ckpt_r4")
    runs = chaos.serve_runs(make_engine, requests, chaos.serve_plans(),
                            ckpt_root)
    shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.synchronize()
    launches["R4"] = launch_counts()
    try:
        check_serve_fixture(runs, ref["serve"])
    except ValueError as e:
        fail(f"R4: {e}")
    if not (launches["R4"]["flash_attention"] >= 1
            and launches["R4"]["paged_attention"] >= 1
            and launches["R4"]["tlb_sweep"] == 0):
        fail(f"R4: launches {launches['R4']}")
    rows = chaos.serve_rows(runs)
    print(f"every run's tokens and report counts equal the JAX engine's; "
          f"launches {launches['R4']}")
    print_rows(rows)
    out["r4"] = dict(rows=rows, reports={k: {x: v for x, v in
                                             r["report"].items()
                                             if x != "metrics"}
                                         for k, r in runs.items()},
                     wall_s=time.time() - t0)
    del make_engine, runs

    # ------------------------------------------------------ R5. full width
    t0 = phase(f"R5. InternLM2-1.8B at full width, f32: S3's first "
               f"{R5_REQUESTS} requests (answers capped at {M_ANSWER_CAP}) "
               f"through a crash at step {R5_CRASH}, KV corruption at step "
               f"{R5_KV[0]} and page loss at step {R5_LOSS[0]}")
    vocab = model32.cfg.vocab
    requests = [(p, min(n, M_ANSWER_CAP))
                for p, n in s3_requests(vocab)[:R5_REQUESTS]]
    gc.collect()
    torch.cuda.synchronize()
    reset_counts()
    ckpt_root = os.path.join(HERE, "build", "ckpt_r5")
    runs = faulted_serve(model32, params32, R5_ENGINE, requests, r5_plans(),
                         ckpt_root, dev, R5_MAX_STEPS, R5_MAX_STEPS)
    shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.synchronize()
    launches["R5"] = launch_counts()
    gc.collect()
    base = runs["baseline"]
    checks = {}
    try:
        for kind in ("engine-crash", "kv-corruption", "page-loss"):
            checks[kind] = hold_faulted_row(base, runs[kind], vocab,
                                            exact=kind == "engine-crash")
    except ValueError as e:
        fail(f"R5 {kind}: {e}")
    rep = {k: r["report"] for k, r in runs.items()}
    if rep["engine-crash"]["restarts"] != 1:
        fail(f"R5: the crash row restarted {rep['engine-crash']['restarts']}"
             " times")
    if rep["kv-corruption"]["preempted"] < 1:
        fail("R5: KV corruption preempted no request")
    if rep["page-loss"]["pages_lost"] < 1:
        fail("R5: no page was lost")
    if not (launches["R5"]["flash_attention"] >= 1
            and launches["R5"]["paged_attention"] >= 1
            and launches["R5"]["tlb_sweep"] == 0):
        fail(f"R5: launches {launches['R5']}")
    rows = []
    for kind, run in runs.items():
        r = run["report"]
        print(f"{kind}: engine wall {run['wall_s']:.2f} s, {r['steps']} "
              f"steps, crashes {r['crashes']}, preempted {r['preempted']}, "
              f"kv corrupted {r['kv_corrupted']}, pages lost "
              f"{r['pages_lost']}; K over the run {run['K']}; "
              f"{len(run['save_s'])} snapshots of "
              f"{run['snapshot_bytes'] / 1e9:.3f} GB, save "
              f"{[round(x, 3) for x in run['save_s']]} s, restore "
              f"{[round(x, 3) for x in run['restore_s']]} s; "
              f"{len(run['prefill_s'])} prefills, decode median "
              f"{statistics.median(run['decode_s']) * 1e3:.2f} ms")
        if kind == "baseline":
            continue
        ch = checks[kind]
        print(f"  vs fault-free: " + (
            f"tokens and all {ch['checked']} logits rows equal bit for bit"
            if kind == "engine-crash" else
            f"{ch['checked']} tokens equal with logits within "
            f"{LOGIT_ATOL} (max abs err {ch['max_abs_err']:.3g}), "
            f"{ch['left_out']} left out past a near-tie "
            f"(requests {ch['diverged']})"))
        rows.append({"fault": kind, "scenario": "internlm2-1.8b",
                     "cell": f"{len(requests)} reqs", "status": "recovered",
                     "detail": (f"crashes={r['crashes']} "
                                f"preempted={r['preempted']} "
                                f"pages_lost={r['pages_lost']} "
                                f"wall={run['wall_s']:.1f}s")})
    print(f"launches {launches['R5']}")
    print_rows(rows)
    out["r5"] = dict(
        rows=rows, checks=checks,
        runs={k: dict(report={x: v for x, v in r["report"].items()
                              if x != "metrics"},
                      wall_s=r["wall_s"], K=r["K"], save_s=r["save_s"],
                      restore_s=r["restore_s"],
                      snapshot_bytes=r["snapshot_bytes"],
                      prefills=len(r["prefill_s"]),
                      decode_median_s=statistics.median(r["decode_s"]),
                      outputs=r["outputs"])
              for k, r in runs.items()},
        wall_s=time.time() - t0)
    del runs, base
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def _eleven_specs(b):
    return [b.base_spec(), b.thp_spec(), b.colt_spec(), b.cluster_spec(),
            b.rmm_spec(), b.anchor_spec(6), b.kaligned_spec([9, 6, 4]),
            b.kaligned_spec([6, 4], use_predictor=False, name="ka-nopred"),
            b.subregion_spec(), b.cache_tlb_spec(), b.dead_protect_spec()]


def _small_dynamic(tc, np):
    pt = tc.page_table
    n = 1 << 10
    dyn = pt.build_dynamic_mapping(
        np.arange(n, dtype=np.int64) + 7,
        [(150, [pt.MappingEvent("remap", 0, 128, ppn=100_000)]),
         (370, [pt.MappingEvent("split", 128, 64, ppn=np.arange(
             200_000, 200_000 + 64 * 3, 3)),
                pt.MappingEvent("unmap", 768, 32)])], name="hot")
    return dyn, np.random.default_rng(3).integers(0, 512, size=520)


def _small_multitenant(tc, np):
    pt = tc.page_table
    n = 1 << 10
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
    return mt, np.concatenate(parts).astype(np.int64)


def small_worlds(tc, SweepCell, np):
    """A small dynamic world (``build_dynamic_mapping``) under both
    coherence policies and a small multi-tenant world
    (``build_multitenant_mapping``) under both context-switch policies,
    all 11 specs each — the worlds of ``tests/test_backends.py`` and
    ``tests/test_multitenant.py``."""
    specs = _eleven_specs(tc.baselines)
    dyn, dtr = _small_dynamic(tc, np)
    dyn_cells = [SweepCell(dataclasses.replace(s, coh_policy=p), dyn, dtr)
                 for p in ("shootdown", "hw-coherence") for s in specs]
    mt, mtr = _small_multitenant(tc, np)
    mt_cells = [SweepCell(dataclasses.replace(s, ctx_policy=p), mt, mtr)
                for p in ("flush", "tag") for s in specs]
    return dyn_cells, mt_cells


def edge_batches(tc, SweepCell, np):
    """Packed batches ``{name: (lanes, stacks, st0, seg_bounds)}`` (numpy)
    that pin the TLB kernel's probe-chain and victim rules against the
    plain version:

    * ``chain`` — K-aligned lanes whose probe order is unusual, on a
      small-contiguity mapping (hits land on every position, walks are
      frequent): pred = -1 at the start, pred outside
      kvals (also with a full kvals row, whose last entry is then never
      probed), duplicate classes with and without the predictor, kvals
      with -1 holes, classes probed smallest last (hits at the last
      position); regular hits come before the chain wherever a regular
      entry covers; a real lane with t_real = 0 beside them; THP, COLT,
      RMM and cluster lanes; and two lanes of kinds with no instance of
      their own (K-aligned with a range table, THP with the predictor),
      which the kernel runs through its general step;
    * ``short-lanes`` — the small dynamic world's 520 accesses cut to
      t_real = 100, 300 or 520 per lane: the short lanes' t_real falls
      before the shootdowns at t = 150 and 370, whose passes still run on
      their state before their padded steps; beside them two lanes of a
      100-access static trace, which end before the other lanes'
      boundaries;
    * ``small-l2`` — 4-set L2s of 2, 3 and 8 ways in a batch packed to 8
      ways (padded ways score BIG), on the multi-tenant world under both
      switch policies, so flushed ways tie at NEG and full rows evict by
      LRU every few accesses."""
    b = tc.baselines
    rep = dataclasses.replace
    out = {}

    m = tc.mappings.synthetic_mapping("small", 1 << 12, seed=1)
    tr = tc.traces.generate_trace("multiscale", 0, 600, seed=2, mapping=m)
    ka = b.kaligned_spec([9, 6, 4])
    wide = b.kaligned_spec([12, 10, 8, 4])
    specs = [rep(ka, name="pred=-1"), rep(ka, name="pred-outside"),
             rep(ka, name="dup", K=(6, 6, 4, 4)),
             rep(ka, name="dup-nopred", K=(6, 6, 4), use_predictor=False),
             rep(ka, name="holes"), rep(ka, name="holes-nopred",
                                        use_predictor=False),
             rep(wide, name="last-nopred", use_predictor=False),
             rep(wide, name="full-row-pred-outside"),
             rep(b.base_spec(), name="t_real=0"), b.thp_spec(),
             b.colt_spec(), b.rmm_spec(), b.cluster_spec(),
             rep(ka, name="ka+rmm", side="rmm"),
             rep(b.thp_spec(), name="thp+pred", use_predictor=True,
                 K=(9, 6, 4))]
    lanes, stacks, st0, sb = _pack(tc, [SweepCell(s, m, tr) for s in specs])
    lanes["pred0"][0] = -1
    lanes["pred0"][1] = 5
    lanes["pred0"][7] = 5
    for i in (4, 5):
        lanes["kvals"][i] = [-1, 9, -1, 4]
    lanes["t_real"][8] = 0
    out["chain"] = (lanes, stacks, st0, sb)

    dyn, dtr = _small_dynamic(tc, np)
    cells = [SweepCell(rep(s, coh_policy=p), dyn, dtr)
             for p in ("shootdown", "hw-coherence")
             for s in _eleven_specs(b)]
    cells += [SweepCell(s, m, tr[:100]) for s in (ka, b.base_spec())]
    lanes, stacks, st0, sb = _pack(tc, cells)
    lanes["t_real"][:22] = [100, 300, 520] * 7 + [100]
    out["short-lanes"] = (lanes, stacks, st0, sb)

    mt, mtr = _small_multitenant(tc, np)
    small = [rep(s, l2_sets=4, l2_ways=w, name=f"{s.name}/4x{w}")
             for s in (b.base_spec(), b.kaligned_spec([9, 6, 4]),
                       b.colt_spec(), b.thp_spec()) for w in (2, 3, 8)]
    out["small-l2"] = _pack(tc, [SweepCell(rep(s, ctx_policy=p), mt, mtr)
                                 for p in ("flush", "tag") for s in small])
    return out


def _pack(tc, cells):
    """``pack_batch`` with every lane array copied, so the caller may edit
    them."""
    lanes, stacks, st0, sb = tc.sweep.pack_batch(cells)
    return {k: v.copy() for k, v in lanes.items()}, stacks, st0, sb


if __name__ == "__main__":
    sys.exit(main())
