// The batched TLB sweep as a CUDA kernel for Hopper (sm_90a).
//
// Replaces src/repro/kernels/tlb_sweep/tlb_sweep.py::_tlb_sweep_kernel of
// the JAX package (a Pallas kernel over a (lanes, blocks) grid that keeps
// each lane's TLB state in VMEM scratch and streams trace blocks in).
//
// What it computes: for every lane, starting from a fresh TLB state
// (tlb_lane.cuh init_word; pred and ASID from the params row), walk the
// segments of seg_bounds; at each segment entry s > 0 run the context
// switch (WITH_SWITCH batches only) and then the coherence shootdown
// (where the lane's seg_shoot flag is set); then run lane_step for every
// t of the segment, active while t < t_real.  Outputs: ppn [L, T] in trace
// order, counters [L, 9], cov_samples [L, 64], and the clock64() cycles
// each lane's block took, [L] int64.
//
// What bounds it: each lane is one serial dependency chain over its trace
// (every access reads the state the previous one wrote), so time is the
// latency of ~1.5 * 10^5 dependent steps on the slowest lane, and not bytes
// or operations: the Table 4 batch moves about half a gigabyte of records
// and needs ~10^8 int32 operations, a few hundredths of a millisecond at
// the card's rates.  On that batch every real lane has the same 150,000
// accesses, so the lane whose step is longest sets the kernel's time: the
// K-aligned lanes with the predictor, whose step runs the aligned-probe
// chain beside the regular probe and both victim scans.  A lane is one
// warp on its own SM, so nothing hides the step's dependent latencies; the
// floor of a step is one dependent shared-memory load -> compare -> store
// round (tlb_round_kernel below measures it on the card), and a step's
// length is its instruction count times the latency between them.
//
// What the design does about it:
//  * one 32-thread block per lane, the lane's whole state (L1, 2MB L1, L2,
//    RMM, cluster TLB, cache-backed tier, dead-entry table, ~70 KB at the
//    default geometry) in dynamic shared memory for the whole trace, so a
//    probe is a shared-memory read; lanes run in parallel on separate SMs;
//  * a step runs across the warp (tlb_lane.cuh lane_step with WarpDev):
//    each thread tests its own way or entry of every structure at once,
//    "first way that matches" is a ballot and __ffs, "first least score"
//    is __reduce_min_sync then a ballot, and the aligned-probe chain is
//    one min-reduction over (position, way) instead of up to maxk
//    sequential W-way probes.  Every victim scan runs beside the probes,
//    before the step knows whether its fill happens, and each way's test
//    loads all its fields before it compares, so no shared load waits on
//    another.  Structures wider than the warp (L2 or cache-tier ways > 32)
//    are refused by the wrapper (ops.prepare_cuda), not looped;
//  * the lane loop is compiled once per kind of lane (TLB_FEAT_CASES), so
//    a lane runs only its own structures' code, with no per-step dispatch
//    (dispatching per step cost a sixth more time); a lane of any other
//    kind runs the FT_ALL step in a second kernel launched beside the
//    first, so that large instance does not take the others' registers.
//    __launch_bounds__(32, 1) lets every instance keep everything in
//    registers (no stack frame, no spills);
//  * the scalars carried between steps (t, pred, ASID, counters) live in
//    registers, uniform across the warp, and go to shared memory only
//    around the segment-entry passes;
//  * records are streamed ahead: the trace and the (map, fill, cluster)
//    records of a step depend only on the trace and the segment's record
//    ids, never on the TLB state, so after every 32 steps each thread
//    copies one step of the batch three ahead from device memory into a
//    128-step shared-memory ring with cp.async (no registers held); the
//    step reads its record from the ring (the next step's while this one
//    runs), and no gather from device memory is on the chain.  The ppns
//    of real steps are kept one per thread and stored once per 32 steps;
//  * padded steps (t >= t_real) write nothing but their ppn, so they are
//    taken off the chain: after a segment's real steps, each thread
//    evaluates one padded step of every 32 read-only (the same lane_step,
//    with WarpSerial standing for the warp) against the state as the
//    segment left it;
//  * the switch and shootdown passes split every structure's entries over
//    the warp and sum their shares with __reduce_add_sync.
#include <cuda_runtime.h>
#include <stddef.h>

#include "tlb_lane.cuh"

#define TLB_THREADS WARP  // one warp per lane
#define RING 128          // ring slots: four batches of 32 steps
#define REC_W 11          // ring fields: vpn, map record, fill record, word
#define FULL_MASK 0xffffffffu

// The warp of lane_step on the card: thread `me` is way thread `me`.
// Threads past the structure's n ways evaluate way n - 1 again (no
// branch) and are masked out of the vote or reduction.
struct WarpDev {
  int me;
  TLB_HD int way(int n) const { return imax(imin(me, n - 1), 0); }
  template <class F>
  TLB_HD unsigned ballot(int n, F f) const {
#ifdef __CUDA_ARCH__
    const unsigned m = __ballot_sync(FULL_MASK, f(way(n)));
    return n >= WARP ? m : m & ((1u << n) - 1u);
#else
    return 0;  // device only
#endif
  }
  template <class F>
  TLB_HD int min(int n, F f) const {
#ifdef __CUDA_ARCH__
    const int v = f(way(n));
    return __reduce_min_sync(FULL_MASK, me < n ? v : 0x7fffffff);
#else
    return 0;
#endif
  }
  template <class F>
  TLB_HD int first_min(int n, F f) const {
#ifdef __CUDA_ARCH__
    const int fv = f(way(n));
    const int v = me < n ? fv : 0x7fffffff;
    const int m = __reduce_min_sync(FULL_MASK, v);
    return first_set(__ballot_sync(FULL_MASK, me < n && v == m));
#else
    return 0;
#endif
  }
  TLB_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
};

struct SweepArgs {
  const int* params;      // [L, N_PARAM_FIELDS]
  const int* kvals;       // [L, maxk]
  const int* segs;        // [N_SEG_PLANES, L, n_segs]
  const int* seg_bounds;  // [n_segs + 1]
  const int* trace_id;    // [L]
  const int* trace;       // [n_tr, T]
  const int* maps;        // [R, P, MAP_W]
  const int* fills;       // [R', P, FILL_W]
  const int* clus;        // [R'', Pc]
  const int* dirty;       // [R''', P + 1]
  int* ppn;               // [L, T]
  int* counters;          // [L, N_COUNTERS]
  int* cov;               // [L, N_COV_SAMPLES]
  long long* cycles;      // [L]
  int L, maxk, n_segs, T, P, Pc;
  LaneGeom g;
};

// The record ids of one segment of one lane, and the stacks they name.
struct SegIds {
  int map, fill, clus;
};

struct SegRecs {
  const int *maps, *fills, *clus;
};

__device__ __forceinline__ SegIds seg_ids(const SweepArgs& a, int lane,
                                          int sg) {
  const int* seg = a.segs + (size_t)lane * a.n_segs + sg;
  const size_t plane = (size_t)a.L * a.n_segs;
  return SegIds{__ldg(seg + S_MAP * plane), __ldg(seg + S_FILL * plane),
                __ldg(seg + S_CLUS * plane)};
}

__device__ __forceinline__ SegRecs seg_recs(const SweepArgs& a, SegIds id) {
  return SegRecs{a.maps + (size_t)id.map * a.P * MAP_W,
                 a.fills + (size_t)id.fill * a.P * FILL_W,
                 a.clus + (size_t)id.clus * a.Pc};
}

__device__ __forceinline__ void gather(const SegRecs& sr, int Pc, int vpn,
                                       Rec& x) {
  x.vpn = vpn;
  const int* mp = sr.maps + (size_t)vpn * MAP_W;
  const int* fp = sr.fills + (size_t)vpn * FILL_W;
#pragma unroll
  for (int i = 0; i < MAP_W; ++i) x.m[i] = __ldg(mp + i);
#pragma unroll
  for (int i = 0; i < FILL_W; ++i) x.f[i] = __ldg(fp + i);
  x.bm = __ldg(sr.clus + iclip(vpn, 0, Pc - 1));
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// Copy one step's records from device memory into ring slot `slot` without
// passing through registers (cp.async; completed by ring_wait).  The ring
// keeps field f of slot i at ring[f * RING + i]: the 32 threads of a
// refill write 32 consecutive words per field.
__device__ __forceinline__ void ring_fetch(int* ring, int slot,
                                           const SegRecs& sr, int Pc,
                                           int vpn) {
  ring[slot] = vpn;
  const int* mp = sr.maps + (size_t)vpn * MAP_W;
  const int* fp = sr.fills + (size_t)vpn * FILL_W;
#pragma unroll
  for (int i = 0; i < MAP_W; ++i) cp_async4(ring + (1 + i) * RING + slot, mp + i);
#pragma unroll
  for (int i = 0; i < FILL_W; ++i)
    cp_async4(ring + (1 + MAP_W + i) * RING + slot, fp + i);
  cp_async4(ring + (REC_W - 1) * RING + slot, sr.clus + iclip(vpn, 0, Pc - 1));
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void ring_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ Rec ring_get(const int* ring, int slot) {
  Rec x;
  x.vpn = ring[slot];
#pragma unroll
  for (int i = 0; i < MAP_W; ++i) x.m[i] = ring[(1 + i) * RING + slot];
#pragma unroll
  for (int i = 0; i < FILL_W; ++i) x.f[i] = ring[(1 + MAP_W + i) * RING + slot];
  x.bm = ring[(REC_W - 1) * RING + slot];
  return x;
}

// One thread's side of the record stream: the segment of the last step it
// looked up (its steps only move forward) and that segment's record ids.
struct Feed {
  int sg, end;
  SegIds id;
};

__device__ __forceinline__ SegRecs feed_seek(Feed& fd, const SweepArgs& a,
                                             int lane, int t) {
  if (t >= fd.end) {
    while (t >= fd.end) {
      ++fd.sg;
      fd.end = __ldg(a.seg_bounds + fd.sg + 1);
    }
    fd.id = seg_ids(a, lane, fd.sg);
  }
  return seg_recs(a, fd.id);
}

// One lane from its fresh state to its last step, with the step compiled
// for the lane's kind (FEAT; tlb_lane.cuh TLB_FEAT_CASES).  Leaves the
// carried scalars in the state.
template <bool WITH_SWITCH, int FEAT>
__device__ __forceinline__ void run_lane(const SweepArgs& a, int lane,
                                         const LaneParams& q,
                                         const LaneState& s, int* ring) {
  const int me = threadIdx.x;
  const WarpDev wp{me};
  const LaneGeom g = a.g;
  const int t_real = q.t_real;
  const int* trace_row = a.trace + (size_t)__ldg(a.trace_id + lane) * a.T;
  int* ppn_row = a.ppn + (size_t)lane * a.T;
  LaneRegs r = lane_regs_load(s, q);

  // ring prologue: batches 0, 1 and 2 fetched, batch 3's vpns loaded; the
  // refill after batch j completes batch j + 2, fetches batch j + 3 and
  // loads the vpns of batch j + 4
  Feed fd{-1, 0, {0, 0, 0}};
  for (int b = 0; b < 3; ++b) {
    const int tp = b * TLB_THREADS + me;
    if (tp < t_real)
      ring_fetch(ring, tp & (RING - 1), feed_seek(fd, a, lane, tp), a.Pc,
                 __ldg(trace_row + tp));
  }
  int vnext = 3 * TLB_THREADS + me < t_real
                  ? __ldg(trace_row + 3 * TLB_THREADS + me) : 0;
  ring_wait();
  __syncwarp();

  Rec nxt;
  if (t_real > 0) nxt = ring_get(ring, 0);
  // ppn of the real steps: thread me keeps step (t & ~31) + me of the
  // current batch and the warp stores the batch at once, at its end or at
  // the end of the segment's real steps (`stored`: steps below are out)
  int mine = 0, stored = 0;
  for (int sg = 0; sg < a.n_segs; ++sg) {
    const int lo = __ldg(a.seg_bounds + sg), hi = __ldg(a.seg_bounds + sg + 1);
#define SEG(plane) __ldg(a.segs + ((size_t)(plane) * a.L + lane) * a.n_segs + sg)
    if (sg > 0) {
      // segment entry: context switch first, then the shootdown (the
      // reference's order); the passes read and write the state's copy
      // of the carried scalars
      lane_regs_store(r, s);
      __syncwarp();
      if (WITH_SWITCH) {
        const int new_asid = SEG(S_ASID);
        int n, loss;
        switch_share(g, s, new_asid, SEG(S_FALL) == 1, SEG(S_FASID) == 1, me,
                     TLB_THREADS, &n, &loss);
        n = __reduce_add_sync(FULL_MASK, n);
        loss = __reduce_add_sync(FULL_MASK, loss);
        __syncwarp();
        switch_charge(s, new_asid, SEG(S_SWITCH) == 1, n, loss);
        __syncwarp();
      }
      if (SEG(S_SHOOT) == 1) {
        const int* dc = a.dirty + (size_t)SEG(S_DIRTY) * (a.P + 1);
        int n, loss;
        shoot_share(q, g, s, dc, a.P, me, TLB_THREADS, &n, &loss);
        n = __reduce_add_sync(FULL_MASK, n);
        loss = __reduce_add_sync(FULL_MASK, loss);
        __syncwarp();
        shoot_charge(q, s, n, loss);
        __syncwarp();
      }
      r = lane_regs_load(s, q);
    }
#undef SEG
    // the real steps, in order, across the warp
    const int real_hi = imin(hi, t_real);
    for (int t = lo; t < real_hi; ++t) {
      const Rec x = nxt;
      if (t + 1 < t_real) nxt = ring_get(ring, (t + 1) & (RING - 1));
      const int out = lane_step<true, FEAT>(wp, q, g, s, r, x);
      if ((t & (TLB_THREADS - 1)) == me) mine = out;
      if ((t & (TLB_THREADS - 1)) == TLB_THREADS - 1 || t + 1 == real_hi) {
        const int tm = (t & ~(TLB_THREADS - 1)) + me;
        if (tm >= stored && tm <= t) ppn_row[tm] = mine;
        stored = t + 1;
      }
      if ((t & (TLB_THREADS - 1)) == TLB_THREADS - 1) {
        const int b = t / TLB_THREADS;
        ring_wait();  // batch b + 2, fetched a batch ago
        const int tp = (b + 3) * TLB_THREADS + me;
        if (tp < t_real)
          ring_fetch(ring, tp & (RING - 1), feed_seek(fd, a, lane, tp), a.Pc,
                     vnext);
        const int vt = (b + 4) * TLB_THREADS + me;
        vnext = vt < t_real ? __ldg(trace_row + vt) : 0;
        __syncwarp();
      }
    }
    // the padded steps, read-only, one per thread, against the state as
    // this segment's entry passes and real steps left it
    const int plo = imax(lo, t_real);
    if (plo < hi) {
      const SegRecs sr = seg_recs(a, seg_ids(a, lane, sg));
      const WarpSerial one{};
      for (int t = plo + me; t < hi; t += TLB_THREADS) {
        Rec x;
        gather(sr, a.Pc, __ldg(trace_row + t), x);
        ppn_row[t] = lane_step<false, FEAT>(one, q, g, s, r, x);
      }
    }
    __syncwarp();
  }
  lane_regs_store(r, s);
  __syncwarp();
}

// GENERAL = false runs the lanes whose kind has an instance of its own
// (tlb_lane.cuh feat_compiled), GENERAL = true the others, through the
// FT_ALL step; each skips the other's lanes.  Two kernels, so the large
// FT_ALL instance does not take the registers of the others.
template <bool WITH_SWITCH, bool GENERAL>
__global__ void __launch_bounds__(TLB_THREADS, 1) tlb_sweep_kernel(SweepArgs a) {
  extern __shared__ int smem[];
  const long long c0 = clock64();
  const int lane = blockIdx.x;
  const int me = threadIdx.x;
  const int* prow = a.params + (size_t)lane * N_PARAM_FIELDS;
  const int* kvrow = a.kvals + (size_t)lane * a.maxk;
  const LaneParams q = load_params(prow, kvrow, a.maxk);
  const int feat = lane_feat(q);
  if (feat_compiled(feat) == GENERAL) return;
  const LaneGeom g = a.g;
  const int words = lane_state_words(g);
  const LaneState s = carve_state(smem, g);
  int* ring = smem + words;  // [REC_W, RING]

  for (int i = me; i < words; i += TLB_THREADS) smem[i] = init_word(i, g);
  __syncwarp();
  if (me < N_CLASSES) s.ktab[me] = ktab_word(kvrow, a.maxk, me);
  if (me == 0) {
    s.misc[M_PRED] = __ldg(prow + F_PRED0);
    s.misc[M_ASID] = __ldg(prow + F_ASID0);
  }
  __syncwarp();

  if (GENERAL) {
    run_lane<WITH_SWITCH, FT_ALL>(a, lane, q, s, ring);
  } else {
    switch (feat) {
#define TLB_CASE(F)                                \
  case F:                                          \
    run_lane<WITH_SWITCH, F>(a, lane, q, s, ring); \
    break;
      TLB_FEAT_CASES(TLB_CASE)
#undef TLB_CASE
    }
  }

  for (int i = me; i < N_COUNTERS; i += TLB_THREADS)
    a.counters[(size_t)lane * N_COUNTERS + i] = s.cnt[i];
  for (int i = me; i < N_COV_SAMPLES; i += TLB_THREADS)
    a.cov[(size_t)lane * N_COV_SAMPLES + i] = s.cov[i];
  if (me == 0) a.cycles[lane] = clock64() - c0;
}

// The floor of a serial step, measured: one thread runs n rounds of a
// dependent shared-memory load -> compare -> store on one word (volatile,
// so every round goes through shared memory); out = {clock64 cycles of
// the n rounds, the final word}.
__global__ void tlb_round_kernel(int n, long long* out) {
  __shared__ int cell[1];
  volatile int* v = cell;
  v[0] = 0;
  const long long c0 = clock64();
  for (int i = 0; i < n; ++i) {
    const int x = v[0];
    v[0] = x == i ? x + 1 : x - 1;
  }
  const long long c1 = clock64();
  out[0] = c1 - c0;
  out[1] = v[0];
}

extern "C" {

// Dynamic shared memory one lane needs (state + the record ring).
int tlb_sweep_smem_bytes(int sets, int ways, int ctlb_sets, int ctlb_ways,
                         int dp_n) {
  LaneGeom g{sets, ways, ctlb_sets, ctlb_ways, dp_n};
  return (lane_state_words(g) + REC_W * RING) * (int)sizeof(int);
}

// Launch on `stream` (the kernel for the lanes of the compiled kinds, then
// the one for any other lane); returns cudaGetLastError() (0 on success).
// The kernels do not synchronise and allocate nothing.
int tlb_sweep_launch(const int* params, const int* kvals, const int* segs,
                     const int* seg_bounds, const int* trace_id,
                     const int* trace, const int* maps, const int* fills,
                     const int* clus, const int* dirty, int* ppn,
                     int* counters, int* cov, long long* cycles, int L,
                     int maxk, int n_segs, int T, int P, int Pc, int sets,
                     int ways, int ctlb_sets, int ctlb_ways, int dp_n,
                     int with_switch, void* stream) {
  SweepArgs a;
  a.params = params;
  a.kvals = kvals;
  a.segs = segs;
  a.seg_bounds = seg_bounds;
  a.trace_id = trace_id;
  a.trace = trace;
  a.maps = maps;
  a.fills = fills;
  a.clus = clus;
  a.dirty = dirty;
  a.ppn = ppn;
  a.counters = counters;
  a.cov = cov;
  a.cycles = cycles;
  a.L = L;
  a.maxk = maxk;
  a.n_segs = n_segs;
  a.T = T;
  a.P = P;
  a.Pc = Pc;
  a.g = LaneGeom{sets, ways, ctlb_sets, ctlb_ways, dp_n};
  const int smem = tlb_sweep_smem_bytes(sets, ways, ctlb_sets, ctlb_ways, dp_n);
  void (*kerns[2])(SweepArgs) = {
      with_switch ? tlb_sweep_kernel<true, false>
                  : tlb_sweep_kernel<false, false>,
      with_switch ? tlb_sweep_kernel<true, true>
                  : tlb_sweep_kernel<false, true>};
  for (auto kern : kerns) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<L, TLB_THREADS, smem, (cudaStream_t)stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// One thread of tlb_round_kernel on `stream`; `out` is two int64 words.
int tlb_round_launch(int n, long long* out, void* stream) {
  tlb_round_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(n, out);
  return (int)cudaGetLastError();
}

const char* tlb_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
