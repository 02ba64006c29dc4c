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
// (where the lane's seg_shoot flag is set); then run step_access for every
// t of the segment, active while t < t_real.  Outputs: ppn [L, T] in trace
// order, counters [L, 9], cov_samples [L, 64].
//
// What bounds it: each lane is one serial dependency chain over its trace
// (every access reads the state the previous one wrote), so time is
// latency — ~10^5 dependent steps of shared-memory probes and updates —
// and not bytes: the whole Table 4 batch moves about half a gigabyte of
// records, a fraction of a millisecond at the card's memory rate.
//
// What the design does about it: one thread block per lane, with the
// lane's whole state (L1, 2MB L1, L2, RMM, cluster TLB, cache-backed
// tier, dead-entry table, counters; ~70 KB at the default geometry) in
// dynamic shared memory for the whole trace, so a probe is a shared-memory
// read and nothing round-trips through device memory.  The step runs on
// one thread; the warp initialises the state and runs the switch and
// shootdown passes over every entry in parallel.  The records of access
// t+1 and the vpn of t+2 are loaded while access t runs, so the gathers
// from device memory stay off the chain.  Lanes run in parallel on
// separate SMs.  Unlike the Pallas kernel, it needs no block plan and no
// block-size cap: the trace is walked in order and ppn is written in
// trace order.
#include <cuda_runtime.h>
#include <stddef.h>

#include "tlb_lane.cuh"

#define TLB_THREADS 32  // one warp per lane

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
  int L, maxk, n_segs, T, P, Pc;
  LaneGeom g;
};

struct Rec {
  int m[MAP_W];
  int f[FILL_W];
  int bm;
};

__device__ __forceinline__ Rec load_rec(const int* mstack, const int* fstack,
                                        const int* cstack, int Pc, int vpn) {
  Rec r;
  const int* mp = mstack + (size_t)vpn * MAP_W;
  const int* fp = fstack + (size_t)vpn * FILL_W;
#pragma unroll
  for (int i = 0; i < MAP_W; ++i) r.m[i] = TLB_LDG(mp + i);
#pragma unroll
  for (int i = 0; i < FILL_W; ++i) r.f[i] = TLB_LDG(fp + i);
  r.bm = TLB_LDG(cstack + iclip(vpn, 0, Pc - 1));
  return r;
}

template <bool WITH_SWITCH>
__global__ void __launch_bounds__(TLB_THREADS) tlb_sweep_kernel(SweepArgs a) {
  extern __shared__ int smem[];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const LaneGeom g = a.g;
  const int words = lane_state_words(g);
  const LaneState s = carve_state(smem, g);
  int* red = smem + words;  // block sums of the entry-pass shares
  const int* prow = a.params + (size_t)lane * N_PARAM_FIELDS;
  const LaneParams q = load_params(prow, a.kvals + (size_t)lane * a.maxk,
                                   a.maxk);

  for (int i = tid; i < words; i += nthr) smem[i] = init_word(i, g);
  __syncthreads();
  if (tid == 0) {
    s.misc[M_PRED] = prow[F_PRED0];
    s.misc[M_ASID] = prow[F_ASID0];
  }
  __syncthreads();

  const int* trace_row = a.trace + (size_t)a.trace_id[lane] * a.T;
  int* ppn_row = a.ppn + (size_t)lane * a.T;

  for (int sg = 0; sg < a.n_segs; ++sg) {
    const int lo = a.seg_bounds[sg], hi = a.seg_bounds[sg + 1];
#define SEG(plane) a.segs[((size_t)(plane) * a.L + lane) * a.n_segs + sg]
    if (sg > 0) {
      // segment entry: context switch first, then the shootdown (the
      // reference's order)
      if (WITH_SWITCH) {
        const int new_asid = SEG(S_ASID);
        if (tid == 0) red[0] = red[1] = 0;
        __syncthreads();
        int n, loss;
        switch_share(g, s, new_asid, SEG(S_FALL) == 1, SEG(S_FASID) == 1, tid,
                     nthr, &n, &loss);
        atomicAdd(&red[0], n);
        atomicAdd(&red[1], loss);
        __syncthreads();
        if (tid == 0) switch_charge(s, new_asid, SEG(S_SWITCH) == 1, red[0], red[1]);
        __syncthreads();
      }
      if (SEG(S_SHOOT) == 1) {
        const int* dc = a.dirty + (size_t)SEG(S_DIRTY) * (a.P + 1);
        if (tid == 0) red[0] = red[1] = 0;
        __syncthreads();
        int n, loss;
        shoot_share(q, g, s, dc, a.P, tid, nthr, &n, &loss);
        atomicAdd(&red[0], n);
        atomicAdd(&red[1], loss);
        __syncthreads();
        if (tid == 0) shoot_charge(q, s, red[0], red[1]);
        __syncthreads();
      }
    }
    if (tid == 0 && lo < hi) {
      const int* mstack = a.maps + (size_t)SEG(S_MAP) * a.P * MAP_W;
      const int* fstack = a.fills + (size_t)SEG(S_FILL) * a.P * FILL_W;
      const int* cstack = a.clus + (size_t)SEG(S_CLUS) * a.Pc;
      // software pipeline: the vpn of t+2 and the records of t+1 are in
      // flight while step t runs
      int v0 = trace_row[lo];
      int v1 = lo + 1 < hi ? trace_row[lo + 1] : 0;
      Rec r0 = load_rec(mstack, fstack, cstack, a.Pc, v0);
      for (int t = lo; t < hi; ++t) {
        const int v2 = t + 2 < hi ? trace_row[t + 2] : 0;
        const Rec r1 = load_rec(mstack, fstack, cstack, a.Pc, v1);
        ppn_row[t] = step_access(q, g, s, v0, r0.m, r0.f, r0.bm, t < q.t_real);
        v0 = v1;
        v1 = v2;
        r0 = r1;
      }
    }
#undef SEG
    __syncthreads();
  }

  for (int i = tid; i < N_COUNTERS; i += nthr)
    a.counters[(size_t)lane * N_COUNTERS + i] = s.cnt[i];
  for (int i = tid; i < N_COV_SAMPLES; i += nthr)
    a.cov[(size_t)lane * N_COV_SAMPLES + i] = s.cov[i];
}

extern "C" {

// Dynamic shared memory one lane needs (state + two reduction words).
int tlb_sweep_smem_bytes(int sets, int ways, int ctlb_sets, int ctlb_ways,
                         int dp_n) {
  LaneGeom g{sets, ways, ctlb_sets, ctlb_ways, dp_n};
  return (lane_state_words(g) + 2) * (int)sizeof(int);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// kernel does not synchronise and allocates nothing.
int tlb_sweep_launch(const int* params, const int* kvals, const int* segs,
                     const int* seg_bounds, const int* trace_id,
                     const int* trace, const int* maps, const int* fills,
                     const int* clus, const int* dirty, int* ppn,
                     int* counters, int* cov, int L, int maxk, int n_segs,
                     int T, int P, int Pc, int sets, int ways, int ctlb_sets,
                     int ctlb_ways, int dp_n, int with_switch,
                     void* stream) {
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
  a.L = L;
  a.maxk = maxk;
  a.n_segs = n_segs;
  a.T = T;
  a.P = P;
  a.Pc = Pc;
  a.g = LaneGeom{sets, ways, ctlb_sets, ctlb_ways, dp_n};
  const int smem = tlb_sweep_smem_bytes(sets, ways, ctlb_sets, ctlb_ways, dp_n);
  void (*kern)(SweepArgs) =
      with_switch ? tlb_sweep_kernel<true> : tlb_sweep_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<L, TLB_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* tlb_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
