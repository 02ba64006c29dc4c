// Host-compiled driver of the TLB-sweep kernel's lane arithmetic.
//
// Walks every lane the way src/repro_torch/kernels/tlb_sweep/csrc/
// tlb_sweep.cu does — fresh state, then per segment the context switch
// (switch batches), the shootdown (where seg_shoot is set), the real steps
// in order and the padded steps read-only, one of every 32 per thread —
// calling the same functions of tlb_lane.cuh with the step compiled for
// the lane's kind (lane_feat, TLB_FEAT_CASES), or for FT_ALL when asked.
// The step's 32 way threads are emulated by WarpSerial (each warp
// operation runs the ways in turn, as the kernel's padded steps do) and
// the entry passes are split over `nthr` emulated threads.
// tests/test_torch_core.py builds it with the host C++ compiler and holds
// it against the plain PyTorch version, so the kernel's step code is
// tested on machines without a card.
#include <stddef.h>

#include <vector>

#include "tlb_lane.cuh"

struct HostBatch {
  const int *params, *kvals, *segs, *seg_bounds, *trace_id, *trace, *maps,
      *fills, *clus, *dirty;
  int *ppn;
  int L, maxk, n_segs, T, P, Pc, with_switch, nthr;
  LaneGeom g;
};

static Rec host_rec(const int* mstack, const int* fstack, const int* cstack,
                    int Pc, int v) {
  Rec x;
  x.vpn = v;
  for (int i = 0; i < MAP_W; ++i) x.m[i] = mstack[(size_t)v * MAP_W + i];
  for (int i = 0; i < FILL_W; ++i) x.f[i] = fstack[(size_t)v * FILL_W + i];
  x.bm = cstack[iclip(v, 0, Pc - 1)];
  return x;
}

template <int FEAT>
static void host_lane(const HostBatch& b, int lane, const LaneParams& q,
                      const LaneState& s) {
  const WarpSerial warp{};
  const LaneGeom& g = b.g;
  LaneRegs r = lane_regs_load(s, q);
  const int* trace_row = b.trace + (size_t)b.trace_id[lane] * b.T;
  for (int sg = 0; sg < b.n_segs; ++sg) {
#define SEG(plane) b.segs[((size_t)(plane) * b.L + lane) * b.n_segs + sg]
    if (sg > 0) {
      lane_regs_store(r, s);
      if (b.with_switch) {
        const int new_asid = SEG(S_ASID);
        int n_inv = 0, loss = 0;
        for (int tid = 0; tid < b.nthr; ++tid) {
          int n, l;
          switch_share(g, s, new_asid, SEG(S_FALL) == 1, SEG(S_FASID) == 1,
                       tid, b.nthr, &n, &l);
          n_inv += n;
          loss = wadd(loss, l);
        }
        switch_charge(s, new_asid, SEG(S_SWITCH) == 1, n_inv, loss);
      }
      if (SEG(S_SHOOT) == 1) {
        const int* dc = b.dirty + (size_t)SEG(S_DIRTY) * (b.P + 1);
        int n_inv = 0, loss = 0;
        for (int tid = 0; tid < b.nthr; ++tid) {
          int n, l;
          shoot_share(q, g, s, dc, b.P, tid, b.nthr, &n, &l);
          n_inv += n;
          loss = wadd(loss, l);
        }
        shoot_charge(q, s, n_inv, loss);
      }
      r = lane_regs_load(s, q);
    }
    const int* mstack = b.maps + (size_t)SEG(S_MAP) * b.P * MAP_W;
    const int* fstack = b.fills + (size_t)SEG(S_FILL) * b.P * FILL_W;
    const int* cstack = b.clus + (size_t)SEG(S_CLUS) * b.Pc;
#undef SEG
    const int lo = b.seg_bounds[sg], hi = b.seg_bounds[sg + 1];
    int* out = b.ppn + (size_t)lane * b.T;
    for (int t = lo; t < imin(hi, q.t_real); ++t)
      out[t] = lane_step<true, FEAT>(
          warp, q, g, s, r,
          host_rec(mstack, fstack, cstack, b.Pc, trace_row[t]));
    // padded steps in the kernel's order: thread tid takes every 32nd
    for (int tid = 0; tid < WARP; ++tid)
      for (int t = imax(lo, q.t_real) + tid; t < hi; t += WARP)
        out[t] = lane_step<false, FEAT>(
            warp, q, g, s, r,
            host_rec(mstack, fstack, cstack, b.Pc, trace_row[t]));
  }
  lane_regs_store(r, s);
}

// Returns 0, or 1 for a batch the kernel's wrapper refuses (structures
// wider than the warp, kvals wider than MAXK_CAP).  With `all_kinds` every
// lane runs the FT_ALL step, which reads the lane's flags at run time.
extern "C" int tlb_lane_host(const int* params, const int* kvals,
                             const int* segs, const int* seg_bounds,
                             const int* trace_id, const int* trace,
                             const int* maps, const int* fills,
                             const int* clus, const int* dirty, int* ppn,
                             int* counters, int* cov, int L, int maxk,
                             int n_segs, int T, int P, int Pc, int sets,
                             int ways, int ctlb_sets, int ctlb_ways, int dp_n,
                             int with_switch, int nthr, int all_kinds) {
  if (ways > WARP || ctlb_ways > WARP || maxk > MAXK_CAP) return 1;
  const HostBatch b{params, kvals, segs, seg_bounds, trace_id, trace, maps,
                    fills, clus, dirty, ppn, L, maxk, n_segs, T, P, Pc,
                    with_switch, nthr,
                    LaneGeom{sets, ways, ctlb_sets, ctlb_ways, dp_n}};
  const int words = lane_state_words(b.g);
  std::vector<int> mem(words);
  for (int lane = 0; lane < L; ++lane) {
    const LaneState s = carve_state(mem.data(), b.g);
    const int* prow = params + (size_t)lane * N_PARAM_FIELDS;
    const int* kvrow = kvals + (size_t)lane * maxk;
    const LaneParams q = load_params(prow, kvrow, maxk);
    for (int i = 0; i < words; ++i) mem[i] = init_word(i, b.g);
    for (int c = 0; c < N_CLASSES; ++c) s.ktab[c] = ktab_word(kvrow, maxk, c);
    s.misc[M_PRED] = prow[F_PRED0];
    s.misc[M_ASID] = prow[F_ASID0];
    switch (all_kinds ? FT_ALL : lane_feat(q)) {
#define TLB_CASE(F)             \
  case F:                       \
    host_lane<F>(b, lane, q, s); \
    break;
      TLB_FEAT_CASES(TLB_CASE)
#undef TLB_CASE
      default:
        host_lane<FT_ALL>(b, lane, q, s);
    }
    for (int i = 0; i < N_COUNTERS; ++i) counters[lane * N_COUNTERS + i] = s.cnt[i];
    for (int i = 0; i < N_COV_SAMPLES; ++i) cov[lane * N_COV_SAMPLES + i] = s.cov[i];
  }
  return 0;
}
