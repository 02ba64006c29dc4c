// Host-compiled driver of the TLB-sweep kernel's lane arithmetic.
//
// Walks every lane the way src/repro_torch/kernels/tlb_sweep/csrc/
// tlb_sweep.cu does — fresh state, then per segment the context switch
// (switch batches), the shootdown (where seg_shoot is set) and the steps —
// calling the same functions of tlb_lane.cuh, with the entry passes split
// over `nthr` emulated threads.  tests/test_torch_core.py builds it with
// the host C++ compiler and holds it against the plain PyTorch version, so
// the kernel's arithmetic is tested on machines without a card.
#include <stddef.h>

#include <vector>

#include "tlb_lane.cuh"

extern "C" int tlb_lane_host(const int* params, const int* kvals,
                             const int* segs, const int* seg_bounds,
                             const int* trace_id, const int* trace,
                             const int* maps, const int* fills,
                             const int* clus, const int* dirty, int* ppn,
                             int* counters, int* cov, int L, int maxk,
                             int n_segs, int T, int P, int Pc, int sets,
                             int ways, int ctlb_sets, int ctlb_ways, int dp_n,
                             int with_switch, int nthr) {
  const LaneGeom g{sets, ways, ctlb_sets, ctlb_ways, dp_n};
  const int words = lane_state_words(g);
  std::vector<int> mem(words);
  for (int lane = 0; lane < L; ++lane) {
    const LaneState s = carve_state(mem.data(), g);
    const int* prow = params + (size_t)lane * N_PARAM_FIELDS;
    const LaneParams q = load_params(prow, kvals + (size_t)lane * maxk, maxk);
    for (int i = 0; i < words; ++i) mem[i] = init_word(i, g);
    s.misc[M_PRED] = prow[F_PRED0];
    s.misc[M_ASID] = prow[F_ASID0];
    const int* trace_row = trace + (size_t)trace_id[lane] * T;
    for (int sg = 0; sg < n_segs; ++sg) {
#define SEG(plane) segs[((size_t)(plane) * L + lane) * n_segs + sg]
      if (sg > 0) {
        if (with_switch) {
          const int new_asid = SEG(S_ASID);
          int n_inv = 0, loss = 0;
          for (int tid = 0; tid < nthr; ++tid) {
            int n, l;
            switch_share(g, s, new_asid, SEG(S_FALL) == 1, SEG(S_FASID) == 1,
                         tid, nthr, &n, &l);
            n_inv += n;
            loss += l;
          }
          switch_charge(s, new_asid, SEG(S_SWITCH) == 1, n_inv, loss);
        }
        if (SEG(S_SHOOT) == 1) {
          const int* dc = dirty + (size_t)SEG(S_DIRTY) * (P + 1);
          int n_inv = 0, loss = 0;
          for (int tid = 0; tid < nthr; ++tid) {
            int n, l;
            shoot_share(q, g, s, dc, P, tid, nthr, &n, &l);
            n_inv += n;
            loss += l;
          }
          shoot_charge(q, s, n_inv, loss);
        }
      }
      const int* mstack = maps + (size_t)SEG(S_MAP) * P * MAP_W;
      const int* fstack = fills + (size_t)SEG(S_FILL) * P * FILL_W;
      const int* cstack = clus + (size_t)SEG(S_CLUS) * Pc;
#undef SEG
      for (int t = seg_bounds[sg]; t < seg_bounds[sg + 1]; ++t) {
        const int v = trace_row[t];
        ppn[(size_t)lane * T + t] = step_access(
            q, g, s, v, mstack + (size_t)v * MAP_W, fstack + (size_t)v * FILL_W,
            cstack[iclip(v, 0, Pc - 1)], t < q.t_real);
      }
    }
    for (int i = 0; i < N_COUNTERS; ++i) counters[lane * N_COUNTERS + i] = s.cnt[i];
    for (int i = 0; i < N_COV_SAMPLES; ++i) cov[lane * N_COV_SAMPLES + i] = s.cov[i];
  }
  return 0;
}
