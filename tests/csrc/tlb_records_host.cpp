// Host-compiled loop over the record kernel's arithmetic.
//
// Walks every (record, vpn) of a record plan the way
// src/repro_torch/kernels/tlb_sweep/csrc/tlb_records.cu does — fill
// records first, then cluster records — calling the same functions of
// tlb_records.cuh (fill_word_row, cluster_word) on one thread.
// tests/test_torch_records.py builds it with the host C++ compiler and
// holds it to the host packing, so the kernel's arithmetic is tested on
// machines without a card.
#include <stddef.h>

#include "tlb_records.cuh"

extern "C" int tlb_records_host(const int* plan, int n_fill, int n_clus,
                                int plan_w, const int* maps, int P, int Pc,
                                int* fills, int* clus) {
  for (int r = 0; r < n_fill + n_clus; ++r) {
    const int* row = plan + (size_t)r * plan_w;
    const int* map = maps + (size_t)row[PLAN_MAP] * P * MAP_W;
    if (r < n_fill) {
      for (int v = 0; v < P; ++v)
        fill_word_row(map, row[PLAN_PAGES], row[PLAN_CODE], row + PLAN_K,
                      plan_w - PLAN_K, v,
                      fills + ((size_t)r * P + v) * FILL_W);
    } else {
      for (int v = 0; v < Pc; ++v)
        clus[(size_t)(r - n_fill) * Pc + v] =
            cluster_word(map, row[PLAN_PAGES], row[PLAN_CODE], v);
    }
  }
  return 0;
}
