// The fill and cluster records of a packed sweep batch, worked out per vpn
// from the batch's map records.
//
// This is the arithmetic of the port's host packing
// (src/repro_torch/core/lane_program.py: _fill_profile, and
// core/page_table.py: cluster_bitmap, huge_page_backed) written for ONE
// (record, vpn): a fill record holds what a walk at vpn installs in the L2
// under the record's profile (regular, K-aligned / Anchor, COLT, THP,
// subregion), a cluster record the Cluster TLB's 8-page bitmap at vpn.
// Each is a pure function of the source's map record
// (ppn, run_start, run_len per vpn; lane_program._map_record) near vpn and
// of the source's n_pages, so the card derives them from the map records
// it is sent anyway.  tlb_records.cu runs it over every (record, vpn) of a
// batch; tests/csrc/tlb_records_host.cpp runs it on the host, which
// tests/test_torch_records.py holds to the host packing bit for bit.
//
// Rules mirrored from the host packing:
//  * a row at or beyond n_pages is (0, K_REGULAR, 0, 0, 0) in a fill
//    record and 0 in a cluster record; a pad record (REC_ZERO) is all 0;
//  * "contig at v" clips v to [0, n - 1] and is 0 where v is unmapped;
//  * K classes are tried in the plan's order and the first that covers
//    vpn wins; -1 marks the end of the classes;
//  * a page of a cluster window at or beyond n_pages is unmapped.
// Every value fits int32: ppn, run_start + run_len and vpn are below 2^31
// (the map record is int32), and classes are at most 30 (the wrapper,
// kernels/tlb_sweep/ops.py, refuses a plan that breaks either).
#pragma once

#include "tlb_lane.cuh"

// ---- the plan row (lane_program.PLAN_FIELDS; a test holds these) ----
#define PLAN_MAP 0
#define PLAN_PAGES 1
#define PLAN_CODE 2
#define PLAN_K 3  // the K classes start here

// ---- profile codes (lane_program.REC_CODES) ----
#define REC_ZERO 0
#define REC_REGULAR 1
#define REC_KALIGNED 2
#define REC_COLT 3
#define REC_THP 4
#define REC_SUBR 5
#define REC_CLUSTER 6

#define K_COLT 3        // the class COLT's coalesced entries carry
#define COLT_SPAN 8     // COLT coalesces within an aligned 8-page window
#define CLUS_BITS 3     // cluster_bitmap's cluster_bits: 8-page windows

struct MapRow {
  int ppn, rs, rl;
};

// Row v of a source's map record (`map` points at its row 0).
TLB_HD MapRow map_row(const int* map, int v) {
#ifdef __CUDA_ARCH__
  const int4 r = __ldg(reinterpret_cast<const int4*>(map) + v);
  return MapRow{r.x, r.y, r.z};
#else
  const int* r = map + (size_t)v * MAP_W;
  return MapRow{r[0], r[1], r[2]};
#endif
}

// Pages contiguously mapped from v on, v clipped to [0, n - 1]; 0 where
// that page is unmapped (lane_program._fill_profile's contig_at).
TLB_HD int contig_at(const int* map, int n, int v) {
  v = iclip(v, 0, n - 1);
  const MapRow r = map_row(map, v);
  return r.ppn >= 0 ? r.rs + r.rl - v : 0;
}

// The fill record at vpn v (< n) of profile `code` into out[FILL_W]:
// tag, class, contig, ppn, aux.  `ks` holds `nk` K classes.
TLB_HD void fill_row(const int* map, int n, int code, const int* ks, int nk,
                     int v, int* out) {
  const MapRow me = map_row(map, v);
  int tag = v, kcls = K_REGULAR, contig = 1, fppn = me.ppn, aux = 0;
  if (code == REC_KALIGNED) {
    for (int i = 0; i < nk; ++i) {
      const int k = TLB_LDG(ks + i);
      if (k < 0) break;
      const int vk = align_down(v, k);
      const int sc = imin(contig_at(map, n, vk), 1 << k);
      if (sc > v - vk) {
        tag = vk;
        kcls = k;
        contig = sc;
        fppn = map_row(map, iclip(vk, 0, n - 1)).ppn;
        break;
      }
    }
  } else if (code == REC_COLT) {
    const int w8 = v & ~(COLT_SPAN - 1);
    tag = imax(me.rs, w8);
    contig = imax(imin(me.rs + me.rl, w8 + COLT_SPAN) - tag, 1);
    kcls = contig > 1 ? K_COLT : K_REGULAR;
    fppn = map_row(map, iclip(tag, 0, n - 1)).ppn;
  } else if (code == REC_THP) {
    // page_table.huge_page_backed: the 2MB window is whole, contiguous
    // from its base and 2MB-aligned in physical memory
    const int huge_pages = 1 << K_HUGE;
    const int base = v & ~(huge_pages - 1);
    const int b = imin(base, n - 1);
    const MapRow rb = map_row(map, b);
    const int cab = rb.ppn != -1 ? rb.rs + rb.rl - b : 0;
    const bool huge = base + huge_pages <= n && cab >= huge_pages &&
                      (rb.ppn & (huge_pages - 1)) == 0;
    if (huge) {
      tag = v >> K_HUGE;
      kcls = K_HUGE;
      contig = huge_pages;
      fppn = map_row(map, iclip(base, 0, n - 1)).ppn;
    }
  } else if (code == REC_SUBR) {
    const int base = v & ~(SUBR_PAGES - 1);
    const int delta = me.ppn - v;
    int bitmap = 0;
    for (int j = 0; j < SUBR_PAGES; ++j) {
      const int pj = base + j;
      if (pj < n) {
        const int q = map_row(map, pj).ppn;
        if (q >= 0 && q - pj == delta) bitmap |= 1 << j;
      }
    }
    if (me.ppn >= 0) {
      tag = base;
      kcls = K_SUBR;
      contig = popc((unsigned)bitmap);
      fppn = me.ppn - (v - base);
      aux = bitmap;
    }
  }
  out[0] = tag;
  out[1] = kcls;
  out[2] = contig;
  out[3] = fppn;
  out[4] = aux;
}

// The whole row v of a fill record: pads and rows past n included.
TLB_HD void fill_word_row(const int* map, int n, int code, const int* ks,
                          int nk, int v, int* out) {
  if (code != REC_ZERO && v < n) {
    fill_row(map, n, code, ks, nk, v, out);
    return;
  }
  out[0] = 0;
  out[1] = code != REC_ZERO ? K_REGULAR : 0;
  out[2] = 0;
  out[3] = 0;
  out[4] = 0;
}

// The cluster record at vpn v: bit j says page j of v's aligned 8-page
// window maps into the same aligned physical cluster as v; 0 where v is
// unmapped, past n, or the record is a pad.
TLB_HD int cluster_word(const int* map, int n, int code, int v) {
  if (code != REC_CLUSTER || v >= n) return 0;
  const int p = map_row(map, v).ppn;
  if (p == -1) return 0;
  const int self = p >> CLUS_BITS;
  const int win = 1 << CLUS_BITS;
  const int base = v & ~(win - 1);
  int bm = 0;
  for (int j = 0; j < win; ++j) {
    if (base + j >= n) break;
    const int q = map_row(map, base + j).ppn;
    if (q != -1 && (q >> CLUS_BITS) == self) bm |= 1 << j;
  }
  return bm;
}
