// One lane of the batched TLB sweep: state layout, the per-access step and
// the segment-entry passes (context switch, coherence shootdown).
//
// This is the arithmetic of the JAX package's lane program
// (src/repro/core/lane_program.py: step_access, shoot_lane, switch_lane)
// written for ONE lane whose whole state lives in one contiguous int32
// block (shared memory in the kernel).  The step is written once, for a
// warp of 32 "way threads": thread w owns entry w of whatever structure is
// probed (a way of the L1 set, the 2MB L1 set, the L2 row and the THP huge
// row; one of the 32 range entries; a cluster way; a way of the
// cache-backed tier), and the few cross-thread operations sit behind the
// warp type WP (ballot, min, first_min, sync).  The kernel runs it with
// WarpDev (tlb_sweep.cu: __ballot_sync, __reduce_min_sync); WarpSerial
// below runs the same code on one thread that stands for the 32 — the
// host build (tests/csrc/tlb_lane_host.cpp) and the kernel's read-only
// padded steps use it.  Apart from the TLB_HD qualifier and the intrinsics
// of WarpDev, it is plain C++.
//
// Bit-exactness rules, each mirrored from the reference and each held by a
// test against the plain torch version (tests/test_torch_core.py on the
// CPU through the host build, tests/test_torch_cuda.py on the card):
//  * first-index semantics: jnp.argmax over an all-False mask is 0, and
//    that index is only used under a gate: first_set(ballot) of an empty
//    mask is 0;
//  * victim choice: jnp.argmin returns the FIRST minimum; padded ways
//    score BIG, invalid ways NEG.  first_min reduces the score first and
//    then takes the lowest way holding it (a packed (score << 5) | way key
//    would overflow int32 at BIG and NEG);
//  * the aligned-probe chain in one round: every position probes the same
//    L2 row, and an entry of class k can only match the positions whose
//    class is k, so each way tests its own entry at the first position of
//    its class and the least (position, way) is the sequential loop's hit
//    (the chain key in lane_step; positions of class -1 are not live, a
//    regular hit leaves probes_used 0, duplicate classes count every live
//    position up to the hit; a prediction is right when the hit is at
//    position 0, which is pred);
//  * the probe order is kept as per-class entry masks (ktab) and 16-bit
//    masks of the kvals row, so no step loops over kvals and no array is
//    indexed at run time in registers (which would put it in local memory);
//  * victim scans read only state the step has not written yet, so a
//    lane kind's instance runs them before it knows whether their fill
//    happens (FT_ALL runs each where its fill does);
//  * write order inside a step: the fill is written first, then the LRU
//    touch goes into the already-filled array (same cell possible);
//  * coverage samples use the pre-increment t and post-add counters;
//  * k == HUGE (9) is a 2MB entry on THP lanes only; on K-aligned lanes 9
//    is a plain alignment class;
//  * rng_dirty clips both ends of the range to [0, P];
//  * the cluster word is read at clip(vpn, 0, Pc - 1) (Pc may be 1);
//  * int32 arithmetic wraps as in XLA: sums, differences and left shifts
//    that could overflow go through uint32 (wadd/wsub/wshl), never signed
//    overflow; right shifts of signed values are arithmetic, as in jnp.
#pragma once

#ifdef __CUDACC__
#define TLB_HD __host__ __device__ __forceinline__
#else
#define TLB_HD inline
#endif
#ifdef __CUDA_ARCH__
#define TLB_LDG(p) __ldg(p)
#else
#define TLB_LDG(p) (*(p))
#endif

// ---- layout (src/repro_torch/core/plane_layout.py; a test holds these) ----
#define L1_W 4          // tag, ppn, lru, asid  (also l1h, ctlb)
#define L2_W 7          // tag, kcls, contig, ppn, lru, asid, aux
#define L2_TAG 0
#define L2_KCLS 1
#define L2_CONTIG 2
#define L2_PPN 3
#define L2_LRU 4
#define L2_ASID 5
#define L2_AUX 6
#define RMM_W 5         // start, len, ppn, lru, asid
#define CLUS_W 4        // tag, bitmap, lru, asid
#define CTLB_W 4        // tag, ppn, lru, asid
#define MAP_W 4         // ppn, run_start, run_len, run_start_ppn
#define FILL_W 5        // tag, k, contig, ppn, aux

// ---- geometry and constants (src/repro_torch/core/simulator.py) ----------
#define L1_SETS 16
#define L1_WAYS 4
#define L1H_SETS 8
#define L1H_WAYS 4
#define RMM_ENTRIES 32
#define CLUS_SETS 64
#define CLUS_WAYS 5
#define N_COUNTERS 9
#define N_COV_SAMPLES 64
#define K_REGULAR (-1)
#define K_HUGE 9
#define K_SUBR 10
#define K_INVALID (-2)
#define SCORE_NEG (-(1 << 30))
#define SCORE_BIG (1 << 30)
#define SUBR_PAGES 16
#define LAT_L2_REG 7
#define LAT_COAL 8
#define LAT_EXTRA_PROBE 7
#define LAT_WALK 50
#define LAT_CTLB 24
#define LAT_SHOOTDOWN 200
#define LAT_INVALIDATE 8
#define LAT_CTX_SWITCH 150

// counters (lane_program.C_*)
#define C_L1 0
#define C_REG 1
#define C_COAL 2
#define C_WALK 3
#define C_PROBE 4
#define C_PRED 5
#define C_CYC 6
#define C_COV 7
#define C_SHOOT 8

// params row (kernels/tlb_sweep/ops.py PARAM_KEYS order)
#define F_IS_COLT 0
#define F_IS_THP 1
#define F_HAS_RMM 2
#define F_HAS_CLUSTER 3
#define F_USE_PRED 4
#define F_SET_MASK 5
#define F_N_WAYS 6
#define F_K_HAT 7
#define F_MISS_CHAIN 8
#define F_PRED0 9
#define F_ASID0 10
#define F_T_REAL 11
#define F_SAMPLE_EVERY 12
#define F_IS_SUBR 13
#define F_HAS_CTLB 14
#define F_USE_DEAD 15
#define F_COH_HW 16
#define N_PARAM_FIELDS 17

// misc scalars (plane_layout.MISC_FIELDS)
#define M_T 0
#define M_PRED 1
#define M_ASID 2
#define MISC_W 3

#define MAXK_CAP 16     // the wrapper refuses wider kvals rows
#define WARP 32         // way threads: the wrapper refuses wider structures
#define N_CLASSES 32    // alignment classes 0..31 have a ktab word

// the seg_* planes, stacked [N_SEG_PLANES, L, n_segs] by the wrapper
#define S_MAP 0
#define S_FILL 1
#define S_CLUS 2
#define S_DIRTY 3
#define S_SHOOT 4
#define S_ASID 5
#define S_SWITCH 6
#define S_FALL 7
#define S_FASID 8
#define N_SEG_PLANES 9

TLB_HD int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
TLB_HD int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
TLB_HD int wshl(int a, int s) { return (int)((unsigned)a << s); }
TLB_HD int imax(int a, int b) { return a > b ? a : b; }
TLB_HD int imin(int a, int b) { return a < b ? a : b; }
TLB_HD int iclip(int a, int lo, int hi) { return imin(imax(a, lo), hi); }

TLB_HD int popc(unsigned m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// Index of the lowest set bit; 0 for an empty mask (jnp.argmax of an
// all-False mask).
TLB_HD int first_set(unsigned m) {
#ifdef __CUDA_ARCH__
  return m ? __ffs((int)m) - 1 : 0;
#else
  return m ? __builtin_ctz(m) : 0;
#endif
}

// Bits 0..i set (none for i < 0).
TLB_HD unsigned upto(int i) {
  return i < 0 ? 0u : i >= 31 ? ~0u : (2u << i) - 1u;
}

// The low bits of vpn cleared below alignment class k (k in 0..30).
TLB_HD int align_down(int vpn, int k) { return vpn & ~wsub(wshl(1, k), 1); }

// The 32 way threads run one after another on one thread: the host build,
// and the kernel's padded steps (each thread of the warp one padded step).
struct WarpSerial {
  // bit w set for every w < n where f(w) holds
  template <class F>
  TLB_HD unsigned ballot(int n, F f) const {
    unsigned m = 0;
    for (int w = 0; w < n; ++w)
      if (f(w)) m |= 1u << w;
    return m;
  }
  // least f(w) over w < n (INT_MAX when n == 0)
  template <class F>
  TLB_HD int min(int n, F f) const {
    int m = 0x7fffffff;
    for (int w = 0; w < n; ++w) m = imin(m, f(w));
    return m;
  }
  // first w < n holding the least f(w) (jnp.argmin); 0 when n == 0
  template <class F>
  TLB_HD int first_min(int n, F f) const {
    int best = 0, best_score = 0;
    for (int w = 0; w < n; ++w) {
      const int v = f(w);
      if (w == 0 || v < best_score) {
        best = w;
        best_score = v;
      }
    }
    return best;
  }
  TLB_HD void sync() const {}
};

// Per-lane geometry; every structure is one int32 block, fields last.
struct LaneGeom {
  int sets, ways, ctlb_sets, ctlb_ways, dp_n;
};

TLB_HD int lane_state_words(const LaneGeom& g) {
  return L1_SETS * L1_WAYS * L1_W + L1H_SETS * L1H_WAYS * L1_W +
         g.sets * g.ways * L2_W + RMM_ENTRIES * RMM_W +
         CLUS_SETS * CLUS_WAYS * CLUS_W + g.ctlb_sets * g.ctlb_ways * CTLB_W +
         g.dp_n + MISC_W + N_COUNTERS + N_COV_SAMPLES + N_CLASSES;
}

struct LaneState {
  int *l1, *l1h, *l2, *rmm, *clus, *ctlb, *dp, *misc, *cnt, *cov;
  int* ktab;  // ktab[c]: mask of the kvals entries equal to class c
};

// Carve one lane's state out of a block of lane_state_words(g) ints.
TLB_HD LaneState carve_state(int* base, const LaneGeom& g) {
  LaneState s;
  s.l1 = base;
  s.l1h = s.l1 + L1_SETS * L1_WAYS * L1_W;
  s.l2 = s.l1h + L1H_SETS * L1H_WAYS * L1_W;
  s.rmm = s.l2 + g.sets * g.ways * L2_W;
  s.clus = s.rmm + RMM_ENTRIES * RMM_W;
  s.ctlb = s.clus + CLUS_SETS * CLUS_WAYS * CLUS_W;
  s.dp = s.ctlb + g.ctlb_sets * g.ctlb_ways * CTLB_W;
  s.misc = s.dp + g.dp_n;
  s.cnt = s.misc + MISC_W;
  s.cov = s.cnt + N_COUNTERS;
  s.ktab = s.cov + N_COV_SAMPLES;
  return s;
}

// Word i (0 <= i < lane_state_words) of the fresh state, as the reference
// initialises it: tag/start planes -1, L2 kcls INVALID and ppn -1, the
// rest 0 (t, counters and samples 0; pred and asid are set by the caller,
// ktab by build_ktab).
TLB_HD int init_word(int i, const LaneGeom& g) {
  int n = L1_SETS * L1_WAYS * L1_W;
  if (i < n) return (i % L1_W) == 0 ? -1 : 0;
  i -= n;
  n = L1H_SETS * L1H_WAYS * L1_W;
  if (i < n) return (i % L1_W) == 0 ? -1 : 0;
  i -= n;
  n = g.sets * g.ways * L2_W;
  if (i < n) {
    int f = i % L2_W;
    return f == L2_TAG ? -1 : f == L2_KCLS ? K_INVALID : f == L2_PPN ? -1 : 0;
  }
  i -= n;
  n = RMM_ENTRIES * RMM_W;
  if (i < n) return (i % RMM_W) == 0 ? -1 : 0;
  i -= n;
  n = CLUS_SETS * CLUS_WAYS * CLUS_W;
  if (i < n) return (i % CLUS_W) == 0 ? -1 : 0;
  i -= n;
  n = g.ctlb_sets * g.ctlb_ways * CTLB_W;
  if (i < n) return (i % CTLB_W) == 0 ? -1 : 0;
  return 0;
}

// ktab[c] for class c: the mask of kvals entries equal to c.  The kernel
// gives each class to one thread; the host calls it for every c.
TLB_HD int ktab_word(const int* kv, int maxk, int c) {
  unsigned m = 0;
  for (int i = 0; i < maxk; ++i)
    if (TLB_LDG(kv + i) == c) m |= 1u << i;
  return (int)m;
}

// Per-lane scalars, read once from the params row and the kvals row.  The
// kvals row itself is kept as masks (entries 0..maxk-1, bit i = entry i)
// beside ktab in the state.
struct LaneParams {
  int is_colt, is_thp, is_subr, is_generic, has_rmm, has_cluster, has_ctlb,
      use_dead, coh_hw, use_pred, set_mask, n_ways, k_hat, miss_chain,
      t_real, sample_every, maxk;
  unsigned live;      // entries >= 0: live positions
  unsigned neg;       // entries == -1: the entries equal to pred == -1
};

TLB_HD LaneParams load_params(const int* p, const int* kv, int maxk) {
  LaneParams q;
  q.is_colt = TLB_LDG(p + F_IS_COLT) == 1;
  q.is_thp = TLB_LDG(p + F_IS_THP) == 1;
  q.is_subr = TLB_LDG(p + F_IS_SUBR) == 1;
  q.is_generic = !q.is_colt && !q.is_thp && !q.is_subr;
  q.has_rmm = TLB_LDG(p + F_HAS_RMM) == 1;
  q.has_cluster = TLB_LDG(p + F_HAS_CLUSTER) == 1;
  q.has_ctlb = TLB_LDG(p + F_HAS_CTLB) == 1;
  q.use_dead = TLB_LDG(p + F_USE_DEAD) == 1;
  q.coh_hw = TLB_LDG(p + F_COH_HW) == 1;
  q.use_pred = TLB_LDG(p + F_USE_PRED) == 1;
  q.set_mask = TLB_LDG(p + F_SET_MASK);
  q.n_ways = TLB_LDG(p + F_N_WAYS);
  q.k_hat = TLB_LDG(p + F_K_HAT);
  q.miss_chain = TLB_LDG(p + F_MISS_CHAIN);
  q.t_real = TLB_LDG(p + F_T_REAL);
  q.sample_every = TLB_LDG(p + F_SAMPLE_EVERY);
  q.maxk = maxk;
  q.live = 0;
  q.neg = 0;
  for (int i = 0; i < maxk; ++i) {
    const int k = TLB_LDG(kv + i);
    q.live |= (k >= 0 ? 1u : 0u) << i;
    q.neg |= (k == -1 ? 1u : 0u) << i;
  }
  return q;
}

// The scalars a lane's steps carry from one to the next, in registers in
// the kernel; lane_regs_store/lane_regs_load move them to and from the
// state around the segment-entry passes and at the end.  `smp` counts the
// steps left before the next coverage sample (t % sample_every ==
// sample_every - 1), so no step divides.
struct LaneRegs {
  int t, pred, cur, smp;
  int cnt[N_COUNTERS];
};

TLB_HD LaneRegs lane_regs_load(const LaneState& s, const LaneParams& q) {
  LaneRegs r;
  r.t = s.misc[M_T];
  r.pred = s.misc[M_PRED];
  r.cur = s.misc[M_ASID];
  r.smp = q.sample_every - 1 - r.t % q.sample_every;
  for (int i = 0; i < N_COUNTERS; ++i) r.cnt[i] = s.cnt[i];
  return r;
}

TLB_HD void lane_regs_store(const LaneRegs& r, const LaneState& s) {
  s.misc[M_T] = r.t;
  s.misc[M_PRED] = r.pred;
  s.misc[M_ASID] = r.cur;
  for (int i = 0; i < N_COUNTERS; ++i) s.cnt[i] = r.cnt[i];
}

// One access's inputs: the vpn and the live segment's map record, fill
// record and cluster word at it.
struct Rec {
  int vpn;
  int m[MAP_W];
  int f[FILL_W];
  int bm;
};

// ---- lane kinds, known at compile time ------------------------------------
// A lane's flags decide which structures its step probes.  The step is
// compiled once per kind of lane the roster has (FEAT, a mask of FT_*
// bits), so a lane runs only its own structures' code; FT_ALL reads the
// flags at run time and takes any other combination.  The kernel and the
// host build both pick a lane's instance by lane_feat and TLB_FEAT_CASES.
#define FT_COLT 1
#define FT_THP 2
#define FT_SUBR 4
#define FT_CHAIN 8      // the aligned-probe chain can hit (live classes)
#define FT_PRED 16
#define FT_RMM 32
#define FT_CLUS 64
#define FT_CTLB 128
#define FT_DEAD 256
#define FT_ALL 511
#define TLB_FEAT_CASES(X)                                                   \
  X(0) X(FT_COLT) X(FT_THP) X(FT_SUBR) X(FT_CHAIN) X(FT_CHAIN | FT_PRED)    \
  X(FT_RMM) X(FT_CLUS) X(FT_CTLB) X(FT_DEAD)

struct Kind {
  bool colt, thp, subr, generic, chain, pred, rmm, clus, ctlb, dead;
};

// Is `feat` one of the kinds with an instance of its own?
TLB_HD bool feat_compiled(int feat) {
  switch (feat) {
#define TLB_CASE(F) case F:
    TLB_FEAT_CASES(TLB_CASE)
#undef TLB_CASE
    return true;
    default:
      return false;
  }
}

TLB_HD Kind kind_of(const LaneParams& q) {
  Kind k;
  k.colt = q.is_colt;
  k.thp = q.is_thp;
  k.subr = q.is_subr;
  k.generic = q.is_generic;
  // a chain with no live position and no predictor never hits or counts
  k.chain = (q.is_generic || q.use_pred) && (q.use_pred || q.live != 0);
  k.pred = q.use_pred;
  k.rmm = q.has_rmm;
  k.clus = q.has_cluster;
  k.ctlb = q.has_ctlb;
  k.dead = q.use_dead;
  return k;
}

TLB_HD int lane_feat(const LaneParams& q) {
  const Kind k = kind_of(q);
  return (k.colt ? FT_COLT : 0) | (k.thp ? FT_THP : 0) |
         (k.subr ? FT_SUBR : 0) | (k.chain ? FT_CHAIN : 0) |
         (k.pred ? FT_PRED : 0) | (k.rmm ? FT_RMM : 0) |
         (k.clus ? FT_CLUS : 0) | (k.ctlb ? FT_CTLB : 0) |
         (k.dead ? FT_DEAD : 0);
}

// The lane's kind under FEAT: constants the compiler folds, or (FT_ALL)
// the flags.  FEAT is lane_feat(q) or FT_ALL, so both agree with q.
template <int FEAT>
TLB_HD Kind kind_at(const LaneParams& q) {
  if (FEAT == FT_ALL) return kind_of(q);
  Kind k;
  k.colt = (FEAT & FT_COLT) != 0;
  k.thp = (FEAT & FT_THP) != 0;
  k.subr = (FEAT & FT_SUBR) != 0;
  k.generic = (FEAT & (FT_COLT | FT_THP | FT_SUBR)) == 0;
  k.chain = (FEAT & FT_CHAIN) != 0;
  k.pred = (FEAT & FT_PRED) != 0;
  k.rmm = (FEAT & FT_RMM) != 0;
  k.clus = (FEAT & FT_CLUS) != 0;
  k.ctlb = (FEAT & FT_CTLB) != 0;
  k.dead = (FEAT & FT_DEAD) != 0;
  return k;
}

// One access of one lane (step_access).  ACT is false on padded steps:
// then nothing is read but the probes and nothing is written; only the
// returned ppn counts.  The probes and victim scans of every structure are
// independent of one another, so the warp issues them together; the writes
// follow in the reference's order.
template <bool ACT, int FEAT, class WP>
TLB_HD int lane_step(const WP& wp, const LaneParams& q, const LaneGeom& g,
                     const LaneState& s, LaneRegs& r, const Rec& rec) {
  const Kind k = kind_at<FEAT>(q);
  const int vpn = rec.vpn;
  const int t = r.t, pred = r.pred, cur = r.cur;
  const int ppn_true = rec.m[0], rs_v = rec.m[1], rl_v = rec.m[2],
            rmm_fill_ppn = rec.m[3];
  const int fill_tag = rec.f[0], fill_k = rec.f[1], fill_contig = rec.f[2],
            fill_ppn = rec.f[3], fill_aux = rec.f[4];
  const int bm = rec.bm;
  const int W = g.ways;

  // ---------------- L1 (regular + gated 2MB array) ----------------
  int* l1row = s.l1 + (vpn & (L1_SETS - 1)) * L1_WAYS * L1_W;
  const unsigned l1m = wp.ballot(L1_WAYS, [&](int w) {
    const int tag = l1row[w * L1_W], asid = l1row[w * L1_W + 3];
    return (tag == vpn) & (asid == cur);
  });
  const bool l1_hit = l1m != 0;
  const int l1_way = first_set(l1m);
  const int hv = vpn >> 9;              // arithmetic, as jnp
  int* l1hrow = s.l1h + (hv & (L1H_SETS - 1)) * L1H_WAYS * L1_W;
  unsigned l1hm = 0;                    // read on THP lanes only
  if (k.thp)
    l1hm = wp.ballot(L1H_WAYS, [&](int w) {
      const int tag = l1hrow[w * L1_W], asid = l1hrow[w * L1_W + 3];
      return (tag == hv) & (asid == cur);
    });
  const bool h_any = l1hm != 0;
  const int l1h_way = first_set(l1hm);
  const bool l1_served = l1_hit || (k.thp && h_any);

  // ---------------- L2 probes (each kind's on its lanes) ----------
  // Each kind's probe runs only on lanes of that kind: its result is read
  // only under the same flag, so skipping it elsewhere changes nothing.
  const int s2 = (vpn >> q.k_hat) & q.set_mask;
  const int* row = s.l2 + s2 * W * L2_W;
  const int s2h = hv & q.set_mask;
  const int* row_h = s.l2 + s2h * W * L2_W;
  const int sub_off = vpn & (SUBR_PAGES - 1);
  unsigned regm = 0, coltm = 0, subrm = 0, hugem = 0;
  if (k.generic || k.thp || k.chain)
    regm = wp.ballot(W, [&](int w) {
      const int* e = row + w * L2_W;
      const int kc = e[L2_KCLS], tag = e[L2_TAG], asid = e[L2_ASID];
      return (kc == K_REGULAR) & (tag == vpn) & (asid == cur);
    });
  if (k.colt)
    coltm = wp.ballot(W, [&](int w) {
      const int* e = row + w * L2_W;
      const int kc = e[L2_KCLS], tag = e[L2_TAG], asid = e[L2_ASID],
                cg = e[L2_CONTIG];
      const int diff = wsub(vpn, tag);
      return (kc != K_INVALID) & (asid == cur) & (diff >= 0) & (diff < cg);
    });
  if (k.subr)
    subrm = wp.ballot(W, [&](int w) {
      const int* e = row + w * L2_W;
      const int kc = e[L2_KCLS], tag = e[L2_TAG], asid = e[L2_ASID],
                aux = e[L2_AUX];
      return (kc == K_SUBR) & (asid == cur) &
             (tag == (vpn & ~(SUBR_PAGES - 1))) & (((aux >> sub_off) & 1) == 1);
    });
  if (k.thp)
    hugem = wp.ballot(W, [&](int w) {
      const int* e = row_h + w * L2_W;
      const int kc = e[L2_KCLS], tag = e[L2_TAG], asid = e[L2_ASID];
      return (kc == K_HUGE) & (tag == hv) & (asid == cur);
    });

  // generic branch: regular probe + the aligned-probe chain, in the
  // predictor's order [pred, remaining K in packed order] or as packed.
  // Its results are read on generic lanes and through the predictor only;
  // a regular hit stops it before its first probe.
  const bool gen_reg = regm != 0;
  const int rw = first_set(regm);
  bool gen_coal = false;
  int coal_way = 0, hit_k = -1, probes_used = 0;
  if (k.chain && !gen_reg) {
    // entries equal to pred (a class outside 0..31 equals no entry); on
    // predicting lanes positions 1.. are the entries other than pred,
    // in order, cut to maxk - 1 of them
    const unsigned eqp = !k.pred ? 0u
                         : pred == -1 ? q.neg
                         : (unsigned)pred < N_CLASSES
                             ? (unsigned)s.ktab[pred] : 0u;
    const unsigned ne_live = upto(q.maxk - 1) & ~eqp & q.live;
    const int p0 = pred >= 0 ? 1 : 0;
    // each way's hit as one key: (position, way) orders the keys as the
    // sequential chain meets them; the live positions probed up to the
    // hit and the class ride in the low bits
    const int NO_KEY = 0x7fffffff;
    const int key = wp.min(W, [&](int w) {
      // every field loaded, every test computed: no load waits on a test
      const int* e = row + w * L2_W;
      const int kc = e[L2_KCLS], tag = e[L2_TAG], asid = e[L2_ASID],
                cg = e[L2_CONTIG];
      const int c = kc & (N_CLASSES - 1);
      const unsigned m = (unsigned)s.ktab[c];  // entries of class c
      const int vk = align_down(vpn, c);
      // a regular or invalid entry (kc < 0) is no class
      const bool match = ((unsigned)kc < N_CLASSES) & (tag == vk) &
                         (asid == cur) & (cg > wsub(vpn, vk));
      const int i = first_set(m);
      int pos, probes;
      if (!k.pred) {
        pos = m ? i : -1;
        probes = popc(q.live & upto(i));
      } else {
        const int after = m ? 1 + i - popc(eqp & (upto(i) >> 1)) : -1;
        pos = c == pred ? 0 : after < q.maxk ? after : -1;
        probes = c == pred ? 1 : p0 + popc(ne_live & upto(i));
      }
      return match & (pos >= 0) ? pos << 15 | w << 10 | probes << 5 | c
                                : NO_KEY;
    });
    gen_coal = key != NO_KEY;
    if (gen_coal) {
      coal_way = (key >> 10) & (WARP - 1);
      hit_k = key & (N_CLASSES - 1);
      probes_used = (key >> 5) & 31;
    } else {
      // every live position probed
      probes_used = !k.pred ? popc(q.live)
                    : p0 + popc(ne_live & (eqp == 0 ? upto(q.maxk - 2)
                                                     : ~0u));
    }
  }

  // ---------------- side structures (gated) -----------------------
  unsigned rngm = 0, ctagm = 0, cbitm = 0, ctm = 0;
  if (k.rmm)
    rngm = wp.ballot(RMM_ENTRIES, [&](int e) {
      const int* x = s.rmm + e * RMM_W;
      const int start = x[0], len = x[1], asid = x[4];
      const int d = wsub(vpn, start);
      return (d >= 0) & (d < len) & (asid == cur);
    });
  const int cwd = vpn >> 3;
  int* crow = s.clus + (cwd & (CLUS_SETS - 1)) * CLUS_WAYS * CLUS_W;
  if (k.clus) {
    ctagm = wp.ballot(CLUS_WAYS, [&](int w) {
      const int tag = crow[w * CLUS_W], asid = crow[w * CLUS_W + 3];
      return (tag == cwd) & (asid == cur);
    });
    cbitm = wp.ballot(CLUS_WAYS, [&](int w) {
      return ((crow[w * CLUS_W + 1] >> (vpn & 7)) & 1) == 1;
    });
  }
  int* trow = s.ctlb + (vpn & (g.ctlb_sets - 1)) * g.ctlb_ways * CTLB_W;
  if (k.ctlb)
    ctm = wp.ballot(g.ctlb_ways, [&](int w) {
      const int tag = trow[w * CTLB_W], asid = trow[w * CTLB_W + 3];
      return (tag == vpn) & (asid == cur);
    });

  // ---------------- victims (see the header) ----------------------
  // A scan reads only state this step has not written yet.  The instance
  // of a lane kind runs its scans here, beside the probes, before the step
  // knows whether their fills happen; FT_ALL, which carries every
  // structure, runs each where its fill does, to keep to the registers.
  const bool early = FEAT != FT_ALL;
  const bool served_huge = k.thp && fill_k == K_HUGE;
  int* frow = s.l2 + (served_huge ? s2h : s2) * W * L2_W;
  auto l2_victim_of = [&]() {
    return wp.first_min(W, [&](int w) {
      const int kc = frow[w * L2_W + L2_KCLS], lru = frow[w * L2_W + L2_LRU];
      return w < q.n_ways ? (kc != K_INVALID ? lru : SCORE_NEG) : SCORE_BIG;
    });
  };
  auto rmm_victim_of = [&]() {
    return wp.first_min(RMM_ENTRIES, [&](int e) {
      const int len = s.rmm[e * RMM_W + 1], lru = s.rmm[e * RMM_W + 3];
      return len > 0 ? lru : SCORE_NEG;
    });
  };
  auto clus_victim_of = [&]() {
    return wp.first_min(CLUS_WAYS, [&](int w) {
      const int word = crow[w * CLUS_W + 1], lru = crow[w * CLUS_W + 2];
      return word != 0 ? lru : SCORE_NEG;
    });
  };
  auto l1h_victim_of = [&]() {
    return wp.first_min(L1H_WAYS, [&](int w) {
      const int tag = l1hrow[w * L1_W], lru = l1hrow[w * L1_W + 2];
      return tag >= 0 ? lru : SCORE_NEG;
    });
  };
  auto l1_victim_of = [&]() {
    return wp.first_min(L1_WAYS, [&](int w) {
      const int tag = l1row[w * L1_W], lru = l1row[w * L1_W + 2];
      return tag >= 0 ? lru : SCORE_NEG;
    });
  };
  int l2_victim = 0, rmm_victim = 0, clus_victim = 0, l1h_victim = 0,
      l1_victim = 0;
  if (ACT && early) {
    l2_victim = l2_victim_of();
    if (k.rmm) rmm_victim = rmm_victim_of();
    if (k.clus) clus_victim = clus_victim_of();
    if (k.thp) l1h_victim = l1h_victim_of();
    l1_victim = l1_victim_of();
  }

  // ---------------- hits and their translations -------------------
  const int l1_out_ppn = l1_hit ? l1row[l1_way * L1_W + 1]
                                : wadd(l1hrow[l1h_way * L1_W + 1], vpn & 511);
  bool reg_hit, coal_hit;
  int l2_ppn_val, touch_set, tw;
  if (k.colt) {
    const int cw = first_set(coltm);
    const int cg = row[cw * L2_W + L2_CONTIG];
    reg_hit = coltm != 0 && cg == 1;
    coal_hit = coltm != 0 && cg > 1;
    l2_ppn_val = wadd(row[cw * L2_W + L2_PPN],
                      wsub(vpn, row[cw * L2_W + L2_TAG]));
    touch_set = s2;
    tw = cw;
  } else if (k.thp) {
    const int hw = first_set(hugem);
    reg_hit = gen_reg || hugem != 0;
    coal_hit = false;
    l2_ppn_val = gen_reg ? row[rw * L2_W + L2_PPN]
                         : wadd(row_h[hw * L2_W + L2_PPN],
                                wsub(vpn, wshl(hv, 9)));
    touch_set = gen_reg ? s2 : s2h;
    tw = gen_reg ? rw : hw;
  } else if (k.subr) {
    const int sw = first_set(subrm);
    const int cg = row[sw * L2_W + L2_CONTIG];
    reg_hit = subrm != 0 && cg == 1;
    coal_hit = subrm != 0 && cg > 1;
    l2_ppn_val = wadd(row[sw * L2_W + L2_PPN], sub_off);
    touch_set = s2;
    tw = sw;
  } else {
    reg_hit = gen_reg;
    coal_hit = gen_coal;
    l2_ppn_val = gen_reg ? row[rw * L2_W + L2_PPN]
                 : wadd(row[coal_way * L2_W + L2_PPN],
                        wsub(vpn, align_down(vpn, imax(hit_k, 0))));
    touch_set = s2;
    tw = gen_reg ? rw : coal_way;
  }
  const bool l2_hit = reg_hit || coal_hit;
  // the predictor was right when the chain hit at its first position
  const int pred_ok = (k.pred && gen_coal && hit_k == pred) ? 1 : 0;
  if (!k.generic) probes_used = 0;

  const int sw_r = first_set(rngm);
  const bool rmm_hit = k.rmm && rngm != 0;
  const int rmm_ppn_val = wadd(s.rmm[sw_r * RMM_W + 2],
                               wsub(vpn, s.rmm[sw_r * RMM_W]));
  const bool cl_hit = k.clus && (ctagm & cbitm) != 0;
  const int hit_cway = first_set(ctagm);
  const int ctlb_way = first_set(ctm);
  const bool ctlb_hit = k.ctlb && !l1_served && !l2_hit && ctm != 0;

  const bool side_hit = rmm_hit || cl_hit || ctlb_hit;
  const int side_ppn = rmm_hit ? rmm_ppn_val
                       : ctlb_hit ? trow[ctlb_way * CTLB_W + 1] : ppn_true;
  const bool walk = !(l1_served || l2_hit || side_hit);
  const int out = l1_served ? l1_out_ppn
                  : l2_hit  ? l2_ppn_val
                  : side_hit ? side_ppn
                             : ppn_true;
  if (!ACT) return out;

  // ---------------- latency (per-lane miss chain) -----------------
  const int cyc = l1_served ? 0
                  : reg_hit ? LAT_L2_REG
                  : coal_hit ? LAT_COAL + LAT_EXTRA_PROBE * imax(probes_used - 1, 0)
                  : side_hit ? (ctlb_hit ? LAT_CTLB : LAT_COAL)
                  : wadd(q.miss_chain, LAT_WALK);

  // ---------------- dead-entry protection -------------------------
  bool dp_bypass = false;
  if (k.dead) {
    const int dp_idx = vpn & (g.dp_n - 1);
    const int dp_ctr = s.dp[dp_idx];
    dp_bypass = walk && dp_ctr == 0;
    if (walk) s.dp[dp_idx] = imin(dp_ctr + 1, 3);
  }

  // ---------------- L2 fill (precomputed record; LRU victim) ------
  int cov_delta = 0;
  if (walk && !dp_bypass) {
    int* ve = frow + (early ? l2_victim : l2_victim_of()) * L2_W;
    const bool v_valid = ve[L2_KCLS] != K_INVALID;
    cov_delta = wsub(fill_contig, v_valid ? ve[L2_CONTIG] : 0);
    if (k.ctlb && v_valid) {
      // Victima move: a valid L2 victim drops into the cache-backed tier
      // (its old fields, read before the fill overwrites them)
      const int ev_tag = ve[L2_TAG], ev_ppn = ve[L2_PPN],
                ev_asid = ve[L2_ASID];
      int* vtrow =
          s.ctlb + (ev_tag & (g.ctlb_sets - 1)) * g.ctlb_ways * CTLB_W;
      int* c = vtrow + wp.first_min(g.ctlb_ways, [&](int w) {
        const int tag = vtrow[w * CTLB_W], lru = vtrow[w * CTLB_W + 2];
        return tag >= 0 ? lru : SCORE_NEG;
      }) * CTLB_W;
      cov_delta = wadd(cov_delta, c[0] >= 0 ? 0 : 1);
      c[0] = ev_tag;
      c[1] = ev_ppn;
      c[2] = t;
      c[3] = ev_asid;
    }
    ve[L2_TAG] = fill_tag;
    ve[L2_KCLS] = fill_k;
    ve[L2_CONTIG] = fill_contig;
    ve[L2_PPN] = fill_ppn;
    ve[L2_LRU] = t;
    ve[L2_ASID] = cur;
    ve[L2_AUX] = fill_aux;
  }
  // the LRU touches go into the already-filled arrays (a hit and a fill
  // never happen in one step, but the order is the reference's)
  if (l2_hit && !walk && !l1_served)
    s.l2[(touch_set * W + tw) * L2_W + L2_LRU] = t;
  if (ctlb_hit) trow[ctlb_way * CTLB_W + 2] = t;

  // ---------------- side fills (gated) ----------------------------
  if (k.rmm) {
    if (walk) {
      int* x = s.rmm + (early ? rmm_victim : rmm_victim_of()) * RMM_W;
      cov_delta = wadd(cov_delta, wsub(rl_v, x[1] > 0 ? x[1] : 0));
      x[0] = rs_v;
      x[1] = rl_v;
      x[2] = rmm_fill_ppn;
      x[3] = t;
      x[4] = cur;
    }
    if (rmm_hit) s.rmm[sw_r * RMM_W + 3] = t;
  }
  if (k.clus) {
    if (walk && bm != wshl(1, vpn & 7)) {   // clusterable
      int* c = crow + (early ? clus_victim : clus_victim_of()) * CLUS_W;
      c[0] = cwd;
      c[1] = bm;
      c[2] = t;
      c[3] = cur;
    }
    if (cl_hit) crow[hit_cway * CLUS_W + 2] = t;
  }

  // ---------------- L1 fills --------------------------------------
  if (!l1_served && served_huge) {
    int* e = l1hrow + (early ? l1h_victim : l1h_victim_of()) * L1_W;
    e[0] = hv;
    e[1] = fill_ppn;
    e[2] = t;
    e[3] = cur;
  }
  if (k.thp && l1_served && h_any && !l1_hit) l1hrow[l1h_way * L1_W + 2] = t;
  if (!l1_served && !served_huge) {
    int* e = l1row + (early ? l1_victim : l1_victim_of()) * L1_W;
    e[0] = vpn;
    e[1] = ppn_true;
    e[2] = t;
    e[3] = cur;
  }
  if (l1_hit) l1row[l1_way * L1_W + 2] = t;

  // ---------------- predictor update (gated) ----------------------
  if (k.pred && gen_coal) {
    r.pred = hit_k;
  } else if (k.pred && walk && fill_k >= 0) {
    r.pred = fill_k;
  }

  // ---------------- accounting ------------------------------------
  int* c = r.cnt;
  c[C_L1] = wadd(c[C_L1], l1_served ? 1 : 0);
  c[C_REG] = wadd(c[C_REG], (reg_hit && !l1_served) ? 1 : 0);
  c[C_COAL] = wadd(c[C_COAL],
                   ((coal_hit || side_hit) && !reg_hit && !l1_served) ? 1 : 0);
  c[C_WALK] = wadd(c[C_WALK], walk ? 1 : 0);
  c[C_PROBE] = wadd(c[C_PROBE], (coal_hit && !l1_served) ? probes_used : 0);
  // dead-protect rides C_PRED: bypassed fills count as predictions
  c[C_PRED] = wadd(c[C_PRED], (l1_served ? 0 : pred_ok) + (dp_bypass ? 1 : 0));
  c[C_CYC] = wadd(c[C_CYC], cyc);
  c[C_COV] = wadd(c[C_COV], cov_delta);
  // the sample slot uses the pre-increment t and the post-add counters
  if (r.smp == 0) {
    s.cov[imin(t / q.sample_every, N_COV_SAMPLES - 1)] = c[C_COV];
    r.smp = q.sample_every;
  }
  r.smp -= 1;
  r.t = t + 1;
  // every thread wrote the same values; the next step's way threads read
  // entries other threads wrote
  wp.sync();
  return out;
}

// Does [lo, lo + ln) hold a dirty vpn?  `dc` is the [P + 1] prefix sum of
// the entered epoch's dirty bitmap; both ends are clipped to [0, P].
TLB_HD bool rng_dirty(const int* dc, int P, int lo, int ln) {
  const int lo_ = iclip(lo, 0, P);
  const int hi_ = iclip(wadd(lo, ln), 0, P);
  return wsub(dc[hi_], dc[lo_]) > 0;
}

// The coherence shootdown over the entries this thread owns (entry i with
// i % nthr == tid, in every structure).  Returns the thread's share of
// the invalidated-entry count and of the coverage released; the caller
// sums the shares and charges the counters (shoot_charge).
TLB_HD void shoot_share(const LaneParams& q, const LaneGeom& g,
                        const LaneState& s, const int* dc, int P, int tid,
                        int nthr, int* n_inv, int* cov_loss) {
  int n = 0, loss = 0;
  for (int i = tid; i < g.sets * g.ways; i += nthr) {
    int* e = s.l2 + i * L2_W;
    const int kv = e[L2_KCLS], tag = e[L2_TAG], cg = e[L2_CONTIG];
    // k == HUGE is a 2MB entry (tag = vpn >> 9) only on THP lanes
    const bool huge2 = q.is_thp && kv == K_HUGE;
    const bool subr2 = q.is_subr && kv == K_SUBR;
    const int lo = imax(huge2 ? wshl(tag, 9) : tag, 0);
    const int ln = huge2 ? 512 : subr2 ? SUBR_PAGES
                   : kv == K_REGULAR ? 1 : imax(cg, 1);
    if (kv != K_INVALID && rng_dirty(dc, P, lo, ln)) {
      e[L2_KCLS] = K_INVALID;
      n += 1;
      loss = wadd(loss, cg);
    }
  }
  for (int i = tid; i < L1_SETS * L1_WAYS; i += nthr) {
    int* e = s.l1 + i * L1_W;
    if (e[0] >= 0 && rng_dirty(dc, P, e[0], 1)) {
      e[0] = -1;
      n += 1;
    }
  }
  for (int i = tid; i < L1H_SETS * L1H_WAYS; i += nthr) {
    int* e = s.l1h + i * L1_W;
    if (e[0] >= 0 && rng_dirty(dc, P, wshl(e[0], 9), 512)) {
      e[0] = -1;
      n += 1;
    }
  }
  for (int i = tid; i < RMM_ENTRIES; i += nthr) {
    int* r = s.rmm + i * RMM_W;
    const int rl0 = r[1];
    if (rl0 > 0 && rng_dirty(dc, P, imax(r[0], 0), rl0)) {
      r[0] = -1;
      r[1] = 0;
      r[2] = -1;
      n += 1;
      loss = wadd(loss, rl0);
    }
  }
  for (int i = tid; i < CLUS_SETS * CLUS_WAYS; i += nthr) {
    int* c = s.clus + i * CLUS_W;
    if (c[1] != 0 && rng_dirty(dc, P, wshl(imax(c[0], 0), 3), 8)) {
      c[1] = 0;
      n += 1;
    }
  }
  for (int i = tid; i < g.ctlb_sets * g.ctlb_ways; i += nthr) {
    int* c = s.ctlb + i * CTLB_W;
    if (c[0] >= 0 && rng_dirty(dc, P, c[0], 1)) {
      c[0] = -1;
      n += 1;
      loss += 1;
    }
  }
  *n_inv = n;
  *cov_loss = loss;
}

TLB_HD void shoot_charge(const LaneParams& q, const LaneState& s, int n_inv,
                         int cov_loss) {
  s.cnt[C_SHOOT] = wadd(s.cnt[C_SHOOT], n_inv);
  s.cnt[C_CYC] = wadd(s.cnt[C_CYC],
                      wadd(q.coh_hw ? 0 : LAT_SHOOTDOWN,
                           n_inv * LAT_INVALIDATE));
  s.cnt[C_COV] = wsub(s.cnt[C_COV], cov_loss);
}

// The context switch's bulk clear over the entries this thread owns:
// every valid entry under flush_all, else those tagged new_asid under
// flush_asid.  The ASID update and the charge are switch_charge.
TLB_HD void switch_share(const LaneGeom& g, const LaneState& s, int new_asid,
                         bool flush_all, bool flush_asid, int tid, int nthr,
                         int* n_inv, int* cov_loss) {
  int n = 0, loss = 0;
#define TLB_KILL(valid, asid) \
  ((valid) && (flush_all || (flush_asid && (asid) == new_asid)))
  for (int i = tid; i < g.sets * g.ways; i += nthr) {
    int* e = s.l2 + i * L2_W;
    if (TLB_KILL(e[L2_KCLS] != K_INVALID, e[L2_ASID])) {
      e[L2_KCLS] = K_INVALID;
      n += 1;
      loss = wadd(loss, e[L2_CONTIG]);
    }
  }
  for (int i = tid; i < L1_SETS * L1_WAYS; i += nthr) {
    int* e = s.l1 + i * L1_W;
    if (TLB_KILL(e[0] >= 0, e[3])) {
      e[0] = -1;
      n += 1;
    }
  }
  for (int i = tid; i < L1H_SETS * L1H_WAYS; i += nthr) {
    int* e = s.l1h + i * L1_W;
    if (TLB_KILL(e[0] >= 0, e[3])) {
      e[0] = -1;
      n += 1;
    }
  }
  for (int i = tid; i < RMM_ENTRIES; i += nthr) {
    int* r = s.rmm + i * RMM_W;
    const int rl0 = r[1];
    if (TLB_KILL(rl0 > 0, r[4])) {
      r[0] = -1;
      r[1] = 0;
      r[2] = -1;
      n += 1;
      loss = wadd(loss, rl0);
    }
  }
  for (int i = tid; i < CLUS_SETS * CLUS_WAYS; i += nthr) {
    int* c = s.clus + i * CLUS_W;
    if (TLB_KILL(c[1] != 0, c[3])) {
      c[1] = 0;
      n += 1;
    }
  }
  for (int i = tid; i < g.ctlb_sets * g.ctlb_ways; i += nthr) {
    int* c = s.ctlb + i * CTLB_W;
    if (TLB_KILL(c[0] >= 0, c[3])) {
      c[0] = -1;
      n += 1;
      loss += 1;
    }
  }
#undef TLB_KILL
  *n_inv = n;
  *cov_loss = loss;
}

TLB_HD void switch_charge(const LaneState& s, int new_asid, bool do_switch,
                          int n_inv, int cov_loss) {
  s.misc[M_ASID] = new_asid;
  s.cnt[C_SHOOT] = wadd(s.cnt[C_SHOOT], n_inv);
  s.cnt[C_CYC] = wadd(s.cnt[C_CYC], do_switch ? LAT_CTX_SWITCH : 0);
  s.cnt[C_COV] = wsub(s.cnt[C_COV], cov_loss);
}
