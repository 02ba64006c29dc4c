// One lane of the batched TLB sweep: state layout, the per-access step and
// the segment-entry passes (context switch, coherence shootdown).
//
// This is the arithmetic of the JAX package's lane program
// (src/repro/core/lane_program.py: step_access, shoot_lane, switch_lane)
// written for ONE lane whose whole state lives in one contiguous int32
// block (shared memory in the kernel).  It is plain C++ apart from the
// TLB_HD qualifier, so the host compiler can build it too.
//
// Bit-exactness rules, each mirrored from the reference and each held by a
// test against the plain torch version (tests/test_torch_sweep.py on the
// CPU, tests/test_torch_cuda.py on the card):
//  * first-index semantics: jnp.argmax over an all-False mask is 0, and
//    that index is only used under a gate (first_true below keeps 0);
//  * victim choice: jnp.argmin returns the FIRST minimum; padded ways
//    score BIG, invalid ways NEG (strict '<' keeps the first);
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
#define TLB_LDG(p) __ldg(p)
#else
#define TLB_HD inline
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

// Per-lane geometry; every structure is one int32 block, fields last.
struct LaneGeom {
  int sets, ways, ctlb_sets, ctlb_ways, dp_n;
};

TLB_HD int lane_state_words(const LaneGeom& g) {
  return L1_SETS * L1_WAYS * L1_W + L1H_SETS * L1H_WAYS * L1_W +
         g.sets * g.ways * L2_W + RMM_ENTRIES * RMM_W +
         CLUS_SETS * CLUS_WAYS * CLUS_W + g.ctlb_sets * g.ctlb_ways * CTLB_W +
         g.dp_n + MISC_W + N_COUNTERS + N_COV_SAMPLES;
}

struct LaneState {
  int *l1, *l1h, *l2, *rmm, *clus, *ctlb, *dp, *misc, *cnt, *cov;
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
  return s;
}

// Word i (0 <= i < lane_state_words) of the fresh state, as the reference
// initialises it: tag/start planes -1, L2 kcls INVALID and ppn -1, the
// rest 0 (t, counters and samples 0; pred and asid are set by the caller).
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

// Per-lane scalars, read once from the params row and the kvals row.
struct LaneParams {
  int is_colt, is_thp, is_subr, is_generic, has_rmm, has_cluster, has_ctlb,
      use_dead, coh_hw, use_pred, set_mask, n_ways, k_hat, miss_chain,
      t_real, sample_every, maxk;
  int kv[MAXK_CAP];
};

TLB_HD LaneParams load_params(const int* p, const int* kv, int maxk) {
  LaneParams q;
  q.is_colt = p[F_IS_COLT] == 1;
  q.is_thp = p[F_IS_THP] == 1;
  q.is_subr = p[F_IS_SUBR] == 1;
  q.is_generic = !q.is_colt && !q.is_thp && !q.is_subr;
  q.has_rmm = p[F_HAS_RMM] == 1;
  q.has_cluster = p[F_HAS_CLUSTER] == 1;
  q.has_ctlb = p[F_HAS_CTLB] == 1;
  q.use_dead = p[F_USE_DEAD] == 1;
  q.coh_hw = p[F_COH_HW] == 1;
  q.use_pred = p[F_USE_PRED] == 1;
  q.set_mask = p[F_SET_MASK];
  q.n_ways = p[F_N_WAYS];
  q.k_hat = p[F_K_HAT];
  q.miss_chain = p[F_MISS_CHAIN];
  q.t_real = p[F_T_REAL];
  q.sample_every = p[F_SAMPLE_EVERY];
  q.maxk = maxk;
  for (int i = 0; i < MAXK_CAP; ++i) q.kv[i] = i < maxk ? kv[i] : -1;
  return q;
}

// LRU victim over `n` ways of a packed row: the first way with the least
// score, score = lru of a valid way, NEG for an invalid one (jnp.argmin).
// `valid_field`/`valid_kind` say how validity is read: tag >= 0, a
// non-zero word, a positive length, or kcls != INVALID.
enum ValidKind { V_TAG_NONNEG, V_NONZERO, V_POSITIVE };

TLB_HD int lru_victim(const int* row, int n, int width, int valid_field,
                      ValidKind vk, int lru_field) {
  int best = 0, best_score = 0;
  for (int w = 0; w < n; ++w) {
    int v = row[w * width + valid_field];
    bool valid = vk == V_TAG_NONNEG ? v >= 0 : vk == V_NONZERO ? v != 0 : v > 0;
    int score = valid ? row[w * width + lru_field] : SCORE_NEG;
    if (w == 0 || score < best_score) {
      best = w;
      best_score = score;
    }
  }
  return best;
}

// One access of one lane (step_access).  `act` is false on padded steps:
// nothing is written except the returned ppn.  `mrec`/`frec`/`bm` are the
// live segment's map record, fill record and cluster word at `vpn`.
TLB_HD int step_access(const LaneParams& q, const LaneGeom& g,
                       const LaneState& s, int vpn, const int* mrec,
                       const int* frec, int bm, bool act) {
  const int t = s.misc[M_T];
  const int pred = s.misc[M_PRED];
  const int cur = s.misc[M_ASID];
  const int ppn_true = mrec[0], rs_v = mrec[1], rl_v = mrec[2],
            rmm_fill_ppn = mrec[3];
  const int fill_tag = frec[0], fill_k = frec[1], fill_contig = frec[2],
            fill_ppn = frec[3], fill_aux = frec[4];
  const int W = g.ways;

  // ---------------- L1 (regular + gated 2MB array) ----------------
  const int s1 = vpn & (L1_SETS - 1);
  int* l1row = s.l1 + s1 * L1_WAYS * L1_W;
  bool l1_hit = false;
  int l1_way = 0;                       // argmax of an all-False mask is 0
  for (int w = 0; w < L1_WAYS; ++w) {
    if (!l1_hit && l1row[w * L1_W] == vpn && l1row[w * L1_W + 3] == cur) {
      l1_hit = true;
      l1_way = w;
    }
  }
  const int hv = vpn >> 9;              // arithmetic, as jnp
  const int s1h = hv & (L1H_SETS - 1);
  int* l1hrow = s.l1h + s1h * L1H_WAYS * L1_W;
  bool h_any = false;
  int l1h_way = 0;
  for (int w = 0; q.is_thp && w < L1H_WAYS; ++w) {   // read on THP lanes only
    if (!h_any && l1hrow[w * L1_W] == hv && l1hrow[w * L1_W + 3] == cur) {
      h_any = true;
      l1h_way = w;
    }
  }
  const bool l1h_hit = q.is_thp && h_any;
  const bool l1_served = l1_hit || l1h_hit;
  const int l1_out_ppn = l1_hit ? l1row[l1_way * L1_W + 1]
                                : wadd(l1hrow[l1h_way * L1_W + 1], vpn & 511);

  // ---------------- L2 probes (all kinds, selected) ---------------
  // Each kind's probe runs only on lanes of that kind: its result is read
  // only under the same flag, so skipping it elsewhere changes nothing.
  const int s2 = (vpn >> q.k_hat) & q.set_mask;
  const int* row = s.l2 + s2 * W * L2_W;
  const int s2h = hv & q.set_mask;
  const int* row_h = s.l2 + s2h * W * L2_W;
  const int sub_base = vpn & ~(SUBR_PAGES - 1);
  const int sub_off = vpn & (SUBR_PAGES - 1);
  bool colt_hit = false, reg_any = false, huge_hit = false, subr_hit = false;
  int colt_way = 0, rw = 0, hw = 0, subr_way = 0;
  for (int w = 0; w < W; ++w) {
    const int* e = row + w * L2_W;
    const int tag = e[L2_TAG], kc = e[L2_KCLS], cg = e[L2_CONTIG];
    const bool valid = kc != K_INVALID && e[L2_ASID] == cur;
    const int diff = wsub(vpn, tag);
    if (q.is_colt && !colt_hit && valid && diff >= 0 && diff < cg) {
      colt_hit = true;
      colt_way = w;
    }
    if (!reg_any && kc == K_REGULAR && tag == vpn && valid) {
      reg_any = true;
      rw = w;
    }
    if (q.is_subr && !subr_hit && valid && kc == K_SUBR && tag == sub_base &&
        ((e[L2_AUX] >> sub_off) & 1) == 1) {
      subr_hit = true;
      subr_way = w;
    }
    if (q.is_thp && !huge_hit) {
      const int* eh = row_h + w * L2_W;
      if (eh[L2_KCLS] == K_HUGE && eh[L2_TAG] == hv && eh[L2_ASID] == cur) {
        huge_hit = true;
        hw = w;
      }
    }
  }
  const int colt_cg = row[colt_way * L2_W + L2_CONTIG];
  const bool colt_reg = colt_hit && colt_cg == 1;
  const bool colt_coal = colt_hit && colt_cg > 1;
  const int colt_ppn = wadd(row[colt_way * L2_W + L2_PPN],
                            wsub(vpn, row[colt_way * L2_W + L2_TAG]));
  const bool thp_reg = reg_any || huge_hit;
  const int thp_ppn = reg_any ? row[rw * L2_W + L2_PPN]
                              : wadd(row_h[hw * L2_W + L2_PPN],
                                     wsub(vpn, wshl(hv, 9)));
  const int thp_touch_set = reg_any ? s2 : s2h;
  const int thp_touch_way = reg_any ? rw : hw;
  const int subr_cg = row[subr_way * L2_W + L2_CONTIG];
  const bool subr_reg = subr_hit && subr_cg == 1;
  const bool subr_coal = subr_hit && subr_cg > 1;
  const int subr_ppn = wadd(row[subr_way * L2_W + L2_PPN], sub_off);

  // generic branch: regular probe + padded aligned-probe chain, in the
  // predictor's order [pred, remaining K in packed order] or as packed.
  // Its results are read on generic lanes and through the predictor only;
  // once a probe hit (or the regular probe did) no later slot is live.
  const bool gen_reg = reg_any;
  int probes_used = 0, hit_k = -1, coal_ppn = -1, coal_way = 0;
  bool gen_coal = false;
  int first_probe_k = -1;
  const int chain = (q.is_generic || q.use_pred) ? q.maxk : 0;
  for (int pos = 0; pos < chain; ++pos) {
    if (pos > 0 && (gen_reg || gen_coal)) break;
    int k_val;
    if (pos == 0) {
      k_val = q.use_pred ? pred : q.kv[0];
    } else if (q.use_pred) {
      // the pos-th kvals entry (1-based) that differs from pred, else -1
      k_val = -1;
      int cnt = 0;
      for (int i = 0; i < q.maxk; ++i) {
        if (q.kv[i] != pred && ++cnt == pos) {
          k_val = q.kv[i];
          break;
        }
      }
    } else {
      k_val = q.kv[pos];
    }
    if (pos == 0) first_probe_k = k_val;
    const int sh = imax(k_val, 0);
    const int vk = k_val >= 0 ? (vpn & ~(wshl(1, sh) - 1)) : -10;
    const bool live = !gen_reg && !gen_coal && k_val >= 0;
    bool m_any = false;
    int mw = 0;
    for (int w = 0; live && w < W; ++w) {
      const int* e = row + w * L2_W;
      if (!m_any && e[L2_KCLS] == k_val && e[L2_TAG] == vk &&
          e[L2_KCLS] != K_INVALID && e[L2_ASID] == cur &&
          e[L2_CONTIG] > wsub(vpn, vk)) {
        m_any = true;
        mw = w;
      }
    }
    const bool m_hit = m_any && live;
    probes_used += live ? 1 : 0;
    if (m_hit) {
      coal_ppn = wadd(row[mw * L2_W + L2_PPN], wsub(vpn, vk));
      coal_way = mw;
      hit_k = k_val;
    }
    gen_coal = gen_coal || m_hit;
  }

  // per-lane branch selection
  bool reg_hit, coal_hit;
  int l2_ppn_val, touch_set, tw;
  if (q.is_colt) {
    reg_hit = colt_reg; coal_hit = colt_coal; l2_ppn_val = colt_ppn;
    touch_set = s2; tw = colt_way;
  } else if (q.is_thp) {
    reg_hit = thp_reg; coal_hit = false; l2_ppn_val = thp_ppn;
    touch_set = thp_touch_set; tw = thp_touch_way;
  } else if (q.is_subr) {
    reg_hit = subr_reg; coal_hit = subr_coal; l2_ppn_val = subr_ppn;
    touch_set = s2; tw = subr_way;
  } else {
    reg_hit = gen_reg; coal_hit = gen_coal;
    l2_ppn_val = gen_reg ? row[rw * L2_W + L2_PPN] : coal_ppn;
    touch_set = s2; tw = gen_reg ? rw : coal_way;
  }
  const bool l2_hit = reg_hit || coal_hit;
  const int pred_ok = (q.use_pred && gen_coal && hit_k == first_probe_k) ? 1 : 0;
  if (!q.is_generic) probes_used = 0;

  // ---------------- side structures (gated) -----------------------
  bool rng_any = false;
  int sw = 0;
  for (int e = 0; q.has_rmm && e < RMM_ENTRIES; ++e) {
    const int* r = s.rmm + e * RMM_W;
    const int d = wsub(vpn, r[0]);
    if (!rng_any && d >= 0 && d < r[1] && r[4] == cur) {
      rng_any = true;
      sw = e;
    }
  }
  const bool rmm_hit = q.has_rmm && rng_any;
  const int rmm_ppn_val = wadd(s.rmm[sw * RMM_W + 2],
                               wsub(vpn, s.rmm[sw * RMM_W]));

  const int cwd = vpn >> 3;
  const int sc = cwd & (CLUS_SETS - 1);
  int* crow = s.clus + sc * CLUS_WAYS * CLUS_W;
  bool c_any = false, hc_any = false;
  int hit_cway = 0;
  for (int w = 0; q.has_cluster && w < CLUS_WAYS; ++w) {
    const int* c = crow + w * CLUS_W;
    const bool tag_ok = c[0] == cwd && c[3] == cur;
    if (tag_ok && ((c[1] >> (vpn & 7)) & 1) == 1) c_any = true;
    if (!hc_any && tag_ok) {
      hc_any = true;
      hit_cway = w;
    }
  }
  const bool cl_hit = q.has_cluster && c_any;

  // cache-backed tier: probed only past an L1+L2 miss
  const int sct = vpn & (g.ctlb_sets - 1);
  int* trow = s.ctlb + sct * g.ctlb_ways * CTLB_W;
  bool t_any = false;
  int ctlb_way = 0;
  for (int w = 0; q.has_ctlb && w < g.ctlb_ways; ++w) {
    if (!t_any && trow[w * CTLB_W] == vpn && trow[w * CTLB_W + 3] == cur) {
      t_any = true;
      ctlb_way = w;
    }
  }
  const bool ctlb_hit = q.has_ctlb && !l1_served && !l2_hit && t_any;

  const bool side_hit = rmm_hit || cl_hit || ctlb_hit;
  const int side_ppn = rmm_hit ? rmm_ppn_val
                       : ctlb_hit ? trow[ctlb_way * CTLB_W + 1] : ppn_true;
  const bool walk = !(l1_served || l2_hit || side_hit);
  const bool wr = walk && act;

  // ---------------- latency (per-lane miss chain) -----------------
  const int cyc = l1_served ? 0
                  : reg_hit ? LAT_L2_REG
                  : coal_hit ? LAT_COAL + LAT_EXTRA_PROBE * imax(probes_used - 1, 0)
                  : side_hit ? (ctlb_hit ? LAT_CTLB : LAT_COAL)
                  : wadd(q.miss_chain, LAT_WALK);

  // ---------------- dead-entry protection -------------------------
  const int dp_idx = vpn & (g.dp_n - 1);
  const int dp_ctr = s.dp[dp_idx];
  const bool dp_bypass = q.use_dead && walk && dp_ctr == 0;
  if (q.use_dead && wr) s.dp[dp_idx] = imin(dp_ctr + 1, 3);

  // ---------------- L2 fill (precomputed record; LRU victim) ------
  // Victim scans run only when their fill happens: the victim is read by
  // nothing else.
  const bool served_huge = q.is_thp && fill_k == K_HUGE;
  const int fill_set = served_huge ? s2h : s2;
  const bool fill_wr = wr && !dp_bypass;
  int cov_delta = 0;
  if (fill_wr) {
    int* frow = s.l2 + fill_set * W * L2_W;
    int victim = 0, best = 0;
    for (int w = 0; w < W; ++w) {       // first minimum (jnp.argmin)
      const int* e = frow + w * L2_W;
      const int score = w < q.n_ways
                            ? (e[L2_KCLS] != K_INVALID ? e[L2_LRU] : SCORE_NEG)
                            : SCORE_BIG;
      if (w == 0 || score < best) {
        victim = w;
        best = score;
      }
    }
    int* ve = frow + victim * L2_W;
    const bool v_valid = ve[L2_KCLS] != K_INVALID;
    cov_delta = wsub(fill_contig, v_valid ? ve[L2_CONTIG] : 0);
    // the victim's old fields, read before the fill overwrites them
    const int ev_tag = ve[L2_TAG], ev_ppn = ve[L2_PPN], ev_asid = ve[L2_ASID];
    ve[L2_TAG] = fill_tag;
    ve[L2_KCLS] = fill_k;
    ve[L2_CONTIG] = fill_contig;
    ve[L2_PPN] = fill_ppn;
    ve[L2_LRU] = t;
    ve[L2_ASID] = cur;
    ve[L2_AUX] = fill_aux;
    // Victima move: a valid L2 victim drops into the cache-backed tier
    if (q.has_ctlb && v_valid) {
      int* vtrow = s.ctlb + (ev_tag & (g.ctlb_sets - 1)) * g.ctlb_ways * CTLB_W;
      const int victim_t = lru_victim(vtrow, g.ctlb_ways, CTLB_W, 0,
                                      V_TAG_NONNEG, 2);
      int* c = vtrow + victim_t * CTLB_W;
      cov_delta = wadd(cov_delta, c[0] >= 0 ? 0 : 1);
      c[0] = ev_tag;
      c[1] = ev_ppn;
      c[2] = t;
      c[3] = ev_asid;
    }
  }
  // the LRU touches go into the already-filled arrays (a hit and a fill
  // never happen in one step, but the order is the reference's)
  if (l2_hit && !walk && !l1_served && act)
    s.l2[(touch_set * W + tw) * L2_W + L2_LRU] = t;
  if (ctlb_hit && act) trow[ctlb_way * CTLB_W + 2] = t;

  // ---------------- side fills (gated) ----------------------------
  if (wr && q.has_rmm) {
    const int victim_r = lru_victim(s.rmm, RMM_ENTRIES, RMM_W, 1,
                                    V_POSITIVE, 3);
    int* r = s.rmm + victim_r * RMM_W;
    cov_delta = wadd(cov_delta, wsub(rl_v, r[1] > 0 ? r[1] : 0));
    r[0] = rs_v;
    r[1] = rl_v;
    r[2] = rmm_fill_ppn;
    r[3] = t;
    r[4] = cur;
  }
  if (rmm_hit && act) s.rmm[sw * RMM_W + 3] = t;

  if (wr && q.has_cluster && bm != wshl(1, vpn & 7)) {   // clusterable
    int* c = crow + lru_victim(crow, CLUS_WAYS, CLUS_W, 1, V_NONZERO, 2) * CLUS_W;
    c[0] = cwd;
    c[1] = bm;
    c[2] = t;
    c[3] = cur;
  }
  if (cl_hit && act) crow[hit_cway * CLUS_W + 2] = t;

  // ---------------- L1 fills --------------------------------------
  if (!l1_served && served_huge && act) {
    int* e = l1hrow + lru_victim(l1hrow, L1H_WAYS, L1_W, 0, V_TAG_NONNEG, 2) * L1_W;
    e[0] = hv;
    e[1] = fill_ppn;
    e[2] = t;
    e[3] = cur;
  }
  if (q.is_thp && l1_served && h_any && !l1_hit && act)
    l1hrow[l1h_way * L1_W + 2] = t;
  if (!l1_served && !served_huge && act) {
    int* e = l1row + lru_victim(l1row, L1_WAYS, L1_W, 0, V_TAG_NONNEG, 2) * L1_W;
    e[0] = vpn;
    e[1] = ppn_true;
    e[2] = t;
    e[3] = cur;
  }
  if (l1_hit && act) l1row[l1_way * L1_W + 2] = t;

  // ---------------- predictor update (gated) ----------------------
  const bool upd = q.use_pred && act;
  if (upd && gen_coal) {
    s.misc[M_PRED] = hit_k;
  } else if (upd && walk && fill_k >= 0) {
    s.misc[M_PRED] = fill_k;
  }

  // ---------------- accounting ------------------------------------
  int* c = s.cnt;
  if (act) {
    c[C_L1] = wadd(c[C_L1], l1_served ? 1 : 0);
    c[C_REG] = wadd(c[C_REG], (reg_hit && !l1_served) ? 1 : 0);
    c[C_COAL] = wadd(c[C_COAL],
                     ((coal_hit || side_hit) && !reg_hit && !l1_served) ? 1 : 0);
    c[C_WALK] = wadd(c[C_WALK], walk ? 1 : 0);
    c[C_PROBE] = wadd(c[C_PROBE], (coal_hit && !l1_served) ? probes_used : 0);
    // dead-protect rides C_PRED: bypassed fills count as predictions
    c[C_PRED] = wadd(c[C_PRED],
                     (l1_served ? 0 : pred_ok) + (dp_bypass ? 1 : 0));
    c[C_CYC] = wadd(c[C_CYC], cyc);
  }
  c[C_COV] = wadd(c[C_COV], cov_delta);  // every term is gated by act
  if (act) {
    // the sample slot uses the pre-increment t and the post-add counters
    const int se = q.sample_every;
    if (t % se == se - 1) s.cov[imin(t / se, N_COV_SAMPLES - 1)] = c[C_COV];
    s.misc[M_T] = t + 1;
  }

  return l1_served ? l1_out_ppn
         : l2_hit  ? l2_ppn_val
         : side_hit ? side_ppn
                    : ppn_true;
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
