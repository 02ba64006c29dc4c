// One class-k pass of paged decode attention as CUDA kernels for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/paged_attention/paged_attention.py::
// _class_kernel of the JAX package (a Pallas kernel over a (B, n_win) grid
// whose BlockSpec index map reads the scalar-prefetched window table and
// loads one contiguous 2^k-page K/V tile per grid step, carrying the
// online-softmax state across the window axis in its revisited outputs).
//
// What it computes (the function of the split and combine kernels below,
// together): for batch row b and KV head h, walk the class's windows
// j = 0 .. n_win-1 in order and skip those with covered[b, j] == 0.  A
// covered window is the W = 2^k * T tokens that start at token
// win_idx[b, j] * W of the pool (the pool [n_pages, T, KVH, D] viewed as
// [n_pages / 2^k, W, KVH, D]).  Token t of window j has position j*W + t.
// The G = H / KVH query rows of head h score each token in f32:
// s = (q . k) / sqrt(D), or exactly NEG_INF = -1e30 where the position is
// >= kv_lens[b].  The unnormalised online-softmax state of each query row,
//   m_new = max(m, max s);  alpha = exp(m - m_new);  p = exp(s - m_new)
//   l = l * alpha + sum p;   o = o * alpha + p @ v
// starts at (o, m, l) = (0, -1e30, 0) and is written out as o [B, H, D],
// m [B, H], l [B, H], all f32.  The -1e30 is the Pallas kernel's and is
// kept as it is, not replaced by -inf: a covered window wholly past
// kv_lens (pages reserved for tokens not generated yet) gives m = -1e30,
// p = exp(0) = 1 and a finite l and o that merge_partials weights by
// exp(-1e30 - m*) = 0; with -inf it would be NaN.  A row with no covered
// window keeps (0, -1e30, 0).
//
// The state is updated once per chunk of at most 64 token slots, not once
// per window as the Pallas kernel does.  This is the same function:
// positions past kv_lens are the tail of a row, so a chunk that is wholly
// masked either follows live tokens (p = 0, alpha = 1: no change) or
// belongs to a class with no live token at all (each masked token adds
// p = 1, as in the per-window update).
//
// What bounds it: bytes.  Every K and V element of the covered windows is
// read once (2 * W * D elements per window and head), against ~4 flops per
// element (a multiply-add for the score, one for p @ v): at G = 2 query
// rows per head, about one flop per byte in bf16, far below the ~295 the
// card needs before compute is the limit.  So the card's 3.35 TB/s has to
// be kept busy: enough blocks on the 132 SMs, and enough copies in flight
// in each.
//
// What the design does about it:
//
// * The windows of a row are split over blocks (flash-decoding).  The grid
//   is (KVH, B, n_split); split s walks the contiguous window range
//   [s * n_win / n_split, (s + 1) * n_win / n_split) with the chunked
//   online softmax below and writes its partial (o, m, l) to an f32
//   scratch [n_split, B, H, D + 2].  The wrapper picks n_split so that
//   the grid has at least two blocks per SM where the windows allow it
//   (ops.choose_splits): a 32k-token row of one request is walked by 32
//   blocks per KV head, not one.  A second kernel, launched right after on
//   the same stream by the same C call, combines the splits of each query
//   row exactly: m = max m_s, l = sum l_s exp(m_s - m), o = sum o_s
//   exp(m_s - m).  The -1e30 semantics survive the split:
//   - a split with no covered window writes (0, -1e30, 0), which weighs
//     exp(-1e30 - m) = 0 against any live split, and 1 against others;
//   - a split whose covered windows lie wholly past kv_lens writes finite
//     junk at m = -1e30 (each masked token adds p = 1), which a live split
//     weights by exp(-1e30 - m*) = 0;
//   - if every split is junk, m = -1e30, every weight is exp(0) = 1 and
//     the l's and o's add up as the one walk over all windows would.
//   Within a split, once a live token has been staged, the walk stops at
//   the first token slot past kv_lens: the slots after it would add p =
//   exp(-1e30 - m) = 0 with alpha = 1, no change.
// * One block of 256 threads per (KV head, batch row, split), so the G
//   query rows that share a KV head read each K/V row once.
// * A chunk is up to 64 covered token slots in walk order, gathered from
//   as many windows as it takes (a class-0 window holds only T = 16), so
//   that a split over many small windows walks few chunks.  Its K and V
//   rows are copied into shared memory by the whole block with 16-byte
//   asynchronous copies (cp.async), into a three-stage ring in dynamic
//   shared memory, rows padded by 16 bytes: the copies run two chunks
//   ahead of the arithmetic, so two trips to device memory overlap it.
// * Scores: each half of the block (128 threads) sums one half of the head
//   dims; thread i of a half takes query row i / n and token i % n of the
//   chunk, reading the token's K row 16 bytes at a time (a warp's 32 rows
//   fall in distinct banks) and the q row as f32 (one address for the
//   warp, a broadcast), with no shuffles.  One warp per query row masks
//   and adds the halves, reduces the chunk's max and sum and updates
//   (m, l).  p @ v: thread i of half s owns column i (and i + 128) of o
//   for the chunk's tokens s, s + 2, ...; the halves' shares of o are
//   added once, at the end of the split.
// Later versions: fold all classes and the merge into one launch.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block: two halves of 128
constexpr int HALF = NT / 2;
constexpr int NWARP = NT / 32;
constexpr int STAGES = 3;        // chunks in the ring: two in flight
constexpr int CHUNK = 64;        // most tokens per online-softmax update
constexpr int STAGE_BYTES = 16384;   // shared memory for one chunk's K (or V)
constexpr int GMAX = 8;          // query rows per KV head
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// tokens per chunk: as many rows as fit the stage, at most CHUNK
template <typename T, int D>
__host__ __device__ constexpr int chunk_rows() {
  return STAGE_BYTES / (D * (int)sizeof(T)) < CHUNK
             ? STAGE_BYTES / (D * (int)sizeof(T)) : CHUNK;
}

// row stride of a staged K or V row: D elements plus 16 bytes of padding,
// so that 8 lanes reading 16 bytes of 8 consecutive rows hit distinct banks
template <typename T, int D>
__host__ __device__ constexpr int row_ld() {
  return D + 16 / (int)sizeof(T);
}

// dynamic shared memory: STAGES stages of a chunk's K and V rows
template <typename T, int D>
constexpr size_t smem_bytes() {
  return (size_t)2 * STAGES * chunk_rows<T, D>() * row_ld<T, D>() *
         sizeof(T);
}

// eight consecutive elements as f32 (16 or 32 bytes, 16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The covered token slots of one split, in order: a cursor (window j, token
// t0) over the covered windows of [j, j_end).  `advance(n, seen_live)`
// moves it past n tokens of the current window, to the first token of the
// next covered window where that one is done; the walk is over once j
// reaches j_end, or once the split has staged a live token and the cursor
// lies at or past kv_lens.
struct Walk {
  const int8_t* cov;
  int j_end, W, len;
  int j, t0;
  __device__ void skip_uncovered() {
    while (j < j_end && !cov[j]) ++j;
  }
  __device__ bool valid() const { return j < j_end; }
  __device__ int pos() const { return j * W + t0; }
  __device__ void advance(int n, bool seen_live) {
    t0 += n;
    if (t0 >= W) {
      t0 = 0;
      ++j;
      skip_uncovered();
    }
    if (seen_live && valid() && pos() >= len) j = j_end;
  }
};

template <typename T, int D>
__device__ __forceinline__ void stage_chunk(T* s_k, T* s_v, const T* kp,
                                            const T* vp, size_t base,
                                            int n, int h, int KVH, int tid) {
  constexpr int VPR = D * (int)sizeof(T) / 16;   // 16-byte copies per row
  const size_t row = (size_t)KVH * D;            // pool elements per token
  for (int i = tid; i < n * VPR; i += NT) {
    const int t = i / VPR, c = i % VPR;
    const size_t src = (base + t) * row + (size_t)h * D;
    constexpr int LD = row_ld<T, D>();
    __pipeline_memcpy_async((char*)(s_k + t * LD) + 16 * c,
                            (const char*)(kp + src) + 16 * c, 16);
    __pipeline_memcpy_async((char*)(s_v + t * LD) + 16 * c,
                            (const char*)(vp + src) + 16 * c, 16);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_class_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                         const T* __restrict__ vp,
                         const int32_t* __restrict__ win_idx,
                         const int8_t* __restrict__ covered,
                         const int32_t* __restrict__ kv_lens,
                         float* __restrict__ part, int B, int H, int KVH,
                         int G, int n_win, int W, float scale) {
  constexpr int DPT = (D + HALF - 1) / HALF;  // o columns per thread
  constexpr int CH = chunk_rows<T, D>();
  constexpr int LD = row_ld<T, D>();
  constexpr int DH = D / 2;                   // head dims of a half's dot
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = tid / HALF, ht = tid % HALF;  // warp-uniform half

  __shared__ float s_s[2][GMAX][CHUNK];     // the halves' partial scores
  __shared__ float s_p[GMAX][CHUNK];        // probabilities
  __shared__ float s_m[GMAX], s_l[GMAX], s_alpha[GMAX];
  __shared__ int s_pos[STAGES][CHUNK];      // positions of a stage's rows
  __shared__ int s_n[STAGES];               // rows a stage holds
  // the G query rows in f32; at the end, half 1's share of o
  __shared__ __align__(16) float s_q[GMAX * D];
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_k = reinterpret_cast<T*>(smem);      // stages 0 .. STAGES - 1
  T* s_v = s_k + STAGES * CH * LD;

  for (int i = tid; i < G * D; i += NT)
    s_q[i] = to_f32(q[((size_t)b * H + (size_t)h * G) * D + i]);
  float acc[GMAX][DPT];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[g][c] = 0.f;
  if (tid < GMAX) {
    s_m[tid] = NEG_INF;
    s_l[tid] = 0.f;
  }
  __syncthreads();

  const int len = kv_lens[b];
  const int32_t* wi = win_idx + (size_t)b * n_win;
  // A chunk is up to CH covered token slots in walk order, gathered from
  // as many windows as it takes (a class-0 window holds T tokens); slot r
  // of a stage holds the token at position s_pos[stage][r].  The copies
  // run STAGES - 1 chunks ahead of the arithmetic.
  Walk walk{covered + (size_t)b * n_win,
            (int)((int64_t)(split + 1) * n_win / n_split), W, len,
            (int)((int64_t)split * n_win / n_split), 0};
  walk.skip_uncovered();
  bool seen_live = false;
  int issued = 0;                           // chunks staged so far
  auto issue = [&](int slot) {
    int filled = 0;
    while (filled < CH && walk.valid()) {
      const int n = min(CH - filled, W - walk.t0);
      stage_chunk<T, D>(s_k + (slot * CH + filled) * LD,
                        s_v + (slot * CH + filled) * LD, kp, vp,
                        (size_t)wi[walk.j] * W + walk.t0, n, h, KVH, tid);
      for (int r = tid; r < n; r += NT)
        s_pos[slot][filled + r] = walk.pos() + r;
      seen_live = seen_live || walk.pos() < len;
      filled += n;
      walk.advance(n, seen_live);
    }
    if (tid == 0) s_n[slot] = filled;
    issued += filled > 0;
    __pipeline_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int c = 0; c < issued; ++c) {
    const int st = c % STAGES;
    // 0. the copies of the chunk STAGES - 1 ahead go out first
    issue((c + STAGES - 1) % STAGES);
    __pipeline_wait_prior(STAGES - 1);       // this chunk has landed
    __syncthreads();
    const int n = s_n[st];
    const int* pos = s_pos[st];
    const T* sk = s_k + st * CH * LD;
    const T* sv = s_v + st * CH * LD;
    // 1. scores: in each half, thread i takes query row i / n and token
    //    i % n and sums its half of the head dims, so that a warp reads 32
    //    K rows (16 bytes each, distinct banks) and one q row (broadcast)
    for (int i = ht; i < G * n; i += HALF) {
      const int g = i / n, t = i - g * n;
      const T* kr = sk + t * LD + half * DH;
      const float* qg = s_q + g * D + half * DH;
      float x0 = 0.f, x1 = 0.f;
#pragma unroll
      for (int d = 0; d < DH; d += 8) {
        float kf[8], qf[8];
        load8(kr + d, kf);
        load8(qg + d, qf);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x0 = fmaf(qf[e], kf[e], x0);
          x1 = fmaf(qf[e + 4], kf[e + 4], x1);
        }
      }
      s_s[half][g][t] = x0 + x1;
    }
    __syncthreads();
    // 2. mask, then the state update: warp w takes query rows w, w + NWARP
    for (int g = warp; g < G; g += NWARP) {
      float mx = NEG_INF;
      for (int t = lane; t < n; t += 32) {
        const float x = pos[t] < len
                            ? (s_s[0][g][t] + s_s[1][g][t]) * scale
                            : NEG_INF;
        s_p[g][t] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_prev = s_m[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(s_p[g][t] - m_new);
        s_p[g][t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        s_alpha[g] = alpha;
        s_l[g] = s_l[g] * alpha + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();
    // 3. o = o * alpha + p @ v: in each half, thread ht owns columns
    //    ht + c * HALF and the tokens t = half, half + 2, ...
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float alpha = g < G ? s_alpha[g] : 0.f;
#pragma unroll
      for (int c2 = 0; c2 < DPT; ++c2) acc[g][c2] *= alpha;
    }
#pragma unroll 4
    for (int t = half; t < n; t += 2) {
      const T* vr = sv + t * LD;
#pragma unroll
      for (int c2 = 0; c2 < DPT; ++c2) {
        const int d = ht + c2 * HALF;
        if (d < D) {
          const float v = to_f32(vr[d]);
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
            if (g < G) acc[g][c2] = fmaf(s_p[g][t], v, acc[g][c2]);
        }
      }
    }
    __syncthreads();   // s_p and this stage are rewritten by later chunks
  }

  // the halves' shares of o meet in shared memory (s_q is free now)
  if (half == 1) {
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = ht + c * HALF;
      if (d < D) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) s_q[g * D + d] = acc[g][c];
      }
    }
  }
  __syncthreads();
  // the split's partial state: part[split, b, h * G + g] = (o[D], m, l)
  const size_t row0 = ((size_t)split * B + b) * H + (size_t)h * G;
  if (half == 0) {
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = ht + c * HALF;
      if (d < D) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G)
            part[(row0 + g) * (D + 2) + d] = acc[g][c] + s_q[g * D + d];
      }
    }
  }
  if (tid < G) {
    part[(row0 + tid) * (D + 2) + D] = s_m[tid];
    part[(row0 + tid) * (D + 2) + D + 1] = s_l[tid];
  }
}

// Combine the n_split partial states of each of the B * H query rows (one
// block each, D threads) into the class's (o, m, l).
__global__ void __launch_bounds__(256)
paged_class_combine_kernel(const float* __restrict__ part,
                           float* __restrict__ o, float* __restrict__ m_out,
                           float* __restrict__ l_out, int BH, int D,
                           int n_split) {
  const int r = blockIdx.x, d = threadIdx.x;
  const size_t stride = (size_t)BH * (D + 2);       // one split
  const float* p = part + (size_t)r * (D + 2);
  float m = NEG_INF;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, p[s * stride + D]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(p[s * stride + D] - m);
    l += p[s * stride + D + 1] * w;
    acc += p[s * stride + d] * w;
  }
  o[(size_t)r * D + d] = acc;
  if (d == 0) {
    m_out[r] = m;
    l_out[r] = l;
  }
}

template <typename T, int D>
int launch_split(const void* q, const void* kp, const void* vp,
                 const int32_t* win_idx, const int8_t* covered,
                 const int32_t* kv_lens, float* part, int B, int H, int KVH,
                 int n_win, int W, float scale, int n_split,
                 cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>();
  // above 48 KB a block's dynamic shared memory must be allowed first
  const cudaError_t e = cudaFuncSetAttribute(
      paged_class_split_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  paged_class_split_kernel<T, D><<<dim3(KVH, B, n_split), NT, smem,
                                   stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, win_idx, covered, kv_lens,
      part, B, H, KVH, H / KVH, n_win, W, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const void* q, const void* kp, const void* vp,
                 const int32_t* win_idx, const int8_t* covered,
                 const int32_t* kv_lens, float* part, float* o, float* m,
                 float* l, int B, int H, int KVH, int D, int n_win, int W,
                 float scale, int n_split, cudaStream_t stream) {
  int rc;
  switch (D) {
#define PA_CASE(DD)                                                        \
  case DD:                                                                 \
    rc = launch_split<T, DD>(q, kp, vp, win_idx, covered, kv_lens, part, B, \
                             H, KVH, n_win, W, scale, n_split, stream);     \
    break;
    PA_CASE(32)
    PA_CASE(64)
    PA_CASE(128)
    PA_CASE(256)
#undef PA_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  paged_class_combine_kernel<<<B * H, D, 0, stream>>>(part, o, m, l, B * H,
                                                      D, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One class pass on `stream`: the split kernel over a (KVH, B, n_split)
// grid into `part` (f32 [n_split, B, H, D + 2] scratch), then the combine
// kernel into o [B, H, D], m and l [B, H] (f32).  dtype 0 = float32, 1 =
// bfloat16 (q and both pools).  Returns cudaGetLastError() after the
// launches (0 on success).  The kernels do not synchronise and allocate
// nothing.
int paged_attention_class_pass(const void* q, const void* k_pool,
                               const void* v_pool, const void* win_idx,
                               const void* covered, const void* kv_lens,
                               void* part, void* o, void* m, void* l, int B,
                               int H, int KVH, int D, int n_win, int W,
                               float scale, int n_split, int dtype,
                               void* stream) {
  const auto wi = (const int32_t*)win_idx;
  const auto cov = (const int8_t*)covered;
  const auto lens = (const int32_t*)kv_lens;
  const auto st = (cudaStream_t)stream;
  if (B < 1 || KVH < 1 || H % KVH != 0 || H / KVH > GMAX || n_win < 0 ||
      W < 1 || n_split < 1 || n_split > 65535 ||
      n_split > (n_win > 1 ? n_win : 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_typed<float>(q, k_pool, v_pool, wi, cov, lens,
                               (float*)part, (float*)o, (float*)m, (float*)l,
                               B, H, KVH, D, n_win, W, scale, n_split, st);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(
        q, k_pool, v_pool, wi, cov, lens, (float*)part, (float*)o, (float*)m,
        (float*)l, B, H, KVH, D, n_win, W, scale, n_split, st);
  return (int)cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
