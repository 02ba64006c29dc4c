// One class-k pass of paged decode attention as a CUDA kernel for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/paged_attention/paged_attention.py::
// _class_kernel of the JAX package (a Pallas kernel over a (B, n_win) grid
// whose BlockSpec index map reads the scalar-prefetched window table and
// loads one contiguous 2^k-page K/V tile per grid step, carrying the
// online-softmax state across the window axis in its revisited outputs).
//
// What it computes: for batch row b and KV head h, walk the class's windows
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
// The state is updated once per chunk of at most 64 tokens, not once per
// window as the Pallas kernel does.  This is the same function: positions
// past kv_lens are the tail of a row, so a chunk that is wholly masked
// either follows live tokens (p = 0, alpha = 1: no change) or belongs to
// a class with no live token at all (each masked token adds p = 1, as in
// the per-window update).
//
// What bounds it: bytes.  Every K and V element of the covered windows is
// read once (2 * W * D elements per window and head), against ~4 flops per
// element (a multiply-add for the score, one for p @ v): at G = 2 query
// rows per head, about one flop per byte in bf16, far below the ~295 the
// card needs before compute is the limit.
//
// What the design does about it: one thread block per (KV head, batch row),
// so the G query rows that share a KV head read each K/V row once.  A
// chunk's K and V rows are first copied into shared memory by the whole
// block with 16-byte asynchronous copies (cp.async), every copy of the
// chunk in flight at once, so a chunk costs about one trip to device
// memory instead of one per token.  A warp then scores one token at a
// time from shared memory: each lane multiplies D/32 elements of the K row
// with the q slice it holds in registers, and a butterfly of shuffles sums
// the G dot products.  One warp per query row reduces the chunk's max and
// sum; then each thread owns D/128 columns of o and accumulates p @ v from
// the staged V rows in f32.  Later versions: overlap the next chunk's
// copies with this chunk's arithmetic (double buffering or TMA), split the
// windows of a row over several blocks (flash-decoding) to fill more than
// B * KVH SMs, and fold all classes and the merge into one launch.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;          // threads per block
constexpr int NWARP = NT / 32;
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

template <typename T, int D>
__global__ void __launch_bounds__(NT)
class_pass_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const int32_t* __restrict__ win_idx,
                  const int8_t* __restrict__ covered,
                  const int32_t* __restrict__ kv_lens, float* __restrict__ o,
                  float* __restrict__ m_out, float* __restrict__ l_out, int H,
                  int KVH, int G, int n_win, int W, float scale) {
  constexpr int EPL = D / 32;               // K-row elements per lane
  constexpr int DPT = (D + NT - 1) / NT;    // o columns per thread
  // tokens per chunk: as many rows as fit the stage, at most CHUNK
  constexpr int CH = STAGE_BYTES / (D * (int)sizeof(T)) < CHUNK
                         ? STAGE_BYTES / (D * (int)sizeof(T)) : CHUNK;
  constexpr int VPR = D * (int)sizeof(T) / 16;   // 16-byte copies per row
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  __shared__ float s_p[GMAX][CHUNK];        // scores, then probabilities
  __shared__ float s_m[GMAX], s_l[GMAX], s_alpha[GMAX];
  __shared__ __align__(16) T s_k[CH * D];   // the chunk's K rows
  __shared__ __align__(16) T s_v[CH * D];   // and V rows

  float qr[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    const T* qrow = q + ((size_t)b * H + (size_t)h * G + g) * D + lane * EPL;
#pragma unroll
    for (int i = 0; i < EPL; ++i) qr[g][i] = g < G ? to_f32(qrow[i]) : 0.f;
  }
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
  const size_t row = (size_t)KVH * D;       // pool elements per token
  for (int j = 0; j < n_win; ++j) {
    if (!covered[(size_t)b * n_win + j]) continue;   // uniform in the block
    const size_t base = (size_t)win_idx[(size_t)b * n_win + j] * W;
    for (int t0 = 0; t0 < W; t0 += CH) {
      const int n = min(CH, W - t0);
      // 0. stage the chunk's K and V rows of head h in shared memory
      for (int i = tid; i < n * VPR; i += NT) {
        const int t = i / VPR, c = i % VPR;
        const size_t src = (base + t0 + t) * row + (size_t)h * D;
        __pipeline_memcpy_async((char*)(s_k + t * D) + 16 * c,
                                (const char*)(kp + src) + 16 * c, 16);
        __pipeline_memcpy_async((char*)(s_v + t * D) + 16 * c,
                                (const char*)(vp + src) + 16 * c, 16);
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      // 1. scores: warp w takes tokens w, w + NWARP, ...
      for (int t = warp; t < n; t += NWARP) {
        const T* kr = s_k + t * D + lane * EPL;
        float kv[EPL];
#pragma unroll
        for (int i = 0; i < EPL; ++i) kv[i] = to_f32(kr[i]);
        const bool live = j * W + t0 + t < len;
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G) {
            float s = 0.f;
#pragma unroll
            for (int i = 0; i < EPL; ++i) s = fmaf(qr[g][i], kv[i], s);
            s = warp_sum(s);
            if (lane == 0) s_p[g][t] = live ? s * scale : NEG_INF;
          }
        }
      }
      __syncthreads();
      // 2. the state update: warp w takes query rows w, w + NWARP, ...
      for (int g = warp; g < G; g += NWARP) {
        float mx = NEG_INF;
        for (int t = lane; t < n; t += 32) mx = fmaxf(mx, s_p[g][t]);
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
      // 3. o = o * alpha + p @ v: thread tid owns columns tid + c * NT
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float alpha = g < G ? s_alpha[g] : 0.f;
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[g][c] *= alpha;
      }
      for (int t = 0; t < n; ++t) {
        const T* vr = s_v + t * D;
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          const int d = tid + c * NT;
          if (d < D) {
            const float v = to_f32(vr[d]);
#pragma unroll
            for (int g = 0; g < GMAX; ++g)
              if (g < G) acc[g][c] = fmaf(s_p[g][t], v, acc[g][c]);
          }
        }
      }
      __syncthreads();   // s_p, s_k, s_v are rewritten by the next chunk
    }
  }

#pragma unroll
  for (int c = 0; c < DPT; ++c) {
    const int d = tid + c * NT;
    if (d < D) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) o[((size_t)b * H + (size_t)h * G + g) * D + d] = acc[g][c];
    }
  }
  if (tid < G) {
    m_out[(size_t)b * H + (size_t)h * G + tid] = s_m[tid];
    l_out[(size_t)b * H + (size_t)h * G + tid] = s_l[tid];
  }
}

template <typename T>
int launch_typed(const void* q, const void* kp, const void* vp,
                 const int32_t* win_idx, const int8_t* covered,
                 const int32_t* kv_lens, float* o, float* m, float* l, int B,
                 int H, int KVH, int D, int n_win, int W, float scale,
                 cudaStream_t stream) {
  const dim3 grid(KVH, B), block(NT);
  const int G = H / KVH;
#define PA_LAUNCH(DD)                                                      \
  class_pass_kernel<T, DD><<<grid, block, 0, stream>>>(                    \
      (const T*)q, (const T*)kp, (const T*)vp, win_idx, covered, kv_lens, \
      o, m, l, H, KVH, G, n_win, W, scale)
  switch (D) {
    case 32: PA_LAUNCH(32); break;
    case 64: PA_LAUNCH(64); break;
    case 128: PA_LAUNCH(128); break;
    case 256: PA_LAUNCH(256); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PA_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One class pass on `stream`; dtype 0 = float32, 1 = bfloat16 (q and both
// pools).  Returns cudaGetLastError() after the launch (0 on success).  The
// kernel does not synchronise and allocates nothing.
int paged_attention_class_pass(const void* q, const void* k_pool,
                               const void* v_pool, const void* win_idx,
                               const void* covered, const void* kv_lens,
                               void* o, void* m, void* l, int B, int H,
                               int KVH, int D, int n_win, int W, float scale,
                               int dtype, void* stream) {
  const auto wi = (const int32_t*)win_idx;
  const auto cov = (const int8_t*)covered;
  const auto lens = (const int32_t*)kv_lens;
  const auto st = (cudaStream_t)stream;
  if (B < 1 || KVH < 1 || H % KVH != 0 || H / KVH > GMAX || n_win < 0 ||
      W < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_typed<float>(q, k_pool, v_pool, wi, cov, lens, (float*)o,
                               (float*)m, (float*)l, B, H, KVH, D, n_win, W,
                               scale, st);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k_pool, v_pool, wi, cov, lens,
                                       (float*)o, (float*)m, (float*)l, B, H,
                                       KVH, D, n_win, W, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
