// Prefill (flash) attention, forward, as a CUDA kernel for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py::
// _flash_kernel of the JAX package (a Pallas kernel over a (B*H, q tiles,
// kv tiles) grid that carries the online-softmax state (m, l, acc) in f32
// scratch across the sequential kv axis and writes the normalised tile at
// the last kv step).
//
// What it computes: for batch row b, query head h and every query position
// i < S, attention over the key positions j < S of KV head h / (H / KVH)
// (the order of the JAX op's jnp.repeat, which this kernel never
// materialises), with j <= i under `causal`.  q, k and v are read in their
// own dtype (f32 or bf16) and multiplied in f32; a score is
// (q . k) * scale, or exactly NEG_INF = -1e30 where it is masked.  Per
// kv tile of BK keys the state of each query row is updated as the Pallas
// kernel does:
//   m_new = max(m, max s);  alpha = exp(m - m_new);  p = exp(s - m_new)
//   l = l * alpha + sum p;  acc = acc * alpha + p @ v
// from (m, l, acc) = (-1e30, 0, 0), all f32 (p too: it is not rounded to
// bf16 for the p @ v product), and the row's output is acc / max(l, 1e-30)
// cast to q's dtype.  Rows at or past S are never written.  The tiles are
// this kernel's own (64 x 64): a kv tile wholly above the causal diagonal
// is not visited, which leaves every row's state exactly as the masked
// tile would (its weights are exp(-1e30 - m) = 0), so the tile sizes do
// not change the function, only the order of its f32 sums.
//
// What bounds it: operations.  A causal layer does 4 * D flops per (query,
// key) pair at or below the diagonal, H * S * (S + 1) / 2 pairs, against
// reading q, k, v and writing o once: at InternLM2-1.8B's layer (H = 16,
// KVH = 8, D = 128, bf16) S = 3,072 is 3.9e10 flops for 38 MB (0.039 ms
// at 989 Tflop/s, 0.011 ms at 3.35 TB/s), and S = 32,768 4.4e12 flops for
// 403 MB (4.45 ms vs 0.12 ms).
//
// What the design does about it: the products are f32 FMAs on the CUDA
// cores (f32 stays full f32, no TF32; bf16 is widened to f32 as it is read
// from shared memory), so this first version is bounded by the card's f32
// FMA rate (~67 Tflop/s), not its bf16 tensor rate; a later version moves
// the bf16 products to the tensor cores (mma.sync or wgmma).  Within that,
// each operand read from shared memory feeds many FMAs: one block of 128
// threads per (b * H + h, 64-row q tile); the block stages its q tile once
// and each 64-key K and V tile with 16-byte cp.async copies into dynamic
// shared memory (rows padded by 16 bytes so that the reads below do not
// collide in a bank), and the copy of V overlaps the scores, the copy of
// the next K the p @ v product.  A thread owns 4 query rows (ty + 16 i)
// and, for the scores, 8 keys (tx + 8 j): 32 scores from 12 shared reads
// per 4 head-dim steps; for p @ v the same rows and D / 8 columns of the
// output, so (m, l, acc) live in registers for the whole walk.  The 8
// threads of a row reduce its max and sum by shuffles.  q tiles are
// launched from the last (the longest causal walk) to the first.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per kv tile
constexpr int NT = 128;           // threads per block
constexpr int TX = 8;             // threads that share a query row
constexpr int TY = NT / TX;       // row groups
constexpr int RPT = BQ / TY;      // query rows per thread
constexpr int KPT = BK / TX;      // keys per thread (scores)
constexpr int PLD = BK + 4;       // row stride of the probabilities
constexpr float NEG_INF = -1e30f;

static_assert(BQ == BK, "one tile size stages q, k and v");

// row stride of a staged tile: D elements plus 16 bytes of padding
template <typename T, int D>
__host__ __device__ constexpr int tile_ld() {
  return D + 16 / (int)sizeof(T);
}

template <typename T, int D>
constexpr size_t smem_bytes() {
  return (size_t)3 * BK * tile_ld<T, D>() * sizeof(T) +
         (size_t)BQ * PLD * sizeof(float);
}

// four consecutive elements as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);          // round to nearest even, as astype
}

// the 8 lanes of a row group are consecutive: xor 1, 2, 4 stays inside it,
// and every lane gets the same bits
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < TX; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < TX; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy rows row0 .. row0 + BK - 1 of one head (row r at src + r * stride,
// D contiguous elements) into a padded shared tile, 16 bytes per cp.async;
// rows at or past `n_rows` are zero-filled (0 * v, never 0 * stale NaN).
template <typename T, int D>
__device__ __forceinline__ void stage(T* dst, const T* src, int64_t stride,
                                      int row0, int n_rows, int tid) {
  constexpr int LD = tile_ld<T, D>();
  constexpr int VPR = D * (int)sizeof(T) / 16;   // 16-byte pieces per row
  for (int i = tid; i < BK * VPR; i += NT) {
    const int r = i / VPR, c = i % VPR;
    char* d = reinterpret_cast<char*>(dst + r * LD) + 16 * c;
    if (row0 + r < n_rows)
      __pipeline_memcpy_async(
          d, reinterpret_cast<const char*>(src + (row0 + r) * stride) + 16 * c,
          16);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int S,
                           int H, int G, int64_t q_sb, int64_t q_ss,
                           int64_t q_sh, int64_t k_sb, int64_t k_ss,
                           int64_t k_sh, int64_t v_sb, int64_t v_ss,
                           int64_t v_sh, float scale, int causal) {
  constexpr int LD = tile_ld<T, D>();
  constexpr int CPT = D / TX;       // output columns per thread
  constexpr int NV = CPT / 4;       // ... in groups of four
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_q = reinterpret_cast<T*>(smem);
  T* s_k = s_q + BQ * LD;
  T* s_v = s_k + BK * LD;
  float* s_p = reinterpret_cast<float*>(s_v + BK * LD);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + (h / G) * k_sh;
  const T* vb = v + b * v_sb + (h / G) * v_sh;
  // the kv tiles this q tile reads: up to its last row's diagonal
  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int n_kt = (k_end + BK - 1) / BK;

  stage<T, D>(s_q, qb + (int64_t)q0 * q_ss, q_ss, 0, S - q0, tid);
  stage<T, D>(s_k, kb, k_ss, 0, S, tid);
  __pipeline_commit();

  float m_i[RPT], l_i[RPT], acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * BK;
    stage<T, D>(s_v, vb + (int64_t)k0 * v_ss, v_ss, 0, S - k0, tid);
    __pipeline_commit();
    __pipeline_wait_prior(1);        // q and this K tile have landed
    __syncthreads();

    // 1. scores of rows ty + TY*i against keys tx + TX*j
    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = load4(s_q + (ty + TY * i) * LD + d);
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kv[j] = load4(s_k + (tx + TX * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // 2. mask, online-softmax update, probabilities to shared memory
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = ty + TY * i, qp = q0 + row;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kp = k0 + tx + TX * j;
        const bool live = kp < S && qp < S && (!causal || qp >= kp);
        s[i][j] = live ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max(mx));
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        s_p[row * PLD + tx + TX * j] = p;
        sum += p;
      }
      l_i[i] = l_i[i] * alpha + row_sum(sum);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __pipeline_wait_prior(0);        // this V tile has landed
    __syncthreads();                 // p visible; every thread is done with K
    if (t + 1 < n_kt) {
      stage<T, D>(s_k, kb + (int64_t)(k0 + BK) * k_ss, k_ss, 0, S - k0 - BK,
                  tid);
      __pipeline_commit();
    }

    // 3. acc += p @ v: rows ty + TY*i, columns (TX*g + tx)*4 + e
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) p[i] = s_p[(ty + TY * i) * PLD + c];
#pragma unroll
      for (int g = 0; g < NV; ++g) {
        const float4 vv = load4(s_v + c * LD + (TX * g + tx) * 4);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc[i][4 * g + 0] = fmaf(p[i], vv.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(p[i], vv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p[i], vv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p[i], vv.w, acc[i][4 * g + 3]);
        }
      }
    }
    __syncthreads();                 // V and p are rewritten next tile
  }

  // 4. normalise and write the rows that exist ([B, S, H, D] contiguous)
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q0 + ty + TY * i;
    if (qp >= S) continue;
    const float lsum = fmaxf(l_i[i], 1e-30f);
    T* orow = o + (((int64_t)b * S + qp) * H + h) * D;
#pragma unroll
    for (int g = 0; g < NV; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(orow + (TX * g + tx) * 4 + e, acc[i][4 * g + e] / lsum);
  }
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int H, int KVH, const int64_t* st, float scale,
                 int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>();
  // above 48 KB a block's dynamic shared memory must be allowed first
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_attention_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, H / KVH, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int KVH, int D, const int64_t* st, float scale,
               int causal, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_typed<T, 32>(q, k, v, o, B, S, H, KVH, st, scale, causal,
                                 stream);
    case 64:
      return launch_typed<T, 64>(q, k, v, o, B, S, H, KVH, st, scale, causal,
                                 stream);
    case 128:
      return launch_typed<T, 128>(q, k, v, o, B, S, H, KVH, st, scale,
                                  causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Forward attention on `stream`.  q [B, S, H, D], k and v [B, S, KVH, D]
// with element strides (batch, sequence, head) in `strides` = {q_sb, q_ss,
// q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh}, the head dim contiguous; o is
// a contiguous [B, S, H, D] of q's dtype.  dtype 0 = float32, 1 =
// bfloat16.  Returns cudaGetLastError() after the launch (0 on success).
// The kernel does not synchronise and allocates nothing.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KVH, int D,
                        const int64_t* strides, float scale, int causal,
                        int dtype, void* stream) {
  const auto st = (cudaStream_t)stream;
  if (B < 1 || S < 1 || KVH < 1 || H % KVH != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_dim<float>(q, k, v, o, B, S, H, KVH, D, strides, scale,
                             causal, st);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(q, k, v, o, B, S, H, KVH, D, strides,
                                     scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
