// Prefill (flash) attention, forward, as CUDA kernels for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py::
// _flash_kernel of the JAX package (a Pallas kernel over a (B*H, q tiles,
// kv tiles) grid that carries the online-softmax state (m, l, acc) in f32
// scratch across the sequential kv axis and writes the normalised tile at
// the last kv step).
//
// What it computes: for batch row b, query head h and every query position
// i < S, attention over the key positions j < S of KV head h / (H / KVH)
// (the order of the JAX op's jnp.repeat, which these kernels never
// materialise), with j <= i under `causal`.  q, k and v are read in their
// own dtype (f32 or bf16); a score is the f32 sum of the exact products
// q_d * k_d, times scale, or exactly NEG_INF = -1e30 where it is masked.
// Per kv tile of 64 keys the state of each query row is updated as the
// Pallas kernel does:
//   m_new = max(m, max s);  alpha = exp(m - m_new);  p = exp(s - m_new)
//   l = l * alpha + sum p;  acc = acc * alpha + p @ v
// from (m, l, acc) = (-1e30, 0, 0), all f32 (p too: it is not rounded once
// to bf16 for the p @ v product), and the row's output is
// acc / max(l, 1e-30) cast to q's dtype.  Rows at or past S are never
// written.  The tiles are these kernels' own (64 or 128 q rows by 64
// keys): a kv tile wholly above the causal diagonal is not visited, which
// leaves every row's state exactly as the masked tile would (its weights
// are exp(-1e30 - m) = 0), so the tile sizes do not change the function,
// only the order of its f32 sums.  Every kernel launches its q tiles from
// the last (the longest causal walk) to the first.
//
// What bounds it: operations.  A causal layer does 4 * D flops per (query,
// key) pair at or below the diagonal, H * S * (S + 1) / 2 pairs, against
// reading q, k, v and writing o once: at InternLM2-1.8B's layer (H = 16,
// KVH = 8, D = 128, bf16) S = 3,072 is 3.9e10 flops for 38 MB (0.039 ms
// at 989 Tflop/s, 0.011 ms at 3.35 TB/s), and S = 32,768 4.4e12 flops for
// 403 MB (4.45 ms vs 0.12 ms).  Only the tensor cores come near that rate;
// the CUDA cores' f32 FMAs peak at ~67 Tflop/s.
//
// The dtype picks the kernel:
//
// * f32 (flash_attention_fwd_kernel): f32 FMAs on the CUDA cores, never
//   TF32, so that f32 serving stays within 1e-3 of the JAX engine after 24
//   layers.  One block of 128 threads per (b * H + h, 64-row q tile)
//   stages its q tile once and each 64-key K and V tile with 16-byte
//   cp.async copies into padded dynamic shared memory (the copy of V
//   overlaps the scores, the copy of the next K the p @ v product).  A
//   thread owns 4 query rows and, for the scores, 8 keys: 32 scores from
//   12 shared reads per 4 head-dim steps; for p @ v the same rows and D / 8
//   output columns, so (m, l, acc) live in registers for the whole walk.
//   Bounded by the FMA rate.
//
// * bf16 (flash_attention_fwd_wg_kernel, D = 32, 64, 128): both products
//   on the tensor cores by wgmma, bf16 operands and f32 accumulators, in
//   blocks of 128 q rows per (b * H + h).  Two consumer warpgroups of 64
//   rows issue S = Q K^T as m64n64k16 and O += P V as m64n{D}k16, A (Q,
//   then P) from registers and B from shared memory through a matrix
//   descriptor; warp w of the consumers owns q rows 16w .. 16w + 15, whose
//   A fragments it loads once with ldmatrix from a padded q tile.  The
//   score accumulators are, with no data movement, the A fragments of P
//   (the accumulator and A layouts coincide per warp and 16 x 16 block);
//   the 4 threads that share a row reduce its max by two shuffles and keep
//   partial row sums, added at the end; the scores are scaled by scale *
//   log2(e), so each weight is one exp2.  p stays f32 as the contract
//   asks: it is split p = p_hi + p_lo, p_hi = bf16(p), p_lo = bf16(p -
//   p_hi), and both halves are multiplied by the same V operand, which
//   keeps p to ~2^-16 relative (a single bf16 rounding, 2^-9, would spend
//   most of the one-bf16-ulp margin the card test holds the output to) at
//   1.5x the product work.  Masks are applied only on tiles that reach
//   past S or across a warp's causal diagonal.
//   A producer warpgroup gives its registers to the consumers (setmaxnreg
//   40 / 232), and one of its threads keeps a ring of 3 K/V stages full
//   with TMA box loads (64 keys x min(D, 64) columns each, the tensor maps
//   built on the host per call), signalled through mbarriers: `full` by
//   the copies' byte count, `empty` by every consumer warp once its
//   products have read the stage.  So the loads run ahead of the products,
//   and the consumers spend no instructions or block barriers on them.
//   TMA writes the swizzle of the tile's rows, which the descriptors name:
//   at D = 64 and 128 the 128-byte swizzle (64-key atoms of 128-byte rows,
//   16-byte chunk c of row r at c ^ (r % 8)), at D = 32 the 64-byte one
//   (64-byte rows, chunk c of row r at c ^ ((r / 2) % 4)); atoms start on
//   1 KB boundaries.  K is read K-major, as it lies in memory; V through
//   wgmma's transpose bit (MN-major), so no transposed copy is made.
//   Next steps (not here): ping-pong scheduling of the two consumer
//   warpgroups, so that one's softmax overlaps the other's products.
#include <cuda.h>
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

// four consecutive elements
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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
        orow[(TX * g + tx) * 4 + e] = acc[i][4 * g + e] / lsum;
  }
}

// ------------------------------------------------- bf16: wgmma (sm_90a)
namespace wg {

using bf16 = __nv_bfloat16;
constexpr int BK = 64;             // keys per kv tile
constexpr int NN = BK / 8;         // 8-key n-tiles of a score tile
constexpr int KK = BK / 16;        // 16-key k-steps of p @ v

template <int D>
__host__ __device__ constexpr int q_ld() {
  return D + 8;
}
// head-dim columns of one swizzle atom: a row of 128 bytes (D >= 64, the
// 128-byte swizzle) or, at D = 32, of 64 bytes (the 64-byte swizzle)
template <int D>
__host__ __device__ constexpr int cols() {
  return D < 64 ? D : 64;
}
// one atom of a K or V tile: 64 rows of cols<D>() columns
template <int D>
__host__ __device__ constexpr int atom_bytes() {
  return BK * cols<D>() * 2;
}
// K or V tile: D / cols<D>() atoms
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return BK * D * 2;
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the 64-bit wgmma matrix descriptor of an operand in the swizzle of
// cols<D>() * 2-byte rows (layout type 1: 128 bytes, 2: 64 bytes)
template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  constexpr uint64_t layout = cols<D>() == 64 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// four 8 x 8 b16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, register i receives it (thread l: row l / 4, elements
// 2 (l % 4), 2 (l % 4) + 1)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) as p_hi = bf16 pairs and p_lo = bf16 of what p_hi leaves out
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - __low2float(h),
                                    y - __high2float(h)));
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving uses of an accumulator across a wait
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 f32, this thread's 32) += a (64 x 16 bf16, registers) *
// b (16 x 64 bf16, shared memory at `desc`); TB = 1 reads b MN-major
template <int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
        "n"(TB));
}

// d (64 x 128 f32, this thread's 64) += a (64 x 16 bf16, registers) *
// b (16 x 128 bf16, shared memory at `desc`); TB = 1 reads b MN-major
template <int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
        "n"(TB));
}

// d (64 x 32 f32, this thread's 16) += a (64 x 16 bf16, registers) *
// b (16 x 32 bf16, shared memory at `desc`); TB = 1 reads b MN-major
template <int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
        "n"(TB));
}

template <int D>
__device__ __forceinline__ void pv(float (&acc)[D / 2],
                                   const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (D == 128)
    wgmma_n128<1>(acc, a, desc, 1);
  else if constexpr (D == 64)
    wgmma_n64<1>(acc, a, desc, 1);
  else
    wgmma_n32<1>(acc, a, desc, 1);
}

// One block: NWG consumer warpgroups of 64 q rows and a producer warpgroup
// (one thread of it issues TMA), sharing a ring of STAGES K/V tiles.
constexpr int NWG = 2;             // consumer warpgroups
constexpr int NC = 128 * NWG;      // consumer threads
constexpr int NT = NC + 128;       // and a producer warpgroup
constexpr int BQ = 64 * NWG;
constexpr int STAGES = 3;          // K/V tiles in the ring

// 1 KB of alignment slack, STAGES stages of K and of V, the padded q tile,
// 2 STAGES mbarriers
template <int D>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)2 * STAGES * tile_bytes<D>() +
         (size_t)BQ * q_ld<D>() * 2 + 2 * STAGES * 8;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// one box of 64 columns x 64 rows of a [B, S, KVH, D] tensor into shared
// memory at `dst`, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const void* tmap,
                                         uint32_t bar, int d0, int s0,
                                         int head, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(tmap), "r"(d0), "r"(s0), "r"(head), "r"(b), "r"(bar)
      : "memory");
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_attention_fwd_wg_kernel(const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const bf16* __restrict__ q,
                              bf16* __restrict__ o, int S, int H, int G,
                              int64_t q_sb, int64_t q_ss, int64_t q_sh,
                              float scale, int causal) {
  constexpr int KS = D / 16;       // 16-wide k-steps of q . k
  constexpr int NA = D / 2;        // accumulator floats of o per thread
  constexpr int TB = tile_bytes<D>();
  constexpr int ATOM = atom_bytes<D>();
  constexpr int ROW = cols<D>() * 2;   // bytes of an atom's row
  constexpr int KPA = cols<D>() / 16;  // k-steps of q . k per atom
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle works on address bits 4-9: atoms start on 1 KB boundaries
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* s_k = smem;                    // stages 0 .. STAGES - 1
  unsigned char* s_v = smem + STAGES * TB;
  bf16* s_q = reinterpret_cast<bf16*>(smem + 2 * STAGES * TB);
  // mbarriers: full[i] (K and V of stage i landed) at bars + 8 i, empty[i]
  // (every consumer warp done with stage i) at bars + 8 (STAGES + i)
  const uint32_t bars =
      smem_addr(smem + 2 * STAGES * TB + BQ * q_ld<D>() * 2);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int n_kt = (k_end + BK - 1) / BK;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(bars + 8 * i, 1);                  // the producer's arrive
      mbar_init(bars + 8 * (STAGES + i), NC / 32);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NC / 32) {
    // the producer warpgroup gives its registers up; one thread loads the
    // K and V tiles into the ring, each stage once every consumer warp has
    // released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == NC / 32 && lane == 0) {
      for (int t = 0; t < n_kt; ++t) {
        const int st = t % STAGES, round = t / STAGES;
        mbar_wait(bars + 8 * (STAGES + st), (round & 1) ^ 1);
        const uint32_t full = bars + 8 * st;
        mbar_expect_tx(full, 2 * TB);
#pragma unroll
        for (int a = 0; a < D / cols<D>(); ++a) {
          tma_load(smem_addr(s_k + st * TB + a * ATOM), &tm_k, full,
                   cols<D>() * a, t * BK, h / G, b);
          tma_load(smem_addr(s_v + st * TB + a * ATOM), &tm_v, full,
                   cols<D>() * a, t * BK, h / G, b);
        }
      }
    }
  } else {
    // the consumers, two warpgroups of 64 q rows, take the registers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int gr = lane >> 2, tq = lane & 3;
    const int r0 = q0 + 16 * warp;
    const bf16* qb = q + b * q_sb + h * q_sh;
    const float scale2 = scale * 1.4426950408889634f;
    {  // the q tile, padded rows, by the consumers alone (barrier 1)
      constexpr int VPR = D / 8;
      for (int i = tid; i < BQ * VPR; i += NC) {
        const int r = i / VPR, c = i % VPR;
        bf16* d = s_q + r * q_ld<D>() + 8 * c;
        if (q0 + r < S)
          __pipeline_memcpy_async(d, qb + (int64_t)(q0 + r) * q_ss + 8 * c,
                                  16);
        else
          *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
    }
    uint32_t qf[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldsm4(qf[ks],
                smem_addr(s_q + (16 * warp + (lane & 15)) * q_ld<D>() +
                              16 * ks + 8 * (lane >> 4)));
    float acc[NA];
    float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.f;

    for (int t = 0; t < n_kt; ++t) {
      const int k0 = t * BK, st = t % STAGES;
      mbar_wait(bars + 8 * st, (t / STAGES) & 1);   // K and V landed
      const uint32_t kt = smem_addr(s_k + st * TB);
      const uint32_t vt = smem_addr(s_v + st * TB);
      // 1. s = q . k (m64n64k16; n-tile n of the warp's 16 rows in
      //    s[4n .. 4n + 3]); K-major: a k-step is the next 32 bytes of an
      //    atom's row (the swizzle is applied to the address), cols<D>()
      //    columns an atom, the next 8 keys one row group on (SBO)
      float s[NN * 4];
      fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_n64<0>(
            s, qf[ks],
            make_desc<D>(kt + (ks / KPA) * ATOM + 32 * (ks % KPA), 16,
                         8 * ROW),
            ks > 0);
      commit();
      wait_all();
      pin(s);

      // 2. scale (log2 units) and mask where the tile reaches past S or
      //    across the warp's diagonal; online-softmax update
      const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > r0);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * n + e] * scale2;
          if (masked) {
            const int kp = k0 + 8 * n + 2 * tq + (e & 1);
            const int qp = r0 + gr + 8 * (e >> 1);
            if (kp >= S || (causal && kp > qp)) x = NEG_INF;
          }
          s[4 * n + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_i[i], mx[i]);
        alpha[i] = exp2f(m_i[i] - m_new);
        m_i[i] = m_new;
        l_i[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[4 * n + e] - m_i[e >> 1]);
          s[4 * n + e] = p;
          l_i[e >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < NA / 4; ++n) {
        acc[4 * n] *= alpha[0];
        acc[4 * n + 1] *= alpha[0];
        acc[4 * n + 2] *= alpha[1];
        acc[4 * n + 3] *= alpha[1];
      }
      // 3. acc += p_hi @ v + p_lo @ v: the score n-tiles 2kk, 2kk + 1 are
      //    the A fragment of keys 16kk .. 16kk + 15; V MN-major through the
      //    transpose bit: the next cols<D>() columns one atom on (LBO), the
      //    next 8 keys one row group on (SBO)
      uint32_t ph[KK][4], pl[KK][4];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        split2(s[8 * kk], s[8 * kk + 1], ph[kk][0], pl[kk][0]);
        split2(s[8 * kk + 2], s[8 * kk + 3], ph[kk][1], pl[kk][1]);
        split2(s[8 * kk + 4], s[8 * kk + 5], ph[kk][2], pl[kk][2]);
        split2(s[8 * kk + 6], s[8 * kk + 7], ph[kk][3], pl[kk][3]);
      }
      pin(acc);
      fence();
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const uint64_t dv = make_desc<D>(vt + kk * 16 * ROW, ATOM, 8 * ROW);
        pv<D>(acc, ph[kk], dv);
        pv<D>(acc, pl[kk], dv);
      }
      commit();
      wait_all();
      pin(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (STAGES + st));  // stage free
    }

    // 4. normalise and write the rows that exist ([B, S, H, D] contiguous)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_i[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float lsum = fmaxf(l, 1e-30f);
      const int qp = r0 + gr + 8 * i;
      if (qp >= S) continue;
      bf16* orow = o + (((int64_t)b * S + qp) * H + h) * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < NA / 4; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2 * i] / lsum,
                                  acc[4 * n + 2 * i + 1] / lsum);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the map of a [B, S, KVH, D] bf16 tensor (element strides sb, ss, sh) in
// boxes of one atom, 64 rows of min(D, 64) columns, written with the
// swizzle of their row bytes (128, or 64 at D = 32)
int encode_map(CUtensorMap* tm, const void* base, int B, int S, int KVH,
               int D, int64_t sb, int64_t ss, int64_t sh) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult qres;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", (void**)&encode, cudaEnableDefault, &qres);
    if (e != cudaSuccess || qres != cudaDriverEntryPointSuccess ||
        encode == nullptr) {
      encode = nullptr;
      return (int)cudaErrorNotSupported;
    }
  }
  // a dimension of extent 1 is never stepped: give it a legal stride
  const int64_t row = (int64_t)D * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)KVH,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {
      (cuuint64_t)(S > 1 ? ss * 2 : row), (cuuint64_t)(KVH > 1 ? sh * 2 : row),
      (cuuint64_t)(B > 1 ? sb * 2 : row)};
  const int c = D < 64 ? D : 64;
  const cuuint32_t box[4] = {(cuuint32_t)c, (cuuint32_t)BK, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      c == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KVH, const int64_t* st, float scale, int causal,
           cudaStream_t stream) {
  CUtensorMap tm_k, tm_v;
  int rc = encode_map(&tm_k, k, B, S, KVH, D, st[3], st[4], st[5]);
  if (rc == 0) rc = encode_map(&tm_v, v, B, S, KVH, D, st[6], st[7], st[8]);
  if (rc != 0) return rc;
  const size_t smem = smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_fwd_wg_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_attention_fwd_wg_kernel<D><<<grid, NT, smem, stream>>>(
      tm_k, tm_v, (const bf16*)q, (bf16*)o, S, H, H / KVH, st[0], st[1],
      st[2], scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace wg


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

int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int KVH, int D, const int64_t* st, float scale,
              int causal, cudaStream_t stream) {
  switch (D) {
    case 32:
      return wg::launch<32>(q, k, v, o, B, S, H, KVH, st, scale, causal,
                            stream);
    case 64:
      return wg::launch<64>(q, k, v, o, B, S, H, KVH, st, scale, causal,
                            stream);
    case 128:
      return wg::launch<128>(q, k, v, o, B, S, H, KVH, st, scale, causal,
                             stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
// a contiguous [B, S, H, D] of q's dtype.  dtype 0 = float32 (the FMA
// kernel), 1 = bfloat16 (the tensor-core kernel).  Returns
// cudaGetLastError() after the launch (0 on success).  The kernel does not
// synchronise and allocates nothing.
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
    return launch_tc(q, k, v, o, B, S, H, KVH, D, strides, scale, causal,
                     st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
