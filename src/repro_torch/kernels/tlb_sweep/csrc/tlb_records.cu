// The fill and cluster records of a packed sweep batch, built on the card
// from its map records.
//
// Replaces no TPU kernel: the JAX package builds these records on the host
// in numpy (src/repro/core/lane_program.py: _fill_profile, and
// page_table.cluster_bitmap), as the port's CPU path still does.  On the
// card path the host sends a record plan instead
// (lane_program.RecordPlan: per record its map record, its source's
// n_pages, its profile code and K classes) and this kernel writes the
// fills [n_fill, P, FILL_W] and clus [n_clus, Pc] stacks that
// tlb_sweep_kernel reads, bit-equal to the host's (tlb_records.cuh has the
// arithmetic, tests hold it to the host packing).  It exists because the
// host took ~3 s a Table 4 call to build ~790 MB of records that are a
// pure function of the ~64 MiB of map records it uploads anyway.
//
// What bounds it: bytes.  At Table 4's shapes it writes 36 fill records of
// 2^20 rows (755 MB) and 8 cluster records (32 MiB) and reads the four map
// records (64 MiB): ~0.26 ms at 3.35 TB/s.  Each row needs a few dozen
// integer operations, a small share of that time at the card's rate.
//
// What the design does about it:
//  * a block takes a tile of REC_THREADS consecutive vpns of one record, one
//    vpn a thread, grid-strided over every tile of the batch in one launch
//    (fill tiles, then cluster tiles); no state is shared between tiles;
//  * tiles run vpn-major, every record of the batch at one vpn range
//    before the next range, so the (up to nine) records a map record feeds
//    read its rows while they sit in L2, and the map records come from
//    memory about once;
//  * a fill row is 20 bytes, so each thread stages its row in shared
//    memory and the block stores the tile's 5 KB as 16-byte stores;
//  * the map rows a profile reads besides its own (the aligned base of
//    each class, the 2MB base, the COLT tag, the subregion and cluster
//    windows) are the tile's neighbours, loaded as 16-byte read-only
//    loads that hit L1.
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

#include "tlb_records.cuh"

#define REC_THREADS 256  // vpns a tile, one a thread

static_assert(MAP_W == 4, "map_row loads a map row as one int4");
static_assert((REC_THREADS * FILL_W) % 4 == 0,
              "a fill tile is a whole number of int4");

// Tiles of REC_THREADS vpns in a record of n vpns.
__host__ __device__ inline unsigned tiles_of(int n) {
  return (unsigned)(n / REC_THREADS + (n % REC_THREADS != 0));
}

struct RecordArgs {
  const int* plan;
  const int* maps;
  int* fills;
  int* clus;
  int n_fill, n_clus, plan_w, P, Pc;
};

__global__ void __launch_bounds__(REC_THREADS)
    tlb_records_kernel(RecordArgs a) {
  __shared__ __align__(16) int stage[REC_THREADS * FILL_W];
  // 32-bit tile arithmetic (the launcher refuses more than INT_MAX
  // tiles): a 64-bit division is a called routine with a stack frame
  const int tid = threadIdx.x;
  const unsigned n_fill = a.n_fill, n_clus = a.n_clus;
  const unsigned fill_tiles = tiles_of(a.P) * n_fill;
  const unsigned tiles = fill_tiles + tiles_of(a.Pc) * n_clus;
  for (unsigned t = blockIdx.x; t < tiles; t += gridDim.x) {
    if (t < fill_tiles) {
      const int r = (int)(t % n_fill);
      const int v0 = (int)(t / n_fill) * REC_THREADS;
      const int* row = a.plan + (size_t)r * a.plan_w;
      const int* map = a.maps + (size_t)__ldg(row + PLAN_MAP) * a.P * MAP_W;
      const int items = min(REC_THREADS, a.P - v0);
      if (tid < items) {
        int out[FILL_W];
        fill_word_row(map, __ldg(row + PLAN_PAGES), __ldg(row + PLAN_CODE),
                      row + PLAN_K, a.plan_w - PLAN_K, v0 + tid, out);
#pragma unroll
        for (int f = 0; f < FILL_W; ++f) stage[tid * FILL_W + f] = out[f];
      }
      __syncthreads();
      const size_t w0 = ((size_t)r * a.P + v0) * FILL_W;
      const int words = items * FILL_W;
      int* dst = a.fills + w0;
      int vec = 0;
      if ((w0 & 3) == 0) {  // 16-byte aligned: whole int4s, then the tail
        vec = words / 4;
        const int4* src4 = reinterpret_cast<const int4*>(stage);
        int4* dst4 = reinterpret_cast<int4*>(dst);
        for (int q = tid; q < vec; q += REC_THREADS) dst4[q] = src4[q];
        vec *= 4;
      }
      for (int q = vec + tid; q < words; q += REC_THREADS) dst[q] = stage[q];
      __syncthreads();
    } else {
      const unsigned tc = t - fill_tiles;
      const int r = (int)(tc % n_clus);
      const int v = (int)(tc / n_clus) * REC_THREADS + tid;
      if (v < a.Pc) {
        const int* row = a.plan + (size_t)(a.n_fill + r) * a.plan_w;
        const int* map = a.maps + (size_t)__ldg(row + PLAN_MAP) * a.P * MAP_W;
        a.clus[(size_t)r * a.Pc + v] = cluster_word(
            map, __ldg(row + PLAN_PAGES), __ldg(row + PLAN_CODE), v);
      }
    }
  }
}

extern "C" {

// One launch on `stream` over every record of the plan (`n_fill` fill
// rows, then `n_clus` cluster rows, `plan_w` ints each); returns
// cudaGetLastError() (0 on success).  Does not synchronise and allocates
// nothing.
int tlb_records_launch(const int* plan, int n_fill, int n_clus, int plan_w,
                       const int* maps, int P, int Pc, int* fills, int* clus,
                       void* stream) {
  RecordArgs a{plan, maps, fills, clus, n_fill, n_clus, plan_w, P, Pc};
  const long long tiles =
      (long long)n_fill * tiles_of(P) + (long long)n_clus * tiles_of(Pc);
  if (tiles == 0) return 0;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // eight resident blocks an SM (256 threads, 5 KB of shared memory each)
  const long long grid = tiles < 8LL * sms ? tiles : 8LL * sms;
  tlb_records_kernel<<<(unsigned)grid, REC_THREADS, 0,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
