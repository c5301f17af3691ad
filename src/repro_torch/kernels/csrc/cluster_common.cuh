// Thread-block cluster pieces of the column-sliced stream engines
// (gcrn_engine.cu, evolve_engine.cu): the cluster's shape and ranks, the
// cluster barrier, stores into a peer CTA's shared memory (DSMEM), the
// all-gather of a k-major node tile, the ELL tile with each row's live
// lanes packed, the batched ELL gathers, the step's live-tile bitmask, L2
// prefetch of the next step, the TMA ring that pages a CTA's own columns,
// and the cluster launch.
//
// One cluster runs one stream: CTA r of the cluster owns the columns
// [r * W / kCluster, (r + 1) * W / kCluster) of a W-wide state (GCRN's
// hidden units, EvolveGCN's columns of W_l). The ELL aggregate is
// separable by column, so a CTA aggregates only its own columns; the
// cluster all-gathers the 32-row aggregate tile through DSMEM, and each CTA
// runs its slice of the product on the whole tile.
//
// Every skip decision taken between two cluster barriers (a dead tile, a
// dead step) is read from data all CTAs of the cluster see alike (the
// mask, the live flags), so the CTAs agree and every barrier is reached by
// all of them.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "engine_common.cuh"
#include "hopper_common.cuh"

namespace cluster {

using engine::kTileRows;
using engine::kTileStride;

// CTAs a cluster (one stream; 8, the portable size), threads a CTA (the
// resident EvolveGCN CTA adds its GRU threads), node rows a thread owns in
// a product (one float4 of a k-major tile column)
constexpr int kCluster = 8;
constexpr int kThreads = 256;
constexpr int kRows = 4;
constexpr int kRowGroups = kTileRows / kRows;
// a paged window: a TMA box of at most this many rows (the box limit)
constexpr int kBoxRows = 256;
// bytes of slack in front of the dynamic shared memory, to align it to 128;
// a CTA's shared memory on Hopper (227 KB)
constexpr int kAlignSlack = 128;
constexpr size_t kSmemLimit = 232448;

static_assert(kCluster >= 1 && kCluster <= 8, "a portable cluster");

// Column slice [lo, hi) of a `width`-wide state owned by CTA `rank`.
__host__ __device__ __forceinline__ int slice_lo(int width, int rank) {
  return rank * width / kCluster;
}
// Widest slice of a `width`-wide state.
__host__ __device__ __forceinline__ int slice_max(int width) {
  return (width + kCluster - 1) / kCluster;
}
__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ unsigned ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// All threads of all CTAs of the cluster: stores (DSMEM ones included)
// before the barrier are visible to every thread of the cluster after it.
// Block-uniform.
__device__ __forceinline__ void sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// sync() in two halves, for warps that work between arriving at a
// barrier phase and waiting for it to complete (warp-uniform; a thread
// waits for a phase before it arrives at the next).
__device__ __forceinline__ void arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The generic address of `p` (this CTA's shared memory) in CTA `rank`'s
// shared memory.
template <class T>
__device__ __forceinline__ T* peer(T* p, unsigned rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(out)
               : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<T*>(out);
}

// Copy columns [c0, c0 + cols) of this CTA's k-major tile (kTileRows rows)
// into the same columns of every other CTA's tile, float4 by float4, by
// threads t of nt.
__device__ __forceinline__ void broadcast_cols(float* tile, int c0, int cols,
                                               unsigned rank, int t, int nt) {
  constexpr int kQuads = kTileRows / 4;
  const int per_peer = cols * kQuads;
  for (int p = t; p < per_peer * (kCluster - 1); p += nt) {
    const int q = p / per_peer, rem = p - q * per_peer;
    const int c = rem / kQuads, g = rem - c * kQuads;
    const unsigned dst_rank = (rank + 1 + q) % kCluster;
    float* src = tile + (size_t)(c0 + c) * kTileStride + g * 4;
    *reinterpret_cast<float4*>(peer(src, dst_rank)) =
        *reinterpret_cast<const float4*>(src);
  }
}

// ELL tile of the node rows [r0, r0 + kTileRows) into shared memory, with
// the rows' mask (and, where rowg is given, global row ids), by threads t
// of nt (whole warps): each row's live lanes (coef != 0; the ELL padding
// and edge-free lanes add exact zeros) are packed to its front in lane
// order, their count in s_cnt, so a row's sums skip no lane of its own and
// keep their order. Rows past n have no lanes, mask 0 and row -1.
__device__ __forceinline__ void load_ell_tile(const int* idx,
                                              const float* coef,
                                              const int* eidx,
                                              const float* mask,
                                              const int* rowg, int r0, int n,
                                              int k, int* s_idx,
                                              float* s_coef, int* s_eidx,
                                              float* s_mask, int* s_rowg,
                                              int* s_cnt, int t, int nt) {
  constexpr int kRowsAtOnce = 4;  // rows a warp loads before it packs
  const int warp = t >> 5, nwarps = nt >> 5, lane = t & 31;
  for (int rb = warp; rb < kTileRows; rb += kRowsAtOnce * nwarps) {
    int cnt[kRowsAtOnce] = {0, 0, 0, 0};
    for (int s0 = 0; s0 < k; s0 += 32) {
      float cv[kRowsAtOnce];
      int iv[kRowsAtOnce], ev[kRowsAtOnce];
#pragma unroll
      for (int q = 0; q < kRowsAtOnce; ++q) {
        const int r = rb + q * nwarps, v = r0 + r, s = s0 + lane;
        const bool ok = r < kTileRows && v < n && s < k;
        const size_t at = (size_t)v * k + s;
        cv[q] = ok ? coef[at] : 0.0f;
        iv[q] = ok ? idx[at] : 0;
        ev[q] = ok && eidx != nullptr ? eidx[at] : 0;
      }
#pragma unroll
      for (int q = 0; q < kRowsAtOnce; ++q) {
        const int r = rb + q * nwarps;
        const unsigned live = __ballot_sync(0xffffffffu, cv[q] != 0.0f);
        if (cv[q] != 0.0f) {
          const int at = r * k + cnt[q] + __popc(live & ((1u << lane) - 1u));
          s_idx[at] = iv[q];
          s_coef[at] = cv[q];
          if (s_eidx != nullptr) s_eidx[at] = ev[q];
        }
        cnt[q] += __popc(live);
      }
    }
#pragma unroll
    for (int q = 0; q < kRowsAtOnce; ++q) {
      const int r = rb + q * nwarps;
      if (lane == 0 && r < kTileRows) s_cnt[r] = cnt[q];
    }
  }
  if (t < kTileRows) {
    const int v = r0 + t;
    s_mask[t] = v < n ? mask[v] : 0.0f;
    if (rowg != nullptr) s_rowg[t] = v < n ? rowg[v] : -1;
  }
}

// ELL sum of one row and column c, as engine::ell_sum (the same chain:
// coef-0 lanes skipped, the others' src (+ emsg) values added in lane
// order), with the gathers of kBatch lanes issued before their sums (8
// covers most rows' live lanes, packed by load_ell_tile, in one round trip
// to global memory).
template <int kBatch = 8>
__device__ __forceinline__ float ell_sum(const float* src, int src_stride,
                                         const float* emsg, int emsg_stride,
                                         const int* li, const float* lc,
                                         const int* le, int k, int c) {
  float acc = 0.0f;
  for (int s0 = 0; s0 < k; s0 += kBatch) {
    float v[kBatch], w[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int s = s0 + j;
      w[j] = s < k ? lc[s] : 0.0f;
      v[j] = 0.0f;
      if (w[j] != 0.0f) {
        v[j] = src[(size_t)li[s] * src_stride + c];
        if (emsg != nullptr)
          v[j] = __fadd_rn(v[j], emsg[(size_t)le[s] * emsg_stride + c]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (w[j] != 0.0f) acc = __fmaf_rn(w[j], v[j], acc);
  }
  return acc;
}

// Two ELL sums at once (rows li0 / li1 of k0 / k1 lanes, columns c0 / c1),
// each ell_sum's chain, their gathers interleaved so twice the loads are in
// flight.
__device__ __forceinline__ float2 ell_sum2(const float* src, int stride,
                                           const int* li0, const float* lc0,
                                           int k0, int c0, const int* li1,
                                           const float* lc1, int k1, int c1) {
  constexpr int kBatch = 8;
  float2 acc = make_float2(0.0f, 0.0f);
  for (int s0 = 0; s0 < max(k0, k1); s0 += kBatch) {
    float v0[kBatch], w0[kBatch], v1[kBatch], w1[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int s = s0 + j;
      w0[j] = s < k0 ? lc0[s] : 0.0f;
      w1[j] = s < k1 ? lc1[s] : 0.0f;
      v0[j] = w0[j] != 0.0f ? src[(size_t)li0[s] * stride + c0] : 0.0f;
      v1[j] = w1[j] != 0.0f ? src[(size_t)li1[s] * stride + c1] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (w0[j] != 0.0f) acc.x = __fmaf_rn(w0[j], v0[j], acc.x);
      if (w1[j] != 0.0f) acc.y = __fmaf_rn(w1[j], v1[j], acc.y);
    }
  }
  return acc;
}

// Ask L2 for `bytes` of global memory at `p` (a later step's inputs), the
// share of CTA `rank` of the cluster: one prefetch a 128-byte line.
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes,
                                            unsigned rank) {
  if (p == nullptr || bytes == 0) return;
  const char* base = static_cast<const char*>(p);
  const size_t lines = (bytes + 127) / 128;
  const size_t lo = lines * rank / kCluster, hi = lines * (rank + 1) / kCluster;
  for (size_t i = lo + threadIdx.x; i < hi; i += kThreads)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(base + i * 128));
}

// Warp-uniform: does node tile q (rows [32 q, 32 q + 32) of n) carry a
// nonzero mask? Called by a whole warp.
__device__ __forceinline__ bool warp_tile_live(const float* mask, int q,
                                               int n) {
  const int v = q * kTileRows + (int)(threadIdx.x & 31);
  return __any_sync(0xffffffffu, v < n && mask[v] != 0.0f);
}

// The chains of one row's aggregate at columns c0 .. c0 + 3, continued
// over the lanes whose source row lies in [lo, hi), in lane order: src
// holds rows lo.. (`stride` floats apart, 16-byte aligned at column c0),
// one float4 a lane, each column its own chain (the row windows of GCRN's
// agg_h: the paged kernel stages them, so the resident kernel sums in the
// same order).
__device__ __forceinline__ float4 ell_window4(float4 acc, const float* src,
                                              int stride, int lo, int hi,
                                              const int* li, const float* lc,
                                              int k, int c0) {
  constexpr int kBatch = 8;
  for (int s0 = 0; s0 < k; s0 += kBatch) {
    float4 v[kBatch];
    float w[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int s = s0 + j;
      const int u = s < k ? li[s] : lo - 1;
      w[j] = s < k && u >= lo && u < hi ? lc[s] : 0.0f;
      v[j] = w[j] != 0.0f ? *reinterpret_cast<const float4*>(
                                src + (size_t)(u - lo) * stride + c0)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (w[j] != 0.0f) {
        acc.x = __fmaf_rn(w[j], v[j].x, acc.x);
        acc.y = __fmaf_rn(w[j], v[j].y, acc.y);
        acc.z = __fmaf_rn(w[j], v[j].z, acc.z);
        acc.w = __fmaf_rn(w[j], v[j].w, acc.w);
      }
  }
  return acc;
}

// -------------------------------------------------- live tiles a step ----
// A step's live node tiles (a nonzero mask among their rows) as a bitmask
// in shared memory: kLiveWords words, so n at most kMaxRows (the launchers
// refuse more). All CTAs of a cluster read the same mask, so they agree on
// every bit, and every loop over live tiles runs alike in all of them.
constexpr int kLiveWords = 64;
constexpr int kMaxRows = kLiveWords * 32 * kTileRows;

// Block-wide; ends with a block barrier.
__device__ __forceinline__ void live_bits(const float* mask, int n,
                                          uint32_t* bits) {
  const int tiles = (n + kTileRows - 1) / kTileRows;
  for (int w = threadIdx.x; w < kLiveWords; w += kThreads) bits[w] = 0u;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  for (int q = warp; q < tiles; q += kThreads / 32) {
    if (warp_tile_live(mask, q, n) && (threadIdx.x & 31) == 0)
      atomicOr(bits + (q >> 5), 1u << (q & 31));
  }
  __syncthreads();
}

__device__ __forceinline__ bool tile_live(const uint32_t* bits, int q) {
  return (bits[q >> 5] >> (q & 31)) & 1u;
}

// The first live tile at or after q, or the tile count.
__device__ __forceinline__ int next_live(const uint32_t* bits, int q, int n) {
  const int tiles = (n + kTileRows - 1) / kTileRows;
  while (q < tiles && !tile_live(bits, q)) ++q;
  return q;
}

__device__ __forceinline__ int count_live(const uint32_t* bits) {
  int total = 0;
  for (int w = 0; w < kLiveWords; ++w) total += __popc(bits[w]);
  return total;
}

// ------------------------------------------------------- the TMA ring ----
// A paged engine moves a CTA's own columns through a ring of `depth` slots
// in shared memory (hbm_paged; depth 1, 2 or 4). A window is one or more
// TMA boxes of a 3-D fp32 tensor map (td columns, at most kBoxRows rows)
// that land in one slot and complete on its mbarrier. The ring counts the
// windows consumed (`seq`, block-uniform); window s sits in slot s % depth
// and its barrier phase has parity (s / depth) & 1. Thread 0 issues: a
// sweep issues its first depth windows, and after each window is consumed
// (and a block barrier) the window depth further on, so while one window
// is read the next depth - 1 are in flight.

struct Ring {
  float* slots;
  uint64_t* bars;
  int depth, slot_floats;
  unsigned seq;
};

__device__ __forceinline__ Ring ring_make(float* slots, uint64_t* bars,
                                          int depth, int slot_floats) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) hopper::mbar_init(hopper::smem_u32(bars + s), 1);
    hopper::mbar_fence_init();
  }
  return Ring{slots, bars, depth, slot_floats, 0u};
}

__device__ __forceinline__ float* ring_slot(const Ring& r, unsigned seq) {
  return r.slots + (size_t)(seq % (unsigned)r.depth) * r.slot_floats;
}

__device__ __forceinline__ uint32_t ring_bar(const Ring& r, unsigned seq) {
  return hopper::smem_u32(r.bars + seq % (unsigned)r.depth);
}

__device__ __forceinline__ void ring_wait(const Ring& r, unsigned seq) {
  hopper::mbar_wait(ring_bar(r, seq), (seq / (unsigned)r.depth) & 1u);
}

// Each thread: order its earlier generic global stores before later reads
// of the same memory through the async proxy (the ring's TMA loads); a
// block barrier follows before the loads are issued.
__device__ __forceinline__ void publish_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// One contiguous run of global memory into shared memory, completing on
// mbarrier `bar` (a 1-D bulk copy: 16-byte aligned, bytes a multiple of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(hopper::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// --------------------------------------------------------- host side ----

// A (d2, d1, d0) row-major fp32 tensor as a 3-D tensor map whose box is
// (1, box_rows, box_cols): d0 a multiple of 4 (16-byte rows), box_cols a
// multiple of 4, box_rows <= kBoxRows; elements outside read as zeros.
inline cudaError_t f32_map_3d(CUtensorMap* map, const void* base, int d0,
                              int d1, int d2, int box_cols, int box_rows) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * 4,
                                 (cuuint64_t)d0 * 4 * (cuuint64_t)d1};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch `kernel` on B clusters of kCluster CTAs (one a stream) of
// `threads` threads and `smem` bytes of dynamic shared memory each.
template <class... Params, class... Args>
inline int launch(void (*kernel)(Params...), int B, int threads, size_t smem,
                  void* stream, Args&&... args) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * kCluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of this launch the card can hold at once (cudaOccupancyMax-
// ActiveClusters), or -1 where the query fails.
template <class... Params>
inline int max_active_clusters(void (*kernel)(Params...), int threads,
                               size_t smem) {
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = -1;
  if (cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg) !=
      cudaSuccess)
    return -1;
  return clusters;
}

}  // namespace cluster
