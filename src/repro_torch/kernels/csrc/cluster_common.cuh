// Thread-block cluster pieces of the column-sliced stream engines
// (gcrn_engine.cu, evolve_engine.cu, stacked_engine.cu, tgn_engine.cu):
// the cluster's shape and ranks, the cluster barrier, stores into a peer
// CTA's shared memory (DSMEM), the all-gather of a k-major node tile, the
// ELL tile with each row's live lanes packed, the batched ELL gathers (and
// TGN's partner windows), the row gathers and scatters of a CTA's own
// columns, the step's live-tile bitmask walked in chunks, L2 prefetch of
// the next step, the own units' products (the node transform and the GRU
// of the stacked and TGN engines), the TMA ring that pages a CTA's own
// columns, and the cluster launch.
//
// One cluster runs one stream: CTA r of the cluster owns the columns
// [r * W / kCluster, (r + 1) * W / kCluster) of a W-wide state (hidden
// units; EvolveGCN's columns of W_l). The ELL aggregate is
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
// keep their order. eidx and aux (null: none) are two more int words a
// lane, packed alike. Rows past n have no lanes, mask 0 and row -1.
__device__ __forceinline__ void load_ell_tile(const int* idx,
                                              const float* coef,
                                              const int* eidx,
                                              const float* mask,
                                              const int* rowg, int r0, int n,
                                              int k, int* s_idx,
                                              float* s_coef, int* s_eidx,
                                              float* s_mask, int* s_rowg,
                                              int* s_cnt, int t, int nt,
                                              const int* aux = nullptr,
                                              int* s_aux = nullptr) {
  constexpr int kRowsAtOnce = 4;  // rows a warp loads before it packs
  const int warp = t >> 5, nwarps = nt >> 5, lane = t & 31;
  for (int rb = warp; rb < kTileRows; rb += kRowsAtOnce * nwarps) {
    int cnt[kRowsAtOnce] = {0, 0, 0, 0};
    for (int s0 = 0; s0 < k; s0 += 32) {
      float cv[kRowsAtOnce];
      int iv[kRowsAtOnce], ev[kRowsAtOnce], xv[kRowsAtOnce];
#pragma unroll
      for (int q = 0; q < kRowsAtOnce; ++q) {
        const int r = rb + q * nwarps, v = r0 + r, s = s0 + lane;
        const bool ok = r < kTileRows && v < n && s < k;
        const size_t at = (size_t)v * k + s;
        cv[q] = ok ? coef[at] : 0.0f;
        iv[q] = ok ? idx[at] : 0;
        ev[q] = ok && eidx != nullptr ? eidx[at] : 0;
        xv[q] = ok && aux != nullptr ? aux[at] : 0;
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
          if (s_aux != nullptr) s_aux[at] = xv[q];
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

// ELL sum of one row and column c (one chain: coef-0 lanes skipped, the
// others' src (+ emsg) values added in lane order, the edge term added
// before the coef multiplies), with the gathers of kBatch lanes issued
// before their sums (8
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

// The chain of one row's ELL sum at column c, continued over the lanes
// whose local id lid[s] lies in [lo, hi), in lane order: lane s reads
// src[(row[s] - base) * stride + c] (row: the lane's row in src; the TGN
// partner windows: resident, global rows of the store, base 0; paged, the
// window's gathered rows, base lo), the gathers of 8 lanes issued before
// their sums.
__device__ __forceinline__ float ell_window(float acc, const float* src,
                                            int stride, const int* row,
                                            int base, const int* lid, int lo,
                                            int hi, const float* lc, int k,
                                            int c) {
  constexpr int kBatch = 8;
  for (int s0 = 0; s0 < k; s0 += kBatch) {
    float v[kBatch], w[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int s = s0 + j;
      const int u = s < k ? lid[s] : lo - 1;
      w[j] = s < k && u >= lo && u < hi ? lc[s] : 0.0f;
      v[j] = w[j] != 0.0f ? src[(size_t)(row[s] - base) * stride + c] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (w[j] != 0.0f) acc = __fmaf_rn(w[j], v[j], acc);
  }
  return acc;
}

// The chain of one row's ELL sum at column c over all the windows of wr
// local ids of n rows, in order, each window's lanes in lane order (as
// ell_window window by window): lane s reads src[row[s] * stride + c]. Up
// to 8 lanes are gathered in one round trip to global memory and summed
// window by window from registers; more take a pass a window.
__device__ __forceinline__ float ell_windows(const float* src, int stride,
                                             const int* row, const int* lid,
                                             int wr, int n, const float* lc,
                                             int k, int c) {
  constexpr int kBatch = 8;
  float acc = 0.0f;
  if (k > kBatch) {
    for (int lo = 0; lo < n; lo += wr)
      acc = ell_window(acc, src, stride, row, 0, lid, lo, min(lo + wr, n),
                       lc, k, c);
    return acc;
  }
  float v[kBatch], w[kBatch];
  int u[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    w[j] = j < k ? lc[j] : 0.0f;
    u[j] = j < k ? lid[j] : -1;
    v[j] = w[j] != 0.0f ? src[(size_t)row[j] * stride + c] : 0.0f;
  }
  for (int lo = 0; lo < n; lo += wr) {
    const int hi = min(lo + wr, n);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (w[j] != 0.0f && u[j] >= lo && u[j] < hi)
        acc = __fmaf_rn(w[j], v[j], acc);
  }
  return acc;
}

// The own columns [u0, u0 + hs) of a step's t-1 rows of a (G, H) store,
// masked (row v: store[rowg[v]] * mask[v]; zeros where rowg[v] is not a
// store row), into dst (n rows, `stride` floats apart, 16-byte aligned),
// by all threads, kGather items' loads in flight a thread (float4 items
// where the slice is 16-byte aligned).
__device__ __forceinline__ void gather_own(const float* store, int G, int H,
                                           int u0, int hs, const int* rowg,
                                           const float* mask, int n,
                                           float* dst, int stride) {
  constexpr int kGather = 8;
  const int tid = threadIdx.x;
  if (u0 % 4 == 0 && hs % 4 == 0) {
    const int per_row = hs / 4, items = n * per_row;
    for (int p0 = tid; p0 < items; p0 += kGather * kThreads) {
      float4 hv[kGather];
#pragma unroll
      for (int q = 0; q < kGather; ++q) {
        const int p = p0 + q * kThreads;
        hv[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const int v = p / per_row, j4 = p - v * per_row;
        const int g = p < items ? rowg[v] : -1;
        if (g >= 0 && g < G) {
          const float m = mask[v];
          const float4 h4 = *reinterpret_cast<const float4*>(
              store + (size_t)g * H + u0 + 4 * j4);
          hv[q] = make_float4(__fmul_rn(h4.x, m), __fmul_rn(h4.y, m),
                              __fmul_rn(h4.z, m), __fmul_rn(h4.w, m));
        }
      }
#pragma unroll
      for (int q = 0; q < kGather; ++q) {
        const int p = p0 + q * kThreads;
        if (p < items) {
          const int v = p / per_row, j4 = p - v * per_row;
          *reinterpret_cast<float4*>(dst + (size_t)v * stride + 4 * j4) =
              hv[q];
        }
      }
    }
  } else {
    for (int p0 = tid; p0 < n * hs; p0 += kGather * kThreads) {
      float hv[kGather];
#pragma unroll
      for (int q = 0; q < kGather; ++q) {
        const int p = p0 + q * kThreads;
        hv[q] = 0.0f;
        const int v = p / hs, j = p - v * hs;
        const int g = p < n * hs ? rowg[v] : -1;
        if (g >= 0 && g < G)
          hv[q] = __fmul_rn(store[(size_t)g * H + u0 + j], mask[v]);
      }
#pragma unroll
      for (int q = 0; q < kGather; ++q) {
        const int p = p0 + q * kThreads;
        if (p < n * hs) {
          const int v = p / hs, j = p - v * hs;
          dst[(size_t)v * stride + j] = hv[q];
        }
      }
    }
  }
}

// Rows [r0, r0 + kTileRows) of the own columns [u0, u0 + hs) of a (G, H)
// store, masked (store[rowg[v]] * mask[v], zeros past n or where rowg[v]
// is not a store row), into the k-major tile's columns [col0, col0 + hs),
// by all threads, the loads of kBatch items in flight a thread.
__device__ __forceinline__ void own_rows(const float* store, int G, int H,
                                         int u0, int hs, const int* rowg,
                                         const float* mask, int r0, int n,
                                         float* tile, int col0) {
  constexpr int kBatch = 4;
  const int items = kTileRows * hs;
  for (int p0 = threadIdx.x; p0 < items; p0 += kBatch * kThreads) {
    float val[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int p = p0 + q * kThreads;
      const int r = p / hs, v = r0 + r;
      const int g = p < items && v < n ? rowg[v] : -1;
      val[q] = g >= 0 && g < G
                   ? __fmul_rn(store[(size_t)g * H + u0 + p - r * hs],
                               mask[v])
                   : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int p = p0 + q * kThreads;
      if (p < items) {
        const int r = p / hs;
        tile[(size_t)(col0 + p - r * hs) * kTileStride + r] = val[q];
      }
    }
  }
}

// Rows [r0, r0 + kTileRows) of a row-major (n, din) matrix into a k-major
// tile (rows past n read as zeros), by all threads: float4 loads where din
// is a multiple of 4, kBatch of them in flight a thread.
__device__ __forceinline__ void load_rows_kmajor(const float* x, int din,
                                                 int r0, int n, float* tile) {
  constexpr int kBatch = 4;
  if (din % 4 == 0) {
    const int per_row = din / 4, items = kTileRows * per_row;
    for (int p0 = threadIdx.x; p0 < items; p0 += kBatch * kThreads) {
      float4 val[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int p = p0 + q * kThreads;
        const int r = p / per_row;
        val[q] = p < items && r0 + r < n
                     ? *reinterpret_cast<const float4*>(
                           x + (size_t)(r0 + r) * din + 4 * (p - r * per_row))
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int p = p0 + q * kThreads;
        if (p < items) {
          const int r = p / per_row, c = 4 * (p - r * per_row);
          float* dst = tile + (size_t)c * kTileStride + r;
          dst[0] = val[q].x;
          dst[kTileStride] = val[q].y;
          dst[2 * kTileStride] = val[q].z;
          dst[3 * kTileStride] = val[q].w;
        }
      }
    }
  } else {
    for (int p = threadIdx.x; p < kTileRows * din; p += kThreads) {
      const int r = p / din, kk = p - r * din;
      tile[(size_t)kk * kTileStride + r] =
          r0 + r < n ? x[(size_t)(r0 + r) * din + kk] : 0.0f;
    }
  }
}

// store[rowg[v]] = src[v] on the own columns [u0, u0 + hs) of the rows
// v < n whose rowg is a store row (G drops), by all threads, the loads of
// kBatch items in flight a thread.
__device__ __forceinline__ void scatter_own(const float* src, float* store,
                                            int G, int H, int u0, int hs,
                                            const int* rowg, int n) {
  constexpr int kBatch = 8;
  const int items = n * hs;
  for (int p0 = threadIdx.x; p0 < items; p0 += kBatch * kThreads) {
    int g[kBatch];
    float val[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int p = p0 + q * kThreads;
      const int v = p / hs;
      g[q] = p < items ? rowg[v] : -1;
      val[q] = p < items ? src[(size_t)v * H + u0 + p - v * hs] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int p = p0 + q * kThreads;
      if (g[q] >= 0 && g[q] < G) {
        const int v = p / hs;
        store[(size_t)g[q] * H + u0 + p - v * hs] = val[q];
      }
    }
  }
}

// --------------------------------------------- the own units' products ----
// A CTA's slice of a product, on the whole 32-row k-major tile. Weights sit
// in shared memory where they fit beside the tiles (kSmemW: the CTA's own
// columns only, staged once a stream), else in global memory (L2), read as
// they are; the sums are the same either way.

// tile[(oc + c) * kTileStride + r] = b[c] + sum_kk tile[(ac + kk) * ... + r]
// * W[kk, c] for the columns c < nc and the 32 rows, W[kk, c] at
// ws[kk * ldw + c], b[c] at bs[c] (kSmemW) or at wg[kk * N + c0 + c],
// bg[c0 + c] (global, N-wide), by threads t of nt: a thread owns 4 rows of
// one column; every output is one fmaf chain over kk from the bias.
template <bool kSmemW>
__device__ __forceinline__ void linear_cols(float* tile, int ac, int K,
                                            int oc, int nc, const float* ws,
                                            int ldw, const float* bs,
                                            const float* wg, const float* bg,
                                            int N, int c0, int t, int nt) {
  for (int p = t; p < kRowGroups * nc; p += nt) {
    const int rg = p / nc, c = p - rg * nc;
    const float bc = kSmemW ? bs[c] : bg[c0 + c];
    float acc[kRows] = {bc, bc, bc, bc};
    const float* ap = tile + (size_t)ac * kTileStride + rg * kRows;
    auto load = [&](int kk, float4& av, float& wv) {
      av = *reinterpret_cast<const float4*>(ap + (size_t)kk * kTileStride);
      wv = kSmemW ? ws[(size_t)kk * ldw + c]
                  : __ldg(wg + (size_t)kk * N + c0 + c);
    };
    auto step = [&](const float4& av, float wv) {
      acc[0] = fmaf(av.x, wv, acc[0]);
      acc[1] = fmaf(av.y, wv, acc[1]);
      acc[2] = fmaf(av.z, wv, acc[2]);
      acc[3] = fmaf(av.w, wv, acc[3]);
    };
    constexpr int kAhead = 4;  // K rows whose loads are issued together
    int kk = 0;
    for (; kk + kAhead <= K; kk += kAhead) {
      float4 av[kAhead];
      float wv[kAhead];
#pragma unroll
      for (int i = 0; i < kAhead; ++i) load(kk + i, av[i], wv[i]);
#pragma unroll
      for (int i = 0; i < kAhead; ++i) step(av[i], wv[i]);
    }
    for (; kk < K; ++kk) {
      float4 av;
      float wv;
      load(kk, av, wv);
      step(av, wv);
    }
    *reinterpret_cast<float4*>(tile + (size_t)(oc + c) * kTileStride +
                               rg * kRows) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// acc{0,1,2}[r] += sum over the K k-major tile columns at ap of a[r] *
// w{0,1,2}, row kk's three gate weights of unit j at ws[(kk * hm + j) * 3]
// (kSmemW) or at wg[kk * 3H + g H + u] (global), one fmaf chain each.
template <bool kSmemW>
__device__ __forceinline__ void gru_rows(const float* ap, int K,
                                         const float* ws, int hm, int j,
                                         const float* wg, int H, int u,
                                         float (&acc0)[kRows],
                                         float (&acc1)[kRows],
                                         float (&acc2)[kRows]) {
  constexpr int kAhead = 4;  // K rows whose loads are issued together
  auto step = [&](const float4& av, float w0, float w1, float w2) {
    const float a4[kRows] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      acc0[r] = fmaf(a4[r], w0, acc0[r]);
      acc1[r] = fmaf(a4[r], w1, acc1[r]);
      acc2[r] = fmaf(a4[r], w2, acc2[r]);
    }
  };
  auto load = [&](int kk, float4& av, float& w0, float& w1, float& w2) {
    av = *reinterpret_cast<const float4*>(ap + (size_t)kk * kTileStride);
    if (kSmemW) {
      const float* wp = ws + ((size_t)kk * hm + j) * 3;
      w0 = wp[0]; w1 = wp[1]; w2 = wp[2];
    } else {
      const float* wp = wg + (size_t)kk * 3 * H + u;
      w0 = __ldg(wp); w1 = __ldg(wp + H); w2 = __ldg(wp + 2 * H);
    }
  };
  int kk = 0;
  for (; kk + kAhead <= K; kk += kAhead) {
    float4 av[kAhead];
    float w0[kAhead], w1[kAhead], w2[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) load(kk + i, av[i], w0[i], w1[i], w2[i]);
#pragma unroll
    for (int i = 0; i < kAhead; ++i) step(av[i], w0[i], w1[i], w2[i]);
  }
  for (; kk < K; ++kk) {
    float4 av;
    float w0, w1, w2;
    load(kk, av, w0, w1, w2);
    step(av, w0, w1, w2);
  }
}

// Floats of gru_units' exchange buffer (its K split), where a CTA owns at
// most kSplitUnits units.
constexpr int kSplitUnits = kThreads / (2 * kRowGroups);
constexpr int kSplitFloats = kRowGroups * kSplitUnits * 3 * kRows;

// The GRU of the own units [u0, u0 + hs) on the tile's 32 rows, x in tile
// columns [xc, xc + Kx) and h in [hc, hc + H) (unit u0 + j's own h at
// column hc + u0 + j):
//   r = sig(b_r + x wx_r + h wh_r), z = sig(b_z + x wx_z + h wh_z),
//   n = tanh((b_n + x wx_n) + r (h wh_n)),  h' = (1 - z) n + z h.
// A thread owns 4 rows of one unit. Where the CTA has half a thread an item
// or more and an exchange buffer (`split`: xch, kSplitFloats of shared
// memory; hs <= kSplitUnits),
// the K loop splits: one thread runs x's rows from the biases, another h's
// from zero and parks its sums in xch, and after a block barrier the first
// adds them (r and z: x's sum + h's); else one thread runs x's rows, then
// h's, one fmaf chain a sum. Weights: kSmemW, a unit's three gate weights
// together, ws[(kk * hm + j) * 3 + g] (rows kk < Kx of wx, then H of wh)
// and bs[j * 3 + g]; else wx (Kx, 3H), wh (H, 3H) and b (3H) in global
// memory. epi(r, j, h') for every row and own unit; threads t of nt (all
// of the block where it splits).
template <bool kSmemW, class Epi>
__device__ __forceinline__ void gru_units(const float* tile, int xc, int Kx,
                                          int hc, int H, int u0, int hs,
                                          int hm, const float* ws,
                                          const float* bs, const float* wx,
                                          const float* wh, const float* b,
                                          float* xch, bool split, int t,
                                          int nt, Epi epi) {
  const int items = kRowGroups * hs;
  const float* wsh = kSmemW ? ws + (size_t)Kx * hm * 3 : nullptr;
  // item p's x rows from the biases into ar / az / an
  auto x_rows = [&](int p, float (&ar)[kRows], float (&az)[kRows],
                    float (&an)[kRows]) {
    const int rg = p / hs, j = p - rg * hs, u = u0 + j;
    const float br = kSmemW ? bs[j * 3] : b[u];
    const float bz = kSmemW ? bs[j * 3 + 1] : b[H + u];
    const float bn = kSmemW ? bs[j * 3 + 2] : b[2 * H + u];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ar[r] = br; az[r] = bz; an[r] = bn;
    }
    gru_rows<kSmemW>(tile + rg * kRows + (size_t)xc * kTileStride, Kx, ws,
                     hm, j, wx, H, u, ar, az, an);
  };
  // item p's h rows, continuing ar / az / ah
  auto h_rows = [&](int p, float (&ar)[kRows], float (&az)[kRows],
                    float (&ah)[kRows]) {
    const int rg = p / hs, j = p - rg * hs;
    gru_rows<kSmemW>(tile + rg * kRows + (size_t)hc * kTileStride, H, wsh,
                     hm, j, wh, H, u0 + j, ar, az, ah);
  };
  auto update = [&](int p, const float (&ar)[kRows], const float (&az)[kRows],
                    const float (&an)[kRows], const float (&ah)[kRows]) {
    const int rg = p / hs, j = p - rg * hs;
    const float4 h4 = *reinterpret_cast<const float4*>(
        tile + rg * kRows + (size_t)(hc + u0 + j) * kTileStride);
    const float hv[kRows] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float rr = engine::sigmoidf(ar[r]);
      const float zz = engine::sigmoidf(az[r]);
      const float nn = tanhf(__fmaf_rn(rr, ah[r], an[r]));
      epi(rg * kRows + r, j,
          __fmaf_rn(zz, hv[r], __fmul_rn(__fsub_rn(1.0f, zz), nn)));
    }
  };
  float ar[kRows], az[kRows], an[kRows], ah[kRows];
  if (split && 2 * items <= nt) {
    // the K loop split over two threads an item; one block barrier
    if (t < items) {
      x_rows(t, ar, az, an);
    } else if (t < 2 * items) {
      float hr[kRows] = {}, hz[kRows] = {}, hn[kRows] = {};
      h_rows(t - items, hr, hz, hn);
      float* x = xch + (size_t)(t - items) * 3 * kRows;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        x[r] = hr[r]; x[kRows + r] = hz[r]; x[2 * kRows + r] = hn[r];
      }
    }
    __syncthreads();
    if (t < items) {
      const float* x = xch + (size_t)t * 3 * kRows;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        ar[r] = __fadd_rn(ar[r], x[r]);
        az[r] = __fadd_rn(az[r], x[kRows + r]);
        ah[r] = x[2 * kRows + r];
      }
      update(t, ar, az, an, ah);
    }
    return;
  }
  for (int p = t; p < items; p += nt) {
    x_rows(p, ar, az, an);
#pragma unroll
    for (int r = 0; r < kRows; ++r) ah[r] = 0.0f;
    h_rows(p, ar, az, ah);
    update(p, ar, az, an, ah);
  }
}

// Stage the own units' GRU weights for gru_units (kSmemW): ws (Kx + H rows
// of [unit][gate], hm units, zeros past hs) and bs, by all threads.
__device__ __forceinline__ void stage_gru(const float* wx, int Kx,
                                          const float* wh, const float* b,
                                          int H, int u0, int hs, int hm,
                                          float* ws, float* bs) {
  for (int p = threadIdx.x; p < (Kx + H) * hm * 3; p += blockDim.x) {
    const int g = p % 3, j = (p / 3) % hm, kk = p / (3 * hm);
    float v = 0.0f;
    if (j < hs) {
      const size_t col = (size_t)g * H + u0 + j;
      v = kk < Kx ? wx[(size_t)kk * 3 * H + col]
                  : wh[(size_t)(kk - Kx) * 3 * H + col];
    }
    ws[p] = v;
  }
  for (int p = threadIdx.x; p < hm * 3; p += blockDim.x) {
    const int g = p % 3, j = p / 3;
    bs[p] = j < hs ? b[g * H + u0 + j] : 0.0f;
  }
}

// -------------------------------------------------- live tiles a step ----
// A step's live node tiles (a nonzero mask among their rows) as a bitmask
// in shared memory, kLiveWords words: the tiles of one chunk of
// kChunkTiles (65,536 rows). A step of more rows walks its tiles chunk by
// chunk, so no n is refused and no CTA's shared memory grows with n. All
// CTAs of a cluster read the same mask, so they agree on every bit, and
// every loop over live tiles runs alike in all of them.
constexpr int kLiveWords = 64;
constexpr int kChunkTiles = kLiveWords * 32;

// The bits of tiles [q0, q0 + kChunkTiles) by threads t of nt (whole warps)
// whose barrier is sync(); starts with a barrier (readers of the bits
// before are done) and ends with one.
template <class Sync>
__device__ __forceinline__ void live_bits(const float* mask, int n, int q0,
                                          uint32_t* bits, int t, int nt,
                                          Sync sync) {
  const int tiles = min((n + kTileRows - 1) / kTileRows - q0, kChunkTiles);
  sync();
  for (int w = t; w < kLiveWords; w += nt) bits[w] = 0u;
  sync();
  for (int q = t >> 5; q < tiles; q += nt >> 5) {
    if (warp_tile_live(mask, q0 + q, n) && (t & 31) == 0)
      atomicOr(bits + (q >> 5), 1u << (q & 31));
  }
  sync();
}

// The same by every thread of the block.
__device__ __forceinline__ void live_bits(const float* mask, int n, int q0,
                                          uint32_t* bits) {
  live_bits(mask, n, q0, bits, (int)threadIdx.x, (int)blockDim.x,
            [] { __syncthreads(); });
}

// Is tile q of the chunk starting at tile q0 live?
__device__ __forceinline__ bool tile_live(const uint32_t* bits, int q0,
                                          int q) {
  const int i = q - q0;
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

// The first live tile at or after q in the chunk starting at tile q0, or
// the chunk's end (the tile count where it is the last chunk).
__device__ __forceinline__ int next_live(const uint32_t* bits, int q0, int q,
                                         int n) {
  const int end = min((n + kTileRows - 1) / kTileRows, q0 + kChunkTiles);
  while (q < end && !tile_live(bits, q0, q)) ++q;
  return q;
}

__device__ __forceinline__ int chunk_end(int q0, int n) {
  return min((n + kTileRows - 1) / kTileRows, q0 + kChunkTiles);
}

__device__ __forceinline__ int count_live(const uint32_t* bits) {
  int total = 0;
  for (int w = 0; w < kLiveWords; ++w) total += __popc(bits[w]);
  return total;
}

// out[v] = 0 on the own columns [u0, u0 + hs) of the rows v in
// [q0 kTileRows, vend) whose tile is dead in the chunk's bits (and, with a
// store, store[rowg[v]] = 0 where rowg[v] is a store row), by all threads,
// a row's columns on neighbouring threads, the row ids of kBatch items
// loaded at once.
__device__ __forceinline__ void zero_dead_rows(float* out, float* store,
                                               int G, int H, int u0, int hs,
                                               const int* rowg,
                                               const uint32_t* bits, int q0,
                                               int vend) {
  constexpr int kBatch = 4;
  const int v_lo = q0 * kTileRows, items = (vend - v_lo) * hs;
  for (int p0 = (int)threadIdx.x; p0 < items; p0 += kBatch * kThreads) {
    int g[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int p = p0 + i * kThreads, v = v_lo + p / hs;
      const bool dead = p < items && !tile_live(bits, q0, v / kTileRows);
      g[i] = !dead ? -2 : store != nullptr ? rowg[v] : -1;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (g[i] == -2) continue;
      const int p = p0 + i * kThreads, v = v_lo + p / hs;
      const int j = p - (v - v_lo) * hs;
      out[(size_t)v * H + u0 + j] = 0.0f;
      if (g[i] >= 0 && g[i] < G) store[(size_t)g[i] * H + u0 + j] = 0.0f;
    }
  }
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
//
// The protocol log. Where a launch is given one (the engines' `proto`
// argument; null on every launch of the main path), the launcher runs the
// kernel's logging build (its kLog instantiation, whose rings carry the
// log; the main path's build has a null log, a compile-time constant, and
// no logging code), in which the ring's logging thread (the one that
// issues) appends a row at each issue (`ring_issue`) and at each wait
// (`ring_wait`), and EvolveGCN one at each read and write of a W plane:
// (CTA, ring, seq, slot, parity, window, event), `window` the entry's
// place in its sweep. The log is int32: a header (rows
// appended, an overflow flag, the capacity in rows) and then rows of
// kRowInts; a row past the capacity is dropped and sets the flag. One
// thread logs a (CTA, ring) pair, so the pair's rows are in its program
// order (kernels/engine.py reads them back, analysis/contracts.py replays
// them).

namespace proto {

constexpr int kHeader = 8;
constexpr int kRowInts = 8;
// rings: the paged state ring, EvolveGCN's GRU slab ring, and its W planes
// (reads and the final copy by the GCN's thread 0; writes by the GRU's)
enum Ring { kStateRing = 0, kGruRing = 1, kPlaneRead = 2, kPlaneWrite = 3 };
enum Event { kIssue = 0, kWait = 1, kRead = 2, kWrite = 3, kFinal = 4 };

__device__ __forceinline__ void append(int* log, int ring, int seq, int slot,
                                       int parity, int window, int event) {
  const int i = atomicAdd(log, 1);
  if (i >= log[2]) {
    atomicExch(log + 1, 1);
    return;
  }
  int* row = log + kHeader + (size_t)i * kRowInts;
  row[0] = (int)blockIdx.x;
  row[1] = ring;
  row[2] = seq;
  row[3] = slot;
  row[4] = parity;
  row[5] = window;
  row[6] = event;
  row[7] = 0;
}

}  // namespace proto

struct Ring {
  float* slots;
  uint64_t* bars;
  int depth, slot_floats;
  unsigned seq;
  int* log;     // the protocol log, or null
  int id;       // its ring id in the log (proto::Ring)
  int log_tid;  // the thread that issues, and logs
};

__device__ __forceinline__ Ring ring_make(float* slots, uint64_t* bars,
                                          int depth, int slot_floats,
                                          int* log = nullptr,
                                          int id = proto::kStateRing,
                                          int log_tid = 0) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) hopper::mbar_init(hopper::smem_u32(bars + s), 1);
    hopper::mbar_fence_init();
  }
  return Ring{slots, bars, depth, slot_floats, 0u, log, id, log_tid};
}

__device__ __forceinline__ float* ring_slot(const Ring& r, unsigned seq) {
  return r.slots + (size_t)(seq % (unsigned)r.depth) * r.slot_floats;
}

__device__ __forceinline__ uint32_t ring_bar(const Ring& r, unsigned seq) {
  return hopper::smem_u32(r.bars + seq % (unsigned)r.depth);
}

__device__ __forceinline__ void ring_log(const Ring& r, unsigned seq,
                                         int window, int event) {
  if (r.log != nullptr && (int)threadIdx.x == r.log_tid)
    proto::append(r.log, r.id, (int)seq, (int)(seq % (unsigned)r.depth),
                  (int)((seq / (unsigned)r.depth) & 1u), window, event);
}

// Entry `seq` of the ring, window `window` of its sweep, by the issuing
// thread: its barrier expects `bytes`; returns the barrier, on which the
// caller's copies complete.
__device__ __forceinline__ uint32_t ring_issue(const Ring& r, unsigned seq,
                                               int window, uint32_t bytes) {
  const uint32_t bar = ring_bar(r, seq);
  ring_log(r, seq, window, proto::kIssue);
  hopper::mbar_expect_tx(bar, bytes);
  return bar;
}

// Every thread that reads entry `seq` (window `window` of its sweep).
__device__ __forceinline__ void ring_wait(const Ring& r, unsigned seq,
                                          int window) {
  hopper::mbar_wait(ring_bar(r, seq), (seq / (unsigned)r.depth) & 1u);
  ring_log(r, seq, window, proto::kWait);
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
