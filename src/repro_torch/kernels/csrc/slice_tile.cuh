// Node tiles of 32 rows that the 8 CTAs of a thread-block cluster share,
// each computing a column slice of a product on them: the pieces of the V2
// stacked step (stacked_step.cu) and the static GCN engine
// (static_engine.cu).
//
// - share_row: one row's ELL aggregate over a range of column groups,
//   gathered by a quarter or an eighth of a warp (ell_lanes.cuh: the row's
//   entries in one coalesced load, the live ones shuffled out kBatch at a
//   time, the gathers of a batch issued before their FMAs, which run in
//   ascending lane order) and stored into the row-major tile of every CTA
//   of the cluster through distributed shared memory (DSMEM). A CTA sums
//   only its range, so after a cluster barrier every CTA holds the whole
//   tile.
// - slice_pass / slice_sum: kPassCols output columns of tile @ W on the
//   whole tile: the K rows split over the 8 warps, each thread 4 rows x 4
//   columns (a float4 of the tile a row and a float4 of W a K row, from
//   shared memory; W read from global memory instead where the CTA's slice
//   of it does not fit), the splits' partial sums meeting in shared memory
//   and added in split order. fp32 FMA on the CUDA cores.
#pragma once

#include "cluster_common.cuh"
#include "ell_lanes.cuh"

namespace slice {

constexpr int kRows = engine::kTileRows;  // rows a tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowThreads = 8;               // a quarter warp a row ...
constexpr int kWarpRows = 32 / kRowThreads;  // ... four rows a warp
constexpr int kRowEntries = ell::kEntries<kRowThreads>;
constexpr int kBatch = 8;       // live lanes gathered at once
constexpr int kPassCols = 16;   // output columns of one slice_pass
constexpr int kPartFloats = kWarps * kRows * kPassCols;
static_assert(kWarps * kWarpRows == kRows, "every row of the tile at once");
static_assert(kThreads == kRows * kPassCols / 2, "two outputs a thread");

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Columns of a tile over a K range of `width` (a multiple of 32: each warp's
// split is whole float4s; zeros past the width), and floats between two of
// its rows (4 mod 32: a warp's float4 reads of 8 rows fall on distinct
// banks).
__host__ __device__ __forceinline__ int k_cols(int width) {
  return round_up(width, 32);
}
__host__ __device__ __forceinline__ int k_stride(int width) {
  return k_cols(width) + 4;
}

// Arrive at the cluster barrier without ordering memory: the first barrier
// only says this CTA runs (its shared memory may take a peer's stores).
__device__ __forceinline__ void arrive_running() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

template <bool kConst, class T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kConst) return __ldg(p);
  else return *p;
}

// Column groups [lo, hi) (V floats each) of row v of
//   agg[c] = sum_s coef[v, s] (src[idx[v, s] ld + c] + emsg[eidx[v, s] width
//            + c]) + add[c]
// for c < width, zeros past it (emsg null: no edge term; add null, or row
// v past n: none), into `trow` (the row in this CTA's tile) of every CTA of
// the cluster, by the row's kRT threads (thread t of them, `group` their
// place in the warp; lo and hi CTA-uniform). The row's entries come 32 a
// round (`first`, `live`: the first round's, loaded already), the live
// ones kBatch at a time; thread t sums the groups lo + t + kRT c.
// kConst: src is not written while the kernel runs (the read-only path).
// `wait_first`: wait on the cluster barrier arrived at on entry (every peer
// runs) before the first DSMEM store, so the gathers overlap the wait.
// width and ld are multiples of V, src / emsg / add 16-byte aligned at V 4.
template <int V, bool kConst, int kRT = kRowThreads>
__device__ __forceinline__ void share_row(
    const float* src, int ld, int width, const float* emsg, const float* add,
    const int* idx, const float* coef, const int* eidx, int v, int n, int k,
    const ell::Entry (&first)[ell::kEntries<kRT>], unsigned live, int t,
    int group, int lo, int hi, float* trow, bool wait_first) {
  constexpr int kEntries = ell::kEntries<kRT>;
  using T = typename ell::Vec<V>::T;
  const int dw = width / V, dl = ld / V;
  const T* es = reinterpret_cast<const T*>(emsg);
  const size_t base = (size_t)v * k;
  bool waited = !wait_first;  // CTA-uniform
  for (int q0 = lo; q0 < hi; q0 += kRT) {  // warp-uniform
    // the group's column (padding groups read column 0 and store zeros)
    const int q = q0 + t;
    const bool valid = q < dw;
    const T* col = reinterpret_cast<const T*>(src) + (valid ? q : 0);
    const T* ec = es + (valid ? q : 0);
    T acc = ell::Vec<V>::zero();
    for (int s0 = 0; s0 < k; s0 += 32) {
      ell::Entry ent[kEntries];
      unsigned m = live;
      if (s0 == 0) {
#pragma unroll
        for (int j = 0; j < kEntries; ++j) ent[j] = first[j];
      } else {
        m = ell::load_round<kRT>(idx, coef, eidx, base, v < n, s0, k, t,
                                 group, es != nullptr, ent);
      }
      while (__any_sync(~0u, m != 0)) {
        int id[kBatch], ed[kBatch];
        float cf[kBatch];
        ell::next_batch<kRT, kBatch>(m, ent, group, id, cf, ed);
        T val[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          val[b] = load<kConst>(col + (size_t)id[b] * dl);
        if (es != nullptr) {  // CTA-uniform
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const T ev = __ldg(ec + (size_t)ed[b] * dw);
            if (valid) val[b] = ell::Vec<V>::add(val[b], ev);
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) ell::Vec<V>::fma(acc, cf[b], val[b]);
      }
    }
    if (add != nullptr && valid && v < n)
      acc = ell::Vec<V>::add(acc, __ldg(reinterpret_cast<const T*>(add) + q));
    if (!waited) {  // every CTA of the cluster runs
      cluster::wait();
      waited = true;
    }
    if (q < hi) {
      const T out = valid ? acc : ell::Vec<V>::zero();
#pragma unroll
      for (unsigned r = 0; r < cluster::kCluster; ++r)
        *cluster::peer(reinterpret_cast<T*>(trow) + q, r) = out;
    }
  }
  if (!waited) cluster::wait();
}

// The partial sums of kPassCols output columns of tile @ W over the tile's
// kc K columns (k_cols of the true K, zeros past it; row-major, `stride`
// floats a row), warp s summing K rows [s kc / 8, (s + 1) kc / 8), into
// part[(s kRows + r) kPassCols + c]. W: kSmemW, ws[kk ldw + c] (shared
// memory, zeros past the true K and the pass's columns); else the pass's
// first column at wg, wg[kk ldg + c] for kk < kin and c < wc (global
// memory, zeros past them).
template <bool kSmemW>
__device__ __forceinline__ void slice_pass(const float* tile, int stride,
                                           int kc, const float* ws, int ldw,
                                           const float* wg, int ldg, int kin,
                                           int wc, float* part) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 4, cg = lane % 4;  // rows rg + 8 i, columns 4 cg + j
  const int ks = kc / kWarps, k0 = warp * ks;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  const float* ar = tile + rg * stride + k0;
  for (int kk = 0; kk < ks; kk += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(ar + 8 * i * stride + kk);
    float4 wv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kr = k0 + kk + q;
      if constexpr (kSmemW) {
        wv[q] = *reinterpret_cast<const float4*>(ws + kr * ldw + 4 * cg);
      } else {
        float w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * cg + j;
          w[j] = kr < kin && c < wc ? __ldg(wg + (size_t)kr * ldg + c) : 0.0f;
        }
        wv[q] = make_float4(w[0], w[1], w[2], w[3]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 w = wv[q];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = q == 0 ? av[i].x : q == 1 ? av[i].y
                      : q == 2 ? av[i].z : av[i].w;
        acc[i][0] = fmaf(x, w.x, acc[i][0]);
        acc[i][1] = fmaf(x, w.y, acc[i][1]);
        acc[i][2] = fmaf(x, w.z, acc[i][2]);
        acc[i][3] = fmaf(x, w.w, acc[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(part + (warp * kRows + rg + 8 * i) * kPassCols +
                               4 * cg) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// `start` plus the kWarps partial sums of row r, column c of a pass, in
// split order. Thread x of the block finishes row x / 8, columns
// 2 (x % 8) and 2 (x % 8) + 1.
__device__ __forceinline__ float slice_sum(const float* part, int r, int c,
                                           float start) {
#pragma unroll
  for (int s = 0; s < kWarps; ++s)
    start += part[(s * kRows + r) * kPassCols + c];
  return start;
}

}  // namespace slice
