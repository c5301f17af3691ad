// Shared pieces of the node-tile kernels (gcrn_engine.cu, evolve_engine.cu,
// stacked_engine.cu, tgn_engine.cu, static_engine.cu, gcrn_step.cu,
// stacked_step.cu, fused_rnn.cu): block shape, the
// k-major activation tile, the ELL aggregation into it, the register
// micro-tile products that the gate / GCN / GRU stages run on, and the
// paging ring of the hbm_paged stream engines.
//
// A CTA walks node rows in tiles of kTileRows. The tile's activations sit
// in shared memory k-major (column c of row r at c * kTileStride + r);
// inside a product every thread owns kRowsPerThread rows of one output
// column, so a weight is read once per kRowsPerThread rows and the tile is
// read as two float4 broadcasts. Weights stay in global memory (L2).
//
// Every multiply-add below is spelled out (fmaf / __fmaf_rn, __fmul_rn,
// __fadd_rn) instead of being left to the compiler's contraction: the
// resident and the paged variant of an engine inline the same functions
// into different kernels, and must round alike to give bit-identical
// results.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace engine {

constexpr int kThreads = 512;
constexpr int kTileRows = 32;
constexpr int kRowsPerThread = 8;
constexpr int kRowGroups = kTileRows / kRowsPerThread;
// k-major tile A_s[c * kTileStride + r]: +4 keeps float4 alignment and
// spreads a column's rows over more banks on the transposing store.
constexpr int kTileStride = kTileRows + 4;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Eight consecutive floats from a 16-byte aligned address in shared
// memory: one thread's rows of one column of a k-major tile.
__device__ __forceinline__ void load_rows(const float* src,
                                          float (&a)[kRowsPerThread]) {
  const float4* p = reinterpret_cast<const float4*>(src);
  float4 lo = p[0], hi = p[1];
  a[0] = lo.x; a[1] = lo.y; a[2] = lo.z; a[3] = lo.w;
  a[4] = hi.x; a[5] = hi.y; a[6] = hi.z; a[7] = hi.w;
}

// ELL tile of the node rows [r0, r0 + kTileRows) into shared memory;
// rows past n read as padding (index 0, coef 0).
__device__ __forceinline__ void load_ell_tile(const int* idx, const float* coef,
                                              const int* eidx, int r0, int n,
                                              int k, int* s_idx, float* s_coef,
                                              int* s_eidx) {
  const size_t base = (size_t)r0 * k;
  const int lim = (n - r0) * k;
  for (int p = threadIdx.x; p < kTileRows * k; p += kThreads) {
    const bool ok = p < lim;
    s_idx[p] = ok ? idx[base + p] : 0;
    s_coef[p] = ok ? coef[base + p] : 0.0f;
    if (s_eidx != nullptr) s_eidx[p] = ok ? eidx[base + p] : 0;
  }
}

// Block-uniform: does any of the tile's rows [r0, r0 + kTileRows) carry a
// nonzero mask? A tile without one produces exact zeros (every cell's
// output is multiplied by its mask), so the kernels skip its arithmetic.
__device__ __forceinline__ bool tile_is_live(const float* mask, int r0, int n) {
  const int v = r0 + (int)threadIdx.x;
  return __syncthreads_or(threadIdx.x < kTileRows && v < n && mask[v] != 0.0f) != 0;
}

// Block-uniform: does the loaded ELL tile hold a nonzero coef? Without one
// every aggregate of the tile is exactly zero, so a product over it adds
// exact zeros to its bias and the kernels skip it.
__device__ __forceinline__ bool tile_has_lanes(const float* s_coef, int k) {
  int any = 0;
  for (int p = threadIdx.x; p < kTileRows * k; p += kThreads)
    any |= s_coef[p] != 0.0f;
  return __syncthreads_or(any) != 0;
}

// ELL sum of one row r and column c:
//   sum_s coef[r, s] * (src[idx[r, s] * src_stride + c]
//                       + emsg[eidx[r, s] * emsg_stride + c])
// over the row's lanes li / lc / le in order (emsg null: no edge term).
// coef-0 lanes (ELL padding) add exact zeros and are skipped.
__device__ __forceinline__ float ell_sum(const float* src, int src_stride,
                                         const float* emsg, int emsg_stride,
                                         const int* li, const float* lc,
                                         const int* le, int k, int c) {
  float acc = 0.0f;
  for (int s = 0; s < k; ++s) {
    if (lc[s] == 0.0f) continue;
    float v = src[(size_t)li[s] * src_stride + c];
    if (emsg != nullptr) v = __fadd_rn(v, emsg[(size_t)le[s] * emsg_stride + c]);
    acc = __fmaf_rn(lc[s], v, acc);
  }
  return acc;
}

// Columns [col0, col0 + width) of the k-major tile hold the ELL aggregate
// of the loaded rows:
//   tile[(col0 + c) * kTileStride + r] =
//       sum_s coef[r, s] * (src[idx[r, s], c] + emsg[eidx[r, s], c])
// over row-major src / emsg of `width` floats a row (emsg null: no edge
// term).
__device__ __forceinline__ void aggregate_tile(const float* src,
                                               const float* emsg, int width,
                                               const int* s_idx,
                                               const float* s_coef,
                                               const int* s_eidx, int k,
                                               float* tile, int col0) {
  for (int p = threadIdx.x; p < kTileRows * width; p += kThreads) {
    const int r = p / width, c = p - r * width;
    tile[(col0 + c) * kTileStride + r] =
        ell_sum(src, width, emsg, width, s_idx + r * k, s_coef + r * k,
                emsg != nullptr ? s_eidx + r * k : nullptr, k, c);
  }
}

// The same aggregate over a column window: `width` columns of a staged
// window whose rows are `stride` floats apart (a ring slot), into tile
// columns [col0, col0 + width).
__device__ __forceinline__ void aggregate_window(const float* win, int stride,
                                                 int width, const int* s_idx,
                                                 const float* s_coef, int k,
                                                 float* tile, int col0) {
  for (int p = threadIdx.x; p < kTileRows * width; p += kThreads) {
    const int r = p / width, c = p - r * width;
    tile[(col0 + c) * kTileStride + r] =
        ell_sum(win, stride, nullptr, 0, s_idx + r * k, s_coef + r * k,
                nullptr, k, c);
  }
}

// Rows [r0, r0 + kTileRows) of a row-major (n, width) matrix into columns
// [0, width) of a k-major tile; rows past n read as zeros.
__device__ __forceinline__ void load_tile(const float* src, int width, int r0,
                                          int n, float* tile) {
  for (int p = threadIdx.x; p < kTileRows * width; p += kThreads) {
    const int r = p / width, c = p - r * width;
    tile[c * kTileStride + r] =
        r0 + r < n ? src[(size_t)(r0 + r) * width + c] : 0.0f;
  }
}

// out = A @ W + bias as a k-major (N, kTileStride) tile, A the first K
// columns of a k-major tile, W (K, N) row-major, bias null for none. K = 0
// gives the bias.
__device__ __forceinline__ void linear_tile(const float* a, int K,
                                            const float* w, const float* bias,
                                            int N, float* out) {
  for (int p = threadIdx.x; p < kRowGroups * N; p += kThreads) {
    const int rg = p / N, col = p - rg * N;
    const float bc = bias != nullptr ? bias[col] : 0.0f;
    float acc[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[r] = bc;
    for (int kk = 0; kk < K; ++kk) {
      float av[kRowsPerThread];
      load_rows(a + kk * kTileStride + rg * kRowsPerThread, av);
      const float wv = __ldg(w + (size_t)kk * N + col);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[r] = fmaf(av[r], wv, acc[r]);
    }
    float4* o = reinterpret_cast<float4*>(out + col * kTileStride +
                                          rg * kRowsPerThread);
    o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

// GC-LSTM update of the tile's rows v = r0 + r < n:
//   gates = tile[:, :din] @ wx + tile[:, din:din+H] @ wh + b  -> i | f | g | o
//   c' = (sig(f) c + sig(i) tanh(g)) m,  h' = sig(o) tanh(c') m
// with c read from c_in[(v - c_r0) * c_rs + j * c_cs] (row major in global
// memory: c_r0 = 0, c_rs = H, c_cs = 1; a k-major tile: c_r0 = r0, c_rs = 1,
// c_cs = kTileStride), h' and c' written to h_out / c_out (row major, H
// wide), m = mask[v] (1 where mask is null). `dense` false: the tile's
// aggregates are all zero, so the gates are the bias.
__device__ __forceinline__ void lstm_tile(const float* tile, int din, int H,
                                          bool dense, const float* wx,
                                          const float* wh, const float* bias,
                                          const float* c_in, int c_r0,
                                          int c_rs, int c_cs,
                                          const float* mask, int r0, int n,
                                          float* h_out, float* c_out) {
  const int K = dense ? din + H : 0;
  for (int p = threadIdx.x; p < kRowGroups * H; p += kThreads) {
    const int rg = p / H, j = p - rg * H;
    float acc[4][kRowsPerThread];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float bg = bias[g * H + j];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[g][r] = bg;
    }
    for (int kk = 0; kk < K; ++kk) {
      float av[kRowsPerThread];
      load_rows(tile + kk * kTileStride + rg * kRowsPerThread, av);
      const float* w = kk < din ? wx + (size_t)kk * 4 * H
                                : wh + (size_t)(kk - din) * 4 * H;
      const float w0 = __ldg(w + j), w1 = __ldg(w + H + j);
      const float w2 = __ldg(w + 2 * H + j), w3 = __ldg(w + 3 * H + j);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        acc[0][r] = fmaf(av[r], w0, acc[0][r]);
        acc[1][r] = fmaf(av[r], w1, acc[1][r]);
        acc[2][r] = fmaf(av[r], w2, acc[2][r]);
        acc[3][r] = fmaf(av[r], w3, acc[3][r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int v = r0 + rg * kRowsPerThread + r;
      if (v < n) {
        const float m = mask != nullptr ? mask[v] : 1.0f;
        const size_t o = (size_t)v * H + j;
        const float c = c_in[(size_t)(v - c_r0) * c_rs + (size_t)j * c_cs];
        const float c_new = __fmul_rn(
            __fmaf_rn(sigmoidf(acc[1][r]), c,
                      __fmul_rn(sigmoidf(acc[0][r]), tanhf(acc[2][r]))), m);
        h_out[o] = __fmul_rn(__fmul_rn(sigmoidf(acc[3][r]), tanhf(c_new)), m);
        c_out[o] = c_new;
      }
    }
  }
}

// GRU update of the tile's rows v = r0 + r < n, with the input x in the
// first K columns of the k-major tile xt and the hidden state h in the
// first H columns of the k-major tile ht:
//   gx = x @ wx + b, gh = h @ wh                    -> r | z | n each
//   h' = ((1 - z) n + z h) m,  r = sig(rx + rh), z = sig(zx + zh),
//   n = tanh(nx + r nh),  m = mask[v] (1 where mask is null)
// written row-major (H wide) to out.
__device__ __forceinline__ void gru_tile(const float* xt, int K,
                                         const float* ht, int H,
                                         const float* wx, const float* wh,
                                         const float* bias, const float* mask,
                                         int r0, int n, float* out) {
  for (int p = threadIdx.x; p < kRowGroups * H; p += kThreads) {
    const int rg = p / H, j = p - rg * H;
    float rx[kRowsPerThread], zx[kRowsPerThread], nx[kRowsPerThread];
    float rh[kRowsPerThread], zh[kRowsPerThread], nh[kRowsPerThread];
    const float br = bias[j], bz = bias[H + j], bn = bias[2 * H + j];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      rx[r] = br; zx[r] = bz; nx[r] = bn;
      rh[r] = zh[r] = nh[r] = 0.0f;
    }
    for (int kk = 0; kk < K; ++kk) {
      float av[kRowsPerThread];
      load_rows(xt + kk * kTileStride + rg * kRowsPerThread, av);
      const float* w = wx + (size_t)kk * 3 * H;
      const float wr = __ldg(w + j), wz = __ldg(w + H + j), wn = __ldg(w + 2 * H + j);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        rx[r] = fmaf(av[r], wr, rx[r]);
        zx[r] = fmaf(av[r], wz, zx[r]);
        nx[r] = fmaf(av[r], wn, nx[r]);
      }
    }
    for (int kk = 0; kk < H; ++kk) {
      float av[kRowsPerThread];
      load_rows(ht + kk * kTileStride + rg * kRowsPerThread, av);
      const float* w = wh + (size_t)kk * 3 * H;
      const float wr = __ldg(w + j), wz = __ldg(w + H + j), wn = __ldg(w + 2 * H + j);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        rh[r] = fmaf(av[r], wr, rh[r]);
        zh[r] = fmaf(av[r], wz, zh[r]);
        nh[r] = fmaf(av[r], wn, nh[r]);
      }
    }
    float hv[kRowsPerThread];
    load_rows(ht + j * kTileStride + rg * kRowsPerThread, hv);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int v = r0 + rg * kRowsPerThread + r;
      if (v < n) {
        const float m = mask != nullptr ? mask[v] : 1.0f;
        const float rr = sigmoidf(__fadd_rn(rx[r], rh[r]));
        const float zz = sigmoidf(__fadd_rn(zx[r], zh[r]));
        const float nn = tanhf(__fmaf_rn(rr, nh[r], nx[r]));
        out[(size_t)v * H + j] = __fmul_rn(
            __fmaf_rn(zz, hv[r], __fmul_rn(__fsub_rn(1.0f, zz), nn)), m);
      }
    }
  }
}

// ------------------------------------------------------ the paging ring ----
// Under hbm_paged residency a stream engine reads its t-1 state through a
// ring of `depth` slots in shared memory (depth 1, 2 or 4; kMaxDepth
// mbarriers are reserved). A slot holds one td-wide column window: the
// columns [c0, c0 + width) of up to two row blocks of global memory, row
// after row, td floats apart. The rows arrive as cp.async.bulk copies, one
// a row, issued by all threads; each slot's mbarrier expects the window's
// bytes (arrive.expect_tx by thread 0) and completes when they have
// landed, and the consumers wait on its phase parity. While window w is
// consumed, windows w + 1 .. w + depth - 1 are in flight; depth 1 copies
// each window synchronously.
constexpr int kMaxDepth = 4;
constexpr int kRingBarBytes = kMaxDepth * 8;

// Rows [0, rows) of a row-major matrix, `stride` floats a row.
struct RowBlock {
  const float* base;
  int stride, rows;
};

struct Ring {
  float* slots;        // depth slots of slot_floats floats
  uint64_t* bars;      // one mbarrier a slot
  int depth, td, slot_floats;
  unsigned seq;        // windows taken so far (block-uniform)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Ring over `slot_floats`-float slots at `slots`, mbarriers at `bars`.
__device__ __forceinline__ Ring ring_make(float* slots, uint64_t* bars,
                                          int depth, int td, int slot_floats) {
  Ring ring{slots, bars, depth, td, slot_floats, 0u};
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(bars + s))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return ring;
}

// Each thread: order its earlier global stores before the ring's copies
// (which read through the async proxy). Call before the barrier that
// precedes a sweep over memory the block has just written.
__device__ __forceinline__ void ring_publish() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Start window number `seq`: columns [c0, c0 + width) of the rows of a and
// then b into slot seq % depth.
__device__ __forceinline__ void ring_issue(const Ring& ring, unsigned seq,
                                           int c0, int width,
                                           const RowBlock& a,
                                           const RowBlock& b) {
  const int slot = (int)(seq % (unsigned)ring.depth);
  float* dst = ring.slots + (size_t)slot * ring.slot_floats;
  const uint32_t bar = smem_addr(ring.bars + slot);
  const uint32_t row_bytes = (uint32_t)width * sizeof(float);
  const int rows = a.rows + b.rows;
  if (threadIdx.x == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"((uint32_t)rows * row_bytes)
                 : "memory");
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const float* src = r < a.rows ? a.base + (size_t)r * a.stride + c0
                                  : b.base + (size_t)(r - a.rows) * b.stride + c0;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst + (size_t)r * ring.td)),
        "l"(src), "r"(row_bytes), "r"(bar)
        : "memory");
  }
}

// Block until window number `seq` has landed in its slot.
__device__ __forceinline__ void ring_wait(const Ring& ring, unsigned seq) {
  const uint32_t bar = smem_addr(ring.bars + seq % (unsigned)ring.depth);
  const uint32_t parity = (seq / (unsigned)ring.depth) & 1u;
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One sweep over the columns [0, cols) of the row blocks a and b in td-wide
// windows, in order: consume(c0, width, slot) runs with all threads once
// window [c0, c0 + width) has landed, while the next depth - 1 windows are
// in flight. Each window's slot is refilled only after a block barrier, so
// every thread is done reading it; the sweep ends with that barrier. The
// rows must not be written while the sweep reads them, and stores made to
// them before the sweep need ring_publish() and a barrier first.
template <class Consume>
__device__ __forceinline__ void ring_sweep(Ring& ring, int cols,
                                           const RowBlock& a,
                                           const RowBlock& b,
                                           Consume consume) {
  const int nwin = (cols + ring.td - 1) / ring.td;
  const unsigned base = ring.seq;
  for (int w = 0; w < min(ring.depth, nwin); ++w)
    ring_issue(ring, base + w, w * ring.td, min(ring.td, cols - w * ring.td),
               a, b);
  for (int w = 0; w < nwin; ++w) {
    const unsigned seq = base + w;
    ring_wait(ring, seq);
    const int c0 = w * ring.td;
    consume(c0, min(ring.td, cols - c0),
            static_cast<const float*>(
                ring.slots + (size_t)(seq % (unsigned)ring.depth) * ring.slot_floats));
    __syncthreads();
    const int next = w + ring.depth;
    if (next < nwin)
      ring_issue(ring, base + next, next * ring.td,
                 min(ring.td, cols - next * ring.td), a, b);
  }
  ring.seq = base + nwin;
}

}  // namespace engine
