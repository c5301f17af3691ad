// EvolveGCN-O stream engine for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/stream_fused.py, _stream_engine_kernel with
// the evolve cell (_evolve_cell) and its between-snapshot hook
// (_evolve_evolve), launch assembly _evolve_build, reached through
// stream_call("evolve", ...).
//
// What it computes, per stream b and step t (the plain version is
// repro_torch/kernels/ref.py evolve_stream_batched_ref on the same packed
// inputs): an L-layer GCN over activations of width D,
//   a_0 = x[b, t];  a_{l+1} = act_l((sum_k coef a_l[idx] + eagg_l) @ W_l + b_l) * mask
// (ReLU except on the last layer, whose output is out[b, t]); then, on a
// live step, every W_l evolves for step t+1 by the matrix-GRU with W_l^T as
// both input and hidden state (its columns are the GRU batch):
//   r = sig(W^T gwx_r + gb_r + W^T gwh_r), z = ..., n = tanh(W^T gwx_n + gb_n + r (W^T gwh_n))
//   W^T <- (1 - z) n + z W^T
// The incoming W is consumed unchanged at t = 0 (the primed-carry
// convention of core/evolvegcn.py): a state primed on the host is never
// evolved twice. Layers share one square width D (the JAX pack's common
// square d_pad, GRU params padded per gate block), so zero-padded weight
// rows stay zero under evolution.
//
// Design. One CTA per stream runs the T and L loops. W_l (D x D, 64 KB at
// D = 128) is copied into shared memory for its layer: the GCN product and
// the GRU both read it there. Activations ping-pong through per-stream
// global scratch (B, 2, n, D) with a barrier between layers. The GRU reads
// only the shared copy of W_l and writes the evolved W_l^{t+1} straight to
// the global state, so the update is in place with no second plane. Both
// products run as register micro-tiles (8 rows per thread); the GRU's six
// gate sums stay in registers.
//
// Paged variant (hbm_paged residency, evolve_engine_paged_launch): the same
// kernel compiled with kPaged, with no D x D buffer in shared memory. W_l
// stays in global memory and moves through the paging ring
// (engine_common.cuh) as (D, td) column windows: a node tile's GCN product
// writes the output columns of window w from W_l[:, w] alone, and the
// matrix-GRU evolves each window's columns on their own (its batch is W's
// columns, each evolving from its own column), writing them back to the
// global W_l beside the windows still in flight (disjoint columns). Both
// run the resident kernel's arithmetic, so outputs and final weights are
// bit-identical to it. Shared memory is linear in D at a fixed td.
//
// What bounds it. One SM per stream, serial in t and l: bound by one SM's
// fp32 FMA rate on 2 n D^2 (GCN) + 12 D^3 (GRU) flops per layer and live
// step, far from the card's roofline, which is set by the bytes of the
// per-step inputs. Spreading a stream over a thread-block cluster is the
// next step (ROADMAP.md). The paged variant adds the ring's copies: D^2
// floats a live tile and layer, and D^2 more for the GRU.
#include "engine_common.cuh"

using namespace engine;

namespace {

struct EvolveArgs {
  const int* idx;     // (B, T, n, k) local neighbour ids
  const float* coef;  // (B, T, n, k)
  const float* x;     // (B, T, n, D)
  const float* mask;  // (B, T, n)
  const int* live;    // (B, T) 1 = real step, 0 = no-op
  const float* bias;  // (L, D)
  const float* gwx;   // (L, D, 3D) [r | z | n]
  const float* gwh;   // (L, D, 3D)
  const float* gb;    // (L, 3D)
  const float* eagg;  // (B, T, L, n, D), or null
  float* out;         // (B, T, n, D) last layer's activations
  float* w;           // (B, L, D, D), W0 on entry, final W on exit
  float* act;         // (B, 2, n, D) scratch
  int T, n, k, L, D;
  int td, depth;      // paged: ring window width and depth
};

// R consecutive floats from shared memory (16-byte aligned for R >= 4).
template <int R>
__device__ __forceinline__ void load_run(const float* src, float (&a)[R]) {
  if constexpr (R == kRowsPerThread) {
    load_rows(src, a);
  } else if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = src[r];
  }
}

// dst[v, c0 + c] = act((tile @ W[:, c0 + c]) + b_l[c0 + c]) * mask[v] for
// the tile's rows v = r0 + r < n and c < width, W's columns read from wsrc
// (row kk of the window at wsrc + kk * wstride); ReLU unless `last`. A
// thread owns R rows of one column. Every output is the same chain of
// fmaf over kk = 0 .. D - 1 whatever R, so R changes the work a thread does
// (the resident kernel: 8 rows over all D columns; the paged one: 1 row,
// so a td-wide window still keeps every thread busy), not the result.
template <int R>
__device__ __forceinline__ void gcn_columns(const float* tile, int D,
                                            const float* wsrc, int wstride,
                                            int c0, int width,
                                            const float* bias, bool last,
                                            const float* mask, int r0, int n,
                                            float* dst) {
  for (int p = threadIdx.x; p < (kTileRows / R) * width; p += kThreads) {
    const int rg = p / width, cl = p - rg * width;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    // unrolled by 4, as the GRU's loop: left to the compiler, both loops
    // stayed rolled here and the resident kernel ran slower than with its
    // products written inline (PERF.md)
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float av[R];
      load_run<R>(tile + kk * kTileStride + rg * R, av);
      const float wv = wsrc[(size_t)kk * wstride + cl];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(av[r], wv, acc[r]);
    }
    const int col = c0 + cl;
    const float bl = bias[col];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int v = r0 + rg * R + r;
      if (v < n) {
        float h = __fadd_rn(acc[r], bl);
        if (!last) h = fmaxf(h, 0.0f);
        dst[(size_t)v * D + col] = __fmul_rn(h, mask[v]);
      }
    }
  }
}

// Matrix-GRU evolution of W's columns c0 .. c0 + width (width a multiple of
// R), read from wsrc (row m of those columns at wsrc + m * wstride),
// written to the same columns of the global w (D x D): rows of W^T are the
// columns c of W; a thread owns R of them and one output feature f. Every
// output is the same chain whatever R (8 resident, 4 paged: a td-wide
// window then still keeps the threads busy).
template <int R>
__device__ __forceinline__ void evolve_columns(const float* wsrc, int wstride,
                                               int c0, int width, int D,
                                               const float* gwx,
                                               const float* gwh,
                                               const float* gb, float* w) {
  const int groups = width / R;
  for (int p = threadIdx.x; p < groups * D; p += kThreads) {
    const int cg = p / D, f = p - cg * D;
    const int cb = cg * R;
    float rx[R], zx[R], nx[R], rh[R], zh[R], nh[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      rx[r] = zx[r] = nx[r] = rh[r] = zh[r] = nh[r] = 0.0f;
    }
#pragma unroll 4  // as gcn_columns' K loop
    for (int m = 0; m < D; ++m) {
      float av[R];
      load_run<R>(wsrc + (size_t)m * wstride + cb, av);  // W^T[c, m] = W[m, c]
      const float* gx = gwx + (size_t)m * 3 * D;
      const float* gh = gwh + (size_t)m * 3 * D;
      const float xr = __ldg(gx + f), xz = __ldg(gx + D + f), xn = __ldg(gx + 2 * D + f);
      const float hr = __ldg(gh + f), hz = __ldg(gh + D + f), hn = __ldg(gh + 2 * D + f);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        rx[r] = fmaf(av[r], xr, rx[r]);
        zx[r] = fmaf(av[r], xz, zx[r]);
        nx[r] = fmaf(av[r], xn, nx[r]);
        rh[r] = fmaf(av[r], hr, rh[r]);
        zh[r] = fmaf(av[r], hz, zh[r]);
        nh[r] = fmaf(av[r], hn, nh[r]);
      }
    }
    const float br = gb[f], bz = gb[D + f], bn = gb[2 * D + f];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float rr = sigmoidf(__fadd_rn(__fadd_rn(rx[r], br), rh[r]));
      const float zz = sigmoidf(__fadd_rn(__fadd_rn(zx[r], bz), zh[r]));
      const float nn = tanhf(__fmaf_rn(rr, nh[r], __fadd_rn(nx[r], bn)));
      const float own = wsrc[(size_t)f * wstride + cb + r];
      w[(size_t)f * D + c0 + cb + r] =
          __fmaf_rn(zz, own, __fmul_rn(__fsub_rn(1.0f, zz), nn));
    }
  }
}

template <bool kPaged>
__global__ void __launch_bounds__(kThreads) evolve_engine_kernel(EvolveArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int n = a.n, k = a.k, L = a.L, D = a.D;
  float* tile = smem;                    // (D, kTileStride) k-major agg
  int* s_idx = reinterpret_cast<int*>(tile + D * kTileStride);
  float* s_coef = reinterpret_cast<float*>(s_idx + kTileRows * k);
  // resident: (D, D) W_l; paged: the ring of (D, td) windows of W_l
  float* w_s = reinterpret_cast<float*>(s_coef + kTileRows * k);
  Ring ring{};
  if constexpr (kPaged) {
    const int slot_floats = D * a.td;
    ring = ring_make(w_s, reinterpret_cast<uint64_t*>(
                              w_s + (size_t)a.depth * slot_floats),
                     a.depth, a.td, slot_floats);
  }

  const int b = blockIdx.x;
  float* act = a.act + (size_t)b * 2 * n * D;

  for (int t = 0; t < a.T; ++t) {
    const size_t bt = (size_t)b * a.T + t;
    const int* idx = a.idx + bt * n * k;
    const float* coef = a.coef + bt * n * k;
    const float* mask = a.mask + bt * n;
    const bool live = a.live[bt] > 0;

    for (int l = 0; l < L; ++l) {
      float* wl = a.w + ((size_t)b * L + l) * D * D;
      const RowBlock wblock{wl, D, D};
      if constexpr (!kPaged)
        for (int p = threadIdx.x; p < D * D; p += kThreads) w_s[p] = wl[p];
      const float* src = l == 0 ? a.x + bt * n * D : act + (size_t)((l - 1) % 2) * n * D;
      float* dst = l == L - 1 ? a.out + bt * n * D : act + (size_t)(l % 2) * n * D;
      const float* ea = a.eagg != nullptr ? a.eagg + (bt * L + l) * n * D : nullptr;
      const float* bias = a.bias + (size_t)l * D;
      const bool last = l == L - 1;
      __syncthreads();

      // GCN layer over node tiles
      for (int r0 = 0; r0 < n; r0 += kTileRows) {
        if (!tile_is_live(mask, r0, n)) {  // all-padding tile: zeros
          const int rows = min(kTileRows, n - r0);
          for (int p = threadIdx.x; p < rows * D; p += kThreads)
            dst[(size_t)r0 * D + p] = 0.0f;
          continue;
        }
        load_ell_tile(idx, coef, nullptr, r0, n, k, s_idx, s_coef, nullptr);
        __syncthreads();
        for (int p = threadIdx.x; p < kTileRows * D; p += kThreads) {
          const int r = p / D, c = p - r * D;
          const int v = r0 + r;
          float acc = ell_sum(src, D, nullptr, 0, s_idx + r * k,
                              s_coef + r * k, nullptr, k, c);
          if (ea != nullptr && v < n) acc = __fadd_rn(acc, ea[(size_t)v * D + c]);
          tile[c * kTileStride + r] = acc;
        }
        __syncthreads();
        if constexpr (kPaged) {
          const int td = a.td;
          ring_sweep(ring, D, wblock, RowBlock{nullptr, 0, 0},
                     [&](int c0, int width, const float* slot) {
                       gcn_columns<1>(tile, D, slot, td, c0, width, bias,
                                      last, mask, r0, n, dst);
                     });
        } else {
          gcn_columns<kRowsPerThread>(tile, D, w_s, D, 0, D, bias, last,
                                      mask, r0, n, dst);
          __syncthreads();
        }
      }

      // matrix-GRU evolution of W_l on live steps
      if (live) {
        const float* gwx = a.gwx + (size_t)l * D * 3 * D;
        const float* gwh = a.gwh + (size_t)l * D * 3 * D;
        const float* gb = a.gb + (size_t)l * 3 * D;
        if constexpr (kPaged) {
          const int td = a.td;
          ring_sweep(ring, D, wblock, RowBlock{nullptr, 0, 0},
                     [&](int c0, int width, const float* slot) {
                       evolve_columns<4>(slot, td, c0, width, D, gwx, gwh,
                                         gb, wl);
                     });
          ring_publish();  // W_l^{t+1} is read through the ring next step
        } else {
          evolve_columns<kRowsPerThread>(w_s, D, 0, D, D, gwx, gwh, gb, wl);
        }
        __syncthreads();
      }
    }
  }
}

template <bool kPaged>
int launch(const EvolveArgs& a, int B, size_t smem, void* stream) {
  if (a.D % kRowsPerThread != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      evolve_engine_kernel<kPaged>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  evolve_engine_kernel<kPaged>
      <<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

EvolveArgs make_args(const void* idx, const void* coef, const void* x,
                     const void* mask, const void* live, const void* bias,
                     const void* gwx, const void* gwh, const void* gb,
                     const void* eagg, void* out, void* w, void* act, int T,
                     int n, int k, int L, int D) {
  EvolveArgs a;
  a.idx = static_cast<const int*>(idx);
  a.coef = static_cast<const float*>(coef);
  a.x = static_cast<const float*>(x);
  a.mask = static_cast<const float*>(mask);
  a.live = static_cast<const int*>(live);
  a.bias = static_cast<const float*>(bias);
  a.gwx = static_cast<const float*>(gwx);
  a.gwh = static_cast<const float*>(gwh);
  a.gb = static_cast<const float*>(gb);
  a.eagg = static_cast<const float*>(eagg);
  a.out = static_cast<float*>(out);
  a.w = static_cast<float*>(w);
  a.act = static_cast<float*>(act);
  a.T = T; a.n = n; a.k = k; a.L = L; a.D = D;
  a.td = 0; a.depth = 0;
  return a;
}

}  // namespace

extern "C" {

size_t evolve_engine_smem_bytes(int k, int D) {
  return sizeof(float) * ((size_t)D * D + (size_t)D * kTileStride) +
         (size_t)kTileRows * k * (sizeof(int) + sizeof(float));
}

size_t evolve_engine_paged_smem_bytes(int k, int D, int td, int depth) {
  return sizeof(float) * (size_t)D * kTileStride +
         (size_t)kTileRows * k * (sizeof(int) + sizeof(float)) +
         sizeof(float) * (size_t)depth * D * td + kRingBarBytes;
}

int evolve_engine_launch(const void* idx, const void* coef, const void* x,
                         const void* mask, const void* live, const void* bias,
                         const void* gwx, const void* gwh, const void* gb,
                         const void* eagg, void* out, void* w, void* act,
                         int B, int T, int n, int k, int L, int D,
                         void* stream) {
  const EvolveArgs a = make_args(idx, coef, x, mask, live, bias, gwx, gwh, gb,
                                 eagg, out, w, act, T, n, k, L, D);
  return launch<false>(a, B, evolve_engine_smem_bytes(k, D), stream);
}

int evolve_engine_paged_launch(const void* idx, const void* coef,
                               const void* x, const void* mask,
                               const void* live, const void* bias,
                               const void* gwx, const void* gwh,
                               const void* gb, const void* eagg, void* out,
                               void* w, void* act, int B, int T, int n, int k,
                               int L, int D, int td, int depth, void* stream) {
  if (td <= 0 || td % kRowsPerThread != 0 || depth < 1 || depth > kMaxDepth)
    return (int)cudaErrorInvalidValue;
  EvolveArgs a = make_args(idx, coef, x, mask, live, bias, gwx, gwh, gb, eagg,
                           out, w, act, T, n, k, L, D);
  a.td = td; a.depth = depth;
  return launch<true>(a, B, evolve_engine_paged_smem_bytes(k, D, td, depth),
                      stream);
}

const char* evolve_engine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* evolve_engine_paged_error_string(int code) {
  return evolve_engine_error_string(code);
}

}  // extern "C"
