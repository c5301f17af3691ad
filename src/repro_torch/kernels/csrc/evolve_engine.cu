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
// What bounds it. One SM per stream, serial in t and l: bound by one SM's
// fp32 FMA rate on 2 n D^2 (GCN) + 12 D^3 (GRU) flops per layer and live
// step, far from the card's roofline, which is set by the bytes of the
// per-step inputs. Spreading a stream over a thread-block cluster is the
// next step (ROADMAP.md).
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
};

__global__ void __launch_bounds__(kThreads) evolve_engine_kernel(EvolveArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int n = a.n, k = a.k, L = a.L, D = a.D;
  float* w_s = smem;                    // (D, D) W_l
  float* tile = w_s + (size_t)D * D;    // (D, kTileStride) k-major agg
  int* s_idx = reinterpret_cast<int*>(tile + D * kTileStride);
  float* s_coef = reinterpret_cast<float*>(s_idx + kTileRows * k);

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
      for (int p = threadIdx.x; p < D * D; p += kThreads) w_s[p] = wl[p];
      const float* src = l == 0 ? a.x + bt * n * D : act + (size_t)((l - 1) % 2) * n * D;
      float* dst = l == L - 1 ? a.out + bt * n * D : act + (size_t)(l % 2) * n * D;
      const float* ea = a.eagg != nullptr ? a.eagg + (bt * L + l) * n * D : nullptr;
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
          const int* li = s_idx + r * k;
          const float* lc = s_coef + r * k;
          float acc = 0.0f;
          for (int s = 0; s < k; ++s)  // coef-0 lanes add exact zeros
            if (lc[s] != 0.0f) acc += lc[s] * src[(size_t)li[s] * D + c];
          if (ea != nullptr && v < n) acc += ea[(size_t)v * D + c];
          tile[c * kTileStride + r] = acc;
        }
        __syncthreads();
        for (int p = threadIdx.x; p < kRowGroups * D; p += kThreads) {
          const int rg = p / D, col = p - rg * D;
          float acc[kRowsPerThread];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.0f;
          for (int kk = 0; kk < D; ++kk) {
            float av[kRowsPerThread];
            load_rows(tile + kk * kTileStride + rg * kRowsPerThread, av);
            const float wv = w_s[kk * D + col];
#pragma unroll
            for (int r = 0; r < kRowsPerThread; ++r) acc[r] = fmaf(av[r], wv, acc[r]);
          }
          const float bl = a.bias[l * D + col];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) {
            const int v = r0 + rg * kRowsPerThread + r;
            if (v < n) {
              float h = acc[r] + bl;
              if (l < L - 1) h = fmaxf(h, 0.0f);
              dst[(size_t)v * D + col] = h * mask[v];
            }
          }
        }
        __syncthreads();
      }

      // matrix-GRU evolution of W_l on live steps: rows of W^T are the
      // columns c of W, tiled kTileRows at a time; thread = (8 c's, f)
      if (live) {
        const float* gwx = a.gwx + (size_t)l * D * 3 * D;
        const float* gwh = a.gwh + (size_t)l * D * 3 * D;
        const float* gb = a.gb + (size_t)l * 3 * D;
        for (int c0 = 0; c0 < D; c0 += kTileRows) {
          for (int p = threadIdx.x; p < kRowGroups * D; p += kThreads) {
            const int rg = p / D, f = p - rg * D;
            const int cb = c0 + rg * kRowsPerThread;
            if (cb >= D) continue;
            float rx[kRowsPerThread], zx[kRowsPerThread], nx[kRowsPerThread];
            float rh[kRowsPerThread], zh[kRowsPerThread], nh[kRowsPerThread];
#pragma unroll
            for (int r = 0; r < kRowsPerThread; ++r) {
              rx[r] = zx[r] = nx[r] = rh[r] = zh[r] = nh[r] = 0.0f;
            }
            for (int m = 0; m < D; ++m) {
              float av[kRowsPerThread];
              load_rows(w_s + (size_t)m * D + cb, av);  // W^T[c, m] = W[m, c]
              const float* gx = gwx + (size_t)m * 3 * D;
              const float* gh = gwh + (size_t)m * 3 * D;
              const float xr = __ldg(gx + f), xz = __ldg(gx + D + f), xn = __ldg(gx + 2 * D + f);
              const float hr = __ldg(gh + f), hz = __ldg(gh + D + f), hn = __ldg(gh + 2 * D + f);
#pragma unroll
              for (int r = 0; r < kRowsPerThread; ++r) {
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
            for (int r = 0; r < kRowsPerThread; ++r) {
              const int c = cb + r;
              const float rr = sigmoidf(rx[r] + br + rh[r]);
              const float zz = sigmoidf(zx[r] + bz + zh[r]);
              const float nn = tanhf(nx[r] + bn + rr * nh[r]);
              wl[(size_t)f * D + c] = (1.0f - zz) * nn + zz * w_s[(size_t)f * D + c];
            }
          }
        }
        __syncthreads();
      }
    }
  }
}

}  // namespace

extern "C" {

size_t evolve_engine_smem_bytes(int k, int D) {
  return sizeof(float) * ((size_t)D * D + (size_t)D * kTileStride) +
         (size_t)kTileRows * k * (sizeof(int) + sizeof(float));
}

int evolve_engine_launch(const void* idx, const void* coef, const void* x,
                         const void* mask, const void* live, const void* bias,
                         const void* gwx, const void* gwh, const void* gb,
                         const void* eagg, void* out, void* w, void* act,
                         int B, int T, int n, int k, int L, int D,
                         void* stream) {
  if (D % kRowsPerThread != 0) return (int)cudaErrorInvalidValue;
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
  const size_t smem = evolve_engine_smem_bytes(k, D);
  cudaError_t err = cudaFuncSetAttribute(
      evolve_engine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  evolve_engine_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* evolve_engine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
