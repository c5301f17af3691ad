// Static GCN stream engine for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/stream_fused.py, _stream_engine_kernel with
// the static cell (_static_cell, launch assembly _static_build), reached
// through stream_call("static_gcn", ...).
//
// What it computes, per slot b (one independent snapshot, T = 1; the plain
// version is repro_torch/kernels/ref.py static_gcn_stream_batched_ref on
// the same packed inputs): an L-layer GCN over activations of width D,
//   a_0 = x[b];  a_{l+1} = act_l((sum_s coef a_l[idx] + eagg_l) @ W_l + b_l) * mask
// with ReLU except on the last layer, whose output is out[b], and the edge
// term only when eagg is given. Layers share one square width D (the JAX
// pack's common square d_pad; zero-padded rows and columns of W keep the
// padded activation columns at zero). No state: nothing carries between
// slots, and the wrapper refuses T != 1 before any launch.
//
// Design. One CTA per slot runs the L loop: the layers of a slot are
// sequential, the slots independent, so the BC-Alpha main path (137
// snapshots folded onto the batch axis) is one launch of 137 CTAs, the
// first of the port's kernels that spreads over the SMs. Activations
// ping-pong through per-slot global scratch (B, 2, n, D) with a block
// barrier between layers, as in evolve_engine.cu. Per live node tile the
// ELL aggregate sits in shared memory k-major and the product with W_l
// runs as a register micro-tile (engine_common.cuh linear_tile), the ReLU
// and the mask fused into its write-back. W is read through L2 (__ldg),
// not staged in shared memory: it is shared by all slots (2 x 64 KB at
// D = 128, L2-resident after the first slots read it), no other stage of
// the slot reads it, and staging the per-step kernels' weights through
// shared memory made them slower on the H100 (PERF.md).
//
// What bounds it. At 40 registers a thread three 512-thread CTAs fit an
// SM, so 137 slots on 132 SMs run in one wave, not two: the launch lasts
// as long as its largest slot (on an H100, BC-Alpha's 384-node snapshot
// alone takes 0.79 of the launch's 0.92 ms; PERF.md). Inside a slot it is
// bound by one SM's fp32 FMA rate on 2 rows D^2 flops a layer and live
// tile, far from the card's roofline, which the bytes of the inputs set.
// Splitting a large slot's tiles over more CTAs and per-layer widths (64
// of D's 128 at layer 0's input and the last layer's output on the main
// path) are the next steps.
#include "engine_common.cuh"

using namespace engine;

namespace {

struct StaticArgs {
  const int* idx;     // (B, n, k) local neighbour ids (T = 1)
  const float* coef;  // (B, n, k)
  const float* x;     // (B, n, D)
  const float* mask;  // (B, n)
  const float* w;     // (L, D, D) shared by the slots
  const float* bias;  // (L, D)
  const float* eagg;  // (B, L, n, D) pre-aggregated edge term, or null
  float* out;         // (B, n, D) last layer's activations
  float* act;         // (B, 2, n, D) scratch
  int n, k, L, D;
};

__global__ void __launch_bounds__(kThreads) static_engine_kernel(StaticArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int n = a.n, k = a.k, L = a.L, D = a.D;
  float* agg = smem;                   // (D, kTileStride) k-major aggregate
  float* nt = agg + D * kTileStride;   // (D, kTileStride) agg @ W_l + b_l
  int* s_idx = reinterpret_cast<int*>(nt + D * kTileStride);
  float* s_coef = reinterpret_cast<float*>(s_idx + kTileRows * k);

  const int b = blockIdx.x;
  const int* idx = a.idx + (size_t)b * n * k;
  const float* coef = a.coef + (size_t)b * n * k;
  const float* mask = a.mask + (size_t)b * n;
  float* act = a.act + (size_t)b * 2 * n * D;

  for (int l = 0; l < L; ++l) {
    const float* src = l == 0 ? a.x + (size_t)b * n * D
                              : act + (size_t)((l - 1) % 2) * n * D;
    float* dst = l == L - 1 ? a.out + (size_t)b * n * D
                            : act + (size_t)(l % 2) * n * D;
    const float* ea = a.eagg != nullptr ? a.eagg + ((size_t)b * L + l) * n * D
                                        : nullptr;
    const bool relu = l < L - 1;
    for (int r0 = 0; r0 < n; r0 += kTileRows) {
      if (!tile_is_live(mask, r0, n)) {  // all-padding tile: zeros
        const int rows = min(kTileRows, n - r0);
        for (int p = threadIdx.x; p < rows * D; p += kThreads)
          dst[(size_t)r0 * D + p] = 0.0f;
        continue;
      }
      load_ell_tile(idx, coef, nullptr, r0, n, k, s_idx, s_coef, nullptr);
      __syncthreads();
      aggregate_tile(src, nullptr, D, s_idx, s_coef, nullptr, k, agg, 0);
      __syncthreads();
      if (ea != nullptr) {  // the edge term joins the finished aggregate
        for (int p = threadIdx.x; p < kTileRows * D; p += kThreads) {
          const int r = p / D, c = p - r * D;
          if (r0 + r < n) agg[c * kTileStride + r] += ea[(size_t)(r0 + r) * D + c];
        }
        __syncthreads();
      }
      linear_tile(agg, D, a.w + (size_t)l * D * D, a.bias + (size_t)l * D, D,
                  nt);
      __syncthreads();
      for (int p = threadIdx.x; p < kTileRows * D; p += kThreads) {
        const int r = p / D, c = p - r * D;
        const int v = r0 + r;
        if (v < n) {
          float h = nt[c * kTileStride + r];
          if (relu) h = fmaxf(h, 0.0f);
          dst[(size_t)v * D + c] = h * mask[v];
        }
      }
      __syncthreads();
    }
    __syncthreads();  // layer l's activations are complete before l + 1
  }
}

}  // namespace

extern "C" {

size_t static_engine_smem_bytes(int k, int D) {
  return sizeof(float) * 2 * (size_t)D * kTileStride +
         (size_t)kTileRows * k * (sizeof(int) + sizeof(float));
}

int static_engine_launch(const void* idx, const void* coef, const void* x,
                         const void* mask, const void* w, const void* bias,
                         const void* eagg, void* out, void* act, int B, int n,
                         int k, int L, int D, void* stream) {
  StaticArgs a;
  a.idx = static_cast<const int*>(idx);
  a.coef = static_cast<const float*>(coef);
  a.x = static_cast<const float*>(x);
  a.mask = static_cast<const float*>(mask);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.eagg = static_cast<const float*>(eagg);
  a.out = static_cast<float*>(out);
  a.act = static_cast<float*>(act);
  a.n = n; a.k = k; a.L = L; a.D = D;
  const size_t smem = static_engine_smem_bytes(k, D);
  cudaError_t err = cudaFuncSetAttribute(
      static_engine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  static_engine_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* static_engine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
