// GCRN-M2 V2 step (GC-LSTM, one snapshot) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/dgnn_fused.py, gcrn_fused_pallas and its body
// _gcrn_kernel, reached through kernels/ops.dgnn_fused_step from
// core/gcrn.GCRN.step(mode="v2").
//
// What it computes (the plain version is repro_torch/kernels/ref.py
// dgnn_fused_step), for every node row v of one snapshot:
//   agg_x = sum_k coef * (x[idx] + emsg[eidx]),  agg_h = sum_k coef * h[idx]
//   gates = agg_x @ Wx + agg_h @ Wh + b          -> i | f | g | o
//   c' = sig(f) c + sig(i) tanh(g),  h' = sig(o) tanh(c')
// No mask: padding rows get the gates of a zero aggregate (the model masks
// after the step, as the JAX kernel's caller does).
//
// Design. The paper's node-queue FIFO between the GNN and RNN stages is the
// CTA's shared memory: one CTA per tile of 32 node rows aggregates x and h
// over the tile's ELL lanes into a k-major tile, and the gate product and
// LSTM update read it there, so neither the aggregate nor the 4H-wide gate
// tensor reaches device memory. The weights ((din + H) x 4H, 393 KB at full
// width) do not fit a CTA; they are read from L2, each read once per
// 8 rows of a thread's register micro-tile (engine_common.cuh). A tile
// without a nonzero coef (all padding) skips the aggregation and product:
// its gates are exactly the bias.
//
// What bounds it. A snapshot of n = 640 rows gives 20 CTAs, so 20 of the
// 132 SMs work and the fp32 FMA rate of those SMs on the gate product
// (2 rows (din + H) 4H flops) bounds it, above the card's roofline, which
// the per-step bytes (x, h, c, the weights once) set.
#include "engine_common.cuh"

using namespace engine;

namespace {

struct StepArgs {
  const int* idx;     // (n, k) local neighbour ids
  const float* coef;  // (n, k)
  const int* eidx;    // (n, k) edge ids into emsg
  const float* x;     // (n, din)
  const float* h;     // (n, H) hidden state of every row (aggregated over)
  const float* c;     // (n, H)
  const float* wx;    // (din, 4H)
  const float* wh;    // (H, 4H)
  const float* bias;  // (4H)
  const float* emsg;  // (e, din), or null
  float* h_out;       // (n, H)
  float* c_out;       // (n, H)
  int n, k, din, H;
};

__global__ void __launch_bounds__(kThreads) gcrn_step_kernel(StepArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int n = a.n, k = a.k, din = a.din, H = a.H;
  float* tile = smem;  // (din + H, kTileStride) k-major [agg_x | agg_h]
  int* s_idx = reinterpret_cast<int*>(tile + (din + H) * kTileStride);
  float* s_coef = reinterpret_cast<float*>(s_idx + kTileRows * k);
  int* s_eidx = reinterpret_cast<int*>(s_coef + kTileRows * k);

  const int r0 = blockIdx.x * kTileRows;
  load_ell_tile(a.idx, a.coef, a.eidx, r0, n, k, s_idx, s_coef,
                a.emsg != nullptr ? s_eidx : nullptr);
  __syncthreads();
  const bool dense = tile_has_lanes(s_coef, k);
  if (dense) {
    aggregate_tile(a.x, a.emsg, din, s_idx, s_coef, s_eidx, k, tile, 0);
    aggregate_tile(a.h, nullptr, H, s_idx, s_coef, s_eidx, k, tile, din);
    __syncthreads();
  }
  lstm_tile(tile, din, H, dense, a.wx, a.wh, a.bias, a.c, 0, H, 1, nullptr,
            r0, n, a.h_out, a.c_out);
}

}  // namespace

extern "C" {

size_t gcrn_step_smem_bytes(int k, int din, int H) {
  return sizeof(float) * (size_t)(din + H) * kTileStride +
         (size_t)kTileRows * k * (2 * sizeof(int) + sizeof(float));
}

int gcrn_step_launch(const void* idx, const void* coef, const void* eidx,
                     const void* x, const void* h, const void* c,
                     const void* wx, const void* wh, const void* bias,
                     const void* emsg, void* h_out, void* c_out, int n, int k,
                     int din, int H, void* stream) {
  StepArgs a;
  a.idx = static_cast<const int*>(idx);
  a.coef = static_cast<const float*>(coef);
  a.eidx = static_cast<const int*>(eidx);
  a.x = static_cast<const float*>(x);
  a.h = static_cast<const float*>(h);
  a.c = static_cast<const float*>(c);
  a.wx = static_cast<const float*>(wx);
  a.wh = static_cast<const float*>(wh);
  a.bias = static_cast<const float*>(bias);
  a.emsg = static_cast<const float*>(emsg);
  a.h_out = static_cast<float*>(h_out);
  a.c_out = static_cast<float*>(c_out);
  a.n = n; a.k = k; a.din = din; a.H = H;
  if (n <= 0) return 0;
  const size_t smem = gcrn_step_smem_bytes(k, din, H);
  cudaError_t err = cudaFuncSetAttribute(
      gcrn_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  gcrn_step_kernel<<<tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* gcrn_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
