// Stacked DGNN V2 step (GCN -> GRU, one snapshot) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/dgnn_fused.py, stacked_fused_pallas and its
// body _stacked_kernel, reached through kernels/ops.stacked_fused_step from
// core/stacked.StackedDGNN.step(mode="v2").
//
// What it computes (the plain version is repro_torch/kernels/ref.py
// stacked_fused_step), for every node row v of one snapshot:
//   agg = sum_k coef * (x[idx] + emsg[eidx])
//   nt  = agg @ Wg + bg                           (the NT stage, linear)
//   gx  = nt @ Wx + b,  gh = h @ Wh               -> r | z | n each
//   h'  = (1 - z) n + z h,  r = sig(rx + rh), z = sig(zx + zh),
//         n = tanh(nx + r nh)
// against the row's own h (no aggregation over h), no mask (the model
// masks after the step).
//
// Design. One CTA per tile of 32 node rows; the tile's aggregate, its node
// transform nt and its own h rows stay in shared memory as k-major tiles
// (the paper's node queue between the GNN and RNN stages), so neither nt
// nor the 3H-wide gate tensors reach device memory. Weights are read from
// L2 once per 8 rows of a thread's register micro-tile. A tile without a
// nonzero coef skips the aggregation and the NT product (nt is exactly bg
// there); the GRU still runs, since h differs per row.
//
// What bounds it. 20 CTAs at n = 640, so the FMA rate of 20 SMs on the
// three products (2 rows (din dmid + dmid 3H + H 3H) flops) bounds it,
// above the roofline set by the per-step bytes.
#include "engine_common.cuh"

using namespace engine;

namespace {

struct StepArgs {
  const int* idx;     // (n, k) local neighbour ids
  const float* coef;  // (n, k)
  const int* eidx;    // (n, k) edge ids into emsg
  const float* x;     // (n, din)
  const float* h;     // (n, H) own hidden rows
  const float* wg;    // (din, dmid) last GCN layer
  const float* bg;    // (dmid)
  const float* wx;    // (dmid, 3H)
  const float* wh;    // (H, 3H)
  const float* bias;  // (3H)
  const float* emsg;  // (e, din), or null
  float* out;         // (n, H)
  int n, k, din, dmid, H;
};

__global__ void __launch_bounds__(kThreads) stacked_step_kernel(StepArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int n = a.n, k = a.k, din = a.din, dmid = a.dmid, H = a.H;
  float* agg = smem;                         // (din, kTileStride)
  float* nt = agg + din * kTileStride;       // (dmid, kTileStride)
  float* ht = nt + dmid * kTileStride;       // (H, kTileStride)
  int* s_idx = reinterpret_cast<int*>(ht + H * kTileStride);
  float* s_coef = reinterpret_cast<float*>(s_idx + kTileRows * k);
  int* s_eidx = reinterpret_cast<int*>(s_coef + kTileRows * k);

  const int r0 = blockIdx.x * kTileRows;
  load_ell_tile(a.idx, a.coef, a.eidx, r0, n, k, s_idx, s_coef,
                a.emsg != nullptr ? s_eidx : nullptr);
  load_tile(a.h, H, r0, n, ht);
  __syncthreads();
  const bool dense = tile_has_lanes(s_coef, k);
  if (dense) {
    aggregate_tile(a.x, a.emsg, din, s_idx, s_coef, s_eidx, k, agg, 0);
    __syncthreads();
  }
  linear_tile(agg, dense ? din : 0, a.wg, a.bg, dmid, nt);
  __syncthreads();
  gru_tile(nt, dmid, ht, H, a.wx, a.wh, a.bias, nullptr, r0, n, a.out);
}

}  // namespace

extern "C" {

size_t stacked_step_smem_bytes(int k, int din, int dmid, int H) {
  return sizeof(float) * (size_t)(din + dmid + H) * kTileStride +
         (size_t)kTileRows * k * (2 * sizeof(int) + sizeof(float));
}

int stacked_step_launch(const void* idx, const void* coef, const void* eidx,
                        const void* x, const void* h, const void* wg,
                        const void* bg, const void* wx, const void* wh,
                        const void* bias, const void* emsg, void* out, int n,
                        int k, int din, int dmid, int H, void* stream) {
  StepArgs a;
  a.idx = static_cast<const int*>(idx);
  a.coef = static_cast<const float*>(coef);
  a.eidx = static_cast<const int*>(eidx);
  a.x = static_cast<const float*>(x);
  a.h = static_cast<const float*>(h);
  a.wg = static_cast<const float*>(wg);
  a.bg = static_cast<const float*>(bg);
  a.wx = static_cast<const float*>(wx);
  a.wh = static_cast<const float*>(wh);
  a.bias = static_cast<const float*>(bias);
  a.emsg = static_cast<const float*>(emsg);
  a.out = static_cast<float*>(out);
  a.n = n; a.k = k; a.din = din; a.dmid = dmid; a.H = H;
  if (n <= 0) return 0;
  const size_t smem = stacked_step_smem_bytes(k, din, dmid, H);
  cudaError_t err = cudaFuncSetAttribute(
      stacked_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  stacked_step_kernel<<<tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* stacked_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
