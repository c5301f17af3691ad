// Fused GRU and LSTM cells for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_rnn.py, fused_gru_pallas (_gru_kernel)
// and fused_lstm_pallas (_lstm_kernel), reached through ops.fused_gru /
// ops.fused_lstm.
//
// What they compute (the plain versions are repro_torch/kernels/ref.py
// fused_gru / fused_lstm), for Bs rows of x (Bs, din) and h (Bs, H):
//   GRU:  gx = x @ wx + b, gh = h @ wh                     -> r | z | n
//         r = sig(rx + rh), z = sig(zx + zh), n = tanh(nx + r nh)
//         h' = (1 - z) n + z h                  (no bias on the hidden side)
//   LSTM: gates = x @ wx + h @ wh + b                      -> i | f | g | o
//         c' = sig(f) c + sig(i) tanh(g), h' = sig(o) tanh(c')
//
// Design. One CTA per tb-row tile, the TPU kernel's grid: it walks its rows
// in kTileRows sub-tiles. A sub-tile's x and h rows go to shared memory
// k-major, and both products run as the register micro-tile of the stream
// engines (engine_common.cuh gru_tile / lstm_tile: 8 rows x 3 or 4 gates a
// thread), with the gate arithmetic fused behind them; the gates never
// leave registers. The weights stay in global memory (L2), read once a
// sub-tile.
//
// What bounds it. At the benchmark shape (Bs 640, din = H = 128, tb 128)
// the grid has 5 CTAs on 132 SMs and each walks its 4 sub-tiles through
// a serial K loop of din + H rows: bound by those SMs' fp32 FMA rate, far
// from the card's roofline (the whole cell moves ~1 MB). More CTAs (a
// smaller tb, or the gate columns split over CTAs) are the next step.
#include "engine_common.cuh"

using namespace engine;

namespace {

struct RnnArgs {
  const float* x;     // (Bs, din)
  const float* h;     // (Bs, H)
  const float* c;     // (Bs, H), LSTM only
  const float* wx;    // (din, G H), G = 3 (GRU) or 4 (LSTM)
  const float* wh;    // (H, G H)
  const float* bias;  // (G H)
  float* h_out;       // (Bs, H)
  float* c_out;       // (Bs, H), LSTM only
  int Bs, din, H, tb;
};

__global__ void __launch_bounds__(kThreads) fused_gru_kernel(RnnArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* xt = smem;                      // (din, kTileStride)
  float* ht = xt + a.din * kTileStride;  // (H, kTileStride)
  const int lo = blockIdx.x * a.tb, hi = min(lo + a.tb, a.Bs);
  for (int r0 = lo; r0 < hi; r0 += kTileRows) {
    load_tile(a.x, a.din, r0, hi, xt);
    load_tile(a.h, a.H, r0, hi, ht);
    __syncthreads();
    gru_tile(xt, a.din, ht, a.H, a.wx, a.wh, a.bias, nullptr, r0, hi,
             a.h_out);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) fused_lstm_kernel(RnnArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;  // (din + H, kTileStride) k-major [x | h]
  const int lo = blockIdx.x * a.tb, hi = min(lo + a.tb, a.Bs);
  for (int r0 = lo; r0 < hi; r0 += kTileRows) {
    load_tile(a.x, a.din, r0, hi, tile);
    load_tile(a.h, a.H, r0, hi, tile + a.din * kTileStride);
    __syncthreads();
    lstm_tile(tile, a.din, a.H, true, a.wx, a.wh, a.bias, a.c, 0, a.H, 1,
              nullptr, r0, hi, a.h_out, a.c_out);
    __syncthreads();
  }
}

template <class Kernel>
int launch(Kernel kernel, const RnnArgs& a, size_t smem, void* stream) {
  if (a.tb <= 0 || a.Bs % a.tb != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.Bs / a.tb, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t fused_gru_smem_bytes(int din, int H) {
  return sizeof(float) * (size_t)(din + H) * kTileStride;
}

size_t fused_lstm_smem_bytes(int din, int H) {
  return sizeof(float) * (size_t)(din + H) * kTileStride;
}

int fused_gru_launch(const void* x, const void* h, const void* wx,
                     const void* wh, const void* bias, void* out, int Bs,
                     int din, int H, int tb, void* stream) {
  RnnArgs a{static_cast<const float*>(x), static_cast<const float*>(h),
            nullptr, static_cast<const float*>(wx),
            static_cast<const float*>(wh), static_cast<const float*>(bias),
            static_cast<float*>(out), nullptr, Bs, din, H, tb};
  return launch(fused_gru_kernel, a, fused_gru_smem_bytes(din, H), stream);
}

int fused_lstm_launch(const void* x, const void* h, const void* c,
                      const void* wx, const void* wh, const void* bias,
                      void* h_out, void* c_out, int Bs, int din, int H,
                      int tb, void* stream) {
  RnnArgs a{static_cast<const float*>(x), static_cast<const float*>(h),
            static_cast<const float*>(c), static_cast<const float*>(wx),
            static_cast<const float*>(wh), static_cast<const float*>(bias),
            static_cast<float*>(h_out), static_cast<float*>(c_out), Bs, din,
            H, tb};
  return launch(fused_lstm_kernel, a, fused_lstm_smem_bytes(din, H), stream);
}

const char* fused_gru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* fused_lstm_error_string(int code) {
  return fused_gru_error_string(code);
}

}  // extern "C"
