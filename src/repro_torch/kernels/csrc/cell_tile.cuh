// The gate product and LSTM update of a 32-row x 8-unit CTA, shared by the
// fused cells (fused_rnn.cu) and the V2 steps (gcrn_step.cu,
// stacked_step.cu).
//
// A CTA owns kRows node rows and kUnits hidden units with all G gates of
// them (weight columns g H + j0 .. + kUnits for each g). Its weights reach
// shared memory a chunk of K rows at a time through a cp.async ring; its
// activations sit row-major in shared memory. The K rows of a chunk are
// split over warps; inside a split a thread owns kRowsPerThread rows
// (rg + kRowGroups i) x kUnitsPerThread units (ug kUnitsPerThread + v) x
// every gate, fed by one float4 of activations a row for four K rows and
// one float2 of weights a gate a K row. The splits' partial sums meet in
// shared memory and are added in split order after the bias.
#pragma once

#include "engine_common.cuh"

namespace cell {

constexpr int kRows = 32;           // rows a CTA
constexpr int kUnits = 8;           // hidden units a CTA
constexpr int kRowsPerThread = 4;   // a thread's rows: rg + kRowGroups i
constexpr int kUnitsPerThread = 2;  // a thread's units: ug kUnitsPerThread + v
constexpr int kRowGroups = kRows / kRowsPerThread;
constexpr int kUnitGroups = kUnits / kUnitsPerThread;
constexpr int kGroup = kRowGroups * kUnitGroups;  // threads of one K split
static_assert(kGroup == 32, "a K split is one warp");

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   engine::smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   engine::smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// kUnitsPerThread consecutive floats from shared memory
__device__ __forceinline__ void load_units(const float* p,
                                           float (&v)[kUnitsPerThread]) {
  if constexpr (kUnitsPerThread == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int t = 0; t < kUnitsPerThread; ++t) v[t] = p[t];
  }
}

using Acc = float[4][kRowsPerThread][kUnitsPerThread];

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int v = 0; v < kUnitsPerThread; ++v) acc[s][i][v] = 0.0f;
}

// acc[s][i][v] += sum over kK K rows k of
//   ar[kRowGroups i a_stride + k] * wr[k G kUnits + g kUnits + v]
// with s = g, except gate 2 (the GRU's n, the LSTM's g), which sums into
// slot kNSlot: ar points at the thread's first row and the split's first K
// row of a row-major activation tile (a_stride floats a row, a multiple of
// 4), wr at the split's first K row of a staged weight chunk, offset to the
// thread's first unit.
template <int G, int kNSlot, int kK>
__device__ __forceinline__ void fma_rows(const float* ar, int a_stride,
                                         const float* wr, Acc& acc) {
  static_assert(kK % 4 == 0, "a split reads float4s along K");
#pragma unroll
  for (int k = 0; k < kK; k += 4) {
    float4 av[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      av[i] = *reinterpret_cast<const float4*>(
          ar + kRowGroups * i * a_stride + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float wv[G][kUnitsPerThread];
#pragma unroll
      for (int g = 0; g < G; ++g)
        load_units(wr + (k + q) * G * kUnits + g * kUnits, wv[g]);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float x = q == 0 ? av[i].x : q == 1 ? av[i].y
                      : q == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int s = g == 2 ? kNSlot : g;
#pragma unroll
          for (int v = 0; v < kUnitsPerThread; ++v)
            acc[s][i][v] = fmaf(x, wv[g][v], acc[s][i][v]);
        }
      }
    }
  }
}

// The partial sums of K split `split` into red: (splits, 4 slots, kRows,
// kUnits) floats.
__device__ __forceinline__ void store_partials(const Acc& acc, float* red,
                                               int split, int rg, int ug) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int v = 0; v < kUnitsPerThread; ++v)
        red[((split * 4 + s) * kRows + rg + kRowGroups * i) * kUnits +
            ug * kUnitsPerThread + v] = acc[s][i][v];
}

// Slot s of row r, unit u: `start` (its bias) plus the kSplit partial sums
// in split order.
template <int kSplit>
__device__ __forceinline__ float gate_sum(const float* red, int s, int r,
                                          int u, float start) {
#pragma unroll
  for (int p = 0; p < kSplit; ++p)
    start += red[((p * 4 + s) * kRows + r) * kUnits + u];
  return start;
}

// c' = sig(f) c + sig(i) tanh(g), h' = sig(o) tanh(c') of the gates
// i | f | g | o, every multiply-add spelled out.
__device__ __forceinline__ void lstm_update(const float (&gate)[4], float c,
                                            float& h_new, float& c_new) {
  c_new = __fmaf_rn(engine::sigmoidf(gate[1]), c,
                    __fmul_rn(engine::sigmoidf(gate[0]), tanhf(gate[2])));
  h_new = __fmul_rn(engine::sigmoidf(gate[3]), tanhf(c_new));
}

}  // namespace cell
