// What the flash attention kernels share (flash_attention.cu, the
// forward; flash_attention_bwd.cu, the backward): the 64-row tile of the
// fp32 kernels, the bf16 packing of two floats, and the load of an fp32
// tile into shared memory, zero-filled past the edge.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace flash {

constexpr int kTile = 64;        // rows of a q tile and of a kv tile (fp32)
constexpr int kMaxD = 128;       // the largest head_dim
constexpr int kPld = kTile + 4;  // row stride of an fp32 (64, 64) tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// Rows [r0, r0 + 64) of a (rows, d) fp32 matrix into a (64, d + 4) tile,
// by kThreads threads; rows at or past n_rows are zero.
template <int kThreads>
__device__ __forceinline__ void load_tile_f32(const float* src, int r0,
                                              int n_rows, int d, float* dst) {
  const int chunks = d / 4, ld = d + 4;
  for (int e = threadIdx.x; e < kTile * chunks; e += kThreads) {
    const int r = e / chunks, c = (e - r * chunks) * 4;
    const float4 val = r0 + r < n_rows
                           ? *reinterpret_cast<const float4*>(
                                 src + (size_t)(r0 + r) * d + c)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

}  // namespace flash
