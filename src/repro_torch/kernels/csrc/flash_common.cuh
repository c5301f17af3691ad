// What the flash attention kernels share (flash_attention.cu, the
// forward; flash_attention_bwd.cu, the backward): the 64-row tile, the
// bf16 tensor-core instructions (mma.sync m16n8k16, ldmatrix .trans) and
// the loads of a tile into shared memory, zero-filled past the edge.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace flash {

constexpr int kTile = 64;        // rows of a q tile and of a kv tile
constexpr int kMaxD = 128;       // the largest head_dim
constexpr int kPld = kTile + 4;  // row stride of an fp32 (64, 64) tile
constexpr float kNegInf = -1e30f;
constexpr int kMaxKSteps = kMaxD / 16;  // 16 dims a k-step of an mma
constexpr int kMaxDTiles = kMaxD / 8;   // 8 output dims an mma n-tile

// c += a . b: one m16n8k16 tile, bf16 x bf16 products summed in fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, rows k..k+15 of a row-major tile (k along the
// rows) at two 8-column blocks, as the B fragments of two n-tiles,
// transposed on the way (ldmatrix .trans). Lanes 0-15 address the rows of
// the first block, lanes 16-31 those of the second.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem_row) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of one k-step (16 columns from c0) of 16 rows of a
// row-major bf16 tile in shared memory (row stride ld); g = lane / 4,
// t = lane % 4.
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4],
                                            const __nv_bfloat16* rows,
                                            int ld, int c0, int g, int t) {
  const int c = c0 + 2 * t;
  a[0] = ld_u32(rows + g * ld + c);
  a[1] = ld_u32(rows + (g + 8) * ld + c);
  a[2] = ld_u32(rows + g * ld + c + 8);
  a[3] = ld_u32(rows + (g + 8) * ld + c + 8);
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

// Rows [r0, r0 + 64) of a (rows, d) bf16 matrix into a (64, dp + 8) bf16
// tile, by kThreads threads; columns d..dp and rows at or past n_rows are
// zero.
template <int kThreads>
__device__ __forceinline__ void load_tile_bf16(const __nv_bfloat16* src,
                                               int r0, int n_rows, int d,
                                               int dp, __nv_bfloat16* dst) {
  const int chunks = dp / 8, ld = dp + 8;
  for (int e = threadIdx.x; e < kTile * chunks; e += kThreads) {
    const int r = e / chunks, c = (e - r * chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows && c < d)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * d + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// head_dim padded to the mma's k-step of 16
__host__ __device__ __forceinline__ int padded_d(int d) {
  return (d + 15) / 16 * 16;
}

}  // namespace flash
