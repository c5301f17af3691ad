// Shared pieces of the stream-engine kernels (gcrn_engine.cu,
// evolve_engine.cu): block shape, the k-major activation tile, and the
// register micro-tile that the gate / GCN products run on.
//
// One CTA runs one stream. Its node rows are walked in tiles of
// kTileRows; inside a tile every thread owns kRowsPerThread rows of one
// output column, so a column of the weight matrix is read once per
// kRowsPerThread rows and the tile's activations are read from shared
// memory as two float4 broadcasts.
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

}  // namespace engine
