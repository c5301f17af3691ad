// Shared pieces of the node-tile kernels: the node tile's shape, the
// sigmoid every cell rounds alike, a shared-memory address, and the depths
// of the paged engines' ring (cluster_common.cuh and the cluster engines,
// cell_tile.cuh, stacked_step.cu, fused_rnn.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace engine {

constexpr int kTileRows = 32;
// k-major tile A_s[c * kTileStride + r]: +4 keeps float4 alignment and
// spreads a column's rows over more banks on the transposing store.
constexpr int kTileStride = kTileRows + 4;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The shared-memory address of `p` (a pointer into shared memory).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------ the paging ring ----
// The paged stream engines read their t-1 state through a ring of `depth`
// slots in shared memory (depth 1, 2 or 4; cluster_common.cuh); kMaxDepth
// mbarriers are reserved.
constexpr int kMaxDepth = 4;
constexpr int kRingBarBytes = kMaxDepth * 8;

}  // namespace engine
