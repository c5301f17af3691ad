// EvolveGCN-O's per-layer edge terms, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes these terms with XLA ops
// (src/repro/core/evolvegcn.py, EvolveGCN._edge_aggs: the edge features
// projected, gathered and summed). The port computed them with ~95 torch
// ops over a (..., n, k, De) gather (4 GB at the benchmark's batch of 16
// histories); those ops stay as the plain version and as the CPU and
// force_ref path (repro_torch/kernels/ref.py evolve_edge_terms).
//
// What it computes, for every snapshot s, row v < n_nodes[s], layer l and
// column c < din_l:
//   agg[d]          = sum_j coef[s, v, j] * feat[s, eidx[s, v, j], d]
//   out[s, l, v, c] = sum_d agg[d] * w_l[d, c]
// and zeros in every other entry of the (S, L, n, D) output: the columns
// past a layer's width (the square layout the evolve engine reads) and the
// rows at or past n_nodes[s]. Each product and each sum is rounded on its
// own (__fmul_rn / __fadd_rn, so nvcc's default -fmad=true fuses none),
// lanes summed in order j = 0, 1, ..., k - 1 and features d = 0, 1, ...,
// De - 1: the torch ops' bits. A row's result reads nothing but its own
// lanes, so it has the same bits whatever the launch's B and T.
//
// Design: a CTA of 256 threads takes kRows rows of one snapshot.
// - A block at or past the snapshot's n_nodes writes its zeros and reads
//   nothing.
// - Otherwise the block's live rows' eidx and coef (contiguous in memory)
//   are staged in shared memory with coalesced loads, each row kStride
//   words apart (k rounded up to odd, so the 4 rows a warp reads at once
//   fall in distinct banks), and every layer's w_l, zero-padded to D.
// - One thread a (row, edge feature) sums the row's lanes in a register;
//   the snapshot's edge-feature table (e_pad x De floats, 128 KB at the
//   benchmark's bucket) is read through L1 and L2.
// - Then a warp a row, its lanes on float4 columns: De products and sums
//   of the row's aggregate (a shared-memory broadcast) by a float4 of w_l,
//   written coalesced (a warp stores a 512-byte row at D 128).
//
// What bounds it. Bytes: the output is S x L x n x D floats, zeros
// included (2.0 GB at the benchmark's b16 shape: 3,072 snapshots of 640
// rows, L 2, D 128), and the live rows' lanes are read once (8 bytes a
// lane). The arithmetic, 2 k De + 2 De din_l flops a live row and layer,
// is far below the card's rate.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;     // rows a CTA
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 32;  // layers a launch takes

// each layer's edge projection (De, din_l), and din_l
struct Layers {
  const float* w[kMaxLayers];
  int din[kMaxLayers];
};

struct Args {
  const int* eidx;      // (S, n, k) edge ids into the snapshot's table
  const float* coef;    // (S, n, k)
  const float* feat;    // (S, E, De) edge features
  const int* n_nodes;   // (S,) live rows of each snapshot
  float* out;           // (S, L, n, D)
  int n, k, E, De, L, D;
  int blocks;           // row blocks a snapshot
};

// words between two staged rows' lanes: odd
__host__ __device__ inline int lane_stride(int k) { return k | 1; }

size_t smem_floats(int k, int De, int L, int D) {
  return (size_t)L * De * D + (size_t)2 * kRows * lane_stride(k) +
         (size_t)kRows * De;
}

__global__ void __launch_bounds__(kThreads)
edge_terms_kernel(const Args a, const Layers ly) {
  extern __shared__ float4 smem_raw[];
  float* s_w = reinterpret_cast<float*>(smem_raw);          // (L, De, D)
  int* s_eidx = reinterpret_cast<int*>(s_w + (size_t)a.L * a.De * a.D);
  const int ks = lane_stride(a.k);
  float* s_coef = reinterpret_cast<float*>(s_eidx + kRows * ks);
  float* s_agg = s_coef + kRows * ks;                        // (kRows, De)

  const int s = blockIdx.x / a.blocks;
  const int r0 = (blockIdx.x - s * a.blocks) * kRows;
  const int nr = min(kRows, a.n - r0);  // the block's rows
  const int rows = max(0, min(nr, min(a.n_nodes[s], a.n) - r0));  // live
  const int tid = threadIdx.x;

  if (rows > 0) {  // block-uniform
    const size_t base = ((size_t)s * a.n + r0) * a.k;
    for (int i = tid; i < rows * a.k; i += kThreads) {
      const int v = i / a.k, j = i - v * a.k;
      const int e = __ldg(a.eidx + base + i);
      // an id outside the table: a fault, as torch's gather asserts
      if ((unsigned)e >= (unsigned)a.E) __trap();
      s_eidx[v * ks + j] = e;
      s_coef[v * ks + j] = __ldg(a.coef + base + i);
    }
    const int wsz = a.De * a.D;
    for (int i = tid; i < a.L * wsz; i += kThreads) {
      const int l = i / wsz, r = i - l * wsz, d = r / a.D, c = r - d * a.D;
      const int din = ly.din[l];
      s_w[i] = c < din ? __ldg(ly.w[l] + (size_t)d * din + c) : 0.0f;
    }
    __syncthreads();
    const float* tab = a.feat + (size_t)s * a.E * a.De;
    for (int i = tid; i < rows * a.De; i += kThreads) {
      const int v = i / a.De, d = i - v * a.De;
      const int* ei = s_eidx + v * ks;
      const float* cf = s_coef + v * ks;
      const float* col = tab + d;
      float acc = __fmul_rn(__ldg(col + (size_t)ei[0] * a.De), cf[0]);
#pragma unroll 8
      for (int j = 1; j < a.k; ++j)
        acc = __fadd_rn(acc,
                        __fmul_rn(__ldg(col + (size_t)ei[j] * a.De), cf[j]));
      s_agg[v * a.De + d] = acc;
    }
    __syncthreads();
  }

  const int warp = tid / 32, lane = tid % 32, D4 = a.D / 4;
  for (int l = 0; l < a.L; ++l) {
    const int din = ly.din[l];
    const float4* wl = reinterpret_cast<const float4*>(s_w) +
                       (size_t)l * a.De * D4;
    for (int v = warp; v < nr; v += kWarps) {
      float4* dst = reinterpret_cast<float4*>(
          a.out + (((size_t)s * a.L + l) * a.n + r0 + v) * a.D);
      const float* ag = s_agg + v * a.De;
      for (int q = lane; q < D4; q += 32) {
        float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (v < rows && 4 * q < din) {
          float g = ag[0];
          float4 w = wl[q];
          o = make_float4(__fmul_rn(g, w.x), __fmul_rn(g, w.y),
                          __fmul_rn(g, w.z), __fmul_rn(g, w.w));
          for (int d = 1; d < a.De; ++d) {
            g = ag[d];
            w = wl[(size_t)d * D4 + q];
            o.x = __fadd_rn(o.x, __fmul_rn(g, w.x));
            o.y = __fadd_rn(o.y, __fmul_rn(g, w.y));
            o.z = __fadd_rn(o.z, __fmul_rn(g, w.z));
            o.w = __fadd_rn(o.w, __fmul_rn(g, w.w));
          }
          // a float4 across din_l: its columns past din_l are zeros
          if (4 * q + 1 >= din) o.y = 0.0f;
          if (4 * q + 2 >= din) o.z = 0.0f;
          if (4 * q + 3 >= din) o.w = 0.0f;
        }
        dst[q] = o;
      }
    }
  }
}

}  // namespace

extern "C" {

size_t edge_terms_smem_bytes(int k, int De, int L, int D) {
  return sizeof(float) * smem_floats(k, De, L, D);
}

// w: L device pointers, widths: L ints (host memory)
int edge_terms_launch(const void* eidx, const void* coef, const void* feat,
                      const void* n_nodes, const void* w,
                      const void* widths, void* out, int S, int n, int k,
                      int E, int De, int L, int D, void* stream) {
  if (S <= 0 || n <= 0) return 0;
  if (k < 1 || E < 1 || De < 1 || L < 1 || L > kMaxLayers || D < 4 ||
      D % 4 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.eidx = static_cast<const int*>(eidx);
  a.coef = static_cast<const float*>(coef);
  a.feat = static_cast<const float*>(feat);
  a.n_nodes = static_cast<const int*>(n_nodes);
  a.out = static_cast<float*>(out);
  a.n = n; a.k = k; a.E = E; a.De = De; a.L = L; a.D = D;
  a.blocks = (n + kRows - 1) / kRows;
  Layers ly{};
  const float* const* ws = static_cast<const float* const*>(w);
  const int* din = static_cast<const int*>(widths);
  for (int l = 0; l < L; ++l) {
    if (din[l] < 1 || din[l] > D) return (int)cudaErrorInvalidValue;
    ly.w[l] = ws[l];
    ly.din[l] = din[l];
  }
  const long long grid = (long long)S * a.blocks;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = edge_terms_smem_bytes(k, De, L, D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edge_terms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  edge_terms_kernel<<<(unsigned)grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(a, ly);
  return (int)cudaGetLastError();
}

const char* edge_terms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
