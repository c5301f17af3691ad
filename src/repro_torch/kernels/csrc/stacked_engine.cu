// Stacked DGNN (GCN -> GRU) stream engine for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/stream_fused.py, _stream_engine_kernel with
// the stacked cell (_stacked_cell, launch assembly _stacked_build), reached
// through stream_call("stacked", ...).
//
// What it computes, per stream b and step t (the plain version is
// repro_torch/kernels/ref.py stacked_stream_batched_ref): the last GCN
// layer and the GRU over the node-state store,
//   h_rows = h_store[row] * mask
//   agg    = sum_k coef * (x[idx] + emsg[eidx])      (ELL, local ids)
//   nt     = agg @ Wg + bg                            (linear)
//   h'     = GRU(nt, h_rows) * mask                   (own row, r | z | n)
//   out[b, t] = h';  h_store[row] = h'                (row == G drops)
// The GCN layers before the last are time-independent and run before the
// launch (core/stacked.py).
//
// Design. As gcrn_engine.cu: one CTA per stream runs the whole T loop; the
// (G, H) store stays in global memory (the output buffer, seeded with h0 by
// the wrapper; L2-resident). Each step first gathers its own t-1 rows into
// per-stream scratch, and only after a barrier runs the node tiles and
// scatters, so every read of the t-1 state precedes any write of step t and
// no second store plane is needed. Per node tile the aggregate, nt and the
// tile's h rows sit in shared memory as k-major tiles, and the NT product
// and the GRU run as register micro-tiles (engine_common.cuh). All-padding
// tiles (no nonzero mask) write zeros and skip their arithmetic.
//
// Paged variant (hbm_paged residency, stacked_engine_paged_launch): the
// same kernel compiled with kPaged. The only t-1 state a tile reads is its
// own rows' h; it comes through the paging ring (engine_common.cuh) in
// td-wide column windows of the tile's kTileRows gathered rows, filling
// the k-major h tile window by window. Outputs and the final store are
// bit-identical to the resident kernel's.
//
// What bounds it. One SM per stream, serial in t: bound by that SM's fp32
// FMA rate on 2 rows (din dmid + dmid 3H + H 3H) flops a step, far from the
// card's roofline, which the per-step bytes set.
#include "engine_common.cuh"

using namespace engine;

namespace {

struct StackedArgs {
  const int* idx;     // (B, T, n, k) local neighbour ids
  const float* coef;  // (B, T, n, k)
  const int* eidx;    // (B, T, n, k) edge ids into emsg
  const float* x;     // (B, T, n, din) input of the last GCN layer
  const int* rowg;    // (B, T, n) global row, G on padding rows (drop)
  const float* mask;  // (B, T, n)
  const float* wg;    // (din, dmid)
  const float* bg;    // (dmid)
  const float* wx;    // (dmid, 3H)
  const float* wh;    // (H, 3H)
  const float* bias;  // (3H)
  const float* emsg;  // (B, T, e, din), or null
  float* out;         // (B, T, n, H) per-step h
  float* h_store;     // (B, G, H), h0 on entry, final h on exit
  float* h_rows;      // (B, n, H) scratch: t-1 h of this step's rows
  int T, n, k, din, dmid, H, G, e;
  int td, depth;      // paged: ring window width and depth
};

template <bool kPaged>
__global__ void __launch_bounds__(kThreads) stacked_engine_kernel(StackedArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, n = a.n, k = a.k, din = a.din, dmid = a.dmid;
  const int H4 = H / 4;
  float* agg = smem;                         // (din, kTileStride)
  float* nt = agg + din * kTileStride;       // (dmid, kTileStride)
  float* ht = nt + dmid * kTileStride;       // (H, kTileStride)
  int* s_idx = reinterpret_cast<int*>(ht + H * kTileStride);
  float* s_coef = reinterpret_cast<float*>(s_idx + kTileRows * k);
  int* s_eidx = reinterpret_cast<int*>(s_coef + kTileRows * k);
  Ring ring{};
  if constexpr (kPaged) {
    float* slots = reinterpret_cast<float*>(s_eidx + kTileRows * k);
    const int slot_floats = kTileRows * a.td;
    ring = ring_make(slots, reinterpret_cast<uint64_t*>(
                                slots + (size_t)a.depth * slot_floats),
                     a.depth, a.td, slot_floats);
  }

  const int b = blockIdx.x;
  float* h_store = a.h_store + (size_t)b * a.G * H;
  float* h_rows = a.h_rows + (size_t)b * n * H;

  for (int t = 0; t < a.T; ++t) {
    const size_t bt = (size_t)b * a.T + t;
    const int* rowg = a.rowg + bt * n;
    const float* mask = a.mask + bt * n;
    const int* idx = a.idx + bt * n * k;
    const float* coef = a.coef + bt * n * k;
    const int* eidx = a.eidx + bt * n * k;
    const float* x = a.x + bt * n * din;
    const float* emsg = a.emsg != nullptr ? a.emsg + bt * a.e * din : nullptr;
    float* out = a.out + bt * n * H;

    // 1. gather this step's t-1 rows out of the store (float4: H % 4 == 0)
    for (int p = threadIdx.x; p < n * H4; p += kThreads) {
      const int v = p / H4, j = p - v * H4;
      const int g = rowg[v];
      float4 hv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (g >= 0 && g < a.G) {
        const float m = mask[v];
        hv = reinterpret_cast<const float4*>(h_store + (size_t)g * H)[j];
        hv.x *= m; hv.y *= m; hv.z *= m; hv.w *= m;
      }
      reinterpret_cast<float4*>(h_rows)[p] = hv;
    }
    if constexpr (kPaged) ring_publish();
    __syncthreads();

    // 2. node tiles: aggregate, node transform, GRU against the own row
    for (int r0 = 0; r0 < n; r0 += kTileRows) {
      if (!tile_is_live(mask, r0, n)) {  // all-padding tile: h' = 0
        const int rows = min(kTileRows, n - r0);
        for (int p = threadIdx.x; p < rows * H; p += kThreads)
          out[(size_t)r0 * H + p] = 0.0f;
        continue;
      }
      load_ell_tile(idx, coef, eidx, r0, n, k, s_idx, s_coef,
                    emsg != nullptr ? s_eidx : nullptr);
      if constexpr (kPaged) {
        // the own rows' t-1 h, window by window through the ring
        const int rows = min(kTileRows, n - r0);
        const int td = a.td;
        ring_sweep(ring, H, RowBlock{h_rows + (size_t)r0 * H, H, rows},
                   RowBlock{nullptr, 0, 0},
                   [&](int c0, int width, const float* slot) {
                     for (int p = threadIdx.x; p < kTileRows * width;
                          p += kThreads) {
                       const int r = p / width, c = p - r * width;
                       ht[(c0 + c) * kTileStride + r] =
                           r < rows ? slot[r * td + c] : 0.0f;
                     }
                   });
      } else {
        load_tile(h_rows, H, r0, n, ht);
        __syncthreads();
      }
      aggregate_tile(x, emsg, din, s_idx, s_coef, s_eidx, k, agg, 0);
      __syncthreads();
      linear_tile(agg, din, a.wg, a.bg, dmid, nt);
      __syncthreads();
      gru_tile(nt, dmid, ht, H, a.wx, a.wh, a.bias, mask, r0, n, out);
      __syncthreads();
    }

    // 3. scatter the new rows into the store (row G drops)
    for (int p = threadIdx.x; p < n * H4; p += kThreads) {
      const int v = p / H4, j = p - v * H4;
      const int g = rowg[v];
      if (g >= 0 && g < a.G)
        reinterpret_cast<float4*>(h_store + (size_t)g * H)[j] =
            reinterpret_cast<const float4*>(out)[p];
    }
    __syncthreads();
  }
}

template <bool kPaged>
int launch(const StackedArgs& a, int B, size_t smem, void* stream) {
  if (a.H % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stacked_engine_kernel<kPaged>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  stacked_engine_kernel<kPaged>
      <<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

StackedArgs make_args(const void* idx, const void* coef, const void* eidx,
                      const void* x, const void* rowg, const void* mask,
                      const void* wg, const void* bg, const void* wx,
                      const void* wh, const void* bias, const void* emsg,
                      void* out, void* h_store, void* h_rows, int T, int n,
                      int k, int din, int dmid, int H, int G, int e) {
  StackedArgs a;
  a.idx = static_cast<const int*>(idx);
  a.coef = static_cast<const float*>(coef);
  a.eidx = static_cast<const int*>(eidx);
  a.x = static_cast<const float*>(x);
  a.rowg = static_cast<const int*>(rowg);
  a.mask = static_cast<const float*>(mask);
  a.wg = static_cast<const float*>(wg);
  a.bg = static_cast<const float*>(bg);
  a.wx = static_cast<const float*>(wx);
  a.wh = static_cast<const float*>(wh);
  a.bias = static_cast<const float*>(bias);
  a.emsg = static_cast<const float*>(emsg);
  a.out = static_cast<float*>(out);
  a.h_store = static_cast<float*>(h_store);
  a.h_rows = static_cast<float*>(h_rows);
  a.T = T; a.n = n; a.k = k; a.din = din; a.dmid = dmid; a.H = H; a.G = G;
  a.e = e; a.td = 0; a.depth = 0;
  return a;
}

}  // namespace

extern "C" {

size_t stacked_engine_smem_bytes(int k, int din, int dmid, int H) {
  return sizeof(float) * (size_t)(din + dmid + H) * kTileStride +
         (size_t)kTileRows * k * (2 * sizeof(int) + sizeof(float));
}

size_t stacked_engine_paged_smem_bytes(int k, int din, int dmid, int H,
                                       int td, int depth) {
  return stacked_engine_smem_bytes(k, din, dmid, H) +
         sizeof(float) * (size_t)depth * kTileRows * td + kRingBarBytes;
}

int stacked_engine_launch(const void* idx, const void* coef, const void* eidx,
                          const void* x, const void* rowg, const void* mask,
                          const void* wg, const void* bg, const void* wx,
                          const void* wh, const void* bias, const void* emsg,
                          void* out, void* h_store, void* h_rows, int B, int T,
                          int n, int k, int din, int dmid, int H, int G, int e,
                          void* stream) {
  const StackedArgs a = make_args(idx, coef, eidx, x, rowg, mask, wg, bg, wx,
                                  wh, bias, emsg, out, h_store, h_rows, T, n,
                                  k, din, dmid, H, G, e);
  return launch<false>(a, B, stacked_engine_smem_bytes(k, din, dmid, H),
                       stream);
}

int stacked_engine_paged_launch(const void* idx, const void* coef,
                                const void* eidx, const void* x,
                                const void* rowg, const void* mask,
                                const void* wg, const void* bg,
                                const void* wx, const void* wh,
                                const void* bias, const void* emsg, void* out,
                                void* h_store, void* h_rows, int B, int T,
                                int n, int k, int din, int dmid, int H, int G,
                                int e, int td, int depth, void* stream) {
  if (td <= 0 || td % 8 != 0 || depth < 1 || depth > kMaxDepth)
    return (int)cudaErrorInvalidValue;
  StackedArgs a = make_args(idx, coef, eidx, x, rowg, mask, wg, bg, wx, wh,
                            bias, emsg, out, h_store, h_rows, T, n, k, din,
                            dmid, H, G, e);
  a.td = td; a.depth = depth;
  return launch<true>(
      a, B, stacked_engine_paged_smem_bytes(k, din, dmid, H, td, depth),
      stream);
}

const char* stacked_engine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* stacked_engine_paged_error_string(int code) {
  return stacked_engine_error_string(code);
}

}  // extern "C"
