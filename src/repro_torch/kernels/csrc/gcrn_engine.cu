// GCRN-M2 (GC-LSTM) stream engine for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/stream_fused.py, _stream_engine_kernel with
// the gcrn cell (_gcrn_cell, launch assembly _gcrn_build), reached through
// stream_call("gcrn", ...).
//
// What it computes, per stream b and step t (the plain version is
// repro_torch/kernels/ref.py gcrn_stream_batched_ref):
//   h_rows = h_store[row] * mask, c_rows = c_store[row] * mask
//   agg_x  = sum_k coef * (x[idx] + emsg[eidx])     (ELL, local ids)
//   agg_h  = sum_k coef * h_rows[idx]
//   gates  = agg_x @ Wx + agg_h @ Wh + b            -> i | f | g | o
//   c' = (sig(f) c_rows + sig(i) tanh(g)) mask,  h' = sig(o) tanh(c') mask
//   out[b, t] = h';  h_store[row] = h', c_store[row] = c'  (row == G drops)
//
// Design. One CTA per stream runs the whole T loop: the recurrence is
// sequential in t, so one persistent launch replaces T launches. The
// (G, H) stores are 1.8 MB each at full width (G = 3468, H = 128) and
// cannot sit in one CTA's shared memory; they stay in global memory (the
// output buffers, seeded with h0 / c0 by the wrapper) and live in the 50 MB
// L2. Each step gathers its own rows into per-stream scratch first, and
// only then, after a barrier, runs the node tiles and scatters: every read
// of the t-1 state is done before any row of step t is written, so the
// TPU engine's whole-store ping-pong copy (1.8 MB a step) is not needed.
// Per node tile the ELL aggregates go to shared memory k-major, and the
// gate product runs as a register micro-tile of 8 rows x 4 gates per
// thread with the LSTM update fused behind it; the gate tensor never
// leaves registers.
//
// Paged variant (hbm_paged residency, gcrn_engine_paged_launch): the same
// kernel compiled with kPaged. The tile pass reads no t-1 state from global
// memory itself: the step's gathered h rows (the neighbours of agg_h) and
// the tile's own c rows come through the paging ring (engine_common.cuh)
// in td-wide column windows, and the agg tile's h columns and a k-major c
// tile are filled window by window with the resident kernel's arithmetic.
// A slot is the window of all n gathered h rows plus the tile's kTileRows
// c rows, (n + kTileRows) x td floats: the store's (G, td) window of the
// TPU engine (3468 x 16 x 4 B = 222 KB at full width) would not fit twice
// in 227 KB, and a step reads only its own n rows. The ring stages from
// the gathered rows, never from the stores that the step's scatter writes,
// so the t-1 / t order is the resident kernel's. Outputs and final stores
// are bit-identical to the resident kernel's.
//
// What bounds it. The stream's work is serial in t and this kernel gives
// a stream one SM: with B streams only B of the 132 SMs work, so the
// kernel is bound by one SM's fp32 FMA rate on the gate product
// (2 n (din + H) 4H flops a step), far from the card's roofline, which is
// set by the bytes of the per-step inputs. Spreading one stream over a
// thread-block cluster is the next step (ROADMAP.md). The paged variant
// adds the ring's copies: (n + kTileRows) H floats a live tile.
#include "engine_common.cuh"

using namespace engine;

namespace {

struct GcrnArgs {
  const int* idx;     // (B, T, n, k) local neighbour ids
  const float* coef;  // (B, T, n, k)
  const int* eidx;    // (B, T, n, k) edge ids into emsg
  const float* x;     // (B, T, n, din)
  const int* rowg;    // (B, T, n) global row, G on padding rows (drop)
  const float* mask;  // (B, T, n)
  const float* wx;    // (din, 4H)
  const float* wh;    // (H, 4H)
  const float* bias;  // (4H)
  const float* emsg;  // (B, T, e, din), or null
  float* out;         // (B, T, n, H) per-step h
  float* h_store;     // (B, G, H), h0 on entry, final h on exit
  float* c_store;     // (B, G, H), c0 on entry, final c on exit
  float* h_rows;      // (B, n, H) scratch: t-1 h of this step's rows
  float* c_rows;      // (B, n, H) scratch: this step's c rows
  int T, n, k, din, H, G, e;
  int td, depth;      // paged: ring window width and depth
};

template <bool kPaged>
__global__ void __launch_bounds__(kThreads) gcrn_engine_kernel(GcrnArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, n = a.n, k = a.k, din = a.din;
  const int K = din + H, H4 = H / 4;
  float* tile = smem;  // (K, kTileStride) k-major [agg_x | agg_h]
  int* s_idx = reinterpret_cast<int*>(tile + K * kTileStride);
  float* s_coef = reinterpret_cast<float*>(s_idx + kTileRows * k);
  int* s_eidx = reinterpret_cast<int*>(s_coef + kTileRows * k);
  // paged: the tile's own t-1 c rows (k-major), then the ring
  float* ct = reinterpret_cast<float*>(s_eidx + kTileRows * k);
  Ring ring{};
  if constexpr (kPaged) {
    float* slots = ct + H * kTileStride;
    const int slot_floats = (n + kTileRows) * a.td;
    ring = ring_make(slots, reinterpret_cast<uint64_t*>(
                                slots + (size_t)a.depth * slot_floats),
                     a.depth, a.td, slot_floats);
  }

  const int b = blockIdx.x;
  float* h_store = a.h_store + (size_t)b * a.G * H;
  float* c_store = a.c_store + (size_t)b * a.G * H;
  float* h_rows = a.h_rows + (size_t)b * n * H;
  float* c_rows = a.c_rows + (size_t)b * n * H;

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

    // 1. gather this step's t-1 rows out of the stores (float4: H % 4 == 0)
    for (int p = threadIdx.x; p < n * H4; p += kThreads) {
      const int v = p / H4, j = p - v * H4;
      const int g = rowg[v];
      float4 hv = make_float4(0.0f, 0.0f, 0.0f, 0.0f), cv = hv;
      if (g >= 0 && g < a.G) {
        const float m = mask[v];
        hv = reinterpret_cast<const float4*>(h_store + (size_t)g * H)[j];
        cv = reinterpret_cast<const float4*>(c_store + (size_t)g * H)[j];
        hv.x *= m; hv.y *= m; hv.z *= m; hv.w *= m;
        cv.x *= m; cv.y *= m; cv.z *= m; cv.w *= m;
      }
      reinterpret_cast<float4*>(h_rows)[p] = hv;
      reinterpret_cast<float4*>(c_rows)[p] = cv;
    }
    if constexpr (kPaged) ring_publish();
    __syncthreads();

    // 2. node tiles: aggregate, gate product, LSTM update
    for (int r0 = 0; r0 < n; r0 += kTileRows) {
      if (!tile_is_live(mask, r0, n)) {  // all-padding tile: h' = c' = 0
        const int rows = min(kTileRows, n - r0);
        for (int p = threadIdx.x; p < rows * H; p += kThreads) {
          out[(size_t)r0 * H + p] = 0.0f;
          c_rows[(size_t)r0 * H + p] = 0.0f;
        }
        continue;
      }
      load_ell_tile(idx, coef, eidx, r0, n, k, s_idx, s_coef,
                    emsg != nullptr ? s_eidx : nullptr);
      __syncthreads();
      aggregate_tile(x, emsg, din, s_idx, s_coef, s_eidx, k, tile, 0);
      if constexpr (kPaged) {
        // agg_h and the own c rows, window by window through the ring
        const int rows = min(kTileRows, n - r0);
        const int td = a.td;
        ring_sweep(ring, H, RowBlock{h_rows, H, n},
                   RowBlock{c_rows + (size_t)r0 * H, H, rows},
                   [&](int c0, int width, const float* slot) {
                     aggregate_window(slot, td, width, s_idx, s_coef, k,
                                      tile, din + c0);
                     const float* cw = slot + (size_t)n * td;
                     for (int p = threadIdx.x; p < kTileRows * width;
                          p += kThreads) {
                       const int r = p / width, c = p - r * width;
                       ct[(c0 + c) * kTileStride + r] =
                           r < rows ? cw[r * td + c] : 0.0f;
                     }
                   });
        lstm_tile(tile, din, H, true, a.wx, a.wh, a.bias, ct, r0, 1,
                  kTileStride, mask, r0, n, out, c_rows);
      } else {
        aggregate_tile(h_rows, nullptr, H, s_idx, s_coef, s_eidx, k, tile,
                       din);
        __syncthreads();
        lstm_tile(tile, din, H, true, a.wx, a.wh, a.bias, c_rows, 0, H, 1,
                  mask, r0, n, out, c_rows);
      }
      __syncthreads();
    }

    // 3. scatter the new rows into the stores (row G drops)
    for (int p = threadIdx.x; p < n * H4; p += kThreads) {
      const int v = p / H4, j = p - v * H4;
      const int g = rowg[v];
      if (g >= 0 && g < a.G) {
        reinterpret_cast<float4*>(h_store + (size_t)g * H)[j] =
            reinterpret_cast<const float4*>(out)[p];
        reinterpret_cast<float4*>(c_store + (size_t)g * H)[j] =
            reinterpret_cast<const float4*>(c_rows)[p];
      }
    }
    __syncthreads();
  }
}

template <bool kPaged>
int launch(const GcrnArgs& a, int B, size_t smem, void* stream) {
  if (a.H % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gcrn_engine_kernel<kPaged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gcrn_engine_kernel<kPaged>
      <<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

GcrnArgs make_args(const void* idx, const void* coef, const void* eidx,
                   const void* x, const void* rowg, const void* mask,
                   const void* wx, const void* wh, const void* bias,
                   const void* emsg, void* out, void* h_store, void* c_store,
                   void* h_rows, void* c_rows, int T, int n, int k, int din,
                   int H, int G, int e) {
  GcrnArgs a;
  a.idx = static_cast<const int*>(idx);
  a.coef = static_cast<const float*>(coef);
  a.eidx = static_cast<const int*>(eidx);
  a.x = static_cast<const float*>(x);
  a.rowg = static_cast<const int*>(rowg);
  a.mask = static_cast<const float*>(mask);
  a.wx = static_cast<const float*>(wx);
  a.wh = static_cast<const float*>(wh);
  a.bias = static_cast<const float*>(bias);
  a.emsg = static_cast<const float*>(emsg);
  a.out = static_cast<float*>(out);
  a.h_store = static_cast<float*>(h_store);
  a.c_store = static_cast<float*>(c_store);
  a.h_rows = static_cast<float*>(h_rows);
  a.c_rows = static_cast<float*>(c_rows);
  a.T = T; a.n = n; a.k = k; a.din = din; a.H = H; a.G = G; a.e = e;
  a.td = 0; a.depth = 0;
  return a;
}

}  // namespace

extern "C" {

size_t gcrn_engine_smem_bytes(int k, int din, int H) {
  return sizeof(float) * (size_t)(din + H) * kTileStride +
         (size_t)kTileRows * k * (2 * sizeof(int) + sizeof(float));
}

size_t gcrn_engine_paged_smem_bytes(int k, int din, int H, int n, int td,
                                    int depth) {
  return gcrn_engine_smem_bytes(k, din, H) +
         sizeof(float) * (size_t)H * kTileStride +
         sizeof(float) * (size_t)depth * (n + kTileRows) * td + kRingBarBytes;
}

int gcrn_engine_launch(const void* idx, const void* coef, const void* eidx,
                       const void* x, const void* rowg, const void* mask,
                       const void* wx, const void* wh, const void* bias,
                       const void* emsg, void* out, void* h_store,
                       void* c_store, void* h_rows, void* c_rows, int B, int T,
                       int n, int k, int din, int H, int G, int e,
                       void* stream) {
  const GcrnArgs a = make_args(idx, coef, eidx, x, rowg, mask, wx, wh, bias,
                               emsg, out, h_store, c_store, h_rows, c_rows, T,
                               n, k, din, H, G, e);
  return launch<false>(a, B, gcrn_engine_smem_bytes(k, din, H), stream);
}

int gcrn_engine_paged_launch(const void* idx, const void* coef,
                             const void* eidx, const void* x, const void* rowg,
                             const void* mask, const void* wx, const void* wh,
                             const void* bias, const void* emsg, void* out,
                             void* h_store, void* c_store, void* h_rows,
                             void* c_rows, int B, int T, int n, int k, int din,
                             int H, int G, int e, int td, int depth,
                             void* stream) {
  if (td <= 0 || td % 8 != 0 || depth < 1 || depth > kMaxDepth)
    return (int)cudaErrorInvalidValue;
  GcrnArgs a = make_args(idx, coef, eidx, x, rowg, mask, wx, wh, bias, emsg,
                         out, h_store, c_store, h_rows, c_rows, T, n, k, din,
                         H, G, e);
  a.td = td; a.depth = depth;
  return launch<true>(
      a, B, gcrn_engine_paged_smem_bytes(k, din, H, n, td, depth), stream);
}

const char* gcrn_engine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* gcrn_engine_paged_error_string(int code) {
  return gcrn_engine_error_string(code);
}

}  // extern "C"
