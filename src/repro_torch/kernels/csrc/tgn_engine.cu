// TGN (event-driven node memory) stream engine for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/stream_fused.py, _stream_engine_kernel with
// the tgn cell (_tgn_cell, launch assembly _tgn_build), reached through
// stream_call("tgn", ...).
//
// What it computes, per stream b and event batch t (the plain version is
// repro_torch/kernels/engine.py tgn_plain on the same packed inputs, which
// under the event contract is kernels/ref.py tgn_stream_batched_ref):
//   own   = store[rowg] * mask                   (the row's t-1 memory)
//   agg_m = sum_s coef * store[gidx]              (partners' t-1 memory)
//   agg_e = sum_s coef * cos(ts * freq)           (time encoding)
//   inp   = (x @ W_in + agg_m) + agg_e
//   m'    = GRU(inp, own) * mask                  (r | z | n)
//   out[b, t] = m';  store[rowg] = m'             (rowg == G drops)
// coef-0 lanes (ELL padding, ragged dead batches) add nothing; rows of
// all-padding tiles write zeros and nothing to the store.
//
// Design. One CTA per stream runs the whole T loop of event batches: the
// memory recurrence is sequential in t. The (G, H) memory store (1.78 MB
// at G = 3468, H = 128) cannot sit in one CTA's shared memory; it stays in
// global memory (the output buffer, seeded with mem0 by the wrapper) and
// lives in the 50 MB L2. A batch's partners are touched rows of the same
// batch, whose memory the batch rewrites, so every read of the batch (the
// partners' rows by gidx, each row's own by rowg) happens in the node-tile
// pass, which writes only out[b, t]; after a block barrier the new rows
// are scattered from there (the gather-before-scatter scheme of
// gcrn_engine.cu, in place of the TPU engine's ping-pong store copy).
// Per live node tile: the features, the GRU input and the own rows sit in
// shared memory as k-major tiles; x @ W_in and the GRU run as register
// micro-tiles (engine_common.cuh), the aggregates between them. A tile
// without a live lane skips both aggregations (they are exact zeros).
// The timestamps ride the ELL tile's edge-id slot as float bits.
//
// The argument of cos reaches ~137 rad on BC-Alpha (ts up to 136.5,
// freq_0 = 1): the kernel calls cosf with its full range reduction, never
// the __cosf intrinsic, and is built without --use_fast_math.
//
// Paged variant (hbm_paged residency, tgn_engine_paged_launch): the same
// kernel compiled with kPaged. Each batch first gathers its touched rows'
// t-1 memory into per-stream scratch (masked, as the own rows are read),
// then a barrier; the tile pass reads that memory only through the paging
// ring (engine_common.cuh), in td-wide column windows of all n gathered
// rows: a partner by its local id (it is a touched row of the same batch),
// the own row by its own. The partner aggregate is added into the GRU
// input window by window ((x @ W_in + agg_m) + agg_e, the resident order),
// so no separate aggregate tile is kept and four n x td slots fit beside
// the tile at full width (218,400 B at n 640, td 16, depth 4). Outputs
// and the final store are bit-identical to the resident kernel's under
// the event contract (every live lane names a touched row).
//
// What bounds it. One SM per stream, serial in t: bound by that SM's fp32
// FMA rate on 2 rows (din H + 2 H 3H) flops a batch, far from the card's
// roofline, which the per-batch bytes set. Spreading a stream over a
// thread-block cluster is the next step (ROADMAP.md). The paged variant
// adds the gather and the ring's copies: n H floats a live tile.
#include "engine_common.cuh"

using namespace engine;

namespace {

struct TgnArgs {
  const int* gidx;    // (B, T, n, k) each lane's partner: its global row
                      // (resident), its local id (paged)
  const float* coef;  // (B, T, n, k) lane weight (1/deg), 0 on padding
  const float* ts;    // (B, T, n, k) event time of each lane
  const float* x;     // (B, T, n, din)
  const int* rowg;    // (B, T, n) global row, G on padding rows (drop)
  const float* mask;  // (B, T, n)
  const float* freq;  // (H) time-encoding frequencies
  const float* w_in;  // (din, H)
  const float* wx;    // (H, 3H)
  const float* wh;    // (H, 3H)
  const float* bias;  // (3H)
  float* out;         // (B, T, n, H) per-batch memory
  float* store;       // (B, G, H), mem0 on entry, final memory on exit
  float* rows;        // paged: (B, n, H) scratch, the batch's t-1 rows
  int T, n, k, din, H, G;
  int td, depth;      // paged: ring window width and depth
};

// inp = (inp + am) + sum_s coef * cos(ts * freq) over the tile (am null:
// the partner aggregate is already in inp), the cell's order.
__device__ __forceinline__ void encode_tile(float* inp, const float* am,
                                            const int* s_ts,
                                            const float* s_coef, int k,
                                            const float* freq, int H) {
  for (int p = threadIdx.x; p < kTileRows * H; p += kThreads) {
    const int r = p / H, c = p - r * H;
    const int* lt = s_ts + r * k;
    const float* lc = s_coef + r * k;
    const float f = freq[c];
    float acc = 0.0f;
    for (int s = 0; s < k; ++s) {
      if (lc[s] == 0.0f) continue;  // coef-0 lanes add exact zeros
      acc = __fmaf_rn(lc[s], cosf(__fmul_rn(__int_as_float(lt[s]), f)), acc);
    }
    const int o = c * kTileStride + r;
    const float base = am != nullptr ? __fadd_rn(inp[o], am[o]) : inp[o];
    inp[o] = __fadd_rn(base, acc);
  }
}

template <bool kPaged>
__global__ void __launch_bounds__(kThreads) tgn_engine_kernel(TgnArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, n = a.n, k = a.k, din = a.din, G = a.G;
  const int H4 = H / 4;
  float* xt = smem;                      // (din, kTileStride) features
  float* inp = xt + din * kTileStride;   // (H, kTileStride) GRU input
  // resident: (H, kTileStride) partner memory; paged: none (the partner
  // aggregate goes straight into inp). Keep am before own: the other
  // order gets the resident kernel fewer registers and more time on the
  // H100 (PERF.md).
  float* am = inp + H * kTileStride;
  float* own = am + (kPaged ? 0 : H * kTileStride);  // (H, kTileStride)
  int* s_gidx = reinterpret_cast<int*>(own + H * kTileStride);
  float* s_coef = reinterpret_cast<float*>(s_gidx + kTileRows * k);
  int* s_ts = reinterpret_cast<int*>(s_coef + kTileRows * k);  // float bits
  Ring ring{};
  if constexpr (kPaged) {
    float* slots = reinterpret_cast<float*>(s_ts + kTileRows * k);
    const int slot_floats = n * a.td;
    ring = ring_make(slots, reinterpret_cast<uint64_t*>(
                                slots + (size_t)a.depth * slot_floats),
                     a.depth, a.td, slot_floats);
  }

  const int b = blockIdx.x;
  float* store = a.store + (size_t)b * G * H;
  float* rows_t1 = kPaged ? a.rows + (size_t)b * n * H : nullptr;

  for (int t = 0; t < a.T; ++t) {
    const size_t bt = (size_t)b * a.T + t;
    const int* gidx = a.gidx + bt * n * k;
    const float* coef = a.coef + bt * n * k;
    const int* ts = reinterpret_cast<const int*>(a.ts + bt * n * k);
    const float* x = a.x + bt * n * din;
    const int* rowg = a.rowg + bt * n;
    const float* mask = a.mask + bt * n;
    float* out = a.out + bt * n * H;

    if constexpr (kPaged) {
      // 0. gather the batch's t-1 rows (float4: H % 4 == 0), masked
      for (int p = threadIdx.x; p < n * H4; p += kThreads) {
        const int v = p / H4, j = p - v * H4;
        const int g = rowg[v];
        float4 hv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (g >= 0 && g < G) {
          const float m = mask[v];
          hv = reinterpret_cast<const float4*>(store + (size_t)g * H)[j];
          hv.x *= m; hv.y *= m; hv.z *= m; hv.w *= m;
        }
        reinterpret_cast<float4*>(rows_t1)[p] = hv;
      }
      ring_publish();
      __syncthreads();
    }

    // 1. node tiles: every read of the t-1 store, no write to it
    for (int r0 = 0; r0 < n; r0 += kTileRows) {
      if (!tile_is_live(mask, r0, n)) {  // all-padding tile: m' = 0
        const int rows = min(kTileRows, n - r0);
        for (int p = threadIdx.x; p < rows * H; p += kThreads)
          out[(size_t)r0 * H + p] = 0.0f;
        continue;
      }
      load_ell_tile(gidx, coef, ts, r0, n, k, s_gidx, s_coef, s_ts);
      load_tile(x, din, r0, n, xt);
      if constexpr (!kPaged) {
        for (int p = threadIdx.x; p < kTileRows * H; p += kThreads) {
          const int r = p / H, c = p - r * H;
          const int v = r0 + r;
          const int g = v < n ? rowg[v] : G;
          own[c * kTileStride + r] =
              g < G ? store[(size_t)g * H + c] * mask[v] : 0.0f;
        }
      }
      __syncthreads();
      const bool lanes = tile_has_lanes(s_coef, k);  // block-uniform
      linear_tile(xt, din, a.w_in, nullptr, H, inp);
      if constexpr (kPaged) {
        __syncthreads();  // inp = x @ W_in before the windows add to it
        // own rows and the partner aggregate, window by window
        const int rows = min(kTileRows, n - r0);
        const int td = a.td;
        ring_sweep(ring, H, RowBlock{rows_t1, H, n}, RowBlock{nullptr, 0, 0},
                   [&](int c0, int width, const float* slot) {
                     for (int p = threadIdx.x; p < kTileRows * width;
                          p += kThreads) {
                       const int r = p / width, c = p - r * width;
                       const int o = (c0 + c) * kTileStride + r;
                       own[o] = r < rows ? slot[(size_t)(r0 + r) * td + c]
                                         : 0.0f;
                       if (lanes)
                         inp[o] = __fadd_rn(
                             inp[o], ell_sum(slot, td, nullptr, 0,
                                             s_gidx + r * k, s_coef + r * k,
                                             nullptr, k, c));
                     }
                   });
        if (lanes) {
          encode_tile(inp, nullptr, s_ts, s_coef, k, a.freq, H);
          __syncthreads();
        }
      } else {
        if (lanes)
          aggregate_tile(store, nullptr, H, s_gidx, s_coef, nullptr, k, am, 0);
        __syncthreads();
        if (lanes) {
          encode_tile(inp, am, s_ts, s_coef, k, a.freq, H);
          __syncthreads();
        }
      }
      gru_tile(inp, H, own, H, a.wx, a.wh, a.bias, mask, r0, n, out);
      __syncthreads();
    }
    __syncthreads();

    // 2. every read of the batch is done: scatter the new rows (G drops)
    for (int p = threadIdx.x; p < n * H4; p += kThreads) {
      const int v = p / H4, j = p - v * H4;
      const int g = rowg[v];
      if (g >= 0 && g < G)
        reinterpret_cast<float4*>(store + (size_t)g * H)[j] =
            reinterpret_cast<const float4*>(out)[p];
    }
    __syncthreads();
  }
}

template <bool kPaged>
int launch(const TgnArgs& a, int B, size_t smem, void* stream) {
  if (a.H % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tgn_engine_kernel<kPaged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  tgn_engine_kernel<kPaged>
      <<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

TgnArgs make_args(const void* gidx, const void* coef, const void* ts,
                  const void* x, const void* rowg, const void* mask,
                  const void* freq, const void* w_in, const void* wx,
                  const void* wh, const void* bias, void* out, void* store,
                  int T, int n, int k, int din, int H, int G) {
  TgnArgs a;
  a.gidx = static_cast<const int*>(gidx);
  a.coef = static_cast<const float*>(coef);
  a.ts = static_cast<const float*>(ts);
  a.x = static_cast<const float*>(x);
  a.rowg = static_cast<const int*>(rowg);
  a.mask = static_cast<const float*>(mask);
  a.freq = static_cast<const float*>(freq);
  a.w_in = static_cast<const float*>(w_in);
  a.wx = static_cast<const float*>(wx);
  a.wh = static_cast<const float*>(wh);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.store = static_cast<float*>(store);
  a.rows = nullptr;
  a.T = T; a.n = n; a.k = k; a.din = din; a.H = H; a.G = G;
  a.td = 0; a.depth = 0;
  return a;
}

}  // namespace

extern "C" {

size_t tgn_engine_smem_bytes(int k, int din, int H) {
  return sizeof(float) * (size_t)(din + 3 * H) * kTileStride +
         (size_t)kTileRows * k * (2 * sizeof(int) + sizeof(float));
}

size_t tgn_engine_paged_smem_bytes(int k, int din, int H, int n, int td,
                                   int depth) {
  return sizeof(float) * (size_t)(din + 2 * H) * kTileStride +
         (size_t)kTileRows * k * (2 * sizeof(int) + sizeof(float)) +
         sizeof(float) * (size_t)depth * n * td + kRingBarBytes;
}

int tgn_engine_launch(const void* gidx, const void* coef, const void* ts,
                      const void* x, const void* rowg, const void* mask,
                      const void* freq, const void* w_in, const void* wx,
                      const void* wh, const void* bias, void* out,
                      void* store, int B, int T, int n, int k, int din, int H,
                      int G, void* stream) {
  const TgnArgs a = make_args(gidx, coef, ts, x, rowg, mask, freq, w_in, wx,
                              wh, bias, out, store, T, n, k, din, H, G);
  return launch<false>(a, B, tgn_engine_smem_bytes(k, din, H), stream);
}

int tgn_engine_paged_launch(const void* idx, const void* coef, const void* ts,
                            const void* x, const void* rowg, const void* mask,
                            const void* freq, const void* w_in,
                            const void* wx, const void* wh, const void* bias,
                            void* out, void* store, void* rows, int B, int T,
                            int n, int k, int din, int H, int G, int td,
                            int depth, void* stream) {
  if (td <= 0 || td % 8 != 0 || depth < 1 || depth > kMaxDepth)
    return (int)cudaErrorInvalidValue;
  TgnArgs a = make_args(idx, coef, ts, x, rowg, mask, freq, w_in, wx, wh,
                        bias, out, store, T, n, k, din, H, G);
  a.rows = static_cast<float*>(rows);
  a.td = td; a.depth = depth;
  return launch<true>(
      a, B, tgn_engine_paged_smem_bytes(k, din, H, n, td, depth), stream);
}

const char* tgn_engine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* tgn_engine_paged_error_string(int code) {
  return tgn_engine_error_string(code);
}

}  // extern "C"
