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
// What bounds them. A cell is one product of (Bs, din + H) by
// (din + H, G H), G = 3 or 4, and a few element operations an output: at
// Bs 640, din = H = 128 it is 168 MFLOP (LSTM) on 2.2 MB, so the fp32 FMA
// rate of the CUDA cores sets the bound (2.5 us at 67 TFLOP/s), not the
// bytes. The TPU kernel's grid (one program a tb-row tile, 5 at that
// shape) would leave 127 of the 132 SMs idle.
//
// Design.
// - A 2-D grid: a CTA owns kRows rows and a slice of kUnits hidden units,
//   and all G gates of those units (weight columns g H + j0 .. + kUnits for
//   each g). Each output is written once, by one CTA; no atomics, the same
//   bits on every run. 640 x 128 gives 20 x 16 = 320 CTAs of 128 threads
//   on 132 SMs, all resident at once.
// - The K loop runs over din (x, wx), then over H (h, wh), in chunks of
//   kChunk rows. Each chunk's activations (kRows x kChunk, row-major) and
//   weights (kChunk x G kUnits) are staged in a ring of kStages slots in
//   shared memory by cp.async, kStages - 1 chunks ahead of the one the
//   FMA loop reads (2 slots: the next chunk lands while this one is read);
//   the FMA loop reads only shared memory and registers. Shared memory
//   does not grow with din or H (29 KB GRU, 33 KB LSTM).
// - fp32 FMA on the CUDA cores (TF32 keeps ~3 digits, over the 1e-4 the
//   kernel is held to). The four warps split each chunk's K rows; a thread
//   owns kRowsPerThread rows x kUnitsPerThread units x all gates: 32 sums
//   (the GRU's four a unit are r and z over [x | h] together, nx and nh
//   apart, since n needs r nh), fed by one float4 of activations a row for
//   four K rows and one float2 of weights a gate a K row. The splits'
//   partial sums meet in shared memory and are added in a fixed order.
// - The epilogue (bias, then the splits' sums; sigmoid / tanh, c' and h')
//   runs in registers with the rounding helpers of the engines' cells
//   (engine_common.cuh lstm_tile / gru_tile), and stores row-major.
// - Edges: rows past Bs, K rows past din or H and units past H are staged
//   as zeros (cp.async's zero fill) and never stored. The 16-byte copies
//   need din and H multiples of 4 and 16-byte aligned x, h, wx, wh;
//   otherwise the same kernel stages 4-byte copies.
//
// Where the time goes (PERF.md, the cells' redesign): 4-6x the bound at
// 640 x 128 x 128, the one shape this tile was chosen at (by timing tile
// variants there on the card). At larger shapes (a deeper K, more rows,
// a wider H) torch.gru_cell / lstm_cell, two cuBLAS GEMMs and a pointwise
// kernel, are faster; chip_smoke.py times both at three such shapes.
// Registers (nvcc -Xptxas -v, sm_90a): 96 (LSTM), 80 (GRU); no spills.
#include "engine_common.cuh"

namespace {

constexpr int kRows = 32;           // rows a CTA
constexpr int kUnits = 8;          // hidden units a CTA
constexpr int kChunk = 64;          // K rows a staged chunk
constexpr int kStages = 2;          // ring slots
constexpr int kSplit = 4;           // warps that split a chunk's K rows
constexpr int kRowsPerThread = 4;   // a thread's rows: rg + kRowGroups i
constexpr int kUnitsPerThread = 2;  // a thread's units: ug kUnitsPerThread + v
constexpr int kRowGroups = kRows / kRowsPerThread;
constexpr int kUnitGroups = kUnits / kUnitsPerThread;
constexpr int kGroup = kRowGroups * kUnitGroups;  // threads of one K split
constexpr int kThreads = kGroup * kSplit;
constexpr int kSplitK = kChunk / kSplit;          // a split's K rows a chunk
// floats between two rows of a staged activation chunk: +4 keeps 16-byte
// alignment and puts a warp's kRowGroups consecutive rows on other banks
constexpr int kAStride = kChunk + 4;
// the partial sums of the K splits: (kSplit, 4 slots, kRows, kUnits)
constexpr int kRedFloats = kSplit * 4 * kRows * kUnits;
static_assert(kGroup % 32 == 0, "a K split is whole warps");
static_assert(kSplitK % 4 == 0, "a split reads float4s along K");
static_assert(kThreads % kUnits == 0 && kRows * kUnits % kThreads == 0,
              "the epilogue's rows divide among the threads");

template <int G>
__host__ __device__ constexpr int smem_floats() {
  constexpr int ring = kStages * (kRows * kAStride + kChunk * G * kUnits);
  return ring > kRedFloats ? ring : kRedFloats;
}

struct Cell {
  const float* x;     // (Bs, din)
  const float* h;     // (Bs, H)
  const float* c;     // (Bs, H), LSTM only
  const float* wx;    // (din, G H), G = 3 (GRU) or 4 (LSTM)
  const float* wh;    // (H, G H)
  const float* bias;  // (G H)
  float* h_out;       // (Bs, H)
  float* c_out;       // (Bs, H), LSTM only
  int Bs, din, H;
};

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

// Stage chunk `chunk` of the K loop (chunks [0, n_x) over x / wx, the rest
// over h / wh) for the CTA's rows [r0, r0 + kRows) and units
// [j0, j0 + kUnits): activations to sa[r * kAStride + k], weights to
// sw[k * G kUnits + g kUnits + u]. Out-of-range pieces are zero-filled
// (their source address stays the array's base, never read). kVec: 16-byte
// pieces (din, H multiples of 4; x, h, wx, wh 16-byte aligned), else 4-byte.
template <int G, bool kVec>
__device__ __forceinline__ void stage_chunk(const Cell& a, int chunk, int n_x,
                                            int r0, int j0, float* sa,
                                            float* sw) {
  constexpr int kPiece = kVec ? 4 : 1;
  const bool on_x = chunk < n_x;
  const int k0 = (on_x ? chunk : chunk - n_x) * kChunk;
  const int K = on_x ? a.din : a.H;
  const float* act = on_x ? a.x : a.h;
  const float* w = on_x ? a.wx : a.wh;
  const size_t ld = (size_t)G * a.H;
  constexpr int kActPieces = kRows * kChunk / kPiece;
  for (int p = threadIdx.x; p < kActPieces; p += kThreads) {
    const int r = p / (kChunk / kPiece);
    const int q = (p - r * (kChunk / kPiece)) * kPiece;
    const int row = r0 + r, k = k0 + q;
    const bool ok = row < a.Bs && k < K;
    const float* src = ok ? act + (size_t)row * K + k : act;
    if constexpr (kVec) cp_async16(sa + r * kAStride + q, src, ok);
    else cp_async4(sa + r * kAStride + q, src, ok);
  }
  constexpr int kRowPieces = G * kUnits / kPiece;
  for (int p = threadIdx.x; p < kChunk * kRowPieces; p += kThreads) {
    const int kk = p / kRowPieces;
    const int rest = p - kk * kRowPieces;
    const int g = rest / (kUnits / kPiece);
    const int q = (rest - g * (kUnits / kPiece)) * kPiece;
    const int k = k0 + kk, j = j0 + q;
    const bool ok = k < K && j < a.H;
    const float* src = ok ? w + (size_t)k * ld + (size_t)g * a.H + j : w;
    float* dst = sw + kk * G * kUnits + g * kUnits + q;
    if constexpr (kVec) cp_async16(dst, src, ok);
    else cp_async4(dst, src, ok);
  }
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

// acc[s][i][v] += sum over split `split`'s K rows k of the staged chunk of
//   sa[(rg + kRowGroups i) * kAStride + k] * sw[k G kUnits + g kUnits + u]
// with u = ug kUnitsPerThread + v and s = g, except gate 2 (the GRU's n,
// the LSTM's g), which sums into slot kNSlot.
template <int G, int kNSlot>
__device__ __forceinline__ void fma_chunk(const float* sa, const float* sw,
                                          int split, int rg, int ug,
                                          Acc& acc) {
  const int k_lo = split * kSplitK;
  const float* ar = sa + rg * kAStride + k_lo;
  const float* wr = sw + k_lo * G * kUnits + ug * kUnitsPerThread;
#pragma unroll
  for (int k = 0; k < kSplitK; k += 4) {
    float4 av[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      av[i] = *reinterpret_cast<const float4*>(
          ar + kRowGroups * i * kAStride + k);
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

// One CTA: rows [r0, r0 + kRows) x units [j0, j0 + kUnits), all G gates.
// Warp `split` sums its kSplitK K rows of every chunk; the splits' partial
// sums meet in shared memory (the ring's, once the loop is done), added in
// split order after the bias, and each thread finishes rows of one unit.
template <int G, bool kVec>
__global__ void __launch_bounds__(kThreads) cell_kernel(Cell a) {
  extern __shared__ __align__(16) float smem[];
  float* const s_a = smem;                               // kStages slots
  float* const s_w = smem + kStages * kRows * kAStride;  // kStages slots
  const int r0 = blockIdx.x * kRows, j0 = blockIdx.y * kUnits;
  const int split = threadIdx.x / kGroup, lane = threadIdx.x % kGroup;
  const int rg = lane / kUnitGroups, ug = lane % kUnitGroups;
  const int n_x = (a.din + kChunk - 1) / kChunk;
  const int n = n_x + (a.H + kChunk - 1) / kChunk;
  const auto slot_a = [&](int c) { return s_a + (c % kStages) * kRows * kAStride; };
  const auto slot_w = [&](int c) { return s_w + (c % kStages) * kChunk * G * kUnits; };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n) stage_chunk<G, kVec>(a, c, n_x, r0, j0, slot_a(c), slot_w(c));
    cp_async_commit();
  }
  Acc acc;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int v = 0; v < kUnitsPerThread; ++v) acc[s][i][v] = 0.0f;
  for (int chunk = 0; chunk < n; ++chunk) {
    cp_async_wait<kStages - 2>();  // this chunk's copies have landed ...
    __syncthreads();               // ... for every thread, and the slot
                                   // refilled below is no longer read
    const int next = chunk + kStages - 1;
    if (next < n)
      stage_chunk<G, kVec>(a, next, n_x, r0, j0, slot_a(next), slot_w(next));
    cp_async_commit();
    if constexpr (G == 3) {
      if (chunk >= n_x) {
        fma_chunk<G, 3>(slot_a(chunk), slot_w(chunk), split, rg, ug, acc);
        continue;
      }
    }
    fma_chunk<G, 2>(slot_a(chunk), slot_w(chunk), split, rg, ug, acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is read out: its memory takes the partials
  float* const red = smem;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int v = 0; v < kUnitsPerThread; ++v)
        red[((split * 4 + s) * kRows + rg + kRowGroups * i) * kUnits +
            ug * kUnitsPerThread + v] = acc[s][i][v];
  __syncthreads();
  const int u = threadIdx.x % kUnits, j = j0 + u;
  if (j >= a.H) return;
  // the sums start at the bias (x side; the GRU's nh, slot 3, at 0)
  float bias[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) bias[s] = s < G ? a.bias[s * a.H + j] : 0.0f;
#pragma unroll
  for (int m = 0; m < kRows * kUnits / kThreads; ++m) {
    const int r = threadIdx.x / kUnits + kThreads / kUnits * m;
    const int row = r0 + r;
    if (row >= a.Bs) break;
    float gate[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      gate[s] = bias[s];
#pragma unroll
      for (int p = 0; p < kSplit; ++p)
        gate[s] += red[((p * 4 + s) * kRows + r) * kUnits + u];
    }
    const size_t o = (size_t)row * a.H + j;
    if constexpr (G == 4) {
      const float c_new = __fmaf_rn(
          engine::sigmoidf(gate[1]), a.c[o],
          __fmul_rn(engine::sigmoidf(gate[0]), tanhf(gate[2])));
      a.h_out[o] = __fmul_rn(engine::sigmoidf(gate[3]), tanhf(c_new));
      a.c_out[o] = c_new;
    } else {
      const float rr = engine::sigmoidf(gate[0]);
      const float zz = engine::sigmoidf(gate[1]);
      const float nn = tanhf(__fmaf_rn(rr, gate[3], gate[2]));
      a.h_out[o] = __fmaf_rn(zz, a.h[o], __fmul_rn(__fsub_rn(1.0f, zz), nn));
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the launch grid: row tiles x unit slices
dim3 cell_grid(int Bs, int H) {
  return dim3((Bs + kRows - 1) / kRows, (H + kUnits - 1) / kUnits);
}

template <int G, bool kVec>
int launch_kernel(const Cell& a, cudaStream_t stream) {
  constexpr int bytes = (int)sizeof(float) * smem_floats<G>();
  static_assert(bytes <= 48 * 1024, "no opt-in to more shared memory");
  cell_kernel<G, kVec><<<cell_grid(a.Bs, a.H), kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int G>
int launch(const Cell& a, void* stream) {
  if (a.Bs <= 0 || a.din < 0 || a.H <= 0) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (a.din % 4 == 0 && a.H % 4 == 0 && aligned16(a.x) && aligned16(a.h) &&
      aligned16(a.wx) && aligned16(a.wh))
    return launch_kernel<G, true>(a, s);
  return launch_kernel<G, false>(a, s);
}

}  // namespace

extern "C" {

// dynamic shared memory of a launch; din and H do not change it
size_t fused_gru_smem_bytes(int din, int H) {
  return sizeof(float) * (size_t)smem_floats<3>();
}

size_t fused_lstm_smem_bytes(int din, int H) {
  return sizeof(float) * (size_t)smem_floats<4>();
}

// CTAs of a launch over Bs rows and H hidden units
int fused_gru_ctas(int Bs, int H) {
  const dim3 grid = cell_grid(Bs, H);
  return (int)(grid.x * grid.y);
}

int fused_lstm_ctas(int Bs, int H) { return fused_gru_ctas(Bs, H); }

int fused_gru_launch(const void* x, const void* h, const void* wx,
                     const void* wh, const void* bias, void* out, int Bs,
                     int din, int H, void* stream) {
  Cell a{static_cast<const float*>(x), static_cast<const float*>(h), nullptr,
         static_cast<const float*>(wx), static_cast<const float*>(wh),
         static_cast<const float*>(bias), static_cast<float*>(out), nullptr,
         Bs, din, H};
  return launch<3>(a, stream);
}

int fused_lstm_launch(const void* x, const void* h, const void* c,
                      const void* wx, const void* wh, const void* bias,
                      void* h_out, void* c_out, int Bs, int din, int H,
                      void* stream) {
  Cell a{static_cast<const float*>(x), static_cast<const float*>(h),
         static_cast<const float*>(c), static_cast<const float*>(wx),
         static_cast<const float*>(wh), static_cast<const float*>(bias),
         static_cast<float*>(h_out), static_cast<float*>(c_out), Bs, din, H};
  return launch<4>(a, stream);
}

const char* fused_gru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* fused_lstm_error_string(int code) {
  return fused_gru_error_string(code);
}

}  // extern "C"
