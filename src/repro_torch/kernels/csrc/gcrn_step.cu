// GCRN-M2 V2 step (GC-LSTM, one snapshot) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/dgnn_fused.py, gcrn_fused_pallas and its body
// _gcrn_kernel, reached through kernels/ops.dgnn_fused_step from
// core/gcrn.GCRN.step(mode="v2").
//
// What it computes (the plain version is repro_torch/kernels/ref.py
// dgnn_fused_step), for every node row v of one snapshot:
//   agg_x = sum_k coef * (x[idx] + emsg[eidx]),  agg_h = sum_k coef * h[idx]
//   gates = agg_x @ Wx + agg_h @ Wh + b          -> i | f | g | o
//   c' = sig(f) c + sig(i) tanh(g),  h' = sig(o) tanh(c')
// No mask: padding rows get the gates of a zero aggregate (the model masks
// after the step, as the JAX kernel's caller does).
//
// Design: the fused LSTM cell's tile (fused_rnn.cu, cell_tile.cuh) with an
// aggregation prologue that a thread-block cluster shares.
// - A grid of 32-row tiles x 8-unit slices, all four gates of a slice's
//   units in one CTA, so the LSTM update stays in registers: n 640, H 128
//   gives 20 x 16 = 320 CTAs of 256 threads, a 1-D grid with the slices of
//   a tile neighbours (the live tiles, at the front, start first). Each
//   output is written once (no atomics: two calls give the same bits).
// - Aggregation, shared. The 8 unit slices of a cluster (the slices
//   padded to a multiple of 8; a padding CTA only aggregates) need the same
//   [agg_x | agg_h] tile, so each gathers an eighth of its columns: CTA r
//   sums column groups [r dp / 8, (r + 1) dp / 8) of all 32 rows at once,
//   a quarter warp a row (ell_lanes.cuh: the row's ELL entries in one
//   coalesced load, the live ones shuffled out 8 at a time, the gathers of
//   a batch issued before their FMAs, which run in ascending lane order),
//   and stores each sum into the tiles of all 8 CTAs through distributed
//   shared memory (after a first cluster barrier, whose arrival opens the
//   kernel: every peer runs); one more cluster barrier later every CTA
//   holds the whole tile (din + H columns, zeros up to a multiple of 8).
//   Every unit slice gathering its own tile instead (no cluster) reads 8x
//   the bytes and was slower on the main path: 0.0124 against 0.0104 ms a
//   call from a CUDA graph, 0.0119 against 0.0099 kernel duration, in
//   turns on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md's findings; that
//   variant is not kept).
// - Weights. The slice's columns of [Wx; Wh] (K = din + H rows x 4 gates x
//   8 units: 24 KB at K 192) reach shared memory kChunk K rows a slot by
//   cp.async through a ring of kStages slots, all in flight ahead of the
//   loop; the first kStages chunks are issued between the CTA's arrival at
//   the second cluster barrier and its wait, so the copies overlap the wait
//   and do not queue the gathers. The FMA loop reads only shared memory and
//   registers; each of the 8 warps sums kChunk / 8 K rows of a chunk
//   (cell_tile.cuh fma_rows), and the splits meet in shared memory in a
//   fixed order. fp32 FMA on the CUDA cores (TF32 keeps ~3 digits, over the
//   1e-4 the kernel is held to).
// - A tile without a live lane (all padding) is dead for its whole
//   cluster, which skips the weights, the aggregation, the second barrier
//   and the K loop together: its gates are exactly the bias.
// - Shared memory: the activation tile (32 x (K rounded up to 8, + 4)
//   floats) and the ring (24 KB), or the splits' partial sums (32 KB)
//   where more; it does not grow with n. K up to 1,616 fits (the one-CTA
//   kernel before it took K <= 1,611).
//
// Profile marks: a line `// PROF(i) <phase>` closes phase i; the comments
// are inert here (tools/cluster_engine_profile.py builds a copy in which
// they become clock64 marks: move one with the code whose end it marks).
//
// What bounds it. The card's roofline is ~0.5 us at the main path's shape
// (the bytes: x, h, c, the weights once, the outputs); the gate product is
// 2 x 107 rows x 192 x 512 flops, 0.3 us at the fp32 rate. At one snapshot
// (~107 live rows, ~5 live lanes a row) 4 of the 20 row tiles are live,
// 64 CTAs on 64 SMs, and a live CTA's chain of latencies sets the time
// (PERF.md: of a live CTA's cycles on the main path, the gathers
// and DSMEM stores 0.32, the K loop at 8 warps an SM 0.26, the weight
// copies' issue and the cluster barrier 0.20, the ELL read 0.13). Not the
// FMA rate, not the bytes. On the main path's 137 recorded calls it took
// 0.0104 ms a call from a CUDA graph and 0.0099 ms kernel duration, in
// turns with the one-CTA-a-tile kernel it replaced (0.1249 / 0.1245), on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md's kernel table).
// Registers (nvcc -Xptxas -v, sm_90a): 128 in both variants (4-byte,
// 16-byte), no spills.
#include "cell_tile.cuh"
#include "cluster_common.cuh"
#include "ell_lanes.cuh"

using namespace cell;

namespace {

constexpr int kCluster = cluster::kCluster;  // unit slices sharing a tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = kWarps;             // warps that split a chunk's K rows
constexpr int kChunk = 64;                 // K rows a staged weight chunk
constexpr int kSplitK = kChunk / kSplit;   // a split's K rows a chunk
constexpr int kStages = 3;                 // ring slots
constexpr int kSlotFloats = kChunk * 4 * kUnits;
constexpr int kRowThreads = 8;             // a quarter warp a row ...
constexpr int kWarpRows = 32 / kRowThreads;  // ... four rows a warp
constexpr int kRowEntries = ell::kEntries<kRowThreads>;
constexpr int kBatch = 8;                  // live lanes gathered at once
constexpr int kRedFloats = kSplit * 4 * kRows * kUnits;
static_assert(kWarps * kWarpRows == kRows, "every row of the tile at once");
static_assert(kRows * kUnits == kThreads, "one (row, unit) a thread");

struct StepArgs {
  const int* idx;     // (n, k) local neighbour ids
  const float* coef;  // (n, k)
  const int* eidx;    // (n, k) edge ids into emsg
  const float* x;     // (n, din)
  const float* h;     // (n, H) hidden state of every row (aggregated over)
  const float* c;     // (n, H)
  const float* wx;    // (din, 4H)
  const float* wh;    // (H, 4H)
  const float* bias;  // (4H)
  const float* emsg;  // (e, din), or null
  float* h_out;       // (n, H)
  float* c_out;       // (n, H)
  int n, k, din, H;
};

// columns of the activation tile (K rounded up to 8) and floats between
// two of its rows (4 mod 8: a warp's float4 reads of 8 rows fall on
// distinct banks)
__host__ __device__ constexpr int tile_cols(int din, int H) {
  return (din + H + 7) / 8 * 8;
}

__host__ __device__ constexpr int tile_stride(int din, int H) {
  return tile_cols(din, H) + 4;
}

size_t smem_floats(int din, int H) {
  const size_t ring = (size_t)kRows * tile_stride(din, H) +
                      (size_t)kStages * kSlotFloats;
  return ring > (size_t)kRedFloats ? ring : (size_t)kRedFloats;
}

// row tiles and unit slices (padded to whole clusters) of a launch
__host__ __device__ int2 step_tiles(int n, int H) {
  const int slices = (H + kUnits - 1) / kUnits;
  return make_int2((n + kRows - 1) / kRows,
                   (slices + kCluster - 1) / kCluster * kCluster);
}

// Arrive at the cluster barrier without ordering memory: the first barrier
// only says this CTA runs (its shared memory may take a peer's stores).
__device__ __forceinline__ void arrive_running() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// Column groups [lo, hi) (of V floats) of row v of [agg_x | agg_h | 0]
// into `trow` of every CTA of the cluster, by the row's quarter warp
// (thread t of it, `quarter` its place in the warp): the row's entries 32
// a round (`first`, `live`: the first round's, loaded already), the live
// ones kBatch at a time, thread t summing groups lo + t + kRowThreads c.
// Waits on the cluster's first barrier (arrived at the kernel's start)
// before its first DSMEM store, so the gathers overlap the wait.
template <int V>
__device__ __forceinline__ void aggregate_share(
    const StepArgs& a, int v, const ell::Entry (&first)[kRowEntries],
    unsigned live, int t, int quarter, int lo, int hi, float* trow) {
  using T = typename ell::Vec<V>::T;
  const int dx = a.din / V, dk = (a.din + a.H) / V;
  const T* xs = reinterpret_cast<const T*>(a.x);
  const T* hs = reinterpret_cast<const T*>(a.h);
  const T* es = reinterpret_cast<const T*>(a.emsg);
  const size_t base = (size_t)v * a.k;
  bool waited = false;  // the cluster's first barrier (CTA-uniform)
  for (int q0 = lo; q0 < hi; q0 += kRowThreads) {  // warp-uniform
    // the group's source (row 0) and row stride: x's part, h's part, or
    // past them (padding: reads h's column 0, stores zeros); its edge term
    // (x's part only; other groups read emsg's column 0 and drop it)
    const int q = q0 + t;
    const T* src = q < dx ? xs + q : q < dk ? hs + (q - dx) : hs;
    const int stride = q < dx ? dx : dk - dx;
    const T* ec = es + (q < dx ? q : 0);
    T acc = ell::Vec<V>::zero();
    for (int s0 = 0; s0 < a.k; s0 += 32) {
      ell::Entry ent[kRowEntries];
      unsigned m = live;
      if (s0 == 0) {
#pragma unroll
        for (int j = 0; j < kRowEntries; ++j) ent[j] = first[j];
      } else {
        m = ell::load_round<kRowThreads>(a.idx, a.coef, a.eidx, base,
                                         v < a.n, s0, a.k, t, quarter,
                                         es != nullptr, ent);
      }
      while (__any_sync(~0u, m != 0)) {
        int id[kBatch], ed[kBatch];
        float cf[kBatch];
        ell::next_batch<kRowThreads, kBatch>(m, ent, quarter, id, cf, ed);
        T val[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          val[b] = __ldg(src + (size_t)id[b] * stride);
        if (es != nullptr && q0 < dx) {  // warp-uniform
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const T ev = __ldg(ec + (size_t)ed[b] * dx);
            if (q < dx) val[b] = ell::Vec<V>::add(val[b], ev);
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) ell::Vec<V>::fma(acc, cf[b], val[b]);
      }
    }
    if (!waited) {  // every CTA of the cluster runs: a peer's tile is live
      cluster::wait();
      waited = true;
    }
    if (q < hi) {
      const T out = q < dk ? acc : ell::Vec<V>::zero();
#pragma unroll
      for (unsigned r = 0; r < kCluster; ++r)
        *cluster::peer(reinterpret_cast<T*>(trow) + q, r) = out;
    }
  }
  if (!waited) cluster::wait();
}

// Stage K rows [chunk kChunk, + kChunk) of the slice's weight columns:
// sw[kk * 4 kUnits + g kUnits + u] = W[chunk kChunk + kk, g H + j0 + u],
// W = [Wx; Wh]; rows past K and units past H are zero-filled (the source
// address stays wx, never read). kVec: 16-byte pieces (H a multiple of 4,
// wx and wh 16-byte aligned), else 4-byte.
template <bool kVec>
__device__ __forceinline__ void stage_weights(const StepArgs& a, int chunk,
                                              int j0, float* sw) {
  constexpr int kPiece = kVec ? 4 : 1;
  constexpr int kRowPieces = 4 * kUnits / kPiece;
  const size_t ld = 4 * (size_t)a.H;
  for (int p = threadIdx.x; p < kChunk * kRowPieces; p += kThreads) {
    const int kk = p / kRowPieces;
    const int rest = p - kk * kRowPieces;
    const int g = rest / (kUnits / kPiece);
    const int u = (rest - g * (kUnits / kPiece)) * kPiece;
    const int k = chunk * kChunk + kk, j = j0 + u;
    const bool ok = k < a.din + a.H && j < a.H;
    const float* src = a.wx;
    if (ok)
      src = (k < a.din ? a.wx + (size_t)k * ld
                       : a.wh + (size_t)(k - a.din) * ld) +
            (size_t)g * a.H + j;
    float* dst = sw + kk * 4 * kUnits + g * kUnits + u;
    if constexpr (kVec) cp_async16(dst, src, ok);
    else cp_async4(dst, src, ok);
  }
}

// One CTA: rows [r0, r0 + kRows) x units [j0, j0 + kUnits), all 4 gates,
// rank `rank` of its row tile's cluster.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2) gcrn_step_kernel(StepArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int S = tile_stride(a.din, a.H);
  float* const tile = smem;               // (kRows, S) row-major
  float* const ring = smem + kRows * S;   // kStages weight slots
  const int2 tiles = step_tiles(a.n, a.H);
  const int r0 = (int)(blockIdx.x / tiles.y) * kRows;
  const int j0 = (int)(blockIdx.x % tiles.y) * kUnits;
  const unsigned rank = cluster::ctarank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quarter = lane / kRowThreads, t = lane % kRowThreads;
  const int ar = warp * kWarpRows + quarter, av = r0 + ar;  // its row
  // PROF_INIT
  arrive_running();  // the first barrier: a peer may store into this
                     // CTA's tile once all have arrived

  // the first 32 ELL entries of the row; the tile is live (for all CTAs
  // of the cluster alike) where any of its rows has a live lane
  ell::Entry first[kRowEntries];
  const unsigned live = ell::load_round<kRowThreads>(
      a.idx, a.coef, a.eidx, (size_t)av * a.k, av < a.n, 0, a.k, t, quarter,
      a.emsg != nullptr, first);
  bool any = __any_sync(~0u, live != 0);
  for (int s0 = 32; s0 < a.k && !any; s0 += 32) {  // warp-uniform
    ell::Entry rest[kRowEntries];
    any = __any_sync(~0u, ell::load_round<kRowThreads>(
                              a.idx, a.coef, a.eidx, (size_t)av * a.k,
                              av < a.n, s0, a.k, t, quarter, false,
                              rest) != 0);
  }
  const bool tile_live = __syncthreads_or(any) != 0;
  // PROF(0) ELL lanes + liveness

  // thread (r, u) finishes row r0 + r, unit j0 + u (all gates of it)
  const int r = threadIdx.x / kUnits, u = threadIdx.x % kUnits;
  const int v = r0 + r, j = j0 + u;
  const bool out = v < a.n && j < a.H;
  float gate[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c = 0.0f;
  const auto epilogue_inputs = [&] {
    if (out) {
      c = a.c[(size_t)v * a.H + j];
#pragma unroll
      for (int s = 0; s < 4; ++s) gate[s] = a.bias[s * a.H + j];
    }
  };

  if (!tile_live) {
    epilogue_inputs();  // the gates are the bias
    cluster::wait();    // the first barrier, which no DSMEM store needs here
  } else {
    const bool owns = j0 < a.H;  // a padding slice only aggregates
    const int chunks = (a.din + a.H + kChunk - 1) / kChunk;
    const auto slot = [&](int i) { return ring + (i % kStages) * kSlotFloats; };
    const int dp = tile_cols(a.din, a.H) / (kVec ? 4 : 1);
    aggregate_share<kVec ? 4 : 1>(a, av, first, live, t, quarter,
                                  (int)rank * dp / kCluster,
                                  ((int)rank + 1) * dp / kCluster,
                                  tile + ar * S);
    // PROF(1) aggregation (gathers, DSMEM stores)
    // the first kStages weight chunks load while the cluster waits for its
    // slowest CTA: issued after this CTA arrives (earlier, their copies
    // would queue its gathers behind them)
    cluster::arrive();
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      if (owns && i < chunks) stage_weights<kVec>(a, i, j0, slot(i));
      cp_async_commit();
    }
    cluster::wait();  // every CTA's share is in every CTA's tile
    // PROF(2) weight issue + cluster barrier
    if (!owns) return;
    const int split = warp, rg = lane / kUnitGroups, ug = lane % kUnitGroups;
    Acc acc;
    zero(acc);
    for (int chunk = 0; chunk < chunks; ++chunk) {
      // this chunk's weights have landed (chunk c is copy group c) ...
      if (chunk == 0) cp_async_wait<kStages - 1>();
      else cp_async_wait<kStages - 2>();
      __syncthreads();  // ... for every thread, and the last chunk's slot
                        // is no longer read: it takes chunk c - 1 + kStages
      if (chunk > 0) {
        const int next = chunk - 1 + kStages;
        if (next < chunks) stage_weights<kVec>(a, next, j0, slot(next));
        cp_async_commit();
      }
      // the split's K rows, where any lies below K (the tile's columns
      // end at K rounded up to 8, zeros past K)
      const int k_lo = chunk * kChunk + split * kSplitK;
      if (k_lo < a.din + a.H)
        fma_rows<4, 2, kSplitK>(
            tile + rg * S + k_lo, S,
            slot(chunk) + split * kSplitK * 4 * kUnits + ug * kUnitsPerThread,
            acc);
    }
    // PROF(3) K loop
    epilogue_inputs();
    cp_async_wait<0>();
    __syncthreads();  // tile and ring are read out: they take the partials
    store_partials(acc, smem, split, rg, ug);
    __syncthreads();
    if (out) {
#pragma unroll
      for (int s = 0; s < 4; ++s)
        gate[s] = gate_sum<kSplit>(smem, s, r, u, gate[s]);
    }
    // PROF(4) partial sums
  }
  if (!out) return;
  const size_t o = (size_t)v * a.H + j;
  float h_new, c_new;
  lstm_update(gate, c, h_new, c_new);
  a.h_out[o] = h_new;
  a.c_out[o] = c_new;
  // PROF(5) LSTM update
  // PROF_END
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kVec>
int launch_kernel(const StepArgs& a, void* stream) {
  const int2 tiles = step_tiles(a.n, a.H);
  return cluster::launch(gcrn_step_kernel<kVec>,
                         tiles.x * tiles.y / kCluster, kThreads,
                         sizeof(float) * smem_floats(a.din, a.H), stream, a);
}

}  // namespace

extern "C" {

// dynamic shared memory of a launch (k does not change it)
size_t gcrn_step_smem_bytes(int k, int din, int H) {
  return sizeof(float) * smem_floats(din, H);
}

// the launch over n rows: out = row tiles, unit slices (padded to whole
// clusters), CTAs (a 1-D grid, the slices of a tile neighbours), threads,
// shared bytes, CTAs a cluster
int gcrn_step_plan(int n, int k, int din, int H, int* out) {
  const int2 tiles = step_tiles(n, H);
  out[0] = tiles.x;
  out[1] = tiles.y;
  out[2] = tiles.x * tiles.y;
  out[3] = kThreads;
  out[4] = (int)gcrn_step_smem_bytes(k, din, H);
  out[5] = kCluster;
  return 0;
}

int gcrn_step_launch(const void* idx, const void* coef, const void* eidx,
                     const void* x, const void* h, const void* c,
                     const void* wx, const void* wh, const void* bias,
                     const void* emsg, void* h_out, void* c_out, int n, int k,
                     int din, int H, void* stream) {
  StepArgs a;
  a.idx = static_cast<const int*>(idx);
  a.coef = static_cast<const float*>(coef);
  a.eidx = static_cast<const int*>(eidx);
  a.x = static_cast<const float*>(x);
  a.h = static_cast<const float*>(h);
  a.c = static_cast<const float*>(c);
  a.wx = static_cast<const float*>(wx);
  a.wh = static_cast<const float*>(wh);
  a.bias = static_cast<const float*>(bias);
  a.emsg = static_cast<const float*>(emsg);
  a.h_out = static_cast<float*>(h_out);
  a.c_out = static_cast<float*>(c_out);
  a.n = n; a.k = k; a.din = din; a.H = H;
  if (n <= 0 || H <= 0) return 0;
  // float4 gathers and 16-byte weight copies need 4-float rows and
  // 16-byte aligned bases
  const bool vec = din % 4 == 0 && H % 4 == 0 && aligned16(x) &&
                   aligned16(h) && aligned16(wx) && aligned16(wh) &&
                   (emsg == nullptr || aligned16(emsg));
  return vec ? launch_kernel<true>(a, stream) : launch_kernel<false>(a, stream);
}

const char* gcrn_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
