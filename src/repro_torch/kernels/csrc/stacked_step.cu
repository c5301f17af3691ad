// Stacked DGNN V2 step (GCN -> GRU, one snapshot) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/dgnn_fused.py, stacked_fused_pallas and its
// body _stacked_kernel, reached through kernels/ops.stacked_fused_step from
// core/stacked.StackedDGNN.step(mode="v2").
//
// What it computes (the plain version is repro_torch/kernels/ref.py
// stacked_fused_step), for every node row v of one snapshot:
//   agg = sum_k coef * (x[idx] + emsg[eidx])
//   nt  = agg @ Wg + bg                           (the NT stage, linear)
//   gx  = nt @ Wx + b,  gh = h @ Wh               -> r | z | n each
//   h'  = (1 - z) n + z h,  r = sig(rx + rh), z = sig(zx + zh),
//         n = tanh(nx + r nh)
// against the row's own h (no aggregation over h), no mask (the model
// masks after the step).
//
// Design: gcrn_step.cu's, with the node transform between the aggregation
// and the cell.
// - A grid of 32-row tiles x 8-unit slices, all three gates of a slice's
//   units in one CTA of 256 threads: n 640, H 128 gives 20 x 16 = 320 CTAs,
//   a 1-D grid with the slices of a tile neighbours, padded to whole
//   clusters of 8 (a padding CTA aggregates and computes nt, no units).
//   Each output is written once (no atomics: two calls give the same bits).
// - Aggregation, shared (slice_tile.cuh share_row): CTA r of a cluster sums
//   an eighth of agg's columns (din rounded up to 32) for all 32 rows, a
//   quarter warp a row, and stores them into the agg tile of all 8 CTAs by
//   DSMEM (after the first cluster barrier, arrived at on entry).
// - nt, sliced: after a second cluster barrier CTA r computes nt's columns
//   [r dmid / 8, (r + 1) dmid / 8) on the whole agg tile (slice_pass: the
//   K rows over the 8 warps; its Wg column slice, 8 KB at din = dmid = 128,
//   staged in shared memory by cp.async while the cluster waits, or read
//   from L2 where it does not fit beside the tiles) and stores them, plus
//   bg, into the [nt | h] tile of all 8 CTAs; a third barrier later every
//   CTA holds the whole nt.
// - GRU: cell_tile.cuh's product over K = dmid (rounded up to 8) + H rows
//   of [nt | h]: the slice's r | z | n columns of [Wx; Wh] (24 KB at K 256)
//   arrive kChunk K rows a slot through a ring of kStages cp.async slots,
//   the first ones issued between the CTA's arrival at the third barrier and
//   its wait; each warp sums kChunk / 8 K rows of a chunk, n's x and h sums
//   apart (r nh), and the splits meet in shared memory in a fixed order.
//   The update is fused_rnn.cu's. The rows' own h and the Wg slice reach
//   shared memory by cp.async, issued between the CTA's arrival at the
//   second barrier and its wait (after its gathers, so they do not queue
//   behind them). Running h's K rows there instead, before nt arrives,
//   took 0.0139-0.0141 ms against 0.0143 a call and spilled: not kept.
// - A tile without a live lane skips the aggregation, nt and both
//   all-gathers: its nt is exactly bg. If its h rows are all zero too
//   (padding rows), every row's h' is the same value, the GRU of bg against
//   h = 0: the CTA computes it for its units from bg and Wx alone (a dot over
//   dmid) and writes it to its rows. Otherwise it runs the GRU against its
//   h rows with nt = bg.
// - fp32 FMA on the CUDA cores (TF32 keeps ~3 digits, over the 1e-4 the
//   kernel is held to). Shared memory: the agg tile (32 x (din rounded up
//   to 32, + 4)), the [nt | h] tile (32 x (dmid and H rounded up to 8, +
//   4)), the ring (18 KB) and, where it fits, the Wg slice; the GRU's
//   partial sums (32 KB) reuse it. It does not grow with n or k, and every
//   (k, din, dmid, H) the one-CTA kernel before it took still fits.
//
// Profile marks: a line `// PROF(i) <phase>` closes phase i; the comments
// are inert here (tools/cluster_engine_profile.py builds a copy in which
// they become clock64 marks: move one with the code whose end it marks).
//
// What bounds it. The card's roofline at the main path's shape is ~0.4 us
// (the products of the ~107 live rows at 67 TFLOP/s; the bytes are less).
// At one snapshot 4 of the 20 row tiles are live, 64 CTAs, and a live
// CTA's chain of latencies sets the time: the ELL round trip, the gathers,
// three cluster barriers, the nt product and the K loop (PERF.md: of a live
// CTA's cycles, the barriers and nt 0.44, the K loop 0.23, the gathers
// 0.19). The other 256 CTAs are padding tiles (no live lane, h = 0), a dot
// over dmid each; running the GRU there instead took 0.0224 against 0.0142
// ms a call. On the main path's 137 recorded calls it took 0.0142 ms
// kernel duration a call (0.0146 from a CUDA graph), in turns with the
// one-CTA-a-tile kernel it replaced (0.0667), on an NVIDIA H100 80GB HBM3
// at 700 W (PERF.md's kernel table).
// Registers (nvcc -Xptxas -v, sm_90a): 128 in all four variants, no
// spills.
#include "cell_tile.cuh"
#include "slice_tile.cuh"

using namespace cell;

namespace {

constexpr int kCluster = cluster::kCluster;  // unit slices sharing a tile
constexpr int kThreads = slice::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = kWarps;             // warps that split a chunk's K rows
constexpr int kChunk = 64;                 // K rows a staged weight chunk
constexpr int kSplitK = kChunk / kSplit;   // a split's K rows a chunk
constexpr int kStages = 3;                 // ring slots
constexpr int kGates = 3;                  // r | z | n
constexpr int kSlotFloats = kChunk * kGates * kUnits;
constexpr int kRingFloats = kStages * kSlotFloats;
constexpr int kRedFloats = kSplit * 4 * kRows * kUnits;
static_assert(kRows * kUnits == kThreads, "one (row, unit) a thread");
static_assert(slice::kPartFloats <= kRingFloats, "nt's partials in the ring");
static_assert(kSplitK % 8 == 0, "a split lies within nt's or h's rows");

struct StepArgs {
  const int* idx;     // (n, k) local neighbour ids
  const float* coef;  // (n, k)
  const int* eidx;    // (n, k) edge ids into emsg
  const float* x;     // (n, din)
  const float* h;     // (n, H) own hidden rows
  const float* wg;    // (din, dmid) last GCN layer
  const float* bg;    // (dmid)
  const float* wx;    // (dmid, 3H)
  const float* wh;    // (H, 3H)
  const float* bias;  // (3H)
  const float* emsg;  // (e, din), or null
  float* out;         // (n, H)
  int n, k, din, dmid, H;
};

// A CTA's shared memory, in floats: the row-major agg tile, the row-major
// [nt | h] tile (h from column m8), the weight ring (nt's partial sums
// first) and, where it fits, the Wg slice; the GRU's partial sums reuse all
// of it from the base.
struct Layout {
  int sa, sg, m8, ldw;
  size_t tile, ring, wg, floats;
};

__host__ __device__ inline Layout place(int din, int dmid, int H,
                                        bool wg_smem) {
  Layout L;
  L.sa = slice::k_stride(din);
  L.m8 = slice::round_up(dmid, 8);
  L.sg = L.m8 + slice::round_up(H, 8) + 4;
  L.ldw = slice::round_up(cluster::slice_max(dmid), slice::kPassCols);
  L.tile = (size_t)kRows * L.sa;
  L.ring = L.tile + (size_t)kRows * L.sg;
  L.wg = L.ring + kRingFloats;
  const size_t end =
      L.wg + (wg_smem ? (size_t)slice::k_cols(din) * L.ldw : 0);
  L.floats = end > (size_t)kRedFloats ? end : (size_t)kRedFloats;
  return L;
}

// Is the Wg slice in shared memory (it fits beside the rest)?
__host__ __device__ inline bool wg_in_smem(int din, int dmid, int H) {
  return place(din, dmid, H, true).floats * sizeof(float) <=
         cluster::kSmemLimit;
}

// row tiles and unit slices (padded to whole clusters) of a launch
__host__ __device__ inline int2 step_tiles(int n, int H) {
  const int slices = (H + kUnits - 1) / kUnits;
  return make_int2((n + kRows - 1) / kRows,
                   (slices + kCluster - 1) / kCluster * kCluster);
}

// Rows [r0, r0 + kRows) of h into the tile's columns [m8, m8 + H rounded up
// to 8) by cp.async (rows past n and columns past H zero-filled; the source
// address stays h, never read). kVec: 16-byte pieces.
template <bool kVec>
__device__ __forceinline__ void stage_h(const StepArgs& a, int r0, float* th,
                                        int stride) {
  constexpr int kPiece = kVec ? 4 : 1;
  const int cols = slice::round_up(a.H, 8) / kPiece;
  for (int p = threadIdx.x; p < kRows * cols; p += kThreads) {
    const int r = p / cols, c = (p - r * cols) * kPiece;
    const bool ok = r0 + r < a.n && c < a.H;
    const float* src = ok ? a.h + (size_t)(r0 + r) * a.H + c : a.h;
    if constexpr (kVec) cp_async16(th + r * stride + c, src, ok);
    else cp_async4(th + r * stride + c, src, ok);
  }
}

// The Wg columns [c0, c0 + wc) into ws[kk * ldw + c] for kk < din rounded
// up to 32 (zeros past din and past wc) by cp.async.
__device__ __forceinline__ void stage_wg(const StepArgs& a, int c0, int wc,
                                         int ldw, float* ws) {
  const int rows = slice::k_cols(a.din);
  for (int p = threadIdx.x; p < rows * ldw; p += kThreads) {
    const int kk = p / ldw, c = p - kk * ldw;
    const bool ok = kk < a.din && c < wc;
    cp_async4(ws + p, ok ? a.wg + (size_t)kk * a.dmid + c0 + c : a.wg, ok);
  }
}

// Stage K rows [chunk kChunk, + kChunk) of the slice's weight columns:
// sw[kk * 3 kUnits + g kUnits + u] = W[chunk kChunk + kk, g H + j0 + u],
// W = [Wx; 0 up to m8 rows; Wh]; rows past that and units past H are
// zero-filled (the source address stays wx, never read). kVec: 16-byte
// pieces (H a multiple of 4, wx and wh 16-byte aligned), else 4-byte.
template <bool kVec>
__device__ __forceinline__ void stage_weights(const StepArgs& a, int m8,
                                              int chunk, int j0, float* sw) {
  constexpr int kPiece = kVec ? 4 : 1;
  constexpr int kRowPieces = kGates * kUnits / kPiece;
  const size_t ld = kGates * (size_t)a.H;
  for (int p = threadIdx.x; p < kChunk * kRowPieces; p += kThreads) {
    const int kk = p / kRowPieces;
    const int rest = p - kk * kRowPieces;
    const int g = rest / (kUnits / kPiece);
    const int u = (rest - g * (kUnits / kPiece)) * kPiece;
    const int k = chunk * kChunk + kk, j = j0 + u;
    const bool on_x = k < a.dmid, on_h = k >= m8 && k < m8 + a.H;
    const bool ok = (on_x || on_h) && j < a.H;
    const float* src = a.wx;
    if (ok)
      src = (on_x ? a.wx + (size_t)k * ld : a.wh + (size_t)(k - m8) * ld) +
            (size_t)g * a.H + j;
    float* dst = sw + kk * kGates * kUnits + g * kUnits + u;
    if constexpr (kVec) cp_async16(dst, src, ok);
    else cp_async4(dst, src, ok);
  }
}

// One CTA: rows [r0, r0 + kRows) x units [j0, j0 + kUnits), all 3 gates,
// rank `rank` of its row tile's cluster (nt's columns of that rank).
template <bool kVec, bool kWgSmem>
__global__ void __launch_bounds__(kThreads, 2)
    stacked_step_kernel(StepArgs a) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay = place(a.din, a.dmid, a.H, kWgSmem);
  float* const agg = smem;               // (kRows, sa) row-major
  float* const tile = smem + lay.tile;   // (kRows, sg) row-major [nt | h]
  float* const ring = smem + lay.ring;   // kStages weight slots
  const int S = lay.sg, m8 = lay.m8;
  const int2 tiles = step_tiles(a.n, a.H);
  const int r0 = (int)(blockIdx.x / tiles.y) * kRows;
  const int j0 = (int)(blockIdx.x % tiles.y) * kUnits;
  const unsigned rank = cluster::ctarank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quarter = lane / slice::kRowThreads;
  const int t = lane % slice::kRowThreads;
  const int ar = warp * slice::kWarpRows + quarter, av = r0 + ar;  // its row
  // PROF_INIT
  slice::arrive_running();  // the first barrier: a peer may store into
                            // this CTA's tiles once all have arrived

  // the first 32 ELL entries of the row; the tile is live (for all CTAs
  // of the cluster alike) where any of its rows has a live lane
  ell::Entry first[slice::kRowEntries];
  const unsigned live = ell::load_round<slice::kRowThreads>(
      a.idx, a.coef, a.eidx, (size_t)av * a.k, av < a.n, 0, a.k, t, quarter,
      a.emsg != nullptr, first);
  bool any = __any_sync(~0u, live != 0);
  for (int s0 = 32; s0 < a.k && !any; s0 += 32) {  // warp-uniform
    ell::Entry rest[slice::kRowEntries];
    any = __any_sync(~0u, ell::load_round<slice::kRowThreads>(
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
  const bool owns = j0 < a.H;  // a padding slice has no units
  const int chunks = (m8 + a.H + kChunk - 1) / kChunk;
  const auto slot = [&](int i) { return ring + (i % kStages) * kSlotFloats; };
  const auto issue_ring = [&] {  // the first kStages weight chunks
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      if (owns && i < chunks) stage_weights<kVec>(a, m8, i, j0, slot(i));
      cp_async_commit();
    }
  };

  if (!tile_live) {
    // nt is exactly bg on every row; the rows' own h decide the rest
    stage_h<kVec>(a, r0, tile + m8, S);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    bool nz = false;
    for (int p = threadIdx.x; p < kRows * a.H; p += kThreads)
      nz |= tile[(p / a.H) * S + m8 + p % a.H] != 0.0f;
    const bool h_live = __syncthreads_or(nz) != 0;
    cluster::wait();  // the first barrier, which no DSMEM store needs here
    if (!owns) return;
    if (!h_live) {
      // every row's h' is the GRU of nt = bg against h = 0: gx of the
      // CTA's units, each a dot over dmid split over the 8 warps
      float* red = ring;
      const int g = lane / kUnits, ju = j0 + lane % kUnits;
      const bool mine = lane < kGates * kUnits && ju < a.H;
      const float* wcol = a.wx + (size_t)g * a.H + ju;
      float s = 0.0f;
      if (mine) {
#pragma unroll 4
        for (int kk = warp; kk < a.dmid; kk += kWarps)
          s = fmaf(__ldg(a.bg + kk), __ldg(wcol + (size_t)kk * kGates * a.H),
                   s);
      }
      red[warp * 32 + lane] = s;
      __syncthreads();
      if (threadIdx.x < kGates * kUnits) {
        const int gg = threadIdx.x / kUnits, jj = j0 + threadIdx.x % kUnits;
        float sum = jj < a.H ? a.bias[gg * a.H + jj] : 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += red[w * 32 + threadIdx.x];
        red[kWarps * 32 + threadIdx.x] = sum;
      }
      __syncthreads();
      if (out) {
        const float* gx = red + kWarps * 32;
        const float rr = engine::sigmoidf(gx[u]);
        const float zz = engine::sigmoidf(gx[kUnits + u]);
        const float nn = tanhf(__fmaf_rn(rr, 0.0f, gx[2 * kUnits + u]));
        a.out[(size_t)v * a.H + j] =
            __fmaf_rn(zz, 0.0f, __fmul_rn(__fsub_rn(1.0f, zz), nn));
      }
      return;
    }
    for (int p = threadIdx.x; p < kRows * m8; p += kThreads) {
      const int c = p % m8;
      tile[(p / m8) * S + c] = c < a.dmid ? a.bg[c] : 0.0f;
    }
    issue_ring();
    // PROF(1) dead tile: own h, nt = bg
  } else {
    constexpr int V = kVec ? 4 : 1;
    const int dp = slice::k_cols(a.din) / V;
    slice::share_row<V, true>(
        a.x, a.din, a.din, a.emsg, nullptr, a.idx, a.coef, a.eidx, av, a.n,
        a.k, first, live, t, quarter, (int)rank * dp / kCluster,
        ((int)rank + 1) * dp / kCluster, agg + ar * lay.sa, true);
    // PROF(2) aggregation (gathers, DSMEM stores)
    // the rows' own h and the Wg slice load while the cluster waits for
    // its slowest CTA (issued after this CTA arrives: earlier, they would
    // queue its gathers behind them)
    const int mlo = cluster::slice_lo(a.dmid, (int)rank);
    const int mw = cluster::slice_lo(a.dmid, (int)rank + 1) - mlo;
    cluster::arrive();
    stage_h<kVec>(a, r0, tile + m8, S);
    if constexpr (kWgSmem) stage_wg(a, mlo, mw, lay.ldw, smem + lay.wg);
    cp_async_commit();
    // nt's columns past dmid (no peer stores there)
    for (int p = threadIdx.x; p < kRows * (m8 - a.dmid); p += kThreads) {
      const int c = a.dmid + p % (m8 - a.dmid);
      tile[(p / (m8 - a.dmid)) * S + c] = 0.0f;
    }
    cluster::wait();  // every CTA's share of agg is in every CTA's tile
    cp_async_wait<0>();
    __syncthreads();
    // PROF(3) h + Wg issue, cluster barrier
    // nt's columns [mlo, mlo + mw), kPassCols a pass, into every CTA's tile
    const int rr = threadIdx.x / 8, cc = threadIdx.x % 8 * 2;
    for (int c0 = 0; c0 < mw; c0 += slice::kPassCols) {
      slice::slice_pass<kWgSmem>(agg, lay.sa, slice::k_cols(a.din),
                                 smem + lay.wg + c0, lay.ldw,
                                 a.wg + mlo + c0, a.dmid, a.din,
                                 min(slice::kPassCols, mw - c0), ring);
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = mlo + c0 + cc + e;
        if (c0 + cc + e < mw) {
          const float val = slice::slice_sum(ring, rr, cc + e, a.bg[c]);
          float* dst = tile + rr * S + c;
#pragma unroll
          for (unsigned p = 0; p < kCluster; ++p) *cluster::peer(dst, p) = val;
        }
      }
      __syncthreads();  // the partials are read out (next pass, the ring)
    }
    // PROF(4) nt (product, DSMEM stores)
    // the first kStages weight chunks load while the cluster waits
    cluster::arrive();
    issue_ring();
    cluster::wait();  // every CTA's nt columns are in every CTA's tile
    // PROF(5) weight issue + cluster barrier
    if (!owns) return;
  }

  const int split = warp, rg = lane / kUnitGroups, ug = lane % kUnitGroups;
  const int kt = m8 + slice::round_up(a.H, 8);  // the tile's K columns
  Acc acc;
  zero(acc);
  for (int chunk = 0; chunk < chunks; ++chunk) {
    // this chunk's weights have landed (chunk c is copy group c) ...
    if (chunk == 0) cp_async_wait<kStages - 1>();
    else cp_async_wait<kStages - 2>();
    __syncthreads();  // ... for every thread, and the last chunk's slot is
                      // no longer read: it takes chunk c - 1 + kStages
    if (chunk > 0) {
      const int next = chunk - 1 + kStages;
      if (next < chunks) stage_weights<kVec>(a, m8, next, j0, slot(next));
      cp_async_commit();
    }
    // the split's K rows, where any lies below the tile's columns: nt's
    // (n's x sum in slot 2) or h's (n's h sum in slot 3)
    const int k_lo = chunk * kChunk + split * kSplitK;
    const float* ap = tile + rg * S + k_lo;
    const float* wp = slot(chunk) + split * kSplitK * kGates * kUnits +
                      ug * kUnitsPerThread;
    if (k_lo < m8) fma_rows<kGates, 2, kSplitK>(ap, S, wp, acc);
    else if (k_lo < kt) fma_rows<kGates, 3, kSplitK>(ap, S, wp, acc);
  }
  // PROF(6) K loop
  float gate[4] = {0.0f, 0.0f, 0.0f, 0.0f}, hv = 0.0f;
  if (out) {
    hv = tile[r * S + m8 + j];
#pragma unroll
    for (int s = 0; s < kGates; ++s) gate[s] = a.bias[s * a.H + j];
  }
  cp_async_wait<0>();
  __syncthreads();  // the tiles and the ring are read out: the partials
  store_partials(acc, smem, split, rg, ug);
  __syncthreads();
  if (!out) return;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    gate[s] = gate_sum<kSplit>(smem, s, r, u, gate[s]);
  const float rr = engine::sigmoidf(gate[0]);
  const float zz = engine::sigmoidf(gate[1]);
  const float nn = tanhf(__fmaf_rn(rr, gate[3], gate[2]));
  a.out[(size_t)v * a.H + j] =
      __fmaf_rn(zz, hv, __fmul_rn(__fsub_rn(1.0f, zz), nn));
  // PROF(7) partial sums + GRU update
  // PROF_END
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kVec, bool kWgSmem>
int launch_kernel(const StepArgs& a, void* stream) {
  const int2 tiles = step_tiles(a.n, a.H);
  return cluster::launch(
      stacked_step_kernel<kVec, kWgSmem>, tiles.x * tiles.y / kCluster,
      kThreads, sizeof(float) * place(a.din, a.dmid, a.H, kWgSmem).floats,
      stream, a);
}

}  // namespace

extern "C" {

// dynamic shared memory of a launch (k does not change it)
size_t stacked_step_smem_bytes(int k, int din, int dmid, int H) {
  return sizeof(float) *
         place(din, dmid, H, wg_in_smem(din, dmid, H)).floats;
}

// the launch over n rows: out = row tiles, unit slices (padded to whole
// clusters), CTAs (a 1-D grid, the slices of a tile neighbours), threads,
// shared bytes, CTAs a cluster, Wg's slice in shared memory (1) or not
int stacked_step_plan(int n, int k, int din, int dmid, int H, int* out) {
  const int2 tiles = step_tiles(n, H);
  out[0] = tiles.x;
  out[1] = tiles.y;
  out[2] = tiles.x * tiles.y;
  out[3] = kThreads;
  out[4] = (int)stacked_step_smem_bytes(k, din, dmid, H);
  out[5] = kCluster;
  out[6] = wg_in_smem(din, dmid, H) ? 1 : 0;
  return 0;
}

int stacked_step_launch(const void* idx, const void* coef, const void* eidx,
                        const void* x, const void* h, const void* wg,
                        const void* bg, const void* wx, const void* wh,
                        const void* bias, const void* emsg, void* out, int n,
                        int k, int din, int dmid, int H, void* stream) {
  StepArgs a;
  a.idx = static_cast<const int*>(idx);
  a.coef = static_cast<const float*>(coef);
  a.eidx = static_cast<const int*>(eidx);
  a.x = static_cast<const float*>(x);
  a.h = static_cast<const float*>(h);
  a.wg = static_cast<const float*>(wg);
  a.bg = static_cast<const float*>(bg);
  a.wx = static_cast<const float*>(wx);
  a.wh = static_cast<const float*>(wh);
  a.bias = static_cast<const float*>(bias);
  a.emsg = static_cast<const float*>(emsg);
  a.out = static_cast<float*>(out);
  a.n = n; a.k = k; a.din = din; a.dmid = dmid; a.H = H;
  if (n <= 0 || H <= 0) return 0;
  // float4 gathers and 16-byte copies need 4-float rows and 16-byte aligned
  // bases
  const bool vec = din % 4 == 0 && H % 4 == 0 && aligned16(x) &&
                   aligned16(h) && aligned16(wx) && aligned16(wh) &&
                   (emsg == nullptr || aligned16(emsg));
  if (wg_in_smem(din, dmid, H))
    return vec ? launch_kernel<true, true>(a, stream)
               : launch_kernel<false, true>(a, stream);
  return vec ? launch_kernel<true, false>(a, stream)
             : launch_kernel<false, false>(a, stream);
}

const char* stacked_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
