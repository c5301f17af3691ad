// GCRN-M2 (GC-LSTM) stream engine for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/stream_fused.py, _stream_engine_kernel with
// the gcrn cell (_gcrn_cell, launch assembly _gcrn_build), reached through
// stream_call("gcrn", ...), and under hbm_paged residency the engine's
// paged staging (_Engine.stage_in / write_back / paged_fill).
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
// Design. One thread-block cluster of kCluster CTAs (cluster_common.cuh)
// runs one stream's whole T loop; B streams are B clusters, which never
// wait on each other (past the card's SMs they run in waves). CTA r owns
// the hidden units [r H / C, (r + 1) H / C) and the input columns
// [r din / C, (r + 1) din / C):
//   * for the whole stream it holds its units' i | f | g | o columns of
//     Wx | Wh and b in shared memory, interleaved [k row][unit][gate] so a
//     thread reads its unit's four gate weights as one float4;
//   * each step it gathers its units' t-1 h and c rows out of the global
//     stores into shared memory (or, where 2 n of its rows do not fit
//     beside the rest, into per-CTA global scratch (B C, n, hmp), the
//     paged variant's), and only then (after a block barrier) runs the
//     node tiles,
//     whose epilogues write the stores: every read of the t-1 state is done
//     before any row of step t is written. A unit's state is read and
//     written by its own CTA only, so no state crosses CTAs;
//   * per live node tile (32 rows) it aggregates its own columns of agg_x
//     and agg_h (the ELL sum is separable by column) into its k-major tile,
//     copies them into every peer's tile (DSMEM), and after one cluster
//     barrier runs its units' slice of the gate product on the whole
//     [agg_x | agg_h] tile as a register micro-tile (4 rows x 4 gates a
//     thread) with the LSTM update fused behind it. The tile is double
//     buffered, so one cluster barrier a live tile suffices: a peer writes
//     tile i + 2 only after every CTA passed tile i + 1's barrier, which
//     each reaches after its product on tile i.
// agg_h runs over the source rows in windows of kBoxRows (the windows the
// paged variant stages), each window's lanes in order, so both variants
// sum alike.
//
// Paged variant (hbm_paged residency, gcrn_engine_paged_launch): the same
// kernel compiled with kPaged. The gathered t-1 rows go to per-CTA global
// scratch ((B C, n, hmp): each CTA's columns contiguous), and no whole-state
// buffer sits in shared memory: each live tile reads them back through a
// depth-deep ring of windows (cluster_common.cuh), a window being one TMA
// box of up to kBoxRows gathered h rows x td of the CTA's own columns (the
// first row window of a column window also brings the tile's own 32 c
// rows). The ring runs across the live tiles of a step: while one window
// is consumed the next depth - 1 (of this tile or the next live one) are
// in flight. Outputs and final stores are bit-identical to the resident
// kernel's.
//
// What bounds it. The recurrence is serial in t; a stream spreads over
// kCluster SMs. The card's roofline is set by the bytes of the per-step
// inputs; the kernel is bound by latency: a live tile's chain of ELL
// loads, gathers from L2 (agg_x) and shared memory (agg_h), the cluster
// barrier and the gate product's K loop (2 (din + H) 4 hs flops a row on
// 4 warps), with the step's row gather in front (PERF.md). The
// paged variant adds the ring's copies: n x hs floats a live tile.
#include "cluster_common.cuh"

using engine::kTileRows;
using engine::kTileStride;
using engine::sigmoidf;
using namespace cluster;

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
  float* h_rows;      // paged: (B C, n, hmp) scratch, the gathered t-1 h
  float* c_rows;      // paged: (B C, n, hmp) scratch, the gathered t-1 c
  int* proto;         // the ring's protocol log (cluster_common.cuh), or null
  int T, n, k, din, H, G, e;
  int td, depth;      // paged: window width and ring depth
};

// Shared memory of one CTA, in floats from the 128-byte aligned base.
struct Layout {
  int K, hm, hmp, wr;
  bool rows_smem;  // resident: the step's gathered rows in shared memory
  size_t ring, tiles, ws, bs, ct, hs, cs, idx, coef, eidx, rows, bars;
  size_t bytes;  // dynamic shared memory, alignment slack included
};

__host__ __device__ inline Layout layout(bool paged, int k, int din, int H,
                                         int n, int td, int depth) {
  Layout L{};
  L.K = din + H;
  L.hm = slice_max(H);           // widest unit slice
  L.hmp = round_up(L.hm, 4);     // its row stride in the gathered rows
  L.wr = round_up(n, 8) < kBoxRows ? round_up(n, 8) : kBoxRows;  // window rows
  size_t o = 0;
  if (paged) {
    L.ring = o;  // depth slots: wr gathered h rows, then 32 own c rows
    o += (size_t)depth * (L.wr + kTileRows) * td;
  }
  L.tiles = o;  // two k-major (K, kTileStride) tiles [agg_x | agg_h]
  o += 2 * (size_t)L.K * kTileStride;
  L.ws = o;  // own weights: [k row][unit][gate]
  o += (size_t)L.K * L.hm * 4;
  L.bs = o;
  o += (size_t)L.hm * 4;
  if (paged) {
    L.ct = o;  // the tile's own t-1 c rows, k-major
    o += (size_t)L.hm * kTileStride;
  }
  L.idx = o;
  o += (size_t)kTileRows * k;
  L.coef = o;
  o += (size_t)kTileRows * k;
  L.eidx = o;
  o += (size_t)kTileRows * k;
  L.rows = o;  // the tile's mask, row ids, live lane counts; the live bits
  o += 3 * kTileRows + kLiveWords;
  L.bars = o;
  if (paged) o += engine::kRingBarBytes / sizeof(float);
  // resident: the step's gathered t-1 h and c rows of the own units, where
  // they fit the CTA's shared memory
  const size_t rows = 2 * (size_t)n * L.hmp;
  L.rows_smem = !paged && kAlignSlack + (o + rows) * sizeof(float) <= kSmemLimit;
  if (L.rows_smem) {
    L.hs = o;
    L.cs = o + rows / 2;
    o += rows;
  }
  L.bytes = kAlignSlack + o * sizeof(float);
  return L;
}

template <bool kPaged, bool kLog = false>
__global__ void __launch_bounds__(kThreads, 1)
    gcrn_engine_kernel(const __grid_constant__ CUtensorMap hmap,
                       const __grid_constant__ CUtensorMap cmap, GcrnArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the 128-byte aligned base, offset from smem_raw (not rebuilt from an
  // integer), so the compiler keeps it a shared-memory pointer: the tiles'
  // and weights' loads compile to LDS, not generic loads
  float* smem = reinterpret_cast<float*>(
      smem_raw + ((128u - hopper::smem_u32(smem_raw)) & 127u));
  const int H = a.H, n = a.n, k = a.k, din = a.din, td = a.td;
  const Layout lay = layout(kPaged, k, din, H, n, td, a.depth);
  const int K = lay.K, hm = lay.hm, hmp = lay.hmp, wr = lay.wr;
  const unsigned rank = ctarank();
  const int b = blockIdx.x / kCluster;
  const int u0 = slice_lo(H, rank), hs = slice_lo(H, rank + 1) - u0;
  const int x0 = slice_lo(din, rank), xs = slice_lo(din, rank + 1) - x0;
  float* tiles = smem + lay.tiles;
  float* ws = smem + lay.ws;
  float* bs = smem + lay.bs;
  int* s_idx = reinterpret_cast<int*>(smem + lay.idx);
  float* s_coef = smem + lay.coef;
  int* s_eidx = reinterpret_cast<int*>(smem + lay.eidx);
  float* s_mask = smem + lay.rows;  // the tile's mask, row ids, lane counts
  int* s_rowg = reinterpret_cast<int*>(s_mask + kTileRows);
  int* s_cnt = reinterpret_cast<int*>(s_mask + 2 * kTileRows);
  uint32_t* s_live = reinterpret_cast<uint32_t*>(s_mask + 3 * kTileRows);
  const int tid = threadIdx.x;

  for (int p = tid; p < K * hm * 4; p += kThreads) {
    const int g = p & 3, j = (p >> 2) % hm, kk = (p >> 2) / hm;
    float v = 0.0f;
    if (j < hs) {
      const size_t col = (size_t)g * H + u0 + j;
      v = kk < din ? a.wx[(size_t)kk * 4 * H + col]
                   : a.wh[(size_t)(kk - din) * 4 * H + col];
    }
    ws[p] = v;
  }
  for (int p = tid; p < hm * 4; p += kThreads) {
    const int g = p & 3, j = p >> 2;
    bs[p] = j < hs ? a.bias[g * H + u0 + j] : 0.0f;
  }
  Ring ring{};
  if constexpr (kPaged)
    ring = ring_make(smem + lay.ring, reinterpret_cast<uint64_t*>(smem + lay.bars),
                     a.depth, (wr + kTileRows) * td,
                     kLog ? a.proto : nullptr);
  // peers' shared memory is live before the first DSMEM store
  cluster::sync();

  float* h_st = a.h_store + (size_t)b * a.G * H;
  float* c_st = a.c_store + (size_t)b * a.G * H;
  const size_t scratch = (size_t)(b * kCluster + rank) * n * hmp;
  float* hdst = lay.rows_smem ? smem + lay.hs : a.h_rows + scratch;
  float* cdst = lay.rows_smem ? smem + lay.cs : a.c_rows + scratch;
  const int nrw = (n + wr - 1) / wr;           // row windows
  const int ncw = kPaged ? (hs + td - 1) / td : 0;  // own column windows
  const int nw = ncw * nrw;                    // windows a live tile
  const int ntiles = (n + kTileRows - 1) / kTileRows;
  const bool vec = u0 % 4 == 0 && hs % 4 == 0;  // float4 store rows
  int buf = 0;
  constexpr int kGather = 8;

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

    if (t + 1 < a.T) {  // the next step's inputs into L2 while this one runs
      const size_t nt = bt + 1;
      prefetch_l2(a.x + nt * n * din, sizeof(float) * n * din, rank);
      prefetch_l2(a.idx + nt * n * k, sizeof(int) * n * k, rank);
      prefetch_l2(a.coef + nt * n * k, sizeof(float) * n * k, rank);
      prefetch_l2(a.rowg + nt * n, sizeof(int) * n, rank);
      prefetch_l2(a.mask + nt * n, sizeof(float) * n, rank);
      if (a.emsg != nullptr) {
        prefetch_l2(a.eidx + nt * n * k, sizeof(int) * n * k, rank);
        prefetch_l2(a.emsg + nt * a.e * din, sizeof(float) * a.e * din, rank);
      }
    }
    // 1. the step's live tiles; gather the own units' t-1 rows out of the
    // stores, kGather items' loads in flight a thread (float4 items where
    // the slice is 16-byte aligned); zero the dead tiles' rows
    live_bits(mask, n, 0, s_live);
    if (vec) {
      const int per_row = hs / 4, items = n * per_row;
      for (int p0 = tid; p0 < items; p0 += kGather * kThreads) {
        float4 hv[kGather], cv[kGather];
#pragma unroll
        for (int q = 0; q < kGather; ++q) {
          const int p = p0 + q * kThreads;
          hv[q] = cv[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const int v = p / per_row, j4 = p - v * per_row;
          const int g = p < items ? rowg[v] : -1;
          if (g >= 0 && g < a.G) {
            const float m = mask[v];
            const size_t at = (size_t)g * H + u0 + 4 * j4;
            const float4 h4 = *reinterpret_cast<const float4*>(h_st + at);
            const float4 c4 = *reinterpret_cast<const float4*>(c_st + at);
            hv[q] = make_float4(__fmul_rn(h4.x, m), __fmul_rn(h4.y, m),
                                __fmul_rn(h4.z, m), __fmul_rn(h4.w, m));
            cv[q] = make_float4(__fmul_rn(c4.x, m), __fmul_rn(c4.y, m),
                                __fmul_rn(c4.z, m), __fmul_rn(c4.w, m));
          }
        }
#pragma unroll
        for (int q = 0; q < kGather; ++q) {
          const int p = p0 + q * kThreads;
          if (p < items) {
            const int v = p / per_row, j4 = p - v * per_row;
            *reinterpret_cast<float4*>(hdst + (size_t)v * hmp + 4 * j4) = hv[q];
            *reinterpret_cast<float4*>(cdst + (size_t)v * hmp + 4 * j4) = cv[q];
          }
        }
      }
    } else {
      for (int p0 = tid; p0 < n * hs; p0 += kGather * kThreads) {
        float hv[kGather], cv[kGather];
#pragma unroll
        for (int q = 0; q < kGather; ++q) {
          const int p = p0 + q * kThreads;
          hv[q] = cv[q] = 0.0f;
          const int v = p / hs, j = p - v * hs;
          const int g = p < n * hs ? rowg[v] : -1;
          if (g >= 0 && g < a.G) {
            const float m = mask[v];
            hv[q] = __fmul_rn(h_st[(size_t)g * H + u0 + j], m);
            cv[q] = __fmul_rn(c_st[(size_t)g * H + u0 + j], m);
          }
        }
#pragma unroll
        for (int q = 0; q < kGather; ++q) {
          const int p = p0 + q * kThreads;
          if (p < n * hs) {
            const int v = p / hs, j = p - v * hs;
            hdst[(size_t)v * hmp + j] = hv[q];
            cdst[(size_t)v * hmp + j] = cv[q];
          }
        }
      }
    }
    if constexpr (kPaged) publish_global();
    __syncthreads();

    // the step's tiles, a chunk of kChunkTiles at a time (one chunk up to n
    // 65,536, whose bits are taken above)
    for (int q0 = 0; q0 < ntiles; q0 += kChunkTiles) {
      if (q0 > 0) live_bits(mask, n, q0, s_live);
      const int qend = chunk_end(q0, n);
      const int vend = min(qend * kTileRows, n);
      // paged: the chunk's sweep, nw windows a live tile; warp 0 issues them
      // in order (lane 0 the copies), tracking the tile it has reached
      int total = 0, issued = 0, p_tile = q0 - 1, p_w = 0;
      if constexpr (kPaged) total = count_live(s_live) * nw;
      const unsigned sweep0 = ring.seq;
      auto issue_next = [&]() {  // warp 0
        if (p_w == 0) p_tile = next_live(s_live, q0, p_tile + 1, n);
        if ((tid & 31) == 0) {
          const unsigned seq = sweep0 + (unsigned)issued;
          const int cw = p_w / nrw, rw = p_w - cw * nrw;
          float* slot = ring_slot(ring, seq);
          const uint32_t hbytes = (uint32_t)wr * td * sizeof(float);
          const uint32_t cbytes = rw == 0 ? kTileRows * td * sizeof(float) : 0u;
          const uint32_t bar = ring_issue(ring, seq, issued, hbytes + cbytes);
          const int plane = b * kCluster + (int)rank;
          hopper::tma_load_3d(hopper::smem_u32(slot), &hmap, bar, cw * td,
                              rw * wr, plane);
          if (rw == 0)
            hopper::tma_load_3d(hopper::smem_u32(slot + (size_t)wr * td), &cmap,
                                bar, cw * td, p_tile * kTileRows, plane);
        }
        ++issued;
        if (++p_w == nw) p_w = 0;
      };
      if constexpr (kPaged) {
        if (tid < 32)
          while (issued < total && issued < a.depth) issue_next();
      }

      // all-padding tiles: h' = c' = 0 (after the gather's barrier; the
      // tiles below write other rows), a thread a row
      for (int v0 = q0 * kTileRows + tid; v0 < vend; v0 += kGather * kThreads) {
        int g[kGather];
#pragma unroll
        for (int i = 0; i < kGather; ++i) {
          const int v = v0 + i * kThreads;
          g[i] = v < vend && !tile_live(s_live, q0, v / kTileRows) ? rowg[v]
                                                                    : -2;
        }
#pragma unroll
        for (int i = 0; i < kGather; ++i) {
          if (g[i] == -2) continue;
          const int v = v0 + i * kThreads;
          const bool store = g[i] >= 0 && g[i] < a.G;
          for (int j = 0; j < hs; ++j) {
            out[(size_t)v * H + u0 + j] = 0.0f;
            if (store) {
              h_st[(size_t)g[i] * H + u0 + j] = 0.0f;
              c_st[(size_t)g[i] * H + u0 + j] = 0.0f;
            }
          }
        }
      }

      // 2. the live tiles: aggregate the own columns of agg_x and agg_h,
      // all-gather the tile (DSMEM; one cluster barrier), gate product and
      // LSTM update of the own units
      for (int q = next_live(s_live, q0, q0, n); q < qend;
           q = next_live(s_live, q0, q + 1, n)) {
        const int r0 = q * kTileRows;
        float* tile = tiles + (size_t)buf * K * kTileStride;
        load_ell_tile(idx, coef, emsg != nullptr ? eidx : nullptr, mask,
                      rowg, r0, n, k, s_idx, s_coef,
                      emsg != nullptr ? s_eidx : nullptr, s_mask, s_rowg, s_cnt,
                      tid, kThreads);
        __syncthreads();
        for (int p = tid; p < kTileRows * xs; p += kThreads) {
          const int r = p / xs, c = p - r * xs;
          tile[(size_t)(x0 + c) * kTileStride + r] = cluster::ell_sum(
              x, din, emsg, din, s_idx + r * k, s_coef + r * k,
              emsg != nullptr ? s_eidx + r * k : nullptr, s_cnt[r], x0 + c);
        }
        if constexpr (kPaged) {
          float* ct = smem + lay.ct;
          for (int w = 0; w < nw; ++w) {
            const unsigned seq = ring.seq;
            ring_wait(ring, seq, (int)(seq - sweep0));
            const float* slot = ring_slot(ring, seq);
            const int cw = w / nrw, rw = w - cw * nrw;
            const int wc = min(td, hs - cw * td);
            const int lo = rw * wr, hi = min(lo + wr, n);
            for (int p = tid; p < kTileRows * ((wc + 3) / 4); p += kThreads) {
              const int r = p % kTileRows, c0 = (p / kTileRows) * 4;
              float* dst = tile + (size_t)(din + u0 + cw * td + c0) * kTileStride + r;
              float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              if (rw != 0)
                acc = make_float4(dst[0], dst[kTileStride],
                                  dst[2 * kTileStride], dst[3 * kTileStride]);
              acc = ell_window4(acc, slot, td, lo, hi, s_idx + r * k,
                                s_coef + r * k, s_cnt[r], c0);
              const float a4[4] = {acc.x, acc.y, acc.z, acc.w};
              for (int c = 0; c < 4 && c0 + c < wc; ++c) {
                dst[c * kTileStride] = a4[c];
                if (rw == 0)
                  ct[(size_t)(cw * td + c0 + c) * kTileStride + r] =
                      slot[(size_t)(wr + r) * td + c0 + c];
              }
            }
            ring.seq = seq + 1;
            __syncthreads();
            if (tid < 32 && issued < total) issue_next();
          }
        } else {
          for (int p = tid; p < kTileRows * ((hs + 3) / 4); p += kThreads) {
            const int r = p % kTileRows, c0 = (p / kTileRows) * 4;
            float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            for (int lo = 0; lo < n; lo += wr)
              acc = ell_window4(acc, hdst + (size_t)lo * hmp, hmp, lo,
                                min(lo + wr, n), s_idx + r * k,
                                s_coef + r * k, s_cnt[r], c0);
            const float a4[4] = {acc.x, acc.y, acc.z, acc.w};
            for (int c = 0; c < 4 && c0 + c < hs; ++c)
              tile[(size_t)(din + u0 + c0 + c) * kTileStride + r] = a4[c];
          }
        }
        __syncthreads();
        broadcast_cols(tile, x0, xs, rank, tid, kThreads);
        broadcast_cols(tile, din + u0, hs, rank, tid, kThreads);
        cluster::sync();
        const float* ct = smem + lay.ct;
        // the LSTM update of unit j at tile row r from its four gate sums
        auto lstm = [&](int r, int j, float gi, float gf, float gg, float go) {
          const int v = r0 + r;
          if (v >= n || j >= hs) return;
          const float m = mask[v];
          const float c = kPaged ? ct[(size_t)j * kTileStride + r]
                                 : cdst[(size_t)v * hmp + j];
          const float c_new = __fmul_rn(
              __fmaf_rn(sigmoidf(gf), c, __fmul_rn(sigmoidf(gi), tanhf(gg))), m);
          const float h_new = __fmul_rn(__fmul_rn(sigmoidf(go), tanhf(c_new)), m);
          out[(size_t)v * H + u0 + j] = h_new;
          const int g = rowg[v];
          if (g >= 0 && g < a.G) {
            h_st[(size_t)g * H + u0 + j] = h_new;
            c_st[(size_t)g * H + u0 + j] = c_new;
          }
        };
        for (int p = tid; p < kRowGroups * hs; p += kThreads) {
          const int rg = p / hs, j = p - rg * hs;
          const float4 bg = *reinterpret_cast<const float4*>(bs + j * 4);
          float acc[4][kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[0][r] = bg.x; acc[1][r] = bg.y; acc[2][r] = bg.z; acc[3][r] = bg.w;
          }
          const float* ap = tile + rg * kRows;
          const float* wp = ws + (size_t)j * 4;
#pragma unroll 4
          for (int kk = 0; kk < K; ++kk) {
            const float4 av = *reinterpret_cast<const float4*>(ap + (size_t)kk * kTileStride);
            const float4 w = *reinterpret_cast<const float4*>(wp + (size_t)kk * hm * 4);
            const float a4[kRows] = {av.x, av.y, av.z, av.w};
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              acc[0][r] = fmaf(a4[r], w.x, acc[0][r]);
              acc[1][r] = fmaf(a4[r], w.y, acc[1][r]);
              acc[2][r] = fmaf(a4[r], w.z, acc[2][r]);
              acc[3][r] = fmaf(a4[r], w.w, acc[3][r]);
            }
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            lstm(rg * kRows + r, j, acc[0][r], acc[1][r], acc[2][r], acc[3][r]);
        }
        buf ^= 1;
      }
    }
    // the step's store writes before the next step's gather reads them
    __syncthreads();
  }
  // no CTA leaves while a peer could still reach its shared memory
  cluster::sync();
}

template <bool kPaged>
int launch(const GcrnArgs& a, int B, void* stream) {
  if (a.H % 4 != 0) return (int)cudaErrorInvalidValue;
  const Layout lay = layout(kPaged, a.k, a.din, a.H, a.n, a.td, a.depth);
  if (!lay.rows_smem && (a.h_rows == nullptr || a.c_rows == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap hmap{}, cmap{};
  if (kPaged) {
    cudaError_t err = f32_map_3d(&hmap, a.h_rows, lay.hmp, a.n, B * kCluster,
                                 a.td, lay.wr);
    if (err == cudaSuccess)
      err = f32_map_3d(&cmap, a.c_rows, lay.hmp, a.n, B * kCluster, a.td,
                       kTileRows);
    if (err != cudaSuccess) return (int)err;
  }
  // a launch with a protocol log runs the paged kernel's logging build;
  // the main path's (proto null) holds no logging code, and a resident
  // one has no ring to log
  if (a.proto != nullptr)
    return cluster::launch(gcrn_engine_kernel<kPaged, kPaged>, B, kThreads,
                           lay.bytes, stream, hmap, cmap, a);
  return cluster::launch(gcrn_engine_kernel<kPaged>, B, kThreads, lay.bytes,
                         stream, hmap, cmap, a);
}

GcrnArgs make_args(const void* idx, const void* coef, const void* eidx,
                   const void* x, const void* rowg, const void* mask,
                   const void* wx, const void* wh, const void* bias,
                   const void* emsg, void* out, void* h_store, void* c_store,
                   void* h_rows, void* c_rows, void* proto, int T, int n,
                   int k, int din, int H, int G, int e) {
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
  a.proto = static_cast<int*>(proto);
  a.T = T; a.n = n; a.k = k; a.din = din; a.H = H; a.G = G; a.e = e;
  a.td = 1; a.depth = 1;
  return a;
}

// The launch's shape into out: cluster size, CTAs, threads a CTA, dynamic
// shared memory a CTA, clusters the card holds at once (-1: unknown), then
// the C + 1 bounds of the unit slices and the C + 1 of the input columns.
template <bool kPaged>
int cluster_config(int B, int k, int din, int H, int n, int td, int depth,
                   int* out) {
  const Layout lay = layout(kPaged, k, din, H, n, td, depth);
  out[0] = kCluster;
  out[1] = B * kCluster;
  out[2] = kThreads;
  out[3] = (int)lay.bytes;
  out[4] = max_active_clusters(gcrn_engine_kernel<kPaged>, kThreads,
                               lay.bytes);
  for (int r = 0; r <= kCluster; ++r) {
    out[5 + r] = slice_lo(H, r);
    out[6 + kCluster + r] = slice_lo(din, r);
  }
  return 0;
}

}  // namespace

extern "C" {

size_t gcrn_engine_smem_bytes(int k, int din, int H, int n) {
  return layout(false, k, din, H, n, 1, 1).bytes;
}

size_t gcrn_engine_paged_smem_bytes(int k, int din, int H, int n, int td,
                                    int depth) {
  return layout(true, k, din, H, n, td, depth).bytes;
}

int gcrn_engine_cluster_config(int B, int k, int din, int H, int n,
                               int* out) {
  return cluster_config<false>(B, k, din, H, n, 1, 1, out);
}

int gcrn_engine_paged_cluster_config(int B, int k, int din, int H, int n,
                                     int td, int depth, int* out) {
  return cluster_config<true>(B, k, din, H, n, td, depth, out);
}

int gcrn_engine_launch(const void* idx, const void* coef, const void* eidx,
                       const void* x, const void* rowg, const void* mask,
                       const void* wx, const void* wh, const void* bias,
                       const void* emsg, void* out, void* h_store,
                       void* c_store, void* h_rows, void* c_rows, void* proto,
                       int B, int T, int n, int k, int din, int H, int G, int e,
                       void* stream) {
  const GcrnArgs a = make_args(idx, coef, eidx, x, rowg, mask, wx, wh, bias,
                               emsg, out, h_store, c_store, h_rows, c_rows,
                               proto, T, n, k, din, H, G, e);
  return launch<false>(a, B, stream);
}

int gcrn_engine_paged_launch(const void* idx, const void* coef,
                             const void* eidx, const void* x, const void* rowg,
                             const void* mask, const void* wx, const void* wh,
                             const void* bias, const void* emsg, void* out,
                             void* h_store, void* c_store, void* h_rows,
                             void* c_rows, void* proto, int B, int T, int n,
                             int k, int din, int H, int G, int e, int td,
                             int depth, void* stream) {
  if (td <= 0 || td % 8 != 0 || td > kBoxRows || depth < 1 ||
      depth > engine::kMaxDepth)
    return (int)cudaErrorInvalidValue;
  GcrnArgs a = make_args(idx, coef, eidx, x, rowg, mask, wx, wh, bias, emsg,
                         out, h_store, c_store, h_rows, c_rows, proto, T, n, k,
                         din, H, G, e);
  a.td = td; a.depth = depth;
  return launch<true>(a, B, stream);
}

const char* gcrn_engine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* gcrn_engine_paged_error_string(int code) {
  return gcrn_engine_error_string(code);
}

}  // extern "C"
