// TGN (event-driven node memory) stream engine for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/stream_fused.py, _stream_engine_kernel with
// the tgn cell (_tgn_cell, launch assembly _tgn_build), reached through
// stream_call("tgn", ...), and under hbm_paged residency the engine's
// paged staging (_Engine.stage_in / write_back / paged_fill).
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
// all-padding tiles write zeros.
//
// Design. One thread-block cluster of kCluster CTAs (cluster_common.cuh)
// runs one stream's whole T loop; B streams are B clusters. CTA r owns the
// memory columns (hidden units) [r H / C, (r + 1) H / C):
//   * where they fit beside the tiles it holds its columns of W_in, its
//     units' r | z | n columns of Wx | Wh and b (interleaved [k row][unit]
//     [gate]) and its frequencies in shared memory for the whole stream;
//     past that room (layout().wsmem) it reads the weights from global
//     memory (L2), the same sums;
//   * inp is separable by column: per live node tile (32 rows) the CTA
//     computes its own columns of inp (x @ its W_in columns, its columns of
//     the partners' memory, its frequencies of the time encoding) and reads
//     its own columns of the rows' memory into the k-major tile
//     [inp | own]; the cluster all-gathers the tile (DSMEM, one cluster
//     barrier) and each CTA runs its units' GRU on the whole tile (K = H
//     for both Wx and Wh) as a register micro-tile (4 rows a thread). The
//     tile is double buffered where two fit, as gcrn_engine.cu's; else a
//     second barrier a tile closes its reads;
//   * a batch's partners are touched rows of the same batch, whose memory
//     the batch rewrites: the tile pass writes only out[b, t], and after a
//     block barrier the CTA scatters its columns of the new rows into the
//     store (gather before scatter). A unit's memory is read and written by
//     its own CTA only, so no state crosses CTAs but through the all-gather.
// agg_m runs over the partners in windows of wr <= kBoxRows local ids (the
// windows the paged variant stages), each window's lanes in order, so both
// variants sum alike: the resident kernel takes each lane's local id
// beside its global row.
//
// The argument of cos reaches ~137 rad on BC-Alpha (ts up to 136.5,
// freq_0 = 1): the kernel calls cosf with its full range reduction, never
// the __cosf intrinsic, and is built without --use_fast_math.
//
// Paged variant (hbm_paged residency, tgn_engine_paged_launch): the same
// kernel compiled with kPaged. Each batch first gathers its touched rows'
// t-1 memory of the own units into per-CTA global scratch ((B C, n, hmp),
// masked, as the own rows are read), then each live tile reads them back
// through a depth-deep ring of windows (cluster_common.cuh): a window is a
// TMA box of up to kBoxRows gathered rows x td of the own columns (the
// partners, by local id), the first row window of a column window also
// brings the tile's own 32 rows; the ring runs across the batch's live
// tiles. No buffer grows with n. Outputs and the final store are
// bit-identical to the resident kernel's under the event contract (every
// live lane names a touched row).
//
// Profile marks. A line `// PROF(i) <phase>` closes phase i; the comments
// are inert here. tools/cluster_engine_profile.py builds a copy in which
// they (with PROF_INIT / PROF_END) become clock64 marks: move one with the
// code whose end it marks.
//
// What bounds it. The recurrence is serial in t; a stream spreads over
// kCluster SMs. The card's roofline is set by the per-batch bytes; the
// kernel is bound by latency: a live tile's ELL loads, the partners'
// gathers from L2, the time encoding, the cluster barrier and the GRU's K
// loop (2 H rows of 3 gates x 4 rows a thread).
#include "cluster_common.cuh"

using engine::kTileRows;
using engine::kTileStride;
using namespace cluster;

namespace {

struct TgnArgs {
  const int* gidx;    // resident: (B, T, n, k) each lane's partner, its
                      // global row; paged: null
  const int* lid;     // (B, T, n, k) each lane's partner, its local id
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
  float* rows;        // paged: (B C, n, hmp) scratch, the batch's t-1 rows
  int T, n, k, din, H, G;
  int td, depth;      // paged: window width and ring depth
};

// Shared memory of one CTA, in floats from the 128-byte aligned base.
struct Layout {
  int hm, hmp, wr, nbuf;
  bool wsmem;  // the own weights in shared memory
  size_t ring, xt, tiles, am, wins, ws, bs, xch, fs, lid, coef, ts, gidx,
      rows, bars;
  size_t bytes;  // dynamic shared memory, alignment slack included
};

__host__ __device__ inline Layout place(bool paged, int k, int din, int H,
                                        int n, int td, int depth, int nbuf,
                                        bool wsmem) {
  Layout L{};
  L.hm = slice_max(H);
  L.hmp = round_up(L.hm, 4);
  // partner windows: local ids [w wr, (w + 1) wr)
  L.wr = round_up(n, 8) < kBoxRows ? round_up(n, 8) : kBoxRows;
  L.nbuf = nbuf;
  L.wsmem = wsmem;
  size_t o = 0;
  if (paged) {
    L.ring = o;  // depth slots: wr gathered rows, then the tile's 32 rows
    o += (size_t)depth * (L.wr + kTileRows) * td;
  }
  L.xt = o;  // the tile's features, k-major (din, kTileStride)
  o += (size_t)din * kTileStride;
  L.tiles = o;  // nbuf k-major (2H, kTileStride) tiles [inp | own]
  o += (size_t)nbuf * 2 * H * kTileStride;
  if (paged) {
    L.am = o;  // the own columns' partner sums between row windows
    o += (size_t)L.hm * kTileStride;
  }
  if (wsmem) {
    L.wins = o;  // own columns of W_in, (din, hm)
    o += (size_t)din * L.hm;
    L.ws = o;  // own units of Wx then Wh, [k row][unit][gate], and of b
    o += (size_t)2 * H * L.hm * 3;
    L.bs = o;
    o += (size_t)L.hm * 3;
  }
  L.xch = 0;  // the GRU's split K loop's exchange (a CTA of <= 16 units)
  if (L.hm <= kSplitUnits) {
    L.xch = o;
    o += kSplitFloats;
  }
  L.fs = o;  // own frequencies
  o += L.hm;
  L.lid = o;  // the ELL lanes: local id, coef, time bits; resident: row
  o += (size_t)kTileRows * k;
  L.coef = o;
  o += (size_t)kTileRows * k;
  L.ts = o;
  o += (size_t)kTileRows * k;
  if (!paged) {
    L.gidx = o;
    o += (size_t)kTileRows * k;
  }
  L.rows = o;  // a tile's mask for each buffer, live lane counts; live bits
  o += 3 * kTileRows + kLiveWords;
  o = round_up((int)o, 2);  // the ring's mbarriers: 8-byte aligned
  L.bars = o;
  if (paged) o += engine::kRingBarBytes / sizeof(float);
  L.bytes = kAlignSlack + o * sizeof(float);
  return L;
}

// Two tile buffers where they fit, then the own weights where they fit.
__host__ __device__ inline Layout layout(bool paged, int k, int din, int H,
                                         int n, int td, int depth) {
  Layout L = place(paged, k, din, H, n, td, depth, 2, false);
  if (L.bytes > kSmemLimit) L = place(paged, k, din, H, n, td, depth, 1, false);
  const Layout W = place(paged, k, din, H, n, td, depth, L.nbuf, true);
  return W.bytes <= kSmemLimit ? W : L;
}

// sum_kk x[kk * kTileStride] * w[kk * ldw], one fmaf chain from 0, the
// loads of kAhead rows issued together (x a k-major tile column).
__device__ __forceinline__ float dot_col(const float* x, int K,
                                        const float* w, int ldw) {
  constexpr int kAhead = 4;
  float acc = 0.0f;
  int kk = 0;
  for (; kk + kAhead <= K; kk += kAhead) {
    float xv[kAhead], wv[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      xv[i] = x[(size_t)(kk + i) * kTileStride];
      wv[i] = w[(size_t)(kk + i) * ldw];
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) acc = fmaf(xv[i], wv[i], acc);
  }
  for (; kk < K; ++kk)
    acc = fmaf(x[(size_t)kk * kTileStride], w[(size_t)kk * ldw], acc);
  return acc;
}

// sum_s coef * cos(ts * f) over a row's packed lanes, in order.
__device__ __forceinline__ float encode(const int* lt, const float* lc,
                                        int cnt, float f) {
  float acc = 0.0f;
  for (int s = 0; s < cnt; ++s)
    acc = __fmaf_rn(lc[s], cosf(__fmul_rn(__int_as_float(lt[s]), f)), acc);
  return acc;
}

template <bool kPaged>
__global__ void __launch_bounds__(kThreads, 1)
    tgn_engine_kernel(const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap omap, TgnArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the 128-byte aligned base, offset from smem_raw (not rebuilt from an
  // integer), so the compiler keeps it a shared-memory pointer: the tiles'
  // and weights' loads compile to LDS, not generic loads
  float* smem = reinterpret_cast<float*>(
      smem_raw + ((128u - hopper::smem_u32(smem_raw)) & 127u));
  const int H = a.H, n = a.n, k = a.k, din = a.din, G = a.G, td = a.td;
  const Layout lay = layout(kPaged, k, din, H, n, td, a.depth);
  const int hm = lay.hm, hmp = lay.hmp, wr = lay.wr;
  const unsigned rank = ctarank();
  const int b = blockIdx.x / kCluster;
  const int u0 = slice_lo(H, rank), hs = slice_lo(H, rank + 1) - u0;
  float* xt = smem + lay.xt;
  float* tiles = smem + lay.tiles;
  float* am = smem + lay.am;
  float* xch = smem + lay.xch;  // the GRU's split K loop, where it has one
  const bool split = lay.xch != 0;
  const float* fs = smem + lay.fs;
  int* s_lid = reinterpret_cast<int*>(smem + lay.lid);
  float* s_coef = smem + lay.coef;
  int* s_ts = reinterpret_cast<int*>(smem + lay.ts);  // float bits
  int* s_gidx = reinterpret_cast<int*>(smem + lay.gidx);
  float* s_rows = smem + lay.rows;  // each buffer's mask, the lane counts
  int* s_cnt = reinterpret_cast<int*>(s_rows + 2 * kTileRows);
  uint32_t* s_live = reinterpret_cast<uint32_t*>(s_rows + 3 * kTileRows);
  const int tid = threadIdx.x;

  if (lay.wsmem) {
    float* wins = smem + lay.wins;
    for (int p = tid; p < din * hm; p += kThreads) {
      const int kk = p / hm, c = p - kk * hm;
      wins[p] = c < hs ? a.w_in[(size_t)kk * H + u0 + c] : 0.0f;
    }
    stage_gru(a.wx, H, a.wh, a.bias, H, u0, hs, hm, smem + lay.ws,
              smem + lay.bs);
  }
  for (int c = tid; c < hm; c += kThreads)
    smem[lay.fs + c] = c < hs ? a.freq[u0 + c] : 0.0f;
  Ring ring{};
  if constexpr (kPaged)
    ring = ring_make(smem + lay.ring,
                     reinterpret_cast<uint64_t*>(smem + lay.bars), a.depth,
                     (wr + kTileRows) * td);
  // peers' shared memory is live before the first DSMEM store
  cluster::sync();
  // PROF_INIT

  float* store = a.store + (size_t)b * G * H;
  const int plane = b * kCluster + (int)rank;
  float* rows_t1 = kPaged ? a.rows + (size_t)plane * n * hmp : nullptr;
  const int nrw = (n + wr - 1) / wr;                // row windows
  const int ncw = kPaged ? (hs + td - 1) / td : 0;  // own column windows
  const int nw = ncw * nrw;                         // windows a live tile
  const int ntiles = (n + kTileRows - 1) / kTileRows;
  int buf = 0;

  for (int t = 0; t < a.T; ++t) {
    const size_t bt = (size_t)b * a.T + t;
    const int* lid = a.lid + bt * n * k;
    const int* gidx = kPaged ? nullptr : a.gidx + bt * n * k;
    const float* coef = a.coef + bt * n * k;
    const int* ts = reinterpret_cast<const int*>(a.ts + bt * n * k);
    const float* x = a.x + bt * n * din;
    const int* rowg = a.rowg + bt * n;
    const float* mask = a.mask + bt * n;
    float* out = a.out + bt * n * H;

    if (t + 1 < a.T) {  // the next batch's inputs into L2 while this one runs
      const size_t nx = bt + 1;
      prefetch_l2(a.x + nx * n * din, sizeof(float) * n * din, rank);
      prefetch_l2(a.lid + nx * n * k, sizeof(int) * n * k, rank);
      if (!kPaged) prefetch_l2(a.gidx + nx * n * k, sizeof(int) * n * k, rank);
      prefetch_l2(a.coef + nx * n * k, sizeof(float) * n * k, rank);
      prefetch_l2(a.ts + nx * n * k, sizeof(float) * n * k, rank);
      prefetch_l2(a.rowg + nx * n, sizeof(int) * n, rank);
      prefetch_l2(a.mask + nx * n, sizeof(float) * n, rank);
    }
    if constexpr (kPaged) {
      // the batch's t-1 rows of the own units into the CTA's scratch, which
      // the ring reads through the async proxy
      gather_own(store, G, H, u0, hs, rowg, mask, n, rows_t1, hmp);
      publish_global();
    }
    // PROF(0) row gather

    // 1. the batch's tiles, a chunk of kChunkTiles at a time (one chunk up
    // to n 65,536): every read of the t-1 store, no write to it
    for (int q0 = 0; q0 < ntiles; q0 += kChunkTiles) {
      live_bits(mask, n, q0, s_live);
      // PROF(1) live bits
      const int qend = chunk_end(q0, n);
      const int vend = min(qend * kTileRows, n);
      // paged: the chunk's sweep, nw windows a live tile; warp 0 issues
      // them in order (lane 0 the copies), tracking the tile it reached
      int total = 0, issued = 0, p_tile = q0 - 1, p_w = 0;
      if constexpr (kPaged) total = count_live(s_live) * nw;
      const unsigned sweep0 = ring.seq;
      auto issue_next = [&]() {  // warp 0
        if (p_w == 0) p_tile = next_live(s_live, q0, p_tile + 1, n);
        if ((tid & 31) == 0) {
          const unsigned seq = sweep0 + (unsigned)issued;
          const int cw = p_w / nrw, rw = p_w - cw * nrw;
          float* slot = ring_slot(ring, seq);
          const uint32_t bar = ring_bar(ring, seq);
          const uint32_t pbytes = (uint32_t)wr * td * sizeof(float);
          const uint32_t obytes = rw == 0 ? kTileRows * td * sizeof(float) : 0u;
          hopper::mbar_expect_tx(bar, pbytes + obytes);
          hopper::tma_load_3d(hopper::smem_u32(slot), &wmap, bar, cw * td,
                              rw * wr, plane);
          if (rw == 0)
            hopper::tma_load_3d(hopper::smem_u32(slot + (size_t)wr * td),
                                &omap, bar, cw * td, p_tile * kTileRows,
                                plane);
        }
        ++issued;
        if (++p_w == nw) p_w = 0;
      };
      if constexpr (kPaged) {
        if (tid < 32)
          while (issued < total && issued < a.depth) issue_next();
      }

      // all-padding tiles: m' = 0 (the live tiles below write other rows)
      zero_dead_rows(out, nullptr, G, H, u0, hs, rowg, s_live, q0, vend);
      // PROF(2) dead tiles

      // the live tiles
      for (int q = next_live(s_live, q0, q0, n); q < qend;
           q = next_live(s_live, q0, q + 1, n)) {
        const int r0 = q * kTileRows;
        float* tile = tiles + (size_t)buf * 2 * H * kTileStride;
        // the tile's mask, by buffer: the next tile's load writes the other
        // while slower warps may still be in this tile's epilogue
        float* s_mask = s_rows + buf * kTileRows;
        load_ell_tile(lid, coef, ts, mask, nullptr, r0, n, k, s_lid, s_coef,
                      s_ts, s_mask, nullptr, s_cnt, tid, kThreads, gidx,
                      kPaged ? nullptr : s_gidx);
        load_rows_kmajor(x, din, r0, n, xt);
        if constexpr (!kPaged)  // the own columns of the rows' t-1 memory
          own_rows(store, G, H, u0, hs, rowg, mask, r0, n, tile, H + u0);
        __syncthreads();
        // PROF(3) ELL + x + own rows
        // x @ W_in of the own columns, one fmaf chain a value
        auto xw = [&](int r, int c) {
          return lay.wsmem
                     ? dot_col(xt + r, din, smem + lay.wins + c, hm)
                     : dot_col(xt + r, din, a.w_in + u0 + c, H);
        };
        if constexpr (kPaged) {
          for (int p = tid; p < kTileRows * hs; p += kThreads) {
            const int r = p / hs, c = p - r * hs;
            tile[(size_t)(u0 + c) * kTileStride + r] = xw(r, c);
          }
          __syncthreads();
          // partners and own rows, window by window through the ring
          for (int w = 0; w < nw; ++w) {
            const unsigned seq = ring.seq;
            ring_wait(ring, seq);
            const float* slot = ring_slot(ring, seq);
            const int cw = w / nrw, rw = w - cw * nrw;
            const int wc = min(td, hs - cw * td);
            const int lo = rw * wr, hi = min(lo + wr, n);
            for (int p = tid; p < kTileRows * wc; p += kThreads) {
              const int r = p / wc, c = p - r * wc, col = cw * td + c;
              const int* li = s_lid + r * k;
              float acc = rw == 0 ? 0.0f : am[(size_t)col * kTileStride + r];
              acc = ell_window(acc, slot, td, li, lo, li, lo, hi,
                               s_coef + r * k, s_cnt[r], c);
              float* dst = tile + (size_t)(u0 + col) * kTileStride + r;
              if (rw == nrw - 1)
                *dst = __fadd_rn(__fadd_rn(*dst, acc),
                                 encode(s_ts + r * k, s_coef + r * k,
                                        s_cnt[r], fs[col]));
              else
                am[(size_t)col * kTileStride + r] = acc;
              if (rw == 0)
                tile[(size_t)(H + u0 + col) * kTileStride + r] =
                    slot[(size_t)(wr + r) * td + c];
            }
            ring.seq = seq + 1;
            __syncthreads();
            if (tid < 32 && issued < total) issue_next();
          }
        } else {
          for (int p = tid; p < kTileRows * hs; p += kThreads) {
            const int r = p / hs, c = p - r * hs;
            const float acc =
                ell_windows(store, H, s_gidx + r * k, s_lid + r * k, wr, n,
                            s_coef + r * k, s_cnt[r], u0 + c);
            tile[(size_t)(u0 + c) * kTileStride + r] = __fadd_rn(
                __fadd_rn(xw(r, c), acc),
                encode(s_ts + r * k, s_coef + r * k, s_cnt[r], fs[c]));
          }
          __syncthreads();
        }
        // PROF(4) inp (+ windows)
        broadcast_cols(tile, u0, hs, rank, tid, kThreads);
        broadcast_cols(tile, H + u0, hs, rank, tid, kThreads);
        cluster::sync();
        // PROF(5) all-gather + barrier
        // the GRU of the own units on [inp | own]; m' into out
        auto epi = [&](int r, int j, float m) {
          const int v = r0 + r;
          if (v < n) out[(size_t)v * H + u0 + j] = __fmul_rn(m, s_mask[r]);
        };
        if (lay.wsmem)
          gru_units<true>(tile, 0, H, H, H, u0, hs, hm, smem + lay.ws,
                          smem + lay.bs, nullptr, nullptr, nullptr, xch, split,
                          tid, kThreads, epi);
        else
          gru_units<false>(tile, 0, H, H, H, u0, hs, hm, nullptr, nullptr,
                           a.wx, a.wh, a.bias, xch, split, tid, kThreads,
                           epi);
        // PROF(8) GRU
        if (lay.nbuf == 1)
          cluster::sync();  // every CTA's reads of the tile are done
        else
          buf ^= 1;
      }
    }
    __syncthreads();
    // PROF(6) batch end

    // 2. every read of the batch is done: scatter the own columns of the
    // new rows (G drops)
    scatter_own(out, store, G, H, u0, hs, rowg, n);
    __syncthreads();
    // PROF(9) scatter
  }
  // PROF_END
  // no CTA leaves while a peer could still reach its shared memory
  cluster::sync();
}

template <bool kPaged>
int launch(const TgnArgs& a, int B, void* stream) {
  if (a.H % 4 != 0) return (int)cudaErrorInvalidValue;
  const Layout lay = layout(kPaged, a.k, a.din, a.H, a.n, a.td, a.depth);
  if (lay.bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap wmap{}, omap{};
  if (kPaged) {
    if (a.rows == nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t err = f32_map_3d(&wmap, a.rows, lay.hmp, a.n, B * kCluster,
                                 a.td, lay.wr);
    if (err == cudaSuccess)
      err = f32_map_3d(&omap, a.rows, lay.hmp, a.n, B * kCluster, a.td,
                       kTileRows);
    if (err != cudaSuccess) return (int)err;
  } else if (a.gidx == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return cluster::launch(tgn_engine_kernel<kPaged>, B, kThreads, lay.bytes,
                         stream, wmap, omap, a);
}

TgnArgs make_args(const void* gidx, const void* lid, const void* coef,
                  const void* ts, const void* x, const void* rowg,
                  const void* mask, const void* freq, const void* w_in,
                  const void* wx, const void* wh, const void* bias, void* out,
                  void* store, void* rows, int T, int n, int k, int din,
                  int H, int G) {
  TgnArgs a;
  a.gidx = static_cast<const int*>(gidx);
  a.lid = static_cast<const int*>(lid);
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
  a.rows = static_cast<float*>(rows);
  a.T = T; a.n = n; a.k = k; a.din = din; a.H = H; a.G = G;
  a.td = 1; a.depth = 1;
  return a;
}

// The launch's shape into out: cluster size, CTAs, threads a CTA, dynamic
// shared memory a CTA, clusters the card holds at once (-1: unknown), the
// C + 1 bounds of the unit slices, then (past C + 1 unused slots, the input
// columns of the other engines) the own weights in shared memory (1) or
// not (0).
template <bool kPaged>
int cluster_config(int B, int k, int din, int H, int n, int td, int depth,
                   int* out) {
  const Layout lay = layout(kPaged, k, din, H, n, td, depth);
  out[0] = kCluster;
  out[1] = B * kCluster;
  out[2] = kThreads;
  out[3] = (int)lay.bytes;
  out[4] = max_active_clusters(tgn_engine_kernel<kPaged>, kThreads,
                               lay.bytes);
  for (int r = 0; r <= kCluster; ++r) out[5 + r] = slice_lo(H, r);
  out[7 + 2 * kCluster] = lay.wsmem ? 1 : 0;
  return 0;
}

}  // namespace

extern "C" {

size_t tgn_engine_smem_bytes(int k, int din, int H) {
  return layout(false, k, din, H, 1, 1, 1).bytes;
}

size_t tgn_engine_paged_smem_bytes(int k, int din, int H, int n, int td,
                                   int depth) {
  return layout(true, k, din, H, n, td, depth).bytes;
}

int tgn_engine_cluster_config(int B, int k, int din, int H, int* out) {
  return cluster_config<false>(B, k, din, H, 1, 1, 1, out);
}

int tgn_engine_paged_cluster_config(int B, int k, int din, int H, int n,
                                    int td, int depth, int* out) {
  return cluster_config<true>(B, k, din, H, n, td, depth, out);
}

int tgn_engine_launch(const void* gidx, const void* idx, const void* coef,
                      const void* ts, const void* x, const void* rowg,
                      const void* mask, const void* freq, const void* w_in,
                      const void* wx, const void* wh, const void* bias,
                      void* out, void* store, int B, int T, int n, int k,
                      int din, int H, int G, void* stream) {
  const TgnArgs a = make_args(gidx, idx, coef, ts, x, rowg, mask, freq, w_in,
                              wx, wh, bias, out, store, nullptr, T, n, k, din,
                              H, G);
  return launch<false>(a, B, stream);
}

int tgn_engine_paged_launch(const void* idx, const void* coef, const void* ts,
                            const void* x, const void* rowg, const void* mask,
                            const void* freq, const void* w_in,
                            const void* wx, const void* wh, const void* bias,
                            void* out, void* store, void* rows, int B, int T,
                            int n, int k, int din, int H, int G, int td,
                            int depth, void* stream) {
  if (td <= 0 || td % 8 != 0 || td > kBoxRows || depth < 1 ||
      depth > engine::kMaxDepth)
    return (int)cudaErrorInvalidValue;
  TgnArgs a = make_args(nullptr, idx, coef, ts, x, rowg, mask, freq, w_in, wx,
                        wh, bias, out, store, rows, T, n, k, din, H, G);
  a.td = td; a.depth = depth;
  return launch<true>(a, B, stream);
}

const char* tgn_engine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* tgn_engine_paged_error_string(int code) {
  return tgn_engine_error_string(code);
}

}  // extern "C"
