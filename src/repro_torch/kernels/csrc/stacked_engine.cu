// Stacked DGNN (GCN -> GRU) stream engine for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/stream_fused.py, _stream_engine_kernel with
// the stacked cell (_stacked_cell, launch assembly _stacked_build), reached
// through stream_call("stacked", ...), and under hbm_paged residency the
// engine's paged staging (_Engine.stage_in / write_back / paged_fill).
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
// Design. One thread-block cluster of kCluster CTAs (cluster_common.cuh)
// runs one stream's whole T loop; B streams are B clusters. CTA r owns the
// hidden units [r H / C, (r + 1) H / C), the input columns
// [r din / C, (r + 1) din / C) and the node-transform columns
// [r dmid / C, (r + 1) dmid / C):
//   * where they fit beside the tiles it holds its columns of Wg and bg and
//     its units' r | z | n columns of Wx | Wh and b in shared memory for
//     the whole stream, interleaved [k row][unit][gate] (a unit's three
//     gate weights together); past that room (layout().wsmem) it reads them
//     from global memory (L2), the same sums;
//   * the only t-1 state a row reads is its own h, so a tile reads its
//     rows' own units from the store and its epilogue writes them back:
//     rows are distinct within a step, and a unit's rows are read and
//     written by its own CTA only;
//   * per live node tile (32 rows) it aggregates its input columns of agg
//     (the ELL sum is separable by column) and reads its units' h into the
//     k-major tile [agg | nt | h], copies both into every peer's tile
//     (DSMEM) and, after a cluster barrier, computes its columns of nt on
//     the whole agg; a second all-gather and barrier give every CTA the
//     whole nt, and it runs its units' GRU on [nt | h] as a register
//     micro-tile (4 rows a thread) with the update fused behind it.
//     The tile is double buffered where two fit (one cluster barrier a
//     phase suffices: a peer writes a buffer again only after every CTA
//     passed the next tile's barriers, which each reaches after its reads
//     of this one); else a third barrier a tile closes its reads. The tile's
//     ELL lanes sit in its nt columns until nt is computed there, which
//     keeps the widest plans (dmid = H = 736, or dmid 128 and H 1,348 at
//     k 27, din 64) within the CTA.
// nt's choice: sliced over dmid as above, against every CTA computing the
// whole nt (din x dmid FMA a row, Wg read from L2, one barrier a tile),
// in turns on an H100 80GB HBM3 at 700 W, BC-Alpha's 137 steps: sliced
// 9.38 / 9.39 ms at B 1 and 9.56 / 9.64 at B 4, whole 16.73 / 16.66 and
// 16.84 / 16.97 (see PERF.md).
//
// Paged variant (hbm_paged residency, stacked_engine_paged_launch): the
// same kernel compiled with kPaged. Each step gathers its rows' own units
// of t-1 h into per-CTA global scratch ((B C, n, hmp)), and a live tile
// reads its 32 rows back through a depth-deep ring of TMA boxes (32 rows x
// td of the CTA's own columns), running across the step's live tiles. No
// buffer grows with n. Outputs and the final store are bit-identical to the
// resident kernel's.
//
// Profile marks. A line `// PROF(i) <phase>` closes phase i; the comments
// are inert here. tools/cluster_engine_profile.py builds a copy in which
// they (with PROF_INIT / PROF_END) become clock64 marks: move one with the
// code whose end it marks.
//
// What bounds it. The recurrence is serial in t; a stream spreads over
// kCluster SMs. The card's roofline is set by the per-step bytes; the
// kernel is bound by latency: a live tile's ELL loads and gathers from L2,
// two cluster barriers and the GRU's K loop (dmid + H rows of 3 gates x 4
// rows a thread).
#include "cluster_common.cuh"

using engine::kTileRows;
using engine::kTileStride;
using namespace cluster;

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
  float* h_rows;      // paged: (B C, n, hmp) scratch, the gathered t-1 h
  int* proto;         // the ring's protocol log (cluster_common.cuh), or null
  int T, n, k, din, dmid, H, G, e;
  int td, depth;      // paged: window width and ring depth
};

// Shared memory of one CTA, in floats from the 128-byte aligned base.
struct Layout {
  int hm, hmp, mm, ntc, K, hc, nbuf;
  bool wsmem;  // the own weights in shared memory
  size_t ring, tiles, wgs, bgs, ws, bs, xch, rows, bars;
  size_t bytes;  // dynamic shared memory, alignment slack included
};

__host__ __device__ inline Layout place(bool paged, int k, int din, int dmid,
                                        int H, int td, int depth, int nbuf,
                                        bool wsmem) {
  Layout L{};
  L.hm = slice_max(H);
  L.hmp = round_up(L.hm, 4);
  L.mm = slice_max(dmid);
  // nt's columns also hold the tile's ELL lanes (3 words) and lane counts
  const int ell_cols = (3 * kTileRows * k + kTileRows + kTileStride - 1) /
                       kTileStride;
  L.ntc = dmid > ell_cols ? dmid : ell_cols;
  L.hc = din + L.ntc;
  L.K = L.hc + H;  // tile columns [agg | nt | h]
  L.nbuf = nbuf;
  L.wsmem = wsmem;
  size_t o = 0;
  if (paged) {
    L.ring = o;  // depth slots: the tile's 32 rows x td own columns
    o += (size_t)depth * kTileRows * td;
  }
  L.tiles = o;
  o += (size_t)nbuf * L.K * kTileStride;
  if (wsmem) {
    L.wgs = o;  // own columns of Wg, (din, mm), and of bg
    o += (size_t)din * L.mm;
    L.bgs = o;
    o += L.mm;
    L.ws = o;  // own units of Wx then Wh, [k row][unit][gate], and of b
    o += (size_t)(dmid + H) * L.hm * 3;
    L.bs = o;
    o += (size_t)L.hm * 3;
  }
  L.xch = 0;  // the GRU's split K loop's exchange (a CTA of <= 16 units)
  if (L.hm <= kSplitUnits) {
    L.xch = o;
    o += kSplitFloats;
  }
  L.rows = o;  // a tile's mask and row ids for each buffer; the live bits
  o += 4 * kTileRows + kLiveWords;
  o = round_up((int)o, 2);  // the ring's mbarriers: 8-byte aligned
  L.bars = o;
  if (paged) o += engine::kRingBarBytes / sizeof(float);
  L.bytes = kAlignSlack + o * sizeof(float);
  return L;
}

// Two tile buffers where they fit, then the own weights where they fit.
__host__ __device__ inline Layout layout(bool paged, int k, int din, int dmid,
                                         int H, int td, int depth) {
  Layout L = place(paged, k, din, dmid, H, td, depth, 2, false);
  if (L.bytes > kSmemLimit)
    L = place(paged, k, din, dmid, H, td, depth, 1, false);
  const Layout W = place(paged, k, din, dmid, H, td, depth, L.nbuf, true);
  return W.bytes <= kSmemLimit ? W : L;
}

template <bool kPaged, bool kLog = false>
__global__ void __launch_bounds__(kThreads, 1)
    stacked_engine_kernel(const __grid_constant__ CUtensorMap hmap,
                          StackedArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the 128-byte aligned base, offset from smem_raw (not rebuilt from an
  // integer), so the compiler keeps it a shared-memory pointer: the tiles'
  // and weights' loads compile to LDS, not generic loads
  float* smem = reinterpret_cast<float*>(
      smem_raw + ((128u - hopper::smem_u32(smem_raw)) & 127u));
  const int H = a.H, n = a.n, k = a.k, din = a.din, dmid = a.dmid;
  const int td = a.td;
  const Layout lay = layout(kPaged, k, din, dmid, H, td, a.depth);
  const int K = lay.K, hc = lay.hc, hm = lay.hm, hmp = lay.hmp;
  const unsigned rank = ctarank();
  const int b = blockIdx.x / kCluster;
  const int u0 = slice_lo(H, rank), hs = slice_lo(H, rank + 1) - u0;
  const int x0 = slice_lo(din, rank), xs = slice_lo(din, rank + 1) - x0;
  const int m0 = slice_lo(dmid, rank), ms = slice_lo(dmid, rank + 1) - m0;
  float* tiles = smem + lay.tiles;
  float* xch = smem + lay.xch;  // the GRU's split K loop, where it has one
  const bool split = lay.xch != 0;
  float* s_rows = smem + lay.rows;  // a buffer's mask and row ids, each
  uint32_t* s_live = reinterpret_cast<uint32_t*>(s_rows + 4 * kTileRows);
  const int tid = threadIdx.x;

  if (lay.wsmem) {
    float* wgs = smem + lay.wgs;
    for (int p = tid; p < din * lay.mm; p += kThreads) {
      const int kk = p / lay.mm, c = p - kk * lay.mm;
      wgs[p] = c < ms ? a.wg[(size_t)kk * dmid + m0 + c] : 0.0f;
    }
    for (int c = tid; c < lay.mm; c += kThreads)
      smem[lay.bgs + c] = c < ms ? a.bg[m0 + c] : 0.0f;
    stage_gru(a.wx, dmid, a.wh, a.bias, H, u0, hs, hm, smem + lay.ws,
              smem + lay.bs);
  }
  Ring ring{};
  if constexpr (kPaged)
    ring = ring_make(smem + lay.ring,
                     reinterpret_cast<uint64_t*>(smem + lay.bars), a.depth,
                     kTileRows * td, kLog ? a.proto : nullptr);
  // peers' shared memory is live before the first DSMEM store
  cluster::sync();
  // PROF_INIT

  float* h_st = a.h_store + (size_t)b * a.G * H;
  const int plane = b * kCluster + (int)rank;
  float* rows_t1 = kPaged ? a.h_rows + (size_t)plane * n * hmp : nullptr;
  const int nw = kPaged ? (hs + td - 1) / td : 0;  // windows a live tile
  const int ntiles = (n + kTileRows - 1) / kTileRows;
  int buf = 0;

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
      const size_t nx = bt + 1;
      prefetch_l2(a.x + nx * n * din, sizeof(float) * n * din, rank);
      prefetch_l2(a.idx + nx * n * k, sizeof(int) * n * k, rank);
      prefetch_l2(a.coef + nx * n * k, sizeof(float) * n * k, rank);
      prefetch_l2(a.rowg + nx * n, sizeof(int) * n, rank);
      prefetch_l2(a.mask + nx * n, sizeof(float) * n, rank);
      if (a.emsg != nullptr) {
        prefetch_l2(a.eidx + nx * n * k, sizeof(int) * n * k, rank);
        prefetch_l2(a.emsg + nx * a.e * din, sizeof(float) * a.e * din, rank);
      }
    }
    if constexpr (kPaged) {
      // the step's t-1 rows of the own units into the CTA's scratch, which
      // the ring reads through the async proxy
      gather_own(h_st, a.G, H, u0, hs, rowg, mask, n, rows_t1, hmp);
      publish_global();
    }
    // PROF(0) row gather

    // the step's tiles, a chunk of kChunkTiles at a time (one chunk up to n
    // 65,536)
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
          const uint32_t bar =
              ring_issue(ring, seq, issued, kTileRows * td * sizeof(float));
          hopper::tma_load_3d(hopper::smem_u32(ring_slot(ring, seq)), &hmap,
                              bar, p_w * td, p_tile * kTileRows, plane);
        }
        ++issued;
        if (++p_w == nw) p_w = 0;
      };
      if constexpr (kPaged) {
        if (tid < 32)
          while (issued < total && issued < a.depth) issue_next();
      }

      // all-padding tiles: h' = 0 (the live tiles below write other rows)
      zero_dead_rows(out, h_st, a.G, H, u0, hs, rowg, s_live, q0, vend);
      // PROF(2) dead tiles

      // the live tiles
      for (int q = next_live(s_live, q0, q0, n); q < qend;
           q = next_live(s_live, q0, q + 1, n)) {
        const int r0 = q * kTileRows;
        float* tile = tiles + (size_t)buf * K * kTileStride;
        // the ELL lanes in the nt columns, dead once agg is computed
        int* s_idx = reinterpret_cast<int*>(tile + (size_t)din * kTileStride);
        float* s_coef = reinterpret_cast<float*>(s_idx + kTileRows * k);
        int* s_eidx = s_idx + 2 * kTileRows * k;
        int* s_cnt = s_idx + 3 * kTileRows * k;
        // the tile's mask and row ids, by buffer: the next tile's load
        // writes the other pair while slower warps may still be in this
        // tile's epilogue
        float* s_mask = s_rows + 2 * buf * kTileRows;
        int* s_rowg = reinterpret_cast<int*>(s_mask + kTileRows);
        load_ell_tile(idx, coef, emsg != nullptr ? eidx : nullptr, mask,
                      rowg, r0, n, k, s_idx, s_coef,
                      emsg != nullptr ? s_eidx : nullptr, s_mask, s_rowg,
                      s_cnt, tid, kThreads);
        if constexpr (!kPaged)  // the own units' t-1 h of the tile's rows
          own_rows(h_st, a.G, H, u0, hs, rowg, mask, r0, n, tile, hc + u0);
        __syncthreads();
        // PROF(3) ELL + own rows
        for (int p = tid; p < kTileRows * xs; p += kThreads) {
          const int r = p / xs, c = p - r * xs;
          tile[(size_t)(x0 + c) * kTileStride + r] = cluster::ell_sum(
              x, din, emsg, din, s_idx + r * k, s_coef + r * k,
              emsg != nullptr ? s_eidx + r * k : nullptr, s_cnt[r], x0 + c);
        }
        if constexpr (kPaged) {
          // the own units' t-1 h, window by window through the ring
          for (int w = 0; w < nw; ++w) {
            const unsigned seq = ring.seq;
            ring_wait(ring, seq, (int)(seq - sweep0));
            const float* slot = ring_slot(ring, seq);
            const int wc = min(td, hs - w * td);
            for (int p = tid; p < kTileRows * wc; p += kThreads) {
              const int r = p / wc, c = p - r * wc;
              tile[(size_t)(hc + u0 + w * td + c) * kTileStride + r] =
                  slot[r * td + c];
            }
            ring.seq = seq + 1;
            __syncthreads();
            if (tid < 32 && issued < total) issue_next();
          }
        }
        __syncthreads();
        // PROF(4) aggregation (+ windows)
        broadcast_cols(tile, x0, xs, rank, tid, kThreads);
        broadcast_cols(tile, hc + u0, hs, rank, tid, kThreads);
        cluster::sync();
        // PROF(5) all-gather A + barrier
        // the own columns of nt on the whole agg, all-gathered
        if (lay.wsmem)
          linear_cols<true>(tile, 0, din, din + m0, ms, smem + lay.wgs,
                            lay.mm, smem + lay.bgs, nullptr, nullptr, dmid,
                            m0, tid, kThreads);
        else
          linear_cols<false>(tile, 0, din, din + m0, ms, nullptr, 0, nullptr,
                             a.wg, a.bg, dmid, m0, tid, kThreads);
        __syncthreads();
        // PROF(6) nt
        broadcast_cols(tile, din + m0, ms, rank, tid, kThreads);
        cluster::sync();
        // PROF(7) all-gather B + barrier
        // the GRU of the own units; h' into out and the store
        auto epi = [&](int r, int j, float h) {
          const int v = r0 + r;
          if (v >= n) return;
          const float hn = __fmul_rn(h, s_mask[r]);
          out[(size_t)v * H + u0 + j] = hn;
          const int g = s_rowg[r];
          if (g >= 0 && g < a.G) h_st[(size_t)g * H + u0 + j] = hn;
        };
        if (lay.wsmem)
          gru_units<true>(tile, din, dmid, hc, H, u0, hs, hm, smem + lay.ws,
                          smem + lay.bs, nullptr, nullptr, nullptr, xch, split,
                          tid, kThreads, epi);
        else
          gru_units<false>(tile, din, dmid, hc, H, u0, hs, hm, nullptr,
                           nullptr, a.wx, a.wh, a.bias, xch, split, tid,
                           kThreads, epi);
        // PROF(8) GRU
        if (lay.nbuf == 1)
          cluster::sync();  // every CTA's reads of the tile are done
        else
          buf ^= 1;
      }
    }
    // the step's store writes before the next step reads them
    __syncthreads();
    // PROF(9) step end
  }
  // PROF_END
  // no CTA leaves while a peer could still reach its shared memory
  cluster::sync();
}

template <bool kPaged>
int launch(const StackedArgs& a, int B, void* stream) {
  if (a.H % 4 != 0) return (int)cudaErrorInvalidValue;
  const Layout lay = layout(kPaged, a.k, a.din, a.dmid, a.H, a.td, a.depth);
  if (lay.bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap hmap{};
  if (kPaged) {
    if (a.h_rows == nullptr) return (int)cudaErrorInvalidValue;
    const cudaError_t err = f32_map_3d(&hmap, a.h_rows, lay.hmp, a.n,
                                       B * kCluster, a.td, kTileRows);
    if (err != cudaSuccess) return (int)err;
  }
  // a launch with a protocol log runs the paged kernel's logging build;
  // the main path's (proto null) holds no logging code, and a resident
  // one has no ring to log
  if (a.proto != nullptr)
    return cluster::launch(stacked_engine_kernel<kPaged, kPaged>, B, kThreads,
                           lay.bytes, stream, hmap, a);
  return cluster::launch(stacked_engine_kernel<kPaged>, B, kThreads,
                         lay.bytes, stream, hmap, a);
}

StackedArgs make_args(const void* idx, const void* coef, const void* eidx,
                      const void* x, const void* rowg, const void* mask,
                      const void* wg, const void* bg, const void* wx,
                      const void* wh, const void* bias, const void* emsg,
                      void* out, void* h_store, void* h_rows, void* proto,
                      int T, int n, int k, int din, int dmid, int H, int G,
                      int e) {
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
  a.proto = static_cast<int*>(proto);
  a.T = T; a.n = n; a.k = k; a.din = din; a.dmid = dmid; a.H = H; a.G = G;
  a.e = e; a.td = 1; a.depth = 1;
  return a;
}

// The launch's shape into out: cluster size, CTAs, threads a CTA, dynamic
// shared memory a CTA, clusters the card holds at once (-1: unknown), the
// C + 1 bounds of the unit slices and the C + 1 of the input columns, then
// the own weights in shared memory (1) or not (0).
template <bool kPaged>
int cluster_config(int B, int k, int din, int dmid, int H, int td, int depth,
                   int* out) {
  const Layout lay = layout(kPaged, k, din, dmid, H, td, depth);
  out[0] = kCluster;
  out[1] = B * kCluster;
  out[2] = kThreads;
  out[3] = (int)lay.bytes;
  out[4] = max_active_clusters(stacked_engine_kernel<kPaged>, kThreads,
                               lay.bytes);
  for (int r = 0; r <= kCluster; ++r) {
    out[5 + r] = slice_lo(H, r);
    out[6 + kCluster + r] = slice_lo(din, r);
  }
  out[7 + 2 * kCluster] = lay.wsmem ? 1 : 0;
  return 0;
}

}  // namespace

extern "C" {

size_t stacked_engine_smem_bytes(int k, int din, int dmid, int H) {
  return layout(false, k, din, dmid, H, 1, 1).bytes;
}

size_t stacked_engine_paged_smem_bytes(int k, int din, int dmid, int H,
                                       int td, int depth) {
  return layout(true, k, din, dmid, H, td, depth).bytes;
}

int stacked_engine_cluster_config(int B, int k, int din, int dmid, int H,
                                  int* out) {
  return cluster_config<false>(B, k, din, dmid, H, 1, 1, out);
}

int stacked_engine_paged_cluster_config(int B, int k, int din, int dmid,
                                        int H, int td, int depth, int* out) {
  return cluster_config<true>(B, k, din, dmid, H, td, depth, out);
}

int stacked_engine_launch(const void* idx, const void* coef, const void* eidx,
                          const void* x, const void* rowg, const void* mask,
                          const void* wg, const void* bg, const void* wx,
                          const void* wh, const void* bias, const void* emsg,
                          void* out, void* h_store, void* h_rows, void* proto,
                          int B, int T, int n, int k, int din, int dmid, int H,
                          int G, int e, void* stream) {
  const StackedArgs a = make_args(idx, coef, eidx, x, rowg, mask, wg, bg, wx,
                                  wh, bias, emsg, out, h_store, h_rows, proto,
                                  T, n, k, din, dmid, H, G, e);
  return launch<false>(a, B, stream);
}

int stacked_engine_paged_launch(const void* idx, const void* coef,
                                const void* eidx, const void* x,
                                const void* rowg, const void* mask,
                                const void* wg, const void* bg,
                                const void* wx, const void* wh,
                                const void* bias, const void* emsg, void* out,
                                void* h_store, void* h_rows, void* proto,
                                int B, int T, int n, int k, int din, int dmid,
                                int H, int G, int e, int td, int depth,
                                void* stream) {
  if (td <= 0 || td % 8 != 0 || td > kBoxRows || depth < 1 ||
      depth > engine::kMaxDepth)
    return (int)cudaErrorInvalidValue;
  StackedArgs a = make_args(idx, coef, eidx, x, rowg, mask, wg, bg, wx, wh,
                            bias, emsg, out, h_store, h_rows, proto, T, n, k,
                            din, dmid, H, G, e);
  a.td = td; a.depth = depth;
  return launch<true>(a, B, stream);
}

const char* stacked_engine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* stacked_engine_paged_error_string(int code) {
  return stacked_engine_error_string(code);
}

}  // extern "C"
