// EvolveGCN-O stream engine for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/stream_fused.py, _stream_engine_kernel with
// the evolve cell (_evolve_cell) and its between-snapshot hook
// (_evolve_evolve), launch assembly _evolve_build, reached through
// stream_call("evolve", ...), and under hbm_paged residency the engine's
// paged staging (_Engine.stage_in / write_back / paged_fill).
//
// What it computes, per stream b and step t (the plain version is
// repro_torch/kernels/ref.py evolve_stream_batched_ref on the same packed
// inputs): an L-layer GCN over activations of width D,
//   a_0 = x[b, t];  a_{l+1} = act_l((sum_k coef a_l[idx] + eagg_l) @ W_l + b_l) * mask
// (ReLU except on the last layer, whose output is out[b, t]); then, on a
// live step, every W_l evolves for step t+1 by the matrix-GRU with W_l^T as
// both input and hidden state (its columns are the GRU batch):
//   r = sig(W^T gwx_r + gb_r + W^T gwh_r), z = ..., n = tanh(W^T gwx_n + gb_n + r (W^T gwh_n))
//   W^T <- (1 - z) n + z W^T
// The incoming W is consumed unchanged at t = 0 (the primed-carry
// convention of core/evolvegcn.py): a state primed on the host is never
// evolved twice. Layers share one square width D (the JAX pack's common
// square d_pad, GRU params padded per gate block), so zero-padded weight
// rows stay zero under evolution.
//
// Design. One thread-block cluster of kCluster CTAs (cluster_common.cuh)
// runs one stream's T and L loops; B streams are B clusters. CTA r owns
// the columns [r D / C, (r + 1) D / C) of every W_l:
//   * it keeps them in shared memory for the whole stream, in two planes
//     (t and t+1) a layer, and writes them to the global W once, at the end;
//   * the GCN output columns it computes are its W columns: per live node
//     tile it aggregates its own columns of a_l (which it produced itself
//     at layer l - 1; the ELL sum is separable by column) into its k-major
//     tile, copies them into every peer's tile (DSMEM), and after one
//     cluster barrier multiplies the whole tile by its columns of W_l (4
//     rows a thread). The tile is double buffered, so one cluster barrier a
//     live tile suffices;
//   * the matrix-GRU's batch is W's columns, so a CTA evolves exactly its
//     own columns, reading plane t and writing plane t+1: no W crosses
//     CTAs. It runs on kGruThreads threads of its own, beside the kThreads
//     GCN threads' tiles of the same step (both read plane t; the paper's
//     V1 overlap), pacing its arrivals at the cluster barriers with the
//     GCN tiles' (the step's live tiles times L, the launcher's count of
//     the tiles the GCN threads' bitmask marks). gwx / gwh (D x 3D each, 393 KB a layer at D 128) stream
//     through a two-slot ring of slabs (one bulk copy each), gwx's rows in
//     a first pass and gwh's in a second, so a thread holds half its gate
//     sums; every product reads from shared memory.
// Activations ping-pong through per-stream global scratch (B, 2, n, D), each
// CTA reading and writing only its own columns.
//
// Paged variant (hbm_paged residency, evolve_engine_paged_launch): the same
// kernel compiled with kPaged, with no W buffer in shared memory. Each CTA
// copies its columns of every W_l into pages of its own in global memory
// ((B, L, C, D, dsp): a TMA box must start 16 bytes aligned, which a slice
// of W's rows need not), and they reach it through a depth-deep ring of
// (D, td) windows (cluster_common.cuh; a window is one TMA box a 256
// rows). The GCN's window sweep runs across the live tiles of a layer (the
// next window in flight while one is consumed); the matrix-GRU evolves
// each window's columns on their own and writes them back to the pages,
// beside the windows still in flight (disjoint columns); the pages go back
// to W at the end. Its GRU runs after each layer's GCN, on all threads
// (the in-place writes must not meet the GCN's windows). Both run the
// resident kernel's arithmetic (each output the same fmaf chain), so
// outputs and final weights are bit-identical to it. Shared memory is
// linear in D at a fixed td.
//
// What bounds it. Serial in t and l; a stream spreads over kCluster SMs.
// The card's roofline is set by the bytes of the per-step inputs; the
// kernel is bound by latency: a live tile's chain of ELL loads, gathers
// from L2, the cluster barrier and a shared-memory-bound product, with the
// GRU's slab copies hidden beside it (PERF.md).
#include "cluster_common.cuh"

using engine::kTileRows;
using engine::kTileStride;
using engine::sigmoidf;
using namespace cluster;

namespace {

// gwx / gwh rows a slab of the GRU's ring and the ring's slots; the
// resident kernel's GRU threads (beside its kThreads GCN threads), and the
// 4-column groups of one output feature a GRU thread carries through a
// pass over the slabs, there and in the paged kernel (whose GRU runs on
// its kThreads threads after each layer's GCN)
constexpr int kGwRows = 8;
constexpr int kGwSlots = 2;
constexpr int kGruThreads = 128;
constexpr int kGruGroups = 2;    // a paged GRU thread's column groups
constexpr int kSplitGroups = 4;  // a resident GRU thread's

template <bool kPaged>
__host__ __device__ constexpr int engine_threads() {
  return kPaged ? kThreads : kThreads + kGruThreads;
}

struct EvolveArgs {
  const int* idx;     // (B, T, n, k) local neighbour ids
  const float* coef;  // (B, T, n, k)
  const float* x;     // (B, T, n, D)
  const float* mask;  // (B, T, n)
  const int* live;    // (B, T) 1 = real step, 0 = no-op
  const int* tiles;   // (B, T) the live node tiles of each step
  const float* bias;  // (L, D)
  const float* gwx;   // (L, D, 3D) [r | z | n]
  const float* gwh;   // (L, D, 3D)
  const float* gb;    // (L, 3D)
  const float* eagg;  // (B, T, L, n, D), or null
  float* out;         // (B, T, n, D) last layer's activations
  float* w;           // (B, L, D, D), W0 on entry, final W on exit
  float* act;         // (B, 2, n, D) scratch
  float* wpage;       // paged: (B, L, C, D, dsp) each CTA's columns of W
  int* proto;         // the rings' and planes' protocol log, or null
  int T, n, k, L, D;
  int td, depth;      // paged: window width and ring depth
};

// Shared memory of one CTA, in floats from the 128-byte aligned base.
struct Layout {
  int dm, dsp, box_rows, nbox;
  size_t ring, gw, planes, tiles, idx, coef, rows, gsum, gbars, rbars;
  size_t bytes;  // dynamic shared memory, alignment slack included
};

__host__ __device__ inline Layout layout(bool paged, int k, int L, int D,
                                         int td, int depth) {
  Layout y{};
  y.dm = slice_max(D);         // widest column slice
  y.dsp = round_up(y.dm, 4);   // its row stride in a plane
  y.box_rows = D < kBoxRows ? D : kBoxRows;
  y.nbox = (D + y.box_rows - 1) / y.box_rows;
  size_t o = 0;
  if (paged) {
    y.ring = o;  // depth slots of (nbox box_rows, td) own-column windows
    o += (size_t)depth * y.nbox * y.box_rows * td;
  }
  y.gw = o;  // kGwSlots slabs: kGwRows rows of gwx, then of gwh
  o += (size_t)kGwSlots * 2 * kGwRows * 3 * D;
  if (!paged) {
    y.planes = o;  // (L, 2, D, dsp): each layer's own columns, t and t+1
    o += (size_t)L * 2 * D * y.dsp;
  }
  y.tiles = o;  // two k-major (D, kTileStride) aggregate tiles
  o += 2 * (size_t)D * kTileStride;
  y.idx = o;
  o += (size_t)kTileRows * k;
  y.coef = o;
  o += (size_t)kTileRows * k;
  y.rows = o;  // two tiles' masks, lane counts; live bits
  o += 3 * kTileRows + kLiveWords;
  if (!paged) {
    y.gsum = o;  // the GRU threads' x-pass sums, 12 a column group
    o += (size_t)kGruThreads * 12 * kSplitGroups;
  }
  y.gbars = o;  // the slab ring's mbarriers, then the window ring's
  o += kGwSlots * 2;
  y.rbars = o;
  if (paged) o += engine::kRingBarBytes / sizeof(float);
  y.bytes = kAlignSlack + o * sizeof(float);
  return y;
}

// dst[v, c] = act((tile @ W[:, c]) + b[c]) * mask[v] for the tile's rows
// v = r0 + r < n and the columns c < ncols, W's column c read from wsrc + c
// (row kk at wsrc + kk * wstride); bias and dst offset to the same first
// column; ReLU unless `last`; m_rows[r] the mask of row r0 + r (the
// tile's own half of the two in shared memory: the next tile's ELL load
// writes the other while slower warps may still be here); by threads t of
// nt. A thread owns 4 rows of one column; every output is one fmaf chain
// over kk = 0 .. D - 1.
__device__ __forceinline__ void gcn_columns(const float* tile, int D,
                                            const float* wsrc, int wstride,
                                            int ncols, const float* bias,
                                            bool last, const float* m_rows,
                                            int r0, int n, float* dst, int t,
                                            int nt) {
  for (int p = t; p < kRowGroups * ncols; p += nt) {
    const int rg = p / ncols, cl = p - rg * ncols;
    float acc[kRows] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* ap = tile + rg * kRows;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(ap + (size_t)kk * kTileStride);
      const float wv = wsrc[(size_t)kk * wstride + cl];
      acc[0] = fmaf(av.x, wv, acc[0]);
      acc[1] = fmaf(av.y, wv, acc[1]);
      acc[2] = fmaf(av.z, wv, acc[2]);
      acc[3] = fmaf(av.w, wv, acc[3]);
    }
    const float bl = bias[cl];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int v = r0 + rg * kRows + r;
      if (v < n) {
        float h = __fadd_rn(acc[r], bl);
        if (!last) h = fmaxf(h, 0.0f);
        dst[(size_t)v * D + cl] = __fmul_rn(h, m_rows[rg * kRows + r]);
      }
    }
  }
}

// Issue slab `seq` of a GRU sweep: rows (s % nslab) * kGwRows.. of gwx and
// gwh into its slot (thread 0).
__device__ __forceinline__ void issue_slab(const Ring& g, unsigned seq,
                                           int s, int D, const float* gwx,
                                           const float* gwh) {
  const int nslab = D / kGwRows;
  const size_t row0 = (size_t)(s % nslab) * kGwRows * 3 * D;
  const uint32_t bytes = (uint32_t)kGwRows * 3 * D * sizeof(float);
  float* slot = ring_slot(g, seq);
  const uint32_t bar = ring_issue(g, seq, s, 2 * bytes);
  bulk_load(slot, gwx + row0, bytes, bar);
  bulk_load(slot + (size_t)kGwRows * 3 * D, gwh + row0, bytes, bar);
}

// Matrix-GRU evolution of W's columns [0, ncols) in the paged kernel, read
// from wsrc (row m at wsrc + m * wstride; 4-column groups read as float4,
// columns past ncols computed and dropped), written to global memory at
// dst[f * dstride + c], which the window ring reads later: rows of W^T are
// the columns c of W; a thread owns one output feature f and G 4-column
// groups (so each gwx / gwh value it reads feeds 4 G of them), and each
// pass over those items streams gwx / gwh through the slab ring. Run by
// all threads t of nt, which meet at a block barrier after each slab. Each
// output is one fmaf chain per gate sum over m = 0 .. D - 1, whatever G,
// the pass or the window.
template <int G>
__device__ __forceinline__ void evolve_columns(const float* wsrc, int wstride,
                                               int ncols, int D,
                                               const float* gwx,
                                               const float* gwh,
                                               const float* gb, float* dst,
                                               int dstride, Ring& g, int t,
                                               int nt) {
  const int ncg = (ncols + 3) / 4;
  const int items = (ncg + G - 1) / G * D;
  const int nslab = D / kGwRows;
  const int passes = (items + nt - 1) / nt;
  const int total = passes * nslab;
  const unsigned base = g.seq;
  if (t == 0)
    for (int s = 0; s < min(kGwSlots, total); ++s)
      issue_slab(g, base + s, s, D, gwx, gwh);
  for (int pass = 0; pass < passes; ++pass) {
    const int item = pass * nt + t;
    const bool has = item < items;
    const int f = item % D, cg0 = item / D * G;
    float acc[G][6][4];
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int q = 0; q < 6; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][q][r] = 0.0f;
    for (int s = 0; s < nslab; ++s) {
      const unsigned seq = g.seq;
      ring_wait(g, seq, (int)(seq - base));
      const float* slab = ring_slot(g, seq);
      if (has) {
#pragma unroll
        for (int mm = 0; mm < kGwRows; ++mm) {
          const int m = s * kGwRows + mm;
          const float* gx = slab + (size_t)mm * 3 * D + f;
          const float* gh = gx + (size_t)kGwRows * 3 * D;
          const float xr = gx[0], xz = gx[D], xn = gx[2 * D];
          const float hr = gh[0], hz = gh[D], hn = gh[2 * D];
#pragma unroll
          for (int j = 0; j < G; ++j) {
            const int cg = cg0 + j;
            const float4 av =
                cg < ncg ? *reinterpret_cast<const float4*>(
                               wsrc + (size_t)m * wstride + cg * 4)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc[j][0][r] = fmaf(a4[r], xr, acc[j][0][r]);
              acc[j][1][r] = fmaf(a4[r], xz, acc[j][1][r]);
              acc[j][2][r] = fmaf(a4[r], xn, acc[j][2][r]);
              acc[j][3][r] = fmaf(a4[r], hr, acc[j][3][r]);
              acc[j][4][r] = fmaf(a4[r], hz, acc[j][4][r]);
              acc[j][5][r] = fmaf(a4[r], hn, acc[j][5][r]);
            }
          }
        }
      }
      g.seq = seq + 1;
      __syncthreads();
      const int next = (int)(seq - base) + kGwSlots;
      if (t == 0 && next < total) issue_slab(g, base + next, next, D, gwx, gwh);
    }
    if (has) {
      const float br = __ldg(gb + f), bz = __ldg(gb + D + f),
                  bn = __ldg(gb + 2 * D + f);
#pragma unroll
      for (int j = 0; j < G; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int c = (cg0 + j) * 4 + r;
          if (c >= ncols) continue;
          const float rr =
              sigmoidf(__fadd_rn(__fadd_rn(acc[j][0][r], br), acc[j][3][r]));
          const float zz =
              sigmoidf(__fadd_rn(__fadd_rn(acc[j][1][r], bz), acc[j][4][r]));
          const float nn = tanhf(
              __fmaf_rn(rr, acc[j][5][r], __fadd_rn(acc[j][2][r], bn)));
          const float own = wsrc[(size_t)f * wstride + c];
          dst[(size_t)f * dstride + c] =
              __fmaf_rn(zz, own, __fmul_rn(__fsub_rn(1.0f, zz), nn));
        }
      }
    }
    publish_global();
  }
}

// evolve_columns for the resident kernel's GRU threads (t of nt, which
// meet at named barrier `bar` after each slab and then call pace(slabs
// done, slabs in all)): a thread owns one output feature f and G 4-column
// groups and runs two passes over the slab ring, first gwx's rows (the x
// sums r | z | n, parked in `park`, nt x 12 G floats) and then gwh's,
// 2 kGwRows rows of one matrix a slab, so it holds 12 G sums and not 24 G.
// Each sum is the same fmaf chain over m = 0 .. D - 1 as evolve_columns',
// so the outputs are bit-identical to the paged kernel's.
template <int G, class Pace>
__device__ __forceinline__ void evolve_columns_xh(
    const float* wsrc, int wstride, int ncols, int D, const float* gwx,
    const float* gwh, const float* gb, float* dst, int dstride, Ring& g,
    float* park, int t, int nt, int bar, Pace pace) {
  constexpr int kSlabRows = 2 * kGwRows;  // one matrix's rows a slab
  const int ncg = (ncols + 3) / 4;
  const int items = (ncg + G - 1) / G * D;
  const int half = (D + kSlabRows - 1) / kSlabRows;  // slabs a matrix
  const int passes = (items + nt - 1) / nt;
  const int total = passes * 2 * half;
  const unsigned base = g.seq;
  auto issue = [&](int s) {  // slab s of the sweep, by thread 0
    const int sp = s % (2 * half), sl = sp % half;
    const int rows = min(kSlabRows, D - sl * kSlabRows);
    const uint32_t bytes = (uint32_t)rows * 3 * D * sizeof(float);
    const float* src = (sp < half ? gwx : gwh) + (size_t)sl * kSlabRows * 3 * D;
    const unsigned seq = base + s;
    const uint32_t mbar = ring_issue(g, seq, s, bytes);
    bulk_load(ring_slot(g, seq), src, bytes, mbar);
  };
  if (t == 0)
    for (int s = 0; s < min(kGwSlots, total); ++s) issue(s);
  for (int pass = 0; pass < passes; ++pass) {
    const int item = pass * nt + t;
    const bool has = item < items;
    const int f = item % D, cg0 = item / D * G;
    float acc[G][3][4];
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[j][q][r] = 0.0f;
      for (int sl = 0; sl < half; ++sl) {
        const unsigned seq = g.seq;
        ring_wait(g, seq, (int)(seq - base));
        const float* slab = ring_slot(g, seq);
        const int rows = min(kSlabRows, D - sl * kSlabRows);
        if (has) {
#pragma unroll 2
          for (int mm = 0; mm < rows; ++mm) {
            const int m = sl * kSlabRows + mm;
            const float* gm = slab + (size_t)mm * 3 * D + f;
            const float gr = gm[0], gz = gm[D], gn = gm[2 * D];
#pragma unroll
            for (int j = 0; j < G; ++j) {
              const int cg = cg0 + j;
              const float4 av =
                  cg < ncg ? *reinterpret_cast<const float4*>(
                                 wsrc + (size_t)m * wstride + cg * 4)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                acc[j][0][r] = fmaf(a4[r], gr, acc[j][0][r]);
                acc[j][1][r] = fmaf(a4[r], gz, acc[j][1][r]);
                acc[j][2][r] = fmaf(a4[r], gn, acc[j][2][r]);
              }
            }
          }
        }
        g.seq = seq + 1;
        hopper::bar_sync(bar, nt);
        const int done = (int)(seq - base) + 1, next = done - 1 + kGwSlots;
        if (t == 0 && next < total) issue(next);
        pace(done, total);
      }
      if (h == 0) {
#pragma unroll
        for (int j = 0; j < G; ++j)
#pragma unroll
          for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              park[(size_t)((j * 3 + q) * 4 + r) * nt + t] = acc[j][q][r];
      }
    }
    if (has) {
      const float br = __ldg(gb + f), bz = __ldg(gb + D + f),
                  bn = __ldg(gb + 2 * D + f);
#pragma unroll
      for (int j = 0; j < G; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int c = (cg0 + j) * 4 + r;
          if (c >= ncols) continue;
          const float xr = park[(size_t)((j * 3 + 0) * 4 + r) * nt + t];
          const float xz = park[(size_t)((j * 3 + 1) * 4 + r) * nt + t];
          const float xn = park[(size_t)((j * 3 + 2) * 4 + r) * nt + t];
          const float rr = sigmoidf(__fadd_rn(__fadd_rn(xr, br), acc[j][0][r]));
          const float zz = sigmoidf(__fadd_rn(__fadd_rn(xz, bz), acc[j][1][r]));
          const float nn =
              tanhf(__fmaf_rn(rr, acc[j][2][r], __fadd_rn(xn, bn)));
          const float own = wsrc[(size_t)f * wstride + c];
          dst[(size_t)f * dstride + c] =
              __fmaf_rn(zz, own, __fmul_rn(__fsub_rn(1.0f, zz), nn));
        }
      }
    }
  }
}

template <bool kPaged, bool kLog = false>
__global__ void __launch_bounds__(engine_threads<kPaged>(), 1)
    evolve_engine_kernel(const __grid_constant__ CUtensorMap wmap,
                         EvolveArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the 128-byte aligned base, offset from smem_raw (not rebuilt from an
  // integer), so the compiler keeps it a shared-memory pointer: the tiles'
  // and weights' loads compile to LDS, not generic loads
  float* smem = reinterpret_cast<float*>(
      smem_raw + ((128u - hopper::smem_u32(smem_raw)) & 127u));
  const int n = a.n, k = a.k, L = a.L, D = a.D, td = a.td;
  const Layout lay = layout(kPaged, k, L, D, td, a.depth);
  const int dsp = lay.dsp;
  const unsigned rank = ctarank();
  const int b = blockIdx.x / kCluster;
  const int d0 = slice_lo(D, rank), ds = slice_lo(D, rank + 1) - d0;
  float* tiles = smem + lay.tiles;
  float* planes = smem + lay.planes;
  int* s_idx = reinterpret_cast<int*>(smem + lay.idx);
  float* s_coef = smem + lay.coef;
  // two tiles' masks (a tile's buffer's half), lane counts, live bits
  float* s_mask = smem + lay.rows;
  int* s_cnt = reinterpret_cast<int*>(s_mask + 2 * kTileRows);
  uint32_t* s_live = reinterpret_cast<uint32_t*>(s_mask + 3 * kTileRows);
  const int tid = threadIdx.x;
  constexpr int kAll = engine_threads<kPaged>();
  // resident: threads [kThreads, kAll) run the matrix-GRU beside the GCN
  const bool gru_warp = !kPaged && tid >= kThreads;
  auto gcn_sync = [] {  // the GCN threads' barrier
    if constexpr (kPaged) __syncthreads();
    else hopper::bar_sync(1, kThreads);
  };
  // paged: this CTA's columns of W_l in global memory, (D, dsp)
  auto wpage = [&](int l) {
    return a.wpage + ((((size_t)b * L + l) * kCluster + rank) * D) * dsp;
  };

  // the GRU's slab ring, issued (and logged) by its first thread
  Ring gring = ring_make(smem + lay.gw,
                         reinterpret_cast<uint64_t*>(smem + lay.gbars),
                         kGwSlots, 2 * kGwRows * 3 * D,
                         kLog ? a.proto : nullptr,
                         proto::kGruRing, kPaged ? 0 : kThreads);
  Ring ring{};
  if constexpr (kPaged) {
    ring = ring_make(smem + lay.ring,
                     reinterpret_cast<uint64_t*>(smem + lay.rbars), a.depth,
                     lay.nbox * lay.box_rows * td,
                     kLog ? a.proto : nullptr);
    // the own columns of W0 into the CTA's pages (zero padding columns),
    // which the ring reads through the async proxy
    for (int p = tid; p < L * D * dsp; p += kAll) {
      const int c = p % dsp, m = (p / dsp) % D, l = p / (dsp * D);
      wpage(l)[(size_t)m * dsp + c] =
          c < ds ? a.w[(((size_t)b * L + l) * D + m) * D + d0 + c] : 0.0f;
    }
    publish_global();
    __syncthreads();
  } else {
    // both planes of every layer: plane 0 the own columns of W0, zero
    // padding columns
    for (int p = tid; p < L * 2 * D * dsp; p += kAll) {
      const int c = p % dsp, m = (p / dsp) % D, pl = (p / (dsp * D)) & 1;
      const int l = p / (2 * D * dsp);
      planes[p] = pl == 0 && c < ds
                      ? a.w[(((size_t)b * L + l) * D + m) * D + d0 + c]
                      : 0.0f;
    }
  }
  // peers' shared memory is live before the first DSMEM store
  cluster::sync();

  float* act = a.act + (size_t)b * 2 * n * D;
  const int ncw = kPaged ? (ds + td - 1) / td : 0;  // own column windows
  const uint32_t wbytes = (uint32_t)lay.nbox * lay.box_rows * td * sizeof(float);
  unsigned cur = 0;  // bit l: the plane that holds layer l's current W
  int buf = 0;

  for (int t = 0; t < a.T; ++t) {
    const size_t bt = (size_t)b * a.T + t;
    const int* idx = a.idx + bt * n * k;
    const float* coef = a.coef + bt * n * k;
    const float* mask = a.mask + bt * n;
    const bool live = a.live[bt] > 0;
    if (t + 1 < a.T && !gru_warp) {  // the next step's inputs into L2
      const size_t nt = bt + 1;
      prefetch_l2(a.x + nt * n * D, sizeof(float) * n * D, rank);
      prefetch_l2(a.idx + nt * n * k, sizeof(int) * n * k, rank);
      prefetch_l2(a.coef + nt * n * k, sizeof(float) * n * k, rank);
      prefetch_l2(a.mask + nt * n, sizeof(float) * n, rank);
      if (a.eagg != nullptr)
        prefetch_l2(a.eagg + nt * L * n * D, sizeof(float) * L * n * D, rank);
    }
    // the bits of the step's first chunk of kChunkTiles live tiles, and the
    // step's live tiles (the launcher's count, at any n)
    const int ntiles = (n + kTileRows - 1) / kTileRows;
    live_bits(mask, n, 0, s_live);
    const int nlive = a.tiles[bt];

    if (gru_warp) {
      // the matrix-GRU of every layer, beside the GCN threads' tiles: these
      // warps arrive at and wait for each of the step's L * nlive cluster
      // barriers (the GCN threads' all-gathers) in turn, spread over their
      // slabs, so both reach every barrier alike
      const int phases = L * nlive;
      int waited = 0, arrived = 0;
      if (phases > 0) {
        cluster::arrive();
        arrived = 1;
      }
      auto pace = [&](long long done, long long total) {
        const int target = (int)(phases * done / total);
        while (waited < target) {
          cluster::wait();
          ++waited;
          if (arrived < phases) {
            cluster::arrive();
            ++arrived;
          }
        }
      };
      if (live) {
        const int items = ((ds + 3) / 4 + kSplitGroups - 1) / kSplitGroups * D;
        const int per_layer = (items + kGruThreads - 1) / kGruThreads * 2 *
                              ((D + 2 * kGwRows - 1) / (2 * kGwRows));
        for (int l = 0; l < L; ++l) {
          const float* wnow = planes + (size_t)(2 * l + ((cur >> l) & 1)) * D * dsp;
          float* wnext = planes + (size_t)(2 * l + (((cur >> l) & 1) ^ 1)) * D * dsp;
          if (kLog && tid == kThreads)  // the plane written
            proto::append(a.proto, proto::kPlaneWrite, t,
                          (int)((wnext - planes) / ((size_t)D * dsp)) - 2 * l,
                          0, l, proto::kWrite);
          evolve_columns_xh<kSplitGroups>(
              wnow, dsp, ds, D, a.gwx + (size_t)l * D * 3 * D,
              a.gwh + (size_t)l * D * 3 * D, a.gb + (size_t)l * 3 * D, wnext,
              dsp, gring, smem + lay.gsum, tid - kThreads, kGruThreads, 2,
              [&](int done, int) { pace((long long)l * per_layer + done,
                                         (long long)L * per_layer); });
        }
      }
      pace(1, 1);
    } else
    for (int l = 0; l < L; ++l) {
      const float* src = l == 0 ? a.x + bt * n * D
                                : act + (size_t)((l - 1) % 2) * n * D;
      const bool last = l == L - 1;
      float* dst = (last ? a.out + bt * n * D : act + (size_t)(l % 2) * n * D) + d0;
      const float* ea = a.eagg != nullptr ? a.eagg + (bt * L + l) * n * D : nullptr;
      const float* bias = a.bias + (size_t)l * D + d0;
      const int page = (b * L + l) * kCluster + (int)rank;  // W_l's pages
      const float* wplane = planes + (size_t)(2 * l + ((cur >> l) & 1)) * D * dsp;
      if (kLog && tid == 0)  // the plane read; paged: the pages
        proto::append(a.proto, proto::kPlaneRead, t,
                      kPaged ? 0
                             : (int)((wplane - planes) / ((size_t)D * dsp)) -
                                   2 * l,
                      0, l, proto::kRead);
      // the layer's tiles, a chunk of kChunkTiles at a time (one chunk up to
      // n 65,536, whose bits are taken above)
      for (int q0 = 0; q0 < ntiles; q0 += kChunkTiles) {
        if (ntiles > kChunkTiles)
          live_bits(mask, n, q0, s_live, tid, kThreads, gcn_sync);
        const int nl = ntiles > kChunkTiles ? count_live(s_live) : nlive;
        const int vend = min(chunk_end(q0, n) * kTileRows, n);
        // paged: window w of the layer's sweep is own column window w % ncw
        // of W_l (thread 0 issues)
        const unsigned sweep0 = ring.seq;
        auto issue_window = [&](int w) {
          const unsigned seq = sweep0 + (unsigned)w;
          const int cw = w % ncw;
          float* slot = ring_slot(ring, seq);
          const uint32_t bar = ring_issue(ring, seq, w, wbytes);
          for (int j = 0; j < lay.nbox; ++j)
            hopper::tma_load_3d(
                hopper::smem_u32(slot + (size_t)j * lay.box_rows * td), &wmap,
                bar, cw * td, j * lay.box_rows, page);
        };
        const int total = nl * ncw;
        if constexpr (kPaged)
          if (tid == 0)
            for (int w = 0; w < min(a.depth, total); ++w) issue_window(w);
        // all-padding tiles: zeros (the live tiles below write other rows)
        for (int p = q0 * kTileRows * ds + tid; p < vend * ds; p += kThreads) {
          const int v = p / ds, c = p - v * ds;
          if (!tile_live(s_live, q0, v / kTileRows))
            dst[(size_t)v * D + c] = 0.0f;
        }

        // GCN layer over the live tiles: aggregate the own columns, all-gather
        // the tile (DSMEM; one cluster barrier), multiply it by the own
        // columns of W_l
        for (int q = next_live(s_live, q0, q0, n); q < chunk_end(q0, n);
             q = next_live(s_live, q0, q + 1, n)) {
          const int r0 = q * kTileRows;
          float* tile = tiles + (size_t)buf * D * kTileStride;
          load_ell_tile(idx, coef, nullptr, mask, nullptr, r0, n, k, s_idx,
                        s_coef, nullptr, s_mask + buf * kTileRows, nullptr,
                        s_cnt, tid, kThreads);
          gcn_sync();
          // two items a thread, their gathers interleaved
          for (int p = tid; p < kTileRows * ds; p += 2 * kThreads) {
            const int p1 = p + kThreads < kTileRows * ds ? p + kThreads : p;
            const int r = p / ds, c = p - r * ds;
            const int r1 = p1 / ds, c1 = p1 - r1 * ds;
            float2 acc = ell_sum2(src, D, s_idx + r * k, s_coef + r * k,
                                  s_cnt[r], d0 + c, s_idx + r1 * k,
                                  s_coef + r1 * k, s_cnt[r1], d0 + c1);
            if (ea != nullptr) {
              if (r0 + r < n)
                acc.x = __fadd_rn(acc.x, ea[(size_t)(r0 + r) * D + d0 + c]);
              if (r0 + r1 < n)
                acc.y = __fadd_rn(acc.y, ea[(size_t)(r0 + r1) * D + d0 + c1]);
            }
            tile[(size_t)(d0 + c) * kTileStride + r] = acc.x;
            if (p1 != p) tile[(size_t)(d0 + c1) * kTileStride + r1] = acc.y;
          }
          gcn_sync();
          broadcast_cols(tile, d0, ds, rank, tid, kThreads);
          cluster::sync();
          if constexpr (kPaged) {
            for (int cw = 0; cw < ncw; ++cw) {
              const unsigned seq = ring.seq;
              ring_wait(ring, seq, (int)(seq - sweep0));
              gcn_columns(tile, D, ring_slot(ring, seq), td,
                          min(td, ds - cw * td), bias + cw * td, last,
                          s_mask + buf * kTileRows, r0, n, dst + cw * td, tid,
                          kThreads);
              ring.seq = seq + 1;
              gcn_sync();
              const int next = (int)(seq - sweep0) + a.depth;
              if (tid == 0 && next < total) issue_window(next);
            }
          } else {
            gcn_columns(tile, D, wplane, dsp, ds, bias, last,
                        s_mask + buf * kTileRows, r0, n,
                        dst, tid, kThreads);
          }
          buf ^= 1;
        }
      }
      // the layer's outputs before the next layer aggregates them
      gcn_sync();

      // paged: the matrix-GRU evolution of the own columns of W_l on live
      // steps, by all threads after the layer's GCN
      if (kPaged && live) {
        const float* gwx = a.gwx + (size_t)l * D * 3 * D;
        const float* gwh = a.gwh + (size_t)l * D * 3 * D;
        const float* gb = a.gb + (size_t)l * 3 * D;
        if constexpr (kPaged) {
          const unsigned gru0 = ring.seq;
          auto issue_gru = [&](int w) {  // thread 0
            const unsigned seq = gru0 + (unsigned)w;
            float* slot = ring_slot(ring, seq);
            const uint32_t bar = ring_issue(ring, seq, w, wbytes);
            for (int j = 0; j < lay.nbox; ++j)
              hopper::tma_load_3d(
                  hopper::smem_u32(slot + (size_t)j * lay.box_rows * td),
                  &wmap, bar, w * td, j * lay.box_rows, page);
          };
          if (kLog && tid == 0)  // in place: the one plane
            proto::append(a.proto, proto::kPlaneWrite, t, 0, 0, l,
                          proto::kWrite);
          if (tid == 0)
            for (int w = 0; w < min(a.depth, ncw); ++w) issue_gru(w);
          for (int cw = 0; cw < ncw; ++cw) {
            const unsigned seq = ring.seq;
            ring_wait(ring, seq, cw);
            evolve_columns<kGruGroups>(
                ring_slot(ring, seq), td, min(td, ds - cw * td), D, gwx, gwh,
                gb, wpage(l) + cw * td, dsp, gring, tid, kThreads);
            ring.seq = seq + 1;
            gcn_sync();
            const int next = cw + a.depth;
            if (tid == 0 && next < ncw) issue_gru(next);
          }
        }
        gcn_sync();
      }
    }
    // every thread: the step's outputs and new W planes before the next
    // step reads them; on a live step every layer's W moved to its other
    // plane
    __syncthreads();
    if (live) cur ^= (1u << L) - 1u;
  }
  // the final W of the own columns
  if (kLog && tid == 0)
    for (int l = 0; l < L; ++l)
      proto::append(a.proto, proto::kPlaneRead, a.T,
                    kPaged ? 0 : (int)((cur >> l) & 1u), 0, l, proto::kFinal);
  for (int p = tid; p < L * D * ds; p += kAll) {
    const int c = p % ds, m = (p / ds) % D, l = p / (ds * D);
    a.w[(((size_t)b * L + l) * D + m) * D + d0 + c] =
        kPaged ? wpage(l)[(size_t)m * dsp + c]
               : planes[((size_t)(2 * l + ((cur >> l) & 1)) * D + m) * dsp + c];
  }
  // no CTA leaves while a peer could still reach its shared memory
  cluster::sync();
}

template <bool kPaged>
int launch(const EvolveArgs& a, int B, void* stream) {
  if (a.D % kGwRows != 0) return (int)cudaErrorInvalidValue;
  const Layout lay = layout(kPaged, a.k, a.L, a.D, a.td, a.depth);
  CUtensorMap wmap{};
  if (kPaged) {
    const cudaError_t err = f32_map_3d(&wmap, a.wpage, lay.dsp, a.D,
                                       B * a.L * kCluster, a.td, lay.box_rows);
    if (err != cudaSuccess) return (int)err;
  }
  // a launch with a protocol log runs the kernel's logging build; the main
  // path's (proto null) holds no logging code
  if (a.proto != nullptr)
    return cluster::launch(evolve_engine_kernel<kPaged, true>, B,
                           engine_threads<kPaged>(), lay.bytes, stream, wmap,
                           a);
  return cluster::launch(evolve_engine_kernel<kPaged>, B,
                         engine_threads<kPaged>(), lay.bytes, stream, wmap,
                         a);
}

EvolveArgs make_args(const void* idx, const void* coef, const void* x,
                     const void* mask, const void* live, const void* tiles,
                     const void* bias,
                     const void* gwx, const void* gwh, const void* gb,
                     const void* eagg, void* out, void* w, void* act,
                     void* wpage, void* proto, int T, int n, int k, int L,
                     int D) {
  EvolveArgs a;
  a.idx = static_cast<const int*>(idx);
  a.coef = static_cast<const float*>(coef);
  a.x = static_cast<const float*>(x);
  a.mask = static_cast<const float*>(mask);
  a.live = static_cast<const int*>(live);
  a.tiles = static_cast<const int*>(tiles);
  a.bias = static_cast<const float*>(bias);
  a.gwx = static_cast<const float*>(gwx);
  a.gwh = static_cast<const float*>(gwh);
  a.gb = static_cast<const float*>(gb);
  a.eagg = static_cast<const float*>(eagg);
  a.out = static_cast<float*>(out);
  a.w = static_cast<float*>(w);
  a.act = static_cast<float*>(act);
  a.wpage = static_cast<float*>(wpage);
  a.proto = static_cast<int*>(proto);
  a.T = T; a.n = n; a.k = k; a.L = L; a.D = D;
  a.td = 8; a.depth = 1;
  return a;
}

// The launch's shape into out: cluster size, CTAs, threads a CTA, dynamic
// shared memory a CTA, clusters the card holds at once (-1: unknown), then
// the C + 1 bounds of the column slices.
template <bool kPaged>
int cluster_config(int B, int k, int L, int D, int td, int depth, int* out) {
  const Layout lay = layout(kPaged, k, L, D, td, depth);
  out[0] = kCluster;
  out[1] = B * kCluster;
  out[2] = engine_threads<kPaged>();
  out[3] = (int)lay.bytes;
  out[4] = max_active_clusters(evolve_engine_kernel<kPaged>,
                               engine_threads<kPaged>(), lay.bytes);
  for (int r = 0; r <= kCluster; ++r) out[5 + r] = slice_lo(D, r);
  return 0;
}

}  // namespace

extern "C" {

size_t evolve_engine_smem_bytes(int k, int L, int D) {
  return layout(false, k, L, D, 8, 1).bytes;
}

size_t evolve_engine_paged_smem_bytes(int k, int D, int td, int depth) {
  return layout(true, k, 1, D, td, depth).bytes;
}

int evolve_engine_cluster_config(int B, int k, int L, int D, int* out) {
  return cluster_config<false>(B, k, L, D, 8, 1, out);
}

int evolve_engine_paged_cluster_config(int B, int k, int D, int td, int depth,
                                       int* out) {
  return cluster_config<true>(B, k, 1, D, td, depth, out);
}

int evolve_engine_launch(const void* idx, const void* coef, const void* x,
                         const void* mask, const void* live,
                         const void* tiles, const void* bias,
                         const void* gwx, const void* gwh, const void* gb,
                         const void* eagg, void* out, void* w, void* act,
                         void* proto, int B, int T, int n, int k, int L, int D,
                         void* stream) {
  if (tiles == nullptr) return (int)cudaErrorInvalidValue;
  const EvolveArgs a = make_args(idx, coef, x, mask, live, tiles, bias, gwx,
                                 gwh, gb, eagg, out, w, act, nullptr, proto, T,
                                 n, k, L, D);
  return launch<false>(a, B, stream);
}

int evolve_engine_paged_launch(const void* idx, const void* coef,
                               const void* x, const void* mask,
                               const void* live, const void* tiles,
                               const void* bias, const void* gwx,
                               const void* gwh, const void* gb,
                               const void* eagg, void* out, void* w,
                               void* act, void* wpage, void* proto, int B,
                               int T, int n, int k, int L, int D, int td,
                               int depth, void* stream) {
  if (td <= 0 || td % 8 != 0 || td > kBoxRows || depth < 1 ||
      depth > engine::kMaxDepth || tiles == nullptr)
    return (int)cudaErrorInvalidValue;
  EvolveArgs a = make_args(idx, coef, x, mask, live, tiles, bias, gwx, gwh,
                           gb, eagg, out, w, act, wpage, proto, T, n, k, L, D);
  a.td = td; a.depth = depth;
  return launch<true>(a, B, stream);
}

const char* evolve_engine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* evolve_engine_paged_error_string(int code) {
  return evolve_engine_error_string(code);
}

}  // extern "C"
