// Static GCN stream engine for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/stream_fused.py, _stream_engine_kernel with
// the static cell (_static_cell, launch assembly _static_build), reached
// through stream_call("static_gcn", ...).
//
// What it computes, per slot b (one independent snapshot, T = 1; the plain
// version is repro_torch/kernels/ref.py static_gcn_stream_batched_ref on
// the same packed inputs): an L-layer GCN over activations of width D,
//   a_0 = x[b];  a_{l+1} = act_l((sum_s coef a_l[idx] + eagg_l) @ W_l + b_l) * mask
// with ReLU except on the last layer, whose output is out[b], and the edge
// term only when eagg is given. The inputs hold every layer at one square
// width D (the JAX pack's common square d_pad, zero-padded); the launcher
// takes each layer's true widths (din_l, dout_l = din_{l+1}) and computes
// only those, writing zeros to the output's columns past the last dout. No
// state: nothing carries between slots, and the wrapper refuses T != 1
// before any launch.
//
// Design: the stateful engines' cluster design (cluster_common.cuh) on a
// stateless slot.
// - One thread-block cluster of 8 CTAs (256 threads) a slot. Starting the
//   largest slots first (a slot order the wrapper sorts) took 0.2223 ms
//   against 0.2305 a launch, but the sort's launches cost the static v3
//   path more than that (0.0163 against 0.0146 ms a snapshot, PERF.md):
//   not kept.
// - CTA r owns the columns [r dout_l / 8, (r + 1) dout_l / 8) of every
//   layer's output, its W_l column slice staged in shared memory by
//   cp.async at the layer's start (read from L2 where it does not fit).
// - GCN aggregation separates by column, and layer l's output slices are
//   layer l + 1's input slices, so CTA r aggregates the input columns it
//   wrote itself (layer 0: of x): a quarter warp a row, the live lanes
//   gathered in batches (slice_tile.cuh share_row, ell_lanes.cuh), its eagg
//   slice added, the sums stored into the row-major tile of all 8 CTAs by
//   DSMEM. One cluster barrier a live tile: the tile is double-buffered, so
//   a peer writes a buffer again only after every CTA passed the next
//   tile's barrier, which each reaches after its reads of this one.
// - Then CTA r computes its output columns on the whole tile (slice_pass:
//   the K rows over the 8 warps, a thread 4 rows x 4 columns), the ReLU
//   (except on the last layer) and the mask fused into the write-back. The
//   activations ping-pong through the slot's global scratch (B, 2, n, D);
//   within a CTA a layer needs only a block barrier, since a CTA reads back
//   only columns it wrote.
// - A layer walks the slot's live tiles (a nonzero mask) from a bitmask of
//   a chunk of 65,536 rows (cluster_common.cuh live_bits), chunk by chunk:
//   any n runs; dead tiles' own columns are written as zeros.
// - Shared memory: the two tiles (32 x (D rounded up to 32, + 4)), the
//   partial sums (16 KB), the live bits and, where it fits, the W slice; it
//   does not grow with n or k, and every (k, D) the one-CTA kernel before it
//   took still fits.
//
// What bounds it. Inside a slot the layers are serial, and a pass is a
// chain of latencies: the ELL round trip, the gathers, the DSMEM stores,
// the cluster barrier and the products (2 x 32 x din x dout / 8 flops a
// CTA and tile).
// The card's roofline, set by the bytes of the inputs (~0.01 ms on the
// main path), is far below it. At 2 CTAs an SM (128 registers) 32 clusters
// run at once, so BC-Alpha's 137 slots take ~4 waves, and the throughput
// of a pass sets the launch (PERF.md splits the largest slot's cycles by
// phase, tools/cluster_engine_profile.py). On BC-Alpha's 137 slots it took
// ~0.23 ms kernel duration a launch, in turns with the one-CTA-a-slot
// kernel it replaced (~0.78), on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md's kernel table).
// Registers (nvcc -Xptxas -v, sm_90a): 124-128 in its three variants, no
// spills.
#include "cell_tile.cuh"
#include "slice_tile.cuh"

namespace {

using cluster::kCluster;
constexpr int kThreads = slice::kThreads;
constexpr int kRows = slice::kRows;
// layers whose true widths a launch takes (more: all D wide)
constexpr int kMaxLayers = 32;

struct StaticArgs {
  const int* idx;     // (B, n, k) local neighbour ids (T = 1)
  const float* coef;  // (B, n, k)
  const float* x;     // (B, n, D)
  const float* mask;  // (B, n)
  const float* w;     // (L, D, D) shared by the slots
  const float* bias;  // (L, D)
  const float* eagg;  // (B, L, n, D) pre-aggregated edge term, or null
  float* out;         // (B, n, D) last layer's activations
  float* act;         // (B, 2, n, D) scratch
  int n, k, L, D;
  bool vec;           // float4 gathers and zero stores (D a multiple of
                      // 4, 16-byte aligned bases)
  int width[kMaxLayers + 1];  // din_0, dout_0 = din_1, ..., dout_{L-1}
};

// A CTA's shared memory, in floats: two row-major buffers of a pass's rows
// (kRT threads a row: 8 rows a warp, 64 a pass, at kRT 4; 4 rows a warp,
// 32 a pass, at 8), the partial sums of each tile of a pass, the live-tile
// bits, the bias slice and, where it fits, the W slice (ldw columns).
struct Layout {
  int stride, ldw, rows;
  size_t part, bits, bs, ws, floats;
};

__host__ __device__ inline Layout place(int D, bool w_smem, int rt) {
  Layout L;
  L.stride = slice::k_stride(D);
  L.ldw = slice::round_up(cluster::slice_max(D), slice::kPassCols);
  L.rows = slice::kWarps * (32 / rt);
  L.part = (size_t)2 * L.rows * L.stride;
  L.bits = L.part + (size_t)L.rows / kRows * slice::kPartFloats;
  L.bs = L.bits + cluster::kLiveWords;
  L.ws = L.bs + L.ldw;
  L.floats = L.ws + (w_smem ? (size_t)slice::k_cols(D) * L.ldw : 0);
  return L;
}

// The launch's variant at D: two tiles a pass (kRT 4) with the W slice in
// shared memory where both fit, else without it, else one tile a pass
// (kRT 8) without it.
struct Variant {
  bool w_smem;
  int rt;
};

__host__ __device__ inline Variant variant(int D) {
  const auto fits = [&](bool w, int rt) {
    return place(D, w, rt).floats * sizeof(float) <= cluster::kSmemLimit;
  };
  if (fits(true, 4)) return {true, 4};
  if (fits(false, 4)) return {false, 4};
  return {false, 8};
}

// Zeros into columns [c0, c0 + w) of the rows [v0, v1) of dst (D floats a
// row) whose tile is dead in the chunk's bits (tile q0 first), or of every
// row (bits null), by all threads; float4 stores where `vec` (dst 16-byte
// aligned, D a multiple of 4) and c0 and w allow.
__device__ __forceinline__ void zero_cols(float* dst, int D, int c0, int w,
                                          const uint32_t* bits, int q0,
                                          int v0, int v1, bool vec) {
  const int piece = vec && c0 % 4 == 0 && w % 4 == 0 ? 4 : 1;
  const int wp = w / piece;
  for (int p = threadIdx.x; p < (v1 - v0) * wp; p += kThreads) {
    const int v = v0 + p / wp, c = c0 + (p % wp) * piece;
    if (bits != nullptr && cluster::tile_live(bits, q0, v / kRows)) continue;
    float* at = dst + (size_t)v * D + c;
    if (piece == 4)
      *reinterpret_cast<float4*>(at) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    else
      *at = 0.0f;
  }
}

template <bool kSmemW, int kRT>
__global__ void __launch_bounds__(kThreads, 2)
    static_engine_kernel(const __grid_constant__ StaticArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kWarpRows = 32 / kRT;
  constexpr int kPassTiles = slice::kWarps * kWarpRows / kRows;
  const int n = a.n, k = a.k, L = a.L, D = a.D;
  const Layout lay = place(D, kSmemW, kRT);
  const int S = lay.stride;
  float* const part = smem + lay.part;
  uint32_t* const bits = reinterpret_cast<uint32_t*>(smem + lay.bits);
  float* const bs = smem + lay.bs;
  float* const ws = smem + lay.ws;
  const unsigned rank = cluster::ctarank();
  const int b = (int)(blockIdx.x / kCluster);  // the slot
  const int* idx = a.idx + (size_t)b * n * k;
  const float* coef = a.coef + (size_t)b * n * k;
  const float* mask = a.mask + (size_t)b * n;
  float* act = a.act + (size_t)b * 2 * n * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane / kRT, t = lane % kRT;
  const int ar = warp * kWarpRows + group;  // the pass row it gathers
  const int rr = threadIdx.x / 8, cc = threadIdx.x % 8 * 2;  // its outputs
  const auto width = [&](int l) { return L <= kMaxLayers ? a.width[l] : D; };
  // PROF_INIT
  slice::arrive_running();  // a peer may store into this CTA's buffers once
                            // all have arrived
  bool waited = false;      // on that first barrier
  int buf = 0;              // the next pass's buffer

  for (int l = 0; l < L; ++l) {
    const int din = width(l), dout = width(l + 1), kc = slice::k_cols(din);
    const int ilo = cluster::slice_lo(din, (int)rank);
    const int ihi = cluster::slice_lo(din, (int)rank + 1);
    const int olo = cluster::slice_lo(dout, (int)rank);
    const int ow = cluster::slice_lo(dout, (int)rank + 1) - olo;
    const float* src = l == 0 ? a.x + (size_t)b * n * D
                              : act + (size_t)((l - 1) % 2) * n * D;
    float* dst = l == L - 1 ? a.out + (size_t)b * n * D
                            : act + (size_t)(l % 2) * n * D;
    const float* ea = a.eagg != nullptr
                          ? a.eagg + ((size_t)b * L + l) * n * D : nullptr;
    const float* wl = a.w + (size_t)l * D * D + olo;
    const bool relu = l < L - 1;
    const bool vec = a.vec && din % 32 == 0;  // whole float4 slices
    cell::cp_async_wait<0>();
    __syncthreads();  // the last layer's reads of the buffers, bs, ws done
    if constexpr (kSmemW) {  // the own columns of W_l, zeros past them
      for (int p = threadIdx.x; p < kc * lay.ldw; p += kThreads) {
        const int kk = p / lay.ldw, c = p - kk * lay.ldw;
        const bool ok = kk < din && c < ow;
        cell::cp_async4(ws + p, ok ? wl + (size_t)kk * D + c : wl, ok);
      }
      cell::cp_async_commit();
    }
    for (int c = threadIdx.x; c < ow; c += kThreads)
      bs[c] = a.bias[(size_t)l * D + olo + c];
    // the buffers' columns [din, kc): zeros (no peer stores there)
    for (int p = threadIdx.x; p < 2 * lay.rows * (kc - din); p += kThreads)
      smem[(p / (kc - din)) * S + din + p % (kc - din)] = 0.0f;
    bool ws_ready = !kSmemW;
    // PROF(0) layer set-up (W issue, padding columns)

    for (int q0 = 0; q0 * kRows < n; q0 += cluster::kChunkTiles) {
      // the live tiles: the mask is every layer's, so one chunk's bits
      // stay
      if (l == 0 || n > cluster::kChunkTiles * kRows)
        cluster::live_bits(mask, n, q0, bits);
      // PROF(1) live bits
      const int qend = cluster::chunk_end(q0, n);
      const int v0 = q0 * kRows, vend = min(qend * kRows, n);
      zero_cols(dst, D, olo, ow, bits, q0, v0, vend, a.vec);
      if (l == L - 1 && dout < D) {  // the padded columns: zeros, a share
        const int plo = dout + cluster::slice_lo(D - dout, (int)rank);
        const int pw = dout + cluster::slice_lo(D - dout, (int)rank + 1) - plo;
        zero_cols(dst, D, plo, pw, nullptr, q0, v0, vend, a.vec);
      }
      // PROF(2) dead rows, padded columns
      // the live tiles, kPassTiles (1 or 2) a pass: tiles q1 and q2 (q2
      // qend where the pass has one)
      for (int q1 = cluster::next_live(bits, q0, q0, n); q1 < qend;) {
        const int q2 =
            kPassTiles == 2 ? cluster::next_live(bits, q0, q1 + 1, n) : qend;
        float* const pass = smem + (size_t)buf * lay.rows * S;
        buf ^= 1;
        // row ar of the pass: row ar % 32 of its tile (past n where the
        // pass has no such tile: zeros)
        const int qa = ar < kRows ? q1 : q2;
        const int v = qa < qend ? qa * kRows + ar % kRows : n;
        ell::Entry first[ell::kEntries<kRT>];
        const unsigned live = ell::load_round<kRT>(
            idx, coef, nullptr, (size_t)v * k, v < n, 0, k, t, group, false,
            first);
        const float* ear = ea != nullptr && v < n ? ea + (size_t)v * D
                                                  : nullptr;
        if (vec)
          slice::share_row<4, false, kRT>(
              src, D, din, nullptr, ear, idx, coef, nullptr, v, n, k, first,
              live, t, group, ilo / 4, ihi / 4, pass + ar * S, !waited);
        else
          slice::share_row<1, false, kRT>(
              src, D, din, nullptr, ear, idx, coef, nullptr, v, n, k, first,
              live, t, group, ilo, ihi, pass + ar * S, !waited);
        waited = true;
        // PROF(3) ELL + gathers + DSMEM stores
        // the tiles' masks (their loads overlap the barrier)
        float m[kPassTiles];
#pragma unroll
        for (int i = 0; i < kPassTiles; ++i) {
          const int vr = (i == 0 ? q1 : q2) * kRows + rr;
          m[i] = (i == 0 || q2 < qend) && vr < n ? mask[vr] : 0.0f;
        }
        cluster::sync();  // every CTA's columns are in every CTA's buffer
        if (!ws_ready) {
          cell::cp_async_wait<0>();
          __syncthreads();
          ws_ready = true;
        }
        // PROF(4) cluster barrier (+ W landed)
        // the own output columns of the pass's tiles, kPassCols at a time
        for (int c0 = 0; c0 < ow; c0 += slice::kPassCols) {
#pragma unroll
          for (int i = 0; i < kPassTiles; ++i)
            if (i == 0 || q2 < qend)
              slice::slice_pass<kSmemW>(
                  pass + (size_t)i * kRows * S, S, kc, ws + c0, lay.ldw,
                  wl + c0, D, din, min(slice::kPassCols, ow - c0),
                  part + i * slice::kPartFloats);
          __syncthreads();
#pragma unroll
          for (int i = 0; i < kPassTiles; ++i) {
            const int vr = (i == 0 ? q1 : q2) * kRows + rr;
            if (i > 0 && q2 >= qend) break;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = c0 + cc + e;
              if (c < ow && vr < n) {
                float h = slice::slice_sum(part + i * slice::kPartFloats, rr,
                                           cc + e, bs[c]);
                if (relu) h = fmaxf(h, 0.0f);
                dst[(size_t)vr * D + olo + c] = h * m[i];
              }
            }
          }
          __syncthreads();  // the partials are read out
        }
        // PROF(5) products + write-back
        q1 = cluster::next_live(bits, q0, (q2 < qend ? q2 : q1) + 1, n);
      }
    }
  }
  if (!waited) cluster::wait();  // the first barrier (no live tile)
  // PROF_END
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

size_t static_engine_smem_bytes(int k, int D) {
  const Variant var = variant(D);
  return sizeof(float) * place(D, var.w_smem, var.rt).floats;
}

// the launch over B slots: out = CTAs a cluster, CTAs, threads, shared
// bytes, W's slice in shared memory (1) or not, layers whose true widths a
// launch takes, rows a pass
int static_engine_plan(int B, int k, int D, int* out) {
  const Variant var = variant(D);
  out[0] = kCluster;
  out[1] = B * kCluster;
  out[2] = kThreads;
  out[3] = (int)static_engine_smem_bytes(k, D);
  out[4] = var.w_smem ? 1 : 0;
  out[5] = kMaxLayers;
  out[6] = place(D, var.w_smem, var.rt).rows;
  return 0;
}

// widths: L + 1 true widths (host memory), or null for D throughout
int static_engine_launch(const void* idx, const void* coef, const void* x,
                         const void* mask, const void* w, const void* bias,
                         const void* eagg, const void* widths,
                         void* out, void* act, int B, int n, int k, int L,
                         int D, void* stream) {
  StaticArgs a{};
  a.idx = static_cast<const int*>(idx);
  a.coef = static_cast<const float*>(coef);
  a.x = static_cast<const float*>(x);
  a.mask = static_cast<const float*>(mask);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.eagg = static_cast<const float*>(eagg);
  a.out = static_cast<float*>(out);
  a.act = static_cast<float*>(act);
  a.n = n; a.k = k; a.L = L; a.D = D;
  if (B <= 0 || n <= 0 || L <= 0 || D <= 0) return 0;
  const int* wd = static_cast<const int*>(widths);
  for (int l = 0; l <= L && l <= kMaxLayers; ++l) {
    a.width[l] = wd != nullptr ? wd[l] : D;
    if (a.width[l] < 1 || a.width[l] > D) return (int)cudaErrorInvalidValue;
  }
  a.vec = D % 4 == 0 && aligned16(x) && aligned16(act) && aligned16(out) &&
          (eagg == nullptr || aligned16(eagg));
  const Variant var = variant(D);
  const size_t smem = sizeof(float) * place(D, var.w_smem, var.rt).floats;
  if (var.w_smem)
    return cluster::launch(static_engine_kernel<true, 4>, B, kThreads, smem,
                           stream, a);
  return var.rt == 4 ? cluster::launch(static_engine_kernel<false, 4>, B,
                                       kThreads, smem, stream, a)
                     : cluster::launch(static_engine_kernel<false, 8>, B,
                                       kThreads, smem, stream, a);
}

const char* static_engine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
