// Flash attention forward for Hopper (sm_90a): causal or full attention
// with online softmax, GQA without a KV repeat, with or without the
// logsumexp rows.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (_flash_kernel, entry point flash_attention_launch) and _flash_fwd
// (_flash_fwd_kernel, entry point flash_fwd_launch), which the LM scaffold
// reaches through attention_block(attn_impl="flash") -> flash_mha.
//
// What it computes (the plain versions are repro_torch/kernels/
// flash_attention.py flash_attention_plain / flash_fwd_plain), for q
// (BH, S, d), k / v (BH / group, Skv, d), q head bh reading kv head
// bh / group:
//   s   = (q . k^T) / sqrt(d) in fp32; masked (causal qpos < kpos) to -1e30
//   online over kv tiles: m' = max(m, rowmax s), alpha = exp(m - m'),
//   p = exp(s - m'), l = l alpha + rowsum p (p unrounded),
//   acc = acc alpha + round_T(p) . v          (p rounded to the value type)
//   o   = acc / max(l, 1e-30) in q's type; lse = m + log(max(l, 1e-30)).
//
// What bounds it. Per (q, k) pair the function does 4 d flops (q.k and
// p.v); its bytes are q, k, v, o (and lse) once. At the LM path's shape
// (Qwen2.5-14B prefill: B 2, S 2048, 40 / 8 heads, d 128, bf16, causal)
// that is 85.9 GFLOP against 101 MB: bound by operations, 0.087 ms at the
// card's 989 TFLOP/s bf16 dense (the bytes take 0.030 ms at 3.35 TB/s).
// So the bf16 kernel is built to keep the tensor cores fed:
//
// * bf16 (the LM path): a CTA owns 128 q rows of one q head and is three
//   warpgroups. Warpgroup 0 is the producer: after setmaxnreg gives its
//   registers to the others, one thread loads the q tile once and then
//   every 128-key k and v tile through a ring of kStages slots in shared
//   memory with TMA (cp.async.bulk.tensor, 128-byte swizzle; rows past S
//   or Skv and columns past d arrive as zeros), each slot with a full and
//   an empty mbarrier for its k tile and for its v tile, so a k tile is
//   refilled as soon as its scores are done. Warpgroups 1 and 2 are
//   consumers of 64 q rows each: s = q . k^T by wgmma m64n128k16 from
//   shared memory (both K-major) into fp32 registers; the online softmax
//   in registers (row max and sum over the quad of threads that shares a
//   row; the scale folded into one FFMA, s log2(e) / sqrt(d), and exp2 on
//   the MUFU unit; masks only on a causal diagonal tile and a ragged last
//   kv tile); then o = o alpha + p . v by wgmma m64n128k16 with p's bf16
//   A fragments made straight from the score registers and v read
//   MN-major (transposed) from its slot. Each consumer issues tile kt's
//   q . k^T together with tile kt - 1's p . v and runs tile kt's softmax
//   while p . v is in flight; the two consumers take turns to issue (named
//   barriers), so one's softmax overlaps the other's products. The
//   epilogue writes o through the q tile's shared memory and a TMA store.
//   Products of bf16 values are exact in fp32 and the sums are fp32, as
//   the TPU kernel's preferred_element_type=f32; p is rounded to bf16 for
//   p.v and l sums it unrounded; m is kept in raw q.k units, so lse = m /
//   sqrt(d) + log(l) is in natural-log units, as the backward kernels read
//   it. head_dim is held as 128 columns (two swizzle atoms; a second atom
//   only where d > 64, and ceil(d / 16) k-steps of q . k^T, a template
//   argument): any multiple of 8 up to 128.
// * fp32: CUDA cores, 256 threads, each 4 rows x 4 scores and 4 x 8 output
//   columns (a row's 16 threads are one half warp: max and sum are
//   shuffles); the q, k and v tiles in shared memory as fp32 (rows padded
//   by 4 floats), the p tile over the k tile: 101 KB at d = 128; expf /
//   logf and IEEE division. One CTA per (bh, 64-row q tile), a loop over
//   64-key kv tiles.
//
// Tiles. Both kernels' tiles are their own, whatever bq / bk the caller
// names: the wrapper validates bq / bk as the JAX package does (min(bq, S)
// | S, min(bk, Skv) | Skv), and since masking, not tiling, decides which
// keys a row sees, the result does not depend on the tile up to the order
// of summation (and, in bf16, where p is rounded relative to the running
// max). A loop inside the CTA over kv tiles takes the place of the TPU
// grid's sequential kv axis, so m, l and the fp32 accumulator stay in
// registers for the whole row block; causal kv tiles past the q tile's
// last row are never visited, and the longest q tiles start first.
#include "flash_common.cuh"
#include "hopper_common.cuh"

#include <cmath>

namespace {

using flash::kMaxD;
using flash::kNegInf;
using flash::kPld;
using flash::pack_bf16;

constexpr int kBQ = flash::kTile;  // q rows a CTA
constexpr int kBK = flash::kTile;  // keys a kv tile
constexpr int kThreads = 256;      // 16 row groups x 16 column lanes


template <class T>
struct Args {
  const T* q;    // (bh, s, d)
  const T* k;    // (bh / group, skv, d)
  const T* v;    // (bh / group, skv, d)
  T* o;          // (bh, s, d)
  float* lse;    // (bh, s), flash_fwd only
  int s, skv, d, group, causal;
  float sqrt_d;  // float(sqrt(d)): the TPU kernel divides by it
};

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <bool kLse>
__global__ void __launch_bounds__(kThreads, 2) flash_fp32_kernel(
    Args<float> a) {
  extern __shared__ __align__(16) float smem[];
  const int d = a.d, ld = d + 4;
  float* qs = smem;                               // (64, d + 4)
  float* ks = qs + kBQ * ld;                      // (64, d + 4)
  float* ps = ks;                                 // (64, 68), over ks
  float* vs = ks + max(kBK * ld, kBQ * kPld);     // (64, d + 4)
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t kv_off = (size_t)(bh / a.group) * a.skv * d;
  const float* k = a.k + kv_off;
  const float* v = a.v + kv_off;

  flash::load_tile_f32<kThreads>(a.q + (size_t)bh * a.s * d, q0, a.s, d, qs);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  int n_kv = (a.skv + kBK - 1) / kBK;
  if (a.causal) n_kv = min(n_kv, (q0 + kBQ - 1) / kBK + 1);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's p . v is done with ps and vs
    flash::load_tile_f32<kThreads>(k, k0, a.skv, d, ks);
    flash::load_tile_f32<kThreads>(v, k0, a.skv, d, vs);
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int kk = 0; kk < d; kk += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * ld + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * ld + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    __syncthreads();  // every thread is done with ks: ps overwrites it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool seen = kpos < a.skv && (!a.causal || qpos >= kpos);
        s[i][j] = seen ? s[i][j] / a.sqrt_d : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty * 4 + i) * kPld + tx + 16 * j] = p;  // fp32: no rounding
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // the p tile is complete

    // acc += p . v: rows ty*4 + i, columns tx*4 + 64 g + e
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kPld + j);
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int col = tx * 4 + 64 * g;
        if (col >= d) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vs + (j + e) * ld + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y
                          : e == 2 ? pv[i].z : pv[i].w;
            acc[i][4 * g + 0] = fmaf(p, vv.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(p, vv.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(p, vv.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(p, vv.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.s) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int col = tx * 4 + 64 * g;
      if (col >= d) continue;
      const float4 out = make_float4(
          acc[i][4 * g + 0] / lc, acc[i][4 * g + 1] / lc,
          acc[i][4 * g + 2] / lc, acc[i][4 * g + 3] / lc);
      *reinterpret_cast<float4*>(a.o + ((size_t)bh * a.s + row) * d + col) =
          out;
    }
    if (kLse && tx == 0) a.lse[(size_t)bh * a.s + row] = m[i] + logf(lc);
  }
}


// ---------------------------------------------------------------- bf16 ----

constexpr int kHBQ = 128;  // q rows a CTA: two consumer warpgroups of 64
constexpr int kHBK = 128;  // keys a kv tile
constexpr int kHD = 128;   // head_dim as held: two 64-column swizzle atoms
constexpr int kAtoms = kHD / hopper::kAtomCols;
constexpr int kStages = 2;     // slots of the k / v ring
constexpr int kConsumers = 2;  // warpgroups of 64 q rows
constexpr int kWgRows = kHBQ / kConsumers;
constexpr int kHThreads = hopper::kWarpgroup * (1 + kConsumers);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr uint32_t kQAtomBytes = kHBQ * hopper::kRowBytes;   // 16 KB
constexpr uint32_t kKvAtomBytes = kHBK * hopper::kRowBytes;  // 16 KB
constexpr uint32_t kQBytes = kAtoms * kQAtomBytes;
constexpr uint32_t kKvBytes = kAtoms * kKvAtomBytes;
// q_full, then for each slot k_full, v_full, k_empty and v_empty
constexpr int kBarriers = 1 + 4 * kStages;
// [alignment slack][q][k0][v0][k1][v1]...[barriers]: the tiles 1024-byte
// aligned, as the swizzle needs
constexpr size_t kHSmem =
    1024 + kQBytes + 2 * kStages * kKvBytes + 8 * kBarriers;
// named barriers: consumer w's turn to issue products is 1 + w; its
// epilogue's is 3 + w
constexpr int kTurnBar = 1, kEpilogueBar = 3;

struct HArgs {
  __nv_bfloat16* o;  // (bh, s, d)
  float* lse;        // (bh, s), flash_fwd only
  int s, skv, d, group, causal;
  float scale_log2;  // log2(e) / sqrt(d): exp(x / sqrt(d)) = 2^(x scale_log2)
  float inv_sqrt_d;
};

// What the launcher builds, and the library exports (flash_fwd_config).
struct FwdConfig {
  int q_rows, kv_rows, stages, threads, smem, grid_x, grid_y;
};

FwdConfig fwd_config(int bh, int s) {
  return {kHBQ, kHBK, kStages, kHThreads, (int)kHSmem, bh,
          (s + kHBQ - 1) / kHBQ};
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// s = q . k^T over kSteps 16-wide k-steps, committed as one group. The
// count is a template argument: a branch between the products of one
// accumulator makes ptxas serialise them.
template <int kSteps>
__device__ __forceinline__ void issue_scores(float (&s)[kHBK / 2],
                                             uint32_t q_rows, uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const uint32_t qoff = (kk / 4) * kQAtomBytes + (kk % 4) * 32;
    const uint32_t koff = (kk / 4) * kKvAtomBytes + (kk % 4) * 32;
    hopper::wgmma_m64n128k16_ss(
        s, hopper::desc_b128(q_rows + qoff, 16, hopper::kCoreRowsBytes),
        hopper::desc_b128(ks + koff, 16, hopper::kCoreRowsBytes), kk > 0);
  }
  hopper::wgmma_commit();
}

// o += p . v over the tile's 128 keys, committed as one group: p as the A
// fragments in registers; v's keys along the rows (K), its columns along
// the row (N, MN-major): a k-step is 16 rows on, the next 64 columns one
// atom on
__device__ __forceinline__ void issue_values(float (&o)[kHD / 2],
                                             const uint32_t (&pa)[kHBK / 16][4],
                                             uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < kHBK / 16; ++kk)
    hopper::wgmma_m64n128k16_rs_tb(
        o, pa[kk],
        hopper::desc_b128(vs + kk * 16 * hopper::kRowBytes, kKvAtomBytes,
                          hopper::kCoreRowsBytes),
        1);
  hopper::wgmma_commit();
}

// kSteps: the 16-wide k-steps of q . k^T, ceil(d / 16)
template <bool kLse, int kSteps>
__global__ void __launch_bounds__(kHThreads, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap to, HArgs a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sq = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t skv = sq + kQBytes;  // slot st: k at + 2 st kKvBytes, v next
  const uint32_t bars = skv + 2 * kStages * kKvBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8u * (1 + st); };
  auto v_full = [&](int st) { return bars + 8u * (1 + kStages + st); };
  auto k_empty = [&](int st) { return bars + 8u * (1 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return bars + 8u * (1 + 3 * kStages + st); };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kHBQ;  // longest tiles first
  int n_kv = (a.skv + kHBK - 1) / kHBK;
  if (a.causal) n_kv = min(n_kv, (min(q0 + kHBQ, a.s) - 1) / kHBK + 1);
  const int n_atoms = (a.d + hopper::kAtomCols - 1) / hopper::kAtomCols;
  // the warpgroup, through a shuffle: the compiler then knows it is
  // warp-uniform, so the roles' branches stay converged and the wgmma
  // descriptors live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / hopper::kWarpgroup, 0);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(k_full(st), 1);
      hopper::mbar_init(v_full(st), 1);
      hopper::mbar_init(k_empty(st), kConsumers * hopper::kWarpgroup);
      hopper::mbar_init(v_empty(st), kConsumers * hopper::kWarpgroup);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread issues every copy
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const int kv = bh / a.group;
      hopper::mbar_expect_tx(q_full, n_atoms * kQAtomBytes);
      for (int at = 0; at < n_atoms; ++at)
        hopper::tma_load_3d(sq + at * kQAtomBytes, &tq, q_full,
                            at * hopper::kAtomCols, q0, bh);
      for (int kt = 0; kt < n_kv; ++kt) {
        const int st = kt % kStages;
        // the slot's last k (v) tile was released; passes at once the
        // first round
        const uint32_t parity = ((kt / kStages) & 1) ^ 1;
        const uint32_t ks = skv + 2 * st * kKvBytes, vs = ks + kKvBytes;
        hopper::mbar_wait(k_empty(st), parity);
        hopper::mbar_expect_tx(k_full(st), n_atoms * kKvAtomBytes);
        for (int at = 0; at < n_atoms; ++at)
          hopper::tma_load_3d(ks + at * kKvAtomBytes, &tk, k_full(st),
                              at * hopper::kAtomCols, kt * kHBK, kv);
        hopper::mbar_wait(v_empty(st), parity);
        hopper::mbar_expect_tx(v_full(st), n_atoms * kKvAtomBytes);
        for (int at = 0; at < n_atoms; ++at)
          hopper::tma_load_3d(vs + at * kKvAtomBytes, &tv, v_full(st),
                              at * hopper::kAtomCols, kt * kHBK, kv);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;  // rows kWgRows cw .. of the q tile
  const int tid = threadIdx.x % hopper::kWarpgroup;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, column pair
  // this thread's rows: row0 and row0 + 8 (h = 0, 1)
  const int row0 = q0 + kWgRows * cw + 16 * warp + g;
  const float c = a.scale_log2;
  // this warpgroup's rows of the q tile (kWgRows rows of each atom)
  const uint32_t q_rows = sq + kWgRows * cw * hopper::kRowBytes;
  // s[4 j + 2 h + e]: row row0 + 8 h, key k0 + 8 j + 2 t + e of a tile's
  // scores, then its p; o[4 j + 2 h + e]: row row0 + 8 h, column
  // 8 j + 2 t + e; pa: p as the A fragments of p . v's 8 k-steps of 16
  // keys (regs 0 / 1 rows g / g + 8 at keys 2t, 2t + 1, regs 2 / 3 the
  // same 8 keys on)
  float s[kHBK / 2], o[kHD / 2];
  uint32_t pa[kHBK / 16][4];
#pragma unroll
  for (int i = 0; i < kHD / 2; ++i) o[i] = 0.f;
  // m in raw q . k units (the scale is in c); l this thread's part of the
  // row sum (the quad's four parts are added at the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

  // tile kt's masks (the keys past Skv of a ragged last tile, and causal
  // keys past a row where the tile reaches past the warpgroup's first
  // row), then the online softmax over s: p = 2^(s c - m c)
  auto softmax = [&](int kt) {
    const int k0 = kt * kHBK;
    if (k0 + kHBK > a.skv ||
        (a.causal && k0 + kHBK - 1 > q0 + kWgRows * cw)) {
#pragma unroll
      for (int j = 0; j < kHBK / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + 2 * t + e;
            if (key >= a.skv || (a.causal && key > row0 + 8 * h))
              s[4 * j + 2 * h + e] = -INFINITY;
          }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < kHBK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = quad_max(mx);
      // every row sees a key of every tile it visits, so mx is finite;
      // the guard keeps a row that saw none at p = 0
      const float mc = mx == -INFINITY ? 0.f : mx * c;
      alpha[h] = hopper::ex2(fmaf(m[h], c, -mc));
      m[h] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kHBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * h + e];
          x = hopper::ex2(fmaf(x, c, -mc));
          sum += x;
        }
      l[h] = l[h] * alpha[h] + sum;
    }
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kHBK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  // The consumers take turns to issue their products (consumer 0 first),
  // so one's softmax runs while the other's products keep the tensor
  // cores busy.
  auto my_turn = [&]() {
    hopper::bar_sync(kTurnBar + cw, 2 * hopper::kWarpgroup);
  };
  auto pass_turn = [&]() {
    hopper::bar_arrive(kTurnBar + 1 - cw, 2 * hopper::kWarpgroup);
  };

  if (cw == 0) hopper::bar_arrive(kTurnBar, 2 * hopper::kWarpgroup);
  hopper::mbar_wait(q_full, 0);
  // tile 0's scores and softmax
  hopper::mbar_wait(k_full(0), 0);
  hopper::wgmma_fence();
  my_turn();
  issue_scores<kSteps>(s, q_rows, skv);
  pass_turn();
  hopper::wgmma_wait<0>();
  hopper::reg_fence(s);
  hopper::mbar_arrive(k_empty(0));
  softmax(0);
  pack_p();
  // step kt: tile kt's q . k^T and tile kt - 1's p . v in flight together;
  // tile kt's softmax runs while p . v does
  for (int kt = 1; kt < n_kv; ++kt) {
    const int st = kt % kStages, pst = (kt - 1) % kStages;
    // o's rescale and p's packing happen before the products, not between
    hopper::reg_fence(o);
    hopper::reg_fence(pa);
    hopper::mbar_wait(k_full(st), (kt / kStages) & 1);
    hopper::mbar_wait(v_full(pst), ((kt - 1) / kStages) & 1);
    hopper::wgmma_fence();
    my_turn();
    issue_scores<kSteps>(s, q_rows, skv + 2 * st * kKvBytes);
    issue_values(o, pa, skv + 2 * pst * kKvBytes + kKvBytes);
    pass_turn();
    hopper::wgmma_wait<1>();  // the scores; p . v still in flight
    hopper::reg_fence(s);
    hopper::mbar_arrive(k_empty(st));  // this thread is done with the k tile
    softmax(kt);
    hopper::wgmma_wait<0>();
    hopper::reg_fence(o);
    hopper::reg_fence(pa);
    hopper::mbar_arrive(v_empty(pst));  // and with the v tile before it
#pragma unroll
    for (int j = 0; j < kHD / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[4 * j + 2 * h] *= alpha[h];
        o[4 * j + 2 * h + 1] *= alpha[h];
      }
    pack_p();
  }
  // the last tile's p . v
  const int pst = (n_kv - 1) % kStages;
  hopper::reg_fence(o);
  hopper::reg_fence(pa);
  hopper::mbar_wait(v_full(pst), ((n_kv - 1) / kStages) & 1);
  hopper::wgmma_fence();
  my_turn();
  issue_values(o, pa, skv + 2 * pst * kKvBytes + kKvBytes);
  pass_turn();
  hopper::wgmma_wait<0>();
  hopper::reg_fence(o);
  hopper::reg_fence(pa);
  hopper::mbar_arrive(v_empty(pst));

  // o = acc / l into this warpgroup's own rows of the q tile's shared
  // memory (its products are done with them), 128-byte swizzled as TMA
  // reads it; then one TMA store a 64-column atom, which writes no row
  // past S and no column past d
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lc = fmaxf(quad_sum(l[h]), 1e-30f);
    const float inv = 1.f / lc;
    const int r = 16 * warp + g + 8 * h;  // row of the warpgroup's
#pragma unroll
    for (int j = 0; j < kHD / 8; ++j)
      hopper::st_shared_u32(q_rows + (j / 8) * kQAtomBytes +
                                r * hopper::kRowBytes +
                                (((j % 8) ^ (r % 8)) << 4) + 4 * t,
                            pack_bf16(o[4 * j + 2 * h] * inv,
                                      o[4 * j + 2 * h + 1] * inv));
    const int row = row0 + 8 * h;
    if (kLse && t == 0 && row < a.s)
      a.lse[(size_t)bh * a.s + row] = m[h] * a.inv_sqrt_d + logf(lc);
  }
  hopper::fence_proxy_async_smem();
  hopper::bar_sync(kEpilogueBar + cw, hopper::kWarpgroup);
  if (tid == 0) {
    for (int at = 0; at < n_atoms; ++at)
      hopper::tma_store_3d(&to, q_rows + at * kQAtomBytes,
                           at * hopper::kAtomCols, q0 + kWgRows * cw, bh);
    hopper::tma_store_commit_and_wait_read();
  }
}

size_t smem_bytes(int d) {
  const int ld = d + 4;
  return sizeof(float) *
         (size_t)(2 * kBQ * ld + (kBK * ld > kBQ * kPld ? kBK * ld
                                                        : kBQ * kPld));
}

template <class T, class Kernel>
int launch_kernel(Kernel kernel, int threads, size_t smem, const void* q,
                  const void* k, const void* v, void* o, void* lse, int bh,
                  int s, int skv, int d, int group, int causal,
                  void* stream) {
  Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<T*>(o),
            static_cast<float*>(lse), s, skv, d, group, causal,
            (float)std::sqrt((double)d)};
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (s + kBQ - 1) / kBQ);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <bool kLse>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int bh, int s, int skv, int d, int group,
                int causal, void* stream) {
  CUtensorMap tq, tk, tv, to;
  cudaError_t err = hopper::bf16_tile_map(&tq, q, d, s, bh, kHBQ);
  if (err == cudaSuccess)
    err = hopper::bf16_tile_map(&tk, k, d, skv, bh / group, kHBK);
  if (err == cudaSuccess)
    err = hopper::bf16_tile_map(&tv, v, d, skv, bh / group, kHBK);
  if (err == cudaSuccess)
    err = hopper::bf16_tile_map(&to, o, d, s, bh, kWgRows);
  if (err != cudaSuccess) return (int)err;
  const FwdConfig cfg = fwd_config(bh, s);
  const double sqrt_d = std::sqrt((double)d);
  HArgs a{static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), s, skv,
          d, group, causal, (float)(1.4426950408889634 / sqrt_d),
          (float)(1.0 / sqrt_d)};
  using Kernel = void (*)(const CUtensorMap, const CUtensorMap,
                          const CUtensorMap, const CUtensorMap, HArgs);
  const Kernel by_steps[kHD / 16] = {
      flash_wgmma_kernel<kLse, 1>, flash_wgmma_kernel<kLse, 2>,
      flash_wgmma_kernel<kLse, 3>, flash_wgmma_kernel<kLse, 4>,
      flash_wgmma_kernel<kLse, 5>, flash_wgmma_kernel<kLse, 6>,
      flash_wgmma_kernel<kLse, 7>, flash_wgmma_kernel<kLse, 8>};
  const Kernel kernel = by_steps[(d + 15) / 16 - 1];
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(cfg.grid_x, cfg.grid_y), cfg.threads, cfg.smem,
           static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, to, a);
  return (int)cudaGetLastError();
}

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores)
template <bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int s, int skv, int d, int group, int causal, int dtype,
           void* stream) {
  if (d <= 0 || d % 8 != 0 || d > kMaxD || group <= 0 || bh % group != 0 ||
      s <= 0 || skv <= 0 || (s + kBQ - 1) / kBQ > 65535 ||
      (kLse && lse == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_kernel<float>(flash_fp32_kernel<kLse>, kThreads,
                                smem_bytes(d), q, k, v, o, lse, bh, s, skv,
                                d, group, causal, stream);
  if (dtype == 1)
    return launch_bf16<kLse>(q, k, v, o, lse, bh, s, skv, d, group, causal,
                             stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* lse, int bh, int s, int skv, int d,
                           int group, int causal, int dtype, void* stream) {
  return launch<false>(q, k, v, o, lse, bh, s, skv, d, group, causal, dtype,
                       stream);
}

int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int s, int skv, int d, int group,
                     int causal, int dtype, void* stream) {
  return launch<true>(q, k, v, o, lse, bh, s, skv, d, group, causal, dtype,
                      stream);
}

// The bf16 launch at (bh, s) as its launcher builds it for both entry
// points, into out[0..6]: q rows a CTA, keys a kv tile, ring slots,
// threads a CTA, dynamic shared memory bytes, grid x (q heads), grid y (q
// tiles). Returns 0.
int flash_fwd_config(int bh, int s, int* out) {
  const FwdConfig cfg = fwd_config(bh, s);
  const int vals[7] = {cfg.q_rows, cfg.kv_rows, cfg.stages, cfg.threads,
                       cfg.smem,   cfg.grid_x,  cfg.grid_y};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
