// Flash attention backward for Hopper (sm_90a): dK / dV and dQ of causal
// or full attention, GQA without a KV repeat, from the forward's saved
// q, k, v and logsumexp rows and the output's cotangent dO.
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_bwd (:278), the
// backward of flash_mha's custom VJP (:232, defvjp :340): its dK / dV pass
// _flash_dkv_kernel (:155, pallas_call :294; entry point
// flash_bwd_dkv_launch) and its dQ pass _flash_dq_kernel (:196,
// pallas_call :321; entry point flash_bwd_dq_launch). The LM reaches them
// when it trains with attn_impl="flash".
//
// What it computes (the plain versions are repro_torch/kernels/
// flash_attention.py flash_bwd_dkv_plain / flash_bwd_dq_plain), for q / dO
// (BH, S, d), k / v (BH / group, Skv, d), q head bh on kv head bh / group,
// lse and delta = rowsum(dO o) (BH, S) fp32, scale = float(1 / sqrt(d)):
//   p  = exp(scale (q . k^T) - lse), 0 where masked (causal: qpos < kpos)
//   dP = dO . v^T                       (fp32 accumulate)
//   dS = p (dP - delta) scale           (p unrounded)
//   dV = sum over the kv head's group of q heads of round(p)^T . dO
//   dK = sum of round(dS)^T . q;  dQ = round(dS) . k
// where round is the rounding to the inputs' type (bf16; none for fp32),
// the TPU kernels' rounding points; accumulators fp32, outputs in the
// inputs' type.
//
// Two kernels, as the TPU has two passes, so that every output is written
// once by one CTA: no atomics, and the result is the same on every run.
// Each recomputes p and dS for its tile pairs (the price of two passes).
//
// What bounds it. At the kernels' own count, per (q, k) pair the dkv pass
// does 8 d flops (q.k, dO.v, p^T.dO, dS^T.q) and the dq pass 6 d (q.k,
// dO.v, dS.k). At Qwen2.5-14B's layer shape (q (80, 2048, 128), k / v
// (16, 2048, 128), bf16, causal: 80 x 2048 x 2049 / 2 pairs) that is
// 171.9 and 128.9 GFLOP against ~100 MB each: bound by operations, 0.174
// and 0.130 ms at the card's 989 TFLOP/s bf16 dense. So the bf16 kernels
// are built, as the forward (flash_attention.cu), to keep the tensor cores
// fed, on the helpers of hopper_common.cuh:
//
// * A CTA is three warpgroups. Warpgroup 0 is the producer (setmaxnreg
//   24): one thread loads the CTA's fixed tiles once and then streams
//   64-row tiles through a ring of 3 slots with TMA (128-byte swizzle;
//   rows past S / Skv and columns past d arrive as zeros), a full and an
//   empty mbarrier a slot. Warpgroups 1 and 2 are consumers (setmaxnreg
//   240) of 64 of the CTA's 128 rows each; they run unpaired (named
//   barriers that made them take turns to issue cost 2-3 %). The scale
//   folds into one FFMA before exp2 on the MUFU unit (lse pre-multiplied
//   by log2(e)); masks only on causal diagonal and ragged tiles.
// * flash_bwd_dkv: one CTA per (kv head, 128-row kv tile), kv tile 0 (the
//   longest when causal) first. K and V load once; the ring streams the
//   group's (q head, 64-row q tile) pairs (from the diagonal on when
//   causal), which the TPU grid's folded (group, q tile) axis ran in
//   order, q and dO by TMA and their lse / delta rows by a second producer
//   warp with ordinary loads (a (BH, S) fp32 row is 16-byte aligned only
//   where S % 4 == 0; rows past S get lse +inf, so p = 0). A consumer
//   computes S^T = K . q^T and dP^T = V . dO^T by wgmma m64n64k16 from
//   shared memory (both K-major), p^T and dS^T in registers, then
//   dV += round(p^T) . dO and dK += round(dS^T) . q by wgmma m64n128k16
//   with A from registers (the accumulators' layout is the A fragment's)
//   and dO / q read MN-major from the same slot. dK and dV (64 + 64 fp32 a
//   thread) stay in registers for the whole loop; at the end they go, in
//   bf16, through the consumer's own rows of the K and V tiles and a TMA
//   store (rows past Skv, columns past d not written).
// * flash_bwd_dq: one CTA per (q head, 128-row q tile), the longest q
//   tiles first. q and dO load once; the ring streams 64-key k / v tiles
//   up to the diagonal. A consumer computes S = q . K^T and dP = dO . V^T
//   (m64n64k16, shared memory), dS in registers with its rows' lse and
//   delta held in registers, then dQ += round(dS) . K (m64n128k16, A from
//   registers, K read MN-major); dQ leaves through the consumer's rows of
//   the q tile and a TMA store.
// The 64-row streamed tile keeps a consumer at 64 + 64 (dK, dV, or dQ and
// headroom) + 32 + 32 (S, dP) fp32 registers a thread at d 128. head_dim
// is held as 128 columns (two swizzle atoms; a second atom only where
// d > 64); ceil(d / 16), the k-steps of S and dP, is a template argument
// (a branch between one accumulator's wgmmas makes ptxas serialise them),
// and so is N, the columns of the dK / dV / dQ products and accumulators:
// d rounded up to 64, 96 or 128 (d 96, phi3's, pays no padded columns),
// the ones past d unstored.
// * fp32: CUDA cores, 256 threads, each 4 rows x 4 tile columns of p / dS
//   (through shared memory) and 4 rows x 8 output columns; 64-row tiles,
//   167 KB (dkv) and 149 KB (dq) at d = 128; expf and IEEE arithmetic.
#include "flash_common.cuh"
#include "hopper_common.cuh"

#include <cmath>

namespace {

using flash::kMaxD;
using flash::kPld;
using flash::kTile;
using flash::pack_bf16;

constexpr int kThreads = 256;  // fp32: 16 row groups x 16 column lanes

using bf16 = __nv_bfloat16;

template <class T>
struct Args {
  const T* q;         // (bh, s, d)
  const T* k;         // (bh / group, skv, d)
  const T* v;         // (bh / group, skv, d)
  const T* dout;      // (bh, s, d)
  const float* lse;   // (bh, s)
  const float* delta; // (bh, s)
  T* dq;              // (bh, s, d), flash_bwd_dq
  T* dk;              // (bh / group, skv, d), flash_bwd_dkv
  T* dv;              // (bh / group, skv, d), flash_bwd_dkv
  int s, skv, d, group, causal;
  float scale;        // float(1 / sqrt(d)): the TPU kernels multiply by it
};

__device__ __forceinline__ bool seen(int qpos, int kpos, const int s,
                                     const int skv, const int causal) {
  return qpos < s && kpos < skv && (!causal || qpos >= kpos);
}

// ------------------------------------------------------------- fp32 ----

// s[i][j] += A[ra + i] . B[rb + 16 j] over d, for rows of two (64, d + 4)
// fp32 tiles in shared memory: a thread's 4 x 4 block of a 64 x 64 product
__device__ __forceinline__ void dot_4x4(float (&s)[4][4], const float* A,
                                        int ra, const float* B, int rb,
                                        int d) {
  const int ld = d + 4;
  for (int kk = 0; kk < d; kk += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + (ra + i) * ld + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(B + (rb + 16 * j) * ld + kk);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// acc[i][4 g + e] += sum_r P[ty*4 + i][r] . X[r][tx*4 + 64 g + e] over the
// 64 rows of a (64, d + 4) tile X, P a (64, kPld) tile
__device__ __forceinline__ void acc_px(float (&acc)[4][8], const float* P,
                                       const float* X, int ty, int tx,
                                       int d) {
  const int ld = d + 4;
  for (int r = 0; r < kTile; r += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(P + (ty * 4 + i) * kPld + r);
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int col = tx * 4 + 64 * g;
      if (col >= d) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 x =
            *reinterpret_cast<const float4*>(X + (r + e) * ld + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y
                        : e == 2 ? pv[i].z : pv[i].w;
          acc[i][4 * g + 0] = fmaf(p, x.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(p, x.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p, x.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p, x.w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// rows r0 + ty*4 + i (< n_rows) of acc into out (rows, d)
__device__ __forceinline__ void store_acc(const float (&acc)[4][8],
                                          float* out, int r0, int n_rows,
                                          int ty, int tx, int d) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int col = tx * 4 + 64 * g;
      if (col >= d) continue;
      *reinterpret_cast<float4*>(out + (size_t)row * d + col) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                      acc[i][4 * g + 3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) dkv_fp32_kernel(Args<float> a) {
  extern __shared__ __align__(16) float smem[];
  const int d = a.d, ld = d + 4;
  float* ks = smem;               // (64, d + 4) K tile
  float* vs = ks + kTile * ld;    // V tile
  float* qs = vs + kTile * ld;    // Q tile
  float* dos = qs + kTile * ld;   // dO tile
  float* ps = dos + kTile * ld;   // (64, 68) p^T: kv rows x q columns
  float* dss = ps + kTile * kPld; // dS^T
  float* lse_s = dss + kTile * kPld;
  float* delta_s = lse_s + kTile;
  const int bhkv = blockIdx.x, k0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t kv_off = (size_t)bhkv * a.skv * d;
  flash::load_tile_f32<kThreads>(a.k + kv_off, k0, a.skv, d, ks);
  flash::load_tile_f32<kThreads>(a.v + kv_off, k0, a.skv, d, vs);

  float dk[4][8], dv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_q = (a.s + kTile - 1) / kTile;
  const int qt0 = a.causal ? k0 / kTile : 0;  // earlier q tiles see no key
  for (int gi = 0; gi < a.group; ++gi) {
    const size_t bh = (size_t)bhkv * a.group + gi;
    for (int qt = qt0; qt < n_q; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the last q tile's products are done
      flash::load_tile_f32<kThreads>(a.q + bh * a.s * d, q0, a.s, d, qs);
      flash::load_tile_f32<kThreads>(a.dout + bh * a.s * d, q0, a.s, d, dos);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        const bool in = q0 + r < a.s;
        lse_s[r] = in ? a.lse[bh * a.s + q0 + r] : 0.f;
        delta_s[r] = in ? a.delta[bh * a.s + q0 + r] : 0.f;
      }
      __syncthreads();
      // s^T and dP^T: kv rows ty*4 + i, q columns tx + 16 j
      float st[4][4] = {}, dpt[4][4] = {};
      dot_4x4(st, ks, ty * 4, qs, tx, d);
      dot_4x4(dpt, vs, ty * 4, dos, tx, d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = tx + 16 * j;
          const float p = seen(q0 + qi, k0 + ty * 4 + i, a.s, a.skv,
                               a.causal)
                              ? expf(st[i][j] * a.scale - lse_s[qi])
                              : 0.f;
          ps[(ty * 4 + i) * kPld + qi] = p;
          dss[(ty * 4 + i) * kPld + qi] = p * (dpt[i][j] - delta_s[qi]) *
                                          a.scale;
        }
      __syncthreads();  // p^T and dS^T are complete
      acc_px(dv, ps, dos, ty, tx, d);
      acc_px(dk, dss, qs, ty, tx, d);
    }
  }
  store_acc(dk, a.dk + kv_off, k0, a.skv, ty, tx, d);
  store_acc(dv, a.dv + kv_off, k0, a.skv, ty, tx, d);
}

__global__ void __launch_bounds__(kThreads) dq_fp32_kernel(Args<float> a) {
  extern __shared__ __align__(16) float smem[];
  const int d = a.d, ld = d + 4;
  float* qs = smem;               // (64, d + 4) Q tile
  float* dos = qs + kTile * ld;   // dO tile
  float* ks = dos + kTile * ld;   // K tile
  float* vs = ks + kTile * ld;    // V tile
  float* dss = vs + kTile * ld;   // (64, 68) dS: q rows x kv columns
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest first
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t kv_off = (bh / a.group) * a.skv * d;
  flash::load_tile_f32<kThreads>(a.q + bh * a.s * d, q0, a.s, d, qs);
  flash::load_tile_f32<kThreads>(a.dout + bh * a.s * d, q0, a.s, d, dos);
  float lse[4], delta[4], dq[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse[i] = row < a.s ? a.lse[bh * a.s + row] : 0.f;
    delta[i] = row < a.s ? a.delta[bh * a.s + row] : 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) dq[i][c] = 0.f;
  }

  int n_kv = (a.skv + kTile - 1) / kTile;
  if (a.causal) n_kv = min(n_kv, (q0 + kTile - 1) / kTile + 1);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last kv tile's dS . K is done
    flash::load_tile_f32<kThreads>(a.k + kv_off, k0, a.skv, d, ks);
    flash::load_tile_f32<kThreads>(a.v + kv_off, k0, a.skv, d, vs);
    __syncthreads();
    // s and dP: q rows ty*4 + i, kv columns tx + 16 j
    float s[4][4] = {}, dp[4][4] = {};
    dot_4x4(s, qs, ty * 4, ks, tx, d);
    dot_4x4(dp, dos, ty * 4, vs, tx, d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j;
        const float p = seen(q0 + ty * 4 + i, k0 + kj, a.s, a.skv, a.causal)
                            ? expf(s[i][j] * a.scale - lse[i])
                            : 0.f;
        dss[(ty * 4 + i) * kPld + kj] = p * (dp[i][j] - delta[i]) * a.scale;
      }
    __syncthreads();  // dS is complete
    acc_px(dq, dss, ks, ty, tx, d);
  }
  store_acc(dq, a.dq + bh * a.s * d, q0, a.s, ty, tx, d);
}

// ---------------------------------------------------------------- bf16 ----

// Consumer warpgroups of the dK / dV pass: 2 (128 kv rows a CTA, one CTA
// an SM) or 1 (64 kv rows, two CTAs an SM: twice the CTAs, so less of the
// causal imbalance between kv tiles, but q and dO streamed once for 64 kv
// rows instead of 128). tools/flash_bwd_kv_tile.py builds both and times
// them on the card.
#ifndef FLASH_BWD_DKV_WARPGROUPS
#define FLASH_BWD_DKV_WARPGROUPS 2
#endif

constexpr int kHD = 128;  // head_dim as held: two 64-column swizzle atoms
constexpr int kAtoms = kHD / hopper::kAtomCols;
constexpr int kWgRows = 64;     // rows a consumer warpgroup owns
constexpr int kTileRows = 64;   // rows of a streamed tile: q / dO or k / v
constexpr int kStages = 3;      // slots of the ring
constexpr int kProducerRegs = 24;
constexpr uint32_t kTileAtomBytes = kTileRows * hopper::kRowBytes;  // 8 KB
constexpr uint32_t kTileBytes = kAtoms * kTileAtomBytes;
// a dkv slot's rows of lse (times log2(e)) and delta
constexpr uint32_t kStatBytes = 2 * kTileRows * sizeof(float);
// the fixed tiles' barrier, then a full and an empty one a slot
constexpr int kBarriers = 1 + 2 * kStages;
constexpr int kEpilogueBar = 1;  // named barriers 1 + consumer
constexpr float kLog2e = 1.4426950408889634f;

// A pass's CTA: kWgs consumer warpgroups of 64 rows own its fixed tiles
// (kv rows for dkv, q rows for dq); the producer warpgroup's registers go
// to them (24 + 240 a thread at one CTA an SM, 24 + 232 at two).
template <int kWgs>
struct Cta {
  static constexpr int kConsumers = kWgs;
  static constexpr int kRows = kWgs * kWgRows;
  static constexpr int kThreads = hopper::kWarpgroup * (1 + kWgs);
  static constexpr int kPerSm = kWgs == 2 ? 1 : 2;
  static constexpr int kConsumerRegs = kWgs == 2 ? 240 : 232;
  static constexpr uint32_t kAtomBytes = kRows * hopper::kRowBytes;
  static constexpr uint32_t kFixedBytes = kAtoms * kAtomBytes;  // a tile
  // [alignment slack][two fixed tiles][slot 0: two tiles][slot 1]...
  // ([lse / delta of each slot], dkv)[barriers]: tiles 1024-byte aligned,
  // as the swizzle needs
  static constexpr size_t smem(bool dkv) {
    return 1024 + 2 * kFixedBytes + 2 * kStages * kTileBytes +
           (dkv ? kStages * kStatBytes : 0) + 8 * kBarriers;
  }
};
using DkvCta = Cta<FLASH_BWD_DKV_WARPGROUPS>;
using DqCta = Cta<2>;

struct BArgs {
  const float* lse;    // (bh, s)
  const float* delta;  // (bh, s)
  int s, skv, d, group, causal;
  float scale;       // float(1 / sqrt(d))
  float scale_log2;  // scale log2(e): exp(x scale - lse) = 2^(x c - lse2)
};

// What the launcher builds, and the library exports (flash_bwd_config).
struct BwdConfig {
  int q_rows, kv_rows, stages, threads, smem, grid_x, grid_y;
};

BwdConfig bwd_config(bool dkv, int bh, int s, int skv, int group) {
  if (dkv)
    return {kTileRows, DkvCta::kRows, kStages, DkvCta::kThreads,
            (int)DkvCta::smem(true), bh / group,
            (skv + DkvCta::kRows - 1) / DkvCta::kRows};
  return {DqCta::kRows, kTileRows, kStages, DqCta::kThreads,
          (int)DqCta::smem(false), bh, (s + DqCta::kRows - 1) / DqCta::kRows};
}

// acc = a . b^T over kSteps 16-wide k-steps (a: 64 rows of a tile whose
// atoms are a_atom bytes apart, b: a 64-row streamed tile, both K-major),
// committed as one group
template <int kSteps>
__device__ __forceinline__ void issue_rows(float (&acc)[32], uint32_t a,
                                           uint32_t a_atom, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    hopper::wgmma_m64n64k16_ss(
        acc,
        hopper::desc_b128(a + (kk / 4) * a_atom + (kk % 4) * 32, 16,
                          hopper::kCoreRowsBytes),
        hopper::desc_b128(b + (kk / 4) * kTileAtomBytes + (kk % 4) * 32, 16,
                          hopper::kCoreRowsBytes),
        kk > 0);
  hopper::wgmma_commit();
}

// acc (64 x kN) += a (64 x 64 as the A fragments of 4 k-steps) . x (a
// 64-row streamed tile read MN-major: its rows along K, its first kN
// columns along N, the next 64 columns one atom on); not committed
template <int kN>
__device__ __forceinline__ void issue_cols(float (&acc)[kN / 2],
                                           const uint32_t (&a)[4][4],
                                           uint32_t x) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t b =
        hopper::desc_b128(x + kk * 16 * hopper::kRowBytes, kTileAtomBytes,
                          hopper::kCoreRowsBytes);
    if constexpr (kN == 128)
      hopper::wgmma_m64n128k16_rs_tb(acc, a[kk], b, 1);
    else if constexpr (kN == 96)
      hopper::wgmma_m64n96k16_rs_tb(acc, a[kk], b, 1);
    else
      hopper::wgmma_m64n64k16_rs_tb(acc, a[kk], b, 1);
  }
}

// x (a 64 x 64 accumulator: x[4 j + 2 h + e] at row 16 warp + g + 8 h,
// column 8 j + 2 t + e) rounded to bf16 as the A fragments of 4 k-steps
// of 16 columns
__device__ __forceinline__ void pack_frags(uint32_t (&a)[4][4],
                                           const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// x (64 rows x kN columns of fp32 accumulators) in bf16 into rows 0..63
// of a 128-byte-swizzled tile at `rows` (atoms `atom` bytes apart), as a
// TMA load would have written them
template <int kN>
__device__ __forceinline__ void stage_out(const float (&x)[kN / 2],
                                          uint32_t rows, uint32_t atom,
                                          int warp, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
      hopper::st_shared_u32(rows + (j / 8) * atom + r * hopper::kRowBytes +
                                (((j % 8) ^ (r % 8)) << 4) + 4 * t,
                            pack_bf16(x[4 * j + 2 * h], x[4 * j + 2 * h + 1]));
  }
}

// The CTA's dynamic shared memory from its first 1024-byte boundary (the
// __align__ of an extern array is not a promise)
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024u - (hopper::smem_u32(raw) & 1023u)) & 1023u);
}

// kSteps: the 16-wide k-steps of S^T and dP^T, ceil(d / 16); kN: the
// columns of dK and dV held, d rounded up to 64, 96 or 128
template <int kSteps, int kN = kSteps <= 4 ? 64 : kSteps <= 6 ? 96 : 128>
__global__ void __launch_bounds__(DkvCta::kThreads, DkvCta::kPerSm)
    dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdk,
    const __grid_constant__ CUtensorMap tdv, BArgs a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  const uint32_t sk = hopper::smem_u32(base);
  const uint32_t sv = sk + DkvCta::kFixedBytes;
  const uint32_t slots = sv + DkvCta::kFixedBytes;  // slot st: q, then dO
  const uint32_t stats_off =
      2 * DkvCta::kFixedBytes + 2 * kStages * kTileBytes;
  const uint32_t bars = sk + stats_off + kStages * kStatBytes;
  const uint32_t kv_full = bars;
  auto full = [&](int st) { return bars + 8u * (1 + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + kStages + st); };

  const int hk = blockIdx.x;               // kv head
  const int k0 = blockIdx.y * DkvCta::kRows;    // kv tile 0 first
  const int n_q = (a.s + kTileRows - 1) / kTileRows;
  // causal: q tiles before the kv tile's first row see none of its keys
  const int qt0 = a.causal ? min(k0 / kTileRows, n_q) : 0;
  const int per_head = n_q - qt0;
  const int n_it = a.group * per_head;
  const int n_atoms = (a.d + hopper::kAtomCols - 1) / hopper::kAtomCols;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / hopper::kWarpgroup, 0);

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      // the TMA thread's arrival with its bytes, and the stats warp's 32
      hopper::mbar_init(full(st), 1 + 32);
      hopper::mbar_init(empty(st), DkvCta::kConsumers * hopper::kWarpgroup);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(kv_full, 2 * n_atoms * DkvCta::kAtomBytes);
      for (int at = 0; at < n_atoms; ++at) {
        hopper::tma_load_3d(sk + at * DkvCta::kAtomBytes, &tk, kv_full,
                            at * hopper::kAtomCols, k0, hk);
        hopper::tma_load_3d(sv + at * DkvCta::kAtomBytes, &tv, kv_full,
                            at * hopper::kAtomCols, k0, hk);
      }
      int bh = hk * a.group, qt = qt0;
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages;
        const uint32_t qs = slots + 2 * st * kTileBytes;
        // passes at once the first round
        hopper::mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full(st), 2 * n_atoms * kTileAtomBytes);
        for (int at = 0; at < n_atoms; ++at) {
          hopper::tma_load_3d(qs + at * kTileAtomBytes, &tq, full(st),
                              at * hopper::kAtomCols, qt * kTileRows, bh);
          hopper::tma_load_3d(qs + kTileBytes + at * kTileAtomBytes, &tdo,
                              full(st), at * hopper::kAtomCols,
                              qt * kTileRows, bh);
        }
        if (++qt == n_q) qt = qt0, ++bh;
      }
    } else if (warp == 1) {
      // the stats warp: each slot's lse (times log2(e); +inf past S, so
      // p = 0 there) and delta rows
      int bh = hk * a.group, qt = qt0;
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages;
        float* stats = reinterpret_cast<float*>(base + stats_off +
                                                st * kStatBytes);
        hopper::mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
        for (int r = lane; r < kTileRows; r += 32) {
          const int row = qt * kTileRows + r;
          const size_t i = (size_t)bh * a.s + row;
          stats[r] = row < a.s ? a.lse[i] * kLog2e : INFINITY;
          stats[kTileRows + r] = row < a.s ? a.delta[i] : 0.f;
        }
        hopper::mbar_arrive(full(st));
        if (++qt == n_q) qt = qt0, ++bh;
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<DkvCta::kConsumerRegs>();
  const int cw = wg - 1;  // kv rows kWgRows cw .. of the kv tile
  const int tid = threadIdx.x % hopper::kWarpgroup;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, column pair
  const int kv_lo = k0 + kWgRows * cw;
  // this thread's kv rows: row0 and row0 + 8 (h = 0, 1)
  const int row0 = kv_lo + 16 * warp + g;
  const uint32_t k_rows = sk + kWgRows * cw * hopper::kRowBytes;
  const uint32_t v_rows = sv + kWgRows * cw * hopper::kRowBytes;
  const float c = a.scale_log2;
  // pt / dst: S^T and dP^T (then p^T and dS^T), [4 j + 2 h + e] at kv row
  // row0 + 8 h, q column 8 j + 2 t + e of the q tile; dk / dv [4 j + 2 h +
  // e] at kv row row0 + 8 h, column 8 j + 2 t + e
  float pt[32], dst[32], dk[kN / 2], dv[kN / 2];
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) dk[i] = dv[i] = 0.f;

  hopper::mbar_wait(kv_full, 0);
  int qt = qt0;
  for (int it = 0; it < n_it; ++it) {
    const int stg = it % kStages;
    const int q0 = qt * kTileRows;
    if (++qt == n_q) qt = qt0;
    const uint32_t qs = slots + 2 * stg * kTileBytes, dos = qs + kTileBytes;
    const float* lse2 =
        reinterpret_cast<const float*>(base + stats_off + stg * kStatBytes);
    const float* delta = lse2 + kTileRows;
    hopper::reg_fence(dk);
    hopper::reg_fence(dv);
    hopper::mbar_wait(full(stg), (it / kStages) & 1);
    hopper::wgmma_fence();
    issue_rows<kSteps>(pt, k_rows, DkvCta::kAtomBytes, qs);
    issue_rows<kSteps>(dst, v_rows, DkvCta::kAtomBytes, dos);
    hopper::wgmma_wait<1>();  // S^T; dP^T still in flight
    hopper::reg_fence(pt);
    // p^T = 2^(S^T c - lse2); a causal tile whose first q row comes before
    // the warpgroup's last kv row is masked (q < kv)
    const bool diag = a.causal && q0 < kv_lo + kWgRows - 1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pt[4 * j + 2 * h] = hopper::ex2(fmaf(pt[4 * j + 2 * h], c, -l.x));
        pt[4 * j + 2 * h + 1] =
            hopper::ex2(fmaf(pt[4 * j + 2 * h + 1], c, -l.y));
      }
    }
    if (diag) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (q0 + 8 * j + 2 * t + e < row0 + 8 * h)
              pt[4 * j + 2 * h + e] = 0.f;
    }
    hopper::wgmma_wait<0>();
    hopper::reg_fence(dst);
    // dS^T = p^T (dP^T - delta) scale
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl =
          *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* x = &dst[4 * j + 2 * h];
        x[0] = pt[4 * j + 2 * h] * (x[0] - dl.x) * a.scale;
        x[1] = pt[4 * j + 2 * h + 1] * (x[1] - dl.y) * a.scale;
      }
    }
    pack_frags(pa, pt);   // p rounded to bf16
    pack_frags(da, dst);  // dS rounded to bf16
    hopper::wgmma_fence();
    issue_cols<kN>(dv, pa, dos);
    issue_cols<kN>(dk, da, qs);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::reg_fence(dk);
    hopper::reg_fence(dv);
    hopper::reg_fence(pa);
    hopper::reg_fence(da);
    hopper::mbar_arrive(empty(stg));  // this thread is done with the slot
  }

  // dK and dV into this warpgroup's own rows of the K and V tiles (only it
  // read them), then one TMA store an atom of each
  stage_out<kN>(dk, k_rows, DkvCta::kAtomBytes, warp, g, t);
  stage_out<kN>(dv, v_rows, DkvCta::kAtomBytes, warp, g, t);
  hopper::fence_proxy_async_smem();
  hopper::bar_sync(kEpilogueBar + cw, hopper::kWarpgroup);
  if (tid == 0) {
    for (int at = 0; at < n_atoms; ++at) {
      hopper::tma_store_3d(&tdk, k_rows + at * DkvCta::kAtomBytes,
                           at * hopper::kAtomCols, kv_lo, hk);
      hopper::tma_store_3d(&tdv, v_rows + at * DkvCta::kAtomBytes,
                           at * hopper::kAtomCols, kv_lo, hk);
    }
    hopper::tma_store_commit_and_wait_read();
  }
}

template <int kSteps, int kN = kSteps <= 4 ? 64 : kSteps <= 6 ? 96 : 128>
__global__ void __launch_bounds__(DqCta::kThreads, DqCta::kPerSm)
    dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdq, BArgs a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sq = hopper::smem_u32(aligned_smem(smem_raw));
  const uint32_t sdo = sq + DqCta::kFixedBytes;
  const uint32_t slots = sdo + DqCta::kFixedBytes;  // slot st: k, then v
  const uint32_t bars = slots + 2 * kStages * kTileBytes;
  const uint32_t q_full = bars;
  auto full = [&](int st) { return bars + 8u * (1 + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + kStages + st); };

  const int bh = blockIdx.x;
  // the longest q tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DqCta::kRows;
  int n_kv = (a.skv + kTileRows - 1) / kTileRows;
  if (a.causal)
    n_kv = min(n_kv, (min(q0 + DqCta::kRows, a.s) - 1) / kTileRows + 1);
  const int n_atoms = (a.d + hopper::kAtomCols - 1) / hopper::kAtomCols;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / hopper::kWarpgroup, 0);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(full(st), 1);
      hopper::mbar_init(empty(st), DqCta::kConsumers * hopper::kWarpgroup);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const int kv = bh / a.group;
      hopper::mbar_expect_tx(q_full, 2 * n_atoms * DqCta::kAtomBytes);
      for (int at = 0; at < n_atoms; ++at) {
        hopper::tma_load_3d(sq + at * DqCta::kAtomBytes, &tq, q_full,
                            at * hopper::kAtomCols, q0, bh);
        hopper::tma_load_3d(sdo + at * DqCta::kAtomBytes, &tdo, q_full,
                            at * hopper::kAtomCols, q0, bh);
      }
      for (int kt = 0; kt < n_kv; ++kt) {
        const int st = kt % kStages;
        const uint32_t ks = slots + 2 * st * kTileBytes;
        hopper::mbar_wait(empty(st), ((kt / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full(st), 2 * n_atoms * kTileAtomBytes);
        for (int at = 0; at < n_atoms; ++at) {
          hopper::tma_load_3d(ks + at * kTileAtomBytes, &tk, full(st),
                              at * hopper::kAtomCols, kt * kTileRows, kv);
          hopper::tma_load_3d(ks + kTileBytes + at * kTileAtomBytes, &tv,
                              full(st), at * hopper::kAtomCols,
                              kt * kTileRows, kv);
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<DqCta::kConsumerRegs>();
  const int cw = wg - 1;  // q rows kWgRows cw .. of the q tile
  const int tid = threadIdx.x % hopper::kWarpgroup;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q_lo = q0 + kWgRows * cw;
  const int row0 = q_lo + 16 * warp + g;  // and row0 + 8 (h = 1)
  const uint32_t q_rows = sq + kWgRows * cw * hopper::kRowBytes;
  const uint32_t do_rows = sdo + kWgRows * cw * hopper::kRowBytes;
  const float c = a.scale_log2;
  // this thread's rows' lse (times log2(e); +inf past S, so p = 0) and delta
  float lse2[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const size_t i = (size_t)bh * a.s + row;
    lse2[h] = row < a.s ? a.lse[i] * kLog2e : INFINITY;
    delta[h] = row < a.s ? a.delta[i] : 0.f;
  }
  // s / dp: S and dP (then p and dS), [4 j + 2 h + e] at q row row0 + 8 h,
  // key 8 j + 2 t + e of the kv tile; dq [4 j + 2 h + e] at row0 + 8 h,
  // column 8 j + 2 t + e
  float s[32], dp[32], dq[kN / 2];
  uint32_t da[4][4];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) dq[i] = 0.f;

  hopper::mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int stg = kt % kStages;
    const int k0 = kt * kTileRows;
    const uint32_t ks = slots + 2 * stg * kTileBytes, vs = ks + kTileBytes;
    hopper::reg_fence(dq);
    hopper::mbar_wait(full(stg), (kt / kStages) & 1);
    hopper::wgmma_fence();
    issue_rows<kSteps>(s, q_rows, DqCta::kAtomBytes, ks);
    issue_rows<kSteps>(dp, do_rows, DqCta::kAtomBytes, vs);
    hopper::wgmma_wait<1>();  // S; dP still in flight
    hopper::reg_fence(s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          s[4 * j + 2 * h + e] =
              hopper::ex2(fmaf(s[4 * j + 2 * h + e], c, -lse2[h]));
    // masks: the keys past Skv of a ragged last tile, and causal keys past
    // a row where the tile reaches past the warpgroup's first row
    if (k0 + kTileRows > a.skv || (a.causal && k0 + kTileRows - 1 > q_lo)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + 2 * t + e;
            if (key >= a.skv || (a.causal && key > row0 + 8 * h))
              s[4 * j + 2 * h + e] = 0.f;
          }
    }
    hopper::wgmma_wait<0>();
    hopper::reg_fence(dp);
    // dS = p (dP - delta) scale
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = dp[4 * j + 2 * h + e];
          x = s[4 * j + 2 * h + e] * (x - delta[h]) * a.scale;
        }
    pack_frags(da, dp);  // dS rounded to bf16
    hopper::wgmma_fence();
    issue_cols<kN>(dq, da, ks);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::reg_fence(dq);
    hopper::reg_fence(da);
    hopper::mbar_arrive(empty(stg));
  }

  // dQ into this warpgroup's own rows of the q tile, then a TMA store
  stage_out<kN>(dq, q_rows, DqCta::kAtomBytes, warp, g, t);
  hopper::fence_proxy_async_smem();
  hopper::bar_sync(kEpilogueBar + cw, hopper::kWarpgroup);
  if (tid == 0) {
    for (int at = 0; at < n_atoms; ++at)
      hopper::tma_store_3d(&tdq, q_rows + at * DqCta::kAtomBytes,
                           at * hopper::kAtomCols, q_lo, bh);
    hopper::tma_store_commit_and_wait_read();
  }
}

// ------------------------------------------------------------ launch ----

size_t fp32_smem_bytes(int d, bool dkv) {
  const size_t tile = (size_t)kTile * (d + 4), p = (size_t)kTile * kPld;
  return sizeof(float) * (dkv ? 4 * tile + 2 * p + 2 * kTile : 4 * tile + p);
}

template <class T, class Kernel>
int launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem,
                  const Args<T>& a, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <bool kDkv>
int launch_bf16(const Args<bf16>& a, int bh, void* stream) {
  const int bhkv = bh / a.group;
  CUtensorMap tq, tdo, tk, tv, to0, to1;
  // the fixed tiles' box is the CTA's rows, the streamed tiles' 64, the
  // outputs' a consumer's 64
  const int q_box = kDkv ? kTileRows : DqCta::kRows;
  const int kv_box = kDkv ? DkvCta::kRows : kTileRows;
  cudaError_t err = hopper::bf16_tile_map(&tq, a.q, a.d, a.s, bh, q_box);
  if (err == cudaSuccess)
    err = hopper::bf16_tile_map(&tdo, a.dout, a.d, a.s, bh, q_box);
  if (err == cudaSuccess)
    err = hopper::bf16_tile_map(&tk, a.k, a.d, a.skv, bhkv, kv_box);
  if (err == cudaSuccess)
    err = hopper::bf16_tile_map(&tv, a.v, a.d, a.skv, bhkv, kv_box);
  if (err == cudaSuccess)
    err = kDkv ? hopper::bf16_tile_map(&to0, a.dk, a.d, a.skv, bhkv, kWgRows)
               : hopper::bf16_tile_map(&to0, a.dq, a.d, a.s, bh, kWgRows);
  if (err == cudaSuccess && kDkv)
    err = hopper::bf16_tile_map(&to1, a.dv, a.d, a.skv, bhkv, kWgRows);
  if (err != cudaSuccess) return (int)err;
  const BwdConfig cfg = bwd_config(kDkv, bh, a.s, a.skv, a.group);
  const BArgs b{a.lse,   a.delta, a.s,     a.skv,
                a.d,     a.group, a.causal, a.scale,
                (float)((double)a.scale * 1.4426950408889634)};
  const dim3 grid(cfg.grid_x, cfg.grid_y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int steps = (a.d + 15) / 16;
  if (kDkv) {
    using Kernel = void (*)(const CUtensorMap, const CUtensorMap,
                            const CUtensorMap, const CUtensorMap,
                            const CUtensorMap, const CUtensorMap, BArgs);
    const Kernel by_steps[kHD / 16] = {
        dkv_wgmma_kernel<1>, dkv_wgmma_kernel<2>, dkv_wgmma_kernel<3>,
        dkv_wgmma_kernel<4>, dkv_wgmma_kernel<5>, dkv_wgmma_kernel<6>,
        dkv_wgmma_kernel<7>, dkv_wgmma_kernel<8>};
    const Kernel kernel = by_steps[steps - 1];
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, cfg.threads, cfg.smem, st>>>(tq, tdo, tk, tv, to0, to1, b);
  } else {
    using Kernel = void (*)(const CUtensorMap, const CUtensorMap,
                            const CUtensorMap, const CUtensorMap,
                            const CUtensorMap, BArgs);
    const Kernel by_steps[kHD / 16] = {
        dq_wgmma_kernel<1>, dq_wgmma_kernel<2>, dq_wgmma_kernel<3>,
        dq_wgmma_kernel<4>, dq_wgmma_kernel<5>, dq_wgmma_kernel<6>,
        dq_wgmma_kernel<7>, dq_wgmma_kernel<8>};
    const Kernel kernel = by_steps[steps - 1];
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, cfg.threads, cfg.smem, st>>>(tq, tdo, tk, tv, to0, b);
  }
  return (int)cudaGetLastError();
}

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores)
template <bool kDkv>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int bh, int s, int skv, int d, int group, int causal, int dtype,
           void* stream) {
  if (d <= 0 || d % 8 != 0 || d > kMaxD || group <= 0 || bh % group != 0 ||
      s <= 0 || skv <= 0 || (kDkv ? skv : s) > 65535 * kTile)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / std::sqrt((double)d));
  if (dtype == 0) {
    const dim3 grid = kDkv ? dim3(bh / group, (skv + kTile - 1) / kTile)
                           : dim3(bh, (s + kTile - 1) / kTile);
    const Args<float> a{
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), s, skv, d, group, causal, scale};
    return launch_kernel(kDkv ? dkv_fp32_kernel : dq_fp32_kernel, grid,
                         kThreads, fp32_smem_bytes(d, kDkv), a, stream);
  }
  if (dtype == 1) {
    const Args<bf16> a{
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), s, skv, d, group, causal, scale};
    return launch_bf16<kDkv>(a, bh, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, int bh, int s,
                         int skv, int d, int group, int causal, int dtype,
                         void* stream) {
  if (dk == nullptr || dv == nullptr) return (int)cudaErrorInvalidValue;
  return launch<true>(q, k, v, dout, lse, delta, nullptr, dk, dv, bh, s, skv,
                      d, group, causal, dtype, stream);
}

int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int bh, int s, int skv, int d, int group,
                        int causal, int dtype, void* stream) {
  if (dq == nullptr) return (int)cudaErrorInvalidValue;
  return launch<false>(q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh,
                       s, skv, d, group, causal, dtype, stream);
}

// The bf16 launch of the dK / dV pass (kind 0) or the dQ pass (kind 1) at
// (bh, s, skv, group) as its launcher builds it, into out[0..6]: q rows and
// kv rows (a CTA's fixed tile and the streamed tile), ring slots, threads
// a CTA, dynamic shared memory bytes, grid x (kv heads or q heads), grid y
// (kv tiles or q tiles). Returns 0, or cudaErrorInvalidValue.
int flash_bwd_config(int kind, int bh, int s, int skv, int group, int* out) {
  if ((kind != 0 && kind != 1) || group <= 0 || bh % group != 0)
    return (int)cudaErrorInvalidValue;
  const BwdConfig cfg = bwd_config(kind == 0, bh, s, skv, group);
  const int vals[7] = {cfg.q_rows, cfg.kv_rows, cfg.stages, cfg.threads,
                       cfg.smem,   cfg.grid_x,  cfg.grid_y};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

const char* flash_bwd_dkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* flash_bwd_dq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
