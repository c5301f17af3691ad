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
// inputs' type. expf and IEEE arithmetic: no fast math.
//
// Design. Two kernels, as the TPU has two passes, so that no output is
// summed across CTAs: no atomics, and the result is the same on every run.
// * flash_bwd_dkv: one CTA per (kv head, 64-row kv tile). K and V stay in
//   shared memory; a loop inside the CTA runs over the group's q heads and
//   their 64-row q tiles (from the diagonal on when causal), which the TPU
//   grid's folded (group, q tile) axis ran in order. dK and dV accumulate
//   in registers (fp32) and are written once.
// * flash_bwd_dq: one CTA per (q head, 64-row q tile), q and dO in shared
//   memory, a loop over the kv tiles up to the diagonal; dQ accumulates in
//   registers.
// Each recomputes p and dS for its tile pairs (the price of two passes).
// Two instantiations by type, as the forward:
// * bf16 (the LM path): tensor cores, 4 warps of 16 rows (kv rows in
//   dkv, q rows in dq); mma.sync m16n8k16 for the four products, with the
//   score and dP accumulators turned straight into the A fragments of the
//   p / dS products (the layouts match) and the B operands of those
//   products by ldmatrix .trans; four (64, d) bf16 tiles in shared memory
//   (rows padded by 8: no bank conflicts), 70 KB at d = 128.
// * fp32: CUDA cores, 256 threads, each 4 rows x 4 tile columns of p / dS
//   (through shared memory) and 4 rows x 8 output columns; 167 KB (dkv)
//   and 149 KB (dq) at d = 128.
// A partial tile (rows past S or Skv) is zero-filled and masked; head_dim
// is any multiple of 8 up to 128 (padded to 16 with zero columns for the
// tensor cores).
//
// What bounds it. At the kernels' own count, per (q, k) pair the dkv pass
// does 8 d flops (q.k, dO.v, p^T.dO, dS^T.q) and the dq pass 6 d (q.k,
// dO.v, dS.k). At Qwen2.5-14B's layer shape (q (80, 2048, 128), k / v
// (16, 2048, 128), bf16, causal: 80 x 2048 x 2049 / 2 pairs) that is
// 171.9 and 128.9 GFLOP against ~100 MB each: bound by operations, 0.174
// and 0.130 ms at the card's 989 TFLOP/s bf16 dense. mma.sync with no copy
// pipeline (every tile is loaded, then used, behind a barrier) stays well
// short of it; wgmma, TMA and a ring of tiles are later work.
#include "flash_common.cuh"

#include <cmath>

namespace {

using flash::kMaxD;
using flash::kMaxDTiles;
using flash::kMaxKSteps;
using flash::kPld;
using flash::kTile;
using flash::ld_u32;
using flash::ldmatrix_x4_trans;
using flash::load_a_frag;
using flash::mma_bf16;
using flash::pack_bf16;
using flash::padded_d;

constexpr int kThreads = 256;     // fp32: 16 row groups x 16 column lanes
constexpr int kMmaThreads = 128;  // bf16: 4 warps of 16 rows
constexpr int kNT = kTile / 8;    // n-tiles of 8 across a 64-wide tile

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

// -------------------------------------------------- bf16, tensor cores ----

// acc[n] (16 rows x 8 n-tiles) += rows . cols^T over the (padded) head
// dim: A fragments from 16 rows of one tile, B fragments from the 64 rows
// of another (the n index), both row-major bf16 (64, dp + 8) in shared
// memory
__device__ __forceinline__ void mma_rows_cols(float (&acc)[kNT][4],
                                              const bf16* rows,
                                              const bf16* cols, int ld,
                                              int n_ks, int g, int t) {
#pragma unroll
  for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] =
      acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kMaxKSteps; ++kk) {
    if (kk >= n_ks) continue;
    uint32_t a[4];
    load_a_frag(a, rows, ld, kk * 16, g, t);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const bf16* br = cols + (j * 8 + g) * ld + kk * 16 + 2 * t;
      mma_bf16(acc[j], a, ld_u32(br), ld_u32(br + 8));
    }
  }
}

// x (16 rows x 64 columns, as 8 n-tiles of accumulators) rounded to bf16
// as the A fragments of 4 k-steps of 16: regs 0 / 1 (rows g / g + 8) hold
// columns 2t, 2t + 1 of a k-step's first 8, regs 2 / 3 of its second 8
__device__ __forceinline__ void to_a_frags(uint32_t (&fa)[kNT / 2][4],
                                           const float (&x)[kNT][4]) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      fa[j / 2][(j % 2) * 2 + h] = pack_bf16(x[j][2 * h], x[j][2 * h + 1]);
}

// acc (16 rows x d) += fa (16 x 64, A fragments) . X (64 x d, a row-major
// bf16 tile in shared memory, read transposed by ldmatrix)
__device__ __forceinline__ void mma_frags_tile(float (&acc)[kMaxDTiles][4],
                                               const uint32_t (&fa)[kNT / 2][4],
                                               const bf16* X, int ld,
                                               int n_dt, int lane) {
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
    const bf16* xr = X + (kk * 16 + (lane & 15)) * ld + ((lane >> 4) << 3);
#pragma unroll
    for (int j = 0; j < kMaxDTiles; j += 2) {
      if (j >= n_dt) continue;  // n_dt is even: dp is a multiple of 16
      uint32_t b[4];
      ldmatrix_x4_trans(b, xr + j * 8);
      mma_bf16(acc[j], fa[kk], b[0], b[1]);
      mma_bf16(acc[j + 1], fa[kk], b[2], b[3]);
    }
  }
}

// rows r0 + g + 8h (< n_rows) of a warp's 16-row accumulator into out
__device__ __forceinline__ void store_frags(const float (&acc)[kMaxDTiles][4],
                                            bf16* out, int r0, int n_rows,
                                            int d, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= n_rows) continue;
    bf16* orow = out + (size_t)row * d;
#pragma unroll
    for (int j = 0; j < kMaxDTiles; ++j) {
      if (j * 8 >= d) continue;
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads) dkv_mma_kernel(Args<bf16> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = a.d, dp = padded_d(d), ld = dp + 8;
  const int n_ks = dp / 16, n_dt = dp / 8;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // (64, dp + 8) K tile
  bf16* vs = ks + kTile * ld;                    // V tile
  bf16* qs = vs + kTile * ld;                    // Q tile
  bf16* dos = qs + kTile * ld;                   // dO tile
  float* lse_s = reinterpret_cast<float*>(dos + kTile * ld);
  float* delta_s = lse_s + kTile;
  const int bhkv = blockIdx.x, k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t kv_off = (size_t)bhkv * a.skv * d;
  flash::load_tile_bf16<kMmaThreads>(a.k + kv_off, k0, a.skv, d, dp, ks);
  flash::load_tile_bf16<kMmaThreads>(a.v + kv_off, k0, a.skv, d, dp, vs);
  const bf16* kw = ks + warp * 16 * ld;  // this warp's 16 kv rows
  const bf16* vw = vs + warp * 16 * ld;

  float dk[kMaxDTiles][4], dv[kMaxDTiles][4];
#pragma unroll
  for (int j = 0; j < kMaxDTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const int n_q = (a.s + kTile - 1) / kTile;
  const int qt0 = a.causal ? k0 / kTile : 0;  // earlier q tiles see no key
  for (int gi = 0; gi < a.group; ++gi) {
    const size_t bh = (size_t)bhkv * a.group + gi;
    for (int qt = qt0; qt < n_q; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // every warp is done with the last q / dO tile
      flash::load_tile_bf16<kMmaThreads>(a.q + bh * a.s * d, q0, a.s, d, dp,
                                         qs);
      flash::load_tile_bf16<kMmaThreads>(a.dout + bh * a.s * d, q0, a.s, d,
                                         dp, dos);
      for (int r = threadIdx.x; r < kTile; r += kMmaThreads) {
        const bool in = q0 + r < a.s;
        lse_s[r] = in ? a.lse[bh * a.s + q0 + r] : 0.f;
        delta_s[r] = in ? a.delta[bh * a.s + q0 + r] : 0.f;
      }
      __syncthreads();
      // p^T: this warp's kv rows g (h = 0), g + 8 (h = 1) x q columns
      // j * 8 + 2t + e
      float pt[kNT][4];
      mma_rows_cols(pt, kw, qs, ld, n_ks, g, t);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = j * 8 + 2 * t + e;
            float& x = pt[j][2 * h + e];
            x = seen(q0 + qi, k0 + warp * 16 + g + 8 * h, a.s, a.skv,
                     a.causal)
                    ? expf(x * a.scale - lse_s[qi])
                    : 0.f;
          }
      uint32_t fa[kNT / 2][4];
      to_a_frags(fa, pt);  // p rounded to bf16
      mma_frags_tile(dv, fa, dos, ld, n_dt, lane);
      // dS^T = p^T (dP^T - delta) scale, with dP^T = V . dO^T
      float dst[kNT][4];
      mma_rows_cols(dst, vw, dos, ld, n_ks, g, t);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = j * 8 + 2 * t + e;
            dst[j][2 * h + e] = pt[j][2 * h + e] *
                                (dst[j][2 * h + e] - delta_s[qi]) * a.scale;
          }
      to_a_frags(fa, dst);  // dS rounded to bf16
      mma_frags_tile(dk, fa, qs, ld, n_dt, lane);
    }
  }
  store_frags(dk, a.dk + kv_off, k0 + warp * 16, a.skv, d, g, t);
  store_frags(dv, a.dv + kv_off, k0 + warp * 16, a.skv, d, g, t);
}

__global__ void __launch_bounds__(kMmaThreads) dq_mma_kernel(Args<bf16> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = a.d, dp = padded_d(d), ld = dp + 8;
  const int n_ks = dp / 16, n_dt = dp / 8;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // (64, dp + 8) Q tile
  bf16* dos = qs + kTile * ld;                   // dO tile
  bf16* ks = dos + kTile * ld;                   // K tile
  bf16* vs = ks + kTile * ld;                    // V tile
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t kv_off = (bh / a.group) * a.skv * d;
  flash::load_tile_bf16<kMmaThreads>(a.q + bh * a.s * d, q0, a.s, d, dp, qs);
  flash::load_tile_bf16<kMmaThreads>(a.dout + bh * a.s * d, q0, a.s, d, dp,
                                     dos);
  const bf16* qw = qs + warp * 16 * ld;  // this warp's 16 q rows
  const bf16* dow = dos + warp * 16 * ld;
  // rows g (h = 0) and g + 8 (h = 1) of the warp's block
  float lse[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    lse[h] = row < a.s ? a.lse[bh * a.s + row] : 0.f;
    delta[h] = row < a.s ? a.delta[bh * a.s + row] : 0.f;
  }
  float dq[kMaxDTiles][4];
#pragma unroll
  for (int j = 0; j < kMaxDTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  int n_kv = (a.skv + kTile - 1) / kTile;
  if (a.causal) n_kv = min(n_kv, (q0 + kTile - 1) / kTile + 1);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the last K / V tile
    flash::load_tile_bf16<kMmaThreads>(a.k + kv_off, k0, a.skv, d, dp, ks);
    flash::load_tile_bf16<kMmaThreads>(a.v + kv_off, k0, a.skv, d, dp, vs);
    __syncthreads();
    // p: q rows g + 8h x kv columns j * 8 + 2t + e
    float p[kNT][4], ds[kNT][4];
    mma_rows_cols(p, qw, ks, ld, n_ks, g, t);
    mma_rows_cols(ds, dow, vs, ld, n_ks, g, t);  // dP = dO . V^T
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + j * 8 + 2 * t + e;
          const float pe =
              seen(q0 + warp * 16 + g + 8 * h, kpos, a.s, a.skv, a.causal)
                  ? expf(p[j][2 * h + e] * a.scale - lse[h])
                  : 0.f;
          ds[j][2 * h + e] = pe * (ds[j][2 * h + e] - delta[h]) * a.scale;
        }
    uint32_t fa[kNT / 2][4];
    to_a_frags(fa, ds);  // dS rounded to bf16
    mma_frags_tile(dq, fa, ks, ld, n_dt, lane);
  }
  store_frags(dq, a.dq + bh * a.s * d, q0 + warp * 16, a.s, d, g, t);
}

// ------------------------------------------------------------ launch ----

size_t fp32_smem_bytes(int d, bool dkv) {
  const size_t tile = (size_t)kTile * (d + 4), p = (size_t)kTile * kPld;
  return sizeof(float) * (dkv ? 4 * tile + 2 * p + 2 * kTile : 4 * tile + p);
}

size_t mma_smem_bytes(int d, bool dkv) {
  return sizeof(bf16) * 4 * (size_t)kTile * (padded_d(d) + 8) +
         (dkv ? sizeof(float) * 2 * kTile : 0);
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

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores)
template <bool kDkv>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int bh, int s, int skv, int d, int group, int causal, int dtype,
           void* stream) {
  if (d <= 0 || d % 8 != 0 || d > kMaxD || group <= 0 || bh % group != 0 ||
      s <= 0 || skv <= 0 || (kDkv ? skv : s) > 65535 * kTile)
    return (int)cudaErrorInvalidValue;
  const dim3 grid = kDkv ? dim3(bh / group, (skv + kTile - 1) / kTile)
                         : dim3(bh, (s + kTile - 1) / kTile);
  const float scale = (float)(1.0 / std::sqrt((double)d));
  if (dtype == 0) {
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
    return launch_kernel(kDkv ? dkv_mma_kernel : dq_mma_kernel, grid,
                         kMmaThreads, mma_smem_bytes(d, kDkv), a, stream);
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

const char* flash_bwd_dkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* flash_bwd_dq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
