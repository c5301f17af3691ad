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
// expf / logf and IEEE division: no fast math.
//
// Design. One CTA per (bh, 64-row q tile); a loop inside the CTA over
// 64-key kv tiles takes the place of the TPU grid's sequential kv axis, so
// m, l and the fp32 accumulator stay in registers for the whole row block.
// Causal: kv tiles above the q tile's last row are never visited, the
// diagonal tiles are masked. Two instantiations of that loop, by type:
//
// * bf16 (the LM path): tensor cores. 4 warps of 16 q rows; mma.sync
//   m16n8k16 (bf16 x bf16, fp32 accumulate) for q.k^T with the warp's q
//   fragments held in registers, and for p.v with p's bf16 fragments made
//   straight from the score accumulators (the layouts match, so p never
//   goes to shared memory) and v's fragments by ldmatrix .trans. The q, k
//   and v tiles sit in shared memory as bf16 (rows padded by 8: no bank
//   conflicts): 52 KB at d = 128. Products of bf16 values are exact in
//   fp32, and the sums are fp32, as the TPU kernel's
//   preferred_element_type=f32; p is rounded to bf16 for p.v, l sums it
//   unrounded.
// * fp32: CUDA cores, 256 threads, each 4 rows x 4 scores and 4 x 8 output
//   columns (a row's 16 threads are one half warp: max and sum are
//   shuffles); the q, k and v tiles in shared memory as fp32 (rows padded
//   by 4 floats), the p tile over the k tile: 101 KB at d = 128.
//
// Tiles. The kernel's tile is its own (64 x 64) whatever bq / bk the
// caller names: the wrapper validates bq / bk as the JAX package does
// (min(bq, S) | S, min(bk, Skv) | Skv), and since masking, not tiling,
// decides which keys a row sees, the result does not depend on the tile
// up to the order of summation (and, in bf16, where p is rounded relative
// to the running max). Rows past S and keys past Skv of a partial tile are
// zero-filled and masked. head_dim: any multiple of 8 up to 128 (the
// tensor-core path pads it to 16 with zero columns).
//
// What bounds it. Per (q, k) pair the function does 4 d flops (q.k and
// p.v); its bytes are q, k, v, o (and lse) once. At the LM path's shape
// (Qwen2.5-14B prefill: B 2, S 2048, 40 / 8 heads, d 128, bf16, causal)
// that is 85.9 GFLOP against 101 MB: bound by operations, 0.087 ms at the
// card's 989 TFLOP/s bf16 dense (the bytes take 0.030 ms at 3.35 TB/s).
// mma.sync without a copy pipeline (every kv tile is loaded, then used,
// behind a barrier) stays well short of it; wgmma, TMA and a ring of kv
// tiles are later work.
#include "flash_common.cuh"

#include <cmath>

namespace {

using flash::kMaxD;
using flash::kMaxDTiles;
using flash::kMaxKSteps;
using flash::kNegInf;
using flash::kPld;
using flash::ldmatrix_x4_trans;
using flash::mma_bf16;
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

// Tensor-core path: bf16 q / k / v, mma.sync m16n8k16 (bf16 x bf16 -> fp32)
constexpr int kMmaWarps = 4;                  // 16 q rows a warp
constexpr int kMmaThreads = 32 * kMmaWarps;

template <bool kLse>
__global__ void __launch_bounds__(kMmaThreads)
    flash_mma_kernel(Args<__nv_bfloat16> a) {
  extern __shared__ __align__(16) __nv_bfloat16 smem_h[];
  const int d = a.d, dp = (d + 15) / 16 * 16, ld = dp + 8;
  const int n_ks = dp / 16, n_dt = dp / 8;
  __nv_bfloat16* qs = smem_h;          // (64, dp + 8)
  __nv_bfloat16* ks = qs + kBQ * ld;   // (64, dp + 8)
  __nv_bfloat16* vs = ks + kBK * ld;   // (64, dp + 8)
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group, column pair
  const size_t kv_off = (size_t)(bh / a.group) * a.skv * d;
  const __nv_bfloat16* k = a.k + kv_off;
  const __nv_bfloat16* v = a.v + kv_off;

  flash::load_tile_bf16<kMmaThreads>(a.q + (size_t)bh * a.s * d, q0, a.s, d,
                                     dp, qs);
  __syncthreads();
  // this warp's 16 q rows as A fragments, kept for the whole kv loop
  uint32_t qa[kMaxKSteps][4];
  const __nv_bfloat16* qw = qs + warp * 16 * ld;
#pragma unroll
  for (int kk = 0; kk < kMaxKSteps; ++kk) {
    if (kk >= n_ks) continue;
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(qw + g * ld + c);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * ld + c);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(qw + g * ld + c + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * ld + c + 8);
  }

  // rows g (h = 0) and g + 8 (h = 1) of the warp's block
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kMaxDTiles][4];
#pragma unroll
  for (int j = 0; j < kMaxDTiles; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  int n_kv = (a.skv + kBK - 1) / kBK;
  if (a.causal) n_kv = min(n_kv, (q0 + kBQ - 1) / kBK + 1);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the last k / v tile
    flash::load_tile_bf16<kMmaThreads>(k, k0, a.skv, d, dp, ks);
    flash::load_tile_bf16<kMmaThreads>(v, k0, a.skv, d, dp, vs);
    __syncthreads();

    // scores: 8 n-tiles of 8 keys; s[j][0..1] row g, s[j][2..3] row g + 8,
    // keys j * 8 + 2t, + 1
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = ks + (j * 8 + g) * ld + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kMaxKSteps; ++kk) {
        if (kk >= n_ks) continue;
        mma_bf16(s[j], qa[kk],
                 *reinterpret_cast<const uint32_t*>(kr + kk * 16),
                 *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
      }
    }

    uint32_t pa[kBK / 16][4];  // p, rounded to bf16, as A fragments
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = q0 + warp * 16 + g + 8 * h;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + j * 8 + 2 * t + e;
          const bool seen = kpos < a.skv && (!a.causal || qpos >= kpos);
          float& x = s[j][2 * h + e];
          x = seen ? x / a.sqrt_d : kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = expf(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const float p0 = expf(s[j][2 * h] - m_new);
        const float p1 = expf(s[j][2 * h + 1] - m_new);
        sum += p0 + p1;
        // A fragment of k-step j / 2: regs 0 / 1 (rows g / g + 8) hold keys
        // 2t, 2t + 1 of its first 8, regs 2 / 3 of its second 8
        pa[j / 2][(j % 2) * 2 + h] = pack_bf16(p0, p1);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = l[h] * alpha + sum;
      m[h] = m_new;
#pragma unroll
      for (int j = 0; j < kMaxDTiles; ++j) {
        o[j][2 * h] *= alpha;
        o[j][2 * h + 1] *= alpha;
      }
    }

    // o += p . v: per k-step of 16 keys, two 8-wide output tiles a ldmatrix
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const __nv_bfloat16* vr =
          vs + (kk * 16 + (lane & 15)) * ld + ((lane >> 4) << 3);
#pragma unroll
      for (int j = 0; j < kMaxDTiles; j += 2) {
        if (j >= n_dt) continue;  // n_dt is even: dp is a multiple of 16
        uint32_t b[4];
        ldmatrix_x4_trans(b, vr + j * 8);
        mma_bf16(o[j], pa[kk], b[0], b[1]);
        mma_bf16(o[j + 1], pa[kk], b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= a.s) continue;
    const float lc = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow = a.o + ((size_t)bh * a.s + row) * d;
#pragma unroll
    for (int j = 0; j < kMaxDTiles; ++j) {
      if (j * 8 >= d) continue;
      const uint32_t val = pack_bf16(o[j][2 * h] / lc, o[j][2 * h + 1] / lc);
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) = val;
    }
    if (kLse && t == 0) a.lse[(size_t)bh * a.s + row] = m[h] + logf(lc);
  }
}

size_t smem_bytes(int d) {
  const int ld = d + 4;
  return sizeof(float) *
         (size_t)(2 * kBQ * ld + (kBK * ld > kBQ * kPld ? kBK * ld
                                                        : kBQ * kPld));
}

size_t mma_smem_bytes(int d) {
  const int dp = (d + 15) / 16 * 16;
  return sizeof(__nv_bfloat16) * (size_t)(kBQ + 2 * kBK) * (dp + 8);
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
    return launch_kernel<__nv_bfloat16>(flash_mma_kernel<kLse>, kMmaThreads,
                                        mma_smem_bytes(d), q, k, v, o, lse,
                                        bh, s, skv, d, group, causal, stream);
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

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
