// ELL SpMM, the message-passing stage, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/csr_spmm.py, ell_spmm_pallas and its bodies
// _spmm_kernel (no edges) and _spmm_edge_kernel (with edge messages),
// reached through kernels/ops.ell_spmm from core/gcn.propagate_ell
// (impl="pallas").
//
// What it computes (the plain version is repro_torch/kernels/ref.py
// ell_spmm), for L independent graphs l and every destination row v:
//   out[l, v] = sum_s coef[l, v, s] * (x[l, idx[l, v, s]] + emsg[l, eidx[l, v, s]])
// with the emsg term only in the edge variant (emsg null: none).
//
// Design. One thread per (graph, row, 4 columns): neighbouring threads
// read neighbouring 16-byte pieces of one source row, so each gather of a
// lane is a coalesced float4 read of the row (a width that is not a multiple
// of 4 takes the one-float variant). A warp covers 32 float4 columns, i.e.
// one row of width 128 or two rows of width 64. The lane's id and coef are
// the same address for the threads of a row (one broadcast). coef-0 lanes,
// the ELL padding, add exact zeros and are skipped, so an all-padding row
// costs k coef reads and writes zeros. x (640 x 128 x 4 B = 328 KB at full
// width) stays in the 50 MB L2, so the gathers hit L2.
//
// What bounds it. It moves more bytes than it computes (2 flops per
// gathered float): bound by bytes, the ELL arrays, the gathered rows and the
// output, on the card's roofline; at one snapshot (640 rows) the launch and
// the L2 latency of the dependent gathers dominate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ static void fma(T& acc, float w, const T& v) {
    acc.x = fmaf(w, v.x, acc.x); acc.y = fmaf(w, v.y, acc.y);
    acc.z = fmaf(w, v.z, acc.z); acc.w = fmaf(w, v.w, acc.w);
  }
  __device__ static T add(const T& a, const T& b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.0f; }
  __device__ static void fma(T& acc, float w, const T& v) { acc = fmaf(w, v, acc); }
  __device__ static T add(const T& a, const T& b) { return a + b; }
};

template <int V>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const int* __restrict__ idx, const float* __restrict__ coef,
                const int* __restrict__ eidx, const float* __restrict__ x,
                const float* __restrict__ emsg, float* __restrict__ out,
                int n, int k, int nx, int e, int d) {
  using T = typename Vec<V>::T;
  const int dv = d / V;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n * dv) return;
  const int v = p / dv, j = p - v * dv;
  const size_t l = blockIdx.y;
  const size_t lane0 = (l * n + v) * k;
  const T* xs = reinterpret_cast<const T*>(x + l * nx * d) + j;
  const T* es = emsg != nullptr
                    ? reinterpret_cast<const T*>(emsg + l * e * d) + j
                    : nullptr;
  T acc = Vec<V>::zero();
  for (int s = 0; s < k; ++s) {
    const float w = __ldg(coef + lane0 + s);
    if (w == 0.0f) continue;
    T val = __ldg(xs + (size_t)__ldg(idx + lane0 + s) * dv);
    if (es != nullptr) val = Vec<V>::add(val, __ldg(es + (size_t)__ldg(eidx + lane0 + s) * dv));
    Vec<V>::fma(acc, w, val);
  }
  reinterpret_cast<T*>(out + (l * n + v) * d)[j] = acc;
}

}  // namespace

extern "C" {

int ell_spmm_launch(const void* idx, const void* coef, const void* eidx,
                    const void* x, const void* emsg, void* out, int L, int n,
                    int k, int nx, int e, int d, void* stream) {
  if (L <= 0 || n <= 0 || d <= 0) return 0;
  if (L > 65535) return (int)cudaErrorInvalidValue;
  // float4 needs rows of a multiple of 4 floats and 16-byte aligned bases
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(emsg) |
                          reinterpret_cast<uintptr_t>(out);
  const bool vec4 = d % 4 == 0 && bases % 16 == 0;
  const long long work = (long long)n * (vec4 ? d / 4 : d);
  const dim3 grid((unsigned)((work + kThreads - 1) / kThreads), (unsigned)L);
  auto s = static_cast<cudaStream_t>(stream);
  const int* ii = static_cast<const int*>(idx);
  const float* cc = static_cast<const float*>(coef);
  const int* ee = static_cast<const int*>(eidx);
  const float* xx = static_cast<const float*>(x);
  const float* em = static_cast<const float*>(emsg);
  float* oo = static_cast<float*>(out);
  if (vec4)
    ell_spmm_kernel<4><<<grid, kThreads, 0, s>>>(ii, cc, ee, xx, em, oo, n, k, nx, e, d);
  else
    ell_spmm_kernel<1><<<grid, kThreads, 0, s>>>(ii, cc, ee, xx, em, oo, n, k, nx, e, d);
  return (int)cudaGetLastError();
}

const char* ell_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
