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
// Design: a row to a group of threads, its ELL lanes loaded once
// (ell_lanes.cuh).
// - A row of dv vectors (float4s; single floats where d is not a multiple
//   of 4 or a base is not 16-byte aligned) takes a warp, or half a warp
//   where dv <= 16 (d 64): thread t sums columns t, t + group, ...
// - The group reads the row's k ELL entries (idx, coef, eidx) in one
//   coalesced load, 32 entries a round (half a warp: two a thread), and
//   ballots the live (coef != 0) ones. Their ids and coefs reach the
//   threads by shuffles, kBatch at a time, and each thread issues the
//   gathers of the whole batch (x, and emsg's rows in the edge variant),
//   without a branch, before their FMAs: the dependent chain is one ELL
//   read plus one gather round trip for every kBatch live lanes, not k of
//   them.
// - The FMAs of a column run in ascending lane order: a fixed order, the
//   same bits on every call. A row without a live lane writes zeros after
//   its one ELL read. Graphs run in blockIdx.y (at most 65535).
//
// What bounds it. It moves more bytes than it computes (2 flops a gathered
// float): the card's roofline is the ELL arrays of the live rows, the x /
// emsg rows they read and the output, ~0.12 us at one snapshot (640 rows,
// ~107 live, ~5 live lanes a row), which fit the 50 MB L2. What sets the
// time instead is latency (PERF.md: ~2.7 us of kernel a call at
// d 128): the launch, then one ELL read and about one gather round trip a
// row, all rows at once. Hopper's other tools do not apply: TMA has no
// gather on sm_90, tensor cores do nothing for ~5 lanes a row, and shared
// memory could hold only the lanes a group already keeps in registers.
// Registers (nvcc -Xptxas -v, sm_90a): 48 / 62 / 76 / 80 (floats a warp,
// floats a half warp, float4s a warp, float4s a half warp), no spills.
#include "ell_lanes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;  // live lanes gathered at once

// V floats a vector, kGroup threads a row (16 or 32)
template <int V, int kGroup>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const int* __restrict__ idx, const float* __restrict__ coef,
                const int* __restrict__ eidx, const float* __restrict__ x,
                const float* __restrict__ emsg, float* __restrict__ out,
                int n, int k, int nx, int e, int d) {
  using T = typename ell::Vec<V>::T;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int half = lane / kGroup, t = lane % kGroup;
  const int v = (blockIdx.x * kWarps + warp) * ell::kEntries<kGroup> + half;
  const bool row_ok = v < n;
  const int dv = d / V;
  const size_t l = blockIdx.y;
  const size_t base = (l * n + v) * k;
  const T* xs = reinterpret_cast<const T*>(x + l * nx * d);
  const T* es = emsg != nullptr
                    ? reinterpret_cast<const T*>(emsg + l * e * d)
                    : nullptr;
  for (int q0 = 0; q0 < dv; q0 += kGroup) {  // warp-uniform
    const int q = q0 + t;
    // a column past d reads column dv - 1 (in bounds) and stores nothing
    const int qc = q < dv ? q : dv - 1;
    T acc = ell::Vec<V>::zero();
    for (int s0 = 0; s0 < k; s0 += 32) {
      ell::Entry ent[ell::kEntries<kGroup>];
      unsigned m = ell::load_round<kGroup>(idx, coef, eidx, base, row_ok, s0,
                                           k, t, half, es != nullptr, ent);
      while (__any_sync(~0u, m != 0)) {
        int id[kBatch], ed[kBatch];
        float cf[kBatch];
        ell::next_batch<kGroup, kBatch>(m, ent, half, id, cf, ed);
        T val[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          val[b] = __ldg(xs + (size_t)id[b] * dv + qc);
        if (es != nullptr) {
#pragma unroll
          for (int b = 0; b < kBatch; ++b)
            val[b] = ell::Vec<V>::add(val[b], __ldg(es + (size_t)ed[b] * dv + qc));
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) ell::Vec<V>::fma(acc, cf[b], val[b]);
      }
    }
    if (row_ok && q < dv) reinterpret_cast<T*>(out + (l * n + v) * d)[q] = acc;
  }
}

// the launch: vector width, threads a row, rows a CTA, grid
struct Plan {
  int vec, group, rows;
  dim3 grid;
};

Plan plan(int L, int n, int d, bool aligned) {
  Plan p;
  p.vec = d % 4 == 0 && aligned ? 4 : 1;
  p.group = d / p.vec <= 16 ? 16 : 32;
  p.rows = kWarps * (32 / p.group);
  p.grid = dim3((unsigned)((n + p.rows - 1) / p.rows), (unsigned)L);
  return p;
}

template <int V, int G>
void launch_kernel(const Plan& p, cudaStream_t s, const void* idx,
                   const void* coef, const void* eidx, const void* x,
                   const void* emsg, void* out, int n, int k, int nx, int e,
                   int d) {
  ell_spmm_kernel<V, G><<<p.grid, kThreads, 0, s>>>(
      static_cast<const int*>(idx), static_cast<const float*>(coef),
      static_cast<const int*>(eidx), static_cast<const float*>(x),
      static_cast<const float*>(emsg), static_cast<float*>(out), n, k, nx, e,
      d);
}

}  // namespace

extern "C" {

// the launch over L graphs of n rows, d wide, with 16-byte aligned bases
// or not: out = grid x, grid y, CTAs, threads, rows a CTA, threads a row,
// floats a vector
int ell_spmm_plan(int L, int n, int d, int aligned, int* out) {
  const Plan p = plan(L, n, d, aligned != 0);
  out[0] = (int)p.grid.x;
  out[1] = (int)p.grid.y;
  out[2] = (int)(p.grid.x * p.grid.y);
  out[3] = kThreads;
  out[4] = p.rows;
  out[5] = p.group;
  out[6] = p.vec;
  return 0;
}

int ell_spmm_launch(const void* idx, const void* coef, const void* eidx,
                    const void* x, const void* emsg, void* out, int L, int n,
                    int k, int nx, int e, int d, void* stream) {
  if (L <= 0 || n <= 0 || d <= 0) return 0;
  if (L > 65535) return (int)cudaErrorInvalidValue;
  // float4 needs rows of a multiple of 4 floats and 16-byte aligned bases
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(emsg) |
                          reinterpret_cast<uintptr_t>(out);
  const Plan p = plan(L, n, d, bases % 16 == 0);
  auto s = static_cast<cudaStream_t>(stream);
  if (p.vec == 4 && p.group == 16)
    launch_kernel<4, 16>(p, s, idx, coef, eidx, x, emsg, out, n, k, nx, e, d);
  else if (p.vec == 4)
    launch_kernel<4, 32>(p, s, idx, coef, eidx, x, emsg, out, n, k, nx, e, d);
  else if (p.group == 16)
    launch_kernel<1, 16>(p, s, idx, coef, eidx, x, emsg, out, n, k, nx, e, d);
  else
    launch_kernel<1, 32>(p, s, idx, coef, eidx, x, emsg, out, n, k, nx, e, d);
  return (int)cudaGetLastError();
}

const char* ell_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
