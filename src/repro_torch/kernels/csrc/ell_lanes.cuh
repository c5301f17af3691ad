// A row's ELL lanes walked by a group of threads, shared by the ELL SpMM
// (ell_spmm.cu) and the V2 GC-LSTM step's aggregation (gcrn_step.cu).
//
// A group of kGroup threads (a warp, or a half or a quarter of one) owns
// one destination row. It reads the row's ELL entries (idx, coef, eidx) 32
// a round in one coalesced load (32 / kGroup a thread) and ballots
// the live ones (coef != 0; the ELL padding adds exact zeros). The live
// entries then reach every thread of the group by shuffles, kBatch at a
// time in ascending lane order, so a thread can issue the gathers of a
// whole batch before its FMAs: a row costs one ELL read and about one
// gather round trip for every kBatch live lanes, not a chain of k
// dependent loads. A batch past the row's last live entry is padded with
// entries of coef 0 and row 0, whose loads stay in bounds and whose FMAs
// add exact zeros, so the gathers need no branch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ell {

// V floats a gathered vector (a float4, or one float where a width is not a
// multiple of 4 or a base not 16-byte aligned), with the sums' rounding
// spelled out: the edge term is added to a row before its coef multiplies.
template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ static T add(const T& a, const T& b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
  }
  __device__ static void fma(T& acc, float w, const T& v) {
    acc.x = __fmaf_rn(w, v.x, acc.x); acc.y = __fmaf_rn(w, v.y, acc.y);
    acc.z = __fmaf_rn(w, v.z, acc.z); acc.w = __fmaf_rn(w, v.w, acc.w);
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.0f; }
  __device__ static T add(const T& a, const T& b) { return __fadd_rn(a, b); }
  __device__ static void fma(T& acc, float w, const T& v) {
    acc = __fmaf_rn(w, v, acc);
  }
};

// Entries a thread holds of a 32-entry round.
template <int kGroup>
constexpr int kEntries = 32 / kGroup;

struct Entry {
  int idx;
  float coef;
  int eidx;
};

// Entries s0 + j kGroup + t (j < kEntries) of the row whose entries start
// at `base` (t: the thread's index in its group, `half`: the group's in the
// warp; row_ok false or past k: coef 0, row 0), eidx only where `edges`.
// Returns the group's live entries of the round: bit j kGroup + t.
// Called by the whole warp.
template <int kGroup>
__device__ __forceinline__ unsigned load_round(
    const int* idx, const float* coef, const int* eidx, size_t base,
    bool row_ok, int s0, int k, int t, int half, bool edges,
    Entry (&e)[kEntries<kGroup>]) {
  constexpr unsigned kBits = kGroup == 32 ? ~0u : (1u << kGroup) - 1;
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < kEntries<kGroup>; ++j) {
    const int s = s0 + j * kGroup + t;
    const bool ok = row_ok && s < k;
    e[j].coef = ok ? __ldg(coef + base + s) : 0.0f;
    e[j].idx = ok ? __ldg(idx + base + s) : 0;
    e[j].eidx = ok && edges ? __ldg(eidx + base + s) : 0;
    const unsigned b = __ballot_sync(~0u, e[j].coef != 0.0f);
    m |= ((b >> (half * kGroup)) & kBits) << (j * kGroup);
  }
  return m;
}

// The next kBatch live entries of the group's round (mask m, cleared as
// they are taken), from their owners by shuffles: every thread of the
// group offers its entry sl / kGroup, which the shuffle takes from thread
// sl % kGroup. Past the live ones: coef 0, rows 0. Called by the whole
// warp.
template <int kGroup, int kBatch>
__device__ __forceinline__ void next_batch(unsigned& m,
                                           const Entry (&e)[kEntries<kGroup>],
                                           int half, int (&id)[kBatch],
                                           float (&cf)[kBatch],
                                           int (&ed)[kBatch]) {
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const bool ok = m != 0;
    const int sl = ok ? __ffs(m) - 1 : 0;
    const int j = sl / kGroup, src = half * kGroup + sl % kGroup;
    Entry mine = e[0];
#pragma unroll
    for (int jj = 1; jj < kEntries<kGroup>; ++jj)
      if (j == jj) mine = e[jj];
    const float c = __shfl_sync(~0u, mine.coef, src);
    const int i = __shfl_sync(~0u, mine.idx, src);
    const int d = __shfl_sync(~0u, mine.eidx, src);
    cf[b] = ok ? c : 0.0f;
    id[b] = ok ? i : 0;
    ed[b] = ok ? d : 0;
    m &= m - 1;
  }
}

}  // namespace ell
