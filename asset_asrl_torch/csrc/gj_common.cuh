// Shared pieces of kernel K1 (batched unpivoted Gauss-Jordan inverse with
// pivot sequence and inertia epilogue) for Hopper: the pivot guard and
// the bad-pivot rule, coalesced block staging, and the warp-level
// elimination that both the narrow kernels (gj_inverse.cu) and the
// diagonal-block step of the wide kernel (gj_inverse_wide.cu) run.
//
// Semantics (those of asset_asrl_tpu/Solvers/pallas_kernels.py:
// batched_gj_inverse and kkt_block._inv_gj_pivots): step j reads the raw
// pivot d = M[j, j], records it, divides by d only where |d| > guard
// (else by 1), so a zero or non-finite pivot is reported, never hidden.

#pragma once

#include <cuda_runtime.h>

namespace gj {

constexpr unsigned kFullMask = 0xffffffffu;

template <typename T> struct Lim;
template <> struct Lim<double> {
  __host__ __device__ static constexpr double guard() { return 1e-300; }
  __host__ __device__ static constexpr double tiny() { return 1e-250; }
};
template <> struct Lim<float> {
  __host__ __device__ static constexpr float guard() { return 1e-30f; }
  __host__ __device__ static constexpr float tiny() { return 1e-25f; }
};

template <typename T>
__device__ __forceinline__ T abs_val(T v) { return v < T(0) ? -v : v; }

// 1 / d behind the pivot guard (NaN compares false, so it divides by 1).
template <typename T>
__device__ __forceinline__ T guarded_inverse(T d) {
  const T dsafe = abs_val(d) > Lim<T>::guard() ? d : T(1);
  return T(1) / dsafe;
}

// The inertia rule of kkt_block._inv_sym: a pivot counts when it is
// negative, non-finite or smaller in magnitude than tiny.
template <typename T>
__device__ __forceinline__ bool bad_pivot(T p) {
  return !isfinite(p) || abs_val(p) < Lim<T>::tiny() || p < T(0);
}

template <typename T>
__device__ __forceinline__ T finite_or_zero(T v, int sanitize) {
  return (sanitize && !isfinite(v)) ? T(0) : v;
}

template <typename T> struct Vec16;
template <> struct Vec16<double> { using type = double2; };
template <> struct Vec16<float> { using type = float4; };

// A block staged in shared memory has an odd row stride LD, so that the
// 32 lanes of a warp, each walking its own row, hit distinct banks.

// NT threads (index t) copy one contiguous W x W block between global
// memory and its staged copy (row stride LD): neighbouring threads on
// neighbouring addresses, 16 bytes a thread where the block's byte size
// keeps every block of the batch 16-byte aligned, else one element a
// thread.  W is a run-time width; a thread finds its (row, column) with
// one division and then walks it by a fixed stride.
struct Walk {
  int row, col, drow, dcol;
  __device__ __forceinline__ Walk(int first, int step, int W)
      : row(first / W), col(first % W), drow(step / W), dcol(step % W) {}
  __device__ __forceinline__ void next(int W) {
    row += drow;
    col += dcol;
    if (col >= W) { col -= W; ++row; }
  }
};

template <typename T, int LD, int NT>
__device__ __forceinline__ void stage_in(const T* __restrict__ src, T* s,
                                         int W, int t) {
  constexpr int V = 16 / sizeof(T);
  const int WW = W * W;
  if (WW % V == 0) {
    using Vec = typename Vec16<T>::type;
    const Vec* v = reinterpret_cast<const Vec*>(src);
    Walk at(t * V, NT * V, W);
    for (int q = t; q < WW / V; q += NT, at.next(W)) {
      const Vec x = v[q];
      const T* xs = reinterpret_cast<const T*>(&x);
      int rr = at.row, cc = at.col;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        s[rr * LD + cc] = xs[u];
        if (++cc == W) { cc = 0; ++rr; }
      }
    }
  } else {
    Walk at(t, NT, W);
    for (int e = t; e < WW; e += NT, at.next(W))
      s[at.row * LD + at.col] = src[e];
  }
}

template <typename T, int LD, int NT>
__device__ __forceinline__ void stage_out(const T* s, T* __restrict__ dst,
                                          int W, int t) {
  constexpr int V = 16 / sizeof(T);
  const int WW = W * W;
  if (WW % V == 0) {
    using Vec = typename Vec16<T>::type;
    Vec* v = reinterpret_cast<Vec*>(dst);
    Walk at(t * V, NT * V, W);
    for (int q = t; q < WW / V; q += NT, at.next(W)) {
      Vec x;
      T* xs = reinterpret_cast<T*>(&x);
      int rr = at.row, cc = at.col;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        xs[u] = s[rr * LD + cc];
        if (++cc == W) { cc = 0; ++rr; }
      }
      v[q] = x;
    }
  } else {
    Walk at(t, NT, W);
    for (int e = t; e < WW; e += NT, at.next(W))
      dst[e] = s[at.row * LD + at.col];
  }
}

// In-place Gauss-Jordan inverse of a W x W block by one warp, without
// shared memory or barriers.  WP (W <= WP <= 32) is the compile-time
// bound of the width: lane i keeps row i in r[0..WP), columns >= W and
// lanes >= W carry zeros.  Returns, in lane j, the pivot of step j.
//
// The columns rotate: before step j, register p holds column (p + j) mod
// WP, so the pivot column is always r[0] and every register index is a
// compile-time constant although the step loop is not unrolled.  Step j:
//   d = row j's r[0], broadcast from lane j;  dinv = 1 / guarded d
//   lane i != j scales its multiplier once, f = r[0] * dinv, and takes
//     r[p-1] = r[p] - f * rowj[p]   (one FMA an entry),
//   lane j takes r[p-1] = rowj[p] * dinv (the same FMA with addend 0 and
//     f = -dinv), and the new inverse column (-f; dinv in lane j) enters
//     at r[WP-1], which is column j from the next step on.
// rowj[p] is fetched unscaled by shuffle, so the shuffles do not wait for
// the division.  The loop makes W steps, not WP: the zero columns of the
// padding ride along untouched.  After them register p holds column
// rotated_column<WP>(p, W).
template <typename T, int WP>
__device__ __forceinline__ T gj_warp(T (&r)[WP], int W, int lane) {
  static_assert(WP >= 1 && WP <= 32, "one lane per row");
  T mypiv = T(0);
#pragma unroll 1
  for (int j = 0; j < W; ++j) {
    const T d = __shfl_sync(kFullMask, r[0], j);
    const bool own = lane == j;
    if (own) mypiv = d;
    const T dinv = guarded_inverse(d);
    const T f = own ? -dinv : r[0] * dinv;
#pragma unroll
    for (int p = 1; p < WP; ++p) {
      const T t = __shfl_sync(kFullMask, r[p], j);
      const T a = own ? T(0) : r[p];
      r[p - 1] = a - f * t;
    }
    r[WP - 1] = own ? dinv : -f;
  }
  return mypiv;
}

// The column that register p of gj_warp's row holds after W steps.
template <int WP>
__device__ __forceinline__ int rotated_column(int p, int W) {
  const int c = p + W;
  return c >= WP ? c - WP : c;
}

}  // namespace gj
