// Kernel K1, narrow blocks (1 <= W <= 64): batched unpivoted Gauss-Jordan
// inverse with pivot sequence and a fused inertia epilogue, for Hopper.
//
// Replaces asset_asrl_tpu/Solvers/pallas_kernels.py: batched_gj_inverse
// (_gj_call / _gj_kernel), and on the f64 path the XLA loop
// kkt_block._inv_gj_pivots.  For each block D of a (K, W, W) batch it
// returns D^-1, the W pivots d_j = M[j, j] seen before step j (raw, before
// the guard), and the count of pivots that are negative, non-finite or
// below tiny: the block's contribution to the inertia that drives the
// interior-point solver's perturbation ladder.  With `sanitize` set, a
// non-finite entry of the inverse is stored as 0, as kkt_block._inv_sym
// hands it to the factorization.
//
// What bounds it: the bytes are small (a 24 x 24 f64 block is 4.6 KB,
// read once and written once), the arithmetic is 2 W^3 a block; the time
// goes into the chain of W dependent steps.  A design with one CTA per
// block pays two CTA-wide barriers a step and W^2 divisions a step.  Here
// no barrier spans more than two warps, and a thread makes one division
// and one multiplication a step (its row multiplier) beside one FMA an
// entry:
//
// * gj_warp_kernel, W <= 32: one warp owns one block, kWarps blocks a
//   CTA.  Lane i keeps row i in registers (the width's bound WP is a
//   template parameter and the columns rotate, so every register index is
//   static, see gj::gj_warp); row j reaches the
//   other lanes by shuffles; warps never wait for each other.  The 2500
//   blocks of a 10^4-node problem's first reduction level are resident at
//   once (19 warps an SM).  What bounds it now is the shuffle unit: two
//   32-bit shuffles an f64 entry a step.
// * gj_pair_kernel, 33 <= W <= 64: the rows no longer fit one warp's
//   registers, so two warps (a CTA of 64 threads) own one block, thread t
//   keeping row t.  The owner of row j stages it in a double-buffered
//   shared row, one two-warp barrier a step; all threads read it as a
//   broadcast.  The same column rotation keeps register indices static.
//
// Blocks enter and leave through a staged copy in shared memory, so
// global accesses are coalesced (16 bytes a thread where alignment
// allows) although each lane works on a row.
//
// The width W is a run-time argument under a compile-time bound WP, the
// next multiple of 4: 16 instances a type cover every width 1..64.  The
// step loop makes W steps, so a padded width pays only the WP - W zero
// columns that ride along in each step (W = 25 runs as 25 steps of 28
// columns).  The step loops are not unrolled, so an instance is small.

#include "gj_common.cuh"

namespace {

using namespace gj;

constexpr int kWarps = 4;   // blocks per CTA of gj_warp_kernel

template <typename T, int WP>
__global__ void __launch_bounds__(kWarps * 32)
gj_warp_kernel(const T* __restrict__ D, T* __restrict__ Dinv,
               T* __restrict__ pivs, int* __restrict__ nbad, long long K,
               int W, int sanitize) {
  constexpr int LD = (WP | 1);
  __shared__ __align__(16) T tile[kWarps][WP * LD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long blk = (long long)blockIdx.x * kWarps + warp;
  if (blk >= K) return;
  T* s = tile[warp];
  stage_in<T, LD, 32>(D + blk * (W * W), s, W, lane);
  __syncwarp();

  T r[WP];
#pragma unroll
  for (int p = 0; p < WP; ++p)
    r[p] = (lane < W && p < W) ? s[lane * LD + p] : T(0);
  const T mypiv = gj_warp<T, WP>(r, W, lane);
  if (lane < W) {
#pragma unroll
    for (int p = 0; p < WP; ++p) {
      const int c = rotated_column<WP>(p, W);
      if (c < W) s[lane * LD + c] = finite_or_zero(r[p], sanitize);
    }
  }
  __syncwarp();
  stage_out<T, LD, 32>(s, Dinv + blk * (W * W), W, lane);

  if (lane < W) pivs[blk * W + lane] = mypiv;
  const unsigned bad =
      __ballot_sync(kFullMask, lane < W && bad_pivot(mypiv));
  if (lane == 0) nbad[blk] = __popc(bad);
}

template <typename T, int WP>
__global__ void __launch_bounds__(64)
gj_pair_kernel(const T* __restrict__ D, T* __restrict__ Dinv,
               T* __restrict__ pivs, int* __restrict__ nbad, int W,
               int sanitize) {
  constexpr int LD = (WP | 1);
  __shared__ __align__(16) T tile[WP * LD];
  __shared__ __align__(16) T rowbuf[2][WP];
  __shared__ int warp_bad[2];
  const int t = threadIdx.x;
  const long long blk = blockIdx.x;
  stage_in<T, LD, 64>(D + blk * (W * W), tile, W, t);
  __syncthreads();

  T r[WP];
#pragma unroll
  for (int p = 0; p < WP; ++p)
    r[p] = (t < W && p < W) ? tile[t * LD + p] : T(0);
  T mypiv = T(0);
  // Step j's row goes, unscaled, to rowbuf[j & 1].  Its owner writes it
  // after the barrier of step j - 1, which every thread reaches only after
  // its reads of step j - 2 (the same buffer): one barrier a step
  // suffices.  Every thread then takes the reciprocal of the pivot itself.
  // The columns rotate as in gj::gj_warp.
#pragma unroll 1
  for (int j = 0; j < W; ++j) {
    T* rb = rowbuf[j & 1];
    const bool own = t == j;
    if (own) {
#pragma unroll
      for (int p = 0; p < WP; ++p) rb[p] = r[p];
    }
    __syncthreads();
    const T d = rb[0];
    if (own) mypiv = d;
    const T dinv = guarded_inverse(d);
    const T f = own ? -dinv : r[0] * dinv;
#pragma unroll
    for (int p = 1; p < WP; ++p) {
      const T a = own ? T(0) : r[p];
      r[p - 1] = a - f * rb[p];
    }
    r[WP - 1] = own ? dinv : -f;
  }

  if (t < W) {
#pragma unroll
    for (int p = 0; p < WP; ++p) {
      const int c = rotated_column<WP>(p, W);
      if (c < W) tile[t * LD + c] = finite_or_zero(r[p], sanitize);
    }
    pivs[blk * W + t] = mypiv;
  }
  const unsigned bad = __ballot_sync(kFullMask, t < W && bad_pivot(mypiv));
  if ((t & 31) == 0) warp_bad[t >> 5] = __popc(bad);
  __syncthreads();
  stage_out<T, LD, 64>(tile, Dinv + blk * (W * W), W, t);
  if (t == 0) nbad[blk] = warp_bad[0] + warp_bad[1];
}

template <typename T, int WP>
int launch_width(const T* D, T* Dinv, T* pivs, int* nbad, long long K, int W,
                 int sanitize, cudaStream_t s) {
  if constexpr (WP <= 32) {
    const unsigned int grid = (unsigned int)((K + kWarps - 1) / kWarps);
    gj_warp_kernel<T, WP><<<grid, kWarps * 32, 0, s>>>(D, Dinv, pivs, nbad,
                                                       K, W, sanitize);
  } else {
    gj_pair_kernel<T, WP><<<(unsigned int)K, 64, 0, s>>>(D, Dinv, pivs,
                                                         nbad, W, sanitize);
  }
  return (int)cudaGetLastError();
}

#define GJ_CASE(wp) \
  case wp: \
    return launch_width<T, wp>(D, Dinv, pivs, nbad, K, W, sanitize, s);
#define GJ_CASE4(b) \
  GJ_CASE(b + 4) GJ_CASE(b + 8) GJ_CASE(b + 12) GJ_CASE(b + 16)

template <typename T>
int launch(const T* D, T* Dinv, T* pivs, int* nbad, long long K, int W,
           int sanitize, void* stream) {
  if (K <= 0) return 0;
  if (W < 1 || W > 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((W + 3) & ~3) {
    GJ_CASE4(0) GJ_CASE4(16) GJ_CASE4(32) GJ_CASE4(48)
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// D, Dinv: (K, W, W); pivs: (K, W); nbad: (K,) int32.  D and Dinv must be
// 16-byte aligned.  Returns the launch's cudaError_t.
extern "C" int gj_inverse_f64(const double* D, double* Dinv, double* pivs,
                              int* nbad, long long K, int W, int sanitize,
                              void* stream) {
  return launch<double>(D, Dinv, pivs, nbad, K, W, sanitize, stream);
}

extern "C" int gj_inverse_f32(const float* D, float* Dinv, float* pivs,
                              int* nbad, long long K, int W, int sanitize,
                              void* stream) {
  return launch<float>(D, Dinv, pivs, nbad, K, W, sanitize, stream);
}
