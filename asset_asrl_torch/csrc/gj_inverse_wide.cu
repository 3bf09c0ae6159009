// Kernel K1, wide blocks (W > 64, the dense border of a multi-phase KKT):
// blocked right-looking Gauss-Jordan inverse with pivot sequence and the
// same inertia epilogue as the narrow kernels, for Hopper.
//
// Replaces asset_asrl_tpu/Solvers/pallas_kernels.py: batched_gj_inverse
// and kkt_block._inv_gj_pivots at the widths a border reaches (segments
// + 5 for a PathToPath link).  Results: D^-1 in place in the output
// buffer, the W pivots of the unblocked elimination, the count of bad
// pivots per block, and optionally 0 stored for non-finite entries (the
// last panel writes every entry of the block once more, and stores it so).
//
// What bounds it: a border is one block (K = 1) and the unblocked
// elimination is a chain of W dependent rank-1 steps, so one CTA would
// work on one of the 132 SMs for W passes over the block.  Here the
// elimination runs in panels of NB = 32 columns, which cuts the chain to
// W / NB steps and turns the rest into tile products that spread over
// the SMs.  For panel p with columns J (A is the current state):
//
//   gj_panel_kernel   every CTA inverts the NB x NB diagonal block A_JJ
//                     (one warp, gj::gj_warp, rows in registers; a
//                     ragged last panel is padded with an identity) and
//                     then owns one tile of the panels:
//                       row role, column tile c:  A_Jc <- inv(A_JJ) A_Jc,
//                         and a raw copy of it to the scratch `rnew`
//                       column role, row tile i:  keeps the old A_iJ in
//                         the scratch `cold`, A_iJ <- -A_iJ inv(A_JJ)
//                     The CTA of the diagonal tile writes the panel's
//                     pivots, its bad-pivot count and inv(A_JJ) (to the
//                     scratch `pbuf`: other CTAs still read A_JJ).
//   gj_update_kernel  64 x 64 output tiles over the whole block:
//                       A_ic <- A_ic - cold_i rnew_c   (i, c outside J)
//                       A_JJ <- pbuf
//                     operands staged through shared memory, 4 x 4
//                     outputs a thread, plain FP64/FP32 FMAs.
//
// With `sanitize` set, the stores of the last panel (both kernels) write
// 0 for a non-finite value.  The products read only the raw scratch
// copies, so the result is that of zeroing after the whole elimination.
//
// The pivots of the diagonal blocks are the pivots of the unblocked
// elimination (a Gauss-Jordan step with a guarded pivot is an exact sweep
// of the block with that pivot replaced, and sweeps commute), summed in
// another order: equal to rounding, not bitwise.
//
// The grid agrees between phases by stream order: a chain of plain
// launches, two a panel, on the caller's stream.  Chosen over a
// cooperative launch because each phase gets the grid that fits it (the
// panel phase 2 W / NB CTAs, the update (W / 64)^2), no co-residency
// limit caps the width, and the chain can be captured in a CUDA graph.
// Nothing synchronises with the host.  Every sum has a fixed order and
// no atomics are used, so a second run is bitwise equal.

#include "gj_common.cuh"

namespace {

using namespace gj;

constexpr int NB = 32;        // panel width
constexpr int TS = 64;        // output tile of the update
constexpr int kThreads = 256;

// grid (tiles, 2 roles, K); see the file note.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gj_panel_kernel(T* A, T* __restrict__ pivs, int* __restrict__ nbad,
                T* __restrict__ cold, T* __restrict__ rnew,
                T* __restrict__ pbuf, int W, int p, int sanitize) {
  __shared__ T P[NB][NB + 1];
  __shared__ T X[NB][NB + 1];
  const int tile = blockIdx.x, role = blockIdx.y;
  const long long blk = blockIdx.z;
  if (role == 1 && tile == p) return;
  const bool diag = tile == p;
  const int j0 = p * NB, t0 = tile * NB;
  const int nbp = min(NB, W - j0), nbt = min(NB, W - t0);
  A += blk * W * W;
  cold += blk * W * NB;
  rnew += blk * W * NB;
  pbuf += blk * NB * NB;

  for (int e = threadIdx.x; e < NB * NB; e += kThreads) {
    const int rr = e / NB, cc = e % NB;
    P[rr][cc] = (rr < nbp && cc < nbp)
                    ? A[(long long)(j0 + rr) * W + j0 + cc]
                    : (rr == cc ? T(1) : T(0));
    T x = T(0);
    if (!diag) {
      if (role == 0) {
        if (rr < nbp && cc < nbt) x = A[(long long)(j0 + rr) * W + t0 + cc];
      } else {
        if (rr < nbt && cc < nbp) x = A[(long long)(t0 + rr) * W + j0 + cc];
      }
    }
    X[rr][cc] = x;
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    T r[NB];
#pragma unroll
    for (int q = 0; q < NB; ++q) r[q] = P[lane][q];
    const T mypiv = gj_warp<T, NB>(r, NB, lane);
#pragma unroll
    for (int q = 0; q < NB; ++q) P[lane][q] = r[q];
    if (diag) {
      if (lane < nbp) pivs[blk * W + j0 + lane] = mypiv;
      const unsigned bad =
          __ballot_sync(kFullMask, lane < nbp && bad_pivot(mypiv));
      if (lane == 0) nbad[blk] = (p == 0 ? 0 : nbad[blk]) + __popc(bad);
    }
  }
  __syncthreads();

  if (diag) {
    for (int e = threadIdx.x; e < NB * NB; e += kThreads)
      pbuf[e] = P[e / NB][e % NB];
    return;
  }

  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  T acc[4] = {T(0), T(0), T(0), T(0)};
  if (role == 0) {
#pragma unroll 8
    for (int k = 0; k < NB; ++k) {
      const T x = X[k][tx];
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a] += P[ty + 8 * a][k] * x;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int rr = ty + 8 * a;
      if (rr < nbp && tx < nbt) {
        A[(long long)(j0 + rr) * W + t0 + tx] =
            finite_or_zero(acc[a], sanitize);
        rnew[(long long)rr * W + t0 + tx] = acc[a];
      }
    }
  } else {
#pragma unroll 8
    for (int k = 0; k < NB; ++k) {
      const T x = P[k][tx];
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a] += X[ty + 8 * a][k] * x;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int rr = ty + 8 * a;
      if (rr < nbt) {
        cold[(long long)(t0 + rr) * NB + tx] = X[rr][tx];
        if (tx < nbp)
          A[(long long)(t0 + rr) * W + j0 + tx] =
              finite_or_zero(-acc[a], sanitize);
      }
    }
  }
}

// grid (ceil(W / TS), ceil(W / TS), K); see the file note.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gj_update_kernel(T* A, const T* __restrict__ cold,
                 const T* __restrict__ rnew, const T* __restrict__ pbuf,
                 int W, int p, int sanitize) {
  __shared__ T Cs[TS][NB + 1];
  __shared__ T Rs[NB][TS];
  const long long blk = blockIdx.z;
  const int c0 = blockIdx.x * TS, i0 = blockIdx.y * TS;
  const int j0 = p * NB;
  const int j1 = min(W, j0 + NB);
  A += blk * W * W;
  cold += blk * W * NB;
  rnew += blk * W * NB;
  pbuf += blk * NB * NB;

  for (int e = threadIdx.x; e < TS * NB; e += kThreads) {
    const int rr = e / NB, k = e % NB;
    const int i = i0 + rr;
    Cs[rr][k] = (i < W && (i < j0 || i >= j1))
                    ? cold[(long long)i * NB + k] : T(0);
  }
  for (int e = threadIdx.x; e < NB * TS; e += kThreads) {
    const int k = e / TS, cc = e % TS;
    const int c = c0 + cc;
    Rs[k][cc] = (j0 + k < j1 && c < W && (c < j0 || c >= j1))
                    ? rnew[(long long)k * W + c] : T(0);
  }
  __syncthreads();

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  T acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = T(0);
#pragma unroll 4
  for (int k = 0; k < NB; ++k) {
    T cv[4], rv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) cv[a] = Cs[ty + 16 * a][k];
#pragma unroll
    for (int b = 0; b < 4; ++b) rv[b] = Rs[k][tx + 16 * b];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] += cv[a] * rv[b];
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= W) continue;
    const bool ij = i >= j0 && i < j1;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = c0 + tx + 16 * b;
      if (c >= W) continue;
      const bool cj = c >= j0 && c < j1;
      T* dst = A + (long long)i * W + c;
      if (!ij && !cj) {
        *dst = finite_or_zero(*dst - acc[a][b], sanitize);
      } else if (ij && cj) {
        *dst = finite_or_zero(pbuf[(i - j0) * NB + (c - j0)], sanitize);
      }
    }
  }
}

template <typename T>
int launch_wide(const T* D, T* Dinv, T* pivs, int* nbad, T* scratch,
                long long K, int W, int sanitize, void* stream) {
  if (K <= 0) return 0;
  if (K > 65535 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = K * W * W;
  cudaError_t err = cudaMemcpyAsync(Dinv, D, sizeof(T) * (size_t)n,
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  T* cold = scratch;
  T* rnew = cold + K * W * NB;
  T* pbuf = rnew + K * W * NB;
  const int tiles = (W + NB - 1) / NB, big = (W + TS - 1) / TS;
  for (int p = 0; p < tiles; ++p) {
    const int last = sanitize && p == tiles - 1;
    gj_panel_kernel<T><<<dim3(tiles, 2, (unsigned int)K), kThreads, 0, s>>>(
        Dinv, pivs, nbad, cold, rnew, pbuf, W, p, last);
    gj_update_kernel<T><<<dim3(big, big, (unsigned int)K), kThreads, 0, s>>>(
        Dinv, cold, rnew, pbuf, W, p, last);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// D, Dinv: (K, W, W); pivs: (K, W); nbad: (K,) int32; scratch: K * (2 *
// W * 32 + 32 * 32) elements.  Returns the first failing call's cudaError_t.
extern "C" int gj_inverse_wide_f64(const double* D, double* Dinv,
                                   double* pivs, int* nbad, double* scratch,
                                   long long K, int W, int sanitize,
                                   void* stream) {
  return launch_wide<double>(D, Dinv, pivs, nbad, scratch, K, W, sanitize,
                             stream);
}

extern "C" int gj_inverse_wide_f32(const float* D, float* Dinv, float* pivs,
                                   int* nbad, float* scratch, long long K,
                                   int W, int sanitize, void* stream) {
  return launch_wide<float>(D, Dinv, pivs, nbad, scratch, K, W, sanitize,
                            stream);
}
