// Batched unpivoted Gauss-Jordan inverse with pivot sequence, for Hopper.
//
// Replaces asset_asrl_tpu/Solvers/pallas_kernels.py: batched_gj_inverse
// (_gj_call / _gj_kernel), and on the f64 path the XLA loop
// kkt_block._inv_gj_pivots.  For each symmetric quasi-definite block D of a
// (K, W, W) batch it returns D^-1 and the W pivots d_j = M[j, j] seen before
// step j.  The pivot signs give the block's inertia (Sylvester), which
// drives the interior-point solver's perturbation ladder.
//
// What bounds it: at W = 24 a block is 4.6 KB in f64 and is read and
// written once, so bytes are negligible; the W sequential steps, each a
// row/column broadcast followed by a __syncthreads(), make it latency- and
// sync-bound.  The design keeps one block resident in shared memory per
// CTA for all W steps, as the Pallas kernel keeps a tile resident in VMEM,
// and many CTAs (one per block, K up to thousands) hide each other's
// latency across the 132 SMs.
//
// Step j (in place, no augmented identity):
//   row j       <- M[j, :] / d,  entry (j, j) <- 1 / d
//   row i != j  <- M[i, :] - M[i, j] * M[j, :] / d,
//                  entry (i, j) <- -M[i, j] / d
// Old row j and column j are copied to shared scratch first, then a
// barrier, so the update reads no entry another thread is overwriting.
// The pivot guard is |d| > guard (1e-300 in f64, 1e-30 in f32, as in the
// JAX code); a zero or non-finite pivot is still written to `pivs`, so the
// caller counts it as an inertia failure.
//
// Supported: 1 <= W <= 64 (a 64x64 f64 block plus scratch is 33 KB, under
// the 48 KB of static/default dynamic shared memory).

#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T abs_val(T v) { return v < T(0) ? -v : v; }

template <typename T>
__global__ void gj_inverse_kernel(const T* __restrict__ D,
                                  T* __restrict__ Dinv,
                                  T* __restrict__ pivs,
                                  int W, T guard) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* M = reinterpret_cast<T*>(smem_raw);
  T* rowj = M + W * W;
  T* colj = rowj + W;

  const long long blk = blockIdx.x;
  const int WW = W * W;
  const T* src = D + blk * WW;
  T* dst = Dinv + blk * WW;
  T* piv = pivs + blk * W;

  for (int e = threadIdx.x; e < WW; e += blockDim.x) M[e] = src[e];
  __syncthreads();

  for (int j = 0; j < W; ++j) {
    for (int t = threadIdx.x; t < W; t += blockDim.x) {
      rowj[t] = M[j * W + t];
      colj[t] = M[t * W + j];
    }
    __syncthreads();
    const T d = rowj[j];
    if (threadIdx.x == 0) piv[j] = d;
    const T dsafe = abs_val(d) > guard ? d : T(1);
    const T dinv = T(1) / dsafe;
    for (int e = threadIdx.x; e < WW; e += blockDim.x) {
      const int i = e / W;
      const int k = e - i * W;
      T v;
      if (i == j) {
        v = (k == j) ? dinv : rowj[k] / dsafe;
      } else if (k == j) {
        v = -(colj[i] * dinv);
      } else {
        v = M[e] - colj[i] * (rowj[k] / dsafe);
      }
      M[e] = v;
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < WW; e += blockDim.x) dst[e] = M[e];
}

template <typename T>
int launch(const T* D, T* Dinv, T* pivs, long long K, int W, T guard,
           void* stream) {
  if (K <= 0) return 0;
  int threads = ((W * W + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = sizeof(T) * (size_t)(W * W + 2 * W);
  gj_inverse_kernel<T><<<(unsigned int)K, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      D, Dinv, pivs, W, guard);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gj_inverse_f64(const double* D, double* Dinv, double* pivs,
                              long long K, int W, void* stream) {
  return launch<double>(D, Dinv, pivs, K, W, 1e-300, stream);
}

extern "C" int gj_inverse_f32(const float* D, float* Dinv, float* pivs,
                              long long K, int W, void* stream) {
  return launch<float>(D, Dinv, pivs, K, W, 1e-30f, stream);
}
