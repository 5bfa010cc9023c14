// Batched lower Cholesky factorization, A = L L', for small SPD matrices.
//
// Replaces the TPU kernel chol_batch (dgsqp_tpu/ops/linalg_pallas.py:123-142; body
// _chol_kernel_body :35-85, pallas_call :109), which laid the batch over the 128 vector
// lanes and ran a blocked 8-wide right-looking algorithm per lane.
//
// Contract: A is (batch, n, n) row-major, contiguous, SPD; L is (batch, n, n) with the
// upper triangle written as zero (the jnp.linalg.cholesky contract).  A non-PD input
// yields NaN/Inf entries, never an error, so masked-out games in a batch cannot abort
// the launch.
//
// What bounds it on the H100: at the main path's shape (batch 256, n 100, f32) the work
// is batch*n^3/3 = 85 MFLOP and the traffic is one read of A's lower triangle and one
// write of L, (n(n+1)/2 + n^2)*batch*4 B = 15.4 MB: 4.6 us at 3.35 TB/s and 1.3 us at
// 67 TFLOP/s (f32 without tensor cores), so the bytes set the bound.  The column recursion itself is a chain of
// n dependent steps, each ending in a block-wide barrier, so a single matrix is
// latency-bound; parallelism comes from the batch and from the trailing update.
//
// Design: one thread block per matrix with the whole matrix in dynamic shared memory
// (row stride n|1 so column walks do not hit one bank; 40 KB in f32 and 80 KB in f64 at
// n = 100, above the 48 KB default, so the opt-in attribute is raised).  A is read from
// device memory once (its lower triangle only; the upper is never read) and L written
// once, coalesced; every intermediate stays on chip.  Column by column, right-looking:
// the block scales the column below the diagonal, then each warp takes whole rows of the
// lower trailing triangle's rank-1 update, its lanes over the row's columns up to the
// diagonal, so no thread idles on the upper half.  256 blocks at batch 256 cover the 132 SMs.  No wgmma/TMA yet: a first,
// simple and exact kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_kernel(const T* __restrict__ A, T* __restrict__ L, int n, int ld) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a = reinterpret_cast<T*>(smem_raw);
  const long long off = static_cast<long long>(blockIdx.x) * n * n;
  const T* Ab = A + off;
  T* Lb = L + off;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nn = n * n;

  for (int e = tid; e < nn; e += kThreads) {
    const int i = e / n, k = e - i * n;
    if (k <= i) a[i * ld + k] = Ab[e];
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    // every thread reads the pivot before the barrier below; only then is it replaced
    const T d = dev_sqrt(a[j * ld + j]);
    for (int i = j + 1 + tid; i < n; i += kThreads) a[i * ld + j] = a[i * ld + j] / d;
    __syncthreads();
    if (tid == 0) a[j * ld + j] = d;
    for (int i = j + 1 + warp; i < n; i += kWarps) {
      const T lij = a[i * ld + j];
      for (int k = j + 1 + lane; k <= i; k += 32)
        a[i * ld + k] = a[i * ld + k] - lij * a[k * ld + j];
    }
    __syncthreads();
  }

  for (int e = tid; e < nn; e += kThreads) {
    const int i = e / n, k = e - i * n;
    Lb[e] = (k <= i) ? a[i * ld + k] : T(0);
  }
}

template <typename T>
int launch(const void* A, void* L, int batch, int n, void* stream) {
  const int ld = n | 1;
  const size_t smem = static_cast<size_t>(n) * ld * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      chol_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_kernel<T><<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<T*>(L), n, ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dgsqp_chol_f32(const void* A, void* L, int batch, int n, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<float>(A, L, batch, n, stream);
}

extern "C" int dgsqp_chol_f64(const void* A, void* L, int batch, int n, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<double>(A, L, batch, n, stream);
}
