// Batched solve of (L L') x = b given the lower Cholesky factor L.
//
// Replaces the TPU kernel cho_solve_batch (dgsqp_tpu/ops/linalg_pallas.py:243-276; body
// _tri_solve_kernel_body :145-186, pallas_call :214), which ran the forward and the
// backward substitution per lane with the batch over the 128 vector lanes and chunked
// the right-hand sides to a VMEM budget.  That budget is a TPU constraint and is gone.
//
// Contract: L is (batch, n, n) row-major, lower triangular (the upper triangle is never
// read); b and x are (batch, n, k) row-major (k = 1 for a vector right-hand side).
// Forward substitution L y = b, then backward substitution L' x = y reading L
// transposed.
//
// What bounds it on the H100: at batch 256, n 100, f32, the work is 2*batch*n^2*k FLOP
// (5.1 MFLOP at k = 1, 328 MFLOP at k = 64) and the traffic is one read of L's lower
// triangle, batch*n(n+1)/2*4 B = 5.2 MB, plus one read of b and one write of x: 5.4 MB
// (1.6 us at 3.35 TB/s) at k = 1 and 18.3 MB (5.5 us) at k = 64, against 0.08 us and
// 4.9 us at 67 TFLOP/s.  So the bytes set the bound at both shapes; a substitution is also a
// chain of 2n dependent steps, so a single solve is latency-bound.
//
// Design: one thread block per (matrix, tile of up to 32 right-hand sides), with L and
// the tile in dynamic shared memory (row stride n|1 for L).  L is read from device
// memory once per tile and the right-hand side once; every intermediate stays on chip.
// Each step divides row j by the pivot, then the block's threads share the rank-1
// update of the rows still to solve (below j going forward, above j going back).  At
// batch 256 this launches 256 blocks for k = 1 and 512 for k = 64 on the 132 SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
cho_solve_kernel(const T* __restrict__ L, const T* __restrict__ b, T* __restrict__ x,
                 int n, int k, int ld) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* l = reinterpret_cast<T*>(smem_raw);
  T* y = l + n * ld;                       // (n, kw) tile, row stride kTile
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * kTile;
  const int kw = min(kTile, k - c0);
  const long long mat = blockIdx.x;
  const T* Lb = L + mat * n * n;
  const T* bb = b + mat * n * k;
  T* xb = x + mat * n * k;

  for (int e = tid; e < n * n; e += kThreads) {
    const int i = e / n, c = e - i * n;
    if (c <= i) l[i * ld + c] = Lb[e];
  }
  for (int e = tid; e < n * kw; e += kThreads) {
    const int r = e / kw, c = e - r * kw;
    y[r * kTile + c] = bb[r * k + c0 + c];
  }
  __syncthreads();

  // forward: L y = b
  for (int j = 0; j < n; ++j) {
    for (int c = tid; c < kw; c += kThreads) y[j * kTile + c] = y[j * kTile + c] / l[j * ld + j];
    __syncthreads();
    const int m = n - j - 1;
    for (int e = tid; e < m * kw; e += kThreads) {
      const int r = e / kw, c = e - r * kw;
      const int i = j + 1 + r;
      y[i * kTile + c] = y[i * kTile + c] - l[i * ld + j] * y[j * kTile + c];
    }
    __syncthreads();
  }
  // backward: L' x = y, row j of L' is column j of L
  for (int j = n - 1; j >= 0; --j) {
    for (int c = tid; c < kw; c += kThreads) y[j * kTile + c] = y[j * kTile + c] / l[j * ld + j];
    __syncthreads();
    for (int e = tid; e < j * kw; e += kThreads) {
      const int i = e / kw, c = e - i * kw;
      y[i * kTile + c] = y[i * kTile + c] - l[j * ld + i] * y[j * kTile + c];
    }
    __syncthreads();
  }

  for (int e = tid; e < n * kw; e += kThreads) {
    const int r = e / kw, c = e - r * kw;
    xb[r * k + c0 + c] = y[r * kTile + c];
  }
}

template <typename T>
int launch(const void* L, const void* b, void* x, int batch, int n, int k, void* stream) {
  const int ld = n | 1;
  const size_t smem = (static_cast<size_t>(n) * ld + static_cast<size_t>(n) * kTile) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      cho_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch, (k + kTile - 1) / kTile);
  cho_solve_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), static_cast<const T*>(b), static_cast<T*>(x), n, k, ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dgsqp_cho_solve_f32(const void* L, const void* b, void* x, int batch, int n,
                                   int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<float>(L, b, x, batch, n, k, stream);
}

extern "C" int dgsqp_cho_solve_f64(const void* L, const void* b, void* x, int batch, int n,
                                   int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<double>(L, b, x, batch, n, k, stream);
}
