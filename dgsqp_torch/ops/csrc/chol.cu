// Batched lower Cholesky factorization, A = L L', for small SPD matrices.
//
// Replaces the TPU kernel chol_batch (dgsqp_tpu/ops/linalg_pallas.py:123-142; body
// _chol_kernel_body :35-85, pallas_call :109), which laid the batch over the 128 vector
// lanes and ran a blocked 8-wide right-looking algorithm per lane.
//
// Contract: A is (batch, n, n) row-major, contiguous, SPD (nothing above its diagonal
// is used); L is (batch, n, n) with the upper triangle written as zero (the
// jnp.linalg.cholesky contract).  A non-PD input yields NaN/Inf entries in that matrix
// only, never an error, so masked-out games in a batch cannot abort the launch.
//
// What bounds it on the H100: at the main path's shape (batch 256, n 100, f32) the work
// is batch*n^3/3 = 85 MFLOP and the traffic is one read of A's lower triangle and one
// write of L, 15.4 MB: 4.6 us at 3.35 TB/s against 1.3 us at 67 TFLOP/s, so the bytes
// set the bound.  What a launch really waits for is the chain of n dependent columns
// (a square root and a reciprocal each) and the launch itself.  The first version paid
// two block barriers per column (2n = 200 per matrix at n = 100) and did one
// multiply-add per two shared-memory loads in its rank-1 update.
//
// Design: one 256-thread block per matrix, the matrix in dynamic shared memory (row
// stride as in common.cuh), right-looking and blocked by panels of kNb columns.  Per
// panel:
//  (a) every thread that owns a row of the panel or below it factors the kNb x kNb
//      diagonal block for itself in registers (the loads are broadcasts), which costs no
//      barrier and no shuffle;
//  (b) it then solves its own row against that block's transpose, kNb values in
//      registers, and writes them to the matrix and, transposed, to a panel buffer
//      P[q][i] (so that the update's tile loads below are consecutive across lanes);
//  (c) one barrier;
//  (d) rank-kNb update of the lower trailing triangle in 4 x 4 register tiles: a thread
//      reads 4 + 4 panel values per panel column (two 16-byte loads) for 16
//      multiply-adds, and tiles wholly above the diagonal are never enumerated;
//  (e) one barrier.
// Block barriers per matrix: 2*ceil(n/kNb) + 1 (27 at n = 100, kNb = 8) against 2n + 1.
// Multiply-adds per shared-memory load in the update rise from 1/2 to 128/24.  A ragged
// last panel (100 = 12*8 + 4, n = 37, 150) is handled here: columns beyond n act as an
// identity block.  All arithmetic is full f32 / f64 fused multiply-add on the CUDA
// cores: the tensor cores' wgmma has no exact-f32 mode (TF32 keeps 10 mantissa bits),
// and the KKT and merit machinery needs full f32 accumulation, so it is not the tool.
//
// A comes in by cp.async, lower triangle only, 16 bytes per lane where n and the pointer
// allow, else one element per lane; L goes out in 16-byte stores likewise.  Shared
// memory per matrix at n = 100: 43 KB in f32 (5 matrices per SM) and 85 KB in f64 (2 per
// SM), so the main path's 256 matrices are one wave on the 132 SMs; n = 150 in f64 takes
// 190 KB of the 227 KB.

#include "common.cuh"

namespace {

using namespace dgsqp;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Columns per panel (dgsqp_torch.ops.linalg.CHOL_PANEL sizes the panel buffer with the
// same number).  Panels of 16 were tried on the H100: slower in f32 at n = 100 and 64, and
// in f64 the 16 x 16 diagonal block does not fit the registers (ptxas: 2244 bytes of
// spill stores).
constexpr int kNb = 8;

__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_kernel(const T* __restrict__ A, T* __restrict__ L, int n, int ld, int aligned) {
  constexpr int kVec = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a = reinterpret_cast<T*>(smem_raw);
  const int np = (n + 3) & ~3;
  T* P = a + n * ld;                       // (kNb, np): the panel, transposed
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  const T* Ab = A + off;
  T* Lb = L + off;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  copy_lower_async(a, Ab, n, ld, warp, kWarps, lane, aligned != 0);
  cp_async_wait_all();
  __syncthreads();

  for (int p = 0; p < n; p += kNb) {
    const int i = p + tid;                 // this thread's row, if any
    const int ri = tid;                    // its index relative to the panel
    const bool have = i < n;
    T l[kNb];
    if (have) {
      // (a) diagonal block, factored redundantly in registers
      T D[kNb][kNb], invd[kNb];
#pragma unroll
      for (int r = 0; r < kNb; ++r) {
        if (p + r < n) {
#pragma unroll
          for (int c = 0; c <= r; c += kVec) load_vec(a + (p + r) * ld + p + c, &D[r][c]);
        } else {
#pragma unroll
          for (int c = 0; c < kNb; ++c) D[r][c] = (c == r) ? T(1) : T(0);
        }
      }
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        T s = D[j][j];
#pragma unroll
        for (int q = 0; q < j; ++q) s = fma(-D[j][q], D[j][q], s);
        const T d = dev_sqrt(s);
        D[j][j] = d;
        invd[j] = T(1) / d;
#pragma unroll
        for (int r = j + 1; r < kNb; ++r) {
          T v = D[r][j];
#pragma unroll
          for (int q = 0; q < j; ++q) v = fma(-D[r][q], D[j][q], v);
          D[r][j] = v * invd[j];
        }
      }
      // (b) this thread's row against the block's transpose
      T av[kNb];
#pragma unroll
      for (int c = 0; c < kNb; c += kVec) {
        if (p + c < ld) {
          load_vec(a + i * ld + p + c, av + c);
        } else {
#pragma unroll
          for (int u = 0; u < kVec; ++u) av[c + u] = T(0);
        }
      }
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        T s = (p + j < n) ? av[j] : T(0);
#pragma unroll
        for (int q = 0; q < j; ++q) s = fma(-l[q], D[j][q], s);
        l[j] = j < ri ? s * invd[j] : (j == ri ? D[j][j] : T(0));
      }
      if (ri >= kNb) {
#pragma unroll
        for (int c = 0; c < kNb; c += kVec)
          if (p + c < ld) store_vec(a + i * ld + p + c, l + c);
#pragma unroll
        for (int q = 0; q < kNb; ++q) P[q * np + i] = l[q];
      }
    }
    __syncthreads();                       // (c)
    // rows of the diagonal block are written only now: (a) read them unfactored
    if (have && ri < kNb) {
#pragma unroll
      for (int c = 0; c < kNb; c += kVec)
        if (c <= ri && p + c < ld) store_vec(a + i * ld + p + c, l + c);
    }
    // (d) trailing update, lower triangle in 4 x 4 tiles numbered row by row
    const int t0 = p + kNb;
    if (t0 < n) {
      const int mt = (n - t0 + 3) >> 2;
      const int ntiles = mt * (mt + 1) / 2;
      for (int idx = tid; idx < ntiles; idx += kThreads) {
        int ti = static_cast<int>((sqrtf(8.0f * idx + 1.0f) - 1.0f) * 0.5f);
        while (ti * (ti + 1) / 2 > idx) --ti;
        while ((ti + 1) * (ti + 2) / 2 <= idx) ++ti;
        const int tk = idx - ti * (ti + 1) / 2;
        const int i0 = t0 + 4 * ti, k0 = t0 + 4 * tk;
        T c[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) c[r][s] = T(0);
#pragma unroll
        for (int q = 0; q < kNb; ++q) {
          T pr[4], pc[4];
          load4(P + q * np + i0, pr);
          load4(P + q * np + k0, pc);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s) c[r][s] = fma(pr[r], pc[s], c[r][s]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (i0 + r < n) {
            T row[4];
            load4(a + (i0 + r) * ld + k0, row);
#pragma unroll
            for (int s = 0; s < 4; ++s) row[s] -= c[r][s];
            store4(a + (i0 + r) * ld + k0, row);
          }
        }
      }
    }
    __syncthreads();                       // (e)
  }

  // L out: zero above the diagonal
  for (int i = warp; i < n; i += kWarps) {
    T* lrow = Lb + static_cast<size_t>(i) * n;
    if (aligned) {
      for (int ch = lane; ch < n / kVec; ch += 32) {
        T v[kVec];
        load_vec(a + i * ld + ch * kVec, v);
#pragma unroll
        for (int u = 0; u < kVec; ++u)
          if (ch * kVec + u > i) v[u] = T(0);
        store_vec(lrow + ch * kVec, v);
      }
    } else {
      for (int c = lane; c < n; c += 32) lrow[c] = c <= i ? a[i * ld + c] : T(0);
    }
  }
}

// ld and smem follow dgsqp_torch.ops.linalg (row_stride, chol_smem_bytes); set_attr asks
// to raise the kernel's dynamic shared-memory limit to smem first.
template <typename T>
int launch(const void* A, void* L, int batch, int n, int nb, int ld, int smem, int set_attr,
           int device, void* stream) {
  // one row per thread in a panel's column block; the caller sized smem for nb columns
  if (n > kThreads || nb != kNb) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (set_attr) {
    cudaError_t err = cudaFuncSetAttribute(chol_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chol_kernel<T><<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<T*>(L), n, ld,
      rows_aligned<T>(A, n) && rows_aligned<T>(L, n) ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dgsqp_chol_f32(const void* A, void* L, int batch, int n, int nb, int ld, int smem,
                              int set_attr, int device, void* stream) {
  return launch<float>(A, L, batch, n, nb, ld, smem, set_attr, device, stream);
}

extern "C" int dgsqp_chol_f64(const void* A, void* L, int batch, int n, int nb, int ld, int smem,
                              int set_attr, int device, void* stream) {
  return launch<double>(A, L, batch, n, nb, ld, smem, set_attr, device, stream);
}
