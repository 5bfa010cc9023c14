// Batched solve of (L L') x = b given the lower Cholesky factor L.
//
// Replaces the TPU kernel cho_solve_batch (dgsqp_tpu/ops/linalg_pallas.py:243-276; body
// _tri_solve_kernel_body :145-186, pallas_call :214), which ran the forward and the
// backward substitution per lane with the batch over the 128 vector lanes and chunked
// the right-hand sides to a VMEM budget.  That budget is a TPU constraint and is gone.
//
// Contract: L is (batch, n, n) row-major, lower triangular (nothing above the diagonal
// is used); b and x are (batch, n, k) row-major (k = 1 for a vector right-hand side).
// Forward substitution L y = b, then backward substitution L' x = y reading L
// transposed.  Rows are scaled by the reciprocal of the diagonal, one IEEE division per
// row, in place of a division per step.
//
// What bounds it on the H100: at batch 256, n 100, f32, the work is 2*batch*n^2*k FLOP
// (5.1 MFLOP at k = 1, 328 MFLOP at k = 64) and the traffic is one read of L's lower
// triangle plus one read of b and one write of x: 5.4 MB (1.6 us at 3.35 TB/s) at k = 1
// and 18.3 MB (5.5 us) at k = 64, so the bytes set the bound.  What a launch really
// waits for is the substitution's chain of 2n dependent steps and the launch itself;
// the first version spent it on 4n = 400 block barriers per matrix (two per step).
// This version has one block barrier (two on the column path), after the load, and none
// inside a substitution loop; with the barriers gone, the copy of L into shared memory
// became the larger part of a k = 1 launch, so every block copies with 8 warps.
//
// Two kernels, chosen by the wrapper from (n, k, dtype) alone
// (dgsqp_torch.ops.linalg.cho_solve_plan):
//
//  * warp path, k small: one warp owns one right-hand-side column of one matrix; a
//    block is 8 warps of the same matrix, min(k, 8) of which solve a column each.  All 8
//    copy L and those without a column then leave: at k = 1, batch 256, n = 100, f32, a
//    block of one warp that copied alone, even though it began the forward pass as soon
//    as the first 32 rows had arrived (one cp.async group per row block, __syncwarp only),
//    took 22.8 us on the H100, with 2, 4 and 8 copying warps and one barrier 16.1, 13.3
//    and 11.9 us (scripts/torch_tune_kernels.py).  The solution lives in registers, lane
//    i holding x[32 t + i] of row block t.  Per row block: a parallel 32 x 32t
//    matrix-vector product (forward: one row per lane, 16-byte row reads and the x
//    values broadcast from a per-warp buffer; backward: one column of L per lane, so the
//    lanes read consecutive words), then the 32 x 32 triangular solve with the lane's
//    row (or column) of the diagonal block in registers, scaled by the reciprocal of its
//    diagonal beforehand, and one __shfl_sync broadcast per step.  The dependent chain is
//    2n steps of one shuffle and one multiply-add.
//  * column path, k large: one thread owns one right-hand-side column, a block is one
//    matrix and a tile of `width` columns.  Every thread of a warp reads the same
//    L[i][j], a shared-memory broadcast, and updates its own column, kept in shared
//    memory with the column index fastest (conflict-free, and b and x are read and
//    written coalesced along k).  Register tiles of 4 rows by 4 columns make it two
//    shared-memory loads per four multiply-adds.  A thread touches its own column only,
//    so after the load there is no barrier at all.
//
// L reaches shared memory by cp.async, 16 bytes per lane, lower triangle only, with no
// index division; when n is not a multiple of the chunk (n = 37, or 150 in f32) or the
// pointer is unaligned the copy falls back to one element per lane, still asynchronous.
// The row stride (common.cuh) keeps both the row walk and the column walk free of bank
// conflicts.
//
// Occupancy: shared memory per matrix at n = 100 is 40 KB (f32) or 82 KB (f64) plus the
// vectors, against 227 KB per SM: 5 (f32) or 2 (f64) matrices are in flight per SM on
// the warp path, so the 256 matrices of the main path are one wave on the 132 SMs; on
// the column path at k = 64 a block holds 66 KB (f32), 3 per SM, again one wave.

#include "common.cuh"

namespace {

using namespace dgsqp;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 256;

// ------------------------------------------------------------------------- warp path
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
cho_solve_warp_kernel(const T* __restrict__ L, const T* __restrict__ b, T* __restrict__ x,
                      int n, int k, int cols, int ld, int aligned) {
  constexpr int kVec = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // `cols` warps of the block solve a column each; all its warps share the copy of L
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nblk = (n + 31) >> 5, n32 = nblk * 32;
  T* l = reinterpret_cast<T*>(smem_raw);
  const bool solver = warp < cols && blockIdx.y * cols + warp < k;
  T* xs = l + n * ld + (solver ? warp : 0) * n32;   // this warp's vector: y, then x
  const size_t mat = blockIdx.x;
  const int col = blockIdx.y * cols + warp;
  const T* Lb = L + mat * n * n;
  const T* bb = b + mat * n * k + col;
  T* xb = x + mat * n * k + col;

  copy_lower_async(l, Lb, n, ld, warp, nwarps, lane, aligned != 0);
  // b goes to the warp's vector now, so its loads overlap the copy of L
  if (solver)
    for (int i = lane; i < n32; i += 32) xs[i] = i < n ? bb[static_cast<size_t>(i) * k] : T(0);
  cp_async_wait_all();
  __syncthreads();
  if (!solver) return;

  // forward: L y = b
  for (int t = 0; t < nblk; ++t) {
    const int row = 32 * t + lane;
    const bool valid = row < n;
    const T* lrow_s = l + row * ld;
    T acc = xs[row];
    T lrow[32];
    T inv = T(1);
    if (valid) {
      T part[kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u) part[u] = T(0);
#pragma unroll 4
      for (int c = 0; c < 32 * t; c += kVec) {
        T lv[kVec], xv[kVec];
        load_vec(lrow_s + c, lv);
        load_vec(xs + c, xv);
#pragma unroll
        for (int u = 0; u < kVec; ++u) part[u] = fma(lv[u], xv[u], part[u]);
      }
      T sum = part[0];
#pragma unroll
      for (int u = 1; u < kVec; ++u) sum += part[u];
      acc -= sum;
      inv = T(1) / lrow_s[row];
    }
#pragma unroll
    for (int g = 0; g < 32; g += kVec) {
      const int c = 32 * t + g;
      if (valid && c < ld) {
        load_vec(lrow_s + c, lrow + g);
      } else {
#pragma unroll
        for (int u = 0; u < kVec; ++u) lrow[g + u] = T(0);
      }
    }
    // the row is scaled by 1 / L[row][row] beforehand, so that a step of the chain is
    // one shuffle and one multiply-add: z_r = acc_r / L[r][r], x_j = z_j at step j
    acc *= inv;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const T xj = __shfl_sync(kFull, acc, j);
      const T lj = lane > j ? lrow[j] * inv : T(0);   // beyond the diagonal: unused garbage
      acc = fma(-lj, xj, acc);
    }
    const T mine = acc;
    xs[row] = mine;
    __syncwarp();
  }

  // backward: L' x = y; lane r of row block t owns column 32 t + r of L
  for (int t = nblk - 1; t >= 0; --t) {
    const int c = 32 * t + lane;
    const bool valid = c < n;
    T acc = xs[c];
    T lcol[32];
    T inv = T(1);
    if (valid) {
      T part[kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u) part[u] = T(0);
#pragma unroll 4
      for (int i = 32 * (t + 1); i < n; i += kVec) {
        T xv[kVec];
        load_vec(xs + i, xv);
#pragma unroll
        for (int u = 0; u < kVec; ++u)
          if (i + u < n) part[u] = fma(l[(i + u) * ld + c], xv[u], part[u]);
      }
      T sum = part[0];
#pragma unroll
      for (int u = 1; u < kVec; ++u) sum += part[u];
      acc -= sum;
      inv = T(1) / l[c * ld + c];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j)
      lcol[j] = (valid && j > lane && 32 * t + j < n) ? l[(32 * t + j) * ld + c] : T(0);
    acc *= inv;
#pragma unroll
    for (int j = 31; j >= 0; --j) {
      const T xj = __shfl_sync(kFull, acc, j);
      acc = fma(-(lcol[j] * inv), xj, acc);
    }
    const T mine = acc;
    __syncwarp();
    xs[c] = mine;
    __syncwarp();
    if (valid) xb[static_cast<size_t>(c) * k] = mine;
  }
}

// ----------------------------------------------------------------------- column path
// rows i0 .. i0+3 of the forward substitution for one column (yc walks it, stride tile)
template <typename T, bool kFullBlock>
__device__ __forceinline__ void forward_rows(const T* __restrict__ l, const T* __restrict__ inv,
                                             T* yc, int tile, int ld, int i0, int nr) {
  constexpr int kVec = Vec<T>::n;
  T acc[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = (kFullBlock || r < nr) ? yc[(i0 + r) * tile] : T(0);
  for (int j0 = 0; j0 < i0; j0 += kVec) {
    T yv[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) yv[u] = yc[(j0 + u) * tile];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (kFullBlock || r < nr) {
        T lv[kVec];
        load_vec(l + (i0 + r) * ld + j0, lv);
#pragma unroll
        for (int u = 0; u < kVec; ++u) acc[r] = fma(-lv[u], yv[u], acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (kFullBlock || r < nr) {
#pragma unroll
      for (int q = 0; q < r; ++q) acc[r] = fma(-l[(i0 + r) * ld + i0 + q], acc[q], acc[r]);
      acc[r] *= inv[i0 + r];
      yc[(i0 + r) * tile] = acc[r];
    }
  }
}

// rows i0 .. i0+3 of the backward substitution; writes the solution to xc (stride k)
template <typename T, bool kFullBlock>
__device__ __forceinline__ void backward_rows(const T* __restrict__ l, const T* __restrict__ inv,
                                              T* yc, T* xc, int tile, int k, int ld, int n,
                                              int i0, int nr) {
  T acc[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = (kFullBlock || r < nr) ? yc[(i0 + r) * tile] : T(0);
  if (kFullBlock) {
#pragma unroll 4
    for (int j = i0 + 4; j < n; ++j) {
      const T xj = yc[j * tile];
      T lv[4];
      load4(l + j * ld + i0, lv);
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = fma(-lv[r], xj, acc[r]);
    }
  }
#pragma unroll
  for (int r = 3; r >= 0; --r) {
    if (kFullBlock || r < nr) {
#pragma unroll
      for (int q = r + 1; q < 4; ++q)
        if (kFullBlock || q < nr) acc[r] = fma(-l[(i0 + q) * ld + i0 + r], acc[q], acc[r]);
      acc[r] *= inv[i0 + r];
      yc[(i0 + r) * tile] = acc[r];
      xc[static_cast<size_t>(i0 + r) * k] = acc[r];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
cho_solve_col_kernel(const T* __restrict__ L, const T* __restrict__ b, T* __restrict__ x,
                     int n, int k, int ld, int aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = blockDim.x, tid = threadIdx.x;
  T* l = reinterpret_cast<T*>(smem_raw);
  T* y = l + n * ld;                        // (n, tile), column index fastest
  T* inv = y + n * tile;                    // reciprocals of the diagonal
  const size_t mat = blockIdx.x;
  const int col = blockIdx.y * tile + tid;
  const bool mine = col < k;
  const T* bc = b + mat * n * k + col;
  T* xc = x + mat * n * k + col;
  T* yc = y + tid;

  copy_lower_async(l, L + mat * n * n, n, ld, tid >> 5, (tile + 31) >> 5, tid & 31,
                   aligned != 0);
  if (mine)
    for (int i = 0; i < n; ++i) yc[i * tile] = bc[static_cast<size_t>(i) * k];
  cp_async_wait_all();
  __syncthreads();
  for (int i = tid; i < n; i += tile) inv[i] = T(1) / l[i * ld + i];
  __syncthreads();
  if (!mine) return;

  const int nfull = n & ~3, tail = n - nfull;
  for (int i0 = 0; i0 < nfull; i0 += 4) forward_rows<T, true>(l, inv, yc, tile, ld, i0, 4);
  if (tail) {
    forward_rows<T, false>(l, inv, yc, tile, ld, nfull, tail);
    backward_rows<T, false>(l, inv, yc, xc, tile, k, ld, n, nfull, tail);
  }
  for (int i0 = nfull - 4; i0 >= 0; i0 -= 4)
    backward_rows<T, true>(l, inv, yc, xc, tile, k, ld, n, i0, 4);
}

// path 0: warp path, `width` columns (warps that solve) per block of `threads` threads;
// path 1: column path with `width` = `threads` columns per block.  ld and smem follow dgsqp_torch.ops.linalg.cho_solve_plan;
// set_attr asks to raise the kernel's dynamic shared-memory limit to smem first.
template <typename T>
int launch(const void* L, const void* b, void* x, int batch, int n, int k, int path, int width,
           int threads, int ld, int smem, int set_attr, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (threads > kMaxThreads || (path == 0 ? threads < 32 * width : threads != width))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = path == 0 ? reinterpret_cast<const void*>(cho_solve_warp_kernel<T>)
                                 : reinterpret_cast<const void*>(cho_solve_col_kernel<T>);
  if (set_attr) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(batch, (k + width - 1) / width);
  const T* Lp = static_cast<const T*>(L);
  const T* bp = static_cast<const T*>(b);
  T* xp = static_cast<T*>(x);
  const int aligned = rows_aligned<T>(L, n) ? 1 : 0;
  if (path == 0) {
    cho_solve_warp_kernel<T><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        Lp, bp, xp, n, k, width, ld, aligned);
  } else {
    cho_solve_col_kernel<T><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        Lp, bp, xp, n, k, ld, aligned);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dgsqp_cho_solve_f32(const void* L, const void* b, void* x, int batch, int n,
                                   int k, int path, int width, int threads, int ld, int smem,
                                   int set_attr, int device, void* stream) {
  return launch<float>(L, b, x, batch, n, k, path, width, threads, ld, smem, set_attr, device,
                       stream);
}

extern "C" int dgsqp_cho_solve_f64(const void* L, const void* b, void* x, int batch, int n,
                                   int k, int path, int width, int threads, int ld, int smem,
                                   int set_attr, int device, void* stream) {
  return launch<double>(L, b, x, batch, n, k, path, width, threads, ld, smem, set_attr, device,
                       stream);
}
