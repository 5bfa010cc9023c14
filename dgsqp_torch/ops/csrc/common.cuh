// Pieces shared by chol.cu and cho_solve.cu: 16-byte vector access to shared memory and
// the asynchronous copy of a matrix's lower triangle from device to shared memory.
//
// Shared-memory layout of a matrix: row-major with row stride ld, where ld is the
// smallest multiple of 4 not below n whose count of 16-byte chunks, ld / kVec, is odd
// (dgsqp_torch.ops.linalg.row_stride computes the same number).  With that stride
//  * 32 lanes that each read a 16-byte chunk of their own row (a row walk, one row per
//    lane) fall into distinct banks within every quarter-warp, since the rows' offsets
//    are odd multiples of 16 bytes apart;
//  * 32 lanes that read consecutive elements of one row (a column walk of L', one
//    column per lane) are conflict-free as always;
// so both the forward and the backward substitution are free of bank conflicts.

#pragma once
#include <cuda_runtime.h>
#include <cstdint>

namespace dgsqp {

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };

__device__ __forceinline__ void unpack(const float4& v, float* out) {
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void unpack(const double2& v, double* out) {
  out[0] = v.x; out[1] = v.y;
}
__device__ __forceinline__ float4 pack(const float* in) {
  return make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ double2 pack(const double* in) { return make_double2(in[0], in[1]); }

// one 16-byte chunk (kVec elements) from / to a 16-byte aligned address
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, T* out) {
  unpack(*reinterpret_cast<const typename Vec<T>::type*>(p), out);
}
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const T* in) {
  *reinterpret_cast<typename Vec<T>::type*>(p) = pack(in);
}
// four consecutive elements from / to an address aligned to four elements
template <typename T>
__device__ __forceinline__ void load4(const T* p, T* out) {
#pragma unroll
  for (int c = 0; c < 4; c += Vec<T>::n) load_vec(p + c, out + c);
}
template <typename T>
__device__ __forceinline__ void store4(T* p, const T* in) {
#pragma unroll
  for (int c = 0; c < 4; c += Vec<T>::n) store_vec(p + c, in + c);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(kBytes)
                 : "memory");
  }
}
// commit this thread's copies and wait until they have all arrived; a barrier must
// follow before other threads read what was copied
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copy of the lower triangle of the n x n row-major matrix g into s (row
// stride ld): warp `warp` of `nwarps` takes rows warp, warp + nwarps, ..., its lanes the
// row's chunks.  `aligned` (every row of g starts on a
// 16-byte boundary) copies 16 bytes per lane, so up to kVec - 1 elements beyond the
// diagonal come along and are never used; otherwise one element per lane.  No index is
// divided, and nothing above the diagonal's chunk is touched.
template <typename T>
__device__ __forceinline__ void copy_lower_async(T* s, const T* __restrict__ g, int n, int ld,
                                                 int warp, int nwarps, int lane, bool aligned) {
  constexpr int kVec = Vec<T>::n;
  for (int i = warp; i < n; i += nwarps) {
    const T* grow = g + static_cast<size_t>(i) * n;
    T* srow = s + i * ld;
    if (aligned) {
      const int chunks = i / kVec + 1;
      for (int c = lane; c < chunks; c += 32) cp_async<16>(srow + c * kVec, grow + c * kVec);
    } else {
      for (int c = lane; c <= i; c += 32) cp_async<sizeof(T)>(srow + c, grow + c);
    }
  }
}

template <typename T>
__host__ inline bool rows_aligned(const void* p, int n) {
  return n % Vec<T>::n == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launch on `device`, leaving the calling thread's current device as it was.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    int cur = -1;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      if (err == cudaSuccess) prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace dgsqp
