// Loads and asynchronous copies shared by the DIA and the banded kernels
// (NVIDIA Hopper, sm_90a): read-once 16-, 8-, 4- and 2-byte global loads, cp.async
// global -> shared copies with commit groups, and the staging of one zero-
// filled window of a vector into shared memory.
//
// Everything here is a __device__ __forceinline__ function in an unnamed
// namespace, so each source that includes this header gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// one 16-byte load of data that is read once: not kept in L1, and fetched
// into L2 in 256-byte pieces (the neighbouring threads' rows)
__device__ __forceinline__ uint4 ld_plane(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// the same for 8 bytes (four bf16 values)
__device__ __forceinline__ uint2 ld_plane8(const void* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v2.u32 {%0, %1}, [%2];\n"
      : "=r"(v.x), "=r"(v.y)
      : "l"(p));
  return v;
}

// one 4-byte and one 2-byte read-once load (a warp's 32 consecutive
// elements: coalesced)
__device__ __forceinline__ unsigned ld_once(const void* p) {
  unsigned v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned ld_once16(const void* p) {
  unsigned short v;
  asm("ld.global.nc.L1::no_allocate.u16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return v;
}

// ---------------------------------------------------------------------------
// asynchronous global -> shared copies (cp.async, commit groups)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// 4 bytes from src, or 4 zero bytes when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// element misalignment of a float pointer against 16 bytes
__device__ __forceinline__ int misalign4(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Stage the elements [a0, a0 + 4 * chunks) of the vector x of n floats into
// dst (16-byte aligned shared memory), 0 where the window leaves [0, n).
// x + a0 must lie on a 16-byte boundary (a0 may be negative).  A chunk of
// four inside x is one 16-byte copy, a chunk wholly outside a store of
// zeros, a chunk across an end of x four 4-byte copies, zero-filled outside.
// The copies are asynchronous: the caller commits, waits and synchronises
// the block before it reads dst.
__device__ __forceinline__ void stage_window(float* dst, const float* x,
                                             int64_t n, int64_t a0,
                                             int chunks) {
  const int64_t lo = a0 >= 0 ? 0 : (-a0 + 3) >> 2;
  const int64_t hi = (n - a0) >> 2;
  const int c_lo = static_cast<int>(lo < chunks ? lo : chunks);
  const int c_hi =
      static_cast<int>(hi < c_lo ? c_lo : hi < chunks ? hi : chunks);
  for (int c = c_lo + threadIdx.x; c < c_hi; c += blockDim.x) {
    cp_async16(dst + 4 * c, x + (a0 + 4 * c));
  }
  const int n_edge = c_lo + (chunks - c_hi);
  for (int i = threadIdx.x; i < n_edge; i += blockDim.x) {
    const int c = i < c_lo ? i : c_hi + (i - c_lo);
    const int64_t g = a0 + 4 * c;
    if (g + 4 <= 0 || g >= n) {
      *reinterpret_cast<float4*>(dst + 4 * c) = make_float4(0, 0, 0, 0);
      continue;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t j = g + e;
      const bool ok = j >= 0 && j < n;
      cp_async4(dst + 4 * c + e, ok ? x + j : x, ok);
    }
  }
}

}  // namespace
