// Error-free transformations (raptor_tpu_torch/utils/df64.py) for the df64
// residual kernels: K5 (banded_kernel.cu) and K7 (dia_df64_kernel.cu).
//
// Every product and sum is written with __fmul_rn / __fadd_rn / __fsub_rn,
// each step rounded on its own, so nvcc cannot contract a pair into an FMA
// (which would use the unrounded product and void Knuth's and Dekker's
// identities).  The functions then round exactly as their plain PyTorch
// versions, one rounded operation per torch op, in the same order.
//
// Everything here is a __device__ __forceinline__ function in an unnamed
// namespace, so each source that includes this header gets its own copy.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// bitmask split: hi keeps sign, exponent and the top 11 mantissa bits
__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  hi = __uint_as_float(__float_as_uint(a) & 0xFFFFF000u);
  lo = __fsub_rn(a, hi);
}

__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  float ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  e = __fadd_rn(__fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, bh), p),
                                    __fmul_rn(ah, bl)),
                          __fmul_rn(al, bh)),
                __fmul_rn(al, bl));
}

// two_prod with a already split into (ah, al), as split(a) gives them (a
// constant coefficient is split once, on the host).  The same operations
// as two_prod, which keeps its own text: written as split(a) and this
// function, it changed the code nvcc builds for K5.
__device__ __forceinline__ void two_prod_split(float a, float ah, float al,
                                               float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  float bh, bl;
  split(b, bh, bl);
  e = __fadd_rn(__fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, bh), p),
                                    __fmul_rn(ah, bl)),
                          __fmul_rn(al, bh)),
                __fmul_rn(al, bl));
}

__device__ __forceinline__ void df_add(float xh, float xl, float yh, float yl,
                                       float& rh, float& rl) {
  float sh, se;
  two_sum(xh, yh, sh, se);
  const float te = __fadd_rn(se, __fadd_rn(xl, yl));
  two_sum(sh, te, rh, rl);
}

}  // namespace
