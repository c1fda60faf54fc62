// DIA (offset-diagonal) SpMV kernels for NVIDIA Hopper (sm_90a).
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (raptor_tpu_torch/ops/cuda/build.py, dia_kernel.py).  Every entry
// point launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// K1 and K2 take x of shape (batch, n), contiguous; blockIdx.y is the
// batch row and a grid-stride loop over blockIdx.x covers the n rows.  K1's
// entry points also serve the K1v1 wrapper (zero-filled shifts of x, which
// is what K1 computes).  K3 takes one vector and its two halos.
//
// Rounding: each term is rounded as the plain PyTorch version rounds it
// (__fmul_rn, then __fadd_rn, in the reference's offset order), so nvcc
// cannot contract the pair into an FMA and the kernel agrees with the plain
// version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RAPTOR_MAX_OFF 32
#define RAPTOR_MAX_DIMS 4
#define RAPTOR_THREADS 256
#define RAPTOR_MAX_BLOCKS 8192

namespace {

struct LinOffsets {
  int n_off;
  int lin[RAPTOR_MAX_OFF];
};

struct ConstStencil {
  int n_off;
  int nd;
  int dims[RAPTOR_MAX_DIMS];
  int strides[RAPTOR_MAX_DIMS];
  int lin[RAPTOR_MAX_OFF];
  int off[RAPTOR_MAX_OFF][RAPTOR_MAX_DIMS];
  float c[RAPTOR_MAX_OFF];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------------------
// K1: streamed-plane DIA SpMV.
//
// Replaces raptor_tpu/ops/pallas/dia_kernel.py::_dia_pallas_call_v2.
//   y[b, i] = sum_k f32(data[k, i]) * x[b, i + lin_k]
// The planes are boundary-zeroed, so a term whose column leaves [0, n) is
// zero; the TPU kernel reads clamped neighbour blocks and lets the zero
// plane annihilate them, but an out-of-range read is undefined behaviour
// here, so the kernel tests 0 <= i + lin_k < n and reads nothing outside.
//
// Bound: device-memory bytes, about n_off * n * sizeof(T) for the planes
// plus 4n for x and 4n for y per batch row (level 1 of the 128^3 problem
// with bf16 planes: 15 * 1M * 2 B + 8 MB, about 40 MB a call).  Design: one
// thread per row, so plane reads are coalesced; the n_off shifted x reads
// are coalesced too and hit L1/L2 after the first offset.  Staging an x
// window in shared memory (cp.async / TMA) and several rows per thread are
// later work.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(RAPTOR_THREADS)
dia_planes_kernel(const T* __restrict__ data, const float* __restrict__ x,
                  float* __restrict__ y, int64_t n, LinOffsets offs) {
  const float* xb = x + static_cast<int64_t>(blockIdx.y) * n;
  float* yb = y + static_cast<int64_t>(blockIdx.y) * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float acc = 0.0f;
    for (int k = 0; k < offs.n_off; ++k) {
      const int64_t j = i + offs.lin[k];
      if (j >= 0 && j < n) {
        acc = __fadd_rn(acc, __fmul_rn(widen(data[k * n + i]), xb[j]));
      }
    }
    yb[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// K2: constant-coefficient DIA SpMV.
//
// Replaces raptor_tpu/ops/pallas/dia_kernel.py::_dia_pallas_call_const.
//   y[b, i] = sum_k c_k * [coord(i) + off_k inside dims] * x[b, i + lin_k]
// Plane k is c_k wherever the neighbour stays on the grid and 0 elsewhere,
// so the kernel builds it from the row's grid coordinates (division and
// modulo by the C-order strides, as the TPU kernel does from its iota) and
// reads only x.  An in-grid neighbour always has 0 <= i + lin_k < n.
//
// Bound: device-memory bytes, about 4n for x and 4n for y per batch row
// (16.8 MB at 128^3).  Design: one thread per row; the shifted x reads are
// coalesced and re-read from L1/L2 across offsets.  The grid coordinates
// cost one 32-bit division and modulo per dimension.
// ---------------------------------------------------------------------------
template <int ND>
__global__ void __launch_bounds__(RAPTOR_THREADS)
dia_const_kernel(const float* __restrict__ x, float* __restrict__ y,
                 int64_t n, ConstStencil st) {
  const float* xb = x + static_cast<int64_t>(blockIdx.y) * n;
  float* yb = y + static_cast<int64_t>(blockIdx.y) * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    // 32-bit division (n < 2^31): 64-bit division is emulated and slow;
    // ND is a template argument so the coordinates stay in registers
    const unsigned int ui = static_cast<unsigned int>(i);
    int coord[ND];
#pragma unroll
    for (int a = 0; a < ND; ++a) {
      coord[a] = static_cast<int>(
          (ui / static_cast<unsigned int>(st.strides[a])) %
          static_cast<unsigned int>(st.dims[a]));
    }
    float acc = 0.0f;
    for (int k = 0; k < st.n_off; ++k) {
      bool ok = true;
#pragma unroll
      for (int a = 0; a < ND; ++a) {
        const int c = coord[a] + st.off[k][a];
        ok = ok && c >= 0 && c < st.dims[a];
      }
      if (ok) {
        acc = __fadd_rn(acc, __fmul_rn(st.c[k], xb[i + st.lin[k]]));
      }
    }
    yb[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// K3: DIA SpMV over a halo-extended window (the plane-sharded SpMV).
//
// Replaces raptor_tpu/ops/pallas/dia_kernel.py::_dia_pallas_call_v2x.
//   y[i] = sum_k f32(data[k, i]) * xw(i + lin_k),  0 <= i < nl,
//   xw = [halo_left | x | halo_right], 0 beyond (no wraparound)
// The TPU wrapper concatenates [pad | halo_left | x | halo_right | pad] into
// a new x_ext on every call, one extra pass over x.  Here the three buffers
// stay apart: xw(j) reads x for 0 <= j < nl, halo_left[len_l + j] for
// -len_l <= j < 0, halo_right[j - nl] for nl <= j < nl + len_r, and a term
// whose column lies beyond all three is skipped (it is zero in the TPU
// kernel's padded window).  Rounding as K1, so the kernel agrees with its
// plain version bit for bit.
//
// Bound: device-memory bytes, n_off * nl * sizeof(T) for the planes plus
// 4 (nl + LP + RP) for the window and 4 nl for y (the 256^3 fine level on
// one rank: 7 fp32 planes of 16.8M rows plus x and y, about 0.6 GB a call).
// Design: one thread per row and a grid-stride loop, so plane and x reads
// are coalesced and the shifted x reads hit L1/L2 after the first offset;
// the halo branches are taken only by the rows within LP / RP of the shard's
// edges.  Staging the window in shared memory (cp.async / TMA) is later
// work.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(RAPTOR_THREADS)
dia_halo_kernel(const T* __restrict__ data, const float* __restrict__ x,
                const float* __restrict__ halo_left,
                const float* __restrict__ halo_right, float* __restrict__ y,
                int64_t nl, int64_t len_l, int64_t len_r, LinOffsets offs) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nl; i += stride) {
    float acc = 0.0f;
    for (int k = 0; k < offs.n_off; ++k) {
      const int64_t j = i + offs.lin[k];
      float v;
      if (j >= 0 && j < nl) {
        v = x[j];
      } else if (j < 0 && j >= -len_l) {
        v = halo_left[len_l + j];
      } else if (j >= nl && j - nl < len_r) {
        v = halo_right[j - nl];
      } else {
        continue;
      }
      acc = __fadd_rn(acc, __fmul_rn(widen(data[k * nl + i]), v));
    }
    y[i] = acc;
  }
}

dim3 grid_for(int64_t n, int batch) {
  int64_t blocks = (n + RAPTOR_THREADS - 1) / RAPTOR_THREADS;
  if (blocks > RAPTOR_MAX_BLOCKS) blocks = RAPTOR_MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  return dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
}

template <typename T>
int launch_planes(const void* data, const void* x, void* y, int64_t n,
                  int batch, const int* lins, int n_off, void* stream) {
  if (n_off < 0 || n_off > RAPTOR_MAX_OFF || batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LinOffsets offs;
  offs.n_off = n_off;
  for (int k = 0; k < n_off; ++k) offs.lin[k] = lins[k];
  dia_planes_kernel<T><<<grid_for(n, batch), RAPTOR_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const float*>(x),
      static_cast<float*>(y), n, offs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_halo(const void* data, const void* x, const void* halo_left,
                const void* halo_right, void* y, int64_t nl, int64_t len_l,
                int64_t len_r, const int* lins, int n_off, void* stream) {
  if (n_off < 0 || n_off > RAPTOR_MAX_OFF || nl < 1 || len_l < 0 ||
      len_r < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LinOffsets offs;
  offs.n_off = n_off;
  for (int k = 0; k < n_off; ++k) offs.lin[k] = lins[k];
  dia_halo_kernel<T><<<grid_for(nl, 1), RAPTOR_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const float*>(x),
      static_cast<const float*>(halo_left),
      static_cast<const float*>(halo_right), static_cast<float*>(y), nl, len_l,
      len_r, offs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int raptor_dia_planes_f32(const void* data, const void* x, void* y, int64_t n,
                          int batch, const int* lins, int n_off,
                          void* stream) {
  return launch_planes<float>(data, x, y, n, batch, lins, n_off, stream);
}

int raptor_dia_planes_bf16(const void* data, const void* x, void* y, int64_t n,
                           int batch, const int* lins, int n_off,
                           void* stream) {
  return launch_planes<__nv_bfloat16>(data, x, y, n, batch, lins, n_off,
                                      stream);
}

// K3: halo_left holds len_l values, halo_right len_r (either may be 0).
int raptor_dia_halo_f32(const void* data, const void* x, const void* halo_left,
                        const void* halo_right, void* y, int64_t nl,
                        int64_t len_l, int64_t len_r, const int* lins,
                        int n_off, void* stream) {
  return launch_halo<float>(data, x, halo_left, halo_right, y, nl, len_l,
                            len_r, lins, n_off, stream);
}

int raptor_dia_halo_bf16(const void* data, const void* x,
                         const void* halo_left, const void* halo_right,
                         void* y, int64_t nl, int64_t len_l, int64_t len_r,
                         const int* lins, int n_off, void* stream) {
  return launch_halo<__nv_bfloat16>(data, x, halo_left, halo_right, y, nl,
                                    len_l, len_r, lins, n_off, stream);
}

// offs: n_off * nd ints, row-major (offset k, dimension a).
int raptor_dia_const_f32(const void* x, void* y, int64_t n, int batch,
                         const int* dims, int nd, const int* offs,
                         const int* lins, const float* consts, int n_off,
                         void* stream) {
  if (n_off < 0 || n_off > RAPTOR_MAX_OFF || nd < 1 || nd > RAPTOR_MAX_DIMS ||
      batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ConstStencil st;
  st.n_off = n_off;
  st.nd = nd;
  int s = 1;
  for (int a = nd - 1; a >= 0; --a) {
    st.dims[a] = dims[a];
    st.strides[a] = s;
    s *= dims[a];
  }
  for (int k = 0; k < n_off; ++k) {
    st.lin[k] = lins[k];
    st.c[k] = consts[k];
    for (int a = 0; a < nd; ++a) st.off[k][a] = offs[k * nd + a];
  }
  const dim3 grid = grid_for(n, batch);
  cudaStream_t s_ = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  switch (nd) {
    case 1: dia_const_kernel<1><<<grid, RAPTOR_THREADS, 0, s_>>>(xp, yp, n, st); break;
    case 2: dia_const_kernel<2><<<grid, RAPTOR_THREADS, 0, s_>>>(xp, yp, n, st); break;
    case 3: dia_const_kernel<3><<<grid, RAPTOR_THREADS, 0, s_>>>(xp, yp, n, st); break;
    default: dia_const_kernel<4><<<grid, RAPTOR_THREADS, 0, s_>>>(xp, yp, n, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
