// K8, the BlockELL apply, for NVIDIA Hopper (sm_90a).
//
// Plain C interface, built by nvcc into the same shared library as the
// other kernels and loaded with ctypes (raptor_tpu_torch/ops/cuda/build.py,
// bell_kernel.py).  The entry points launch on the stream they are given,
// allocate nothing, and return cudaGetLastError() (or cudaErrorInvalidValue
// for arguments they do not take) so the wrapper can raise.
//
// No TPU kernel: the JAX package's BlockELL applies
// (raptor_tpu/core/bell.py::bell_spmv, the block smoothers' Dblk^{-1} r) are
// plain jnp einsums.  On the card the same einsums cost a gather of x into
// (K, nb, b), a strided copy and a cuBLAS batched gemv on b x b problems, so
// every block was read once and x's gathered copy written and read twice.
//
// What it computes (core/bell.py):
//   general form:  y[n*b + i] = sum over slots k < row_nnz[n], in order,
//                  and then over j in order, of
//                  data[k, n, i, j] * x[cols[k, n]*b + j]
//   diagonal form: y[n*b + i] = sum over j in order of
//                  data[n, i, j] * x[n*b + j]  (z = Binv r; no index read)
// for each vector of a (batch, nb * b) x.  The general form takes
// contiguous blocks, so for b = 3 and 6 their strides are compile-time
// constants; the diagonal form reads its blocks at the element strides
// (sn, si, sj) it is given (torch.linalg.inv's block inverses are
// column-major within a block).
//
// Rounding: each product and each sum is rounded on its own
// (__fmul_rn / __fadd_rn, __dmul_rn / __dadd_rn), starting from 0, so nvcc
// cannot contract a pair into an FMA and the kernel agrees bit for bit with
// the slot-order plain version (ops/cuda/bell_kernel.py::bell_spmv_ref).
// bf16 blocks are widened to fp32 before the product, which is exact.
//
// Bound: device-memory bytes, each live block read once (b*b values), x in
// and y out.  Config 4's level 0 (505,600 block rows, 27 3x3 fp32 blocks in
// most) is 491 MB a general apply, 0.147 ms at 3.35 TB/s; its diagonal form
// 30 MB.  The column indices (4 B a block) add about a tenth at b = 3.  The
// arithmetic is far below the card's: 2 flops a value read.
//
// Design: one thread a scalar row, so block row n takes b neighbouring
// threads and thread (n, i) reads row i of each of its blocks: for a given
// slot a warp's loads cover neighbouring bytes of that slot's blocks.  The
// blocks are read once, with the evict-first hint (ld.global.cs), so that
// x (6 MB at level 0) stays in L2 while half a gigabyte of blocks streams
// past; x, the columns and row_nnz go through the read-only path.  For
// b = 3 and b = 6 (config 4's level 0 and its levels under six candidates)
// b is a template argument and UNROLL slots' columns, blocks and x values
// are loaded before their terms are summed, so each thread keeps UNROLL
// blocks in flight; any other b takes a runtime loop.  On a level of few
// scalar rows and long block rows (config 4's level 2: 676 block rows of
// up to 206 6x6 blocks) the card is nearly empty and each thread waits on
// its slots in turn; a block of threads a block row is faster there, but
// that level is two launches of a W-cycle and moved no solve time.
//
// Padded slots beyond row_nnz are not read; row_nnz is clamped
// to [0, K] and a column outside [0, nb) is clamped into it, so no argument
// reads outside its arrays.  The batch is the grid's second dimension (a
// block of threads loops over vectors beyond 65535).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;
constexpr int UNROLL = 4;  // slots loaded ahead of their sums (b = 3, 6)

// x and y are fp64 for fp64 blocks and fp32 for fp32 and bf16 blocks
template <typename T>
struct Vec {
  using type = float;
};
template <>
struct Vec<double> {
  using type = double;
};

__device__ __forceinline__ float load_block(const float* p) {
  return __ldcs(p);
}
__device__ __forceinline__ double load_block(const double* p) {
  return __ldcs(p);
}
__device__ __forceinline__ float load_block(const __nv_bfloat16* p) {
  // a bf16 value is the top half of the fp32 value it widens to
  const unsigned short bits =
      __ldcs(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// block row n's live slots: row_nnz[n] clamped to [0, K]
__device__ __forceinline__ int live_slots(const int* __restrict__ row_nnz,
                                          int n, int K) {
  const int m = __ldg(row_nnz + n);
  return m < 0 ? 0 : (m > K ? K : m);
}

// slot k's block column of block row n, clamped into [0, nb)
__device__ __forceinline__ int block_col(const int* __restrict__ cols,
                                         int64_t at, int nb) {
  const int c = __ldg(cols + at);
  return c < 0 ? 0 : (c >= nb ? nb - 1 : c);
}

// acc + sum over j of a[j * sj] * xc[j], in j order; BS = 0: runtime b
template <int BS, typename T, typename X>
__device__ __forceinline__ X block_row(X acc, const T* a, const X* xc, int b,
                                       int64_t sj) {
  if constexpr (BS > 0) {
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      acc = add_rn(acc, mul_rn(load_block(a + j * sj), __ldg(xc + j)));
    }
  } else {
    for (int j = 0; j < b; ++j) {
      acc = add_rn(acc, mul_rn(load_block(a + j * sj), __ldg(xc + j)));
    }
  }
  return acc;
}

// K8.  BS: the block size b, or 0 for a runtime b (bs).  DIAG:
// the diagonal form, whose blocks lie at strides (sn, si, sj); the general
// form's are contiguous.
template <int BS, bool DIAG, typename T>
__global__ void __launch_bounds__(THREADS)
    bell_rows_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                     const int* __restrict__ row_nnz,
                     const typename Vec<T>::type* __restrict__ x,
                     typename Vec<T>::type* __restrict__ y, int nb, int K,
                     int bs, int batch, int64_t sn, int64_t si, int64_t sj) {
  using X = typename Vec<T>::type;
  const int b = BS > 0 ? BS : bs;
  const int64_t rows = static_cast<int64_t>(nb) * b;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (r >= rows) return;
  const int n = static_cast<int>(r / b);
  const int i = static_cast<int>(r - static_cast<int64_t>(n) * b);
  if constexpr (!DIAG) {
    sn = static_cast<int64_t>(b) * b;
    si = b;
    sj = 1;
  }
  const int64_t sk = static_cast<int64_t>(nb) * b * b;
  const T* a = data + n * sn + i * si;
  const int nnz = DIAG ? 1 : live_slots(row_nnz, n, K);
  for (int v = blockIdx.y; v < batch; v += gridDim.y) {
    const X* xv = x + v * rows;
    X acc = 0;
    if constexpr (DIAG) {
      acc = block_row<BS>(acc, a, xv + static_cast<int64_t>(n) * b, b, sj);
    } else {
      int k = 0;
      if constexpr (BS > 0) {
        for (; k + UNROLL <= nnz; k += UNROLL) {
          int c[UNROLL];
          X av[UNROLL][BS], xw[UNROLL][BS];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            c[u] = block_col(cols, static_cast<int64_t>(k + u) * nb + n, nb);
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
            for (int j = 0; j < BS; ++j) {
              av[u][j] = load_block(a + (k + u) * sk + j);
            }
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
            for (int j = 0; j < BS; ++j) {
              xw[u][j] = __ldg(xv + static_cast<int64_t>(c[u]) * BS + j);
            }
          }
          // the sums in slot order, then j order
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
            for (int j = 0; j < BS; ++j) {
              acc = add_rn(acc, mul_rn(av[u][j], xw[u][j]));
            }
          }
        }
      }
      for (; k < nnz; ++k) {
        const int c = block_col(cols, static_cast<int64_t>(k) * nb + n, nb);
        acc = block_row<BS>(acc, a + k * sk, xv + static_cast<int64_t>(c) * b,
                            b, 1);
      }
    }
    y[v * rows + r] = acc;
  }
}

dim3 batch_grid(int64_t blocks, int batch) {
  return dim3(static_cast<unsigned>(blocks),
              static_cast<unsigned>(batch < MAX_GRID_Y ? batch : MAX_GRID_Y));
}

template <int BS, typename T>
cudaError_t launch_as(int form, const void* data, const void* cols,
                      const void* row_nnz, const void* x, void* y, int nb,
                      int K, int bs, int batch, int64_t sn, int64_t si,
                      int64_t sj, cudaStream_t stream) {
  using X = typename Vec<T>::type;
  const T* d = static_cast<const T*>(data);
  const int* c = static_cast<const int*>(cols);
  const int* m = static_cast<const int*>(row_nnz);
  const X* xp = static_cast<const X*>(x);
  X* yp = static_cast<X*>(y);
  const int64_t rows = static_cast<int64_t>(nb) * bs;
  const dim3 grid = batch_grid((rows + THREADS - 1) / THREADS, batch);
  if (form == 0) {
    bell_rows_kernel<BS, false, T><<<grid, THREADS, 0, stream>>>(
        d, c, m, xp, yp, nb, K, bs, batch, 0, 0, 0);
  } else {
    bell_rows_kernel<BS, true, T><<<grid, THREADS, 0, stream>>>(
        d, nullptr, nullptr, xp, yp, nb, 1, bs, batch, sn, si, sj);
  }
  return cudaGetLastError();
}

template <typename T>
int launch(int form, const void* data, const void* cols, const void* row_nnz,
           const void* x, void* y, int nb, int K, int bs, int batch,
           int64_t sn, int64_t si, int64_t sj, void* stream) {
  if (form < 0 || form > 1 || nb < 1 || bs < 1 || K < 1 || batch < 1 ||
      static_cast<int64_t>(nb) * bs >= (int64_t(1) << 31) ||
      (form == 0 && (cols == nullptr || row_nnz == nullptr)) || sn < 0 ||
      si < 0 || sj < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (bs) {
    case 3:
      e = launch_as<3, T>(form, data, cols, row_nnz, x, y, nb, K, bs, batch,
                          sn, si, sj, s);
      break;
    case 6:
      e = launch_as<6, T>(form, data, cols, row_nnz, x, y, nb, K, bs, batch,
                          sn, si, sj, s);
      break;
    default:
      e = launch_as<0, T>(form, data, cols, row_nnz, x, y, nb, K, bs, batch,
                          sn, si, sj, s);
  }
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// K8.  form 0: the general form; 1: the diagonal form.  data:
// the blocks, (K, nb, b, b) contiguous in the general form, (nb, b, b) at
// element strides (sn, si, sj) in the diagonal form; cols (K, nb) and
// row_nnz (nb,) int32, contiguous (null in the diagonal form); x and y
// contiguous (batch, nb * b), fp32 (fp64 for fp64 blocks).
int raptor_bell_f32(int form, const void* data, const void* cols,
                    const void* row_nnz, const void* x, void* y, int nb, int K,
                    int bs, int batch, int64_t sn, int64_t si, int64_t sj,
                    void* stream) {
  return launch<float>(form, data, cols, row_nnz, x, y, nb, K, bs, batch, sn,
                       si, sj, stream);
}

int raptor_bell_bf16(int form, const void* data, const void* cols,
                     const void* row_nnz, const void* x, void* y, int nb,
                     int K, int bs, int batch, int64_t sn, int64_t si,
                     int64_t sj, void* stream) {
  return launch<__nv_bfloat16>(form, data, cols, row_nnz, x, y, nb, K, bs,
                               batch, sn, si, sj, stream);
}

int raptor_bell_f64(int form, const void* data, const void* cols,
                    const void* row_nnz, const void* x, void* y, int nb, int K,
                    int bs, int batch, int64_t sn, int64_t si, int64_t sj,
                    void* stream) {
  return launch<double>(form, data, cols, row_nnz, x, y, nb, K, bs, batch, sn,
                        si, sj, stream);
}

}  // extern "C"
