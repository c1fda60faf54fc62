// Banded paged-gather SpMV kernels for NVIDIA Hopper (sm_90a): K4 (square
// SpMV), K6 (rectangular transfer) and K5 (fused df64 residual).
//
// Plain C interface, built by nvcc into the same shared library as
// dia_kernel.cu and loaded with ctypes (raptor_tpu_torch/ops/cuda/build.py,
// banded_kernel.py).  Every entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() so the wrapper can
// raise on a refused launch.
//
// Layout (raptor_tpu_torch/ops/banded_plan.py): vals and pidx are
// (T, K, tile/128, 128), contiguous; entry (t, k, j) of row
// i = t*tile + j sits at ((t*K + k) * tile) + j, so a warp of consecutive
// rows reads 32 consecutive values and offsets of one slot (coalesced).
// pidx packs an entry's offset into the tile's x window as
// page*1024 + idx.  Each kernel visits only the live slots (those whose
// static page range is non-empty), in slot order, as the TPU kernels do.
//
// Rounding: every product and sum is written with __fmul_rn / __fadd_rn /
// __fsub_rn, so nvcc cannot contract a pair into an FMA.  The kernels then
// round exactly as their plain PyTorch versions (one rounded operation per
// torch op, slot by slot) and agree with them bit for bit; for K5 this is
// also what keeps the error-free transformations exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RAPTOR_BANDED_THREADS 256
#define RAPTOR_MAX_SLOTS 256
#define RAPTOR_PAGE 1024

namespace {

struct SlotList {
  int n;
  int k[RAPTOR_MAX_SLOTS];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// i / tile in 32 bits (the wrappers check n < 2^31): 64-bit division is
// emulated on the card
__device__ __forceinline__ int64_t tile_of(int64_t i, int tile) {
  return static_cast<unsigned>(i) / static_cast<unsigned>(tile);
}

// x[xi] for a square window index, 0 outside [0, n): the TPU reads zero
// padding there; here an out-of-range read would be undefined, so none
// is made.
__device__ __forceinline__ float window_x(const float* __restrict__ x,
                                          int64_t xi, int64_t n) {
  return (xi >= 0 && xi < n) ? x[xi] : 0.0f;
}

// ---------------------------------------------------------------------------
// K4: square banded SpMV.
//
// Replaces raptor_tpu/ops/pallas/banded_kernel.py::_banded_call.
//   y[i] = sum_{live k} vals[t,k,j] * x[t*tile - Wp + pidx[t,k,j]]
// with x read as 0 outside [0, n) (the TPU kernel's zero-padded x_pad; no
// padded copy of x is made here).
//
// Bound: device-memory bytes, K*n*(sizeof(vals) + 4) for the plan plus 8n
// for x and y (48^3 level 0: 7 slots, n = 110,592, about 7.1 MB a call;
// 96^3: 57 MB).  Design: one thread per output row, so the plan streams
// coalesced; the x window (Wp each side of the tile) is re-read through
// L1/L2 across slots.  Staging the window in shared memory (cp.async/TMA)
// is later work.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(RAPTOR_BANDED_THREADS)
banded_kernel(const T* __restrict__ vals, const int* __restrict__ pidx,
              const float* __restrict__ x, float* __restrict__ y, int64_t n,
              int K, int tile, int Wp, SlotList live) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t t = tile_of(i, tile);
  const int64_t j = i - t * tile;
  const int64_t row0 = t * K * tile + j;
  const int64_t xbase = t * tile - Wp;
  float acc = 0.0f;
  for (int s = 0; s < live.n; ++s) {
    const int64_t e = row0 + static_cast<int64_t>(live.k[s]) * tile;
    const float g = window_x(x, xbase + pidx[e], n);
    acc = __fadd_rn(acc, __fmul_rn(widen(vals[e]), g));
  }
  y[i] = acc;
}

// ---------------------------------------------------------------------------
// K6: rectangular banded transfer (P or R).
//
// Replaces raptor_tpu/ops/pallas/banded_kernel.py::_banded_call_rect.
// Window page p of tile t is clamp((t*n_cols)//(T*1024) - WpP + p, 0,
// n_cols/1024 - 1), exactly the TPU kernel's index map, with the clamp per
// page so the dummy targets of masked slots stay in range:
//   y[i] = sum_{live k} vals[t,k,j] * x[page(pidx >> 10) * 1024 + (pidx & 1023)]
//
// Bound: device-memory bytes, K*n*(sizeof(vals) + 4) + 4n + 4*n_cols
// (48^3 level 0 R: 8 slots over 55,296 rows reading 110,592 fine values).
// Design: as K4; the window base is one 64-bit division per thread.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(RAPTOR_BANDED_THREADS)
banded_rect_kernel(const T* __restrict__ vals, const int* __restrict__ pidx,
                   const float* __restrict__ x, float* __restrict__ y,
                   int64_t n, int K, int tile, int64_t n_cols, int WpP,
                   SlotList live) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t t = tile_of(i, tile);
  const int64_t j = i - t * tile;
  const int64_t n_tiles = n / tile;
  const int64_t row0 = t * K * tile + j;
  const int64_t base = (t * n_cols) / (n_tiles * RAPTOR_PAGE) - WpP;
  const int64_t last = n_cols / RAPTOR_PAGE - 1;
  float acc = 0.0f;
  for (int s = 0; s < live.n; ++s) {
    const int64_t e = row0 + static_cast<int64_t>(live.k[s]) * tile;
    const int p = pidx[e];
    int64_t page = base + (p >> 10);
    page = page < 0 ? 0 : (page > last ? last : page);
    const float g = x[page * RAPTOR_PAGE + (p & (RAPTOR_PAGE - 1))];
    acc = __fadd_rn(acc, __fmul_rn(widen(vals[e]), g));
  }
  y[i] = acc;
}

// ---------------------------------------------------------------------------
// Error-free transformations (raptor_tpu_torch/utils/df64.py), each step
// rounded on its own.
// ---------------------------------------------------------------------------
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

__device__ __forceinline__ void df_add(float xh, float xl, float yh, float yl,
                                       float& rh, float& rl) {
  float sh, se;
  two_sum(xh, yh, sh, se);
  const float te = __fadd_rn(se, __fadd_rn(xl, yl));
  two_sum(sh, te, rh, rl);
}

// ---------------------------------------------------------------------------
// K5: fused df64 residual on the square banded layout.
//
// Replaces raptor_tpu/ops/pallas/banded_kernel.py::_banded_df64_resid_call.
//   (rh, rl) = df64[(bh, bl) - v - A @ xh]
// per row: (sh, se) = df_add(bh, bl, -v, 0); then for each live slot in
// order (ph, pe) = two_prod(vals, gh), pe += vals_lo * gh when vals_lo is
// given (the operator's fp32 truncation remainder), and
// (sh, se) = df_add(sh, se, -ph, -pe).
//
// Bound: device-memory bytes, K*n*(4 + 4 [+ 4 with vals_lo]) + 24n (xh,
// bh, bl, v in; rh, rl out); about 40 flops per entry, far under the
// card's fp32 rate.  Design: K4's gather; each row's compensated sum stays
// in registers.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(RAPTOR_BANDED_THREADS)
banded_df64_kernel(const float* __restrict__ vals,
                   const float* __restrict__ vals_lo,
                   const int* __restrict__ pidx, const float* __restrict__ xh,
                   const float* __restrict__ bh, const float* __restrict__ bl,
                   const float* __restrict__ v, float* __restrict__ rh,
                   float* __restrict__ rl, int64_t n, int K, int tile, int Wp,
                   SlotList live) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t t = tile_of(i, tile);
  const int64_t j = i - t * tile;
  const int64_t row0 = t * K * tile + j;
  const int64_t xbase = t * tile - Wp;
  float sh, se;
  df_add(bh[i], bl[i], -v[i], 0.0f, sh, se);
  for (int s = 0; s < live.n; ++s) {
    const int64_t e = row0 + static_cast<int64_t>(live.k[s]) * tile;
    const float gh = window_x(xh, xbase + pidx[e], n);
    float ph, pe;
    two_prod(vals[e], gh, ph, pe);
    if (vals_lo != nullptr) pe = __fadd_rn(pe, __fmul_rn(vals_lo[e], gh));
    df_add(sh, se, -ph, -pe, sh, se);
  }
  rh[i] = sh;
  rl[i] = se;
}

bool fill_slots(SlotList& live, const int* slots, int n_live, int K) {
  if (n_live < 0 || n_live > RAPTOR_MAX_SLOTS) return false;
  live.n = n_live;
  for (int s = 0; s < n_live; ++s) {
    if (slots[s] < 0 || slots[s] >= K) return false;
    live.k[s] = slots[s];
  }
  return true;
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + RAPTOR_BANDED_THREADS - 1) /
                               RAPTOR_BANDED_THREADS);
}

template <typename T>
int launch_banded(const void* vals, const void* pidx, const void* x, void* y,
                  int64_t n, int K, int tile, int Wp, const int* slots,
                  int n_live, void* stream) {
  SlotList live;
  if (n < 1 || K < 1 || tile < 1 || n % tile != 0 ||
      !fill_slots(live, slots, n_live, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  banded_kernel<T><<<blocks_for(n), RAPTOR_BANDED_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int*>(pidx),
      static_cast<const float*>(x), static_cast<float*>(y), n, K, tile, Wp,
      live);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rect(const void* vals, const void* pidx, const void* x, void* y,
                int64_t n, int K, int tile, int64_t n_cols, int WpP,
                const int* slots, int n_live, void* stream) {
  SlotList live;
  if (n < 1 || K < 1 || tile < 1 || n % tile != 0 || n_cols < RAPTOR_PAGE ||
      n_cols % RAPTOR_PAGE != 0 || !fill_slots(live, slots, n_live, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  banded_rect_kernel<T><<<blocks_for(n), RAPTOR_BANDED_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int*>(pidx),
      static_cast<const float*>(x), static_cast<float*>(y), n, K, tile,
      n_cols, WpP, live);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int raptor_banded_f32(const void* vals, const void* pidx, const void* x,
                      void* y, int64_t n, int K, int tile, int Wp,
                      const int* slots, int n_live, void* stream) {
  return launch_banded<float>(vals, pidx, x, y, n, K, tile, Wp, slots, n_live,
                              stream);
}

int raptor_banded_bf16(const void* vals, const void* pidx, const void* x,
                       void* y, int64_t n, int K, int tile, int Wp,
                       const int* slots, int n_live, void* stream) {
  return launch_banded<__nv_bfloat16>(vals, pidx, x, y, n, K, tile, Wp, slots,
                                      n_live, stream);
}

int raptor_banded_rect_f32(const void* vals, const void* pidx, const void* x,
                           void* y, int64_t n, int K, int tile, int64_t n_cols,
                           int WpP, const int* slots, int n_live,
                           void* stream) {
  return launch_rect<float>(vals, pidx, x, y, n, K, tile, n_cols, WpP, slots,
                            n_live, stream);
}

int raptor_banded_rect_bf16(const void* vals, const void* pidx, const void* x,
                            void* y, int64_t n, int K, int tile,
                            int64_t n_cols, int WpP, const int* slots,
                            int n_live, void* stream) {
  return launch_rect<__nv_bfloat16>(vals, pidx, x, y, n, K, tile, n_cols, WpP,
                                    slots, n_live, stream);
}

// vals_lo may be null (no truncation remainder).
int raptor_banded_df64_f32(const void* vals, const void* vals_lo,
                           const void* pidx, const void* xh, const void* bh,
                           const void* bl, const void* v, void* rh, void* rl,
                           int64_t n, int K, int tile, int Wp,
                           const int* slots, int n_live, void* stream) {
  SlotList live;
  if (n < 1 || K < 1 || tile < 1 || n % tile != 0 ||
      !fill_slots(live, slots, n_live, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  banded_df64_kernel<<<blocks_for(n), RAPTOR_BANDED_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const float*>(vals_lo),
      static_cast<const int*>(pidx), static_cast<const float*>(xh),
      static_cast<const float*>(bh), static_cast<const float*>(bl),
      static_cast<const float*>(v), static_cast<float*>(rh),
      static_cast<float*>(rl), n, K, tile, Wp, live);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
