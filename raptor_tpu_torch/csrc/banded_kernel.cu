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

#include "hopper_copy.cuh"

#define RAPTOR_BANDED_THREADS 256
#define RAPTOR_MAX_SLOTS 256
#define RAPTOR_PAGE 1024
// K4: the slot count its live mask covers, rows per thread, the most live
// slots the loop-free kernels take, slots per chunk of the looping kernel
#define RAPTOR_MAX_K 1024
#define RAPTOR_K4_ROWS 4
#define RAPTOR_K4_SINGLE_MAX 8
#define RAPTOR_K4_LOOP_CHUNK 4
// shared memory a block may take on Hopper (227 KB); K4's window may take
// what its slot list (static) leaves
#define RAPTOR_SMEM_MAX 232448
#define RAPTOR_K4_WINDOW_MAX (RAPTOR_SMEM_MAX - 2 * RAPTOR_MAX_SLOTS)
#define RAPTOR_MAX_DEVICES 64

namespace {

struct SlotList {
  int n;
  int k[RAPTOR_MAX_SLOTS];
};

// K4's live slots: bit k of word k / 32 is set when slot k is live
struct LiveMask {
  unsigned w[RAPTOR_MAX_K / 32];
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
// Device functions of the banded gather, written for K4 and taken as they
// are by any kernel over the same layout.
// ---------------------------------------------------------------------------

// The live slots in slot order, from the mask into shared memory: slot k's
// place is the number of live slots below it.  The caller synchronises the
// block before it reads ``slots``.
__device__ __forceinline__ void live_slot_list(const LiveMask& live, int K,
                                               unsigned short* slots) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const unsigned word = live.w[k >> 5];
    if ((word >> (k & 31)) & 1u) {
      int rank = __popc(word & ((1u << (k & 31)) - 1u));
      for (int w = 0; w < (k >> 5); ++w) rank += __popc(live.w[w]);
      slots[rank] = static_cast<unsigned short>(k);
    }
  }
}

// the four rows' values and window offsets of one slot, as loaded
template <typename T>
struct SlotRegs;
template <>
struct SlotRegs<float> {
  uint4 p, v;
};
template <>
struct SlotRegs<__nv_bfloat16> {
  uint4 p;
  uint2 v;
};

// one 16-byte load of four rows' pidx and one 16- or 8-byte load of their
// values; e is the element index of the first row in this slot
__device__ __forceinline__ void load_slot(SlotRegs<float>& r,
                                          const float* vals, const int* pidx,
                                          int64_t e) {
  r.p = ld_plane(pidx + e);
  r.v = ld_plane(vals + e);
}
__device__ __forceinline__ void load_slot(SlotRegs<__nv_bfloat16>& r,
                                          const __nv_bfloat16* vals,
                                          const int* pidx, int64_t e) {
  r.p = ld_plane(pidx + e);
  r.v = ld_plane8(vals + e);
}

__device__ __forceinline__ void slot_values(const SlotRegs<float>& r,
                                            float (&out)[4]) {
  out[0] = __uint_as_float(r.v.x);
  out[1] = __uint_as_float(r.v.y);
  out[2] = __uint_as_float(r.v.z);
  out[3] = __uint_as_float(r.v.w);
}
__device__ __forceinline__ void slot_values(const SlotRegs<__nv_bfloat16>& r,
                                            float (&out)[4]) {
  out[0] = __uint_as_float(r.v.x << 16);
  out[1] = __uint_as_float(r.v.x & 0xffff0000u);
  out[2] = __uint_as_float(r.v.y << 16);
  out[3] = __uint_as_float(r.v.y & 0xffff0000u);
}

// x at window offset p.  Staged: ``win`` holds the window from offset
// ``wbase`` on, zeros where it leaves [0, x_len), so the read has no test.
// Direct: x[xbase + p] from device memory; the load is unconditional, on an
// index clamped into [0, x_len), and a select gives 0 outside.
template <bool STAGED>
__device__ __forceinline__ float gather_x(const float* __restrict__ x,
                                          const float* win, int wbase,
                                          int xbase, int x_len, unsigned p) {
  if constexpr (STAGED) {
    return win[static_cast<int>(p) - wbase];
  } else {
    const int xi = xbase + static_cast<int>(p);
    const bool ok = static_cast<unsigned>(xi) < static_cast<unsigned>(x_len);
    const float g = __ldg(x + (ok ? xi : 0));
    return ok ? g : 0.0f;
  }
}

// The sum over the live slots for four consecutive rows, in slot order,
// in chunks of CH slots: a chunk's gathers are issued together once its
// offsets have arrived, the next chunk's plan loads right behind them, and
// only then the chunk's products and sums.  ``cur`` holds the first
// chunk's plan loads (issued by the caller before it waits for the
// window); base is the element index of the rows in slot 0.  SINGLE: at
// most CH live slots, so one chunk and no loop.
template <typename T, bool STAGED, int CH, bool SINGLE>
__device__ __forceinline__ void banded_rows(
    const T* __restrict__ vals, const int* __restrict__ pidx,
    const float* __restrict__ x, const float* win, int wbase, int xbase,
    int x_len, int64_t base, int tile, const unsigned short* slots, int n_live,
    SlotRegs<T> (&cur)[CH], float (&acc)[RAPTOR_K4_ROWS]) {
  for (int s0 = 0;; s0 += CH) {
    float g[CH][4], v[CH][4];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (s0 + c < n_live) {
        g[c][0] = gather_x<STAGED>(x, win, wbase, xbase, x_len, cur[c].p.x);
        g[c][1] = gather_x<STAGED>(x, win, wbase, xbase, x_len, cur[c].p.y);
        g[c][2] = gather_x<STAGED>(x, win, wbase, xbase, x_len, cur[c].p.z);
        g[c][3] = gather_x<STAGED>(x, win, wbase, xbase, x_len, cur[c].p.w);
      }
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (s0 + c < n_live) slot_values(cur[c], v[c]);
    }
    if constexpr (!SINGLE) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (s0 + CH + c < n_live) {
          load_slot(cur[c], vals, pidx,
                    base + static_cast<int64_t>(slots[s0 + CH + c]) * tile);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (s0 + c < n_live) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r] = __fadd_rn(acc[r], __fmul_rn(v[c][r], g[c][r]));
        }
      }
    }
    if (SINGLE || s0 + CH >= n_live) break;
  }
}

// ---------------------------------------------------------------------------
// K4: square banded SpMV.
//
// Replaces raptor_tpu/ops/pallas/banded_kernel.py::_banded_call.
//   y[i] = sum_{live k} vals[t,k,j] * x[x_off + t*tile - Wp + pidx[t,k,j]]
// with x read as 0 outside [0, x_len).  Two forms:
//   * zero pad (x_off 0, x_len n): x is the vector itself, and the TPU
//     kernel's zero-padded x_pad is never built;
//   * halo (x_off h = kh*tile, x_len n + 2h): x is a rank's buffer
//     [left halo | x_own | right halo], the x_pad of the sharded caller
//     raptor_tpu/parallel/dist.py::dist_banded_spmv.  Every window read then
//     lies inside the buffer (h >= Wp), so the bound never binds.
// The TPU kernel selects the window's pages one by one (its only dynamic
// gather covers one vector register); none of that is carried over.
//
// Bound: device-memory bytes, K*n*(sizeof(vals) + 4) for the plan plus 8n
// for x and y (48^3 level 0: 7 slots, n = 110,592, about 7.1 MB a call;
// 96^3: 57 MB).  The coarse levels are bound by latency instead: a level
// of 7 tiles and 32 slots moves 2 MB.
//
// Design.  The one-row-per-thread kernel this replaces loaded pidx and only
// then x, slot after slot in a loop of runtime length: two round trips per
// slot in series, 64 of them on a 32-slot level.  Here:
//   * a thread owns four consecutive rows of a tile, so each slot costs it
//     one 16-byte load of pidx and one 16-byte (bf16: 8-byte) load of vals,
//     through the read-once path;
//   * the slots run in unrolled chunks (banded_rows): a chunk's plan
//     loads, then its gathers (four a slot), are in flight together, and
//     the next chunk's plan loads are issued before this chunk's sums.  Up
//     to eight live slots there is no loop at all (SINGLE, one chunk of 4
//     or 8); more run in chunks of 4 at two blocks an SM, which measured
//     faster than chunks of 8 at one (96^3 level 1: 27.1 against 31.7 us);
//   * x comes either straight from device memory (direct: an unconditional
//     load on a clamped index and a select, no branch) or from a window in
//     shared memory (staged): the pages [page0, page0 + pages) of the
//     tile's window that the live slots' ranges touch, copied once per
//     block by 16-byte cp.async with zeros outside [0, x_len); pidx is then a
//     shared-memory index.  The first chunk's plan loads are issued before
//     the block waits for the window.  The host picks per plan
//     (ops/cuda/banded_kernel.py::banded_launch_plan): staged where a
//     staged value is read often enough (every shape of the 48^3 and 96^3
//     paths: a thread's four rows spread a warp's direct gather over 128
//     rows, four times the L1 sectors of a row per thread), direct for wide
//     windows with few slots, and 128 threads a block on a level of fewer
//     tiles than SMs (a block then covers half a tile);
//   * the live slots travel as a bit mask (128 bytes) and become a list in
//     shared memory, not a 1 KB array by value.
// Alignment: the staged copy starts at the 16-byte boundary of x at or
// below the window's start and the reads add the remainder back, so x may
// be any float view; vals and pidx must be 16-byte aligned (the wrapper
// checks); y takes a 16-byte store where its address allows.
// ---------------------------------------------------------------------------
template <typename T, bool STAGED, int CH, bool SINGLE>
__global__ void __launch_bounds__(RAPTOR_BANDED_THREADS, SINGLE ? 1 : 2)
banded_kernel(const T* __restrict__ vals, const int* __restrict__ pidx,
              const float* __restrict__ x, float* __restrict__ y, int K,
              int tile, int Wp, int x_off, int x_len, int page0, int pages,
              int n_live, const __grid_constant__ LiveMask live) {
  constexpr int R = RAPTOR_K4_ROWS;
  __shared__ unsigned short slots[RAPTOR_MAX_SLOTS];
  extern __shared__ float4 win4[];
  float* win = reinterpret_cast<float*>(win4);

  const int row0 = blockIdx.x * (blockDim.x * R);
  const int t = static_cast<int>(static_cast<unsigned>(row0) /
                                 static_cast<unsigned>(tile));
  const int j = row0 - t * tile + threadIdx.x * R;
  const int xbase = x_off + t * tile - Wp;
  int wbase = 0;
  if constexpr (STAGED) {
    // the window's first staged element, rounded down to 16 bytes of x
    const int64_t j0 = static_cast<int64_t>(xbase) + page0 * RAPTOR_PAGE;
    const int rem = static_cast<int>((misalign4(x) + j0) & 3);
    stage_window(win, x, x_len, j0 - rem, pages * (RAPTOR_PAGE / 4) + 1);
    cp_async_commit();
    wbase = page0 * RAPTOR_PAGE - rem;
  }
  live_slot_list(live, K, slots);
  __syncthreads();

  const int64_t base = static_cast<int64_t>(t) * K * tile + j;
  SlotRegs<T> cur[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (c < n_live) {
      load_slot(cur[c], vals, pidx,
                base + static_cast<int64_t>(slots[c]) * tile);
    }
  }
  if constexpr (STAGED) {
    cp_async_wait<0>();
    __syncthreads();
  }
  float acc[R] = {0.0f, 0.0f, 0.0f, 0.0f};
  banded_rows<T, STAGED, CH, SINGLE>(vals, pidx, x, win, wbase, xbase, x_len,
                                     base, tile, slots, n_live, cur, acc);
  float* yr = y + row0 + threadIdx.x * R;
  if ((reinterpret_cast<uintptr_t>(yr) & 15) == 0) {
    *reinterpret_cast<float4*>(yr) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) yr[r] = acc[r];
  }
}

// ---------------------------------------------------------------------------
// K6: rectangular banded transfer (P or R).
//
// Replaces raptor_tpu/ops/pallas/banded_kernel.py::_banded_call_rect.
// Window page p of tile t is clamp((t*map_cols)//(T*1024) - WpP + p, 0,
// x_len/1024 - 1), exactly the TPU kernel's index map, with the clamp per
// page so the dummy targets of masked slots stay in range:
//   y[i] = sum_{live k} vals[t,k,j] * x[page(pidx >> 10) * 1024 + (pidx & 1023)]
// Two forms: n_cols (map_cols = x_len = the column count) and map_cols, the
// sharded caller's (raptor_tpu/parallel/dist.py::dist_rect_banded_spmv):
// x is a rank's halo-extended buffer of x_len elements, map_cols its own
// column count, and WpP, folded into the buffer's left halo, is 0.
//
// Bound: device-memory bytes, K*n*(sizeof(vals) + 4) + 4n + 4*n_cols
// (48^3 level 0 R: 8 slots over 55,296 rows reading 110,592 fine values).
// Design: as K4; the window base is one 64-bit division per thread.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(RAPTOR_BANDED_THREADS)
banded_rect_kernel(const T* __restrict__ vals, const int* __restrict__ pidx,
                   const float* __restrict__ x, float* __restrict__ y,
                   int64_t n, int K, int tile, int64_t x_len,
                   int64_t map_cols, int WpP, SlotList live) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t t = tile_of(i, tile);
  const int64_t j = i - t * tile;
  const int64_t n_tiles = n / tile;
  const int64_t row0 = t * K * tile + j;
  const int64_t base = (t * map_cols) / (n_tiles * RAPTOR_PAGE) - WpP;
  const int64_t last = x_len / RAPTOR_PAGE - 1;
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

// Check K4's live mask: n_live bits set, none at or above K.
bool check_mask(const LiveMask& live, int n_live, int K) {
  int bits = 0;
  for (int w = 0; w < RAPTOR_MAX_K / 32; ++w) {
    const int lo = w * 32;
    if (lo + 32 > K && live.w[w] >> (lo >= K ? 0 : K - lo) != 0) return false;
    bits += __builtin_popcount(live.w[w]);
  }
  return bits == n_live;
}

template <typename T, bool STAGED, int CH, bool SINGLE>
cudaError_t launch_banded_as(const T* vals, const int* pidx, const float* x,
                             float* y, int n, int K, int tile, int Wp,
                             int x_off, int x_len, int page0, int pages,
                             int n_live, const LiveMask& live, int threads,
                             int smem, cudaStream_t stream) {
  auto kern = banded_kernel<T, STAGED, CH, SINGLE>;
  if constexpr (STAGED) {
    // above 48 KB a block's shared memory must be allowed first: once per
    // kernel and device, before any launch (so never inside a graph capture
    // that the first, eager call did not precede)
    static bool smem_allowed[RAPTOR_MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= RAPTOR_MAX_DEVICES) return cudaErrorInvalidDevice;
    if (!smem_allowed[dev]) {
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               RAPTOR_K4_WINDOW_MAX);
      if (e != cudaSuccess) return e;
      smem_allowed[dev] = true;
    }
  }
  const unsigned blocks = static_cast<unsigned>(n / (threads * RAPTOR_K4_ROWS));
  kern<<<blocks, threads, smem, stream>>>(vals, pidx, x, y, K, tile, Wp, x_off,
                                          x_len, page0, pages, n_live, live);
  return cudaGetLastError();
}

// K4's launch, from the wrapper's plan (banded_launch_plan): ``mask`` holds
// RAPTOR_MAX_K / 32 words; ``threads`` per block, each of four rows;
// ``staged`` with the window's pages [page0, page0 + pages), which must fit
// a block's shared memory (nothing is truncated: what does not fit is
// refused).  x holds x_len floats, row 0's x at x_off (the zero-pad form:
// 0 and n; the halo form: kh*tile and n + 2*kh*tile).
template <typename T>
int launch_banded(const void* vals, const void* pidx, const void* x, void* y,
                  int64_t n, int K, int tile, int Wp, int64_t x_off,
                  int64_t x_len, const unsigned* mask, int n_live, int staged,
                  int threads, int page0, int pages, void* stream) {
  if (n < 1 || n >= (int64_t(1) << 31) || K < 1 || K > RAPTOR_MAX_K ||
      tile < RAPTOR_PAGE || tile % RAPTOR_PAGE != 0 || n % tile != 0 ||
      Wp < 0 || x_off < 0 || x_len < 1 || x_off + n > x_len ||
      x_len + RAPTOR_PAGE + Wp >= (int64_t(1) << 31) || n_live < 0 ||
      n_live > RAPTOR_MAX_SLOTS || threads < 32 ||
      threads > RAPTOR_BANDED_THREADS || (threads & (threads - 1)) != 0 ||
      ((reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(pidx)) &
       15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LiveMask live;
  for (int w = 0; w < RAPTOR_MAX_K / 32; ++w) live.w[w] = mask[w];
  if (!check_mask(live, n_live, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int smem = 0;
  if (staged) {
    const int64_t window = static_cast<int64_t>(tile) + 2 * int64_t(Wp);
    if (page0 < 0 || pages < 1 ||
        (static_cast<int64_t>(page0) + pages) * RAPTOR_PAGE > window) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t bytes = (static_cast<int64_t>(pages) * RAPTOR_PAGE + 4) * 4;
    if (bytes > RAPTOR_K4_WINDOW_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    smem = static_cast<int>(bytes);
  }
  const T* v = static_cast<const T*>(vals);
  const int* pi = static_cast<const int*>(pidx);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n);
  const int xo = static_cast<int>(x_off), xl = static_cast<int>(x_len);
  // up to 4 and up to 8 live slots: one unrolled chunk; more: the loop
#define RAPTOR_K4_LAUNCH(STAGED, PAGE0, PAGES, SMEM)                         \
  (n_live <= 4                                                               \
       ? launch_banded_as<T, STAGED, 4, true>(v, pi, xp, yp, ni, K, tile, Wp, \
                                              xo, xl, PAGE0, PAGES, n_live,  \
                                              live, threads, SMEM, s)        \
   : n_live <= RAPTOR_K4_SINGLE_MAX                                          \
       ? launch_banded_as<T, STAGED, RAPTOR_K4_SINGLE_MAX, true>(            \
             v, pi, xp, yp, ni, K, tile, Wp, xo, xl, PAGE0, PAGES, n_live,   \
             live, threads, SMEM, s)                                         \
       : launch_banded_as<T, STAGED, RAPTOR_K4_LOOP_CHUNK, false>(           \
             v, pi, xp, yp, ni, K, tile, Wp, xo, xl, PAGE0, PAGES, n_live,   \
             live, threads, SMEM, s))
  const cudaError_t e = staged ? RAPTOR_K4_LAUNCH(true, page0, pages, smem)
                               : RAPTOR_K4_LAUNCH(false, 0, 0, 0);
#undef RAPTOR_K4_LAUNCH
  return static_cast<int>(e);
}

// K6's launch: x holds x_len floats (a whole number of pages), and the
// window's base page is (t*map_cols)//(T*1024) - WpP (map_cols = x_len in
// the n_cols form).
template <typename T>
int launch_rect(const void* vals, const void* pidx, const void* x, void* y,
                int64_t n, int K, int tile, int64_t x_len, int64_t map_cols,
                int WpP, const int* slots, int n_live, void* stream) {
  SlotList live;
  if (n < 1 || K < 1 || tile < 1 || n % tile != 0 || x_len < RAPTOR_PAGE ||
      x_len % RAPTOR_PAGE != 0 || map_cols < 0 ||
      map_cols > (int64_t(1) << 40) || !fill_slots(live, slots, n_live, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  banded_rect_kernel<T><<<blocks_for(n), RAPTOR_BANDED_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int*>(pidx),
      static_cast<const float*>(x), static_cast<float*>(y), n, K, tile,
      x_len, map_cols, WpP, live);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int raptor_banded_f32(const void* vals, const void* pidx, const void* x,
                      void* y, int64_t n, int K, int tile, int Wp,
                      int64_t x_off, int64_t x_len, const unsigned* mask,
                      int n_live, int staged, int threads, int page0,
                      int pages, void* stream) {
  return launch_banded<float>(vals, pidx, x, y, n, K, tile, Wp, x_off, x_len,
                              mask, n_live, staged, threads, page0, pages,
                              stream);
}

int raptor_banded_bf16(const void* vals, const void* pidx, const void* x,
                       void* y, int64_t n, int K, int tile, int Wp,
                       int64_t x_off, int64_t x_len, const unsigned* mask,
                       int n_live, int staged, int threads, int page0,
                       int pages, void* stream) {
  return launch_banded<__nv_bfloat16>(vals, pidx, x, y, n, K, tile, Wp, x_off,
                                      x_len, mask, n_live, staged, threads,
                                      page0, pages, stream);
}

int raptor_banded_rect_f32(const void* vals, const void* pidx, const void* x,
                           void* y, int64_t n, int K, int tile, int64_t x_len,
                           int64_t map_cols, int WpP, const int* slots,
                           int n_live, void* stream) {
  return launch_rect<float>(vals, pidx, x, y, n, K, tile, x_len, map_cols, WpP,
                            slots, n_live, stream);
}

int raptor_banded_rect_bf16(const void* vals, const void* pidx, const void* x,
                            void* y, int64_t n, int K, int tile,
                            int64_t x_len, int64_t map_cols, int WpP,
                            const int* slots, int n_live, void* stream) {
  return launch_rect<__nv_bfloat16>(vals, pidx, x, y, n, K, tile, x_len,
                                    map_cols, WpP, slots, n_live, stream);
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
