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
// The three kernels share one design (K4's, see banded_kernel below): four
// consecutive rows a thread, 16-byte plan loads in unrolled chunks of
// slots, the live slots as a bit mask, and x from a shared-memory window
// of the live pages or straight from device memory, as the host's launch
// plan says (ops/cuda/banded_kernel.py::banded_launch_plan).
//
// Rounding: every product and sum is written with __fmul_rn / __fadd_rn /
// __fsub_rn, so nvcc cannot contract a pair into an FMA.  The kernels then
// round exactly as their plain PyTorch versions (one rounded operation per
// torch op, slot by slot) and agree with them bit for bit; for K5 this is
// also what keeps the error-free transformations exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "df64.cuh"
#include "hopper_copy.cuh"

#define RAPTOR_BANDED_THREADS 256
#define RAPTOR_MAX_SLOTS 1024
#define RAPTOR_PAGE 1024
// the slot count a live mask covers, rows per thread, the most live slots
// the loop-free kernels take, slots per chunk of the looping kernels
#define RAPTOR_MAX_K 1024
#define RAPTOR_K4_ROWS 4
#define RAPTOR_K4_SINGLE_MAX 8
#define RAPTOR_K4_LOOP_CHUNK 4
// K6 with one row a thread: slots whose loads a thread keeps in flight
#define RAPTOR_K6_ROW_CHUNK 8
// shared memory a block may take on Hopper (227 KB); a window may take
// what the kernel's slot list (static) leaves
#define RAPTOR_SMEM_MAX 232448
#define RAPTOR_K4_WINDOW_MAX (RAPTOR_SMEM_MAX - 2 * RAPTOR_MAX_SLOTS)
// K6's staged window holds each page on its own, this many floats apart:
// the page and the 16-byte round-down of its start
#define RAPTOR_WPAGE (RAPTOR_PAGE + 4)
#define RAPTOR_MAX_DEVICES 64

namespace {

// the live slots: bit k of word k / 32 is set when slot k is live
struct LiveMask {
  unsigned w[RAPTOR_MAX_K / 32];
};

// ---------------------------------------------------------------------------
// Device functions of the banded gather, written for K4 and taken by K5 and
// K6 as they are.
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

// the same four rows' pidx and values when they lie 32 rows apart (a warp's
// lanes on consecutive rows): 4-byte (bf16: 2-byte) loads, each coalesced
// over the warp, packed as load_slot packs them
__device__ __forceinline__ void load_rows32(SlotRegs<float>& r,
                                            const float* vals, const int* pidx,
                                            int64_t e) {
  r.p = make_uint4(ld_once(pidx + e), ld_once(pidx + e + 32),
                   ld_once(pidx + e + 64), ld_once(pidx + e + 96));
  r.v = make_uint4(ld_once(vals + e), ld_once(vals + e + 32),
                   ld_once(vals + e + 64), ld_once(vals + e + 96));
}
__device__ __forceinline__ void load_rows32(SlotRegs<__nv_bfloat16>& r,
                                            const __nv_bfloat16* vals,
                                            const int* pidx, int64_t e) {
  r.p = make_uint4(ld_once(pidx + e), ld_once(pidx + e + 32),
                   ld_once(pidx + e + 64), ld_once(pidx + e + 96));
  r.v = make_uint2(ld_once16(vals + e) | (ld_once16(vals + e + 32) << 16),
                   ld_once16(vals + e + 64) | (ld_once16(vals + e + 96) << 16));
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

// x at window offset p of a square window.  Staged: ``win`` holds the
// window from offset ``wbase`` on, zeros where it leaves [0, x_len), so the
// read has no test.  Direct: x[xbase + p] from device memory; the load is
// unconditional, on an index clamped into [0, x_len), and a select gives 0
// outside.
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

// The plan loads of the live slots [s0, s0 + CH) into ``regs`` (those that
// exist); base is the element index of the rows in slot 0.
template <int CH, typename Regs, typename Load>
__device__ __forceinline__ void load_chunk(Regs (&regs)[CH], const Load& load,
                                           const unsigned short* slots, int s0,
                                           int n_live, int64_t base,
                                           int tile) {
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (s0 + c < n_live) {
      load(regs[c], base + static_cast<int64_t>(slots[s0 + c]) * tile);
    }
  }
}

// The terms of the live slots for four consecutive rows, in slot order, in
// chunks of CH slots: a chunk's gathers are issued together once its
// offsets have arrived, the next chunk's plan loads right behind them, and
// only then the chunk's terms.  ``cur`` holds the first chunk's plan loads
// (issued by the caller before it waits for the window).  SINGLE: at most
// CH live slots, so one chunk and no loop.  The kernel gives what a slot
// loads (``load(regs, e)``), how x is read at a window offset
// (``gather(p)``) and what a slot adds to its rows (``add(regs, g)``).
template <int CH, bool SINGLE, typename Regs, typename Load, typename Gather,
          typename Add>
__device__ __forceinline__ void banded_rows(const unsigned short* slots,
                                            int n_live, int64_t base, int tile,
                                            Regs (&cur)[CH], const Load& load,
                                            const Gather& gather,
                                            const Add& add) {
  for (int s0 = 0;; s0 += CH) {
    float g[CH][4];
    Regs held[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (s0 + c < n_live) {
        g[c][0] = gather(cur[c].p.x);
        g[c][1] = gather(cur[c].p.y);
        g[c][2] = gather(cur[c].p.z);
        g[c][3] = gather(cur[c].p.w);
        held[c] = cur[c];
      }
    }
    if constexpr (!SINGLE) {
      load_chunk<CH>(cur, load, slots, s0 + CH, n_live, base, tile);
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (s0 + c < n_live) add(held[c], g[c]);
    }
    if (SINGLE || s0 + CH >= n_live) break;
  }
}

// A block over a square window (K4, K5): its first row, tile and thread's
// row within the tile, and x's window; the staged copy is started
// (committed, not waited for) and the live slot list built, the block
// synchronised.
struct SquareBlock {
  int row0, t, j, xbase, wbase;
};

template <bool STAGED>
__device__ __forceinline__ SquareBlock square_block(
    const float* __restrict__ x, float* win, int K, int tile, int Wp,
    int x_off, int x_len, int page0, int pages, const LiveMask& live,
    unsigned short* slots) {
  SquareBlock b;
  b.row0 = blockIdx.x * (blockDim.x * RAPTOR_K4_ROWS);
  b.t = static_cast<int>(static_cast<unsigned>(b.row0) /
                         static_cast<unsigned>(tile));
  b.j = b.row0 - b.t * tile + threadIdx.x * RAPTOR_K4_ROWS;
  b.xbase = x_off + b.t * tile - Wp;
  b.wbase = 0;
  if constexpr (STAGED) {
    // the window's first staged element, rounded down to 16 bytes of x
    const int64_t j0 = static_cast<int64_t>(b.xbase) + page0 * RAPTOR_PAGE;
    const int rem = static_cast<int>((misalign4(x) + j0) & 3);
    stage_window(win, x, x_len, j0 - rem, pages * (RAPTOR_PAGE / 4) + 1);
    cp_async_commit();
    b.wbase = page0 * RAPTOR_PAGE - rem;
  }
  live_slot_list(live, K, slots);
  __syncthreads();
  return b;
}

// wait for the staged window (a no-op when direct)
template <bool STAGED>
__device__ __forceinline__ void window_ready() {
  if constexpr (STAGED) {
    cp_async_wait<0>();
    __syncthreads();
  }
}

// four floats at p (a multiple of four rows): one 16-byte access where the
// address allows, else four
__device__ __forceinline__ void load4(const float* __restrict__ p,
                                      float (&a)[4]) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    a[0] = v.x;
    a[1] = v.y;
    a[2] = v.z;
    a[3] = v.w;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = __ldg(p + r);
  }
}
__device__ __forceinline__ void store4(float* p, const float (&a)[4]) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) p[r] = a[r];
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

  const SquareBlock b = square_block<STAGED>(x, win, K, tile, Wp, x_off, x_len,
                                             page0, pages, live, slots);
  const int64_t base = static_cast<int64_t>(b.t) * K * tile + b.j;
  const auto load = [&](SlotRegs<T>& r, int64_t e) {
    load_slot(r, vals, pidx, e);
  };
  SlotRegs<T> cur[CH];
  load_chunk<CH>(cur, load, slots, 0, n_live, base, tile);
  window_ready<STAGED>();
  float acc[R] = {0.0f, 0.0f, 0.0f, 0.0f};
  banded_rows<CH, SINGLE>(
      slots, n_live, base, tile, cur, load,
      [&](unsigned p) {
        return gather_x<STAGED>(x, win, b.wbase, b.xbase, x_len, p);
      },
      [&](const SlotRegs<T>& r, const float (&g)[4]) {
        float v[4];
        slot_values(r, v);
#pragma unroll
        for (int q = 0; q < R; ++q) {
          acc[q] = __fadd_rn(acc[q], __fmul_rn(v[q], g[q]));
        }
      });
  store4(y + b.row0 + threadIdx.x * R, acc);
}

// ---------------------------------------------------------------------------
// K6: rectangular banded transfer (P or R).
//
// Replaces raptor_tpu/ops/pallas/banded_kernel.py::_banded_call_rect.
// Window page p of tile t is clamp(base_t + p, 0, x_len/1024 - 1) with
// base_t = (t*map_cols)//(T*1024) - WpP, exactly the TPU kernel's index
// map, the clamp per page so the dummy targets of masked slots stay in
// range:
//   y[i] = sum_{live k} vals[t,k,j] * x[page(pidx >> 10) * 1024 + (pidx & 1023)]
// Two forms: n_cols (map_cols = x_len = the column count, WpP the plan's)
// and map_cols, the sharded caller's
// (raptor_tpu/parallel/dist.py::dist_rect_banded_spmv): x is a rank's
// halo-extended buffer of x_len elements, map_cols its own column count,
// and WpP, folded into the buffer's left halo, is 0.
//
// Bound: device-memory bytes, live*n*(sizeof(vals) + 4) + 4n + 4*x_len
// (48^3 level 0 R: 8 slots over 55,296 rows reading 110,592 fine values,
// 1.1 us; 96^3 level 0 P: 7 slots over 884,736 rows, 16 us).
//
// Design: K4's (four rows a thread, plan loads in unrolled chunks, the
// live mask, the host's launch plan), on a window whose pages are not
// contiguous in x.  At the first and last tiles the clamp maps several
// window pages to one page of x, and a masked slot reads there (its dummy
// target is its slot's lowest page), so a staged copy must repeat such a
// page as often as the window does:
//   * staged: each live window page [page0, page0 + pages) is copied on its
//     own, from the 16-byte boundary of x at or below its clamped page's
//     start, RAPTOR_WPAGE floats apart in shared memory (stage_pages); the
//     remainder rem is the same for every page (pages are 4 KB apart), so
//     a window offset p reads win[p + 4*(p >> 10) - (page0*RAPTOR_WPAGE - rem)];
//   * direct: x[clamp(base + (p >> 10), 0, last) * 1024 + (p & 1023)], in
//     range by the clamp, so no select.
// A thread's four rows are consecutive (one 16-byte pidx and vals load a
// slot) or, STRIDED, 32 apart (four coalesced 4-byte loads a slot), so
// that a warp's gather covers 32 consecutive rows; on levels of more than
// RAPTOR_K4_SINGLE_MAX live slots a thread takes one row
// (banded_rect_row_kernel).  Measured on an H100
// with consecutive rows (scripts/bench_banded_rect_ab.py), K6 lost to the
// one-row-per-thread kernel it replaces at the short R levels (96^3 level
// 1 R: 6.8 direct, 8.7 staged against 6.0 us): a warp's rows then read x
// four times as far apart as its lanes, over four times the L1 sectors
// direct, and, staged, R's x reads 8 floats apart per lane land on 4 of
// the 32 shared-memory banks.  The host picks the stride and the variant.
// The window base is one division per thread of the block, in 32 bits
// where t * map_cols fits them.
// ---------------------------------------------------------------------------

// x at window offset p of a K6 window whose page 0 is x's page xbase, the
// page clamped into [0, last]: in range, so no select
__device__ __forceinline__ float rect_x(const float* __restrict__ x,
                                        int xbase, int last, unsigned p) {
  const int pg = min(max(xbase + static_cast<int>(p >> 10), 0), last);
  return __ldg(x + (pg * RAPTOR_PAGE + static_cast<int>(p & (RAPTOR_PAGE - 1))));
}

// base_t + WpP = (t * map_cols) // (T * 1024)
__device__ __forceinline__ int rect_base(int t, int64_t map_cols, int n_tiles) {
  const uint64_t num = static_cast<uint64_t>(t) * static_cast<uint64_t>(map_cols);
  const unsigned den = static_cast<unsigned>(n_tiles) * RAPTOR_PAGE;
  return (num >> 32) ? static_cast<int>(num / den)
                     : static_cast<int>(static_cast<unsigned>(num) / den);
}

// Stage window pages [first, first + pages) of x (x_len floats, a whole
// number of pages; first may lie outside): page w is x's page clamp(first
// + w, 0, last), copied from 16 bytes below its start when x lies rem
// elements past a 16-byte boundary, RAPTOR_WPAGE floats apart in dst.  A
// page's copy is RAPTOR_WPAGE / 4 chunks of four, each one 16-byte
// cp.async, or four 4-byte ones zero-filled outside [0, x_len) at the ends
// of x (those elements are never read).  The caller commits, waits and
// synchronises before it reads dst.
__device__ __forceinline__ void stage_pages(float* dst,
                                            const float* __restrict__ x,
                                            int x_len, int first, int last,
                                            int rem, int pages) {
  constexpr int CPP = RAPTOR_WPAGE / 4;
  const int chunks = pages * CPP;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int w = static_cast<int>(static_cast<unsigned>(c) / CPP);
    const int pg = min(max(first + w, 0), last);
    const int g = pg * RAPTOR_PAGE - rem + 4 * (c - w * CPP);
    float* d = dst + 4 * c;
    if (g >= 0 && g + 4 <= x_len) {
      cp_async16(d, x + g);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = g + e >= 0 && g + e < x_len;
        cp_async4(d + e, ok ? x + (g + e) : x, ok);
      }
    }
  }
}

template <typename T, bool STAGED, bool STRIDED, int CH, bool SINGLE>
__global__ void __launch_bounds__(RAPTOR_BANDED_THREADS, SINGLE ? 1 : 2)
banded_rect_kernel(const T* __restrict__ vals, const int* __restrict__ pidx,
                   const float* __restrict__ x, float* __restrict__ y, int K,
                   int tile, int n_tiles, int x_len, int64_t map_cols, int WpP,
                   int page0, int pages, int n_live,
                   const __grid_constant__ LiveMask live) {
  constexpr int R = RAPTOR_K4_ROWS;
  __shared__ unsigned short slots[RAPTOR_MAX_SLOTS];
  extern __shared__ float4 win4[];
  float* win = reinterpret_cast<float*>(win4);

  const int row0 = blockIdx.x * (blockDim.x * R);
  const int t = static_cast<int>(static_cast<unsigned>(row0) /
                                 static_cast<unsigned>(tile));
  // the thread's first row in the tile: of four consecutive rows, or
  // (STRIDED) of four 32 apart, so that a warp's gather covers 32
  // consecutive rows
  const int j = row0 - t * tile +
                (STRIDED ? (threadIdx.x & ~31u) * R + (threadIdx.x & 31u)
                         : threadIdx.x * R);
  const int xbase = rect_base(t, map_cols, n_tiles) - WpP;
  const int last = x_len / RAPTOR_PAGE - 1;
  int wbase = 0;
  if constexpr (STAGED) {
    const int rem = misalign4(x);
    stage_pages(win, x, x_len, xbase + page0, last, rem, pages);
    cp_async_commit();
    wbase = page0 * RAPTOR_WPAGE - rem;
  }
  live_slot_list(live, K, slots);
  __syncthreads();

  const int64_t base = static_cast<int64_t>(t) * K * tile + j;
  const auto load = [&](SlotRegs<T>& r, int64_t e) {
    if constexpr (STRIDED) {
      load_rows32(r, vals, pidx, e);
    } else {
      load_slot(r, vals, pidx, e);
    }
  };
  SlotRegs<T> cur[CH];
  load_chunk<CH>(cur, load, slots, 0, n_live, base, tile);
  window_ready<STAGED>();
  float acc[R] = {0.0f, 0.0f, 0.0f, 0.0f};
  banded_rows<CH, SINGLE>(
      slots, n_live, base, tile, cur, load,
      [&](unsigned p) {
        if constexpr (STAGED) {
          return win[static_cast<int>(p + ((p >> 10) << 2)) - wbase];
        } else {
          return rect_x(x, xbase, last, p);
        }
      },
      [&](const SlotRegs<T>& r, const float (&g)[4]) {
        float v[4];
        slot_values(r, v);
#pragma unroll
        for (int q = 0; q < R; ++q) {
          acc[q] = __fadd_rn(acc[q], __fmul_rn(v[q], g[q]));
        }
      });
  float* yr = y + (static_cast<int64_t>(t) * tile + j);
  if constexpr (STRIDED) {
#pragma unroll
    for (int q = 0; q < R; ++q) yr[32 * q] = acc[q];
  } else {
    store4(yr, acc);
  }
}

// one value of vals, widened
__device__ __forceinline__ float load_value(const float* p) {
  return __uint_as_float(ld_once(p));
}
__device__ __forceinline__ float load_value(const __nv_bfloat16* p) {
  return __uint_as_float(ld_once16(p) << 16);
}

// K6 with one row a thread, direct, for the levels of more than
// RAPTOR_K4_SINGLE_MAX live slots (every short R level).  There the work
// is a few microseconds of latency, and four rows a thread leave a quarter
// of the threads to hide it: the one-row-per-thread kernel this replaces
// read 4.9-6.2 us where four rows a thread read 7.1-11.7
// (scripts/bench_banded_rect_ab.py, H100; every looping shape of the 48^3
// and 96^3 paths).  A thread keeps RAPTOR_K6_ROW_CHUNK slots' plan loads,
// then their gathers, in flight at once; a warp's lanes are 32 consecutive
// rows, so its loads are coalesced and its gathers close.
template <typename T>
__global__ void __launch_bounds__(RAPTOR_BANDED_THREADS)
banded_rect_row_kernel(const T* __restrict__ vals, const int* __restrict__ pidx,
                       const float* __restrict__ x, float* __restrict__ y,
                       int K, int tile, int n_tiles, int x_len,
                       int64_t map_cols, int WpP, int n_live,
                       const __grid_constant__ LiveMask live) {
  constexpr int CH = RAPTOR_K6_ROW_CHUNK;
  __shared__ unsigned short slots[RAPTOR_MAX_SLOTS];
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = static_cast<int>(static_cast<unsigned>(row) /
                                 static_cast<unsigned>(tile));
  const int xbase = rect_base(t, map_cols, n_tiles) - WpP;
  const int last = x_len / RAPTOR_PAGE - 1;
  live_slot_list(live, K, slots);
  __syncthreads();
  const int64_t base = static_cast<int64_t>(t) * K * tile + (row - t * tile);
  float acc = 0.0f;
  for (int s0 = 0; s0 < n_live; s0 += CH) {
    unsigned p[CH];
    float v[CH], g[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (s0 + c < n_live) {
        const int64_t e = base + static_cast<int64_t>(slots[s0 + c]) * tile;
        p[c] = ld_once(pidx + e);
        v[c] = load_value(vals + e);
      }
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (s0 + c < n_live) g[c] = rect_x(x, xbase, last, p[c]);
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (s0 + c < n_live) acc = __fadd_rn(acc, __fmul_rn(v[c], g[c]));
    }
  }
  y[row] = acc;
}

// ---------------------------------------------------------------------------
// K5: fused df64 residual on the square banded layout.
//
// Replaces raptor_tpu/ops/pallas/banded_kernel.py::_banded_df64_resid_call.
//   (rh, rl) = df64[(bh, bl) - v - A @ xh]
// per row: (sh, se) = df_add(bh, bl, -v, 0); then for each live slot in
// order (ph, pe) = two_prod(vals, gh), pe += vals_lo * gh when vals_lo is
// given (the operator's fp32 truncation remainder), and
// (sh, se) = df_add(sh, se, -ph, -pe).  two_prod and df_add are df64.cuh's,
// which K7 (dia_df64_kernel.cu) shares.
//
// Bound: device-memory bytes, live*n*(4 + 4 [+ 4 with vals_lo]) + 24n (xh,
// bh, bl, v in; rh, rl out); 27 fp32 operations per entry, far under the
// card's fp32 rate.
//
// Design: K4's zero-pad form with a df64 body.  Four rows a thread, one
// 16-byte load each of pidx, vals and (LO) vals_lo per slot, 16-byte loads
// of bh, bl and v and stores of rh and rl; x from K4's staged window (zeros
// outside [0, n)) or direct, by K4's launch plan on the same plan; each
// row's (sh, se) in registers.  With vals_lo a chunk of 8 holds 96
// registers of plan values, so the kernel asks for one block an SM and
// lets ptxas take what it needs (the build log reports it).
// ---------------------------------------------------------------------------

// four rows' pidx, vals and (LO) vals_lo of one slot
template <bool LO>
struct DfRegs {
  uint4 p, v, lo;
};
template <>
struct DfRegs<false> {
  uint4 p, v;
};

__device__ __forceinline__ float lane(const uint4& u, int q) {
  return __uint_as_float(q == 0 ? u.x : q == 1 ? u.y : q == 2 ? u.z : u.w);
}

template <bool STAGED, int CH, bool SINGLE, bool LO>
__global__ void __launch_bounds__(RAPTOR_BANDED_THREADS, 1)
banded_df64_kernel(const float* __restrict__ vals,
                   const float* __restrict__ vals_lo,
                   const int* __restrict__ pidx, const float* __restrict__ xh,
                   const float* __restrict__ bh, const float* __restrict__ bl,
                   const float* __restrict__ v, float* __restrict__ rh,
                   float* __restrict__ rl, int K, int tile, int Wp, int n,
                   int page0, int pages, int n_live,
                   const __grid_constant__ LiveMask live) {
  constexpr int R = RAPTOR_K4_ROWS;
  __shared__ unsigned short slots[RAPTOR_MAX_SLOTS];
  extern __shared__ float4 win4[];
  float* win = reinterpret_cast<float*>(win4);

  const SquareBlock b = square_block<STAGED>(xh, win, K, tile, Wp, 0, n,
                                             page0, pages, live, slots);
  const int i0 = b.row0 + threadIdx.x * R;
  float b_hi[R], b_lo[R], vv[R];
  load4(bh + i0, b_hi);
  load4(bl + i0, b_lo);
  load4(v + i0, vv);
  const int64_t base = static_cast<int64_t>(b.t) * K * tile + b.j;
  const auto load = [&](DfRegs<LO>& r, int64_t e) {
    r.p = ld_plane(pidx + e);
    r.v = ld_plane(vals + e);
    if constexpr (LO) r.lo = ld_plane(vals_lo + e);
  };
  DfRegs<LO> cur[CH];
  load_chunk<CH>(cur, load, slots, 0, n_live, base, tile);
  window_ready<STAGED>();
  float sh[R], se[R];
#pragma unroll
  for (int q = 0; q < R; ++q) df_add(b_hi[q], b_lo[q], -vv[q], 0.0f, sh[q], se[q]);
  banded_rows<CH, SINGLE>(
      slots, n_live, base, tile, cur, load,
      [&](unsigned p) {
        return gather_x<STAGED>(xh, win, b.wbase, b.xbase, n, p);
      },
      [&](const DfRegs<LO>& r, const float (&g)[4]) {
#pragma unroll
        for (int q = 0; q < R; ++q) {
          float ph, pe;
          two_prod(lane(r.v, q), g[q], ph, pe);
          if constexpr (LO) pe = __fadd_rn(pe, __fmul_rn(lane(r.lo, q), g[q]));
          df_add(sh[q], se[q], -ph, -pe, sh[q], se[q]);
        }
      });
  store4(rh + i0, sh);
  store4(rl + i0, se);
}

// ---------------------------------------------------------------------------
// Host side: checks and launches
// ---------------------------------------------------------------------------

// Check a live mask: n_live bits set, none at or above K.
bool check_mask(const LiveMask& live, int n_live, int K) {
  int bits = 0;
  for (int w = 0; w < RAPTOR_MAX_K / 32; ++w) {
    const int lo = w * 32;
    if (lo + 32 > K && live.w[w] >> (lo >= K ? 0 : K - lo) != 0) return false;
    bits += __builtin_popcount(live.w[w]);
  }
  return bits == n_live;
}

// The checks every banded launch shares (the launch plan's block, the
// plan's shape, the mask, vals and pidx 16-byte aligned); fills ``live``.
bool check_launch(int64_t n, int K, int tile, const unsigned* mask,
                  int n_live, int threads, const void* vals, const void* pidx,
                  LiveMask& live) {
  if (n < 1 || n >= (int64_t(1) << 31) || K < 1 || K > RAPTOR_MAX_K ||
      tile < RAPTOR_PAGE || tile % RAPTOR_PAGE != 0 || n % tile != 0 ||
      n_live < 0 || n_live > RAPTOR_MAX_SLOTS || threads < 32 ||
      threads > RAPTOR_BANDED_THREADS || (threads & (threads - 1)) != 0 ||
      ((reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(pidx)) &
       15) != 0) {
    return false;
  }
  for (int w = 0; w < RAPTOR_MAX_K / 32; ++w) live.w[w] = mask[w];
  return check_mask(live, n_live, K);
}

// Above 48 KB a block's shared memory must be allowed first: once per
// kernel and device, before any launch (so never inside a graph capture
// that the first, eager call did not precede).  The kernels already
// allowed are kept per device (the staged instantiations are 24).
cudaError_t allow_window(const void* kern) {
  constexpr int kMaxKernels = 32;
  static const void* allowed[RAPTOR_MAX_DEVICES][kMaxKernels] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= RAPTOR_MAX_DEVICES) return cudaErrorInvalidDevice;
  for (int i = 0; i < kMaxKernels; ++i) {
    if (allowed[dev][i] == kern) return cudaSuccess;
    if (allowed[dev][i] == nullptr) {
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               RAPTOR_K4_WINDOW_MAX);
      if (e == cudaSuccess) allowed[dev][i] = kern;
      return e;
    }
  }
  return cudaErrorNotSupported;
}

// Launch ``kern`` (one instantiation, STAGED or not) over n rows, ``rows``
// a thread, after allowing its window.
template <bool STAGED, typename Kern, typename... Args>
cudaError_t launch_as(Kern kern, int64_t n, int rows, int threads, int smem,
                      cudaStream_t stream, Args... args) {
  if constexpr (STAGED) {
    const cudaError_t e = allow_window(reinterpret_cast<const void*>(kern));
    if (e != cudaSuccess) return e;
  }
  const unsigned blocks = static_cast<unsigned>(n / (threads * rows));
  kern<<<blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The instantiation for a launch: staged or direct, then by the live
// slots: one unrolled chunk of 4 or of 8, or the loop over chunks of 4.
// ``f(staged, chunk, single)`` takes each as an integral constant.
template <typename F>
cudaError_t by_variant(bool staged, int n_live, const F& f) {
  using std::bool_constant;
  using std::integral_constant;
  const auto by_chunk = [&](auto st) {
    if (n_live <= 4) {
      return f(st, integral_constant<int, 4>{}, bool_constant<true>{});
    }
    if (n_live <= RAPTOR_K4_SINGLE_MAX) {
      return f(st, integral_constant<int, RAPTOR_K4_SINGLE_MAX>{},
               bool_constant<true>{});
    }
    return f(st, integral_constant<int, RAPTOR_K4_LOOP_CHUNK>{},
             bool_constant<false>{});
  };
  return staged ? by_chunk(bool_constant<true>{})
                : by_chunk(bool_constant<false>{});
}

// K4's and K5's staged window: pages [page0, page0 + pages) of a square
// window of tile + 2*Wp elements, in shared memory with the 16-byte
// round-down (nothing is truncated: what does not fit is refused)
bool square_window(int tile, int Wp, int page0, int pages, int& smem) {
  const int64_t window = static_cast<int64_t>(tile) + 2 * int64_t(Wp);
  if (page0 < 0 || pages < 1 ||
      (static_cast<int64_t>(page0) + pages) * RAPTOR_PAGE > window) {
    return false;
  }
  const int64_t bytes = (static_cast<int64_t>(pages) * RAPTOR_PAGE + 4) * 4;
  if (bytes > RAPTOR_K4_WINDOW_MAX) return false;
  smem = static_cast<int>(bytes);
  return true;
}

// K4's launch, from the wrapper's plan (banded_launch_plan): ``mask`` holds
// RAPTOR_MAX_K / 32 words; ``threads`` per block, each of four rows;
// ``staged`` with the window's pages [page0, page0 + pages), which must fit
// a block's shared memory.  x holds x_len floats, row 0's x at x_off (the
// zero-pad form: 0 and n; the halo form: kh*tile and n + 2*kh*tile).
template <typename T>
int launch_banded(const void* vals, const void* pidx, const void* x, void* y,
                  int64_t n, int K, int tile, int Wp, int64_t x_off,
                  int64_t x_len, const unsigned* mask, int n_live, int staged,
                  int threads, int page0, int pages, void* stream) {
  LiveMask live;
  int smem = 0;
  if (!check_launch(n, K, tile, mask, n_live, threads, vals, pidx, live) ||
      Wp < 0 || x_off < 0 || x_len < 1 || x_off + n > x_len ||
      x_len + RAPTOR_PAGE + Wp >= (int64_t(1) << 31) ||
      (staged && !square_window(tile, Wp, page0, pages, smem))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* v = static_cast<const T*>(vals);
  const int* pi = static_cast<const int*>(pidx);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int xo = static_cast<int>(x_off), xl = static_cast<int>(x_len);
  return static_cast<int>(by_variant(
      staged, n_live, [&](auto st, auto ch, auto single) {
        constexpr bool ST = decltype(st)::value;
        return launch_as<ST>(
            banded_kernel<T, ST, decltype(ch)::value, decltype(single)::value>,
            n, RAPTOR_K4_ROWS, threads, smem, s, v, pi, xp, yp, K, tile, Wp,
            xo, xl,
            ST ? page0 : 0, ST ? pages : 0, n_live, live);
      }));
}

// K6's launch, from the wrapper's plan (banded_launch_plan on the
// rectangular plan): x holds x_len floats (a whole number of pages), the
// window's base page is (t*map_cols)//(T*1024) - WpP (map_cols = x_len in
// the n_cols form); ``staged`` with the window's pages [page0, page0 +
// pages) of its npage, each page RAPTOR_WPAGE floats of shared memory.
// ``layout``: 0 four consecutive rows a thread, 1 four rows 32 apart, 2
// one row a thread (direct only).
template <typename T>
int launch_rect(const void* vals, const void* pidx, const void* x, void* y,
                int64_t n, int K, int tile, int64_t x_len, int64_t map_cols,
                int WpP, int npage, const unsigned* mask, int n_live,
                int staged, int layout, int threads, int page0, int pages,
                void* stream) {
  LiveMask live;
  int smem = 0;
  if (!check_launch(n, K, tile, mask, n_live, threads, vals, pidx, live) ||
      x_len < RAPTOR_PAGE || x_len % RAPTOR_PAGE != 0 ||
      x_len >= (int64_t(1) << 31) || map_cols < 0 ||
      map_cols > (int64_t(1) << 40) || WpP < 0 || WpP >= (1 << 30) ||
      npage < 1 || layout < 0 || layout > 2 || (layout == 2 && staged)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (staged) {
    const int64_t bytes = static_cast<int64_t>(pages) * RAPTOR_WPAGE * 4;
    if (page0 < 0 || pages < 1 || static_cast<int64_t>(page0) + pages > npage ||
        bytes > RAPTOR_K4_WINDOW_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    smem = static_cast<int>(bytes);
  }
  const T* v = static_cast<const T*>(vals);
  const int* pi = static_cast<const int*>(pidx);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = static_cast<int>(n / tile), xl = static_cast<int>(x_len);
  if (layout == 2) {
    return static_cast<int>(launch_as<false>(
        banded_rect_row_kernel<T>, n, 1, threads, 0, s, v, pi, xp, yp, K, tile,
        n_tiles, xl, map_cols, WpP, n_live, live));
  }
  const auto rows = [&](auto sr) {
    return by_variant(staged, n_live, [&](auto st, auto ch, auto single) {
      constexpr bool ST = decltype(st)::value;
      return launch_as<ST>(
          banded_rect_kernel<T, ST, decltype(sr)::value, decltype(ch)::value,
                             decltype(single)::value>,
          n, RAPTOR_K4_ROWS, threads, smem, s, v, pi, xp, yp, K, tile, n_tiles,
          xl, map_cols, WpP, ST ? page0 : 0, ST ? pages : 0, n_live, live);
    });
  };
  return static_cast<int>(layout == 1 ? rows(std::bool_constant<true>{})
                                      : rows(std::bool_constant<false>{}));
}

// K5's launch: K4's zero-pad form (x_off 0, x_len n) and K4's launch plan;
// vals_lo may be null (no truncation remainder) and is 16-byte aligned
// where given.
template <bool LO>
int launch_df64(const float* vals, const float* vals_lo, const int* pidx,
                const float* xh, const float* bh, const float* bl,
                const float* v, float* rh, float* rl, int64_t n, int K,
                int tile, int Wp, const unsigned* mask, int n_live, int staged,
                int threads, int page0, int pages, cudaStream_t s) {
  LiveMask live;
  int smem = 0;
  if (!check_launch(n, K, tile, mask, n_live, threads, vals, pidx, live) ||
      Wp < 0 || n + RAPTOR_PAGE + Wp >= (int64_t(1) << 31) ||
      (LO && (reinterpret_cast<uintptr_t>(vals_lo) & 15) != 0) ||
      (staged && !square_window(tile, Wp, page0, pages, smem))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ni = static_cast<int>(n);
  return static_cast<int>(by_variant(
      staged, n_live, [&](auto st, auto ch, auto single) {
        constexpr bool ST = decltype(st)::value;
        return launch_as<ST>(
            banded_df64_kernel<ST, decltype(ch)::value, decltype(single)::value,
                               LO>,
            n, RAPTOR_K4_ROWS, threads, smem, s, vals, vals_lo, pidx, xh, bh,
            bl, v, rh, rl, K, tile, Wp, ni, ST ? page0 : 0, ST ? pages : 0,
            n_live, live);
      }));
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
                           int64_t map_cols, int WpP, int npage,
                           const unsigned* mask, int n_live, int staged,
                           int layout, int threads, int page0, int pages,
                           void* stream) {
  return launch_rect<float>(vals, pidx, x, y, n, K, tile, x_len, map_cols, WpP,
                            npage, mask, n_live, staged, layout, threads,
                            page0, pages, stream);
}

int raptor_banded_rect_bf16(const void* vals, const void* pidx, const void* x,
                            void* y, int64_t n, int K, int tile,
                            int64_t x_len, int64_t map_cols, int WpP,
                            int npage, const unsigned* mask, int n_live,
                            int staged, int layout, int threads, int page0,
                            int pages, void* stream) {
  return launch_rect<__nv_bfloat16>(vals, pidx, x, y, n, K, tile, x_len,
                                    map_cols, WpP, npage, mask, n_live, staged,
                                    layout, threads, page0, pages, stream);
}

// vals_lo may be null (no truncation remainder).
int raptor_banded_df64_f32(const void* vals, const void* vals_lo,
                           const void* pidx, const void* xh, const void* bh,
                           const void* bl, const void* v, void* rh, void* rl,
                           int64_t n, int K, int tile, int Wp,
                           const unsigned* mask, int n_live, int staged,
                           int threads, int page0, int pages, void* stream) {
  const float* lo = static_cast<const float*>(vals_lo);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* va = static_cast<const float*>(vals);
  const int* pi = static_cast<const int*>(pidx);
  const float *x = static_cast<const float*>(xh),
              *b_h = static_cast<const float*>(bh),
              *b_l = static_cast<const float*>(bl),
              *vv = static_cast<const float*>(v);
  float *r_h = static_cast<float*>(rh), *r_l = static_cast<float*>(rl);
  return lo != nullptr
             ? launch_df64<true>(va, lo, pi, x, b_h, b_l, vv, r_h, r_l, n, K,
                                 tile, Wp, mask, n_live, staged, threads,
                                 page0, pages, s)
             : launch_df64<false>(va, lo, pi, x, b_h, b_l, vv, r_h, r_l, n, K,
                                  tile, Wp, mask, n_live, staged, threads,
                                  page0, pages, s);
}

}  // extern "C"
