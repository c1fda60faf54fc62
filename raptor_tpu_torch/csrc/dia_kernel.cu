// DIA (offset-diagonal) SpMV kernels K1, K1v1 and K3 for NVIDIA Hopper
// (sm_90a).
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (raptor_tpu_torch/ops/cuda/build.py, dia_kernel.py).  Every entry
// point launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() (or the error of the call that refused the launch) so
// the wrapper can raise.
//
// K1, K1v1 and K3 share one device code, the tiled plane-streaming kernel
// below: K1 takes x of shape (batch, n), contiguous; K3 takes one vector
// and its two halos; K1v1 is K1's entry point given planes that need not be
// boundary-zeroed (K1 reads x as zero outside [0, n), which is K1v1's
// function).  K2, which walks the same tiles and windows with its planes
// synthesized, is in dia_const_kernel.cu.
//
// Rounding: each term is rounded as the plain PyTorch version rounds it
// (__fmul_rn, then __fadd_rn, in the reference's offset order, the first
// term standing alone as the reference's sum starts), so nvcc cannot
// contract the pair into an FMA and the kernels agree with their plain
// versions bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dia_tiles.cuh"
#include "hopper_copy.cuh"

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Stage one tile's windows into ``buf``.  Window b holds the elements
// [a0, a0 + win[b]) of xw = [halo_left | x | halo_right], 0 beyond, where
// a0 is row0 + lo[b] rounded down to a 16-byte boundary of x.  A chunk of
// four inside x is one 16-byte copy; a chunk wholly beyond the halos is a
// store of zeros; any other chunk at an edge is four 4-byte copies, each
// from x, a halo, or zero-filled.
__device__ __forceinline__ void stage_windows(
    float* buf, const float* xb, const float* hl, const float* hr, int64_t n,
    int64_t len_l, int64_t len_r, int64_t row0, const TilePlan& p) {
  const int xmis = misalign4(xb);
  for (int b = 0; b < p.n_band; ++b) {
    const int64_t j0 = row0 + p.lo[b];
    const int64_t a0 = j0 - ((xmis + j0) & 3);
    float* dst = buf + p.base[b];
    const int chunks = p.win[b] >> 2;
    // chunks [c_lo, c_hi) lie inside x: 16-byte copies
    const int64_t lo = a0 >= 0 ? 0 : (-a0 + 3) >> 2;
    const int64_t hi = (n - a0) >> 2;
    const int c_lo = static_cast<int>(lo < chunks ? lo : chunks);
    const int c_hi = static_cast<int>(hi < c_lo ? c_lo : hi < chunks ? hi : chunks);
    for (int c = c_lo + threadIdx.x; c < c_hi; c += blockDim.x) {
      cp_async16(dst + 4 * c, xb + (a0 + 4 * c));
    }
    // the edge chunks: zeros where the whole chunk lies beyond the halos,
    // else element by element from x, a halo, or zero
    const int n_edge = c_lo + (chunks - c_hi);
    for (int i = threadIdx.x; i < n_edge; i += blockDim.x) {
      const int c = i < c_lo ? i : c_hi + (i - c_lo);
      const int64_t g = a0 + 4 * c;
      if (g + 4 <= -len_l || g >= n + len_r) {
        *reinterpret_cast<float4*>(dst + 4 * c) = make_float4(0, 0, 0, 0);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t j = g + e;
        const float* from = xb;
        bool ok = true;
        if (j >= 0 && j < n) {
          from = xb + j;
        } else if (j < 0 && j >= -len_l) {
          from = hl + (len_l + j);
        } else if (j >= n && j - n < len_r) {
          from = hr + (j - n);
        } else {
          ok = false;
        }
        cp_async4(dst + 4 * c + e, from, ok);
      }
    }
  }
}

// the R plane values of one 16-byte load, widened to fp32
__device__ __forceinline__ void unpack(const uint4& q, float (&out)[4],
                                       const float*) {
  out[0] = __uint_as_float(q.x);
  out[1] = __uint_as_float(q.y);
  out[2] = __uint_as_float(q.z);
  out[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack(const uint4& q, float (&out)[8],
                                       const __nv_bfloat16*) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// ---------------------------------------------------------------------------
// K1 (and K1v1) and K3: tiled plane-streaming DIA SpMV.
//
// K1 replaces raptor_tpu/ops/pallas/dia_kernel.py::_dia_pallas_call_v2:
//   y[b, i] = sum_k f32(data[k, i]) * x[b, i + lin_k], x read as 0 outside
//   [0, n) (the planes are boundary-zeroed, so that is also the TPU
//   kernel's roll with clamped neighbour blocks).
// K3 replaces _dia_pallas_call_v2x, the plane-sharded SpMV:
//   y[i] = sum_k f32(data[k, i]) * xw(i + lin_k),  0 <= i < nl,
//   xw = [halo_left | x | halo_right], 0 beyond (no wraparound); the TPU
//   wrapper concatenates that window into a new x_ext on every call, here
//   the three buffers stay apart.
//
// Bound: device-memory bytes.  The planes are read once (n_off * n *
// sizeof(T): 15 bf16 planes of 1M rows at level 1 of the 128^3 problem, 7
// fp32 planes of 16.8M rows at the 256^3 fine level on one rank), x and y
// once each; at 4 B per fp32 operation pair the kernel sits far below the
// card's compute rate.
//
// Design.  The one-row-per-thread kernel this replaces waited on one plane
// load and one x load per term, behind a bounds branch per term, so the
// compiler could not hoist later offsets' loads: 15 round trips in series at
// level 1, latency- and not bandwidth-bound.  Here:
//   * a block owns a tile of T consecutive rows, a thread R = 16 /
//     sizeof(T) consecutive rows (8 for bf16 planes, 4 for fp32), so every
//     plane read is one 16-byte load, and all n_off of them are issued
//     before the first multiply (n_off is a template argument for the
//     path's counts 3, 7, 15 and 27, fully unrolled; a generic body takes
//     up to 32).  With 27 offsets the first nine are issued and each term
//     summed issues the next: 27 loads held at once took 175 registers,
//     one block per SM, too few warps to hide L2 latency on the mid-size
//     levels, while the rolling loads fit 128 and two blocks;
//   * x is read from shared memory: the host groups the sorted offsets into
//     bands (a gap of more than T starts a new band; on a 3D grid a band is
//     one value of the slowest axis' offset), and each band's window
//     [row0 + lo, row0 + T + hi) is copied once per tile by 16-byte
//     cp.async, instead of n_off reads of each x value through L1/L2.  The
//     TPU kernel's single window of T + 2 * max|lin| rows (+-65536 at
//     256^3) would not fit a block's 227 KB;
//   * the staging writes zeros where the window leaves [0, n), or the halo
//     values for K3, so the multiply-add loop has no branch;
//   * the blocks are persistent (as many as fit on the SMs) and walk the
//     tiles with two stages: tile t + 1's windows are in flight while tile
//     t computes (and, for fp32 planes with up to 16 offsets, its plane
//     loads too, into a second set of registers).
// Alignment: window copies start at the 16-byte boundary at or below the
// window's first element and the reads add back the remainder; the planes
// take 16-byte loads only when the host found them aligned (VEC), else the
// kernel loads them one element at a time; y takes vector stores where its
// address allows.
// ---------------------------------------------------------------------------
template <typename T, int KMAX, bool EXACT, bool VEC>
__device__ __forceinline__ void dia_tiles(
    const T* __restrict__ data, const float* __restrict__ x,
    const float* __restrict__ hl, const float* __restrict__ hr,
    float* __restrict__ y, int64_t n, int64_t len_l, int64_t len_r,
    int batch, const TilePlan& p) {
  constexpr int R = 16 / sizeof(T);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_off = EXACT ? KMAX : p.n_off;
  const int64_t per_row = (n + p.tile - 1) / p.tile;
  const int64_t n_tiles = per_row * batch;
  const int r0 = threadIdx.x * R;

  int64_t t = blockIdx.x;
  {
    const int64_t b = batch == 1 ? 0 : t / per_row;
    stage_windows(smem, x + b * n, hl, hr, n, len_l, len_r,
                  (t - b * per_row) * p.tile, p);
  }
  cp_async_commit();
  // fp32 planes with up to 16 offsets are loaded one tile ahead: tile
  // t + 1's plane loads are in flight while tile t computes (the registers
  // of 27 offsets, or of bf16 planes at twice the rows, would not pay)
  constexpr bool PIPE = VEC && sizeof(T) == 4 && KMAX <= 16;
  // 27 offsets: ROLL_G plane loads in flight, the next issued as each term
  // is summed, so a thread holds ROLL_G of them and two blocks fit an SM
  constexpr bool ROLL = VEC && EXACT && KMAX > 16;
  constexpr int ROLL_G = 9;
  uint4 pn[PIPE ? KMAX : 1];
  if constexpr (PIPE) {
    const int64_t b0 = batch == 1 ? 0 : t / per_row;
    const int64_t row0 = (t - b0 * per_row) * p.tile + r0;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if ((EXACT || k < n_off) && row0 < n) {
        pn[k] = ld_plane(
            data + static_cast<int64_t>(k) * n + row0);
      }
    }
  }
  int s = 0;
  for (; t < n_tiles; t += gridDim.x) {
    const int64_t tn = t + gridDim.x;
    if (tn < n_tiles) {
      const int64_t bn = batch == 1 ? 0 : tn / per_row;
      stage_windows(smem + (s ^ 1) * p.stage, x + bn * n, hl, hr, n, len_l,
                    len_r, (tn - bn * per_row) * p.tile, p);
    }
    cp_async_commit();  // possibly empty: keeps wait_group 1 exact

    const int64_t b = batch == 1 ? 0 : t / per_row;
    const int64_t row = (t - b * per_row) * p.tile + r0;
    const bool active = row < n;
    // every plane load of this tile before the window wait and the sums
    uint4 pv[VEC ? KMAX : 1];
    if constexpr (PIPE) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k) pv[k] = pn[k];
      if (tn < n_tiles) {
        const int64_t bn = batch == 1 ? 0 : tn / per_row;
        const int64_t rown = (tn - bn * per_row) * p.tile + r0;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if ((EXACT || k < n_off) && rown < n) {
            pn[k] = ld_plane(
                data + static_cast<int64_t>(k) * n + rown);
          }
        }
      }
    } else if constexpr (VEC) {
#pragma unroll
      for (int k = 0; k < (ROLL ? ROLL_G : KMAX); ++k) {
        if ((EXACT || k < n_off) && active) {
          pv[k] = ld_plane(
              data + static_cast<int64_t>(k) * n + row);
        }
      }
    }
    cp_async_wait<1>();
    __syncthreads();

    if (active) {
      const float* xb = x + b * n;
      const int xmis = misalign4(xb);
      const float* w = smem + s * p.stage + r0;
      float acc[R];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if constexpr (ROLL) {
          if (k + ROLL_G < KMAX) {
            pv[k + ROLL_G] = ld_plane(
                data + static_cast<int64_t>(k + ROLL_G) * n + row);
          }
        }
        if (EXACT || k < n_off) {
          float pk[R];
          if constexpr (VEC) {
            unpack(pv[k], pk, data);
          } else {
            const T* dk = data + static_cast<int64_t>(k) * n + row;
#pragma unroll
            for (int i = 0; i < R; ++i) {
              pk[i] = row + i < n ? widen(dk[i]) : 0.0f;
            }
          }
          float xv[R];
          window_read<R>(w, p.koff[k] + ((xmis + p.klo[k]) & 3), xv);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float term = __fmul_rn(pk[i], xv[i]);
            acc[i] = k == 0 ? term : __fadd_rn(acc[i], term);
          }
        }
      }
      float* yr = y + b * n + row;
      if (row + R <= n && (reinterpret_cast<uintptr_t>(yr) & 15) == 0) {
#pragma unroll
        for (int i = 0; i < R; i += 4) {
          *reinterpret_cast<float4*>(yr + i) =
              make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (row + i < n) yr[i] = acc[i];
        }
      }
    }
    __syncthreads();  // the stage just read is the next iteration's target
    s ^= 1;
  }
  cp_async_wait<0>();
}

template <typename T, int KMAX, bool EXACT, bool VEC>
__global__ void __launch_bounds__(RAPTOR_THREADS)
dia_tiles_kernel(const T* __restrict__ data, const float* __restrict__ x,
                 const float* __restrict__ hl, const float* __restrict__ hr,
                 float* __restrict__ y, int64_t n, int64_t len_l,
                 int64_t len_r, int batch, const __grid_constant__ TilePlan p) {
  dia_tiles<T, KMAX, EXACT, VEC>(data, x, hl, hr, y, n, len_l, len_r, batch,
                                 p);
}

// the same body held to 128 registers, so that two blocks share an SM
// (stating a minimum of one block instead changes ptxas's register choice
// for the other counts, which is why this is a kernel of its own)
template <typename T, int KMAX, bool EXACT, bool VEC>
__global__ void __launch_bounds__(RAPTOR_THREADS, 2)
dia_tiles_kernel_2(const T* __restrict__ data, const float* __restrict__ x,
                   const float* __restrict__ hl, const float* __restrict__ hr,
                   float* __restrict__ y, int64_t n, int64_t len_l,
                   int64_t len_r, int batch,
                   const __grid_constant__ TilePlan p) {
  dia_tiles<T, KMAX, EXACT, VEC>(data, x, hl, hr, y, n, len_l, len_r, batch,
                                 p);
}

// the rolling loads (27 offsets) take two blocks per SM, the rest one
template <typename T, int KMAX, bool EXACT, bool VEC>
constexpr auto tiles_kernel() {
  if constexpr (VEC && EXACT && KMAX > 16) {
    return dia_tiles_kernel_2<T, KMAX, EXACT, VEC>;
  } else {
    return dia_tiles_kernel<T, KMAX, EXACT, VEC>;
  }
}

template <typename T, int KMAX, bool EXACT, bool VEC>
cudaError_t launch_tiles_as(const T* data, const float* x, const float* hl,
                            const float* hr, float* y, int64_t n,
                            int64_t len_l, int64_t len_r, int batch,
                            const TilePlan& p, cudaStream_t stream) {
  auto kern = tiles_kernel<T, KMAX, EXACT, VEC>();
  constexpr int R = 16 / sizeof(T);
  const int threads = p.tile / R;
  const int smem = 2 * p.stage * static_cast<int>(sizeof(float));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  // above 48 KB a block's shared memory must be allowed first: once per
  // kernel and device, before any launch (so never inside a graph capture
  // that the first, eager call did not precede)
  static bool smem_allowed[RAPTOR_MAX_DEVICES] = {};
  if (dev < 0 || dev >= RAPTOR_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!smem_allowed[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             RAPTOR_SMEM_MAX);
    if (e != cudaSuccess) return e;
    smem_allowed[dev] = true;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t tiles = (n + p.tile - 1) / p.tile * batch;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const int64_t blocks = tiles < resident ? tiles : resident;
  kern<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      data, x, hl, hr, y, n, len_l, len_r, batch, p);
  return cudaGetLastError();
}

template <typename T>
int launch_tiles(const void* data, const void* x, const void* hl,
                 const void* hr, void* y, int64_t n, int64_t len_l,
                 int64_t len_r, int batch, const int* lins, int n_off,
                 int tile, int n_band, const int* band_lo,
                 const int* band_win, const int* band_of, int vec,
                 void* stream) {
  constexpr int R = 16 / sizeof(T);
  TilePlan p;
  if (n < 1 || n >= (int64_t(1) << 31) || batch < 1 || len_l < 0 ||
      len_r < 0 ||
      make_plan(&p, lins, n_off, tile, R, n_band, band_lo, band_win,
                band_of) != 0 ||
      (vec && (n % R != 0 ||
               (reinterpret_cast<uintptr_t>(data) & 15) != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* d = static_cast<const T*>(data);
  const float* xp = static_cast<const float*>(x);
  const float* hlp = static_cast<const float*>(hl);
  const float* hrp = static_cast<const float*>(hr);
  float* yp = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (!vec) {
    e = launch_tiles_as<T, RAPTOR_MAX_OFF, false, false>(
        d, xp, hlp, hrp, yp, n, len_l, len_r, batch, p, s);
  } else {
    switch (n_off) {
      case 3:
        e = launch_tiles_as<T, 3, true, true>(d, xp, hlp, hrp, yp, n, len_l,
                                              len_r, batch, p, s);
        break;
      case 7:
        e = launch_tiles_as<T, 7, true, true>(d, xp, hlp, hrp, yp, n, len_l,
                                              len_r, batch, p, s);
        break;
      case 15:
        e = launch_tiles_as<T, 15, true, true>(d, xp, hlp, hrp, yp, n, len_l,
                                               len_r, batch, p, s);
        break;
      case 27:
        e = launch_tiles_as<T, 27, true, true>(d, xp, hlp, hrp, yp, n, len_l,
                                               len_r, batch, p, s);
        break;
      default:
        e = launch_tiles_as<T, RAPTOR_MAX_OFF, false, true>(
            d, xp, hlp, hrp, yp, n, len_l, len_r, batch, p, s);
        break;
    }
  }
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// K1 (and K1v1).  The plan (tile, bands) comes from the wrapper's
// tile_plan: band_lo[b] and band_win[b] for each of n_band bands,
// band_of[k] for each offset; vec asks for 16-byte plane loads.
int raptor_dia_planes_f32(const void* data, const void* x, void* y, int64_t n,
                          int batch, const int* lins, int n_off, int tile,
                          int n_band, const int* band_lo, const int* band_win,
                          const int* band_of, int vec, void* stream) {
  return launch_tiles<float>(data, x, nullptr, nullptr, y, n, 0, 0, batch,
                             lins, n_off, tile, n_band, band_lo, band_win,
                             band_of, vec, stream);
}

int raptor_dia_planes_bf16(const void* data, const void* x, void* y, int64_t n,
                           int batch, const int* lins, int n_off, int tile,
                           int n_band, const int* band_lo,
                           const int* band_win, const int* band_of, int vec,
                           void* stream) {
  return launch_tiles<__nv_bfloat16>(data, x, nullptr, nullptr, y, n, 0, 0,
                                     batch, lins, n_off, tile, n_band,
                                     band_lo, band_win, band_of, vec, stream);
}

// K3: halo_left holds len_l values, halo_right len_r (either may be 0).
int raptor_dia_halo_f32(const void* data, const void* x, const void* halo_left,
                        const void* halo_right, void* y, int64_t nl,
                        int64_t len_l, int64_t len_r, const int* lins,
                        int n_off, int tile, int n_band, const int* band_lo,
                        const int* band_win, const int* band_of, int vec,
                        void* stream) {
  return launch_tiles<float>(data, x, halo_left, halo_right, y, nl, len_l,
                             len_r, 1, lins, n_off, tile, n_band, band_lo,
                             band_win, band_of, vec, stream);
}

int raptor_dia_halo_bf16(const void* data, const void* x,
                         const void* halo_left, const void* halo_right,
                         void* y, int64_t nl, int64_t len_l, int64_t len_r,
                         const int* lins, int n_off, int tile, int n_band,
                         const int* band_lo, const int* band_win,
                         const int* band_of, int vec, void* stream) {
  return launch_tiles<__nv_bfloat16>(data, x, halo_left, halo_right, y, nl,
                                     len_l, len_r, 1, lins, n_off, tile,
                                     n_band, band_lo, band_win, band_of, vec,
                                     stream);
}

}  // extern "C"
