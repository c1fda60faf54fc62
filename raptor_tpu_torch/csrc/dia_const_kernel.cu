// K2, the constant-coefficient DIA SpMV, for NVIDIA Hopper (sm_90a).
//
// Plain C interface, built by nvcc into the same shared library as
// dia_kernel.cu and banded_kernel.cu and loaded with ctypes
// (raptor_tpu_torch/ops/cuda/build.py, dia_kernel.py).  The entry point
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() (or the error of the call that refused the launch) so
// the wrapper can raise.
//
// K2 takes x of shape (batch, n) and walks the tiles and shared-memory
// windows of the tiled DIA kernel (dia_kernel.cu; the plan is
// dia_tiles.cuh's TilePlan) with its planes synthesized from the grid
// coordinates.
//
// Rounding: each term is rounded as the plain PyTorch version rounds it
// (__fmul_rn, then __fadd_rn, in the reference's offset order, the first
// term standing alone as the reference's sum starts), so nvcc cannot
// contract the pair into an FMA and the kernel agrees with its plain
// version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dia_tiles.cuh"
#include "hopper_copy.cuh"

namespace {

// ---------------------------------------------------------------------------
// K2: constant-coefficient DIA SpMV.
//
// Replaces raptor_tpu/ops/pallas/dia_kernel.py::_dia_pallas_call_const.
//   y[b, i] = sum_k c_k * [coord(i) + off_k inside dims] * x[b, i + lin_k]
// Plane k is c_k wherever the neighbour stays on the grid and 0 elsewhere,
// so the kernel builds it from the row's grid coordinates (as the TPU
// kernel does from its iota) and reads only x.  An in-grid neighbour always
// has 0 <= i + lin_k < n.  Each term is the plain version's: the
// synthesized plane value (c_k or 0) times x, summed in offset order, the
// first term standing alone; the windows hold x, or 0 outside [0, n), so
// an out-of-grid term is a product with 0.
//
// Bound: device-memory bytes, 4n for x and 4n for y per batch row (16.8 MB
// at 128^3, 134 MB at 256^3).  With so few bytes a row the instructions
// count: the kernel must stay near two per term.
//
// Design.  The kernel this replaces gave a thread one row, a runtime offset
// loop with a branch around each 4-byte x load, and a division and modulo
// per row and dimension: its loads waited on each other.  This one is the
// tiled kernel of dia_kernel.cu with the planes synthesized instead of
// loaded:
//   * a block owns a tile of rows, a thread R = 16 consecutive rows (8 or 4
//     on a grid whose last dimension is no multiple of 16 or 8, or too
//     small to give every SM a tile of such threads): what a thread does
//     once per tile (staging, the coordinates, the coefficients) costs more
//     instructions than its rows' sums; x is staged per offset band by
//     cp.async (stage_windows: zeros outside [0, n)), two stages over
//     persistent blocks.  At 128^3 the 7-point stencil's bands are
//     {-16384}, {-128 .. 128} and {+16384}: each x value comes from L2
//     about 3.3 times instead of 7 times through L1;
//   * the grid tests are made before the block waits for its windows.
//     Where the last dimension is a multiple of R a thread's rows share
//     every coordinate but the last: one division chain per thread and
//     tile, one coefficient per offset (c_k, or 0 where an outer coordinate
//     leaves the grid), and a compare per row only for the offsets that
//     move along the last dimension.  Any other grid takes the kernel's
//     per-row chain (R = 4), kept as 4 bits per offset;
//   * the sums have no branch and no load behind a test: every offset's
//     window read is unconditional and the plane value is a select;
//   * the windows are stored swizzled (swz4 below), so that threads of 8 or
//     16 rows read them without shared-memory bank conflicts;
//     an offset alone in its band (-+16384 at 128^3) is staged like the
//     rest: reading its rows straight from device memory, 16 bytes a load,
//     measured no faster (256^3: 80.0 against 73.1 us);
//   * n_off is a template argument for 3, 5, 7 and 27, with a generic body
//     up to 32; y takes 16-byte stores where its address allows.
// ---------------------------------------------------------------------------

// K2's shared-memory layout.  A thread of R consecutive rows reads float4s
// R / 4 apart from its neighbour's, so at R = 8 (16) the eight lanes of a
// quarter warp would meet only 4 (2) of the 8 16-byte bank groups.  The
// stage is therefore stored swizzled: float4 p of a stage lies at
// p ^ ((p >> 3) & (R / 4 - 1)), which sends those lanes to 8 different
// groups.  A stage is a multiple of 64 floats, so the swizzle stays inside
// it and every stage starts on a 128-byte line.
template <int SW>
__device__ __forceinline__ int swz4(int p) {
  if constexpr (SW == 0) {
    return p;
  } else {
    return p ^ ((p >> 3) & ((1 << SW) - 1));
  }
}

// stage_windows for K2: no halos, and the swizzled layout
template <int SW>
__device__ __forceinline__ void stage_windows_swz(float* buf, const float* xb,
                                                  int64_t n, int64_t row0,
                                                  const TilePlan& p) {
  const int xmis = misalign4(xb);
  for (int b = 0; b < p.n_band; ++b) {
    const int64_t j0 = row0 + p.lo[b];
    const int64_t a0 = j0 - ((xmis + j0) & 3);
    const int p0 = p.base[b] >> 2;
    const int chunks = p.win[b] >> 2;
    const int64_t lo = a0 >= 0 ? 0 : (-a0 + 3) >> 2;
    const int64_t hi = (n - a0) >> 2;
    const int c_lo = static_cast<int>(lo < chunks ? lo : chunks);
    const int c_hi =
        static_cast<int>(hi < c_lo ? c_lo : hi < chunks ? hi : chunks);
    for (int c = c_lo + threadIdx.x; c < c_hi; c += blockDim.x) {
      cp_async16(buf + 4 * swz4<SW>(p0 + c), xb + (a0 + 4 * c));
    }
    const int n_edge = c_lo + (chunks - c_hi);
    for (int i = threadIdx.x; i < n_edge; i += blockDim.x) {
      const int c = i < c_lo ? i : c_hi + (i - c_lo);
      const int64_t g = a0 + 4 * c;
      float* dst = buf + 4 * swz4<SW>(p0 + c);
      if (g + 4 <= 0 || g >= n) {
        *reinterpret_cast<float4*>(dst) = make_float4(0, 0, 0, 0);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t j = g + e;
        const bool ok = j >= 0 && j < n;
        cp_async4(dst + e, ok ? xb + j : xb, ok);
      }
    }
  }
}

// R consecutive floats from float ``4 * p4 + shift`` of a swizzled stage:
// R / 4 float4 reads, and one more only where shift != 0 (shift is the same
// for the whole block, so no branch diverges)
template <int R, int SW>
__device__ __forceinline__ void window_read_swz(const float4* stage, int p4,
                                                int shift, float (&out)[R]) {
  float v[R + 4];
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const float4 q = stage[swz4<SW>(p4 + j)];
    v[4 * j] = q.x;
    v[4 * j + 1] = q.y;
    v[4 * j + 2] = q.z;
    v[4 * j + 3] = q.w;
  }
  if (shift == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) out[i] = v[i];
    return;
  }
  const float4 q = stage[swz4<SW>(p4 + R / 4)];
  v[R] = q.x;
  v[R + 1] = q.y;
  v[R + 2] = q.z;
  v[R + 3] = q.w;
  if (shift == 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) out[i] = v[i + 1];
  } else if (shift == 2) {
#pragma unroll
    for (int i = 0; i < R; ++i) out[i] = v[i + 2];
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) out[i] = v[i + 3];
  }
}

template <int KMAX, bool EXACT, int R>
__global__ void __launch_bounds__(RAPTOR_THREADS)
dia_const_kernel(const float* __restrict__ x, float* __restrict__ y, int64_t n,
                 int batch, const __grid_constant__ TilePlan p,
                 const __grid_constant__ ConstStencil st) {
  constexpr int LAST = RAPTOR_MAX_DIMS - 1;
  constexpr int SW = R == 16 ? 2 : R == 8 ? 1 : 0;
  extern __shared__ __align__(128) float4 const_smem4[];
  float* smem = reinterpret_cast<float*>(const_smem4);
  const int n_off = EXACT ? KMAX : p.n_off;
  const int64_t per_row = (n + p.tile - 1) / p.tile;
  const int64_t n_tiles = per_row * batch;
  const int r0 = threadIdx.x * R;
  const int d_last = st.dims[LAST];

  int64_t t = blockIdx.x;
  {
    const int64_t b = batch == 1 ? 0 : t / per_row;
    stage_windows_swz<SW>(smem, x + b * n, n, (t - b * per_row) * p.tile, p);
  }
  cp_async_commit();
  int s = 0;
  for (; t < n_tiles; t += gridDim.x) {
    const int64_t tn = t + gridDim.x;
    if (tn < n_tiles) {
      const int64_t bn = batch == 1 ? 0 : tn / per_row;
      stage_windows_swz<SW>(smem + (s ^ 1) * p.stage, x + bn * n, n,
                            (tn - bn * per_row) * p.tile, p);
    }
    cp_async_commit();  // possibly empty: keeps wait_group 1 exact

    const int64_t b = batch == 1 ? 0 : t / per_row;
    const int64_t row = (t - b * per_row) * p.tile + r0;
    const bool active = row < n;
    // shared coordinates: ck[k] is c_k where offset k keeps the outer
    // coordinates on the grid, else 0; cl the first row's last coordinate.
    // Per-row coordinates (R = 4 only): bit r of nibble k says that row + r
    // has offset k's neighbour on the grid.
    float ck[KMAX];
    int cl = 0;
    unsigned ok[R == 4 ? (KMAX + 7) / 8 : 1] = {};
    if (active) {
      int c[RAPTOR_MAX_DIMS];
      if (R != 4 || st.share) {
        grid_coords(static_cast<unsigned>(row), st, c);
        cl = c[LAST];
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (EXACT || k < n_off) {
            bool outer = true;
#pragma unroll
            for (int a = 0; a < LAST; ++a) {
              outer = outer && in_dim(c[a] + st.off[k][a], st.dims[a]);
            }
            ck[k] = outer ? st.c[k] : 0.0f;
          }
        }
      } else if constexpr (R == 4) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          grid_coords(static_cast<unsigned>(row + r), st, c);
#pragma unroll
          for (int k = 0; k < KMAX; ++k) {
            if (EXACT || k < n_off) {
              bool in = true;
#pragma unroll
              for (int a = 0; a < RAPTOR_MAX_DIMS; ++a) {
                in = in && in_dim(c[a] + st.off[k][a], st.dims[a]);
              }
              ok[k / 8] |= (in ? 1u : 0u) << (4 * (k % 8) + r);
            }
          }
        }
      }
    }
    cp_async_wait<1>();
    __syncthreads();

    if (active) {
      const float* xb = x + b * n;
      const int xmis = misalign4(xb);
      const float4* stage =
          reinterpret_cast<const float4*>(smem + s * p.stage);
      const bool shared_coords = R != 4 || st.share;
      float acc[R];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (EXACT || k < n_off) {
          float xv[R];
          const int so = p.koff[k] + ((xmis + p.klo[k]) & 3);
          window_read_swz<R, SW>(stage, (r0 + (so & ~3)) >> 2, so & 3, xv);
          float pk[R];
          if (shared_coords) {
            const int o_last = st.off[k][LAST];
            if (o_last == 0) {
#pragma unroll
              for (int r = 0; r < R; ++r) pk[r] = ck[k];
            } else {
#pragma unroll
              for (int r = 0; r < R; ++r) {
                pk[r] = in_dim(cl + o_last + r, d_last) ? ck[k] : 0.0f;
              }
            }
          } else if constexpr (R == 4) {
            const unsigned bits = ok[k / 8] >> (4 * (k % 8));
            const float c_k = st.c[k];
#pragma unroll
            for (int r = 0; r < R; ++r) pk[r] = ((bits >> r) & 1u) ? c_k : 0.0f;
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float term = __fmul_rn(pk[r], xv[r]);
            acc[r] = k == 0 ? term : __fadd_rn(acc[r], term);
          }
        }
      }
      float* yr = y + b * n + row;
      if (row + R <= n && (reinterpret_cast<uintptr_t>(yr) & 15) == 0) {
#pragma unroll
        for (int r = 0; r < R; r += 4) {
          *reinterpret_cast<float4*>(yr + r) =
              make_float4(acc[r], acc[r + 1], acc[r + 2], acc[r + 3]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (row + r < n) yr[r] = acc[r];
        }
      }
    }
    __syncthreads();  // the stage just read is the next iteration's target
    s ^= 1;
  }
  cp_async_wait<0>();
}

template <int KMAX, bool EXACT, int R>
cudaError_t launch_const_as(const float* x, float* y, int64_t n, int batch,
                            const TilePlan& p, const ConstStencil& st,
                            cudaStream_t stream) {
  auto kern = dia_const_kernel<KMAX, EXACT, R>;
  const int threads = p.tile / R;
  const int smem = 2 * p.stage * static_cast<int>(sizeof(float));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  // as launch_tiles_as: allow more than 48 KB once per kernel and device
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
  kern<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(x, y, n,
                                                                 batch, p, st);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K2.  offs: n_off * nd ints, row-major (offset k, dimension a); the plan
// (tile, bands) comes from the wrapper's tile_plan for the stencil's linear
// offsets, with ``rows`` (4, 8 or 16) rows per thread; 8 and 16 need a last
// dimension that is a multiple of them.
int raptor_dia_const_f32(const void* x, void* y, int64_t n, int batch,
                         const int* dims, int nd, const int* offs,
                         const int* lins, const float* consts, int n_off,
                         int rows, int tile, int n_band, const int* band_lo,
                         const int* band_win, const int* band_of,
                         void* stream) {
  TilePlan p;
  if (n < 1 || n >= (int64_t(1) << 31) || nd < 1 || nd > RAPTOR_MAX_DIMS ||
      batch < 1 || (rows != 4 && rows != 8 && rows != 16) ||
      make_plan(&p, lins, n_off, tile, rows, n_band, band_lo, band_win,
                band_of) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // whole swizzle groups and 128-byte lines per stage
  p.stage = (p.stage + 63) & ~63;
  if (2 * static_cast<int64_t>(p.stage) * 4 > RAPTOR_SMEM_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ConstStencil st;
  if (make_stencil(&st, n, dims, nd, offs, consts, n_off, rows) != 0 ||
      (rows != 4 && !st.share)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s_ = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
#define RAPTOR_CONST_CASE(K, E)                                            \
  (rows == 16  ? launch_const_as<K, E, 16>(xp, yp, n, batch, p, st, s_)    \
   : rows == 8 ? launch_const_as<K, E, 8>(xp, yp, n, batch, p, st, s_)     \
               : launch_const_as<K, E, 4>(xp, yp, n, batch, p, st, s_))
  cudaError_t e;
  switch (n_off) {
    case 3: e = RAPTOR_CONST_CASE(3, true); break;
    case 5: e = RAPTOR_CONST_CASE(5, true); break;
    case 7: e = RAPTOR_CONST_CASE(7, true); break;
    case 27: e = RAPTOR_CONST_CASE(27, true); break;
    default: e = RAPTOR_CONST_CASE(RAPTOR_MAX_OFF, false); break;
  }
#undef RAPTOR_CONST_CASE
  return static_cast<int>(e);
}

}  // extern "C"
