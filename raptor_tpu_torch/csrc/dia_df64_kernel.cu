// K7, the df64 DIA residual, for NVIDIA Hopper (sm_90a).
//
// Plain C interface, built by nvcc into the same shared library as the
// other kernels and loaded with ctypes (raptor_tpu_torch/ops/cuda/build.py,
// dia_kernel.py).  The entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() (or the error of the
// call that refused the launch) so the wrapper can raise.
//
// Rounding: every product and sum is df64.cuh's, each rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn), in the plain version's order, so
// nvcc cannot contract a pair into an FMA: the error-free transformations
// stay exact and the kernel agrees with its plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "df64.cuh"
#include "dia_tiles.cuh"
#include "hopper_copy.cuh"

namespace {

// ---------------------------------------------------------------------------
// K7: the compensated (double-float32) residual of a DIA operator.
//
// The structured engine's refinement residual
// (raptor_tpu_torch/structured/dia.py::dia_df64_residual_ref):
//   (rh, rl) = (bh, bl); for each offset k in order, with a = plane k at
//   row i and (gh, gl) = (xh, xl)[i + lin_k]:
//     (ph, pe) = two_prod(a, gh);  pe = pe + a * gl;
//     (rh, rl) = df_add(rh, rl, -ph, -pe).
// Two forms.  The planes form reads plane k (fp32, boundary-zeroed) as K1
// does.  The const form synthesizes it as K2 does, c_k where the neighbour
// stays on the grid and 0 elsewhere, with c_k split into (hi, lo) once on
// the host; it reads only xh, xl, bh and bl.  Out-of-grid terms are
// computed like the rest, with a = 0: the windows hold 0 outside [0, n)
// where the plain version's roll wraps, so such a term is a product with 0
// either way and can differ from it in the sign of a zero only.
//
// Bound: device-memory bytes, 24 a row (xh, xl, bh, bl in; rh, rl out),
// plus 4 a row and offset in the planes form: 3.2 GB at 512^3 const.  The
// arithmetic is near it: some 27 rounded operations a row and offset
// (about 190 a row at 7 offsets), so the kernel must not add many
// instructions of its own.
//
// Design: the tiled DIA kernel's (dia_kernel.cu), with xh and xl staged
// side by side.  A block owns a tile of rows and a thread four consecutive
// rows; each offset band's windows of xh and of xl are copied once per
// tile by cp.async (zeros outside [0, n)), two stages over persistent
// blocks, so tile t + 1's windows are in flight while tile t computes.
// bh and bl are read once per row by 16-byte loads (the rows' (rh, rl)
// start there), the planes by 16-byte loads G offsets ahead of their term.
// The const form tests the grid before the block waits for its windows,
// as K2 does: where the last dimension is a multiple of four a thread's
// rows share every other coordinate (one coordinate chain per thread and
// tile; the last dimension tested only in rows within the offsets' reach
// of its ends), else each row's chain sets a bit per offset, so a term
// tests one bit.  n_off is a template argument for 7 and 27, with a
// generic body up to 32.
// ---------------------------------------------------------------------------

constexpr int R = 4;       // rows per thread
constexpr int PLANE_G = 4;  // plane loads in flight ahead of their term

// K7's stencil in the const form: K2's, with each c_k split as split(c_k)
struct Df64Stencil {
  ConstStencil st;
  float hi[RAPTOR_MAX_OFF];
  float lo[RAPTOR_MAX_OFF];
  // how far the offsets reach below and above a row along the last
  // dimension: rows farther from its ends keep every neighbour there
  int reach_lo, reach_hi;
};

// one tile's windows of one vector into buf: window b holds x's elements
// from the 16-byte boundary at or below row0 + lo[b], 0 outside [0, n)
__device__ __forceinline__ void stage_vector(float* buf, const float* x,
                                             int64_t n, int64_t row0,
                                             const TilePlan& p) {
  const int xmis = misalign4(x);
  for (int b = 0; b < p.n_band; ++b) {
    const int64_t j0 = row0 + p.lo[b];
    stage_window(buf + p.base[b], x, n, j0 - ((xmis + j0) & 3),
                 p.win[b] >> 2);
  }
}

// the R rows of v from row: one 16-byte load where the rows lie in [0, n)
// and the address allows, else element by element (0 past n)
__device__ __forceinline__ void load_rows(const float* v, int64_t row,
                                          int64_t n, float (&out)[R]) {
  const float* s = v + row;
  if (row + R <= n && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
    const uint4 q = ld_plane(s);
    out[0] = __uint_as_float(q.x);
    out[1] = __uint_as_float(q.y);
    out[2] = __uint_as_float(q.z);
    out[3] = __uint_as_float(q.w);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] = row + r < n ? s[r] : 0.0f;
  }
}

__device__ __forceinline__ void store_rows(float* v, int64_t row, int64_t n,
                                           const float (&in)[R]) {
  float* d = v + row;
  if (row + R <= n && (reinterpret_cast<uintptr_t>(d) & 15) == 0) {
    *reinterpret_cast<float4*>(d) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row + r < n) d[r] = in[r];
    }
  }
}

// CONST: planes synthesized; else VEC says the planes take 16-byte loads
template <int KMAX, bool EXACT, bool CONST, bool VEC>
__global__ void __launch_bounds__(RAPTOR_THREADS)
dia_df64_kernel(const float* __restrict__ data, const float* __restrict__ xh,
                const float* __restrict__ xl, const float* __restrict__ bh,
                const float* __restrict__ bl, float* __restrict__ rh,
                float* __restrict__ rl, int64_t n,
                const __grid_constant__ TilePlan p,
                const __grid_constant__ Df64Stencil cs) {
  constexpr int LAST = RAPTOR_MAX_DIMS - 1;
  constexpr bool ROLL = !CONST && VEC;
  extern __shared__ float4 df64_smem4[];
  float* smem = reinterpret_cast<float*>(df64_smem4);
  const ConstStencil& st = cs.st;
  const int n_off = EXACT ? KMAX : p.n_off;
  const int64_t n_tiles = (n + p.tile - 1) / p.tile;
  const int r0 = threadIdx.x * R;
  const int mis_h = misalign4(xh), mis_l = misalign4(xl);
  const int d_last = st.dims[LAST];

  int64_t t = blockIdx.x;
  stage_vector(smem, xh, n, t * p.tile, p);
  stage_vector(smem + p.stage, xl, n, t * p.tile, p);
  cp_async_commit();
  int s = 0;
  for (; t < n_tiles; t += gridDim.x) {
    const int64_t tn = t + gridDim.x;
    if (tn < n_tiles) {
      float* next = smem + (s ^ 1) * 2 * p.stage;
      stage_vector(next, xh, n, tn * p.tile, p);
      stage_vector(next + p.stage, xl, n, tn * p.tile, p);
    }
    cp_async_commit();  // possibly empty: keeps wait_group 1 exact

    const int64_t row = t * p.tile + r0;
    const bool active = row < n;
    float sh[R], se[R];
    // const form: bit k of okr[r] says that row + r's neighbour k is on
    // the grid
    unsigned okr[R] = {};
    uint4 pv[ROLL ? KMAX : 1];
    if (active) {
      load_rows(bh, row, n, sh);
      load_rows(bl, row, n, se);
      if constexpr (CONST) {
        int c[RAPTOR_MAX_DIMS];
        if (st.share) {
          // one chain: the rows share every coordinate but the last, and
          // only rows within reach of an end of the last dimension test it
          grid_coords(static_cast<unsigned>(row), st, c);
          unsigned outer = 0;
#pragma unroll
          for (int k = 0; k < KMAX; ++k) {
            if (EXACT || k < n_off) {
              bool in = true;
#pragma unroll
              for (int a = 0; a < LAST; ++a) {
                in = in && in_dim(c[a] + st.off[k][a], st.dims[a]);
              }
              outer |= (in ? 1u : 0u) << k;
            }
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int q = c[LAST] + r;
            okr[r] = outer;
            if (q < cs.reach_lo || q >= d_last - cs.reach_hi) {
#pragma unroll
              for (int k = 0; k < KMAX; ++k) {
                if ((EXACT || k < n_off) &&
                    !in_dim(q + st.off[k][LAST], d_last)) {
                  okr[r] &= ~(1u << k);
                }
              }
            }
          }
        } else {
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
                okr[r] |= (in ? 1u : 0u) << k;
              }
            }
          }
        }
      } else if constexpr (ROLL) {
#pragma unroll
        for (int k = 0; k < (PLANE_G < KMAX ? PLANE_G : KMAX); ++k) {
          if (EXACT || k < n_off) {
            pv[k] = ld_plane(data + static_cast<int64_t>(k) * n + row);
          }
        }
      }
    }
    cp_async_wait<1>();
    __syncthreads();

    if (active) {
      const float* wh = smem + s * 2 * p.stage + r0;
      const float* wl = wh + p.stage;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if constexpr (ROLL) {
          if (k + PLANE_G < KMAX && (EXACT || k + PLANE_G < n_off)) {
            pv[k + PLANE_G] = ld_plane(
                data + static_cast<int64_t>(k + PLANE_G) * n + row);
          }
        }
        if (EXACT || k < n_off) {
          float a[R], ah[R], al[R];
          if constexpr (CONST) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const bool in = ((okr[r] >> k) & 1u) != 0;
              a[r] = in ? st.c[k] : 0.0f;
              ah[r] = in ? cs.hi[k] : 0.0f;
              al[r] = in ? cs.lo[k] : 0.0f;
            }
          } else {
            if constexpr (ROLL) {
              a[0] = __uint_as_float(pv[k].x);
              a[1] = __uint_as_float(pv[k].y);
              a[2] = __uint_as_float(pv[k].z);
              a[3] = __uint_as_float(pv[k].w);
            } else {
              const float* dk = data + static_cast<int64_t>(k) * n + row;
#pragma unroll
              for (int r = 0; r < R; ++r) a[r] = row + r < n ? dk[r] : 0.0f;
            }
#pragma unroll
            for (int r = 0; r < R; ++r) split(a[r], ah[r], al[r]);
          }
          float gh[R], gl[R];
          window_read<R>(wh, p.koff[k] + ((mis_h + p.klo[k]) & 3), gh);
          window_read<R>(wl, p.koff[k] + ((mis_l + p.klo[k]) & 3), gl);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float ph, pe;
            two_prod_split(a[r], ah[r], al[r], gh[r], ph, pe);
            pe = __fadd_rn(pe, __fmul_rn(a[r], gl[r]));
            df_add(sh[r], se[r], -ph, -pe, sh[r], se[r]);
          }
        }
      }
      store_rows(rh, row, n, sh);
      store_rows(rl, row, n, se);
    }
    __syncthreads();  // the stage just read is the next iteration's target
    s ^= 1;
  }
  cp_async_wait<0>();
}

template <int KMAX, bool EXACT, bool CONST, bool VEC>
cudaError_t launch_df64_as(const float* data, const float* xh,
                           const float* xl, const float* bh, const float* bl,
                           float* rh, float* rl, int64_t n, const TilePlan& p,
                           const Df64Stencil& cs, cudaStream_t stream) {
  auto kern = dia_df64_kernel<KMAX, EXACT, CONST, VEC>;
  const int threads = p.tile / R;
  const int smem = 4 * p.stage * static_cast<int>(sizeof(float));
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
  const int64_t tiles = (n + p.tile - 1) / p.tile;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const int64_t blocks = tiles < resident ? tiles : resident;
  kern<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      data, xh, xl, bh, bl, rh, rl, n, p, cs);
  return cudaGetLastError();
}

template <bool CONST, bool VEC>
cudaError_t launch_df64(int n_off, const float* data, const float* xh,
                        const float* xl, const float* bh, const float* bl,
                        float* rh, float* rl, int64_t n, const TilePlan& p,
                        const Df64Stencil& cs, cudaStream_t stream) {
  if constexpr (VEC || CONST) {
    if (n_off == 7) {
      return launch_df64_as<7, true, CONST, VEC>(data, xh, xl, bh, bl, rh,
                                                 rl, n, p, cs, stream);
    }
    if (n_off == 27) {
      return launch_df64_as<27, true, CONST, VEC>(data, xh, xl, bh, bl, rh,
                                                  rl, n, p, cs, stream);
    }
  }
  return launch_df64_as<RAPTOR_MAX_OFF, false, CONST, VEC>(
      data, xh, xl, bh, bl, rh, rl, n, p, cs, stream);
}

}  // namespace

extern "C" {

// K7.  data: the (n_off, n) fp32 planes, or null for the const form, which
// takes the stencil instead (dims: nd ints; offs: n_off * nd ints,
// row-major; consts: n_off floats).  The plan (tile, bands) comes from the
// wrapper's tile plan for the linear offsets, four rows a thread and two
// vectors staged; vec asks for 16-byte plane loads.
int raptor_dia_df64_f32(const void* data, const void* xh, const void* xl,
                        const void* bh, const void* bl, void* rh, void* rl,
                        int64_t n, const int* dims, int nd, const int* offs,
                        const float* consts, const int* lins, int n_off,
                        int tile, int n_band, const int* band_lo,
                        const int* band_win, const int* band_of, int vec,
                        void* stream) {
  TilePlan p;
  if (n < 1 || n >= (int64_t(1) << 31) ||
      make_plan(&p, lins, n_off, tile, R, n_band, band_lo, band_win,
                band_of) != 0 ||
      4 * static_cast<int64_t>(p.stage) * 4 > RAPTOR_SMEM_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Df64Stencil cs;
  memset(&cs, 0, sizeof(cs));
  const bool is_const = data == nullptr;
  if (is_const) {
    if (make_stencil(&cs.st, n, dims, nd, offs, consts, n_off, R) != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    // split(c_k) on the host: the top 12 significant bits, and the exact
    // remainder
    for (int k = 0; k < n_off; ++k) {
      uint32_t bits;
      memcpy(&bits, &cs.st.c[k], sizeof(bits));
      bits &= 0xFFFFF000u;
      memcpy(&cs.hi[k], &bits, sizeof(bits));
      cs.lo[k] = cs.st.c[k] - cs.hi[k];
      const int o = cs.st.off[k][RAPTOR_MAX_DIMS - 1];
      cs.reach_lo = o < -cs.reach_lo ? -o : cs.reach_lo;
      cs.reach_hi = o > cs.reach_hi ? o : cs.reach_hi;
    }
  } else if (vec && (n % R != 0 ||
                     (reinterpret_cast<uintptr_t>(data) & 15) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* d = static_cast<const float*>(data);
  const float* xhp = static_cast<const float*>(xh);
  const float* xlp = static_cast<const float*>(xl);
  const float* bhp = static_cast<const float*>(bh);
  const float* blp = static_cast<const float*>(bl);
  float* rhp = static_cast<float*>(rh);
  float* rlp = static_cast<float*>(rl);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_const) {
    e = launch_df64<true, false>(n_off, d, xhp, xlp, bhp, blp, rhp, rlp, n,
                                 p, cs, s);
  } else if (vec) {
    e = launch_df64<false, true>(n_off, d, xhp, xlp, bhp, blp, rhp, rlp, n,
                                 p, cs, s);
  } else {
    e = launch_df64<false, false>(n_off, d, xhp, xlp, bhp, blp, rhp, rlp, n,
                                  p, cs, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
