// What the DIA kernels' sources share: the limits, the tiled kernels' plan
// (TilePlan) and its host-side check (make_plan), the window read, and the
// constant stencil whose planes K2 and K7 synthesize (ConstStencil, its
// host-side check make_stencil, and the rows' grid coordinates).
// dia_kernel.cu holds K1, K1v1 and K3, dia_const_kernel.cu K2,
// dia_df64_kernel.cu K7; nvcc builds them side by side.  Everything lies in
// an unnamed namespace, so each source gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RAPTOR_MAX_OFF 32
#define RAPTOR_THREADS 256
// shared memory a block may take on Hopper (227 KB)
#define RAPTOR_SMEM_MAX 232448
// floats a window holds beyond tile + span: the 16-byte round-down of its
// start (up to 3) and the last thread's extra float4 read (up to 4)
#define RAPTOR_WIN_SLACK 7
#define RAPTOR_MAX_DEVICES 64
#define RAPTOR_MAX_DIMS 4

namespace {

// The tiled kernel's plan, built on the host from the wrapper's bands
// (ops/cuda/dia_kernel.py::tile_plan).  A stage of shared memory holds one
// window per band, window b at floats [base[b], base[b] + win[b]); offset k
// reads its band's window from float koff[k] (+ the 16-byte remainder of
// the window's start, which depends on x's address and klo[k]).
struct TilePlan {
  int n_off;
  int n_band;
  int tile;   // rows per tile
  int stage;  // floats per stage (sum of win)
  int koff[RAPTOR_MAX_OFF];  // base[band] + lin_k - lo[band]
  int klo[RAPTOR_MAX_OFF];   // lo[band] of offset k
  int lo[RAPTOR_MAX_OFF];    // a band's least linear offset
  int base[RAPTOR_MAX_OFF];
  int win[RAPTOR_MAX_OFF];
};

// Fill and check a TilePlan from the wrapper's bands: every offset's reads
// must stay inside its band's window, and two stages inside a block's
// shared memory.
int make_plan(TilePlan* p, const int* lins, int n_off, int tile, int rows,
              int n_band, const int* band_lo, const int* band_win,
              const int* band_of) {
  if (n_off < 1 || n_off > RAPTOR_MAX_OFF || n_band < 1 || n_band > n_off ||
      tile < rows || tile % rows != 0 || tile / rows > RAPTOR_THREADS) {
    return 1;
  }
  p->n_off = n_off;
  p->n_band = n_band;
  p->tile = tile;
  int64_t stage = 0;
  for (int b = 0; b < n_band; ++b) {
    if (band_win[b] < tile || band_win[b] % 4 != 0) return 1;
    p->lo[b] = band_lo[b];
    p->base[b] = static_cast<int>(stage);
    p->win[b] = band_win[b];
    stage += band_win[b];
  }
  if (2 * stage * static_cast<int64_t>(sizeof(float)) > RAPTOR_SMEM_MAX) {
    return 1;
  }
  p->stage = static_cast<int>(stage);
  for (int k = 0; k < n_off; ++k) {
    const int b = band_of[k];
    if (b < 0 || b >= n_band) return 1;
    const int64_t d = static_cast<int64_t>(lins[k]) - band_lo[b];
    if (d < 0 || d + tile + RAPTOR_WIN_SLACK > band_win[b]) return 1;
    p->koff[k] = p->base[b] + static_cast<int>(d);
    p->klo[k] = band_lo[b];
  }
  return 0;
}

// R consecutive window floats from w + so; w is 16-byte aligned.  Aligned
// float4 reads (R / 4 + 1 of them) and a shift by so & 3, which is the same
// for the whole block, so the switch does not diverge.
template <int R>
__device__ __forceinline__ void window_read(const float* w, int so,
                                            float (&out)[R]) {
  const float4* w4 = reinterpret_cast<const float4*>(w + (so & ~3));
  float v[R + 4];
#pragma unroll
  for (int j = 0; j <= R / 4; ++j) {
    const float4 q = w4[j];
    v[4 * j] = q.x;
    v[4 * j + 1] = q.y;
    v[4 * j + 2] = q.z;
    v[4 * j + 3] = q.w;
  }
  switch (so & 3) {
    case 0:
#pragma unroll
      for (int i = 0; i < R; ++i) out[i] = v[i];
      break;
    case 1:
#pragma unroll
      for (int i = 0; i < R; ++i) out[i] = v[i + 1];
      break;
    case 2:
#pragma unroll
      for (int i = 0; i < R; ++i) out[i] = v[i + 2];
      break;
    default:
#pragma unroll
      for (int i = 0; i < R; ++i) out[i] = v[i + 3];
      break;
  }
}

// A constant stencil (K2, K7).  The grid's dimensions fill the last entries
// of ``dims`` (the leading ones are 1, with offset 0), so the kernels always
// walk RAPTOR_MAX_DIMS of them.
struct ConstStencil {
  int dims[RAPTOR_MAX_DIMS];
  int share;  // a thread's rows share every coordinate but the last
  short off[RAPTOR_MAX_OFF][RAPTOR_MAX_DIMS];
  float c[RAPTOR_MAX_OFF];
};

// Fill and check a ConstStencil: nd (1 to RAPTOR_MAX_DIMS) dims whose
// product is n, n_off offsets of nd steps each (row-major in offs, each
// step within 16 bits), and a thread's ``rows`` rows sharing every
// coordinate but the last where the last dimension is a multiple of rows.
int make_stencil(ConstStencil* st, int64_t n, const int* dims, int nd,
                 const int* offs, const float* consts, int n_off, int rows) {
  if (nd < 1 || nd > RAPTOR_MAX_DIMS || n_off < 1 || n_off > RAPTOR_MAX_OFF) {
    return 1;
  }
  const int lead = RAPTOR_MAX_DIMS - nd;
  int64_t cells = 1;
  for (int a = 0; a < RAPTOR_MAX_DIMS; ++a) {
    st->dims[a] = a < lead ? 1 : dims[a - lead];
    if (st->dims[a] < 1) return 1;
    cells *= st->dims[a];
    if (cells > n) return 1;
  }
  if (cells != n) return 1;
  st->share = st->dims[RAPTOR_MAX_DIMS - 1] % rows == 0;
  for (int k = 0; k < RAPTOR_MAX_OFF; ++k) {
    st->c[k] = k < n_off ? consts[k] : 0.0f;
    for (int a = 0; a < RAPTOR_MAX_DIMS; ++a) {
      const int o = (k < n_off && a >= lead) ? offs[k * nd + a - lead] : 0;
      if (o < -32768 || o > 32767) return 1;
      st->off[k][a] = static_cast<short>(o);
    }
  }
  return 0;
}

__device__ __forceinline__ bool in_dim(int c, int d) {
  return static_cast<unsigned>(c) < static_cast<unsigned>(d);
}

// grid coordinates of a row (32-bit: n < 2^31), last dimension fastest
__device__ __forceinline__ void grid_coords(unsigned row,
                                            const ConstStencil& st,
                                            int (&c)[RAPTOR_MAX_DIMS]) {
#pragma unroll
  for (int a = RAPTOR_MAX_DIMS - 1; a > 0; --a) {
    const unsigned d = static_cast<unsigned>(st.dims[a]);
    const unsigned q = row / d;
    c[a] = static_cast<int>(row - q * d);
    row = q;
  }
  c[0] = static_cast<int>(row);
}


}  // namespace
