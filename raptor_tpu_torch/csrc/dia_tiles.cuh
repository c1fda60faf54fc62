// What the DIA kernels' sources share: the limits, the tiled kernels' plan
// (TilePlan) and its host-side check (make_plan).  dia_kernel.cu holds K1,
// K1v1 and K3, dia_const_kernel.cu holds K2; nvcc builds the two side by
// side.  Everything lies in an unnamed namespace, so each source gets its
// own copy.

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

}  // namespace
