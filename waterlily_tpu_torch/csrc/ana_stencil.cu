// Analytic far-field Poisson operator of a banded multigrid level:
// z = A x for the constant face coefficient c, with the wall faces (index 1
// and S-2 of a non-periodic axis) zero, and optionally <A x, x> over the
// interior.
//
// Replaces waterlily_tpu/ops/pallas_stencil.py `ana_mult3d_pallas`
// (`_ana_kernel`), f32 and whole-grid, periodic axes included (a per-axis
// flag: their faces are never zero and the caller fills x's ghosts).
//
// Bound on the H100: memory.  The operator reads no coefficient field: x in
// and z out, 8 B per cell against ~20 flops.  The first kernel (one thread
// per cell on 32 x 8 tiles of the whole array, every x value fetched seven
// times, the last tile of a 258 row running 2 of its 32 lanes, and the dot
// as ~67k block partials summed by a second launch, torch.sum) took 0.1384
// ms at 258^3 with the dot and 0.1016 without, against a 0.0410 ms bound.
// Design: the plane march of march.cuh.  A thread carries x at planes i-1,
// i and i+1 of its column in registers down its chunk (one new load a
// plane); the in-plane taps are the tile's neighbouring rows and lanes of
// plane i, loads that hit the lines the tile's own loads brought into L1 a
// plane earlier.  The face flags of axes 1 and 2 come from the index once
// a column, those of axis 0 once a plane.  z is written once: each
// interior cell by its thread, and the ghost cells as exact zeros by the
// threads of the interior cells next to them (march_ghosts; the first
// and last chunks also the ghost planes).  The dot accumulates in
// registers over the march, then over the block by warp shuffles; the last
// block sums the partials in index order: one launch, the same bits on
// every call.
// Exactness: the association is the TPU kernel's (t = lo0*x[i-1] +
// hi0*x[i+1] + ... left to right, nf = lo0+hi0+..., z = c*t - (c*nf)*x;
// nf is a sum of six 0/1 flags, exact in any order, so its axis-1 and -2
// part is summed once a column): built with --fmad=false it equals the
// plain version `_ana_mult3d_plain` bit for bit.
// Members (an ensemble's banded levels under torch.func.vmap, `ana_mult3d`'s
// member form): one launch marches every member's x with a one-member
// launch's chunks and gives each member its z and its own dot (march.cuh),
// equal to its own launch bit for bit.  c and the periodic axes are the
// level's, the same for every member.
#include "march.cuh"

// MB: the member-axis instance (march.cuh); x and z hold the members one
// after another, S0 * S1 * S2 values apart.
template <bool DOT, bool MB>
__global__ void __launch_bounds__(MARCH_THREADS)
ana_kernel(const float* __restrict__ x, float* __restrict__ z,
           float* partial, unsigned int* count, float* out, float c,
           int periodic, int S0, int S1, int S2, int planes) {
  __shared__ float sh[MARCH_THREADS / 32];
  const Column col = march_column<MB>(S0, S1, S2, planes);
  const int P = S1 * S2;
  if (MB) {
    const long long sm = (long long)col.m * S0 * P;
    x += sm;
    z += sm;
  }
  const auto zero = [z](int a) { z[a] = 0.f; };
  float dot = 0.f;
  if (col.in) {
    const int j = col.j, k = col.k;
    const bool jl = j == 1, jh = j == S1 - 2, kl = k == 1, kh = k == S2 - 2;
    const bool per0 = periodic & 1, per1 = (periodic >> 1) & 1,
               per2 = (periodic >> 2) & 1;
    const float lo1 = (per1 || !jl) ? 1.f : 0.f;
    const float hi1 = (per1 || !jh) ? 1.f : 0.f;
    const float lo2 = (per2 || !kl) ? 1.f : 0.f;
    const float hi2 = (per2 || !kh) ? 1.f : 0.f;
    const float nf12 = lo1 + hi1 + lo2 + hi2;
    const int cell = j * S2 + k;
    if (col.i0 == 1) {   // ghost plane 0
      z[cell] = 0.f;
      march_ghosts(cell, jl, jh, kl, kh, S2, zero);
    }
    int at = col.i0 * P + cell;
    float xm = x[at - P], xc = x[at];
#pragma unroll 4
    for (int i = col.i0; i < col.i1; ++i, at += P) {
      const float xp = x[at + P];
      const float lo0 = (per0 || i != 1) ? 1.f : 0.f;
      const float hi0 = (per0 || i != S0 - 2) ? 1.f : 0.f;
      float t = lo0 * xm;
      t = t + hi0 * xp;
      t = t + lo1 * x[at - S2];
      t = t + hi1 * x[at + S2];
      t = t + lo2 * x[at - 1];
      t = t + hi2 * x[at + 1];
      const float nf = (lo0 + hi0) + nf12;
      const float v = c * t - (c * nf) * xc;
      z[at] = v;
      march_ghosts(at, jl, jh, kl, kh, S2, zero);
      if (DOT) dot = dot + v * xc;
      xm = xc;
      xc = xp;
    }
    if (col.i1 == S0 - 1) {   // ghost plane S0-1 (at is its cell now)
      z[at] = 0.f;
      march_ghosts(at, jl, jh, kl, kh, S2, zero);
    }
  }
  if (DOT)
    march_finish<SumOp>(col, block_reduce<SumOp>(dot, 0.f, sh), 0.f,
                        partial, count, out, sh);
}

template <bool DOT>
static void ana_launch(dim3 grid, cudaStream_t s, bool members,
                       const float* x, float* z, float* partial,
                       unsigned int* count, float* out, float c, int periodic,
                       int S0, int S1, int S2, int planes) {
  const dim3 block(MARCH_TK, MARCH_TJ);
  if (members)
    ana_kernel<DOT, true><<<grid, block, 0, s>>>(
        x, z, partial, count, out, c, periodic, S0, S1, S2, planes);
  else
    ana_kernel<DOT, false><<<grid, block, 0, s>>>(
        x, z, partial, count, out, c, periodic, S0, S1, S2, planes);
}

// partial, count, out: NULL for z alone; else one float a block of a
// member's grid (`march_grid`), member after member, a zeroed counter a
// member (left zeroed) and each member's dot.  members: the fields at x,
// x + S0*S1*S2, ... and their z alike (one field: members 1).  Calls that
// share a counter run on one stream.
extern "C" int wl_ana_mult3d(const float* x, float* z, float* partial,
                             unsigned int* count, float* out, float c,
                             int periodic, int planes, int members, int S0,
                             int S1, int S2, void* stream) {
  if (!march_shape_ok(S0, S1, S2, planes, members))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = march_grid(S0, S1, S2, planes, members);
  const cudaStream_t s = (cudaStream_t)stream;
  if (partial != nullptr)
    ana_launch<true>(grid, s, members > 1, x, z, partial, count, out, c,
                     periodic, S0, S1, S2, planes);
  else
    ana_launch<false>(grid, s, members > 1, x, z, partial, count, out, c,
                      periodic, S0, S1, S2, planes);
  return (int)cudaGetLastError();
}
