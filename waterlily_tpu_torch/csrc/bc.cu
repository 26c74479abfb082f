// Domain boundary conditions of a (3, S) velocity field in one sweep.
//
// Replaces waterlily_tpu/ops/pallas_stencil.py `bc3d_pallas` (`_bc_kernel`),
// whole grid, with its periodic and save_exit forms.
//
// Semantics (waterlily_tpu.ops.bc.bc_vector): for each component c the
// stages j = 0, 1, 2 run in order, each on the values the previous stage
// left.  Along a periodic axis (bit j of `periodic`) plane 0 copies plane
// S-2 and plane S-1 copies plane 1.  Otherwise, along the normal axis
// (j == c) planes 0, 1 and S-1 become A[c] (Dirichlet; with `save_exit`,
// component 0 keeps its plane S-1 along axis 0: the convective outlet);
// along a tangential axis plane 0 copies plane 1 and plane S-1 copies plane
// S-2 (zero Neumann).  Ghost corners depend on that order.
//
// Design: one thread per output cell composes the three stages by resolving
// its source backwards: stage 2 either yields A[c] or maps the axis-2 index
// to its source plane, then stage 1 the axis-1 index, then stage 0 the axis-0
// index; the thread then reads that one source value.  This is exactly the
// sequential order (a stage never modifies the planes it copies from), so
// the result equals the plane-update chain bit for bit, corners included.
// Bound on the H100: memory, one 4 B read and one 4 B write per value
// (24 B/cell for the three components), against the plane-update chain's
// full copy plus 21 plane passes.
#include "common.cuh"

// PER: bit a set for each periodic axis a; EXIT: save_exit.  Template
// arguments, so that each form compiles to its own straight-line code.
template <int PER, int EXIT>
__global__ void bc_kernel(const float* __restrict__ u, float* __restrict__ out,
                          const float* __restrict__ A, Shape3 g) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 3 * g.N) return;
  const int comp = (int)(t / g.N);
  int idx[3];
  unflatten(g, t - comp * g.N, idx);
#pragma unroll
  for (int a = 2; a >= 0; --a) {
    const int q = idx[a];
    const int hi = g.S[a] - 1;
    if ((PER >> a) & 1) {
      if (q == 0) {
        idx[a] = hi - 1;
      } else if (q == hi) {
        idx[a] = 1;
      }
    } else if (a == comp) {
      const bool kept = EXIT && comp == 0;  // the outlet plane
      if (q <= 1 || (q == hi && !kept)) {
        out[t] = A[comp];
        return;
      }
    } else if (q == 0) {
      idx[a] = 1;
    } else if (q == hi) {
      idx[a] = hi - 1;
    }
  }
  const long long src = idx[0] * g.st[0] + idx[1] * g.st[1] + idx[2];
  out[t] = u[comp * g.N + src];
}

#define WL_BC_FORM(F)                                                  \
  case F:                                                              \
    bc_kernel<((F) & 7), ((F) >> 3)><<<blocks, WL_THREADS, 0, s>>>(    \
        u, out, A, g);                                                 \
    break;

extern "C" int wl_bc3d(const float* u, float* out, const float* A,
                       int periodic, int save_exit, int S0, int S1, int S2,
                       void* stream) {
  const Shape3 g = make_shape(S0, S1, S2);
  const int blocks = blocks_for(3 * g.N);
  cudaStream_t s = (cudaStream_t)stream;
  switch (periodic | (save_exit ? 8 : 0)) {
    WL_BC_FORM(0) WL_BC_FORM(1) WL_BC_FORM(2) WL_BC_FORM(3)
    WL_BC_FORM(4) WL_BC_FORM(5) WL_BC_FORM(6) WL_BC_FORM(7)
    WL_BC_FORM(8) WL_BC_FORM(9) WL_BC_FORM(10) WL_BC_FORM(11)
    WL_BC_FORM(12) WL_BC_FORM(13) WL_BC_FORM(14) WL_BC_FORM(15)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
