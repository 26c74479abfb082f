// CFL flux-out reduction: the interior max of
// sum_i max(0, u_i[I+d_i]) + max(0, -u_i[I]).
//
// Replaces waterlily_tpu/ops/pallas_stencil.py `cfl3d_pallas` (`_cfl_kernel`).
//
// Bound on the H100: memory, 12 B/cell read (three velocity components) and
// a handful of flops.  The first kernel (one thread per cell with a 64-bit
// divide-based unflatten, the +d_0 tap a load from the next plane, a
// shared-memory tree max per 256 cells and a second launch, torch.amax, over
// the ~67k partials) took 0.1557 ms at 258^3, 0.40 of its 0.0615 ms bound.
// Design: the plane march of march.cuh.  A thread carries u_0 of plane i+1
// in a register to the next plane, so each u_0 is loaded once; the +d_1 and
// +d_2 taps are the neighbouring row's and lane's values of the same plane,
// loads that hit the lines the tile's own loads brought into L1.  The max
// runs in registers down the march, then over the block by warp shuffles;
// the last block takes the max of the partials: one launch per call.
// Exactness: every term is >= 0 (or NaN), max does not depend on order,
// and ghost cells never enter it, so the result equals the plain version
// exactly; the per-cell sum keeps waterlily_tpu.flow.cfl's association
// s = t0; s += t1; s += t2, and every max is PTX max.NaN (a NaN anywhere
// in the interior sums comes out, as in torch.max).
// Members (an ensemble under torch.func.vmap, `cfl3d`'s member form): one
// launch marches every member's field with a one-member launch's chunks
// and gives each member its own max (march.cuh), equal to its own launch.
#include "march.cuh"

// MB: the member-axis instance (march.cuh).
template <bool MB>
__global__ void __launch_bounds__(MARCH_THREADS)
cfl_kernel(const float* __restrict__ u, float* partial, unsigned int* count,
           float* out, int S0, int S1, int S2, int planes, long long su) {
  __shared__ float sh[MARCH_THREADS / 32];
  const Column c = march_column<MB>(S0, S1, S2, planes);
  const int P = S1 * S2, N = S0 * P;
  if (MB) u += c.m * su;
  const float* __restrict__ u0 = u;
  const float* __restrict__ u1 = u + N;
  const float* __restrict__ u2 = u + 2 * N;
  float m = 0.f;   // every term is >= 0: 0 is the max's identity
  if (c.in) {
    int at = c.i0 * P + c.j * S2 + c.k;
    float a0 = u0[at];
#pragma unroll 1   // unrolled by 4: 32 registers and 4% slower at 258^3
    for (int i = c.i0; i < c.i1; ++i, at += P) {
      const float n0 = u0[at + P];
      float s = tmax(0.f, n0) + tmax(0.f, -a0);
      s = s + (tmax(0.f, u1[at + S2]) + tmax(0.f, -u1[at]));
      s = s + (tmax(0.f, u2[at + 1]) + tmax(0.f, -u2[at]));
      m = tmax(m, s);
      a0 = n0;
    }
  }
  march_finish<MaxOp>(c, block_reduce<MaxOp>(m, 0.f, sh), 0.f, partial,
                      count, out, sh);
}

// partial: one float a block of a member's grid (`march_grid`), member
// after member; count: a zeroed counter a member (left zeroed); out: the
// max of each member.  members: the fields at u, u + su, u + 2 su, ...
// (one field and one max: members 1).  Calls that share a counter run on
// one stream.
extern "C" int wl_cfl3d(const float* u, float* partial, unsigned int* count,
                        float* out, int planes, int members, long long su,
                        int S0, int S1, int S2, void* stream) {
  if (!march_shape_ok(S0, S1, S2, planes, members))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = march_grid(S0, S1, S2, planes, members);
  const dim3 block(MARCH_TK, MARCH_TJ);
  const cudaStream_t s = (cudaStream_t)stream;
  if (members > 1)
    cfl_kernel<true><<<grid, block, 0, s>>>(u, partial, count, out, S0, S1,
                                            S2, planes, su);
  else
    cfl_kernel<false><<<grid, block, 0, s>>>(u, partial, count, out, S0, S1,
                                             S2, planes, su);
  return (int)cudaGetLastError();
}

// The march tile, (axis 1, axis 2) columns of a block, for the wrappers'
// grid sizing (ops/stencil_kernels.py `march_planes`).
extern "C" int wl_march_tile(int axis) {
  return axis == 1 ? MARCH_TJ : MARCH_TK;
}
