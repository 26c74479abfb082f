// Domain boundary conditions of a (3, S) velocity field in one sweep.
//
// Replaces waterlily_tpu/ops/pallas_stencil.py `bc3d_pallas` (`_bc_kernel`),
// non-periodic, without save_exit, whole grid.
//
// Semantics (waterlily_tpu.ops.bc.bc_vector): for each component c the
// stages j = 0, 1, 2 run in order, each on the values the previous stage
// left.  Along the normal axis (j == c) planes 0, 1 and S-1 become A[c]
// (Dirichlet); along a tangential axis plane 0 copies plane 1 and plane S-1
// copies plane S-2 (zero Neumann).  Ghost corners depend on that order.
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

__global__ void bc_kernel(const float* __restrict__ u, float* __restrict__ out,
                          const float* __restrict__ A, Shape3 g) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 3 * g.N) return;
  const int comp = (int)(t / g.N);
  int idx[3];
  unflatten(g, t - comp * g.N, idx);
  for (int a = 2; a >= 0; --a) {
    const int q = idx[a];
    const int hi = g.S[a] - 1;
    if (a == comp) {
      if (q <= 1 || q == hi) {
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

extern "C" int wl_bc3d(const float* u, float* out, const float* A, int S0,
                       int S1, int S2, void* stream) {
  const Shape3 g = make_shape(S0, S1, S2);
  bc_kernel<<<blocks_for(3 * g.N), WL_THREADS, 0, (cudaStream_t)stream>>>(
      u, out, A, g);
  return (int)cudaGetLastError();
}
