// CFL flux-out reduction: the interior max of
// sum_i max(0, u_i[I+d_i]) + max(0, -u_i[I]).
//
// Replaces waterlily_tpu/ops/pallas_stencil.py `cfl3d_pallas` (`_cfl_kernel`).
//
// Bound on the H100: memory, 12 B/cell read (three velocity components; the
// +d_i taps are neighbours' values, cached) and a handful of flops.  Design:
// one thread per cell, a block-level tree max, one partial per block; the
// caller takes the max of the small partial array on the device.  All terms
// are >= 0, so ghost cells contribute 0 without changing the max, and max
// does not depend on order: the result equals the plain version exactly.
// The per-cell sum keeps waterlily_tpu.flow.cfl's association
// s = t0; s += t1; s += t2.
#include "common.cuh"

__global__ void cfl_kernel(const float* __restrict__ u,
                           float* __restrict__ partial, Shape3 g) {
  __shared__ float sh[WL_THREADS];
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float m = 0.f;
  if (c < g.N) {
    int idx[3];
    unflatten(g, c, idx);
    if (is_interior(g, idx)) {
      float s = 0.f;
      for (int a = 0; a < 3; ++a) {
        const float* ua = u + a * g.N;
        const float t = tmax(0.f, ua[c + g.st[a]]) + tmax(0.f, -ua[c]);
        s = (a == 0) ? t : s + t;
      }
      m = s;
    }
  }
  const float mx = block_max(m, sh);
  if (threadIdx.x == 0) partial[blockIdx.x] = mx;
}

extern "C" int wl_cfl3d(const float* u, float* partial, int S0, int S1, int S2,
                        void* stream) {
  const Shape3 g = make_shape(S0, S1, S2);
  cfl_kernel<<<blocks_for(g.N), WL_THREADS, 0, (cudaStream_t)stream>>>(
      u, partial, g);
  return (int)cudaGetLastError();
}
