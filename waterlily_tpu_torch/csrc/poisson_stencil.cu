// Poisson operator stencil: z = A x, z = A x with per-block partials of
// <A x, x>, and r - A eps.
//
// Replaces waterlily_tpu/ops/pallas_stencil.py `mult3d_pallas` (`_mult_kernel`,
// `_mult_block`) and `increment3d_pallas` (`_rsub_kernel`), f32 and whole-grid.
//
// Bound on the H100: memory.  Per cell the operator reads L (3 floats), D
// and x (7 taps, six of them shared with neighbouring cells) and writes z:
// at least 6 floats = 24 B/cell moved against ~13 flops, far below the
// card's flop-to-byte balance.  Design: one thread per cell with threadIdx.x
// along axis 2, so the x taps of a warp along axes 1 and 2 and the L[+]
// reads hit lines the neighbouring warps already brought into L1/L2; the dot
// partial is reduced in the block and written once per block, so the PCG
// denominator costs no second pass over z and x.  Ghost cells are written as
// exact zeros by a branch (no multiply by a mask) and never read neighbours.
#include "common.cuh"

__global__ void mult_kernel(const float* __restrict__ L,
                            const float* __restrict__ Dd,
                            const float* __restrict__ x, float* __restrict__ z,
                            float* __restrict__ partial, Shape3 g) {
  __shared__ float sh[WL_THREADS];
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float dot = 0.f;
  if (c < g.N) {
    int idx[3];
    unflatten(g, c, idx);
    float v = 0.f;
    if (is_interior(g, idx)) {
      v = ax_cell(L, Dd, x, g, c);
      dot = v * x[c];
    }
    z[c] = v;
  }
  if (partial != nullptr) {  // uniform across the block
    const float s = block_sum(dot, sh);
    if (threadIdx.x == 0) partial[blockIdx.x] = s;
  }
}

__global__ void rsub_kernel(const float* __restrict__ L,
                            const float* __restrict__ Dd,
                            const float* __restrict__ eps,
                            const float* __restrict__ r,
                            float* __restrict__ r_out, Shape3 g) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.N) return;
  int idx[3];
  unflatten(g, c, idx);
  const float ae = is_interior(g, idx) ? ax_cell(L, Dd, eps, g, c) : 0.f;
  r_out[c] = r[c] - ae;
}

extern "C" int wl_threads() { return WL_THREADS; }

extern "C" const char* wl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int wl_mult3d(const float* L, const float* Dd, const float* x,
                         float* z, float* partial, int S0, int S1, int S2,
                         void* stream) {
  const Shape3 g = make_shape(S0, S1, S2);
  mult_kernel<<<blocks_for(g.N), WL_THREADS, 0, (cudaStream_t)stream>>>(
      L, Dd, x, z, partial, g);
  return (int)cudaGetLastError();
}

extern "C" int wl_increment3d(const float* L, const float* Dd, const float* eps,
                              const float* r, float* r_out, int S0, int S1,
                              int S2, void* stream) {
  const Shape3 g = make_shape(S0, S1, S2);
  rsub_kernel<<<blocks_for(g.N), WL_THREADS, 0, (cudaStream_t)stream>>>(
      L, Dd, eps, r, r_out, g);
  return (int)cudaGetLastError();
}
