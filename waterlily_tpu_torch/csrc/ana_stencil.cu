// Analytic far-field Poisson operator of a banded multigrid level:
// z = A x for the constant face coefficient c, with the wall faces (index 1
// and S-2 of a non-periodic axis) zero, and optionally per-block partials of
// <A x, x> over the interior.
//
// Replaces waterlily_tpu/ops/pallas_stencil.py `ana_mult3d_pallas`
// (`_ana_kernel`), f32 and whole-grid, periodic axes included (a per-axis
// flag: their faces are never zero and the caller fills x's ghosts).
//
// Launch: grid (ceil(S2/32), ceil(S1/8), S0) of 32 x 8 blocks; `partial`
// holds one float per block, in the grid's row-major order.
//
// Bound on the H100: memory.  The operator reads no coefficient field: x in
// and z out, 8 B per cell against ~20 flops, a third of mult3d's traffic.
// Design: one thread per cell on a 3D launch grid, 32 x 8 threads over a
// tile of axes (2, 1) and one grid row per index of axis 0, so a thread
// finds its cell without integer division (the flat-index unflatten of the
// other kernels costs more than this kernel's memory traffic).  The x taps
// of a warp along axes 1 and 2 come from lines its neighbours already
// brought into L1/L2; the face flags come from the index.  The association
// is the TPU kernel's (t = lo0*x[i-1] + hi0*x[i+1] + ... left to right,
// nf = lo0+hi0+..., z = c*t - (c*nf)*x): built with --fmad=false it equals
// the plain version `_ana_mult3d_plain` bit for bit.  Ghost cells are
// written as exact zeros by a branch and never read neighbours; threads past
// the ragged edge of axes 1 and 2 write nothing; the dot partial is a
// warp-shuffle sum written once per block.
#include "common.cuh"

// threads of a block along axes 2 and 1 (stencil_kernels.ANA_TILE)
#define ANA_TX 32
#define ANA_TY 8   // ANA_TX * ANA_TY == WL_THREADS

// Sum of v over the block, valid in thread (0, 0): shuffles within each
// warp, then the first warp sums the WL_THREADS/32 warp partials.  One
// barrier instead of the eight rounds of `block_sum`.
__device__ inline float warp_block_sum(float v, float* sh) {
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, o);
  if ((t & 31) == 0) sh[t >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (t < 32) {
    s = (t < WL_THREADS / 32) ? sh[t] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      s = s + __shfl_down_sync(0xffffffffu, s, o);
  }
  return s;
}

__global__ void ana_kernel(const float* __restrict__ x, float* __restrict__ z,
                           float* __restrict__ partial, float c, int periodic,
                           Shape3 g) {
  __shared__ float sh[WL_THREADS / 32];
  const int idx[3] = {(int)blockIdx.z,
                      (int)(blockIdx.y * ANA_TY + threadIdx.y),
                      (int)(blockIdx.x * ANA_TX + threadIdx.x)};
  float dot = 0.f;
  if (idx[1] < g.S[1] && idx[2] < g.S[2]) {
    const long long cell = idx[0] * g.st[0] + idx[1] * g.st[1] + idx[2];
    float v = 0.f;
    if (is_interior(g, idx)) {
      float lo[3], hi[3];
      for (int a = 0; a < 3; ++a) {
        const bool per = (periodic >> a) & 1;
        lo[a] = (per || idx[a] != 1) ? 1.f : 0.f;
        hi[a] = (per || idx[a] != g.S[a] - 2) ? 1.f : 0.f;
      }
      float t = lo[0] * x[cell - g.st[0]];
      t = t + hi[0] * x[cell + g.st[0]];
      float nf = lo[0];
      nf = nf + hi[0];
      for (int a = 1; a < 3; ++a) {
        t = t + lo[a] * x[cell - g.st[a]];
        t = t + hi[a] * x[cell + g.st[a]];
        nf = nf + lo[a];
        nf = nf + hi[a];
      }
      const float xc = x[cell];
      v = c * t - (c * nf) * xc;
      dot = v * xc;
    }
    z[cell] = v;
  }
  if (partial != nullptr) {  // uniform across the block
    const float s = warp_block_sum(dot, sh);
    if (threadIdx.x == 0 && threadIdx.y == 0)
      partial[((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
              blockIdx.x] = s;
  }
}

extern "C" int wl_ana_mult3d(const float* x, float* z, float* partial,
                             float c, int periodic, int S0, int S1, int S2,
                             void* stream) {
  const Shape3 g = make_shape(S0, S1, S2);
  const dim3 block(ANA_TX, ANA_TY);
  const dim3 grid((S2 + ANA_TX - 1) / ANA_TX, (S1 + ANA_TY - 1) / ANA_TY, S0);
  ana_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, z, partial, c,
                                                       periodic, g);
  return (int)cudaGetLastError();
}
