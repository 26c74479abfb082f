// A whole Jacobi-preconditioned CG smooth (`it` iterations) of one small
// multigrid level in a single launch.
//
// Replaces waterlily_tpu/ops/pallas_kernels.py `pcg_pallas` (`_make_kernel`),
// 3D non-periodic.
//
// Semantics (waterlily_tpu.ops.poisson.pcg, the reference's pcg! with its
// early exits as a monotone `dead` flag):
//   z = r*iD; eps = z; rho = <r, z>; dead = |rho| < 10 eps_f32
//   repeat: z = A eps (ghosts 0); alpha = rho/<z, eps> (0 if dead or the
//   denominator is 0); dead |= |alpha| outside [1e-2, 1e2]; upd = dead ? 0 :
//   alpha; x += upd*eps; r -= upd*z; then (not after the last iteration)
//   z2 = r*iD; rho2 = <r, z2>; dead |= |rho2| < 10 eps_f32;
//   beta = dead ? 0 : rho2/rho; eps = interior ? beta*eps + z2 : 0;
//   rho = dead ? rho : rho2.
// Only x and r leave the kernel.
//
// Bound on the H100: launch latency and synchronisation, not memory.  The
// coarse levels it serves hold at most ~60k cells (1.4 MB for L, D, iD, x,
// r, eps and z together), so every array stays in L2, while the plain form
// is some 30 small launches per smooth.  Design: the literal counterpart of
// the TPU's whole smooth on chip: one block of 1024 threads walks the level
// in strides, __syncthreads() separates the phases (the matvec reads eps
// written by other threads), and each dot is a deterministic block tree sum
// that every thread receives, so all threads take the same early-exit
// decisions.  eps and z are scratch arrays the wrapper allocates.
#include "common.cuh"

#define PCG_THREADS 1024

__global__ void __launch_bounds__(PCG_THREADS)
pcg_kernel(const float* __restrict__ L, const float* __restrict__ Dd,
           const float* __restrict__ iD, float* __restrict__ x,
           float* __restrict__ r, float* __restrict__ eps,
           float* __restrict__ z, Shape3 g, int it) {
  __shared__ float sh[PCG_THREADS];
  const float teneps = 10.f * FLT_EPSILON;
  const long long n = g.N;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  float part = 0.f;
  for (long long c = tid; c < n; c += nt) {
    const float zc = r[c] * iD[c];
    eps[c] = zc;
    part = part + r[c] * zc;
  }
  float rho = block_sum(part, sh);  // its barriers publish eps
  bool dead = fabsf(rho) < teneps;

  for (int i = 0; i < it; ++i) {
    part = 0.f;
    for (long long c = tid; c < n; c += nt) {
      int idx[3];
      unflatten(g, c, idx);
      const float v = is_interior(g, idx) ? ax_cell(L, Dd, eps, g, c) : 0.f;
      z[c] = v;
      part = part + v * eps[c];
    }
    const float denom = block_sum(part, sh);
    const float alpha = (dead || denom == 0.f) ? 0.f : rho / denom;
    dead = dead || fabsf(alpha) < 1e-2f || fabsf(alpha) > 1e2f;
    const float upd = dead ? 0.f : alpha;
    const bool last = (i == it - 1);
    part = 0.f;
    for (long long c = tid; c < n; c += nt) {
      x[c] = x[c] + upd * eps[c];
      const float rc = r[c] - upd * z[c];
      r[c] = rc;
      if (!last) {
        const float z2 = rc * iD[c];
        z[c] = z2;   // each thread only rewrites its own cells
        part = part + rc * z2;
      }
    }
    if (last) break;
    const float rho2 = block_sum(part, sh);
    dead = dead || fabsf(rho2) < teneps;
    const float beta = dead ? 0.f : rho2 / (rho == 0.f ? 1.f : rho);
    for (long long c = tid; c < n; c += nt) {
      int idx[3];
      unflatten(g, c, idx);
      eps[c] = is_interior(g, idx) ? beta * eps[c] + z[c] : 0.f;
    }
    __syncthreads();  // the next matvec reads other threads' eps
    rho = dead ? rho : rho2;
  }
}

extern "C" int wl_pcg3d(const float* L, const float* Dd, const float* iD,
                        float* x, float* r, float* eps, float* z, int S0,
                        int S1, int S2, int it, void* stream) {
  const Shape3 g = make_shape(S0, S1, S2);
  pcg_kernel<<<1, PCG_THREADS, 0, (cudaStream_t)stream>>>(L, Dd, iD, x, r, eps,
                                                         z, g, it);
  return (int)cudaGetLastError();
}
