// The PCG iteration's axpy pair and next rho in one sweep:
//   x' = x + upd*eps,  r' = r - upd*z,  per-block partials of <r', r'*iD>
// over the interior.  Shared by `wl_pcg_update` (pcg_iter.cu, the second
// fused-iteration sweep) and `wl_pcg_axpy` (reduce.cu): the two TPU kernels
// they replace, waterlily_tpu/ops/attic.py `_pcg_update_kernel` and
// `_axpy_rid_kernel`, compute this same function in the same operation
// order.  eps may be bf16 (upcast in registers), and so may iD (a level's
// operator shadow iD16); x', r' and the sums are f32.
//
// Bound on the H100: memory (5 fields read, 2 written, ~7 flops a cell).
// One thread per cell; x' and r' go to new arrays (never in place), and the
// rho partial is reduced in the block (deterministic tree, no atomics) and
// summed over blocks by the caller.  Ghost cells add nothing to the sum by a
// branch, so a non-finite ghost value cannot reach it.
#pragma once

#include "common.cuh"

template <typename TE, typename TI>
__global__ void axpy_rho_kernel(const float* __restrict__ x,
                                const float* __restrict__ r,
                                const TE* __restrict__ eps,
                                const float* __restrict__ z,
                                const TI* __restrict__ iD,
                                const float* __restrict__ upd_p,
                                float* __restrict__ x_out,
                                float* __restrict__ r_out,
                                float* __restrict__ partial, Shape3 g) {
  __shared__ float sh[WL_THREADS];
  const float upd = *upd_p;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float rho = 0.f;
  if (c < g.N) {
    x_out[c] = x[c] + upd * ld(eps[c]);
    const float rn = r[c] - upd * z[c];
    r_out[c] = rn;
    int idx[3];
    unflatten(g, c, idx);
    if (is_interior(g, idx)) rho = rn * (rn * ld(iD[c]));
  }
  const float s = block_sum(rho, sh);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

// eps_bf16: eps is bf16 (else f32); iD_bf16: iD is bf16 (else f32)
inline int launch_axpy_rho(const float* x, const float* r, const void* eps,
                           const float* z, const void* iD, const float* upd,
                           float* x_out, float* r_out, float* partial,
                           int eps_bf16, int iD_bf16, int S0, int S1, int S2,
                           void* stream) {
  const Shape3 g = make_shape(S0, S1, S2);
  dispatch_bf16(eps_bf16, iD_bf16, [&](auto te, auto ti) {
    axpy_rho_kernel<<<blocks_for(g.N), WL_THREADS, 0, (cudaStream_t)stream>>>(
        x, r, (const TAG_T(te)*)eps, z, (const TAG_T(ti)*)iD, upd, x_out,
        r_out, partial, g);
  });
  return (int)cudaGetLastError();
}
