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
// One wave of blocks, as many as the card holds at once (`axpy_coresident`),
// strides over the cells, one cell a thread at a time; x' and r' go to new arrays (never in place), and
// each thread's rho is reduced in the block (deterministic tree, no
// atomics); the last block to finish sums the blocks' partials in index
// order (`finish_sum`), so a sweep is one launch and its rho the same bits
// on every call.  (The first form, a block a 256 cells, left ~67k partials
// at 258^3 to a second launch, torch.sum; summed by the last block, the
// blocks' ~67k atomics on the one counter serialised: 0.239 against 0.199
// ms on the H100; 8 blocks an SM, of which 5 fit at 48 registers, left a
// ragged second wave: 0.216 against 0.197 with a bf16 eps.)  Ghost cells
// add nothing to the sum by a branch, so a non-finite ghost value cannot
// reach it.
// Members (an ensemble under torch.func.vmap, the member forms of
// `pcg_update` and `pcg_axpy`): blockIdx.y is the member, each member
// swept by the one-field launch's blocks with its stride, its own upd (a
// member stride of 0: one for all), partials, counter and rho, so bit for
// bit its own launch; x', r' hold the members' fields one after another,
// each input sits at its own member stride (0: shared).
#pragma once

#include "common.cuh"

// Member strides (elements) of the sweep's inputs and of upd.
struct AxpyStrides {
  long long x, r, eps, z, iD, upd;
};

// MB: the member-axis instance (the one-field instance leaves its pointers
// as they are passed).
template <typename TE, typename TI, bool MB>
__global__ void axpy_rho_kernel(const float* __restrict__ x,
                                const float* __restrict__ r,
                                const TE* __restrict__ eps,
                                const float* __restrict__ z,
                                const TI* __restrict__ iD,
                                const float* __restrict__ upd_p,
                                float* __restrict__ x_out,
                                float* __restrict__ r_out,
                                float* partial, unsigned int* count,
                                float* out, Shape3 g, AxpyStrides st) {
  __shared__ float sh[WL_THREADS];
  if constexpr (MB) {
    const long long m = blockIdx.y;
    x += m * st.x;
    r += m * st.r;
    eps += m * st.eps;
    z += m * st.z;
    iD += m * st.iD;
    upd_p += m * st.upd;
    x_out += m * g.N;
    r_out += m * g.N;
    partial += m * gridDim.x;
    count += m;
    out += m;
  }
  const float upd = *upd_p;
  float rho = 0.f;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < g.N; c += (long long)gridDim.x * blockDim.x) {
    x_out[c] = x[c] + upd * ld(eps[c]);
    const float rn = r[c] - upd * z[c];
    r_out[c] = rn;
    int idx[3];
    unflatten(g, c, idx);
    if (is_interior(g, idx)) rho = rho + rn * (rn * ld(iD[c]));
  }
  finish_sum(block_sum(rho, sh), partial, count, out, sh);
}

// Blocks of the one-field sweep (eps, iD bf16 or f32) the card holds at
// once: the grid of a member as of a one-field launch.
inline int axpy_coresident(int eps_bf16, int iD_bf16) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  dispatch_bf16(eps_bf16, iD_bf16, [&](auto te, auto ti) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, axpy_rho_kernel<TAG_T(te), TAG_T(ti), false>, WL_THREADS,
        0);
  });
  return sms * per_sm;
}

// eps_bf16: eps is bf16 (else f32); iD_bf16: iD is bf16 (else f32);
// blocks: a member's grid (the caller's: at most one a WL_THREADS cells);
// partial: one float a block of a member, count: a zeroed counter a member
// (left zeroed), out: each member's rho.  members: x_out and r_out hold
// that many fields one after another, member m reading its inputs at the
// strides ``st`` (one field: members 1).  Calls that share a counter run
// on one stream.
inline int launch_axpy_rho(const float* x, const float* r, const void* eps,
                           const float* z, const void* iD, const float* upd,
                           float* x_out, float* r_out, float* partial,
                           unsigned int* count, float* out, int eps_bf16,
                           int iD_bf16, int blocks, int members,
                           AxpyStrides st, int S0, int S1, int S2,
                           void* stream) {
  const Shape3 g = make_shape(S0, S1, S2);
  if (blocks < 1 || blocks > blocks_for(g.N) || members < 1 ||
      members > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  dispatch_bf16(eps_bf16, iD_bf16, [&](auto te, auto ti) {
    using TE = TAG_T(te);
    using TI = TAG_T(ti);
    if (members > 1)
      axpy_rho_kernel<TE, TI, true><<<dim3(blocks, members), WL_THREADS, 0,
                                      s>>>(
          x, r, (const TE*)eps, z, (const TI*)iD, upd, x_out, r_out, partial,
          count, out, g, st);
    else
      axpy_rho_kernel<TE, TI, false><<<blocks, WL_THREADS, 0, s>>>(
          x, r, (const TE*)eps, z, (const TI*)iD, upd, x_out, r_out, partial,
          count, out, g, st);
  });
  return (int)cudaGetLastError();
}
