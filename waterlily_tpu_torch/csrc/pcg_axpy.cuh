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
//
// The scalar step (`ops.attic.pcg_blocked`'s smooth, the fused iteration's
// sweeps with their words): a smooth carries its scalars in PCG_WORDS f32
// device words a member, from sweep to sweep, and the thread that sums a
// sweep's dots (thread 0 of the last block) also takes the PCG's scalar
// step from them, so a smooth is its sweeps' launches and nothing else.
// Each sweep reads the words its predecessor wrote and writes new ones
// (never in place: every block reads beta or upd from them while the last
// block steps).  The step is `ops.poisson.pcg`'s torch.where chain in IEEE
// f32 (round-to-nearest division, comparisons false on NaN, the constants
// rounded to f32 as torch rounds a Python number against an f32 tensor), so
// the words equal the chain's 0-d tensors bit for bit.
#pragma once

#include "common.cuh"

// The words of a member: rho, the sweep's own sum (<z, eps> after the
// first sweep, rho2 = <r', r'*iD> after the second), the dead flag (1 or
// 0), the step upd and the next beta.
#define PCG_WORDS 5
enum PcgWord { W_RHO = 0, W_SUM, W_DEAD, W_UPD, W_BETA };
// the smoother's exit on |rho|: 10 f32 eps (exact in f32)
#define PCG_TENEPS (10.f * FLT_EPSILON)

// The first sweep's step from its <z, eps> ``denom``: alpha = rho/denom
// (0 where dead or denom is 0), dead where |alpha| leaves [1e-2, 1e2],
// upd = alpha where alive.  w_in: the words of the previous sweep, or NULL
// at the smooth's seed (rho its own <r, r*iD> ``rho_seed``, dead where
// |rho| < PCG_TENEPS, beta 0).
__device__ inline void step_alpha(const float* w_in, float denom,
                                  float rho_seed, float* w_out) {
  float rho = rho_seed, beta = 0.f;
  bool dead = fabsf(rho_seed) < PCG_TENEPS;
  if (w_in != nullptr) {
    rho = w_in[W_RHO];
    dead = w_in[W_DEAD] != 0.f;
    beta = w_in[W_BETA];
  }
  const float alpha = (dead || denom == 0.f) ? 0.f : __fdiv_rn(rho, denom);
  dead = dead || fabsf(alpha) < 1e-2f || fabsf(alpha) > 1e2f;
  w_out[W_RHO] = rho;
  w_out[W_SUM] = denom;
  w_out[W_DEAD] = dead ? 1.f : 0.f;
  w_out[W_UPD] = dead ? 0.f : alpha;
  w_out[W_BETA] = beta;
}

// The second sweep's step from its rho2 = <r', r'*iD>: dead where |rho2| <
// PCG_TENEPS, beta = rho2/rho (rho 0 read as 1; 0 where dead), rho = rho2
// where alive.
__device__ inline void step_beta(const float* w_in, float rho2,
                                 float* w_out) {
  const float rho = w_in[W_RHO];
  const bool dead = w_in[W_DEAD] != 0.f || fabsf(rho2) < PCG_TENEPS;
  w_out[W_RHO] = dead ? rho : rho2;
  w_out[W_SUM] = rho2;
  w_out[W_DEAD] = dead ? 1.f : 0.f;
  w_out[W_UPD] = w_in[W_UPD];
  w_out[W_BETA] = dead ? 0.f : __fdiv_rn(rho2, rho == 0.f ? 1.f : rho);
}

// Member strides (elements) of the sweep's inputs, of upd and of the words.
struct AxpyStrides {
  long long x, r, eps, z, iD, upd, words;
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
                                const float* w_in, float* w_out,
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
    if (w_out != nullptr) {
      w_in += m * st.words;
      w_out += m * PCG_WORDS;
    }
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
  if (finish_sum(block_sum(rho, sh), partial, count, out, sh) &&
      w_out != nullptr)
    step_beta(w_in, *out, w_out);
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
// strides ``st`` (one field: members 1).  w_in, w_out: `wl_pcg_update`'s
// words (`step_beta`; w_out PCG_WORDS a member, w_in at member stride
// st.words, upd pointing into w_in), or NULL for none (`wl_pcg_axpy`).
// Calls that share a counter run on one stream.
inline int launch_axpy_rho(const float* x, const float* r, const void* eps,
                           const float* z, const void* iD, const float* upd,
                           const float* w_in, float* w_out, float* x_out,
                           float* r_out, float* partial, unsigned int* count,
                           float* out, int eps_bf16, int iD_bf16, int blocks,
                           int members, AxpyStrides st, int S0, int S1,
                           int S2, void* stream) {
  const Shape3 g = make_shape(S0, S1, S2);
  if (blocks < 1 || blocks > blocks_for(g.N) || members < 1 ||
      members > 65535 || (w_out != nullptr && w_in == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  dispatch_bf16(eps_bf16, iD_bf16, [&](auto te, auto ti) {
    using TE = TAG_T(te);
    using TI = TAG_T(ti);
    if (members > 1)
      axpy_rho_kernel<TE, TI, true><<<dim3(blocks, members), WL_THREADS, 0,
                                      s>>>(
          x, r, (const TE*)eps, z, (const TI*)iD, upd, w_in, w_out, x_out,
          r_out, partial, count, out, g, st);
    else
      axpy_rho_kernel<TE, TI, false><<<blocks, WL_THREADS, 0, s>>>(
          x, r, (const TE*)eps, z, (const TI*)iD, upd, w_in, w_out, x_out,
          r_out, partial, count, out, g, st);
  });
  return (int)cudaGetLastError();
}
