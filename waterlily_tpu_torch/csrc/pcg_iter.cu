// The fused PCG iteration of the blocked (big 3D) levels, in two sweeps.
//
// `wl_pcg_dir_mult` replaces waterlily_tpu/ops/attic.py `pcg_dir_mult`
// (`_pcg_dir_mult_kernel`): it rebuilds the search direction
// eps = beta*eps_prev + r*iD, rounds it to bf16 when the level stores its
// direction in bf16, applies A to the (rounded) direction in f32, and writes
// eps, z = A eps and per-block partials of <z, eps> (the next alpha's
// denominator) and <r, r*iD> (the rho seed at beta = 0, from the UNROUNDED
// product, as the TPU kernel takes it).  On a level with operator shadows
// (`PoissonLevel.L16`) L and iD are the bf16 L16 and iD16 (D the f32 D16),
// upcast in registers as the TPU kernel's `_mult_block` and `_pcg_rebuild`
// do.  `wl_pcg_update` replaces `pcg_update` (`_pcg_update_kernel`): the
// axpy pair and the next rho (pcg_axpy.cuh).
//
// Bound on the H100: memory.  The first sweep reads L (3 fields), D,
// eps_prev, r and iD and writes eps and z: 9 fields a cell (8 with a bf16
// direction, 7 with bf16 L and iD) against ~20 flops, far below the card's
// flop-to-byte balance.
// Design: one thread per cell, threadIdx.x along axis 2.  Where the TPU
// kernel carries the rebuilt direction's halo rows in VMEM, a thread here
// rebuilds eps at each of its six neighbours from eps_prev, r and iD, whose
// lines the neighbouring threads of the warp and block bring into L1/L2: 18
// extra reads that hit the caches instead of a second pass over memory.
// Each rebuilt value is rounded before the stencil, so z, the x/r update
// and the written eps all see one rounded direction (the bf16_eps contract
// of waterlily_tpu.ops.poisson.PoissonLevel).  eps_prev must not alias eps:
// neighbours read the previous direction while eps is written.  Both sums
// are block trees (no atomics) reduced over blocks by the caller, masked to
// the interior by a branch.
#include <type_traits>

#include "common.cuh"
#include "pcg_axpy.cuh"

// v as the direction is stored: unchanged in f32, rounded to nearest even
// in bf16 (the rounding of torch's .to(torch.bfloat16))
template <typename T>
__device__ inline float as_stored(float v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

__device__ inline void put(float* p, float v) { *p = v; }
__device__ inline void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);  // v is bf16-representable: exact
}

// TP: eps_prev's type, TO: eps's, TC: the coefficients L and iD's
template <typename TP, typename TO, typename TC>
__global__ void dir_mult_kernel(const TC* __restrict__ L,
                                const float* __restrict__ Dd,
                                const TP* __restrict__ ep,
                                const float* __restrict__ r,
                                const TC* __restrict__ iD,
                                const float* __restrict__ beta_p,
                                TO* __restrict__ eps, float* __restrict__ z,
                                float* __restrict__ partial, Shape3 g,
                                int nblocks) {
  __shared__ float sh[WL_THREADS];
  const float beta = *beta_p;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // the rebuilt (and stored-precision) direction at flat index i
  auto e = [&](long long i) {
    return as_stored<TO>(beta * ld(ep[i]) + r[i] * ld(iD[i]));
  };
  float den = 0.f, rre = 0.f;
  if (c < g.N) {
    int idx[3];
    unflatten(g, c, idx);
    const float ec = e(c);
    put(eps + c, ec);
    float v = 0.f;
    if (is_interior(g, idx)) {
      v = ax_cell_at(L, Dd, e, g, c);
      den = v * ec;
      const float rc = r[c];
      rre = rc * (rc * ld(iD[c]));
    }
    z[c] = v;
  }
  const float s_den = block_sum(den, sh);
  const float s_rre = block_sum(rre, sh);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = s_den;
    partial[nblocks + blockIdx.x] = s_rre;
  }
}

// ep_bf16: eps_prev is bf16; out_bf16: eps is written (and rounded) in bf16;
// coef_bf16: L and iD are bf16 (the level's L16 and iD16; D is f32).
// partial holds 2 * blocks floats: the <z, eps> partials, then <r, r*iD>'s.
extern "C" int wl_pcg_dir_mult(const void* L, const float* Dd, const void* ep,
                               const float* r, const void* iD,
                               const float* beta, void* eps, float* z,
                               float* partial, int ep_bf16, int out_bf16,
                               int coef_bf16, int S0, int S1, int S2,
                               void* stream) {
  const Shape3 g = make_shape(S0, S1, S2);
  const int nb = blocks_for(g.N);
  dispatch_bf16(ep_bf16, out_bf16, [&](auto tp, auto to) {
    auto go = [&](auto tc) {
      using TC = TAG_T(tc);
      dir_mult_kernel<TAG_T(tp), TAG_T(to), TC>
          <<<nb, WL_THREADS, 0, (cudaStream_t)stream>>>(
              (const TC*)L, Dd, (const TAG_T(tp)*)ep, r, (const TC*)iD, beta,
              (TAG_T(to)*)eps, z, partial, g, nb);
    };
    if (coef_bf16)
      go(type_tag<__nv_bfloat16>{});
    else
      go(type_tag<float>{});
  });
  return (int)cudaGetLastError();
}

extern "C" int wl_pcg_update(const float* x, const float* r, const void* eps,
                             const float* z, const void* iD, const float* upd,
                             float* x_out, float* r_out, float* partial,
                             int eps_bf16, int iD_bf16, int S0, int S1, int S2,
                             void* stream) {
  return launch_axpy_rho(x, r, eps, z, iD, upd, x_out, r_out, partial,
                         eps_bf16, iD_bf16, S0, S1, S2, stream);
}
