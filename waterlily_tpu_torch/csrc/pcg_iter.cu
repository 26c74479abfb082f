// The fused PCG iteration of the blocked (big 3D) levels, in two sweeps.
//
// `wl_pcg_dir_mult` replaces waterlily_tpu/ops/attic.py `pcg_dir_mult`
// (`_pcg_dir_mult_kernel`): it rebuilds the search direction
// eps = beta*eps_prev + r*iD, rounds it to bf16 when the level stores its
// direction in bf16, applies A to the (rounded) direction in f32, and writes
// eps, z = A eps (zero on the ghost cells), <z, eps> (the next alpha's
// denominator) and <r, r*iD> (the rho seed at beta = 0, from the UNROUNDED
// product, as the TPU kernel takes it) over the interior.  On a level with
// operator shadows (`PoissonLevel.L16`) L and iD are the bf16 L16 and iD16
// (D the f32 D16), upcast in registers as the TPU kernel's `_mult_block`
// and `_pcg_rebuild` do.  `wl_pcg_update` replaces `pcg_update`
// (`_pcg_update_kernel`): the axpy pair and the next rho (pcg_axpy.cuh).
// Each sweep also takes the PCG's scalar step on the smooth's words
// (`ops.attic.pcg_blocked`) in the thread that sums its dots (pcg_axpy.cuh's
// `step_alpha` after the first sweep's <z, eps>, `step_beta` after the
// second's rho), reading beta or upd from the words the other wrote: a
// smooth is 2 launches an iteration and no other device work.
//
// Bound on the H100: memory.  The first sweep reads L (3 fields), D,
// eps_prev, r and iD and writes eps and z: 9 fields a cell (8 with a bf16
// direction, 7 with bf16 L and iD) against ~21 flops, far below the card's
// flop-to-byte balance.  The first kernel (one thread a cell with a 64-bit
// divide-based unflatten, the direction rebuilt at the cell and at each of
// its six neighbours: 21 loads of eps_prev, r and iD where 3 do, two
// shared-memory tree sums per 256 cells and ~2 x 67k partials summed by a
// second launch, torch.sum) took 0.3573 ms at 258^3, 0.52 of its 0.1846 ms
// bound.
// Design: the plane march of march.cuh.  A thread owns an interior column,
// rebuilds (and rounds) the direction of each of its cells once, stores it
// to eps, and carries it down its chunk of planes with L0 in registers:
// e[i-1], e[i], e[i+1], L0[i] and L0[i+1], one new plane of loads a step.
// The in-plane taps of the rebuilt direction: j+-1 rebuilt from the
// neighbouring rows' eps_prev, r and iD, loads that hit the lines the
// tile's own loads of the plane brought into L1; k+-1 from the
// neighbouring lanes by warp shuffles (lanes 0 and 31 rebuild theirs) with
// f32 coefficients, rebuilt from L1 like j+-1 with the bf16 shadows.  On
// the H100 at 258^3 that took 0.270 ms with f32 operands (0.68 of the
// bound), 0.302-0.316 with every tap rebuilt from L1, 0.336 from a
// double-buffered shared tile with a one-cell halo (a barrier a plane) and
// 0.342 with k+-1 by shuffles and j+-1 from a shared row buffer; with the
// shadows the shuffles cost more than they save (0.272-0.291 against
// 0.223).  The ghost cells are written by the threads of the interior
// cells next to them (`march_ghosts`): eps the rebuilt direction, as the
// plain form writes it over the whole array, z exact zeros; the first and
// last chunks also write the ghost planes.  Both dots accumulate in
// registers over the march, then over the block by warp shuffles; the
// last block sums each one's partials in index order: one launch, the
// same bits on every call.
// Exactness: each direction value is rounded before the stencil, so z, the
// x/r update and the written eps all see one rounded direction (the
// bf16_eps contract of waterlily_tpu.ops.poisson.PoissonLevel), and z
// keeps the association of `ax_cell_at` (common.cuh): built with
// --fmad=false, eps and z equal the plain version bit for bit.  eps_prev
// must not alias eps: neighbours read the previous direction while eps is
// written.
// Members (an ensemble under torch.func.vmap, `pcg_dir_mult`'s member
// form): the march's member axis (march.cuh): each member marched with a
// one-member launch's chunks, with its own beta (a member stride of 0: one
// for all), partials, counter, two dots and words, so bit for bit its
// own launch; eps and z hold the members' fields one after another, each input
// at its own member stride (0 for one every member shares: a level's
// operator).
#include <type_traits>

#include "march.cuh"
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

// Member strides (elements) of the first sweep's inputs and of the words.
struct DirStrides {
  long long L, D, ep, r, iD, words;
};

// TP: eps_prev's type, TO: eps's, TC: the coefficients L and iD's.  w_in:
// the words beta is read from, or NULL at the smooth's seed (beta 0);
// w_out: the new words (`step_alpha`).  partial: 2 floats a block (the
// <z, eps> partials, then <r, r*iD>'s), out: the two sums.  MB: the
// member-axis instance (the one-field instance leaves its pointers as they
// are passed).
template <typename TP, typename TO, typename TC, bool MB>
__global__ void __launch_bounds__(MARCH_THREADS)
dir_mult_kernel(const TC* __restrict__ L, const float* __restrict__ Dd,
                const TP* __restrict__ ep, const float* __restrict__ r,
                const TC* __restrict__ iD, const float* w_in, float* w_out,
                TO* __restrict__ eps, float* __restrict__ z, float* partial,
                unsigned int* count, float* out, int S0, int S1, int S2,
                int planes, DirStrides st) {
  // k+-1 taps by warp shuffles with f32 coefficients, rebuilt from L1
  // with the bf16 shadows (the faster of the two for each, above)
  constexpr bool SHUFFLE = std::is_same<TC, float>::value;
  __shared__ float sh[2 * MARCH_THREADS / 32];
  const Column col = march_column<MB>(S0, S1, S2, planes);
  const int P = S1 * S2, N = S0 * P;
  if constexpr (MB) {
    const long long m = col.m;
    L += m * st.L;
    Dd += m * st.D;
    ep += m * st.ep;
    r += m * st.r;
    iD += m * st.iD;
    if (w_in != nullptr) w_in += m * st.words;
    w_out += m * PCG_WORDS;
    eps += m * N;
    z += m * N;
  }
  const float beta = w_in != nullptr ? w_in[W_BETA] : 0.f;
  const TC* __restrict__ L0 = L;
  const TC* __restrict__ L1 = L + N;
  const TC* __restrict__ L2 = L + 2 * N;
  // the direction at flat index a, as stored
  const auto e = [&](int a) {
    return as_stored<TO>(beta * ld(ep[a]) + r[a] * ld(iD[a]));
  };
  const auto ghost = [&](int a) {
    put(eps + a, e(a));
    z[a] = 0.f;
  };
  const int j = col.j, k = col.k, lane = threadIdx.x;
  const bool in = col.in;
  const bool jl = j == 1, jh = j == S1 - 2, kl = k == 1, kh = k == S2 - 2;
  float sums[2] = {0.f, 0.f};   // <z, eps>, <r, r*iD>
  int at = col.i0 * P + j * S2 + k;
  float em = 0.f, ec = 0.f, l0c = 0.f, qc = 0.f;
  if (in) {
    em = e(at - P);
    if (col.i0 == 1) {   // ghost plane 0
      put(eps + at - P, em);
      z[at - P] = 0.f;
      march_ghosts(at - P, jl, jh, kl, kh, S2, ghost);
    }
    const float rc = r[at], idc = ld(iD[at]);
    ec = as_stored<TO>(beta * ld(ep[at]) + rc * idc);
    qc = rc * (rc * idc);
    l0c = ld(L0[at]);
  }
#pragma unroll 2
  for (int i = col.i0; i < col.i1; ++i, at += P) {
    float en = 0.f, l0n = 0.f, qn = 0.f;
    if (in) {
      const float rn = r[at + P], idn = ld(iD[at + P]);
      en = as_stored<TO>(beta * ld(ep[at + P]) + rn * idn);
      qn = rn * (rn * idn);
      l0n = ld(L0[at + P]);
    }
    float ekm, ekp;
    if constexpr (SHUFFLE) {   // every lane of the warp takes part
      ekm = __shfl_up_sync(0xffffffffu, ec, 1);
      ekp = __shfl_down_sync(0xffffffffu, ec, 1);
      if (in && lane == 0) ekm = e(at - 1);
      if (in && (lane == MARCH_TK - 1 || kh)) ekp = e(at + 1);
    }
    if (in) {
      const float ejm = e(at - S2), ejp = e(at + S2);
      if constexpr (!SHUFFLE) {
        ekm = e(at - 1);
        ekp = e(at + 1);
      }
      // ax_cell_at's association
      float s = ec * Dd[at];
      s = s + em * l0c;
      s = s + en * l0n;
      s = s + ejm * ld(L1[at]);
      s = s + ejp * ld(L1[at + S2]);
      s = s + ekm * ld(L2[at]);
      s = s + ekp * ld(L2[at + 1]);
      put(eps + at, ec);
      z[at] = s;
      march_ghosts(at, jl, jh, kl, kh, S2, ghost);
      sums[0] = sums[0] + s * ec;
      sums[1] = sums[1] + qc;
    }
    em = ec;
    ec = en;
    l0c = l0n;
    qc = qn;
  }
  if (in && col.i1 == S0 - 1) {   // ghost plane S0-1: at is its cell now
    put(eps + at, ec);
    z[at] = 0.f;
    march_ghosts(at, jl, jh, kl, kh, S2, ghost);
  }
  block_reduce_n<SumOp, 2>(sums, 0.f, sh);
  if (march_finish_n<SumOp, 2>(col, sums, 0.f, partial, count, out, sh)) {
    const float* o = out + 2 * col.m;
    step_alpha(w_in, o[0], o[1], w_out);
  }
}

// ep_bf16: eps_prev is bf16; out_bf16: eps is written (and rounded) in bf16;
// coef_bf16: L and iD are bf16 (the level's L16 and iD16; D is f32).
// w_in: the words beta is read from (one run a member at stride sw, 0:
// shared), or NULL at the smooth's seed (beta 0); w_out: PCG_WORDS a
// member, the new words.  partial: 2 floats a block of a member's grid
// (`march_grid`), member after member, count: a zeroed counter a member
// (left zeroed), out: each member's <z, eps> then <r, r*iD>.  members: eps
// and z hold that many fields one after another, member m reading L + m sL,
// Dd + m sD, eps_prev + m se, r + m sr, iD + m si (elements; 0: shared;
// one field: members 1).  Calls that share a counter run on one stream.
extern "C" int wl_pcg_dir_mult(const void* L, const float* Dd, const void* ep,
                               const float* r, const void* iD,
                               const float* w_in, float* w_out, void* eps,
                               float* z, float* partial, unsigned int* count,
                               float* out, int ep_bf16, int out_bf16,
                               int coef_bf16, int planes, int members,
                               long long sL, long long sD, long long se,
                               long long sr, long long si, long long sw,
                               int S0, int S1, int S2, void* stream) {
  if (!march_shape_ok(S0, S1, S2, planes, members) || w_out == nullptr)
    return (int)cudaErrorInvalidValue;
  const dim3 grid = march_grid(S0, S1, S2, planes, members);
  const dim3 block(MARCH_TK, MARCH_TJ);
  const cudaStream_t s = (cudaStream_t)stream;
  const DirStrides st{sL, sD, se, sr, si, sw};
  dispatch_bf16(ep_bf16, out_bf16, [&](auto tp, auto to) {
    using TP = TAG_T(tp);
    using TO = TAG_T(to);
    auto go = [&](auto tc) {
      using TC = TAG_T(tc);
      if (members > 1)
        dir_mult_kernel<TP, TO, TC, true><<<grid, block, 0, s>>>(
            (const TC*)L, Dd, (const TP*)ep, r, (const TC*)iD, w_in, w_out,
            (TO*)eps, z, partial, count, out, S0, S1, S2, planes, st);
      else
        dir_mult_kernel<TP, TO, TC, false><<<grid, block, 0, s>>>(
            (const TC*)L, Dd, (const TP*)ep, r, (const TC*)iD, w_in, w_out,
            (TO*)eps, z, partial, count, out, S0, S1, S2, planes, st);
    };
    if (coef_bf16)
      go(type_tag<__nv_bfloat16>{});
    else
      go(type_tag<float>{});
  });
  return (int)cudaGetLastError();
}

// w_in: the words upd is read from (one run a member at stride sw, 0:
// shared), w_out: PCG_WORDS a member, the new words (`step_beta`).  The
// rest as launch_axpy_rho's.
extern "C" int wl_pcg_update(const float* x, const float* r, const void* eps,
                             const float* z, const void* iD,
                             const float* w_in, float* w_out, float* x_out,
                             float* r_out, float* partial,
                             unsigned int* count, float* out, int eps_bf16,
                             int iD_bf16, int blocks, int members,
                             long long sx, long long sr, long long se,
                             long long sz, long long si, long long sw,
                             int S0, int S1, int S2, void* stream) {
  if (w_in == nullptr || w_out == nullptr) return (int)cudaErrorInvalidValue;
  return launch_axpy_rho(x, r, eps, z, iD, w_in + W_UPD, w_in, w_out, x_out,
                         r_out, partial, count, out, eps_bf16, iD_bf16,
                         blocks, members,
                         AxpyStrides{sx, sr, se, sz, si, sw, sw}, S0, S1, S2,
                         stream);
}
