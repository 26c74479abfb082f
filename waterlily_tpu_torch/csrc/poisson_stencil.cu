// Poisson operator stencil: r - A eps (`increment3d`'s stencil half).
//
// Replaces waterlily_tpu/ops/pallas_stencil.py `increment3d_pallas`
// (`_rsub_kernel`), whole-grid, with eps in f32 or in bf16 (the smoother's
// search direction stored in bf16, `PoissonLevel.bf16_eps`) and L in f32 or
// in bf16 (a level's operator shadow L16, `PoissonLevel.L16`, with its f32
// diagonal D16): a bf16 operand is upcast in registers and the operator
// applied in f32, so r stays f32, as in the TPU kernel.
//
// `mult3d_pallas` (`_mult_kernel`, `_mult_block`), z = A x with and
// without <A x, x>, is no longer here: `mult3d` launches the plane march of
// stream_march.cu, the kernel `mult3d_stream` launches, with its chunk
// rule.  The one-thread-a-cell `mult_kernel` that stood here (every tap a
// load, a branch a ghost cell, one dot partial a block summed by a second
// launch) took 0.1894 ms at 258^3 with f32 L and the dot (0.65 of its
// 0.1230 ms bound) and 0.1854 with L16 (0.50 of 0.0923) on the H100,
// against the march's 0.1545 and 0.1333; without the dot it streamed
// faster than the march (0.1429 against 0.1522 ms), but the default path
// launches A x with the dot more than ten times as often.
//
// Bound on the H100: memory.  Per cell the increment reads L (3 floats), D,
// eps and r (7 eps taps, six of them shared with neighbouring cells) and
// writes r: at least 7 floats moved against ~15 flops, far below the card's
// flop-to-byte balance (a bf16 eps saves 2 bytes of them, a bf16 L 6).
// Design: one thread per cell with threadIdx.x along axis 2, so the eps
// taps of a warp along axes 1 and 2 and the L[+] reads hit lines the
// neighbouring warps already brought into L1/L2.  Ghost cells take r as it
// is, by a branch (no multiply by a mask), and never read neighbours.
// Members (an ensemble under torch.func.vmap, `increment3d`'s member form):
// blockIdx.y is the member; r_out holds the members' fields one after
// another, and each input sits at its own member stride (0 for one every
// member shares: an operator, or a field not batched).
#include "common.cuh"

// MB: the member-axis instance (its pointers offset by the member; the
// one-field instance leaves them in the constant bank).
template <typename TL, typename T, bool MB>
__global__ void rsub_kernel(const TL* __restrict__ L,
                            const float* __restrict__ Dd,
                            const T* __restrict__ eps,
                            const float* __restrict__ r,
                            float* __restrict__ r_out, Shape3 g,
                            long long sL, long long sD, long long se,
                            long long sr) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.N) return;
  if (MB) {
    const long long m = blockIdx.y;
    L += m * sL;
    Dd += m * sD;
    eps += m * se;
    r += m * sr;
    r_out += m * g.N;
  }
  int idx[3];
  unflatten(g, c, idx);
  const float ae = is_interior(g, idx) ? ax_cell(L, Dd, eps, g, c) : 0.f;
  r_out[c] = r[c] - ae;
}

extern "C" int wl_threads() { return WL_THREADS; }

extern "C" const char* wl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// L_bf16: L is bf16 (else f32); eps_bf16: eps is bf16 (else f32).
// members: r_out holds that many fields one after another (one field: 1);
// member m reads L + m sL, Dd + m sD, eps + m se and r + m sr (elements;
// 0: shared).
extern "C" int wl_increment3d(const void* L, const float* Dd, const void* eps,
                              const float* r, float* r_out, int L_bf16,
                              int eps_bf16, int members, long long sL,
                              long long sD, long long se, long long sr,
                              int S0, int S1, int S2, void* stream) {
  const Shape3 g = make_shape(S0, S1, S2);
  if (members < 1 || members > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for(g.N), members);
  const cudaStream_t s = (cudaStream_t)stream;
  dispatch_bf16(L_bf16, eps_bf16, [&](auto tl, auto te) {
    using TL = TAG_T(tl);
    using TE = TAG_T(te);
    if (members > 1)
      rsub_kernel<TL, TE, true><<<grid, WL_THREADS, 0, s>>>(
          (const TL*)L, Dd, (const TE*)eps, r, r_out, g, sL, sD, se, sr);
    else
      rsub_kernel<TL, TE, false><<<grid, WL_THREADS, 0, s>>>(
          (const TL*)L, Dd, (const TE*)eps, r, r_out, g, sL, sD, se, sr);
  });
  return (int)cudaGetLastError();
}
