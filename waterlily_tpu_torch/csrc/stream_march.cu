// Poisson operator: z = A x, and <A x, x> over the interior on request, as
// a plane march (march.cuh) in one launch.
//
// Replaces two TPU kernels of one function:
// waterlily_tpu/ops/pallas_stencil.py `mult3d_pallas` (`_mult_kernel`), the
// blocked levels' operator on the default path, launched by `mult3d`, and
// waterlily_tpu/ops/attic.py `mult3d_stream` (`_stream_mult_kernel`), the
// carried-rows form behind the STREAM seam, launched by `mult3d_stream`.
// Both wrappers launch this entry point with one chunk rule
// (`ops.attic._stream_march`) and keep their own launch counts.  L is f32
// or bf16 (a level's shadow L16, D the f32 D16) and x f32 or bf16, upcast
// in registers; z and the dot are f32.
//
// The carried-rows TPU kernel walks axis-0 slabs in order and carries x
// rows and a row of L0 in VMEM, so that every input row comes from HBM
// once.  Blocks here run in parallel with no carry between them; the H100
// form of "each row read once" is the column march of march.cuh.
//
// Bound on the H100: memory.  z = A x moves L (3 fields), D, x and z: 6
// fields a cell (4.5 with bf16 L), against ~15 flops.  The first kernel
// (stream_stencil.cu before this design: tiles of 32 x 8 cells from cell 0,
// so the ninth tile of a 258 row ran 2 of its 32 lanes, x, L1 and L2 staged
// in shared plane tiles with a one-cell halo, two barriers a row, and one
// dot partial a block summed by a second launch, torch.sum) took 0.1976 ms
// at 258^3 (0.62 of its 0.1230 ms bound), 0.1886 with L16 (0.49); the
// default path's one-thread-a-cell kernel (poisson_stencil.cu before it
// took this one) 0.1894 and 0.1854 (0.50).
// Design: an (8, 32) tile of interior columns a block, one thread a
// column, marching a chunk of interior planes with x[i-1], x[i], x[i+1],
// L0[i] and L0[i+1] in registers: each loaded once.  In-plane taps: j+-1
// and L1[j+1] are loads of the neighbouring rows of the tile's own plane,
// which hit the lines those rows' loads brought into L1; k+-1 and L2[k+1]
// come from the neighbouring lanes by warp shuffles (the warp's edge lanes
// load their halo cell).  No shared tile and no barrier in the march.  z's
// ghost cells are written as exact zeros by the threads of the interior
// cells beside them (`march_ghosts`), the ghost planes by the first and
// last chunks: each cell of z once.  The dot accumulates in registers down
// the march, then over the block by warp shuffles; the last block sums the
// partials in index order: one launch, the same bits on every call.  The
// caller cuts the planes into chunks of 2 to 32, as many as a wave of the
// blocks the card holds at once needs (`wl_stream_coresident`).
// On the H100 at 258^3 that takes 0.155 ms with f32 L (0.79 of the bound)
// and 0.133 with L16 (0.69), 32 registers; k+-1 and L2[k+1] loaded from
// L1 took 0.161 and 0.139, though 0.0005 ms less at 66^3; chunks of 64
// planes (1024 blocks, one wave) cost L16 3%, and at 130^3 512 blocks of
// 16 planes took 0.029 ms against 0.023 for 1024 of 8; at 66^3 chunks of 2
// planes beat chunks of 4 by 10%.  Without the dot the march streams at
// 0.81 of the bound at 258^3, where the flat one-thread-a-cell kernel it
// replaced reached 0.86; unrolling the march by 4 or 1 (not 2), and
// evict-first loads of L0, L2, D with evict-first stores of z, were
// slower.
// Exactness: the association of `ax_cell_at` (common.cuh); built with
// --fmad=false z equals the plain version bit for bit.
// Members (an ensemble under torch.func.vmap, `mult3d`'s member form): one
// launch marches every member's x (and L, D where each member has its own:
// a member stride of 0 shares one operator) with a one-member launch's
// chunks, writes each member's z and gives each member its own dot in a
// one-member launch's order (march.cuh): bit for bit its own launch.
#include "march.cuh"

// TL: L's type, TX: x's.  DOT: reduce <z, x> into out (partial: one float
// a block, count: the zeroed counter).  MB: the member-axis instance.
template <typename TL, typename TX, bool DOT, bool MB>
__global__ void __launch_bounds__(MARCH_THREADS)
stream_mult_kernel(const TL* __restrict__ L, const float* __restrict__ Dd,
                   const TX* __restrict__ x, float* __restrict__ z,
                   float* partial, unsigned int* count, float* out, int S0,
                   int S1, int S2, int planes, long long sL, long long sD,
                   long long sx) {
  __shared__ float sh[MARCH_THREADS / 32];
  const Column col = march_column<MB>(S0, S1, S2, planes);
  const int P = S1 * S2, N = S0 * P;
  if (MB) {
    L += col.m * sL;
    Dd += col.m * sD;
    x += col.m * sx;
    z += (long long)col.m * N;
  }
  const TL* __restrict__ L0 = L;
  const TL* __restrict__ L1 = L + N;
  const TL* __restrict__ L2 = L + 2 * N;
  const auto zero = [z](int a) { z[a] = 0.f; };
  const int j = col.j, k = col.k, lane = threadIdx.x;
  const bool in = col.in;
  const bool jl = j == 1, jh = j == S1 - 2, kl = k == 1, kh = k == S2 - 2;
  int at = col.i0 * P + j * S2 + k;
  float xm = 0.f, xc = 0.f, l0c = 0.f, dot = 0.f;
  if (in) {
    if (col.i0 == 1) {   // ghost plane 0
      z[at - P] = 0.f;
      march_ghosts(at - P, jl, jh, kl, kh, S2, zero);
    }
    xm = ld(x[at - P]);
    xc = ld(x[at]);
    l0c = ld(L0[at]);
  }
#pragma unroll 2
  for (int i = col.i0; i < col.i1; ++i, at += P) {
    float xn = 0.f, l0n = 0.f, l2c = 0.f;
    if (in) {
      xn = ld(x[at + P]);
      l0n = ld(L0[at + P]);
      l2c = ld(L2[at]);
    }
    // every lane of the warp takes part in the shuffles
    float xkm = __shfl_up_sync(0xffffffffu, xc, 1);
    float xkp = __shfl_down_sync(0xffffffffu, xc, 1);
    float l2p = __shfl_down_sync(0xffffffffu, l2c, 1);
    if (in && lane == 0) xkm = ld(x[at - 1]);
    if (in && (lane == MARCH_TK - 1 || kh)) {
      xkp = ld(x[at + 1]);
      l2p = ld(L2[at + 1]);
    }
    if (in) {
      // ax_cell_at's association
      float s = xc * Dd[at];
      s = s + xm * l0c;
      s = s + xn * l0n;
      s = s + ld(x[at - S2]) * ld(L1[at]);
      s = s + ld(x[at + S2]) * ld(L1[at + S2]);
      s = s + xkm * l2c;
      s = s + xkp * l2p;
      z[at] = s;
      march_ghosts(at, jl, jh, kl, kh, S2, zero);
      if (DOT) dot = dot + s * xc;
    }
    xm = xc;
    xc = xn;
    l0c = l0n;
  }
  if (in && col.i1 == S0 - 1) {   // ghost plane S0-1: at is its cell now
    z[at] = 0.f;
    march_ghosts(at, jl, jh, kl, kh, S2, zero);
  }
  if (DOT)
    march_finish<SumOp>(col, block_reduce<SumOp>(dot, 0.f, sh), 0.f,
                        partial, count, out, sh);
}

// Calls f with the kernel instance for L's and x's types (bf16 where
// L_bf16 / x_bf16, else f32), with the dot or without, with the member
// axis (mb) or without.
template <typename F>
static void with_stream_mult(int L_bf16, int x_bf16, bool dot, bool mb,
                             F f) {
  dispatch_bf16(L_bf16, x_bf16, [&](auto tl, auto tx) {
    using TL = TAG_T(tl);
    using TX = TAG_T(tx);
    if (mb) {
      if (dot)
        f(tl, tx, stream_mult_kernel<TL, TX, true, true>);
      else
        f(tl, tx, stream_mult_kernel<TL, TX, false, true>);
    } else if (dot) {
      f(tl, tx, stream_mult_kernel<TL, TX, true, false>);
    } else {
      f(tl, tx, stream_mult_kernel<TL, TX, false, false>);
    }
  });
}

// z = A x.  partial, count, out: NULL for z alone; else one float a block
// of a member's grid (`march_grid`), member after member, a zeroed counter
// a member (left zeroed) and each member's dot.  L_bf16 / x_bf16: L / x are
// bf16 (else f32).  members: z holds that many fields one after another;
// member m reads L + m sL, Dd + m sD, x + m sx (elements; 0: shared; one
// field: members 1).  Calls that share a counter run on one stream.
extern "C" int wl_mult3d_stream(const void* L, const float* Dd, const void* x,
                                float* z, float* partial, unsigned int* count,
                                float* out, int members, long long sL,
                                long long sD, long long sx, int L_bf16,
                                int x_bf16, int planes, int S0, int S1,
                                int S2, void* stream) {
  if (!march_shape_ok(S0, S1, S2, planes, members))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = march_grid(S0, S1, S2, planes, members);
  const dim3 block(MARCH_TK, MARCH_TJ);
  const cudaStream_t s = (cudaStream_t)stream;
  with_stream_mult(L_bf16, x_bf16, partial != nullptr, members > 1,
                   [&](auto tl, auto tx, auto kern) {
    kern<<<grid, block, 0, s>>>((const TAG_T(tl)*)L, Dd,
                                (const TAG_T(tx)*)x, z, partial, count, out,
                                S0, S1, S2, planes, sL, sD, sx);
  });
  return (int)cudaGetLastError();
}

// Blocks of the one-field kernel instance (L's and x's types, with the dot
// or without) the card holds at once: occupancy times the SMs (the chunk
// rule of both instances, so that a member marches as its own launch).
extern "C" int wl_stream_coresident(int L_bf16, int x_bf16, int dot) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  with_stream_mult(L_bf16, x_bf16, dot, false, [&](auto, auto, auto kern) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                  MARCH_THREADS, 0);
  });
  return sms * per_sm;
}
