// Solver dots and the PCG axpy-pair sweep of the blocked (big 3D) levels.
//
// `wl_dot3d` replaces waterlily_tpu/ops/attic.py `dot3d_pallas`
// (`_dot_kernel`): an interior dot in three modes,
// aa = sum a*a, ab = sum a*b, rid = sum a*(a*b) (the PCG rho <r, r*iD>
// without writing the product), in the TPU kernel's multiply order; in rid
// mode b may be bf16 (a level's iD16 shadow, upcast in registers as the TPU
// kernel does).
// `wl_pcg_axpy` replaces `pcg_axpy_pallas` (`_axpy_rid_kernel`): the axpy
// pair and the next rho (pcg_axpy.cuh, shared with the fused iteration's
// second sweep).
//
// Bound on the H100: memory.  A dot reads one field (aa) or two and does
// 2-3 flops a cell.  Design: a grid sized to the card and to the work (the
// caller's ``blocks``: at most eight an SM, at least 16 rows a block, so
// that a small level keeps its blocks' loads in flight and leaves the last
// block few partials to sum), block q summing the contiguous
// interior rows [q R / G, (q+1) R / G) of axis 2 (R rows, G blocks), its
// threads striding along the rows.  Each thread loads DOT_UNROLL rows
// before it adds any of them, so that every thread keeps several
// independent loads in flight: the first form (one load in flight a
// thread, a dependent add between rows, and a second launch to sum the
// partials) ran at 0.0528 ms at 258^3 against torch.dot's 0.0295.  Rows need
// no index division per cell, and ghost cells are never read (NaN-safe).
// Each block reduces its threads by a deterministic tree and writes its
// partial; the last block to finish (elected by a counter, which it resets)
// sums the partials in index order, so a dot is one launch.  No atomics in
// the sum, and the order of every sum is fixed by the shape and the grid,
// so a solve's r.r, and with it the iteration count, is the same from run
// to run.
// Members (an ensemble under torch.func.vmap, `dot3d`'s and `pcg_axpy`'s
// member forms): one launch sums every member's dot, blockIdx.y the
// member, each member with its own launch's blocks and rows, its own
// partials, counter and result, so bit for bit its own launch; each operand
// sits at its own member stride (0 for one every member shares).  The
// one-field instances (MB false) leave their pointers as they are passed.
#include "common.cuh"
#include "pcg_axpy.cuh"

#define DOT_UNROLL 8

template <int MODE, typename TB>
__device__ __forceinline__ float dot_term(const float* __restrict__ a,
                                          const TB* __restrict__ b, int c) {
  const float ac = a[c];
  if (MODE == 0) return ac * ac;
  if (MODE == 1) return ac * ld(b[c]);
  return ac * (ac * ld(b[c]));
}

// MODE: 0 aa, 1 ab, 2 rid.  Interior row r is (i, j) = (r / (S1-2) + 1,
// r % (S1-2) + 1).  count: a zeroed counter (left zeroed); out: the dot.
// MB: the member-axis instance (member blockIdx.y; a, b at strides sa, sb;
// partials, counter and result a member's own).
template <int MODE, typename TB, bool MB>
__global__ void dot_kernel(const float* __restrict__ a,
                           const TB* __restrict__ b, float* partial,
                           unsigned int* count, float* out, int S0, int S1,
                           int S2, long long sa, long long sb) {
  __shared__ float sh[WL_THREADS];
  if constexpr (MB) {
    const long long m = blockIdx.y;
    a += m * sa;
    if (MODE != 0) b += m * sb;
    partial += m * gridDim.x;
    count += m;
    out += m;
  }
  const int rows1 = S1 - 2, nrows = (S0 - 2) * rows1, P = S1 * S2;
  const int r0 = (int)((long long)blockIdx.x * nrows / gridDim.x);
  const int r1 = (int)((long long)(blockIdx.x + 1) * nrows / gridDim.x);
  int i = r0 / rows1 + 1, j = r0 % rows1 + 1;   // row r0's cell (i, j, 0)
  float v = 0.f;
  for (int r = r0; r < r1; r += DOT_UNROLL) {
    int base[DOT_UNROLL];
#pragma unroll
    for (int q = 0; q < DOT_UNROLL; ++q) {
      base[q] = r + q < r1 ? i * P + j * S2 : -1;
      if (++j > rows1) {
        j = 1;
        ++i;
      }
    }
    for (int k = 1 + threadIdx.x; k <= S2 - 2; k += blockDim.x) {
      float t[DOT_UNROLL];
#pragma unroll
      for (int q = 0; q < DOT_UNROLL; ++q)
        t[q] = base[q] >= 0 ? dot_term<MODE>(a, b, base[q] + k) : 0.f;
#pragma unroll
      for (int q = 0; q < DOT_UNROLL; ++q) v += t[q];
    }
  }
  finish_sum(block_sum(v, sh), partial, count, out, sh);
}

// One dot_kernel launch: members > 1 the member-axis instance.
template <int MODE, typename TB>
static void launch_dot(int blocks, int threads, int members, cudaStream_t s,
                       const float* a, const void* b, float* partial,
                       unsigned int* count, float* out, int S0, int S1,
                       int S2, long long sa, long long sb) {
  const TB* bt = (const TB*)b;
  if (members > 1)
    dot_kernel<MODE, TB, true><<<dim3(blocks, members), threads, 0, s>>>(
        a, bt, partial, count, out, S0, S1, S2, sa, sb);
  else
    dot_kernel<MODE, TB, false><<<blocks, threads, 0, s>>>(
        a, bt, partial, count, out, S0, S1, S2, sa, sb);
}

// b is not read in mode 0 (may be NULL), bf16 in mode 2 with b_bf16 (else
// f32); partial holds ``blocks`` floats a member, count one zeroed unsigned
// int a member (left zeroed), out one float a member.  members: a holds
// that many fields, member m at a + m sa (b + m sb; elements, 0: shared;
// one field: members 1).  Calls that share a counter run on one stream.
extern "C" int wl_dot3d(const float* a, const void* b, float* partial,
                        unsigned int* count, float* out, int mode, int b_bf16,
                        int blocks, int members, long long sa, long long sb,
                        int S0, int S1, int S2, void* stream) {
  if ((long long)S0 * S1 * S2 >= (1LL << 31) || blocks < 1 ||
      blocks > (S0 - 2) * (S1 - 2) || members < 1 || members > 65535)
    return (int)cudaErrorInvalidValue;
  int threads = 32;  // a power of two covering a row, at most WL_THREADS
  while (threads < S2 - 2 && threads < WL_THREADS) threads *= 2;
  const cudaStream_t s = (cudaStream_t)stream;
  if (b_bf16 && mode != 2) return (int)cudaErrorInvalidValue;
  if (mode == 0)
    launch_dot<0, float>(blocks, threads, members, s, a, b, partial, count,
                         out, S0, S1, S2, sa, sb);
  else if (mode == 1)
    launch_dot<1, float>(blocks, threads, members, s, a, b, partial, count,
                         out, S0, S1, S2, sa, sb);
  else if (mode == 2 && b_bf16)
    launch_dot<2, __nv_bfloat16>(blocks, threads, members, s, a, b, partial,
                                 count, out, S0, S1, S2, sa, sb);
  else if (mode == 2)
    launch_dot<2, float>(blocks, threads, members, s, a, b, partial, count,
                         out, S0, S1, S2, sa, sb);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int wl_pcg_axpy(const float* x, const float* r, const void* eps,
                           const float* z, const void* iD, const float* upd,
                           float* x_out, float* r_out, float* partial,
                           unsigned int* count, float* out, int eps_bf16,
                           int iD_bf16, int blocks, int members,
                           long long sx, long long sr, long long se,
                           long long sz, long long si, long long su, int S0,
                           int S1, int S2, void* stream) {
  return launch_axpy_rho(x, r, eps, z, iD, upd, nullptr, nullptr, x_out,
                         r_out, partial, count, out, eps_bf16, iD_bf16,
                         blocks, members,
                         AxpyStrides{sx, sr, se, sz, si, su, 0}, S0, S1, S2,
                         stream);
}

extern "C" int wl_axpy_coresident(int eps_bf16, int iD_bf16) {
  return axpy_coresident(eps_bf16, iD_bf16);
}
