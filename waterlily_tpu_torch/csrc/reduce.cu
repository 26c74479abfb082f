// Solver dots and the PCG axpy-pair sweep of the blocked (big 3D) levels.
//
// `wl_dot3d` replaces waterlily_tpu/ops/attic.py `dot3d_pallas`
// (`_dot_kernel`): per-block partials of an interior dot in three modes,
// aa = sum a*a, ab = sum a*b, rid = sum a*(a*b) (the PCG rho <r, r*iD>
// without writing the product), in the TPU kernel's multiply order; in rid
// mode b may be bf16 (a level's iD16 shadow, upcast in registers as the TPU
// kernel does).
// `wl_pcg_axpy` replaces `pcg_axpy_pallas` (`_axpy_rid_kernel`): the axpy
// pair and the next rho (pcg_axpy.cuh, shared with the fused iteration's
// second sweep).
//
// Bound on the H100: memory.  A dot reads one field (aa) or two and does
// 2-3 flops a cell.  Design: a fixed number of blocks (the caller's
// ``blocks``), each walking whole interior rows of axis 2 with its threads
// striding along the row and summing in registers, then one tree reduction
// per block.  A first form with one thread per cell and a block reduction
// per 256 cells ran at 5.4x its bound at 258^3 on the H100 (4.5x
// torch.dot), and one block per row no faster: the per-block work
// (scheduling a block and its tree), not the index arithmetic, set its
// time.  Rows need no index division per cell, and ghost cells are never
// read (NaN-safe, no ragged block).  The blocks' partials are summed by the
// caller with one device reduction.  No atomics, and the work of each block
// is fixed by the shape, so a solve's r.r, and with it the iteration count,
// is the same from run to run.
#include "common.cuh"
#include "pcg_axpy.cuh"

// MODE: 0 aa, 1 ab, 2 rid.  Block q takes the interior rows
// r = q, q + gridDim.x, ..., row r being (i, j) = (r / (S1-2) + 1,
// r % (S1-2) + 1).
template <int MODE, typename TB>
__global__ void dot_kernel(const float* __restrict__ a,
                           const TB* __restrict__ b,
                           float* __restrict__ partial, Shape3 g) {
  __shared__ float sh[WL_THREADS];
  const int rows1 = g.S[1] - 2, nrows = (g.S[0] - 2) * rows1;
  float v = 0.f;
  for (int r = blockIdx.x; r < nrows; r += gridDim.x) {
    const long long row =
        ((long long)(r / rows1 + 1) * g.S[1] + (r % rows1 + 1)) * g.S[2];
    for (int k = 1 + threadIdx.x; k <= g.S[2] - 2; k += blockDim.x) {
      const float ac = a[row + k];
      if (MODE == 0)
        v += ac * ac;
      else if (MODE == 1)
        v += ac * ld(b[row + k]);
      else
        v += ac * (ac * ld(b[row + k]));
    }
  }
  const float s = block_sum(v, sh);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

// b is not read in mode 0 (may be NULL), bf16 in mode 2 with b_bf16 (else
// f32); partial holds ``blocks`` floats
extern "C" int wl_dot3d(const float* a, const void* b, float* partial,
                        int mode, int b_bf16, int blocks, int S0, int S1,
                        int S2, void* stream) {
  const Shape3 g = make_shape(S0, S1, S2);
  int threads = 32;  // a power of two covering a row, at most WL_THREADS
  while (threads < S2 - 2 && threads < WL_THREADS) threads *= 2;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* bf = (const float*)b;
  if (b_bf16 && mode != 2) return (int)cudaErrorInvalidValue;
  if (mode == 0)
    dot_kernel<0, float><<<blocks, threads, 0, s>>>(a, bf, partial, g);
  else if (mode == 1)
    dot_kernel<1, float><<<blocks, threads, 0, s>>>(a, bf, partial, g);
  else if (mode == 2 && b_bf16)
    dot_kernel<2, __nv_bfloat16><<<blocks, threads, 0, s>>>(
        a, (const __nv_bfloat16*)b, partial, g);
  else if (mode == 2)
    dot_kernel<2, float><<<blocks, threads, 0, s>>>(a, bf, partial, g);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int wl_pcg_axpy(const float* x, const float* r, const void* eps,
                           const float* z, const void* iD, const float* upd,
                           float* x_out, float* r_out, float* partial,
                           int eps_bf16, int iD_bf16, int S0, int S1, int S2,
                           void* stream) {
  return launch_axpy_rho(x, r, eps, z, iD, upd, x_out, r_out, partial,
                         eps_bf16, iD_bf16, S0, S1, S2, stream);
}
