// The plane march of the interior reductions cfl3d (cfl.cu), ana_mult3d
// (ana_stencil.cu) and pcg_dir_mult (pcg_iter.cu), and their one-launch
// reduction.
//
// A block owns a MARCH_TJ x MARCH_TK tile of interior (axis 1, axis 2)
// columns, one thread a column (a warp a row of the tile), and marches a
// chunk of interior axis-0 planes, carrying its column's axis-0 taps from
// plane to plane in registers, so each value is loaded once.  The tiles
// start at the first interior cell (1, 1), so that 256 interior columns
// fill whole warps; indices are 32-bit and need no division.  The caller
// chooses the chunk (`planes`) from the shape: the grid is
// (ceil((S2-2)/MARCH_TK), ceil((S1-2)/MARCH_TJ), members * chunks), with
// chunks = ceil((S0-2)/planes) and members 1 for one field.
//
// Members (an ensemble's fields, one after another in memory): the grid's
// z axis runs over each member's chunks in turn (blockIdx.z = member *
// chunks + chunk), so every member is marched with the chunks, blocks and
// reduction order of a one-member launch, and a launch of M members gives
// each member the bits of its own launch.  The kernel offsets its operands
// by the member index (`Column::m`) times their member strides, 0 for an
// operand every member shares.  A kernel takes members in its instance
// with MB (member-axis) true; its one-field instance (MB false, member 0,
// the chunk blockIdx.z) leaves its pointers as they are passed: offsetting
// them moved each pointer from the constant bank into two registers a
// thread (the operator march went from 32 to 40 registers and took 0.181
// ms at 258^3 against 0.156; cfl3d 0.096 against 0.069; H100 80GB HBM3,
// 700 W).
//
// The reduction: each thread reduces its column in registers, the block
// reduces its threads by warp shuffles (a fixed tree), and each block
// writes one partial; the last block to finish (elected by a counter,
// which it resets) reduces the partials in index order and writes the
// result.  One launch, no atomics in the reduction, and the order of every
// sum fixed by the shape and the grid: the same bits on every call.
#pragma once

#include "common.cuh"

#define MARCH_TJ 8    // tile rows along axis 1 (threadIdx.y, one warp each)
#define MARCH_TK 32   // tile columns along axis 2 (threadIdx.x)
#define MARCH_THREADS (MARCH_TJ * MARCH_TK)

// This thread's interior column (j, k), its block's planes [i0, i1), its
// member m and its block's chunk of that member's `chunks`.
struct Column {
  int j, k;
  bool in;   // (j, k) is an interior column (the tile may overhang)
  int i0, i1;
  int m, chunk, chunks;
};

template <bool MB = false>
__device__ inline Column march_column(int S0, int S1, int S2, int planes) {
  Column c;
  c.j = 1 + (int)blockIdx.y * MARCH_TJ + (int)threadIdx.y;
  c.k = 1 + (int)blockIdx.x * MARCH_TK + (int)threadIdx.x;
  c.in = c.j <= S1 - 2 && c.k <= S2 - 2;
  if (MB) {
    c.chunks = (S0 - 2 + planes - 1) / planes;
    c.m = (int)blockIdx.z / c.chunks;
    c.chunk = (int)blockIdx.z - c.m * c.chunks;
  } else {
    c.chunks = (int)gridDim.z;
    c.m = 0;
    c.chunk = (int)blockIdx.z;
  }
  c.i0 = 1 + c.chunk * planes;
  c.i1 = min(c.i0 + planes, S0 - 1);
  return c;
}

struct MaxOp {   // NaN-propagating, as torch.max
  static __device__ __forceinline__ float f(float a, float b) {
    return tmax(a, b);
  }
};
struct SumOp {
  static __device__ __forceinline__ float f(float a, float b) { return a + b; }
};

template <class Op>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = Op::f(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// v[0..N) each reduced over the block (a fixed tree), valid in thread 0;
// every thread calls it.  ``sh`` holds N * MARCH_THREADS / 32 floats.
template <class Op, int N>
__device__ inline void block_reduce_n(float (&v)[N], float id, float* sh) {
  constexpr int W = MARCH_THREADS / 32;
  const int t = threadIdx.y * MARCH_TK + threadIdx.x;
#pragma unroll
  for (int q = 0; q < N; ++q) v[q] = warp_reduce<Op>(v[q]);
  if ((t & 31) == 0) {
#pragma unroll
    for (int q = 0; q < N; ++q) sh[q * W + (t >> 5)] = v[q];
  }
  __syncthreads();
  if (t < 32) {
#pragma unroll
    for (int q = 0; q < N; ++q)
      v[q] = warp_reduce<Op>(t < W ? sh[q * W + t] : id);
  }
}

template <class Op>
__device__ inline float block_reduce(float v, float id, float* sh) {
  float a[1] = {v};
  block_reduce_n<Op, 1>(a, id, sh);
  return a[0];
}

// Publishes the block's N partials ``r`` (thread 0's, after
// `block_reduce_n`) and, in the last block of its member to finish,
// reduces each one's partials of that member in index order into
// out[0..N) and resets the member's counter to 0.  ``partial`` holds, member
// after member, N runs of one float a block of a member; ``count`` and
// ``out`` one counter and N results a member.  ``c``: the block's
// `march_column`.  Every thread of the block calls it; true in the thread
// that wrote out (thread 0 of the member's last block).
template <class Op, int N>
__device__ inline bool march_finish_n(const Column& c, const float (&r)[N],
                                      float id, float* partial,
                                      unsigned int* count, float* out,
                                      float* sh) {
  __shared__ bool last;
  const int t = threadIdx.y * MARCH_TK + threadIdx.x;
  const unsigned int b =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * c.chunk);
  const unsigned int n = gridDim.x * gridDim.y * c.chunks;
  partial += (long long)c.m * N * n;
  count += c.m;
  out += c.m * N;
  if (t == 0) {
#pragma unroll
    for (int q = 0; q < N; ++q) partial[q * n + b] = r[q];
    __threadfence();   // the partials are visible before the count says so
    last = atomicAdd(count, 1u) == n - 1;
  }
  __syncthreads();
  if (!last) return false;
  float v[N];
#pragma unroll
  for (int q = 0; q < N; ++q) v[q] = id;
  for (unsigned int p = t; p < n; p += MARCH_THREADS) {
#pragma unroll
    for (int q = 0; q < N; ++q)
      v[q] = Op::f(v[q], __ldcg(&partial[q * n + p]));
  }
  block_reduce_n<Op, N>(v, id, sh);
  if (t == 0) {
#pragma unroll
    for (int q = 0; q < N; ++q) out[q] = v[q];
    *count = 0u;
  }
  return t == 0;
}

template <class Op>
__device__ inline void march_finish(const Column& c, float r, float id,
                                    float* partial, unsigned int* count,
                                    float* out, float* sh) {
  const float a[1] = {r};
  march_finish_n<Op, 1>(c, a, id, partial, count, out, sh);
}

// Calls ``ghost(a)`` once for each ghost cell a next to interior column
// (j, k) in the plane whose cell (j, k) is at flat index ``at``: row 0
// (jl: j == 1) and row S1-1 (jh: j == S1-2), column 0 (kl: k == 1) and
// column S2-1 (kh: k == S2-2), and the corners between them.  Together the
// interior columns' calls cover every ghost cell of a plane exactly once.
template <typename F>
__device__ inline void march_ghosts(int at, bool jl, bool jh, bool kl,
                                    bool kh, int S2, F ghost) {
  if (jl) {
    ghost(at - S2);
    if (kl) ghost(at - S2 - 1);
    if (kh) ghost(at - S2 + 1);
  }
  if (jh) {
    ghost(at + S2);
    if (kl) ghost(at + S2 - 1);
    if (kh) ghost(at + S2 + 1);
  }
  if (kl) ghost(at - 1);
  if (kh) ghost(at + 1);
}

// The launch grid of a march of ``members`` members with ``planes`` planes
// a block.
inline dim3 march_grid(int S0, int S1, int S2, int planes, int members = 1) {
  return dim3((S2 - 2 + MARCH_TK - 1) / MARCH_TK,
              (S1 - 2 + MARCH_TJ - 1) / MARCH_TJ,
              members * ((S0 - 2 + planes - 1) / planes));
}

// Shapes the marches take: every axis has an interior, the three
// components of a vector field index in 32 bits, and the members' chunks
// fit the grid's z axis (65535).
inline bool march_shape_ok(int S0, int S1, int S2, int planes,
                           int members = 1) {
  return S0 >= 3 && S1 >= 3 && S2 >= 3 && planes >= 1 && members >= 1 &&
         (long long)3 * S0 * S1 * S2 < (1LL << 31) &&
         (long long)members * ((S0 - 2 + planes - 1) / planes) <= 65535;
}
