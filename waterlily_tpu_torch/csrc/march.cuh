// The plane march of the interior reductions cfl3d (cfl.cu) and
// ana_mult3d (ana_stencil.cu), and their one-launch reduction.
//
// A block owns a MARCH_TJ x MARCH_TK tile of interior (axis 1, axis 2)
// columns, one thread a column (a warp a row of the tile), and marches a
// chunk of interior axis-0 planes, carrying its column's axis-0 taps from
// plane to plane in registers, so each value is loaded once.  The tiles
// start at the first interior cell (1, 1), so that 256 interior columns
// fill whole warps; indices are 32-bit and need no division.  The caller
// chooses the chunk (`planes`) from the shape: the grid is
// (ceil((S2-2)/MARCH_TK), ceil((S1-2)/MARCH_TJ), ceil((S0-2)/planes)).
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

// This thread's interior column (j, k) and its block's planes [i0, i1).
struct Column {
  int j, k;
  bool in;   // (j, k) is an interior column (the tile may overhang)
  int i0, i1;
};

__device__ inline Column march_column(int S0, int S1, int S2, int planes) {
  Column c;
  c.j = 1 + (int)blockIdx.y * MARCH_TJ + (int)threadIdx.y;
  c.k = 1 + (int)blockIdx.x * MARCH_TK + (int)threadIdx.x;
  c.in = c.j <= S1 - 2 && c.k <= S2 - 2;
  c.i0 = 1 + (int)blockIdx.z * planes;
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

// v reduced over the block (a fixed tree), valid in thread 0; every
// thread calls it.  ``sh`` holds MARCH_THREADS / 32 floats.
template <class Op>
__device__ inline float block_reduce(float v, float id, float* sh) {
  const int t = threadIdx.y * MARCH_TK + threadIdx.x;
  v = warp_reduce<Op>(v);
  if ((t & 31) == 0) sh[t >> 5] = v;
  __syncthreads();
  if (t < 32) v = warp_reduce<Op>(t < MARCH_THREADS / 32 ? sh[t] : id);
  return v;
}

// Publishes the block's partial ``r`` (thread 0's) and, in the last block
// to finish, reduces every partial in index order into *out and resets
// *count to 0.  Every thread of the block calls it, after `block_reduce`.
template <class Op>
__device__ inline void march_finish(float r, float id, float* partial,
                                    unsigned int* count, float* out,
                                    float* sh) {
  __shared__ bool last;
  const int t = threadIdx.y * MARCH_TK + threadIdx.x;
  const unsigned int b =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const unsigned int n = gridDim.x * gridDim.y * gridDim.z;
  if (t == 0) {
    partial[b] = r;
    __threadfence();   // the partial is visible before the count says so
    last = atomicAdd(count, 1u) == n - 1;
  }
  __syncthreads();
  if (!last) return;
  float v = id;
  for (unsigned int q = t; q < n; q += MARCH_THREADS)
    v = Op::f(v, __ldcg(&partial[q]));
  v = block_reduce<Op>(v, id, sh);
  if (t == 0) {
    *out = v;
    *count = 0u;
  }
}

// The launch grid of a march with ``planes`` planes a block.
inline dim3 march_grid(int S0, int S1, int S2, int planes) {
  return dim3((S2 - 2 + MARCH_TK - 1) / MARCH_TK,
              (S1 - 2 + MARCH_TJ - 1) / MARCH_TJ,
              (S0 - 2 + planes - 1) / planes);
}

// Shapes the marches take: every axis has an interior, and the three
// components of a vector field index in 32 bits.
inline bool march_shape_ok(int S0, int S1, int S2, int planes) {
  return S0 >= 3 && S1 >= 3 && S2 >= 3 && planes >= 1 &&
         (long long)3 * S0 * S1 * S2 < (1LL << 31);
}
