// Index, mask and reduction helpers shared by the waterlily_tpu_torch kernels.
//
// Layout (the JAX package's): a scalar field is a contiguous (S0, S1, S2)
// f32 array with one ghost cell on each side of every axis, axis 2 fastest;
// a vector field is (3, S0, S1, S2), component-major.  Flat index
// c = (i*S1 + j)*S2 + k.  One thread handles one output cell, so neighbouring
// threads touch neighbouring addresses (threadIdx.x runs along axis 2).
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

#define WL_THREADS 256

struct Shape3 {
  int S[3];
  long long N;       // cells of one scalar field
  long long st[3];   // flat strides of the three axes
};

__host__ __device__ inline Shape3 make_shape(int S0, int S1, int S2) {
  Shape3 g;
  g.S[0] = S0; g.S[1] = S1; g.S[2] = S2;
  g.N = (long long)S0 * S1 * S2;
  g.st[0] = (long long)S1 * S2; g.st[1] = S2; g.st[2] = 1;
  return g;
}

__device__ inline void unflatten(const Shape3& g, long long c, int idx[3]) {
  idx[2] = (int)(c % g.S[2]);
  long long q = c / g.S[2];
  idx[1] = (int)(q % g.S[1]);
  idx[0] = (int)(q / g.S[1]);
}

__device__ inline bool is_interior(const Shape3& g, const int idx[3]) {
  return idx[0] >= 1 && idx[0] <= g.S[0] - 2 && idx[1] >= 1 &&
         idx[1] <= g.S[1] - 2 && idx[2] >= 1 && idx[2] <= g.S[2] - 2;
}

// NaN-propagating max/min: the semantics of torch.maximum / torch.minimum
// (fmaxf/fminf would drop a NaN operand and hide a blow-up).
__device__ inline float tmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ inline float tmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

// z = A x at an interior cell of the 7-point variable-coefficient Poisson
// operator, with the association of waterlily_tpu.ops.poisson
// `_mult_interior_arrays`: s = x*D, then per axis s = (s + x[-]*L) + x[+]*L[+].
// An interior cell's six neighbours always lie inside the array.
__device__ inline float ax_cell(const float* L, const float* Dd,
                                const float* x, const Shape3& g, long long c) {
  float s = x[c] * Dd[c];
  for (int a = 0; a < 3; ++a) {
    const float* La = L + a * g.N;
    const long long st = g.st[a];
    s = s + x[c - st] * La[c];
    s = s + x[c + st] * La[c + st];
  }
  return s;
}

// Deterministic tree reductions over a block (blockDim.x * blockDim.y a
// power of two, sh holds that many floats; a 2D block reduces in the order
// of its flat thread index threadIdx.y * blockDim.x + threadIdx.x).  Every
// thread of the block must call them; all threads receive the result.
__device__ inline float block_sum(float v, float* sh) {
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int s = blockDim.x * blockDim.y / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = sh[t] + sh[t + s];
    __syncthreads();
  }
  float out = sh[0];
  __syncthreads();
  return out;
}

__device__ inline float block_max(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] = tmax(sh[threadIdx.x], sh[threadIdx.x + s]);
    __syncthreads();
  }
  float out = sh[0];
  __syncthreads();
  return out;
}

inline int blocks_for(long long n) {
  return (int)((n + WL_THREADS - 1) / WL_THREADS);
}
