// Index, mask and reduction helpers shared by the waterlily_tpu_torch kernels.
//
// Layout (the JAX package's): a scalar field is a contiguous (S0, S1, S2)
// f32 array (bf16 for a search direction stored in bf16 and for a level's
// operator shadows L16 and iD16) with one ghost
// cell on each side of every axis, axis 2 fastest;
// a vector field is (3, S0, S1, S2), component-major.  Flat index
// c = (i*S1 + j)*S2 + k.  One thread handles one output cell, so neighbouring
// threads touch neighbouring addresses (threadIdx.x runs along axis 2).
#pragma once

#include <cfloat>
#include <cuda_bf16.h>
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
// (fmaxf/fminf would drop a NaN operand and hide a blow-up), one PTX
// instruction each (.NaN, sm_80 and later) where the two NaN tests around
// fmaxf/fminf took three.
__device__ inline float tmax(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}
__device__ inline float tmin(float a, float b) {
  float m;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

// The f32 value of a stored operand: a float as it is, a bf16 upcast (exact).
__device__ inline float ld(float v) { return v; }
__device__ inline float ld(__nv_bfloat16 v) { return __bfloat162float(v); }

// z = A x at an interior cell of the 7-point variable-coefficient Poisson
// operator, with the association of waterlily_tpu.ops.poisson
// `_mult_interior_arrays`: s = x*D, then per axis s = (s + x[-]*L) + x[+]*L[+].
// ``xv(i)`` gives x at flat index i as a float.  L is f32, or bf16 (a level's
// operator shadow L16, upcast in registers: the bf16-rounded operator applied
// in f32).  An interior cell's six neighbours always lie inside the array.
template <typename TL, typename F>
__device__ inline float ax_cell_at(const TL* L, const float* Dd, F xv,
                                   const Shape3& g, long long c) {
  float s = xv(c) * Dd[c];
  for (int a = 0; a < 3; ++a) {
    const TL* La = L + a * g.N;
    const long long st = g.st[a];
    s = s + xv(c - st) * ld(La[c]);
    s = s + xv(c + st) * ld(La[c + st]);
  }
  return s;
}

// The same from a stored x (f32, or bf16 upcast in registers).
template <typename TL, typename T>
__device__ inline float ax_cell(const TL* L, const float* Dd, const T* x,
                                const Shape3& g, long long c) {
  return ax_cell_at(L, Dd, [x](long long i) { return ld(x[i]); }, g, c);
}

// Deterministic tree sum over a block (blockDim.x * blockDim.y a power of
// two, sh holds that many floats; a 2D block reduces in the order of its
// flat thread index threadIdx.y * blockDim.x + threadIdx.x).  Every thread
// of the block must call it; all threads receive the result.
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

// Publishes a 1D block's sum ``s`` (from `block_sum`) as its partial and,
// in the last block to finish (elected by ``count``, which it resets to 0),
// sums every block's partial in index order into *out: a reduction over
// the grid in one launch, with no atomics in the sum and its order fixed by
// the grid.  Every thread of the block calls it; sh as for `block_sum`.
// True in the thread that wrote *out (thread 0 of the last block).  Calls
// that share a counter run on one stream.
__device__ inline bool finish_sum(float s, float* partial,
                                  unsigned int* count, float* out,
                                  float* sh) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = s;
    __threadfence();   // the partial is visible before the count says so
    last = atomicAdd(count, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return false;
  // each thread adds partials t, t + B, t + 2B, ... in that order, with
  // eight loads in flight (a 258^3 grid leaves ~67k partials)
  const int n = (int)gridDim.x, B = (int)blockDim.x;
  float w = 0.f;
  for (int q0 = threadIdx.x; q0 < n; q0 += 8 * B) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = q0 + u * B < n ? __ldcg(&partial[q0 + u * B]) : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) w += v[u];
  }
  const float tot = block_sum(w, sh);
  if (threadIdx.x == 0) {
    *out = tot;
    *count = 0u;
  }
  return threadIdx.x == 0;
}

inline int blocks_for(long long n) {
  return (int)((n + WL_THREADS - 1) / WL_THREADS);
}

// The stored type of an operand, passed to a generic lambda as a value.
template <typename T>
struct type_tag {
  using type = T;
};
#define TAG_T(tag) typename decltype(tag)::type

// Calls f(ta, tb) with ta, tb the type_tag of float or __nv_bfloat16 as
// a_bf16 / b_bf16 say: the one dispatch of a kernel templated on two
// operand types (f32, or bf16 upcast in registers).
template <typename F>
inline void dispatch_bf16(int a_bf16, int b_bf16, F f) {
  using bf = __nv_bfloat16;
  if (a_bf16 && b_bf16)
    f(type_tag<bf>{}, type_tag<bf>{});
  else if (a_bf16)
    f(type_tag<bf>{}, type_tag<float>{});
  else if (b_bf16)
    f(type_tag<float>{}, type_tag<bf>{});
  else
    f(type_tag<float>{}, type_tag<float>{});
}
