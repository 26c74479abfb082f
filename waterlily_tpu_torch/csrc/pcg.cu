// A whole Jacobi-preconditioned CG smooth (`it` iterations) of one small
// multigrid level in a single launch, 2D or 3D, walls or periodic axes.
//
// Replaces waterlily_tpu/ops/pallas_kernels.py `pcg_pallas` (`_make_kernel`,
// with its in-kernel periodic fills `_per_fill`).
//
// Semantics (waterlily_tpu.ops.poisson.pcg, the reference's pcg! with its
// early exits as a monotone `dead` flag):
//   z = r*iD; eps = z; rho = <r, z>; dead = |rho| < 10 eps_f32
//   repeat: fill eps's ghosts along each periodic axis (plane 0 <- plane
//   S-2, plane S-1 <- plane 1, axis by axis); z = A eps (ghosts 0);
//   alpha = rho/<z, eps> (0 if dead or the denominator is 0);
//   dead |= |alpha| outside [1e-2, 1e2]; upd = dead ? 0 : alpha;
//   x += upd*eps (periodic ghosts of x move with eps's); r -= upd*z; then
//   (not after the last iteration) z2 = r*iD; rho2 = <r, z2>;
//   dead |= |rho2| < 10 eps_f32; beta = dead ? 0 : rho2/rho;
//   eps = interior ? beta*eps + z2 : 0; rho = dead ? rho : rho2.
// Only x and r leave the kernel.
//
// Bound on the H100: launch latency and synchronisation, not memory.  The
// coarse levels it serves hold at most ~60k cells (1.4 MB for L, D, iD, x,
// r, eps and z together), so every array stays in L2, while the plain form
// is some 30 small launches per smooth.  Design: the literal counterpart of
// the TPU's whole smooth on chip: one block of 1024 threads walks the level
// in strides, __syncthreads() separates the phases (the matvec reads eps
// written by other threads; each periodic axis's fill is read by the next
// axis's corners), and each dot is a deterministic block tree sum that every
// thread receives, so all threads take the same early-exit decisions.  The
// kernel is a template on the rank D: a 2D level is walked as 2D, so its
// interior mask is its own (a (S0, S1, 1) 3D view would have none).  eps and
// z are scratch arrays the wrapper allocates.
#include "common.cuh"

#define PCG_THREADS 1024

// A D-dimensional ghost-padded level, axis D-1 fastest.  32-bit indices:
// the wrapper admits levels of fewer than 2^31 cells (one block serves
// tens of thousands).
template <int D>
struct ShapeD {
  int S[D];
  int st[D];  // flat strides
  int N;      // cells
};

template <int D>
ShapeD<D> make_shape_d(const int* S) {
  ShapeD<D> g;
  g.N = 1;
  for (int d = D - 1; d >= 0; --d) {
    g.S[d] = S[d];
    g.st[d] = g.N;
    g.N *= S[d];
  }
  return g;
}

template <int D>
__device__ inline bool interior_cell(const ShapeD<D>& g, int c) {
  bool in = true;
  for (int d = D - 1; d >= 0; --d) {
    const int q = c % g.S[d];
    in = in && q >= 1 && q <= g.S[d] - 2;
    c /= g.S[d];
  }
  return in;
}

// A x at an interior cell, the association of `ax_cell` (common.cuh) in D
// dimensions: s = x*D, then per axis s = (s + x[-]*L) + x[+]*L[+].
template <int D>
__device__ inline float ax_cell_d(const float* L, const float* Dd,
                                  const float* x, const ShapeD<D>& g,
                                  int c) {
  float s = x[c] * Dd[c];
  for (int a = 0; a < D; ++a) {
    const float* La = L + a * g.N;
    const int st = g.st[a];
    s = s + x[c - st] * La[c];
    s = s + x[c + st] * La[c + st];
  }
  return s;
}

// Periodic ghost fill of `a` along every axis set in `periodic`, in axis
// order (the fills commute, so perdir's order does not matter); the whole
// block takes part and leaves it published.
template <int D>
__device__ inline void periodic_fill(float* a, const ShapeD<D>& g,
                                     int periodic) {
  for (int j = 0; j < D; ++j) {
    if (!(periodic & (1 << j))) continue;
    const int P = g.N / g.S[j];  // cells of one plane normal to j
    const int span = (g.S[j] - 2) * g.st[j];
    for (int p = threadIdx.x; p < 2 * P; p += blockDim.x) {
      const bool top = p >= P;
      int q = top ? p - P : p;
      int c = 0;  // the cell of plane 0 at this transverse position
      for (int d = D - 1; d >= 0; --d) {
        if (d == j) continue;
        c += (q % g.S[d]) * g.st[d];
        q /= g.S[d];
      }
      if (top) {
        a[c + span + g.st[j]] = a[c + g.st[j]];  // plane S-1 <- plane 1
      } else {
        a[c] = a[c + span];                      // plane 0 <- plane S-2
      }
    }
    __syncthreads();
  }
}

template <int D>
__global__ void __launch_bounds__(PCG_THREADS)
pcg_kernel(const float* __restrict__ L, const float* __restrict__ Dd,
           const float* __restrict__ iD, float* __restrict__ x,
           float* __restrict__ r, float* __restrict__ eps,
           float* __restrict__ z, ShapeD<D> g, int it, int periodic) {
  __shared__ float sh[PCG_THREADS];
  const float teneps = 10.f * FLT_EPSILON;
  const int n = g.N;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  float part = 0.f;
  for (int c = tid; c < n; c += nt) {
    const float zc = r[c] * iD[c];
    eps[c] = zc;
    part = part + r[c] * zc;
  }
  float rho = block_sum(part, sh);  // its barriers publish eps
  bool dead = fabsf(rho) < teneps;

  for (int i = 0; i < it; ++i) {
    periodic_fill<D>(eps, g, periodic);
    part = 0.f;
    for (int c = tid; c < n; c += nt) {
      const float v = interior_cell<D>(g, c) ? ax_cell_d<D>(L, Dd, eps, g, c)
                                             : 0.f;
      z[c] = v;
      part = part + v * eps[c];
    }
    const float denom = block_sum(part, sh);
    const float alpha = (dead || denom == 0.f) ? 0.f : rho / denom;
    dead = dead || fabsf(alpha) < 1e-2f || fabsf(alpha) > 1e2f;
    const float upd = dead ? 0.f : alpha;
    const bool last = (i == it - 1);
    part = 0.f;
    for (int c = tid; c < n; c += nt) {
      x[c] = x[c] + upd * eps[c];
      const float rc = r[c] - upd * z[c];
      r[c] = rc;
      if (!last) {
        const float z2 = rc * iD[c];
        z[c] = z2;   // each thread only rewrites its own cells
        part = part + rc * z2;
      }
    }
    if (last) break;
    const float rho2 = block_sum(part, sh);
    dead = dead || fabsf(rho2) < teneps;
    const float beta = dead ? 0.f : rho2 / (rho == 0.f ? 1.f : rho);
    for (int c = tid; c < n; c += nt) {
      eps[c] = interior_cell<D>(g, c) ? beta * eps[c] + z[c] : 0.f;
    }
    __syncthreads();  // the fill and the next matvec read other threads' eps
    rho = dead ? rho : rho2;
  }
}

// ndim 2 or 3; S2 is ignored for a 2D level.  `periodic`: bit d set for
// each periodic axis d.
extern "C" int wl_pcg(const float* L, const float* Dd, const float* iD,
                      float* x, float* r, float* eps, float* z, int ndim,
                      int S0, int S1, int S2, int it, int periodic,
                      void* stream) {
  const int S[3] = {S0, S1, S2};
  cudaStream_t s = (cudaStream_t)stream;
  if (ndim == 3) {
    pcg_kernel<3><<<1, PCG_THREADS, 0, s>>>(L, Dd, iD, x, r, eps, z,
                                            make_shape_d<3>(S), it, periodic);
  } else if (ndim == 2) {
    pcg_kernel<2><<<1, PCG_THREADS, 0, s>>>(L, Dd, iD, x, r, eps, z,
                                            make_shape_d<2>(S), it, periodic);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
