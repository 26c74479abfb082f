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
// An ensemble (`torch.func.vmap` over the solver) smooths M members of one
// shape in one launch: blockIdx.y is the member (within the launch's chunk
// of members), each member's x, r and scratch follow the previous one's,
// and its L, D and iD start a member stride further on (0: one operator
// shared by every member).  A member's sums and early exits are its own
// (its partials, its `dead` flag); every block runs the same `it`
// iterations and barriers whatever its member's exits, so the grid barrier
// of a chunk of members never waits on a block that left.
//
// Bound on the H100: launch latency and the chain of level-wide sums the
// algorithm needs (two a iteration), not memory: the coarse levels it
// serves hold at most ~60k cells (1.4 MB for L, D, iD, x and r), all in
// L2.  Design:
// * The smooth is spread over a grid of blocks of 256 threads (GRID, a
//   cooperative launch sized by the level, `ops.pcg_kernel.pcg_grid`); a
//   level too small to repay grid barriers runs on one block of 1024
//   threads (!GRID) with __syncthreads().
// * Each thread owns K cells for the whole smooth (flat index
//   (block * K + k) * T + thread, coalesced for each k).  Their
//   neighbour offsets and interior and periodic flags are computed once, so
//   the iterations do no division; their L taps, D, iD, x, r and eps stay
//   in registers.  x and r are written back once, at the end.
// * Only the search direction goes through memory (on a grid read with
//   __ldcg from L2, since other SMs write it; on one block through L1):
//   before the rho2 barrier every interior
//   cell publishes eps (E) and z2 (Z2); after it, a reader forms the new
//   direction of a neighbour itself as beta*E + Z2 (0 at a wall ghost),
//   the owner's expression on the owner's operands, so every reader has the
//   owner's bits (--fmad=false).  Two barriers an iteration, one a sum.
// * A sum is a per-block partial (a deterministic warp-shuffle and warp
//   tree) written to P, a grid barrier, then every block adding all
//   partials in index order: all blocks hold the same bits and take the
//   same early-exit decisions.  P alternates between two halves, so a
//   block never overwrites a partial another block may still read.
// * The periodic fill is an index map on the read: a neighbour across a
//   periodic ghost plane is read at its source plane (an interior cell's
//   neighbour has one ghost index at most), and a ghost cell's owner takes
//   its eps through the composed map of all its periodic indices (the
//   fills commute: each rewrites one index), so x's ghosts move as the
//   plain form moves them.
// The kernel is a template on the rank D (2D levels keep their own interior
// mask), on K, on the block size T and on GRID.  Member offsets are 64-bit;
// a member's own cells are indexed in 32 bits.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// threads a block: the grid form's, the one-block form's
#define PCG_THREADS 256
#define PCG_ONE_BLOCK_THREADS 1024

// A D-dimensional ghost-padded level, axis D-1 fastest.  32-bit indices:
// the wrapper admits levels of fewer than 2^31 cells.
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

// per-cell flags: the cell exists, is interior, its periodic source is
// interior; per axis a, its low / high neighbour lies across a periodic
// ghost plane (read at the source plane) or is a wall ghost
enum : unsigned {
  kValid = 1u,
  kInterior = 2u,
  kSrcInterior = 4u,
};
__device__ inline unsigned lo_wrap(int a) { return 1u << (4 + 4 * a); }
__device__ inline unsigned hi_wrap(int a) { return 1u << (5 + 4 * a); }
__device__ inline unsigned lo_wall(int a) { return 1u << (6 + 4 * a); }
__device__ inline unsigned hi_wall(int a) { return 1u << (7 + 4 * a); }

// Sum over a block of T threads, in a fixed order (shuffle tree in each
// warp, then warp 0..T/32-1 in turn); every thread receives it.  sh holds
// T/32 + 2 floats.
template <int T>
__device__ inline float block_total(float v, float* sh) {
  constexpr int W = T / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(~0u, v, o);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < W; ++w) s = s + sh[w];
    sh[W] = s;
  }
  __syncthreads();
  return sh[W];
}

// The level-wide sum of every thread's `part`.  GRID: each block's partial
// to P, a grid barrier (which also publishes every write made before it),
// then the partials added in index order by every block.  One block: the
// block sum (its barriers publish the block's writes).
template <int T, bool GRID>
__device__ inline float level_total(float part, float* P, float* sh) {
  const float b = block_total<T>(part, sh);
  if constexpr (!GRID) {
    return b;
  } else {
    if (threadIdx.x == 0) P[blockIdx.x] = b;
    cg::this_grid().sync();
    if (threadIdx.x < 32) {
      float s = 0.f;
      for (int q = threadIdx.x; q < gridDim.x; q += 32) s = s + __ldcg(P + q);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s = s + __shfl_down_sync(~0u, s, o);
      if (threadIdx.x == 0) sh[T / 32 + 1] = s;
    }
    __syncthreads();
    return sh[T / 32 + 1];
  }
}

// A value of the direction arrays that another thread wrote before the last
// barrier: on a grid from L2 (another SM's L1 may hold an older copy), on
// one block through the SM's own L1.
template <bool GRID>
__device__ inline float shared_ld(const float* p) {
  if constexpr (GRID) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

template <int D, int K, int T, bool GRID>
__global__ void __launch_bounds__(T)
pcg_kernel(const float* __restrict__ L, const float* __restrict__ Dd,
           const float* __restrict__ iD, float* __restrict__ x,
           float* __restrict__ r, float* E, float* Z2, float* P,
           ShapeD<D> g, int it, int periodic, long long sL, long long sD) {
  __shared__ float sh[T / 32 + 2];
  const float teneps = 10.f * FLT_EPSILON;
  // this block's member: its operator, fields, direction arrays, partials
  const long long m = blockIdx.y;
  L += m * sL;
  Dd += m * sD;
  iD += m * sD;
  x += m * g.N;
  r += m * g.N;
  E += m * 2 * (long long)g.N;
  Z2 += m * 2 * (long long)g.N;
  P += m * 2 * (long long)gridDim.x;
  // the two halves of P: the rho sums and the denominators
  float* Prho = P;
  float* Pden = P + gridDim.x;
  int wrap[D];  // (S-3) * stride: a neighbour read across a periodic plane
#pragma unroll
  for (int a = 0; a < D; ++a) wrap[a] = (g.S[a] - 3) * g.st[a];

  int cell[K], src[K];
  unsigned fl[K];
  float xk[K], rk[K], ek[K], dk[K], idk[K], llo[K][D], lhi[K][D];
  float part = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (blockIdx.x * K + k) * T + threadIdx.x;
    cell[k] = c;
    src[k] = c;
    fl[k] = 0u;
    xk[k] = rk[k] = ek[k] = dk[k] = idk[k] = 0.f;
#pragma unroll
    for (int a = 0; a < D; ++a) llo[k][a] = lhi[k][a] = 0.f;
    if (c >= g.N) continue;
    // coordinates, flags and the periodic source, once
    unsigned f = kValid;
    bool in = true, src_in = true;
    int s = c;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      const int q = (c / g.st[a]) % g.S[a];
      const int hi = g.S[a] - 1;
      const bool per = (periodic >> a) & 1;
      in = in && q >= 1 && q <= hi - 1;
      int qs = q;
      if (per && q == 0) qs = hi - 1;
      if (per && q == hi) qs = 1;
      s += (qs - q) * g.st[a];
      src_in = src_in && qs >= 1 && qs <= hi - 1;
      if (q == 1) f |= per ? lo_wrap(a) : lo_wall(a);
      if (q == hi - 1) f |= per ? hi_wrap(a) : hi_wall(a);
    }
    if (in) f |= kInterior;
    if (src_in) f |= kSrcInterior;
    fl[k] = f;
    src[k] = s;
    xk[k] = x[c];
    rk[k] = r[c];
    idk[k] = iD[c];
    if (in) {
      dk[k] = Dd[c];
#pragma unroll
      for (int a = 0; a < D; ++a) {
        llo[k][a] = L[a * g.N + c];
        lhi[k][a] = L[a * g.N + c + g.st[a]];
      }
    }
    const float z = rk[k] * idk[k];
    ek[k] = z;
    E[c] = z;  // every cell: iteration 0 reads wall ghosts' r*iD too
    part = part + rk[k] * z;
  }
  float rho = level_total<T, GRID>(part, Prho, sh);
  bool dead = fabsf(rho) < teneps;
  float beta = 0.f;

  // the direction at position p (after the periodic map) in iteration i:
  // eps0 as published, then beta*E + Z2 (0 at a wall ghost)
  auto dir = [&](int i, int p, bool wall) {
    if (i == 0) return shared_ld<GRID>(E + p);
    return wall ? 0.f
                : beta * shared_ld<GRID>(E + p) + shared_ld<GRID>(Z2 + p);
  };

  for (int i = 0; i < it; ++i) {
    float zk[K];
    part = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      zk[k] = 0.f;
      const unsigned f = fl[k];
      if (!(f & kValid)) continue;
      const int c = cell[k];
      if (!(f & kInterior)) {
        // a ghost cell: eps at its periodic source (x's ghosts move with it)
        ek[k] = dir(i, src[k], !(f & kSrcInterior));
      } else {
        float s = ek[k] * dk[k];
#pragma unroll
        for (int a = 0; a < D; ++a) {
          const int lo = c + ((f & lo_wrap(a)) ? wrap[a] : -g.st[a]);
          const int hi = c + ((f & hi_wrap(a)) ? -wrap[a] : g.st[a]);
          s = s + dir(i, lo, f & lo_wall(a)) * llo[k][a];
          s = s + dir(i, hi, f & hi_wall(a)) * lhi[k][a];
        }
        zk[k] = s;
      }
      part = part + zk[k] * ek[k];
    }
    const float denom = level_total<T, GRID>(part, Pden, sh);
    const float alpha = (dead || denom == 0.f) ? 0.f : rho / denom;
    dead = dead || fabsf(alpha) < 1e-2f || fabsf(alpha) > 1e2f;
    const float upd = dead ? 0.f : alpha;
    const bool last = (i == it - 1);
    part = 0.f;
    float z2k[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      z2k[k] = 0.f;
      if (!(fl[k] & kValid)) continue;
      xk[k] = xk[k] + upd * ek[k];
      rk[k] = rk[k] - upd * zk[k];
      if (last) {
        x[cell[k]] = xk[k];
        r[cell[k]] = rk[k];
        continue;
      }
      z2k[k] = rk[k] * idk[k];
      part = part + rk[k] * z2k[k];
      if (fl[k] & kInterior) {  // every reader of this iteration has read
        E[cell[k]] = ek[k];
        Z2[cell[k]] = z2k[k];
      }
    }
    if (last) break;
    const float rho2 = level_total<T, GRID>(part, Prho, sh);
    dead = dead || fabsf(rho2) < teneps;
    beta = dead ? 0.f : rho2 / (rho == 0.f ? 1.f : rho);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (fl[k] & kInterior) ek[k] = beta * ek[k] + z2k[k];
    }
    rho = dead ? rho : rho2;
  }
}

// Blocks of one instance that fit on the card at once (the cooperative
// launch's limit; the wrapper queries it once and sizes the grid by it).
template <int D, int K>
int pcg_coresident() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pcg_kernel<D, K, PCG_THREADS, true>, PCG_THREADS, 0);
  return sms * per_sm;
}

// The status of a cooperative launch that returned `e`.  A refused launch
// also leaves its error as the thread's last one, which the next launch's
// cudaGetLastError would report as its own: read it off here.
static int coop_status(cudaError_t e) {
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? (int)e : (int)last;
}

// A pass of the (D, K) instance over `members` members: one launch, a
// grid of (blocks, members) blocks, cooperative where blocks > 1 (the
// launch refuses, cudaErrorCooperativeLaunchTooLarge, a grid that would
// not be co-resident on this card).
template <int D, int K>
int pcg_launch(const float* L, const float* Dd, const float* iD, float* x,
               float* r, float* E, float* Z2, float* P, const int* S, int it,
               int periodic, int blocks, int members, long long sL,
               long long sD, cudaStream_t s) {
  ShapeD<D> g = make_shape_d<D>(S);
  if (members < 1 || members > 65535) return (int)cudaErrorInvalidValue;
  if (blocks == 1) {
    if constexpr (K <= 2) {
      if (K * PCG_ONE_BLOCK_THREADS < g.N) return (int)cudaErrorInvalidValue;
      pcg_kernel<D, K, PCG_ONE_BLOCK_THREADS, false>
          <<<dim3(1, members), PCG_ONE_BLOCK_THREADS, 0, s>>>(
              L, Dd, iD, x, r, E, Z2, P, g, it, periodic, sL, sD);
      return (int)cudaGetLastError();
    }
    return (int)cudaErrorInvalidValue;  // one block: 1 or 2 cells a thread
  }
  if ((long long)blocks * K * PCG_THREADS < g.N)
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&L,  (void*)&Dd, (void*)&iD,       (void*)&x,
                  (void*)&r,  (void*)&E,  (void*)&Z2,       (void*)&P,
                  (void*)&g,  (void*)&it, (void*)&periodic, (void*)&sL,
                  (void*)&sD};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)pcg_kernel<D, K, PCG_THREADS, true>, dim3(blocks, members),
      dim3(PCG_THREADS), args, 0, s);
  return coop_status(e);
}

// The instance for k cells a thread.
template <int D>
int pcg_launch_k(int k, const float* L, const float* Dd, const float* iD,
                 float* x, float* r, float* E, float* Z2, float* P,
                 const int* S, int it, int periodic, int blocks, int members,
                 long long sL, long long sD, cudaStream_t s) {
  switch (k) {
    case 1: return pcg_launch<D, 1>(L, Dd, iD, x, r, E, Z2, P, S, it,
                                    periodic, blocks, members, sL, sD, s);
    case 2: return pcg_launch<D, 2>(L, Dd, iD, x, r, E, Z2, P, S, it,
                                    periodic, blocks, members, sL, sD, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int pcg_coresident_k(int k) {
  switch (k) {
    case 1: return pcg_coresident<D, 1>();
    case 2: return pcg_coresident<D, 2>();
    default: return 0;
  }
}

// ndim 2 or 3; S2 is ignored for a 2D level.  `periodic`: bit d set for
// each periodic axis d.  `blocks` == 1: the one-block form, 1024 threads
// of `k` cells a member; more: the cooperative grid form, `blocks` blocks
// of PCG_THREADS threads of `k` cells a member (k 1 or 2: two cells a
// thread put a 60k-cell level on 118 blocks, which fit on the card at any
// occupancy).  `members` members of N cells each (N the level's cells):
// x and r hold members * N floats, member after member; member m's L
// starts at L + m * sL, its D and iD at + m * sD (sL = sD = 0: one
// operator for all).  work: scratch of 2 N members + 2 blocks members
// floats: each member's E and Z2, then each member's partials P (one
// allocation a call).
extern "C" int wl_pcg(const float* L, const float* Dd, const float* iD,
                      float* x, float* r, float* work, int ndim, int S0,
                      int S1, int S2, int it, int periodic, int blocks, int k,
                      int members, long long sL, long long sD,
                      void* stream) {
  const int S[3] = {S0, S1, S2};
  const long long N = (long long)S0 * S1 * (ndim == 3 ? S2 : 1);
  float* E = work;
  float* Z2 = work + N;
  float* P = work + 2 * N * members;
  cudaStream_t s = (cudaStream_t)stream;
  if (ndim == 3)
    return pcg_launch_k<3>(k, L, Dd, iD, x, r, E, Z2, P, S, it, periodic,
                           blocks, members, sL, sD, s);
  if (ndim == 2)
    return pcg_launch_k<2>(k, L, Dd, iD, x, r, E, Z2, P, S, it, periodic,
                           blocks, members, sL, sD, s);
  return (int)cudaErrorInvalidValue;
}

// The grid form's co-resident block count for rank ndim and k cells a
// thread (0 for a form the kernel does not have).
extern "C" int wl_pcg_coresident(int ndim, int k) {
  if (ndim == 3) return pcg_coresident_k<3>(k);
  if (ndim == 2) return pcg_coresident_k<2>(k);
  return 0;
}

// threads a block of the grid form (one_block 0) or the one-block form
extern "C" int wl_pcg_threads(int one_block) {
  return one_block ? PCG_ONE_BLOCK_THREADS : PCG_THREADS;
}

// A trivial cooperative kernel: `n` grid barriers and nothing else, on
// `blocks` blocks of PCG_THREADS threads.  Timed by kernels/times.py
// (`barrier:`) for the cost of one grid barrier on the card, the unit of
// pcg_fused's sync floor; on no solver path.
__global__ void __launch_bounds__(PCG_THREADS) grid_sync_probe(int n) {
  for (int i = 0; i < n; ++i) cg::this_grid().sync();
}

extern "C" int wl_grid_sync_probe(int blocks, int n, void* stream) {
  void* args[] = {(void*)&n};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)grid_sync_probe, dim3(blocks), dim3(PCG_THREADS), args, 0,
      (cudaStream_t)stream);
  return coop_status(e);
}
