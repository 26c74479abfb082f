// Projection head and tail: (div u, p*dt) and (u - L grad x, x/dt).
//
// Replaces waterlily_tpu/ops/pallas_stencil.py `div3d_pallas` (`_div_kernel`)
// and `project3d_pallas` (`_project_kernel`), f32, on the whole grid and in
// their shard-local (base) forms.
//
// Base form: the array is a halo-extended block of a grid of global sizes
// G whose cell 0 sits at global index B (per axis); a cell takes the
// interior branch where it is interior both in the array (every tap in
// bounds) and in the global grid (1 <= idx + B <= G - 2).  The caller trims
// the halo ring.  The whole grid is the case B = 0, G = S.
//
// Bound on the H100: memory.  div reads u (12 B) and p (4 B) and writes z and
// x (8 B): 24 B/cell; project reads L, u (24 B) and x (4 B) and writes u and
// p (16 B): 44 B/cell.  The plain forms spend a pass per shifted operand and
// per chained op.  Design: one thread per cell emits both outputs of its
// sweep; the +-d_i taps are neighbours' values already in L1/L2.  dt arrives
// as a device pointer (it is the CFL feedback value: reading it on the host
// would synchronise every call).  Ghost cells take the pass-through branch
// and read no neighbour.  Associations follow waterlily_tpu.flow.div
// ((t0 + t1) + t2) and the projection's u - L*(x - x[-d]).
// Members (an ensemble under torch.func.vmap, the member forms of `div3d`
// and `project3d`, whole grid): blockIdx.y is the member; the outputs hold
// the members' fields one after another, each input (dt too) sits at its
// own member stride, 0 for one every member shares.
#include "common.cuh"

// The global grid of a shard-local call (B = 0, G = S: the whole grid).
struct Glob {
  int B[3];
  int G[3];
};

__device__ inline bool global_interior(const Glob& q, const int idx[3]) {
  bool in = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int gq = idx[a] + q.B[a];
    in = in && gq >= 1 && gq <= q.G[a] - 2;
  }
  return in;
}

__global__ void div_kernel(const float* __restrict__ u,
                           const float* __restrict__ p,
                           const float* __restrict__ dt, float* __restrict__ z,
                           float* __restrict__ x, Shape3 g, Glob q,
                           long long su, long long sp, long long sdt) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.N) return;
  const long long m = blockIdx.y;
  u += m * su;
  p += m * sp;
  dt += m * sdt;
  z += m * g.N;
  x += m * g.N;
  int idx[3];
  unflatten(g, c, idx);
  float v = 0.f;
  if (is_interior(g, idx) && global_interior(q, idx)) {
    for (int a = 0; a < 3; ++a) {
      const float* ua = u + a * g.N;
      const float t = ua[c + g.st[a]] - ua[c];
      v = (a == 0) ? t : v + t;
    }
  }
  z[c] = v;
  x[c] = p[c] * dt[0];
}

__global__ void project_kernel(const float* __restrict__ L,
                               const float* __restrict__ x,
                               const float* __restrict__ u,
                               const float* __restrict__ dt,
                               float* __restrict__ u_out,
                               float* __restrict__ p, Shape3 g, Glob q,
                               long long sL, long long sx, long long su,
                               long long sdt) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.N) return;
  const long long m = blockIdx.y;
  L += m * sL;
  x += m * sx;
  u += m * su;
  dt += m * sdt;
  u_out += m * 3 * g.N;
  p += m * g.N;
  int idx[3];
  unflatten(g, c, idx);
  const float xc = x[c];
  const bool in = is_interior(g, idx) && global_interior(q, idx);
  for (int a = 0; a < 3; ++a) {
    const long long o = a * g.N + c;
    u_out[o] = in ? u[o] - L[o] * (xc - x[c - g.st[a]]) : u[o];
  }
  p[c] = xc / dt[0];
}

// members: the outputs hold that many fields one after another (one
// field: 1); member m reads each input at m times its stride (elements; 0:
// shared).  G0..G2: the global sizes, B0..B2: the global index of cell 0
// (the whole grid: G = S, B = 0).
extern "C" int wl_div3d(const float* u, const float* p, const float* dt,
                        float* z, float* x, int members, long long su,
                        long long sp, long long sdt, int S0, int S1, int S2,
                        int G0, int G1, int G2, int B0, int B1, int B2,
                        void* stream) {
  const Shape3 g = make_shape(S0, S1, S2);
  const Glob q = {{B0, B1, B2}, {G0, G1, G2}};
  if (members < 1 || members > 65535) return (int)cudaErrorInvalidValue;
  div_kernel<<<dim3(blocks_for(g.N), members), WL_THREADS, 0,
               (cudaStream_t)stream>>>(u, p, dt, z, x, g, q, su, sp, sdt);
  return (int)cudaGetLastError();
}

extern "C" int wl_project3d(const float* L, const float* x, const float* u,
                            const float* dt, float* u_out, float* p,
                            int members, long long sL, long long sx,
                            long long su, long long sdt, int S0, int S1,
                            int S2, int G0, int G1, int G2, int B0, int B1,
                            int B2, void* stream) {
  const Shape3 g = make_shape(S0, S1, S2);
  const Glob q = {{B0, B1, B2}, {G0, G1, G2}};
  if (members < 1 || members > 65535) return (int)cudaErrorInvalidValue;
  project_kernel<<<dim3(blocks_for(g.N), members), WL_THREADS, 0,
                   (cudaStream_t)stream>>>(L, x, u, dt, u_out, p, g, q, sL,
                                           sx, su, sdt);
  return (int)cudaGetLastError();
}
