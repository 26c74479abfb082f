// Convection-diffusion tendency r of all three velocity components, QUICK or
// van Leer limited, non-periodic walls.
//
// Replaces waterlily_tpu/ops/pallas_stencil.py `conv_diff3d_pallas`
// (`_conv_all_kernel`, `_conv_comp_kernel`), non-periodic whole-grid variant.
//
// Semantics (waterlily_tpu.ops.convect.conv_core): for sweep axis a the flux
// through the lower face of cell k is
//   F = (w > 0 ? w*pos : w*neg) - nu*(f - fm1)
// with f, fm1, fm2, fp1 the component's values at k, k-1, k-2, k+1 along a,
// w the advecting velocity (0.5*(u_a[k] + u_a[k-1]) when the component is a
// itself, 0.5*(u_a[k] + u_a[k - d_comp]) otherwise), pos/neg the limiter's
// upwind values, and the central value 0.5*(f + fm1) on the wall faces k=1
// (incoming pos) and k=S-1 (incoming neg).  The tendency is
// r = sum_a where(support_a, F[k] - F[k+1], 0), accumulated from 0 in axis
// order; support_a is 1..S-2 along a and >= 1 across it (so the top ghost
// plane of a transverse axis is written), and every other cell is exactly 0.
//
// Bound on the H100: in flops and registers more than memory.  Per value it
// reads 12 B of velocity (the 13 taps are neighbours, cached) and writes 4 B,
// but evaluates six limited fluxes (two faces per axis) of ~25 flops each.
// Design: one thread per (component, cell) evaluates both faces of each axis
// itself; the TPU kernel's face-flux roll (sharing a face between two cells)
// is an optimisation left for later.  Every load is bounds-checked: a tap
// beyond the array reads 0, as the plain form's zero padding does, and such
// taps only ever feed a limiter branch the wall-face select discards.
#include "common.cuh"

__device__ inline float median3(float a, float b, float c) {
  return tmax(tmin(a, b), tmin(tmax(a, b), c));
}

template <int LIM>
__device__ inline float limiter(float u, float c, float d) {
  if (LIM == 0) {  // QUICK with median limiter
    return median3((5.f * c + 2.f * d - u) / 6.f, c,
                   median3(10.f * c - 9.f * u, c, d));
  }
  // van Leer, division-guarded
  const float denom = (d == u) ? 1.f : d - u;
  const float lim = c + (d - c) * (c - u) / denom;
  const bool keep = (c <= tmin(u, d)) || (c >= tmax(u, d));
  return keep ? c : lim;
}

// Bounds-checked tap of field f (one component) at idx + o*e_a.
__device__ inline float tap(const float* f, const Shape3& g, const int idx[3],
                            int a, int o) {
  const int q = idx[a] + o;
  if (q < 0 || q >= g.S[a]) return 0.f;
  return f[idx[0] * g.st[0] + idx[1] * g.st[1] + idx[2] + o * g.st[a]];
}

// Flux through face idx[a] + s of component `comp`.
template <int LIM>
__device__ inline float face_flux(const float* u, const Shape3& g,
                                  const int idx[3], int comp, int a, int s,
                                  float nu) {
  const float* ui = u + comp * g.N;
  const float* ua = u + a * g.N;
  const float f = tap(ui, g, idx, a, s);
  const float fm1 = tap(ui, g, idx, a, s - 1);
  const float fm2 = tap(ui, g, idx, a, s - 2);
  const float fp1 = tap(ui, g, idx, a, s + 1);
  float w;
  if (comp == a) {
    w = 0.5f * (tap(ua, g, idx, a, s) + tap(ua, g, idx, a, s - 1));
  } else {
    int sh[3] = {idx[0], idx[1], idx[2]};
    sh[comp] -= 1;   // >= 0: the support keeps idx[comp] >= 1
    w = 0.5f * (tap(ua, g, idx, a, s) + tap(ua, g, sh, a, s));
  }
  const int kf = idx[a] + s;
  const float cd = 0.5f * (f + fm1);
  const float pos = (kf == 1) ? cd : limiter<LIM>(fm2, fm1, f);
  const float neg = (kf == g.S[a] - 1) ? cd : limiter<LIM>(fp1, f, fm1);
  return ((w > 0.f) ? w * pos : w * neg) - nu * (f - fm1);
}

template <int LIM>
__global__ void conv_kernel(const float* __restrict__ u, float* __restrict__ r,
                            float nu, Shape3 g) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 3 * g.N) return;
  const int comp = (int)(t / g.N);
  int idx[3];
  unflatten(g, t - comp * g.N, idx);
  float acc = 0.f;
  for (int a = 0; a < 3; ++a) {
    bool m = true;
    for (int d = 0; d < 3; ++d) {
      m = m && (d == a ? (idx[d] >= 1 && idx[d] <= g.S[d] - 2) : idx[d] >= 1);
    }
    float term = 0.f;
    if (m) {
      term = face_flux<LIM>(u, g, idx, comp, a, 0, nu) -
             face_flux<LIM>(u, g, idx, comp, a, 1, nu);
    }
    acc = acc + term;
  }
  r[t] = acc;
}

extern "C" int wl_conv_diff3d(const float* u, float* r, float nu, int lim,
                              int S0, int S1, int S2, void* stream) {
  const Shape3 g = make_shape(S0, S1, S2);
  const int blocks = blocks_for(3 * g.N);
  if (lim == 0) {
    conv_kernel<0><<<blocks, WL_THREADS, 0, (cudaStream_t)stream>>>(u, r, nu, g);
  } else if (lim == 1) {
    conv_kernel<1><<<blocks, WL_THREADS, 0, (cudaStream_t)stream>>>(u, r, nu, g);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
