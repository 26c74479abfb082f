// Convection-diffusion tendency r of all three velocity components, QUICK or
// van Leer limited, with walls or periodic axes.
//
// Replaces waterlily_tpu/ops/pallas_stencil.py `conv_diff3d_pallas`
// (`_conv_all_kernel`, `_conv_comp_kernel`), whole grid, periodic variants
// included.
//
// Semantics (waterlily_tpu.ops.convect.conv_core): for sweep axis a the flux
// through the lower face of cell k is
//   F = (w > 0 ? w*pos : w*neg) - nu*(f - fm1)
// with f, fm1, fm2, fp1 the component's values at k, k-1, k-2, k+1 along a,
// w the advecting velocity (0.5*(u_a[k] + u_a[k-1]) when the component is a
// itself, 0.5*(u_a[k] + u_a[k - d_comp]) otherwise), pos/neg the limiter's
// upwind values.  On a wall axis the central value 0.5*(f + fm1) replaces
// them on the wall faces k=1 (incoming pos) and k=S-1 (incoming neg).  On a
// periodic axis (bit a of `periodic`) both are always limited, face 1's
// far-upwind tap fm2 is the interior plane S-3 (the wrap), and the top face
// S-1 carries a copy of face 1's flux.  The tendency is
// r = sum_a where(support_a, F[k] - F[k+1], 0), accumulated from 0 in axis
// order; support_a is 1..S-2 along a and >= 1 across it (so the top ghost
// plane of a transverse axis is written), and every other cell is exactly 0.
//
// Bound on the H100: in flops and registers more than memory.  Per value it
// reads 12 B of velocity (the 13 taps are neighbours, cached) and writes 4 B,
// but evaluates six limited fluxes (two faces per axis) of ~25 flops each.
// Design: one thread per (component, cell) evaluates both faces of each axis
// itself; the TPU kernel's face-flux roll (sharing a face between two cells)
// is an optimisation left for later.  A periodic top face is evaluated as
// face 1 at the same transverse position, so the copy costs no second pass.
// Every load is bounds-checked: a tap beyond the array reads 0, as the plain
// form's zero padding does, and such taps only ever feed a limiter branch
// the wall-face select discards.
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

// Flux through face idx[a] + s of component `comp`; `per`: axis a is
// periodic.
template <int LIM>
__device__ inline float face_flux(const float* u, const Shape3& g,
                                  const int idx[3], int comp, int a, int s,
                                  float nu, bool per) {
  const float* ui = u + comp * g.N;
  const float* ua = u + a * g.N;
  int p[3] = {idx[0], idx[1], idx[2]};
  p[a] += s;                    // the face's cell: taps at offsets 0,-1,-2,+1
  if (per && p[a] == g.S[a] - 1) p[a] = 1;   // top face: face 1's flux
  const int kf = p[a];
  const float f = tap(ui, g, p, a, 0);
  const float fm1 = tap(ui, g, p, a, -1);
  const float fm2 = (per && kf == 1) ? tap(ui, g, p, a, g.S[a] - 4)  // S-3
                                     : tap(ui, g, p, a, -2);
  const float fp1 = tap(ui, g, p, a, 1);
  float w;
  if (comp == a) {
    w = 0.5f * (tap(ua, g, p, a, 0) + tap(ua, g, p, a, -1));
  } else {
    int sh[3] = {p[0], p[1], p[2]};
    sh[comp] -= 1;   // >= 0: the support keeps idx[comp] >= 1
    w = 0.5f * (tap(ua, g, p, a, 0) + tap(ua, g, sh, a, 0));
  }
  float pos, neg;
  if (per) {
    pos = limiter<LIM>(fm2, fm1, f);
    neg = limiter<LIM>(fp1, f, fm1);
  } else {
    const float cd = 0.5f * (f + fm1);
    pos = (kf == 1) ? cd : limiter<LIM>(fm2, fm1, f);
    neg = (kf == g.S[a] - 1) ? cd : limiter<LIM>(fp1, f, fm1);
  }
  return ((w > 0.f) ? w * pos : w * neg) - nu * (f - fm1);
}

// PER: bit a set for each periodic axis a, a template argument so that
// each form compiles to its own straight-line code (the wall form as if the
// periodic branches did not exist).
template <int LIM, int PER>
__global__ void conv_kernel(const float* __restrict__ u, float* __restrict__ r,
                            float nu, Shape3 g) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 3 * g.N) return;
  const int comp = (int)(t / g.N);
  int idx[3];
  unflatten(g, t - comp * g.N, idx);
  float acc = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    bool m = true;
    for (int d = 0; d < 3; ++d) {
      m = m && (d == a ? (idx[d] >= 1 && idx[d] <= g.S[d] - 2) : idx[d] >= 1);
    }
    float term = 0.f;
    if (m) {
      const bool per = (PER >> a) & 1;
      term = face_flux<LIM>(u, g, idx, comp, a, 0, nu, per) -
             face_flux<LIM>(u, g, idx, comp, a, 1, nu, per);
    }
    acc = acc + term;
  }
  r[t] = acc;
}

#define WL_CONV_FORM(P)                                        \
  case P:                                                      \
    conv_kernel<LIM, P><<<blocks, WL_THREADS, 0, s>>>(u, r, nu, g); \
    break;

template <int LIM>
int launch_conv(const float* u, float* r, float nu, int periodic,
                const Shape3& g, cudaStream_t s) {
  const int blocks = blocks_for(3 * g.N);
  switch (periodic) {
    WL_CONV_FORM(0) WL_CONV_FORM(1) WL_CONV_FORM(2) WL_CONV_FORM(3)
    WL_CONV_FORM(4) WL_CONV_FORM(5) WL_CONV_FORM(6) WL_CONV_FORM(7)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int wl_conv_diff3d(const float* u, float* r, float nu, int lim,
                              int periodic, int S0, int S1, int S2,
                              void* stream) {
  const Shape3 g = make_shape(S0, S1, S2);
  cudaStream_t s = (cudaStream_t)stream;
  if (lim == 0) return launch_conv<0>(u, r, nu, periodic, g, s);
  if (lim == 1) return launch_conv<1>(u, r, nu, periodic, g, s);
  return (int)cudaErrorInvalidValue;
}
