// Convection-diffusion tendency r of all three velocity components, with
// any elementwise flux limiter (QUICK, van Leer or a user's own), with walls
// or periodic axes.
//
// Replaces waterlily_tpu/ops/pallas_stencil.py `conv_diff3d_pallas`
// (`_conv_all_kernel`, `_conv_comp_kernel`), whole grid, periodic variants
// included, and its shard-local (base and modular) forms.
//
// Semantics (waterlily_tpu.ops.convect.conv_core): for sweep axis a the flux
// of component c through the lower face of cell k is
//   F = (w > 0 ? w*pos : w*neg) - nu*(f - fm1)
// with f, fm1, fm2, fp1 the component's values at k, k-1, k-2, k+1 along a,
// w = 0.5*(u_a[k] + u_a[k - e_c]) the advecting velocity (e_c the unit step
// along axis c, so along a itself when c == a), pos/neg the limiter's upwind
// values.  On a wall axis the central value 0.5*(f + fm1) replaces them on
// the wall faces k=1 (incoming pos) and k=S-1 (incoming neg).  On a periodic
// axis (bit a of PER) both are always limited, face 1's far-upwind tap fm2
// is the interior plane S-3 (the wrap), and the top face S-1 carries a copy
// of face 1's flux.  The tendency is r = sum_a where(support_a, F[k] -
// F[k+1], 0), accumulated from 0 in axis order; support_a is 1..S-2 along a
// and >= 1 across it (so the top ghost plane of a transverse axis is
// written), and every other cell is exactly 0.  A tap beyond the array reads
// 0, as the plain form's zero padding does; such taps only feed a limiter
// branch that the wall-face select or the support mask discards.
//
// Bound on the H100: instructions, not bytes.  Per cell it reads 12 B of
// velocity and writes 12 B (0.1230 ms at 258^3 at the memory rate), but a
// face flux is a limiter (for QUICK a true division by 6 and two
// NaN-propagating medians) and a few selects, some 35 instructions.  The
// first kernel (one thread per output, both faces of every axis and both
// limiters of every face evaluated by the thread, 64-bit bounds-checked taps
// and index divisions) ran 36 limiters per cell and took 2.8698 ms at 258^3
// (3.4721 periodic), 0.043 of its bound.
//
// Design: each face flux is evaluated once (9 per cell: the TPU kernel's
// face-flux roll) with one limiter (`flux`), 32-bit indices and no
// per-thread division.  A block owns a CV_TJ x CV_TK tile of (axis 1, axis 2)
// columns, all three components, and marches a chunk of `rows` planes along
// axis 0 (chosen per shape so that the grid gives the card about two waves
// of blocks).
// - Axis 0: each thread carries its column's taps at planes i-1..i+2 of the
//   three components in registers, and the flux through face i+1, computed
//   at plane i, is face i's flux at plane i+1.
// - Axes 1 and 2: the three components' plane i sits in shared memory with
//   a halo of two cells (the interior from the threads' registers, the halo
//   read from memory); each thread evaluates the lower faces of its cell
//   and the first four warps one flux each of the tile's top faces, into
//   shared flux tiles; after a barrier each cell takes the differences.  A
//   second plane buffer holds plane i+1, whose axis-0 velocity the axis-0
//   faces of the other components advect with.
// - At most 64 registers a thread (four resident blocks an SM, no spills).
// - Periodic axes stay a template argument (a runtime flag cost 40%).  The
//   faces 1 and S-1 of a periodic axis take face 1's flux with its wrapped
//   tap, read from memory by the few threads that own them.
// Measured at 258^3 on an H100 80GB HBM3 (700 W): 0.65 ms walls, 0.78
// periodic on all axes, 0.57 van Leer (kernels/times.py),
// still some five times its memory bound: the limiters' instructions, their
// dependent chains and the two barriers a plane set its time.
// Base form: the array is a shard's block, halo-extended by two cells, of
// a grid of global sizes G whose cell 0 sits at global index B (per axis);
// the wall-face variants and the write support test global positions
// (kf + B against G), and the caller trims the halo.  The whole grid is
// the case B = 0, G = S, compiled apart (FORM 0: a whole-grid instance
// with the base's integer adds took 64 registers for 61 and ran 2.4%
// slower at 258^3).  Modular form (FORM 2, a base form): the halo planes
// of the periodic axes hold the modular wrap values (global plane -m is
// interior plane G-2-m, G-1+m is 1+m), so a periodic face takes the
// uniform periodic flux with no wrap read and no copy of face 1's flux: the
// face-1 far-upwind tap at -1 is plane G-3, and the top face's flux from
// {G-3, G-2, G-1 = 1, G = 2} is face 1's, bit for bit.
// Exactness against the plain form: the flux keeps its expression order,
// the QUICK division stays a true division, min/max propagate NaN, and the
// build has no multiply-add contraction (--fmad=false).
//
// Members (an ensemble under torch.func.vmap, `conv_diff3d`'s member
// form): the grid's z axis runs over each member's chunks in turn
// (blockIdx.z = member * chunks + chunk), each member with a one-member
// launch's chunks; u and r hold the members' fields one after another (u
// at member stride su, 0 for one field every member shares), and nu is a
// number every member shares or, from a device array, one a member (nu_dev
// at stride snu).  Every member's r is its own launch's, bit for bit.  It
// is an instance of its own (MB, whole grid only): the one-field instance
// reads nu from the launch and its pointers as passed (offsetting them and
// reading nu from memory in the one-field kernel spilled 3 of its
// instances and cost it 6% at 258^3 on an H100 80GB HBM3, 700 W).
//
// The kernel template, shared by the built-in limiters' entry point
// (conv_diff.cu) and the generated source of each user-defined limiter
// (waterlily_tpu_torch/kernels/limiter.py).
#pragma once

#include "common.cuh"

#define CV_TJ 8    // tile rows along axis 1 (threadIdx.y)
#define CV_TK 32   // tile columns along axis 2 (threadIdx.x)
#define CV_HJ (CV_TJ + 4)   // the tile with a two-cell halo
#define CV_HK (CV_TK + 4)
#define CV_THREADS (CV_TJ * CV_TK)
#define CV_HALO (CV_HJ * CV_HK - CV_THREADS)   // halo cells of one plane
// chunk lengths along axis 0 and the blocks a grid should give the card
// (about two waves of 132 SMs at four resident blocks each)
#define CV_ROWS_MIN 4
#define CV_ROWS_MAX 64
#define CV_BLOCKS 1024
// resident blocks an SM must fit (at most 64 registers a thread, no
// spills): unbounded, the periodic forms took 95-105 registers (two blocks
// an SM), the wall forms 64-72 (three); four ran 12-15% faster than three
#define CV_MIN_BLOCKS 4

struct Grid {
  int S0, S1, S2;
  int P;   // plane stride S1*S2
  int N;   // cells of one component (3*N < 2^31)
  int B0, B1, B2;   // global index of cell 0 (0 on the whole grid)
  int G0, G1, G2;   // global sizes (S on the whole grid)
};

__device__ inline float median3(float a, float b, float c) {
  return tmax(tmin(a, b), tmin(tmax(a, b), c));
}

// The kernel's limiters: a type with a static ``eval(u, c, d)`` (u far
// upwind, c upwind, d downwind), the expression of convect.quick /
// convect.vanleer; a user-defined limiter is rendered into the same form
// (waterlily_tpu_torch/kernels/limiter.py).
struct Quick {  // QUICK with median limiter
  static __device__ __forceinline__ float eval(float u, float c, float d) {
    return median3((5.f * c + 2.f * d - u) / 6.f, c,
                   median3(10.f * c - 9.f * u, c, d));
  }
};

struct VanLeer {  // van Leer, division-guarded
  static __device__ __forceinline__ float eval(float u, float c, float d) {
    const float denom = (d == u) ? 1.f : d - u;
    const float lim = c + (d - c) * (c - u) / denom;
    const bool keep = (c <= tmin(u, d)) || (c >= tmax(u, d));
    return keep ? c : lim;
  }
};

// Flux through face kf of an axis of length S from its taps and advecting
// velocity w; PER: the axis is periodic (fm2 already wrapped at face 1).
// The plain form evaluates both upwind values, pos = limiter(fm2, fm1, f)
// and neg = limiter(fp1, f, fm1), and keeps w*pos where w > 0, else w*neg;
// here the sign of w picks the limiter's arguments first, so one limiter
// runs and the kept value is the same, bit for bit.
template <class L, bool PER>
__device__ __forceinline__ float flux(float fm2, float fm1, float f, float fp1,
                                      float w, float nu, int kf, int S) {
  const bool up = w > 0.f;
  float v = L::eval(up ? fm2 : fp1, up ? fm1 : f, up ? f : fm1);
  if (!PER && (up ? kf == 1 : kf == S - 1)) v = 0.5f * (f + fm1);
  return w * v - nu * (f - fm1);
}

// Component c at (i, j, k), 0 outside the array.
__device__ inline float at(const float* __restrict__ u, const Grid& g, int c,
                           int i, int j, int k) {
  if (i < 0 || i >= g.S0 || j < 0 || j >= g.S1 || k < 0 || k >= g.S2)
    return 0.f;
  return u[c * g.N + i * g.P + j * g.S2 + k];
}

// Face 1's flux of component c along periodic axis A at the transverse
// position of (i, j, k): what faces 1 and S-1 of that axis carry.  Its
// far-upwind tap wraps to plane S-3, which no tile holds, so the taps come
// from memory; only the threads at those two faces call it (whole grid:
// the modular form needs no wrap).
template <class L, int A>
__device__ float periodic_face1(const float* __restrict__ u, const Grid& g,
                                int c, int i, int j, int k, float nu) {
  const int S = A == 0 ? g.S0 : A == 1 ? g.S1 : g.S2;
  const int di = A == 0, dj = A == 1, dk = A == 2;
  if (A == 0) i = 1;
  if (A == 1) j = 1;
  if (A == 2) k = 1;
  const float f = at(u, g, c, i, j, k);
  const float fm1 = at(u, g, c, i - di, j - dj, k - dk);
  const float fm2 = at(u, g, c, i + di * (S - 4), j + dj * (S - 4),
                       k + dk * (S - 4));
  const float fp1 = at(u, g, c, i + di, j + dj, k + dk);
  const float w = 0.5f * (at(u, g, A, i, j, k) +
                          at(u, g, A, i - (c == 0), j - (c == 1), k - (c == 2)));
  return flux<L, true>(fm2, fm1, f, fp1, w, nu, 1, S);
}

typedef float Plane[CV_HJ][CV_HK];   // one component's plane tile

// The global position of array index q along axis A, and the global size
// of the axis: the array's own on the whole grid (FORM 0), from the base
// and the global sizes in a shard-local form (FORM 1 walls, 2 modular).
template <int FORM, int A>
__device__ __forceinline__ int gpos(const Grid& g, int q) {
  return FORM ? q + (A == 0 ? g.B0 : A == 1 ? g.B1 : g.B2) : q;
}

template <int FORM, int A>
__device__ __forceinline__ int gsize(const Grid& g) {
  return FORM ? (A == 0 ? g.G0 : A == 1 ? g.G1 : g.G2)
              : (A == 0 ? g.S0 : A == 1 ? g.S1 : g.S2);
}

// Component c's flux through the lower face along axis A (1 or 2) of the
// cell at tile position (y, x) (halo offset included), array position
// (i, j, k); wprev is u_A at (i-1, j, k), the advecting velocity's second
// tap for component 0 (not read for the others).
template <class L, int PER, int FORM, int A>
__device__ __forceinline__ float inplane_flux(const Plane* T, int y, int x,
                                              int c, float wprev,
                                              const float* __restrict__ u,
                                              const Grid& g, int i, int j,
                                              int k, float nu) {
  const int kf = A == 1 ? j : k;
  const int S = A == 1 ? g.S1 : g.S2;
  constexpr bool per = (PER >> A) & 1;
  if (per && FORM != 2 && (kf == 1 || kf == S - 1))
    return periodic_face1<L, A>(u, g, c, i, j, k, nu);
  constexpr int dy = A == 1, dx = A == 2;
  const float wb = c == 0 ? wprev : T[A][y - (c == 1)][x - (c == 2)];
  return flux<L, per>(T[c][y - 2 * dy][x - 2 * dx], T[c][y - dy][x - dx],
                      T[c][y][x], T[c][y + dy][x + dx],
                      0.5f * (T[A][y][x] + wb), nu, gpos<FORM, A>(g, kf),
                      gsize<FORM, A>(g));
}

// The three components' fluxes through axis-0 face f of this thread's
// column from its taps at planes f-2, f-1, f, f+1 (registers) and plane f's
// tile (u_0's in-plane neighbours, at tile position (y, x)).
template <class L, int PER, int FORM>
__device__ __forceinline__ void axis0_faces(
    const float m2[3], const float m1[3], const float c0[3], const float p1[3],
    const Plane* T, int y, int x, const float* __restrict__ u, const Grid& g,
    int f, int j, int k, float nu, float out[3]) {
  constexpr bool per = PER & 1;
  if (per && FORM != 2 && (f == 1 || f == g.S0 - 1)) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[c] = periodic_face1<L, 0>(u, g, c, f, j, k, nu);
    return;
  }
  const float wb[3] = {m1[0], T[0][y - 1][x], T[0][y][x - 1]};
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[c] = flux<L, per>(m2[c], m1[c], c0[c], p1[c],
                          0.5f * (c0[0] + wb[c]), nu, gpos<FORM, 0>(g, f),
                          gsize<FORM, 0>(g));
}

template <class L, int PER, int FORM, bool MB>
__global__ void __launch_bounds__(CV_THREADS, CV_MIN_BLOCKS)
conv_kernel(const float* __restrict__ u, float* __restrict__ r,
            float nu_host, const float* __restrict__ nu_dev, long long snu,
            long long su, Grid g, int rows) {
  __shared__ Plane tile[2][3];                  // planes i and i+1
  __shared__ float f1[3][CV_TJ + 1][CV_TK];     // axis-1 lower-face fluxes
  __shared__ float f2[3][CV_TJ][CV_TK + 1];     // axis-2 lower-face fluxes
  const int tj = threadIdx.y, tk = threadIdx.x, t = tj * CV_TK + tk;
  const int j0 = blockIdx.y * CV_TJ, k0 = blockIdx.x * CV_TK;
  const int j = j0 + tj, k = k0 + tk;
  int i0 = (int)blockIdx.z * rows;
  float nu = nu_host;
  if (MB) {
    const int chunks = (g.S0 + rows - 1) / rows;
    const int m = (int)blockIdx.z / chunks;
    i0 = ((int)blockIdx.z - m * chunks) * rows;
    u += m * su;
    r += (long long)m * 3 * g.N;
    if (nu_dev) nu = nu_dev[m * snu];
  }
  const int i1 = min(i0 + rows, g.S0);
  const bool in = j < g.S1 && k < g.S2;
  const int col = j * g.S2 + k;
  const int y = tj + 2, x = tk + 2;
  // the halo cell this thread fills in each plane tile (t < CV_HALO): the
  // two rows below and above the tile, then two columns on each side
  int hy, hx;
  if (t < 2 * CV_HK) {
    hy = t / CV_HK;
    hx = t % CV_HK;
  } else if (t < 4 * CV_HK) {
    hy = CV_TJ + 2 + (t - 2 * CV_HK) / CV_HK;
    hx = (t - 2 * CV_HK) % CV_HK;
  } else {
    const int s = t - 4 * CV_HK, q = s % 4;
    hy = 2 + s / 4;
    hx = q < 2 ? q : CV_TK + q;
  }
  const int hj = j0 + hy - 2, hk = k0 + hx - 2;
  const bool hin = t < CV_HALO && hj >= 0 && hj < g.S1 && hk >= 0 &&
                   hk < g.S2;
  const int hcol = hj * g.S2 + hk;
  // the tile's top faces, one flux a thread, so that no warp evaluates more
  // than one flux beyond its cells' nine: threads [0, 3 CV_TK) take the
  // axis-1 faces of row CV_TJ (component t / CV_TK, one per warp), the next
  // 3 CV_TJ the axis-2 faces of column CV_TK (row e / 3, component e % 3)
  const int e2 = t - 3 * CV_TK;
  const int e_axis = e2 < 0 ? 1 : e2 < 3 * CV_TJ ? 2 : 0;
  const int ec = e2 < 0 ? t / CV_TK : e2 % 3;
  const int ey = e2 < 0 ? CV_TJ : e2 / 3;   // tile row and column
  const int ex = e2 < 0 ? t % CV_TK : CV_TK;
  const int ej = j0 + ey, ek = k0 + ex;

  auto load = [&](int c, int i) {
    return (in && i >= 0 && i < g.S0) ? u[c * g.N + i * g.P + col] : 0.f;
  };
  auto fill = [&](Plane* T, int i, const float own[3]) {
    const bool hp = hin && i >= 0 && i < g.S0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T[c][y][x] = own[c];
      if (t < CV_HALO) T[c][hy][hx] = hp ? u[c * g.N + i * g.P + hcol] : 0.f;
    }
  };

  // prologue: face i0's fluxes from planes i0-2..i0+1 and plane i0's tile
  float m1[3], c0[3], p1[3], p2[3], F0[3], Fn[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    m1[c] = load(c, i0 - 2);
    c0[c] = load(c, i0 - 1);
    p1[c] = load(c, i0);
    p2[c] = load(c, i0 + 1);
  }
  fill(tile[i0 & 1], i0, p1);
  __syncthreads();
  axis0_faces<L, PER, FORM>(m1, c0, p1, p2, tile[i0 & 1], y, x, u, g, i0, j,
                           k, nu, F0);
  // from here m1, c0, p1 hold planes i-1, i, i+1
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    m1[c] = c0[c];
    c0[c] = p1[c];
    p1[c] = p2[c];
  }
  for (int i = i0; i < i1; ++i) {
    Plane* T = tile[i & 1];
    Plane* Tn = tile[(i + 1) & 1];
#pragma unroll
    for (int c = 0; c < 3; ++c) p2[c] = load(c, i + 2);
    fill(Tn, i + 1, p1);
    __syncthreads();   // plane i+1's tile is complete
    axis0_faces<L, PER, FORM>(m1, c0, p1, p2, Tn, y, x, u, g, i + 1, j, k,
                             nu, Fn);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f1[c][tj][tk] = inplane_flux<L, PER, FORM, 1>(T, y, x, c, m1[1], u, g,
                                                   i, j, k, nu);
      f2[c][tj][tk] = inplane_flux<L, PER, FORM, 2>(T, y, x, c, m1[2], u, g,
                                                   i, j, k, nu);
    }
    if (e_axis == 1) {
      const float wp = ec == 0 ? at(u, g, 1, i - 1, ej, ek) : 0.f;
      f1[ec][CV_TJ][ex] = inplane_flux<L, PER, FORM, 1>(
          T, ey + 2, ex + 2, ec, wp, u, g, i, ej, ek, nu);
    } else if (e_axis == 2) {
      const float wp = ec == 0 ? at(u, g, 2, i - 1, ej, ek) : 0.f;
      f2[ec][ey][CV_TK] = inplane_flux<L, PER, FORM, 2>(
          T, ey + 2, ex + 2, ec, wp, u, g, i, ej, ek, nu);
    }
    __syncthreads();   // every face flux of plane i is in place
    if (in) {
      // the write support, in global positions
      const int gi = gpos<FORM, 0>(g, i), gj = gpos<FORM, 1>(g, j),
                gk = gpos<FORM, 2>(g, k);
      const bool m0 = gi >= 1 && gi <= gsize<FORM, 0>(g) - 2 && gj >= 1 &&
                      gk >= 1;
      const bool mj = gj >= 1 && gj <= gsize<FORM, 1>(g) - 2 && gi >= 1 &&
                      gk >= 1;
      const bool mk = gk >= 1 && gk <= gsize<FORM, 2>(g) - 2 && gi >= 1 &&
                      gj >= 1;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float acc = 0.f;
        acc = acc + (m0 ? F0[c] - Fn[c] : 0.f);
        acc = acc + (mj ? f1[c][tj][tk] - f1[c][tj + 1][tk] : 0.f);
        acc = acc + (mk ? f2[c][tj][tk] - f2[c][tj][tk + 1] : 0.f);
        r[c * g.N + i * g.P + col] = acc;
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      F0[c] = Fn[c];
      m1[c] = c0[c];
      c0[c] = p1[c];
      p1[c] = p2[c];
    }
  }
}

// Planes of each block's march: the fewest chunks of at most CV_ROWS_MAX
// planes, more where the tiles alone would give the card fewer than
// CV_BLOCKS blocks, down to chunks of CV_ROWS_MIN; balanced over S0.  258^3
// marches 5 chunks of 52 planes (1485 blocks), (98,66,66) 25 of 4 (675).
static int conv_rows(int S0, int S1, int S2) {
  const int tiles = ((S1 + CV_TJ - 1) / CV_TJ) * ((S2 + CV_TK - 1) / CV_TK);
  const int most = (S0 + CV_ROWS_MIN - 1) / CV_ROWS_MIN;
  const int fewest = (S0 + CV_ROWS_MAX - 1) / CV_ROWS_MAX;
  int chunks = (CV_BLOCKS + tiles - 1) / tiles;
  chunks = chunks < most ? chunks : most;
  chunks = chunks > fewest ? chunks : fewest;
  return (S0 + chunks - 1) / chunks;
}

#define WL_CONV_FORM(P, MB)                                              \
  case P:                                                                \
    conv_kernel<L, (P) & 7, ((P) >> 3), MB>                              \
        <<<grid, dim3(CV_TK, CV_TJ), 0, s>>>(u, r, nu, nu_dev, snu, su,  \
                                             g, rows);                   \
    break;

// Launches the kernel with limiter L on the periodic-axes mask ``periodic``
// (bit a: axis a periodic), in the modular form where ``modular`` (and an
// axis is periodic), on an array of shape S that sits at global index B of
// a grid of sizes G (the whole grid: G = S, B = 0), for ``members`` members
// (one field: 1; u at member stride su, nu from nu_dev at stride snu where
// nu_dev is not null); returns a cudaError_t.
template <class L>
int launch_conv(const float* u, float* r, float nu, const float* nu_dev,
                long long snu, int members, long long su, int periodic,
                int modular, int S0, int S1, int S2, int G0, int G1, int G2,
                int B0, int B1, int B2, void* stream) {
  // 32-bit indexing: the three components must stay below 2^31 cells
  if ((long long)3 * S0 * S1 * S2 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Grid g = {S0, S1, S2, S1 * S2, S0 * S1 * S2,
                  B0, B1, B2, G0, G1, G2};
  const cudaStream_t s = (cudaStream_t)stream;
  const int rows = conv_rows(g.S0, g.S1, g.S2);
  const int chunks = (g.S0 + rows - 1) / rows;
  if (members < 1 || (long long)members * chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((g.S2 + CV_TK - 1) / CV_TK, (g.S1 + CV_TJ - 1) / CV_TJ,
                  members * chunks);
  // FORM: 0 the whole grid, 1 a shard's block with walls, 2 with periodic
  // axes (modular; a shard-local periodic call must be modular)
  const bool whole = B0 == 0 && B1 == 0 && B2 == 0 && G0 == S0 &&
                     G1 == S1 && G2 == S2 && !modular;
  const int form = whole ? 0 : periodic ? 2 : 1;
  if (form == 2 && !modular) return (int)cudaErrorInvalidValue;
  if (members > 1 || nu_dev) {   // the member-axis instance: whole grid
    if (form != 0) return (int)cudaErrorInvalidValue;
    switch (periodic) {
      WL_CONV_FORM(0, true) WL_CONV_FORM(1, true) WL_CONV_FORM(2, true)
      WL_CONV_FORM(3, true) WL_CONV_FORM(4, true) WL_CONV_FORM(5, true)
      WL_CONV_FORM(6, true) WL_CONV_FORM(7, true)
      default:
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  switch (periodic | form << 3) {
    WL_CONV_FORM(0, false) WL_CONV_FORM(1, false) WL_CONV_FORM(2, false)
    WL_CONV_FORM(3, false) WL_CONV_FORM(4, false) WL_CONV_FORM(5, false)
    WL_CONV_FORM(6, false) WL_CONV_FORM(7, false) WL_CONV_FORM(8, false)
    WL_CONV_FORM(17, false) WL_CONV_FORM(18, false) WL_CONV_FORM(19, false)
    WL_CONV_FORM(20, false) WL_CONV_FORM(21, false) WL_CONV_FORM(22, false)
    WL_CONV_FORM(23, false)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
#undef WL_CONV_FORM
