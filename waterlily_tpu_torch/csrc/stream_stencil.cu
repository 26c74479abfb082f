// Carried-rows Poisson increment: (x + eps, r - A eps), every input row
// read once.  (The carried-rows z = A x is the plane march of
// stream_march.cu.)
//
// Replaces waterlily_tpu/ops/attic.py `increment3d_stream`
// (`_stream_rsub_kernel`).  It computes what `increment3d`
// (poisson_stencil.cu) computes, in the same association, with L in f32 or
// bf16 (a level's shadow L16, D the f32 D16) and eps in f32 or bf16, upcast
// in registers; r and x + eps are f32.  It also writes x + eps, which the
// TPU kernel left to XLA, so eps is read once for both outputs.
//
// The TPU kernel walks axis-0 slabs in order, one grid step ahead of its
// output, and carries x rows [gB-1, (g+1)B) and a row of L0 in VMEM so that
// every input row comes from HBM once.  Blocks here run in parallel with no
// carry between them; the H100 form of "each row read once" is a column
// march.  A block owns a tile of ST_TJ x ST_TK (axis 1, axis 2) columns and
// a chunk of ``rows`` axis-0 rows (the caller picks it: 29 rows at 258^3,
// which gives each of the 132 SMs some 20 blocks, and shorter chunks on
// smaller grids, whose few tiles would otherwise leave SMs idle while
// each block walked many rows).  Each thread walks its column
// down the chunk, carrying x[i-1], x[i], x[i+1] and L0[i], L0[i+1] in
// registers: the carried rows.  The in-plane taps (x at j+-1 and k+-1,
// L1[j+1], L2[k+1]) come from shared-memory plane tiles with a one-cell
// halo, written once per row from the threads' own registers plus the halo
// cells.  Only the tile halos and the two end rows of each chunk are read
// twice, and those re-reads mostly hit L2, where the neighbouring tile or
// chunk brought them.
//
// Bound on the H100: memory.  The increment moves L, D, eps, x, r and
// writes x and r: 9 fields a cell (7.5 with bf16 L), against ~15 flops.
// Ghost outputs are written by a branch (r unchanged) and the ragged
// edges of tiles and chunks are masked by bounds checks, never by a multiply.
// Every shape is taken: there is no divisibility condition.
// Members (an ensemble under torch.func.vmap, `increment3d_stream`'s member
// form): the grid's z axis runs over each member's chunks in turn
// (blockIdx.z = member * chunks + chunk), every member with a one-member
// launch's tiles and chunks; the outputs hold the members' fields one
// after another, each input sits at its own member stride (0 for one
// every member shares: a level's operator).
#include "common.cuh"

#define ST_TJ 8    // tile extent along axis 1 (threadIdx.y)
#define ST_TK 32   // tile extent along axis 2 (threadIdx.x)

// Member strides (elements) of the increment's inputs.
struct IncStrides {
  long long L, D, eps, x, r;
};

// TL: L's type; TX: eps's (``x`` below: the increment's eps; ``xa``: its
// x).  out = r - A eps, x_out = x + eps.  MB: the member-axis instance (the
// one-field instance leaves its pointers as they are passed, its chunk
// blockIdx.z).
template <typename TL, typename TX, bool MB>
__global__ void __launch_bounds__(ST_TJ * ST_TK)
stream_kernel(const TL* __restrict__ L, const float* __restrict__ Dd,
              const TX* __restrict__ x, const float* __restrict__ xa,
              const float* __restrict__ r, float* __restrict__ out,
              float* __restrict__ x_out, Shape3 g, int rows, IncStrides st) {
  __shared__ float sx[ST_TJ + 2][ST_TK + 2];  // x with a one-cell halo
  __shared__ float s1[ST_TJ + 1][ST_TK];      // L1 and its j+1 halo row
  __shared__ float s2[ST_TJ][ST_TK + 1];      // L2 and its k+1 halo column
  const int tj = threadIdx.y, tk = threadIdx.x;
  const int j = blockIdx.y * ST_TJ + tj, k = blockIdx.x * ST_TK + tk;
  const int S0 = g.S[0], S1 = g.S[1], S2 = g.S[2];
  int chunk = blockIdx.z;
  if constexpr (MB) {
    const int chunks = (S0 + rows - 1) / rows;
    const long long m = blockIdx.z / chunks;
    chunk = (int)(blockIdx.z - m * chunks);
    L += m * st.L;
    Dd += m * st.D;
    x += m * st.eps;
    xa += m * st.x;
    r += m * st.r;
    out += m * g.N;
    x_out += m * g.N;
  }
  const int i0 = chunk * rows;
  const int i1 = min(i0 + rows, S0);
  const bool in = j < S1 && k < S2;
  const bool inner_jk = j >= 1 && j <= S1 - 2 && k >= 1 && k <= S2 - 2;
  // which halo cells this thread loads (bounds-checked)
  const bool h_jm = in && tj == 0 && j >= 1;
  const bool h_jp = in && tj == ST_TJ - 1 && j + 1 < S1;
  const bool h_km = in && tk == 0 && k >= 1;
  const bool h_kp = in && tk == ST_TK - 1 && k + 1 < S2;
  const long long P = g.st[0];
  const long long col = (long long)j * S2 + k;
  const TL* L0 = L;
  const TL* L1 = L + g.N;
  const TL* L2 = L + 2 * g.N;
  // the carried rows of this column
  float xm = 0.f, xc = 0.f, l0c = 0.f;
  if (in) {
    if (i0 >= 1) xm = ld(x[(i0 - 1) * P + col]);
    xc = ld(x[i0 * P + col]);
    l0c = ld(L0[i0 * P + col]);
  }
  for (int i = i0; i < i1; ++i) {
    const long long c = i * P + col;
    float xp = 0.f, l0p = 0.f, l1 = 0.f, l2 = 0.f, d = 0.f, xav = 0.f,
          rv = 0.f;
    float hjm = 0.f, hjp = 0.f, hl1 = 0.f, hkm = 0.f, hkp = 0.f, hl2 = 0.f;
    if (in) {
      if (i + 1 < S0) {
        xp = ld(x[c + P]);
        l0p = ld(L0[c + P]);
      }
      l1 = ld(L1[c]);
      l2 = ld(L2[c]);
      d = Dd[c];
      xav = xa[c];
      rv = r[c];
    }
    if (h_jm) hjm = ld(x[c - S2]);
    if (h_jp) {
      hjp = ld(x[c + S2]);
      hl1 = ld(L1[c + S2]);
    }
    if (h_km) hkm = ld(x[c - 1]);
    if (h_kp) {
      hkp = ld(x[c + 1]);
      hl2 = ld(L2[c + 1]);
    }
    __syncthreads();  // every thread is done reading the previous row's tiles
    sx[tj + 1][tk + 1] = xc;
    s1[tj][tk] = l1;
    s2[tj][tk] = l2;
    if (tj == 0) sx[0][tk + 1] = hjm;
    if (tj == ST_TJ - 1) {
      sx[ST_TJ + 1][tk + 1] = hjp;
      s1[ST_TJ][tk] = hl1;
    }
    if (tk == 0) sx[tj + 1][0] = hkm;
    if (tk == ST_TK - 1) {
      sx[tj + 1][ST_TK + 1] = hkp;
      s2[tj][ST_TK] = hl2;
    }
    __syncthreads();
    if (in) {
      float v = 0.f;
      if (inner_jk && i >= 1 && i <= S0 - 2) {
        // the association of ax_cell_at (common.cuh)
        float s = xc * d;
        s = s + xm * l0c;
        s = s + xp * l0p;
        s = s + sx[tj][tk + 1] * s1[tj][tk];
        s = s + sx[tj + 2][tk + 1] * s1[tj + 1][tk];
        s = s + sx[tj + 1][tk] * s2[tj][tk];
        s = s + sx[tj + 1][tk + 2] * s2[tj][tk + 1];
        v = s;
      }
      out[c] = rv - v;
      x_out[c] = xav + xc;
    }
    xm = xc;
    xc = xp;
    l0c = l0p;
  }
}

// The tile extent along axis 1 (axis = 1) or axis 2 (axis = 2): the caller
// sizes the grid's chunks from it.
extern "C" int wl_stream_tile(int axis) {
  return axis == 1 ? ST_TJ : axis == 2 ? ST_TK : 0;
}

// (x_out, r_out) = (x + eps, r - A eps).  L_bf16 / eps_bf16: L / eps are
// bf16 (else f32).  members: x_out and r_out hold that many fields one
// after another, member m reading L + m sL, Dd + m sD, eps + m se, x + m sx
// and r + m sr (elements; 0: shared; one field: members 1).
extern "C" int wl_increment3d_stream(const void* L, const float* Dd,
                                     const void* eps, const float* x,
                                     const float* r, float* x_out,
                                     float* r_out, int L_bf16, int eps_bf16,
                                     int rows, int members, long long sL,
                                     long long sD, long long se, long long sx,
                                     long long sr, int S0, int S1, int S2,
                                     void* stream) {
  const int chunks = rows < 1 ? 0 : (S0 + rows - 1) / rows;
  if (rows < 1 || members < 1 || (long long)members * chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const Shape3 g = make_shape(S0, S1, S2);
  const dim3 grid((S2 + ST_TK - 1) / ST_TK, (S1 + ST_TJ - 1) / ST_TJ,
                  members * chunks);
  const cudaStream_t s = (cudaStream_t)stream;
  const IncStrides st{sL, sD, se, sx, sr};
  dispatch_bf16(L_bf16, eps_bf16, [&](auto tl, auto tx) {
    using TL = TAG_T(tl);
    using TX = TAG_T(tx);
    if (members > 1)
      stream_kernel<TL, TX, true><<<grid, dim3(ST_TK, ST_TJ), 0, s>>>(
          (const TL*)L, Dd, (const TX*)eps, x, r, r_out, x_out, g, rows, st);
    else
      stream_kernel<TL, TX, false><<<grid, dim3(ST_TK, ST_TJ), 0, s>>>(
          (const TL*)L, Dd, (const TX*)eps, x, r, r_out, x_out, g, rows, st);
  });
  return (int)cudaGetLastError();
}
