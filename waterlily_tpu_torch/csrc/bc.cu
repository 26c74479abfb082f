// Domain boundary conditions of a (3, S) velocity field, in place, in one
// launch (the wrapper runs it on a clone for a copy).
//
// Replaces waterlily_tpu/ops/pallas_stencil.py `bc3d_pallas` (`_bc_kernel`),
// whole grid, with its periodic and save_exit forms, and its shard-local
// (base) form.
//
// Semantics (waterlily_tpu.ops.bc.bc_vector): for each component c the
// stages j = 0, 1, 2 run in order, each on the values the previous stage
// left.  Along a periodic axis (bit j of `periodic`) plane 0 copies plane
// S-2 and plane S-1 copies plane 1.  Otherwise, along the normal axis
// (j == c) planes 0, 1 and S-1 become A[c] (Dirichlet; with `save_exit`,
// component 0 keeps its plane S-1 along axis 0: the convective outlet);
// along a tangential axis plane 0 copies plane 1 and plane S-1 copies plane
// S-2 (zero Neumann).  Ghost corners depend on that order.
//
// Every written cell resolves its source backwards (`bc_source`): stage 2
// either yields A[c] or maps the axis-2 index to its source plane, then
// stage 1 the axis-1 index, then stage 0 the axis-0 index; the cell then
// takes that one source value.  This is exactly the sequential order (a
// stage never modifies the planes it copies from), so the result equals the
// plane-update chain bit for bit, corners included.
//
// Only the cells that change are written: for each component the ghost
// planes 0 and S-1 of the three axes and plane 1 of its normal axis,
// except the kept outlet plane's own cells.  One launch is race-free: a
// resolved source has every index in [1, S-2] (a periodic or tangential
// stage maps 0 and S-1 into that range and leaves the others), and along
// the normal axis index >= 2 (indices 0, 1 and S-1 yield A[c]) or S-1 on
// the kept outlet plane, which is not written.  So no source is a cell the
// launch writes, and every cell reads the values the sequential chain's
// stages read.  A block takes one tile of one (component, strip) pair in
// 2D thread coordinates: 3 components x 6 strips, the ghost faces of axes
// 0 and 1 (32 x 32 tiles), the two axis-2 faces together, a thread writing
// both ends of its row and component 2's Dirichlet k = 1 (32 x 8 tiles:
// these strided cells want many blocks in flight), and the Dirichlet
// plane; the strips' tiles lie end to end in blockIdx.x (`BcTiles`), with
// no idle block.  No division per cell.  A face of axis a spans the full
// range of the axes after a and the interior [1, S-2] of the axes before
// it, and the Dirichlet strip the interior of plane 1, so a cell that two
// faces share is written once, by the face of its lowest ghost axis.
//
// Bound on the H100: the Dirichlet cells (planes 0, 1 and S-1 of each
// component's normal axis, ~9 of the ~21 planes written) take one 4 B
// write, every other written cell one 4 B read and one 4 B write (8.7 MB
// at 258³ with walls, 0.0026 ms by bytes); the axis-2 faces are strided,
// one 32 B sector (read, then written back) for each of their ~0.4M cells
// at 258³, and these scattered sectors take most of the time.
//
// Base form (walls and the outlet only, as in JAX): the array is one
// shard's block of a grid of global sizes G whose cell 0 sits at global
// index B.  The global ghost planes and Dirichlet plane that fall in the
// block are its faces that are "present": the low face of axis a where
// B[a] == 0 (it holds global planes 0 and 1: blocks are at least 2 cells
// wide), the high face where B[a] + S[a] == G[a].  Every test above of a
// plane 0, 1 or S-1 becomes a test of a present face, and the sources stay
// the block's planes 1 and S-2, which on the shards that own the faces
// are the global planes 1 and G-2 (the ownership argument of the TPU
// kernel).  A block with no present face writes nothing; the race-freedom
// argument holds face by face.  The whole grid is the case with every
// face present, compiled apart (`AllFaces`: every face present at compile
// time, an empty parameter after the others).  Measured at 258^3 on an
// H100: the face flags tested at run time cost 7%; folded at compile time
// but carried in BcShape (16 -> 40 bytes) 13%, with 1160 instructions
// against 1168 before: the parameters' layout, not the code.
//
// Indices are 32-bit: the wrapper admits fields of fewer than 2^31 values.
//
// Members (an ensemble under torch.func.vmap, `bc3d`'s member form):
// blockIdx.y is the member, u holds the members' fields one after another
// (each filled in place) and a device array A one (3,) vector a member, at
// member stride sA (0: one for all); numbers passed with the launch are
// every member's.
#include "common.cuh"

struct BcShape {
  int S[3];
  int N;  // cells of one component
};

// The global faces a launch fills: every one on the whole grid (an empty
// parameter), those in a shard's block (1 where the block holds the global
// low or high face of the axis).
struct AllFaces {
  __host__ __device__ int lo(int) const { return 1; }
  __host__ __device__ int hi(int) const { return 1; }
};

struct BlockFaces {
  int l[3], h[3];
  __host__ __device__ int lo(int a) const { return l[a]; }
  __host__ __device__ int hi(int a) const { return h[a]; }
};

// The Dirichlet values A: three numbers passed with the launch, or (ptr not
// null) a (3,) device array (values the host does not hold).
struct BcValues {
  const float* ptr;
  float v[3];
};

__device__ inline float bc_value(const BcValues& A, int comp) {
  return A.ptr ? A.ptr[comp] : A.v[comp];
}

// The flat source index of component `comp`'s cell (i, j, k) after the
// three stages, or -1 where the result is A[comp].
template <int PER, int EXIT, class F>
__device__ inline int bc_source(int comp, int i, int j, int k,
                                const BcShape& g, const F& fc) {
  int idx[3] = {i, j, k};
#pragma unroll
  for (int a = 2; a >= 0; --a) {
    const int q = idx[a];
    const int hi = g.S[a] - 1;
    const bool at_lo = fc.lo(a) && q == 0;
    const bool at_hi = fc.hi(a) && q == hi;
    if ((PER >> a) & 1) {
      if (at_lo) {
        idx[a] = hi - 1;
      } else if (at_hi) {
        idx[a] = 1;
      }
    } else if (a == comp) {
      const bool kept = EXIT && comp == 0;  // the outlet plane
      if ((fc.lo(a) && q <= 1) || (at_hi && !kept)) return -1;
    } else if (at_lo) {
      idx[a] = 1;
    } else if (at_hi) {
      idx[a] = hi - 1;
    }
  }
  return comp * g.N + (idx[0] * g.S[1] + idx[1]) * g.S[2] + idx[2];
}

#define BC_TILE 32
#define BC_ROWS 8    // blockDim.y
#define BC_STRIPS 6  // a component's strips: 4 faces, the axis-2 pair, plane 1
#define BC_RMAX (BC_TILE / BC_ROWS)  // rows a thread, at most

// Strip f of component comp: the face or plane (axis a at index v; f == 4
// the pair v = 0 and S-1, each where present), its row axis b and column
// axis c (the faster) with their first index and extents, and the rows a
// thread takes (the strided axis-2 strip one: four times its blocks, spread
// over the card).  The rows and columns leave out the present faces of the
// axes before a (of both axes on the Dirichlet strip).  nb == 0 for a strip
// with nothing to write.
struct BcStrip {
  int a, v, b, c, lo_b, lo_c, nb, nc, rows;
};

template <class F>
__host__ __device__ inline BcStrip bc_strip_of(int comp, int f, int per,
                                              const BcShape& g,
                                              const F& fc) {
  BcStrip t;
  if (f < 5) {
    t.a = f >> 1;
    t.v = (f & 1) ? g.S[t.a] - 1 : 0;
  } else {
    t.a = comp;
    t.v = 1;
  }
  t.b = t.a == 0 ? 1 : 0;
  t.c = t.a == 2 ? 1 : 2;
  const bool xb = f == 5 || t.b < t.a, xc = f == 5 || t.c < t.a;
  t.lo_b = xb ? fc.lo(t.b) : 0;
  t.lo_c = xc ? fc.lo(t.c) : 0;
  t.nb = g.S[t.b] - t.lo_b - (xb ? fc.hi(t.b) : 0);
  t.nc = g.S[t.c] - t.lo_c - (xc ? fc.hi(t.c) : 0);
  // the face is not in the block (the Dirichlet plane 1 lies in the block
  // that holds plane 0)
  const bool present =
      f < 4    ? ((f & 1) ? fc.hi(t.a) : fc.lo(t.a))
      : f == 4 ? (fc.lo(2) || fc.hi(2))
               : fc.lo(comp);
  if (!present) t.nb = 0;
  // no Dirichlet plane (periodic), or the axis-2 strip writes it
  if (f == 5 && (((per >> comp) & 1) || comp == 2)) t.nb = 0;
  if (t.nb < 0 || t.nc <= 0) t.nb = 0;
  t.rows = f == 4 ? 1 : BC_RMAX;
  return t;
}

// The launch's blocks, strip after strip: strip z = comp * BC_STRIPS + f
// starts at block first[z] and has cols[z] column tiles a row of tiles.
struct BcTiles {
  int first[3 * BC_STRIPS + 1];
  int cols[3 * BC_STRIPS];
};

template <class F>
inline BcTiles bc_tiles(int per, const BcShape& g, const F& fc) {
  BcTiles t;
  t.first[0] = 0;
  for (int z = 0; z < 3 * BC_STRIPS; ++z) {
    const BcStrip s = bc_strip_of(z / BC_STRIPS, z % BC_STRIPS, per, g, fc);
    const int h = BC_ROWS * s.rows;  // rows of a tile
    t.cols[z] = (s.nc + BC_TILE - 1) / BC_TILE;
    t.first[z + 1] = t.first[z] + t.cols[z] * ((s.nb + h - 1) / h);
  }
  return t;
}

// In place: one tile of one strip (see the header).  Each thread loads all
// its sources before it stores: no load waits on a store (the compiler
// cannot know that a source is never a written cell).  The axis-2 strip
// writes, for each of its rows, k = 0 and S2-1, and for component 2 its
// Dirichlet k = 1 too (in the sectors of k = 0), so component 2 has no
// Dirichlet strip of its own.
template <int PER, int EXIT, class F>
__device__ inline void bc_strip(float* u, const BcValues& A,
                                const BcShape& g, const BcTiles& tiles,
                                const F& fc) {
  int z = 0;
  while ((int)blockIdx.x >= tiles.first[z + 1]) ++z;  // 18 strips at most
  const int comp = z / BC_STRIPS;
  const int f = z - comp * BC_STRIPS;
  const BcStrip t = bc_strip_of(comp, f, PER, g, fc);
  const int tile = blockIdx.x - tiles.first[z];
  const int tile_b = tile / tiles.cols[z];
  const int col = (tile - tile_b * tiles.cols[z]) * BC_TILE + threadIdx.x;
  if (col >= t.nc) return;
  const float Ac = bc_value(A, comp);
  // the planes of a row: the face's own, or on the axis-2 strip its present
  // faces 0 and S-1 and component 2's Dirichlet plane 1 (with face 0)
  const int lo2 = fc.lo(2), hi2 = fc.hi(2);
  const bool d2 = comp == 2 && !((PER >> 2) & 1) && lo2;
  const int H = f != 4 ? 1 : lo2 + hi2 + d2;
  const int q0 = f != 4 ? t.v : lo2 ? 0 : g.S[2] - 1;
  const int q1 = lo2 && hi2 ? g.S[2] - 1 : 1;
  int dst[BC_RMAX][3];
  float val[BC_RMAX][3];
#pragma unroll
  for (int m = 0; m < BC_RMAX; ++m) {
    const int row = (tile_b * t.rows + m) * BC_ROWS + threadIdx.y;
#pragma unroll
    for (int h = 0; h < 3; ++h) {
      dst[m][h] = -1;
      val[m][h] = 0.f;
      if (m >= t.rows || row >= t.nb || h >= H) continue;
      // (i, j, k) from the face index, row and column, by selects (b is
      // axis 0 unless a is; c is axis 2 unless a is)
      const int pa = h == 0 ? q0 : h == 1 ? q1 : 1;
      const int pb = t.lo_b + row, pc = t.lo_c + col;
      const int i = t.a == 0 ? pa : pb;
      const int j = t.a == 1 ? pa : (t.a == 0 ? pb : pc);
      const int k = t.a == 2 ? pa : pc;
      const int self = comp * g.N + (i * g.S[1] + j) * g.S[2] + k;
      const int src = bc_source<PER, EXIT>(comp, i, j, k, g, fc);
      if (src < 0) {
        dst[m][h] = self;
        val[m][h] = Ac;
      } else if (src != self) {  // the kept outlet plane is its own source
        dst[m][h] = self;
        val[m][h] = u[src];
      }
    }
  }
#pragma unroll
  for (int m = 0; m < BC_RMAX; ++m) {
#pragma unroll
    for (int h = 0; h < 3; ++h) {
      if (dst[m][h] >= 0) u[dst[m][h]] = val[m][h];
    }
  }
}

// PER: bit a set for each periodic axis a; EXIT: save_exit; F: the faces
// (`AllFaces`, or a shard's `BlockFaces`).  Template arguments, so that
// each form compiles to its own straight-line code.  No __restrict__: the
// launch reads and writes u.
template <int PER, int EXIT, class F>
__global__ void bc_kernel(float* u, BcValues A, BcShape g, BcTiles tiles,
                          F fc, int sA) {
  const int m = blockIdx.y;
  if (A.ptr) A.ptr += m * sA;
  bc_strip<PER, EXIT>(u + (long long)m * 3 * g.N, A, g, tiles, fc);
}

#define WL_BC_FORM(F)                                                    \
  case F:                                                                \
    bc_kernel<((F) & 7), ((F) >> 3)><<<grid, blk, 0, s>>>(               \
        u, Av, g, tiles, AllFaces(), sA);                                \
    break;

// Fill u's ghost faces and Dirichlet planes in place.  A: the (3,) device
// array of the Dirichlet values, or null and the values A0, A1, A2.
// members: u holds that many fields one after another (one field: 1),
// member m's values at A + m sA (sA 3, or 0: shared).  G0..G2: the global
// sizes, B0..B2: the global index of cell 0 (the whole grid: G = S, B = 0;
// a periodic form takes only the whole grid).
extern "C" int wl_bc3d(float* u, const float* A, float A0, float A1, float A2,
                       int periodic, int save_exit, int members, int sA,
                       int S0, int S1, int S2, int G0, int G1, int G2,
                       int B0, int B1, int B2, void* stream) {
  const BcValues Av = {A, {A0, A1, A2}};
  if ((long long)S0 * S1 * S2 * 3 >= (1LL << 31) || members < 1 ||
      members > 65535)
    return (int)cudaErrorInvalidValue;
  BcShape g;
  g.S[0] = S0; g.S[1] = S1; g.S[2] = S2;
  g.N = S0 * S1 * S2;
  const int G[3] = {G0, G1, G2}, B[3] = {B0, B1, B2};
  BlockFaces fc;
  bool base = false;
  for (int a = 0; a < 3; ++a) {
    fc.l[a] = B[a] == 0;
    fc.h[a] = B[a] + g.S[a] == G[a];
    base = base || !(fc.l[a] && fc.h[a]);
    if (B[a] < 0 || B[a] + g.S[a] > G[a] || g.S[a] < 2)
      return (int)cudaErrorInvalidValue;
  }
  const dim3 blk(32, BC_ROWS);
  cudaStream_t s = (cudaStream_t)stream;
  if (base) {
    // the shard-local form has walls and the outlet only
    if (periodic) return (int)cudaErrorInvalidValue;
    const BcTiles tiles = bc_tiles(0, g, fc);
    if (tiles.first[3 * BC_STRIPS] == 0) return (int)cudaSuccess;
    const dim3 grid(tiles.first[3 * BC_STRIPS], members);
    if (save_exit)
      bc_kernel<0, 1><<<grid, blk, 0, s>>>(u, Av, g, tiles, fc, sA);
    else
      bc_kernel<0, 0><<<grid, blk, 0, s>>>(u, Av, g, tiles, fc, sA);
    return (int)cudaGetLastError();
  }
  const BcTiles tiles = bc_tiles(periodic, g, AllFaces());
  if (tiles.first[3 * BC_STRIPS] == 0) return (int)cudaSuccess;
  const dim3 grid(tiles.first[3 * BC_STRIPS], members);
  switch (periodic | (save_exit ? 8 : 0)) {
    WL_BC_FORM(0) WL_BC_FORM(1) WL_BC_FORM(2) WL_BC_FORM(3)
    WL_BC_FORM(4) WL_BC_FORM(5) WL_BC_FORM(6) WL_BC_FORM(7)
    WL_BC_FORM(8) WL_BC_FORM(9) WL_BC_FORM(10) WL_BC_FORM(11)
    WL_BC_FORM(12) WL_BC_FORM(13) WL_BC_FORM(14) WL_BC_FORM(15)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
