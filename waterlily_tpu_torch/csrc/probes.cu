// Bandwidth probes: a scaled copy o = C x and a scaled copy with four
// in-plane neighbour reads o = C (x + 1e-30 (x[j-1] + x[j+1] + x[k-1] +
// x[k+1])), the in-plane neighbours wrapping around the (S1, S2) plane as
// jnp.roll / torch.roll do.
//
// Replace scripts/bench_kernels.py `copy_kernel` (run by `pal_copy`) and
// `roll_kernel` (run by `pal_roll`), the TPU's probes of what a streaming
// kernel can move.  Here they measure the card's achievable memory rate for
// one read and one write a cell, the yardstick beside the data sheet's
// 3.35 TB/s for the stencil kernels' bound shares (chip_smoke.py phase 8),
// and, for the roll, what a kernel with in-plane neighbour reads can move.
//
// Bound on the H100: memory (one field read, one written; 1 and 6 flops a
// cell).  Design: the copy moves 16 bytes a thread (float4 loads and stores;
// the caller passes 16-byte aligned arrays), the ragged tail cell by cell.
// The roll's first kernel (one thread a cell on (32, 8) tiles from cell 0,
// so the ninth tile of a 258 row ran 2 of its 32 lanes, all four taps
// loads that hoped for an L1 hit) took 0.0832 ms at 258^3, 0.49 of its
// 0.0410 ms bound.  Now each thread writes ROLL_ROWS rows of one column
// (a band) and holds x at those rows and the rows above and below in
// registers, so its j+-1 taps are its own values: each row loaded once,
// the band's two end rows twice.  The threads of a plane's bands are
// numbered (band, column) and cut into warps of 32 consecutive ones, so no
// warp is nearly empty whatever S2 is; k+-1 come from the neighbouring
// lanes by warp shuffles, and a lane whose neighbour is not its row's next
// column (a warp's edge, a row's end, where the wrap applies) loads it.
// The wrap is an index computation, never a copy.  Every load of a thread
// is issued before its first sum (the band's rows are a compile-time
// count): on the H100 at 258^3 that takes 0.0525 ms (0.78 of the bound,
// the copy probe 0.0469), with 4 rows a band 0.0527, 2 rows 0.0715, 16
// rows (93 registers) 0.0682, and 0.0642-0.0750 when each thread walked
// its band one row a step.
#include "common.cuh"

__global__ void copy_probe_kernel(const float* __restrict__ x,
                                  float* __restrict__ o, float C,
                                  long long n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = n / 4;
  if (t < n4) {
    const float4 v = reinterpret_cast<const float4*>(x)[t];
    reinterpret_cast<float4*>(o)[t] = make_float4(v.x * C, v.y * C, v.z * C,
                                                  v.w * C);
  } else if (t < n4 + (n - 4 * n4)) {
    const long long c = 4 * n4 + (t - n4);
    o[c] = x[c] * C;
  }
}

#define ROLL_ROWS 8   // rows of axis 1 a roll-probe thread writes

// Thread v of the grid is column k of band b of plane i, v = (i * bands +
// b) * S2 + k with bands = ceil(S1 / R): it writes rows [b R, min(b R + R,
// S1)) of its column, from x at rows b R - 1 to b R + R (wrapped).
// S0 * S1 * S2 < 2^31.
__global__ void __launch_bounds__(WL_THREADS)
roll_probe_kernel(const float* __restrict__ x, float* __restrict__ o,
                  float C, int S0, int S1, int S2) {
  constexpr int R = ROLL_ROWS;
  const int bands = (S1 + R - 1) / R;
  const int v = blockIdx.x * WL_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int base = 0, k = 0, j0 = 0, n = 0;   // n: rows written (0 past the end)
  if (v < S0 * bands * S2) {
    const int ib = v / S2;
    const int i = ib / bands;
    k = v - ib * S2;
    j0 = (ib - i * bands) * R;
    n = min(R, S1 - j0);
    base = i * S1 * S2 + k;
  }
  // the neighbouring lanes hold this row's k-1 and k+1 (the same band)
  const bool lo = lane > 0 && k > 0, hi = lane < 31 && k < S2 - 1;
  const int dm = k == 0 ? S2 - 1 : -1, dp = k == S2 - 1 ? 1 - S2 : 1;
  float c[R + 2], em[R], ep[R];   // x at rows j0 - 1 + r; k-1 and k+1 loads
#pragma unroll
  for (int r = 0; r < R + 2; ++r) {
    const int j = j0 - 1 + r;
    const int jw = j < 0 ? S1 - 1 : j == S1 ? 0 : j;
    c[r] = r <= n + 1 && n > 0 ? x[base + jw * S2] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int at = base + (j0 + r) * S2;
    em[r] = r < n && !lo ? x[at + dm] : 0.f;
    ep[r] = r < n && !hi ? x[at + dp] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // every lane takes part in the shuffles
    const float km = __shfl_up_sync(0xffffffffu, c[r + 1], 1);
    const float kp = __shfl_down_sync(0xffffffffu, c[r + 1], 1);
    if (r < n) {
      // ((roll(+1, axis 1) + roll(-1, axis 1)) + roll(+1, axis 2)) +
      // roll(-1, axis 2), in the order of the TPU kernel's expression
      float t = c[r] + c[r + 2];
      t = t + (lo ? km : em[r]);
      t = t + (hi ? kp : ep[r]);
      o[base + (j0 + r) * S2] = C * (c[r + 1] + 1e-30f * t);
    }
  }
}

extern "C" int wl_copy_probe(const float* x, float* o, float C, int S0, int S1,
                             int S2, void* stream) {
  const long long n = (long long)S0 * S1 * S2;
  const long long threads = n / 4 + n % 4;
  copy_probe_kernel<<<blocks_for(threads), WL_THREADS, 0,
                      (cudaStream_t)stream>>>(x, o, C, n);
  return (int)cudaGetLastError();
}

extern "C" int wl_roll_probe(const float* x, float* o, float C, int S0, int S1,
                             int S2, void* stream) {
  if ((long long)S0 * S1 * S2 >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long threads =
      (long long)S0 * ((S1 + ROLL_ROWS - 1) / ROLL_ROWS) * S2;
  roll_probe_kernel<<<blocks_for(threads), WL_THREADS, 0,
                      (cudaStream_t)stream>>>(x, o, C, S0, S1, S2);
  return (int)cudaGetLastError();
}
