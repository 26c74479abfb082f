// Bandwidth probes: a scaled copy o = C x and a scaled copy with four
// in-plane neighbour reads o = C (x + 1e-30 (x[j-1] + x[j+1] + x[k-1] +
// x[k+1])), the in-plane neighbours wrapping around the (S1, S2) plane as
// jnp.roll / torch.roll do.
//
// Replace scripts/bench_kernels.py `copy_kernel` (run by `pal_copy`) and
// `roll_kernel` (run by `pal_roll`), the TPU's probes of what a streaming
// kernel can move.  Here they measure the card's achievable memory rate for
// one read and one write a cell, the yardstick beside the data sheet's
// 3.35 TB/s for the stencil kernels' bound shares (chip_smoke.py phase 8).
//
// Bound on the H100: memory (one field read, one written; 1 and 6 flops a
// cell).  Design: the copy moves 16 bytes a thread (float4 loads and stores;
// the caller passes 16-byte aligned arrays), the ragged tail cell by cell.
// The roll keeps one thread a cell on a (32, 8) tile of (axis 2, axis 1), so
// the j+-1 and k+-1 reads of a warp hit lines its block already brought into
// L1; the wrap is an index computation, not a copy.
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

__global__ void roll_probe_kernel(const float* __restrict__ x,
                                  float* __restrict__ o, float C, Shape3 g) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int i = blockIdx.z;
  const int S1 = g.S[1], S2 = g.S[2];
  if (j >= S1 || k >= S2) return;
  const float* row = x + i * g.st[0];
  const int jm = j == 0 ? S1 - 1 : j - 1, jp = j == S1 - 1 ? 0 : j + 1;
  const int km = k == 0 ? S2 - 1 : k - 1, kp = k == S2 - 1 ? 0 : k + 1;
  // ((roll(+1, axis 1) + roll(-1, axis 1)) + roll(+1, axis 2)) + roll(-1,
  // axis 2), in the order of the TPU kernel's expression
  float t = row[(long long)jm * S2 + k] + row[(long long)jp * S2 + k];
  t = t + row[(long long)j * S2 + km];
  t = t + row[(long long)j * S2 + kp];
  const long long c = i * g.st[0] + (long long)j * S2 + k;
  o[c] = C * (x[c] + 1e-30f * t);
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
  const Shape3 g = make_shape(S0, S1, S2);
  const dim3 grid((S2 + 31) / 32, (S1 + 7) / 8, S0);
  roll_probe_kernel<<<grid, dim3(32, 8), 0, (cudaStream_t)stream>>>(x, o, C,
                                                                    g);
  return (int)cudaGetLastError();
}
