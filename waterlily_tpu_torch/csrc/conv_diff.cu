// conv_diff3d's entry point for the limiters compiled in: QUICK (lim 0) and
// van Leer (lim 1), in the order of convect.KERNEL_LIMITERS.  The kernel,
// its design and its measurements are in conv_diff.cuh; a user-defined
// limiter gets an entry point of its own, generated and built at first use
// (waterlily_tpu_torch/kernels/limiter.py).
#include "conv_diff.cuh"

// nu: every member's, or (nu_dev not null) member m's at nu_dev[m snu];
// members: r holds that many fields one after another (one field: 1), u at
// member stride su (0: shared).  G0..G2: the global sizes, B0..B2: the
// global index of cell 0 (the whole grid: G = S, B = 0); modular: the
// shard-local periodic form.
extern "C" int wl_conv_diff3d(const float* u, float* r, float nu,
                              const float* nu_dev, long long snu,
                              int members, long long su, int lim,
                              int periodic, int modular, int S0, int S1,
                              int S2, int G0, int G1, int G2, int B0, int B1,
                              int B2, void* stream) {
  if (lim == 0)
    return launch_conv<Quick>(u, r, nu, nu_dev, snu, members, su, periodic,
                              modular, S0, S1, S2, G0, G1, G2, B0, B1, B2,
                              stream);
  if (lim == 1)
    return launch_conv<VanLeer>(u, r, nu, nu_dev, snu, members, su,
                                periodic, modular, S0, S1, S2, G0, G1, G2,
                                B0, B1, B2, stream);
  return (int)cudaErrorInvalidValue;
}
