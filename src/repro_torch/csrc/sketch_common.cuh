// Shared pieces of the block_sketch and plan_sketch kernels.
//
// Both kernels reduce row tiles in concurrent CTAs.  Each CTA writes one
// partial per (group, feature) -- (count, mean, M2) in double and (min, max)
// in float -- to scratch; sketch_finalize then Chan-combines the partials in
// a fixed order (a sequential fold per lane, then a fixed butterfly across
// the 32 lanes of a warp), so the result does not depend on how the CTAs
// were scheduled.  No float atomics are used anywhere; histograms count with
// int32 atomics, which are exact.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace repro_sketch {

// clip(floor((x - lo) * inv_width), 0, bins - 1), in float32 exactly as the
// reference's jit and Pallas paths compute it: round-to-nearest subtract,
// then multiply (no fused multiply-add).  NaN lands in bin 0.
__device__ __forceinline__ int bin_of(float x, float lo, float inv_width, int bins) {
  const float t = __fmul_rn(__fsub_rn(x, lo), inv_width);
  const float f = floorf(t);
  if (!(f > 0.0f)) return 0;
  if (f >= (float)(bins - 1)) return bins - 1;
  return (int)f;
}

// Chan et al.'s parallel combine of (count, mean, m2) in double.
__device__ __forceinline__ void chan_fold(double& n, double& mean, double& m2,
                                          double nb, double mb, double m2b) {
  if (nb <= 0.0) return;
  if (n <= 0.0) {
    n = nb;
    mean = mb;
    m2 = m2b;
    return;
  }
  const double tot = n + nb;
  const double d = mb - mean;
  mean += d * (nb / tot);
  m2 += m2b + d * d * (n * nb / tot);
  n = tot;
}

// A CTA's (count, shifted sum, shifted sum of squares) -> (count, mean, M2).
__device__ __forceinline__ void shifted_to_moments(double c, double s, double ss, float shift,
                                                   double& mean, double& m2) {
  if (c <= 0.0) {
    mean = 0.0;
    m2 = 0.0;
    return;
  }
  const double ms = s / c;
  mean = (double)shift + ms;
  m2 = ss - s * ms;
  if (m2 < 0.0) m2 = 0.0;
}

// Partial layout: pmom [ctas][groups][3][F] double (count, mean, m2),
//                 pext [ctas][groups][2][F] float (min, max).
// One warp per (group, feature) column.  Output stats [groups * 5, F] float:
// rows 5g..5g+4 are (count, mean, M2, min, max).
// static: each translation unit that includes this header gets its own copy.
static __global__ void sketch_finalize(const double* __restrict__ pmom, const float* __restrict__ pext,
                                int ctas, int groups, int F, float* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  const int col = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5);
  if (col >= groups * F) return;  // whole warp exits together
  const int g = col / F;
  const int f = col - g * F;
  double n = 0.0, mean = 0.0, m2 = 0.0;
  float mn = CUDART_INF_F, mx = -CUDART_INF_F;
  for (int c = lane; c < ctas; c += 32) {
    const int64_t mb = ((int64_t)c * groups + g) * 3 * F + f;
    const int64_t eb = ((int64_t)c * groups + g) * 2 * F + f;
    chan_fold(n, mean, m2, pmom[mb], pmom[mb + F], pmom[mb + 2 * F]);
    mn = fminf(mn, pext[eb]);
    mx = fmaxf(mx, pext[eb + F]);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const double nb = __shfl_down_sync(0xffffffffu, n, off);
    const double meanb = __shfl_down_sync(0xffffffffu, mean, off);
    const double m2b = __shfl_down_sync(0xffffffffu, m2, off);
    const float mnb = __shfl_down_sync(0xffffffffu, mn, off);
    const float mxb = __shfl_down_sync(0xffffffffu, mx, off);
    chan_fold(n, mean, m2, nb, meanb, m2b);
    mn = fminf(mn, mnb);
    mx = fmaxf(mx, mxb);
  }
  if (lane == 0) {
    stats[(5 * g + 0) * (int64_t)F + f] = (float)n;
    stats[(5 * g + 1) * (int64_t)F + f] = (float)mean;
    stats[(5 * g + 2) * (int64_t)F + f] = (float)m2;
    stats[(5 * g + 3) * (int64_t)F + f] = mn;
    stats[(5 * g + 4) * (int64_t)F + f] = mx;
  }
}

static inline cudaError_t launch_finalize(const double* pmom, const float* pext, int ctas, int groups,
                                   int F, float* stats, cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = (int64_t)groups * F * 32;
  const int blocks = (int)((total + threads - 1) / threads);
  sketch_finalize<<<blocks, threads, 0, stream>>>(pmom, pext, ctas, groups, F, stats);
  return cudaGetLastError();
}

// Raise the dynamic shared-memory ceiling of a kernel when it needs more
// than the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace repro_sketch
