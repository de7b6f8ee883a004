// block_sketch: one pass over a [n, F] float32 block -> per-feature
// (count, mean, M2, min, max) and a fixed-grid histogram [F, bins].
//
// Replaces the Pallas kernel block_sketch_pallas (_sketch_kernel) of
// src/repro/kernels/block_sketch/kernel.py.  On the TPU the grid walked row
// tiles in order and folded each into VMEM-resident outputs, with the
// histogram as a one-hot [T, F, B] compare; neither carries over.
//
// Bound on the H100: bytes.  The block is read once (n * F * 4 bytes, 12.76
// MB for a 110,000 x 29 HIGGS block) and the outputs are a few KB, so the
// least time is the read at 3.35 TB/s (~3.8 us); the arithmetic is a few
// operations per element.
//
// Design:
//  * Row ranges of ROWS_PER_CTA rows run as concurrent CTAs.  Thread t < F*J
//    owns feature f = t % F and rows j, j+J, ... (j = t / F) of its range, so
//    consecutive threads read consecutive addresses of the row-major block
//    and every load is coalesced.  Four loads are issued before any is used.
//  * Each thread accumulates count, a shifted sum and a shifted sum of
//    squares in double (shift = the range's first row), then the J lanes of
//    a feature are summed in a fixed order and the CTA writes one
//    (count, mean, M2, min, max) partial.  sketch_finalize Chan-combines the
//    partials in a fixed order: no float atomics, results do not depend on
//    scheduling.
//  * The histogram counts with int32 atomics in shared memory (F*bins*4
//    bytes; 14.8 KB on the main path), flushed to a global int32 histogram
//    with one atomic per non-empty bin.  When it does not fit, the CTA counts
//    straight into global memory.  bins == 0 computes moments only.
#include "sketch_common.cuh"

namespace {

constexpr int kRowsPerCta = 256;

__device__ __forceinline__ void accumulate(float v, float shift, long long& c, double& s,
                                           double& ss, float& mn, float& mx) {
  const double d = (double)v - (double)shift;
  c += 1;
  s += d;
  ss += d * d;
  mn = fminf(mn, v);
  mx = fmaxf(mx, v);
}

__global__ void block_sketch_partial(const float* __restrict__ x, long long n, int F, int J,
                                     const float* __restrict__ lo,
                                     const float* __restrict__ inv_width, int bins,
                                     int hist_in_smem, double* __restrict__ pmom,
                                     float* __restrict__ pext, int* __restrict__ hist) {
  extern __shared__ unsigned char smem_raw[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  // shared layout: [lane count T x int64][lane sums T x double][lane sumsq T
  // x double][lane min T x float][lane max T x float][histogram F*bins int]
  long long* red_c = reinterpret_cast<long long*>(smem_raw);
  double* red_s = reinterpret_cast<double*>(red_c + T);
  double* red_ss = red_s + T;
  float* red_mn = reinterpret_cast<float*>(red_ss + T);
  float* red_mx = red_mn + T;
  int* shist = reinterpret_cast<int*>(red_mx + T);

  const int nh = F * bins;
  if (bins > 0 && hist_in_smem) {
    for (int i = t; i < nh; i += T) shist[i] = 0;
  }
  __syncthreads();

  const long long r0 = (long long)blockIdx.x * kRowsPerCta;
  const long long r1 = min(n, r0 + kRowsPerCta);
  const bool active = t < F * J;
  const int f = active ? t % F : 0;
  const int j = t / F;
  const float shift = r0 < n ? x[r0 * F + f] : 0.0f;

  long long c = 0;
  double s = 0.0, ss = 0.0;
  float mn = CUDART_INF_F, mx = -CUDART_INF_F;
  if (active) {
    const float lo_f = bins > 0 ? lo[f] : 0.0f;
    const float iw_f = bins > 0 ? inv_width[f] : 0.0f;
    int* h = (bins > 0) ? ((hist_in_smem ? shist : hist) + (long long)f * bins) : nullptr;
    long long r = r0 + j;
    for (; r + 3LL * J < r1; r += 4LL * J) {
      const float v0 = x[r * F + f];
      const float v1 = x[(r + J) * F + f];
      const float v2 = x[(r + 2LL * J) * F + f];
      const float v3 = x[(r + 3LL * J) * F + f];
      accumulate(v0, shift, c, s, ss, mn, mx);
      accumulate(v1, shift, c, s, ss, mn, mx);
      accumulate(v2, shift, c, s, ss, mn, mx);
      accumulate(v3, shift, c, s, ss, mn, mx);
      if (h != nullptr) {
        atomicAdd(h + repro_sketch::bin_of(v0, lo_f, iw_f, bins), 1);
        atomicAdd(h + repro_sketch::bin_of(v1, lo_f, iw_f, bins), 1);
        atomicAdd(h + repro_sketch::bin_of(v2, lo_f, iw_f, bins), 1);
        atomicAdd(h + repro_sketch::bin_of(v3, lo_f, iw_f, bins), 1);
      }
    }
    for (; r < r1; r += J) {
      const float v = x[r * F + f];
      accumulate(v, shift, c, s, ss, mn, mx);
      if (h != nullptr) atomicAdd(h + repro_sketch::bin_of(v, lo_f, iw_f, bins), 1);
    }
  }
  red_c[t] = c;
  red_s[t] = s;
  red_ss[t] = ss;
  red_mn[t] = mn;
  red_mx[t] = mx;
  __syncthreads();

  for (int q = t; q < F; q += T) {
    long long cc = 0;
    double sq = 0.0, ssq = 0.0;
    float mnq = CUDART_INF_F, mxq = -CUDART_INF_F;
    for (int jj = 0; jj < J; ++jj) {  // fixed order over the lanes of feature q
      const int lane = jj * F + q;
      cc += red_c[lane];
      sq += red_s[lane];
      ssq += red_ss[lane];
      mnq = fminf(mnq, red_mn[lane]);
      mxq = fmaxf(mxq, red_mx[lane]);
    }
    const float shift_q = r0 < n ? x[r0 * F + q] : 0.0f;
    double mean, m2;
    repro_sketch::shifted_to_moments((double)cc, sq, ssq, shift_q, mean, m2);
    const long long mb = (long long)blockIdx.x * 3 * F + q;
    const long long eb = (long long)blockIdx.x * 2 * F + q;
    pmom[mb] = (double)cc;
    pmom[mb + F] = mean;
    pmom[mb + 2 * F] = m2;
    pext[eb] = mnq;
    pext[eb + F] = mxq;
  }

  if (bins > 0 && hist_in_smem) {
    for (int i = t; i < nh; i += T) {
      const int v = shist[i];
      if (v != 0) atomicAdd(hist + i, v);
    }
  }
}

}  // namespace

extern "C" {

// Partial-sketch CTAs for a block of n rows (0 when n == 0 is passed as 1 CTA).
int block_sketch_num_ctas(long long n) {
  const long long c = (n + kRowsPerCta - 1) / kRowsPerCta;
  return (int)(c < 1 ? 1 : c);
}

// Shared memory the partial kernel needs for T threads (histogram included
// when hist_in_smem).
long long block_sketch_smem_bytes(int T, int F, int bins, int hist_in_smem) {
  long long b = (long long)T * (8 + 8 + 8 + 4 + 4);
  if (bins > 0 && hist_in_smem) b += (long long)F * bins * 4;
  return b;
}

// x [n, F] float32 row-major; lo / inv_width [F] float32 (ignored when
// bins == 0); scratch pmom [ctas, 3, F] double and pext [ctas, 2, F] float;
// outputs stats [5, F] float32 and hist [F, bins] int32 (zero-filled by the
// caller).  T = threads per CTA (a multiple of 32, >= F * J).  Returns
// cudaGetLastError() after both launches.
int block_sketch_launch(const void* x, long long n, int F, int J, int T, const void* lo,
                        const void* inv_width, int bins, int hist_in_smem, void* pmom,
                        void* pext, void* stats, void* hist, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int ctas = block_sketch_num_ctas(n);
  const size_t smem = (size_t)block_sketch_smem_bytes(T, F, bins, hist_in_smem);
  cudaError_t err = repro_sketch::allow_smem(block_sketch_partial, smem);
  if (err != cudaSuccess) return (int)err;
  block_sketch_partial<<<ctas, T, smem, st>>>(
      static_cast<const float*>(x), n, F, J, static_cast<const float*>(lo),
      static_cast<const float*>(inv_width), bins, hist_in_smem, static_cast<double*>(pmom),
      static_cast<float*>(pext), static_cast<int*>(hist));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)repro_sketch::launch_finalize(static_cast<const double*>(pmom),
                                            static_cast<const float*>(pext), ctas, 1, F,
                                            static_cast<float*>(stats), st);
}

}  // extern "C"
