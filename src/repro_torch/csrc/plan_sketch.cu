// plan_sketch: the block_sketch fold behind a conjunctive predicate mask, a
// column projection and a group-by on a float label column, in one pass
// over a [n, F] float32 block.
//
// Replaces the Pallas kernel plan_sketch_pallas (_plan_kernel) of
// src/repro/kernels/plan/kernel.py.  The TPU version projected with a
// one-hot matmul on the MXU and histogrammed with a one-hot compare; here the
// projection is a column gather and the histogram counts with int32 atomics.
//
// Bound on the H100: bytes.  Every row has to be visited (the predicate
// columns decide which rows count), but only the 32-byte sectors that hold
// the plan's predicate, projected and group columns need be read.  A plan
// over all 29 columns reads the whole 110,000 x 29 block, 12.76 MB, ~3.8 us
// at 3.35 TB/s; the main path's where=/columns= plan (columns 0 and 28,
// adjacent bytes across neighbouring 116-byte rows) needs about a third of
// that.  Outputs are a few KB.  This kernel stages whole rows, so it reads
// every sector whatever the plan.
//
// Design:
//  * Each CTA stages a tile of up to 256 rows into shared memory with
//    coalesced loads (the tile is contiguous in the row-major block).
//  * One thread per row evaluates the predicates (lt/le/gt/ge/eq/ne against
//    float32 constants, passed as small device arrays) and the row's group:
//    the label is truncated toward zero, as the reference's numpy and jit
//    paths do, and a label outside [0, G) leaves the row in no group.
//    Every row that passes the predicates counts toward nsel, whatever its
//    label (an int32 shared counter, then one global atomic per CTA).
//  * Thread t < Fp*J owns projected feature p = t % Fp and tile rows
//    j, j+J, ...; it keeps count, shifted sum and shifted sum of squares in
//    double, and min/max, per group in its own shared-memory slots, so no
//    two threads ever update the same accumulator.
//  * The CTA writes one partial per (group, feature); sketch_finalize
//    Chan-combines them in a fixed order.  Histograms count with int32
//    atomics in shared memory when G*Fp*bins*4 bytes fit, else in global.
#include "sketch_common.cuh"

namespace {

__device__ __forceinline__ bool compare(float v, int op, float c) {
  switch (op) {
    case 0: return v < c;
    case 1: return v <= c;
    case 2: return v > c;
    case 3: return v >= c;
    case 4: return v == c;
    default: return v != c;
  }
}

struct PlanArgs {
  const float* x;
  long long n;
  int F;
  int tile_rows;
  int npred;
  const int* pcol;
  const int* pop;
  const float* pval;
  const int* cols;
  int Fp;
  int J;
  int gcol;  // -1: ungrouped
  int G;
  const float* lo;
  const float* inv_width;
  int bins;
  int hist_in_smem;
  double* pmom;
  float* pext;
  int* hist;
  int* nsel;
};

__global__ void plan_sketch_partial(PlanArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int F = a.F;
  const int Fp = a.Fp;
  const int G = a.G;
  const int TR = a.tile_rows;
  const int slots = G * T;
  // shared layout (8-byte members first):
  //   acc_c [G][T] int64, acc_s [G][T] double, acc_ss [G][T] double,
  //   acc_mn [G][T] float, acc_mx [G][T] float, tile [TR][F] float,
  //   grp [TR] int, nsel (1 int, padded to 4), histogram [G][Fp][bins] int
  long long* acc_c = reinterpret_cast<long long*>(smem_raw);
  double* acc_s = reinterpret_cast<double*>(acc_c + slots);
  double* acc_ss = acc_s + slots;
  float* acc_mn = reinterpret_cast<float*>(acc_ss + slots);
  float* acc_mx = acc_mn + slots;
  float* tile = acc_mx + slots;
  int* grp = reinterpret_cast<int*>(tile + (long long)TR * F);
  int* cta_nsel = grp + TR;
  int* shist = cta_nsel + 4;

  const int nh = G * Fp * a.bins;
  for (int i = t; i < slots; i += T) {
    acc_c[i] = 0;
    acc_s[i] = 0.0;
    acc_ss[i] = 0.0;
    acc_mn[i] = CUDART_INF_F;
    acc_mx[i] = -CUDART_INF_F;
  }
  if (a.bins > 0 && a.hist_in_smem) {
    for (int i = t; i < nh; i += T) shist[i] = 0;
  }
  if (t == 0) *cta_nsel = 0;

  const long long r0 = (long long)blockIdx.x * TR;
  const int rows = (int)min((long long)TR, a.n - r0);
  const long long words = (long long)rows * F;
  const float* src = a.x + r0 * F;
#pragma unroll 4
  for (long long i = t; i < words; i += T) tile[i] = src[i];
  __syncthreads();

  // row pass: predicate mask, group, nsel
  int mine = 0;
  for (int r = t; r < rows; r += T) {
    const float* row = tile + (long long)r * F;
    bool ok = true;
    for (int p = 0; p < a.npred; ++p) ok = ok && compare(row[a.pcol[p]], a.pop[p], a.pval[p]);
    int g = -1;
    if (ok) {
      mine += 1;
      if (a.gcol < 0) {
        g = 0;
      } else {
        const float lab = row[a.gcol];
        // truncation toward zero keeps (-1, G) -> [0, G); NaN fails both tests
        if (lab > -1.0f && lab < (float)G) g = (int)lab;
      }
    }
    grp[r] = g;
  }
  if (mine) atomicAdd(cta_nsel, mine);
  __syncthreads();

  // column pass: grouped moments and histograms of the projected features
  const bool active = t < Fp * a.J;
  const int p = active ? t % Fp : 0;
  const int j = t / Fp;
  const int col = a.cols[p];
  const float shift = rows > 0 ? tile[col] : 0.0f;
  if (active) {
    const float lo_p = a.bins > 0 ? a.lo[p] : 0.0f;
    const float iw_p = a.bins > 0 ? a.inv_width[p] : 0.0f;
    int* hbase = a.hist_in_smem ? shist : a.hist;
    for (int r = j; r < rows; r += a.J) {
      const int g = grp[r];
      if (g < 0) continue;
      const float v = tile[(long long)r * F + col];
      const int slot = g * T + t;
      const double d = (double)v - (double)shift;
      acc_c[slot] += 1;
      acc_s[slot] += d;
      acc_ss[slot] += d * d;
      acc_mn[slot] = fminf(acc_mn[slot], v);
      acc_mx[slot] = fmaxf(acc_mx[slot], v);
      if (a.bins > 0) {
        atomicAdd(hbase + ((long long)g * Fp + p) * a.bins +
                      repro_sketch::bin_of(v, lo_p, iw_p, a.bins),
                  1);
      }
    }
  }
  __syncthreads();

  for (int q = t; q < G * Fp; q += T) {  // one (group, feature) column per thread
    const int g = q / Fp;
    const int pq = q - g * Fp;
    long long cc = 0;
    double sq = 0.0, ssq = 0.0;
    float mnq = CUDART_INF_F, mxq = -CUDART_INF_F;
    for (int jj = 0; jj < a.J; ++jj) {  // fixed order over the lanes
      const int slot = g * T + jj * Fp + pq;
      cc += acc_c[slot];
      sq += acc_s[slot];
      ssq += acc_ss[slot];
      mnq = fminf(mnq, acc_mn[slot]);
      mxq = fmaxf(mxq, acc_mx[slot]);
    }
    const float shift_q = rows > 0 ? tile[a.cols[pq]] : 0.0f;
    double mean, m2;
    repro_sketch::shifted_to_moments((double)cc, sq, ssq, shift_q, mean, m2);
    const long long mb = ((long long)blockIdx.x * G + g) * 3 * Fp + pq;
    const long long eb = ((long long)blockIdx.x * G + g) * 2 * Fp + pq;
    a.pmom[mb] = (double)cc;
    a.pmom[mb + Fp] = mean;
    a.pmom[mb + 2 * Fp] = m2;
    a.pext[eb] = mnq;
    a.pext[eb + Fp] = mxq;
  }
  if (t == 0 && *cta_nsel) atomicAdd(a.nsel, *cta_nsel);
  if (a.bins > 0 && a.hist_in_smem) {
    for (int i = t; i < nh; i += T) {
      const int v = shist[i];
      if (v != 0) atomicAdd(a.hist + i, v);
    }
  }
}

}  // namespace

extern "C" {

int plan_sketch_num_ctas(long long n, int tile_rows) {
  const long long c = (n + tile_rows - 1) / tile_rows;
  return (int)(c < 1 ? 1 : c);
}

long long plan_sketch_smem_bytes(int T, int F, int tile_rows, int Fp, int G, int bins,
                                 int hist_in_smem) {
  long long b = (long long)G * T * (8 + 8 + 8 + 4 + 4);
  b += (long long)tile_rows * F * 4 + (long long)tile_rows * 4 + 16;
  if (bins > 0 && hist_in_smem) b += (long long)G * Fp * bins * 4;
  return b;
}

// x [n, F] float32 row-major.  Predicates: pcol / pop int32 [npred], pval
// float32 [npred] (the wrapper caps npred).  cols int32 [Fp]
// projected column indices in [0, F).  gcol: label column in [0, F), or -1
// for an ungrouped plan (then G must be 1).  lo / inv_width [Fp] float32
// (ignored when bins == 0).  Scratch pmom [ctas, G, 3, Fp] double and pext
// [ctas, G, 2, Fp] float.  Outputs: stats [G*5, Fp] float32, hist
// [G*Fp, bins] int32 and nsel [1] int32, both zero-filled by the caller.
// Returns cudaGetLastError() after both launches.
int plan_sketch_launch(const void* x, long long n, int F, int tile_rows, int T, int J,
                       int npred, const void* pcol, const void* pop, const void* pval,
                       const void* cols, int Fp, int gcol, int G, const void* lo,
                       const void* inv_width, int bins, int hist_in_smem, void* pmom,
                       void* pext, void* stats, void* hist, void* nsel, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  PlanArgs a;
  a.x = static_cast<const float*>(x);
  a.n = n;
  a.F = F;
  a.tile_rows = tile_rows;
  a.npred = npred;
  a.pcol = static_cast<const int*>(pcol);
  a.pop = static_cast<const int*>(pop);
  a.pval = static_cast<const float*>(pval);
  a.cols = static_cast<const int*>(cols);
  a.Fp = Fp;
  a.J = J;
  a.gcol = gcol;
  a.G = G;
  a.lo = static_cast<const float*>(lo);
  a.inv_width = static_cast<const float*>(inv_width);
  a.bins = bins;
  a.hist_in_smem = hist_in_smem;
  a.pmom = static_cast<double*>(pmom);
  a.pext = static_cast<float*>(pext);
  a.hist = static_cast<int*>(hist);
  a.nsel = static_cast<int*>(nsel);
  const int ctas = plan_sketch_num_ctas(n, tile_rows);
  const size_t smem =
      (size_t)plan_sketch_smem_bytes(T, F, tile_rows, Fp, G, bins, hist_in_smem);
  cudaError_t err = repro_sketch::allow_smem(plan_sketch_partial, smem);
  if (err != cudaSuccess) return (int)err;
  plan_sketch_partial<<<ctas, T, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)repro_sketch::launch_finalize(static_cast<const double*>(pmom),
                                            static_cast<const float*>(pext), ctas, G, Fp,
                                            static_cast<float*>(stats), st);
}

}  // extern "C"
