// block_sketch: one pass over a [n, F] float32 block -> per-feature
// (count, mean, M2, min, max) and a fixed-grid histogram [F, bins], in one
// launch.
//
// Replaces the Pallas kernel block_sketch_pallas (_sketch_kernel) of
// src/repro/kernels/block_sketch/kernel.py.  On the TPU the grid walked row
// tiles in order and folded each into VMEM-resident outputs, with the
// histogram as a one-hot [T, F, B] compare; neither carries over.
//
// Bound on the H100: bytes.  The block is read once (n * F * 4 bytes, 12.76
// MB for the main path's 110,000 x 29 HIGGS block) and the outputs are a
// few KB, so the least time is the read at 3.35 TB/s (~3.8 us); the
// arithmetic is a few operations per element.
//
// Design:
//  1. One launch a call, in clusters of 8 CTAs (sketch_common.cuh): each CTA
//     leaves its per-feature totals and histogram in shared memory; the
//     cluster folds them through distributed shared memory, in rank order,
//     into one partial; the last cluster to take the ticket folds the
//     partials, in cluster order, writes stats, the int64 histogram and
//     nsel into the caller's packed output, and leaves the scratch clean.
//     No memset or cast runs around the kernel.  The fold order is fixed,
//     so repeated calls give the same bits.
//  2. Fewer, larger CTAs.  The grid is as many clusters as the card holds
//     at once (15 of 8 CTAs of 464 threads on the H100: 120 CTAs of 920
//     rows at the main path's shape, against 430 of 256 before; see
//     kernels/_sketch.py), each CTA
//     taking a contiguous range of rows that starts at a multiple of 4.  The
//     histogram counts with int32 atomics in shared memory, laid out
//     [bins][ceil32(F)] so that the lanes of a warp, which hold different
//     features, count in different banks; each cluster then adds its bins
//     into the global accumulator with one atomic per non-empty bin, 15
//     flushes instead of 430.  When it does not fit, the CTA counts straight
//     into global memory.
//  3. 16-byte loads.  A range of 4k rows starts 16-byte aligned (4 rows of
//     F floats are F float4s), and float4 number v of the range holds the
//     features (4v + i) mod F.  The CTA has T = F * J threads (J a power of
//     two), so thread t reads float4s t, t + T, t + 2T, ... -- neighbouring
//     threads on neighbouring 16 bytes, up to 16 loads in flight before any
//     is used (a thread's whole share at the main path's shape) -- and
//     always sees the same four features, whose accumulators stay in
//     registers.  A block whose data_ptr is not 16-byte aligned takes the
//     same walk with four scalar loads a float4: the same values in the
//     same order, so the same bits.  A ring of cp.async.bulk copies into
//     shared memory on mbarriers (16 KB a copy, every copy of a CTA issued
//     at its start) was measured against these register loads on the H100,
//     with and without the histogram, and was slower both times: each value
//     is used once, by the thread that loads it, so staging it buys nothing.
//  4. (plan_sketch only.)
//  5. Reach: F from 1 to 1024 (T = F for F > 512), any n < 2^31 (n = 0 gives
//     count 0, min +inf, max -inf), bins 0 (moments only) or any count.
//
// Threads t and t + kF hold the same four features.  The CTA folds their
// slots over k in a fixed tree (component-major in shared memory, no bank
// conflicts, every load of a step before its stores), then each feature
// sums its four (thread, component) slots.  A bin is one cvt.rmi and an
// integer clamp: conversions issue at an eighth of the FP32 rate.
//
// Where the time goes (H100, per-CTA %globaltimer stamps of the main path's
// call): about half in the walk, the histogram's shared-memory atomics and
// conversions a good part of it; the rest in the CTA's tree, the
// cluster's fold and the last cluster's ticket and fold -- a chain of
// dependent L2 round trips (fence and ticket, loads, stores).
#include "sketch_common.cuh"

namespace {

struct BlockArgs {
  const float* x;
  long long n;
  int F;
  int J;  // threads a feature: T = F * J
  long long rows_per_cta;
  int ctas;
  const float* lo;
  const float* inv_width;
  int bins;
  int hist_in_smem;
  int path;  // kVec4, or 0: scalar loads
  unsigned char* scratch;
  int ld;  // the most clusters a launch may have
  long long hist_bytes, work_bytes;  // shared-memory layout (block_smem)
  repro_sketch::Out out;
};

// A thread's four features: float4 component i of its loads is feature f[i].
struct Acc4 {
  double s[4], ss[4];
  float mn[4], mx[4];
  float shift[4], lo[4], iw[4];
  int at[4];   // where feature f[i]'s bin 0 is counted
  int step;    // ... and the stride from one bin to the next
  int* hist;
  int bins;

  __device__ __forceinline__ void take(float v, int i) {
    const double d = (double)v - (double)shift[i];
    s[i] += d;
    ss[i] += d * d;
    mn[i] = fminf(mn[i], v);
    mx[i] = fmaxf(mx[i], v);
    if (hist != nullptr) atomicAdd(hist + at[i] + step * repro_sketch::bin_of(v, lo[i], iw[i], bins), 1);
  }

  __device__ __forceinline__ void take4(const float4& q) {
    take(q.x, 0);
    take(q.y, 1);
    take(q.z, 2);
    take(q.w, 3);
  }
};

template <bool VEC>
__device__ __forceinline__ float4 load4(const float* base, long long v) {
  if (VEC) return __ldg(reinterpret_cast<const float4*>(base) + v);
  const float* p = base + 4 * v;
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

constexpr int kBatch = 16;  // float4 loads a thread has in flight
constexpr int kVec4 = 1;     // the path of a 16-byte aligned range (0: scalar loads)

// Float4s t, t + T, ... of the range, kBatch loads issued before any is used.
template <bool VEC>
__device__ __forceinline__ void walk(Acc4& acc, const float* base, long long nv, int T) {
  for (long long v = threadIdx.x; v < nv; v += (long long)kBatch * T) {
    float4 q[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (v + (long long)k * T < nv) q[k] = load4<VEC>(base, v + (long long)k * T);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (v + (long long)k * T < nv) acc.take4(q[k]);
    }
  }
}

template <int MAXT>
__global__ void __launch_bounds__(MAXT) block_sketch_fused(BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int flag;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int F = a.F;
  const int bins = a.bins;
  repro_sketch::Scratch sc;
  repro_sketch::scratch_layout(a.scratch, F, a.ld, bins, &sc);

  // the shared histogram is [bins][hcols]: the lanes of a warp hold
  // different features, so their counts fall in different banks
  int* shist = reinterpret_cast<int*>(smem);
  const bool smem_hist = bins > 0 && a.hist_in_smem;
  const int hcols = repro_sketch::hist_cols(F);
  if (smem_hist) {
    for (int i = t; i < hcols * bins; i += T) shist[i] = 0;
  }
  __syncthreads();

  const long long r0 = (long long)blockIdx.x * a.rows_per_cta;
  const long long r1 = min(a.n, r0 + a.rows_per_cta);
  const long long rows = r1 > r0 ? r1 - r0 : 0;
  const long long nf = rows * F;
  const long long nv = nf >> 2;
  const float* base = a.x + r0 * F;

  Acc4 acc;
  acc.hist = bins > 0 ? (smem_hist ? shist : sc.hist) : nullptr;
  acc.bins = bins;
  acc.step = smem_hist ? hcols : 1;   // global: the output's [F][bins]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = (4 * t + i) % F;
    acc.s[i] = 0.0;
    acc.ss[i] = 0.0;
    acc.mn[i] = CUDART_INF_F;
    acc.mx[i] = -CUDART_INF_F;
    acc.shift[i] = repro_sketch::shift_of(a.x, a.n, f);
    acc.lo[i] = bins > 0 ? __ldg(a.lo + f) : 0.0f;
    acc.iw[i] = bins > 0 ? __ldg(a.inv_width + f) : 0.0f;
    acc.at[i] = smem_hist ? f : f * bins;
  }
  if (a.path == kVec4) {
    walk<true>(acc, base, nv, T);
  } else {
    walk<false>(acc, base, nv, T);
  }
  // a range that ends at n may end inside a float4: its owner takes the rest
  const int rem = (int)(nf & 3);
  if (rem != 0 && t == (int)(nv % T)) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (i < rem) acc.take(__ldg(base + 4 * nv + i), i);
    }
  }
  __syncthreads();

  // Thread t + kF holds the same four features as thread t.  Slot [i][t]
  // (component-major: no bank conflicts) is folded over k in a fixed tree;
  // then feature f gathers its four (thread, component) slots 4p + i = f + mF
  // into the CTA's totals, which its cluster reads.
  unsigned char* work = smem + a.hist_bytes;  // the tree's slots, then the last fold
  double* rs = reinterpret_cast<double*>(work);
  double* rss = rs + 4 * T;
  float* rmn = reinterpret_cast<float*>(rss + 4 * T);
  float* rmx = rmn + 4 * T;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rs[i * T + t] = acc.s[i];
    rss[i * T + t] = acc.ss[i];
    rmn[i * T + t] = acc.mn[i];
    rmx[i * T + t] = acc.mx[i];
  }
  __syncthreads();
  for (int h = a.J / 2; h >= 1; h >>= 1) {
    for (int q = t; q < F * h; q += T) {
      double s0[4], s1[4], q0[4], q1[4];  // every load before any store
      float n0[4], n1[4], x0[4], x1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = i * T + q;
        const int o = d + F * h;
        s0[i] = rs[d];
        s1[i] = rs[o];
        q0[i] = rss[d];
        q1[i] = rss[o];
        n0[i] = rmn[d];
        n1[i] = rmn[o];
        x0[i] = rmx[d];
        x1[i] = rmx[o];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = i * T + q;
        rs[d] = s0[i] + s1[i];
        rss[d] = q0[i] + q1[i];
        rmn[d] = fminf(n0[i], n1[i]);
        rmx[d] = fmaxf(x0[i], x1[i]);
      }
    }
    __syncthreads();
  }
  const repro_sketch::Partials mine = repro_sketch::totals_at(work + a.work_bytes, F);
  for (int f = t; f < F; f += T) {
    double fs = 0.0, fss = 0.0;
    float fmn = CUDART_INF_F, fmx = -CUDART_INF_F;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int v = f + m * F;
      const int k = (v & 3) * T + (v >> 2);
      fs += rs[k];
      fss += rss[k];
      fmn = fminf(fmn, rmn[k]);
      fmx = fmaxf(fmx, rmx[k]);
    }
    mine.s[f] = fs;
    mine.ss[f] = fss;
    mine.mn[f] = fmn;
    mine.mx[f] = fmx;
    mine.cnt[f] = (int)rows;
  }
  if (t == 0) *mine.nsel = (int)rows;
  const float* x = a.x;
  const long long n = a.n;
  repro_sketch::finish(sc, a.ctas, F, F, bins, hcols, smem_hist ? shist : nullptr, mine, a.out,
                       work, &flag, [&](int q) { return repro_sketch::shift_of(x, n, q); });
}

// Dynamic shared memory: the histogram ([bins][ceil32(F)]), the work area
// (the tree's slots, later the last fold), the CTA's totals.
struct BlockSmem {
  long long hist, work, total;
};

BlockSmem block_smem(int T, int F, int bins, int hist_in_smem) {
  BlockSmem L;
  L.hist = (bins > 0 && hist_in_smem) ? repro_sketch::hist_smem_bytes(F, bins) : 0;
  L.work = repro_sketch::align16(4LL * T * (8 + 8 + 4 + 4));
  if (L.work < repro_sketch::kFoldSmemBytes) L.work = repro_sketch::kFoldSmemBytes;
  L.total = L.hist + L.work + repro_sketch::totals_bytes(F);
  return L;
}

template <typename Run>
cudaError_t with_kernel(int T, Run run) {
  return T <= 512 ? run(block_sketch_fused<512>) : run(block_sketch_fused<1024>);
}

}  // namespace

extern "C" {

// Bytes of the scratch a launch over `cols` columns needs when it may have
// up to ld clusters (the clusters' partials, the ticket, the int32
// histogram accumulator).  The caller zeroes it once; launches leave it so.
long long sketch_scratch_bytes(int cols, int ld, int bins) {
  repro_sketch::Scratch sc;
  return repro_sketch::scratch_layout(nullptr, cols, ld, bins, &sc);
}

// Dynamic shared memory of a launch with T threads.
long long block_sketch_smem_bytes(int T, int F, int bins, int hist_in_smem) {
  return block_smem(T, F, bins, hist_in_smem).total;
}

// Clusters of kCluster CTAs of T threads the card holds at once (negative:
// a CUDA error).
int block_sketch_max_clusters(int T, int F, int bins, int hist_in_smem) {
  const size_t smem = (size_t)block_smem(T, F, bins, hist_in_smem).total;
  int n = 0;
  const cudaError_t err = with_kernel(T, [&](auto kernel) {
    const cudaError_t e = repro_sketch::allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    n = repro_sketch::max_clusters(kernel, T, smem);
    return cudaSuccess;
  });
  return err == cudaSuccess ? n : -(int)err;
}

// x [n, F] float32 row-major; lo / inv_width [F] float32 (ignored when
// bins == 0).  ctas CTAs (a multiple of kCluster, at most kCluster * ld)
// of T = F * J threads (J a power of two), CTA c taking rows
// [c * rows_per_cta, min(n, (c + 1) * rows_per_cta)), with rows_per_cta a
// multiple of 4.  path: kVec4 (x 16-byte aligned) or 0 (scalar loads).
// scratch: the
// sketch_scratch_bytes(F, ld, bins) buffer.  Writes stats [5, F] float32,
// hist [F, bins] int64 and nsel (= n) int64.  Returns the launch's error.
int block_sketch_launch(const void* x, long long n, int F, int J, long long rows_per_cta, int ctas,
                        const void* lo, const void* inv_width, int bins, int hist_in_smem, int path,
                        void* scratch, int ld, void* stats, void* hist, void* nsel, void* stream) {
  const int T = F * J;
  const BlockSmem L = block_smem(T, F, bins, hist_in_smem);
  BlockArgs a;
  a.x = static_cast<const float*>(x);
  a.n = n;
  a.F = F;
  a.J = J;
  a.rows_per_cta = rows_per_cta;
  a.ctas = ctas;
  a.lo = static_cast<const float*>(lo);
  a.inv_width = static_cast<const float*>(inv_width);
  a.bins = bins;
  a.hist_in_smem = hist_in_smem;
  a.path = path;
  a.scratch = static_cast<unsigned char*>(scratch);
  a.ld = ld;
  a.hist_bytes = L.hist;
  a.work_bytes = L.work;
  a.out.stats = static_cast<float*>(stats);
  a.out.hist = static_cast<long long*>(hist);
  a.out.nsel = static_cast<long long*>(nsel);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err = with_kernel(T, [&](auto kernel) {
    const cudaError_t e = repro_sketch::allow_smem(kernel, (size_t)L.total);
    if (e != cudaSuccess) return e;
    return repro_sketch::launch_clusters(kernel, ctas, T, (size_t)L.total, st, a);
  });
  return (int)err;
}

}  // extern "C"
