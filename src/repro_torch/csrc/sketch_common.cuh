// Shared pieces of the block_sketch and plan_sketch kernels: the binning
// rule, the scratch layout, asynchronous copies, and the fold that ends
// every launch.
//
// One launch a call, in clusters of kCluster CTAs.  Each CTA sketches a
// contiguous row range into shared memory: one total per column -- (count,
// shifted sum, shifted sum of squares) in int and double, (min, max) in
// float -- and its histogram.  After a cluster barrier, CTA rank r of a
// cluster folds its share of the columns and of the histogram bins across
// the cluster's CTAs, in rank order, reading their shared memory directly
// (distributed shared memory); it writes the cluster's partial for those
// columns to scratch and adds the bins into the int32 accumulator with one
// integer atomic per non-empty bin.  A second cluster barrier ends the
// remote reads.  The clusters then arrive at one ticket; the last to arrive
// folds the cluster partials, in cluster order, and writes the packed
// output: stats, the histogram widened to int64, and nsel.  It zeroes the
// accumulator and resets the ticket, so the scratch is clean for the next
// launch on the stream.  The order of every floating-point sum is a fixed
// function of the launch geometry, so repeated calls give the same bits.
// No float atomics are used anywhere.
//
// Every column is shifted by its own value in row 0 of the block (0 when
// that is not finite), the same shift in every CTA, so partial sums add
// without a division and the last fold turns them into (mean, M2) once.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace repro_sketch {

namespace cg = cooperative_groups;

constexpr int kCluster = 8;      // CTAs a cluster: the portable maximum
constexpr int kMaxEntries = 32;  // clusters a launch may have: entries of the last fold
constexpr int kFoldCols = 64;    // columns the last fold stages in shared memory at once
constexpr int kFoldStride = kFoldCols + 1;  // padded: the loads' stores miss no bank twice
constexpr int kFoldTeam = 8;     // threads that fold one column, in a fixed shuffle tree
constexpr int kFoldSmemBytes = kFoldStride * kMaxEntries * (8 + 8 + 4 + 4 + 4);

__host__ __device__ inline long long align16(long long b) { return (b + 15) / 16 * 16; }

// A CTA's shared histogram is [bins][hist_cols(cols)], column-minor: the
// lanes of a warp count different columns, which then fall in different
// banks.
__host__ __device__ inline int hist_cols(int cols) { return (cols + 31) / 32 * 32; }

__host__ __device__ inline long long hist_smem_bytes(int cols, int bins) {
  return align16(4LL * hist_cols(cols) * bins);
}

// clip(floor((x - lo) * inv_width), 0, bins - 1), in float32 exactly as the
// reference's jit and Pallas paths compute it: round-to-nearest subtract,
// then multiply (no fused multiply-add).  NaN lands in bin 0.
// The floor and the integer conversion are one cvt.rmi (NaN converts to
// 0, +-inf and out-of-range values saturate), then clamped as integers.
__device__ __forceinline__ int bin_of(float x, float lo, float inv_width, int bins) {
  const int f = __float2int_rd(__fmul_rn(__fsub_rn(x, lo), inv_width));
  return min(max(f, 0), bins - 1);
}

// A column's shift: its value in row 0, or 0 when the block is empty or
// that value is not finite.
__device__ __forceinline__ float shift_of(const float* x, long long n, int col) {
  if (n <= 0) return 0.0f;
  const float v = __ldg(x + col);
  return isfinite(v) ? v : 0.0f;
}

// Per-column totals, structure of arrays.  In shared memory: a CTA's totals,
// which its cluster reads (nsel: one int).  In scratch: the clusters'
// partials, column-major, entry e of column q at q * ld + e (nsel: [ld]).
struct Partials {
  double* s;
  double* ss;
  float* mn;
  float* mx;
  int* cnt;
  int* nsel;
  int ld;
};

__host__ __device__ inline long long totals_bytes(int cols) { return align16(28LL * cols + 4); }

__device__ inline Partials totals_at(unsigned char* base, int cols) {
  Partials p;
  p.s = reinterpret_cast<double*>(base);
  p.ss = p.s + cols;
  p.mn = reinterpret_cast<float*>(p.ss + cols);
  p.mx = p.mn + cols;
  p.cnt = reinterpret_cast<int*>(p.mx + cols);
  p.nsel = p.cnt + cols;
  p.ld = 1;
  return p;
}

struct Scratch {
  Partials clusters;  // one entry a cluster (ld = the most clusters a launch may have)
  int* ticket;
  int* hist;          // [cols * bins] int32 accumulator
};

__host__ __device__ inline unsigned char* carve(unsigned char* base, long long& off, long long bytes) {
  unsigned char* p = base != nullptr ? base + off : nullptr;
  off += align16(bytes);
  return p;
}

// Lays the scratch buffer out at base (nullptr: sizes only); returns its bytes.
__host__ __device__ inline long long scratch_layout(unsigned char* base, int cols, int ld, int bins,
                                                    Scratch* sc) {
  long long off = 0;
  const long long m = (long long)cols * ld;
  Partials& p = sc->clusters;
  p.ld = ld;
  p.s = reinterpret_cast<double*>(carve(base, off, 8 * m));
  p.ss = reinterpret_cast<double*>(carve(base, off, 8 * m));
  p.mn = reinterpret_cast<float*>(carve(base, off, 4 * m));
  p.mx = reinterpret_cast<float*>(carve(base, off, 4 * m));
  p.cnt = reinterpret_cast<int*>(carve(base, off, 4 * m));
  p.nsel = reinterpret_cast<int*>(carve(base, off, 4LL * ld));
  sc->ticket = reinterpret_cast<int*>(carve(base, off, 4));
  sc->hist = reinterpret_cast<int*>(carve(base, off, 4LL * cols * (bins > 0 ? bins : 0)));
  return off;
}

// The packed output a launch writes: stats [groups * 5, fp] float32, rows
// 5g..5g+4 (count, mean, M2, min, max); hist [cols, bins] int64; nsel.
struct Out {
  float* stats;
  long long* hist;
  long long* nsel;
};

struct Totals {
  long long cnt;
  double s, ss;
  float mn, mx;
};

// Folds entries [0, E) (E <= kMaxEntries) of every column of p and hands
// column q's totals to emit(q, totals); *nsel (thread 0) gets the sum of
// p.nsel[0, E).  Every thread of the CTA calls it; smem holds
// kFoldSmemBytes.  All threads load a chunk of columns into shared memory
// at once; then a team of kFoldTeam lanes takes a column, lane l summing
// entries l, l + kFoldTeam, ... in order, and the team meets in a fixed
// shuffle tree -- the same order on every run.
template <typename Emit>
__device__ void fold(const Partials& p, int E, int cols, unsigned char* smem, Emit emit,
                     long long* nsel) {
  const int T = blockDim.x;
  const int t = threadIdx.x;
  constexpr int kSlots = kFoldStride * kMaxEntries;
  double* fs = reinterpret_cast<double*>(smem);
  double* fss = fs + kSlots;
  float* fmn = reinterpret_cast<float*>(fss + kSlots);
  float* fmx = fmn + kSlots;
  int* fc = reinterpret_cast<int*>(fmx + kSlots);
  for (int q0 = 0; q0 < cols; q0 += kFoldCols) {
    const int ch = min(kFoldCols, cols - q0);
#pragma unroll 4
    for (int i = t; i < ch * E; i += T) {  // consecutive threads: consecutive entries
      const int qq = i / E;
      const int e = i - qq * E;
      const long long g = (long long)(q0 + qq) * p.ld + e;
      const int k = e * kFoldStride + qq;
      fs[k] = __ldcg(p.s + g);
      fss[k] = __ldcg(p.ss + g);
      fmn[k] = __ldcg(p.mn + g);
      fmx[k] = __ldcg(p.mx + g);
      fc[k] = __ldcg(p.cnt + g);
    }
    if (q0 == 0 && t < 32) {
      long long x = t < E ? (long long)__ldcg(p.nsel + t) : 0LL;
      for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
      if (t == 0) *nsel = x;
    }
    __syncthreads();
    // whole warps only, so every shuffle has its full warp
    const int lane = t & 31;
    const int l = lane % kFoldTeam;
    const int warps = T >> 5;
    const int first = (t >> 5) < warps ? (t >> 5) * (32 / kFoldTeam) : ch;
    for (int qb = first; qb < ch; qb += warps * (32 / kFoldTeam)) {
      const int qq = qb + lane / kFoldTeam;
      Totals tot{0, 0.0, 0.0, CUDART_INF_F, -CUDART_INF_F};
      if (qq < ch) {
        for (int e = l; e < E; e += kFoldTeam) {
          const int k = e * kFoldStride + qq;
          tot.cnt += fc[k];
          tot.s += fs[k];
          tot.ss += fss[k];
          tot.mn = fminf(tot.mn, fmn[k]);
          tot.mx = fmaxf(tot.mx, fmx[k]);
        }
      }
      for (int off = kFoldTeam / 2; off > 0; off >>= 1) {
        tot.cnt += __shfl_down_sync(0xffffffffu, tot.cnt, off, kFoldTeam);
        tot.s += __shfl_down_sync(0xffffffffu, tot.s, off, kFoldTeam);
        tot.ss += __shfl_down_sync(0xffffffffu, tot.ss, off, kFoldTeam);
        tot.mn = fminf(tot.mn, __shfl_down_sync(0xffffffffu, tot.mn, off, kFoldTeam));
        tot.mx = fmaxf(tot.mx, __shfl_down_sync(0xffffffffu, tot.mx, off, kFoldTeam));
      }
      if (l == 0 && qq < ch) emit(q0 + qq, tot);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void fence_acq_rel() { asm volatile("fence.acq_rel.gpu;\n" ::: "memory"); }

// The end of every launch.  The CTA has its per-column totals in shared
// memory (`mine`, nsel included) and its histogram in shist ([bins][hcols];
// nullptr when the CTA counted straight into sc.hist).  Columns run
// q = g * fp + p; shift(q) is column q's shift; fold_smem (kFoldSmemBytes)
// may alias anything but `mine` and shist.
template <typename Shift>
__device__ void finish(const Scratch& sc, int ctas, int cols, int fp, int bins, int hcols,
                       const int* shist, const Partials& mine, const Out& out,
                       unsigned char* fold_smem, int* flag, Shift shift) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cl = blockIdx.x / kCluster;
  const int t = threadIdx.x;
  const Partials& pc = sc.clusters;
  cluster.sync();  // every CTA of the cluster has its totals and histogram in place

  // this rank's columns, each summed over the cluster in rank order (a
  // peer's address is mapped where it is read: few registers stay live)
  const int per = (cols + kCluster - 1) / kCluster;
  const int q1 = min(cols, (rank + 1) * per);
  for (int q = rank * per + t; q < q1; q += blockDim.x) {
    Totals tot{0, 0.0, 0.0, CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int k = 0; k < kCluster; ++k) {
      tot.cnt += *cluster.map_shared_rank(mine.cnt + q, k);
      tot.s += *cluster.map_shared_rank(mine.s + q, k);
      tot.ss += *cluster.map_shared_rank(mine.ss + q, k);
      tot.mn = fminf(tot.mn, *cluster.map_shared_rank(mine.mn + q, k));
      tot.mx = fmaxf(tot.mx, *cluster.map_shared_rank(mine.mx + q, k));
    }
    const long long i = (long long)q * pc.ld + cl;
    pc.s[i] = tot.s;
    pc.ss[i] = tot.ss;
    pc.mn[i] = tot.mn;
    pc.mx[i] = tot.mx;
    pc.cnt[i] = (int)tot.cnt;
  }
  if (rank == 0 && t == 0) {
    int nsel = 0;
#pragma unroll
    for (int k = 0; k < kCluster; ++k) nsel += *cluster.map_shared_rank(mine.nsel, k);
    pc.nsel[cl] = nsel;
  }
  // this rank's bins, each summed over the cluster: one atomic a non-empty
  // bin.  Neighbouring threads read neighbouring shared-memory words.
  if (shist != nullptr) {
    const int nh = hcols * bins;
    const int hper = (nh + kCluster - 1) / kCluster;
    const int h1 = min(nh, (rank + 1) * hper);
    for (int at = rank * hper + t; at < h1; at += blockDim.x) {
      const int b = at / hcols;
      const int q = at - b * hcols;
      if (q >= cols) continue;
      int c = 0;
#pragma unroll
      for (int k = 0; k < kCluster; ++k) c += *cluster.map_shared_rank(shist + at, k);
      if (c != 0) atomicAdd(sc.hist + (long long)q * bins + b, c);
    }
  }
  __syncthreads();
  if (t == 0) fence_acq_rel();  // the CTA's writes, before its cluster's ticket
  cluster.sync();               // no CTA leaves while its cluster still reads it
  if (rank != 0) return;

  __syncthreads();
  if (t == 0) {
    fence_acq_rel();
    const bool last = atomicAdd(sc.ticket, 1) == ctas / kCluster - 1;
    if (last) fence_acq_rel();
    *flag = last;
  }
  __syncthreads();
  if (*flag == 0) return;

  long long nsel = 0;
  fold(pc, ctas / kCluster, cols, fold_smem, [&](int q, const Totals& tot) {
    const int g = q / fp;
    float* st = out.stats + 5LL * g * fp + (q - g * fp);
    double mean = 0.0, m2 = 0.0;
    if (tot.cnt > 0) {
      const double ms = tot.s / (double)tot.cnt;
      mean = (double)shift(q) + ms;
      m2 = tot.ss - tot.s * ms;
      if (m2 < 0.0) m2 = 0.0;
    }
    st[0] = (float)tot.cnt;
    st[fp] = (float)mean;
    st[2 * fp] = (float)m2;
    st[3 * fp] = tot.mn;
    st[4 * fp] = tot.mx;
  }, &nsel);
  if (t == 0) {
    *out.nsel = nsel;
    *sc.ticket = 0;
  }
  // the histogram: int32 accumulator -> int64 output, leaving zeros behind
  const long long nh = (long long)cols * (bins > 0 ? bins : 0);
  const long long nq = nh >> 2;  // the accumulator is 16-byte aligned
  int4* acc4 = reinterpret_cast<int4*>(sc.hist);
#pragma unroll 4
  for (long long i = t; i < nq; i += blockDim.x) {
    const int4 v = __ldcg(acc4 + i);
    acc4[i] = make_int4(0, 0, 0, 0);
    out.hist[4 * i] = v.x;
    out.hist[4 * i + 1] = v.y;
    out.hist[4 * i + 2] = v.z;
    out.hist[4 * i + 3] = v.w;
  }
  for (long long i = 4 * nq + t; i < nh; i += blockDim.x) {
    out.hist[i] = __ldcg(sc.hist + i);
    sc.hist[i] = 0;
  }
}

// Launches `kernel` over `ctas` CTAs (a multiple of kCluster) in clusters
// of kCluster.
template <typename Kernel, typename Args>
inline cudaError_t launch_clusters(Kernel kernel, int ctas, int threads, size_t smem,
                                   cudaStream_t stream, const Args& args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args);
}

// Clusters of `kernel` the card can hold at once (negative: a CUDA error).
template <typename Kernel>
inline int max_clusters(Kernel kernel, int threads, size_t smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * kMaxEntries, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// Asynchronous global -> shared copies (cp.async; sm_80 and later).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Raise the dynamic shared-memory ceiling of a kernel when it may need
// more than the default 48 KB with its static shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 46 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace repro_sketch
