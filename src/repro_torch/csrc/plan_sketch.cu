// plan_sketch: the block_sketch fold behind a conjunctive predicate mask, a
// column projection and a group-by on a float label column, in one pass
// over a [n, F] float32 block and one launch.
//
// Replaces the Pallas kernel plan_sketch_pallas (_plan_kernel) of
// src/repro/kernels/plan/kernel.py.  The TPU version projected with a
// one-hot matmul on the MXU and histogrammed with a one-hot compare; here the
// projection is a column gather and the histogram counts with int32 atomics.
//
// Bound on the H100: bytes.  Every row has to be visited (the predicate
// columns decide which rows count), but only the 32-byte sectors that hold
// the plan's predicate, projected and group columns need be read.  The main
// path's per-class plan (group_by c28, all 29 columns) reads the whole
// 110,000 x 29 block, 12.76 MB, ~3.8 us at 3.35 TB/s; its where=/columns=
// plan (c0 > 0.5, columns 0 and 28: adjacent bytes across neighbouring
// 116-byte rows) touches 9 of every 29 sectors, 3.96 MB, ~1.2 us.  Outputs
// are a few KB.
//
// Design:
//  1. One launch a call: the cluster fold and the last cluster's fold of
//     sketch_common.cuh write stats, the int64 histogram and nsel into the
//     packed output and leave the scratch clean; the fold order is fixed.
//  2. Fewer, larger CTAs: the grid is as many clusters of 8 as the card
//     holds at once (two CTAs an SM on the H100 at the main path's plans:
//     30 clusters of 464 threads for query (c)'s, 32 of 128 for query (b)'s);
//     each CTA walks its contiguous row range
//     (starting at a multiple of 4 rows) in tiles of up to 128 rows and
//     8 KB, through a ring of four tiles in shared memory filled with
//     cp.async, so three tiles' loads fly while one is folded.  A cluster
//     adds its histogram bins into the global accumulator once.
//  3. 16-byte loads on the whole-row path: a tile starts at a multiple of
//     4 rows, so a 16-byte aligned block is staged with 16-byte cp.async;
//     an unaligned one with 4-byte copies of the same values.
//  4. Column reads for narrow plans: when the sectors of the touched
//     columns are under half the block's (kernels/plan/kernel.py:read_path),
//     the tile holds only those columns, each element fetched straight from
//     global memory with a 4-byte cp.async -- the reads touch only their
//     sectors.  Otherwise the tile holds whole rows.
//     One thread a row evaluates the predicates (lt/le/gt/ge/eq/ne) and the
//     row's group: the label truncated toward zero, a label outside [0, G)
//     joining no group; every row that passes counts toward nsel, whatever
//     its label.  Thread t < Fp*J then owns projected feature t % Fp and
//     rows j, j+J, ... (j = t / Fp) of the tile, four rows in flight, and
//     keeps count, shifted sum and shifted sum of squares in double and
//     min/max per group in registers for G <= 4 (larger G: per-thread
//     shared-memory slots).  The J lanes of a (group, feature) meet in a
//     fixed tree.  The shared histogram is [bins][ceil32(G*Fp)]: the lanes
//     of a warp count different columns, in different banks.
//  5. Reach: F up to 8192 and Fp from 1 to 1024, any n < 2^31 (n = 0 gives
//     count 0, min +inf, max -inf), bins 0 or any count (the histogram in
//     global memory when it does not fit shared memory), up to
//     MAX_PREDICATES predicates.
//
// Where the time goes (H100, per-CTA %globaltimer stamps): about half in
// the tile loop (query (c)'s column pass waits on latency -- a barrier
// three times a tile; query (b)'s gathers wait on memory), the rest in the
// folds, as in block_sketch.  Measured there too: query (b)'s plan reads
// faster gathered than staged, query (c)'s faster with 464 threads a CTA
// than 232, and hints to prefetch 256 bytes into L2 changed nothing.
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
  long long rows_per_cta;
  int ctas;
  int tile_rows;
  int Ft;      // tile width: F (whole rows) or the touched columns
  int gather;  // the tile holds only the touched columns
  int vec;     // whole rows with 16-byte copies
  int npred;
  const int* pcol;    // [npred] tile columns
  const int* pop;     // [npred]
  const float* pval;  // [npred]
  int Fp;
  int J;
  const int* cols;   // [Fp] tile columns of the projected features
  const int* bcols;  // [Fp] their block columns
  const int* src;    // [Ft] the block column of each tile column (gather)
  int gcol;          // tile column of the label, -1: ungrouped
  int G;
  const float* lo;
  const float* inv_width;
  int bins;
  int hist_in_smem;
  unsigned char* scratch;
  int ld;  // the most clusters a launch may have
  repro_sketch::Out out;
};

// Per-slot accumulators, structure of arrays: count, shifted sum and sum of
// squares, min, max.
struct Slots {
  double* s;
  double* ss;
  float* mn;
  float* mx;
  int* cnt;
};

using repro_sketch::align16;

__device__ inline Slots slots_at(unsigned char* base, int count) {
  Slots sl;
  sl.s = reinterpret_cast<double*>(base);
  sl.ss = sl.s + count;
  sl.mn = reinterpret_cast<float*>(sl.ss + count);
  sl.mx = sl.mn + count;
  sl.cnt = reinterpret_cast<int*>(sl.mx + count);
  return sl;
}

// Dynamic shared memory: a union of (the ring of tiles + the rows' groups),
// the combine slots and the last fold, then the persistent parts: slots for
// G > 4, the histogram ([bins][hist_cols(G * Fp)]), the CTA's nsel, and the
// CTA's totals, which its cluster reads.
constexpr int kStages = 4;  // tiles in flight in the cp.async ring

struct PlanSmem {
  long long tile, slots, hist, nsel, mine, total;
};

__host__ __device__ inline int reg_groups(int G) { return G == 1 ? 1 : G == 2 ? 2 : G <= 4 ? 4 : 0; }

__host__ __device__ inline PlanSmem plan_smem(int T, int TR, int Ft, int Fp, int G, int bins,
                                              int hist_in_smem) {
  PlanSmem L;
  L.tile = align16(4LL * TR * Ft);
  const long long slot_bytes = 28LL * G * T;
  long long u = kStages * L.tile + align16(4LL * TR);
  if (reg_groups(G) > 0 && slot_bytes > u) u = slot_bytes;
  if (repro_sketch::kFoldSmemBytes > u) u = repro_sketch::kFoldSmemBytes;
  L.slots = align16(u);
  L.hist = L.slots + (reg_groups(G) > 0 ? 0 : align16(slot_bytes));
  L.nsel = L.hist + ((bins > 0 && hist_in_smem) ? repro_sketch::hist_smem_bytes(G * Fp, bins) : 0);
  L.mine = L.nsel + 16;
  L.total = L.mine + repro_sketch::totals_bytes(G * Fp);
  return L;
}

// Stage `rows` rows from tr0 into a tile (asynchronous; the caller commits).
__device__ __forceinline__ void fill(float* tile, const PlanArgs& a, long long tr0, int rows) {
  const int T = blockDim.x;
  const int t = threadIdx.x;
  if (a.gather) {
    const int Ft = a.Ft;
    for (int e = t; e < rows * Ft; e += T) {
      const int r = e / Ft;
      repro_sketch::cp_async4(tile + e, a.x + (tr0 + r) * a.F + __ldg(a.src + (e - r * Ft)));
    }
    return;
  }
  const long long nf = (long long)rows * a.F;
  const float* g = a.x + tr0 * a.F;
  long long e = t;
  if (a.vec) {
    const long long nv = nf >> 2;
    for (long long v = t; v < nv; v += T) repro_sketch::cp_async16(tile + 4 * v, g + 4 * v);
    e = 4 * nv + t;
  }
  for (; e < nf; e += T) repro_sketch::cp_async4(tile + e, g + e);
}

template <int MAXT, int RG>
__global__ void __launch_bounds__(MAXT) plan_sketch_fused(PlanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int flag;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int G = a.G;
  const int Fp = a.Fp;
  const int J = a.J;
  const int Ft = a.Ft;
  const int TR = a.tile_rows;
  const int bins = a.bins;
  const int cols = G * Fp;
  const PlanSmem L = plan_smem(T, TR, Ft, Fp, G, bins, a.hist_in_smem);
  int* grp = reinterpret_cast<int*>(smem + kStages * L.tile);
  int* shist = reinterpret_cast<int*>(smem + L.hist);
  int* cta_nsel = reinterpret_cast<int*>(smem + L.nsel);
  repro_sketch::Scratch sc;
  repro_sketch::scratch_layout(a.scratch, cols, a.ld, bins, &sc);

  const bool smem_hist = bins > 0 && a.hist_in_smem;
  const int hcols = repro_sketch::hist_cols(cols);  // the shared histogram is [bins][hcols]
  if (smem_hist) {
    for (int i = t; i < hcols * bins; i += T) shist[i] = 0;
  }
  Slots slots = slots_at(smem + L.slots, G * T);  // accumulators when G > 4
  if (RG == 0) {
    for (int i = t; i < G * T; i += T) {
      slots.s[i] = 0.0;
      slots.ss[i] = 0.0;
      slots.mn[i] = CUDART_INF_F;
      slots.mx[i] = -CUDART_INF_F;
      slots.cnt[i] = 0;
    }
  }
  if (t == 0) *cta_nsel = 0;
  int* hist = bins > 0 ? (smem_hist ? shist : sc.hist) : nullptr;

  const long long r0 = (long long)blockIdx.x * a.rows_per_cta;
  const long long r1 = min(a.n, r0 + a.rows_per_cta);
  const long long range = r1 > r0 ? r1 - r0 : 0;
  const int ntiles = (int)((range + TR - 1) / TR);

  // column role: projected feature p, rows j, j + J, ... of each tile
  const bool active = t < Fp * J;
  const int p = active ? t % Fp : 0;
  const int j = t / Fp;
  const int colp = __ldg(a.cols + p);
  const float shift = repro_sketch::shift_of(a.x, a.n, __ldg(a.bcols + p));
  const float lo_p = bins > 0 ? __ldg(a.lo + p) : 0.0f;
  const float iw_p = bins > 0 ? __ldg(a.inv_width + p) : 0.0f;
  constexpr int R = RG > 0 ? RG : 1;
  int c[R];
  double s[R], ss[R];
  float mn[R], mx[R];
#pragma unroll
  for (int g = 0; g < R; ++g) {
    c[g] = 0;
    s[g] = 0.0;
    ss[g] = 0.0;
    mn[g] = CUDART_INF_F;
    mx[g] = -CUDART_INF_F;
  }
  int passed = 0;  // rows of this thread that pass the predicates
  __syncthreads();

  auto tile_at = [&](int it) { return reinterpret_cast<float*>(smem + (it % kStages) * L.tile); };
  auto rows_of = [&](int it) { return (int)min((long long)TR, r1 - (r0 + (long long)it * TR)); };
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < ntiles) fill(tile_at(it), a, r0 + (long long)it * TR, rows_of(it));
    repro_sketch::cp_async_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    const int nxt = it + kStages - 1;  // refills the tile read in the last iteration
    if (nxt < ntiles) fill(tile_at(nxt), a, r0 + (long long)nxt * TR, rows_of(nxt));
    repro_sketch::cp_async_commit();
    repro_sketch::cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* tile = tile_at(it);
    const int rows = rows_of(it);

    for (int r = t; r < rows; r += T) {  // row pass: predicates, group, nsel
      const float* row = tile + (long long)r * Ft;
      bool ok = true;
      for (int k = 0; k < a.npred; ++k) {
        ok = ok && compare(row[__ldg(a.pcol + k)], __ldg(a.pop + k), __ldg(a.pval + k));
      }
      int g = -1;
      if (ok) {
        passed += 1;
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
    __syncthreads();

    if (active) {  // column pass, four rows in flight
      for (int r = j; r < rows; r += 4 * J) {
        int gq[4];
        float vq[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int rr = r + k * J;
          gq[k] = rr < rows ? grp[rr] : -1;
          vq[k] = rr < rows ? tile[rr * Ft + colp] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int g = gq[k];
          if (g < 0) continue;
          const float v = vq[k];
          const double d = (double)v - (double)shift;
          if (RG > 0) {
#pragma unroll
            for (int gg = 0; gg < R; ++gg) {
              if (gg == g) {
                c[gg] += 1;
                s[gg] += d;
                ss[gg] += d * d;
                mn[gg] = fminf(mn[gg], v);
                mx[gg] = fmaxf(mx[gg], v);
              }
            }
          } else {
            const int sl = g * T + t;
            slots.cnt[sl] += 1;
            slots.s[sl] += d;
            slots.ss[sl] += d * d;
            slots.mn[sl] = fminf(slots.mn[sl], v);
            slots.mx[sl] = fmaxf(slots.mx[sl], v);
          }
          if (hist != nullptr) {
            const int b = repro_sketch::bin_of(v, lo_p, iw_p, bins);
            const int q = g * Fp + p;
            atomicAdd(hist + (smem_hist ? b * hcols + q : q * bins + b), 1);
          }
        }
      }
    }
    __syncthreads();
  }
  repro_sketch::cp_async_wait<0>();
  if (passed != 0) atomicAdd(cta_nsel, passed);

  // combine: slot g*T + t, with the J lanes of (g, p) at p + m*Fp
  Slots cs = slots;
  if (RG > 0) {
    __syncthreads();  // the tiles are free
    cs = slots_at(smem, G * T);
#pragma unroll
    for (int g = 0; g < R; ++g) {
      if (g < G) {
        const int sl = g * T + t;
        cs.cnt[sl] = c[g];
        cs.s[sl] = s[g];
        cs.ss[sl] = ss[g];
        cs.mn[sl] = mn[g];
        cs.mx[sl] = mx[g];
      }
    }
  }
  __syncthreads();
  for (int h = J / 2; h >= 1; h >>= 1) {  // a fixed tree over the J lanes
    for (int i = t; i < G * Fp * h; i += T) {
      const int g = i / (Fp * h);
      const int dst = g * T + (i - g * Fp * h);
      const int o = dst + Fp * h;
      cs.cnt[dst] += cs.cnt[o];
      cs.s[dst] += cs.s[o];
      cs.ss[dst] += cs.ss[o];
      cs.mn[dst] = fminf(cs.mn[dst], cs.mn[o]);
      cs.mx[dst] = fmaxf(cs.mx[dst], cs.mx[o]);
    }
    __syncthreads();
  }
  const repro_sketch::Partials mine = repro_sketch::totals_at(smem + L.mine, cols);
  for (int q = t; q < cols; q += T) {
    const int g = q / Fp;
    const int sl = g * T + (q - g * Fp);
    mine.s[q] = cs.s[sl];
    mine.ss[q] = cs.ss[sl];
    mine.mn[q] = cs.mn[sl];
    mine.mx[q] = cs.mx[sl];
    mine.cnt[q] = cs.cnt[sl];
  }
  if (t == 0) *mine.nsel = *cta_nsel;
  const float* x = a.x;
  const long long n = a.n;
  const int* bcols = a.bcols;
  repro_sketch::finish(sc, a.ctas, cols, Fp, bins, hcols, smem_hist ? shist : nullptr, mine, a.out,
                       smem, &flag, [&](int q) {
                         return repro_sketch::shift_of(x, n, __ldg(bcols + q % Fp));
                       });
}

template <int MAXT, typename Run>
cudaError_t with_kernel(int G, Run run) {
  switch (reg_groups(G)) {
    case 1: return run(plan_sketch_fused<MAXT, 1>);
    case 2: return run(plan_sketch_fused<MAXT, 2>);
    case 4: return run(plan_sketch_fused<MAXT, 4>);
    default: return run(plan_sketch_fused<MAXT, 0>);
  }
}

template <typename Run>
cudaError_t with_kernel(int T, int G, Run run) {
  return T <= 512 ? with_kernel<512>(G, run) : with_kernel<1024>(G, run);
}

}  // namespace

extern "C" {

// Dynamic shared memory of a launch with T threads and tiles of TR rows of
// Ft floats.
long long plan_sketch_smem_bytes(int T, int TR, int Ft, int Fp, int G, int bins, int hist_in_smem) {
  return plan_smem(T, TR, Ft, Fp, G, bins, hist_in_smem).total;
}

// Clusters of kCluster CTAs of T threads the card holds at once (negative:
// a CUDA error).
int plan_sketch_max_clusters(int T, int TR, int Ft, int Fp, int G, int bins, int hist_in_smem) {
  const size_t smem = (size_t)plan_smem(T, TR, Ft, Fp, G, bins, hist_in_smem).total;
  int n = 0;
  const cudaError_t err = with_kernel(T, G, [&](auto kernel) {
    const cudaError_t e = repro_sketch::allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    n = repro_sketch::max_clusters(kernel, T, smem);
    return cudaSuccess;
  });
  return err == cudaSuccess ? n : -(int)err;
}

// x [n, F] float32 row-major.  ctas CTAs (a multiple of kCluster, at most
// kCluster * ld) of T = Fp * J threads (J a power of two), CTA c taking
// rows [c * rows_per_cta, min(n, (c + 1) * rows_per_cta)) in tiles of
// tile_rows (both multiples of 4 when vec).
// The tile holds whole rows (Ft = F) or, when gather, the Ft block columns
// src.  Predicates: pcol (tile columns) / pop int32 [npred], pval float32
// [npred].  cols int32 [Fp]: tile columns of the projected features, bcols
// their block columns.  gcol: the label's tile column, or -1 for an
// ungrouped plan (then G must be 1).  lo / inv_width [Fp] float32 (ignored
// when bins == 0).  scratch: the sketch_scratch_bytes(G * Fp, ld, bins)
// buffer.  Writes stats [G*5, Fp] float32, hist [G*Fp, bins] int64 and nsel
// int64.  Returns the launch's error.
int plan_sketch_launch(const void* x, long long n, int F, long long rows_per_cta, int ctas,
                       int tile_rows, int Ft, int gather, int vec, int npred, const void* pcol,
                       const void* pop, const void* pval, int Fp, int J, const void* cols,
                       const void* bcols, const void* src, int gcol, int G, const void* lo,
                       const void* inv_width, int bins, int hist_in_smem, void* scratch, int ld,
                       void* stats, void* hist, void* nsel, void* stream) {
  PlanArgs a;
  a.x = static_cast<const float*>(x);
  a.n = n;
  a.F = F;
  a.rows_per_cta = rows_per_cta;
  a.ctas = ctas;
  a.tile_rows = tile_rows;
  a.Ft = Ft;
  a.gather = gather;
  a.vec = vec;
  a.npred = npred;
  a.pcol = static_cast<const int*>(pcol);
  a.pop = static_cast<const int*>(pop);
  a.pval = static_cast<const float*>(pval);
  a.Fp = Fp;
  a.J = J;
  a.cols = static_cast<const int*>(cols);
  a.bcols = static_cast<const int*>(bcols);
  a.src = static_cast<const int*>(src);
  a.gcol = gcol;
  a.G = G;
  a.lo = static_cast<const float*>(lo);
  a.inv_width = static_cast<const float*>(inv_width);
  a.bins = bins;
  a.hist_in_smem = hist_in_smem;
  a.scratch = static_cast<unsigned char*>(scratch);
  a.ld = ld;
  a.out.stats = static_cast<float*>(stats);
  a.out.hist = static_cast<long long*>(hist);
  a.out.nsel = static_cast<long long*>(nsel);
  const int T = Fp * J;
  const size_t smem = (size_t)plan_smem(T, tile_rows, Ft, Fp, G, bins, hist_in_smem).total;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err = with_kernel(T, G, [&](auto kernel) {
    const cudaError_t e = repro_sketch::allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    return repro_sketch::launch_clusters(kernel, ctas, T, smem, st, a);
  });
  return (int)err;
}

}  // extern "C"
