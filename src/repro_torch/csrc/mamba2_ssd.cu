// mamba2_ssd: the Mamba2 SSD chunked scan (Dao & Gu, 2024), per batch row b
// and head h, over chunks of Q = 128 steps:
//   cum_i   = dA_0 + ... + dA_i                       (inside the chunk)
//   y_i     = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xbar_j
//             + exp(cum_i) h_start C_i
//   h_end   = exp(cum_{Q-1}) h_start + sum_j exp(cum_{Q-1} - cum_j) xbar_j B_j^T
// with xbar [B, L, H, P], dA [B, L, H] (<= 0), B and C [B, L, N], the state
// h [B, H, P, N], P = N = 64, everything float32.
//
// Replaces the Pallas kernel ssd_pallas (_ssd_kernel) of
// src/repro/kernels/mamba2_ssd/kernel.py.  On the TPU the chunk axis was the
// innermost, sequential grid dimension and the state [Ht, P, N] lived in
// VMEM scratch from one grid step to the next.  Only the state chain is
// sequential, so here it is taken apart as Mamba2's own chunk_state,
// state_passing and chunk_scan, in two launches:
//  * ssd_state: one CTA per (b, h) walks the chunks.  A chunk's own state
//    contribution S_c = sum_j exp(cum_last - cum_j) xbar_j B_j^T ([64 x 128]
//    by [128 x 64]) does not depend on the state; it is summed on the
//    tensor cores, and h_c = exp(cum_last) h_{c-1} + S_c stays in registers
//    across the chunks.  The state at each chunk's start goes to a scratch
//    hs [B, nc, H, P, N] (16 KB a head and chunk); the last one is h_final.
//  * ssd_scan: one CTA per (b, chunk, tile of Ht heads), all in parallel.
//    C B^T [128 x 128] once per CTA, kept in shared memory; then per head the
//    inter-chunk term exp(cum_i) C_i h_start^T ([128 x 64] by [64 x 64])
//    and the intra-chunk term (C B^T o exp(cum_i - cum_j), j <= i) xbar
//    ([128 x 128] by [128 x 64]), y written once.
//
// Bound on the H100 at zamba2-7b's prefill shape (B 8, L 2048, H 112): the
// products are 45 GFLOP (2 a multiply-add), which the split below runs
// six times at the bf16 rate, as three times at the dense TF32 rate: 0.28
// ms at 494.7 TFLOP/s; xbar, dA, B, C, y and h_final are 0.97 GB, and the
// chunk-start states 0.235 GB each way: 1.44 GB, 0.43 ms at 3.35 TB/s.
// So: bytes.
//
// Design:
//  * Every product runs on mma.sync.m16n8k16 with each float32 operand in
//    three bf16 pieces (mma_x3.cuh): float32's precision on the tensor
//    cores.  Operands are staged in shared memory with rows padded to 72
//    floats where a fragment reads 8-byte pairs along a row and to 68 where
//    it reads two rows of a column, so that every fragment load hits 32
//    distinct banks.
//  * C B^T's accumulators are already the A fragments of W xbar (two
//    j-tiles side by side make a k-step of 16): each thread keeps its own
//    fragments (in shared memory, one float4 each, in thread order: 72
//    registers did not fit beside the rest), scales them by
//    exp(cum_i - cum_j), and the masked product runs from registers; W is
//    never stored.  A warp takes one of 8 row tiles from each end (tiles r
//    and 7 - r: 18 j-tiles, the same for every warp) and half of P; the
//    two warps of a row pair share C B^T, nine j-tiles computed by each.
//  * Below a row tile's diagonal block every j is before every i, so
//    exp(cum_i - cum_j) = exp(cum_i - cum_m) exp(cum_m - cum_j) with m the
//    tile's first row, both factors <= 1 (nothing overflows; a factor that
//    underflows stands for an entry smaller still): an exp per row and per
//    column in place of one per entry.  The diagonal blocks take one exp
//    an entry.
//  * The tensor cores round toward zero as they accumulate.  So no sum runs
//    long in one accumulator: every k-step of 16 terms (32 in S_c) starts
//    from zero and is added in float32, and S_c is added to exp(cum_last) h
//    with one fmaf, as the plain version adds it.  (C B^T summed over its
//    64 terms in one accumulator put y twice as far from a float64 scan as
//    the plain version; a k-step at a time, nearer than the plain version.)
//  * Precision as before: cum and the differences cum_i - cum_j in
//    float64, each exponent rounded to float32 once (cum reaches about
//    -100 in a chunk, where a float32 ulp is 8e-6); exp taken only where
//    j <= i, W is 0 above the diagonal by selection, never by multiplying
//    an exp that may be inf.
//  * Staging by cp.async: ssd_state through a ring of 3 stages of 32 steps
//    (xbar and B, and the chunk's dA), 56 KB, three CTAs an SM; ssd_scan
//    loads C and B once and each head's xbar, h_start and dA through two
//    slots, the next head's in flight while one computes (211 KB, one CTA
//    an SM; B sits in the second slot until C B^T is taken).  Operands used
//    by several warps or heads are split once where the room allows: C
//    into three bf16 pieces for every head's C h_start^T, and each k-step
//    of xbar for both of a warp's row tiles.  The wrapper picks Ht so that
//    the B * nc * H / Ht CTAs fill the SMs in the fewest waves.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_x3.cuh"

namespace {

constexpr int Q = 128;  // chunk
constexpr int P = 64;   // head dim
constexpr int N = 64;   // state dim

// ---------------------------------------------------------------------------
// ssd_state: the chunk-start states and h_final
// ---------------------------------------------------------------------------

constexpr int kStateThreads = 128;       // 4 warps, 16 rows of P each
constexpr int kSub = 32;                 // steps of a stage
constexpr int kSubs = Q / kSub;          // stages a chunk
constexpr int kStages = 3;
constexpr int kXS = 68;                  // row stride of staged xbar and B (floats)
constexpr int kStX = 0;                  // xbar [kSub][kXS]
constexpr int kStB = kStX + kSub * kXS;  // B [kSub][kXS]
constexpr int kStDA = kStB + kSub * kXS; // the chunk's dA [Q], at its first stage
constexpr int kStage = kStDA + Q;
constexpr int kStateSmemFloats = kStages * kStage + 4 * Q;  // + each warp's decays [Q]

struct StateArgs {
  const float* x;
  const float* dA;
  const float* Bm;
  const float* h0;  // may be null: start from zeros
  float* hs;        // [B, nc, H, P, N]: the state at each chunk's start
  float* h;         // [B, H, P, N]: h_final
  int L, H;
};

// the chunk's inclusive prefix sum of dA in float64, one warp; lane l holds
// steps 4l .. 4l + 3.  Returns the chunk's total.
__device__ __forceinline__ double chunk_cum(const float* dA, int lane, double (&v)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = dA[4 * lane + k];
  v[1] += v[0];
  v[2] += v[1];
  v[3] += v[2];
  double s = v[3];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += o;
  }
  const double base = s - v[3];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] += base;
  return __shfl_sync(0xffffffffu, s, 31);
}

__global__ void __launch_bounds__(kStateThreads, 3) ssd_state(StateArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int H = a.H;
  const long long L = a.L;
  const int nc = a.L / Q;
  const int n_it = nc * kSubs;
  const int p0 = 16 * warp;
  float* dec = sm + kStages * kStage + warp * Q;  // exp(cum_last - cum_j), this warp's

  auto issue = [&](int it) {
    if (it < n_it) {
      float* st = sm + (it % kStages) * kStage;
      const long long t0 = (long long)it * kSub;
      for (int idx = tid; idx < kSub * (P / 4); idx += kStateThreads) {
        const int r = idx >> 4, c4 = (idx & 15) * 4;
        x3::cp16(st + kStX + r * kXS + c4, a.x + (((long long)b * L + t0 + r) * H + h) * P + c4);
        x3::cp16(st + kStB + r * kXS + c4, a.Bm + ((long long)b * L + t0 + r) * N + c4);
      }
      if (it % kSubs == 0) {
        for (int j = tid; j < Q; j += kStateThreads) {
          x3::cp4(st + kStDA + j, a.dA + ((long long)b * L + t0 + j) * H + h);
        }
      }
    }
    x3::cp_commit();
  };

  // the state: rows p0 + g, p0 + g + 8, columns 8 nt + 2t, + 1
  const long long hoff = ((long long)b * H + h) * P * N;
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = 8 * nt + 2 * t;
    float2 u = make_float2(0.f, 0.f), w = u;
    if (a.h0) {
      u = *reinterpret_cast<const float2*>(a.h0 + hoff + (p0 + g) * N + n);
      w = *reinterpret_cast<const float2*>(a.h0 + hoff + (p0 + g + 8) * N + n);
    }
    acc[nt][0] = u.x;
    acc[nt][1] = u.y;
    acc[nt][2] = w.x;
    acc[nt][3] = w.y;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  // S_c, the chunk's own contribution, is summed a stage (32 steps) at a
  // time into its own accumulators and added to exp(cum_last) h in float32
  // at the chunk's end, as the plain version adds it: the tensor cores'
  // accumulation rounds toward zero, and a long chain into the state would
  // carry that bias across every chunk
  float sc[8][4];
  float gl = 1.f;  // exp(cum_last) of the current chunk
  for (int it = 0; it < n_it; ++it) {
    x3::cp_wait<kStages - 2>();
    __syncthreads();
    issue(it + kStages - 1);
    const float* st = sm + (it % kStages) * kStage;
    const int sub = it % kSubs;
    if (sub == 0) {
      // the state at the chunk's start
      const int c = it / kSubs;
      float* hw = a.hs + (((long long)b * nc + c) * H + h) * P * N;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(hw + (p0 + g) * N + n) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(hw + (p0 + g + 8) * N + n) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
      double v[4];
      const double last = chunk_cum(st + kStDA, lane, v);
      __syncwarp();  // every lane is done with the previous chunk's decays
#pragma unroll
      for (int k = 0; k < 4; ++k) dec[4 * lane + k] = expf((float)(last - v[k]));
      gl = expf((float)last);
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
    }
    // these 32 steps' share of S_c: (xbar o dec)^T B, k = the step
    float part[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSub / 16; ++ks) {
      const int jl = 16 * ks + 2 * t;  // and jl + 1, jl + 8, jl + 9
      const float* dj = dec + sub * kSub + jl;
      const float* xr = st + kStX + jl * kXS + p0 + g;
      const float lo[4] = {xr[0] * dj[0], xr[8] * dj[0], xr[8 * kXS] * dj[8],
                           xr[8 * kXS + 8] * dj[8]};
      const float hi[4] = {xr[kXS] * dj[1], xr[kXS + 8] * dj[1], xr[9 * kXS] * dj[9],
                           xr[9 * kXS + 8] * dj[9]};
      const x3::Frag<4> af = x3::frag(lo, hi);
      const float* br = st + kStB + jl * kXS + g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float blo[2] = {br[8 * nt], br[8 * kXS + 8 * nt]};
        const float bhi[2] = {br[kXS + 8 * nt], br[9 * kXS + 8 * nt]};
        x3::mma6(part[nt], af, x3::frag(blo, bhi));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] += part[nt][e];
    if (sub == kSubs - 1) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = fmaf(gl, acc[nt][e], sc[nt][e]);
    }
  }
  x3::cp_wait<0>();

  float* hw = a.h + hoff;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = 8 * nt + 2 * t;
    *reinterpret_cast<float2*>(hw + (p0 + g) * N + n) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(hw + (p0 + g + 8) * N + n) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ---------------------------------------------------------------------------
// ssd_scan: y of every chunk
// ---------------------------------------------------------------------------

constexpr int kScanThreads = 256;  // 8 warps: 4 row-tile pairs x 2 halves of P
constexpr int kS = 72;             // row stride of C, B and h_start (floats): 8-byte pairs
constexpr int kSX = 68;            // row stride of xbar (floats): single floats
constexpr int kJT = 18;            // j-tiles of C B^T a warp holds
constexpr int kCP = 36;            // row stride of C's bf16 pieces (32-bit words)
constexpr int kCs = 0;             // C [Q][kS], until its pieces take its place
constexpr int kCPieces = 0;        // C in three bf16 pieces [3][Q][kCP] words
// C B^T's fragments [kJT][128][4], in the thread order of a row-tile pair's
// warp (the two warps of a pair, one per half of P, hold the same ones)
constexpr int kCB = kCPieces + 3 * Q * kCP;
constexpr int kSlot0 = kCB + kJT * 128 * 4;
constexpr int kSlotX = 0;                    // xbar [Q][kSX]
constexpr int kSlotH = kSlotX + Q * kSX;     // h_start [P][kS]
constexpr int kSlotDA = kSlotH + P * kS;     // dA [Q]
constexpr int kSlot = kSlotDA + Q;
constexpr int kCum = kSlot0 + 2 * kSlot;     // each warp's cum [Q], float64
constexpr int kF = kCum + 8 * Q * 2;         // each warp's column decays [2][Q]
constexpr int kScanSmemFloats = kF + 8 * 2 * Q;

struct ScanArgs {
  const float* x;
  const float* dA;
  const float* Bm;
  const float* Cm;
  const float* hs;
  float* y;
  int L, H, Ht;
};

// the A fragment of rows i0 .. i0 + 15 of a [.][kS] array, columns n0 .. n0 + 15
__device__ __forceinline__ x3::Frag<4> rows_frag(const float* M, int i0, int n0, int g, int t) {
  const float* m0 = M + (i0 + g) * kS + n0 + 2 * t;
  const float2 v0 = *reinterpret_cast<const float2*>(m0);
  const float2 v1 = *reinterpret_cast<const float2*>(m0 + 8 * kS);
  const float2 v2 = *reinterpret_cast<const float2*>(m0 + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(m0 + 8 * kS + 8);
  const float lo[4] = {v0.x, v1.x, v2.x, v3.x};
  const float hi[4] = {v0.y, v1.y, v2.y, v3.y};
  return x3::frag(lo, hi);
}

// the A fragment of rows i0 .. i0 + 15, columns n0 .. n0 + 15 of C's pieces
__device__ __forceinline__ x3::Frag<4> piece_frag(const uint32_t* Cp, int i0, int n0, int g,
                                                  int t) {
  x3::Frag<4> f;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const uint32_t* m0 = Cp + (q * Q + i0 + g) * kCP + n0 / 2 + t;
    f.v[q][0] = m0[0];
    f.v[q][1] = m0[8 * kCP];
    f.v[q][2] = m0[4];
    f.v[q][3] = m0[8 * kCP + 4];
  }
  return f;
}

// the B fragment of row j (as column n) of a [.][kS] array, k = columns n0 .. n0 + 15
__device__ __forceinline__ x3::Frag<2> cols_frag(const float* M, int j, int n0, int t) {
  const float* m0 = M + j * kS + n0 + 2 * t;
  const float2 v0 = *reinterpret_cast<const float2*>(m0);
  const float2 v1 = *reinterpret_cast<const float2*>(m0 + 8);
  const float lo[2] = {v0.x, v1.x};
  const float hi[2] = {v0.y, v1.y};
  return x3::frag(lo, hi);
}

__device__ __forceinline__ void zero(float (&x)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

// acc += part, part = 0
__device__ __forceinline__ void flush(float (&acc)[4][4], float (&part)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[i][e] += part[i][e];
      part[i][e] = 0.f;
    }
}

__global__ void __launch_bounds__(kScanThreads, 1) ssd_scan(ScanArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.y, b = blockIdx.z;
  const int H = a.H, Ht = a.Ht;
  const long long L = a.L;
  const int nc = a.L / Q;
  const long long t0 = (long long)c * Q;
  // this warp: row tiles r and 7 - r of the chunk, columns pb .. pb + 31 of P
  const int r = warp & 3, ra = r, rb = 7 - r, nA = 2 * r + 2;
  const int pb = 32 * (warp >> 2);
  const float* Cs = sm + kCs;
  const uint32_t* Cp = reinterpret_cast<const uint32_t*>(sm + kCPieces);
  float4* CBf = reinterpret_cast<float4*>(sm + kCB) + 32 * r + lane;
  double* cum = reinterpret_cast<double*>(sm + kCum) + warp * Q;
  float* fa = sm + kF + warp * 2 * Q;  // exp(cum_m - cum_j), m = 16 ra, j < m
  float* fb = fa + Q;                  // the same for m = 16 rb

  auto issue = [&](int hh) {
    if (hh < Ht) {
      float* sl = sm + kSlot0 + (hh & 1) * kSlot;
      const int h = blockIdx.x * Ht + hh;
      for (int idx = tid; idx < Q * (P / 4); idx += kScanThreads) {
        const int row = idx >> 4, c4 = (idx & 15) * 4;
        x3::cp16(sl + kSlotX + row * kSX + c4,
                 a.x + (((long long)b * L + t0 + row) * H + h) * P + c4);
      }
      const float* hsrc = a.hs + (((long long)b * nc + c) * H + h) * P * N;
      for (int idx = tid; idx < P * (N / 4); idx += kScanThreads) {
        const int row = idx >> 4, c4 = (idx & 15) * 4;
        x3::cp16(sl + kSlotH + row * kS + c4, hsrc + row * N + c4);
      }
      if (tid < Q) x3::cp4(sl + kSlotDA + tid, a.dA + ((long long)b * L + t0 + tid) * H + h);
    }
    x3::cp_commit();
  };

  // C, head 0's slot, and B (in slot 1 until C B^T is taken)
  const float* Bs = sm + kSlot0 + kSlot;
  for (int idx = tid; idx < Q * (N / 4); idx += kScanThreads) {
    const int row = idx >> 4, c4 = (idx & 15) * 4;
    x3::cp16(sm + kCs + row * kS + c4, a.Cm + ((long long)b * L + t0 + row) * N + c4);
    x3::cp16(sm + kSlot0 + kSlot + row * kS + c4, a.Bm + ((long long)b * L + t0 + row) * N + c4);
  }
  issue(0);
  x3::cp_wait<0>();
  __syncthreads();

  // C B^T for this warp's tiles, kept in shared memory in fragment order:
  // entry s is row tile ra, j-tile s for s < nA, else row tile rb, j-tile
  // s - nA.  The pair's warps take nine j-tiles each.
  {
    const int half = warp >> 2;
    float cb[kJT / 2][4];
#pragma unroll
    for (int s = 0; s < kJT / 2; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) cb[s][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < N / 16; ++kk) {
      const x3::Frag<4> ca = rows_frag(Cs, 16 * ra, 16 * kk, g, t);
      const x3::Frag<4> cbr = rows_frag(Cs, 16 * rb, 16 * kk, g, t);
#pragma unroll
      for (int s2 = 0; s2 < kJT / 2; ++s2) {
        const int s = half * (kJT / 2) + s2;
        const int jt = s < nA ? s : s - nA;
        const x3::Frag<2> bf = cols_frag(Bs, 8 * jt + g, 16 * kk, t);
        float part[4] = {0.f, 0.f, 0.f, 0.f};  // each k-step from zero: see the notes above
        if (s < nA) {
          x3::mma6(part, ca, bf);
        } else {
          x3::mma6(part, cbr, bf);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) cb[s2][e] += part[e];
      }
    }
#pragma unroll
    for (int s2 = 0; s2 < kJT / 2; ++s2) {
      CBf[(half * (kJT / 2) + s2) * 128] = make_float4(cb[s2][0], cb[s2][1], cb[s2][2], cb[s2][3]);
    }
  }
  // C in three bf16 pieces, split once for every head's C h_start^T: each
  // thread takes 16 pairs of C into registers, and after the barrier
  // writes their pieces over C
  {
    float2 cv[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int e = tid + kScanThreads * k, row = e >> 5, pr = e & 31;
      cv[k] = *reinterpret_cast<const float2*>(Cs + row * kS + 2 * pr);
    }
    __syncthreads();  // every warp is done with B and with C in float32
    uint32_t* cp = reinterpret_cast<uint32_t*>(sm + kCPieces);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int e = tid + kScanThreads * k, row = e >> 5, pr = e & 31;
      const x3::Split sp = x3::split(cv[k].x, cv[k].y);
#pragma unroll
      for (int q = 0; q < 3; ++q) cp[(q * Q + row) * kCP + pr] = sp.p[q];
    }
  }
  __syncthreads();  // C's pieces are in place; slot 1 takes head 1
  issue(1);

  for (int hh = 0; hh < Ht; ++hh) {
    if (hh > 0) {
      x3::cp_wait<0>();
      __syncthreads();  // head hh has landed; every warp is done with head hh - 1
      issue(hh + 1);
    }
    const int h = blockIdx.x * Ht + hh;
    const float* sl = sm + kSlot0 + (hh & 1) * kSlot;
    const float* Xs = sl + kSlotX;
    const float* Hs = sl + kSlotH;

    // cum of this head's chunk, in this warp's own copy
    double v[4];
    chunk_cum(sl + kSlotDA, lane, v);
    __syncwarp();  // every lane is done with the previous head's cum
#pragma unroll
    for (int k = 0; k < 4; ++k) cum[4 * lane + k] = v[k];
    __syncwarp();
    const int ia = 16 * ra + g, ib = 16 * rb + g;  // and + 8
    // below a row tile's diagonal block every j is before every i, so
    // exp(cum_i - cum_j) = exp(cum_i - cum_m) exp(cum_m - cum_j) with m the
    // tile's first row, both factors <= 1: a row factor per i and a column
    // factor per j in place of an exp per entry
    const double ma = cum[16 * ra], mb = cum[16 * rb];
    for (int j = lane; j < 16 * rb; j += 32) {
      fb[j] = expf((float)(mb - cum[j]));
      if (j < 16 * ra) fa[j] = expf((float)(ma - cum[j]));
    }
    __syncwarp();

    // the inter-chunk term C h_start^T, each row times exp(cum_i); the
    // tensor cores round toward zero as they accumulate, so every k-step of
    // 16 terms starts from zero and is added in float32
    float acc[2][4][4], part[2][4][4];
    zero(acc[0]);
    zero(acc[1]);
    zero(part[0]);
    zero(part[1]);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const x3::Frag<4> ca = piece_frag(Cp, 16 * ra, 16 * kk, g, t);
      const x3::Frag<4> cbr = piece_frag(Cp, 16 * rb, 16 * kk, g, t);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const x3::Frag<2> hf = cols_frag(Hs, pb + 8 * nt + g, 16 * kk, t);
        x3::mma6(part[0][nt], ca, hf);
        x3::mma6(part[1][nt], cbr, hf);
      }
      flush(acc[0], part[0]);
      flush(acc[1], part[1]);
    }
    {
      const float ea0 = expf((float)cum[ia]), ea1 = expf((float)cum[ia + 8]);
      const float eb0 = expf((float)cum[ib]), eb1 = expf((float)cum[ib + 8]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        acc[0][nt][0] *= ea0;
        acc[0][nt][1] *= ea0;
        acc[0][nt][2] *= ea1;
        acc[0][nt][3] *= ea1;
        acc[1][nt][0] *= eb0;
        acc[1][nt][1] *= eb0;
        acc[1][nt][2] *= eb1;
        acc[1][nt][3] *= eb1;
      }
    }

    // the intra-chunk term: W = C B^T o exp(cum_i - cum_j) over j <= i.  A
    // k-step of 16 columns j takes two j-tiles of C B^T, whose C fragments
    // are W's A fragment; each k-step from zero.
    const double ca0 = cum[ia], ca1 = cum[ia + 8], cb0 = cum[ib], cb1 = cum[ib + 8];
    // W of one j-tile (c0 .. c3 of its C fragment)
    auto w_tile = [&](float (&w)[4], int s, int jt, int rt, int i0, double ci0, double ci1,
                      float e0, float e1, const float* F) {
      const int j0 = 8 * jt + 2 * t;
      const float4 cbv = CBf[s * 128];
      if (jt < 2 * rt) {
        const float2 f = *reinterpret_cast<const float2*>(F + j0);
        w[0] = cbv.x * e0 * f.x;
        w[1] = cbv.y * e0 * f.y;
        w[2] = cbv.z * e1 * f.x;
        w[3] = cbv.w * e1 * f.y;
      } else {  // the diagonal block: one exp an entry, none above the diagonal
        const double2 cj = *reinterpret_cast<const double2*>(cum + j0);
        w[0] = j0 <= i0 ? cbv.x * expf((float)(ci0 - cj.x)) : 0.f;
        w[1] = j0 + 1 <= i0 ? cbv.y * expf((float)(ci0 - cj.y)) : 0.f;
        w[2] = j0 <= i0 + 8 ? cbv.z * expf((float)(ci1 - cj.x)) : 0.f;
        w[3] = j0 + 1 <= i0 + 8 ? cbv.w * expf((float)(ci1 - cj.y)) : 0.f;
      }
    };
    // W's A fragment of row tile rt at k-step m (j-tiles 2m and 2m + 1)
    auto w_frag = [&](int s, int m, int rt, int i0, double ci0, double ci1, float e0, float e1,
                      const float* F) {
      float w0[4], w1[4];
      w_tile(w0, s, 2 * m, rt, i0, ci0, ci1, e0, e1, F);
      w_tile(w1, s + 1, 2 * m + 1, rt, i0, ci0, ci1, e0, e1, F);
      const float lo[4] = {w0[0], w0[2], w1[0], w1[2]};
      const float hi[4] = {w0[1], w0[3], w1[1], w1[3]};
      return x3::frag(lo, hi);
    };
    // xbar's B fragments at k-step m, split once for both row tiles
    auto x_frags = [&](x3::Frag<2> (&xf)[4], int m) {
      const float* xp = Xs + (16 * m + 2 * t) * kSX + pb + g;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float blo[2] = {xp[8 * nt], xp[8 * kSX + 8 * nt]};
        const float bhi[2] = {xp[kSX + 8 * nt], xp[9 * kSX + 8 * nt]};
        xf[nt] = x3::frag(blo, bhi);
      }
    };
    auto wx = [&](float (&accq)[4][4], const x3::Frag<4>& wf, const x3::Frag<2> (&xf)[4]) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) x3::mma6(part[0][nt], wf, xf[nt]);
      flush(accq, part[0]);
    };
    // the row factors exp(cum_i - cum_m)
    const float ea0 = expf((float)(ca0 - ma)), ea1 = expf((float)(ca1 - ma));
    const float eb0 = expf((float)(cb0 - mb)), eb1 = expf((float)(cb1 - mb));
#pragma unroll 1
    for (int m = 0; m <= rb; ++m) {  // rb > ra: tile ra stops at its diagonal
      x3::Frag<2> xf[4];
      x_frags(xf, m);
      if (m <= ra) wx(acc[0], w_frag(2 * m, m, ra, ia, ca0, ca1, ea0, ea1, fa), xf);
      wx(acc[1], w_frag(nA + 2 * m, m, rb, ib, cb0, cb1, eb0, eb1, fb), xf);
    }

    // y: rows i0, i0 + 8 of each tile, columns pb + 8 nt + 2t, + 1
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = q == 0 ? ia : ib;
      float* yp = a.y + (((long long)b * L + t0 + i) * H + h) * P + pb + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        *reinterpret_cast<float2*>(yp + 8 * nt) = make_float2(acc[q][nt][0], acc[q][nt][1]);
        *reinterpret_cast<float2*>(yp + 8LL * H * P + 8 * nt) =
            make_float2(acc[q][nt][2], acc[q][nt][3]);
      }
    }
  }
  x3::cp_wait<0>();
}

}  // namespace

extern "C" {

// xbar [B, L, H, 64], dA [B, L, H], Bm / Cm [B, L, 64], h0 [B, H, 64, 64] or
// null, y [B, L, H, 64], h [B, H, 64, 64], hs [B, L / 128, H, 64, 64]
// (scratch: the state at each chunk's start); all contiguous float32, L a
// multiple of 128, Ht a divisor of H (heads per ssd_scan CTA).  Two
// launches; returns cudaGetLastError() after them.
int mamba2_ssd_launch(const float* x, const float* dA, const float* Bm, const float* Cm,
                      const float* h0, float* y, float* h, float* hs, int B, int L, int H,
                      int Ht, void* stream) {
  if (B <= 0 || H <= 0 || Ht <= 0 || H % Ht != 0 || L < 0 || L % Q != 0 || B > 65535 ||
      L / Q > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (L == 0) return (int)cudaSuccess;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t state_smem = (size_t)kStateSmemFloats * sizeof(float);
  const size_t scan_smem = (size_t)kScanSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_state, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)state_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)scan_smem);
  if (err != cudaSuccess) return (int)err;
  const StateArgs sa{x, dA, Bm, h0, hs, h, L, H};
  ssd_state<<<dim3((unsigned)H, (unsigned)B), kStateThreads, state_smem, st>>>(sa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const ScanArgs ca{x, dA, Bm, Cm, hs, y, L, H, Ht};
  ssd_scan<<<dim3((unsigned)(H / Ht), (unsigned)(L / Q), (unsigned)B), kScanThreads, scan_smem,
             st>>>(ca);
  return (int)cudaGetLastError();
}

}  // extern "C"
