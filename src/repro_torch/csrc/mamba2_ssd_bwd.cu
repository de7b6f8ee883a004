// mamba2_ssd_bwd: the backward of the Mamba2 SSD chunked scan
// (mamba2_ssd.cu), per batch row b and head h, chunks of Q = 128 steps,
// P = N = 64.
//
// Replaces no Pallas kernel: the reference trains through jax.grad of its
// jnp chunked form (src/repro/models/mamba2.py, ssd_chunked), and its
// Pallas SSD has no backward.  The formulas are ref.py's ssd_chunked_bwd.
// cum_t is the inclusive prefix sum of dA inside a chunk, W_ts =
// exp(cum_t - cum_s) for s <= t (0 above), M = (C B^T) W and E_ts = W_ts
// (dy_t . xbar_s):
//   G_start = exp(cum_Q) G_end + sum_t exp(cum_t) dy_t C_t^T       (ssd_bwd_state)
//   dxbar_s = exp(cum_Q - cum_s) G_end B_s + sum_{t>=s} M_ts dy_t  (ssd_bwd_tile)
//   dB_s    = sum_h exp(cum_Q - cum_s) G_end^T xbar_s + sum_{t>=s} (sum_h E_ts) C_t
//   dC_t    = sum_h exp(cum_t) h_start^T dy_t + sum_{s<=t} (sum_h E_ts) B_s
//   ddA_s   = exp(cum_Q) <G_end, h_start> + sum_{t>=s} exp(cum_t) dy_t . (h_start C_t)
//             + sum_{j<s} exp(cum_Q - cum_j) xbar_j . (G_end B_j) + sum_{j<s<=t} F_tj,
// F = (C B^T) E strictly below the diagonal: the paths through step s's
// decay inside its chunk, each term carrying that decay, so nothing cancels.
// B and C are shared by the heads, so dB's and dC's intra-chunk terms are
// products of E summed over the heads.  No atomics: every sum runs in one
// fixed order, and a call gives the same bits every time.
//
// Two launches: ssd_bwd_state, one CTA a (b, h), walks the chunks in
// reverse and writes G_end of every chunk (the forward's hs layout);
// ssd_bwd_tile, one CTA a (b, chunk, tile of Ht heads), computes the
// chunk's gradients from the forward's chunk-start states (hs) and G_end,
// and writes dB's and dC's sums over its heads, [B, L, H / Ht, 64], which
// the caller adds in one fixed order.
//
// Bound on the H100 at zamba2-7b's training shape (B 8, L 2048, H 112): it
// reads xbar, dy (0.470 GB each), dA, B, C and the chunk-start states
// (0.470 GB) and writes dxbar, ddA, dB, dC: about 1.68 GB, 0.50 ms at 3.35
// TB/s (with G_end written and read back, 2.15 GB, 0.64 ms).  The chunked
// algebra is about 122 GFLOP: 1.81 ms at 67 TFLOP/s of float32; as six
// bf16 products a product on the tensor cores, 0.74 ms at 989 TFLOP/s.
// ssd_bwd_tile forms about 79 GFLOP of products (C B^T once a tile, dB's
// and dC's intra-chunk terms once a tile on the heads' summed E) and
// ssd_bwd_state 15 GFLOP: 0.57 ms as six bf16 products.  So: operations.
//
// Design:
//  * Every product runs on mma.sync.m16n8k16 with each float32 operand in
//    three bf16 pieces (mma_x3.cuh), float32's precision on the tensor
//    cores.  They round toward zero as they accumulate, so every k-step of
//    16 terms starts from zero and is added in float32.  An MMA waits for
//    the one before it into the same accumulator (about 22 cycles on the
//    H100, against about 7 a warp scheduler takes to issue one), so the
//    six products of 4 to 8 independent k-steps are interleaved.
//  * ssd_bwd_state is the forward's ssd_state walked backward: dy and C
//    through a ring of 3 cp.async stages of 32 steps, G in the four warps'
//    accumulators (16 rows of P each), the chunk's term from zero and
//    added to exp(cum_Q) G with one fmaf.
//  * ssd_bwd_tile, 8 warps: warp (r, half) owns the row tiles r and 7 - r
//    of a [128 x 64] result and its half of the columns (the forward's
//    ssd_scan layout), so every warp has the same share of the causal
//    triangle: the 9 blocks of 16 x 16 in the two row tiles' columns.
//  * B C^T, oriented by rows s, is computed once a CTA (C staged in xbar's
//    place until then) and kept in shared memory in fragment order (each
//    thread reads its own float4s): the A fragment of M^T = (B C^T) o W^T
//    for dxbar's intra-chunk term, and the weights of F^T.
//  * Per head: the chunk-boundary terms (dy h_start, xbar G_end, B G_end^T;
//    each [128 x 64] by [64 x 64], both row tiles of a warp on one split
//    of each B fragment), then dxbar's intra-chunk term M^T dy, then E^T =
//    W^T o (xbar dy^T) over the triangle, each of its 36 blocks by one
//    warp, which adds it into the heads' sum (shared memory, fragment
//    order, each thread its own entries) and takes F^T's row, column and
//    diagonal path sums with shuffles.  dB's and dC's chunk-boundary terms
//    are summed over the tile's heads in registers, in head order.  After
//    the last head the summed E is spread out as a matrix over xbar's and
//    dy's place, C is staged again in G_end's, and two products add dB's
//    and dC's intra-chunk terms.
//  * Below the diagonal blocks every s is before every t, so W_ts =
//    exp(cum_t - cum_m) exp(cum_m - cum_s) with m the t-tile's first step,
//    both factors <= 1, from two tables of 576 exps a head (the forward
//    takes its W so); the diagonal blocks take an exp an entry.
//  * Staging: each head's xbar, dy, dA, G_end and h_start by cp.async,
//    each array as soon as the previous head is done with it (G_end,
//    h_start and dA after the boundary terms, xbar and dy after the
//    triangle).  B, B C^T, the heads' summed E and one head's operands take
//    226 KB of the SM's 227: a second slot for a whole head does not fit.
//    (A prefetch of the next head into L2 when a head started cost more
//    issue time than it saved in waiting, on the H100.)
//  * Precision as before: cum and the differences cum_t - cum_s in
//    float64, each exponent rounded to float32 once, every exponent <= 0;
//    exp taken only where s <= t, W 0 above the diagonal by selection.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_x3.cuh"

namespace {

constexpr int Q = 128;  // chunk
constexpr int P = 64;   // head dim
constexpr int N = 64;   // state dim
constexpr int kThreads = 256;

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

// ---------------------------------------------------------------------------
// ssd_bwd_state: G_end of every chunk, the chunks in reverse
// ---------------------------------------------------------------------------

constexpr int kStThreads = 128;             // 4 warps, 16 rows of P each
constexpr int kSub = 32;                    // steps of a stage
constexpr int kSubs = Q / kSub;             // stages a chunk
constexpr int kStages = 3;
constexpr int kXS = 68;                     // row stride of staged dy and C (floats)
constexpr int kStDy = 0;                    // dy [kSub][kXS]
constexpr int kStC = kStDy + kSub * kXS;    // C [kSub][kXS]
constexpr int kStDA = kStC + kSub * kXS;    // the chunk's dA [Q], at its first stage
constexpr int kStage = kStDA + Q;
constexpr int kStFloats = kStages * kStage + 4 * Q;  // + each warp's exp(cum_t) [Q]

struct StateArgs {
  const float* dA;   // [B, L, H]
  const float* C;    // [B, L, N]
  const float* dy;   // [B, L, H, P]
  const float* dh;   // [B, H, P, N] or null
  float* dhs;        // [B, L / Q, H, P, N]
  int L, H;
};

// The forward's ssd_state walked backward: G_start = exp(cum_Q) G_end + sum_t
// (exp(cum_t) dy_t) C_t^T, a stage of 32 steps at a time through a ring of
// 3 cp.async stages, the chunk's term on the tensor cores (each k-step of
// 16 from zero) and added to exp(cum_Q) G with one fmaf at the chunk's end.
__global__ void __launch_bounds__(kStThreads, 3) ssd_bwd_state(StateArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int H = a.H, nc = a.L / Q, n_it = nc * kSubs;
  const long long L = a.L;
  const int p0 = 16 * warp;
  float* dec = sm + kStages * kStage + warp * Q;  // exp(cum_t), this warp's

  // iteration it: chunk nc - 1 - it / kSubs, its stage it % kSubs
  auto issue = [&](int it) {
    if (it < n_it) {
      float* st = sm + (it % kStages) * kStage;
      const long long t0 = (long long)(nc - 1 - it / kSubs) * Q + (it % kSubs) * kSub;
      for (int idx = tid; idx < kSub * (P / 4); idx += kStThreads) {
        const int r = idx >> 4, c4 = (idx & 15) * 4;
        x3::cp16(st + kStDy + r * kXS + c4,
                 a.dy + (((long long)b * L + t0 + r) * H + h) * P + c4);
        x3::cp16(st + kStC + r * kXS + c4, a.C + ((long long)b * L + t0 + r) * N + c4);
      }
      if (it % kSubs == 0) {
        for (int j = tid; j < Q; j += kStThreads) {
          x3::cp4(st + kStDA + j, a.dA + ((long long)b * L + t0 + j) * H + h);
        }
      }
    }
    x3::cp_commit();
  };

  // G: rows p0 + g, p0 + g + 8, columns 8 nt + 2t, + 1
  const long long hoff = ((long long)b * H + h) * P * N;
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = 8 * nt + 2 * t;
    float2 u = make_float2(0.f, 0.f), w = u;
    if (a.dh) {
      u = *reinterpret_cast<const float2*>(a.dh + hoff + (p0 + g) * N + n);
      w = *reinterpret_cast<const float2*>(a.dh + hoff + (p0 + g + 8) * N + n);
    }
    acc[nt][0] = u.x;
    acc[nt][1] = u.y;
    acc[nt][2] = w.x;
    acc[nt][3] = w.y;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  float sc[8][4];  // the chunk's own term
  float gl = 1.f;  // exp(cum_Q) of the current chunk
  for (int it = 0; it < n_it; ++it) {
    x3::cp_wait<kStages - 2>();
    __syncthreads();
    issue(it + kStages - 1);
    const float* st = sm + (it % kStages) * kStage;
    const int sub = it % kSubs;
    if (sub == 0) {
      // G_end of the chunk
      const int c = nc - 1 - it / kSubs;
      float* gw = a.dhs + (((long long)b * nc + c) * H + h) * P * N;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(gw + (p0 + g) * N + n) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(gw + (p0 + g + 8) * N + n) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
      double v[4];
      const double last = chunk_cum(st + kStDA, lane, v);
      __syncwarp();  // every lane is done with the previous chunk's decays
#pragma unroll
      for (int k = 0; k < 4; ++k) dec[4 * lane + k] = expf((float)v[k]);
      gl = expf((float)last);
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
    }
    // these 32 steps' share of the chunk's term: (dy o exp(cum))^T C, k =
    // the step, a k-step of 16 at a time
#pragma unroll
    for (int ks = 0; ks < kSub / 16; ++ks) {
      const int jl = 16 * ks + 2 * t;  // and jl + 1, jl + 8, jl + 9
      const float* dj = dec + sub * kSub + jl;
      const float* xr = st + kStDy + jl * kXS + p0 + g;
      const float lo[4] = {xr[0] * dj[0], xr[8] * dj[0], xr[8 * kXS] * dj[8],
                           xr[8 * kXS + 8] * dj[8]};
      const float hi[4] = {xr[kXS] * dj[1], xr[kXS + 8] * dj[1], xr[9 * kXS] * dj[9],
                           xr[9 * kXS + 8] * dj[9]};
      const x3::Frag<4> af = x3::frag(lo, hi);
      x3::Frag<2> bf[8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) bf[nt] = x3::b_rows(st + kStC, kXS, 16 * ks, 8 * nt + g, t);
      x3::mma_add_n<8>(sc, af, bf);
    }
    if (sub == kSubs - 1) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = fmaf(gl, acc[nt][e], sc[nt][e]);
    }
  }
  x3::cp_wait<0>();
}

// ---------------------------------------------------------------------------
// ssd_bwd_tile: one chunk's gradients for a tile of Ht heads
// ---------------------------------------------------------------------------

constexpr int kSR = 72;     // row stride where fragments read 8-byte pairs along a row
constexpr int kSC = 68;     // where they read two rows of one column
constexpr int kNT = 18;     // n8 tiles of B C^T a row-tile pair keeps (its 9 blocks)
constexpr int kPairBlocks = 9;
constexpr int kOwn = 5;     // blocks of E a warp owns: 5 of its pair's 9, or 4
constexpr int kPv = 33;     // a block's path sums: rows (16), columns or 2D (16), total
constexpr int kLdE = 132;   // row stride of the heads' summed E^T after the last head

// shared memory, in floats
constexpr int kTB = 0;                     // B [Q][kSR]
constexpr int kTE = kTB + Q * kSR;         // sum_h E^T in fragment order [4][kNT][32][4]
constexpr int kTCB = kTE + 4 * kNT * 128;  // B C^T in fragment order [4][kNT][32][4]
constexpr int kTX = kTCB + 4 * kNT * 128;  // xbar [Q][kSR]: C [Q][kSC] before the first
                                           // head, sum_h E^T [Q][kLdE] after the last
constexpr int kTDY = kTX + Q * kSR;        // dy [Q][kSR]
constexpr int kTG = kTDY + Q * kSR;        // G_end [P][kSR]: C [Q][kSC] after the last head
constexpr int kTH = kTG + P * kSR;         // h_start [P][kSC]
constexpr int kTDA = kTH + P * kSC;        // dA [Q]
constexpr int kTCum = kTDA + Q;            // cum [Q] float64
constexpr int kTXi = kTCum + 2 * Q;        // xi, each half's [2][Q]
constexpr int kTYo = kTXi + 2 * Q;         // yo, each half's [2][Q]
constexpr int kTPv = kTYo + 2 * Q;         // the 36 blocks' path sums [36][kPv]
constexpr int kTRv = kTPv + 36 * kPv;      // their sums over a step's tile [2][Q]
constexpr int kTRed = kTRv + 2 * Q;        // <G_end, h_start>'s warp sums, the scans' totals [16]
// the decays below the diagonal blocks, split at the first step m of the
// t-tile: exp(cum_t - cum_m) [Q], and exp(cum_m - cum_s), s < m, for m =
// 16, 32, .. 112 [448] (tile i's row at 8 i (i - 1))
constexpr int kTU = kTRed + 16;
constexpr int kTVr = kTU + Q;
constexpr int kTileFloats = kTVr + 448;
static_assert(kTCum % 2 == 0, "cum is float64");
static_assert(kTX + Q * kLdE <= kTG, "sum_h E^T fits in xbar's and dy's place");
static_assert(kTG + Q * kSC <= kTDA, "C fits in G_end's and h_start's place");

struct TileArgs {
  const float* x;    // [B, L, H, P]
  const float* dA;   // [B, L, H]
  const float* Bm;   // [B, L, N]
  const float* Cm;   // [B, L, N]
  const float* hs;   // [B, L / Q, H, P, N]: h_start of every chunk
  const float* dy;   // [B, L, H, P]
  const float* dhs;  // [B, L / Q, H, P, N]: G_end of every chunk
  float* dx;         // [B, L, H, P]
  float* ddA;        // [B, L, H]
  float* dBp;        // [B, L, H / Ht, N]: each tile's sum over its heads
  float* dCp;        // [B, L, H / Ht, N]
  int L, H, Ht;
};

__device__ __forceinline__ void zero(float (&x)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[i][j][e] = 0.f;
}

// the id (0 .. 35) of the triangle's block of s-tile j and t-tile i >= j:
// row-tile pair p = min(j, 7 - j) lists the blocks of s-tile p (t-tiles p
// .. 7), then those of s-tile 7 - p (t-tiles 7 - p .. 7)
__device__ __forceinline__ int block_id(int j, int i) {
  return j < 4 ? j * kPairBlocks + i - j : (7 - j) * kPairBlocks + 8 - (7 - j) + i - j;
}

// C [Q][kSC] from the chunk's rows of Cm, by cp.async (not committed)
__device__ __forceinline__ void issue_c(float* dst, const float* Cm, long long t0, int tid) {
  for (int idx = tid; idx < Q * 16; idx += kThreads) {
    const int row = idx >> 4, c4 = (idx & 15) * 4;
    x3::cp16(dst + row * kSC + c4, Cm + (t0 + row) * N + c4);
  }
}

__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_tile(TileArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* Bs = sm + kTB;
  float4* Ebf = reinterpret_cast<float4*>(sm + kTE);
  const float4* CBf = reinterpret_cast<const float4*>(sm + kTCB);
  float* X = sm + kTX;
  float* DY = sm + kTDY;
  float* G = sm + kTG;
  float* Hs = sm + kTH;
  float* dAs = sm + kTDA;
  double* cum = reinterpret_cast<double*>(sm + kTCum);
  float* xiv = sm + kTXi;
  float* yov = sm + kTYo;
  float* pv = sm + kTPv;
  float* rv = sm + kTRv;
  float* red = sm + kTRed;
  float* U = sm + kTU;
  float* Vr = sm + kTVr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  // this warp: row tiles ra = r and rb = 7 - r, columns n0 .. n0 + 31
  const int r = warp & 3, hf = warp >> 2, ra = r, rb = 7 - r, n0 = 32 * hf;
  const int tile = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int H = a.H, Ht = a.Ht, nc = a.L / Q;
  const long long t0 = (long long)b * a.L + (long long)c * Q;   // the chunk's first step
  const long long rowx = (long long)H * P;                     // floats between steps of x
  // this thread's rows of the warp's tiles: ra's g and g + 8, then rb's
  const int rows[4] = {16 * ra + g, 16 * ra + g + 8, 16 * rb + g, 16 * rb + g + 8};

  auto head_off = [&](int hh) {   // offset of head hh's state in hs and dhs
    return (((long long)b * nc + c) * H + tile * Ht + hh) * P * N;
  };
  auto issue_xdy = [&](int hh) {
    const long long hp = (long long)(tile * Ht + hh) * P;
    for (int idx = tid; idx < Q * 16; idx += kThreads) {
      const int row = idx >> 4, c4 = (idx & 15) * 4;
      const long long off = (t0 + row) * rowx + hp + c4;
      x3::cp16(X + row * kSR + c4, a.x + off);
      x3::cp16(DY + row * kSR + c4, a.dy + off);
    }
  };
  auto issue_gh = [&](int hh) {
    const long long so = head_off(hh);
    for (int idx = tid; idx < P * 16; idx += kThreads) {
      const int row = idx >> 4, c4 = (idx & 15) * 4;
      x3::cp16(G + row * kSR + c4, a.dhs + so + row * N + c4);
      x3::cp16(Hs + row * kSC + c4, a.hs + so + row * N + c4);
    }
    if (tid < Q) x3::cp4(dAs + tid, a.dA + (t0 + tid) * H + tile * Ht + hh);
  };
  // B, and C in xbar's place until B C^T is taken
  for (int idx = tid; idx < Q * 16; idx += kThreads) {
    const int row = idx >> 4, c4 = (idx & 15) * 4;
    x3::cp16(Bs + row * kSR + c4, a.Bm + (t0 + row) * N + c4);
  }
  issue_c(X, a.Cm, t0, tid);
  x3::cp_commit();
  x3::cp_wait<0>();
  __syncthreads();

  // B C^T [s][t] over this pair's blocks, once for every head: entry e of
  // the pair is row tile ra, n8 tile 2r + e for e < 16 - 2r, else row tile
  // rb, n8 tile e - 2; the pair's two warps take nine entries each.  Entry
  // 2 l + j is n8 tile j of the pair's block l.
  {
    const float* Cs = X;
    float cb[9][4];
#pragma unroll
    for (int s2 = 0; s2 < 9; ++s2)
#pragma unroll
      for (int e = 0; e < 4; ++e) cb[s2][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const x3::Frag<4> fa = x3::a_rows(Bs, kSR, 16 * ra, 16 * kk, g, q);
      const x3::Frag<4> fb = x3::a_rows(Bs, kSR, 16 * rb, 16 * kk, g, q);
#pragma unroll
      for (int s2 = 0; s2 < 9; ++s2) {
        const int e = 9 * hf + s2;
        const bool in_a = e < 16 - 2 * r;
        const x3::Frag<2> bf = x3::b_cols(Cs, kSC, 8 * (in_a ? 2 * r + e : e - 2) + g, 16 * kk, q);
        if (in_a) {
          x3::mma_add(cb[s2], fa, bf);
        } else {
          x3::mma_add(cb[s2], fb, bf);
        }
      }
    }
    float4* cbw = reinterpret_cast<float4*>(sm + kTCB);
#pragma unroll
    for (int s2 = 0; s2 < 9; ++s2) {
      const int e = (r * kNT + 9 * hf + s2) * 32 + lane;
      cbw[e] = make_float4(cb[s2][0], cb[s2][1], cb[s2][2], cb[s2][3]);
      Ebf[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();  // C is done with: the first head goes in
  issue_xdy(0);
  issue_gh(0);
  x3::cp_commit();

  // dB's and dC's sums over the tile's heads, this warp's rows and columns
  float dBs[2][4][4], dCs[2][4][4];
  zero(dBs);
  zero(dCs);

  for (int hh = 0; hh < Ht; ++hh) {
    const int h = tile * Ht + hh;
    x3::cp_wait<0>();
    __syncthreads();  // head hh has landed; the previous head is done

    // cum (warp 0); <G_end, h_start>
    if (warp == 0) {
      double v[4];
      chunk_cum(dAs, lane, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) cum[4 * lane + k] = v[k];
    }
    {
      float z = 0.f;
      for (int e = tid; e < P * N; e += kThreads) {
        z = fmaf(G[(e >> 6) * kSR + (e & 63)], Hs[(e >> 6) * kSC + (e & 63)], z);
      }
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) z += __shfl_xor_sync(0xffffffffu, z, d);
      if (lane == 0) red[warp] = z;
    }
    __syncthreads();
    const double cq = cum[Q - 1];
    // below a diagonal block every s is before every t, so W_ts = exp(cum_t
    // - cum_m) exp(cum_m - cum_s), m the t-tile's first step, both factors
    // <= 1 (nothing overflows; a factor that underflows stands for an entry
    // smaller still): 576 exps a head in place of one an entry (read after
    // the next barrier)
    for (int i = tid; i < Q + 448; i += kThreads) {
      if (i < Q) {
        U[i] = expf((float)(cum[i] - cum[i & ~15]));
      } else {
        const int j = i - Q;
        int m = 1;
        while (8 * m * (m + 1) <= j) ++m;
        Vr[j] = expf((float)(cum[16 * m] - cum[j - 8 * m * (m - 1)]));
      }
    }
    float ec[4], eq[4];  // exp(cum_t) and exp(cum_Q - cum_s) of this thread's rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ec[i] = expf((float)cum[rows[i]]);
      eq[i] = expf((float)(cq - cum[rows[i]]));
    }

    // dC's boundary term exp(cum_t) (dy h_start), into the heads' sum;
    // yo_t = its row t . C_t, this half's columns
    {
      float acc[2][4][4];
      zero(acc);
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        const x3::Frag<4> fr[2] = {x3::a_rows(DY, kSR, 16 * ra, 16 * kk, g, q),
                                   x3::a_rows(DY, kSR, 16 * rb, 16 * kk, g, q)};
        x3::Frag<2> bf[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) bf[nt] = x3::b_rows(Hs, kSC, 16 * kk, n0 + 8 * nt + g, q);
        x3::mma_add_outer<2, 4>(acc, fr, bf);
      }
#pragma unroll
      for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int t = rows[2 * rt + hr];
          const float* cp = a.Cm + (t0 + t) * N + n0 + 2 * q;
          float d = 0.f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const float2 cv = __ldg(reinterpret_cast<const float2*>(cp + 8 * nt));
            const float v0 = acc[rt][nt][2 * hr] * ec[2 * rt + hr];
            const float v1 = acc[rt][nt][2 * hr + 1] * ec[2 * rt + hr];
            d = fmaf(v0, cv.x, d);
            d = fmaf(v1, cv.y, d);
            dCs[rt][nt][2 * hr] += v0;
            dCs[rt][nt][2 * hr + 1] += v1;
          }
          d += __shfl_xor_sync(0xffffffffu, d, 1);
          d += __shfl_xor_sync(0xffffffffu, d, 2);
          if (q == 0) yov[hf * Q + t] = d;
        }
      }
    }
    // dB's boundary term exp(cum_Q - cum_s) (xbar G_end), into the heads' sum
    {
      float acc[2][4][4];
      zero(acc);
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        const x3::Frag<4> fr[2] = {x3::a_rows(X, kSR, 16 * ra, 16 * kk, g, q),
                                   x3::a_rows(X, kSR, 16 * rb, 16 * kk, g, q)};
        x3::Frag<2> bf[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) bf[nt] = x3::b_rows(G, kSR, 16 * kk, n0 + 8 * nt + g, q);
        x3::mma_add_outer<2, 4>(acc, fr, bf);
      }
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dBs[rt][nt][e] += acc[rt][nt][e] * eq[2 * rt + (e >> 1)];
    }
    // dxbar's boundary term exp(cum_Q - cum_s) (B G_end^T); xi_s = its row
    // s . xbar_s, this half's columns
    float dx[2][4][4];
    zero(dx);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const x3::Frag<4> fr[2] = {x3::a_rows(Bs, kSR, 16 * ra, 16 * kk, g, q),
                                 x3::a_rows(Bs, kSR, 16 * rb, 16 * kk, g, q)};
      x3::Frag<2> bf[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) bf[nt] = x3::b_cols(G, kSR, n0 + 8 * nt + g, 16 * kk, q);
      x3::mma_add_outer<2, 4>(dx, fr, bf);
    }
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int s = rows[2 * rt + hr];
        float d = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float2 xv = *reinterpret_cast<const float2*>(X + s * kSR + n0 + 8 * nt + 2 * q);
          dx[rt][nt][2 * hr] *= eq[2 * rt + hr];
          dx[rt][nt][2 * hr + 1] *= eq[2 * rt + hr];
          d = fmaf(dx[rt][nt][2 * hr], xv.x, d);
          d = fmaf(dx[rt][nt][2 * hr + 1], xv.y, d);
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        if (q == 0) xiv[hf * Q + s] = d;
      }
    }
    __syncthreads();  // G_end, h_start and dA are free: the next head's go in
    if (hh + 1 < Ht) issue_gh(hh + 1);
    x3::cp_commit();

    // W^T of n8 tile j of the block of s-tile st and t-tile tt at this
    // thread's four entries: split at the t-tile's first step below the
    // diagonal, an exp an entry on it (none above the diagonal)
    auto weights = [&](float (&w)[4], int st, int tt, int j) {
      const int s = 16 * st + g, t = 16 * tt + 8 * j + 2 * q;
      if (tt > st) {
        const float* vr = Vr + 8 * tt * (tt - 1);
        const float v0 = vr[s], v1 = vr[s + 8];
        const float2 u = *reinterpret_cast<const float2*>(U + t);
        w[0] = v0 * u.x;
        w[1] = v0 * u.y;
        w[2] = v1 * u.x;
        w[3] = v1 * u.y;
      } else {
        const double cs0 = cum[s], cs1 = cum[s + 8], ct0 = cum[t], ct1 = cum[t + 1];
        w[0] = s <= t ? expf((float)(ct0 - cs0)) : 0.f;
        w[1] = s <= t + 1 ? expf((float)(ct1 - cs0)) : 0.f;
        w[2] = s + 8 <= t ? expf((float)(ct0 - cs1)) : 0.f;
        w[3] = s + 8 <= t + 1 ? expf((float)(ct1 - cs1)) : 0.f;
      }
    };
    // W^T o (B C^T) of n8 tile j of the pair's block l (s-tile st, t-tile
    // tt) at this thread's four entries
    auto mt_tile = [&](float (&w)[4], int st, int tt, int l, int j) {
      const float4 v = CBf[(r * kNT + 2 * l + j) * 32 + lane];
      weights(w, st, tt, j);
      w[0] *= v.x;
      w[1] *= v.y;
      w[2] *= v.z;
      w[3] *= v.w;
    };
    // M^T's A fragment of block l: rows of s-tile st, k = t-tile tt
    auto mt_frag = [&](int st, int tt, int l) {
      float w0[4], w1[4];
      mt_tile(w0, st, tt, l, 0);
      mt_tile(w1, st, tt, l, 1);
      const float lo[4] = {w0[0], w0[2], w1[0], w1[2]};
      const float hi[4] = {w0[1], w0[3], w1[1], w1[3]};
      return x3::frag(lo, hi);
    };

    // dxbar's intra-chunk term M^T dy: t-tile m's dy fragments, split once
    // for both row tiles
#pragma unroll 1
    for (int m = r; m < 8; ++m) {
      x3::Frag<2> df[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) df[nt] = x3::b_rows(DY, kSR, 16 * m, n0 + 8 * nt + g, q);
      if (m >= rb) {
        const x3::Frag<4> mf[2] = {mt_frag(ra, m, m - r), mt_frag(rb, m, 8 - r + m - rb)};
        x3::mma_add_outer<2, 4>(dx, mf, df);
      } else {
        x3::mma_add_n<4>(dx[0], mt_frag(ra, m, m - r), df);
      }
    }
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float* dp = a.dx + (t0 + rows[2 * rt + hr]) * rowx + (long long)h * P + n0 + 2 * q;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          *reinterpret_cast<float2*>(dp + 8 * nt) =
              make_float2(dx[rt][nt][2 * hr], dx[rt][nt][2 * hr + 1]);
        }
      }
    }

    // E^T = W^T o (xbar dy^T) over this warp's blocks of the triangle
    // (blocks 5 hf .. of the pair's 9), into the heads' sum (each thread's
    // own fragment entries); F^T = (B C^T) o E^T strictly above the
    // diagonal, and its path sums: each row's sum over t, each column's
    // over s and the block's total (a block off the diagonal), or each
    // step x's sum over s < x <= t (a diagonal block)
#pragma unroll 1
    for (int bi = 0; bi < kOwn; ++bi) {
      const int l = kOwn * hf + bi;
      if (l >= kPairBlocks) break;
      const bool in_a = l < 8 - r;
      const int st = in_a ? ra : rb, tt = in_a ? r + l : l - 1;
      float z[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int k2 = 0; k2 < P / 32; ++k2) {
        const x3::Frag<4> fx[2] = {x3::a_rows(X, kSR, 16 * st, 32 * k2, g, q),
                                   x3::a_rows(X, kSR, 16 * st, 32 * k2 + 16, g, q)};
        x3::Frag<2> bd[2][2];
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            bd[kh][j] = x3::b_cols(DY, kSR, 16 * tt + 8 * j + g, 32 * k2 + 16 * kh, q);
        x3::mma_add_k<2, 2>(z, fx, bd);
      }
      float f[2][4];
      float rs0 = 0.f, rs1 = 0.f;  // rows g, g + 8
      const int s = 16 * st + g;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int fe = (r * kNT + 2 * l + j) * 32 + lane;
        const float4 v = CBf[fe];
        const float cbv[4] = {v.x, v.y, v.z, v.w};
        const int t = 16 * tt + 8 * j + 2 * q;
        float ev[4];
        weights(ev, st, tt, j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int si = s + 8 * (e >> 1), ti = t + (e & 1);
          ev[e] *= z[j][e];
          f[j][e] = si < ti ? cbv[e] * ev[e] : 0.f;
        }
        float4 eb = Ebf[fe];
        eb.x += ev[0];
        eb.y += ev[1];
        eb.z += ev[2];
        eb.w += ev[3];
        Ebf[fe] = eb;
        rs0 += f[j][0] + f[j][1];
        rs1 += f[j][2] + f[j][3];
      }
      float* out = pv + block_id(st, tt) * kPv;
      if (st != tt) {
        // rows: over q; columns: over g; the total: over the warp
        float tot = rs0 + rs1;
#pragma unroll
        for (int d = 1; d <= 2; d <<= 1) {
          rs0 += __shfl_xor_sync(0xffffffffu, rs0, d);
          rs1 += __shfl_xor_sync(0xffffffffu, rs1, d);
        }
#pragma unroll
        for (int d = 1; d <= 16; d <<= 1) tot += __shfl_xor_sync(0xffffffffu, tot, d);
        float cs[4] = {f[0][0] + f[0][2], f[0][1] + f[0][3], f[1][0] + f[1][2],
                       f[1][1] + f[1][3]};
#pragma unroll
        for (int d = 4; d <= 16; d <<= 1) {
#pragma unroll
          for (int i = 0; i < 4; ++i) cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], d);
        }
        if (q == 0) {
          out[g] = rs0;
          out[g + 8] = rs1;
        }
        if (g == 0) {
          out[16 + 2 * q] = cs[0];
          out[16 + 2 * q + 1] = cs[1];
          out[16 + 8 + 2 * q] = cs[2];
          out[16 + 8 + 2 * q + 1] = cs[3];
        }
        if (lane == 0) out[32] = tot;
      } else {
        // x's sum over the entries s < x <= t (s = the local row, t the
        // local column), then over the warp
        float dd[16];
#pragma unroll
        for (int x = 0; x < 16; ++x) {
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int sl = g + 8 * (e >> 1), tl = 8 * j + 2 * q + (e & 1);
              if (sl < x && x <= tl) acc += f[j][e];
            }
          dd[x] = acc;
        }
#pragma unroll
        for (int d = 1; d <= 16; d <<= 1) {
#pragma unroll
          for (int x = 0; x < 16; ++x) dd[x] += __shfl_xor_sync(0xffffffffu, dd[x], d);
        }
#pragma unroll
        for (int x = 0; x < 16; ++x) {
          if (lane == x) out[16 + x] = dd[x];
        }
      }
    }
    __syncthreads();  // xbar and dy are free: the next head's go in
    if (hh + 1 < Ht) issue_xdy(hh + 1);
    x3::cp_commit();

    // ddA_x = exp(cum_Q) <G_end, h_start> + sum_{t>=x} yo_t + sum_{j<x} xi_j
    //         + sum_{j<x<=t} F_tj: threads 0 .. 127, x = tid, k = x's tile.
    // The F sums: blocks (s-tile k, t-tile i > k) add their rows' sums
    // over s < x (rv: summed over i first), blocks (s-tile j < k, t-tile
    // k) their columns' sums over t >= x (rv + Q), blocks j < k < i their
    // totals, the diagonal block its own.
    float yo = 0.f, xi = 0.f;  // the warp's scans, kept across the barrier
    if (tid < Q) {
      const int x = tid, k = x >> 4, xl = x & 15;
      float rsum = 0.f, csum = 0.f;
      for (int i = k + 1; i < 8; ++i) rsum += pv[block_id(k, i) * kPv + xl];
      for (int j = 0; j < k; ++j) csum += pv[block_id(j, k) * kPv + 16 + xl];
      rv[x] = rsum;
      rv[Q + x] = csum;
      // sum_{t>=x} yo_t in the warp, from its end; sum_{j<x} xi_j in the
      // warp, as the inclusive sum of xi_{x-1}
      yo = yov[x] + yov[Q + x];
      xi = x > 0 ? xiv[x - 1] + xiv[Q + x - 1] : 0.f;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, yo, d);
        if (lane + d < 32) yo += o;
        const float p = __shfl_up_sync(0xffffffffu, xi, d);
        if (lane >= d) xi += p;
      }
      if (lane == 0) red[8 + warp] = yo;
      if (lane == 31) red[12 + warp] = xi;
    }
    __syncthreads();
    if (tid < Q) {
      const int x = tid, k = x >> 4;
      float strad = pv[block_id(k, k) * kPv + 16 + (x & 15)];
      for (int y = 16 * k; y < x; ++y) strad += rv[y];
      for (int y = x; y < 16 * k + 16; ++y) strad += rv[Q + y];
      for (int j = 0; j < k; ++j)
        for (int i = k + 1; i < 8; ++i) strad += pv[block_id(j, i) * kPv + 32];
      for (int w = warp + 1; w < 4; ++w) yo += red[8 + w];
      for (int w = 0; w < warp; ++w) xi += red[12 + w];
      float gh = 0.f;
      for (int w = 0; w < 8; ++w) gh += red[w];
      a.ddA[(t0 + x) * H + h] = expf((float)cq) * gh + strad + yo + xi;
    }
  }

  // dB += (sum_h E^T) C and dC += (sum_h E) B, the triangle's blocks only:
  // sum_h E^T spread out as a matrix over xbar and dy, C in G_end's place
  __syncthreads();  // every warp is done with the last head
  issue_c(G, a.Cm, t0, tid);
  x3::cp_commit();
  float* EbT = X;   // [Q][kLdE]
  for (int bi = 0; bi < kOwn; ++bi) {
    const int l = kOwn * hf + bi;
    if (l >= kPairBlocks) break;
    const bool in_a = l < 8 - r;
    const int st = in_a ? ra : rb, tt = in_a ? r + l : l - 1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 v = Ebf[(r * kNT + 2 * l + j) * 32 + lane];
      const int s = 16 * st + g, t = 16 * tt + 8 * j + 2 * q;
      *reinterpret_cast<float2*>(EbT + s * kLdE + t) = make_float2(v.x, v.y);
      *reinterpret_cast<float2*>(EbT + (s + 8) * kLdE + t) = make_float2(v.z, v.w);
    }
  }
  x3::cp_wait<0>();
  __syncthreads();
  const float* Cs = G;
#pragma unroll 1
  for (int m = r; m < 8; ++m) {  // t-tile
    x3::Frag<2> cf[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) cf[nt] = x3::b_rows(Cs, kSC, 16 * m, n0 + 8 * nt + g, q);
    if (m >= rb) {
      const x3::Frag<4> fr[2] = {x3::a_rows(EbT, kLdE, 16 * ra, 16 * m, g, q),
                                 x3::a_rows(EbT, kLdE, 16 * rb, 16 * m, g, q)};
      x3::mma_add_outer<2, 4>(dBs, fr, cf);
    } else {
      x3::mma_add_n<4>(dBs[0], x3::a_rows(EbT, kLdE, 16 * ra, 16 * m, g, q), cf);
    }
  }
#pragma unroll 1
  for (int m = 0; m <= rb; ++m) {  // s-tile
    x3::Frag<2> bf[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) bf[nt] = x3::b_rows(Bs, kSR, 16 * m, n0 + 8 * nt + g, q);
    if (m <= ra) {
      const x3::Frag<4> fr[2] = {x3::a_cols(EbT, kLdE, 16 * ra, 16 * m, g, q),
                                 x3::a_cols(EbT, kLdE, 16 * rb, 16 * m, g, q)};
      x3::mma_add_outer<2, 4>(dCs, fr, bf);
    } else {
      x3::mma_add_n<4>(dCs[1], x3::a_cols(EbT, kLdE, 16 * rb, 16 * m, g, q), bf);
    }
  }
  const int ntl = H / Ht;
#pragma unroll
  for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const long long o = ((t0 + rows[2 * rt + hr]) * ntl + tile) * N + n0 + 2 * q;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        *reinterpret_cast<float2*>(a.dBp + o + 8 * nt) =
            make_float2(dBs[rt][nt][2 * hr], dBs[rt][nt][2 * hr + 1]);
        *reinterpret_cast<float2*>(a.dCp + o + 8 * nt) =
            make_float2(dCs[rt][nt][2 * hr], dCs[rt][nt][2 * hr + 1]);
      }
    }
  }
}

}  // namespace

extern "C" {

// dynamic shared memory of ssd_bwd_state (0) and ssd_bwd_tile (1), bytes
int mamba2_ssd_bwd_smem_bytes(int kernel) {
  return (int)((kernel == 0 ? kStFloats : kTileFloats) * sizeof(float));
}

// xbar, dy [B, L, H, 64], dA [B, L, H], B and C [B, L, 64], hs [B, L / 128,
// H, 64, 64] (the forward's chunk-start states), dh_final [B, H, 64, 64] or
// null; scratch dhs like hs; outputs dxbar [B, L, H, 64], ddA [B, L, H],
// and each tile of Ht heads' share of dB and dC, [B, L, H / Ht, 64]; all
// contiguous float32, L a multiple of 128, Ht a divisor of H.  Returns
// cudaGetLastError() after the second launch.
int mamba2_ssd_bwd_launch(const float* x, const float* dA, const float* Bm, const float* Cm,
                          const float* hs, const float* dy, const float* dh, float* dhs,
                          float* dx, float* ddA, float* dBp, float* dCp, int B, int L, int H,
                          int Ht, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || Ht <= 0 || H % Ht != 0 || L % Q != 0 || B > 65535 ||
      L / Q > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem1 = (size_t)kStFloats * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(ssd_bwd_state, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  const StateArgs sa{dA, Cm, dy, dh, dhs, L, H};
  ssd_bwd_state<<<dim3((unsigned)H, (unsigned)B), kStThreads, smem1, st>>>(sa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = (size_t)kTileFloats * sizeof(float);
  err = cudaFuncSetAttribute(ssd_bwd_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const TileArgs ta{x, dA, Bm, Cm, hs, dy, dhs, dx, ddA, dBp, dCp, L, H, Ht};
  ssd_bwd_tile<<<dim3((unsigned)(H / Ht), (unsigned)(L / Q), (unsigned)B), kThreads, smem2,
                 st>>>(ta);
  return (int)cudaGetLastError();
}

}  // extern "C"
