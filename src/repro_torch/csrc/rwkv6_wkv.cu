// rwkv6_wkv: the RWKV6 ("Finch") WKV recurrence, per batch row b and head h,
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,   y_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t,
// in chunks of Q = 16 steps.  With cwx_t the sum of the log-decays before
// step t inside the chunk and cw_j the sum through step j:
//   y_t   = (r_t exp(cwx_t)) h_start + sum_{j<t} A_tj v_j + (r_t . u k_t) v_t,
//   A_tj  = sum_c r_tc k_jc exp(cwx_tc - cw_jc),
//   h_end = exp(cw_Q) h_start + sum_j (k_j exp(cw_Q - cw_j)) v_j^T,
// with r, k, v, logw [B, T, H, C] (logw <= 0), u [H, C], the state
// h [B, H, C, V], C = V = 64, everything float32.
//
// Replaces the Pallas kernel wkv6_pallas (_wkv_kernel) of
// src/repro/kernels/rwkv6_wkv/kernel.py.  On the TPU the chunk axis was the
// innermost, sequential grid dimension and the [C, V] state lived in VMEM
// scratch from one grid step to the next.  CTAs run in no order, so here one
// CTA owns (b, h) and walks the chunks (256 CTAs of 105 KB at the serving
// shape, all resident on 132 SMs).  r, k, v and logw are read in the
// model's [B, T, H, C] layout: a head's 64 floats are one 256-byte row.
//
// Bound on the H100 at rwkv6-1.6b's prefill shape (B 8, T 2048, H 32):
// r, k, v, logw and y are 0.671 GB, 0.200 ms at 3.35 TB/s; the three
// products on the tensor cores are 9.7 GFLOP, which the split below runs
// six times at the bf16 rate (0.059 ms at 989 TFLOP/s), and A, the decays
// and the prefix sums about 2.4 GFLOP of float32 and float64 arithmetic
// (0.036 ms at 67 TFLOP/s).  So: bytes.
//
// Only two products depend on the state: the inter-chunk term
// (r exp(cwx)) h_start and the update exp(cw_Q) h + kdec^T v.  Everything
// else of a chunk can be computed ahead of it.  Design, warp-specialised:
//  * 4 producer warps: cp.async brings each chunk's r, k, v and logw into a
//    ring of 3 raw slots, 2 chunks ahead.  Per chunk they take the prefix
//    sums of the log-decay (float64, one thread a channel), the bonus
//    r_t . (u k_t), the decayed operands rdec = r exp(cwx) and kdec =
//    k exp(cw_Q - cw), exp(cw_Q), and A over the 120 strictly lower pairs,
//    with the bonus on its diagonal (A'), and hand them to the consumers
//    through 3 slots (named barriers full and empty: bar.arrive by the side
//    that gives, bar.sync by the side that waits).
//  * A's 64 pairs across the chunk's halves (j < 8 <= t) split the decay
//    at step 8: exp(cwx_t - cw_j) = exp(cwx_t - cum_8) exp(cum_8 - cw_j),
//    both factors <= 1, so they are dot products of r and k scaled once
//    per row (1,024 exps in place of 4,096); the 56 pairs inside a half take
//    an exp a channel.
//  * 4 consumer warps hold the state in MMA accumulators, transposed (a
//    warp owns 16 value rows of S^T by all 64 key columns), and run the
//    products on mma.sync.m16n8k16 with each float32 operand in three bf16
//    pieces (mma_x3.cuh): y_inter [16 x 64] = rdec [16 x 64] S, whose B
//    operand is the accumulators themselves (two key tiles of S^T side by
//    side are S's B fragment over 16 keys); the intra-chunk term A' v; and
//    S^T <- S^T diag(exp(cw_Q)) + v^T kdec ([64 x 16] by [16 x 64]), whose
//    A fragment is made of A' v's B fragments.  y is written once.  The
//    tensor cores round toward zero as they accumulate, so each sum starts
//    from zero in its own accumulators (a k-step of 16 terms) and is added
//    in float32: the chunk's state term joins exp(cw_Q) h with one fmaf, as
//    the plain version adds it.
//  * Precision as before: a step's log-decay reaches -87.5 at the
//    wrapper's 1e-38 clamp, so a chunk's prefix sum reaches about -1400,
//    where the float32 difference of two prefix sums keeps none of the bits
//    of a small exponent.  The prefix sums and the pairwise differences
//    are float64; each exponent is rounded to float32 once before expf.
//    Every exponent is <= 0: nothing overflows.  The strict triangle
//    j < t is a selection: only those pairs are formed.
//  * A slot's rows are padded to 72 floats (A' to 24) where a fragment
//    reads 8-byte pairs along a row and to 68 where it reads two rows of a
//    column, so that each fragment load hits 32 distinct banks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_x3.cuh"

namespace {

constexpr int Q = 16;   // chunk
constexpr int C = 64;   // key dim (head dim)
constexpr int V = 64;   // value dim
constexpr int kWarps = 8;            // 4 consumers, then 4 producers
constexpr int kThreads = 32 * kWarps;
constexpr int kProducers = 128;
constexpr int kRawSlots = 3;
constexpr int kSlots = 3;
constexpr int kHalf = Q / 2;
constexpr int kWithin = 2 * kHalf * (kHalf - 1) / 2;  // pairs inside a half: 56
// row strides (floats) of a slot's arrays: 72 where a fragment reads 8-byte
// pairs along a row, 68 where it reads rows 2t and 2t + 1 of one column
constexpr int kPR = 72;                   // rdec
constexpr int kPK = 68;                   // kdec and v
constexpr int kAS = 24;                   // A'

// shared memory layout, in floats (cum first: float64)
constexpr int kCum = 0;                          // cum [Q + 1][C] float64: cum[t] = sum_{s<t} logw_s
constexpr int kRaw = kCum + 2 * (Q + 1) * C;     // raw slots: r, k, v, logw [Q][C] each
constexpr int kRawR = 0, kRawK = Q * C, kRawV = 2 * Q * C, kRawW = 3 * Q * C;
constexpr int kRawSlot = 4 * Q * C;
constexpr int kSlot0 = kRaw + kRawSlots * kRawSlot;
constexpr int kRdec = 0;                // r exp(cwx) [Q][kPR]
constexpr int kKdec = kRdec + Q * kPR;  // k exp(cw_Q - cw) [Q][kPK]
constexpr int kVs = kKdec + Q * kPK;    // v [Q][kPK]
constexpr int kAp = kVs + Q * kPK;      // A' [Q][kAS]: A below the diagonal, the bonus on it
constexpr int kCdec = kAp + Q * kAS;    // exp(cw_Q) [C]
constexpr int kSlot = kCdec + C;
constexpr int kRt = kSlot0 + kSlots * kSlot;  // r_t exp(cwx_t - cum_8), t >= 8 [8][C]
constexpr int kKt = kRt + kHalf * C;          // k_j exp(cum_8 - cw_j), j < 8 [8][C]
constexpr int kBonus = kKt + kHalf * C;       // r_t . u k_t [Q]
constexpr int kU = kBonus + Q;                // u [C]
constexpr int kSmemFloats = kU + C;

// named barriers (0 is __syncthreads')
constexpr int kBarProducers = 1;
constexpr int kBarFull = 2;               // + slot
constexpr int kBarEmpty = kBarFull + kSlots;

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  const float* h0;  // may be null: start from zeros
  float* y;
  float* h;
  float* hs;        // may be null: the state at every chunk's start [B, T / Q, H, C, V]
  int T, H;
};

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// the (t, j) pair of a strictly lower index q of a [n, n] triangle
__device__ __forceinline__ void lower_pair(int q, int& t, int& j) {
  t = 1;
  while ((t + 1) * t / 2 <= q) ++t;
  j = q - t * (t - 1) / 2;
}

// the producers: everything of a chunk that does not depend on the state
__device__ __forceinline__ void produce(const Args& a, float* sm, int p) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int H = a.H;
  const long long T = a.T;
  const int nc = a.T / Q;
  const long long row = (long long)H * C;   // floats between steps
  const long long base = ((long long)b * T * H + h) * C;
  double* cum = reinterpret_cast<double*>(sm + kCum);
  float* rt8 = sm + kRt;
  float* kt8 = sm + kKt;
  float* bonus = sm + kBonus;
  const float* us = sm + kU;

  auto issue = [&](int c) {
    if (c < nc) {
      float* rs = sm + kRaw + (c % kRawSlots) * kRawSlot;
      const long long off = base + (long long)c * Q * row;
      for (int e = p; e < Q * C / 4; e += kProducers) {
        const int tt = e >> 4, c4 = (e & 15) * 4;
        const long long src = off + tt * row + c4;
        x3::cp16(rs + kRawR + tt * C + c4, a.r + src);
        x3::cp16(rs + kRawK + tt * C + c4, a.k + src);
        x3::cp16(rs + kRawV + tt * C + c4, a.v + src);
        x3::cp16(rs + kRawW + tt * C + c4, a.lw + src);
      }
    }
    x3::cp_commit();
  };

  // A's pairs, two threads a pair, 32 channels each.  A cross pair
  // (t >= 8 > j): t = 8 + (q >> 3), j = q & 7.  A pair inside a half: the
  // strictly lower pair of the 8 x 8 triangle, in the lower half or (q >=
  // 28) the upper one; 112 of the 128 threads.
  const int half = p & 1;
  const int ct = kHalf + ((p >> 1) >> 3), cj = (p >> 1) & 7;
  const bool within = (p >> 1) < kWithin;
  int wt = 0, wj = 0;
  if (within) {
    const int q = (p >> 1) % (kWithin / 2), hb = (p >> 1) / (kWithin / 2);
    lower_pair(q, wt, wj);
    wt += kHalf * hb;
    wj += kHalf * hb;
  }
  const int stagger = ((p >> 1) + 16 * half) & 31;
  // the bonus: four threads a step, 16 channels each
  const int bt = (p - 64) >> 2, bpart = (p - 64) & 3;

#pragma unroll
  for (int s = 0; s < kRawSlots - 1; ++s) issue(s);

  for (int c = 0; c < nc; ++c) {
    x3::cp_wait<kRawSlots - 2>();
    bar_sync(kBarProducers, kProducers);  // chunk c has landed; chunk c - 1 is done
    issue(c + kRawSlots - 1);
    const float* rs = sm + kRaw + (c % kRawSlots) * kRawSlot;
    const float* r = rs + kRawR;
    const float* k = rs + kRawK;
    const float* lw = rs + kRawW;

    if (p < C) {  // prefix sums of the log-decay, one channel a thread, float64
      double s = 0.0;
      cum[p] = 0.0;
#pragma unroll
      for (int tt = 0; tt < Q; ++tt) {
        s += (double)lw[tt * C + p];
        cum[(tt + 1) * C + p] = s;
      }
    } else {  // the bonus r_t . (u k_t)
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int ch = 16 * bpart + ((i + bt) & 15);
        acc = fmaf(r[bt * C + ch] * us[ch], k[bt * C + ch], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (bpart == 0) bonus[bt] = acc;
    }
    bar_sync(kBarProducers, kProducers);

    const int ps = c % kSlots;
    if (c >= kSlots) bar_sync(kBarEmpty + ps, kThreads);  // the consumers are done with it
    float* sl = sm + kSlot0 + ps * kSlot;
    // r exp(cwx), k exp(cw_Q - cw) and v, one float4 of each per round; and
    // the cross pairs' operands, split at the half: exp(cwx_t - cw_j) =
    // exp(cwx_t - cum_8) exp(cum_8 - cw_j) for j < 8 <= t, both factors <= 1
#pragma unroll
    for (int rd = 0; rd < Q * C / 4 / kProducers; ++rd) {
      const int e = p + kProducers * rd;
      const int tt = e >> 4, c4 = (e & 15) * 4;
      const float4 rv = ld4(r + tt * C + c4), kv = ld4(k + tt * C + c4);
      const double* cx = cum + tt * C + c4;
      const double* cw = cum + (tt + 1) * C + c4;
      const double* cq = cum + Q * C + c4;
      const double* c8 = cum + kHalf * C + c4;
      float4 rd4, kd4;
      rd4.x = rv.x * expf((float)cx[0]);
      rd4.y = rv.y * expf((float)cx[1]);
      rd4.z = rv.z * expf((float)cx[2]);
      rd4.w = rv.w * expf((float)cx[3]);
      kd4.x = kv.x * expf((float)(cq[0] - cw[0]));
      kd4.y = kv.y * expf((float)(cq[1] - cw[1]));
      kd4.z = kv.z * expf((float)(cq[2] - cw[2]));
      kd4.w = kv.w * expf((float)(cq[3] - cw[3]));
      *reinterpret_cast<float4*>(sl + kRdec + tt * kPR + c4) = rd4;
      *reinterpret_cast<float4*>(sl + kKdec + tt * kPK + c4) = kd4;
      *reinterpret_cast<float4*>(sl + kVs + tt * kPK + c4) = ld4(rs + kRawV + tt * C + c4);
      if (tt >= kHalf) {
        *reinterpret_cast<float4*>(rt8 + (tt - kHalf) * C + c4) =
            make_float4(rv.x * expf((float)(cx[0] - c8[0])), rv.y * expf((float)(cx[1] - c8[1])),
                        rv.z * expf((float)(cx[2] - c8[2])), rv.w * expf((float)(cx[3] - c8[3])));
      } else {
        *reinterpret_cast<float4*>(kt8 + tt * C + c4) =
            make_float4(kv.x * expf((float)(c8[0] - cw[0])), kv.y * expf((float)(c8[1] - cw[1])),
                        kv.z * expf((float)(c8[2] - cw[2])), kv.w * expf((float)(c8[3] - cw[3])));
      }
    }
    if (p < C) sl[kCdec + p] = expf((float)cum[Q * C + p]);
    if (p < Q) sl[kAp + p * kAS + p] = bonus[p];
    bar_sync(kBarProducers, kProducers);

    // A_tj = sum_c r_tc k_jc exp(cwx_tc - cw_jc), j < t, into A' below the
    // diagonal.  Cross pairs: a dot product of the split operands.  Pairs
    // inside a half: an exp of a float64 difference per channel.  Every lane
    // takes part in the pair's shuffle; lanes past the pairs add 0.
    {
      const float* ra = rt8 + (ct - kHalf) * C + 32 * half;
      const float* ka = kt8 + cj * C + 32 * half;
      float acc = 0.f;
#pragma unroll 8
      for (int i = 0; i < 32; ++i) {
        const int ch = (i + stagger) & 31;
        acc = fmaf(ra[ch], ka[ch], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) sl[kAp + ct * kAS + cj] = acc;
    }
    {
      float acc = 0.f;
      if (within) {
        const double* cx = cum + wt * C + 32 * half;
        const double* cw = cum + (wj + 1) * C + 32 * half;
        const float* rt = r + wt * C + 32 * half;
        const float* kj = k + wj * C + 32 * half;
#pragma unroll 8
        for (int i = 0; i < 32; ++i) {
          const int ch = (i + stagger) & 31;
          acc = fmaf(rt[ch] * kj[ch], expf((float)(cx[ch] - cw[ch])), acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (within && half == 0) sl[kAp + wt * kAS + wj] = acc;
    }
    bar_arrive(kBarFull + ps, kThreads);
  }
  x3::cp_wait<0>();
}

// the consumers: the state and its two products; warp w owns S^T's value
// rows 16w .. 16w + 15
__device__ __forceinline__ void consume(const Args& a, float* sm, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int H = a.H;
  const long long T = a.T;
  const int nc = a.T / Q;
  const int v0 = 16 * warp;
  const long long hoff = ((long long)b * H + h) * C * V;

  // S^T [v][c] in accumulators: tile m covers key columns 8m .. 8m + 7;
  // st[m] = (v0 + g, 8m + 2t), (v0 + g, 8m + 2t + 1), (v0 + g + 8, 8m + 2t), ...
  float st[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int c0 = 8 * m + 2 * t;
    if (a.h0) {
      const float* hp = a.h0 + hoff;
      st[m][0] = hp[c0 * V + v0 + g];
      st[m][1] = hp[(c0 + 1) * V + v0 + g];
      st[m][2] = hp[c0 * V + v0 + g + 8];
      st[m][3] = hp[(c0 + 1) * V + v0 + g + 8];
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[m][e] = 0.f;
    }
  }

  for (int c = 0; c < nc; ++c) {
    if (a.hs) {  // the chunk's start state, for the backward
      float* hp = a.hs + (((long long)b * nc + c) * H + h) * C * V;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int c0 = 8 * m + 2 * t;
        hp[c0 * V + v0 + g] = st[m][0];
        hp[(c0 + 1) * V + v0 + g] = st[m][1];
        hp[c0 * V + v0 + g + 8] = st[m][2];
        hp[(c0 + 1) * V + v0 + g + 8] = st[m][3];
      }
    }
    const int ps = c % kSlots;
    bar_sync(kBarFull + ps, kThreads);
    const float* sl = sm + kSlot0 + ps * kSlot;
    const float* rdec = sl + kRdec;

    // y_inter = rdec S: S^T's accumulators of key tiles 2ks and 2ks + 1 are
    // the B fragment of S over those 16 keys.  The tensor cores round
    // toward zero as they accumulate: each k-step of 16 terms from zero,
    // added in float32
    float yacc[2][4], ypart[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      yacc[0][e] = yacc[1][e] = 0.f;
      ypart[0][e] = ypart[1][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < C / 16; ++ks) {
      const float* r0 = rdec + g * kPR + 16 * ks + 2 * t;
      const float2 q0 = *reinterpret_cast<const float2*>(r0);
      const float2 q1 = *reinterpret_cast<const float2*>(r0 + 8 * kPR);
      const float2 q2 = *reinterpret_cast<const float2*>(r0 + 8);
      const float2 q3 = *reinterpret_cast<const float2*>(r0 + 8 * kPR + 8);
      const float alo[4] = {q0.x, q1.x, q2.x, q3.x}, ahi[4] = {q0.y, q1.y, q2.y, q3.y};
      const x3::Frag<4> af = x3::frag(alo, ahi);
      const float b0lo[2] = {st[2 * ks][0], st[2 * ks + 1][0]};
      const float b0hi[2] = {st[2 * ks][1], st[2 * ks + 1][1]};
      const float b1lo[2] = {st[2 * ks][2], st[2 * ks + 1][2]};
      const float b1hi[2] = {st[2 * ks][3], st[2 * ks + 1][3]};
      x3::mma6(ypart[0], af, x3::frag(b0lo, b0hi));
      x3::mma6(ypart[1], af, x3::frag(b1lo, b1hi));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        yacc[0][e] += ypart[0][e];
        yacc[1][e] += ypart[1][e];
        ypart[0][e] = ypart[1][e] = 0.f;
      }
    }

    // the intra-chunk term and the bonus, A' v ([16 x 16] by [16 x 16] a
    // warp), and the chunk's own state term v^T kdec ([16 x 16] by
    // [16 x 64]): v^T's A fragment is made of v's B fragments, split once
    const float* vs = sl + kVs;
    const float* kdec = sl + kKdec;
    const float* ap = sl + kAp;
    const float* vp = vs + 2 * t * kPK + v0 + g;  // rows 2t, 2t + 1, 2t + 8, 2t + 9
    const float vlo[4] = {vp[0], vp[8], vp[8 * kPK], vp[8 * kPK + 8]};
    const float vhi[4] = {vp[kPK], vp[kPK + 8], vp[9 * kPK], vp[9 * kPK + 8]};
    const x3::Frag<4> vt = x3::frag(vlo, vhi);  // A of v^T; B of v: {0, 2} and {1, 3}
    x3::Frag<2> vb0, vb1;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      vb0.v[q][0] = vt.v[q][0];
      vb0.v[q][1] = vt.v[q][2];
      vb1.v[q][0] = vt.v[q][1];
      vb1.v[q][1] = vt.v[q][3];
    }
    float yin[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const float* a0 = ap + g * kAS + 2 * t;
      const float2 q0 = *reinterpret_cast<const float2*>(a0);
      const float2 q1 = *reinterpret_cast<const float2*>(a0 + 8 * kAS);
      const float2 q2 = *reinterpret_cast<const float2*>(a0 + 8);
      const float2 q3 = *reinterpret_cast<const float2*>(a0 + 8 * kAS + 8);
      const float alo[4] = {q0.x, q1.x, q2.x, q3.x}, ahi[4] = {q0.y, q1.y, q2.y, q3.y};
      const x3::Frag<4> af = x3::frag(alo, ahi);
      x3::mma6(yin[0], af, vb0);
      x3::mma6(yin[1], af, vb1);
    }
    float sc[8][4];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[m][e] = 0.f;
      const float* kp = kdec + 2 * t * kPK + 8 * m + g;
      const float blo[2] = {kp[0], kp[8 * kPK]};
      const float bhi[2] = {kp[kPK], kp[9 * kPK]};
      x3::mma6(sc[m], vt, x3::frag(blo, bhi));
    }
    // y = y_inter + y_intra: steps g, g + 8, value columns v0 + 8 nt + 2t, + 1
    float* yg = a.y + ((long long)b * T + (long long)c * Q) * H * V + (long long)h * V;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int vc = v0 + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(yg + (long long)g * H * V + vc) =
          make_float2(yacc[nt][0] + yin[nt][0], yacc[nt][1] + yin[nt][1]);
      *reinterpret_cast<float2*>(yg + (long long)(g + 8) * H * V + vc) =
          make_float2(yacc[nt][2] + yin[nt][2], yacc[nt][3] + yin[nt][3]);
    }

    // S^T <- S^T diag(exp(cw_Q)) + v^T kdec: the chunk's own term from zero,
    // then one fmaf, as the plain version adds it
    const float* cdec = sl + kCdec;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const float2 d = *reinterpret_cast<const float2*>(cdec + 8 * m + 2 * t);
      st[m][0] = fmaf(d.x, st[m][0], sc[m][0]);
      st[m][1] = fmaf(d.y, st[m][1], sc[m][1]);
      st[m][2] = fmaf(d.x, st[m][2], sc[m][2]);
      st[m][3] = fmaf(d.y, st[m][3], sc[m][3]);
    }
    if (c + kSlots < nc) bar_arrive(kBarEmpty + ps, kThreads);
  }

  float* hp = a.h + hoff;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int c0 = 8 * m + 2 * t;
    hp[c0 * V + v0 + g] = st[m][0];
    hp[(c0 + 1) * V + v0 + g] = st[m][1];
    hp[c0 * V + v0 + g + 8] = st[m][2];
    hp[(c0 + 1) * V + v0 + g + 8] = st[m][3];
  }
}

__global__ void __launch_bounds__(kThreads, 2) wkv6_chunks(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  if (tid < C) sm[kU + tid] = a.u[(long long)blockIdx.x * C + tid];
  // A' above the diagonal stays 0 (the producers write on and below it)
  for (int i = tid; i < kSlots * Q * kAS; i += kThreads) {
    sm[kSlot0 + (i / (Q * kAS)) * kSlot + kAp + i % (Q * kAS)] = 0.f;
  }
  __syncthreads();
  if (warp < 4) {
    consume(a, sm, warp, tid & 31);
  } else {
    produce(a, sm, tid - 128);
  }
}

}  // namespace

extern "C" {

// r, k, v, logw [B, T, H, 64], u [H, 64], h0 [B, H, 64, 64] or null,
// y [B, T, H, 64], h [B, H, 64, 64], hs [B, T / 16, H, 64, 64] or null (the
// chunk-start states); all contiguous float32, T a multiple of 16.  h0 and
// h may be the same buffer (each thread reads its entries of h0 before the
// loop and writes the same entries of h after it).  Returns
// cudaGetLastError() after the launch.
int rwkv6_wkv_launch(const float* r, const float* k, const float* v, const float* logw,
                     const float* u, const float* h0, float* y, float* h, float* hs, int B,
                     int T, int H, void* stream) {
  if (B <= 0 || H <= 0 || T < 0 || T % Q != 0 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)kSmemFloats * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(wkv6_chunks, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Args a{r, k, v, logw, u, h0, y, h, hs, T, H};
  wkv6_chunks<<<dim3((unsigned)H, (unsigned)B), kThreads, smem,
                reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
