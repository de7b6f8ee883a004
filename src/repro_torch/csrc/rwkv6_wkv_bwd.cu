// rwkv6_wkv_bwd: the backward of the RWKV6 WKV recurrence (rwkv6_wkv.cu),
// per batch row b and head h, in chunks of Q = 16 steps.
//
// Replaces no Pallas kernel: the reference trains through jax.grad of its
// jnp scan (src/repro/models/rwkv6.py, wkv6_scan), and its Pallas WKV has
// no backward.  The formulas are ref.py's wkv6_chunked_bwd.  With the
// forward's chunk-start states S (written by wkv6_chunks), the state's
// gradient G at each chunk's end (G_start = exp(cw_Q) G_end + sum_t
// (r_t exp(cwx_t)) dy_t^T from dh_final), E_tsc = exp(cwx_tc - cw_sc) for
// s < t and vd_ts = v_s . dy_t:
//   dr_t = exp(cwx_t) (S dy_t) + sum_{s<t} vd_ts k_s E_ts + u k_t vd_tt,
//   dk_s = exp(cw_Q - cw_s) (G v_s) + sum_{t>s} vd_ts r_t E_ts + u r_s vd_ss,
//   dv_s = G^T (k_s exp(cw_Q - cw_s)) + sum_{t>s} A_ts dy_t + (r_s . u k_s) dy_s,
//   A_ts = sum_c r_tc k_sc E_tsc,
//   dlogw_s = exp(cw_Q) rowsum(G S) + sum_{t>s} a_t + sum_{j<s} b_j + sum_{j<s<t} P_tj,
// the paths through step s's decay inside its chunk, every term carrying
// that decay (a_t = r_t exp(cwx_t) (S dy_t), b_j = k_j exp(cw_Q - cw_j)
// (G v_j), P_tj = r_t k_j E_tj vd_tj), so nothing cancels; and du = sum_t
// r_t k_t vd_tt, written per (b, chunk group, h) and summed by the caller
// in one fixed order: no atomics, the same bits every call.
//
// Two launches, the SSD backward's split:
//  * wkv6_bwd_state: one CTA a (b, h) walks the chunks in reverse and
//    writes G_end of every chunk ([B, T / 16, H, 64, 64], the forward's
//    chunk-start states' layout).  Four warps hold G in MMA accumulators
//    (16 key rows each) and run its update, (r exp(cwx))^T dy ([64 x 16]
//    by [16 x 64]), on the tensor cores: the chunk's term from zero, then
//    one fmaf with exp(cw_Q) G, as the plain version adds it.  Each chunk's
//    r, logw and dy come by cp.async through a ring of 3 stages, 2 chunks
//    ahead.
//  * wkv6_bwd_chunk: one CTA a (b, group of 8 chunks, h) takes its chunks
//    in reverse, every chunk's gradients from its S and G_end.  The
//    products run on mma.sync.m16n8k16 with each float32 operand in three
//    bf16 pieces (mma_x3.cuh): S dy, G v, G^T kdec and vd (each [16 x 64]
//    by [64 x 64] or [64 x 16]), the k-steps of a warp's three products
//    interleaved.  The pairs s < t run on the CUDA cores, four threads a
//    channel (steps sub, sub + 4, ...): each thread's pairs (t its own
//    step) add dr_t, its share of dk_s and of P's path sums, and (a pair
//    inside a half) r_t k_s E_ts into a row of A's per-channel terms; the
//    channel's four threads then add their shares with shuffles, in a
//    fixed order.  A pair across the chunk's halves (s < 8 <= t) splits its
//    decay at step 8, E_ts = exp(cwx_t - cum_8) exp(cum_8 - cw_s), as the
//    forward's A takes it, so those 64 entries of A are one [8 x 64] by
//    [64 x 8] product on the tensor cores.  r, k, logw and dy have two
//    slots, and chunk c - 1's go in by cp.async when chunk c starts; S,
//    G_end and v go in as soon as chunk c's products are done with them:
//    chunk c - 1's loads are in flight while chunk c computes.
// A walk that carried G through one CTA a (b, h) and computed every chunk's
// gradients there would have to stage a chunk's inputs and start state
// (36 KB) 2 chunks ahead beside the hand-off of its state-independent terms
// (24 KB a chunk): more than the 113 KB that keep two CTAs an SM, and so
// all 256 (b, h) of rwkv6-1.6b's training shape, resident.
//
// Bound on the H100 at rwkv6-1.6b's training shape (B 8, T 2048, H 32): the
// algebra reads r, k, v, logw, dy (0.671 GB) and the chunk-start states
// (0.537 GB) and writes dr, dk, dv, dlogw (0.537 GB): 1.745 GB, 0.521 ms
// at 3.35 TB/s; this design also writes and reads G_end (0.537 GB each
// way): 2.82 GB, 0.841 ms.  Its products are about 18.3 GFLOP (six bf16
// products a product: 0.11 ms at 989 TFLOP/s), the rest (the pairs, the
// decays) about 4.6 GFLOP at the FMA rate (0.07 ms).  So: bytes.
//
// Precision as before: a step's log-decay reaches -87.5 at the wrapper's
// 1e-38 clamp, so a chunk's prefix sum reaches about -1400: the prefix sums
// and their differences are float64, each exponent rounded to float32 once
// before expf, every exponent <= 0, and only the pairs s < t are formed.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_x3.cuh"

namespace {

constexpr int Q = 16;   // chunk
constexpr int C = 64;   // key dim (head dim)
constexpr int V = 64;   // value dim
constexpr int kSR = 72;  // row stride where fragments read 8-byte pairs along a row
constexpr int kSC = 68;  // where they read two rows of one column

// ---------------------------------------------------------------------------
// wkv6_bwd_state: G_end of every chunk, the chunks in reverse
// ---------------------------------------------------------------------------

constexpr int kStThreads = 128;  // 4 warps, 16 key rows of G each
constexpr int kStages = 3;
// a stage: r, logw [Q][C], dy [Q][kSC]
constexpr int kStR = 0;
constexpr int kStW = kStR + Q * C;
constexpr int kStDy = kStW + Q * C;
constexpr int kStage = kStDy + Q * kSC;
constexpr int kStRdec = kStages * kStage;  // r exp(cwx) [Q][kSC]
constexpr int kStCd = kStRdec + Q * kSC;   // exp(cw_Q) [C]
constexpr int kStFloats = kStCd + C;

struct StateArgs {
  const float* r;
  const float* lw;
  const float* dy;
  const float* dh;   // may be null: dh_final = 0
  float* dhs;        // [B, T / Q, H, C, V]: G_end of every chunk
  int T, H;
};

__global__ void __launch_bounds__(kStThreads) wkv6_bwd_state(StateArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int H = a.H, nc = a.T / Q;
  const long long row = (long long)H * C;   // floats between steps
  const long long base = ((long long)b * a.T * H + h) * C;
  const long long hoff = ((long long)b * H + h) * C * V;
  const int c0 = 16 * warp;                 // this warp's key rows of G
  float* rdec = sm + kStRdec;
  float* cd = sm + kStCd;

  auto issue = [&](int it) {  // chunk nc - 1 - it
    if (it < nc) {
      float* st = sm + (it % kStages) * kStage;
      const long long off = base + (long long)(nc - 1 - it) * Q * row;
      for (int e = tid; e < Q * C / 4; e += kStThreads) {
        const int tt = e >> 4, c4 = (e & 15) * 4;
        const long long src = off + tt * row + c4;
        x3::cp16(st + kStR + tt * C + c4, a.r + src);
        x3::cp16(st + kStW + tt * C + c4, a.lw + src);
        x3::cp16(st + kStDy + tt * kSC + c4, a.dy + src);
      }
    }
    x3::cp_commit();
  };

  // G [c][v]: rows c0 + g, c0 + g + 8, columns 8 nt + 2q, + 1
  float gs[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int v = 8 * nt + 2 * q;
    float2 u0 = make_float2(0.f, 0.f), u1 = u0;
    if (a.dh) {
      u0 = *reinterpret_cast<const float2*>(a.dh + hoff + (c0 + g) * V + v);
      u1 = *reinterpret_cast<const float2*>(a.dh + hoff + (c0 + g + 8) * V + v);
    }
    gs[nt][0] = u0.x;
    gs[nt][1] = u0.y;
    gs[nt][2] = u1.x;
    gs[nt][3] = u1.y;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int it = 0; it < nc; ++it) {
    const int c = nc - 1 - it;
    float* gw = a.dhs + (((long long)b * nc + c) * H + h) * C * V;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int v = 8 * nt + 2 * q;
      *reinterpret_cast<float2*>(gw + (c0 + g) * V + v) = make_float2(gs[nt][0], gs[nt][1]);
      *reinterpret_cast<float2*>(gw + (c0 + g + 8) * V + v) = make_float2(gs[nt][2], gs[nt][3]);
    }
    x3::cp_wait<kStages - 2>();
    __syncthreads();  // chunk c has landed; the previous update is done with rdec
    issue(it + kStages - 1);
    const float* st = sm + (it % kStages) * kStage;
    // r exp(cwx) and exp(cw_Q): channel ch's prefix sum in float64, its
    // steps 8 half .. 8 half + 7
    {
      const int ch = tid & (C - 1), half = tid >> 6;
      double s = 0.0;
#pragma unroll
      for (int tt = 0; tt < Q; ++tt) {
        if ((tt >> 3) == half) rdec[tt * kSC + ch] = st[kStR + tt * C + ch] * expf((float)s);
        s += (double)st[kStW + tt * C + ch];
      }
      if (half == 0) cd[ch] = expf((float)s);
    }
    __syncthreads();
    // G <- diag(exp(cw_Q)) G + (r exp(cwx))^T dy: the chunk's term from
    // zero, then one fmaf, as the plain version adds it
    const x3::Frag<4> af = x3::a_cols(rdec, kSC, c0, 0, g, q);
    const float cd0 = cd[c0 + g], cd1 = cd[c0 + g + 8];
    x3::Frag<2> bf[8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) bf[nt] = x3::b_rows(st + kStDy, kSC, 0, 8 * nt + g, q);
    float part[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
#pragma unroll
    for (int p = 0; p < 6; ++p)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) x3::mma6_piece(p, part[nt], af, bf[nt]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      gs[nt][0] = fmaf(cd0, gs[nt][0], part[nt][0]);
      gs[nt][1] = fmaf(cd0, gs[nt][1], part[nt][1]);
      gs[nt][2] = fmaf(cd1, gs[nt][2], part[nt][2]);
      gs[nt][3] = fmaf(cd1, gs[nt][3], part[nt][3]);
    }
  }
  x3::cp_wait<0>();
}

// ---------------------------------------------------------------------------
// wkv6_bwd_chunk: every chunk's gradients, a group of chunks a CTA
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kPairs = Q * (Q - 1) / 2;  // 120 strictly lower pairs
constexpr int kHalf = Q / 2;
constexpr int kWithin = 2 * kHalf * (kHalf - 1) / 2;  // pairs inside a half: 56
constexpr int kLdA = 65;                 // row stride of the pairs' terms by channel
constexpr int kLdVd = 17;

// shared memory, in floats
constexpr int kR = 0;                    // r, two slots [2][Q][C]
constexpr int kK = kR + 2 * Q * C;       // k, two slots [2][Q][C]
constexpr int kW = kK + 2 * Q * C;       // logw, two slots [2][Q][C]
constexpr int kV = kW + 2 * Q * C;       // v [Q][kSR]
constexpr int kDy = kV + Q * kSR;        // dy, two slots [2][Q][kSR]
constexpr int kS = kDy + 2 * Q * kSR;    // S (h_start) [C][kSR]
constexpr int kG = kS + C * kSR;         // G_end [C][kSR]
constexpr int kKd = kG + C * kSR;        // k exp(cw_Q - cw) [Q][kSR]
constexpr int kSdy = kKd + Q * kSR;      // S dy [Q][C]: (S dy_t)_c
constexpr int kGv = kSdy + Q * C;        // G v [Q][C]: (G v_s)_c
constexpr int kVd = kGv + Q * C;         // vd [Q][kLdVd]: vd[t][s] = v_s . dy_t
constexpr int kR8 = kVd + Q * kLdVd;     // r_t exp(cwx_t - cum_8), t >= 8 [8][kSR]
constexpr int kK8 = kR8 + kHalf * kSR;   // k_s exp(cum_8 - cw_s), s < 8 [8][kSR]
constexpr int kAp = kK8 + kHalf * kSR;   // r_t k_s E_ts of the pairs inside a half
                                         // [kWithin][kLdA], r_t u k_t [Q][kLdA]
constexpr int kA = kAp + (kWithin + Q) * kLdA;  // A [kPairs] by pair, then the bonus [Q]
constexpr int kSmemFloats = kA + kPairs + Q;

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  const float* hs;    // [B, T / Q, H, C, V]
  const float* dy;
  const float* dhs;   // [B, T / Q, H, C, V]: G_end of every chunk
  float* dr;
  float* dk;
  float* dv;
  float* dlw;
  float* du;          // [B, T / (Q group), H, C]: each CTA's share
  int T, H, group;
};

__device__ __forceinline__ int pair_index(int t, int s) { return t * (t - 1) / 2 + s; }

// the row of a pair inside a half among Ap's (t, s both < 8, or both >= 8)
__device__ __forceinline__ int within_index(int t, int s) {
  return t < kHalf ? pair_index(t, s) : kWithin / 2 + pair_index(t - kHalf, s - kHalf);
}

__global__ void __launch_bounds__(kThreads, 2) wkv6_bwd_chunk(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int h = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int H = a.H, nc = a.T / Q, ngr = gridDim.y;
  const long long row = (long long)H * C;   // floats between steps
  const long long base = ((long long)b * a.T * H + h) * C;
  float* Vs = sm + kV;
  float* S = sm + kS;
  float* G = sm + kG;
  float* Kd = sm + kKd;
  float* Sdy = sm + kSdy;
  float* Gv = sm + kGv;
  float* Vd = sm + kVd;
  float* R8 = sm + kR8;
  float* K8 = sm + kK8;
  float* Ap = sm + kAp;
  float* Al = sm + kA;
  // the pairs' thread: channel ch, its steps sub, sub + 4, sub + 8, sub + 12
  const int ch = tid >> 2, sub = tid & 3;
  const float uc = a.u[(long long)h * C + ch];
  const int c_lo = grp * a.group, c_hi = min(nc, c_lo + a.group);

  // dy, r, k and logw into chunk c's slot (c & 1), at once
  auto issue_slot = [&](int c) {
    const int sl = c & 1;
    const int tt = tid >> 4, c4 = (tid & 15) * 4;
    const long long off = base + ((long long)c * Q + tt) * row + c4;
    x3::cp16(sm + kDy + sl * Q * kSR + tt * kSR + c4, a.dy + off);
    x3::cp16(sm + kR + sl * Q * C + tt * C + c4, a.r + off);
    x3::cp16(sm + kK + sl * Q * C + tt * C + c4, a.k + off);
    x3::cp16(sm + kW + sl * Q * C + tt * C + c4, a.lw + off);
  };
  // S, G_end and v, once the previous chunk is done with its own
  auto issue_sgv = [&](int c) {
    const long long so = (((long long)b * nc + c) * H + h) * C * V;
    for (int e = tid; e < C * V / 4; e += kThreads) {
      const int rr = e >> 4, c4 = (e & 15) * 4;
      x3::cp16(S + rr * kSR + c4, a.hs + so + rr * V + c4);
      x3::cp16(G + rr * kSR + c4, a.dhs + so + rr * V + c4);
    }
    const int tt = tid >> 4, c4 = (tid & 15) * 4;
    x3::cp16(Vs + tt * kSR + c4, a.v + base + ((long long)c * Q + tt) * row + c4);
  };

  issue_slot(c_hi - 1);
  issue_sgv(c_hi - 1);
  x3::cp_commit();
  float du = 0.f;  // this thread's steps' share of du[ch]

  for (int c = c_hi - 1; c >= c_lo; --c) {
    const bool more = c > c_lo;
    x3::cp_wait<0>();
    __syncthreads();  // chunk c has landed; chunk c + 1 is done with every buffer
    if (more) issue_slot(c - 1);
    x3::cp_commit();
    const int sl = c & 1;
    const float* DY = sm + kDy + sl * Q * kSR;
    const float* R = sm + kR + sl * Q * C;
    const float* K = sm + kK + sl * Q * C;
    const float* W = sm + kW + sl * Q * C;
    const long long cbase = base + (long long)c * Q * row;
    // the channel's prefix sums of the log-decay in float64: cum[t] = sum_{s<t} logw_s
    auto prefix = [&](double (&cum)[Q + 1]) {
      cum[0] = 0.0;
#pragma unroll
      for (int t = 0; t < Q; ++t) cum[t + 1] = cum[t] + (double)W[t * C + ch];
    };

    // 1. the channel's prefix sums, its steps' exp(cwx_t) and exp(cw_Q -
    //    cw_t), k exp(cw_Q - cw), and exp(cw_Q) rowsum(G S)
    float ex[4], ek[4], z = 0.f;
    {
      double cum[Q + 1], cx[4], cw[4];  // cum, and at this thread's steps t and t + 1
      prefix(cum);
#pragma unroll
      for (int t = 0; t < Q; ++t) {
        if ((t & 3) == sub) {
          cx[t >> 2] = cum[t];
          cw[t >> 2] = cum[t + 1];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = sub + 4 * i;
        ex[i] = expf((float)cx[i]);
        ek[i] = expf((float)(cum[Q] - cw[i]));
        Kd[t * kSR + ch] = K[t * C + ch] * ek[i];
      }
#pragma unroll 4
      for (int i = 0; i < 16; ++i) {
        const int vv = 16 * sub + i;
        z = fmaf(G[ch * kSR + vv], S[ch * kSR + vv], z);
      }
      z += __shfl_xor_sync(0xffffffffu, z, 1);
      z += __shfl_xor_sync(0xffffffffu, z, 2);
      z *= expf((float)cum[Q]);
    }
    __syncthreads();

    // 2. the products, an n8 tile of each a warp: S dy (t, c), G v (s, c),
    //    G^T kdec (s, v; kept for dv) and, warps 0 and 1, vd (t, s)
    float gk[4] = {0.f, 0.f, 0.f, 0.f};
    {
      float sd[4] = {0.f, 0.f, 0.f, 0.f}, gvv[4] = {0.f, 0.f, 0.f, 0.f};
      float vdd[4] = {0.f, 0.f, 0.f, 0.f};
      const int j = 8 * warp + g;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // the three products' k-steps interleaved (each still from zero)
        const x3::Frag<4> fdy = x3::a_rows(DY, kSR, 0, 16 * kk, g, q);
        const x3::Frag<4> fv = x3::a_rows(Vs, kSR, 0, 16 * kk, g, q);
        const x3::Frag<4> fk = x3::a_rows(Kd, kSR, 0, 16 * kk, g, q);
        const x3::Frag<2> bs = x3::b_cols(S, kSR, j, 16 * kk, q);
        const x3::Frag<2> bg = x3::b_cols(G, kSR, j, 16 * kk, q);
        const x3::Frag<2> bg2 = x3::b_rows(G, kSR, 16 * kk, j, q);
        float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
        float p2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int p = 0; p < 6; ++p) {
          x3::mma6_piece(p, p0, fdy, bs);
          x3::mma6_piece(p, p1, fv, bg);
          x3::mma6_piece(p, p2, fk, bg2);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sd[e] += p0[e];
          gvv[e] += p1[e];
          gk[e] += p2[e];
        }
        if (warp < 2) x3::mma_add(vdd, fdy, x3::b_cols(Vs, kSR, j, 16 * kk, q));
      }
      const int cc = 8 * warp + 2 * q;
      *reinterpret_cast<float2*>(Sdy + g * C + cc) = make_float2(sd[0], sd[1]);
      *reinterpret_cast<float2*>(Sdy + (g + 8) * C + cc) = make_float2(sd[2], sd[3]);
      *reinterpret_cast<float2*>(Gv + g * C + cc) = make_float2(gvv[0], gvv[1]);
      *reinterpret_cast<float2*>(Gv + (g + 8) * C + cc) = make_float2(gvv[2], gvv[3]);
      if (warp < 2) {
        Vd[g * kLdVd + cc] = vdd[0];
        Vd[g * kLdVd + cc + 1] = vdd[1];
        Vd[(g + 8) * kLdVd + cc] = vdd[2];
        Vd[(g + 8) * kLdVd + cc + 1] = vdd[3];
      }
    }
    __syncthreads();  // S, G_end, v and kdec are free: the next chunk's go in
    if (more) issue_sgv(c - 1);
    x3::cp_commit();

    // 3. the pairs s < t of this thread's steps t
    double cum[Q + 1];
    prefix(cum);
    double cx[4];  // cum at this thread's steps
#pragma unroll
    for (int t = 0; t < Q; ++t) {
      if ((t & 3) == sub) cx[t >> 2] = cum[t];
    }
    // a pair across the chunk's halves (s < 8 <= t) splits its decay at step
    // 8: E_ts = exp(cwx_t - cum_8) exp(cum_8 - cw_s), both factors <= 1 (a
    // factor that underflows stands for an entry smaller still), as the
    // forward's A takes it, and its A_ts is a product on the tensor cores
    // (step 4); a pair inside a half takes an exp
    float k8[kHalf];
#pragma unroll
    for (int s = 0; s < kHalf; ++s) k8[s] = expf((float)(cum[kHalf] - cum[s + 1]));
    K8[sub * kSR + ch] = K[sub * C + ch] * k8[sub];
    K8[(sub + 4) * kSR + ch] = K[(sub + 4) * C + ch] * k8[sub + 4];
    float dkp[Q], dlp[Q];  // shares of sum_{t>s} vd_ts r_t E_ts and sum_{j<s<t} P_tj
#pragma unroll
    for (int s = 0; s < Q; ++s) dkp[s] = dlp[s] = 0.f;
    float rr[4], kt[4], dri[4], dki[4], av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = sub + 4 * i;
      rr[i] = R[t * C + ch];
      kt[i] = K[t * C + ch];
      dri[i] = ex[i] * Sdy[t * C + ch];
      dki[i] = ek[i] * Gv[t * C + ch];
      av[i] = rr[i] * dri[i];
      bv[i] = kt[i] * dki[i];
      float drv = 0.f, run = 0.f;
      const float r8 = i >= 2 ? expf((float)(cx[i] - cum[kHalf])) : 0.f;
      if (i >= 2) R8[(t - kHalf) * kSR + ch] = rr[i] * r8;
#pragma unroll
      for (int s = 0; s < 4 * i + 3; ++s) {
        if (s < t) {
          const bool cross = i >= 2 && s < kHalf;
          const float e = cross ? r8 * k8[s] : expf((float)(cx[i] - cum[s + 1]));
          const float vts = Vd[t * kLdVd + s];
          const float ks = K[s * C + ch];
          drv = fmaf(vts * ks, e, drv);
          const float x = rr[i] * e;
          dkp[s] = fmaf(vts, x, dkp[s]);
          const float pa = x * ks;
          if (!cross) Ap[within_index(t, s) * kLdA + ch] = pa;
          dlp[s] += run;
          run = fmaf(pa, vts, run);
        }
      }
      const float vtt = Vd[t * kLdVd + t];
      a.dr[cbase + (long long)t * row + ch] = fmaf(uc * kt[i], vtt, dri[i] + drv);
      Ap[(kWithin + t) * kLdA + ch] = rr[i] * uc * kt[i];
      du = fmaf(rr[i] * kt[i], vtt, du);
    }
    // the channel's four threads: their shares of dk and of P's sums, and
    // every step's a and b
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      dkp[s] += __shfl_xor_sync(0xffffffffu, dkp[s], 1);
      dkp[s] += __shfl_xor_sync(0xffffffffu, dkp[s], 2);
      dlp[s] += __shfl_xor_sync(0xffffffffu, dlp[s], 1);
      dlp[s] += __shfl_xor_sync(0xffffffffu, dlp[s], 2);
    }
    float aa[Q], ba[Q];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        aa[src + 4 * i] = __shfl_sync(0xffffffffu, av[i], (lane & ~3) | src);
        ba[src + 4 * i] = __shfl_sync(0xffffffffu, bv[i], (lane & ~3) | src);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = sub + 4 * i;
      float dks = 0.f, dls = 0.f;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if (sub == x) {
          dks = dkp[x + 4 * i];
          dls = dlp[x + 4 * i];
        }
      }
      float after = 0.f, before = 0.f;
#pragma unroll
      for (int t = 0; t < Q; ++t) {
        if (t > s) after += aa[t];
        if (t < s) before += ba[t];
      }
      const float vss = Vd[s * kLdVd + s];
      a.dk[cbase + (long long)s * row + ch] = fmaf(uc * rr[i], vss, dki[i] + dks);
      a.dlw[cbase + (long long)s * row + ch] = z + after + before + dls;
    }
    __syncthreads();

    // 4. A and the bonus, each a sum over the channels: the pairs across
    //    the halves as (r exp(cwx - cum_8)) (k exp(cum_8 - cw))^T on the
    //    tensor cores (warp 7: rows t - 8 of 16, the upper 8 zero; k = the
    //    channel; n = s), the pairs inside a half and the bonus as two
    //    threads a row of Ap, 32 channels each in four running sums
    if (warp == kThreads / 32 - 1) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        const float* m = R8 + g * kSR + 16 * kk + 2 * q;
        const float2 v0 = *reinterpret_cast<const float2*>(m);
        const float2 v2 = *reinterpret_cast<const float2*>(m + 8);
        const float lo[4] = {v0.x, 0.f, v2.x, 0.f};
        const float hi[4] = {v0.y, 0.f, v2.y, 0.f};
        x3::mma_add(acc, x3::frag(lo, hi), x3::b_cols(K8, kSR, g, 16 * kk, q));
      }
      Al[pair_index(kHalf + g, 2 * q)] = acc[0];
      Al[pair_index(kHalf + g, 2 * q + 1)] = acc[1];
    } else if (warp < (2 * (kWithin + Q) + 31) / 32) {
      const int p = tid >> 1;
      float acc = 0.f;
      if (p < kWithin + Q) {
        const float* ap = Ap + p * kLdA + 32 * (tid & 1);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) part[jj] += ap[8 * jj + i];
        acc = (part[0] + part[1]) + (part[2] + part[3]);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (p < kWithin + Q && (tid & 1) == 0) {
        if (p >= kWithin) {
          Al[kPairs + p - kWithin] = acc;
        } else {
          const bool lower = p < kWithin / 2;
          const int pp = lower ? p : p - kWithin / 2;
          int t = 1;
          while ((t + 1) * t / 2 <= pp) ++t;
          const int s = pp - t * (t - 1) / 2;
          Al[lower ? pair_index(t, s) : pair_index(t + kHalf, s + kHalf)] = acc;
        }
      }
    }
    __syncthreads();

    // 5. dv_s = G^T kdec_s + sum_{t>s} A_ts dy_t + bonus_s dy_s: rows g, g +
    //    8, value columns 8 warp + 2q, + 1 (the G^T kdec tile's)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int s = g + 8 * hr, vc = 8 * warp + 2 * q;
      const float bon = Al[kPairs + s];
      float d0 = fmaf(bon, DY[s * kSR + vc], gk[2 * hr]);
      float d1 = fmaf(bon, DY[s * kSR + vc + 1], gk[2 * hr + 1]);
      for (int t = s + 1; t < Q; ++t) {
        const float at = Al[pair_index(t, s)];
        d0 = fmaf(at, DY[t * kSR + vc], d0);
        d1 = fmaf(at, DY[t * kSR + vc + 1], d1);
      }
      *reinterpret_cast<float2*>(a.dv + cbase + (long long)s * row + vc) = make_float2(d0, d1);
    }
  }
  x3::cp_wait<0>();
  du += __shfl_xor_sync(0xffffffffu, du, 1);
  du += __shfl_xor_sync(0xffffffffu, du, 2);
  if (sub == 0) a.du[(((long long)b * ngr + grp) * H + h) * C + ch] = du;
}

}  // namespace

extern "C" {

// dynamic shared memory of wkv6_bwd_state (0) and wkv6_bwd_chunk (1), bytes
int rwkv6_wkv_bwd_smem_bytes(int kernel) {
  return (int)((kernel == 0 ? kStFloats : kSmemFloats) * sizeof(float));
}

// r, k, v, logw, dy [B, T, H, 64], u [H, 64], hs [B, T / 16, H, 64, 64]
// (the forward's chunk-start states), dh_final [B, H, 64, 64] or null;
// scratch dhs like hs; outputs dr, dk, dv, dlogw [B, T, H, 64] and du
// [B, ceil(T / (16 group)), H, 64] (each CTA's share); all contiguous
// float32, T a multiple of 16, group chunks a CTA of wkv6_bwd_chunk.
// Returns cudaGetLastError() after the second launch.
int rwkv6_wkv_bwd_launch(const float* r, const float* k, const float* v, const float* logw,
                         const float* u, const float* hs, const float* dy, const float* dh,
                         float* dhs, float* dr, float* dk, float* dv, float* dlogw, float* du,
                         int B, int T, int H, int group, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % Q != 0 || group <= 0 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem1 = (size_t)kStFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(wkv6_bwd_state,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  const StateArgs sa{r, logw, dy, dh, dhs, T, H};
  wkv6_bwd_state<<<dim3((unsigned)H, (unsigned)B), kStThreads, smem1, st>>>(sa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = (size_t)kSmemFloats * sizeof(float);
  err = cudaFuncSetAttribute(wkv6_bwd_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const int groups = (T / Q + group - 1) / group;
  const Args ca{r, k, v, logw, u, hs, dy, dhs, dr, dk, dv, dlogw, du, T, H, group};
  wkv6_bwd_chunk<<<dim3((unsigned)H, (unsigned)groups, (unsigned)B), kThreads, smem2, st>>>(ca);
  return (int)cudaGetLastError();
}

}  // extern "C"
