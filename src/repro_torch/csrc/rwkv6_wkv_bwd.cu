// rwkv6_wkv_bwd: the backward of the RWKV6 WKV recurrence (rwkv6_wkv.cu),
// per batch row b and head h, in chunks of Q = 16 steps walked in reverse.
//
// Replaces no Pallas kernel: the reference trains through jax.grad of its
// jnp scan (src/repro/models/rwkv6.py, wkv6_scan), and its Pallas WKV has
// no backward.  The formulas are ref.py's wkv6_chunked_bwd, in its order.
// With the forward's chunk-start states S (written by wkv6_chunks), the
// state's gradient G carried from dh_final backward (G_start = exp(cw_Q)
// G_end + sum_t (r_t exp(cwx_t)) dy_t^T), E_tsc = exp(cwx_tc - cw_sc) for
// s < t and vd_ts = v_s . dy_t:
//   dr_t = exp(cwx_t) (S dy_t) + sum_{s<t} vd_ts k_s E_ts + u k_t vd_tt,
//   dk_s = exp(cw_Q - cw_s) (G v_s) + sum_{t>s} vd_ts r_t E_ts + u r_s vd_ss,
//   dv_s = G^T (k_s exp(cw_Q - cw_s)) + sum_{t>s} A_ts dy_t + (r_s . u k_s) dy_s,
//   A_ts = sum_c r_tc k_sc E_tsc,
//   dlogw_s = exp(cw_Q) rowsum(G S) + sum_{t>s} a_t + sum_{j<s} b_j + sum_{j<s<t} P_tj,
// the paths through step s's decay inside its chunk, every term carrying
// that decay (a_t = r_t exp(cwx_t) (S dy_t), b_j = k_j exp(cw_Q - cw_j)
// (G v_j), P_tj = r_t k_j E_tj vd_tj), so nothing cancels; and du = sum_t
// r_t k_t vd_tt per (b, h), summed over b by the caller in one fixed
// order: no atomics, the same bits every call.
//
// Bound on the H100 at rwkv6-1.6b's training shape (B 8, T 2048, H 32):
// it reads r, k, v, logw, dy (0.671 GB) and the chunk-start states
// (0.537 GB) and writes dr, dk, dv, dlogw (0.537 GB): 1.745 GB, 0.521 ms
// at 3.35 TB/s.  Its products are about 21 GFLOP, 0.31 ms at 67 TFLOP/s
// of float32.  So: bytes.
//
// Design (simple first): one CTA of 256 threads owns (b, h); G [64 x 64]
// and the chunk's start state live in shared memory (rows padded to 65
// floats, so a warp reading a column or a row hits 32 banks).  A chunk is
// seven phases between barriers: load; the prefix sums of the log-decay
// (float64, a thread a channel), vd and the bonus; the exponents
// (float64 differences rounded once to float32, every one <= 0, as the
// forward takes them) and E over the 120 strictly lower pairs; dr, dk and
// A; dv, du and P (in E's place); dlogw; G's update.  Every product runs
// on the CUDA cores in float32 FMAs (more exact than the forward's
// three-piece bf16 tensor core products).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 16;   // chunk
constexpr int C = 64;   // key dim (head dim)
constexpr int V = 64;   // value dim
constexpr int kThreads = 256;
constexpr int kPairs = Q * (Q - 1) / 2;  // 120 strictly lower pairs
constexpr int kLd = 65;                  // padded row of G and S

// shared memory layout, in floats (cum first: float64)
constexpr int kCum = 0;                      // cum [Q + 1][C] float64: cum[t] = sum_{s<t} logw_s
constexpr int kG = kCum + 2 * (Q + 1) * C;   // G [C][kLd]
constexpr int kS = kG + C * kLd;             // S_start [C][kLd]
constexpr int kR = kS + C * kLd;             // r, k, v, logw, dy [Q][C] each
constexpr int kK = kR + Q * C;
constexpr int kVv = kK + Q * C;
constexpr int kW = kVv + Q * C;
constexpr int kDy = kW + Q * C;
constexpr int kEx = kDy + Q * C;             // exp(cwx_t) [Q][C]
constexpr int kEk = kEx + Q * C;             // exp(cw_Q - cw_t) [Q][C]
constexpr int kCd = kEk + Q * C;             // exp(cw_Q) [C]
constexpr int kE = kCd + C;                  // E [kPairs][C]
constexpr int kAi = kE + kPairs * C;         // a_t, b_t (the boundary paths) [Q][C]
constexpr int kBi = kAi + Q * C;
constexpr int kZ = kBi + Q * C;              // exp(cw_Q) rowsum(G S) [C]
constexpr int kVd = kZ + C;                  // vd [Q][Q]: vd[t][s] = v_s . dy_t
constexpr int kA = kVd + Q * Q;              // A [Q][Q], s < t
constexpr int kBonus = kA + Q * Q;           // r_t . (u k_t) [Q]
constexpr int kU = kBonus + Q;               // u [C]
constexpr int kPt = kU + C;                  // the pairs' t and s [kPairs] (ints)
constexpr int kPs = kPt + kPairs;
constexpr int kSmemFloats = kPs + kPairs;

__device__ __forceinline__ int pair_index(int t, int s) { return t * (t - 1) / 2 + s; }

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  const float* hs;    // [B, T / Q, H, C, V]
  const float* dy;
  const float* dh;    // may be null: dh_final = 0
  float* dr;
  float* dk;
  float* dv;
  float* dlw;
  float* du;          // [B, H, C]
  int T, H;
};

__global__ void __launch_bounds__(kThreads, 2) wkv6_bwd_chunks(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int H = a.H;
  const int nc = a.T / Q;
  const long long row = (long long)H * C;            // floats between steps
  const long long base = ((long long)b * a.T * H + h) * C;
  const long long hoff = ((long long)b * H + h) * C * V;
  double* cum = reinterpret_cast<double*>(sm + kCum);
  float* G = sm + kG;
  float* S = sm + kS;
  float* rs = sm + kR;
  float* ks = sm + kK;
  float* vs = sm + kVv;
  float* ws = sm + kW;
  float* dys = sm + kDy;
  float* ex = sm + kEx;
  float* ek = sm + kEk;
  float* cd = sm + kCd;
  float* E = sm + kE;
  float* ai = sm + kAi;
  float* bi = sm + kBi;
  float* zs = sm + kZ;
  float* vd = sm + kVd;
  float* A = sm + kA;
  float* bonus = sm + kBonus;
  float* us = sm + kU;
  int* pt = reinterpret_cast<int*>(sm + kPt);
  int* ps = reinterpret_cast<int*>(sm + kPs);

  if (tid < C) us[tid] = a.u[(long long)h * C + tid];
  if (tid < kPairs) {
    int t = 1;
    while ((t + 1) * t / 2 <= tid) ++t;
    pt[tid] = t;
    ps[tid] = tid - t * (t - 1) / 2;
  }
  // G from dh_final
  for (int e = tid; e < C * V; e += kThreads) {
    G[(e / V) * kLd + e % V] = a.dh ? a.dh[hoff + e] : 0.f;
  }
  float du = 0.f;     // threads < C: channel tid's share of du

  for (int c = nc - 1; c >= 0; --c) {
    __syncthreads();  // the previous chunk is done with every buffer
    // 1. the chunk's inputs and its start state
    {
      const int tt = tid >> 4, c4 = (tid & 15) * 4;
      const long long off = base + ((long long)c * Q + tt) * row + c4;
      *reinterpret_cast<float4*>(rs + tt * C + c4) = *reinterpret_cast<const float4*>(a.r + off);
      *reinterpret_cast<float4*>(ks + tt * C + c4) = *reinterpret_cast<const float4*>(a.k + off);
      *reinterpret_cast<float4*>(vs + tt * C + c4) = *reinterpret_cast<const float4*>(a.v + off);
      *reinterpret_cast<float4*>(ws + tt * C + c4) = *reinterpret_cast<const float4*>(a.lw + off);
      *reinterpret_cast<float4*>(dys + tt * C + c4) = *reinterpret_cast<const float4*>(a.dy + off);
      const float* hp = a.hs + (((long long)b * nc + c) * H + h) * C * V;
#pragma unroll
      for (int i = 0; i < C * V / 4 / kThreads; ++i) {
        const int e = 4 * (tid + kThreads * i);
        const float4 q = *reinterpret_cast<const float4*>(hp + e);
        float* d = S + (e / V) * kLd + e % V;
        d[0] = q.x;
        d[1] = q.y;
        d[2] = q.z;
        d[3] = q.w;
      }
    }
    __syncthreads();
    // 2. prefix sums of the log-decay (float64), the bonus, vd
    if (tid < C) {
      double s = 0.0;
      cum[tid] = 0.0;
#pragma unroll
      for (int tt = 0; tt < Q; ++tt) {
        s += (double)ws[tt * C + tid];
        cum[(tt + 1) * C + tid] = s;
      }
    } else if (tid < C + Q) {
      const int tt = tid - C;
      float acc = 0.f;
      for (int i = 0; i < C; ++i) {
        const int ch = (i + tt) & (C - 1);
        acc = fmaf(rs[tt * C + ch] * us[ch], ks[tt * C + ch], acc);
      }
      bonus[tt] = acc;
    }
    {
      const int tt = tid >> 4, s = tid & 15;
      float acc = 0.f;
      for (int i = 0; i < V; ++i) {
        const int j = (i + s) & (V - 1);
        acc = fmaf(vs[s * V + j], dys[tt * V + j], acc);
      }
      vd[tt * Q + s] = acc;
    }
    __syncthreads();
    // 3. the exponents: exp(cwx_t), exp(cw_Q - cw_t), exp(cw_Q), E
    for (int e = tid; e < Q * C; e += kThreads) {
      const int tt = e / C, ch = e % C;
      ex[e] = expf((float)cum[tt * C + ch]);
      ek[e] = expf((float)(cum[Q * C + ch] - cum[(tt + 1) * C + ch]));
    }
    if (tid < C) cd[tid] = expf((float)cum[Q * C + tid]);
    for (int e = tid; e < kPairs * C; e += kThreads) {
      const int p = e / C, ch = e % C;
      E[e] = expf((float)(cum[pt[p] * C + ch] - cum[(ps[p] + 1) * C + ch]));
    }
    __syncthreads();
    // 4. dr and dk (thread: channel ch, steps q, q + 4, q + 8, q + 12), and A
    {
      const int ch = tid & (C - 1), q = tid >> 6;
      float sdy[4] = {0.f, 0.f, 0.f, 0.f}, gv[4] = {0.f, 0.f, 0.f, 0.f}, z = 0.f;
      for (int vv = 0; vv < V; ++vv) {
        const float sv = S[ch * kLd + vv], gg = G[ch * kLd + vv];
        z = fmaf(sv, gg, z);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tt = q + 4 * i;
          sdy[i] = fmaf(sv, dys[tt * V + vv], sdy[i]);
          gv[i] = fmaf(gg, vs[tt * V + vv], gv[i]);
        }
      }
      if (q == 0) zs[ch] = cd[ch] * z;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tt = q + 4 * i;
        float dr = ex[tt * C + ch] * sdy[i];
        float dk = ek[tt * C + ch] * gv[i];
        ai[tt * C + ch] = rs[tt * C + ch] * dr;
        bi[tt * C + ch] = ks[tt * C + ch] * dk;
        for (int s = 0; s < tt; ++s) {
          dr = fmaf(vd[tt * Q + s] * ks[s * C + ch], E[pair_index(tt, s) * C + ch], dr);
        }
        for (int t2 = tt + 1; t2 < Q; ++t2) {
          dk = fmaf(vd[t2 * Q + tt] * rs[t2 * C + ch], E[pair_index(t2, tt) * C + ch], dk);
        }
        const float vdd = vd[tt * Q + tt];
        const long long off = base + ((long long)c * Q + tt) * row + ch;
        a.dr[off] = fmaf(us[ch] * ks[tt * C + ch], vdd, dr);
        a.dk[off] = fmaf(us[ch] * rs[tt * C + ch], vdd, dk);
      }
    }
    {
      // A over the 120 pairs, two threads a pair, 32 channels each
      const int p = tid >> 1, half = tid & 1;
      float acc = 0.f;
      if (p < kPairs) {
        const int tt = pt[p], s = ps[p];
        const int lane = tid & 31;
        for (int i = 0; i < 32; ++i) {
          const int ch = 32 * half + ((i + lane) & 31);
          acc = fmaf(rs[tt * C + ch] * ks[s * C + ch], E[p * C + ch], acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (p < kPairs && half == 0) A[pt[p] * Q + ps[p]] = acc;
    }
    __syncthreads();
    // 5. dv (thread: value column vv, steps q, q + 4, ...); du; P_tj in E's place
    {
      const int vv = tid & (V - 1), q = tid >> 6;
      float gk[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ch = 0; ch < C; ++ch) {
        const float gg = G[ch * kLd + vv];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tt = q + 4 * i;
          gk[i] = fmaf(gg, ks[tt * C + ch] * ek[tt * C + ch], gk[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = q + 4 * i;
        float dv = gk[i];
        for (int t2 = s + 1; t2 < Q; ++t2) dv = fmaf(A[t2 * Q + s], dys[t2 * V + vv], dv);
        dv = fmaf(bonus[s], dys[s * V + vv], dv);
        a.dv[base + ((long long)c * Q + s) * row + vv] = dv;
      }
    }
    if (tid < C) {
      for (int tt = 0; tt < Q; ++tt) {
        du = fmaf(rs[tt * C + tid] * ks[tt * C + tid], vd[tt * Q + tt], du);
      }
    }
    {
      const int ch = tid & (C - 1);
      for (int p = tid >> 6; p < kPairs; p += kThreads / C) {
        const int tt = pt[p], s = ps[p];
        E[p * C + ch] *= rs[tt * C + ch] * ks[s * C + ch] * vd[tt * Q + s];
      }
    }
    __syncthreads();
    // 6. dlogw_s = exp(cw_Q) rowsum(G S) + sum_{t>s} a_t + sum_{j<s} b_j + sum_{j<s<t} P_tj
    {
      const int ch = tid & (C - 1), q = tid >> 6;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = q + 4 * i;
        float d = zs[ch];
        for (int tt = s + 1; tt < Q; ++tt) d += ai[tt * C + ch];
        for (int j = 0; j < s; ++j) d += bi[j * C + ch];
        for (int tt = s + 1; tt < Q; ++tt) {
          for (int j = 0; j < s; ++j) d += E[pair_index(tt, j) * C + ch];
        }
        a.dlw[base + ((long long)c * Q + s) * row + ch] = d;
      }
    }
    __syncthreads();
    // 7. G <- diag(exp(cw_Q)) G + sum_t (r_t exp(cwx_t)) dy_t^T
    for (int e = tid; e < C * V; e += kThreads) {
      const int ch = e / V, vv = e % V;
      float acc = 0.f;
#pragma unroll
      for (int tt = 0; tt < Q; ++tt) {
        acc = fmaf(rs[tt * C + ch] * ex[tt * C + ch], dys[tt * V + vv], acc);
      }
      G[ch * kLd + vv] = fmaf(cd[ch], G[ch * kLd + vv], acc);
    }
  }
  if (tid < C) a.du[((long long)b * H + h) * C + tid] = du;
}

}  // namespace

extern "C" {

// r, k, v, logw, dy [B, T, H, 64], u [H, 64], hs [B, T / 16, H, 64, 64]
// (the forward's chunk-start states), dh_final [B, H, 64, 64] or null;
// outputs dr, dk, dv, dlogw [B, T, H, 64] and du [B, H, 64] (a batch row's
// share); all contiguous float32, T a multiple of 16.  Returns
// cudaGetLastError() after the launch.
int rwkv6_wkv_bwd_launch(const float* r, const float* k, const float* v, const float* logw,
                         const float* u, const float* hs, const float* dy, const float* dh,
                         float* dr, float* dk, float* dv, float* dlogw, float* du, int B, int T,
                         int H, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % Q != 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(wkv6_bwd_chunks,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Args a{r, k, v, logw, u, hs, dy, dh, dr, dk, dv, dlogw, du, T, H};
  wkv6_bwd_chunks<<<dim3((unsigned)H, (unsigned)B), kThreads, smem,
                    reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
