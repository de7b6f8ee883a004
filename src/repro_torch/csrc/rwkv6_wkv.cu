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
// CTA owns (b, h) and walks the chunks in a loop, the 16 KB state in shared
// memory throughout; at the serving shape (B 8, H 32) that is 256 CTAs of
// 51 KB, all resident at once on 132 SMs.  r, k, v and logw are read in the
// model's [B, T, H, C] layout, where a head's 64 floats are one 256-byte
// row: no transposing copy.
//
// Bound on the H100 at rwkv6-1.6b's prefill shape (B 8, T 2048, H 32):
// r, k, v, logw and y are 0.671 GB, 0.200 ms at 3.35 TB/s; about 11 GFLOP
// of float32 arithmetic (A once per (b, h, chunk), then the inter-chunk
// product, the intra-chunk sum and the state update), 0.16 ms at 67 TFLOP/s.
// So: bytes.
//
// Design (a simple kernel that is right; float32 has no exact tensor-core
// path, and TF32 would miss the reference's 2e-4):
//  * Per chunk the CTA stages r, k, v and logw (one float4 of each a
//    thread), loads the next chunk's into registers while it computes, and
//    keeps five barriers a chunk.
//  * Precision: a step's log-decay reaches -87.5 at the wrapper's 1e-38
//    clamp, so a chunk's prefix sum reaches about -1400, where the float32
//    difference of two prefix sums keeps none of the bits of a small
//    exponent.  The prefix sums (one thread a channel) and the pairwise
//    differences are float64; each exponent is rounded to float32 once
//    before expf.  Every exponent is <= 0: nothing overflows.
//  * A [Q, Q] is shared by every value column: it is computed once per
//    chunk, two threads per pair (t, j), j < t, 32 channels each, the
//    strict triangle a selection (only those 120 pairs are formed).  The
//    channels are staggered across lanes so that the shared loads do not
//    collide in banks.
//  * y: a thread owns 4 value columns of one step; the inter-chunk sum over
//    the 64 channels adds two blocks of 32.  The state update: a thread
//    owns a 4 x 4 tile of [C, V] and writes it back to shared memory; the
//    final state goes out from the same threads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 16;   // chunk
constexpr int C = 64;   // key dim (head dim)
constexpr int V = 64;   // value dim
constexpr int kThreads = 256;
constexpr int kPairs = Q * (Q - 1) / 2;   // strictly lower pairs of A

// shared memory layout, in floats (cum first: float64, 8-byte aligned)
constexpr int kCum = 0;               // cum [Q + 1][C] float64: cum[t] = sum_{s<t} logw_s
constexpr int kHs = kCum + 2 * (Q + 1) * C;   // state [C][V]
constexpr int kRs = kHs + C * V;      // r [Q][C]
constexpr int kKs = kRs + Q * C;      // k [Q][C]
constexpr int kVs = kKs + Q * C;      // v [Q][V]
constexpr int kLw = kVs + Q * V;      // logw [Q][C]
constexpr int kRdec = kLw + Q * C;    // r exp(cwx) [Q][C]
constexpr int kKdec = kRdec + Q * C;  // k exp(cw_Q - cw) [Q][C]
constexpr int kA = kKdec + Q * C;     // A [Q][Q]
constexpr int kBonus = kA + Q * Q;    // r_t . u k_t [Q]
constexpr int kCdec = kBonus + Q;     // exp(cw_Q) [C]
constexpr int kSmemFloats = kCdec + C;

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  const float* h0;  // may be null: start from zeros
  float* y;
  float* h;
  int T, H;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void fma4(float4& acc, const float a, const float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__global__ void __launch_bounds__(kThreads) wkv6_fwd(Args a) {
  extern __shared__ __align__(16) float sm[];
  double* cum = reinterpret_cast<double*>(sm + kCum);
  float* hs = sm + kHs;
  float* rs = sm + kRs;
  float* ks = sm + kKs;
  float* vs = sm + kVs;
  float* lws = sm + kLw;
  float* rdec = sm + kRdec;
  float* kdec = sm + kKdec;
  float* As = sm + kA;
  float* bonus = sm + kBonus;
  float* cdec = sm + kCdec;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int H = a.H;
  const long long T = a.T;
  const int nc = a.T / Q;
  const long long row = (long long)H * C;   // floats between steps

  // staging, y and the state tile: step / channel row (tid >> 4), 4 columns
  const int tq = tid >> 4;
  const int c4 = (tid & 15) * 4;
  const int c0 = 4 * tq;  // the state tile's 4 channel rows
  // A's pair (t, j), j < t, and this thread's half of the channels
  const int pair = tid >> 1;
  const int half = tid & 1;
  int pt = 0, pj = 0;
  if (pair < kPairs) {
    while ((pt + 1) * pt / 2 <= pair) ++pt;
    pj = pair - pt * (pt - 1) / 2;
  }
  const int stagger = (pair + 16 * half) & 31;

  const float* ug = a.u + (long long)h * C;
  const float u_lo = ug[lane], u_hi = ug[lane + 32];

  // the state at the start: this thread's tile of h0, or zeros
  const long long hoff = ((long long)b * H + h) * C * V;
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    const float4 v0 = a.h0 ? ld4(a.h0 + hoff + (c0 + cc) * V + c4) : make_float4(0.f, 0.f, 0.f, 0.f);
    st4(hs + (c0 + cc) * V + c4, v0);
  }

  const long long base = ((long long)b * T * H + h) * C + tq * row + c4;
  float4 nr = ld4(a.r + base), nk = ld4(a.k + base), nv = ld4(a.v + base),
         nw = ld4(a.lw + base);

  for (int c = 0; c < nc; ++c) {
    __syncthreads();  // the previous chunk is done with the staged operands
    st4(rs + tq * C + c4, nr);
    st4(ks + tq * C + c4, nk);
    st4(vs + tq * V + c4, nv);
    st4(lws + tq * C + c4, nw);
    __syncthreads();
    if (c + 1 < nc) {  // the next chunk's operands, in flight while this one computes
      const long long off = base + (long long)(c + 1) * Q * row;
      nr = ld4(a.r + off);
      nk = ld4(a.k + off);
      nv = ld4(a.v + off);
      nw = ld4(a.lw + off);
    }

    if (tid < C) {  // prefix sums of the log-decay, one channel a thread, float64
      double s = 0.0;
      cum[tid] = 0.0;
#pragma unroll
      for (int t = 0; t < Q; ++t) {
        s += (double)lws[t * C + tid];
        cum[(t + 1) * C + tid] = s;
      }
      cdec[tid] = expf((float)s);
    } else {  // the diagonal bonus r_t . (u k_t), one warp a step
      for (int t = warp - 2; t < Q; t += kThreads / 32 - 2) {
        float p = rs[t * C + lane] * u_lo * ks[t * C + lane] +
                  rs[t * C + lane + 32] * u_hi * ks[t * C + lane + 32];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
        if (lane == 0) bonus[t] = p;
      }
    }
    __syncthreads();

    // r exp(cwx) and k exp(cw_Q - cw): this thread's 4 entries of each
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int ch = c4 + m;
      rdec[tq * C + ch] = rs[tq * C + ch] * expf((float)cum[tq * C + ch]);
      kdec[tq * C + ch] = ks[tq * C + ch] * expf((float)(cum[Q * C + ch] - cum[(tq + 1) * C + ch]));
    }
    // A_tj = sum_c r_tc k_jc exp(cwx_tc - cw_jc), j < t: 32 channels a thread
    // (every lane takes part in the pair's shuffle; lanes past the pairs add 0)
    float acc = 0.f;
    if (pair < kPairs) {
      const double* ct = cum + pt * C + 32 * half;
      const double* cj = cum + (pj + 1) * C + 32 * half;
      const float* rt = rs + pt * C + 32 * half;
      const float* kj = ks + pj * C + 32 * half;
#pragma unroll 8
      for (int i = 0; i < 32; ++i) {
        const int ch = (i + stagger) & 31;
        const float e = expf((float)(ct[ch] - cj[ch]));
        acc = fmaf(rt[ch] * kj[ch], e, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (pair < kPairs && half == 0) As[pt * Q + pj] = acc;
    __syncthreads();

    // y_t: the inter-chunk term in two blocks of 32 channels, then the
    // intra-chunk sum and the bonus
    {
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      const float* rd = rdec + tq * C;
#pragma unroll 8
      for (int ch = 0; ch < 32; ++ch) fma4(lo, rd[ch], ld4(hs + ch * V + c4));
#pragma unroll 8
      for (int ch = 32; ch < C; ++ch) fma4(hi, rd[ch], ld4(hs + ch * V + c4));
      float4 intra = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < tq; ++j) fma4(intra, As[tq * Q + j], ld4(vs + j * V + c4));
      const float4 vt = ld4(vs + tq * V + c4);
      const float bt = bonus[tq];
      float4 out;
      out.x = fmaf(bt, vt.x, (lo.x + hi.x) + intra.x);
      out.y = fmaf(bt, vt.y, (lo.y + hi.y) + intra.y);
      out.z = fmaf(bt, vt.z, (lo.z + hi.z) + intra.z);
      out.w = fmaf(bt, vt.w, (lo.w + hi.w) + intra.w);
      st4(a.y + base + (long long)c * Q * row, out);
    }
    __syncthreads();  // every y has read the state

    // h_end = exp(cw_Q) h_start + sum_j kdec_j v_j^T on this thread's tile
    {
      float4 s[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) s[cc] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int j = 0; j < Q; ++j) {
        const float4 vj = ld4(vs + j * V + c4);
        const float4 kd = ld4(kdec + j * C + c0);
        fma4(s[0], kd.x, vj);
        fma4(s[1], kd.y, vj);
        fma4(s[2], kd.z, vj);
        fma4(s[3], kd.w, vj);
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float* hp = hs + (c0 + cc) * V + c4;
        const float4 old = ld4(hp);
        const float g = cdec[c0 + cc];
        st4(hp, make_float4(fmaf(g, old.x, s[cc].x), fmaf(g, old.y, s[cc].y),
                            fmaf(g, old.z, s[cc].z), fmaf(g, old.w, s[cc].w)));
      }
    }
  }

  // the final state: each thread's own tile, written by itself above
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    st4(a.h + hoff + (c0 + cc) * V + c4, ld4(hs + (c0 + cc) * V + c4));
  }
}

}  // namespace

extern "C" {

// r, k, v, logw [B, T, H, 64], u [H, 64], h0 [B, H, 64, 64] or null,
// y [B, T, H, 64], h [B, H, 64, 64]; all contiguous float32, T a multiple
// of 16.  h0 and h may be the same buffer.  Returns cudaGetLastError()
// after the launch.
int rwkv6_wkv_launch(const float* r, const float* k, const float* v, const float* logw,
                     const float* u, const float* h0, float* y, float* h, int B, int T, int H,
                     void* stream) {
  if (B <= 0 || H <= 0 || T < 0 || T % Q != 0 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (T == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)kSmemFloats * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(wkv6_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Args a{r, k, v, logw, u, h0, y, h, T, H};
  wkv6_fwd<<<dim3((unsigned)H, (unsigned)B), kThreads, smem,
             reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
