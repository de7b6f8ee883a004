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
// VMEM scratch from one grid step to the next.  CTAs run in no order, so here
// one CTA owns (b, a tile of Ht heads) and walks the chunks in a loop.  A
// tile's states (16 KB a head) do not fit in shared memory beside the chunk's
// operands, so the state of each head goes back to the output h (device
// memory, in L2 at the serving shape: 14.7 MB) at the end of every chunk and
// is read again at the next one; h holds h_final when the loop ends.
//
// Bound on the H100 at zamba2-7b's prefill shape (B 8, L 2048, H 112): about
// 49 GFLOP of float32 FMAs (C B^T once per chunk and head tile, then per
// head and chunk the causal half of the intra-chunk product, the inter-chunk
// term and the state update), 0.73 ms at 67 TFLOP/s; 0.97 GB in and out,
// 0.29 ms at 3.35 TB/s.  So: operations.
//
// Design (a simple kernel that is right; wgmma and TMA are for later, and
// float32 has no exact tensor-core path: TF32 would miss the reference's
// 2e-4):
//  * Per chunk the CTA stages C^T and B in shared memory and computes the
//    lower 4x4 tiles of C B^T once, into shared memory, shared by the Ht
//    heads of its tile, as the Pallas kernel shares C B^T across its head
//    tile.
//  * Per head: stage xbar's chunk and the state (transposed), prefix-sum dA
//    in one warp, then write W^T[j][i] = (C B^T)[i][j] exp(cum_i - cum_j)
//    from C B^T's tiles.  cum and the differences cum_i - cum_j are float64:
//    cum reaches about -100 inside a chunk, where a float32 ulp is 8e-6,
//    and a few roundings of the prefix sum put the largest outputs 1e-3
//    off; the exponents themselves are rounded to float32 once.  exp is
//    taken only for j <= i; above the diagonal W is 0 by selection, never
//    by multiplying an exp that may be inf.
//  * y: a thread owns 4 columns of two row quads, rows 4a.. and 124-4a..,
//    so that the causal triangle's work is even across threads; three
//    float4 loads feed 32 FMAs.  The state update: a thread owns a 4 x 4
//    tile of [N, P].
//  * Every sum over the chunk's steps (or the state's N) adds blocks of 32
//    terms, each summed on its own first: at weak decay this halved the
//    largest deviation from a float64 recurrence (6.9e-4 to 3.4e-4 on y up
//    to 1.2e3).  The inter-chunk and intra-chunk terms are summed apart and
//    added last, as the reference adds them.
//  * Shared memory 218 KB (one CTA an SM); the wrapper picks Ht so that
//    B * H / Ht CTAs fill the SMs in the fewest waves (B 8, H 112: Ht 7,
//    128 CTAs on 132 SMs).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 128;  // chunk
constexpr int P = 64;   // head dim
constexpr int N = 64;   // state dim
constexpr int kThreads = 256;
constexpr int BS = N + 4;                                       // B row stride (floats)
constexpr int kTiles = (Q / 4) * (Q / 4 + 1) / 2;               // lower 4x4 tiles of C B^T
constexpr int kTilesPerThread = (kTiles + kThreads - 1) / kThreads;
constexpr int kSumBlock = 32;                                   // terms summed apart

// shared memory layout, in floats (every offset 16-byte aligned)
constexpr int kCt = 0;                // C^T [N][Q]
constexpr int kBs = kCt + N * Q;      // B [Q][BS]
constexpr int kWt = kBs + Q * BS;     // W^T [Q][Q]
constexpr int kXs = kWt + Q * Q;      // xbar [Q][P] of the current head
constexpr int kHs = kXs + Q * P;      // state^T [N][P] of the current head
constexpr int kCum = kHs + N * P;     // cum [Q], float64
constexpr int kEcum = kCum + 2 * Q;   // exp(cum_i) [Q]
constexpr int kSdec = kEcum + Q;      // exp(cum_last - cum_j) [Q]
constexpr int kGlast = kSdec + Q;     // exp(cum_last)
constexpr int kCB = kGlast + 4;       // C B^T's lower tiles [kTiles][4][4]
constexpr int kSmemFloats = kCB + kTiles * 16;

struct Args {
  const float* x;
  const float* dA;
  const float* Bm;
  const float* Cm;
  const float* h0;  // may be null: start from zeros
  float* y;
  float* h;
  int L, H, Ht;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// acc += part
__device__ __forceinline__ void add(float (&acc)[4][4], const float (&part)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] += part[r][c];
}

// acc[r][c] += a[r] * b[c]
__device__ __forceinline__ void outer(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
}

__global__ void __launch_bounds__(kThreads, 1) ssd_fwd(Args a) {
  extern __shared__ __align__(16) float sm[];
  float* Ct = sm + kCt;
  float* Bs = sm + kBs;
  float* Wt = sm + kWt;
  float* Xs = sm + kXs;
  float* Hs = sm + kHs;
  double* cum = reinterpret_cast<double*>(sm + kCum);
  float* ecum = sm + kEcum;
  float* sdec = sm + kSdec;
  float* glast = sm + kGlast;
  float* CBs = sm + kCB;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int H = a.H;
  const long long L = a.L;
  const int nc = a.L / Q;

  // this thread's lower tiles of C B^T: tile t = bi (bi + 1) / 2 + bj, bj <= bi
  int ti[kTilesPerThread], tj[kTilesPerThread];
#pragma unroll
  for (int k = 0; k < kTilesPerThread; ++k) {
    const int t = tid + k * kThreads;
    int bi = 0;
    while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
    ti[k] = t < kTiles ? bi : -1;
    tj[k] = t - bi * (bi + 1) / 2;
  }
  // y: 4 columns of two row quads; state update: a 4 x 4 tile of [N, P]
  const int p0 = (tid & 15) * 4;
  const int ra = 4 * (tid >> 4), rb = Q - 4 - ra;
  const int n0 = 4 * (tid >> 4);

  for (int c = 0; c < nc; ++c) {
    const long long t0 = (long long)c * Q;
    __syncthreads();  // the previous chunk is done with Ct and Bs
    const float* Cg = a.Cm + ((long long)b * L + t0) * N;
    const float* Bg = a.Bm + ((long long)b * L + t0) * N;
    // consecutive threads on consecutive rows: the transposed stores hit
    // consecutive banks
    for (int idx = tid; idx < Q * N / 4; idx += kThreads) {
      const int r = idx % Q, c4 = (idx / Q) * 4;
      const float4 cv = ld4(Cg + r * N + c4);
      Ct[(c4 + 0) * Q + r] = cv.x;
      Ct[(c4 + 1) * Q + r] = cv.y;
      Ct[(c4 + 2) * Q + r] = cv.z;
      Ct[(c4 + 3) * Q + r] = cv.w;
      *reinterpret_cast<float4*>(Bs + r * BS + c4) = ld4(Bg + r * N + c4);
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kTilesPerThread; ++k) {
      if (ti[k] < 0) continue;
      const float* bp = Bs + 4 * tj[k] * BS;
      float cb[4][4], part[4][4];
      zero(cb);
      for (int nb = 0; nb < N; nb += kSumBlock) {
        zero(part);
        for (int n = nb; n < nb + kSumBlock; ++n) {
          const float4 bv = make_float4(bp[n], bp[BS + n], bp[2 * BS + n], bp[3 * BS + n]);
          outer(part, ld4(Ct + n * Q + 4 * ti[k]), bv);
        }
        add(cb, part);
      }
      float* dst = CBs + (tid + k * kThreads) * 16;
#pragma unroll
      for (int r = 0; r < 4; ++r) st4(dst + 4 * r, cb[r][0], cb[r][1], cb[r][2], cb[r][3]);
    }

    for (int hh = 0; hh < a.Ht; ++hh) {
      const int h = blockIdx.x * a.Ht + hh;
      __syncthreads();  // the previous head is done with Xs, Hs, Wt and cum
      const float* xg = a.x + (((long long)b * L + t0) * H + h) * P;
      for (int idx = tid; idx < Q * P / 4; idx += kThreads) {
        const int r = idx / (P / 4), c4 = (idx % (P / 4)) * 4;
        *reinterpret_cast<float4*>(Xs + r * P + c4) = ld4(xg + (long long)r * H * P + c4);
      }
      // the state at the chunk's start, transposed: Hs[n][p] = h[p][n]
      const float* hg = c == 0 ? a.h0 : a.h;
      const long long hoff = ((long long)b * H + h) * P * N;
      for (int idx = tid; idx < P * N / 4; idx += kThreads) {
        const int p = idx % P, n4 = (idx / P) * 4;
        const float4 v = hg ? ld4(hg + hoff + p * N + n4) : make_float4(0.f, 0.f, 0.f, 0.f);
        Hs[(n4 + 0) * P + p] = v.x;
        Hs[(n4 + 1) * P + p] = v.y;
        Hs[(n4 + 2) * P + p] = v.z;
        Hs[(n4 + 3) * P + p] = v.w;
      }
      if (tid < 32) {  // cum: an inclusive prefix sum of dA over the chunk
        const float* dg = a.dA + ((long long)b * L + t0) * H + h;
        double v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = dg[(long long)(4 * tid + k) * H];
        v[1] += v[0];
        v[2] += v[1];
        v[3] += v[2];
        double s = v[3];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double o = __shfl_up_sync(0xffffffffu, s, off);
          if (tid >= off) s += o;
        }
        const double base = s - v[3];
        const double last = __shfl_sync(0xffffffffu, s, 31);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const double cv = v[k] + base;
          cum[4 * tid + k] = cv;
          ecum[4 * tid + k] = expf((float)cv);
          sdec[4 * tid + k] = expf((float)(last - cv));
        }
        if (tid == 0) glast[0] = expf((float)last);
      }
      __syncthreads();

      // W^T[j][i] = (C B^T)[i][j] exp(cum_i - cum_j) for j <= i, else 0; the
      // thread reads back the C B^T tiles it wrote
#pragma unroll
      for (int k = 0; k < kTilesPerThread; ++k) {
        if (ti[k] < 0) continue;
        const float* cb = CBs + (tid + k * kThreads) * 16;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * ti[k] + r;
          const double ci = cum[i];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int j = 4 * tj[k] + m;
            Wt[j * Q + i] = j <= i ? cb[4 * r + m] * expf((float)(ci - cum[j])) : 0.f;
          }
        }
      }
      __syncthreads();

      // y: the inter-chunk term exp(cum_i) C_i . h_start and the causal sum,
      // each summed in blocks, added last
      float off[2][4][4], diag[2][4][4], part[2][4][4];
      zero(off[0]);
      zero(off[1]);
      for (int nb = 0; nb < N; nb += kSumBlock) {
        zero(part[0]);
        zero(part[1]);
        for (int n = nb; n < nb + kSumBlock; ++n) {
          const float4 hv = ld4(Hs + n * P + p0);
          outer(part[0], ld4(Ct + n * Q + ra), hv);
          outer(part[1], ld4(Ct + n * Q + rb), hv);
        }
        add(off[0], part[0]);
        add(off[1], part[1]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ea = ecum[ra + r], eb = ecum[rb + r];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          off[0][r][m] *= ea;
          off[1][r][m] *= eb;
        }
      }
      // quad a's rows need j < ra + 4, quad b's j < rb + 4
      zero(diag[0]);
      zero(diag[1]);
      for (int j0 = 0; j0 < rb + 4; j0 += kSumBlock) {
        const int j1 = min(j0 + kSumBlock, rb + 4), ja = min(j1, ra + 4);
        zero(part[0]);
        zero(part[1]);
        int j = j0;
        for (; j < ja; ++j) {
          const float4 xv = ld4(Xs + j * P + p0);
          outer(part[0], ld4(Wt + j * Q + ra), xv);
          outer(part[1], ld4(Wt + j * Q + rb), xv);
        }
        for (; j < j1; ++j) outer(part[1], ld4(Wt + j * Q + rb), ld4(Xs + j * P + p0));
        add(diag[0], part[0]);
        add(diag[1], part[1]);
      }
      float acc[2][4][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int m = 0; m < 4; ++m) acc[q][r][m] = diag[q][r][m] + off[q][r][m];
      float* yg = a.y + (((long long)b * L + t0) * H + h) * P + p0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* ya = acc[0][r];
        const float* yb = acc[1][r];
        st4(yg + (long long)(ra + r) * H * P, ya[0], ya[1], ya[2], ya[3]);
        st4(yg + (long long)(rb + r) * H * P, yb[0], yb[1], yb[2], yb[3]);
      }

      // the state at the next chunk's start, written to h: reads only this
      // thread's own entries of Hs, so no barrier is needed before it
      float s[4][4], sp[4][4];
      zero(s);
      for (int j0 = 0; j0 < Q; j0 += kSumBlock) {
        zero(sp);
        for (int j = j0; j < j0 + kSumBlock; ++j) {
          const float d = sdec[j];
          float4 xv = ld4(Xs + j * P + p0);
          xv.x *= d;
          xv.y *= d;
          xv.z *= d;
          xv.w *= d;
          outer(sp, ld4(Bs + j * BS + n0), xv);
        }
        add(s, sp);
      }
      const float g = glast[0];
      float* hw = a.h + hoff;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int p = p0 + m;
        st4(hw + p * N + n0, fmaf(g, Hs[(n0 + 0) * P + p], s[0][m]),
            fmaf(g, Hs[(n0 + 1) * P + p], s[1][m]), fmaf(g, Hs[(n0 + 2) * P + p], s[2][m]),
            fmaf(g, Hs[(n0 + 3) * P + p], s[3][m]));
      }
    }
  }
}

}  // namespace

extern "C" {

// xbar [B, L, H, 64], dA [B, L, H], Bm / Cm [B, L, 64], h0 [B, H, 64, 64] or
// null, y [B, L, H, 64], h [B, H, 64, 64]; all contiguous float32, L a
// multiple of 128, Ht a divisor of H (heads per CTA).  h0 and h must not
// overlap.  Returns cudaGetLastError() after the launch.
int mamba2_ssd_launch(const float* x, const float* dA, const float* Bm, const float* Cm,
                      const float* h0, float* y, float* h, int B, int L, int H, int Ht,
                      void* stream) {
  if (B <= 0 || H <= 0 || Ht <= 0 || H % Ht != 0 || L < 0 || L % Q != 0 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (L == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)kSmemFloats * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(ssd_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Args a{x, dA, Bm, Cm, h0, y, h, L, H, Ht};
  ssd_fwd<<<dim3((unsigned)(H / Ht), (unsigned)B), kThreads, smem,
            reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
