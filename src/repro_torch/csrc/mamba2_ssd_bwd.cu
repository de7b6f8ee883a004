// mamba2_ssd_bwd: the backward of the Mamba2 SSD chunked scan
// (mamba2_ssd.cu), per batch row b and head h, chunks of Q = 128 steps,
// P = N = 64.
//
// Replaces no Pallas kernel: the reference trains through jax.grad of its
// jnp chunked form (src/repro/models/mamba2.py, ssd_chunked), and its
// Pallas SSD has no backward.  The formulas are ref.py's ssd_chunked_bwd,
// in its order.  cum_t is the inclusive prefix sum of dA inside a chunk,
// W_ts = exp(cum_t - cum_s) for s <= t (0 above), M = (C B^T) W and
// E_ts = W_ts (dy_t . xbar_s):
//   G_start = exp(cum_Q) G_end + sum_t exp(cum_t) dy_t C_t^T       (ssd_bwd_state)
//   dxbar_s = exp(cum_Q - cum_s) G_end B_s + sum_{t>=s} M_ts dy_t  (ssd_bwd_chunk)
//   dB_s    = exp(cum_Q - cum_s) G_end^T xbar_s + sum_{t>=s} E_ts C_t   (a head's share)
//   dC_t    = exp(cum_t) h_start^T dy_t + sum_{s<=t} E_ts B_s          (a head's share)
//   ddA_s   = exp(cum_Q) <G_end, h_start> + sum_{t>=s} exp(cum_t) dy_t . (h_start C_t)
//             + sum_{j<s} exp(cum_Q - cum_j) xbar_j . (G_end B_j) + sum_{j<s<=t} F_tj,
// F = (C B^T) E strictly below the diagonal: the paths through step s's
// decay inside its chunk, each term carrying that decay, so nothing cancels.
// dB and dC are written per head and summed over the heads by the caller
// in one fixed order: no atomics, the same bits every call.
//
// Two launches, as the forward: ssd_bwd_state, one CTA a (b, h), walks the
// chunks in reverse and writes G_end of every chunk (the forward's hs
// layout); ssd_bwd_chunk, one CTA a (b, chunk, h), computes the chunk's
// gradients from the forward's chunk-start states (hs) and G_end.
//
// Bound on the H100 at zamba2-7b's training shape (B 8, L 2048, H 112): it
// reads xbar, dy (0.470 GB each), dA, B, C and the chunk-start states
// (0.470 GB) and writes dxbar, ddA, dB, dC (0.479 GB): about 1.90 GB,
// 0.57 ms at 3.35 TB/s.  Its products, as this kernel forms them (64-row
// blocks, the diagonal blocks whole), are about 157 GFLOP, 2.35 ms at 67
// TFLOP/s of float32; the chunked algebra needs about 91 GFLOP (1.36 ms).
// So: operations.
//
// Design (simple first): every product runs on the CUDA cores in float32
// FMAs, as 64 x 64 x 64 block products out of shared memory, each thread
// holding a 4 x 4 tile of the output (rows ty + 16 i, columns tx + 16 j);
// rows are padded to 65 floats, so a warp reads any row or column of an
// operand from 32 banks.  A 128-step chunk is three pairs of 64-step
// blocks (target t-block, source s-block): (0, 0), (1, 0), (1, 1); dx and
// dB of an s-block and dC of a t-block stay in registers until their last
// pair.  h_start, M, E and F share one buffer, one after the other; the
// sums of F over j < s <= t are a row prefix and a column sum of each
// block (below the diagonal, a column sum and a row sum).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 128;  // chunk
constexpr int P = 64;   // head dim
constexpr int N = 64;   // state dim
constexpr int Bk = 64;  // block of steps
constexpr int kThreads = 256;
constexpr int kLd = 65;          // padded row of a 64 x 64 block
constexpr int kBlock = Bk * kLd;

__device__ __forceinline__ double warp_scan_incl(double v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// cum[t] = sum_{s<=t} dA[t0 + s] (t < Q) in float64; warp 0 only, four
// steps a lane, then a scan over the lanes
__device__ __forceinline__ void chunk_cumsum(const float* dA, long long stride, double* cum,
                                             int lane) {
  double v[4];
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s += (double)dA[(long long)(4 * lane + i) * stride];
    v[i] = s;
  }
  const double before = warp_scan_incl(s, lane) - s;
#pragma unroll
  for (int i = 0; i < 4; ++i) cum[4 * lane + i] = before + v[i];
}

// ---------------------------------------------------------------------------
// ssd_bwd_state: G_end of every chunk, the chunks in reverse
// ---------------------------------------------------------------------------

struct StateArgs {
  const float* dA;   // [B, L, H]
  const float* C;    // [B, L, N]
  const float* dy;   // [B, L, H, P]
  const float* dh;   // [B, H, P, N] or null
  float* dhs;        // [B, L / Q, H, P, N]
  int L, H;
};

constexpr int kStDy = 0;                    // exp(cum_t) dy_t [Q][P]
constexpr int kStC = kStDy + Q * P;         // C [Q][N]
constexpr int kStCum = kStC + Q * N;        // cum [Q] float64
constexpr int kStFloats = kStCum + 2 * Q;

__global__ void __launch_bounds__(kThreads) ssd_bwd_state(StateArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* dys = sm + kStDy;
  float* cs = sm + kStC;
  double* cum = reinterpret_cast<double*>(sm + kStCum);
  const int tid = threadIdx.x, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int H = a.H, nc = a.L / Q;
  const int p0 = 4 * (tid >> 4), n0 = 4 * (tid & 15);
  const long long hoff = ((long long)b * H + h) * P * N;

  float g[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 q = a.dh ? *reinterpret_cast<const float4*>(a.dh + hoff + (p0 + i) * N + n0)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    g[i][0] = q.x;
    g[i][1] = q.y;
    g[i][2] = q.z;
    g[i][3] = q.w;
  }

  for (int c = nc - 1; c >= 0; --c) {
    float* out = a.dhs + (((long long)b * nc + c) * H + h) * P * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(out + (p0 + i) * N + n0) =
          make_float4(g[i][0], g[i][1], g[i][2], g[i][3]);
    }
    __syncthreads();  // the previous chunk is done with the buffers
    const long long t0 = (long long)b * a.L + (long long)c * Q;
    for (int e = tid; e < Q * P / 4; e += kThreads) {
      const int t = e >> 4, c4 = (e & 15) * 4;
      *reinterpret_cast<float4*>(dys + t * P + c4) =
          *reinterpret_cast<const float4*>(a.dy + ((t0 + t) * H + h) * P + c4);
      *reinterpret_cast<float4*>(cs + t * N + c4) =
          *reinterpret_cast<const float4*>(a.C + (t0 + t) * N + c4);
    }
    if (tid < 32) chunk_cumsum(a.dA + t0 * H + h, H, cum, lane);
    __syncthreads();
    for (int e = tid; e < Q * P; e += kThreads) dys[e] *= expf((float)cum[e / P]);
    __syncthreads();
    const float cd = expf((float)cum[Q - 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) g[i][j] *= cd;
    }
#pragma unroll 4
    for (int t = 0; t < Q; ++t) {
      const float4 dv = *reinterpret_cast<const float4*>(dys + t * P + p0);
      const float4 cv = *reinterpret_cast<const float4*>(cs + t * N + n0);
      const float dd[4] = {dv.x, dv.y, dv.z, dv.w}, cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = fmaf(dd[i], cc[j], g[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// ssd_bwd_chunk: one chunk's gradients
// ---------------------------------------------------------------------------

struct ChunkArgs {
  const float* x;    // [B, L, H, P]
  const float* dA;   // [B, L, H]
  const float* Bm;   // [B, L, N]
  const float* Cm;   // [B, L, N]
  const float* hs;   // [B, L / Q, H, P, N]: h_start of every chunk
  const float* dy;   // [B, L, H, P]
  const float* dhs;  // [B, L / Q, H, P, N]: G_end of every chunk
  float* dx;         // [B, L, H, P]
  float* ddA;        // [B, L, H]
  float* dBp;        // [B, L, H, N]: each head's share
  float* dCp;        // [B, L, H, N]
  int L, H;
};

// shared memory, in floats
constexpr int kCkG = 0;                     // G_end [P][kLd]
constexpr int kCkX = kCkG + kBlock;         // xbar of the s-block [Bk][kLd]
constexpr int kCkB = kCkX + kBlock;         // B of the s-block
constexpr int kCkDy = kCkB + kBlock;        // dy of the t-block
constexpr int kCkC = kCkDy + kBlock;        // C of the t-block
constexpr int kCkME = kCkC + kBlock;        // h_start, then M, E and F in turn
constexpr int kCkCum = kCkME + kBlock;      // cum [Q] float64
constexpr int kCkYo = kCkCum + 2 * Q;       // exp(cum_t) dy_t . (h_start C_t) [Q]
constexpr int kCkXi = kCkYo + Q;            // exp(cum_Q - cum_j) xbar_j . (G_end B_j) [Q]
constexpr int kCkStrad = kCkXi + Q;         // sum_{j<s<=t} F_tj [Q]
constexpr int kCkCol = kCkStrad + Q;        // an off-diagonal F block's column sums [Bk]
constexpr int kCkRow = kCkCol + Bk;         // and its row sums [Bk]
constexpr int kCkRed = kCkRow + Bk;         // <G_end, h_start>'s partial sums [8]
constexpr int kCkFloats = kCkRed + 8;

// a 64 x 64 block of rows [t0, t0 + 64) of a [.., ld]-strided global array
// into padded shared rows
__device__ __forceinline__ void load_block(float* dst, const float* src, long long ld, int tid) {
#pragma unroll
  for (int i = 0; i < Bk * 64 / 4 / kThreads; ++i) {
    const int e = tid + kThreads * i;
    const int r = e >> 4, c4 = (e & 15) * 4;
    const float4 q = *reinterpret_cast<const float4*>(src + r * ld + c4);
    float* d = dst + r * kLd + c4;
    d[0] = q.x;
    d[1] = q.y;
    d[2] = q.z;
    d[3] = q.w;
  }
}

// acc[i][j] += sum_k a(ty + 16 i, k) b(k, tx + 16 j), k < 64
template <class FA, class FB>
__device__ __forceinline__ void mm64(float (&acc)[4][4], FA a, FB b, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < 64; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a(ty + 16 * i, k);
      bv[i] = b(k, tx + 16 * i);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
}

// row i's sum of acc[i][.] * m(row, col) over the tile's 64 columns, into
// out[row] (the 16 threads of a row are 16 lanes of one warp)
template <class FM>
__device__ __forceinline__ void row_dots(const float (&acc)[4][4], FM m, float* out, int ty,
                                         int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) d = fmaf(acc[i][j], m(ty + 16 * i, tx + 16 * j), d);
#pragma unroll
    for (int o = 8; o >= 1; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if (tx == 0) out[ty + 16 * i] = d;
  }
}

__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_chunk(ChunkArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* G = sm + kCkG;
  float* X = sm + kCkX;
  float* Bs = sm + kCkB;
  float* DY = sm + kCkDy;
  float* Cs = sm + kCkC;
  float* ME = sm + kCkME;
  double* cum = reinterpret_cast<double*>(sm + kCkCum);
  float* yo = sm + kCkYo;
  float* xi = sm + kCkXi;
  float* strad = sm + kCkStrad;
  float* colv = sm + kCkCol;
  float* rowv = sm + kCkRow;
  float* red = sm + kCkRed;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int H = a.H, nc = a.L / Q;
  const long long t0 = (long long)b * a.L + (long long)c * Q;   // the chunk's first step
  const long long rowx = (long long)H * P;                     // floats between steps of x
  const float* xc = a.x + t0 * rowx + (long long)h * P;
  const float* dyc = a.dy + t0 * rowx + (long long)h * P;
  const float* Bc = a.Bm + t0 * N;
  const float* Cc = a.Cm + t0 * N;
  const long long soff = (((long long)b * nc + c) * H + h) * P * N;

  // G_end; <G_end, h_start>; cum
  load_block(G, a.dhs + soff, N, tid);
  {
    float z = 0.f;
    for (int e = tid; e < P * N; e += kThreads) z = fmaf(a.dhs[soff + e], a.hs[soff + e], z);
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) z += __shfl_xor_sync(0xffffffffu, z, d);
    if (lane == 0) red[warp] = z;
  }
  if (tid < 32) chunk_cumsum(a.dA + t0 * H + h, H, cum, lane);
  if (tid < Q) strad[tid] = 0.f;

  float dx[4][4], dB[4][4], dC[4][4], tile[4][4], mk[4][4];
  // the pairs (t-block, s-block): (0, 0), (1, 0), (1, 1)
  for (int pair = 0; pair < 3; ++pair) {
    const int tb = pair == 0 ? 0 : 1, sb = pair == 2 ? 1 : 0;
    __syncthreads();  // the buffers about to be loaded are free
    if (pair != 1) {
      load_block(X, xc + (long long)sb * Bk * rowx, rowx, tid);
      load_block(Bs, Bc + (long long)sb * Bk * N, N, tid);
    }
    if (pair != 2) {
      load_block(DY, dyc + (long long)tb * Bk * rowx, rowx, tid);
      load_block(Cs, Cc + (long long)tb * Bk * N, N, tid);
      load_block(ME, a.hs + soff, N, tid);   // h_start, for dC's first term
    }
    __syncthreads();
    if (pair != 1) {
      // the s-block's first terms: exp(cum_Q - cum_s) (G B_s) and (G^T xbar_s)
      zero(dx);
      zero(dB);
      mm64(dx, [&](int s, int n) { return Bs[s * kLd + n]; },
           [&](int n, int p) { return G[p * kLd + n]; }, ty, tx);
      mm64(dB, [&](int s, int p) { return X[s * kLd + p]; },
           [&](int p, int n) { return G[p * kLd + n]; }, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = sb * Bk + ty + 16 * i;
        const float e = expf((float)(cum[Q - 1] - cum[s]));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dx[i][j] *= e;
          dB[i][j] *= e;
        }
      }
      row_dots(dx, [&](int s, int p) { return X[s * kLd + p]; }, xi + sb * Bk, ty, tx);
    }
    if (pair != 2) {
      // the t-block's first term: exp(cum_t) (h_start^T dy_t)
      zero(dC);
      mm64(dC, [&](int t, int p) { return DY[t * kLd + p]; },
           [&](int p, int n) { return ME[p * kLd + n]; }, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf((float)cum[tb * Bk + ty + 16 * i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) dC[i][j] *= e;
      }
      row_dots(dC, [&](int t, int n) { return Cs[t * kLd + n]; }, yo + tb * Bk, ty, tx);
      __syncthreads();   // h_start read: ME is free
    }
    // M = (C B^T) W into ME (and kept), then dx += M^T dy
    zero(tile);
    mm64(tile, [&](int t, int n) { return Cs[t * kLd + n]; },
         [&](int n, int s) { return Bs[s * kLd + n]; }, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tb * Bk + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = sb * Bk + tx + 16 * j;
        mk[i][j] = s <= t ? tile[i][j] * expf((float)(cum[t] - cum[s])) : 0.f;
        ME[(ty + 16 * i) * kLd + tx + 16 * j] = mk[i][j];
      }
    }
    __syncthreads();
    mm64(dx, [&](int s, int t) { return ME[t * kLd + s]; },
         [&](int t, int p) { return DY[t * kLd + p]; }, ty, tx);
    __syncthreads();
    // E = W (dy xbar^T) into ME, then dB += E^T C and dC += E B; F = M (dy
    // xbar^T) strictly below the diagonal stays in the tile
    zero(tile);
    mm64(tile, [&](int t, int p) { return DY[t * kLd + p]; },
         [&](int p, int s) { return X[s * kLd + p]; }, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tb * Bk + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = sb * Bk + tx + 16 * j;
        ME[(ty + 16 * i) * kLd + tx + 16 * j] =
            s <= t ? tile[i][j] * expf((float)(cum[t] - cum[s])) : 0.f;
        tile[i][j] = s < t ? mk[i][j] * tile[i][j] : 0.f;
      }
    }
    __syncthreads();
    mm64(dB, [&](int s, int t) { return ME[t * kLd + s]; },
         [&](int t, int n) { return Cs[t * kLd + n]; }, ty, tx);
    mm64(dC, [&](int t, int s) { return ME[t * kLd + s]; },
         [&](int s, int n) { return Bs[s * kLd + n]; }, ty, tx);

    if (pair != 0) {
      // the s-block's dx and dB are complete
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long st = t0 + sb * Bk + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a.dx[st * rowx + (long long)h * P + tx + 16 * j] = dx[i][j];
          a.dBp[(st * H + h) * N + tx + 16 * j] = dB[i][j];
        }
      }
    }
    if (pair != 1) {
      // the t-block's dC is complete
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long t = t0 + tb * Bk + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) a.dCp[(t * H + h) * N + tx + 16 * j] = dC[i][j];
      }
    }

    // sum_{j<s<=t} F_tj: F into ME
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ME[(ty + 16 * i) * kLd + tx + 16 * j] = tile[i][j];
    }
    __syncthreads();
    if (tb == sb) {
      // a diagonal block: each row's sums over j < s, then over rows t >= s
      if (tid < Bk) {
        float run = 0.f;
        for (int j = 0; j < Bk; ++j) {
          const float v = ME[tid * kLd + j];
          ME[tid * kLd + j] = run;
          run += v;
        }
      }
      __syncthreads();
      if (tid < Bk) {
        float acc = 0.f;
        for (int t = tid; t < Bk; ++t) acc += ME[t * kLd + tid];
        strad[sb * Bk + tid] += acc;
      }
    } else {
      // the block below the diagonal: every t is past every s-block step
      // and every j before every t-block step
      if (tid < Bk) {
        float acc = 0.f;
        for (int t = 0; t < Bk; ++t) acc += ME[t * kLd + tid];
        colv[tid] = acc;
      } else if (tid < 2 * Bk) {
        float acc = 0.f;
        for (int j = 0; j < Bk; ++j) acc += ME[(tid - Bk) * kLd + j];
        rowv[tid - Bk] = acc;
      }
      __syncthreads();
      if (tid < Bk) {
        float acc = 0.f;
        for (int j = 0; j < tid; ++j) acc += colv[j];
        strad[tid] += acc;
      } else if (tid < 2 * Bk) {
        float acc = 0.f;
        for (int t = tid - Bk; t < Bk; ++t) acc += rowv[t];
        strad[tid] += acc;
      }
    }
  }
  __syncthreads();
  // ddA_s = exp(cum_Q) <G_end, h_start> + sum_{t>=s} yo_t + sum_{j<s} xi_j + strad_s
  if (tid < Q) {
    float z = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) z += red[w];
    float d = expf((float)cum[Q - 1]) * z + strad[tid];
    for (int t = tid; t < Q; ++t) d += yo[t];
    for (int j = 0; j < tid; ++j) d += xi[j];
    a.ddA[(t0 + tid) * H + h] = d;
  }
}

}  // namespace

extern "C" {

// xbar, dy [B, L, H, 64], dA [B, L, H], B and C [B, L, 64], hs [B, L / 128,
// H, 64, 64] (the forward's chunk-start states), dh_final [B, H, 64, 64] or
// null; scratch dhs like hs; outputs dxbar [B, L, H, 64], ddA [B, L, H],
// and each head's share of dB and dC, [B, L, H, 64]; all contiguous
// float32, L a multiple of 128.  Returns cudaGetLastError() after the
// second launch.
int mamba2_ssd_bwd_launch(const float* x, const float* dA, const float* Bm, const float* Cm,
                          const float* hs, const float* dy, const float* dh, float* dhs,
                          float* dx, float* ddA, float* dBp, float* dCp, int B, int L, int H,
                          void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || L % Q != 0 || B > 65535 || L / Q > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem1 = (size_t)kStFloats * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(ssd_bwd_state, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  const StateArgs sa{dA, Cm, dy, dh, dhs, L, H};
  ssd_bwd_state<<<dim3((unsigned)H, (unsigned)B), kThreads, smem1, st>>>(sa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = (size_t)kCkFloats * sizeof(float);
  err = cudaFuncSetAttribute(ssd_bwd_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const ChunkArgs ca{x, dA, Bm, Cm, hs, dy, dhs, dx, ddA, dBp, dCp, L, H};
  ssd_bwd_chunk<<<dim3((unsigned)H, (unsigned)(L / Q), (unsigned)B), kThreads, smem2, st>>>(ca);
  return (int)cudaGetLastError();
}

}  // extern "C"
