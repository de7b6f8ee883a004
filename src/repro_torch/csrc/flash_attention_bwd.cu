// flash_attention_bwd: the gradient of flash attention (bf16, causal or
// bidirectional, grouped-query heads) from the forward's row log-sum-exp:
//   P    = exp(scale q k^T - lse)            (recomputed tile by tile)
//   Dvec = rowsum(dout * out)
//   dS   = P * (dout v^T - Dvec) * scale
//   dq   = dS k,   dk = dS^T q,   dv = P^T dout
// with dk and dv summed over the G = H / Hkv query heads of each kv head.
//
// Replaces the reference's blockwise custom-VJP backward
// _flash_flat_cvjp_bwd (src/repro/models/attention.py), which recomputes
// the scores from the forward's saved m and l, in jnp; the forward it
// differentiates is the Pallas kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py), ported as
// fa_wgmma_bf16 (flash_attention.cu), which writes lse for this kernel.
//
// Bound on the H100 at llama3.2-1b's training shape (B 8, H 32, Hkv 8,
// S 2048, D 64, causal): operations.  The algorithm's five products over
// the causal pairs need 2.5x the forward's, 10 B H D S (S + 1) / 2 = 344
// GFLOP, 0.35 ms at 989 TFLOP/s; q, k, v, out, dout, lse and the three
// gradients are 302 MB, 0.09 ms at 3.35 TB/s.
//
// Design: no float atomics, so a step's gradients are the same bits every
// run (the restart gate of training needs it).  Three launches:
//  * fa_bwd_dot: Dvec [B, H, S] in float32, one warp a row.
//  * fa_bwd_dkdv: a CTA owns 64 kv rows of one (b, kv head) and walks the
//    G query heads of its group and every query tile that sees its keys,
//    in a fixed order, with dK and dV accumulated in float32 registers;
//    four warps take 16 kv rows each.  It computes S^T = K Q^T and
//    dP^T = V dout^T, so P^T and dS^T are already the A operands of
//    dV += P^T dout and dK += dS^T Q.
//  * fa_bwd_dq: a CTA owns 64 query rows of one (b, head) and walks the kv
//    tiles up to the diagonal, recomputing S and dP, dQ += dS K.
//  Products are mma.sync m16n8k16 with bf16 operands and float32
//  accumulators, fed by ldmatrix (.trans where the product reads a tile
//  along its rows) from shared memory rows padded by 16 bytes, so the
//  eight rows of an ldmatrix fall in eight distinct bank groups.  Tiles
//  arrive by cp.async (16 bytes a thread, zero-filled past S).  P and dS
//  enter their second products rounded to bf16, as the tensor cores take
//  them; the reference keeps them in float32.
//  Causal: a kv tile's CTA starts at the query tile of its first row, and
//  a query tile's CTA stops at the kv tile of its last row; pairs above
//  the diagonal, past S in either direction, get P = 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // the kv rows (dkdv) or query rows (dq) a CTA owns
constexpr int kTileQ = 32;          // query rows a dkdv step reads
constexpr int kTileK = 64;          // kv rows a dq step reads
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* g;  // dout
  const float* lse;        // [B, H, S]
  float* dvec;             // [B, H, S], written by fa_bwd_dot
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  // element strides over (batch, head, row); the head dim is contiguous
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os, gb, gh, gs;
  long long dqb, dqh, dqs, dkb, dkh, dks, dvb, dvh, dvs;
  int H, S, group, causal;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros where !valid (src not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + R) of a [S, D] bf16 matrix (row stride rs) into a shared
// tile of row stride D + 8, rows past S zero
template <int D, int R>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long rs, int r0, int S) {
  constexpr int kChunks = D / 8;  // 16-byte pieces of a row
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = r0 + r < S;
    const __nv_bfloat16* src = base + (long long)(valid ? r0 + r : 0) * rs + c * 8;
    cp_async16(smem_u32(dst + r * (D + 8) + c * 8), src, valid);
  }
}

__device__ __forceinline__ void ldm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c[16 x 8] += A[16 x 16] B[16 x 8], bf16 operands, float32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offsets of this lane's ldmatrix row in a tile of row stride LD:
// A operand (or B read .trans) at (r0, c0): rows r0 + lane % 16, column
// block lane / 16; B read as is at (n0, k0): rows n0 + lane % 8 + 8 (lane /
// 16), column block (lane / 8) % 2.
template <int LD>
__device__ __forceinline__ uint32_t a_off(int lane, int r0, int c0) {
  return (uint32_t)(((r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8) * 2);
}
template <int LD>
__device__ __forceinline__ uint32_t b_off(int lane, int n0, int k0) {
  return (uint32_t)(((n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 + ((lane >> 3) & 1) * 8) *
                    2);
}

// the accumulators of two adjacent 16 x 8 tiles as one 16 x 16 A operand
__device__ __forceinline__ void as_a(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

template <int D>
__global__ void __launch_bounds__(256) fa_bwd_dot(const BwdArgs a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.x * 8 + warp, h = blockIdx.y, b = blockIdx.z;
  if (s >= a.S) return;
  const __nv_bfloat162* o =
      reinterpret_cast<const __nv_bfloat162*>(a.o + b * a.ob + h * a.oh + s * a.os);
  const __nv_bfloat162* g =
      reinterpret_cast<const __nv_bfloat162*>(a.g + b * a.gb + h * a.gh + s * a.gs);
  float acc = 0.f;
  for (int c = lane; c < D / 2; c += 32) {
    const float2 x = __bfloat1622float2(o[c]), y = __bfloat1622float2(g[c]);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.dvec[((long long)b * a.H + h) * a.S + s] = acc;
}

template <int D>
struct DkdvSmem {
  static constexpr int LD = D + 8;
  static constexpr int kBytes = (2 * kRows + 2 * kTileQ) * LD * 2 + 2 * kTileQ * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_dkdv(const BwdArgs a) {
  constexpr int LD = D + 8;
  constexpr int NT = D / 8;   // 8-column tiles of a gradient row block
  constexpr int KS = D / 16;  // k-steps over the head dim
  constexpr int QN = kTileQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kRows * LD;
  __nv_bfloat16* Qs = Vs + kRows * LD;
  __nv_bfloat16* Gs = Qs + kTileQ * LD;
  float* Ls = reinterpret_cast<float*>(Gs + kTileQ * LD);  // lse, log2 units
  float* Ds = Ls + kTileQ;                                 // Dvec

  const int S = a.S;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int kr_a = k0 + warp * 16 + g, kr_b = kr_a + 8;  // this thread's kv rows
  const uint32_t ks_s = smem_u32(Ks), vs_s = smem_u32(Vs), qs_s = smem_u32(Qs),
                 gs_s = smem_u32(Gs);
  load_tile<D, kRows>(Ks, a.k + b * a.kb + hk * a.kh, a.ks, k0, S);
  load_tile<D, kRows>(Vs, a.v + b * a.vb + hk * a.vh, a.vs, k0, S);

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;
  const float sl2 = a.scale * kLog2e;
  const int nq = (S + kTileQ - 1) / kTileQ;
  const int qt0 = a.causal ? k0 / kTileQ : 0;

  for (int hg = 0; hg < a.group; ++hg) {
    const int h = hk * a.group + hg;
    const __nv_bfloat16* qp = a.q + b * a.qb + h * a.qh;
    const __nv_bfloat16* gp = a.g + b * a.gb + h * a.gh;
    const float* lp = a.lse + ((long long)b * a.H + h) * S;
    const float* dp = a.dvec + ((long long)b * a.H + h) * S;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * kTileQ;
      __syncthreads();  // every warp is done with the previous tile
      load_tile<D, kTileQ>(Qs, qp, a.qs, q0, S);
      load_tile<D, kTileQ>(Gs, gp, a.gs, q0, S);
      for (int i = threadIdx.x; i < kTileQ; i += kThreads) {
        const bool in = q0 + i < S;
        Ls[i] = in ? lp[q0 + i] * kLog2e : 0.f;
        Ds[i] = in ? dp[q0 + i] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();

      // S^T = K_w Q^T and dP^T = V_w dout^T, [16 x kTileQ] each
      float st[QN][4], pt[QN][4];
#pragma unroll
      for (int n = 0; n < QN; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[n][i] = pt[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        const uint32_t ao = a_off<LD>(lane, warp * 16, kk * 16);
        ldm_x4(ka, ks_s + ao);
        ldm_x4(va, vs_s + ao);
#pragma unroll
        for (int np = 0; np < QN / 2; ++np) {
          uint32_t qf[4], gf[4];
          const uint32_t bo = b_off<LD>(lane, np * 16, kk * 16);
          ldm_x4(qf, qs_s + bo);
          ldm_x4(gf, gs_s + bo);
          mma(st[2 * np], ka, qf[0], qf[1]);
          mma(st[2 * np + 1], ka, qf[2], qf[3]);
          mma(pt[2 * np], va, gf[0], gf[1]);
          mma(pt[2 * np + 1], va, gf[2], gf[3]);
        }
      }
      // P^T into st, dS^T into pt: element (kv row kr, query q0 + 8 n + 2 t + i % 2)
#pragma unroll
      for (int n = 0; n < QN; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = 8 * n + 2 * t + (i & 1);
          const int kr = i < 2 ? kr_a : kr_b;
          const int qr = q0 + qc;
          float p = exp2f(fmaf(st[n][i], sl2, -Ls[qc]));
          if (qr >= S || kr >= S || (a.causal && qr < kr)) p = 0.f;
          st[n][i] = p;
          pt[n][i] = p * (pt[n][i] - Ds[qc]) * a.scale;
        }
      }
      // dV_w += P^T dout, dK_w += dS^T Q: k-steps over the tile's query rows
#pragma unroll
      for (int j = 0; j < kTileQ / 16; ++j) {
        uint32_t pa[4], sa[4];
        as_a(pa, st[2 * j], st[2 * j + 1]);
        as_a(sa, pt[2 * j], pt[2 * j + 1]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t gf[4], qf[4];
          const uint32_t to = a_off<LD>(lane, j * 16, np * 16);
          ldm_x4_t(gf, gs_s + to);
          ldm_x4_t(qf, qs_s + to);
          mma(dv[2 * np], pa, gf[0], gf[1]);
          mma(dv[2 * np + 1], pa, gf[2], gf[3]);
          mma(dk[2 * np], sa, qf[0], qf[1]);
          mma(dk[2 * np + 1], sa, qf[2], qf[3]);
        }
      }
    }
  }

  __nv_bfloat16* dkp = a.dk + b * a.dkb + hk * a.dkh;
  __nv_bfloat16* dvp = a.dv + b * a.dvb + hk * a.dvh;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    if (kr_a < S) {
      *reinterpret_cast<uint32_t*>(dkp + kr_a * a.dks + c) = pack_bf16(dk[n][0], dk[n][1]);
      *reinterpret_cast<uint32_t*>(dvp + kr_a * a.dvs + c) = pack_bf16(dv[n][0], dv[n][1]);
    }
    if (kr_b < S) {
      *reinterpret_cast<uint32_t*>(dkp + kr_b * a.dks + c) = pack_bf16(dk[n][2], dk[n][3]);
      *reinterpret_cast<uint32_t*>(dvp + kr_b * a.dvs + c) = pack_bf16(dv[n][2], dv[n][3]);
    }
  }
}

template <int D>
struct DqSmem {
  static constexpr int LD = D + 8;
  static constexpr int kBytes = (2 * kRows + 2 * kTileK) * LD * 2;
};

template <int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_dq(const BwdArgs a) {
  constexpr int LD = D + 8;
  constexpr int NT = D / 8;
  constexpr int KS = D / 16;
  constexpr int KN = kTileK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Gs = Qs + kRows * LD;
  __nv_bfloat16* Ks = Gs + kRows * LD;
  __nv_bfloat16* Vs = Ks + kTileK * LD;

  const int S = a.S;
  const int nq = (S + kRows - 1) / kRows;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kRows;  // the heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int qr_a = q0 + warp * 16 + g, qr_b = qr_a + 8;  // this thread's query rows
  const uint32_t qs_s = smem_u32(Qs), gs_s = smem_u32(Gs), ks_s = smem_u32(Ks),
                 vs_s = smem_u32(Vs);
  load_tile<D, kRows>(Qs, a.q + b * a.qb + h * a.qh, a.qs, q0, S);
  load_tile<D, kRows>(Gs, a.g + b * a.gb + h * a.gh, a.gs, q0, S);
  const float* lp = a.lse + ((long long)b * a.H + h) * S;
  const float* dp = a.dvec + ((long long)b * a.H + h) * S;
  const float l_a = qr_a < S ? lp[qr_a] * kLog2e : 0.f, l_b = qr_b < S ? lp[qr_b] * kLog2e : 0.f;
  const float d_a = qr_a < S ? dp[qr_a] : 0.f, d_b = qr_b < S ? dp[qr_b] : 0.f;
  const float sl2 = a.scale * kLog2e;

  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;
  const __nv_bfloat16* kp = a.k + b * a.kb + hk * a.kh;
  const __nv_bfloat16* vp = a.v + b * a.vb + hk * a.vh;
  const int nk = (S + kTileK - 1) / kTileK;
  const int ntiles = a.causal ? min(nk, (q0 + kRows - 1) / kTileK + 1) : nk;

  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * kTileK;
    __syncthreads();
    load_tile<D, kTileK>(Ks, kp, a.ks, k0, S);
    load_tile<D, kTileK>(Vs, vp, a.vs, k0, S);
    cp_async_wait_all();
    __syncthreads();

    // S = Q_w K^T and dP = dout_w V^T, [16 x kTileK] each
    float s[KN][4], dpv[KN][4];
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dpv[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], ga[4];
      const uint32_t ao = a_off<LD>(lane, warp * 16, kk * 16);
      ldm_x4(qa, qs_s + ao);
      ldm_x4(ga, gs_s + ao);
#pragma unroll
      for (int np = 0; np < KN / 2; ++np) {
        uint32_t kf[4], vf[4];
        const uint32_t bo = b_off<LD>(lane, np * 16, kk * 16);
        ldm_x4(kf, ks_s + bo);
        ldm_x4(vf, vs_s + bo);
        mma(s[2 * np], qa, kf[0], kf[1]);
        mma(s[2 * np + 1], qa, kf[2], kf[3]);
        mma(dpv[2 * np], ga, vf[0], vf[1]);
        mma(dpv[2 * np + 1], ga, vf[2], vf[3]);
      }
    }
    // dS into s: element (query row, kv column k0 + 8 n + 2 t + i % 2)
#pragma unroll
    for (int n = 0; n < KN; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kc = k0 + 8 * n + 2 * t + (i & 1);
        const int qr = i < 2 ? qr_a : qr_b;
        float p = exp2f(fmaf(s[n][i], sl2, -(i < 2 ? l_a : l_b)));
        if (kc >= S || qr >= S || (a.causal && kc > qr)) p = 0.f;
        s[n][i] = p * (dpv[n][i] - (i < 2 ? d_a : d_b)) * a.scale;
      }
    }
    // dQ_w += dS K: k-steps over the tile's kv rows
#pragma unroll
    for (int j = 0; j < kTileK / 16; ++j) {
      uint32_t sa[4];
      as_a(sa, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldm_x4_t(kf, ks_s + a_off<LD>(lane, j * 16, np * 16));
        mma(dq[2 * np], sa, kf[0], kf[1]);
        mma(dq[2 * np + 1], sa, kf[2], kf[3]);
      }
    }
  }

  __nv_bfloat16* dqp = a.dq + b * a.dqb + h * a.dqh;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    if (qr_a < S)
      *reinterpret_cast<uint32_t*>(dqp + qr_a * a.dqs + c) = pack_bf16(dq[n][0], dq[n][1]);
    if (qr_b < S)
      *reinterpret_cast<uint32_t*>(dqp + qr_b * a.dqs + c) = pack_bf16(dq[n][2], dq[n][3]);
  }
}

template <int D>
cudaError_t run_bwd(const BwdArgs& a, int B, int Hkv, cudaStream_t st) {
  const int S = a.S;
  fa_bwd_dot<D><<<dim3((unsigned)((S + 7) / 8), (unsigned)a.H, (unsigned)B), 256, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DkdvSmem<D>::kBytes);
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv<D><<<dim3((unsigned)((S + kRows - 1) / kRows), (unsigned)Hkv, (unsigned)B),
                   kThreads, DkdvSmem<D>::kBytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DqSmem<D>::kBytes);
  if (err != cudaSuccess) return err;
  fa_bwd_dq<D><<<dim3((unsigned)((S + kRows - 1) / kRows), (unsigned)a.H, (unsigned)B), kThreads,
                 DqSmem<D>::kBytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The bf16 backward: q, out, dout, dq [B, H, S, D]; k, v, dk, dv [B, Hkv,
// S, D], each given by its element strides over (batch, head, row) with
// the head dim contiguous and rows 16-byte aligned; lse the forward's
// contiguous float32 [B, H, S]; dvec a float32 [B, H, S] scratch.  D in
// {64, 112, 128}; H % Hkv == 0.  Three launches on `stream`; returns
// cudaGetLastError() after the last.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const float* lse, float* dvec, void* dq,
                               void* dk, void* dv, int B, int H, int Hkv, int S, int D,
                               const long long* strides, int causal, float scale,
                               void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 || H > 65535 ||
      (D != 64 && D != 112 && D != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  if (S <= 0) return (int)cudaSuccess;
  const long long* s = strides;  // q, k, v, out, dout, dq, dk, dv: (batch, head, row) each
  BwdArgs a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
            static_cast<const __nv_bfloat16*>(dout), lse, dvec,
            static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
            static_cast<__nv_bfloat16*>(dv),
            s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
            s[12], s[13], s[14], s[15], s[16], s[17], s[18], s[19], s[20], s[21], s[22], s[23],
            H, S, H / Hkv, causal, scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(D == 64    ? run_bwd<64>(a, B, Hkv, st)
               : D == 112 ? run_bwd<112>(a, B, Hkv, st)
                          : run_bwd<128>(a, B, Hkv, st));
}

// Dynamic shared memory of the dK/dV and dQ kernels at head dim D (bytes).
int flash_attention_bwd_smem_bytes(int D, int which) {
  if (D != 64 && D != 112 && D != 128) return -1;
  if (which == 0) return D == 64 ? DkdvSmem<64>::kBytes : D == 112 ? DkdvSmem<112>::kBytes
                                                                   : DkdvSmem<128>::kBytes;
  return D == 64 ? DqSmem<64>::kBytes : D == 112 ? DqSmem<112>::kBytes : DqSmem<128>::kBytes;
}

}  // extern "C"
