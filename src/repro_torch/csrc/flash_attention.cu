// flash_attention: online-softmax attention, causal or bidirectional, with
// grouped-query heads (query head h reads kv head h / (H / Hkv)):
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h/G, j]) v[b, h/G, j]
// over j <= i when causal, with float32 scores, running max, running sum
// and accumulator, and the output in the inputs' dtype.
//
// Replaces the Pallas kernel flash_attention_pallas (_fa_kernel) of
// src/repro/kernels/flash_attention/kernel.py.  On the TPU the kv blocks
// were the innermost, sequential grid dimension and m, l and acc lived in
// VMEM scratch from one grid step to the next; CTAs run in no order, so
// here each CTA owns one (b, h, 64-row query tile) and walks the kv tiles
// in a loop, with the running state in registers.
//
// Head dims 64, 112 (zamba2-7b's shared block: 7 k-steps of m16n8k16 and 14
// n-tiles of 8 in bf16, 28 columns a thread in float32) and 128.  The
// reference's wrapper pads D up to a multiple of 128 for the MXU; the
// tensor cores need only multiples of 16, so no head dim is padded here and
// no input is copied.
//
// Bound on the H100 at the serve path's prefill shape (B 8, H 32, Hkv 8,
// S 2048, D 64, causal, bf16): operations.  The causal pairs need
// 4 * B * H * D * S (S + 1) / 2 = 137 GFLOP, 0.139 ms at 989 TFLOP/s on the
// bf16 tensor cores; q, k, v and o are 168 MB, 0.050 ms at 3.35 TB/s.
//
// Design (a simple kernel that is right; wgmma, TMA and warp
// specialisation are for a later change):
//  * bf16: 4 warps per CTA, 16 query rows each.  Q stays in registers as
//    mma.sync A fragments; each 64-row kv tile is staged in shared memory
//    (K row-major, V transposed, rows padded by 8 elements so the fragment
//    loads hit 32 distinct banks).  S = Q K^T and O += P V run on the
//    tensor cores with mma.sync.m16n8k16 (bf16 in, float32 accumulate);
//    the S accumulators are rescaled, masked and exponentiated in
//    registers and repacked as the A fragments of P V without a trip
//    through shared memory.  The reference keeps P in float32 for P V; a
//    bf16 P (2^-9 relative on each weight) moved zamba2-7b's logits by up to
//    0.1 over its 95 blocks, so P enters P V as two bf16 parts, hi = bf16(P)
//    and lo = bf16(P - hi), two MMAs that carry P to about 2^-17; the
//    running sum l adds up the float32 P.
//  * float32: no tensor-core path keeps float32 exact, so 256 threads,
//    four per query row, compute scores and the accumulator with FMAs from
//    shared memory (rows padded by one word so no load conflicts).
//  * Causal: kv tiles above the diagonal are never loaded; tiles are
//    launched heaviest first.  The ragged last tiles are masked: kv columns
//    at or beyond S score -1e30 (exp gives 0, never NaN), query rows beyond
//    S are not stored.  Like the reference, the output divides by
//    max(l, 1e-30).
//  * Inputs may be strided views (the grouped layout arrives transposed):
//    only the head dim must be contiguous, rows 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, group;  // group = H / Hkv
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;  // element strides
  int causal;
  float scale;
};

__device__ __forceinline__ int kv_tiles(const Args& a, int qt) {
  const int nk = (a.S + kBlockK - 1) / kBlockK;
  return a.causal ? min(nk, qt + 1) : nk;  // kBlockQ == kBlockK
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(128) fa_fwd_bf16(Args a) {
  constexpr int KS = D + 8;        // K tile row stride (elements)
  constexpr int VS = kBlockK + 8;  // V^T tile row stride
  constexpr int KSTEPS = D / 16;   // k-steps of Q K^T
  constexpr int DT = D / 8;        // n-tiles of P V
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vt = Ks + kBlockK * KS;

  const int S = a.S;
  const int nq = (S + kBlockQ - 1) / kBlockQ;
  const int qt = nq - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.qb + h * a.qh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.kb + hk * a.kh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.vb + hk * a.vh;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + b * a.ob + h * a.oh;

  // the thread's two query rows (fragment rows g and g + 8 of its warp)
  const int ra = qt * kBlockQ + warp * 16 + g;
  const int rb = ra + 8;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    const int c = s * 16 + 2 * t;
    qa[s][0] = ra < S ? ld32(q + ra * a.qs + c) : 0u;
    qa[s][1] = rb < S ? ld32(q + rb * a.qs + c) : 0u;
    qa[s][2] = ra < S ? ld32(q + ra * a.qs + c + 8) : 0u;
    qa[s][3] = rb < S ? ld32(q + rb * a.qs + c + 8) : 0u;
  }

  float oacc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) oacc[d][0] = oacc[d][1] = oacc[d][2] = oacc[d][3] = 0.f;
  // running max (log2 units) and this lane's part of the running sum
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  const float sl2 = a.scale * kLog2e;

  const int ntiles = kv_tiles(a, qt);
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile is consumed
    constexpr int CH = D / 8;  // 16-byte chunks per row
    for (int idx = threadIdx.x; idx < kBlockK * CH; idx += blockDim.x) {
      const int r = idx % kBlockK, c = (idx / kBlockK) * 8;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < S) {
        kk = *reinterpret_cast<const uint4*>(k + (k0 + r) * a.ks + c);
        vv = *reinterpret_cast<const uint4*>(v + (k0 + r) * a.vs + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * KS + c) = kk;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c + e) * VS + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 kv columns
    float sacc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (n * 8 + g) * KS + 2 * t;
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) mma_bf16(sacc[n], qa[s], ld32(kr + s * 16), ld32(kr + s * 16 + 8));
    }

    // scale, mask, running max
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + n * 8 + 2 * t + (i & 1);
        const int row = i < 2 ? ra : rb;
        float s = sacc[n][i] * sl2;
        if (col >= S || (a.causal && col > row)) s = kNegInf;
        sacc[n][i] = s;
        if (i < 2) mx_a = fmaxf(mx_a, s);
        else mx_b = fmaxf(mx_b, s);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sacc[n][0] = exp2f(sacc[n][0] - mn_a);
      sacc[n][1] = exp2f(sacc[n][1] - mn_a);
      sacc[n][2] = exp2f(sacc[n][2] - mn_b);
      sacc[n][3] = exp2f(sacc[n][3] - mn_b);
      ps_a += sacc[n][0] + sacc[n][1];
      ps_b += sacc[n][2] + sacc[n][3];
    }
    l_a = l_a * al_a + ps_a;
    l_b = l_b * al_b + ps_b;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      oacc[d][0] *= al_a;
      oacc[d][1] *= al_a;
      oacc[d][2] *= al_b;
      oacc[d][3] *= al_b;
    }

    // O += P V: the S accumulators of n-tiles 2j, 2j+1 are the A fragment
    // of k-step j, as hi and lo parts
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t ph[4], pl[4];
      split_bf16(sacc[2 * j][0], sacc[2 * j][1], ph[0], pl[0]);
      split_bf16(sacc[2 * j][2], sacc[2 * j][3], ph[1], pl[1]);
      split_bf16(sacc[2 * j + 1][0], sacc[2 * j + 1][1], ph[2], pl[2]);
      split_bf16(sacc[2 * j + 1][2], sacc[2 * j + 1][3], ph[3], pl[3]);
      const __nv_bfloat16* vr = Vt + g * VS + j * 16 + 2 * t;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const uint32_t v0 = ld32(vr + d * 8 * VS), v1 = ld32(vr + d * 8 * VS + 8);
        mma_bf16(oacc[d], ph, v0, v1);
        mma_bf16(oacc[d], pl, v0, v1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int c = d * 8 + 2 * t;
    if (ra < S)
      *reinterpret_cast<uint32_t*>(o + ra * a.os + c) = pack_bf16(oacc[d][0] * inv_a, oacc[d][1] * inv_a);
    if (rb < S)
      *reinterpret_cast<uint32_t*>(o + rb * a.os + c) = pack_bf16(oacc[d][2] * inv_b, oacc[d][3] * inv_b);
  }
}

// ---------------------------------------------------------------------------
// float32: FMAs from shared memory
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(256) fa_fwd_f32(Args a) {
  constexpr int QS = D + 1;        // Q / K tile row stride (words)
  constexpr int PS = kBlockK + 1;  // P tile row stride
  constexpr int E = D / 4;         // accumulator columns per thread: j, j+4, ...
  constexpr int C = kBlockK / 4;   // score columns per thread: j, j+4, ...
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBlockQ * QS;
  float* Vs = Ks + kBlockK * QS;
  float* Ps = Vs + kBlockK * D;

  const int S = a.S;
  const int nq = (S + kBlockQ - 1) / kBlockQ;
  const int qt = nq - 1 - (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const int r = threadIdx.x >> 2, j = threadIdx.x & 3;
  const int q0 = qt * kBlockQ, row = q0 + r;
  const float* q = static_cast<const float*>(a.q) + b * a.qb + h * a.qh;
  const float* k = static_cast<const float*>(a.k) + b * a.kb + hk * a.kh;
  const float* v = static_cast<const float*>(a.v) + b * a.vb + hk * a.vh;
  float* o = static_cast<float*>(a.o) + b * a.ob + h * a.oh;

  for (int idx = threadIdx.x; idx < kBlockQ * D; idx += blockDim.x) {
    const int rr = idx / D, d = idx % D;
    Qs[rr * QS + d] = q0 + rr < S ? q[(q0 + rr) * a.qs + d] : 0.f;
  }
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  float m = kNegInf, l = 0.f;

  const int ntiles = kv_tiles(a, qt);
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBlockK * D; idx += blockDim.x) {
      const int rr = idx / D, d = idx % D;
      const bool in = k0 + rr < S;
      Ks[rr * QS + d] = in ? k[(k0 + rr) * a.ks + d] : 0.f;
      Vs[rr * D + d] = in ? v[(k0 + rr) * a.vs + d] : 0.f;
    }
    __syncthreads();

    float s[C];
#pragma unroll
    for (int i = 0; i < C; ++i) s[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = Qs[r * QS + d];
#pragma unroll
      for (int i = 0; i < C; ++i) s[i] = fmaf(qd, Ks[(j + 4 * i) * QS + d], s[i]);
    }
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int col = k0 + j + 4 * i;
      float x = s[i] * a.scale;
      if (col >= S || (a.causal && col > row)) x = kNegInf;
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float al = expf(m - mn);
    float ps = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const float p = expf(s[i] - mn);
      Ps[r * PS + j + 4 * i] = p;
      ps += p;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l = l * al + ps;
    m = mn;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= al;
    __syncwarp();  // a row's P is written by the four lanes that read it
    for (int c = 0; c < kBlockK; ++c) {
      const float p = Ps[r * PS + c];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(p, Vs[c * D + j + 4 * e], acc[e]);
    }
  }
  if (row < S) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int e = 0; e < E; ++e) o[row * a.os + j + 4 * e] = acc[e] / den;
  }
}

template <typename Kernel>
cudaError_t run(Kernel kernel, int threads, size_t smem, dim3 grid, const Args& a,
                cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, H, S, D], k / v [B, Hkv, S, D], o [B, H, S, D], each given by its
// element strides over (batch, head, row) with the head dim contiguous;
// dtype 0 = float32, 1 = bfloat16 (all four alike); D in {64, 112, 128};
// H % Hkv == 0.  Returns cudaGetLastError() after the launch.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int dtype,
                           int B, int H, int Hkv, int S, int D, long long qb, long long qh,
                           long long qs, long long kb, long long kh, long long ks,
                           long long vb, long long vh, long long vs, long long ob, long long oh,
                           long long os, int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 || H > 65535 ||
      (D != 64 && D != 112 && D != 128) || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (S <= 0) return (int)cudaSuccess;
  const Args a{q, k, v, o, S, H / Hkv, qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os,
               causal, scale};
  const dim3 grid((unsigned)((S + kBlockQ - 1) / kBlockQ), (unsigned)H, (unsigned)B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const size_t smem = (size_t)(kBlockK * (D + 8) + D * (kBlockK + 8)) * sizeof(__nv_bfloat16);
    return (int)(D == 64    ? run(fa_fwd_bf16<64>, 128, smem, grid, a, st)
                 : D == 112 ? run(fa_fwd_bf16<112>, 128, smem, grid, a, st)
                            : run(fa_fwd_bf16<128>, 128, smem, grid, a, st));
  }
  const size_t smem =
      (size_t)(kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D + kBlockQ * (kBlockK + 1)) *
      sizeof(float);
  return (int)(D == 64    ? run(fa_fwd_f32<64>, 256, smem, grid, a, st)
               : D == 112 ? run(fa_fwd_f32<112>, 256, smem, grid, a, st)
                          : run(fa_fwd_f32<128>, 256, smem, grid, a, st));
}

}  // extern "C"
