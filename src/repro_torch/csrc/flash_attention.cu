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
// here each CTA owns one (b, h, query tile) and walks the kv tiles in a
// loop, with the running state in registers.
//
// Head dims 64, 80 (hubert-xlarge), 112 (zamba2-7b's shared block) and 128.
// The reference's wrapper pads D up to a multiple of 128 for the MXU; no
// input is padded or copied here.
//
// Bound on the H100 at the serve path's prefill shape (B 8, H 32, Hkv 8,
// S 2048, D 64, causal, bf16): operations.  The causal pairs need
// 4 * B * H * D * S (S + 1) / 2 = 137 GFLOP, 0.139 ms at 989 TFLOP/s on the
// bf16 tensor cores; q, k, v and o are 168 MB, 0.050 ms at 3.35 TB/s.  P V
// runs twice (below), so the tensor cores do 1.5x that work: 0.21 ms.
//
// bf16 design (fa_wgmma_bf16): Hopper's warpgroup MMA fed by TMA.
//  * A CTA takes 128 query rows of one (b, h): three warpgroups, one
//    producer and two consumers of 64 rows each.  setmaxnreg moves
//    registers from the producer (56) to the consumers (224).
//  * The producer's first thread loads Q once and then each 128-row K and V
//    tile by TMA (cp.async.bulk.tensor.4d) into a ring of 2 stages, with
//    mbarriers full (transaction bytes) and empty (every consumer thread
//    arrives).  K and V have barriers of their own, so a consumer frees K
//    as soon as S is computed and V may still be landing during the
//    softmax.
//  * Tensor maps are 4-D (D, S, heads, B) over the strided views as the
//    caller hands them (the serve path's [B, S, heads, D]), built on the
//    host per call with 128-byte swizzle: each 64-column block of a tile is
//    one box of rows x 128 bytes, the layout wgmma reads.  Rows past S are
//    zero-filled by TMA.  cuTensorMapEncodeTiled lives in the driver
//    library; the launcher takes its entry point once with
//    cudaGetDriverEntryPoint(ByVersion), so the library links no -lcuda.
//  * S = Q K^T: wgmma.mma_async m64n128k16, both operands K-major in
//    shared memory, float32 accumulators.  D = 80 and 112 load two 64-wide
//    boxes and TMA zero-fills the second past column D; only D / 16 k-steps
//    are issued (5 and 7), so the all-zero rest costs nothing (no 32-byte
//    swizzle needed).  The wgmma helpers, descriptors, barriers and tensor
//    maps are in flash_common.cuh, shared with the backward.
//  * Softmax online in registers, in float32: mask, running max in log2
//    units, P = 2^(s scale log2(e) - m) as one FMA and one ex2.approx.ftz
//    (a row masked so far takes no offset, so its P is 0).  Only tiles
//    that cross the diagonal or S are masked; kv
//    tiles above the diagonal are never loaded; the heaviest query tiles
//    of each head launch first.  kv columns at or past S score -1e30 (exp
//    gives 0, never NaN), query rows past S are not stored.
//  * O += P V: wgmma m64nDk16 (n64, n80, n112, n128) with A from
//    registers: the S accumulators, packed into bf16 pairs, are already in
//    wgmma's A-register layout.
//    The reference keeps P in float32; a bf16 P (2^-9 relative on each
//    weight) moved zamba2-7b's logits by up to 0.1 over its 95 blocks, so P
//    enters as two bf16 parts, hi = bf16(P) and lo = bf16(P - hi), two
//    MMAs that carry P to about 2^-17; the running sum l adds up the
//    float32 P.  V stays row-major as TMA wrote it and is read through
//    wgmma's B transpose (MN-major descriptor), with no transpose by hand.
//  * The output divides by max(l, 1e-30), as the reference, and is stored
//    from registers into the [B, S, H, D] layout the wrapper allocates.
//  * Training asks for each row's log-sum-exp, lse = m + log(max(l, 1e-30))
//    in natural units, float32 [B, H, S]: the statistics the backward kernel
//    (flash_attention_bwd.cu) recomputes P from, as the reference's custom
//    VJP keeps m and l (src/repro/models/attention.py, _flash_flat_cvjp_fwd).
//    A null pointer (serving) stores nothing more.
//
// float32 design (fa_fwd_f32): no tensor-core path keeps float32 exact, so
// 256 threads, four per query row, compute scores and the accumulator with
// FMAs from shared memory (rows padded by one word so no load conflicts).
// No serving path runs it.
#include "flash_common.cuh"

namespace {

using namespace fa;

// ---------------------------------------------------------------------------
// bf16: wgmma and TMA
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;                   // query rows of one consumer warpgroup
constexpr int kConsumers = 2;                 // consumer warpgroups
constexpr int kTileQ = kWgRows * kConsumers;  // query rows of a CTA
constexpr int kTileK = 128;                   // kv rows of a stage
constexpr int kStages = 2;
constexpr int kThreads = 128 * (1 + kConsumers);

struct TmaArgs {
  void* o;
  long long ob, oh, os;  // element strides of the output
  float* lse;            // [B, H, S] float32, or null
  int S, group, causal;
  float scale;
};

// shared memory of one CTA, in bytes from a 1024-aligned base
template <int D>
struct Smem {
  static constexpr int kBlocks = (D + kAtom - 1) / kAtom;  // 64-column blocks of a tile
  static constexpr int kQ = kBlocks * kTileQ * kRowBytes;
  static constexpr int kKV = kBlocks * kTileK * kRowBytes;  // one K or V stage
  static constexpr int kKOff = kQ;
  static constexpr int kVOff = kKOff + kStages * kKV;
  static constexpr int kBarOff = kVOff + kStages * kKV;
  // barriers: q full, then k full, v full, k empty, v empty per stage
  static constexpr int kBytes = kBarOff + 8 * (1 + 4 * kStages) + 1024;  // + alignment
};

// mask (kMask) and take the row maxima of an S tile, unscaled: accumulator
// 4n + i holds row r0 (i < 2) or r0 + 8, column 8n + 2t + (i & 1)
template <bool kMask>
__device__ __forceinline__ void mask_max(float (&s)[kTileK / 2], int k0, int t, int r0, int S,
                                         bool causal, float& mx_a, float& mx_b) {
#pragma unroll
  for (int n = 0; n < kTileK / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kMask) {
        const int col = k0 + n * 8 + 2 * t + (i & 1);
        const int row = i < 2 ? r0 : r0 + 8;
        if (col >= S || (causal && col > row)) s[4 * n + i] = kNegInf;
      }
      if (i < 2) mx_a = fmaxf(mx_a, s[4 * n + i]);
      else mx_b = fmaxf(mx_b, s[4 * n + i]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_wgmma_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const TmaArgs a) {
  using L = Smem<D>;
  constexpr int KSTEPS = D / 16;  // Q K^T k-steps (7 at D = 112)
  constexpr int PSTEPS = kTileK / 16;  // P V k-steps
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms are 1024 B
  const uint32_t sq = base, sk = base + L::kKOff, sv = base + L::kVOff;
  const uint32_t q_full = base + L::kBarOff;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages, v_empty = k_empty + 8 * kStages;

  const int S = a.S;
  const int nq = (S + kTileQ - 1) / kTileQ;
  const int qt = nq - 1 - (int)blockIdx.x;  // heaviest causal tiles of a head first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.group;
  const int q0 = qt * kTileQ;
  const int nk = (S + kTileK - 1) / kTileK;
  const int ntiles = a.causal ? min(nk, (q0 + kTileQ - 1) / kTileK + 1) : nk;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 128 * kConsumers);
      mbar_init(v_empty + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQ);
      for (int c = 0; c < L::kBlocks; ++c)
        tma_load(sq + c * kTileQ * kRowBytes, &tq, q_full, c * kAtom, q0, h, b);
      for (int kt = 0; kt < ntiles; ++kt) {
        const int s = kt % kStages;
        const uint32_t phase = (kt / kStages) & 1;
        mbar_wait(k_empty + 8 * s, phase ^ 1);  // a fresh barrier passes parity 1
        mbar_expect_tx(k_full + 8 * s, L::kKV);
        for (int c = 0; c < L::kBlocks; ++c)
          tma_load(sk + s * L::kKV + c * kTileK * kRowBytes, &tk, k_full + 8 * s, c * kAtom,
                   kt * kTileK, hk, b);
        mbar_wait(v_empty + 8 * s, phase ^ 1);
        mbar_expect_tx(v_full + 8 * s, L::kKV);
        for (int c = 0; c < L::kBlocks; ++c)
          tma_load(sv + s * L::kKV + c * kTileK * kRowBytes, &tv, v_full + 8 * s, c * kAtom,
                   kt * kTileK, hk, b);
      }
    }
    return;
  }

  // consumers: warpgroup cw takes query rows q0 + 64 cw .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rmin = q0 + cw * kWgRows;
  const int r0 = rmin + warp * 16 + g;  // the thread's rows: r0 and r0 + 8
  const uint32_t qa = sq + cw * kWgRows * kRowBytes;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float sacc[kTileK / 2];
  // running max (log2 units) and this lane's part of the running sum
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  const float sl2 = a.scale * kLog2e;
  const float dead = 0.5f * kNegInf * sl2;  // below any real score, above a masked one

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < ntiles; ++kt) {
    const int s = kt % kStages;
    const uint32_t phase = (kt / kStages) & 1;
    const int k0 = kt * kTileK;

    // S = Q K^T
    mbar_wait(k_full + 8 * s, phase);
    const uint32_t kb = sk + s * L::kKV;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const uint32_t off = (ks % 4) * 32;  // 16 columns = 32 bytes into the row
      const uint64_t da = smem_desc(qa + (ks / 4) * kTileQ * kRowBytes + off, 16, 1024);
      const uint64_t db = smem_desc(kb + (ks / 4) * kTileK * kRowBytes + off, 16, 1024);
      if (ks == 0) wgmma_ss_first(sacc, da, db);
      else wgmma_ss(sacc, da, db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    mbar_arrive(k_empty + 8 * s);

    // mask where the tile crosses the diagonal or S; running max in log2
    // units; P = 2^(s sl2 - m) as one FMA and one ex2 an element
    float mx_a = kNegInf, mx_b = kNegInf;
    if (k0 + kTileK > S || (a.causal && k0 + kTileK - 1 > rmin))
      mask_max<true>(sacc, k0, t, r0, S, a.causal, mx_a, mx_b);
    else
      mask_max<false>(sacc, k0, t, r0, S, a.causal, mx_a, mx_b);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a * sl2), mn_b = fmaxf(m_b, mx_b * sl2);
    const float al_a = ex2(m_a - mn_a), al_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    // a row masked so far (max -1e30 sl2) takes no offset, so each of its P
    // is 2^(-1e30 sl2) = 0 and not 2^(rounding error of the max)
    const float nb_a = mn_a < dead ? 0.f : -mn_a;
    const float nb_b = mn_b < dead ? 0.f : -mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n) {
      sacc[4 * n + 0] = ex2(fmaf(sacc[4 * n + 0], sl2, nb_a));
      sacc[4 * n + 1] = ex2(fmaf(sacc[4 * n + 1], sl2, nb_a));
      sacc[4 * n + 2] = ex2(fmaf(sacc[4 * n + 2], sl2, nb_b));
      sacc[4 * n + 3] = ex2(fmaf(sacc[4 * n + 3], sl2, nb_b));
      ps_a += sacc[4 * n + 0] + sacc[4 * n + 1];
      ps_b += sacc[4 * n + 2] + sacc[4 * n + 3];
    }
    l_a = l_a * al_a + ps_a;
    l_b = l_b * al_b + ps_b;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n + 0] *= al_a;
      o[4 * n + 1] *= al_a;
      o[4 * n + 2] *= al_b;
      o[4 * n + 3] *= al_b;
    }

    // P as wgmma A fragments: k-step j covers S n-blocks 2j and 2j + 1
    uint32_t phi[PSTEPS][4], plo[PSTEPS][4];
#pragma unroll
    for (int j = 0; j < PSTEPS; ++j) {
      split_bf16(sacc[8 * j + 0], sacc[8 * j + 1], phi[j][0], plo[j][0]);
      split_bf16(sacc[8 * j + 2], sacc[8 * j + 3], phi[j][1], plo[j][1]);
      split_bf16(sacc[8 * j + 4], sacc[8 * j + 5], phi[j][2], plo[j][2]);
      split_bf16(sacc[8 * j + 6], sacc[8 * j + 7], phi[j][3], plo[j][3]);
    }

    // O += P V, hi and lo
    mbar_wait(v_full + 8 * s, phase);
    const uint32_t vb = sv + s * L::kKV;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < PSTEPS; ++j) {
      // 16 kv rows from row 16 j; 64-column blocks kTileK rows apart
      const uint64_t db = smem_desc(vb + j * 16 * kRowBytes, kTileK * kRowBytes, 1024);
      wgmma_rs(o, phi[j], db);
      wgmma_rs(o, plo[j], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(phi);
    fence_regs(plo);
    mbar_arrive(v_empty + 8 * s);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  if (a.lse != nullptr && t == 0) {
    // m is in log2 units of the scaled score
    float* lse = a.lse + ((long long)b * gridDim.y + h) * S;
    if (r0 < S) lse[r0] = (m_a + log2f(fmaxf(l_a, 1e-30f))) / kLog2e;
    if (r0 + 8 < S) lse[r0 + 8] = (m_b + log2f(fmaxf(l_b, 1e-30f))) / kLog2e;
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o) + b * a.ob + h * a.oh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(out + r0 * a.os + c) =
          pack_bf16(o[4 * n + 0] * inv_a, o[4 * n + 1] * inv_a);
    if (r0 + 8 < S)
      *reinterpret_cast<uint32_t*>(out + (r0 + 8) * a.os + c) =
          pack_bf16(o[4 * n + 2] * inv_b, o[4 * n + 3] * inv_b);
  }
}

// ---------------------------------------------------------------------------
// float32: FMAs from shared memory
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;    // [B, H, S] float32, or null
  int S, group;  // group = H / Hkv
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;  // element strides
  int causal;
  float scale;
};

__device__ __forceinline__ int kv_tiles(const Args& a, int qt) {
  const int nk = (a.S + kBlockK - 1) / kBlockK;
  return a.causal ? min(nk, qt + 1) : nk;  // kBlockQ == kBlockK
}

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
    if (a.lse != nullptr && j == 0) a.lse[((long long)b * gridDim.y + h) * S + row] = m + logf(den);
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and launches
// ---------------------------------------------------------------------------

template <int D>
cudaError_t run_wgmma(const Args& a, int B, int H, int Hkv, cudaStream_t st) {
  // the shared-memory size first: a runtime call makes the device's context
  // current on this thread, which the driver's tensor-map encoding needs
  const int smem = Smem<D>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(fa_wgmma_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  if (!encode_map(&tq, a.q, D, a.S, H, B, a.qb, a.qh, a.qs, kTileQ) ||
      !encode_map(&tk, a.k, D, a.S, Hkv, B, a.kb, a.kh, a.ks, kTileK) ||
      !encode_map(&tv, a.v, D, a.S, Hkv, B, a.vb, a.vh, a.vs, kTileK)) {
    return cudaErrorInvalidValue;
  }
  const TmaArgs ta{a.o, a.ob, a.oh, a.os, a.lse, a.S, a.group, a.causal, a.scale};
  const dim3 grid((unsigned)((a.S + kTileQ - 1) / kTileQ), (unsigned)H, (unsigned)B);
  fa_wgmma_bf16<D><<<grid, kThreads, smem, st>>>(tq, tk, tv, ta);
  return cudaGetLastError();
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

// Dynamic shared memory of the bf16 kernel at head dim D (bytes), or -1.
int flash_attention_smem_bytes(int D) {
  return D == 64    ? Smem<64>::kBytes
         : D == 80  ? Smem<80>::kBytes
         : D == 112 ? Smem<112>::kBytes
         : D == 128 ? Smem<128>::kBytes
                    : -1;
}

// q [B, H, S, D], k / v [B, Hkv, S, D], o [B, H, S, D], each given by its
// element strides over (batch, head, row) with the head dim contiguous;
// dtype 0 = float32, 1 = bfloat16 (all four alike; bf16 rows 16-byte
// aligned, as TMA wants); D in {64, 80, 112, 128}; H % Hkv == 0.  lse, when not
// null, is a contiguous float32 [B, H, S] that takes each row's
// log-sum-exp.  Returns cudaGetLastError() after the launch.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, float* lse,
                           int dtype,
                           int B, int H, int Hkv, int S, int D, long long qb, long long qh,
                           long long qs, long long kb, long long kh, long long ks,
                           long long vb, long long vh, long long vs, long long ob, long long oh,
                           long long os, int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 || H > 65535 ||
      (D != 64 && D != 80 && D != 112 && D != 128) || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (S <= 0) return (int)cudaSuccess;
  const Args a{q, k, v, o, lse, S, H / Hkv, qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os,
               causal, scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return (int)(D == 64    ? run_wgmma<64>(a, B, H, Hkv, st)
                 : D == 80  ? run_wgmma<80>(a, B, H, Hkv, st)
                 : D == 112 ? run_wgmma<112>(a, B, H, Hkv, st)
                            : run_wgmma<128>(a, B, H, Hkv, st));
  }
  const dim3 grid((unsigned)((S + kBlockQ - 1) / kBlockQ), (unsigned)H, (unsigned)B);
  const size_t smem =
      (size_t)(kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D + kBlockQ * (kBlockK + 1)) *
      sizeof(float);
  return (int)(D == 64    ? run(fa_fwd_f32<64>, 256, smem, grid, a, st)
               : D == 80  ? run(fa_fwd_f32<80>, 256, smem, grid, a, st)
               : D == 112 ? run(fa_fwd_f32<112>, 256, smem, grid, a, st)
                          : run(fa_fwd_f32<128>, 256, smem, grid, a, st));
}

}  // extern "C"
