// flash_attention_bwd: the gradient of flash attention (bf16, causal or
// bidirectional, grouped-query heads) from the forward's row log-sum-exp:
//   P    = exp(scale q k^T - lse)            (recomputed tile by tile)
//   Dvec = rowsum(dout * out)
//   dS   = P * (dout v^T - Dvec) * scale
//   dq   = dS k,   dk = dS^T q,   dv = P^T dout
// with dk and dv summed over the G = H / Hkv query heads of each kv head.
//
// Replaces the reference's blockwise custom-VJP backward
// _flash_flat_cvjp_bwd (src/repro/models/attention.py:240), which
// recomputes the scores from the forward's saved m and l, in jnp; it has
// no Pallas site.  The forward it differentiates is the Pallas kernel
// flash_attention_pallas (src/repro/kernels/flash_attention/kernel.py),
// ported as fa_wgmma_bf16 (flash_attention.cu), which writes lse for this
// kernel.
//
// Bound on the H100: operations.  The algorithm's five products over the
// pairs need 2.5x the forward's, 10 B H D pairs.  At llama3.2-1b's training
// shape (B 8, H 32, Hkv 8, S 2048, D 64, causal) that is 344 GFLOP, 0.3476
// ms at 989 TFLOP/s (q, k, v, out, dout, lse and the three gradients are
// 302 MB, 0.09 ms at 3.35 TB/s); at hubert-xlarge's (B 8, H = Hkv 16,
// S 2048, D 80, full) 429 GFLOP, 0.4343 ms.  This design computes S and dP
// in both of its kernels, seven products where the algorithm needs five:
// 1.4x that tensor work, 0.4866 and 0.6080 ms.
//
// Design: Hopper's wgmma fed by TMA, built from the forward's pieces
// (flash_common.cuh); no float atomics, so a step's gradients are the same
// bits every run (the training restart gate needs it).  Two launches, dQ
// first:
//  * fa_bwd_dq_wgmma: the forward's skeleton with the backward's arithmetic.
//    A CTA owns 128 query rows of one (b, h): one producer warpgroup
//    (setmaxnreg down to 24) and two consumer warpgroups (up to 240) of 64
//    rows each.  Q and dout arrive once by TMA; K and V tiles of 64 rows
//    stream through a ring of 2 stages with full (transaction bytes) and
//    empty (every consumer thread) mbarriers.  Each consumer thread first
//    takes lse (in log2 units) and Dvec = rowsum(dout * out) of its two
//    rows and writes them to a float32 scratch [B, H, 2, Sp] (Sp = S rounded
//    up to 384, a whole number of both kernels' tiles; zeros past S) for
//    the dK/dV kernel.  S = Q K^T, then dP = dout V^T: wgmma m64n64k16 with
//    both operands K-major in shared memory, issued as two groups, so that
//    P = 2^(S scale log2(e) - lse log2(e)) is taken while dP is still in
//    flight; dS = P (dP - Dvec) scale in float32 registers, packed to bf16
//    into wgmma's A-register layout (as the forward packs P), and dQ += dS K
//    is wgmma m64nDk16 with K read MN-major, as the forward reads V.  When
//    causal it stops at the diagonal, and the heaviest query tiles launch
//    first.
//  * fa_bwd_dkdv_wgmma: a CTA owns 128 kv rows of one (b, kv head), the same
//    three warpgroups.  K and V arrive once; the CTA walks the G query heads
//    of its group and, when causal, the query tiles from the diagonal on, in
//    a fixed order: each step's Q and dout tiles (TMA) and its lse and Dvec
//    slices (bulk copies) stream through the ring.  S^T = K Q^T and
//    dP^T = V dout^T as above; P^T and dS^T in registers; dV += P^T dout and
//    dK += dS^T Q with B the staged tiles read MN-major.  dK and dV stay in
//    float32 registers and are stored in bf16 once.  The two consumer
//    warpgroups take turns to issue a step's S^T and dP^T (named barriers),
//    so that one's exponentials run beside the other's products.
//  Steps are 64 kv rows (dQ) and 64, 48 or 32 query rows (dK/dV at D = 64,
//  80, above): once the wgmma accumulators alive at once (S + dP + dQ:
//  64 + D / 2, or dK + dV + S^T + dP^T: D + the step) pass about 128
//  registers a thread, ptxas serializes the wgmmas and spills, whatever
//  setmaxnreg gives the consumers (at 128 it pipelines them, at 144 it does
//  not).  At D = 112 and 128 the dK/dV kernel is past that (serialized; no
//  config trains there).
//  What it does about the first version's limits (mma.sync from ldmatrix,
//  one stage, 128-thread CTAs of 64 rows reading 32 or 64 rows a step, 246
//  to 255 registers with spills at D = 128, D = 80 padded to 112): every
//  product is wgmma; copies are TMA into a 2-stage ring that the producer
//  keeps ahead of the consumers; a CTA owns 128 rows in 384 threads; the
//  products that have D as their depth issue D / 16 k-steps (5 at D = 80,
//  the second 64-column box zero-filled past column 80 by TMA) and those
//  that have D as their width are wgmma n80 at D = 80, so hubert runs
//  unpadded.  S and dP are still computed twice.
//  Tiles that cross the diagonal or S are masked (P = 0); a
//  warpgroup whose rows are all masked in a step skips its products; pairs
//  past S in either direction give zero or unstored terms.  P and dS enter
//  their second products rounded to bf16, as the tensor cores take them;
//  the reference keeps them in float32.
#include "flash_common.cuh"

namespace {

using namespace fa;

constexpr int kWgRows = 64;                     // rows of one consumer warpgroup
constexpr int kConsumers = 2;                   // consumer warpgroups
constexpr int kCtaRows = kWgRows * kConsumers;  // kv rows (dK/dV) or query rows (dQ) of a CTA
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kStages = 2;
// the stats cover S rounded up to this: whole dQ CTAs and dK/dV steps
constexpr int kPadRows = 384;

// named barrier `id` over the two consumer warpgroups: wait, or arrive only
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(128 * kConsumers) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(128 * kConsumers) : "memory");
}

__host__ __device__ __forceinline__ int padded_rows(int S) {
  return (S + kPadRows - 1) / kPadRows * kPadRows;
}

struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* g;  // dout
  const float* lse;        // [B, H, S]
  float* stats;            // [B, H, 2, padded_rows(S)]: lse2, Dvec; written by fa_bwd_dq_wgmma
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  // element strides over (batch, head, row); the head dim is contiguous
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os, gb, gh, gs;
  long long dqb, dqh, dqs, dkb, dkh, dks, dvb, dvh, dvs;
  int H, S, group, causal;
  float scale;
};

// the lse2 row of (b, h); its Dvec row follows at + padded_rows(S)
__device__ __forceinline__ float* stats_row(const BwdArgs& a, int b, int h) {
  return a.stats + ((long long)b * a.H + h) * 2 * padded_rows(a.S);
}

// this lane's part (column pairs t, t + 4, ...) of the dot product of two
// bf16 rows of D columns
template <int D>
__device__ __forceinline__ float row_dot(const __nv_bfloat16* x, const __nv_bfloat16* y, int t) {
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(x);
  const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(y);
  float acc = 0.f;
#pragma unroll
  for (int c = t; c < D / 2; c += 4) {
    const float2 xf = __bfloat1622float2(xp[c]), yf = __bfloat1622float2(yp[c]);
    acc = fmaf(xf.x, yf.x, acc);
    acc = fmaf(xf.y, yf.y, acc);
  }
  return acc;
}

// shared memory of a dK/dV CTA, in bytes from a 1024-aligned base
template <int D>
struct DkdvSmem {
  // query rows a step streams: 64 at D = 64, 32 above, so that the wgmma
  // accumulators alive at once (dK, dV, S^T, dP^T: D + kStep registers a
  // thread) stay within the 128 or so ptxas places them in
  static constexpr int kStep = D <= 64 ? 64 : D <= 80 ? 48 : 32;
  static constexpr int kBlocks = (D + kAtom - 1) / kAtom;     // 64-column blocks of a tile
  static constexpr int kKV = kBlocks * kCtaRows * kRowBytes;  // the CTA's K or V
  static constexpr int kQ = kBlocks * kStep * kRowBytes;      // a step's Q or dout tile
  static constexpr int kStatBytes = 2 * kStep * 4;            // its lse2, then its Dvec
  static constexpr int kKOff = 0;
  static constexpr int kVOff = kKV;
  static constexpr int kQOff = 2 * kKV;  // stage s: Q at kQOff + 2 s kQ, dout after it
  static constexpr int kStatOff = kQOff + 2 * kStages * kQ;  // stage s: kStatBytes
  static constexpr int kBarOff = kStatOff + kStages * kStatBytes;
  // barriers: kv full, then full and empty per stage
  static constexpr int kBytes = kBarOff + 8 * (1 + 2 * kStages) + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
                      const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                      const BwdArgs a) {
  using L = DkdvSmem<D>;
  constexpr int NQ = L::kStep;
  constexpr int KSTEPS = D / 16;   // S^T and dP^T k-steps over the head dim
  constexpr int QSTEPS = NQ / 16;  // dV and dK k-steps over a step's query rows
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms are 1024 B
  const float* stats_smem = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::kStatOff);
  const uint32_t sk = base + L::kKOff, sv = base + L::kVOff;
  const uint32_t kv_full = base + L::kBarOff;
  const uint32_t full = kv_full + 8, empty = full + 8 * kStages;

  const int S = a.S;
  // causal: the kv tile is the slowest grid index, so the first tiles, which
  // see the most query tiles, launch first for every head; bidirectional:
  // the fastest, so the CTAs in flight share a head's query tiles in L2
  const int hk = a.causal ? blockIdx.x : blockIdx.y, b = a.causal ? blockIdx.y : blockIdx.z;
  const int k0 = (a.causal ? blockIdx.z : blockIdx.x) * kCtaRows;
  const int nq = (S + NQ - 1) / NQ;
  const int qt0 = a.causal ? k0 / NQ : 0;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKV);
      for (int c = 0; c < L::kBlocks; ++c) {
        tma_load(sk + c * kCtaRows * kRowBytes, &tk, kv_full, c * kAtom, k0, hk, b);
        tma_load(sv + c * kCtaRows * kRowBytes, &tv, kv_full, c * kAtom, k0, hk, b);
      }
      int it = 0;
      for (int hg = 0; hg < a.group; ++hg) {
        const int h = hk * a.group + hg;
        const float* lse2 = stats_row(a, b, h);
        for (int qt = qt0; qt < nq; ++qt, ++it) {
          const int s = it % kStages;
          const uint32_t phase = (it / kStages) & 1;
          const uint32_t sq = base + L::kQOff + s * 2 * L::kQ, sg = sq + L::kQ;
          const uint32_t sst = base + L::kStatOff + s * L::kStatBytes;
          mbar_wait(empty + 8 * s, phase ^ 1);  // a fresh barrier passes parity 1
          mbar_expect_tx(full + 8 * s, 2 * L::kQ + L::kStatBytes);
          for (int c = 0; c < L::kBlocks; ++c) {
            tma_load(sq + c * NQ * kRowBytes, &tq, full + 8 * s, c * kAtom, qt * NQ, h, b);
            tma_load(sg + c * NQ * kRowBytes, &tg, full + 8 * s, c * kAtom, qt * NQ, h, b);
          }
          bulk_load(sst, lse2 + qt * NQ, NQ * 4, full + 8 * s);
          bulk_load(sst + NQ * 4, lse2 + padded_rows(S) + qt * NQ, NQ * 4, full + 8 * s);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw takes kv rows k0 + 64 cw .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kmin = k0 + cw * kWgRows;
  const int kr_a = kmin + warp * 16 + g, kr_b = kr_a + 8;  // this thread's kv rows
  const uint32_t ka = sk + cw * kWgRows * kRowBytes, va = sv + cw * kWgRows * kRowBytes;
  const float sl2 = a.scale * kLog2e;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kv_full, 0);
  const int steps = a.group * (nq - qt0);
  // the two warpgroups take turns to issue a step's S^T and dP^T (named
  // barriers 1 and 2), so that one's exponentials run beside the other's
  // products; warpgroup 0 goes first, and warpgroup 1's last turn is given
  // to no one
  if (cw == 1) named_arrive(1);
  int it = 0;
  for (int hg = 0; hg < a.group; ++hg) {
    for (int qt = qt0; qt < nq; ++qt, ++it) {
      const int s = it % kStages;
      const uint32_t phase = (it / kStages) & 1;
      const int q0 = qt * NQ;
      const uint32_t sq = base + L::kQOff + s * 2 * L::kQ, sg = sq + L::kQ;
      mbar_wait(full + 8 * s, phase);
      named_sync(1 + cw);
      if (a.causal && q0 + NQ - 1 < kmin) {  // every query before this warpgroup's keys
        if (!(cw == 1 && it == steps - 1)) named_arrive(2 - cw);
        mbar_arrive(empty + 8 * s);
        continue;
      }

      // S^T = K Q^T, then dP^T = V dout^T: two groups in flight
      float st[NQ / 2], dpt[NQ / 2];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const uint32_t off = (ks % 4) * 32;  // 16 columns = 32 bytes into the row
        const uint64_t db = smem_desc(sq + (ks / 4) * NQ * kRowBytes + off, 16, 1024);
        const uint64_t da = smem_desc(ka + (ks / 4) * kCtaRows * kRowBytes + off, 16, 1024);
        if (ks == 0) wgmma_ss_first(st, da, db);
        else wgmma_ss(st, da, db);
      }
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const uint32_t off = (ks % 4) * 32;
        const uint64_t db = smem_desc(sg + (ks / 4) * NQ * kRowBytes + off, 16, 1024);
        const uint64_t da = smem_desc(va + (ks / 4) * kCtaRows * kRowBytes + off, 16, 1024);
        if (ks == 0) wgmma_ss_first(dpt, da, db);
        else wgmma_ss(dpt, da, db);
      }
      wgmma_commit();
      if (!(cw == 1 && it == steps - 1)) named_arrive(2 - cw);

      // P^T while dP^T lands: element 4n + i is kv row kr_a (i < 2) or kr_b,
      // query q0 + 8n + 2t + (i & 1)
      wgmma_wait<1>();
      fence_regs(st);
      const float* ls = stats_smem + s * 2 * NQ;
      const bool edge = (a.causal && q0 < kmin + kWgRows - 1) || q0 + NQ > S;
#pragma unroll
      for (int n = 0; n < NQ / 8; ++n) {
        const int c = 8 * n + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
        st[4 * n + 0] = ex2(fmaf(st[4 * n + 0], sl2, -l2.x));
        st[4 * n + 1] = ex2(fmaf(st[4 * n + 1], sl2, -l2.y));
        st[4 * n + 2] = ex2(fmaf(st[4 * n + 2], sl2, -l2.x));
        st[4 * n + 3] = ex2(fmaf(st[4 * n + 3], sl2, -l2.y));
        if (edge) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qr = q0 + c + (i & 1), kr = i < 2 ? kr_a : kr_b;
            if (qr >= S || (a.causal && qr < kr)) st[4 * n + i] = 0.f;
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int n = 0; n < NQ / 8; ++n) {
        const float2 d2 = *reinterpret_cast<const float2*>(ls + NQ + 8 * n + 2 * t);
        dpt[4 * n + 0] = st[4 * n + 0] * (dpt[4 * n + 0] - d2.x) * a.scale;
        dpt[4 * n + 1] = st[4 * n + 1] * (dpt[4 * n + 1] - d2.y) * a.scale;
        dpt[4 * n + 2] = st[4 * n + 2] * (dpt[4 * n + 2] - d2.x) * a.scale;
        dpt[4 * n + 3] = st[4 * n + 3] * (dpt[4 * n + 3] - d2.y) * a.scale;
      }
      uint32_t pa[QSTEPS][4], sa[QSTEPS][4];
      as_a_frags(st, pa);
      as_a_frags(dpt, sa);

      // dV += P^T dout, dK += dS^T Q: B the staged tiles read MN-major
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < QSTEPS; ++j)
        wgmma_rs(dv, pa[j], smem_desc(sg + j * 16 * kRowBytes, NQ * kRowBytes, 1024));
#pragma unroll
      for (int j = 0; j < QSTEPS; ++j)
        wgmma_rs(dk, sa[j], smem_desc(sq + j * 16 * kRowBytes, NQ * kRowBytes, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(sa);
      mbar_arrive(empty + 8 * s);
    }
  }

  __nv_bfloat16* dkp = a.dk + b * a.dkb + hk * a.dkh;
  __nv_bfloat16* dvp = a.dv + b * a.dvb + hk * a.dvh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (kr_a < S) {
      *reinterpret_cast<uint32_t*>(dkp + kr_a * a.dks + c) = pack_bf16(dk[4 * n + 0], dk[4 * n + 1]);
      *reinterpret_cast<uint32_t*>(dvp + kr_a * a.dvs + c) = pack_bf16(dv[4 * n + 0], dv[4 * n + 1]);
    }
    if (kr_b < S) {
      *reinterpret_cast<uint32_t*>(dkp + kr_b * a.dks + c) = pack_bf16(dk[4 * n + 2], dk[4 * n + 3]);
      *reinterpret_cast<uint32_t*>(dvp + kr_b * a.dvs + c) = pack_bf16(dv[4 * n + 2], dv[4 * n + 3]);
    }
  }
}

// shared memory of a dQ CTA, in bytes from a 1024-aligned base
template <int D>
struct DqSmem {
  static constexpr int kBlocks = (D + kAtom - 1) / kAtom;
  static constexpr int kQ = kBlocks * kCtaRows * kRowBytes;    // the CTA's Q or dout
  static constexpr int kStep = 64;  // kv rows a step streams
  static constexpr int kKV = kBlocks * kStep * kRowBytes;      // a step's K or V tile
  static constexpr int kQOff = 0;
  static constexpr int kGOff = kQ;
  static constexpr int kKOff = 2 * kQ;  // stage s: K at kKOff + 2 s kKV, V after it
  static constexpr int kBarOff = kKOff + 2 * kStages * kKV;
  // barriers: q full, then full and empty per stage
  static constexpr int kBytes = kBarOff + 8 * (1 + 2 * kStages) + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const BwdArgs a) {
  using L = DqSmem<D>;
  constexpr int N = L::kStep;
  constexpr int KSTEPS = D / 16;  // S and dP k-steps over the head dim
  constexpr int PSTEPS = N / 16;  // dQ k-steps over a step's kv rows
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQOff, sg = base + L::kGOff;
  const uint32_t q_full = base + L::kBarOff;
  const uint32_t full = q_full + 8, empty = full + 8 * kStages;

  const int S = a.S;
  const int nqt = (S + kCtaRows - 1) / kCtaRows;
  const int qt = nqt - 1 - (int)blockIdx.x;  // heaviest causal tiles of a head first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.group;
  const int q0 = qt * kCtaRows;
  const int nk = (S + N - 1) / N;
  const int ntiles = a.causal ? min(nk, (q0 + kCtaRows - 1) / N + 1) : nk;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::kQ);
      for (int c = 0; c < L::kBlocks; ++c) {
        tma_load(sq + c * kCtaRows * kRowBytes, &tq, q_full, c * kAtom, q0, h, b);
        tma_load(sg + c * kCtaRows * kRowBytes, &tg, q_full, c * kAtom, q0, h, b);
      }
      for (int kt = 0; kt < ntiles; ++kt) {
        const int s = kt % kStages;
        const uint32_t phase = (kt / kStages) & 1;
        const uint32_t skb = base + L::kKOff + s * 2 * L::kKV, svb = skb + L::kKV;
        mbar_wait(empty + 8 * s, phase ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * L::kKV);
        for (int c = 0; c < L::kBlocks; ++c) {
          tma_load(skb + c * N * kRowBytes, &tk, full + 8 * s, c * kAtom, kt * N, hk, b);
          tma_load(svb + c * N * kRowBytes, &tv, full + 8 * s, c * kAtom, kt * N, hk, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw takes query rows q0 + 64 cw .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rmin = q0 + cw * kWgRows;
  const int r_a = rmin + warp * 16 + g, r_b = r_a + 8;  // this thread's query rows
  const uint32_t qa = sq + cw * kWgRows * kRowBytes, ga = sg + cw * kWgRows * kRowBytes;
  // lse in log2 units and Dvec = rowsum(dout * out) of this thread's rows,
  // the four lanes of a row taking every fourth column pair; written to the
  // stats for the dK/dV kernel, which runs after this one (zeros past S, to
  // the end of the padded rows).  Taken while the first step's products run.
  float l_a = 0.f, l_b = 0.f, d_a = 0.f, d_b = 0.f;
  const auto take_stats = [&]() {
    const long long bh = (long long)b * a.H + h;
    const __nv_bfloat16* o = a.o + b * a.ob + h * a.oh;
    const __nv_bfloat16* go = a.g + b * a.gb + h * a.gh;
    if (r_a < S) {
      l_a = a.lse[bh * S + r_a] * kLog2e;
      d_a = row_dot<D>(o + r_a * a.os, go + r_a * a.gs, t);
    }
    if (r_b < S) {
      l_b = a.lse[bh * S + r_b] * kLog2e;
      d_b = row_dot<D>(o + r_b * a.os, go + r_b * a.gs, t);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      d_a += __shfl_xor_sync(0xffffffffu, d_a, off);
      d_b += __shfl_xor_sync(0xffffffffu, d_b, off);
    }
    float* row = stats_row(a, b, h);
    if (t == 0) {
      row[r_a] = l_a;
      row[r_b] = l_b;
      row[padded_rows(S) + r_a] = d_a;
      row[padded_rows(S) + r_b] = d_b;
    }
    if (qt == nqt - 1) {  // the last query tile: the padded rows after it
      for (int r = nqt * kCtaRows + cw * 128 + tid; r < padded_rows(S); r += 128 * kConsumers) {
        row[r] = 0.f;
        row[padded_rows(S) + r] = 0.f;
      }
    }
  };
  const float sl2 = a.scale * kLog2e;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < ntiles; ++kt) {
    const int s = kt % kStages;
    const uint32_t phase = (kt / kStages) & 1;
    const int k0 = kt * N;
    const uint32_t skb = base + L::kKOff + s * 2 * L::kKV, svb = skb + L::kKV;
    mbar_wait(full + 8 * s, phase);
    if (a.causal && k0 > rmin + kWgRows - 1) {  // every key after this warpgroup's queries
      mbar_arrive(empty + 8 * s);
      continue;
    }

    // S = Q K^T, then dP = dout V^T: two groups in flight
    float sacc[N / 2], dp[N / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const uint32_t off = (ks % 4) * 32;
      const uint64_t db = smem_desc(skb + (ks / 4) * N * kRowBytes + off, 16, 1024);
      const uint64_t da = smem_desc(qa + (ks / 4) * kCtaRows * kRowBytes + off, 16, 1024);
      if (ks == 0) wgmma_ss_first(sacc, da, db);
      else wgmma_ss(sacc, da, db);
    }
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const uint32_t off = (ks % 4) * 32;
      const uint64_t db = smem_desc(svb + (ks / 4) * N * kRowBytes + off, 16, 1024);
      const uint64_t da = smem_desc(ga + (ks / 4) * kCtaRows * kRowBytes + off, 16, 1024);
      if (ks == 0) wgmma_ss_first(dp, da, db);
      else wgmma_ss(dp, da, db);
    }
    wgmma_commit();
    if (kt == 0) take_stats();  // the first step is never skipped

    // P while dP lands: element 4n + i is query row r_a (i < 2) or r_b, kv
    // column k0 + 8n + 2t + (i & 1)
    wgmma_wait<1>();
    fence_regs(sacc);
    const bool edge = k0 + N > S || (a.causal && k0 + N - 1 > rmin);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      sacc[4 * n + 0] = ex2(fmaf(sacc[4 * n + 0], sl2, -l_a));
      sacc[4 * n + 1] = ex2(fmaf(sacc[4 * n + 1], sl2, -l_a));
      sacc[4 * n + 2] = ex2(fmaf(sacc[4 * n + 2], sl2, -l_b));
      sacc[4 * n + 3] = ex2(fmaf(sacc[4 * n + 3], sl2, -l_b));
      if (edge) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = k0 + 8 * n + 2 * t + (i & 1), row = i < 2 ? r_a : r_b;
          if (col >= S || (a.causal && col > row)) sacc[4 * n + i] = 0.f;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      dp[4 * n + 0] = sacc[4 * n + 0] * (dp[4 * n + 0] - d_a) * a.scale;
      dp[4 * n + 1] = sacc[4 * n + 1] * (dp[4 * n + 1] - d_a) * a.scale;
      dp[4 * n + 2] = sacc[4 * n + 2] * (dp[4 * n + 2] - d_b) * a.scale;
      dp[4 * n + 3] = sacc[4 * n + 3] * (dp[4 * n + 3] - d_b) * a.scale;
    }
    uint32_t sa[PSTEPS][4];
    as_a_frags(dp, sa);

    // dQ += dS K: K read MN-major
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < PSTEPS; ++j)
      wgmma_rs(dq, sa[j], smem_desc(skb + j * 16 * kRowBytes, N * kRowBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
    fence_regs(sa);
    mbar_arrive(empty + 8 * s);
  }

  __nv_bfloat16* dqp = a.dq + b * a.dqb + h * a.dqh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r_a < S)
      *reinterpret_cast<uint32_t*>(dqp + r_a * a.dqs + c) = pack_bf16(dq[4 * n + 0], dq[4 * n + 1]);
    if (r_b < S)
      *reinterpret_cast<uint32_t*>(dqp + r_b * a.dqs + c) = pack_bf16(dq[4 * n + 2], dq[4 * n + 3]);
  }
}

template <int D>
cudaError_t run_bwd(const BwdArgs& a, int B, int Hkv, cudaStream_t st) {
  const int S = a.S, H = a.H;
  // the shared-memory sizes first: a runtime call makes the device's context
  // current on this thread (autograd's device thread may have none yet),
  // which the driver's tensor-map encoding needs
  cudaError_t err = cudaFuncSetAttribute(fa_bwd_dq_wgmma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DqSmem<D>::kBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dkdv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DkdvSmem<D>::kBytes);
  if (err != cudaSuccess) return err;
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  constexpr int NQ = DkdvSmem<D>::kStep;
  CUtensorMap qn, gn, k128, v128, q128, g128, kn, vn;
  constexpr int NK = DqSmem<D>::kStep;
  if (!encode_map(&qn, a.q, D, S, H, B, a.qb, a.qh, a.qs, NQ) ||
      !encode_map(&gn, a.g, D, S, H, B, a.gb, a.gh, a.gs, NQ) ||
      !encode_map(&k128, a.k, D, S, Hkv, B, a.kb, a.kh, a.ks, kCtaRows) ||
      !encode_map(&v128, a.v, D, S, Hkv, B, a.vb, a.vh, a.vs, kCtaRows) ||
      !encode_map(&q128, a.q, D, S, H, B, a.qb, a.qh, a.qs, kCtaRows) ||
      !encode_map(&g128, a.g, D, S, H, B, a.gb, a.gh, a.gs, kCtaRows) ||
      !encode_map(&kn, a.k, D, S, Hkv, B, a.kb, a.kh, a.ks, NK) ||
      !encode_map(&vn, a.v, D, S, Hkv, B, a.vb, a.vh, a.vs, NK)) {
    return cudaErrorInvalidValue;
  }
  // dQ first: it writes the stats the dK/dV kernel reads
  const unsigned tiles = (unsigned)((S + kCtaRows - 1) / kCtaRows);
  fa_bwd_dq_wgmma<D><<<dim3(tiles, (unsigned)H, (unsigned)B), kThreads, DqSmem<D>::kBytes, st>>>(
      q128, g128, kn, vn, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid = a.causal ? dim3((unsigned)Hkv, (unsigned)B, tiles)
                             : dim3(tiles, (unsigned)Hkv, (unsigned)B);
  fa_bwd_dkdv_wgmma<D><<<grid, kThreads, DkdvSmem<D>::kBytes, st>>>(qn, gn, k128, v128, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The bf16 backward: q, out, dout, dq [B, H, S, D]; k, v, dk, dv [B, Hkv,
// S, D], each given by its element strides over (batch, head, row) with
// the head dim contiguous and rows 16-byte aligned (as TMA wants); lse the
// forward's contiguous float32 [B, H, S]; stats a float32 scratch of
// B * H * 2 * Sp values, Sp = S rounded up to 384.  D in {64, 80, 112,
// 128}; H % Hkv == 0; when causal, S at most 65535 * 128 (the grid's third
// index takes a 128-row kv tile).  Two launches on `stream`; returns
// cudaGetLastError() after the last.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const float* lse, float* stats, void* dq,
                               void* dk, void* dv, int B, int H, int Hkv, int S, int D,
                               const long long* strides, int causal, float scale,
                               void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 || H > 65535 ||
      (causal && (long long)S > 65535ll * kCtaRows) || (D != 64 && D != 80 && D != 112 && D != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  if (S <= 0) return (int)cudaSuccess;
  const long long* s = strides;
  using bf16 = __nv_bfloat16;
  const BwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(o),
                  static_cast<const bf16*>(dout), lse, stats, static_cast<bf16*>(dq),
                  static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                  s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
                  s[12], s[13], s[14], s[15], s[16], s[17], s[18], s[19], s[20], s[21], s[22],
                  s[23], H, S, H / Hkv, causal, scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(D == 64    ? run_bwd<64>(a, B, Hkv, st)
               : D == 80  ? run_bwd<80>(a, B, Hkv, st)
               : D == 112 ? run_bwd<112>(a, B, Hkv, st)
                          : run_bwd<128>(a, B, Hkv, st));
}

// Dynamic shared memory of the dK/dV (which 0) and dQ (which 1) kernels at
// head dim D (bytes), or -1.
int flash_attention_bwd_smem_bytes(int D, int which) {
  if (which == 0)
    return D == 64    ? DkdvSmem<64>::kBytes
           : D == 80  ? DkdvSmem<80>::kBytes
           : D == 112 ? DkdvSmem<112>::kBytes
           : D == 128 ? DkdvSmem<128>::kBytes
                      : -1;
  return D == 64    ? DqSmem<64>::kBytes
         : D == 80  ? DqSmem<80>::kBytes
         : D == 112 ? DqSmem<112>::kBytes
         : D == 128 ? DqSmem<128>::kBytes
                    : -1;
}

}  // extern "C"
