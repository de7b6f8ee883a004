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
// Head dims 64, 112 (zamba2-7b's shared block) and 128.  The reference's
// wrapper pads D up to a multiple of 128 for the MXU; no input is padded or
// copied here.
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
//    shared memory, float32 accumulators.  D = 112 loads two 64-wide boxes
//    and TMA zero-fills columns 112-127; only 7 k-steps are issued, so the
//    all-zero 8th costs nothing (no 32-byte swizzle needed).
//  * Softmax online in registers, in float32: mask, running max in log2
//    units, P = 2^(s scale log2(e) - m) as one FMA and one ex2.approx.ftz
//    (a row masked so far takes no offset, so its P is 0).  Only tiles
//    that cross the diagonal or S are masked; kv
//    tiles above the diagonal are never loaded; the heaviest query tiles
//    of each head launch first.  kv columns at or past S score -1e30 (exp
//    gives 0, never NaN), query rows past S are not stored.
//  * O += P V: wgmma m64nDk16 with A from registers: the S accumulators,
//    packed into bf16 pairs, are already in wgmma's A-register layout.
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
#include <cuda.h>  // CUtensorMap and its enums; the entry point is taken at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: wgmma and TMA
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;                   // query rows of one consumer warpgroup
constexpr int kConsumers = 2;                 // consumer warpgroups
constexpr int kTileQ = kWgRows * kConsumers;  // query rows of a CTA
constexpr int kTileK = 128;                   // kv rows of a stage
constexpr int kStages = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kAtom = 64;       // bf16 columns in one 128-byte swizzled row
constexpr int kRowBytes = 128;  // bytes of a swizzled row

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the phase of parity `parity` to complete; a phase that never
// completes (a fault in the pipeline) traps after ~10 s instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// a box of the 4-D map at (c0, c1, c2, c3), into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep registers that an asynchronous wgmma reads or writes in place until
// after its wait (the compiler sees no use of them in between)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d[64 x 128] += A[64 x 16] B[128 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 128] = A[64 x 16] B[128 x 16]^T: the first k-step, which writes d
// without reading it (so the previous tile's values need not stay live)
__device__ __forceinline__ void wgmma_ss_first(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 112] += A[64 x 16] B[16 x 112], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[56], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

// 2^x on the MUFU unit; subnormal results flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 4-D map (D, S, heads, B) of a bf16 tensor given by its element strides
// over (batch, head, row), boxes of 64 columns x `rows` rows, 128-byte
// swizzle, zeros outside
bool encode_map(CUtensorMap* map, const void* ptr, int D, int S, int heads, int B,
                long long sb, long long sh, long long ss, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const long long elems[3] = {ss, sh, sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    // a dim of extent 1 is never stepped; TMA still wants a multiple of 16 bytes
    const cuuint64_t packed = i == 0 ? (cuuint64_t)((D * 2 + 15) / 16 * 16)
                                     : strides[i - 1] * dims[i];
    strides[i] = dims[i + 1] == 1 ? packed : (cuuint64_t)elems[i] * 2;
  }
  const cuuint32_t box[4] = {(cuuint32_t)kAtom, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t run_wgmma(const Args& a, int B, int H, int Hkv, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  if (!encode_map(&tq, a.q, D, a.S, H, B, a.qb, a.qh, a.qs, kTileQ) ||
      !encode_map(&tk, a.k, D, a.S, Hkv, B, a.kb, a.kh, a.ks, kTileK) ||
      !encode_map(&tv, a.v, D, a.S, Hkv, B, a.vb, a.vh, a.vs, kTileK)) {
    return cudaErrorInvalidValue;
  }
  const TmaArgs ta{a.o, a.ob, a.oh, a.os, a.lse, a.S, a.group, a.causal, a.scale};
  const int smem = Smem<D>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(fa_wgmma_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
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
  return D == 64 ? Smem<64>::kBytes : D == 112 ? Smem<112>::kBytes : D == 128 ? Smem<128>::kBytes : -1;
}

// q [B, H, S, D], k / v [B, Hkv, S, D], o [B, H, S, D], each given by its
// element strides over (batch, head, row) with the head dim contiguous;
// dtype 0 = float32, 1 = bfloat16 (all four alike; bf16 rows 16-byte
// aligned, as TMA wants); D in {64, 112, 128}; H % Hkv == 0.  lse, when not
// null, is a contiguous float32 [B, H, S] that takes each row's
// log-sum-exp.  Returns cudaGetLastError() after the launch.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, float* lse,
                           int dtype,
                           int B, int H, int Hkv, int S, int D, long long qb, long long qh,
                           long long qs, long long kb, long long kh, long long ks,
                           long long vb, long long vh, long long vs, long long ob, long long oh,
                           long long os, int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 || H > 65535 ||
      (D != 64 && D != 112 && D != 128) || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (S <= 0) return (int)cudaSuccess;
  const Args a{q, k, v, o, lse, S, H / Hkv, qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os,
               causal, scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return (int)(D == 64    ? run_wgmma<64>(a, B, H, Hkv, st)
                 : D == 112 ? run_wgmma<112>(a, B, H, Hkv, st)
                            : run_wgmma<128>(a, B, H, Hkv, st));
  }
  const dim3 grid((unsigned)((S + kBlockQ - 1) / kBlockQ), (unsigned)H, (unsigned)B);
  const size_t smem =
      (size_t)(kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D + kBlockQ * (kBlockK + 1)) *
      sizeof(float);
  return (int)(D == 64    ? run(fa_fwd_f32<64>, 256, smem, grid, a, st)
               : D == 112 ? run(fa_fwd_f32<112>, 256, smem, grid, a, st)
                          : run(fa_fwd_f32<128>, 256, smem, grid, a, st));
}

}  // extern "C"
