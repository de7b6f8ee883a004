// mma_x3.cuh: float32 products on the tensor cores, each operand split into
// three bf16 pieces, fragments of float32 arrays in shared memory, and the
// cp.async staging the SSD and WKV kernels (forward and backward) share.
//
// A float32 x is x0 + x1 + x2 exactly: x0 = bf16(x), x1 = bf16(x - x0),
// x2 = bf16(x - x0 - x1) (each difference is exact; 3 x 8 bits hold the 24
// of x's significand).  mma.sync.m16n8k16 multiplies bf16 exactly and adds
// in float32, so a b is taken as six products, the smallest first:
// a2 b0 + a1 b1 + a0 b2 + a1 b0 + a0 b1 + a0 b0; the three dropped ones
// come to at most about 2^-23 |a b|, float32's own rounding.  Two pieces of
// TF32 (3xTF32) drop a term of up to 2^-22 and keep each operand only to
// 2^-22: on the H100 that moved zamba2-7b's served logits past their
// teacher-forced limit.
// Six m16n8k16 MMAs take the time of six m16n8k8 TF32 ones (bf16 runs at
// twice the rate), the same as 3xTF32 over the same k.
//
// Fragments of m16n8k16 (g = lane / 4, t = lane % 4; a register holds two
// bf16, the lower column or row in its low half):
//   A [16 x 16]: a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1),
//                a2 (g, 2t+8..2t+9), a3 (g + 8, 2t+8..2t+9)
//   B [16 x 8]:  b0 (2t..2t+1, g), b1 (2t+8..2t+9, g)           (rows k, col n)
//   C [16 x 8]:  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// So the C fragments of two n-tiles side by side are the A fragment of
// their 16 columns ({c0 c1, c2 c3} of the first, then of the second), and
// with rows and columns exchanged, a B fragment: a product's result feeds
// the next product from registers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace x3 {

// two floats -> bf16x2, lo in the low half (round to nearest even)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float low(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float high(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

// the three bf16x2 pieces of the pair (lo, hi)
struct Split {
  uint32_t p[3];
};

__device__ __forceinline__ Split split(float lo, float hi) {
  Split s;
  s.p[0] = pack(lo, hi);
  lo -= low(s.p[0]);
  hi -= high(s.p[0]);
  s.p[1] = pack(lo, hi);
  lo -= low(s.p[1]);
  hi -= high(s.p[1]);
  s.p[2] = pack(lo, hi);
  return s;
}

// an operand fragment in three pieces: piece q of register r is v[q][r]
template <int R>
struct Frag {
  uint32_t v[3][R];
};

// a fragment from R pairs of floats (pair r goes to register r)
template <int R>
__device__ __forceinline__ Frag<R> frag(const float (&lo)[R], const float (&hi)[R]) {
  Frag<R> f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const Split s = split(lo[r], hi[r]);
    f.v[0][r] = s.p[0];
    f.v[1][r] = s.p[1];
    f.v[2][r] = s.p[2];
  }
  return f;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b, the six products above
__device__ __forceinline__ void mma6(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  mma(d, a.v[2], b.v[0]);
  mma(d, a.v[1], b.v[1]);
  mma(d, a.v[0], b.v[2]);
  mma(d, a.v[1], b.v[0]);
  mma(d, a.v[0], b.v[1]);
  mma(d, a.v[0], b.v[0]);
}

// the p-th (p < 6, a constant once unrolled) of mma6's six products, so
// that independent products can be interleaved: each MMA of a sum waits
// for the one before it, and the MMAs issue in program order
__device__ __forceinline__ void mma6_piece(int p, float (&d)[4], const Frag<4>& a,
                                           const Frag<2>& b) {
  constexpr int kA[6] = {2, 1, 0, 1, 0, 0};
  constexpr int kB[6] = {0, 1, 2, 0, 1, 0};
  mma(d, a.v[kA[p]], b.v[kB[p]]);
}

// Fragments of float32 arrays in shared memory, row-major with row stride
// ld (even), split into their pieces.  A stride of 72 floats keeps a
// fragment that reads 8-byte pairs along rows on 32 distinct banks (a_rows,
// b_cols), one of 68 a fragment that reads two rows of one column (a_cols,
// b_rows).

// the A fragment of rows i0 + g, i0 + g + 8 and columns k0 .. k0 + 15
__device__ __forceinline__ Frag<4> a_rows(const float* M, int ld, int i0, int k0, int g, int t) {
  const float* m = M + (i0 + g) * ld + k0 + 2 * t;
  const float2 v0 = *reinterpret_cast<const float2*>(m);
  const float2 v1 = *reinterpret_cast<const float2*>(m + 8 * ld);
  const float2 v2 = *reinterpret_cast<const float2*>(m + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(m + 8 * ld + 8);
  const float lo[4] = {v0.x, v1.x, v2.x, v3.x};
  const float hi[4] = {v0.y, v1.y, v2.y, v3.y};
  return frag(lo, hi);
}

// the A fragment of the transpose: rows i0 + g, i0 + g + 8 of M^T (columns
// of M), k = rows k0 .. k0 + 15 of M
__device__ __forceinline__ Frag<4> a_cols(const float* M, int ld, int i0, int k0, int g, int t) {
  const float* m = M + (k0 + 2 * t) * ld + i0 + g;
  const float lo[4] = {m[0], m[8], m[8 * ld], m[8 * ld + 8]};
  const float hi[4] = {m[ld], m[ld + 8], m[9 * ld], m[9 * ld + 8]};
  return frag(lo, hi);
}

// the B fragment of k = rows k0 .. k0 + 15 and n = column j
__device__ __forceinline__ Frag<2> b_rows(const float* M, int ld, int k0, int j, int t) {
  const float* m = M + (k0 + 2 * t) * ld + j;
  const float lo[2] = {m[0], m[8 * ld]};
  const float hi[2] = {m[ld], m[9 * ld]};
  return frag(lo, hi);
}

// the B fragment of the transpose: k = columns k0 .. k0 + 15 of row j (n = j)
__device__ __forceinline__ Frag<2> b_cols(const float* M, int ld, int j, int k0, int t) {
  const float* m = M + j * ld + k0 + 2 * t;
  const float2 v0 = *reinterpret_cast<const float2*>(m);
  const float2 v1 = *reinterpret_cast<const float2*>(m + 8);
  const float lo[2] = {v0.x, v1.x};
  const float hi[2] = {v0.y, v1.y};
  return frag(lo, hi);
}

// acc += a b with the k-step's six products summed from zero and then
// added in float32: the tensor cores round toward zero as they accumulate,
// so no sum runs long in one accumulator
__device__ __forceinline__ void mma_add(float (&acc)[4], const Frag<4>& a, const Frag<2>& b) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma6(part, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// acc[i][j] += a[i] b[j] for NA x NB independent k-steps, each as mma_add
// (the same bits), their products interleaved
template <int NA, int NB>
__device__ __forceinline__ void mma_add_outer(float (&acc)[NA][NB][4], const Frag<4> (&a)[NA],
                                              const Frag<2> (&b)[NB]) {
  float part[NA][NB][4];
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j) mma6_piece(p, part[i][j], a[i], b[j]);
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

// acc[j] += a b[j], the NB k-steps interleaved
template <int NB>
__device__ __forceinline__ void mma_add_n(float (&acc)[NB][4], const Frag<4>& a,
                                          const Frag<2> (&b)[NB]) {
  mma_add_outer<1, NB>(reinterpret_cast<float (&)[1][NB][4]>(acc),
                       reinterpret_cast<const Frag<4> (&)[1]>(a), b);
}

// acc[j] += sum_k a[k] b[k][j]: NK k-steps of NB sums, interleaved, each
// k-step from zero and added in the order of k (the bits of NK mma_adds)
template <int NK, int NB>
__device__ __forceinline__ void mma_add_k(float (&acc)[NB][4], const Frag<4> (&a)[NK],
                                          const Frag<2> (&b)[NK][NB]) {
  float part[NK][NB][4];
#pragma unroll
  for (int k = 0; k < NK; ++k)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[k][j][e] = 0.f;
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int k = 0; k < NK; ++k)
#pragma unroll
      for (int j = 0; j < NB; ++j) mma6_piece(p, part[k][j], a[k], b[k][j]);
#pragma unroll
  for (int k = 0; k < NK; ++k)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[k][j][e];
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace x3
