// rsp_shuffle: the hierarchical row shuffle of Algorithm 1's randomize step,
//   out[b, i*T + r, :] = x[b, tile_perm[b, i]*T + intra_perm[b, i, r], :]
// for every batch b (one original block each), output tile i and row r.
//
// Replaces the Pallas kernel rsp_shuffle_pallas (_shuffle_kernel) of
// src/repro/kernels/rsp_shuffle/kernel.py.  On the TPU the intra-tile
// permutation ran as a one-hot matmul on the MXU because VMEM had no vector
// gather; here it is a plain gather, and the rows are copied as raw words,
// so the output is bit-exact for any dtype whose rows are an even number of
// bytes (every float dtype the partition backends admit).
//
// Bound on the H100: bytes.  Every row is read once and written once, plus
// the index arrays: for one 110,000 x 29 float32 original block that is
// 12.76 MB + 12.76 MB + 0.44 MB, ~7.7 us at 3.35 TB/s (~0.77 ms for the 100
// blocks of the main path, which go in one launch).
//
// One CTA per (output tile, batch) -- for the row kernel, per (output
// tile, batch, slice of kRowsPerCta rows) -- in one of two kernels; the
// wrapper picks the path (rsp_shuffle/kernel.py, shuffle_path) and this
// launcher checks it:
//  * rsp_shuffle_staged: when the tile's bytes are a multiple of 16, both
//    base pointers 16-byte aligned and the tile fits in shared memory
//    (the main path's HIGGS tile: 1100 x 116 B = 127,600 B = 16 x 7,975).
//    The source tile (tile_perm's pick) is contiguous, so it is staged in
//    shared memory with bulk async copies (cp.async.bulk, completion on an
//    mbarrier; no tensor map) while the threads load intra_perm beside it.
//    The output tile is then written in order, 16 bytes a thread a store,
//    each 16-byte chunk gathered from shared memory through intra_perm.
//    Row and column of a chunk's words are stepped along with 32-bit adds:
//    no division in the loop.  At 127.6 KB one CTA fits on an SM, so an
//    SM's loads and stores do not overlap; across the 10,000 CTAs the SMs
//    drift apart and the card sees both at once.
//  * rsp_shuffle_rows: every other tile (rows of 116 B in tiles of 110, or
//    tiles over the 227 KB of shared memory).  One warp per output row
//    copies the row from its source row in 4-byte words (2-byte when the
//    row's size is not a multiple of 4), neighbouring lanes on neighbouring
//    words, with 32-bit index arithmetic within the row.  A long tile's
//    rows are dealt over gridDim.z CTAs (one per kRowsPerCta rows), so the
//    collective partition's few tiles of 687,500 rows (four a rank at HIGGS
//    size) still fill the card.
// Rows whose intra_perm index lies outside the tile, and tiles whose
// tile_perm index lies outside the block, are skipped rather than read.
//
// The threads a CTA are a template argument of both kernels: the staged
// kernel takes 512 or 1024, the row kernel 256, 512 or 1024 (128 threads,
// and 256 staged, were the slowest of their paths on the H100), with
// defaults kStagedThreads and kRowsThreads.  The autotuner
// (kernels/autotune.py) times each; the output is the same gather, bit for
// bit, whatever the count and the path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStagedThreads = 1024;  // the staged kernel's default CTA
constexpr int kRowsThreads = 256;     // the row kernel's default CTA
constexpr int kRowsPerCta = 1024;   // rows of one tile a row-kernel CTA copies
constexpr int kCopyBytes = 16384;  // one bulk copy of the staged tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the 16 bytes of kPer words, in order
template <typename W, int kPer>
__device__ __forceinline__ uint4 pack16(const W (&w)[kPer]) {
  if constexpr (kPer == 4) {
    return make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = (uint32_t)w[2 * i] | ((uint32_t)w[2 * i + 1] << 16);
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
}

template <typename W, int kThreads>
__global__ void __launch_bounds__(kThreads)
    rsp_shuffle_staged(const unsigned char* __restrict__ x, const int32_t* __restrict__ tile_perm,
                       const int32_t* __restrict__ intra, unsigned char* __restrict__ out,
                       int n_tiles, int tile_rows, int row_words) {
  constexpr int kPer = 16 / sizeof(W);  // words of a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_words = tile_rows * row_words;
  const int tile_bytes = tile_words * (int)sizeof(W);
  const W* src_s = reinterpret_cast<const W*>(smem);
  int32_t* perm_s = reinterpret_cast<int32_t*>(smem + tile_bytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + tile_bytes + ((tile_rows * 4 + 15) & ~15));
  const uint32_t bar_s = smem_u32(bar);

  const long long slot = (long long)blockIdx.y * n_tiles + blockIdx.x;
  const int src_tile = tile_perm[slot];
  if (src_tile < 0 || src_tile >= n_tiles) return;  // uniform over the CTA
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_s),
                 "r"(tile_bytes)
                 : "memory");
    const unsigned char* src = x + ((long long)blockIdx.y * n_tiles + src_tile) * tile_bytes;
    for (int off = 0; off < tile_bytes; off += kCopyBytes) {
      const int n = min(kCopyBytes, tile_bytes - off);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
          ::"r"(smem_u32(smem + off)), "l"(src + off), "r"(n), "r"(bar_s)
          : "memory");
    }
  }
  const int32_t* perm = intra + slot * tile_rows;
  for (int r = threadIdx.x; r < tile_rows; r += blockDim.x) perm_s[r] = perm[r];
  __syncthreads();  // perm_s written, the barrier initialised
  // the tile has landed (a copy that never lands traps after ~10 s)
  for (const long long t0 = clock64();;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar_s)
        : "memory");
    if (done) break;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }

  // chunk c holds words kPer c .. kPer c + kPer - 1 of the output tile; a
  // thread's chunks are blockDim.x apart, so its (row, column) steps by a
  // constant
  const int chunks = tile_words / kPer;
  const int step = (int)blockDim.x * kPer;
  const int step_r = step / row_words, step_c = step - step_r * row_words;
  int r = (int)threadIdx.x * kPer / row_words;
  int col = (int)threadIdx.x * kPer - r * row_words;
  uint4* dst = reinterpret_cast<uint4*>(out + slot * tile_bytes);
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    W w[kPer];
    bool whole = true;
    int rr = r, cc = col;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int sr = perm_s[rr];
      const bool in = sr >= 0 && sr < tile_rows;
      whole = whole && in;
      w[j] = in ? src_s[sr * row_words + cc] : W(0);
      if (++cc == row_words) {
        cc = 0;
        ++rr;
      }
    }
    if (whole) {
      dst[c] = pack16(w);
    } else {  // some rows index outside the tile: store the others alone
      W* d = reinterpret_cast<W*>(dst + c);
      rr = r;
      cc = col;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int sr = perm_s[rr];
        if (sr >= 0 && sr < tile_rows) d[j] = w[j];
        if (++cc == row_words) {
          cc = 0;
          ++rr;
        }
      }
    }
    r += step_r;
    col += step_c;
    if (col >= row_words) {
      col -= row_words;
      ++r;
    }
  }
}

template <typename W, int kThreads>
__global__ void __launch_bounds__(kThreads)
    rsp_shuffle_rows(const W* __restrict__ x, const int32_t* __restrict__ tile_perm,
                     const int32_t* __restrict__ intra, W* __restrict__ out, int n_tiles,
                     int tile_rows, int row_words) {
  const long long slot = (long long)blockIdx.y * n_tiles + blockIdx.x;
  const int src_tile = tile_perm[slot];
  if (src_tile < 0 || src_tile >= n_tiles) return;
  const long long tile_words = (long long)tile_rows * row_words;
  const int32_t* perm = intra + slot * tile_rows;
  const W* src = x + ((long long)blockIdx.y * n_tiles + src_tile) * tile_words;
  W* dst = out + slot * tile_words;
  const int warps = blockDim.x / 32, lane = threadIdx.x % 32;
  const int stride = warps * (int)gridDim.z;
  for (int r = (int)blockIdx.z * warps + threadIdx.x / 32; r < tile_rows; r += stride) {
    const int sr = perm[r];
    if (sr < 0 || sr >= tile_rows) continue;
    const W* s = src + (long long)sr * row_words;
    W* d = dst + (long long)r * row_words;
    for (int c = lane; c < row_words; c += 32) d[c] = s[c];
  }
}

template <typename W, int kThreads>
cudaError_t launch_rows_t(const void* x, const int32_t* tp, const int32_t* ip, void* out,
                          dim3 grid, int tile_rows, int row_bytes, cudaStream_t st) {
  rsp_shuffle_rows<W, kThreads><<<grid, kThreads, 0, st>>>(
      static_cast<const W*>(x), tp, ip, static_cast<W*>(out), (int)grid.x, tile_rows,
      row_bytes / (int)sizeof(W));
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_rows(const void* x, const int32_t* tp, const int32_t* ip, void* out, dim3 grid,
                        int tile_rows, int row_bytes, int threads, cudaStream_t st) {
  switch (threads) {
    case 256: return launch_rows_t<W, 256>(x, tp, ip, out, grid, tile_rows, row_bytes, st);
    case 512: return launch_rows_t<W, 512>(x, tp, ip, out, grid, tile_rows, row_bytes, st);
    case 1024: return launch_rows_t<W, 1024>(x, tp, ip, out, grid, tile_rows, row_bytes, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename W, int kThreads>
cudaError_t launch_staged_t(const void* x, const int32_t* tp, const int32_t* ip, void* out,
                            dim3 grid, int tile_rows, int row_bytes, int smem, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      rsp_shuffle_staged<W, kThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  rsp_shuffle_staged<W, kThreads><<<grid, kThreads, smem, st>>>(
      static_cast<const unsigned char*>(x), tp, ip, static_cast<unsigned char*>(out),
      (int)grid.x, tile_rows, row_bytes / (int)sizeof(W));
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_staged(const void* x, const int32_t* tp, const int32_t* ip, void* out,
                          dim3 grid, int tile_rows, int row_bytes, int smem, int threads,
                          cudaStream_t st) {
  switch (threads) {
    case 512: return launch_staged_t<W, 512>(x, tp, ip, out, grid, tile_rows, row_bytes, smem, st);
    case 1024:
      return launch_staged_t<W, 1024>(x, tp, ip, out, grid, tile_rows, row_bytes, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x / out [batch, rows_per_batch, row_bytes] (any dtype, row_bytes even,
// row-major and contiguous); tile_perm int32 [batch, n_tiles]; intra int32
// [batch, n_tiles, tile_rows], with n_tiles = rows_per_batch / tile_rows.
// staged = 1 takes rsp_shuffle_staged, which needs tile_rows * row_bytes a
// multiple of 16, x and out 16-byte aligned and the staged shared memory
// within the card's opt-in limit (repro_smem_optin); staged = 0 takes
// rsp_shuffle_rows.  threads: a CTA's threads (staged 512 or 1024, rows
// 256, 512 or 1024; 0 takes the path's default).  Returns
// cudaGetLastError() after the launch.
int rsp_shuffle_launch(const void* x, const void* tile_perm, const void* intra, void* out,
                       long long batch, long long rows_per_batch, int tile_rows, int row_bytes,
                       int staged, int threads, void* stream) {
  if (tile_rows <= 0 || rows_per_batch % tile_rows != 0 || batch > 65535 || row_bytes % 2 ||
      rows_per_batch / tile_rows > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || rows_per_batch == 0 || row_bytes == 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int n_tiles = (int)(rows_per_batch / tile_rows);
  const dim3 grid((unsigned)n_tiles, (unsigned)batch);
  const auto* tp = static_cast<const int32_t*>(tile_perm);
  const auto* ip = static_cast<const int32_t*>(intra);
  if (threads == 0) threads = staged ? kStagedThreads : kRowsThreads;
  if (!staged) {
    const long long slices = ((long long)tile_rows + kRowsPerCta - 1) / kRowsPerCta;
    const dim3 rows_grid(grid.x, grid.y, (unsigned)(slices < 65535 ? slices : 65535));
    return (int)(row_bytes % 4 == 0 ? launch_rows<uint32_t>(x, tp, ip, out, rows_grid,
                                                            tile_rows, row_bytes, threads, st)
                                    : launch_rows<uint16_t>(x, tp, ip, out, rows_grid,
                                                            tile_rows, row_bytes, threads, st));
  }
  const long long tile_bytes = (long long)tile_rows * row_bytes;
  // the tile, its intra_perm padded to 16 bytes, one mbarrier; a size over
  // the card's limit fails cudaFuncSetAttribute
  const long long smem = tile_bytes + (((long long)tile_rows * 4 + 15) & ~15LL) + 8;
  if (tile_bytes % 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || smem > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)(row_bytes % 4 == 0
                   ? launch_staged<uint32_t>(x, tp, ip, out, grid, tile_rows, row_bytes, (int)smem,
                                             threads, st)
                   : launch_staged<uint16_t>(x, tp, ip, out, grid, tile_rows, row_bytes, (int)smem,
                                             threads, st));
}

// Shared memory a block may opt into on the current device (bytes), or -1.
int repro_smem_optin(void) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return -1;
  }
  return limit;
}

// Message for a CUDA error code (for the Python wrappers' exceptions).
const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
