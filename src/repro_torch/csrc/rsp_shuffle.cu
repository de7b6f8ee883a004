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
// Design: one CTA per (output tile, batch).  A 116-byte HIGGS row is not a
// multiple of 16 bytes, so 16-byte vector loads do not apply; the CTA walks
// the output tile as a flat run of words (4-byte words when the row size
// allows, else 2-byte words), neighbouring threads on neighbouring
// words, so writes are fully coalesced and reads are coalesced within each
// source row.  Indices outside the tile are skipped rather than read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename W>
__global__ void rsp_shuffle_kernel(const W* __restrict__ x, const int32_t* __restrict__ tile_perm,
                                   const int32_t* __restrict__ intra, W* __restrict__ out,
                                   long long rows_per_batch, int n_tiles, int tile_rows,
                                   int row_words) {
  const int tile = blockIdx.x;
  const long long b = blockIdx.y;
  const long long tile_words = (long long)tile_rows * row_words;
  const long long slot = b * n_tiles + tile;
  const int src_tile = tile_perm[slot];
  if (src_tile < 0 || src_tile >= n_tiles) return;
  const int32_t* perm = intra + slot * tile_rows;
  const W* src = x + (b * rows_per_batch + (long long)src_tile * tile_rows) * row_words;
  W* dst = out + (b * rows_per_batch + (long long)tile * tile_rows) * row_words;
  for (long long w = threadIdx.x; w < tile_words; w += blockDim.x) {
    const int r = (int)(w / row_words);
    const int c = (int)(w - (long long)r * row_words);
    const int sr = perm[r];
    if (sr < 0 || sr >= tile_rows) continue;
    dst[w] = src[(long long)sr * row_words + c];
  }
}

template <typename W>
cudaError_t launch(const void* x, const void* tile_perm, const void* intra, void* out,
                   long long batch, long long rows_per_batch, int tile_rows, int row_bytes,
                   cudaStream_t st) {
  const int n_tiles = (int)(rows_per_batch / tile_rows);
  const dim3 grid((unsigned)n_tiles, (unsigned)batch);
  rsp_shuffle_kernel<W><<<grid, 256, 0, st>>>(
      static_cast<const W*>(x), static_cast<const int32_t*>(tile_perm),
      static_cast<const int32_t*>(intra), static_cast<W*>(out), rows_per_batch, n_tiles,
      tile_rows, row_bytes / (int)sizeof(W));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x / out [batch, rows_per_batch, row_bytes] (any dtype, row_bytes even,
// row-major and contiguous); tile_perm int32 [batch, n_tiles]; intra int32 [batch,
// n_tiles, tile_rows], with n_tiles = rows_per_batch / tile_rows.  Returns
// cudaGetLastError() after the launch.
int rsp_shuffle_launch(const void* x, const void* tile_perm, const void* intra, void* out,
                       long long batch, long long rows_per_batch, int tile_rows, int row_bytes,
                       void* stream) {
  if (tile_rows <= 0 || rows_per_batch % tile_rows != 0 || batch > 65535 || row_bytes % 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || rows_per_batch == 0 || row_bytes == 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (row_bytes % 4 == 0) {
    return (int)launch<uint32_t>(x, tile_perm, intra, out, batch, rows_per_batch, tile_rows,
                                 row_bytes, st);
  }
  return (int)launch<uint16_t>(x, tile_perm, intra, out, batch, rows_per_batch, tile_rows,
                               row_bytes, st);
}

// Message for a CUDA error code (for the Python wrappers' exceptions).
const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
