// Kernel K2: MSB-first field placement into 32-bit words, one warp per row.
//
// Replaces tac/ops/pallas_pack.py:scatter_words_rows (_kernel_win, and
// _kernel when TAC_PACK_WIN=0): per row, words[w] = OR of every field's
// first-word contribution c0 with word0 == w and spill contribution c1
// with word0 == w - 1; contributions beyond the row's W32 words drop. The
// plain PyTorch mirror is tac_torch/ops/pack.py:scatter_words_rows_plain.
//
// What bounds it on an H100: bytes. Each field is read once (c0, c1, word0:
// 12 bytes) and each word written once, ~271 MB for the flagship's 20 704
// rows x 1 075 fields, about 81 us at 3.35 TB/s; the arithmetic is one OR
// per field. The design reads a row's fields with lane f % 32, so each
// warp-wide load is 128 contiguous bytes, ORs them into the row's words in
// shared memory (shared atomics; OR commutes, so the result does not
// depend on their order) and writes the words back coalesced. Four rows
// per 128-thread block keep loads from several rows in flight per SM.
// The TPU kernel's register window existed to avoid dynamic indexing on
// the vector unit; shared memory indexes freely, so it is not needed. The
// word buffer is dynamic shared memory of W32 words a row, so a launch
// takes any W32 up to the 48 KB a block gets without an opt-in: 3 072
// words (the mid/side VBR rows need 408).

#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kMaxWords = (48 << 10) / (kRowsPerBlock * 4);

__global__ void __launch_bounds__(32 * kRowsPerBlock)
scatter_words_kernel(const unsigned* __restrict__ c0,
                     const unsigned* __restrict__ c1,
                     const int* __restrict__ word0, unsigned* __restrict__ out,
                     int rows, int nf, int w32) {
  extern __shared__ unsigned buf[];            // [kRowsPerBlock][w32]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;                     // warp-uniform exit
  unsigned* words = buf + warp * w32;
  for (int w = lane; w < w32; w += 32) words[w] = 0u;
  __syncwarp();
  const size_t base = (size_t)row * nf;
  for (int f = lane; f < nf; f += 32) {
    const int w = word0[base + f];
    const unsigned v0 = c0[base + f], v1 = c1[base + f];
    if (v0 && (unsigned)w < (unsigned)w32) atomicOr(&words[w], v0);
    if (v1 && (unsigned)(w + 1) < (unsigned)w32) atomicOr(&words[w + 1], v1);
  }
  __syncwarp();
  for (int w = lane; w < w32; w += 32) out[(size_t)row * w32 + w] = words[w];
}

}  // namespace

// c0, c1: u32[rows, nf] word contributions (int32 storage); word0:
// i32[rows, nf]; out: u32[rows, w32]. Returns cudaGetLastError() after the
// launch.
extern "C" int tac_scatter_words_rows(const void* c0, const void* c1,
                                      const int* word0, void* out, int rows,
                                      int nf, int w32, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (w32 < 1 || w32 > kMaxWords || nf < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem = sizeof(unsigned) * kRowsPerBlock * w32;
  scatter_words_kernel<<<blocks, 32 * kRowsPerBlock, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(c0), static_cast<const unsigned*>(c1),
      word0, static_cast<unsigned*>(out), rows, nf, w32);
  return (int)cudaGetLastError();
}
