// Kernel K4: the canonical-Huffman mantissa decode walk, one thread per row.
//
// Replaces tac/ops/pallas_huffdec.py:huffman_decode_rows (_kernel). Per
// payload row, pos = mant_start; for each of the H lines with mantissa size
// m (SPEC.md §8 decode walk, tac/codec.py:_huffman_decode_scan):
//   m in [2, 8]: read the 32-bit window at pos, find the codeword length ln
//     and symbol; if the symbol is ESCAPE (2^m) the value is the next m raw
//     bits; pos += ln (+ m on escape). An uncovered peek gives ln = 0,
//     symbol 0, and the walk stalls in place.
//   otherwise (m = 0, 1, 9..16): the value is m raw bits; pos += m.
// A window is two adjacent big-endian words; both word indices clip to
// [0, W32 - 1], so a walk that runs past the payload reads the same
// (discarded) bits here as in the plain PyTorch mirror,
// tac_torch/ops/huffdec.py:huffman_decode_rows_plain.
//
// Length and symbol come from canonical-code arithmetic, not a peek LUT (all
// seven 2^13-entry LUTs would be 229 KB, more than a block's shared memory):
// for table t and length l the codes are the contiguous range
// canon[t][l] = (first, last, base), so the top l window bits v with
// first <= v <= last have rank v - first + base and symbol perm[t][rank].
// Both arrays (8.6 KB) sit in shared memory. The TPU kernel's run-decomposed
// permutation and select-accumulate window fetch avoided gathers, which are
// plain loads here.
//
// What bounds it on an H100: bytes in principle (m_line and the output are
// 85 MB each at the 16-clip run's 20 704 rows x 1024 lines, ~56 us at 3.35
// TB/s), latency in practice: each thread is a serial chain of H dependent
// steps. m_line and the output go through a 32 x 32 shared-memory tile per
// warp so that global traffic is coalesced although a thread owns a row; the
// row's words are read through the read-only cache as the cursor advances.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTab = 7;            // codable sizes m = 2..8
constexpr int kMaxLen = 16;        // longest codeword the tables hold
constexpr int kPerm = 257;         // symbols per table incl. ESCAPE
constexpr int kWarps = 4;          // warps per block, 32 rows each
constexpr int kTile = 32;          // lines per tile

__device__ __forceinline__ uint32_t window(const uint32_t* __restrict__ w,
                                           int w32, int pos) {
  const int w0 = pos >> 5;
  const unsigned r = pos & 31;
  const uint32_t hi = __ldg(w + min(max(w0, 0), w32 - 1));
  const uint32_t lo = __ldg(w + min(max(w0 + 1, 0), w32 - 1));
  return (hi << r) | (r ? lo >> (32 - r) : 0u);   // no shift by 32
}

__device__ __forceinline__ int top_bits(uint32_t win, int n) {
  return n > 0 ? (int)(win >> (32 - n)) : 0;      // no shift by 32
}

__global__ void __launch_bounds__(32 * kWarps)
huffdec_kernel(const uint32_t* __restrict__ words,
               const int* __restrict__ mant_start,
               const int* __restrict__ m_line, const int* __restrict__ canon,
               const int* __restrict__ perm, int* __restrict__ out, int rows,
               int h, int w32, int lmax) {
  __shared__ int s_canon[kTab][kMaxLen + 1][3];
  __shared__ int s_perm[kTab][kPerm];
  __shared__ int s_tile[kWarps][kTile][kTile + 1];

  for (int i = threadIdx.x; i < kTab * (kMaxLen + 1) * 3; i += blockDim.x)
    (&s_canon[0][0][0])[i] = canon[i];
  for (int i = threadIdx.x; i < kTab * kPerm; i += blockDim.x)
    (&s_perm[0][0])[i] = perm[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * kWarps + warp) * 32;
  if (row0 >= rows) return;                    // warp-uniform exit
  const int row = row0 + lane;
  const bool live = row < rows;
  const uint32_t* w = words + (size_t)(live ? row : row0) * w32;
  int pos = live ? mant_start[row] : 0;
  int (*tile)[kTile + 1] = s_tile[warp];

  for (int j0 = 0; j0 < h; j0 += kTile) {
    const int nj = min(kTile, h - j0);
    // coalesced load: lane = line within the tile, r = row of the warp
    for (int r = 0; r < 32 && row0 + r < rows; ++r)
      if (lane < nj) tile[r][lane] = m_line[(size_t)(row0 + r) * h + j0 + lane];
    __syncwarp();

    if (live) {
      for (int j = 0; j < nj; ++j) {
        const int m = tile[lane][j];
        int val, adv;
        if (m >= 2 && m <= 8) {
          const uint32_t win = window(w, w32, pos);
          const int t = m - 2;
          int ln = 0, sym = 0;
          for (int l = 1; l <= lmax; ++l) {
            const int v = (int)(win >> (32 - l));
            const int first = s_canon[t][l][0];
            if (v >= first && v <= s_canon[t][l][1]) {
              ln = l;
              sym = s_perm[t][v - first + s_canon[t][l][2]];
              break;
            }
          }
          if (ln > 0 && sym == (1 << m)) {       // ESCAPE: m raw bits follow
            val = top_bits(window(w, w32, pos + ln), m);
            adv = ln + m;
          } else {                               // ln == 0: stall, value 0
            val = sym;
            adv = ln;
          }
        } else {
          val = top_bits(window(w, w32, pos), m);
          adv = m;
        }
        tile[lane][j] = val;
        pos += adv;
      }
    }
    __syncwarp();

    for (int r = 0; r < 32 && row0 + r < rows; ++r)
      if (lane < nj) out[(size_t)(row0 + r) * h + j0 + lane] = tile[r][lane];
    __syncwarp();
  }
}

}  // namespace

// words u32[rows, w32] (32-bit patterns); mant_start i32[rows]; m_line
// i32[rows, h] with values in [0, 16]; canon i32[7, 17, 3]; perm i32[7, 257];
// out i32[rows, h]; lmax = the set's longest codeword (<= 16). Returns
// cudaGetLastError() after the launch.
extern "C" int tac_huffman_decode_rows(const void* words, const int* mant_start,
                                       const int* m_line, const int* canon,
                                       const int* perm, int* out, int rows,
                                       int h, int w32, int lmax, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 1 || h < 1 || w32 < 1 || lmax < 1 || lmax > kMaxLen)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + 32 * kWarps - 1) / (32 * kWarps);
  huffdec_kernel<<<blocks, 32 * kWarps, 0, st>>>(
      static_cast<const uint32_t*>(words), mant_start, m_line, canon, perm, out,
      rows, h, w32, lmax);
  return (int)cudaGetLastError();
}
