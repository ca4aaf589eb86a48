// Kernel K4: the canonical-Huffman mantissa decode walk, one thread per row,
// every row of a decode in one launch, each with its own table set.
//
// Replaces tac/ops/pallas_huffdec.py:huffman_decode_rows (_kernel). Per
// payload row whose tableId s names a loaded set, pos = mant_start; for each
// of the H lines with mantissa size m (SPEC.md §8 decode walk,
// tac/codec.py:_huffman_decode_scan):
//   m in [2, 8]: peek at pos, take the codeword length ln and symbol from
//     set s's table m; if the symbol is ESCAPE (2^m) the value is the next m
//     raw bits; pos += ln (+ m on escape). An uncovered peek gives ln = 0,
//     symbol 0, and the walk stalls in place.
//   otherwise (m = 0, 1, 9..16): the value is m raw bits; pos += m.
// Rows of any other tableId are not walked: their raw mantissas, already in
// `out`, stay. The row's bits are the stream of its words with every word
// index clipped to [0, W32 - 1], so a walk that runs past the payload reads
// the last word over and over, as the plain PyTorch mirror
// (tac_torch/ops/huffdec.py:huffman_decode_rows_plain) and tac do.
//
// Length and symbol come from one shared-memory load. Each table t of a set
// is a peek LUT at its own width w_t, its longest codeword, not the set's
// (huffman.py:compact_dec_lut): 16-bit entries length << 9 | symbol. The
// three trained sets' widths are [4, 8, 9, 10, 11, 12, 13], [4, 7, 10, 10,
// 12, 12, 13] and [4, 8, 8, 10, 11, 11, 12]: 16 144 + 18 576 + 9 744 = 44 464
// entries, 88.9 KB, which a block holds after the dynamic shared-memory
// opt-in (227 KB at most on an H100).
//
// What bounds it on an H100: bytes in principle (words, m_line, tid,
// mant_start and the Huffman rows' output, ~187 MB at the 16-clip run's
// 20 704 rows x 1024 lines, ~56 us at 3.35 TB/s), the chain in practice:
// each thread is a serial walk of H dependent steps, and 20 704 threads are
// ~5 warps an SM, too few to hide a step's latency. So a step is short and
// has no load from device memory on it:
//   * the row's bits sit in a 64-bit register buffer holding at least 32
//     valid bits (a line takes at most 16 + 8), refilled a word at a time
//     from four words whose loads were issued four refills ahead;
//   * the step is straight-line code with selects (raw, codable and escape
//     lines differ only in which bits of the same window they keep and how
//     far pos moves): a shift, one shared load, a few integer ops; only
//     the refill, taken every few lines, is a branch;
//   * m_line comes through a 32 x 32 shared-memory tile per warp (coalesced
//     although a thread owns a row), the next tile's values loaded into
//     registers before the current tile's walk, and each line's size and
//     table offset / width read from shared memory a line ahead;
//   * the blocks copy the LUTs with cp.async, all copies in flight at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSets = 3;        // tableId is two bits: raw + three sets
constexpr int kTab = 7;            // codable sizes m = 2..8
constexpr int kWarps = 4;          // warps per block, 32 rows each
constexpr int kTile = 32;          // lines per tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct SetTables {
  const uint4* lut[kMaxSets];      // compact LUT, 8 entries per uint4
  const int* tab[kMaxSets];        // [7] offset << 5 | width
  int lut_vec[kMaxSets];           // LUT length in uint4
  int n;
};

__global__ void __launch_bounds__(32 * kWarps)
huffdec_sets_kernel(const uint32_t* __restrict__ words,
                    const int* __restrict__ mant_start,
                    const int* __restrict__ m_line, const int* __restrict__ tid,
                    int* __restrict__ out, SetTables sets, int rows, int h,
                    int w32) {
  extern __shared__ uint4 s_lut_vec[];       // every set's LUT, back to back
  __shared__ int s_tab[kMaxSets][kTab];      // offset in s_lut << 5 | width
  __shared__ int s_tile[kWarps][kTile][kTile + 1];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * kWarps + warp) * 32;
  const int row = row0 + lane;
  const int s = row < rows ? tid[row] : 0;
  const bool walk = s >= 1 && s <= sets.n;
  // a block none of whose rows is Huffman-coded leaves before the copy
  if (!__syncthreads_or(walk)) return;

  int base = 0;                              // in uint4
  for (int i = 0; i < sets.n; ++i) {         // all copies in flight at once
    for (int k = threadIdx.x; k < sets.lut_vec[i]; k += blockDim.x)
      cp_async16(s_lut_vec + base + k, sets.lut[i] + k);
    if (threadIdx.x < kTab)
      s_tab[i][threadIdx.x] = sets.tab[i][threadIdx.x] + (base << 8);
    base += sets.lut_vec[i];                 // (base * 8 entries) << 5
  }
  cp_async_wait_all();
  __syncthreads();
  const uint16_t* s_lut = reinterpret_cast<const uint16_t*>(s_lut_vec);

  const unsigned walking = __ballot_sync(kFull, walk);
  if (!walking) return;                      // warp-uniform exit
  // a lane that does not walk shadows the warp's first walking row, so its
  // loads fall on addresses the warp reads anyway; its results are dropped
  const int lead = __ffs(walking) - 1;
  const int s_lead = __shfl_sync(kFull, s, lead);
  const int src = walk ? row : row0 + lead;
  const int set = (walk ? s : s_lead) - 1;
  const uint32_t* w = words + (size_t)src * w32;
  auto word = [&](int i) { return __ldg(w + min(max(i, 0), w32 - 1)); };

  // The row's next bits sit in buf, left-aligned, nbits of them valid (at
  // least 32 after every refill). The words after them: `cur` is being
  // consumed, one word a refill; `nxt` was loaded when `cur` became
  // current, four refills before it is needed (a queue rotated one word a
  // refill would read each load's register one refill after issuing it,
  // and wait).
  const int pos = mant_start[src];
  int next = pos >> 5;                       // floor, for negative too
  uint64_t buf = ((uint64_t)word(next) << 32 | word(next + 1)) << (pos & 31);
  int nbits = 64 - (pos & 31);               // zeros below the valid bits
  uint4 cur = make_uint4(word(next + 2), word(next + 3), word(next + 4),
                         word(next + 5));
  uint4 nxt = make_uint4(word(next + 6), word(next + 7), word(next + 8),
                         word(next + 9));
  next += 10;
  int used = 0;                              // words of `cur` consumed

  int (*tile)[kTile + 1] = s_tile[warp];
  int pre[kTile];                            // the next tile's m_line column
#pragma unroll
  for (int r = 0; r < kTile; ++r)
    pre[r] = ((walking >> r) & 1) && lane < h
                 ? m_line[(size_t)(row0 + r) * h + lane] : 0;

  for (int j0 = 0; j0 < h; j0 += kTile) {
    const int nj = min(kTile, h - j0);
#pragma unroll
    for (int r = 0; r < kTile; ++r) tile[r][lane] = pre[r];
    __syncwarp();
    const int jn = j0 + kTile + lane;        // issue the next tile's loads now
#pragma unroll
    for (int r = 0; r < kTile; ++r)
      if (((walking >> r) & 1) && jn < h)
        pre[r] = m_line[(size_t)(row0 + r) * h + jn];

    // line j's size and table entry are read one line ahead, off the chain
    int m = tile[lane][0];
    int ti = s_tab[set][min(max(m - 2, 0), kTab - 1)];
    for (int j = 0; j < nj; ++j) {
      const int mj = m, tij = ti;
      m = tile[lane][min(j + 1, kTile - 1)];
      const bool codable = (unsigned)(mj - 2) < (unsigned)kTab;
      const uint32_t win = (uint32_t)(buf >> 32);
      // top w bits of the window (w = 0 gives 0: no shift by 32)
      const int e = s_lut[(tij >> 5) + ((win >> 1) >> (31 - (tij & 31)))];
      ti = s_tab[set][min(max(m - 2, 0), kTab - 1)];
      const int ln = e >> 9, sym = e & 511;
      const bool esc = codable && sym == (1 << mj);
      const int cb = codable ? ln : 0;                  // codeword bits
      const int rb = codable && !esc ? 0 : mj;          // raw bits after them
      const int raw = (int)(((buf << cb) >> 1) >> (63 - rb));   // rb = 0 -> 0
      tile[lane][j] = codable && !esc ? sym : raw;
      const int adv = cb + rb;
      buf <<= adv;
      nbits -= adv;
      if (nbits < 32) {                      // keep >= 32 valid bits
        const uint32_t wv = used == 0 ? cur.x : used == 1 ? cur.y
                          : used == 2 ? cur.z : cur.w;
        buf |= (uint64_t)wv << (32 - nbits);
        nbits += 32;
        if (++used == 4) {
          used = 0;
          cur = nxt;
          nxt = make_uint4(word(next), word(next + 1), word(next + 2),
                           word(next + 3));
          next += 4;
        }
      }
    }
    __syncwarp();
    for (int r = 0; r < kTile; ++r)
      if (((walking >> r) & 1) && lane < nj)
        out[(size_t)(row0 + r) * h + j0 + lane] = tile[r][lane];
    __syncwarp();
  }
}

}  // namespace

// Lets the kernel take up to the device's opt-in shared memory a block.
// Call once per device before the first launch there.
extern "C" int tac_huffdec_setup(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, huffdec_sets_kernel);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(huffdec_sets_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   optin - (int)fa.sharedSizeBytes);
}

// words u32[rows, w32] (32-bit patterns); mant_start, tid i32[rows]; m_line
// i32[rows, h] with values in [0, 16]; out i32[rows, h] holding the raw
// mantissas, whose rows with tid in [1, n_sets] are overwritten. luts, tabs,
// lut_len: host arrays of n_sets device pointers (compact LUT, 16-byte
// aligned, lut_len[i] entries, a multiple of 8; [7] offset << 5 | width)
// and lengths. Returns cudaGetLastError() after the launch.
extern "C" int tac_huffman_decode_sets(const void* words, const int* mant_start,
                                       const int* m_line, const int* tid,
                                       int* out, const void* const* luts,
                                       const void* const* tabs,
                                       const int* lut_len, int n_sets, int rows,
                                       int h, int w32, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 1 || h < 1 || w32 < 1 || n_sets < 1 || n_sets > kMaxSets)
    return (int)cudaErrorInvalidValue;
  SetTables sets{};
  size_t smem = 0;
  for (int i = 0; i < n_sets; ++i) {
    if (lut_len[i] < 1 || lut_len[i] % 8) return (int)cudaErrorInvalidValue;
    sets.lut[i] = static_cast<const uint4*>(luts[i]);
    sets.tab[i] = static_cast<const int*>(tabs[i]);
    sets.lut_vec[i] = lut_len[i] / 8;
    smem += sizeof(uint16_t) * lut_len[i];
  }
  sets.n = n_sets;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + 32 * kWarps - 1) / (32 * kWarps);
  huffdec_sets_kernel<<<blocks, 32 * kWarps, smem, st>>>(
      static_cast<const uint32_t*>(words), mant_start, m_line, tid, out, sets,
      rows, h, w32);
  return (int)cudaGetLastError();
}
