// Kernel K7: row-invariant f32 segment sums, out[r, s] = sum of x[r, l] over
// l in [start_s, end_s), added in index order in double, rounded once.
//
// A kernel of the port with no TPU counterpart: it replaces the per-band
// cumsums of the fast psy model's noise maskers (tac_torch/psy.py,
// band_slice_sum; tac/psy.py's segment sums) and the first-difference
// energies of block switching's transient detector (tac_torch/
// blockswitch.py:transient_flags, a prefix sum read at eight segment
// edges; tac/blockswitch.py's cumsum). The library scan takes another
// order for a few rows than for many, so a one-row stream push summed a
// band differently from the batch; here each segment's sum is one lane's
// loop over its entries in index order, whatever the number of rows. The
// accumulator is a double, as the CPU's cumsum keeps it, so the result
// equals the plain version (tac_torch/ops/segment_sum.py:
// segment_sums_plain, the last entry of a per-segment CPU cumsum) bit for
// bit.
//
// What bounds it on an H100: bytes, each row read once; a 2 048-row launch
// of 1 024-line rows is 8.4 MB, 2.5 us at 3.35 TB/s. Its critical path is
// the widest segment's chain of dependent double adds (304 lines in band 25
// at H = 1 024, 44.1 kHz).
//
// Design (Hopper): a warp per row, eight rows a 256-thread block, so that
// a 2 048-row launch fills the card with 256 blocks. The warp stages its
// row in shared memory, kChunk floats at a time, by coalesced 16-byte loads
// (4-byte loads where the row is not 16-byte aligned); then lane i adds
// segment i (and i + 32: at most kMaxSegs = 64) out of shared memory into
// its double accumulator, which carries from one chunk to the next, so the
// additions are those of one loop over the segment in index order. The
// transient detector's nested prefixes [0, e_i) are segments like any
// other: their lanes read the same shared words in the same steps (a
// broadcast), and the longest prefix's chain is the whole critical path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSegs = 64;
constexpr int kWarps = 8;          // rows a block
constexpr int kChunk = 1024;       // floats of a row in shared memory at a time

struct Segs {
  int start[kMaxSegs];
  int end[kMaxSegs];
};

// acc + x[l] for l in [lo, hi) ∩ [c0, c0 + n), in index order; buf holds
// x[c0 .. c0 + n).
__device__ __forceinline__ double add_range(const float* buf, int c0, int n,
                                            int lo, int hi, double acc) {
  const int a = max(lo, c0) - c0, b = min(hi, c0 + n) - c0;
#pragma unroll 8
  for (int i = a; i < b; ++i) acc += (double)buf[i];
  return acc;
}

__global__ void __launch_bounds__(kWarps * 32)
segment_sum_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int rows, int len, int nseg, int lo, int hi,
                   const Segs segs) {
  __shared__ __align__(16) float stage[kWarps][kChunk];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= rows) return;             // the warp's own row only: no block sync
  const float* row = x + (long long)r * len;
  float* buf = stage[warp];
  float* dst = out + (long long)r * nseg;
  double acc0 = 0.0, acc1 = 0.0;     // segments lane and lane + 32
  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    const int n = min(kChunk, hi - c0);
    const float* src = row + c0;
    __syncwarp();                    // the previous chunk is consumed
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int n4 = n / 4;
#pragma unroll 4
      for (int i = lane; i < n4; i += 32)
        reinterpret_cast<float4*>(buf)[i] = reinterpret_cast<const float4*>(src)[i];
      for (int i = 4 * n4 + lane; i < n; i += 32) buf[i] = src[i];
    } else {
#pragma unroll 8
      for (int i = lane; i < n; i += 32) buf[i] = src[i];
    }
    __syncwarp();
    if (lane < nseg)
      acc0 = add_range(buf, c0, n, segs.start[lane], segs.end[lane], acc0);
    if (lane + 32 < nseg)
      acc1 = add_range(buf, c0, n, segs.start[lane + 32], segs.end[lane + 32],
                       acc1);
  }
  if (lane < nseg) dst[lane] = (float)acc0;
  if (lane + 32 < nseg) dst[lane + 32] = (float)acc1;
}

}  // namespace

// x: f32[rows, len], out: f32[rows, nseg], both contiguous; bounds: host
// int32[2 * nseg], the starts then the ends, with 0 <= start <= end <= len
// (an empty segment sums to 0). Returns cudaGetLastError() after the launch.
extern "C" int tac_segment_sum(const float* x, float* out, int rows, int len,
                               int nseg, const int* bounds, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0 || len < 0 || nseg < 1 || nseg > kMaxSegs)
    return (int)cudaErrorInvalidValue;
  Segs segs;
  int lo = len, hi = 0;
  for (int s = 0; s < nseg; ++s) {
    segs.start[s] = bounds[s];
    segs.end[s] = bounds[nseg + s];
    if (segs.start[s] < 0 || segs.start[s] > segs.end[s] || segs.end[s] > len)
      return (int)cudaErrorInvalidValue;
    if (segs.start[s] < segs.end[s]) {
      lo = segs.start[s] < lo ? segs.start[s] : lo;
      hi = segs.end[s] > hi ? segs.end[s] : hi;
    }
  }
  if (hi <= lo) lo = hi = 0;         // every segment empty: no chunk to stage
  if (rows == 0) return 0;
  segment_sum_kernel<<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, out, rows, len, nseg,
                                                            lo, hi, segs);
  return (int)cudaGetLastError();
}
