// Kernel K1: greedy water-fill bit allocation, one warp per row.
//
// Replaces tac/ops/pallas_alloc.py:water_fill_rows (warm=True): the Pallas
// body _kernel = warm_start_tile (water-level bisection, 2 rounds x 20
// steps) + water_fill_tile (grant / lone-bit freeze loop to a fixpoint).
// The decision chain is SPEC.md §6 and must equal tac's integer for integer;
// the plain PyTorch mirror is tac_torch/ops/alloc.py:water_fill_rows_plain.
//
// What bounds it on an H100: neither bytes (a row reads B floats + B ints
// and writes B ints: ~4 MB for the flagship's 20 704 rows x 25 bands, about
// a microsecond at 3.35 TB/s) nor arithmetic, but latency: each row is a
// data-dependent serial chain of ~40 bisection steps and ~10-30 loop
// iterations, each ending in warp-wide reductions. The design keeps the
// whole chain in registers: band b lives on lane b % 32, slot b / 32 (four
// slots, B <= 128); every reduction is a shuffle or a warp reduce
// instruction, never shared or global memory; each warp leaves its loop as
// soon as its own row converges (the TPU kernel looped to the batch max),
// and four rows per 128-thread block keep enough warps resident to hide
// the shuffle latency.
//
// Exactness: need = smr - DEC[alloc] with DEC read from a constant table
// filled once per device with float32(6.02 * k) by the host
// (tac_water_fill_set_dec), and the file is compiled with
// -fmad=false, so no multiply-add is ever contracted. IEEE comparisons and
// the -inf / 1e30 sentinels are kept (never build with --use_fast_math).
// Padded bands (b >= nb) carry smr = -inf and n_lines = 0 and are inert.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMantMax = 16;
constexpr int kSlots = 4;          // bands per lane: B <= 32 * kSlots
constexpr int kRowsPerBlock = 4;   // warps per block
constexpr int kRounds = 2;         // warm-start rounds
constexpr int kBisect = 20;        // bisection steps per round
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;  // "no band" index: loses every tie

__constant__ float c_dec[kMantMax + 1];

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  return (int)__reduce_add_sync(kFull, (unsigned)v);
}

// (value, band) arg-max over the warp: larger value wins, equal values go
// to the lower band; "no band" (kNone) loses to any real band.
__device__ __forceinline__ void warp_argmax(float& v, int& b) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    float ov = __shfl_xor_sync(kFull, v, o);
    int ob = __shfl_xor_sync(kFull, b, o);
    if (ov > v || (ov == v && ob < b)) { v = ov; b = ob; }
  }
}

__global__ void __launch_bounds__(32 * kRowsPerBlock)
water_fill_kernel(const float* __restrict__ smr, const int* __restrict__ nl,
                  const int* __restrict__ rem0, int* __restrict__ out,
                  int rows, int nb, int nl_stride, int max_mant) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;                     // warp-uniform exit
  const int nslot = (nb + 31) >> 5;
  const float neg = -CUDART_INF_F;

  float s[kSlots];
  int n[kSlots], a[kSlots];
  bool valid[kSlots], frozen[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int b = k * 32 + lane;
    const bool in = k < nslot && b < nb;
    s[k] = in ? smr[(size_t)row * nb + b] : neg;
    n[k] = in ? nl[(size_t)row * nl_stride + b] : 0;
    valid[k] = in && n[k] > 0;
    a[k] = 0;
    frozen[k] = false;
  }
  int rem = rem0[row];

  // ---- warm start (warm_start_tile): grant the prefix of the descending
  // event order above a bisected water level, twice.
  for (int round = 0; round < kRounds; ++round) {
    bool live[kSlots];                         // valid & affordable
    float hi = neg, lo = 1e30f;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      live[k] = valid[k] && n[k] <= rem;
      if (live[k] && a[k] < max_mant) {
        hi = fmaxf(hi, s[k] - c_dec[a[k]]);
        lo = fminf(lo, s[k] - c_dec[max_mant - 1]);
      }
    }
    hi = warp_max(hi);
    lo = warp_min(lo) - 1.0f;
    for (int it = 0; it <= kBisect; ++it) {
      const float t = it < kBisect ? 0.5f * (lo + hi) : hi;
      int cost = 0;
      int g[kSlots];
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        int cnt = 0;
        if (live[k])
          for (int m = 0; m < max_mant; ++m) cnt += (s[k] - c_dec[m]) > t;
        g[k] = max(cnt - a[k], 0);
        cost += g[k] * n[k];
      }
      cost = warp_sum(cost);
      if (it == kBisect) {                     // grant at the final level
#pragma unroll
        for (int k = 0; k < kSlots; ++k) a[k] += g[k];
        rem -= cost;
      } else if (cost <= rem) {
        hi = t;
      } else {
        lo = t;
      }
    }
  }

  // ---- greedy loop (water_fill_tile) to this row's fixpoint. Each band
  // takes at most kMantMax grants and one freeze, so a correct chain ends
  // within the cap; a row that hits it traps, which surfaces as a CUDA
  // error at the caller's next synchronization instead of hanging the card
  // or writing an allocation that would be packed into a corrupt stream.
  const int cap = 32 * kSlots * (kMantMax + 1) + 1;
  for (int iter = 0;; ++iter) {
    if (iter == cap) __trap();
    float bv = neg;
    int bb = kNone;
    int lone_b = -1;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int b = k * 32 + lane;
      const bool elig = !frozen[k] && a[k] < max_mant && valid[k] && n[k] <= rem;
      if (elig) {
        const float need = s[k] - c_dec[a[k]];
        if (bb == kNone || need > bv) { bv = need; bb = b; }
      }
      if (a[k] == 1 && !frozen[k] && k < nslot && b < nb) lone_b = b;
    }
    warp_argmax(bv, bb);
    const bool any_grant = bb != kNone;
    const int hisel = __reduce_max_sync(kFull, lone_b);
    if (!any_grant && hisel < 0) break;        // fixpoint

    if (any_grant) {
      // runner-up need, and the chosen band's smr / lines / alloc
      float need2 = neg, sb = 0.0f;
      int nbsel = 0, ab = 0;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int b = k * 32 + lane;
        const bool elig = !frozen[k] && a[k] < max_mant && valid[k] && n[k] <= rem;
        if (elig && b != bb) need2 = fmaxf(need2, s[k] - c_dec[a[k]]);
        if (k == (bb >> 5)) { sb = s[k]; nbsel = n[k]; ab = a[k]; }
      }
      need2 = warp_max(need2);
      const int owner = bb & 31;
      sb = __shfl_sync(kFull, sb, owner);
      nbsel = __shfl_sync(kFull, nbsel, owner);
      ab = __shfl_sync(kFull, ab, owner);
      // multi-grant: k = #{m in [ab, max_mant) : sb - DEC[m] > need2}
      const bool ahead = lane < max_mant && lane >= ab && (sb - c_dec[lane]) > need2;
      int kk = __popc(__ballot_sync(kFull, ahead));
      kk = min(kk, max_mant - ab);
      kk = min(kk, rem / max(nbsel, 1));
      kk = max(kk, 1);
      if (lane == owner) {
#pragma unroll
        for (int k = 0; k < kSlots; ++k)
          if (k == (bb >> 5)) a[k] += kk;
      }
      rem -= kk * nbsel;
    } else {
      // freeze: the highest band holding a lone bit gives it back for good
      int nf = 0;
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
        if (k == (hisel >> 5) && lane == (hisel & 31)) {
          nf = n[k];
          a[k] = 0;
          frozen[k] = true;
        }
      rem += __shfl_sync(kFull, nf, hisel & 31);
    }
  }

#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int b = k * 32 + lane;
    if (k < nslot && b < nb) out[(size_t)row * nb + b] = a[k];
  }
}

}  // namespace

// Fills the decrement table on `device`: dec_host holds 17 float32 values
// DEC[k] = 6.02 * k. Call once per device before the first launch there.
extern "C" int tac_water_fill_set_dec(const float* dec_host, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(c_dec, dec_host, sizeof(float) * (kMantMax + 1));
}

// smr f32[rows, nb]; nl i32[nb] (nl_stride 0) or i32[rows, nb] (nl_stride
// nb); rem0 i32[rows] budgets; out i32[rows, nb]. Returns
// cudaGetLastError() after the launch.
extern "C" int tac_water_fill_rows(const float* smr, const int* nl,
                                   const int* rem0, int* out, int rows, int nb,
                                   int nl_stride, int max_mant, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb < 1 || nb > 32 * kSlots || max_mant < 1 || max_mant > kMantMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  water_fill_kernel<<<blocks, 32 * kRowsPerBlock, 0, st>>>(
      smr, nl, rem0, out, rows, nb, nl_stride, max_mant);
  return (int)cudaGetLastError();
}
