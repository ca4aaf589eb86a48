// The greedy water-fill decision chain of SPEC.md §6 for one row of bands
// held by one warp: shared by kernel K1 (water_fill.cu, one row per warp)
// and kernel K3 (vbr_scan.cu, one reservoir lane per warp, a row per frame),
// so there is one chain and both kernels give tac's integers.
//
// Layout: band b lives on lane b % 32, slot b / 32 (Slots slots, a template
// parameter: 1 for B <= 32, 2 for B <= 64, 4 for B <= 128). All row state
// stays in registers.
//
// One step of the grant loop is short: the arg-max of need over the warp is
// one __reduce_max_sync over an order-preserving unsigned key of need (0 for
// ineligible bands), the lowest band holding it one __ballot_sync + __ffs,
// the runner-up a second reduce; the multi-grant count is one ballot. DEC[a]
// for a band's own alloc a comes from a register by shuffle (lane m holds
// DEC[m]): no divergent __constant__ reads.
//
// Exactness: need = smr - DEC[alloc] with DEC the float32 table the host
// fills once per device with float32(6.02 * k) (set_dec_table); every file
// that includes this header is compiled with -fmad=false, so no multiply-add
// is ever contracted. IEEE comparisons and the -inf / 1e30 sentinels are
// kept (never build with --use_fast_math). The keys order floats as IEEE
// comparisons do (-0 is folded into +0 first, so those two still tie and the
// lower band wins). Padded bands (b >= nb) carry smr = -inf and n_lines = 0
// and are inert.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace tac_wf {

constexpr int kMantMax = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInvStep = 1.0f / 6.02f;  // the warm start's count estimate

// One copy per shared library that includes this header.
static __constant__ float c_dec[kMantMax + 1];

// Fills the decrement table on `device`: dec_host holds 17 float32 values
// DEC[k] = 6.02 * k. Call once per device before the first launch there.
static inline int set_dec_table(const float* dec_host, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(c_dec, dec_host, sizeof(float) * (kMantMax + 1));
}

// Lane m's register copy of DEC[m] (lanes 16 and up hold DEC[16]).
__device__ __forceinline__ float load_dec(int lane) {
  return c_dec[lane < kMantMax ? lane : kMantMax];
}

// DEC[a] for each lane's own a in [0, 16]; all 32 lanes must call it.
__device__ __forceinline__ float dec_at(float dec, int a) {
  return __shfl_sync(kFull, dec, a);
}

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

// Order-preserving key of a float (not NaN): a > b  <=>  key(a) > key(b),
// and key(v) >= 1 for every v, so 0 can stand for "no band". -0 becomes +0.
__device__ __forceinline__ unsigned float_key(float v) {
  const unsigned u = __float_as_uint(v + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Loads one row into the warp's registers: s = smr (or -inf past nb),
// n = n_lines (or 0), valid = band exists and has lines.
template <int Slots>
__device__ __forceinline__ void load_row(const float* __restrict__ smr_row,
                                         const int* __restrict__ nl_row,
                                         int nb, int lane, float (&s)[Slots],
                                         int (&n)[Slots], bool (&valid)[Slots]) {
#pragma unroll
  for (int k = 0; k < Slots; ++k) {
    const int b = k * 32 + lane;
    const bool in = b < nb;
    s[k] = in ? smr_row[b] : -CUDART_INF_F;
    n[k] = in ? nl_row[b] : 0;
    valid[k] = in && n[k] > 0;
  }
}

// The warm start's event count of each slot: cnt = #{m in [0, max_mant) :
// fl(s - DEC[m]) > t} for a live band, 0 otherwise. fl(s - DEC[m]) does not
// rise as m rises (DEC rises, and rounding is monotone), so the events above
// t are a prefix of m and the count is the first m whose event is <= t. cnt
// comes in as an estimate, (s - t) / 6.02 rounded up and clamped, and is
// moved one step at a time until that characterization holds, tested with
// the exact IEEE compares fl(s - DEC[m]) > t, so it equals a count over all
// m (NaN, +-inf, the 1e30 sentinel and events that tie at large magnitudes
// included). The estimate is exact but near a rounding edge, so the loop
// usually checks once and stops; it is warp-uniform, as dec_at needs all
// lanes.
template <int Slots>
__device__ __forceinline__ void count_events_above(const float (&s)[Slots],
                                                   const bool (&live)[Slots],
                                                   float t, int max_mant,
                                                   float dec,
                                                   int (&cnt)[Slots]) {
  for (;;) {
    bool moved = false;
#pragma unroll
    for (int k = 0; k < Slots; ++k) {
      const float below = s[k] - dec_at(dec, max(cnt[k] - 1, 0));
      const float at = s[k] - dec_at(dec, cnt[k]);
      const bool up = live[k] && cnt[k] < max_mant && at > t;
      const bool down = live[k] && cnt[k] > 0 && !(below > t);
      cnt[k] += (int)up - (int)down;
      moved |= up || down;
    }
    if (!__any_sync(kFull, moved)) return;
  }
}

// The whole chain for one row: warm start (warm_start_tile: grant the
// prefix of the descending event order above a bisected water level,
// Rounds times with Bisect steps each; 0 rounds is a cold start) then the
// grant / lone-bit freeze loop (water_fill_tile) to the row's fixpoint. The
// final allocation is the same for any Rounds and Bisect (tac's prefix
// lemma); they set how much of the walk the loop still has to take. `rem`
// is the row's bit budget, `dec` the lane's load_dec register; the
// allocation lands in a[]. Warp-uniform control flow: all 32 lanes call it
// together.
template <int Slots, int Rounds, int Bisect>
__device__ __forceinline__ void water_fill_row(const float (&s)[Slots],
                                               const int (&n)[Slots],
                                               const bool (&valid)[Slots],
                                               int rem, int nb, int max_mant,
                                               int lane, float dec,
                                               int (&a)[Slots]) {
  const float neg = -CUDART_INF_F;
  bool frozen[Slots];
#pragma unroll
  for (int k = 0; k < Slots; ++k) {
    a[k] = 0;
    frozen[k] = false;
  }

#pragma unroll 1
  for (int round = 0; round < Rounds; ++round) {
    bool live[Slots];                          // valid & affordable
    float hi = neg, lo = 1e30f;
#pragma unroll
    for (int k = 0; k < Slots; ++k) {
      live[k] = valid[k] && n[k] <= rem;
      const float top = s[k] - dec_at(dec, a[k]);
      if (live[k] && a[k] < max_mant) {
        hi = fmaxf(hi, top);
        lo = fminf(lo, s[k] - c_dec[max_mant - 1]);
      }
    }
    hi = warp_max(hi);
    lo = warp_min(lo) - 1.0f;
#pragma unroll 1
    for (int it = 0; it <= Bisect; ++it) {
      const float t = it < Bisect ? 0.5f * (lo + hi) : hi;
      int cnt[Slots];
#pragma unroll
      for (int k = 0; k < Slots; ++k)
        cnt[k] = live[k] ? min(max(__float2int_ru((s[k] - t) * kInvStep), 0),
                               max_mant)
                         : 0;
      count_events_above(s, live, t, max_mant, dec, cnt);
      int cost = 0;
      int g[Slots];
#pragma unroll
      for (int k = 0; k < Slots; ++k) {
        g[k] = max(cnt[k] - a[k], 0);
        cost += g[k] * n[k];
      }
      cost = warp_sum(cost);
      if (it == Bisect) {                      // grant at the final level
#pragma unroll
        for (int k = 0; k < Slots; ++k) a[k] += g[k];
        rem -= cost;
      } else if (cost <= rem) {
        hi = t;
      } else {
        lo = t;
      }
    }
  }

  // Each band takes at most kMantMax grants and one freeze, so a correct
  // chain ends within the cap; a row that hits it traps, which surfaces as
  // a CUDA error at the caller's next synchronization instead of hanging
  // the card or writing an allocation that would be packed into a corrupt
  // stream.
  const int cap = 32 * Slots * (kMantMax + 1) + 1;
  for (int iter = 0;; ++iter) {
    if (iter == cap) __trap();
    unsigned key[Slots];
    unsigned best = 0;
    int lone_b = -1;
#pragma unroll
    for (int k = 0; k < Slots; ++k) {
      const bool elig = !frozen[k] && a[k] < max_mant && valid[k] && n[k] <= rem;
      const float need = s[k] - dec_at(dec, a[k]);
      key[k] = elig ? float_key(need) : 0u;
      best = max(best, key[k]);
      if (a[k] == 1 && !frozen[k] && k * 32 + lane < nb) lone_b = k * 32 + lane;
    }
    const unsigned top = __reduce_max_sync(kFull, best);
    const int hisel = __reduce_max_sync(kFull, lone_b);
    if (top == 0 && hisel < 0) return;         // fixpoint

    if (top != 0) {
      // the lowest band holding the top key: lowest slot, then lowest lane
      int kb = 0, owner = 0;
      bool found = false;
#pragma unroll
      for (int k = 0; k < Slots; ++k) {
        const unsigned hit = __ballot_sync(kFull, key[k] == top);
        if (!found && hit) {
          found = true;
          kb = k;
          owner = __ffs(hit) - 1;
        }
      }
      // runner-up need over the eligible bands but the chosen one
      unsigned second = 0;
      float sb = 0.0f;
      int nbsel = 0, ab = 0;
#pragma unroll
      for (int k = 0; k < Slots; ++k) {
        const bool chosen = k == kb && lane == owner;
        second = max(second, chosen ? 0u : key[k]);
        if (k == kb) { sb = s[k]; nbsel = n[k]; ab = a[k]; }
      }
      second = __reduce_max_sync(kFull, second);
      const float need2 = second ? key_float(second) : neg;
      sb = __shfl_sync(kFull, sb, owner);
      nbsel = max(__shfl_sync(kFull, nbsel, owner), 1);
      ab = __shfl_sync(kFull, ab, owner);
      // multi-grant: k = min(#{m in [ab, max_mant) : sb - DEC[m] > need2},
      // rem / n), at least 1. Each condition holds on a prefix of m >= ab
      // (DEC rises with m), so one ballot over m = lane counts them all.
      const bool take = lane >= ab && lane < max_mant && (sb - dec) > need2 &&
                        (lane - ab + 1) * nbsel <= rem;
      const int kk = max(__popc(__ballot_sync(kFull, take)), 1);
      if (lane == owner) {
#pragma unroll
        for (int k = 0; k < Slots; ++k)
          if (k == kb) a[k] += kk;
      }
      rem -= kk * nbsel;
    } else {
      // freeze: the highest band holding a lone bit gives it back for good
      int nf = 0;
#pragma unroll
      for (int k = 0; k < Slots; ++k)
        if (k == (hisel >> 5) && lane == (hisel & 31)) {
          nf = n[k];
          a[k] = 0;
          frozen[k] = true;
        }
      rem += __shfl_sync(kFull, nf, hisel & 31);
    }
  }
}

}  // namespace tac_wf
