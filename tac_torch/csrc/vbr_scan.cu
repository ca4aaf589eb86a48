// Kernel K3: the whole VBR bit-reservoir chain, one warp per reservoir lane.
//
// Replaces tac/ops/pallas_vbr_scan.py:vbr_reservoir_scan (_scan_kernel).
// Per lane (a channel of a clip, or a channel pair with 2B bands), for
// frame f = 0..F-1 with the reservoir fill `res` carried in a register
// (SPEC.md §8):
//   budget = base + res
//   alloc  = water-fill of smr[f, lane] under budget   (water_fill.cuh: the
//            decision chain of kernel K1, SPEC.md §6)
//   raw    = sum_b alloc_b * n_lines_b
//   huf_s  = sum_b (alloc_b in [2, 8] ? bits_huf[f, lane, b, 7 s + alloc_b - 2]
//                                     : alloc_b * n_lines_b)     per set s
//   best   = min_s huf_s, the FIRST minimum (strict <: ties go raw <= set 1
//            <= set 2 <= set 3);  tid = best < raw ? argfirstmin + 1 : 0
//   used   = min(raw, best);  res = clamp(res + base - used, 0, cap)
// The plain PyTorch mirror is tac_torch/ops/vbr_scan.py:
// vbr_reservoir_scan_plain.
//
// The TPU kernel's grid over frames, VMEM scratch, frames-per-step batching
// and straight-line loop prefix were that machine's loop-sync economics and
// are decision-exact at any setting; here the frame loop runs inside the
// kernel and the water-fill is K1's (2 x 20 warm start, plain loop).
//
// What bounds it on an H100: latency. The bytes are small (~33 MB at the
// 16-clip run's F = 647, L = 32, B = 25, S = 2: ~10 us at 3.35 TB/s), but
// each lane is F dependent water-fills, and only L warps exist. One warp
// per block spreads the lanes over as many SMs as there are lanes, so each
// chain runs with an SM's schedulers to itself; bands sit on the warp's
// lanes and all state (row, reservoir) stays in registers.
//
// Compiled with -fmad=false (see water_fill.cuh on exactness).

#include "water_fill.cuh"

namespace {

using namespace tac_wf;

constexpr int kMaxSets = 3;        // tableId is 2 bits: raw + three sets
constexpr int kTab = 7;            // codable sizes m = 2..8

__global__ void __launch_bounds__(32)
vbr_scan_kernel(const float* __restrict__ smr, const int* __restrict__ bh,
                const int* __restrict__ nl, const int* __restrict__ res0,
                int* __restrict__ alloc, int* __restrict__ tid,
                int* __restrict__ used, int* __restrict__ res_out, int frames,
                int lanes, int nb, int n_sets, int nl_per_frame, int base,
                int cap, int max_mant) {
  const int lane = threadIdx.x;
  const int ln = blockIdx.x;                   // reservoir lane of this warp
  if (ln >= lanes) return;

  float s[kSlots];
  int n[kSlots], a[kSlots];
  bool valid[kSlots];
  int res = res0[ln];
  const int ncol = kTab * n_sets;

  for (int f = 0; f < frames; ++f) {
    const size_t row = (size_t)f * lanes + ln;
    load_row(smr + row * nb, nl_per_frame ? nl + row * nb : nl, nb, lane, s, n,
             valid);
    water_fill_row(s, n, valid, base + res, nb, max_mant, lane, a);

    int raw = 0;
    int huf[kMaxSets] = {0, 0, 0};
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int b = k * 32 + lane;
      const int raw_b = a[k] * n[k];
      raw += raw_b;
      const bool codable = a[k] >= 2 && a[k] <= 8;   // only real bands hold bits
      const int* cell = bh + (row * nb + (b < nb ? b : 0)) * ncol + a[k] - 2;
#pragma unroll
      for (int si = 0; si < kMaxSets; ++si)
        if (si < n_sets) huf[si] += codable ? cell[kTab * si] : raw_b;
      if (b < nb) alloc[row * nb + b] = a[k];
    }
    raw = warp_sum(raw);
    int best = warp_sum(huf[0]);
    int tid_h = 1;
#pragma unroll
    for (int si = 1; si < kMaxSets; ++si)
      if (si < n_sets) {
        const int h = warp_sum(huf[si]);
        if (h < best) { best = h; tid_h = si + 1; }
      }
    const int used_f = min(raw, best);
    res = min(max(res + base - used_f, 0), cap);
    if (lane == 0) {
      tid[row] = best < raw ? tid_h : 0;
      used[row] = used_f;
      res_out[row] = res;
    }
  }
}

}  // namespace

// Fills the decrement table on `device` (17 float32 values DEC[k] = 6.02 k).
extern "C" int tac_vbr_scan_set_dec(const float* dec_host, int device) {
  return tac_wf::set_dec_table(dec_host, device);
}

// smr f32[frames, lanes, nb]; bh i32[frames, lanes, nb, 7 * n_sets];
// nl i32[nb] (nl_per_frame 0) or i32[frames, lanes, nb] (nl_per_frame 1);
// res0 i32[lanes]; alloc i32[frames, lanes, nb]; tid, used, res_out
// i32[frames, lanes]. Returns cudaGetLastError() after the launch.
extern "C" int tac_vbr_reservoir_scan(const float* smr, const int* bh,
                                      const int* nl, const int* res0, int* alloc,
                                      int* tid, int* used, int* res_out,
                                      int frames, int lanes, int nb, int n_sets,
                                      int nl_per_frame, int base, int cap,
                                      int max_mant, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb < 1 || nb > 32 * kSlots || max_mant < 1 || max_mant > kMantMax ||
      n_sets < 1 || n_sets > kMaxSets || frames < 1 || lanes < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  vbr_scan_kernel<<<lanes, 32, 0, st>>>(smr, bh, nl, res0, alloc, tid, used,
                                        res_out, frames, lanes, nb, n_sets,
                                        nl_per_frame, base, cap, max_mant);
  return (int)cudaGetLastError();
}
