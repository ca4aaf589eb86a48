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
// kernel, the water-fill is K1's chain with tac's K3 warm start (1 round x
// 12 bisection steps, as tac/ops/pallas_vbr_scan.py runs it), and the band
// slots per lane are a template parameter (one at 25 bands).
//
// What bounds it on an H100: latency. The bytes are small (~33 MB at the
// 16-clip run's F = 647, L = 32, B = 25, S = 2: ~10 us at 3.35 TB/s), but
// each lane is F dependent water-fills, and only L warps exist. One warp
// per block spreads the lanes over as many SMs as there are lanes, so each
// chain runs with an SM's schedulers to itself; bands sit on the warp's
// lanes and the chain's state (row, reservoir) stays in registers. No load
// from device memory sits on the chain: nothing a frame reads depends on
// the reservoir, so the warp copies frame f + kDepth - 1's smr row, n_lines
// row and whole bits_huf row into a ring of kDepth shared-memory stages
// with cp.async (fire and forget) before it starts frame f, and frame f
// reads its row, and prices its allocation, from shared memory.
//
// Compiled with -fmad=false (see water_fill.cuh on exactness).

#include "water_fill.cuh"

#if !defined(TAC_WARM_ROUNDS) || !defined(TAC_WARM_BISECT)
#error "set the warm start with -DTAC_WARM_ROUNDS/-DTAC_WARM_BISECT (_build.py)"
#endif

namespace {

using namespace tac_wf;

constexpr int kMaxSets = 3;        // tableId is 2 bits: raw + three sets
constexpr int kTab = 7;            // codable sizes m = 2..8
constexpr int kDepth = 4;          // ring stages: frames in flight
constexpr int kRounds = TAC_WARM_ROUNDS;  // warm start: tac's K3 setting,
constexpr int kBisect = TAC_WARM_BISECT;  // from _build.WARM_START

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kDepth - 1 of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 1) : "memory");
}

// Words of one ring stage: smr [nb] | n_lines [nb] (per-frame only) |
// bits_huf [nb * 7 * n_sets].
__host__ __device__ __forceinline__ int stage_words(int nb, int n_sets,
                                                    int nl_per_frame) {
  return nb * (1 + (nl_per_frame ? 1 : 0) + kTab * n_sets);
}

template <int Slots>
__global__ void __launch_bounds__(32)
vbr_scan_kernel(const float* __restrict__ smr, const int* __restrict__ bh,
                const int* __restrict__ nl, const int* __restrict__ res0,
                int* __restrict__ alloc, int* __restrict__ tid,
                int* __restrict__ used, int* __restrict__ res_out, int frames,
                int lanes, int nb, int n_sets, int nl_per_frame, int base,
                int cap, int max_mant) {
  extern __shared__ int ring[];
  const int lane = threadIdx.x;
  const int ln = blockIdx.x;                   // reservoir lane of this warp
  if (ln >= lanes) return;

  const int ncol = kTab * n_sets;
  const int words = stage_words(nb, n_sets, nl_per_frame);
  const int nl_off = nb, bh_off = nb * (nl_per_frame ? 2 : 1);

  // Copies frame f's rows into its ring stage (one commit group per frame,
  // empty past the last frame, so that the group count stays in step).
  auto prefetch = [&](int f) {
    if (f < frames) {
      int* st = ring + (f % kDepth) * words;
      const size_t row = (size_t)f * lanes + ln;
      for (int i = lane; i < nb; i += 32) cp_async4(st + i, smr + row * nb + i);
      if (nl_per_frame)
        for (int i = lane; i < nb; i += 32)
          cp_async4(st + nl_off + i, nl + row * nb + i);
      const int* src = bh + row * nb * ncol;
      for (int i = lane; i < nb * ncol; i += 32) cp_async4(st + bh_off + i, src + i);
    }
    cp_async_commit();
  };

  const float dec = load_dec(lane);
  int nl_shared[Slots];                        // shared n_lines, read once
#pragma unroll
  for (int k = 0; k < Slots; ++k) {
    const int b = k * 32 + lane;
    nl_shared[k] = (!nl_per_frame && b < nb) ? nl[b] : 0;
  }
  float s[Slots];
  int n[Slots], a[Slots];
  bool valid[Slots];
  int res = res0[ln];

  for (int f = 0; f < kDepth - 1; ++f) prefetch(f);
  for (int f = 0; f < frames; ++f) {
    prefetch(f + kDepth - 1);
    cp_async_wait_ring();                      // this lane's copies of frame f
    __syncwarp();                              // ... and every other lane's
    const int* st = ring + (f % kDepth) * words;
    const float* st_smr = reinterpret_cast<const float*>(st);
    const int* st_bh = st + bh_off;
#pragma unroll
    for (int k = 0; k < Slots; ++k) {
      const int b = k * 32 + lane;
      const bool in = b < nb;
      s[k] = in ? st_smr[b] : -CUDART_INF_F;
      n[k] = nl_per_frame ? (in ? st[nl_off + b] : 0) : nl_shared[k];
      valid[k] = in && n[k] > 0;
    }
    water_fill_row<Slots, kRounds, kBisect>(s, n, valid, base + res, nb,
                                            max_mant, lane, dec, a);

    const size_t row = (size_t)f * lanes + ln;
    int raw = 0;
    int huf[kMaxSets] = {0, 0, 0};
#pragma unroll
    for (int k = 0; k < Slots; ++k) {
      const int b = k * 32 + lane;
      const int raw_b = a[k] * n[k];
      raw += raw_b;
      const bool codable = a[k] >= 2 && a[k] <= 8;   // only real bands hold bits
      const int* cell = st_bh + (b < nb ? b : 0) * ncol + (codable ? a[k] - 2 : 0);
#pragma unroll
      for (int si = 0; si < kMaxSets; ++si)
        if (si < n_sets) huf[si] += codable ? cell[kTab * si] : raw_b;
      if (b < nb) alloc[row * nb + b] = a[k];
    }
    __syncwarp();                              // stage f is free for reuse
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
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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
  if (nb < 1 || nb > 128 || max_mant < 1 || max_mant > kMantMax ||
      n_sets < 1 || n_sets > kMaxSets || frames < 1 || lanes < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // at most 4 x 128 x (2 + 21) words = 47 104 bytes: under the 48 KB that
  // needs no opt-in
  const size_t smem = sizeof(int) * kDepth * stage_words(nb, n_sets, nl_per_frame);
  auto kernel = nb <= 32 ? vbr_scan_kernel<1>
              : nb <= 64 ? vbr_scan_kernel<2> : vbr_scan_kernel<4>;
  kernel<<<lanes, 32, smem, st>>>(smr, bh, nl, res0, alloc, tid, used, res_out,
                                  frames, lanes, nb, n_sets, nl_per_frame, base,
                                  cap, max_mant);
  return (int)cudaGetLastError();
}
