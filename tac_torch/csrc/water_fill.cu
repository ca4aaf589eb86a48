// Kernel K1: greedy water-fill bit allocation, one warp per row.
//
// Replaces tac/ops/pallas_alloc.py:water_fill_rows (warm=True): the Pallas
// body _kernel = warm_start_tile (water-level bisection, 2 rounds x 20
// steps there; here the setting tac_torch/_build.py:WARM_START gives) +
// water_fill_tile (grant / lone-bit freeze loop to a fixpoint).
// The decision chain is SPEC.md §6 and must equal tac's integer for integer;
// it lives in water_fill.cuh (shared with kernel K3), and the plain PyTorch
// mirror is tac_torch/ops/alloc.py:water_fill_rows_plain.
//
// What bounds it on an H100: not bytes (a row reads B floats + B ints and
// writes B ints: ~4 MB for the flagship's 20 704 rows x 25 bands, about a
// microsecond at 3.35 TB/s) but instructions: a warp per row gives ~157
// warps an SM, each a data-dependent serial chain of warm-start bisection
// steps and ~16 loop trips, each ending in warp-wide reductions, so the
// schedulers' issue rate sets the time. The design keeps the whole chain
// in registers (water_fill.cuh); each warp leaves its loop as soon as its
// own row converges (the TPU kernel looped to the batch max). A bisection
// step counts each band's events above the level by an estimate and a
// one-step check instead of 16 compares, and the warm start is the
// fastest setting measured on the card among 2 x 20 (tac's), 1 x 12, 1 x 8
// and a cold start (PERF.md §6); the allocation is the same at any. The
// band slots per lane are a template parameter (one slot at 25 bands).
//
// Compiled with -fmad=false (see water_fill.cuh on exactness).

#include "water_fill.cuh"

#if !defined(TAC_WARM_ROUNDS) || !defined(TAC_WARM_BISECT)
#error "set the warm start with -DTAC_WARM_ROUNDS/-DTAC_WARM_BISECT (_build.py)"
#endif

namespace {

using namespace tac_wf;

constexpr int kRowsPerBlock = 4;   // warps per block
constexpr int kRounds = TAC_WARM_ROUNDS;  // warm start: rounds x bisection
constexpr int kBisect = TAC_WARM_BISECT;  // steps, from _build.WARM_START

template <int Slots>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
water_fill_kernel(const float* __restrict__ smr, const int* __restrict__ nl,
                  const int* __restrict__ rem0, int* __restrict__ out,
                  int rows, int nb, int nl_stride, int max_mant) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;                     // warp-uniform exit

  const float dec = load_dec(lane);
  float s[Slots];
  int n[Slots], a[Slots];
  bool valid[Slots];
  load_row<Slots>(smr + (size_t)row * nb, nl + (size_t)row * nl_stride, nb,
                  lane, s, n, valid);
  water_fill_row<Slots, kRounds, kBisect>(s, n, valid, rem0[row], nb, max_mant,
                                          lane, dec, a);

#pragma unroll
  for (int k = 0; k < Slots; ++k) {
    const int b = k * 32 + lane;
    if (b < nb) out[(size_t)row * nb + b] = a[k];
  }
}

}  // namespace

// Fills the decrement table on `device` (17 float32 values DEC[k] = 6.02 k).
extern "C" int tac_water_fill_set_dec(const float* dec_host, int device) {
  return tac_wf::set_dec_table(dec_host, device);
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
  if (nb < 1 || nb > 128 || max_mant < 1 || max_mant > kMantMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  auto kernel = nb <= 32 ? water_fill_kernel<1>
              : nb <= 64 ? water_fill_kernel<2> : water_fill_kernel<4>;
  kernel<<<blocks, 32 * kRowsPerBlock, 0, st>>>(smr, nl, rem0, out, rows, nb,
                                                nl_stride, max_mant);
  return (int)cudaGetLastError();
}
