// Kernel K6: a row-invariant f32 matrix product, C = A @ B.
//
// A kernel of the port with no TPU counterpart: it replaces the library
// sgemm in the fast encoders' products, which tac leaves to XLA as plain
// jnp.dot (tac/codec.py:153, the window-fused MDCT; tac/psy.py:293, the
// hann-fused DFT; tac/blockswitch.py:165 and :177, the long and short
// MDCTs). cuBLAS picks another tiling, and so another reduction order, for
// every batch shape, so a row's lines depended on the rows beside it; at a
// 1/16-dB grid tie that moved a clip's bytes with its batch, its stream
// push size or its rank. Here every C[i, j] is one chain of fused
// multiply-adds in k order,
//
//     acc = 0; for k = 0 .. K-1: acc = fma(A[i, k], B[k, j], acc),
//
// on the CUDA cores: no split-K, no atomics, one code path for every M, so
// a row's result is a function of that row and B alone, whatever M is and
// wherever the row sits. The tile changes who computes an output, never
// its arithmetic, so every tile gives the same bits. The plain PyTorch
// version is tac_torch/ops/row_gemm.py:row_matmul_plain (one library call
// per row, in another but equally fixed order; the two agree within
// K * 2^-23 * sum|a||b|).
//
// Why not the tensor cores: a split-TF32 wgmma route (K5's, fed by TMA,
// each 32-deep stage's partial promoted into an f32 accumulator) was built
// and was row-invariant on an H100, with a smaller error against an f64
// product than this chain's, but it moved the fast encodes of pure tones
// by up to 0.17 dB against parity (chip_smoke.py's 0.1 dB gate under the
// line psy model; PERF.md §6). This chain's sums are the ones that
// gate was set on.
//
// What bounds it on an H100: operations. The flagship MDCT is 20 704 x 2 048
// x 1 024 fused multiply-adds, 86.8 GFLOP, 1.30 ms at 67 TFLOP/s of f32;
// its bytes (A once, B once, C once: 256 MB) take 76 us.
//
// Design (Hopper, CUDA cores): the register-blocked sgemm. A block computes
// a BM x BN tile of C, each thread TM x TN outputs (split in halves of 4
// rows and of 4 columns, so that a warp's shared-memory reads are
// conflict-free float4s). A and B pass through shared memory in k-slices
// of BK = 16, double-buffered with one barrier a slice: B's rows by
// cp.async straight into shared memory (16-byte copies, zero-filled past
// K or N), A's rows through registers, transposed on the way so that a
// thread reads its rows as float4s; the next slice is in flight while the
// current one is used. The tile is chosen by N alone (never by M) so that
// a 2 048-row launch (the codec's chunk) has 128 blocks at every product
// shape of the presets: 128 x 128 from N = 1 024, 128 x 64 at 512, 64 x 64
// at 256, 64 x 32 at 128, 32 x 32 below.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The index of a thread's i-th row (or column) in a tile of `extent`: T
// of them in groups of 4, the groups extent / (T / 4) apart.
template <int T, int EXTENT>
__device__ __forceinline__ int spread(int t, int i) {
  return (i / 4) * (EXTENT / (T / 4)) + t * 4 + i % 4;
}

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
row_gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ c, int m, int n, int k, int col_tiles) {
  constexpr int TX = BN / TN, THREADS = (BM / TM) * TX;
  constexpr int LA = BM * BK / 4 / THREADS;      // A float4s a thread a slice
  constexpr int LB = BK * BN / 4 / THREADS;      // B float4s a thread a slice
  static_assert(LA * THREADS * 4 == BM * BK && LB * THREADS * 4 == BK * BN,
                "the tile's slices split evenly over the threads");
  __shared__ __align__(16) float sa[2][BK][BM];  // A slice, transposed
  __shared__ __align__(16) float sb[2][BK][BN];
  const int tid = threadIdx.x;
  const int n0 = (blockIdx.x % col_tiles) * BN;
  const int m0 = (blockIdx.x / col_tiles) * BM;
  const int tx = tid % TX, ty = tid / TX;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ra[LA];
  // A: float4 f of a slice is row f / (BK/4), k quad f % (BK/4)
  auto load_a = [&](int k0) {
#pragma unroll
    for (int q = 0; q < LA; ++q) {
      const int f = tid + q * THREADS;
      const int row = m0 + f / (BK / 4), kk = k0 + (f % (BK / 4)) * 4;
      ra[q] = (row < m && kk < k)
                  ? *reinterpret_cast<const float4*>(a + (size_t)row * k + kk) : zero;
    }
  };
  auto store_a = [&](int buf) {
#pragma unroll
    for (int q = 0; q < LA; ++q) {
      const int f = tid + q * THREADS;
      const int row = f / (BK / 4), kk = (f % (BK / 4)) * 4;
      sa[buf][kk + 0][row] = ra[q].x;
      sa[buf][kk + 1][row] = ra[q].y;
      sa[buf][kk + 2][row] = ra[q].z;
      sa[buf][kk + 3][row] = ra[q].w;
    }
  };
  // B: float4 f of a slice is k row f / (BN/4), column quad f % (BN/4)
  auto copy_b = [&](int buf, int k0) {
#pragma unroll
    for (int q = 0; q < LB; ++q) {
      const int f = tid + q * THREADS;
      const int kr = f / (BN / 4), col = (f % (BN / 4)) * 4;
      const bool ok = k0 + kr < k && n0 + col < n;        // n % 4 == 0
      cp_async16(&sb[buf][kr][col],
                 ok ? b + (size_t)(k0 + kr) * n + n0 + col : b, ok);
    }
    cp_async_commit();
  };

  const int slices = (k + BK - 1) / BK;
  copy_b(0, 0);
  load_a(0);
  store_a(0);
  cp_async_wait_all();
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    if (s + 1 < slices) {                        // the next slice in flight
      copy_b(cur ^ 1, (s + 1) * BK);
      load_a((s + 1) * BK);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {            // k in order, always
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(&sa[cur][kk][spread<TM, BM>(ty, i)]);
        av[i] = v.x; av[i + 1] = v.y; av[i + 2] = v.z; av[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(&sb[cur][kk][spread<TN, BN>(tx, j)]);
        bv[j] = v.x; bv[j + 1] = v.y; bv[j + 2] = v.z; bv[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    if (s + 1 < slices) {
      store_a(cur ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + spread<TM, BM>(ty, i);
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int col = n0 + spread<TN, BN>(tx, j);
      if (col < n)
        *reinterpret_cast<float4*>(c + (size_t)row * n + col) =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
    }
  }
}

template <int BM, int BN, int TM, int TN>
int launch(const float* a, const float* b, float* c, int m, int n, int k,
           cudaStream_t st) {
  const long long tiles = (long long)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  row_gemm_kernel<BM, BN, TM, TN><<<(unsigned)tiles, (BM / TM) * (BN / TN), 0, st>>>(
      a, b, c, m, n, k, (n + BN - 1) / BN);
  return (int)cudaGetLastError();
}

}  // namespace

// The output tile of a product with n columns, BM x BN, encoded as
// BM * 1000 + BN: a function of (k, n) only, never of m.
extern "C" int tac_row_gemm_tile(int k, int n) {
  (void)k;
  if (n >= 1024) return 128 * 1000 + 128;
  if (n >= 512) return 128 * 1000 + 64;
  if (n >= 256) return 64 * 1000 + 64;
  if (n >= 128) return 64 * 1000 + 32;
  return 32 * 1000 + 32;
}

// a: f32[m, k], b: f32[k, n], c: f32[m, n], all contiguous, 16-byte
// aligned, with k % 4 == 0 and n % 4 == 0. Returns cudaGetLastError()
// after the launch.
extern "C" int tac_row_gemm(const float* a, const float* b, float* c, int m,
                            int n, int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m < 0 || n < 1 || k < 1 || n % 4 || k % 4) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tac_row_gemm_tile(k, n)) {
    case 128 * 1000 + 128: return launch<128, 128, 8, 8>(a, b, c, m, n, k, st);
    case 128 * 1000 + 64: return launch<128, 64, 8, 4>(a, b, c, m, n, k, st);
    case 64 * 1000 + 64: return launch<64, 64, 4, 4>(a, b, c, m, n, k, st);
    case 64 * 1000 + 32: return launch<64, 32, 4, 4>(a, b, c, m, n, k, st);
    default: return launch<32, 32, 4, 4>(a, b, c, m, n, k, st);
  }
}
