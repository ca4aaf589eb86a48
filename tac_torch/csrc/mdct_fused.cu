// Kernel K5: fused 50 %-overlap framing + window-fused MDCT product.
//
// Replaces tac/ops/pallas_mdct.py:mdct_frames_pallas (_mdct_kernel):
//   out[c, f, :] = xp[c, f*h : f*h + 2h] @ basis        basis f32 [2h, h]
// with xp the signal padded as frame_signal pads it (h zeros in front, to
// (F+1)*h samples a channel). The plain PyTorch mirror is
// tac_torch/ops/mdct_fused.py:mdct_frames_plain.
//
// The frame matrix is never built. Over r = c*(F+1) + f the padded signal
// of all channels is one matrix Xh [C*(F+1), h] of non-overlapping rows,
// and frame row r is [Xh[r], Xh[r+1]]: ONE 2-D TMA tensor map over Xh
// feeds the whole K loop (k < h reads the box at row r0, k >= h the box at
// row r0 + 1), and TMA's out-of-bounds zero fill covers the ragged edges.
// Row f = F of a channel straddles two channels: it is computed like any
// other and not stored. The TPU kernel's 8-frame tiles, its pair of aligned
// DMAs and its extra padding answered Mosaic's sublane rule and have no
// counterpart here.
//
// What bounds it on an H100: operations (2*R*2h*h flops against
// 4*(R*h + 2h*h + R*h) bytes, ~680 flops a byte at h = 1024). The CUDA
// cores' f32 peak (67 TFLOP/s) caps any full-f32 design at 1.30 ms on the
// 16-clip run; the tensor cores run TF32 at 495 TFLOP/s. This kernel keeps
// full f32 accuracy on the tensor cores with the 3xTF32 split: every
// operand v is big = cvt.rna.tf32(v) plus small = v - big (exact in f32),
// and each product is a_small*b_big + a_big*b_small + a_big*b_big, the
// smallest terms first. What the split drops, a_small * b_small and the
// rounding of the small parts, is about 2^-20 of a product at worst; over
// 2h terms of mixed sign that is ~2e-7 of the largest line. The tensor
// core's own f32 accumulation is shorter than IEEE f32 (measured on an
// H100: 1.5e-5 of the largest line over 2048 terms, 3x the 5e-6 gate), so
// each 32-sample stage's products go into a fresh partial that is added
// into an f32 accumulator on the CUDA cores (measured: 2e-6, err / tol
// 0.41). One TF32 pass would miss the gate (~1e-4). Bound: 3 x 86.8 GFLOP
// at 495 TFLOP/s = 0.53 ms on the 16-clip run.
//
// Design (Hopper): a pre-pass (split_pad_kernel) pads the signal and
// writes Xh_big and Xh_small in one elementwise pass; the wrapper splits the
// basis once per call, transposed to K-major [2][h][h] (TF32 wgmma takes A
// and B from shared memory K-major only). The main kernel gives each block a
// 128-row x 128-line output tile: one producer thread keeps TMA loads of
// the four operand tiles (A big / small, B big / small, 32 samples deep: one
// 128-byte swizzled row each) in flight over a ring of kStages
// shared-memory stages on full / empty mbarriers, and two consumer
// warpgroups (64 rows each) run wgmma.mma_async m64n128k8 tf32, three per
// 8-sample step, wait for a stage's products, release the stage and
// promote the partial; the two warpgroups keep the tensor core busy in
// turn. Column tiles run fastest over the (flat) grid, so the blocks in
// flight share their row tiles of Xh through L2 and the 16 MB split basis
// stays in L2.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;            // frame rows per block (2 warpgroups x 64)
constexpr int BN = 128;            // MDCT lines per block
constexpr int BK = 32;             // samples per stage: one 128-byte row
constexpr int kStages = 3;
constexpr int kThreads = 384;      // producer warpgroup + 2 consumer warpgroups
constexpr int kTile = BM * BK * 4; // bytes of one operand tile (BN == BM)
constexpr int kStageBytes = 4 * kTile;
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;

// ---- PTX helpers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile whose rows are 128 bytes,
// written by TMA with the 128-byte swizzle: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);   // start address
  d |= (uint64_t)1 << 16;                           // leading byte offset (unused)
  d |= (uint64_t)(1024 >> 4) << 32;                 // stride byte offset
  d |= (uint64_t)1 << 62;                           // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma launch / wait points.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 8] * B[8 x 128]^T, tf32 operands from shared
// memory; Accumulate = 0 overwrites d (scale-d false).
template <int Accumulate>
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(Accumulate));
}

__device__ __forceinline__ float tf32_big(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(v));
  return __uint_as_float(u);
}

// ---- the pre-pass: pad + split -------------------------------------------

// xh_big / xh_small [C * (F+1) * h]: element j of channel c is sample
// j - h of x[c] (zero outside [0, T)), split into its TF32 part and the
// exact f32 remainder. Four elements a thread ((F+1)*h is a multiple of 4).
__global__ void __launch_bounds__(256)
split_pad_kernel(const float* __restrict__ x, float* __restrict__ xh_big,
                 float* __restrict__ xh_small, long long total, long long t_len,
                 long long row_len, int h) {
  const long long e0 = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (e0 >= total) return;
  // row_len is a multiple of 4: the four elements share one channel
  const long long c = e0 / row_len;
  const long long t0 = e0 - c * row_len - h;
  float big[4], small[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long t = t0 + i;
    const float v = (t >= 0 && t < t_len) ? x[c * t_len + t] : 0.0f;
    big[i] = tf32_big(v);
    small[i] = v - big[i];
  }
  *reinterpret_cast<float4*>(xh_big + e0) = make_float4(big[0], big[1], big[2], big[3]);
  *reinterpret_cast<float4*>(xh_small + e0) =
      make_float4(small[0], small[1], small[2], small[3]);
}

// ---- the main kernel ---------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
mdct_wgmma_kernel(const __grid_constant__ CUtensorMap xa_big,
                  const __grid_constant__ CUtensorMap xa_small,
                  const __grid_constant__ CUtensorMap bt_big,
                  const __grid_constant__ CUtensorMap bt_small,
                  float* __restrict__ out, int rows, int frames, int h,
                  int col_tiles) {
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle and the wgmma descriptors need 1024-byte aligned
  // tiles
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int col0 = (blockIdx.x % col_tiles) * BN;
  const int row0 = (blockIdx.x / col_tiles) * BM;
  const int nkh = (h + BK - 1) / BK;           // K blocks per half
  const int nk = 2 * nkh;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);                  // one arrival per consumer group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % kStages;
        mbar_wait(empty(s), ((kb / kStages) & 1) ^ 1);
        const uint32_t st = base + s * kStageBytes;
        mbar_expect_tx(full(s), kStageBytes);
        const int half = kb / nkh, k0 = (kb - half * nkh) * BK;
        tma_load_2d(st, &xa_big, full(s), k0, row0 + half);
        tma_load_2d(st + kTile, &xa_small, full(s), k0, row0 + half);
        tma_load_3d(st + 2 * kTile, &bt_big, full(s), k0, col0, half);
        tma_load_3d(st + 3 * kTile, &bt_small, full(s), k0, col0, half);
      }
    }
    return;
  }

  // consumers: warpgroup wg - 1 owns rows [64 (wg - 1), 64 wg) of the tile;
  // each stage's 12 products go into a fresh partial p, then into the
  // CUDA-core f32 accumulator d (64 adds a thread per 32 samples)
  float d[64], p[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = p[i] = 0.0f;
  const uint32_t a_off = (wg - 1) * 64 * BK * 4;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % kStages;
    mbar_wait(full(s), (kb / kStages) & 1);
    const uint32_t st = base + s * kStageBytes;
    wgmma_fence();
    fence_acc(p);
#pragma unroll
    for (int k8 = 0; k8 < BK / 8; ++k8) {
      const uint32_t ko = k8 * 32;             // 8 tf32 = 32 bytes
      const uint64_t a_b = wgmma_desc(st + a_off + ko);
      const uint64_t a_s = wgmma_desc(st + kTile + a_off + ko);
      const uint64_t b_b = wgmma_desc(st + 2 * kTile + ko);
      const uint64_t b_s = wgmma_desc(st + 3 * kTile + ko);
      if (k8 == 0)
        wgmma_tf32<0>(p, a_s, b_b);
      else
        wgmma_tf32<1>(p, a_s, b_b);
      wgmma_tf32<1>(p, a_b, b_s);
      wgmma_tf32<1>(p, a_b, b_b);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(p);
    if (threadIdx.x % 128 == 0) mbar_arrive(empty(s));
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] += p[i];
  }

  // store: accumulator d[4j + 2i + c] is row 16 w + l/4 + 8i, line
  // 8j + 2 (l % 4) + c of the warpgroup's 64 x 128 block; row
  // r = c*(F+1) + f goes to out[c, f, :], f == F is dropped
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + (wg - 1) * 64 + 16 * w + l / 4 + 8 * i;
    if (r >= rows) continue;
    const int c = r / (frames + 1);
    const int f = r - c * (frames + 1);
    if (f == frames) continue;
    float* dst = out + ((long long)c * frames + f) * h;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j + 2 * (l % 4);
      if (col < h)                             // h % 4 == 0: col + 1 < h too
        *reinterpret_cast<float2*>(dst + col) =
            make_float2(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
    }
  }
}

// ---- host side -----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not the runtime: its entry point
// is fetched through the runtime, so that the library needs no link
// against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                       12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over a row-major f32 tensor with `rank` dims (dims innermost first,
// strides in bytes of dims 1..rank-1) and a box of 32 samples x 128 rows
// (x 1), swizzled for wgmma.
bool make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint32_t box[3] = {BK, BM, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x: f32[channels, t_len] signal; xh_big, xh_small: f32[channels * (frames+1)
// * h] scratch (the padded, split signal); bt_big, bt_small: f32[2, h, h],
// the split basis with bt[half, n, k] = basis[half * h + k, n]; out:
// f32[channels, frames, h]. h must be a multiple of 4. All pointers 16-byte
// aligned. Returns cudaGetLastError() after the launches (or
// cudaErrorInvalidValue when an argument or a tensor map is refused).
extern "C" int tac_mdct_frames_fused(const float* x, float* xh_big, float* xh_small,
                                     const float* bt_big, const float* bt_small,
                                     float* out, int channels, long long t_len,
                                     int frames, int h, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (channels < 1 || frames < 1 || t_len < 1 || h < 4 || h % 4)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)channels * (frames + 1);
  const long long row_len = (long long)(frames + 1) * h;
  const long long total = rows * h;
  if (rows > 2147483647LL - BM) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const long long quads = total / 4;
  split_pad_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, st>>>(
      x, xh_big, xh_small, total, t_len, row_len, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap maps[4];
  const cuuint64_t xdims[2] = {(cuuint64_t)h, (cuuint64_t)rows};
  const cuuint64_t xstride[1] = {(cuuint64_t)h * 4};
  const cuuint64_t bdims[3] = {(cuuint64_t)h, (cuuint64_t)h, 2};
  const cuuint64_t bstride[2] = {(cuuint64_t)h * 4, (cuuint64_t)h * h * 4};
  if (!make_map(&maps[0], xh_big, 2, xdims, xstride) ||
      !make_map(&maps[1], xh_small, 2, xdims, xstride) ||
      !make_map(&maps[2], bt_big, 3, bdims, bstride) ||
      !make_map(&maps[3], bt_small, 3, bdims, bstride))
    return (int)cudaErrorInvalidValue;

  err = cudaFuncSetAttribute(mdct_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const long long row_tiles = (rows + BM - 1) / BM;
  const int col_tiles = (h + BN - 1) / BN;
  if (row_tiles * col_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  mdct_wgmma_kernel<<<(unsigned)(row_tiles * col_tiles), kThreads, kSmemBytes, st>>>(
      maps[0], maps[1], maps[2], maps[3], out, (int)rows, frames, h, col_tiles);
  return (int)cudaGetLastError();
}
