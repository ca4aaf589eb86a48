// Kernel K5: fused 50 %-overlap framing + window-fused MDCT product.
//
// Replaces tac/ops/pallas_mdct.py:mdct_frames_pallas (_mdct_kernel):
//   out[c, f, :] = xp[c, f*h : f*h + 2h] @ basis        basis f32 [2h, h]
// with xp the signal padded as frame_signal pads it (h zeros in front, to
// (F+1)*h samples a channel). The plain PyTorch mirror is
// tac_torch/ops/mdct_fused.py:mdct_frames_plain.
//
// The frame matrix is never built. Frame f of channel c starts at sample
// (c*(F+1) + f) * h of the padded buffer, so over the row index
// r = c*(F+1) + f the left operand is ONE matrix with row stride h (its rows
// overlap by half) and 2h columns. Row f = F of a channel straddles two
// channels: it is computed like any other and not stored. That keeps every
// tile of 128 rows full whatever F is; the TPU kernel's 8-frame tiles, its
// pair of aligned DMAs and its extra padding answered Mosaic's sublane rule
// and have no counterpart here.
//
// What bounds it on an H100: operations. 2*R*2h*h flops against
// 4*(R*h + 2h*h + R*h) bytes is ~680 flops a byte at h = 1024, far above the
// card's f32 ridge of 20. The product runs in full f32 on the CUDA cores (an
// f32 tl.dot or wgmma would round the operands to TF32, and the codec's
// 1/16-dB SMR grid does not survive that), as a shared-memory tiled GEMM:
// a block of 256 threads owns a 128 x 128 output tile, walks the 2h samples
// in steps of 8, stages the A tile (transposed, so that a thread's rows are
// one vector load) and the B tile in shared memory, and keeps an 8 x 8
// micro-tile in registers (two 4-wide halves 64 apart in each direction,
// which makes shared-memory reads and global stores conflict-free and
// coalesced). The next step's tiles are fetched into registers while the
// current step multiplies. Each signal sample is read from device memory
// once and a second time, by the neighbouring frame row, from L2.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;            // frame rows per block
constexpr int BN = 128;            // MDCT lines per block
constexpr int BK = 8;              // samples per step
constexpr int kThreads = 256;
constexpr int kPadA = 4;           // As row stride 132: conflict-free stores

__global__ void __launch_bounds__(kThreads)
mdct_fused_kernel(const float* __restrict__ xp, const float* __restrict__ basis,
                  float* __restrict__ out, long long rows, int frames, int h,
                  long long xp_len) {
  __shared__ __align__(16) float As[BK][BM + kPadA];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int n2 = 2 * h;

  // loads: A tile 128 rows x 8 samples = 256 float4, one a thread;
  //        B tile 8 samples x 128 lines = 256 float4, one a thread
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const int b_k = tid >> 5, b_col = (tid & 31) * 4;
  const long long a_off = (row0 + a_row) * h + a_k;      // + k0
  const bool b_ok = col0 + b_col < h;                     // h % 4 == 0
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  auto load_a = [&](int k0) -> float4 {
    const long long e = a_off + k0;                       // multiple of 4
    return e + 3 < xp_len ? *reinterpret_cast<const float4*>(xp + e) : zero4;
  };
  auto load_b = [&](int k0) -> float4 {
    return b_ok ? *reinterpret_cast<const float4*>(
                      basis + (long long)(k0 + b_k) * h + col0 + b_col)
                : zero4;
  };

  // compute: thread (ty, tx) owns rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
  // columns tx*4 + {0..3} and 64 + tx*4 + {0..3}
  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 ra = load_a(0), rb = load_b(0);
  for (int k0 = 0; k0 < n2; k0 += BK) {
    As[a_k + 0][a_row] = ra.x;
    As[a_k + 1][a_row] = ra.y;
    As[a_k + 2][a_row] = ra.z;
    As[a_k + 3][a_row] = ra.w;
    *reinterpret_cast<float4*>(&Bs[b_k][b_col]) = rb;
    __syncthreads();
    if (k0 + BK < n2) {
      ra = load_a(k0 + BK);
      rb = load_b(k0 + BK);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // store: row r = c*(F+1) + f goes to out[c, f, :]; f == F is the row that
  // straddles two channels and is dropped
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r >= rows) continue;
    const long long c = r / (frames + 1);
    const int f = (int)(r - c * (frames + 1));
    if (f == frames) continue;
    float* dst = out + (c * frames + f) * h;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = col0 + half * 64 + tx * 4;
      if (col < h)
        *reinterpret_cast<float4*>(dst + col) =
            make_float4(acc[i][half * 4 + 0], acc[i][half * 4 + 1],
                        acc[i][half * 4 + 2], acc[i][half * 4 + 3]);
    }
  }
}

}  // namespace

// xp: f32[channels, (frames + 1) * h] padded signal; basis: f32[2h, h];
// out: f32[channels, frames, h]. h must be a multiple of 4 (16-byte vector
// loads). Returns cudaGetLastError() after the launch.
extern "C" int tac_mdct_frames_fused(const float* xp, const float* basis,
                                     float* out, int channels, int frames,
                                     int h, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (channels < 1 || frames < 1 || h < 4 || h % 4) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)channels * (frames + 1);
  const long long row_tiles = (rows + BM - 1) / BM;
  const int col_tiles = (h + BN - 1) / BN;
  if (row_tiles > 2147483647LL || col_tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)row_tiles, (unsigned)col_tiles);
  mdct_fused_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xp, basis, out, rows, frames, h, rows * h);
  return (int)cudaGetLastError();
}
