// Kernel K8: the fast psychoacoustic model after its DFT, one launch a call.
// In: the hann-fused DFT's real and imaginary rows (two K6 products), the
// MDCT lines and the MDCT gain (one scalar, or one per row: block
// switching's START / STOP windows). Out: smr[r, b] per scale-factor band,
// the large negative _NEG on empty bands.
//
// A kernel of the port with no TPU counterpart: tac leaves its psy model to
// XLA (tac/psy.py: _tonal_maskers, _noise_band_maskers, masked_threshold,
// masked_threshold_bands, calc_smrs), which fuses it. In eager PyTorch the
// same model is ~165 launches a call at H = 1 024 and ~160 at H = 256 or 64,
// among them [rows, 64, H] broadcasts of the spread; a streaming-ll batch
// issued ~6 700 of them. Here each row's spectrum, peaks, masker sort,
// spreading, noise maskers and band maxima stay in shared memory and
// registers.
//
// What it computes (tac_torch/psy.py, the plain version, step for step):
//   ii = fft_gain * (re^2 + im^2); strict interior local maxima, their
//   +-1-line sums (peak_i) and weighted-centre numerators; the candidates
//   pair-compacted (strict peaks are never adjacent) where k <= H/2, else
//   every line; the top k by (-value, index), k = min(max_maskers, H);
//   each kept masker's SPL, Bark and slope; per band the noise energy of
//   the lines not within +-1 of a kept masker (the kept / tie rule of
//   _noise_band_maskers); the two-slope spread of every valid masker and
//   valid noise band at each point, plus the threshold in quiet; then
//     line model (H points): smr = band max of (line SPL - threshold SPL);
//     band model (2B points, a band's two edge Barks; per masker the lesser
//     of its two edge intensities): smr = band max of line SPL - threshold
//     SPL.
//
// What bounds it on an H100: the spread's exponentials, one powf per
// (masker, point): up to (64 + 25) x 256 a streaming-ll long row, 89 x 64
// a short one, (64 + 25) x 50 a flagship row; bytes are the rows read once
// (re, im, lines; 25.2 MB a 2 048-row flagship chunk). The critical path of
// a row is the bitonic sort (45 barrier-separated stages at 512 keys) and
// the widest band's chains (304 lines at H = 1 024).
//
// Design (Hopper):
//  - row-invariant: T = min(H, 256) threads a row, 256 / T rows a
//    256-thread block, one block a row for H >= 256; no atomics and no
//    cross-row sum, so a row's bits do not depend on the rows beside it;
//  - the row's intensity is staged in shared memory; the candidates are
//    64-bit keys (0x7fffffff - bits(value)) << 32 | index there, sorted
//    ascending by a bitonic network: descending value, ties by the lower
//    index, as the plain version's stable sort;
//  - each thread owns points and adds the valid maskers' intensities in
//    rank order in a register (line model); the band model spreads its
//    (masker, band) pairs over the block into a table, then a thread a
//    band adds the table's column in rank order;
//  - the noise bands' energies are added in index order in double and
//    rounded once, as K7 adds them, so they equal the plain version's;
//    the band maxima are order-free, so they are exact;
//  - built with -fmad=false: ii, the peak sums and the tie rule compare
//    the plain version's floats bit for bit, so the same maskers are
//    kept; precise powf / log10f / atanf (no fast intrinsics). Divisions
//    by a constant are products by its float reciprocal, as PyTorch's
//    CUDA division by a Python number computes them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBands = 64;   // the host table is K7's (MAX_SEGMENTS)

// the plain version's constants as PyTorch rounds a Python float to f32
constexpr float kTiny = (float)1e-40;      // spl_from_intensity's clamp
constexpr float kNeg = (float)-1e30;       // psy._NEG
constexpr float kTenth = 1.0f / 10.0f;     // (spl - 96) / 10
constexpr float kMilli = 1.0f / 1000.0f;   // bark: 0.76 f / 1000
constexpr float kBarkG = 1.0f / 7500.0f;   // bark: f / 7500

struct Bands {
  int start[kMaxBands];
  int end[kMaxBands];
};

__device__ __forceinline__ float spl(float i) {
  const float c = i < kTiny ? kTiny : i;
  const float s = 96.0f + 10.0f * log10f(c);
  return s < -30.0f ? -30.0f : s;
}

__device__ __forceinline__ float intensity(float s) {
  return powf(10.0f, (s - 96.0f) * kTenth);
}

__device__ __forceinline__ float bark(float f) {
  const float g = f * kBarkG;
  return 13.0f * atanf((float)0.76 * f * kMilli) + 3.5f * atanf(g * g);
}

// the upward slope of a masker of level l (SPEC.md §5)
__device__ __forceinline__ float up_slope(float l) {
  float a = l - 40.0f;
  a = a < 0.0f ? 0.0f : a;
  const float s = 27.0f - (float)0.367 * a;
  return s < 0.0f ? 0.0f : s;
}

// intensity at Bark z of a masker at zm with slope `up` and level - delta
// `top`: the two-slope spread of _spread_spl
__device__ __forceinline__ float spread_i(float z, float zm, float up,
                                          float top) {
  const float dz = z - zm;
  const float drop = dz < 0.0f ? 27.0f * (-dz) : up * dz;
  return intensity(top - drop);
}

// peak_i at line l: the +-1 sum of a strict interior local maximum, else 0
// (edges compare against +inf, sum against 0); 0 outside [0, h)
__device__ __forceinline__ float peak_at(const float* ii, int l, int h) {
  if (l < 0 || l >= h) return 0.0f;
  const float c = ii[l];
  const float left = l > 0 ? ii[l - 1] : INFINITY;
  const float right = l < h - 1 ? ii[l + 1] : INFINITY;
  if (!(c > left && c >= right)) return 0.0f;
  return (c + (l > 0 ? ii[l - 1] : 0.0f)) + (l < h - 1 ? ii[l + 1] : 0.0f);
}

__device__ __forceinline__ unsigned long long cand_key(float v, int idx) {
  return ((unsigned long long)(0x7fffffffu - __float_as_uint(v)) << 32)
         | (unsigned)idx;
}

// Shared memory of one row, in floats: keys (2n; the noise lines alias
// them once the maskers are read), ii (H; the line SPLs alias it once the
// noise lines are made), three masker arrays (k each), four noise-band
// arrays (B each), four scalars, and in the band model the spread table
// (k + B rows of B).
__host__ __device__ __forceinline__ int row_floats(int h, int n, int k,
                                                   int nb, bool band) {
  const int f = 2 * n + h + 3 * k + 4 * nb + 4 + (band ? (k + nb) * nb : 0);
  return (f + 3) & ~3;                 // 16-byte rows: keys stay aligned
}

template <bool BAND>
__global__ void __launch_bounds__(kThreads)
psy_smr_kernel(const float* __restrict__ re, const float* __restrict__ im,
               const float* __restrict__ lines,
               const float* __restrict__ gain_rows, float gain, float fft_gain,
               const float* __restrict__ freqs,
               const float* __restrict__ zlo, const float* __restrict__ zhi,
               const float* __restrict__ quiet,
               const float* __restrict__ noise_z, float delta_tonal,
               float delta_noise, float* __restrict__ out,
               int* __restrict__ maskers_out, int rows, int h, int k, int nb,
               int noise, const Bands bands) {
  extern __shared__ __align__(16) float smem[];
  const int tpr = h < kThreads ? h : kThreads;      // threads a row
  const int t = threadIdx.x % tpr;
  const int local = threadIdx.x / tpr;
  const int row = blockIdx.x * (kThreads / tpr) + local;
  const bool active = row < rows;                   // every thread syncs
  const bool compact = k <= h / 2;
  const int n = compact ? h / 2 : h;                 // candidates
  float* base = smem + (size_t)local * row_floats(h, n, k, nb, BAND);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(base);
  float* nline = base;                 // noise lines, after the maskers
  float* ii = base + 2 * n;
  float* dline = ii;                   // line SPLs, after the noise lines
  float* m_z = ii + h;
  float* m_up = m_z + k;
  float* m_top = m_up + k;
  float* n_z = m_top + k;
  float* n_up = n_z + nb;
  float* n_top = n_up + nb;
  int* n_ok = reinterpret_cast<int*>(n_top + nb);
  int* s_nv = n_ok + nb;               // valid maskers (a prefix of ranks)
  float* s_thr = reinterpret_cast<float*>(s_nv + 1);  // the kth value
  int* s_tie = s_nv + 2;               // largest kept index at that value
  float* tab = reinterpret_cast<float*>(s_nv + 4);    // band model

  const long long off = (long long)row * h;
  // 1. the intensity
  for (int l = t; l < h; l += tpr) {
    float v = 0.0f;
    if (active) {
      const float a = re[off + l], b = im[off + l];
      v = fft_gain * (a * a + b * b);
    }
    ii[l] = v;
  }
  if (t == 0) *s_nv = 0;
  __syncthreads();

  // 2. the candidates' keys
  if (compact) {
    for (int j = t; j < n; j += tpr) {
      const float pa = peak_at(ii, 2 * j, h), pb = peak_at(ii, 2 * j + 1, h);
      keys[j] = pb > pa ? cand_key(pb, 2 * j + 1) : cand_key(pa, 2 * j);
    }
  } else {
    for (int l = t; l < n; l += tpr) keys[l] = cand_key(peak_at(ii, l, h), l);
  }
  __syncthreads();

  // 3. bitonic sort, ascending key: descending value, then lower index
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < n; i += tpr) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = keys[i], b = keys[j];
          if ((a > b) == ((i & size) == 0)) {
            keys[i] = b;
            keys[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // 4. the kept maskers: level, Bark, slope, in rank order
  for (int m = t; m < k; m += tpr) {
    const unsigned long long key = keys[m];
    const float v = __uint_as_float(0x7fffffffu - (unsigned)(key >> 32));
    const int idx = (int)(key & 0xffffffffu);
    const bool valid = v > 0.0f;
    if (valid && (m + 1 == k || !(__uint_as_float(
            0x7fffffffu - (unsigned)(keys[m + 1] >> 32)) > 0.0f)))
      *s_nv = m + 1;
    if (m == k - 1) {
      *s_thr = v;
      *s_tie = valid ? idx : -1;     // ties rank by index: the kth's is largest
    }
    if (active && maskers_out != nullptr)
      maskers_out[(long long)row * k + m] = valid ? idx : -1;
    // the weighted centre: sum of ii * f over the three lines, edges
    // replicated
    const float pc = ii[idx] * freqs[idx];
    const float pl = idx > 0 ? ii[idx - 1] * freqs[idx - 1] : pc;
    const float pr = idx < h - 1 ? ii[idx + 1] * freqs[idx + 1] : pc;
    const float fm = ((pl + pc) + pr) / (v < kTiny ? kTiny : v);
    const float lm = spl(v);
    m_z[m] = bark(fm);
    m_up[m] = up_slope(lm);
    m_top[m] = lm - delta_tonal;
  }
  __syncthreads();
  const int nv = *s_nv;

  // 5. the noise maskers: each band's lines not within +-1 of a kept tonal
  // masker, added in index order in double
  if (noise) {
    const float thr = *s_thr;
    const int tie = *s_tie;
    for (int l = t; l < h; l += tpr) {
      bool near = false;
      for (int d = -1; d <= 1; ++d) {
        const float p = peak_at(ii, l + d, h);
        near |= p > 0.0f && (p > thr || (p == thr && l + d <= tie));
      }
      nline[l] = near ? 0.0f : ii[l];
    }
    __syncthreads();
    for (int b = t; b < nb; b += tpr) {
      double acc = 0.0;
      for (int l = bands.start[b]; l < bands.end[b]; ++l) acc += (double)nline[l];
      const float e = (float)acc;
      const float ln = spl(e);
      n_ok[b] = e > 0.0f;
      n_z[b] = noise_z[b];
      n_up[b] = up_slope(ln);
      n_top[b] = ln - delta_noise;
    }
  }
  __syncthreads();

  // 6. the threshold, the line SPLs, the SMRs
  const float g = gain_rows != nullptr ? (active ? gain_rows[row] : 0.0f) : gain;
  if (!BAND) {
    for (int p = t; p < h; p += tpr) {
      const float z = zlo[p];
      float acc = 0.0f;
      for (int m = 0; m < nv; ++m) acc += spread_i(z, m_z[m], m_up[m], m_top[m]);
      if (noise) {
        float accn = 0.0f;
        for (int b = 0; b < nb; ++b)
          if (n_ok[b]) accn += spread_i(z, n_z[b], n_up[b], n_top[b]);
        acc = acc + accn;
      }
      const float thr_spl = spl(acc + quiet[p]);
      const float x = active ? lines[off + p] : 0.0f;
      dline[p] = spl(g * (x * x)) - thr_spl;
    }
  } else {
    for (int i = t; i < nv * nb; i += tpr) {
      const int m = i / nb, b = i - m * nb;
      tab[i] = fminf(spread_i(zlo[b], m_z[m], m_up[m], m_top[m]),
                     spread_i(zhi[b], m_z[m], m_up[m], m_top[m]));
    }
    if (noise) {
      float* tabn = tab + k * nb;
      for (int i = t; i < nb * nb; i += tpr) {
        const int bn = i / nb, b = i - bn * nb;
        tabn[i] = n_ok[bn]
            ? fminf(spread_i(zlo[b], n_z[bn], n_up[bn], n_top[bn]),
                    spread_i(zhi[b], n_z[bn], n_up[bn], n_top[bn]))
            : 0.0f;
      }
    }
    for (int p = t; p < h; p += tpr) {
      const float x = active ? lines[off + p] : 0.0f;
      dline[p] = spl(g * (x * x));
    }
  }
  __syncthreads();
  for (int b = t; b < nb; b += tpr) {
    const int s = bands.start[b], e = bands.end[b];
    float mx = kNeg;
    if (e > s) {
      mx = dline[s];
      for (int l = s + 1; l < e; ++l) mx = fmaxf(mx, dline[l]);
      if (BAND) {
        float acc = 0.0f;
        for (int m = 0; m < nv; ++m) acc += tab[m * nb + b];
        if (noise) {
          const float* tabn = tab + k * nb;
          float accn = 0.0f;
          for (int bn = 0; bn < nb; ++bn)
            if (n_ok[bn]) accn += tabn[bn * nb + b];
          acc = acc + accn;
        }
        mx = mx - spl(acc + quiet[b]);
      }
    }
    if (active) out[(long long)row * nb + b] = mx;
  }
}

}  // namespace

// re, im, lines: f32[rows, h]; gain_rows: f32[rows] or null (then `gain`);
// freqs: f32[h]; line model: zlo = Bark of each line f32[h], quiet f32[h],
// zhi unused; band model: zlo / zhi = each band's edge Barks f32[nb], quiet
// f32[nb]; noise_z f32[nb]; out f32[rows, nb]; maskers_out int32[rows, k]
// or null (the kept maskers' line indices in rank order, -1 past the valid
// ones); bounds: host int32[2 * nb], the band starts then the ends. h a
// power of two >= 2, 1 <= k <= h, 1 <= nb <= 64. Returns
// cudaGetLastError() after the launch.
extern "C" int tac_psy_smr(const float* re, const float* im, const float* lines,
                           const float* gain_rows, float gain, float fft_gain,
                           const float* freqs, const float* zlo,
                           const float* zhi, const float* quiet,
                           const float* noise_z, float delta_tonal,
                           float delta_noise, float* out, int* maskers_out,
                           int rows, int h, int k, int nb, int band_model,
                           int noise, const int* bounds, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0 || h < 2 || (h & (h - 1)) || k < 1 || k > h || nb < 1
      || nb > kMaxBands)
    return (int)cudaErrorInvalidValue;
  Bands bands;
  for (int b = 0; b < nb; ++b) {
    bands.start[b] = bounds[b];
    bands.end[b] = bounds[nb + b];
    if (bands.start[b] < 0 || bands.start[b] > bands.end[b]
        || bands.end[b] > h)
      return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  const int tpr = h < kThreads ? h : kThreads;
  const int per_block = kThreads / tpr;
  const int n = k <= h / 2 ? h / 2 : h;
  const size_t bytes = sizeof(float) * (size_t)per_block
                       * row_floats(h, n, k, nb, band_model != 0);
  const int blocks = (rows + per_block - 1) / per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (band_model) {
    if (bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(psy_smr_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    psy_smr_kernel<true><<<blocks, kThreads, bytes, s>>>(
        re, im, lines, gain_rows, gain, fft_gain, freqs, zlo, zhi, quiet,
        noise_z, delta_tonal, delta_noise, out, maskers_out, rows, h, k, nb,
        noise, bands);
  } else {
    if (bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(psy_smr_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    psy_smr_kernel<false><<<blocks, kThreads, bytes, s>>>(
        re, im, lines, gain_rows, gain, fft_gain, freqs, zlo, zhi, quiet,
        noise_z, delta_tonal, delta_noise, out, maskers_out, rows, h, k, nb,
        noise, bands);
  }
  return (int)cudaGetLastError();
}
