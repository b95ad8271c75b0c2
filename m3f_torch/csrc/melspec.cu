// Log-mel frontend: framing -> Hann window -> real FFT -> power -> mel -> log.
//
// Replaces: m3f/pytorch_tpu/ops/pallas/melspec_pallas.py
//           log_mel_spectrogram_pallas (kernel body _kernel, constants
//           _windowed_dft_mats).
//
// Bound on an H100: operations, but only just. The function's own work per
// frame of 1024 samples is a real FFT (~5/2 n log2 n), the power of 513
// bins and the 513 x 64 mel product: ~0.19 GFLOP for the main path's 2048
// frames, ~2.9 us at the fp32 rate (67 TFLOP/s), against ~1.3 us for its
// 4.1 MB of wav in and 0.26 MB out at 3.35 TB/s (chip_smoke.py computes
// this bound). The TPU kernel does the DFT as a product with window-folded
// cos / sin bases on its matrix unit, ~20x that work; on this card the
// product ran on the fp32 cores and cost more than torch.stft + a matmul,
// so the DFT here is an FFT in shared memory, about the function's own
// work.
//
// Design:
// - One block per (wav row, FPB output frames). The block copies the row's
//   samples that its frames touch into shared memory ONCE, applying the
//   centring reflection in index space while it copies, so there is no
//   padded copy of the wav in device memory. Frames are overlapping windows
//   of that shared segment (frame f starts at f*hop).
// - A frame of n real samples is one n/2-point complex FFT of z[j] =
//   w[2j] x[2j] + i w[2j+1] x[2j+1] (the window applied as the samples are
//   read), in Stockham stages in shared memory, fp32: a radix-2 stage first
//   when log2(n/2) is odd, then radix-4 stages; each stage reads one buffer
//   and writes the other in natural order, with one barrier. Twiddles come
//   from a table exp(-2 pi i k / n) built on the host in float64
//   (melspec.py fft_plan), staged in shared memory once per block.
// - The real split gives the bins [bin_lo, bin_hi) that some mel band
//   weighs: X[k] = (Z[k] + Z*[N-k]) / 2 - i e[k] (Z[k] - Z*[N-k]) / 2, and
//   their power goes to shared memory; bins no band weighs (0 and n/2 at
//   the default config) are never formed. The spectrum never reaches
//   device memory.
// - Mel: band m sums only its own nonzero bins [band_lo[m], band_hi[m])
//   (a Slaney triangle covers a few dozen bins), then log(mel + eps) is
//   written once in the output dtype.
// - Per-row hop: with a hop array each row frames at its own hop and
//   reflects about its own end, (F-1)*hop - 1 (melspec.py _frame_dynamic).
//
// A second route, log_mel_dft_kernel (entry m3f_log_mel_dft), takes an
// n_fft that is not a power of two (the FFT's stages need one): the TPU
// kernel's own method, a product of the frames with window-folded cos /
// sin bases over the bins the filterbank weighs (melspec.py
// windowed_dft_mats), ~20x the function's work on the fp32 cores. It is
// the route for such configs only, not made fast (described above its
// code).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FPB = 8;        // frames per block
constexpr int THREADS = 256;

// One Stockham stage of radix R over the block's nf frames of N points:
// for j < N/R, v[r] = src[j + r N/R] * w^(r (j % Ns) N/(Ns R)), a radix-R
// DFT of v, dst[(j / Ns) Ns R + j % Ns + r Ns] = v[r]. With src null the
// stage reads z from the windowed segment (the first stage: Ns = 1, no
// twiddles).
template <int R>
__device__ __forceinline__ void fft_stage(const float2* src, float2* dst,
                                          const float* seg, const float* win,
                                          int hop, const float2* tw, int N,
                                          int Ns, int nf) {
  const int NR = N / R;
  for (int i = threadIdx.x; i < nf * NR; i += THREADS) {
    const int f = i / NR, j = i - f * NR;
    const int k = j % Ns;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = j + r * NR;
      if (src == nullptr) {
        const float* s = seg + f * hop + 2 * n;
        v[r] = make_float2(win[2 * n] * s[0], win[2 * n + 1] * s[1]);
      } else {
        const float2 a = src[f * N + n];
        // w_N^m = e[2m], m = r k N / (Ns R)
        const float2 w = tw[2 * r * k * (N / (Ns * R))];
        v[r] = make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
      }
    }
    float2* d = dst + f * N + (j / Ns) * Ns * R + k;
    if (R == 2) {
      d[0] = make_float2(v[0].x + v[1].x, v[0].y + v[1].y);
      d[Ns] = make_float2(v[0].x - v[1].x, v[0].y - v[1].y);
    } else {
      const float2 a0 = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
      const float2 a1 = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
      const float2 a2 = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
      // -i (v1 - v3)
      const float2 a3 = make_float2(v[1].y - v[3].y, v[3].x - v[1].x);
      d[0] = make_float2(a0.x + a2.x, a0.y + a2.y);
      d[Ns] = make_float2(a1.x + a3.x, a1.y + a3.y);
      d[2 * Ns] = make_float2(a0.x - a2.x, a0.y - a2.y);
      d[3 * Ns] = make_float2(a1.x - a3.x, a1.y - a3.y);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ wav, int S, int F,
               const int* __restrict__ hops, int hop0, int end0, int left,
               const float* __restrict__ window, const float2* __restrict__ twid,
               const int* __restrict__ band_lo, const int* __restrict__ band_hi,
               const float* __restrict__ fbw, int width, int bin_lo, int bin_hi,
               int n_fft, int n_mels, float log_eps, void* __restrict__ out,
               int out_bf16) {
  extern __shared__ __align__(16) float smem[];
  const int N = n_fft / 2;
  const int row = blockIdx.x;
  const int f0 = blockIdx.y * FPB;
  const int nf = min(FPB, F - f0);
  int hop = hop0, end = end0;
  if (hops != nullptr) {
    hop = hops[row];                        // the wrapper bounds it by hop_max
    end = hop * (F - 1) - 1;
  }
  const int seg_len = (nf - 1) * hop + n_fft;

  float2* bufA = reinterpret_cast<float2*>(smem);     // [FPB][N]
  float2* bufB = bufA + FPB * N;                       // [FPB][N]
  float2* tw = bufB + FPB * N;                         // [n_fft]
  float* win = reinterpret_cast<float*>(tw + n_fft);   // [n_fft]
  float* seg = win + n_fft;                            // [seg_len]

  const int tid = threadIdx.x;
  const float* x = wav + (int64_t)row * S;
  const int start = f0 * hop - left;
  for (int i = tid; i < seg_len; i += THREADS) {
    int j = start + i;
    j = j < 0 ? -j : j;                     // left reflection: -k -> k
    if (j > end) j = 2 * end - j;           // right reflection about end
    j = min(max(j, 0), S - 1);
    seg[i] = x[j];
  }
  for (int i = tid; i < n_fft; i += THREADS) {
    tw[i] = twid[i];
    win[i] = window[i];
  }
  __syncthreads();

  // the stages: radix 2 first when log2(N) is odd, then radix 4
  const float2* src = nullptr;
  float2* dst = bufA;
  int Ns = 1;
  if ((31 - __clz(N)) & 1) {
    fft_stage<2>(src, dst, seg, win, hop, tw, N, Ns, nf);
    Ns = 2;
    src = dst;
    dst = bufB;
    __syncthreads();
  }
  for (; Ns < N; Ns *= 4) {
    fft_stage<4>(src, dst, seg, win, hop, tw, N, Ns, nf);
    src = dst;
    dst = dst == bufA ? bufB : bufA;
    __syncthreads();
  }

  // real split and power of the weighed bins, into the other buffer
  const float2* Z = src;
  float* power = reinterpret_cast<float*>(dst);         // [FPB][nb]
  const int nb = bin_hi - bin_lo;
  for (int i = tid; i < nf * nb; i += THREADS) {
    const int f = i / nb, k = bin_lo + i - f * nb;
    const float2 a = Z[f * N + (k & (N - 1))];
    const float2 c = Z[f * N + ((N - k) & (N - 1))];  // conj taken below
    // Xe = (a + c*) / 2, Xo = -i (a - c*) / 2
    const float xe_r = 0.5f * (a.x + c.x), xe_i = 0.5f * (a.y - c.y);
    const float xo_r = 0.5f * (a.y + c.y), xo_i = -0.5f * (a.x - c.x);
    const float2 e = tw[k];
    const float re = xe_r + (e.x * xo_r - e.y * xo_i);
    const float im = xe_i + (e.x * xo_i + e.y * xo_r);
    power[f * nb + (k - bin_lo)] = re * re + im * im;
  }
  __syncthreads();

  // mel[f, m] = sum over band m's bins of power * weight; one owner each
  for (int o = tid; o < nf * n_mels; o += THREADS) {
    const int f = o / n_mels, m = o - f * n_mels;
    const int lo = band_lo[m], hi = band_hi[m];
    const float* pw = power + f * nb - bin_lo;
    const float* wm = fbw + (int64_t)m * width - lo;
    float acc = 0.f;
    for (int k = lo; k < hi; ++k) acc = fmaf(pw[k], __ldg(wm + k), acc);
    const float v = logf(acc + log_eps);
    const int64_t dst_i = ((int64_t)row * F + f0 + f) * n_mels + m;
    if (out_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[dst_i] = __float2bfloat16(v);
    else
      reinterpret_cast<float*>(out)[dst_i] = v;
  }
}

// ---------------------------------------------------------------------------
// The DFT-product route, for an n_fft that is not a power of two
// ---------------------------------------------------------------------------
//
// - One block per (wav row, DFT_FPB output frames); the row's samples its
//   frames touch are copied into shared memory once, with the centring
//   reflection applied in index space, as above.
// - The DFT is a product of the frames with window-folded cos / sin bases
//   (built on the host in float64, only the bins the mel filterbank weighs,
//   padded to a multiple of DFT_NB with zero columns). Basis tiles of
//   DFT_KT taps x DFT_NB bins are staged in shared memory (taps past n_fft
//   zero, so any n_fft works); each thread keeps a 4-frame x 4-bin register
//   tile of real and imaginary sums.
// - Power goes to shared memory per DFT_NB-bin pass and is folded into the
//   mel sums (kept in shared memory) before the next pass; log(mel + eps)
//   is written once in the output dtype. Per-row hop as above.

constexpr int DFT_FPB = 16;   // frames per block
constexpr int DFT_NB = 256;   // DFT bins per pass
constexpr int DFT_KT = 32;    // DFT taps per shared tile

__global__ void __launch_bounds__(THREADS)
log_mel_dft_kernel(const float* __restrict__ wav, int S, int F,
                   const int* __restrict__ hops, int hop0, int end0, int left,
                   const float* __restrict__ cmat, const float* __restrict__ smat,
                   const float* __restrict__ fb, int nbp, int n_fft, int n_mels,
                   float log_eps, void* __restrict__ out, int out_bf16) {
  extern __shared__ __align__(16) float smem[];
  const int row = blockIdx.x;
  const int f0 = blockIdx.y * DFT_FPB;
  const int nf = min(DFT_FPB, F - f0);
  int hop = hop0, end = end0;
  if (hops != nullptr) {
    hop = hops[row];                        // the wrapper bounds it by hop_max
    end = hop * (F - 1) - 1;
  }
  const int ktp = (n_fft + DFT_KT - 1) / DFT_KT * DFT_KT;   // taps, padded
  const int seg_len = (nf - 1) * hop + ktp;

  float* ctile = smem;                      // [DFT_KT][DFT_NB]
  float* stile = ctile + DFT_KT * DFT_NB;   // [DFT_KT][DFT_NB]
  float* power = stile + DFT_KT * DFT_NB;   // [DFT_FPB][DFT_NB]
  float* melacc = power + DFT_FPB * DFT_NB; // [DFT_FPB][n_mels]
  float* seg = melacc + DFT_FPB * n_mels;   // [seg_len]

  const int tid = threadIdx.x;
  const float* x = wav + (int64_t)row * S;
  const int start = f0 * hop - left;
  // samples past a frame's n_fft meet zero basis rows; they are read as
  // finite values from the row all the same
  for (int i = tid; i < seg_len; i += THREADS) {
    int j = start + i;
    j = j < 0 ? -j : j;                     // left reflection: -k -> k
    if (j > end) j = 2 * end - j;           // right reflection about end
    j = min(max(j, 0), S - 1);
    seg[i] = x[j];
  }
  for (int i = tid; i < DFT_FPB * n_mels; i += THREADS) melacc[i] = 0.f;

  const int fg = tid >> 6;                  // frames fg*4 .. fg*4+3
  const int bg = tid & 63;                  // bins bg*4 .. bg*4+3 of a pass
  for (int pass = 0; pass < nbp / DFT_NB; ++pass) {
    float re[4][4], im[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) re[a][b] = im[a][b] = 0.f;

    for (int k0 = 0; k0 < ktp; k0 += DFT_KT) {
      __syncthreads();                      // previous tile fully consumed
      for (int v = tid; v < DFT_KT * DFT_NB / 4; v += THREADS) {
        const int kk = v / (DFT_NB / 4), c4 = v % (DFT_NB / 4);
        float4 c = make_float4(0.f, 0.f, 0.f, 0.f), sn = c;
        if (k0 + kk < n_fft) {
          const int64_t g = (int64_t)(k0 + kk) * nbp + pass * DFT_NB + c4 * 4;
          c = *reinterpret_cast<const float4*>(cmat + g);
          sn = *reinterpret_cast<const float4*>(smat + g);
        }
        reinterpret_cast<float4*>(ctile)[v] = c;
        reinterpret_cast<float4*>(stile)[v] = sn;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < DFT_KT; ++kk) {
        float xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int f = fg * 4 + a;
          xv[a] = f < nf ? seg[f * hop + k0 + kk] : 0.f;
        }
        const float4 c = reinterpret_cast<const float4*>(ctile + kk * DFT_NB)[bg];
        const float4 sn = reinterpret_cast<const float4*>(stile + kk * DFT_NB)[bg];
        const float cv[4] = {c.x, c.y, c.z, c.w};
        const float sv[4] = {sn.x, sn.y, sn.z, sn.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            re[a][b] = fmaf(xv[a], cv[b], re[a][b]);
            im[a][b] = fmaf(xv[a], sv[b], im[a][b]);
          }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        power[(fg * 4 + a) * DFT_NB + bg * 4 + b] =
            re[a][b] * re[a][b] + im[a][b] * im[a][b];
    __syncthreads();
    // mel[f, m] += sum_b power[f, b] * fb[b, m]; each output has one owner
    const float* fbp = fb + (int64_t)pass * DFT_NB * n_mels;
    for (int o = tid; o < DFT_FPB * n_mels; o += THREADS) {
      const int f = o / n_mels, m = o % n_mels;
      float acc = 0.f;
      for (int b = 0; b < DFT_NB; ++b)
        acc = fmaf(power[f * DFT_NB + b], fbp[b * n_mels + m], acc);
      melacc[o] += acc;
    }
  }
  __syncthreads();
  for (int o = tid; o < nf * n_mels; o += THREADS) {
    const int f = o / n_mels;
    const float v = logf(melacc[o] + log_eps);
    const int64_t dst = ((int64_t)row * F + f0 + f) * n_mels + (o % n_mels);
    if (out_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[dst] = __float2bfloat16(v);
    else
      reinterpret_cast<float*>(out)[dst] = v;
  }
}

}  // namespace

extern "C" int m3f_log_mel(const void* wav, int n_rows, int S, int F,
                           const void* hops, int hop0, int end0, int left,
                           int hop_max, const void* window, const void* twid,
                           const void* band_lo, const void* band_hi,
                           const void* fbw, int width, int bin_lo, int bin_hi,
                           int n_fft, int n_mels, float log_eps, void* out,
                           int out_bf16, void* stream) {
  if (n_rows <= 0 || F <= 0) return 0;
  if (n_fft < 4 || (n_fft & (n_fft - 1)) || bin_lo < 0 || bin_hi > n_fft / 2 + 1 ||
      bin_hi < bin_lo)
    return (int)cudaErrorInvalidValue;
  const int seg_max = (min(F, FPB) - 1) * hop_max + n_fft;
  // two FFT buffers (the power reuses one), twiddles, window, segment
  const size_t smem = sizeof(float) * (4 * FPB * (n_fft / 2) + 3 * n_fft + seg_max);
  cudaError_t e = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_rows, (F + FPB - 1) / FPB);
  log_mel_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)wav, S, F, (const int*)hops, hop0, end0, left,
      (const float*)window, (const float2*)twid, (const int*)band_lo,
      (const int*)band_hi, (const float*)fbw, width, bin_lo, bin_hi, n_fft,
      n_mels, log_eps, out, out_bf16);
  return (int)cudaGetLastError();
}

// The DFT-product route: cmat / smat [n_fft, nbp] fp32 window-folded bases
// over the bins the filterbank weighs (zero columns past them), fb [nbp,
// n_mels] the matching filterbank rows, nbp a multiple of 256; the other
// arguments as m3f_log_mel's.
extern "C" int m3f_log_mel_dft(const void* wav, int n_rows, int S, int F,
                               const void* hops, int hop0, int end0, int left,
                               int hop_max, const void* cmat, const void* smat,
                               const void* fb, int nbp, int n_fft, int n_mels,
                               float log_eps, void* out, int out_bf16,
                               void* stream) {
  if (n_rows <= 0 || F <= 0) return 0;
  if (nbp % DFT_NB != 0 || n_fft < 1) return (int)cudaErrorInvalidValue;
  const int ktp = (n_fft + DFT_KT - 1) / DFT_KT * DFT_KT;
  const int seg_max = (min(F, DFT_FPB) - 1) * hop_max + ktp;
  const size_t smem = sizeof(float) *
      (2 * DFT_KT * DFT_NB + DFT_FPB * DFT_NB + DFT_FPB * n_mels + seg_max);
  cudaError_t e = cudaFuncSetAttribute(
      log_mel_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_rows, (F + DFT_FPB - 1) / DFT_FPB);
  log_mel_dft_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)wav, S, F, (const int*)hops, hop0, end0, left,
      (const float*)cmat, (const float*)smat, (const float*)fb, nbp, n_fft,
      n_mels, log_eps, out, out_bf16);
  return (int)cudaGetLastError();
}
