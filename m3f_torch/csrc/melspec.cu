// Log-mel frontend: framing -> Hann-folded real DFT -> power -> mel -> log.
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
// this bound). This simple kernel does the DFT as a product with cos / sin
// bases instead of an FFT, 16 x 1024 x 511 x 2 multiply-adds per row, about
// 20x the function's work, so it sits far above that floor; an FFT in
// shared memory is the way down to it.
//
// Design:
// - One block per (wav row, 16 output frames). The block copies the row's
//   samples that its frames touch into shared memory ONCE, applying the
//   centring reflection in index space while it copies, so there is no
//   padded copy of the wav in device memory. Frames are then overlapping
//   windows of that shared segment (frame f starts at f*hop).
// - The DFT is a product of the frames with window-folded cos / sin bases
//   (built on the host in float64, only the bins the mel filterbank weighs,
//   padded to a multiple of 256 with zero columns). Basis tiles of 32 taps x
//   256 bins are staged in shared memory; each thread keeps a 4-frame x
//   4-bin register tile of real and imaginary sums (32 accumulators), so
//   each shared load feeds several FMAs.
// - Power goes to shared memory per 256-bin pass and is folded into the mel
//   sums (kept in shared memory) before the next pass: the [frames, bins]
//   spectrum never reaches device memory. log(mel + eps) is written once in
//   the output dtype.
// - Per-row hop: with a hop array each row frames at its own hop and
//   reflects about its own end, (F-1)*hop - 1 (melspec.py _frame_dynamic).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FPB = 16;       // frames per block
constexpr int NB = 256;       // DFT bins per pass
constexpr int KT = 32;        // DFT taps per shared tile
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ wav, int S, int F,
               const int* __restrict__ hops, int hop0, int end0, int left,
               const float* __restrict__ cmat, const float* __restrict__ smat,
               const float* __restrict__ fb, int nbp, int n_fft, int n_mels,
               float log_eps, void* __restrict__ out, int out_bf16) {
  extern __shared__ __align__(16) float smem[];
  const int row = blockIdx.x;
  const int f0 = blockIdx.y * FPB;
  const int nf = min(FPB, F - f0);
  int hop = hop0, end = end0;
  if (hops != nullptr) {
    hop = hops[row];                        // the wrapper bounds it by hop_max
    end = hop * (F - 1) - 1;
  }
  const int seg_len = (nf - 1) * hop + n_fft;

  float* ctile = smem;                      // [KT][NB]
  float* stile = ctile + KT * NB;           // [KT][NB]
  float* power = stile + KT * NB;           // [FPB][NB]
  float* melacc = power + FPB * NB;         // [FPB][n_mels]
  float* seg = melacc + FPB * n_mels;       // [seg_len]

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
  for (int i = tid; i < FPB * n_mels; i += THREADS) melacc[i] = 0.f;

  const int fg = tid >> 6;                  // frames fg*4 .. fg*4+3
  const int bg = tid & 63;                  // bins bg*4 .. bg*4+3 of a pass
  for (int pass = 0; pass < nbp / NB; ++pass) {
    float re[4][4], im[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) re[a][b] = im[a][b] = 0.f;

    for (int k0 = 0; k0 < n_fft; k0 += KT) {
      __syncthreads();                      // previous tile fully consumed
      for (int v = tid; v < KT * NB / 4; v += THREADS) {
        const int kk = v / (NB / 4), c4 = v % (NB / 4);
        const int64_t g = (int64_t)(k0 + kk) * nbp + pass * NB + c4 * 4;
        reinterpret_cast<float4*>(ctile)[v] =
            *reinterpret_cast<const float4*>(cmat + g);
        reinterpret_cast<float4*>(stile)[v] =
            *reinterpret_cast<const float4*>(smat + g);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KT; ++kk) {
        float xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int f = fg * 4 + a;
          xv[a] = f < nf ? seg[f * hop + k0 + kk] : 0.f;
        }
        const float4 c = reinterpret_cast<const float4*>(ctile + kk * NB)[bg];
        const float4 s = reinterpret_cast<const float4*>(stile + kk * NB)[bg];
        const float cv[4] = {c.x, c.y, c.z, c.w};
        const float sv[4] = {s.x, s.y, s.z, s.w};
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
        power[(fg * 4 + a) * NB + bg * 4 + b] =
            re[a][b] * re[a][b] + im[a][b] * im[a][b];
    __syncthreads();
    // mel[f, m] += sum_b power[f, b] * fb[b, m]; each output has one owner
    const float* fbp = fb + (int64_t)pass * NB * n_mels;
    for (int o = tid; o < FPB * n_mels; o += THREADS) {
      const int f = o / n_mels, m = o % n_mels;
      float acc = 0.f;
      for (int b = 0; b < NB; ++b)
        acc = fmaf(power[f * NB + b], fbp[b * n_mels + m], acc);
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
                           int hop_max, const void* cmat, const void* smat,
                           const void* fb, int nbp, int n_fft, int n_mels,
                           float log_eps, void* out, int out_bf16,
                           void* stream) {
  if (n_rows <= 0 || F <= 0) return 0;
  if (nbp % NB != 0 || n_fft % KT != 0) return (int)cudaErrorInvalidValue;
  const int seg_max = (min(F, FPB) - 1) * hop_max + n_fft;
  const size_t smem = sizeof(float) *
      (2 * KT * NB + FPB * NB + FPB * n_mels + seg_max);
  cudaError_t e = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_rows, (F + FPB - 1) / FPB);
  log_mel_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)wav, S, F, (const int*)hops, hop0, end0, left,
      (const float*)cmat, (const float*)smat, (const float*)fb, nbp, n_fft,
      n_mels, log_eps, out, out_bf16);
  return (int)cudaGetLastError();
}
