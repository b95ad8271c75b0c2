// Log-mel frontend: framing -> Hann window -> real FFT -> power -> mel -> log.
//
// Replaces: m3f/pytorch_tpu/ops/pallas/melspec_pallas.py
//           log_mel_spectrogram_pallas (kernel body _kernel, constants
//           _windowed_dft_mats).
//
// Bound on an H100: bytes. The function's own work per frame of 1024
// samples is the window, a real FFT (~5/2 n log2 n), the power of 513 bins
// and the mel product over the filterbank's 997 nonzero weights (each bin
// lies in at most two Slaney triangles): ~0.062 GFLOP for the main path's
// 2048 frames, ~0.9 us at the fp32 rate (67 TFLOP/s), against ~1.3 us for
// its 4.1 MB of wav in and 0.26 MB out at 3.35 TB/s (chip_smoke.py
// computes this bound). The TPU kernel does the DFT as a product with
// window-folded cos / sin bases on its matrix unit, many times that work;
// on this card such a product runs on the fp32 cores and cost more than
// torch.stft + a matmul, so the DFT here is an FFT, about the function's
// own work, for every n_fft.
//
// Design:
// - Where everything fits a block's shared memory, one block per (wav row,
//   fpb output frames); melspec.py block_layout picks fpb, the largest of
//   8, 4, 2, 1 that fits (mel_smem). Where not even one frame's FFT
//   buffers, twiddles and window fit beside its samples (n_fft above ~7k
//   odd, ~9.7k even), the buffers live in a device-memory workspace of two
//   N-point complex buffers a block, the twiddles and window are read
//   through __ldg, and a grid of two blocks an SM walks the (row, frame)
//   pairs one frame at a time. Either way the block copies the row's
//   samples that its frames touch into shared memory ONCE, applying the
//   centring reflection in index space while it copies, so there is no
//   padded copy of the wav in device memory. Frames are overlapping
//   windows of that shared segment (frame f starts at f*hop).
// - An even n_fft of n real samples is one N = n/2-point complex FFT of
//   z[j] = w[2j] x[2j] + i w[2j+1] x[2j+1]; an odd n_fft one N = n-point
//   FFT of z[j] = w[j] x[j] (the window applied as the samples are read).
//   The FFT is a mixed-radix Stockham walk, fp32: stages of the radices
//   melspec.py fft_radices lists (4s, one 2 where the power of two is odd,
//   3s, 5s, then any other prime), each reading one buffer and writing the
//   other in natural order, with one barrier. Radices 2, 3, 4 and 5 have
//   their own butterflies; any other prime p is a stage in which each
//   thread forms one output as a p-term sum, its inner twiddle w_p^(rs)
//   read from the table at the integer index (N/p)((r s) mod p). Twiddles
//   come from a table e[m] = exp(-2 pi i m / n) built on the host in
//   float64 (the FFT's w_N^m is e[2m] for an even n_fft, e[m] for an odd
//   one).
// - Even n_fft: the real split gives the bins [bin_lo, bin_hi) that some
//   mel band weighs: X[k] = (Z[k] + Z*[N-k]) / 2 - i e[k] (Z[k] - Z*[N-k])
//   / 2. Odd n_fft: X[k] = Z[k]. Their power goes to the free buffer; bins
//   no band weighs (0 and n/2 at the default config) are never formed.
//   Where the buffers are shared the spectrum never reaches device memory.
// - Mel: band m sums only its own nonzero bins [band_lo[m], band_hi[m])
//   (a Slaney triangle covers a few dozen bins), then log(mel + eps) is
//   written once in the output dtype.
// - Per-row hop: with a hop array each row frames at its own hop and
//   reflects about its own end, (F-1)*hop - 1 (melspec.py _frame_dynamic).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_RADICES = 24;
constexpr int SMEM_MAX = 227 * 1024;   // a block's shared memory on sm_90

struct MelArgs {
  const float* wav;
  int S, F;
  const int* hops;
  int hop0, end0, left, jmax;
  const float* window;       // [n_fft]
  const float2* twid;        // [n_fft] e[m]
  const int* band_lo;
  const int* band_hi;
  const float* fbw;
  int width, bin_lo, bin_hi;
  int n_fft, N;
  int n_mels, fpb, n_rows;
  float log_eps;
  float2* work;              // [gridDim.x][2][N] where the buffers are not shared
  void* out;
  int out_bf16;
  int nrad;
  int rad[MAX_RADICES];
};

// A block's shared memory; melspec.py (mel_smem) computes the same: where
// shared, two complex buffers of fpb frames of N points (the power reuses
// one), the twiddle table and the window; always the segment of seg_frames
// frames at hop.
size_t mel_smem(int n_fft, int N, int fpb, int seg_frames, int hop, int shared) {
  return sizeof(float) * ((shared ? 4 * (size_t)fpb * N + 3 * (size_t)n_fft : 0) +
                          (size_t)(seg_frames - 1) * hop + n_fft);
}

template <bool SH, typename T>
__device__ __forceinline__ T tab(const T* p) {
  if constexpr (SH) return *p;
  else return __ldg(p);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// Input n of a stage: with src null the windowed frame f (the first stage:
// Ns = 1, no twiddle), else src[f][n] * w_N^m, w_N^m = e[2m] (even n_fft)
// or e[m] (ODD).
template <bool SH, bool ODD>
__device__ __forceinline__ float2 stage_in(const float2* src, const float* seg,
                                           const float* win, int hop,
                                           const float2* tw, const MelArgs& a,
                                           int f, int n, int m) {
  if (src == nullptr) {
    const float* s = seg + f * hop;
    if constexpr (ODD) return make_float2(tab<SH>(win + n) * s[n], 0.f);
    else return make_float2(tab<SH>(win + 2 * n) * s[2 * n],
                            tab<SH>(win + 2 * n + 1) * s[2 * n + 1]);
  }
  return cmul(src[f * a.N + n], tab<SH>(tw + (ODD ? 1 : 2) * m));
}

// One Stockham stage of radix R (2, 3, 4 or 5) over the block's nf frames
// of N points: for j < N/R, v[r] = src[j + r N/R] * w^(r (j % Ns) N/(Ns R)),
// a radix-R DFT of v, dst[(j / Ns) Ns R + j % Ns + r Ns] = v[r].
template <int R, bool SH, bool ODD>
__device__ __forceinline__ void fft_stage(const float2* src, float2* dst,
                                          const float* seg, const float* win,
                                          int hop, const float2* tw,
                                          const MelArgs& a, int Ns, int nf) {
  const int N = a.N, NR = N / R;
  for (int i = threadIdx.x; i < nf * NR; i += THREADS) {
    const int f = i / NR, j = i - f * NR;
    const int k = j % Ns;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[r] = stage_in<SH, ODD>(src, seg, win, hop, tw, a, f, j + r * NR,
                                r * k * (N / (Ns * R)));
    float2* d = dst + f * N + (j / Ns) * Ns * R + k;
    if constexpr (R == 2) {
      d[0] = make_float2(v[0].x + v[1].x, v[0].y + v[1].y);
      d[Ns] = make_float2(v[0].x - v[1].x, v[0].y - v[1].y);
    } else if constexpr (R == 3) {
      // w3 = -1/2 - i sqrt(3)/2: y1,2 = v0 - (v1 + v2)/2 -/+ i sqrt(3)/2 (v1 - v2)
      constexpr float S3 = 0.86602540378443865f;
      const float2 s = make_float2(v[1].x + v[2].x, v[1].y + v[2].y);
      const float2 t1 = make_float2(v[0].x - 0.5f * s.x, v[0].y - 0.5f * s.y);
      const float2 t2 = make_float2(S3 * (v[1].y - v[2].y), S3 * (v[2].x - v[1].x));
      d[0] = make_float2(v[0].x + s.x, v[0].y + s.y);
      d[Ns] = make_float2(t1.x + t2.x, t1.y + t2.y);
      d[2 * Ns] = make_float2(t1.x - t2.x, t1.y - t2.y);
    } else if constexpr (R == 4) {
      const float2 a0 = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
      const float2 a1 = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
      const float2 a2 = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
      // -i (v1 - v3)
      const float2 a3 = make_float2(v[1].y - v[3].y, v[3].x - v[1].x);
      d[0] = make_float2(a0.x + a2.x, a0.y + a2.y);
      d[Ns] = make_float2(a1.x + a3.x, a1.y + a3.y);
      d[2 * Ns] = make_float2(a0.x - a2.x, a0.y - a2.y);
      d[3 * Ns] = make_float2(a1.x - a3.x, a1.y - a3.y);
    } else {
      static_assert(R == 5, "radix 2, 3, 4 or 5");
      // c1, s1 = cos, sin(2 pi / 5); c2, s2 = cos, sin(4 pi / 5)
      constexpr float C1 = 0.30901699437494742f, C2 = -0.80901699437494742f;
      constexpr float S1 = 0.95105651629515357f, S2 = 0.58778525229247313f;
      const float2 a1 = make_float2(v[1].x + v[4].x, v[1].y + v[4].y);
      const float2 b1 = make_float2(v[1].x - v[4].x, v[1].y - v[4].y);
      const float2 a2 = make_float2(v[2].x + v[3].x, v[2].y + v[3].y);
      const float2 b2 = make_float2(v[2].x - v[3].x, v[2].y - v[3].y);
      // y1,4 = v0 + c1 a1 + c2 a2 -/+ i (s1 b1 + s2 b2)
      // y2,3 = v0 + c2 a1 + c1 a2 -/+ i (s2 b1 - s1 b2)
      const float2 p1 = make_float2(v[0].x + C1 * a1.x + C2 * a2.x,
                                    v[0].y + C1 * a1.y + C2 * a2.y);
      const float2 p2 = make_float2(v[0].x + C2 * a1.x + C1 * a2.x,
                                    v[0].y + C2 * a1.y + C1 * a2.y);
      const float2 q1 = make_float2(S1 * b1.x + S2 * b2.x, S1 * b1.y + S2 * b2.y);
      const float2 q2 = make_float2(S2 * b1.x - S1 * b2.x, S2 * b1.y - S1 * b2.y);
      d[0] = make_float2(v[0].x + a1.x + a2.x, v[0].y + a1.y + a2.y);
      // -i q = (q.y, -q.x)
      d[Ns] = make_float2(p1.x + q1.y, p1.y - q1.x);
      d[2 * Ns] = make_float2(p2.x + q2.y, p2.y - q2.x);
      d[3 * Ns] = make_float2(p2.x - q2.y, p2.y + q2.x);
      d[4 * Ns] = make_float2(p1.x - q1.y, p1.y + q1.x);
    }
  }
}

// A stage of any radix p (a prime other than 2, 3, 5; 1 copies the
// windowed frames where N = 1): each thread forms one output r of
// butterfly j, y_r = sum_s v[s] w_p^(r s), with w_p^(r s) = w_N^((N/p)
// ((r s) mod p)), the index carried exactly as an integer.
template <bool SH, bool ODD>
__device__ void fft_stage_prime(const float2* src, float2* dst, const float* seg,
                                const float* win, int hop, const float2* tw,
                                const MelArgs& a, int Ns, int nf, int p) {
  const int N = a.N, NR = N / p;
  for (int i = threadIdx.x; i < nf * N; i += THREADS) {
    const int f = i / N, o = i - f * N;
    const int r = o / NR, j = o - r * NR;
    const int k = j % Ns;
    const int step = k * (N / (Ns * p));   // the stage twiddle's index step
    float2 acc = make_float2(0.f, 0.f);
    int m = 0;                             // (r s) mod p
    for (int s = 0; s < p; ++s) {
      const float2 v = stage_in<SH, ODD>(src, seg, win, hop, tw, a, f,
                                          j + s * NR, s * step);
      const float2 w = tab<SH>(tw + (ODD ? 1 : 2) * NR * m);
      acc.x = fmaf(v.x, w.x, fmaf(-v.y, w.y, acc.x));
      acc.y = fmaf(v.x, w.y, fmaf(v.y, w.x, acc.y));
      m += r;
      if (m >= p) m -= p;
    }
    dst[f * N + (j / Ns) * Ns * p + k + r * Ns] = acc;
  }
}

// One item: frames [f0, f0 + fpb) of wav row ``row``, from the segment copy
// to the log-mel stores.
template <bool SH, bool ODD>
__device__ __forceinline__ void mel_item(const MelArgs& a, int row, int f0,
                                         float2* bufA, float2* bufB,
                                         const float2* tw, const float* win,
                                         float* seg) {
  const int N = a.N, n_fft = a.n_fft, F = a.F;
  const int tid = threadIdx.x;
  const int nf = min(a.fpb, F - f0);
  int hop = a.hop0, end = a.end0;
  if (a.hops != nullptr) {
    hop = a.hops[row];                    // the wrapper bounds it by hop_max
    end = hop * (F - 1) - 1;
  }
  const int seg_len = (nf - 1) * hop + n_fft;
  const float* x = a.wav + (int64_t)row * a.S;
  const int start = f0 * hop - a.left;
  for (int i = tid; i < seg_len; i += THREADS) {
    int j = min(start + i, a.jmax);       // the static path's last padded sample
    j = j < 0 ? -j : j;                   // left reflection: -k -> k
    if (j > end) j = 2 * end - j;         // right reflection about end
    j = min(max(j, 0), a.S - 1);
    seg[i] = x[j];
  }
  __syncthreads();

  // the stages, in fft_plan's order; the first reads the windowed
  // segment. A radix-2 first stage is called on its own, with src null at
  // compile time, so a power of two keeps the arithmetic (and the fp32
  // roundings) of the radix-2/4 walk this one generalises.
  const float2* src = nullptr;
  float2* dst = bufA;
  int Ns = 1, st = 0;
  if (a.nrad > 0 && a.rad[0] == 2) {
    fft_stage<2, SH, ODD>(nullptr, dst, seg, win, hop, tw, a, Ns, nf);
    Ns = 2;
    src = dst;
    dst = bufB;
    st = 1;
    __syncthreads();
  }
  for (; st < max(a.nrad, 1); ++st) {
    const int R = a.nrad ? a.rad[st] : 1;
    switch (R) {
      case 2: fft_stage<2, SH, ODD>(src, dst, seg, win, hop, tw, a, Ns, nf); break;
      case 3: fft_stage<3, SH, ODD>(src, dst, seg, win, hop, tw, a, Ns, nf); break;
      case 4: fft_stage<4, SH, ODD>(src, dst, seg, win, hop, tw, a, Ns, nf); break;
      case 5: fft_stage<5, SH, ODD>(src, dst, seg, win, hop, tw, a, Ns, nf); break;
      default:
        fft_stage_prime<SH, ODD>(src, dst, seg, win, hop, tw, a, Ns, nf, R);
    }
    Ns *= R;
    src = dst;
    dst = dst == bufA ? bufB : bufA;
    __syncthreads();
  }

  // the power of the weighed bins (even n_fft: through the real split),
  // into the other buffer
  const float2* Z = src;
  float* power = reinterpret_cast<float*>(dst);       // [fpb][nb]
  const int nb = a.bin_hi - a.bin_lo;
  for (int i = tid; i < nf * nb; i += THREADS) {
    const int f = i / nb, k = a.bin_lo + i - f * nb;
    float re, im;
    if constexpr (ODD) {
      const float2 z = Z[f * N + k];
      re = z.x;
      im = z.y;
    } else {
      const float2 u = Z[f * N + k % N];
      const float2 c = Z[f * N + (N - k) % N];     // conj taken below
      // Xe = (u + c*) / 2, Xo = -i (u - c*) / 2
      const float xe_r = 0.5f * (u.x + c.x), xe_i = 0.5f * (u.y - c.y);
      const float xo_r = 0.5f * (u.y + c.y), xo_i = -0.5f * (u.x - c.x);
      const float2 e = tab<SH>(tw + k);
      re = xe_r + (e.x * xo_r - e.y * xo_i);
      im = xe_i + (e.x * xo_i + e.y * xo_r);
    }
    power[f * nb + (k - a.bin_lo)] = re * re + im * im;
  }
  __syncthreads();

  // mel[f, m] = sum over band m's bins of power * weight; one owner each
  for (int o = tid; o < nf * a.n_mels; o += THREADS) {
    const int f = o / a.n_mels, m = o - f * a.n_mels;
    const int lo = a.band_lo[m], hi = a.band_hi[m];
    const float* pw = power + f * nb - a.bin_lo;
    const float* wm = a.fbw + (int64_t)m * a.width - lo;
    float acc = 0.f;
    for (int k = lo; k < hi; ++k) acc = fmaf(pw[k], __ldg(wm + k), acc);
    const float v = logf(acc + a.log_eps);
    const int64_t dst_i = ((int64_t)row * F + f0 + f) * a.n_mels + m;
    if (a.out_bf16)
      reinterpret_cast<__nv_bfloat16*>(a.out)[dst_i] = __float2bfloat16(v);
    else
      reinterpret_cast<float*>(a.out)[dst_i] = v;
  }
}

template <bool SH, bool ODD>
__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const __grid_constant__ MelArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, n_fft = a.n_fft;
  if constexpr (SH) {
    // one block per (row, frame group), everything in shared memory
    float2* bufA = reinterpret_cast<float2*>(smem);      // [fpb][N]
    float2* bufB = bufA + a.fpb * N;                     // [fpb][N]
    float2* tws = bufB + a.fpb * N;                      // [n_fft]
    float* wins = reinterpret_cast<float*>(tws + n_fft); // [n_fft]
    for (int i = threadIdx.x; i < n_fft; i += THREADS) {
      tws[i] = a.twid[i];
      wins[i] = a.window[i];
    }
    mel_item<SH, ODD>(a, blockIdx.x, blockIdx.y * a.fpb, bufA, bufB, tws,
                      wins, wins + n_fft);
  } else {
    // one frame an item; the block's own two buffers in device memory, the
    // grid walking the (row, frame) pairs
    float2* bufA = a.work + (int64_t)blockIdx.x * 2 * N;
    for (int64_t item = blockIdx.x; item < (int64_t)a.n_rows * a.F;
         item += gridDim.x) {
      mel_item<SH, ODD>(a, (int)(item / a.F), (int)(item % a.F), bufA,
                        bufA + N, a.twid, a.window, smem);
      __syncthreads();                      // the next item reuses the buffers
    }
  }
}

}  // namespace

// jmax: the largest sample index a frame reads before reflection (the
// static path: the reflect-padded row's last, S - 1 + left, where an odd
// n_fft's last frame would read one past it; the per-row hop: none);
// radices: n_radices ints on the host (melspec.py fft_radices), their
// product the FFT's N; fpb frames a block; shared 1 to keep the FFT
// buffers, twiddles and window in shared memory, 0 to keep them in device
// memory (fpb 1): then work holds work_blocks blocks' two N-point complex
// buffers and a grid of that many blocks walks the frames; smem the
// block's bytes as melspec.py mel_smem gives them, recomputed here: a
// mismatch is refused.
extern "C" int m3f_log_mel(const void* wav, int n_rows, int S, int F,
                           const void* hops, int hop0, int end0, int left,
                           int jmax, int hop_max, const void* window, const void* twid,
                           const void* radices, int n_radices,
                           const void* band_lo, const void* band_hi,
                           const void* fbw, int width, int bin_lo, int bin_hi,
                           int n_fft, int n_mels, float log_eps, int fpb,
                           int shared, int smem_bytes, void* work,
                           int work_blocks, void* out, int out_bf16,
                           void* stream) {
  if (n_rows <= 0 || F <= 0) return 0;
  MelArgs a;
  a.N = n_fft % 2 ? n_fft : n_fft / 2;
  if (n_fft < 1 || n_radices < 0 || n_radices > MAX_RADICES || hop_max < 1 ||
      (fpb != 1 && fpb != 2 && fpb != 4 && fpb != 8) || bin_lo < 0 ||
      bin_hi > n_fft / 2 + 1 || bin_hi < bin_lo)
    return (int)cudaErrorInvalidValue;
  const int groups = (F + fpb - 1) / fpb;
  if (shared ? groups > 65535
             : fpb != 1 || work == nullptr || work_blocks < 1 ||
                   work_blocks > (int64_t)n_rows * F)
    return (int)cudaErrorInvalidValue;
  int prod = 1;
  for (int i = 0; i < n_radices; ++i) {
    const int r = static_cast<const int*>(radices)[i];
    if (r < 2 || a.N % (prod * r)) return (int)cudaErrorInvalidValue;
    a.rad[i] = r;
    prod *= r;
  }
  if (prod != a.N) return (int)cudaErrorInvalidValue;
  const size_t smem = mel_smem(n_fft, a.N, fpb, F < fpb ? F : fpb, hop_max, shared);
  if (smem != (size_t)smem_bytes || smem > (size_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  a.wav = (const float*)wav;
  a.n_rows = n_rows;
  a.S = S;
  a.F = F;
  a.hops = (const int*)hops;
  a.hop0 = hop0;
  a.end0 = end0;
  a.left = left;
  a.jmax = jmax;
  a.window = (const float*)window;
  a.twid = (const float2*)twid;
  a.band_lo = (const int*)band_lo;
  a.band_hi = (const int*)band_hi;
  a.fbw = (const float*)fbw;
  a.width = width;
  a.bin_lo = bin_lo;
  a.bin_hi = bin_hi;
  a.n_fft = n_fft;
  a.n_mels = n_mels;
  a.fpb = fpb;
  a.log_eps = log_eps;
  a.work = (float2*)work;
  a.out = out;
  a.out_bf16 = out_bf16;
  a.nrad = n_radices;
  void (*kern)(const MelArgs) =
      n_fft % 2 ? (shared ? &log_mel_kernel<true, true>
                          : &log_mel_kernel<false, true>)
                : (shared ? &log_mel_kernel<true, false>
                          : &log_mel_kernel<false, false>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid = shared ? dim3(n_rows, groups) : dim3(work_blocks);
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
