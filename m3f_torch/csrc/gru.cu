// GRU recurrence over pre-projected inputs, both directions in one launch.
//
// Replaces: m3f/pytorch_tpu/ops/pallas/gru_pallas.py gru_scan_pallas
//           (kernel body _gru_kernel), and the lax.scan step of
//           models/gru.py BiGRU.apply that it stands in for.
//
//   hp = round_W(h_W @ W_hh) + b_hh            (h_W: h rounded to W's dtype)
//   r = sigmoid(x_r + hp_r), z = sigmoid(x_z + hp_z)
//   n = tanh(x_n + r * hp_n)                  (b_hn inside the r-product)
//   h' = (1 - z) * n + z * h                  (h carried in fp32)
//
// round_W is the identity for fp32 W_hh (the Pallas kernel's numerics) and a
// round to bf16 for bf16 W_hh (the XLA scan's bf16 dot product).
//
// Bound on an H100: neither bytes nor operations but the chain of T
// dependent steps. Each step reads all of W_hh (H x 3H: 384 KB in bf16,
// 768 KB in fp32 at H = 256), which does not fit one block's 227 KB of
// shared memory, so this simple kernel streams it from L2 every step; the
// per-SM L2 rate times T is the floor this design can reach. Keeping W_hh
// resident, split over a thread-block cluster, is later work.
//
// Design: grid (direction, batch tile of BT sequences); block (256, KS=2):
// thread (j, ks) owns hidden unit j and half of the reduction over k, for
// the three gate columns j, H+j, 2H+j of BT sequences (3*BT fp32
// accumulators), reading W_hh rows coalesced across j and h from shared
// memory (broadcast). The two halves meet in shared memory, the gate math
// runs in fp32, and h is double-buffered in shared memory (fp32, plus a copy
// rounded to W's dtype for the product). The backward direction reads the
// input at the reversed time index and writes its output in time order, so
// nothing is flipped in memory; the output is [B, T, D, H], i.e. the
// directions' concatenation. For training, the kernel also writes the fp32
// carry h of every step ([B, T, D, H], optional): the backward recurrence
// (BPTT, in PyTorch ops) needs the carry the forward kept, and recomputing it
// from the rounded output would differ.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int JT = 256;   // hidden units per pass (blockDim.x)
constexpr int KS = 2;     // k-split (blockDim.y)
constexpr int BT = 4;     // sequences per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <typename WT> __device__ __forceinline__ float round_w(float v) {
  return to_f(from_f<WT>(v));
}
__device__ __forceinline__ float sigmoid_f(float v) { return 1.f / (1.f + expf(-v)); }

template <typename XT, typename WT>
__global__ void __launch_bounds__(JT * KS)
gru_kernel(const XT* __restrict__ xp, const WT* __restrict__ whh,
           const float* __restrict__ bhh, XT* __restrict__ out,
           float* __restrict__ hs, int B, int T, int H, int D) {
  extern __shared__ float smem[];
  float* h = smem;                 // [BT][H] fp32 state
  float* hw = h + BT * H;          // [BT][H] state rounded to W's dtype
  float* hn = hw + BT * H;         // [BT][H] next state
  float* red = hn + BT * H;        // [3][BT][JT] partial sums of ks = 1

  const int d = blockIdx.x;
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  const int tx = threadIdx.x, ks = threadIdx.y;
  const int tid = ks * JT + tx;
  const int H3 = 3 * H;
  const WT* w = whh + (int64_t)d * H * H3;
  const float* bias = bhh + (int64_t)d * H3;
  const bool reverse = (d == 1);
  const int khalf = (H + KS - 1) / KS;
  const int kbeg = ks * khalf, kend = min(H, kbeg + khalf);

  for (int i = tid; i < BT * H; i += JT * KS) h[i] = hw[i] = 0.f;
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    for (int j0 = 0; j0 < H; j0 += JT) {
      const int j = j0 + tx;
      float ar[BT], az[BT], an[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) ar[b] = az[b] = an[b] = 0.f;
      if (j < H) {
#pragma unroll 8
        for (int k = kbeg; k < kend; ++k) {
          const WT* wr = w + (int64_t)k * H3 + j;
          const float wr_r = to_f(wr[0]), wr_z = to_f(wr[H]), wr_n = to_f(wr[2 * H]);
#pragma unroll
          for (int b = 0; b < BT; ++b) {
            const float hv = hw[b * H + k];
            ar[b] = fmaf(hv, wr_r, ar[b]);
            az[b] = fmaf(hv, wr_z, az[b]);
            an[b] = fmaf(hv, wr_n, an[b]);
          }
        }
      }
      if (ks == 1) {
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          red[(0 * BT + b) * JT + tx] = ar[b];
          red[(1 * BT + b) * JT + tx] = az[b];
          red[(2 * BT + b) * JT + tx] = an[b];
        }
      }
      __syncthreads();
      if (ks == 0 && j < H) {
        const float bh_r = bias[j], bh_z = bias[H + j], bh_n = bias[2 * H + j];
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          if (b >= nb) break;
          const float hp_r = round_w<WT>(ar[b] + red[(0 * BT + b) * JT + tx]) + bh_r;
          const float hp_z = round_w<WT>(az[b] + red[(1 * BT + b) * JT + tx]) + bh_z;
          const float hp_n = round_w<WT>(an[b] + red[(2 * BT + b) * JT + tx]) + bh_n;
          const XT* x = xp + (((int64_t)(b0 + b) * T + t) * D + d) * H3;
          const float r = sigmoid_f(to_f(x[j]) + hp_r);
          const float z = sigmoid_f(to_f(x[H + j]) + hp_z);
          const float n = tanhf(to_f(x[2 * H + j]) + r * hp_n);
          const float hnew = (1.f - z) * n + z * h[b * H + j];
          hn[b * H + j] = hnew;
          const int64_t o = (((int64_t)(b0 + b) * T + t) * D + d) * H + j;
          out[o] = from_f<XT>(hnew);
          if (hs != nullptr) hs[o] = hnew;
        }
      }
      __syncthreads();
    }
    for (int i = tid; i < BT * H; i += JT * KS) {
      const float v = hn[i];
      h[i] = v;
      hw[i] = round_w<WT>(v);
    }
    __syncthreads();
  }
}

template <typename XT, typename WT>
int launch(const void* xp, const void* whh, const void* bhh, void* out,
           float* hs, int B, int T, int H, int D, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * BT * H + 3 * BT * JT);
  cudaError_t e = cudaFuncSetAttribute(
      gru_kernel<XT, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(D, (B + BT - 1) / BT), block(JT, KS);
  gru_kernel<XT, WT><<<grid, block, smem, stream>>>(
      (const XT*)xp, (const WT*)whh, (const float*)bhh, (XT*)out, hs, B, T, H,
      D);
  return (int)cudaGetLastError();
}

}  // namespace

// xp [B, T, D, 3H] (x@W_ih + b_ih), whh [D, H, 3H], bhh [D, 3H] fp32,
// out [B, T, D, H]; hs [B, T, D, H] fp32 carries or null; direction 1 of
// D = 2 runs in reverse time.
extern "C" int m3f_gru_fwd(const void* xp, const void* whh, const void* bhh,
                           void* out, void* hs, int B, int T, int H, int D,
                           int x_bf16, int w_bf16, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (D < 1 || D > 2 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16 && w_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(xp, whh, bhh, out, (float*)hs, B, T, H, D, s);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(xp, whh, bhh, out, (float*)hs, B, T, H, D, s);
  if (w_bf16) return (int)cudaErrorInvalidValue;  // W_hh is x's dtype or fp32
  return launch<float, float>(xp, whh, bhh, out, (float*)hs, B, T, H, D, s);
}
