// Fused conv + BatchNorm forward units for fp32 activations.
//
// Replaces: m3f/pytorch_tpu/ops/pallas/conv_bn.py _spatial_fwd (kernel
// _spatial_fwd_kernel, pallas_call at :192) and _temporal_fwd
// (_temporal_fwd_kernel, :250) when x is fp32 (model.compute_dtype =
// "float32"): the Pallas kernels run in the dtype of x, and
// tests/test_conv_bn_fused.py holds them in fp32. conv_bn.cu keeps the bf16
// units.
//
// One unit:
//   prologue:  x^ = relu(f32(f32(x * inv) + shift))   (previous BN + ReLU,
//                                                     optional; two
//                                                     roundings, as XLA)
//   conv:      y  = x^ (*) W   (1,3,3) "spatial" or (3,1,1) "temporal",
//                              stride 1, zero padding 1 (the padding is x^ =
//                              0, not the prologue of 0), fp32 FMA
//   epilogue:  s1 = sum y, s2 = sum y^2 per output channel, fp32, over the
//              emitted y
//
// Bound on an H100: operations. As an implicit GEMM over the M = B*T*H*W
// positions with K = 9*Ci (spatial) or 3*Ci (temporal) taps x channels, the
// unit does 2*K*Co FLOP per position on (Ci + Co)*4 bytes: at the serving
// stage-1 spatial unit (Ci 64 -> Co 144) ~200 FLOP per byte, far above the
// ~20 at which the fp32 CUDA cores (67 TFLOP/s; the reference is fp32, so
// no TF32 and no tensor cores) and not memory (3.35 TB/s) set the floor.
//
// Design (simple and right first; a faster design is later work):
// - A block owns a tile of 64 positions x 64 output channels, 256 threads,
//   each 4 positions x 4 channels in registers. It walks K in chunks of 16
//   input channels of one tap: the x^ chunk [16][64] (formed at the gather:
//   the neighbour's x through the prologue, 0 where the tap falls in the
//   padding or past Ci) and the filter chunk [16][64] go through shared
//   memory, the next chunk's loads held in registers while the products of
//   the current one run. Forming x^ again for each of the 9 (3) taps costs
//   2 FLOP per element and tap against 2*Co of products, so the gather does
//   not stage x^ rows once for all taps; the neighbours' rows come from L1
//   and L2.
// - A block walks a contiguous range of position tiles (the grid's y) for
//   one output-channel tile (the grid's x, fastest, so the blocks that read
//   the same x run together), adding each tile's y and y^2 to per-thread
//   sums in a fixed order; at the end the 16 position groups are reduced in
//   a fixed order into one partial row per range, and colsum_f32_kernel
//   sums the rows per channel in a fixed order. No atomics: two calls give
//   the same bits.
// - Channel counts are multiples of 8 (the wrapper zero-pads others), so
//   every x, w and y access is a 16-byte vector and a chunk's channels are
//   either all inside or all past C.
//
// Measured times are in PERF.md (chip_smoke.py, phase kernel_conv_f32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // positions per tile
constexpr int BN = 64;        // output channels per tile
constexpr int KC = 16;        // input channels per chunk
constexpr int THREADS = 256;

struct F32FwdArgs {
  const float* x;      // [M, Ci]
  const float* w;      // [taps * Ci, Co], row tap * Ci + ci
  const float* inv;    // [Ci] or null
  const float* shift;  // [Ci] or null
  float* y;            // [M, Co]
  float* part1;        // [ranges, Co]
  float* part2;        // [ranges, Co]
  int T, H, W, Ci, Co;
  int64_t M;
  int m_tiles, tiles_per_range;
};

// relu(f32(f32(x * inv) + shift)): the _rn intrinsics keep nvcc from
// contracting the two roundings into one fma
__device__ __forceinline__ float prologue(float x, float inv, float shift) {
  return fmaxf(__fadd_rn(__fmul_rn(x, inv), shift), 0.f);
}

// KIND 0: spatial (taps (dh, dw) = (tap / 3 - 1, tap % 3 - 1)); 1: temporal
// (dt = tap - 1)
template <int KIND, bool AFFINE>
__global__ void __launch_bounds__(THREADS)
conv_f32_kernel(const F32FwdArgs a) {
  __shared__ __align__(16) float As[KC][BM];
  __shared__ __align__(16) float Bs[KC][BN];
  __shared__ float red1[16][BN], red2[16][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;       // compute: channels, positions
  const int lp = tid / 4, lc = (tid % 4) * 4;   // x gather: position, channels
  const int lk = tid / 16, ln = (tid % 16) * 4; // w load: k row, channels
  const int n0 = blockIdx.x * BN;
  const int taps = KIND == 0 ? 9 : 3;
  const int nck = (a.Ci + KC - 1) / KC;
  const int steps = taps * nck;
  const int HW = a.H * a.W;

  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};

  const int t_begin = blockIdx.y * a.tiles_per_range;
  const int t_end = min(a.m_tiles, t_begin + a.tiles_per_range);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int64_t m0 = (int64_t)tile * BM;
    // this thread's gather position, decoded once per tile
    const int64_t gm = m0 + lp;
    const bool gm_ok = gm < a.M;
    int gt = 0, gh = 0, gw = 0;
    if (gm_ok) {
      const int64_t img = gm / HW;
      const int r = (int)(gm - img * HW);
      gh = r / a.W;
      gw = r - gh * a.W;
      gt = (int)(img % a.T);
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    float4 xa, wb;
    auto load = [&](int step) {
      const int tap = step / nck;
      const int c0 = (step - tap * nck) * KC;
      // x^ of the neighbour of position gm at this tap, 4 channels
      xa = make_float4(0.f, 0.f, 0.f, 0.f);
      const int c = c0 + lc;
      if (gm_ok && c < a.Ci) {
        bool ok;
        int64_t src;
        if (KIND == 0) {
          const int dh = tap / 3 - 1, dw = tap % 3 - 1;
          const int hh = gh + dh, ww = gw + dw;
          ok = hh >= 0 && hh < a.H && ww >= 0 && ww < a.W;
          src = gm + (int64_t)dh * a.W + dw;
        } else {
          const int dt = tap - 1;
          const int tt = gt + dt;
          ok = tt >= 0 && tt < a.T;
          src = gm + (int64_t)dt * HW;
        }
        if (ok) {
          xa = *reinterpret_cast<const float4*>(a.x + src * a.Ci + c);
          if (AFFINE) {
            const float4 iv = *reinterpret_cast<const float4*>(a.inv + c);
            const float4 sh = *reinterpret_cast<const float4*>(a.shift + c);
            xa.x = prologue(xa.x, iv.x, sh.x);
            xa.y = prologue(xa.y, iv.y, sh.y);
            xa.z = prologue(xa.z, iv.z, sh.z);
            xa.w = prologue(xa.w, iv.w, sh.w);
          }
        }
      }
      // the filter rows tap * Ci + c0 + lk, channels n0 + ln .. + 3
      wb = make_float4(0.f, 0.f, 0.f, 0.f);
      const int k = c0 + lk;
      if (k < a.Ci && n0 + ln < a.Co)
        wb = *reinterpret_cast<const float4*>(
            a.w + ((int64_t)tap * a.Ci + k) * a.Co + n0 + ln);
    };
    auto store = [&]() {
      As[lc + 0][lp] = xa.x;
      As[lc + 1][lp] = xa.y;
      As[lc + 2][lp] = xa.z;
      As[lc + 3][lp] = xa.w;
      *reinterpret_cast<float4*>(&Bs[lk][ln]) = wb;
    };

    load(0);
    store();
    __syncthreads();
    for (int step = 0; step < steps; ++step) {
      if (step + 1 < steps) load(step + 1);
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
      if (step + 1 < steps) {
        store();
        __syncthreads();
      }
    }

    // epilogue: y, and the tile's share of the sums in a fixed order
    const int n = n0 + tx * 4;
    if (n < a.Co) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t m = m0 + ty * 4 + i;
        if (m < a.M) {
          *reinterpret_cast<float4*>(a.y + m * a.Co + n) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s1[j] = __fadd_rn(s1[j], acc[i][j]);
            s2[j] = __fadd_rn(s2[j], __fmul_rn(acc[i][j], acc[i][j]));
          }
        }
      }
    }
  }

  // the range's partial row: the 16 position groups in order
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red1[ty][tx * 4 + j] = s1[j];
    red2[ty][tx * 4 + j] = s2[j];
  }
  __syncthreads();
  if (tid < BN && n0 + tid < a.Co) {
    float b1 = 0.f, b2 = 0.f;
    for (int g = 0; g < 16; ++g) {
      b1 += red1[g][tid];
      b2 += red2[g][tid];
    }
    a.part1[(int64_t)blockIdx.y * a.Co + n0 + tid] = b1;
    a.part2[(int64_t)blockIdx.y * a.Co + n0 + tid] = b2;
  }
}

// s[c] = sum over rows r of part[r, c], in a fixed order
__global__ void __launch_bounds__(1024)
colsum_f32_kernel(const float* __restrict__ part1,
                  const float* __restrict__ part2, int R, int C,
                  float* __restrict__ s1, float* __restrict__ s2) {
  __shared__ float sh1[32][33], sh2[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  float a1 = 0.f, a2 = 0.f;
  if (c < C) {
    for (int r = ty; r < R; r += 32) {
      a1 += part1[(int64_t)r * C + c];
      a2 += part2[(int64_t)r * C + c];
    }
  }
  sh1[ty][tx] = a1;
  sh2[ty][tx] = a2;
  __syncthreads();
  if (ty == 0 && c < C) {
    float b1 = 0.f, b2 = 0.f;
    for (int i = 0; i < 32; ++i) {
      b1 += sh1[i][tx];
      b2 += sh2[i][tx];
    }
    s1[c] = b1;
    s2[c] = b2;
  }
}

}  // namespace

// Forward unit, fp32. x [B, T, H, W, Ci], wk [taps * Ci, Co] (taps 9 for
// kind 0 spatial, 3 for kind 1 temporal), inv / shift [Ci] or both null,
// y [B, T, H, W, Co], s1 / s2 [Co], part a scratch of 2 * ranges * Co
// floats, ranges = ceil(ceil(M / 64) / per); all fp32, contiguous, Ci and Co
// multiples of 8. Returns a cudaError_t.
extern "C" int m3f_conv_unit_fwd_f32(const void* x, const void* wk,
                                     const void* inv, const void* shift,
                                     void* y, void* s1, void* s2, void* part,
                                     int kind, int B, int T, int H, int W,
                                     int Ci, int Co, int per, void* stream) {
  const int64_t M = (int64_t)B * T * H * W;
  if ((kind != 0 && kind != 1) || per < 1) return (int)cudaErrorInvalidValue;
  if (M == 0 || Co == 0) return 0;
  if (Ci % 8 != 0 || Co % 8 != 0 || Ci == 0 || (inv == nullptr) != (shift == nullptr))
    return (int)cudaErrorInvalidValue;
  const int64_t m_tiles = (M + BM - 1) / BM;
  if (m_tiles >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  F32FwdArgs a{};
  a.x = (const float*)x;
  a.w = (const float*)wk;
  a.inv = (const float*)inv;
  a.shift = (const float*)shift;
  a.y = (float*)y;
  a.T = T;
  a.H = H;
  a.W = W;
  a.Ci = Ci;
  a.Co = Co;
  a.M = M;
  a.m_tiles = (int)m_tiles;
  a.tiles_per_range = per;
  const int ranges = (int)((m_tiles + per - 1) / per);
  if (ranges > 65535) return (int)cudaErrorInvalidValue;
  a.part1 = (float*)part;
  a.part2 = (float*)part + (int64_t)ranges * Co;
  const dim3 grid((Co + BN - 1) / BN, ranges);
  const bool affine = inv != nullptr;
  if (kind == 0) {
    if (affine)
      conv_f32_kernel<0, true><<<grid, THREADS, 0, s>>>(a);
    else
      conv_f32_kernel<0, false><<<grid, THREADS, 0, s>>>(a);
  } else {
    if (affine)
      conv_f32_kernel<1, true><<<grid, THREADS, 0, s>>>(a);
    else
      conv_f32_kernel<1, false><<<grid, THREADS, 0, s>>>(a);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  colsum_f32_kernel<<<(Co + 31) / 32, dim3(32, 32), 0, s>>>(
      a.part1, a.part2, ranges, Co, (float*)s1, (float*)s2);
  return (int)cudaGetLastError();
}
