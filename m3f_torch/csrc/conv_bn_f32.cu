// Fused conv + BatchNorm units for fp32 activations: the forward and both
// halves of the backward.
//
// Replaces, when x is fp32 (model.compute_dtype = "float32"; the Pallas
// kernels run in the dtype of x, and tests/test_conv_bn_fused.py holds them
// in fp32), in m3f/pytorch_tpu/ops/pallas/conv_bn.py:
//   spatial_fwd_f32_kernel  _spatial_fwd (_spatial_fwd_kernel, pallas_call
//                           at :192): a row walk (its own section below)
//   temporal_fwd_f32_kernel _temporal_fwd (_temporal_fwd_kernel, :250): a
//                           frame walk (its own section below)
//   conv_f32_kernel         _spatial_fwd where no row-walk layout fits the
//                           images (rows of a few hundred pixels)
//   spatial_data_f32_kernel _spatial_bwd's data gradient
//                           (_spatial_bwd_data_kernel, :537): a row walk (its
//                           own section below), with a K split summed by
//                           data_split_sum_f32_kernel where M is short
//   temporal_data_f32_kernel _temporal_bwd's data gradient
//                           (_temporal_bwd_data_kernel, :612): a frame walk
//                           (its own section below)
//   bwd_data_f32_kernel     _spatial_bwd's data gradient where no row-walk
//                           layout fits the images
//   spatial_filter_f32_kernel _spatial_bwd's filter gradient
//                           (_spatial_bwd_filter_kernel, :554): a row walk
//                           (its own section below), after fold_f32_kernel
//                           folds ge once
//   temporal_filter_f32_kernel _temporal_bwd's filter gradient
//                           (_temporal_bwd_filter_kernel, :625): a frame
//                           walk (its own section below)
//   bwd_filter_f32_kernel   _spatial_bwd's filter gradient where no row-walk
//                           layout fits the images
// conv_bn.cu keeps the bf16 units.
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
// Its backward, from the cotangents (gy, gs1, gs2) folded into
//   ge = f32(gy + f32(gs1 + f32(f32(2 y) * gs2)))   (_gy_eff, each op rounded)
// which is 0 in the padding (not gs1: the reference zeroes the border):
//   data:      dx^ = ge (*) W mirrored and transposed [Co -> Ci], stride 1,
//              pad 1; with the prologue xa = f32(f32(x * inv) + shift),
//              dxa = xa > 0 ? dx^ : 0, dx = f32(dxa * inv), and per input
//              channel dinv = sum x * dxa, dshift = sum dxa; without it
//              dx = dx^
//   filter:    dw[tap * Ci + ci, co] = sum_m x^[neighbour(m, tap), ci] *
//              ge[m, co], fp32, x^ 0 in the padding
//
// Bound on an H100: operations. Each of the three is an implicit GEMM over
// the M = B*T*H*W positions with K = taps x channels, 2*K*N FLOP per
// position on (Ci + Co)*4 bytes (the backward reads gy and y, 8*Co): at the
// stage-1 spatial unit (Ci 64, Co 144) ~200 FLOP per byte or more, far above
// the ~20 at which the fp32 CUDA cores (67 TFLOP/s; the reference is fp32,
// so no TF32 and no tensor cores) and not memory (3.35 TB/s) set the floor.
//
// Design of the per-tap gathers (simple and right first; the forward's row
// and frame walks, the spatial gradients' row walks and the temporal
// gradients' frame walks are the redesigns, described above their code). Every
// gather kernel is a block of 256 threads owning a 64 x 64 tile, each
// thread 4 x 4 sums in registers, K walked in chunks of 16 through shared
// memory, the next chunk's loads held in registers while the products of
// the current one run; channel counts are multiples of 8 (the wrapper zero-pads
// others), so every access is a 16-byte vector and a chunk's channels are
// either all inside or all past C. No atomics: two calls give the same bits.
// - conv_f32_kernel (spatial only): 64 positions x 64 output channels; K =
//   9 x Ci in chunks of 16 input channels of one tap, the x^ chunk formed at
//   the gather (the neighbour's x through the prologue, 0 in the padding or
//   past Ci), again for each of the 9 taps; the neighbours' rows come from
//   L1 and L2 (with 64-channel N tiles, what the row walk takes out). A
//   block walks a
//   contiguous range of position tiles (the grid's y) for one output-channel
//   tile (the grid's x, fastest, so the blocks that read the same x run
//   together), adding each tile's y and y^2 to per-thread sums in a fixed
//   order; at the end the 16 position groups are reduced in a fixed order
//   into one partial row per range, and colsum_f32_kernel sums the rows per
//   channel in a fixed order.
// - bwd_data_f32_kernel (the spatial kind's images too wide for the row
//   walk): the same walk with the roles of the
//   channels swapped: 64 positions x 64 input channels, K = 9 x Co in
//   chunks of 16 output channels of one tap, the ge chunk formed at the
//   gather from gy, y, gs1 and gs2 at the neighbour (0 in the padding and
//   past Co), the filter chunk read from [taps * Co, Ci] with the taps
//   mirrored (the wrapper lays it out). The epilogue applies the mask and
//   inv, and the partial rows of dinv / dshift go through colsum_f32_kernel
//   as s1 / s2 do.
// - bwd_filter_f32_kernel (the spatial kind's images too wide for the row
//   walk): 64 rows of K = 9 x Ci x 64 output
//   channels of dw over a slice of the positions, walked in chunks of 16
//   positions: x^ formed at the gather (4 rows of one tap a thread, fixed
//   for the block), ge at the load. A slice writes one partial [K, Co] (or
//   dw itself when there is one slice), and slice_sum_f32_kernel sums the
//   partials in slice order.
//
// Measured times are in PERF.md (chip_smoke.py, phases kernel_conv_f32 and
// kernel_conv_f32_bwd; m3f_torch/scripts/filter_sweep.py --kind
// spatial_fwd_f32 / temporal_fwd_f32 / spatial_filter_f32 / spatial_data_f32
// / temporal_data_f32 / temporal_filter_f32 for the walks' layouts and
// ablations).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // positions (filter gradient: K rows) per tile
constexpr int BN = 64;        // output (data gradient: input) channels per tile
constexpr int KC = 16;        // channels (filter gradient: positions) per chunk
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

struct F32BwdDataArgs {
  const float* gy;     // [M, Co]
  const float* y;      // [M, Co]
  const float* gs1;    // [Co]
  const float* gs2;    // [Co]
  const float* wt;     // [taps * Co, Ci], row tap * Co + co = W[taps-1-tap, ci, co]
  const float* x;      // [M, Ci] or null (no prologue)
  const float* inv;    // [Ci] or null
  const float* shift;  // [Ci] or null
  float* dx;           // [M, Ci]
  float* part1;        // [ranges, Ci]: dinv's partial rows
  float* part2;        // [ranges, Ci]: dshift's
  int T, H, W, Ci, Co;
  int64_t M;
  int m_tiles, tiles_per_range;
};

struct F32BwdFilterArgs {
  const float* x;      // [M, Ci]
  const float* gy;     // [M, Co]
  const float* y;      // [M, Co]
  const float* gs1;    // [Co]
  const float* gs2;    // [Co]
  const float* inv;    // [Ci] or null
  const float* shift;  // [Ci] or null
  float* out;          // [slices, 9 * Ci, Co]: partials, or dw (one slice)
  int T, H, W, Ci, Co;
  int64_t M;
  int chunks, chunks_per_slice;
};

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// relu(f32(f32(x * inv) + shift)): the _rn intrinsics keep nvcc from
// contracting the two roundings into one fma
__device__ __forceinline__ float prologue(float x, float inv, float shift) {
  return fmaxf(__fadd_rn(__fmul_rn(x, inv), shift), 0.f);
}

__device__ __forceinline__ float4 prologue4(float4 x, float4 inv, float4 shift) {
  return make_float4(prologue(x.x, inv.x, shift.x), prologue(x.y, inv.y, shift.y),
                     prologue(x.z, inv.z, shift.z), prologue(x.w, inv.w, shift.w));
}

// the folded cotangent gy + (gs1 + 2 y gs2), each op rounded as _gy_eff is
__device__ __forceinline__ float fold(float gy, float y, float gs1, float gs2) {
  return __fadd_rn(gy, __fadd_rn(gs1, __fmul_rn(__fmul_rn(2.f, y), gs2)));
}

__device__ __forceinline__ float4 fold4(float4 gy, float4 y, float4 gs1,
                                        float4 gs2) {
  return make_float4(fold(gy.x, y.x, gs1.x, gs2.x), fold(gy.y, y.y, gs1.y, gs2.y),
                     fold(gy.z, y.z, gs1.z, gs2.z), fold(gy.w, y.w, gs1.w, gs2.w));
}

// (t, h, w) of position m of [B, T, H, W]
__device__ __forceinline__ void decode(int64_t m, int T, int H, int W, int& t,
                                       int& h, int& w) {
  const int64_t HW = (int64_t)H * W;
  const int64_t img = m / HW;
  const int r = (int)(m - img * HW);
  h = r / W;
  w = r - h * W;
  t = (int)(img % T);
}

// The neighbour of position m (at h, w) that spatial tap reads, (dh, dw) =
// (tap / 3 - 1, tap % 3 - 1). False where it falls in the zero padding.
__device__ __forceinline__ bool neighbour(int64_t m, int h, int w, int tap,
                                          int H, int W, int64_t& src) {
  const int dh = tap / 3 - 1, dw = tap % 3 - 1;
  const int hh = h + dh, ww = w + dw;
  src = m + (int64_t)dh * W + dw;
  return hh >= 0 && hh < H && ww >= 0 && ww < W;
}

// acc[i][j] += A[kk][ty * 4 + i] * B[kk][tx * 4 + j] over the chunk
__device__ __forceinline__ void chunk_products(float (*As)[BM],
                                               float (*Bs)[BN], int tx,
                                               int ty, float (&acc)[4][4]) {
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
}

// The range's partial rows (part1, part2 [ranges, C]) from the per-thread
// sums: the 16 position groups in order
__device__ __forceinline__ void partial_rows(const float (&s1)[4],
                                             const float (&s2)[4],
                                             float (*red1)[BN],
                                             float (*red2)[BN], int n0, int C,
                                             float* part1, float* part2) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red1[ty][tx * 4 + j] = s1[j];
    red2[ty][tx * 4 + j] = s2[j];
  }
  __syncthreads();
  if (tid < BN && n0 + tid < C) {
    float b1 = 0.f, b2 = 0.f;
    for (int g = 0; g < 16; ++g) {
      b1 += red1[g][tid];
      b2 += red2[g][tid];
    }
    part1[(int64_t)blockIdx.y * C + n0 + tid] = b1;
    part2[(int64_t)blockIdx.y * C + n0 + tid] = b2;
  }
}

template <bool AFFINE>
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
  const int taps = 9;
  const int nck = (a.Ci + KC - 1) / KC;
  const int steps = taps * nck;

  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};

  const int t_begin = blockIdx.y * a.tiles_per_range;
  const int t_end = min(a.m_tiles, t_begin + a.tiles_per_range);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int64_t m0 = (int64_t)tile * BM;
    // this thread's gather position, decoded once per tile
    const int64_t gm = m0 + lp;
    const bool gm_ok = gm < a.M;
    int gt = 0, gh = 0, gw = 0;
    if (gm_ok) decode(gm, a.T, a.H, a.W, gt, gh, gw);
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
      xa = zero4();
      const int c = c0 + lc;
      int64_t src;
      if (gm_ok && c < a.Ci &&
          neighbour(gm, gh, gw, tap, a.H, a.W, src)) {
        xa = ld4(a.x + src * a.Ci + c);
        if (AFFINE) xa = prologue4(xa, ld4(a.inv + c), ld4(a.shift + c));
      }
      // the filter rows tap * Ci + c0 + lk, channels n0 + ln .. + 3
      wb = zero4();
      const int k = c0 + lk;
      if (k < a.Ci && n0 + ln < a.Co)
        wb = ld4(a.w + ((int64_t)tap * a.Ci + k) * a.Co + n0 + ln);
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
      chunk_products(As, Bs, tx, ty, acc);
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
  partial_rows(s1, s2, red1, red2, n0, a.Co, a.part1, a.part2);
}

// The spatial data gradient: dx (and the partial rows of dinv / dshift with
// the prologue) over a range of position tiles for one input-channel tile
template <bool AFFINE>
__global__ void __launch_bounds__(THREADS)
bwd_data_f32_kernel(const F32BwdDataArgs a) {
  __shared__ __align__(16) float As[KC][BM];
  __shared__ __align__(16) float Bs[KC][BN];
  __shared__ float red1[AFFINE ? 16 : 1][BN], red2[AFFINE ? 16 : 1][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;       // compute: channels, positions
  const int lp = tid / 4, lc = (tid % 4) * 4;   // ge gather: position, channels
  const int lk = tid / 16, ln = (tid % 16) * 4; // w load: k row, channels
  const int n0 = blockIdx.x * BN;               // input channels
  const int taps = 9;
  const int nck = (a.Co + KC - 1) / KC;
  const int steps = taps * nck;

  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};

  const int t_begin = blockIdx.y * a.tiles_per_range;
  const int t_end = min(a.m_tiles, t_begin + a.tiles_per_range);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int64_t m0 = (int64_t)tile * BM;
    const int64_t gm = m0 + lp;
    const bool gm_ok = gm < a.M;
    int gt = 0, gh = 0, gw = 0;
    if (gm_ok) decode(gm, a.T, a.H, a.W, gt, gh, gw);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    float4 ga, wb;
    auto load = [&](int step) {
      const int tap = step / nck;
      const int c0 = (step - tap * nck) * KC;
      // ge of the neighbour of position gm at this tap (the filter's tap is
      // the mirror), 4 output channels; 0 in the padding
      ga = zero4();
      const int c = c0 + lc;
      int64_t src;
      if (gm_ok && c < a.Co &&
          neighbour(gm, gh, gw, tap, a.H, a.W, src))
        ga = fold4(ld4(a.gy + src * a.Co + c), ld4(a.y + src * a.Co + c),
                   ld4(a.gs1 + c), ld4(a.gs2 + c));
      // the mirrored filter's rows tap * Co + c0 + lk, input channels
      // n0 + ln .. + 3
      wb = zero4();
      const int k = c0 + lk;
      if (k < a.Co && n0 + ln < a.Ci)
        wb = ld4(a.wt + ((int64_t)tap * a.Co + k) * a.Ci + n0 + ln);
    };
    auto store = [&]() {
      As[lc + 0][lp] = ga.x;
      As[lc + 1][lp] = ga.y;
      As[lc + 2][lp] = ga.z;
      As[lc + 3][lp] = ga.w;
      *reinterpret_cast<float4*>(&Bs[lk][ln]) = wb;
    };

    load(0);
    store();
    __syncthreads();
    for (int step = 0; step < steps; ++step) {
      if (step + 1 < steps) load(step + 1);
      chunk_products(As, Bs, tx, ty, acc);
      __syncthreads();
      if (step + 1 < steps) {
        store();
        __syncthreads();
      }
    }

    // epilogue: the mask and inv, dx, and the tile's share of dinv / dshift
    const int n = n0 + tx * 4;
    if (n < a.Ci) {
      float iv[4] = {0.f, 0.f, 0.f, 0.f}, sh[4] = {0.f, 0.f, 0.f, 0.f};
      if (AFFINE) {
        const float4 i4 = ld4(a.inv + n), s4 = ld4(a.shift + n);
        iv[0] = i4.x; iv[1] = i4.y; iv[2] = i4.z; iv[3] = i4.w;
        sh[0] = s4.x; sh[1] = s4.y; sh[2] = s4.z; sh[3] = s4.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t m = m0 + ty * 4 + i;
        if (m < a.M) {
          float d[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
          if (AFFINE) {
            const float4 x4 = ld4(a.x + m * a.Ci + n);
            const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float xa = __fadd_rn(__fmul_rn(xv[j], iv[j]), sh[j]);
              const float dxa = xa > 0.f ? d[j] : 0.f;
              d[j] = __fmul_rn(dxa, iv[j]);
              s1[j] = __fadd_rn(s1[j], __fmul_rn(xv[j], dxa));
              s2[j] = __fadd_rn(s2[j], dxa);
            }
          }
          *reinterpret_cast<float4*>(a.dx + m * a.Ci + n) =
              make_float4(d[0], d[1], d[2], d[3]);
        }
      }
    }
  }
  if constexpr (AFFINE)
    partial_rows(s1, s2, red1, red2, n0, a.Ci, a.part1, a.part2);
}

// The spatial filter gradient: one 64 x 64 tile of [9 * Ci, Co] over the
// slice blockIdx.z of the positions, walked in chunks of 16
template <bool AFFINE>
__global__ void __launch_bounds__(THREADS)
bwd_filter_f32_kernel(const F32BwdFilterArgs a) {
  __shared__ __align__(16) float As[KC][BM];    // [position][K row]: x^
  __shared__ __align__(16) float Bs[KC][BN];    // [position][channel]: ge

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;       // compute: channels, K rows
  const int lp = tid / 16, l4 = (tid % 16) * 4; // loads: position, 4 columns
  const int n0 = blockIdx.x * BN;
  const int k0 = blockIdx.y * BM;
  const int K = 9 * a.Ci;
  // this thread's gather rows k0 + l4 .. + 3: one tap, 4 input channels
  // (Ci is a multiple of 8), the same for the whole walk
  const int r = k0 + l4;
  const bool r_ok = r < K;
  const int tap = r_ok ? r / a.Ci : 0;
  const int ci = r - tap * a.Ci;
  float4 iv = zero4(), sh = zero4();
  if (AFFINE && r_ok) {
    iv = ld4(a.inv + ci);
    sh = ld4(a.shift + ci);
  }
  const int co = n0 + l4;
  const bool co_ok = co < a.Co;
  float4 g1 = zero4(), g2 = zero4();
  if (co_ok) {
    g1 = ld4(a.gs1 + co);
    g2 = ld4(a.gs2 + co);
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float4 xa, gb;
  auto load = [&](int chunk) {
    const int64_t m = (int64_t)chunk * KC + lp;
    xa = zero4();
    gb = zero4();
    if (m < a.M) {
      if (r_ok) {
        int t, h, w;
        decode(m, a.T, a.H, a.W, t, h, w);
        int64_t src;
        if (neighbour(m, h, w, tap, a.H, a.W, src)) {
          xa = ld4(a.x + src * a.Ci + ci);
          if (AFFINE) xa = prologue4(xa, iv, sh);
        }
      }
      if (co_ok)
        gb = fold4(ld4(a.gy + m * a.Co + co), ld4(a.y + m * a.Co + co), g1, g2);
    }
  };
  auto store = [&]() {
    *reinterpret_cast<float4*>(&As[lp][l4]) = xa;
    *reinterpret_cast<float4*>(&Bs[lp][l4]) = gb;
  };

  const int c_begin = blockIdx.z * a.chunks_per_slice;
  const int c_end = min(a.chunks, c_begin + a.chunks_per_slice);
  if (c_begin < c_end) {
    load(c_begin);
    store();
    __syncthreads();
    for (int c = c_begin; c < c_end; ++c) {
      if (c + 1 < c_end) load(c + 1);
      chunk_products(As, Bs, tx, ty, acc);
      __syncthreads();
      if (c + 1 < c_end) {
        store();
        __syncthreads();
      }
    }
  }

  const int n = n0 + tx * 4;
  if (n < a.Co) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k0 + ty * 4 + i;
      if (row < K)
        *reinterpret_cast<float4*>(
            a.out + ((int64_t)blockIdx.z * K + row) * a.Co + n) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
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

// out[e] = sum over slices s of part[s, e], in slice order
__global__ void __launch_bounds__(256)
slice_sum_f32_kernel(const float* __restrict__ part, int slices, int64_t E,
                     float* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += stride) {
    float s = 0.f;
    for (int k = 0; k < slices; ++k) s += part[(int64_t)k * E + e];
    out[e] = s;
  }
}

// ---------------------------------------------------------------------------
// The spatial forward: the row walk (spatial_fwd_f32_kernel)
// ---------------------------------------------------------------------------
//
// Replaces _spatial_fwd (m3f/pytorch_tpu/ops/pallas/conv_bn.py, pallas_call
// at :192, kernel _spatial_fwd_kernel at :62) for fp32 x. At the serving
// forward's stage 1 (x [128,16,56,56,64] -> Co 144) a launch is 1.07 TFLOP
// of fp32 FMA on 5.3 GB: 15.9 ms at 67 TFLOP/s against 1.6 ms of memory, so
// the CUDA cores set the floor at every stage. What conv_f32_kernel spends
// beyond the products (x^ gathered and formed again for each of the nine
// taps and each 64-channel N tile, one shared load per two FMA, 33% of the
// columns padding at C_out 144) is what this design takes out.
//
// - Row walk. A block walks a range of whole (b, t) images as one dense
//   stream of output pixels, S = 8 * NPG a step (112 with N tiles of 144,
//   128 with tiles of 128). A step's chunk buffer
//   holds the stream rows from the one above its first pixel to the one
//   below its last (local row 0 upward), with an all-zero row before every
//   image and after the last, and columns 0 and W+1 zero: the conv's
//   padding, never touched by the prologue, so it is 0 AFTER the prologue
//   (relu(shift) is not 0), as the reference's pad-after-prologue. A step
//   may span many rows and several images (W = 7: an image is 49 pixels).
//   A pixel's taps are one base offset (its row above, column w - 1) plus
//   (dh * (W+2) + dw) pixels, the same for every pixel.
// - K inside a step, in chunks of KC input channels (16, or 8 where the
//   16-channel buffers do not fit) for all nine taps: the block copies the
//   step's x rows for the chunk with cp.async into [pixel][KC + 4] (zero
//   filled on the zero rows and past C_in), each thread forms x^ in place
//   once on the vectors it copied, after its own wait_group, with two
//   roundings (__fmul_rn / __fadd_rn: no fused multiply-add), and the
//   filter chunk [9 * KC, NB] streams from the L2 with it. Both are double
//   buffered, one barrier a chunk: x^ is formed once per staged pixel, step
//   and N tile (a step's halo rows twice).
// - FFMA microkernel: a block of NPG x NCG threads, each 8 pixels (pg +
//   NPG i) x 8 output channels (4 at cg * 4, 4 at NB/2 + cg * 4), 64 fp32
//   sums. A is a float4 of 4 channels of one pixel at its tap offset, B a
//   float4 of 4 output channels: 16 LDS.128 per 256 FFMA. Every pixel row
//   of the buffer starts on 16 bytes, and its stride (KC + 4 floats) puts 8
//   neighbouring pixels on distinct banks.
// - N tiles of NB = 144 (C_out 144 / 288 / 576 / 1152, mid_mode "flops") or
//   128 (128 / 256 / 512, "lane"): at stage 1 one tile, x^ formed once for
//   every output channel. Other multiples of 8 take a masked last tile.
// - Epilogue: y leaves from registers in 16-byte stores along the channels
//   (a warp's lanes write one pixel's row); s1 / s2 are per-thread fp32 sums
//   over the walk in a fixed order, then the NPG pixel groups in order into
//   one partial row per range, summed by colsum_f32_kernel. No atomics: two
//   calls give the same bits.
// - Grid: image ranges x N tiles, the N tile fastest (the blocks reading
//   the same x run together), one block a SM. A block is at most 8 warps:
//   9 put three warps on one of the four 16,384-register files and ptxas
//   then caps a thread at 168 registers, where the 64 sums, the A / B
//   vectors and the walk's offsets spill (ptxas wants ~230-255). So N tiles
//   of 144 (18 channel groups) take 14 pixel groups (S = 112, 252
//   threads), tiles of 128 take 16 (S = 128, 256 threads). 112 divides the
//   pixels of 16 images at every stage (56^2 ... 7^2 x 16), so the serving
//   ranges end on whole steps.

constexpr int SWF_VMAX = 8;           // x vectors a thread copies a chunk, at most
constexpr int SWF_SMEM_MAX = 232448;  // 227 KB, a block's most on sm_90
// Measurement knob, for filter_sweep.py only (y is then wrong): 1 leaves out
// forming x^, 2 the products, 4 the copies of x and of the filter (the
// buffers keep what they held), 8 the epilogue (y stores and sums); 15
// leaves the walk alone.
#ifndef SWF_ABLATE
#define SWF_ABLATE 0
#endif

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// all but the most recent group landed
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct SpatialFwdF32Args {
  const float* x;      // [images, H, W, Ci]
  const float* w;      // [9 * Ci, Co], row tap * Ci + ci
  const float* inv;    // [Ci] or null
  const float* shift;
  float* y;            // [images, H, W, Co]
  float* part1;        // [ranges, Co]
  float* part2;
  int H, W, Ci, Co;
  int images, images_per_range, n_tiles;
  int XR;              // rows of a chunk buffer (swf_rows at the step)
};

// Rows one step of S pixels reads at the worst alignment: dr more image
// rows, di zero rows between images, and the halo row above and below.
// ops/conv_bn.py (spatial_ring_rows with one step) computes the same.
int swf_rows(int H, int W, int S) {
  const int dr = (S + W - 2) / W;
  const int di = (dr + H - 1) / H;
  return dr + di + 3;
}

// A block's shared memory: two x chunk buffers [XR][W + 2][KC + 4] and two
// filter chunks [9 * KC][NB] (the block's sums reuse the latter at the
// end); ops/conv_bn.py (_spatial_fwd_f32_smem) computes the same.
size_t swf_smem(int W, int XR, int KC, int NB) {
  return (2 * (size_t)XR * (W + 2) * (KC + 4) + 2 * (size_t)9 * KC * NB) *
         sizeof(float);
}

// The stream row of output pixel q of a range: one zero row before every
// image, so image i's row h is row i * (H + 1) + h + 1.
__device__ __forceinline__ int swf_stream_row(int q, int W, int H) {
  const int rho = q / W;
  return rho + rho / H + 1;
}

// component k of v (k a constant once the loops are unrolled)
__device__ __forceinline__ float lane4(const float4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The row walks' FFMA microkernel over one chunk of KC channels for all nine
// taps: acc[i][c] += A at pixel i's tap t, channel k, times the filter's
// row (t, k) at this thread's 8 output channels (4 at fs, 4 at fs + NB/2).
// xs is the chunk buffer ([rows][WP][LDC]), base[i] pixel i's offset of its
// padded pixel (h - 1, w - 1), fs the filter chunk [9 * KC][NB] at this
// thread's first channel.
template <int KC, int NB, int LDC>
__device__ __forceinline__ void walk_products(const float* xs, const float* fs,
                                              const int (&base)[8], int WP,
                                              float (&acc)[8][8]) {
  constexpr int QV = KC / 4;
  auto tap = [&](int t) {
    const float* xt = xs + ((t / 3) * WP + t % 3) * LDC;
    const float* ft = fs + t * KC * NB;
#pragma unroll
    for (int q = 0; q < QV; ++q) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = ld4(xt + base[i] + 4 * q);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = ld4(ft + (4 * q + kk) * NB);
        const float4 b1 = ld4(ft + (4 * q + kk) * NB + NB / 2);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ak = lane4(av[i], kk);
          acc[i][0] = fmaf(ak, b0.x, acc[i][0]);
          acc[i][1] = fmaf(ak, b0.y, acc[i][1]);
          acc[i][2] = fmaf(ak, b0.z, acc[i][2]);
          acc[i][3] = fmaf(ak, b0.w, acc[i][3]);
          acc[i][4] = fmaf(ak, b1.x, acc[i][4]);
          acc[i][5] = fmaf(ak, b1.y, acc[i][5]);
          acc[i][6] = fmaf(ak, b1.z, acc[i][6]);
          acc[i][7] = fmaf(ak, b1.w, acc[i][7]);
        }
      }
    }
  };
#pragma unroll 1
  for (int t = 0; t < 9; ++t) tap(t);
}

// NPG x NCG threads, each 8 pixels x 8 output channels: S = 8 * NPG pixels
// a step, NB = 8 * NCG output channels a block.
template <int NCG, int NPG, int KC, bool AFFINE>
__global__ void __launch_bounds__(NPG * NCG, 1)
spatial_fwd_f32_kernel(const SpatialFwdF32Args a) {
  constexpr int NTH = NPG * NCG, NB = 8 * NCG, S = 8 * NPG;
  constexpr int LDC = KC + 4;                  // a pixel's stride (floats)
  constexpr int QV = KC / 4;                   // 16-byte vectors of a pixel's chunk
  constexpr int XP = NTH / QV;                 // pixels of a copy pass
  constexpr int FR = 9 * KC;                   // filter rows of a chunk
  constexpr int FV = FR * NB / 4;              // 16-byte vectors of a filter chunk
  constexpr int F_IT = (FV + NTH - 1) / NTH;
  static_assert(NTH % QV == 0 && NPG <= FR && NTH <= 256 && NB <= NTH,
                "copies, block sums, 8 warps");
  const int H = a.H, W = a.W, Ci = a.Ci, Co = a.Co;
  const int WP = W + 2, HW = H * W;
  const int BUF = a.XR * WP * LDC;             // floats of an x chunk buffer
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Xb = reinterpret_cast<float*>(smem_raw);   // [2][XR][WP][LDC]
  float* Fb = Xb + 2 * BUF;                         // [2][FR][NB]

  const int tid = threadIdx.x;
  const int cg = tid % NCG, pg = tid / NCG;
  const int n0 = ((int)blockIdx.x % a.n_tiles) * NB;
  const int range = (int)blockIdx.x / a.n_tiles;
  const int i0 = range * a.images_per_range;
  const int nimg = min(a.images, i0 + a.images_per_range) - i0;
  const int Q = nimg * HW;                      // output pixels of the range
  const int nq = (Q + S - 1) / S;               // steps of the walk
  const int nck = (Ci + KC - 1) / KC;           // chunks a step
  const int64_t P0 = (int64_t)i0 * HW;          // the range's first pixel
  const int cq = (tid % QV) * 4;                // this thread's channels of a chunk

  // The x buffers zero once: the padding columns are never written again.
  for (int i = tid; i < 2 * BUF / 4; i += NTH)
    reinterpret_cast<float4*>(Xb)[i] = zero4();
  __syncthreads();

  // This thread's x vectors of a step: channels cq .. cq+3 of each chunk at
  // buffer offset v_off of the range's pixel v_pix (-1: a zero row, -2:
  // none). The same for every chunk of the step; a thread copies and forms
  // exactly these.
  int v_off[SWF_VMAX], v_pix[SWF_VMAX];
  auto seek_copies = [&](int j) {
    const int q0 = j * S, q1 = min(Q, q0 + S) - 1;
    const int rs = swf_stream_row(q0, W, H) - 1;
    const int npp = (swf_stream_row(q1, W, H) + 2 - rs) * W;
#pragma unroll
    for (int k = 0; k < SWF_VMAX; ++k) {
      const int pp = tid / QV + k * XP;
      v_off[k] = 0;
      v_pix[k] = -2;
      if (pp < npp) {
        const int lr = pp / W, w = pp - lr * W;
        const int vr = rs + lr;
        const int img = vr / (H + 1), hr = vr - img * (H + 1);
        v_off[k] = (lr * WP + w + 1) * LDC + cq;
        v_pix[k] = hr == 0 ? -1 : (img * H + hr - 1) * W + w;
      }
    }
  };
  // This thread's output pixels of step j: the offset of the padded pixel
  // (h - 1, w - 1) in the chunk buffer (0 past the range: their y is
  // neither stored nor summed).
  int base[8];
  auto seek_pixels = [&](int j) {
    const int rs = swf_stream_row(j * S, W, H) - 1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = j * S + pg + NPG * i;
      base[i] = 0;
      if (q < Q) {
        const int rho = q / W;
        base[i] = ((rho + rho / H - rs) * WP + q - rho * W) * LDC;
      }
    }
  };
  // chunk ck of the current step into buffer b: the step's x rows for
  // channels ck*KC .. +KC-1, and the filter chunk [9 * KC, NB]
  auto copy_chunk = [&](int ck, int b) {
    if (SWF_ABLATE & 4) return;
    const int ch = ck * KC + cq;
    float* xd = Xb + b * BUF;
#pragma unroll
    for (int k = 0; k < SWF_VMAX; ++k) {
      if (v_pix[k] < -1) continue;
      const bool real = v_pix[k] >= 0 && ch < Ci;
      cp_async16(xd + v_off[k], real ? a.x + (P0 + v_pix[k]) * Ci + ch : a.x,
                 real);
    }
    float* fd = Fb + b * FR * NB;
#pragma unroll
    for (int i = 0; i < F_IT; ++i) {
      const int idx = tid + i * NTH;
      if (FV % NTH != 0 && idx >= FV) break;
      const int r = idx / (NB / 4), c4 = (idx - r * (NB / 4)) * 4;
      const int tap = r / KC, ci = ck * KC + r - tap * KC;
      const bool ok = ci < Ci && n0 + c4 < Co;
      cp_async16(fd + r * NB + c4,
                 ok ? a.w + ((int64_t)tap * Ci + ci) * Co + n0 + c4 : a.w, ok);
    }
  };
  // x^ = relu(f32(f32(x * inv) + shift)) in place, on this thread's vectors
  // of real pixels (never the zero rows or columns)
  auto form_chunk = [&](int ck, int b) {
    const int ch = ck * KC + cq;
    if (!AFFINE || (SWF_ABLATE & 1) || ch >= Ci) return;
    const float4 iv = ld4(a.inv + ch), sv = ld4(a.shift + ch);
    float* xd = Xb + b * BUF;
#pragma unroll
    for (int k = 0; k < SWF_VMAX; ++k) {
      if (v_pix[k] < 0) continue;
      float4* p = reinterpret_cast<float4*>(xd + v_off[k]);
      *p = prologue4(*p, iv, sv);
    }
  };

  float acc[8][8];
  // acc[i][c] += x^ at pixel i's tap t, channel k, times the filter's row
  // (t, k) at this thread's 8 output channels, over the chunk in buffer b
  auto products = [&](int b) {
    walk_products<KC, NB, LDC>(Xb + b * BUF, Fb + b * FR * NB + cg * 4, base,
                               WP, acc);
  };

  float s1[8], s2[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) s1[c] = s2[c] = 0.f;

  if (nq > 0) {
    seek_copies(0);
    copy_chunk(0, 0);
  }
  cp_async_commit();
  int b = 0;                                    // the buffer of the chunk multiplied
  for (int j = 0; j < nq; ++j) {
    seek_pixels(j);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
    for (int ck = 0; ck < nck; ++ck) {
      cp_async_wait_all();                      // this thread's copies of the chunk
      form_chunk(ck, b);
      __syncthreads();                          // the chunk formed; the one before done
      if (ck + 1 < nck) {                       // the next chunk, into the other buffers
        copy_chunk(ck + 1, b ^ 1);
      } else if (j + 1 < nq) {                  // the next step's first
        seek_copies(j + 1);
        copy_chunk(0, b ^ 1);
      }
      cp_async_commit();
      if (!(SWF_ABLATE & 2)) products(b);
      b ^= 1;
    }

    // epilogue: y straight from the registers, and the step's share of the
    // sums in a fixed order
    const int npx = min(S, Q - j * S);
    if (!(SWF_ABLATE & 8)) {
      const bool lo = n0 + cg * 4 < Co, hi = n0 + NB / 2 + cg * 4 < Co;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = pg + NPG * i;
        if (p >= npx) continue;
        float* yr = a.y + (P0 + (int64_t)j * S + p) * Co + n0 + cg * 4;
        if (lo)
          *reinterpret_cast<float4*>(yr) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        if (hi)
          *reinterpret_cast<float4*>(yr + NB / 2) =
              make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          s1[c] = __fadd_rn(s1[c], acc[i][c]);
          s2[c] = __fadd_rn(s2[c], __fmul_rn(acc[i][c], acc[i][c]));
        }
      }
    } else if (H < 0) {                         // never true: keeps the products alive
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) a.y[i * 8 + c] = acc[i][c];
    }
  }
  cp_async_wait_all();
  __syncthreads();                              // every product read: reuse the filter buffers

  // the block's partial row: the NPG pixel groups in order
  float* red1 = Fb;                             // [NPG][NB]
  float* red2 = Fb + NPG * NB;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    red1[pg * NB + cg * 4 + c] = s1[c];
    red1[pg * NB + NB / 2 + cg * 4 + c] = s1[4 + c];
    red2[pg * NB + cg * 4 + c] = s2[c];
    red2[pg * NB + NB / 2 + cg * 4 + c] = s2[4 + c];
  }
  __syncthreads();
  if (tid < NB && n0 + tid < Co) {
    float v1 = 0.f, v2 = 0.f;
    for (int g = 0; g < NPG; ++g) {
      v1 += red1[g * NB + tid];
      v2 += red2[g * NB + tid];
    }
    a.part1[(int64_t)range * Co + n0 + tid] = v1;
    a.part2[(int64_t)range * Co + n0 + tid] = v2;
  }
}

template <int NCG, int NPG, int KC, bool AFFINE>
int launch_spatial_fwd_f32(const SpatialFwdF32Args& a, int ranges,
                           cudaStream_t stream) {
  constexpr int NTH = NPG * NCG;
  const size_t smem = swf_smem(a.W, a.XR, KC, 8 * NCG);
  if (smem > (size_t)SWF_SMEM_MAX || a.XR * a.W > SWF_VMAX * (NTH / (KC / 4)))
    return (int)cudaErrorInvalidValue;
  auto kern = spatial_fwd_f32_kernel<NCG, NPG, KC, AFFINE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<ranges * a.n_tiles, NTH, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The layouts f32_spatial_fwd_plan (ops/conv_bn.py) can ask for: (N tile,
// K chunk) -> NCG = N tile / 8 channel groups, NPG pixel groups.
template <int NCG, int NPG, int KC>
int spatial_fwd_f32_either(bool affine, SpatialFwdF32Args a, int ranges,
                           cudaStream_t s) {
  a.XR = swf_rows(a.H, a.W, 8 * NPG);
  return affine ? launch_spatial_fwd_f32<NCG, NPG, KC, true>(a, ranges, s)
                : launch_spatial_fwd_f32<NCG, NPG, KC, false>(a, ranges, s);
}

// ---------------------------------------------------------------------------
// The temporal forward: the frame walk (temporal_fwd_f32_kernel)
// ---------------------------------------------------------------------------
//
// Replaces _temporal_fwd (m3f/pytorch_tpu/ops/pallas/conv_bn.py, pallas_call
// at :250, kernel _temporal_fwd_kernel at :133) for fp32 x:
//   y[b,t,p,:] = sum_dt x^[b,t+dt-1,p,:] @ W[dt]
// with the frames -1 and T zero AFTER the prologue and no clip reading
// another's frames. At the serving forward's stage 1 (x [128,16,56,56,144]
// -> Co 64) a launch is 0.355 TFLOP of fp32 FMA on 5.3 GB: 5.30 ms at 67
// TFLOP/s against 1.59 ms of memory, and every stage is operation-bound
// (stage 4, [128,2,7,7,1152] -> 512: 0.66 against 0.03). What the per-tap
// gather spent beyond the products (x^ gathered and formed again for each
// of the three taps and each 64-channel N tile, 4x4 register tiles, a
// synchronous gather through registers, (b, t, h, w) decoded per tile) is
// what this design takes out. The walk follows the bf16 temporal_fwd_kernel
// (conv_bn.cu); the microkernel follows spatial_fwd_f32_kernel above.
//
// - Frame walk, input-stationary. A work unit is a strip of S consecutive
//   positions of the flattened B*H*W axis, walked over t = 0..T-1 (every
//   clip has the same T, so the strip's rows share t). Where H*W is small
//   (stages 3-4: 196 and 49) a strip spans several clips, so one pass of
//   the filter serves S positions whatever H*W is; a block's units follow
//   one another in one stream of chunks.
// - Frame t's x arrives in chunks of KC = 16 input channels by cp.async
//   into a [S][KC + 4] buffer (zero-filled past the strip and past C_in).
//   The thread that copied a vector forms it in place once, after its own
//   wait_group, with __fmul_rn / __fadd_rn (two roundings, no FMA), and
//   never forms a vector past the strip or past C_in. The formed chunk is
//   multiplied into three accumulator sets: output frames t+1 (tap 0), t
//   (tap 1) and t-1 (tap 2); a tap whose output frame lies outside the clip
//   is skipped, which is the zero padding after the prologue. After frame
//   t's last chunk, output frame t-1 is complete: its y leaves and its sums
//   are taken, and the sets shift by one frame. So each x^ element is formed
//   once per N tile, not once per tap and tile.
// - The filter chunk [3 * KC, NB] (row tap * KC + k) streams from the L2
//   through the same double buffer, or, where [3 * C_in, NB] fits beside
//   the x buffers (stage 1 at NB 64: 108 KB), stays resident in shared
//   memory, loaded once per block with the first chunk.
// - FFMA microkernel (fp32 CUDA cores: the reference is fp32, so no TF32
//   and no tensor cores): a block of NPG x NCG threads, each 4 positions
//   (pg + NPG i) x 8 output channels (4 at cg * 4, 4 at NB/2 + cg * 4) x 3
//   output frames, 96 fp32 sums. A is a float4 of 4 channels of one
//   position, B two float4 of output channels: 28 LDS.128 per 384 FFMA. A
//   warp is 4 position groups x 8 channel groups, so its A and B loads are
//   4 and 8 distinct vectors (one wavefront each); a row stride of KC + 4
//   floats puts 4 neighbouring positions on distinct banks.
// - One layout: N tile 64 x strip 128 (NCG 8, NPG 32: 256 threads, one
//   block a SM; ptxas gives 255 registers a thread and no spill). At stage
//   1 (C_out 64) one tile covers every output channel, so x^ is formed once
//   in all. N tiles of 128 x strips of 64 were measured 2-4% slower at
//   stages 2-4 and not kept (PERF.md). At most 8 warps a block: nine cap a
//   thread at 168 registers (spatial_fwd_f32_kernel's finding).
// - Epilogue: y leaves from registers in 16-byte stores along the channels
//   (8 lanes write 128 bytes of one position's row); s1 / s2 are per-thread
//   fp32 sums over the walk in a fixed order (units, frames, positions),
//   then the NPG position groups in order into one partial row per range,
//   summed by colsum_f32_kernel. No atomics: two calls give the same bits.
// - Grid: ranges of units x N tiles, the N tile fastest (the blocks reading
//   the same x run together); f32_temporal_fwd_plan (ops/conv_bn.py) sizes
//   the ranges for the fewest unit-times to the last block's end.

constexpr int TWF_KC = 16;            // input channels a chunk
constexpr int TWF_NCG = 8;            // channel groups: N tile 8 * NCG = 64
constexpr int TWF_NPG = 32;           // position groups: strip 4 * NPG = 128
// Measurement knob, for filter_sweep.py only (y is then wrong): 1 leaves out
// forming x^, 2 the products, 4 the copies of x and of the filter (the
// buffers keep what they held), 8 the epilogue (y stores and sums); 15
// leaves the walk alone.
#ifndef TWF_ABLATE
#define TWF_ABLATE 0
#endif

struct TemporalFwdF32Args {
  const float* x;      // [B, T, H*W, Ci]
  const float* w;      // [3 * Ci, Co], row tap * Ci + ci
  const float* inv;    // [Ci] or null
  const float* shift;
  float* y;            // [B, T, H*W, Co]
  float* part1;        // [ranges, Co]
  float* part2;
  int64_t positions;   // B * H*W: the axis the strips cut
  int T, HW, Ci, Co;
  int units;           // ceil(positions / S)
  int units_per_range;
  int n_tiles;
  int resident;        // the block's filter tile stays in shared memory
};

// A block's shared memory: the filter (resident [3 * Cip][NB], Cip = C_in
// in whole chunks, or two streamed chunks [3 * KC][NB]) and two x chunk
// buffers [S][KC + 4]; the block's sums reuse it at the end.
// ops/conv_bn.py (_temporal_fwd_f32_smem) computes the same.
size_t twf_smem(int S, int NB, int Cip, int res) {
  const size_t filt = res ? (size_t)3 * Cip * NB : (size_t)2 * 3 * TWF_KC * NB;
  return sizeof(float) * (filt + (size_t)2 * S * (TWF_KC + 4));
}

// NPG x NCG threads, each 4 positions x 8 output channels x 3 frames:
// S = 4 * NPG positions a strip, NB = 8 * NCG output channels a block.
template <bool AFFINE>
__global__ void __launch_bounds__(TWF_NPG * TWF_NCG, 1)
temporal_fwd_f32_kernel(const TemporalFwdF32Args a) {
  constexpr int NCG = TWF_NCG, NPG = TWF_NPG;
  constexpr int NTH = NPG * NCG, NB = 8 * NCG, S = 4 * NPG;
  constexpr int KC = TWF_KC, LDC = KC + 4;     // a position's stride (floats)
  constexpr int QV = KC / 4;                   // 16-byte vectors of a position's chunk
  constexpr int XV = S * QV / NTH;             // x vectors a thread copies a chunk
  constexpr int FR = 3 * KC;                   // filter rows of a chunk
  constexpr int FV = FR * NB / 4;              // 16-byte vectors of a filter chunk
  static_assert(S * QV % NTH == 0 && FV % NTH == 0 && NCG == 8 &&
                    NPG % 4 == 0 && NTH <= 256 &&
                    2 * NPG * NB <= FR * NB + 2 * S * LDC,
                "copies, warp layout, 8 warps, block sums");
  const int T = a.T, HW = a.HW, Ci = a.Ci, Co = a.Co;
  const bool res = a.resident != 0;
  const int nck = (Ci + KC - 1) / KC;          // chunks a frame
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Xb = reinterpret_cast<float*>(smem_raw);   // [2][S][LDC]
  float* Fb = Xb + 2 * S * LDC;                     // [nck][FR][NB] or [2][FR][NB]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = lane >> 2;                     // channels cg*4, NB/2 + cg*4
  const int pg = warp * 4 + (lane & 3);         // positions pg + NPG*i
  const int n0 = ((int)blockIdx.x % a.n_tiles) * NB;
  const int range = (int)blockIdx.x / a.n_tiles;
  const int u0 = range * a.units_per_range;
  const int u1 = min(a.units, u0 + a.units_per_range);
  const int nq = u1 > u0 ? (u1 - u0) * T * nck : 0;   // chunks of the walk
  const int cq = (tid % QV) * 4;               // this thread's channels of a chunk

  // the resident filter: chunk c's rows tap * KC + k at [c][FR][NB], zero
  // past Ci and Co
  if (res && !(TWF_ABLATE & 4)) {
    for (int idx = tid; idx < nck * FV; idx += NTH) {
      const int r = idx / (NB / 4), c4 = (idx - r * (NB / 4)) * 4;
      const int c = r / FR, tap = (r - c * FR) / KC;
      const int ci = c * KC + r - c * FR - tap * KC;
      const bool ok = ci < Ci && n0 + c4 < Co;
      cp_async16(Fb + r * NB + c4,
                 ok ? a.w + ((int64_t)tap * Ci + ci) * Co + n0 + c4 : a.w, ok);
    }
  }

  // The position of strip row r of unit u at frame 0, b*T*HW + p (-1 past
  // the positions): only entering a unit divides.
  auto row_pos = [&](int u, int r) -> int64_t {
    const int64_t gp = (int64_t)u * S + r;
    if (gp >= a.positions) return -1;
    const int64_t b = gp / HW;
    return b * T * HW + (gp - b * HW);
  };
  // This thread's x vectors of a chunk: tid + j*NTH -> strip row
  // (tid + j*NTH) / QV, channels cq .. cq+3 of the chunk
  int64_t x_pos[XV];
  auto seek_x = [&](int u) {
#pragma unroll
    for (int j = 0; j < XV; ++j) x_pos[j] = row_pos(u, (tid + j * NTH) / QV);
  };
  // This thread's output positions, strip rows pg + NPG*i
  int64_t y_pos[4];
  auto seek_y = [&](int u) {
#pragma unroll
    for (int i = 0; i < 4; ++i) y_pos[i] = row_pos(u, pg + NPG * i);
  };

  // A cursor on the walk: chunk c of frame t of unit u, the walk's q-th.
  struct Cursor {
    int q, u, t, c;
  };
  auto advance = [&](Cursor& w) {
    ++w.q;
    if (++w.c < nck) return false;
    w.c = 0;
    if (++w.t < T) return false;
    w.t = 0;
    ++w.u;
    return true;                   // a new unit
  };

  // chunk w into buffer w.q & 1: the strip's x rows at frame w.t for the
  // chunk's channels, and (streamed) the filter chunk
  auto copy_chunk = [&](const Cursor& w) {
    if (TWF_ABLATE & 4) return;
    const int ch = w.c * KC + cq;
    float* xd = Xb + (w.q & 1) * S * LDC;
    const int64_t frame = (int64_t)w.t * HW;
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const bool ok = x_pos[j] >= 0 && ch < Ci;
      cp_async16(xd + (tid + j * NTH) / QV * LDC + cq,
                 ok ? a.x + (x_pos[j] + frame) * Ci + ch : a.x, ok);
    }
    if (res) return;
    float* fd = Fb + (w.q & 1) * FR * NB;
#pragma unroll
    for (int i = 0; i < FV / NTH; ++i) {
      const int idx = tid + i * NTH;
      const int r = idx / (NB / 4), c4 = (idx - r * (NB / 4)) * 4;
      const int tap = r / KC, ci = w.c * KC + r - tap * KC;
      const bool ok = ci < Ci && n0 + c4 < Co;
      cp_async16(fd + r * NB + c4,
                 ok ? a.w + ((int64_t)tap * Ci + ci) * Co + n0 + c4 : a.w, ok);
    }
  };
  // x^ = relu(f32(f32(x * inv) + shift)) in place, on this thread's
  // vectors of the chunk (never those past the strip or past Ci)
  auto form_chunk = [&](const Cursor& w) {
    const int ch = w.c * KC + cq;
    if (!AFFINE || (TWF_ABLATE & 1) || ch >= Ci) return;
    const float4 iv = ld4(a.inv + ch), sv = ld4(a.shift + ch);
    float* xd = Xb + (w.q & 1) * S * LDC;
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      if (x_pos[j] < 0) continue;
      float4* p = reinterpret_cast<float4*>(xd + (tid + j * NTH) / QV * LDC + cq);
      *p = prologue4(*p, iv, sv);
    }
  };

  float acc[3][4][8];              // output frames t-1, t, t+1
#pragma unroll
  for (int f = 0; f < 3; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[f][i][c] = 0.f;
  // acc[2 - dt][i][c] += x^ at position i, channel k, times the filter's
  // row (dt, k) at this thread's 8 output channels, over chunk w; the taps
  // whose output frame lies outside the clip are skipped
  auto products = [&](const Cursor& w) {
    const float* xs = Xb + (w.q & 1) * S * LDC + pg * LDC;
    const float* fs = (res ? Fb + w.c * FR * NB : Fb + (w.q & 1) * FR * NB) + cg * 4;
    const bool t0 = w.t + 1 < T, t2 = w.t > 0;
#pragma unroll
    for (int q = 0; q < QV; ++q) {
      float4 av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = ld4(xs + i * NPG * LDC + 4 * q);
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        if ((dt == 0 && !t0) || (dt == 2 && !t2)) continue;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* fr = fs + (dt * KC + 4 * q + kk) * NB;
          const float4 b0 = ld4(fr), b1 = ld4(fr + NB / 2);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float ak = lane4(av[i], kk);
            const int f = 2 - dt;
            acc[f][i][0] = fmaf(ak, b0.x, acc[f][i][0]);
            acc[f][i][1] = fmaf(ak, b0.y, acc[f][i][1]);
            acc[f][i][2] = fmaf(ak, b0.z, acc[f][i][2]);
            acc[f][i][3] = fmaf(ak, b0.w, acc[f][i][3]);
            acc[f][i][4] = fmaf(ak, b1.x, acc[f][i][4]);
            acc[f][i][5] = fmaf(ak, b1.y, acc[f][i][5]);
            acc[f][i][6] = fmaf(ak, b1.z, acc[f][i][6]);
            acc[f][i][7] = fmaf(ak, b1.w, acc[f][i][7]);
          }
        }
      }
    }
  };

  float s1[8], s2[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) s1[c] = s2[c] = 0.f;
  const bool lo = n0 + cg * 4 < Co, hi = n0 + NB / 2 + cg * 4 < Co;
  // output frame tf of the current unit from accumulator set f: y straight
  // from the registers, and its share of the sums in a fixed order
  auto epilogue = [&](const float (&f)[4][8], int tf) {
    if (TWF_ABLATE & 8) return;
    const int64_t frame = (int64_t)tf * HW;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (y_pos[i] < 0) continue;
      float* yr = a.y + (y_pos[i] + frame) * Co + n0 + cg * 4;
      if (lo)
        *reinterpret_cast<float4*>(yr) = make_float4(f[i][0], f[i][1], f[i][2], f[i][3]);
      if (hi)
        *reinterpret_cast<float4*>(yr + NB / 2) =
            make_float4(f[i][4], f[i][5], f[i][6], f[i][7]);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s1[c] = __fadd_rn(s1[c], f[i][c]);
        s2[c] = __fadd_rn(s2[c], __fmul_rn(f[i][c], f[i][c]));
      }
    }
  };

  Cursor cc{0, u0, 0, 0}, mc{0, u0, 0, 0};   // the chunk copied, multiplied
  if (nq > 0) {
    seek_x(u0);
    seek_y(u0);
    copy_chunk(cc);                 // with the resident filter, one group
  }
  cp_async_commit();
  for (int q = 0; q < nq; ++q) {
    cp_async_wait_all();            // this thread's copies of chunk q landed
    form_chunk(mc);
    __syncthreads();                // chunk q formed; chunk q-1 multiplied
    if (q + 1 < nq) {               // chunk q+1, into the buffers of q-1
      if (advance(cc)) seek_x(cc.u);
      copy_chunk(cc);
    }
    cp_async_commit();
    if (!(TWF_ABLATE & 2)) products(mc);
    if (mc.c == nck - 1) {          // frame t's last chunk: frame t-1 is done
      const int t = mc.t;
      if (t > 0) epilogue(acc[0], t - 1);
      if (t + 1 == T) {
        epilogue(acc[1], t);
#pragma unroll
        for (int f = 0; f < 3; ++f)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[f][i][c] = 0.f;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            acc[0][i][c] = acc[1][i][c];
            acc[1][i][c] = acc[2][i][c];
            acc[2][i][c] = 0.f;
          }
      }
    }
    if (advance(mc)) seek_y(mc.u);
    if ((TWF_ABLATE & 8) && T < 0) {   // never true: keeps the products alive
#pragma unroll
      for (int f = 0; f < 3; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) a.y[(f * 4 + i) * 8 + c] = acc[f][i][c];
    }
  }
  cp_async_wait_all();
  __syncthreads();                  // every product read: reuse the buffers

  // the block's partial row: the NPG position groups in order
  float* red1 = Xb;                 // [NPG][NB]
  float* red2 = Xb + NPG * NB;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    red1[pg * NB + cg * 4 + c] = s1[c];
    red1[pg * NB + NB / 2 + cg * 4 + c] = s1[4 + c];
    red2[pg * NB + cg * 4 + c] = s2[c];
    red2[pg * NB + NB / 2 + cg * 4 + c] = s2[4 + c];
  }
  __syncthreads();
  if (tid < NB && n0 + tid < Co) {
    float v1 = 0.f, v2 = 0.f;
    for (int g = 0; g < NPG; ++g) {
      v1 += red1[g * NB + tid];
      v2 += red2[g * NB + tid];
    }
    a.part1[(int64_t)range * Co + n0 + tid] = v1;
    a.part2[(int64_t)range * Co + n0 + tid] = v2;
  }
}

template <bool AFFINE>
int launch_temporal_fwd_f32(const TemporalFwdF32Args& a, int ranges,
                            cudaStream_t stream) {
  const int cip = (a.Ci + TWF_KC - 1) / TWF_KC * TWF_KC;
  const size_t smem = twf_smem(4 * TWF_NPG, 8 * TWF_NCG, cip, a.resident);
  if (smem > (size_t)SWF_SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = temporal_fwd_f32_kernel<AFFINE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<ranges * a.n_tiles, TWF_NPG * TWF_NCG, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The spatial filter gradient: the row walk (spatial_filter_f32_kernel)
// ---------------------------------------------------------------------------
//
// Replaces _spatial_bwd's filter gradient (m3f/pytorch_tpu/ops/pallas/
// conv_bn.py:554, kernel _spatial_bwd_filter_kernel at :356) for fp32 x:
//   dw[tap * Ci + ci, co] = sum_m x^[neighbour(m, tap), ci] * ge[m, co]
// with x^ and ge 0 in the padding. At the train step's stage 1 (x
// [32,16,56,56,64], ge [.., 144]) a launch is 0.26 TFLOP of fp32 FMA on
// 2.3 GB: 3.9 ms at 67 TFLOP/s against 0.69 ms of memory, and every stage
// is operation-bound. What the per-tap gather (bwd_filter_f32_kernel) spent
// beyond the products (x^ formed 27 times a pixel at stage 1, once per tap
// and per 64-channel N tile; ge folded again for each 64-row K tile; a third
// of the columns padding at C_out 144; one LDS.128 of A and one of B per 16
// FMA) is what this design takes out. The walk follows the bf16
// spatial_filter_kernel (conv_bn.cu) and spatial_fwd_f32_kernel above.
//
// - ge = gy + (gs1 + (2 y) gs2), each op rounded, is folded once into a
//   scratch [M, Co] by fold_f32_kernel before the walk (a pass over 2.8 GB
//   at stage 1), so the walk copies one tensor, not gy and y, and no block
//   folds it again (a fold in every channel block measured 1.5x slower).
// - Row walk. A block owns every tap of SFF_CB = 16 input channels x an N
//   tile of NB output channels ([9 * 16, NB] of dw, 96 sums a thread in
//   registers across the whole walk) over a slice of whole (b, t) images,
//   walked as one stream of output pixels, S a step. The x rows live in a
//   ring of XR stream rows of W + 2 pixels: an all-zero row before every
//   image and after the last, columns 0 and W + 1 zero (never written), so
//   the padding is 0 AFTER the prologue, as the reference's. Each row is
//   copied once by cp.async ([pixel][16 + 4] floats) and formed in place
//   once (x^, two roundings: __fmul_rn / __fadd_rn); the ring holds the rows
//   of two steps, those multiplied and those arriving. So x^ is formed once
//   per pixel and N tile.
// - A producer warp. The block is 3 x 4 x NCG consumer threads and one warp
//   more that copies step j+1's x rows and ge rows ([S][NB + 4], double
//   buffered), forms its x^ and writes its table while the consumers
//   multiply step j; one barrier a step. 144 = 9 x 16 puts a factor 3 in
//   the consumers' count, so they are 7 warps (6 for NB 128) on four
//   schedulers: the producer runs on the one with a single consumer warp,
//   in its idle issue slots. (PERF.md, PR 22: all threads copying and
//   forming before each barrier was 5-10% slower, a producer two steps
//   ahead 2-5% slower, bulk copies of a pixel's x and ge row slower than
//   16-byte cp.async.)
// - A tap is an address. A step's table holds, per output pixel and dh, the
//   ring offset of the padded pixel (h + dh - 1, w - 1); tap dw adds dw
//   pixels. Pixels past the slice point at a padding column (x^ 0, ge 0).
// - FFMA microkernel (fp32 CUDA cores; the reference is fp32, so no TF32
//   and no tensor cores): consumer (dh, cg, ng) holds the three dw taps of
//   row dh x 4 input channels (cg * 4) x 8 output channels (4 at ng * 4, 4
//   at NB/2 + ng * 4). A pixel costs it 3 LDS.128 of x^ (its dw taps), 2 of
//   ge and a quarter of the table's LDS.128 for 96 FFMA: 1 LDS.128 per 18
//   FFMA against 1 per 8 in the gather.
// - N tiles of NB = 144 (C_out 144 / 288 / 576 / 1152, mid_mode "flops")
//   or 128 (128 / 256 / 512, "lane"); other multiples of 8 take a masked
//   last tile. One block a SM.
// - Epilogue: the 96 sums leave from registers in 16-byte stores into the
//   slice's partial [9 * Ci, Co] (or dw itself with one slice), and
//   slice_sum_f32_kernel sums the partials in slice order. No atomics: two
//   calls give the same bits.
// - Grid: slices x channel blocks x N tiles, the channel block fastest (the
//   blocks reading the same ge run together), the slice slowest.
//   f32_spatial_filter_plan (ops/conv_bn.py) picks NB, S, the ring's rows
//   and the slices.

constexpr int SFF_CB = 16;            // input channels a block
// Measurement knob, for filter_sweep.py only (dw is then wrong): 1 leaves
// out forming x^, 2 the products, 4 the copies of x and ge (the buffers
// keep what they held), 8 the epilogue (the dw stores); 15 leaves the walk
// alone (the fold of ge runs in every build).
#ifndef SFF_ABLATE
#define SFF_ABLATE 0
#endif

// The threads that multiply; the block is one warp more (the producer).
__host__ __device__ constexpr int sff_consumers(int ncg) {
  return 3 * (SFF_CB / 4) * ncg;
}
__host__ __device__ constexpr int sff_block(int ncg) {
  return ((sff_consumers(ncg) + 31) / 32 + 1) * 32;
}

// n / d for 0 <= n < 2^31 and d >= 1 by a multiply-high and at most one
// correction, m = floor((2^32 - 1) / d) computed once (the walk's runtime
// divisors: W, H, H + 1, XR, 4 W)
struct FastDiv {
  uint32_t d, m;
};

inline FastDiv fast_div(int d) {
  return FastDiv{(uint32_t)d, 0xFFFFFFFFu / (uint32_t)d};
}

__device__ __forceinline__ int fdiv(int n, const FastDiv f) {
  uint32_t q = __umulhi((uint32_t)n, f.m);
  if ((uint32_t)n - q * f.d >= f.d) ++q;
  return (int)q;
}

struct SpatialFilterF32Args {
  const float* x;      // [images, H, W, Ci]
  const float* ge;     // [images, H, W, Co]: the folded cotangent
  const float* inv;    // [Ci] or null
  const float* shift;
  float* out;          // [slices][9 * Ci][Co] partials, or dw (one slice)
  int H, W, Ci, Co;
  int images, images_per_slice, ci_blocks, n_tiles;
  int S;               // output pixels a step, a multiple of 8
  int XR;              // rows of the x^ ring (swf_rows of two steps)
  FastDiv by_w, by_h, by_h1, by_xr, by_4w;
};

// A block's shared memory: the x^ ring [XR][W + 2][16 + 4], two ge buffers
// [S][NB + 4] and two tables [3][S]; ops/conv_bn.py
// (_spatial_filter_f32_smem) computes the same.
size_t sff_smem(int W, int XR, int S, int NB) {
  return sizeof(float) * ((size_t)XR * (W + 2) * (SFF_CB + 4) +
                          (size_t)2 * S * (NB + 4)) +
         sizeof(int) * (size_t)2 * 3 * S;
}

// 3 x SFF_CB/4 x NCG consumers, each 3 taps x 4 input channels x 8 output
// channels (NB = 8 * NCG output channels a block), and the producer warp.
template <int NCG, bool AFFINE>
__global__ void __launch_bounds__(sff_block(NCG), 1)
spatial_filter_f32_kernel(const SpatialFilterF32Args a) {
  constexpr int CB = SFF_CB, CG = CB / 4, NB = 8 * NCG;
  constexpr int NTH = sff_consumers(NCG);      // the threads that multiply
  constexpr int NBLK = sff_block(NCG);
  constexpr int LDX = CB + 4;                  // a ring pixel's stride (floats)
  constexpr int LDG = NB + 4;                  // a ge row's stride (floats)
  constexpr int GV = NB / 4;                   // 16-byte vectors of a ge row
  static_assert(CG == 4, "a pixel's 16 channels in 4 vectors");
  const int H = a.H, W = a.W, Ci = a.Ci, Co = a.Co, S = a.S, XR = a.XR;
  const int WP = W + 2, HW = H * W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Xs = reinterpret_cast<float*>(smem_raw);   // [XR][WP][LDX]: the x^ ring
  float* Gs = Xs + XR * WP * LDX;                   // [2][S][LDG]: ge
  int* Tab = reinterpret_cast<int*>(Gs + 2 * S * LDG);   // [2][3][S]

  const int tid = threadIdx.x;
  const int ng = tid % NCG, cg = (tid / NCG) % CG, dh = tid / (NCG * CG);
  const bool producer = tid >= NBLK - 32;
  const int lane = tid & 31;
  const int tiles = a.ci_blocks * a.n_tiles;
  const int tile = (int)blockIdx.x % tiles, slice = (int)blockIdx.x / tiles;
  const int c0 = (tile % a.ci_blocks) * CB, n0 = (tile / a.ci_blocks) * NB;
  const int i0 = slice * a.images_per_slice;
  const int nimg = min(a.images, i0 + a.images_per_slice) - i0;
  const int Q = nimg * HW;                      // output pixels of the slice
  const int nq = (Q + S - 1) / S;               // steps of the walk
  const int64_t P0 = (int64_t)i0 * HW;          // the slice's first pixel
  const int last_row = nimg * (H + 1);          // the zero row after the last image

  // The ring zero once: the padding columns are never written again.
  for (int i = tid; i < XR * WP * LDX / 4; i += NBLK)
    reinterpret_cast<float4*>(Xs)[i] = zero4();
  __syncthreads();

  // The last stream row step j reads: the row below its last pixel.
  auto need = [&](int j) {
    if ((j + 1) * S >= Q) return last_row;
    const int rho = fdiv((j + 1) * S - 1, a.by_w);
    return rho + fdiv(rho, a.by_h) + 2;
  };
  // The rows (lo, upto] step j adds: their 4 W vectors each, this lane's
  // share (vectors lane, lane + 32, ...: the same channel cq in every row)
  // to `fn(ring offset, source pixel of the slice or -1 on a zero row,
  // channel)`. Rows of 32 pixels or more a row at a time; shorter ones (a
  // step adds many) in one loop unrolled so that the vectors' loads
  // overlap.
  auto rows_of = [&](int lo, int upto, auto&& fn) {
    if (W >= 32) {
      int vr = lo + 1;
      int img = fdiv(vr, a.by_h1), hr = vr - img * (H + 1);
      int slot = vr - fdiv(vr, a.by_xr) * XR;
      for (; vr <= upto; ++vr) {
        for (int u = lane; u < 4 * W; u += 32) {
          const int col = u >> 2, cq = (u & 3) * 4;
          fn((slot * WP + col + 1) * LDX + cq,
             hr == 0 ? -1 : (img * H + hr - 1) * W + col, cq);
        }
        if (++hr == H + 1) {
          hr = 0;
          ++img;
        }
        slot = slot + 1 == XR ? 0 : slot + 1;
      }
      return;
    }
    const int n = (upto - lo) * 4 * W;
#pragma unroll 4
    for (int v = lane; v < n; v += 32) {
      const int r = fdiv(v, a.by_4w), u = v - r * 4 * W;
      const int vr = lo + 1 + r;
      const int img = fdiv(vr, a.by_h1), hr = vr - img * (H + 1);
      const int col = u >> 2, cq = (u & 3) * 4;
      fn(((vr - fdiv(vr, a.by_xr) * XR) * WP + col + 1) * LDX + cq,
         hr == 0 ? -1 : (img * H + hr - 1) * W + col, cq);
    }
  };
  // This lane's channels of x^: the same 4 in every row
  float4 inv4 = zero4(), shift4 = zero4();
  if (AFFINE && producer && c0 + (lane & 3) * 4 < Ci) {
    inv4 = ld4(a.inv + c0 + (lane & 3) * 4);
    shift4 = ld4(a.shift + c0 + (lane & 3) * 4);
  }
  // Step j's copies into buffer b (cp.async, zero-filled on the zero rows,
  // past Ci, past the slice and past Co), and its table; then, once they
  // land, x^ in place on the rows (image rows and channels < Ci only).
  auto produce = [&](int j, int b) {
    const int lo = j == 0 ? -1 : need(j - 1), upto = need(j);
    if (!(SFF_ABLATE & 4)) {
      rows_of(lo, upto, [&](int off, int pix, int cq) {
        const bool real = pix >= 0 && c0 + cq < Ci;
        cp_async16(Xs + off, real ? a.x + (P0 + pix) * Ci + c0 + cq : a.x, real);
      });
      const int q0 = j * S;
      float* gd = Gs + b * S * LDG;
#pragma unroll 4
      for (int v = lane; v < S * GV; v += 32) {
        const int p = v / GV, c4 = (v - p * GV) * 4;
        const bool ok = q0 + p < Q && n0 + c4 < Co;
        cp_async16(gd + p * LDG + c4,
                   ok ? a.ge + (P0 + q0 + p) * Co + n0 + c4 : a.ge, ok);
      }
    }
    cp_async_commit();
    for (int i = lane; i < S; i += 32) {
      const int q = j * S + i;
      int* t = Tab + b * 3 * S + i;
      if (q < Q) {
        const int rho = fdiv(q, a.by_w), w = q - rho * W;
        const int up = rho + fdiv(rho, a.by_h);      // the stream row above
        int slot = up - fdiv(up, a.by_xr) * XR;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          t[r * S] = slot * WP + w;
          slot = slot + 1 == XR ? 0 : slot + 1;
        }
      } else {
        t[0] = t[S] = t[2 * S] = 0;
      }
    }
    cp_async_wait_all();                        // this lane's copies landed
    rows_of(lo, upto, [&](int off, int pix, int cq) {
      if (!AFFINE || (SFF_ABLATE & 1) || pix < 0 || c0 + cq >= Ci) return;
      float4* p = reinterpret_cast<float4*>(Xs + off);
      *p = prologue4(*p, inv4, shift4);
    });
  };

  float acc[3][4][8];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[d][k][c] = 0.f;
  // acc[dw][k][c] += x^ at the pixel's tap (dh, dw), channel cg * 4 + k,
  // times ge at the pixel, this thread's output channel c, over step b's S
  // pixels
  auto products = [&](int b) {
    const int* tab = Tab + (b * 3 + dh) * S;
    const float* xs = Xs + cg * 4;
    const float* gs = Gs + b * S * LDG + ng * 4;
#pragma unroll 2
    for (int p = 0; p < S; p += 4) {
      const int4 o4 = *reinterpret_cast<const int4*>(tab + p);
      const int o[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* xa = xs + o[i] * LDX;
        const float4 av[3] = {ld4(xa), ld4(xa + LDX), ld4(xa + 2 * LDX)};
        const float* gb = gs + (p + i) * LDG;
        const float4 b0 = ld4(gb), b1 = ld4(gb + NB / 2);
#pragma unroll
        for (int d = 0; d < 3; ++d)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float ak = lane4(av[d], k);
            acc[d][k][0] = fmaf(ak, b0.x, acc[d][k][0]);
            acc[d][k][1] = fmaf(ak, b0.y, acc[d][k][1]);
            acc[d][k][2] = fmaf(ak, b0.z, acc[d][k][2]);
            acc[d][k][3] = fmaf(ak, b0.w, acc[d][k][3]);
            acc[d][k][4] = fmaf(ak, b1.x, acc[d][k][4]);
            acc[d][k][5] = fmaf(ak, b1.y, acc[d][k][5]);
            acc[d][k][6] = fmaf(ak, b1.z, acc[d][k][6]);
            acc[d][k][7] = fmaf(ak, b1.w, acc[d][k][7]);
          }
      }
    }
  };

  // The producer readies step j+1 while the consumers multiply step j; one
  // barrier a step publishes the one and frees the other's buffers.
  if (producer && nq > 0) produce(0, 0);
  __syncthreads();
  for (int j = 0; j < nq; ++j) {
    const int b = j & 1;
    if (producer) {
      if (j + 1 < nq) produce(j + 1, b ^ 1);
    } else if (tid < NTH && !(SFF_ABLATE & 2)) {
      products(b);
    }
    __syncthreads();                            // step j+1 formed; step j multiplied
  }

  // the block's [9 * CB, NB] of the slice's partial
  if (SFF_ABLATE & 8) {
    if (H < 0)                                  // never true: keeps the products alive
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int c = 0; c < 8; ++c) a.out[(d * 4 + k) * 8 + c] = acc[d][k][c];
    return;
  }
  if (tid >= NTH || c0 + cg * 4 >= Ci) return;
  float* out = a.out + (int64_t)slice * 9 * Ci * Co;
  const bool lo = n0 + ng * 4 < Co, hi = n0 + NB / 2 + ng * 4 < Co;
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float* r = out + ((int64_t)(dh * 3 + d) * Ci + c0 + cg * 4 + k) * Co + n0 +
                 ng * 4;
      if (lo)
        *reinterpret_cast<float4*>(r) =
            make_float4(acc[d][k][0], acc[d][k][1], acc[d][k][2], acc[d][k][3]);
      if (hi)
        *reinterpret_cast<float4*>(r + NB / 2) =
            make_float4(acc[d][k][4], acc[d][k][5], acc[d][k][6], acc[d][k][7]);
    }
}

// ge[m, c] = fold(gy, y, gs1[c], gs2[c]) over [M, C] (C a multiple of 4),
// the walk's input
__global__ void __launch_bounds__(256)
fold_f32_kernel(const float* __restrict__ gy, const float* __restrict__ y,
                const float* __restrict__ gs1, const float* __restrict__ gs2,
                float* __restrict__ ge, int64_t M, int C) {
  const int64_t n4 = M * C / 4;
  const int c4s = C / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const int c = (int)(i % c4s) * 4;
    reinterpret_cast<float4*>(ge)[i] =
        fold4(ld4(gy + 4 * i), ld4(y + 4 * i), ld4(gs1 + c), ld4(gs2 + c));
  }
}

template <int NCG, bool AFFINE>
int launch_spatial_filter_f32(const SpatialFilterF32Args& a, int blocks,
                              cudaStream_t stream) {
  const size_t smem = sff_smem(a.W, a.XR, a.S, 8 * NCG);
  if (smem > (size_t)SWF_SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = spatial_filter_f32_kernel<NCG, AFFINE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<blocks, sff_block(NCG), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The spatial data gradient: the row walk (spatial_data_f32_kernel)
// ---------------------------------------------------------------------------
//
// Replaces _spatial_bwd's data gradient (m3f/pytorch_tpu/ops/pallas/
// conv_bn.py:537, kernel _spatial_bwd_data_kernel at :293, ge from _gy_eff
// at :287) for fp32 x:
//   dx^[m, ci] = sum_tap sum_co ge[neighbour(m, tap), co] * W[8 - tap, ci, co]
// with ge 0 in the padding, then with the prologue the mask, dx = f32(dxa *
// inv) and dinv / dshift. At the train step's stage 1 (gy [32,16,56,56,144]
// -> dx 64) a launch is 0.26 TFLOP of fp32 FMA on 2.6 GB: 3.9 ms at 67
// TFLOP/s against 0.8 ms of memory, and every stage is operation-bound.
// What the per-tap gather (bwd_data_f32_kernel) spent beyond the products
// (ge folded again for each of the nine taps and each 64-channel N tile: 9
// to 72 times a pixel; one LDS.128 of A and one of B per 16 FFMA; loads
// through registers with a bounds test per vector; at stages 3-4 a long K
// over few positions, 13% of the SMs' time idle at the end) is what this
// design takes out. It is spatial_fwd_f32_kernel's walk with ge in place of
// x^ and the mirrored filter in place of W, and the bf16 spatial_data_kernel's
// epilogue (conv_bn.cu).
//
// - Row walk. A block walks a range of whole (b, t) images as one dense
//   stream of output pixels, S a step, with an all-zero row before every
//   image and after the last and columns 0 and W+1 zero: ge's padding, 0
//   and not the fold of a zero gy and y (gs1). A pixel's taps are one base
//   offset plus (dh * (W+2) + dw) pixels, tap t meeting the filter's row
//   block t of [9 * Co, Ci] (W[8 - t] transposed, laid out by the wrapper).
// - K inside a step, in chunks of KC output channels (16, or 8 where the
//   buffers need it) for all nine taps: the block copies the step's gy and y
//   rows for the chunk with cp.async (zero-filled on the zero rows and past
//   C_out), each thread folds ge = gy + (gs1 + (2 y) gs2) in place once on
//   the vectors it copied, after its own wait_group (each op rounded; never
//   on the zero rows, columns or channels), and the filter chunk [9 * KC,
//   NB] streams from the L2 with it. gy and the filter are double
//   buffered, y single (only its copier reads it, before the barrier that
//   frees it): one barrier a chunk, ge formed once per staged pixel, step
//   and N tile (a step's halo rows twice).
// - FFMA microkernel (spatial_fwd_f32_kernel's): NPG x NCG threads, each 8
//   pixels (pg + NPG i) x 8 input channels (4 at cg * 4, 4 at NB/2 + cg *
//   4), 64 fp32 sums; 16 LDS.128 per 256 FFMA. N tiles of NB = 64 (steps of
//   256, C_in 64) or 128 (steps of 128, C_in 128 / 256 / 512), at most 8
//   warps a block (9 cap a thread at 168 registers and spill); other
//   multiples of 8 take a masked last tile.
// - Epilogue: dx leaves from registers in 16-byte stores along the
//   channels; with the prologue x is read there from global memory (an x
//   tile in shared memory beside three ge / y buffers and two filter chunks
//   would not fit at stage 1), xa = f32(f32(x * inv) + shift) with two
//   roundings, the mask, dx = f32(dxa * inv), and dinv / dshift as per-thread
//   fp32 sums over the walk in a fixed order, then the NPG pixel groups in
//   order into one partial row per range, summed by colsum_f32_kernel.
// - K split (short M, long K: stages 3-4, where one range per SM would hold
//   a few images and round its steps up): the grid's ranges may also cut the
//   chunks, each split writing its partial dx^ [M, Ci] straight from the
//   registers; data_split_sum_f32_kernel then sums the splits in order and
//   applies the epilogue (the mask needs the whole sum), one partial row of
//   dinv / dshift per 64 positions. No atomics anywhere: two calls give the
//   same bits.
// - Grid: ranges x splits x N tiles, the N tile fastest (the blocks reading
//   the same ge run together), one block a SM. f32_spatial_data_plan
//   (ops/conv_bn.py) picks NB, KC, the ranges and the splits for the least
//   modelled time in one wave.

constexpr int SDF_SUM_ROWS = 64;      // positions a block of the split sum
// Measurement knob, for filter_sweep.py only (dx is then wrong): 1 leaves
// out forming ge, 2 the products, 4 the copies of gy, y and the filter (the
// buffers keep what they held), 8 the epilogue (dx stores and sums); 15
// leaves the walk alone.
#ifndef SDF_ABLATE
#define SDF_ABLATE 0
#endif

struct SpatialDataF32Args {
  const float* gy;     // [images, H, W, Co]
  const float* y;
  const float* gs1;    // [Co]
  const float* gs2;
  const float* wt;     // [9 * Co, Ci], row tap * Co + co = W[8 - tap, ci, co]
  const float* x;      // [images, H, W, Ci] (the prologue, one split) or null
  const float* inv;    // [Ci] or null
  const float* shift;
  float* dx;           // [images, H, W, Ci], or [splits][M][Ci] partial dx^
  float* part1;        // [ranges, Ci]: dinv's partial rows (the prologue)
  float* part2;        // [ranges, Ci]: dshift's
  int64_t M;           // positions: a split's stride
  int H, W, Ci, Co;
  int images, images_per_range, n_tiles, splits, chunks_per_split;
  int XR;              // rows of a chunk buffer (swf_rows at the step)
};

// A block's shared memory: two gy / ge chunk buffers and one y buffer
// [XR][W + 2][KC + 4], two filter chunks [9 * KC][NB] (the block's sums
// reuse them at the end); ops/conv_bn.py (_spatial_data_f32_smem) computes
// the same.
size_t sdf_smem(int W, int XR, int KC, int NB) {
  return (3 * (size_t)XR * (W + 2) * (KC + 4) + 2 * (size_t)9 * KC * NB) *
         sizeof(float);
}

// NPG x NCG threads, each 8 pixels x 8 input channels: S = 8 * NPG pixels
// a step, NB = 8 * NCG input channels a block.
template <int NCG, int NPG, int KC, bool AFFINE>
__global__ void __launch_bounds__(NPG * NCG, 1)
spatial_data_f32_kernel(const SpatialDataF32Args a) {
  constexpr int NTH = NPG * NCG, NB = 8 * NCG, S = 8 * NPG;
  constexpr int LDC = KC + 4;                  // a pixel's stride (floats)
  constexpr int QV = KC / 4;                   // 16-byte vectors of a pixel's chunk
  constexpr int XP = NTH / QV;                 // pixels of a copy pass
  constexpr int FR = 9 * KC;                   // filter rows of a chunk
  constexpr int FV = FR * NB / 4;              // 16-byte vectors of a filter chunk
  constexpr int F_IT = (FV + NTH - 1) / NTH;
  static_assert(NTH % QV == 0 && NPG <= FR && NTH <= 256 && NB <= NTH,
                "copies, block sums, 8 warps");
  const int H = a.H, W = a.W, Ci = a.Ci, Co = a.Co;
  const int WP = W + 2, HW = H * W;
  const int BUF = a.XR * WP * LDC;             // floats of a chunk buffer
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Gb = reinterpret_cast<float*>(smem_raw);   // [2][XR][WP][LDC]: gy, then ge
  float* Yb = Gb + 2 * BUF;                         // [XR][WP][LDC]: y
  float* Fb = Yb + BUF;                             // [2][FR][NB]

  const int tid = threadIdx.x;
  const int cg = tid % NCG, pg = tid / NCG;
  const int n0 = ((int)blockIdx.x % a.n_tiles) * NB;
  const int rs = (int)blockIdx.x / a.n_tiles;  // range * splits + split
  const int split = rs % a.splits, range = rs / a.splits;
  const int i0 = range * a.images_per_range;
  const int nimg = min(a.images, i0 + a.images_per_range) - i0;
  const int Q = nimg * HW;                      // output pixels of the range
  const int nq = (Q + S - 1) / S;               // steps of the walk
  const int c_lo = split * a.chunks_per_split;  // this split's chunks
  const int c_hi = min((Co + KC - 1) / KC, c_lo + a.chunks_per_split);
  const int64_t P0 = (int64_t)i0 * HW;          // the range's first pixel
  const int cq = (tid % QV) * 4;                // this thread's channels of a chunk
  float* dx = a.dx + (int64_t)split * a.M * Ci;

  // The gy buffers zero once: the padding columns are never written again.
  for (int i = tid; i < 2 * BUF / 4; i += NTH)
    reinterpret_cast<float4*>(Gb)[i] = zero4();
  __syncthreads();

  // This thread's vectors of a step: channels cq .. cq+3 of each chunk at
  // buffer offset v_off of the range's pixel v_pix (-1: a zero row, -2:
  // none). The same for every chunk of the step; a thread copies and folds
  // exactly these.
  int v_off[SWF_VMAX], v_pix[SWF_VMAX];
  auto seek_copies = [&](int j) {
    const int q0 = j * S, q1 = min(Q, q0 + S) - 1;
    const int r0 = swf_stream_row(q0, W, H) - 1;
    const int npp = (swf_stream_row(q1, W, H) + 2 - r0) * W;
#pragma unroll
    for (int k = 0; k < SWF_VMAX; ++k) {
      const int pp = tid / QV + k * XP;
      v_off[k] = 0;
      v_pix[k] = -2;
      if (pp < npp) {
        const int lr = pp / W, w = pp - lr * W;
        const int vr = r0 + lr;
        const int img = vr / (H + 1), hr = vr - img * (H + 1);
        v_off[k] = (lr * WP + w + 1) * LDC + cq;
        v_pix[k] = hr == 0 ? -1 : (img * H + hr - 1) * W + w;
      }
    }
  };
  // This thread's output pixels of step j: the offset of the padded pixel
  // (h - 1, w - 1) in the chunk buffer (0 past the range: their dx is
  // neither stored nor summed).
  int base[8];
  auto seek_pixels = [&](int j) {
    const int r0 = swf_stream_row(j * S, W, H) - 1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = j * S + pg + NPG * i;
      base[i] = 0;
      if (q < Q) {
        const int rho = q / W;
        base[i] = ((rho + rho / H - r0) * WP + q - rho * W) * LDC;
      }
    }
  };
  // chunk ck of the current step into buffer b: the step's gy and y rows for
  // output channels ck*KC .. +KC-1, and the filter chunk [9 * KC, NB]
  auto copy_chunk = [&](int ck, int b) {
    if (SDF_ABLATE & 4) return;
    const int ch = ck * KC + cq;
    float* gd = Gb + b * BUF;
#pragma unroll
    for (int k = 0; k < SWF_VMAX; ++k) {
      if (v_pix[k] < -1) continue;
      const bool real = v_pix[k] >= 0 && ch < Co;
      const int64_t src = real ? (P0 + v_pix[k]) * Co + ch : 0;
      cp_async16(gd + v_off[k], a.gy + src, real);
      if (real) cp_async16(Yb + v_off[k], a.y + src, true);
    }
    float* fd = Fb + b * FR * NB;
#pragma unroll
    for (int i = 0; i < F_IT; ++i) {
      const int idx = tid + i * NTH;
      if (FV % NTH != 0 && idx >= FV) break;
      const int r = idx / (NB / 4), c4 = (idx - r * (NB / 4)) * 4;
      const int tap = r / KC, co = ck * KC + r - tap * KC;
      const bool ok = co < Co && n0 + c4 < Ci;
      cp_async16(fd + r * NB + c4,
                 ok ? a.wt + ((int64_t)tap * Co + co) * Ci + n0 + c4 : a.wt, ok);
    }
  };
  // ge = gy + (gs1 + (2 y) gs2) in place, on this thread's vectors of real
  // pixels and channels (never the zero rows, columns or channels past Co)
  auto form_chunk = [&](int ck, int b) {
    const int ch = ck * KC + cq;
    if ((SDF_ABLATE & 1) || ch >= Co) return;
    const float4 g1 = ld4(a.gs1 + ch), g2 = ld4(a.gs2 + ch);
    float* gd = Gb + b * BUF;
#pragma unroll
    for (int k = 0; k < SWF_VMAX; ++k) {
      if (v_pix[k] < 0) continue;
      float4* p = reinterpret_cast<float4*>(gd + v_off[k]);
      *p = fold4(*p, ld4(Yb + v_off[k]), g1, g2);
    }
  };

  float acc[8][8];
  // acc[i][c] += ge at pixel i's tap t, output channel k, times the
  // mirrored filter's row (t, k) at this thread's 8 input channels, over the
  // chunk in buffer b
  auto products = [&](int b) {
    walk_products<KC, NB, LDC>(Gb + b * BUF, Fb + b * FR * NB + cg * 4, base,
                               WP, acc);
  };

  float s1[8], s2[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) s1[c] = s2[c] = 0.f;

  if (nq > 0 && c_lo < c_hi) {
    seek_copies(0);
    copy_chunk(c_lo, 0);
  }
  cp_async_commit();
  int b = 0;                                    // the buffer of the chunk multiplied
  for (int j = 0; j < nq && c_lo < c_hi; ++j) {
    seek_pixels(j);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
    for (int ck = c_lo; ck < c_hi; ++ck) {
      cp_async_wait_all();                      // this thread's copies of the chunk
      form_chunk(ck, b);
      __syncthreads();                          // the chunk formed; the one before done
      if (ck + 1 < c_hi) {                      // the next chunk, into the other buffers
        copy_chunk(ck + 1, b ^ 1);
      } else if (j + 1 < nq) {                  // the next step's first
        seek_copies(j + 1);
        copy_chunk(c_lo, b ^ 1);
      }
      cp_async_commit();
      if (!(SDF_ABLATE & 2)) products(b);
      b ^= 1;
    }

    // epilogue: dx (or the split's partial dx^) straight from the
    // registers; with the prologue the mask and inv from x, and the step's
    // share of dinv / dshift in a fixed order
    const int npx = min(S, Q - j * S);
    if (!(SDF_ABLATE & 8)) {
      const bool lo = n0 + cg * 4 < Ci, hi = n0 + NB / 2 + cg * 4 < Ci;
      float4 iv[2] = {zero4(), zero4()}, sv[2] = {zero4(), zero4()};
      if (AFFINE) {
        if (lo) {
          iv[0] = ld4(a.inv + n0 + cg * 4);
          sv[0] = ld4(a.shift + n0 + cg * 4);
        }
        if (hi) {
          iv[1] = ld4(a.inv + n0 + NB / 2 + cg * 4);
          sv[1] = ld4(a.shift + n0 + NB / 2 + cg * 4);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = pg + NPG * i;
        if (p >= npx) continue;
        const int64_t m = P0 + (int64_t)j * S + p;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!(h ? hi : lo)) continue;
          const int n = n0 + h * (NB / 2) + cg * 4;
          float d[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]};
          if (AFFINE) {
            const float4 x4 = ld4(a.x + m * Ci + n);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float xv = lane4(x4, k), ivk = lane4(iv[h], k);
              const float xa = __fadd_rn(__fmul_rn(xv, ivk), lane4(sv[h], k));
              const float dxa = xa > 0.f ? d[k] : 0.f;
              d[k] = __fmul_rn(dxa, ivk);
              s1[4 * h + k] = __fadd_rn(s1[4 * h + k], __fmul_rn(xv, dxa));
              s2[4 * h + k] = __fadd_rn(s2[4 * h + k], dxa);
            }
          }
          *reinterpret_cast<float4*>(dx + m * Ci + n) =
              make_float4(d[0], d[1], d[2], d[3]);
        }
      }
    } else if (H < 0) {                         // never true: keeps the products alive
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) dx[i * 8 + c] = acc[i][c];
    }
  }
  if (!AFFINE) return;
  cp_async_wait_all();
  __syncthreads();                              // every product read: reuse the filter buffers

  // the range's partial row: the NPG pixel groups in order
  float* red1 = Fb;                             // [NPG][NB]
  float* red2 = Fb + NPG * NB;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    red1[pg * NB + cg * 4 + c] = s1[c];
    red1[pg * NB + NB / 2 + cg * 4 + c] = s1[4 + c];
    red2[pg * NB + cg * 4 + c] = s2[c];
    red2[pg * NB + NB / 2 + cg * 4 + c] = s2[4 + c];
  }
  __syncthreads();
  if (tid < NB && n0 + tid < Ci) {
    float v1 = 0.f, v2 = 0.f;
    for (int g = 0; g < NPG; ++g) {
      v1 += red1[g * NB + tid];
      v2 += red2[g * NB + tid];
    }
    a.part1[(int64_t)range * Ci + n0 + tid] = v1;
    a.part2[(int64_t)range * Ci + n0 + tid] = v2;
  }
}

// The K split's second pass: dx^ = the splits' partials [splits][M][Ci]
// summed in split order, then (AFFINE) the mask, dx = f32(dxa * inv) and one
// partial row of dinv / dshift per block of SDF_SUM_ROWS positions (4 groups
// of rows in a fixed order). Block (x: positions, y: 256 channels).
template <bool AFFINE>
__global__ void __launch_bounds__(256)
data_split_sum_f32_kernel(const float* __restrict__ part, int splits,
                          int64_t M, int Ci, const float* __restrict__ x,
                          const float* __restrict__ inv,
                          const float* __restrict__ shift,
                          float* __restrict__ dx, float* __restrict__ part1,
                          float* __restrict__ part2) {
  __shared__ float red1[4][256], red2[4][256];
  const int tid = threadIdx.x, g = tid / 64;
  const int c = ((int)blockIdx.y * 64 + tid % 64) * 4;
  const bool ok = c < Ci;
  float4 iv = zero4(), sv = zero4();
  if (AFFINE && ok) {
    iv = ld4(inv + c);
    sv = ld4(shift + c);
  }
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  const int64_t m0 = (int64_t)blockIdx.x * SDF_SUM_ROWS;
  for (int p = g; ok && p < SDF_SUM_ROWS && m0 + p < M; p += 4) {
    const int64_t m = m0 + p;
    float4 d = ld4(part + m * Ci + c);
    for (int k = 1; k < splits; ++k) {
      const float4 e = ld4(part + ((int64_t)k * M + m) * Ci + c);
      d = make_float4(__fadd_rn(d.x, e.x), __fadd_rn(d.y, e.y),
                      __fadd_rn(d.z, e.z), __fadd_rn(d.w, e.w));
    }
    if (AFFINE) {
      const float4 x4 = ld4(x + m * Ci + c);
      float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float xv = lane4(x4, k), ivk = lane4(iv, k);
        const float xa = __fadd_rn(__fmul_rn(xv, ivk), lane4(sv, k));
        const float dxa = xa > 0.f ? dv[k] : 0.f;
        dv[k] = __fmul_rn(dxa, ivk);
        s1[k] = __fadd_rn(s1[k], __fmul_rn(xv, dxa));
        s2[k] = __fadd_rn(s2[k], dxa);
      }
      d = make_float4(dv[0], dv[1], dv[2], dv[3]);
    }
    *reinterpret_cast<float4*>(dx + m * Ci + c) = d;
  }
  if (!AFFINE) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    red1[g][(tid % 64) * 4 + k] = s1[k];
    red2[g][(tid % 64) * 4 + k] = s2[k];
  }
  __syncthreads();
  const int col = (int)blockIdx.y * 256 + tid;
  if (col < Ci) {
    float v1 = 0.f, v2 = 0.f;
    for (int r = 0; r < 4; ++r) {
      v1 += red1[r][tid];
      v2 += red2[r][tid];
    }
    part1[(int64_t)blockIdx.x * Ci + col] = v1;
    part2[(int64_t)blockIdx.x * Ci + col] = v2;
  }
}

template <int NCG, int NPG, int KC, bool AFFINE>
int launch_spatial_data_f32(const SpatialDataF32Args& a, int blocks,
                            cudaStream_t stream) {
  constexpr int NTH = NPG * NCG;
  const size_t smem = sdf_smem(a.W, a.XR, KC, 8 * NCG);
  if (smem > (size_t)SWF_SMEM_MAX || a.XR * a.W > SWF_VMAX * (NTH / (KC / 4)))
    return (int)cudaErrorInvalidValue;
  auto kern = spatial_data_f32_kernel<NCG, NPG, KC, AFFINE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<blocks, NTH, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The layouts f32_spatial_data_plan (ops/conv_bn.py) can ask for: (N tile,
// K chunk) -> NCG = N tile / 8 channel groups, NPG pixel groups (8 warps).
template <int NCG, int NPG, int KC>
int spatial_data_f32_either(bool affine, SpatialDataF32Args a, int blocks,
                            cudaStream_t s) {
  a.XR = swf_rows(a.H, a.W, 8 * NPG);
  return affine ? launch_spatial_data_f32<NCG, NPG, KC, true>(a, blocks, s)
                : launch_spatial_data_f32<NCG, NPG, KC, false>(a, blocks, s);
}

// ---------------------------------------------------------------------------
// The temporal data gradient: the frame walk (temporal_data_f32_kernel)
// ---------------------------------------------------------------------------
//
// Replaces _temporal_bwd's data gradient (m3f/pytorch_tpu/ops/pallas/
// conv_bn.py:612, kernel _temporal_bwd_data_kernel at :407, ge from _gy_eff
// at :287) for fp32 x:
//   dx^[b,t,p,ci] = sum_k sum_co ge[b,t+k-1,p,co] * W[2-k][ci,co]
// with ge 0 at the frames -1 and T (not the fold of a zero gy and y, which
// is gs1), then with the prologue the mask, dx = f32(dxa * inv) and dinv /
// dshift. At the train step's stage 1 (gy [32,16,56,56,64] -> dx 144) a
// launch is 85 GFLOP of fp32 FMA on 2.7 GB: 1.27 ms at 67 TFLOP/s against
// 0.80 ms of memory, and every stage is operation-bound. What the per-tap
// gather (bwd_data_f32_kernel's first design) spent beyond the products (ge
// gathered and folded again for each of the three taps and each 64-channel
// N tile, a quarter of stage 1's columns padding, 4x4 register tiles, a
// synchronous gather through registers, (b, t, h, w) decoded per tile) is
// what this design takes out. It is temporal_fwd_f32_kernel's walk with ge
// in place of x^ and the mirrored filter in place of W, and
// spatial_data_f32_kernel's epilogue.
//
// - Frame walk. A unit is a strip of S consecutive positions of the
//   flattened B*H*W axis (across clips where H*W is small), walked over t =
//   0..T-1; a block's units follow one another in one stream of chunks.
//   Frame t's gy and y arrive by cp.async in chunks of KC = 16 output
//   channels (gy double buffered, zero-filled past the strip and past
//   C_out; y single: only its copier reads it, before the barrier that frees
//   it). Each thread folds ge = gy + (gs1 + (2 y) gs2) in place once on the
//   vectors it copied, after its own wait_group (each op rounded; never past
//   the strip or past C_out). The folded chunk feeds three accumulator sets,
//   dx^ frames t+1 (tap 0), t (tap 1) and t-1 (tap 2); a tap whose frame
//   lies outside the clip is skipped, which is ge's zero padding. After
//   frame t's last chunk dx^ frame t-1 is complete and leaves through the
//   epilogue, and the sets shift by one frame.
// - The mirrored filter [3 * C_out, C_in] (row tap * Co + co = W[2 - tap,
//   ci, co], laid out by the wrapper) stays resident in shared memory where
//   [3 * C_out, NB] fits beside the buffers (loaded once a block with the
//   first chunk), else streams in [3 * KC, NB] chunks with the ge chunks.
// - FFMA microkernel (temporal_fwd_f32_kernel's): NPG x NCG threads, each 4
//   positions (pg + NPG i) x 8 input channels (4 at cg * 4, 4 at NB/2 + cg
//   * 4) x 3 frames, 96 fp32 sums; 28 LDS.128 per 384 FFMA. N tiles of NB =
//   8 * NCG: 64 (a warp is 4 position groups x 8 channel groups and reads B
//   in one wavefront), or 144, which divides every train stage's C_in (a
//   warp then holds threads tid % NCG and reads B in three wavefronts, and
//   still beats 8 positions x 4 channels a thread, whose warps read A and B
//   in one each; tiles of 48 and 72 won no stage: PERF.md); the
//   strip S = 4 * NPG is the most that 8 warps hold (tdf_run's instances
//   below).
// - Epilogue: dx leaves from registers in 16-byte stores along the
//   channels. With the prologue each thread copies the x vectors its
//   epilogue will read (4 positions x 8 channels of each finished frame)
//   by cp.async into its own slots of shared memory before the frame's
//   last chunk is multiplied, as a group of its own that the products then
//   hide (reading them from global memory in the epilogue stalled the
//   block: PERF.md); then xa = f32(f32(x * inv) + shift) with two
//   roundings, the mask, dx = f32(dxa * inv), and dinv / dshift as
//   per-thread fp32 sums over the walk in a fixed order (units, frames,
//   positions), then the NPG position groups in order into one partial row
//   per range, summed by colsum_f32_kernel. No atomics: two calls give the
//   same bits.
// - Grid: ranges of units x N tiles, the N tile fastest (the blocks reading
//   the same ge run together), one block a SM; f32_temporal_data_plan
//   (ops/conv_bn.py) picks NB and sizes the ranges for the fewest unit-times
//   to the last block's end.

constexpr int TDF_KC = 16;            // output channels a chunk
// Measurement knob, for filter_sweep.py only (dx is then wrong, but for
// 16): 1 leaves out folding ge, 2 the products, 4 the copies of gy, y, x
// and the filter (the buffers keep what they held), 8 the epilogue (dx
// stores and sums, and the copies of x); 15 leaves the walk alone; 16 reads
// x from global memory in the epilogue (the first design) in place of the
// copies ahead.
#ifndef TDF_ABLATE
#define TDF_ABLATE 0
#endif

struct TemporalDataF32Args {
  const float* gy;     // [B, T, H*W, Co]
  const float* y;
  const float* gs1;    // [Co]
  const float* gs2;
  const float* wt;     // [3 * Co, Ci], row tap * Co + co = W[2 - tap, ci, co]
  const float* x;      // [B, T, H*W, Ci] (the prologue) or null
  const float* inv;    // [Ci] or null
  const float* shift;
  float* dx;           // [B, T, H*W, Ci]
  float* part1;        // [ranges, Ci]: dinv's partial rows (the prologue)
  float* part2;        // [ranges, Ci]: dshift's
  int64_t positions;   // B * H*W: the axis the strips cut
  int T, HW, Ci, Co;
  int units;           // ceil(positions / S)
  int units_per_range;
  int n_tiles;
  int resident;        // the block's filter tile stays in shared memory
};

// A block's shared memory: two gy / ge chunk buffers and one y buffer
// [S][KC + 4], with the prologue the threads' x slots (two frames of 4
// positions x 8 channels a thread: 2 * S * NB floats), and the filter
// (resident [3 * Cop][NB], Cop = C_out in whole chunks, or two streamed
// chunks [3 * KC][NB]); the block's sums reuse it at the end.
// ops/conv_bn.py (_temporal_data_f32_smem) computes the same.
size_t tdf_smem(int S, int NB, int Cop, int res, int aff) {
  const size_t filt = res ? (size_t)3 * Cop * NB : (size_t)2 * 3 * TDF_KC * NB;
  const size_t xs = aff ? (size_t)2 * S * NB : 0;
  return sizeof(float) * (filt + xs + (size_t)3 * S * (TDF_KC + 4));
}

// NPG x NCG threads, each 4 positions x 8 input channels (two vectors of
// 4) x 3 frames: S = 4 * NPG positions a strip, NB = 8 * NCG input
// channels a block.
template <int NCG, int NPG, bool AFFINE>
__global__ void __launch_bounds__(NPG * NCG, 1)
temporal_data_f32_kernel(const TemporalDataF32Args a) {
  constexpr int PT = 4, CV = 2;                // positions, channel vectors
  constexpr int NTH = NPG * NCG, NB = 8 * NCG, S = 4 * NPG;
  constexpr int NV = NB / 2;                   // channel vector j at j * NV
  constexpr int KC = TDF_KC, LDC = KC + 4;     // a position's stride (floats)
  constexpr int QV = KC / 4;                   // 16-byte vectors of a position's chunk
  constexpr int GVN = S * QV;                  // 16-byte vectors of a strip's chunk
  constexpr int GV = (GVN + NTH - 1) / NTH;    // ... a thread copies, at most
  constexpr int FR = 3 * KC;                   // filter rows of a chunk
  constexpr int FV = FR * NB / 4;              // 16-byte vectors of a filter chunk
  constexpr int F_IT = (FV + NTH - 1) / NTH;
  static_assert(NTH % QV == 0 && NTH <= 256 && NTH >= NB &&
                    (NCG % 8 != 0 || NPG % 4 == 0) &&
                    2 * NPG * NB <= 3 * S * LDC + 2 * FR * NB,
                "copies, warp layout, 8 warps, block sums");
  const int T = a.T, HW = a.HW, Ci = a.Ci, Co = a.Co;
  const bool res = a.resident != 0;
  const int nck = (Co + KC - 1) / KC;          // chunks a frame
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Gb = reinterpret_cast<float*>(smem_raw);   // [2][S][LDC]: gy, then ge
  float* Yb = Gb + 2 * S * LDC;                     // [S][LDC]: y
  float* Xs = Yb + S * LDC;                         // [2][8][NTH] float4: x
  float* Fb = Xs + (AFFINE ? 2 * S * NB : 0);       // [nck][FR][NB] or [2][FR][NB]

  const int tid = threadIdx.x;
  int cg, pg;                                   // channels j * NV + cg*4,
  if constexpr (NCG % 8 == 0) {                 // positions pg + NPG*i
    const int lane = tid & 31, warp = tid >> 5; // a warp: 4 x 8 of them
    cg = (warp % (NCG / 8)) * 8 + (lane >> 2);
    pg = (warp / (NCG / 8)) * 4 + (lane & 3);
  } else {
    cg = tid % NCG;
    pg = tid / NCG;
  }
  const int n0 = ((int)blockIdx.x % a.n_tiles) * NB;
  const int range = (int)blockIdx.x / a.n_tiles;
  const int u0 = range * a.units_per_range;
  const int u1 = min(a.units, u0 + a.units_per_range);
  const int nq = u1 > u0 ? (u1 - u0) * T * nck : 0;   // chunks of the walk
  const int cq = (tid % QV) * 4;               // this thread's channels of a chunk

  // the resident filter: chunk c's rows tap * KC + k at [c][FR][NB], zero
  // past Co and Ci
  if (res && !(TDF_ABLATE & 4)) {
    for (int idx = tid; idx < nck * FV; idx += NTH) {
      const int r = idx / (NB / 4), c4 = (idx - r * (NB / 4)) * 4;
      const int c = r / FR, tap = (r - c * FR) / KC;
      const int co = c * KC + r - c * FR - tap * KC;
      const bool ok = co < Co && n0 + c4 < Ci;
      cp_async16(Fb + r * NB + c4,
                 ok ? a.wt + ((int64_t)tap * Co + co) * Ci + n0 + c4 : a.wt, ok);
    }
  }

  // The position of strip row r of unit u at frame 0, b*T*HW + p (-1 past
  // the positions): only entering a unit divides.
  auto row_pos = [&](int u, int r) -> int64_t {
    const int64_t gp = (int64_t)u * S + r;
    if (gp >= a.positions) return -1;
    const int64_t b = gp / HW;
    return b * T * HW + (gp - b * HW);
  };
  // This thread's gy / y vectors of a chunk: tid + j*NTH -> strip row
  // (tid + j*NTH) / QV, channels cq .. cq+3 of the chunk (-2: none)
  int64_t g_pos[GV];
  auto seek_g = [&](int u) {
#pragma unroll
    for (int j = 0; j < GV; ++j) {
      const int idx = tid + j * NTH;
      g_pos[j] = idx < GVN ? row_pos(u, idx / QV) : -2;
    }
  };
  // This thread's dx positions, strip rows pg + NPG*i
  int64_t d_pos[PT];
  auto seek_d = [&](int u) {
#pragma unroll
    for (int i = 0; i < PT; ++i) d_pos[i] = row_pos(u, pg + NPG * i);
  };

  // A cursor on the walk: chunk c of frame t of unit u, the walk's q-th.
  struct Cursor {
    int q, u, t, c;
  };
  auto advance = [&](Cursor& w) {
    ++w.q;
    if (++w.c < nck) return false;
    w.c = 0;
    if (++w.t < T) return false;
    w.t = 0;
    ++w.u;
    return true;                   // a new unit
  };

  // chunk w: the strip's gy rows at frame w.t for the chunk's output
  // channels into buffer w.q & 1, its y rows into the y buffer, and
  // (streamed) the filter chunk
  auto copy_chunk = [&](const Cursor& w) {
    if (TDF_ABLATE & 4) return;
    const int ch = w.c * KC + cq;
    float* gd = Gb + (w.q & 1) * S * LDC;
    const int64_t frame = (int64_t)w.t * HW;
#pragma unroll
    for (int j = 0; j < GV; ++j) {
      if (g_pos[j] < -1) continue;
      const int off = (tid + j * NTH) / QV * LDC + cq;
      const bool ok = g_pos[j] >= 0 && ch < Co;
      const int64_t src = ok ? (g_pos[j] + frame) * Co + ch : 0;
      cp_async16(gd + off, a.gy + src, ok);
      if (ok) cp_async16(Yb + off, a.y + src, true);
    }
    if (res) return;
    float* fd = Fb + (w.q & 1) * FR * NB;
#pragma unroll
    for (int i = 0; i < F_IT; ++i) {
      const int idx = tid + i * NTH;
      if (FV % NTH != 0 && idx >= FV) break;
      const int r = idx / (NB / 4), c4 = (idx - r * (NB / 4)) * 4;
      const int tap = r / KC, co = w.c * KC + r - tap * KC;
      const bool ok = co < Co && n0 + c4 < Ci;
      cp_async16(fd + r * NB + c4,
                 ok ? a.wt + ((int64_t)tap * Co + co) * Ci + n0 + c4 : a.wt, ok);
    }
  };
  // ge = gy + (gs1 + (2 y) gs2) in place, on this thread's vectors of the
  // chunk (never those past the strip or past Co)
  auto form_chunk = [&](const Cursor& w) {
    const int ch = w.c * KC + cq;
    if ((TDF_ABLATE & 1) || ch >= Co) return;
    const float4 g1 = ld4(a.gs1 + ch), g2 = ld4(a.gs2 + ch);
    float* gd = Gb + (w.q & 1) * S * LDC;
#pragma unroll
    for (int j = 0; j < GV; ++j) {
      if (g_pos[j] < 0) continue;
      const int off = (tid + j * NTH) / QV * LDC + cq;
      float4* p = reinterpret_cast<float4*>(gd + off);
      *p = fold4(*p, ld4(Yb + off), g1, g2);
    }
  };

  constexpr int NC = 4 * CV;       // a thread's input channels
  float acc[3][PT][NC];            // dx^ frames t-1, t, t+1
#pragma unroll
  for (int f = 0; f < 3; ++f)
#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[f][i][c] = 0.f;
  // acc[2 - tap][i][c] += ge at position i, output channel k, times the
  // mirrored filter's row (tap, k) at this thread's input channels, over
  // chunk w; the taps whose dx^ frame lies outside the clip are skipped
  auto products = [&](const Cursor& w) {
    const float* gs = Gb + (w.q & 1) * S * LDC + pg * LDC;
    const float* fs = (res ? Fb + w.c * FR * NB : Fb + (w.q & 1) * FR * NB) + cg * 4;
    const bool t0 = w.t + 1 < T, t2 = w.t > 0;
#pragma unroll
    for (int q = 0; q < QV; ++q) {
      float4 av[PT];
#pragma unroll
      for (int i = 0; i < PT; ++i) av[i] = ld4(gs + i * NPG * LDC + 4 * q);
#pragma unroll
      for (int tap = 0; tap < 3; ++tap) {
        if ((tap == 0 && !t0) || (tap == 2 && !t2)) continue;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* fr = fs + (tap * KC + 4 * q + kk) * NB;
          float4 bv[CV];
#pragma unroll
          for (int j = 0; j < CV; ++j) bv[j] = ld4(fr + j * NV);
#pragma unroll
          for (int i = 0; i < PT; ++i) {
            const float ak = lane4(av[i], kk);
            const int f = 2 - tap;
#pragma unroll
            for (int j = 0; j < CV; ++j) {
              acc[f][i][4 * j] = fmaf(ak, bv[j].x, acc[f][i][4 * j]);
              acc[f][i][4 * j + 1] = fmaf(ak, bv[j].y, acc[f][i][4 * j + 1]);
              acc[f][i][4 * j + 2] = fmaf(ak, bv[j].z, acc[f][i][4 * j + 2]);
              acc[f][i][4 * j + 3] = fmaf(ak, bv[j].w, acc[f][i][4 * j + 3]);
            }
          }
        }
      }
    }
  };

  float s1[NC], s2[NC];            // dinv's and dshift's per-thread sums
#pragma unroll
  for (int c = 0; c < NC; ++c) s1[c] = s2[c] = 0.f;
  bool ok[CV];                     // channel vector j inside Ci
#pragma unroll
  for (int j = 0; j < CV; ++j) ok[j] = n0 + j * NV + cg * 4 < Ci;
  // This thread's x slot k (j * PT + i: channel vector j, position i) of
  // frame slot fs: [fs][k][NTH] float4, a warp's lanes on consecutive
  // vectors
  auto x_slot = [&](int fs, int k) { return Xs + ((fs * 8 + k) * NTH + tid) * 4; };
  // the x vectors the epilogues of chunk w will read, into this thread's
  // slots: frame t-1 into slot 0, at the clip's last frame frame t into 1
  auto copy_x = [&](const Cursor& w) {
    if (TDF_ABLATE & (4 | 8 | 16)) return;
#pragma unroll
    for (int fs = 0; fs < 2; ++fs) {
      const int tf = w.t - 1 + fs;
      if ((fs == 0 && w.t == 0) || (fs == 1 && w.t + 1 != T)) continue;
      const int64_t frame = (int64_t)tf * HW;
#pragma unroll
      for (int j = 0; j < CV; ++j) {
        if (!ok[j]) continue;
        const int n = n0 + j * NV + cg * 4;
#pragma unroll
        for (int i = 0; i < PT; ++i)
          if (d_pos[i] >= 0)
            cp_async16(x_slot(fs, j * PT + i),
                       a.x + (d_pos[i] + frame) * Ci + n, true);
      }
    }
  };
  // dx^ frame tf of the current unit from accumulator set f, with the
  // prologue x from frame slot fs: the mask and inv, dx straight from the
  // registers, and its share of dinv / dshift in a fixed order
  auto epilogue = [&](const float (&f)[PT][NC], int tf, int fs) {
    if (TDF_ABLATE & 8) return;
    const int64_t frame = (int64_t)tf * HW;
#pragma unroll
    for (int j = 0; j < CV; ++j) {
      if (!ok[j]) continue;
      const int n = n0 + j * NV + cg * 4;
      float4 x4[PT];
      if (AFFINE) {
#pragma unroll
        for (int i = 0; i < PT; ++i)
          x4[i] = !(TDF_ABLATE & 16) ? ld4(x_slot(fs, j * PT + i))
                  : d_pos[i] < 0     ? zero4()
                                     : ld4(a.x + (d_pos[i] + frame) * Ci + n);
      }
      float4 iv = zero4(), sv = zero4();
      if (AFFINE) {
        iv = ld4(a.inv + n);
        sv = ld4(a.shift + n);
      }
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        if (d_pos[i] < 0) continue;
        float d[4] = {f[i][4 * j], f[i][4 * j + 1], f[i][4 * j + 2],
                      f[i][4 * j + 3]};
        if (AFFINE) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float xv = lane4(x4[i], k), ivk = lane4(iv, k);
            const float xa = __fadd_rn(__fmul_rn(xv, ivk), lane4(sv, k));
            const float dxa = xa > 0.f ? d[k] : 0.f;
            d[k] = __fmul_rn(dxa, ivk);
            s1[4 * j + k] = __fadd_rn(s1[4 * j + k], __fmul_rn(xv, dxa));
            s2[4 * j + k] = __fadd_rn(s2[4 * j + k], dxa);
          }
        }
        *reinterpret_cast<float4*>(a.dx + (d_pos[i] + frame) * Ci + n) =
            make_float4(d[0], d[1], d[2], d[3]);
      }
    }
  };

  Cursor cc{0, u0, 0, 0}, mc{0, u0, 0, 0};   // the chunk copied, multiplied
  if (nq > 0) {
    seek_g(u0);
    seek_d(u0);
    copy_chunk(cc);                 // with the resident filter, one group
  }
  cp_async_commit();
  for (int q = 0; q < nq; ++q) {
    cp_async_wait_all();            // this thread's copies of chunk q landed
    form_chunk(mc);
    __syncthreads();                // chunk q folded; chunk q-1 multiplied
    const bool last = mc.c == nck - 1;   // frame t's last chunk
    if (AFFINE && last) {           // the epilogue's x, a group of its own
      copy_x(mc);
      cp_async_commit();
    }
    if (q + 1 < nq) {               // chunk q+1, into the buffers of q-1
      if (advance(cc)) seek_g(cc.u);
      copy_chunk(cc);
    }
    cp_async_commit();
    if (!(TDF_ABLATE & 2)) products(mc);
    if (last) {                     // frame t-1 is done
      const int t = mc.t;
      if (AFFINE) cp_async_wait_one();   // this thread's x landed
      if (t > 0) epilogue(acc[0], t - 1, 0);
      if (t + 1 == T) {
        epilogue(acc[1], t, 1);
#pragma unroll
        for (int f = 0; f < 3; ++f)
#pragma unroll
          for (int i = 0; i < PT; ++i)
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[f][i][c] = 0.f;
      } else {
#pragma unroll
        for (int i = 0; i < PT; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc[0][i][c] = acc[1][i][c];
            acc[1][i][c] = acc[2][i][c];
            acc[2][i][c] = 0.f;
          }
      }
    }
    if (advance(mc)) seek_d(mc.u);
    if ((TDF_ABLATE & 8) && T < 0) {   // never true: keeps the products alive
#pragma unroll
      for (int f = 0; f < 3; ++f)
#pragma unroll
        for (int i = 0; i < PT; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) a.dx[(f * PT + i) * NC + c] = acc[f][i][c];
    }
  }
  if (!AFFINE) return;
  cp_async_wait_all();
  __syncthreads();                  // every product read: reuse the buffers

  // the range's partial row: the NPG position groups in order
  float* red1 = Gb;                 // [NPG][NB]
  float* red2 = Gb + NPG * NB;
#pragma unroll
  for (int j = 0; j < CV; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      red1[pg * NB + j * NV + cg * 4 + c] = s1[4 * j + c];
      red2[pg * NB + j * NV + cg * 4 + c] = s2[4 * j + c];
    }
  __syncthreads();
  if (tid < NB && n0 + tid < Ci) {
    float v1 = 0.f, v2 = 0.f;
    for (int g = 0; g < NPG; ++g) {
      v1 += red1[g * NB + tid];
      v2 += red2[g * NB + tid];
    }
    a.part1[(int64_t)range * Ci + n0 + tid] = v1;
    a.part2[(int64_t)range * Ci + n0 + tid] = v2;
  }
}

// One launch of the frame walk in the layout NCG x NPG (N tile 8 * NCG,
// strips of 4 * NPG positions) over ranges of per units, then with the
// prologue the fixed-order sum of the partial rows: the C entry's args
// completed here, since the strip sets the units.
template <int NCG, int NPG>
int tdf_run(TemporalDataF32Args a, int per, float* dinv, float* dshift,
            float* part, cudaStream_t s) {
  constexpr int S = 4 * NPG, NB = 8 * NCG;
  const int64_t units = (a.positions + S - 1) / S;
  const int64_t ranges = (units + per - 1) / per;
  const int n_tiles = (a.Ci + NB - 1) / NB;
  if (units >= ((int64_t)1 << 31) || ranges * n_tiles >= ((int64_t)1 << 31) ||
      units * a.T * ((a.Co + TDF_KC - 1) / TDF_KC) >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const bool affine = a.x != nullptr;
  a.units = (int)units;
  a.units_per_range = per;
  a.n_tiles = n_tiles;
  a.part1 = affine ? part : nullptr;
  a.part2 = affine ? part + ranges * a.Ci : nullptr;
  const int cop = (a.Co + TDF_KC - 1) / TDF_KC * TDF_KC;
  const size_t smem = tdf_smem(S, NB, cop, a.resident, affine);
  if (smem > (size_t)SWF_SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = affine ? temporal_data_f32_kernel<NCG, NPG, true>
                     : temporal_data_f32_kernel<NCG, NPG, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)(ranges * n_tiles), NPG * NCG, smem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || !affine) return (int)e;
  colsum_f32_kernel<<<(a.Ci + 31) / 32, dim3(32, 32), 0, s>>>(
      a.part1, a.part2, (int)ranges, a.Ci, dinv, dshift);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The temporal filter gradient: the frame walk (temporal_filter_f32_kernel)
// ---------------------------------------------------------------------------
//
// Replaces _temporal_bwd's filter gradient (m3f/pytorch_tpu/ops/pallas/
// conv_bn.py:625, kernel _temporal_bwd_filter_kernel at :454, ge from
// _gy_eff at :287) for fp32 x:
//   dw[k * Ci + ci, co] = sum_{b,t,p} x^[b, t+k-1, p, ci] * ge[b, t, p, co]
// with x^ 0 at the frames -1 and T (not relu(shift)). At the train step's
// stage 1 (x [32,16,56,56,144], ge [.., 64]) a launch is 85 GFLOP of fp32
// FMA on 1.7 GB: 1.27 ms at 67 TFLOP/s against 0.52 ms of memory, and every
// stage is operation-bound. What the per-tap gather (bwd_filter_f32_kernel's
// first design) spent beyond the products (x^ formed again for each of the
// three taps and each 64-channel N tile, ge folded again for each 64-row K
// tile: 7 to 54 times an element; (t, h, w) decoded per position and chunk;
// a synchronous gather through registers; one LDS.128 of A and one of B per
// 16 FFMA) is what this design takes out. It is temporal_fwd_f32_kernel's
// frame walk with the products turned round: dw stays in registers, and the
// positions are the sum.
//
// - Frame walk. A unit is a strip of S = 32 consecutive positions of the
//   flattened B*H*W axis (across clips where H*W is small), walked over t =
//   0..T-1; a slice's units follow one another in one stream of steps, step
//   j being frame j % T of unit j / T. A block owns every tap of CB input
//   channels x an N tile of 64 output channels: [3 * CB, 64] of dw, 96 sums
//   a thread in registers across the whole walk.
// - x^ once. Frame j's x rows for the block's channels arrive by cp.async
//   into a ring of TFF_XS frames ([S][CB] each: frames j-1, j, j+1 and the
//   one arriving); the thread that copied a vector forms x^ in place, once,
//   after its own wait_group (two roundings: __fmul_rn / __fadd_rn; never
//   past the strip or C_in). Step j's ge [S][64] then feeds all three taps:
//   x^ frame t-1 (tap 0), t (tap 1) and t+1 (tap 2); a tap whose frame lies
//   outside the clip is skipped, which is x^'s zero padding after the
//   prologue. So x^ is read from memory and formed once per N tile (at
//   stage 1 once in all), ge once per channel block.
// - ge folded once, in place in each channel block as row 7f does (gy
//   double buffered, y single: only its copier reads it, before the barrier
//   that frees it; each op rounded, never past the strip or C_out). A
//   fold_f32_kernel pass into a scratch [M, Co] before the walk was 10%
//   slower at stage 1 and within 1% at stages 3-4 (PERF.md, PR 25).
// - All threads copy and form: after its own wait_group a thread forms its
//   vectors of frame j+1 and folds its vectors of ge j, one barrier a step
//   publishes them and frees the buffers of step j-1, the copies of x^ j+2
//   and ge j+1 are issued, and the products of step j hide them. A
//   producer warp (row 6f's shape) and a unit-major walk with x^ in
//   registers both measured slower (PERF.md).
// - FFMA microkernel (fp32 CUDA cores: the reference is fp32, so no TF32
//   and no tensor cores): CB/4 channel groups x 8 output-channel groups,
//   each thread 3 taps x 4 input channels (cg * 4) x 8 output channels (4 at
//   ng * 4, 4 at 32 + ng * 4) over every position of each step. A position
//   costs it 3 LDS.128 of x^ and 2 of ge for 96 FFMA (one per ~19, against
//   one per 8 in the gather). A warp is 4 channel groups x 8 output-channel
//   groups of one position, so its A loads are 4 distinct vectors and its B
//   loads 8 (one wavefront each). CB = 48 (3 warps, four blocks a SM; 48
//   divides every flops-mode width) or 64 (4 warps, three a SM): 48 or 56
//   KB of shared memory a block and 12 warps a SM (ptxas capped at 168
//   registers), so that one block's barrier, copies and forming hide behind
//   the others' products (8 warps a SM ran 7-17% slower, PERF.md). A warp
//   whose 16 channels all lie past C_in (the tail of the last channel
//   block) skips its copies and products.
// - Epilogue: the sums through shared memory (each quad of output channels
//   stored pair-swapped: see there), stored along the output channels into
//   the slice's partial [3 * Ci, Co] (or dw itself with one slice);
//   slice_sum_f32_kernel sums the partials in slice order. No atomics: two
//   calls give the same bits.
// - Grid: slices of units x channel blocks x N tiles, the channel block
//   fastest (the blocks reading the same ge run together);
//   f32_temporal_filter_plan (ops/conv_bn.py) picks CB and sizes the slices.

constexpr int TFF_NB = 64;            // output channels a block
constexpr int TFF_XS = 4;             // x^ frames in the ring
// Measurement knob, for filter_sweep.py only (dw is then wrong): 1 leaves
// out forming x^ and folding ge, 2 the products, 4 the copies of x, gy and y
// (the buffers keep what they held), 8 the epilogue (the dw stores); 15
// leaves the walk alone; 64 stores the sums in output-channel order (b and
// the sum then share a register bank in every FFMA, see the epilogue).
#ifndef TFF_ABLATE
#define TFF_ABLATE 0
#endif

struct TemporalFilterF32Args {
  const float* x;      // [B, T, H*W, Ci]
  const float* gy;     // [B, T, H*W, Co]
  const float* y;      // [B, T, H*W, Co]
  const float* gs1;    // [Co]
  const float* gs2;
  const float* inv;    // [Ci] or null
  const float* shift;
  float* out;          // [slices][3 * Ci][Co] partials, or dw (one slice)
  int positions;       // B * H*W: the axis the strips cut
  int T, HW, Ci, Co;
  int units, units_per_slice, ci_blocks, n_tiles;
  FastDiv by_hw;
};

// A block's shared memory: the x^ ring [TFF_XS][S][CB], two gy / ge
// buffers [S][64] and a y buffer [S][64]; the block's sums reuse it at the
// end. ops/conv_bn.py (_temporal_filter_f32_smem) computes the same.
size_t tff_smem(int CB, int S) {
  return sizeof(float) * ((size_t)TFF_XS * S * CB + (size_t)3 * S * TFF_NB);
}

// One position group: each thread walks every position of a step, from a
// first position p0 that the kernel computes at run time (warp / (CG / 4),
// always 0 with TFF_PG 1). ptxas schedules the products 5-6% faster with
// the loop's start a run-time value than with a constant start (PERF.md,
// PR 25 run 15): keep p0 a run-time value.
constexpr int TFF_PG = 1;

// acc[d][k][c] += x^ of tap d (frame t - 1 + d) at position p, channel k,
// times ge at p, this thread's output channel c, over positions p0, p0 +
// TFF_PG, ... < n (n <= S); xm / x0 / xp and gs at this thread's first
// channel. The next position's vectors are loaded before this one's
// products. T0 / T2: taps 0 / 2 inside the clip.
template <int CB, int S, bool T0, bool T2>
__device__ __forceinline__ void tff_products(const float* xm, const float* x0,
                                             const float* xp, const float* gs,
                                             int p0, int n,
                                             float (&acc)[3][4][8]) {
  constexpr int NB = TFF_NB, step = TFF_PG;
  if (p0 >= n) return;
  float4 av[3], b0, b1;
  auto load = [&](int p, float4 (&a)[3], float4& c0, float4& c1) {
    a[0] = T0 ? ld4(xm + p * CB) : zero4();
    a[1] = ld4(x0 + p * CB);
    a[2] = T2 ? ld4(xp + p * CB) : zero4();
    c0 = ld4(gs + p * NB);
    c1 = ld4(gs + p * NB + NB / 2);
  };
  load(p0, av, b0, b1);
#pragma unroll 2
  for (int p = p0; p < n; p += step) {
    float4 an[3], bn0, bn1;
    load(min(p + step, S - 1), an, bn0, bn1);   // a row of the buffers
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      if ((d == 0 && !T0) || (d == 2 && !T2)) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float ak = lane4(av[d], k);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[d][k][c] = fmaf(ak, b[c], acc[d][k][c]);
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) av[d] = an[d];
    b0 = bn0;
    b1 = bn1;
  }
}

// CG channel groups x 8 output-channel groups (CB = 4 * CG input channels,
// 64 output channels a block; CG / 4 warps) over strips of S positions,
// each thread 3 taps x 4 input channels x 8 output channels; BPS blocks a
// SM.
template <int CG, int S, int BPS>
__global__ void __launch_bounds__(8 * CG, BPS)
temporal_filter_f32_kernel(const TemporalFilterF32Args a) {
  constexpr int CB = 4 * CG, NB = TFF_NB, XS = TFF_XS;
  constexpr int NTH = 8 * CG;                  // threads: CG / 4 warps
  constexpr int QX = CB / 4, QG = NB / 4;      // 16-byte vectors of a position's x / ge row
  constexpr int XV = (S * QX + NTH - 1) / NTH; // x vectors a thread copies a frame, at most
  constexpr int GV = (S * QG + NTH - 1) / NTH; // ge (gy, y) vectors
  static_assert(TFF_PG == 1 && CG % 4 == 0 && NTH % 32 == 0 && NTH <= 128 && NTH % QX == 0 &&
                    NTH % QG == 0 && 3 * CB * NB <= XS * S * CB + 3 * S * NB,
                "one position group, warp layout, 4 warps, fixed channels a thread, block sums");
  const int T = a.T, HW = a.HW, Ci = a.Ci, Co = a.Co;
  const bool affine = a.inv != nullptr;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Xr = reinterpret_cast<float*>(smem_raw);   // [XS][S][CB]: the x^ ring
  float* Gb = Xr + XS * S * CB;                     // [2][S][NB]: gy, then ge
  float* Yb = Gb + 2 * S * NB;                      // [S][NB]: y

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ng = lane & 7;                      // channels ng*4, NB/2 + ng*4
  const int cg = (warp % (CG / 4)) * 4 + (lane >> 3);   // input channels cg*4
  const int pg = warp / (CG / 4);               // first position (0): TFF_PG
  const int tiles = a.ci_blocks * a.n_tiles;
  const int tile = (int)blockIdx.x % tiles, slice = (int)blockIdx.x / tiles;
  const int c0 = (tile % a.ci_blocks) * CB, n0 = (tile / a.ci_blocks) * NB;
  // a warp's 16 input channels all past Ci (the last channel block's): no
  // products, its sums stay 0 and are never stored
  const bool busy = c0 + (warp % (CG / 4)) * 16 < Ci;
  const int u0 = slice * a.units_per_slice;
  const int u1 = min(a.units, u0 + a.units_per_slice);
  const int nsteps = u1 > u0 ? (u1 - u0) * T : 0;
  // this thread's copy vectors: the same channels in every row
  const int xq = (tid % QX) * 4, gq = (tid % QG) * 4;
  const bool x_in = c0 + xq < Ci, g_in = n0 + gq < Co;
  float4 iv = zero4(), sv = zero4(), g1 = zero4(), g2 = zero4();
  if (affine && x_in) {
    iv = ld4(a.inv + c0 + xq);
    sv = ld4(a.shift + c0 + xq);
  }
  if (g_in) {
    g1 = ld4(a.gs1 + n0 + gq);
    g2 = ld4(a.gs2 + n0 + gq);
  }

  // The row of strip position r of unit u at frame f (-1 past the
  // positions): b*T*HW + f*HW + p for position gp = b*HW + p.
  auto row_of = [&](int u, int r, int f) -> int64_t {
    const int gp = u * S + r;
    if (gp >= a.positions) return -1;
    const int b = fdiv(gp, a.by_hw);
    return (int64_t)gp + (int64_t)b * (T - 1) * HW + (int64_t)f * HW;
  };
  // x frame s of the walk (unit u0 + s / T, frame s % T) into ring slot s % XS
  // (vectors past Ci not at all: only sums never stored read them)
  auto copy_x = [&](int s) {
    if ((TFF_ABLATE & 4) || !x_in) return;
    const int u = u0 + s / T, f = s - (s / T) * T;
    float* xd = Xr + (s % XS) * S * CB;
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int v = tid + j * NTH;
      if (S * QX % NTH != 0 && v >= S * QX) break;
      const int64_t row = row_of(u, v / QX, f);
      cp_async16(xd + v * 4, row >= 0 ? a.x + row * Ci + c0 + xq : a.x,
                 row >= 0);
    }
  };
  // x^ = relu(f32(f32(x * inv) + shift)) in place, on this thread's vectors
  // of frame s (never those past the strip or past Ci)
  auto form_x = [&](int s) {
    if (!affine || (TFF_ABLATE & 1) || !x_in) return;
    const int u = u0 + s / T;
    float* xd = Xr + (s % XS) * S * CB;
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int v = tid + j * NTH;
      if (S * QX % NTH != 0 && v >= S * QX) break;
      if (u * S + v / QX >= a.positions) continue;
      float4* p = reinterpret_cast<float4*>(xd + v * 4);
      *p = prologue4(*p, iv, sv);
    }
  };
  // gy of step s into buffer s & 1, its y into the y buffer
  auto copy_g = [&](int s) {
    if (TFF_ABLATE & 4) return;
    const int u = u0 + s / T, f = s - (s / T) * T;
    float* gd = Gb + (s & 1) * S * NB;
#pragma unroll
    for (int j = 0; j < GV; ++j) {
      const int v = tid + j * NTH;
      if (S * QG % NTH != 0 && v >= S * QG) break;
      const int64_t row = row_of(u, v / QG, f);
      const bool ok = row >= 0 && g_in;
      const int64_t src = ok ? row * Co + n0 + gq : 0;
      cp_async16(gd + v * 4, a.gy + src, ok);
      if (ok) cp_async16(Yb + v * 4, a.y + src, true);
    }
  };
  // ge = gy + (gs1 + (2 y) gs2) in place, on this thread's vectors of step
  // s (never those past the strip or past Co)
  auto fold_g = [&](int s) {
    if ((TFF_ABLATE & 1) || !g_in) return;
    const int u = u0 + s / T;
    float* gd = Gb + (s & 1) * S * NB;
#pragma unroll
    for (int j = 0; j < GV; ++j) {
      const int v = tid + j * NTH;
      if (S * QG % NTH != 0 && v >= S * QG) break;
      if (u * S + v / QG >= a.positions) continue;
      float4* p = reinterpret_cast<float4*>(gd + v * 4);
      *p = fold4(*p, ld4(Yb + v * 4), g1, g2);
    }
  };

  float acc[3][4][8];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[d][k][c] = 0.f;

  // Step j: its wait covers x^ j+1 and ge j (issued a step ahead), one
  // barrier publishes them and frees the buffers of step j-1, then x^ j+2
  // and ge j+1 are issued and the products of step j hide them.
  if (nsteps > 0) {
    copy_x(0);
    if (nsteps > 1) copy_x(1);
    copy_g(0);
  }
  cp_async_commit();
  for (int j = 0; j < nsteps; ++j) {
    cp_async_wait_all();            // this thread's copies of step j landed
    if (j == 0) form_x(0);
    if (j + 1 < nsteps) form_x(j + 1);
    fold_g(j);
    __syncthreads();                // x^ j+1 and ge j formed; step j-1 multiplied
    if (j + 2 < nsteps) copy_x(j + 2);   // into the slot of x^ j-2
    if (j + 1 < nsteps) copy_g(j + 1);   // into the buffers of step j-1
    cp_async_commit();
    if ((TFF_ABLATE & 2) || !busy) continue;
    const int u = u0 + j / T, t = j - (j / T) * T;
    const int n = min(S, a.positions - u * S);   // the strip's positions
    const float* xm = Xr + ((j + XS - 1) % XS) * S * CB + cg * 4;
    const float* x0 = Xr + (j % XS) * S * CB + cg * 4;
    const float* xp = Xr + ((j + 1) % XS) * S * CB + cg * 4;
    const float* gs = Gb + (j & 1) * S * NB + ng * 4;
    const bool t0 = t > 0, t2 = t + 1 < T;
    if (t0 && t2)
      tff_products<CB, S, true, true>(xm, x0, xp, gs, pg, n, acc);
    else if (t0)
      tff_products<CB, S, true, false>(xm, x0, xp, gs, pg, n, acc);
    else if (t2)
      tff_products<CB, S, false, true>(xm, x0, xp, gs, pg, n, acc);
    else
      tff_products<CB, S, false, false>(xm, x0, xp, gs, pg, n, acc);
  }
  cp_async_wait_all();
  __syncthreads();                  // every product read: reuse the buffers

  if (TFF_ABLATE & 8) {
    if (T < 0)                      // never true: keeps the products alive
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int c = 0; c < 8; ++c) a.out[(d * 4 + k) * 8 + c] = acc[d][k][c];
    return;
  }
  // the block's [3 * CB, NB], each pair of output channels swapped (column
  // c at c ^ SW). ptxas lays a vector store's four sums out as an aligned
  // register quad and keeps them there through the walk; swapped, the sum of an even channel sits at an odd
  // register and the reverse, so no FFMA reads its b value (aligned as
  // loaded) and its sum from one register bank. (TFF_ABLATE & 64 stores
  // them in order: every FFMA then does.)
  constexpr int SW = (TFF_ABLATE & 64) ? 0 : 1;
  float* red = Xr;                  // [3 * CB][NB]
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* s = acc[d][k];
      float* r = red + (d * CB + cg * 4 + k) * NB + ng * 4;
      *reinterpret_cast<float4*>(r) =
          make_float4(s[0 ^ SW], s[1 ^ SW], s[2 ^ SW], s[3 ^ SW]);
      *reinterpret_cast<float4*>(r + NB / 2) =
          make_float4(s[4 ^ SW], s[5 ^ SW], s[6 ^ SW], s[7 ^ SW]);
    }
  __syncthreads();
  float* out = a.out + (int64_t)slice * 3 * Ci * Co;
  for (int e = tid; e < 3 * CB * NB; e += NTH) {
    const int row = e / NB, col = e - row * NB;
    const int d = row / CB, ci = c0 + row - d * CB, co = n0 + col;
    if (ci >= Ci || co >= Co) continue;
    out[((int64_t)d * Ci + ci) * Co + co] = red[e ^ SW];
  }
}

template <int CG, int S, int BPS>
int launch_temporal_filter_f32(const TemporalFilterF32Args& a, int blocks,
                               cudaStream_t stream) {
  const size_t smem = tff_smem(4 * CG, S);
  if (smem > (size_t)SWF_SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = temporal_filter_f32_kernel<CG, S, BPS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  kern<<<blocks, 8 * CG, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Spatial forward unit, fp32, the per-tap gather (the route of images too
// wide for the row walk). x [B, T, H, W, Ci], wk [9 * Ci, Co], inv / shift
// [Ci] or both null, y [B, T, H, W, Co], s1 / s2 [Co], part a scratch of
// 2 * ranges * Co floats, ranges = ceil(ceil(M / 64) / per); all fp32,
// contiguous, Ci and Co multiples of 8. Returns a cudaError_t.
extern "C" int m3f_conv_unit_fwd_f32(const void* x, const void* wk,
                                     const void* inv, const void* shift,
                                     void* y, void* s1, void* s2, void* part,
                                     int B, int T, int H, int W, int Ci,
                                     int Co, int per, void* stream) {
  const int64_t M = (int64_t)B * T * H * W;
  if (per < 1) return (int)cudaErrorInvalidValue;
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
  if (inv != nullptr)
    conv_f32_kernel<true><<<grid, THREADS, 0, s>>>(a);
  else
    conv_f32_kernel<false><<<grid, THREADS, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  colsum_f32_kernel<<<(Co + 31) / 32, dim3(32, 32), 0, s>>>(
      a.part1, a.part2, ranges, Co, (float*)s1, (float*)s2);
  return (int)cudaGetLastError();
}

// Temporal forward unit, fp32, the frame walk. x [B, T, H, W, Ci], wk
// [3 * Ci, Co] (row tap * Ci + ci), inv / shift [Ci] or both null, y
// [B, T, H, W, Co], s1 / s2 [Co], part a scratch of 2 * ranges * Co floats,
// ranges = ceil(ceil(B * H * W / 128) / per) (strips of 128 positions, N
// tiles of 64 output channels), resident 1 to keep the filter tile in
// shared memory; all fp32, contiguous, 16-byte aligned, Ci and Co
// multiples of 8. Returns a cudaError_t (cudaErrorInvalidValue where the
// resident filter does not fit).
extern "C" int m3f_temporal_fwd_f32(const void* x, const void* wk,
                                    const void* inv, const void* shift,
                                    void* y, void* s1, void* s2, void* part,
                                    int B, int T, int H, int W, int Ci, int Co,
                                    int resident, int per, void* stream) {
  const int64_t positions = (int64_t)B * H * W;
  if (per < 1 || Ci % 8 != 0 || Co % 8 != 0 || Ci == 0 || Co == 0 ||
      (inv == nullptr) != (shift == nullptr) ||
      (resident != 0 && resident != 1) || (int64_t)H * W >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (positions * T == 0) {
    cudaMemsetAsync(s1, 0, sizeof(float) * Co, s);
    cudaMemsetAsync(s2, 0, sizeof(float) * Co, s);
    return (int)cudaGetLastError();
  }
  const int strip = 4 * TWF_NPG, nb = 8 * TWF_NCG;
  const int64_t units = (positions + strip - 1) / strip;
  const int64_t ranges = (units + per - 1) / per;
  const int n_tiles = (Co + nb - 1) / nb;
  if (units >= ((int64_t)1 << 31) || ranges * n_tiles >= ((int64_t)1 << 31) ||
      units * T * ((Ci + TWF_KC - 1) / TWF_KC) >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  TemporalFwdF32Args a{};
  a.x = (const float*)x;
  a.w = (const float*)wk;
  a.inv = (const float*)inv;
  a.shift = (const float*)shift;
  a.y = (float*)y;
  a.part1 = (float*)part;
  a.part2 = (float*)part + ranges * Co;
  a.positions = positions;
  a.T = T;
  a.HW = H * W;
  a.Ci = Ci;
  a.Co = Co;
  a.units = (int)units;
  a.units_per_range = per;
  a.n_tiles = n_tiles;
  a.resident = resident;
  const int err = inv != nullptr
      ? launch_temporal_fwd_f32<true>(a, (int)ranges, s)
      : launch_temporal_fwd_f32<false>(a, (int)ranges, s);
  if (err != 0) return err;
  colsum_f32_kernel<<<(Co + 31) / 32, dim3(32, 32), 0, s>>>(
      a.part1, a.part2, (int)ranges, Co, (float*)s1, (float*)s2);
  return (int)cudaGetLastError();
}

// Spatial forward unit, fp32, the row walk. x [B, T, H, W, Ci], wk
// [9 * Ci, Co] (row tap * Ci + ci), inv / shift [Ci] or both null, y
// [B, T, H, W, Co], s1 / s2 [Co], part a scratch of 2 * ranges * Co floats,
// ranges = ceil(B * T / per); nb (144 or 128) output channels a block (a
// step of 112 or 128 pixels), kc (16 or 8) input channels a chunk; all fp32, contiguous, 16-byte aligned,
// Ci and Co multiples of 8. Returns a cudaError_t (cudaErrorInvalidValue
// where the layout's buffers do not fit).
extern "C" int m3f_spatial_fwd_f32(const void* x, const void* wk,
                                   const void* inv, const void* shift, void* y,
                                   void* s1, void* s2, void* part, int B, int T,
                                   int H, int W, int Ci, int Co, int nb, int kc,
                                   int per, void* stream) {
  const int64_t images = (int64_t)B * T;
  if (per < 1 || Ci % 8 != 0 || Co % 8 != 0 || Ci == 0 || Co == 0 ||
      (inv == nullptr) != (shift == nullptr) || (nb != 144 && nb != 128) ||
      (kc != 16 && kc != 8) || (int64_t)per * H * W >= ((int64_t)1 << 31) ||
      images >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (images * H * W == 0) {
    cudaMemsetAsync(s1, 0, sizeof(float) * Co, s);
    cudaMemsetAsync(s2, 0, sizeof(float) * Co, s);
    return (int)cudaGetLastError();
  }
  const int64_t ranges = (images + per - 1) / per;
  const int n_tiles = (Co + nb - 1) / nb;
  if (ranges * n_tiles >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  SpatialFwdF32Args a{};
  a.x = (const float*)x;
  a.w = (const float*)wk;
  a.inv = (const float*)inv;
  a.shift = (const float*)shift;
  a.y = (float*)y;
  a.part1 = (float*)part;
  a.part2 = (float*)part + ranges * Co;
  a.H = H;
  a.W = W;
  a.Ci = Ci;
  a.Co = Co;
  a.images = (int)images;
  a.images_per_range = per;
  a.n_tiles = n_tiles;
  const bool affine = inv != nullptr;
  int err;
  if (nb == 144)
    err = kc == 16 ? spatial_fwd_f32_either<18, 14, 16>(affine, a, (int)ranges, s)
                   : spatial_fwd_f32_either<18, 14, 8>(affine, a, (int)ranges, s);
  else
    err = kc == 16 ? spatial_fwd_f32_either<16, 16, 16>(affine, a, (int)ranges, s)
                   : spatial_fwd_f32_either<16, 16, 8>(affine, a, (int)ranges, s);
  if (err != 0) return err;
  colsum_f32_kernel<<<(Co + 31) / 32, dim3(32, 32), 0, s>>>(
      a.part1, a.part2, (int)ranges, Co, (float*)s1, (float*)s2);
  return (int)cudaGetLastError();
}

// Spatial data gradient, fp32, the per-tap gather (the route of images too
// wide for the row walk). gy / y [B, T, H, W, Co], gs1 / gs2 [Co], wt
// [9 * Co, Ci] (row tap * Co + co = W[8 - tap, ci, co]: the
// filter's taps mirrored, each transposed), x [B, T, H, W, Ci] and
// inv / shift [Ci] with the prologue (all three null without), dx
// [B, T, H, W, Ci], dinv / dshift [Ci] and part a scratch of 2 * ranges * Ci
// floats with the prologue (else null), ranges = ceil(ceil(M / 64) / per);
// all fp32, contiguous, 16-byte aligned, Ci and Co multiples of 8. Returns
// a cudaError_t.
extern "C" int m3f_conv_unit_bwd_data_f32(
    const void* gy, const void* y, const void* gs1, const void* gs2,
    const void* wt, const void* x, const void* inv, const void* shift,
    void* dx, void* dinv, void* dshift, void* part, int B, int T, int H,
    int W, int Ci, int Co, int per, void* stream) {
  const int64_t M = (int64_t)B * T * H * W;
  const bool affine = x != nullptr;
  if (per < 1 || Ci % 8 != 0 || Co % 8 != 0 ||
      Ci == 0 || Co == 0 || (inv == nullptr) == affine ||
      (shift == nullptr) == affine || (dinv == nullptr) == affine ||
      (dshift == nullptr) == affine || (part == nullptr) == affine)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (M == 0) {
    if (!affine) return 0;
    cudaMemsetAsync(dinv, 0, sizeof(float) * Ci, s);
    cudaMemsetAsync(dshift, 0, sizeof(float) * Ci, s);
    return (int)cudaGetLastError();
  }
  const int64_t m_tiles = (M + BM - 1) / BM;
  if (m_tiles >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const int ranges = (int)((m_tiles + per - 1) / per);
  if (ranges > 65535) return (int)cudaErrorInvalidValue;
  F32BwdDataArgs a{};
  a.gy = (const float*)gy;
  a.y = (const float*)y;
  a.gs1 = (const float*)gs1;
  a.gs2 = (const float*)gs2;
  a.wt = (const float*)wt;
  a.x = (const float*)x;
  a.inv = (const float*)inv;
  a.shift = (const float*)shift;
  a.dx = (float*)dx;
  a.part1 = (float*)part;
  a.part2 = affine ? (float*)part + (int64_t)ranges * Ci : nullptr;
  a.T = T;
  a.H = H;
  a.W = W;
  a.Ci = Ci;
  a.Co = Co;
  a.M = M;
  a.m_tiles = (int)m_tiles;
  a.tiles_per_range = per;
  const dim3 grid((Ci + BN - 1) / BN, ranges);
  if (affine)
    bwd_data_f32_kernel<true><<<grid, THREADS, 0, s>>>(a);
  else
    bwd_data_f32_kernel<false><<<grid, THREADS, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !affine) return (int)e;
  colsum_f32_kernel<<<(Ci + 31) / 32, dim3(32, 32), 0, s>>>(
      a.part1, a.part2, ranges, Ci, (float*)dinv, (float*)dshift);
  return (int)cudaGetLastError();
}

// Spatial filter gradient, fp32, the per-tap gather (the route of images
// too wide for the row walk). x [B, T, H, W, Ci], gy / y [B, T, H, W, Co],
// gs1 / gs2 [Co], inv / shift [Ci] or both null, dw [9 * Ci, Co] (row
// tap * Ci + ci), part a scratch of slices * 9 * Ci * Co floats when
// slices > 1 (else null); slice s takes the chunks of 16 positions
// [s * per, (s + 1) * per); all fp32, contiguous, 16-byte aligned, Ci and Co
// multiples of 8. Returns a cudaError_t.
extern "C" int m3f_conv_unit_bwd_filter_f32(
    const void* x, const void* gy, const void* y, const void* gs1,
    const void* gs2, const void* inv, const void* shift, void* dw, void* part,
    int B, int T, int H, int W, int Ci, int Co, int per, int slices,
    void* stream) {
  const int64_t M = (int64_t)B * T * H * W;
  const int64_t chunks = (M + KC - 1) / KC;
  const int64_t K = (int64_t)9 * Ci;
  if (per < 1 || slices < 1 || slices > 65535 ||
      Ci % 8 != 0 || Co % 8 != 0 || Ci == 0 || Co == 0 ||
      (inv == nullptr) != (shift == nullptr) || (part == nullptr) != (slices == 1) ||
      chunks >= ((int64_t)1 << 31) || (int64_t)per * slices < chunks ||
      (K + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  F32BwdFilterArgs a{};
  a.x = (const float*)x;
  a.gy = (const float*)gy;
  a.y = (const float*)y;
  a.gs1 = (const float*)gs1;
  a.gs2 = (const float*)gs2;
  a.inv = (const float*)inv;
  a.shift = (const float*)shift;
  a.out = slices > 1 ? (float*)part : (float*)dw;
  a.T = T;
  a.H = H;
  a.W = W;
  a.Ci = Ci;
  a.Co = Co;
  a.M = M;
  a.chunks = (int)chunks;
  a.chunks_per_slice = per;
  const dim3 grid((Co + BN - 1) / BN, (unsigned)((K + BM - 1) / BM), slices);
  if (inv != nullptr)
    bwd_filter_f32_kernel<true><<<grid, THREADS, 0, s>>>(a);
  else
    bwd_filter_f32_kernel<false><<<grid, THREADS, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || slices == 1) return (int)e;
  const int64_t E = K * Co;
  const int64_t blocks = (E + 255) / 256;
  slice_sum_f32_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      (const float*)part, slices, E, (float*)dw);
  return (int)cudaGetLastError();
}

// Spatial filter gradient, fp32, the row walk. x [B, T, H, W, Ci], gy / y
// [B, T, H, W, Co], gs1 / gs2 [Co], inv / shift [Ci] or both null, dw
// [9 * Ci, Co] (row tap * Ci + ci), part a scratch of slices * 9 * Ci * Co
// floats when slices > 1 (else null), ge a scratch of B * T * H * W * Co
// floats (ge folded once before the walk); slice s takes the images [s *
// per, (s + 1) * per) of the B * T, slices = ceil(B * T / per); nb (144 or
// 128) output channels a block, step (a multiple of 8) output pixels a
// step; all fp32, contiguous, 16-byte aligned, Ci and Co multiples of 8.
// Returns a cudaError_t (cudaErrorInvalidValue where the layout's buffers
// do not fit).
extern "C" int m3f_spatial_filter_f32(
    const void* x, const void* gy, const void* y, const void* gs1,
    const void* gs2, const void* inv, const void* shift, void* dw, void* part,
    void* ge, int B, int T, int H, int W, int Ci, int Co, int nb, int step,
    int per, int slices, void* stream) {
  const int64_t images = (int64_t)B * T;
  if (per < 1 || slices < 1 || Ci % 8 != 0 || Co % 8 != 0 || Ci == 0 ||
      Co == 0 || (inv == nullptr) != (shift == nullptr) ||
      (part == nullptr) != (slices == 1) || (nb != 144 && nb != 128) ||
      step < 8 || step % 8 != 0 || images >= ((int64_t)1 << 31) ||
      (int64_t)per * H * W >= ((int64_t)1 << 31) ||
      (images > 0 && (slices != (images + per - 1) / per)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t K = (int64_t)9 * Ci;
  if (images * H * W == 0) {
    cudaMemsetAsync(dw, 0, sizeof(float) * K * Co, s);
    return (int)cudaGetLastError();
  }
  if (ge == nullptr) return (int)cudaErrorInvalidValue;
  const int ci_blocks = (Ci + SFF_CB - 1) / SFF_CB;
  const int n_tiles = (Co + nb - 1) / nb;
  const int64_t blocks = (int64_t)slices * ci_blocks * n_tiles;
  if (blocks >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const int64_t n4 = images * H * W * Co / 4;
  const int64_t fblocks = (n4 + 255) / 256;
  fold_f32_kernel<<<(unsigned)(fblocks < 8192 ? fblocks : 8192), 256, 0, s>>>(
      (const float*)gy, (const float*)y, (const float*)gs1, (const float*)gs2,
      (float*)ge, images * H * W, Co);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  SpatialFilterF32Args a{};
  a.x = (const float*)x;
  a.ge = (const float*)ge;
  a.inv = (const float*)inv;
  a.shift = (const float*)shift;
  a.out = slices > 1 ? (float*)part : (float*)dw;
  a.H = H;
  a.W = W;
  a.Ci = Ci;
  a.Co = Co;
  a.images = (int)images;
  a.images_per_slice = per;
  a.ci_blocks = ci_blocks;
  a.n_tiles = n_tiles;
  a.S = step;
  a.XR = swf_rows(H, W, 2 * step);
  a.by_w = fast_div(W);
  a.by_h = fast_div(H);
  a.by_h1 = fast_div(H + 1);
  a.by_xr = fast_div(a.XR);
  a.by_4w = fast_div(4 * W);
  const bool affine = inv != nullptr;
  int err;
  if (nb == 144)
    err = affine ? launch_spatial_filter_f32<18, true>(a, (int)blocks, s)
                 : launch_spatial_filter_f32<18, false>(a, (int)blocks, s);
  else
    err = affine ? launch_spatial_filter_f32<16, true>(a, (int)blocks, s)
                 : launch_spatial_filter_f32<16, false>(a, (int)blocks, s);
  if (err != 0 || slices == 1) return err;
  const int64_t E = K * Co;
  const int64_t sblocks = (E + 255) / 256;
  slice_sum_f32_kernel<<<(unsigned)(sblocks < 4096 ? sblocks : 4096), 256, 0, s>>>(
      (const float*)part, slices, E, (float*)dw);
  return (int)cudaGetLastError();
}

// Spatial data gradient, fp32, the row walk. gy / y [B, T, H, W, Co],
// gs1 / gs2 [Co], wt [9 * Co, Ci] (row tap * Co + co = W[8 - tap, ci, co]:
// the filter's taps mirrored, each transposed), x [B, T, H, W, Ci] and
// inv / shift [Ci] with the prologue (all three null without), dx
// [B, T, H, W, Ci], dinv / dshift [Ci] and part a scratch of 2 * rows * Ci
// floats with the prologue (else null; rows = ranges with one split, else
// ceil(M / 64)), dxpart a scratch of splits * M * Ci floats when splits > 1
// (else null); ranges of per images of the B * T; nb (64 or 128) input
// channels a block (a step of 256 or 128 pixels), kc (16 or 8) output
// channels a chunk, the ceil(Co / kc) chunks cut into splits of
// ceil(chunks / splits), none empty; all fp32, contiguous, 16-byte aligned,
// Ci and Co multiples of 8. Returns a cudaError_t (cudaErrorInvalidValue
// where the layout's buffers do not fit).
extern "C" int m3f_spatial_data_f32(
    const void* gy, const void* y, const void* gs1, const void* gs2,
    const void* wt, const void* x, const void* inv, const void* shift,
    void* dx, void* dinv, void* dshift, void* part, void* dxpart, int B,
    int T, int H, int W, int Ci, int Co, int nb, int kc, int per, int splits,
    void* stream) {
  const int64_t images = (int64_t)B * T;
  const int64_t M = images * H * W;
  const bool affine = x != nullptr;
  const int chunks = (kc > 0) ? (Co + kc - 1) / kc : 0;
  const int cps = splits > 0 ? (chunks + splits - 1) / splits : 0;
  if (per < 1 || splits < 1 || Ci % 8 != 0 || Co % 8 != 0 || Ci == 0 ||
      Co == 0 || (nb != 64 && nb != 128) || (kc != 16 && kc != 8) ||
      (inv == nullptr) == affine || (shift == nullptr) == affine ||
      (dinv == nullptr) == affine || (dshift == nullptr) == affine ||
      (part == nullptr) == affine || (dxpart == nullptr) != (splits == 1) ||
      (splits - 1) * cps >= chunks || (int64_t)per * H * W >= ((int64_t)1 << 31) ||
      images >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (M == 0) {
    if (!affine) return 0;
    cudaMemsetAsync(dinv, 0, sizeof(float) * Ci, s);
    cudaMemsetAsync(dshift, 0, sizeof(float) * Ci, s);
    return (int)cudaGetLastError();
  }
  const int64_t ranges = (images + per - 1) / per;
  const int n_tiles = (Ci + nb - 1) / nb;
  const int64_t blocks = ranges * splits * n_tiles;
  const int64_t sum_rows = (M + SDF_SUM_ROWS - 1) / SDF_SUM_ROWS;
  if (blocks >= ((int64_t)1 << 31) || sum_rows >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const bool walk_affine = affine && splits == 1;   // the epilogue in the walk
  const int64_t rows = splits == 1 ? ranges : sum_rows;
  SpatialDataF32Args a{};
  a.gy = (const float*)gy;
  a.y = (const float*)y;
  a.gs1 = (const float*)gs1;
  a.gs2 = (const float*)gs2;
  a.wt = (const float*)wt;
  a.x = walk_affine ? (const float*)x : nullptr;
  a.inv = walk_affine ? (const float*)inv : nullptr;
  a.shift = walk_affine ? (const float*)shift : nullptr;
  a.dx = splits == 1 ? (float*)dx : (float*)dxpart;
  a.part1 = affine ? (float*)part : nullptr;
  a.part2 = affine ? (float*)part + rows * Ci : nullptr;
  a.M = M;
  a.H = H;
  a.W = W;
  a.Ci = Ci;
  a.Co = Co;
  a.images = (int)images;
  a.images_per_range = per;
  a.n_tiles = n_tiles;
  a.splits = splits;
  a.chunks_per_split = cps;
  int err;
  if (nb == 64)
    err = kc == 16 ? spatial_data_f32_either<8, 32, 16>(walk_affine, a, (int)blocks, s)
                   : spatial_data_f32_either<8, 32, 8>(walk_affine, a, (int)blocks, s);
  else
    err = kc == 16 ? spatial_data_f32_either<16, 16, 16>(walk_affine, a, (int)blocks, s)
                   : spatial_data_f32_either<16, 16, 8>(walk_affine, a, (int)blocks, s);
  if (err != 0) return err;
  if (splits > 1) {
    const dim3 grid((unsigned)sum_rows, (Ci + 255) / 256);
    if (affine)
      data_split_sum_f32_kernel<true><<<grid, 256, 0, s>>>(
          (const float*)dxpart, splits, M, Ci, (const float*)x,
          (const float*)inv, (const float*)shift, (float*)dx, a.part1, a.part2);
    else
      data_split_sum_f32_kernel<false><<<grid, 256, 0, s>>>(
          (const float*)dxpart, splits, M, Ci, nullptr, nullptr, nullptr,
          (float*)dx, nullptr, nullptr);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (!affine) return 0;
  colsum_f32_kernel<<<(Ci + 31) / 32, dim3(32, 32), 0, s>>>(
      a.part1, a.part2, (int)rows, Ci, (float*)dinv, (float*)dshift);
  return (int)cudaGetLastError();
}

// Temporal data gradient, fp32, the frame walk. gy / y [B, T, H, W, Co],
// gs1 / gs2 [Co], wt [3 * Co, Ci] (row tap * Co + co = W[2 - tap, ci, co]:
// the filter's taps mirrored, each transposed), x [B, T, H, W, Ci] and
// inv / shift [Ci] with the prologue (all three null without), dx
// [B, T, H, W, Ci], dinv / dshift [Ci] and part a scratch of 2 * ranges * Ci
// floats with the prologue (else null); nb (64 or 144) input channels a
// block, each with its strip (128 or 56 positions of the B * H * W), ranges = ceil(ceil(B * H * W / strip) / per), resident 1
// to keep the filter tile in shared memory; all fp32, contiguous, 16-byte
// aligned, Ci and Co multiples of 8. Returns a cudaError_t
// (cudaErrorInvalidValue where the resident filter does not fit).
extern "C" int m3f_temporal_data_f32(
    const void* gy, const void* y, const void* gs1, const void* gs2,
    const void* wt, const void* x, const void* inv, const void* shift,
    void* dx, void* dinv, void* dshift, void* part, int B, int T, int H,
    int W, int Ci, int Co, int nb, int resident, int per, void* stream) {
  const bool affine = x != nullptr;
  if (per < 1 || Ci % 8 != 0 || Co % 8 != 0 || Ci == 0 || Co == 0 ||
      (inv == nullptr) == affine || (shift == nullptr) == affine ||
      (dinv == nullptr) == affine || (dshift == nullptr) == affine ||
      (part == nullptr) == affine || (resident != 0 && resident != 1) ||
      (int64_t)H * W >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  TemporalDataF32Args a{};
  a.gy = (const float*)gy;
  a.y = (const float*)y;
  a.gs1 = (const float*)gs1;
  a.gs2 = (const float*)gs2;
  a.wt = (const float*)wt;
  a.x = (const float*)x;
  a.inv = (const float*)inv;
  a.shift = (const float*)shift;
  a.dx = (float*)dx;
  a.positions = (int64_t)B * H * W;
  a.T = T;
  a.HW = H * W;
  a.Ci = Ci;
  a.Co = Co;
  a.resident = resident;
  if (a.positions * T == 0) {
    if (!affine) return 0;
    cudaMemsetAsync(dinv, 0, sizeof(float) * Ci, s);
    cudaMemsetAsync(dshift, 0, sizeof(float) * Ci, s);
    return (int)cudaGetLastError();
  }
  float *di = (float*)dinv, *ds = (float*)dshift, *scratch = (float*)part;
  switch (nb) {                   // the layouts: tdf_run<NCG, NPG>
    case 64: return tdf_run<8, 32>(a, per, di, ds, scratch, s);
    case 144: return tdf_run<18, 14>(a, per, di, ds, scratch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Temporal filter gradient, fp32, the frame walk. x [B, T, H, W, Ci], gy / y
// [B, T, H, W, Co], gs1 / gs2 [Co], inv / shift [Ci] or both null, dw
// [3 * Ci, Co] (row tap * Ci + ci), part a scratch of slices * 3 * Ci * Co
// floats when slices > 1 (else null); a layout of cb input channels a block
// over strips of `strip` positions of the B * H * W (the instances below);
// slice s takes the strips [s * per, (s + 1) * per), slices = ceil(strips /
// per); all fp32, contiguous, 16-byte aligned, Ci and Co multiples of 8.
// Returns a cudaError_t.
extern "C" int m3f_temporal_filter_f32(
    const void* x, const void* gy, const void* y, const void* gs1,
    const void* gs2, const void* inv, const void* shift, void* dw, void* part,
    int B, int T, int H, int W, int Ci, int Co, int cb, int strip, int per,
    int slices, void* stream) {
  const int64_t positions = (int64_t)B * H * W;
  const int64_t units = strip > 0 ? (positions + strip - 1) / strip : 0;
  if (per < 1 || slices < 1 || strip < 1 || Ci % 8 != 0 || Co % 8 != 0 ||
      Ci == 0 || Co == 0 || (inv == nullptr) != (shift == nullptr) ||
      (part == nullptr) != (slices == 1) ||
      positions >= ((int64_t)1 << 31) || units * T >= ((int64_t)1 << 31) ||
      (units > 0 && slices != (units + per - 1) / per))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t K = (int64_t)3 * Ci;
  if (positions * T == 0) {
    cudaMemsetAsync(dw, 0, sizeof(float) * K * Co, s);
    return (int)cudaGetLastError();
  }
  const int ci_blocks = (Ci + cb - 1) / cb;
  const int n_tiles = (Co + TFF_NB - 1) / TFF_NB;
  const int64_t blocks = (int64_t)slices * ci_blocks * n_tiles;
  if (blocks >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  TemporalFilterF32Args a{};
  a.x = (const float*)x;
  a.gy = (const float*)gy;
  a.y = (const float*)y;
  a.gs1 = (const float*)gs1;
  a.gs2 = (const float*)gs2;
  a.inv = (const float*)inv;
  a.shift = (const float*)shift;
  a.out = slices > 1 ? (float*)part : (float*)dw;
  a.positions = (int)positions;
  a.T = T;
  a.HW = H * W;
  a.Ci = Ci;
  a.Co = Co;
  a.units = (int)units;
  a.units_per_slice = per;
  a.ci_blocks = ci_blocks;
  a.n_tiles = n_tiles;
  a.by_hw = fast_div(H * W);
  // the layouts: cb = 4 * CG input channels, strips of S positions, BPS
  // blocks a SM
  const int n = (int)blocks;
  int err;
  if (cb == 48 && strip == 32) err = launch_temporal_filter_f32<12, 32, 4>(a, n, s);
  else if (cb == 64 && strip == 32) err = launch_temporal_filter_f32<16, 32, 3>(a, n, s);
  else return (int)cudaErrorInvalidValue;
  if (err != 0 || slices == 1) return err;
  const int64_t E = K * Co;
  const int64_t sblocks = (E + 255) / 256;
  slice_sum_f32_kernel<<<(unsigned)(sblocks < 4096 ? sblocks : 4096), 256, 0, s>>>(
      (const float*)part, slices, E, (float*)dw);
  return (int)cudaGetLastError();
}
