// Fused conv + BatchNorm units of the R(2+1)D blocks: forward, and the
// backward's data and filter gradients.
//
// Replaces: m3f/pytorch_tpu/ops/pallas/conv_bn.py
//   forward   _spatial_fwd (kernel _spatial_fwd_kernel) and _temporal_fwd
//             (_temporal_fwd_kernel), the forward of conv_unit;
//   backward  _spatial_bwd: data (_spatial_bwd_data_kernel, pallas_call at
//             :537) and filter (_spatial_bwd_filter_kernel, :554);
//             _temporal_bwd: data (_temporal_bwd_data_kernel, :612) and
//             filter (_temporal_bwd_filter_kernel, :625).
//
// Forward unit:
//   prologue:  x^ = relu(bf16(bf16(x * inv) + shift))   (previous BN + ReLU,
//                                                       optional)
//   conv:      y  = bf16(x^ (*) W)   (1,3,3) or (3,1,1), stride 1, pad 1,
//                                    fp32 accumulation
//   epilogue:  s1 = sum y, s2 = sum y^2 per output channel, fp32, over the
//              ROUNDED y
// Backward, with the cotangents (gy, gs1, gs2) folded into
//   ge = bf16(gy + bf16(gs1 + 2 * f32(y) * gs2))
//   data:      dx^ = bf16(ge (*) flip(W)^T); with the prologue
//              dxa = (bf16(bf16(x * inv) + shift) > 0) ? dx^ : 0,
//              dx = bf16(dxa * bf16(inv)), dinv = sum x * dxa,
//              dshift = sum dxa (fp32, per input channel)
//   filter:    dW[tap*Ci + ci, co] = sum over pixels of
//              x^[p + off(tap), ci] * ge[p, co], fp32
//
// Bound on an H100: as implicit GEMMs over the M = B*T*H*W pixels, with K =
// 9*C (spatial) or 3*C (temporal) taps x channels, the forward and the data
// gradient are [M, K] x [K, N] products and the filter gradient is a
// [K, M] x [M, N] product. At the main path's stage-1 spatial unit (M = 1.6
// M pixels per train step, K = 576, N = 144) each is 0.27 TFLOP. The forward
// and the data gradient move ~0.7 GB there (x and y, or gy, y and dx: about
// 400 FLOP/byte), above the ~295 FLOP/byte at which the bf16 tensor cores
// (989 TFLOP/s) and not memory (3.35 TB/s) set the floor: operations. The
// filter gradients read x, gy and y: the spatial one does 236 FLOP per byte
// at stage 1, so memory sets its floor there and operations at stages 2-4
// (see spatial_filter_kernel); the temporal one has a third of the taps,
// 102 FLOP per byte at stage 1 (Ci 144 -> Co 64), memory (see
// temporal_filter_kernel).
//
// Design (simple, correct tensor-core kernels; wgmma / TMA come later):
// - The spatial forward is spatial_fwd_kernel, a row walk that forms each
//   x^ row once for all nine taps and every output channel of its tile; the
//   temporal forward is temporal_fwd_kernel, a frame walk that forms each
//   x^ tile once for all three taps and every output channel of its tile
//   (each described above its code).
// - Forward epilogues: y is rounded, staged in shared memory and stored in
//   16-byte vectors; the rounded values feed the per-channel sums. The TPU
//   grid is sequential and carries sums across steps; CUDA blocks run in
//   parallel, so each block reduces its sums over its whole walk in a fixed
//   order (warp shuffles, then shared memory) into one partial row, and
//   colsum_kernel sums the rows per channel in a fixed order. No atomics.
// - The backward has a kernel per gradient and kind, each described above
//   its code: the data gradients spatial_data_kernel (a row walk that forms
//   each ge row once for all nine taps) and temporal_data_kernel (a frame
//   walk that forms each ge tile once for all three taps), the filter
//   gradients spatial_filter_kernel (a row walk) and temporal_filter_kernel
//   (a frame walk).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// s[c] = sum over rows r of part[r, c], in a fixed order
__global__ void __launch_bounds__(1024)
colsum_kernel(const float* __restrict__ part1, const float* __restrict__ part2,
              int R, int C, float* __restrict__ s1, float* __restrict__ s2) {
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

// ---------------------------------------------------------------------------
// Filter gradient
// ---------------------------------------------------------------------------

// out[i] = sum over s of part[s, i], in a fixed order (n a multiple of 4)
__global__ void __launch_bounds__(256)
slice_sum_kernel(const float4* __restrict__ part, int S, int64_t n4,
                 float4* __restrict__ out) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    float4 a = part[i];
    for (int s = 1; s < S; ++s) {
      const float4 b = part[(int64_t)s * n4 + i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    out[i] = a;
  }
}

// ---------------------------------------------------------------------------
// Temporal filter gradient: the frame walk
// ---------------------------------------------------------------------------
//
// Replaces _temporal_bwd_filter_kernel (m3f/pytorch_tpu/ops/pallas/conv_bn.py,
// pallas_call at :625), which takes a strip of one clip over all T frames,
// builds the x^ im2col [T*p, 3*Ci] once and does one product with ge for all
// three taps.
//
// Bound on an H100: bytes. dW[dt, ci, co] = sum_{b,t,p} x^[b, t+dt-1, p, ci] *
// ge[b, t, p, co] does 2*3*Ci*Co FLOP per pixel on (Ci + 2*Co) * 2 bytes of
// input: at the train step's stage 1 (x [32,16,56,56,144] -> Co 64) 88.8
// GFLOP on 873 MB, 102 FLOP/byte, under the ~295 at which the bf16 tensor
// cores and not the memory set the floor. So the design moves each byte once
// and keeps the loads in flight; mma.sync is fast enough for the math.
//
// - Frame walk. A work unit is one clip b and one strip of TF_S positions of
//   the H*W plane, walked over t = 0..T-1. Shared memory holds a ring of x
//   frame tiles [TF_S, CB] (frames t-1, t, t+1, and TF_AHEAD more in flight)
//   and of gy / y frame tiles [TF_S, 64] (frame t and TF_AHEAD in flight).
//   Each x tile is turned into x^ in place once after it lands (the BN
//   prologue, two roundings), each gy tile into ge (from y, gs1, gs2, two
//   roundings); both then serve all three taps. Tap dt adds x^[t+dt-1]^T ge[t]
//   only where that frame lies in the clip: the padding along T is a skipped
//   tap, and the walk never mixes two clips (they lie back to back). A
//   block's units follow one another in one stream of frames, so the ring
//   stays full across unit boundaries.
// - Channel block. A block owns a [3*CB, 64] output tile (every tap of CB =
//   48 or 64 input channels; 2*CB/16 warps, each one m16 channel tile x 32
//   output channels for all three taps, 48 fp32 accumulators a thread). x is
//   read once per output-channel tile; gy and y once per channel block. The
//   channel block is fastest in the grid, so the blocks of one unit run
//   together and find gy and y in the 50 MB L2. The whole Ci as one block
//   (CB 144 at stage 1, 18 warps, one block per SM) reads gy and y once but
//   was slower on the card: one block per SM cannot overlap one block's
//   forming with another's products.
// - The ring is filled by cp.async (16-byte copies, zero-filled past the
//   strip, the channels or the output channels), two frames ahead; with two
//   blocks per SM that keeps about 90 KB a SM in flight. Each thread forms
//   x^ and ge on exactly the vectors it copied (always the same 8 channels,
//   whose inv / shift / gs1 / gs2 sit in its registers), on the bf16x2 unit,
//   so one __syncthreads per frame step publishes the formed tiles and frees
//   the slots of the step before.
// - Tensor cores: ldmatrix.trans + mma.sync m16n8k16 bf16 -> fp32, TF_S/16
//   k-steps per tap and frame step; the B (ge) fragments serve three taps.
// - Parallelism: grid (channel blocks x output-channel tiles, slices); a
//   slice is a contiguous range of units and writes one fp32 partial, summed
//   in a fixed order by slice_sum_kernel. No atomics: bit-identical dw.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py, train
// step shapes, 32 clips): 0.73 / 0.42 / 0.22 / 0.19 ms per launch at stages
// 1-4, 4.6 ms per train step, against 3.09 / 1.33 / 0.54 / 0.27 (16.6 per
// step) for the per-K-tile kernel it replaced and 2.6 per step for cuDNN's
// conv3d_weight on x^ and ge already formed. What holds it back
// (m3f_torch/scripts/filter_sweep.py --kind temporal): at stage 1 the ring
// streaming x, gy and y alone takes 0.49 ms, about 1.8 TB/s, where a device
// copy of x runs at 2.8 TB/s; forming and products do not hide under it
// (0.65 ms in all). PERF.md has the numbers.

constexpr int TF_S = 64;       // positions of H*W per strip
constexpr int TF_AHEAD = 2;    // frames in flight beyond the one being formed
constexpr int TF_XS = TF_AHEAD + 3;   // x ring: t-1, t, t+1, in flight
constexpr int TF_GS = TF_AHEAD + 1;   // gy / y ring: t, in flight
constexpr int TF_CO = 64;      // output channels per block
// Measurement knob, for filter_sweep.py only (dw is then wrong):
// 1 leaves out forming x^ and ge, 2 the products, 3 both.
#ifndef TF_ABLATE
#define TF_ABLATE 0
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// prologue() on the bf16x2 unit: each op rounds its exact result once to
// bf16, which is what the explicit fp32 op and rounding give for bf16
// operands (their product is exact in fp32, and so is any sum whose
// rounding could differ). The _rn forms keep the compiler from contracting
// the product and the sum into one fma, which would round once.
__device__ __forceinline__ uint4 prologue_x2(uint4 v, const bf162 (&inv)[4],
                                             const bf162 (&shift)[4]) {
  bf162* p = reinterpret_cast<bf162*>(&v);
  const bf162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    p[i] = __hmax2(__hadd2_rn(__hmul2_rn(p[i], inv[i]), shift[i]), zero);
  return v;
}

// gy_eff8() with gs1 / gs2 in registers and the outer bf16 sum on the bf16x2
// unit (one rounding of an exact bf16 + bf16 sum, as above)
__device__ __forceinline__ uint4 gy_eff8_x2(uint4 g, uint4 yv,
                                            const float (&g1)[8],
                                            const float (&g2)[8]) {
  bf162* pg = reinterpret_cast<bf162*>(&g);
  const bf162* py = reinterpret_cast<const bf162*>(&yv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 yf = __bfloat1622float2(py[i]);
    const float a0 = __fadd_rn(g1[2 * i], __fmul_rn(2.f * yf.x, g2[2 * i]));
    const float a1 = __fadd_rn(g1[2 * i + 1], __fmul_rn(2.f * yf.y, g2[2 * i + 1]));
    pg[i] = __hadd2_rn(pg[i], __floats2bfloat162_rn(a0, a1));
  }
  return g;
}

struct TemporalFilterArgs {
  const bf16* x;       // [B, T, H*W, Ci]
  const bf16* gy;      // [B, T, H*W, Co]
  const bf16* y;
  const float* inv;    // [Ci] or null
  const float* shift;
  const float* gs1;    // [Co]
  const float* gs2;
  float* out;          // [slices][3*Ci][Co] partials, or dW
  int T, HW, Ci, Co;
  int strips;          // ceil(HW / TF_S)
  int units;           // B * strips
  int units_per_slice;
  int ci_blocks;
};

template <int MT, bool AFFINE>
__global__ void __launch_bounds__(64 * MT, 2)
temporal_filter_kernel(const TemporalFilterArgs a) {
  constexpr int NTH = 64 * MT;                 // 2*MT warps
  constexpr int CB = 16 * MT;                  // input channels per block
  constexpr int LDX = CB + 8;                  // row strides (bf16): 16-byte
  constexpr int LDG = TF_CO + 8;               // multiples, ldmatrix conflict-free
  constexpr int XV = CB / 8, GV = TF_CO / 8;   // 16-byte vectors per row
  constexpr int X_IT = (TF_S * XV + NTH - 1) / NTH;
  constexpr int G_IT = (TF_S * GV + NTH - 1) / NTH;
  constexpr int XS = TF_XS, GS = TF_GS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);           // [XS][TF_S][LDX]
  bf16* Gs = Xs + XS * TF_S * LDX;                        // [GS][TF_S][LDG]
  bf16* Ys = Gs + GS * TF_S * LDG;                        // [GS][TF_S][LDG]

  const int T = a.T, HW = a.HW, Ci = a.Ci, Co = a.Co;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp % MT, warp_n = warp / MT;
  const int c0 = (blockIdx.x % a.ci_blocks) * CB;
  const int n0 = (blockIdx.x / a.ci_blocks) * TF_CO;

  // NTH is a multiple of XV and of GV, so each thread copies and forms the
  // same 8 channels of every x row (xv) and of every gy / y row (gv): their
  // inv / shift and gs1 / gs2 live in registers.
  const int xv = (tid % XV) * 8, gv = (tid % GV) * 8;
  bf162 inv2[4], shift2[4];
  float g1[8], g2[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + xv + 2 * i;
    const bool ok = AFFINE && c < Ci;
    inv2[i] = __floats2bfloat162_rn(ok ? a.inv[c] : 0.f, ok ? a.inv[c + 1] : 0.f);
    shift2[i] = __floats2bfloat162_rn(ok ? a.shift[c] : 0.f,
                                      ok ? a.shift[c + 1] : 0.f);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool ok = n0 + gv + i < Co;
    g1[i] = ok ? a.gs1[n0 + gv + i] : 0.f;
    g2[i] = ok ? a.gs2[n0 + gv + i] : 0.f;
  }

  const int u0 = blockIdx.y * a.units_per_slice;
  const int u1 = min(a.units, u0 + a.units_per_slice);
  const int nq = u1 > u0 ? (u1 - u0) * T : 0;    // frames of the walk

  // A cursor on the walk: frame q (frame t of unit u), its first pixel and
  // its rows inside the strip. Four cursors (copy x, copy gy / y, form x^,
  // form ge) step one frame at a time; only a step into the next unit divides.
  struct Cursor {
    int q, t, u, rows;
    int64_t base;
  };
  auto seek_unit = [&](Cursor& w) {
    const int b = w.u / a.strips, p0 = (w.u - b * a.strips) * TF_S;
    w.base = (int64_t)b * T * HW + p0;
    w.rows = min(TF_S, HW - p0);
  };
  auto step = [&](Cursor& w) {
    ++w.q;
    if (++w.t < T) {
      w.base += HW;
    } else {
      w.t = 0;
      ++w.u;
      seek_unit(w);
    }
  };
  Cursor wx{0, 0, u0, 0, 0};
  seek_unit(wx);
  Cursor wg = wx, fx = wx, fg = wx;

  auto copy_x = [&](const Cursor& w) {
    if (w.q >= nq) return;
    const int64_t base = w.base;
    const int rows = w.rows;
    bf16* dst = Xs + (w.q % XS) * TF_S * LDX;
#pragma unroll
    for (int i = 0; i < X_IT; ++i) {
      const int c = tid + i * NTH;
      if (c >= TF_S * XV) break;
      const int r = c / XV;
      const bool ok = r < rows && c0 + xv < Ci;
      cp_async16(dst + r * LDX + xv, ok ? a.x + (base + r) * Ci + c0 + xv : a.x,
                 ok);
    }
  };
  auto copy_g = [&](const Cursor& w) {
    if (w.q >= nq) return;
    const int64_t base = w.base;
    const int rows = w.rows;
    const int off = (w.q % GS) * TF_S * LDG;
#pragma unroll
    for (int i = 0; i < G_IT; ++i) {
      const int c = tid + i * NTH;
      if (c >= TF_S * GV) break;
      const int r = c / GV;
      const bool ok = r < rows && n0 + gv < Co;
      const int64_t src = ok ? (base + r) * Co + n0 + gv : 0;
      cp_async16(Gs + off + r * LDG + gv, a.gy + src, ok);
      cp_async16(Ys + off + r * LDG + gv, a.y + src, ok);
    }
  };
  // x^ = prologue(x) in place, on this thread's own vectors of frame q
  auto form_x = [&](const Cursor& w) {
    if (!AFFINE || w.q >= nq) return;
    const int rows = w.rows;
    bf16* xs = Xs + (w.q % XS) * TF_S * LDX;
#pragma unroll
    for (int i = 0; i < X_IT; ++i) {
      const int c = tid + i * NTH;
      if (c >= TF_S * XV) break;
      const int r = c / XV;
      if (r < rows && c0 + xv < Ci) {
        uint4* p = reinterpret_cast<uint4*>(xs + r * LDX + xv);
        *p = prologue_x2(*p, inv2, shift2);
      }
    }
  };
  // ge = gy + bf16(gs1 + 2*y*gs2) in place of gy, on this thread's vectors
  auto form_g = [&](const Cursor& w) {
    const int rows = w.rows;
    const int off = (w.q % GS) * TF_S * LDG;
#pragma unroll
    for (int i = 0; i < G_IT; ++i) {
      const int c = tid + i * NTH;
      if (c >= TF_S * GV) break;
      const int r = c / GV;
      if (r < rows && n0 + gv < Co) {
        uint4* p = reinterpret_cast<uint4*>(Gs + off + r * LDG + gv);
        *p = gy_eff8_x2(*p, *reinterpret_cast<const uint4*>(Ys + off + r * LDG + gv),
                        g1, g2);
      }
    }
  };

  float acc[3][4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  // ldmatrix.trans lanes: A (channels m, pixels k) from [pixel][channel];
  // B (pixels k, output channels n, two n8 tiles) from [pixel][n]
  const int sub = lane >> 3;
  const int a_krow = (lane & 7) + (sub >> 1) * 8, a_moff = (sub & 1) * 8;
  const int b_krow = (lane & 7) + (sub & 1) * 8, b_noff = (sub >> 1) * 8;
  const bool warp_live = c0 + warp_m * 16 < Ci;

  // the stream's first groups: {x0, x1, g0}, then {x(k+1), g(k)}
  copy_x(wx);
  step(wx);
  copy_x(wx);
  step(wx);
  copy_g(wg);
  step(wg);
  cp_async_commit();
#pragma unroll
  for (int k = 1; k < TF_AHEAD; ++k) {
    copy_x(wx);
    step(wx);
    copy_g(wg);
    step(wg);
    cp_async_commit();
  }
  for (int j = 0; j < nq; ++j) {
    cp_async_wait<TF_AHEAD - 1>();   // this thread's x(j+1) and g(j) landed
    if (j == 0) {
      if (!(TF_ABLATE & 1)) form_x(fx);
      step(fx);
    }
    if (!(TF_ABLATE & 1)) form_x(fx);    // x^(j+1)
    step(fx);
    const int t = fg.t;              // frame of step j inside its clip
    if (!(TF_ABLATE & 1)) form_g(fg);    // ge(j)
    step(fg);
    __syncthreads();                 // formed tiles visible; step j-1 done
    copy_x(wx);                      // x(j+AHEAD+1), into the slot of x(j-2)
    step(wx);
    copy_g(wg);                      // g(j+AHEAD), into the slot of g(j-1)
    step(wg);
    cp_async_commit();
    if (!(TF_ABLATE & 2) && warp_live) {
      const bf16* gs = Gs + (j % GS) * TF_S * LDG + warp_n * 32 + b_noff;
      const bf16* xt[3] = {Xs + ((j + XS - 1) % XS) * TF_S * LDX,
                           Xs + (j % XS) * TF_S * LDX,
                           Xs + ((j + 1) % XS) * TF_S * LDX};
      const bool tap_on[3] = {t > 0, true, t + 1 < T};
#pragma unroll
      for (int ks = 0; ks < TF_S / 16; ++ks) {
        uint32_t bfr[4][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t r4[4];
          ldsm_x4_t(r4, gs + (ks * 16 + b_krow) * LDG + h * 16);
          bfr[2 * h][0] = r4[0];
          bfr[2 * h][1] = r4[1];
          bfr[2 * h + 1][0] = r4[2];
          bfr[2 * h + 1][1] = r4[3];
        }
#pragma unroll
        for (int tap = 0; tap < 3; ++tap) {
          if (!tap_on[tap]) continue;
          uint32_t af[4];
          ldsm_x4_t(af, xt[tap] + (ks * 16 + a_krow) * LDX + warp_m * 16 + a_moff);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[tap][nt], af, bfr[nt]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* out = a.out + (int64_t)blockIdx.y * 3 * Ci * Co;
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int tap = 0; tap < 3; ++tap)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = c0 + warp_m * 16 + g + half * 8;
      if (ci >= Ci) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + warp_n * 32 + nt * 8 + tg * 2;
        if (n >= Co) continue;
        *reinterpret_cast<float2*>(out + ((int64_t)tap * Ci + ci) * Co + n) =
            make_float2(acc[tap][nt][half * 2], acc[tap][nt][half * 2 + 1]);
      }
    }
}

template <int MT, bool AFFINE>
int launch_temporal_filter(const TemporalFilterArgs& args, int slices,
                           cudaStream_t stream) {
  constexpr int CB = 16 * MT;
  const size_t smem =
      ((size_t)TF_XS * TF_S * (CB + 8) + 2 * (size_t)TF_GS * TF_S * (TF_CO + 8)) *
      sizeof(bf16);
  auto kern = temporal_filter_kernel<MT, AFFINE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int co_tiles = (args.Co + TF_CO - 1) / TF_CO;
  kern<<<dim3(args.ci_blocks * co_tiles, slices), 64 * MT, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <int MT>
int dispatch_temporal_filter(int affine, const TemporalFilterArgs& a,
                             int slices, cudaStream_t s) {
  return affine ? launch_temporal_filter<MT, true>(a, slices, s)
                : launch_temporal_filter<MT, false>(a, slices, s);
}

// ---------------------------------------------------------------------------
// Spatial filter gradient: the row walk
// ---------------------------------------------------------------------------
//
// Replaces _spatial_bwd_filter_kernel (m3f/pytorch_tpu/ops/pallas/conv_bn.py,
// pallas_call at :554), which takes one whole (b, t) image per sequential
// grid step, pads it in VMEM, builds a strip's x^ im2col [sh*W, 9*Ci] and
// does one product per strip, carrying dW across grid steps.
//
// dW[(dh*3+dw)*Ci + ci, co] = sum_{b,t,h,w} x^[b,t,h+dh-1,w+dw-1,ci] *
// ge[b,t,h,w,co] does 2*9*Ci*Co FLOP per pixel on (Ci + 2*Co) * 2 bytes of
// input. Bound on an H100 at the train step's shapes (32 clips): stage 1 (x
// [32,16,56,56,64] -> Co 144) 0.266 TFLOP on 1.13 GB, 236 FLOP/byte: bytes,
// 0.337 ms; stages 2-4 (Ci 128 / 256 / 512) 471 / 930 / 1740 FLOP/byte:
// operations, 0.135 / 0.067 / 0.034 ms. The whole [9*Ci, Co] fp32 result
// (332 KB at stage 1) fits no block, blocks run in parallel, and an im2col
// is written nowhere. So the design stages each byte once per block for all
// nine taps, and keeps the repeats between blocks in the L2.
//
// - Row walk. A slice's images lie back to back in memory; the kernel walks
//   them as one dense stream of output pixels in steps of S (a multiple of
//   16: k-steps may span image rows and images, only a slice's last step is
//   partly masked) and one stream of x rows. Shared memory holds a ring of
//   XR x rows [W+2, CB] and a ring of gy / y tiles [S, CO_T]. The x stream
//   has one all-zero row before every image and after the last, so a tap row
//   above or below the image is that zero row (shared by two neighbouring
//   images), never the neighbour's row; columns 0 and W+1 of every ring row
//   are zero from the start and never written: the conv's padding, zero
//   AFTER the prologue. Each x row is copied once, turned into x^ in place
//   once (the BN prologue, two roundings; image rows, columns 1..W only) and
//   serves all three dh and all three dw; each gy tile is turned into ge in
//   place once (from y, gs1, gs2, two roundings) and serves all nine taps.
// - A tap is an address offset. With x^ pixel-major in shared memory, each
//   lane of ldmatrix.trans gives its own pixel's row address: a table per
//   step (written by the threads that start the copies) holds, per output
//   pixel and dh, the ring offset of x^[h+dh-1][w-1]; dw adds one pixel.
// - Channel block. A block owns a [9*CB, CO_T] output tile as its transpose:
//   ge is the A operand (output channels are m), x^ the B operand (input
//   channels are n). Each of the NW warps takes 8 input channels and all
//   MT m16 tiles of the CO_T output channels for all nine taps (36*MT fp32
//   accumulators a thread: 108 at CO_T 48). The ge fragments are loaded once
//   per k-step and serve nine taps; a tap's x^ fragment serves MT products.
//   Per k-step a warp loads 7.5 ldmatrix.x4 worth of shared memory for 27
//   products; with x^ as the A operand of m16 x n24 warp tiles (the first
//   trial) it was 10.5. x is read once per output-channel tile, gy and y
//   once per channel block; the tiles of one slice are neighbours in the
//   grid, run together and find the repeats in the 50 MB L2 (at stage 1
//   with 64 x 48: 3 x 128 + 3 x 192 = 960 B a pixel from the L2 for the 704
//   B that come from memory).
// - One block of 8 warps a SM. The accumulators and fragments need ~220
//   registers a thread; compiled for two blocks a SM (128 registers) the
//   kernel spills and was 1.6-2.7x slower in trials. So the overlap has to
//   come from inside the block: the rings are filled by cp.async (16-byte
//   copies, zero-filled for the zero rows and past the slice; padded
//   channels are never written) three steps ahead, and step j is multiplied
//   in the same barrier phase in which step j+1 is formed (no barrier
//   between a warp's products and its forming). Each thread forms x^ and ge
//   on exactly the vectors it copied, on the bf16x2 unit (_rn forms: no
//   fused multiply-add), with its channels' inv / shift / gs1 / gs2 read
//   from shared memory when it forms, so one __syncthreads per step
//   publishes the formed tiles and frees the slots of the step before.
//   Every position of the walk (copy, form, table) is a cursor that moves
//   on by additions: the divisions are made once, before the loop.
// - Tensor cores: ldmatrix.trans + mma.sync m16n8k16 bf16 -> fp32.
// - Parallelism: grid (channel blocks x output-channel tiles, slices); a
//   slice is a contiguous range of whole images and writes one fp32
//   partial, summed in a fixed order by slice_sum_kernel. No atomics:
//   bit-identical dw.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (m3f_torch/scripts/
// filter_sweep.py --kind spatial, train step shapes, 32 clips): 1.46 / 0.79
// / 0.47 / 0.34 ms per launch at stages 1-4, 175 / 164 / 136 / 93 TFLOP/s;
// per train step (chip_smoke.py) 8.3 ms against 36.8 for the per-K-tile
// kernel it replaced and 11.8 for cuDNN's conv3d_weight on x^ and ge
// already formed. What holds it back, from the sweep's ablation builds at
// stage 1: the products alone take 0.87 ms (mma.sync at ~300 TFLOP/s, the
// same with 8 or 16 warps), the forming alone 0.69, the copies alone 0.57,
// the walk alone (cursors, tables, barriers, partials) 0.34, and they add
// up more than they overlap. PERF.md has the numbers and the trials.

constexpr int SF_AHEAD = 3;            // steps copied beyond the one multiplied
constexpr int SF_GS = SF_AHEAD + 1;    // gy / y / table ring
constexpr int SF_SMEM_MAX = 232448;    // 227 KB, a block's most on sm_90
// Measurement knob, for filter_sweep.py only (dw is then wrong): 1 leaves
// out forming x^ and ge, 2 the products, 4 the copies (the rings stay zero);
// their sums leave out several.
#ifndef SF_ABLATE
#define SF_ABLATE 0
#endif

struct SpatialFilterArgs {
  const bf16* x;       // [images, H, W, Ci]
  const bf16* gy;      // [images, H, W, Co]
  const bf16* y;
  const float* inv;    // [Ci] or null
  const float* shift;
  const float* gs1;    // [Co]
  const float* gs2;
  float* out;          // [slices][9*Ci][Co] partials, or dW
  int H, W, Ci, Co;
  int images;          // B * T
  int images_per_slice;
  int ci_blocks;
  int S;               // output pixels per step, a multiple of 16
  int XR;              // rows of the x ring (spatial_ring_rows)
};

// Rows a ring must hold: the rows under `steps` steps of S pixels at the
// worst alignment (dr more real rows, di zero rows between images) plus the
// halo row above and below. ops/conv_bn.py computes the same.
int spatial_ring_rows(int H, int W, int S, int steps) {
  const int span = steps * S;
  const int dr = (span + W - 2) / W;
  const int di = (dr + H - 1) / H;
  return dr + di + 3;
}

// The row walk of the spatial kernels (spatial_filter_kernel,
// spatial_data_kernel). A slice's images lie back to back; the walk takes
// them as one stream of output pixels, S a step, and one stream of rows with
// an all-zero row before every image and after the last, kept in a ring of
// XR rows of W + 2 pixels (columns 0 and W + 1 are the zero padding). Every
// position moves on by additions: the divisions are made once, before the
// walk.
struct RowWalk {
  int H, W, XR;
  int x_aw, x_av;      // a copy pass's pixels on: columns, rows
  int s_aw, s_av;      // a step's S pixels on
  int S, Q;            // pixels a step, output pixels of the slice
  int last_row;        // the zero row after the slice's last image
};

__device__ __forceinline__ RowWalk row_walk(int H, int W, int XR, int XP,
                                            int S, int images) {
  return RowWalk{H, W, XR, XP % W, XP / W, S % W, S / W, S, images * H * W,
                 images * (H + 1)};
}

// A position in the stream of rows, which a thread takes XP pixels at a
// time: column w of row vr (ring slot vr % XR); hrow is 0 on the zero row
// before an image and 1..H on the image's rows; rr counts the image rows
// above.
struct XCursor {
  int w, vr, slot, hrow, rr;
};

__device__ __forceinline__ XCursor x_seek(const RowWalk& g, int pix) {
  XCursor c;
  c.vr = pix / g.W;
  c.w = pix - c.vr * g.W;
  c.slot = c.vr % g.XR;
  c.hrow = c.vr % (g.H + 1);
  c.rr = c.vr - (c.vr + g.H) / (g.H + 1);
  return c;
}

__device__ __forceinline__ void x_advance(const RowWalk& g, XCursor& c) {
  c.w += g.x_aw;
  int dv = g.x_av;
  if (c.w >= g.W) {
    c.w -= g.W;
    ++dv;
  }
  for (; dv > 0; --dv) {
    if (c.hrow) ++c.rr;
    c.hrow = c.hrow == g.H ? 0 : c.hrow + 1;
    c.slot = c.slot + 1 == g.XR ? 0 : c.slot + 1;
    ++c.vr;
  }
}

// An output pixel of the slice, taken S pixels at a time: column w, row h
// of its image, stream row vr (one zero row before every image), ring slot.
struct PCursor {
  int w, h, vr, slot;
};

__device__ __forceinline__ PCursor p_seek(const RowWalk& g, int q) {
  PCursor c;
  const int rho = q / g.W, img = rho / g.H;
  c.w = q - rho * g.W;
  c.h = rho - img * g.H;
  c.vr = rho + img + 1;
  c.slot = c.vr % g.XR;
  return c;
}

__device__ __forceinline__ void p_advance(const RowWalk& g, PCursor& c) {
  c.w += g.s_aw;
  int dr = g.s_av;
  if (c.w >= g.W) {
    c.w -= g.W;
    ++dr;
  }
  for (; dr > 0; --dr) {
    int d = 1;
    if (++c.h == g.H) {     // over the zero row into the next image
      c.h = 0;
      d = 2;
    }
    c.vr += d;
    c.slot += d;
    if (c.slot >= g.XR) c.slot -= g.XR;
  }
}

// The last stream row step j needs: the row below its last pixel. `e` is on
// step j's last pixel (p_seek(g, S - 1) for step 0); steps come in order.
__device__ __forceinline__ int row_need(const RowWalk& g, int j, PCursor& e) {
  if ((j + 1) * g.S >= g.Q) return g.last_row;
  const int upto = e.vr + 1;
  p_advance(g, e);
  return upto;
}

// A step's tap table: for the output pixel of `tp` (the step's pixel t, of
// S), the ring offset in pixels of row h + dh - 1 at column w, dh = 0..2,
// i.e. of the padded pixel (h + dh - 1, w - 1): tap dw adds dw. Pixels past
// the slice (`live` false) get offset 0. Then tp moves on one step.
__device__ __forceinline__ void tap_table(const RowWalk& g, int* t, bool live,
                                          PCursor& tp) {
  const int WP = g.W + 2;
  if (live) {
    const int up = tp.slot == 0 ? g.XR - 1 : tp.slot - 1;
    const int down = tp.slot + 1 == g.XR ? 0 : tp.slot + 1;
    t[0] = up * WP + tp.w;
    t[g.S] = tp.slot * WP + tp.w;
    t[2 * g.S] = down * WP + tp.w;
  } else {
    t[0] = t[g.S] = t[2 * g.S] = 0;
  }
  p_advance(g, tp);
}

template <int NW, int MT>
size_t spatial_filter_smem(int W, int S, int XR) {
  constexpr int CB = 8 * NW, CO_T = 16 * MT;
  return ((size_t)XR * (W + 2) * (CB + 8) + 2 * (size_t)SF_GS * S * (CO_T + 8)) *
             sizeof(bf16) +
         (size_t)SF_GS * 3 * S * sizeof(int) + 2 * CO_T * sizeof(float) +
         2 * CB * sizeof(bf16);
}

template <int NW, int MT, bool AFFINE, int MINB>
__global__ void __launch_bounds__(32 * NW, MINB)
spatial_filter_kernel(const SpatialFilterArgs a) {
  constexpr int NTH = 32 * NW;
  constexpr int CB = 8 * NW;                   // input channels per block
  constexpr int CO_T = 16 * MT;                // output channels per block
  constexpr int LDX = CB + 8;                  // row strides (bf16): odd multiples
  constexpr int LDG = CO_T + 8;                // of 16 B, ldmatrix conflict-free
  constexpr int XV = CB / 8, GV = CO_T / 8;    // 16-byte vectors per pixel
  constexpr int XP = NTH / XV, GP = NTH / GV;  // pixels per pass of the block
  const int H = a.H, W = a.W, Ci = a.Ci, Co = a.Co, S = a.S, XR = a.XR;
  const int HW = H * W, WP = W + 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);           // [XR][WP][LDX]
  bf16* Gs = Xs + (size_t)XR * WP * LDX;                  // [GS][S][LDG]
  bf16* Ys = Gs + SF_GS * S * LDG;                        // [GS][S][LDG]
  int* Tab = reinterpret_cast<int*>(Ys + SF_GS * S * LDG);  // [GS][3][S]
  float* sG1 = reinterpret_cast<float*>(Tab + SF_GS * 3 * S);  // [CO_T]
  float* sG2 = sG1 + CO_T;
  bf16* sInv = reinterpret_cast<bf16*>(sG2 + CO_T);       // [CB]
  bf16* sShift = sInv + CB;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = (blockIdx.x % a.ci_blocks) * CB;
  const int n0 = (blockIdx.x / a.ci_blocks) * CO_T;
  const int i0 = blockIdx.y * a.images_per_slice;
  const int i1 = min(a.images, i0 + a.images_per_slice);
  const int Q = i1 > i0 ? (i1 - i0) * HW : 0;     // output pixels of the slice
  const int nq = (Q + S - 1) / S;                 // steps of the walk
  const int64_t P0 = (int64_t)i0 * HW;            // the slice's first pixel

  // Everything zero once: the padding columns and padded channels stay so.
  {
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    const int n16 = (int)((reinterpret_cast<unsigned char*>(Tab) - smem_raw) / 16);
    for (int i = tid; i < n16; i += NTH) z[i] = make_uint4(0, 0, 0, 0);
  }
  for (int c = tid; c < CO_T; c += NTH) {
    const bool ok = n0 + c < Co;
    sG1[c] = ok ? a.gs1[n0 + c] : 0.f;
    sG2[c] = ok ? a.gs2[n0 + c] : 0.f;
  }
  for (int c = tid; c < CB; c += NTH) {
    const bool ok = AFFINE && c0 + c < Ci;
    sInv[c] = __float2bfloat16(ok ? a.inv[c0 + c] : 0.f);
    sShift[c] = __float2bfloat16(ok ? a.shift[c0 + c] : 0.f);
  }
  __syncthreads();

  // The first XP*XV (GP*GV) threads copy and form x (gy / y): each always the
  // same 8 channels, pixel xpix (gpix) of every pass.
  const int xpix = tid / XV, xv = (tid % XV) * 8;
  const int gpix = tid / GV, gv = (tid % GV) * 8;
  const bool x_on = tid < XP * XV && c0 + xv < Ci;
  const bool g_on = tid < GP * GV && n0 + gv < Co;

  // Cursors (see RowWalk): the next x vector to copy and to form, this
  // thread's pixel of the table, the last pixel of the step copied / formed.
  const RowWalk rw = row_walk(H, W, XR, XP, S, i1 > i0 ? i1 - i0 : 0);
  XCursor cx = x_seek(rw, xpix), fx = cx;
  PCursor tp = p_seek(rw, min(tid, S - 1));
  PCursor ce = p_seek(rw, S - 1), fe = ce;

  // group j of the copies: the x rows step j adds, its gy / y tile, its table
  auto copy_step = [&](int j) {
    if (j >= nq) return;
    const int upto = row_need(rw, j, ce);
    if (x_on) {
      while (cx.vr <= upto) {
        const bool real = cx.hrow != 0;
        const bf16* src = real
            ? a.x + (P0 + (int64_t)cx.rr * W + cx.w) * Ci + c0 + xv : a.x;
        if (!(SF_ABLATE & 4))
          cp_async16(Xs + ((size_t)cx.slot * WP + 1 + cx.w) * LDX + xv, src, real);
        x_advance(rw, cx);
      }
    }
    const int q0 = j * S, slot = j % SF_GS;
    if (g_on) {
      const int off = slot * S * LDG + gv;
      for (int p = gpix; p < S; p += GP) {
        const bool ok = q0 + p < Q;
        const int64_t src = ok ? (P0 + q0 + p) * Co + n0 + gv : 0;
        if (SF_ABLATE & 4) continue;
        cp_async16(Gs + off + p * LDG, a.gy + src, ok);
        cp_async16(Ys + off + p * LDG, a.y + src, ok);
      }
    }
    // ring offset (in pixels) of x^[h+dh-1][w-1] for each output pixel
    // (ge is zero past the slice: any finite x^ there)
    if (tid < S) tap_table(rw, Tab + slot * 3 * S + tid, q0 + tid < Q, tp);
  };
  // x^ = prologue(x) in place on the image rows step j added, ge in place of
  // gy: on this thread's own vectors
  auto form_step = [&](int j) {
    if (AFFINE && x_on) {
      const int upto = row_need(rw, j, fe);
      bf162 inv2[4], shift2[4];
      *reinterpret_cast<uint4*>(inv2) = *reinterpret_cast<const uint4*>(sInv + xv);
      *reinterpret_cast<uint4*>(shift2) = *reinterpret_cast<const uint4*>(sShift + xv);
      while (fx.vr <= upto) {
        if (fx.hrow) {
          uint4* p = reinterpret_cast<uint4*>(
              Xs + ((size_t)fx.slot * WP + 1 + fx.w) * LDX + xv);
          *p = prologue_x2(*p, inv2, shift2);
        }
        x_advance(rw, fx);
      }
    }
    if (g_on) {
      float g1[8], g2[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        g1[i] = sG1[gv + i];
        g2[i] = sG2[gv + i];
      }
      const int off = (j % SF_GS) * S * LDG + gv;
      const int npx = min(S, Q - j * S);
      for (int p = gpix; p < npx; p += GP) {
        uint4* g = reinterpret_cast<uint4*>(Gs + off + p * LDG);
        *g = gy_eff8_x2(*g, *reinterpret_cast<const uint4*>(Ys + off + p * LDG),
                        g1, g2);
      }
    }
  };

  float acc[9][MT][4];
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  // The product is dW^T: A = ge (output channels m, pixels k) from
  // [pixel][co], all MT m16 tiles in every warp; B = x^ (pixels k, this
  // warp's 8 input channels n) from [pixel][ci], one n8 tile per tap. Both
  // by ldmatrix.trans; a B x4 takes two taps (lanes 16-31 one pixel on).
  const int sub = lane >> 3;
  const int a_krow = (lane & 7) + (sub >> 1) * 8, a_moff = (sub & 1) * 8;
  const int b_krow = lane & 15, b_tap = lane >> 4;
  const bool warp_live = c0 + warp * 8 < Ci;

  // The products of step j. A k-step loads all its fragments first (the
  // asm statements keep their order), then does its 27 products back to
  // back, under which the scheduler's other warp loads its own.
  auto multiply_step = [&](int j) {
    if ((SF_ABLATE & 2) || !warp_live) return;
    const int slot = j % SF_GS;
    const int* tab = Tab + slot * 3 * S + b_krow;
    const bf16* gs = Gs + slot * S * LDG + a_krow * LDG + a_moff;
    const bf16* xs = Xs + warp * 8 + b_tap * LDX;
    const int nks = (min(S, Q - j * S) + 15) / 16;
    for (int ks = 0; ks < nks; ++ks) {
      uint32_t afr[MT][4], b01[3][4], b2[3][2];
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        const bf16* xp = xs + (size_t)tab[dh * S + ks * 16] * LDX;
        ldsm_x4_t(b01[dh], xp);                  // dw 0 ([0..1]), dw 1 ([2..3])
        ldsm_x2_t(b2[dh], xp + (2 - b_tap) * LDX);   // dw 2, from every lane
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4_t(afr[mt], gs + ks * 16 * LDG + mt * 16);
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        const uint32_t b0[2] = {b01[dh][0], b01[dh][1]};
        const uint32_t b1[2] = {b01[dh][2], b01[dh][3]};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[dh * 3][mt], afr[mt], b0);
          mma_bf16(acc[dh * 3 + 1][mt], afr[mt], b1);
          mma_bf16(acc[dh * 3 + 2][mt], afr[mt], b2[dh]);
        }
      }
    }
  };

  // Step j is multiplied in the barrier phase in which step j+1 is formed
  // and steps j+2 .. j+AHEAD land: a warp that is done multiplying forms
  // beside the products of the others.
#pragma unroll
  for (int k = 0; k < SF_AHEAD; ++k) {
    copy_step(k);
    cp_async_commit();
  }
  cp_async_wait<SF_AHEAD - 1>();     // this thread's copies of step 0 landed
  if (!(SF_ABLATE & 1)) form_step(0);
  for (int j = 0; j < nq; ++j) {
    cp_async_wait<SF_AHEAD - 2>();   // ... of step j+1 landed
    __syncthreads();                 // step j's formed tiles visible; j-1 done
    copy_step(j + SF_AHEAD);         // into the slots steps < j have left
    cp_async_commit();
    multiply_step(j);
    if (!(SF_ABLATE & 1) && j + 1 < nq) form_step(j + 1);
  }
  cp_async_wait<0>();

  // acc[tap][mt] holds dW^T: rows co = mt*16 + g (+8), columns this warp's
  // ci = 2*tg (+1)
  float* out = a.out + (int64_t)blockIdx.y * 9 * Ci * Co;
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ci = c0 + warp * 8 + tg * 2 + e;
      if (ci >= Ci) continue;
      float* row = out + ((int64_t)tap * Ci + ci) * Co + n0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = mt * 16 + g + half * 8;
          if (n0 + n < Co) row[n] = acc[tap][mt][half * 2 + e];
        }
    }
}

template <int NW, int MT, bool AFFINE, int MINB>
int launch_spatial_filter(const SpatialFilterArgs& args, int slices,
                          cudaStream_t stream) {
  const size_t smem = spatial_filter_smem<NW, MT>(args.W, args.S, args.XR);
  if (smem > (size_t)SF_SMEM_MAX || args.S > 32 * NW)
    return (int)cudaErrorInvalidValue;
  auto kern = spatial_filter_kernel<NW, MT, AFFINE, MINB>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int co_tiles = (args.Co + 16 * MT - 1) / (16 * MT);
  kern<<<dim3(args.ci_blocks * co_tiles, slices), 32 * NW, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <int NW, int MT, int MINB>
int spatial_filter_either(int affine, const SpatialFilterArgs& a, int slices,
                          cudaStream_t s) {
  return affine ? launch_spatial_filter<NW, MT, true, MINB>(a, slices, s)
                : launch_spatial_filter<NW, MT, false, MINB>(a, slices, s);
}

// (channel block, output-channel tile) -> NW warps of 8 input channels x MT
// m16 output-channel tiles, and the resident blocks per SM compiled for
int dispatch_spatial_filter(int ci_blk, int co_tile, int affine,
                            const SpatialFilterArgs& a, int slices,
                            cudaStream_t s) {
  if (ci_blk == 64 && co_tile == 48)
    return spatial_filter_either<8, 3, 1>(affine, a, slices, s);
  if (ci_blk == 32 && co_tile == 48)
    return spatial_filter_either<4, 3, 2>(affine, a, slices, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Spatial data gradient: the row walk
// ---------------------------------------------------------------------------
//
// Replaces _spatial_bwd_data_kernel (m3f/pytorch_tpu/ops/pallas/conv_bn.py,
// pallas_call at :537), which pads one (b, t) image's ge once per sequential
// grid step, keeps the flipped filter in VMEM and does one product per strip
// of rows, then the ReLU mask, the scale by inv and the dinv / dshift sums
// carried across the grid.
//
// dx^[b,t,h,w,ci] = bf16(sum_{dh,dw} sum_co ge[b,t,h+1-dh,w+1-dw,co] *
// W[dh,dw,ci,co]) does 2*9*Co*Ci FLOP per pixel on (2*Co + 2*Ci) * 2 bytes
// (gy, y, x in, dx out). Bound on an H100 at the train step's shapes (32
// clips): stage 1 (gy [32,16,56,56,144] -> dx 64) 266 GFLOP on 1.34 GB with
// the prologue, 199 FLOP/byte: bytes, 0.40 ms, with the operations (0.27 ms)
// close behind; stages 2-4 (Ci 128 / 256 / 512) operations, 0.135 / 0.067 /
// 0.034 ms. So the products must run near the mma.sync rate with the copies
// hidden under them, ge must not be formed per tap, and the filter (up to
// 10.6 MB at stage 4) must not be re-read from the L2 for every few pixels.
//
// - Row walk (RowWalk, shared with spatial_filter_kernel). A block walks a
//   range of whole (b, t) images as one dense stream of output pixels in
//   steps of S (256 where it fits; a step may span rows and images). A step
//   reads the stream rows from the one above its first pixel to the one
//   below its last, with one all-zero row before every image and after the
//   last: a tap row above or below the image is that zero row, never the
//   neighbour's row; columns 0 and W+1 are zero from the start and never
//   written (the conv's padding).
// - K runs outermost inside a step, in chunks of SD_KC = 16 output channels
//   for all nine taps: per chunk the block copies the step's rows of gy and
//   y for those channels (cp.async, zero-filled on the zero rows and past
//   C_out), forms ge in place once (each thread the vectors it copied,
//   after its own wait_group), and multiplies them by the filter chunk
//   [NB, 9 taps x 16] for all nine taps. The chunk buffers are double-
//   buffered (y single: it is read only while forming), so chunk c+1
//   lands while chunk c is multiplied, one barrier a chunk. The [S, NB]
//   accumulators stay in registers for the whole step (64 a thread at S =
//   256, NB = 64), so the filter is read from the L2 once per 256 pixels;
//   ge is formed once per step's row and N tile (halo rows twice).
// - A tap is an address offset. Each lane of ldmatrix reads its own output
//   pixel's row from a per-step table (tap_table, shared with the filter
//   kernel): the offset of (h + dh - 1, w - 1) in the chunk buffer; tap dw
//   adds dw pixels. The table is read once a step.
// - Tensor cores: ldmatrix + mma.sync m16n8k16 bf16 -> fp32; 8 warps in WM x
//   WN, each MT m16 pixel tiles x NT n8 channel tiles (64 x 32 at S = 256:
//   six ldmatrix.x4 per 16 products); a tap's fragments are loaded while
//   the tap before is multiplied.
// - Epilogue, as temporal_data_kernel's: the x tile [S, NB] lands by
//   cp.async under the step's products; the accumulator is rounded to dx^,
//   masked by a bitwise select from the recomputed prologue (_rn forms: no
//   fused multiply-add), scaled by inv and staged over the x tile; dx leaves
//   at the next step in 16-byte stores along the channels, each thread
//   storing the vectors it copied before it copies the next x tile into
//   them. dinv / dshift: per-thread fp32 sums over the walk, then warp
//   shuffles and shared memory in a fixed order into one partial row per
//   block, then colsum_kernel. No atomics: two calls give the same bits.
// - Parallelism: grid = image ranges x N tiles of 64 input channels (the N
//   tile fastest: the blocks of one range run together and find gy and y
//   in the L2), about one block a SM.

constexpr int SD_THREADS = 256;
constexpr int SD_KC = 16;                 // output channels of a chunk
constexpr int SD_LDC = SD_KC + 8;         // a chunk buffer's pixel stride (48 B)
constexpr int SD_LDF = 9 * SD_KC + 8;     // a filter chunk's row stride (304 B)
constexpr int SD_VMAX = 8;                // gy vectors a thread copies a chunk
// Measurement knob, for filter_sweep.py only (dx is then wrong): 1 leaves
// out forming ge, 2 the products, 4 the copies of gy, y and x (the buffers
// keep what they held), 8 the epilogue (mask, scale, sums, dx stores); 15
// leaves the filter stream and the walk alone.
#ifndef SD_ABLATE
#define SD_ABLATE 0
#endif

struct SpatialDataArgs {
  const bf16* gy;      // [images, H, W, Co]
  const bf16* y;
  const float* gs1;    // [Co]
  const float* gs2;
  const bf16* w;       // the flipped filter [Ci, 9*Co]: w[ci, tap*Co + co] =
                       // W[2 - tap/3, 2 - tap%3, ci, co]
  const bf16* x;       // [images, H, W, Ci] or null
  const float* inv;    // [Ci] or null
  const float* shift;
  bf16* dx;            // [images, H, W, Ci]
  float* part1;        // [ranges][Ci] partial dinv, dshift
  float* part2;
  int H, W, Ci, Co;
  int Cop;             // Co rounded up to the chunk
  int images;          // B * T
  int images_per_range;
  int n_tiles;         // ceil(Ci / NB)
  int XR;              // rows of a chunk buffer (spatial_ring_rows, one step)
};

// A block's shared memory; ops/conv_bn.py (_spatial_data_smem) computes the
// same: two ge and one y chunk buffer, two filter chunks, the x / dx tile,
// two tap tables, gs1 / gs2, inv / shift.
size_t spatial_data_smem(int W, int Cop, int S, int NB, int XR) {
  const size_t buf = (size_t)XR * (W + 2) * SD_LDC;
  return 2 * (3 * buf + 2 * (size_t)NB * SD_LDF + (size_t)S * (NB + 8)) +
         24 * (size_t)S + 8 * (size_t)Cop + 4 * (size_t)NB;
}

// WM x WN warps, each MT m16 pixel tiles x NT n8 channel tiles: S =
// 16*MT*WM pixels a step, NB = 8*NT*WN input channels a block.
template <int WM, int WN, int MT, int NT, bool AFFINE>
__global__ void __launch_bounds__(SD_THREADS, 1)
spatial_data_kernel(const SpatialDataArgs a) {
  constexpr int NTH = SD_THREADS;
  static_assert(32 * WM * WN == NTH, "8 warps");
  constexpr int S = 16 * MT * WM;
  constexpr int NB = 8 * NT * WN;
  constexpr int LDX = NB + 8;                  // x tile row stride (bf16)
  constexpr int XV = NB / 8;                   // 16-byte vectors per x row
  constexpr int X_IT = (S * XV + NTH - 1) / NTH;
  constexpr int FV = NB * 9 * SD_KC / 8;       // 16-byte vectors of a filter chunk
  constexpr int F_IT = (FV + NTH - 1) / NTH;
  constexpr int XP = NTH / 2;                  // pixels per copy pass (2 vectors each)
  const int H = a.H, W = a.W, Ci = a.Ci, Co = a.Co, Cop = a.Cop, XR = a.XR;
  const int HW = H * W, WP = W + 2, BUF = XR * WP * SD_LDC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Gs = reinterpret_cast<bf16*>(smem_raw);            // [2][XR][WP][SD_LDC]
  bf16* Ys = Gs + 2 * BUF;                                 // [XR][WP][SD_LDC]
  bf16* Fs = Ys + BUF;                                     // [2][NB][SD_LDF]
  bf16* Xs = Fs + 2 * NB * SD_LDF;                         // [S][LDX]
  int* Tab = reinterpret_cast<int*>(Xs + S * LDX);         // [2][3][S]
  float* sG1 = reinterpret_cast<float*>(Tab + 6 * S);      // [Cop]
  float* sG2 = sG1 + Cop;
  bf162* sInv = reinterpret_cast<bf162*>(sG2 + Cop);       // [NB / 2]
  bf162* sShift = sInv + NB / 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int n0 = ((int)blockIdx.x % a.n_tiles) * NB;
  const int range = (int)blockIdx.x / a.n_tiles;
  const int i0 = range * a.images_per_range;
  const int nimg = max(0, min(a.images, i0 + a.images_per_range) - i0);
  const int Q = nimg * HW;                        // output pixels of the range
  const int nq = (Q + S - 1) / S;                 // steps of the walk
  const int nck = Cop / SD_KC;                    // chunks a step
  const int64_t P0 = (int64_t)i0 * HW;            // the range's first pixel

  // The chunk buffers zero once: the padding columns stay so.
  {
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    const int n16 = 3 * BUF / 8;
    for (int i = tid; i < n16; i += NTH) z[i] = make_uint4(0, 0, 0, 0);
  }
  for (int c = tid; c < Cop; c += NTH) {
    sG1[c] = c < Co ? a.gs1[c] : 0.f;
    sG2[c] = c < Co ? a.gs2[c] : 0.f;
  }
  for (int c = tid; c < NB / 2; c += NTH) {
    const int n = n0 + 2 * c;
    const bool ok = AFFINE && n < Ci;
    sInv[c] = __floats2bfloat162_rn(ok ? a.inv[n] : 0.f, ok ? a.inv[n + 1] : 0.f);
    sShift[c] = __floats2bfloat162_rn(ok ? a.shift[n] : 0.f,
                                      ok ? a.shift[n + 1] : 0.f);
  }
  __syncthreads();

  // Cursors (see RowWalk): this thread's pixel of the table, the first and
  // the last pixel of the next step to copy.
  const RowWalk rw = row_walk(H, W, XR, XP, S, nimg);
  PCursor tp = p_seek(rw, min(tid, S - 1));
  PCursor cf = p_seek(rw, 0), ce = p_seek(rw, S - 1);

  // This thread's gy vectors of a step: channels gv..gv+7 of each chunk at
  // buffer offset v_off of the pixel v_pix of the range (-1: a zero row,
  // -2: none). The same for every chunk of the step; a thread copies and
  // forms exactly these.
  const int gv = (tid & 1) * 8;
  int v_off[SD_VMAX], v_pix[SD_VMAX];
  auto seek_step = [&](int j) {                  // steps in order
    const int upto = row_need(rw, j, ce);
    const int rs = cf.vr - 1;                    // the row above the first pixel
    p_advance(rw, cf);
    XCursor c = x_seek(rw, rs * W + (tid >> 1));
#pragma unroll
    for (int k = 0; k < SD_VMAX; ++k) {
      const bool live = c.vr <= upto;
      v_off[k] = (c.slot * WP + 1 + c.w) * SD_LDC + gv;
      v_pix[k] = !live ? -2 : c.hrow ? c.rr * W + c.w : -1;
      if (live) x_advance(rw, c);
    }
  };
  // chunk ck of the current step into buffer b: the step's gy and y rows
  // for channels ck*16 .. +15, and the filter chunk
  auto copy_chunk = [&](int ck, int b) {
    const int ch = ck * SD_KC + gv;
    if (!(SD_ABLATE & 4)) {
      bf16* gd = Gs + b * BUF;
#pragma unroll
      for (int k = 0; k < SD_VMAX; ++k) {
        if (v_pix[k] < -1) continue;
        const bool real = v_pix[k] >= 0 && ch < Co;
        const int64_t src = real ? (P0 + v_pix[k]) * Co + ch : 0;
        cp_async16(gd + v_off[k], a.gy + src, real);
        if (real) cp_async16(Ys + v_off[k], a.y + src, true);
      }
    }
    bf16* fd = Fs + b * NB * SD_LDF;
#pragma unroll
    for (int i = 0; i < F_IT; ++i) {
      const int idx = tid + i * NTH;
      if (idx >= FV) break;
      const int n = idx / 18, r = idx - n * 18, tap = r >> 1, kk = (r & 1) * 8;
      const bool ok = n0 + n < Ci && ck * SD_KC + kk < Co;
      cp_async16(fd + n * SD_LDF + tap * SD_KC + kk,
                 ok ? a.w + ((int64_t)(n0 + n) * 9 + tap) * Co + ck * SD_KC + kk
                    : a.w, ok);
    }
  };
  // ge = gy + bf16(gs1 + 2*y*gs2) in place, on this thread's vectors
  auto form_chunk = [&](int ck, int b) {
    const int ch = ck * SD_KC + gv;
    if ((SD_ABLATE & 1) || ch >= Co) return;
    float g1[8], g2[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float4*>(g1 + 4 * h) =
          *reinterpret_cast<const float4*>(sG1 + ch + 4 * h);
      *reinterpret_cast<float4*>(g2 + 4 * h) =
          *reinterpret_cast<const float4*>(sG2 + ch + 4 * h);
    }
    bf16* gd = Gs + b * BUF;
#pragma unroll
    for (int k = 0; k < SD_VMAX; ++k) {
      if (v_pix[k] < 0) continue;
      uint4* p = reinterpret_cast<uint4*>(gd + v_off[k]);
      *p = gy_eff8_x2(*p, *reinterpret_cast<const uint4*>(Ys + v_off[k]), g1, g2);
    }
  };

  // A thread's vectors of the x / dx tile: c = tid + i*NTH -> pixel c / XV,
  // channels (c % XV) * 8
  auto copy_x = [&](int j) {
    if (!AFFINE || (SD_ABLATE & 4)) return;
    const int npx = min(S, Q - j * S);
    const bf16* src = a.x + (P0 + (int64_t)j * S) * Ci + n0;
#pragma unroll
    for (int i = 0; i < X_IT; ++i) {
      const int c = tid + i * NTH, r = c / XV, v = (c - r * XV) * 8;
      if (c >= S * XV) break;
      const bool ok = r < npx && n0 + v < Ci;
      cp_async16(Xs + r * LDX + v, ok ? src + r * Ci + v : a.x, ok);
    }
  };
  auto store_dx = [&](int j) {
    if (SD_ABLATE & 8) return;
    const int npx = min(S, Q - j * S);
    bf16* dst = a.dx + (P0 + (int64_t)j * S) * Ci + n0;
#pragma unroll
    for (int i = 0; i < X_IT; ++i) {
      const int c = tid + i * NTH, r = c / XV, v = (c - r * XV) * 8;
      if (c >= S * XV) break;
      if (r < npx && n0 + v < Ci)
        *reinterpret_cast<uint4*>(dst + r * Ci + v) =
            *reinterpret_cast<const uint4*>(Xs + r * LDX + v);
    }
  };

  float acc[MT][NT][4];
  float st1[NT][2], st2[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    st1[nt][0] = st1[nt][1] = st2[nt][0] = st2[nt][1] = 0.f;

  // ldmatrix lanes: A (pixels m, channels k) from the chunk buffer at the
  // lane's pixel's tap row; B (k, input channels n; two n8 tiles a x4) from
  // the filter chunk [n][tap*16 + k]
  const int a_koff = (lane >> 4) * 8;
  const int a_pix = wm * MT * 16 + (lane & 15);
  const int b_row = wn * NT * 8 + (lane & 7) + ((lane >> 4) & 1) * 8;
  const int b_koff = ((lane >> 3) & 1) * 8;
  const int b_row_last = wn * NT * 8 + (NT - 1) * 8 + (lane & 7);
  int a_off[MT][3];                              // the step's tap rows, per tile
  auto products = [&](int b) {
    const bf16* gs = Gs + b * BUF;
    const bf16* fs = Fs + b * NB * SD_LDF;
    uint32_t af[2][MT][4], bq[2][NT][2];
    auto load = [&](int t, int s) {
      const int dh = t / 3, dw = t - 3 * (t / 3);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(af[s][mt], gs + a_off[mt][dh] + dw * SD_LDC);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t r4[4];
        ldsm_x4(r4, fs + (b_row + p * 16) * SD_LDF + t * SD_KC + b_koff);
        bq[s][2 * p][0] = r4[0];
        bq[s][2 * p][1] = r4[1];
        bq[s][2 * p + 1][0] = r4[2];
        bq[s][2 * p + 1][1] = r4[3];
      }
      if (NT & 1) ldsm_x2(bq[s][NT - 1], fs + b_row_last * SD_LDF + t * SD_KC + b_koff);
    };
    load(0, 0);
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      if (t + 1 < 9) load(t + 1, (t + 1) & 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af[t & 1][mt], bq[t & 1][nt]);
    }
  };

  const int g = lane >> 2, tg = lane & 3;
  // inv / shift of this thread's accumulator columns
  bf162 inv2[NT], shift2[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    inv2[nt] = sInv[(wn * NT * 8 + nt * 8 + tg * 2) >> 1];
    shift2[nt] = sShift[(wn * NT * 8 + nt * 8 + tg * 2) >> 1];
  }
  const bf162 zero2 = __float2bfloat162_rn(0.f);

  // the stream's first group: step 0's table, its first chunk and x tile
  if (nq > 0) {
    if (tid < S) tap_table(rw, Tab + tid, tid < Q, tp);
    seek_step(0);
    copy_chunk(0, 0);
    copy_x(0);
  }
  cp_async_commit();
  int b = 0;                                     // the buffer of the chunk multiplied
  for (int j = 0; j < nq; ++j) {
    for (int ck = 0; ck < nck; ++ck) {
      cp_async_wait<0>();                        // this thread's copies of the chunk
      form_chunk(ck, b);
      __syncthreads();                           // the chunk formed; the one before done
      if (ck == 0) {
        if (j > 0) {
          store_dx(j - 1);                       // then x(j) into the same vectors
          copy_x(j);
        }
        if (j + 1 < nq && tid < S)
          tap_table(rw, Tab + ((j + 1) & 1) * 3 * S + tid, (j + 1) * S + tid < Q, tp);
        const int* tab = Tab + (j & 1) * 3 * S + a_pix;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int dh = 0; dh < 3; ++dh)
            a_off[mt][dh] = tab[dh * S + mt * 16] * SD_LDC + a_koff;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;
      }
      if (ck + 1 < nck) {                        // the next chunk, into the other buffers
        copy_chunk(ck + 1, b ^ 1);
      } else if (j + 1 < nq) {
        seek_step(j + 1);
        copy_chunk(0, b ^ 1);
      }
      cp_async_commit();
      if (!(SD_ABLATE & 2)) products(b);
      b ^= 1;
    }

    // epilogue: dx^ = bf16(acc); with the prologue the mask from x, dx =
    // dxa * inv over the x tile, and the sums over the step's pixels. The
    // barrier: x(j) landed and visible, dx(j-1) stored.
    cp_async_wait<0>();
    __syncthreads();
    if (!(SD_ABLATE & 8)) {
      const int npx = min(S, Q - j * S);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = wm * MT * 16 + mt * 16 + g + half * 8;
          // pixels past the range read table offset 0: their dx^ is not
          // zero, so they are masked out of the sums
          const uint32_t live = row < npx ? 0xffffffffu : 0u;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int col = wn * NT * 8 + nt * 8 + tg * 2;
            const bf162 d = __floats2bfloat162_rn(acc[mt][nt][half * 2],
                                                  acc[mt][nt][half * 2 + 1]);
            bf162* px = reinterpret_cast<bf162*>(Xs + row * LDX + col);
            if (AFFINE) {
              const bf162 xv = *px;
              const uint32_t on = __hgt2_mask(
                  __hadd2_rn(__hmul2_rn(xv, inv2[nt]), shift2[nt]), zero2) & live;
              const uint32_t kept = *reinterpret_cast<const uint32_t*>(&d) & on;
              const bf162 dxa = *reinterpret_cast<const bf162*>(&kept);
              *px = __hmul2_rn(dxa, inv2[nt]);
              const float2 xf = __bfloat1622float2(xv);
              const float2 df = __bfloat1622float2(dxa);
              st1[nt][0] += xf.x * df.x;
              st1[nt][1] += xf.y * df.y;
              st2[nt][0] += df.x;
              st2[nt][1] += df.y;
            } else {
              *px = d;
            }
          }
        }
    }
    if ((SD_ABLATE & 8) && H < 0) {    // never true: keeps the products alive
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          Xs[(mt * NT + nt) * NTH + tid] = __float2bfloat16(
              acc[mt][nt][0] + acc[mt][nt][1] + acc[mt][nt][2] + acc[mt][nt][3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // dx(nq-1) staged; the filter chunks free
  if (nq > 0) store_dx(nq - 1);

  if (!AFFINE) return;
  // block-level sums in a fixed order: lanes sharing a column, then warps
  float* red1 = reinterpret_cast<float*>(Fs);    // [WM][NB]
  float* red2 = red1 + WM * NB;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v1 = st1[nt][e], v2 = st2[nt][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        v1 += __shfl_xor_sync(0xffffffffu, v1, off);
        v2 += __shfl_xor_sync(0xffffffffu, v2, off);
      }
      if (g == 0) {
        const int col = wn * NT * 8 + nt * 8 + tg * 2 + e;
        red1[wm * NB + col] = v1;
        red2[wm * NB + col] = v2;
      }
    }
  __syncthreads();
  for (int col = tid; col < NB; col += NTH) {
    if (n0 + col >= Ci) continue;
    float v1 = 0.f, v2 = 0.f;
    for (int m = 0; m < WM; ++m) {
      v1 += red1[m * NB + col];
      v2 += red2[m * NB + col];
    }
    a.part1[(int64_t)range * Ci + n0 + col] = v1;
    a.part2[(int64_t)range * Ci + n0 + col] = v2;
  }
}

template <int WM, int WN, int MT, int NT, bool AFFINE>
int launch_spatial_data(const SpatialDataArgs& a, cudaStream_t stream) {
  constexpr int S = 16 * MT * WM, NB = 8 * NT * WN;
  const size_t smem = spatial_data_smem(a.W, a.Cop, S, NB, a.XR);
  if (smem > (size_t)SF_SMEM_MAX || a.XR * a.W > SD_THREADS / 2 * SD_VMAX)
    return (int)cudaErrorInvalidValue;
  auto kern = spatial_data_kernel<WM, WN, MT, NT, AFFINE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int ranges = (a.images + a.images_per_range - 1) / a.images_per_range;
  kern<<<ranges * a.n_tiles, SD_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int WM, int WN, int MT, int NT>
int spatial_data_either(int affine, const SpatialDataArgs& a, cudaStream_t s) {
  return affine ? launch_spatial_data<WM, WN, MT, NT, true>(a, s)
                : launch_spatial_data<WM, WN, MT, NT, false>(a, s);
}

// step -> the warp layout (4 x 2 warps, N tile 64). These are the steps
// spatial_data_plan (ops/conv_bn.py) can ask for: 128 only where a step of
// 256 pixels reads more rows than a thread's SD_VMAX copies cover.
int dispatch_spatial_data(int step, int affine, const SpatialDataArgs& a,
                          cudaStream_t s) {
  if (step == 256) return spatial_data_either<4, 2, 4, 4>(affine, a, s);
  if (step == 128) return spatial_data_either<4, 2, 2, 4>(affine, a, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Spatial forward unit: the row walk
// ---------------------------------------------------------------------------
//
// Replaces _spatial_fwd (m3f/pytorch_tpu/ops/pallas/conv_bn.py, pallas_call
// at :192), which pads one (b, t) image's x^ after the prologue once per
// sequential grid step, builds a strip's im2col [sh*W, 9*Ci] in VMEM and
// does one product per strip with the filter resident, carrying the channel
// sums of the rounded y across the grid.
//
// y[b,t,h,w,co] = bf16(sum_{dh,dw} sum_ci x^[b,t,h+dh-1,w+dw-1,ci] *
// W[dh,dw,ci,co]) does 2*9*Ci*Co FLOP per pixel on (Ci + Co) * 2 bytes (x
// in, y out). Bound on an H100 at the serving forward's shapes (128 clips):
// stage 1 (x [128,16,56,56,64] -> Co 144) 1.07 TFLOP on 2.7 GB, 400
// FLOP/byte: operations, 1.08 ms; stages 2-4 (Ci 128 / 256 / 512)
// operations, 0.54 / 0.27 / 0.13 ms. So the products must run near the
// mma.sync rate, x^ must not be formed per tap or per output-channel tile,
// and the filter (166 KB at stage 1, up to 10.6 MB at stage 4) must not be
// re-read from the L2 for every few pixels.
//
// - Row walk (RowWalk, shared with the backward's spatial kernels). A block
//   walks a range of whole (b, t) images as one dense stream of output
//   pixels in steps of S (128 with N tiles of 144, 256 with N tiles of 64).
//   A step reads the stream rows from the one above its first pixel to the
//   one below its last, with one all-zero row before every image and after
//   the last; columns 0 and W+1 are zero: the conv's padding. The prologue
//   never touches them, so the padding is zero AFTER the prologue (relu(0 *
//   inv + shift) is not 0), as the reference's pad-after-prologue.
// - K runs outermost inside a step, in chunks of SW_KC = 16 input channels
//   for all nine taps: per chunk the block copies the step's x rows for
//   those channels (cp.async, zero-filled on the zero rows and past C_in),
//   each thread forms x^ in place once on the vectors it copied, after its
//   own wait_group (relu(bf16(bf16(x * inv) + shift)) on the bf16x2 unit,
//   _rn forms: no fused multiply-add), and the chunk is multiplied by the
//   filter chunk [NB, 9 taps x 16] for all nine taps. Chunk buffers are
//   double-buffered, one barrier a chunk. The [S, NB] accumulators stay in
//   registers for the whole step (72 a thread at S = 128, NB = 144), so x^
//   is formed once per step's row and N tile (the halo rows of a step twice)
//   and, at stage 1 (C_out 144, one N tile), once for every output channel.
// - The filter tile [NB, 9 * Ci] stays in shared memory where it fits
//   beside the chunk buffers (stage 1: 166 KB), copied once per block; else
//   each chunk's [NB, 9 x 16] slice is streamed with the chunk, so the
//   filter is read from the L2 once per step of S pixels.
// - A tap is an address offset. Each lane of ldmatrix reads its own output
//   pixel's row from a per-step table (tap_table): the offset of (h + dh -
//   1, w - 1) in the chunk buffer; tap dw adds dw pixels.
// - Tensor cores: ldmatrix + mma.sync m16n8k16 bf16 -> fp32; 8 warps in WM x
//   WN, each MT m16 pixel tiles x NT n8 channel tiles (32 x 72 at S = 128,
//   NB = 144: 6.5 ldmatrix.x4 per 18 products); a tap's fragments are loaded
//   while the tap before is multiplied.
// - Epilogue: the accumulators are rounded to bf16 and staged in shared
//   memory over the chunk buffers (each warp its own [32, 72] region), and
//   y leaves in 16-byte stores along the channels. s1 / s2 are taken over
//   the rounded values: per-thread fp32 sums over the walk, then warp
//   shuffles and shared memory in a fixed order into one partial row per
//   block, then colsum_kernel. No atomics: two calls give the same bits.
//   The next step's first chunk is copied after the staging is read (the
//   padding columns the staging overwrote are zeroed again then).
// - Parallelism: grid = image ranges x N tiles (the N tile fastest: the
//   blocks of one range run together and find x in the L2), about one
//   block a SM.

constexpr int SW_THREADS = 256;
constexpr int SW_KC = 16;                 // input channels of a chunk
constexpr int SW_LDC = SW_KC + 8;         // a chunk buffer's pixel stride (48 B)
constexpr int SW_LDF = 9 * SW_KC + 8;     // a streamed filter chunk's row stride (304 B)
constexpr int SW_VMAX = 8;                // x vectors a thread copies a chunk
constexpr int SW_WM = 4;                  // warps along the pixels
// Measurement knob, for filter_sweep.py only (y is then wrong): 1 leaves
// out forming x^, 2 the products, 4 the copies of x and of the filter (the
// buffers keep what they held), 8 the epilogue (staging, y stores, sums);
// 15 leaves the walk alone.
#ifndef SW_ABLATE
#define SW_ABLATE 0
#endif

struct SpatialFwdArgs {
  const bf16* x;       // [images, H, W, Ci]
  const bf16* w;       // [Co, 9*Ci]: w[co, tap*Ci + ci] = W[tap/3, tap%3, ci, co]
  const float* inv;    // [Ci] or null
  const float* shift;
  bf16* y;             // [images, H, W, Co]
  float* part1;        // [ranges][Co] partial s1, s2
  float* part2;
  int H, W, Ci, Co;
  int Cip;             // Ci rounded up to the chunk
  int images;          // B * T
  int images_per_range;
  int n_tiles;         // ceil(Co / NB)
  int XR;              // rows of a chunk buffer (spatial_ring_rows, one step)
  int resident;        // the block's filter tile stays in shared memory
};

// The chunk buffers, the y staging and the block's sums share one region.
__host__ __device__ inline size_t spatial_fwd_union(int W, int S, int NB, int XR) {
  const size_t bufs = 2 * (size_t)XR * (W + 2) * SW_LDC * sizeof(bf16);
  const size_t stage = (size_t)S * (NB + 8) * sizeof(bf16);
  const size_t red = 2 * (size_t)SW_WM * NB * sizeof(float);
  return bufs > stage ? (bufs > red ? bufs : red) : (stage > red ? stage : red);
}

// A block's shared memory; ops/conv_bn.py (_spatial_fwd_smem) computes the
// same: that region, the filter tile or two streamed filter chunks, two tap
// tables, inv / shift.
size_t spatial_fwd_smem(int W, int Cip, int S, int NB, int XR, int resident) {
  const size_t filt = resident ? (size_t)NB * (9 * Cip + 8) : 2 * (size_t)NB * SW_LDF;
  return spatial_fwd_union(W, S, NB, XR) + filt * sizeof(bf16) + 24 * (size_t)S +
         4 * (size_t)Cip;
}

// SW_WM x WN warps, each MT m16 pixel tiles x NT n8 channel tiles: S =
// 16*MT*SW_WM pixels a step, NB = 8*NT*WN output channels a block.
template <int WN, int MT, int NT, bool AFFINE>
__global__ void __launch_bounds__(SW_THREADS, 1)
spatial_fwd_kernel(const SpatialFwdArgs a) {
  constexpr int NTH = SW_THREADS, WM = SW_WM;
  static_assert(32 * WM * WN == NTH, "8 warps");
  constexpr int S = 16 * MT * WM;
  constexpr int NB = 8 * NT * WN;
  constexpr int LDS = NB + 8;                  // staging row stride (bf16)
  constexpr int FV = NB * 9 * SW_KC / 8;       // 16-byte vectors of a filter chunk
  constexpr int F_IT = (FV + NTH - 1) / NTH;
  constexpr int XP = NTH / 2;                  // pixels per copy pass (2 vectors each)
  const int H = a.H, W = a.W, Ci = a.Ci, Co = a.Co, Cip = a.Cip, XR = a.XR;
  const int HW = H * W, WP = W + 2, BUF = XR * WP * SW_LDC;
  const bool res = a.resident != 0;
  const int ldf = res ? 9 * Cip + 8 : SW_LDF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xb = reinterpret_cast<bf16*>(smem_raw);            // [2][XR][WP][SW_LDC]
  bf16* Ys = Xb;                                           // the staging [S][LDS]
  bf16* Fs = reinterpret_cast<bf16*>(smem_raw + spatial_fwd_union(W, S, NB, XR));
  int* Tab = reinterpret_cast<int*>(Fs + (res ? NB * ldf : 2 * NB * SW_LDF));  // [2][3][S]
  bf162* sInv = reinterpret_cast<bf162*>(Tab + 6 * S);    // [Cip / 2]
  bf162* sShift = sInv + Cip / 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int n0 = ((int)blockIdx.x % a.n_tiles) * NB;
  const int range = (int)blockIdx.x / a.n_tiles;
  const int i0 = range * a.images_per_range;
  const int nimg = max(0, min(a.images, i0 + a.images_per_range) - i0);
  const int Q = nimg * HW;                        // output pixels of the range
  const int nq = (Q + S - 1) / S;                 // steps of the walk
  const int nck = Cip / SW_KC;                    // chunks a step
  const int64_t P0 = (int64_t)i0 * HW;            // the range's first pixel

  // The chunk buffers zero once: the padding columns stay so (see the
  // epilogue).
  {
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    const int n16 = 2 * BUF / 8;
    for (int i = tid; i < n16; i += NTH) z[i] = make_uint4(0, 0, 0, 0);
  }
  for (int c = tid; c < Cip / 2; c += NTH) {
    const int n = 2 * c;
    const bool ok = AFFINE && n < Ci;
    sInv[c] = __floats2bfloat162_rn(ok ? a.inv[n] : 0.f, ok ? a.inv[n + 1] : 0.f);
    sShift[c] = __floats2bfloat162_rn(ok ? a.shift[n] : 0.f,
                                      ok ? a.shift[n + 1] : 0.f);
  }
  // the resident filter tile: [n][ck * 144 + tap * 16 + kk]
  if (res && !(SW_ABLATE & 4)) {
    const int rv = 9 * Cip / 8;                   // vectors of a row
    for (int idx = tid; idx < NB * rv; idx += NTH) {
      const int n = idx / rv, col = (idx - n * rv) * 8;
      const int ck = col / (9 * SW_KC), rr = col - ck * 9 * SW_KC;
      const int tap = rr / SW_KC, ci = ck * SW_KC + rr - tap * SW_KC;
      const bool ok = n0 + n < Co && ci < Ci;
      cp_async16(Fs + n * ldf + col,
                 ok ? a.w + ((int64_t)(n0 + n) * 9 + tap) * Ci + ci : a.w, ok);
    }
  }
  __syncthreads();

  // Cursors (see RowWalk): this thread's pixel of the table, the first and
  // the last pixel of the next step to copy.
  const RowWalk rw = row_walk(H, W, XR, XP, S, nimg);
  PCursor tp = p_seek(rw, min(tid, S - 1));
  PCursor cf = p_seek(rw, 0), ce = p_seek(rw, S - 1);

  // This thread's x vectors of a step: channels gv..gv+7 of each chunk at
  // buffer offset v_off of the pixel v_pix of the range (-1: a zero row,
  // -2: none). The same for every chunk of the step; a thread copies and
  // forms exactly these.
  const int gv = (tid & 1) * 8;
  int v_off[SW_VMAX], v_pix[SW_VMAX];
  auto seek_step = [&](int j) {                  // steps in order
    const int upto = row_need(rw, j, ce);
    const int rs = cf.vr - 1;                    // the row above the first pixel
    p_advance(rw, cf);
    XCursor c = x_seek(rw, rs * W + (tid >> 1));
#pragma unroll
    for (int k = 0; k < SW_VMAX; ++k) {
      const bool live = c.vr <= upto;
      v_off[k] = (c.slot * WP + 1 + c.w) * SW_LDC + gv;
      v_pix[k] = !live ? -2 : c.hrow ? c.rr * W + c.w : -1;
      if (live) x_advance(rw, c);
    }
  };
  // chunk ck of the current step into buffer b: the step's x rows for
  // channels ck*16 .. +15, and (streamed) the filter chunk
  auto copy_chunk = [&](int ck, int b) {
    if (SW_ABLATE & 4) return;
    const int ch = ck * SW_KC + gv;
    bf16* xd = Xb + b * BUF;
#pragma unroll
    for (int k = 0; k < SW_VMAX; ++k) {
      if (v_pix[k] < -1) continue;
      const bool real = v_pix[k] >= 0 && ch < Ci;
      cp_async16(xd + v_off[k], a.x + (real ? (P0 + v_pix[k]) * Ci + ch : 0), real);
    }
    if (res) return;
    bf16* fd = Fs + b * NB * SW_LDF;
#pragma unroll
    for (int i = 0; i < F_IT; ++i) {
      const int idx = tid + i * NTH;
      if (idx >= FV) break;
      const int n = idx / 18, r = idx - n * 18, tap = r >> 1, kk = (r & 1) * 8;
      const bool ok = n0 + n < Co && ck * SW_KC + kk < Ci;
      cp_async16(fd + n * SW_LDF + tap * SW_KC + kk,
                 ok ? a.w + ((int64_t)(n0 + n) * 9 + tap) * Ci + ck * SW_KC + kk
                    : a.w, ok);
    }
  };
  // x^ = relu(bf16(bf16(x * inv) + shift)) in place, on this thread's
  // vectors of real pixels (never the zero rows or columns)
  auto form_chunk = [&](int ck, int b) {
    const int ch = ck * SW_KC + gv;
    if (!AFFINE || (SW_ABLATE & 1) || ch >= Ci) return;
    bf162 iv[4], sv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      iv[i] = sInv[(ch >> 1) + i];
      sv[i] = sShift[(ch >> 1) + i];
    }
    bf16* xd = Xb + b * BUF;
#pragma unroll
    for (int k = 0; k < SW_VMAX; ++k) {
      if (v_pix[k] < 0) continue;
      uint4* p = reinterpret_cast<uint4*>(xd + v_off[k]);
      *p = prologue_x2(*p, iv, sv);
    }
  };

  float acc[MT][NT][4];
  float st1[NT][2], st2[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    st1[nt][0] = st1[nt][1] = st2[nt][0] = st2[nt][1] = 0.f;

  // ldmatrix lanes: A (pixels m, channels k) from the chunk buffer at the
  // lane's pixel's tap row; B (k, output channels n; two n8 tiles a x4) from
  // the filter [n][tap*16 + k] of the chunk
  const int a_koff = (lane >> 4) * 8;
  const int a_pix = wm * MT * 16 + (lane & 15);
  const int b_row = wn * NT * 8 + (lane & 7) + ((lane >> 4) & 1) * 8;
  const int b_koff = ((lane >> 3) & 1) * 8;
  const int b_row_last = wn * NT * 8 + (NT - 1) * 8 + (lane & 7);
  int a_off[MT][3];                              // the step's tap rows, per tile
  auto products = [&](int ck, int b) {
    const bf16* xs = Xb + b * BUF;
    const bf16* fs = res ? Fs + ck * 9 * SW_KC : Fs + b * NB * SW_LDF;
    uint32_t af[2][MT][4], bq[2][NT][2];
    auto load = [&](int t, int s) {
      const int dh = t / 3, dw = t - 3 * (t / 3);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(af[s][mt], xs + a_off[mt][dh] + dw * SW_LDC);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t r4[4];
        ldsm_x4(r4, fs + (b_row + p * 16) * ldf + t * SW_KC + b_koff);
        bq[s][2 * p][0] = r4[0];
        bq[s][2 * p][1] = r4[1];
        bq[s][2 * p + 1][0] = r4[2];
        bq[s][2 * p + 1][1] = r4[3];
      }
      if (NT & 1) ldsm_x2(bq[s][NT - 1], fs + b_row_last * ldf + t * SW_KC + b_koff);
    };
    load(0, 0);
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      if (t + 1 < 9) load(t + 1, (t + 1) & 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af[t & 1][mt], bq[t & 1][nt]);
    }
  };

  const int g = lane >> 2, tg = lane & 3;
  // the stream's first group: the resident filter, step 0's table and its
  // first chunk
  if (nq > 0) {
    if (tid < S) tap_table(rw, Tab + tid, tid < Q, tp);
    seek_step(0);
    copy_chunk(0, 0);
  }
  cp_async_commit();
  int b = 0;                                     // the buffer of the chunk multiplied
  for (int j = 0; j < nq; ++j) {
    for (int ck = 0; ck < nck; ++ck) {
      cp_async_wait<0>();                        // this thread's copies of the chunk
      form_chunk(ck, b);
      __syncthreads();                           // the chunk formed; the one before done
      if (ck == 0) {
        if (j + 1 < nq && tid < S)
          tap_table(rw, Tab + ((j + 1) & 1) * 3 * S + tid, (j + 1) * S + tid < Q, tp);
        const int* tab = Tab + (j & 1) * 3 * S + a_pix;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int dh = 0; dh < 3; ++dh)
            a_off[mt][dh] = tab[dh * S + mt * 16] * SW_LDC + a_koff;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;
      }
      if (ck + 1 < nck) {                        // the next chunk, into the other buffers
        copy_chunk(ck + 1, b ^ 1);
        cp_async_commit();
      }
      if (!(SW_ABLATE & 2)) products(ck, b);
      b ^= 1;
    }

    // epilogue: y = bf16(acc) staged over the chunk buffers, which every
    // warp has finished reading at this barrier; each warp stores its own
    // region of the staging in 16-byte vectors
    __syncthreads();
    const int npx = min(S, Q - j * S);
    if (!(SW_ABLATE & 8)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = wm * MT * 16 + mt * 16 + g + half * 8;
          // pixels past the range read table offset 0: their y is not
          // zero, so they are left out of the sums (and of the stores)
          const bool live = row < npx;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int col = wn * NT * 8 + nt * 8 + tg * 2;
            const bf162 p = __floats2bfloat162_rn(acc[mt][nt][half * 2],
                                                  acc[mt][nt][half * 2 + 1]);
            *reinterpret_cast<bf162*>(Ys + row * LDS + col) = p;
            if (live) {
              const float2 f = __bfloat1622float2(p);
              st1[nt][0] += f.x;
              st1[nt][1] += f.y;
              st2[nt][0] += f.x * f.x;
              st2[nt][1] += f.y * f.y;
            }
          }
        }
      __syncwarp();
      bf16* dst = a.y + (P0 + (int64_t)j * S) * Co + n0;
      for (int i = lane; i < MT * 16 * NT; i += 32) {
        const int r = i / NT, v = i - r * NT;
        const int row = wm * MT * 16 + r, col = (wn * NT + v) * 8;
        if (row < npx && n0 + col < Co)
          *reinterpret_cast<uint4*>(dst + (int64_t)row * Co + col) =
              *reinterpret_cast<const uint4*>(Ys + row * LDS + col);
      }
    }
    if ((SW_ABLATE & 8) && H < 0) {    // never true: keeps the products alive
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          Ys[(mt * NT + nt) * NTH + tid] = __float2bfloat16(
              acc[mt][nt][0] + acc[mt][nt][1] + acc[mt][nt][2] + acc[mt][nt][3]);
    }
    __syncthreads();                             // the staging read
    if (j + 1 < nq) {
      // the padding columns the staging overwrote, zero again; then the
      // next step's first chunk
      for (int i = tid; i < 8 * XR; i += NTH) {
        const int buf = i / (4 * XR), r = (i >> 2) % XR;
        const int col = (i & 2) ? W + 1 : 0, half = (i & 1) * 8;
        *reinterpret_cast<uint4*>(Xb + buf * BUF + (r * WP + col) * SW_LDC + half) =
            make_uint4(0, 0, 0, 0);
      }
      seek_step(j + 1);
      copy_chunk(0, b);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  // block-level sums in a fixed order: lanes sharing a column, then warps
  float* red1 = reinterpret_cast<float*>(smem_raw);        // [WM][NB]
  float* red2 = red1 + WM * NB;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v1 = st1[nt][e], v2 = st2[nt][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        v1 += __shfl_xor_sync(0xffffffffu, v1, off);
        v2 += __shfl_xor_sync(0xffffffffu, v2, off);
      }
      if (g == 0) {
        const int col = wn * NT * 8 + nt * 8 + tg * 2 + e;
        red1[wm * NB + col] = v1;
        red2[wm * NB + col] = v2;
      }
    }
  __syncthreads();
  for (int col = tid; col < NB; col += NTH) {
    if (n0 + col >= Co) continue;
    float v1 = 0.f, v2 = 0.f;
    for (int m = 0; m < WM; ++m) {
      v1 += red1[m * NB + col];
      v2 += red2[m * NB + col];
    }
    a.part1[(int64_t)range * Co + n0 + col] = v1;
    a.part2[(int64_t)range * Co + n0 + col] = v2;
  }
}

template <int WN, int MT, int NT, bool AFFINE>
int launch_spatial_fwd(const SpatialFwdArgs& a, cudaStream_t stream) {
  constexpr int S = 16 * MT * SW_WM, NB = 8 * NT * WN;
  const size_t smem = spatial_fwd_smem(a.W, a.Cip, S, NB, a.XR, a.resident);
  if (smem > (size_t)SF_SMEM_MAX || a.XR * a.W > SW_THREADS / 2 * SW_VMAX)
    return (int)cudaErrorInvalidValue;
  auto kern = spatial_fwd_kernel<WN, MT, NT, AFFINE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int ranges = (a.images + a.images_per_range - 1) / a.images_per_range;
  kern<<<ranges * a.n_tiles, SW_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int WN, int MT, int NT>
int spatial_fwd_either(int affine, const SpatialFwdArgs& a, cudaStream_t s) {
  return affine ? launch_spatial_fwd<WN, MT, NT, true>(a, s)
                : launch_spatial_fwd<WN, MT, NT, false>(a, s);
}

// (step, N tile) -> the warp layout (4 x 2 warps). These are the layouts
// spatial_fwd_plan (ops/conv_bn.py) can ask for.
int dispatch_spatial_fwd(int step, int nb, int affine, const SpatialFwdArgs& a,
                         cudaStream_t s) {
  if (step == 128 && nb == 144) return spatial_fwd_either<2, 2, 9>(affine, a, s);
  if (step == 256 && nb == 64) return spatial_fwd_either<2, 4, 4>(affine, a, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Temporal forward unit: the frame walk
// ---------------------------------------------------------------------------
//
// Replaces _temporal_fwd (m3f/pytorch_tpu/ops/pallas/conv_bn.py, pallas_call
// at :250), which takes a strip of one clip over all T frames, forms x^
// after the prologue with a zero frame at each end of the clip, builds the
// im2col [T*p, 3*Ci] in VMEM and does one product with the filter resident,
// carrying the channel sums of the rounded y across the sequential grid.
//
// y[b,t,p,co] = bf16(sum_dt sum_ci x^[b,t+dt-1,p,ci] * W[dt,ci,co]) does
// 2*3*Ci*Co FLOP per pixel on (Ci + Co) * 2 bytes (x in, y out). Bound on an
// H100 at the serving forward's shapes (128 clips): stage 1 (x
// [128,16,56,56,144] -> Co 64) 0.355 TFLOP on 2.67 GB, 133 FLOP/byte, under
// the ~295 at which the tensor cores set the floor: bytes, 0.80 ms; stage 2
// (288 -> 128) bytes, 0.20 ms; stages 3-4 (576 -> 256, 1152 -> 512)
// operations, 0.090 / 0.045 ms. Stage 1 is four fifths of the video's
// bound. So the design reads each x element once (at stage 1, where one
// tile covers C_out), forms it once, and lets y leave in whole vectors.
//
// - Frame walk. A work unit is a strip of S consecutive (clip, position)
//   pairs of the flattened B*H*W axis, walked over t = 0..T-1 (every clip
//   has the same T, so the strip's rows share t). Where H*W is small
//   (stages 3-4: 196 and 49) a strip spans several clips, so one pass of
//   the filter serves S positions whatever H*W is; a block's units follow
//   one another in one stream of chunks, so the rings stay full across
//   unit boundaries.
// - Input-stationary. The walk takes x frame t in chunks of KC input
//   channels; each chunk lands by cp.async (16-byte copies, zero-filled
//   past the strip and past C_in), is formed into x^ in place once by the
//   thread that copied it (relu(bf16(bf16(x * inv) + shift)) on the bf16x2
//   unit, _rn forms: no fused multiply-add), and is multiplied once per
//   tap into three register accumulators: output frames t+1 (tap 0), t
//   (tap 1) and t-1 (tap 2). So each x^ tile feeds all three output frames
//   and every output channel of the block. A tap whose output frame lies
//   outside the clip is skipped: the frames t = -1 and t = T are zero AFTER
//   the prologue, and no clip reads another's frames. After frame t's last
//   chunk, output frame t-1 is complete and leaves; the accumulators shift
//   by one frame. The rings hold chunks, not whole frames, so a strip of
//   128 positions fits at any C_in.
// - The filter tile [NB, 3 * Ci] stays in shared memory where it fits
//   (stage 1: 55 KB, stage 2 at N tiles of 64: 110 KB); else each chunk's
//   [NB, 3 x KC] slice streams from the L2 with the chunk, through the same
//   ring: the filter is then read once per frame and strip of S positions.
// - Tensor cores: ldmatrix + mma.sync m16n8k16 bf16 -> fp32; warp tiles of
//   32 x 32 (96 accumulators a thread for the three frames, ~215
//   registers); a chunk's A fragments are loaded once per k16 step and
//   serve the three taps.
// - One __syncthreads per chunk: it publishes the chunk formed by every
//   thread and frees the slot of the chunk before, into which the next
//   chunk's copy is issued (a ring of two slots: one chunk in flight while
//   one is formed and multiplied; two in flight measured slower).
// - Epilogue: each warp rounds its [32, 32] tile to bf16, stages it in a
//   region of shared memory of its own and stores y in 16-byte vectors
//   along the channels (no block barrier); s1 / s2 are per-thread fp32 sums
//   of the rounded values over the walk, then warp shuffles and shared
//   memory in a fixed order into one partial row per block, then
//   colsum_kernel. No atomics: two calls give the same bits.
// - Parallelism: grid = ranges of units x N tiles (the N tile fastest: the
//   blocks of one range run together and find x in the L2): one block of
//   8 warps a SM (strips of 128 x 64 output channels), or two of 4 warps
//   (64 x 64) where their shared memory fits half a SM (stage 1, 106 KB):
//   one block's products then run under the other's copies, forming and
//   epilogue, which inside a block add up (every warp does each in turn).
//   A 64 x 128 layout and every fragment of a k16 step loaded before its
//   products were measured and not kept (PERF.md).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (m3f_torch/scripts/
// filter_sweep.py --kind temporal_fwd, serving shapes, 128 clips, the
// planner's tiling through the C entry, device time: each call queued
// behind a spin kernel, 5 rounds of 20 in turn; two identical launches
// within 0.044 ms at stage 1 and 0.0005 ms elsewhere): 1.82 / 0.90 / 0.51
// / 0.25 ms per launch at stages 1-4, against 26.0 / 1.78 / 0.53 / 0.17
// for cuDNN's conv with the fp32 sums of y and 5.4 / 3.2 / 1.6 / 0.54 for
// the per-K-tile gather it replaced (the previous source, same call). At stage 1 the two blocks
// of 64 x 64 a SM ran 6% faster than one of 128 x 64 (4% at 32 clips),
// beyond the spread between identical launches. What holds it back, from
// the ablation builds at stage 1: the parts add up instead of overlapping,
// products 0.80, copies 0.35, forming 0.22, epilogue 0.16 ms, where
// streaming x and y alone (no products) takes 1.02 and the bytes' bound is
// 0.80; at stages 3-4 the filter streamed once per strip and frame, and at
// stage 4 only 49 strips of 128 (32 clips: 13, so 104 blocks for 132 SMs):
// cuDNN's conv + sums is as fast at stage 3 and 1.5x faster at stage 4.

constexpr int TW_XV = 9;       // x vectors a thread copies a chunk, at most
constexpr int TW_XS = 2;       // slots of the x (and streamed filter) ring
constexpr int TW_LDY = 40;     // a warp's y staging row stride (32 + 8 bf16)
// Measurement knob, for filter_sweep.py only (y is then wrong): 1 leaves
// out forming x^, 2 the products, 4 the copies of x and of the streamed
// filter (the rings keep what they held), 8 the epilogue (staging, y
// stores, sums); 15 leaves the walk alone.
#ifndef TW_ABLATE
#define TW_ABLATE 0
#endif

struct TemporalFwdArgs {
  const bf16* x;       // [B, T, H*W, Ci]
  const bf16* w;       // [Co, 3*Ci]: w[co, tap*Ci + ci] = W[tap, ci, co]
  const float* inv;    // [Ci] or null
  const float* shift;
  bf16* y;             // [B, T, H*W, Co]
  float* part1;        // [ranges][Co] partial s1, s2
  float* part2;
  int T, HW, Ci, Co;
  int positions;       // B * H*W: the axis the strips cut
  int KC;              // input channels of a chunk (a multiple of 16)
  int nck;             // chunks a frame: ceil(Ci / KC)
  int units;           // ceil(positions / S)
  int units_per_block;
  int n_tiles;         // ceil(Co / NB)
  int resident;        // the block's filter tile stays in shared memory
};

// A block's shared memory; ops/conv_bn.py (_temporal_fwd_smem) computes the
// same: the filter tile (resident) or its ring, the x ring, each warp's y
// staging, inv / shift.
size_t temporal_fwd_smem(int S, int NB, int KC, int nck, bool res) {
  const size_t filt = res ? (size_t)NB * (3 * nck * KC + 8)
                          : (size_t)TW_XS * NB * (3 * KC + 8);
  const size_t ring = (size_t)TW_XS * S * (KC + 8);
  const size_t stage = (size_t)(S / 32) * (NB / 32) * 32 * TW_LDY;
  return 2 * (filt + ring + stage) + 4 * (size_t)nck * KC;
}

// WM x WN warps of 32 x 32: S = 32*WM positions, NB = 32*WN output
// channels; PER_SM blocks must fit a multiprocessor's registers together.
template <int WM, int WN, bool AFFINE, int PER_SM>
__global__ void __launch_bounds__(32 * WM * WN, PER_SM)
temporal_fwd_kernel(const TemporalFwdArgs a) {
  constexpr int NTH = 32 * WM * WN;
  constexpr int S = 32 * WM, NB = 32 * WN;
  constexpr int MT = 2, NT = 4;                 // a warp's m16 x n8 tiles
  constexpr int XS = TW_XS;
  const int T = a.T, HW = a.HW, Ci = a.Ci, Co = a.Co, KC = a.KC, nck = a.nck;
  const bool res = a.resident != 0;
  const int LDX = KC + 8;                       // row strides (bf16): odd
  const int LDF = res ? 3 * nck * KC + 8 : 3 * KC + 8;   // multiples of 16 B
  const int VPR = KC / 8;                       // vectors of a chunk row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Fs = reinterpret_cast<bf16*>(smem_raw);   // [NB][LDF] or [XS][NB][LDF]
  bf16* Xs = Fs + (res ? NB * LDF : XS * NB * LDF);           // [XS][S][LDX]
  bf16* Ys = Xs + XS * S * LDX;                               // [warps][32][TW_LDY]
  bf162* sInv = reinterpret_cast<bf162*>(Ys + WM * WN * 32 * TW_LDY);  // [nck*KC/2]
  bf162* sShift = sInv + nck * KC / 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int n0 = ((int)blockIdx.x % a.n_tiles) * NB;
  const int range = (int)blockIdx.x / a.n_tiles;
  const int u0 = range * a.units_per_block;
  const int u1 = min(a.units, u0 + a.units_per_block);
  const int nq = u1 > u0 ? (u1 - u0) * T * nck : 0;   // chunks of the walk

  for (int c = tid; c < nck * KC / 2; c += NTH) {
    const int n = 2 * c;
    const bool ok = AFFINE && n < Ci;
    sInv[c] = __floats2bfloat162_rn(ok ? a.inv[n] : 0.f, ok ? a.inv[n + 1] : 0.f);
    sShift[c] = __floats2bfloat162_rn(ok ? a.shift[n] : 0.f,
                                      ok ? a.shift[n + 1] : 0.f);
  }
  // the resident filter tile: [n][c*3*KC + tap*KC + k] = W[tap, c*KC + k,
  // n0 + n], zero past Ci and Co
  if (res && !(TW_ABLATE & 4)) {
    const int rv = 3 * nck * VPR;                 // vectors of a row
    for (int idx = tid; idx < NB * rv; idx += NTH) {
      const int n = idx / rv, col = (idx - n * rv) * 8;
      const int c = col / (3 * KC), rr = col - c * 3 * KC;
      const int tap = rr / KC, ci = c * KC + rr - tap * KC;
      const bool ok = n0 + n < Co && ci < Ci;
      cp_async16(Fs + n * LDF + col,
                 ok ? a.w + ((int64_t)(n0 + n) * 3 + tap) * Ci + ci : a.w, ok);
    }
  }

  // This thread's x vectors of a chunk: c = tid + i*NTH -> row c / VPR,
  // channels (c % VPR) * 8 of the chunk; the same for every chunk.
  const int nvec = S * VPR;
  int x_soff[TW_XV], x_ch[TW_XV], x_pos[TW_XV];
#pragma unroll
  for (int i = 0; i < TW_XV; ++i) {
    const int c = tid + i * NTH, r = c / VPR, v8 = (c - r * VPR) * 8;
    x_soff[i] = r * LDX + v8;
    x_ch[i] = v8;
    x_pos[i] = -1;
  }
  // The position of row r of unit u at frame 0, b*T*HW + p (-1 past the
  // strip's end): only entering a unit divides.
  auto row_pos = [&](int u, int r) {
    const int gp = u * S + r;
    if (gp >= a.positions) return -1;
    const int b = gp / HW;
    return b * T * HW + (gp - b * HW);
  };
  auto seek_x = [&](int u) {
#pragma unroll
    for (int i = 0; i < TW_XV; ++i)
      x_pos[i] = row_pos(u, (tid + i * NTH) / VPR);
  };

  // A cursor on the walk: chunk c of frame t of unit u, the walk's q-th.
  struct Cursor {
    int q, u, t, c;
  };
  auto step = [&](Cursor& w) {
    ++w.q;
    if (++w.c < nck) return false;
    w.c = 0;
    if (++w.t < T) return false;
    w.t = 0;
    ++w.u;
    return true;                   // a new unit
  };

  // chunk w of the walk into its slot: x rows of the strip for the chunk's
  // channels, and (streamed) the filter chunk
  auto copy_chunk = [&](const Cursor& w) {
    if ((TW_ABLATE & 4) || w.q >= nq) return;
    const int slot = w.q % XS;
    bf16* xd = Xs + slot * S * LDX;
    const int64_t frame = (int64_t)w.t * HW;
#pragma unroll
    for (int i = 0; i < TW_XV; ++i) {
      if (tid + i * NTH >= nvec) break;
      const int ch = w.c * KC + x_ch[i];
      const bool ok = x_pos[i] >= 0 && ch < Ci;
      cp_async16(xd + x_soff[i],
                 ok ? a.x + (x_pos[i] + frame) * Ci + ch : a.x, ok);
    }
    if (res) return;
    bf16* fd = Fs + slot * NB * LDF;
    const int rv = 3 * VPR;                     // vectors of a filter row
    int n = tid / rv, j = tid - n * rv;
    const int dn = NTH / rv, dj = NTH - dn * rv;
    for (int idx = tid; idx < NB * rv; idx += NTH) {
      const int tap = (j >= VPR) + (j >= 2 * VPR), k8 = (j - tap * VPR) * 8;
      const int ci = w.c * KC + k8;
      const bool ok = n0 + n < Co && ci < Ci;
      cp_async16(fd + n * LDF + tap * KC + k8,
                 ok ? a.w + ((int64_t)(n0 + n) * 3 + tap) * Ci + ci : a.w, ok);
      n += dn;
      j += dj;
      if (j >= rv) {
        j -= rv;
        ++n;
      }
    }
  };
  // x^ in place, on this thread's vectors of the chunk (channels past Ci
  // have inv = shift = 0: they stay 0)
  auto form_chunk = [&](const Cursor& w) {
    if (!AFFINE || (TW_ABLATE & 1)) return;
    bf16* xd = Xs + (w.q % XS) * S * LDX;
#pragma unroll
    for (int i = 0; i < TW_XV; ++i) {
      if (tid + i * NTH >= nvec) break;
      const int ch = w.c * KC + x_ch[i];
      const uint4 iv4 = *reinterpret_cast<const uint4*>(sInv + (ch >> 1));
      const uint4 sv4 = *reinterpret_cast<const uint4*>(sShift + (ch >> 1));
      const bf162* iv = reinterpret_cast<const bf162*>(&iv4);
      const bf162* sv = reinterpret_cast<const bf162*>(&sv4);
      const bf162 iv2[4] = {iv[0], iv[1], iv[2], iv[3]};
      const bf162 sv2[4] = {sv[0], sv[1], sv[2], sv[3]};
      uint4* p = reinterpret_cast<uint4*>(xd + x_soff[i]);
      *p = prologue_x2(*p, iv2, sv2);
    }
  };

  float acc[3][MT][NT][4];         // output frames t-1, t, t+1
#pragma unroll
  for (int f = 0; f < 3; ++f)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[f][mt][nt][k] = 0.f;
  float st1[NT][2], st2[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    st1[nt][0] = st1[nt][1] = st2[nt][0] = st2[nt][1] = 0.f;

  // ldmatrix lanes: A (positions m, channels k) from [position][k]; B
  // (channels k, output channels n; two n8 tiles a x4) from [n][tap*KC + k]
  const int a_off = (wm * 32 + (lane & 15)) * LDX + (lane >> 4) * 8;
  const int b_off = (wn * 32 + (lane & 7) + ((lane >> 4) & 1) * 8) * LDF +
                    ((lane >> 3) & 1) * 8;
  auto products = [&](const Cursor& w) {
    const bf16* xs = Xs + (w.q % XS) * S * LDX + a_off;
    const bf16* fs = (res ? Fs + w.c * 3 * KC : Fs + (w.q % XS) * NB * LDF) + b_off;
    const bool t0 = w.t + 1 < T, t2 = w.t > 0;   // taps 0 and 2 inside the clip
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldsm_x4(af[mt], xs + mt * 16 * LDX + ks * 16);
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        if ((dt == 0 && !t0) || (dt == 2 && !t2)) continue;
        uint32_t bq[NT][2];
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t r4[4];
          ldsm_x4(r4, fs + p * 16 * LDF + dt * KC + ks * 16);
          bq[2 * p][0] = r4[0];
          bq[2 * p][1] = r4[1];
          bq[2 * p + 1][0] = r4[2];
          bq[2 * p + 1][1] = r4[3];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[2 - dt][mt][nt], af[mt], bq[nt]);
      }
    }
  };

  // The epilogue's rows: fragment rows (valid below nvalid) and the rows
  // this lane stores, wm*32 + lane/4 + 8*i, at their frame-0 positions.
  const int g = lane >> 2, tg = lane & 3;
  int y_pos[4];
  int nvalid = 0;
  auto seek_y = [&](int u) {
    nvalid = min(S, a.positions - u * S);
#pragma unroll
    for (int i = 0; i < 4; ++i) y_pos[i] = row_pos(u, wm * 32 + g + 8 * i);
  };
  bf16* Yw = Ys + warp * 32 * TW_LDY;
  // output frame tf of the current unit from accumulator f
  auto epilogue = [&](const float (&f)[MT][NT][4], int tf) {
    if (TW_ABLATE & 8) return;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = mt * 16 + g + half * 8;
        const bool live = wm * 32 + row < nvalid;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const bf162 p = __floats2bfloat162_rn(f[mt][nt][half * 2],
                                                f[mt][nt][half * 2 + 1]);
          *reinterpret_cast<bf162*>(Yw + row * TW_LDY + nt * 8 + tg * 2) = p;
          if (live) {
            const float2 v = __bfloat1622float2(p);
            st1[nt][0] += v.x;
            st1[nt][1] += v.y;
            st2[nt][0] += v.x * v.x;
            st2[nt][1] += v.y * v.y;
          }
        }
      }
    __syncwarp();
    const int col = n0 + wn * 32 + tg * 8;
    const int64_t frame = (int64_t)tf * HW;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (y_pos[i] >= 0 && col < Co)
        *reinterpret_cast<uint4*>(a.y + (y_pos[i] + frame) * Co + col) =
            *reinterpret_cast<const uint4*>(Yw + (g + 8 * i) * TW_LDY + tg * 8);
    __syncwarp();
  };

  Cursor cc{0, u0, 0, 0};
  if (nq > 0) seek_x(u0);
  // the stream's first group: the resident filter with chunk 0
  copy_chunk(cc);
  if (step(cc)) seek_x(cc.u);
  cp_async_commit();
  Cursor mc{0, u0, 0, 0};
  if (nq > 0) seek_y(u0);
  __syncthreads();                   // inv / shift visible

  for (int q = 0; q < nq; ++q) {
    cp_async_wait<0>();              // this thread's copies of chunk q landed
    form_chunk(mc);
    __syncthreads();                 // chunk q formed; chunk q-1 multiplied
    copy_chunk(cc);                  // chunk q+1, into the slot of q-1
    if (step(cc)) seek_x(cc.u);
    cp_async_commit();
    if (!(TW_ABLATE & 2)) products(mc);
    if (mc.c == nck - 1) {           // frame t's last chunk: frame t-1 is done
      const int t = mc.t;
      if (t > 0) epilogue(acc[0], t - 1);
      if (t + 1 == T) {
        epilogue(acc[1], t);
#pragma unroll
        for (int f = 0; f < 3; ++f)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int k = 0; k < 4; ++k) acc[f][mt][nt][k] = 0.f;
      } else {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              acc[0][mt][nt][k] = acc[1][mt][nt][k];
              acc[1][mt][nt][k] = acc[2][mt][nt][k];
              acc[2][mt][nt][k] = 0.f;
            }
      }
    }
    if (step(mc)) seek_y(mc.u);
    if ((TW_ABLATE & 8) && T < 0) {    // never true: keeps the products alive
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          Ys[(mt * NT + nt) * NTH + tid] = __float2bfloat16(
              acc[0][mt][nt][0] + acc[1][mt][nt][1] + acc[2][mt][nt][2]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // every warp done with the rings

  // block-level sums in a fixed order: lanes sharing a column, then warps
  float* red1 = reinterpret_cast<float*>(Xs);    // [WM][NB]
  float* red2 = red1 + WM * NB;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v1 = st1[nt][e], v2 = st2[nt][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        v1 += __shfl_xor_sync(0xffffffffu, v1, off);
        v2 += __shfl_xor_sync(0xffffffffu, v2, off);
      }
      if (g == 0) {
        const int col = wn * 32 + nt * 8 + tg * 2 + e;
        red1[wm * NB + col] = v1;
        red2[wm * NB + col] = v2;
      }
    }
  __syncthreads();
  for (int col = tid; col < NB; col += NTH) {
    if (n0 + col >= Co) continue;
    float v1 = 0.f, v2 = 0.f;
    for (int m = 0; m < WM; ++m) {
      v1 += red1[m * NB + col];
      v2 += red2[m * NB + col];
    }
    a.part1[(int64_t)range * Co + n0 + col] = v1;
    a.part2[(int64_t)range * Co + n0 + col] = v2;
  }
}

template <int WM, int WN, bool AFFINE, int PER_SM>
int launch_temporal_fwd(const TemporalFwdArgs& a, cudaStream_t stream) {
  constexpr int S = 32 * WM, NB = 32 * WN, NTH = 32 * WM * WN;
  const size_t smem = temporal_fwd_smem(S, NB, a.KC, a.nck, a.resident != 0);
  if (smem > (size_t)SF_SMEM_MAX || S * (a.KC / 8) > TW_XV * NTH)
    return (int)cudaErrorInvalidValue;
  auto kern = temporal_fwd_kernel<WM, WN, AFFINE, PER_SM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int ranges = (a.units + a.units_per_block - 1) / a.units_per_block;
  kern<<<ranges * a.n_tiles, NTH, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int WM, int WN, int PER_SM>
int temporal_fwd_either(int affine, const TemporalFwdArgs& a, cudaStream_t s) {
  return affine ? launch_temporal_fwd<WM, WN, true, PER_SM>(a, s)
                : launch_temporal_fwd<WM, WN, false, PER_SM>(a, s);
}

// (strip, N tile) -> the warp layout of 32 x 32 warp tiles: 8 warps, or 4
// with two blocks a SM. These are the layouts temporal_fwd_plan
// (ops/conv_bn.py) can ask for.
int dispatch_temporal_fwd(int strip, int nb, int affine,
                          const TemporalFwdArgs& a, cudaStream_t s) {
  if (strip == 128 && nb == 64) return temporal_fwd_either<4, 2, 1>(affine, a, s);
  if (strip == 64 && nb == 64) return temporal_fwd_either<2, 2, 2>(affine, a, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Temporal data gradient: the frame walk
// ---------------------------------------------------------------------------
//
// Replaces _temporal_bwd_data_kernel (m3f/pytorch_tpu/ops/pallas/conv_bn.py,
// pallas_call at :612), which takes a strip of one clip over all T frames,
// builds the ge im2col [T*p, 3*Co] once in VMEM and does one product with
// the reversed filter [3*Co, Ci], then the ReLU mask, the scale by inv and
// the dinv / dshift sums carried across the sequential grid.
//
// dx^[b,t,p,ci] = bf16(sum_dt sum_co ge[b,t+dt,p,co] * W[1-dt,ci,co]) does
// 2*3*Co*Ci FLOP per pixel on (2*Co + 2*Ci) * 2 bytes (gy, y, x in, dx out).
// Bound on an H100 at the train step's shapes (32 clips): stage 1 (gy
// [32,16,56,56,64] -> dx 144) 88.8 GFLOP on 1.34 GB, 66 FLOP/byte: bytes,
// 0.40 ms; stage 2 (128 -> 288) bytes, 0.10 ms; stage 3 (256 -> 576) bytes,
// 0.025 ms; stage 4 (512 -> 1152) operations, 0.011 ms. Stage 1 is four
// fifths of the step's bound. So the design moves each byte of stage 1 once,
// forms ge once per element there, keeps the copies in flight under the
// products, and lets dx leave in whole 16-byte vectors.
//
// - Frame walk. A work unit is one clip b and one strip of S positions of
//   the H*W plane (S = 64, 32 or 16), walked over t = 0..T-1; a block's
//   units follow one another as one stream of frames. Shared memory holds a
//   ring of gy frame tiles [S, Co] (frames t-1, t, t+1 and `ahead` more in
//   flight), one of y tiles (only until ge is formed) and one of x tiles
//   [S, NB] (frame t-1 waiting to leave as dx, t, and `ahead` in flight).
//   Each gy tile is turned into ge in place once after it lands (from y,
//   gs1, gs2, two roundings) and then serves the three output frames that
//   use it. A tap whose frame lies outside the clip is skipped: no zero
//   tile, and the walk never mixes two clips.
// - All of C_in in one block where it fits: the block's accumulator is
//   [S, NB] with NB = 144 (the model's stage-1 C_in), so ge is formed once
//   per element at stage 1 and ceil(Ci / 144) times at the wider stages
//   (the N tile is fastest in the grid: the blocks of one unit run together
//   and find gy and y in the L2).
// - The flipped filter [NB, 3*Co] stays in shared memory for the whole walk
//   where it fits beside the rings (stage 1: 58 KB beside tiles of 64
//   positions; stage 2: 113 KB beside tiles of 32). Where it does not
//   (stages 3-4: 0.9 and 3.5 MB in all) it streams from the L2 in chunks of
//   one tap x 64 output channels through a three-slot cp.async ring, one
//   barrier a chunk.
// - The rings are filled by cp.async (16-byte copies, zero-filled past the
//   strip and past the channels). Each thread forms ge on exactly the
//   vectors it copied, so its own wait_group suffices before forming, and
//   one __syncthreads per frame step publishes ge(t+1) and x(t) and frees
//   the slots of the step before.
// - Tensor cores: ldmatrix + mma.sync m16n8k16 bf16 -> fp32; a warp owns
//   one m16 row tile x NT n8 tiles; K = Co per tap.
// - Epilogue. The accumulator is rounded to dx^; the ReLU mask recomputes
//   the forward prologue's two roundings from the x tile on the bf16x2 unit
//   (_rn forms: no fused multiply-add), dx = dxa * inv is written over the x
//   tile in shared memory, and leaves one step later in 16-byte stores along
//   the channel axis, under the next step's products. dinv / dshift: per-
//   thread fp32 sums over the whole walk, then warp shuffles and shared
//   memory in a fixed order into one partial row per block, then
//   colsum_kernel. No atomics: two calls give the same bits.
// - Parallelism: grid = ranges of units x N tiles, one block a SM. Every
//   warp copies, forms, multiplies and masks in turn, so inside one block
//   the phases add up. Two blocks of 32 positions a SM (6 warps capped at
//   168 registers, or 4 warps) overlap them and measured the same as one
//   block of 64 positions x 8 warps (0.76-0.81 against 0.75-0.81 ms at
//   stage 1), so the planner keeps the one rule (ops/conv_bn.py
//   temporal_data_plan); the others stay behind -DTD_TRIALS for the sweep.
// - Registers: a thread keeps for the whole walk its gs1 / gs2 (it forms
//   the same 8 channels of every row where the threads are a multiple of
//   the vectors per row), inv / shift of its accumulator columns and the
//   offsets of its x / dx vectors: 241 registers at 64 x 8, no spill.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (m3f_torch/scripts/
// filter_sweep.py --kind temporal_data, train step shapes, 32 clips, the C
// entry, two calls): 0.79 / 0.44-0.50 / 0.37-0.40 / 0.30 ms per launch at
// stages 1-4, against 2.51 / 1.57 / 0.54 / 0.32 for the per-tap gather it
// replaced and 1.67-1.76 / 0.53-0.55 / 0.19-0.21 / 0.10-0.12 for cuDNN's
// conv3d_input on ge already formed; per train step (chip_smoke.py) 5.9 ms
// against 14.9 and 8.2-8.7. What holds it back, from the sweep's ablation
// builds: at stage 1 the rings alone stream in 0.38 ms (the bound is 0.40
// with dx), and the products (0.20 ms of the whole), the epilogue (0.15),
// starting the copies (0.12) and forming (0.05) add to it instead of hiding
// under it; at stages 3-4 the filter, streamed from the L2 once per frame
// and 32 or 16 positions, is most of the time (0.27 of 0.40, 0.22 of 0.30
// ms with nothing else running): more positions per filter pass is what
// they need. PERF.md has the numbers.

constexpr int TD_KC = 64;      // output channels per streamed filter chunk
constexpr int TD_WST = 3;      // slots of the streamed filter's ring
constexpr int TD_LDC = TD_KC + 8;
// Measurement knob, for filter_sweep.py only (dx is then wrong): 1 leaves
// out forming ge, 2 the products, 4 the copies of gy, y and x (the rings
// keep what they held), 8 the epilogue (mask, scale, sums, dx stores);
// their sums leave out several.
#ifndef TD_ABLATE
#define TD_ABLATE 0
#endif

struct TemporalDataArgs {
  const bf16* gy;      // [B, T, H*W, Co]
  const bf16* y;
  const float* gs1;    // [Co]
  const float* gs2;
  const bf16* w;       // the filter [3, Ci, Co]; tap dt of the walk (frame
                       // t + dt - 1) multiplies W[2 - dt]
  const bf16* x;       // [B, T, H*W, Ci] or null
  const float* inv;    // [Ci] or null
  const float* shift;
  bf16* dx;            // [B, T, H*W, Ci]
  float* part1;        // [ranges][Ci] partial dinv, dshift
  float* part2;
  int T, HW, Ci, Co;
  int Cop;             // Co rounded up to the k16 step
  int strips;          // ceil(HW / S)
  int units;           // B * strips
  int units_per_block;
  int n_tiles;         // ceil(Ci / NB)
  int ahead;           // frames in flight beyond the one being formed
};

// WM x WN warps, each one m16 row tile x NT n8 tiles: S = 16*WM positions,
// NB = 8*NT*WN input channels. RES: the filter is resident. PER_SM: blocks
// that must fit a multiprocessor's registers together.
template <int WM, int WN, int NT, bool RES, bool AFFINE, int PER_SM>
__global__ void __launch_bounds__(32 * WM * WN, PER_SM)
temporal_data_kernel(const TemporalDataArgs a) {
  constexpr int NTH = 32 * WM * WN;
  constexpr int S = 16 * WM;
  constexpr int NB = 8 * NT * WN;
  constexpr int LDX = NB + 8;                  // row strides (bf16): 16-byte
  constexpr int XV = NB / 8;                   // multiples, ldmatrix conflict-free
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int T = a.T, HW = a.HW, Ci = a.Ci, Co = a.Co, Cop = a.Cop;
  const int LDG = Cop + 8, LDW = 3 * Cop + 8, GV = Cop / 8;
  const int AH = RES ? a.ahead : 1;
  const int GS = AH + 3, YS = AH + 1, XS = AH + 2;
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw);  // [NB][LDW] or [TD_WST][NB][TD_LDC]
  bf16* Gs = Ws + (RES ? NB * LDW : TD_WST * NB * TD_LDC);   // [GS][S][LDG]
  bf16* Ys = Gs + GS * S * LDG;                               // [YS][S][LDG]
  bf16* Xs = Ys + YS * S * LDG;                               // [XS][S][LDX]
  float* sG1 = reinterpret_cast<float*>(Xs + XS * S * LDX);   // [Cop]
  float* sG2 = sG1 + Cop;
  bf162* sInv = reinterpret_cast<bf162*>(sG2 + Cop);          // [NB / 2]
  bf162* sShift = sInv + NB / 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int n0 = ((int)blockIdx.x % a.n_tiles) * NB;
  const int range = (int)blockIdx.x / a.n_tiles;
  const int u0 = range * a.units_per_block;
  const int u1 = min(a.units, u0 + a.units_per_block);
  const int nq = u1 > u0 ? (u1 - u0) * T : 0;    // frames of the walk

  for (int c = tid; c < Cop; c += NTH) {
    sG1[c] = c < Co ? a.gs1[c] : 0.f;
    sG2[c] = c < Co ? a.gs2[c] : 0.f;
  }
  for (int c = tid; c < NB / 2; c += NTH) {
    const int n = n0 + 2 * c;
    const bool ok = AFFINE && n < Ci;
    sInv[c] = __floats2bfloat162_rn(ok ? a.inv[n] : 0.f, ok ? a.inv[n + 1] : 0.f);
    sShift[c] = __floats2bfloat162_rn(ok ? a.shift[n] : 0.f,
                                      ok ? a.shift[n + 1] : 0.f);
  }

  if (RES) {
    // the block's filter tile, flipped along dt: [n][tap*Cop + co] =
    // W[2 - tap, n0 + n, co], zero past Ci and Co
    const int WV = 3 * GV;
    for (int c = tid; c < NB * WV; c += NTH) {
      const int n = c / WV, v = c - n * WV;
      const int tap = v / GV, k8 = (v - tap * GV) * 8;
      const bool ok = n0 + n < Ci && k8 < Co;
      cp_async16(Ws + n * LDW + tap * Cop + k8,
                 ok ? a.w + ((int64_t)(2 - tap) * Ci + n0 + n) * Co + k8 : a.w, ok);
    }
    cp_async_commit();
  }

  // A cursor on the walk: frame q (frame t of unit u), its first pixel and
  // its rows inside the strip; only a step into the next unit divides.
  struct Cursor {
    int q, t, u, rows;
    int64_t base;
  };
  auto seek_unit = [&](Cursor& w) {
    const int b = w.u / a.strips, p0 = (w.u - b * a.strips) * S;
    w.base = (int64_t)b * T * HW + p0;
    w.rows = min(S, HW - p0);
  };
  auto step = [&](Cursor& w) {
    ++w.q;
    if (++w.t < T) {
      w.base += HW;
    } else {
      w.t = 0;
      ++w.u;
      seek_unit(w);
    }
  };

  // A thread's vectors of a gy / y tile: c = tid + i*NTH -> row c / GV,
  // vector c % GV, stepped by additions.
  const int g_r0 = tid / GV, g_v0 = tid - g_r0 * GV;
  const int g_dr = NTH / GV, g_dv = NTH - g_dr * GV;
  const int g_vecs = S * GV;

  auto copy_g = [&](const Cursor& w) {           // gy and y of frame w.q
    if ((TD_ABLATE & 4) || w.q >= nq) return;
    bf16* gd = Gs + (w.q % GS) * S * LDG;
    bf16* yd = Ys + (w.q % YS) * S * LDG;
    const int64_t frame = w.base * Co;
    int r = g_r0, v = g_v0;
    for (int c = tid; c < g_vecs; c += NTH) {
      const bool ok = r < w.rows && v * 8 < Co;
      const int64_t src = ok ? frame + (r * Co + v * 8) : 0;
      cp_async16(gd + r * LDG + v * 8, a.gy + src, ok);
      cp_async16(yd + r * LDG + v * 8, a.y + src, ok);
      r += g_dr;
      v += g_dv;
      if (v >= GV) {
        v -= GV;
        ++r;
      }
    }
  };
  // gs1 / gs2 of a vector's 8 channels. Where the threads are a multiple of
  // the vectors per row (every train shape) a thread keeps one column for
  // the whole walk and loads them once.
  float g1[8], g2[8];
  auto load_gs = [&](int v) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float4*>(g1 + 4 * h) =
          *reinterpret_cast<const float4*>(sG1 + v * 8 + 4 * h);
      *reinterpret_cast<float4*>(g2 + 4 * h) =
          *reinterpret_cast<const float4*>(sG2 + v * 8 + 4 * h);
    }
  };
  // ge = gy + bf16(gs1 + 2*y*gs2) in place of gy, on this thread's vectors
  auto form_g = [&](const Cursor& w) {
    if ((TD_ABLATE & 1) || w.q >= nq) return;
    bf16* gd = Gs + (w.q % GS) * S * LDG;
    const bf16* yd = Ys + (w.q % YS) * S * LDG;
    int r = g_r0, v = g_v0;
    for (int c = tid; c < g_vecs; c += NTH) {
      if (r < w.rows && v * 8 < Co) {
        uint4* p = reinterpret_cast<uint4*>(gd + r * LDG + v * 8);
        if (g_dv != 0) load_gs(v);
        *p = gy_eff8_x2(*p, *reinterpret_cast<const uint4*>(yd + r * LDG + v * 8),
                        g1, g2);
      }
      r += g_dr;
      v += g_dv;
      if (v >= GV) {
        v -= GV;
        ++r;
      }
    }
  };
  // A thread's vectors of an x / dx tile: c = tid + i*NTH -> row c / XV,
  // channels (c % XV) * 8; the offsets are the same for every frame. A
  // vector past C_in has row S: never inside the strip.
  constexpr int X_IT = (S * XV + NTH - 1) / NTH;
  int x_row[X_IT], x_smem[X_IT], x_gmem[X_IT];
#pragma unroll
  for (int i = 0; i < X_IT; ++i) {
    const int c = tid + i * NTH, r = c / XV, v = (c - r * XV) * 8;
    x_row[i] = n0 + v < Ci ? r : S;
    x_smem[i] = r * LDX + v;
    x_gmem[i] = r * Ci + v;
  }
  auto copy_x = [&](const Cursor& w) {
    if (!AFFINE || (TD_ABLATE & 4) || w.q >= nq) return;
    bf16* xd = Xs + (w.q % XS) * S * LDX;
    const bf16* frame = a.x + w.base * Ci + n0;
#pragma unroll
    for (int i = 0; i < X_IT; ++i) {
      if (tid + i * NTH >= S * XV) break;
      const bool ok = x_row[i] < w.rows;
      cp_async16(xd + x_smem[i], ok ? frame + x_gmem[i] : a.x, ok);
    }
  };
  // dx of frame w.q leaves its x slot: 16-byte stores along the channels
  auto store_dx = [&](const Cursor& w) {
    if (TD_ABLATE & 8) return;
    const bf16* xs = Xs + (w.q % XS) * S * LDX;
    bf16* frame = a.dx + w.base * Ci + n0;
#pragma unroll
    for (int i = 0; i < X_IT; ++i) {
      if (tid + i * NTH >= S * XV) break;
      if (x_row[i] < w.rows)
        *reinterpret_cast<uint4*>(frame + x_gmem[i]) =
            *reinterpret_cast<const uint4*>(xs + x_smem[i]);
    }
  };

  // The streamed filter's chunks, in the order the walk multiplies them:
  // per frame its taps inside the clip, per tap ceil(Cop / TD_KC) chunks.
  struct Chunk {
    int i, q, t, tap, kc;
  };
  const int kch = (Cop + TD_KC - 1) / TD_KC;
  auto next_chunk = [&](Chunk& w) {
    ++w.i;
    if (++w.kc < kch) return;
    w.kc = 0;
    ++w.tap;
    if (w.tap == 2 && w.t + 1 >= T) w.tap = 3;
    if (w.tap >= 3) {
      ++w.q;
      w.t = w.t + 1 < T ? w.t + 1 : 0;
      w.tap = w.t > 0 ? 0 : 1;
    }
  };
  auto copy_w = [&](const Chunk& w) {
    if (w.q >= nq) return;
    bf16* wd = Ws + (w.i % TD_WST) * NB * TD_LDC;
    for (int c = tid; c < NB * (TD_KC / 8); c += NTH) {
      const int n = c / (TD_KC / 8), v = (c % (TD_KC / 8)) * 8;
      const int k8 = w.kc * TD_KC + v;
      const bool ok = n0 + n < Ci && k8 < Co;
      cp_async16(wd + n * TD_LDC + v,
                 ok ? a.w + ((int64_t)(2 - w.tap) * Ci + n0 + n) * Co + k8 : a.w,
                 ok);
    }
  };

  Cursor cg{0, 0, u0, 0, 0};
  seek_unit(cg);
  Cursor cx = cg, fg = cg, cur = cg, prev = cg;
  Chunk pw{0, 0, 0, 1, 0}, cw = pw;

  // the stream's first groups: {g0, g1, x0}, then {g(k+1), x(k)}
  copy_g(cg);
  step(cg);
  for (int k = 0; k < AH; ++k) {
    copy_g(cg);
    step(cg);
    copy_x(cx);
    step(cx);
    cp_async_commit();
  }
  if (!RES) {
    for (int k = 0; k < TD_WST - 1; ++k) {
      copy_w(pw);
      next_chunk(pw);
      cp_async_commit();
    }
  }
  __syncthreads();                   // gs1 / gs2 / inv / shift visible
  load_gs(g_v0);

  float acc[NT][4];
  float st1[NT][2], st2[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    st1[nt][0] = st1[nt][1] = st2[nt][0] = st2[nt][1] = 0.f;

  // ldmatrix lanes: A (positions m, channels k) from [position][co]; B
  // (channels k, input channels n; two n8 tiles a x4) from [n][k]
  const int a_off = (wm * 16 + (lane & 15)) * LDG + (lane >> 4) * 8;
  const int b_row = wn * NT * 8 + (lane & 7) + ((lane >> 4) & 1) * 8;
  const int b_koff = ((lane >> 3) & 1) * 8;
  const int b_row_last = wn * NT * 8 + (NT - 1) * 8 + (lane & 7);
  auto products = [&](const bf16* as, const bf16* bs, int ldb, int ksteps) {
#pragma unroll 4
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t af[4];
      ldsm_x4(af, as + a_off + ks * 16);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t r4[4];
        ldsm_x4(r4, bs + (b_row + p * 16) * ldb + b_koff + ks * 16);
        const uint32_t lo[2] = {r4[0], r4[1]}, hi[2] = {r4[2], r4[3]};
        mma_bf16(acc[2 * p], af, lo);
        mma_bf16(acc[2 * p + 1], af, hi);
      }
      if (NT & 1) {
        uint32_t r2[2];
        ldsm_x2(r2, bs + b_row_last * ldb + b_koff + ks * 16);
        mma_bf16(acc[NT - 1], af, r2);
      }
    }
  };

  const int g = lane >> 2, tg = lane & 3;
  // inv / shift of this thread's accumulator columns
  bf162 inv2[NT], shift2[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    inv2[nt] = sInv[(wn * NT * 8 + nt * 8 + tg * 2) >> 1];
    shift2[nt] = sShift[(wn * NT * 8 + nt * 8 + tg * 2) >> 1];
  }
  const bf162 zero2 = __float2bfloat162_rn(0.f);
  for (int j = 0; j < nq; ++j) {
    // this thread's gy / y (j+1) and x(j) landed
    if (RES && AH == 2)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    if (j == 0) {
      form_g(fg);
      step(fg);
    }
    form_g(fg);                      // ge(j+1)
    step(fg);
    __syncthreads();                 // ge(j+1), x(j) visible; step j-1 done
    copy_g(cg);                      // gy / y (j+1+AH), into the slot of ge(j-2)
    step(cg);
    copy_x(cx);                      // x(j+AH), into the slot of dx(j-2)
    step(cx);
    if (RES) cp_async_commit();      // streamed: rides the next chunk's group
    if (j > 0) store_dx(prev);       // dx(j-1)

#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[nt][k] = 0.f;
    const int t = cur.t;
    const int tap_lo = t > 0 ? 0 : 1, tap_hi = t + 1 < T ? 3 : 2;
    for (int tap = tap_lo; tap < tap_hi; ++tap) {
      const bf16* gs = Gs + ((j + tap - 1 + GS) % GS) * S * LDG;
      if (RES) {
        if (!(TD_ABLATE & 2)) products(gs, Ws + tap * Cop, LDW, Cop / 16);
      } else {
        for (int kc = 0; kc < kch; ++kc) {
          cp_async_wait<1>();        // this thread's part of chunk cw landed
          __syncthreads();           // all of it; the chunk before is done
          copy_w(pw);                // two chunks ahead, into that one's slot
          next_chunk(pw);
          cp_async_commit();
          if (!(TD_ABLATE & 2))
            products(gs + kc * TD_KC, Ws + (cw.i % TD_WST) * NB * TD_LDC, TD_LDC,
                     min(TD_KC, Cop - kc * TD_KC) / 16);
          next_chunk(cw);
        }
      }
    }

    // epilogue: dx^ = bf16(acc); with the prologue the mask from x, dx =
    // dxa * inv over the x tile, and the sums over the rows of the strip
    if (!(TD_ABLATE & 8)) {
      bf16* xs = Xs + (j % XS) * S * LDX;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm * 16 + g + half * 8;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = wn * NT * 8 + nt * 8 + tg * 2;
          const bf162 d = __floats2bfloat162_rn(acc[nt][half * 2],
                                                acc[nt][half * 2 + 1]);
          bf162* px = reinterpret_cast<bf162*>(xs + row * LDX + col);
          if (AFFINE) {
            // rows past the strip hold x = 0 and dx^ = 0 (their ge rows are
            // zero-filled and never formed): they add nothing to the sums
            const bf162 xv = *px;
            const uint32_t on = __hgt2_mask(
                __hadd2_rn(__hmul2_rn(xv, inv2[nt]), shift2[nt]), zero2);
            const uint32_t kept = *reinterpret_cast<const uint32_t*>(&d) & on;
            const bf162 dxa = *reinterpret_cast<const bf162*>(&kept);
            *px = __hmul2_rn(dxa, inv2[nt]);
            const float2 xf = __bfloat1622float2(xv);
            const float2 df = __bfloat1622float2(dxa);
            st1[nt][0] += xf.x * df.x;
            st1[nt][1] += xf.y * df.y;
            st2[nt][0] += df.x;
            st2[nt][1] += df.y;
          } else {
            *px = d;
          }
        }
      }
    }
    if ((TD_ABLATE & 8) && T < 0) {    // never true: keeps the products alive
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        Xs[nt * NTH + tid] = __float2bfloat16(acc[nt][0] + acc[nt][1] +
                                              acc[nt][2] + acc[nt][3]);
    }
    prev = cur;
    step(cur);
  }
  cp_async_wait<0>();
  __syncthreads();                   // dx(nq-1) staged
  if (nq > 0) store_dx(prev);

  if (!AFFINE) return;
  // block-level sums in a fixed order: lanes sharing a column, then warps
  float* red1 = reinterpret_cast<float*>(Gs);    // [WM][NB], the ring is free
  float* red2 = red1 + WM * NB;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v1 = st1[nt][e], v2 = st2[nt][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        v1 += __shfl_xor_sync(0xffffffffu, v1, off);
        v2 += __shfl_xor_sync(0xffffffffu, v2, off);
      }
      if (g == 0) {
        const int col = wn * NT * 8 + nt * 8 + tg * 2 + e;
        red1[wm * NB + col] = v1;
        red2[wm * NB + col] = v2;
      }
    }
  __syncthreads();
  for (int col = tid; col < NB; col += NTH) {
    if (n0 + col >= Ci) continue;
    float v1 = 0.f, v2 = 0.f;
    for (int m = 0; m < WM; ++m) {
      v1 += red1[m * NB + col];
      v2 += red2[m * NB + col];
    }
    a.part1[(int64_t)range * Ci + n0 + col] = v1;
    a.part2[(int64_t)range * Ci + n0 + col] = v2;
  }
}

// A block's shared memory; ops/conv_bn.py (_temporal_data_smem) computes
// the same.
size_t temporal_data_smem(int S, int NB, int Cop, bool res, int ahead) {
  const size_t ldg = Cop + 8;
  const size_t w = res ? (size_t)NB * (3 * Cop + 8) : (size_t)TD_WST * NB * TD_LDC;
  const size_t rings = (size_t)(2 * ahead + 4) * S * ldg +
                       (size_t)(ahead + 2) * S * (NB + 8);
  return 2 * (w + rings) + 8 * (size_t)Cop + 4 * (size_t)NB;
}

template <int WM, int WN, int NT, bool RES, bool AFFINE, int PER_SM>
int launch_temporal_data(const TemporalDataArgs& a, cudaStream_t stream) {
  constexpr int NB = 8 * NT * WN;
  const size_t smem =
      temporal_data_smem(16 * WM, NB, a.Cop, RES, RES ? a.ahead : 1);
  if (smem > (size_t)SF_SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = temporal_data_kernel<WM, WN, NT, RES, AFFINE, PER_SM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int ranges = (a.units + a.units_per_block - 1) / a.units_per_block;
  kern<<<ranges * a.n_tiles, 32 * WM * WN, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int WM, int WN, int NT, bool RES, int PER_SM = 1>
int temporal_data_either(int affine, const TemporalDataArgs& a, cudaStream_t s) {
  return affine ? launch_temporal_data<WM, WN, NT, RES, true, PER_SM>(a, s)
                : launch_temporal_data<WM, WN, NT, RES, false, PER_SM>(a, s);
}

// (strip, warps, filter resident) -> the warp layout; every layout's N tile
// is 144. These are the layouts temporal_data_plan (ops/conv_bn.py) can ask
// for: whole-Co frame tiles of 64 positions fit beside a resident filter up
// to Co 96, of 32 up to 144; streamed, 32 positions fit up to Co 336 and 16
// up to 752.
int dispatch_temporal_data(int strip, int warps, int resident, int affine,
                           const TemporalDataArgs& a, cudaStream_t s) {
  if (strip == 64 && warps == 8 && resident)
    return temporal_data_either<4, 2, 9, true>(affine, a, s);
#ifdef TD_TRIALS
  // layouts tried by filter_sweep.py and not kept
  if (strip == 32 && warps == 6 && resident && a.ahead == 1)   // two a SM
    return temporal_data_either<2, 3, 6, true, 2>(affine, a, s);
  if (strip == 64 && warps == 12 && resident)
    return temporal_data_either<4, 3, 6, true>(affine, a, s);
  if (strip == 32 && warps == 4 && resident)
    return temporal_data_either<2, 2, 9, true>(affine, a, s);
#endif
  if (strip == 32 && warps == 6)
    return resident ? temporal_data_either<2, 3, 6, true>(affine, a, s)
                    : temporal_data_either<2, 3, 6, false>(affine, a, s);
  if (strip == 16 && warps == 6 && !resident)
    return temporal_data_either<1, 6, 3, false>(affine, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [B, T, H, W, Ci] bf16; wk [Co, taps*Ci] bf16 with k = tap*Ci + ci
// (spatial tap = dh*3 + dw, temporal tap = dt); inv/shift [Ci] fp32 or null;
// y [B, T, H, W, Co] bf16; s1/s2 [Co] fp32; part a scratch of 2 * ranges *
// Co floats. Spatial (kind 0, spatial_fwd_kernel): bn is the N tile (144 or
// 64) and step the output pixels a step (128 or 256, spatial_fwd_plan's
// pairs), per the images of a range (ranges = ceil(B*T / per)), resident
// whether the filter tile stays in shared memory; kc is not read.
// Temporal (kind 1, temporal_fwd_kernel): step is the strip of (clip,
// position) pairs (128 or 64) and bn the N tile (64 or 128,
// temporal_fwd_plan's pairs), per the strips of a range (ranges =
// ceil(ceil(B*H*W / step) / per)), resident whether the filter tile stays
// in shared memory and kc the input channels of a chunk (a multiple of 16).
extern "C" int m3f_conv_unit_fwd(const void* x, const void* wk, const void* inv,
                                 const void* shift, void* y, void* s1, void* s2,
                                 void* part, int kind, int B, int T, int H,
                                 int W, int Ci, int Co, int bn, int per,
                                 int step, int resident, int kc,
                                 void* stream) {
  const int64_t M = (int64_t)B * T * H * W;
  if ((kind != 0 && kind != 1) || per < 1) return (int)cudaErrorInvalidValue;
  if (M == 0 || Co == 0) return 0;
  if (Ci % 8 != 0 || Co % 8 != 0 || Ci == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* part1 = (float*)part;
  int ranges, e;
  if (kind == 1) {
    if (step < 32 || kc < 16 || kc % 16 != 0 || M >= ((int64_t)1 << 31))
      return (int)cudaErrorInvalidValue;
    TemporalFwdArgs t{};
    t.x = (const bf16*)x;
    t.w = (const bf16*)wk;
    t.inv = (const float*)inv;
    t.shift = (const float*)shift;
    t.y = (bf16*)y;
    t.T = T;
    t.HW = H * W;
    t.Ci = Ci;
    t.Co = Co;
    t.positions = B * H * W;
    t.KC = kc;
    t.nck = (Ci + kc - 1) / kc;
    t.units = (t.positions + step - 1) / step;
    t.units_per_block = per;
    t.n_tiles = (Co + bn - 1) / bn;
    t.resident = resident;
    ranges = (t.units + per - 1) / per;
    t.part1 = part1;
    t.part2 = part1 + (int64_t)ranges * Co;
    e = dispatch_temporal_fwd(step, bn, inv != nullptr, t, s);
  } else {
    if ((int64_t)per * H * W >= (1 << 30)) return (int)cudaErrorInvalidValue;
    SpatialFwdArgs f{};
    f.x = (const bf16*)x;
    f.w = (const bf16*)wk;
    f.inv = (const float*)inv;
    f.shift = (const float*)shift;
    f.y = (bf16*)y;
    f.H = H;
    f.W = W;
    f.Ci = Ci;
    f.Co = Co;
    f.Cip = (Ci + SW_KC - 1) / SW_KC * SW_KC;
    f.images = B * T;
    f.images_per_range = per;
    f.n_tiles = (Co + bn - 1) / bn;
    f.XR = spatial_ring_rows(H, W, step, 1);
    f.resident = resident;
    ranges = (f.images + per - 1) / per;
    f.part1 = part1;
    f.part2 = part1 + (int64_t)ranges * Co;
    e = dispatch_spatial_fwd(step, bn, inv != nullptr, f, s);
  }
  if (e != 0) return e;
  colsum_kernel<<<(Co + 31) / 32, dim3(32, 32), 0, s>>>(
      part1, part1 + (int64_t)ranges * Co, ranges, Co, (float*)s1, (float*)s2);
  return (int)cudaGetLastError();
}

// Data gradient of the unit. gy, y [B, T, H, W, Co] bf16; gs1/gs2 [Co] fp32;
// with the prologue x [B, T, H, W, Ci] bf16 and inv/shift [Ci] fp32 (else
// all three null); dx [B, T, H, W, Ci] bf16; dinv/dshift [Ci] fp32 (with the
// prologue); part a scratch of 2 * ranges * Ci floats (with the prologue),
// ranges = ceil(units / tiles_per_block). Spatial (kind 0,
// spatial_data_kernel): wd [Ci, 9*Co] bf16 is the flipped transposed
// filter, wd[ci, tap*Co + co] = W[2 - tap/3, 2 - tap%3, ci, co]; bn is the
// N tile (64), strip the output pixels a step (256 or 128),
// warps 8, and the units are the B * T images; resident and ahead are not
// read. Temporal (kind 1, temporal_data_kernel): wd is the filter itself,
// [3, Ci, Co] bf16 (the kernel flips the taps as it loads); bn is 144, strip
// the positions of H*W per unit (64, 32 or 16) with its warps (8, 6, 6),
// the units are the B * ceil(H*W / strip) clip strips, resident whether the
// block's filter tile stays in shared memory (else it streams), ahead the
// frames in flight (1 or 2; 1 when streamed).
extern "C" int m3f_conv_unit_bwd_data(const void* gy, const void* y,
                                      const void* gs1, const void* gs2,
                                      const void* wd, const void* x,
                                      const void* inv, const void* shift,
                                      void* dx, void* dinv, void* dshift,
                                      void* part, int kind, int B, int T,
                                      int H, int W, int Ci, int Co, int bn,
                                      int tiles_per_block, int strip,
                                      int warps, int resident, int ahead,
                                      void* stream) {
  const int affine = inv != nullptr;
  if ((kind != 0 && kind != 1) ||
      (affine && (x == nullptr || shift == nullptr || dinv == nullptr ||
                  dshift == nullptr || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int64_t M = (int64_t)B * T * H * W;
  if (M == 0 || Ci == 0) return 0;
  if (Ci % 8 != 0 || Co % 8 != 0 || Co == 0 || tiles_per_block < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int ranges, e;
  float* part1 = (float*)part;
  if (kind == 0) {
    if (bn != 64 || warps != 8 || (int64_t)tiles_per_block * H * W >= (1 << 30))
      return (int)cudaErrorInvalidValue;
    SpatialDataArgs d{};
    d.gy = (const bf16*)gy;
    d.y = (const bf16*)y;
    d.gs1 = (const float*)gs1;
    d.gs2 = (const float*)gs2;
    d.w = (const bf16*)wd;
    d.x = (const bf16*)x;
    d.inv = (const float*)inv;
    d.shift = (const float*)shift;
    d.dx = (bf16*)dx;
    d.H = H;
    d.W = W;
    d.Ci = Ci;
    d.Co = Co;
    d.Cop = (Co + SD_KC - 1) / SD_KC * SD_KC;
    d.images = B * T;
    d.images_per_range = tiles_per_block;
    d.n_tiles = (Ci + bn - 1) / bn;
    d.XR = spatial_ring_rows(H, W, strip, 1);
    ranges = (d.images + tiles_per_block - 1) / tiles_per_block;
    d.part1 = part1;
    d.part2 = affine ? part1 + (int64_t)ranges * Ci : nullptr;
    e = dispatch_spatial_data(strip, affine, d, s);
  } else {
    if (bn != 144 || ahead < 1 || ahead > 2 || (!resident && ahead != 1))
      return (int)cudaErrorInvalidValue;
    TemporalDataArgs t{};
    t.gy = (const bf16*)gy;
    t.y = (const bf16*)y;
    t.gs1 = (const float*)gs1;
    t.gs2 = (const float*)gs2;
    t.w = (const bf16*)wd;
    t.x = (const bf16*)x;
    t.inv = (const float*)inv;
    t.shift = (const float*)shift;
    t.dx = (bf16*)dx;
    t.T = T;
    t.HW = H * W;
    t.Ci = Ci;
    t.Co = Co;
    t.Cop = (Co + 15) / 16 * 16;
    t.strips = (t.HW + strip - 1) / strip;
    t.units = B * t.strips;
    t.units_per_block = tiles_per_block;
    t.n_tiles = (Ci + bn - 1) / bn;
    t.ahead = ahead;
    ranges = (t.units + tiles_per_block - 1) / tiles_per_block;
    t.part1 = part1;
    t.part2 = affine ? part1 + (int64_t)ranges * Ci : nullptr;
    e = dispatch_temporal_data(strip, warps, resident, affine, t, s);
  }
  if (e != 0 || !affine) return e;
  colsum_kernel<<<(Ci + 31) / 32, dim3(32, 32), 0, s>>>(
      part1, part1 + (int64_t)ranges * Ci, ranges, Ci, (float*)dinv,
      (float*)dshift);
  return (int)cudaGetLastError();
}

// Filter gradient of the unit. x [B, T, H, W, Ci], gy and y [B, T, H, W, Co]
// bf16; inv/shift [Ci] fp32 or null; gs1/gs2 [Co] fp32; dw [taps*Ci, Co]
// fp32 with row tap*Ci + ci; part: scratch of slices * taps*Ci * Co floats
// (unused, may be null, when slices == 1). Spatial (kind 0): ci_blk x bn is
// the block's tile of input x output channels (64 x 48 or 32 x 48), strip
// the output pixels per step of the row walk (a multiple of 16, at most the
// block's 4 * ci_blk threads, whose rings fit a block's shared memory), and the B * T images are cut into `slices`
// contiguous ranges of ceil(images / slices). Temporal (kind 1): bn is 64,
// ci_blk the channel block (48 or 64), strip the positions per strip (TF_S),
// and the B * ceil(H*W / strip) units are cut into `slices` contiguous
// ranges of ceil(units / slices).
extern "C" int m3f_conv_unit_bwd_filter(const void* x, const void* gy,
                                        const void* y, const void* gs1,
                                        const void* gs2, const void* inv,
                                        const void* shift, void* dw,
                                        void* part, int kind, int B, int T,
                                        int H, int W, int Ci, int Co, int bn,
                                        int slices, int ci_blk, int strip,
                                        void* stream) {
  const int64_t M = (int64_t)B * T * H * W;
  const int K = (kind == 0 ? 9 : 3) * Ci;
  if ((kind != 0 && kind != 1) || Ci % 8 != 0 || Co % 8 != 0 || slices < 1 ||
      (slices > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (K == 0 || Co == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (M == 0) return (int)cudaMemsetAsync(dw, 0, (size_t)K * Co * sizeof(float), s);
  const int affine = inv != nullptr;
  int e;
  if (kind == 1) {
    if (bn != TF_CO || strip != TF_S) return (int)cudaErrorInvalidValue;
    TemporalFilterArgs t{};
    t.x = (const bf16*)x;
    t.gy = (const bf16*)gy;
    t.y = (const bf16*)y;
    t.inv = (const float*)inv;
    t.shift = (const float*)shift;
    t.gs1 = (const float*)gs1;
    t.gs2 = (const float*)gs2;
    t.out = slices > 1 ? (float*)part : (float*)dw;
    t.T = T;
    t.HW = H * W;
    t.Ci = Ci;
    t.Co = Co;
    t.strips = (t.HW + TF_S - 1) / TF_S;
    t.units = B * t.strips;
    t.units_per_slice = (t.units + slices - 1) / slices;
    t.ci_blocks = (Ci + ci_blk - 1) / ci_blk;
    if (ci_blk == 48)
      e = dispatch_temporal_filter<3>(affine, t, slices, s);
    else if (ci_blk == 64)
      e = dispatch_temporal_filter<4>(affine, t, slices, s);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    const int images = B * T;
    const int per = (images + slices - 1) / slices;
    if (strip < 16 || strip % 16 != 0 || (int64_t)per * H * W >= (1 << 30))
      return (int)cudaErrorInvalidValue;
    SpatialFilterArgs a{};
    a.x = (const bf16*)x;
    a.gy = (const bf16*)gy;
    a.y = (const bf16*)y;
    a.inv = (const float*)inv;
    a.shift = (const float*)shift;
    a.gs1 = (const float*)gs1;
    a.gs2 = (const float*)gs2;
    a.out = slices > 1 ? (float*)part : (float*)dw;
    a.H = H;
    a.W = W;
    a.Ci = Ci;
    a.Co = Co;
    a.images = images;
    a.images_per_slice = per;
    a.ci_blocks = (Ci + ci_blk - 1) / ci_blk;
    a.S = strip;
    a.XR = spatial_ring_rows(H, W, strip, SF_AHEAD + 1);
    e = dispatch_spatial_filter(ci_blk, bn, affine, a, slices, s);
  }
  if (e != 0 || slices == 1) return e;
  const int64_t n4 = (int64_t)K * Co / 4;
  const int64_t want = (n4 + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  slice_sum_kernel<<<blocks, 256, 0, s>>>((const float4*)part, slices, n4,
                                          (float4*)dw);
  return (int)cudaGetLastError();
}
