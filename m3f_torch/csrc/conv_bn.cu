// Fused conv + BatchNorm forward units of the R(2+1)D blocks.
//
// Replaces: m3f/pytorch_tpu/ops/pallas/conv_bn.py _spatial_fwd (kernel body
//           _spatial_fwd_kernel) and _temporal_fwd (_temporal_fwd_kernel),
//           the forward of conv_unit / conv_unit_fwd.
//
//   prologue:  x^ = relu(bf16(bf16(x * inv) + shift))   (previous BN + ReLU,
//                                                       optional)
//   conv:      y  = bf16(x^ (*) W)   (1,3,3) or (3,1,1), stride 1, pad 1,
//                                    fp32 accumulation
//   epilogue:  s1 = sum y, s2 = sum y^2 per output channel, fp32, over the
//              ROUNDED y
//
// Bound on an H100: operations. As an implicit GEMM it is M = B*T*H*W
// output pixels, N = C_out, K = 9*C_in (spatial) or 3*C_in (temporal); at
// the main path's stage-1 spatial unit (M = 6.4 M, K = 576, N = 144) that is
// 1.07 TFLOP against ~2.7 GB of input and output, far above the ~295
// FLOP/byte at which the bf16 tensor cores (989 TFLOP/s) and not memory
// (3.35 TB/s) set the floor.
//
// Design (a simple, correct tensor-core kernel; wgmma / TMA come later):
// - A 128 x BN output tile per block, 4 warps in 2 x 2, each warp 64 x BN/2
//   with mma.sync m16n8k16 bf16 -> fp32 and ldmatrix fragment loads.
// - K runs in chunks of 32 over the flattened (tap, c_in) axis. Each thread
//   gathers its A rows as 16-byte vectors straight from the NDHWC activation
//   at the tap's offset; a tap that falls outside the image (or clip) is the
//   conv's zero padding, written as zeros AFTER the prologue. The prologue
//   rounds like the reference: product to bf16, then sum to bf16, then ReLU.
// - Chunks go global -> registers -> shared memory, double-buffered: the
//   next chunk's loads are in flight while the tensor cores work on this one.
// - Epilogue: y is rounded to bf16 and stored; the rounded values feed the
//   per-channel sums. The TPU grid is sequential and carries the sums across
//   steps; CUDA blocks run in parallel, so each block loops over a few row
//   tiles, reduces its sums in a fixed order (warp shuffles, then shared
//   memory) and writes one partial row; a second small kernel sums the
//   partial rows per channel in a fixed order. No atomics: deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;          // output pixels per tile
constexpr int BK = 32;           // K per chunk
constexpr int LDS = BK + 8;      // shared row stride (bf16): 80 B, conflict-free
constexpr int THREADS = 128;

__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// relu(bf16(bf16(x * inv) + shift)) on 8 bf16 lanes
__device__ __forceinline__ uint4 prologue(uint4 v, const bf16* inv,
                                          const bf16* shift) {
  const uint4 iv = *reinterpret_cast<const uint4*>(inv);
  const uint4 sv = *reinterpret_cast<const uint4*>(shift);
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
  const __nv_bfloat162* pi = reinterpret_cast<const __nv_bfloat162*>(&iv);
  const __nv_bfloat162* ps = reinterpret_cast<const __nv_bfloat162*>(&sv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(p[i]);
    const float2 a = __bfloat1622float2(pi[i]);
    const float2 b = __bfloat1622float2(ps[i]);
    const float y0 = fmaxf(rnd(rnd(x.x * a.x) + b.x), 0.f);
    const float y1 = fmaxf(rnd(rnd(x.y * a.y) + b.y), 0.f);
    p[i] = __floats2bfloat162_rn(y0, y1);
  }
  return v;
}

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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// KIND 0: (1,3,3) spatial conv over each (b, t) image [H, W].
// KIND 1: (3,1,1) temporal conv over T for each pixel of [H*W].
template <int BN, bool AFFINE, int KIND>
__global__ void __launch_bounds__(THREADS)
conv_unit_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wk,
                 const float* __restrict__ inv, const float* __restrict__ shift,
                 bf16* __restrict__ y, float* __restrict__ part1,
                 float* __restrict__ part2, int64_t M, int Ci, int Co, int T,
                 int H, int W, int tiles_m, int tiles_per_block) {
  constexpr int NT = BN / 16;                  // n8 tiles per warp
  constexpr int B_VECS = BN * BK / 8;          // 16-byte vectors per B chunk
  constexpr int B_IT = (B_VECS + THREADS - 1) / THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);          // [2][BM][LDS]
  bf16* Bs = As + 2 * BM * LDS;                           // [2][BN][LDS]
  float* red1 = reinterpret_cast<float*>(Bs + 2 * BN * LDS);  // [2][BN]
  float* red2 = red1 + 2 * BN;                            // [2][BN]
  bf16* sInv = reinterpret_cast<bf16*>(red2 + 2 * BN);    // [Ci]
  bf16* sShift = sInv + Ci;                               // [Ci]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 1, warp_n = warp >> 1;
  const int n0 = blockIdx.y * BN;
  const int taps = KIND == 0 ? 9 : 3;
  const int K = taps * Ci;
  const int nchunks = (K + BK - 1) / BK;
  const int64_t P = (int64_t)H * W;

  if (AFFINE) {
    for (int c = tid; c < Ci; c += THREADS) {
      sInv[c] = __float2bfloat16(inv[c]);
      sShift[c] = __float2bfloat16(shift[c]);
    }
  }
  __syncthreads();

  float st1[NT][2], st2[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    st1[nt][0] = st1[nt][1] = st2[nt][0] = st2[nt][1] = 0.f;

  const int kv = tid & 3;                      // this thread's 8-wide K slot
  const int tile_end = min(tiles_m, (int)(blockIdx.x + 1) * tiles_per_block);
  for (int tile = blockIdx.x * tiles_per_block; tile < tile_end; ++tile) {
    const int64_t m_base = (int64_t)tile * BM;
    int64_t rm[4];
    int ra_[4], rb_[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t m = m_base + (tid >> 2) + 32 * i;
      rm[i] = m;
      if (KIND == 0) {
        rb_[i] = (int)(m % W);
        ra_[i] = (int)((m / W) % H);
      } else {
        ra_[i] = (int)((m / P) % T);
        rb_[i] = 0;
      }
    }

    float acc[4][NT][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < NT; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

    uint4 regA[4], regB[B_IT];
    auto load = [&](int chunk) {
      const int k = chunk * BK + kv * 8;
      int tap = 0, ci = 0;
      if (k < K) {
        tap = k / Ci;
        ci = k - tap * Ci;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (rm[i] < M && k < K) {
          int64_t src;
          bool ok;
          if (KIND == 0) {
            const int dh = tap / 3 - 1, dw = tap % 3 - 1;
            ok = (unsigned)(ra_[i] + dh) < (unsigned)H &&
                 (unsigned)(rb_[i] + dw) < (unsigned)W;
            src = rm[i] + (int64_t)dh * W + dw;
          } else {
            const int dt = tap - 1;
            ok = (unsigned)(ra_[i] + dt) < (unsigned)T;
            src = rm[i] + dt * P;
          }
          if (ok) {
            v = __ldg(reinterpret_cast<const uint4*>(x + src * Ci + ci));
            if (AFFINE) v = prologue(v, sInv + ci, sShift + ci);
          }
        }
        regA[i] = v;
      }
#pragma unroll
      for (int j = 0; j < B_IT; ++j) {
        const int v = j * THREADS + tid;
        uint4 r = make_uint4(0, 0, 0, 0);
        if (v < B_VECS) {
          const int n = v >> 2, kb = chunk * BK + (v & 3) * 8;
          if (n0 + n < Co && kb < K)
            r = __ldg(reinterpret_cast<const uint4*>(wk + (int64_t)(n0 + n) * K + kb));
        }
        regB[j] = r;
      }
    };
    auto store = [&](int buf) {
      bf16* a = As + buf * BM * LDS;
      bf16* b = Bs + buf * BN * LDS;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint4*>(a + ((tid >> 2) + 32 * i) * LDS + kv * 8) = regA[i];
#pragma unroll
      for (int j = 0; j < B_IT; ++j) {
        const int v = j * THREADS + tid;
        if (v < B_VECS)
          *reinterpret_cast<uint4*>(b + (v >> 2) * LDS + (v & 3) * 8) = regB[j];
      }
    };

    load(0);
    store(0);
    __syncthreads();
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      const int buf = chunk & 1;
      if (chunk + 1 < nchunks) load(chunk + 1);
      const bf16* a = As + buf * BM * LDS;
      const bf16* b = Bs + buf * BN * LDS;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t af[4][4], bfr[NT][2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldsm_x4(af[mt], a + (warp_m * 64 + mt * 16 + (lane & 15)) * LDS +
                              ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          ldsm_x2(bfr[nt], b + (warp_n * (BN / 2) + nt * 8 + (lane & 7)) * LDS +
                               ks * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt]);
      }
      if (chunk + 1 < nchunks) store(buf ^ 1);
      __syncthreads();
    }

    // epilogue: round, store, and accumulate the sums of the rounded values
    const int g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t m = m_base + warp_m * 64 + mt * 16 + g + half * 8;
        if (m >= M) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = n0 + warp_n * (BN / 2) + nt * 8 + tg * 2;
          if (n >= Co) continue;
          const __nv_bfloat162 p = __floats2bfloat162_rn(acc[mt][nt][half * 2],
                                                         acc[mt][nt][half * 2 + 1]);
          *reinterpret_cast<__nv_bfloat162*>(y + m * Co + n) = p;
          const float2 f = __bfloat1622float2(p);
          st1[nt][0] += f.x;
          st1[nt][1] += f.y;
          st2[nt][0] += f.x * f.x;
          st2[nt][1] += f.y * f.y;
        }
      }
  }

  // block-level sums in a fixed order: lanes sharing a column, then warps
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v1 = st1[nt][j], v2 = st2[nt][j];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        v1 += __shfl_xor_sync(0xffffffffu, v1, off);
        v2 += __shfl_xor_sync(0xffffffffu, v2, off);
      }
      if (g == 0) {
        const int col = warp_n * (BN / 2) + nt * 8 + tg * 2 + j;
        red1[warp_m * BN + col] = v1;
        red2[warp_m * BN + col] = v2;
      }
    }
  __syncthreads();
  for (int col = tid; col < BN; col += THREADS) {
    if (n0 + col < Co) {
      part1[(int64_t)blockIdx.x * Co + n0 + col] = red1[col] + red1[BN + col];
      part2[(int64_t)blockIdx.x * Co + n0 + col] = red2[col] + red2[BN + col];
    }
  }
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

template <int BN, bool AFFINE, int KIND>
int launch(const void* x, const void* wk, const void* inv, const void* shift,
           void* y, float* part1, float* part2, int64_t M, int Ci, int Co,
           int T, int H, int W, int tiles_m, int tiles_per_block,
           cudaStream_t stream) {
  const size_t smem = 2 * (BM + BN) * LDS * sizeof(bf16) +
                      4 * BN * sizeof(float) + 2 * Ci * sizeof(bf16);
  auto kern = conv_unit_kernel<BN, AFFINE, KIND>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((tiles_m + tiles_per_block - 1) / tiles_per_block,
            (Co + BN - 1) / BN);
  kern<<<grid, THREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)wk, (const float*)inv, (const float*)shift,
      (bf16*)y, part1, part2, M, Ci, Co, T, H, W, tiles_m, tiles_per_block);
  return (int)cudaGetLastError();
}

template <int BN>
int dispatch(int kind, int affine, const void* x, const void* wk,
             const void* inv, const void* shift, void* y, float* part1,
             float* part2, int64_t M, int Ci, int Co, int T, int H, int W,
             int tiles_m, int tpb, cudaStream_t s) {
  if (kind == 0)
    return affine ? launch<BN, true, 0>(x, wk, inv, shift, y, part1, part2, M,
                                        Ci, Co, T, H, W, tiles_m, tpb, s)
                  : launch<BN, false, 0>(x, wk, inv, shift, y, part1, part2, M,
                                         Ci, Co, T, H, W, tiles_m, tpb, s);
  return affine ? launch<BN, true, 1>(x, wk, inv, shift, y, part1, part2, M,
                                      Ci, Co, T, H, W, tiles_m, tpb, s)
                : launch<BN, false, 1>(x, wk, inv, shift, y, part1, part2, M,
                                       Ci, Co, T, H, W, tiles_m, tpb, s);
}

}  // namespace

// x [B, T, H, W, Ci] bf16; wk [Co, taps*Ci] bf16 with k = tap*Ci + ci
// (spatial tap = dh*3 + dw, temporal tap = dt); inv/shift [Ci] fp32 or null;
// y [B, T, H, W, Co] bf16; s1/s2 [Co] fp32; part: scratch of
// 2 * ceil(ceil(M/128) / tiles_per_block) * Co floats.
extern "C" int m3f_conv_unit_fwd(const void* x, const void* wk, const void* inv,
                                 const void* shift, void* y, void* s1, void* s2,
                                 void* part, int kind, int B, int T, int H,
                                 int W, int Ci, int Co, int bn,
                                 int tiles_per_block, void* stream) {
  const int64_t M = (int64_t)B * T * H * W;
  if (M == 0 || Co == 0) return 0;
  if ((kind != 0 && kind != 1) || Ci % 8 != 0 || Co % 8 != 0 ||
      tiles_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles_m = (int)((M + BM - 1) / BM);
  const int R = (tiles_m + tiles_per_block - 1) / tiles_per_block;
  float* part1 = (float*)part;
  float* part2 = part1 + (int64_t)R * Co;
  const int affine = inv != nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  int e;
  if (bn == 48)
    e = dispatch<48>(kind, affine, x, wk, inv, shift, y, part1, part2, M, Ci,
                     Co, T, H, W, tiles_m, tiles_per_block, s);
  else if (bn == 64)
    e = dispatch<64>(kind, affine, x, wk, inv, shift, y, part1, part2, M, Ci,
                     Co, T, H, W, tiles_m, tiles_per_block, s);
  else if (bn == 96)
    e = dispatch<96>(kind, affine, x, wk, inv, shift, y, part1, part2, M, Ci,
                     Co, T, H, W, tiles_m, tiles_per_block, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != 0) return e;
  colsum_kernel<<<(Co + 31) / 32, dim3(32, 32), 0, s>>>(
      part1, part2, R, Co, (float*)s1, (float*)s2);
  return (int)cudaGetLastError();
}
