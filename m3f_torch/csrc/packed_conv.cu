// Packed-layout (channels-major) 3x3 conv of the layout probe, and its two
// ablations: four kernels behind one entry point, m3f_packed_conv.
//
// Replaces: scripts/probe_packed_conv.py
//   mode 0/1  packed_conv          (:85, kernel _conv_kernel :53), bf16 / fp32 y
//   mode 2    ablate_slabs         (:139, _slab_only_kernel :113)
//   mode 3    ablate_matmul        (:157, _matmul_only_kernel :131)
//   mode 4    packed_conv_chunked  (:207, _conv_kernel_chunked :182)
//
// Layout: x_cm [BT, CIN, HWM] bf16, an image's positions p = y*W + x on the
// minor axis at offset MARGIN (margins and the HW..HWP tail read as given);
// w_cm [COUT, K] bf16, K = 9*CIN, k = tap*CIN + c, tap = (dy+1)*3 + (dx+1).
// Per image the im2col matrix P [K, HWP] has
//   P[tap*CIN + c, p] = x[c, MARGIN + p + dy*W + dx] * mask
// with mask = 0 where dx = -1 and p % W == 0 or dx = +1 and p % W == W-1
// (a bf16 multiply by 0, as the TPU kernel's, so -0 stays -0), else 1.
//   packed_conv          y[b] = W @ P[b], fp32 accumulation, bf16 or fp32 y
//   ablate_slabs         y[b] = P[b][:COUT]
//   ablate_matmul        y[b] = bf16(W @ p_const), recomputed for every b
//   packed_conv_chunked  packed_conv with bf16 y
// over all HWP columns (the tail is real output).
//
// Bound on an H100: at the probe's shape (BT 512, CIN 64, COUT 144, HWP
// 3200) the conv is 0.27 TFLOP of bf16 products against 0.70 GB of input
// and bf16 output (1.17 GB with fp32 y): operations with bf16 y (0.27 ms at
// 989 TFLOP/s), bytes with fp32 y (0.35 ms at 3.35 TB/s); the slab ablation
// is bytes alone (0.21 ms), the product ablation operations (0.27 ms).
//
// Design (simple, correct tensor-core kernels; wgmma / TMA come later):
// - One implicit GEMM Y[COUT, HWP] = W[COUT, K] * P[K, HWP] per image: a
//   block takes one image, all of BM = 144 output channels (more blocks
//   along y for a wider COUT) and BN = 128 positions, with 4 warps of 32
//   positions each, mma.sync m16n8k16 bf16 -> fp32. K runs in chunks of 32,
//   double-buffered in shared memory: W rows by cp.async, P rows built in
//   registers and stored, fed to the tensor cores by ldmatrix (W) and
//   ldmatrix.trans (P, stored [k][position] as it lies in x_cm).
// - packed_conv gathers each P row straight from x_cm in global memory (L2):
//   a tap's slab starts at an arbitrary element offset, so each thread reads
//   its 8 positions as scalars and applies the x-edge mask from p % W; no
//   im2col ever reaches device memory.
// - ablate_slabs runs the same gather and pipeline without the product: it
//   builds every row of the P tile in shared memory (the store's condition
//   is a runtime COUT, so no row can be dropped) and copies rows k < COUT
//   out. ablate_matmul runs the same pipeline with P rows copied (cp.async)
//   from the one resident p_const, for every image.
// - packed_conv_chunked: a block takes one image and one CHUNK of positions,
//   stages that chunk's halo window (CIN x (CHUNK + 2*(W+1)) positions,
//   widened to 16-byte loads; 96 KB at the probe's shape) in shared memory
//   once, and builds the nine taps of its BN-position tiles from there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 144;              // output channels per block
constexpr int MT = BM / 16;          // m16 tiles per block
constexpr int BN = 128;              // positions per tile
constexpr int BK = 32;               // K per chunk
constexpr int LDA = BK + 8;          // W tile row stride (bf16): 80 B
constexpr int LDB = BN + 8;          // P tile row stride (bf16): 272 B
constexpr int THREADS = 128;
constexpr int A_VECS = BM * BK / 8;  // 16-byte vectors per W chunk
constexpr int B_IT = BK * BN / 8 / THREADS;
constexpr int SMEM_MAX = 232448;

enum Mode { CONV_BF16 = 0, CONV_F32 = 1, SLABS = 2, MATMUL = 3, CHUNKED = 4 };

struct Args {
  const bf16* a;      // x_cm [BT, CIN, HWM], or p_const [K, HWP] (MATMUL)
  const bf16* w;      // [COUT, K]
  void* y;            // [BT, COUT, HWP]
  int CIN, COUT, W, HWP, HWM, MARGIN, K, CHUNK, LW;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// 16 bytes global -> shared without registers; zero-filled when !pred
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// bf16 x * 0 (signed zero, NaN for inf / NaN), the TPU kernel's mask
__device__ __forceinline__ unsigned short times_zero(unsigned short h) {
  return __bfloat16_as_ushort(
      __float2bfloat16(__bfloat162float(__ushort_as_bfloat16(h)) * 0.f));
}

// Eight P values of one row at positions p0..p0+7: src points at position
// p0 of the tap's slab; col0 = p0 % W; dx selects the x-edge mask.
template <bool GLOBAL>
__device__ __forceinline__ uint4 gather8(const bf16* src, int dx, int col0, int W) {
  union { uint4 v; unsigned short h[8]; } u;
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
  for (int e = 0; e < 8; ++e) u.h[e] = GLOBAL ? __ldg(s + e) : s[e];
  if (dx != 0) {
    const int edge = dx < 0 ? 0 : W - 1;
    int col = col0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (col == edge) u.h[e] = times_zero(u.h[e]);
      col = col + 1 == W ? 0 : col + 1;
    }
  }
  return u.v;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
packed_conv_kernel(const Args args) {
  constexpr bool PRODUCT = MODE != SLABS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);   // [2][BM][LDA]
  bf16* Bs = As + 2 * BM * LDA;                   // [2][BK][LDB]
  bf16* Win = Bs + 2 * BK * LDB;                  // CHUNKED: [CIN][LW]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int img = blockIdx.z, m0 = blockIdx.y * BM;
  const int CIN = args.CIN, COUT = args.COUT, W = args.W, HWP = args.HWP;
  const int HWM = args.HWM, K = args.K;
  const int nchunks = (K + BK - 1) / BK;
  const int span = MODE == CHUNKED ? args.CHUNK : BN;
  const int pos_begin = blockIdx.x * span;
  const bf16* x = args.a + (MODE == MATMUL ? 0 : (int64_t)img * CIN * HWM);

  // CHUNKED: the chunk's halo window, from 8-aligned position a0 of each row
  int a0 = 0;
  if (MODE == CHUNKED) {
    a0 = (args.MARGIN + pos_begin - (W + 1)) & ~7;
    const int vecs = args.LW / 8;
    for (int i = tid; i < CIN * vecs; i += THREADS) {
      const int c = i / vecs, j = i - c * vecs;
      const int q = a0 + 8 * j;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (q < HWM) v = __ldg(reinterpret_cast<const uint4*>(x + (int64_t)c * HWM + q));
      *reinterpret_cast<uint4*>(Win + c * args.LW + 8 * j) = v;
    }
    __syncthreads();
  }

  const int b_krow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int g = lane >> 2, tg = lane & 3;

  for (int n0 = pos_begin; n0 < pos_begin + span; n0 += BN) {
    float acc[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

    uint4 regB[B_IT];
    // W chunk -> shared (cp.async); MATMUL: p_const chunk -> shared (cp.async)
    auto issue = [&](int chunk, int buf) {
      if (PRODUCT) {
        bf16* a = As + buf * BM * LDA;
        for (int v = tid; v < A_VECS; v += THREADS) {
          const int row = v >> 2, k = chunk * BK + (v & 3) * 8;
          const bool ok = m0 + row < COUT && k < K;
          cp_async16(a + row * LDA + (v & 3) * 8,
                     ok ? args.w + (int64_t)(m0 + row) * K + k : args.w, ok);
        }
      }
      if (MODE == MATMUL) {
        bf16* b = Bs + buf * BK * LDB;
#pragma unroll
        for (int i = 0; i < B_IT; ++i) {
          const int v = i * THREADS + tid, r = v >> 4, c8 = v & 15;
          const int k = chunk * BK + r;
          cp_async16(b + r * LDB + c8 * 8,
                     k < K ? x + (int64_t)k * HWP + n0 + c8 * 8 : x, k < K);
        }
      }
    };
    // P chunk -> registers (the masked gather)
    auto gather = [&](int chunk) {
#pragma unroll
      for (int i = 0; i < B_IT; ++i) {
        const int v = i * THREADS + tid, r = v >> 4, c8 = v & 15;
        const int k = chunk * BK + r;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (k < K) {
          const int tap = k / CIN, c = k - tap * CIN;
          const int dx = tap % 3 - 1, s = (tap / 3 - 1) * W + dx;
          const int p0 = n0 + c8 * 8;
          if (MODE == CHUNKED)
            val = gather8<false>(Win + c * args.LW + (args.MARGIN + p0 + s - a0),
                                 dx, p0 % W, W);
          else
            val = gather8<true>(x + (int64_t)c * HWM + args.MARGIN + p0 + s, dx,
                                p0 % W, W);
        }
        regB[i] = val;
      }
    };
    auto store = [&](int buf) {
      bf16* b = Bs + buf * BK * LDB;
#pragma unroll
      for (int i = 0; i < B_IT; ++i) {
        const int v = i * THREADS + tid;
        *reinterpret_cast<uint4*>(b + (v >> 4) * LDB + (v & 15) * 8) = regB[i];
      }
    };

    issue(0, 0);
    if (MODE != MATMUL) {
      gather(0);
      store(0);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      const int buf = chunk & 1;
      const bool next = chunk + 1 < nchunks;
      if (next) {
        issue(chunk + 1, buf ^ 1);
        if (MODE != MATMUL) gather(chunk + 1);
      }
      const bf16* b = Bs + buf * BK * LDB;
      if (PRODUCT) {
        const bf16* a = As + buf * BM * LDA;
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
          uint32_t bfr[4][2];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            ldsm_x2_t(bfr[nt], b + (ks * 16 + b_krow) * LDB + warp * 32 + nt * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (m0 + mt * 16 >= COUT) break;
            uint32_t af[4];
            ldsm_x4(af, a + (mt * 16 + (lane & 15)) * LDA + ks * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af, bfr[nt]);
          }
        }
      } else {
        // SLABS: rows k < COUT of the built tile go out, 16 bytes a thread
        bf16* y = reinterpret_cast<bf16*>(args.y);
#pragma unroll
        for (int i = 0; i < B_IT; ++i) {
          const int v = i * THREADS + tid, r = v >> 4, c8 = v & 15;
          const int k = chunk * BK + r;
          if (k < COUT)
            *reinterpret_cast<uint4*>(y + ((int64_t)img * COUT + k) * HWP + n0 + c8 * 8) =
                *reinterpret_cast<const uint4*>(b + r * LDB + c8 * 8);
        }
      }
      if (next && MODE != MATMUL) store(buf ^ 1);
      cp_async_wait_all();
      __syncthreads();
    }

    if (PRODUCT) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (m0 + mt * 16 >= COUT) break;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m0 + mt * 16 + g + half * 8;
          if (m >= COUT) continue;
          const int64_t row = ((int64_t)img * COUT + m) * HWP;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int n = n0 + warp * 32 + nt * 8 + tg * 2;
            const float v0 = acc[mt][nt][half * 2], v1 = acc[mt][nt][half * 2 + 1];
            if (MODE == CONV_F32)
              *reinterpret_cast<float2*>(reinterpret_cast<float*>(args.y) + row + n) =
                  make_float2(v0, v1);
            else
              *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(args.y) + row + n) =
                  __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

template <int MODE>
int launch(const Args& a, int BT, cudaStream_t s) {
  const size_t tiles = 2 * BM * LDA * sizeof(bf16) + 2 * BK * LDB * sizeof(bf16);
  const size_t smem = tiles + (MODE == CHUNKED ? (size_t)a.CIN * a.LW * sizeof(bf16) : 0);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = packed_conv_kernel<MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(MODE == CHUNKED ? a.HWP / a.CHUNK : a.HWP / BN,
            MODE == SLABS ? 1 : (a.COUT + BM - 1) / BM, BT);
  kern<<<grid, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0 packed_conv (bf16 y), 1 packed_conv (fp32 y), 2 ablate_slabs,
// 3 ablate_matmul, 4 packed_conv_chunked. a: x_cm [BT, CIN, HWP + 2*MARGIN]
// bf16, or p_const [9*CIN, HWP] bf16 (mode 3); w: w_cm [COUT, 9*CIN] bf16
// (unread in mode 2); y: [BT, COUT, HWP], fp32 in mode 1, else bf16.
// Needs CIN and MARGIN multiples of 8, HWP a multiple of 128, W + 1 <=
// MARGIN; mode 2 COUT <= 9*CIN; mode 4 CHUNK a multiple of 128 dividing HWP.
extern "C" int m3f_packed_conv(const void* a, const void* w, void* y, int mode,
                               int BT, int CIN, int COUT, int W, int HWP,
                               int MARGIN, int CHUNK, void* stream) {
  Args args{};
  args.a = (const bf16*)a;
  args.w = (const bf16*)w;
  args.y = y;
  args.CIN = CIN;
  args.COUT = COUT;
  args.W = W;
  args.HWP = HWP;
  args.HWM = HWP + 2 * MARGIN;
  args.MARGIN = MARGIN;
  args.K = 9 * CIN;
  args.CHUNK = CHUNK;
  args.LW = (CHUNK + 2 * (W + 1) + 7 + 7) / 8 * 8;
  if (BT < 0 || BT > 65535 || CIN <= 0 || CIN % 8 || COUT <= 0 || W <= 0 ||
      HWP <= 0 || HWP % BN || MARGIN % 8 || W + 1 > MARGIN ||
      (mode == SLABS && COUT > args.K) ||
      (mode == CHUNKED && (CHUNK <= 0 || CHUNK % BN || HWP % CHUNK)))
    return (int)cudaErrorInvalidValue;
  if (BT == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case CONV_BF16: return launch<CONV_BF16>(args, BT, s);
    case CONV_F32: return launch<CONV_F32>(args, BT, s);
    case SLABS: return launch<SLABS>(args, BT, s);
    case MATMUL: return launch<MATMUL>(args, BT, s);
    case CHUNKED: return launch<CHUNKED>(args, BT, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
