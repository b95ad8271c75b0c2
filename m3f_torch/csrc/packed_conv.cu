// Packed-layout (channels-major) 3x3 conv of the layout probe and its two
// ablations, behind two entry points: m3f_packed_conv_tma (the conv, bf16 or
// fp32 y, whole or chunked) and m3f_packed_conv (the two ablations).
//
// Replaces: scripts/probe_packed_conv.py
//   packed_conv          (:85, kernel _conv_kernel :53), bf16 / fp32 y
//   packed_conv_chunked  (:207, _conv_kernel_chunked :182)
//   ablate_slabs         (:139, _slab_only_kernel :113), m3f_packed_conv mode 2
//   ablate_matmul        (:157, _matmul_only_kernel :131), m3f_packed_conv mode 3
//
// Layout: x_cm [BT, CIN, HWM] bf16, an image's positions p = y*W + x on the
// minor axis at offset MARGIN (margins and the HW..HWP tail read as given);
// w_cm [COUT, K] bf16, K = 9*CIN, k = tap*CIN + c, tap = (dy+1)*3 + (dx+1).
// Per image the im2col matrix P [K, HWP] has
//   P[tap*CIN + c, p] = x[c, MARGIN + p + dy*W + dx] * mask
// with mask = 0 where dx = -1 and p % W == 0 or dx = +1 and p % W == W-1
// (a bf16 multiply by 0, as the TPU kernel's, so -0 stays -0 and inf / NaN
// poison y), else 1.
//   packed_conv          y[b] = W @ P[b], fp32 accumulation, bf16 or fp32 y
//   packed_conv_chunked  packed_conv with bf16 y
//   ablate_slabs         y[b] = P[b][:COUT]
//   ablate_matmul        y[b] = bf16(W @ p_const), recomputed for every b
// over all HWP columns (the tail is real output).
//
// Bound on an H100 at the probe's shape (BT 512, CIN 64, COUT 144, HWP
// 3200): 271.8 GFLOP of bf16 products, 0.275 ms at 989 TFLOP/s, against
// 0.70 GB of x, W and bf16 y, 0.21 ms at 3.35 TB/s: operations-bound, but
// barely, so loads and stores must overlap the products (fp32 y: 1.17 GB,
// bytes-bound at 0.35 ms). The slab ablation is bytes alone (0.21 ms), the
// product ablation operations (0.27 ms).
//
// The conv (packed_tma_kernel), a warp-specialised persistent walk over the
// transposed product Y^T[positions, COUT] = P^T[positions, K] W^T[K, COUT],
// one tap (K = CIN, in boxes of 64 channels) at a time:
// - A producer warp has the copy engine (TMA) load, for each 64-position
//   tile and each dy, one window of x_cm: 88 positions x 64 channels from
//   the 8-aligned position at or before MARGIN + p0 + dy*W - 1. The copy
//   engine takes a box only at a 16-byte-aligned innermost coordinate (a
//   tap's slab at its own element offset is an illegal instruction on the
//   H100), so one aligned window serves the three dx taps of a dy, and x is
//   read three times from the L2, not nine. Channels are a dimension of the
//   tensor map, so a box past CIN reads zeros: K per tap is padded to 64
//   without reading the next tap.
// - One or two consumer warpgroups (64 positions each) run wgmma m64 x N,
//   positions as M, COUT as N (one pass of up to 192, more for a wider
//   COUT), with A from registers: each thread reads its m16n8k16 fragment of
//   tap (dy, dx) out of the window at the tap's offset (2-byte loads, the
//   rows 176 bytes apart, so no bank conflict), while the previous tap's
//   products run; the x-edge mask is a multiply by bf16 zero of the
//   fragment's masked positions (one or two of 64 at the probe's W). B is a
//   K-major, 128-byte-swizzled W tile; fp32 accumulators in registers.
// - W streams through the ring, the three dx taps' W tiles beside each
//   window, under two consumer warpgroups on 128 positions (the planner's
//   first layout) or one on 64 (a pass of N 192, which the ring of two
//   fits only at 64 positions). Persistent blocks take their units
//   round-robin: a tile, or for packed_conv_chunked a CHUNK of tiles in
//   order (the TPU kernel's grid step).
// - y leaves through a staging tile in shared memory, one TMA store a tile;
//   the store is waited for (bulk wait_group.read) only before the staging
//   tile is written again, so it overlaps the next tile's products.
// The tensor maps are encoded on the host per call and passed as
// __grid_constant__ parameters; ops/packed_conv.py packed_plan picks the
// layout (tile width, ring depth, N, grid).
//
// The ablations keep the first design: a block takes one image, all of BM =
// 144 output channels and BN = 128 positions, with 4 warps of 32 positions
// each, mma.sync m16n8k16, K in chunks of 32 double-buffered in shared
// memory: W / p_const rows by cp.async, P rows gathered from x_cm in
// global memory (scalar loads, the x-edge mask from p % W).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PK_ABLATE
#define PK_ABLATE 0  // timing builds of the conv: 1 no products, 2 no mask,
#endif               // 4 no y stores, 8 one x window for all three dy

namespace {

typedef __nv_bfloat16 bf16;

constexpr int SMEM_MAX = 232448;

// bf16 x * 0 (signed zero, NaN for inf / NaN), the TPU kernel's mask
__device__ __forceinline__ unsigned short times_zero(unsigned short h) {
  return __bfloat16_as_ushort(
      __float2bfloat16(__bfloat162float(__ushort_as_bfloat16(h)) * 0.f));
}

// ---------------------------------------------------------------------------
// The ablations (mode 2 ablate_slabs, mode 3 ablate_matmul)

constexpr int BM = 144;              // output channels per block
constexpr int MT = BM / 16;          // m16 tiles per block
constexpr int BN = 128;              // positions per tile
constexpr int BK = 32;               // K per chunk
constexpr int LDA = BK + 8;          // W tile row stride (bf16): 80 B
constexpr int LDB = BN + 8;          // P tile row stride (bf16): 272 B
constexpr int THREADS = 128;
constexpr int A_VECS = BM * BK / 8;  // 16-byte vectors per W chunk
constexpr int B_IT = BK * BN / 8 / THREADS;

enum Mode { SLABS = 2, MATMUL = 3 };

struct Args {
  const bf16* a;      // x_cm [BT, CIN, HWM] (SLABS), or p_const [K, HWP]
  const bf16* w;      // [COUT, K]
  bf16* y;            // [BT, COUT, HWP]
  int CIN, COUT, W, HWP, HWM, MARGIN, K;
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

// Eight P values of one row at positions p0..p0+7: src points at position
// p0 of the tap's slab; col0 = p0 % W; dx selects the x-edge mask.
__device__ __forceinline__ uint4 gather8(const bf16* src, int dx, int col0, int W) {
  union { uint4 v; unsigned short h[8]; } u;
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
  for (int e = 0; e < 8; ++e) u.h[e] = __ldg(s + e);
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
packed_ablation_kernel(const Args args) {
  constexpr bool PRODUCT = MODE == MATMUL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);   // [2][BM][LDA]
  bf16* Bs = As + 2 * BM * LDA;                   // [2][BK][LDB]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int img = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int CIN = args.CIN, COUT = args.COUT, W = args.W, HWP = args.HWP;
  const int HWM = args.HWM, K = args.K;
  const int nchunks = (K + BK - 1) / BK;
  const bf16* x = args.a + (PRODUCT ? 0 : (int64_t)img * CIN * HWM);
  const int b_krow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int g = lane >> 2, tg = lane & 3;

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  uint4 regB[B_IT];
  // MATMUL: the W chunk and the p_const chunk -> shared (cp.async)
  auto issue = [&](int chunk, int buf) {
    bf16* a = As + buf * BM * LDA;
    for (int v = tid; v < A_VECS; v += THREADS) {
      const int row = v >> 2, k = chunk * BK + (v & 3) * 8;
      const bool ok = m0 + row < COUT && k < K;
      cp_async16(a + row * LDA + (v & 3) * 8,
                 ok ? args.w + (int64_t)(m0 + row) * K + k : args.w, ok);
    }
    bf16* b = Bs + buf * BK * LDB;
#pragma unroll
    for (int i = 0; i < B_IT; ++i) {
      const int v = i * THREADS + tid, r = v >> 4, c8 = v & 15;
      const int k = chunk * BK + r;
      cp_async16(b + r * LDB + c8 * 8,
                 k < K ? x + (int64_t)k * HWP + n0 + c8 * 8 : x, k < K);
    }
  };
  // SLABS: the P chunk -> registers (the masked gather)
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
        val = gather8(x + (int64_t)c * HWM + args.MARGIN + p0 + s, dx, p0 % W, W);
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

  if (PRODUCT) {
    issue(0, 0);
  } else {
    gather(0);
    store(0);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    const int buf = chunk & 1;
    const bool next = chunk + 1 < nchunks;
    if (next) {
      if (PRODUCT) issue(chunk + 1, buf ^ 1);
      else gather(chunk + 1);
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
#pragma unroll
      for (int i = 0; i < B_IT; ++i) {
        const int v = i * THREADS + tid, r = v >> 4, c8 = v & 15;
        const int k = chunk * BK + r;
        if (k < COUT)
          *reinterpret_cast<uint4*>(args.y + ((int64_t)img * COUT + k) * HWP + n0 + c8 * 8) =
              *reinterpret_cast<const uint4*>(b + r * LDB + c8 * 8);
      }
    }
    if (next && !PRODUCT) store(buf ^ 1);
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
          *reinterpret_cast<__nv_bfloat162*>(args.y + row + n) =
              __floats2bfloat162_rn(acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
        }
      }
    }
  }
}

template <int MODE>
int launch_ablation(const Args& a, int BT, cudaStream_t s) {
  const size_t smem = 2 * BM * LDA * sizeof(bf16) + 2 * BK * LDB * sizeof(bf16);
  auto kern = packed_ablation_kernel<MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.HWP / BN, MODE == SLABS ? 1 : (a.COUT + BM - 1) / BM, BT);
  kern<<<grid, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The conv: the TMA-fed wgmma walk

constexpr int TILE_P = 64;       // positions of a consumer warpgroup's tile (M)
constexpr int WROW = 88;         // positions of an x window: 64 + up to 7 + 2 + 1
constexpr int ROW = 128;         // bytes of a 128-byte-swizzled W row (64 bf16)
constexpr int MAX_STAGES = 4;    // ring slots
constexpr int ENCODE_FAILED = 0x10000;   // + the CUresult of a refused map

struct Walk {
  int W, MARGIN, KC, NPASS, WGS, STAGES, out_f32;
  int tiles_per_unit, units_per_image, units;
  uint32_t off_y, off_x, off_bar, x_bytes, b_bytes, y_bytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 128-byte swizzle (the TMA's and wgmma's): the 16-byte chunk of a byte
// offset within a 1024-byte-aligned tile XOR its row within 8
__device__ __forceinline__ uint32_t swz(uint32_t o) { return o ^ ((o >> 3) & 0x70); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// A wait that outlasts 2^28 tries (seconds; a call takes milliseconds) is
// a fault of the walk: trap, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (++tries == (1u << 28)) __trap();
  } while (!done);
}

// The copy engine's tiled load of one box at element coordinates (c0, c1,
// c2). The innermost coordinate must fall on 16 bytes (8 bf16): a box at
// any other offset is an illegal instruction on the H100.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// four 8 x 8 bf16 blocks of mma fragments, each stored transposed: lane l
// gives the shared address of row l % 8 of block l / 8
__device__ __forceinline__ void stmatrix_trans(uint32_t addr, uint32_t r0, uint32_t r1,
                                               uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// one consumer warpgroup's barrier (ids 1, 2; 0 is __syncthreads); the
// form without .aligned, as lanes may arrive apart
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("barrier.sync %0, 128;\n" :: "r"(id) : "memory");
}

// wgmma descriptor of a K-major, 128-byte-swizzled B tile: rows of 64
// channels (128 B), 1024 bytes between groups of 8 rows
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// The .aligned wgmma instructions need the warp converged: the lanes leave
// a barrier's wait loop, or pass a one-lane branch, apart.
__device__ __forceinline__ void wgmma_fence() {
  __syncwarp();
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  __syncwarp();
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING) : "memory");
}

// keep the compiler off registers that an issued wgmma still reads or writes
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void pin(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i]) :: "memory");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], bf16 in, fp32 accumulators: A in
// registers (the m16n8k16 A fragment of each warp's 16 rows), B K-major and
// 128-byte swizzled in shared memory
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4],
                                      uint64_t db, int scale_d);

#define PK_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : PK_D8(0), PK_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : PK_D8(0), PK_D8(8), PK_D8(16), PK_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : PK_D8(0), PK_D8(8), PK_D8(16), PK_D8(24), PK_D8(32), PK_D8(40),
        PK_D8(48), PK_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<144>(float (&d)[72], const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71"
      "}, {%72, %73, %74, %75}, %76, p, 1, 1, 0;\n}\n"
      : PK_D8(0), PK_D8(8), PK_D8(16), PK_D8(24), PK_D8(32), PK_D8(40),
        PK_D8(48), PK_D8(56), PK_D8(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<192>(float (&d)[96], const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : PK_D8(0), PK_D8(8), PK_D8(16), PK_D8(24), PK_D8(32), PK_D8(40),
        PK_D8(48), PK_D8(56), PK_D8(64), PK_D8(72), PK_D8(80), PK_D8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef PK_D8

// bf16x2 v * f (the mask: f 1 keeps v, f 0 gives signed zeros and NaN for
// inf / NaN, as the TPU kernel's multiply)
__device__ __forceinline__ uint32_t times2(uint32_t v, uint32_t f) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  h = __hmul2_rn(h, *reinterpret_cast<__nv_bfloat162*>(&f));
  return *reinterpret_cast<uint32_t*>(&h);
}

constexpr uint32_t BF16X2_ONE = 0x3F803F80u, BF16X2_ZERO = 0u;

// Window start (8-aligned) of the x rows of (tile at p0, dy): it holds
// positions MARGIN + p0 + dy*W - 1 .. + 64 for the three dx taps.
__device__ __forceinline__ int window_start(const Walk& k, int p0, int dy) {
  return (k.MARGIN + p0 + dy * k.W - 1) & ~7;
}

// The A fragments of a tap for the warp's 16 of the tile's 64 positions,
// four k-steps of 16 channels, from the window `win` [64][WROW] at the
// tap's offset `off`; with MASK, each position's values are multiplied by
// its factor (bf16x2 1, or 0 at the x edge: x * 1 is x, x * 0 the mask),
// so no branch defines a register that wgmma reads.
template <bool MASK>
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const unsigned short* win,
                                       int off, int m0, int t4, uint32_t f0, uint32_t f1) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned short* r = win + (16 * j + 2 * t4) * WROW + off + m0;
    a[j][0] = r[0] | (uint32_t)r[WROW] << 16;
    a[j][1] = r[8] | (uint32_t)r[WROW + 8] << 16;
    a[j][2] = r[8 * WROW] | (uint32_t)r[9 * WROW] << 16;
    a[j][3] = r[8 * WROW + 8] | (uint32_t)r[9 * WROW + 8] << 16;
    if (MASK) {
      a[j][0] = times2(a[j][0], f0);
      a[j][1] = times2(a[j][1], f1);
      a[j][2] = times2(a[j][2], f0);
      a[j][3] = times2(a[j][3], f1);
    }
  }
}

// The walk (see the note at the top). Threads: WGS consumer warpgroups,
// then the producer: one warp beside one consumer warpgroup (160 threads:
// 255 registers a thread); beside two, a whole warpgroup that hands its
// registers to the consumers (setmaxnreg: 40 for it, 232 for them).
// Shared memory from a 1024-aligned base: the B ring [stage][dx], the y
// staging tiles [WGS], the x window ring [stage][WGS], the barriers
// full[STAGES], empty[STAGES]. A ring slot holds one (dy, channel box) of a
// tile: the window of each warpgroup and the three dx taps' W tiles.
template <int N, int WGS>
__global__ void __launch_bounds__(WGS == 1 ? 160 : 384, 1)
packed_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap ymap, const Walk k) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const uint32_t full = base + k.off_bar, empty = full + 8 * k.STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int NS = 3 * k.KC;       // ring slots a pass: (channel box, dy)

  if (tid == 0) {
    for (int s = 0; s < k.STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * WGS);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WGS) {
    // the producer: one thread keeps the ring full
    if (WGS > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != WGS * 128) return;
    int s = 0;
    uint32_t ph = 0;
    for (int u = blockIdx.x; u < k.units; u += gridDim.x) {
      const int b = u / k.units_per_image;
      const int t0 = (u - b * k.units_per_image) * k.tiles_per_unit;
      for (int t = 0; t < k.tiles_per_unit; ++t) {
        const int p0 = (t0 + t) * WGS * TILE_P;
        for (int pass = 0; pass < k.NPASS; ++pass)
          for (int st = 0; st < NS; ++st) {
            const int kc = st / 3, dy = st % 3 - 1;
            const bool load_x = !(PK_ABLATE & 8) || st == 0;
            mbar_wait(empty + 8 * s, ph ^ 1);
            mbar_expect_tx(full + 8 * s, (load_x ? WGS * k.x_bytes : 0) + 3 * k.b_bytes);
            if (load_x)
              for (int g = 0; g < WGS; ++g)
                tma_load(base + k.off_x + (s * WGS + g) * k.x_bytes, &xmap,
                         full + 8 * s, window_start(k, p0 + g * TILE_P, dy), kc * 64, b);
            for (int dx = 0; dx < 3; ++dx)
              tma_load(base + (s * 3 + dx) * k.b_bytes, &wmap, full + 8 * s,
                       kc * 64, (dy + 1) * 3 + dx, pass * N);
            if (++s == k.STAGES) {
              s = 0;
              ph ^= 1;
            }
          }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 positions of every tile of the block's units
  if (WGS > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const int m0 = 16 * warp + (lane >> 2), t4 = lane & 3;
  const int bar_id = 1 + wg;
  const uint32_t y_s = base + k.off_y + wg * k.y_bytes;
  unsigned char* const ys = sm + k.off_y + wg * k.y_bytes;
  float acc[N / 2];
  uint32_t a[2][4][4];   // the A fragments of taps q (q even, q odd)
  int s = 0;
  uint32_t ph = 0;
  for (int u = blockIdx.x; u < k.units; u += gridDim.x) {
    const int b = u / k.units_per_image;
    const int t0 = (u - b * k.units_per_image) * k.tiles_per_unit;
    for (int t = 0; t < k.tiles_per_unit; ++t) {
      const int p0 = ((t0 + t) * WGS + wg) * TILE_P;
      // the x-edge mask factors of the thread's two positions, dx = -1, +1
      const int col0 = (p0 + m0) % k.W, col1 = (p0 + m0 + 8) % k.W;
      const uint32_t fl0 = col0 == 0 ? BF16X2_ZERO : BF16X2_ONE;
      const uint32_t fl1 = col1 == 0 ? BF16X2_ZERO : BF16X2_ONE;
      const uint32_t fr0 = col0 == k.W - 1 ? BF16X2_ZERO : BF16X2_ONE;
      const uint32_t fr1 = col1 == k.W - 1 ? BF16X2_ZERO : BF16X2_ONE;
      for (int pass = 0; pass < k.NPASS; ++pass) {
        if (PK_ABLATE & 1) {
#pragma unroll
          for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
        }
        for (int kc = 0; kc < k.KC; ++kc) {
          // taps q = 0..8 of the channel box: slot dy = q / 3 - 1, dx = q % 3 - 1
          int cur = 0, prev = 0;
          auto acquire = [&]() {
            mbar_wait(full + 8 * s, ph);
            cur = s;
            if (++s == k.STAGES) {
              s = 0;
              ph ^= 1;
            }
          };
          auto fetch = [&](uint32_t (&f)[4][4], int q) {
            const int dy = q / 3 - 1, dx = q % 3 - 1;
            const unsigned short* win = reinterpret_cast<const unsigned short*>(
                sm + k.off_x + (cur * WGS + wg) * k.x_bytes);
            const int off = k.MARGIN + p0 + dy * k.W + dx - window_start(k, p0, dy);
            if ((PK_ABLATE & 2) || dx == 0)
              load_a<false>(f, win, off, m0, t4, 0, 0);
            else if (dx < 0)
              load_a<true>(f, win, off, m0, t4, fl0, fl1);
            else
              load_a<true>(f, win, off, m0, t4, fr0, fr1);
          };
          acquire();
          fetch(a[0], 0);
#pragma unroll
          for (int q = 0; q < 9; ++q) {
            // the products of tap q, then tap q + 1's fragments fetched
            // while they run
            if (!(PK_ABLATE & 1)) {
              const uint32_t b_s = base + (cur * 3 + q % 3) * k.b_bytes;
              pin(acc);
              wgmma_fence();
#pragma unroll
              for (int j = 0; j < 4; ++j)
                wgmma<N>(acc, a[q & 1][j], desc_b(b_s + j * 32), (kc | q | j) != 0);
              wgmma_commit();
              wgmma_wait<1>();
              pin(acc);
              pin(a[0]);
              pin(a[1]);
            }
            // tap q - 1 is done: its slot is free when it was the slot's last
            if (q == 3 || q == 6) {
              __syncwarp();
              if (lane == 0) mbar_arrive(empty + 8 * prev);
            }
            if (q < 8) {
              if (q == 2 || q == 5) {
                prev = cur;
                acquire();
              }
              fetch(a[(q + 1) & 1], q + 1);
            }
          }
          wgmma_wait<0>();
          pin(acc);
          if (lane == 0) mbar_arrive(empty + 8 * cur);
        }
        if (PK_ABLATE & 4) {
          // no y stores: a sum the compiler cannot drop keeps the products
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < N / 2; ++i) sum += acc[i];
          if (k.W < 0) reinterpret_cast<float*>(ys)[wtid] = sum;
          continue;
        }
        // epilogue: the accumulators -> the staging tile [N][64] -> y
        if (wtid == 0)
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        warpgroup_sync(bar_id);
        if (k.out_f32) {
          float* y = reinterpret_cast<float*>(ys);
#pragma unroll
          for (int i = 0; i < N / 8; ++i) {
            const int n = 8 * i + 2 * t4;
            y[n * TILE_P + m0] = acc[4 * i];
            y[(n + 1) * TILE_P + m0] = acc[4 * i + 1];
            y[n * TILE_P + m0 + 8] = acc[4 * i + 2];
            y[(n + 1) * TILE_P + m0 + 8] = acc[4 * i + 3];
          }
        } else {
          // bf16: stmatrix.trans writes each 8 x 8 block of the fragment as
          // 8 channel rows of 8 positions (16 bytes, swizzled); lane l
          // addresses row l % 8 of block l / 8 (channel chunks i, i + 1 x
          // the warp's two 8-position halves)
          __syncwarp();
          const int blk = lane >> 3, row = lane & 7;
#pragma unroll
          for (int i = 0; i < N / 8; i += 2) {
            const int n = 8 * (i + (blk >> 1)) + row, pos = 16 * warp + 8 * (blk & 1);
            stmatrix_trans(y_s + swz(n * ROW + pos * 2), pack_bf16(acc[4 * i], acc[4 * i + 1]),
                           pack_bf16(acc[4 * i + 2], acc[4 * i + 3]),
                           pack_bf16(acc[4 * i + 4], acc[4 * i + 5]),
                           pack_bf16(acc[4 * i + 6], acc[4 * i + 7]));
          }
        }
        fence_proxy_async();
        warpgroup_sync(bar_id);
        if (wtid == 0) tma_store(&ymap, y_s, p0, pass * N, b);
      }
    }
  }
  if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int N>
int launch_tma(const CUtensorMap& xm, const CUtensorMap& wm, const CUtensorMap& ym,
               const Walk& k, int grid, int smem, cudaStream_t s) {
  auto kern = k.WGS == 1 ? packed_tma_kernel<N, 1> : packed_tma_kernel<N, 2>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, k.WGS == 1 ? 160 : 384, smem, s>>>(xm, wm, ym, k);
  return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, found through the runtime (no
// link against libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3D tiled map (dims innermost first, strides of dims 1 and 2 in bytes);
// 0, or ENCODE_FAILED + the CUDA driver's CUresult
int encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
           const cuuint64_t (&dims)[3], const cuuint64_t (&strides)[2],
           const cuuint32_t (&box)[3], CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return ENCODE_FAILED + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

}  // namespace

// The ablations: mode 2 ablate_slabs, 3 ablate_matmul. a: x_cm [BT, CIN,
// HWP + 2*MARGIN] bf16 (mode 2) or p_const [9*CIN, HWP] bf16 (mode 3); w:
// w_cm [COUT, 9*CIN] bf16 (unread in mode 2); y: [BT, COUT, HWP] bf16.
// Needs CIN and MARGIN multiples of 8, HWP a multiple of 128, W + 1 <=
// MARGIN; mode 2 COUT <= 9*CIN.
extern "C" int m3f_packed_conv(const void* a, const void* w, void* y, int mode,
                               int BT, int CIN, int COUT, int W, int HWP,
                               int MARGIN, void* stream) {
  Args args{};
  args.a = (const bf16*)a;
  args.w = (const bf16*)w;
  args.y = (bf16*)y;
  args.CIN = CIN;
  args.COUT = COUT;
  args.W = W;
  args.HWP = HWP;
  args.HWM = HWP + 2 * MARGIN;
  args.MARGIN = MARGIN;
  args.K = 9 * CIN;
  if (BT < 0 || BT > 65535 || CIN <= 0 || CIN % 8 || COUT <= 0 || W <= 0 ||
      HWP <= 0 || HWP % BN || MARGIN % 8 || W + 1 > MARGIN ||
      (mode == SLABS && COUT > args.K))
    return (int)cudaErrorInvalidValue;
  if (BT == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case SLABS: return launch_ablation<SLABS>(args, BT, s);
    case MATMUL: return launch_ablation<MATMUL>(args, BT, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The conv. x: x_cm [BT, CIN, HWP + 2*MARGIN] bf16; w: w_cm [COUT, 9*CIN]
// bf16; y: [BT, COUT, HWP], fp32 if out_f32 else bf16. chunk: 0 for
// packed_conv (a unit is one tile), else packed_conv_chunked's CHUNK (a
// unit is CHUNK positions of one image, its tiles in order). The layout is
// packed_plan's: bn positions a tile (64 or 128, a consumer warpgroup per
// 64), stages ring slots, np the wgmma N of a pass (COUT in ceil(COUT /
// np) passes), grid persistent blocks. Needs
// CIN and MARGIN multiples of 8 (16-byte strides and window starts), W + 1
// <= MARGIN, whole tiles and chunks. Returns 0, a cudaError_t, or
// ENCODE_FAILED + the CUresult of a tensor map the CUDA driver refused (a
// base address not 16-byte aligned, say).
extern "C" int m3f_packed_conv_tma(const void* x, const void* w, void* y, int out_f32,
                                   int BT, int CIN, int COUT, int W, int HWP,
                                   int MARGIN, int chunk, int bn, int stages, int np,
                                   int grid, void* stream) {
  if (BT < 0 || CIN <= 0 || CIN % 8 || COUT <= 0 || W <= 0 || W + 1 > MARGIN ||
      MARGIN % 8 || (bn != 64 && bn != 128) || HWP <= 0 || HWP % bn || chunk < 0 ||
      (chunk && (chunk % bn || HWP % chunk)) || stages < 2 || stages > MAX_STAGES ||
      grid < 1 || np <= 0)
    return (int)cudaErrorInvalidValue;
  Walk k{};
  k.W = W;
  k.MARGIN = MARGIN;
  k.KC = (CIN + 63) / 64;
  k.NPASS = (COUT + np - 1) / np;
  k.WGS = bn / TILE_P;
  k.STAGES = stages;
  k.out_f32 = out_f32 != 0;
  k.tiles_per_unit = chunk ? chunk / bn : 1;
  k.units_per_image = HWP / (k.tiles_per_unit * bn);
  const int64_t units = (int64_t)BT * k.units_per_image;
  if (units > (1 << 30)) return (int)cudaErrorInvalidValue;
  k.units = (int)units;
  k.x_bytes = 64 * WROW * 2;
  k.b_bytes = np * ROW;
  k.y_bytes = np * TILE_P * (out_f32 ? 4 : 2);
  k.off_y = stages * 3 * k.b_bytes;
  k.off_x = k.off_y + k.WGS * k.y_bytes;
  k.off_bar = k.off_x + stages * k.WGS * k.x_bytes;
  const int64_t smem = (int64_t)k.off_bar + 2 * stages * 8 + 1024;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (BT == 0) return 0;

  const int HWM = HWP + 2 * MARGIN, ysize = out_f32 ? 4 : 2;
  CUtensorMap xm, wm, ym;
  const cuuint64_t xdims[3] = {(cuuint64_t)HWM, (cuuint64_t)CIN, (cuuint64_t)BT};
  const cuuint64_t xstrides[2] = {(cuuint64_t)HWM * 2, (cuuint64_t)CIN * HWM * 2};
  const cuuint32_t xbox[3] = {WROW, 64, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)CIN, 9, (cuuint64_t)COUT};
  const cuuint64_t wstrides[2] = {(cuuint64_t)CIN * 2, (cuuint64_t)9 * CIN * 2};
  const cuuint32_t wbox[3] = {64, 1, (cuuint32_t)np};
  const cuuint64_t ydims[3] = {(cuuint64_t)HWP, (cuuint64_t)COUT, (cuuint64_t)BT};
  const cuuint64_t ystrides[2] = {(cuuint64_t)HWP * ysize,
                                  (cuuint64_t)COUT * HWP * ysize};
  const cuuint32_t ybox[3] = {TILE_P, (cuuint32_t)np, 1};
  int err = encode(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, xdims, xstrides, xbox,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!err)
    err = encode(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, wdims, wstrides, wbox,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = encode(&ym, out_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                 y, ydims, ystrides, ybox,
                 out_f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int sm = (int)smem;
  switch (np) {
    case 32: return launch_tma<32>(xm, wm, ym, k, grid, sm, s);
    case 64: return launch_tma<64>(xm, wm, ym, k, grid, sm, s);
    case 128: return launch_tma<128>(xm, wm, ym, k, grid, sm, s);
    case 144: return launch_tma<144>(xm, wm, ym, k, grid, sm, s);
    case 192: return launch_tma<192>(xm, wm, ym, k, grid, sm, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
