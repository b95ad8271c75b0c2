// Packed-layout (channels-major) 3x3 conv of the layout probe and its two
// ablations, behind two entry points: m3f_packed_conv_tma (the conv, bf16 or
// fp32 y, whole or chunked) and m3f_packed_ablate (the two ablations).
//
// Replaces: scripts/probe_packed_conv.py
//   packed_conv          (:85, kernel _conv_kernel :53), bf16 / fp32 y
//   packed_conv_chunked  (:207, _conv_kernel_chunked :182)
//   ablate_slabs         (:139, _slab_only_kernel :113), m3f_packed_ablate mode 2
//   ablate_matmul        (:157, _matmul_only_kernel :131), m3f_packed_ablate mode 3
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
// The ablations are persistent walks on the same machinery (tensor maps,
// an mbarrier ring fed by a producer warp, TMA stores of staged tiles);
// ops/packed_conv.py ablation_plan picks their layouts:
// - ablate_matmul (ablate_matmul_kernel), operations-bound: the GEMM
//   Y^T = P^T W^T of every image, P^T a 64-k box of p_const loaded by the
//   copy engine at a 64-aligned position (an MN-major, 128-byte-swizzled
//   wgmma A operand: the transpose bit), kept resident across the block's
//   range of images (the TPU kernel keeps p_const and W resident); W
//   streams through the ring in 64-k boxes, each read by two consumer
//   warpgroups that split the images of a 64-position tile (one or two
//   each: ptxas holds such a block to 168 registers a thread). The L2
//   reads of W (166 KB per 128 or 256 position-images) bound it near the
//   products' time.
// - ablate_slabs (ablate_slabs_kernel), bytes-bound (x read once, y written
//   once): for each (image, 128-position tile), channel box and dy one
//   8-aligned x window by TMA; 256 threads form every row of the tile's P
//   (the three dx taps of the window) in shared memory with 16-byte loads
//   and stores, the dx shift a funnel of aligned words (__byte_perm), the
//   x-edge mask a bf16x2 multiply by 0 merged in by bit mask; the rows
//   below COUT leave by TMA stores of the staging tile, the rest are formed
//   in a scratch tile and not stored.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PK_ABLATE
#define PK_ABLATE 0  // timing builds of the conv: 1 no products, 2 no mask,
#endif               // 4 no y stores, 8 one x window for all three dy
#ifndef PA_ABLATE
#define PA_ABLATE 0  // timing builds of the ablations: 1 no products (row
#endif               // 11), 2 no mask, 4 no y stores, 8 rows >= COUT not
                     // formed (row 10)

namespace {

typedef __nv_bfloat16 bf16;

constexpr int SMEM_MAX = 232448;

enum Mode { SLABS = 2, MATMUL = 3 };

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

// A consumer warpgroup's 64 x N fp32 accumulators -> its bf16 staging tile
// [N][64] (128-byte swizzled, the y map's box): stmatrix.trans writes each
// 8 x 8 block of the fragment as 8 channel rows of 8 positions (16 bytes);
// lane l addresses row l % 8 of block l / 8 (channel chunks i, i + 1 x the
// warp's two 8-position halves)
template <int N>
__device__ __forceinline__ void stage_bf16(const float (&acc)[N / 2], uint32_t y_s,
                                           int warp, int lane) {
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
          stage_bf16<N>(acc, y_s, warp, lane);
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

// ---------------------------------------------------------------------------
// The ablations (rows 10 and 11): persistent blocks over contiguous ranges
// of work items, ablation_plan's layout

struct Abl {
  int BT, COUT, W, MARGIN;
  int KB;             // row 11: 64-k boxes of K; row 10: channel boxes of a tap
  int BC;             // row 10: channels of a box
  int NPASS, STAGES;
  int tiles;          // position tiles an image
  int groups;         // row 11: image groups a tile
  int items, per;     // work items; items a block
  uint32_t off_w, off_y, off_s, off_x, off_bar, stage_bytes, y_bytes;
};

// ---------------------------------------------------------------------------
// Row 10, ablate_slabs: the masked im2col formed in shared memory

constexpr int SLAB_BN = 128;      // positions of a tile
constexpr int SLAB_ROW = 144;     // positions of a dy's x window: 128 + up to 7
                                  // + 2, and the funnel's word past them, on 8
constexpr int SLAB_FORMERS = 256; // forming threads: 16 a P row (a 16-byte word
                                  // each), 16 rows at a time
constexpr int ABL_MAX_STAGES = 8;   // ring slots of both ablations

// bf16x2 v * 0 in the halves m selects, v elsewhere: the TPU kernel's
// multiply by its 0 / 1 mask (v * 1 is v bit for bit; v * 0 a signed zero,
// NaN for inf / NaN)
__device__ __forceinline__ uint32_t mask2(uint32_t v, uint32_t m) {
  return (v & ~m) | (times2(v, BF16X2_ZERO) & m);
}

// The 16 bytes at halfword SH of the words w (a window row from the
// thread's word on): a funnel shift of aligned words, no 2-byte loads
template <int SH>
__device__ __forceinline__ uint4 funnel(const uint32_t (&w)[9]) {
  constexpr int q = SH >> 1;
  if constexpr (SH & 1)
    return make_uint4(__byte_perm(w[q], w[q + 1], 0x5432),
                      __byte_perm(w[q + 1], w[q + 2], 0x5432),
                      __byte_perm(w[q + 2], w[q + 3], 0x5432),
                      __byte_perm(w[q + 3], w[q + 4], 0x5432));
  else
    return make_uint4(w[q], w[q + 1], w[q + 2], w[q + 3]);
}

// One (channel box, dy) of a tile: rows c = r0, r0 + 16, ... of the window
// `win` [channels][row_bytes / 2] give the thread's 16-byte word i of the
// three dx taps' P rows k = tap * CIN + c0 + c; each is stored to the
// staging tile (k < COUT) or the scratch tile (the rest, formed and not
// stored). `win` points B0 + 1 positions before the dx = 0 tap, so taps
// dx = -1, 0, +1 begin at halfwords B0, B0 + 1, B0 + 2 of the row.
template <int B0>
__device__ __forceinline__ void form_dy(const unsigned char* win, int row_bytes, int rows,
                                        int i, int r0, int tap0, int CIN, int c0, int COUT,
                                        unsigned char* ys, unsigned char* scratch,
                                        const uint32_t (&lm)[4], const uint32_t (&rm)[4]) {
  for (int c = r0; c < rows; c += SLAB_FORMERS / 16) {
    const uint4* src = reinterpret_cast<const uint4*>(win + c * row_bytes) + i;
    const uint4 a = src[0], b = src[1];
    uint32_t w[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, 0};
    if (B0 == 7) w[8] = *reinterpret_cast<const uint32_t*>(src + 2);
    uint4 t[3] = {funnel<B0>(w), funnel<B0 + 1>(w), funnel<B0 + 2>(w)};
    if (!(PA_ABLATE & 2)) {
      t[0] = make_uint4(mask2(t[0].x, lm[0]), mask2(t[0].y, lm[1]), mask2(t[0].z, lm[2]),
                        mask2(t[0].w, lm[3]));
      t[2] = make_uint4(mask2(t[2].x, rm[0]), mask2(t[2].y, rm[1]), mask2(t[2].z, rm[2]),
                        mask2(t[2].w, rm[3]));
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int k = (tap0 + d) * CIN + c0 + c;
      if ((PA_ABLATE & 8) && k >= COUT) continue;
      unsigned char* row = k < COUT ? ys + k * SLAB_BN * 2 : scratch + (k & 63) * SLAB_BN * 2;
      reinterpret_cast<uint4*>(row)[i] = t[d];
    }
  }
}

// The walk. Threads: SLAB_FORMERS forming threads, then one producer warp.
// A block owns a contiguous range of (image, 128-position tile) items,
// image-major. The producer has the copy engine load, for each item and
// channel box, one x window of WROW positions and BC channels (zeros past
// CIN) from the 8-aligned position at or before MARGIN + p0 - W - 1, which
// holds all three dy (WINDOWS 1, where 2W + 138 positions fit a box of 256)
// or, else, one SLAB_ROW window per dy (+1, 0, -1) from the 8-aligned
// position at or before MARGIN + p0 + dy*W - 1 (WINDOWS 3). The formers
// build every row of the item's P tile from it and release the slot; the
// staging tile's rows (< COUT) leave by TMA stores, issued once the tile is
// formed and waited for (bulk read) only before the next tile first writes
// a staging row: dy = +1 and 0 come first, and at CIN >= COUT / 6 their
// rows all go to the scratch tile. Shared memory from a 1024-aligned base:
// the staging tile [ny * YR][128], the scratch tile [64][128], the window
// ring [STAGES][BC][WROW], the barriers full[STAGES], empty[STAGES].
__global__ void __launch_bounds__(SLAB_FORMERS + 32, 1)
ablate_slabs_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap ymap, const Abl k, int CIN,
                    int ny, int yr, int windows, int wrow) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const uint32_t full = base + k.off_bar, empty = full + 8 * k.STAGES;
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * k.per, i1 = min(i0 + k.per, k.items);
  // the window of (tile at p0, dy): its first position
  auto start = [&](int p0, int dy) {
    return (k.MARGIN + p0 + (windows == 1 ? -1 : dy) * k.W - 1) & ~7;
  };

  if (tid == 0) {
    for (int s = 0; s < k.STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, SLAB_FORMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= SLAB_FORMERS) {
    // the producer: one thread keeps the ring full
    if (tid != SLAB_FORMERS) return;
    int s = 0;
    uint32_t ph = 0;
    for (int it = i0; it < i1; ++it) {
      const int b = it / k.tiles, p0 = (it - b * k.tiles) * SLAB_BN;
      for (int kc = 0; kc < k.KB; ++kc)
        for (int w = 0; w < windows; ++w) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full + 8 * s, k.stage_bytes);
          tma_load(base + k.off_x + s * k.stage_bytes, &xmap, full + 8 * s,
                   start(p0, 1 - w), kc * k.BC, b);
          if (++s == k.STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
    }
    return;
  }

  const int i = tid & 15, r0 = tid >> 4, lane = tid & 31;
  unsigned char* const ys = sm + k.off_y;
  unsigned char* const scratch = sm + k.off_s;
  int s = 0;
  uint32_t ph = 0;
  for (int it = i0; it < i1; ++it) {
    const int b = it / k.tiles, p0 = (it - b * k.tiles) * SLAB_BN;
    // the x-edge masks of the thread's 8 positions: dx = -1 zeroes column
    // 0, dx = +1 column W - 1 (bf16 halves of 4 words)
    uint32_t lm[4], rm[4];
    const int col0 = (p0 + 8 * i) % k.W;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ca = (col0 + 2 * j) % k.W, cb = (col0 + 2 * j + 1) % k.W;
      lm[j] = (ca == 0 ? 0xFFFFu : 0u) | (cb == 0 ? 0xFFFF0000u : 0u);
      rm[j] = (ca == k.W - 1 ? 0xFFFFu : 0u) | (cb == k.W - 1 ? 0xFFFF0000u : 0u);
    }
    bool staging_free = false;
    for (int kc = 0; kc < k.KB; ++kc) {
      const int c0 = kc * k.BC, rows = min(k.BC, CIN - c0);
      for (int dy = 1; dy >= -1; --dy) {
        const int tap0 = (dy + 1) * 3;
        if (!staging_free && tap0 * CIN + c0 < k.COUT) {
          // the last tile's stores must have read the staging tile
          if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          asm volatile("barrier.sync 1, %0;\n" :: "n"(SLAB_FORMERS) : "memory");
          staging_free = true;
        }
        if (windows == 3 || dy == 1) mbar_wait(full + 8 * s, ph);
        // the dx = -1 tap's first position, from the window's start
        const int off = k.MARGIN + p0 + dy * k.W - 1 - start(p0, dy);
        const unsigned char* win = sm + k.off_x + s * k.stage_bytes + (off >> 3) * 16;
        switch (off & 7) {
#define PA_FORM(B) case B: form_dy<B>(win, wrow * 2, rows, i, r0, tap0, CIN, c0, k.COUT, \
                                      ys, scratch, lm, rm); break;
          PA_FORM(0) PA_FORM(1) PA_FORM(2) PA_FORM(3)
          PA_FORM(4) PA_FORM(5) PA_FORM(6) PA_FORM(7)
#undef PA_FORM
        }
        if (windows == 3 || dy == -1) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * s);
          if (++s == k.STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    // the staging tile -> y rows < COUT, one TMA store a box of yr rows
    fence_proxy_async();
    asm volatile("barrier.sync 1, %0;\n" :: "n"(SLAB_FORMERS) : "memory");
    if (tid == 0 && !(PA_ABLATE & 4))
      for (int j = 0; j < ny; ++j)
        tma_store(&ymap, base + k.off_y + j * yr * SLAB_BN * 2, p0, j * yr, b);
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Row 11, ablate_matmul: a TMA-fed wgmma GEMM on a resident P^T tile

constexpr uint32_t P_BOX = 64 * 64 * 2;   // a P^T box: 64 k rows of 64 positions
constexpr int MATMUL_WGS = 2;             // consumer warpgroups
// images x N fp32 accumulators a consumer thread holds at most: ptxas keeps
// a block of two consumer warpgroups and a producer warp to 168 registers a
// thread (three warps on one of the SM's four register files of 16,384),
// setmaxnreg or not, and two images of N 144 spilled there
constexpr int ACC_MAX = 256;

// wgmma descriptor of an MN-major, 128-byte-swizzled A tile (the TMA's P^T
// box: a 128-byte row of 64 positions per k): groups of 8 k rows 1024 bytes
// apart. The tile's 64 positions are one swizzle atom along M, so the atom
// stride is never read; both offset fields carry 1024.
__device__ __forceinline__ uint64_t desc_a_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], both from shared memory: A MN-major
// (the transpose bit set), B K-major, both 128-byte swizzled
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d);

#define PK_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : PK_D8(0), PK_D8(8)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : PK_D8(0), PK_D8(8), PK_D8(16), PK_D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      : PK_D8(0), PK_D8(8), PK_D8(16), PK_D8(24), PK_D8(32), PK_D8(40), PK_D8(48), PK_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<144>(float (&d)[72], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1, 1, 0;\n}\n"
      : PK_D8(0), PK_D8(8), PK_D8(16), PK_D8(24), PK_D8(32), PK_D8(40), PK_D8(48), PK_D8(56), PK_D8(64)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<192>(float (&d)[96], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95"
      "}, %96, %97, p, 1, 1, 1, 0;\n}\n"
      : PK_D8(0), PK_D8(8), PK_D8(16), PK_D8(24), PK_D8(32), PK_D8(40), PK_D8(48), PK_D8(56), PK_D8(64), PK_D8(72), PK_D8(80), PK_D8(88)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef PK_D8

// The GEMM Y^T[positions, COUT] = P^T[positions, K] W^T[K, COUT] of every
// image. Threads: WGS consumer warpgroups, then one producer warp. A work
// item is (64-position tile, group of WGS x IMGS images): consumer
// warpgroup g takes IMGS images of the group, each into its own
// accumulators. A block owns a contiguous range of items, tile-major, so
// its P^T tile stays resident in shared memory across the range (loaded
// again only where the tile changes, at most twice a block) while W streams
// through the ring, one 64-k box a slot read by every consumer warpgroup:
// a W box feeds 64 positions of WGS x IMGS images, and each warpgroup's
// epilogue runs while the other's products do. Each warpgroup stages y in
// YT staging tiles (one per image where they fit), so its next image need
// not wait for the store of the last. Shared memory from a 1024-aligned
// base: P^T [KB] boxes, the W ring [STAGES], the y staging tiles [WGS][YT],
// the barriers full[STAGES], empty[STAGES], pfull, pempty.
template <int N, int IMGS>
__global__ void __launch_bounds__(MATMUL_WGS * 128 + 32, 1)
ablate_matmul_kernel(const __grid_constant__ CUtensorMap pmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap ymap, const Abl k, int yt) {
  constexpr int WGS = MATMUL_WGS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full = base + k.off_bar, empty = full + 8 * k.STAGES;
  const uint32_t pfull = empty + 8 * k.STAGES, pempty = pfull + 8;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int i0 = blockIdx.x * k.per, i1 = min(i0 + k.per, k.items);

  if (tid == 0) {
    for (int s = 0; s < k.STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * WGS);
    }
    mbar_init(pfull, 1);
    mbar_init(pempty, 4 * WGS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WGS) {
    // the producer: one thread keeps the ring full
    if (tid != WGS * 128) return;
    int s = 0, held = -1;
    uint32_t ph = 0, pph = 0;
    for (int i = i0; i < i1; ++i) {
      const int tile = i / k.groups;
      if (tile != held) {
        mbar_wait(pempty, pph ^ 1);
        pph ^= 1;
        mbar_expect_tx(pfull, k.KB * P_BOX);
        for (int kb = 0; kb < k.KB; ++kb)
          tma_load(base + kb * P_BOX, &pmap, pfull, tile * 64, kb * 64, 0);
        held = tile;
      }
      for (int pass = 0; pass < k.NPASS; ++pass)
        for (int kb = 0; kb < k.KB; ++kb) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full + 8 * s, k.stage_bytes);
          tma_load(base + k.off_w + s * k.stage_bytes, &wmap, full + 8 * s, kb * 64,
                   pass * N, 0);
          if (++s == k.STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
    }
    return;
  }

  const int wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const uint32_t y_s = base + k.off_y + wg * yt * k.y_bytes;
  float acc[IMGS][N / 2];
  int s = 0, held = -1;
  uint32_t ph = 0, pph = 0;
  for (int i = i0; i < i1; ++i) {
    const int tile = i / k.groups;
    const int b0 = ((i - tile * k.groups) * WGS + wg) * IMGS;
    if (tile != held) {
      mbar_wait(pfull, pph);
      pph ^= 1;
      held = tile;
    }
    // the P^T tile is free after this item when the next one has another
    const bool frees_p = i + 1 == i1 || (i + 1) / k.groups != tile;
    const int p0 = tile * 64;
    for (int pass = 0; pass < k.NPASS; ++pass) {
      if (PA_ABLATE & 1) {
#pragma unroll
        for (int m = 0; m < IMGS; ++m)
#pragma unroll
          for (int r = 0; r < N / 2; ++r) acc[m][r] = 0.f;
      }
      int prev = 0;
      for (int kb = 0; kb < k.KB; ++kb) {
        mbar_wait(full + 8 * s, ph);
        const int cur = s;
        if (++s == k.STAGES) {
          s = 0;
          ph ^= 1;
        }
        if (!(PA_ABLATE & 1)) {
          const uint32_t a_k = base + kb * P_BOX;
          const uint32_t b_s = base + k.off_w + cur * k.stage_bytes;
#pragma unroll
          for (int m = 0; m < IMGS; ++m) pin(acc[m]);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int m = 0; m < IMGS; ++m)
              wgmma_ss<N>(acc[m], desc_a_mn(a_k + j * 2048), desc_b(b_s + j * 32),
                          (kb | j) != 0);
          wgmma_commit();
          wgmma_wait<1>();
#pragma unroll
          for (int m = 0; m < IMGS; ++m) pin(acc[m]);
        }
        // the previous box's products are done: its slot is free
        if (kb > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = cur;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < IMGS; ++m) pin(acc[m]);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(empty + 8 * prev);
        if (frees_p && pass == k.NPASS - 1) mbar_arrive(pempty);
      }
      if (PA_ABLATE & 4) {
        // no y stores: a sum the compiler cannot drop keeps the products
        float sum = 0.f;
#pragma unroll
        for (int m = 0; m < IMGS; ++m)
#pragma unroll
          for (int r = 0; r < N / 2; ++r) sum += acc[m][r];
        if (k.W < 0) reinterpret_cast<float*>(smem_raw)[wtid] = sum;
        continue;
      }
      // epilogue: each image's tile through a staging tile, one TMA store
      // (one bulk group) each; a staging tile is written again once the
      // store of yt images ago has read it. An image past BT (an odd BT's
      // last group) commits an empty group, so the count stays regular.
#pragma unroll
      for (int m = 0; m < IMGS; ++m) {
        const uint32_t y_m = y_s + (m % yt) * k.y_bytes;
        const bool real = b0 + m < k.BT;
        if (wtid == 0) {
          if (yt == 1) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          else asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        }
        warpgroup_sync(1 + wg);
        if (real) stage_bf16<N>(acc[m], y_m, warp, lane);
        fence_proxy_async();
        warpgroup_sync(1 + wg);
        if (wtid == 0) {
          if (real) tma_store(&ymap, y_m, p0, pass * N, b0 + m);
          else asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
    }
  }
  if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int N, int IMGS>
int launch_matmul_layout(const CUtensorMap& pm, const CUtensorMap& wm,
                         const CUtensorMap& ym, const Abl& k, int yt, int grid, int smem,
                         cudaStream_t s) {
  if constexpr (IMGS * N > ACC_MAX) {
    return (int)cudaErrorInvalidValue;
  } else {
    auto kern = ablate_matmul_kernel<N, IMGS>;
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, MATMUL_WGS * 128 + 32, smem, s>>>(pm, wm, ym, k, yt);
    return (int)cudaGetLastError();
  }
}

// images a work item: two or one a warpgroup (packed_conv.MATMUL_LAYOUTS)
template <int N>
int launch_matmul(const CUtensorMap& pm, const CUtensorMap& wm, const CUtensorMap& ym,
                  const Abl& k, int imgs, int yt, int grid, int smem, cudaStream_t s) {
  if (imgs == 2 * MATMUL_WGS) return launch_matmul_layout<N, 2>(pm, wm, ym, k, yt, grid, smem, s);
  if (imgs == MATMUL_WGS) return launch_matmul_layout<N, 1>(pm, wm, ym, k, yt, grid, smem, s);
  return (int)cudaErrorInvalidValue;
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

// The ablations, each on ablation_plan's layout (ops/packed_conv.py).
// Mode 2, ablate_slabs: a = x_cm [BT, CIN, HWP + 2*MARGIN] bf16, w unread;
// windows x windows a (tile, channel box), 1 (wrow positions, all three
// dy) or 3 (SLAB_ROW each), stages window slots. Mode 3, ablate_matmul: a
// = p_const [9*CIN, HWP] bf16, w = w_cm [COUT, 9*CIN] bf16; imgs images a
// work item over two consumer warpgroups (4 or 2: the layouts of
// packed_conv.MATMUL_LAYOUTS), yt staging tiles a warpgroup (1, or its
// images), np the wgmma N of a pass (COUT in ceil(COUT / np) passes),
// stages W ring slots. grid: blocks at most (each takes ceil(items /
// grid) items, so ceil(items / that) are launched). y: [BT, COUT, HWP]
// bf16. Needs CIN and MARGIN multiples of 8, HWP a multiple of 128, W + 1 <=
// MARGIN; mode 2 COUT <= 9*CIN. Returns 0, a cudaError_t, or ENCODE_FAILED
// + the CUresult of a refused tensor map.
extern "C" int m3f_packed_ablate(const void* a, const void* w, void* y, int mode,
                                 int BT, int CIN, int COUT, int W, int HWP, int MARGIN,
                                 int stages, int np, int imgs, int yt, int windows,
                                 int grid, void* stream) {
  if (BT < 0 || CIN <= 0 || CIN % 8 || COUT <= 0 || W <= 0 || W + 1 > MARGIN ||
      MARGIN % 8 || HWP <= 0 || HWP % 128 || grid < 1 || stages < 2 ||
      stages > ABL_MAX_STAGES || (mode != SLABS && mode != MATMUL))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int HWM = HWP + 2 * MARGIN;
  Abl k{};
  k.BT = BT;
  k.COUT = COUT;
  k.W = W;
  k.MARGIN = MARGIN;
  k.STAGES = stages;
  if (mode == SLABS) {
    // the one window: from the dy = -1 window's start to the dy = +1 tap's
    // funnel words (see ablation_plan)
    const int wrow = windows == 1 ? (((-W - 1) & 7) + 2 * W + 144) & ~7 : SLAB_ROW;
    if (COUT > 9 * CIN || (windows != 1 && windows != 3) || wrow > 256)
      return (int)cudaErrorInvalidValue;
    k.BC = CIN < 64 ? CIN : 64;
    k.KB = (CIN + k.BC - 1) / k.BC;
    k.tiles = HWP / SLAB_BN;
    const int64_t items = (int64_t)BT * k.tiles;
    if (items > (1 << 30)) return (int)cudaErrorInvalidValue;
    k.items = (int)items;
    k.per = (k.items + grid - 1) / grid;
    const int ny = (COUT + 255) / 256, yr = ((COUT + ny - 1) / ny + 7) / 8 * 8;
    k.stage_bytes = k.BC * wrow * 2;
    k.off_s = ny * yr * SLAB_BN * 2;
    k.off_x = k.off_s + 64 * SLAB_BN * 2;
    k.off_bar = k.off_x + stages * k.stage_bytes;
    const int64_t smem = (int64_t)k.off_bar + 2 * stages * 8 + 1024;
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    if (BT == 0) return 0;
    CUtensorMap xm, ym;
    const cuuint64_t xdims[3] = {(cuuint64_t)HWM, (cuuint64_t)CIN, (cuuint64_t)BT};
    const cuuint64_t xstrides[2] = {(cuuint64_t)HWM * 2, (cuuint64_t)CIN * HWM * 2};
    const cuuint32_t xbox[3] = {(cuuint32_t)wrow, (cuuint32_t)k.BC, 1};
    const cuuint64_t ydims[3] = {(cuuint64_t)HWP, (cuuint64_t)COUT, (cuuint64_t)BT};
    const cuuint64_t ystrides[2] = {(cuuint64_t)HWP * 2, (cuuint64_t)COUT * HWP * 2};
    const cuuint32_t ybox[3] = {SLAB_BN, (cuuint32_t)yr, 1};
    int err = encode(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, xdims, xstrides, xbox,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
    if (!err)
      err = encode(&ym, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, y, ydims, ystrides, ybox,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err) return err;
    cudaError_t e = cudaFuncSetAttribute(
        ablate_slabs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    ablate_slabs_kernel<<<(k.items + k.per - 1) / k.per, SLAB_FORMERS + 32, (int)smem, s>>>(
        xm, ym, k, CIN, ny, yr, windows, wrow);
    return (int)cudaGetLastError();
  }
  if (np <= 0 || imgs % MATMUL_WGS || (yt != 1 && yt != imgs / MATMUL_WGS))
    return (int)cudaErrorInvalidValue;
  const int K = 9 * CIN;
  k.KB = (K + 63) / 64;
  k.NPASS = (COUT + np - 1) / np;
  k.tiles = HWP / 64;
  k.groups = (BT + imgs - 1) / imgs;
  const int64_t items = (int64_t)k.tiles * k.groups;
  if (items > (1 << 30)) return (int)cudaErrorInvalidValue;
  k.items = (int)items;
  k.per = (k.items + grid - 1) / grid;
  k.stage_bytes = np * ROW;
  k.y_bytes = np * 64 * 2;
  k.off_w = k.KB * P_BOX;
  k.off_y = k.off_w + stages * k.stage_bytes;
  k.off_bar = k.off_y + MATMUL_WGS * yt * k.y_bytes;
  const int64_t smem = (int64_t)k.off_bar + (2 * stages + 2) * 8 + 1024;
  if (smem > SMEM_MAX || (int64_t)k.KB * P_BOX >= (1 << 20))
    return (int)cudaErrorInvalidValue;
  if (BT == 0) return 0;
  CUtensorMap pm, wm, ym;
  const cuuint64_t pdims[3] = {(cuuint64_t)HWP, (cuuint64_t)K, 1};
  const cuuint64_t pstrides[2] = {(cuuint64_t)HWP * 2, (cuuint64_t)K * HWP * 2};
  const cuuint32_t pbox[3] = {64, 64, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)K, (cuuint64_t)COUT, 1};
  const cuuint64_t wstrides[2] = {(cuuint64_t)K * 2, (cuuint64_t)COUT * K * 2};
  const cuuint32_t wbox[3] = {64, (cuuint32_t)np, 1};
  const cuuint64_t ydims[3] = {(cuuint64_t)HWP, (cuuint64_t)COUT, (cuuint64_t)BT};
  const cuuint64_t ystrides[2] = {(cuuint64_t)HWP * 2, (cuuint64_t)COUT * HWP * 2};
  const cuuint32_t ybox[3] = {64, (cuuint32_t)np, 1};
  int err = encode(&pm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, pdims, pstrides, pbox,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = encode(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, wdims, wstrides, wbox,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = encode(&ym, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, y, ydims, ystrides, ybox,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const int blocks = (k.items + k.per - 1) / k.per, sm = (int)smem;
  switch (np) {
    case 32: return launch_matmul<32>(pm, wm, ym, k, imgs, yt, blocks, sm, s);
    case 64: return launch_matmul<64>(pm, wm, ym, k, imgs, yt, blocks, sm, s);
    case 128: return launch_matmul<128>(pm, wm, ym, k, imgs, yt, blocks, sm, s);
    case 144: return launch_matmul<144>(pm, wm, ym, k, imgs, yt, blocks, sm, s);
    case 192: return launch_matmul<192>(pm, wm, ym, k, imgs, yt, blocks, sm, s);
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
