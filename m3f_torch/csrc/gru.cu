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
// dependent steps. A step is a [16 x H] x [H x 3H] product and 16 x H gate
// evaluations, and the next step needs all of h. So the floor is T times
// what one step's exchange of h and its barrier cost.
//
// Two routes, both exported here:
//
// gru_cluster_kernel (m3f_gru_cluster_fwd; the wrapper's "cluster" route):
// one thread-block cluster of C blocks per (direction, tile of BM = 16
// sequences). W_hh is split by hidden unit: block r owns units [r*U,
// (r+1)*U) (U a multiple of 8, units past H masked), i.e. the columns j,
// H+j, 2H+j of its units, so a unit's r / z / n gates stay in one block.
// It loads that slice of W_hh into shared memory once and keeps it for the
// whole sequence (H x 3U: 48 KB in bf16, 96 KB in fp32 at H = 256, C = 8).
// A block has U / 8 unit groups of KW warps (KW = 1, or 2 with fp32 W):
// the group's warps split K, and its lead warp owns the group's 8 units,
// lane l the rows l/4 and l/4 + 8 and the units 2(l%4), 2(l%4)+1 of them:
// the C fragment of mma.m16n8k16, so the r, z, n products of a (row, unit)
// land in one thread and the gates, the fp32 carry and the output need no
// shared memory. Each step t:
//   - product: A = h of the 16 sequences in W's dtype, from the block's own
//     h buffer; bf16 W: mma.sync m16n8k16 (A and B by ldmatrix, K in two
//     accumulator sets), fp32 accumulators; fp32 W: FFMA from shared memory
//     (not TF32, which would change the numerics); with KW > 1 the other
//     warps' partial sums meet the lead warp's in shared memory, behind one
//     block barrier;
//   - gates in fp32, the carry kept in registers;
//   - exchange: h' of the block's units, rounded to W's dtype, is stored
//     into the next h buffer of every block of the cluster (distributed
//     shared memory, st.shared::cluster);
//   - one barrier.cluster arrive.release / wait.acquire: the h buffers are
//     double-buffered, so one barrier a step is enough. The output (and
//     carry) rows are stored between arrive and wait, off the chain, and xp
//     of step t+1 is fetched by cp.async during step t, each lane its own
//     elements, into a ring of two slots (plain loads into registers were
//     slower: the arrive's release waits for loads still in flight).
// The wrapper's planner (m3f_torch/ops/gru.py gru_plan) picks C = 8, or 16
// (a non-portable cluster size) only where 8 does not fit 227 KB; the
// layout below (cluster_layout) is the planner's byte count.
//
// gru_kernel (m3f_gru_stream_fwd; the "stream" route, the port's first
// design, kept for shapes whose slice fits no cluster, e.g. fp32 W at H =
// 512, or an odd H): grid (direction, batch tile of BT sequences); block
// (256, KS=2): thread (j, ks) owns hidden unit j and half of the reduction
// over k, for the three gate columns j, H+j, 2H+j of BT sequences, reading
// W_hh rows from the L2 every step and h from shared memory (broadcast).
// The two halves meet in shared memory, the gate math runs in fp32, and h
// is double-buffered in shared memory (fp32, plus a copy rounded to W's
// dtype for the product).
//
// Both routes: the backward direction reads the input at the reversed time
// index and writes its output in time order, so nothing is flipped in
// memory; the output is [B, T, D, H], i.e. the directions' concatenation.
// For training, the kernel also writes the fp32 carry h of every step ([B,
// T, D, H], optional): the backward recurrence (BPTT, in PyTorch ops) needs
// the carry the forward kept, and recomputing it from the rounded output
// would differ.
//
// Carried state (both routes): h0 [B, D, H] fp32, optional, is the carry a
// lane starts from (null: zeros; direction 1 starts at the last time index),
// and hT [B, D, H] fp32, optional, receives the carry after a lane's last
// step. A sequence cut into chunks that are scanned one after another, each
// starting from the fp32 carry the previous one left, gives the bits of one
// scan of the whole sequence (the sequence-parallel BiGRU,
// parallel/seqpar.py): the walk keeps no time tile, so a chunk's launch
// is cut as the whole sequence's is.
//
// GRU_ABLATE (timing builds of filter_sweep --kind gru; results wrong):
// bit 1 no products, 2 no exchange (each block stores h' into its own
// buffer only), 4 no xp, gates or outputs, 8 a block barrier in place of the
// cluster barrier, 16 no output stores, 32 no xp copies (the ring stays as
// it is). 5 is the walk alone: exchange and barrier, the chain's floor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef GRU_ABLATE
#define GRU_ABLATE 0
#endif

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
           float* __restrict__ hs, const float* __restrict__ h0,
           float* __restrict__ hT, int B, int T, int H, int D) {
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

  for (int i = tid; i < BT * H; i += JT * KS) {
    const int b = i / H;
    const float v = (h0 != nullptr && b < nb)
        ? h0[((int64_t)(b0 + b) * D + d) * H + i - b * H] : 0.f;
    h[i] = v;
    hw[i] = round_w<WT>(v);
  }
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
  if (hT != nullptr)
    for (int i = tid; i < nb * H; i += JT * KS) {
      const int b = i / H;
      hT[((int64_t)(b0 + b) * D + d) * H + i - b * H] = h[i];
    }
}

template <typename XT, typename WT>
int launch(const void* xp, const void* whh, const void* bhh, void* out,
           float* hs, const float* h0, float* hT, int B, int T, int H, int D,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * BT * H + 3 * BT * JT);
  cudaError_t e = cudaFuncSetAttribute(
      gru_kernel<XT, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(D, (B + BT - 1) / BT), block(JT, KS);
  gru_kernel<XT, WT><<<grid, block, smem, stream>>>(
      (const XT*)xp, (const WT*)whh, (const float*)bhh, (XT*)out, hs, h0, hT,
      B, T, H, D);
  return (int)cudaGetLastError();
}

// --- the cluster walk --------------------------------------------------------

constexpr int BM = 16;          // sequences a batch tile: the M of one mma
constexpr int NSLOT = 2;        // xp ring: step t and t + 1
constexpr int SMEM_MAX = 232448;

// Shared memory of one block, in bytes (gru_plan in ops/gru.py counts the
// same): the W slice, two h buffers in W's dtype and the xp ring.
struct Layout {
  int kp;        // K = H padded to a multiple of 32 (zero rows / columns)
  int hstride;   // elements a row of an h buffer (kp + 16 bytes)
  int wstride;   // bf16: elements a W row [3U][kp + 8] (n-major, k inner);
                 // fp32: 3U, a row per k ([kp][3U])
  int w_bytes, h_bytes, x_bytes, r_bytes, total;
};

// KW warps share a unit group's K (ksplit); the KW - 1 partial products
// meet in shared memory, [KW - 1][U / 8][32 lanes][12] fp32
template <typename WT>
__host__ __device__ inline Layout cluster_layout(int H, int U, int KW) {
  Layout L;
  const int ws = (int)sizeof(WT);
  const int n = 3 * U;
  L.kp = (H + 31) / 32 * 32;
  L.hstride = L.kp + 16 / ws;
  if (ws == 2) {
    L.wstride = L.kp + 8;
    L.w_bytes = n * L.wstride * 2;
  } else {
    L.wstride = n;
    L.w_bytes = L.kp * n * 4;
  }
  L.h_bytes = BM * L.hstride * ws;
  // the ring holds xp in x's dtype: bf16 with bf16 W, else sized for fp32
  L.x_bytes = NSLOT * BM * n * (ws == 2 ? 2 : 4);
  L.r_bytes = (KW - 1) * (U / 8) * 32 * 12 * 4;
  L.total = L.w_bytes + 2 * L.h_bytes + L.x_bytes + L.r_bytes;
  return L;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
// the address of the same shared-memory offset in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" :: "r"(addr), "r"(v)
               : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};"
               :: "r"(addr), "f"(v.x), "f"(v.y) : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// cp.async of `bytes` (4 or 8); src_size 0 fills the slot with zeros
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
               :: "r"(dst), "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// a pair of adjacent values in x's / W's dtype <-> two floats
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void st_cluster_pair(uint32_t addr, float a,
                                                float b, float*) {
  st_cluster(addr, make_float2(a, b));
}
__device__ __forceinline__ void st_cluster_pair(uint32_t addr, float a,
                                                float b, __nv_bfloat16*) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  st_cluster(addr, *reinterpret_cast<const uint32_t*>(&v));
}

// acc[g][i]: gate g's product at (row r0 + 8 (i / 2), unit ul + i % 2) of
// this lane, over k in [kb, ke) of the h buffer at `hbuf`. bf16 W: mma.sync,
// the even and odd k-steps in two accumulator sets (six independent chains
// a warp); q is the warp's unit group.
__device__ __forceinline__ void product(float (&acc)[3][4], uint32_t hbuf,
                                        const __nv_bfloat16* ws,
                                        const Layout& L, int U, int q,
                                        int lane, int kb, int ke) {
  float odd[3][4];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] = odd[g][i] = 0.f;
  const uint32_t a_addr =
      hbuf + ((lane & 15) * L.hstride + (lane >> 4) * 8) * 2;
  uint32_t b_addr[3];
#pragma unroll
  for (int g = 0; g < 3; ++g)
    b_addr[g] = smem_addr(ws) +
                ((g * U + q * 8 + (lane & 7)) * L.wstride + (lane >> 3) * 8) * 2;
  for (int k = kb; k < ke; k += 32) {
    uint32_t a[4], c[4], b[3][4];
    ldsm_x4(a_addr + k * 2, a[0], a[1], a[2], a[3]);
    ldsm_x4(a_addr + (k + 16) * 2, c[0], c[1], c[2], c[3]);
#pragma unroll
    for (int g = 0; g < 3; ++g)
      ldsm_x4(b_addr[g] + k * 2, b[g][0], b[g][1], b[g][2], b[g][3]);
#pragma unroll
    for (int g = 0; g < 3; ++g)
      mma_bf16(acc[g], a[0], a[1], a[2], a[3], b[g][0], b[g][1]);
#pragma unroll
    for (int g = 0; g < 3; ++g)
      mma_bf16(odd[g], c[0], c[1], c[2], c[3], b[g][2], b[g][3]);
  }
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] += odd[g][i];
}

// fp32 W: FFMA over k from shared memory, h four k at a time
__device__ __forceinline__ void product(float (&acc)[3][4], uint32_t,
                                        const float* hbuf_f, const float* ws,
                                        const Layout& L, int U, int r0, int ul,
                                        int kb, int ke) {
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
  const int n = 3 * U;
  const float* h0 = hbuf_f + r0 * L.hstride;
  const float* h1 = h0 + 8 * L.hstride;
#pragma unroll 2
  for (int k = kb; k < ke; k += 4) {
    const float4 p = *reinterpret_cast<const float4*>(h0 + k);
    const float4 q = *reinterpret_cast<const float4*>(h1 + k);
    const float hp[4] = {p.x, p.y, p.z, p.w}, hq[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float2 wv = load_pair(ws + (k + kk) * n + g * U + ul);
        acc[g][0] = fmaf(hp[kk], wv.x, acc[g][0]);
        acc[g][1] = fmaf(hp[kk], wv.y, acc[g][1]);
        acc[g][2] = fmaf(hq[kk], wv.x, acc[g][2]);
        acc[g][3] = fmaf(hq[kk], wv.y, acc[g][3]);
      }
    }
  }
}

template <typename XT, typename WT>
__global__ void __launch_bounds__(512)
gru_cluster_kernel(const XT* __restrict__ xp, const WT* __restrict__ whh,
                   const float* __restrict__ bhh, XT* __restrict__ out,
                   float* __restrict__ hs, const float* __restrict__ h0,
                   float* __restrict__ hT, int B, int T, int H, int D, int U,
                   int KW) {
  extern __shared__ __align__(16) unsigned char cl_smem[];
  const Layout L = cluster_layout<WT>(H, U, KW);
  WT* ws = reinterpret_cast<WT*>(cl_smem);
  WT* hb = reinterpret_cast<WT*>(cl_smem + L.w_bytes);         // 2 buffers
  XT* xr = reinterpret_cast<XT*>(cl_smem + L.w_bytes + 2 * L.h_bytes);
  float4* red = reinterpret_cast<float4*>(cl_smem + L.w_bytes +
                                          2 * L.h_bytes + L.x_bytes);
  const uint32_t hb_addr = smem_addr(hb), xr_addr = smem_addr(xr);

  const int rank = (int)cluster_rank(), csize = (int)cluster_size();
  const int d = blockIdx.z, b0 = blockIdx.y * BM;
  const int nb = min(BM, B - b0);
  const int H3 = 3 * H, N = 3 * U;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int groups = U / 8;
  const int q = warp % groups, kh = warp / groups;  // unit group, K part
  const bool lead = kh == 0;   // the K part 0 warp owns gates and outputs
  const int nk = L.kp / 32;
  const int kb = kh * nk / KW * 32, ke = (kh + 1) * nk / KW * 32;
  const WT* w = whh + (int64_t)d * H * H3;
  const float* bias = bhh + (int64_t)d * H3;
  const bool reverse = (d == 1);
  const int r0 = lane >> 2;                  // rows r0, r0 + 8
  const int ul = q * 8 + 2 * (lane & 3);     // units ul, ul + 1 of the block
  const int j = rank * U + ul;               // ... of the layer
  const bool jv = lead && j < H;             // H even: j + 1 < H too

  // xp of step `step` into ring slot `slot`: each lane its own 3 x 2 pairs
  auto prefetch = [&](int step, int slot) {
    if (!lead) return;
    const int t = reverse ? T - 1 - step : step;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      const bool ok = jv && row < nb;
      const XT* src = ok ? xp + (((int64_t)(b0 + row) * T + t) * D + d) * H3 + j
                         : xp;
      const uint32_t dst =
          xr_addr + ((slot * BM + row) * N + ul) * (int)sizeof(XT);
#pragma unroll
      for (int g = 0; g < 3; ++g)
        cp_async<(int)(2 * sizeof(XT))>(dst + g * U * (int)sizeof(XT),
                                 ok ? src + g * H : src, ok);
    }
  };
  if (!(GRU_ABLATE & 36)) prefetch(0, 0);
  cp_commit();

  // the block's slice of W_hh, once: column g*U + u is W[:, g*H + rank*U + u]
  for (int i = tid; i < L.kp * N; i += blockDim.x) {
    const int k = i / N, n = i - k * N;
    const int g = n / U, u = n - g * U, jj = rank * U + u;
    const WT v = (k < H && jj < H) ? w[(int64_t)k * H3 + g * H + jj]
                                   : from_f<WT>(0.f);
    if (sizeof(WT) == 2) ws[n * L.wstride + k] = v;
    else ws[k * N + n] = v;
  }
  // h buffer 0 holds the starting carry of the tile's rows rounded to W's
  // dtype (zeros without h0, and in the padding), buffer 1 zeros
  for (int i = tid; i < 2 * BM * L.hstride; i += blockDim.x) {
    const int row = i / L.hstride, k = i - row * L.hstride;
    hb[i] = from_f<WT>((h0 != nullptr && row < nb && k < H)
                           ? h0[((int64_t)(b0 + row) * D + d) * H + k] : 0.f);
  }
  float bh[3][2], hc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int e = 0; e < 2; ++e) bh[g][e] = jv ? bias[g * H + j + e] : 0.f;
  if (h0 != nullptr && jv) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r0 + 8 * i < nb) {
        const float2 v = load_pair(h0 + ((int64_t)(b0 + r0 + 8 * i) * D + d) * H + j);
        hc[2 * i] = v.x;
        hc[2 * i + 1] = v.y;
      }
  }
  // every block of the cluster runs and has zeroed its buffers before any
  // block stores into them
  __syncthreads();
  cluster_arrive();
  cluster_wait();

  for (int step = 0; step < T; ++step) {
    const int cur = step & 1;
    const int t = reverse ? T - 1 - step : step;
    if (!(GRU_ABLATE & 36) && step + 1 < T) prefetch(step + 1, cur ^ 1);
    cp_commit();
    cp_wait1();                               // this step's xp has landed

    float acc[3][4];
    if (GRU_ABLATE & 1) {
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
    } else if constexpr (sizeof(WT) == 2) {
      product(acc, hb_addr + cur * L.h_bytes,
              reinterpret_cast<const __nv_bfloat16*>(ws), L, U, q, lane, kb,
              ke);
    } else {
      product(acc, 0u,
              reinterpret_cast<const float*>(hb) + cur * BM * L.hstride,
              reinterpret_cast<const float*>(ws), L, U, r0, ul, kb, ke);
    }
    if (KW > 1) {          // the K parts meet in the lead warp of the group
      if (!lead) {
        float4* dst = red + (((kh - 1) * groups + q) * 32 + lane) * 3;
#pragma unroll
        for (int g = 0; g < 3; ++g)
          dst[g] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      }
      __syncthreads();
      if (lead) {
        for (int p = 1; p < KW; ++p) {
          const float4* src = red + (((p - 1) * groups + q) * 32 + lane) * 3;
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            const float4 v = src[g];
            acc[g][0] += v.x; acc[g][1] += v.y; acc[g][2] += v.z; acc[g][3] += v.w;
          }
        }
      }
    }

    // gates (fp32); the carry stays in registers
    float hn[4];
    const XT* xs = xr + cur * BM * N;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (GRU_ABLATE & 4) {
        hn[2 * i] = hc[2 * i] + acc[0][2 * i];
        hn[2 * i + 1] = hc[2 * i + 1] + acc[0][2 * i + 1];
        continue;
      }
      const float2 xg[3] = {load_pair(xs + row * N + ul),
                            load_pair(xs + row * N + U + ul),
                            load_pair(xs + row * N + 2 * U + ul)};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * i + e;
        const float hp_r = round_w<WT>(acc[0][c]) + bh[0][e];
        const float hp_z = round_w<WT>(acc[1][c]) + bh[1][e];
        const float hp_n = round_w<WT>(acc[2][c]) + bh[2][e];
        const float r = sigmoid_f((e ? xg[0].y : xg[0].x) + hp_r);
        const float z = sigmoid_f((e ? xg[1].y : xg[1].x) + hp_z);
        const float n = tanhf((e ? xg[2].y : xg[2].x) + r * hp_n);
        hn[c] = (1.f - z) * n + z * hc[c];
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) hc[c] = hn[c];

    // exchange: h' of this lane's units into the next buffer of every block
    if (jv) {
      const uint32_t nxt = hb_addr + (cur ^ 1) * L.h_bytes;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t off =
            nxt + ((r0 + 8 * i) * L.hstride + j) * (int)sizeof(WT);
        if (GRU_ABLATE & 2) {
          st_cluster_pair(map_rank(off, rank), hn[2 * i], hn[2 * i + 1], ws);
        } else {
          for (int q = 0; q < csize; ++q)
            st_cluster_pair(map_rank(off, q), hn[2 * i], hn[2 * i + 1], ws);
        }
      }
    }
    __syncwarp();
    if (GRU_ABLATE & 8) __syncthreads();
    else cluster_arrive();
    // the output rows, off the chain
    if (!(GRU_ABLATE & 20) && jv) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        if (row >= nb) continue;
        const int64_t o = (((int64_t)(b0 + row) * T + t) * D + d) * H + j;
        store_pair(out + o, hn[2 * i], hn[2 * i + 1]);
        if (hs != nullptr) store_pair(hs + o, hn[2 * i], hn[2 * i + 1]);
      }
    }
    if (!(GRU_ABLATE & 8)) cluster_wait();
  }
  if (hT != nullptr && jv) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r0 + 8 * i < nb)
        store_pair(hT + ((int64_t)(b0 + r0 + 8 * i) * D + d) * H + j,
                   hc[2 * i], hc[2 * i + 1]);
  }
  // no block leaves while another may still store into its shared memory
  cluster_arrive();
  cluster_wait();
}

template <typename XT, typename WT>
int launch_cluster(const void* xp, const void* whh, const void* bhh, void* out,
                   float* hs, const float* h0, float* hT, int B, int T, int H,
                   int D, int C, int U, int KW, cudaStream_t stream) {
  if (H % 2 || U <= 0 || U % 8 || KW < 1 || KW > 4 || U / 8 * 32 * KW > 512 ||
      C < 1 || C > 16 || C * U < H)
    return (int)cudaErrorInvalidValue;
  const Layout L = cluster_layout<WT>(H, U, KW);
  if (L.total > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = gru_cluster_kernel<XT, WT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return (int)e;
  if (C > 8) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (B + BM - 1) / BM, D);
  cfg.blockDim = dim3(U / 8 * 32 * KW);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, (const XT*)xp, (const WT*)whh,
                         (const float*)bhh, (XT*)out, hs, h0, hT, B, T, H, D,
                         U, KW);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// No step: the final carry (when asked for) is the starting one.
int carry_through(const void* h0, void* hT, int B, int D, int H,
                  void* stream) {
  if (hT == nullptr) return 0;
  const size_t n = sizeof(float) * B * D * H;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(h0 != nullptr
                   ? cudaMemcpyAsync(hT, h0, n, cudaMemcpyDeviceToDevice, s)
                   : cudaMemsetAsync(hT, 0, n, s));
}

}  // namespace

// Both entries: xp [B, T, D, 3H] (x@W_ih + b_ih), whh [D, H, 3H] in xp's
// dtype or fp32, bhh [D, 3H] fp32, out [B, T, D, H]; hs [B, T, D, H] fp32
// carries or null; h0 [B, D, H] fp32 starting carry or null (zeros); hT
// [B, D, H] fp32 final carry or null; direction 1 of D = 2 runs in reverse
// time.

// The cluster walk: clusters of C blocks of U hidden units each, K split
// over KW warps a unit group (the planner's choice; H even, U a multiple of
// 8, C * U >= H, C <= 16, KW <= 4, U / 8 * 32 * KW <= 512 threads).
extern "C" int m3f_gru_cluster_fwd(const void* xp, const void* whh,
                                   const void* bhh, void* out, void* hs,
                                   const void* h0, void* hT, int B, int T,
                                   int H, int D, int x_bf16, int w_bf16,
                                   int C, int U, int KW, void* stream) {
  if (B <= 0) return 0;
  if (T <= 0) return carry_through(h0, hT, B, D, H, stream);
  if (D < 1 || D > 2 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16 && w_bf16)
    return launch_cluster<__nv_bfloat16, __nv_bfloat16>(
        xp, whh, bhh, out, (float*)hs, (const float*)h0, (float*)hT, B, T, H,
        D, C, U, KW, s);
  if (x_bf16)
    return launch_cluster<__nv_bfloat16, float>(
        xp, whh, bhh, out, (float*)hs, (const float*)h0, (float*)hT, B, T, H,
        D, C, U, KW, s);
  if (w_bf16) return (int)cudaErrorInvalidValue;  // W_hh is x's dtype or fp32
  return launch_cluster<float, float>(xp, whh, bhh, out, (float*)hs,
                                      (const float*)h0, (float*)hT, B, T, H,
                                      D, C, U, KW, s);
}

// The stream route (the first design): any H.
extern "C" int m3f_gru_stream_fwd(const void* xp, const void* whh,
                                  const void* bhh, void* out, void* hs,
                                  const void* h0, void* hT, int B, int T,
                                  int H, int D, int x_bf16, int w_bf16,
                                  void* stream) {
  if (B <= 0) return 0;
  if (T <= 0) return carry_through(h0, hT, B, D, H, stream);
  if (D < 1 || D > 2 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16 && w_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(xp, whh, bhh, out, (float*)hs,
                                                (const float*)h0, (float*)hT,
                                                B, T, H, D, s);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(xp, whh, bhh, out, (float*)hs,
                                        (const float*)h0, (float*)hT, B, T, H,
                                        D, s);
  if (w_bf16) return (int)cudaErrorInvalidValue;  // W_hh is x's dtype or fp32
  return launch<float, float>(xp, whh, bhh, out, (float*)hs, (const float*)h0,
                              (float*)hT, B, T, H, D, s);
}
