// Flash attention backward, bf16, for Hopper (sm_90a): the CUDA counterpart
// of chainermn_tpu/ops/flash_attention.py::_flash_bwd_fused_kernel (with
// the XLA sum of its dq partial planes folded in) and, without its dq part,
// of ::_flash_bwd_dkv_kernel (the split backward's dk/dv pass).  One kernel
// body serves both; dq is a template flag.  Beside it, the two passes the
// wrappers put around it: the delta rowsum (the JAX wrapper's XLA reduce)
// and the dq epilogue (its scale and cast).  fp32 stays on CUDA cores in
// flash_attention_bwd.cu and flash_attention_bwd_split.cu (the parity
// path), which hold the C entry points of the two backward kernels.
//
// What it computes, for q/g [B, H, Tq, D], k/v [B, H, Tk, D] read through
// their strides (any Tq, Tk >= 1, D 64 or 128, any finite scale), the
// forward's row statistic lse and delta = rowsum(g * out) - g_lse (both
// fp32 [B*H, Tq]): for every live (q tile, key tile) pair, once,
//     p  = exp(scale * q k^T - lse)    (0 where masked: causal top-left,
//                                       ragged Tq or Tk)
//     ds = p * (g v^T - delta)
//     dv += p^T g,   dk += ds^T q,   dq += ds k   (dq: the fused kernel)
// with dk scaled at the end and dq after the cross-tile sum (the
// epilogue).  The JAX kernels' points of rounding are kept: bf16 operands
// into the products with fp32 accumulation, p cast to bf16 before the dv
// product, ds before the dk and dq products.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM) at the
// training shape (B 8, H 12, T 1024, D 64, causal, 524,800 live pairs per
// head): fused, five products, 32.2 GFLOP (32.6 us) against 88.9 MB
// (26.5 us); dk/dv, four products, 25.8 GFLOP (26.1 us) against 76.3 MB
// (22.8 us).  Both are set by operations, so the products belong on
// wgmma, fed without stalls.
//
// How the design answers it:
// - Key-major blocks: one block per (b*h, 64-key tile), grid (B*H, key
//   tiles), key tile 0 (under causal the one with the most q tiles) first.
//   K and V are loaded once by TMA through 4-D tensor maps over the
//   caller's strides (128-byte swizzle, zero fill past Tk).  One producer
//   warp feeds a ring (three stages at D 64, two at D 128): each stage
//   holds a 64-row Q tile and its dO (g) tile (TMA) and that tile's lse
//   (times log2 e) and delta rows, which the producer's 32 lanes load with
//   the rows past Tq masked (a tile of a [B*H, Tq] row is 16-byte aligned
//   only when Tq % 4 == 0, so a bulk copy would need padded rows); the
//   stage's full mbarrier counts the 32 lanes' arrivals and the TMA bytes.
// - One consumer warpgroup owns the 64 keys.  Per q tile: S^T = K Q^T and
//   dP^T = V dO^T on wgmma from shared memory (both operands K-major, two
//   commit groups, so the exp of P^T starts while dP^T is in flight);
//   P^T = ex2(S^T scale log2 e - lse log2 e) in registers, masked (-inf
//   before ex2) only on tiles that cross the diagonal or a ragged end;
//   dS^T = P^T (dP^T - delta); then dV += P^T dO and dK += dS^T Q with
//   P^T and dS^T packed to bf16 in place as the register A operand and
//   dO, Q read MN-major through the transpose bit.  dK and dV stay in
//   fp32 registers across the q tiles; the q loop starts at the diagonal
//   tile under causal.
// - dq without per-element atomics: while dV and dK run, dS^T goes to a
//   128-byte-swizzled bf16 tile in shared memory (the accumulator layout
//   makes each thread's pairs 4-byte stores, conflict free); then dQ = dS
//   K is a shared-memory wgmma with both operands MN-major (D 128 as two
//   n64 halves in the same 32 registers), the fp32 tile is staged in
//   shared memory (two buffers) and added into the caller's zeroed fp32
//   [B*H, Tq, D] accumulator by one cp.reduce.async.bulk .add.f32 per
//   tile, cut at Tq's end.  dQ waits for dV and dK: with both in flight
//   ptxas serializes every wgmma of the kernel (C7512).  dq's low bits
//   depend on the order of the adds; dk and dv are bitwise deterministic.
// - Two blocks per SM at D 64 (registers), one at D 128: one block's
//   exp and elementwise work overlaps the other's products.  128-key
//   blocks of two warpgroups (half the Q/dO and dq traffic per key), a
//   deeper ring, red.global.add.v2.f32 or a swizzled TMA tensor reduce in
//   place of the bulk reduce measured no faster on an H100 (PERF.md).
//
// Plain C interface: the delta pass has its own entry point here; the
// kernel and the epilogue are launched by flash_attention_bwd.cu's and
// flash_attention_bwd_split.cu's.  Everything launches on the caller's
// stream and allocates nothing.

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_bwd.cuh"
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using flash::BwdParams;
using flash::pack_bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBK = 64;          // keys per block: one consumer warpgroup
constexpr int kBQ = 64;          // q rows per step of the q loop
constexpr int kBox = 64 * 128;   // bytes of one 64-row x 64-column box
constexpr int kThreads = 128 + 32;  // consumers + producer warp

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D, bool kDq>
struct Cfg {
  // two blocks per SM at D 64 (registers), one at D 128
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;
  static constexpr int kStages = D == 64 ? 3 : 2;  // Q/dO ring depth
  static constexpr int kChunks = D / 64;       // 64-column boxes per row
  static constexpr int kTile = 64 * D * 2;     // one bf16 Q, dO, K or V tile
  static constexpr int kDsBytes = kDq ? kBK * kBQ * 2 : 0;  // bf16 dS^T
  static constexpr int kDqTile = kBQ * D * 4;  // one fp32 dQ staging tile
  static constexpr int kDqBytes = kDq ? 2 * kDqTile : 0;
  // 1024 bytes of slack to align the swizzled tiles to 1024
  static constexpr int kBytes =
      1024 + 2 * kTile + 2 * kStages * kTile + kDsBytes + kDqBytes;
};

template <int D, bool kDq>
__global__ void __launch_bounds__(kThreads, Cfg<D, kDq>::kMinBlocks)
    flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_g,
                          const BwdParams prm, float scale_log2) {
  using C = Cfg<D, kDq>;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv;
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  // per stage: lse * log2(e) and delta of the tile's 64 q rows
  __shared__ __align__(16) float stat[kStages][2][kBQ];

  unsigned char* sk =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sv = sk + C::kTile;
  unsigned char* sq = sv + C::kTile;            // kStages Q tiles
  unsigned char* sg = sq + kStages * C::kTile;  // kStages dO tiles
  unsigned char* sds = sg + kStages * C::kTile;
  float* sdq = reinterpret_cast<float*>(sds + C::kDsBytes);

  const int bh = blockIdx.x;
  const int b = bh / prm.H, h = bh % prm.H;
  const int kt = blockIdx.y;  // key tile 0 first: under causal the heaviest
  const int k_start = kt * kBK;
  const int n_qt = (prm.Tq + kBQ - 1) / kBQ;
  // causal (top-left, key <= q): q tile qt reaches key tile kt iff qt >= kt
  const int first = prm.causal ? kt : 0;
  const int n_it = max(n_qt - first, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's 32 lanes
      mbar_init(&empty[s], 1);  // the consumer warpgroup's one arrival
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    if (lane == 0 && n_it > 0) {
      prefetch_tensor_map(&map_q);
      prefetch_tensor_map(&map_k);
      prefetch_tensor_map(&map_v);
      prefetch_tensor_map(&map_g);
      mbar_arrive_expect_tx(&bar_kv, 2 * C::kTile);
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load_4d(sk + c * kBox, &map_k, &bar_kv, 64 * c, k_start, h, b);
        tma_load_4d(sv + c * kBox, &map_v, &bar_kv, 64 * c, k_start, h, b);
      }
    }
    const float* lse_g = prm.lse + (long long)bh * prm.Tq;
    const float* delta_g = prm.delta + (long long)bh * prm.Tq;
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages, use = it / kStages;
      const int q_start = (first + it) * kBQ;
      // the consumers have released this stage's previous tile
      if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
      // the tiles first (their bytes join the phase before any arrival),
      // then the rows, then every lane's arrival
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * C::kTile);
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load_4d(sq + s * C::kTile + c * kBox, &map_q, &full[s],
                      64 * c, q_start, h, b);
          tma_load_4d(sg + s * C::kTile + c * kBox, &map_g, &full[s],
                      64 * c, q_start, h, b);
        }
      }
      __syncwarp();
#pragma unroll
      for (int rr = 0; rr < kBQ / 32; ++rr) {
        const int r = lane + 32 * rr;
        const bool live = q_start + r < prm.Tq;
        stat[s][0][r] = live ? lse_g[q_start + r] * kLog2e : 0.f;
        stat[s][1][r] = live ? delta_g[q_start + r] : 0.f;
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  // the consumer warpgroup: this thread holds keys key0 and key0 + 8
  // (accumulator rows 16 warp + g and + 8) and, of every n8 block j,
  // columns 8j + 2c and 8j + 2c + 1 (q rows of S^T, dims of dK and dV)
  const int g = lane / 4, c = lane % 4;
  const int key0 = k_start + 16 * warp + g;
  const bool leader = threadIdx.x == 0;
  const uint32_t k_addr = smem_u32(sk), v_addr = smem_u32(sv);
  const uint32_t ds_addr = smem_u32(sds);

  float dk[D / 2], dv[D / 2];  // m64nD accumulators (D 128: two halves)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float st[32], dp[32];         // S^T then P^T; dP^T then dS^T
  uint32_t pa[16], da[16];      // bf16 P^T and dS^T: A fragments
  float dq[32];                 // a 64-column half of dQ

  auto fence_dkv = [&] {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      fence_operand(dk[i]);
      fence_operand(dv[i]);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      fence_operand(pa[i]);
      fence_operand(da[i]);
    }
  };
  // x^T = A B^T over D for 64 keys x 64 q rows: A (K or V) and B (Q or
  // dO) K-major in shared memory, one commit group
  auto issue_nt = [&](float* x, uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(x[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      wgmma_ss<64>(x, desc_sw128(a_addr + off, 16, 1024),
                   desc_sw128(b_addr + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // dV += P^T dO and dK += dS^T Q over the 64 q rows: P^T and dS^T from
  // registers, dO and Q [q, D] MN-major, one commit group
  auto issue_dkv = [&](uint32_t q_addr, uint32_t g_addr) {
    fence_dkv();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
      for (int ch = 0; ch < C::kChunks; ++ch)
        wgmma_rs<64>(dv + 32 * ch, pa + 4 * kk,
                     desc_sw128(g_addr + ch * kBox + kk * 16 * 128, kBox,
                                1024));
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
      for (int ch = 0; ch < C::kChunks; ++ch)
        wgmma_rs<64>(dk + 32 * ch, da + 4 * kk,
                     desc_sw128(q_addr + ch * kBox + kk * 16 * 128, kBox,
                                1024));
    wgmma_commit();
  };
  // dQ[:, 64 ch : 64 ch + 64] = dS K over the 64 keys: A = dS^T read
  // MN-major (its q rows contiguous), B = K MN-major (its dims
  // contiguous); one commit group, waited for
  auto dq_half = [&](int ch) {
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(dq[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_ss_mn64(dq, desc_sw128(ds_addr + kk * 16 * 128, kBox, 1024),
                    desc_sw128(k_addr + ch * kBox + kk * 16 * 128, kBox,
                               1024),
                    kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(dq[i]);
  };

  if (n_it > 0) mbar_wait(&bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const int q_start = (first + it) * kBQ;
    const uint32_t q_addr = smem_u32(sq + s * C::kTile);
    const uint32_t g_addr = smem_u32(sg + s * C::kTile);
    mbar_wait(&full[s], (it / kStages) & 1);
    issue_nt(st, k_addr, q_addr);  // S^T = K Q^T (unscaled)
    issue_nt(dp, v_addr, g_addr);  // dP^T = V dO^T

    // the causal diagonal or a ragged end crosses this tile
    const bool edge = q_start + kBQ > prm.Tq || k_start + kBK > prm.Tk ||
                      (prm.causal && k_start + kBK - 1 > q_start);
    wgmma_wait<1>();  // S^T
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(st[i]);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qi = 8 * (i / 4) + 2 * c + (i & 1);
      float x = st[i] * scale_log2 - stat[s][0][qi];
      if (edge) {
        const int qpos = q_start + qi;
        const int kpos = key0 + 8 * ((i / 2) & 1);
        if (qpos >= prm.Tq || kpos >= prm.Tk || (prm.causal && kpos > qpos))
          x = -INFINITY;
      }
      st[i] = ex2(x);  // P^T
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(dp[i]);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qi = 8 * (i / 4) + 2 * c + (i & 1);
      dp[i] = st[i] * (dp[i] - stat[s][1][qi]);  // dS^T
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      pa[i] = pack_bf16(st[2 * i], st[2 * i + 1]);
      da[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
    }
    // dV and dK run while dS^T is written to shared memory
    issue_dkv(q_addr, g_addr);
    if (kDq) {
      // dS^T, 64 keys x 64 q rows of 128 bytes, in TMA's 128-byte swizzle:
      // the 16-byte chunk j of row r sits at chunk j ^ (r % 8)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = 16 * warp + g + 8 * hr;
          *reinterpret_cast<uint32_t*>(sds + row * 128 + ((j ^ g) << 4) +
                                       4 * c) = da[2 * j + hr];
        }
      fence_proxy_async();
      // the staging buffer this tile fills is free once the reduce issued
      // two tiles ago has read it
      if (leader) bulk_wait_read<1>();
      bar_sync(1, 128);  // every thread's dS^T is written
    }
    // dQ waits for them: with dK, dV, P^T and dS^T in flight beside it,
    // ptxas serializes the wgmmas (C7512)
    wgmma_wait<0>();
    fence_dkv();
    if (leader) mbar_arrive(&empty[s]);  // Q and dO are read
    if (kDq) {
      float* stage = sdq + (it & 1) * (kBQ * D);
#pragma unroll
      for (int ch = 0; ch < C::kChunks; ++ch) {
        dq_half(ch);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = 16 * warp + g + 8 * hr;
            *reinterpret_cast<float2*>(stage + row * D + 64 * ch + 8 * j +
                                       2 * c) =
                make_float2(dq[4 * j + 2 * hr], dq[4 * j + 2 * hr + 1]);
          }
      }
      fence_proxy_async();
      bar_sync(1, 128);  // the dQ tile is staged
      if (leader) {
        const int rows = min(kBQ, prm.Tq - q_start);  // cut at Tq's end
        bulk_reduce_add_f32(static_cast<float*>(prm.dq) +
                                ((long long)bh * prm.Tq + q_start) * D,
                            stage, rows * D * 4);
        bulk_commit();
      }
    }
  }
  if (kDq && leader) bulk_wait<0>();

  // keys past Tk (zero-filled k, v) are dropped here
  __nv_bfloat16* dkg =
      static_cast<__nv_bfloat16*>(prm.dk) + (long long)bh * prm.Tk * D;
  __nv_bfloat16* dvg =
      static_cast<__nv_bfloat16*>(prm.dv) + (long long)bh * prm.Tk * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int key = key0 + 8 * ((i / 2) & 1);
    if (key < prm.Tk) {
      const long long at = (long long)key * D + 8 * (i / 4) + 2 * c;
      *reinterpret_cast<uint32_t*>(dkg + at) =
          pack_bf16(dk[i] * prm.scale, dk[i + 1] * prm.scale);
      *reinterpret_cast<uint32_t*>(dvg + at) = pack_bf16(dv[i], dv[i + 1]);
    }
  }
}

template <int D, bool kDq>
cudaError_t launch(const BwdParams& prm, cudaStream_t stream) {
  using C = Cfg<D, kDq>;
  CUtensorMap mq, mk, mv, mg;
  if (!encode_bf16_4d(&mq, prm.q, D, prm.Tq, prm.H, prm.B, prm.sqt, prm.sqh,
                      prm.sqb, kBQ) ||
      !encode_bf16_4d(&mg, prm.g, D, prm.Tq, prm.H, prm.B, prm.sgt, prm.sgh,
                      prm.sgb, kBQ) ||
      !encode_bf16_4d(&mk, prm.k, D, prm.Tk, prm.H, prm.B, prm.skt, prm.skh,
                      prm.skb, kBK) ||
      !encode_bf16_4d(&mv, prm.v, D, prm.Tk, prm.H, prm.B, prm.svt, prm.svh,
                      prm.svb, kBK))
    return cudaErrorInvalidValue;
  // the shared-memory opt-in is per function and device
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(configured >> dev & 1ull)) {
    err = cudaFuncSetAttribute(flash_bwd_sm90_kernel<D, kDq>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kBytes);
    if (err != cudaSuccess) return err;
    configured |= 1ull << dev;
  }
  dim3 grid(prm.B * prm.H, (prm.Tk + kBK - 1) / kBK);
  flash_bwd_sm90_kernel<D, kDq><<<grid, kThreads, C::kBytes, stream>>>(
      mq, mk, mv, mg, prm, prm.scale * kLog2e);
  return cudaGetLastError();
}

// delta[row] = sum_d g[row, d] * out[row, d] - g_lse[row] in fp32, and,
// when dq_zero is given, that row of the fp32 dq accumulator zeroed: one
// pass over the rows, kLanes threads per row, 16 bytes each per tensor.
template <typename T, int D>
__global__ void __launch_bounds__(256)
    bwd_delta_kernel(const T* g, const T* out, const float* g_lse,
                     float* delta, float* dq_zero, int H, int Tq,
                     long long rows, long long sgb, long long sgh,
                     long long sgt, long long sob, long long soh,
                     long long sot) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kLanes = D / kVec;  // 8, 16 or 32: within one warp
  const long long row =
      (long long)blockIdx.x * (256 / kLanes) + threadIdx.x / kLanes;
  const int part = threadIdx.x % kLanes;
  float sum = 0.f;
  if (row < rows) {
    const long long bh = row / Tq;
    const int t = (int)(row % Tq);
    const long long b = bh / H, h = bh % H;
    const uint4 gv = *reinterpret_cast<const uint4*>(
        g + b * sgb + h * sgh + t * sgt + part * kVec);
    const uint4 ov = *reinterpret_cast<const uint4*>(
        out + b * sob + h * soh + t * sot + part * kVec);
    const T* ga = reinterpret_cast<const T*>(&gv);
    const T* oa = reinterpret_cast<const T*>(&ov);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      sum = fmaf(static_cast<float>(ga[i]), static_cast<float>(oa[i]), sum);
  }
#pragma unroll
  for (int m = kLanes / 2; m > 0; m /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (row >= rows) return;
  if (part == 0) delta[row] = g_lse ? sum - g_lse[row] : sum;
  if (dq_zero) {
    float4* z = reinterpret_cast<float4*>(dq_zero + row * D) +
                part * (D / kLanes / 4);
#pragma unroll
    for (int i = 0; i < D / kLanes / 4; ++i)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <typename T, int D>
cudaError_t launch_delta(const void* g, const void* out, const float* g_lse,
                         float* delta, float* dq_zero, int B, int H, int Tq,
                         long long sgb, long long sgh, long long sgt,
                         long long sob, long long soh, long long sot,
                         cudaStream_t stream) {
  constexpr int kRowsPerBlock = 256 / (D * sizeof(T) / 16);
  const long long rows = (long long)B * H * Tq;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  bwd_delta_kernel<T, D><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(out), g_lse, delta,
      dq_zero, H, Tq, rows, sgb, sgh, sgt, sob, soh, sot);
  return cudaGetLastError();
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 x);

template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      float4 x) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}

template <>
__device__ __forceinline__ void store4<float>(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}

// dq[i] = acc[i] * scale in T, four elements a thread per step
template <typename T>
__global__ void __launch_bounds__(256)
    dq_epilogue_kernel(const float* acc, T* dq, long long n4, float scale) {
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n4;
       i += (long long)gridDim.x * 256) {
    float4 a = reinterpret_cast<const float4*>(acc)[i];
    a.x *= scale;
    a.y *= scale;
    a.z *= scale;
    a.w *= scale;
    store4(dq + 4 * i, a);
  }
}

}  // namespace

namespace flash {

cudaError_t bwd_bf16_sm90(const BwdParams& prm, int D, bool with_dq,
                          cudaStream_t s) {
  if (D == 64) return with_dq ? launch<64, true>(prm, s)
                              : launch<64, false>(prm, s);
  if (D == 128) return with_dq ? launch<128, true>(prm, s)
                               : launch<128, false>(prm, s);
  return cudaErrorInvalidValue;
}

cudaError_t bwd_dq_epilogue(const float* acc, void* dq, int dtype,
                            long long n, float scale, cudaStream_t s) {
  const long long n4 = n / 4;
  const long long want = (n4 + 255) / 256;
  const long long blocks = want < 132 * 16 ? want : 132 * 16;
  if (dtype == 0)
    dq_epilogue_kernel<__nv_bfloat16><<<(unsigned)blocks, 256, 0, s>>>(
        acc, static_cast<__nv_bfloat16*>(dq), n4, scale);
  else if (dtype == 1)
    dq_epilogue_kernel<float><<<(unsigned)blocks, 256, 0, s>>>(
        acc, static_cast<float*>(dq), n4, scale);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace flash

// delta = rowsum(g * out) - g_lse (g_lse may be null) into fp32 [B*H, Tq];
// g and out [B, H, Tq, D] of dtype 0 (bfloat16) or 1 (float32) through
// their element strides (last dimension dense, rows 16-byte aligned).
// dq_zero: null, or an fp32 [B*H, Tq, D] buffer to zero in the same pass
// (the fused backward's dq accumulator).  Returns a cudaError_t.
extern "C" int flash_attention_bwd_delta(
    const void* g, const void* out, const float* g_lse, float* delta,
    float* dq_zero, int dtype, int B, int H, int Tq, int D, long long sgb,
    long long sgh, long long sgt, long long sob, long long soh,
    long long sot, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_delta<__nv_bfloat16, 64>(g, out, g_lse, delta, dq_zero, B,
                                           H, Tq, sgb, sgh, sgt, sob, soh,
                                           sot, s);
  if (dtype == 0 && D == 128)
    return launch_delta<__nv_bfloat16, 128>(g, out, g_lse, delta, dq_zero, B,
                                            H, Tq, sgb, sgh, sgt, sob, soh,
                                            sot, s);
  if (dtype == 1 && D == 64)
    return launch_delta<float, 64>(g, out, g_lse, delta, dq_zero, B, H, Tq,
                                   sgb, sgh, sgt, sob, soh, sot, s);
  if (dtype == 1 && D == 128)
    return launch_delta<float, 128>(g, out, g_lse, delta, dq_zero, B, H, Tq,
                                    sgb, sgh, sgt, sob, soh, sot, s);
  return cudaErrorInvalidValue;
}
