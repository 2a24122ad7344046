// The split flash attention backward's dq pass, bf16, for Hopper (sm_90a):
// the CUDA counterpart of chainermn_tpu/ops/flash_attention.py::
// _flash_bwd_dq_kernel.  The fp32 dq pass (the parity path) stays on CUDA
// cores in flash_attention_bwd_split.cu, which also holds the C entry
// point; the bf16 dk/dv pass is flash_bwd_sm90.cu's kernel.
//
// What it computes, for q/g [B, H, Tq, D], k/v [B, H, Tk, D] read through
// their strides (any Tq, Tk >= 1, D 64 or 128, any finite scale), the
// forward's row statistic lse and delta = rowsum(g * out) - g_lse (both
// fp32 [B*H, Tq]), for each q tile over its live key tiles:
//     p  = exp(scale * q k^T - lse)    (0 where masked: causal top-left
//                                       k <= q, ragged Tk)
//     ds = p * (g v^T - delta)
//     dq = scale * sum over the key tiles of ds k
// with the JAX kernel's points of rounding: bf16 operands into the products
// with fp32 accumulation, ds cast to k's dtype before the dq product, dq
// written once in q's dtype.  Each block owns its q rows, so dq takes no
// atomics and no fp32 buffer, and it is bitwise deterministic.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM) at the
// training shape (B 8, H 12, T 1024, D 64, causal, 524,800 live pairs per
// head): three products, 19.3 GFLOP (19.6 us) against 63.7 MB of q, k, v,
// g, lse and delta in and dq out (19.0 us): set by operations, barely, so
// the products belong on wgmma and the loads must stay out of their way.
//
// How the design answers it (the forward's shape, flash_fwd_sm90.cu):
// - Grid (B*H, q tiles), the heaviest causal q tiles first.  One block has
//   a producer warp and one consumer warpgroup that owns 64 q rows.
// - The producer loads the block's Q and dO tiles once, then feeds a ring
//   of K/V stages (three at D 64, two at D 128) on full and empty
//   mbarriers, by TMA through 4-D tensor maps over the caller's strides
//   (128-byte swizzle; zero fill past Tq and Tk).  Key tiles past the
//   causal diagonal are never loaded.
// - Per key tile the consumers run S = Q K^T and dP = dO V^T on wgmma from
//   shared memory (both operands K-major) as two commit groups, so the
//   exponent of P starts while dP is in flight; P = ex2(S scale log2 e -
//   lse log2 e) in registers, with each thread's two rows of lse and delta
//   loaded once (rows past Tq read as 0, their dq is never stored); the
//   mask (-inf before ex2) runs only on tiles that cross the causal
//   diagonal or the end of Tk.  TMA's zero fill does not make a key past
//   Tk dead: its score is 0 and its p exp(-lse), which can overflow.
// - dS = P (dP - delta) is packed to bf16 in place as the register A
//   operand of dQ += dS K, with K read MN-major through the transpose bit
//   (as V in the forward's O += P V).  S, dP, dS and dQ never leave
//   registers; dQ is scaled and stored once at the end, cut at Tq.
// - 64 x 64 tiles; registers bound the blocks per SM (at D 64 dQ, S and dP
//   are 32 fp32 registers each and packed dS 16; at D 128 dQ is 64).
//
// Plain C interface through flash_attention_bwd_split.cu's entry point;
// launches on the caller's stream and allocates nothing.

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
constexpr int kBQ = 64;             // q rows per block: one warpgroup
constexpr int kBK = 64;             // keys per step of the key loop
constexpr int kBox = 64 * 128;      // bytes of one 64-row x 64-column box
constexpr int kThreads = 128 + 32;  // consumers + producer warp

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
struct Cfg {
  static constexpr int kStages = D == 64 ? 3 : 2;  // K/V ring depth
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;
  static constexpr int kChunks = D / 64;    // 64-column boxes per row
  static constexpr int kTile = 64 * D * 2;  // one bf16 Q, dO, K or V tile
  // 1024 bytes of slack to align the swizzled tiles to 1024
  static constexpr int kBytes = 1024 + 2 * kTile + 2 * kStages * kTile;
};

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_g,
                             const BwdParams prm, float scale_log2) {
  using C = Cfg<D>;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_qg;
  __shared__ __align__(8) uint64_t full_k[kStages];
  __shared__ __align__(8) uint64_t full_v[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];

  unsigned char* sq =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sg = sq + C::kTile;
  unsigned char* sk = sg + C::kTile;            // kStages K tiles
  unsigned char* sv = sk + kStages * C::kTile;  // kStages V tiles

  const int bh = blockIdx.x;
  const int b = bh / prm.H, h = bh % prm.H;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const int n_kt = (prm.Tk + kBK - 1) / kBK;
  // causal: key tiles up to the one holding key q_start + kBQ - 1
  const int n_iter =
      prm.causal ? min((q_start + kBQ + kBK - 1) / kBK, n_kt) : n_kt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&bar_qg, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 1);  // the consumer warpgroup's one arrival
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp: one thread loads
    if (lane == 0) {
      prefetch_tensor_map(&map_q);
      prefetch_tensor_map(&map_g);
      prefetch_tensor_map(&map_k);
      prefetch_tensor_map(&map_v);
      mbar_arrive_expect_tx(&bar_qg, 2 * C::kTile);
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load_4d(sq + c * kBox, &map_q, &bar_qg, 64 * c, q_start, h, b);
        tma_load_4d(sg + c * kBox, &map_g, &bar_qg, 64 * c, q_start, h, b);
      }
      for (int kt = 0; kt < n_iter; ++kt) {
        const int s = kt % kStages, use = kt / kStages;
        // the consumers have released this stage's previous tile
        if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
        mbar_arrive_expect_tx(&full_k[s], C::kTile);
        for (int c = 0; c < C::kChunks; ++c)
          tma_load_4d(sk + s * C::kTile + c * kBox, &map_k, &full_k[s],
                      64 * c, kt * kBK, h, b);
        mbar_arrive_expect_tx(&full_v[s], C::kTile);
        for (int c = 0; c < C::kChunks; ++c)
          tma_load_4d(sv + s * C::kTile + c * kBox, &map_v, &full_v[s],
                      64 * c, kt * kBK, h, b);
      }
    }
    return;
  }

  // the consumer warpgroup: this thread holds q rows row0 and row0 + 8 and,
  // of every n8 block j, columns 8j + 2c and 8j + 2c + 1 (keys of S, dP;
  // dims of dQ)
  const int g = lane / 4, c = lane % 4;
  const int row0 = q_start + 16 * warp + g;
  const bool leader = threadIdx.x == 0;
  const uint32_t q_addr = smem_u32(sq), g_addr = smem_u32(sg);
  // lse * log2(e) and delta of the thread's two rows (0 past Tq)
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool live = row < prm.Tq;
    lse2[r] = live ? prm.lse[(long long)bh * prm.Tq + row] * kLog2e : 0.f;
    dlt[r] = live ? prm.delta[(long long)bh * prm.Tq + row] : 0.f;
  }

  float dq[D / 2];  // m64nD accumulator (D 128: two m64n64 halves)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float s[32], dp[32];  // S then P; dP then dS
  uint32_t da[16];      // bf16 dS: the A fragments of dQ's k16 steps
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) da[i] = 0u;

  // x = A B^T over D for 64 q rows x 64 keys: A (Q or dO) and B (K or V)
  // K-major in shared memory, one commit group
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
  // dQ += dS K over the tile's 64 keys: dS from registers, K [keys, D]
  // MN-major, one commit group
  auto issue_dq = [&](uint32_t k_addr) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) fence_operand(dq[i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) fence_operand(da[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int ch = 0; ch < C::kChunks; ++ch)
        wgmma_rs<64>(dq + 32 * ch, da + 4 * kk,
                     desc_sw128(k_addr + ch * kBox + kk * 16 * 128, kBox,
                                1024));
    wgmma_commit();
  };

  mbar_wait(&bar_qg, 0);
  for (int kt = 0; kt < n_iter; ++kt) {
    const int st = kt % kStages;
    const uint32_t phase = (kt / kStages) & 1;
    const uint32_t k_addr = smem_u32(sk + st * C::kTile);
    const uint32_t v_addr = smem_u32(sv + st * C::kTile);
    mbar_wait(&full_k[st], phase);
    issue_nt(s, q_addr, k_addr);  // S = Q K^T (unscaled)
    mbar_wait(&full_v[st], phase);
    issue_nt(dp, g_addr, v_addr);  // dP = dO V^T

    // the causal diagonal or the end of Tk crosses this tile
    const int k_lo = kt * kBK;
    const bool edge =
        k_lo + kBK > prm.Tk || (prm.causal && k_lo + kBK - 1 > q_start);
    wgmma_wait<1>();  // S
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(s[i]);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2 - lse2[(i / 2) & 1];
      if (edge) {
        const int kpos = k_lo + 8 * (i / 4) + 2 * c + (i & 1);
        const int row = row0 + 8 * ((i / 2) & 1);
        if (kpos >= prm.Tk || (prm.causal && kpos > row)) x = -INFINITY;
      }
      s[i] = ex2(x);  // P
    }
    wgmma_wait<0>();  // dP
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(dp[i]);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dlt[(i / 2) & 1]);
#pragma unroll
    for (int i = 0; i < 16; ++i) da[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
    issue_dq(k_addr);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) fence_operand(dq[i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) fence_operand(da[i]);
    // a stage is free once the warpgroup's wgmma reading it completed (a
    // wgmma group completes for all its warps): one arrival
    if (leader) mbar_arrive(&empty[st]);
  }

  // rows past Tq (zero-filled q and g) are dropped here
  __nv_bfloat16* dqg =
      static_cast<__nv_bfloat16*>(prm.dq) + (long long)bh * prm.Tq * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = row0 + 8 * ((i / 2) & 1);
    if (row < prm.Tq)
      *reinterpret_cast<uint32_t*>(dqg + (long long)row * D + 8 * (i / 4) +
                                   2 * c) =
          pack_bf16(dq[i] * prm.scale, dq[i + 1] * prm.scale);
  }
}

template <int D>
cudaError_t launch(const BwdParams& prm, cudaStream_t stream) {
  using C = Cfg<D>;
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
    err = cudaFuncSetAttribute(flash_bwd_dq_sm90_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kBytes);
    if (err != cudaSuccess) return err;
    configured |= 1ull << dev;
  }
  dim3 grid(prm.B * prm.H, (prm.Tq + kBQ - 1) / kBQ);
  flash_bwd_dq_sm90_kernel<D><<<grid, kThreads, C::kBytes, stream>>>(
      mq, mk, mv, mg, prm, prm.scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

namespace flash {

cudaError_t bwd_dq_bf16_sm90(const BwdParams& prm, int D, cudaStream_t s) {
  if (D == 64) return launch<64>(prm, s);
  if (D == 128) return launch<128>(prm, s);
  return cudaErrorInvalidValue;
}

}  // namespace flash
