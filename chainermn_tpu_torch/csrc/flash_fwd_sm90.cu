// Flash attention forward, bf16, for Hopper (sm_90a): the CUDA counterpart
// of chainermn_tpu/ops/flash_attention.py::_flash_kernel (no lse) and
// ::_flash_kernel_lse (the training forward, which also writes the row
// statistic lse = m_safe + log(max(l, 1e-30)) in fp32, natural log; m_safe
// is 0 for a row with no live key, so such a row's out is 0 and its lse the
// finite log(1e-30)).  One kernel body serves both; the lse store is a
// template flag.  The fp32 forward (the parity path) stays on CUDA cores in
// flash_attention.cu, which also holds the C entry point.
//
// What it computes: out = softmax(scale * q k^T [causal, top-left: k <= q])
// v for q [B, H, Tq, D] and k/v [B, H, Tk, D] read through their strides,
// any Tq, Tk >= 1, D 64 or 128, any finite scale (0 and negative included),
// with the JAX kernel's numerics: bf16 q/k/v into the products, fp32
// accumulation and online-softmax state (m, l, acc), p cast to bf16 before
// the PV product, the m_safe / corr / l >= 1e-30 rules.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM).  Training
// shape (B 8, H 12, T 1024, D 64, causal, with lse): 12.9 GFLOP (13.0 us)
// against 50.7 MB of q/k/v/o and lse (15.1 us): bytes.  One serving prefill
// layer (B 1, T 1024, no lse): 1.61 GFLOP (1.6 us) against 6.3 MB (1.88
// us): bytes.  Both are short, so the kernel must keep the memory system
// and the tensor cores busy at once and lose little to its own latency.
//
// How the design answers it:
// - One producer warp issues TMA loads (cp.async.bulk.tensor) through 4-D
//   tensor maps (D, T, H, B) with the caller's strides, so the strided q/k/v
//   sliced out of one [B, T, 3, H, D] projection are read in place.  Tiles
//   land 128-byte swizzled (a bf16 row of 64 is one swizzle atom; D 128 is
//   two 64-column boxes); TMA's zero fill replaces the ragged-edge masking
//   of the loads.  K and V go through a ring of stages (three at D 64,
//   two at D 128) on full and empty mbarriers, so the copies of the next
//   key tiles are in flight while the current one is computed, and each of
//   q, k, v is read from device memory once per q tile.  Causal key tiles
//   past the diagonal are never loaded.
// - One consumer warpgroup per block owns its 64 q rows and runs both
//   products on wgmma: S = Q K^T with Q and K read from shared memory (both
//   K-major), then O += P V with P's fp32 accumulator packed to bf16 in
//   place as the register A operand (the m64nN accumulator layout is the A
//   layout) and V read MN-major through the transpose bit.  S, P and O
//   never leave registers.  Tile j's Q K^T and tile j - 1's P V are issued
//   as one batch, and the warpgroups of the 2-3 blocks on an SM interleave
//   one's softmax (ex2 on the SFUs) with another's products.  Within a
//   warpgroup ptxas places the P V's wait ahead of the softmax, so the two
//   do not overlap there (PERF.md).
// - Per score: one FMUL by scale * log2(e) ahead of the row max (so the
//   max is that of what enters ex2, right for a scale of either sign or 0)
//   and one FADD into ex2; the mask runs only on tiles that cross the
//   causal diagonal or the ragged end of Tk.
// - Tiles of 64 q rows x BK keys, BK chosen by the Python wrapper
//   (_fwd_block_k) from H100 measurements: 64 at the training shape (three
//   blocks per SM), 128 for a serving prefill at B 1 (fewer, longer steps
//   on the critical path); 64 at D 128 (registers).  Grid (B*H, q tiles),
//   the heaviest causal q tiles first.
//
// Plain C interface through flash_attention.cu's entry point; launches on
// the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_fwd.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using flash::FwdParams;
using flash::pack_bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBQ = 64;  // q rows per block: one consumer warpgroup

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D, int BK>
struct Tiles {
  // K/V ring depth: three stages at D 64 (the prefetch distance must cover
  // a tile while the previous one is still held by its P V), two at D 128
  static constexpr int kStages = D == 64 ? 3 : 2;
  // 64 x 64 tiles at D 64: three blocks per SM (at most 136 registers)
  static constexpr int kMinBlocks = D == 64 && BK == 64 ? 3 : 1;
  static constexpr int kThreads = 128 + 32;    // consumers + producer warp
  static constexpr int kChunks = D / 64;       // 64-column boxes per row
  static constexpr int kQChunk = kBQ * 128;    // bytes of one box of Q
  static constexpr int kKVChunk = BK * 128;    // bytes of one box of K or V
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = BK * D * 2;  // one stage of K (or V)
  // 1024 bytes of slack to align the swizzled tiles to 1024
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes;
};

template <int D, int BK, bool kLse>
__global__ void __launch_bounds__(Tiles<D, BK>::kThreads,
                                  Tiles<D, BK>::kMinBlocks)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const FwdParams prm, float scale_log2) {
  using Tl = Tiles<D, BK>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t full_k[Tl::kStages];
  __shared__ __align__(8) uint64_t full_v[Tl::kStages];
  __shared__ __align__(8) uint64_t empty[Tl::kStages];

  unsigned char* sq =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sk = sq + Tl::kQBytes;
  unsigned char* sv = sk + Tl::kStages * Tl::kKVBytes;

  const int bh = blockIdx.x;
  const int b = bh / prm.H, h = bh % prm.H;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const int n_kt = (prm.Tk + BK - 1) / BK;
  // causal: key tiles up to the one holding key q_start + kBQ - 1
  const int n_iter =
      prm.causal ? min((q_start + kBQ + BK - 1) / BK, n_kt) : n_kt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < Tl::kStages; ++s) {
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
      prefetch_tensor_map(&map_k);
      prefetch_tensor_map(&map_v);
      mbar_arrive_expect_tx(&bar_q, Tl::kQBytes);
      for (int c = 0; c < Tl::kChunks; ++c)
        tma_load_4d(sq + c * Tl::kQChunk, &map_q, &bar_q, 64 * c, q_start, h,
                    b);
      for (int kt = 0; kt < n_iter; ++kt) {
        const int s = kt % Tl::kStages, use = kt / Tl::kStages;
        // the consumers have released this stage's previous tile
        if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
        mbar_arrive_expect_tx(&full_k[s], Tl::kKVBytes);
        for (int c = 0; c < Tl::kChunks; ++c)
          tma_load_4d(sk + s * Tl::kKVBytes + c * Tl::kKVChunk, &map_k,
                      &full_k[s], 64 * c, kt * BK, h, b);
        mbar_arrive_expect_tx(&full_v[s], Tl::kKVBytes);
        for (int c = 0; c < Tl::kChunks; ++c)
          tma_load_4d(sv + s * Tl::kKVBytes + c * Tl::kKVChunk, &map_v,
                      &full_v[s], 64 * c, kt * BK, h, b);
      }
    }
    return;
  }

  // the consumer warpgroup: this thread holds rows row0 and row0 + 8,
  // columns 8j + 2c and 8j + 2c + 1 of every n8 block j
  const int g = lane / 4, c = lane % 4;
  const int row0 = q_start + 16 * warp + g;
  const uint32_t q_addr = smem_u32(sq);

  float o[D / 2];   // m64nD accumulator (at D 128: two m64n64 halves)
  float sc[BK / 2];  // m64nBK scores, then probabilities
  uint32_t pa[BK / 4];  // bf16 P: the A fragments of PV's k16 steps
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) pa[i] = 0u;
  // row max of scale * log2(e) * s: the exponent of ex2
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums
  float corr[2];

  // S = Q K^T for the tile in stage s, over D in k16 steps (one group)
  auto issue_qk = [&](int s) {
    const uint32_t k_addr = smem_u32(sk + s * Tl::kKVBytes);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) fence_operand(sc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // k16 step inside a 128-byte row
      wgmma_ss<BK>(
          sc, desc_sw128(q_addr + (kk / 4) * Tl::kQChunk + off, 16, 1024),
          desc_sw128(k_addr + (kk / 4) * Tl::kKVChunk + off, 16, 1024),
          kk > 0);
    }
    wgmma_commit();
  };
  // O += P V for the tile in stage s, over its keys in k16 steps (one group)
  auto issue_pv = [&](int s) {
    const uint32_t v_addr = smem_u32(sv + s * Tl::kKVBytes);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) fence_operand(o[i]);
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) fence_operand(pa[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int ch = 0; ch < Tl::kChunks; ++ch)
        wgmma_rs<64>(o + 32 * ch, pa + 4 * kk,
                     desc_sw128(v_addr + ch * Tl::kKVChunk + kk * 16 * 128,
                                Tl::kKVChunk, 1024));
    }
    wgmma_commit();
  };
  auto sync_s = [&] {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) fence_operand(sc[i]);
  };
  auto sync_pv = [&] {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) fence_operand(o[i]);
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) fence_operand(pa[i]);
  };
  // the online softmax of key tile kt on sc, in place; sets corr and
  // touches neither o nor pa (a PV may still be reading them)
  auto softmax = [&](int kt) {
    const int k_lo = kt * BK;
    // the scale first, so that the row max is the largest exponent for a
    // scale of either sign (and masked scores stay -inf at a scale of 0)
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] *= scale_log2;
    // the causal diagonal or the ragged end of Tk crosses this tile
    if (k_lo + BK > prm.Tk || (prm.causal && k_lo + BK - 1 > q_start)) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int kpos = k_lo + 8 * (i / 4) + 2 * c + (i & 1);
        const int row = row0 + 8 * ((i / 2) & 1);
        if (kpos >= prm.Tk || (prm.causal && kpos > row)) sc[i] = -INFINITY;
      }
    }
    // four independent chains per row for the max and the sum
    float mx4[2][4], ls4[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int a = 0; a < 4; ++a) mx4[r][a] = m[r], ls4[r][a] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float& a = mx4[(i / 2) & 1][(i / 4) % 2 * 2 + (i & 1)];
      a = fmaxf(a, sc[i]);
    }
    float mx[2], msc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(fmaxf(mx4[r][0], mx4[r][1]), fmaxf(mx4[r][2], mx4[r][3]));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      msc[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // m_safe
      corr[r] = ex2(m[r] - msc[r]);  // 0 if m was -inf
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      sc[i] = ex2(sc[i] - msc[(i / 2) & 1]);
      ls4[(i / 2) & 1][(i / 4) % 2 * 2 + (i & 1)] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = l[r] * corr[r] +
             ((ls4[r][0] + ls4[r][1]) + (ls4[r][2] + ls4[r][3]));
  };
  // O to the latest row max, before the next P V adds to it
  auto rescale = [&] {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) & 1];
  };
  // P to bf16 A fragments, once the previous P V no longer reads them
  auto pack = [&] {
#pragma unroll
    for (int i = 0; i < BK / 4; ++i)
      pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
  };
  // a stage is free once the warpgroup's wgmma reading it completed (a
  // wgmma group completes for all its warps): one arrival
  const bool leader = threadIdx.x == 0;
  auto release = [&](int s) {
    if (leader) mbar_arrive(&empty[s]);
  };

  mbar_wait(&bar_q, 0);
  mbar_wait(&full_k[0], 0);
  issue_qk(0);
  wgmma_wait<0>();
  sync_s();
  softmax(0);
  pack();
  // tile kt's Q K^T and tile kt - 1's P V go to the tensor cores as one
  // batch; the softmax of tile kt needs only the first
  for (int kt = 1; kt < n_iter; ++kt) {
    const int s = kt % Tl::kStages, sp = (kt - 1) % Tl::kStages;
    mbar_wait(&full_k[s], (kt / Tl::kStages) & 1);
    mbar_wait(&full_v[sp], ((kt - 1) / Tl::kStages) & 1);
    rescale();
    issue_qk(s);
    issue_pv(sp);
    wgmma_wait<1>();  // Q K^T done
    sync_s();
    softmax(kt);
    wgmma_wait<0>();  // P V done: stage sp is free
    sync_pv();
    release(sp);
    pack();
  }
  {
    const int sl = (n_iter - 1) % Tl::kStages;
    mbar_wait(&full_v[sl], ((n_iter - 1) / Tl::kStages) & 1);
    rescale();
    issue_pv(sl);
    wgmma_wait<0>();
    sync_pv();
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  // rows past Tq (zero-filled q) are dropped here
  __nv_bfloat16* og =
      static_cast<__nv_bfloat16*>(prm.o) + (long long)bh * prm.Tq * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = (i / 2) & 1;
    const int row = row0 + 8 * r;
    if (row < prm.Tq)
      *reinterpret_cast<uint32_t*>(og + (long long)row * D + 8 * (i / 4) +
                                   2 * c) =
          pack_bf16(o[i] * inv[r], o[i + 1] * inv[r]);
  }
  if (kLse && c == 0) {  // one lane of each quad holds the rows' m and l
    float* lse = prm.lse + (long long)bh * prm.Tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < prm.Tq)  // m back from log2 to natural log
        lse[row] = (m[r] == -INFINITY ? 0.f : m[r] * kLn2) +
                   logf(fmaxf(l[r], 1e-30f));
    }
  }
}

template <int D, int BK, bool kLse>
cudaError_t launch(const FwdParams& prm, cudaStream_t stream) {
  using Tl = Tiles<D, BK>;
  CUtensorMap mq, mk, mv;
  if (!encode_bf16_4d(&mq, prm.q, D, prm.Tq, prm.H, prm.B, prm.sqt, prm.sqh,
                      prm.sqb, kBQ) ||
      !encode_bf16_4d(&mk, prm.k, D, prm.Tk, prm.H, prm.B, prm.skt, prm.skh,
                      prm.skb, BK) ||
      !encode_bf16_4d(&mv, prm.v, D, prm.Tk, prm.H, prm.B, prm.svt, prm.svh,
                      prm.svb, BK))
    return cudaErrorInvalidValue;
  // the shared-memory opt-in is per function and device
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(configured >> dev & 1ull)) {
    err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D, BK, kLse>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tl::kSmem);
    if (err != cudaSuccess) return err;
    configured |= 1ull << dev;
  }
  dim3 grid(prm.B * prm.H, (prm.Tq + kBQ - 1) / kBQ);
  flash_fwd_sm90_kernel<D, BK, kLse>
      <<<grid, Tl::kThreads, Tl::kSmem, stream>>>(mq, mk, mv, prm,
                                                  prm.scale * kLog2e);
  return cudaGetLastError();
}

template <int D, int BK>
cudaError_t launch_tiles(const FwdParams& prm, cudaStream_t s) {
  return prm.lse ? launch<D, BK, true>(prm, s) : launch<D, BK, false>(prm, s);
}

}  // namespace

namespace flash {

cudaError_t fwd_bf16_sm90(const FwdParams& prm, int D, int block_k,
                          cudaStream_t s) {
  if (D == 64 && block_k == 64) return launch_tiles<64, 64>(prm, s);
  if (D == 64 && block_k == 128) return launch_tiles<64, 128>(prm, s);
  if (D == 128 && block_k == 64) return launch_tiles<128, 64>(prm, s);
  return cudaErrorInvalidValue;
}

}  // namespace flash
