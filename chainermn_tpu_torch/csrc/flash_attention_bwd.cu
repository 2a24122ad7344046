// Fused flash attention backward: the C entry point of the counterpart of
// chainermn_tpu/ops/flash_attention.py::_flash_bwd_fused_kernel (with the
// XLA sum of its dq partial planes, scale and cast folded in), and its
// fp32 kernel.
//
// bf16, the main path of training, is the Hopper kernel in
// flash_bwd_sm90.cu (a TMA-fed Q/dO ring, wgmma for the five products, dq
// added per tile by a bulk reduce), followed by its dq epilogue.  This
// file keeps the fp32 kernel, the parity path of the fp32 model and tests
// (wgmma takes no fp32 inputs).
//
// What it computes, for q/g [B, H, Tq, D], k/v [B, H, Tk, D], the forward's
// row statistic lse [B*H, Tq] (fp32) and delta = rowsum(g * out) - g_lse
// [B*H, Tq] (fp32, the delta pass of flash_bwd_sm90.cu): for every (q tile,
// key tile) pair, once,
//     p  = exp(scale * q k^T - lse)      (0 where masked: causal, ragged)
//     ds = p * (g v^T - delta)
//     dv += p^T g,   dk += ds^T q,   dq += ds k
// with dk and dq multiplied by `scale` at the end.  The JAX kernel's points
// of rounding are kept: q/k/v/g enter the dots in their storage dtype with
// fp32 accumulation, p is cast to g's dtype before the dv dot and ds to
// q's/k's dtype before the dk and dq dots.
//
// fp32 design: one block of 4 warps per (b*h, 64-row key tile); each warp
// owns 16 keys.  The key tile's k and v stay in shared memory, dk and dv
// accumulate in registers across the q tiles (under `causal` the q loop
// starts at the first tile that reaches the key tile).  Each step stages a
// 64-row q tile and its g rows, lse and delta in padded shared memory and
// computes the score tile key-major, s^T = k q^T, on CUDA cores in the mma
// C fragment layout (flash::BwdOps), p^T and ds^T staged through shared
// memory; each block adds its dq contribution into the zeroed fp32
// [B*H, Tq, D] accumulator with atomicAdd.  Bound at the fp32 parity shape
// (B 2, H 4, T 256, D 64 causal): 0.17 GFLOP over 67 TFLOP/s (2.5 us).
//
// Plain C interface (bound with ctypes): the launcher returns
// cudaGetLastError(), launches on the caller's stream and allocates
// nothing.  Strides are in elements; the last dimension must be dense and
// every row 16-byte aligned (the Python wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bwd.cuh"
#include "flash_common.cuh"

namespace {

using flash::BwdOps;

constexpr int kBlockK = flash::kBwdTile;  // key rows per block
constexpr int kBlockQ = flash::kBwdTile;  // q rows per inner step
constexpr int kWarps = 4;                 // 16 keys per warp
constexpr int kThreads = kWarps * 32;

using Params = flash::BwdParams;  // dq: the zeroed fp32 accumulator

// out = ds . k for q rows qw..qw+15 of the tile: ds^T is staged at s
// ([64 keys, kLdS], every warp's rows); k is the block's [64, D] tile.
// The other products are flash::BwdOps.
template <typename T, int D>
struct StagedDq;

template <int D>
struct StagedDq<float, D> {
  using T = float;
  static constexpr int kLd = BwdOps<T, D>::kLd;
  static constexpr int kLdS = BwdOps<T, D>::kLdS;

  __device__ static void dq(float (*out)[4], const T* s, const T* kb, int qw,
                            int lane) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const T* kc = kb + 8 * nd + 2 * t;
      float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
      for (int key = 0; key < kBlockK; ++key) {
        const float d0 = s[key * kLdS + qw + g];
        const float d1 = s[key * kLdS + qw + g + 8];
        const float k0 = kc[key * kLd], k1 = kc[key * kLd + 1];
        c0 = fmaf(d0, k0, c0);
        c1 = fmaf(d0, k1, c1);
        c2 = fmaf(d1, k0, c2);
        c3 = fmaf(d1, k1, c3);
      }
      out[nd][0] = c0; out[nd][1] = c1; out[nd][2] = c2; out[nd][3] = c3;
    }
  }
};

template <typename T, int D>
constexpr size_t smem_bytes() {
  return (2 * kBlockK + 2 * kBlockQ) * BwdOps<T, D>::kLd * sizeof(T) +
         kBlockK * BwdOps<T, D>::kLdS * sizeof(T) +
         2 * kBlockQ * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kernel(const Params prm) {
  using O = BwdOps<T, D>;
  constexpr int kLd = O::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kBlockK * kLd;
  T* qs = vs + kBlockK * kLd;
  T* gs = qs + kBlockQ * kLd;
  T* dss = gs + kBlockQ * kLd;  // ds^T (and, for fp32, p^T) staging
  float* lse_s = reinterpret_cast<float*>(dss + kBlockK * O::kLdS);
  float* delta_s = lse_s + kBlockQ;

  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / prm.H, h = bh % prm.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k_start = kt * kBlockK;

  flash::load_tile<T, D, kBlockK, kThreads>(
      ks, static_cast<const T*>(prm.k) + b * prm.skb + h * prm.skh +
              k_start * prm.skt,
      prm.skt, prm.Tk - k_start);
  flash::load_tile<T, D, kBlockK, kThreads>(
      vs, static_cast<const T*>(prm.v) + b * prm.svb + h * prm.svh +
              k_start * prm.svt,
      prm.svt, prm.Tk - k_start);
  const T* qg = static_cast<const T*>(prm.q) + b * prm.sqb + h * prm.sqh;
  const T* gg = static_cast<const T*>(prm.g) + b * prm.sgb + h * prm.sgh;
  const float* lse_g = prm.lse + (long long)bh * prm.Tq;
  const float* delta_g = prm.delta + (long long)bh * prm.Tq;
  float* dq_g = static_cast<float*>(prm.dq) + (long long)bh * prm.Tq * D;

  const T* kw = ks + warp * 16 * kLd;  // this warp's 16 keys
  const T* vw = vs + warp * 16 * kLd;
  T* dsw = dss + warp * 16 * O::kLdS;
  const int key0 = k_start + warp * 16 + g;  // this lane's two keys:
  const int key1 = key0 + 8;                  // key0 and key0 + 8

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    dk[nd][0] = dk[nd][1] = dk[nd][2] = dk[nd][3] = 0.f;
    dv[nd][0] = dv[nd][1] = dv[nd][2] = dv[nd][3] = 0.f;
  }

  const int n_qt = (prm.Tq + kBlockQ - 1) / kBlockQ;
  // under causal only q tiles at or after the key tile reach it
  // (kBlockQ == kBlockK, so that is tile kt)
  const int first = prm.causal ? kt : 0;
  float s[kBlockQ / 8][4], dp[kBlockQ / 8][4];
  for (int qt = first; qt < n_qt; ++qt) {
    const int q_start = qt * kBlockQ;
    __syncthreads();  // the previous step's readers are done
    flash::load_tile<T, D, kBlockQ, kThreads>(qs, qg + q_start * prm.sqt,
                                              prm.sqt, prm.Tq - q_start);
    flash::load_tile<T, D, kBlockQ, kThreads>(gs, gg + q_start * prm.sgt,
                                              prm.sgt, prm.Tq - q_start);
    for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
      const bool live = q_start + i < prm.Tq;
      lse_s[i] = live ? lse_g[q_start + i] : 0.f;
      delta_s[i] = live ? delta_g[q_start + i] : 0.f;
    }
    __syncthreads();

    O::nt(s, kw, qs, g, t);  // s^T = k q^T (unscaled)
#pragma unroll
    for (int j = 0; j < kBlockQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1);
        const int qpos = q_start + qi;
        const int kpos = e < 2 ? key0 : key1;
        const bool ok = qpos < prm.Tq && kpos < prm.Tk &&
                        (!prm.causal || kpos <= qpos);
        s[j][e] = ok ? expf(s[j][e] * prm.scale - lse_s[qi]) : 0.f;  // p^T
      }
    }
    O::nt(dp, vw, gs, g, t);  // (g v^T)^T
    O::nn(dv, s, gs, dsw, lane);  // dv += p^T g
#pragma unroll
    for (int j = 0; j < kBlockQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[j][e] = s[j][e] * (dp[j][e] - delta_s[8 * j + 2 * t + (e & 1)]);
      }
    }
    O::nn(dk, dp, qs, dsw, lane);  // dk += ds^T q
    O::stage(dsw, dp, g, t);
    __syncthreads();  // every warp's ds^T rows are staged

    float dqa[D / 8][4];
    StagedDq<T, D>::dq(dqa, dss, ks, warp * 16, lane);
    const int r0 = q_start + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int col = 8 * nd + 2 * t;
      if (r0 < prm.Tq) {
        atomicAdd(dq_g + (long long)r0 * D + col, dqa[nd][0]);
        atomicAdd(dq_g + (long long)r0 * D + col + 1, dqa[nd][1]);
      }
      if (r1 < prm.Tq) {
        atomicAdd(dq_g + (long long)r1 * D + col, dqa[nd][2]);
        atomicAdd(dq_g + (long long)r1 * D + col + 1, dqa[nd][3]);
      }
    }
  }

  T* dkg = static_cast<T*>(prm.dk) + (long long)bh * prm.Tk * D;
  T* dvg = static_cast<T*>(prm.dv) + (long long)bh * prm.Tk * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = 8 * nd + 2 * t;
    if (key0 < prm.Tk) {
      const long long i = (long long)key0 * D + col;
      flash::store2(dkg, i, dk[nd][0] * prm.scale, dk[nd][1] * prm.scale);
      flash::store2(dvg, i, dv[nd][0], dv[nd][1]);
    }
    if (key1 < prm.Tk) {
      const long long i = (long long)key1 * D + col;
      flash::store2(dkg, i, dk[nd][2] * prm.scale, dk[nd][3] * prm.scale);
      flash::store2(dvg, i, dv[nd][2], dv[nd][3]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& prm, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((prm.Tk + kBlockK - 1) / kBlockK, prm.B * prm.H);
  flash_bwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16 (flash_bwd_sm90.cu), 1 = float32.  dq_acc: fp32
// [B*H, Tq, D], zeroed (the delta pass does it); it receives the unscaled
// sum of ds . k, and the epilogue writes dq = scale * dq_acc in the input
// dtype.  dk/dv: [B*H, Tk, D] in the input dtype.  Returns a cudaError_t
// (0 = success); cudaErrorInvalidValue for a dtype or head dim without an
// instantiation.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* g,
    const float* lse, const float* delta, float* dq_acc, void* dq, void* dk,
    void* dv, int dtype, int B, int H, int Tq, int Tk, int D, long long sqb,
    long long sqh, long long sqt, long long skb, long long skh,
    long long skt, long long svb, long long svh, long long svt,
    long long sgb, long long sgh, long long sgt, int causal, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params prm{q,   k,   v,   g,   lse, delta, dq_acc, dk,  dv,
                   B,   H,   Tq,  Tk,  sqb, sqh,   sqt,    skb, skh,
                   skt, svb, svh, svt, sgb, sgh,   sgt,    causal, scale};
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = flash::bwd_bf16_sm90(prm, D, true, s);
  if (dtype == 1 && D == 64) err = launch<float, 64>(prm, s);
  if (dtype == 1 && D == 128) err = launch<float, 128>(prm, s);
  if (err != cudaSuccess) return err;
  return flash::bwd_dq_epilogue(dq_acc, dq, dtype, (long long)B * H * Tq * D,
                                scale, s);
}
