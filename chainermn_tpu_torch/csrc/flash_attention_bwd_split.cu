// Split flash attention backward for Hopper (sm_90a): the fp32 kernels of
// the two-kernel lowering that CHAINERMN_TPU_FLASH_BWD=split selects, and
// the C entry points of both passes.  They are the CUDA counterparts of
// chainermn_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel (the dq pass)
// and ::_flash_bwd_dkv_kernel (the dk/dv pass).  In bf16 the entry points
// launch the Hopper kernels (TMA and wgmma): the dq pass of
// flash_bwd_dq_sm90.cu and the dk/dv pass of flash_bwd_sm90.cu (the fused
// kernel with its dq part switched off).  This file keeps their fp32
// versions on CUDA cores (wgmma takes no fp32 inputs), the parity path of
// the fp32 model and tests.
//
// What they compute, for q/g [B, H, Tq, D], k/v [B, H, Tk, D], the
// forward's row statistic lse [B*H, Tq] (fp32) and delta = rowsum(g * out)
// - g_lse [B*H, Tq] (fp32, the delta pass of flash_bwd_sm90.cu):
// each pass recomputes, for every live (q tile, key tile) pair,
//     p  = exp(scale * q k^T - lse)      (0 where masked: causal, ragged)
//     ds = p * (g v^T - delta)
// and the dq pass sums dq = scale * ds k over the key tiles, the dk/dv pass
// dv = p^T g and dk = scale * ds^T q over the q tiles; dq, dk and dv are
// written once, in the inputs' dtype, without atomics (bitwise
// deterministic).
//
// fp32 design: one block of 4 warps per (b*h, 64-row tile), each warp
// owning 16 rows; the dq pass is q-major (the q tile and its g rows, then
// per key tile the k and v tiles in padded shared memory), the dk/dv pass
// key-major (the k and v tiles, then per q tile the q and g tiles and
// their lse and delta rows), so that p, ds (dq pass) or p^T, ds^T (dk/dv
// pass) come out of the score product in the fragment layout of the
// product that consumes them (flash::BwdOps).  Single-buffered 16-byte
// loads with the ragged edge zero-filled and masked; under causal the
// loops skip the tiles past the diagonal.  Bound at the fp32 parity shape
// (B 2, H 4, T 256, D 64, causal): 3 and 4 products, 0.10 and 0.13 GFLOP
// over 67 TFLOP/s (1.5 and 2.0 us).
//
// Plain C interface (bound with ctypes), like the other kernels: each
// launcher returns cudaGetLastError(), launches on the caller's stream and
// allocates nothing.  Strides are in elements; the last dimension must be
// dense and every row 16-byte aligned (the Python wrapper checks).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bwd.cuh"
#include "flash_common.cuh"

namespace {

using flash::BwdOps;

constexpr int kBlock = flash::kBwdTile;  // q rows and keys per tile
constexpr int kWarps = 4;                // 16 rows per warp
constexpr int kThreads = kWarps * 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const float* lse;    // [B*H, Tq]
  const float* delta;  // [B*H, Tq]
  void* o0;            // dq [B*H, Tq, D], or dk [B*H, Tk, D]
  void* o1;            // dv [B*H, Tk, D] (the dk/dv pass only)
  int H, Tq, Tk;
  long long sqb, sqh, sqt;
  long long skb, skh, skt;
  long long svb, svh, svt;
  long long sgb, sgh, sgt;
  int causal;
  float scale;
};

// Four [64, D] tiles, the per-warp staging rows of the fp32 products and
// the lse/delta rows of the dk/dv pass's q tile.
template <typename T, int D>
constexpr size_t smem_bytes() {
  return 4 * kBlock * BwdOps<T, D>::kLd * sizeof(T) +
         kBlock * BwdOps<T, D>::kLdS * sizeof(T) + 2 * kBlock * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Params prm) {
  using O = BwdOps<T, D>;
  constexpr int kLd = O::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* gs = qs + kBlock * kLd;
  T* ks = gs + kBlock * kLd;
  T* vs = ks + kBlock * kLd;
  T* stg = vs + kBlock * kLd;  // fp32: each warp's ds rows for ds . k

  // heaviest causal q tiles first: the last tiles scan the most keys
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / prm.H, h = bh % prm.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q_start = qt * kBlock;

  flash::load_tile<T, D, kBlock, kThreads>(
      qs, static_cast<const T*>(prm.q) + b * prm.sqb + h * prm.sqh +
              q_start * prm.sqt,
      prm.sqt, prm.Tq - q_start);
  flash::load_tile<T, D, kBlock, kThreads>(
      gs, static_cast<const T*>(prm.g) + b * prm.sgb + h * prm.sgh +
              q_start * prm.sgt,
      prm.sgt, prm.Tq - q_start);
  const T* kg = static_cast<const T*>(prm.k) + b * prm.skb + h * prm.skh;
  const T* vg = static_cast<const T*>(prm.v) + b * prm.svb + h * prm.svh;

  const int row0 = q_start + warp * 16 + g;  // this lane's two q rows:
  const int row1 = row0 + 8;                  // row0 and row0 + 8
  const float* lse_g = prm.lse + (long long)bh * prm.Tq;
  const float* delta_g = prm.delta + (long long)bh * prm.Tq;
  const float lse[2] = {row0 < prm.Tq ? lse_g[row0] : 0.f,
                        row1 < prm.Tq ? lse_g[row1] : 0.f};
  const float delta[2] = {row0 < prm.Tq ? delta_g[row0] : 0.f,
                          row1 < prm.Tq ? delta_g[row1] : 0.f};
  const T* qw = qs + warp * 16 * kLd;  // this warp's 16 q rows
  const T* gw = gs + warp * 16 * kLd;
  T* sw = stg + warp * 16 * O::kLdS;

  float dq[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
    dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;

  const int n_kt = (prm.Tk + kBlock - 1) / kBlock;
  // only key tiles that intersect the causal triangle contribute (q and
  // key tiles are both kBlock rows, so the last one is tile qt)
  const int last = prm.causal ? min(qt + 1, n_kt) : n_kt;
  float s[kBlock / 8][4], dp[kBlock / 8][4];
  for (int kt = 0; kt < last; ++kt) {
    const int k_start = kt * kBlock;
    __syncthreads();  // the previous tile's readers are done
    flash::load_tile<T, D, kBlock, kThreads>(ks, kg + k_start * prm.skt,
                                             prm.skt, prm.Tk - k_start);
    flash::load_tile<T, D, kBlock, kThreads>(vs, vg + k_start * prm.svt,
                                             prm.svt, prm.Tk - k_start);
    __syncthreads();

    O::nt(s, qw, ks, g, t);  // s = q k^T (unscaled)
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = e < 2 ? row0 : row1;
        const int kpos = k_start + 8 * j + 2 * t + (e & 1);
        const bool ok = qpos < prm.Tq && kpos < prm.Tk &&
                        (!prm.causal || kpos <= qpos);
        s[j][e] = ok ? expf(s[j][e] * prm.scale - lse[e >> 1]) : 0.f;  // p
      }
    }
    O::nt(dp, gw, vs, g, t);  // g v^T
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = s[j][e] * (dp[j][e] - delta[e >> 1]);  // ds
    }
    O::nn(dq, dp, ks, sw, lane);  // dq += ds k
  }

  T* dqg = static_cast<T*>(prm.o0) + (long long)bh * prm.Tq * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = 8 * nd + 2 * t;
    if (row0 < prm.Tq)
      flash::store2(dqg, (long long)row0 * D + col, dq[nd][0] * prm.scale,
                    dq[nd][1] * prm.scale);
    if (row1 < prm.Tq)
      flash::store2(dqg, (long long)row1 * D + col, dq[nd][2] * prm.scale,
                    dq[nd][3] * prm.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const Params prm) {
  using O = BwdOps<T, D>;
  constexpr int kLd = O::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kBlock * kLd;
  T* qs = vs + kBlock * kLd;
  T* gs = qs + kBlock * kLd;
  T* stg = gs + kBlock * kLd;  // fp32: each warp's p^T / ds^T rows
  float* lse_s = reinterpret_cast<float*>(stg + kBlock * O::kLdS);
  float* delta_s = lse_s + kBlock;

  const int kt = blockIdx.x;  // causal: the first key tiles are heaviest
  const int bh = blockIdx.y;
  const int b = bh / prm.H, h = bh % prm.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k_start = kt * kBlock;

  flash::load_tile<T, D, kBlock, kThreads>(
      ks, static_cast<const T*>(prm.k) + b * prm.skb + h * prm.skh +
              k_start * prm.skt,
      prm.skt, prm.Tk - k_start);
  flash::load_tile<T, D, kBlock, kThreads>(
      vs, static_cast<const T*>(prm.v) + b * prm.svb + h * prm.svh +
              k_start * prm.svt,
      prm.svt, prm.Tk - k_start);
  const T* qg = static_cast<const T*>(prm.q) + b * prm.sqb + h * prm.sqh;
  const T* gg = static_cast<const T*>(prm.g) + b * prm.sgb + h * prm.sgh;
  const float* lse_g = prm.lse + (long long)bh * prm.Tq;
  const float* delta_g = prm.delta + (long long)bh * prm.Tq;

  const T* kw = ks + warp * 16 * kLd;  // this warp's 16 keys
  const T* vw = vs + warp * 16 * kLd;
  T* sw = stg + warp * 16 * O::kLdS;
  const int key0 = k_start + warp * 16 + g;  // this lane's two keys:
  const int key1 = key0 + 8;                  // key0 and key0 + 8

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    dk[nd][0] = dk[nd][1] = dk[nd][2] = dk[nd][3] = 0.f;
    dv[nd][0] = dv[nd][1] = dv[nd][2] = dv[nd][3] = 0.f;
  }

  const int n_qt = (prm.Tq + kBlock - 1) / kBlock;
  // under causal only q tiles at or after the key tile reach it
  const int first = prm.causal ? kt : 0;
  float s[kBlock / 8][4], dp[kBlock / 8][4];
  for (int qt = first; qt < n_qt; ++qt) {
    const int q_start = qt * kBlock;
    __syncthreads();  // the previous step's readers are done
    flash::load_tile<T, D, kBlock, kThreads>(qs, qg + q_start * prm.sqt,
                                             prm.sqt, prm.Tq - q_start);
    flash::load_tile<T, D, kBlock, kThreads>(gs, gg + q_start * prm.sgt,
                                             prm.sgt, prm.Tq - q_start);
    for (int i = threadIdx.x; i < kBlock; i += kThreads) {
      const bool live = q_start + i < prm.Tq;
      lse_s[i] = live ? lse_g[q_start + i] : 0.f;
      delta_s[i] = live ? delta_g[q_start + i] : 0.f;
    }
    __syncthreads();

    O::nt(s, kw, qs, g, t);  // s^T = k q^T (unscaled)
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
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
    O::nn(dv, s, gs, sw, lane);  // dv += p^T g
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = s[j][e] * (dp[j][e] - delta_s[8 * j + 2 * t + (e & 1)]);
    }
    O::nn(dk, dp, qs, sw, lane);  // dk += ds^T q
  }

  T* dkg = static_cast<T*>(prm.o0) + (long long)bh * prm.Tk * D;
  T* dvg = static_cast<T*>(prm.o1) + (long long)bh * prm.Tk * D;
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

// One grid row per (b*h); the dq pass tiles Tq, the dk/dv pass Tk.
template <typename T, int D, bool kDq>
cudaError_t launch(const Params& prm, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  void (*kernel)(const Params) =
      kDq ? &flash_bwd_dq_kernel<T, D> : &flash_bwd_dkv_kernel<T, D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid(((kDq ? prm.Tq : prm.Tk) + kBlock - 1) / kBlock, B * prm.H);
  kernel<<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

// fp32 only: the bf16 passes are the Hopper kernels
template <bool kDq>
int dispatch(const Params& prm, int dtype, int B, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64) return launch<float, 64, kDq>(prm, B, s);
  if (dtype == 1 && D == 128) return launch<float, 128, kDq>(prm, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32.  dq: [B*H, Tq, D] in the input dtype,
// written whole (scaled).  bf16 runs the Hopper kernel of
// flash_bwd_dq_sm90.cu.  Returns a cudaError_t (0 = success);
// cudaErrorInvalidValue for a dtype or head dim without an instantiation.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* g,
    const float* lse, const float* delta, void* dq, int dtype, int B, int H,
    int Tq, int Tk, int D, long long sqb, long long sqh, long long sqt,
    long long skb, long long skh, long long skt, long long svb,
    long long svh, long long svt, long long sgb, long long sgh,
    long long sgt, int causal, float scale, void* stream) {
  if (dtype == 0) {
    const flash::BwdParams prm{q,   k,   v,   g,       lse,     delta,
                               dq,  nullptr, nullptr, B,   H,   Tq,
                               Tk,  sqb, sqh, sqt,     skb,     skh,
                               skt, svb, svh, svt,     sgb,     sgh,
                               sgt, causal, scale};
    return flash::bwd_dq_bf16_sm90(prm, D, static_cast<cudaStream_t>(stream));
  }
  Params prm{q,   k,   v,   g,   lse, delta, dq,  nullptr, H,   Tq,
             Tk,  sqb, sqh, sqt, skb, skh,   skt, svb,     svh, svt,
             sgb, sgh, sgt, causal, scale};
  return dispatch<true>(prm, dtype, B, D, stream);
}

// dk/dv: [B*H, Tk, D] in the input dtype, written whole (dk scaled).
// bf16 runs the Hopper kernel of flash_bwd_sm90.cu without its dq part.
extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* g,
    const float* lse, const float* delta, void* dk, void* dv, int dtype,
    int B, int H, int Tq, int Tk, int D, long long sqb, long long sqh,
    long long sqt, long long skb, long long skh, long long skt,
    long long svb, long long svh, long long svt, long long sgb,
    long long sgh, long long sgt, int causal, float scale, void* stream) {
  if (dtype == 0) {
    const flash::BwdParams prm{q,   k,   v,   g,   lse, delta,   nullptr,
                               dk,  dv,  B,   H,   Tq,  Tk,      sqb,
                               sqh, sqt, skb, skh, skt, svb,     svh,
                               svt, sgb, sgh, sgt, causal, scale};
    return flash::bwd_bf16_sm90(prm, D, false,
                                static_cast<cudaStream_t>(stream));
  }
  Params prm{q,   k,   v,   g,   lse, delta, dk,  dv,  H,   Tq,
             Tk,  sqb, sqh, sqt, skb, skh,   skt, svb, svh, svt,
             sgb, sgh, sgt, causal, scale};
  return dispatch<false>(prm, dtype, B, D, stream);
}
