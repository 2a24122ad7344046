// Flash attention forward, fp32, and the C entry point of both forwards.
//
// The bf16 forward, the main path of training and serving, is the Hopper
// kernel in flash_fwd_sm90.cu (TMA and wgmma), the counterpart of
// chainermn_tpu/ops/flash_attention.py::_flash_kernel and, with a non-null
// lse pointer, of ::_flash_kernel_lse.  This file keeps the fp32 forward,
// the parity path of the fp32 model and tests (wgmma takes no fp32
// inputs): the same function and numerics, lse = m_safe + log(max(l,
// 1e-30)) in fp32 when asked for (m_safe is 0 for a row with no live key,
// so such a row's out is 0 and its lse finite, -69.08).
//
// fp32 design: one block of 4 warps per (b*h, 64-row q tile), each warp
// owning 16 q rows; K/V tiles of 64 rows staged in padded shared memory
// (single-buffered 16-byte vector loads, the ragged edge zero-filled and
// masked), the products on CUDA cores in the mma C fragment layout, key
// tiles past the causal diagonal skipped.  Bound at the fp32 parity shape
// (B 2, H 4, T 256, D 64 causal): 0.07 GFLOP over 67 TFLOP/s (1.0 us).
//
// Plain C interface (bound with ctypes): the launcher returns
// cudaGetLastError(); it launches on the caller's stream and allocates
// nothing.  Strides are in elements; the last dimension must be dense and
// every row 16-byte aligned (the Python wrapper checks and copies if not).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_fwd.cuh"

namespace {

using flash::Pad;
using Params = flash::FwdParams;

constexpr int kBlockQ = 64;   // q rows per block
constexpr int kBlockK = 64;   // key rows per shared-memory tile
constexpr int kWarps = 4;     // 16 q rows per warp
constexpr int kThreads = kWarps * 32;

// Fragment layout (the mma C layout): lane = 4 * g + t holds, for n-tile
// j, columns 8j + 2t and 8j + 2t + 1 of rows g (entries 0, 1) and g + 8
// (entries 2, 3) of the warp's 16 rows.
template <typename T, int D>
struct Tile;

template <int D>
struct Tile<float, D> {
  using T = float;
  static constexpr int kLd = D + Pad<T>::value;
  const T* q0;  // the warp's 16 q rows in shared memory

  __device__ void load_q(const T* qs, int, int) { q0 = qs; }

  __device__ void qk(float (*s)[4], const T* ks, int g, int t) {
    const T* qr0 = q0 + g * kLd;
    const T* qr1 = qr0 + 8 * kLd;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      const T* k0 = ks + (8 * j + 2 * t) * kLd;
      const T* k1 = k0 + kLd;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int d = 0; d < D; ++d) {
        a0 = fmaf(qr0[d], k0[d], a0);
        a1 = fmaf(qr0[d], k1[d], a1);
        a2 = fmaf(qr1[d], k0[d], a2);
        a3 = fmaf(qr1[d], k1[d], a3);
      }
      s[j][0] = a0; s[j][1] = a1; s[j][2] = a2; s[j][3] = a3;
    }
  }

  // p goes through the warp's own [16, 64] shared scratch: every output
  // element needs a whole row of p, which is spread over four lanes.
  __device__ void pv(float (*o)[4], float (*p)[4], const T* vs,
                     float* ps, int g, int t) {
    constexpr int kPs = kBlockK + Pad<float>::value;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      ps[g * kPs + 8 * j + 2 * t] = p[j][0];
      ps[g * kPs + 8 * j + 2 * t + 1] = p[j][1];
      ps[(g + 8) * kPs + 8 * j + 2 * t] = p[j][2];
      ps[(g + 8) * kPs + 8 * j + 2 * t + 1] = p[j][3];
    }
    __syncwarp();
    const float* p0 = ps + g * kPs;
    const float* p1 = p0 + 8 * kPs;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const T* vc = vs + 8 * nd + 2 * t;
      float a0 = o[nd][0], a1 = o[nd][1], a2 = o[nd][2], a3 = o[nd][3];
      for (int kk = 0; kk < kBlockK; ++kk) {
        float v0 = vc[kk * kLd], v1 = vc[kk * kLd + 1];
        a0 = fmaf(p0[kk], v0, a0);
        a1 = fmaf(p0[kk], v1, a1);
        a2 = fmaf(p1[kk], v0, a2);
        a3 = fmaf(p1[kk], v1, a3);
      }
      o[nd][0] = a0; o[nd][1] = a1; o[nd][2] = a2; o[nd][3] = a3;
    }
    __syncwarp();
  }

};

template <typename T>
constexpr int scratch_floats() {
  return sizeof(T) == 4 ? kWarps * 16 * (kBlockK + Pad<float>::value) : 0;
}

template <typename T, int D>
constexpr size_t smem_bytes() {
  return 3 * kBlockK * (D + Pad<T>::value) * sizeof(T) +
         scratch_floats<T>() * sizeof(float);
}

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params prm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kLd = D + Pad<T>::value;
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kBlockQ * kLd;
  T* vs = ks + kBlockK * kLd;
  float* ps = reinterpret_cast<float*>(vs + kBlockK * kLd);

  // heaviest causal q tiles first: the last tiles scan the most keys
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / prm.H, h = bh % prm.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q_start = qt * kBlockQ;

  const T* qg = static_cast<const T*>(prm.q) + b * prm.sqb + h * prm.sqh +
                q_start * prm.sqt;
  const T* kg = static_cast<const T*>(prm.k) + b * prm.skb + h * prm.skh;
  const T* vg = static_cast<const T*>(prm.v) + b * prm.svb + h * prm.svh;
  T* og = static_cast<T*>(prm.o) + ((long long)bh * prm.Tq + q_start) * D;

  flash::load_tile<T, D, kBlockQ, kThreads>(qs, qg, prm.sqt,
                                            prm.Tq - q_start);
  __syncthreads();
  Tile<T, D> tile;
  tile.load_q(qs + warp * 16 * kLd, g, t);

  const int row0 = q_start + warp * 16 + g;  // this lane's two q rows:
  const int row1 = row0 + 8;                  // row0 and row0 + 8
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-lane partial sums, reduced at the end
  float o[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  const int n_kt = (prm.Tk + kBlockK - 1) / kBlockK;
  // only key tiles that intersect the causal triangle contribute
  const int last = prm.causal ? min(qt + 1, n_kt) : n_kt;
  float s[kBlockK / 8][4];
  for (int kt = 0; kt < last; ++kt) {
    const int k_start = kt * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    flash::load_tile<T, D, kBlockK, kThreads>(ks, kg + k_start * prm.skt,
                                              prm.skt, prm.Tk - k_start);
    flash::load_tile<T, D, kBlockK, kThreads>(vs, vg + k_start * prm.svt,
                                              prm.svt, prm.Tk - k_start);
    __syncthreads();

    tile.qk(s, ks, g, t);
    float mb[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k_start + 8 * j + 2 * t + (e & 1);
        const int qpos = e < 2 ? row0 : row1;
        const bool ok = kpos < prm.Tk && (!prm.causal || kpos <= qpos);
        s[j][e] = ok ? s[j][e] * prm.scale : -INFINITY;
        mb[e >> 1] = fmaxf(mb[e >> 1], s[j][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 1));
      mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 2));
      const float m_new = fmaxf(m[r], mb[r]);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      corr[r] = isfinite(m[r]) ? expf(m[r] - m_safe) : 0.f;
      m[r] = m_new;
      mb[r] = m_safe;  // reused below as the row's exponent offset
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        s[j][e] = isfinite(x) ? expf(x - mb[e >> 1]) : 0.f;
        ls[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ls[r];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      o[nd][0] *= corr[0]; o[nd][1] *= corr[0];
      o[nd][2] *= corr[1]; o[nd][3] *= corr[1];
    }
    tile.pv(o, s, vs, ps + warp * 16 * (kBlockK + Pad<float>::value), g, t);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  const int lr0 = warp * 16 + g;  // rows relative to the tile's output
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = 8 * nd + 2 * t;
    if (row0 < prm.Tq)
      flash::store2(og, (long long)lr0 * D + col, o[nd][0] * inv[0],
                    o[nd][1] * inv[0]);
    if (row1 < prm.Tq)
      flash::store2(og, (long long)(lr0 + 8) * D + col, o[nd][2] * inv[1],
                    o[nd][3] * inv[1]);
  }
  if (kLse && t == 0) {  // one lane of each quad holds the row's m and l
    float* lse = prm.lse + (long long)bh * prm.Tq;
    if (row0 < prm.Tq)
      lse[row0] = (isfinite(m[0]) ? m[0] : 0.f) + logf(fmaxf(l[0], 1e-30f));
    if (row1 < prm.Tq)
      lse[row1] = (isfinite(m[1]) ? m[1] : 0.f) + logf(fmaxf(l[1], 1e-30f));
  }
}

template <typename T, int D, bool kLse>
cudaError_t launch_as(const Params& prm, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D, kLse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((prm.Tq + kBlockQ - 1) / kBlockQ, prm.B * prm.H);
  flash_fwd_kernel<T, D, kLse><<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Params& prm, cudaStream_t stream) {
  return prm.lse ? launch_as<T, D, true>(prm, stream)
                 : launch_as<T, D, false>(prm, stream);
}

}  // namespace

// dtype: 0 = bfloat16 (flash_fwd_sm90.cu, key tiles of block_k), 1 =
// float32 (this file; block_k is not read).  lse: fp32 [B*H, Tq] output,
// or null for the forward without it.  Returns a cudaError_t (0 =
// success); cudaErrorInvalidValue for a dtype, head dim or key tile the
// kernels do not take, or strides a tensor map cannot describe.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int B,
    int H, int Tq, int Tk, int D, long long sqb, long long sqh,
    long long sqt, long long skb, long long skh, long long skt,
    long long svb, long long svh, long long svt, int causal, float scale,
    int block_k, void* stream) {
  const Params prm{q, k, v, o, lse, B, H, Tq, Tk, sqb, sqh, sqt,
                   skb, skh, skt, svb, svh, svt, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return flash::fwd_bf16_sm90(prm, D, block_k, s);
  if (dtype == 1 && D == 64) return launch<float, 64>(prm, s);
  if (dtype == 1 && D == 128) return launch<float, 128>(prm, s);
  return cudaErrorInvalidValue;
}
