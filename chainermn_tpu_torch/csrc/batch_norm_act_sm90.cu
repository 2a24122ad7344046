// Batch normalization in training with its activation fused, over
// channel-innermost activations (NHWC, or (N, C)), for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package's batch norm is plain jnp
// (chainermn_tpu/nn/functions.py::batch_moments and _apply_bn), which XLA
// fuses on the TPU.  PyTorch runs the same arithmetic as a dozen separate
// passes over fp32 copies of the bf16 activations, forward and backward:
// most of a ResNet-50 training step on the card.  These kernels do it in
// two passes each way.
//
// What it computes, for x [R, C] (R rows, C channels, C % 8 == 0), fp32
// gamma, beta and running statistics, and act one of: none, relu, or the
// residual s [R, C] added before the relu (a bottleneck block's
// relu(bn(c) + shortcut)):
//   forward   mean, var (population) over the rows, rstd = 1/sqrt(var+eps),
//             a = gamma rstd, y = act((x - mean) a + beta [+ s]),
//             avg_mean and avg_var moved by Chainer's decay with the
//             unbiased m/(m-1) variance (when their pointers are given)
//   backward  g = dy relu'(pre) with pre recomputed from x (relu' is 1/2 at
//             exactly 0, as torch.maximum splits a tie), x^ = (x - mean) rstd,
//             dbeta = sum g, dgamma = sum g x^,
//             dx = a (g - dbeta/m - x^ dgamma/m), ds = g
//
// Bound on an H100 SXM (3.35 TB/s HBM): bytes.  Every kernel does a few
// floating-point operations per element read, so its least time is the
// bytes it must move: 2 B an element read for the statistics, 4 (6 with s)
// for the apply, 4 (8 with s, which also writes ds) for the backward's
// reduction and 6 for dx.
//
// How the design answers it:
// - A thread holds 8 contiguous channels, read and written with 16-byte
//   vectors (two for fp32); a block of 256 threads is 8 channel groups (64
//   channels) by 32 rows, so a warp reads whole 128-byte row segments.
//   Narrower C takes fewer groups and more rows.  The grid is channel tiles
//   by row splits, sized from Python (ops/batch_norm.py::_geometry) to ~4
//   blocks an SM; each thread keeps 4 rows of loads in flight.
// - All arithmetic is fp32 in registers; an output is rounded once.
// - The statistics are Welford moments per thread, merged by Chan's rule
//   (which does not cancel as E[x^2] - mean^2 does) across the block in
//   shared memory, then across the row splits by the last block of each
//   channel tile to finish (a counter per tile, reset by that block): no
//   second launch, and the partials merge in a fixed order, so the result
//   is bitwise repeatable.  The backward's sums merge the same way, with no
//   float atomics.  The last block also folds what the second pass needs
//   (a, and the backward's two dx coefficients) and moves the running
//   statistics.
// - In the residual variant the reduction writes ds = g, which is exact in
//   the activation dtype (dy times 0, 1/2 or 1), and the dx pass reads it
//   in place of dy and the mask, as the plain variant.
// Kernel names carry bn_fw or bn_bw: the benchmark's bn_act_ms reads them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a block
constexpr int kVec = 8;        // channels a thread holds
constexpr int kUnroll = 4;     // rows a thread has in flight

enum Act { kNone = 0, kRelu = 1, kResidualRelu = 2 };

// 8 channels as loaded: one 16-byte vector of bf16 or two of fp32, kept
// packed while the loads are in flight and unpacked to fp32 at use.
template <typename T>
struct Raw;
template <>
struct Raw<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void unpack(float (&v)[kVec]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Raw<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void unpack(float (&v)[kVec]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void load8f(const float* p, float (&v)[kVec]) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) v[i] = p[i];
}

// The pre-activation, written once for both directions so that the
// backward's recompute is bitwise the forward's.
__device__ __forceinline__ float pre_act(float x, float mean, float a,
                                         float beta) {
  return __fmaf_rn(x - mean, a, beta);
}

// d relu(pre) / d pre as torch.maximum(pre, 0) has it: 0 below, 1/2 at a
// tie, 1 above (and for NaN).
__device__ __forceinline__ float relu_grad(float pre) {
  return pre < 0.f ? 0.f : (pre == 0.f ? 0.5f : 1.f);
}

// Moments of a set: count, mean, sum of squared deviations.
struct Moments {
  float n, mean, m2;
};

// Chan's merge of (nb, mb, m2b) into acc.
__device__ __forceinline__ void chan_merge(Moments& acc, float nb, float mb,
                                           float m2b) {
  if (nb == 0.f) return;
  const float n = acc.n + nb;
  const float d = mb - acc.mean;
  const float r = nb / n;
  acc.mean = __fmaf_rn(d, r, acc.mean);
  acc.m2 = acc.m2 + m2b + d * d * acc.n * r;
  acc.n = n;
}

// The block's geometry: tx channel groups of 8 by ty = kThreads / tx rows;
// a tile of ct = 8 tx channels; this thread's first channel c0.
struct Tile {
  int ty, ct, lane, row, c0;
  long long r_begin, r_end;
  __device__ Tile(int tx, long long R, int C, long long rps) {
    ty = kThreads / tx;
    ct = tx * kVec;
    lane = threadIdx.x % tx;
    row = threadIdx.x / tx;
    c0 = blockIdx.x * ct + lane * kVec;
    r_begin = blockIdx.y * rps;
    r_end = r_begin + rps < R ? r_begin + rps : R;
  }
  __device__ bool live(int C) const { return c0 < C; }
};

// Rows of split s.
__device__ __forceinline__ float split_rows(int s, long long R,
                                            long long rps) {
  const long long b = s * rps;
  const long long e = b + rps < R ? b + rps : R;
  return static_cast<float>(e - b);
}

// Shared memory of the reductions: a (mean, m2) or (sum, sum) pair per
// (row lane, channel), the row lanes' counts, and the parts' results.
struct Shared {
  float2 lane[kThreads * kVec];
  float count[kThreads];
  float3 part[kThreads];
  int last;
};

// True in the last block of this channel tile to finish (after every
// thread has stored its partials); that block resets the counter.
__device__ __forceinline__ bool last_block(int* counters, Shared& sh) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int done = atomicAdd(&counters[blockIdx.x], 1);
    sh.last = done == static_cast<int>(gridDim.y) - 1;
    if (sh.last) counters[blockIdx.x] = 0;
  }
  __syncthreads();
  if (sh.last) __threadfence();
  return sh.last;
}

// Forward, pass 1: the batch statistics.  stats [4, C]: mean, var, rstd, a.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_fw_stats_kernel(const T* __restrict__ x, long long R, int C, int tx,
                       long long rps, const float* __restrict__ gamma,
                       float* avg_mean, float* avg_var, float eps,
                       float decay, float one_minus_decay, float unbias,
                       float2* part, int* counters, float* stats) {
  __shared__ Shared sh;
  const Tile t(tx, R, C, rps);
  float n = 0.f, mean[kVec], m2[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) mean[i] = m2[i] = 0.f;
  if (t.live(C)) {
    for (long long r = t.r_begin + t.row; r < t.r_end;
         r += kUnroll * t.ty) {
      Raw<T> raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long rr = r + u * t.ty;
        if (rr < t.r_end) raw[u].load(x + rr * C + t.c0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * t.ty < t.r_end) {
          float v[kVec];
          raw[u].unpack(v);
          n += 1.f;
          const float inv = __frcp_rn(n);
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            const float d = v[i] - mean[i];
            mean[i] = __fmaf_rn(d, inv, mean[i]);
            m2[i] = __fmaf_rn(d, v[i] - mean[i], m2[i]);
          }
        }
      }
    }
  }
  // across the block's row lanes: each of P parts merges ty / P lanes of
  // one channel, then the first part merges the parts, in a fixed order
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    sh.lane[t.row * t.ct + t.lane * kVec + i] = make_float2(mean[i], m2[i]);
  if (t.lane == 0) sh.count[t.row] = n;
  __syncthreads();
  const int P = kThreads / t.ct, cl = threadIdx.x % t.ct, p = threadIdx.x / t.ct;
  const int per = t.ty / P;
  Moments acc{0.f, 0.f, 0.f};
  for (int k = p * per; k < (p + 1) * per; ++k) {
    const float2 e = sh.lane[k * t.ct + cl];
    chan_merge(acc, sh.count[k], e.x, e.y);
  }
  sh.part[p * t.ct + cl] = make_float3(acc.n, acc.mean, acc.m2);
  __syncthreads();
  const int c = blockIdx.x * t.ct + cl;
  if (p == 0 && c < C) {
    Moments b{0.f, 0.f, 0.f};
    for (int q = 0; q < P; ++q) {
      const float3 e = sh.part[q * t.ct + cl];
      chan_merge(b, e.x, e.y, e.z);
    }
    part[static_cast<long long>(blockIdx.y) * C + c] = make_float2(b.mean, b.m2);
  }
  if (!last_block(counters, sh)) return;
  // across the splits: part p takes splits p, p + P, ...
  Moments s{0.f, 0.f, 0.f};
  if (c < C) {
    for (int k = p; k < static_cast<int>(gridDim.y); k += P) {
      const float2 e = __ldcg(&part[static_cast<long long>(k) * C + c]);
      chan_merge(s, split_rows(k, R, rps), e.x, e.y);
    }
  }
  sh.part[p * t.ct + cl] = make_float3(s.n, s.mean, s.m2);
  __syncthreads();
  if (p == 0 && c < C) {
    Moments b{0.f, 0.f, 0.f};
    for (int q = 0; q < P; ++q) {
      const float3 e = sh.part[q * t.ct + cl];
      chan_merge(b, e.x, e.y, e.z);
    }
    const float var = fmaxf(b.m2 / b.n, 0.f);
    const float rstd = 1.f / sqrtf(var + eps);
    stats[c] = b.mean;
    stats[C + c] = var;
    stats[2 * C + c] = rstd;
    stats[3 * C + c] = gamma[c] * rstd;
    if (avg_mean != nullptr) {
      // avg = decay avg + (1 - decay) batch, rounded as the torch update
      avg_mean[c] = __fadd_rn(__fmul_rn(avg_mean[c], decay),
                              __fmul_rn(one_minus_decay, b.mean));
      avg_var[c] = __fadd_rn(__fmul_rn(avg_var[c], decay),
                             __fmul_rn(one_minus_decay, __fmul_rn(var, unbias)));
    }
  }
}

// Forward, pass 2: y = act((x - mean) a + beta [+ s]).
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
    bn_fw_apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                       T* __restrict__ y, long long R, int C, int tx,
                       long long rps, const float* __restrict__ stats,
                       const float* __restrict__ beta) {
  const Tile t(tx, R, C, rps);
  if (!t.live(C)) return;
  float mu[kVec], a[kVec], b[kVec];
  load8f(stats + t.c0, mu);
  load8f(stats + 3 * C + t.c0, a);
  load8f(beta + t.c0, b);
  for (long long r = t.r_begin + t.row; r < t.r_end; r += kUnroll * t.ty) {
    Raw<T> xr[kUnroll], sr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = r + u * t.ty;
      if (rr < t.r_end) {
        xr[u].load(x + rr * C + t.c0);
        if (ACT == kResidualRelu) sr[u].load(res + rr * C + t.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = r + u * t.ty;
      if (rr < t.r_end) {
        float v[kVec], s[kVec], o[kVec];
        xr[u].unpack(v);
        if (ACT == kResidualRelu) sr[u].unpack(s);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          float pre = pre_act(v[i], mu[i], a[i], b[i]);
          if (ACT == kResidualRelu) pre += s[i];
          o[i] = (ACT != kNone && pre < 0.f) ? 0.f : pre;
        }
        store8(y + rr * C + t.c0, o);
      }
    }
  }
}

// Backward, pass 1: per channel sum g and sum g (x - mean) (ds = g in the
// residual variant), then in the last block dgamma, dbeta and the dx
// coefficients.  grads [4, C]: dgamma, dbeta, k0 = a dbeta / m,
// k2 = a rstd^2 sum g (x - mean) / m.
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
    bn_bw_reduce_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                        const T* __restrict__ res, T* __restrict__ ds,
                        long long R, int C, int tx, long long rps,
                        const float* __restrict__ stats,
                        const float* __restrict__ beta, float inv_m,
                        float2* part, int* counters, float* grads) {
  __shared__ Shared sh;
  const Tile t(tx, R, C, rps);
  float sg[kVec], sgx[kVec], mu[kVec], a[kVec], b[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) sg[i] = sgx[i] = 0.f;
  if (t.live(C)) {
    load8f(stats + t.c0, mu);
    if (ACT != kNone) {
      load8f(stats + 3 * C + t.c0, a);
      load8f(beta + t.c0, b);
    }
    for (long long r = t.r_begin + t.row; r < t.r_end;
         r += kUnroll * t.ty) {
      Raw<T> gr[kUnroll], xr[kUnroll], sr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long rr = r + u * t.ty;
        if (rr < t.r_end) {
          gr[u].load(dy + rr * C + t.c0);
          xr[u].load(x + rr * C + t.c0);
          if (ACT == kResidualRelu) sr[u].load(res + rr * C + t.c0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long rr = r + u * t.ty;
        if (rr < t.r_end) {
          float g[kVec], v[kVec], s[kVec];
          gr[u].unpack(g);
          xr[u].unpack(v);
          if (ACT == kResidualRelu) sr[u].unpack(s);
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            if (ACT != kNone) {
              float pre = pre_act(v[i], mu[i], a[i], b[i]);
              if (ACT == kResidualRelu) pre += s[i];
              g[i] *= relu_grad(pre);
            }
            sg[i] += g[i];
            sgx[i] = __fmaf_rn(g[i], v[i] - mu[i], sgx[i]);
          }
          if (ACT == kResidualRelu) store8(ds + rr * C + t.c0, g);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    sh.lane[t.row * t.ct + t.lane * kVec + i] = make_float2(sg[i], sgx[i]);
  __syncthreads();
  const int P = kThreads / t.ct, cl = threadIdx.x % t.ct, p = threadIdx.x / t.ct;
  const int per = t.ty / P;
  float2 acc = make_float2(0.f, 0.f);
  for (int k = p * per; k < (p + 1) * per; ++k) {
    const float2 e = sh.lane[k * t.ct + cl];
    acc.x += e.x;
    acc.y += e.y;
  }
  sh.part[p * t.ct + cl] = make_float3(acc.x, acc.y, 0.f);
  __syncthreads();
  const int c = blockIdx.x * t.ct + cl;
  if (p == 0 && c < C) {
    float2 tot = make_float2(0.f, 0.f);
    for (int q = 0; q < P; ++q) {
      tot.x += sh.part[q * t.ct + cl].x;
      tot.y += sh.part[q * t.ct + cl].y;
    }
    part[static_cast<long long>(blockIdx.y) * C + c] = tot;
  }
  if (!last_block(counters, sh)) return;
  float2 s = make_float2(0.f, 0.f);
  if (c < C) {
    for (int k = p; k < static_cast<int>(gridDim.y); k += P) {
      const float2 e = __ldcg(&part[static_cast<long long>(k) * C + c]);
      s.x += e.x;
      s.y += e.y;
    }
  }
  sh.part[p * t.ct + cl] = make_float3(s.x, s.y, 0.f);
  __syncthreads();
  if (p == 0 && c < C) {
    float sum_g = 0.f, sum_gx = 0.f;
    for (int q = 0; q < P; ++q) {
      sum_g += sh.part[q * t.ct + cl].x;
      sum_gx += sh.part[q * t.ct + cl].y;
    }
    const float rstd = stats[2 * C + c], ac = stats[3 * C + c];
    const float dgamma = sum_gx * rstd;
    grads[c] = dgamma;
    grads[C + c] = sum_g;
    grads[2 * C + c] = ac * sum_g * inv_m;
    grads[3 * C + c] = ac * rstd * dgamma * inv_m;
  }
}

// Backward, pass 2: dx = a g - k2 (x - mean) - k0, g = dy (relu'(pre)).
template <typename T, bool RELU>
__global__ void __launch_bounds__(kThreads)
    bn_bw_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                    T* __restrict__ dx, long long R, int C, int tx,
                    long long rps, const float* __restrict__ stats,
                    const float* __restrict__ beta,
                    const float* __restrict__ grads) {
  const Tile t(tx, R, C, rps);
  if (!t.live(C)) return;
  float mu[kVec], a[kVec], b[kVec], k0[kVec], k2[kVec];
  load8f(stats + t.c0, mu);
  load8f(stats + 3 * C + t.c0, a);
  if (RELU) load8f(beta + t.c0, b);
  load8f(grads + 2 * C + t.c0, k0);
  load8f(grads + 3 * C + t.c0, k2);
  for (long long r = t.r_begin + t.row; r < t.r_end; r += kUnroll * t.ty) {
    Raw<T> gr[kUnroll], xr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = r + u * t.ty;
      if (rr < t.r_end) {
        gr[u].load(dy + rr * C + t.c0);
        xr[u].load(x + rr * C + t.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = r + u * t.ty;
      if (rr < t.r_end) {
        float g[kVec], v[kVec], o[kVec];
        gr[u].unpack(g);
        xr[u].unpack(v);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          float gi = g[i];
          if (RELU) gi *= relu_grad(pre_act(v[i], mu[i], a[i], b[i]));
          const float xm = v[i] - mu[i];
          o[i] = __fmaf_rn(a[i], gi, -__fmaf_rn(k2[i], xm, k0[i]));
        }
        store8(dx + rr * C + t.c0, o);
      }
    }
  }
}

bool bad_geometry(long long R, int C, int tx, long long rps, int splits) {
  if (R < 1 || C < kVec || C % kVec || rps < 1 || splits < 1 ||
      splits > 65535)
    return true;
  if (tx != 1 && tx != 2 && tx != 4 && tx != 8) return true;
  return (R + rps - 1) / rps != splits;
}

dim3 grid_of(int C, int tx, int splits) {
  const int ct = tx * kVec;
  return dim3((C + ct - 1) / ct, splits);
}

template <typename T>
int fwd(const void* x, const void* res, void* y, const float* gamma,
        const float* beta, float* avg_mean, float* avg_var, float* stats,
        void* part, int* counters, int act, long long R, int C, int tx,
        long long rps, int splits, float eps, float decay,
        float one_minus_decay, float unbias, cudaStream_t stream) {
  const dim3 grid = grid_of(C, tx, splits);
  const T* xt = static_cast<const T*>(x);
  bn_fw_stats_kernel<T><<<grid, kThreads, 0, stream>>>(
      xt, R, C, tx, rps, gamma, avg_mean, avg_var, eps, decay,
      one_minus_decay, unbias, static_cast<float2*>(part), counters, stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const T* rt = static_cast<const T*>(res);
  T* yt = static_cast<T*>(y);
  if (act == kNone)
    bn_fw_apply_kernel<T, kNone><<<grid, kThreads, 0, stream>>>(
        xt, rt, yt, R, C, tx, rps, stats, beta);
  else if (act == kRelu)
    bn_fw_apply_kernel<T, kRelu><<<grid, kThreads, 0, stream>>>(
        xt, rt, yt, R, C, tx, rps, stats, beta);
  else
    bn_fw_apply_kernel<T, kResidualRelu><<<grid, kThreads, 0, stream>>>(
        xt, rt, yt, R, C, tx, rps, stats, beta);
  return cudaGetLastError();
}

template <typename T>
int bwd(const void* dy, const void* x, const void* res, void* dx, void* ds,
        const float* stats, const float* beta, float* grads, void* part,
        int* counters, int act, long long R, int C, int tx, long long rps,
        int splits, cudaStream_t stream) {
  const dim3 grid = grid_of(C, tx, splits);
  const T* dyt = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  T* dst = static_cast<T*>(ds);
  float2* pt = static_cast<float2*>(part);
  const float inv_m = 1.f / static_cast<float>(R);
  if (act == kNone)
    bn_bw_reduce_kernel<T, kNone><<<grid, kThreads, 0, stream>>>(
        dyt, xt, rt, dst, R, C, tx, rps, stats, beta, inv_m, pt, counters,
        grads);
  else if (act == kRelu)
    bn_bw_reduce_kernel<T, kRelu><<<grid, kThreads, 0, stream>>>(
        dyt, xt, rt, dst, R, C, tx, rps, stats, beta, inv_m, pt, counters,
        grads);
  else
    bn_bw_reduce_kernel<T, kResidualRelu><<<grid, kThreads, 0, stream>>>(
        dyt, xt, rt, dst, R, C, tx, rps, stats, beta, inv_m, pt, counters,
        grads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  T* dxt = static_cast<T*>(dx);
  if (act == kRelu)
    bn_bw_dx_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        dyt, xt, dxt, R, C, tx, rps, stats, beta, grads);
  else  // the residual variant reads g from ds
    bn_bw_dx_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        act == kNone ? dyt : dst, xt, dxt, R, C, tx, rps, stats, beta,
        grads);
  return cudaGetLastError();
}

}  // namespace

// The forward: both passes on `stream`.  x, res (act 2 only) and y are
// [R, C] contiguous in dtype (0 bf16, 1 fp32); gamma, beta fp32 [C];
// avg_mean and avg_var fp32 [C], moved in place, or both null; stats fp32
// [4, C] out; part fp32 [splits, C, 2] scratch; counters int32 [channel
// tiles], zero, left zero.  Returns a cudaError_t (0 = success);
// cudaErrorInvalidValue for arguments without a kernel.
extern "C" int bn_act_fwd(const void* x, const void* res, void* y,
                          const float* gamma, const float* beta,
                          float* avg_mean, float* avg_var, float* stats,
                          void* part, void* counters, int dtype, int act,
                          long long R, int C, int tx, long long rps,
                          int splits, float eps, float decay,
                          float one_minus_decay, float unbias,
                          void* stream) {
  if (bad_geometry(R, C, tx, rps, splits) || act < 0 || act > 2 ||
      (act == kResidualRelu && res == nullptr) ||
      ((avg_mean == nullptr) != (avg_var == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd<__nv_bfloat16>(x, res, y, gamma, beta, avg_mean, avg_var,
                              stats, part, static_cast<int*>(counters), act,
                              R, C, tx, rps, splits, eps, decay,
                              one_minus_decay, unbias, st);
  if (dtype == 1)
    return fwd<float>(x, res, y, gamma, beta, avg_mean, avg_var, stats,
                      part, static_cast<int*>(counters), act, R, C, tx, rps,
                      splits, eps, decay, one_minus_decay, unbias, st);
  return cudaErrorInvalidValue;
}

// The backward: both passes on `stream`.  dy, x, res (act 2), dx and ds
// (act 2, written) are [R, C] contiguous in dtype; stats is the forward's;
// grads fp32 [4, C] out (dgamma, dbeta, then the dx coefficients); part
// and counters as the forward's.
extern "C" int bn_act_bwd(const void* dy, const void* x, const void* res,
                          void* dx, void* ds, const float* stats,
                          const float* beta, float* grads, void* part,
                          void* counters, int dtype, int act, long long R,
                          int C, int tx, long long rps, int splits,
                          void* stream) {
  if (bad_geometry(R, C, tx, rps, splits) || act < 0 || act > 2 ||
      (act == kResidualRelu && (res == nullptr || ds == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd<__nv_bfloat16>(dy, x, res, dx, ds, stats, beta, grads, part,
                              static_cast<int*>(counters), act, R, C, tx,
                              rps, splits, st);
  if (dtype == 1)
    return bwd<float>(dy, x, res, dx, ds, stats, beta, grads, part,
                      static_cast<int*>(counters), act, R, C, tx, rps,
                      splits, st);
  return cudaErrorInvalidValue;
}
