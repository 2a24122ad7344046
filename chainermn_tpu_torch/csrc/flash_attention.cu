// Flash attention forward for Hopper (sm_90a): the CUDA counterpart of
// chainermn_tpu/ops/flash_attention.py::_flash_kernel.
//
// What it computes: out = softmax(scale * q k^T [causal mask]) v for
// q [B, H, Tq, D] and k/v [B, H, Tk, D], with the JAX kernel's numerics:
// q/k/v enter the dots in their storage dtype, accumulators and the online
// softmax state (m, l, acc) are fp32, p is cast to v's dtype before the PV
// dot, and the -inf / m_safe / corr rules plus the final l >= 1e-30 clamp
// make a fully masked row come out as 0 instead of NaN.  Key tiles past
// the causal diagonal are skipped; the ragged edge (any T >= 1) is masked
// inside the kernel, so no shape ever falls back to the plain version.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM): at
// B = 1, H = 12, T = 1024, D = 64 causal (one serving prefill layer), the
// causal QK^T + PV work is 4 * B*H * D * T(T+1)/2 = 1.61 GFLOP (1.6 us)
// and q/k/v/o are 4 * B*H*T*D * 2 B = 6.3 MB (1.9 us), so a launch cannot
// take less than about 2 us and is bytes-bound at this size.
//
// How the design answers it: one block of 4 warps per (b*h, 64-row q
// tile), each warp owning 16 q rows.  K/V tiles of 64 rows are staged in
// shared memory (16-byte vector loads, padded rows so the fragment reads
// are conflict free) and read from device memory once per q tile; q, the
// [64, 64] score tile and the output accumulator never leave registers.
// bf16 QK^T and PV run on mma.sync m16n8k16 tensor-core instructions with
// fp32 accumulation, and the score fragments are reused in place as the A
// operand of PV (the FlashAttention-2 register layout).  fp32 inputs take
// the same tiling with the dots done on CUDA cores.  Single-buffered
// loads, no TMA and no wgmma: the simple, correct first version.
//
// Plain C interface (bound with ctypes): the launcher returns
// cudaGetLastError(); it launches on the caller's stream and allocates
// nothing.  Strides are in elements; the last dimension must be dense and
// every row 16-byte aligned (the Python wrapper checks and copies if not).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // q rows per block
constexpr int kBlockK = 64;   // key rows per shared-memory tile
constexpr int kWarps = 4;     // 16 q rows per warp
constexpr int kThreads = kWarps * 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, Tq, Tk;
  long long sqb, sqh, sqt;
  long long skb, skh, skt;
  long long svb, svh, svt;
  int causal;
  float scale;
};

template <typename T>
struct Pad {  // 16 bytes of padding per shared-memory row
  static constexpr int value = 16 / sizeof(T);
};

// Copy `rows` rows of D elements (row r at src + r * stride) into a padded
// shared tile; rows at or past `valid` are zero-filled, so masked keys
// contribute p = 0 against finite values (0 * garbage could be NaN).
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, int valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  constexpr int kLd = D + Pad<T>::value;
  for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
    int r = i / kChunks;
    int c = (i % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) {
      val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b for one m16n8k16 tile: A row-major 16x16 bf16, B 16x8 bf16
// ("col"), C/D 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layout shared by both element types (the mma C layout): lane =
// 4 * g + t holds, for n-tile j, columns 8j + 2t and 8j + 2t + 1 of rows
// g (entries 0, 1) and g + 8 (entries 2, 3) of the warp's 16 rows.
template <typename T, int D>
struct Tile;

template <int D>
struct Tile<__nv_bfloat16, D> {
  using T = __nv_bfloat16;
  static constexpr int kLd = D + Pad<T>::value;
  uint32_t qa[D / 16][4];

  __device__ void load_q(const T* qs, int g, int t) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const T* r0 = qs + g * kLd + kk * 16 + 2 * t;
      const T* r1 = r0 + 8 * kLd;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(r1);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
    }
  }

  // s[j][*] = q . k for the 64 keys of the tile (unscaled).
  __device__ void qk(float (*s)[4], const T* ks, int g, int t) {
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const T* kr = ks + (8 * j + g) * kLd + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16(s[j], qa[kk], b0, b1);
      }
    }
  }

  // o += bf16(p) . v, the score fragments reused as the A operand.
  __device__ void pv(float (*o)[4], float (*p)[4], const T* vs, float*,
                     int g, int t) {
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
      pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
      pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
      const T* v0 = vs + (16 * kk + 2 * t) * kLd + g;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const T* vr = v0 + 8 * nd;
        uint32_t b0 = pack_bf16(vr[0], vr[kLd]);
        uint32_t b1 = pack_bf16(vr[8 * kLd], vr[9 * kLd]);
        mma_bf16(o[nd], pa, b0, b1);
      }
    }
  }

  __device__ static void store(T* out, int row, int col, float a, float b) {
    *reinterpret_cast<uint32_t*>(out + (long long)row * D + col) =
        pack_bf16(a, b);
  }
};

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

  __device__ static void store(T* out, int row, int col, float a, float b) {
    *reinterpret_cast<float2*>(out + (long long)row * D + col) =
        make_float2(a, b);
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

template <typename T, int D>
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

  load_tile<T, D>(qs, qg, prm.sqt, prm.Tq - q_start);
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
    load_tile<T, D>(ks, kg + k_start * prm.skt, prm.skt, prm.Tk - k_start);
    load_tile<T, D>(vs, vg + k_start * prm.svt, prm.svt, prm.Tk - k_start);
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
      Tile<T, D>::store(og, lr0, col, o[nd][0] * inv[0], o[nd][1] * inv[0]);
    if (row1 < prm.Tq)
      Tile<T, D>::store(og, lr0 + 8, col, o[nd][2] * inv[1],
                        o[nd][3] * inv[1]);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& prm, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((prm.Tq + kBlockQ - 1) / kBlockQ, B * prm.H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32.  Returns a cudaError_t (0 = success);
// cudaErrorInvalidValue for a dtype or head dim the kernel has no
// instantiation for.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int Tq, int Tk, int D, long long sqb, long long sqh,
    long long sqt, long long skb, long long skh, long long skt,
    long long svb, long long svh, long long svt, int causal, float scale,
    void* stream) {
  Params prm{q, k, v, o, H, Tq, Tk, sqb, sqh, sqt, skb, skh, skt,
             svb, svh, svt, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch<__nv_bfloat16, 64>(prm, B, s);
  if (dtype == 0 && D == 128) return launch<__nv_bfloat16, 128>(prm, B, s);
  if (dtype == 1 && D == 64) return launch<float, 64>(prm, B, s);
  if (dtype == 1 && D == 128) return launch<float, 128>(prm, B, s);
  return cudaErrorInvalidValue;
}
