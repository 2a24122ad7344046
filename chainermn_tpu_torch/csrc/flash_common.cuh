// Pieces shared by the flash attention kernels (forward and backward):
// bf16 packing (the Hopper kernels), and for the fp32 kernels on CUDA cores
// padded shared-memory tiles, paired stores and the backward kernels' tile
// products (BwdOps).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

template <typename T>
struct Pad {  // 16 bytes of padding per shared-memory row
  static constexpr int value = 16 / sizeof(T);
};

// Copy `rows` rows of D elements (row r at src + r * stride) into a padded
// shared tile with `threads` threads; rows at or past `valid` are
// zero-filled, so masked rows meet finite values (0 * garbage could be NaN).
template <typename T, int D, int kRows, int kThreads>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, int valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  constexpr int kLd = D + Pad<T>::value;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
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

// Two adjacent elements at flat index idx (even), from fp32 values.
template <typename T>
__device__ __forceinline__ void store2(T* out, long long idx, float a,
                                       float b);

template <>
__device__ __forceinline__ void store2<float>(float* out, long long idx,
                                              float a, float b) {
  *reinterpret_cast<float2*>(out + idx) = make_float2(a, b);
}

// The fp32 backward kernels' tile products (the fused kernel and the split
// dq and dk/dv passes; in bf16 all three are Hopper kernels), over 64-row
// tiles.  A warp owns 16 rows of one operand (keys in the fused kernel and
// the dk/dv pass, q rows in the dq pass) and meets the 64 rows of a
// shared-memory tile of the other.  Fragments follow the mma C layout:
// lane = 4 * g + t holds, for n-tile j, columns 8j + 2t and 8j + 2t + 1 of
// rows g (entries 0, 1) and g + 8 (entries 2, 3); a warp's [16, 64] tile
// is float x[8][4], its [16, D] accumulators float x[D / 8][4].
constexpr int kBwdTile = 64;

template <typename T, int D>
struct BwdOps;

template <int D>
struct BwdOps<float, D> {
  using T = float;
  static constexpr int kLd = D + Pad<T>::value;
  static constexpr int kLdS = kBwdTile + Pad<T>::value;

  __device__ static void nt(float (*acc)[4], const T* a, const T* b, int g,
                            int t) {
    const T* a0 = a + g * kLd;
    const T* a1 = a0 + 8 * kLd;
#pragma unroll
    for (int j = 0; j < kBwdTile / 8; ++j) {
      const T* b0 = b + (8 * j + 2 * t) * kLd;
      const T* b1 = b0 + kLd;
      float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
      for (int d = 0; d < D; ++d) {
        c0 = fmaf(a0[d], b0[d], c0);
        c1 = fmaf(a0[d], b1[d], c1);
        c2 = fmaf(a1[d], b0[d], c2);
        c3 = fmaf(a1[d], b1[d], c3);
      }
      acc[j][0] = c0; acc[j][1] = c1; acc[j][2] = c2; acc[j][3] = c3;
    }
  }

  // x goes through the warp's own rows of the staging buffer s: every
  // output element needs a whole row of x, which is spread over four lanes.
  __device__ static void nn(float (*out)[4], float (*x)[4], const T* b,
                            T* s, int lane) {
    const int g = lane / 4, t = lane % 4;
    stage(s, x, g, t);
    __syncwarp();
    const float* x0 = s + g * kLdS;
    const float* x1 = x0 + 8 * kLdS;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const T* bc = b + 8 * nd + 2 * t;
      float c0 = out[nd][0], c1 = out[nd][1], c2 = out[nd][2],
            c3 = out[nd][3];
      for (int r = 0; r < kBwdTile; ++r) {
        float b0 = bc[r * kLd], b1 = bc[r * kLd + 1];
        c0 = fmaf(x0[r], b0, c0);
        c1 = fmaf(x0[r], b1, c1);
        c2 = fmaf(x1[r], b0, c2);
        c3 = fmaf(x1[r], b1, c3);
      }
      out[nd][0] = c0; out[nd][1] = c1; out[nd][2] = c2; out[nd][3] = c3;
    }
    __syncwarp();
  }

  __device__ static void stage(T* s, float (*x)[4], int g, int t) {
#pragma unroll
    for (int j = 0; j < kBwdTile / 8; ++j) {
      s[g * kLdS + 8 * j + 2 * t] = x[j][0];
      s[g * kLdS + 8 * j + 2 * t + 1] = x[j][1];
      s[(g + 8) * kLdS + 8 * j + 2 * t] = x[j][2];
      s[(g + 8) * kLdS + 8 * j + 2 * t + 1] = x[j][3];
    }
  }
};

}  // namespace flash
