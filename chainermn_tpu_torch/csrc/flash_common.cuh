// Pieces shared by the flash attention kernels (forward and backward):
// padded shared-memory tiles, bf16 packing, the m16n8k16 tensor-core
// product, the transposing shared-memory fragment load and the backward
// kernels' tile products (BwdOps).
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

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b for one m16n8k16 tile: A row-major 16x16 bf16, B 16x8 bf16
// ("col"), C/D 16x8 fp32.  Fragment layout of C (and of the outputs built
// from it): lane = 4 * g + t holds, for n-tile j, columns 8j + 2t and
// 8j + 2t + 1 of rows g (entries 0, 1) and g + 8 (entries 2, 3).
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, each transposed: lane l
// gives the address of row l % 8 of matrix l / 8 (16 contiguous bytes,
// 16-byte aligned) and receives in r[i] the pair (M_i[2t][g],
// M_i[2t + 1][g]), g = l / 4, t = l % 4.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* row) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two adjacent elements at flat index idx (even), from fp32 values.
template <typename T>
__device__ __forceinline__ void store2(T* out, long long idx, float a,
                                       float b);

template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* out,
                                                      long long idx, float a,
                                                      float b) {
  *reinterpret_cast<uint32_t*>(out + idx) = pack_bf16(a, b);
}

template <>
__device__ __forceinline__ void store2<float>(float* out, long long idx,
                                              float a, float b) {
  *reinterpret_cast<float2*>(out + idx) = make_float2(a, b);
}

// The backward kernels' tile products (the split dq pass, and the fp32
// fused and dk/dv kernels; bf16 B2 and dk/dv are flash_bwd_sm90.cu's),
// over 64-row tiles.  A warp owns 16 rows of one operand
// (keys in B2 and the dk/dv pass, q rows in the dq pass) and meets the 64
// rows of a shared-memory tile of the other.  Fragments follow the mma C
// layout above: a warp's [16, 64] tile is float x[8][4], its [16, D]
// accumulators float x[D / 8][4].
constexpr int kBwdTile = 64;

template <typename T, int D>
struct BwdOps;

template <int D>
struct BwdOps<__nv_bfloat16, D> {
  using T = __nv_bfloat16;
  static constexpr int kLd = D + Pad<T>::value;        // tile rows
  static constexpr int kLdS = kBwdTile + Pad<T>::value;  // staged [16, 64]

  // acc[j] = A . B^T over D: A = the warp's 16 rows at a, B = the 64 rows
  // of the tile at b.
  __device__ static void nt(float (*acc)[4], const T* a, const T* b, int g,
                            int t) {
    uint32_t af[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const T* r0 = a + g * kLd + kk * 16 + 2 * t;
      const T* r1 = r0 + 8 * kLd;
      af[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
      af[kk][1] = *reinterpret_cast<const uint32_t*>(r1);
      af[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
      af[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
    }
#pragma unroll
    for (int j = 0; j < kBwdTile / 8; ++j) {
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      const T* br = b + (8 * j + g) * kLd + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(br + kk * 16);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(br + kk * 16 + 8);
        mma_bf16(acc[j], af[kk], b0, b1);
      }
    }
  }

  // out += bf16(x) . B over the tile's 64 rows: x is the warp's [16, 64]
  // tile (reused in place as the A operand), B = the tile's [64, D] rows at
  // b, read transposed by ldmatrix.
  __device__ static void nn(float (*out)[4], float (*x)[4], const T* b, T*,
                            int lane) {
#pragma unroll
    for (int kk = 0; kk < kBwdTile / 16; ++kk) {
      uint32_t xa[4];
      xa[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
      xa[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
      xa[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
      xa[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
      const T* row =
          b + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLd +
          (lane >> 4) * 8;
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, row + 8 * nd);
        mma_bf16(out[nd], xa, bf[0], bf[1]);
        mma_bf16(out[nd + 1], xa, bf[2], bf[3]);
      }
    }
  }

  // Write the warp's [16, 64] tile x, cast to bf16, to its rows at s.
  __device__ static void stage(T* s, float (*x)[4], int g, int t) {
#pragma unroll
    for (int j = 0; j < kBwdTile / 8; ++j) {
      *reinterpret_cast<uint32_t*>(s + g * kLdS + 8 * j + 2 * t) =
          pack_bf16(x[j][0], x[j][1]);
      *reinterpret_cast<uint32_t*>(s + (g + 8) * kLdS + 8 * j + 2 * t) =
          pack_bf16(x[j][2], x[j][3]);
    }
  }
};

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
