// Pieces shared by the flash attention kernels (forward and backward):
// padded shared-memory tiles, bf16 packing, the m16n8k16 tensor-core
// product and the transposing shared-memory fragment load.
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

}  // namespace flash
