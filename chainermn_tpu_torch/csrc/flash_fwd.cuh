// The flash attention forward's launch parameters, shared by the bf16
// Hopper kernel (flash_fwd_sm90.cu) and the fp32 kernel with the C entry
// point (flash_attention.cu).
#pragma once

#include <cuda_runtime.h>

namespace flash {

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;     // [B*H, Tq, D], q's dtype
  float* lse;  // [B*H, Tq], or null for the forward without it
  int B, H, Tq, Tk;
  long long sqb, sqh, sqt;  // element strides; the last dimension is dense
  long long skb, skh, skt;
  long long svb, svh, svt;
  int causal;
  float scale;
};

// bf16 on TMA and wgmma: q tiles of 64 rows, key tiles of block_k (D 64:
// 64 or 128; D 128: 64).
cudaError_t fwd_bf16_sm90(const FwdParams& prm, int D, int block_k,
                          cudaStream_t stream);

}  // namespace flash
