// The flash attention backward's launch parameters and the bf16 Hopper
// kernels that the C entry points of the fused backward
// (flash_attention_bwd.cu) and of the split backward's two passes
// (flash_attention_bwd_split.cu) launch: flash_bwd_sm90.cu (the fused
// kernel, the dk/dv pass, the dq epilogue) and flash_bwd_dq_sm90.cu (the
// dq pass).
#pragma once

#include <cuda_runtime.h>

namespace flash {

struct BwdParams {
  const void* q;       // [B, H, Tq, D], read through its strides
  const void* k;       // [B, H, Tk, D]
  const void* v;       // [B, H, Tk, D]
  const void* g;       // [B, H, Tq, D]: the cotangent of out
  const float* lse;    // [B*H, Tq]
  const float* delta;  // [B*H, Tq]: rowsum(g * out) - g_lse
  void* dq;            // fused: fp32 [B*H, Tq, D], zeroed; receives the
                       // unscaled sum of ds k.  dq pass: [B*H, Tq, D] in
                       // q's dtype, written once, scaled.  dk/dv pass: null
  void* dk;            // [B*H, Tk, D], k's dtype
  void* dv;            // [B*H, Tk, D]
  int B, H, Tq, Tk;
  long long sqb, sqh, sqt;  // element strides; the last dimension is dense
  long long skb, skh, skt;
  long long svb, svh, svt;
  long long sgb, sgh, sgt;
  int causal;
  float scale;
};

// bf16 on TMA and wgmma, one block per (b*h, 64-key tile): the fused
// backward (with_dq) or the split backward's dk/dv pass.  D 64 or 128.
cudaError_t bwd_bf16_sm90(const BwdParams& prm, int D, bool with_dq,
                          cudaStream_t stream);

// bf16 on TMA and wgmma, one block per (b*h, 64-row q tile): the split
// backward's dq pass.  D 64 or 128.
cudaError_t bwd_dq_bf16_sm90(const BwdParams& prm, int D,
                             cudaStream_t stream);

// dq = (acc * scale) in dtype (0 bf16, 1 fp32): n elements, n % 4 == 0,
// both buffers 16-byte aligned.
cudaError_t bwd_dq_epilogue(const float* acc, void* dq, int dtype,
                            long long n, float scale, cudaStream_t stream);

}  // namespace flash
