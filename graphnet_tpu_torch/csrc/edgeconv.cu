// Fused EdgeConv forward for Hopper:
//
//   out[i] = aggr_{kk < k, em[i,kk]} act(act(a[i] + b[idx[i,kk]]) @ W2 + b2)
//
// with act = relu (slope 0) or leaky relu (slope 0.01) and aggr = add or
// max; a node with no valid edge gives 0.  Output is fp32.
//
// Replaces the TPU kernel graphnet_tpu/ops/edgeconv_pallas.py:_fwd_kernel
// (forward of fused_edgeconv).  The TPU kernel gathered b[idx] with a 0/1
// selection matmul and laid edge rows out k-major, both Mosaic
// workarounds; here each block gathers the rows of b by index directly.
//
// What bounds it on the H100: operations.  At DynEdge's layers 1-3
// (H1=336, H2=256) with B=128, L=128, k=8 the second linear alone is
// 2*131072*336*256 = 22.5 GFLOP against ~60 MB of input and output, far
// above the card's FLOP/byte balance in either precision.  The design
// keeps the [B, L, k, H1] messages out of device memory: one block takes
// 64 edge rows (64/k whole nodes of one event), builds their messages in
// shared memory, multiplies them by W2 with fp32 accumulation, and
// reduces over k in the epilogue, so only a, b, idx, em, W2 are read and
// only [B, L, H2] is written.
//   * fp32 operands: CUDA-core FMAs.  Each thread owns one output column
//     and all 64 rows (64 accumulators in registers), reads its W2 column
//     from L2 and the message rows from shared memory as float4
//     broadcasts.  The 64x336 fp32 message tile is 86 KB, which needs
//     the dynamic shared memory opt-in.
//   * bf16 operands: tensor cores through WMMA (16x16x16 bf16, fp32
//     accumulate).  Messages are formed in fp32 and rounded to bf16 once,
//     as the TPU kernel does; W2 is staged through shared memory in
//     16-row slabs, zero-padded so H1 and H2 need not be multiples of 16
//     (336 = 21*16 is, 128 and 256 are).
// This is the first, simple version; it is not tuned (no TMA, wgmma or
// pipelining yet).  The block's code lives in edgeconv.cuh, which
// edgeconv_knn.cu shares.

#include "edgeconv.cuh"

namespace {

__global__ void __launch_bounds__(ec::kThreads)
    edgeconv_fwd_f32(const float* __restrict__ a, const float* __restrict__ b,
                     const int32_t* __restrict__ idx,
                     const uint8_t* __restrict__ em,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out,
                     int L, int H1, int H2, int k, int tl, float slope,
                     int aggr_max) {
  extern __shared__ __align__(128) float msg[];
  ec::fwd_f32(a, b, idx, em, w2, b2, out, L, H1, H2, k, tl, slope, aggr_max,
              msg);
}

__global__ void __launch_bounds__(ec::kThreads)
    edgeconv_fwd_bf16(const __nv_bfloat16* __restrict__ a,
                      const __nv_bfloat16* __restrict__ b,
                      const int32_t* __restrict__ idx,
                      const uint8_t* __restrict__ em,
                      const __nv_bfloat16* __restrict__ w2,
                      const __nv_bfloat16* __restrict__ b2,
                      float* __restrict__ out, int L, int H1, int H2, int k,
                      int tl, float slope, int aggr_max) {
  extern __shared__ __align__(128) unsigned char smem[];
  ec::fwd_bf16(a, b, idx, em, w2, b2, out, L, H1, H2, k, tl, slope, aggr_max,
               smem);
}

}  // namespace

// Shared memory the kernel needs, in bytes (the wrapper checks it
// against the card's limit before launching).
extern "C" long long edgeconv_fwd_smem_bytes(int H1, int bf16) {
  return ec::smem_bytes(H1, bf16);
}

extern "C" int edgeconv_fwd_launch(const void* a, const void* b,
                                   const void* idx, const void* em,
                                   const void* w2, const void* b2, void* out,
                                   int B, int L, int H1, int H2, int k,
                                   float slope, int aggr_max, int bf16,
                                   void* stream) {
  static size_t configured_f32 = 0, configured_bf16 = 0;
  if (B == 0 || L == 0) return 0;
  if (k < 1 || k > ec::kRows) return (int)cudaErrorInvalidValue;
  const int tl = ec::kRows / k;
  const dim3 grid((L + tl - 1) / tl, B);
  const size_t smem = (size_t)ec::smem_bytes(H1, bf16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = ec::allow_smem((const void*)edgeconv_fwd_bf16, smem,
                         &configured_bf16);
    if (err != cudaSuccess) return (int)err;
    edgeconv_fwd_bf16<<<grid, ec::kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(em),
        static_cast<const __nv_bfloat16*>(w2),
        static_cast<const __nv_bfloat16*>(b2), static_cast<float*>(out), L,
        H1, H2, k, tl, slope, aggr_max);
  } else {
    err = ec::allow_smem((const void*)edgeconv_fwd_f32, smem, &configured_f32);
    if (err != cudaSuccess) return (int)err;
    edgeconv_fwd_f32<<<grid, ec::kThreads, smem, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(em),
        static_cast<const float*>(w2), static_cast<const float*>(b2),
        static_cast<float*>(out), L, H1, H2, k, tl, slope, aggr_max);
  }
  return (int)cudaGetLastError();
}
