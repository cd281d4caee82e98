// Pieces shared by the flash-attention kernels (flash_attention.cu,
// flash_attention_bwd.cu) and the relative-bias ones: the numerics
// helpers, and the row layout of the dq kernel.
//
// dq layout: each row of q, k, v or g (head dim DH = 32 or 64) belongs
// to SPLIT = DH / 32 adjacent threads of a warp, each holding 32 of its
// elements in registers; a dot product is a 32-term partial sum per
// thread, then a butterfly sum over the SPLIT lanes (both lanes end with
// the same bits).  Tiles of rows are staged in shared memory as fp32 in
// segments of 32 elements padded to 36 floats, so the SPLIT segments of
// one row, read together by the two lanes of a pair, sit in different
// banks.  The forward and dkv kernels tile with flash_mma.cuh instead.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

// a masked key's logit, as in the TPU kernel: exp(_NEG - lse) underflows
// to 0 for any realistic lse, yet a fully masked row keeps
// lse = _NEG + log(L) distinct from _NEG in fp32
constexpr float kNeg = -1e5f;
constexpr int kSeg = 32;     // row elements a thread holds
constexpr int kSegPad = 36;  // floats per staged segment
constexpr int kRows = 128;   // rows a block owns
constexpr int kTile = 32;    // rows staged per tile

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the value x carries once rounded to T (round to nearest even)
template <typename T>
__device__ __forceinline__ float round_t(float x) {
  return to_f<T>(from_f<T>(x));
}

// sum over the SPLIT adjacent lanes that share a row
template <int SPLIT>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < SPLIT; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// a thread's 32 elements against one staged segment
__device__ __forceinline__ float seg_dot(const float (&a)[kSeg],
                                         const float* s) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < kSeg; d += 4) {
    const float4 w = *reinterpret_cast<const float4*>(s + d);
    acc = fmaf(a[d], w.x, acc);
    acc = fmaf(a[d + 1], w.y, acc);
    acc = fmaf(a[d + 2], w.z, acc);
    acc = fmaf(a[d + 3], w.w, acc);
  }
  return acc;
}

// acc += c * segment
__device__ __forceinline__ void seg_axpy(float (&acc)[kSeg], float c,
                                         const float* s) {
#pragma unroll
  for (int d = 0; d < kSeg; d += 4) {
    const float4 w = *reinterpret_cast<const float4*>(s + d);
    acc[d] = fmaf(c, w.x, acc[d]);
    acc[d + 1] = fmaf(c, w.y, acc[d + 1]);
    acc[d + 2] = fmaf(c, w.z, acc[d + 2]);
    acc[d + 3] = fmaf(c, w.w, acc[d + 3]);
  }
}

// segment h of staged row r
template <int DH>
__device__ __forceinline__ int seg_off(int r, int h) {
  return (r * (DH / kSeg) + h) * kSegPad;
}

// Stage rows [0, n) of src ([*, DH], row-major) into dst as fp32, rows
// n..kTile-1 as 0.  Each value becomes round_t<T>(value * scale): q
// scaled in its own dtype; scale = 1 leaves a T value as it is.
template <typename T, int DH>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int n, float scale) {
  for (int e = threadIdx.x; e < kTile * DH; e += blockDim.x) {
    const int r = e / DH, c = e % DH;
    float x = 0.f;
    if (r < n) {
      x = round_t<T>(to_f<T>(src[(size_t)r * DH + c]) * scale);
    }
    dst[seg_off<DH>(r, c / kSeg) + c % kSeg] = x;
  }
}

// a thread's 32 elements of row `row` of src, 0 for an inactive row;
// scaled as in stage()
template <typename T>
__device__ __forceinline__ void load_seg(float (&dst)[kSeg],
                                         const T* __restrict__ src,
                                         bool active, float scale) {
#pragma unroll
  for (int d = 0; d < kSeg; ++d) {
    dst[d] = active ? round_t<T>(to_f<T>(src[d]) * scale) : 0.f;
  }
}

}  // namespace flash
