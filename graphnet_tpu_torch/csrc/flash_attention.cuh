// Pieces shared by the flash-attention kernels (flash_attention.cu,
// flash_attention_bwd.cu) and the relative-bias ones: the masked logit
// and the numerics helpers of the input dtypes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

// a masked key's logit, as in the TPU kernel: exp(_NEG - lse) underflows
// to 0 for any realistic lse, yet a fully masked row keeps
// lse = _NEG + log(L) distinct from _NEG in fp32
constexpr float kNeg = -1e5f;

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

}  // namespace flash
