// Backward of the masked softmax attention (flash_attention.cu), for
// Hopper: dQ, and dK with dV.
//
// Replaces the TPU kernels graphnet_tpu/ops/flash_attention.py:
// _bwd_dq_kernel and _bwd_dkv_kernel.  Same contract: the probabilities
// are recomputed from the forward's lse, p = exp(logit - lse), with the
// logits formed as in the forward (q scaled in its dtype, a masked key
// at -1e5); dp = g.v; ds = p * (dp - delta) * valid, so a masked key
// passes no gradient through its logit while dv still takes its p;
// delta = sum(g * o) comes in from the wrapper.  dq = (sum ds.k) * scale,
// rounded once at the end; dk = sum ds.(q*scale) with no second scale;
// dv = sum p.g.  ds and p are rounded to the input dtype before their
// products, which accumulate in fp32.
//
// What bounds it on the H100: operations, 10*B*H*L^2*Dh flops for the
// pair (0.33 ms at the fp32 CUDA-core peak at TITO's shape).  The split
// is the TPU's, and it is what keeps the kernels free of floating-point
// atomics: the dq kernel owns 128 query rows per block and streams keys
// and values; the dkv kernel owns 128 key rows per block and streams
// queries, output gradients, lse and delta.  Every sum runs in a fixed
// order, so two runs give the same bits.  Each row is held by Dh/32
// threads in registers (see flash_attention.cuh); CUDA cores only in
// this version.

#include "flash_attention.cuh"

namespace flash {
namespace {

template <typename T, int DH>
__global__ void __launch_bounds__(kRows * (DH / kSeg))
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const uint8_t* __restrict__ mask,   // [B, L]
                    const float* __restrict__ lse,      // [B*H, L]
                    const T* __restrict__ g,            // [B*H, L, DH]
                    const float* __restrict__ delta,    // [B*H, L]
                    int H, int L, float scale,
                    T* __restrict__ dq) {
  constexpr int SPLIT = DH / kSeg;
  __shared__ __align__(16) float ks[kTile * SPLIT * kSegPad];
  __shared__ __align__(16) float vs[kTile * SPLIT * kSegPad];
  __shared__ float kval[kTile];

  const int bh = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x / SPLIT;
  const int h = threadIdx.x % SPLIT;
  const bool active = row < L;
  const size_t base = (size_t)bh * L * DH;
  const uint8_t* m = mask + (size_t)(bh / H) * L;
  const size_t at = base + (size_t)min(row, L - 1) * DH + h * kSeg;
  const size_t st = (size_t)bh * L + min(row, L - 1);

  float qr[kSeg], gr[kSeg], acc[kSeg];
  load_seg<T>(qr, q + at, active, round_t<T>(scale));
  load_seg<T>(gr, g + at, active, 1.f);
#pragma unroll
  for (int d = 0; d < kSeg; ++d) acc[d] = 0.f;
  const float lse_r = active ? lse[st] : 0.f;
  const float delta_r = active ? delta[st] : 0.f;

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int n = min(kTile, L - t0);  // the same in every thread
    __syncthreads();
    stage<T, DH>(ks, k + base + (size_t)t0 * DH, n, 1.f);
    stage<T, DH>(vs, v + base + (size_t)t0 * DH, n, 1.f);
    for (int j = threadIdx.x; j < kTile; j += blockDim.x)
      kval[j] = (j < n && m[t0 + j]) ? 1.f : 0.f;
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float* kj = ks + seg_off<DH>(j, h);
      const float valid = kval[j];
      float s = row_sum<SPLIT>(seg_dot(qr, kj));
      s = valid != 0.f ? s : kNeg;
      const float p = expf(s - lse_r);
      const float dp = row_sum<SPLIT>(seg_dot(gr, vs + seg_off<DH>(j, h)));
      seg_axpy(acc, round_t<T>(p * (dp - delta_r) * valid), kj);
    }
  }

  if (active) {
#pragma unroll
    for (int d = 0; d < kSeg; ++d) dq[at + d] = from_f<T>(acc[d] * scale);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kRows * (DH / kSeg))
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const uint8_t* __restrict__ mask,  // [B, L]
                     const float* __restrict__ lse,     // [B*H, L]
                     const T* __restrict__ g,           // [B*H, L, DH]
                     const float* __restrict__ delta,   // [B*H, L]
                     int H, int L, float scale,
                     T* __restrict__ dk, T* __restrict__ dv) {
  constexpr int SPLIT = DH / kSeg;
  __shared__ __align__(16) float qs[kTile * SPLIT * kSegPad];
  __shared__ __align__(16) float gs[kTile * SPLIT * kSegPad];
  __shared__ float lse_s[kTile], delta_s[kTile];

  const int bh = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x / SPLIT;  // a key
  const int h = threadIdx.x % SPLIT;
  const bool active = row < L;
  const size_t base = (size_t)bh * L * DH;
  const float* lse_b = lse + (size_t)bh * L;
  const float* delta_b = delta + (size_t)bh * L;
  const size_t at = base + (size_t)min(row, L - 1) * DH + h * kSeg;
  const float valid =
      (active && mask[(size_t)(bh / H) * L + row]) ? 1.f : 0.f;
  const float scale_t = round_t<T>(scale);

  float kr[kSeg], vr[kSeg], dka[kSeg], dva[kSeg];
  load_seg<T>(kr, k + at, active, 1.f);
  load_seg<T>(vr, v + at, active, 1.f);
#pragma unroll
  for (int d = 0; d < kSeg; ++d) dka[d] = dva[d] = 0.f;

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int n = min(kTile, L - t0);  // the same in every thread
    __syncthreads();
    stage<T, DH>(qs, q + base + (size_t)t0 * DH, n, scale_t);
    stage<T, DH>(gs, g + base + (size_t)t0 * DH, n, 1.f);
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      lse_s[i] = i < n ? lse_b[t0 + i] : 0.f;
      delta_s[i] = i < n ? delta_b[t0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float* qi = qs + seg_off<DH>(i, h);
      const float* gi = gs + seg_off<DH>(i, h);
      float s = row_sum<SPLIT>(seg_dot(kr, qi));
      s = valid != 0.f ? s : kNeg;
      const float p = expf(s - lse_s[i]);
      const float dp = row_sum<SPLIT>(seg_dot(vr, gi));
      seg_axpy(dka, round_t<T>(p * (dp - delta_s[i]) * valid), qi);
      seg_axpy(dva, round_t<T>(p), gi);
    }
  }

  if (active) {
#pragma unroll
    for (int d = 0; d < kSeg; ++d) {
      dk[at + d] = from_f<T>(dka[d]);
      dv[at + d] = from_f<T>(dva[d]);
    }
  }
}

template <typename T, int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* mask, const void* lse, const void* g,
                      const void* delta, int BH, int H, int L, float scale,
                      void* dq, cudaStream_t stream) {
  dim3 grid((L + kRows - 1) / kRows, BH);
  flash_dq_kernel<T, DH><<<grid, kRows * (DH / kSeg), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(lse), static_cast<const T*>(g),
      static_cast<const float*>(delta), H, L, scale, static_cast<T*>(dq));
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* mask, const void* lse, const void* g,
                       const void* delta, int BH, int H, int L, float scale,
                       void* dk, void* dv, cudaStream_t stream) {
  dim3 grid((L + kRows - 1) / kRows, BH);
  flash_dkv_kernel<T, DH><<<grid, kRows * (DH / kSeg), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(lse), static_cast<const T*>(g),
      static_cast<const float*>(delta), H, L, scale, static_cast<T*>(dk),
      static_cast<T*>(dv));
  return cudaGetLastError();
}

}  // namespace
}  // namespace flash

// q, k, v, g, dq, dk, dv: [BH, L, DH] of float (bf16 = 0) or bfloat16
// (bf16 = 1); mask: [BH / H, L] uint8; lse, delta: [BH, L] float.  Each
// returns a cudaError_t.
#define FLASH_DISPATCH(CALL)                               \
  if (BH == 0 || L == 0) return 0;                         \
  if (H <= 0 || BH % H) return (int)cudaErrorInvalidValue; \
  if (DH == 32 && !bf16) return (int)CALL(float, 32);      \
  if (DH == 64 && !bf16) return (int)CALL(float, 64);      \
  if (DH == 32 && bf16) return (int)CALL(__nv_bfloat16, 32); \
  if (DH == 64 && bf16) return (int)CALL(__nv_bfloat16, 64); \
  return (int)cudaErrorInvalidValue

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   const void* lse, const void* g,
                                   const void* delta, int BH, int H, int L,
                                   int DH, float scale, int bf16, void* dq,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ(T, D) \
  flash::launch_dq<T, D>(q, k, v, mask, lse, g, delta, BH, H, L, scale, dq, s)
  FLASH_DISPATCH(DQ);
#undef DQ
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    const void* lse, const void* g,
                                    const void* delta, int BH, int H, int L,
                                    int DH, float scale, int bf16, void* dk,
                                    void* dv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV(T, D)                                                          \
  flash::launch_dkv<T, D>(q, k, v, mask, lse, g, delta, BH, H, L, scale, dk, \
                          dv, s)
  FLASH_DISPATCH(DKV);
#undef DKV
}
