// Masked softmax attention (flash forward) on dense-padded events, for
// Hopper.
//
// Replaces the TPU kernel graphnet_tpu/ops/flash_attention.py:_fwd_kernel.
// Same contract, per (batch*head, query row): q is scaled in its own
// dtype (round(q * round(scale))) before the product; logits q.k in
// fp32, a masked key's logit set to -1e5; online softmax in fp32 with
// the running max starting at -1e5; p rounded to the input dtype before
// the P.V product, fp32 accumulation; o = acc / max(l, 1e-30) in the
// input dtype and lse = m + log(max(l, 1e-30)) in fp32.  A fully masked
// row therefore comes out as the mean of v over the L keys, with
// lse = -1e5 + log(L).  The TPU's padding of a ragged L to lane tiles is
// not carried over: the last tile is loaded and looped over only as far
// as L.
//
// What bounds it on the H100: operations.  At TITO's shape (B*H = 64,
// L = 1024, Dh = 32) it does 4*B*H*L^2*Dh = 8.6 GFLOP on 17 MB of
// inputs, 0.13 ms at the fp32 CUDA-core peak (bf16 operands run the
// same fp32 CUDA-core path in this version).  The design keeps the
// logits and probabilities on chip: one block per (batch*head, 128
// query rows), each row held by Dh/32 threads (q and the accumulator in
// registers), keys and values streamed through shared memory in tiles
// of 32, the tile's logits in registers.  No tensor cores yet.

#include "flash_attention.cuh"

namespace flash {
namespace {

template <typename T, int DH>
__global__ void __launch_bounds__(kRows * (DH / kSeg))
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const uint8_t* __restrict__ mask,  // [B, L]
                     int H, int L, float scale,
                     T* __restrict__ o,                 // [B*H, L, DH]
                     float* __restrict__ lse) {         // [B*H, L]
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
  const float scale_t = round_t<T>(scale);
  const size_t at = base + (size_t)min(row, L - 1) * DH + h * kSeg;

  float qr[kSeg], acc[kSeg];
  load_seg<T>(qr, q + at, active, scale_t);
#pragma unroll
  for (int d = 0; d < kSeg; ++d) acc[d] = 0.f;
  float mrow = kNeg, lrow = 0.f;

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int n = min(kTile, L - t0);  // the same in every thread
    __syncthreads();
    stage<T, DH>(ks, k + base + (size_t)t0 * DH, n, 1.f);
    stage<T, DH>(vs, v + base + (size_t)t0 * DH, n, 1.f);
    for (int j = threadIdx.x; j < kTile; j += blockDim.x)
      kval[j] = (j < n && m[t0 + j]) ? 1.f : 0.f;
    __syncthreads();

    float s[kTile];
    float smax = kNeg;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      s[j] = 0.f;
      if (j < n) {
        const float x = row_sum<SPLIT>(seg_dot(qr, ks + seg_off<DH>(j, h)));
        s[j] = kval[j] != 0.f ? x : kNeg;
        smax = fmaxf(smax, s[j]);
      }
    }
    const float m_new = fmaxf(mrow, smax);
    const float corr = expf(mrow - m_new);
#pragma unroll
    for (int d = 0; d < kSeg; ++d) acc[d] *= corr;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < n) {
        const float p = expf(s[j] - m_new);
        psum += p;
        seg_axpy(acc, round_t<T>(p), vs + seg_off<DH>(j, h));
      }
    }
    lrow = lrow * corr + psum;
    mrow = m_new;
  }

  if (active) {
    const float ls = fmaxf(lrow, 1e-30f);
#pragma unroll
    for (int d = 0; d < kSeg; ++d) o[at + d] = from_f<T>(acc[d] / ls);
    if (h == 0) lse[(size_t)bh * L + row] = mrow + logf(ls);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, int BH, int H, int L, float scale,
                   void* o, void* lse, cudaStream_t stream) {
  dim3 grid((L + kRows - 1) / kRows, BH);
  flash_fwd_kernel<T, DH><<<grid, kRows * (DH / kSeg), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask), H, L,
      scale, static_cast<T*>(o), static_cast<float*>(lse));
  return cudaGetLastError();
}

}  // namespace
}  // namespace flash

// q, k, v, o: [BH, L, DH] of float (bf16 = 0) or bfloat16 (bf16 = 1);
// mask: [BH / H, L] uint8; lse: [BH, L] float.  Returns a cudaError_t.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* mask, int BH, int H, int L,
                                int DH, float scale, int bf16, void* o,
                                void* lse, void* stream) {
  using flash::launch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || L == 0) return 0;
  if (H <= 0 || BH % H) return (int)cudaErrorInvalidValue;
  if (DH == 32 && !bf16)
    return (int)launch<float, 32>(q, k, v, mask, BH, H, L, scale, o, lse, s);
  if (DH == 64 && !bf16)
    return (int)launch<float, 64>(q, k, v, mask, BH, H, L, scale, o, lse, s);
  if (DH == 32 && bf16)
    return (int)launch<__nv_bfloat16, 32>(q, k, v, mask, BH, H, L, scale, o,
                                          lse, s);
  if (DH == 64 && bf16)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, mask, BH, H, L, scale, o,
                                          lse, s);
  return (int)cudaErrorInvalidValue;
}
