// Relative-bias attention forward (DeepIce's first BlockRel), for
// Hopper.
//
// Replaces the TPU kernel graphnet_tpu/ops/rel_flash_attention.py:
// _rel_fwd_kernel.  Same contract, per (batch, head, query row), with q
// already scaled: logits q.k + qt.emb_ij + qb in fp32, where emb_ij is
// the sinusoidal embedding of 1024 * clip(signed sqrt spacetime
// interval) between pulses i and j (rel_flash_attention.cuh); a masked
// key's logit is -1e5; online softmax over key tiles of 16 with the
// running max from -1e5; p rounded to the input dtype before p.v, fp32
// for p.emb; o = acc / max(l, 1e-30) in the input dtype, oe = acc_e /
// max(l, 1e-30) and lse = m + log(max(l, 1e-30)) in fp32.  A fully
// masked row comes out as the means of v and of emb over the L keys,
// with lse = -1e5 + log(L).  Any L: the last tile runs only as far as L.
//
// What bounds it on the H100: operations.  Per (b, h, i, j) it does
// ~8*hd flops (q.k, qt.emb, p.v, p.emb: 4 * 2 * hd), 0.43 ms at the
// fp32 CUDA-core peak at DeepIce's shape (B=16, H=12, L=768, hd=32),
// plus hd/2 precise sincos per (b, i, j).  The design: one block per
// (batch, 32 query rows, group of up to 6 heads), a warp per head and a
// lane per query row holding q, qt and the two accumulators in
// registers; per tile of 16 keys the block stages k and v of its heads
// and the (32 x 16) pair embedding in shared memory, so the sincos are
// computed once per group of heads, not once per head.  No tensor
// cores, no atomics.

#include "rel_flash_attention.cuh"

namespace relattn {
namespace {

constexpr int kFwdHeads = 6;  // most heads a block holds

template <typename T, int HD>
__global__ void __launch_bounds__(kLanes * kFwdHeads)
    rel_fwd_kernel(const T* __restrict__ q, const float* __restrict__ qt,
                   const float* __restrict__ qb, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ x0,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ freqs, int H, int L, int XF,
                   T* __restrict__ o, float* __restrict__ oe,
                   float* __restrict__ lse) {
  constexpr int E = HD;
  extern __shared__ __align__(16) float smem[];
  const int hg = blockDim.x / kLanes;
  float* emb = smem;                       // [kTile][E][32]
  float* ks = emb + kTile * E * kLanes;    // [hg][kTile][HD]
  float* vs = ks + hg * kTile * HD;        // [hg][kTile][HD]
  float* kval = vs + hg * kTile * HD;      // [kTile]

  const int lane = threadIdx.x % kLanes, w = threadIdx.x / kLanes;
  const int b = blockIdx.z, h0 = blockIdx.y * hg;
  const int row0 = blockIdx.x * kLanes, row = row0 + lane;
  const bool active = row < L;
  const size_t bh = (size_t)b * H + h0 + w;
  const size_t at = (bh * L + min(row, L - 1)) * HD;
  const float* x0b = x0 + (size_t)b * L * XF;
  const uint8_t* mb = mask + (size_t)b * L;

  float qr[HD], qtr[E], acc[HD], acce[E];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = active ? to_f<T>(q[at + d]) : 0.f;
    qtr[d] = active ? qt[at + d] : 0.f;
    acc[d] = 0.f;
    acce[d] = 0.f;
  }
  const float qbr = active ? qb[bh * L + row] : 0.f;
  float mrow = kNeg, lrow = 0.f;

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int n = min(kTile, L - t0);  // the same in every thread
    __syncthreads();
    emb_tile<E>(emb, x0b, XF, L, row0, t0, freqs);
    for (int e = threadIdx.x; e < hg * kTile * HD; e += blockDim.x) {
      const int hh = e / (kTile * HD), r = (e / HD) % kTile, c = e % HD;
      float kx = 0.f, vx = 0.f;
      if (r < n) {
        const size_t g = (((size_t)b * H + h0 + hh) * L + t0 + r) * HD + c;
        kx = to_f<T>(k[g]);
        vx = to_f<T>(v[g]);
      }
      ks[e] = kx;
      vs[e] = vx;
    }
    for (int j = threadIdx.x; j < kTile; j += blockDim.x)
      kval[j] = (j < n && mb[t0 + j]) ? 1.f : 0.f;
    __syncthreads();

    const float* kh = ks + w * kTile * HD;
    const float* vh = vs + w * kTile * HD;
    float s[kTile];
    float smax = kNeg;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      s[j] = kNeg;
      if (j < n) {
        float a = 0.f, ae = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) a = fmaf(qr[d], kh[j * HD + d], a);
        const float* ej = emb + j * E * kLanes + lane;
#pragma unroll
        for (int d = 0; d < E; ++d) ae = fmaf(qtr[d], ej[d * kLanes], ae);
        const float x = (a + ae) + qbr;
        s[j] = kval[j] != 0.f ? x : kNeg;
        smax = fmaxf(smax, s[j]);
      }
    }
    const float m_new = fmaxf(mrow, smax);
    const float corr = expf(mrow - m_new);
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      acc[d] *= corr;
      acce[d] *= corr;
    }
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < n) {
        const float p = expf(s[j] - m_new);
        const float pr = round_t<T>(p);
        psum += p;
        const float* ej = emb + j * E * kLanes + lane;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          acc[d] = fmaf(pr, vh[j * HD + d], acc[d]);
          acce[d] = fmaf(p, ej[d * kLanes], acce[d]);
        }
      }
    }
    lrow = lrow * corr + psum;
    mrow = m_new;
  }

  if (active) {
    const float ls = fmaxf(lrow, 1e-30f);
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      o[at + d] = from_f<T>(acc[d] / ls);
      oe[at + d] = acce[d] / ls;
    }
    lse[bh * L + row] = mrow + logf(ls);
  }
}

// the dynamic shared memory of a block of hg heads
inline size_t fwd_smem_bytes(int HD, int hg) {
  return sizeof(float) * (kTile * HD * kLanes + 2 * hg * kTile * HD + kTile);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* qt, const void* qb,
                   const void* k, const void* v, const void* x0,
                   const void* mask, const void* freqs, int B, int H, int L,
                   int XF, void* o, void* oe, void* lse,
                   cudaStream_t stream) {
  const int hg = head_group(H, kFwdHeads);
  const size_t bytes = fwd_smem_bytes(HD, hg);
  auto kern = rel_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kLanes - 1) / kLanes, H / hg, B);
  kern<<<grid, kLanes * hg, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const float*>(qt),
      static_cast<const float*>(qb), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(x0),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(freqs), H,
      L, XF, static_cast<T*>(o), static_cast<float*>(oe),
      static_cast<float*>(lse));
  return cudaGetLastError();
}

}  // namespace
}  // namespace relattn

// q, k, v, o: [B, H, L, HD] of float (bf16 = 0) or bfloat16 (bf16 = 1);
// qt, oe: [B, H, L, HD] float; qb, lse: [B, H, L] float; x0: [B, L, XF]
// float (XF >= 4: x, y, z, t first); mask: [B, L] uint8; freqs: [HD / 2]
// float.  Returns a cudaError_t.
extern "C" int rel_fwd_launch(const void* q, const void* qt, const void* qb,
                              const void* k, const void* v, const void* x0,
                              const void* mask, const void* freqs, int B,
                              int H, int L, int HD, int XF, int bf16,
                              void* o, void* oe, void* lse, void* stream) {
  using relattn::launch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || L == 0 || H == 0) return 0;
  if (H < 0 || XF < 4) return (int)cudaErrorInvalidValue;
#define FWD(T, D) \
  launch<T, D>(q, qt, qb, k, v, x0, mask, freqs, B, H, L, XF, o, oe, lse, s)
  if (HD == 16 && !bf16) return (int)FWD(float, 16);
  if (HD == 32 && !bf16) return (int)FWD(float, 32);
  if (HD == 16 && bf16) return (int)FWD(__nv_bfloat16, 16);
  if (HD == 32 && bf16) return (int)FWD(__nv_bfloat16, 32);
#undef FWD
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory of a launch over H heads at head dim HD (0
// for a head dim the kernel is not built for).
extern "C" int rel_fwd_smem_bytes(int HD, int H) {
  if (HD != 16 && HD != 32) return 0;
  return (int)relattn::fwd_smem_bytes(
      HD, relattn::head_group(H, relattn::kFwdHeads));
}
