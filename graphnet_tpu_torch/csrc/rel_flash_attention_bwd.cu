// Backward of the relative-bias attention (rel_flash_attention.cu), for
// Hopper: dq with dqt and dqb, and dk with dv.
//
// Replaces the TPU kernels graphnet_tpu/ops/rel_flash_attention.py:
// _rel_bwd_dq_kernel and _rel_bwd_dkv_kernel.  Same contract, the
// extended-value recompute: the pair embedding is an extension of the
// value, so with the forward's lse, p = exp(logit - lse) (logits formed
// as in the forward, a masked key at -1e5), dp = do.v + doe.emb_ij,
// ds = p * (dp - delta) * valid, delta = do.o + doe.oe from the wrapper;
// dq = sum_j ds.k (ds rounded to the input dtype), dqt = sum_j ds.emb_ij
// and dqb = sum_j ds in fp32; dk = sum_i ds.q (ds rounded), dv =
// sum_i p.do (p rounded).  Both kernels form p with the same operations
// in the same order, so they see the same bits.
//
// What bounds it on the H100: operations, ~12*hd flops per (b, h, i, j)
// in each kernel (two logit dots, two dp dots, two updates), plus hd/2
// precise sincos per (b, i, j) in each.  The split is the TPU's, and it
// keeps the kernels free of atomics: the dq kernel owns 32 query rows per
// block (one per lane) and streams key tiles; the dkv kernel owns 32 key
// rows and streams query tiles.  Each block holds a group of up to 4
// heads (a warp each) and computes each tile's pair embedding once for
// the group, in shared memory.  Every sum runs in a fixed order, so two
// runs give the same bits.

#include "rel_flash_attention.cuh"

namespace relattn {
namespace {

constexpr int kBwdHeads = 4;  // most heads a block holds

template <typename T, int HD>
__global__ void __launch_bounds__(kLanes * kBwdHeads)
    rel_dq_kernel(const T* __restrict__ q, const float* __restrict__ qt,
                  const float* __restrict__ qb, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ x0,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ freqs,
                  const float* __restrict__ lse, const T* __restrict__ dout,
                  const float* __restrict__ doe,
                  const float* __restrict__ delta, int H, int L, int XF,
                  T* __restrict__ dq, float* __restrict__ dqt,
                  float* __restrict__ dqb) {
  constexpr int E = HD;
  extern __shared__ __align__(16) float smem[];
  const int hg = blockDim.x / kLanes;
  float* emb = smem;                     // [kTile][E][32]
  float* ks = emb + kTile * E * kLanes;  // [hg][kTile][HD]
  float* vs = ks + hg * kTile * HD;      // [hg][kTile][HD]
  float* kval = vs + hg * kTile * HD;    // [kTile]

  const int lane = threadIdx.x % kLanes, w = threadIdx.x / kLanes;
  const int b = blockIdx.z, h0 = blockIdx.y * hg;
  const int row0 = blockIdx.x * kLanes, row = row0 + lane;
  const bool active = row < L;
  const size_t bh = (size_t)b * H + h0 + w;
  const size_t at = (bh * L + min(row, L - 1)) * HD;
  const size_t st = bh * L + min(row, L - 1);
  const float* x0b = x0 + (size_t)b * L * XF;
  const uint8_t* mb = mask + (size_t)b * L;

  float qr[HD], qtr[E], dor[HD], doer[E], acc[HD], acce[E];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = active ? to_f<T>(q[at + d]) : 0.f;
    qtr[d] = active ? qt[at + d] : 0.f;
    dor[d] = active ? to_f<T>(dout[at + d]) : 0.f;
    doer[d] = active ? doe[at + d] : 0.f;
    acc[d] = 0.f;
    acce[d] = 0.f;
  }
  const float qbr = active ? qb[st] : 0.f;
  const float lser = active ? lse[st] : 0.f;
  const float deltar = active ? delta[st] : 0.f;
  float accb = 0.f;

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int n = min(kTile, L - t0);  // the same in every thread
    __syncthreads();
    emb_tile<E>(emb, x0b, XF, L, row0, t0, true, freqs);
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
    for (int j = 0; j < n; ++j) {
      const float* kj = kh + j * HD;
      const float* vj = vh + j * HD;
      const float* ej = emb + j * E * kLanes + lane;
      const float valid = kval[j];
      float a = 0.f, ae = 0.f, dpv = 0.f, dpe = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        a = fmaf(qr[d], kj[d], a);
        dpv = fmaf(dor[d], vj[d], dpv);
      }
#pragma unroll
      for (int d = 0; d < E; ++d) {
        const float x = ej[d * kLanes];
        ae = fmaf(qtr[d], x, ae);
        dpe = fmaf(doer[d], x, dpe);
      }
      float s = (a + ae) + qbr;
      s = valid != 0.f ? s : kNeg;
      const float p = expf(s - lser);
      const float ds = p * (dpv + dpe - deltar) * valid;
      const float dsr = round_t<T>(ds);
      accb += ds;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        acc[d] = fmaf(dsr, kj[d], acc[d]);
        acce[d] = fmaf(ds, ej[d * kLanes], acce[d]);
      }
    }
  }

  if (active) {
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      dq[at + d] = from_f<T>(acc[d]);
      dqt[at + d] = acce[d];
    }
    dqb[st] = accb;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kLanes * kBwdHeads)
    rel_dkv_kernel(const T* __restrict__ q, const float* __restrict__ qt,
                   const float* __restrict__ qb, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ x0,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ freqs,
                   const float* __restrict__ lse, const T* __restrict__ dout,
                   const float* __restrict__ doe,
                   const float* __restrict__ delta, int H, int L, int XF,
                   T* __restrict__ dk, T* __restrict__ dv) {
  constexpr int E = HD;
  extern __shared__ __align__(16) float smem[];
  const int hg = blockDim.x / kLanes;
  float* emb = smem;                      // [kTile][E][32], lane = key
  float* qs = emb + kTile * E * kLanes;   // [hg][kTile][HD], q
  float* qts = qs + hg * kTile * HD;      // qt
  float* dos = qts + hg * kTile * HD;     // do
  float* does = dos + hg * kTile * HD;    // doe
  float* rows = does + hg * kTile * HD;   // [hg][3][kTile]: qb, lse, delta

  const int lane = threadIdx.x % kLanes, w = threadIdx.x / kLanes;
  const int b = blockIdx.z, h0 = blockIdx.y * hg;
  const int key0 = blockIdx.x * kLanes, key = key0 + lane;
  const bool active = key < L;
  const size_t bh = (size_t)b * H + h0 + w;
  const size_t at = (bh * L + min(key, L - 1)) * HD;
  const float* x0b = x0 + (size_t)b * L * XF;
  const float valid = (active && mask[(size_t)b * L + key]) ? 1.f : 0.f;

  float kr[HD], vr[HD], dka[HD], dva[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    kr[d] = active ? to_f<T>(k[at + d]) : 0.f;
    vr[d] = active ? to_f<T>(v[at + d]) : 0.f;
    dka[d] = 0.f;
    dva[d] = 0.f;
  }

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int n = min(kTile, L - t0);  // the same in every thread
    __syncthreads();
    emb_tile<E>(emb, x0b, XF, L, key0, t0, false, freqs);
    for (int e = threadIdx.x; e < hg * kTile * HD; e += blockDim.x) {
      const int hh = e / (kTile * HD), r = (e / HD) % kTile, c = e % HD;
      float a = 0.f, at_ = 0.f, g = 0.f, ge = 0.f;
      if (r < n) {
        const size_t i = (((size_t)b * H + h0 + hh) * L + t0 + r) * HD + c;
        a = to_f<T>(q[i]);
        at_ = qt[i];
        g = to_f<T>(dout[i]);
        ge = doe[i];
      }
      qs[e] = a;
      qts[e] = at_;
      dos[e] = g;
      does[e] = ge;
    }
    for (int e = threadIdx.x; e < hg * kTile; e += blockDim.x) {
      const int hh = e / kTile, r = e % kTile;
      const size_t i = ((size_t)b * H + h0 + hh) * L + t0 + min(r, n - 1);
      rows[(hh * 3 + 0) * kTile + r] = qb[i];
      rows[(hh * 3 + 1) * kTile + r] = lse[i];
      rows[(hh * 3 + 2) * kTile + r] = delta[i];
    }
    __syncthreads();

    const float* qh = qs + w * kTile * HD;
    const float* qth = qts + w * kTile * HD;
    const float* doh = dos + w * kTile * HD;
    const float* doeh = does + w * kTile * HD;
    const float* rh = rows + w * 3 * kTile;
    for (int i = 0; i < n; ++i) {
      const float* qi = qh + i * HD;
      const float* qti = qth + i * HD;
      const float* doi = doh + i * HD;
      const float* doei = doeh + i * HD;
      const float* ei = emb + i * E * kLanes + lane;
      float a = 0.f, ae = 0.f, dpv = 0.f, dpe = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        a = fmaf(qi[d], kr[d], a);
        dpv = fmaf(doi[d], vr[d], dpv);
      }
#pragma unroll
      for (int d = 0; d < E; ++d) {
        const float x = ei[d * kLanes];
        ae = fmaf(qti[d], x, ae);
        dpe = fmaf(doei[d], x, dpe);
      }
      float s = (a + ae) + rh[i];
      s = valid != 0.f ? s : kNeg;
      const float p = expf(s - rh[kTile + i]);
      const float ds = round_t<T>(p * (dpv + dpe - rh[2 * kTile + i]) * valid);
      const float pr = round_t<T>(p);
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dka[d] = fmaf(ds, qi[d], dka[d]);
        dva[d] = fmaf(pr, doi[d], dva[d]);
      }
    }
  }

  if (active) {
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      dk[at + d] = from_f<T>(dka[d]);
      dv[at + d] = from_f<T>(dva[d]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* qt, const void* qb,
                      const void* k, const void* v, const void* x0,
                      const void* mask, const void* freqs, const void* lse,
                      const void* dout, const void* doe, const void* delta,
                      int B, int H, int L, int XF, void* dq, void* dqt,
                      void* dqb, cudaStream_t stream) {
  const int hg = head_group(H, kBwdHeads);
  const size_t bytes =
      sizeof(float) * (kTile * HD * kLanes + 2 * hg * kTile * HD + kTile);
  auto kern = rel_dq_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kLanes - 1) / kLanes, H / hg, B);
  kern<<<grid, kLanes * hg, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const float*>(qt),
      static_cast<const float*>(qb), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(x0),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(freqs),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const float*>(doe), static_cast<const float*>(delta), H, L,
      XF, static_cast<T*>(dq), static_cast<float*>(dqt),
      static_cast<float*>(dqb));
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* qt, const void* qb,
                       const void* k, const void* v, const void* x0,
                       const void* mask, const void* freqs, const void* lse,
                       const void* dout, const void* doe, const void* delta,
                       int B, int H, int L, int XF, void* dk, void* dv,
                       cudaStream_t stream) {
  const int hg = head_group(H, kBwdHeads);
  const size_t bytes = sizeof(float) * (kTile * HD * kLanes +
                                        4 * hg * kTile * HD + 3 * hg * kTile);
  auto kern = rel_dkv_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kLanes - 1) / kLanes, H / hg, B);
  kern<<<grid, kLanes * hg, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const float*>(qt),
      static_cast<const float*>(qb), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(x0),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(freqs),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const float*>(doe), static_cast<const float*>(delta), H, L,
      XF, static_cast<T*>(dk), static_cast<T*>(dv));
  return cudaGetLastError();
}

}  // namespace
}  // namespace relattn

// q, k, v, dout, dq, dk, dv: [B, H, L, HD] of float (bf16 = 0) or
// bfloat16 (bf16 = 1); qt, doe, dqt: [B, H, L, HD] float; qb, lse,
// delta, dqb: [B, H, L] float; x0: [B, L, XF] float; mask: [B, L]
// uint8; freqs: [HD / 2] float.  Each returns a cudaError_t.
#define REL_DISPATCH(CALL)                                 \
  if (B == 0 || L == 0 || H == 0) return 0;                \
  if (H < 0 || XF < 4) return (int)cudaErrorInvalidValue;  \
  if (HD == 16 && !bf16) return (int)CALL(float, 16);      \
  if (HD == 32 && !bf16) return (int)CALL(float, 32);      \
  if (HD == 16 && bf16) return (int)CALL(__nv_bfloat16, 16); \
  if (HD == 32 && bf16) return (int)CALL(__nv_bfloat16, 32); \
  return (int)cudaErrorInvalidValue

extern "C" int rel_bwd_dq_launch(const void* q, const void* qt,
                                 const void* qb, const void* k,
                                 const void* v, const void* x0,
                                 const void* mask, const void* freqs,
                                 const void* lse, const void* dout,
                                 const void* doe, const void* delta, int B,
                                 int H, int L, int HD, int XF, int bf16,
                                 void* dq, void* dqt, void* dqb,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ(T, D)                                                           \
  relattn::launch_dq<T, D>(q, qt, qb, k, v, x0, mask, freqs, lse, dout, doe, \
                           delta, B, H, L, XF, dq, dqt, dqb, s)
  REL_DISPATCH(DQ);
#undef DQ
}

extern "C" int rel_bwd_dkv_launch(const void* q, const void* qt,
                                  const void* qb, const void* k,
                                  const void* v, const void* x0,
                                  const void* mask, const void* freqs,
                                  const void* lse, const void* dout,
                                  const void* doe, const void* delta, int B,
                                  int H, int L, int HD, int XF, int bf16,
                                  void* dk, void* dv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV(T, D)                                                           \
  relattn::launch_dkv<T, D>(q, qt, qb, k, v, x0, mask, freqs, lse, dout, doe, \
                            delta, B, H, L, XF, dk, dv, s)
  REL_DISPATCH(DKV);
#undef DKV
}
