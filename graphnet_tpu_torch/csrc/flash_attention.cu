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
// not carried over: keys at or beyond L take no part (p = 0 exactly),
// and rows at or beyond L are not written.
//
// Both versions own 64 query rows of one (batch*head) per block and
// stream the keys and values in tiles of 64 rows, double-buffered in
// shared memory by 16-byte cp.async (flash_mma.cuh), the next tile in
// flight while the block works on this one; the key mask comes beside
// each tile as flags.  The exponentials are __expf (the SFU's exp2 of
// x * log2(e), a few ulp): exactly 1 at the row max and 0 at -inf, so
// a row with one valid key reads that key's v exactly and a key beyond
// L adds exactly nothing.
//
// bf16: the tensor cores.  At TITO's shape (B*H = 64, L = 1024, Dh =
// 32) the products are 8.6 GFLOP, 8.7 us at the bf16 peak, and the
// exponentials (B*H*L^2 = 67 M) ~17 us on the SFUs, so the bound is
// the softmax, not the products.  Four warps of 16 query rows each hold
// their scaled q tile as mma A fragments; S = Q.K^T is Dh/16 k-steps of
// mma.sync.m16n8k16 (bf16 in, fp32 out) per 8 keys, with K read by
// ldmatrix (at Dh = 16 one k-step, one ldmatrix for two n-tiles); the
// row max and sum are taken across the four lanes of a row by
// shuffles; P, rounded to bf16, is repacked in registers into the A
// fragments of O += P.V, with V read by ldmatrix.trans.  mma.sync and
// not wgmma: at Dh = 32 the products are two k-steps deep.
//
// fp32: the CUDA cores in full fp32 (no TF32, the port's fp32
// contract).  Bound by the 4*B*H*L^2*Dh flops, 0.13 ms at TITO's shape
// at the 67 TFLOP/s fp32 peak.  256 threads as a 16 x 16 grid: a thread
// computes a 4 x 4 micro-tile of S (queries ty + 16i, keys tx + 16j,
// sixteen independent accumulators, float4 reads along Dh), the
// softmax statistics are taken across the 16 lanes that share a row by
// shuffles, P goes through shared memory, and the same thread then
// accumulates a 4 x Dh/16 micro-tile of O for its four rows (at Dh =
// 16 one column each).
//
// Head dims 16, 32 and 64 (RNN_TITO's DynTrans attention has 16 heads
// of 16).  At Dh = 16 a block does a quarter of Dh 64's work a key, the
// grid has the same (L/64) x B*H blocks, and the exponentials weigh
// more against the products: at RNN_TITO's B*H = 128, L = 1024 they are
// 134 M against 8.6 GFLOP of products.

#include "flash_attention.cuh"
#include "flash_mma.cuh"

namespace flash {
namespace {

constexpr int kBlockQ = 64;  // query rows a block owns
constexpr int kBlockK = 64;  // keys per streamed tile

// a logit by its key's flag (load_key_flags): valid, masked (-1e5), or
// beyond L (-inf: p = 0 exactly and no part in the max)
__device__ __forceinline__ float flag_logit(float s, float flag) {
  return flag > 0.f ? s : (flag == 0.f ? kNeg : -INFINITY);
}

// ------------------------------------------------------------ bf16

template <int DH>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (kBlockQ + 4 * kBlockK) *
             pad_ld<__nv_bfloat16, DH>() +
         sizeof(float) * 2 * kBlockK;
}

template <int DH>
__global__ void __launch_bounds__(128)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const uint8_t* __restrict__ mask,  // [B, L]
                         int H, int L, float scale,
                         __nv_bfloat16* __restrict__ o,     // [B*H, L, DH]
                         float* __restrict__ lse) {         // [B*H, L]
  using T = __nv_bfloat16;
  constexpr int LD = pad_ld<T, DH>();
  constexpr int KS = DH / 16;  // k-steps of Q.K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kBlockQ][LD]
  T* ks = qs + kBlockQ * LD;               // [2][kBlockK][LD]
  T* vs = ks + 2 * kBlockK * LD;           // [2][kBlockK][LD]
  float* kf = reinterpret_cast<float*>(vs + 2 * kBlockK * LD);  // [2][kBlockK]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int bh = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const size_t base = (size_t)bh * L * DH;
  const uint8_t* m = mask + (size_t)(bh / H) * L;
  const int nt = (L + kBlockK - 1) / kBlockK;

  load_tile<T, DH, kBlockQ>(qs, q + base, q0, L);
  load_tile<T, DH, kBlockK>(ks, k + base, 0, L);
  load_tile<T, DH, kBlockK>(vs, v + base, 0, L);
  cp_async_commit();
  load_key_flags(kf, m, 0, L, kBlockK);

  uint32_t qa[KS][4];
  float acc[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  // rows g and g + 8 of the warp's 16: running max, this lane's part of
  // the running sum
  float mrow[2] = {kNeg, kNeg}, lrow[2] = {0.f, 0.f};

  for (int t = 0; t < nt; ++t) {
    const int cur = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + 1 < nt) {
      const int nxt = cur ^ 1, r0 = (t + 1) * kBlockK;
      load_tile<T, DH, kBlockK>(ks + nxt * kBlockK * LD, k + base, r0, L);
      load_tile<T, DH, kBlockK>(vs + nxt * kBlockK * LD, v + base, r0, L);
      cp_async_commit();
      load_key_flags(kf + nxt * kBlockK, m, r0, L, kBlockK);
    }
    if (t == 0) {
      scale_tile<T, DH, kBlockQ>(qs, round_t<T>(scale));
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qa[kk], qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                (lane >> 4) * 8);
    }
    const T* kt = ks + cur * kBlockK * LD;
    const T* vt = vs + cur * kBlockK * LD;
    const float* f = kf + cur * kBlockK;

    // S = Q.K^T for the warp's 16 rows and the tile's 64 keys
    float s[kBlockK / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (KS == 1) {
      // DH = 16, one k-step: an ldmatrix_x4 gives the B fragments of two
      // n-tiles (keys n*8 .. n*8 + 15, both halves of the 16 dims)
#pragma unroll
      for (int n = 0; n < kBlockK / 8; n += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + (n * 8 + (lane & 7) + (lane >> 4) * 8) * LD +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(s[n], qa[0], b[0], b[1]);
        mma_bf16(s[n + 1], qa[0], b[2], b[3]);
      }
    } else {
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
        for (int kk = 0; kk < KS; kk += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, kt + (n * 8 + (lane & 7)) * LD + kk * 16 +
                             (lane >> 3) * 8);
          mma_bf16(s[n], qa[kk], b[0], b[1]);
          mma_bf16(s[n], qa[kk + 1], b[2], b[3]);
        }
      }
    }

    // the online softmax, rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = flag_logit(s[n][e], f[n * 8 + c + (e & 1)]);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = __expf(mrow[r] - mx[r]);
      mrow[r] = mx[r];
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - mx[e >> 1]);
        ps[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) lrow[r] = lrow[r] * corr[r] + ps[r];
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      acc[d][0] *= corr[0];
      acc[d][1] *= corr[0];
      acc[d][2] *= corr[1];
      acc[d][3] *= corr[1];
    }

    // O += round(P).V, 16 keys a k-step
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) {
        uint32_t b[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(b, vt + key * LD + np * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], pa, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = lrow[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float ls = fmaxf(l, 1e-30f);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row < L) {
      T* orow = o + base + (size_t)row * DH + c;
#pragma unroll
      for (int d = 0; d < DH / 8; ++d)
        *reinterpret_cast<uint32_t*>(orow + d * 8) =
            pack_bf16(acc[d][2 * r] / ls, acc[d][2 * r + 1] / ls);
      if ((lane & 3) == 0) lse[(size_t)bh * L + row] = mrow[r] + logf(ls);
    }
  }
}

// ------------------------------------------------------------ fp32

constexpr int kPld = kBlockK + 4;  // row stride of the staged P

template <int DH>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * ((kBlockQ + 4 * kBlockK) * pad_ld<float, DH>() +
                          kBlockQ * kPld + 2 * kBlockK);
}

template <int DH>
__global__ void __launch_bounds__(256)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const uint8_t* __restrict__ mask,  // [B, L]
                         int H, int L, float scale,
                         float* __restrict__ o,             // [B*H, L, DH]
                         float* __restrict__ lse) {         // [B*H, L]
  constexpr int LD = pad_ld<float, DH>();
  constexpr int DN = DH / 16;  // dims of O per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kBlockQ][LD]
  float* ks = qs + kBlockQ * LD;                   // [2][kBlockK][LD]
  float* vs = ks + 2 * kBlockK * LD;               // [2][kBlockK][LD]
  float* ps = vs + 2 * kBlockK * LD;               // [kBlockQ][kPld]
  float* kf = ps + kBlockQ * kPld;                 // [2][kBlockK]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const size_t base = (size_t)bh * L * DH;
  const uint8_t* m = mask + (size_t)(bh / H) * L;
  const int nt = (L + kBlockK - 1) / kBlockK;

  load_tile<float, DH, kBlockQ>(qs, q + base, q0, L);
  load_tile<float, DH, kBlockK>(ks, k + base, 0, L);
  load_tile<float, DH, kBlockK>(vs, v + base, 0, L);
  cp_async_commit();
  load_key_flags(kf, m, 0, L, kBlockK);

  // rows ty + 16 i; O columns DN * tx ..
  float acc[4][DN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DN; ++e) acc[i][e] = 0.f;
  float mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mrow[i] = kNeg, lrow[i] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int cur = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every thread is done with t - 1
    if (t + 1 < nt) {
      const int nxt = cur ^ 1, r0 = (t + 1) * kBlockK;
      load_tile<float, DH, kBlockK>(ks + nxt * kBlockK * LD, k + base, r0, L);
      load_tile<float, DH, kBlockK>(vs + nxt * kBlockK * LD, v + base, r0, L);
      cp_async_commit();
      load_key_flags(kf + nxt * kBlockK, m, r0, L, kBlockK);
    }
    if (t == 0) {
      scale_tile<float, DH, kBlockQ>(qs, scale);
      __syncthreads();
    }
    const float* kt = ks + cur * kBlockK * LD;
    const float* vt = vs + cur * kBlockK * LD;
    const float* f = kf + cur * kBlockK;

    // S micro-tile: queries ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = ld4(qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = ld4(kt + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // the online softmax across the 16 lanes of a row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = mrow[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = flag_logit(s[i][j], f[tx + 16 * j]);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float corr = __expf(mrow[i] - mx);
      mrow[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = __expf(s[i][j] - mx);
        sum += p;
        ps[(ty + 16 * i) * kPld + tx + 16 * j] = p;
      }
      lrow[i] = lrow[i] * corr + sum;
#pragma unroll
      for (int e = 0; e < DN; ++e) acc[i][e] *= corr;
    }
    __syncthreads();

    // O micro-tile += P.V
#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = ld4(ps + (ty + 16 * i) * kPld + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float w[DN];
        ld_cols<DN>(w, vt + (kk + u) * LD + DN * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = at4(p[i], u);
#pragma unroll
          for (int e = 0; e < DN; ++e) acc[i][e] = fmaf(pu, w[e], acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = lrow[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const float ls = fmaxf(l, 1e-30f);
    const int row = q0 + ty + 16 * i;
    if (row < L) {
      float out[DN];
#pragma unroll
      for (int e = 0; e < DN; ++e) out[e] = acc[i][e] / ls;
      st_cols<DN>(o + base + (size_t)row * DH + DN * tx, out);
      if (tx == 0) lse[(size_t)bh * L + row] = mrow[i] + logf(ls);
    }
  }
}

template <typename T>
cudaError_t launch(void (*kern)(const T*, const T*, const T*, const uint8_t*,
                                int, int, float, T*, float*),
                   size_t bytes, int threads, const void* q, const void* k,
                   const void* v, const void* mask, int BH, int H, int L,
                   float scale, void* o, void* lse, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kBlockQ - 1) / kBlockQ, BH);
  kern<<<grid, threads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask), H, L,
      scale, static_cast<T*>(o), static_cast<float*>(lse));
  return cudaGetLastError();
}

}  // namespace
}  // namespace flash

// q, k, v, o: [BH, L, DH] of float (bf16 = 0) or bfloat16 (bf16 = 1),
// 16-byte aligned; mask: [BH / H, L] uint8; lse: [BH, L] float.  Returns
// a cudaError_t.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* mask, int BH, int H, int L,
                                int DH, float scale, int bf16, void* o,
                                void* lse, void* stream) {
  using namespace flash;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || L == 0) return 0;
  if (H <= 0 || BH % H) return (int)cudaErrorInvalidValue;
  if (!aligned16(q, k, v)) return (int)cudaErrorMisalignedAddress;
#define FWD(KERN, BYTES, THREADS) \
  launch(KERN, BYTES, THREADS, q, k, v, mask, BH, H, L, scale, o, lse, s)
  if (DH == 16 && !bf16)
    return (int)FWD(flash_fwd_f32_kernel<16>, f32_smem_bytes<16>(), 256);
  if (DH == 32 && !bf16)
    return (int)FWD(flash_fwd_f32_kernel<32>, f32_smem_bytes<32>(), 256);
  if (DH == 64 && !bf16)
    return (int)FWD(flash_fwd_f32_kernel<64>, f32_smem_bytes<64>(), 256);
  if (DH == 16 && bf16)
    return (int)FWD(flash_fwd_mma_kernel<16>, mma_smem_bytes<16>(), 128);
  if (DH == 32 && bf16)
    return (int)FWD(flash_fwd_mma_kernel<32>, mma_smem_bytes<32>(), 128);
  if (DH == 64 && bf16)
    return (int)FWD(flash_fwd_mma_kernel<64>, mma_smem_bytes<64>(), 128);
#undef FWD
  return (int)cudaErrorInvalidValue;
}

// the dynamic shared memory a forward block takes, in bytes (0 for a
// head dim the kernels do not take)
extern "C" int flash_fwd_smem_bytes(int DH, int bf16) {
  using namespace flash;
  if (DH == 16)
    return (int)(bf16 ? mma_smem_bytes<16>() : f32_smem_bytes<16>());
  if (DH == 32)
    return (int)(bf16 ? mma_smem_bytes<32>() : f32_smem_bytes<32>());
  if (DH == 64)
    return (int)(bf16 ? mma_smem_bytes<64>() : f32_smem_bytes<64>());
  return 0;
}
