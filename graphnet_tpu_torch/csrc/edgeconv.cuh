// The fused EdgeConv forward of one block of 64 edge rows, shared by
// csrc/edgeconv.cu (the forward kernel) and csrc/edgeconv_knn.cu (the
// forward fused with the next layer's kNN), so that both compute `out`
// with the same code and give the same bits.  edgeconv.cu's note says
// what the block does and what bounds it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace ec {


constexpr int kRows = 64;      // edge rows per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kChunk = 128;    // output columns per WMMA pass (8 warps x 16)
constexpr int kWld = kChunk + 8;  // bf16 elements per staged W2 row
constexpr int kOld = kChunk + 4;  // floats per staged output row

__device__ __forceinline__ float act(float x, float slope) {
  return slope == 0.0f ? fmaxf(x, 0.0f) : (x > 0.0f ? x : slope * x);
}

// Neighbour index and edge validity of the block's 64 rows; rows past
// the block's nodes, past L, or with an out-of-range index are invalid.
__device__ __forceinline__ void load_edges(const int32_t* __restrict__ idx,
                                           const uint8_t* __restrict__ em,
                                           int ev, int n0, int L, int k,
                                           int rows, int* s_idx,
                                           uint8_t* s_em) {
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    int j = 0;
    uint8_t e = 0;
    const int node = n0 + r / k;
    if (r < rows && node < L) {
      const size_t o = ((size_t)ev * L + node) * k + r % k;
      j = idx[o];
      e = em[o];
      if (j < 0 || j >= L) {
        j = 0;
        e = 0;
      }
    }
    s_idx[r] = j;
    s_em[r] = e;
  }
}

// The fp32 block: `msg` is the dynamic shared memory, [kRows][H1p]
// floats, then the edges.
__device__ __forceinline__ void fwd_f32(
    const float* __restrict__ a, const float* __restrict__ b,
    const int32_t* __restrict__ idx, const uint8_t* __restrict__ em,
    const float* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ out, int L, int H1, int H2, int k, int tl,
    float slope, int aggr_max, float* msg) {
  const int H1p = (H1 + 3) & ~3;
  int* s_idx = reinterpret_cast<int*>(msg + kRows * H1p);
  uint8_t* s_em = reinterpret_cast<uint8_t*>(s_idx + kRows);
  const int ev = blockIdx.y;
  const int n0 = blockIdx.x * tl;
  const int rows = tl * k;
  load_edges(idx, em, ev, n0, L, k, rows, s_idx, s_em);
  __syncthreads();

  const float* aE = a + (size_t)ev * L * H1;
  const float* bE = b + (size_t)ev * L * H1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const bool ok = s_em[r] != 0;
    const float* ar = aE + (size_t)(n0 + r / k) * H1;
    const float* br = bE + (size_t)s_idx[r] * H1;
    for (int h = lane; h < H1p; h += 32) {
      msg[r * H1p + h] = (ok && h < H1) ? act(ar[h] + br[h], slope) : 0.0f;
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < H2; c += blockDim.x) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int h = 0; h < H1p; h += 4) {
      const float w0 = w2[(size_t)h * H2 + c];
      const float w1 = h + 1 < H1 ? w2[(size_t)(h + 1) * H2 + c] : 0.0f;
      const float w2v = h + 2 < H1 ? w2[(size_t)(h + 2) * H2 + c] : 0.0f;
      const float w3 = h + 3 < H1 ? w2[(size_t)(h + 3) * H2 + c] : 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 m = *reinterpret_cast<const float4*>(&msg[r * H1p + h]);
        acc[r] = fmaf(m.x, w0, acc[r]);
        acc[r] = fmaf(m.y, w1, acc[r]);
        acc[r] = fmaf(m.z, w2v, acc[r]);
        acc[r] = fmaf(m.w, w3, acc[r]);
      }
    }
    const float bias = b2[c];
    float cur = aggr_max ? -1e30f : 0.0f;
    bool has = false;
    int kk = 0, node = n0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        if (s_em[r]) {
          const float v = act(acc[r] + bias, slope);
          cur = aggr_max ? fmaxf(cur, v) : cur + v;
          has = true;
        }
        if (++kk == k) {
          if (node < L) {
            out[((size_t)ev * L + node) * H2 + c] =
                (aggr_max && !has) ? 0.0f : cur;
          }
          cur = aggr_max ? -1e30f : 0.0f;
          has = false;
          kk = 0;
          ++node;
        }
      }
    }
  }
}

// The bf16 block: `smem` is the dynamic shared memory, one region with
// every WMMA tile 32-byte aligned:
// msg [64][ldm] bf16 | wt [16][kWld] bf16 | o [64][kOld] f32 | edges
__device__ __forceinline__ void fwd_bf16(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    const int32_t* __restrict__ idx, const uint8_t* __restrict__ em,
    const __nv_bfloat16* __restrict__ w2,
    const __nv_bfloat16* __restrict__ b2, float* __restrict__ out, int L,
    int H1, int H2, int k, int tl, float slope, int aggr_max,
    unsigned char* smem) {
  using namespace nvcuda;
  const int H1p = (H1 + 15) & ~15;
  const int ldm = H1p + 8;  // bf16 elements; 64*ldm*2 bytes is 128-aligned
  __nv_bfloat16* msg = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wt = msg + kRows * ldm;
  float* o = reinterpret_cast<float*>(wt + 16 * kWld);
  int* s_idx = reinterpret_cast<int*>(o + kRows * kOld);
  uint8_t* s_em = reinterpret_cast<uint8_t*>(s_idx + kRows);

  const int ev = blockIdx.y;
  const int n0 = blockIdx.x * tl;
  const int rows = tl * k;
  load_edges(idx, em, ev, n0, L, k, rows, s_idx, s_em);
  __syncthreads();

  const __nv_bfloat16* aE = a + (size_t)ev * L * H1;
  const __nv_bfloat16* bE = b + (size_t)ev * L * H1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const bool ok = s_em[r] != 0;
    const __nv_bfloat16* ar = aE + (size_t)(n0 + r / k) * H1;
    const __nv_bfloat16* br = bE + (size_t)s_idx[r] * H1;
    for (int h = lane; h < ldm; h += 32) {
      float v = 0.0f;
      if (ok && h < H1) {
        v = act(__bfloat162float(ar[h]) + __bfloat162float(br[h]), slope);
      }
      msg[r * ldm + h] = __float2bfloat16(v);
    }
  }

  for (int c0 = 0; c0 < H2; c0 += kChunk) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kRows / 16];
#pragma unroll
    for (int i = 0; i < kRows / 16; ++i) wmma::fill_fragment(acc[i], 0.0f);

    for (int h0 = 0; h0 < H1p; h0 += 16) {
      __syncthreads();  // previous slab consumed (and messages written)
      for (int t = threadIdx.x; t < 16 * kChunk; t += blockDim.x) {
        const int hh = t / kChunk, cc = t % kChunk;
        const int h = h0 + hh, c = c0 + cc;
        wt[hh * kWld + cc] = (h < H1 && c < H2)
                                 ? w2[(size_t)h * H2 + c]
                                 : __float2bfloat16(0.0f);
      }
      __syncthreads();
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bf;
      wmma::load_matrix_sync(bf, wt + 16 * warp, kWld);
#pragma unroll
      for (int i = 0; i < kRows / 16; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            af;
        wmma::load_matrix_sync(af, msg + 16 * i * ldm + h0, ldm);
        wmma::mma_sync(acc[i], af, bf, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows / 16; ++i) {
      wmma::store_matrix_sync(o + 16 * i * kOld + 16 * warp, acc[i], kOld,
                              wmma::mem_row_major);
    }
    __syncthreads();

    for (int t = threadIdx.x; t < tl * kChunk; t += blockDim.x) {
      const int nl = t / kChunk, cc = t % kChunk;
      const int node = n0 + nl, c = c0 + cc;
      if (node >= L || c >= H2) continue;
      const float bias = __bfloat162float(b2[c]);
      float cur = aggr_max ? -1e30f : 0.0f;
      bool has = false;
      for (int kk = 0; kk < k; ++kk) {
        const int r = nl * k + kk;
        if (!s_em[r]) continue;
        const float v = act(o[r * kOld + cc] + bias, slope);
        cur = aggr_max ? fmaxf(cur, v) : cur + v;
        has = true;
      }
      out[((size_t)ev * L + node) * H2 + c] = (aggr_max && !has) ? 0.0f : cur;
    }
    // the next chunk's first slab barrier also protects `o`
  }
}

// Shared memory a block needs, in bytes.
inline long long smem_bytes(int H1, int bf16) {
  const long long edges = kRows * (4 + 1);
  if (bf16) {
    const int ldm = ((H1 + 15) & ~15) + 8;
    return (long long)kRows * ldm * 2 + 16 * kWld * 2 +
           (long long)kRows * kOld * 4 + edges;
  }
  return (long long)kRows * ((H1 + 3) & ~3) * 4 + edges;
}

inline cudaError_t allow_smem(const void* kernel, size_t bytes,
                              size_t* configured) {
  if (bytes <= 48 * 1024 || bytes <= *configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *configured = bytes;
  return err;
}

}  // namespace ec
