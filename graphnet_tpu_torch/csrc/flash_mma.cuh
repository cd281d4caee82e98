// Tile machinery shared by the Hopper flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): 16-byte cp.async copies
// of row tiles into padded shared memory, the key flags and row
// statistics beside them.  The PTX primitives (cp.async, ldmatrix,
// mma.sync.m16n8k16) and the fragment layouts the kernels rely on are in
// mma_bf16.cuh.
//
// Row tiles live in shared memory with a row stride of the row plus
// 16 bytes (pad_ld<T, DH>): at 48, 80 or 144 bytes (bf16, DH = 16, 32 or
// 64) the eight 16-byte rows one ldmatrix phase reads fall in distinct
// banks, and at DH + 4 floats (fp32) a float4 read of 16 rows strided by
// the pad is conflict-free.

#pragma once

#include "flash_attention.cuh"
#include "mma_bf16.cuh"

namespace flash {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait_all;
using hopper::ldmatrix_x4;
using hopper::ldmatrix_x4_trans;
using hopper::mma_bf16;
using hopper::pack_a;
using hopper::pack_bf16;

// elements of one staged row: DH and 16 bytes of pad
template <typename T, int DH>
__host__ __device__ constexpr int pad_ld() {
  return DH + 16 / (int)sizeof(T);
}

// whether every pointer is 16-byte aligned, as cp.async needs
inline bool aligned16(const void* a, const void* b, const void* c,
                      const void* d = nullptr) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) &
          15) == 0;
}

// the float4 at p (16-byte aligned), and its component u
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at4(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// the DN (1, 2 or 4) consecutive floats at p, 4 * DN-byte aligned: a
// thread's columns of an fp32 micro-tile (DH / 16 of a row)
template <int DN>
__device__ __forceinline__ void ld_cols(float (&w)[DN], const float* p) {
  if constexpr (DN == 4) {
    const float4 x = ld4(p);
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else if constexpr (DN == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    w[0] = x.x, w[1] = x.y;
  } else {
    static_assert(DN == 1, "DN is 1, 2 or 4");
    w[0] = *p;
  }
}

// w stored at p, as ld_cols reads it
template <int DN>
__device__ __forceinline__ void st_cols(float* p, const float (&w)[DN]) {
  if constexpr (DN == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(w[0], w[1], w[2], w[3]);
  } else if constexpr (DN == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(w[0], w[1]);
  } else {
    static_assert(DN == 1, "DN is 1, 2 or 4");
    *p = w[0];
  }
}

// Start the copy of rows [row0, row0 + ROWS) of src ([L, DH] of T,
// 16-byte aligned) into dst (ROWS x pad_ld<T, DH>() elements); rows at
// or beyond L are written as zeros.  Every thread of the block calls it
// with the same arguments; it commits nothing.
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int row0, int L) {
  constexpr int kPer = 16 / (int)sizeof(T);  // elements per chunk
  constexpr int kChunks = DH / kPer;         // chunks per row
  constexpr int LD = pad_ld<T, DH>();
  for (int c = threadIdx.x; c < ROWS * kChunks; c += blockDim.x) {
    const int r = c / kChunks, e = (c % kChunks) * kPer;
    const bool in = row0 + r < L;
    const T* g = src + (size_t)(in ? row0 + r : 0) * DH + e;
    cp_async16(dst + r * LD + e, g, in ? 16 : 0);
  }
}

// dst[j] for j < n of a tile at row0: 1 for a valid key, 0 for a masked
// one, -1 beyond L (keys that take no part at all)
__device__ __forceinline__ void load_key_flags(float* dst,
                                               const uint8_t* __restrict__ m,
                                               int row0, int L, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int r = row0 + j;
    dst[j] = r < L ? (m[r] ? 1.f : 0.f) : -1.f;
  }
}

// the lse and delta of rows [row0, row0 + n) into dst_lse, dst_delta;
// beyond L, lse = +inf and delta = 0, so such a row's p = exp(s - lse)
// and ds are exactly 0
__device__ __forceinline__ void load_row_stats(float* dst_lse,
                                               float* dst_delta,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               int row0, int L, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int r = row0 + j;
    dst_lse[j] = r < L ? lse[r] : INFINITY;
    dst_delta[j] = r < L ? delta[r] : 0.f;
  }
}

// every element x of a staged tile (ROWS x DH, row stride pad_ld) set to
// round_T(x * scale), the query's scaling in its own dtype
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void scale_tile(T* tile, float scale) {
  constexpr int LD = pad_ld<T, DH>();
  for (int e = threadIdx.x; e < ROWS * DH; e += blockDim.x) {
    T* x = tile + (e / DH) * LD + e % DH;
    *x = from_f<T>(to_f<T>(*x) * scale);
  }
}

}  // namespace flash
