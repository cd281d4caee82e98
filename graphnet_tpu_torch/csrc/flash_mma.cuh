// Tile machinery shared by the Hopper flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): 16-byte cp.async copies
// of row tiles into padded shared memory, ldmatrix and the bf16
// mma.sync.m16n8k16 of the tensor cores, and the fragment layouts the
// kernels rely on.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, c = 2 * (lane % 4)):
//   A (16 x 16, row-major), 4 regs of bf16x2: a0 (g, c..c+1),
//     a1 (g+8, c..c+1), a2 (g, c+8..c+9), a3 (g+8, c+8..c+9);
//   B (16 x 8, k x n), 2 regs: b0 (k = c..c+1, n = g), b1 (k = c+8..c+9);
//   C / D (16 x 8, fp32), 4 floats: (g, c), (g, c+1), (g+8, c),
//     (g+8, c+1).
// So the accumulator of two adjacent n-tiles of an S = Q.K^T product
// repacks, rounded to bf16, straight into the A fragment of the next
// product over those 16 columns (pack_a below): P never goes through
// shared memory.
//
// Row tiles live in shared memory with a row stride of the row plus
// 16 bytes (pad_ld<T, DH>): at 80 or 144 bytes (bf16, DH = 32 or 64) the
// eight 16-byte rows one ldmatrix phase reads fall in distinct banks,
// and at DH + 4 floats (fp32) a float4 read of 16 rows strided by the
// pad is conflict-free.

#pragma once

#include "flash_attention.cuh"

namespace flash {

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

// ---- PTX primitives

// 16 bytes from global to shared memory, asynchronously; src_bytes = 0
// writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until every committed group has landed (this thread's copies)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// four 8 x 8 bf16 matrices; lanes 8m..8m+7 give the row addresses of
// matrix m, and r[m] is this lane's (row g, cols c..c+1) of matrix m
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// as ldmatrix_x4, transposed: r[m] is (rows c..c+1, col g) of matrix m
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a . b, bf16 operands, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- end of PTX primitives

// the float4 at p (16-byte aligned), and its component u
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at4(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// (lo, hi) rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// the A fragment over the 16 columns of the C fragments of two adjacent
// n-tiles (columns 0-7 in c0, 8-15 in c1), each value rounded to bf16
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
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
