// The Hopper primitives of the hand-written tensor-core kernels
// (flash_attention.cu, flash_attention_bwd.cu through flash_mma.cuh, the
// EdgeConv kernels and rel_flash_attention_bwd.cu): 16-byte cp.async
// copies into shared memory, bulk copies completing on mbarriers,
// ldmatrix, the bf16 mma.sync.m16n8k16 and the tf32 mma.sync.m16n8k8 with
// fp32 accumulation, and the packing of fp32 accumulators into bf16 A
// fragments.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, c = 2 * (lane % 4)):
//   A (16 x 16, row-major), 4 regs of bf16x2: a0 (g, c..c+1),
//     a1 (g+8, c..c+1), a2 (g, c+8..c+9), a3 (g+8, c+8..c+9);
//   B (16 x 8, k x n), 2 regs: b0 (k = c..c+1, n = g), b1 (k = c+8..c+9);
//   C / D (16 x 8, fp32), 4 floats: (g, c), (g, c+1), (g+8, c),
//     (g+8, c+1).
// So the accumulator of two adjacent n-tiles repacks, rounded to bf16,
// straight into the A fragment of a next product over those 16 columns
// (pack_a).  A row-major [rows][k] tile in shared memory gives A
// fragments by ldmatrix; a [n][k] tile gives B fragments by ldmatrix,
// a [k][n] tile by ldmatrix.trans.
// The tf32 mma.m16n8k8 (fp32 accumulation) takes A (16 x 8) in 4 regs:
// a0 (g, c/2), a1 (g+8, c/2), a2 (g, c/2+4), a3 (g+8, c/2+4); B (8 x 8)
// in 2: b0 (k = c/2, n = g), b1 (k = c/2+4, n = g); C / D as above.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

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

// wait until at most N of the committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// d += a . b, tf32 operands (m16n8k8; the low 13 bits of each operand
// are not read), fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the shared-memory address of p
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// an mbarrier in shared memory expecting `count` arrivals a phase
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

// makes initialised mbarriers visible to the async proxy
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// orders this thread's earlier shared-memory accesses (and those it has
// synchronised with) before its later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// arrive on bar, announcing `bytes` more to land in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory by the bulk-copy engine, completing on bar
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wait until the phase of bar with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// ---- end of PTX primitives

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

}  // namespace hopper
