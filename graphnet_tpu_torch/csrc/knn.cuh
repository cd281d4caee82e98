// The kNN's distance arithmetic and its sorted top-k insertion, shared
// by csrc/knn.cu (the kNN kernel) and csrc/edgeconv_knn.cu (the kNN of
// the fused EdgeConv's output), so both pick neighbours alike.  knn.cu's
// note says why the arithmetic is non-fused and how ties are broken.

#pragma once

#include <cuda_runtime.h>

constexpr float kBig = 1e30f;

// |c|^2 or a.b over D coordinates, in coordinate order, one rounding per
// product and per sum (the plain version's order)
template <int D>
__device__ __forceinline__ float dot_rn(const float* a, const float* b) {
  float s = __fmul_rn(a[0], b[0]);
#pragma unroll
  for (int d = 1; d < D; ++d) s = __fadd_rn(s, __fmul_rn(a[d], b[d]));
  return s;
}

// |q|^2 + |k|^2 - 2 q.k, clamped at 0, rounded op by op
__device__ __forceinline__ float sq_dist(float qsq, float ksq, float cross) {
  return fmaxf(__fsub_rn(__fadd_rn(qsq, ksq), __fmul_rn(2.0f, cross)), 0.0f);
}

// Offer key `j` at squared distance `d` to the sorted list (bd, bi) of
// the K nearest so far.  Keys come in ascending index order; a key is
// inserted only when strictly closer than the current K-th, and equal
// distances stay behind the earlier (lower-index) key, which is top_k's
// tie rule.  The loop is unrolled, so the list stays in registers.
template <int K>
__device__ __forceinline__ void topk_insert(float (&bd)[K], int (&bi)[K],
                                            float d, int j) {
  if (d < bd[K - 1]) {
    // insert into the sorted list, dropping the last entry
#pragma unroll
    for (int p = K - 1; p > 0; --p) {
      if (bd[p - 1] > d) {
        bd[p] = bd[p - 1];
        bi[p] = bi[p - 1];
      } else if (bd[p] > d) {
        bd[p] = d;
        bi[p] = j;
      }
    }
    if (bd[0] > d) {
      bd[0] = d;
      bi[0] = j;
    }
  }
}
