// Batched k-nearest-neighbour graph on dense-padded events, for Hopper.
//
// Replaces the TPU kernel graphnet_tpu/ops/knn_pallas.py:_knn_kernel.
// Same contract: squared distances |q|^2 + |k|^2 - 2 q.k on coordinates
// already centred per event (the wrapper centres them, as the TPU
// wrapper does), clamped at 0; invalid keys and, with exclude_self, the
// query itself are never chosen; k nearest in ascending distance with
// ties to the lower key index; edge_mask = "a real key was chosen" and
// the query is valid.
//
// D is 3 (DynEdge's xyz) or 4 (TITO's xyzt), a template parameter like k.
//
// What bounds it on the H100: neither bytes nor FLOPs. At the serving
// shape (B=128, L=128, k=8, D=3) it reads 0.2 MB, writes 0.65 MB and
// does ~20 M flops, so the floor is launch latency (a few us).  The
// design keeps everything on chip and in one pass: one block per
// (event, tile of queries), one thread per query, the event's key
// coordinates streamed through shared memory in tiles of 256 (so any L
// the buckets give, up to 4096, fits without the >48 KB opt-in), and a
// sorted top-k kept in registers (k is a template parameter, so the
// insertion network is unrolled and never spills to local memory).
// Keys are scanned in ascending index order and a key is inserted only
// when strictly closer than the current k-th, which reproduces the
// lower-index tie rule of top_k.  Distances use the non-fused
// __fmul_rn/__fadd_rn intrinsics in the same order as the plain PyTorch
// version, so both give bit-identical distances and the same neighbours.
// The distance and the insertion live in knn.cuh, which edgeconv_knn.cu
// shares.

#include <cuda_runtime.h>
#include <stdint.h>

#include "knn.cuh"

namespace {

constexpr int kKeyTile = 256;

template <int K, int D>
__global__ void knn_kernel(const float* __restrict__ coords,    // [B, L, D]
                           const uint8_t* __restrict__ mask,    // [B, L]
                           int L, int exclude_self,
                           int32_t* __restrict__ idx_out,       // [B, L, K]
                           uint8_t* __restrict__ em_out) {      // [B, L, K]
  __shared__ float sc[kKeyTile][D];
  __shared__ float ssq[kKeyTile];
  __shared__ uint8_t sval[kKeyTile];

  const int b = blockIdx.y;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const float* ev = coords + (size_t)b * L * D;
  const uint8_t* m = mask + (size_t)b * L;
  const bool active = q < L;

  float qc[D];
  float qsq = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) qc[d] = active ? ev[q * D + d] : 0.f;
  if (active) qsq = dot_rn<D>(qc, qc);

  float bd[K];
  int bi[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    bd[i] = kBig;
    bi[i] = 0;
  }

  for (int t0 = 0; t0 < L; t0 += kKeyTile) {
    __syncthreads();
    for (int j = threadIdx.x; j < kKeyTile; j += blockDim.x) {
      const int g = t0 + j;
      if (g < L) {
#pragma unroll
        for (int d = 0; d < D; ++d) sc[j][d] = ev[g * D + d];
        ssq[j] = dot_rn<D>(sc[j], sc[j]);
        sval[j] = m[g];
      } else {
        sval[j] = 0;
      }
    }
    __syncthreads();
    if (!active) continue;
    const int n = min(kKeyTile, L - t0);
    for (int j = 0; j < n; ++j) {
      if (!sval[j] || (exclude_self && t0 + j == q)) continue;
      topk_insert<K>(bd, bi, sq_dist(qsq, ssq[j], dot_rn<D>(qc, sc[j])),
                     t0 + j);
    }
  }

  if (active) {
    const bool qvalid = m[q] != 0;
    const size_t o = ((size_t)b * L + q) * K;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      idx_out[o + i] = bi[i];
      em_out[o + i] = (qvalid && bd[i] < kBig * 0.5f) ? 1 : 0;
    }
  }
}

template <int K, int D>
cudaError_t launch(const float* coords, const uint8_t* mask, int B, int L,
                   int exclude_self, int32_t* idx, uint8_t* em,
                   cudaStream_t stream) {
  const int threads = L >= 128 ? 128 : ((L + 31) / 32) * 32;
  dim3 grid((L + threads - 1) / threads, B);
  knn_kernel<K, D><<<grid, threads, 0, stream>>>(coords, mask, L,
                                                  exclude_self, idx, em);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_k(const float* x, const uint8_t* m, int B, int L, int k,
                     int exclude_self, int32_t* i, uint8_t* e,
                     cudaStream_t s) {
  switch (k) {
#define KNN_CASE(K) \
  case K:           \
    return launch<K, D>(x, m, B, L, exclude_self, i, e, s);
    KNN_CASE(1) KNN_CASE(2) KNN_CASE(3) KNN_CASE(4)
    KNN_CASE(5) KNN_CASE(6) KNN_CASE(7) KNN_CASE(8)
    KNN_CASE(9) KNN_CASE(10) KNN_CASE(11) KNN_CASE(12)
    KNN_CASE(13) KNN_CASE(14) KNN_CASE(15) KNN_CASE(16)
#undef KNN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int knn_graph_launch(const void* coords, const void* mask, int B,
                                int L, int D, int k, int exclude_self,
                                void* idx, void* em, void* stream) {
  const float* x = static_cast<const float*>(coords);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int32_t* i = static_cast<int32_t*>(idx);
  uint8_t* e = static_cast<uint8_t*>(em);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || L == 0) return 0;
  if (D == 3) return (int)launch_k<3>(x, m, B, L, k, exclude_self, i, e, s);
  if (D == 4) return (int)launch_k<4>(x, m, B, L, k, exclude_self, i, e, s);
  return (int)cudaErrorInvalidValue;
}
