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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kKeyTile = 256;

template <int K>
__global__ void knn_kernel(const float* __restrict__ xyz,       // [B, L, 3]
                           const uint8_t* __restrict__ mask,    // [B, L]
                           int L, int exclude_self,
                           int32_t* __restrict__ idx_out,       // [B, L, K]
                           uint8_t* __restrict__ em_out) {      // [B, L, K]
  __shared__ float sx[kKeyTile], sy[kKeyTile], sz[kKeyTile], ssq[kKeyTile];
  __shared__ uint8_t sval[kKeyTile];

  const int b = blockIdx.y;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const float* ev = xyz + (size_t)b * L * 3;
  const uint8_t* m = mask + (size_t)b * L;
  const bool active = q < L;

  float qx = 0.f, qy = 0.f, qz = 0.f, qsq = 0.f;
  if (active) {
    qx = ev[q * 3 + 0];
    qy = ev[q * 3 + 1];
    qz = ev[q * 3 + 2];
    qsq = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)),
                    __fmul_rn(qz, qz));
  }

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
        const float x = ev[g * 3 + 0], y = ev[g * 3 + 1], z = ev[g * 3 + 2];
        sx[j] = x;
        sy[j] = y;
        sz[j] = z;
        ssq[j] = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                           __fmul_rn(z, z));
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
      const float cross =
          __fadd_rn(__fadd_rn(__fmul_rn(qx, sx[j]), __fmul_rn(qy, sy[j])),
                    __fmul_rn(qz, sz[j]));
      float d = __fsub_rn(__fadd_rn(qsq, ssq[j]), __fmul_rn(2.0f, cross));
      d = fmaxf(d, 0.0f);
      if (d < bd[K - 1]) {
        // insert into the sorted list, dropping the last entry; equal
        // distances stay behind the earlier (lower-index) key
#pragma unroll
        for (int p = K - 1; p > 0; --p) {
          if (bd[p - 1] > d) {
            bd[p] = bd[p - 1];
            bi[p] = bi[p - 1];
          } else if (bd[p] > d) {
            bd[p] = d;
            bi[p] = t0 + j;
          }
        }
        if (bd[0] > d) {
          bd[0] = d;
          bi[0] = t0 + j;
        }
      }
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

template <int K>
cudaError_t launch(const float* xyz, const uint8_t* mask, int B, int L,
                   int exclude_self, int32_t* idx, uint8_t* em,
                   cudaStream_t stream) {
  const int threads = L >= 128 ? 128 : ((L + 31) / 32) * 32;
  dim3 grid((L + threads - 1) / threads, B);
  knn_kernel<K><<<grid, threads, 0, stream>>>(xyz, mask, L, exclude_self,
                                               idx, em);
  return cudaGetLastError();
}

}  // namespace

extern "C" int knn_graph_launch(const void* xyz, const void* mask, int B,
                                int L, int k, int exclude_self, void* idx,
                                void* em, void* stream) {
  const float* x = static_cast<const float*>(xyz);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int32_t* i = static_cast<int32_t*>(idx);
  uint8_t* e = static_cast<uint8_t*>(em);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || L == 0) return 0;
  switch (k) {
#define KNN_CASE(K) \
  case K:           \
    return (int)launch<K>(x, m, B, L, exclude_self, i, e, s);
    KNN_CASE(1) KNN_CASE(2) KNN_CASE(3) KNN_CASE(4)
    KNN_CASE(5) KNN_CASE(6) KNN_CASE(7) KNN_CASE(8)
    KNN_CASE(9) KNN_CASE(10) KNN_CASE(11) KNN_CASE(12)
    KNN_CASE(13) KNN_CASE(14) KNN_CASE(15) KNN_CASE(16)
#undef KNN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
