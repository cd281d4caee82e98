// Fused EdgeConv forward + the next layer's kNN, for Hopper:
//
//   out  = the fused EdgeConv forward (edgeconv.cu), fp32, [B, L, H2]
//   nidx, nem = the knn_k nearest valid nodes of each node over
//               out[..., lo:lo+D], D = 3 or 4
//
// Replaces the TPU kernel
// graphnet_tpu/ops/edgeconv_pallas.py:_fwd_knn_kernel (entry
// fused_edgeconv_knn).  Its kNN contract: coordinates centred over the
// event's valid nodes, squared distances |q|^2 + |k|^2 - 2 q.k clamped at
// 0, invalid keys and the query itself never chosen, ties to the lower
// index, nem = (a real key was chosen) & the query is valid.  The centre
// is the sum over the valid nodes in index order in float64, divided by
// their count (at least 1) and rounded once to float32, so the plain
// PyTorch version, which sums in the same order, gets the same centre,
// the same distances (knn.cuh's non-fused arithmetic) and the same
// neighbours, bit for bit.  It needs L <= 128 (whole events), as the TPU
// kernel does.
//
// What bounds it on the H100: operations, as edgeconv.cu.  At DynEdge's
// layers 1-3 (H1=336, H2=256, B=128, L=128, k=8) the conv's second
// linear is ~17 GFLOP over the valid edges; the kNN adds ~10 flops a
// valid pair, 21 MFLOP.
//
// The design: the kNN needs every row of an event, but edgeconv.cu's grid
// gives a block 64 edge rows (8 nodes at k=8), so an event at L=128
// spans 16 blocks.  The grid and the conv block are edgeconv.cu's
// (ec::fwd_block in edgeconv.cuh: the message build, the W2 tiles through
// a cp.async ring, pre2 on mma.sync in bf16 or on 8 x 8 fp32 register
// tiles, the reduction over k through the ring's place), so `out` is the
// same bits as that kernel's, with its shared memory (112 KB bf16, two
// blocks an SM; 155 KB fp32 at H1=336).  Each block writes its rows of
// `out`, fences them, and counts itself in the event's arrival counter
// with an atomic; a block of padding nodes, which writes its zeros and
// leaves the conv early, counts itself too, and may be the last.  The
// block that arrives last reads the event's D coordinate columns back
// from L2 (__ldcg, past the non-coherent L1), computes the centre and
// runs knn.cu's selection, one thread per query with a sorted top-16 in
// registers (the first knn_k of the top 16 are the top knn_k), and
// resets the counter to 0 for the next launch.  The kNN of an event thus
// runs on one block while the other events' conv blocks keep the card
// busy; the event's coordinates never leave the chip between the conv
// and the kNN but for the L2 round trip.  The counters ([B] unsigned
// ints, zero) are allocated once per device by the wrapper; launches on
// one stream run one after another, so each finds them zero.  The kNN
// tail is serial per event (one block).

#include "edgeconv.cuh"
#include "knn.cuh"

namespace {

constexpr int kMaxK = 16;  // the sorted list's length; knn_k <= kMaxK

// After the block's conv: make its stores of `out` visible device-wide,
// count it in, and tell whether it is the last block of event `ev`.
__device__ __forceinline__ bool last_of_event(unsigned int* counter, int ev) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int before = atomicAdd(&counter[ev], 1u);
    s_last = before == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  return s_last;
}

// The kNN of event `ev` over out[ev, :, lo:lo+D], run by one block;
// `sm` is shared memory of at least L * (4 * D + 5) bytes.
template <int D>
__device__ void event_knn(const float* __restrict__ out,
                          const uint8_t* __restrict__ nmask, int ev, int L,
                          int H2, int lo, int knn_k,
                          int32_t* __restrict__ nidx,
                          uint8_t* __restrict__ nem, float* sm) {
  __shared__ float s_centre[D];
  float* sc = sm;            // [L][D] coordinates, then centred
  float* ssq = sc + L * D;   // [L] |c|^2
  uint8_t* sval = reinterpret_cast<uint8_t*>(ssq + L);  // [L] validity
  const float* o = out + (size_t)ev * L * H2 + lo;
  for (int t = threadIdx.x; t < L * D; t += blockDim.x) {
    sc[t] = __ldcg(o + (size_t)(t / D) * H2 + t % D);
  }
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    sval[j] = nmask[(size_t)ev * L + j];
  }
  __syncthreads();
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    double s = 0.0;
    int n = 0;
    for (int j = 0; j < L; ++j) {
      if (sval[j]) {
        s += (double)sc[j * D + d];
        ++n;
      }
    }
    s_centre[d] = (float)(s / (double)max(n, 1));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    float c[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      c[d] = __fsub_rn(sc[j * D + d], s_centre[d]);
      sc[j * D + d] = c[d];
    }
    ssq[j] = dot_rn<D>(c, c);
  }
  __syncthreads();
  for (int q = threadIdx.x; q < L; q += blockDim.x) {
    float qc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qc[d] = sc[q * D + d];
    const float qsq = ssq[q];
    float bd[kMaxK];
    int bi[kMaxK];
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
      bd[i] = kBig;
      bi[i] = 0;
    }
    for (int j = 0; j < L; ++j) {
      if (!sval[j] || j == q) continue;
      topk_insert<kMaxK>(bd, bi, sq_dist(qsq, ssq[j], dot_rn<D>(qc, &sc[j * D])),
                         j);
    }
    const bool qvalid = sval[q] != 0;
    const size_t base = ((size_t)ev * L + q) * knn_k;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
      if (i < knn_k) {
        nidx[base + i] = bi[i];
        nem[base + i] = (qvalid && bd[i] < kBig * 0.5f) ? 1 : 0;
      }
    }
  }
}

// The last block of the event runs its kNN and resets its counter.
__device__ __forceinline__ void knn_tail(const float* __restrict__ out,
                                         const uint8_t* __restrict__ nmask,
                                         int L, int H2, int lo, int D,
                                         int knn_k, int32_t* __restrict__ nidx,
                                         uint8_t* __restrict__ nem,
                                         unsigned int* counter, float* sm) {
  const int ev = blockIdx.y;
  if (!last_of_event(counter, ev)) return;
  if (D == 3) {
    event_knn<3>(out, nmask, ev, L, H2, lo, knn_k, nidx, nem, sm);
  } else {
    event_knn<4>(out, nmask, ev, L, H2, lo, knn_k, nidx, nem, sm);
  }
  if (threadIdx.x == 0) counter[ev] = 0;
}

template <typename T>
__global__ void __launch_bounds__(ec::kThreads, sizeof(T) == 2 ? 2 : 1)
    edgeconv_knn(const T* __restrict__ a, const T* __restrict__ b,
                 const int32_t* __restrict__ idx,
                 const uint8_t* __restrict__ em,
                 const uint8_t* __restrict__ nmask, const T* __restrict__ w2,
                 const T* __restrict__ b2, float* __restrict__ out,
                 int32_t* __restrict__ nidx, uint8_t* __restrict__ nem,
                 unsigned int* counter, int L, int H1, int H2, int k, int tl,
                 float slope, int aggr_max, int knn_k, int lo, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  ec::fwd_block<T>(a, b, idx, em, w2, b2, out, L, H1, H2, k, tl, slope,
                   aggr_max, smem);
  knn_tail(out, nmask, L, H2, lo, D, knn_k, nidx, nem, counter,
           reinterpret_cast<float*>(smem));
}

long long knn_smem_bytes(int L, int D) { return (long long)L * (4 * D + 5); }

}  // namespace

// Shared memory the kernel needs, in bytes (the wrapper checks it
// against the card's limit before launching).
extern "C" long long edgeconv_knn_smem_bytes(int H1, int L, int D, int bf16) {
  const long long conv = ec::smem_bytes(H1, bf16);
  const long long knn = knn_smem_bytes(L, D);
  return conv > knn ? conv : knn;
}

// Blocks of the kernel an SM holds at H1, L and D (-1 on an error).
extern "C" int edgeconv_knn_blocks_per_sm(int H1, int L, int D, int bf16) {
  const size_t smem = (size_t)edgeconv_knn_smem_bytes(H1, L, D, bf16);
  return bf16 ? ec::blocks_per_sm((const void*)edgeconv_knn<ec::bf16_t>, smem)
              : ec::blocks_per_sm((const void*)edgeconv_knn<float>, smem);
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* idx,
                   const void* em, const void* nmask, const void* w2,
                   const void* b2, void* out, void* nidx, void* nem,
                   void* counter, int B, int L, int H1, int H2, int k,
                   int knn_k, int lo, int D, float slope, int aggr_max,
                   size_t smem, cudaStream_t s) {
  static size_t configured = 0;
  const int tl = ec::kRows / k;
  const dim3 grid((L + tl - 1) / tl, B);
  cudaError_t err = ec::allow_smem((const void*)edgeconv_knn<T>, smem,
                                   &configured);
  if (err != cudaSuccess) return err;
  edgeconv_knn<T><<<grid, ec::kThreads, smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(em),
      static_cast<const uint8_t*>(nmask), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<float*>(out),
      static_cast<int32_t*>(nidx), static_cast<uint8_t*>(nem),
      static_cast<unsigned int*>(counter), L, H1, H2, k, tl, slope, aggr_max,
      knn_k, lo, D);
  return cudaGetLastError();
}

// H1 and H2 multiples of 8; a, b, w2 16-byte aligned (the wrapper pads
// and copies).
extern "C" int edgeconv_knn_launch(const void* a, const void* b,
                                   const void* idx, const void* em,
                                   const void* nmask, const void* w2,
                                   const void* b2, void* out, void* nidx,
                                   void* nem, void* counter, int B, int L,
                                   int H1, int H2, int k, int knn_k, int lo,
                                   int D, float slope, int aggr_max, int bf16,
                                   void* stream) {
  if (B == 0 || L == 0) return 0;
  if (k < 1 || k > ec::kRows || knn_k < 1 || knn_k > kMaxK ||
      (D != 3 && D != 4) || lo < 0 || lo + D > H2 || H1 % 8 || H2 % 8) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)edgeconv_knn_smem_bytes(H1, L, D, bf16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch<ec::bf16_t>(a, b, idx, em, nmask, w2, b2, out,
                                         nidx, nem, counter, B, L, H1, H2, k,
                                         knn_k, lo, D, slope, aggr_max, smem, s)
                    : launch<float>(a, b, idx, em, nmask, w2, b2, out, nidx,
                                    nem, counter, B, L, H1, H2, k, knn_k, lo,
                                    D, slope, aggr_max, smem, s));
}
