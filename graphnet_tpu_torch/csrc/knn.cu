// Batched k-nearest-neighbour graph on dense-padded events, for Hopper.
//
// Replaces the TPU kernel graphnet_tpu/ops/knn_pallas.py:_knn_kernel.
// Same contract: squared distances |q|^2 + |k|^2 - 2 q.k on coordinates
// centred per event, clamped at 0; invalid keys and, with exclude_self,
// the query itself are never chosen; k nearest in ascending distance
// with ties to the lower key index; edge_mask = "a real key was chosen"
// and the query is valid.  D is 3 (DynEdge's xyz) or 4 (TITO's xyzt) and
// k is 1-32 (RadialEdges' default cap is 32), both template parameters,
// for events of at most 8192 nodes; every other k (up to L) and L take
// the rounds path at the end of this note.
//
// What bounds it on the H100: neither bytes nor FLOPs.  At the serving
// shape (B=128, L=128, k=8, D=3) it reads 0.2 MB, writes 0.65 MB and
// does ~20 M flops, a bound of ~0.3 us, below a launch's own latency.  So
// the design is about the call: one launch and nothing else on the
// device, and a grid that fills the card even for one event.
//
// One launch.  The kernel reads the raw coordinates where they lie: a
// [B, L, D] float32 view whose last dimension has stride 1 (the xyz
// columns of a wider feature tensor, say), given its batch and row
// strides, and the [B, L] mask with its batch stride.  It centres them
// itself, so the wrapper runs no centring ops and copies nothing.
//
// The centring rule (row 4's, csrc/edgeconv_knn.cu, and the plain
// version's, ops/knn.py:event_centre): the centre is the
// float64 sum of the valid nodes' coordinates in index order, divided by
// their count (at least 1) and rounded once to float32; each coordinate
// is centred by one float32 subtraction.  The fused and the unfused
// DynEdge routes therefore pick the same neighbours from the same
// latents.  The serial sum is ~L dependent float64 adds (several us at
// L=1024), so a block sums in parallel wherever that gives the same
// bits, and serially only where it might not:
//   A finite float32 x != 0 with biased exponent e is a multiple of
//   2^(max(e,1) - 150) and |x| < 2^(max(e,1) - 126).  Let lo and hi be
//   the least and greatest max(e,1) over one coordinate's valid non-zero
//   values and n the count of valid nodes.  Every sum of a subset of
//   them is then a multiple of 2^(lo - 150) below n * 2^(hi - 126) in
//   magnitude: an integer multiple m of 2^(lo - 150) with
//   |m| < 2^(ceil(log2 n) + hi - lo + 24).  If ceil(log2 n) + hi - lo +
//   24 <= 53, every such sum is a float64, so every float64 addition of
//   any order is exact and all orders give the exact sum, the serial one
//   included.  (+0.0 is added last: the serial sum, which starts at
//   +0.0, never yields -0.0.)  Otherwise, or with an inf or NaN (e =
//   255), D threads add the coordinates in index order.  Detector
//   coordinates and latents pass the test; the chip check holds both
//   paths against the plain version.
//
// Filling the card.  A block of up to 256 threads holds its whole event
// in shared memory (at most 8192 nodes: 16 bytes a node for D=3, 20 for
// D=4, above 48 KB through the opt-in) and serves 256/S of its queries;
// the grid is (event, query tile).  Whole events, not tiles of keys: the
// centre needs every node before any distance, and one pass over the
// event then stages it once.  Each query's keys are split across S lanes
// of a warp, strided (lane s takes keys s, s+S, ...); S, a power of two
// up to 32, is chosen from B*L so that B*L*S lanes come to 64 x 1024
// (B=128, L=128: 4; B=8, L=1024: 8; one event of 512 nodes: 32) while
// each lane keeps at least max(8, k) keys (a lane's list is k long, so a
// lane with fewer keys would hold mostly padding, and every merge round
// costs k registers of each list).  S is a run-time argument: it sets
// only loop bounds and the merge's rounds, and as a template parameter
// it would multiply the 64 instantiations by six.
//
// Each lane keeps its own sorted top-k in registers (knn.cuh's
// topk_insert, keys in ascending index order, so ties stay with the
// lower index), then the S lists are merged by warp shuffles in log2(S)
// butterfly rounds: two sorted lists, padded to a power of two P >= k,
// are merged by the elementwise minimum of one and the other reversed (a
// bitonic sequence holding the P smallest) and a bitonic half-cleaner
// network, all on registers.  The partner's entries are shuffled in as
// the minimum reads them, so a merge holds two lists of P pairs, not
// three (at k = 32, 128 registers instead of 192).  Strided keys interleave the lanes'
// indices, so the merge compares (distance, index) pairs; both partners
// end with the same list.  A key is one 16-byte shared-memory read for
// D=3, (cx, cy, cz, |c|^2), and a 16-byte plus a 4-byte read for D=4; an
// invalid key has coordinates 0 and |c|^2 = +inf, so its distance is
// +inf and it is never inserted.  Keys past the event's last valid node
// are not scanned, and a lane of an invalid query scans nothing.
// Distances use the non-fused __fmul_rn/__fadd_rn intrinsics of knn.cuh
// in the plain version's order, so both give bit-identical distances and
// the same neighbours.
//
// The rounds path: k > 32 or L > 8192.  Past those limits a lane's list
// no longer fits in registers, or the event no longer fits in shared
// memory, so a second kernel (knn_kernel_rounds) takes every other shape
// with the same arithmetic.  Each block first sums its event's centre by
// the rule above, reading the event from memory (the serial fallback
// reads it in index order from memory too).  Then k rounds: round r picks
// the least (distance, index) pair above round r - 1's pick, so the k
// picks come out in top_k's order with ties to the lower index, as the
// JAX package's streaming select does (k rounds of min, argmin, mask).
// In each round the keys stream through shared memory in tiles of
// kRoundTile, centred (__fsub_rn) and squared (dot_rn) as they arrive,
// the block's queries each split over S lanes as above; the S lanes'
// candidates are reduced by warp shuffles.  Nothing of size L^2 or L*k
// waits in shared memory, so L is bounded only by the grid.  The work is
// k times the distances of one pass; the first path stays the one for
// k <= 32, L <= 8192, so their launches and bits do not change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "knn.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 8192;
constexpr int kTargetLanes = 64 * 1024;
constexpr int kMinKeysPerLane = 8;  // raised to k above 8

__host__ __device__ constexpr int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p *= 2;
  return p;
}

// (d1, i1) before (d2, i2): by distance, then by key index
__device__ __forceinline__ bool before(float d1, int i1, float d2, int i2) {
  return d1 < d2 || (d1 == d2 && i1 < i2);
}

// Merge the sorted list (bd, bi) with lane (lane ^ o)'s into the K first
// (distance, index) pairs of both, on both lanes.
template <int K>
__device__ __forceinline__ void merge_lists(float (&bd)[K], int (&bi)[K],
                                            int o) {
  constexpr int P = pow2_at_least(K);
  float md[P];
  int mi[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int r = P - 1 - i;  // a compile-time index once unrolled
    const float ad = i < K ? bd[i] : __int_as_float(0x7f800000);
    const int ai = i < K ? bi[i] : 0x7fffffff;
    const float cd = r < K ? __shfl_xor_sync(0xffffffffu, bd[r], o)
                           : __int_as_float(0x7f800000);
    const int ci = r < K ? __shfl_xor_sync(0xffffffffu, bi[r], o) : 0x7fffffff;
    const bool a = before(ad, ai, cd, ci);
    md[i] = a ? ad : cd;
    mi[i] = a ? ai : ci;
  }
#pragma unroll
  for (int w = P / 2; w > 0; w /= 2) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if ((i & w) == 0 && before(md[i + w], mi[i + w], md[i], mi[i])) {
        const float td = md[i];
        const int ti = mi[i];
        md[i] = md[i + w];
        mi[i] = mi[i + w];
        md[i + w] = td;
        mi[i + w] = ti;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    bd[i] = md[i];
    bi[i] = mi[i];
  }
}

// max(biased exponent, 1) of a non-zero float
__device__ __forceinline__ int exponent_of(float x) {
  return max((int)((__float_as_uint(x) >> 23) & 0xffu), 1);
}

template <int K, int D>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ coords, long long sb, long long sl,
           const uint8_t* __restrict__ mask, long long mb, int L, int tiles,
           int S, int exclude_self, int32_t* __restrict__ idx_out,
           uint8_t* __restrict__ em_out) {
  extern __shared__ float4 key[];  // [L] (cx, cy, cz, |c|^2 | ct)
  float* ksq = reinterpret_cast<float*>(key + L);  // [L] |c|^2, D=4 only
  __shared__ double s_sum[kWarps][D];
  __shared__ int s_n[kWarps], s_last[kWarps], s_lo[kWarps][D],
      s_hi[kWarps][D];
  __shared__ float s_centre[D];

  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const float* ev = coords + b * sb;
  const uint8_t* m = mask + b * mb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  // 1. the raw event into shared memory (validity in the |c|^2 slot),
  // each thread's float64 sums, count, exponent range and last valid node
  double sum[D];
  int lo[D], hi[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    sum[d] = 0.0;
    lo[d] = 255;
    hi[d] = 0;
  }
  int n = 0, last = -1;
  for (int j = tid; j < L; j += blockDim.x) {
    const bool v = m[j] != 0;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int d = 0; d < D; ++d) c[d] = __ldg(ev + j * sl + d);
    if (v) {
      ++n;
      last = j;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        sum[d] += (double)c[d];
        if (c[d] != 0.f) {
          const int e = exponent_of(c[d]);
          lo[d] = min(lo[d], e);
          hi[d] = max(hi[d], e);
        }
      }
    }
    const float flag = v ? 1.f : 0.f;
    if constexpr (D == 3) {
      key[j] = make_float4(c[0], c[1], c[2], flag);
    } else {
      key[j] = make_float4(c[0], c[1], c[2], c[3]);
      ksq[j] = flag;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      sum[d] += __shfl_xor_sync(0xffffffffu, sum[d], o);
      lo[d] = min(lo[d], __shfl_xor_sync(0xffffffffu, lo[d], o));
      hi[d] = max(hi[d], __shfl_xor_sync(0xffffffffu, hi[d], o));
    }
    n += __shfl_xor_sync(0xffffffffu, n, o);
    last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  }
  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      s_sum[warp][d] = sum[d];
      s_lo[warp][d] = lo[d];
      s_hi[warp][d] = hi[d];
    }
    s_n[warp] = n;
    s_last[warp] = last;
  }
  __syncthreads();

  // 2. the centre (the note's rule), then the event centred in place
  n = 0;
  last = -1;
  for (int w = 0; w < nwarps; ++w) {
    n += s_n[w];
    last = max(last, s_last[w]);
  }
  const int nk = last + 1;  // keys past the last valid node are not scanned
  if (tid < D) {
    const int d = tid;
    double s = 0.0;
    int l = 255, h = 0;
    for (int w = 0; w < nwarps; ++w) {
      s += s_sum[w][d];
      l = min(l, s_lo[w][d]);
      h = max(h, s_hi[w][d]);
    }
    const int clog = n > 1 ? 32 - __clz(n - 1) : 0;
    if (h < 255 && h - l + 24 + clog <= 53) {
      s += 0.0;
    } else {
      s = 0.0;
      const float* raw = reinterpret_cast<const float*>(key);
      for (int j = 0; j < nk; ++j) {
        const float flag = D == 3 ? raw[4 * j + 3] : ksq[j];
        if (flag != 0.f) s += (double)raw[4 * j + d];
      }
    }
    s_centre[d] = (float)(s / (double)max(n, 1));
  }
  __syncthreads();
  for (int j = tid; j < nk; j += blockDim.x) {
    const float4 r = key[j];
    const float raw[4] = {r.x, r.y, r.z, r.w};
    const bool v = (D == 3 ? r.w : ksq[j]) != 0.f;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int d = 0; d < D; ++d) c[d] = v ? __fsub_rn(raw[d], s_centre[d]) : 0.f;
    const float sq = v ? dot_rn<D>(c, c) : __int_as_float(0x7f800000);
    if constexpr (D == 3) {
      key[j] = make_float4(c[0], c[1], c[2], sq);
    } else {
      key[j] = make_float4(c[0], c[1], c[2], c[3]);
      ksq[j] = sq;
    }
  }
  __syncthreads();

  // 3. each lane's top K over its share of the keys
  const int slot = tid / S, s = tid - slot * S;
  const int q = tile * (blockDim.x / S) + slot;
  const bool qvalid = q < L && m[q] != 0;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    bd[i] = kBig;
    bi[i] = 0;
  }
  if (qvalid) {
    const float4 qv = key[q];
    const float qc[4] = {qv.x, qv.y, qv.z, qv.w};
    const float qsq = D == 3 ? qv.w : ksq[q];
    const int self = exclude_self ? q : -1;
    for (int j = s; j < nk; j += S) {
      const float4 kv = key[j];
      const float kc[4] = {kv.x, kv.y, kv.z, kv.w};
      const float d = sq_dist(qsq, D == 3 ? kv.w : ksq[j], dot_rn<D>(qc, kc));
      if (j != self) topk_insert<K>(bd, bi, d, j);
    }
  }

  // 4. the S lists merged, and written by the S lanes in turn
  for (int o = 1; o < S; o <<= 1) merge_lists<K>(bd, bi, o);
  if (q < L) {
    const size_t base = ((size_t)b * L + q) * K;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if ((i & (S - 1)) == s) {
        idx_out[base + i] = bi[i];
        em_out[base + i] = (qvalid && bd[i] < kBig * 0.5f) ? 1 : 0;
      }
    }
  }
}

// Lanes a query: the smallest power of two S <= 32 with B*L*S >=
// kTargetLanes, at most L / max(kMinKeysPerLane, k) (and at least 1).
int lanes_per_query(int B, int L, int k) {
  int s = 1;
  const long long queries = (long long)B * L;
  const int keys = k > kMinKeysPerLane ? k : kMinKeysPerLane;
  while (s < 32 && queries * s < kTargetLanes && 2 * s * keys <= L) {
    s *= 2;
  }
  return s;
}

template <int K, int D>
cudaError_t launch(const float* coords, long long sb, long long sl,
                   const uint8_t* mask, long long mb, int B, int L,
                   int exclude_self, int32_t* idx, uint8_t* em,
                   cudaStream_t stream) {
  const int S = lanes_per_query(B, L, K);
  const long long lanes = ((long long)L * S + 31) / 32 * 32;
  const int threads = lanes < kThreads ? (int)lanes : kThreads;
  const int tiles = (L + threads / S - 1) / (threads / S);
  const size_t bytes = (size_t)L * (D == 3 ? 16 : 20);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_kernel<K, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  knn_kernel<K, D><<<(unsigned)B * tiles, threads, bytes, stream>>>(
      coords, sb, sl, mask, mb, L, tiles, S, exclude_self, idx, em);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_k(const float* x, long long sb, long long sl,
                     const uint8_t* m, long long mb, int B, int L, int k,
                     int exclude_self, int32_t* i, uint8_t* e,
                     cudaStream_t s) {
  switch (k) {
#define KNN_CASE(K) \
  case K:           \
    return launch<K, D>(x, sb, sl, m, mb, B, L, exclude_self, i, e, s);
    KNN_CASE(1) KNN_CASE(2) KNN_CASE(3) KNN_CASE(4)
    KNN_CASE(5) KNN_CASE(6) KNN_CASE(7) KNN_CASE(8)
    KNN_CASE(9) KNN_CASE(10) KNN_CASE(11) KNN_CASE(12)
    KNN_CASE(13) KNN_CASE(14) KNN_CASE(15) KNN_CASE(16)
    KNN_CASE(17) KNN_CASE(18) KNN_CASE(19) KNN_CASE(20)
    KNN_CASE(21) KNN_CASE(22) KNN_CASE(23) KNN_CASE(24)
    KNN_CASE(25) KNN_CASE(26) KNN_CASE(27) KNN_CASE(28)
    KNN_CASE(29) KNN_CASE(30) KNN_CASE(31) KNN_CASE(32)
#undef KNN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

constexpr int kRoundTile = 2048;  // keys a tile of the rounds kernel

// Lanes a query in the rounds kernel: the smallest power of two S <= 32
// with B*L*S >= kTargetLanes, while each lane keeps at least
// kMinKeysPerLane keys of the event (and at least 1 lane).
int round_lanes(int B, int L) {
  int s = 1;
  const long long queries = (long long)B * L;
  while (s < 32 && queries * s < kTargetLanes &&
         2 * s * kMinKeysPerLane <= L) {
    s *= 2;
  }
  return s;
}

// One block: the queries tile * (blockDim.x / S) .. + blockDim.x / S - 1
// of event blockIdx.x / tiles, k rounds each.  Dynamic shared memory:
// kRoundTile float4 keys (cx, cy, cz, |c|^2 | ct) and, for D=4,
// kRoundTile floats |c|^2.
template <int D>
__global__ void __launch_bounds__(kThreads)
knn_kernel_rounds(const float* __restrict__ coords, long long sb,
                  long long sl, const uint8_t* __restrict__ mask,
                  long long mb, int L, int k, int tiles, int S,
                  int exclude_self, int32_t* __restrict__ idx_out,
                  uint8_t* __restrict__ em_out) {
  extern __shared__ float4 key[];  // [kRoundTile]
  float* ksq = reinterpret_cast<float*>(key + kRoundTile);  // D=4 only
  __shared__ double s_sum[kWarps][D];
  __shared__ int s_n[kWarps], s_last[kWarps], s_lo[kWarps][D],
      s_hi[kWarps][D];
  __shared__ float s_centre[D];
  __shared__ int s_nk;

  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const float* ev = coords + b * sb;
  const uint8_t* m = mask + b * mb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  // 1. the centre: each thread's float64 sums, count, exponent range and
  // last valid node over its strided share of the event, in memory
  double sum[D];
  int lo[D], hi[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    sum[d] = 0.0;
    lo[d] = 255;
    hi[d] = 0;
  }
  int n = 0, last = -1;
  for (int j = tid; j < L; j += blockDim.x) {
    if (m[j] == 0) continue;
    ++n;
    last = j;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float c = __ldg(ev + j * sl + d);
      sum[d] += (double)c;
      if (c != 0.f) {
        const int e = exponent_of(c);
        lo[d] = min(lo[d], e);
        hi[d] = max(hi[d], e);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      sum[d] += __shfl_xor_sync(0xffffffffu, sum[d], o);
      lo[d] = min(lo[d], __shfl_xor_sync(0xffffffffu, lo[d], o));
      hi[d] = max(hi[d], __shfl_xor_sync(0xffffffffu, hi[d], o));
    }
    n += __shfl_xor_sync(0xffffffffu, n, o);
    last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  }
  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      s_sum[warp][d] = sum[d];
      s_lo[warp][d] = lo[d];
      s_hi[warp][d] = hi[d];
    }
    s_n[warp] = n;
    s_last[warp] = last;
  }
  __syncthreads();
  n = 0;
  last = -1;
  for (int w = 0; w < nwarps; ++w) {
    n += s_n[w];
    last = max(last, s_last[w]);
  }
  if (tid < D) {
    const int d = tid;
    double s = 0.0;
    int l = 255, h = 0;
    for (int w = 0; w < nwarps; ++w) {
      s += s_sum[w][d];
      l = min(l, s_lo[w][d]);
      h = max(h, s_hi[w][d]);
    }
    const int clog = n > 1 ? 32 - __clz(n - 1) : 0;
    if (h < 255 && h - l + 24 + clog <= 53) {
      s += 0.0;
    } else {  // the serial sum, in index order
      s = 0.0;
      for (int j = 0; j <= last; ++j) {
        if (m[j] != 0) s += (double)__ldg(ev + j * sl + d);
      }
    }
    s_centre[d] = (float)(s / (double)max(n, 1));
  }
  if (tid == 0) s_nk = last + 1;  // keys past the last valid node: none
  __syncthreads();
  const int nk = s_nk;
  float centre[D];
#pragma unroll
  for (int d = 0; d < D; ++d) centre[d] = s_centre[d];

  // 2. this thread's query, centred as its keys will be
  const int slot = tid / S, s = tid - slot * S;
  const int q = tile * (blockDim.x / S) + slot;
  const bool qvalid = q < L && m[q] != 0;
  float qc[4] = {0.f, 0.f, 0.f, 0.f};
  float qsq = 0.f;
  if (qvalid) {
#pragma unroll
    for (int d = 0; d < D; ++d) qc[d] = __fsub_rn(__ldg(ev + q * sl + d), centre[d]);
    qsq = dot_rn<D>(qc, qc);
  }
  const int self = exclude_self ? q : -1;

  // 3. k rounds, each the least (d, j) above the previous round's pick
  float pd = -__int_as_float(0x7f800000);
  int pj = -1;
  const size_t base = ((size_t)b * L + q) * k;
  for (int r = 0; r < k; ++r) {
    float bd = kBig;
    int bj = 0x7fffffff;
    for (int t0 = 0; t0 < nk; t0 += kRoundTile) {
      const int tn = min(kRoundTile, nk - t0);
      __syncthreads();  // the previous tile is read by all
      for (int i = tid; i < tn; i += blockDim.x) {
        const int j = t0 + i;
        const bool v = m[j] != 0;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int d = 0; d < D; ++d) {
          c[d] = v ? __fsub_rn(__ldg(ev + j * sl + d), centre[d]) : 0.f;
        }
        const float sq = v ? dot_rn<D>(c, c) : __int_as_float(0x7f800000);
        if constexpr (D == 3) {
          key[i] = make_float4(c[0], c[1], c[2], sq);
        } else {
          key[i] = make_float4(c[0], c[1], c[2], c[3]);
          ksq[i] = sq;
        }
      }
      __syncthreads();
      if (qvalid) {
        for (int i = s; i < tn; i += S) {
          const int j = t0 + i;
          const float4 kv = key[i];
          const float kc[4] = {kv.x, kv.y, kv.z, kv.w};
          const float d = sq_dist(qsq, D == 3 ? kv.w : ksq[i],
                                  dot_rn<D>(qc, kc));
          if (j != self && d < kBig && before(pd, pj, d, j) &&
              before(d, j, bd, bj)) {
            bd = d;
            bj = j;
          }
        }
      }
    }
    // the S lanes' least pair, on every lane of the query
    for (int o = 1; o < S; o <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, o);
      const int oj = __shfl_xor_sync(0xffffffffu, bj, o);
      if (before(od, oj, bd, bj)) {
        bd = od;
        bj = oj;
      }
    }
    const bool found = bd < kBig;
    if (q < L && s == 0) {
      idx_out[base + r] = found ? bj : 0;
      em_out[base + r] = (qvalid && found && bd < kBig * 0.5f) ? 1 : 0;
    }
    pd = bd;
    pj = bj;
  }
}

template <int D>
cudaError_t launch_rounds(const float* coords, long long sb, long long sl,
                          const uint8_t* mask, long long mb, int B, int L,
                          int k, int exclude_self, int32_t* idx, uint8_t* em,
                          cudaStream_t stream) {
  const int S = round_lanes(B, L);
  const int per = kThreads / S;
  const long long tiles = (L + per - 1) / per;
  if ((long long)B * tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t bytes = (size_t)kRoundTile * (D == 3 ? 16 : 20);
  knn_kernel_rounds<D><<<(unsigned)(B * tiles), kThreads, bytes, stream>>>(
      coords, sb, sl, mask, mb, L, k, (int)tiles, S, exclude_self, idx, em);
  return cudaGetLastError();
}

}  // namespace

// Whether a call of (L, k) takes the rounds kernel (k > 32 or L > 8192).
extern "C" int knn_uses_rounds(int L, int k) {
  return k > 32 || L > kMaxL ? 1 : 0;
}

// One kNN graph launch on `stream` of CUDA device `device` (made current
// for the launch if it is not): knn_kernel for k <= 32 and L <= 8192,
// knn_kernel_rounds otherwise.  coords: float32 [B, L, D] with element
// strides (sb, sl, 1); mask: bool [B, L] with strides (mb, 1); idx int32
// and em bool [B, L, k], contiguous.  Returns the CUDA error code.
extern "C" int knn_graph_launch(const void* coords, long long sb,
                                long long sl, const void* mask, long long mb,
                                int B, int L, int D, int k, int exclude_self,
                                void* idx, void* em, int device,
                                void* stream) {
  if (B == 0 || L == 0) return 0;
  if (k < 1 || k > L) return (int)cudaErrorInvalidValue;
  int current = device;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* x = static_cast<const float*>(coords);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int32_t* i = static_cast<int32_t*>(idx);
  uint8_t* e = static_cast<uint8_t*>(em);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rounds = knn_uses_rounds(L, k) != 0;
  if (D == 3) {
    err = rounds
              ? launch_rounds<3>(x, sb, sl, m, mb, B, L, k, exclude_self, i, e, s)
              : launch_k<3>(x, sb, sl, m, mb, B, L, k, exclude_self, i, e, s);
  } else if (D == 4) {
    err = rounds
              ? launch_rounds<4>(x, sb, sl, m, mb, B, L, k, exclude_self, i, e, s)
              : launch_k<4>(x, sb, sl, m, mb, B, L, k, exclude_self, i, e, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (current != device) cudaSetDevice(current);
  return (int)err;
}
