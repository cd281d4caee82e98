// Fused EdgeConv backward for Hopper.  For the forward
//
//   out[i] = aggr_{kk < k, em[i,kk]} act(act(a[i] + b[j]) @ W2 + b2),
//   j = idx[i,kk],
//
// and the fp32 output gradient g [B, L, H2], it returns da, db [B, L, H1],
// dW2 [H1, H2] and db2 [H2], all fp32.  Per valid edge (i, kk):
//
//   z     = a[i] + b[j];  msgs = act(z)          (rounded once to bf16 in
//                                                  the bf16 mode)
//   pre2  = msgs @ W2 + b2;  gate2 = pre2 > 0 ? 1 : slope
//   route = g[i]                  (add; mean is add, divided outside)
//         = g[i] on the first valid edge whose act(pre2) is the node's
//           max in that channel, 0 elsewhere                      (max)
//   gm    = route * gate2
//   dW2  += msgs^T gm;  db2 += sum gm
//   gz    = (gm @ W2^T) * (z > 0 ? 1 : slope)
//   da[i] = sum_kk gz (fp32);  db[j] += gz (bf16-rounded in bf16 mode)
//
// Masked edges contribute nothing.  In the bf16 mode msgs, gm and W2 are
// bf16 values in the products (exact in fp32) with fp32 sums, as the TPU
// kernel does.
//
// Replaces the TPU kernel graphnet_tpu/ops/edgeconv_pallas.py:_bwd_kernel
// (the custom VJP of fused_edgeconv).  On the TPU the grid ran in order,
// so the db, dW2 and db2 sums were free of races; here blocks run in
// parallel, and the design keeps every sum in a fixed order, so two runs
// give the same bits (no floating-point atomics).  Nine launches:
//
//   1. edge rows.  bwd_gm: 64 rows a block (64/k whole nodes of one
//      event), as the forward: messages in shared memory, pre2 by
//      CUDA-core FMAs (one thread per output column, 64 accumulators),
//      routing; writes the msgs and gm rows to scratch and the block's
//      partial of db2.  bwd_gz: gz = gm W2^T as a tiled product over all
//      edge rows (128x128 tiles, 8x8 outputs a thread; W2^T transposed
//      once so its reads coalesce), the z gate in the epilogue; fp32 gz
//      rows to scratch.  bwd_da sums each node's k rows.
//   2. dW2 = msgs^T gm, the same tiled product split over S slices of
//      the edge rows; the S partials and the db2 partials are summed in
//      a fixed order.
//   3. db: one block per event builds the reverse (CSR) index of incoming
//      edges, ordered by edge id; then one block per node sums the gz
//      rows of its incoming edges in that order (each rounded to bf16
//      first in the bf16 mode).
//
// What bounds it on the H100: operations.  It does three products of
// 2*E*H1*H2 flops (E valid edges): about 3x the forward's.  At DynEdge's
// layers 1-3 (H1=336, H2=256), B=128, L=128, k=8 with ~75 % of the edges
// valid that is ~51 GFLOP, a bound of ~0.76 ms on the fp32 CUDA cores.
// This is a simple version: CUDA-core FMAs in both precisions (no
// tensor cores, TMA or wgmma yet), and the scratch rows (msgs, gm, gz:
// ~0.5 GB at that shape) go through device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // edge rows per block of the edge kernel
constexpr int kThreads = 256;  // 8 warps
constexpr int kTile = 128;     // dW2 tile edge
constexpr int kStage = 16;     // edge rows per dW2 shared-memory stage

__device__ __forceinline__ float act(float x, float slope) {
  return slope == 0.0f ? fmaxf(x, 0.0f) : (x > 0.0f ? x : slope * x);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to the compute type T, as a float
template <typename T>
__device__ __forceinline__ float round_c(float x);
template <>
__device__ __forceinline__ float round_c<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_c<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Neighbour index and edge validity of the block's 64 rows; rows past
// the block's nodes, past L, or with an out-of-range index are invalid
// (the forward kernel's rule).
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

// Messages, pre2 and the routed, gated gradient gm of 64 edge rows;
// writes the msgs and gm rows and the block's partial of db2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_gm(const T* __restrict__ a, const T* __restrict__ b,
           const int32_t* __restrict__ idx, const uint8_t* __restrict__ em,
           const T* __restrict__ w2, const T* __restrict__ b2,
           const float* __restrict__ g, float* __restrict__ msgs_out,
           float* __restrict__ gm_out, float* __restrict__ db2_part, int L,
           int H1, int H2, int k, int tl, float slope, int aggr_max) {
  // msg [kRows][H1p] | s_idx [kRows] | s_em [kRows]
  extern __shared__ __align__(16) float smem[];
  const int H1p = (H1 + 3) & ~3;
  float* msg = smem;
  int* s_idx = reinterpret_cast<int*>(msg + kRows * H1p);
  uint8_t* s_em = reinterpret_cast<uint8_t*>(s_idx + kRows);

  const int ev = blockIdx.y;
  const int n0 = blockIdx.x * tl;
  const int rows = tl * k;
  const int live = min(rows, (L - n0) * k);  // rows of existing nodes
  const size_t e0 = ((size_t)ev * L + n0) * k;  // the block's first edge row
  load_edges(idx, em, ev, n0, L, k, rows, s_idx, s_em);
  __syncthreads();

  const T* aE = a + (size_t)ev * L * H1;
  const T* bE = b + (size_t)ev * L * H1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const bool ok = s_em[r] != 0;
    const T* ar = aE + (size_t)(n0 + r / k) * H1;
    const T* br = bE + (size_t)s_idx[r] * H1;
    for (int h = lane; h < H1p; h += 32) {
      float v = 0.0f;
      if (ok && h < H1) v = round_c<T>(act(to_f(ar[h]) + to_f(br[h]), slope));
      msg[r * H1p + h] = v;
      if (r < live && h < H1) msgs_out[(e0 + r) * H1 + h] = v;
    }
  }
  __syncthreads();

  const size_t bid = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  for (int c = threadIdx.x; c < H2; c += blockDim.x) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int h = 0; h < H1p; h += 4) {
      const float w0 = to_f(w2[(size_t)h * H2 + c]);
      const float w1 = h + 1 < H1 ? to_f(w2[(size_t)(h + 1) * H2 + c]) : 0.0f;
      const float wv2 = h + 2 < H1 ? to_f(w2[(size_t)(h + 2) * H2 + c]) : 0.0f;
      const float w3 = h + 3 < H1 ? to_f(w2[(size_t)(h + 3) * H2 + c]) : 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 m = *reinterpret_cast<const float4*>(&msg[r * H1p + h]);
        acc[r] = fmaf(m.x, w0, acc[r]);
        acc[r] = fmaf(m.y, w1, acc[r]);
        acc[r] = fmaf(m.z, wv2, acc[r]);
        acc[r] = fmaf(m.w, w3, acc[r]);
      }
    }
    const float bias = to_f(b2[c]);
    float* out = gm_out + e0 * H2 + c;
    float db2_acc = 0.0f;
    float best = 0.0f, best_gate = 0.0f;
    int first = -1, kk = 0, node = n0;
    float gn = node < L ? g[((size_t)ev * L + node) * H2 + c] : 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < live) {
        const float pre = acc[r] + bias;
        const float gate = pre > 0.0f ? 1.0f : slope;
        if (aggr_max) {
          out[(size_t)r * H2] = 0.0f;
          if (s_em[r]) {
            const float v = act(pre, slope);
            if (first < 0 || v > best) {  // strictly greater: first argmax
              best = v;
              best_gate = gate;
              first = r;
            }
          }
        } else {
          const float gv = s_em[r] ? gn * gate : 0.0f;
          out[(size_t)r * H2] = round_c<T>(gv);
          db2_acc += gv;
        }
        if (++kk == k) {
          if (aggr_max && first >= 0) {
            const float gv = gn * best_gate;
            out[(size_t)first * H2] = round_c<T>(gv);
            db2_acc += gv;
          }
          first = -1;
          kk = 0;
          ++node;
          gn = node < L ? g[((size_t)ev * L + node) * H2 + c] : 0.0f;
        }
      }
    }
    db2_part[bid * H2 + c] = db2_acc;
  }
}

// gz = (gm @ W2^T) * act'(z) over all edge rows, as a tiled product:
// one 128x128 tile (edge rows x H1 columns) a block, 8x8 outputs a
// thread, the gate applied in the epilogue; writes fp32 gz rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_gz(const float* __restrict__ gm, const T* __restrict__ w2t,
           const T* __restrict__ a, const T* __restrict__ b,
           const int32_t* __restrict__ idx, const uint8_t* __restrict__ em,
           float* __restrict__ gz, long long E, int L, int H1, int H2, int k,
           float slope) {
  // [c][edge row], rows padded: the transposing stores hit 2-way banks
  __shared__ __align__(16) float As[kStage][kTile + 4];
  __shared__ __align__(16) float Bs[kStage][kTile];  // [c][h]
  const long long m0 = (long long)blockIdx.x * kTile;
  const int h0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  constexpr int kPer = kStage * kTile / kThreads;
  float ra[kPer], rb[kPer];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int t = threadIdx.x + p * kThreads;
      const int m = t / kStage, q = t % kStage;  // 16 consecutive c a row
      const long long row = m0 + m;
      ra[p] = (row < E && c0 + q < H2) ? gm[row * H2 + c0 + q] : 0.0f;
      const int qb = t / kTile, col = t % kTile;
      rb[p] = (c0 + qb < H2 && h0 + col < H1)
                  ? to_f(w2t[(size_t)(c0 + qb) * H1 + h0 + col])
                  : 0.0f;
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  fetch(0);
  for (int c0 = 0; c0 < H2; c0 += kStage) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int t = threadIdx.x + p * kThreads;
      As[t % kStage][t / kStage] = ra[p];
      Bs[t / kTile][t % kTile] = rb[p];
    }
    __syncthreads();
    if (c0 + kStage < H2) fetch(c0 + kStage);
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[q][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[q][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[q][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[q][64 + tx * 4]);
      const float ai[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bj[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
    __syncthreads();
  }
  const long long per_event = (long long)L * k;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long e = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (e >= E) continue;
    const long long ev = e / per_event;
    const int node = (int)(e % per_event) / k;
    const int j = idx[e];
    const bool ok = em[e] && j >= 0 && j < L;
    const T* ar = a + ((size_t)ev * L + node) * H1;
    const T* br = b + ((size_t)ev * L + (ok ? j : 0)) * H1;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int h = h0 + (jj < 4 ? tx * 4 + jj : 64 + tx * 4 + jj - 4);
      if (h >= H1) continue;
      float v = 0.0f;
      if (ok) {
        const float z = to_f(ar[h]) + to_f(br[h]);
        v = acc[i][jj] * (z > 0.0f ? 1.0f : slope);
      }
      gz[e * H1 + h] = v;
    }
  }
}

// da[i] = sum over node i's k edge rows of the fp32 gz, in order.
__global__ void bwd_da(const float* __restrict__ gz, float* __restrict__ da,
                       long long n, int k, int H1) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const long long node = t / H1;
  const int h = (int)(t % H1);
  const float* row = gz + (size_t)node * k * H1 + h;
  float s = 0.0f;
  for (int kk = 0; kk < k; ++kk) s += row[(size_t)kk * H1];
  da[t] = s;
}

// Partial dW2 of one 128x128 tile over one slice of the edge rows:
// 8x8 outputs a thread (rows ty*4+i and 64+ty*4+i, columns likewise).
__global__ void __launch_bounds__(kThreads)
    bwd_dw2(const float* __restrict__ msgs, const float* __restrict__ gm,
            float* __restrict__ part, long long E, long long chunk, int H1,
            int H2) {
  __shared__ __align__(16) float As[kStage][kTile];
  __shared__ __align__(16) float Bs[kStage][kTile];
  const int h0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const long long eb = blockIdx.z * chunk;
  const long long ee = min(E, eb + chunk);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  // the next stage's operands load into registers while this one computes
  constexpr int kPer = kStage * kTile / kThreads;
  float ra[kPer], rb[kPer];
  auto fetch = [&](long long e) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int t = threadIdx.x + p * kThreads;
      const int q = t / kTile, col = t % kTile;
      const long long row = e + q;
      ra[p] = (row < ee && h0 + col < H1) ? msgs[row * H1 + h0 + col] : 0.0f;
      rb[p] = (row < ee && c0 + col < H2) ? gm[row * H2 + c0 + col] : 0.0f;
    }
  };
  fetch(eb);
  for (long long e = eb; e < ee; e += kStage) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int t = threadIdx.x + p * kThreads;
      As[t / kTile][t % kTile] = ra[p];
      Bs[t / kTile][t % kTile] = rb[p];
    }
    __syncthreads();
    if (e + kStage < ee) fetch(e + kStage);
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[q][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[q][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[q][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[q][64 + tx * 4]);
      const float ai[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bj[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * H1 * H2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int h = h0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (h < H1 && c < H2) out[(size_t)h * H2 + c] = acc[i][j];
    }
  }
}

// out[i] = sum_{s < S} part[s * n + i], in order of s (short S).
__global__ void sum_partials(const float* __restrict__ part, long long S,
                             long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (long long q = 0; q < S; ++q) s += part[q * n + i];
  out[i] = s;
}

// The same sum for a long S: one block per i, each thread a fixed
// strided subset in order, then a fixed tree (deterministic).
__global__ void __launch_bounds__(kThreads)
    sum_partials_long(const float* __restrict__ part, long long S, long long n,
                      float* __restrict__ out) {
  __shared__ float red[kThreads];
  const long long i = blockIdx.x;
  float s = 0.0f;
  for (long long q = threadIdx.x; q < S; q += kThreads) s += part[q * n + i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[i] = red[0];
}

// w2t [H2, H1] = w2 [H1, H2] transposed, for coalesced reads of W2^T.
template <typename T>
__global__ void transpose(const T* __restrict__ w2, T* __restrict__ w2t,
                          int H1, int H2) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)H1 * H2) return;
  const int h = (int)(t / H2), c = (int)(t % H2);
  w2t[(size_t)c * H1 + h] = w2[t];
}

// Reverse index of one event's valid edges: offs[j]..offs[j+1] in list
// are the edge ids (i*k + kk) whose neighbour is j, in increasing order.
__global__ void __launch_bounds__(kThreads)
    bwd_csr(const int32_t* __restrict__ idx, const uint8_t* __restrict__ em,
            int L, int k, int* __restrict__ offs, int* __restrict__ list) {
  // s_off [L+1] | cursor [L] | part [blockDim] | tgt [blockDim]
  extern __shared__ int ismem[];
  int* s_off = ismem;
  int* cursor = s_off + L + 1;
  int* part = cursor + L;
  int* tgt = part + blockDim.x;
  const int ev = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int n = L * k;
  const int32_t* id = idx + (size_t)ev * n;
  const uint8_t* m = em + (size_t)ev * n;

  for (int i = tid; i < L; i += nt) cursor[i] = 0;
  __syncthreads();
  for (int e = tid; e < n; e += nt) {
    const int j = id[e];
    if (m[e] && j >= 0 && j < L) atomicAdd(&cursor[j], 1);  // counts
  }
  __syncthreads();
  // exclusive scan of the counts: each thread a contiguous chunk
  const int per = (L + nt - 1) / nt;
  const int lo = min(L, tid * per), hi = min(L, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += cursor[i];
  part[tid] = sum;
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int t = 0; t < nt; ++t) {
      const int v = part[t];
      part[t] = run;
      run += v;
    }
    s_off[L] = run;
  }
  __syncthreads();
  int run = part[tid];
  for (int i = lo; i < hi; ++i) {
    s_off[i] = run;
    run += cursor[i];
  }
  __syncthreads();
  for (int i = tid; i < L; i += nt) cursor[i] = 0;
  for (int i = tid; i <= L; i += nt) offs[(size_t)ev * (L + 1) + i] = s_off[i];
  __syncthreads();
  // fill in edge order: a chunk of nt edges at a time, each edge ranked
  // among the chunk's earlier edges with the same neighbour
  for (int c0 = 0; c0 < n; c0 += nt) {
    const int e = c0 + tid;
    int j = -1;
    if (e < n) {
      const int v = id[e];
      if (m[e] && v >= 0 && v < L) j = v;
    }
    tgt[tid] = j;
    __syncthreads();
    if (j >= 0) {
      int rank = 0;
      for (int t = 0; t < tid; ++t) rank += tgt[t] == j;
      list[(size_t)ev * n + s_off[j] + cursor[j] + rank] = e;
    }
    __syncthreads();
    if (j >= 0) atomicAdd(&cursor[j], 1);
    __syncthreads();
  }
}

// db[j] = sum of the gz rows of j's incoming edges, in edge order, each
// rounded to the compute type T first.
template <typename T>
__global__ void bwd_db(const float* __restrict__ gz,
                       const int* __restrict__ offs,
                       const int* __restrict__ list, float* __restrict__ db,
                       int L, int k, int H1) {
  const int j = blockIdx.x, ev = blockIdx.y;
  const int* o = offs + (size_t)ev * (L + 1);
  const int p0 = o[j], p1 = o[j + 1];
  const int* lst = list + (size_t)ev * L * k;
  const float* gE = gz + (size_t)ev * L * k * H1;
  for (int h = threadIdx.x; h < H1; h += blockDim.x) {
    float s = 0.0f;
    for (int p = p0; p < p1; ++p) s += round_c<T>(gE[(size_t)lst[p] * H1 + h]);
    db[((size_t)ev * L + j) * H1 + h] = s;
  }
}

cudaError_t allow_smem(const void* kernel, size_t bytes, size_t* configured) {
  if (bytes <= 48 * 1024 || bytes <= *configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *configured = bytes;
  return err;
}

}  // namespace

static long long gm_smem(int H1) {
  return (long long)kRows * ((H1 + 3) & ~3) * 4 + kRows * (4 + 1);
}

// Shared memory of bwd_gm and of the CSR kernel, in bytes (the wrapper
// checks both against the card's limit before launching).
extern "C" long long edgeconv_bwd_smem_bytes(int H1) { return gm_smem(H1); }

extern "C" long long edgeconv_bwd_csr_smem_bytes(int L) {
  return (2LL * L + 1 + 2 * kThreads) * 4;
}

#define CHECK_LAUNCH()                                   \
  do {                                                   \
    cudaError_t e_ = cudaGetLastError();                 \
    if (e_ != cudaSuccess) return e_;                    \
  } while (0)

// Every kernel of the backward, in order, for compute type T.
template <typename T>
static cudaError_t launch(const T* a, const T* b, const int32_t* idx,
                          const uint8_t* em, const T* w2, const T* b2,
                          const float* g, float* da, float* db, float* dw2,
                          float* db2, T* w2t, float* msgs, float* gm,
                          float* gz, float* dw2_part, float* db2_part,
                          int* offs, int* list, int B, int L, int H1, int H2,
                          int k, int S, float slope, int aggr_max,
                          cudaStream_t s) {
  static size_t conf_gm = 0, conf_csr = 0;
  const int tl = kRows / k;
  const long long E = (long long)B * L * k;
  cudaError_t err;
  transpose<T><<<(unsigned)(((long long)H1 * H2 + 255) / 256), 256, 0, s>>>(
      w2, w2t, H1, H2);
  CHECK_LAUNCH();

  // 1. edge rows: gm (and msgs, db2 partials), then gz and da
  const dim3 grid((L + tl - 1) / tl, B);
  err = allow_smem((const void*)bwd_gm<T>, gm_smem(H1), &conf_gm);
  if (err != cudaSuccess) return err;
  bwd_gm<T><<<grid, kThreads, gm_smem(H1), s>>>(a, b, idx, em, w2, b2, g,
                                                msgs, gm, db2_part, L, H1, H2,
                                                k, tl, slope, aggr_max);
  CHECK_LAUNCH();
  const dim3 gz_tiles((unsigned)((E + kTile - 1) / kTile),
                      (H1 + kTile - 1) / kTile);
  bwd_gz<T><<<gz_tiles, kThreads, 0, s>>>(gm, w2t, a, b, idx, em, gz, E, L,
                                          H1, H2, k, slope);
  CHECK_LAUNCH();
  const long long n_da = (long long)B * L * H1;
  bwd_da<<<(unsigned)((n_da + 255) / 256), 256, 0, s>>>(gz, da, n_da, k, H1);
  CHECK_LAUNCH();

  // 2. dW2 split over S slices of the edge rows, then db2
  const long long chunk = (E + S - 1) / S;
  const dim3 tiles((H1 + kTile - 1) / kTile, (H2 + kTile - 1) / kTile, S);
  bwd_dw2<<<tiles, kThreads, 0, s>>>(msgs, gm, dw2_part, E, chunk, H1, H2);
  CHECK_LAUNCH();
  const long long n_w = (long long)H1 * H2;
  sum_partials<<<(unsigned)((n_w + 255) / 256), 256, 0, s>>>(dw2_part, S, n_w,
                                                              dw2);
  CHECK_LAUNCH();
  sum_partials_long<<<H2, kThreads, 0, s>>>(db2_part, (long long)grid.x * B,
                                            H2, db2);
  CHECK_LAUNCH();

  // 3. db through the reverse index
  const size_t csr_smem = (size_t)edgeconv_bwd_csr_smem_bytes(L);
  err = allow_smem((const void*)bwd_csr, csr_smem, &conf_csr);
  if (err != cudaSuccess) return err;
  bwd_csr<<<B, kThreads, csr_smem, s>>>(idx, em, L, k, offs, list);
  CHECK_LAUNCH();
  bwd_db<T><<<dim3(L, B), 128, 0, s>>>(gz, offs, list, db, L, k, H1);
  return cudaGetLastError();
}

// Scratch (all from the wrapper): w2t [H2, H1] of w2's type; msgs_buf
// [B*L*k, H1], gm_buf [B*L*k, H2], gz_buf [B*L*k, H1], dw2_part [S, H1, H2],
// db2_part [blocks, H2] float; offs [B, L+1], list [B, L*k] int32.
// blocks = B * ceil(L / (64/k)).
extern "C" int edgeconv_bwd_launch(
    const void* a, const void* b, const void* idx, const void* em,
    const void* w2, const void* b2, const void* g, void* da, void* db,
    void* dw2, void* db2, void* w2t, void* msgs_buf, void* gm_buf,
    void* gz_buf, void* dw2_part, void* db2_part, void* offs, void* list,
    int B, int L, int H1, int H2, int k, int S, float slope, int aggr_max,
    int bf16, void* stream) {
  if (B == 0 || L == 0) return 0;
  if (k < 1 || k > kRows || S < 1) return (int)cudaErrorInvalidValue;
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const uint8_t* m = static_cast<const uint8_t*>(em);
  const float* gf = static_cast<const float*>(g);
  float* f[9] = {static_cast<float*>(da),       static_cast<float*>(db),
                 static_cast<float*>(dw2),      static_cast<float*>(db2),
                 static_cast<float*>(msgs_buf), static_cast<float*>(gm_buf),
                 static_cast<float*>(gz_buf),   static_cast<float*>(dw2_part),
                 static_cast<float*>(db2_part)};
  int* o = static_cast<int*>(offs);
  int* lst = static_cast<int*>(list);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return (int)launch<T>(
        static_cast<const T*>(a), static_cast<const T*>(b), ix, m,
        static_cast<const T*>(w2), static_cast<const T*>(b2), gf, f[0], f[1],
        f[2], f[3], static_cast<T*>(w2t), f[4], f[5], f[6], f[7], f[8], o, lst,
        B, L, H1, H2, k, S, slope, aggr_max, s);
  }
  return (int)launch<float>(
      static_cast<const float*>(a), static_cast<const float*>(b), ix, m,
      static_cast<const float*>(w2), static_cast<const float*>(b2), gf, f[0],
      f[1], f[2], f[3], static_cast<float*>(w2t), f[4], f[5], f[6], f[7], f[8],
      o, lst, B, L, H1, H2, k, S, slope, aggr_max, s);
}
