// What the EdgeConv forward block (edgeconv.cuh, for edgeconv.cu and
// edgeconv_knn.cu) and the backward's edge kernel (edgeconv_bwd.cu)
// share: the block of 64 edge rows and its neighbour indices, the
// message build, the W2 tiles streamed through a ring of cp.async stages
// and the product pre2 = msgs.W2 over them, in both compute types.  Both
// take W2's h tiles in the same rotated order with the same products, so
// the backward recomputes the forward's pre2 bit for bit (and the max
// routing picks the edge whose value the forward took, even at a
// near-tie).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace ec {

using bf16_t = __nv_bfloat16;
using hopper::cp_async16;
using hopper::ldmatrix_x4;
using hopper::ldmatrix_x4_trans;
using hopper::mma_bf16;
using hopper::pack_bf16;

constexpr int kRows = 64;      // edge rows per block
constexpr int kThreads = 256;  // 8 warps

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

inline cudaError_t allow_smem(const void* kernel, size_t bytes,
                              size_t* configured) {
  if (bytes <= 48 * 1024 || bytes <= *configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *configured = bytes;
  return err;
}

// Blocks of `kernel` (kThreads threads) an SM holds with `smem` bytes of
// dynamic shared memory, by its registers and shared memory; -1 on an
// error.
inline int blocks_per_sm(const void* kernel, size_t smem) {
  size_t configured = 0;
  int n = 0;
  if (allow_smem(kernel, smem, &configured) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

// Per compute type, the tiles.  pre2 = msgs.W2 streams tiles of kPreR
// rows (h) of W2, the forward kFwdC columns (c) a tile through a ring of
// kFwdStages, the backward kPreC through kStages; g_z = gm.W2^T (the
// backward), kGzN of its columns (h) a pass, streams tiles of kGzR x
// kGzC: of W2 (bf16: rows h, columns c, read by ldmatrix) or of W2^T
// (fp32: rows c, columns h, read along h by float4).  The stages in
// flight cover the copies' latency from L2.  kStage edge rows per dW2
// stage.
template <typename T>
struct Cfg;
template <>
struct Cfg<bf16_t> {
  static constexpr int kStages = 4, kPreR = 64, kPreC = 128, kGzR = 64,
                       kGzC = 128, kGzN = 64, kStage = 32, kFwdStages = 2,
                       kFwdC = 256;
  static constexpr bool kGzT = false;
};
template <>
struct Cfg<float> {
  static constexpr int kStages = 3, kPreR = 16, kPreC = 256, kGzR = 16,
                       kGzC = 128, kGzN = 128, kStage = 16, kFwdStages = 4,
                       kFwdC = 256;
  static constexpr bool kGzT = true;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16_t x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16_t from_f<bf16_t>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at4(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// the 8 values at p (16-byte aligned), as floats
__device__ __forceinline__ void load8(float (&v)[8], const bf16_t* p) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v[2 * i] = __bfloat162float(h.x);
    v[2 * i + 1] = __bfloat162float(h.y);
  }
}
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 x = ld4(p), y = ld4(p + 4);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  v[4] = y.x, v[5] = y.y, v[6] = y.z, v[7] = y.w;
}

// v rounded to T into dst (16-byte aligned)
__device__ __forceinline__ void store8(bf16_t* dst, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}
__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <int M, int N>
__device__ __forceinline__ void zero(float (&acc)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.f;
}
template <int L, int M, int N>
__device__ __forceinline__ void zero(float (&acc)[L][M][N]) {
#pragma unroll
  for (int i = 0; i < L; ++i) zero(acc[i]);
}

// Start the 16-byte copy of src into dst, or zeros where src is null
// (`base`: any valid source address, named where nothing is read).
template <typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src, const T* base) {
  cp_async16(dst, src ? src : base, src ? 16 : 0);
}

// Start the copy of rows [r0, r0 + R) x columns [c0, c0 + C) of src
// ([*][ld]) into dst ([R][C + 16 bytes]), zeros outside [0, rows) x
// [0, cols) (cols a multiple of 16 bytes).  Commits nothing.
template <typename T, int R, int C>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int ld, int r0, int c0, int rows,
                                          int cols) {
  constexpr int kPer = 16 / (int)sizeof(T), kCpr = C / kPer;
  for (int i = threadIdx.x; i < R * kCpr; i += kThreads) {
    const int r = i / kCpr, c = (i % kCpr) * kPer;
    const bool in = r0 + r < rows && c0 + c < cols;
    copy16(dst + r * (C + kPer) + c,
           in ? src + (size_t)(r0 + r) * ld + c0 + c : nullptr, src);
  }
}

// pre2's step t over a column chunk: the W2 rows of h tile
// (t % nhp + rot) % nhp, its first row returned.  The tiles are rotated
// per block (rot), so that the blocks that run together read other parts
// of W2 from L2 at a time; forward and backward rotate alike.
template <typename T>
__device__ __forceinline__ int pre_h0(int t, int nhp, int rot) {
  return (t % nhp + rot) % nhp * Cfg<T>::kPreR;
}

// ---- the messages.  Start the copies of the neighbours' b rows into
// msg ([kRows][ldm], zeros for invalid edges and past H1, up to H1p) in
// the current commit group.
template <typename T>
__device__ __forceinline__ void issue_b_rows(T* msg, int ldm,
                                             const T* __restrict__ bE,
                                             const T* __restrict__ b,
                                             const int* s_idx,
                                             const uint8_t* s_em, int H1,
                                             int H1p) {
  constexpr int kPer = 16 / (int)sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const T* src = s_em[r] ? bE + (size_t)s_idx[r] * H1 : nullptr;
    for (int h = lane * kPer; h < H1p; h += 32 * kPer)
      copy16(msg + r * ldm + h, src && h < H1 ? src + h : nullptr, b);
  }
}

// msgs = act(a + b) in place of the b rows, once they have landed, a
// warp per row, 8 columns a lane, over the first nch8 * 8 columns; the a
// rows are arows[(r / k) * lda ..] (shared or global memory, read only
// for valid edges and h < H1).  Four rows a pass, their loads issued
// before any arithmetic.  With zbits, also each message's z > 0 bits, a
// byte per 8 columns (nch8 bytes a row).
template <typename T>
__device__ __forceinline__ void build_msgs(T* msg, int ldm, const T* arows,
                                           int lda, int k, int H1, int nch8,
                                           const uint8_t* s_em, float slope,
                                           uint8_t* zbits) {
  constexpr int kWarps = kThreads / 32, kPass = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r0 = warp; r0 < kRows; r0 += kPass * kWarps) {
    int node[kPass];
    bool ok[kPass];
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
      node[j] = (r0 + j * kWarps) / k;
      ok[j] = s_em[r0 + j * kWarps] != 0;
    }
    for (int ch = lane; ch < nch8; ch += 32) {
      float x[kPass][8], y[kPass][8];
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        if (ok[j] && ch * 8 < H1) {
          load8(x[j], arows + (size_t)node[j] * lda + ch * 8);
        } else {
#pragma unroll
          for (int u = 0; u < 8; ++u) x[j][u] = 0.f;
        }
        load8(y[j], msg + (r0 + j * kWarps) * ldm + ch * 8);
      }
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        const int r = r0 + j * kWarps;
        uint32_t bits = 0;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float z = ok[j] ? x[j][u] + y[j][u] : 0.f;
          if (zbits) bits |= (z > 0.0f ? 1u : 0u) << u;
          x[j][u] = act(z, slope);
        }
        store8(msg + r * ldm + ch * 8, x[j]);
        if (zbits) zbits[r * nch8 + ch] = (uint8_t)bits;
      }
    }
  }
}

// ---- pre2 = msgs.W2, a streamed tile [kPreR][NC + 16 bytes] a step.
// bf16: the 8 warps in a grid of 4 / MT rows of warps by 2 MT columns;
// warp w owns the MT m-tiles (16 rows each) from 16 MT (w % (4 / MT))
// and the NT n-tiles (8 columns each) from 8 NT (w / (4 / MT)): a tile
// is 16 MT NT columns wide.  The W2 tile is [h][c]: B fragments by
// ldmatrix.trans, each shared by the warp's MT m-tiles.  Only the first
// nks 16-row k slices of the tile are taken (the rest are zeros past
// H1).  Each accumulator sums its k slices in the same order whatever
// MT and NT.
template <int MT, int NT>
__device__ __forceinline__ void pre_step(float (&acc)[MT][NT][4],
                                         const bf16_t* msg, int ldm, int h0,
                                         const bf16_t* w,
                                         int nks = Cfg<bf16_t>::kPreR / 16) {
  constexpr int WR = 4 / MT, ldw = 16 * MT * NT + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp % WR, cg = warp / WR;
#pragma unroll
  for (int ks = 0; ks < Cfg<bf16_t>::kPreR / 16; ++ks) {
    if (ks >= nks) break;
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(af[mt], msg + ((rg * MT + mt) * 16 + (lane & 15)) * ldm +
                              h0 + ks * 16 + (lane >> 4) * 8);
    const int hr = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(
          b, w + hr * ldw + cg * 8 * NT + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * np], af[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
      }
    }
  }
}

// pre2 + b2 of the chunk from column c0 into pre ([kRows][ldp] fp32,
// its first column pre2's column `base`)
template <int MT, int NT>
__device__ __forceinline__ void pre_store(const float (&acc)[MT][NT][4],
                                          float* pre, int ldp, int c0,
                                          const bf16_t* __restrict__ b2,
                                          int H2, int base = 0) {
  constexpr int WR = 4 / MT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp % WR, cg = warp / WR;
  const int gq = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = c0 + cg * 8 * NT + n * 8 + c;
    const float bias0 = col < H2 ? to_f(b2[col]) : 0.f;
    const float bias1 = col + 1 < H2 ? to_f(b2[col + 1]) : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = (rg * MT + mt) * 16 + gq + 8 * r;
        *reinterpret_cast<float2*>(pre + row * ldp + col - base) =
            make_float2(acc[mt][n][2 * r] + bias0,
                        acc[mt][n][2 * r + 1] + bias1);
      }
  }
}

// fp32: warp w owns rows w + 8 i (i < 8), lane l the columns 4 l .. + 3
// and 128 + 4 l .. + 3 of a 256-column tile: 8 x 8 micro-tiles, each
// operand read as float4, the rows' along h (a broadcast in the warp),
// the tile's along the lanes.
__device__ __forceinline__ void pre_step(float (&acc)[8][8], const float* msg,
                                         int ldm, int h0, const float* w,
                                         int = 0) {
  constexpr int ldw = Cfg<float>::kPreC + 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int hh = 0; hh < Cfg<float>::kPreR; hh += 4) {
    float4 mv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) mv[i] = ld4(msg + (warp + 8 * i) * ldm + h0 + hh);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 w0 = ld4(w + (hh + u) * ldw + 4 * lane);
      const float4 w1 = ld4(w + (hh + u) * ldw + 128 + 4 * lane);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float m = at4(mv[i], u);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(m, wv[j], acc[i][j]);
      }
    }
  }
}

__device__ __forceinline__ void pre_store(const float (&acc)[8][8], float* pre,
                                          int ldp, int c0,
                                          const float* __restrict__ b2,
                                          int H2, int base = 0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int col = c0 + 128 * jj + 4 * lane;
    float bias[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) bias[u] = col + u < H2 ? b2[col + u] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float* a = acc[i] + 4 * jj;
      *reinterpret_cast<float4*>(pre + (warp + 8 * i) * ldp + col - base) =
          make_float4(a[0] + bias[0], a[1] + bias[1], a[2] + bias[2],
                      a[3] + bias[3]);
    }
  }
}

}  // namespace ec
