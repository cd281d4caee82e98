// The fused EdgeConv forward of one block of 64 edge rows, shared by
// csrc/edgeconv.cu (the forward kernel) and csrc/edgeconv_knn.cu (the
// forward fused with the next layer's kNN), so that both compute `out`
// with the same code and give the same bits.  The messages, the W2 ring
// and the product pre2 = msgs.W2 are the backward's (edgeconv_tiles.cuh);
// edgeconv.cu's note says what the block does and what bounds it.
//
// Shared memory a block, in order: the messages [64][ldm] in the compute
// type (H1 zero-padded to a multiple of 16, plus 16 bytes a row); the
// ring of kFwdStages W2 tiles [kPreR][256 + 16 bytes], which at the end
// of each 256-column chunk becomes the fp32 staging of pre2 + b2
// [64][264]; the block's neighbour indices and edge flags.  At H1=336:
// bf16 44,032 + 67,584 + 320 = 111,936 bytes, two blocks an SM; fp32
// 87,040 + 67,584 + 320 = 154,944 bytes, one block an SM.

#pragma once

#include "edgeconv_tiles.cuh"

namespace ec {

constexpr int kLds = 256 + 8;  // floats per staged pre2 row (bank spread)

struct FwdLayout {
  int H1p, ldm, slot;
  size_t msg_bytes, region, total;
};

template <typename T>
__host__ __device__ inline FwdLayout fwd_layout(int H1) {
  using C = Cfg<T>;
  constexpr int el = (int)sizeof(T), pad = 16 / el;
  FwdLayout s;
  s.H1p = (H1 + 15) / 16 * 16;
  s.ldm = s.H1p + pad;  // bf16: an odd count of 16 bytes, for ldmatrix
  s.slot = C::kPreR * (C::kFwdC + pad);
  s.msg_bytes = (size_t)kRows * s.ldm * el;
  const size_t ring = (size_t)C::kFwdStages * s.slot * el;
  const size_t stage = (size_t)kRows * kLds * 4;
  s.region = ring > stage ? ring : stage;
  s.total = s.msg_bytes + s.region + kRows * (4 + 1);
  return s;
}

// the accumulators of pre2 over a 256-column chunk, a thread
template <typename T>
struct FwdAcc;
template <>
struct FwdAcc<bf16_t> {  // mma C fragments: [m-tile][n-tile][4]
  using type = float[2][8][4];
};
template <>
struct FwdAcc<float> {  // [row i][column]
  using type = float[8][8];
};

// One block: out rows n0 .. n0 + tl - 1 of event blockIdx.y, all H2
// columns.  H1 and H2 are multiples of 8 and a, b, w2 16-byte aligned
// (the wrapper pads).  `smem`: fwd_layout<T>(H1).total bytes.  A block of
// padding nodes (no valid edge) writes its zeros and returns.
template <typename T>
__device__ __forceinline__ void fwd_block(
    const T* __restrict__ a, const T* __restrict__ b,
    const int32_t* __restrict__ idx, const uint8_t* __restrict__ em,
    const T* __restrict__ w2, const T* __restrict__ b2,
    float* __restrict__ out, int L, int H1, int H2, int k, int tl,
    float slope, int aggr_max, unsigned char* smem) {
  using C = Cfg<T>;
  constexpr int S = C::kFwdStages, R = C::kPreR, NC = C::kFwdC;
  const FwdLayout lay = fwd_layout<T>(H1);
  const int ldm = lay.ldm, slot = lay.slot;
  T* msg = reinterpret_cast<T*>(smem);
  T* ring = reinterpret_cast<T*>(smem + lay.msg_bytes);
  float* stage = reinterpret_cast<float*>(smem + lay.msg_bytes);
  int* s_idx = reinterpret_cast<int*>(smem + lay.msg_bytes + lay.region);
  uint8_t* s_em = reinterpret_cast<uint8_t*>(s_idx + kRows);

  const int ev = blockIdx.y;
  const int n0 = blockIdx.x * tl;
  load_edges(idx, em, ev, n0, L, k, tl * k, s_idx, s_em);
  if (!__syncthreads_or(threadIdx.x < kRows && s_em[threadIdx.x])) {
    for (int i = threadIdx.x; i < tl * H2; i += kThreads) {
      if (n0 + i / H2 < L) out[((size_t)ev * L + n0) * H2 + i] = 0.f;
    }
    return;
  }
  // pre2 over nhp h tiles for each 256-column chunk, the tiles S - 1
  // ahead in the ring, each in a commit group of its own
  const int nhp = (H1 + R - 1) / R, rot = blockIdx.x % nhp;
  auto load = [=](int t, int c0) {
    load_tile<T, R, NC>(ring + (t % S) * slot, w2, H2, pre_h0<T>(t, nhp, rot),
                        c0, H1, H2);
  };
  for (int t = 0; t < S - 1; ++t) {
    if (t < nhp) load(t, 0);
    hopper::cp_async_commit();
  }

  // the messages: the neighbours' b rows into msg and the nodes' a rows
  // into the ring's last slot (read from memory where they do not fit),
  // then msgs = act(a + b) in place
  const T* aE = a + ((size_t)ev * L + n0) * H1;
  T* as = ring + (S - 1) * slot;
  const bool staged = tl * ldm <= slot;
  issue_b_rows(msg, ldm, b + (size_t)ev * L * H1, b, s_idx, s_em, H1,
               lay.H1p);
  if (staged) {
    constexpr int kPer = 16 / (int)sizeof(T);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int q = warp; q < tl; q += kThreads / 32) {
      for (int h = lane * kPer; h < H1; h += 32 * kPer)
        copy16(as + q * ldm + h, n0 + q < L ? aE + (size_t)q * H1 + h : nullptr,
               a);
    }
  }
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();
  if (staged) {  // two calls, so that this one reads shared memory only
    build_msgs(msg, ldm, as, ldm, k, H1, lay.H1p / 8, s_em, slope,
               (uint8_t*)nullptr);
  } else {
    build_msgs(msg, ldm, aE, H1, k, H1, lay.H1p / 8, s_em, slope,
               (uint8_t*)nullptr);
  }

  for (int c0 = 0; c0 < H2; c0 += NC) {
    if (c0 > 0) {
      for (int t = 0; t < S - 1; ++t) {
        if (t < nhp) load(t, c0);
        hopper::cp_async_commit();
      }
    }
    typename FwdAcc<T>::type acc;
    zero(acc);
    for (int t = 0; t < nhp; ++t) {
      hopper::cp_async_wait<S - 2>();
      __syncthreads();  // tile t landed; every warp is done with tile t - 1
      if (t + S - 1 < nhp) load(t + S - 1, c0);
      hopper::cp_async_commit();
      const int h0 = pre_h0<T>(t, nhp, rot);
      pre_step(acc, msg, ldm, h0, ring + (t % S) * slot, (lay.H1p - h0) / 16);
    }
    __syncthreads();  // every warp is done with the ring: pre2 + b2 there
    pre_store(acc, stage, kLds, c0, b2, H2, c0);
    __syncthreads();
    // bias done; act, mask and the sum or max over each node's k rows in
    // order, 4 columns a thread
    constexpr int kQ = NC / 4;
    for (int i = threadIdx.x; i < tl * kQ; i += kThreads) {
      const int q = i / kQ, cq = (i % kQ) * 4, col = c0 + cq;
      if (n0 + q >= L || col >= H2) continue;
      const float init = aggr_max ? -1e30f : 0.0f;
      float cur[4] = {init, init, init, init};
      bool has = false;
#pragma unroll 8
      for (int kk = 0; kk < k; ++kk) {
        const int r = q * k + kk;  // < 64: a row of the staging
        const float4 v = ld4(stage + r * kLds + cq);
        if (!s_em[r]) continue;
        const float x[4] = {act(v.x, slope), act(v.y, slope), act(v.z, slope),
                            act(v.w, slope)};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          cur[u] = aggr_max ? fmaxf(cur[u], x[u]) : cur[u] + x[u];
        has = true;
      }
      if (aggr_max && !has) cur[0] = cur[1] = cur[2] = cur[3] = 0.0f;
      *reinterpret_cast<float4*>(out + ((size_t)ev * L + n0 + q) * H2 + col) =
          make_float4(cur[0], cur[1], cur[2], cur[3]);
    }
    __syncthreads();  // the staging is read before the next tiles land
  }
}

// Shared memory a block needs, in bytes.
inline long long smem_bytes(int H1, int bf16) {
  return (long long)(bf16 ? fwd_layout<bf16_t>(H1).total
                          : fwd_layout<float>(H1).total);
}

}  // namespace ec
