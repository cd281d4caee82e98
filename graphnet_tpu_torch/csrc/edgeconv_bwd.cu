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
// give the same bits (no floating-point atomics).  Six launches (seven
// in fp32, which first transposes W2):
//
//   1. the edge kernel: pre2 = msgs.W2 + b2 recomputed from the gathered
//      rows, the routing gives gm, g_z = (gm.W2^T) * act'(z), and da sums
//      each node's rows of g_z in order.  Only what crosses blocks
//      leaves: the gm rows (for dW2), the g_z rows in the compute type
//      (for db), the block's partial of db2.  A block of padding nodes
//      (no valid edge) writes its zeros and stops.  Three routes (the
//      wrapper's bwd_route, from H1, H2 and the dtype):
//      - bf16: bwd_edge<bf16_t> below, a block of 64 edge rows (64/k
//        whole nodes of one event, as the forward; fewer rows when k does
//        not divide 64).  The neighbours' b rows and the nodes' a rows
//        come in by cp.async and become the messages (and their z > 0
//        bits) in shared memory; pre2 over W2 tiles streamed through a
//        ring of cp.async stages into fp32 in shared memory; the routing
//        replaces the messages by gm; g_z a pass of columns at a time
//        over the ring again.  The message build, the W2 tiles and the
//        pre2 product are the forward's code (edgeconv_tiles.cuh), in the
//        same tile order, so pre2 is the forward's, bit for bit.
//      - fp32 up to H1 = 352, H2 = 256 (every DynEdge layer): ecf::bwd_edge
//        (edgeconv_bwd_f32.cuh), a block of two forward blocks' 128 rows
//        on 16 warps, pre2 in registers in the forward's tile order.
//      - wider fp32: bwd_edge<float>, the bf16 kernel's design with 8 x 8
//        and 8 x 4 register tiles over W2 and W2^T.
//   2. dW2 = msgs^T gm split over slices of at most 1024 edge rows, each
//      slice's valid edges streamed through a ring of cp.async stages,
//      msgs formed from their a and b rows where they land: bf16 in
//      128 x 128 tiles (bwd_dw2), fp32 in 128 x 256 tiles (ecf::dw2),
//      where a slice with no valid edge (most of a batch padded to a long
//      bucket) writes no partial and is not summed.  sum_partials (or
//      sum_used_partials) adds the slices' partials and sum_partials_long
//      the db2 partials, each in a fixed order.
//   3. db: bwd_csr, one block per event, builds the reverse (CSR) index
//      of incoming edges, ordered by edge id; bwd_db (bf16, a block a
//      node) or bwd_db_f32 (a warp a node) sums the g_z rows of its
//      incoming edges in that order.
//
// What bounds it on the H100: operations.  It does three products of
// 2*E*H1*H2 flops (E valid edges): about 3x the forward's.  At DynEdge's
// layers 1-3 (H1=336, H2=256), B=128, L=128, k=8 with ~75 % of the edges
// valid that is ~51 GFLOP: 0.76 ms on the fp32 CUDA cores, 0.05 ms on
// the bf16 tensor cores.  bf16 runs the products on the tensor cores
// (mma.sync.m16n8k16 with ldmatrix fragments; mma_bf16.cuh), fp32 on the
// CUDA cores in full fp32 (no TF32).  The 64-row design holds one block
// of 8 warps an SM (its shared memory) and streams all of W2 twice for
// every 64 rows: in fp32 its products ran at about a third of the rate.
// So the fp32 kernels of edgeconv_bwd_f32.cuh hold 16 warps an SM, let
// each W2 tile serve 128 rows, keep pre2 in registers, leave nothing but
// FMAs and shared-memory reads in their products' loops, and write the
// gm rows from the routing threads a line at a time; their note says
// the rest (PERF.md §6 gives the times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "edgeconv_bwd_f32.cuh"
#include "edgeconv_tiles.cuh"
#include "mma_bf16.cuh"

namespace {

using ec::act;
using ec::at4;
using ec::bf16_t;
using ec::Cfg;
using ec::copy16;
using ec::from_f;
using ec::kRows;
using ec::kThreads;
using ec::ld4;
using ec::load8;
using ec::load_tile;
using ec::pre_h0;
using ec::pre_step;
using ec::pre_store;
using ec::store8;
using ec::to_f;
using ec::zero;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::ldmatrix_x4;
using hopper::ldmatrix_x4_trans;
using hopper::mma_bf16;
using hopper::pack_bf16;

constexpr int kTile = 128;    // dW2 tile edge (h and c)
constexpr int kChunk = 1024;  // at most this many edge rows per dW2 slice
constexpr int kDwStages = 3;  // dW2 stages in flight

// The edge kernel's shared memory for compute type T and k neighbours,
// in order: the messages, later the gm rows (row strides ldm, ldg: the
// padded widths and 16 bytes); pre2 in fp32 (ldp), later the g_z
// staging; the ring of tiles (slot elements each); the z > 0 bits of the
// messages, a byte per 8 columns (nzb bytes a row); the block's
// neighbour indices and edge flags.  The nodes' a rows are staged first
// where pre2 and the ring go (a_bytes); `early`: they leave the ring
// free, so that its first tiles can be in flight meanwhile.  Widths are
// padded with zeros to H1p (a multiple of the g_z pass) and H2p (of a
// pre2 column chunk).
struct EdgeLayout {
  int H1p, H2p, ldm, ldg, ldp, slot, nzb;
  size_t msg_bytes, pre_bytes, w_bytes, a_bytes, bits_bytes, total;
  bool early;
};

template <typename T>
__host__ __device__ inline EdgeLayout edge_layout(int H1, int H2, int k) {
  using C = Cfg<T>;
  constexpr int el = (int)sizeof(T), pad = 16 / el;
  constexpr int kPreSlot = C::kPreR * (C::kPreC + pad);
  constexpr int kGzSlot = C::kGzR * (C::kGzC + pad);
  EdgeLayout s;
  s.H1p = (H1 + C::kGzN - 1) / C::kGzN * C::kGzN;
  s.H2p = (H2 + C::kPreC - 1) / C::kPreC * C::kPreC;
  s.ldm = s.H1p + pad;
  s.ldg = s.H2p + pad;
  s.ldp = s.H2p + 8;
  s.slot = kPreSlot > kGzSlot ? kPreSlot : kGzSlot;
  s.nzb = s.H1p / 8;
  s.msg_bytes = (size_t)kRows * (s.ldm > s.ldg ? s.ldm : s.ldg) * el;
  s.pre_bytes = (size_t)kRows * s.ldp * 4;
  s.w_bytes = (size_t)C::kStages * s.slot * el;
  s.a_bytes = (size_t)(kRows / k) * s.ldm * el;
  s.early = s.a_bytes <= s.pre_bytes;
  s.bits_bytes = ((size_t)kRows * s.nzb + 15) / 16 * 16;
  const size_t stage = s.pre_bytes + s.w_bytes;
  s.total = s.msg_bytes + (stage > s.a_bytes ? stage : s.a_bytes) +
            s.bits_bytes + kRows * (4 + 1);
  return s;
}

// ---- the products of the edge kernel, per compute type: pre2 over a
// column chunk of kPreC (Acc::pre a thread), g_z over a pass of kGzN
// columns (Acc::gz a thread), a streamed tile a step.
template <typename T>
struct Acc;
template <>
struct Acc<bf16_t> {  // mma C fragments: [m-tile][n-tile][4]
  using pre = float[1][8][4];
  using gz = float[4][4];
};
template <>
struct Acc<float> {  // [row i][column]
  using pre = float[8][8];
  using gz = float[8][4];
};

__device__ __forceinline__ void gz_step(float (&acc)[4][4], const bf16_t* gm,
                                        int ldg, int c0, const bf16_t* w) {
  constexpr int ldw = Cfg<bf16_t>::kGzC + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp & 3, hg = warp >> 2;
#pragma unroll
  for (int ks = 0; ks < Cfg<bf16_t>::kGzC / 16; ++ks) {
    uint32_t af[4];
    ldmatrix_x4(af, gm + (rg * 16 + (lane & 15)) * ldg + c0 + ks * 16 +
                        (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, w + (hg * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8) *
                             ldw +
                         ks * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], af, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], af, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void gz_store(const float (&acc)[4][4], float* gzs,
                                         int ldz) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp & 3, hg = warp >> 2;
  const int gq = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(gzs + (rg * 16 + gq + 8 * r) * ldz + hg * 32 +
                                 n * 8 + c) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
}

__device__ __forceinline__ void gz_step(float (&acc)[8][4], const float* gm,
                                        int ldg, int c0, const float* wt) {
  constexpr int ldw = Cfg<float>::kGzC + 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int cc = 0; cc < Cfg<float>::kGzR; cc += 4) {
    float4 gv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) gv[i] = ld4(gm + (warp + 8 * i) * ldg + c0 + cc);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 x = ld4(wt + (cc + u) * ldw + 4 * lane);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float m = at4(gv[i], u);
        acc[i][0] = fmaf(m, x.x, acc[i][0]);
        acc[i][1] = fmaf(m, x.y, acc[i][1]);
        acc[i][2] = fmaf(m, x.z, acc[i][2]);
        acc[i][3] = fmaf(m, x.w, acc[i][3]);
      }
    }
  }
}

__device__ __forceinline__ void gz_store(const float (&acc)[8][4], float* gzs,
                                         int ldz) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(gzs + (warp + 8 * i) * ldz + 4 * lane) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// The tiles of each product, rotated per block (rot) so that the blocks
// that run together read other parts of W2 from L2 at a time.  pre2's
// step t: column chunk t / nhp, W2 rows of h tile (t % nhp + rot) % nhp
// (ec::pre_h0, as the forward).  g_z's step t: pass (t / nk + rot) % np,
// k tile t % nk.  Both give the source tile's first row and column.
template <typename T>
__device__ __forceinline__ int2 pre_tile(int t, int nhp, int rot) {
  return make_int2(pre_h0<T>(t, nhp, rot), (t / nhp) * Cfg<T>::kPreC);
}
template <typename T>
__device__ __forceinline__ int gz_pass(int t, int nk, int np, int rot) {
  return (t / nk + rot) % np;
}
template <typename T>
__device__ __forceinline__ int2 gz_tile(int t, int nk, int np, int rot) {
  using C = Cfg<T>;
  const int h0 = gz_pass<T>(t, nk, np, rot) * C::kGzN;
  const int k0 = (t % nk) * (C::kGzT ? C::kGzR : C::kGzC);
  return C::kGzT ? make_int2(k0, h0) : make_int2(h0, k0);
}

// One block of 64 edge rows: pre2, the routed and gated gm, g_z and da.
// Writes the gm rows ([E][H2p], compute type), the g_z rows ([E][H1],
// compute type), da and the block's partial of db2.  H1 and H2 are
// multiples of 8 and every pointer is 16-byte aligned (the wrapper
// pads); w2t is W2^T ([H2][H1]) where g_z reads it (kGzT).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_edge(const T* __restrict__ a, const T* __restrict__ b,
             const int32_t* __restrict__ idx, const uint8_t* __restrict__ em,
             const T* __restrict__ w2, const T* __restrict__ w2t,
             const T* __restrict__ b2, const float* __restrict__ g,
             T* __restrict__ gm_out, T* __restrict__ gz_out,
             float* __restrict__ da, float* __restrict__ db2_part, int L,
             int H1, int H2, int k, int tl, float slope, int aggr_max) {
  using C = Cfg<T>;
  constexpr int S = C::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const EdgeLayout lay = edge_layout<T>(H1, H2, k);
  const int ldm = lay.ldm, ldg = lay.ldg, ldp = lay.ldp, slot = lay.slot;
  const int nzb = lay.nzb;
  unsigned char* p = smem_raw;
  T* msg = reinterpret_cast<T*>(p);  // [kRows][ldm], then gm [kRows][ldg]
  p += lay.msg_bytes;
  T* as = reinterpret_cast<T*>(p);           // [tl][ldm] first
  float* pre = reinterpret_cast<float*>(p);  // [kRows][ldp]
  p += lay.pre_bytes;
  T* ring = reinterpret_cast<T*>(p);  // [kStages][slot]
  p = smem_raw + lay.msg_bytes +
      (lay.pre_bytes + lay.w_bytes > lay.a_bytes ? lay.pre_bytes + lay.w_bytes
                                                 : lay.a_bytes);
  uint8_t* zbits = p;  // [kRows][nzb]
  p += lay.bits_bytes;
  int* s_idx = reinterpret_cast<int*>(p);
  uint8_t* s_em = reinterpret_cast<uint8_t*>(s_idx + kRows);

  const int ev = blockIdx.y;
  const int n0 = blockIdx.x * tl;
  const int live = min(tl * k, (L - n0) * k);  // rows of existing nodes
  const size_t e0 = ((size_t)ev * L + n0) * k;  // the block's first edge row
  // pre2: nhp h tiles for each of ncp column chunks; g_z: np passes of
  // nk k tiles
  const int nhp = (H1 + C::kPreR - 1) / C::kPreR, ncp = lay.H2p / C::kPreC;
  const int np = lay.H1p / C::kGzN,
            nk = lay.H2p / (C::kGzT ? C::kGzR : C::kGzC);
  const int npre = nhp * ncp, ngz = np * nk;
  const int rot_pre = blockIdx.x % nhp, rot_gz = blockIdx.x % np;
  const T* gsrc = C::kGzT ? w2t : w2;  // g_z's tiles
  const int g_ld = C::kGzT ? H1 : H2, g_rows = C::kGzT ? H2 : H1;
  auto pre_load = [=](int t) {
    const int2 rc = pre_tile<T>(t, nhp, rot_pre);
    load_tile<T, C::kPreR, C::kPreC>(ring + (t % S) * slot, w2, H2, rc.x, rc.y,
                                     H1, H2);
  };
  auto gz_load = [=](int t) {
    const int2 rc = gz_tile<T>(t, nk, np, rot_gz);
    load_tile<T, C::kGzR, C::kGzC>(ring + (t % S) * slot, gsrc, g_ld, rc.x,
                                   rc.y, g_rows, g_ld);
  };
  ec::load_edges(idx, em, ev, n0, L, k, tl * k, s_idx, s_em);
  // a block of padding nodes (no valid edge): da and the db2 partial are
  // 0; its gm and g_z rows are read by no one (dW2 and db take valid
  // edges only)
  if (!__syncthreads_or(threadIdx.x < kRows && s_em[threadIdx.x])) {
    for (int i = threadIdx.x; i < tl * H1; i += kThreads) {
      const int nd = i / H1;
      if (n0 + nd < L) da[((size_t)ev * L + n0) * H1 + i] = 0.f;
    }
    const size_t bid = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    for (int c = threadIdx.x; c < H2; c += kThreads) db2_part[bid * H2 + c] = 0.f;
    return;
  }
  // the tiles of each product stream through the ring S - 1 ahead, each
  // in a commit group of its own
  if (lay.early) {
    for (int t = 0; t < S - 1; ++t) {
      if (t < npre) pre_load(t);
      cp_async_commit();
    }
  }
  // the first 8 nodes' output gradient of this thread's first column,
  // for the routing
  float g0[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int c = threadIdx.x, node = n0 + u;
    g0[u] = (u < tl && node < L && c < H2) ? g[((size_t)ev * L + node) * H2 + c]
                                           : 0.f;
  }

  // the messages: the neighbours' b rows into msg, the nodes' a rows
  // into `as`, then msgs = act(a + b) in place with their z > 0 bits
  {
    const T* aE = a + (size_t)ev * L * H1;
    constexpr int kPer = 16 / (int)sizeof(T);
    const int cpr = lay.H1p / kPer;
    ec::issue_b_rows(msg, ldm, b + (size_t)ev * L * H1, b, s_idx, s_em, H1,
                     lay.H1p);
    for (int i = threadIdx.x; i < tl * cpr; i += kThreads) {
      const int q = i / cpr, h = (i % cpr) * kPer;
      copy16(as + q * ldm + h,
             n0 + q < L && h < H1 ? aE + (size_t)(n0 + q) * H1 + h : nullptr, a);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  ec::build_msgs(msg, ldm, as, ldm, k, H1, nzb, s_em, slope, zbits);
  if (!lay.early) {
    __syncthreads();  // the a rows are read: the ring is free
    for (int t = 0; t < S - 1; ++t) {
      if (t < npre) pre_load(t);
      cp_async_commit();
    }
  }

  // 1. pre2 = msgs.W2 + b2 into `pre` (no longer the a rows: the first
  // tile's __syncthreads orders the messages before it)
  {
    typename Acc<T>::pre acc;
    zero(acc);
    for (int t = 0; t < npre; ++t) {
      cp_async_wait<S - 2>();
      __syncthreads();  // tile t landed; every warp is done with tile t - 1
      if (t + S - 1 < npre) pre_load(t + S - 1);
      cp_async_commit();
      pre_step(acc, msg, ldm, pre_tile<T>(t, nhp, rot_pre).x,
               ring + (t % S) * slot);
      if (t % nhp == nhp - 1) {
        pre_store(acc, pre, ldp, (t / nhp) * C::kPreC, b2, H2);
        zero(acc);
      }
    }
  }
  __syncthreads();  // pre2 complete; the messages are no longer read
  for (int t = 0; t < S - 1; ++t) {  // g_z's first tiles, during the routing
    if (t < ngz) gz_load(t);
    cp_async_commit();
  }

  // 2. routing: thread per column, nodes in order, their output gradient
  // loaded 8 nodes at a time; gm replaces msgs
  T* gms = msg;
  const size_t bid = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  for (int c = threadIdx.x; c < lay.H2p; c += kThreads) {
    float db2_acc = 0.f;
    for (int q0 = 0; q0 < tl; q0 += 8) {
      float gq[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int node = n0 + q0 + u;
        gq[u] = c == threadIdx.x && q0 == 0 ? g0[u]
                : (q0 + u < tl && node < L && c < H2)
                    ? g[((size_t)ev * L + node) * H2 + c]
                    : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int q = q0 + u;
        if (q >= tl) break;
        const bool exists = n0 + q < L;
        float best = 0.f, best_gate = 0.f;
        int first = -1;
        for (int k0 = 0; k0 < k; k0 += 8) {  // 8 rows' pre2 in flight
          float pr[8];
          bool ok[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int r = q * k + k0 + j;
            ok[j] = exists && k0 + j < k && s_em[r];
            pr[j] = ok[j] ? pre[r * ldp + c] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (k0 + j >= k) break;
            const int r = q * k + k0 + j;
            float gv = 0.f;
            if (ok[j]) {
              const float gate = pr[j] > 0.0f ? 1.0f : slope;
              if (aggr_max) {
                const float v = act(pr[j], slope);
                if (first < 0 || v > best) {  // strictly greater: first argmax
                  best = v;
                  best_gate = gate;
                  first = r;
                }
              } else {
                gv = gq[u] * gate;
                db2_acc += gv;
              }
            }
            gms[r * ldg + c] = from_f<T>(gv);
          }
        }
        if (aggr_max && first >= 0) {
          const float gf = gq[u] * best_gate;
          gms[first * ldg + c] = from_f<T>(gf);
          db2_acc += gf;
        }
      }
    }
    for (int r = tl * k; r < kRows; ++r) gms[r * ldg + c] = from_f<T>(0.f);
    if (c < H2) db2_part[bid * H2 + c] = db2_acc;
  }
  __syncthreads();
  {  // the gm rows of existing nodes, 16 bytes at a time
    const int cpr = lay.H2p * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < live * cpr; i += kThreads) {
      const int r = i / cpr, q = i % cpr;
      reinterpret_cast<uint4*>(gm_out + (e0 + r) * lay.H2p)[q] =
          reinterpret_cast<const uint4*>(gms + r * ldg)[q];
    }
  }

  // 3. g_z = (gm.W2^T) * act'(z), kGzN columns a pass, then da
  constexpr int kN = C::kGzN, ldz = kN + 4;
  float* gzs = pre;  // [kRows][ldz]: pre2 is no longer read
  typename Acc<T>::gz acz;
  zero(acz);
  for (int t = 0; t < ngz; ++t) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + S - 1 < ngz) gz_load(t + S - 1);
    cp_async_commit();
    gz_step(acz, gms, ldg, (t % nk) * (C::kGzT ? C::kGzR : C::kGzC),
            ring + (t % S) * slot);
    if (t % nk != nk - 1) continue;
    gz_store(acz, gzs, ldz);
    zero(acz);
    __syncthreads();
    // gate by z, 8 columns a thread; the g_z rows in the compute type
    const int h0 = gz_pass<T>(t, nk, np, rot_gz) * kN;
    for (int i = threadIdx.x; i < kRows * (kN / 8); i += kThreads) {
      const int r = i / (kN / 8), hh = (i % (kN / 8)) * 8, h = h0 + hh;
      const bool ok = s_em[r] && h < H1;  // H1 % 8 == 0
      const uint32_t bits = zbits[r * nzb + h / 8];
      float v[8];
      load8(v, gzs + r * ldz + hh);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = ok ? v[u] * ((bits >> u) & 1u ? 1.0f : slope) : 0.f;
      store8(gzs + r * ldz + hh, v);
      if (r < live && h < H1) store8(gz_out + (e0 + r) * H1 + h, v);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tl * kN; i += kThreads) {
      const int nd = i / kN, hh = i % kN, h = h0 + hh;
      if (n0 + nd < L && h < H1) {
        float s = 0.0f;
        for (int kk = 0; kk < k; ++kk) s += gzs[(nd * k + kk) * ldz + hh];
        da[((size_t)ev * L + n0 + nd) * H1 + h] = s;
      }
    }
    // gzs is written again only after the next pass's tiles, past a
    // __syncthreads at the top of the loop
  }
}

// w2t [H2, H1] = w2 [H1, H2] transposed, for g_z's fp32 tiles.
template <typename T>
__global__ void transpose(const T* __restrict__ w2, T* __restrict__ w2t,
                          int H1, int H2) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)H1 * H2) return;
  const int h = (int)(t / H2), c = (int)(t % H2);
  w2t[(size_t)c * H1 + h] = w2[t];
}

// ---- dW2: partial dW2 of one 128 x 128 tile (h0.., c0..) over the
// valid edges of one slice of at most kChunk edge rows [eb, ee), kStage
// edges a stage through a ring of kDwStages: each stage copies in, by
// cp.async, the edges' a rows (their nodes'), b rows (their neighbours',
// gathered) and gm rows; rows past the last valid edge are zeros.
// bf16 forms msgs = act(a + b), rounded, in the A fragments; fp32 in
// place of the a rows, once a stage.

template <typename T>
constexpr size_t dw2_smem_bytes() {
  return (size_t)kDwStages * 3 * Cfg<T>::kStage * (kTile + 16 / sizeof(T)) *
             sizeof(T) +
         2 * kChunk * sizeof(int);
}

// Start the copy of one dW2 stage, the valid edges [v0, v0 + kStage) of
// the slice, into buf: their a rows, b rows and gm rows, each
// [kStage][kTile + 16 bytes]; rows past nv as zeros.
template <typename T>
__device__ __forceinline__ void dw2_issue(T* buf, const T* __restrict__ a,
                                          const T* __restrict__ b,
                                          const T* __restrict__ gm,
                                          const int* s_rows,
                                          const int* s_boff, int v0, int nv,
                                          int h0, int c0, int H1, int H2p,
                                          int k) {
  constexpr int kSt = Cfg<T>::kStage, kPer = 16 / (int)sizeof(T);
  constexpr int kLd = kTile + kPer, kCpr = kTile / kPer;
  for (int i = threadIdx.x; i < kSt * kCpr; i += kThreads) {
    const int r = i / kCpr, c = (i % kCpr) * kPer, v = v0 + r;
    const bool row = v < nv;
    const bool in = row && h0 + c < H1;  // H1 % kPer == 0
    const int e = row ? s_rows[v] : 0;
    copy16(buf + r * kLd + c, in ? a + (size_t)(e / k) * H1 + h0 + c : nullptr,
           a);
    copy16(buf + kSt * kLd + r * kLd + c,
           in ? b + (size_t)s_boff[v] * H1 + h0 + c : nullptr, b);
    copy16(buf + 2 * kSt * kLd + r * kLd + c,
           row ? gm + (size_t)e * H2p + c0 + c : nullptr, gm);
  }
}

// bf16: warp w owns h rows 32 (w & 3) .. + 31 (2 m-tiles) and c columns
// 64 (w >> 2) .. + 63 (8 n-tiles).  A = msgs^T: the a and b stages read
// by ldmatrix.trans, added, activated and rounded in the fragment; B =
// gm by ldmatrix.trans of the [e][c] stage.
__device__ __forceinline__ uint32_t msg_pair(uint32_t x, uint32_t y,
                                             float slope) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&y);
  return pack_bf16(act(__bfloat162float(a.x) + __bfloat162float(b.x), slope),
                   act(__bfloat162float(a.y) + __bfloat162float(b.y), slope));
}

__device__ __forceinline__ void dw2_step(float (&acc)[2][8][4],
                                         const bf16_t* as, const bf16_t* bs,
                                         const bf16_t* gs, int ld,
                                         float slope) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wh = warp & 3, wc = warp >> 2;
#pragma unroll
  for (int ks = 0; ks < Cfg<bf16_t>::kStage / 16; ++ks) {
    uint32_t af[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int at = (ks * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * ld +
                     wh * 32 + m * 16 + ((lane >> 3) & 1) * 8;
      uint32_t x[4], y[4];
      ldmatrix_x4_trans(x, as + at);
      ldmatrix_x4_trans(y, bs + at);
#pragma unroll
      for (int e = 0; e < 4; ++e) af[m][e] = msg_pair(x[e], y[e], slope);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldmatrix_x4_trans(
          bf, gs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                  wc * 64 + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma_bf16(acc[m][2 * np], af[m], bf[0], bf[1]);
        mma_bf16(acc[m][2 * np + 1], af[m], bf[2], bf[3]);
      }
    }
  }
}

__device__ __forceinline__ void dw2_store(const float (&acc)[2][8][4],
                                          float* out, int h0, int c0, int H1,
                                          int H2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wh = warp & 3, wc = warp >> 2;
  const int gq = lane >> 2, cq = 2 * (lane & 3);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = h0 + wh * 32 + m * 16 + gq + 8 * (e >> 1);
        const int c = c0 + wc * 64 + n * 8 + cq + (e & 1);
        if (h < H1 && c < H2) out[(size_t)h * H2 + c] = acc[m][n][e];
      }
}

template <typename T>
struct Dw2Acc;
template <>
struct Dw2Acc<bf16_t> {
  using type = float[2][8][4];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_dw2(const T* __restrict__ a, const T* __restrict__ b,
            const int32_t* __restrict__ idx, const uint8_t* __restrict__ em,
            const T* __restrict__ gm, float* __restrict__ part, int E,
            int chunk, int L, int H1, int H2, int H2p, int k, float slope) {
  constexpr int kSt = Cfg<T>::kStage, S = kDwStages;
  constexpr int kLd = kTile + 16 / (int)sizeof(T);
  constexpr int kBuf = kSt * kLd;  // elements of one stage buffer
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [S][a, b, gm][kSt][kLd]
  int* s_boff = reinterpret_cast<int*>(ring + S * 3 * kBuf);  // [kChunk]
  int* s_rows = s_boff + kChunk;                               // [kChunk]
  __shared__ int s_count[kThreads / 32 + 1];
  const int h0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const int eb = blockIdx.z * chunk;
  const int ee = min(E, eb + chunk);
  // the slice's valid edges, in order: their rows and neighbour rows in
  // b (a node's row in a is e / k); each thread takes 4 rows, then a
  // scan of the counts
  int nv;
  {
    constexpr int kPerT = kChunk / kThreads;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int bo[kPerT], cnt = 0;
#pragma unroll
    for (int u = 0; u < kPerT; ++u) {
      const int e = eb + threadIdx.x * kPerT + u;
      bo[u] = -1;
      if (e < ee) {
        const int j = idx[e];
        if (em[e] && j >= 0 && j < L) bo[u] = (e / (L * k)) * L + j;
      }
      cnt += bo[u] >= 0;
    }
    int incl = cnt;  // inclusive scan over the warp, then over the warps
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) s_count[warp] = incl;
    __syncthreads();
    if (threadIdx.x == 0) {
      int run = 0;
      for (int w = 0; w < kThreads / 32; ++w) {
        const int x = s_count[w];
        s_count[w] = run;
        run += x;
      }
      s_count[kThreads / 32] = run;
    }
    __syncthreads();
    int at = s_count[warp] + incl - cnt;
#pragma unroll
    for (int u = 0; u < kPerT; ++u) {
      if (bo[u] >= 0) {
        s_rows[at] = eb + threadIdx.x * kPerT + u;
        s_boff[at] = bo[u];
        ++at;
      }
    }
    nv = s_count[kThreads / 32];
    __syncthreads();
  }
  const int nst = (nv + kSt - 1) / kSt;
  typename Dw2Acc<T>::type acc;
  zero(acc);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nst)
      dw2_issue(ring + s * 3 * kBuf, a, b, gm, s_rows, s_boff, s * kSt, nv, h0,
                c0, H1, H2p, k);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<S - 2>();
    __syncthreads();  // stage s landed; every warp is done with s - 1
    if (s + S - 1 < nst)
      dw2_issue(ring + ((s + S - 1) % S) * 3 * kBuf, a, b, gm, s_rows, s_boff,
                (s + S - 1) * kSt, nv, h0, c0, H1, H2p, k);
    cp_async_commit();
    T* buf = ring + (s % S) * 3 * kBuf;
    dw2_step(acc, buf, buf + kBuf, buf + 2 * kBuf, kLd, slope);
  }
  dw2_store(acc, part + (size_t)blockIdx.z * H1 * H2, h0, c0, H1, H2);
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

// The same over the slices `used` marks, in order of s (fp32): a block
// first lists a chunk's marked slices in order (a warp's ballots), then
// each thread sums its i over them.
__global__ void __launch_bounds__(256)
    sum_used_partials(const float* __restrict__ part,
                      const int* __restrict__ used, long long S, long long n,
                      float* __restrict__ out) {
  constexpr int kList = 2048;
  __shared__ int list[kList];
  __shared__ int count;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float s = 0.0f;
  for (long long q0 = 0; q0 < S; q0 += kList) {
    if (threadIdx.x < 32) {
      int base = 0;
      for (int j = 0; j < kList; j += 32) {
        const long long q = q0 + j + threadIdx.x;
        const bool f = q < S && used[q];
        const unsigned m = __ballot_sync(0xffffffffu, f);
        if (f)
          list[base + __popc(m & ((1u << threadIdx.x) - 1))] = j + threadIdx.x;
        base += __popc(m);
      }
      if (threadIdx.x == 0) count = base;
    }
    __syncthreads();
    if (i < n)
      for (int j = 0; j < count; ++j) s += part[(q0 + list[j]) * n + i];
    __syncthreads();  // the list is read before the next chunk's
  }
  if (i < n) out[i] = s;
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

// db[j] = sum of the g_z rows (fp32) of j's incoming edges, in edge
// order, as bwd_db's: a warp a node, 8 nodes a block, 4 columns a lane.
__global__ void __launch_bounds__(256)
    bwd_db_f32(const float* __restrict__ gz, const int* __restrict__ offs,
               const int* __restrict__ list, float* __restrict__ db, int L,
               int k, int H1) {
  const int j = blockIdx.x * 8 + threadIdx.x / 32, ev = blockIdx.y;
  if (j >= L) return;
  const int* o = offs + (size_t)ev * (L + 1);
  const int p0 = o[j], p1 = o[j + 1];
  const int* lst = list + (size_t)ev * L * k;
  const float* gE = gz + (size_t)ev * L * k * H1;
  for (int h = 4 * (threadIdx.x % 32); h < H1; h += 128) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = p0; p < p1; ++p)
      s = ecf::add4(s, ecf::ld4(gE + (size_t)lst[p] * H1 + h));
    ecf::st4(db + ((size_t)ev * L + j) * H1 + h, s);
  }
}

// db[j] = sum of the g_z rows (compute type) of j's incoming edges, in
// edge order.
template <typename T>
__global__ void bwd_db(const T* __restrict__ gz, const int* __restrict__ offs,
                       const int* __restrict__ list, float* __restrict__ db,
                       int L, int k, int H1) {
  const int j = blockIdx.x, ev = blockIdx.y;
  const int* o = offs + (size_t)ev * (L + 1);
  const int p0 = o[j], p1 = o[j + 1];
  const int* lst = list + (size_t)ev * L * k;
  const T* gE = gz + (size_t)ev * L * k * H1;
  for (int h = threadIdx.x; h < H1; h += blockDim.x) {
    float s = 0.0f;
    for (int p = p0; p < p1; ++p) s += to_f(gE[(size_t)lst[p] * H1 + h]);
    db[((size_t)ev * L + j) * H1 + h] = s;
  }
}

}  // namespace

// The backward's routes (the C entry's `route`, the wrapper's
// bwd_route): 0 fp32 with the 64-row edge kernel, 1 bf16, 2 fp32 with
// the 128-row edge kernel of edgeconv_bwd_f32.cuh.
enum Route { kF32Rows64 = 0, kBf16 = 1, kF32Rows128 = 2 };

// Shared memory of the edge kernel and of the CSR kernel, in bytes (the
// wrapper checks both against the card's limit before launching).
extern "C" long long edgeconv_bwd_smem_bytes(int H1, int H2, int k,
                                             int route) {
  if (route == kF32Rows128) return (long long)ecf::layout(H1).total;
  return (long long)(route == kBf16 ? edge_layout<bf16_t>(H1, H2, k).total
                                    : edge_layout<float>(H1, H2, k).total);
}

extern "C" long long edgeconv_bwd_csr_smem_bytes(int L) {
  return (2LL * L + 1 + 2 * kThreads) * 4;
}

#define CHECK_LAUNCH()                                   \
  do {                                                   \
    cudaError_t e_ = cudaGetLastError();                 \
    if (e_ != cudaSuccess) return e_;                    \
  } while (0)

// What follows the edge kernel, in order, for compute type T: dW2 over S
// slices and the sums of its partials (fp32: ecf::dw2, which marks the
// slices that hold a valid edge in `used`, summed alone) and of the edge
// blocks' db2 partials, then db through the reverse index (fp32: a warp
// a node).
template <typename T>
static cudaError_t launch_tail(const T* a, const T* b, const int32_t* idx,
                               const uint8_t* em, float* db, float* dw2,
                               float* db2, const T* gm, const T* gz,
                               float* dw2_part, int* used,
                               const float* db2_part, long long edge_blocks,
                               int* offs, int* list, int B, int L, int H1,
                               int H2, int H2p, int k, int S, float slope,
                               cudaStream_t s) {
  static size_t conf_dw2 = 0, conf_csr = 0;
  const int E = B * L * k;
  cudaError_t err;
  const int chunk = (E + S - 1) / S;
  if (chunk > kChunk) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4) {
    const dim3 tiles((H1 + ecf::kDwH - 1) / ecf::kDwH,
                     (H2 + ecf::kDwC - 1) / ecf::kDwC, S);
    err = ec::allow_smem((const void*)ecf::dw2, ecf::dw2_smem(), &conf_dw2);
    if (err != cudaSuccess) return err;
    ecf::dw2<<<tiles, ecf::kDwThreads, ecf::dw2_smem(), s>>>(
        a, b, idx, em, gm, dw2_part, used, E, chunk, L, H1, H2, H2p, k, slope);
  } else {
    const dim3 tiles((H1 + kTile - 1) / kTile, (H2 + kTile - 1) / kTile, S);
    err = ec::allow_smem((const void*)bwd_dw2<T>, dw2_smem_bytes<T>(),
                         &conf_dw2);
    if (err != cudaSuccess) return err;
    bwd_dw2<T><<<tiles, kThreads, dw2_smem_bytes<T>(), s>>>(
        a, b, idx, em, gm, dw2_part, E, chunk, L, H1, H2, H2p, k, slope);
  }
  CHECK_LAUNCH();
  const long long n_w = (long long)H1 * H2;
  const unsigned w_blocks = (unsigned)((n_w + 255) / 256);
  if (used)
    sum_used_partials<<<w_blocks, 256, 0, s>>>(dw2_part, used, S, n_w, dw2);
  else
    sum_partials<<<w_blocks, 256, 0, s>>>(dw2_part, S, n_w, dw2);
  CHECK_LAUNCH();
  sum_partials_long<<<H2, kThreads, 0, s>>>(db2_part, edge_blocks, H2, db2);
  CHECK_LAUNCH();

  const size_t csr_smem = (size_t)edgeconv_bwd_csr_smem_bytes(L);
  err = ec::allow_smem((const void*)bwd_csr, csr_smem, &conf_csr);
  if (err != cudaSuccess) return err;
  bwd_csr<<<B, kThreads, csr_smem, s>>>(idx, em, L, k, offs, list);
  CHECK_LAUNCH();
  if constexpr (sizeof(T) == 4)
    bwd_db_f32<<<dim3((L + 7) / 8, B), 256, 0, s>>>(gz, offs, list, db, L, k,
                                                    H1);
  else
    bwd_db<T><<<dim3(L, B), 128, 0, s>>>(gz, offs, list, db, L, k, H1);
  return cudaGetLastError();
}

// Every kernel of the backward, in order, for compute type T with the
// 64-row edge kernel.
template <typename T>
static cudaError_t launch(const T* a, const T* b, const int32_t* idx,
                          const uint8_t* em, const T* w2, const T* b2,
                          const float* g, float* da, float* db, float* dw2,
                          float* db2, T* w2t, T* gm, T* gz, float* dw2_part,
                          int* used, float* db2_part, int* offs, int* list,
                          int B, int L, int H1, int H2, int k, int S,
                          float slope, int aggr_max, cudaStream_t s) {
  static size_t conf_edge = 0;
  const int tl = kRows / k;
  const EdgeLayout lay = edge_layout<T>(H1, H2, k);
  cudaError_t err;

  // 1. edge rows: gm, g_z, da and the db2 partials
  if constexpr (Cfg<T>::kGzT) {
    transpose<T><<<(H1 * H2 + 255) / 256, 256, 0, s>>>(w2, w2t, H1, H2);
    CHECK_LAUNCH();
  }
  const dim3 grid((L + tl - 1) / tl, B);
  err = ec::allow_smem((const void*)bwd_edge<T>, lay.total, &conf_edge);
  if (err != cudaSuccess) return err;
  bwd_edge<T><<<grid, kThreads, lay.total, s>>>(
      a, b, idx, em, w2, w2t, b2, g, gm, gz, da, db2_part, L, H1, H2, k, tl,
      slope, aggr_max);
  CHECK_LAUNCH();
  // 2. dW2, db2 and db
  return launch_tail<T>(a, b, idx, em, db, dw2, db2, gm, gz, dw2_part, used,
                        db2_part, (long long)grid.x * B, offs, list, B, L, H1,
                        H2, lay.H2p, k, S, slope, s);
}

// The same in fp32 with the 128-row edge kernel (H1 <= 368, H2 <= 256).
static cudaError_t launch_rows128(const float* a, const float* b,
                                  const int32_t* idx, const uint8_t* em,
                                  const float* w2, const float* b2,
                                  const float* g, float* da, float* db,
                                  float* dw2, float* db2, float* w2t,
                                  float* gm, float* gz, float* dw2_part,
                                  int* used, float* db2_part, int* offs,
                                  int* list, int B, int L, int H1, int H2,
                                  int k, int S, float slope, int aggr_max,
                                  cudaStream_t s) {
  static size_t conf_edge = 0;
  const int tl = kRows / k;  // the forward's nodes a block; two here
  const size_t smem = ecf::layout(H1).total;
  if (H2 > ecf::kPreC || smem > 232448) return cudaErrorInvalidValue;
  transpose<float><<<(H1 * H2 + 255) / 256, 256, 0, s>>>(w2, w2t, H1, H2);
  CHECK_LAUNCH();
  const dim3 grid((L + 2 * tl - 1) / (2 * tl), B);
  cudaError_t err =
      ec::allow_smem((const void*)ecf::bwd_edge, smem, &conf_edge);
  if (err != cudaSuccess) return err;
  ecf::bwd_edge<<<grid, ecf::kThreads, smem, s>>>(
      a, b, idx, em, w2, w2t, b2, g, gm, gz, da, db2_part, L, H1, H2, k, tl,
      slope, aggr_max);
  CHECK_LAUNCH();
  return launch_tail<float>(a, b, idx, em, db, dw2, db2, gm, gz, dw2_part,
                            used, db2_part, (long long)grid.x * B, offs, list,
                            B, L, H1, H2, ecf::kPreC, k, S, slope, s);
}

// H1 and H2 multiples of 8; every pointer 16-byte aligned.  Scratch (all
// from the wrapper): w2t [H2, H1] (used in fp32), gm_buf [B*L*k, H2p]
// (H2 rounded up to a pre2 column chunk: 128 in bf16, 256 in fp32) and
// gz_buf [B*L*k, H1], all of a's type; dw2_part [S, H1, H2] with S >=
// B*L*k / 1024 float, dw2_used [S] int32 (read in fp32); db2_part
// [blocks, H2] float; offs [B, L+1], list [B, L*k] int32.  blocks = B *
// ceil(L / (64/k)), and half that (rounded up a event) on route 2.
extern "C" int edgeconv_bwd_launch(
    const void* a, const void* b, const void* idx, const void* em,
    const void* w2, const void* b2, const void* g, void* da, void* db,
    void* dw2, void* db2, void* w2t, void* gm_buf, void* gz_buf,
    void* dw2_part, void* dw2_used, void* db2_part, void* offs, void* list,
    int B, int L, int H1, int H2, int k, int S, float slope, int aggr_max,
    int route, void* stream) {
  if (B == 0 || L == 0) return 0;
  if (k < 1 || k > kRows || S < 1 || H1 % 8 || H2 % 8 || route < 0 ||
      route > kF32Rows128)
    return (int)cudaErrorInvalidValue;
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const uint8_t* m = static_cast<const uint8_t*>(em);
  const float* gf = static_cast<const float*>(g);
  float* f[6] = {static_cast<float*>(da),       static_cast<float*>(db),
                 static_cast<float*>(dw2),      static_cast<float*>(db2),
                 static_cast<float*>(dw2_part), static_cast<float*>(db2_part)};
  int* used = static_cast<int*>(dw2_used);
  int* o = static_cast<int*>(offs);
  int* lst = static_cast<int*>(list);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kBf16) {
    using T = bf16_t;
    return (int)launch<T>(
        static_cast<const T*>(a), static_cast<const T*>(b), ix, m,
        static_cast<const T*>(w2), static_cast<const T*>(b2), gf, f[0], f[1],
        f[2], f[3], static_cast<T*>(w2t), static_cast<T*>(gm_buf),
        static_cast<T*>(gz_buf), f[4], nullptr, f[5], o, lst, B, L, H1, H2,
        k, S, slope, aggr_max, s);
  }
  using T = float;
  auto* run = route == kF32Rows128 ? &launch_rows128 : &launch<T>;
  return (int)run(static_cast<const T*>(a), static_cast<const T*>(b), ix, m,
                  static_cast<const T*>(w2), static_cast<const T*>(b2), gf,
                  f[0], f[1], f[2], f[3], static_cast<T*>(w2t),
                  static_cast<T*>(gm_buf), static_cast<T*>(gz_buf), f[4], used,
                  f[5], o, lst, B, L, H1, H2, k, S, slope, aggr_max, s);
}
