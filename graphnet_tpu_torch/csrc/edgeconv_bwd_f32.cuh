// The fp32 kernels of the EdgeConv backward (edgeconv_bwd.cu, whose note
// says what they compute): their own code, apart from the bf16 kernels
// and from the forward's tiles.
//
// bwd_edge: one block is two of the forward's blocks (2 x 64 edge-row
// slots, 512 threads; warps 0-7 the first forward block's rows, 8-15 the
// second's), so each W2 tile read from L2 serves 128 rows, and 16 warps
// an SM hide the latency of the shared-memory operands that 8 did not.
//
//   1. msgs = act(a + b), gathered straight from memory (six items of
//      a lane's slot in flight), stored k-major with their z > 0 bits;
//   2. pre2 = msgs.W2 in registers (8 x 8 a thread) over W2 tiles of 16
//      h rows streamed through two ring slots.  Each element's FMA chain
//      takes the h tiles in the order the forward's block took them,
//      (t + blockIdx) % nhp for its own forward block: the second half's
//      order is the first's shifted by one tile, so the walk streams
//      nhp + 1 tiles, the first half skipping the last and the second
//      the first.  pre2 is thus the forward's, bit for bit, and the max
//      routing picks the forward's winner at near-ties;
//   3. pre2 + b2 replaces the messages; a thread a column and half
//      routes and gates it into gm in place (four rows a read where k is
//      a multiple of 4), sums the db2 partial, and writes the gm rows of
//      valid edges, for dW2 (a warp's 32 columns of a row a line);
//   4. g_z = (gm.W2^T) * act'(z) in passes of 128 columns over W2^T
//      tiles of 32 rows through the same ring, 8 x 4 a thread, gated in
//      registers; the g_z rows of valid edges leave for db, and da sums
//      each node's rows in order through a staging of 64 columns.
//
// What bounds it: the fp32 FMAs of the two products (issue slots: an
// FMA a lane a cycle), then the steps between them.  So each product's
// loop is FMAs and shared-memory reads alone: every ring copy's source
// and target are worked out once a thread (two 16-byte copies a tile)
// and each tile's index follows from the last's, without a division.
// A warp whose 32 slots hold no valid edge skips the products (the rest
// of its block still runs them), and a block with none writes its zeros
// and stops.  Every product is fp32 FMAs; every sum runs in a fixed
// order, so two runs give the same bits.
//
// Shared memory: the messages [H1p][132] (H1p: H1 rounded up to 16),
// whose place later holds pre2, then gm, [256][132] and the da staging
// [128][68]; two ring slots of 16.5 KB; the z > 0 bits [H1g / 8][128]
// (H1g: H1 rounded up to a g_z pass); the slots' neighbours, edge flags
// and the row blocks' flags.  218,000 bytes at H1 = 336, 206,480 at
// H1 = 128; H1 up to 352 fits (the wrapper sends wider layers, and H2
// past 256, to the 64-row kernel).
//
// dw2: dW2 = msgs^T gm, a tile of 128 h by 256 c over one slice of at
// most 1024 edge rows a block (512 threads, 8 x 8 a thread): the slice's
// valid edges are listed first, then 32 of them a stage stream their a,
// b and gm rows in by cp.async, two stages ahead (the copies' rows
// worked out at the listing), msgs = act(a + b) in place (a thread the
// rows it copied, so one __syncthreads a stage), and the product.  A
// tile 256 columns wide reads each gm row once for each 128 columns of
// h (H2 <= 256), and the msgs of a stage serve all of them.  A slice
// with no valid edge marks itself unused and writes nothing.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace ecf {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

constexpr int kSlots = 128;    // edge-row slots a block
constexpr int kHalf = 64;      // slots of one forward block
constexpr int kThreads = 512;  // 16 warps
constexpr int kPreR = 16;   // W2 rows (h) a pre2 tile: the forward's h tile
constexpr int kPreC = 256;  // pre2 columns (c): H2 <= 256
constexpr int kGzR = 32;    // W2^T rows (c) a g_z tile
constexpr int kGzN = 128;   // g_z columns (h) a pass
constexpr int kStageC = 64;  // g_z columns staged a round for da
constexpr int kLdt = kSlots + 4;  // a row of the k-major operands
constexpr int kLdw = kPreC + 4, kLdz = kGzN + 4, kLds = kStageC + 4;
constexpr int kRing = kPreR * kLdw > kGzR * kLdz ? kPreR * kLdw : kGzR * kLdz;
constexpr int kStages = 2;

struct Layout {
  int H1p, H1g, nzb;
  size_t region, ring, bits, total;
};

// In bytes: the region of the messages (later pre2, gm and the staging
// of g_z for da), the ring, the z > 0 bits, and the whole.
__host__ __device__ inline Layout layout(int H1) {
  Layout s;
  s.H1p = (H1 + kPreR - 1) / kPreR * kPreR;
  s.H1g = (H1 + kGzN - 1) / kGzN * kGzN;
  s.nzb = s.H1g / 8;
  const size_t msg = (size_t)s.H1p * kLdt * 4;
  const size_t gm = (size_t)kPreC * kLdt * 4 + (size_t)kSlots * kLds * 4;
  s.region = msg > gm ? msg : gm;
  s.ring = (size_t)kStages * kRing * 4;
  s.bits = (size_t)s.nzb * kSlots;
  s.total = s.region + s.ring + s.bits + kSlots * (4 + 1) + 4 * 4;
  return s;
}

__device__ __forceinline__ float act(float x, float slope) {
  return slope == 0.0f ? fmaxf(x, 0.0f) : (x > 0.0f ? x : slope * x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float4 add4(float4 x, float4 y) {
  return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}

// Fetch the 128-byte line at p into L2, without waiting for it.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// The 16-byte copy of src into dst where `in`, else zeros (`base`: any
// valid address, named where nothing is read).
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       const float* base, bool in) {
  cp_async16(dst, in ? src : base, in ? 16 : 0);
}

// The products' lane layout: a warp owns 32 slots (rb = warp / 4) and a
// column block (cb = warp % 4); lane = 8 rg + cg owns slots 32 rb + 4 rg
// + {0..3} and 32 rb + 16 + 4 rg + {0..3} (its rows i < 4 and i >= 4)
// and its column group cg of the block.  The row operands are stored
// k-major ([k][kLdt], the slots along a row), so at each k a lane reads
// its 8 rows' operands in two 16-byte reads and the tile's in one or two,
// each read a single wavefront, and the next k's operands are in flight
// during this k's FMAs.

// pre2 over one tile: the tile's 16 h rows, columns 64 cb + 4 cg .. + 3
// and 64 cb + 32 + 4 cg .. + 3; each element's FMAs in h order, as the
// forward's.  m: the messages at the tile's first h and the lane's first
// slot; w: the tile at the lane's first column.
__device__ __forceinline__ void pre_step(float (&acc)[8][8], const float* m,
                                         const float* w) {
  float4 a0 = ld4(m), a1 = ld4(m + 16), b0 = ld4(w), b1 = ld4(w + 32);
#pragma unroll
  for (int hh = 0; hh < kPreR; ++hh) {
    float4 na0 = a0, na1 = a1, nb0 = b0, nb1 = b1;
    if (hh + 1 < kPreR) {
      na0 = ld4(m + (hh + 1) * kLdt);
      na1 = ld4(m + (hh + 1) * kLdt + 16);
      nb0 = ld4(w + (hh + 1) * kLdw);
      nb1 = ld4(w + (hh + 1) * kLdw + 32);
    }
    const float x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float y[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    a0 = na0, a1 = na1, b0 = nb0, b1 = nb1;
  }
}

// g_z over one tile: the tile's 32 c rows, columns 32 cb + 4 cg .. + 3 of
// the pass (g_z's own column and row blocks, below).  gm: gm^T at the
// tile's first c and the lane's first slot;
// wt: the tile at the lane's first column.
__device__ __forceinline__ void gz_step(float (&acc)[8][4], const float* gm,
                                        const float* wt) {
  float4 a0 = ld4(gm), a1 = ld4(gm + 16), b = ld4(wt);
#pragma unroll
  for (int cc = 0; cc < kGzR; ++cc) {
    float4 na0 = a0, na1 = a1, nb = b;
    if (cc + 1 < kGzR) {
      na0 = ld4(gm + (cc + 1) * kLdt);
      na1 = ld4(gm + (cc + 1) * kLdt + 16);
      nb = ld4(wt + (cc + 1) * kLdz);
    }
    const float x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i][0] = fmaf(x[i], b.x, acc[i][0]);
      acc[i][1] = fmaf(x[i], b.y, acc[i][1]);
      acc[i][2] = fmaf(x[i], b.z, acc[i][2]);
      acc[i][3] = fmaf(x[i], b.w, acc[i][3]);
    }
    a0 = na0, a1 = na1, b = nb;
  }
}

// The routing of one row: pre2 value pr of a valid edge (ok) of the
// node being walked, whose output gradient is gq.  add: the row's gm,
// summed into db2; max: the running first argmax (strictly greater
// wins), its gate and row, gm written at the node's end.
struct Route {
  float best, best_gate;
  int first;
};
__device__ __forceinline__ float route_row(Route& st, float pr, bool ok,
                                           int r, float gq, float slope,
                                           int aggr_max, float& db2) {
  if (!ok) return 0.f;
  const float gate = pr > 0.0f ? 1.0f : slope;
  if (aggr_max) {
    const float v = act(pr, slope);
    if (st.first < 0 || v > st.best) {
      st.best = v;
      st.best_gate = gate;
      st.first = r;
    }
    return 0.f;
  }
  const float gv = gq * gate;
  db2 += gv;
  return gv;
}

// One block: nodes n0 .. n0 + 2 tl - 1 of event blockIdx.y (n0 = 2 tl
// blockIdx.x; tl = 64 / k, the forward's nodes a block).  Writes the gm
// rows ([E][256]) and the g_z rows ([E][H1]) of valid edges, da, and the
// block's partial of db2.  H1 and H2 are multiples of 8, H1 <= 352,
// H2 <= 256, every pointer 16-byte aligned; w2t is W2^T ([H2][H1]).
__global__ void __launch_bounds__(kThreads, 1)
    bwd_edge(const float* __restrict__ a, const float* __restrict__ b,
             const int32_t* __restrict__ idx, const uint8_t* __restrict__ em,
             const float* __restrict__ w2, const float* __restrict__ w2t,
             const float* __restrict__ b2, const float* __restrict__ g,
             float* __restrict__ gm_out, float* __restrict__ gz_out,
             float* __restrict__ da, float* __restrict__ db2_part, int L,
             int H1, int H2, int k, int tl, float slope, int aggr_max) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout lay = layout(H1);
  float* msg = reinterpret_cast<float*>(smem_raw);  // msgs^T [H1p][kLdt]
  float* gmt = msg;  // pre2 + b2, then gm: [kPreC][kLdt], the slots along
  float* stage = msg + kPreC * kLdt;  // g_z for da: [kSlots][kLds]
  float* ring = reinterpret_cast<float*>(smem_raw + lay.region);
  uint8_t* zbits = smem_raw + lay.region + lay.ring;  // [H1g / 8][kSlots]
  int* s_idx = reinterpret_cast<int*>(zbits + lay.bits);
  uint8_t* s_em = reinterpret_cast<uint8_t*>(s_idx + kSlots);
  int* s_rbact = reinterpret_cast<int*>(s_em + kSlots);  // [4] row blocks

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rb = warp / 4, cb = warp % 4, rg = lane / 8, cg = lane % 8;
  const int half = rb / 2, slot0 = 32 * rb + 4 * rg;  // the lane's rows
  // g_z's warps: column block warp / 4 and row block (warp / 4 + warp %
  // 4) % 4, so that each SMSP (warp % 4) holds every column block and
  // every row block once: a pass that ends short of 128 columns idles
  // column blocks, spread over the SMSPs
  const int cbz = warp / 4, rbz = (cbz + warp % 4) % 4;
  const int slotz = 32 * rbz + 4 * rg;
  auto slot_of = [&](int i) { return slotz + (i / 4) * 16 + i % 4; };
  const int ev = blockIdx.y;
  const int n0 = blockIdx.x * 2 * tl;
  const int rows = tl * k;  // edge rows of a half
  // slot s: row s % kHalf of half s / kHalf, edge row e0 + half rows + row
  const size_t e0 = ((size_t)ev * L + n0) * k;
  auto edge_of = [&](int s) { return e0 + (s / kHalf) * rows + s % kHalf; };
  if (tid < kSlots) {
    const int r = tid % kHalf, node = n0 + (tid / kHalf) * tl + r / k;
    int j = 0;
    uint8_t e = 0;
    if (r < rows && node < L) {
      const size_t o = edge_of(tid);
      j = idx[o];
      e = em[o];
      if (j < 0 || j >= L) {
        j = 0;
        e = 0;
      }
    }
    s_idx[tid] = j;
    s_em[tid] = e;
  }
  __syncthreads();
  if (tid < 4) {
    int any = 0;
    for (int i = 0; i < 32; ++i) any |= s_em[32 * tid + i];
    s_rbact[tid] = any;
  }
  const size_t bid = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  // a block of padding nodes (no valid edge): da and the db2 partial are
  // 0; its gm and g_z rows are read by no one
  if (!__syncthreads_or(tid < kSlots && s_em[tid])) {
    for (int i = tid; i < 2 * tl * H1; i += kThreads) {
      if (n0 + i / H1 < L) da[((size_t)ev * L + n0) * H1 + i] = 0.f;
    }
    for (int c = tid; c < H2; c += kThreads) db2_part[bid * H2 + c] = 0.f;
    return;
  }
  const bool wact = s_rbact[rb] != 0;  // a valid edge in the warp's rows
  const bool wactz = s_rbact[rbz] != 0;
  {  // the nodes' output gradient rows into L2, for the routing
    const char* gp =
        reinterpret_cast<const char*>(g + ((size_t)ev * L + n0) * H2);
    const int bytes = min(2 * tl, L - n0) * H2 * 4;
    for (int i = tid * 128; i < bytes; i += kThreads * 128) prefetch_l2(gp + i);
  }

  // pre2's tiles: step t holds h tile (rot + t) % nhp, rot the first
  // half's forward block's rotation; half 1 is one step behind.  A
  // thread copies rows pr and pr + 8, columns pc .. pc + 3, of each tile
  // (rows 0-7 of a tile always lie below H1, a multiple of 8)
  const int nhp = lay.H1p / kPreR, off = nhp > 1 ? 1 : 0;
  const int npre = nhp + off, rot = (2 * blockIdx.x) % nhp;
  const int pr = tid >> 6, pc = (tid & 63) * 4;
  const bool pin = pc < H2;
  const float* psrc = w2 + (size_t)pr * H2 + pc;
  float* pdst = ring + pr * kLdw + pc;
  auto pre_load = [&](int s, int ht) {
    const float* src = psrc + (size_t)ht * kPreR * H2;
    float* dst = pdst + s * kRing;
    copy16(dst, src, w2, pin);
    copy16(dst + 8 * kLdw, src + 8 * H2, w2, pin && (ht + 1) * kPreR <= H1);
  };
  // g_z's tiles: step t holds rows kt kGzR .. of pass pp (from rotz, in
  // turn), kt = t % nk; a thread copies rows zr and zr + 16, columns
  // zc .. zc + 3
  const int npass = lay.H1g / kGzN, nk = (H2 + kGzR - 1) / kGzR;
  const int ngz = npass * nk, rotz = blockIdx.x % npass;
  const int zr = tid >> 5, zc = (tid & 31) * 4;
  const float* zsrc = w2t + (size_t)zr * H1 + zc;
  float* zdst = ring + zr * kLdz + zc;
  auto gz_load = [&](int s, int kt, int pp) {
    const int c0 = kt * kGzR, p0 = pp * kGzN;
    const float* src = zsrc + (size_t)c0 * H1 + p0;
    float* dst = zdst + s * kRing;
    const bool in = p0 + zc < H1;
    copy16(dst, src, w2t, in && c0 + zr < H2);
    copy16(dst + 16 * kLdz, src + 16 * H1, w2t, in && c0 + zr + 16 < H2);
  };
  pre_load(0, rot);
  cp_async_commit();

  // 1. msgs^T = act(a + b) with its z > 0 bits, a lane a slot and eight
  // columns an item, six items in flight (zero bits up to H1g)
  {
    const float* aE = a + ((size_t)ev * L + n0) * H1;
    const float* bE = b + (size_t)ev * L * H1;
    const int nch = lay.H1g / 8, nchm = lay.H1p / 8, ncha = H1 / 8;
    const int s = 32 * (warp % 4) + lane;
    const bool ok = s_em[s] != 0;
    const float* ar = aE + (size_t)((s / kHalf) * tl + (s % kHalf) / k) * H1;
    const float* br = bE + (size_t)s_idx[s] * H1;
    constexpr int U = 6, kStep = kThreads / 128;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int ch0 = warp / 4; ch0 < nch; ch0 += U * kStep) {
      float4 x[U][2], y[U][2];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int ch = ch0 + u * kStep;
        const bool in = ok && ch < ncha;
        x[u][0] = in ? ld4(ar + ch * 8) : zero;
        x[u][1] = in ? ld4(ar + ch * 8 + 4) : zero;
        y[u][0] = in ? ld4(br + ch * 8) : zero;
        y[u][1] = in ? ld4(br + ch * 8 + 4) : zero;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int ch = ch0 + u * kStep;
        if (ch >= nch) break;
        const float z[8] = {x[u][0].x + y[u][0].x, x[u][0].y + y[u][0].y,
                            x[u][0].z + y[u][0].z, x[u][0].w + y[u][0].w,
                            x[u][1].x + y[u][1].x, x[u][1].y + y[u][1].y,
                            x[u][1].z + y[u][1].z, x[u][1].w + y[u][1].w};
        uint32_t bits = 0;
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          bits |= (z[v] > 0.0f ? 1u : 0u) << v;
          if (ch < nchm) msg[(ch * 8 + v) * kLdt + s] = act(z[v], slope);
        }
        zbits[ch * kSlots + s] = (uint8_t)bits;
      }
    }
  }

  // 2. pre2 = msgs.W2 in registers
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  {
    const float* mrow = msg + slot0;
    const float* wcol = ring + 64 * cb + 4 * cg;
    int ht = rot;  // step t's h tile
    for (int t = 0; t < npre; ++t) {
      const int hn = ht + 1 == nhp ? 0 : ht + 1;
      cp_async_wait<0>();
      __syncthreads();  // tile t landed; every warp is done with tile t - 1
      if (t + 1 < npre) pre_load((t + 1) & 1, hn);
      cp_async_commit();
      const bool mine = half == 0 ? t < nhp : t >= off;  // this half's steps
      if (wact && mine)
        pre_step(acc, mrow + ht * kPreR * kLdt, wcol + (t & 1) * kRing);
      ht = hn;
    }
  }
  __syncthreads();  // every warp is done with the messages and the ring
  gz_load(0, 0, rotz);  // g_z's first tile, during the routing
  cp_async_commit();
  {  // pre2 + b2 where the messages were, transposed
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 64 * cb + (j / 4) * 32 + 4 * cg + j % 4;
      const float bias = c < H2 ? b2[c] : 0.f;
      st4(gmt + c * kLdt + slot0,
          make_float4(acc[0][j] + bias, acc[1][j] + bias, acc[2][j] + bias,
                      acc[3][j] + bias));
      st4(gmt + c * kLdt + slot0 + 16,
          make_float4(acc[4][j] + bias, acc[5][j] + bias, acc[6][j] + bias,
                      acc[7][j] + bias));
    }
  }
  __syncthreads();

  // 3. routing: a thread a column of one half, nodes in order, their
  // output gradient loaded 8 nodes at a time; gm replaces pre2.  Where k
  // is a multiple of 4 a node's rows are read four at a time (a warp's
  // 32 columns then hit every bank once a phase)
  {
    const int hs = tid / kPreC, c = tid % kPreC;
    float* P = gmt + c * kLdt + hs * kHalf;
    const uint8_t* ems = s_em + hs * kHalf;
    const int nb = n0 + hs * tl;  // the half's first node
    const bool quads = (k & 3) == 0;
    // the half's gm rows in memory, column c: a warp's stores of a row
    // are one 128-byte line
    float* gmo = gm_out + (e0 + hs * rows) * kPreC + c;
    float db2_acc = 0.f;
    for (int q0 = 0; q0 < tl; q0 += 8) {
      float gq[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int node = nb + q0 + u;
        gq[u] = q0 + u < tl && node < L && c < H2
                    ? g[((size_t)ev * L + node) * H2 + c]
                    : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int q = q0 + u;
        if (q >= tl) break;
        Route st{0.f, 0.f, -1};
        const int r0 = q * k;
        if (quads) {
          for (int kk = 0; kk < k; kk += 4) {
            const int r = r0 + kk;
            const float4 v = ld4(P + r);
            float4 o;
            o.x = route_row(st, v.x, ems[r], r, gq[u], slope, aggr_max,
                            db2_acc);
            o.y = route_row(st, v.y, ems[r + 1], r + 1, gq[u], slope, aggr_max,
                            db2_acc);
            o.z = route_row(st, v.z, ems[r + 2], r + 2, gq[u], slope, aggr_max,
                            db2_acc);
            o.w = route_row(st, v.w, ems[r + 3], r + 3, gq[u], slope, aggr_max,
                            db2_acc);
            st4(P + r, o);
            if (!aggr_max) {  // the gm rows of valid edges (max: below)
              const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (ems[r + j]) gmo[(r + j) * kPreC] = ov[j];
            }
          }
        } else {
          for (int kk = 0; kk < k; ++kk) {
            const int r = r0 + kk;
            P[r] = route_row(st, P[r], ems[r], r, gq[u], slope, aggr_max,
                             db2_acc);
            if (!aggr_max && ems[r]) gmo[r * kPreC] = P[r];
          }
        }
        if (aggr_max) {
          const float gf = st.first >= 0 ? gq[u] * st.best_gate : 0.f;
          if (st.first >= 0) {
            P[st.first] = gf;
            db2_acc += gf;
          }
          for (int kk = 0; kk < k; ++kk) {
            const int r = r0 + kk;
            if (ems[r]) gmo[r * kPreC] = r == st.first ? gf : 0.f;
          }
        }
      }
    }
    for (int r = rows; r < kHalf; ++r) P[r] = 0.f;
    stage[hs * kPreC + c] = db2_acc;
  }
  __syncthreads();
  if (tid < H2) db2_part[bid * H2 + tid] = stage[tid] + stage[kPreC + tid];

  // 4. g_z = (gm.W2^T) * act'(z), kGzN columns a pass, then da
  float acz[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) acz[i][u] = 0.f;
  const float* grow = gmt + slotz;
  const float* zcol = ring + 32 * cbz + 4 * cg;
  int kt = 0, pp = rotz;  // step t: k tile kt of pass pp
  for (int t = 0; t < ngz; ++t) {
    const bool last = kt + 1 == nk;  // the pass's last tile
    const int kn = last ? 0 : kt + 1;
    const int pn = last ? (pp + 1 == npass ? 0 : pp + 1) : pp;
    cp_async_wait<0>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + 1 < ngz) gz_load((t + 1) & 1, kn, pn);
    cp_async_commit();
    const int p0 = pp * kGzN;  // the pass's first column
    if (wactz && p0 + 32 * cbz < H1)
      gz_step(acz, grow + kt * kGzR * kLdt, zcol + (t & 1) * kRing);
    kt = kn;
    const int pdone = pp;
    pp = pn;
    if (!last) continue;
    const int h = pdone * kGzN + 32 * cbz + 4 * cg;
    const bool hin = h < H1;  // H1 % 4 == 0: all four columns or none
    // gate by z in registers; the g_z rows of valid edges
    float4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = slot_of(i);
      const bool ok = hin && s_em[s];
      const uint32_t bits = ok ? zbits[(h / 8) * kSlots + s] >> (h % 8) : 0u;
      float o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        o[u] = ok ? acz[i][u] * ((bits >> u) & 1u ? 1.0f : slope) : 0.f;
        acz[i][u] = 0.f;
      }
      v[i] = make_float4(o[0], o[1], o[2], o[3]);
      if (ok) st4(gz_out + edge_of(s) * H1 + h, v[i]);
    }
    // da: each node's rows summed in order, kStageC columns a round
    // through the staging (column blocks 2 r and 2 r + 1 in round r)
    for (int r = 0; r < kGzN / kStageC; ++r) {
      const int x0 = pdone * kGzN + r * kStageC;  // the round's first column
      if (x0 >= H1) break;
      if (cbz / 2 == r) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          st4(stage + slot_of(i) * kLds + (cbz % 2) * 32 + 4 * cg, v[i]);
      }
      __syncthreads();
      constexpr int kQ = kStageC / 4;  // four columns an item
      for (int it = tid; it < 2 * tl * kQ; it += kThreads) {
        const int q = it / kQ, x = (it % kQ) * 4, hs = q / tl;
        const int node = n0 + q;
        if (node >= L || x0 + x >= H1) continue;
        const float* src = stage + (hs * kHalf + (q % tl) * k) * kLds + x;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int kk = 0; kk < k; ++kk) sum = add4(sum, ld4(src + kk * kLds));
        st4(da + ((size_t)ev * L + node) * H1 + x0 + x, sum);
      }
      __syncthreads();  // the staging is read before the next round
    }
  }
}

// ---- dW2
constexpr int kDwH = 128;        // dW2 tile rows (h)
constexpr int kDwC = 256;        // dW2 tile columns (c)
constexpr int kDwStage = 32;     // edges a stage
constexpr int kDwChunk = 1024;   // at most this many edge rows a slice
constexpr int kDwThreads = 512;
constexpr int kDwLdh = kDwH + 4, kDwLdc = kDwC + 4;
constexpr int kDwA = kDwStage * kDwLdh;  // floats of a stage's a or b rows
constexpr int kDwBuf = 2 * kDwA + kDwStage * kDwLdc;  // floats of a stage
constexpr int kDwStages = 3;  // stages in flight

// Shared memory of dw2: three stages of the a, b and gm rows, and the
// slice's valid edges (their edge row and node row from the slice's
// first, as uint16, and their neighbour's row in b).
constexpr size_t dw2_smem() {
  return (size_t)kDwStages * kDwBuf * 4 + (size_t)kDwChunk * (2 + 2 + 4);
}

// Partial dW2 of tile (h0 = 128 blockIdx.x, c0 = 256 blockIdx.y) over
// slice blockIdx.z: edge rows [z chunk, (z + 1) chunk) of the [E] edges
// (a's rows are the nodes', e / k).  gm: [E][H2p].  used[z]: whether the
// slice holds a valid edge (its partial is written only then).
__global__ void __launch_bounds__(kDwThreads, 1)
    dw2(const float* __restrict__ a, const float* __restrict__ b,
        const int32_t* __restrict__ idx, const uint8_t* __restrict__ em,
        const float* __restrict__ gm, float* __restrict__ part,
        int* __restrict__ used, int E, int chunk, int L, int H1, int H2,
        int H2p, int k, float slope) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // [3][a, b, gm]
  uint16_t* s_e = reinterpret_cast<uint16_t*>(ring + kDwStages * kDwBuf);
  uint16_t* s_a = s_e + kDwChunk;
  int* s_b = reinterpret_cast<int*>(s_a + kDwChunk);
  __shared__ int s_count[kDwThreads / 32 + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h0 = blockIdx.x * kDwH, c0 = blockIdx.y * kDwC;
  const int eb = blockIdx.z * chunk;
  const int ee = min(E, eb + chunk);
  const int ab = eb / k;  // the slice's first node row
  // the slice's valid edges, in order: each thread takes 2 rows, then a
  // scan of the counts
  int nv;
  {
    constexpr int kPerT = kDwChunk / kDwThreads;
    int bo[kPerT], cnt = 0;
#pragma unroll
    for (int u = 0; u < kPerT; ++u) {
      const int e = eb + tid * kPerT + u;
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
    if (tid == 0) {
      int run = 0;
      for (int w = 0; w < kDwThreads / 32; ++w) {
        const int x = s_count[w];
        s_count[w] = run;
        run += x;
      }
      s_count[kDwThreads / 32] = run;
    }
    __syncthreads();
    int at = s_count[warp] + incl - cnt;
#pragma unroll
    for (int u = 0; u < kPerT; ++u) {
      if (bo[u] >= 0) {
        const int e = eb + tid * kPerT + u;
        s_e[at] = (uint16_t)(e - eb);
        s_a[at] = (uint16_t)(e / k - ab);
        s_b[at] = bo[u];
        ++at;
      }
    }
    nv = s_count[kDwThreads / 32];
    __syncthreads();
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) used[blockIdx.z] = nv > 0;
  if (nv == 0) return;
  // a thread copies rows cr and cr + 16 (a, b: columns ch .. ch + 3) and
  // rows cr + 16 u (gm, u < 2: columns cc .. cc + 3, cc + 128 ..) of
  // each stage
  const int cr = tid >> 5, ch = (tid & 31) * 4;
  const bool hin = h0 + ch < H1;  // H1 % 4 == 0
  const bool cin0 = c0 + ch < H2p, cin1 = c0 + 128 + ch < H2p;
  const float* abase = a + (size_t)ab * H1 + h0 + ch;
  const float* bbase = b + h0 + ch;
  const float* gbase = gm + (size_t)eb * H2p + c0 + ch;
  auto issue = [&](int s, int v0) {
    float* dst = ring + s * kDwBuf;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = cr + 16 * u, v = v0 + r;
      const bool row = v < nv;
      const int vv = row ? v : 0;
      copy16(dst + r * kDwLdh + ch, abase + (size_t)s_a[vv] * H1, a,
             row && hin);
      copy16(dst + kDwA + r * kDwLdh + ch, bbase + (size_t)s_b[vv] * H1, b,
             row && hin);
      const float* gr = gbase + (size_t)s_e[vv] * H2p;
      float* gd = dst + 2 * kDwA + r * kDwLdc + ch;
      copy16(gd, gr, gm, row && cin0);
      copy16(gd + 128, gr + 128, gm, row && cin1);
    }
  };
  const int nst = (nv + kDwStage - 1) / kDwStage;
  // 8 x 8 outputs a thread: rows (h) 4 ty + i and 64 + 4 ty + i, columns
  // (c) 4 tx + j and 128 + 4 tx + j; a warp holds 8 ty by 4 tx, so each
  // of its operand reads is a single wavefront
  const int ty = (warp / 8) * 8 + lane / 4, tx = (warp % 8) * 4 + lane % 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // msgs = act(a + b) in place of stage s's a rows, by the thread that
  // copied them, once its copies have landed
  auto build = [&](int s) {
    float* ms = ring + s * kDwBuf + cr * kDwLdh + ch;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float* m = ms + 16 * u * kDwLdh;
      const float4 x = ld4(m), y = ld4(m + kDwA);
      st4(m, make_float4(act(x.x + y.x, slope), act(x.y + y.y, slope),
                         act(x.z + y.z, slope), act(x.w + y.w, slope)));
    }
  };
  for (int st = 0; st < kDwStages - 1; ++st) {
    if (st < nst) issue(st, st * kDwStage);
    cp_async_commit();
  }
  cp_async_wait<kDwStages - 2>();
  build(0);
  for (int st = 0; st < nst; ++st) {
    __syncthreads();  // stage st is built; every warp is done with st - 1
    const int sn = st + kDwStages - 1;
    if (sn < nst) issue(sn % kDwStages, sn * kDwStage);
    cp_async_commit();
    const float* ms = ring + (st % kDwStages) * kDwBuf;
    const float* gs = ms + 2 * kDwA;
    const float* mp = ms + ty * 4;
    const float* gp = gs + tx * 4;
    float4 a0 = ld4(mp), a1 = ld4(mp + 64), b0 = ld4(gp), b1 = ld4(gp + 128);
#pragma unroll 8
    for (int q = 0; q < kDwStage; ++q) {
      float4 na0 = a0, na1 = a1, nb0 = b0, nb1 = b1;
      if (q + 1 < kDwStage) {
        na0 = ld4(mp + (q + 1) * kDwLdh);
        na1 = ld4(mp + (q + 1) * kDwLdh + 64);
        nb0 = ld4(gp + (q + 1) * kDwLdc);
        nb1 = ld4(gp + (q + 1) * kDwLdc + 128);
      }
      const float x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float y[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
      a0 = na0, a1 = na1, b0 = nb0, b1 = nb1;
    }
    if (st + 1 < nst) {
      cp_async_wait<kDwStages - 2>();
      build((st + 1) % kDwStages);
    }
  }
  float* out = part + (size_t)blockIdx.z * H1 * H2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int h = h0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = c0 + 128 * jj + tx * 4;
      if (h < H1 && c < H2)  // H2 % 4 == 0
        st4(out + (size_t)h * H2 + c,
            make_float4(acc[i][4 * jj], acc[i][4 * jj + 1], acc[i][4 * jj + 2],
                        acc[i][4 * jj + 3]));
    }
  }
}

}  // namespace ecf
