// Pieces shared by the relative-bias attention kernels
// (rel_flash_attention.cu, rel_flash_attention_bwd.cu): the pair
// argument of DeepIce's SpacetimeEncoder; the pair embedding built in
// registers straight into tf32 mma fragments, and the split of an fp32
// value into two tf32 parts, with which every kernel forms its
// embedding dots as three tf32 products at fp32 accuracy; the row
// staging of the query and key tiles; and the layouts of a block that
// owns 16 query rows and streams 16-key tiles (the forward and the dQ
// kernel): the place of each pair's dot in shared memory, read and
// written in three orders, and the per-query buffer that hands phase
// A's split embedding to phase C transposed.
//
// Head dim 64.  Phase A's fragments of all HD / 8 k-steps take HD
// registers, all 64 at hd 64, half of what a thread of a 16-warp block
// has; so at hd 64 every phase A builds and consumes them in two halves
// of the frequencies (each half the sin and the cos k-steps of HD / 4
// frequencies, 32 registers), the second half's dots added to the
// first's in fp32.  And the per-query buffer that hands the embedding to
// phase C holds each value once, in fp32 (64 KB for a block's 16
// queries, where the split pairs would take 128 of the 227 a block may
// have), split again where phase C reads it: the same two parts, since
// big + small is the value exactly.  Building the embedding again in
// phase C instead would double the sincos.  Hd 16 and 32 keep one half
// and the split buffer.

#pragma once

#include "flash_mma.cuh"

namespace relattn {

using flash::kNeg;

constexpr int kTile = 16;  // keys per streamed tile (KEY_TILE of the
                           // plain version), and the query rows of a
                           // forward or dQ block
constexpr int kPairs = kTile * kTile;  // dots a head a (16 x 16) block

// light speed in the scaled detector units, the interval's clip, the
// argument's scale (the SpacetimeEncoder's constants)
constexpr float kC = 18.0f;
constexpr float kClip = 4.0f;
constexpr float kArgScale = 1024.0f;

// 1024 * clip(signed sqrt of the spacetime interval, -4, 4) between
// pulse a (the query) and pulse c (the key), [>=4] coordinates each.
// Every operation is rounded on its own, in the plain version's order
// (no FMA contraction): the argument reaches 4096 rad, where one ulp is
// 4.9e-4, and the sqrt amplifies an error of the interval near 0.
__device__ __forceinline__ float pair_arg(const float* __restrict__ a,
                                          const float* __restrict__ c) {
  const float dx = __fsub_rn(a[0], c[0]);
  const float dy = __fsub_rn(a[1], c[1]);
  const float dz = __fsub_rn(a[2], c[2]);
  const float dt = __fmul_rn(__fsub_rn(a[3], c[3]), kC);
  float s = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  s = __fadd_rn(s, __fmul_rn(dz, dz));
  s = __fsub_rn(s, __fmul_rn(dt, dt));
  const float r = sqrtf(fabsf(s));  // IEEE-rounded (no fast math)
  const float d = s > 0.f ? r : (s < 0.f ? -r : 0.f);
  return __fmul_rn(kArgScale, fminf(fmaxf(d, -kClip), kClip));
}

// heads per block: the head groups of a launch over H heads, at most cap
// heads a group, and the heads of each (the last group may hold fewer)
inline void head_groups(int H, int cap, int* groups, int* hg) {
  *groups = (H + cap - 1) / cap;
  *hg = (H + *groups - 1) / *groups;
}

// floats per head of a staged qt or doe tile: 16 rows and 8 of pad, so
// that the 8-byte B-fragment loads of 8 heads fall in distinct banks
template <int HD>
__host__ __device__ constexpr int qt_ld() {
  return kTile * HD + 8;
}

// elements of a resident Q or dO row of a forward or dQ block: HD and 8
// of pad, so that ldmatrix (bf16) and the 8-byte fragment loads (fp32)
// are free of bank conflicts
template <int HD>
__host__ __device__ constexpr int q_ld() {
  return HD + 8;
}

// rows [row0, row0 + ROWS) of nh heads of one event ([head][L][HD] of T
// from src) into dst ([head][ROWS][LD]); rows at or past L as zeros
template <typename T, int HD, int ROWS, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          int nh, int L, int row0) {
  constexpr int kPer = 16 / (int)sizeof(T);
  constexpr int kChunks = HD / kPer;
  for (int c = threadIdx.x; c < nh * ROWS * kChunks; c += blockDim.x) {
    const int h = c / (ROWS * kChunks), r = (c / kChunks) % ROWS;
    const int e = (c % kChunks) * kPer;
    const bool in = row0 + r < L;
    const T* g = src + ((size_t)h * L + (in ? row0 + r : 0)) * HD + e;
    flash::cp_async16(dst + (h * ROWS + r) * LD + e, g, in ? 16 : 0);
  }
}

// every thread: the K and V rows of keys [t0, t0 + 16) of nh heads
// (zeros past L) into the tile ([k|v][head][16][pad_ld] of T), one
// cp.async commit group
template <typename T, int HD>
__device__ __forceinline__ void load_kv(T* kvs, const T* __restrict__ k,
                                        const T* __restrict__ v, int nh,
                                        int hg, int L, int t0) {
  constexpr int LD = flash::pad_ld<T, HD>();
  load_rows<T, HD, kTile, LD>(kvs, k, nh, L, t0);
  load_rows<T, HD, kTile, LD>(kvs + hg * kTile * LD, v, nh, L, t0);
  flash::cp_async_commit();
}

// x as a tf32 pair, x ~ big + small: big is x rounded to tf32 (half an
// ulp added, the low 13 bits cleared; x is finite), small the exact rest,
// which the tensor core reads truncated to tf32 (|small| <= 2^-11 |x|, so
// it carries x to ~2^-22)
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// The pair embeddings of rows g and g + 8 of a block of 16 pairs (lane
// (g, cq) of a warp; args[rh] is the pair argument of row g + 8 rh)
// straight into the A fragments of the KS tf32 k-steps of a product over
// the embedding, split big + small: frequency 8kk + 2cq + s is column
// cq + 4s of k-step kk (its sin) and of k-step KS/2 + kk (its cos), so
// column cq + 4s of k-step k stands for embedding dim 8k + 2cq + s.
// Each lane builds 2 KS of the block's pairs' sincosf, no pair twice
// (pair_arg and the precise sincosf: the plain version's bits).
template <int KS>
__device__ __forceinline__ void emb_frags(const float (&args)[2],
                                          const float* __restrict__ fr,
                                          uint32_t (&ab)[KS][4],
                                          uint32_t (&as)[KS][4]) {
  const int cq = threadIdx.x & 3;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh)
#pragma unroll
    for (int kk = 0; kk < KS / 2; ++kk)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        // |x| <= 4096 (pair_arg's clip, frequencies <= 1): sincosf never
        // takes its large-argument path, and the compiler, told so,
        // interleaves the calls
        const float x = __fmul_rn(args[rh], fr[8 * kk + 2 * cq + s]);
        __builtin_assume(fabsf(x) <= 4096.f);
        float sn, cs;
        sincosf(x, &sn, &cs);
        tf32_split(sn, ab[kk][2 * s + rh], as[kk][2 * s + rh]);
        tf32_split(cs, ab[KS / 2 + kk][2 * s + rh],
                   as[KS / 2 + kk][2 * s + rh]);
      }
}

// the halves of phase A's fragments (above: 2 at hd 64, else 1)
template <int HD>
__host__ __device__ constexpr int emb_halves() {
  return HD > 32 ? 2 : 1;
}

// whether a query's phase-C buffer holds the embedding split (big and
// small of each value: hd 16, 32) or each value once in fp32 (hd 64)
template <int HD>
__host__ __device__ constexpr bool emb_split() {
  return HD <= 32;
}

// floats of one key's embedding in a query's phase-C buffer
template <int HD>
__host__ __device__ constexpr int emb_ld() {
  return emb_split<HD>() ? 2 * HD : HD;
}

// the k-step over the embedding (of HD / 8) that k-step l of half hf's
// fragments stands for: the half's sin k-steps, then their cos; the
// half's frequencies start at 4 KH hf (KH the k-steps of a half)
template <int HD>
__device__ __forceinline__ int emb_kstep(int hf, int l) {
  constexpr int KH = HD / 8 / emb_halves<HD>();
  return l < KH / 2 ? hf * (KH / 2) + l
                    : HD / 16 + hf * (KH / 2) + (l - KH / 2);
}

// The place of the dot (and then of p or ds) of (head h, query i, key j)
// of a 16 x 16 block of pairs: the order of a phase-B unit's accumulator
// fragments (lane 4 (i & 7) + ((j & 7) >> 1), element 2 (i >> 3) + (j &
// 1), key 8-tile j >> 3), the lane XOR-swizzled by h and j so that phase
// A's stores (one query, lanes over keys and heads) and phase C's loads
// (one query, lanes over heads and keys) are free of bank conflicts too.
__device__ __forceinline__ int dot_slot(int h, int i, int j) {
  const int sw = (((h >> 1) & 3) << 3) | ((j & 1) << 2) | ((h & 1) << 1);
  return ((h * 2 + (j >> 3)) * 4 + 2 * (i >> 3) + (j & 1)) * 32 +
         ((4 * (i & 7) + ((j & 7) >> 1)) ^ sw);
}

// The place of key j's embedding dims 2p and 2p + 1 (big and small of
// each, 4 floats) in a query's phase-C buffer (2E floats a key), the
// pair XOR-swizzled by the key: phase A stores 16 bytes a lane (keys g,
// g + 8, pairs 4k + cq), phase C loads 8 (keys cq, cq + 4 of a k-step,
// dim g of an n-tile), both free of bank conflicts.
template <int E>
__device__ __forceinline__ int emb_at(int j, int p) {
  return j * 2 * E + 4 * (p ^ (((j & 1) << 2) | (((j >> 1) & 1) << 1)));
}

// The place of key j's embedding dim d in a query's phase-C buffer at
// hd 64 (HD floats a key), the dim XOR-swizzled by the key: phase A
// stores 8 bytes a lane (keys g, g + 8; dims 8k + 2cq and + 1), phase C
// loads 4 (keys cq, cq + 4 of a k-step; dim 8nt + g), both free of bank
// conflicts.
template <int HD>
__device__ __forceinline__ int emb1_at(int j, int d) {
  return j * HD + (d ^ ((j & 3) << 3));
}

// The pair arguments of query xq (its coordinates) against keys g and
// g + 8 of the tile (coordinates xks, [16][4]) for lane (g, cq), whose
// own pair_arg is that of key g + 8 (cq & 1).
__device__ __forceinline__ void query_args(const float* __restrict__ xq,
                                           const float* __restrict__ xks,
                                           float (&args)[2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const float arg = pair_arg(xq, xks + 4 * (g + 8 * (lane & 1)));
  args[0] = __shfl_sync(0xffffffffu, arg, g * 4);
  args[1] = __shfl_sync(0xffffffffu, arg, g * 4 + 1);
}

// Phase A's embedding of a query against the tile's 16 keys (args from
// query_args), half hf of it (emb_halves), for a whole warp: lane (g,
// cq) builds the embeddings of keys g and g + 8 into the A fragments ab
// / as (keys x e, split big + small; k-step l stands for emb_kstep(hf,
// l)) and stores them into embq for phase C (emb_at, or emb1_at at
// hd 64).
template <int HD>
__device__ __forceinline__ void query_emb(
    const float (&args)[2], const float* __restrict__ fr,
    float* __restrict__ embq, int hf,
    uint32_t (&ab)[HD / 8 / emb_halves<HD>()][4],
    uint32_t (&as)[HD / 8 / emb_halves<HD>()][4]) {
  constexpr int KH = HD / 8 / emb_halves<HD>();  // k-steps of the half
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, cq = lane & 3;
  emb_frags<KH>(args, fr + 4 * KH * hf, ab, as);
  // for phase C: key g + 8 rh, dims 8k + 2cq and 8k + 2cq + 1
#pragma unroll
  for (int rh = 0; rh < 2; ++rh)
#pragma unroll
    for (int l = 0; l < KH; ++l) {
      const int k = emb_kstep<HD>(hf, l);
      if constexpr (emb_split<HD>()) {
        *reinterpret_cast<float4*>(embq + emb_at<HD>(g + 8 * rh, 4 * k + cq)) =
            make_float4(__uint_as_float(ab[l][rh]), __uint_as_float(as[l][rh]),
                        __uint_as_float(ab[l][2 + rh]),
                        __uint_as_float(as[l][2 + rh]));
      } else {
        *reinterpret_cast<float2*>(embq +
                                   emb1_at<HD>(g + 8 * rh, 8 * k + 2 * cq)) =
            make_float2(
                __uint_as_float(ab[l][rh]) + __uint_as_float(as[l][rh]),
                __uint_as_float(ab[l][2 + rh]) + __uint_as_float(as[l][2 + rh]));
      }
    }
}

// Phase C's product for query i of the block: acc (rows: heads g and
// g + 8, columns: dims 8nt + 2cq and + 1) = x . emb over the tile's 16
// keys, three tf32 products a step, begun at zero.  A: x (head, key)
// from its dot_slot in xs (0 for a head past nh); B: the embedding from
// phase A's buffer embq (at hd 64 each value split here).
template <int HD>
__device__ __forceinline__ void slot_emb_product(
    const float* __restrict__ xs, const float* __restrict__ embq,
    float (&acc)[HD / 8][4], int i, int nh) {
  constexpr int NT = HD / 8;  // n-tiles over the embedding
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kTile / 8; ++ks) {
    // a0 (head g, key 8ks + cq), a1 (head g + 8), a2 / a3 (key + 4)
    uint32_t ab[4], as[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int h = g + 8 * (r & 1), j = 8 * ks + cq + 4 * (r >> 1);
      const float x = xs[dot_slot(min(h, nh - 1), i, j)];
      tf32_split(h < nh ? x : 0.f, ab[r], as[r]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // b0 (key 8ks + cq, dim 8nt + g), b1 (key 8ks + cq + 4): big, small
      const int d = 8 * nt + g;
      if constexpr (emb_split<HD>()) {
        const float2 x0 = *reinterpret_cast<const float2*>(
            embq + emb_at<HD>(8 * ks + cq, d >> 1) + 2 * (d & 1));
        const float2 x1 = *reinterpret_cast<const float2*>(
            embq + emb_at<HD>(8 * ks + cq + 4, d >> 1) + 2 * (d & 1));
        const uint32_t b0 = __float_as_uint(x0.x), b1 = __float_as_uint(x1.x);
        hopper::mma_tf32(acc[nt], as, b0, b1);
        hopper::mma_tf32(acc[nt], ab, __float_as_uint(x0.y),
                         __float_as_uint(x1.y));
        hopper::mma_tf32(acc[nt], ab, b0, b1);
      } else {
        uint32_t b0, s0, b1, s1;
        tf32_split(embq[emb1_at<HD>(8 * ks + cq, d)], b0, s0);
        tf32_split(embq[emb1_at<HD>(8 * ks + cq + 4, d)], b1, s1);
        hopper::mma_tf32(acc[nt], as, b0, b1);
        hopper::mma_tf32(acc[nt], ab, s0, s1);
        hopper::mma_tf32(acc[nt], ab, b0, b1);
      }
    }
  }
}

// s (rows g, g + 8 of 16 queries; keys 8n + 2cq and + 1) += A . B^T in
// fp32 as three tf32 products a step (big . big, big . small, small .
// big, the smaller terms first): A the rows at a (this lane's row g,
// dims 2cq on; row stride LD), B the 16 key rows at b (row stride LK).
// The A fragments hold dims 8k + 2cq and + 1 in columns cq and cq + 4,
// so each is one 8-byte load.
template <int HD, int LD, int LK>
__device__ __forceinline__ void tf32x3_products(float (&s)[2][4],
                                                const float* __restrict__ a,
                                                const float* __restrict__ b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int k = 0; k < HD / 8; ++k) {
    uint32_t ab[4], as[4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 x =
          *reinterpret_cast<const float2*>(a + 8 * r * LD + 8 * k);
      tf32_split(x.x, ab[r], as[r]);
      tf32_split(x.y, ab[2 + r], as[2 + r]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      // B: dims 8k + 2cq and + 1 of key 8n + g
      const float2 x = *reinterpret_cast<const float2*>(
          b + (8 * n + g) * LK + 8 * k + 2 * cq);
      uint32_t xb0, xs0, xb1, xs1;
      tf32_split(x.x, xb0, xs0);
      tf32_split(x.y, xb1, xs1);
      hopper::mma_tf32(s[n], as, xb0, xb1);
      hopper::mma_tf32(s[n], ab, xs0, xs1);
      hopper::mma_tf32(s[n], ab, xb0, xb1);
    }
  }
}

}  // namespace relattn
