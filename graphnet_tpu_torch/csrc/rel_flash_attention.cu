// Relative-bias attention forward (DeepIce's first BlockRel), for
// Hopper.
//
// Replaces the TPU kernel graphnet_tpu/ops/rel_flash_attention.py:
// _rel_fwd_kernel.  Same contract, per (batch, head, query row), with q
// already scaled: logits q.k + qt.emb_ij + qb in fp32, where emb_ij is
// the sinusoidal embedding of 1024 * clip(signed sqrt spacetime
// interval) between pulses i and j (rel_flash_attention.cuh); a masked
// key's logit is -1e5; online softmax over key tiles of 16 with the
// running max from -1e5; p rounded to the input dtype before p.v, fp32
// for p.emb; o = acc / max(l, 1e-30) in the input dtype, oe = acc_e /
// max(l, 1e-30) and lse = m + log(max(l, 1e-30)) in fp32.  A fully
// masked row comes out as the means of v and of emb over the L keys,
// with lse = -1e5 + log(L).  Any L: the last tile runs only as far as L.
//
// What bounds it on the H100: operations.  Per (b, h, i, j) q.k and p.v
// (4*hd flops in the input dtype) and qt.emb and p.emb (4*hd flops, fp32
// by the contract), and per (b, i, j) hd/2 precise sincos: at DeepIce's
// shape (B=16, H=12, L=768, hd=32) 0.24 ms in bf16 and 0.44 ms in fp32
// at the card's peaks; at hd 64 (B_d64) 0.47 and 0.87 ms.
//
// The design is the dQ kernel's (rel_flash_attention_bwd.cu) with the
// forward's side of the contract.  A block owns 16 query rows of one
// event and a group of heads (all of them up to fwd_heads: one group at
// H = 12 in both dtypes at hd 16 and 32), and streams tiles of 16 keys.  The query side
// stays resident in shared memory: qt, Q, qb and the running O.  Per key
// tile, three phases:
//
// A. qt.emb, once per pair for the whole group, on the tensor cores: for
//    one query and 16 keys the lanes of a warp build the pair embeddings
//    into tf32 A fragments (query_emb), the query's qt rows of 8 heads
//    are the B fragments, three tf32 products (big . big, big . small,
//    small . big), which keep fp32 accuracy.  The dots go to shared
//    memory in the order of phase B's accumulator fragments (dot_slot),
//    and the split embedding to the query's buffer for phase C.
// B. A unit (head, 16 queries) a warp: S = Q.K^T (bf16 on
//    mma.sync.m16n8k16; fp32 as three tf32 products), the dots and qb
//    added in fp32, a masked key's logit -1e5 and a key past L's -inf
//    (its p exactly 0: the contract's last tile ends at L); the tile's
//    running max, corr = exp(m_old - m_new), p = exp(s - m_new), l =
//    l corr + sum p; O = O corr + P.V, m and l in registers.  p,
//    unrounded, goes back into the dots' slots and corr to shared memory
//    for phase C.  bf16: P rounded to bf16 as the A fragment of P.V on
//    mma.sync.  fp32: P.V as fp32 FMAs on the CUDA cores, each lane its
//    accumulator fragment's rows and dims, the p row gathered from the
//    lane's quad by shuffles.  That is exact for p in {0, 1}: a one-key
//    row's o is its key's v bit for bit, and the corr = 0 that follows
//    the masked tiles before the key clears O exactly.  Three tf32
//    products would read v's small part truncated to tf32, so 1 . v
//    would differ from v; the FMAs cost ~0.1 ms at the fp32 peak.
// C. oe = oe corr + p.emb per query, on the tensor cores: [heads x 16
//    keys] . [16 keys x e] as three tf32 products (slot_emb_product), p
//    from its slots as A fragments (split big + small), the embedding
//    from phase A's buffer as B fragments; each tile's sum begins at
//    zero and is added in fp32 to the query's running oe, in registers.
//
// Head dim 64 (rel_flash_attention.cuh): phase A in two halves of the
// frequencies, so that its fragments fit the 128 registers beside the
// running oe, and the phase-C buffer with each embedding value once in
// fp32, split again in phase C: 64 KB where the split pairs would take
// 128 and leave room for 4 heads in fp32 (6 in bf16).  With it a block
// holds up to 7 heads in fp32 and 10 in bf16 (fwd_heads), two groups of
// 6 at H = 12, each building the pair embeddings once.
//
// What holds it is latency (the dQ kernel's lesson): the phases' chains
// of mma.sync, shared-memory loads and sincosf between barriers.  So a
// block runs 16 warps, a query each in phases A and C and a head each in
// phase B, in 128 registers: the running O of each head waits in shared
// memory between its phase-B turns (in registers it spilled 44 bytes at
// hd 32).  A warp works on its own query in phases A and C, so phase C of
// tile t and phase A of tile t + 1 follow each other without a block
// barrier: two barriers a tile.  The K/V tile of
// t + 1 streams in by cp.async meanwhile, and the key coordinates and
// flags are double-buffered.  Rows past L are computed on zeros and not
// stored.  No atomics, every sum in a fixed order, so two runs give the
// same bits.

#include <algorithm>

#include "rel_flash_attention.cuh"

namespace relattn {
namespace {

constexpr int kFwdWarps = kTile;  // a query each in phases A and C

// most heads a block holds (a head a warp in phase B), by shared memory:
// 12 at hd 16 and 32; at hd 64 7 in fp32 and 10 in bf16
template <typename T, int HD>
__host__ __device__ constexpr int fwd_heads() {
  return HD <= 32 ? 12 : (sizeof(T) == 2 ? 10 : 7);
}

static_assert(fwd_heads<float, 32>() <= kFwdWarps &&
                  fwd_heads<__nv_bfloat16, 64>() <= kFwdWarps,
              "phase B: a unit a warp");
static_assert(4 * kTile <= 32 * kFwdWarps, "fwd_key_rows: a value a thread");

// The shared memory of a forward block of hg heads, in floats from the
// start: the resident qt rows ([head][qt_ld]), the resident Q rows
// ([head][16][q_ld] of T), the K/V tile ([k|v][head][16][pad_ld] of T),
// the dots ([head][kPairs], qt.emb then p), the running O of each head
// ([head][HD/8][4][32], a lane's accumulator fragments), the embeddings
// for phase C ([query][key][emb_ld]), the row statistics
// ([qb|corr|l][head][16]), the query coordinates ([16][4]), the key
// coordinates ([2][16][4]) and flags ([2][16]) and the frequencies.
template <typename T, int HD>
struct FwdSmem {
  static constexpr int kEl = (int)sizeof(T);
  int qt, q, kv, dots, oacc, emb, stats, xq, xk, kval, freqs, floats;
  __host__ __device__ explicit FwdSmem(int hg) {
    qt = 0;
    q = qt + hg * qt_ld<HD>();
    kv = q + hg * kTile * q_ld<HD>() * kEl / 4;
    dots = kv + 2 * hg * kTile * flash::pad_ld<T, HD>() * kEl / 4;
    oacc = dots + hg * kPairs;
    emb = oacc + hg * kTile * HD;
    stats = emb + kTile * kTile * emb_ld<HD>();
    xq = stats + 3 * hg * kTile;
    xk = xq + 4 * kTile;
    kval = xk + 2 * 4 * kTile;
    freqs = kval + 2 * kTile;
    floats = freqs + HD / 2;
  }
};

template <typename T, int HD>
size_t fwd_smem_bytes(int hg) {
  return sizeof(float) * (size_t)FwdSmem<T, HD>(hg).floats;
}

// the coordinates (x, y, z, t; past L key L - 1's) and flags (1 valid,
// 0 masked, -1 past L) of keys [t0, t0 + 16) into xk [16][4] and kval
// [16]
__device__ __forceinline__ void fwd_key_rows(float* xk, float* kval,
                                             const float* __restrict__ x0b,
                                             const uint8_t* __restrict__ mb,
                                             int XF, int L, int t0) {
  const int e = threadIdx.x;
  if (e < 4 * kTile)
    xk[e] = x0b[(size_t)min(t0 + e / 4, L - 1) * XF + e % 4];
  flash::load_key_flags(kval, mb, t0, L, kTile);
}

// Phase A for query i of the block and the tile's 16 keys (coordinates
// xks): qt.emb of every head into the dots at dot_slot, and the
// embedding into embq (query_emb), in emb_halves halves (the second's
// dots added to the first's).  The B fragments are the query's qt rows
// of 8 heads (dims 2cq and 2cq + 1 of a k-step in columns cq and cq + 4,
// one 8-byte load; a head past nh reads head nh - 1 and its column of D
// is dropped); the big . big products and the corrections run in two
// accumulators.
template <int HD>
__device__ __forceinline__ void fwd_phase_a(const float* __restrict__ qts,
                                            float* __restrict__ dots,
                                            float* __restrict__ embq,
                                            const float* __restrict__ fr,
                                            const float* __restrict__ xq,
                                            const float* __restrict__ xks,
                                            int i, int nh) {
  constexpr int KH = HD / 8 / emb_halves<HD>();  // tf32 k-steps a half
  constexpr int LDH = qt_ld<HD>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, cq = lane & 3;
  float args[2];
  query_args(xq, xks, args);
  const int ntiles = (nh + 7) / 8;
#pragma unroll
  for (int hf = 0; hf < emb_halves<HD>(); ++hf) {
    uint32_t ab[KH][4], as[KH][4];  // A fragments (keys x e)
    query_emb<HD>(args, fr, embq, hf, ab, as);
#pragma unroll 1
    for (int n = 0; n < ntiles; ++n) {
      // B fragments (e x heads): head 8n + g
      const float* qr = qts + min(8 * n + g, nh - 1) * LDH + i * HD + 2 * cq;
      float eb[4] = {0.f, 0.f, 0.f, 0.f}, ec[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int l = 0; l < KH; ++l) {
        const float2 x = *reinterpret_cast<const float2*>(
            qr + 8 * emb_kstep<HD>(hf, l));
        uint32_t xb0, xs0, xb1, xs1;
        tf32_split(x.x, xb0, xs0);
        tf32_split(x.y, xb1, xs1);
        hopper::mma_tf32(ec, as[l], xb0, xb1);
        hopper::mma_tf32(ec, ab[l], xs0, xs1);
        hopper::mma_tf32(eb, ab[l], xb0, xb1);
      }
      // element e: key g + 8 (e >> 1), head 8n + 2cq + (e & 1)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = 8 * n + 2 * cq + (e & 1);
        if (h < nh) {
          float* d = dots + dot_slot(h, i, g + 8 * (e >> 1));
          *d = hf == 0 ? eb[e] + ec[e] : *d + (eb[e] + ec[e]);
        }
      }
    }
  }
}

// Phase C for query i of the block: its running oe (rows: heads g and
// g + 8, columns: dims 8nt + 2cq and + 1) = oe corr + p . emb over the
// tile's 16 keys (slot_emb_product), corr from phase B ([head][16]).
template <int HD>
__device__ __forceinline__ void fwd_phase_c(const float* __restrict__ p_s,
                                            const float* __restrict__ embq,
                                            const float* __restrict__ corr,
                                            float (&oe)[HD / 8][4], int i,
                                            int nh) {
  constexpr int NT = HD / 8;
  const int g = (threadIdx.x & 31) >> 2;
  float acc[NT][4];
  slot_emb_product<HD>(p_s, embq, acc, i, nh);
  const float c[2] = {corr[min(g, nh - 1) * kTile + i],
                      corr[min(g + 8, nh - 1) * kTile + i]};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      oe[nt][e] = oe[nt][e] * c[e >> 1] + acc[nt][e];
}

// Phase B's row state of a warp's unit (head w, queries g and g + 8 of
// lane (g, cq)): the running max m and sum l.
struct FwdRows {
  float m[2], l[2];
};

// The online softmax of a unit's tile, shared by both dtypes: st holds S
// (element e of n-tile n: query g + 8 (e >> 1), key 8n + 2cq + (e & 1),
// the accumulator fragments of m16n8k16 and m16n8k8 alike).  The logits
// (S + dots + qb; -1e5 for a masked key, -inf past L), the rows' running
// max and sum updated, st set to p (unrounded), p into the dots' slots,
// corr into corr_s (lane cq = 0) and returned.  qb_s: [head][16].
__device__ __forceinline__ void fwd_softmax(float (&st)[2][4],
                                            float* __restrict__ dots,
                                            const float* __restrict__ qb_s,
                                            float* __restrict__ corr_s,
                                            const float* __restrict__ kval,
                                            int h, FwdRows& rs,
                                            float (&corr)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, cq = lane & 3;
  const float qb[2] = {qb_s[h * kTile + g], qb_s[h * kTile + g + 8]};
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, j = 8 * n + 2 * cq + (e & 1);
      const float f = kval[j];
      const float s = (st[n][e] + dots[dot_slot(h, g + 8 * r, j)]) + qb[r];
      st[n][e] = f > 0.f ? s : (f == 0.f ? kNeg : -INFINITY);
      mx[r] = fmaxf(mx[r], st[n][e]);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(rs.m[r], mx[r]);
    corr[r] = expf(rs.m[r] - m_new);
    rs.m[r] = m_new;
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, j = 8 * n + 2 * cq + (e & 1);
      const float p = expf(st[n][e] - rs.m[r]);
      st[n][e] = p;
      dots[dot_slot(h, g + 8 * r, j)] = p;
      sum[r] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    rs.l[r] = rs.l[r] * corr[r] + sum[r];
    if (cq == 0) corr_s[h * kTile + g + 8 * r] = corr[r];
  }
}

// S = Q.K^T of a unit, qh its 16 Q rows (stride q_ld), ks its 16 K rows
// (stride pad_ld).  bf16: Q (A fragments, rows: queries) and K by
// ldmatrix, mma.sync.m16n8k16.
template <int HD>
__device__ __forceinline__ void fwd_qk(float (&st)[2][4],
                                       const __nv_bfloat16* __restrict__ qh,
                                       const __nv_bfloat16* __restrict__ ks) {
  constexpr int LD = q_ld<HD>(), LK = flash::pad_ld<__nv_bfloat16, HD>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int at = ((lane & 7) + (lane >> 4) * 8) * LK + kk * 16 +
                   ((lane >> 3) & 1) * 8;
    const int aq = (lane & 15) * LD + kk * 16 + (lane >> 4) * 8;
    uint32_t a[4], bk[4];
    flash::ldmatrix_x4(a, qh + aq);
    flash::ldmatrix_x4(bk, ks + at);
    flash::mma_bf16(st[0], a, bk[0], bk[1]);
    flash::mma_bf16(st[1], a, bk[2], bk[3]);
  }
}

// fp32: three tf32 products (tf32x3_products)
template <int HD>
__device__ __forceinline__ void fwd_qk(float (&st)[2][4],
                                       const float* __restrict__ qh,
                                       const float* __restrict__ ks) {
  constexpr int LD = q_ld<HD>();
  const int lane = threadIdx.x & 31;
  tf32x3_products<HD, LD, flash::pad_ld<float, HD>()>(
      st, qh + (lane >> 2) * LD + 2 * (lane & 3), ks);
}

// O (accumulator fragments: dims 8d + 2cq and + 1 of queries g, g + 8)
// += P.V over the tile's 16 keys, P in st, vs the 16 V rows (stride
// pad_ld).  bf16: P rounded to bf16 and repacked from S's accumulators
// as the A fragment, V by ldmatrix.trans, mma.sync.m16n8k16.
template <int HD>
__device__ __forceinline__ void fwd_pv(float (&O)[HD / 8][4],
                                       const float (&st)[2][4],
                                       const __nv_bfloat16* __restrict__ vs) {
  constexpr int LK = flash::pad_ld<__nv_bfloat16, HD>();
  const int lane = threadIdx.x & 31;
  uint32_t pa[4];
  flash::pack_a(pa, st[0], st[1]);
#pragma unroll
  for (int np = 0; np < HD / 16; ++np) {
    const int at = ((lane & 7) + ((lane >> 3) & 1) * 8) * LK + np * 16 +
                   (lane >> 4) * 8;
    uint32_t bt[4];
    flash::ldmatrix_x4_trans(bt, vs + at);
    flash::mma_bf16(O[2 * np], pa, bt[0], bt[1]);
    flash::mma_bf16(O[2 * np + 1], pa, bt[2], bt[3]);
  }
}

// fp32: FMAs, key by key, in full fp32; p of the lane's rows from the
// lane of its quad that holds it
template <int HD>
__device__ __forceinline__ void fwd_pv(float (&O)[HD / 8][4],
                                       const float (&st)[2][4],
                                       const float* __restrict__ vs) {
  constexpr int LK = flash::pad_ld<float, HD>();
  const int lane = threadIdx.x & 31, g = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    // p of (query g + 8r, key j): element 2r + (j & 1) of n-tile j >> 3
    // in lane 4g + ((j & 7) >> 1)
    const int src = 4 * g + ((j & 7) >> 1);
    const float p0 = __shfl_sync(0xffffffffu, st[j >> 3][j & 1], src);
    const float p1 = __shfl_sync(0xffffffffu, st[j >> 3][2 + (j & 1)], src);
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const float2 x =
          *reinterpret_cast<const float2*>(vs + j * LK + 8 * d + 2 * cq);
      O[d][0] = fmaf(p0, x.x, O[d][0]);
      O[d][1] = fmaf(p0, x.y, O[d][1]);
      O[d][2] = fmaf(p1, x.x, O[d][2]);
      O[d][3] = fmaf(p1, x.y, O[d][3]);
    }
  }
}

// Phase B of warp w, the unit (head w, the block's 16 queries) if w < nh:
// S, the softmax, and O = O corr + P.V, the running O read from and put
// back into oacc ([head][HD/8][4][32]: element e of a lane's d-th
// fragment at [(4d + e) * 32]).
template <typename T, int HD>
__device__ __forceinline__ void fwd_phase_b(
    const T* __restrict__ kvs, const T* __restrict__ qs,
    float* __restrict__ dots, float* __restrict__ oacc,
    const float* __restrict__ qb_s, float* __restrict__ corr_s,
    const float* __restrict__ kval, FwdRows& rs, int nh, int hg) {
  constexpr int LK = flash::pad_ld<T, HD>();
  const int h = threadIdx.x >> 5;
  if (h >= nh) return;
  float st[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[n][e] = 0.f;
  fwd_qk<HD>(st, qs + h * kTile * q_ld<HD>(), kvs + h * kTile * LK);
  float corr[2];
  fwd_softmax(st, dots, qb_s, corr_s, kval, h, rs, corr);
  float* oa = oacc + h * kTile * HD + (threadIdx.x & 31);
  float O[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[d][e] = oa[(4 * d + e) * 32] * corr[e >> 1];
  fwd_pv<HD>(O, st, kvs + (hg + h) * kTile * LK);
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oa[(4 * d + e) * 32] = O[d][e];
}

// dims 2c and 2c + 1 of a row of o
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = flash::pack_bf16(a, b);
}

// The epilogue of warp w's unit (if w < nh): o = O / max(l, 1e-30) in
// the input dtype, lse = m + log(max(l, 1e-30)); l into l_s for the oe
// of phase C's warps.
template <typename T, int HD>
__device__ __forceinline__ void fwd_store_o(T* __restrict__ o,
                                            float* __restrict__ lse,
                                            const float* __restrict__ oacc,
                                            float* __restrict__ l_s,
                                            const FwdRows& rs, size_t bh0,
                                            int nh, int L, int row0) {
  const int lane = threadIdx.x & 31, h = threadIdx.x >> 5;
  const int g = lane >> 2, cq = lane & 3;
  if (h >= nh) return;
  const float* oa = oacc + h * kTile * HD + lane;
  const size_t bh = bh0 + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (cq == 0) l_s[h * kTile + g + 8 * r] = rs.l[r];
    if (row >= L) continue;
    const float ls = fmaxf(rs.l[r], 1e-30f);
    if (cq == 0) lse[bh * L + row] = rs.m[r] + logf(ls);
    T* out = o + (bh * L + row) * HD + 2 * cq;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      put2(out + 8 * d, oa[(4 * d + 2 * r) * 32] / ls,
           oa[(4 * d + 2 * r + 1) * 32] / ls);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(32 * kFwdWarps, 1)
    rel_fwd_kernel(const T* __restrict__ q, const float* __restrict__ qt,
                   const float* __restrict__ qb, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ x0,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ freqs, int H, int L, int XF,
                   int hg, T* __restrict__ o, float* __restrict__ oe,
                   float* __restrict__ lse) {
  constexpr int E = HD, LDH = qt_ld<HD>(), EQ = kTile * emb_ld<HD>();
  extern __shared__ __align__(16) float smem[];
  const FwdSmem<T, HD> sm(hg);
  float* qts = smem + sm.qt;
  T* qs = reinterpret_cast<T*>(smem + sm.q);
  T* kvs = reinterpret_cast<T*>(smem + sm.kv);
  float* dots = smem + sm.dots;
  float* oacc = smem + sm.oacc;
  float* embs = smem + sm.emb;
  float* qb_s = smem + sm.stats;
  float* corr_s = qb_s + hg * kTile;
  float* l_s = corr_s + hg * kTile;
  float* xqs = smem + sm.xq;
  float* xks = smem + sm.xk;
  float* kvals = smem + sm.kval;
  float* fr = smem + sm.freqs;

  // warp w: query w in phases A and C, head w in phase B
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int b = blockIdx.z, h0 = blockIdx.y * hg;
  const int nh = min(hg, H - h0);
  const int row0 = blockIdx.x * kTile;
  const size_t bh0 = (size_t)b * H + h0;
  const float* x0b = x0 + (size_t)b * L * XF;
  const uint8_t* mb = mask + (size_t)b * L;
  const T* kg = k + bh0 * L * HD;
  const T* vg = v + bh0 * L * HD;
  const int nt = (L + kTile - 1) / kTile;

  // the resident qt and Q rows (zeros past L), the first K/V tile
  {
    constexpr int C4 = HD / 4;  // 16-byte chunks a row
    for (int c = threadIdx.x; c < nh * kTile * C4; c += blockDim.x) {
      const int hh = c / (kTile * C4), r = (c / C4) % kTile;
      const int e = (c % C4) * 4;
      const bool in = row0 + r < L;
      flash::cp_async16(qts + hh * LDH + r * HD + e,
                        qt + ((bh0 + hh) * L + (in ? row0 + r : 0)) * HD + e,
                        in ? 16 : 0);
    }
  }
  load_rows<T, HD, kTile, q_ld<HD>()>(qs, q + bh0 * L * HD, nh, L, row0);
  load_kv<T, HD>(kvs, kg, vg, nh, hg, L, 0);
  for (int f = threadIdx.x; f < HD / 2; f += blockDim.x) fr[f] = freqs[f];
  fwd_key_rows(xks, kvals, x0b, mb, XF, L, 0);
  for (int c = threadIdx.x; c < nh * kTile; c += blockDim.x) {
    const int row = row0 + c % kTile;
    qb_s[c] = row < L ? qb[(bh0 + c / kTile) * L + row] : 0.f;
  }
  for (int e = threadIdx.x; e < 4 * kTile; e += blockDim.x)
    xqs[e] = x0b[(size_t)min(row0 + e / 4, L - 1) * XF + e % 4];
  for (int e = threadIdx.x; e < hg * kTile * HD; e += blockDim.x)
    oacc[e] = 0.f;
  float oea[E / 8][4];  // query w's running oe
#pragma unroll
  for (int n = 0; n < E / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oea[n][e] = 0.f;
  flash::cp_async_wait_all();
  __syncthreads();
  FwdRows rs = {{kNeg, kNeg}, {0.f, 0.f}};
  fwd_phase_a<HD>(qts, dots, embs + w * EQ, fr, xqs + 4 * w, xks, w, nh);

  for (int t = 0; t < nt; ++t) {
    const int nb = (t + 1) & 1;  // the buffer of tile t + 1's key rows
    const bool next = t + 1 < nt;
    if (next)
      fwd_key_rows(xks + nb * 4 * kTile, kvals + nb * kTile, x0b, mb, XF, L,
                   (t + 1) * kTile);
    flash::cp_async_wait_all();  // this tile's K/V
    __syncthreads();             // and phase A's dots and embeddings
    fwd_phase_b<T, HD>(kvs, qs, dots, oacc, qb_s, corr_s,
                       kvals + (t & 1) * kTile, rs, nh, hg);
    __syncthreads();  // p in the dots' slots, corr; the K/V tile is free
    if (next) load_kv<T, HD>(kvs, kg, vg, nh, hg, L, (t + 1) * kTile);
    float* embq = embs + w * EQ;
    fwd_phase_c<HD>(dots, embq, corr_s, oea, w, nh);
    if (next) {
      __syncwarp();  // phase C's reads of this query's slots and buffer
      fwd_phase_a<HD>(qts, dots, embq, fr, xqs + 4 * w,
                      xks + nb * 4 * kTile, w, nh);
    }
  }

  fwd_store_o<T, HD>(o, lse, oacc, l_s, rs, bh0, nh, L, row0);
  __syncthreads();  // l
  const int row = row0 + w;
  if (row >= L) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int h = g + 8 * r;
    if (h >= nh) continue;
    const float ls = fmaxf(l_s[h * kTile + w], 1e-30f);
    float* out = oe + ((bh0 + h) * L + row) * HD + 2 * cq;
#pragma unroll
    for (int n = 0; n < E / 8; ++n)
      put2(out + 8 * n, oea[n][2 * r] / ls, oea[n][2 * r + 1] / ls);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* qt, const void* qb,
                   const void* k, const void* v, const void* x0,
                   const void* mask, const void* freqs, int B, int H, int L,
                   int XF, void* o, void* oe, void* lse,
                   cudaStream_t stream) {
  if (!flash::aligned16(q, qt, k, v)) return cudaErrorMisalignedAddress;
  int groups, hg;
  head_groups(H, fwd_heads<T, HD>(), &groups, &hg);
  const size_t bytes = fwd_smem_bytes<T, HD>(hg);
  auto kern = rel_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kTile - 1) / kTile, groups, B);
  kern<<<grid, 32 * kFwdWarps, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const float*>(qt),
      static_cast<const float*>(qb), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(x0),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(freqs), H,
      L, XF, hg, static_cast<T*>(o), static_cast<float*>(oe),
      static_cast<float*>(lse));
  return cudaGetLastError();
}

}  // namespace
}  // namespace relattn

// q, k, v, o: [B, H, L, HD] of float (bf16 = 0) or bfloat16 (bf16 = 1);
// qt, oe: [B, H, L, HD] float; qb, lse: [B, H, L] float; x0: [B, L, XF]
// float (XF >= 4: x, y, z, t first); mask: [B, L] uint8; freqs: [HD / 2]
// float.  q, qt, k and v 16-byte aligned.  Returns a cudaError_t.
extern "C" int rel_fwd_launch(const void* q, const void* qt, const void* qb,
                              const void* k, const void* v, const void* x0,
                              const void* mask, const void* freqs, int B,
                              int H, int L, int HD, int XF, int bf16,
                              void* o, void* oe, void* lse, void* stream) {
  using relattn::launch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || L == 0 || H == 0) return 0;
  if (H < 0 || XF < 4) return (int)cudaErrorInvalidValue;
#define FWD(T, D) \
  launch<T, D>(q, qt, qb, k, v, x0, mask, freqs, B, H, L, XF, o, oe, lse, s)
  if (HD == 16 && !bf16) return (int)FWD(float, 16);
  if (HD == 32 && !bf16) return (int)FWD(float, 32);
  if (HD == 64 && !bf16) return (int)FWD(float, 64);
  if (HD == 16 && bf16) return (int)FWD(__nv_bfloat16, 16);
  if (HD == 32 && bf16) return (int)FWD(__nv_bfloat16, 32);
  if (HD == 64 && bf16) return (int)FWD(__nv_bfloat16, 64);
#undef FWD
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory of a launch over H heads at head dim HD (0
// for a head dim the kernel is not built for): the larger of a bf16 and
// a fp32 launch's.
extern "C" int rel_fwd_smem_bytes(int HD, int H) {
  int groups, hb, hf;
#define SMEM(D)                                                            \
  (relattn::head_groups(H, relattn::fwd_heads<__nv_bfloat16, D>(), &groups, \
                        &hb),                                              \
   relattn::head_groups(H, relattn::fwd_heads<float, D>(), &groups, &hf),   \
   (int)std::max(relattn::fwd_smem_bytes<__nv_bfloat16, D>(hb),            \
                 relattn::fwd_smem_bytes<float, D>(hf)))
  if (HD == 16) return SMEM(16);
  if (HD == 32) return SMEM(32);
  if (HD == 64) return SMEM(64);
#undef SMEM
  return 0;
}
