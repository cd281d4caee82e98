// Backward of the relative-bias attention (rel_flash_attention.cu), for
// Hopper: dq with dqt and dqb, and dk with dv.
//
// Replaces the TPU kernels graphnet_tpu/ops/rel_flash_attention.py:
// _rel_bwd_dq_kernel and _rel_bwd_dkv_kernel.  Same contract, the
// extended-value recompute: the pair embedding is an extension of the
// value, so with the forward's lse, p = exp(logit - lse) (logits q.k +
// qt.emb_ij + qb, a masked key at -1e5), dp = do.v + doe.emb_ij,
// ds = p * (dp - delta) * valid, delta = do.o + doe.oe from the wrapper;
// dq = sum_j ds.k (ds rounded to the input dtype), dqt = sum_j ds.emb_ij
// and dqb = sum_j ds in fp32; dk = sum_i ds.q (ds rounded), dv =
// sum_i p.do (p rounded), over every query row.  The two kernels form
// the logits with other operations in another order, so each is held to
// the plain version on its own.  Neither uses atomics; every sum runs in
// a fixed order, so two runs give the same bits.
//
// Both build each pair's embedding once for all heads of a block,
// straight into tf32 mma fragments (emb_frags), and form the embedding
// dots as three tf32 products, which keep fp32 accuracy.  See the notes
// at each kernel below.


#include <algorithm>

#include "flash_mma.cuh"
#include "rel_flash_attention.cuh"

namespace relattn {
namespace {

// ------------------------------------------------------------ dK, dV
//
// What bounds the dkv kernel on the H100: operations.  Per (b, h, i, j)
// the two embedding dots qt.emb_ij and doe.emb_ij (4*hd flops, fp32 by
// the contract) and the four products q.k, do.v, ds.q and p.do (8*hd
// flops, in the input dtype), and per (b, i, j) hd/2 precise sincos: at
// DeepIce's shape (B=16, H=12, L=768, hd=32) 0.25 ms in bf16 and 0.65
// ms in fp32 at the card's peaks; at hd 64 (B_d64) 0.50 and 1.31 ms.
//
// The design.  A block owns 32 keys of one event and a group of heads
// (all of them up to kDkvHeads: one group at H = 12 in bf16), and
// streams tiles of 16 query rows.  Per tile, two phases:
//
// A. The embedding dots, once per pair for the whole group, on the
//    tensor cores.  For one query and 16 keys the dots of every head
//    are a product [16 keys x e] . [e x heads]; a warp builds the pair
//    embeddings (pair_arg and precise sincosf, the plain version's
//    bits) straight into the A fragments of mma.m16n8k8 (each lane's
//    fragment places are 4 frequencies of 2 keys, so no pair is built
//    twice), and the query's qt and doe rows of 8 heads are the B
//    fragments.  The product runs split in three tf32 products (big .
//    big, big . small and small . big, the two corrections in their own
//    accumulator), which keeps it at fp32 accuracy.  Register-blocked
//    fp32 FMAs fed from shared memory are bound by it: a warp's 16-byte
//    load takes four of shared memory's cycles, broadcast or not, and
//    each loaded qt value feeds one FMA per key a lane holds.  sincosf
//    is told its argument is bounded (|x| <= 4096), so the calls, free
//    of their large-argument branch, interleave.  The dots go to shared
//    memory in the order of the phase-B accumulator fragments
//    ([head][key 16-tile][query 8-tile][element][lane], the lane
//    XOR-swizzled by the head so that the stores do not collide).
// B. The products.  bf16: a unit is (head, 16 keys); the 8 warps take
//    the group's units in turn (3 each at 12 heads), each unit holding
//    its K and V rows as mma A fragments and its dK and dV accumulators
//    in registers.  S^T = K.Q^T and dP^T = V.G^T on mma.sync.m16n8k16,
//    the embedding dots and qb added in fp32, p = exp(s - lse),
//    ds = p (dp - delta) valid; then dV += P^T.G and dK += dS^T.Q with
//    P^T and dS^T repacked from the accumulators as A fragments (rounded
//    to bf16 there).  fp32: a warp per head, K and V staged in shared
//    memory; each lane takes a 4 x 4 register tile of S^T and dP^T
//    (keys g + 8r, queries in the accumulator fragments' places), puts
//    P^T and dS^T in the head's slot of the embedding-dot buffer it has
//    just read, and accumulates 4 keys x 8 dims of dK and of dV.
//
// Head dim 64.  Phase A builds its fragments in two halves
// (rel_flash_attention.cuh).  bf16: a warp's three units would hold 3 x
// 96 registers of K/V fragments and dK/dV accumulators, so a warp takes
// one unit and a block 4 heads.  fp32: a lane's 4 keys x 16 dims of dK
// and dV would be 128 registers, so two warps share a head, each the 16
// keys of one key 16-tile (2 keys x 16 dims a lane, the 64 registers of
// hd 32), and a block holds 4 heads.  Three groups at H = 12 in both
// dtypes, each building the pair embeddings once.
//
// The tiles stream in asynchronously: the qt/doe tile of the next query
// tile (double-buffered, by bulk copies on an mbarrier) while this one
// is worked on, the q/do tile (16-byte cp.async into padded rows) while
// phase A runs; the next tile's row statistics and query coordinates
// wait in registers meanwhile.  Rows past L have lse = +inf, so their p
// and ds are exactly 0.  No atomics, every sum in a fixed order.

constexpr int kDkvKeys = 32;     // keys a block owns
constexpr int kDkvQueries = 16;  // query rows per streamed tile
constexpr int kDkvThreads = 256;
constexpr int kDkvWarps = kDkvThreads / 32;

// most heads a dkv block holds: bf16 by the registers of its units (3 a
// warp; 1 at hd 64), fp32 by a warp per head (two at hd 64)
template <typename T, int HD>
__host__ __device__ constexpr int kDkvHeads() {
  return HD > 32 ? 4 : (sizeof(T) == 2 ? 12 : 8);
}

// fp32 dkv: warps a head, each the keys of 2 / dkv_f32_wph of the
// block's two key 16-tiles
template <int HD>
__host__ __device__ constexpr int dkv_f32_wph() {
  return HD > 32 ? 2 : 1;
}

// The shared memory of a dkv block of hg heads, in floats from the
// start: the qt/doe tiles (two stages, [stage][qt|doe][head][qt_ld]),
// the q/do tile ([q|do][head][16][pad_ld]), in fp32 the K/V rows
// ([k|v][head][32][pad_ld]), the row statistics ([qb|lse|delta][head]
// [16]), the embedding dots ([ae|dpe][head][512]), the key flags [32],
// the query coordinates [16][4], the frequencies [HD/2] and the
// mbarriers of the two qt/doe stages.
// In bf16 the K/V rows are staged in the qt/doe region before the loop.
template <typename T, int HD>
struct DkvSmem {
  static constexpr int LD = flash::pad_ld<T, HD>();
  static constexpr int kEl = (int)sizeof(T);
  int qtd, qdo, kv, stats, ae, kval, xq, freqs, bars, floats;
  __host__ __device__ explicit DkvSmem(int hg) {
    qtd = 0;
    qdo = qtd + 2 * 2 * hg * qt_ld<HD>();
    kv = qdo + 2 * hg * kDkvQueries * LD * kEl / 4;
    stats = kv + (kEl == 4 ? 2 * hg * kDkvKeys * LD : 0);
    ae = stats + 3 * hg * kDkvQueries;
    kval = ae + 2 * hg * 512;
    xq = kval + kDkvKeys;
    freqs = xq + 4 * kDkvQueries;
    bars = (freqs + HD / 2 + 1) & ~1;
    floats = bars + 4;
  }
};

template <typename T, int HD>
size_t dkv_smem_bytes(int hg) {
  return sizeof(float) * (size_t)DkvSmem<T, HD>(hg).floats;
}

// The streamed query tiles of a dkv block: qt/doe in two stages
// (qt_ld floats a head, rows contiguous), filled by bulk copies
// that warp 0 issues (one a head and tensor), completing on the stage's
// mbarrier; q/do in one stage of padded rows, by cp.async.  Rows past L
// are not copied (qt/doe) or come as zeros (q/do): the buffers start
// zeroed, and a row past L keeps finite values whose p and ds are 0.
template <typename T, int HD>
struct DkvTiles {
  static constexpr int LD = flash::pad_ld<T, HD>();
  static constexpr int LDH = qt_ld<HD>();
  const float* qt;  // the block's first head of the event, [head][L][HD]
  const float* doe;
  const T* q;
  const T* dout;
  float* qtd;
  T* qdo;
  uint64_t* bars;
  int nh, hg, L;

  // warp 0: the qt and doe rows of tile t into stage t & 1
  __device__ void issue_qtd(int t) const {
    const int lane = threadIdx.x & 31, row0 = t * kDkvQueries;
    const uint32_t bytes = min(kDkvQueries, L - row0) * HD * 4;
    uint64_t* bar = bars + (t & 1);
    float* dst = qtd + (t & 1) * 2 * hg * LDH;
    hopper::fence_proxy_async();
    if (lane == 0) hopper::mbar_arrive_expect_tx(bar, 2 * nh * bytes);
    __syncwarp();
    for (int c = lane; c < 2 * nh; c += 32) {
      const int tn = c / nh, h = c % nh;
      hopper::bulk_copy_g2s(dst + (tn * hg + h) * LDH,
                            (tn ? doe : qt) + ((size_t)h * L + row0) * HD,
                            bytes, bar);
    }
  }

  // every thread: the q and do rows of tile t, by cp.async (one commit
  // group; the padded rows keep ldmatrix free of bank conflicts)
  __device__ void load_qdo(int t) const {
    const int row0 = t * kDkvQueries;
    load_rows<T, HD, kDkvQueries, LD>(qdo, q, nh, L, row0);
    load_rows<T, HD, kDkvQueries, LD>(qdo + hg * kDkvQueries * LD, dout,
                                          nh, L, row0);
    flash::cp_async_commit();
  }

  // every thread: wait for tile t's qt/doe
  __device__ void wait_qtd(int t) const {
    hopper::mbar_wait(bars + (t & 1), (t >> 1) & 1);
  }
};

static_assert(kDkvHeads<__nv_bfloat16, 32>() * kDkvQueries <= kDkvThreads &&
                  kDkvHeads<float, 32>() * kDkvQueries <= kDkvThreads &&
                  kDkvHeads<float, 64>() * dkv_f32_wph<64>() <= kDkvWarps,
              "DkvRows reads one row statistic of the tile a thread; fp32 "
              "phase B takes dkv_f32_wph warps a head");

// The row statistics (qb, lse, delta; past L 0, +inf, 0) and the query
// coordinates (x, y, z, t of rows past L: row L - 1's) of one query
// tile, one value of each a thread: read into registers ahead of the
// tile, stored once the tile before it is done.
struct DkvRows {
  float qb, lse, delta, xq;
  __device__ void read(const float* __restrict__ qb_b,
                       const float* __restrict__ lse_b,
                       const float* __restrict__ delta_b,
                       const float* __restrict__ x0b, int XF, int nh, int L,
                       int row0) {
    const int e = threadIdx.x;
    if (e < nh * kDkvQueries) {
      const int r = row0 + e % kDkvQueries;
      const size_t at = (size_t)(e / kDkvQueries) * L + r;
      const bool in = r < L;
      qb = in ? qb_b[at] : 0.f;
      lse = in ? lse_b[at] : INFINITY;
      delta = in ? delta_b[at] : 0.f;
    }
    if (e < 4 * kDkvQueries)
      xq = x0b[(size_t)min(row0 + e / 4, L - 1) * XF + e % 4];
  }
  __device__ void store(float* stats, float* xq_s, int nh, int hg) const {
    const int e = threadIdx.x;
    if (e < nh * kDkvQueries) {
      stats[e] = qb;
      stats[hg * kDkvQueries + e] = lse;
      stats[2 * hg * kDkvQueries + e] = delta;
    }
    if (e < 4 * kDkvQueries) xq_s[e] = xq;
  }
};

// the place of element e (key row g + 8 (e >> 1), query parity e & 1)
// of lane `lane`'s accumulator fragment (unit (h, m), query 8-tile n)
// in the embedding-dot buffer
__device__ __forceinline__ int dkv_slot(int h, int m, int n, int e,
                                        int lane) {
  return ((h * 2 + m) * 2 + n) * 128 + e * 32 + (lane ^ ((h >> 1) & 3));
}

// Phase A for one tile: qt.emb and doe.emb of every (query, key) pair of
// the tile for each of the nh heads, into ae_s / dpe (hg * 512 floats
// on) in fragment order.  Warp w takes key 16-tile m = w & 1 and the
// queries (w >> 1) + 4 t; lane (g, cq) builds the embedding of keys
// 16m + g and 16m + g + 8 (xk: the coordinates of key 16m + g + 8 (cq &
// 1)), in emb_halves halves (the second's dots added to the first's).
// Within a k-step, columns cq and cq + 4 stand for embedding dims 2cq
// and 2cq + 1 (of 8k on): a sum over e takes them in any order, and so
// each B fragment is one 8-byte load, and lane (g, cq) builds
// frequencies 8kk + 2cq and 8kk + 2cq + 1.
template <int HD>
__device__ __forceinline__ void dkv_phase_a(
    const float* __restrict__ qtd, float* __restrict__ ae_s,
    const float* __restrict__ fr, const float* __restrict__ xq_s,
    const float (&xk)[4], int nh, int hg) {
  constexpr int KH = HD / 8 / emb_halves<HD>();  // tf32 k-steps a half
  constexpr int LDH = qt_ld<HD>();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, cq = lane & 3, m = w & 1;
  const int ntiles = (nh + 7) / 8;
#pragma unroll 1
  for (int task = 0; task < kDkvQueries / 4; ++task) {
    const int i = (w >> 1) + 4 * task;  // the query row in the tile
    const float arg = pair_arg(xq_s + 4 * i, xk);
    const float args[2] = {__shfl_sync(0xffffffffu, arg, g * 4),
                           __shfl_sync(0xffffffffu, arg, g * 4 + 1)};
#pragma unroll
    for (int hf = 0; hf < emb_halves<HD>(); ++hf) {
      uint32_t ab[KH][4], as[KH][4];  // A fragments (keys x e)
      emb_frags<KH>(args, fr + 4 * KH * hf, ab, as);
      // the place of element e of lane (g, cq)'s tile n in phase B:
      // element 2 (e >> 1) + (i & 1) of lane 4g + (i & 7) / 2 of fragment
      // (head 8n + 2cq + (e & 1), m, i >> 3), the lane swizzled by cq
      const int at0 = 2 * cq * 512 + (m * 2 + (i >> 3)) * 128 +
                      (i & 1) * 32 + ((4 * g + ((i & 7) >> 1)) ^ cq);
#pragma unroll 1
      for (int n = 0; n < ntiles; ++n) {
        // B fragments (e x heads): head 8n + g (a head past nh reads head
        // nh - 1; its column of D is dropped)
        const float* qr =
            qtd + min(8 * n + g, nh - 1) * LDH + i * HD + 2 * cq;
        const float* dr = qr + hg * LDH;
        float eb[4] = {0.f, 0.f, 0.f, 0.f}, ec[4] = {0.f, 0.f, 0.f, 0.f};
        float db[4] = {0.f, 0.f, 0.f, 0.f}, dc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int l = 0; l < KH; ++l) {
          const int k = emb_kstep<HD>(hf, l);
          const float2 x = *reinterpret_cast<const float2*>(qr + 8 * k);
          const float2 y = *reinterpret_cast<const float2*>(dr + 8 * k);
          uint32_t xb0, xs0, xb1, xs1, yb0, ys0, yb1, ys1;
          tf32_split(x.x, xb0, xs0);
          tf32_split(x.y, xb1, xs1);
          tf32_split(y.x, yb0, ys0);
          tf32_split(y.y, yb1, ys1);
          hopper::mma_tf32(ec, as[l], xb0, xb1);
          hopper::mma_tf32(ec, ab[l], xs0, xs1);
          hopper::mma_tf32(eb, ab[l], xb0, xb1);
          hopper::mma_tf32(dc, as[l], yb0, yb1);
          hopper::mma_tf32(dc, ab[l], ys0, ys1);
          hopper::mma_tf32(db, ab[l], yb0, yb1);
        }
        // element e: key row g + 8 (e >> 1), head 8n + 2cq + (e & 1)
        float* out = ae_s + 8 * n * 512 + at0;
        const bool full = 8 * n + 8 <= nh;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (full || 8 * n + 2 * cq + (e & 1) < nh) {
            const int off = (e & 1) * 512 + (e >> 1) * 64;
            float* a = out + off;
            float* d = out + hg * 512 + off;
            *a = hf == 0 ? eb[e] + ec[e] : *a + (eb[e] + ec[e]);
            *d = hf == 0 ? db[e] + dc[e] : *d + (db[e] + dc[e]);
          }
        }
      }
    }
  }
}

// p and ds of an element of a unit's accumulators from S^T and dP^T
// (in st, dp), in place: slot is the element's place in ae_s, stats the
// row statistics of the unit's head, i the query row within the tile
__device__ __forceinline__ void dkv_p_ds(float& st, float& dp,
                                         const float* __restrict__ ae_s,
                                         int slot, int dpe_off,
                                         const float* __restrict__ stats,
                                         int hg, int i, float val) {
  float s = (st + ae_s[slot]) + stats[i];
  s = val != 0.f ? s : kNeg;
  const float p = expf(s - stats[hg * kDkvQueries + i]);
  st = p;
  dp = p * ((dp + ae_s[slot + dpe_off]) - stats[2 * hg * kDkvQueries + i]) *
       val;
}

// dkv, bf16: tensor cores for the four products.
template <int HD>
__global__ void __launch_bounds__(kDkvThreads, 1)
    rel_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const float* __restrict__ qt,
                       const float* __restrict__ qb,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ x0,
                       const uint8_t* __restrict__ mask,
                       const float* __restrict__ freqs,
                       const float* __restrict__ lse,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ doe,
                       const float* __restrict__ delta, int H, int L, int XF,
                       int hg, __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv) {
  using T = __nv_bfloat16;
  constexpr int LD = flash::pad_ld<T, HD>();
  constexpr int KS = HD / 16;  // k-steps of K.Q^T
  constexpr int UPW = (2 * kDkvHeads<T, HD>() + kDkvWarps - 1) / kDkvWarps;
  extern __shared__ __align__(16) float smem[];
  const DkvSmem<T, HD> sm(hg);
  float* qtd = smem + sm.qtd;
  T* qdo = reinterpret_cast<T*>(smem + sm.qdo);
  float* stats = smem + sm.stats;
  float* ae_s = smem + sm.ae;
  float* kval = smem + sm.kval;
  float* xq_s = smem + sm.xq;
  float* fr = smem + sm.freqs;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + sm.bars);

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int b = blockIdx.z, h0 = blockIdx.y * hg;
  const int nh = min(hg, H - h0), units = 2 * nh;
  const int k0 = blockIdx.x * kDkvKeys;
  const size_t bh0 = (size_t)b * H + h0;
  const float* x0b = x0 + (size_t)b * L * XF;
  const int nt = (L + kDkvQueries - 1) / kDkvQueries;
  const int qtd_stage = 2 * hg * qt_ld<HD>();
  const DkvTiles<T, HD> tiles{qt + bh0 * L * HD, doe + bh0 * L * HD,
                              q + bh0 * L * HD,  dout + bh0 * L * HD,
                              qtd,               qdo,
                              bars,              nh,
                              hg,                L};

  if (threadIdx.x == 0) {
    for (int j = 0; j < 2; ++j) hopper::mbar_init(bars + j, 1);
    hopper::fence_mbar_init();
  }
  // the block's K and V rows, staged in the qt/doe region, into the
  // units' A fragments
  load_rows<T, HD, kDkvKeys, LD>(reinterpret_cast<T*>(qtd),
                                     k + bh0 * L * HD, nh, L, k0);
  load_rows<T, HD, kDkvKeys, LD>(
      reinterpret_cast<T*>(qtd) + hg * kDkvKeys * LD, v + bh0 * L * HD, nh,
      L, k0);
  flash::cp_async_commit();
  for (int j = threadIdx.x; j < kDkvKeys; j += blockDim.x)
    kval[j] = (k0 + j < L && mask[(size_t)b * L + k0 + j]) ? 1.f : 0.f;
  for (int f = threadIdx.x; f < HD / 2; f += blockDim.x) fr[f] = freqs[f];
  float xk[4];  // the key of this lane's pair_arg in phase A
  {
    const int key = min(k0 + (w & 1) * 16 + g + 8 * (lane & 1), L - 1);
#pragma unroll
    for (int d = 0; d < 4; ++d) xk[d] = x0b[(size_t)key * XF + d];
  }
  flash::cp_async_wait_all();
  __syncthreads();
  uint32_t ka[UPW][KS][4], va[UPW][KS][4];
  float dka[UPW][HD / 8][4], dva[UPW][HD / 8][4];
#pragma unroll
  for (int u = 0; u < UPW; ++u) {
    const int unit = w + kDkvWarps * u;
    const int hh = unit >> 1, mm = unit & 1;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int at = (mm * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
      if (unit < units) {
        const T* ks = reinterpret_cast<const T*>(qtd) + hh * kDkvKeys * LD;
        flash::ldmatrix_x4(ka[u][kk], ks + at);
        flash::ldmatrix_x4(va[u][kk], ks + hg * kDkvKeys * LD + at);
      }
    }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[u][d][e] = dva[u][d][e] = 0.f;
  }
  __syncthreads();  // the K/V staging is done with
  for (int e = threadIdx.x; e < sm.kv - sm.qtd; e += blockDim.x) qtd[e] = 0.f;
  DkvRows rows;
  rows.read(qb + bh0 * L, lse + bh0 * L, delta + bh0 * L, x0b, XF, nh, L, 0);
  rows.store(stats, xq_s, nh, hg);
  __syncthreads();
  if (w == 0) {
    tiles.issue_qtd(0);
  }
  tiles.load_qdo(0);

  for (int t = 0; t < nt; ++t) {
    const int t0 = t * kDkvQueries;
    if (t + 1 < nt) {
      if (w == 0) tiles.issue_qtd(t + 1);
      rows.read(qb + bh0 * L, lse + bh0 * L, delta + bh0 * L, x0b, XF, nh, L,
                t0 + kDkvQueries);
    }
    tiles.wait_qtd(t);
    __syncthreads();  // also: this tile's row statistics and coordinates
    dkv_phase_a<HD>(qtd + (t & 1) * qtd_stage, ae_s, fr, xq_s, xk, nh, hg);
    flash::cp_async_wait_all();  // this tile's q/do
    __syncthreads();  // the embedding dots

#pragma unroll
    for (int u = 0; u < UPW; ++u) {
      const int unit = w + kDkvWarps * u;
      if (unit >= units) continue;
      const int hh = unit >> 1, mm = unit & 1;
      const T* qs = qdo + hh * kDkvQueries * LD;
      const T* gs = qdo + (hg + hh) * kDkvQueries * LD;
      float st[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int at = ((lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                       ((lane >> 3) & 1) * 8;
        uint32_t bq[4];
        flash::ldmatrix_x4(bq, qs + at);
        flash::mma_bf16(st[0], ka[u][kk], bq[0], bq[1]);
        flash::mma_bf16(st[1], ka[u][kk], bq[2], bq[3]);
        flash::ldmatrix_x4(bq, gs + at);
        flash::mma_bf16(dp[0], va[u][kk], bq[0], bq[1]);
        flash::mma_bf16(dp[1], va[u][kk], bq[2], bq[3]);
      }
      const float* sh = stats + hh * kDkvQueries;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int slot = dkv_slot(hh, mm, n, e, lane);
          dkv_p_ds(st[n][e], dp[n][e], ae_s, slot, hg * 512, sh, hg,
                   n * 8 + c + (e & 1), kval[mm * 16 + g + 8 * (e >> 1)]);
        }
      uint32_t pa[4], da[4];
      flash::pack_a(pa, st[0], st[1]);
      flash::pack_a(da, dp[0], dp[1]);
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        const int at = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + np * 16 +
                       (lane >> 4) * 8;
        uint32_t bt[4];
        flash::ldmatrix_x4_trans(bt, gs + at);
        flash::mma_bf16(dva[u][2 * np], pa, bt[0], bt[1]);
        flash::mma_bf16(dva[u][2 * np + 1], pa, bt[2], bt[3]);
        flash::ldmatrix_x4_trans(bt, qs + at);
        flash::mma_bf16(dka[u][2 * np], da, bt[0], bt[1]);
        flash::mma_bf16(dka[u][2 * np + 1], da, bt[2], bt[3]);
      }
    }
    __syncthreads();  // the q/do tile and the embedding dots are free
    if (t + 1 < nt) {
      tiles.load_qdo(t + 1);
      rows.store(stats, xq_s, nh, hg);
    }
  }

#pragma unroll
  for (int u = 0; u < UPW; ++u) {
    const int unit = w + kDkvWarps * u;
    if (unit >= units) continue;
    const int hh = unit >> 1, mm = unit & 1;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + mm * 16 + g + 8 * r;
      if (key < L) {
        const size_t at = ((bh0 + hh) * L + key) * HD + c;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) {
          *reinterpret_cast<uint32_t*>(dk + at + d * 8) =
              flash::pack_bf16(dka[u][d][2 * r], dka[u][d][2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dv + at + d * 8) =
              flash::pack_bf16(dva[u][d][2 * r], dva[u][d][2 * r + 1]);
        }
      }
    }
  }
}

// dkv, fp32: the four products on the CUDA cores in full fp32 (no
// TF32; phase A as in bf16).  Warp w takes head w / WPH and part
// p = w % WPH of its keys (WPH = dkv_f32_wph: 1, at hd 64 2); lane (g,
// cq) its keys g + 8kr, kr = r + R p (r < R = 4 / WPH: key 16-tile
// kr >> 1, row half kr & 1) against queries 8n + 2cq + s, the places of
// its mma accumulator fragments, so it reads the embedding dots as the
// bf16 kernel does.  The P^T and dS^T a warp puts over its head's
// embedding dots fall on its own key rows' dots.
template <int HD>
__global__ void __launch_bounds__(kDkvThreads, 1)
    rel_dkv_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ qt,
                       const float* __restrict__ qb,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ x0,
                       const uint8_t* __restrict__ mask,
                       const float* __restrict__ freqs,
                       const float* __restrict__ lse,
                       const float* __restrict__ dout,
                       const float* __restrict__ doe,
                       const float* __restrict__ delta, int H, int L, int XF,
                       int hg, float* __restrict__ dk,
                       float* __restrict__ dv) {
  constexpr int LD = flash::pad_ld<float, HD>();
  constexpr int NK = HD / 16;  // 4-dim chunks of dK, dV a lane owns
  constexpr int WPH = dkv_f32_wph<HD>(), R = 4 / WPH;
  extern __shared__ __align__(16) float smem[];
  const DkvSmem<float, HD> sm(hg);
  float* qtd = smem + sm.qtd;
  float* qdo = smem + sm.qdo;
  float* kvs = smem + sm.kv;
  float* stats = smem + sm.stats;
  float* ae_s = smem + sm.ae;
  float* kval = smem + sm.kval;
  float* xq_s = smem + sm.xq;
  float* fr = smem + sm.freqs;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + sm.bars);

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int b = blockIdx.z, h0 = blockIdx.y * hg;
  const int nh = min(hg, H - h0);
  const int k0 = blockIdx.x * kDkvKeys;
  const size_t bh0 = (size_t)b * H + h0;
  const float* x0b = x0 + (size_t)b * L * XF;
  const int nt = (L + kDkvQueries - 1) / kDkvQueries;
  const int qtd_stage = 2 * hg * qt_ld<HD>();
  const DkvTiles<float, HD> tiles{qt + bh0 * L * HD, doe + bh0 * L * HD,
                                  q + bh0 * L * HD,  dout + bh0 * L * HD,
                                  qtd,               qdo,
                                  bars,              nh,
                                  hg,                L};

  load_rows<float, HD, kDkvKeys, LD>(kvs, k + bh0 * L * HD, nh, L, k0);
  load_rows<float, HD, kDkvKeys, LD>(kvs + hg * kDkvKeys * LD,
                                         v + bh0 * L * HD, nh, L, k0);
  flash::cp_async_commit();
  if (threadIdx.x == 0) {
    for (int j = 0; j < 2; ++j) hopper::mbar_init(bars + j, 1);
    hopper::fence_mbar_init();
  }
  for (int e = threadIdx.x; e < sm.kv - sm.qtd; e += blockDim.x) qtd[e] = 0.f;
  DkvRows rows;
  rows.read(qb + bh0 * L, lse + bh0 * L, delta + bh0 * L, x0b, XF, nh, L, 0);
  rows.store(stats, xq_s, nh, hg);
  for (int j = threadIdx.x; j < kDkvKeys; j += blockDim.x)
    kval[j] = (k0 + j < L && mask[(size_t)b * L + k0 + j]) ? 1.f : 0.f;
  for (int f = threadIdx.x; f < HD / 2; f += blockDim.x) fr[f] = freqs[f];
  float xk[4];  // the key of this lane's pair_arg in phase A
  {
    const int key = min(k0 + (w & 1) * 16 + g + 8 * (lane & 1), L - 1);
#pragma unroll
    for (int d = 0; d < 4; ++d) xk[d] = x0b[(size_t)key * XF + d];
  }

  flash::cp_async_wait_all();  // the K/V rows
  __syncthreads();
  if (w == 0) {
    tiles.issue_qtd(0);
  }
  tiles.load_qdo(0);

  // the warp's head (and part of its keys) in phase B, if it takes part
  const int hh = w / WPH, part = w % WPH;
  const bool owner = hh < nh;
  float dka[R][NK][4], dva[R][NK][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[r][kk][e] = dva[r][kk][e] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int t0 = t * kDkvQueries;
    if (t + 1 < nt) {
      if (w == 0) tiles.issue_qtd(t + 1);
      rows.read(qb + bh0 * L, lse + bh0 * L, delta + bh0 * L, x0b, XF, nh, L,
                t0 + kDkvQueries);
    }
    tiles.wait_qtd(t);
    __syncthreads();  // also: this tile's row statistics and coordinates
    dkv_phase_a<HD>(qtd + (t & 1) * qtd_stage, ae_s, fr, xq_s, xk, nh, hg);
    flash::cp_async_wait_all();  // this tile's q/do
    __syncthreads();  // the embedding dots

    if (owner) {
      const float* ks = kvs + hh * kDkvKeys * LD;
      const float* vs = kvs + (hg + hh) * kDkvKeys * LD;
      const float* qs = qdo + hh * kDkvQueries * LD;
      const float* gs = qdo + (hg + hh) * kDkvQueries * LD;
      // S^T and dP^T: st[r][j] for key g + 8kr and query qi(j) =
      // 8 (j >> 1) + 2cq + (j & 1)
      float st[R][4], dp[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[r][j] = dp[r][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HD; d += 4) {
        float4 a[R], bq[4];
#pragma unroll
        for (int r = 0; r < R; ++r)
          a[r] = flash::ld4(ks + (g + 8 * (r + R * part)) * LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bq[j] = flash::ld4(qs + (8 * (j >> 1) + 2 * cq + (j & 1)) * LD + d);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[r][j] = fmaf(a[r].x, bq[j].x, st[r][j]);
            st[r][j] = fmaf(a[r].y, bq[j].y, st[r][j]);
            st[r][j] = fmaf(a[r].z, bq[j].z, st[r][j]);
            st[r][j] = fmaf(a[r].w, bq[j].w, st[r][j]);
          }
#pragma unroll
        for (int r = 0; r < R; ++r)
          a[r] = flash::ld4(vs + (g + 8 * (r + R * part)) * LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bq[j] = flash::ld4(gs + (8 * (j >> 1) + 2 * cq + (j & 1)) * LD + d);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dp[r][j] = fmaf(a[r].x, bq[j].x, dp[r][j]);
            dp[r][j] = fmaf(a[r].y, bq[j].y, dp[r][j]);
            dp[r][j] = fmaf(a[r].z, bq[j].z, dp[r][j]);
            dp[r][j] = fmaf(a[r].w, bq[j].w, dp[r][j]);
          }
      }
      const float* sh = stats + hh * kDkvQueries;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // fragment (m = kr >> 1, n = j >> 1), element 2 (kr & 1) + (j & 1)
          const int kr = r + R * part;
          const int slot =
              dkv_slot(hh, kr >> 1, j >> 1, 2 * (kr & 1) + (j & 1), lane);
          dkv_p_ds(st[r][j], dp[r][j], ae_s, slot, hg * 512, sh, hg,
                   8 * (j >> 1) + 2 * cq + (j & 1), kval[g + 8 * kr]);
        }
      // P^T and dS^T ([key][query], the query's float4 slot swizzled by
      // the key) over the head's embedding dots, which are read
      __syncwarp();
      float* ps = ae_s + hh * 512;
      float* dss = ae_s + (hg + hh) * 512;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = g + 8 * (r + R * part);
          const int i = 8 * (j >> 1) + 2 * cq + (j & 1);
          const int at = key * 16 + 4 * ((i >> 2) ^ ((key >> 1) & 3)) + (i & 3);
          ps[at] = st[r][j];
          dss[at] = dp[r][j];
        }
      __syncwarp();
      // dV += P^T.G and dK += dS^T.Q: keys g + 8kr, dims 4 (cq + 4 kk) ..
      // + 3, four queries a step
#pragma unroll 1
      for (int q4 = 0; q4 < kDkvQueries / 4; ++q4) {
        float4 pr[R], sr[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int at =
              (g + 8 * (r + R * part)) * 16 + 4 * (q4 ^ ((g >> 1) & 3));
          pr[r] = flash::ld4(ps + at);
          sr[r] = flash::ld4(dss + at);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int row = 4 * q4 + u;
#pragma unroll
          for (int kk = 0; kk < NK; ++kk) {
            const float4 x = flash::ld4(gs + row * LD + 4 * (cq + 4 * kk));
            const float4 y = flash::ld4(qs + row * LD + 4 * (cq + 4 * kk));
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float pu = flash::at4(pr[r], u), su = flash::at4(sr[r], u);
              dva[r][kk][0] = fmaf(pu, x.x, dva[r][kk][0]);
              dva[r][kk][1] = fmaf(pu, x.y, dva[r][kk][1]);
              dva[r][kk][2] = fmaf(pu, x.z, dva[r][kk][2]);
              dva[r][kk][3] = fmaf(pu, x.w, dva[r][kk][3]);
              dka[r][kk][0] = fmaf(su, y.x, dka[r][kk][0]);
              dka[r][kk][1] = fmaf(su, y.y, dka[r][kk][1]);
              dka[r][kk][2] = fmaf(su, y.z, dka[r][kk][2]);
              dka[r][kk][3] = fmaf(su, y.w, dka[r][kk][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // the q/do tile and the embedding dots are free
    if (t + 1 < nt) {
      tiles.load_qdo(t + 1);
      rows.store(stats, xq_s, nh, hg);
    }
  }

  if (owner) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int key = k0 + g + 8 * (r + R * part);
      if (key < L) {
        const size_t at = ((bh0 + hh) * L + key) * HD;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          const int d = 4 * (cq + 4 * kk);
          *reinterpret_cast<float4*>(dk + at + d) = make_float4(
              dka[r][kk][0], dka[r][kk][1], dka[r][kk][2], dka[r][kk][3]);
          *reinterpret_cast<float4*>(dv + at + d) = make_float4(
              dva[r][kk][0], dva[r][kk][1], dva[r][kk][2], dva[r][kk][3]);
        }
      }
    }
  }
}

// the dkv kernel of each input dtype
template <int HD>
auto dkv_kernel(const float*) {
  return rel_dkv_f32_kernel<HD>;
}
template <int HD>
auto dkv_kernel(const __nv_bfloat16*) {
  return rel_dkv_mma_kernel<HD>;
}

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* qt, const void* qb,
                       const void* k, const void* v, const void* x0,
                       const void* mask, const void* freqs, const void* lse,
                       const void* dout, const void* doe, const void* delta,
                       int B, int H, int L, int XF, void* dk, void* dv,
                       cudaStream_t stream) {
  if (!flash::aligned16(q, qt, k, v) || !flash::aligned16(dout, doe, dk, dv))
    return cudaErrorMisalignedAddress;
  int groups, hg;
  head_groups(H, kDkvHeads<T, HD>(), &groups, &hg);
  const size_t bytes = dkv_smem_bytes<T, HD>(hg);
  auto kern = dkv_kernel<HD>(static_cast<const T*>(nullptr));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kDkvKeys - 1) / kDkvKeys, groups, B);
  kern<<<grid, kDkvThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const float*>(qt),
      static_cast<const float*>(qb), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(x0),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(freqs),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const float*>(doe), static_cast<const float*>(delta), H, L,
      XF, hg, static_cast<T*>(dk), static_cast<T*>(dv));
  return cudaGetLastError();
}

// ------------------------------------------------------------ dQ
//
// What bounds the dq kernel on the H100: operations.  Per (b, h, i, j)
// the three embedding dots qt.emb_ij, doe.emb_ij and ds.emb_ij (6*hd
// flops, fp32 by the contract) and the three products q.k, do.v and
// ds.k (6*hd flops, in the input dtype), and per (b, i, j) hd/2 precise
// sincos: at DeepIce's shape (B=16, H=12, L=768, hd=32) 0.35 ms in bf16
// and 0.65 ms in fp32 at the card's peaks; at hd 64 (B_d64) 0.70 and
// 1.31 ms.
//
// The design is the dkv kernel's with the two sides swapped.  A block
// owns 16 query rows of one event and a group of heads (all of them up
// to kDqHeads: one group at H = 12 in bf16, two of 6 in fp32), and
// streams tiles of 16 keys.  The query side stays resident in shared
// memory: qt, doe, q, do and the row statistics.  Per key tile, three
// phases:
//
// A. qt.emb and doe.emb, once per pair for the whole group, on the
//    tensor cores: for one query and 16 keys the lanes of a warp build
//    the pair embeddings into tf32 A fragments (emb_frags), the query's
//    qt and doe rows of 8 heads are the B fragments, three tf32 products
//    each (dkv_phase_a's loop).  The dots go to shared memory in the
//    order of phase B's accumulator fragments (dot_slot), and the split
//    embedding to the query's buffer for phase C ([key][dim pair], the
//    pair XOR-swizzled by the key).
// B. The products, a unit (head, 16 queries) a warp: S = Q.K^T and
//    dP = dO.V^T, the dots and qb added in fp32, p = exp(s - lse),
//    ds = p (dp - delta) valid; ds, unrounded, back into the dots' slot
//    for phase C and into the row sums of dqb; dQ += round(dS).K with dS
//    repacked from the accumulators as A fragments, each tile's dQ begun
//    at zero and added in fp32 to the running dQ in shared memory.  bf16
//    on mma.sync.m16n8k16 (Q, dO, K and V by ldmatrix); fp32 as three
//    tf32 products (big . big, big . small, small . big) on
//    mma.sync.m16n8k8, fp32-accurate.
// C. dqt += ds.emb on the tensor cores, three tf32 products: for query i
//    [heads x 16 keys] . [16 keys x e], ds from its slots as A fragments
//    (split big + small), the embedding from phase A's buffer as B
//    fragments.  Phase A's fragments hold the keys as rows, phase C sums
//    over them, so the embedding goes through shared memory rather than
//    being built again.  Each tile's sum begins at zero and is added to
//    the query's running dqt in fp32.
//
// Head dim 64 (rel_flash_attention.cuh): phase A in two halves of the
// frequencies, and the phase-C buffer with each embedding value once in
// fp32 (64 KB, not 128).  The resident rows and the K/V tile of a head
// take 32 KB in fp32 and 23 in bf16 there, so a block holds up to 5
// heads in fp32 and 6 in bf16 (kDqHeads): three groups of 4 and two of
// 6 at H = 12, each building the pair embeddings once.
//
// What holds it on the card is latency: the phases' chains of mma.sync,
// shared-memory loads and sincosf, between barriers.  So bf16 runs 16
// warps a block, a query each in phases A and C, in 128 registers (the
// running dQ and the row statistics kept in shared memory for that);
// fp32, whose phase B needs more, runs 8 warps of two queries.  A warp
// works on its own queries in phases A and C, so phase C of tile t and
// phase A of tile t + 1 follow each other without a block barrier: two
// barriers a tile.  The K/V tile of t + 1 streams in by cp.async
// meanwhile, and the key coordinates and flags are double-buffered.
// Rows past L have lse = +inf, so their p and ds are exactly 0; keys
// past L come as zeros with flag 0.  No atomics, every sum in a fixed
// order.

constexpr int kDqQueries = 16;  // query rows a block owns
constexpr int kDqKeys = 16;     // keys per streamed tile
constexpr int kDqPairs = kDqQueries * kDqKeys;  // dots a head a tile

// warps a dq block runs: a query each in bf16, whose registers fit the
// 128 of 16 warps; two each in fp32, whose do not
template <typename T>
__host__ __device__ constexpr int kDqWarps() {
  return sizeof(T) == 2 ? 16 : 8;
}

static_assert(kDqQueries == kDkvQueries, "the qt/doe rows use qt_ld");
static_assert(4 * kDqKeys <= 32 * kDqWarps<float>(), "dq_key_rows: a value a thread");

// most heads a dq block holds (a unit a warp in phase B), by the shared
// memory of their K/V tile and Q/dO rows beside the rest: one group at
// H = 12 in bf16, two of 6 in fp32 (hd 64: 6 and 5 heads)
template <typename T, int HD>
__host__ __device__ constexpr int kDqHeads() {
  return HD > 32 ? (sizeof(T) == 2 ? 6 : 5) : (sizeof(T) == 2 ? 12 : 8);
}
static_assert(kDqHeads<__nv_bfloat16, 32>() <= kDqWarps<__nv_bfloat16>() &&
                  kDqHeads<float, 32>() <= kDqWarps<float>() &&
                  kDqHeads<float, 64>() <= kDqWarps<float>(),
              "phase B: a unit a warp");

// The shared memory of a dq block of hg heads, in floats from the start:
// the resident qt/doe rows ([qt|doe][head][qt_ld]), the resident
// Q/dO rows ([q|do][head][16][q_ld] of T), the K/V tile
// ([k|v][head][16][pad_ld] of T), the dots ([ae|dpe][head][kDqPairs],
// ae then ds), the running dQ of each unit ([head][HD/8][4][32], a
// lane's accumulator fragments), the embeddings for phase C
// ([query][key][emb_ld]), the row
// statistics ([qb|lse|delta][head][16]), the query coordinates ([16][4]),
// the key coordinates ([2][16][4]) and flags ([2][16]) and the
// frequencies.
template <typename T, int HD>
struct DqSmem {
  static constexpr int LD = flash::pad_ld<T, HD>();
  static constexpr int kEl = (int)sizeof(T);
  int qtd, qdo, kv, dots, dqacc, emb, stats, xq, xk, kval, freqs, floats;
  __host__ __device__ explicit DqSmem(int hg) {
    qtd = 0;
    qdo = qtd + 2 * hg * qt_ld<HD>();
    kv = qdo + 2 * hg * kDqQueries * q_ld<HD>() * kEl / 4;
    dots = kv + 2 * hg * kDqKeys * LD * kEl / 4;
    dqacc = dots + 2 * hg * kDqPairs;
    emb = dqacc + hg * kDqQueries * HD;
    stats = emb + kDqPairs * emb_ld<HD>();
    xq = stats + 3 * hg * kDqQueries;
    xk = xq + 4 * kDqQueries;
    kval = xk + 2 * 4 * kDqKeys;
    freqs = kval + 2 * kDqKeys;
    floats = freqs + HD / 2;
  }
};

template <typename T, int HD>
size_t dq_smem_bytes(int hg) {
  return sizeof(float) * (size_t)DqSmem<T, HD>(hg).floats;
}

// the coordinates (x, y, z, t; past L key L - 1's) and flags (1 valid, 0
// masked or past L) of keys [t0, t0 + 16) into xk [16][4] and kval [16]
__device__ __forceinline__ void dq_key_rows(float* xk, float* kval,
                                            const float* __restrict__ x0b,
                                            const uint8_t* __restrict__ mb,
                                            int XF, int L, int t0) {
  const int e = threadIdx.x;
  if (e < 4 * kDqKeys)
    xk[e] = x0b[(size_t)min(t0 + e / 4, L - 1) * XF + e % 4];
  if (e < kDqKeys) kval[e] = (t0 + e < L && mb[t0 + e]) ? 1.f : 0.f;
}

// the row statistics of the block's queries for each head into stats
// ([qb|lse|delta][head][16]; rows past L 0, +inf and 0, so their p and
// ds are exactly 0) and their coordinates into xq ([16][4]; rows past L
// take row L - 1's)
__device__ __forceinline__ void dq_query_rows(
    float* stats, float* xq, const float* __restrict__ qb,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ x0b, int XF, size_t bh0, int nh, int hg, int L,
    int row0) {
  for (int c = threadIdx.x; c < nh * kDqQueries; c += blockDim.x) {
    const int row = row0 + c % kDqQueries;
    const size_t at = (bh0 + c / kDqQueries) * L + min(row, L - 1);
    const bool in = row < L;
    const int h = c / kDqQueries, r = c % kDqQueries;
    stats[h * kDqQueries + r] = in ? qb[at] : 0.f;
    stats[(hg + h) * kDqQueries + r] = in ? lse[at] : INFINITY;
    stats[(2 * hg + h) * kDqQueries + r] = in ? delta[at] : 0.f;
  }
  for (int e = threadIdx.x; e < 4 * kDqQueries; e += blockDim.x)
    xq[e] = x0b[(size_t)min(row0 + e / 4, L - 1) * XF + e % 4];
}

// Phase A for query i of the block and the tile's 16 keys (coordinates
// xks, [16][4]): qt.emb and doe.emb of every head into the dots (ae, and
// dpe hg * kDqPairs on) at dot_slot, and the embedding into embq for
// phase C (query_emb), in emb_halves halves (the second's dots added to
// the first's).  The B fragments are the query's qt and doe rows, as in
// dkv_phase_a (dims 2cq and 2cq + 1 of a k-step in columns cq and cq +
// 4, one 8-byte load; a head past nh reads head nh - 1 and its column of
// D is dropped).
template <int HD>
__device__ __forceinline__ void dq_phase_a(const float* __restrict__ qtd,
                                           float* __restrict__ dots,
                                           float* __restrict__ embq,
                                           const float* __restrict__ fr,
                                           const float* __restrict__ xq,
                                           const float* __restrict__ xks,
                                           int i, int nh, int hg) {
  constexpr int KH = HD / 8 / emb_halves<HD>();  // tf32 k-steps a half
  constexpr int LDH = qt_ld<HD>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, cq = lane & 3;
  // query_args' arguments, computed here: through query_args the fp32
  // hd-16 build allocates its registers otherwise
  const float arg = pair_arg(xq, xks + 4 * (g + 8 * (lane & 1)));
  const float args[2] = {__shfl_sync(0xffffffffu, arg, g * 4),
                         __shfl_sync(0xffffffffu, arg, g * 4 + 1)};
#pragma unroll
  for (int hf = 0; hf < emb_halves<HD>(); ++hf) {
    uint32_t ab[KH][4], as[KH][4];  // A fragments (keys x e)
    query_emb<HD>(args, fr, embq, hf, ab, as);
    const int ntiles = (nh + 7) / 8;
#pragma unroll 1
    for (int n = 0; n < ntiles; ++n) {
      // B fragments (e x heads): head 8n + g
      const float* qr = qtd + min(8 * n + g, nh - 1) * LDH + i * HD + 2 * cq;
      const float* dr = qr + hg * LDH;
      // a k-step's two corrections before its big . big product, all in
      // one accumulator (the sum runs over e = hd terms only)
      float ea[4] = {0.f, 0.f, 0.f, 0.f}, da[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int l = 0; l < KH; ++l) {
        const int k = emb_kstep<HD>(hf, l);
        const float2 x = *reinterpret_cast<const float2*>(qr + 8 * k);
        const float2 y = *reinterpret_cast<const float2*>(dr + 8 * k);
        uint32_t xb0, xs0, xb1, xs1, yb0, ys0, yb1, ys1;
        tf32_split(x.x, xb0, xs0);
        tf32_split(x.y, xb1, xs1);
        tf32_split(y.x, yb0, ys0);
        tf32_split(y.y, yb1, ys1);
        hopper::mma_tf32(ea, as[l], xb0, xb1);
        hopper::mma_tf32(ea, ab[l], xs0, xs1);
        hopper::mma_tf32(ea, ab[l], xb0, xb1);
        hopper::mma_tf32(da, as[l], yb0, yb1);
        hopper::mma_tf32(da, ab[l], ys0, ys1);
        hopper::mma_tf32(da, ab[l], yb0, yb1);
      }
      // element e: key g + 8 (e >> 1), head 8n + 2cq + (e & 1)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = 8 * n + 2 * cq + (e & 1);
        if (h < nh) {
          const int slot = dot_slot(h, i, g + 8 * (e >> 1));
          if (hf == 0) {
            dots[slot] = ea[e];
            dots[hg * kDqPairs + slot] = da[e];
          } else {
            dots[slot] += ea[e];
            dots[hg * kDqPairs + slot] += da[e];
          }
        }
      }
    }
  }
}

// Phase C for query i of the block: dqt (rows: heads g and g + 8,
// columns: dims 8nt + 2cq and + 1) += ds . emb over the tile's 16 keys
// (slot_emb_product: ds from its slots, the embedding from phase A's
// buffer, three tf32 products, begun at zero).
template <int HD>
__device__ __forceinline__ void dq_phase_c(const float* __restrict__ ds_s,
                                           const float* __restrict__ embq,
                                           float (&dqt)[HD / 8][4], int i,
                                           int nh) {
  constexpr int NT = HD / 8;  // n-tiles over the embedding
  float acc[NT][4];
  slot_emb_product<HD>(ds_s, embq, acc, i, nh);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqt[nt][e] += acc[nt][e];
}

// p and ds of an element of S and dP (st, dp) at `slot` of the dots, with
// the row's statistics and the key's flag; st becomes ds, which also goes
// back into the slot (in place of ae) for phase C
__device__ __forceinline__ void dq_p_ds(float& st, float dp,
                                        float* __restrict__ dots, int slot,
                                        int dpe_off, float qb, float lse,
                                        float delta, float val) {
  float s = (st + dots[slot]) + qb;
  s = val != 0.f ? s : kNeg;
  const float p = expf(s - lse);
  const float ds = p * ((dp + dots[slot + dpe_off]) - delta) * val;
  dots[slot] = ds;
  st = ds;
}

// A unit's row statistics (rows g and g + 8 of its head, from the
// block's stats) and the lane's dqb row sums, stored at the end.
struct DqRows {
  float qb[2], lse[2], delta[2], sum[2] = {0.f, 0.f};

  __device__ void read(const float* __restrict__ stats, int h, int hg) {
    const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qb[r] = stats[h * kDqQueries + g + 8 * r];
      lse[r] = stats[(hg + h) * kDqQueries + g + 8 * r];
      delta[r] = stats[(2 * hg + h) * kDqQueries + g + 8 * r];
    }
  }

  // the row sums over the four lanes of a row, in a fixed order; lane
  // cq = 0 writes them (the whole warp calls this)
  __device__ void store(float* __restrict__ dqb, size_t bh, int L,
                        int row0) const {
    const int lane = threadIdx.x & 31, g = lane >> 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float s = sum[r];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const int row = row0 + g + 8 * r;
      if ((lane & 3) == 0 && row < L) dqb[bh * L + row] = s;
    }
  }
};

// the running dQ of unit w (lane's fragments, [HD/8][4][32]) += part,
// in fp32
template <int HD>
__device__ __forceinline__ void dq_add(float* __restrict__ dqacc,
                                       const float (&part)[HD / 8][4]) {
  float* at = dqacc + (threadIdx.x >> 5) * kDqQueries * HD + (threadIdx.x & 31);
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) at[(d * 4 + e) * 32] += part[d][e];
}

// Phase B's state and work of a warp, by input dtype.
template <typename T, int HD>
struct DqUnits;

// bf16: warp w takes the unit (head w, 16 queries); its Q and dO A
// fragments (rows: queries) by ldmatrix from the staged rows each tile;
// each tile's dQ begun at zero and added to the running dQ.
template <int HD>
struct DqUnits<__nv_bfloat16, HD> {
  using T = __nv_bfloat16;
  static constexpr int KQ = HD / 16, LD = q_ld<HD>();
  DqRows rs;

  __device__ void tile(const T* __restrict__ kvs, const T* __restrict__ qdo,
                       float* __restrict__ dots, float* __restrict__ dqacc,
                       const float* __restrict__ stats,
                       const float* __restrict__ kval, int nh, int hg) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int g = lane >> 2, c = 2 * (lane & 3);
    if (w >= nh) return;
    rs.read(stats, w, hg);
    const T* ks = kvs + w * kDqKeys * flash::pad_ld<T, HD>();
    const T* vs = kvs + (hg + w) * kDqKeys * flash::pad_ld<T, HD>();
    const T* qs = qdo + w * kDqQueries * LD;
    const T* gs = qdo + (hg + w) * kDqQueries * LD;
    float st[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      const int at = ((lane & 7) + (lane >> 4) * 8) * flash::pad_ld<T, HD>() +
                     kk * 16 + ((lane >> 3) & 1) * 8;
      const int aq = (lane & 15) * LD + kk * 16 + (lane >> 4) * 8;
      uint32_t a[4], bk[4];
      flash::ldmatrix_x4(a, qs + aq);
      flash::ldmatrix_x4(bk, ks + at);
      flash::mma_bf16(st[0], a, bk[0], bk[1]);
      flash::mma_bf16(st[1], a, bk[2], bk[3]);
      flash::ldmatrix_x4(a, gs + aq);
      flash::ldmatrix_x4(bk, vs + at);
      flash::mma_bf16(dp[0], a, bk[0], bk[1]);
      flash::mma_bf16(dp[1], a, bk[2], bk[3]);
    }
    // element e of n-tile n: query g + 8 (e >> 1), key 8n + c + (e & 1)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, j = 8 * n + c + (e & 1);
        dq_p_ds(st[n][e], dp[n][e], dots, dot_slot(w, g + 8 * r, j),
                hg * kDqPairs, rs.qb[r], rs.lse[r], rs.delta[r], kval[j]);
        rs.sum[r] += st[n][e];
      }
    uint32_t pa[4];  // dS rounded to bf16, the A fragment over the keys
    flash::pack_a(pa, st[0], st[1]);
    float part[HD / 8][4] = {};
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      const int at = ((lane & 7) + ((lane >> 3) & 1) * 8) *
                         flash::pad_ld<T, HD>() +
                     np * 16 + (lane >> 4) * 8;
      uint32_t bt[4];
      flash::ldmatrix_x4_trans(bt, ks + at);
      flash::mma_bf16(part[2 * np], pa, bt[0], bt[1]);
      flash::mma_bf16(part[2 * np + 1], pa, bt[2], bt[3]);
    }
    dq_add<HD>(dqacc, part);
  }

  __device__ void store(T* __restrict__ dq, float* __restrict__ dqb,
                        const float* __restrict__ dqacc, size_t bh0, int nh,
                        int L, int row0) const {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int g = lane >> 2, c = 2 * (lane & 3);
    if (w >= nh) return;
    rs.store(dqb, bh0 + w, L, row0);
    const float* acc = dqacc + w * kDqQueries * HD + lane;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= L) continue;
      T* out = dq + ((bh0 + w) * L + row) * HD + c;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        *reinterpret_cast<uint32_t*>(out + 8 * d) = flash::pack_bf16(
            acc[(d * 4 + 2 * r) * 32], acc[(d * 4 + 2 * r + 1) * 32]);
    }
  }
};

// fp32: warp w takes the unit (head w, 16 queries); its Q and dO tf32 A
// fragments (dims 8k + 2cq and + 1 in columns cq and cq + 4, one 8-byte
// load) from the staged rows each tile, split big + small; each product
// as three tf32 products, the smaller terms first; each tile's dQ as in
// bf16.
template <int HD>
struct DqUnits<float, HD> {
  static constexpr int LD = q_ld<HD>();
  static constexpr int LK = flash::pad_ld<float, HD>();
  DqRows rs;

  __device__ void tile(const float* __restrict__ kvs,
                       const float* __restrict__ qdo,
                       float* __restrict__ dots, float* __restrict__ dqacc,
                       const float* __restrict__ stats,
                       const float* __restrict__ kval, int nh, int hg) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int g = lane >> 2, cq = lane & 3;
    if (w >= nh) return;
    rs.read(stats, w, hg);
    const float* ks = kvs + w * kDqKeys * LK;
    const float* vs = kvs + (hg + w) * kDqKeys * LK;
    const float* qs = qdo + w * kDqQueries * LD + g * LD + 2 * cq;
    const float* gs = qdo + (hg + w) * kDqQueries * LD + g * LD + 2 * cq;
    float st[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dp[n][e] = 0.f;
    tf32x3_products<HD, LD, LK>(st, qs, ks);
    tf32x3_products<HD, LD, LK>(dp, gs, vs);
    // element e of n-tile n: query g + 8 (e >> 1), key 8n + 2cq + (e & 1)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, j = 8 * n + 2 * cq + (e & 1);
        dq_p_ds(st[n][e], dp[n][e], dots, dot_slot(w, g + 8 * r, j),
                hg * kDqPairs, rs.qb[r], rs.lse[r], rs.delta[r], kval[j]);
        rs.sum[r] += st[n][e];
      }
    // dQ += dS.K in k-steps of 8 keys: A (query g, key 8kt + 2cq) in
    // column cq and key 8kt + 2cq + 1 in column cq + 4, straight from the
    // accumulator of S's n-tile kt; B (those keys, dim 8nt + g)
    float part[HD / 8][4];
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      uint32_t ab[4], as[4];
      tf32_split(st[kt][0], ab[0], as[0]);
      tf32_split(st[kt][2], ab[1], as[1]);
      tf32_split(st[kt][1], ab[2], as[2]);
      tf32_split(st[kt][3], ab[3], as[3]);
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        const float* kr = ks + (8 * kt + 2 * cq) * LK + 8 * nt + g;
        uint32_t b0, s0, b1, s1;
        tf32_split(kr[0], b0, s0);
        tf32_split(kr[LK], b1, s1);
        hopper::mma_tf32(part[nt], as, b0, b1);
        hopper::mma_tf32(part[nt], ab, s0, s1);
        hopper::mma_tf32(part[nt], ab, b0, b1);
      }
    }
    dq_add<HD>(dqacc, part);
  }

  __device__ void store(float* __restrict__ dq, float* __restrict__ dqb,
                        const float* __restrict__ dqacc, size_t bh0, int nh,
                        int L, int row0) const {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int g = lane >> 2, cq = lane & 3;
    if (w >= nh) return;
    rs.store(dqb, bh0 + w, L, row0);
    const float* acc = dqacc + w * kDqQueries * HD + lane;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= L) continue;
      float* out = dq + ((bh0 + w) * L + row) * HD + 2 * cq;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        *reinterpret_cast<float2*>(out + 8 * d) = make_float2(
            acc[(d * 4 + 2 * r) * 32], acc[(d * 4 + 2 * r + 1) * 32]);
    }
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(32 * kDqWarps<T>(), 1)
    rel_dq_kernel(const T* __restrict__ q, const float* __restrict__ qt,
                  const float* __restrict__ qb, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ x0,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ freqs,
                  const float* __restrict__ lse, const T* __restrict__ dout,
                  const float* __restrict__ doe,
                  const float* __restrict__ delta, int H, int L, int XF,
                  int hg, T* __restrict__ dq, float* __restrict__ dqt,
                  float* __restrict__ dqb) {
  constexpr int E = HD, LDH = qt_ld<HD>(), EQ = kDqKeys * emb_ld<HD>();
  extern __shared__ __align__(16) float smem[];
  const DqSmem<T, HD> sm(hg);
  float* qtd = smem + sm.qtd;
  T* qdo = reinterpret_cast<T*>(smem + sm.qdo);
  T* kvs = reinterpret_cast<T*>(smem + sm.kv);
  float* dots = smem + sm.dots;
  float* dqacc = smem + sm.dqacc;
  float* embs = smem + sm.emb;
  float* stats = smem + sm.stats;
  float* xqs = smem + sm.xq;
  float* xks = smem + sm.xk;
  float* kvals = smem + sm.kval;
  float* fr = smem + sm.freqs;

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int b = blockIdx.z, h0 = blockIdx.y * hg;
  const int nh = min(hg, H - h0);
  const int row0 = blockIdx.x * kDqQueries;
  const size_t bh0 = (size_t)b * H + h0;
  const float* x0b = x0 + (size_t)b * L * XF;
  const uint8_t* mb = mask + (size_t)b * L;
  const T* kg = k + bh0 * L * HD;
  const T* vg = v + bh0 * L * HD;
  const int nt = (L + kDqKeys - 1) / kDqKeys;

  // the resident qt/doe and Q/dO rows (zeros past L), the first K/V tile
  {
    constexpr int C4 = HD / 4;  // 16-byte chunks a row
    const int per = nh * kDqQueries * C4;
    for (int c = threadIdx.x; c < 2 * per; c += blockDim.x) {
      const int tn = c / per, hh = (c % per) / (kDqQueries * C4);
      const int r = (c / C4) % kDqQueries, e = (c % C4) * 4;
      const bool in = row0 + r < L;
      const float* src = (tn ? doe : qt) +
                         ((bh0 + hh) * L + (in ? row0 + r : 0)) * HD + e;
      flash::cp_async16(qtd + (tn * hg + hh) * LDH + r * HD + e, src,
                        in ? 16 : 0);
    }
  }
  load_rows<T, HD, kDqQueries, q_ld<HD>()>(qdo, q + bh0 * L * HD, nh,
                                                  L, row0);
  load_rows<T, HD, kDqQueries, q_ld<HD>()>(
      qdo + hg * kDqQueries * q_ld<HD>(), dout + bh0 * L * HD, nh, L, row0);
  load_kv<T, HD>(kvs, kg, vg, nh, hg, L, 0);
  for (int f = threadIdx.x; f < HD / 2; f += blockDim.x) fr[f] = freqs[f];
  dq_key_rows(xks, kvals, x0b, mb, XF, L, 0);
  dq_query_rows(stats, xqs, qb, lse, delta, x0b, XF, bh0, nh, hg, L, row0);
  for (int e = threadIdx.x; e < hg * kDqQueries * HD; e += blockDim.x)
    dqacc[e] = 0.f;
  // the warp's queries in phases A and C, w + kDqWarps<T>() task, and
  // their running dqt
  constexpr int QW = kDqQueries / kDqWarps<T>();
  float dqta[QW][E / 8][4];
#pragma unroll
  for (int task = 0; task < QW; ++task)
#pragma unroll
    for (int n = 0; n < E / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqta[task][n][e] = 0.f;
  DqUnits<T, HD> units;
  flash::cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int task = 0; task < QW; ++task) {
    const int i = w + kDqWarps<T>() * task;
    dq_phase_a<HD>(qtd, dots, embs + i * EQ, fr, xqs + 4 * i, xks, i, nh,
                   hg);
  }

  for (int t = 0; t < nt; ++t) {
    const int nb = (t + 1) & 1;  // the buffer of tile t + 1's key rows
    const bool next = t + 1 < nt;
    if (next)
      dq_key_rows(xks + nb * 4 * kDqKeys, kvals + nb * kDqKeys, x0b, mb, XF,
                  L, (t + 1) * kDqKeys);
    flash::cp_async_wait_all();  // this tile's K/V
    __syncthreads();             // and phase A's dots and embeddings
    units.tile(kvs, qdo, dots, dqacc, stats, kvals + (t & 1) * kDqKeys, nh,
               hg);
    __syncthreads();  // ds in the dots' slots; the K/V tile is free
    if (next) load_kv<T, HD>(kvs, kg, vg, nh, hg, L, (t + 1) * kDqKeys);
#pragma unroll
    for (int task = 0; task < QW; ++task) {
      const int i = w + kDqWarps<T>() * task;
      float* embq = embs + i * EQ;
      dq_phase_c<HD>(dots, embq, dqta[task], i, nh);
      if (next) {
        __syncwarp();  // phase C's reads of this query's slots and buffer
        dq_phase_a<HD>(qtd, dots, embq, fr, xqs + 4 * i,
                       xks + nb * 4 * kDqKeys, i, nh, hg);
      }
    }
  }

  units.store(dq, dqb, dqacc, bh0, nh, L, row0);
#pragma unroll
  for (int task = 0; task < QW; ++task) {
    const int row = row0 + w + kDqWarps<T>() * task;
    if (row >= L) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int h = g + 8 * r;
      if (h >= nh) continue;
      float* out = dqt + ((bh0 + h) * L + row) * HD + 2 * cq;
#pragma unroll
      for (int n = 0; n < E / 8; ++n)
        *reinterpret_cast<float2*>(out + 8 * n) = make_float2(
            dqta[task][n][2 * r], dqta[task][n][2 * r + 1]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* qt, const void* qb,
                      const void* k, const void* v, const void* x0,
                      const void* mask, const void* freqs, const void* lse,
                      const void* dout, const void* doe, const void* delta,
                      int B, int H, int L, int XF, void* dq, void* dqt,
                      void* dqb, cudaStream_t stream) {
  if (!flash::aligned16(q, qt, k, v) || !flash::aligned16(dout, doe, dq, dqt))
    return cudaErrorMisalignedAddress;
  int groups, hg;
  head_groups(H, kDqHeads<T, HD>(), &groups, &hg);
  const size_t bytes = dq_smem_bytes<T, HD>(hg);
  auto kern = rel_dq_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kDqQueries - 1) / kDqQueries, groups, B);
  const int threads = 32 * kDqWarps<T>();
  kern<<<grid, threads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const float*>(qt),
      static_cast<const float*>(qb), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(x0),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(freqs),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const float*>(doe), static_cast<const float*>(delta), H, L,
      XF, hg, static_cast<T*>(dq), static_cast<float*>(dqt),
      static_cast<float*>(dqb));
  return cudaGetLastError();
}

}  // namespace
}  // namespace relattn

// q, k, v, dout, dq, dk, dv: [B, H, L, HD] of float (bf16 = 0) or
// bfloat16 (bf16 = 1); qt, doe, dqt: [B, H, L, HD] float; qb, lse,
// delta, dqb: [B, H, L] float; x0: [B, L, XF] float; mask: [B, L]
// uint8; freqs: [HD / 2] float.  Each returns a cudaError_t.
#define REL_DISPATCH(CALL)                                 \
  if (B == 0 || L == 0 || H == 0) return 0;                \
  if (H < 0 || XF < 4) return (int)cudaErrorInvalidValue;  \
  if (HD == 16 && !bf16) return (int)CALL(float, 16);      \
  if (HD == 32 && !bf16) return (int)CALL(float, 32);      \
  if (HD == 64 && !bf16) return (int)CALL(float, 64);      \
  if (HD == 16 && bf16) return (int)CALL(__nv_bfloat16, 16); \
  if (HD == 32 && bf16) return (int)CALL(__nv_bfloat16, 32); \
  if (HD == 64 && bf16) return (int)CALL(__nv_bfloat16, 64); \
  return (int)cudaErrorInvalidValue

extern "C" int rel_bwd_dq_launch(const void* q, const void* qt,
                                 const void* qb, const void* k,
                                 const void* v, const void* x0,
                                 const void* mask, const void* freqs,
                                 const void* lse, const void* dout,
                                 const void* doe, const void* delta, int B,
                                 int H, int L, int HD, int XF, int bf16,
                                 void* dq, void* dqt, void* dqb,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ(T, D)                                                           \
  relattn::launch_dq<T, D>(q, qt, qb, k, v, x0, mask, freqs, lse, dout, doe, \
                           delta, B, H, L, XF, dq, dqt, dqb, s)
  REL_DISPATCH(DQ);
#undef DQ
}


extern "C" int rel_bwd_dkv_launch(const void* q, const void* qt,
                                  const void* qb, const void* k,
                                  const void* v, const void* x0,
                                  const void* mask, const void* freqs,
                                  const void* lse, const void* dout,
                                  const void* doe, const void* delta, int B,
                                  int H, int L, int HD, int XF, int bf16,
                                  void* dk, void* dv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV(T, D)                                                           \
  relattn::launch_dkv<T, D>(q, qt, qb, k, v, x0, mask, freqs, lse, dout, doe, \
                            delta, B, H, L, XF, dk, dv, s)
  REL_DISPATCH(DKV);
#undef DKV
}

// The dynamic shared memory of a launch over H heads at head dim HD (0
// for a head dim the kernels are not built for).
extern "C" int rel_bwd_dq_smem_bytes(int HD, int H) {
  // the larger of a bf16 and a fp32 launch's (bf16's at 12 and 24 heads)
  int groups, hb, hf;
#define SMEM(D)                                                            \
  (relattn::head_groups(H, relattn::kDqHeads<__nv_bfloat16, D>(), &groups, \
                        &hb),                                              \
   relattn::head_groups(H, relattn::kDqHeads<float, D>(), &groups, &hf),   \
   (int)std::max(relattn::dq_smem_bytes<__nv_bfloat16, D>(hb),             \
                 relattn::dq_smem_bytes<float, D>(hf)))
  if (HD == 16) return SMEM(16);
  if (HD == 32) return SMEM(32);
  if (HD == 64) return SMEM(64);
#undef SMEM
  return 0;
}

extern "C" int rel_bwd_dkv_smem_bytes(int HD, int bf16, int H) {
  int groups, hg;
#define SMEM(T, D)                                                    \
  (relattn::head_groups(H, relattn::kDkvHeads<T, D>(), &groups, &hg), \
   (int)relattn::dkv_smem_bytes<T, D>(hg))
  if (HD == 16) return bf16 ? SMEM(__nv_bfloat16, 16) : SMEM(float, 16);
  if (HD == 32) return bf16 ? SMEM(__nv_bfloat16, 32) : SMEM(float, 32);
  if (HD == 64) return bf16 ? SMEM(__nv_bfloat16, 64) : SMEM(float, 64);
#undef SMEM
  return 0;
}
