// Backward of the masked softmax attention (flash_attention.cu), for
// Hopper: dQ, and dK with dV.
//
// Replaces the TPU kernels graphnet_tpu/ops/flash_attention.py:
// _bwd_dq_kernel and _bwd_dkv_kernel.  Same contract: the probabilities
// are recomputed from the forward's lse, p = exp(logit - lse), with the
// logits formed as in the forward (q scaled in its dtype, a masked key
// at -1e5); dp = g.v; ds = p * (dp - delta) * valid, so a masked key
// passes no gradient through its logit while dv still takes its p;
// delta = sum(g * o) comes in from the wrapper.  dq = (sum ds.k) * scale,
// rounded once at the end; dk = sum ds.(q*scale) with no second scale;
// dv = sum p.g.  ds and p are rounded to the input dtype before their
// products, which accumulate in fp32.
//
// The split is the TPU's, and it is what keeps the kernels free of
// floating-point atomics: the dq kernel owns query rows and streams keys
// and values; the dkv kernel owns key rows and streams queries, output
// gradients, lse and delta.  Every sum runs in a fixed order, so two
// runs give the same bits.
//
// dq: 64 query rows per block; key and value tiles of 64 stream in
// double-buffered by 16-byte cp.async (flash_mma.cuh) with their key
// flags.  Bound: 6*B*H*L^2*Dh flops (three products), 13 us in bf16 and
// 0.19 ms in fp32 at TITO's shape, and B*H*L^2 exponentials, as dkv's.
// bf16 on the tensor cores (dS never leaves the registers), fp32 on the
// CUDA cores with register micro-tiles; see the notes at the kernels.
//
// dkv: 64 key rows per block; query tiles of 64 stream in
// double-buffered by 16-byte cp.async (flash_mma.cuh), the next in
// flight while the block works on this one, with their lse and delta.
// Bound: 8*B*H*L^2*Dh flops (four products), 17 us in bf16 and 0.26 ms
// in fp32 at TITO's shape (B*H = 64, L = 1024, Dh = 32), and B*H*L^2
// exponentials (~17 us on the SFUs), so in bf16 the exponentials and
// the products weigh about the same (p = __expf(s - lse), as in the
// forward).  bf16 runs on the tensor cores
// (mma.sync.m16n8k16; P^T and dS^T never leave the registers), fp32 on
// the CUDA cores in full fp32 with register micro-tiles; see the notes
// at the two kernels.
//
// Head dims 16, 32 and 64.  At 16 the bf16 kernels take their one k-step
// of K.Q^T and one n-tile pair of the dV, dK (dQ) products as they are;
// the fp32 dq keeps one dQ column a thread; the fp32 dkv splits the
// queries of a tile among eight groups, whose partial sums need a little
// more shared memory than the tiles (dkv_f32_smem_bytes).

#include "flash_attention.cuh"
#include "flash_mma.cuh"

namespace flash {
namespace {

// key rows a dkv block owns, and a dq block's streamed key tile; query
// rows a dq block owns, and a dkv block's streamed query tile
constexpr int kBlockK = 64;
constexpr int kBlockQ = 64;

// ------------------------------------------------------------ dK, dV

// dkv, bf16: tensor cores.  Four warps of 16 keys each hold their K and
// V rows as mma A fragments.  Per 16 queries of the streamed tile:
// S^T = K.Q_scaled^T and dP^T = V.G^T (Q and G read by ldmatrix),
// P^T = exp(S^T - lse) with the block's masked keys at -1e5,
// dS^T = round(P^T * (dP^T - delta) * valid); then dV += round(P^T).G
// and dK += dS^T.Q_scaled with the P^T and dS^T accumulators repacked
// as A fragments and G, Q_scaled read by ldmatrix.trans.
template <int DH>
constexpr size_t dkv_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * kBlockK + 4 * kBlockQ) *
             pad_ld<__nv_bfloat16, DH>() +
         sizeof(float) * 4 * kBlockQ;
}

template <int DH>
__global__ void __launch_bounds__(128)
    flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const uint8_t* __restrict__ mask,  // [B, L]
                         const float* __restrict__ lse,     // [B*H, L]
                         const __nv_bfloat16* __restrict__ g,
                         const float* __restrict__ delta,   // [B*H, L]
                         int H, int L, float scale,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv) {
  using T = __nv_bfloat16;
  constexpr int LD = pad_ld<T, DH>();
  constexpr int KS = DH / 16;  // k-steps of K.Q^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [kBlockK][LD]
  T* vs = ks + kBlockK * LD;               // [kBlockK][LD]
  T* qs = vs + kBlockK * LD;               // [2][kBlockQ][LD]
  T* gs = qs + 2 * kBlockQ * LD;           // [2][kBlockQ][LD]
  float* ls = reinterpret_cast<float*>(gs + 2 * kBlockQ * LD);  // [2][kBlockQ]
  float* dl = ls + 2 * kBlockQ;                                 // [2][kBlockQ]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, c = 2 * (lane & 3);
  const int bh = blockIdx.y, k0 = blockIdx.x * kBlockK;
  const size_t base = (size_t)bh * L * DH;
  const uint8_t* m = mask + (size_t)(bh / H) * L;
  const float* lse_b = lse + (size_t)bh * L;
  const float* delta_b = delta + (size_t)bh * L;
  const int nt = (L + kBlockQ - 1) / kBlockQ;
  // the lane's key rows gq and gq + 8 of the warp's 16
  float valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + gq + 8 * r;
    valid[r] = (key < L && m[key]) ? 1.f : 0.f;
  }

  load_tile<T, DH, kBlockK>(ks, k + base, k0, L);
  load_tile<T, DH, kBlockK>(vs, v + base, k0, L);
  load_tile<T, DH, kBlockQ>(qs, q + base, 0, L);
  load_tile<T, DH, kBlockQ>(gs, g + base, 0, L);
  cp_async_commit();
  load_row_stats(ls, dl, lse_b, delta_b, 0, L, kBlockQ);

  uint32_t ka[KS][4], va[KS][4];
  float dka[DH / 8][4], dva[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;
  const float scale_t = round_t<T>(scale);

  for (int t = 0; t < nt; ++t) {
    const int cur = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + 1 < nt) {
      const int nxt = cur ^ 1, r0 = (t + 1) * kBlockQ;
      load_tile<T, DH, kBlockQ>(qs + nxt * kBlockQ * LD, q + base, r0, L);
      load_tile<T, DH, kBlockQ>(gs + nxt * kBlockQ * LD, g + base, r0, L);
      cp_async_commit();
      load_row_stats(ls + nxt * kBlockQ, dl + nxt * kBlockQ, lse_b, delta_b,
                     r0, L, kBlockQ);
    }
    T* qt = qs + cur * kBlockQ * LD;
    const T* gt = gs + cur * kBlockQ * LD;
    const float* lt = ls + cur * kBlockQ;
    const float* dt = dl + cur * kBlockQ;
    scale_tile<T, DH, kBlockQ>(qt, scale_t);
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int at =
            (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
        ldmatrix_x4(ka[kk], ks + at);
        ldmatrix_x4(va[kk], vs + at);
      }
    }
    __syncthreads();

#pragma unroll
    for (int ch = 0; ch < kBlockQ / 16; ++ch) {
      // S^T and dP^T for the warp's 16 keys and queries 16 ch .. + 15
      float st[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int at = (ch * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                       ((lane >> 3) & 1) * 8;
        uint32_t b[4];
        ldmatrix_x4(b, qt + at);
        mma_bf16(st[0], ka[kk], b[0], b[1]);
        mma_bf16(st[1], ka[kk], b[2], b[3]);
        ldmatrix_x4(b, gt + at);
        mma_bf16(dp[0], va[kk], b[0], b[1]);
        mma_bf16(dp[1], va[kk], b[2], b[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = ch * 16 + n * 8 + c + (e & 1);
          const float val = valid[e >> 1];
          const float p = __expf((val != 0.f ? st[n][e] : kNeg) - lt[i]);
          st[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dt[i]) * val;
        }
      uint32_t pa[4], da[4];
      pack_a(pa, st[0], st[1]);
      pack_a(da, dp[0], dp[1]);
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) {
        const int at = (ch * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                       np * 16 + (lane >> 4) * 8;
        uint32_t b[4];
        ldmatrix_x4_trans(b, gt + at);
        mma_bf16(dva[2 * np], pa, b[0], b[1]);
        mma_bf16(dva[2 * np + 1], pa, b[2], b[3]);
        ldmatrix_x4_trans(b, qt + at);
        mma_bf16(dka[2 * np], da, b[0], b[1]);
        mma_bf16(dka[2 * np + 1], da, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + gq + 8 * r;
    if (key < L) {
      const size_t at = base + (size_t)key * DH + c;
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        *reinterpret_cast<uint32_t*>(dk + at + d * 8) =
            pack_bf16(dka[d][2 * r], dka[d][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + at + d * 8) =
            pack_bf16(dva[d][2 * r], dva[d][2 * r + 1]);
      }
    }
  }
}

// dkv, fp32: CUDA cores in full fp32.  256 threads as a 16 x 16 grid
// compute 4 x 4 micro-tiles of S^T and dP^T (keys ty + 16i, queries
// tx + 16j, float4 reads along Dh) and write P^T and dS^T into shared
// memory.  For dK and dV the threads then form NG groups, each taking
// 64 / NG of the tile's queries; a thread accumulates 8 keys x 4 dims
// of dK and of dV (64 accumulators, 24 shared-memory reads for 256 FMAs
// a step of 4 queries: one row of 4 dims a thread covered the same
// step with 16 reads for 64).  The groups' partial sums meet once, at
// the end, added in group order.
constexpr int kPld = kBlockQ + 4;  // row stride of the staged P^T, dS^T

// groups of the dK, dV step: a group is 8 key rows x DH / 4 threads
template <int DH>
__host__ __device__ constexpr int dkv_f32_groups() {
  return 256 / (DH / 4 * 8);
}

// the tiles, or at DH = 16 (eight groups) the K and V tiles and the
// partial sums of groups 1 .. 7, which then need more than the tiles
template <int DH>
constexpr size_t dkv_f32_smem_bytes() {
  constexpr size_t tiles =
      (2 * kBlockK + 4 * kBlockQ) * pad_ld<float, DH>() + 2 * kBlockK * kPld +
      4 * kBlockQ;
  constexpr size_t partials = 2 * kBlockK * pad_ld<float, DH>() +
                              (size_t)(dkv_f32_groups<DH>() - 1) * 2 *
                                  kBlockK * DH;
  return sizeof(float) * (tiles > partials ? tiles : partials);
}

template <int DH>
__global__ void __launch_bounds__(256, DH <= 32 ? 2 : 1)
    flash_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const uint8_t* __restrict__ mask,  // [B, L]
                         const float* __restrict__ lse,     // [B*H, L]
                         const float* __restrict__ g,
                         const float* __restrict__ delta,   // [B*H, L]
                         int H, int L, float scale,
                         float* __restrict__ dk, float* __restrict__ dv) {
  constexpr int LD = pad_ld<float, DH>();
  constexpr int TXN = DH / 4;          // threads across the dims of a group
  constexpr int GT = TXN * 8;          // threads of a group: 8 key rows
  constexpr int NG = dkv_f32_groups<DH>();  // groups
  constexpr int QG = kBlockQ / NG;     // queries of a tile per group
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [kBlockK][LD]
  float* vs = ks + kBlockK * LD;                   // [kBlockK][LD]
  float* qs = vs + kBlockK * LD;                   // [2][kBlockQ][LD]
  float* gs = qs + 2 * kBlockQ * LD;               // [2][kBlockQ][LD]
  float* ps = gs + 2 * kBlockQ * LD;               // [kBlockK][kPld]
  float* dss = ps + kBlockK * kPld;                // [kBlockK][kPld]
  float* ls = dss + kBlockK * kPld;                // [2][kBlockQ]
  float* dl = ls + 2 * kBlockQ;                    // [2][kBlockQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // dK, dV: group gz, keys ky + 8 i, dims 4 dx .. 4 dx + 3
  const int gz = threadIdx.x / GT, dx = threadIdx.x % TXN,
            ky = (threadIdx.x % GT) / TXN;
  const int bh = blockIdx.y, k0 = blockIdx.x * kBlockK;
  const size_t base = (size_t)bh * L * DH;
  const uint8_t* m = mask + (size_t)(bh / H) * L;
  const float* lse_b = lse + (size_t)bh * L;
  const float* delta_b = delta + (size_t)bh * L;
  const int nt = (L + kBlockQ - 1) / kBlockQ;
  float valid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    valid[i] = (key < L && m[key]) ? 1.f : 0.f;
  }

  load_tile<float, DH, kBlockK>(ks, k + base, k0, L);
  load_tile<float, DH, kBlockK>(vs, v + base, k0, L);
  load_tile<float, DH, kBlockQ>(qs, q + base, 0, L);
  load_tile<float, DH, kBlockQ>(gs, g + base, 0, L);
  cp_async_commit();
  load_row_stats(ls, dl, lse_b, delta_b, 0, L, kBlockQ);

  float dka[8][4], dva[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int cur = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every thread is done with t - 1
    if (t + 1 < nt) {
      const int nxt = cur ^ 1, r0 = (t + 1) * kBlockQ;
      load_tile<float, DH, kBlockQ>(qs + nxt * kBlockQ * LD, q + base, r0, L);
      load_tile<float, DH, kBlockQ>(gs + nxt * kBlockQ * LD, g + base, r0, L);
      cp_async_commit();
      load_row_stats(ls + nxt * kBlockQ, dl + nxt * kBlockQ, lse_b, delta_b,
                     r0, L, kBlockQ);
    }
    float* qt = qs + cur * kBlockQ * LD;
    const float* gt = gs + cur * kBlockQ * LD;
    const float* lt = ls + cur * kBlockQ;
    const float* dt = dl + cur * kBlockQ;
    scale_tile<float, DH, kBlockQ>(qt, scale);
    __syncthreads();

    // S^T and dP^T micro-tiles: keys ty + 16 i, queries tx + 16 j
    float st[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = ld4(ks + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = ld4(qt + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(a[i].x, b[j].x, st[i][j]);
          st[i][j] = fmaf(a[i].y, b[j].y, st[i][j]);
          st[i][j] = fmaf(a[i].z, b[j].z, st[i][j]);
          st[i][j] = fmaf(a[i].w, b[j].w, st[i][j]);
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = ld4(vs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = ld4(gt + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dp[i][j] = fmaf(a[i].x, b[j].x, dp[i][j]);
          dp[i][j] = fmaf(a[i].y, b[j].y, dp[i][j]);
          dp[i][j] = fmaf(a[i].z, b[j].z, dp[i][j]);
          dp[i][j] = fmaf(a[i].w, b[j].w, dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = tx + 16 * j;
        const float p = __expf((valid[i] != 0.f ? st[i][j] : kNeg) - lt[qi]);
        ps[(ty + 16 * i) * kPld + qi] = p;
        dss[(ty + 16 * i) * kPld + qi] = p * (dp[i][j] - dt[qi]) * valid[i];
      }
    __syncthreads();

    // dV += P^T.G, dK += dS^T.Q_scaled over the group's queries
#pragma unroll 1
    for (int qq = gz * QG; qq < (gz + 1) * QG; qq += 4) {
      float wg[4][4], wq[4][4];  // rows qq .. qq + 3 of G and Q_scaled
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 x = ld4(gt + (qq + u) * LD + 4 * dx);
        const float4 y = ld4(qt + (qq + u) * LD + 4 * dx);
        wg[u][0] = x.x, wg[u][1] = x.y, wg[u][2] = x.z, wg[u][3] = x.w;
        wq[u][0] = y.x, wq[u][1] = y.y, wq[u][2] = y.z, wq[u][3] = y.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 p = ld4(ps + (ky + 8 * i) * kPld + qq);
        const float4 s = ld4(dss + (ky + 8 * i) * kPld + qq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dva[i][e] = fmaf(p.x, wg[0][e], dva[i][e]);
          dva[i][e] = fmaf(p.y, wg[1][e], dva[i][e]);
          dva[i][e] = fmaf(p.z, wg[2][e], dva[i][e]);
          dva[i][e] = fmaf(p.w, wg[3][e], dva[i][e]);
          dka[i][e] = fmaf(s.x, wq[0][e], dka[i][e]);
          dka[i][e] = fmaf(s.y, wq[1][e], dka[i][e]);
          dka[i][e] = fmaf(s.z, wq[2][e], dka[i][e]);
          dka[i][e] = fmaf(s.w, wq[3][e], dka[i][e]);
        }
      }
    }
  }

  // the groups' partial sums, added in group order by group 0; the
  // tiles' buffers (from qs on) hold the partials of groups 1 .. NG - 1
  // (dkv_f32_smem_bytes makes room for them)
  __syncthreads();
  float* red = qs;  // [NG - 1][2][kBlockK][DH]
  if (gz > 0) {
    float* r = red + (size_t)(gz - 1) * 2 * kBlockK * DH;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int at = (ky + 8 * i) * DH + 4 * dx;
      *reinterpret_cast<float4*>(r + at) =
          make_float4(dka[i][0], dka[i][1], dka[i][2], dka[i][3]);
      *reinterpret_cast<float4*>(r + kBlockK * DH + at) =
          make_float4(dva[i][0], dva[i][1], dva[i][2], dva[i][3]);
    }
  }
  __syncthreads();
  if (gz == 0) {
#pragma unroll 1
    for (int z = 0; z < NG - 1; ++z) {
      const float* r = red + (size_t)z * 2 * kBlockK * DH;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int at = (ky + 8 * i) * DH + 4 * dx;
        const float4 a = ld4(r + at);
        const float4 b = ld4(r + kBlockK * DH + at);
        dka[i][0] += a.x, dka[i][1] += a.y, dka[i][2] += a.z, dka[i][3] += a.w;
        dva[i][0] += b.x, dva[i][1] += b.y, dva[i][2] += b.z, dva[i][3] += b.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int key = k0 + ky + 8 * i;
      if (key < L) {
        const size_t at = base + (size_t)key * DH + 4 * dx;
        *reinterpret_cast<float4*>(dk + at) =
            make_float4(dka[i][0], dka[i][1], dka[i][2], dka[i][3]);
        *reinterpret_cast<float4*>(dv + at) =
            make_float4(dva[i][0], dva[i][1], dva[i][2], dva[i][3]);
      }
    }
  }
}

// ------------------------------------------------------------ dQ

// dq, bf16: tensor cores.  64 query rows per block, four warps of 16,
// each holding its Q_scaled and G rows as mma A fragments and its rows'
// lse and delta in registers; key and value tiles of 64 rows stream in
// double-buffered by cp.async with their key flags.  Per 16 keys of the
// tile: S = Q_scaled.K^T and dP = G.V^T (K and V read by ldmatrix),
// P = exp(S - lse) with masked keys at -1e5, dS = round(P * (dP - delta)
// * valid); then dQ += dS.K with the dS accumulators repacked as an A
// fragment and K read by ldmatrix.trans.  dQ stays in fp32 registers
// and is rounded once, after the scale, at the end.
template <int DH>
constexpr size_t dq_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * kBlockQ + 4 * kBlockK) *
             pad_ld<__nv_bfloat16, DH>() +
         sizeof(float) * 2 * kBlockK;
}

template <int DH>
__global__ void __launch_bounds__(128)
    flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const uint8_t* __restrict__ mask,  // [B, L]
                        const float* __restrict__ lse,     // [B*H, L]
                        const __nv_bfloat16* __restrict__ g,
                        const float* __restrict__ delta,   // [B*H, L]
                        int H, int L, float scale,
                        __nv_bfloat16* __restrict__ dq) {
  using T = __nv_bfloat16;
  constexpr int LD = pad_ld<T, DH>();
  constexpr int KS = DH / 16;  // k-steps of Q.K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kBlockQ][LD]
  T* gs = qs + kBlockQ * LD;               // [kBlockQ][LD]
  T* ks = gs + kBlockQ * LD;               // [2][kBlockK][LD]
  T* vs = ks + 2 * kBlockK * LD;           // [2][kBlockK][LD]
  float* kf = reinterpret_cast<float*>(vs + 2 * kBlockK * LD);  // [2][kBlockK]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, c = 2 * (lane & 3);
  const int bh = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const size_t base = (size_t)bh * L * DH;
  const uint8_t* m = mask + (size_t)(bh / H) * L;
  const int nt = (L + kBlockK - 1) / kBlockK;
  // the lane's query rows gq and gq + 8 of the warp's 16; beyond L
  // lse = +inf and delta = 0, so p and ds are 0 there
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + gq + 8 * r;
    lr[r] = row < L ? lse[(size_t)bh * L + row] : INFINITY;
    dr[r] = row < L ? delta[(size_t)bh * L + row] : 0.f;
  }

  load_tile<T, DH, kBlockQ>(qs, q + base, q0, L);
  load_tile<T, DH, kBlockQ>(gs, g + base, q0, L);
  load_tile<T, DH, kBlockK>(ks, k + base, 0, L);
  load_tile<T, DH, kBlockK>(vs, v + base, 0, L);
  cp_async_commit();
  load_key_flags(kf, m, 0, L, kBlockK);

  uint32_t qa[KS][4], ga[KS][4];
  float acc[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int cur = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + 1 < nt) {
      const int nxt = cur ^ 1, r0 = (t + 1) * kBlockK;
      load_tile<T, DH, kBlockK>(ks + nxt * kBlockK * LD, k + base, r0, L);
      load_tile<T, DH, kBlockK>(vs + nxt * kBlockK * LD, v + base, r0, L);
      cp_async_commit();
      load_key_flags(kf + nxt * kBlockK, m, r0, L, kBlockK);
    }
    if (t == 0) {
      scale_tile<T, DH, kBlockQ>(qs, round_t<T>(scale));
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int at =
            (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
        ldmatrix_x4(qa[kk], qs + at);
        ldmatrix_x4(ga[kk], gs + at);
      }
    }
    const T* kt = ks + cur * kBlockK * LD;
    const T* vt = vs + cur * kBlockK * LD;
    const float* f = kf + cur * kBlockK;

#pragma unroll
    for (int ch = 0; ch < kBlockK / 16; ++ch) {
      // S and dP for the warp's 16 rows and keys 16 ch .. + 15
      float st[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int at = (ch * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                       ((lane >> 3) & 1) * 8;
        uint32_t b[4];
        ldmatrix_x4(b, kt + at);
        mma_bf16(st[0], qa[kk], b[0], b[1]);
        mma_bf16(st[1], qa[kk], b[2], b[3]);
        ldmatrix_x4(b, vt + at);
        mma_bf16(dp[0], ga[kk], b[0], b[1]);
        mma_bf16(dp[1], ga[kk], b[2], b[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float val = f[ch * 16 + n * 8 + c + (e & 1)] > 0.f ? 1.f : 0.f;
          const float p =
              __expf((val != 0.f ? st[n][e] : kNeg) - lr[e >> 1]);
          dp[n][e] = p * (dp[n][e] - dr[e >> 1]) * val;
        }
      uint32_t da[4];
      pack_a(da, dp[0], dp[1]);
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) {
        const int at = (ch * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                       np * 16 + (lane >> 4) * 8;
        uint32_t b[4];
        ldmatrix_x4_trans(b, kt + at);
        mma_bf16(acc[2 * np], da, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], da, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + gq + 8 * r;
    if (row < L) {
      T* out = dq + base + (size_t)row * DH + c;
#pragma unroll
      for (int d = 0; d < DH / 8; ++d)
        *reinterpret_cast<uint32_t*>(out + d * 8) =
            pack_bf16(acc[d][2 * r] * scale, acc[d][2 * r + 1] * scale);
    }
  }
}

// dq, fp32: CUDA cores in full fp32.  256 threads as a 16 x 16 grid
// compute 4 x 4 micro-tiles of S and dP (queries ty + 16i, keys
// tx + 16j, float4 reads along Dh) and write dS into shared memory; the
// same thread then accumulates a 4 x Dh/16 micro-tile of dQ (its four
// rows, dims DN * tx ..) over the tile's keys, as the fp32 forward does
// for O += P.V.
constexpr int kDsLd = kBlockK + 4;  // row stride of the staged dS

template <int DH>
constexpr size_t dq_f32_smem_bytes() {
  return sizeof(float) * ((2 * kBlockQ + 4 * kBlockK) * pad_ld<float, DH>() +
                          kBlockQ * kDsLd + 2 * kBlockK);
}

template <int DH>
__global__ void __launch_bounds__(256, DH <= 32 ? 2 : 1)
    flash_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const uint8_t* __restrict__ mask,  // [B, L]
                        const float* __restrict__ lse,     // [B*H, L]
                        const float* __restrict__ g,
                        const float* __restrict__ delta,   // [B*H, L]
                        int H, int L, float scale,
                        float* __restrict__ dq) {
  constexpr int LD = pad_ld<float, DH>();
  constexpr int DN = DH / 16;  // dims of dQ per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kBlockQ][LD]
  float* gs = qs + kBlockQ * LD;                   // [kBlockQ][LD]
  float* ks = gs + kBlockQ * LD;                   // [2][kBlockK][LD]
  float* vs = ks + 2 * kBlockK * LD;               // [2][kBlockK][LD]
  float* dss = vs + 2 * kBlockK * LD;              // [kBlockQ][kDsLd]
  float* kf = dss + kBlockQ * kDsLd;               // [2][kBlockK]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const size_t base = (size_t)bh * L * DH;
  const uint8_t* m = mask + (size_t)(bh / H) * L;
  const int nt = (L + kBlockK - 1) / kBlockK;
  // rows ty + 16 i: lse (+inf beyond L) and delta (0 beyond L)
  float lr[4], dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lr[i] = row < L ? lse[(size_t)bh * L + row] : INFINITY;
    dr[i] = row < L ? delta[(size_t)bh * L + row] : 0.f;
  }

  load_tile<float, DH, kBlockQ>(qs, q + base, q0, L);
  load_tile<float, DH, kBlockQ>(gs, g + base, q0, L);
  load_tile<float, DH, kBlockK>(ks, k + base, 0, L);
  load_tile<float, DH, kBlockK>(vs, v + base, 0, L);
  cp_async_commit();
  load_key_flags(kf, m, 0, L, kBlockK);

  float acc[4][DN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DN; ++e) acc[i][e] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int cur = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every thread is done with t - 1
    if (t + 1 < nt) {
      const int nxt = cur ^ 1, r0 = (t + 1) * kBlockK;
      load_tile<float, DH, kBlockK>(ks + nxt * kBlockK * LD, k + base, r0, L);
      load_tile<float, DH, kBlockK>(vs + nxt * kBlockK * LD, v + base, r0, L);
      cp_async_commit();
      load_key_flags(kf + nxt * kBlockK, m, r0, L, kBlockK);
    }
    if (t == 0) {
      scale_tile<float, DH, kBlockQ>(qs, scale);
      __syncthreads();
    }
    const float* kt = ks + cur * kBlockK * LD;
    const float* vt = vs + cur * kBlockK * LD;
    const float* f = kf + cur * kBlockK;

    // S and dP micro-tiles: queries ty + 16 i, keys tx + 16 j
    float st[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ld4(kt + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(a[i].x, b[j].x, st[i][j]);
          st[i][j] = fmaf(a[i].y, b[j].y, st[i][j]);
          st[i][j] = fmaf(a[i].z, b[j].z, st[i][j]);
          st[i][j] = fmaf(a[i].w, b[j].w, st[i][j]);
        }
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(gs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ld4(vt + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dp[i][j] = fmaf(a[i].x, b[j].x, dp[i][j]);
          dp[i][j] = fmaf(a[i].y, b[j].y, dp[i][j]);
          dp[i][j] = fmaf(a[i].z, b[j].z, dp[i][j]);
          dp[i][j] = fmaf(a[i].w, b[j].w, dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        const float val = f[key] > 0.f ? 1.f : 0.f;
        const float p = __expf((val != 0.f ? st[i][j] : kNeg) - lr[i]);
        dss[(ty + 16 * i) * kDsLd + key] = p * (dp[i][j] - dr[i]) * val;
      }
    __syncthreads();

    // dQ micro-tile += dS.K
#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float4 s[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = ld4(dss + (ty + 16 * i) * kDsLd + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float w[DN];
        ld_cols<DN>(w, kt + (kk + u) * LD + DN * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float su = at4(s[i], u);
#pragma unroll
          for (int e = 0; e < DN; ++e) acc[i][e] = fmaf(su, w[e], acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < L) {
      float out[DN];
#pragma unroll
      for (int e = 0; e < DN; ++e) out[e] = acc[i][e] * scale;
      st_cols<DN>(dq + base + (size_t)row * DH + DN * tx, out);
    }
  }
}

template <typename T>
cudaError_t launch_dq(void (*kern)(const T*, const T*, const T*,
                                   const uint8_t*, const float*, const T*,
                                   const float*, int, int, float, T*),
                      size_t bytes, int threads, const void* q,
                      const void* k, const void* v, const void* mask,
                      const void* lse, const void* g, const void* delta,
                      int BH, int H, int L, float scale, void* dq,
                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kBlockQ - 1) / kBlockQ, BH);
  kern<<<grid, threads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(lse), static_cast<const T*>(g),
      static_cast<const float*>(delta), H, L, scale, static_cast<T*>(dq));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(
    void (*kern)(const T*, const T*, const T*, const uint8_t*, const float*,
                 const T*, const float*, int, int, float, T*, T*),
    size_t bytes, int threads, const void* q, const void* k, const void* v,
    const void* mask, const void* lse, const void* g, const void* delta,
    int BH, int H, int L, float scale, void* dk, void* dv,
    cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kBlockK - 1) / kBlockK, BH);
  kern<<<grid, threads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(lse), static_cast<const T*>(g),
      static_cast<const float*>(delta), H, L, scale, static_cast<T*>(dk),
      static_cast<T*>(dv));
  return cudaGetLastError();
}

}  // namespace
}  // namespace flash

// q, k, v, g, dq, dk, dv: [BH, L, DH] of float (bf16 = 0) or bfloat16
// (bf16 = 1); mask: [BH / H, L] uint8; lse, delta: [BH, L] float.  Each
// returns a cudaError_t.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   const void* lse, const void* g,
                                   const void* delta, int BH, int H, int L,
                                   int DH, float scale, int bf16, void* dq,
                                   void* stream) {
  using namespace flash;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || L == 0) return 0;
  if (H <= 0 || BH % H) return (int)cudaErrorInvalidValue;
  if (!aligned16(q, k, v, g)) return (int)cudaErrorMisalignedAddress;
#define DQ(KERN, BYTES, THREADS)                                         \
  launch_dq(KERN, BYTES, THREADS, q, k, v, mask, lse, g, delta, BH, H, L, \
            scale, dq, s)
  if (DH == 16 && !bf16)
    return (int)DQ(flash_dq_f32_kernel<16>, dq_f32_smem_bytes<16>(), 256);
  if (DH == 32 && !bf16)
    return (int)DQ(flash_dq_f32_kernel<32>, dq_f32_smem_bytes<32>(), 256);
  if (DH == 64 && !bf16)
    return (int)DQ(flash_dq_f32_kernel<64>, dq_f32_smem_bytes<64>(), 256);
  if (DH == 16 && bf16)
    return (int)DQ(flash_dq_mma_kernel<16>, dq_mma_smem_bytes<16>(), 128);
  if (DH == 32 && bf16)
    return (int)DQ(flash_dq_mma_kernel<32>, dq_mma_smem_bytes<32>(), 128);
  if (DH == 64 && bf16)
    return (int)DQ(flash_dq_mma_kernel<64>, dq_mma_smem_bytes<64>(), 128);
#undef DQ
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    const void* lse, const void* g,
                                    const void* delta, int BH, int H, int L,
                                    int DH, float scale, int bf16, void* dk,
                                    void* dv, void* stream) {
  using namespace flash;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || L == 0) return 0;
  if (H <= 0 || BH % H) return (int)cudaErrorInvalidValue;
  if (!aligned16(q, k, v, g)) return (int)cudaErrorMisalignedAddress;
#define DKV(KERN, BYTES, THREADS)                                         \
  launch_dkv(KERN, BYTES, THREADS, q, k, v, mask, lse, g, delta, BH, H, L, \
             scale, dk, dv, s)
  if (DH == 16 && !bf16)
    return (int)DKV(flash_dkv_f32_kernel<16>, dkv_f32_smem_bytes<16>(), 256);
  if (DH == 32 && !bf16)
    return (int)DKV(flash_dkv_f32_kernel<32>, dkv_f32_smem_bytes<32>(), 256);
  if (DH == 64 && !bf16)
    return (int)DKV(flash_dkv_f32_kernel<64>, dkv_f32_smem_bytes<64>(), 256);
  if (DH == 16 && bf16)
    return (int)DKV(flash_dkv_mma_kernel<16>, dkv_mma_smem_bytes<16>(), 128);
  if (DH == 32 && bf16)
    return (int)DKV(flash_dkv_mma_kernel<32>, dkv_mma_smem_bytes<32>(), 128);
  if (DH == 64 && bf16)
    return (int)DKV(flash_dkv_mma_kernel<64>, dkv_mma_smem_bytes<64>(), 128);
#undef DKV
  return (int)cudaErrorInvalidValue;
}

// the dynamic shared memory a dkv block takes, in bytes (0 for a head
// dim the kernels do not take)
extern "C" int flash_bwd_dkv_smem_bytes(int DH, int bf16) {
  using namespace flash;
  if (DH == 16)
    return (int)(bf16 ? dkv_mma_smem_bytes<16>() : dkv_f32_smem_bytes<16>());
  if (DH == 32)
    return (int)(bf16 ? dkv_mma_smem_bytes<32>() : dkv_f32_smem_bytes<32>());
  if (DH == 64)
    return (int)(bf16 ? dkv_mma_smem_bytes<64>() : dkv_f32_smem_bytes<64>());
  return 0;
}

// the dynamic shared memory a dq block takes, in bytes (0 for a head dim
// the kernels do not take)
extern "C" int flash_bwd_dq_smem_bytes(int DH, int bf16) {
  using namespace flash;
  if (DH == 16)
    return (int)(bf16 ? dq_mma_smem_bytes<16>() : dq_f32_smem_bytes<16>());
  if (DH == 32)
    return (int)(bf16 ? dq_mma_smem_bytes<32>() : dq_f32_smem_bytes<32>());
  if (DH == 64)
    return (int)(bf16 ? dq_mma_smem_bytes<64>() : dq_f32_smem_bytes<64>());
  return 0;
}
