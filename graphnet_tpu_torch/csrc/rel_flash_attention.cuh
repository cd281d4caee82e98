// Pieces shared by the relative-bias attention kernels
// (rel_flash_attention.cu, rel_flash_attention_bwd.cu): the pair
// argument of DeepIce's SpacetimeEncoder (all three kernels), and the
// forward kernel's embedding built per tile in shared memory and its
// tile sizes.
//
// A forward block owns 32 query rows, one row per lane, and a group of
// heads, one warp per head.  It streams key tiles.  The pair embedding
// of a (32 rows x tile) block of pairs is computed once into shared
// memory and read by every head of the group: the transcendentals are
// the costly part of the work, and they do not depend on the head.
// (The backward kernels build their embeddings in registers, straight
// into tensor-core fragments; see rel_flash_attention_bwd.cu.)

#pragma once

#include "flash_attention.cuh"

namespace relattn {

using flash::from_f;
using flash::kNeg;
using flash::round_t;
using flash::to_f;

constexpr int kLanes = 32;  // rows a forward block owns, one per lane
constexpr int kTile = 16;   // keys per streamed tile (KEY_TILE of the
                            // plain version)

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

// emb[(t * E + e) * 32 + lane] = embedding e of the pair (query lane0 +
// lane, key tile0 + t) for t < kTile: [sin(arg f), cos(arg f)] with the
// precise sincosf (the fast __sinf's error grows with the argument).
// Rows past L take row L - 1 (their values are never used).
template <int E>
__device__ __forceinline__ void emb_tile(float* emb,
                                         const float* __restrict__ x0b,
                                         int XF, int L, int lane0, int tile0,
                                         const float* __restrict__ freqs) {
  for (int p = threadIdx.x; p < kTile * kLanes; p += blockDim.x) {
    const int lane = p % kLanes, t = p / kLanes;
    const float* xl = x0b + (size_t)min(lane0 + lane, L - 1) * XF;
    const float* xt = x0b + (size_t)min(tile0 + t, L - 1) * XF;
    const float arg = pair_arg(xl, xt);
    float* out = emb + (size_t)t * E * kLanes + lane;
#pragma unroll 4
    for (int f = 0; f < E / 2; ++f) {
      float sn, cs;
      sincosf(__fmul_rn(arg, freqs[f]), &sn, &cs);
      out[f * kLanes] = sn;
      out[(E / 2 + f) * kLanes] = cs;
    }
  }
}

// heads per block: the largest divisor of H not above cap
inline int head_group(int H, int cap) {
  int g = cap < H ? cap : H;
  while (H % g) --g;
  return g;
}

}  // namespace relattn
