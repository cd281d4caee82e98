// Fused EdgeConv forward for Hopper:
//
//   out[i] = aggr_{kk < k, em[i,kk]} act(act(a[i] + b[idx[i,kk]]) @ W2 + b2)
//
// with act = relu (slope 0) or leaky relu (slope 0.01) and aggr = add or
// max; a node with no valid edge gives 0, and an index outside [0, L)
// is an invalid edge.  Output is fp32.
//
// Replaces the TPU kernel graphnet_tpu/ops/edgeconv_pallas.py:_fwd_kernel
// (forward of fused_edgeconv).  The TPU kernel gathered b[idx] with a 0/1
// selection matmul and laid edge rows out k-major, both Mosaic
// workarounds; here each block gathers the rows of b by index directly.
//
// What bounds it on the H100: operations.  At DynEdge's layers 1-3
// (H1=336, H2=256) with B=128, L=128, k=8 the second linear is
// 2*E*336*256 flops over the E valid edges (~17 GFLOP at ~99k of the
// 131k edge rows), against ~60 MB of input and output: far above the
// card's FLOP/byte balance in either precision.  The [B, L, k, H1]
// messages never leave the chip.  The grid gives a block 64 edge rows
// (64/k whole nodes of one event); a block whose nodes have no valid
// edge writes its zeros and returns.  Otherwise the block (edgeconv.cuh,
// on the backward's code in edgeconv_tiles.cuh):
//   1. starts the first W2 tiles into a ring of cp.async stages, the
//      gather of the neighbours' b rows and of its nodes' a rows (16
//      bytes a copy), and forms msgs = act(a + b) in fp32 in shared
//      memory, rounded once to the compute type (bf16: as the TPU
//      kernel);
//   2. for each 256-column chunk of W2, streams its tiles of kPreR h rows
//      through the ring (h tiles rotated per block, in the backward's
//      order) and accumulates pre2 = msgs.W2 in fp32 registers: bf16 on
//      the tensor cores (mma.sync.m16n8k16, A fragments by ldmatrix from
//      the messages, B by ldmatrix.trans from the tile; 64-row tiles, two
//      stages, warps in a 2 x 4 grid of 32 rows x 64 columns each), fp32
//      on the CUDA cores in full fp32 (no TF32; 16-row tiles, four
//      stages, 8 x 8 register tiles a thread);
//   3. writes pre2 + b2 into the ring's place, then sums or maxes each
//      node's k rows of act(.) in order (no atomics: the same bits every
//      run) and stores out with float4 stores.
// Shared memory at H1=336: bf16 112 KB (two blocks an SM), fp32 155 KB
// (one block an SM; the fp32 messages alone are 87 KB).  What sets the
// pace instead of the tensor cores (PERF.md §6): every block streams all
// of W2 from L2 (172 KB bf16, 344 KB fp32 at 336 x 256; up to 2,048
// blocks at B=128, L=128), and the tiles, the messages and the staging all
// pass through shared memory; in fp32, the FMA loop at one block an SM.

#include "edgeconv.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(ec::kThreads, sizeof(T) == 2 ? 2 : 1)
    edgeconv_fwd(const T* __restrict__ a, const T* __restrict__ b,
                 const int32_t* __restrict__ idx,
                 const uint8_t* __restrict__ em, const T* __restrict__ w2,
                 const T* __restrict__ b2, float* __restrict__ out, int L,
                 int H1, int H2, int k, int tl, float slope, int aggr_max) {
  extern __shared__ __align__(128) unsigned char smem[];
  ec::fwd_block<T>(a, b, idx, em, w2, b2, out, L, H1, H2, k, tl, slope,
                   aggr_max, smem);
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* idx,
                   const void* em, const void* w2, const void* b2, void* out,
                   int B, int L, int H1, int H2, int k, float slope,
                   int aggr_max, cudaStream_t s) {
  static size_t configured = 0;
  const int tl = ec::kRows / k;
  const dim3 grid((L + tl - 1) / tl, B);
  const size_t smem = (size_t)ec::fwd_layout<T>(H1).total;
  cudaError_t err = ec::allow_smem((const void*)edgeconv_fwd<T>, smem,
                                   &configured);
  if (err != cudaSuccess) return err;
  edgeconv_fwd<T><<<grid, ec::kThreads, smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(em),
      static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<float*>(out), L, H1, H2, k, tl, slope, aggr_max);
  return cudaGetLastError();
}

}  // namespace

// Shared memory the kernel needs, in bytes (the wrapper checks it
// against the card's limit before launching).
extern "C" long long edgeconv_fwd_smem_bytes(int H1, int bf16) {
  return ec::smem_bytes(H1, bf16);
}

// Blocks of the kernel an SM holds at H1 (-1 on an error).
extern "C" int edgeconv_fwd_blocks_per_sm(int H1, int bf16) {
  return bf16 ? ec::blocks_per_sm((const void*)edgeconv_fwd<ec::bf16_t>,
                                  ec::fwd_layout<ec::bf16_t>(H1).total)
              : ec::blocks_per_sm((const void*)edgeconv_fwd<float>,
                                  ec::fwd_layout<float>(H1).total);
}

// H1 and H2 multiples of 8; a, b, w2 16-byte aligned (the wrapper pads
// and copies).
extern "C" int edgeconv_fwd_launch(const void* a, const void* b,
                                   const void* idx, const void* em,
                                   const void* w2, const void* b2, void* out,
                                   int B, int L, int H1, int H2, int k,
                                   float slope, int aggr_max, int bf16,
                                   void* stream) {
  if (B == 0 || L == 0) return 0;
  if (k < 1 || k > ec::kRows || H1 % 8 || H2 % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch<ec::bf16_t>(a, b, idx, em, w2, b2, out, B, L, H1,
                                         H2, k, slope, aggr_max, s)
                    : launch<float>(a, b, idx, em, w2, b2, out, B, L, H1, H2,
                                    k, slope, aggr_max, s));
}
