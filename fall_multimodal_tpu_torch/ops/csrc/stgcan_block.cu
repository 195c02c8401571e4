// One eval-mode STGCAN block, fused, for Hopper (sm_90a). fp32 in and out.
//
// Replaces the TPU kernel fall_multimodal_tpu/ops/pallas/stgcan_block.py
// `_block_kernel` (pallas_call at :196). x (N,T,V,Cin) -> out (N,T_out,V,C),
// T_out = (T-1)/stride + 1; all BNs arrive folded to per-channel (scale, shift)
// and the GEMM weights split into TF32 halves by ops/stgcan_block.py:pack_block.
// What a block computes, and the design (a sample cut into row x column
// parts taken by a cluster of 4, 2 or 1 CTAs, four phases between cluster
// barriers, the GEMMs as wgmma in split TF32 fed by a producer warpgroup
// through mbarrier rings), is in stgcan_phases.cuh, which the whole-backbone
// kernel (fused_backbone.cu) shares; this file is the one-block-per-launch
// entry point. Any N is taken.
//
// What bounds it: operations. Block 6 (256->256, T=8) costs 2*112*256*768 (mix)
// + 2*9*112*256^2 (taps) = 176 MFLOP per sample, 22.5 GFLOP at batch 128; in
// split TF32 every product is three tensor-core products, so the floor is
// 3 * 22.5 GFLOP / 495 TFLOP/s = 0.14 ms (0.34 ms on the fp32 FMA pipe),
// against ~32 MB of activations and weights (~10 us at 3.35 TB/s). What this
// design leaves on the table: every CTA streams every weight chunk from L2
// for every sample (no TMA multicast, no rows of several samples in one
// pass), the SE gate stays on the FMA pipe between cluster barriers, and at
// batch 1 only 4 of the 132 SMs work.

#include "stgcan_phases.cuh"

namespace {

using namespace stgcan;

struct BlockArgs : BlockConsts {
  const float* x;        // (N, T, V, Cin)
  float* g;              // scratch (N, T, V, C)
  float* out;            // (N, T_out, V, C)
  int T, V, Cin, K, T_out;
};

__global__ void __launch_bounds__(kCtaThreads, 1) stgcan_block_kernel(const BlockArgs p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const size_t n = blockIdx.x / cluster.num_blocks();  // one cluster a sample
  const float* x = p.x + n * p.T * p.V * p.Cin;
  float* g = p.g + n * p.T * p.V * p.C;
  float* out = p.out + n * p.T_out * p.V * p.C;
  if (threadIdx.x >= kThreads) {
    producer_registers();
    stgcan_block_phases<false, true>(p, p.T, p.V, p.Cin, p.K, x, nullptr, nullptr, g, out,
                                     cluster, smem);
  } else {
    consumer_registers();
    stgcan_block_phases<false, false>(p, p.T, p.V, p.Cin, p.K, x, nullptr, nullptr, g, out,
                                      cluster, smem);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, for one CTA at these sizes, at most (with
// one CTA a sample; with more, each holds the SE sums of fewer parts).
size_t stgcan_block_smem_bytes(int T, int V, int K, int C, int stride) {
  return sizeof(float) * block_smem_floats(T, V, K, C, stride, 1);
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = queued).
// consts: the 14 device pointers of BlockConsts, in order (the last three null
// unless the block projects its residual). residual_mode: 0 none, 1 identity
// (Cin == C), 2 proj. nnz: nonzeros of the packed adjacency. Pointers must be
// 16-byte aligned; C a multiple of 4, at most 256; K <= 4.
int stgcan_block_forward(const float* x, const void* const* consts, float* g, float* out,
                         int N, int T, int V, int Cin, int K, int C, int stride,
                         int residual_mode, int nnz, void* stream) {
  const int ints[kIntsPerBlock] = {C, stride, residual_mode, nnz};
  const BlockArgs a{block_consts(reinterpret_cast<const float* const*>(consts), ints),
                    x, g, out, T, V, Cin, K, (T - 1) / stride + 1};
  return launch_clusters(
      stgcan_block_kernel, a, N,
      [&](int ncta) { return sizeof(float) * block_smem_floats(T, V, K, C, stride, ncta); },
      stream);
}

const char* stgcan_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
