// One eval-mode STGCAN block, fused, for Hopper (sm_90a). fp32 throughout.
//
// Replaces the TPU kernel fall_multimodal_tpu/ops/pallas/stgcan_block.py
// `_block_kernel` (pallas_call at :196). x (N,T,V,Cin) -> out (N,T_out,V,C),
// T_out = (T-1)/stride + 1; all BNs arrive folded to per-channel (scale, shift)
// from ops/stgcan_block.py:fold_block_params. What a block computes, and the
// design (one cluster of 4 CTAs per sample, four phases between cluster
// barriers, row-tile GEMMs in fp32 FMAs), is in stgcan_phases.cuh, which the
// whole-backbone kernel (fused_backbone.cu) shares; this file is the
// one-block-per-launch entry point. Any N is taken.
//
// What bounds it: at the flagship's shapes the block is compute-bound. Block 6
// (256->256, T=8) costs 2*112*256*768 (mix) + 2*9*112*256^2 (taps) = 176 MFLOP per
// sample, 22.5 GFLOP at batch 128: 0.34 ms at the card's 67 TFLOP/s fp32 peak,
// against ~32 MB of activations and weights (~10 us at 3.35 TB/s).
// What this design leaves on the table: no tensor cores (TF32/bf16 wgmma would
// lift the 67 TFLOP/s ceiling to 495/989), no TMA or cp.async pipelining of
// the tiles, and at batch 1 only kCluster of the 132 SMs work.

#include "stgcan_phases.cuh"

namespace {

using namespace stgcan;

struct BlockArgs : BlockConsts {
  const float* x;        // (N, T, V, Cin)
  float* g;              // scratch (N, T, V, C)
  float* out;            // (N, T_out, V, C)
  int T, V, Cin, K, T_out;
};

__global__ void __launch_bounds__(kThreads) stgcan_block_kernel(const BlockArgs p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = blockIdx.x / kCluster;
  stgcan_block_phases<false>(p, p.T, p.V, p.Cin, p.K,
                             p.x + (size_t)n * p.T * p.V * p.Cin, nullptr, nullptr,
                             p.g + (size_t)n * p.T * p.V * p.C,
                             p.out + (size_t)n * p.T_out * p.V * p.C, cluster,
                             (int)cluster.block_rank(), smem);
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, for one CTA at these sizes.
size_t stgcan_block_smem_bytes(int V, int K, int C) {
  return sizeof(float) * block_smem_floats(V, K, C);
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = queued).
// residual_mode: 0 none, 1 identity (Cin == C), 2 proj (res_* non-null).
// Pointers must be 16-byte aligned; C a multiple of 4, at most 256; K <= 4.
int stgcan_block_forward(const float* x, const float* A, const float* gcn_w,
                         const float* gcn_b, const float* bn1_s, const float* bn1_t,
                         const float* tconv_w, const float* tconv_b, const float* bn2_s,
                         const float* bn2_t, const float* se_w1, const float* se_b1,
                         const float* se_w2, const float* se_b2, const float* res_w,
                         const float* res_s, const float* res_t, float* g, float* out,
                         int N, int T, int V, int Cin, int K, int C, int stride,
                         int residual_mode, void* stream) {
  const BlockArgs a{{A, gcn_w, gcn_b, bn1_s, bn1_t, tconv_w, tconv_b, bn2_s, bn2_t, se_w1,
                     se_b1, se_w2, se_b2, res_w, res_s, res_t, C, stride, residual_mode},
                    x, g, out, T, V, Cin, K, (T - 1) / stride + 1};
  return launch_clusters(stgcan_block_kernel, a, N, stgcan_block_smem_bytes(V, K, C), stream);
}

const char* stgcan_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
