// A whole eval-mode STGCAN backbone in one launch, for Hopper (sm_90a). fp32.
//
// Replaces the TPU kernel fall_multimodal_tpu/ops/pallas/fused_backbone_v2.py
// `_backbone_kernel` (pallas_call at :341). Per sample:
//   y0     = x * in_s + in_t                    (data BN, a per-(v, cin) affine)
//   y(i+1) = STGCAN block i of y(i)             (stgcan_phases.cuh)
//   logits = mean_{t,v}(y_last) @ cls_w + cls_b
// x (N,T,V,Cin) -> logits (N, classes). Any stage plan of up to kMaxBlocks
// blocks, each with its own width, stride, residual mode and adjacency.
//
// Design. What the TPU kernel gains, one launch and no host between the
// blocks, is kept; how it gets there is not. The TPU kernel folds the
// adjacency into a dense (V*Cin, V*C) matrix and pads every width to 128
// lanes; here that would cost V/K = 14/3 times the mix FLOPs of a
// compute-bound kernel and a 51 MB matrix at C=256. This kernel keeps the
// factored graph conv at the true widths: one cluster of kCluster CTAs per
// sample loops over the blocks and runs the same four phases as the per-block
// kernel. The data BN is applied where block 0 reads x. Activations ping-pong
// between two per-sample scratch buffers in global memory (at most 115 KB per
// sample at the full plan, so they stay in L2); a cluster barrier after each
// block makes its rows visible to the CTAs that stage them next and keeps the
// shared-memory regions of a block from being rewritten while a peer still
// reads them. The pool and the head are done by the cluster's first CTA.
//
// What bounds it: operations. The full plan (64,64,64,128,128,256,256 on
// T=30, V=14) is about 0.65 GFLOP per sample in fp32 FMAs against 8.4 MB of
// weights shared by all samples. What this design leaves on the table is what
// the per-block kernel leaves (no tensor cores, no async tile pipeline), and a
// cluster never spreads over more than kCluster SMs, so at batch 1 the whole
// backbone runs on 4 of the 132 SMs.

#include "stgcan_phases.cuh"

namespace {

using namespace stgcan;

constexpr int kMaxBlocks = 16;
constexpr int kPtrsPerBlock = 16;  // the pointers of BlockConsts, in order
constexpr int kIntsPerBlock = 3;   // C, stride, residual mode

struct BackboneArgs {
  const float* x;      // (N, T, V, Cin)
  const float* in_s;   // (V*Cin) data BN scale
  const float* in_t;   // (V*Cin) data BN shift
  const float* cls_w;  // (C_last, classes)
  const float* cls_b;  // (classes)
  float* act0;         // (N, act_stride) even blocks' outputs
  float* act1;         // (N, act_stride) odd blocks' outputs
  float* g;            // (N, g_stride) graph-conv scratch
  float* logits;       // (N, classes)
  int n_blocks, T, V, Cin, K, classes, act_stride, g_stride;
  BlockConsts blocks[kMaxBlocks];
};

// Two CTAs per SM (at most 128 registers a thread): at batch 128 the 512 CTAs
// need the occupancy, and the block's constants, copied out of parameter
// space once per block, then cost a few spilled registers and nothing else.
__global__ void __launch_bounds__(kThreads, 2)
fused_backbone_kernel(const __grid_constant__ BackboneArgs p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const size_t n = blockIdx.x / kCluster;
  float* const act0 = p.act0 + n * p.act_stride;
  float* const act1 = p.act1 + n * p.act_stride;
  float* const gn = p.g + n * p.g_stride;

  const float* xn = p.x + n * p.T * p.V * p.Cin;
  int T = p.T, Cin = p.Cin;
  for (int i = 0; i < p.n_blocks; ++i) {
    const BlockConsts blk = p.blocks[i];
    float* const on = (i & 1) ? act1 : act0;
    if (i == 0)
      stgcan_block_phases<true>(blk, T, p.V, Cin, p.K, xn, p.in_s, p.in_t, gn, on, cluster,
                                rank, smem);
    else
      stgcan_block_phases<false>(blk, T, p.V, Cin, p.K, xn, nullptr, nullptr, gn, on,
                                 cluster, rank, smem);
    // Every row of `on` is visible to the cluster before the next block
    // stages it, and no CTA rewrites its shared memory while a peer is still
    // inside this block.
    cluster.sync();
    xn = on;
    T = (T - 1) / blk.stride + 1;
    Cin = blk.C;
  }

  // ---- pool over (T, V) and the classifier head, by the first CTA ------------
  if (rank != 0) return;
  const int rows = T * p.V, C = Cin;
  float* mean = smem;  // the blocks' regions are free after the last barrier
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += xn[(size_t)r * C + c];
    mean[c] = s / (float)rows;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < p.classes; j += kThreads) {
    float z = p.cls_b[j];
    for (int c = 0; c < C; ++c) z = fmaf(mean[c], p.cls_w[c * p.classes + j], z);
    p.logits[n * p.classes + j] = z;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = queued),
// or cudaErrorInvalidValue for a plan it does not take.
// block_ptrs: n_blocks * 16 device pointers, per block in BlockConsts order
// (A, gcn_w, gcn_b, bn1_s, bn1_t, tconv_w, tconv_b, bn2_s, bn2_t, se_w1, se_b1,
// se_w2, se_b2, res_w, res_s, res_t; the last three null unless the block
// projects its residual). block_ints: n_blocks * 3 ints (C, stride, residual
// mode: 0 none, 1 identity, 2 proj). act0/act1 hold act_stride floats per
// sample (the largest block output), g holds g_stride (the largest T*V*C);
// both strides are multiples of 4. Pointers must be 16-byte aligned; every C a
// multiple of 4, at most 256; K <= 4.
int fused_backbone_forward(const float* x, const float* in_s, const float* in_t,
                           const void* const* block_ptrs, const int* block_ints,
                           const float* cls_w, const float* cls_b, float* act0, float* act1,
                           float* g, float* logits, int N, int T, int V, int Cin, int K,
                           int n_blocks, int classes, int act_stride, int g_stride,
                           void* stream) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks) return (int)cudaErrorInvalidValue;
  BackboneArgs p{x, in_s, in_t, cls_w, cls_b, act0, act1, g, logits,
                 n_blocks, T, V, Cin, K, classes, act_stride, g_stride, {}};
  size_t smem_floats = 0;
  for (int i = 0; i < n_blocks; ++i) {
    const float* const* ptrs =
        reinterpret_cast<const float* const*>(block_ptrs) + i * kPtrsPerBlock;
    const int* ints = block_ints + i * kIntsPerBlock;
    p.blocks[i] = BlockConsts{ptrs[0],  ptrs[1],  ptrs[2],  ptrs[3],  ptrs[4],  ptrs[5],
                              ptrs[6],  ptrs[7],  ptrs[8],  ptrs[9],  ptrs[10], ptrs[11],
                              ptrs[12], ptrs[13], ptrs[14], ptrs[15], ints[0],  ints[1],
                              ints[2]};
    const size_t need = block_smem_floats(V, K, ints[0]);
    if (need > smem_floats) smem_floats = need;
  }
  return launch_clusters(fused_backbone_kernel, p, N, sizeof(float) * smem_floats, stream);
}

const char* fused_backbone_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
