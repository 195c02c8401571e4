// A whole eval-mode STGCAN backbone in one launch, for Hopper (sm_90a). fp32
// in and out; the GEMMs run on tensor cores in split TF32 (stgcan_phases.cuh).
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
// factored graph conv at the true widths: one cluster of CTAs per sample
// (4, 2 or 1, stgcan_phases.cuh:launch_clusters) loops over the blocks and
// runs the same four phases as the per-block kernel. The data BN is applied where block 0 reads x. Activations ping-pong
// between two per-sample scratch buffers in global memory (at most 115 KB per
// sample at the full plan, so they stay in L2); a cluster barrier after each
// block makes its rows visible to the CTAs that stage them next and keeps the
// shared-memory regions of a block from being rewritten while a peer still
// reads them. The pool and the head are done by the cluster's first CTA.
//
// What bounds it: operations. The full plan (64,64,64,128,128,256,256 on
// T=30, V=14) is about 0.65 GFLOP per sample, 95% of it GEMMs that cost three
// tensor-core products each in split TF32 (floor at batch 128: about 0.5 ms),
// against 8.4 MB of weights (17 MB as TF32 halves) shared by all samples. What
// the design does about it is the per-block design of stgcan_phases.cuh: a
// sample cut into row x column parts by the block's width, a producer
// warpgroup that keeps the weights' ring and the activations' ring full, two
// consumer warpgroups with a wgmma group always in flight. What it leaves on
// the table is what the per-block kernel leaves (every CTA streams every
// weight from L2 for every sample, no TMA multicast; the SE gate on the FMA
// pipe between cluster barriers), and a cluster never spreads over more than
// 4 SMs, so at batch 1 the whole backbone runs on 4 of the 132 SMs.

#include "stgcan_phases.cuh"

namespace {

using namespace stgcan;

constexpr int kMaxBlocks = 16;

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

// The blocks of sample n, by the producer warpgroup (kProducer) or the
// consumers. Few values live across a block: every pointer is rebuilt from
// parameter space where it is needed, since a copy held in registers spills.
// Returns the last block's output; T and Cin become its sizes.
template <bool kProducer>
__device__ __forceinline__ const float* run_blocks(const BackboneArgs& p, const size_t n,
                                                   cg::cluster_group& cluster, float* smem,
                                                   int& T, int& Cin) {
  T = p.T;
  Cin = p.Cin;
  for (int i = 0; i < p.n_blocks; ++i) {
    const BlockConsts& blk = p.blocks[i];  // read where used: no registers held
    const float* xn = i == 0 ? p.x + n * p.T * p.V * p.Cin
                             : ((i & 1) ? p.act0 : p.act1) + n * p.act_stride;
    float* const on = ((i & 1) ? p.act1 : p.act0) + n * p.act_stride;
    float* const gn = p.g + n * p.g_stride;
    if (i == 0)
      stgcan_block_phases<true, kProducer>(blk, T, p.V, Cin, p.K, xn, p.in_s, p.in_t, gn, on,
                                           cluster, smem);
    else
      stgcan_block_phases<false, kProducer>(blk, T, p.V, Cin, p.K, xn, nullptr, nullptr, gn, on,
                                            cluster, smem);
    // Every row of `on` is visible to the cluster before the next block
    // stages it, and no CTA rewrites its shared memory while a peer is still
    // inside this block.
    cluster.sync();
    T = (T - 1) / blk.stride + 1;
    Cin = blk.C;
  }
  return ((p.n_blocks & 1) ? p.act0 : p.act1) + n * p.act_stride;
}

// One CTA per SM: a producer warpgroup and two consumer warpgroups; one
// cluster a sample.
__global__ void __launch_bounds__(kCtaThreads, 1)
fused_backbone_kernel(const __grid_constant__ BackboneArgs p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const size_t n = blockIdx.x / cluster.num_blocks();
  int T, Cin;
  if (threadIdx.x >= kThreads) {
    producer_registers();
    run_blocks<true>(p, n, cluster, smem, T, Cin);
    return;
  }
  consumer_registers();
  const float* xn = run_blocks<false>(p, n, cluster, smem, T, Cin);

  // ---- pool over (T, V) and the classifier head, by the first CTA's consumers
  if (cluster.block_rank() != 0) return;
  const int rows = T * p.V, C = Cin;
  float* mean = smem;  // the blocks' regions are free after the last barrier
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += xn[(size_t)r * C + c];
    mean[c] = s / (float)rows;
  }
  consumer_sync();
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
// block_ptrs: n_blocks * 14 device pointers, per block in BlockConsts order
// (nbr, gcn_w, g_shift, bn1_s, tconv_w, bn2_s, y_shift, se_w1, se_b1, se_w2,
// se_b2, res_w, res_s, res_t; the last three null unless the block projects
// its residual; the adjacency packed as its nonzeros, the three weights as
// TF32 halves). block_ints: n_blocks * 4 ints (C, stride, residual mode: 0
// none, 1 identity, 2 proj; nonzeros of the adjacency). act0/act1 hold
// act_stride floats per sample (the largest block output), g holds g_stride
// (the largest T*V*C);
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
  for (int i = 0; i < n_blocks; ++i)
    p.blocks[i] = block_consts(
        reinterpret_cast<const float* const*>(block_ptrs) + i * kPtrsPerBlock,
        block_ints + i * kIntsPerBlock);
  // every block's shared memory, at the sizes it sees
  auto smem_bytes = [&](int ncta) {
    size_t floats = 0;
    int tt = T;
    for (int i = 0; i < n_blocks; ++i) {
      const int* ints = block_ints + i * kIntsPerBlock;
      const size_t need = block_smem_floats(tt, V, K, ints[0], ints[1], ncta);
      if (need > floats) floats = need;
      tt = (tt - 1) / ints[1] + 1;
    }
    return sizeof(float) * floats;
  };
  return launch_clusters(fused_backbone_kernel, p, N, smem_bytes, stream);
}

const char* fused_backbone_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
