// Device code of one eval-mode STGCAN block for Hopper (sm_90a), fp32,
// shared by the per-block kernel (stgcan_block.cu) and the whole-backbone
// kernel (fused_backbone.cu). Per sample:
//   g   = ReLU(BN1(sum_{k,v} A[k,v,w] * (x[t,v,:] @ W[:, k*C:(k+1)*C] + b_k)))
//   y   = BN2(sum_tap g[t*stride + tap - 4] @ Wt[tap] + bt)        (9 taps, zero pad)
//   a   = sigmoid(W2 ReLU(W1 mean_{t,w}(y) + b1) + b2)             (SE, BN folded in W1/b1)
//   out = ReLU(y * a + residual)        residual: none | x[::stride] | BN(x[::stride] @ Wr)
// x (T,V,Cin) -> out (T_out,V,C), T_out = (T-1)/stride + 1. All BNs arrive folded
// to per-channel (scale, shift). An optional per-(v, cin) affine (in_s, in_t) is
// applied to x wherever it is read: the backbone's data BN on block 0's input
// (a template flag, so that the other blocks' code carries no trace of it).
//
// One thread-block cluster of kCluster CTAs (kThreads threads each) works on
// one sample and calls stgcan_block_phases together. The SE gate needs the
// sample's mean over all (t, w) before any output can be finished, and the
// temporal taps read graph-conv rows of other row tiles, so the CTAs meet at
// cluster barriers (which order their global-memory writes) between phases:
//   1. graph conv. The V-contraction is applied to x first (z = A_k^T x, width
//      K*Cin), then one row-tile GEMM z @ W' (K*Cin -> C); this costs the same
//      mix FLOPs as mix-then-contract and a V/C-times cheaper contraction.
//      BN1 + ReLU, stored to a per-sample scratch g (T,V,C) in global memory;
//      the K*C-wide intermediate is never formed. g stays in the 50 MB L2.
//   2. nine temporal taps as one row-tile GEMM over (tap, c_in), + bias, BN2,
//      written to `out`; each thread keeps running per-channel sums for SE.
//   3. the SE partial sums of the cluster's CTAs are read through distributed
//      shared memory; each CTA computes the SE MLP itself.
//   4. gate, residual (projection = one more row-tile GEMM), ReLU, in place.
// Row tiles are dealt round-robin to the cluster's CTAs. Row-tile GEMM:
// thread (rg, cg) owns 4 consecutive output channels of kRowsPerThread rows
// spaced G = 256/(C/4) apart (32 accumulators); the A operand (rows x k-chunk)
// is staged in 48 KB of shared memory (warps take rows, lanes columns) and
// read as float4 broadcasts, B is read from global memory as float4 along the
// channels. Ragged row tiles, T=29, stride 2 and Cin in {2, 3, ...} are masked
// here; no 128-lane padding. C must be a multiple of 4 and at most 256; K at
// most 4.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace stgcan {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 4;          // CTAs per sample
constexpr int kMaxK = 4;             // graph partitions (spatial strategy: 3)
constexpr int kRowsPerThread = 8;
constexpr int kTileFloats = 12288;   // 48 KB staged A-operand tile
constexpr int kTaps = 9;
constexpr int kPad = 4;

enum { kResNone = 0, kResIdentity = 1, kResProj = 2 };

// Shared-memory regions start on 16-byte boundaries (float4 accesses).
__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Floats of dynamic shared memory stgcan_block_phases uses at these sizes.
__host__ __device__ constexpr size_t block_smem_floats(int V, int K, int C) {
  return (size_t)kTileFloats + round4(K * V * V) + round4(K * V) + 4 * (size_t)kThreads +
         2 * (size_t)C + (size_t)(C / 4);
}

// The folded constants of one block, its width, stride and residual mode.
struct BlockConsts {
  const float* A;        // (K, V, V) adjacency * edge importance
  const float* gcn_w;    // (Cin, K*C), read as (Cin*K, C)
  const float* gcn_b;    // (K*C)
  const float* bn1_s;    // (C)
  const float* bn1_t;
  const float* tconv_w;  // (9, C, C), read as (9*C, C)
  const float* tconv_b;  // (C)
  const float* bn2_s;
  const float* bn2_t;
  const float* se_w1;    // (C, H)
  const float* se_b1;    // (H)
  const float* se_w2;    // (H, C)
  const float* se_b2;    // (C)
  const float* res_w;    // (Cin, C) or null
  const float* res_s;    // (C) or null
  const float* res_t;    // (C) or null
  int C, stride, mode;
};

struct Layout {
  int G;       // row groups: threads (rg, cg) with rg < G are active
  int RT;      // rows per tile = kRowsPerThread * G
  int kc_max;  // k-chunk staged per pass, multiple of 4
  int c0, rg;  // first of the thread's 4 channels; its row group
  bool active;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// acc[j] = sum_k Aop[r0 + rg + j*G][k] * B[k][c0:c0+4] for k < kdim, where B is
// row-major with row stride ldb. The A operand is staged chunk by chunk:
// stage(k0, kc, kcp) fills tile[RT][kcp] with columns k0..k0+kc of the tile's
// rows and zeros past column kc and past the last row. Every thread of the CTA
// must call it (it synchronises).
template <class Stage>
__device__ __forceinline__ void tile_gemm(float4 (&acc)[kRowsPerThread], float* tile,
                                          const Layout& L, int kdim, int chunk,
                                          const float* __restrict__ B, int ldb, Stage stage) {
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < kdim; k0 += chunk) {
    const int kc = min(chunk, kdim - k0);
    const int kcp = round4(kc);
    __syncthreads();  // earlier readers of `tile` are done
    stage(k0, kc, kcp);
    __syncthreads();
    if (L.active) {
      const float* bp = B + (size_t)k0 * ldb + L.c0;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int kk = 0; kk < kcp; kk += 4) {
        const float4 b0 = ld4(bp + (size_t)kk * ldb);
        const float4 b1 = kk + 1 < kc ? ld4(bp + (size_t)(kk + 1) * ldb) : zero;
        const float4 b2 = kk + 2 < kc ? ld4(bp + (size_t)(kk + 2) * ldb) : zero;
        const float4 b3 = kk + 3 < kc ? ld4(bp + (size_t)(kk + 3) * ldb) : zero;
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          const float4 a = ld4(tile + (L.rg + j * L.G) * kcp + kk);
          fma4(acc[j], a.x, b0);
          fma4(acc[j], a.y, b1);
          fma4(acc[j], a.z, b2);
          fma4(acc[j], a.w, b3);
        }
      }
    }
  }
}

// The four phases of one block on one sample: xn (T,V,Cin) -> on (T_out,V,C),
// with gn a (T,V,C) scratch. kAffine: x is read as x * in_s + in_t, both
// (V*Cin). Every thread of every CTA of the sample's cluster calls it with the
// same arguments; `smem` holds block_smem_floats(V, K, C) floats and may be
// reused by the caller after a further cluster barrier. On return this CTA's
// rows of `on` are written; a cluster barrier makes every row visible to the
// cluster.
template <bool kAffine>
__device__ __forceinline__ void stgcan_block_phases(
    const BlockConsts& p, const int T, const int V, const int Cin, const int K,
    const float* xn, const float* in_s, const float* in_t, float* gn, float* on,
    cg::cluster_group& cluster, const int rank, float* smem) {
  const int C = p.C, H = C / 4;
  const int stride = p.stride;
  const int T_out = (T - 1) / stride + 1;
  // Staging: warps take tile rows (one row's index math per warp), lanes columns.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  Layout L;
  const int groups = C / 4;
  L.G = kThreads / groups;
  L.RT = kRowsPerThread * L.G;
  L.kc_max = (kTileFloats / L.RT) & ~3;  // >= C for every C <= 256
  L.c0 = 4 * (threadIdx.x % groups);
  L.rg = threadIdx.x / groups;
  L.active = L.rg < L.G;
  const int tile_step = kCluster * L.RT;  // this CTA's tiles: rank, rank + kCluster, ...

  float* tile = smem;                     // kTileFloats
  float* sA = tile + kTileFloats;         // K*V*V
  float* colsum = sA + round4(K * V * V); // K*V: sum_v A[k,v,w]
  float* part = colsum + round4(K * V);   // 4*kThreads: per-row-group SE partial sums
  float* mean = part + 4 * kThreads;      // C
  float* gate = mean + C;                 // C
  float* hid = gate + C;                  // H

  for (int e = threadIdx.x; e < K * V * V; e += kThreads) sA[e] = p.A[e];
  __syncthreads();
  for (int e = threadIdx.x; e < K * V; e += kThreads) {
    const int k = e / V, w = e - k * V;
    float s = 0.f;
    for (int v = 0; v < V; ++v) s += sA[(k * V + v) * V + w];
    colsum[e] = s;
  }
  // sA and colsum are next read after tile_gemm's barriers

  float4 acc[kRowsPerThread];
  int r0;  // first row of the current tile, read by the staging lambdas

  // ---- phase 1: graph conv + BN1 + ReLU -> g --------------------------------
  // A-operand column i*K + k holds z[t,w,k,i] = sum_v A[k,v,w] x[t,v,i], so
  // that row i*K + k of B is gcn_w[i, k*C : (k+1)*C], i.e. gcn_w + (i*K + k)*C.
  // A chunk covers whole input channels.
  const int rows1 = T * V;
  auto stage_z = [&](int k0, int kc, int kcp) {
    const int i0 = k0 / K, ic = kc / K;
    for (int rr = warp; rr < L.RT; rr += kWarps) {
      float* row = tile + rr * kcp;
      const int r = r0 + rr;
      int done = 0;
      if (r < rows1) {
        const int t = r / V, w = r - t * V;
        const float* xa = xn + (size_t)t * V * Cin + i0;
        for (int i = lane; i < ic; i += 32) {
          float s[kMaxK];
#pragma unroll
          for (int k = 0; k < kMaxK; ++k) s[k] = 0.f;
          for (int v = 0; v < V; ++v) {
            float xv = xa[v * Cin + i];
            if (kAffine) xv = fmaf(xv, in_s[v * Cin + i0 + i], in_t[v * Cin + i0 + i]);
#pragma unroll
            for (int k = 0; k < kMaxK; ++k)
              if (k < K) s[k] = fmaf(sA[(k * V + v) * V + w], xv, s[k]);
          }
#pragma unroll
          for (int k = 0; k < kMaxK; ++k)
            if (k < K) row[i * K + k] = s[k];
        }
        done = kc;
      }
      for (int kk = done + lane; kk < kcp; kk += 32) row[kk] = 0.f;
    }
  };
  const int chunk1 = K * min(Cin, L.kc_max / K);
  for (r0 = rank * L.RT; r0 < rows1; r0 += tile_step) {
    tile_gemm(acc, tile, L, K * Cin, chunk1, p.gcn_w, C, stage_z);
    if (L.active) {
      const float4 s1 = ld4(p.bn1_s + L.c0), t1 = ld4(p.bn1_t + L.c0);
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int r = r0 + L.rg + j * L.G;
        if (r < rows1) {
          const int w = r % V;
          float4 b = zero4;
          for (int k = 0; k < K; ++k) fma4(b, colsum[k * V + w], ld4(p.gcn_b + k * C + L.c0));
          const float4 a = acc[j];
          st4(gn + (size_t)r * C + L.c0,
              make_float4(fmaxf(fmaf(a.x + b.x, s1.x, t1.x), 0.f),
                          fmaxf(fmaf(a.y + b.y, s1.y, t1.y), 0.f),
                          fmaxf(fmaf(a.z + b.z, s1.z, t1.z), 0.f),
                          fmaxf(fmaf(a.w + b.w, s1.w, t1.w), 0.f)));
        }
      }
    }
  }
  cluster.sync();  // every row of g is written and visible to the cluster

  // ---- phase 2: 9-tap temporal conv + bias + BN2 -> out; SE sums -------------
  // A chunk is one tap: C columns, row (to, w) <- g row (to*stride + tap - 4, w).
  const int rows2 = T_out * V;
  auto stage_tap = [&](int k0, int, int) {
    const int tap = k0 / C;
    for (int rr = warp; rr < L.RT; rr += kWarps) {
      const int r = r0 + rr;
      const float* src = nullptr;
      if (r < rows2) {
        const int to = r / V, w = r - to * V;
        const int t = to * stride + tap - kPad;
        if (t >= 0 && t < T) src = gn + ((size_t)t * V + w) * C;
      }
      float* row = tile + rr * C;
      for (int c = 4 * lane; c < C; c += 128) st4(row + c, src ? ld4(src + c) : zero4);
    }
  };
  float4 se_sum = zero4;
  for (r0 = rank * L.RT; r0 < rows2; r0 += tile_step) {
    tile_gemm(acc, tile, L, kTaps * C, C, p.tconv_w, C, stage_tap);
    if (L.active) {
      const float4 bt = ld4(p.tconv_b + L.c0), s2 = ld4(p.bn2_s + L.c0),
                   t2 = ld4(p.bn2_t + L.c0);
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int r = r0 + L.rg + j * L.G;
        if (r < rows2) {
          const float4 a = acc[j];
          const float4 y = make_float4(fmaf(a.x + bt.x, s2.x, t2.x), fmaf(a.y + bt.y, s2.y, t2.y),
                                       fmaf(a.z + bt.z, s2.z, t2.z), fmaf(a.w + bt.w, s2.w, t2.w));
          st4(on + (size_t)r * C + L.c0, y);
          se_sum.x += y.x;
          se_sum.y += y.y;
          se_sum.z += y.z;
          se_sum.w += y.w;
        }
      }
    }
  }

  // ---- phase 3: squeeze-excite gate -----------------------------------------
  if (L.active) st4(part + L.rg * C + L.c0, se_sum);
  cluster.sync();  // every CTA's partial sums are in its shared memory
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int q = 0; q < kCluster; ++q) {
      const float* remote = cluster.map_shared_rank(part, q);
      for (int g = 0; g < L.G; ++g) s += remote[g * C + c];
    }
    mean[c] = s / (float)rows2;
  }
  cluster.sync();  // no CTA leaves or reuses `part` while another reads it
  for (int j = threadIdx.x; j < H; j += kThreads) {
    float h = p.se_b1[j];
    for (int c = 0; c < C; ++c) h = fmaf(mean[c], p.se_w1[c * H + j], h);
    hid[j] = fmaxf(h, 0.f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float z = p.se_b2[c];
    for (int j = 0; j < H; ++j) z = fmaf(hid[j], p.se_w2[j * C + c], z);
    gate[c] = 1.f / (1.f + expf(-z));
  }
  __syncthreads();

  // ---- phase 4: gate + residual + ReLU on this CTA's rows of out -------------
  if (p.mode == kResProj) {
    // A operand: row (to, w) <- x row (to*stride, w), Cin columns.
    auto stage_res = [&](int k0, int kc, int kcp) {
      for (int rr = warp; rr < L.RT; rr += kWarps) {
        const int r = r0 + rr;
        float* row = tile + rr * kcp;
        const float* src = nullptr;
        int w = 0;
        if (r < rows2) {
          const int to = r / V;
          w = r - to * V;
          src = xn + ((size_t)(to * stride) * V + w) * Cin + k0;
        }
        for (int kk = lane; kk < kcp; kk += 32) {
          float xv = 0.f;
          if (src && kk < kc) {
            xv = src[kk];
            if (kAffine) xv = fmaf(xv, in_s[w * Cin + k0 + kk], in_t[w * Cin + k0 + kk]);
          }
          row[kk] = xv;
        }
      }
    };
    for (r0 = rank * L.RT; r0 < rows2; r0 += tile_step) {
      tile_gemm(acc, tile, L, Cin, min(Cin, L.kc_max), p.res_w, C, stage_res);
      if (L.active) {
        const float4 rs = ld4(p.res_s + L.c0), rt = ld4(p.res_t + L.c0),
                     a = ld4(gate + L.c0);
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          const int r = r0 + L.rg + j * L.G;
          if (r < rows2) {
            float* o = on + (size_t)r * C + L.c0;
            const float4 y = ld4(o), q = acc[j];
            st4(o, make_float4(fmaxf(fmaf(y.x, a.x, fmaf(q.x, rs.x, rt.x)), 0.f),
                               fmaxf(fmaf(y.y, a.y, fmaf(q.y, rs.y, rt.y)), 0.f),
                               fmaxf(fmaf(y.z, a.z, fmaf(q.z, rs.z, rt.z)), 0.f),
                               fmaxf(fmaf(y.w, a.w, fmaf(q.w, rs.w, rt.w)), 0.f)));
          }
        }
      }
    }
  } else {
    // identity needs Cin == C (checked by the wrapper), so x rows are float4-aligned
    const bool identity = p.mode == kResIdentity;
    for (r0 = rank * L.RT; r0 < rows2; r0 += tile_step) {
      for (int rr = warp; rr < L.RT && r0 + rr < rows2; rr += kWarps) {
        const int r = r0 + rr;
        const int to = r / V, w = r - to * V;
        float* o = on + (size_t)r * C;
        const float* xr = xn + ((size_t)(to * stride) * V + w) * Cin;
        for (int c = 4 * lane; c < C; c += 128) {
          const float4 y = ld4(o + c), a = ld4(gate + c);
          float4 res = identity ? ld4(xr + c) : zero4;
          if (kAffine && identity) {
            const float4 s = ld4(in_s + w * Cin + c), t = ld4(in_t + w * Cin + c);
            res = make_float4(fmaf(res.x, s.x, t.x), fmaf(res.y, s.y, t.y),
                              fmaf(res.z, s.z, t.z), fmaf(res.w, s.w, t.w));
          }
          st4(o + c, make_float4(fmaxf(fmaf(y.x, a.x, res.x), 0.f),
                                 fmaxf(fmaf(y.y, a.y, res.y), 0.f),
                                 fmaxf(fmaf(y.z, a.z, res.z), 0.f),
                                 fmaxf(fmaf(y.w, a.w, res.w), 0.f)));
        }
      }
    }
  }
}

// Launches `kernel(args)` on `stream` with `samples` clusters of kCluster
// CTAs and `smem` bytes of dynamic shared memory; returns the CUDA error
// code (0 = queued).
template <class Kernel, class Args>
inline int launch_clusters(Kernel kernel, const Args& args, int samples, size_t smem,
                           void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(samples * kCluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace stgcan
