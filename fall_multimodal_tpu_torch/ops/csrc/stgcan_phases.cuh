// Device code of one eval-mode STGCAN block for Hopper (sm_90a), shared by the
// per-block kernel (stgcan_block.cu) and the whole-backbone kernel
// (fused_backbone.cu). Per sample:
//   g   = ReLU(BN1(sum_{k,v} A[k,v,w] * (x[t,v,:] @ W[:, k*C:(k+1)*C] + b_k)))
//   y   = BN2(sum_tap g[t*stride + tap - 4] @ Wt[tap] + bt)        (9 taps, zero pad)
//   a   = sigmoid(W2 ReLU(W1 mean_{t,w}(y) + b1) + b2)             (SE, BN folded in W1/b1)
//   out = ReLU(y * a + residual)        residual: none | x[::stride] | BN(x[::stride] @ Wr)
// x (T,V,Cin) -> out (T_out,V,C), T_out = (T-1)/stride + 1. All BNs arrive folded
// to per-channel (scale, shift). An optional per-(v, cin) affine (in_s, in_t) is
// applied to x wherever it is read: the backbone's data BN on block 0's input
// (a template flag, so that the other blocks' code carries no trace of it).
//
// What bounds a block: operations. About 95% of them are three GEMMs per
// sample (channel mix, nine temporal taps, residual projection) with few rows
// (T_out*V <= 420) against weights of up to 9*256*256 floats, so the pace is
// set by how the operands reach the multipliers. What the design does about it:
//
// * Tensor cores at fp32 accuracy ("3xTF32"). Every fp32 operand is split as
//   hi = tf32(a), lo = tf32(a - hi); a product is a_lo*b_hi + a_hi*b_lo +
//   a_hi*b_hi in wgmma.mma_async.m64n64k8 (TF32 in, fp32 out); the lo*lo term,
//   below 2^-22 relative, is dropped. The weights' halves are made once by the
//   wrapper (ops/stgcan_block.py:pack_gemm_weight), laid out as wgmma's K-major
//   shared-memory operand; an activation is split when its fragment is loaded
//   from shared memory into registers (cvt.rna.tf32.f32 and one subtract), and
//   A goes to wgmma from registers, so any row of the A tile can feed any row
//   of the product (the taps need that). The tensor core truncates when it
//   accumulates, so it sums only one chunk of 32 k's from zero; the chunks are
//   added to the running sums by fp32 adds (error 1e-6 against 5e-5 without).
// * One thread-block cluster of kCluster CTAs works on one sample. The
//   cluster is cut into row parts x column parts by the block's width
//   (C <= 64: 4 x 1, C = 128: 2 x 2, C = 256: 1 x 4), so that a CTA owns up
//   to kPassRows rows x kPassCols columns of every GEMM and reads only its
//   columns of the weights: at C = 256, where a sample has 112 rows, each
//   weight enters one SM per sample instead of four. Rows are dealt in units
//   of 16, so 420 rows cost 4 x 112 (3.6% masked).
// * B (weights) goes through a ring of kStages stages in shared memory filled
//   by bulk asynchronous copies (cp.async.bulk, completion counted on an
//   mbarrier per stage): one thread starts a chunk's 16 copies of 1 KB, no
//   other thread spends an instruction on them. A stage is one chunk of up to
//   kSlice k-rows x kPassCols columns of hi and lo (16 KB); the copy of chunk
//   i+2 overlaps the products of chunk i.
// * A (activations) is staged in slices of kSlice channels with a row stride
//   of kRowStride floats (= 4 mod 8: the fragment loads of a warp hit 32
//   banks). For the temporal taps the slice holds the pass's graph-conv
//   frames with their 8-frame halo, copied once by cp.async (zero rows past
//   either end of the clip); the nine taps read the same tile at a row offset
//   of tap*V. For the channel mix the adjacency is contracted on x first
//   (z = A_k^T x, fp32 FMAs from a staged slice of x, over the nonzeros of A
//   only: 40 of 588 for the 14-joint skeleton), so the K*C-wide intermediate
//   is never formed. The staging loops carry no integer division (a small
//   per-row table instead) and keep several loads in flight: on this card
//   they are latency chains, and cost more than the products when written
//   naively.
// * 8 warps per CTA = 2 warpgroups; a warp holds 16 rows x 64 columns of the
//   product (32 accumulators, and 32 more for the chunk in flight); two CTAs
//   fit an SM (128 registers, about 100 KB of shared memory), so one CTA's
//   staging and barriers overlap the other's products.
//
// The CTAs meet at cluster barriers (which order their global-memory writes):
//   1. graph conv -> g (T,V,C), a per-sample scratch in global memory (L2);
//   2. the taps + bias + BN2 -> `out`; per-(CTA, warp, column) sums for SE,
//      each entry summed by one warp in a fixed order (no atomics);
//   3. the partial sums of all CTAs are read through distributed shared
//      memory; every CTA computes the SE MLP itself;
//   4. gate, residual (projection = one more GEMM), ReLU, in place: a CTA
//      revisits exactly the rows x columns it wrote in phase 2.
// Ragged rows and columns, T=29, stride 2 and Cin in {2, 3, ...} are masked
// here. C must be a multiple of 4 and at most 256; K at most 4.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stgcan {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 4;          // CTAs per sample
constexpr int kTaps = 9;
constexpr int kPad = 4;
constexpr int kSlice = 32;           // k-columns of an A slice and k-rows of a B chunk
constexpr int kRowStride = kSlice + 4;  // floats between rows of the A tile
constexpr int kPassRows = 128;       // rows x columns a CTA multiplies in one pass
constexpr int kPassCols = 64;
constexpr int kStages = 3;           // B ring
constexpr int kStageFloats = (kSlice / 8) * kPassCols * 16;  // hi and lo: 16 KB

enum { kResNone = 0, kResIdentity = 1, kResProj = 2 };

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }

// Column parts of the cluster for a block of width C (row parts: kCluster / it).
__host__ __device__ constexpr int col_parts(int C) {
  int cc = 1;
  while (cc * 2 <= kCluster && cc * kPassCols < C) cc *= 2;
  return cc;
}
// Rows (a multiple of 16) of each of `parts` row parts of `rows` rows.
__host__ __device__ constexpr int row_share(int rows, int parts) {
  return ((rows + 15) / 16 + parts - 1) / parts * 16;
}
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Rows of the A tile that a block of these sizes needs: the largest of x
// frames + z rows (phase 1), graph-conv frames with halo (phase 2) and x rows
// (phase 4) of one pass.
__host__ __device__ constexpr int a_tile_rows(int T, int V, int C, int stride) {
  const int cr = kCluster / col_parts(C);
  const int T_out = (T - 1) / stride + 1;
  const int m1 = imin(kPassRows, row_share(T * V, cr));
  const int m2 = imin(kPassRows, row_share(T_out * V, cr));
  const int p1 = imin(T, (m1 - 1) / V + 2) * V + m1;
  const int p2 = ((imin(T_out, (m2 - 1) / V + 2) - 1) * stride + kTaps) * V;
  return imax(p1, p2);
}

// Ints of the packed adjacency: K*V + 1 offsets, then nnz joints v, then nnz
// weights A[k, v, w] (float bits); entry e of (k, w) runs over
// [offset[k*V + w], offset[k*V + w + 1]).
__host__ __device__ constexpr int nbr_ints(int K, int V, int nnz) { return K * V + 1 + 2 * nnz; }

// Floats of dynamic shared memory stgcan_block_phases uses at these sizes.
__host__ __device__ constexpr size_t block_smem_floats(int T, int V, int K, int C, int stride) {
  return (size_t)kStages * kStageFloats + (size_t)a_tile_rows(T, V, C, stride) * kRowStride +
         round4(nbr_ints(K, V, K * V * V)) + kWarps * (size_t)round8(C) + 2 * (size_t)C + (size_t)round4(C / 4) +
         round4(2 * kStages) + 2 * kPassRows;
}

// The constants of one block as the kernel reads them (built once by
// ops/stgcan_block.py:pack_block), its width, stride and residual mode. A
// packed GEMM weight (k-rows x C) is laid out as [c/64][k/8][piece][c%64][k%4]
// with piece = 2*(0 hi | 1 lo) + (k%8)/4, zero past the true sizes: the 8-row
// blocks of a column block are contiguous and already in the ring's layout.
struct BlockConsts {
  const int* nbr;        // the adjacency's nonzeros by (k, w): see pack_adjacency
  const float* gcn_w;    // packed, k-row = k*round8(Cin) + i
  const float* g_shift;  // (V, C): BN1 of the graph conv's bias, per joint
  const float* bn1_s;    // (C)
  const float* tconv_w;  // packed, k-row = tap*round8(C) + c_in
  const float* bn2_s;    // (C)
  const float* y_shift;  // (C): BN2 of the temporal conv's bias
  const float* se_w1;    // (C, H)
  const float* se_b1;    // (H)
  const float* se_w2;    // (H, C)
  const float* se_b2;    // (C)
  const float* res_w;    // packed, k-row = i; or null
  const float* res_s;    // (C) or null
  const float* res_t;    // (C) or null
  int C, stride, mode;
  int nnz;               // nonzeros of the adjacency
};
constexpr int kPtrsPerBlock = 14;  // the pointers of BlockConsts, in order
constexpr int kIntsPerBlock = 4;   // C, stride, residual mode, nnz

inline BlockConsts block_consts(const float* const* p, const int* ints) {
  return BlockConsts{reinterpret_cast<const int*>(p[0]), p[1], p[2], p[3], p[4], p[5], p[6],
                     p[7], p[8], p[9], p[10], p[11], p[12], p[13], ints[0], ints[1], ints[2],
                     ints[3]};
}


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
__device__ __forceinline__ float4 affine4(float4 x, float4 s, float4 t) {
  return make_float4(fmaf(x.x, s.x, t.x), fmaf(x.y, s.y, t.y), fmaf(x.z, s.z, t.z),
                     fmaf(x.w, s.w, t.w));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a = hi + lo with both halves in TF32 (10 mantissa bits, round to nearest).
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(a));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(a - __uint_as_float(hi)));
}
// ---- wgmma: one warpgroup (4 warps), D (64 x 64, fp32, registers) = or += A (64 x 8,
// TF32, registers) * B (8 x 64, TF32, shared memory). A warp holds rows
// 16*(warp%4) .. +15 of A and D in the fragment layout of mma.m16n8k8: a[0..3] =
// (row g, k t), (g+8, t), (g, t+4), (g+8, t+4); d[4j..4j+3] = (g, 8j+2t), (g, 8j+2t+1),
// (g+8, 8j+2t), (g+8, 8j+2t+1), with g = lane/4, t = lane%4.
//
// B is K-major without swizzle: 8 columns (n) x 4 k's form a "core matrix" of
// 8 rows of 16 bytes, 128 contiguous bytes; the two core matrices of an 8-deep
// step lie kBLeadBytes apart, the eight column groups kBStrideBytes apart.
constexpr uint32_t kBLeadBytes = kPassCols * 16;  // between k 0..3 and k 4..7
constexpr uint32_t kBStrideBytes = 128;           // between groups of 8 columns

__device__ __forceinline__ uint64_t b_descriptor(uint32_t smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)(kBLeadBytes >> 4) << 16) |
         ((uint64_t)(kBStrideBytes >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// ---- bulk asynchronous copies global -> shared, completion on an mbarrier ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// The one arrival of a phase, announcing `bytes` of copies to come.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) in one instruction.
__device__ __forceinline__ void bulk_copy(float* smem, const float* gmem, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// d = (scale_d ? d : 0) + a * B.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// This thread's part of one pass: rows [r0, r0 + rows) x columns
// [n0, n0 + ncols) of a GEMM. Warp w multiplies rows 16w .. 16w+15 of the pass
// by all its columns; warps 0-3 and 4-7 are the two warpgroups.
struct Pass {
  int r0, rows;   // first row, row count (<= kPassRows)
  int n0, ncols;  // first column, column count (a multiple of 8, <= kPassCols)
  bool active;    // the thread's warpgroup has rows in the pass
  int row[2];     // pass-relative row of the fragment's halves (g, g+8), -1 past the end
};

__device__ __forceinline__ Pass make_pass(int r0, int rows, int n0, int ncols) {
  Pass P;
  P.r0 = r0; P.rows = rows; P.n0 = n0; P.ncols = ncols;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4;
  P.active = (warp / 4) * 64 < rows && ncols > 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pr = warp * 16 + h * 8 + g;
    P.row[h] = pr < rows ? pr : -1;
  }
  return P;
}

// The B ring: kStages stages of kStageFloats and an mbarrier each. `count`
// chunks have gone through it since the barriers were initialised (the same
// in every thread); chunk number c lives in stage c % kStages and completes
// phase (c / kStages) of that stage's barrier.
struct Ring {
  float* stages;
  uint64_t* bars;
  uint32_t count;
};

struct Chunk {
  int kb0;    // first 8-row block of the packed weight
  int nk8;    // 8-row blocks in the chunk (<= kSlice / 8)
  int a_off;  // float offset of the chunk's A rows in the tile
};

// acc = Atile * B over `nchunks` chunks of k. chunk_of(i) names chunk i;
// prep(i) is called by every thread before chunk i is multiplied and may
// rewrite the A tile after a __syncthreads() of its own (whatever it writes is
// visible to the products of chunk i). aoff[h] is the float offset of the
// thread's fragment rows in the tile (column lane%4 included). Bp is the packed
// weight of `kblocks` 8-row blocks. Every thread of the CTA must call it.
template <class ChunkOf, class Prep>
__device__ __forceinline__ void gemm_pass(float (&acc)[32], const Pass& P, const int (&aoff)[2],
                                          const float* atile, Ring& ring,
                                          const float* __restrict__ Bp, int kblocks, int nchunks,
                                          ChunkOf chunk_of, Prep prep) {
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;

  // One thread starts a chunk's copy: the 8-row blocks of one column block
  // are contiguous in the packed weight, in the stage's own layout.
  const uint32_t base = ring.count;
  const float* bsrc = Bp + (size_t)(P.n0 / kPassCols) * kblocks * (kPassCols * 16);
  auto issue = [&](int i) {
    if (threadIdx.x == 0 && i < nchunks) {
      const Chunk c = chunk_of(i);
      const uint32_t slot = (base + i) % kStages, bytes = c.nk8 * (kPassCols * 64);
      mbar_expect(ring.bars + slot, bytes);
      bulk_copy(ring.stages + slot * kStageFloats, bsrc + (size_t)c.kb0 * (kPassCols * 16), bytes,
                ring.bars + slot);
    }
  };
  __syncthreads();  // the ring's earlier readers are done
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  for (int i = 0; i < nchunks; ++i) {
    prep(i);
    const uint32_t slot = (base + i) % kStages;
    mbar_wait(ring.bars + slot, ((base + i) / kStages) & 1);  // chunk i has landed
    __syncthreads();  // the A tile is written; chunk i-1 is multiplied by every warp
    issue(i + kStages - 1);  // into the stage chunk i-1 used
    if (!P.active) continue;
    const Chunk c = chunk_of(i);
    const uint32_t bs = smem_u32(ring.stages + slot * kStageFloats);
    const float* ap = atile + c.a_off;
    // The chunk's products are summed by the tensor core from zero, then added
    // to the running sums by fp32 adds, which round to nearest where the tensor
    // core's own accumulation truncates: over a whole K of 2304 that bias
    // reaches 5e-5, over a chunk it stays below 1e-6.
    float part[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) part[e] = 0.f;
    // The chunk's A values are loaded at once (rows past the pass read row 0,
    // results unused); each wgmma group takes two 8-deep steps, split into
    // halves once the group before it is done (the tensor core reads the
    // fragment registers asynchronously).
    float raw[kSlice / 8][4];
#pragma unroll
    for (int q = 0; q < kSlice / 8; ++q) {
      if (q < c.nk8) {
        const float* a0 = ap + aoff[0] + q * 8;
        const float* a1 = ap + aoff[1] + q * 8;
        raw[q][0] = a0[0];
        raw[q][1] = a1[0];
        raw[q][2] = a0[4];
        raw[q][3] = a1[4];
      }
    }
#pragma unroll
    for (int q = 0; q < kSlice / 8; q += 2) {
      if (q < c.nk8) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(raw[q + u][e], ah[u][e], al[u][e]);
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (q + u < c.nk8) {
            const uint64_t b_hi = b_descriptor(bs + (q + u) * (kPassCols * 64));
            const uint64_t b_lo =
                b_descriptor(bs + (q + u) * (kPassCols * 64) + kPassCols * 32);
            wgmma_tf32(part, al[u], b_hi, q + u != 0);  // small terms first
            wgmma_tf32(part, ah[u], b_lo, 1);
            wgmma_tf32(part, ah[u], b_hi, 1);
          }
        }
        wgmma_commit();
        wgmma_wait();
      }
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] += part[e];
  }
  ring.count = base + nchunks;
}

// Calls f(row, col, v0, v1) for the thread's accumulators of a pass: global
// row, first of two neighbouring columns, the two sums. Only rows inside the
// pass and columns below C.
template <class F>
__device__ __forceinline__ void for_each_acc(const float (&acc)[32], const Pass& P, int C, F f) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = P.n0 + j * 8 + 2 * t;
      if (P.active && j * 8 < P.ncols && P.row[h] >= 0 && col < C)
        f(P.r0 + P.row[h], col, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
}

// Copies columns [c0, c0 + 8*nk8) of `nrows` rows of x (row stride Cin, row
// row_of(tile row)) into the A tile, zero past column Cin, with the optional
// affine by joint. No division and several loads in flight per thread: the
// staging loops are latency chains, not bandwidth.
template <bool kAffine, class RowOf>
__device__ __forceinline__ void stage_x(float* __restrict__ tile, int nrows, int c0, int nk8,
                                        const float* __restrict__ xn, int Cin, int V,
                                        const float* in_s, const float* in_t, RowOf row_of) {
  constexpr int kBatch = 4;
  if ((Cin & 3) == 0) {
    // a thread takes float4 number threadIdx.x % 8 of every 32nd row
    constexpr int kPer = kSlice / 4, kStep = kThreads / kPer;
    const int q = threadIdx.x % kPer, c = c0 + 4 * q;
    if (q >= nk8 * 2) return;
    for (int tr0 = threadIdx.x / kPer; tr0 < nrows; tr0 += kBatch * kStep) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int tr = tr0 + u * kStep;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (tr < nrows && c < Cin) {
          const int xr = row_of(tr);
          v[u] = ld4(xn + (size_t)xr * Cin + c);
          if (kAffine) {
            const int w = xr % V;
            v[u] = affine4(v[u], ld4(in_s + w * Cin + c), ld4(in_t + w * Cin + c));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (tr0 + u * kStep < nrows) st4(tile + (tr0 + u * kStep) * kRowStride + 4 * q, v[u]);
    }
  } else {
    // a thread takes column threadIdx.x % 32 of every 8th row
    constexpr int kStep = kThreads / kSlice;
    const int cl = threadIdx.x % kSlice, c = c0 + cl;
    if (cl >= nk8 * 8) return;
    for (int tr0 = threadIdx.x / kSlice; tr0 < nrows; tr0 += kBatch * kStep) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int tr = tr0 + u * kStep;
        v[u] = 0.f;
        if (tr < nrows && c < Cin) {
          const int xr = row_of(tr);
          v[u] = xn[(size_t)xr * Cin + c];
          if (kAffine) v[u] = fmaf(v[u], in_s[(xr % V) * Cin + c], in_t[(xr % V) * Cin + c]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (tr0 + u * kStep < nrows) tile[(tr0 + u * kStep) * kRowStride + cl] = v[u];
    }
  }
}

// The four phases of one block on one sample: xn (T,V,Cin) -> on (T_out,V,C),
// with gn a (T,V,C) scratch. kAffine: x is read as x * in_s + in_t, both
// (V*Cin). Every thread of every CTA of the sample's cluster calls it with the
// same arguments; `smem` holds block_smem_floats(T, V, K, C, stride) floats and
// may be reused by the caller after a further cluster barrier. On return this
// CTA's part of `on` is written; a cluster barrier makes all of it visible to
// the cluster.
template <bool kAffine>
__device__ __forceinline__ void stgcan_block_phases(
    const BlockConsts& p, const int T, const int V, const int Cin, const int K,
    const float* xn, const float* in_s, const float* in_t, float* gn, float* on,
    cg::cluster_group& cluster, const int rank, float* smem) {
  const int C = p.C, H = C / 4;
  const int stride = p.stride;
  const int T_out = (T - 1) / stride + 1;
  const int cp8 = round8(C), cinp8 = round8(Cin);
  const int lane_t = threadIdx.x % 4;
  constexpr int S = kRowStride;

  // this CTA's rows and columns of every GEMM
  const int cc = col_parts(C), cr = kCluster / cc;
  const int rr = rank / cc, rc = rank % cc;
  const int n0 = rc * kPassCols;  // column blocks of kPassCols, as the weights are packed
  const int ncols = imax(0, imin(kPassCols, cp8 - n0));
  const int rows1 = T * V, rows2 = T_out * V;
  const int share1 = row_share(rows1, cr), share2 = row_share(rows2, cr);
  const int beg1 = ncols ? rr * share1 : rows1, end1 = imin(rows1, rr * share1 + share1);
  const int beg2 = ncols ? rr * share2 : rows2, end2 = imin(rows2, rr * share2 + share2);

  float* tile = smem + kStages * kStageFloats;                 // a_tile_rows * S
  int* nbr = reinterpret_cast<int*>(tile + a_tile_rows(T, V, C, stride) * S);  // <= dense
  float* part = reinterpret_cast<float*>(nbr) + round4(nbr_ints(K, V, K * V * V));  // kWarps * cp8
  float* mean = part + kWarps * cp8;                           // C
  float* gate = mean + C;                                      // C
  float* hid = gate + C;                                       // H
  Ring ring{smem, reinterpret_cast<uint64_t*>(hid + round4(H)), 0};
  // per row of the current pass, what its staging needs (no division in the loops)
  int2* rowtab = reinterpret_cast<int2*>(hid + round4(H) + round4(2 * kStages));

  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) mbar_init(ring.bars + s);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  for (int e = threadIdx.x; e < nbr_ints(K, V, p.nnz); e += kThreads) nbr[e] = p.nbr[e];
  const int* nbr_v = nbr + K * V + 1;
  const float* nbr_a = reinterpret_cast<const float*>(nbr_v + p.nnz);
  for (int e = threadIdx.x; e < kWarps * cp8; e += kThreads) part[e] = 0.f;
  // both are next touched after gemm_pass's or the cluster's barriers

  float acc[32];
  int aoff[2];

  // ---- phase 1: graph conv + BN1 + ReLU -> g --------------------------------
  // A chunk is (channel slice s, partition k): z[r=(t,w)][i] = sum_v A[k,v,w] x[t,v,i]
  // for the slice's channels i, computed from the staged frames of x.
  {
    const int nslices = (Cin + kSlice - 1) / kSlice;
    for (int r0 = beg1; r0 < end1; r0 += kPassRows) {
      const Pass P = make_pass(r0, imin(kPassRows, end1 - r0), n0, ncols);
      const int f_first = r0 / V, f_last = (r0 + P.rows - 1) / V;
      const int xrows = (f_last - f_first + 1) * V;
      float* X = tile;
      float* Z = tile + xrows * S;
      // row -> (float offset of its frame's rows in X, joint); read after
      // gemm_pass's first barrier
      for (int pr = threadIdx.x; pr < P.rows; pr += kThreads) {
        const int tt = (r0 + pr) / V;
        rowtab[pr] = make_int2((tt - f_first) * V * S, r0 + pr - tt * V);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) aoff[h] = imax(P.row[h], 0) * S + lane_t;
      auto chunk_of = [&](int i) {
        const int s = i / K, k = i - s * K;
        return Chunk{(k * cinp8 + s * kSlice) / 8, imin(kSlice, cinp8 - s * kSlice) / 8, 0};
      };
      auto prep = [&](int i) {
        const int s = i / K, k = i - s * K;
        const int nk8 = imin(kSlice, cinp8 - s * kSlice) / 8;
        __syncthreads();  // chunk i-1's readers of z (and, at k == 0, of x) are done
        if (k == 0) {
          stage_x<kAffine>(X, xrows, s * kSlice, nk8, xn, Cin, V, in_s, in_t,
                           [&](int tr) { return f_first * V + tr; });
          __syncthreads();
        }
        // a thread takes float4 number threadIdx.x % 8 of every 32nd row (at most
        // four: all computed, then all stored, so that their loads overlap); only
        // the joints v with A[k, v, w] != 0 are visited (the skeleton's graph
        // has about one per (k, w))
        static_assert(kPassRows == 4 * (kThreads / (kSlice / 4)), "four rows a thread");
        const int cq = threadIdx.x % (kSlice / 4), c = 4 * cq;
        if (cq < nk8 * 2) {
          float4 z[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int pr = threadIdx.x / (kSlice / 4) + u * (kThreads / (kSlice / 4));
            z[u] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (pr < P.rows) {
              const int2 tw = rowtab[pr];
              const float* xb = X + tw.x + c;
              for (int e = nbr[k * V + tw.y]; e < nbr[k * V + tw.y + 1]; ++e)
                fma4(z[u], nbr_a[e], ld4(xb + nbr_v[e] * S));
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int pr = threadIdx.x / (kSlice / 4) + u * (kThreads / (kSlice / 4));
            if (pr < P.rows) st4(Z + pr * S + c, z[u]);
          }
        }
      };
      gemm_pass(acc, P, aoff, Z, ring, p.gcn_w, K * cinp8 / 8, nslices * K, chunk_of, prep);
      for_each_acc(acc, P, C, [&](int r, int col, float v0, float v1) {
        const float2 s1 = *reinterpret_cast<const float2*>(p.bn1_s + col);
        const float2 sh = *reinterpret_cast<const float2*>(p.g_shift + (r % V) * C + col);
        *reinterpret_cast<float2*>(gn + (size_t)r * C + col) =
            make_float2(fmaxf(fmaf(v0, s1.x, sh.x), 0.f), fmaxf(fmaf(v1, s1.y, sh.y), 0.f));
      });
    }
  }
  cluster.sync();  // every row of g is written and visible to the cluster

  // ---- phase 2: 9-tap temporal conv + bias + BN2 -> out; SE sums -------------
  // A chunk is (channel slice s, tap). The slice's tile holds g frames
  // f0 .. f0 + nfr - 1 (all joints), f0 = first output frame * stride - 4;
  // output row (to, w) reads tile row ((to - to_first)*stride + tap)*V + w.
  {
    const int nslices = (C + kSlice - 1) / kSlice;
    for (int r0 = beg2; r0 < end2; r0 += kPassRows) {
      const Pass P = make_pass(r0, imin(kPassRows, end2 - r0), n0, ncols);
      const int to_first = r0 / V, to_last = (r0 + P.rows - 1) / V;
      const int f0 = to_first * stride - kPad;
      const int trows = ((to_last - to_first) * stride + kTaps) * V;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + imax(P.row[h], 0), to = r / V;
        aoff[h] = ((to - to_first) * stride * V + (r - to * V)) * S + lane_t;
      }
      auto chunk_of = [&](int i) {
        const int s = i / kTaps, tap = i - s * kTaps;
        return Chunk{(tap * cp8 + s * kSlice) / 8, imin(kSlice, cp8 - s * kSlice) / 8,
                     tap * V * S};
      };
      auto prep = [&](int i) {
        const int s = i / kTaps;
        if (i - s * kTaps) return;
        const int nv = imin(kSlice, cp8 - s * kSlice) / 4;   // float4 per tile row
        const int valid = imin(kSlice, C - s * kSlice) / 4;  // of them inside C
        __syncthreads();  // the previous slice's readers are done
        const int q = threadIdx.x % (kSlice / 4);
        for (int tr = threadIdx.x / (kSlice / 4); tr < trows && q < nv;
             tr += kThreads / (kSlice / 4)) {
          const int gr = f0 * V + tr;  // row of g; past either end of the clip: zeros
          float* dst = tile + tr * S + 4 * q;
          if (gr >= 0 && gr < T * V && q < valid)
            cp_async16(dst, gn + (size_t)gr * C + s * kSlice + 4 * q);
          else
            st4(dst, make_float4(0.f, 0.f, 0.f, 0.f));
        }
        cp_async_commit();
        cp_async_wait<0>();
      };
      gemm_pass(acc, P, aoff, tile, ring, p.tconv_w, kTaps * cp8 / 8, nslices * kTaps, chunk_of,
                prep);

      // y, and its column sums over the warp's 16 rows (lanes that differ in
      // lane/4) for SE: one warp owns an entry of `part` in every pass
      const int warp = threadIdx.x / 32;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + j * 8 + 2 * lane_t;
        const bool live = P.active && j * 8 < P.ncols && col < C;
        float s0 = 0.f, s1 = 0.f;
        if (live) {
          const float2 s2 = *reinterpret_cast<const float2*>(p.bn2_s + col);
          const float2 sh = *reinterpret_cast<const float2*>(p.y_shift + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (P.row[h] >= 0) {
              const float y0 = fmaf(acc[4 * j + 2 * h], s2.x, sh.x);
              const float y1 = fmaf(acc[4 * j + 2 * h + 1], s2.y, sh.y);
              *reinterpret_cast<float2*>(on + (size_t)(r0 + P.row[h]) * C + col) =
                  make_float2(y0, y1);
              s0 += y0;
              s1 += y1;
            }
          }
        }
#pragma unroll
        for (int m = 4; m < 32; m *= 2) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, m);
          s1 += __shfl_xor_sync(0xffffffffu, s1, m);
        }
        if (live && threadIdx.x % 32 < 4) {
          part[warp * cp8 + col] += s0;
          part[warp * cp8 + col + 1] += s1;
        }
      }
    }
  }

  // ---- phase 3: squeeze-excite gate -----------------------------------------
  cluster.sync();  // every CTA's partial sums are in its shared memory
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int q = 0; q < kCluster; ++q) {
      const float* remote = cluster.map_shared_rank(part, q);
      for (int m = 0; m < kWarps; ++m) s += remote[m * cp8 + c];
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

  // ---- phase 4: gate + residual + ReLU on this CTA's part of out -------------
  if (p.mode == kResProj) {
    // A operand: row (to, w) <- x row (to*stride, w), one channel slice a chunk.
    const int nslices = (Cin + kSlice - 1) / kSlice;
    for (int r0 = beg2; r0 < end2; r0 += kPassRows) {
      const Pass P = make_pass(r0, imin(kPassRows, end2 - r0), n0, ncols);
#pragma unroll
      for (int h = 0; h < 2; ++h) aoff[h] = imax(P.row[h], 0) * S + lane_t;
      auto chunk_of = [&](int s) {
        return Chunk{s * (kSlice / 8), imin(kSlice, cinp8 - s * kSlice) / 8, 0};
      };
      for (int pr = threadIdx.x; pr < P.rows; pr += kThreads) {  // row -> its row of x
        const int to = (r0 + pr) / V;
        rowtab[pr].x = to * stride * V + (r0 + pr - to * V);
      }
      auto prep = [&](int s) {
        __syncthreads();  // the previous slice's readers are done; rowtab is written
        stage_x<kAffine>(tile, P.rows, s * kSlice, imin(kSlice, cinp8 - s * kSlice) / 8, xn,
                         Cin, V, in_s, in_t, [&](int tr) { return rowtab[tr].x; });
      };
      gemm_pass(acc, P, aoff, tile, ring, p.res_w, cinp8 / 8, nslices, chunk_of, prep);
      for_each_acc(acc, P, C, [&](int r, int col, float v0, float v1) {
        const float2 rs = *reinterpret_cast<const float2*>(p.res_s + col);
        const float2 rt = *reinterpret_cast<const float2*>(p.res_t + col);
        float2* o = reinterpret_cast<float2*>(on + (size_t)r * C + col);
        const float2 y = *o;
        *o = make_float2(fmaxf(fmaf(y.x, gate[col], fmaf(v0, rs.x, rt.x)), 0.f),
                         fmaxf(fmaf(y.y, gate[col + 1], fmaf(v1, rs.y, rt.y)), 0.f));
      });
    }
  } else {
    // identity needs Cin == C and stride 1 (checked by the wrapper): the
    // residual of row r is row r of x, float4-aligned. A thread takes float4
    // number threadIdx.x % 16 of every 16th row.
    const bool identity = p.mode == kResIdentity;
    constexpr int kPer = kPassCols / 4;
    const int q = threadIdx.x % kPer, c = n0 + 4 * q;
    for (int r = beg2 + threadIdx.x / kPer; r < end2 && c < C && q * 4 < ncols;
         r += kThreads / kPer) {
      float* o = on + (size_t)r * C + c;
      const float4 y = ld4(o), a = ld4(gate + c);
      float4 res = make_float4(0.f, 0.f, 0.f, 0.f);
      if (identity) {
        res = ld4(xn + (size_t)r * Cin + c);
        if (kAffine) {
          const int w = r % V;
          res = affine4(res, ld4(in_s + w * Cin + c), ld4(in_t + w * Cin + c));
        }
      }
      st4(o, make_float4(fmaxf(fmaf(y.x, a.x, res.x), 0.f), fmaxf(fmaf(y.y, a.y, res.y), 0.f),
                         fmaxf(fmaf(y.z, a.z, res.z), 0.f), fmaxf(fmaf(y.w, a.w, res.w), 0.f)));
    }
  }
  __syncthreads();  // the ring is idle: its barriers may be initialised anew by a next block
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) mbar_inval(ring.bars + s);
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
