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
// * A sample's GEMMs are cut into kParts row parts x column parts by the
//   block's width (C <= 64: 4 x 1, C = 128: 2 x 2, C = 256: 1 x 4), so that a
//   part is up to kPassRows rows x kPassCols columns of every GEMM and reads
//   only its columns of the weights. Rows are dealt in units of 16, so 420
//   rows cost 4 x 112 (3.6% masked). One thread-block cluster works on one
//   sample: 4 CTAs of one part each for a few samples (batch 1), or 2 or 1
//   CTAs that take 2 or 4 parts in turn once the samples outnumber the
//   clusters the card holds (batch 128: 128 samples on 132 SMs in one round,
//   where 4-CTA clusters, 30 at a time, take five). launch_clusters chooses.
// * Warp-specialised, one CTA to an SM: two consumer warpgroups (warps 0-7,
//   each warp 16 rows x 64 columns of the product) and one producer
//   warpgroup, which hands its registers to the consumers (setmaxnreg:
//   kProducerRegs and kConsumerRegs a thread). The producers walk the same
//   passes and chunks as the consumers and fill two rings in shared memory;
//   a ring slot is handed over by a "full" mbarrier and handed back by an
//   "empty" one, so no CTA barrier is left inside a pass:
//   - B (weights): up to kMaxBStages stages of one chunk (as many as shared
//     memory holds beside the rest at the block's sizes), up to kSlice k-rows
//     x kPassCols columns of hi and lo (16 KB), each filled by one bulk
//     asynchronous copy (cp.async.bulk) that completes on the stage's
//     mbarrier. One thread of the producer warpgroup issues them, up to a ring
//     ahead, across passes, and fills the next phase's first stages before
//     the cluster barrier between phases.
//   - A (activations): kAStages slots of kSlice channels with a row stride of
//     kRowStride floats (= 4 mod 8: the fragment loads of a warp hit 32 banks),
//     filled by the other three producer warps with cp.async (16 bytes a
//     thread; the mbarrier counts them in). For the temporal taps a slot holds
//     the pass's graph-conv frames with their 8-frame halo (zero rows past
//     either end of the clip), and the nine taps read it at a row offset of
//     tap*V; for the residual projection the pass's strided rows of x; for the
//     channel mix the pass's frames of x, from which the consumers contract
//     the adjacency right into their fragments (z = A_k^T x, fp32 FMAs over
//     the nonzeros of A only: 40 of 588 for the 14-joint skeleton, so the
//     K*C-wide intermediate is never formed).
//   The consumers keep one wgmma group (two 8-deep steps, six products) in
//   flight while they load and split the next one (wgmma.wait_group 1), and
//   sum chunks into two register sets by turns so that the fp32 add of one
//   chunk overlaps the products of the next; they drain every second chunk,
//   as ptxas keeps the products asynchronous only where no group is in flight
//   across a loop's back edge. Every warp issues every wgmma (rows past a pass
//   read row 0 and are masked in the epilogue): no branch that depends on the
//   thread surrounds a product.
//
// The CTAs of a sample meet at cluster barriers (which order their global-
// memory writes):
//   1. graph conv -> g (T,V,C), a per-sample scratch in global memory (L2);
//   2. the taps + bias + BN2 -> `out`; per-(part, warp, column) sums for SE,
//      each entry summed by one warp in a fixed order (no atomics);
//   3. the partial sums of all parts are read through distributed shared
//      memory, in part order; every CTA computes the SE MLP itself;
//   4. gate, residual (projection = one more GEMM), ReLU, in place: a CTA
//      revisits exactly the rows x columns it wrote in phase 2.
// What bounds it now (PERF.md section 5 has the clock64() split): the wait
// for B in the taps (every CTA streams every weight chunk from L2 for every
// sample: no TMA multicast, no rows of several samples in one pass), the
// latency of the contraction in the channel mix's fragment loads, the drain
// every second chunk, and the phases between the GEMMs (the SE gate on the
// FMA pipe, the cluster barriers), which a CTA no longer overlaps with another
// CTA's products. At batch 1 only 4 of the 132 SMs work.
// Ragged rows and columns, T=29, stride 2 and Cin in {2, 3, ...} are masked
// here. C must be a multiple of 4 and at most 256; K at most 4.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace stgcan {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;                         // consumer warps: two warpgroups
constexpr int kThreads = kWarps * 32;             // consumer threads
constexpr int kProducerThreads = 128;             // one producer warpgroup:
constexpr int kStagers = 96;                      // warps 8-10 stage A,
constexpr int kBIssuer = kThreads + kStagers;     // a thread of warp 11 copies B
constexpr int kCtaThreads = kThreads + kProducerThreads;
// Registers a thread of each role keeps (setmaxnreg): 168 each at launch.
// The consumers need about 200 (two sets of chunk sums, the running sums,
// two groups' fragments); at 232 the whole-backbone kernel, whose consumers
// still spill a little, is 3% faster than at 208 (batch 128). The producers'
// staging spills a little at 40, which costs nothing measurable.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kProducerThreads * kProducerRegs + kThreads * kConsumerRegs <= 65536, "registers");
constexpr int kParts = 4;            // row x column parts of a sample's GEMMs
constexpr int kTaps = 9;
constexpr int kPad = 4;
constexpr int kSlice = 32;           // k-columns of an A slice and k-rows of a B chunk
constexpr int kRowStride = kSlice + 4;  // floats between rows of an A slot
constexpr int kPassRows = 128;       // rows x columns a CTA multiplies in one pass
constexpr int kPassCols = 64;
constexpr int kMaxBStages = 8;       // B ring, as deep as shared memory allows
constexpr int kAStages = 2;          // A ring
constexpr int kStageFloats = (kSlice / 8) * kPassCols * 16;  // hi and lo: 16 KB
constexpr int kSmemFloats = (232448 - 1024) / 4;  // shared memory a CTA may have, 1 KB spare
// mbarriers: full and empty of every B stage and A slot
constexpr int kBars = 2 * kMaxBStages + 2 * kAStages;

enum { kResNone = 0, kResIdentity = 1, kResProj = 2 };

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }

// Column parts of a sample for a block of width C (row parts: kParts / it).
__host__ __device__ constexpr int col_parts(int C) {
  int cc = 1;
  while (cc * 2 <= kParts && cc * kPassCols < C) cc *= 2;
  return cc;
}
// Rows (a multiple of 16) of each of `parts` row parts of `rows` rows.
__host__ __device__ constexpr int row_share(int rows, int parts) {
  return ((rows + 15) / 16 + parts - 1) / parts * 16;
}
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// The most rows of one pass of the graph conv (m1) and of the taps and the
// residual (m2); the x frames a graph-conv pass reads; the g rows (frames with
// halo) a tap slice holds.
__host__ __device__ constexpr int pass_rows1(int T, int V, int C) {
  return imin(kPassRows, row_share(T * V, kParts / col_parts(C)));
}
__host__ __device__ constexpr int pass_rows2(int T, int V, int C, int stride) {
  return imin(kPassRows, row_share(((T - 1) / stride + 1) * V, kParts / col_parts(C)));
}
__host__ __device__ constexpr int x_rows(int T, int V, int C) {
  return imin(T, (pass_rows1(T, V, C) - 1) / V + 2) * V;
}
__host__ __device__ constexpr int g_rows(int T, int V, int C, int stride) {
  return ((imin((T - 1) / stride + 1, (pass_rows2(T, V, C, stride) - 1) / V + 2) - 1) * stride +
          kTaps) * V;
}
// Rows of the A region: kAStages slots of x frames (phase 1), g frames
// (phase 2) or strided x rows (phase 4).
__host__ __device__ constexpr int a_region_rows(int T, int V, int C, int stride) {
  return kAStages *
         imax(x_rows(T, V, C), imax(g_rows(T, V, C, stride), pass_rows2(T, V, C, stride)));
}

// Ints of the packed adjacency: K*V + 1 offsets, then nnz joints v, then nnz
// weights A[k, v, w] (float bits); entry e of (k, w) runs over
// [offset[k*V + w], offset[k*V + w + 1]).
__host__ __device__ constexpr int nbr_ints(int K, int V, int nnz) { return K * V + 1 + 2 * nnz; }

// Floats of shared memory beside the B ring at these sizes, with ncta CTAs
// a sample: the A region, the adjacency, the SE buffers (partial sums of
// each of the CTA's parts), the barriers and a row table.
__host__ __device__ constexpr int rest_floats(int T, int V, int K, int C, int stride, int ncta) {
  return a_region_rows(T, V, C, stride) * kRowStride + round4(nbr_ints(K, V, K * V * V)) +
         kParts / ncta * kWarps * round8(C) + 2 * C + round4(C / 4) + 2 * kBars + kPassRows;
}
// Stages of the B ring: as many as fit (at most kMaxBStages, at least 2; a
// deeper ring rides out more of L2's latency).
__host__ __device__ constexpr int b_stages(int T, int V, int K, int C, int stride, int ncta) {
  return imax(2, imin(kMaxBStages,
                      (kSmemFloats - rest_floats(T, V, K, C, stride, ncta)) / kStageFloats));
}
// Floats of dynamic shared memory stgcan_block_phases uses at these sizes.
__host__ __device__ constexpr size_t block_smem_floats(int T, int V, int K, int C, int stride,
                                                       int ncta) {
  return (size_t)b_stages(T, V, K, C, stride, ncta) * kStageFloats +
         rest_floats(T, V, K, C, stride, ncta);
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
__device__ __forceinline__ float4 affine4(float4 x, float4 s, float4 t) {
  return make_float4(fmaf(x.x, s.x, t.x), fmaf(x.y, s.y, t.y), fmaf(x.z, s.z, t.z),
                     fmaf(x.w, s.w, t.w));
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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of these registers across
// the wgmma fences and waits around them (they are written asynchronously).
__device__ __forceinline__ void fence_operand(float (&r)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) asm volatile("" : "+f"(r[e])::"memory");
}

// ---- mbarriers and bulk asynchronous copies global -> shared ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// One arrival (release: this thread's earlier writes are seen by the waiters).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// One arrival, announcing `bytes` of copies to come.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
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
// 16 bytes global -> shared (cp.async, the load/store path), and an arrival on
// `bar` once every cp.async this thread has issued so far has landed.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// Makes this thread's plain writes so far visible to later bulk copies (the
// async proxy), which write past the plain loads and stores.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
// A barrier of the producer warps alone, and one of the consumer warps alone.
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kProducerThreads) : "memory");
}
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kThreads) : "memory");
}
// Hands registers from the producer warpgroup to the consumers: every warp
// of a warpgroup calls its side once, first thing, and the two sides of the
// kernel never join again (ptxas then keeps each side within its count).
__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
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

// A consumer thread's part of one pass: rows [r0, r0 + rows) x columns
// [n0, n0 + ncols) of a GEMM. Warp w multiplies rows 16w .. 16w+15 of the pass
// by all its columns; warps 0-3 and 4-7 are the two warpgroups.
struct Pass {
  int r0, rows;   // first row, row count (<= kPassRows)
  int n0, ncols;  // first column, column count (a multiple of 8, <= kPassCols)
  bool active;    // the thread's warpgroup has rows in the pass (epilogue only)
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

// The two rings and their barriers. Each side (producer, consumer)
// counts what has gone through a ring since the barriers were initialised;
// item n of a ring of S lives in slot n % S, and its handover is phase
// (n / S) of the slot's full barrier, its return phase (n / S) of the empty one.
struct Rings {
  float* b;        // nbs stages of kStageFloats
  uint64_t* bars;  // full B, empty B, full A, empty A
  uint32_t nbs;    // B stages
  uint32_t nb;     // B chunks
  uint32_t na;     // A items
  __device__ uint64_t* full_b(uint32_t s) const { return bars + s; }
  __device__ uint64_t* empty_b(uint32_t s) const { return bars + kMaxBStages + s; }
  __device__ uint64_t* full_a(uint32_t s) const { return bars + 2 * kMaxBStages + s; }
  __device__ uint64_t* empty_a(uint32_t s) const { return bars + 2 * kMaxBStages + kAStages + s; }
};

struct Chunk {
  int kb0;    // first 8-row block of the packed weight
  int nk8;    // 8-row blocks in the chunk (<= kSlice / 8)
  int a_off;  // float offset of the chunk's A rows in its slot
};

// ---- producer side --------------------------------------------------------

// Producer: the bulk copy of one chunk of B (`bsrc`: the CTA's column block of
// the packed weight) into the next stage, once the consumers have returned it.
__device__ __forceinline__ void produce_b(Rings& R, const float* __restrict__ bsrc,
                                          const Chunk c) {
  const uint32_t n = R.nb++, slot = n % R.nbs;
  if (threadIdx.x == kBIssuer) {
    mbar_wait(R.empty_b(slot), ((n / R.nbs) & 1) ^ 1);
    const uint32_t bytes = c.nk8 * (kPassCols * 64);
    mbar_arrive_expect(R.full_b(slot), bytes);
    bulk_copy(R.b + slot * kStageFloats, bsrc + (size_t)c.kb0 * (kPassCols * 16), bytes,
              R.full_b(slot));
  }
}

// Producer: the next A slot, its address and full barrier; a stager waits
// until the consumers have returned it.
__device__ __forceinline__ float* a_begin(Rings& R, float* abase, int slot_floats,
                                          uint64_t*& full) {
  const uint32_t n = R.na++, slot = n % kAStages;
  if (threadIdx.x < kBIssuer) mbar_wait(R.empty_a(slot), ((n / kAStages) & 1) ^ 1);
  full = R.full_a(slot);
  return abase + slot * slot_floats;
}

// Producer: tile row tr in [0, nrows) <- columns [c0, c0 + nfill) of row
// src_row(tr) of a row-major matrix with row stride ld (zero past column ld,
// and in the whole row where tr lies outside [vlo, vhi)), with the optional
// affine by joint (in_s, in_t: (V, ld)). A float4-aligned matrix goes by
// cp.async, 16 bytes a thread and eight threads a row (bulk copies of single
// rows keep the copy engine busy for longer than the products take); the
// rest by plain loads. Every stager arrives on `full` twice: for its plain
// stores, and (cp.async) when its copies have landed; other threads return.
template <bool kAffine, class SrcRow>
__device__ __forceinline__ void stage_rows(float* __restrict__ tile, int nrows, int vlo, int vhi,
                                           const float* __restrict__ src, int ld, int c0,
                                           int nfill, int V, const float* in_s,
                                           const float* in_t, SrcRow src_row, uint64_t* full) {
  const int pt = threadIdx.x - kThreads;
  if (pt >= kStagers) return;
  const int ncopy = imin(nfill, ld - c0);  // columns with a source
  if (!kAffine && (ld & 3) == 0) {
    constexpr int kQ = kSlice / 4, kStep = kStagers / kQ;
    const int c = 4 * (pt % kQ);
    if (c < nfill)
      for (int tr = pt / kQ; tr < nrows; tr += kStep) {
        float* dst = tile + tr * kRowStride + c;
        if (tr >= vlo && tr < vhi && c < ncopy)
          cp_async16(dst, src + (size_t)src_row(tr) * ld + c0 + c);
        else
          st4(dst, make_float4(0.f, 0.f, 0.f, 0.f));
      }
  } else {
    for (int tr = pt; tr < nrows; tr += kStagers) {
      float* dst = tile + tr * kRowStride;
      const bool live = tr >= vlo && tr < vhi;
      const int xr = live ? src_row(tr) : 0;
      const float* xp = src + (size_t)xr * ld + c0;
      const int w = xr % V;
#pragma unroll 4
      for (int c = 0; c < nfill; ++c) {
        float v = 0.f;
        if (live && c < ncopy) {
          v = xp[c];
          if (kAffine) v = fmaf(v, in_s[w * ld + c0 + c], in_t[w * ld + c0 + c]);
        }
        dst[c] = v;
      }
    }
  }
  mbar_arrive(full);
  cp_async_arrive(full);
}

// ---- consumer side --------------------------------------------------------

// The A fragments of one wgmma group: two 8-deep steps, hi and lo halves.
struct Frags {
  uint32_t h[2][4], l[2][4];
};

// The A operand as a slot holds it: off[h] is the float offset of the
// thread's fragment rows (g, g+8) in the slot, column lane%4 included. Loads
// and splits steps 2G, 2G+1 of a chunk (zero past its nk8 steps: the products
// there are zero whatever the B stage holds).
struct SlotA {
  int off[2];
  template <int G>
  __device__ __forceinline__ void load(Frags& f, const float* ap, int nk8, int) const {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int q = 2 * G + u;
      const float* a0 = ap + off[0] + q * 8;
      const float* a1 = ap + off[1] + q * 8;
      const bool live = q < nk8;
      const float raw[4] = {live ? a0[0] : 0.f, live ? a1[0] : 0.f, live ? a0[4] : 0.f,
                            live ? a1[4] : 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(raw[e], f.h[u][e], f.l[u][e]);
    }
  }
};

// The graph conv's A operand, z[r=(t,w)][i] = sum_v A[k,v,w] x[t,v,i] for
// chunk (slice, partition k), contracted from the slot's x frames right into
// the thread's fragments (fp32 FMAs in the order of the nonzeros, over the
// nonzeros of A only); off[h] is the float offset of row h's frame in the
// slot (column lane%4 included), w[h] its joint. Group 0 contracts all four
// steps, the two rows side by side (their loads in flight together), and
// keeps steps 2 and 3 for group 1.
struct ContractA {
  int off[2], w[2];
  const int* nbr;      // offsets by (k, w)
  const int* nbr_v;    // joints
  const float* nbr_a;  // weights
  int V, K;
  float later[2][4];   // steps 2, 3 of the chunk, in fragment order
  template <int G>
  __device__ __forceinline__ void load(Frags& f, const float* xs, int nk8, int i) {
    if (G == 0) {
      const int k = i % K;
      float z[4][4];  // [step][fragment entry]
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[q][e] = 0.f;
      const int e0 = nbr[k * V + w[0]], n0 = nbr[k * V + w[0] + 1] - e0;
      const int e1 = nbr[k * V + w[1]], n1 = nbr[k * V + w[1] + 1] - e1;
      for (int j = 0; j < imax(n0, n1); ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = (h ? e1 : e0) + j;
          if (j < (h ? n1 : n0)) {
            const float a = nbr_a[e];
            const float* xr = xs + off[h] + nbr_v[e] * kRowStride;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              z[q][h] = fmaf(a, xr[q * 8], z[q][h]);
              z[q][2 + h] = fmaf(a, xr[q * 8 + 4], z[q][2 + h]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split_tf32(u < nk8 ? z[u][e] : 0.f, f.h[u][e], f.l[u][e]);
          later[u][e] = 2 + u < nk8 ? z[2 + u][e] : 0.f;
        }
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(later[u][e], f.h[u][e], f.l[u][e]);
    }
  }
};

// Issues steps 2G, 2G+1 of a chunk into d as one wgmma group (small terms
// first; the chunk's first product starts d from zero).
template <int G>
__device__ __forceinline__ void issue_group(float (&d)[32], const Frags& f, uint32_t bs) {
  wgmma_fence();
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int q = 2 * G + u;
    const uint64_t b_hi = b_descriptor(bs + q * (kPassCols * 64));
    const uint64_t b_lo = b_descriptor(bs + q * (kPassCols * 64) + kPassCols * 32);
    wgmma_tf32(d, f.l[u], b_hi, q != 0);
    wgmma_tf32(d, f.h[u], b_lo, 1);
    wgmma_tf32(d, f.h[u], b_hi, 1);
  }
  wgmma_commit();
}

// Consumer: chunk i of a pass, summed into `cur` as two wgmma groups with one
// in flight while the next is loaded. An odd chunk also adds the even chunk
// before it (`prev`, done once its own first group is issued) to acc and
// returns that chunk's B stage, and its A slot if chunk i starts a new one.
template <bool kOdd, class Loader, class ChunkOf, class Fresh>
__device__ __forceinline__ void consume_chunk(const int i, float (&cur)[32], float (&prev)[32],
                                              float (&acc)[32], Frags (&fr)[2], Loader& ld,
                                              Rings& R, uint32_t& item,
                                              const float* abase, int slot_floats,
                                              ChunkOf chunk_of, Fresh fresh) {
  const Chunk c = chunk_of(i);
  const bool starts = fresh(i);
  const uint32_t last_item = item;
  if (starts) {
    item = R.na++;
    mbar_wait(R.full_a(item % kAStages), (item / kAStages) & 1);
  }
  const uint32_t nb = R.nb + i, slot = nb % R.nbs;
  mbar_wait(R.full_b(slot), (nb / R.nbs) & 1);
  __syncwarp();
  const float* ap = abase + (item % kAStages) * slot_floats + c.a_off;
  const uint32_t bs = smem_u32(R.b + slot * kStageFloats);
  ld.template load<0>(fr[0], ap, c.nk8, i);
  issue_group<0>(cur, fr[0], bs);
  wgmma_wait<1>();  // the chunk before is multiplied
  if (kOdd) {
    fence_operand(prev);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] += prev[e];
    __syncwarp();
    if (threadIdx.x % 32 == 0) {
      mbar_arrive(R.empty_b((nb - 1) % R.nbs));
      if (starts) mbar_arrive(R.empty_a(last_item % kAStages));
    }
  }
  ld.template load<1>(fr[1], ap, c.nk8, i);
  issue_group<1>(cur, fr[1], bs);
  wgmma_wait<1>();  // the first group of chunk i is done: fr[0] may be rewritten
}

// Consumer: waits for the last chunk issued (i, in `part`), adds it to acc
// and returns its B stage, and its A slot if that ends with it.
template <class Fresh>
__device__ __forceinline__ void drain_chunk(const int i, const int nchunks, float (&part)[32],
                                            float (&acc)[32], Rings& R, uint32_t item,
                                            Fresh fresh) {
  wgmma_wait<0>();
  fence_operand(part);
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] += part[e];
  __syncwarp();
  if (threadIdx.x % 32 == 0) {
    mbar_arrive(R.empty_b((R.nb + i) % R.nbs));
    if (i + 1 == nchunks || fresh(i + 1)) mbar_arrive(R.empty_a(item % kAStages));
  }
}

// Consumer: acc = A * B over the `nchunks` chunks of one pass. chunk_of(i)
// names chunk i, fresh(i) whether it starts a new A slot, and `ld` loads its
// fragments. The chunks' sums are added to acc in order, each in fp32. Chunks
// go in pairs, the pair's groups back to back with one in flight; the wait at
// a pair's end leaves none in flight across the loop, which ptxas needs to
// keep them asynchronous while other sums are read.
template <class Loader, class ChunkOf, class Fresh>
__device__ __forceinline__ void consume_pass(float (&acc)[32], Loader& ld, Rings& R,
                                             const float* abase, int slot_floats, int nchunks,
                                             ChunkOf chunk_of, Fresh fresh) {
  float part0[32], part1[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = part0[e] = part1[e] = 0.f;
  Frags fr[2];
  uint32_t item = 0;
  int i = 0;
  for (; i + 1 < nchunks; i += 2) {
    consume_chunk<false>(i, part0, part1, acc, fr, ld, R, item, abase, slot_floats, chunk_of,
                         fresh);
    consume_chunk<true>(i + 1, part1, part0, acc, fr, ld, R, item, abase, slot_floats,
                        chunk_of, fresh);
    drain_chunk(i + 1, nchunks, part1, acc, R, item, fresh);
  }
  if (i < nchunks) {
    consume_chunk<false>(i, part0, part1, acc, fr, ld, R, item, abase, slot_floats, chunk_of,
                         fresh);
    drain_chunk(i, nchunks, part0, acc, R, item, fresh);
  }
  R.nb += nchunks;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

// The thread's accumulators of a pass: column group j holds the two sums
// acc[4j + 2h], acc[4j + 2h + 1] of columns col(P, j), col(P, j) + 1 in row
// half h (global row P.r0 + P.row[h]). Only rows inside the pass and columns
// below C are live. Epilogues load all they read before their first store:
// the compiler may not move a load past a store that could alias it, and a
// load, store, load, ... chain waits on L2 once an element.
__device__ __forceinline__ int acc_col(const Pass& P, int j) {
  return P.n0 + j * 8 + 2 * (threadIdx.x % 4);
}
__device__ __forceinline__ bool acc_live(const Pass& P, int j, int C) {
  return P.active && j * 8 < P.ncols && acc_col(P, j) < C;
}

// The four phases of one block on one sample: xn (T,V,Cin) -> on (T_out,V,C),
// with gn a (T,V,C) scratch. kAffine: x is read as x * in_s + in_t, both
// (V*Cin). Every thread of every CTA of the sample's cluster calls it with the
// same arguments, the producer warpgroup with kProducer and the consumers
// without; `smem` holds block_smem_floats(T, V, K, C, stride) floats and may be
// reused by the caller after a further cluster barrier. On return this CTA's
// part of `on` is written; a cluster barrier makes all of it visible to the
// cluster.
template <bool kAffine, bool kProducer>
__device__ __forceinline__ void stgcan_block_phases(
    const BlockConsts& p, const int T, const int V, const int Cin, const int K,
    const float* xn, const float* in_s, const float* in_t, float* gn, float* on,
    cg::cluster_group& cluster, float* smem) {
  const int C = p.C, H = C / 4;
  const int stride = p.stride;
  const int T_out = (T - 1) / stride + 1;
  const int cp8 = round8(C), cinp8 = round8(Cin);
  const int lane_t = threadIdx.x % 4;
  constexpr bool producer = kProducer;
  const int pt = threadIdx.x - kThreads;  // producer thread, when producer
  constexpr int S = kRowStride;

  // The sample's parts: rows x columns of every GEMM, part q = (q / cc, q % cc);
  // this CTA takes parts rank, rank + ncta, ...
  const int ncta = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int nlp = kParts / ncta;  // parts of this CTA
  const int cc = col_parts(C), cr = kParts / cc;
  const int rows1 = T * V, rows2 = T_out * V;
  const int share1 = row_share(rows1, cr), share2 = row_share(rows2, cr);
  struct Part {
    int n0, ncols;     // columns (column blocks of kPassCols, as the weights are packed)
    int beg1, end1;    // rows of the graph conv
    int beg2, end2;    // rows of the taps and the residual
  };
  auto part_of = [&](int lp) {
    const int q = rank + lp * ncta, rr = q / cc;
    Part P;
    P.n0 = (q % cc) * kPassCols;
    P.ncols = imax(0, imin(kPassCols, cp8 - P.n0));
    P.beg1 = P.ncols ? rr * share1 : rows1;
    P.end1 = imin(rows1, rr * share1 + share1);
    P.beg2 = P.ncols ? rr * share2 : rows2;
    P.end2 = imin(rows2, rr * share2 + share2);
    return P;
  };
  const int m2 = pass_rows2(T, V, C, stride);

  const int nbs = b_stages(T, V, K, C, stride, ncta);
  float* abase = smem + nbs * kStageFloats;                    // a_region_rows * S
  int* nbr = reinterpret_cast<int*>(abase + a_region_rows(T, V, C, stride) * S);  // <= dense
  float* part = reinterpret_cast<float*>(nbr) + round4(nbr_ints(K, V, K * V * V));  // nlp * kWarps * cp8
  float* mean = part + nlp * kWarps * cp8;                     // C
  float* gate = mean + C;                                      // C
  float* hid = gate + C;                                       // H
  uint64_t* bars = reinterpret_cast<uint64_t*>(hid + round4(H));  // kBars
  // per row of a residual pass, its row of x (no division in the staging)
  int* rowtab = reinterpret_cast<int*>(bars + kBars);
  Rings R{smem, bars, (uint32_t)nbs, 0, 0};

  if (threadIdx.x == 0) {
    for (int s = 0; s < nbs; ++s) {
      mbar_init(R.full_b(s), 1);
      mbar_init(R.empty_b(s), kWarps);
    }
    for (int s = 0; s < kAStages; ++s) {
      mbar_init(R.full_a(s), 2 * kStagers);
      mbar_init(R.empty_a(s), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Steps past a chunk's end read whatever its stage holds, times zero: the
  // stages start as zeros, never NaN.
  for (int e = threadIdx.x; e < nbs * kStageFloats / 4; e += kCtaThreads)
    st4(smem + 4 * e, make_float4(0.f, 0.f, 0.f, 0.f));
  for (int e = threadIdx.x; e < nbr_ints(K, V, p.nnz); e += kCtaThreads) nbr[e] = p.nbr[e];
  const int* nbr_v = nbr + K * V + 1;
  const float* nbr_a = reinterpret_cast<const float*>(nbr_v + p.nnz);
  for (int e = threadIdx.x; e < nlp * kWarps * cp8; e += kCtaThreads) part[e] = 0.f;
  fence_proxy_async();  // the zeros before the bulk copies into the stages
  __syncthreads();

  float acc[32];

  // The B chunks of each GEMM, from a part's column block of the packed weight.
  const int nsl1 = (Cin + kSlice - 1) / kSlice, nsl2 = (C + kSlice - 1) / kSlice;
  const int n1 = nsl1 * K, n2 = nsl2 * kTaps;
  auto chunk1 = [&](int i) {  // (channel slice s, partition k)
    const int s = i / K, k = i - s * K;
    return Chunk{(k * cinp8 + s * kSlice) / 8, imin(kSlice, cinp8 - s * kSlice) / 8, 0};
  };
  auto chunk2 = [&](int i) {  // (channel slice s, tap)
    const int s = i / kTaps, tap = i - s * kTaps;
    return Chunk{(tap * cp8 + s * kSlice) / 8, imin(kSlice, cp8 - s * kSlice) / 8, tap * V * S};
  };
  auto chunk4 = [&](int s) {  // channel slice s
    return Chunk{s * (kSlice / 8), imin(kSlice, cinp8 - s * kSlice) / 8, 0};
  };
  auto b1 = [&](const Part& P) {
    return p.gcn_w + (size_t)(P.n0 / kPassCols) * (K * cinp8 / 8) * (kPassCols * 16);
  };
  auto b2 = [&](const Part& P) {
    return p.tconv_w + (size_t)(P.n0 / kPassCols) * (kTaps * cp8 / 8) * (kPassCols * 16);
  };
  auto b4 = [&](const Part& P) {
    return p.res_w + (size_t)(P.n0 / kPassCols) * (cinp8 / 8) * (kPassCols * 16);
  };
  // The first part with rows in phases 2 and 4: the producers copy the first
  // B stages of its first pass before the cluster barrier in front of them.
  int first2 = 0;
  while (first2 < nlp && part_of(first2).beg2 >= part_of(first2).end2) ++first2;
  const int pre2 = first2 < nlp ? imin(nbs, n2) : 0;
  const int pre4 = p.mode == kResProj ? (first2 < nlp ? imin(nbs, nsl1) : 0) : 0;

  // ---- phase 1: graph conv + BN1 + ReLU -> g --------------------------------
  // Chunk i = (channel slice s, partition k). The producers stage the slice of
  // the pass's x frames (all joints) into a slot, for K chunks; the consumers
  // contract the adjacency on it as they load their fragments (ContractA).
  {
    const int xslot = x_rows(T, V, C) * S;
    for (int lp = 0; lp < nlp; ++lp) {
      const Part Q = part_of(lp);
      for (int r0 = Q.beg1; r0 < Q.end1; r0 += kPassRows) {
        const int rows = imin(kPassRows, Q.end1 - r0);
        const int f_first = r0 / V, f_last = (r0 + rows - 1) / V;
        if (producer) {
          const int xrows = (f_last - f_first + 1) * V;
          for (int i = 0; i < n1; ++i) {
            produce_b(R, b1(Q), chunk1(i));
            if (i % K == 0) {
              uint64_t* full;
              float* X = a_begin(R, abase, xslot, full);
              stage_rows<kAffine>(X, xrows, 0, xrows, xn, Cin, i / K * kSlice,
                                  chunk1(i).nk8 * 8, V, in_s, in_t,
                                  [&](int tr) { return f_first * V + tr; }, full);
            }
          }
        } else {
          const Pass P = make_pass(r0, rows, Q.n0, Q.ncols);
          ContractA ld{{0, 0}, {0, 0}, nbr, nbr_v, nbr_a, V, K, {}};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + imax(P.row[h], 0), tt = r / V;
            ld.off[h] = (tt - f_first) * V * S + lane_t;
            ld.w[h] = r - tt * V;
          }
          consume_pass(acc, ld, R, abase, xslot, n1, chunk1, [&](int i) { return i % K == 0; });
#pragma unroll
          for (int j0 = 0; j0 < 8; j0 += 4) {  // half the column groups at a time
            float2 s1[4], sh[4][2];
#pragma unroll
            for (int j = j0; j < j0 + 4; ++j) {
              if (!acc_live(P, j, C)) continue;
              s1[j - j0] = ld2(p.bn1_s + acc_col(P, j));
#pragma unroll
              for (int h = 0; h < 2; ++h)
                if (P.row[h] >= 0) sh[j - j0][h] = ld2(p.g_shift + ld.w[h] * C + acc_col(P, j));
            }
#pragma unroll
            for (int j = j0; j < j0 + 4; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                if (acc_live(P, j, C) && P.row[h] >= 0)
                  st2(gn + (size_t)(r0 + P.row[h]) * C + acc_col(P, j),
                      make_float2(
                          fmaxf(fmaf(acc[4 * j + 2 * h], s1[j - j0].x, sh[j - j0][h].x), 0.f),
                          fmaxf(fmaf(acc[4 * j + 2 * h + 1], s1[j - j0].y, sh[j - j0][h].y),
                                0.f)));
          }
        }
      }
    }
    if (producer && pre2)  // phase 2's first stages
      for (int i = 0; i < pre2; ++i) produce_b(R, b2(part_of(first2)), chunk2(i));
  }
  cluster.sync();  // every row of g is written and visible to the cluster

  // ---- phase 2: 9-tap temporal conv + bias + BN2 -> out; SE sums -------------
  // Chunk i = (channel slice s, tap). The slice's slot holds g frames
  // f0 .. f0 + nfr - 1 (all joints), f0 = first output frame * stride - 4;
  // output row (to, w) reads slot row ((to - to_first)*stride + tap)*V + w.
  {
    const int slot2 = g_rows(T, V, C, stride) * S;
    int pre = pre2;
    for (int lp = 0; lp < nlp; ++lp) {
      const Part Q = part_of(lp);
      float* qpart = part + lp * kWarps * cp8;  // this part's column sums, by warp
      for (int r0 = Q.beg2; r0 < Q.end2; r0 += kPassRows) {
        const int rows = imin(kPassRows, Q.end2 - r0);
        const int to_first = r0 / V, to_last = (r0 + rows - 1) / V;
        const int f0 = to_first * stride - kPad;
        const int trows = ((to_last - to_first) * stride + kTaps) * V;
        if (producer) {
          for (int i = 0; i < n2; ++i) {
            const int s = i / kTaps;
            if (i >= pre) produce_b(R, b2(Q), chunk2(i));
            if (i - s * kTaps == 0) {
              uint64_t* full;
              float* G = a_begin(R, abase, slot2, full);
              // g rows f0*V + tr; past either end of the clip: zeros
              stage_rows<false>(G, trows, imax(0, -f0 * V), imin(trows, rows1 - f0 * V), gn, C,
                                s * kSlice, chunk2(i).nk8 * 8, V, nullptr, nullptr,
                                [&](int tr) { return f0 * V + tr; }, full);
            }
          }
          pre = 0;
        } else {
          const Pass P = make_pass(r0, rows, Q.n0, Q.ncols);
          SlotA ld;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + imax(P.row[h], 0), to = r / V;
            ld.off[h] = ((to - to_first) * stride * V + (r - to * V)) * S + lane_t;
          }
          consume_pass(acc, ld, R, abase, slot2, n2, chunk2,
                       [](int i) { return i % kTaps == 0; });

          // y, and its column sums over the warp's 16 rows (lanes that differ in
          // lane/4) for SE: one warp owns an entry of `qpart` in every pass. (Its
          // loads are not hoisted ahead of the stores as in the other epilogues:
          // in the whole-backbone kernel the registers that takes cost more,
          // measured, than the waits.)
          const int warp = threadIdx.x / 32;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = acc_col(P, j);
            const bool live = acc_live(P, j, C);
            float s0 = 0.f, s1 = 0.f;
            if (live) {
              const float2 s2 = ld2(p.bn2_s + col), sh = ld2(p.y_shift + col);
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
              qpart[warp * cp8 + col] += s0;
              qpart[warp * cp8 + col + 1] += s1;
            }
          }
        }
      }
    }
    if (producer && pre4)  // phase 4's first stages
      for (int i = 0; i < pre4; ++i) produce_b(R, b4(part_of(first2)), chunk4(i));
  }

  // ---- phase 3: squeeze-excite gate -----------------------------------------
  cluster.sync();  // every CTA's partial sums are in its shared memory
  for (int c = threadIdx.x; c < C; c += kCtaThreads) {
    float s = 0.f;
    for (int q = 0; q < kParts; ++q) {  // part q: CTA q % ncta, its part q / ncta
      const float* remote = cluster.map_shared_rank(part, q % ncta) + q / ncta * kWarps * cp8;
      for (int m = 0; m < kWarps; ++m) s += remote[m * cp8 + c];
    }
    mean[c] = s / (float)rows2;
  }
  cluster.sync();  // no CTA leaves or reuses `part` while another reads it
  for (int j = threadIdx.x; j < H; j += kCtaThreads) {
    float h = p.se_b1[j];
    for (int c = 0; c < C; ++c) h = fmaf(mean[c], p.se_w1[c * H + j], h);
    hid[j] = fmaxf(h, 0.f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kCtaThreads) {
    float z = p.se_b2[c];
    for (int j = 0; j < H; ++j) z = fmaf(hid[j], p.se_w2[j * C + c], z);
    gate[c] = 1.f / (1.f + expf(-z));
  }
  __syncthreads();

  // ---- phase 4: gate + residual + ReLU on this CTA's parts of out ------------
  if (p.mode == kResProj) {
    // A operand: row (to, w) <- x row (to*stride, w), one channel slice a chunk.
    int pre = pre4;
    for (int lp = 0; lp < nlp; ++lp) {
      const Part Q = part_of(lp);
      for (int r0 = Q.beg2; r0 < Q.end2; r0 += kPassRows) {
        const int rows = imin(kPassRows, Q.end2 - r0);
        if (producer) {
          producer_sync();  // the last pass's readers of rowtab are done
          for (int pr = pt; pr < rows; pr += kProducerThreads) {  // row -> its row of x
            const int to = (r0 + pr) / V;
            rowtab[pr] = to * stride * V + (r0 + pr - to * V);
          }
          producer_sync();
          for (int s = 0; s < nsl1; ++s) {
            if (s >= pre) produce_b(R, b4(Q), chunk4(s));
            uint64_t* full;
            float* Xr = a_begin(R, abase, m2 * S, full);
            stage_rows<kAffine>(Xr, rows, 0, rows, xn, Cin, s * kSlice, chunk4(s).nk8 * 8, V,
                                in_s, in_t, [&](int tr) { return rowtab[tr]; }, full);
          }
          pre = 0;
        } else {
          const Pass P = make_pass(r0, rows, Q.n0, Q.ncols);
          SlotA ld;
#pragma unroll
          for (int h = 0; h < 2; ++h) ld.off[h] = imax(P.row[h], 0) * S + lane_t;
          consume_pass(acc, ld, R, abase, m2 * S, nsl1, chunk4, [](int) { return true; });
#pragma unroll
          for (int j0 = 0; j0 < 8; j0 += 4) {  // half the column groups at a time
            float2 rs[4], rt[4], y[4][2];
#pragma unroll
            for (int j = j0; j < j0 + 4; ++j) {
              if (!acc_live(P, j, C)) continue;
              rs[j - j0] = ld2(p.res_s + acc_col(P, j));
              rt[j - j0] = ld2(p.res_t + acc_col(P, j));
#pragma unroll
              for (int h = 0; h < 2; ++h)
                if (P.row[h] >= 0)
                  y[j - j0][h] = ld2(on + (size_t)(r0 + P.row[h]) * C + acc_col(P, j));
            }
#pragma unroll
            for (int j = j0; j < j0 + 4; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                if (acc_live(P, j, C) && P.row[h] >= 0) {
                  const int col = acc_col(P, j);
                  const float2 a = y[j - j0][h], s = rs[j - j0], t = rt[j - j0];
                  st2(on + (size_t)(r0 + P.row[h]) * C + col,
                      make_float2(fmaxf(fmaf(a.x, gate[col], fmaf(acc[4 * j + 2 * h], s.x, t.x)), 0.f),
                                  fmaxf(fmaf(a.y, gate[col + 1],
                                             fmaf(acc[4 * j + 2 * h + 1], s.y, t.y)),
                                        0.f)));
                }
          }
        }
      }
    }
  } else if (!producer) {
    // identity needs Cin == C and stride 1 (checked by the wrapper): the
    // residual of row r is row r of x, float4-aligned. A thread takes float4
    // number threadIdx.x % 16 of every 16th row.
    // Four rows at a time, loads before stores (see acc_col).
    const bool identity = p.mode == kResIdentity;
    constexpr int kPer = kPassCols / 4, kStep = kThreads / kPer, kBatch = 4;
    for (int lp = 0; lp < nlp; ++lp) {
      const Part Q = part_of(lp);
      const int q = threadIdx.x % kPer, c = Q.n0 + 4 * q;
      if (c >= C || q * 4 >= Q.ncols) continue;
      const float4 a = ld4(gate + c);
      for (int r0 = Q.beg2 + threadIdx.x / kPer; r0 < Q.end2; r0 += kBatch * kStep) {
        float4 y[kBatch], res[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int r = r0 + u * kStep;
          y[u] = res[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < Q.end2) {
            y[u] = ld4(on + (size_t)r * C + c);
            if (identity) {
              res[u] = ld4(xn + (size_t)r * Cin + c);
              if (kAffine) {
                const int w = r % V;
                res[u] = affine4(res[u], ld4(in_s + w * Cin + c), ld4(in_t + w * Cin + c));
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int r = r0 + u * kStep;
          if (r < Q.end2)
            st4(on + (size_t)r * C + c,
                make_float4(fmaxf(fmaf(y[u].x, a.x, res[u].x), 0.f),
                            fmaxf(fmaf(y[u].y, a.y, res[u].y), 0.f),
                            fmaxf(fmaf(y[u].z, a.z, res[u].z), 0.f),
                            fmaxf(fmaf(y[u].w, a.w, res[u].w), 0.f)));
        }
      }
    }
  }
  __syncthreads();  // the rings are idle: their barriers may be initialised anew by a next block
  if (threadIdx.x == 0) {
    for (int s = 0; s < nbs; ++s) {
      mbar_inval(R.full_b(s));
      mbar_inval(R.empty_b(s));
    }
    for (int s = 0; s < 2 * kAStages; ++s) mbar_inval(R.full_a(0) + s);
  }
}

// CTAs a sample for a launch of `samples` samples: kParts CTAs each take one
// part, so that a few samples (batch 1: 4 SMs) finish soonest; once the
// samples outnumber the clusters the card holds at once, fewer CTAs a sample
// (each taking several parts in turn) fill the card in fewer rounds. The
// choice minimises rounds x parts a CTA; on a tie, fewer CTAs a sample, whose
// fixed costs (set-up, SE gate, cluster barriers) are then shared by more
// parts (measured at batch 128: 4-7% faster with one CTA a sample than two).
// `clusters(ncta)` is how many clusters of ncta CTAs the card holds at once.
template <class Resident>
inline int ctas_per_sample(int samples, Resident clusters) {
  int best = kParts;
  long best_cost = -1;
  for (int ncta = kParts; ncta >= 1; ncta /= 2) {
    const int held = clusters(ncta);
    if (held < 1) continue;
    const long cost = (long)((samples + held - 1) / held) * (kParts / ncta);
    if (best_cost < 0 || cost <= best_cost) {
      best = ncta;
      best_cost = cost;
    }
  }
  return best;
}

// Launches `kernel(args)` on `stream` for `samples` samples, one cluster a
// sample, with smem_bytes(ncta) bytes of dynamic shared memory a CTA; returns
// the CUDA error code (0 = queued). The clusters the card holds at once are
// asked once per device, cluster size and shared memory.
template <class Kernel, class Args, class SmemBytes>
inline int launch_clusters(Kernel kernel, const Args& args, int samples, SmemBytes smem_bytes,
                           void* stream) {
  static std::mutex lock;
  static std::map<std::pair<std::pair<int, int>, size_t>, int> resident;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.blockDim = dim3(kCtaThreads);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  auto prepare = [&](int ncta) {
    const size_t smem = smem_bytes(ncta);
    config.gridDim = dim3(ncta);
    config.dynamicSmemBytes = smem;
    attr[0].val.clusterDim.x = ncta;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  };
  const int ncta = ctas_per_sample(samples, [&](int n) {
    const size_t smem = smem_bytes(n);
    std::lock_guard<std::mutex> hold(lock);
    const auto key = std::make_pair(std::make_pair(device, n), smem);
    const auto found = resident.find(key);
    if (found != resident.end()) return found->second;
    int held = 0;
    if (prepare(n) != cudaSuccess || cudaOccupancyMaxActiveClusters(&held, kernel, &config) !=
                                         cudaSuccess) {
      cudaGetLastError();  // a size the card does not take: not chosen
      held = 0;
    }
    resident[key] = held;
    return held;
  });
  err = prepare(ncta);
  if (err != cudaSuccess) return (int)err;
  config.gridDim = dim3(samples * ncta);
  err = cudaLaunchKernelEx(&config, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace stgcan
