// K4: one TARGCN graph-GRU layer (models/targcn.py:GraphGRUCell.scan with
// gated EmbGCN gate and update, hidden width 64) over every frame in one
// launch, for Hopper (sm_90a). fp32 in and out; every product on the tensor
// cores in split TF32, the graph mixing and the gates in fp32.
//
// Replaces no TPU kernel: the JAX package runs TARGCN through XLA
// (fall_multimodal_tpu/models/targcn.py reaches no pallas_call). It was added
// because the stock loop took 74 ms of a 100 ms forward at batch 8,192:
// about 28 stock ops a frame and layer, each writing and re-reading a
// (B, V, 128) tensor, ~1,700 launches a forward that the host enqueued
// behind the card.
//
// What it computes, for each window b of x (B, T, V, Cx) from h = 0, with
// the supports S (V x V), node-wise weights Wg[n] (Cx+64 x 128), Wu[n]
// (Cx+64 x 64) and biases that ops/graph_gru.py generates once a call, and
// the static branches' linears Lg, Lu and column weights col:
//   per frame t:  xh  = [x_t, h]                                 (V, Cx+64)
//                 pre = (S xh)[n] Wg[n] + bg[n] + sg(col[n] xh[n] Lg^T + lbg)
//                 z, r = sigmoid(pre)                            (64 each)
//                 xr  = [x_t, r*h]
//                 hh  = tanh((S xr)[n] Wu[n] + bu[n] + sg(col[n] xr[n] Lu^T + lbu))
//                 h   = z*h + (1-z)*hh;  out[b, t] = h
// with sg(s) = sigmoid(s) * s. The weights come in mma fragment order
// (ops/graph_gru.py:fragments): a (rows, K) matrix as [rows/16][K/8][lane]
// [4], the gate's rows reordered so that an m16 tile holds z and r of the
// same eight features; K is the input padded to KX (8 or 64) then h's 64.
//
// What bounds it on this card. The products are 1.47 MFLOP a window and
// frame at layer 1 (Cx 64), 0.77 at layer 0 (Cx 3): 553 GFLOP a forward at
// batch 8,192 with the graph mixing, 1.1 ms at TF32's 495 TFLOP/s, about
// 5.4 ms in split TF32 at mma.sync's ~310 TFLOP/s. The least bytes are 1.8
// GB (x read once, every h written once; 0.54 ms at 3.35 TB/s). The
// node-wise weights (96 KB a node at layer 1, 1.38 MB a frame) do not fit
// in shared memory, so every CTA streams them from L2 every frame: 33 GB of
// L2 reads a forward at 16 windows a CTA. Operations and L2 bandwidth
// bound it.
//
// What the design does about it:
// * The state never leaves the SM. A CTA owns 16 windows and all V nodes
//   for all T frames: x_t, h and r*h live in shared memory (V x 16 x 68
//   floats each), x is read once and each h_t written once. z waits for the
//   blend in the output's own frame slot (L2), which h_t then overwrites.
// * The products run with the weights as the A operand (M = 128 gate or
//   64 update rows, K = KX + 64) and the windows as N (two n8 tiles), on
//   mma.sync m16n8k8 in split TF32 (an operand a = hi + lo, three products,
//   fp32 accuracy). A warp's node-wise A fragments are read from L2 straight
//   into registers, each once a CTA and frame, through a register ring
//   several k-steps ahead that runs across node boundaries; the static
//   linears' fragments (shared by every node) are read once a phase and
//   stay in registers through its 14 nodes.
// * The graph mixing S [x, h] for node n+1 is formed in fp32 FMA by every
//   thread while the tensor cores work on node n, and stored already split
//   into TF32 halves (double-buffered), so the eight warps that read it as
//   their B operand do not split it again.
// * The gate's 8 m16 tiles take a warp each. The update's 4 tiles take a
//   pair of warps each, split along K, the halves summed through shared
//   memory, each warp of the pair finishing one n tile.
// * The gates' logistic and tanh are branch-free (expf and a Newton-refined
//   reciprocal; a polynomial for small tanh), so the epilogue's 16
//   logistics a lane overlap instead of running one after another.
// What it leaves (H100 at 700 W, batch 8,192): layer 0 in 8.7 ms, layer 1
// in 11.5 ms, 24-31 TFLOP/s; clock64() phases of a layer-1 node put 80% of
// the gate's cycles and 65% of the update's in the k-loop, which issues
// ~8 instructions a product (splits, fragment loads, the interleaved
// mixing) from two warps a scheduler. From those counts (an estimate: no
// hardware counter was read), issue, shared-memory traffic (every warp
// reads the same B fragments) and the tensor pipe each sit near half of
// their rate. 16 warps of half the K (4 a scheduler) or two tiles a warp
// were slower here (registers capped at 128 spill; under full load the
// two-tile warps waited on L2), as was streaming the static fragments.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kH = 64;          // hidden width the kernel is built for
constexpr int kWt = 16;         // windows a CTA
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxV = 16;       // nodes
constexpr int kGateTiles = 8;   // 128 gate rows
constexpr int kUpdTiles = 4;    // 64 update rows
constexpr int kTiles = kGateTiles + kUpdTiles;
constexpr int kBiases = 16 * kTiles;        // 192 a node: gate (reordered), then update
constexpr int kLdH = kH + 4;                // h, r*h rows: 68 = 4 mod 32
constexpr int kRedFloats = kUpdTiles * 2 * 8 * 32;
constexpr int kSmallFloats = kMaxV * kMaxV + kMaxV;

template <int KX>
struct Dims {
  static constexpr int K = KX + kH;
  static constexpr int KS = K / 8;          // k-steps
  static constexpr int KXS = KX / 8;        // k-steps of x
  static constexpr int LdX = KX + 4;        // 12 or 68: conflict-free fragment reads
  static constexpr int LdG = K + 4;         // 76 or 132
  static constexpr int KH0 = (KS + 1) / 2;  // the update's first K half
};

// Register-ring depth for KN k-steps a node: it divides KN, so that a slot's
// index stays a constant across nodes.
__host__ __device__ constexpr int ring_depth(int kn) {
  return kn % 4 == 0 ? 4 : kn % 3 == 0 ? 3 : kn % 5 == 0 ? 5 : kn % 2 == 0 ? 2 : 1;
}

__host__ __device__ constexpr size_t smem_floats(int V, int KX) {
  return (size_t)V * kWt * (KX + 4) + 2 * (size_t)V * kWt * kLdH + 4 * kWt * (KX + kH + 4) +
         kRedFloats + kSmallFloats;
}

// a rounded to TF32, to nearest with ties away from zero (csrc/temporal_transformer.cu).
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// The same with lo left for the tensor core to truncate to TF32 (as
// CUTLASS's 3xTF32 does): |lo| <= 2^-11 |a|, so the truncation moves a by at
// most 2^-21 |a|; two instructions fewer for an operand split in the loop.
__device__ __forceinline__ void split_tf32_fast(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = __float_as_uint(a - __uint_as_float(hi));
}

__device__ __forceinline__ void split4_fast(const float4& a, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  split_tf32_fast(a.x, hi[0], lo[0]);
  split_tf32_fast(a.y, hi[1], lo[1]);
  split_tf32_fast(a.z, hi[2], lo[2]);
  split_tf32_fast(a.w, hi[3], lo[3]);
}

__device__ __forceinline__ void split4(const float4& a, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(a.x, hi[0], lo[0]);
  split_tf32(a.y, hi[1], lo[1]);
  split_tf32(a.z, hi[2], lo[2]);
  split_tf32(a.w, hi[3], lo[3]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a * b + c ... in split TF32, small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// 1 / d for d in [1, 1e35]: the hardware's approximation and one Newton
// step, within an ulp, and with no branch (an IEEE division `1.f / d` keeps
// a slow path for huge and tiny d, whose branches serialise the epilogue).
__device__ __forceinline__ float reciprocal(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return fmaf(r, fmaf(-d, r, 1.f), r);
}

// Full-precision expf; below -80 the logistic is under 2e-35 and is held there.
__device__ __forceinline__ float sigmoid(float v) {
  return reciprocal(1.f + expf(-fmaxf(v, -80.f)));
}

// tanh within 2 ulp, branch-free: an odd polynomial below 0.6 (under an ulp
// there, fitted to tanh in float64), 1 - 2 / (e^2|v| + 1) above it.
__device__ __forceinline__ float tanh_exact(float v) {
  const float a = fabsf(v), u = v * v;
  float p = fmaf(-5.908978637e-3f, u, 2.080874704e-2f);
  p = fmaf(p, u, -5.378796905e-2f);
  p = fmaf(p, u, 1.333197802e-1f);
  p = fmaf(p, u, -3.333330154e-1f);
  const float small = fmaf(v * u, p, v);
  const float big = copysignf(1.f - 2.f * reciprocal(expf(2.f * fminf(a, 10.f)) + 1.f), v);
  return a < 0.6f ? small : big;
}

// The static branch's gating s -> sigmoid(s) * s.
__device__ __forceinline__ float gated(float s) { return sigmoid(s) * s; }

// The two K halves of the update run as two copies of its code, so the
// barriers there are the unaligned forms: the whole CTA, and the warp pair
// (w, w + 4) of an update tile (barrier 1 + tile).
__device__ __forceinline__ void cta_sync() { asm volatile("barrier.sync 0;\n" ::: "memory"); }

__device__ __forceinline__ void pair_sync(int tile) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(tile + 1), "r"(64) : "memory");
}

struct Smem {
  float* X;    // [V][kWt][LdX]: x_t, channels past Cx zero
  float* H;    // [V][kWt][kLdH]: h
  float* RH;   // [V][kWt][kLdH]: r * h
  float* G;    // [2 buffers][hi, lo][kWt][LdG]: S [x, h] of one node, split
  float* RED;  // [update tile][k half][8][32]: partial sums of the other n tile
  float* S;    // [kMaxV][kMaxV] supports
  float* COL;  // [kMaxV]
};

// The graph mixing of one node, G[buf] = split(sum_m S[n][m] [X[m], hsrc[m]])
// for the CTA's windows: each thread owns up to kChunks float4 of the
// (window, K) tile. `steps` takes nodes m in [m0, m1), so that the products
// of the node before can interleave it k-step by k-step.
template <int KX>
struct Stager {
  static constexpr int C4 = Dims<KX>::K / 4;                       // float4 a window row
  static constexpr int kChunks = (kWt * C4 + kThreads - 1) / kThreads;
  const float* src[kChunks];  // node 0's float4 of the chunk
  int ld[kChunks];            // floats between nodes
  int dst[kChunks];           // offset in a G buffer
  float4 acc[kChunks];
  const float* srow;          // S[n]

  __device__ __forceinline__ Stager(const Smem& sm, const float* hsrc) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = threadIdx.x + c * kThreads;
      const int w = i / C4, k = 4 * (i - w * C4);
      const bool x_part = k < KX;
      src[c] = x_part ? sm.X + w * Dims<KX>::LdX + k : hsrc + w * kLdH + (k - KX);
      ld[c] = i < kWt * C4 ? (x_part ? kWt * Dims<KX>::LdX : kWt * kLdH) : 0;
      dst[c] = w * Dims<KX>::LdG + k;
    }
  }
  __device__ __forceinline__ void begin(const Smem& sm, int n) {
    srow = sm.S + n * kMaxV;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void steps(int m0, int m1, int V) {
#pragma unroll
    for (int m = m0; m < m1; ++m) {
      if (m < V) {
        const float sv = srow[m];
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          if (ld[c] != 0) {
            const float4 v = *reinterpret_cast<const float4*>(src[c] + m * ld[c]);
            acc[c].x = fmaf(sv, v.x, acc[c].x);
            acc[c].y = fmaf(sv, v.y, acc[c].y);
            acc[c].z = fmaf(sv, v.z, acc[c].z);
            acc[c].w = fmaf(sv, v.w, acc[c].w);
          }
        }
      }
    }
  }
  __device__ __forceinline__ void finish(float* gb) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (ld[c] != 0) {
        uint32_t hi[4], lo[4];
        split4(acc[c], hi, lo);
        *reinterpret_cast<uint4*>(gb + dst[c]) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(gb + kWt * Dims<KX>::LdG + dst[c]) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
  }
};

// One warp's m16 tile over k-steps [KB, KB + KN) of one node, both n tiles:
// accW += A_node (S xh)^T, accS += A_static xh[n]^T, and, between the
// k-steps, the graph mixing of the next node when `mix` is set. `wn` points
// at the node's A fragments (this tile, k-step KB, this lane; 32 float4 a
// k-step), `wnext` at the next node's or is null; `ring` holds the first
// fragments of `wn` on entry and of `wnext` on exit.
template <int KX, int KB, int KN>
__device__ __forceinline__ void tile_products(float (&accW)[2][4], float (&accS)[2][4],
                                              float4 (&ring)[ring_depth(KN)],
                                              const float4 (&lstat)[KN], const float4* wn,
                                              const float4* wnext, const float* gc,
                                              const float* xs, const float* hs, int g, int q,
                                              Stager<KX>& stager, bool mix, int V) {
  using D = Dims<KX>;
  constexpr int P = ring_depth(KN);
#pragma unroll
  for (int kk = 0; kk < KN; ++kk) {
    const int ks = KB + kk;
    const float4 a4 = ring[kk % P];
    if (kk + P < KN)
      ring[kk % P] = __ldg(wn + (kk + P) * 32);
    else if (wnext != nullptr)
      ring[kk % P] = __ldg(wnext + (kk + P - KN) * 32);
    if (mix) stager.steps(kk * kMaxV / KN, (kk + 1) * kMaxV / KN, V);
    uint32_t ah[4], al[4], sh[4], sl[4];
    split4_fast(a4, ah, al);
    split4_fast(lstat[kk], sh, sl);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int w = 8 * j + g;
      const uint32_t* gh = reinterpret_cast<const uint32_t*>(gc + w * D::LdG + 8 * ks);
      const uint32_t* gl = gh + kWt * D::LdG;
      const float* src = ks < D::KXS ? xs + w * D::LdX + 8 * ks : hs + w * kLdH + 8 * (ks - D::KXS);
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32_fast(src[q], bh0, bl0);
      split_tf32_fast(src[q + 4], bh1, bl1);
      mma3(accW[j], ah, al, gh[q], gh[q + 4], gl[q], gl[q + 4]);
      mma3(accS[j], sh, sl, bh0, bh1, bl0, bl1);
    }
  }
}

template <int A, int B>
__device__ __forceinline__ void zero(float (&acc)[A][B]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int e = 0; e < B; ++e) acc[i][e] = 0.f;
}

struct Frame {
  const float4* node_w;   // the call's node-wise fragments
  const float4* stat_w;   // the static linears' fragments
  const float* node_b;    // [V][kBiases]
  float sb[2];            // this lane's static-branch biases: the gate's rows g, g + 8
  float sbu[2];           // and the update's
  float* out;
  size_t out_win;         // floats between windows of out
  size_t out_t;           // offset of frame t in a window
  long long b0;
  int nvalid, V;
};

// z, r of every node: r * h into RH, z into the output's frame slot.
template <int KX>
__device__ __forceinline__ void gate_phase(const Smem& sm, const Frame& f) {
  using D = Dims<KX>;
  constexpr int KS = D::KS, P = ring_depth(KS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const size_t node_f4 = (size_t)kTiles * KS * 32;
  const float4* wbase = f.node_w + (size_t)warp * KS * 32 + lane;
  // the static linear's fragments of this warp's tile, for every node
  float4 lg[KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) lg[ks] = __ldg(f.stat_w + (warp * KS + ks) * 32 + lane);
  float4 ring[P];
#pragma unroll
  for (int p = 0; p < P; ++p) ring[p] = __ldg(wbase + p * 32);
  Stager<KX> stager(sm, sm.H);
  stager.begin(sm, 0);
  stager.steps(0, kMaxV, f.V);
  stager.finish(sm.G);
  __syncthreads();
  for (int n = 0; n < f.V; ++n) {
    const float* gc = sm.G + (n & 1) * 2 * kWt * D::LdG;
    // the node's biases, read ahead of the products
    const float nbz = __ldg(f.node_b + n * kBiases + 16 * warp + g);
    const float nbr = __ldg(f.node_b + n * kBiases + 16 * warp + 8 + g);
    const bool mix = n + 1 < f.V;
    if (mix) stager.begin(sm, n + 1);
    float accW[2][4], accS[2][4];
    zero(accW);
    zero(accS);
    const float* hs = sm.H + n * kWt * kLdH;
    tile_products<KX, 0, KS>(accW, accS, ring, lg, wbase + n * node_f4,
                                 mix ? wbase + (n + 1) * node_f4 : nullptr, gc,
                                 sm.X + n * kWt * D::LdX, hs, g, q, stager, mix, f.V);
    if (mix) stager.finish(sm.G + ((n + 1) & 1) * 2 * kWt * D::LdG);
    // rows g: z of feature c; rows g + 8: r of feature c
    const int c = 8 * warp + g;
    const float colv = sm.COL[n];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int w = 8 * j + 2 * q + e;
        const float z = sigmoid((accW[j][e] + nbz) + gated(colv * accS[j][e] + f.sb[0]));
        const float r = sigmoid((accW[j][2 + e] + nbr) + gated(colv * accS[j][2 + e] + f.sb[1]));
        const int i = (n * kWt + w) * kLdH + c;
        sm.RH[i] = r * hs[(w * kLdH) + c];
        if (w < f.nvalid) f.out[(f.b0 + w) * f.out_win + f.out_t + n * kH + c] = z;
      }
    __syncthreads();
  }
}

// h_hat of every node and the blend: h into H and the output. KH is the
// warp's K half (0 or 1), its k-steps [KB, KB + KN).
template <int KX, int KH, int KB, int KN>
__device__ __forceinline__ void update_phase(const Smem& sm, const Frame& f) {
  using D = Dims<KX>;
  constexpr int P = ring_depth(KN);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int tile = warp & 3;
  const size_t node_f4 = (size_t)kTiles * D::KS * 32;
  const float4* wbase = f.node_w + (size_t)((kGateTiles + tile) * D::KS + KB) * 32 + lane;
  // the static linear's fragments of this warp's tile and K half
  float4 lu[KN];
#pragma unroll
  for (int kk = 0; kk < KN; ++kk)
    lu[kk] = __ldg(f.stat_w + ((kGateTiles + tile) * D::KS + KB + kk) * 32 + lane);
  float4 ring[P];
#pragma unroll
  for (int p = 0; p < P; ++p) ring[p] = __ldg(wbase + p * 32);
  Stager<KX> stager(sm, sm.RH);
  stager.begin(sm, 0);
  stager.steps(0, kMaxV, f.V);
  stager.finish(sm.G);
  cta_sync();
  for (int n = 0; n < f.V; ++n) {
    const float* gc = sm.G + (n & 1) * 2 * kWt * D::LdG;
    // z (left in the output by the gate) and the node's biases, read ahead
    // of the products: the blend then waits on no L2 round trip
    float zv[2][2], nb[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int c = 16 * tile + 8 * hr + g;
      nb[hr] = __ldg(f.node_b + n * kBiases + 16 * kGateTiles + c);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int w = 8 * KH + 2 * q + e;
        zv[hr][e] = w < f.nvalid ? f.out[(f.b0 + w) * f.out_win + f.out_t + n * kH + c] : 0.f;
      }
    }
    const bool mix = n + 1 < f.V;
    if (mix) stager.begin(sm, n + 1);
    float accW[2][4], accS[2][4];
    zero(accW);
    zero(accS);
    tile_products<KX, KB, KN>(accW, accS, ring, lu, wbase + n * node_f4,
                                  mix ? wbase + (n + 1) * node_f4 : nullptr, gc,
                                  sm.X + n * kWt * D::LdX, sm.RH + n * kWt * kLdH, g, q,
                                  stager, mix, f.V);
    if (mix) stager.finish(sm.G + ((n + 1) & 1) * 2 * kWt * D::LdG);
    // the other n tile's partial sums to the pair's other warp, and back
    float* mine = sm.RED + (tile * 2 + KH) * 8 * 32 + lane;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mine[e * 32] = accW[1 - KH][e];
      mine[(4 + e) * 32] = accS[1 - KH][e];
    }
    pair_sync(tile);
    const float* theirs = sm.RED + (tile * 2 + 1 - KH) * 8 * 32 + lane;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      accW[KH][e] += theirs[e * 32];
      accS[KH][e] += theirs[(4 + e) * 32];
    }
    const float colv = sm.COL[n];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int c = 16 * tile + 8 * hr + g;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int w = 8 * KH + 2 * q + e;
        const float hh = tanh_exact((accW[KH][2 * hr + e] + nb[hr]) +
                                    gated(colv * accS[KH][2 * hr + e] + f.sbu[hr]));
        const int i = (n * kWt + w) * kLdH + c;
        const float z = zv[hr][e];
        const float hn = z * sm.H[i] + (1.f - z) * hh;
        sm.H[i] = hn;
        if (w < f.nvalid) f.out[(f.b0 + w) * f.out_win + f.out_t + n * kH + c] = hn;
      }
    }
    cta_sync();
  }
}

// One CTA a tile of kWt windows, all V nodes, every frame.
template <int KX>
__global__ void __launch_bounds__(kThreads, 1)
graph_gru_kernel(const float* __restrict__ x, const float* __restrict__ supports,
                 const float* __restrict__ node_w, const float* __restrict__ node_b,
                 const float* __restrict__ stat_w, const float* __restrict__ stat_b,
                 const float* __restrict__ col, float* out, int B, int T, int V, int Cx) {
  using D = Dims<KX>;
  extern __shared__ __align__(16) float smem[];
  Smem sm;
  sm.X = smem;
  sm.H = sm.X + V * kWt * D::LdX;
  sm.RH = sm.H + V * kWt * kLdH;
  sm.G = sm.RH + V * kWt * kLdH;
  sm.RED = sm.G + 4 * kWt * D::LdG;
  sm.S = sm.RED + kRedFloats;
  sm.COL = sm.S + kMaxV * kMaxV;
  const int total = (int)smem_floats(V, KX);
  for (int i = threadIdx.x * 4; i < total; i += kThreads * 4)
    *reinterpret_cast<float4*>(smem + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int i = threadIdx.x; i < V * V; i += kThreads)
    sm.S[(i / V) * kMaxV + i % V] = supports[i];
  if (threadIdx.x < V) sm.COL[threadIdx.x] = col[threadIdx.x];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Frame f;
  f.node_w = reinterpret_cast<const float4*>(node_w);
  f.stat_w = reinterpret_cast<const float4*>(stat_w);
  f.node_b = node_b;
  f.sb[0] = __ldg(stat_b + 16 * warp + (lane >> 2));
  f.sb[1] = __ldg(stat_b + 16 * warp + 8 + (lane >> 2));
  f.sbu[0] = __ldg(stat_b + 16 * kGateTiles + 16 * (warp & 3) + (lane >> 2));
  f.sbu[1] = __ldg(stat_b + 16 * kGateTiles + 16 * (warp & 3) + 8 + (lane >> 2));
  f.out = out;
  f.out_win = (size_t)T * V * kH;
  f.b0 = (long long)blockIdx.x * kWt;
  f.nvalid = (int)min((long long)kWt, (long long)B - f.b0);
  f.V = V;
  const size_t x_win = (size_t)T * V * Cx;
  for (int t = 0; t < T; ++t) {
    const float* xt = x + f.b0 * x_win + (size_t)t * V * Cx;
    if (KX == kH && Cx == kH) {
      const int per_win = V * (kH / 4);
      for (int i = threadIdx.x; i < f.nvalid * per_win; i += kThreads) {
        const int w = i / per_win, r = i - w * per_win;
        *reinterpret_cast<float4*>(sm.X + ((r >> 4) * kWt + w) * D::LdX + 4 * (r & 15)) =
            __ldg(reinterpret_cast<const float4*>(xt + w * x_win) + r);
      }
    } else {
      const int per_win = V * Cx;
      for (int i = threadIdx.x; i < f.nvalid * per_win; i += kThreads) {
        const int w = i / per_win, r = i - w * per_win, n = r / Cx;
        sm.X[(n * kWt + w) * D::LdX + r - n * Cx] = __ldg(xt + w * x_win + r);
      }
    }
    f.out_t = (size_t)t * V * kH;
    __syncthreads();
    gate_phase<KX>(sm, f);
    if (warp < 4)
      update_phase<KX, 0, 0, D::KH0>(sm, f);
    else
      update_phase<KX, 1, D::KH0, D::KS - D::KH0>(sm, f);
  }
}

template <int KX>
cudaError_t launch(const float* x, const float* supports, const float* node_w,
                   const float* node_b, const float* stat_w, const float* stat_b,
                   const float* col, float* out, int B, int T, int V, int Cx,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(V, KX);
  cudaError_t err = cudaFuncSetAttribute(graph_gru_kernel<KX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + kWt - 1) / kWt;
  graph_gru_kernel<KX><<<grid, kThreads, smem, stream>>>(x, supports, node_w, node_b, stat_w,
                                                         stat_b, col, out, B, T, V, Cx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K4 on `stream` and returns cudaGetLastError() (0 = queued), or
// cudaErrorInvalidValue for sizes it does not take (B < 0, T < 1, V outside
// 1..16, Cx outside 1..kx, kx not 8 or 64, shared memory past 227 KB) and
// cudaErrorMisalignedAddress for a pointer that is not 16-byte aligned.
// x: (B, T, V, Cx) contiguous; out: (B, T, V, 64); supports (V, V); node_w:
// V x graph_gru_node_floats(kx); node_b: V x 192; stat_w:
// graph_gru_node_floats(kx); stat_b: 192; col: V.
int graph_gru_forward(const float* x, const float* supports, const float* node_w,
                      const float* node_b, const float* stat_w, const float* stat_b,
                      const float* col, float* out, int B, int T, int V, int Cx, int kx,
                      void* stream) {
  if (B < 0 || T < 1 || V < 1 || V > kMaxV || Cx < 1 || Cx > kx || (kx != 8 && kx != kH) ||
      sizeof(float) * smem_floats(V, kx) > 232448)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(node_w) |
       reinterpret_cast<uintptr_t>(stat_w) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (B == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(kx == 8 ? launch<8>(x, supports, node_w, node_b, stat_w, stat_b, col, out, B, T,
                                   V, Cx, s)
                       : launch<kH>(x, supports, node_w, node_b, stat_w, stat_b, col, out, B,
                                    T, V, Cx, s));
}

// Floats of one node's fragments (the static linears' are as many): the
// wrapper checks its layout against it.
int graph_gru_node_floats(int kx) { return kTiles * ((kx + kH) / 8) * 32 * 4; }

// Dynamic shared memory of a launch, in bytes.
int graph_gru_smem_bytes(int V, int kx) { return (int)(sizeof(float) * smem_floats(V, kx)); }

const char* graph_gru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
