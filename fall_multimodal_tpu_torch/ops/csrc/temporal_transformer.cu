// K3: TARGCN's temporal transformer (the positional table and both attention
// layers, models/targcn.py:TemporalTransformer) in one launch, for Hopper
// (sm_90a). fp32 in and out; every product on the tensor cores in split TF32.
//
// Replaces no TPU kernel: the JAX package runs TARGCN through XLA
// (fall_multimodal_tpu/models/targcn.py reaches no pallas_call). It was added
// because the stock modules took 54 ms of a 145 ms forward at batch 8,192:
// four LayerNorms, the residual adds, the convolutions' permuted copies and
// the FF hidden layer each wrote and re-read a (B, T, V, F) tensor (881 MB
// in fp32 at the main path's sizes), a dozen of them a layer.
//
// What it computes, for each (b, v) sequence of x (B, T, V, F), T <= 32,
// F = 64, the layout of TemporalTransformLayer.forward:
//   h = x[b, :, v] + pe                                   (T, F)
//   per layer:  Q = sum_k Wq_k h[:, k:k+F-2] + bq         (T, F-2; T as conv channels)
//               K = sum_k Wk_k h[:, k:k+F-2] + bk
//               P = softmax_s(Q K^T / sqrt(F))            (over the T key frames)
//               o = ln(P (h Wv^T + bv) + h)
//               h = lnff(relu(o W1^T + b1) W2^T + b2 + o)
//   out[b, :, v] = h
// The weights come packed by ops/temporal_transformer.py:pack_temporal_transformer,
// in the padded layout of kLayerFloats below (frames padded to 32 with zeros,
// rows padded by 4 or 8 floats so that fragment loads hit distinct banks).
//
// What bounds it on this card. One layer is 22.9 MFLOP a window of 14
// sequences, so both are 375 GFLOP at batch 8,192, against 1.76 GB that the
// function must read and write (x once, the output once): 0.53 ms at 3.35
// TB/s, 0.76 ms at TF32's 495 TFLOP/s, 2.3 ms in split TF32 (three products
// each) and 5.6 ms on the fp32 FMA pipe (67 TFLOP/s). Operations bound it.
//
// What the design does about it:
// * Nothing between the two layers leaves the SM. A sequence is a 32 x 64
//   tile (7.7 KB); a CTA holds two of them in shared memory ("slots"), each
//   with its Q/V, K/H and score buffers (31.5 KB a slot), and takes each
//   through the positional add and both layers. x is read once and the
//   output written once.
// * Both layers' weights (78 KB each, padded) are staged in shared memory
//   once per CTA; the grid is one persistent CTA an SM, and each slot walks
//   sequence after sequence, fetching the next one into registers while it
//   computes the current one.
// * The products are warp-level mma.sync m16n8k8 in split TF32 (3xTF32: an
//   operand a = hi + lo with hi = tf32(a), lo = tf32(a - hi); a product is
//   a_lo b_hi + a_hi b_lo + a_hi b_hi in fp32), which keeps fp32 accuracy at
//   a third of mma.sync's TF32 rate (about 310 TFLOP/s on this card), 1.5
//   times the fp32 FMA rate. Operands are split as their fragments are
//   loaded from shared memory.
// * Each slot is four warps that meet at their own named barrier; the two
//   slots of a CTA run out of step, so one slot's softmax, LayerNorm and
//   barrier waits overlap the other's products.
// * The 3-tap convolutions are three 32x32 frame-mixing products over
//   column-shifted views of the tile; Q and K share those B fragments. The
//   softmax, both LayerNorms, the biases, the ReLU and the residual adds are
//   fused into the epilogues and row passes between the products.
// What it leaves (H100, batch 8,192: 9.2 ms, 41 TFLOP/s): the products alone
// would take 4.1 ms at mma.sync's peak, two thirds of what wgmma gives; the
// rest is issue and waits, since every operand is split again each time a
// fragment is loaded (the weights have no room for a second, pre-split
// copy), and each phase ends at a slot barrier (eight a layer).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kF = 64;          // feature width the kernel is built for
constexpr int kT = 32;          // frames, padded
constexpr int kTaps = 3;        // conv1 / conv2 kernel width over F
constexpr int kMaxLayers = 2;
constexpr int kSlotWarps = 4;
constexpr int kSlots = 2;
constexpr int kSlotThreads = 32 * kSlotWarps;
constexpr int kThreads = kSlots * kSlotThreads;

// One packed layer, in floats; ops/temporal_transformer.py:layer_layout
// builds the same offsets. Wq/Wk: [t_out][tap * 32 + t_in]; Wv/W1/W2: the
// nn.Linear weight [out][in]; then the biases and the two LayerNorms.
constexpr int kConvLd = kTaps * kT + 4;  // 100 = 4 mod 32
constexpr int kLinLd = kF + 4;           // 68 = 4 mod 32
constexpr int kWq = 0;
constexpr int kWk = kWq + kT * kConvLd;
constexpr int kWv = kWk + kT * kConvLd;
constexpr int kW1 = kWv + kF * kLinLd;
constexpr int kW2 = kW1 + kF * kLinLd;
constexpr int kBq = kW2 + kF * kLinLd;
constexpr int kBk = kBq + kT;
constexpr int kBv = kBk + kT;
constexpr int kB1 = kBv + kF;
constexpr int kB2 = kB1 + kF;
constexpr int kLnW = kB2 + kF;
constexpr int kLnB = kLnW + kF;
constexpr int kLnffW = kLnB + kF;
constexpr int kLnffB = kLnffW + kF;
constexpr int kLayerFloats = kLnffB + kF;
static_assert(kLayerFloats % 4 == 0, "layers are copied as float4");

// A slot's buffers. A fragment load of a warp reads rows g = 0..7 and
// columns q = 0..3 (or the transpose): a row stride of 4 mod 32 puts the 32
// reads on distinct banks where k runs along a row, 8 mod 32 where k runs
// down the rows (the convolutions' and P V's B operands).
constexpr int kXLd = kF + 8;   // h: B of the convolutions (+2 columns read past F), A of V and FF1
constexpr int kVLd = kF + 8;   // V: B of P V
constexpr int kQLd = kF + 4;   // Q (A of the scores), K (B of the scores), FF hidden (A of FF2)
constexpr int kSLd = kT + 4;   // scores, then probabilities (A of P V)
constexpr int kBuf = kT * kXLd;
constexpr int kSlotFloats = 3 * kBuf + kT * kSLd;
static_assert(kSlotFloats % 4 == 0, "slots stay 16-byte aligned");
constexpr int kFetch = (kT * kF / 4 + kSlotThreads - 1) / kSlotThreads;  // float4 a thread

// a rounded to TF32, to nearest with ties away from zero: what cvt.rna.tf32.f32
// gives for a finite a, in two instructions (ptxas expands the cvt into four,
// with checks for NaN and infinity that these finite operands never need).
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[i][j] += A_i (16 x 8*KS) B (8*KS x 8*NT) for a warp, in split TF32,
// small terms first. A_i(m, k) = A[i][m * lda + k] (NA products that share
// B); B(k, n) = B[k * ldb + n] if kBRows, else B[n * ldb + k]. Fragment
// element (g, q) of m16n8k8: g = lane / 4, q = lane % 4.
template <int NA, int NT, int KS, bool kBRows>
__device__ __forceinline__ void warp_mma(float (&acc)[NA][NT][4], const float* const (&A)[NA],
                                         int lda, const float* B, int ldb, int g, int q) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int k0 = ks * 8;
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* b = kBRows ? B + k0 * ldb + j * 8 : B + j * 8 * ldb + k0;
      split_tf32(kBRows ? b[q * ldb + g] : b[g * ldb + q], bh[j][0], bl[j][0]);
      split_tf32(kBRows ? b[(q + 4) * ldb + g] : b[g * ldb + q + 4], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const float* a = A[i] + k0;
      uint32_t ah[4], al[4];
      split_tf32(a[g * lda + q], ah[0], al[0]);
      split_tf32(a[(g + 8) * lda + q], ah[1], al[1]);
      split_tf32(a[g * lda + q + 4], ah[2], al[2]);
      split_tf32(a[(g + 8) * lda + q + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], al, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah, bh[j][0], bh[j][1]);
    }
  }
}

template <int NA, int NT>
__device__ __forceinline__ void zero(float (&acc)[NA][NT][4]) {
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// The four warps of a slot (named barrier 1 + slot; 0 is __syncthreads).
__device__ __forceinline__ void slot_sync(int slot) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(slot + 1), "r"(kSlotThreads) : "memory");
}

// The row passes take a warp's eight rows r = wh*8 + lane/4 at once, four
// lanes a row: lane part p = lane % 4 holds columns 4p + 16u, u = 0, 1, ...,
// and a row's sums are two shuffles.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// LayerNorm (eps 1e-5) of the warp's rows of h. A row below T goes to `dst`
// (row stride dst_ld) when it is given, else back into h; h's rows from T on
// are set to zero.
__device__ __forceinline__ void layer_norm_rows(float* h, const float* w, const float* b, int T,
                                                int wh, int lane, float* dst, size_t dst_ld) {
  const int r = wh * (kT / kSlotWarps) + (lane >> 2), c0 = 4 * (lane & 3);
  float4 v[kF / 16];
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < kF / 16; ++u) {
    v[u] = *reinterpret_cast<const float4*>(h + r * kXLd + c0 + 16 * u);
    sum += (v[u].x + v[u].y) + (v[u].z + v[u].w);
  }
  const float mean = quad_sum(sum) * (1.f / kF);
  float var = 0.f;
#pragma unroll
  for (int u = 0; u < kF / 16; ++u) {
    v[u] = make_float4(v[u].x - mean, v[u].y - mean, v[u].z - mean, v[u].w - mean);
    var += (v[u].x * v[u].x + v[u].y * v[u].y) + (v[u].z * v[u].z + v[u].w * v[u].w);
  }
  const float rstd = rsqrtf(quad_sum(var) * (1.f / kF) + 1e-5f);
#pragma unroll
  for (int u = 0; u < kF / 16; ++u) {
    const int c = c0 + 16 * u;
    const float4 gw = *reinterpret_cast<const float4*>(w + c);
    const float4 gb = *reinterpret_cast<const float4*>(b + c);
    float4 y = make_float4(v[u].x * rstd * gw.x + gb.x, v[u].y * rstd * gw.y + gb.y,
                           v[u].z * rstd * gw.z + gb.z, v[u].w * rstd * gw.w + gb.w);
    if (r >= T) y = make_float4(0.f, 0.f, 0.f, 0.f);
    if (dst != nullptr && r < T)
      *reinterpret_cast<float4*>(dst + r * dst_ld + c) = y;
    else
      *reinterpret_cast<float4*>(h + r * kXLd + c) = y;
  }
}

// Softmax of the warp's score rows over the key frames below T, in place.
__device__ __forceinline__ void softmax_rows(float* s, int T, int wh, int lane) {
  float* row = s + (wh * (kT / kSlotWarps) + (lane >> 2)) * kSLd;
  const int c0 = 4 * (lane & 3);
  float e[kT / 4];
#pragma unroll
  for (int u = 0; u < kT / 16; ++u) {
    const float4 v = *reinterpret_cast<const float4*>(row + c0 + 16 * u);
    e[4 * u] = v.x, e[4 * u + 1] = v.y, e[4 * u + 2] = v.z, e[4 * u + 3] = v.w;
  }
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kT / 4; ++i)
    if (c0 + 16 * (i / 4) + i % 4 < T) m = fmaxf(m, e[i]);
  m = quad_max(m);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kT / 4; ++i) {
    e[i] = c0 + 16 * (i / 4) + i % 4 < T ? expf(e[i] - m) : 0.f;
    sum += e[i];
  }
  const float inv = 1.f / quad_sum(sum);
#pragma unroll
  for (int u = 0; u < kT / 16; ++u)
    *reinterpret_cast<float4*>(row + c0 + 16 * u) =
        make_float4(e[4 * u] * inv, e[4 * u + 1] * inv, e[4 * u + 2] * inv, e[4 * u + 3] * inv);
}

// One TA layer of the sequence in slot buffers (h, qv, kh, s). `out` (the
// sequence's first output row, row stride out_ld) is given for the last
// layer, which writes there instead of back into h.
__device__ __forceinline__ void ta_layer(const float* w, float* h, float* qv, float* kh, float* s,
                                         int T, int slot, int wh, int lane, float* out,
                                         size_t out_ld) {
  const int g = lane >> 2, q = lane & 3;
  const int m0 = (wh & 1) * 16;  // a warp's 16 rows of each product
  const int r0 = m0 + g;         // its fragment rows r0 and r0 + 8

  // 1. Q and K: three frame-mixing products over h shifted by the tap, + bias;
  //    columns F-2, F-1 (past the valid convolution) set to zero.
  {
    const int n0 = (wh >> 1) * 32;
    float acc[2][4][4];
    zero(acc);
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const float* const A[2] = {w + kWq + m0 * kConvLd + tap * kT,
                                 w + kWk + m0 * kConvLd + tap * kT};
      warp_mma<2, 4, kT / 8, true>(acc, A, kConvLd, h + tap + n0, kXLd, g, q);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* dst = i == 0 ? qv : kh;
      const float* bias = w + (i == 0 ? kBq : kBk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + j * 8 + 2 * q;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = r0 + 8 * hr;
          const float bv = bias[r];
          *reinterpret_cast<float2*>(dst + r * kQLd + c) =
              make_float2(c < kF - 2 ? acc[i][j][2 * hr] + bv : 0.f,
                          c + 1 < kF - 2 ? acc[i][j][2 * hr + 1] + bv : 0.f);
        }
      }
    }
  }
  slot_sync(slot);

  // 2. scores Q K^T / sqrt(F): a warp's 16 rows x 16 key frames.
  {
    const int n0 = (wh >> 1) * 16;
    float acc[1][2][4];
    zero(acc);
    const float* const A[1] = {qv + m0 * kQLd};
    warp_mma<1, 2, kF / 8, false>(acc, A, kQLd, kh + n0 * kQLd, kQLd, g, q);
    const float scale = 1.f / sqrtf((float)kF);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = n0 + j * 8 + 2 * q;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(s + (r0 + 8 * hr) * kSLd + c) =
            make_float2(acc[0][j][2 * hr] * scale, acc[0][j][2 * hr + 1] * scale);
    }
  }
  slot_sync(slot);

  // 3. softmax over the key frames below T; then V = h Wv^T + bv into the Q
  //    buffer (Q is read no more).
  softmax_rows(s, T, wh, lane);
  {
    const int n0 = (wh >> 1) * 32;
    float acc[1][4][4];
    zero(acc);
    const float* const A[1] = {h + m0 * kXLd};
    warp_mma<1, 4, kF / 8, false>(acc, A, kXLd, w + kWv + n0 * kLinLd, kLinLd, g, q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + j * 8 + 2 * q;
      const float2 bv = *reinterpret_cast<const float2*>(w + kBv + c);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(qv + (r0 + 8 * hr) * kVLd + c) =
            make_float2(acc[0][j][2 * hr] + bv.x, acc[0][j][2 * hr + 1] + bv.y);
    }
  }
  slot_sync(slot);

  // 4. P V + h, in place in h (each element read and written by one thread).
  {
    const int n0 = (wh >> 1) * 32;
    float acc[1][4][4];
    zero(acc);
    const float* const A[1] = {s + m0 * kSLd};
    warp_mma<1, 4, kT / 8, true>(acc, A, kSLd, qv + n0, kVLd, g, q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + j * 8 + 2 * q;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float2* p = reinterpret_cast<float2*>(h + (r0 + 8 * hr) * kXLd + c);
        const float2 res = *p;
        *p = make_float2(acc[0][j][2 * hr] + res.x, acc[0][j][2 * hr + 1] + res.y);
      }
    }
  }
  slot_sync(slot);

  // 5. ln, in place.
  layer_norm_rows(h, w + kLnW, w + kLnB, T, wh, lane, nullptr, 0);
  slot_sync(slot);

  // 6. FF hidden relu(o W1^T + b1) into the K buffer (K is read no more).
  {
    const int n0 = (wh >> 1) * 32;
    float acc[1][4][4];
    zero(acc);
    const float* const A[1] = {h + m0 * kXLd};
    warp_mma<1, 4, kF / 8, false>(acc, A, kXLd, w + kW1 + n0 * kLinLd, kLinLd, g, q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + j * 8 + 2 * q;
      const float2 bv = *reinterpret_cast<const float2*>(w + kB1 + c);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(kh + (r0 + 8 * hr) * kQLd + c) =
            make_float2(fmaxf(acc[0][j][2 * hr] + bv.x, 0.f),
                        fmaxf(acc[0][j][2 * hr + 1] + bv.y, 0.f));
    }
  }
  slot_sync(slot);

  // 7. hidden W2^T + b2 + o, in place in h.
  {
    const int n0 = (wh >> 1) * 32;
    float acc[1][4][4];
    zero(acc);
    const float* const A[1] = {kh + m0 * kQLd};
    warp_mma<1, 4, kF / 8, false>(acc, A, kQLd, w + kW2 + n0 * kLinLd, kLinLd, g, q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + j * 8 + 2 * q;
      const float2 bv = *reinterpret_cast<const float2*>(w + kB2 + c);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float2* p = reinterpret_cast<float2*>(h + (r0 + 8 * hr) * kXLd + c);
        const float2 res = *p;
        *p = make_float2((acc[0][j][2 * hr] + bv.x) + res.x,
                         (acc[0][j][2 * hr + 1] + bv.y) + res.y);
      }
    }
  }
  slot_sync(slot);

  // 8. lnff: into h, or for the last layer out to device memory.
  layer_norm_rows(h, w + kLnffW, w + kLnffB, T, wh, lane, out, out_ld);
  slot_sync(slot);
}

// One CTA an SM, persistent: two slots of four warps, each slot walks the
// sequences slot, slot + 2 * gridDim.x, ... of the grid's order (b * V + v).
__global__ void __launch_bounds__(kThreads, 1)
temporal_transformer_kernel(const float* __restrict__ x, const float* __restrict__ pe,
                            const float* __restrict__ weights, float* __restrict__ out,
                            long long nseq, int T, int V, int n_layers) {
  extern __shared__ __align__(16) float smem[];
  float* const wsm = smem;  // n_layers packed layers
  float* const slots = smem + n_layers * kLayerFloats;

  for (int i = threadIdx.x * 4; i < n_layers * kLayerFloats; i += kThreads * 4)
    *reinterpret_cast<float4*>(wsm + i) = __ldg(reinterpret_cast<const float4*>(weights + i));
  // zero the slots: pad rows and the two columns the convolutions read past F
  for (int i = threadIdx.x * 4; i < kSlots * kSlotFloats; i += kThreads * 4)
    *reinterpret_cast<float4*>(slots + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int slot = threadIdx.x / kSlotThreads;
  const int tid = threadIdx.x % kSlotThreads;
  const int wh = tid / 32, lane = tid % 32;
  float* const h = slots + slot * kSlotFloats;
  float* const qv = h + kBuf;
  float* const kh = qv + kBuf;
  float* const s = kh + kBuf;
  const size_t row_ld = (size_t)V * kF;  // between frames of one sequence
  const long long step = (long long)gridDim.x * kSlots;

  // the rows of sequence n below T, kFetch float4 a thread (16 a row)
  float4 next[kFetch];
  auto fetch = [&](long long n) {
    const float* base = x + ((size_t)(n / V) * T * V + (size_t)(n % V)) * kF;
#pragma unroll
    for (int u = 0; u < kFetch; ++u) {
      const int i = tid + u * kSlotThreads;
      if (i < T * (kF / 4))
        next[u] = __ldg(reinterpret_cast<const float4*>(base + (i >> 4) * row_ld) + (i & 15));
    }
  };

  long long n = (long long)blockIdx.x * kSlots + slot;
  if (n < nseq) fetch(n);
  for (; n < nseq; n += step) {
#pragma unroll
    for (int u = 0; u < kFetch; ++u) {
      const int i = tid + u * kSlotThreads;
      if (i < T * (kF / 4)) {
        const float4 p = __ldg(reinterpret_cast<const float4*>(pe) + i);
        const float4 v = next[u];
        *reinterpret_cast<float4*>(h + (i >> 4) * kXLd + (i & 15) * 4) =
            make_float4(v.x + p.x, v.y + p.y, v.z + p.z, v.w + p.w);
      }
    }
    slot_sync(slot);
    if (n + step < nseq) fetch(n + step);  // in flight through both layers
    float* const dst = out + ((size_t)(n / V) * T * V + (size_t)(n % V)) * kF;
    for (int l = 0; l < n_layers; ++l)
      ta_layer(wsm + l * kLayerFloats, h, qv, kh, s, T, slot, wh, lane,
               l + 1 == n_layers ? dst : nullptr, row_ld);
  }
}

}  // namespace

extern "C" {

// Launches K3 on `stream` and returns cudaGetLastError() (0 = queued), or
// cudaErrorInvalidValue for sizes it does not take (T outside 1..32, V < 1,
// n_layers outside 1..2, B < 0) and cudaErrorMisalignedAddress for a pointer
// that is not 16-byte aligned. x, out: (B, T, V, 64) contiguous; pe: (T, 64);
// weights: n_layers packed layers of temporal_transformer_layer_floats().
int temporal_transformer_forward(const float* x, const float* pe, const float* weights,
                                 float* out, int B, int T, int V, int n_layers, void* stream) {
  if (B < 0 || T < 1 || T > kT || V < 1 || n_layers < 1 || n_layers > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(pe) |
       reinterpret_cast<uintptr_t>(weights) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const long long nseq = (long long)B * V;
  if (nseq == 0) return (int)cudaSuccess;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const size_t smem = sizeof(float) * ((size_t)n_layers * kLayerFloats + kSlots * kSlotFloats);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(temporal_transformer_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = (nseq + kSlots - 1) / kSlots;
  const int grid = (int)(ctas < sms ? ctas : sms);
  temporal_transformer_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, pe, weights, out, nseq, T, V, n_layers);
  return (int)cudaGetLastError();
}

// Floats of one packed layer (the wrapper checks its layout against it).
int temporal_transformer_layer_floats() { return kLayerFloats; }

const char* temporal_transformer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
