// The flash-attention kernels' shared parts: the launch parameters, Philox,
// and the three tensor-core kernels (forward, dq, dk/dv/db) templated on
// their 16-bit element type T (__nv_bfloat16 or __half).
//
// flash_attention.cu instantiates them for bf16 beside the fp32 CUDA-core
// kernels and holds the C entries; flash_attention_fp16.cu instantiates them
// for fp16 (dispatch_mma_f16), so the two files compile in parallel. The two
// types share every instruction but the product and the rounding of the
// fp32 accumulators into operands and outputs (Mma<T>): p, ds and the
// outputs are rounded to T at the points where the JAX kernels cast to the
// input dtype. The fp16 rounding is __floats2half2_rn, which gives inf past
// fp16's range as XLA's convert does (never satfinite): a loss-scaled
// backward that overflows must reach the gradients as inf so that the loss
// scaler sees it. The -1e30 sentinel lives only in fp32 scores and lse.
#pragma once

#include "common.cuh"

namespace dstorch {
namespace flash {

constexpr float kBig = 1e30f;  // lse of a row that saw no key

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;   // [B, S] fp32 key bias
  const void* dout;    // dO (backward)
  const float* lse;    // [B*H, S] (backward)
  const float* delta;  // [B*H, S] rowsum(dO * out) (backward)
  const int* lut;      // [H, nblocks, maxn]
  const int* counts;   // [H, nblocks]
  void* out0;          // out | dq | dk
  void* out1;          // lse | -  | dv
  float* out2;         // -   | -  | db
  int H, S, block, maxn, causal;
  float scale;
  uint32_t seed, threshold;
  float keep_scale;
  int dropout;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += W0;
      k.y += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ uint32_t word(const uint4& b, int i) {
  return i == 0 ? b.x : i == 1 ? b.y : i == 2 ? b.z : b.w;
}

// s = (a . b) * scale + bias, or the causal sentinel (the fp32 multiply is
// kept apart from the add, as in the JAX kernel)
__device__ __forceinline__ float masked_score(float dot, float scale, float bias,
                                              bool masked) {
  return masked ? kNegBig : __fmul_rn(dot, scale) + bias;
}

// the product and the rounding of a 16-bit element type
template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_bf16(c, a, b0, b1);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return pack_bf16(lo, hi);
  }
};
template <> struct Mma<__half> {
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_f16(c, a, b0, b1);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return pack_f16(lo, hi);
  }
};

// ---------------------------------------------------------------------------
// the 16-bit forward on the tensor cores
// ---------------------------------------------------------------------------

template <int BLOCK, int D>
struct FwdLayout {
  static constexpr int kStride = D + 8;  // elements per tile row, 16 bytes of padding
  static constexpr int kTileBytes = BLOCK * kStride * 2;
  static constexpr int kStageBytes = 2 * kTileBytes + BLOCK * 4;  // K, V, bias
  // Q tile | `stages` x (K tile, V tile, bias)
  static constexpr int smem_bytes(int stages) { return kTileBytes + stages * kStageBytes; }
};

// The keep words of a thread's four accumulator elements of one n-tile
// whose rows are queries: rows r0 (w[0], w[1]) and r0 + 8 (w[2], w[3]),
// columns 4 quad4 + 2 (lane & 1) + {0, 1} of the key block. Lanes t,
// t^1 share the column quad `quad4`: the even lane draws row r0's four
// words, the odd lane row r0 + 8's, and each hands the other the two words
// of the other's columns.
__device__ __forceinline__ void paired_words(uint32_t (&w)[4], const Params& P, int bh, int qi,
                                             int kj, int r0, int quad4, int lane) {
  const bool odd = lane & 1;
  const uint4 bits = philox4x32_10(make_uint4(qi, kj, odd ? r0 + 8 : r0, quad4),
                                   make_uint2(P.seed, bh));
  const uint32_t got0 = __shfl_xor_sync(0xffffffffu, odd ? bits.x : bits.z, 1);
  const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? bits.y : bits.w, 1);
  w[0] = odd ? got0 : bits.x;
  w[1] = odd ? got1 : bits.y;
  w[2] = odd ? bits.z : got0;
  w[3] = odd ? bits.w : got1;
}

// a BLOCK x D 16-bit tile from device memory into shared-memory rows padded
// by 16 bytes (FwdLayout::kStride), 16 bytes a thread by cp.async
template <int BLOCK, int D, int THREADS, typename T>
__device__ __forceinline__ void copy_tile(unsigned char* dst, const T* src) {
  constexpr int CPR = D / 8, STRIDE = FwdLayout<BLOCK, D>::kStride;
  for (int e = threadIdx.x; e < BLOCK * CPR; e += THREADS) {
    const int r = e / CPR, ch = e % CPR;
    cp_async16(smem_u32(dst + (r * STRIDE + ch * 8) * 2), src + r * D + ch * 8, 16);
  }
}

// Two thread blocks an SM up to D = 64 (128 registers a thread at block 128,
// a few words spilled): one block's loads then run under the other's
// products, which measured faster than one block with every value in
// registers, than 64-row thread blocks, than two 16-row tiles a warp (255
// registers and spills), and than a persistent grid that loads the next tile
// under this one's products.
template <typename T, int BLOCK, int D>
__global__ void __launch_bounds__(BLOCK * 2, D <= 64 ? 2 : 1)
flash_fwd_mma_kernel(const Params P) {
  using Lay = FwdLayout<BLOCK, D>;
  constexpr int THREADS = BLOCK * 2;
  constexpr int STRIDE = Lay::kStride;
  constexpr int CPR = D / 8;     // 16-byte chunks per row
  constexpr int NT = BLOCK / 8;  // score n-tiles
  constexpr int DT = D / 8;      // output n-tiles
  const int bh = blockIdx.x, qi = blockIdx.y, nqb = gridDim.y;
  const int h = bh % P.H, b = bh / P.H, S = P.S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  extern __shared__ float4 smem4[];
  unsigned char* sQ = reinterpret_cast<unsigned char*>(smem4);
  unsigned char* stages = sQ + Lay::kTileBytes;

  const size_t base = static_cast<size_t>(bh) * S * D;
  const T* q = static_cast<const T*>(P.q) + base +
                           static_cast<size_t>(qi) * BLOCK * D;
  const T* k = static_cast<const T*>(P.k) + base;
  const T* v = static_cast<const T*>(P.v) + base;
  T* out = static_cast<T*>(P.out0) + base +
                       static_cast<size_t>(qi) * BLOCK * D;
  float* lse = static_cast<float*>(P.out1) + static_cast<size_t>(bh) * S + qi * BLOCK;
  const int* lut = P.lut + (static_cast<size_t>(h) * nqb + qi) * P.maxn;
  const int count = P.counts[h * nqb + qi];

  if (count == 0) {  // the block's rows see no key
    for (int e = tid; e < BLOCK * CPR; e += THREADS)
      reinterpret_cast<uint4*>(out)[e] = make_uint4(0u, 0u, 0u, 0u);
    for (int r = tid; r < BLOCK; r += THREADS) lse[r] = kBig;
    return;
  }

  auto load_tile = [&](unsigned char* dst, const T* src) {
    copy_tile<BLOCK, D, THREADS>(dst, src);
  };
  auto load_bias = [&](unsigned char* stage, int k0) {
    for (int e = tid; e < BLOCK / 4; e += THREADS)
      cp_async16(smem_u32(stage + 2 * Lay::kTileBytes + e * 16), P.bias + b * S + k0 + e * 4,
                 16);
  };

  {  // group 0: Q, the first K and its bias; group 1: the first V
    const int k0 = lut[0] * BLOCK;
    load_tile(sQ, q);
    load_tile(stages, k + static_cast<size_t>(k0) * D);
    load_bias(stages, k0);
    cp_async_commit();
    load_tile(stages + Lay::kTileBytes, v + static_cast<size_t>(k0) * D);
    cp_async_commit();
  }

  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows of the block: r0, r0 + 8
  const int qpos0 = qi * BLOCK + r0, qpos1 = qpos0 + 8;
  const int mat = lane >> 3;
  float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;  // l: this thread's columns only
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  for (int n = 0; n < count; ++n) {
    const int kj = lut[n], k0 = kj * BLOCK;
    const bool has_next = n + 1 < count;
    unsigned char* stage = stages + (n & 1) * Lay::kStageBytes;
    if (has_next) {  // the next LUT block loads under this one's products
      unsigned char* next = stages + ((n + 1) & 1) * Lay::kStageBytes;
      const int k1 = lut[n + 1] * BLOCK;
      load_tile(next, k + static_cast<size_t>(k1) * D);
      load_tile(next + Lay::kTileBytes, v + static_cast<size_t>(k1) * D);
      load_bias(next, k1);
      cp_async_commit();
    }
    // K (and, at first, Q) must have landed; at n == 0 V is one group younger
    if (n == 0) {
      if (has_next) cp_async_wait<2>(); else cp_async_wait<1>();
    } else {
      if (has_next) cp_async_wait<1>(); else cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* tK = stage;
    const unsigned char* tV = stage + Lay::kTileBytes;
    const float* sB = reinterpret_cast<const float*>(stage + 2 * Lay::kTileBytes);

    float s[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qf[4];
      ldmatrix_x4(qf, smem_u32(sQ + ((warp * 16 + (lane & 7) + (mat & 1) * 8) * STRIDE +
                                     kk * 16 + (mat >> 1) * 8) * 2));
#pragma unroll
      for (int tp = 0; tp < NT / 2; ++tp) {
        const int key = tp * 16 + (mat >> 1) * 8 + (lane & 7);
        const int col = kk * 16 + (mat & 1) * 8;
        uint32_t bf[4];
        ldmatrix_x4(bf, smem_u32(tK + (key * STRIDE + col) * 2));
        Mma<T>::mma(s[2 * tp], qf, bf[0], bf[1]);
        Mma<T>::mma(s[2 * tp + 1], qf, bf[2], bf[3]);
      }
    }

    // only a key block that reaches past the query block's first row can hold
    // a causally masked pair; the others skip the compare
    const bool diagonal = P.causal && k0 + BLOCK - 1 > qi * BLOCK;
    float mx0 = kNegBig, mx1 = kNegBig;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int col = t * 8 + (lane & 3) * 2;
      const float2 bias = *reinterpret_cast<const float2*>(sB + col);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float be = e ? bias.y : bias.x;
        s[t][e] = masked_score(s[t][e], P.scale, be, diagonal && qpos0 < k0 + col + e);
        s[t][2 + e] = masked_score(s[t][2 + e], P.scale, be, diagonal && qpos1 < k0 + col + e);
        mx0 = fmaxf(mx0, s[t][e]);
        mx1 = fmaxf(mx1, s[t][2 + e]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = __expf(m0 - mn0), corr1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // p, its row sums, the keep mask, and p rounded to T as the A operand
    uint32_t pa[NT][2];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      float p[4];
      p[0] = __expf(s[t][0] - mn0);
      p[1] = __expf(s[t][1] - mn0);
      p[2] = __expf(s[t][2] - mn1);
      p[3] = __expf(s[t][3] - mn1);
      ps0 += p[0] + p[1];
      ps1 += p[2] + p[3];
      if (P.dropout) {
        uint32_t w[4];
        paired_words(w, P, bh, qi, kj, r0, 2 * t + ((lane & 3) >> 1), lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = w[e] >= P.threshold ? p[e] * P.keep_scale : 0.f;
      }
      pa[t][0] = Mma<T>::pack(p[0], p[1]);
      pa[t][1] = Mma<T>::pack(p[2], p[3]);
    }
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= corr0;
      o[d][1] *= corr0;
      o[d][2] *= corr1;
      o[d][3] *= corr1;
    }

    if (n == 0) {  // the first V
      if (has_next) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int ks = 0; ks < BLOCK / 16; ++ks) {
      const uint32_t a[4] = {pa[2 * ks][0], pa[2 * ks][1], pa[2 * ks + 1][0],
                             pa[2 * ks + 1][1]};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        const int key = ks * 16 + (mat & 1) * 8 + (lane & 7);
        const int col = dp * 16 + (mat >> 1) * 8;
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, smem_u32(tV + (key * STRIDE + col) * 2));
        Mma<T>::mma(o[2 * dp], a, bf[0], bf[1]);
        Mma<T>::mma(o[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the stage may be refilled
  }

  // out = acc / l through the warp's own rows of the Q tile, then 16 bytes a thread
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const bool alive0 = l0 > 0.f, alive1 = l1 > 0.f;
  // one division a row: the quotient is rounded to T anyway
  const float inv0 = alive0 ? 1.f / l0 : 0.f, inv1 = alive1 ? 1.f / l1 : 0.f;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + (lane & 3) * 2;
    *reinterpret_cast<uint32_t*>(sQ + (r0 * STRIDE + col) * 2) =
        Mma<T>::pack(o[d][0] * inv0, o[d][1] * inv0);
    *reinterpret_cast<uint32_t*>(sQ + ((r0 + 8) * STRIDE + col) * 2) =
        Mma<T>::pack(o[d][2] * inv1, o[d][3] * inv1);
  }
  if ((lane & 3) == 0) {
    lse[r0] = alive0 ? m0 + logf(l0) : kBig;
    lse[r0 + 8] = alive1 ? m1 + logf(l1) : kBig;
  }
  __syncwarp();
  for (int e = lane; e < 16 * CPR; e += 32) {
    const int r = warp * 16 + e / CPR, ch = e % CPR;
    *reinterpret_cast<uint4*>(out + r * D + ch * 8) =
        *reinterpret_cast<const uint4*>(sQ + (r * STRIDE + ch * 8) * 2);
  }
}

// ---------------------------------------------------------------------------
// the 16-bit dk/dv/db on the tensor cores
// ---------------------------------------------------------------------------

template <int BLOCK, int D>
struct DkvLayout {
  static constexpr int kStride = FwdLayout<BLOCK, D>::kStride;
  static constexpr int kTileBytes = FwdLayout<BLOCK, D>::kTileBytes;
  // K, V, Q, dO tiles | key bias, lse, delta (fp32)
  static constexpr int kSmemBytes = 4 * kTileBytes + 3 * BLOCK * 4;
};

// the four Philox words of an n-tile's elements. Element e of a thread
// (key row r0 + 8 (e >> 1), query c + (e & 1)) takes word g of call e,
// where g = (lane >> 2) & 3 is the row's place in its key quad. The four
// lanes that differ in g (lane bits 2, 3) make the tile's four calls, one
// each (call g), and swap words by xor shuffles: in round k a lane sends
// word g ^ k of its call and gets word g of call g ^ k.
__device__ __forceinline__ void exchange_words(uint32_t (&w)[4], const uint4& bits, int g) {
  const uint32_t got1 = __shfl_xor_sync(0xffffffffu, word(bits, g ^ 1), 4);
  const uint32_t got2 = __shfl_xor_sync(0xffffffffu, word(bits, g ^ 2), 8);
  const uint32_t got3 = __shfl_xor_sync(0xffffffffu, word(bits, g ^ 3), 12);
  const uint32_t own = word(bits, g);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = e ^ g;
    w[e] = k == 0 ? own : k == 1 ? got1 : k == 2 ? got2 : got3;
  }
}

// One thread block per (batch*head, key block), a warp per 16 key rows;
// the transposed products Sᵀ = K Qᵀ and dPᵀ = V dOᵀ leave the scores of a
// key row in the accumulator registers of its warp, whose rounded
// fragments are the A operands of dV += Pᵀ dO and dK += dSᵀ Q. The query
// block is walked in slabs of 32 queries (p needs no running max), so a
// thread holds dk and dv (D / 2 values each) and two 16 x 32 score tiles.
template <typename T, int BLOCK, int D>
__global__ void __launch_bounds__(BLOCK * 2, D <= 64 ? 2 : 1)
flash_bwd_dkv_mma_kernel(const Params P) {
  using Lay = DkvLayout<BLOCK, D>;
  constexpr int THREADS = BLOCK * 2;
  constexpr int STRIDE = Lay::kStride;
  constexpr int CPR = D / 8;                   // 16-byte chunks per row
  constexpr int QS = BLOCK < 32 ? BLOCK : 32;  // queries a slab
  constexpr int NT = QS / 8;                   // score n-tiles of a slab
  constexpr int DT = D / 8;                    // dk / dv n-tiles
  const int bh = blockIdx.x, kj = blockIdx.y, nkb = gridDim.y;
  const int h = bh % P.H, b = bh / P.H, S = P.S, k0 = kj * BLOCK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, mat = lane >> 3;
  extern __shared__ float4 smem4[];
  unsigned char* sK = reinterpret_cast<unsigned char*>(smem4);
  unsigned char* sV = sK + Lay::kTileBytes;
  unsigned char* sQ = sV + Lay::kTileBytes;
  unsigned char* sO = sQ + Lay::kTileBytes;
  float* sB = reinterpret_cast<float*>(sO + Lay::kTileBytes);
  float* sL = sB + BLOCK;
  float* sDl = sL + BLOCK;

  const size_t base = static_cast<size_t>(bh) * S * D;
  const T* q = static_cast<const T*>(P.q) + base;
  const T* dout = static_cast<const T*>(P.dout) + base;
  const T* k =
      static_cast<const T*>(P.k) + base + static_cast<size_t>(k0) * D;
  const T* v =
      static_cast<const T*>(P.v) + base + static_cast<size_t>(k0) * D;
  T* dk = static_cast<T*>(P.out0) + base + static_cast<size_t>(k0) * D;
  T* dv = static_cast<T*>(P.out1) + base + static_cast<size_t>(k0) * D;
  float* db = P.out2 + static_cast<size_t>(bh) * S + k0;
  const float* lse = P.lse + static_cast<size_t>(bh) * S;
  const float* delta = P.delta + static_cast<size_t>(bh) * S;
  const int* qlut = P.lut + (static_cast<size_t>(h) * nkb + kj) * P.maxn;
  const int count = P.counts[h * nkb + kj];

  if (count == 0) {  // no query block sees these keys
    for (int e = tid; e < BLOCK * CPR; e += THREADS) {
      reinterpret_cast<uint4*>(dk)[e] = make_uint4(0u, 0u, 0u, 0u);
      reinterpret_cast<uint4*>(dv)[e] = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int r = tid; r < BLOCK; r += THREADS) db[r] = 0.f;
    return;
  }

  auto load_tile = [&](unsigned char* dst, const T* src) {
    copy_tile<BLOCK, D, THREADS>(dst, src);
  };
  auto load_vec = [&](float* dst, const float* src) {
    for (int e = tid; e < BLOCK / 4; e += THREADS) cp_async16(smem_u32(dst + e * 4), src + e * 4, 16);
  };
  // a query block in two copy groups: Q and lse first, then dO and delta,
  // which land under the Sᵀ product of the first slab; K and the bias join
  // the first block's first group, V its second
  auto load_q = [&](int q0) {
    load_tile(sQ, q + static_cast<size_t>(q0) * D);
    load_vec(sL, lse + q0);
    cp_async_commit();
  };
  auto load_do = [&](int q0) {
    load_tile(sO, dout + static_cast<size_t>(q0) * D);
    load_vec(sDl, delta + q0);
    cp_async_commit();
  };
  load_tile(sK, k);
  load_vec(sB, P.bias + b * S + k0);
  load_q(qlut[0] * BLOCK);
  load_tile(sV, v);
  load_do(qlut[0] * BLOCK);

  const int r0 = warp * 16 + (lane >> 2);  // this thread's key rows: r0, r0 + 8
  const int kpos0 = k0 + r0, kpos1 = kpos0 + 8;
  const int quad = lane & 3, g = (lane >> 2) & 3;
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;
  float db0 = 0.f, db1 = 0.f;  // this thread's columns of rows r0, r0 + 8

  for (int n = 0; n < count; ++n) {
    const int qi = qlut[n], q0 = qi * BLOCK;
    if (n > 0) {
      __syncthreads();  // every warp is done with the previous Q and dO
      load_q(q0);
      load_do(q0);
    }
    cp_async_wait<1>();
    __syncthreads();
    const float bias0 = sB[r0], bias1 = sB[r0 + 8];
    // only a query block that starts before the key block's last row can
    // hold a causally masked pair
    const bool diagonal = P.causal && q0 < k0 + BLOCK - 1;

#pragma unroll 1
    for (int sl = 0; sl < BLOCK / QS; ++sl) {
      const int cb = sl * QS;
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
      // Sᵀ = K Qᵀ (keys are the rows, queries the columns)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, smem_u32(sK + ((warp * 16 + (lane & 7) + (mat & 1) * 8) * STRIDE +
                                       kk * 16 + (mat >> 1) * 8) * 2));
#pragma unroll
        for (int tp = 0; tp < NT / 2; ++tp) {
          const int qr = cb + tp * 16 + (mat >> 1) * 8 + (lane & 7);
          uint32_t bf[4];
          ldmatrix_x4(bf, smem_u32(sQ + (qr * STRIDE + kk * 16 + (mat & 1) * 8) * 2));
          Mma<T>::mma(s[2 * tp], af, bf[0], bf[1]);
          Mma<T>::mma(s[2 * tp + 1], af, bf[2], bf[3]);
        }
      }
      if (sl == 0) {  // dO and delta
        cp_async_wait<0>();
        __syncthreads();
      }
      // dPᵀ = V dOᵀ
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, smem_u32(sV + ((warp * 16 + (lane & 7) + (mat & 1) * 8) * STRIDE +
                                       kk * 16 + (mat >> 1) * 8) * 2));
#pragma unroll
        for (int tp = 0; tp < NT / 2; ++tp) {
          const int qr = cb + tp * 16 + (mat >> 1) * 8 + (lane & 7);
          uint32_t bf[4];
          ldmatrix_x4(bf, smem_u32(sO + (qr * STRIDE + kk * 16 + (mat & 1) * 8) * 2));
          Mma<T>::mma(dp[2 * tp], af, bf[0], bf[1]);
          Mma<T>::mma(dp[2 * tp + 1], af, bf[2], bf[3]);
        }
      }

      // p, the keep mask, ds and the rounded A operands; thread holds
      // columns (queries) c, c + 1 of key rows r0 (e = 0, 1) and r0 + 8 (2, 3)
      uint32_t pa[NT][2], da[NT][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int c = cb + t * 8 + quad * 2;
        const float2 l = *reinterpret_cast<const float2*>(sL + c);
        const float2 dl = *reinterpret_cast<const float2*>(sDl + c);
        float p[4], d[4], pd[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = q0 + c + (e & 1);
          const float sc = masked_score(s[t][e], P.scale, e < 2 ? bias0 : bias1,
                                        diagonal && qpos < (e < 2 ? kpos0 : kpos1));
          p[e] = __expf(sc - ((e & 1) ? l.y : l.x));
          pd[e] = p[e];
          d[e] = dp[t][e];
        }
        if (P.dropout) {
          // call g: query c + (g & 1), the key quad of row r0 + 8 (g >> 1)
          const uint4 bits = philox4x32_10(make_uint4(qi, kj, c + (g & 1), (r0 >> 2) + (g & 2)),
                                           make_uint2(P.seed, bh));
          uint32_t w[4];
          exchange_words(w, bits, g);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool keep = w[e] >= P.threshold;
            pd[e] = keep ? p[e] * P.keep_scale : 0.f;
            d[e] = keep ? d[e] * P.keep_scale : 0.f;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[e] = p[e] * (d[e] - ((e & 1) ? dl.y : dl.x));
        db0 += ds[0] + ds[1];
        db1 += ds[2] + ds[3];
        pa[t][0] = Mma<T>::pack(pd[0], pd[1]);
        pa[t][1] = Mma<T>::pack(pd[2], pd[3]);
        da[t][0] = Mma<T>::pack(ds[0], ds[1]);
        da[t][1] = Mma<T>::pack(ds[2], ds[3]);
      }

      // dV += Pᵀ dO and dK += dSᵀ Q over the slab's queries
#pragma unroll
      for (int ks = 0; ks < QS / 16; ++ks) {
        const uint32_t ap[4] = {pa[2 * ks][0], pa[2 * ks][1], pa[2 * ks + 1][0],
                                pa[2 * ks + 1][1]};
        const uint32_t ad[4] = {da[2 * ks][0], da[2 * ks][1], da[2 * ks + 1][0],
                                da[2 * ks + 1][1]};
        const int qr = cb + ks * 16 + (mat & 1) * 8 + (lane & 7);
#pragma unroll
        for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
          const int col = dp2 * 16 + (mat >> 1) * 8;
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, smem_u32(sO + (qr * STRIDE + col) * 2));
          Mma<T>::mma(dva[2 * dp2], ap, bf[0], bf[1]);
          Mma<T>::mma(dva[2 * dp2 + 1], ap, bf[2], bf[3]);
          ldmatrix_x4_trans(bf, smem_u32(sQ + (qr * STRIDE + col) * 2));
          Mma<T>::mma(dka[2 * dp2], ad, bf[0], bf[1]);
          Mma<T>::mma(dka[2 * dp2 + 1], ad, bf[2], bf[3]);
        }
      }
    }
  }

  // dk * scale and dv through the warp's own rows of the K and V tiles
  // (no other warp reads them), then 16 bytes a thread
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + quad * 2;
    *reinterpret_cast<uint32_t*>(sK + (r0 * STRIDE + col) * 2) =
        Mma<T>::pack(dka[d][0] * P.scale, dka[d][1] * P.scale);
    *reinterpret_cast<uint32_t*>(sK + ((r0 + 8) * STRIDE + col) * 2) =
        Mma<T>::pack(dka[d][2] * P.scale, dka[d][3] * P.scale);
    *reinterpret_cast<uint32_t*>(sV + (r0 * STRIDE + col) * 2) = Mma<T>::pack(dva[d][0], dva[d][1]);
    *reinterpret_cast<uint32_t*>(sV + ((r0 + 8) * STRIDE + col) * 2) =
        Mma<T>::pack(dva[d][2], dva[d][3]);
  }
  db0 = quad_sum(db0);
  db1 = quad_sum(db1);
  if (quad == 0) {
    db[r0] = db0;
    db[r0 + 8] = db1;
  }
  __syncwarp();
  for (int e = lane; e < 16 * CPR; e += 32) {
    const int r = warp * 16 + e / CPR, ch = e % CPR;
    *reinterpret_cast<uint4*>(dk + r * D + ch * 8) =
        *reinterpret_cast<const uint4*>(sK + (r * STRIDE + ch * 8) * 2);
    *reinterpret_cast<uint4*>(dv + r * D + ch * 8) =
        *reinterpret_cast<const uint4*>(sV + (r * STRIDE + ch * 8) * 2);
  }
}

// ---------------------------------------------------------------------------
// the 16-bit dq on the tensor cores
// ---------------------------------------------------------------------------

// One thread block per (batch*head, query block), a warp per 16 query rows;
// S = Q K^T and dP = dO V^T leave a query row's scores in the accumulator
// registers of its warp, whose rounded ds fragments are the A operand of
// dQ += dS K. Each LUT key block is walked in slabs of 32 keys (p needs no
// running max), so a thread holds dq (D / 2 values) and two 16 x 32 tiles.
template <typename T, int BLOCK, int D>
__global__ void __launch_bounds__(BLOCK * 2, D <= 64 ? 2 : 1)
flash_bwd_dq_mma_kernel(const Params P) {
  using Lay = FwdLayout<BLOCK, D>;
  constexpr int THREADS = BLOCK * 2;
  constexpr int STRIDE = Lay::kStride;
  constexpr int CPR = D / 8;                   // 16-byte chunks per row
  constexpr int KS = BLOCK < 32 ? BLOCK : 32;  // keys a slab
  constexpr int NT = KS / 8;                   // score n-tiles of a slab
  constexpr int DT = D / 8;                    // dq n-tiles
  const int bh = blockIdx.x, qi = blockIdx.y, nqb = gridDim.y;
  const int h = bh % P.H, b = bh / P.H, S = P.S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, mat = lane >> 3;
  extern __shared__ float4 smem4[];
  // Q tile | dO tile | the forward's ring of (K tile, V tile, bias) stages
  unsigned char* sQ = reinterpret_cast<unsigned char*>(smem4);
  unsigned char* sO = sQ + Lay::kTileBytes;
  unsigned char* stages = sO + Lay::kTileBytes;

  const size_t base = static_cast<size_t>(bh) * S * D;
  const size_t rows = base + static_cast<size_t>(qi) * BLOCK * D;
  const T* q = static_cast<const T*>(P.q) + rows;
  const T* dout = static_cast<const T*>(P.dout) + rows;
  const T* k = static_cast<const T*>(P.k) + base;
  const T* v = static_cast<const T*>(P.v) + base;
  T* dq = static_cast<T*>(P.out0) + rows;
  const int* lut = P.lut + (static_cast<size_t>(h) * nqb + qi) * P.maxn;
  const int count = P.counts[h * nqb + qi];

  if (count == 0) {  // the block's rows see no key
    for (int e = tid; e < BLOCK * CPR; e += THREADS)
      reinterpret_cast<uint4*>(dq)[e] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  auto load_tile = [&](unsigned char* dst, const T* src) {
    copy_tile<BLOCK, D, THREADS>(dst, src);
  };
  auto load_bias = [&](unsigned char* stage, int k0) {
    for (int e = tid; e < BLOCK / 4; e += THREADS)
      cp_async16(smem_u32(stage + 2 * Lay::kTileBytes + e * 16), P.bias + b * S + k0 + e * 4,
                 16);
  };

  {  // group 0: Q, the first K and its bias; group 1: dO and the first V
    const int k0 = lut[0] * BLOCK;
    load_tile(sQ, q);
    load_tile(stages, k + static_cast<size_t>(k0) * D);
    load_bias(stages, k0);
    cp_async_commit();
    load_tile(sO, dout);
    load_tile(stages + Lay::kTileBytes, v + static_cast<size_t>(k0) * D);
    cp_async_commit();
  }

  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows of the block: r0, r0 + 8
  const int qpos0 = qi * BLOCK + r0, qpos1 = qpos0 + 8;
  const float* lse = P.lse + static_cast<size_t>(bh) * S;
  const float* delta = P.delta + static_cast<size_t>(bh) * S;
  const float lse0 = lse[qpos0], lse1 = lse[qpos1];
  const float dl0 = delta[qpos0], dl1 = delta[qpos1];
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int n = 0; n < count; ++n) {
    const int kj = lut[n], k0 = kj * BLOCK;
    const bool has_next = n + 1 < count;
    unsigned char* stage = stages + (n & 1) * Lay::kStageBytes;
    if (has_next) {  // the next LUT block loads under this one's products
      unsigned char* next = stages + ((n + 1) & 1) * Lay::kStageBytes;
      const int k1 = lut[n + 1] * BLOCK;
      load_tile(next, k + static_cast<size_t>(k1) * D);
      load_tile(next + Lay::kTileBytes, v + static_cast<size_t>(k1) * D);
      load_bias(next, k1);
      cp_async_commit();
    }
    // K (and, at first, Q) must have landed; at n == 0 dO and V are one
    // group younger
    if (n == 0) {
      if (has_next) cp_async_wait<2>(); else cp_async_wait<1>();
    } else {
      if (has_next) cp_async_wait<1>(); else cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* tK = stage;
    const unsigned char* tV = stage + Lay::kTileBytes;
    const float* sB = reinterpret_cast<const float*>(stage + 2 * Lay::kTileBytes);
    // only a key block that reaches past the query block's first row can
    // hold a causally masked pair; the others skip the compare
    const bool diagonal = P.causal && k0 + BLOCK - 1 > qi * BLOCK;

#pragma unroll 1
    for (int sl = 0; sl < BLOCK / KS; ++sl) {
      const int cb = sl * KS;
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
      // S = Q K^T over the slab's keys
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, smem_u32(sQ + ((warp * 16 + (lane & 7) + (mat & 1) * 8) * STRIDE +
                                       kk * 16 + (mat >> 1) * 8) * 2));
#pragma unroll
        for (int tp = 0; tp < NT / 2; ++tp) {
          const int key = cb + tp * 16 + (mat >> 1) * 8 + (lane & 7);
          uint32_t bf[4];
          ldmatrix_x4(bf, smem_u32(tK + (key * STRIDE + kk * 16 + (mat & 1) * 8) * 2));
          Mma<T>::mma(s[2 * tp], af, bf[0], bf[1]);
          Mma<T>::mma(s[2 * tp + 1], af, bf[2], bf[3]);
        }
      }
      if (n == 0 && sl == 0) {  // dO and the first V
        if (has_next) cp_async_wait<1>(); else cp_async_wait<0>();
        __syncthreads();
      }
      // dP = dO V^T
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, smem_u32(sO + ((warp * 16 + (lane & 7) + (mat & 1) * 8) * STRIDE +
                                       kk * 16 + (mat >> 1) * 8) * 2));
#pragma unroll
        for (int tp = 0; tp < NT / 2; ++tp) {
          const int key = cb + tp * 16 + (mat >> 1) * 8 + (lane & 7);
          uint32_t bf[4];
          ldmatrix_x4(bf, smem_u32(tV + (key * STRIDE + kk * 16 + (mat & 1) * 8) * 2));
          Mma<T>::mma(dp[2 * tp], af, bf[0], bf[1]);
          Mma<T>::mma(dp[2 * tp + 1], af, bf[2], bf[3]);
        }
      }

      // p, the keep mask and ds rounded to T as the A operand; a thread
      // holds keys c, c + 1 of rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3)
      uint32_t da[NT][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int c = cb + t * 8 + (lane & 3) * 2;
        const float2 bias = *reinterpret_cast<const float2*>(sB + c);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          const float sc = masked_score(s[t][e], P.scale, (e & 1) ? bias.y : bias.x,
                                        diagonal && (lo ? qpos0 : qpos1) < k0 + c + (e & 1));
          ds[e] = __expf(sc - (lo ? lse0 : lse1));
        }
        if (P.dropout) {
          uint32_t w[4];
          paired_words(w, P, bh, qi, kj, r0, c >> 2, lane);
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[t][e] = w[e] >= P.threshold ? dp[t][e] * P.keep_scale : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[e] *= dp[t][e] - (e < 2 ? dl0 : dl1);
        da[t][0] = Mma<T>::pack(ds[0], ds[1]);
        da[t][1] = Mma<T>::pack(ds[2], ds[3]);
      }

      // dQ += dS K over the slab's keys
#pragma unroll
      for (int ks = 0; ks < KS / 16; ++ks) {
        const uint32_t a[4] = {da[2 * ks][0], da[2 * ks][1], da[2 * ks + 1][0],
                               da[2 * ks + 1][1]};
        const int key = cb + ks * 16 + (mat & 1) * 8 + (lane & 7);
#pragma unroll
        for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, smem_u32(tK + (key * STRIDE + dp2 * 16 + (mat >> 1) * 8) * 2));
          Mma<T>::mma(acc[2 * dp2], a, bf[0], bf[1]);
          Mma<T>::mma(acc[2 * dp2 + 1], a, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // the stage may be refilled
  }

  // dq * scale through the warp's own rows of the Q tile, then 16 bytes a thread
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + (lane & 3) * 2;
    *reinterpret_cast<uint32_t*>(sQ + (r0 * STRIDE + col) * 2) =
        Mma<T>::pack(acc[d][0] * P.scale, acc[d][1] * P.scale);
    *reinterpret_cast<uint32_t*>(sQ + ((r0 + 8) * STRIDE + col) * 2) =
        Mma<T>::pack(acc[d][2] * P.scale, acc[d][3] * P.scale);
  }
  __syncwarp();
  for (int e = lane; e < 16 * CPR; e += 32) {
    const int r = warp * 16 + e / CPR, ch = e % CPR;
    *reinterpret_cast<uint4*>(dq + r * D + ch * 8) =
        *reinterpret_cast<const uint4*>(sQ + (r * STRIDE + ch * 8) * 2);
  }
}

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int BLOCK, int D>
cudaError_t launch_mma(Kind kind, const Params& P, int BH, cudaStream_t stream) {
  void (*kernel)(const Params) = kind == kFwd  ? flash_fwd_mma_kernel<T, BLOCK, D>
                                 : kind == kDq ? flash_bwd_dq_mma_kernel<T, BLOCK, D>
                                               : flash_bwd_dkv_mma_kernel<T, BLOCK, D>;
  // the forward's and dq's second stage is only ever filled when a row has
  // more than one LUT block; dq holds a dO tile besides the forward's layout
  using Fwd = FwdLayout<BLOCK, D>;
  const int stages = P.maxn > 1 ? 2 : 1;
  const int smem = kind == kFwd  ? Fwd::smem_bytes(stages)
                   : kind == kDq ? Fwd::kTileBytes + Fwd::smem_bytes(stages)
                                 : DkvLayout<BLOCK, D>::kSmemBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BH, P.S / BLOCK), BLOCK * 2, smem, stream>>>(P);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_mma(Kind kind, const Params& P, int BH, cudaStream_t stream) {
  if (P.block == 16) return launch_mma<T, 16, D>(kind, P, BH, stream);
  if (P.block == 32) return launch_mma<T, 32, D>(kind, P, BH, stream);
  if (P.block == 64) return launch_mma<T, 64, D>(kind, P, BH, stream);
  if (P.block == 128) return launch_mma<T, 128, D>(kind, P, BH, stream);
  return cudaErrorInvalidValue;
}

// the fp16 instantiations, defined in flash_attention_fp16.cu
cudaError_t dispatch_mma_f16(Kind kind, int D, const Params& P, int BH, cudaStream_t stream);

}  // namespace flash
}  // namespace dstorch
