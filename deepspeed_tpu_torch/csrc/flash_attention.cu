// Flash attention forward and backward for Hopper (sm_90a), with in-kernel
// dropout on the softmax probabilities.
//
// Replaces the three Pallas kernels of deepspeed_tpu/ops/transformer/attention.py:
//   ds_flash_fwd     <- _attn_kernel         (:94, launched by _attention_pallas)
//   ds_flash_bwd_dq  <- _attn_bwd_dq_kernel  (:204, launched by _attention_pallas_bwd)
//   ds_flash_bwd_dkv <- _attn_bwd_dkv_kernel (:246, launched by _attention_pallas_bwd)
// with their arithmetic: scores s = (q k^T) * scale + key bias in fp32 from
// input-dtype operands, the causal -1e30 sentinel, the online softmax per LUT
// key block (running max m, denominator l, accumulator acc), probabilities
// rounded to the input dtype before the PV product, out = 0 and lse = 1e30 for
// rows that saw no key; dq and dk/dv recompute p = exp(s - lse), round ds to
// the input dtype before its products, and the dk/dv program also sums the key
// bias gradient db over its rows.
//
// Dropout: the keep mask of tile (qi, kj) comes from Philox4x32-10 with key
// (seed, batch*head) and counter (qi, kj, row, col / 4), one call giving four
// columns; a probability is kept when its word is >= threshold and is then
// scaled by 1 / (1 - rate). All three kernels regenerate the identical mask
// (the plain PyTorch versions draw the same bits).
//
// What bounds it on the H100: at the training shapes (S = 128, D = 64) each
// (batch, head) reads 4 S x D tiles and does ~4 S^2 D flops per product, about
// 32 flops per byte in bf16, far below the tensor cores' ridge (~295): on the
// tensor cores the three bf16 kernels are bound by bytes. On the fp32 CUDA
// cores (ridge ~20) the same work is bound by operations; that is where the
// fp32 kernels run (fp32 holds 1e-5, which TF32 cannot).
//
// Design of the bf16 forward (`flash_fwd_mma_kernel`). One block per
// (batch*head, LUT block): the TPU's sequential grid of key blocks becomes a
// loop inside the block. Each warp owns 16 query rows of the block
// (block / 16 warps). Q, K, V tiles and the key bias arrive in shared memory
// as they lie in device memory (bf16, cp.async, 16 bytes a thread) in rows
// padded by 16 bytes, so the eight rows of an ldmatrix fall on all 32 banks;
// with more than one LUT block the next block's K and V load into the second
// stage under this block's products, and for the first block V is its own
// copy group, so it lands under the QK product. S = Q K^T runs once per tile
// on mma.sync.m16n8k16 (bf16 operands, fp32 accumulators: the TPU kernel's
// "fp32 from input-dtype operands"), and the whole 16 x block score tile of a
// warp stays in its accumulator registers: the row max, exp, the row sum, the
// dropout mask and the rounding of p to bf16 happen on those fragments, and
// the rounded p is the A operand of the PV product. The softmax updates once
// per LUT block, so p is rounded against the same running max as in the TPU
// kernel and the plain version. In an accumulator a thread holds two
// neighbouring columns of rows r and r + 8, a Philox call gives four columns:
// the lanes t, t^1 share a column quad, the even lane draws row r's call and
// the odd lane row r + 8's, and they hand each other the two words the other
// needs (`__shfl_xor` by 1, `paired_words`): one call per lane per eight
// columns, the same bits as before. The output goes back through the warp's
// rows of the Q tile so that it is stored 16 bytes a thread.
//
// Design of the bf16 dq (`flash_bwd_dq_mma_kernel`). Bound by bytes like
// the other two: at the main case (B = 64, H = 16, S = 128, D = 64) q, dO,
// k and v are read and dq written once, ~85 MB with lse, delta and the
// bias, 0.025 ms at 3.35 TB/s, against 6.4 GFLOP of products. It is the
// forward's block turned to the backward: one block per (batch*head, query
// block), a warp per 16 query rows; Q and dO
// arrive once, K, V and the key bias of each LUT block through the forward's
// ring (with more than one LUT block the next block's tiles load under this
// one's products), and each thread keeps lse and delta of its two rows in
// registers. The backward knows lse, so p needs no running max and a key
// block is walked in slabs of 32 keys: S = Q K^T and dP = dO V^T on mma.sync
// (K and V as B operands through ldmatrix), p = exp(s - lse), the keep mask
// and ds = p (dp - delta) on the accumulator fragments, and the bf16-rounded
// ds fragments are the A operand of dQ += dS K (K through ldmatrix .trans, as
// the forward feeds V). A thread holds dq (D / 2 values) and one slab's S and
// dP. Rows are queries, as in the forward, so the keep mask comes from the
// forward's lane pairing (`paired_words`); a slab's edge is a multiple of 8
// columns and never splits a column quad. Fully masked causal slabs are
// computed, not skipped: a row whose visited keys are all masked has
// lse = -1e30 + log n and a p of 1, as in the plain version. dq * scale
// leaves through the warp's own Q rows, 16 bytes a thread, without atomics.
// Registers (`nvcc -Xptxas -v`, build/torch_kernels/nvcc.log), no
// instantiation spilling: D = 64 122 at block 128 (two blocks an SM) and
// 148-155 at blocks 16-64; D = 128 156-185; D = 32 121-124.
//
// Design of the bf16 dk/dv/db (`flash_bwd_dkv_mma_kernel`). Its bound is
// bytes: at the main case (B = 64, H = 16, S = 128, D = 64, one LUT block)
// q, k, v and dO are read and dk and dv written once, ~102 MB with lse,
// delta, the bias and db, 0.0305 ms at 3.35 TB/s, against 8.6 GFLOP of
// products (0.009 ms on the tensor cores). So the products must leave the
// CUDA cores, and every tile must cross device memory once. One block per
// (batch*head, key block) walks the transposed LUT's query blocks; each warp
// owns 16 key rows. K and V arrive once, Q, dO, lse and delta once per query
// block (cp.async, rows padded as in the forward; Q in the first copy group,
// dO in the second, under the first Sᵀ product). Sᵀ = K Qᵀ and dPᵀ = V dOᵀ
// run on mma.sync with fp32 accumulators, so a key row's scores lie in its
// warp's registers: p = exp(s - lse), the keep mask, ds = p (dp - delta) and
// the row sums of ds (db, unrounded) are taken there, and the bf16-rounded
// p_drop and ds fragments are the A operands of dV += Pᵀ dO and dK += dSᵀ Q
// (dO and Q as B operands through ldmatrix .trans), the forward's trick. The
// backward knows lse, so a query block's slabs of 32 queries are
// independent: a thread holds dk and dv of its rows and one slab's Sᵀ and dPᵀ
// (a D = 64 block of 128 keys fits two blocks an SM). dk and dv stay in
// registers over the LUT and leave through the warp's own K and V tile rows,
// 16 bytes a thread: no atomics, the same bits whatever the schedule. In the
// transposed accumulator the four keys of one Philox call lie in four lanes
// (row-groups g..g+3 of a column pair); each makes one of the n-tile's four
// calls and three xor shuffles swap the words (`exchange_words`): one call
// per four elements, `_dropout_keep`'s bits.
//
// The fp32 kernels: D/32 neighbouring threads share a query (or, in dk/dv,
// a key) row, each holding 32 of its D values in
// registers as eight float4 chunks interleaved across the row's threads, so a
// warp reads a staged tile row from shared memory as a broadcast without bank
// conflicts; a dot product is the threads' partial sums reduced with shuffles.
// The LUT block's keys (or, in dk/dv, queries) are staged in shared memory in
// fp32. The fp32 forward walks each key block twice, once for the block's max
// and once for p and the PV sum (it holds 1e-5, which TF32 cannot). dk/dv/db
// of a key block come from one block of threads: no atomics, and the result
// does not depend on scheduling.

#include "common.cuh"

namespace dstorch {
namespace {

constexpr int kChunks = 8;     // float4 chunks per thread: 32 of a row's D values
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

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// this thread's chunk i of a D-long row: chunks interleave across the TPR
// threads of the row
template <int TPR>
__device__ __forceinline__ int chunk_off(int sub, int i) {
  return (sub + TPR * i) * 4;
}

template <int TPR>
__device__ __forceinline__ void load_row(float4 (&x)[kChunks], const float* row, int sub) {
#pragma unroll
  for (int i = 0; i < kChunks; ++i) x[i] = load4(row + chunk_off<TPR>(sub, i));
}

// the full dot of a register row with a shared-memory row (all TPR threads
// of the row get the same sum)
template <int TPR>
__device__ __forceinline__ float dot_row(const float4 (&x)[kChunks], const float* r, int sub) {
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const float4 y = *reinterpret_cast<const float4*>(r + chunk_off<TPR>(sub, i));
    a = fmaf(x[i].x, y.x, a);
    a = fmaf(x[i].y, y.y, a);
    a = fmaf(x[i].z, y.z, a);
    a = fmaf(x[i].w, y.w, a);
  }
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  return a;
}

// acc += w * smem row
template <int TPR>
__device__ __forceinline__ void axpy_row(float4 (&acc)[kChunks], float w, const float* r,
                                         int sub) {
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const float4 y = *reinterpret_cast<const float4*>(r + chunk_off<TPR>(sub, i));
    acc[i].x = fmaf(w, y.x, acc[i].x);
    acc[i].y = fmaf(w, y.y, acc[i].y);
    acc[i].z = fmaf(w, y.z, acc[i].z);
    acc[i].w = fmaf(w, y.w, acc[i].w);
  }
}

// rows [0, rows) of a D-wide fp32 tile from device memory into shared memory
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int rows) {
  for (int e = threadIdx.x; e < rows * D / 4; e += blockDim.x)
    *reinterpret_cast<float4*>(dst + e * 4) = load4(src + e * 4);
}

// s = (a . b) * scale + bias, or the causal sentinel (the fp32 multiply is
// kept apart from the add, as in the JAX kernel)
__device__ __forceinline__ float masked_score(float dot, float scale, float bias,
                                              bool masked) {
  return masked ? kNegBig : __fmul_rn(dot, scale) + bias;
}

template <int D>
__global__ void __launch_bounds__(128 * (D / 32))
flash_fwd_kernel(const Params P) {
  constexpr int TPR = D / 32;
  const int bh = blockIdx.x, qi = blockIdx.y, nqb = gridDim.y;
  const int h = bh % P.H, b = bh / P.H, S = P.S, blk = P.block;
  const int row = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + blk * D;
  float* bs = vs + blk * D;

  const size_t base = static_cast<size_t>(bh) * S * D;
  const float* k = static_cast<const float*>(P.k) + base;
  const float* v = static_cast<const float*>(P.v) + base;
  const int qpos = qi * blk + row;
  float4 qv[kChunks], acc[kChunks];
  load_row<TPR>(qv, static_cast<const float*>(P.q) + base + static_cast<size_t>(qpos) * D, sub);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNegBig, l = 0.f;
  const int* lut = P.lut + (static_cast<size_t>(h) * nqb + qi) * P.maxn;
  const int count = P.counts[h * nqb + qi];

  for (int n = 0; n < count; ++n) {
    const int kj = lut[n], k0 = kj * blk;
    __syncthreads();  // every thread is done with the previous tile
    stage<D>(ks, k + static_cast<size_t>(k0) * D, blk);
    stage<D>(vs, v + static_cast<size_t>(k0) * D, blk);
    for (int e = threadIdx.x; e < blk; e += blockDim.x) bs[e] = P.bias[b * S + k0 + e];
    __syncthreads();

    float mb = kNegBig;
    for (int j = 0; j < blk; ++j) {
      const float s = masked_score(dot_row<TPR>(qv, ks + j * D, sub), P.scale, bs[j],
                                   P.causal && qpos < k0 + j);
      mb = fmaxf(mb, s);
    }
    const float m_new = fmaxf(m, mb);
    const float corr = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      acc[i].x *= corr;
      acc[i].y *= corr;
      acc[i].z *= corr;
      acc[i].w *= corr;
    }
    float psum = 0.f;
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    for (int j = 0; j < blk; ++j) {
      const float s = masked_score(dot_row<TPR>(qv, ks + j * D, sub), P.scale, bs[j],
                                   P.causal && qpos < k0 + j);
      const float p = expf(s - m_new);
      psum += p;
      float pa = p;
      if (P.dropout) {
        if ((j & 3) == 0)
          bits = philox4x32_10(make_uint4(qi, kj, row, j >> 2), make_uint2(P.seed, bh));
        pa = word(bits, j & 3) >= P.threshold ? p * P.keep_scale : 0.f;
      }
      axpy_row<TPR>(acc, pa, vs + j * D, sub);
    }
    l = l * corr + psum;
    m = m_new;
  }

  const bool alive = l > 0.f;
  float* o = static_cast<float*>(P.out0) + base + static_cast<size_t>(qpos) * D;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const float4 r = alive ? make_float4(acc[i].x / l, acc[i].y / l, acc[i].z / l,
                                         acc[i].w / l)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(o + chunk_off<TPR>(sub, i), r);
  }
  if (sub == 0)
    static_cast<float*>(P.out1)[static_cast<size_t>(bh) * S + qpos] =
        alive ? m + logf(l) : kBig;
}

// ---------------------------------------------------------------------------
// bf16 forward on the tensor cores
// ---------------------------------------------------------------------------

template <int BLOCK, int D>
struct FwdLayout {
  static constexpr int kStride = D + 8;  // bf16 per tile row, 16 bytes of padding
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

// a BLOCK x D bf16 tile from device memory into shared-memory rows padded
// by 16 bytes (FwdLayout::kStride), 16 bytes a thread by cp.async
template <int BLOCK, int D, int THREADS>
__device__ __forceinline__ void copy_tile(unsigned char* dst, const __nv_bfloat16* src) {
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
template <int BLOCK, int D>
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
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(P.q) + base +
                           static_cast<size_t>(qi) * BLOCK * D;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(P.k) + base;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(P.v) + base;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(P.out0) + base +
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

  auto load_tile = [&](unsigned char* dst, const __nv_bfloat16* src) {
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
        mma_bf16(s[2 * tp], qf, bf[0], bf[1]);
        mma_bf16(s[2 * tp + 1], qf, bf[2], bf[3]);
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

    // p, its row sums, the keep mask, and p rounded to bf16 as the A operand
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
      pa[t][0] = pack_bf16(p[0], p[1]);
      pa[t][1] = pack_bf16(p[2], p[3]);
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
        mma_bf16(o[2 * dp], a, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the stage may be refilled
  }

  // out = acc / l through the warp's own rows of the Q tile, then 16 bytes a thread
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const bool alive0 = l0 > 0.f, alive1 = l1 > 0.f;
  // one division a row: the quotient is rounded to bf16 anyway
  const float inv0 = alive0 ? 1.f / l0 : 0.f, inv1 = alive1 ? 1.f / l1 : 0.f;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + (lane & 3) * 2;
    *reinterpret_cast<uint32_t*>(sQ + (r0 * STRIDE + col) * 2) =
        pack_bf16(o[d][0] * inv0, o[d][1] * inv0);
    *reinterpret_cast<uint32_t*>(sQ + ((r0 + 8) * STRIDE + col) * 2) =
        pack_bf16(o[d][2] * inv1, o[d][3] * inv1);
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

template <int D>
__global__ void __launch_bounds__(128 * (D / 32))
flash_bwd_dq_kernel(const Params P) {
  constexpr int TPR = D / 32;
  const int bh = blockIdx.x, qi = blockIdx.y, nqb = gridDim.y;
  const int h = bh % P.H, b = bh / P.H, S = P.S, blk = P.block;
  const int row = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + blk * D;
  float* bs = vs + blk * D;

  const size_t base = static_cast<size_t>(bh) * S * D;
  const float* k = static_cast<const float*>(P.k) + base;
  const float* v = static_cast<const float*>(P.v) + base;
  const int qpos = qi * blk + row;
  float4 qv[kChunks], dov[kChunks], dq[kChunks];
  load_row<TPR>(qv, static_cast<const float*>(P.q) + base + static_cast<size_t>(qpos) * D, sub);
  load_row<TPR>(dov, static_cast<const float*>(P.dout) + base + static_cast<size_t>(qpos) * D,
                sub);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) dq[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float lse = P.lse[static_cast<size_t>(bh) * S + qpos];
  const float delta = P.delta[static_cast<size_t>(bh) * S + qpos];
  const int* lut = P.lut + (static_cast<size_t>(h) * nqb + qi) * P.maxn;
  const int count = P.counts[h * nqb + qi];

  for (int n = 0; n < count; ++n) {
    const int kj = lut[n], k0 = kj * blk;
    __syncthreads();
    stage<D>(ks, k + static_cast<size_t>(k0) * D, blk);
    stage<D>(vs, v + static_cast<size_t>(k0) * D, blk);
    for (int e = threadIdx.x; e < blk; e += blockDim.x) bs[e] = P.bias[b * S + k0 + e];
    __syncthreads();

    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    for (int j = 0; j < blk; ++j) {
      const float s = masked_score(dot_row<TPR>(qv, ks + j * D, sub), P.scale, bs[j],
                                   P.causal && qpos < k0 + j);
      const float p = expf(s - lse);
      float dp = dot_row<TPR>(dov, vs + j * D, sub);
      if (P.dropout) {
        if ((j & 3) == 0)
          bits = philox4x32_10(make_uint4(qi, kj, row, j >> 2), make_uint2(P.seed, bh));
        dp = word(bits, j & 3) >= P.threshold ? dp * P.keep_scale : 0.f;
      }
      const float ds = p * (dp - delta);
      axpy_row<TPR>(dq, ds, ks + j * D, sub);
    }
  }

  float* o = static_cast<float*>(P.out0) + base + static_cast<size_t>(qpos) * D;
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
    store4(o + chunk_off<TPR>(sub, i),
           make_float4(dq[i].x * P.scale, dq[i].y * P.scale, dq[i].z * P.scale,
                       dq[i].w * P.scale));
}

template <int D>
__global__ void __launch_bounds__(128 * (D / 32))
flash_bwd_dkv_kernel(const Params P) {
  constexpr int TPR = D / 32;
  const int bh = blockIdx.x, kj = blockIdx.y, nkb = gridDim.y;
  const int h = bh % P.H, b = bh / P.H, S = P.S, blk = P.block;
  const int col = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + blk * D;
  float* lses = dos + blk * D;
  float* deltas = lses + blk;

  const size_t base = static_cast<size_t>(bh) * S * D;
  const float* q = static_cast<const float*>(P.q) + base;
  const float* dout = static_cast<const float*>(P.dout) + base;
  const int kpos = kj * blk + col;
  float4 kv[kChunks], vv[kChunks], dk[kChunks], dv[kChunks];
  load_row<TPR>(kv, static_cast<const float*>(P.k) + base + static_cast<size_t>(kpos) * D, sub);
  load_row<TPR>(vv, static_cast<const float*>(P.v) + base + static_cast<size_t>(kpos) * D, sub);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    dk[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float db = 0.f;
  const float bias = P.bias[b * S + kpos];
  const int* qlut = P.lut + (static_cast<size_t>(h) * nkb + kj) * P.maxn;
  const int count = P.counts[h * nkb + kj];

  for (int n = 0; n < count; ++n) {
    const int qi = qlut[n], q0 = qi * blk;
    __syncthreads();
    stage<D>(qs, q + static_cast<size_t>(q0) * D, blk);
    stage<D>(dos, dout + static_cast<size_t>(q0) * D, blk);
    for (int e = threadIdx.x; e < blk; e += blockDim.x) {
      lses[e] = P.lse[static_cast<size_t>(bh) * S + q0 + e];
      deltas[e] = P.delta[static_cast<size_t>(bh) * S + q0 + e];
    }
    __syncthreads();

    for (int i = 0; i < blk; ++i) {
      const float s = masked_score(dot_row<TPR>(kv, qs + i * D, sub), P.scale, bias,
                                   P.causal && q0 + i < kpos);
      const float p = expf(s - lses[i]);
      float dp = dot_row<TPR>(vv, dos + i * D, sub);
      float p_drop = p;
      if (P.dropout) {
        const uint4 bits =
            philox4x32_10(make_uint4(qi, kj, i, col >> 2), make_uint2(P.seed, bh));
        const bool keep = word(bits, col & 3) >= P.threshold;
        p_drop = keep ? p * P.keep_scale : 0.f;
        dp = keep ? dp * P.keep_scale : 0.f;
      }
      axpy_row<TPR>(dv, p_drop, dos + i * D, sub);
      const float ds = p * (dp - deltas[i]);
      axpy_row<TPR>(dk, ds, qs + i * D, sub);
      db += ds;
    }
  }

  float* okv = static_cast<float*>(P.out0) + base + static_cast<size_t>(kpos) * D;
  float* ovv = static_cast<float*>(P.out1) + base + static_cast<size_t>(kpos) * D;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    store4(okv + chunk_off<TPR>(sub, i),
           make_float4(dk[i].x * P.scale, dk[i].y * P.scale, dk[i].z * P.scale,
                       dk[i].w * P.scale));
    store4(ovv + chunk_off<TPR>(sub, i), dv[i]);
  }
  if (sub == 0) P.out2[static_cast<size_t>(bh) * S + kpos] = db;
}

// ---------------------------------------------------------------------------
// bf16 dk/dv/db on the tensor cores
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
template <int BLOCK, int D>
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
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(P.q) + base;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(P.dout) + base;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(P.k) + base + static_cast<size_t>(k0) * D;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(P.v) + base + static_cast<size_t>(k0) * D;
  __nv_bfloat16* dk = static_cast<__nv_bfloat16*>(P.out0) + base + static_cast<size_t>(k0) * D;
  __nv_bfloat16* dv = static_cast<__nv_bfloat16*>(P.out1) + base + static_cast<size_t>(k0) * D;
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

  auto load_tile = [&](unsigned char* dst, const __nv_bfloat16* src) {
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
          mma_bf16(s[2 * tp], af, bf[0], bf[1]);
          mma_bf16(s[2 * tp + 1], af, bf[2], bf[3]);
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
          mma_bf16(dp[2 * tp], af, bf[0], bf[1]);
          mma_bf16(dp[2 * tp + 1], af, bf[2], bf[3]);
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
        pa[t][0] = pack_bf16(pd[0], pd[1]);
        pa[t][1] = pack_bf16(pd[2], pd[3]);
        da[t][0] = pack_bf16(ds[0], ds[1]);
        da[t][1] = pack_bf16(ds[2], ds[3]);
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
          mma_bf16(dva[2 * dp2], ap, bf[0], bf[1]);
          mma_bf16(dva[2 * dp2 + 1], ap, bf[2], bf[3]);
          ldmatrix_x4_trans(bf, smem_u32(sQ + (qr * STRIDE + col) * 2));
          mma_bf16(dka[2 * dp2], ad, bf[0], bf[1]);
          mma_bf16(dka[2 * dp2 + 1], ad, bf[2], bf[3]);
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
        pack_bf16(dka[d][0] * P.scale, dka[d][1] * P.scale);
    *reinterpret_cast<uint32_t*>(sK + ((r0 + 8) * STRIDE + col) * 2) =
        pack_bf16(dka[d][2] * P.scale, dka[d][3] * P.scale);
    *reinterpret_cast<uint32_t*>(sV + (r0 * STRIDE + col) * 2) = pack_bf16(dva[d][0], dva[d][1]);
    *reinterpret_cast<uint32_t*>(sV + ((r0 + 8) * STRIDE + col) * 2) =
        pack_bf16(dva[d][2], dva[d][3]);
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
// bf16 dq on the tensor cores
// ---------------------------------------------------------------------------

// One thread block per (batch*head, query block), a warp per 16 query rows;
// S = Q K^T and dP = dO V^T leave a query row's scores in the accumulator
// registers of its warp, whose rounded ds fragments are the A operand of
// dQ += dS K. Each LUT key block is walked in slabs of 32 keys (p needs no
// running max), so a thread holds dq (D / 2 values) and two 16 x 32 tiles.
template <int BLOCK, int D>
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
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(P.q) + rows;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(P.dout) + rows;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(P.k) + base;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(P.v) + base;
  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(P.out0) + rows;
  const int* lut = P.lut + (static_cast<size_t>(h) * nqb + qi) * P.maxn;
  const int count = P.counts[h * nqb + qi];

  if (count == 0) {  // the block's rows see no key
    for (int e = tid; e < BLOCK * CPR; e += THREADS)
      reinterpret_cast<uint4*>(dq)[e] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  auto load_tile = [&](unsigned char* dst, const __nv_bfloat16* src) {
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
          mma_bf16(s[2 * tp], af, bf[0], bf[1]);
          mma_bf16(s[2 * tp + 1], af, bf[2], bf[3]);
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
          mma_bf16(dp[2 * tp], af, bf[0], bf[1]);
          mma_bf16(dp[2 * tp + 1], af, bf[2], bf[3]);
        }
      }

      // p, the keep mask and ds rounded to bf16 as the A operand; a thread
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
        da[t][0] = pack_bf16(ds[0], ds[1]);
        da[t][1] = pack_bf16(ds[2], ds[3]);
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
          mma_bf16(acc[2 * dp2], a, bf[0], bf[1]);
          mma_bf16(acc[2 * dp2 + 1], a, bf[2], bf[3]);
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
        pack_bf16(acc[d][0] * P.scale, acc[d][1] * P.scale);
    *reinterpret_cast<uint32_t*>(sQ + ((r0 + 8) * STRIDE + col) * 2) =
        pack_bf16(acc[d][2] * P.scale, acc[d][3] * P.scale);
  }
  __syncwarp();
  for (int e = lane; e < 16 * CPR; e += 32) {
    const int r = warp * 16 + e / CPR, ch = e % CPR;
    *reinterpret_cast<uint4*>(dq + r * D + ch * 8) =
        *reinterpret_cast<const uint4*>(sQ + (r * STRIDE + ch * 8) * 2);
  }
}

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

template <int D>
cudaError_t launch_fp32(Kind kind, const Params& P, int BH, cudaStream_t stream) {
  void (*kernel)(const Params) = kind == kFwd  ? flash_fwd_kernel<D>
                                 : kind == kDq ? flash_bwd_dq_kernel<D>
                                               : flash_bwd_dkv_kernel<D>;
  const size_t smem = sizeof(float) * (2 * P.block * D + 2 * P.block);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BH, P.S / P.block), P.block * (D / 32), smem, stream>>>(P);
  return cudaGetLastError();
}

template <int BLOCK, int D>
cudaError_t launch_mma(Kind kind, const Params& P, int BH, cudaStream_t stream) {
  void (*kernel)(const Params) = kind == kFwd  ? flash_fwd_mma_kernel<BLOCK, D>
                                 : kind == kDq ? flash_bwd_dq_mma_kernel<BLOCK, D>
                                               : flash_bwd_dkv_mma_kernel<BLOCK, D>;
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

template <int D>
cudaError_t dispatch_mma(Kind kind, const Params& P, int BH, cudaStream_t stream) {
  if (P.block == 16) return launch_mma<16, D>(kind, P, BH, stream);
  if (P.block == 32) return launch_mma<32, D>(kind, P, BH, stream);
  if (P.block == 64) return launch_mma<64, D>(kind, P, BH, stream);
  if (P.block == 128) return launch_mma<128, D>(kind, P, BH, stream);
  return cudaErrorInvalidValue;
}

// bf16 runs on the tensor cores, fp32 on the CUDA cores (fp32 holds 1e-5,
// which TF32 cannot); any other head dim or dtype is refused
cudaError_t dispatch(Kind kind, int dtype, int D, const Params& P, int BH,
                     cudaStream_t stream) {
  if (dtype == kBF16) {
    if (D == 32) return dispatch_mma<32>(kind, P, BH, stream);
    if (D == 64) return dispatch_mma<64>(kind, P, BH, stream);
    if (D == 128) return dispatch_mma<128>(kind, P, BH, stream);
  } else if (dtype == kF32) {
    if (D == 32) return launch_fp32<32>(kind, P, BH, stream);
    if (D == 64) return launch_fp32<64>(kind, P, BH, stream);
    if (D == 128) return launch_fp32<128>(kind, P, BH, stream);
  }
  return cudaErrorInvalidValue;
}

int run(Kind kind, Params& P, int B, int H, int S, int D, int block, int maxn, int causal,
        int dtype, float scale, unsigned seed, unsigned threshold, float keep_scale,
        int dropout, void* stream) {
  const bool block_ok = block == 16 || block == 32 || block == 64 || block == 128;
  if (B < 1 || H < 1 || S < 1 || maxn < 1 || !block_ok || S % block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  P.H = H;
  P.S = S;
  P.block = block;
  P.maxn = maxn;
  P.causal = causal;
  P.scale = scale;
  P.seed = seed;
  P.threshold = threshold;
  P.keep_scale = keep_scale;
  P.dropout = dropout;
  return static_cast<int>(
      dispatch(kind, dtype, D, P, B * H, static_cast<cudaStream_t>(stream)));
}

}  // namespace
}  // namespace dstorch

// q, k, v, out [B, H, S, D] in `dtype` (0 f32, 1 bf16); bias fp32 [B, S];
// lut int32 [H, S/block, maxn]; counts int32 [H, S/block]; lse fp32 [B*H, S].
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                            const void* lut, const void* counts, void* out, void* lse,
                            int B, int H, int S, int D, int block, int maxn, int causal,
                            int dtype, float scale, unsigned seed, unsigned threshold,
                            float keep_scale, int dropout, void* stream) {
  using namespace dstorch;
  Params P{};
  P.q = q;
  P.k = k;
  P.v = v;
  P.bias = static_cast<const float*>(bias);
  P.lut = static_cast<const int*>(lut);
  P.counts = static_cast<const int*>(counts);
  P.out0 = out;
  P.out1 = lse;
  return run(kFwd, P, B, H, S, D, block, maxn, causal, dtype, scale, seed, threshold,
             keep_scale, dropout, stream);
}

// dq [B, H, S, D] from dO, lse and delta (fp32 [B*H, S]) over the row LUT.
extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* bias, const void* dout, const void* lse,
                               const void* delta, const void* lut, const void* counts,
                               void* dq, int B, int H, int S, int D, int block, int maxn,
                               int causal, int dtype, float scale, unsigned seed,
                               unsigned threshold, float keep_scale, int dropout,
                               void* stream) {
  using namespace dstorch;
  Params P{};
  P.q = q;
  P.k = k;
  P.v = v;
  P.bias = static_cast<const float*>(bias);
  P.dout = dout;
  P.lse = static_cast<const float*>(lse);
  P.delta = static_cast<const float*>(delta);
  P.lut = static_cast<const int*>(lut);
  P.counts = static_cast<const int*>(counts);
  P.out0 = dq;
  return run(kDq, P, B, H, S, D, block, maxn, causal, dtype, scale, seed, threshold,
             keep_scale, dropout, stream);
}

// dk, dv [B, H, S, D] and db fp32 [B*H, S] over the transposed LUT (qlut,
// qcounts: for each key block, the query blocks that see it).
extern "C" int ds_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* bias, const void* dout, const void* lse,
                                const void* delta, const void* qlut, const void* qcounts,
                                void* dk, void* dv, void* db, int B, int H, int S, int D,
                                int block, int maxn, int causal, int dtype, float scale,
                                unsigned seed, unsigned threshold, float keep_scale,
                                int dropout, void* stream) {
  using namespace dstorch;
  Params P{};
  P.q = q;
  P.k = k;
  P.v = v;
  P.bias = static_cast<const float*>(bias);
  P.dout = dout;
  P.lse = static_cast<const float*>(lse);
  P.delta = static_cast<const float*>(delta);
  P.lut = static_cast<const int*>(qlut);
  P.counts = static_cast<const int*>(qcounts);
  P.out0 = dk;
  P.out1 = dv;
  P.out2 = static_cast<float*>(db);
  return run(kDkv, P, B, H, S, D, block, maxn, causal, dtype, scale, seed, threshold,
             keep_scale, dropout, stream);
}
