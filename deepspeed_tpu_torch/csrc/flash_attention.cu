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
// Files: the launch parameters, Philox and the three tensor-core kernels,
// templated on their 16-bit element type, are in flash_attention_mma.cuh;
// this file instantiates them for bf16, holds the fp32 CUDA-core kernels and
// the C entries; flash_attention_fp16.cu instantiates them for fp16 (fp16
// training with loss scaling), so nvcc builds the two halves in parallel.
// What is said below of the bf16 kernels holds for fp16 as well: the same
// tiles and instructions, only the product (mma ... .f16.f16) and the
// rounding (__floats2half2_rn, inf past the range) differ.
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

#include "flash_attention_mma.cuh"

namespace dstorch {
namespace flash {
namespace {

constexpr int kChunks = 8;  // float4 chunks per thread: 32 of a row's D values

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

// bf16 and fp16 run on the tensor cores (fp16's instantiations live in
// flash_attention_fp16.cu), fp32 on the CUDA cores (fp32 holds 1e-5, which
// TF32 cannot); any other head dim or dtype is refused
cudaError_t dispatch(Kind kind, int dtype, int D, const Params& P, int BH,
                     cudaStream_t stream) {
  if (dtype == kBF16) {
    if (D == 32) return dispatch_mma<__nv_bfloat16, 32>(kind, P, BH, stream);
    if (D == 64) return dispatch_mma<__nv_bfloat16, 64>(kind, P, BH, stream);
    if (D == 128) return dispatch_mma<__nv_bfloat16, 128>(kind, P, BH, stream);
  } else if (dtype == kF16) {
    return dispatch_mma_f16(kind, D, P, BH, stream);
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
}  // namespace flash
}  // namespace dstorch

// q, k, v, out [B, H, S, D] in `dtype` (0 f32, 1 bf16, 3 f16); bias fp32 [B, S];
// lut int32 [H, S/block, maxn]; counts int32 [H, S/block]; lse fp32 [B*H, S].
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                            const void* lut, const void* counts, void* out, void* lse,
                            int B, int H, int S, int D, int block, int maxn, int causal,
                            int dtype, float scale, unsigned seed, unsigned threshold,
                            float keep_scale, int dropout, void* stream) {
  using namespace dstorch::flash;
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
  using namespace dstorch::flash;
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
  using namespace dstorch::flash;
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
