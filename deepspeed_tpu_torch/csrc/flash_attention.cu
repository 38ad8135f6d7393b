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
// 32 flops per byte in bf16, far below the tensor cores' ridge (~295) but above
// the fp32 CUDA cores' (~20). These kernels run every product on the CUDA cores
// in fp32, so they are bound by fp32 operations; wgmma on bf16 tiles is the
// next step.
//
// Design. One block per (batch*head, LUT block): the TPU's sequential grid of
// key blocks becomes a loop inside the block. D/32 neighbouring threads share a
// query (or, in dk/dv, a key) row, each holding 32 of its D values in
// registers as eight float4 chunks interleaved across the row's threads, so a
// warp reads a staged tile row from shared memory as a broadcast without bank
// conflicts; a dot product is the threads' partial sums reduced with shuffles.
// The LUT block's keys (or, in dk/dv, queries) are staged in shared memory in
// fp32. The forward walks each key block twice, once for the block's max and
// once for p and the PV sum, so the softmax updates at the same granularity
// (and rounds p at the same points) as the JAX kernel without storing a score
// tile. dk/dv/db of a key block come from one block of threads: no atomics, and
// the result does not depend on scheduling.

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
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// this thread's chunk i of a D-long row: chunks interleave across the TPR
// threads of the row
template <int TPR>
__device__ __forceinline__ int chunk_off(int sub, int i) {
  return (sub + TPR * i) * 4;
}

template <int TPR, typename T>
__device__ __forceinline__ void load_row(float4 (&x)[kChunks], const T* row, int sub) {
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

// rows [0, rows) of a D-wide tile of T from device memory into fp32 shared memory
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int rows) {
  for (int e = threadIdx.x; e < rows * D / 4; e += blockDim.x)
    *reinterpret_cast<float4*>(dst + e * 4) = load4(src + e * 4);
}

// s = (a . b) * scale + bias, or the causal sentinel (the fp32 multiply is
// kept apart from the add, as in the JAX kernel)
__device__ __forceinline__ float masked_score(float dot, float scale, float bias,
                                              bool masked) {
  return masked ? kNegBig : __fmul_rn(dot, scale) + bias;
}

template <typename T, int D>
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
  const T* k = static_cast<const T*>(P.k) + base;
  const T* v = static_cast<const T*>(P.v) + base;
  const int qpos = qi * blk + row;
  float4 qv[kChunks], acc[kChunks];
  load_row<TPR>(qv, static_cast<const T*>(P.q) + base + static_cast<size_t>(qpos) * D, sub);
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
      axpy_row<TPR>(acc, round_to<T>(pa), vs + j * D, sub);
    }
    l = l * corr + psum;
    m = m_new;
  }

  const bool alive = l > 0.f;
  T* o = static_cast<T*>(P.out0) + base + static_cast<size_t>(qpos) * D;
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

template <typename T, int D>
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
  const T* k = static_cast<const T*>(P.k) + base;
  const T* v = static_cast<const T*>(P.v) + base;
  const int qpos = qi * blk + row;
  float4 qv[kChunks], dov[kChunks], dq[kChunks];
  load_row<TPR>(qv, static_cast<const T*>(P.q) + base + static_cast<size_t>(qpos) * D, sub);
  load_row<TPR>(dov, static_cast<const T*>(P.dout) + base + static_cast<size_t>(qpos) * D,
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
      axpy_row<TPR>(dq, round_to<T>(ds), ks + j * D, sub);
    }
  }

  T* o = static_cast<T*>(P.out0) + base + static_cast<size_t>(qpos) * D;
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
    store4(o + chunk_off<TPR>(sub, i),
           make_float4(dq[i].x * P.scale, dq[i].y * P.scale, dq[i].z * P.scale,
                       dq[i].w * P.scale));
}

template <typename T, int D>
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
  const T* q = static_cast<const T*>(P.q) + base;
  const T* dout = static_cast<const T*>(P.dout) + base;
  const int kpos = kj * blk + col;
  float4 kv[kChunks], vv[kChunks], dk[kChunks], dv[kChunks];
  load_row<TPR>(kv, static_cast<const T*>(P.k) + base + static_cast<size_t>(kpos) * D, sub);
  load_row<TPR>(vv, static_cast<const T*>(P.v) + base + static_cast<size_t>(kpos) * D, sub);
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
      axpy_row<TPR>(dv, round_to<T>(p_drop), dos + i * D, sub);
      const float ds = p * (dp - deltas[i]);
      axpy_row<TPR>(dk, round_to<T>(ds), qs + i * D, sub);
      db += ds;
    }
  }

  T* okv = static_cast<T*>(P.out0) + base + static_cast<size_t>(kpos) * D;
  T* ovv = static_cast<T*>(P.out1) + base + static_cast<size_t>(kpos) * D;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    store4(okv + chunk_off<TPR>(sub, i),
           make_float4(dk[i].x * P.scale, dk[i].y * P.scale, dk[i].z * P.scale,
                       dk[i].w * P.scale));
    store4(ovv + chunk_off<TPR>(sub, i), dv[i]);
  }
  if (sub == 0) P.out2[static_cast<size_t>(bh) * S + kpos] = db;
}

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
cudaError_t launch(Kind kind, const Params& P, int BH, cudaStream_t stream) {
  void (*kernel)(const Params) = kind == kFwd  ? flash_fwd_kernel<T, D>
                                 : kind == kDq ? flash_bwd_dq_kernel<T, D>
                                               : flash_bwd_dkv_kernel<T, D>;
  const size_t smem = sizeof(float) * (2 * P.block * D + 2 * P.block);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BH, P.S / P.block), P.block * (D / 32), smem, stream>>>(P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(Kind kind, int D, const Params& P, int BH, cudaStream_t stream) {
  if (D == 32) return launch<T, 32>(kind, P, BH, stream);
  if (D == 64) return launch<T, 64>(kind, P, BH, stream);
  if (D == 128) return launch<T, 128>(kind, P, BH, stream);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kF32)
    err = dispatch_d<float>(kind, D, P, B * H, st);
  else if (dtype == kBF16)
    err = dispatch_d<__nv_bfloat16>(kind, D, P, B * H, st);
  return static_cast<int>(err);
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
