// Banded sink+window attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel of deepspeed_tpu/kernels/sparse_attention.py
// (`_make_kernel` body launched by `_band_attend_pallas`): each query
// q [N, nh, hd] at position pos[i] attends its window slice
// k_win/v_win [N, nh, W, hd] (tokens [base, base + W), valid where
// token <= pos) plus the anchor page k_sink/v_sink [N, nh, pt, hd]
// (tokens [0, pt), valid where token < base), with the math of
// `_band_math`: scores in the input dtype, softmax in fp32 over all the
// query's keys (not online), probabilities rounded to the input dtype
// before the PV sum.
//
// What bounds it on the H100: every query reads its own visible keys and
// values and does 4*hd flops per key, about one flop per byte, so it is
// bound by bytes whatever the batch. The window slices are gathered per
// query outside the kernel (as in JAX), so neighbouring queries' windows
// overlap in memory only through L2.
//
// Design. One block of 8 warps per (query, head). The mask is a prefix of
// each part: window keys t <= pos - base and sink keys t < base. A masked
// key's probability is exp(-1e30 - m) = 0 exactly in fp32, so the kernel
// never loads masked keys: it walks the query's visible keys (the sink's,
// then the window's) and nothing else, which changes no bit for finite
// inputs. (Where no key is visible, the plain version averages V over all
// of them; the kernel then walks all keys with masked scores and does the
// same.) A lane loads 16 bytes of a key row, so a row is hd * size / 16
// lanes (8 for bf16 at hd 64) and a warp instruction reads several rows;
// each lane keeps two rounds of four rows in flight. A QK dot reduces over
// its row's lanes only; scores go to shared memory, the block takes their
// max and sum in fp32, and p = T(e / sum) replaces each score. The PV pass
// walks the same keys in the same lanes (its first round of V loads is
// issued before the softmax, so it lands under the reductions): each lane
// accumulates p * v for its 16 bytes of dimensions, then the row groups of
// a warp and the warps merge in fixed trees. The order of every sum depends
// on the query's own count of visible keys alone, so a query's bits do not
// depend on N or its neighbours; there is one routine per dtype and head dim.

#include "common.cuh"

namespace dstorch {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // key rows a lane loads per round

__device__ float block_reduce(float v, float* red, bool is_max) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// 16 bytes of T widened to fp32, and back
__device__ __forceinline__ void widen(float (&x)[4], const uint4& u) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen(float (&x)[8], const uint4& u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 narrow(const float (&x)[4]) {
  return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                    __float_as_uint(x[3]));
}
__device__ __forceinline__ uint4 narrow(const float (&x)[8]) {
  return make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                    pack_bf16(x[6], x[7]));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
band_attend_kernel(const T* __restrict__ q, const T* __restrict__ kw,
                   const T* __restrict__ vw, const T* __restrict__ ksink,
                   const T* __restrict__ vsink, const int* __restrict__ pos,
                   const int* __restrict__ base, T* __restrict__ out, int nh, int W,
                   int pt, float scale) {
  constexpr int EPL = 16 / sizeof(T);  // elements of a row a lane loads
  constexpr int LPR = HD / EPL;        // lanes a key row
  constexpr int RPW = 32 / LPR;        // key rows a warp instruction
  constexpr int ROWS = kWarps * RPW;   // key rows a block instruction
  constexpr int STEP = kUnroll * ROWS;  // key rows a round
  static_assert(LPR <= 32 && 32 % LPR == 0, "a key row must fit a warp");
  const int row = blockIdx.x;  // query * nh + head
  const int i = row / nh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane % LPR, rg = lane / LPR;

  extern __shared__ float smem[];
  float* part = smem;               // [kWarps, HD] PV partials of the warps
  float* ss = part + kWarps * HD;   // [visible keys] scores, then probabilities
  __shared__ float red[kWarps];

  const int p = pos[i], bs = base[i];
  int nsink = min(max(bs, 0), pt);        // sink keys t < base
  int nwin = min(max(p - bs + 1, 0), W);  // window keys base + t <= pos
  const bool none = nsink + nwin == 0;
  if (none) {
    nsink = pt;
    nwin = W;
  }
  const int nkeys = nsink + nwin;
  const size_t srow = static_cast<size_t>(row) * pt * HD, wrow = static_cast<size_t>(row) * W * HD;
  // this lane's 16 bytes of visible key u (the sink's keys first)
  auto at = [&](const T* sink, const T* win, int u) {
    const T* r = u < nsink ? sink + srow + static_cast<size_t>(u) * HD
                           : win + wrow + static_cast<size_t>(u - nsink) * HD;
    return *reinterpret_cast<const uint4*>(r + sub * EPL);
  };
  // round `u0`'s rows of this lane: u0 + rg + j * ROWS
  auto load = [&](uint4 (&raw)[kUnroll], const T* sink, const T* win, int u0) {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int u = u0 + rg + j * ROWS;
      if (u < nkeys) raw[j] = at(sink, win, u);
    }
  };

  float qv[EPL];
  widen(qv, *reinterpret_cast<const uint4*>(q + static_cast<size_t>(row) * HD + sub * EPL));

  // QK: a round's loads are issued before the previous round is consumed
  uint4 cur[kUnroll], nxt[kUnroll];
  load(cur, ksink, kw, warp * RPW);
  for (int u0 = warp * RPW; u0 < nkeys; u0 += STEP) {  // u0 is the same in a warp
    const bool more = u0 + STEP < nkeys;
    if (more) load(nxt, ksink, kw, u0 + STEP);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      float k[EPL];
      widen(k, cur[j]);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) dot = fmaf(qv[e], k[e], dot);
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const int u = u0 + rg + j * ROWS;
      // the einsum and the scale multiply both run in T, as in _band_math
      if (sub == 0 && u < nkeys) ss[u] = none ? kNegBig : round_to<T>(round_to<T>(dot) * scale);
    }
    if (more) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) cur[j] = nxt[j];
    }
  }
  load(cur, vsink, vw, warp * RPW);  // the first V round lands under the softmax
  __syncthreads();

  float mx = kNegBig;
  for (int t = tid; t < nkeys; t += kThreads) mx = fmaxf(mx, ss[t]);
  mx = block_reduce(mx, red, true);
  float sum = 0.f;
  for (int t = tid; t < nkeys; t += kThreads) {
    const float e = expf(ss[t] - mx);
    ss[t] = e;
    sum += e;
  }
  sum = block_reduce(sum, red, false);
  for (int t = tid; t < nkeys; t += kThreads) ss[t] = round_to<T>(ss[t] / sum);
  __syncthreads();

  float acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  for (int u0 = warp * RPW; u0 < nkeys; u0 += STEP) {
    const bool more = u0 + STEP < nkeys;
    if (more) load(nxt, vsink, vw, u0 + STEP);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int u = u0 + rg + j * ROWS;
      if (u < nkeys) {
        float v[EPL];
        widen(v, cur[j]);
        const float pr = ss[u];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] = fmaf(pr, v[e], acc[e]);
      }
    }
    if (more) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) cur[j] = nxt[j];
    }
  }
  // merge: the row groups of a warp (xor tree), then the warps in order
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  if (rg == 0) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) part[warp * HD + sub * EPL + e] = acc[e];
  }
  __syncthreads();
  if (tid < LPR) {
    float r[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) r[e] = part[tid * EPL + e];
    for (int w = 1; w < kWarps; ++w)
#pragma unroll
      for (int e = 0; e < EPL; ++e) r[e] += part[w * HD + tid * EPL + e];
    float o[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] = round_to<T>(r[e]);
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * HD + tid * EPL) = narrow(o);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kw, const void* vw, const void* ks,
                   const void* vs, const int* pos, const int* base, void* out, int N,
                   int nh, int W, int pt, float scale, cudaStream_t stream) {
  auto kernel = band_attend_kernel<T, HD>;
  const size_t smem = sizeof(float) * (kWarps * HD + pt + W);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<N * nh, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kw), static_cast<const T*>(vw),
      static_cast<const T*>(ks), static_cast<const T*>(vs), pos, base,
      static_cast<T*>(out), nh, W, pt, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* kw, const void* vw,
                        const void* ks, const void* vs, const int* pos, const int* base,
                        void* out, int N, int nh, int W, int pt, float scale,
                        cudaStream_t stream) {
  if (hd == 64)
    return launch<T, 64>(q, kw, vw, ks, vs, pos, base, out, N, nh, W, pt, scale, stream);
  if (hd == 128)
    return launch<T, 128>(q, kw, vw, ks, vs, pos, base, out, N, nh, W, pt, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dstorch

// All tensors share `dtype` (0 f32, 1 bf16); pos and base are int32 [N].
extern "C" int ds_band_attend(const void* q, const void* k_win, const void* v_win,
                              const void* k_sink, const void* v_sink, const void* pos,
                              const void* base, void* out, int N, int nh, int hd, int W,
                              int pt, int dtype, float scale, void* stream) {
  using namespace dstorch;
  if (N < 1 || nh < 1 || W < 1 || pt < 1) return cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(pos);
  const int* b = static_cast<const int*>(base);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kF32)
    err = dispatch_hd<float>(hd, q, k_win, v_win, k_sink, v_sink, p, b, out, N, nh, W, pt,
                             scale, st);
  else if (dtype == kBF16)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k_win, v_win, k_sink, v_sink, p, b, out, N,
                                     nh, W, pt, scale, st);
  return static_cast<int>(err);
}
