// Paged causal decode attention for Hopper (sm_90a): split-KV, 16-byte loads,
// bf16 tensor cores for chunks.
//
// Replaces the Pallas kernel of deepspeed_tpu/kernels/decode_attention.py
// (`_make_kernel` body launched by `_decode_attend_pallas`): attention of
// queries q [B, C, nh, hd] at positions qpos [B, C] over a page pool
// pages_k/v [P, nh, pt, hd] reached through per-lane page tables [B, mp],
// with the online softmax of `_page_update` (key pos <= query pos, -1e30
// sentinel, running (m, l, acc) in fp32, acc / max(l, 1e-30) at the end).
// int8 pages take k_scale[page, head] * 1/sqrt(hd) on the fp32 QK dot and
// v_scale[page, head] on the fp32 probability before the PV sum, so no
// dequantized copy exists.
//
// What bounds it on the H100: decode (C = 1) reads every visible page once
// and does 4*hd flops per key, far below the 295 flop/byte ridge, so it is
// bound by bytes (3.35 TB/s), and a byte-bound kernel is as fast as the
// number of bytes it keeps in flight. A prefill chunk (C in the hundreds)
// reuses each page across many queries; on the bf16 tensor cores it is still
// bound by bytes, on the fp32 CUDA cores by operations.
//
// Design. The TPU grid walks pages as a sequential grid axis with the softmax
// carry in VMEM. Here the cache of a (lane, head, query tile) is cut into
// splits of a fixed number of keys (`pages_per_split` whole pages, at most
// 256 keys), one block per split: every block computes the partial
// (m, l, acc) of its split in fp32 into scratch the wrapper allocates, and a
// second small kernel on the same stream merges a query's partials in
// ascending key order and writes acc / max(l, 1e-30). A block whose split no
// query of its tile can see exits at once. Three routines fill the partials:
//   * vec (bf16 queries, a decode step: C == 1 and not a prefill): no reuse,
//     so no shared-memory staging. Each thread loads 16 bytes (8 bf16 / 16 int8) of a K row and of a V row
//     straight to registers, four rows of each in flight; the threads of a row
//     reduce the dot with shuffles and keep their own online softmax over their
//     rows; rows, then the four warps (each a quarter of the split), merge in a
//     fixed tree.
//   * mma (bf16 queries, a prefill or C >= 2, bf16 or int8 pages): 64 queries
//     a block, 16 a warp; K and V blocks of 64 keys arrive by cp.async in a two-stage ring
//     (int8 is widened to bf16, exactly, on the way), are read with ldmatrix
//     from padded rows, and S = Q K^T and P V run on mma.sync.m16n8k16 with
//     fp32 accumulators. P is fp32 in the TPU kernel; here it is split into a
//     bf16 high part and a bf16 remainder and P V is two products, which keeps
//     ~16 bits of P (the int8 check is one bf16 step of the output).
//   * tile (fp32 queries, any C and page type): the fp32 tolerance (1e-5) is
//     below TF32, so every product stays on the fp32 CUDA cores: 16 queries a
//     block, keys staged 64 at a time in shared memory by 16-byte loads.
//
// Invariance rule: a query's output bits depend only on its own position, its
// own keys and the types, never on B, on the table width mp, on the number of
// splits launched, on the other queries of its tile or on block scheduling.
// The served == one-shot oracle rests on it: serving runs 8 lanes over a
// pool-sized table, generate() one lane over its own cache. Hence split
// boundaries are fixed key positions (a function of pt alone), every partial
// starts from an empty carry, the merge order is fixed, a key block or split a
// query cannot see adds exactly 0 and leaves m alone, and no atomics add
// floats. The routine is chosen by the query type and by the stage, which the
// caller names (`prefill`): a decode step (one query a lane, not a prefill) takes
// vec, a prefill takes mma whatever its width. Serving prefills a prompt as a
// bucket-wide chunk and generate() at its exact length, down to one token, and
// both decode one query a lane, so a request meets the same routine at the same
// stage on both sides; a chunk's rows do not depend on its width.

#include "common.cuh"

namespace dstorch {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplitKeys = 256;  // a split is whole pages, at most this many keys

// partials: acc [nsplit, B, C, nh, HD] and (m, l) [nsplit, B, C, nh, 2], fp32
struct Args {
  const void* q;
  const void* pk;
  const void* pv;
  const int* tables;
  const int* qpos;
  const float* ks;
  const float* vs;
  float* part_acc;
  float* part_ml;
  int B, C, nh, pt, mp, pps, nsplit;
  float scale;
};

__device__ __forceinline__ size_t part_row(const Args& A, int split, int b, int c, int n) {
  return ((static_cast<size_t>(split) * A.B + b) * A.C + c) * A.nh + n;
}

// (m, l, x) <- merge of the carries (m, l, x) and (m2, l2, x2); every product
// and sum is rounded on its own, so the result is symmetric in its arguments
// and the same wherever it is compiled
struct Merge {
  float m, a, b;
  __device__ __forceinline__ Merge(float m1, float m2) {
    m = fmaxf(m1, m2);
    a = expf(m1 - m);
    b = expf(m2 - m);
  }
  __device__ __forceinline__ float operator()(float x1, float x2) const {
    return __fadd_rn(__fmul_rn(x1, a), __fmul_rn(x2, b));
  }
};

// ---------------------------------------------------------------------------
// vec: bf16 queries, a decode step (C == 1, not a prefill)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void unpack16(const uint4& raw, float (&x)[8], __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(const uint4& raw, float (&x)[16], int8_t) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[4 * i + j] = static_cast<float>(static_cast<int>(w[i] << (24 - 8 * j)) >> 24);
  }
}

template <typename KT, int HD>
__global__ void __launch_bounds__(kThreads) decode_vec_kernel(const Args A) {
  constexpr int VEC = 16 / sizeof(KT);  // elements of a row in one 16-byte load
  constexpr int TPR = HD / VEC;         // threads sharing a key row
  constexpr int SLOTS = 32 / TPR;       // key rows a warp loads at once
  constexpr int U = 4;                  // rows of K and of V in flight per thread
  constexpr int G = SLOTS * U;          // keys per warp iteration
  const int split = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int qp = A.qpos[b];
  const int L = A.pps * A.pt, s0 = split * L;
  if (qp < s0) return;  // the query sees nothing of this split
  const int kend = min(min(s0 + L, A.mp * A.pt), qp + 1);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slot = lane / TPR, sub = lane % TPR;
  const KT* pk = static_cast<const KT*>(A.pk);
  const KT* pv = static_cast<const KT*>(A.pv);

  float qv[VEC];
  {
    const __nv_bfloat16* qrow = static_cast<const __nv_bfloat16*>(A.q) +
                                (static_cast<size_t>(b) * A.nh + n) * HD + sub * VEC;
#pragma unroll
    for (int i = 0; i < VEC / 8; ++i) {
      float x[8];
      unpack16(*reinterpret_cast<const uint4*>(qrow + 8 * i), x, __nv_bfloat16());
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[8 * i + e] = x[e];
    }
  }

  // this warp's quarter of the split, in whole iterations (a function of pt)
  const int per_warp = (L + kWarps * G - 1) / (kWarps * G) * G;
  const int w0 = s0 + warp * per_warp;
  const int w1 = min(w0 + per_warp, kend);

  float m = kNegBig, l = 0.f, acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  for (int g0 = w0; g0 < w1; g0 += G) {
    uint4 kraw[U], vraw[U];
    float kmul[U], vmul[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kpos = g0 + u * SLOTS + slot;
      ok[u] = kpos < w1;
      kraw[u] = make_uint4(0u, 0u, 0u, 0u);
      vraw[u] = make_uint4(0u, 0u, 0u, 0u);
      kmul[u] = A.scale;
      vmul[u] = 1.f;
      if (ok[u]) {
        const int j = kpos / A.pt, t = kpos - j * A.pt;
        const int page = A.tables[static_cast<size_t>(b) * A.mp + j];
        const size_t ph = static_cast<size_t>(page) * A.nh + n;
        const size_t off = (ph * A.pt + t) * HD + sub * VEC;
        kraw[u] = *reinterpret_cast<const uint4*>(pk + off);
        vraw[u] = *reinterpret_cast<const uint4*>(pv + off);
        if (A.ks != nullptr) {
          kmul[u] = A.ks[ph] * A.scale;
          vmul[u] = A.vs[ph];
        }
      }
    }
    float s[U];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float x[VEC];
      unpack16(kraw[u], x, KT());
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) dot = fmaf(qv[i], x[i], dot);
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      s[u] = ok[u] ? dot * kmul[u] : kNegBig;
      m_new = fmaxf(m_new, s[u]);
    }
    const float corr = __expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= corr;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = ok[u] ? __expf(s[u] - m_new) : 0.f;
      l += p;
      const float pw = p * vmul[u];
      float x[VEC];
      unpack16(vraw[u], x, KT());
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(pw, x[i], acc[i]);
    }
    m = m_new;
  }

  // the warp's key rows, in a fixed tree
#pragma unroll
  for (int o = TPR; o < 32; o <<= 1) {
    const Merge mg(m, __shfl_xor_sync(0xffffffffu, m, o));
    l = mg(l, __shfl_xor_sync(0xffffffffu, l, o));
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = mg(acc[i], __shfl_xor_sync(0xffffffffu, acc[i], o));
    m = mg.m;
  }
  __shared__ float s_acc[kWarps][HD];
  __shared__ float s_ml[kWarps][2];
  if (slot == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) s_acc[warp][sub * VEC + i] = acc[i];
    if (sub == 0) {
      s_ml[warp][0] = m;
      s_ml[warp][1] = l;
    }
  }
  __syncthreads();
  // the four warps, in ascending key order
  if (tid < HD) {
    float mm = s_ml[0][0], ll = s_ml[0][1], x = s_acc[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const Merge mg(mm, s_ml[w][0]);
      ll = mg(ll, s_ml[w][1]);
      x = mg(x, s_acc[w][tid]);
      mm = mg.m;
    }
    const size_t row = part_row(A, split, b, 0, n);
    A.part_acc[row * HD + tid] = x;
    if (tid == 0) {
      A.part_ml[row * 2] = mm;
      A.part_ml[row * 2 + 1] = ll;
    }
  }
}

// ---------------------------------------------------------------------------
// mma: bf16 queries, a prefill or C >= 2, bf16 or int8 pages
// ---------------------------------------------------------------------------

constexpr int kMQ = 64;  // queries per block: 16 per warp
constexpr int kMK = 64;  // keys per step

template <typename KT, int HD>
struct MmaLayout {
  static constexpr bool kQuant = sizeof(KT) == 1;
  static constexpr int kStride = HD + 8;  // bf16 per tile row: 16 bytes of padding keep
                                          // the eight rows of an ldmatrix on 32 banks
  static constexpr int kTileBytes = kMK * kStride * 2;
  static constexpr int kRawBytes = kMK * HD;  // an int8 tile as it lies in the page
  // Q tile | bf16: ring of 2 x (K, V) operand tiles
  //        | int8: one (K, V) operand tile, ring of 2 x (K, V) raw tiles
  static constexpr int kSmemBytes =
      kTileBytes + (kQuant ? 2 * kTileBytes + 4 * kRawBytes : 4 * kTileBytes);
};

template <typename KT, int HD>
__global__ void __launch_bounds__(kThreads) decode_mma_kernel(const Args A) {
  using Lay = MmaLayout<KT, HD>;
  constexpr bool QUANT = Lay::kQuant;
  constexpr int STRIDE = Lay::kStride;
  constexpr int VEC = 16 / sizeof(KT);
  constexpr int CPR = HD / VEC;  // 16-byte chunks per K or V row
  constexpr int NT = kMK / 8;    // score n-tiles per step
  constexpr int DT = HD / 8;     // output n-tiles
  const int split = blockIdx.x % A.nsplit, tile = blockIdx.x / A.nsplit;
  const int n = blockIdx.y, b = blockIdx.z;
  const int c0 = tile * kMQ, nq = min(kMQ, A.C - c0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = A.pps * A.pt, s0 = split * L;

  extern __shared__ uint4 smem16[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem16);
  __shared__ long long s_rowoff[kMaxSplitKeys];
  __shared__ float s_kmul[QUANT ? kMaxSplitKeys : 1];
  __shared__ float s_vmul[QUANT ? kMaxSplitKeys : 1];
  __shared__ int s_qpos[kMQ];

  // the tile's last position, the same in every warp
  int tmax;
  {
    const int* qp = A.qpos + static_cast<size_t>(b) * A.C + c0;
    const int a0 = lane < nq ? qp[lane] : -1;
    const int a1 = lane + 32 < nq ? qp[lane + 32] : -1;
    int mx = max(a0, a1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    tmax = mx;
    if (warp == 0) {
      s_qpos[lane] = a0;
      s_qpos[lane + 32] = a1;
    }
  }
  if (tmax < s0) return;  // no query of the tile sees this split
  const int kend = min(s0 + L, A.mp * A.pt);     // keys of the split that exist
  const int nvis = min(kend, tmax + 1) - s0;     // ... and that the tile can see
  const int nblk = (nvis + kMK - 1) / kMK;

  for (int i = tid; i < nvis; i += kThreads) {
    const int kpos = s0 + i, j = kpos / A.pt, t = kpos - j * A.pt;
    const int page = A.tables[static_cast<size_t>(b) * A.mp + j];
    const size_t ph = static_cast<size_t>(page) * A.nh + n;
    s_rowoff[i] = static_cast<long long>((ph * A.pt + t) * HD);
    if constexpr (QUANT) {
      s_kmul[i] = A.ks[ph] * A.scale;
      s_vmul[i] = A.vs[ph];
    }
  }

  unsigned char* sQ = smem;
  unsigned char* sOp = smem + Lay::kTileBytes;                       // operand tiles
  unsigned char* sRaw = sOp + 2 * Lay::kTileBytes;                   // int8 only
  const KT* pk = static_cast<const KT*>(A.pk);
  const KT* pv = static_cast<const KT*>(A.pv);

  // Q tile: rows past the chunk are zero
  {
    const __nv_bfloat16* qbase = static_cast<const __nv_bfloat16*>(A.q);
    constexpr int QCPR = HD / 8;
    for (int e = tid; e < kMQ * QCPR; e += kThreads) {
      const int r = e / QCPR, ch = e % QCPR;
      const bool ok = r < nq;
      const __nv_bfloat16* src =
          qbase + ((static_cast<size_t>(b) * A.C + c0 + (ok ? r : 0)) * A.nh + n) * HD + ch * 8;
      cp_async16(smem_u32(sQ + (r * STRIDE + ch * 8) * 2), src, ok ? 16 : 0);
    }
  }
  __syncthreads();  // s_rowoff is written

  // one step's K and V rows into ring stage `stage`; rows the tile cannot see
  // are zero
  auto load_block = [&](int blk, int stage) {
    for (int e = tid; e < kMK * CPR; e += kThreads) {
      const int r = e / CPR, ch = e % CPR;
      const int krel = blk * kMK + r;
      const bool ok = krel < nvis;
      const long long off = ok ? s_rowoff[krel] + ch * VEC : 0;
      unsigned char *dk, *dv;
      if constexpr (QUANT) {
        dk = sRaw + (2 * stage) * Lay::kRawBytes + r * HD + ch * 16;
        dv = dk + Lay::kRawBytes;
      } else {
        dk = sOp + (2 * stage) * Lay::kTileBytes + (r * STRIDE + ch * 8) * 2;
        dv = dk + Lay::kTileBytes;
      }
      cp_async16(smem_u32(dk), pk + off, ok ? 16 : 0);
      cp_async16(smem_u32(dv), pv + off, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows of the tile: r0, r0 + 8
  const int qp0 = s_qpos[r0], qp1 = s_qpos[r0 + 8];
  int wmax = max(qp0, qp1);                // the warp's last position
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));

  float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;  // l: this thread's columns only
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  uint32_t qf[HD / 16][4];

  load_block(0, 0);  // the group also carries the Q tile
  for (int blk = 0; blk < nblk; ++blk) {
    const int stage = blk & 1;
    if (blk + 1 < nblk) {
      load_block(blk + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* tK;
    if constexpr (QUANT) {  // widen the raw stage into the operand tiles (int8 -> bf16 is exact)
      const unsigned char* raw = sRaw + (2 * stage) * Lay::kRawBytes;
      for (int e = tid; e < 2 * kMK * CPR; e += kThreads) {
        const int which = e / (kMK * CPR), f = e % (kMK * CPR);
        const int r = f / CPR, ch = f % CPR;
        const uint4 v =
            *reinterpret_cast<const uint4*>(raw + which * Lay::kRawBytes + r * HD + ch * 16);
        float x[16];
        unpack16(v, x, int8_t());
        uint4 lo, hi;
        lo.x = pack_bf16(x[0], x[1]);
        lo.y = pack_bf16(x[2], x[3]);
        lo.z = pack_bf16(x[4], x[5]);
        lo.w = pack_bf16(x[6], x[7]);
        hi.x = pack_bf16(x[8], x[9]);
        hi.y = pack_bf16(x[10], x[11]);
        hi.z = pack_bf16(x[12], x[13]);
        hi.w = pack_bf16(x[14], x[15]);
        uint4* dst = reinterpret_cast<uint4*>(sOp + which * Lay::kTileBytes +
                                              (r * STRIDE + ch * 16) * 2);
        dst[0] = lo;
        dst[1] = hi;
      }
      __syncthreads();
      tK = sOp;
    } else {
      tK = sOp + (2 * stage) * Lay::kTileBytes;
    }
    const unsigned char* tV = tK + Lay::kTileBytes;

    if (blk == 0) {  // the Q tile has arrived with the first group
      const int mat = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int row = warp * 16 + (lane & 7) + (mat & 1) * 8;
        const int col = kk * 16 + (mat >> 1) * 8;
        ldmatrix_x4(qf[kk], smem_u32(sQ + (row * STRIDE + col) * 2));
      }
    }

    const int kb0 = s0 + blk * kMK;  // the step's first key position
    if (kb0 <= wmax) {               // else every row of the warp is masked: adds exactly 0
      float s[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
      const int mat = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int tp = 0; tp < NT / 2; ++tp) {
          const int key = tp * 16 + (mat >> 1) * 8 + (lane & 7);
          const int col = kk * 16 + (mat & 1) * 8;
          uint32_t bf[4];
          ldmatrix_x4(bf, smem_u32(tK + (key * STRIDE + col) * 2));
          mma_bf16(s[2 * tp], qf[kk], bf[0], bf[1]);
          mma_bf16(s[2 * tp + 1], qf[kk], bf[2], bf[3]);
        }
      }
      // scale, mask, and the step's row maxima
      float mx0 = kNegBig, mx1 = kNegBig;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int krel = blk * kMK + t * 8 + (lane & 3) * 2 + e;
          const int kpos = s0 + krel;
          float km = A.scale;
          if constexpr (QUANT) km = s_kmul[min(krel, kMaxSplitKeys - 1)];
          const bool in = kpos < kend;
          s[t][e] = in && kpos <= qp0 ? s[t][e] * km : kNegBig;
          s[t][2 + e] = in && kpos <= qp1 ? s[t][2 + e] * km : kNegBig;
          mx0 = fmaxf(mx0, s[t][e]);
          mx1 = fmaxf(mx1, s[t][2 + e]);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      const float corr0 = __expf(m0 - mn0), corr1 = __expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= corr0;
      l1 *= corr1;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][0] *= corr0;
        o[d][1] *= corr0;
        o[d][2] *= corr1;
        o[d][3] *= corr1;
      }
      // p, its row sums, and p (times the V scale) as bf16 high and low parts
      uint32_t ph[NT][2], pl[NT][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mrow = e < 2 ? m0 : m1;
          p[e] = s[t][e] > -1e29f ? __expf(s[t][e] - mrow) : 0.f;
        }
        l0 += p[0] + p[1];
        l1 += p[2] + p[3];
        if constexpr (QUANT) {
          const int krel = min(blk * kMK + t * 8 + (lane & 3) * 2, kMaxSplitKeys - 2);
          const float v0 = s_vmul[krel], v1 = s_vmul[krel + 1];
          p[0] = p[0] > 0.f ? p[0] * v0 : 0.f;
          p[1] = p[1] > 0.f ? p[1] * v1 : 0.f;
          p[2] = p[2] > 0.f ? p[2] * v0 : 0.f;
          p[3] = p[3] > 0.f ? p[3] * v1 : 0.f;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p[2 * h], p[2 * h + 1]);
          const float2 back = __bfloat1622float2(hi);
          ph[t][h] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[t][h] = pack_bf16(p[2 * h] - back.x, p[2 * h + 1] - back.y);
        }
      }
      // O += P V, high part and remainder
#pragma unroll
      for (int ks = 0; ks < kMK / 16; ++ks) {
        const uint32_t ah[4] = {ph[2 * ks][0], ph[2 * ks][1], ph[2 * ks + 1][0],
                                ph[2 * ks + 1][1]};
        const uint32_t al[4] = {pl[2 * ks][0], pl[2 * ks][1], pl[2 * ks + 1][0],
                                pl[2 * ks + 1][1]};
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          const int key = ks * 16 + (mat & 1) * 8 + (lane & 7);
          const int col = dp * 16 + (mat >> 1) * 8;
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, smem_u32(tV + (key * STRIDE + col) * 2));
          mma_bf16(o[2 * dp], ah, bf[0], bf[1]);
          mma_bf16(o[2 * dp], al, bf[0], bf[1]);
          mma_bf16(o[2 * dp + 1], ah, bf[2], bf[3]);
          mma_bf16(o[2 * dp + 1], al, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // the stage may be refilled
  }

  // partials of the rows that see this split
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= nq || (h ? qp1 : qp0) < s0) continue;
    const size_t row = part_row(A, split, b, c0 + r, n);
    float* dst = A.part_acc + row * HD + (lane & 3) * 2;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<float2*>(dst + d * 8) = make_float2(o[d][2 * h], o[d][2 * h + 1]);
    if ((lane & 3) == 0) {
      A.part_ml[row * 2] = h ? m1 : m0;
      A.part_ml[row * 2 + 1] = h ? l1 : l0;
    }
  }
}

// ---------------------------------------------------------------------------
// tile: fp32 queries on the fp32 CUDA cores, any C, any page type
// ---------------------------------------------------------------------------

constexpr int kQTile = 16;  // queries per block
constexpr int kQPerWarp = kQTile / kWarps;
constexpr int kKeyBlock = 64;  // keys staged in shared memory at once

template <int HD>
constexpr size_t tile_smem_bytes() {
  return sizeof(float) * (kQTile * HD + kKeyBlock * (HD + 1) + kKeyBlock * HD +
                          kWarps * kKeyBlock);
}

// 16 bytes of a page row, widened to fp32
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[8]) {
  unpack16(*reinterpret_cast<const uint4*>(p), x, __nv_bfloat16());
}
__device__ __forceinline__ void load16(const int8_t* p, float (&x)[16]) {
  unpack16(*reinterpret_cast<const uint4*>(p), x, int8_t());
}

template <typename KT, int HD>
__global__ void __launch_bounds__(kThreads) decode_tile_kernel(const Args A) {
  constexpr int kDPerLane = HD / 32;
  constexpr int VEC = 16 / sizeof(KT);
  const int split = blockIdx.x % A.nsplit, tile = blockIdx.x / A.nsplit;
  const int c0 = tile * kQTile;
  const int n = blockIdx.y, b = blockIdx.z;
  const int C = A.C, nh = A.nh, pt = A.pt, mp = A.mp;
  const int nq = min(kQTile, C - c0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* q = static_cast<const float*>(A.q);
  const KT* pk = static_cast<const KT*>(A.pk);
  const KT* pv = static_cast<const KT*>(A.pv);

  extern __shared__ float smem[];
  float* sq = smem;                          // [kQTile][HD]
  float* sk = sq + kQTile * HD;              // [kKeyBlock][HD + 1]
  float* sv = sk + kKeyBlock * (HD + 1);     // [kKeyBlock][HD]
  float* sp = sv + kKeyBlock * HD;           // [kWarps][kKeyBlock]
  __shared__ int s_qpos[kQTile];
  __shared__ int s_last;

  for (int i = tid; i < kQTile * HD; i += kThreads) {
    const int c = i / HD, d = i % HD;
    sq[i] = c < nq ? q[((static_cast<size_t>(b) * C + c0 + c) * nh + n) * HD + d] : 0.f;
  }
  if (tid < kQTile) s_qpos[tid] = tid < nq ? A.qpos[static_cast<size_t>(b) * C + c0 + tid] : -1;
  __syncthreads();
  if (tid == 0) {
    int mx = -1;
    for (int c = 0; c < nq; ++c) mx = max(mx, s_qpos[c]);
    s_last = mx;
  }
  __syncthreads();
  const int s0 = split * A.pps * pt;
  if (s_last < s0) return;  // no query of the tile sees this split
  const int last_page = min(min((split + 1) * A.pps, mp) - 1, s_last / pt);

  // this warp's queries: the last position any of them can see
  int warp_last = -1;
#pragma unroll
  for (int qi = 0; qi < kQPerWarp; ++qi) {
    const int c = warp * kQPerWarp + qi;
    if (c < nq) warp_last = max(warp_last, s_qpos[c]);
  }

  float m[kQPerWarp], l[kQPerWarp], acc[kQPerWarp][kDPerLane];
#pragma unroll
  for (int qi = 0; qi < kQPerWarp; ++qi) {
    m[qi] = kNegBig;
    l[qi] = 0.f;
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) acc[qi][e] = 0.f;
  }

  for (int j = split * A.pps; j <= last_page; ++j) {
    const int page = A.tables[static_cast<size_t>(b) * mp + j];
    const size_t ph = static_cast<size_t>(page) * nh + n;
    const float k_mul = A.ks != nullptr ? A.ks[ph] * A.scale : A.scale;
    const float v_mul = A.vs != nullptr ? A.vs[ph] : 1.f;
    const KT* kbase = pk + ph * pt * HD;
    const KT* vbase = pv + ph * pt * HD;
    for (int t0 = 0; t0 < pt; t0 += kKeyBlock) {
      const int nk = min(kKeyBlock, pt - t0);
      const int kpos0 = j * pt + t0;
      if (kpos0 > s_last) break;  // block-uniform: nothing further is visible
      __syncthreads();            // the previous key block has been consumed
      // the key block is one contiguous run of the page: 16 bytes a thread
      for (int i = tid; i < nk * HD / VEC; i += kThreads) {
        const int e0 = i * VEC, t = e0 / HD, d = e0 % HD;
        float x[VEC];
        load16(kbase + static_cast<size_t>(t0) * HD + e0, x);
#pragma unroll
        for (int e = 0; e < VEC; ++e) sk[t * (HD + 1) + d + e] = x[e];
        load16(vbase + static_cast<size_t>(t0) * HD + e0, x);
#pragma unroll
        for (int e = 0; e < VEC; ++e) sv[t * HD + d + e] = x[e];
      }
      __syncthreads();
      if (kpos0 > warp_last) continue;  // warp-uniform: all masked, adds exactly 0
#pragma unroll
      for (int qi = 0; qi < kQPerWarp; ++qi) {
        const int c = warp * kQPerWarp + qi;
        if (c >= nq) continue;
        const int qp = s_qpos[c];
        if (kpos0 > qp) continue;  // this query sees none of the block
        const float* qrow = sq + c * HD;
        float s[2];
        bool ok[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = lane + 32 * r;
          ok[r] = t < nk && kpos0 + t <= qp;
          float dot = 0.f;
          if (ok[r]) {
            const float* krow = sk + t * (HD + 1);
#pragma unroll 16
            for (int d = 0; d < HD; ++d) dot = fmaf(qrow[d], krow[d], dot);
          }
          s[r] = ok[r] ? dot * k_mul : kNegBig;
        }
        const float m_new = fmaxf(m[qi], warp_max(fmaxf(s[0], s[1])));
        float psum = 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p = ok[r] ? expf(s[r] - m_new) : 0.f;
          sp[warp * kKeyBlock + lane + 32 * r] = p;
          psum += p;
        }
        psum = warp_sum(psum);
        const float corr = expf(m[qi] - m_new);
        l[qi] = l[qi] * corr + psum;
        m[qi] = m_new;
        __syncwarp();
        const float* prow = sp + warp * kKeyBlock;
#pragma unroll
        for (int e = 0; e < kDPerLane; ++e) {
          const int d = lane + 32 * e;
          float pvs = 0.f;
          for (int t = 0; t < nk; ++t) pvs = fmaf(prow[t], sv[t * HD + d], pvs);
          acc[qi][e] = acc[qi][e] * corr + pvs * v_mul;
        }
        __syncwarp();
      }
    }
  }

#pragma unroll
  for (int qi = 0; qi < kQPerWarp; ++qi) {
    const int c = warp * kQPerWarp + qi;
    if (c >= nq || s_qpos[c] < s0) continue;
    const size_t row = part_row(A, split, b, c0 + c, n);
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) A.part_acc[row * HD + lane + 32 * e] = acc[qi][e];
    if (lane == 0) {
      A.part_ml[row * 2] = m[qi];
      A.part_ml[row * 2 + 1] = l[qi];
    }
  }
}

// ---------------------------------------------------------------------------
// merge: a query's partials in ascending key order, then acc / max(l, 1e-30)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store_out4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store_out4(__nv_bfloat16* p, float4 v) {
  uint2 u;
  u.x = pack_bf16(v.x, v.y);
  u.y = pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename QT>
__global__ void __launch_bounds__(256) decode_merge_kernel(const Args A, QT* __restrict__ out,
                                                           int hd) {
  const size_t nrows = static_cast<size_t>(A.B) * A.C * A.nh;  // queries x heads
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int per_row = hd / 4;
  if (idx >= nrows * per_row) return;
  const size_t row = idx / per_row;
  const int d = static_cast<int>(idx % per_row) * 4;
  const int qp = A.qpos[row / A.nh];
  const int nvalid = qp < 0 ? 0 : min(A.nsplit, qp / (A.pps * A.pt) + 1);
  float m = kNegBig, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < nvalid; ++s) {
    const size_t prow = static_cast<size_t>(s) * nrows + row;
    const float2 ml = *reinterpret_cast<const float2*>(A.part_ml + prow * 2);
    const float4 x = *reinterpret_cast<const float4*>(A.part_acc + prow * hd + d);
    const Merge mg(m, ml.x);
    l = mg(l, ml.y);
    acc = make_float4(mg(acc.x, x.x), mg(acc.y, x.y), mg(acc.z, x.z), mg(acc.w, x.w));
    m = mg.m;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  store_out4(out + row * hd + d,
             make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename KT, int HD>
cudaError_t launch_vec(const Args& A, cudaStream_t stream) {
  decode_vec_kernel<KT, HD><<<dim3(A.nsplit, A.nh, A.B), kThreads, 0, stream>>>(A);
  return cudaGetLastError();
}

template <typename KT, int HD>
cudaError_t launch_mma(const Args& A, cudaStream_t stream) {
  auto kernel = decode_mma_kernel<KT, HD>;
  constexpr int smem = MmaLayout<KT, HD>::kSmemBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (A.C + kMQ - 1) / kMQ;
  kernel<<<dim3(tiles * A.nsplit, A.nh, A.B), kThreads, smem, stream>>>(A);
  return cudaGetLastError();
}

template <typename KT, int HD>
cudaError_t launch_tile(const Args& A, cudaStream_t stream) {
  auto kernel = decode_tile_kernel<KT, HD>;
  constexpr size_t smem = tile_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (A.C + kQTile - 1) / kQTile;
  kernel<<<dim3(tiles * A.nsplit, A.nh, A.B), kThreads, smem, stream>>>(A);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_merge(const Args& A, void* out, int hd, cudaStream_t stream) {
  const size_t threads = static_cast<size_t>(A.B) * A.C * A.nh * (hd / 4);
  const unsigned blocks = static_cast<unsigned>((threads + 255) / 256);
  decode_merge_kernel<QT><<<blocks, 256, 0, stream>>>(A, static_cast<QT*>(out), hd);
  return cudaGetLastError();
}

// the routine by the query type and the stage (see the header)
template <int HD>
cudaError_t partials(const Args& A, int q_dtype, int kv_dtype, bool prefill, cudaStream_t st) {
  if (q_dtype == kF32) {
    if (kv_dtype == kF32) return launch_tile<float, HD>(A, st);
    if (kv_dtype == kBF16) return launch_tile<__nv_bfloat16, HD>(A, st);
    if (kv_dtype == kI8) return launch_tile<int8_t, HD>(A, st);
  } else if (q_dtype == kBF16 && A.C == 1 && !prefill) {
    if (kv_dtype == kBF16) return launch_vec<__nv_bfloat16, HD>(A, st);
    if (kv_dtype == kI8) return launch_vec<int8_t, HD>(A, st);
  } else if (q_dtype == kBF16) {
    if (kv_dtype == kBF16) return launch_mma<__nv_bfloat16, HD>(A, st);
    if (kv_dtype == kI8) return launch_mma<int8_t, HD>(A, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dstorch

extern "C" const char* ds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q/out dtype `q_dtype` (0 f32, 1 bf16); page dtype `kv_dtype` (0 f32,
// 1 bf16, 2 int8; int8 needs k_scale/v_scale [P, nh] f32, else pass null).
// The cache is cut into splits of `pages_per_split` pages (at most 256 keys);
// `part_acc` [nsplit, B, C, nh, hd] and `part_ml` [nsplit, B, C, nh, 2] are
// fp32 scratch for the splits' partials, nsplit = ceil(mp / pages_per_split).
// `prefill` != 0 says the queries are a prompt's chunk, not a decode step (it
// picks the routine, see the header). Two device kernels are launched: the
// partials, then the merge.
extern "C" int ds_decode_attend(const void* q, const void* pages_k, const void* pages_v,
                                const void* tables, const void* qpos, const void* k_scale,
                                const void* v_scale, void* out, void* part_acc,
                                void* part_ml, int B, int C, int nh, int hd, int pt, int mp,
                                int pages_per_split, int q_dtype, int kv_dtype, int prefill,
                                float scale, void* stream) {
  using namespace dstorch;
  if (B < 1 || C < 1 || nh < 1 || pt < 1 || mp < 1 || pages_per_split < 1 ||
      pages_per_split * pt > kMaxSplitKeys)
    return cudaErrorInvalidValue;
  if ((kv_dtype == kI8) != (k_scale != nullptr) || (k_scale == nullptr) != (v_scale == nullptr))
    return cudaErrorInvalidValue;
  Args A;
  A.q = q;
  A.pk = pages_k;
  A.pv = pages_v;
  A.tables = static_cast<const int*>(tables);
  A.qpos = static_cast<const int*>(qpos);
  A.ks = static_cast<const float*>(k_scale);
  A.vs = static_cast<const float*>(v_scale);
  A.part_acc = static_cast<float*>(part_acc);
  A.part_ml = static_cast<float*>(part_ml);
  A.B = B;
  A.C = C;
  A.nh = nh;
  A.pt = pt;
  A.mp = mp;
  A.pps = pages_per_split;
  A.nsplit = (mp + pages_per_split - 1) / pages_per_split;
  A.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (hd == 64)
    err = partials<64>(A, q_dtype, kv_dtype, prefill != 0, st);
  else if (hd == 128)
    err = partials<128>(A, q_dtype, kv_dtype, prefill != 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (q_dtype == kF32)
    err = launch_merge<float>(A, out, hd, st);
  else
    err = launch_merge<__nv_bfloat16>(A, out, hd, st);
  return static_cast<int>(err);
}
