// Paged-attention decode for Hopper (sm_90a): one query token per slot
// against that slot's keys and values in a shared page pool.
//
// Replaces src/repro/kernels/paged_attn.py::_kernel, the Pallas TPU kernel
// of the paged serve path. For slot b and query head h of KV group g
// (rep = H / KV heads per group):
//   s[t] = (q[b,h] . k[t] + q2[b,h] . k2[t]) * scale   (fp32; q, q2 first
//          rounded to the pool's type, as the reference casts them)
//   s[t] = -1e30 unless t <= pos[b] (and t > pos[b] - window)
//   p    = exp(s - max s) / sum exp(s - max s), rounded to the pool's type
//   out[b,h] = sum_t p[t] * v[t]                         (fp32)
// where key t of the slot lives in page table[b, t / P] at offset t % P.
// The rope term (q2, k2) and Dv != D are for multi-head latent attention.
//
// What bounds it: bytes. Each live key and value row is read once for all
// rep heads of its group, a few operations per byte, far below the card's
// ratio. The bytes the function needs are the live K/V rows,
// sum over slots of (pos + 1) * KV * (D + Dv) * sizeof(pool type), plus q,
// the table and the output. At decode sizes (a few MB) the time is set by
// how many loads are in flight across the card, not by the byte count.
//
// The design (split-K, "flash-decoding", with the reference's rounding):
//   * The grid is (splits, KV groups x head chunks, slots). Each split owns
//     a contiguous range of whole pages; the host picks the split size from
//     the table's capacity so that the grid fills at least one wave of the
//     card's SMs (132 on an H100 SXM). The grid never depends on pos (a
//     device tensor), so it is the same from step to step. A split
//     outside the live keys [lo, hi] writes an empty partial and touches
//     no key. If the mask leaves no key at all, every key is scored -1e30
//     and the softmax is uniform, as in the reference.
//   * The reference rounds the normalised probabilities to the pool's type
//     before the PV product, which needs the global max and sum; an online
//     softmax with per-split rescaling would round other numbers. So two
//     launches: the scores kernel writes each split's fp32 scores to a
//     workspace and its (max, sum exp(s - max)) per head; the PV kernel
//     combines every split's (max, sum) in split order into the same global
//     max and sum in every CTA, rounds p = exp(s - max) / sum to the pool
//     type, multiplies by V in fp32 and writes a partial output per split.
//     The last CTA of each (slot, group) to finish, found by an atomic
//     counter after a __threadfence(), adds the partial outputs in split
//     order and resets the counter for the next call. Every sum has a
//     fixed order; nothing is accumulated with atomics.
//   * A score's dot product keeps W partial sums per lane and adds them, and
//     the kSub lanes, as trees: no fp32 sum runs over more than D / 64 terms
//     in a row, which holds wide heads (MLA's 512 + 64) to the bound.
//   * Memory-level parallelism: a key row is read with 16-byte vector loads
//     by 8 lanes, so a warp scores 4 keys at once and a CTA 32; q sits in
//     shared memory in a swizzled order that those loads read without bank
//     conflicts. In the PV kernel each thread owns 8 adjacent columns of one
//     head and walks the split's keys with 16-byte loads of V, eight rows in
//     flight; the V row offsets and every split's (max, sum) are staged in
//     shared memory by all threads at once, one round trip to L2 each; the
//     last CTA loads eight splits' partial outputs at a time. Shapes whose
//     rows are not multiples of 8 elements (or pools not 16-byte aligned)
//     take the same code with one element per load.
// Tensor cores are not used: at 8 heads per group the products are tiny.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 8;               // lanes that score one key together
constexpr int kKeysPerWarp = 32 / kSub;
constexpr int kRB = 8;                // heads scored per pass over a key
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Round an fp32 value to T and back (the reference's astype to the pool type).
template <typename T>
__device__ __forceinline__ float round_as(float v);
template <>
__device__ __forceinline__ float round_as<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// W consecutive elements at p as fp32: one 16-byte load of 8 bf16, two of
// 8 floats (p 16-byte aligned), or one scalar load when W == 1.
template <int W>
__device__ __forceinline__ void load_w(const float* p, float (&o)[W]) {
  if constexpr (W == 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  } else {
    o[0] = *p;
  }
}
template <int W>
__device__ __forceinline__ void load_w(const __nv_bfloat16* p, float (&o)[W]) {
  if constexpr (W == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  } else {
    o[0] = __bfloat162float(*p);
  }
}

// The W elements c .. c+W-1 of a q row stored with q_slot (c % 8 == 0).
template <int W>
__device__ __forceinline__ void load_q(const float* qr, int c, float (&o)[W]) {
  if constexpr (W == 8) {
    const float* p = qr + (c & ~63) + ((c & 63) >> 3) * 4;
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 32);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  } else {
    o[0] = qr[c];
  }
}

__device__ __forceinline__ float sub_sum(float v) {  // over the kSub lanes of a key
#pragma unroll
  for (int o = kSub / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Args {
  const void* q;      // (B, H, D)
  const void* q2;     // (B, H, D2) or null
  const void* kp;     // (N, P, KV, D)
  const void* vp;     // (N, P, KV, Dv)
  const void* k2p;    // (N, P, KV, D2) or null
  const int* table;   // (B, MP)
  const int* pos;     // (B,) or (1,): pos[b * pos_stride]
  float* out;         // (B, H, Dv)
  float* scores;      // workspace (B, H, MP * P)
  float* mpart;       // (S, B, H) max of each split's scores
  float* lpart;       // (S, B, H) sum of exp(s - split max)
  float* opart;       // (S, B, H, Dv) each split's share of the output
  unsigned* count;    // (B, G) finished CTAs per (slot, group); 0 between calls
  int B, H, KV, D, Dv, D2, P, MP, pos_stride;
  int hpc;            // query heads per CTA (divides rep)
  int ps;             // pages per split
  int window;         // <= 0: none
  float scale;
};

// Where a CTA works: its split, heads and the live keys of its slot.
struct Place {
  int s, b, g, gc, h0;
  int lo, hi;         // live keys of the slot (every key if all are masked)
  bool all_masked;
  int a, z;           // the split's live keys: a..z, empty if a > z
};

__device__ __forceinline__ void live_range(const Args& p, int b, int& lo, int& hi, bool& none) {
  const int T = p.MP * p.P;
  const int pos = p.pos[b * p.pos_stride];
  lo = 0;
  hi = min(pos, T - 1);
  if (p.window > 0) lo = max(lo, pos - p.window + 1);
  none = lo > hi;
  if (none) {
    lo = 0;
    hi = T - 1;
  }
}

__device__ __forceinline__ void split_keys(const Args& p, int s, int lo, int hi, int& a, int& z) {
  const int K = p.ps * p.P;
  a = max(lo, s * K);
  z = min(hi, min((s + 1) * K, p.MP * p.P) - 1);
}

__device__ __forceinline__ Place place(const Args& p) {
  Place c;
  c.s = blockIdx.x;
  c.gc = blockIdx.y;
  c.b = blockIdx.z;
  const int rep = p.H / p.KV, chunks = rep / p.hpc;
  c.g = c.gc / chunks;
  c.h0 = c.g * rep + (c.gc % chunks) * p.hpc;
  live_range(p, c.b, c.lo, c.hi, c.all_masked);
  split_keys(p, c.s, c.lo, c.hi, c.a, c.z);
  return c;
}

// Row index of key t (of group g) in the pool, in rows of one head, from
// the split's pages staged in prow.
__device__ __forceinline__ size_t key_row(const Args& p, const int* prow, int s, int g, int t) {
  return ((size_t)prow[t / p.P - s * p.ps] * p.P + t % p.P) * p.KV + g;
}

// Where element e of a q row lives in shared memory. With 16-byte loads
// (W == 8) lane sl of a key's kSub lanes owns elements sl*8 .. sl*8+7 of
// every 64; their two halves are stored at sl*4 and 32 + sl*4 of that
// block of 64 floats, so the kSub lanes read 128 contiguous bytes per load
// and hit distinct banks. Rows are padded to a multiple of 64 then.
template <int W>
__device__ __forceinline__ int q_slot(int e) {
  if constexpr (W == 8) return (e & ~63) + ((e & 7) >> 2) * 32 + ((e & 63) >> 3) * 4 + (e & 3);
  return e;
}
template <int W>
__host__ __device__ __forceinline__ int q_stride(int d) {
  return W == 8 ? (d + 63) / 64 * 64 : d;
}

// q[i] . row for heads i < rc over this lane's share of the row (lane sl
// of kSub), fp32. Each lane keeps W partial sums per head, one per element
// of its chunks, and adds them as a tree, so no sum runs over more than
// d / (kSub * W) terms in a row; the kSub lanes are added as a tree too.
template <int W, typename KT>
__device__ __forceinline__ void dot_rows(const KT* row, const float* qs, int d, int rc, int sl,
                                         float (&out)[kRB]) {
  const int dq = q_stride<W>(d);
  float acc[kRB][W];
#pragma unroll
  for (int i = 0; i < kRB; ++i)
#pragma unroll
    for (int w = 0; w < W; ++w) acc[i][w] = 0.f;
  constexpr int kBatch = 4;  // chunks of the row in flight
  for (int c0 = sl * W; c0 < d; c0 += kBatch * kSub * W) {
    float kv[kBatch][W];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (c0 + u * kSub * W < d) load_w<W>(row + c0 + u * kSub * W, kv[u]);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * kSub * W;
      if (c < d) {
#pragma unroll
        for (int i = 0; i < kRB; ++i) {
          if (i < rc) {
            float qv[W];
            load_q<W>(qs + (size_t)i * dq, c, qv);
#pragma unroll
            for (int w = 0; w < W; ++w) acc[i][w] = fmaf(qv[w], kv[u][w], acc[i][w]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRB; ++i) {
#pragma unroll
    for (int h = W / 2; h > 0; h >>= 1)
#pragma unroll
      for (int w = 0; w < h; ++w) acc[i][w] += acc[i][w + h];
    out[i] = sub_sum(acc[i][0]);
  }
}

// Shared memory of the scores kernel, in 4-byte words: q and q2 of the
// CTA's heads (fp32, already rounded; rows padded as q_stride says), the
// split's scores and its pages.
template <int W>
size_t scores_smem(int hpc, int d, int d2, int keys, int pages) {
  return 4 * ((size_t)hpc * (q_stride<W>(d) + q_stride<W>(d2) + keys) + pages);
}
// ... of the PV kernel, in bytes: the offsets of the split's V rows, its
// probabilities, the global max and sum per head, every split's max and
// sum per head, and the last-CTA flag.
size_t pv_smem(int hpc, int keys, int splits) {
  return 8 * (size_t)keys + 4 * ((size_t)hpc * keys + 2 * (size_t)hpc + 2 * (size_t)splits * hpc + 1);
}

template <typename QT, typename KT, int W>
__global__ void __launch_bounds__(kThreads) paged_attn_scores_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  const int hpc = p.hpc, K = p.ps * p.P, T = p.MP * p.P;
  const int dq = q_stride<W>(p.D), dq2 = q_stride<W>(p.D2);
  float* qs = smem;
  float* q2s = qs + (size_t)hpc * dq;
  float* sc = q2s + (size_t)hpc * dq2;
  int* prow = reinterpret_cast<int*>(sc + (size_t)hpc * K);
  const Place c = place(p);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t stat = ((size_t)c.s * p.B + c.b) * p.H + c.h0;
  if (c.a > c.z) {
    for (int r = tid; r < hpc; r += kThreads) {
      p.mpart[stat + r] = -INFINITY;
      p.lpart[stat + r] = 0.f;
    }
    return;
  }
  const QT* q = static_cast<const QT*>(p.q);
  const QT* q2 = static_cast<const QT*>(p.q2);
  const KT* kp = static_cast<const KT*>(p.kp);
  const KT* k2p = static_cast<const KT*>(p.k2p);
  for (int e = tid; e < hpc * p.D; e += kThreads)
    qs[(e / p.D) * dq + q_slot<W>(e % p.D)] =
        round_as<KT>(to_f32(q[((size_t)c.b * p.H + c.h0) * p.D + e]));
  for (int e = tid; e < hpc * p.D2; e += kThreads)
    q2s[(e / p.D2) * dq2 + q_slot<W>(e % p.D2)] =
        round_as<KT>(to_f32(q2[((size_t)c.b * p.H + c.h0) * p.D2 + e]));
  const int page0 = c.s * p.ps;
  for (int e = tid; e < p.ps && page0 + e < p.MP; e += kThreads)
    prow[e] = p.table[(size_t)c.b * p.MP + page0 + e];
  __syncthreads();

  const int n = c.z - c.a + 1;
  const int sub = lane / kSub, sl = lane % kSub;
  for (int r0 = 0; r0 < hpc; r0 += kRB) {
    const int rc = min(kRB, hpc - r0);
    // the loop bounds are the same on every lane of a warp (shuffles)
    for (int tb = c.a + warp * kKeysPerWarp; tb <= c.z; tb += kWarps * kKeysPerWarp) {
      const int t = tb + sub;
      const bool ok = t <= c.z;
      float acc[kRB], acc2[kRB];
#pragma unroll
      for (int i = 0; i < kRB; ++i) acc[i] = acc2[i] = 0.f;
      // every lane of the warp takes part in the shuffles of dot_rows
      const size_t row = ok && !c.all_masked ? key_row(p, prow, c.s, c.g, t) : 0;
      const bool live = ok && !c.all_masked;
      dot_rows<W>(kp + row * p.D, qs + (size_t)r0 * dq, live ? p.D : 0, rc, sl, acc);
      if (p.D2 > 0) dot_rows<W>(k2p + row * p.D2, q2s + (size_t)r0 * dq2, live ? p.D2 : 0, rc, sl, acc2);
      if (ok && sl == 0) {
#pragma unroll
        for (int i = 0; i < kRB; ++i)
          if (i < rc)
            sc[(size_t)(r0 + i) * K + (t - c.a)] =
                c.all_masked ? -1e30f : (acc[i] + acc2[i]) * p.scale;
      }
    }
  }
  __syncthreads();

  // The split's max and sum of exp(s - max) per head, then the scores out.
  for (int r = warp; r < hpc; r += kWarps) {
    const float* sr = sc + (size_t)r * K;
    float m = -INFINITY;
    for (int t = lane; t < n; t += 32) m = fmaxf(m, sr[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < n; t += 32) l += expf(sr[t] - m);
    l = warp_sum(l);
    if (lane == 0) {
      p.mpart[stat + r] = m;
      p.lpart[stat + r] = l;
    }
  }
  float* ws = p.scores + ((size_t)c.b * p.H + c.h0) * T + c.a;
  for (int e = tid; e < hpc * n; e += kThreads) {
    const int r = e / n, t = e % n;
    ws[(size_t)r * T + t] = sc[(size_t)r * K + t];
  }
}

template <typename KT, int W>
__global__ void __launch_bounds__(kThreads) paged_attn_pv_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  const int hpc = p.hpc, K = p.ps * p.P, T = p.MP * p.P, S = gridDim.x;
  long long* rows = reinterpret_cast<long long*>(smem);  // element offset of each key's V row
  float* ps = reinterpret_cast<float*>(rows + K);
  float* mg = ps + (size_t)hpc * K;
  float* lg = mg + hpc;
  float* part = lg + hpc;  // (S, hpc, 2): each split's max and sum
  int* last = reinterpret_cast<int*>(part + 2 * (size_t)S * hpc);
  const Place c = place(p);
  const int tid = threadIdx.x;
  const KT* vp = static_cast<const KT*>(p.vp);
  const size_t bh = (size_t)c.b * p.H + c.h0;  // first (slot, head) row of the CTA
  const size_t sbh = (size_t)p.B * p.H;         // stride of one split in the partials

  const int n = c.z - c.a + 1;
  if (n > 0) {
    // The offsets of the split's V rows, and every split's (max, sum) of the
    // CTA's heads, loaded at once. Every CTA of the slot and group then
    // derives the same global max (exact in any order) and the same sum,
    // its terms added in split order.
    for (int t = tid; t < n; t += kThreads) {
      const int key = c.a + t;
      const int page = p.table[(size_t)c.b * p.MP + key / p.P];
      rows[t] = (((long long)page * p.P + key % p.P) * p.KV + c.g) * p.Dv;
    }
    for (int e = tid; e < S * hpc; e += kThreads) {
      const int s = e / hpc, r = e % hpc;
      part[2 * e] = p.mpart[s * sbh + bh + r];
      part[2 * e + 1] = p.lpart[s * sbh + bh + r];
    }
    __syncthreads();
    for (int r = tid; r < hpc; r += kThreads) {
      float m = -INFINITY;
#pragma unroll 8
      for (int s = 0; s < S; ++s) m = fmaxf(m, part[2 * (s * hpc + r)]);
      mg[r] = m;
    }
    __syncthreads();
    for (int e = tid; e < S * hpc; e += kThreads)
      part[2 * e + 1] *= expf(part[2 * e] - mg[e % hpc]);
    __syncthreads();
    for (int r = tid; r < hpc; r += kThreads) {
      float l = 0.f;
#pragma unroll 8
      for (int s = 0; s < S; ++s) l += part[2 * (s * hpc + r) + 1];
      lg[r] = l;
    }
    __syncthreads();
    for (int e = tid; e < hpc * n; e += kThreads) {
      const int r = e / n, t = e % n;
      const float s = p.scores[(bh + r) * T + c.a + t];
      ps[(size_t)r * K + t] = round_as<KT>(expf(s - mg[r]) / lg[r]);
    }
    __syncthreads();
    // Thread e owns W adjacent columns of one head and walks the keys in
    // order, the V rows of kBatch keys loaded before any is used.
    const int nch = p.Dv / W;
    float* op = p.opart + (c.s * sbh + bh) * p.Dv;
    constexpr int kBatch = 8;
    for (int e = tid; e < hpc * nch; e += kThreads) {
      const int r = e / nch, col = (e % nch) * W;
      const float* pr = ps + (size_t)r * K;
      float acc[W];
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] = 0.f;
      for (int t0 = 0; t0 < n; t0 += kBatch) {
        float v[kBatch][W];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (t0 + u < n) load_w<W>(vp + rows[t0 + u] + col, v[u]);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (t0 + u < n) {
            const float pt = pr[t0 + u];
#pragma unroll
            for (int w = 0; w < W; ++w) acc[w] = fmaf(pt, v[u][w], acc[w]);
          }
        }
      }
#pragma unroll
      for (int w = 0; w < W; ++w) op[(size_t)r * p.Dv + col + w] = acc[w];
    }
  }

  // The last CTA of the (slot, group) adds the partial outputs.
  __threadfence();
  __syncthreads();
  unsigned* cnt = p.count + (size_t)c.b * gridDim.y + c.gc;
  if (tid == 0) *last = atomicAdd(cnt, 1u) == (unsigned)(S - 1);
  __syncthreads();
  if (!*last) return;
  __threadfence();
  constexpr int CW = W == 8 ? 4 : 1;  // columns per load (Dv % 8 == 0 when W == 8)
  constexpr int kBatch = 8;           // splits loaded before any is added
  for (int e = tid * CW; e < hpc * p.Dv; e += kThreads * CW) {
    float acc[CW];
#pragma unroll
    for (int w = 0; w < CW; ++w) acc[w] = 0.f;
    for (int s0 = 0; s0 < S; s0 += kBatch) {
      float v[kBatch][CW];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        int a, z;
        split_keys(p, s0 + u, c.lo, c.hi, a, z);
        const bool use = s0 + u < S && a <= z;
        const float* src = p.opart + ((s0 + u) * sbh + bh) * p.Dv + e;
        if constexpr (CW == 4) {
          const float4 x = use ? __ldcg(reinterpret_cast<const float4*>(src))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          v[u][0] = x.x; v[u][1] = x.y; v[u][2] = x.z; v[u][3] = x.w;
        } else {
          v[u][0] = use ? __ldcg(src) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int w = 0; w < CW; ++w) acc[w] += v[u][w];
    }
#pragma unroll
    for (int w = 0; w < CW; ++w) p.out[bh * p.Dv + e + w] = acc[w];
  }
  if (tid == 0) *cnt = 0u;
}

template <typename QT, typename KT, int W>
cudaError_t launch(const Args& a, int splits, int groups, cudaStream_t stream) {
  const int keys = a.ps * a.P;
  const size_t s1 = scores_smem<W>(a.hpc, a.D, a.D2, keys, a.ps);
  const size_t s2 = pv_smem(a.hpc, keys, splits);
  if (s1 > kMaxSmem || s2 > kMaxSmem) return cudaErrorInvalidValue;
  auto k1 = paged_attn_scores_kernel<QT, KT, W>;
  auto k2 = paged_attn_pv_kernel<KT, W>;
  cudaError_t e;
  if (s1 > 48 * 1024 &&
      (e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(s1))) != cudaSuccess)
    return e;
  if (s2 > 48 * 1024 &&
      (e = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(s2))) != cudaSuccess)
    return e;
  dim3 grid(splits, groups, a.B);
  k1<<<grid, kThreads, s1, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  k2<<<grid, kThreads, s2, stream>>>(a);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t launch_w(const Args& a, int splits, int groups, int vec, cudaStream_t s) {
  return vec ? launch<QT, KT, 8>(a, splits, groups, s) : launch<QT, KT, 1>(a, splits, groups, s);
}

}  // namespace

// Launches the two kernels on `stream` without synchronising; returns the
// cudaError_t of the launches. q/q2 are fp32 (q_bf16 = 0) or bf16 (1), the
// pools likewise by kv_bf16; table and pos are int32; out is (batch, H, Dv)
// fp32. q2 and k2p are null when d2 == 0. The workspace holds scores
// (batch, H, mp * p), mpart and lpart (splits, batch, H) and opart
// (splits, batch, H, dv), all fp32; count is (batch, KV * rep / hpc) and
// zero. The caller guarantees H % KV == 0, hpc divides H / KV,
// splits == ceil(mp / ps), every table entry indexes a page of the pools,
// both kernels' shared memory fits in 232448 bytes, and, if vec, that d,
// dv and d2 are multiples of 8 and the pools 16-byte aligned.
extern "C" int paged_attn_launch(const void* q, const void* q2, const void* kp, const void* vp,
                                 const void* k2p, const void* table, const void* pos, void* out,
                                 void* scores, void* mpart, void* lpart, void* opart, void* count,
                                 int batch, int h, int kv, int d, int dv, int d2, int p, int mp,
                                 int pos_stride, int hpc, int ps, int splits, int window,
                                 float scale, int vec, int q_bf16, int kv_bf16, int device,
                                 void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  Args a{q,
         q2,
         kp,
         vp,
         k2p,
         static_cast<const int*>(table),
         static_cast<const int*>(pos),
         static_cast<float*>(out),
         static_cast<float*>(scores),
         static_cast<float*>(mpart),
         static_cast<float*>(lpart),
         static_cast<float*>(opart),
         static_cast<unsigned*>(count),
         batch,
         h,
         kv,
         d,
         dv,
         d2,
         p,
         mp,
         pos_stride,
         hpc,
         ps,
         window,
         scale};
  const int groups = kv * (h / kv / hpc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_bf16) {
    if (q_bf16) return launch_w<__nv_bfloat16, __nv_bfloat16>(a, splits, groups, vec, s);
    return launch_w<float, __nv_bfloat16>(a, splits, groups, vec, s);
  }
  if (q_bf16) return launch_w<__nv_bfloat16, float>(a, splits, groups, vec, s);
  return launch_w<float, float>(a, splits, groups, vec, s);
}

extern "C" const char* paged_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
