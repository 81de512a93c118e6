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
// the table and the output. A kernel that gathers every page of the table,
// as the TPU kernel does into VMEM, reads max_pages * P rows per slot
// instead.
//
// The design:
//   * One CTA per (slot, KV group, chunk of heads); the chunk is the whole
//     group unless its scores do not fit in shared memory. The CTA walks the
//     slot's page-table row itself (staged in shared memory) and touches
//     only keys inside the mask: a masked score is -1e30, whose exp is
//     exactly 0 in fp32, so skipping it changes no sum. If the mask leaves
//     no key at all, every key is scored -1e30 and the softmax is uniform,
//     as in the reference.
//   * Two passes, not an online softmax: the reference rounds the
//     normalised probabilities to the pool's type before the PV product,
//     which needs the final max and sum first. Pass 1 scores every live key
//     (one warp per key, lanes across D, a warp-shuffle sum) into shared
//     memory and takes the max; the sum follows from the stored scores.
//     Pass 2 turns the scores into rounded probabilities in place and
//     accumulates p * v in fp32, one thread per output column, keys in
//     order (no atomics; the summation order is fixed).
//   * When the scores of the chunk's heads for every key exceed shared
//     memory (very long caches), the host picks a tile of keys instead: the
//     CTA then rescores each tile in pass 2 and keeps its partial sums in
//     the output, which only the owning thread touches.
// One CTA per slot and group fills few of the 132 SMs at decode batch
// sizes (gemma-2b: KV = 1); splitting keys over CTAs is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRB = 8;  // heads a warp scores per pass over a key
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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
  int H, KV, D, Dv, D2, P, MP, pos_stride;
  int hpc;            // query heads per CTA (divides rep)
  int tile;           // score columns per head in shared memory
  int window;         // <= 0: none
  float scale;
};

// Shared memory, in 4-byte words: q and q2 of the chunk's heads (fp32,
// already rounded), the score tile, the cross-warp reduction buffer, the
// max and sum per head, and the slot's page-table row.
size_t smem_bytes(int hpc, int d, int d2, int tile, int mp) {
  return 4 * ((size_t)hpc * (d + d2 + tile) + (size_t)kWarps * hpc + 2 * (size_t)hpc + mp);
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) paged_attn_kernel(Args a) {
  extern __shared__ float smem[];
  const int hpc = a.hpc;
  float* qs = smem;
  float* q2s = qs + (size_t)hpc * a.D;
  float* sc = q2s + (size_t)hpc * a.D2;
  float* red = sc + (size_t)hpc * a.tile;
  float* mstat = red + (size_t)kWarps * hpc;
  float* lstat = mstat + hpc;
  int* prow = reinterpret_cast<int*>(lstat + hpc);

  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = a.H / a.KV;
  const int h0 = g * rep + blockIdx.x * hpc;  // first query head of the CTA
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool rope = a.D2 > 0;
  const QT* q = static_cast<const QT*>(a.q);
  const QT* q2 = static_cast<const QT*>(a.q2);
  const KT* kp = static_cast<const KT*>(a.kp);
  const KT* vp = static_cast<const KT*>(a.vp);
  const KT* k2p = static_cast<const KT*>(a.k2p);

  for (int e = tid; e < hpc * a.D; e += kThreads)
    qs[e] = round_as<KT>(to_f32(q[((size_t)b * a.H + h0) * a.D + e]));
  for (int e = tid; e < hpc * a.D2; e += kThreads)
    q2s[e] = round_as<KT>(to_f32(q2[((size_t)b * a.H + h0) * a.D2 + e]));
  for (int e = tid; e < a.MP; e += kThreads) prow[e] = a.table[(size_t)b * a.MP + e];

  // The live keys are lo..hi; everything else is masked.
  const int T = a.MP * a.P;
  const int pos = a.pos[b * a.pos_stride];
  int lo = 0, hi = min(pos, T - 1);
  if (a.window > 0) lo = max(lo, pos - a.window + 1);
  const bool all_masked = lo > hi;
  if (all_masked) {
    lo = 0;
    hi = T - 1;
  }
  const int n = hi - lo + 1;
  const bool store = n <= a.tile;
  __syncthreads();

  // Row index of key t (of group g) in the pool, in rows of one head.
  auto key_row = [&](int t) -> size_t {
    return ((size_t)prow[t / a.P] * a.P + t % a.P) * a.KV + g;
  };
  // Scaled scores of key t for heads r0 .. r0+rc-1 (rc <= kRB), on every lane.
  auto score = [&](int t, int r0, int rc, float* s) {
    if (all_masked) {
#pragma unroll
      for (int i = 0; i < kRB; ++i) s[i] = -1e30f;
      return;
    }
    const size_t row = key_row(t);
    float acc[kRB], acc2[kRB];
#pragma unroll
    for (int i = 0; i < kRB; ++i) acc[i] = acc2[i] = 0.f;
    const KT* kr = kp + row * a.D;
    for (int j = lane; j < a.D; j += 32) {
      const float kv = to_f32(kr[j]);
#pragma unroll
      for (int i = 0; i < kRB; ++i)
        if (i < rc) acc[i] = fmaf(qs[(r0 + i) * a.D + j], kv, acc[i]);
    }
    if (rope) {
      const KT* k2r = k2p + row * a.D2;
      for (int j = lane; j < a.D2; j += 32) {
        const float kv = to_f32(k2r[j]);
#pragma unroll
        for (int i = 0; i < kRB; ++i)
          if (i < rc) acc2[i] = fmaf(q2s[(r0 + i) * a.D2 + j], kv, acc2[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRB; ++i) {
      if (i < rc) {
        float v = warp_sum(acc[i]);
        if (rope) v += warp_sum(acc2[i]);
        s[i] = v * a.scale;
      }
    }
  };

  // Pass 1: scores (kept when they fit) and their max per head.
  for (int r0 = 0; r0 < hpc; r0 += kRB) {
    const int rc = min(kRB, hpc - r0);
    float mx[kRB];
#pragma unroll
    for (int i = 0; i < kRB; ++i) mx[i] = -3.0e38f;
    for (int t = lo + warp; t <= hi; t += kWarps) {
      float s[kRB];
      score(t, r0, rc, s);
#pragma unroll
      for (int i = 0; i < kRB; ++i) {
        if (i < rc) {
          mx[i] = fmaxf(mx[i], s[i]);
          if (store && lane == 0) sc[(size_t)(r0 + i) * a.tile + (t - lo)] = s[i];
        }
      }
    }
    if (lane == 0)
      for (int i = 0; i < rc; ++i) red[warp * hpc + r0 + i] = mx[i];
  }
  __syncthreads();
  for (int r = tid; r < hpc; r += kThreads) {
    float m = red[r];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w * hpc + r]);
    mstat[r] = m;
  }
  __syncthreads();

  // The sum of exp(s - max) per head.
  if (store) {
    for (int r = warp; r < hpc; r += kWarps) {
      const float m = mstat[r];
      float l = 0.f;
      for (int t = lane; t < n; t += 32) l += expf(sc[(size_t)r * a.tile + t] - m);
      l = warp_sum(l);
      if (lane == 0) lstat[r] = l;
    }
  } else {
    for (int r0 = 0; r0 < hpc; r0 += kRB) {
      const int rc = min(kRB, hpc - r0);
      float ls[kRB];
#pragma unroll
      for (int i = 0; i < kRB; ++i) ls[i] = 0.f;
      for (int t = lo + warp; t <= hi; t += kWarps) {
        float s[kRB];
        score(t, r0, rc, s);
#pragma unroll
        for (int i = 0; i < kRB; ++i)
          if (i < rc) ls[i] += expf(s[i] - mstat[r0 + i]);
      }
      if (lane == 0)
        for (int i = 0; i < rc; ++i) red[warp * hpc + r0 + i] = ls[i];
    }
    __syncthreads();
    for (int r = tid; r < hpc; r += kThreads) {
      float l = 0.f;
      for (int w = 0; w < kWarps; ++w) l += red[w * hpc + r];
      lstat[r] = l;
    }
  }
  __syncthreads();

  // Pass 2: rounded probabilities times V, tile by tile (one tile when the
  // scores were kept).
  float* out = a.out + ((size_t)b * a.H + h0) * a.Dv;
  for (int t0 = lo; t0 <= hi; t0 += a.tile) {
    const int tn = min(a.tile, hi - t0 + 1);
    if (!store) {
      for (int r0 = 0; r0 < hpc; r0 += kRB) {
        const int rc = min(kRB, hpc - r0);
        for (int t = t0 + warp; t < t0 + tn; t += kWarps) {
          float s[kRB];
          score(t, r0, rc, s);
          if (lane == 0)
            for (int i = 0; i < rc; ++i) sc[(size_t)(r0 + i) * a.tile + (t - t0)] = s[i];
        }
      }
      __syncthreads();
    }
    for (int e = tid; e < hpc * tn; e += kThreads) {
      const int r = e / tn, t = e % tn;
      float* p = sc + (size_t)r * a.tile + t;
      *p = round_as<KT>(expf(*p - mstat[r]) / lstat[r]);
    }
    __syncthreads();
    for (int c = tid; c < a.Dv; c += kThreads) {
      for (int r0 = 0; r0 < hpc; r0 += kRB) {
        const int rc = min(kRB, hpc - r0);
        float acc[kRB];
#pragma unroll
        for (int i = 0; i < kRB; ++i)
          acc[i] = (t0 == lo || i >= rc) ? 0.f : out[(size_t)(r0 + i) * a.Dv + c];
        for (int t = 0; t < tn; ++t) {
          const float v = to_f32(vp[key_row(t0 + t) * a.Dv + c]);
#pragma unroll
          for (int i = 0; i < kRB; ++i)
            if (i < rc) acc[i] = fmaf(sc[(size_t)(r0 + i) * a.tile + t], v, acc[i]);
        }
        for (int i = 0; i < rc; ++i) out[(size_t)(r0 + i) * a.Dv + c] = acc[i];
      }
    }
    __syncthreads();
  }
}

template <typename QT, typename KT>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.hpc, a.D, a.D2, a.tile, a.MP);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = paged_attn_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(a.H / a.KV / a.hpc, a.KV, batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` without synchronising; returns the cudaError_t of the
// launch. q/q2 are fp32 (q_bf16 = 0) or bf16 (1), the pools likewise by
// kv_bf16; table and pos are int32; out is (batch, H, Dv) fp32. q2 and k2p
// are null when d2 == 0. The caller guarantees H % KV == 0, hpc divides
// H / KV, every table entry indexes a page of the pools, and
// smem_bytes(hpc, d, d2, tile, mp) <= 232448.
extern "C" int paged_attn_launch(const void* q, const void* q2, const void* kp, const void* vp,
                                 const void* k2p, const void* table, const void* pos, void* out,
                                 int batch, int h, int kv, int d, int dv, int d2, int p, int mp,
                                 int pos_stride, int hpc, int tile, int window, float scale,
                                 int q_bf16, int kv_bf16, int device, void* stream) {
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
         h,
         kv,
         d,
         dv,
         d2,
         p,
         mp,
         pos_stride,
         hpc,
         tile,
         window,
         scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_bf16) {
    if (q_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(a, batch, s);
    return launch<float, __nv_bfloat16>(a, batch, s);
  }
  if (q_bf16) return launch<__nv_bfloat16, float>(a, batch, s);
  return launch<float, float>(a, batch, s);
}

extern "C" const char* paged_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
