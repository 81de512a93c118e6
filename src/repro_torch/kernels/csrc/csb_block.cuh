// The CSB block-row body shared by kernel B1 (csb_mvm.cu) and kernel B3
// (csb_sharded.cu), so that both sum every output in the same order.
//
// One CTA takes one block-row i of a PaddedCSB and a tile of batch rows.
// Its warps are cut into groups of `gs` lanes (a power of two >= Pm, at
// most 32), one group per (block-column, batch row) item, so all blocks of
// the block-row load their indices, live values and gathered x at once. A
// block costs two dependent rounds of loads: m, n and col_idx; then the
// inputs x[col_idx] (gathered into shared memory), the first kPre live
// values of each lane's row and its row_idx. Lane k then computes kernel
// row k's dot product over the block's n live columns (fmaf in column
// order) and stores it at the block's output row row_idx[k] in a shared
// table part[t][j][r], which the group zeroes first (rows the block does
// not reach stay 0). After one barrier, thread (t, r) adds part[t][j][r]
// over j from left to right: the order of a serial walk of the
// block-columns, with no atomics. Block-rows wider than shared memory holds
// are cut into chunks of block-columns, two barriers per chunk.
#pragma once

#include <cuda_bf16.h>

#include <cstddef>

namespace csb {

constexpr int kPre = 16;  // live values of a lane's first row loaded with the gather

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// part[tr][chunk][bm] floats: per true batch row, block-column of the
// chunk and output row of the block-row, that block's dot product; then
// xs[threads / gs][pn] floats: each lane group's gathered x.
inline size_t smem_bytes(int bm, int pn, int tr, int chunk, int threads, int gs) {
  return sizeof(float) * ((size_t)tr * chunk * bm + (size_t)(threads / gs) * pn);
}

// The sum of thread (t, r) = (threadIdx.x / bm, threadIdx.x % bm) for block
// row i of the arrays and batch row t0 + t; meaningful where t < nt (the
// tile's true rows). x holds rows of `ldx` values; a block column at or
// past ldx reads as 0, as a batch padded with zero columns would. `part`
// is the CTA's dynamic shared memory (smem_bytes). Every thread of the CTA
// must call it.
template <typename TV, typename TX>
__device__ __forceinline__ float block_row(float* part, const TV* __restrict__ vals,
                                           const int* __restrict__ row_idx,
                                           const int* __restrict__ col_idx,
                                           const int* __restrict__ m, const int* __restrict__ n,
                                           const TX* __restrict__ x, int ldx, int i, int t0,
                                           int nt, int bc, int bm, int bn, int pm, int pn,
                                           int tr, int gs, int chunk) {
  float* xs = part + (size_t)tr * chunk * bm + (size_t)(threadIdx.x / gs) * pn;  // this group's x
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int per_warp = 32 / gs, sub = lane / gs, k0 = lane % gs;
  const int t_out = tid / bm, r_out = tid % bm;  // this thread's output
  float acc = 0.f;

  for (int j0 = 0; j0 < bc; j0 += chunk) {
    const int cn = min(chunk, bc - j0);
    const int items = cn * nt;
    if (j0 > 0) __syncthreads();  // the previous chunk's sums have been read
    // The loop bounds are the same on every lane of a warp (__syncwarp).
    for (int base = warp * per_warp; base < items; base += nwarps * per_warp) {
      const int it = base + sub;
      const bool ok = it < items;
      const int t = ok ? it / cn : 0, jj = ok ? it % cn : 0;
      float* pr = part + ((size_t)t * chunk + jj) * bm;
      if (ok)
        for (int e = k0; e < bm; e += gs) pr[e] = 0.f;
      __syncwarp();
      // Two dependent rounds of loads per block: m, n and col_idx; then x
      // at col_idx, the first kPre live values of row k0 and its row_idx.
      const size_t b = (size_t)i * bc + j0 + jj;
      const int mb = ok ? m[b] : 0, nb = ok ? n[b] : 0;
      const int c0 = (j0 + jj) * bn;  // the block's first input column
      const TX* xr = x + (size_t)(t0 + t) * ldx + c0;
#pragma unroll 4
      for (int l = k0; l < pn; l += gs) {
        const int c = ok ? col_idx[b * pn + l] : 0;
        if (l < nb) xs[l] = c0 + c < ldx ? to_f32(xr[c]) : 0.f;
      }
      const TV* vr0 = vals + (b * pm + k0) * pn;
      float v[kPre];
#pragma unroll
      for (int u = 0; u < kPre; ++u) v[u] = (k0 < mb && u < nb) ? to_f32(vr0[u]) : 0.f;
      const int r0 = k0 < mb ? row_idx[b * pm + k0] : 0;
      __syncwarp();
      for (int k = k0; k < mb; k += gs) {
        const TV* vr = vals + (b * pm + k) * pn;
        float s = 0.f;
        int l = 0;
        if (k == k0) {
#pragma unroll
          for (int u = 0; u < kPre; ++u)
            if (u < nb) s = fmaf(v[u], xs[u], s);
          l = kPre;
        }
#pragma unroll 8
        for (; l < nb; ++l) s = fmaf(to_f32(vr[l]), xs[l], s);
        pr[k == k0 ? r0 : row_idx[b * pm + k]] = s;
      }
      __syncwarp();
    }
    __syncthreads();
    if (t_out < nt)
      for (int jj = 0; jj < cn; ++jj) acc += part[((size_t)t_out * chunk + jj) * bm + r_out];
  }
  return acc;
}

}  // namespace csb
