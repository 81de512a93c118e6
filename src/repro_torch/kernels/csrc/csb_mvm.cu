// CSB matrix-vector product Y = X * W^T for a CSB-pruned W, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/csb_mvm.py::_kernel, the Pallas TPU kernel
// (the paper's CSB-Engine). W is held as a PaddedCSB: per block (i, j) of
// the (Br, Bc) grid a dense kernel vals[b, :Pm, :Pn] of which only the
// top-left m[b] x n[b] corner is live, row_idx[b, :m] naming the block's
// output rows and col_idx[b, :n] its input columns.
//
// What bounds it: bytes. Each live value is used once per batch row, so
// at the serving batch (1 to 16 rows) the work is a few FLOPs per byte,
// far below the card's ratio. The bytes the function needs are the m*n
// live values plus the m + n indices of every block, x and y. A naive
// kernel reads the padded Pm*Pn of every block instead: for the paper's
// SR1 model at 13x pruning that is about seven times the live bytes
// (24.0 MB against 3.6 MB per frame, as chip_smoke.py counts them). At
// these sizes the time is set by the chain of dependent loads each block
// needs (m and n, then vals, col_idx and row_idx, then the gathered x),
// so the design puts every block of a block-row in flight at once.
//
// The design:
//   * One CTA per (block-row, batch tile). Its warps are cut into groups
//     of `gs` lanes (a power of two >= Pm, at most 32), one group per
//     (block-column, batch row) item, so all blocks of the block-row load
//     their indices, live values and gathered x concurrently. A block costs
//     two dependent rounds of loads: m, n and col_idx; then the inputs
//     x[col_idx] (gathered into shared memory), the first 16 live values
//     of each lane's row and its row_idx. Then lane k
//     computes kernel row k's dot product over the block's n live
//     columns (fma in column order) and stores it at the block's output
//     row row_idx[k] in a shared-memory table part[t][j][r], which the
//     group zeroes first (rows the block does not reach stay 0).
//   * The TPU kernel turned the gather by col_idx and the scatter by
//     row_idx into one-hot matmuls, because VMEM has no cheap random
//     access. Here the gather is an indexed load of x and the scatter an
//     indexed store to shared memory.
//   * After one barrier, thread (t, r) adds part[t][j][r] over j from left
//     to right: the same order as a serial walk of the block-columns
//     (lanes in order within a block, blocks left to right), with no
//     atomics. Block-rows wider than shared memory holds are cut into
//     chunks of block-columns, two barriers per chunk, never per block.
//   * Only the true batch rows are computed; the pad rows of the tile are
//     written as zeros, which is what they are.
// Making it faster still (splitting a block-row over CTAs, fusing a cell's
// MVMs into one launch) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kPre = 16;  // live values of a lane's first row loaded with the gather

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// part[tr][chunk][bm] floats: per true batch row, block-column of the
// chunk and output row of the block-row, that block's dot product; then
// xs[threads / gs][pn] floats: each lane group's gathered x.
size_t smem_bytes(int bm, int pn, int tr, int chunk, int threads, int gs) {
  return sizeof(float) * ((size_t)tr * chunk * bm + (size_t)(threads / gs) * pn);
}

template <typename TV, typename TX>
__global__ void __launch_bounds__(1024)
    csb_mvm_kernel(const TV* __restrict__ vals, const int* __restrict__ row_idx,
                   const int* __restrict__ col_idx, const int* __restrict__ m,
                   const int* __restrict__ n, const TX* __restrict__ x, float* __restrict__ out,
                   int rows, int bc, int bm, int bn, int pm, int pn, int tb, int tr, int gs,
                   int chunk) {
  extern __shared__ float part[];
  float* xs = part + (size_t)tr * chunk * bm + (size_t)(threadIdx.x / gs) * pn;  // this group's x
  const int i = blockIdx.x;        // block-row
  const int t0 = blockIdx.y * tb;  // first batch row of the tile
  const int nt = max(0, min(tb, rows - t0));  // true rows of the tile (<= tr)
  const size_t ldx = (size_t)bc * bn;
  const size_t ldo = (size_t)gridDim.x * bm;
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
      const TX* xr = x + (t0 + t) * ldx + (size_t)(j0 + jj) * bn;
#pragma unroll 4
      for (int l = k0; l < pn; l += gs) {
        const int c = ok ? col_idx[b * pn + l] : 0;
        if (l < nb) xs[l] = to_f32(xr[c]);
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
  if (t_out < tb) out[(t0 + t_out) * ldo + (size_t)i * bm + r_out] = t_out < nt ? acc : 0.f;
}

template <typename TV, typename TX>
cudaError_t launch(const void* vals, const void* row_idx, const void* col_idx, const void* m,
                   const void* n, const void* x, void* out, int batch, int rows, int br, int bc,
                   int bm, int bn, int pm, int pn, int tb, int threads, int gs, int chunk,
                   cudaStream_t stream) {
  const int tr = min(tb, rows);
  const size_t smem = smem_bytes(bm, pn, tr, chunk, threads, gs);
  auto kernel = csb_mvm_kernel<TV, TX>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(br, batch / tb);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const TV*>(vals), static_cast<const int*>(row_idx),
      static_cast<const int*>(col_idx), static_cast<const int*>(m),
      static_cast<const int*>(n), static_cast<const TX*>(x), static_cast<float*>(out), rows, bc,
      bm, bn, pm, pn, tb, tr, gs, chunk);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` without synchronising; returns the cudaError_t of
// the launch. vals and x are fp32 (0) or bf16 (1) as the flags say; the
// indices are int32; out is (batch, br * bm) fp32, of which the first
// `rows` rows are computed and the rest written as zeros. The caller
// (kernels/csb_mvm.py::launch_config) guarantees batch % tb == 0,
// 1 <= rows <= batch, tb * bm <= threads <= 1024 with threads a multiple of
// 32, gs a power of two <= 32, and smem_bytes(bm, pn, min(tb, rows),
// chunk, threads, gs) within 232448.
extern "C" int csb_mvm_launch(const void* vals, const void* row_idx, const void* col_idx,
                              const void* m, const void* n, const void* x, void* out, int batch,
                              int rows, int br, int bc, int bm, int bn, int pm, int pn, int tb,
                              int threads, int gs, int chunk, int vals_bf16, int x_bf16,
                              int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals_bf16) {
    if (x_bf16)
      return launch<__nv_bfloat16, __nv_bfloat16>(vals, row_idx, col_idx, m, n, x, out, batch,
                                                  rows, br, bc, bm, bn, pm, pn, tb, threads, gs,
                                                  chunk, s);
    return launch<__nv_bfloat16, float>(vals, row_idx, col_idx, m, n, x, out, batch, rows, br,
                                        bc, bm, bn, pm, pn, tb, threads, gs, chunk, s);
  }
  if (x_bf16)
    return launch<float, __nv_bfloat16>(vals, row_idx, col_idx, m, n, x, out, batch, rows, br,
                                        bc, bm, bn, pm, pn, tb, threads, gs, chunk, s);
  return launch<float, float>(vals, row_idx, col_idx, m, n, x, out, batch, rows, br, bc, bm, bn,
                              pm, pn, tb, threads, gs, chunk, s);
}

extern "C" const char* csb_mvm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
