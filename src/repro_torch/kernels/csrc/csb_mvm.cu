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
// (24.0 MB against 3.6 MB per frame, as chip_smoke.py counts them).
//
// The design:
//   * Only live lanes are read: a block's staging loop runs over its
//     m*n values and n columns, never over the pad.
//   * The TPU kernel turned the gather by col_idx and the scatter by
//     row_idx into one-hot matmuls, because VMEM has no cheap random
//     access. Shared memory has, so here the gather is an indexed load
//     of x and the scatter an inverse row map in shared memory.
//   * One CTA per (block-row, batch tile); the TPU's sequential grid
//     axis over block-columns is a loop inside the CTA. Each thread owns
//     one output element (t, r) and keeps its sum in a register across
//     the loop, so no atomics are needed, the summation order is fixed
//     (blocks left to right, lanes in order) and y is stored once.
//   * `group` blocks are staged per pass between barriers.
// Making it fast (filling 132 SMs at batch 1, skipping the idle threads
// of dead rows, TMA/wgmma, fusing a cell's MVMs) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Shared memory of one pass, for G = group staged blocks:
//   kv  [G][Pm][Pn + 1] float  live kernel values (row stride padded by one
//                              so that threads reading different rows of
//                              the same lane hit different banks)
//   xg  [G][TB][Pn]     float  x gathered by col_idx
//   inv [G][bm]         int    output row r -> kernel row k, or -1
size_t smem_bytes(int pm, int pn, int bm, int tb, int group) {
  return sizeof(float) * ((size_t)group * pm * (pn + 1) + (size_t)group * tb * pn) +
         sizeof(int) * (size_t)group * bm;
}

template <typename TV, typename TX>
__global__ void csb_mvm_kernel(const TV* __restrict__ vals, const int* __restrict__ row_idx,
                               const int* __restrict__ col_idx, const int* __restrict__ m,
                               const int* __restrict__ n, const TX* __restrict__ x,
                               float* __restrict__ out, int bc, int bm, int bn, int pm, int pn,
                               int tb, int group) {
  extern __shared__ float smem[];
  const int ks = pn + 1;
  float* kv = smem;
  float* xg = kv + (size_t)group * pm * ks;
  int* inv = reinterpret_cast<int*>(xg + (size_t)group * tb * pn);

  const int i = blockIdx.x;        // block-row
  const int t0 = blockIdx.y * tb;  // first batch row of the tile
  const size_t ldx = (size_t)bc * bn;
  const size_t ldo = (size_t)gridDim.x * bm;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // == tb * bm
  const int t = tid / bm;           // this thread's output: batch row t0 + t,
  const int r = tid % bm;           //   column i * bm + r
  float acc = 0.f;

  for (int j0 = 0; j0 < bc; j0 += group) {
    __syncthreads();  // the previous pass has finished reading kv, xg, inv
    for (int g = 0; g < group; ++g) {
      const size_t b = (size_t)i * bc + j0 + g;
      const int mb = m[b], nb = n[b];
      for (int e = tid; e < bm; e += nthreads) inv[g * bm + e] = -1;
      for (int e = tid; e < mb * nb; e += nthreads) {
        const int k = e / nb, l = e % nb;
        kv[((size_t)g * pm + k) * ks + l] = to_f32(vals[(b * pm + k) * pn + l]);
      }
      for (int e = tid; e < tb * nb; e += nthreads) {
        const int tt = e / nb, l = e % nb;
        xg[((size_t)g * tb + tt) * pn + l] =
            to_f32(x[(t0 + tt) * ldx + (size_t)(j0 + g) * bn + col_idx[b * pn + l]]);
      }
    }
    __syncthreads();
    // Within one block the live row_idx are distinct, so each output row
    // has at most one kernel row.
    for (int g = 0; g < group; ++g) {
      const size_t b = (size_t)i * bc + j0 + g;
      for (int k = tid; k < m[b]; k += nthreads) inv[g * bm + row_idx[b * pm + k]] = k;
    }
    __syncthreads();
    for (int g = 0; g < group; ++g) {
      const int k = inv[g * bm + r];
      if (k >= 0) {
        const int nb = n[(size_t)i * bc + j0 + g];
        const float* kr = kv + ((size_t)g * pm + k) * ks;
        const float* xr = xg + ((size_t)g * tb + t) * pn;
        float s = 0.f;
        for (int l = 0; l < nb; ++l) s = fmaf(kr[l], xr[l], s);
        acc += s;
      }
    }
  }
  out[(t0 + t) * ldo + (size_t)i * bm + r] = acc;
}

template <typename TV, typename TX>
cudaError_t launch(const void* vals, const void* row_idx, const void* col_idx, const void* m,
                   const void* n, const void* x, void* out, int batch, int br, int bc, int bm,
                   int bn, int pm, int pn, int tb, int group, cudaStream_t stream) {
  const size_t smem = smem_bytes(pm, pn, bm, tb, group);
  auto kernel = csb_mvm_kernel<TV, TX>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(br, batch / tb);
  kernel<<<grid, tb * bm, smem, stream>>>(
      static_cast<const TV*>(vals), static_cast<const int*>(row_idx),
      static_cast<const int*>(col_idx), static_cast<const int*>(m),
      static_cast<const int*>(n), static_cast<const TX*>(x), static_cast<float*>(out), bc, bm,
      bn, pm, pn, tb, group);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` without synchronising; returns the cudaError_t of
// the launch. vals and x are fp32 (0) or bf16 (1) as the flags say; the
// indices are int32; out is (batch, br * bm) fp32. The caller guarantees
// batch % tb == 0, bc % group == 0 and tb * bm <= 1024.
extern "C" int csb_mvm_launch(const void* vals, const void* row_idx, const void* col_idx,
                              const void* m, const void* n, const void* x, void* out, int batch,
                              int br, int bc, int bm, int bn, int pm, int pn, int tb, int group,
                              int vals_bf16, int x_bf16, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals_bf16) {
    if (x_bf16)
      return launch<__nv_bfloat16, __nv_bfloat16>(vals, row_idx, col_idx, m, n, x, out, batch, br,
                                                  bc, bm, bn, pm, pn, tb, group, s);
    return launch<__nv_bfloat16, float>(vals, row_idx, col_idx, m, n, x, out, batch, br, bc, bm,
                                        bn, pm, pn, tb, group, s);
  }
  if (x_bf16)
    return launch<float, __nv_bfloat16>(vals, row_idx, col_idx, m, n, x, out, batch, br, bc, bm,
                                        bn, pm, pn, tb, group, s);
  return launch<float, float>(vals, row_idx, col_idx, m, n, x, out, batch, br, bc, bm, bn, pm, pn,
                              tb, group, s);
}

extern "C" const char* csb_mvm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
