// CSB matrix-vector product Y = X * W^T for a CSB-pruned W, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/csb_mvm.py::_kernel, the Pallas TPU kernel
// (the paper's CSB-Engine). W is held as a PaddedCSB: per block (i, j) of
// the (Br, Bc) grid a dense kernel vals[b, :Pm, :Pn] of which only the
// top-left m[b] x n[b] corner is live, row_idx[b, :m] naming the block's
// output rows and col_idx[b, :n] its input columns. The TPU kernel turned
// the gather by col_idx and the scatter by row_idx into one-hot matmuls,
// because VMEM has no cheap random access; here both are indexed accesses
// to shared memory. The kernel has two bodies, which the wrapper
// (kernels/csb_mvm.py) chooses by the call's true batch rows (`rows`): the
// row body below TILED_MIN_ROWS, the batch-tiled body at and above it.
//
// The row body (csb_mvm_kernel; its block-row code is csb_block.cuh, which
// kernel B3 runs too). What bounds it at 1 to 16 rows: latency. Each live
// value is used once per batch row, a few FLOPs per byte, and the time is
// set by the chain of dependent loads each block needs (m and n, then
// vals, col_idx and row_idx, then the gathered x), so it puts every block
// of a block-row in flight at once:
//   * One CTA per (block-row, batch tile of 8 rows). Its warps are cut into
//     groups of `gs` lanes (a power of two >= Pm, at most 32), one group
//     per (block-column, batch row) item. A block costs two dependent
//     rounds of loads: m, n and col_idx; then x[col_idx] (gathered into
//     shared memory), the first 16 live values of each lane's row and its
//     row_idx. Lane k computes kernel row k's dot product over the block's
//     n live columns (fma in column order) and stores it at the block's
//     output row row_idx[k] in a shared table part[t][j][r], which the
//     group zeroes first (rows the block does not reach stay 0).
//   * After one barrier, thread (t, r) adds part[t][j][r] over j from left
//     to right: the same order as a serial walk of the block-columns, with
//     no atomics. Block-rows wider than shared memory holds are cut into
//     chunks of block-columns, two barriers per chunk, never per block.
//   * Only the true batch rows are computed; the pad rows of the tile are
//     written as zeros, which is what they are.
// At the serving batch (hundreds to thousands of stream rows) that body is
// bound by reloads and idle lanes: every (block, batch row) item loads its
// block again, so each live value is read once per row, and a group is
// Pm lanes wide (32 for a matrix with one dense block) while the mean live
// m of a pruned block is 4 to 7, so most lanes idle. Its time grows with
// the batch, not with the live weights.
//
// The batch-tiled body (csb_mvm_kernel_tiled) reads each live value once
// per tile of 32 stream rows and keeps every lane on a row:
//   * One CTA per (group of `warps` block-rows, tile of 32 batch rows);
//     warp w takes block-row i0 + w and lane t batch row t0 + t, so a
//     warp's branches are uniform and its lanes all work.
//   * The CTA stages the tile's x for a pass over the block-columns into
//     shared memory once, for all its block-rows, column-major (x[c][t]),
//     so that the lanes' reads of one column hit 32 banks: lane t loads
//     16-byte pieces of its row, several before it stores any.
//   * Each warp walks its block-row's blocks left to right. The loads of a
//     block's live m x n corner (rows of n values at stride Pn, neighbouring
//     lanes on neighbouring values), its row_idx and its col_idx go out
//     into registers before the warp computes the block before it, and into
//     the warp's stage after. Lane t gathers x at the block's live columns
//     into registers, then, four live rows at a time, runs an fmaf chain
//     over the columns with the values broadcast from the stage, and adds
//     each row's sum into its shared accumulator acc[row_idx[k]][t].
//   * The sums are those of the row body: each block's sum is an fmaf chain
//     over its live columns in column order starting at 0, and the block
//     sums enter the output's accumulator (from 0) in block-column order.
//     The row body also adds +0.0 for blocks that miss a row, which leaves
//     a sum that is never -0.0 unchanged, so the two bodies give equal
//     numbers.
//   * fp32 FFMA on the CUDA cores; no tensor cores.
// What bounds it: the latency of each warp's walk. A block costs a warp
// about 1.5 us on an H100 whether it holds one live value or sixteen (the
// chain of its staging, the gather, the rows' fmaf chains and the
// accumulator's read and write), and a warp walks its block-row's blocks
// one after another; the card holds about 8 such warps an SM at the
// serving batch. Work per block grows only where blocks are dense.
// It is chosen by `rows` because the row body puts every block in flight
// at once and is the faster below 64 to 96 rows (where a warp of the tiled
// body still walks the whole block-row for few rows), the tiled body from
// the crossover measured on the card (PERF.md). Making it faster still
// (staging several blocks a round trip, splitting a block-row's walk
// over warps, fusing a cell's MVMs into one launch, CUDA graphs to take
// the host off the path) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "csb_block.cuh"

namespace {

template <typename TV, typename TX>
__global__ void __launch_bounds__(1024)
    csb_mvm_kernel(const TV* __restrict__ vals, const int* __restrict__ row_idx,
                   const int* __restrict__ col_idx, const int* __restrict__ m,
                   const int* __restrict__ n, const TX* __restrict__ x, float* __restrict__ out,
                   int rows, int bc, int bm, int bn, int pm, int pn, int tb, int tr, int gs,
                   int chunk) {
  extern __shared__ float part[];
  const int i = blockIdx.x;        // block-row
  const int t0 = blockIdx.y * tb;  // first batch row of the tile
  const int nt = max(0, min(tb, rows - t0));  // true rows of the tile (<= tr)
  const size_t ldo = (size_t)gridDim.x * bm;
  const float acc = csb::block_row<TV, TX>(part, vals, row_idx, col_idx, m, n, x, bc * bn, i,
                                           t0, nt, bc, bm, bn, pm, pn, tr, gs, chunk);
  const int t_out = threadIdx.x / bm, r_out = threadIdx.x % bm;  // this thread's output
  if (t_out < tb) out[(t0 + t_out) * ldo + (size_t)i * bm + r_out] = t_out < nt ? acc : 0.f;
}

template <typename TV, typename TX>
cudaError_t launch(const void* vals, const void* row_idx, const void* col_idx, const void* m,
                   const void* n, const void* x, void* out, int batch, int rows, int br, int bc,
                   int bm, int bn, int pm, int pn, int tb, int threads, int gs, int chunk,
                   cudaStream_t stream) {
  const int tr = min(tb, rows);
  const size_t smem = csb::smem_bytes(bm, pn, tr, chunk, threads, gs);
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

namespace csb_mvm_tiled {

constexpr int kRows = 32;              // batch rows of a tile: one a lane
constexpr int kAccStride = kRows + 1;  // an accumulator row, padded off the banks
constexpr int kMaxWarps = 8;           // block-rows of a CTA
constexpr int kCols = 32;              // live columns of a block held in registers
constexpr int kAhead = 16;             // live values a lane loads a block ahead
constexpr int kBatch = 8;              // 16-byte pieces of x a lane loads before storing

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// Shared memory, in 4-byte words, each part 16-byte aligned: x for a pass,
// column-major (chunk * bn columns of kRows rows, so that the lanes' reads
// of one column hit 32 banks); the pass's m and n of every warp's blocks;
// then per warp its accumulators acc[bm][kRows] (padded) and a stage: a
// block's live values vt[round4(Pm)][round4(min(Pn, kCols))] (rows of n
// values at a stride of round4(n)), its row_idx and its col_idx.
__host__ __device__ constexpr int stage_cols(int pn) { return round4(pn < kCols ? pn : kCols); }
__host__ __device__ constexpr int stage_words(int pm, int pn) {
  return round4(pm) * stage_cols(pn) + round4(pm) + stage_cols(pn);
}
__host__ __device__ constexpr int warp_words(int bm, int pm, int pn) {
  return round4(bm * kAccStride) + stage_words(pm, pn);
}
inline size_t smem_bytes(int bm, int bn, int pm, int pn, int warps, int chunk) {
  return 4 * ((size_t)kRows * chunk * bn + round4(2 * warps * chunk) +
              (size_t)warps * warp_words(bm, pm, pn));
}

// Stages the tile's x for one pass, cw inputs of each row at `ldx` from
// `x` (its first row), the first `nt` rows true and the rest zeros, into
// xs[c][t]: lane t takes row t, warp w every warps-th 16-byte piece (or
// value, where the rows do not allow pieces), kBatch loads before any store.
template <typename TX>
__device__ __forceinline__ void stage_x(float* xs, const TX* __restrict__ x, size_t ldx, int cw,
                                        int nt, int warps, int w, int lane) {
  constexpr int K = 16 / sizeof(TX);  // values a piece
  const bool vec = cw % K == 0 && ldx % K == 0 && (reinterpret_cast<size_t>(x) & 15) == 0;
  const bool live = lane < nt;
  const TX* row = x + lane * ldx;
  float* col = xs + lane;
  if (!vec) {
    for (int c = w; c < cw; c += warps) col[c * kRows] = live ? csb::to_f32(row[c]) : 0.f;
    return;
  }
  for (int q0 = w; q0 < cw / K; q0 += kBatch * warps) {
    uint4 raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = q0 + u * warps;
      if (live && q < cw / K) raw[u] = __ldg(reinterpret_cast<const uint4*>(row + q * K));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = q0 + u * warps;
      const TX* v = reinterpret_cast<const TX*>(&raw[u]);
      if (q < cw / K)
#pragma unroll
        for (int e = 0; e < K; ++e) col[(q * K + e) * kRows] = live ? csb::to_f32(v[e]) : 0.f;
    }
  }
}

// A block of at most kCols live columns on its way into a warp's stage:
// load() issues its loads into registers, store() writes them to the stage
// once the warp has computed the block before it. A row's n values go to
// a group of lanes (a power of two >= max(n, 4)), neighbouring lanes on
// neighbouring values; the stage's rows are round4(n) wide, their pad
// zeros. The first kAhead rows of a lane's column travel in registers, the
// rest are copied by store() itself.
struct Ahead {
  float v[kAhead];
  int r, c;  // row_idx[lane], col_idx[lane]
};

__device__ __forceinline__ int lanes_log2(int nb) {
  return max(2, nb > 1 ? 32 - __clz(nb - 1) : 0);
}

template <typename TV>
__device__ __forceinline__ void load(Ahead& a, const TV* __restrict__ vals,
                                     const int* __restrict__ row_idx,
                                     const int* __restrict__ col_idx, size_t b, int mb, int nb,
                                     int pm, int pn, int lane) {
  if (nb > kCols) return;  // block_wide reads it in place
  const int lg = lanes_log2(nb), per = 32 >> lg, k0 = lane >> lg, l0 = lane & ((1 << lg) - 1);
  const TV* vb = vals + b * pm * pn + l0;
#pragma unroll
  for (int p = 0; p < kAhead; ++p) {
    const int k = k0 + p * per;
    a.v[p] = k < mb && l0 < nb ? csb::to_f32(vb[k * pn]) : 0.f;
  }
  a.r = lane < mb ? row_idx[b * pm + lane] : 0;
  a.c = lane < nb ? col_idx[b * pn + lane] : 0;
}

template <typename TV>
__device__ __forceinline__ void store(float* stage, const Ahead& a, const TV* __restrict__ vals,
                                      const int* __restrict__ row_idx, size_t b, int mb, int nb,
                                      int pm, int pn, int lane) {
  if (nb > kCols) return;
  const int kn = round4(nb);
  int* rid = reinterpret_cast<int*>(stage + round4(pm) * stage_cols(pn));
  int* cid = rid + round4(pm);
  const int lg = lanes_log2(nb), per = 32 >> lg, k0 = lane >> lg, l0 = lane & ((1 << lg) - 1);
  if (l0 < kn) {
#pragma unroll
    for (int p = 0; p < kAhead; ++p) {
      const int k = k0 + p * per;
      if (k < mb) stage[k * kn + l0] = a.v[p];
    }
    const TV* vb = vals + b * pm * pn + l0;
    for (int k = k0 + kAhead * per; k < mb; k += per)
      stage[k * kn + l0] = l0 < nb ? csb::to_f32(vb[k * pn]) : 0.f;
  }
  if (lane < mb) rid[lane] = a.r;
  for (int k = lane + 32; k < mb; k += 32) rid[k] = row_idx[b * pm + k];
  if (lane < kn) cid[lane] = a.c;
}

// The staged block's contribution to this lane's row, nb <= kCols: the row's
// x at the block's live columns gathered into registers (0 past n), then
// four live rows at a time an fmaf chain over the columns in order, each
// row's sum added into acc[row] (acc and xcol are offset by the lane;
// xcol[c * kRows] is the block's column c). The chain's steps past n
// multiply the stage's pad columns (0) by 0: they can only turn a -0.0 sum
// into +0.0, which adds the same to the accumulator.
__device__ __forceinline__ void block_rows(const float* stage, int mb, int nb, int pm, int pn,
                                           const float* xcol, float* acc) {
  const int kn = round4(nb);
  const int* rid = reinterpret_cast<const int*>(stage + round4(pm) * stage_cols(pn));
  const int4* cid = reinterpret_cast<const int4*>(rid + round4(pm));
  float xg[kCols];
#pragma unroll
  for (int q = 0; q < kCols / 4; ++q)
    if (4 * q < nb) {
      const int4 c = cid[q];
      xg[4 * q] = xcol[c.x * kRows];
      xg[4 * q + 1] = 4 * q + 1 < nb ? xcol[c.y * kRows] : 0.f;
      xg[4 * q + 2] = 4 * q + 2 < nb ? xcol[c.z * kRows] : 0.f;
      xg[4 * q + 3] = 4 * q + 3 < nb ? xcol[c.w * kRows] : 0.f;
    }
  for (int k = 0; k < mb; k += 4) {
    const float4* v = reinterpret_cast<const float4*>(stage + k * kn);
    const int step = kn / 4;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < kCols / 4; ++q)
      if (4 * q < nb) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 w = v[u * step + q];
          s[u] = fmaf(w.x, xg[4 * q], s[u]);
          s[u] = fmaf(w.y, xg[4 * q + 1], s[u]);
          s[u] = fmaf(w.z, xg[4 * q + 2], s[u]);
          s[u] = fmaf(w.w, xg[4 * q + 3], s[u]);
        }
      }
    // The quad's four loads before its four stores: a block's rows are
    // distinct (and where they were not, the last would win, as in the row
    // body).
    const int4 r4 = *reinterpret_cast<const int4*>(rid + k);
    const int r[4] = {r4.x * kAccStride, r4.y * kAccStride, r4.z * kAccStride,
                      r4.w * kAccStride};
    float sum[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k + u < mb) sum[u] = acc[r[u]] + s[u];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k + u < mb) acc[r[u]] = sum[u];
  }
}

// The same for a block of more than kCols live columns, read in place.
template <typename TV>
__device__ __noinline__ void block_wide(const TV* __restrict__ vals,
                                        const int* __restrict__ row_idx,
                                        const int* __restrict__ col_idx, size_t b, int mb,
                                        int nb, int pm, int pn, const float* xcol, float* acc) {
  const int* cr = col_idx + b * pn;
  for (int k = 0; k < mb; ++k) {
    const TV* vr = vals + (b * pm + k) * pn;
    float s = 0.f;
    for (int l = 0; l < nb; ++l) s = fmaf(csb::to_f32(vr[l]), xcol[cr[l] * kRows], s);
    acc[row_idx[b * pm + k] * kAccStride] += s;
  }
}

}  // namespace csb_mvm_tiled

namespace {

template <typename TV, typename TX>
__global__ void __launch_bounds__(csb_mvm_tiled::kRows * csb_mvm_tiled::kMaxWarps)
    csb_mvm_kernel_tiled(const TV* __restrict__ vals, const int* __restrict__ row_idx,
                         const int* __restrict__ col_idx, const int* __restrict__ m,
                         const int* __restrict__ n, const TX* __restrict__ x,
                         float* __restrict__ out, int batch, int rows, int br, int bc, int bm,
                         int bn, int pm, int pn, int chunk) {
  using namespace csb_mvm_tiled;
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * warps + w;  // this warp's block-row
  const bool live = i < br;
  const int t0 = blockIdx.y * kRows;
  const int nt = min(kRows, rows - t0);  // true rows of the tile
  const size_t ldx = (size_t)bc * bn, ldo = (size_t)br * bm;
  float* xs = smem;
  int* mc = reinterpret_cast<int*>(xs + (size_t)kRows * chunk * bn);  // m of the pass's blocks
  int* nc = mc + warps * chunk;                                        // and their n
  float* acc = reinterpret_cast<float*>(mc + round4(2 * warps * chunk)) +
               (size_t)w * warp_words(bm, pm, pn);
  float* const stage = acc + round4(bm * kAccStride);

  if (nt > 0) {
    for (int r = 0; r < bm; ++r) acc[r * kAccStride + lane] = 0.f;
    for (int j0 = 0; j0 < bc; j0 += chunk) {
      const int cn = min(chunk, bc - j0);
      if (j0 > 0) __syncthreads();  // every warp is done with the previous pass
      stage_x(xs, x + (size_t)t0 * ldx + (size_t)j0 * bn, ldx, cn * bn, nt, warps, w, lane);
      for (int e = threadIdx.x; e < warps * cn; e += blockDim.x) {
        const int g = e / cn, jj = e - g * cn, ig = blockIdx.x * warps + g;
        if (ig < br) {
          const size_t b = (size_t)ig * bc + j0 + jj;
          mc[g * chunk + jj] = m[b];
          nc[g * chunk + jj] = n[b];
        }
      }
      __syncthreads();
      if (live) {
        const int* mw = mc + w * chunk;
        const int* nw = nc + w * chunk;
        const size_t b0 = (size_t)i * bc + j0;
        const float* xl = xs + lane;
        Ahead a;
        load(a, vals, row_idx, col_idx, b0, mw[0], nw[0], pm, pn, lane);
        store(stage, a, vals, row_idx, b0, mw[0], nw[0], pm, pn, lane);
        __syncwarp();
        for (int jj = 0; jj < cn; ++jj) {
          const int mb = mw[jj], nb = nw[jj];
          if (jj + 1 < cn)
            load(a, vals, row_idx, col_idx, b0 + jj + 1, mw[jj + 1], nw[jj + 1], pm, pn, lane);
          if (mb > 0 && nb > 0) {  // an empty block adds nothing (the row body adds +0.0)
            if (nb <= kCols)
              block_rows(stage, mb, nb, pm, pn, xl + jj * bn * kRows, acc + lane);
            else
              block_wide(vals, row_idx, col_idx, b0 + jj, mb, nb, pm, pn,
                         xl + jj * bn * kRows, acc + lane);
          }
          __syncwarp();
          if (jj + 1 < cn)
            store(stage, a, vals, row_idx, b0 + jj + 1, mw[jj + 1], nw[jj + 1], pm, pn, lane);
          __syncwarp();
        }
      }
    }
  }
  if (!live) return;
  for (int e = lane; e < kRows * bm; e += 32) {
    const int t = e / bm, r = e - t * bm, row = t0 + t;
    if (row < batch)
      out[(size_t)row * ldo + (size_t)i * bm + r] = t < nt ? acc[r * kAccStride + t] : 0.f;
  }
}

template <typename TV, typename TX>
cudaError_t launch_tiled(const void* vals, const void* row_idx, const void* col_idx,
                         const void* m, const void* n, const void* x, void* out, int batch,
                         int rows, int br, int bc, int bm, int bn, int pm, int pn, int warps,
                         int chunk, cudaStream_t stream) {
  const size_t smem = csb_mvm_tiled::smem_bytes(bm, bn, pm, pn, warps, chunk);
  auto kernel = csb_mvm_kernel_tiled<TV, TX>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int rows_per_cta = csb_mvm_tiled::kRows;
  dim3 grid((br + warps - 1) / warps, (batch + rows_per_cta - 1) / rows_per_cta);
  kernel<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const TV*>(vals), static_cast<const int*>(row_idx),
      static_cast<const int*>(col_idx), static_cast<const int*>(m),
      static_cast<const int*>(n), static_cast<const TX*>(x), static_cast<float*>(out), batch,
      rows, br, bc, bm, bn, pm, pn, chunk);
  return cudaGetLastError();
}

// Calls f(TV{}, TX{}) for the value and input types the flags name:
// fp32 (0) or bf16 (1).
template <typename F>
cudaError_t by_dtypes(int vals_bf16, int x_bf16, F&& f) {
  if (vals_bf16) {
    if (x_bf16) return f(__nv_bfloat16{}, __nv_bfloat16{});
    return f(__nv_bfloat16{}, float{});
  }
  if (x_bf16) return f(float{}, __nv_bfloat16{});
  return f(float{}, float{});
}

}  // namespace

// Launches the row body on `stream` without synchronising; returns the
// cudaError_t of the launch. vals and x are fp32 (0) or bf16 (1) as the
// flags say; the indices are int32; out is (batch, br * bm) fp32, of which
// the first `rows` rows are computed and the rest written as zeros. The
// caller (kernels/csb_mvm.py::launch_config) guarantees batch % tb == 0,
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
  return by_dtypes(vals_bf16, x_bf16, [&](auto v, auto xv) {
    return launch<decltype(v), decltype(xv)>(vals, row_idx, col_idx, m, n, x, out, batch, rows,
                                             br, bc, bm, bn, pm, pn, tb, threads, gs, chunk, s);
  });
}

// Launches the batch-tiled body, as csb_mvm_launch does the row body: a
// grid of (ceil(br / warps), ceil(batch / 32)) CTAs of 32 * warps threads.
// The caller (kernels/csb_mvm.py::tiled_config) guarantees 1 <= warps <= 8,
// 1 <= chunk <= bc, 1 <= rows <= batch and smem_bytes(bm, bn, pm, pn,
// warps, chunk) within 232448.
extern "C" int csb_mvm_tiled_launch(const void* vals, const void* row_idx, const void* col_idx,
                                    const void* m, const void* n, const void* x, void* out,
                                    int batch, int rows, int br, int bc, int bm, int bn, int pm,
                                    int pn, int warps, int chunk, int vals_bf16, int x_bf16,
                                    int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtypes(vals_bf16, x_bf16, [&](auto v, auto xv) {
    return launch_tiled<decltype(v), decltype(xv)>(vals, row_idx, col_idx, m, n, x, out, batch,
                                                   rows, br, bc, bm, bn, pm, pn, warps, chunk,
                                                   s);
  });
}

extern "C" const char* csb_mvm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
