// Kernel B3 for Hopper (sm_90a): the CSB matvec y = x * W^T with W's
// block-rows spread over the ranks of a mesh axis, returned whole and in
// row order on every rank.
//
// Replaces src/repro/kernels/csb_sharded.py::csb_matvec_sharded, which runs
// the Pallas CSB-MVM on each TPU's block-row shard under shard_map, then
// all-gathers the output rows in chunks (so that ICI traffic hides behind
// the next chunk's compute) and puts them back in order with one take.
//
// What bounds it: bytes, as B1: the shard's live values and indices, x,
// and this rank's output rows stored once to every rank. Here the
// exchange is the kernel's epilogue. Each CTA runs B1's block-row body
// (csb_block.cuh, the same device code, so every output is summed in B1's
// order and B3 is bit-equal to B1 on the whole matrix) over one of the
// rank's live block-rows; pad rows (m = n = 0) get no CTA. Thread (t, r)
// then stores its sum for each true batch row at its global output column,
// read from a table the host builds once (row_map[rank][i] * bm + r, or -1
// past the matrix), into every rank's destination: its own and its peers'
// through pointers opened with CUDA IPC (peers over NVLink, or ranks that
// share one card). That store is the all-gather and the row unpermute of
// the TPU version; no concat, gather or copy kernel runs. With one rank
// the one destination is the output itself.
//
// With R > 1 ranks each rank holds a symmetric buffer (dist/symm.py):
// S output slots and the int32 words written[S][R] and consumed[R]. A call
// with ticket e (1, 2, ... in lock-step on every rank: the call is SPMD)
// uses slot (e - 1) % S, all on the caller's stream, with no host wait and
// no SM spinning (the waits are stream memory operations):
//   1. wait until every peer k has copied out the slot's previous use:
//      consumed[k] >= e - S in this rank's buffer;
//   2. launch the kernel, storing into slot s of every rank;
//   3. write written[s][rank] = e into every peer's buffer (the write is
//      preceded by a system-wide fence, so the kernel's stores land first);
//   4. wait until written[s][k] >= e for every peer k;
//   5. copy the slot into the output (one cudaMemcpyAsync);
//   6. write consumed[rank] = e into every peer's buffer.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

#include "csb_block.cuh"

namespace {

constexpr int kMaxRanks = 8;
constexpr int kCuResult = 100000;  // codes at or above it are CUresult + kCuResult

struct Dests {
  float* p[kMaxRanks];
};

template <typename TV, typename TX>
__global__ void __launch_bounds__(1024)
    csb_sharded_kernel(const TV* __restrict__ vals, const int* __restrict__ row_idx,
                       const int* __restrict__ col_idx, const int* __restrict__ m,
                       const int* __restrict__ n, const TX* __restrict__ x,
                       const int* __restrict__ cols, Dests dst, int n_dst, int ldx,
                       int out_dim, int rows, int bc, int bm, int bn, int pm, int pn, int tb,
                       int tr, int gs, int chunk) {
  extern __shared__ float part[];
  const int i = blockIdx.x;        // the rank's live block-row
  const int t0 = blockIdx.y * tb;  // first batch row of the tile
  const int nt = max(0, min(tb, rows - t0));
  const float acc = csb::block_row<TV, TX>(part, vals, row_idx, col_idx, m, n, x, ldx, i, t0,
                                           nt, bc, bm, bn, pm, pn, tr, gs, chunk);
  const int t = threadIdx.x / bm, r = threadIdx.x % bm;
  if (t < nt) {
    const int col = cols[(size_t)i * bm + r];
    if (col >= 0) {
      const size_t at = (size_t)(t0 + t) * out_dim + col;
      // unrolled: a constant index keeps the pointers in the parameter bank
#pragma unroll
      for (int d = 0; d < kMaxRanks; ++d)
        if (d < n_dst) dst.p[d][at] = acc;
    }
  }
}

template <typename TV, typename TX>
cudaError_t launch(const void* vals, const void* row_idx, const void* col_idx, const void* m,
                   const void* n, const void* x, const void* cols, const Dests& dst, int n_dst,
                   int ldx, int out_dim, int rows, int live_rows, int bc, int bm, int bn, int pm,
                   int pn, int tb, int threads, int gs, int chunk, cudaStream_t stream) {
  const int tr = min(tb, rows);
  const size_t smem = csb::smem_bytes(bm, pn, tr, chunk, threads, gs);
  auto kernel = csb_sharded_kernel<TV, TX>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(live_rows, (rows + tb - 1) / tb);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const TV*>(vals), static_cast<const int*>(row_idx),
      static_cast<const int*>(col_idx), static_cast<const int*>(m),
      static_cast<const int*>(n), static_cast<const TX*>(x), static_cast<const int*>(cols), dst,
      n_dst, ldx, out_dim, rows, bc, bm, bn, pm, pn, tb, tr, gs, chunk);
  return cudaGetLastError();
}

cudaError_t launch_any(int vals_bf16, int x_bf16, const void* vals, const void* row_idx,
                       const void* col_idx, const void* m, const void* n, const void* x,
                       const void* cols, const Dests& dst, int n_dst, int ldx, int out_dim,
                       int rows, int live_rows, int bc, int bm, int bn, int pm, int pn, int tb,
                       int threads, int gs, int chunk, cudaStream_t s) {
  if (vals_bf16) {
    if (x_bf16)
      return launch<__nv_bfloat16, __nv_bfloat16>(vals, row_idx, col_idx, m, n, x, cols, dst,
                                                  n_dst, ldx, out_dim, rows, live_rows, bc, bm,
                                                  bn, pm, pn, tb, threads, gs, chunk, s);
    return launch<__nv_bfloat16, float>(vals, row_idx, col_idx, m, n, x, cols, dst, n_dst, ldx,
                                        out_dim, rows, live_rows, bc, bm, bn, pm, pn, tb,
                                        threads, gs, chunk, s);
  }
  if (x_bf16)
    return launch<float, __nv_bfloat16>(vals, row_idx, col_idx, m, n, x, cols, dst, n_dst, ldx,
                                        out_dim, rows, live_rows, bc, bm, bn, pm, pn, tb,
                                        threads, gs, chunk, s);
  return launch<float, float>(vals, row_idx, col_idx, m, n, x, cols, dst, n_dst, ldx, out_dim,
                              rows, live_rows, bc, bm, bn, pm, pn, tb, threads, gs, chunk, s);
}

// The stream memory operations (cuStreamWaitValue32, cuStreamWriteValue32)
// and cuGetErrorString, reached through the runtime's entry-point query
// (no link against libcuda).
typedef CUresult (*StreamValueFn)(CUstream, CUdeviceptr, cuuint32_t, unsigned int);
typedef CUresult (*ErrorStringFn)(CUresult, const char**);

struct StreamOps {
  StreamValueFn wait = nullptr, write = nullptr;
  ErrorStringFn error_string = nullptr;
  int status = 0;
};

template <typename F>
int entry_point(const char* name, F* fn) {
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(name, reinterpret_cast<void**>(fn), 12000,
                                                   cudaEnableDefault, &q);
#else
  cudaError_t e = cudaGetDriverEntryPoint(name, reinterpret_cast<void**>(fn), cudaEnableDefault,
                                          &q);
#endif
  if (e != cudaSuccess) return e;
  return q == cudaDriverEntryPointSuccess ? 0 : cudaErrorSymbolNotFound;
}

const StreamOps& stream_ops() {
  static const StreamOps d = [] {
    StreamOps d;
    d.status = entry_point("cuStreamWaitValue32", &d.wait);
    if (!d.status) d.status = entry_point("cuStreamWriteValue32", &d.write);
    if (!d.status) d.status = entry_point("cuGetErrorString", &d.error_string);
    return d;
  }();
  return d;
}

int wait_geq(CUstream s, const int* addr, unsigned int value) {
  CUresult r = stream_ops().wait(s, reinterpret_cast<CUdeviceptr>(addr), value,
                                 CU_STREAM_WAIT_VALUE_GEQ);
  return r == CUDA_SUCCESS ? 0 : kCuResult + r;
}

int write_value(CUstream s, int* addr, unsigned int value) {
  CUresult r = stream_ops().write(s, reinterpret_cast<CUdeviceptr>(addr), value,
                                  CU_STREAM_WRITE_VALUE_DEFAULT);
  return r == CUDA_SUCCESS ? 0 : kCuResult + r;
}

}  // namespace

// One call of B3 on this rank, enqueued on `stream` without synchronising;
// returns 0 or the error. vals and x are fp32 (0) or bf16 (1) as the flags
// say; x is (rows, ldx) with ldx <= bc * bn; the indices and `cols`
// ((live_rows + pad rows) * bm entries) are int32; out is (rows, out_dim)
// fp32. With n_ranks == 1 the kernel stores straight into out (bases is
// unused); columns whose table entry is -1 are not written. With n_ranks >
// 1, bases[k] is rank k's symmetric buffer as mapped in this process:
// flag_bytes of int32 words (written[n_slots][n_ranks], then
// consumed[n_ranks]), then n_slots slots of slot_bytes; ticket is this
// call's (1, 2, ..., the same on every rank). live_rows may be 0 (a rank
// that holds only pad rows): then no kernel runs, and the rank still takes
// its part in the exchange. The caller (kernels/csb_sharded.py) guarantees
// launch_config's conditions, as for B1, and n_ranks <= 8.
extern "C" int csb_sharded_run(const void* vals, const void* row_idx, const void* col_idx,
                               const void* m, const void* n, const void* x, const void* cols,
                               void* out, void* const* bases, int n_ranks, int rank,
                               int n_slots, long long flag_bytes, long long slot_bytes,
                               unsigned int ticket, int rows, int live_rows, int ldx,
                               int out_dim, int bc, int bm, int bn, int pm, int pn, int tb,
                               int threads, int gs, int chunk, int vals_bf16, int x_bf16,
                               int device, void* stream) {
  int e = cudaSetDevice(device);
  if (e) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Dests dst{};
  if (n_ranks == 1) {
    dst.p[0] = static_cast<float*>(out);
    if (live_rows == 0) return 0;
    return launch_any(vals_bf16, x_bf16, vals, row_idx, col_idx, m, n, x, cols, dst, 1, ldx,
                      out_dim, rows, live_rows, bc, bm, bn, pm, pn, tb, threads, gs, chunk, s);
  }
  if (n_ranks > kMaxRanks) return cudaErrorInvalidValue;
  if (stream_ops().status) return stream_ops().status;
  CUstream cs = reinterpret_cast<CUstream>(s);
  const int slot = static_cast<int>((ticket - 1) % static_cast<unsigned int>(n_slots));
  int* own = static_cast<int*>(bases[rank]);
  for (int k = 0; k < n_ranks; ++k)
    dst.p[k] = reinterpret_cast<float*>(static_cast<char*>(bases[k]) + flag_bytes +
                                        slot * slot_bytes);
  // 1. every peer has copied out this slot's previous use
  if (ticket > static_cast<unsigned int>(n_slots))
    for (int k = 0; k < n_ranks; ++k)
      if (k != rank && (e = wait_geq(cs, own + n_slots * n_ranks + k, ticket - n_slots)))
        return e;
  // 2. this rank's rows, stored into slot `slot` of every rank
  if (live_rows > 0 &&
      (e = launch_any(vals_bf16, x_bf16, vals, row_idx, col_idx, m, n, x, cols, dst, n_ranks,
                      ldx, out_dim, rows, live_rows, bc, bm, bn, pm, pn, tb, threads, gs, chunk,
                      s)))
    return e;
  // 3. tell every peer they are there; 4. wait for every peer's rows
  for (int k = 0; k < n_ranks; ++k)
    if (k != rank &&
        (e = write_value(cs, static_cast<int*>(bases[k]) + slot * n_ranks + rank, ticket)))
      return e;
  for (int k = 0; k < n_ranks; ++k)
    if (k != rank && (e = wait_geq(cs, own + slot * n_ranks + k, ticket))) return e;
  // 5. the slot into the output; 6. the slot is free again
  e = cudaMemcpyAsync(out, dst.p[rank], sizeof(float) * (size_t)rows * out_dim,
                      cudaMemcpyDeviceToDevice, s);
  if (e) return e;
  for (int k = 0; k < n_ranks; ++k)
    if (k != rank && (e = write_value(cs, static_cast<int*>(bases[k]) + n_slots * n_ranks + rank,
                                      ticket)))
      return e;
  return 0;
}

// A symmetric buffer of `bytes` on `device`, zeroed (the zeroing has ended
// when this returns), and its IPC handle (cudaIpcMemHandle_t, 64 bytes)
// written to `handle`.
extern "C" int symm_alloc(long long bytes, int device, void** ptr, void* handle) {
  int e = cudaSetDevice(device);
  if (e) return e;
  if ((e = cudaMalloc(ptr, static_cast<size_t>(bytes)))) return e;
  if ((e = cudaMemset(*ptr, 0, static_cast<size_t>(bytes)))) return e;
  if ((e = cudaDeviceSynchronize())) return e;
  return cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
}

// A peer's buffer, opened from its IPC handle in this process.
extern "C" int symm_open(const void* handle, int device, void** ptr) {
  int e = cudaSetDevice(device);
  if (e) return e;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int symm_handle_bytes() { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }

extern "C" const char* csb_sharded_error_string(int code) {
  if (code >= kCuResult) {
    const char* msg = nullptr;
    if (stream_ops().error_string &&
        stream_ops().error_string(static_cast<CUresult>(code - kCuResult), &msg) ==
            CUDA_SUCCESS &&
        msg)
      return msg;
    return "unknown CUresult";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
