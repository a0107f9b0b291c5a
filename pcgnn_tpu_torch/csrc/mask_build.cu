// Dense selection-mask build for Hopper (sm_90a):
//
//     out[b, c] = 1.0f  if some slot j has keep[b, j] and ids[b, j] == c,
//     out[b, c] = 0.0f  otherwise,                  for 0 <= c < n.
//
// Replaces the Pallas TPU kernel of pcgnn_tpu/ops/pallas/mask_build.py
// (_mask_kernel, launched by build_batch_mask).  It builds the dense [B, N]
// 0/1 mask of the learned-feature lane, whose GEMM with the node table is
// the aggregation (and whose transpose carries the table's gradient).
// Mosaic has no indexed store, so the TPU kernel inverted the scatter into
// `ids == column` compares over (row tile, column tile, slot chunk) grid
// steps.  Hopper has indexed stores: each block owns one row's tile of
// kTile columns in shared memory, zeroes it, stores 1.0f at every kept id
// that falls in it, and writes the tile out.  The store is idempotent, so
// duplicate ids need no atomics (set semantics).  Ids outside [0, n),
// including the sentinel n that dropped slots hold, set nothing.
//
// Bound: bytes.  The mask is B * N * 4 bytes of output, written once; the
// ids and keep flags (5 bytes a slot) are read once per column tile, a few
// percent of the output at the learned lane's shapes.  At B = 1024 and
// N = 45,954 the output alone is 188.2 MB: 56.2 us at an H100 SXM's
// 3.35 TB/s.  Design: neighbouring threads write neighbouring 4-byte
// floats, so stores coalesce whatever the row pitch (N * 4 bytes is not a
// multiple of 16 in general, so 16-byte vector stores would need a realign);
// a 32 KB tile leaves room for seven blocks on an SM.
//
// The grid is (rows, column tiles): rows on x (up to 2^31 - 1), tiles on y
// (up to 65535, so n <= 65535 * kTile); offsets are 64-bit, since B * N
// passes 2^31 on large graphs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kTile = 8192;

__global__ void mask_build_kernel(const int32_t* __restrict__ ids,
                                  const uint8_t* __restrict__ keep,
                                  int64_t slots, int64_t n,
                                  float* __restrict__ out) {
  __shared__ float tile[kTile];
  const int64_t b = blockIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t width = (n - c0 < kTile) ? (n - c0) : kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) tile[i] = 0.0f;
  __syncthreads();
  const int32_t* row_ids = ids + b * slots;
  const uint8_t* row_keep = keep + b * slots;
  for (int64_t j = threadIdx.x; j < slots; j += kThreads) {
    const int64_t c = static_cast<int64_t>(__ldg(row_ids + j)) - c0;
    if (c >= 0 && c < width && __ldg(row_keep + j)) tile[c] = 1.0f;
  }
  __syncthreads();
  float* dst = out + b * n + c0;
  for (int64_t i = threadIdx.x; i < width; i += kThreads) dst[i] = tile[i];
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller has checked: ids [rows, slots] int32 and keep [rows, slots] bool,
// both contiguous, out [rows, n] float32 contiguous, 0 < rows < 2^31,
// 0 < n, ceil(n / 8192) <= 65535, slots >= 0.
extern "C" int mask_build(const int32_t* ids, const uint8_t* keep,
                          int64_t rows, int64_t slots, int64_t n, float* out,
                          void* stream) {
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((n + kTile - 1) / kTile));
  mask_build_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ids, keep, slots, n, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mask_build_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
