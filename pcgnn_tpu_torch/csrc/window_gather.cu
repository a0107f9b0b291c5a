// Window gather for Hopper (sm_90a):
//
//     out[b, 0 : row_bytes) = store[starts[b] * elem_bytes : ... + row_bytes)
//
// Replaces the three Pallas TPU kernels of pcgnn_tpu/ops/pallas/window_gather.py:
//   _kernel / _gather               (1024-element-aligned starts),
//   _shift_kernel / _gather_shift   (any start, realigned in registers),
//   _kernel_masked / _gather_masked (rows with active == 0 issue no copy).
// On the TPU the starts had to be 1024-element aligned for a direct DMA, so
// an unaligned variant realigned in registers.  Here one kernel takes any
// start that is 16-byte aligned, which the port's store layout guarantees
// (pcgnn_tpu_torch/graph/csr.py), and copies whole 16-byte vectors, so it
// serves float32 and bfloat16 stores alike.  The optional `active` mask
// skips a row's copy entirely; its output row is then left unwritten.
//
// The same kernel serves the fused record fetch: record v of an [N, W]
// store is the window that starts at element v * W.
//
// Bound: bytes.  The kernel does no arithmetic; it must read each window
// once and write it once, B * row_bytes each way.  At the main path's shape
// (B = 1024 records of the yelp-like fused width, 17,792 bytes each) that
// is 18.2 MB each way: 10.9 us at an H100 SXM's 3.35 TB/s, 18 us at an H100
// PCIe's 2.0 TB/s.  Design: one block per batch row, its threads striding
// over the row's 16-byte vectors, so neighbouring threads touch neighbouring
// addresses and every load and store is a full 16-byte transaction.  Later
// work: TMA bulk copies and several rows per block for narrow windows.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void window_gather_kernel(const uint4* __restrict__ store,
                                     const int64_t* __restrict__ starts,
                                     const int32_t* __restrict__ active,
                                     uint4* __restrict__ out,
                                     int64_t vecs_per_row,
                                     int64_t elems_per_vec) {
  const int64_t b = blockIdx.x;
  if (active != nullptr && active[b] == 0) return;
  const uint4* src = store + starts[b] / elems_per_vec;
  uint4* dst = out + b * vecs_per_row;
  for (int64_t i = threadIdx.x; i < vecs_per_row; i += blockDim.x) {
    dst[i] = __ldg(src + i);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller has checked: 16-byte aligned store and out, row_bytes % 16 == 0,
// every starts[b] * elem_bytes % 16 == 0 and in bounds, 0 < rows < 2^31.
extern "C" int window_gather(const void* store, const int64_t* starts,
                             const int32_t* active, void* out, int64_t rows,
                             int64_t row_bytes, int64_t elem_bytes,
                             void* stream) {
  const int64_t vecs = row_bytes / 16;
  const int threads = vecs >= 256 ? 256 : static_cast<int>((vecs + 31) / 32 * 32);
  window_gather_kernel<<<static_cast<unsigned>(rows), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(store), starts, active,
      static_cast<uint4*>(out), vecs, 16 / elem_bytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* window_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
