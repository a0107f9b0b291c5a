// Ragged gather for Hopper (sm_90a):
//
//     out[b, i] = col[starts[b] + i]    for 0 <= i < d,
//     out[b, i] = fill                  where starts[b] + i lies outside col
//
// Replaces the Pallas TPU kernel of pcgnn_tpu/ops/pallas/ragged_gather.py
// (_gather_kernel, launched by ragged_window_gather).  It fetches contiguous
// runs of a CSR column array (int32 neighbor ids) from arbitrary element
// offsets: the hub lane reads each hub row's edge tail with it.  On the TPU a
// DMA wanted 1024-element-aligned starts, so the kernel copied the aligned
// superset and realigned it in registers, and the edge array had to be
// padded past every read.  Here a start may be any element offset, and the
// kernel guards the end of `col` itself: a position past it reads `fill`
// (the caller passes the node count N, the value the CSR padding holds), so
// no caller has to pad for the widest read.
//
// Bound: bytes.  The kernel does no arithmetic; it must read B * d ids and
// write B * d ids, 8 * B * d bytes.  At the hub lane's widest chunk on
// yelp-skew (32 rows of 20,480 ids) that is 5.2 MB: 1.6 us at an H100 SXM's
// 3.35 TB/s; at one TPU-sized block (32 x 512) it is 131 KB, 0.04 us, so
// there the launch, not the bytes, sets the time.  Design: one block per
// (row, tile of 1024 ids); each thread copies 4 ids, neighbouring threads on
// neighbouring 4-byte addresses, so reads and writes coalesce whatever the
// start's alignment.  The start is not 16-byte aligned in general, so wider
// vectors would need a realign; that is later work if the copy ever shows.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int64_t kTile = kThreads * kPerThread;

template <typename Start>
__global__ void ragged_gather_kernel(const int32_t* __restrict__ col,
                                     int64_t col_len,
                                     const Start* __restrict__ starts,
                                     int32_t* __restrict__ out, int64_t d,
                                     int32_t fill) {
  const int64_t b = blockIdx.x;
  const int64_t start = static_cast<int64_t>(starts[b]);
  const int64_t base = static_cast<int64_t>(blockIdx.y) * kTile + threadIdx.x;
  int32_t* dst = out + b * d;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t i = base + k * kThreads;
    if (i < d) {
      const int64_t pos = start + i;
      dst[i] = (pos >= 0 && pos < col_len) ? __ldg(col + pos) : fill;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a start width other than 4 or 8 bytes.  The
// caller has checked: col int32 and contiguous, starts contiguous,
// 0 < rows < 2^31, 0 < d, ceil(d / 1024) <= 65535.
extern "C" int ragged_gather(const int32_t* col, int64_t col_len,
                             const void* starts, int start_bytes,
                             int32_t* out, int64_t rows, int64_t d,
                             int32_t fill, void* stream) {
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((d + kTile - 1) / kTile));
  const auto s = static_cast<cudaStream_t>(stream);
  if (start_bytes == 8) {
    ragged_gather_kernel<int64_t><<<grid, kThreads, 0, s>>>(
        col, col_len, static_cast<const int64_t*>(starts), out, d, fill);
  } else if (start_bytes == 4) {
    ragged_gather_kernel<int32_t><<<grid, kThreads, 0, s>>>(
        col, col_len, static_cast<const int32_t*>(starts), out, d, fill);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ragged_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
