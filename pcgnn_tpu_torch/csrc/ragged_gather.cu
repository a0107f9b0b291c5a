// Ragged gather for Hopper (sm_90a):
//
//     out[b, i] = col[starts[b] + i]    for 0 <= i < d,
//     out[b, i] = fill                  where starts[b] + i lies outside col
//
// Replaces the Pallas TPU kernel of pcgnn_tpu/ops/pallas/ragged_gather.py
// (_gather_kernel, launched by ragged_window_gather).  It fetches contiguous
// runs of a CSR column array (int32 neighbor ids) from arbitrary element
// offsets: the hub lane reads each hub row's edge tail with it, and
// batch_neighbor_window's CSR branch each row's window.  On the TPU a DMA
// wanted 1024-element-aligned starts, so the kernel copied the aligned
// superset and realigned it in registers, and the edge array had to be
// padded past every read.  Here a start may be any element offset, and the
// kernel guards the end of `col` itself: a position past it reads `fill`
// (the caller passes the node count N, the value the CSR padding holds), so
// no caller has to pad for the widest read.
//
// Bound: bytes, 8 * B * d (each id read once and written once).  At the hub
// lane's widest chunk on yelp-skew (16 rows of 16,896 ids) that is 2.16 MB:
// 0.65 us at an H100 SXM's 3.35 TB/s, below what any launch takes, so the
// launch and two dependent memory round trips (starts[b], then col) set the
// time, and the card's floor is this kernel copying 1 row of 1 id.  Design,
// to spread those round trips over as many threads as the copy has units
// and to leave each thread no serial work:
//   - The output is flat: thread u copies unit u (a 16-byte group of 4 ids,
//     or one id), whichever row it falls in: one load of its start, then
//     its ids, then one store.  Narrow rows (d = 17) no longer leave most
//     of a block idle, and wide ones spread over every SM.  Giving a thread
//     4 or 8 units (all loads before any store) was slower: at 16 x 512 the
//     copy then ran on 2 blocks.
//   - Vector path, where every output row is 16-byte aligned (d % 4 == 0,
//     true of every hub chunk, whose widths are multiples of 512) and col
//     is too: each group is one 16-byte store, its 4 ids two aligned 16-byte
//     loads realigned by the start's offset mod 4 (one load where the start
//     is aligned).  Where those vectors would leave col, four guarded
//     scalar loads give the fill.
//   - Scalar path otherwise (the CSR windows of d = 17 or 49): coalesced
//     4-byte loads and stores, guarded likewise.
// Indices are 32-bit (the wrapper takes B * d < 2^31).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int32_t load_id(const int32_t* __restrict__ col,
                                           int64_t len, int64_t pos,
                                           int32_t fill) {
  return (pos >= 0 && pos < len) ? __ldg(col + pos) : fill;
}

// col[pos .. pos + 4), fill outside col; col is 16-byte aligned
__device__ __forceinline__ int4 load_group(const int32_t* __restrict__ col,
                                           int64_t len, int64_t pos,
                                           int32_t fill) {
  const int sh = static_cast<int>(pos & 3);
  const int64_t q = pos - sh;
  if (q >= 0 && q + (sh ? 8 : 4) <= len) {
    const int4* v = reinterpret_cast<const int4*>(col + q);
    const int4 a = __ldg(v);
    if (sh == 0) return a;
    const int4 c = __ldg(v + 1);
    if (sh == 1) return make_int4(a.y, a.z, a.w, c.x);
    if (sh == 2) return make_int4(a.z, a.w, c.x, c.y);
    return make_int4(a.w, c.x, c.y, c.z);
  }
  return make_int4(load_id(col, len, pos, fill),
                   load_id(col, len, pos + 1, fill),
                   load_id(col, len, pos + 2, fill),
                   load_id(col, len, pos + 3, fill));
}

template <typename Start, bool kVector>
__global__ void __launch_bounds__(kThreads)
ragged_gather_kernel(const int32_t* __restrict__ col, int64_t col_len,
                     const Start* __restrict__ starts,
                     int32_t* __restrict__ out, uint32_t d, uint32_t units,
                     int32_t fill) {
  constexpr uint32_t kWidth = kVector ? 4 : 1;    // ids per unit
  const uint32_t u = blockIdx.x * kThreads + threadIdx.x;
  if (u >= units) return;
  const uint32_t e = u * kWidth;                  // the unit's first id
  const uint32_t b = e / d;
  const int64_t pos = static_cast<int64_t>(__ldg(starts + b)) + (e - b * d);
  if constexpr (kVector) {
    reinterpret_cast<int4*>(out)[u] = load_group(col, col_len, pos, fill);
  } else {
    out[u] = load_id(col, col_len, pos, fill);
  }
}

template <typename Start>
int launch(const int32_t* col, int64_t col_len, const Start* starts,
           int32_t* out, int64_t rows, int64_t d, int32_t fill,
           cudaStream_t s) {
  const auto total = static_cast<uint32_t>(rows * d);
  const bool vector = d % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(col) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const uint32_t units = vector ? total / 4 : total;
  const unsigned grid = (units + kThreads - 1) / kThreads;
  if (vector) {
    ragged_gather_kernel<Start, true><<<grid, kThreads, 0, s>>>(
        col, col_len, starts, out, static_cast<uint32_t>(d), units, fill);
  } else {
    ragged_gather_kernel<Start, false><<<grid, kThreads, 0, s>>>(
        col, col_len, starts, out, static_cast<uint32_t>(d), units, fill);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a start width other than 4 or 8 bytes.  The
// caller has checked: col int32 and contiguous, starts contiguous, out
// [rows, d] int32 contiguous, 0 < rows, 0 < d, rows * d < 2^31.
extern "C" int ragged_gather(const int32_t* col, int64_t col_len,
                             const void* starts, int start_bytes,
                             int32_t* out, int64_t rows, int64_t d,
                             int32_t fill, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (start_bytes == 8) {
    return launch(col, col_len, static_cast<const int64_t*>(starts), out,
                  rows, d, fill, s);
  }
  if (start_bytes == 4) {
    return launch(col, col_len, static_cast<const int32_t*>(starts), out,
                  rows, d, fill, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ragged_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
