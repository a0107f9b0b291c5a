// Window gather for Hopper (sm_90a):
//
//     out[b, 0 : dp) = convert(store[s_b : s_b + dp])
//     s_b = clamp(starts[b] < 0 ? starts[b] + L : starts[b], 0, L - dp)
//
// Replaces the three Pallas TPU kernels of pcgnn_tpu/ops/pallas/window_gather.py:
//   _kernel / _gather               (1024-element-aligned starts),
//   _shift_kernel / _gather_shift   (any start, realigned in registers),
//   _kernel_masked / _gather_masked (rows with active == 0 issue no copy).
// The start is taken as that module's fallback, jax.lax.dynamic_slice, takes
// it: a negative start gets L added once, then every start is clamped into
// [0, L - dp].  So the kernel accepts any start and the caller reads nothing
// back to check one.  `convert` is the identity, or the exact bfloat16 ->
// float32 widening that every consumer of a bf16 store applies right after
// the fetch; folding it here saves that consumer a launch and a pass.
//
// The same kernel serves the per-relation edge-window stores and the fused
// record store (record v of an [N, W] store is the window at element v * W).
//
// Bound: bytes.  The kernel does no arithmetic; it must read each window once
// and write it once.  On the main path a bf16 fused record of yelp-like
// (17,792 bytes) is read and written widened (35,584 bytes): 1024 records
// move 54.7 MB, 16.3 us at an H100 SXM's 3.35 TB/s.  Stress-1m's relation
// windows (1,664-4,096 bytes) move 5-12.6 MB a call widened, 1.5-3.8 us,
// near what any launch costs.  Design, to keep many loads in flight (the TPU
// kernel keeps up to 64 row DMAs in flight per grid step):
//   - A row is copied in units: 16 bytes in and out, or, widening, 8 bytes
//     (4 bf16) in and 16 bytes (4 f32) out, so that neighbouring threads
//     load and store neighbouring addresses and every store is a whole
//     16 bytes.  (Widening 16-byte loads into two stores 16 bytes apart
//     cost each 32-byte sector two half-filled writes: 27 against 21 us at
//     the fused records on an H100 80GB HBM3.)
//   - One block per row.  Each thread issues all its loads (up to 4 units)
//     before its stores; a block has the fewest warps (1 to 8) that cover
//     the row at 4 units a thread.  Stress-1m's windows take 1-4 warps; the
//     16-18 KB fused and homo windows take 8 and loop.  1,024 rows are
//     then about one wave of blocks on the 132 SMs.  (Several narrow rows to a
//     block, and a warp count fixed per width at compile time, measured no
//     faster in turns on an H100 80GB HBM3.)
//   - Element path for a start that is not a whole unit (the counterpart of
//     _gather_shift) and for a dp that is not whole units: coalesced element
//     loads and stores.  The branch is taken per row.
//   - Plain (write-back) stores: the output is read by the very next kernel,
//     and 3-36 MB of it fits the 50 MB L2.
// A variant with TMA bulk copies (cp.async.bulk into shared memory on an
// mbarrier, then a bulk store or a widening pass) copied the wide rows
// faster but widened them slower (31.6 against 27.2 us at the fused records
// on an H100 80GB HBM3), and the path widens, so it was dropped.  The
// copy-mode TMA readings it lacked are the gather probes' (csrc/
// gather_probe.cu): PERF.md section 6, rows P-a and P-s of the kernel table.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;  // threads per block, at most
constexpr int kUnitsPerThread = 4;

// copy modes: bf16 or f32 copied as is, bf16 widened to f32
enum Mode { kCopy16 = 0, kCopy32 = 1, kWiden = 2 };

// In: a store element, Out: an output element, Load: one unit of input
template <int M> struct Traits;
template <> struct Traits<kCopy16> {
  using In = uint16_t; using Out = uint16_t; using Load = uint4;
};
template <> struct Traits<kCopy32> {
  using In = uint32_t; using Out = uint32_t; using Load = uint4;
};
template <> struct Traits<kWiden> {
  using In = uint16_t; using Out = uint32_t; using Load = uint2;
};

// the window's first element: wrap a negative start once, then clamp
__device__ __forceinline__ int64_t window_start(
    const int64_t* __restrict__ starts, int64_t b, int64_t len, int64_t dp) {
  int64_t s = __ldg(starts + b);
  if (s < 0) s += len;
  if (s > len - dp) s = len - dp;
  return s < 0 ? 0 : s;
}

// 4 bf16 -> 4 f32: a bf16's bits are the high half of its f32's bits
__device__ __forceinline__ uint4 widen(uint2 v) {
  return make_uint4(v.x << 16, v.x & 0xffff0000u, v.y << 16,
                    v.y & 0xffff0000u);
}

// one row's n units by the block: all loads, then all stores
template <int M>
__device__ __forceinline__ void copy_units(
    const typename Traits<M>::Load* __restrict__ src,
    uint4* __restrict__ dst, int64_t n) {
  using Load = typename Traits<M>::Load;
  const int g = static_cast<int>(blockDim.x);
  for (int64_t base = threadIdx.x; base < n;
       base += int64_t{g} * kUnitsPerThread) {
    Load v[kUnitsPerThread];
#pragma unroll
    for (int k = 0; k < kUnitsPerThread; ++k) {
      const int64_t i = base + k * g;
      if (i < n) v[k] = __ldg(src + i);
    }
#pragma unroll
    for (int k = 0; k < kUnitsPerThread; ++k) {
      const int64_t i = base + k * g;
      if (i < n) {
        if constexpr (M == kWiden) {
          dst[i] = widen(v[k]);
        } else {
          dst[i] = v[k];
        }
      }
    }
  }
}

// one row element by element (any start, any dp)
template <int M>
__device__ __forceinline__ void copy_elems(
    const typename Traits<M>::In* __restrict__ src,
    typename Traits<M>::Out* __restrict__ dst, int64_t dp) {
  for (int64_t j = threadIdx.x; j < dp; j += blockDim.x) {
    const auto x = __ldg(src + j);
    if constexpr (M == kWiden) {
      dst[j] = static_cast<uint32_t>(x) << 16;
    } else {
      dst[j] = x;
    }
  }
}

// one block per row.  unit_rows: dp is whole units and store and out are
// 16-byte aligned.
template <int M>
__global__ void __launch_bounds__(kMaxThreads)
window_gather_kernel(const void* __restrict__ store, int64_t len,
                     const int64_t* __restrict__ starts,
                     const int32_t* __restrict__ active,
                     void* __restrict__ out, int64_t dp, bool unit_rows) {
  using T = Traits<M>;
  constexpr int kPerUnit = sizeof(typename T::Load) / sizeof(typename T::In);
  const int64_t b = blockIdx.x;
  if (active != nullptr && __ldg(active + b) == 0) return;
  const int64_t s = window_start(starts, b, len, dp);
  const auto* src = static_cast<const typename T::In*>(store) + s;
  auto* dst = static_cast<typename T::Out*>(out) + b * dp;
  if (unit_rows && s % kPerUnit == 0) {
    copy_units<M>(reinterpret_cast<const typename T::Load*>(src),
                  reinterpret_cast<uint4*>(dst), dp / kPerUnit);
  } else {
    copy_elems<M>(src, dst, dp);
  }
}

template <int M>
int launch(const void* store, int64_t len, const int64_t* starts,
           const int32_t* active, void* out, int64_t rows, int64_t dp,
           cudaStream_t s) {
  using T = Traits<M>;
  constexpr int64_t kPerUnit = sizeof(typename T::Load) / sizeof(typename T::In);
  const bool unit_rows = dp % kPerUnit == 0 &&
                         reinterpret_cast<uintptr_t>(store) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
  // the fewest warps whose threads cover the row at kUnitsPerThread units
  const int64_t units = (dp + kPerUnit - 1) / kPerUnit;
  const int64_t per_warp = 32 * kUnitsPerThread;
  const int64_t warps = (units + per_warp - 1) / per_warp;
  const int threads =
      static_cast<int>(warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads);
  window_gather_kernel<M><<<static_cast<unsigned>(rows), threads, 0, s>>>(
      store, len, starts, active, out, dp, unit_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for an element width it does not take.
// elem_bytes -> out_bytes: 2 -> 2 and 4 -> 4 copy, 2 -> 4 widens bf16 to
// f32.  The caller has checked: store [len] contiguous, len >= dp > 0;
// starts [rows] int64 and active [rows] int32 (or null) contiguous; out
// [rows, dp] contiguous; 0 < rows < 2^31.  Starts may hold any value.
extern "C" int window_gather(const void* store, int64_t len, int elem_bytes,
                             const int64_t* starts, const int32_t* active,
                             void* out, int out_bytes, int64_t rows,
                             int64_t dp, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2 && out_bytes == 2) {
    return launch<kCopy16>(store, len, starts, active, out, rows, dp, s);
  }
  if (elem_bytes == 4 && out_bytes == 4) {
    return launch<kCopy32>(store, len, starts, active, out, rows, dp, s);
  }
  if (elem_bytes == 2 && out_bytes == 4) {
    return launch<kWiden>(store, len, starts, active, out, rows, dp, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* window_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
