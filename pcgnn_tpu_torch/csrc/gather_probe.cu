// Gather-kernel probes for Hopper (sm_90a): two ways to move [B, dp] int32
// windows of a flat array with the Tensor Memory Accelerator's bulk copies.
//
//   P-a, aligned:  out[b, 0 : dp) = flat[a_b : a_b + dp),
//                  a_b = (s_b / 1024) * 1024
//   P-s, shift:    out[b, 0 : dp) = flat[s_b : s_b + dp)
//   s_b = clamp(starts[b], 0, L - dp)   (so no launch reads past flat)
//
// Replaces the two Pallas TPU kernels of benchmarks/gather_kernel_probe.py:
//   _aligned_kernel / aligned_window_gather (row DMAs from 1024-aligned
//     starts straight into the output block, `rows` in flight),
//   _shift_kernel / shift_window_gather (a `slots`-deep pipeline of span
//     DMAs into scratch, realigned by two rolls and a lane select).
// They are design probes of the window gather (csrc/window_gather.cu): do
// window rows move faster as aligned asynchronous copies in flight, or
// through a K-slot pipeline with a realigning shift?  No training path
// launches them; benchmarks/gather_kernel_probe.py (the port's) times them.
//
// Bound: bytes.  Each window is read once and written once: at the probe's
// defaults (B = 1024, dp = 7,040) 2 x 28.8 MB, 17.2 us at an H100 SXM's
// 3.35 TB/s.  Hopper has no global-to-global DMA, so a row passes through
// shared memory; what the design does about the bound is keep many rows in
// flight with no thread spending registers or instructions on the bytes:
//   - P-a: a block takes `rows` rows through a ring of K slots of dp * 4
//     bytes (as many as fit in 227 KB, at most `rows`).  One elected thread
//     issues one 1-D bulk copy a row (cp.async.bulk global -> shared,
//     completing on that slot's mbarrier); as each slot completes it issues
//     a bulk store of it to the output row (cp.async.bulk shared -> global,
//     one bulk group a row), and refills the slot whose store was issued a
//     step earlier once that store has read it (wait_group.read 1).  The
//     1024-element floor makes every source 16-byte aligned; dp % 4 == 0
//     makes every size whole 16-byte units.
//   - P-s: a block takes `rows` rows through K slots.  Each slot receives
//     the 16-byte-aligned cover of its row's window, from s_b & ~3, dp + 4
//     elements cut at the end of flat (L % 4 == 0 keeps the cut in whole
//     16-byte units), by one bulk copy on its own mbarrier, issued by one
//     thread K - 1 rows ahead of the row being written.  The block's
//     threads then read the slot at offset s_b & 3 (two aligned 16-byte
//     shared loads realigned in registers, one where the offset is 0) and
//     write whole 16-byte stores to the output row: the counterpart of the
//     two rolls and the lane select.  A __syncthreads after each row frees
//     its slot for the copy issued at the next.  The TPU's span of
//     ceil(dp/1024)*1024 + 1024 elements (32 KiB at the defaults) existed
//     for its 1024-element DMA alignment; here the cover is dp + 4.
// Both need at least 2 slots (one filling while one drains); the wrapper
// refuses a row too wide for that.  Offsets into flat are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kAlign = 1024;            // P-a's start granule, in elements
constexpr int kShiftThreads = 256;
constexpr int kAlignedThreads = 32;

// shared memory before the slots: one 8-byte mbarrier a slot, rounded up
// to 128 bytes
__host__ __device__ constexpr int barrier_bytes(int slots) {
  return (slots * 8 + 127) / 128 * 128;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// one bulk store of `bytes` from shared into global memory, as its own
// bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// orders this thread's shared-memory accesses with the bulk copies' (the
// async proxy's): a completed copy's data before the store that reads it,
// the block's reads of a slot before the copy that overwrites it
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ int64_t clamped_start(const int32_t* starts,
                                                 int64_t b, int64_t len,
                                                 int64_t dp) {
  int64_t s = __ldg(starts + b);
  if (s > len - dp) s = len - dp;
  return s < 0 ? 0 : s;
}

__global__ void __launch_bounds__(kAlignedThreads)
aligned_kernel(const int32_t* __restrict__ flat, int64_t len,
               const int32_t* __restrict__ starts, int32_t* __restrict__ out,
               int64_t b_total, int dp, int rows, int slots) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;
  auto* bars = reinterpret_cast<uint64_t*>(smem);
  auto* ring = reinterpret_cast<int32_t*>(smem + barrier_bytes(slots));
  const int64_t first = static_cast<int64_t>(blockIdx.x) * rows;
  const int n = static_cast<int>(
      b_total - first < rows ? b_total - first : rows);
  const uint32_t bytes = static_cast<uint32_t>(dp) * 4u;
  for (int k = 0; k < slots; ++k) mbar_init(bars + k);
  mbar_fence_init();
  auto load = [&](int r) {
    const int64_t s = clamped_start(starts, first + r, len, dp);
    const int64_t a = (s / kAlign) * kAlign;
    const int k = r % slots;
    bulk_load(ring + static_cast<int64_t>(k) * dp, flat + a, bytes,
              bars + k);
  };
  for (int r = 0; r < n && r < slots; ++r) load(r);
  for (int r = 0; r < n; ++r) {
    const int k = r % slots;
    mbar_wait(bars + k, static_cast<uint32_t>(r / slots) & 1u);
    fence_async_shared();
    bulk_store(out + (first + r) * dp, ring + static_cast<int64_t>(k) * dp,
               bytes);
    // refill the slot whose store went out a step ago, once it is read
    if (r >= 1 && r - 1 + slots < n) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(r - 1 + slots);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// four int32 of `slot` from element 4 * u + off (0 <= off < 4); the slot is
// 16-byte aligned and holds at least 4 * u + 8 elements when off != 0
__device__ __forceinline__ int4 shifted_group(const int32_t* slot, int u,
                                              int off) {
  const int4* v = reinterpret_cast<const int4*>(slot) + u;
  const int4 a = v[0];
  if (off == 0) return a;
  const int4 c = v[1];
  if (off == 1) return make_int4(a.y, a.z, a.w, c.x);
  if (off == 2) return make_int4(a.z, a.w, c.x, c.y);
  return make_int4(a.w, c.x, c.y, c.z);
}

__global__ void __launch_bounds__(kShiftThreads)
shift_kernel(const int32_t* __restrict__ flat, int64_t len,
             const int32_t* __restrict__ starts, int32_t* __restrict__ out,
             int64_t b_total, int dp, int rows, int slots) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto* bars = reinterpret_cast<uint64_t*>(smem);
  auto* ring = reinterpret_cast<int32_t*>(smem + barrier_bytes(slots));
  const int64_t first = static_cast<int64_t>(blockIdx.x) * rows;
  const int n = static_cast<int>(
      b_total - first < rows ? b_total - first : rows);
  const int cover = dp + 4;            // a slot's elements
  if (threadIdx.x == 0) {
    for (int k = 0; k < slots; ++k) mbar_init(bars + k);
    mbar_fence_init();
  }
  __syncthreads();
  auto load = [&](int r) {
    const int64_t s = clamped_start(starts, first + r, len, dp);
    const int64_t q = s & ~int64_t{3};
    const int64_t m = len - q < cover ? len - q : cover;
    const int k = r % slots;
    // the block's reads of this slot (ordered by __syncthreads) before
    // the copy that overwrites it
    fence_async_shared();
    bulk_load(ring + static_cast<int64_t>(k) * cover, flat + q,
              static_cast<uint32_t>(m) * 4u, bars + k);
  };
  if (threadIdx.x == 0) {
    for (int r = 0; r < n && r < slots - 1; ++r) load(r);
  }
  const int units = dp / 4;
  for (int r = 0; r < n; ++r) {
    // keep slots - 1 rows in flight: the slot of row r - 1, freed by the
    // __syncthreads that ended its row
    if (threadIdx.x == 0 && r + slots - 1 < n) load(r + slots - 1);
    const int k = r % slots;
    const int64_t b = first + r;
    const int off = static_cast<int>(clamped_start(starts, b, len, dp) & 3);
    mbar_wait(bars + k, static_cast<uint32_t>(r / slots) & 1u);
    const int32_t* slot = ring + static_cast<int64_t>(k) * cover;
    int4* dst = reinterpret_cast<int4*>(out + b * dp);
    for (int u = threadIdx.x; u < units; u += kShiftThreads) {
      dst[u] = shifted_group(slot, u, off);
    }
    __syncthreads();
  }
}

int set_smem(const void* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

// The caller has checked: flat int32 contiguous and 16-byte aligned, with
// len % 4 == 0 and dp <= len; starts int32 contiguous; out [b_total, dp]
// int32 contiguous; dp % 4 == 0, dp > 0, b_total > 0, 1 <= rows, and
// 1 <= slots <= rows with barrier_bytes(slots) + slots * slot bytes within
// the 227 KB of shared memory a block may use, and slots >= 2 for P-a
// unless rows == 1.  Each launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int gather_probe_aligned(const int32_t* flat, int64_t len,
                                    const int32_t* starts, int32_t* out,
                                    int64_t b_total, int dp, int rows,
                                    int slots, void* stream) {
  const int smem = barrier_bytes(slots) + slots * dp * 4;
  int rc = set_smem(reinterpret_cast<const void*>(aligned_kernel), smem);
  if (rc) return rc;
  const auto grid = static_cast<unsigned>((b_total + rows - 1) / rows);
  aligned_kernel<<<grid, kAlignedThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      flat, len, starts, out, b_total, dp, rows, slots);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_probe_shift(const int32_t* flat, int64_t len,
                                  const int32_t* starts, int32_t* out,
                                  int64_t b_total, int dp, int rows,
                                  int slots, void* stream) {
  const int smem = barrier_bytes(slots) + slots * (dp + 4) * 4;
  int rc = set_smem(reinterpret_cast<const void*>(shift_kernel), smem);
  if (rc) return rc;
  const auto grid = static_cast<unsigned>((b_total + rows - 1) / rows);
  shift_kernel<<<grid, kShiftThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      flat, len, starts, out, b_total, dp, rows, slots);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gather_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
