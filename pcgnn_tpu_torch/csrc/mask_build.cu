// Dense selection-mask build with row counts, for Hopper (sm_90a):
//
//     out[b, c]  = 1.0f  if some kept slot of row b holds id c,
//     out[b, c]  = 0.0f  otherwise,                     for 0 <= c < n,
//     counts[b]  = the number of distinct kept ids of row b in [0, n)
//                = out[b, :].sum(), exactly.
//
// A row's slots come in two column groups read in place: the window
// (ids/keep [B, S]) and the minors (minor_ids [M] shared by every row, row
// stride 0, or [B, M]; keep_minor [B, M]).  A minor that is also a kept
// neighbor gives one 1.0 and counts once (set semantics).  Ids outside
// [0, n), the sentinel n among them, set nothing.
//
// Replaces the Pallas TPU kernel of pcgnn_tpu/ops/pallas/mask_build.py
// (_mask_kernel, launched by build_batch_mask).  It builds the dense [B, N]
// 0/1 mask of the learned-feature lane, whose GEMM with the node table is
// the aggregation (and whose transpose carries the table's gradient).
// Mosaic has no indexed store, so the TPU kernel inverted the scatter into
// `ids == column` compares over (row tile, column tile, slot chunk) grid
// steps.  The counts come out of the same launch, so the lane runs no row
// sum over the mask and divides the [B, F] product by them, not the mask.
//
// Bound: bytes.  The mask is B * N * 4 bytes of output, written once; the
// ids and keep flags (5 bytes a slot) are read once.  At B = 1024 and
// N = 45,954 the output alone is 188.2 MB: 56.2 us at an H100 SXM's
// 3.35 TB/s.  Design, so that the card spends its time on the stores:
//   - A bitmap in shared memory.  A block zeroes the bits of its columns,
//     reads the row's ids and sets each kept id's bit with a shared-memory
//     atomicOr (duplicates are idempotent), then expands the bits straight
//     into the row's stores: no float tile is zeroed and copied.
//   - 16-byte streaming stores.  The row pitch N * 4 bytes is not a multiple
//     of 16 in general (8 mod 16 at N = 45,954), so bits are laid out by the
//     row's position past the 16-byte boundary before it: bit p is column
//     p - shift, shift = (b * N) mod 4.  Each group of 4 positions is then
//     one aligned float4 store of 4 bits of one bitmap word; only the row's
//     first and last groups, which share 16 bytes with the neighbouring
//     rows, store their own floats one by one.  The stores are st.global.cs
//     (evict first): a 188 MB mask cannot stay in the 50 MB L2, and with
//     plain stores its dirty lines there cost about a third of the rate.
//   - Blocks of kTile positions in row-major order.  Blocks that run at the
//     same time then write one contiguous stretch of memory.  One block per
//     whole row (1,024 write streams 184 KB apart) wrote markedly slower,
//     as did a plain zero fill in that pattern.  Each block reads all of
//     its row's ids (a few percent of the bytes, from L2) and keeps the
//     bits of its own tile.
//   - Counts by popcount and a block reduction, in the row's first block,
//     whose bitmap covers the whole row (ceil((N + 3) / 32) words, 5.7 KB at
//     N = 45,954; the same dynamic size for every block, so 8 blocks of 256
//     threads fit an SM).  One block owns each count, so no global atomics
//     and no zeroing launch are needed.  A row wider than kChunkCols
//     positions is counted chunk by chunk by that block, so every N the
//     wrapper takes works with one launch.
// Blocks go on gridDim.x (rows * tiles < 2^31); offsets are 64-bit, since
// B * N passes 2^31 on large graphs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;                     // row positions per block
constexpr int kChunkWords = 4096;               // bitmap words, at most
constexpr int kChunkCols = 32 * kChunkWords;    // 131,072 row positions

// Sets the bit of each kept id of one column group that lies in [0, n) and
// in [p0, p0 + width) of the row's positions; `lo` = shift - p0.
__device__ __forceinline__ void set_bits(const int32_t* __restrict__ ids,
                                         const uint8_t* __restrict__ keep,
                                         int64_t slots, int64_t n, int64_t lo,
                                         int width, uint32_t* bits) {
  for (int64_t j = threadIdx.x; j < slots; j += kThreads) {
    const int64_t c = __ldg(ids + j);
    const int64_t p = c + lo;
    if (c >= 0 && c < n && p >= 0 && p < width && __ldg(keep + j)) {
      atomicOr(bits + (p >> 5), 1u << (p & 31));
    }
  }
}

struct Row {
  const int32_t* ids;
  const uint8_t* keep;
  int64_t slots;
  const int32_t* minor_ids;
  const uint8_t* keep_minor;
  int64_t minors;
};

// The bitmap of positions [p0, p0 + width) of the row, both groups.
__device__ void build(const Row& r, int64_t n, int64_t shift, int64_t p0,
                      int width, uint32_t* bits) {
  const int words = (width + 31) >> 5;
  for (int w = threadIdx.x; w < words; w += kThreads) bits[w] = 0u;
  __syncthreads();
  set_bits(r.ids, r.keep, r.slots, n, shift - p0, width, bits);
  if (r.minors > 0) {
    set_bits(r.minor_ids, r.keep_minor, r.minors, n, shift - p0, width, bits);
  }
  __syncthreads();
}

// Stores the first `width` bits as floats at row positions p0..; `base` is
// the row's 16-byte-aligned start, the row holds positions [shift, span).
__device__ void expand(const uint32_t* bits, float* base, int64_t p0,
                       int width, int64_t shift, int64_t span) {
  float* const dst = base + p0;
  const int groups = (width + 3) >> 2;
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    const int q = g << 2;
    const uint32_t nib = bits[q >> 5] >> (q & 31);
    const float4 v = make_float4(static_cast<float>(nib & 1u),
                                 static_cast<float>((nib >> 1) & 1u),
                                 static_cast<float>((nib >> 2) & 1u),
                                 static_cast<float>((nib >> 3) & 1u));
    const int64_t p = p0 + q;
    if (p >= shift && p + 4 <= span) {
      __stcs(reinterpret_cast<float4*>(dst + q), v);
    } else {
      // the row's first or last group: the other floats of these 16 bytes
      // belong to the neighbouring rows
      if (p >= shift && p < span) dst[q] = v.x;
      if (p + 1 >= shift && p + 1 < span) dst[q + 1] = v.y;
      if (p + 2 >= shift && p + 2 < span) dst[q + 2] = v.z;
      if (p + 3 >= shift && p + 3 < span) dst[q + 3] = v.w;
    }
  }
}

__device__ void store_count(uint32_t count, float* out) {
  __shared__ uint32_t warp_counts[kWarps];
  for (int o = 16; o > 0; o >>= 1) {
    count += __shfl_xor_sync(0xffffffffu, count, o);
  }
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_counts[w];
    *out = static_cast<float>(total);
  }
}

// Block i builds tile i % tiles of row i / tiles; chunk_cols (a multiple of
// 32, at most kChunkCols) is the bitmap's width in positions.
__global__ void __launch_bounds__(kThreads)
mask_build_kernel(const int32_t* __restrict__ ids,
                  const uint8_t* __restrict__ keep, int64_t slots,
                  const int32_t* __restrict__ minor_ids, int64_t minor_stride,
                  const uint8_t* __restrict__ keep_minor, int64_t minors,
                  int64_t n, int64_t tiles, int chunk_cols,
                  float* __restrict__ out, float* __restrict__ counts) {
  extern __shared__ uint32_t bits[];
  const int64_t b = blockIdx.x / tiles;
  const int64_t t0 = (blockIdx.x % tiles) * kTile;
  const int64_t first = b * n;                // the row's first element
  const int64_t shift = first & 3;            // floats past a 16-byte line
  float* const base = out + (first - shift);  // 16-byte aligned
  const int64_t span = shift + n;             // the row: positions [shift, span)
  const Row r{ids + b * slots, keep + b * slots, slots,
              minor_ids + b * minor_stride, keep_minor + b * minors, minors};
  const int width = static_cast<int>(span - t0 < kTile ? span - t0 : kTile);
  if (t0 != 0) {
    build(r, n, shift, t0, width, bits);
    expand(bits, base, t0, width, shift, span);
    return;
  }
  // the row's first block: its tile, and the count of the whole row
  uint32_t count = 0;
  for (int64_t p0 = 0; p0 < span; p0 += chunk_cols) {
    const int chunk = static_cast<int>(
        span - p0 < chunk_cols ? span - p0 : chunk_cols);
    build(r, n, shift, p0, chunk, bits);
    if (p0 == 0) expand(bits, base, 0, width, shift, span);
    for (int w = threadIdx.x; w < (chunk + 31) >> 5; w += kThreads) {
      count += __popc(bits[w]);
    }
    __syncthreads();                          // the bitmap is reused
  }
  store_count(count, counts + b);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorMisalignedAddress if `out` is not 16-byte aligned.  The caller
// has checked: ids [rows, slots] int32 and keep [rows, slots] bool, both
// contiguous; where minors > 0, minor_ids int32 with row stride
// minor_stride (0 or minors) and keep_minor [rows, minors] bool, both
// contiguous; out [rows, n] float32 and counts [rows] float32, contiguous;
// 0 < n < 2^31, 0 < rows, rows * ceil((n + 3) / 4096) < 2^31, slots >= 0,
// minors >= 0.
extern "C" int mask_build(const int32_t* ids, const uint8_t* keep,
                          int64_t slots, const int32_t* minor_ids,
                          int64_t minor_stride, const uint8_t* keep_minor,
                          int64_t minors, int64_t rows, int64_t n, float* out,
                          float* counts, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int64_t span = n + 3;                 // the widest row's positions
  const int64_t tiles = (span + kTile - 1) / kTile;
  const int64_t words = (span + 31) / 32;
  const int chunk_words =
      static_cast<int>(words < kChunkWords ? words : kChunkWords);
  mask_build_kernel<<<static_cast<unsigned>(rows * tiles), kThreads,
                      chunk_words * sizeof(uint32_t),
                      static_cast<cudaStream_t>(stream)>>>(
      ids, keep, slots, minor_ids, minor_stride, keep_minor, minors, n, tiles,
      chunk_words * 32, out, counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mask_build_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
