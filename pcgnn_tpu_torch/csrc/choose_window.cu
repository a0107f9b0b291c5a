// The window lane's choose for Hopper (sm_90a), one relation a launch:
//
//     s[d]     = float32(sum_f double(x[d, f]) * double(w0[f]) + double(b0))
//     dist[d]  = |center[b] - s[d]|                   for d < n,
//     n        = 0 on a hub row (deg > hub_cap), else min(deg, D),
//     keep[d]  = d < n and d is among the row's k = keff[b] nearest
//                (all strictly nearer than the k-th smallest distance t,
//                then the first ties at t in slot order; none for k <= 0),
//     num[b]   = sum of x[d, :] over kept d,  cnt[b] = the kept count,
//
// where x is the row's section of the fused records: D slots of F float32
// values, a flat run at raw + b * stride.  With `round_bf16` each value is
// rounded to bfloat16 before it is scored (a float32 store among bfloat16
// ones); the sum reads it as stored.
//
// Replaces no Pallas kernel: the JAX package computes this with XLA ops
// (pcgnn_tpu/models/pcgnn.py:218 window_s0, ops/aggregate.py:216
// keep_nearest and :674 window_sum_from_gathered), and so did the port, as
// a chain of some forty PyTorch kernels a relation: a float64 copy of the
// whole [B, D, F] window for the score, a float64 gemv, a radix sort of the
// distances, a cumsum and masks for the ties, and a bmm that read the
// window again.  The plain version, ops/aggregate.py::
// choose_window_sum_plain, is that chain.
//
// Bound: bytes.  The work under it is one read of the batch's records and
// about D * F float64 FMAs a row.  At the benchmark's shapes the records
// are [1024, 8,512] float32 for YelpChi (34.9 MB, 10.4 us at an H100 SXM's
// 3.35 TB/s, all three relations) and [256, 23,925] for Amazon (24.5 MB,
// 7.3 us); the 9 M float64 FMAs take under 1 us of the card's 34 TFLOP/s.
// At a batch of 1,024 rows the card holds every row at once or nearly, so
// a row's own latency, not the card's bandwidth, sets the time.  Design,
// so that the card moves those bytes once, keeps every intermediate on
// chip and spreads each row's work over many threads:
//   - A team of threads a row: one warp for D <= 32, up to a block of 256
//     threads at D > 128, so a team has about a thread a slot; a block of
//     256 threads holds 256 / team rows.  The launch shape follows D alone,
//     so a relation's sums always add in one order and a replay repeats
//     bit for bit.
//   - Scores: the team copies a tile of up to one slot a thread (at most
//     32 KB) of the row's valid slots into shared memory with cp.async,
//     every copy of a thread in flight at once: 16 bytes where the run is
//     16-byte aligned, 4 at its head and tail (at F = 25 a row's run starts
//     at any float), each value at its address modulo 16 so the 16-byte
//     copies stay aligned.  Each thread then scores one slot from shared
//     memory, the sum in float64 in four register chains and rounded once,
//     which gives selection_score's float32 value.  At even F the thread
//     starts at feature (lane mod F), so the warp reads 32 banks; at odd F
//     the slots' bases already fall in 32 banks.
//   - Selection keeps each slot with fewer than k slots before it in
//     (distance, slot) order, keep_nearest's rule.  At most 64 valid slots:
//     each thread counts its slot's rank over every distance.  More: a
//     bucket select with four team barriers (rank_select and bucket_select
//     below say how).  A row's steps are what costs here: with six to
//     eight rows on an SM, a barrier step took some 500 cycles, so a
//     bitonic sort (36 steps at D = 200) took 19,000 cycles a row, a
//     one-warp radix select (16 passes of a warp reduction) 8,000 and
//     counting ranks at D = 200 as long, on instruction issue.  Rows that
//     keep all their valid slots (k >= n: no selection can drop one) or
//     none skip the score and the selection.
//   - Only the distances stay, overwritten by the keep flags (D floats a
//     row, and a bucket select's histogram and boundary keys, in shared
//     memory, or in a scratch row of device memory that the wrapper gives
//     where a block's would pass 64 KB).  No [B, D, F] intermediate goes
//     to device memory.
//   - The sum: the team splits the valid slots into one contiguous chunk
//     a group of F threads, each thread one feature, and adds the chunks'
//     partial sums in chunk order: no atomics, a fixed order.  A keep flag
//     (1.0 or 0.0) multiplies its value, so no load waits on a branch.  It
//     reads the rows from the tile where the whole row was one tile (every
//     relation of the YelpChi cell), else from device memory again, where
//     the records, just read, mostly hit the L2.  A row that keeps every
//     valid slot copies its tile as well, all copies in flight at once.
// One launch a relation: the model's loop and the sharded lane interleave
// each relation's choose with its hub lane and its minors, and the three
// relations' widths (17 to 200 slots at YelpChi, several hundred for
// Amazon's U-S-U) want different teams.  Offsets are 64-bit.
//
// A second row source serves the lanes without stores (choose_window_ids):
// slot d of row b is the row xs + nbr[b, d] * ld of a feature table, at
// the ids kernel 2 or the dense table hands over, and only a valid slot's
// id is read as a row (padding ids N, and ids past the table, never).  The
// selection, the sum and the shapes are the store source's, through the
// kernel's template parameter; the tile holds each slot's row at its own
// stride, 16-byte copies where the rows and F allow (the stress table,
// F = 64), 4-byte copies otherwise (a table of F + 1 or F + 2 columns).
// Its score is computed from the row (score_row below), or read from a
// given column of it (the score-table lane).  It replaced a row gather of
// [B, D, F] float32, a float64 copy of it, a float64 gemv, keep_nearest's
// sort, cumsum and masks, and an einsum: some thirty kernels a relation.
//
// score_row is the one float64 dot product of the ids source and of
// score_rows, which scores rows of any stride for selection_score (the
// centers, the train positives, the hub lane's chunks): features in order
// in four chains, rounded once to float32, so a row's score depends on its
// values alone, and a self-loop's distance is exactly 0.  The store source
// keeps its own rotated order (bank spread at even F), which gives
// selection_score's value to float64 round-off.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 32 * 1024;   // a team's score tile, at most
constexpr int kSelectBytes = 64 * 1024; // a block's selection state, at most
constexpr int kRankMax = 64;            // rows of more valid slots: buckets
constexpr int kBuckets = 256;           // a bucket select's histogram
constexpr int kMaxCards = 64;
constexpr unsigned kFull = 0xffffffffu;

struct Shape {
  int team;        // threads a row: 32, 64, 128 or 256
  int tile;        // slots a score tile
  int tile_words;  // floats of a team's tile region (16-byte multiple)
  int part_words;  // floats of a team's partial sums
  int sel_words;   // floats of a row's selection state
  bool spill;      // the selection state in scratch rows, not shared memory
  size_t smem;     // dynamic shared memory of a block
};

__host__ __device__ inline int round4(int64_t v) {
  return static_cast<int>((v + 3) & ~int64_t{3});
}

// ts: floats between two slots' rows in an ids source's tile; 0 for the
// store source, whose tile is one run of the records
Shape shape_of(int64_t d, int64_t f, int64_t ts = 0) {
  Shape s{};
  const int64_t warps = (d + 31) / 32;
  s.team = warps <= 1 ? 32 : warps <= 2 ? 64 : warps <= 4 ? 128 : 256;
  const int64_t by_bytes = kTileBytes / (4 * (ts > 0 ? ts : f));
  s.tile = static_cast<int>(by_bytes < 1 ? 1
                            : by_bytes < s.team ? by_bytes : s.team);
  // the store's tile: its first value sits up to 3 floats past its 16-byte
  // base; an ids tile: a row every ts floats
  s.tile_words = ts > 0 ? round4(int64_t{s.tile} * ts)
                        : round4(int64_t{s.tile} * f + 3);
  s.part_words = round4(f <= s.team ? s.team : f);
  // distances (then keep flags) [D]; past kRankMax slots also a bucket
  // select's 8 control words, histogram and boundary keys [D] (64-bit)
  s.sel_words = round4(d);
  if (d > kRankMax) s.sel_words += 8 + kBuckets + 2 * round4(d);
  const int rows = kThreads / s.team;
  s.spill = int64_t{rows} * s.sel_words * 4 > kSelectBytes;
  s.smem = sizeof(double) * static_cast<size_t>(round4(f)) +
           sizeof(float) * static_cast<size_t>(rows) *
               (s.tile_words + s.part_words + (s.spill ? 0 : s.sel_words));
  return s;
}

// all threads of the team: a warp, or the named barrier 1 + the team's
// index in the block (0 is __syncthreads) over the team's warps; the ids
// are constants, so a block reserves 5 barriers
__device__ __forceinline__ void team_sync(int team, int index) {
  switch (team == 32 ? -1 : index) {
    case 0:
      asm volatile("bar.sync 1, %0;" ::"r"(team) : "memory");
      break;
    case 1:
      asm volatile("bar.sync 2, %0;" ::"r"(team) : "memory");
      break;
    case 2:
      asm volatile("bar.sync 3, %0;" ::"r"(team) : "memory");
      break;
    case 3:
      asm volatile("bar.sync 4, %0;" ::"r"(team) : "memory");
      break;
    default:
      __syncwarp();
  }
}

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const auto s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const auto s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
               : "memory");
}

// tile[lead + i] = src[i] for i < len, lead = the float offset of src past
// its 16-byte boundary; returns lead.  tile is 16-byte aligned.  Every copy
// is asynchronous (cp.async), so all of a thread's are in flight at once;
// the thread waits for its own, and a team barrier after it for all.
__device__ int copy_tile(const float* __restrict__ src, int len,
                         float* __restrict__ tile, int t, int team) {
  const int lead =
      static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int head = min(len, (4 - lead) & 3);
  if (t < head) copy_async4(tile + lead + t, src + t);
  const int nvec = (len - head) >> 2;
  for (int i = t; i < nvec; i += team) {
    copy_async16(tile + lead + head + 4 * i, src + head + 4 * i);
  }
  const int done = head + 4 * nvec;
  if (t < len - done) copy_async4(tile + lead + done + t, src + done + t);
  asm volatile("cp.async.wait_all;" ::: "memory");
  return lead;
}

// The kernel's row sources.  Records: row b's D slots are one run of
// D * F floats of the fused records at raw + b * stride.  Ids: slot d of
// row b is the row xs + nbr[b * nbr_stride + d] * ld of a table, whose
// score is column score_col where that is >= 0, else computed; vec: rows
// 16-byte aligned and F a multiple of 4 (16-byte copies and reads); a
// tile holds a slot's row every ts floats (ts / 4 odd where vec, else ts
// odd, so a warp's reads of its slots spread over the banks).
struct Records {
  static constexpr bool kIds = false;
  const float* raw;
  int64_t stride;
};

struct Ids {
  static constexpr bool kIds = true;
  const float* xs;
  int64_t ld;
  const int32_t* nbr;
  int64_t nbr_stride;
  int score_col;
  int vec;
  int ts;
};

// adds features [j0, j1) of a row, at x[0, j1 - j0), into its score's
// four float64 chains: feature j to chain j mod 4 below f4 (f less f mod
// 4), past it to chain 0, each chain in feature order, every value rounded
// to bfloat16 first where rnd.  j0 is a multiple of 4; where kVec, x is
// 16-byte aligned and j1 - j0 a multiple of 4 (16-byte reads).  A float32
// product is exact in float64, so each fma adds the exact product
template <bool kVec>
__device__ __forceinline__ void score_part(const float* x, int j0, int j1,
                                           int f4, const double* w, int rnd,
                                           double& a0, double& a1,
                                           double& a2, double& a3) {
  const auto r = [rnd](float v) -> double { return rnd ? to_bf16(v) : v; };
  if constexpr (kVec) {
    const auto* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 4
    for (int j = j0; j < j1; j += 4) {
      const float4 v = x4[(j - j0) >> 2];
      a0 = fma(r(v.x), w[j], a0);
      a1 = fma(r(v.y), w[j + 1], a1);
      a2 = fma(r(v.z), w[j + 2], a2);
      a3 = fma(r(v.w), w[j + 3], a3);
    }
  } else {
    const int e = j1 < f4 ? j1 : f4;
    int j = j0;
#pragma unroll 2
    for (; j + 4 <= e; j += 4) {
      a0 = fma(r(x[j - j0]), w[j], a0);
      a1 = fma(r(x[j - j0 + 1]), w[j + 1], a1);
      a2 = fma(r(x[j - j0 + 2]), w[j + 2], a2);
      a3 = fma(r(x[j - j0 + 3]), w[j + 3], a3);
    }
    for (; j < j1; ++j) a0 = fma(r(x[j - j0]), w[j], a0);
  }
}

// the score of the chains: float32(((a0 + a1) + (a2 + a3)) + bias), one
// rounding
__device__ __forceinline__ float score_of(double a0, double a1, double a2,
                                          double a3, double bias) {
  return static_cast<float>(((a0 + a1) + (a2 + a3)) + bias);
}

// a row's selection score from its first f values at x: score_part over
// [0, f), then score_of.  The two forms do the same arithmetic, so a
// row's score depends on its values alone
template <bool kVec>
__device__ __forceinline__ float score_row(const float* x, int f,
                                           const double* w, double bias,
                                           int rnd) {
  double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
  score_part<kVec>(x, 0, f, f & ~3, w, rnd, a0, a1, a2, a3);
  return score_of(a0, a1, a2, a3, bias);
}

// tile[s * ts + c] = the row of slot s at c < f, for s < ns (ids: the
// slots' ids); every copy asynchronous, as copy_tile's
__device__ void copy_rows(Ids src, const int32_t* ids, int ns, int f,
                          float* tile, int t, int team) {
  const int per = src.vec ? f >> 2 : f;      // copies a row
  const int total = ns * per;
  for (int i = t; i < total; i += team) {
    const int s = i / per;
    const int v = i - s * per;
    const float* row = src.xs + int64_t{__ldg(ids + s)} * src.ld;
    if (src.vec) {
      copy_async16(tile + s * src.ts + 4 * v, row + 4 * v);
    } else {
      copy_async4(tile + s * src.ts + v, row + v);
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The team keeps the k nearest of dist[0, n), 0 < k < n: dist[i] becomes
// 1.0 where slot i is kept, else 0.0 (keep_nearest's rule: fewer than k
// slots come before it in (distance, slot) order).  The caller syncs the
// team before and after.
//   - n <= kRankMax: each thread counts its own slot's rank over every
//     distance (broadcast reads of shared memory), then writes its flag.
//   - Else a bucket select: the distances' range [lo, hi] (found while
//     scoring, in ctl[0] and ctl[1]) is cut into kBuckets equal buckets,
//     a bucket index that never decreases as the distance grows; a
//     histogram, one warp's scan of it, and every slot below the k-th
//     smallest's bucket is kept, every slot above dropped; the slots of
//     that bucket (few, unless many distances tie) are ranked among
//     themselves by (distance, slot).  Four team barriers in all: under
//     the card's load a barrier step costs some 500 cycles, so the fewer
//     the better (a bitonic sort's 36 steps at D = 200 took 19,000).
__device__ void rank_select(float* dist, int n, int k, int t, int team,
                            int ti) {
  const float v = t < n ? dist[t] : 0.0f;
  int rank = 0;
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const float u = dist[j];
    rank += (u < v) || (u == v && j < t);
  }
  team_sync(team, ti);
  if (t < n) dist[t] = rank < k ? 1.0f : 0.0f;
}

__device__ void bucket_select(float* dist, unsigned* ctl, int* hist,
                              uint64_t* boundary, int n, int k, int t,
                              int team, int ti) {
  const float lo = __uint_as_float(ctl[0]);
  const float scale = kBuckets / (__uint_as_float(ctl[1]) - lo);
  // hi == lo, or a range too narrow to divide: every slot in bucket 0
  const bool spread = scale < INFINITY;
  const auto bucket_of = [&](float v) {
    return spread ? min(kBuckets - 1, static_cast<int>((v - lo) * scale)) : 0;
  };
  for (int i = t; i < n; i += team) atomicAdd(hist + bucket_of(dist[i]), 1);
  team_sync(team, ti);
  if (t < 32) {
    // warp 0: the bucket of the k-th smallest, and the count below it
    constexpr int per = kBuckets / 32;
    int own = 0;
#pragma unroll
    for (int q = 0; q < per; ++q) own += hist[t * per + q];
    int upto = own;                          // inclusive scan over lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, upto, o);
      if (t >= o) upto += y;
    }
    const unsigned hit = __ballot_sync(kFull, upto >= k);
    if (t == __ffs(hit) - 1) {
      int below = upto - own;
      int q = 0;
      while (below + hist[t * per + q] < k) below += hist[t * per + q++];
      ctl[3] = t * per + q;
      ctl[4] = below;
    }
  }
  team_sync(team, ti);
  const int edge = static_cast<int>(ctl[3]);
  const int need = k - static_cast<int>(ctl[4]);
  for (int i = t; i < n; i += team) {
    const float v = dist[i];
    const int bk = bucket_of(v);
    if (bk == edge) {
      const unsigned at = atomicAdd(ctl + 2, 1u);
      boundary[at] = (uint64_t{__float_as_uint(v)} << 32) |
                     static_cast<uint32_t>(i);
    } else {
      dist[i] = bk < edge ? 1.0f : 0.0f;
    }
  }
  team_sync(team, ti);
  const int m = static_cast<int>(ctl[2]);
  for (int q = t; q < m; q += team) {
    const uint64_t key = boundary[q];
    int rank = 0;
    for (int j = 0; j < m; ++j) rank += boundary[j] < key;
    dist[static_cast<uint32_t>(key)] = rank < need ? 1.0f : 0.0f;
  }
}

// part[g * F + f] = the sum of src(d, f) over the kept d of group g's
// chunk of [0, n), in slot order (kFlags: d kept where flags[d] is 1.0,
// else every d); a flag multiplies its value, so no load waits on a branch
template <bool kFlags, typename Src>
__device__ void sum_chunks(Src src, int n, int f, const float* flags,
                           float* part, int t, int team) {
  const int groups = f <= team ? team / f : 1;
  const int g = f <= team ? t / f : 0;
  if (g >= groups) return;
  const int chunk = (n + groups - 1) / groups;
  const int lo = g * chunk;
  const int hi = min(n, lo + chunk);
  for (int c = f <= team ? t % f : t; c < f; c += f <= team ? f : team) {
    float acc = 0.0f;
#pragma unroll 8
    for (int d = lo; d < hi; ++d) {
      const float v = src(d, c);
      acc = kFlags ? fmaf(v, flags[d], acc) : acc + v;
    }
    part[g * f + c] = acc;
  }
}

template <bool kSpill, typename Src>
__global__ void __launch_bounds__(kThreads)
choose_window_kernel(Src src, int64_t rows, int d, int f,
                     const float* __restrict__ center,
                     const float* __restrict__ w0, int64_t w_stride,
                     const float* __restrict__ b0,
                     const int32_t* __restrict__ deg,
                     const int32_t* __restrict__ keff, int64_t hub_cap,
                     int round_bf16, Shape sh, float* __restrict__ num,
                     float* __restrict__ cnt, uint8_t* __restrict__ keep_out,
                     float* __restrict__ scratch,
                     float* __restrict__ scores_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* w = reinterpret_cast<double*>(smem);
  for (int i = threadIdx.x; i < f; i += kThreads) {
    w[i] = static_cast<double>(__ldg(w0 + i * w_stride));
  }
  __syncthreads();
  const int team = sh.team;
  const int t = threadIdx.x % team;
  const int ti = threadIdx.x / team;
  const int64_t b = int64_t{blockIdx.x} * (kThreads / team) + ti;
  if (b >= rows) return;                     // the whole team
  float* tile =
      reinterpret_cast<float*>(smem + sizeof(double) * round4(f)) +
      int64_t{ti} * (sh.tile_words + sh.part_words +
                     (kSpill ? 0 : sh.sel_words));
  float* part = tile + sh.tile_words;
  // a row's distances, then keep flags [D]; a bucket select's control
  // words, histogram and boundary keys after them (16-byte aligned)
  float* dist = kSpill ? scratch + b * sh.sel_words : part + sh.part_words;
  auto* ctl = reinterpret_cast<unsigned*>(dist + round4(d));
  int* hist = reinterpret_cast<int*>(ctl + 8);
  auto* boundary = reinterpret_cast<uint64_t*>(hist + kBuckets);
  // the store source's run, or the ids source's ids, of the row
  const float* x = nullptr;
  const int32_t* ids = nullptr;
  if constexpr (Src::kIds) {
    ids = src.nbr + b * src.nbr_stride;
  } else {
    x = src.raw + b * src.stride;
  }

  const int dg = __ldg(deg + b);
  const int k = __ldg(keff + b);
  int n = dg < d ? dg : d;
  if (n < 0 || (hub_cap >= 0 && dg > hub_cap)) n = 0;
  const int kept = k <= 0 || n == 0 ? 0 : (k >= n ? n : k);
  const bool choose = kept > 0 && kept < n;
  int lead = -1;                             // >= 0: the row is the tile
  if (choose) {
    const float c = __ldg(center + b);
    const double bias = static_cast<double>(__ldg(b0));
    const int rot = (f & 1) ? 0 : (t & 31) % f;
    const bool bucketed = n > kRankMax;
    if (bucketed) {
      for (int i = t; i < kBuckets; i += team) hist[i] = 0;
      if (t == 0) {
        ctl[0] = ~0u;                        // the distances' least bits
        ctl[1] = 0;                          // and greatest
        ctl[2] = 0;                          // boundary slots
      }
    }
    for (int s0 = 0; s0 < n; s0 += sh.tile) {
      const int ns = min(sh.tile, n - s0);
      if constexpr (Src::kIds) {
        // a given score reads one value of the slot's row; a computed one
        // its tile of rows
        if (src.score_col < 0) {
          copy_rows(src, ids + s0, ns, f, tile, t, team);
          lead = 0;
          team_sync(team, ti);
        }
        if (t < ns) {
          float s;
          if (src.score_col >= 0) {
            s = __ldg(src.xs + int64_t{__ldg(ids + s0 + t)} * src.ld +
                      src.score_col);
          } else if (src.vec) {
            s = score_row<true>(tile + t * src.ts, f, w, bias, round_bf16);
          } else {
            s = score_row<false>(tile + t * src.ts, f, w, bias, round_bf16);
          }
          dist[s0 + t] = fabsf(c - s);
          if (scores_out != nullptr) scores_out[b * d + s0 + t] = s;
        }
      } else {
        lead = copy_tile(x + int64_t{s0} * f, ns * f, tile, t, team);
        team_sync(team, ti);
        if (t < ns) {
          // four float64 chains, added in a fixed order at the end
          const float* xs = tile + lead + t * f;
          int fi = rot;
          const auto term = [&](double a) {
            const float v = xs[fi];
            const double p = round_bf16 ? to_bf16(v) : v;
            a = fma(p, w[fi], a);
            fi = fi + 1 == f ? 0 : fi + 1;
            return a;
          };
          double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
          int j = 0;
#pragma unroll 2
          for (; j + 4 <= f; j += 4) {
            a0 = term(a0);
            a1 = term(a1);
            a2 = term(a2);
            a3 = term(a3);
          }
          for (; j < f; ++j) a0 = term(a0);
          const double dot = (a0 + a1) + (a2 + a3);
          const float s = static_cast<float>(dot + bias);
          dist[s0 + t] = fabsf(c - s);
          if (scores_out != nullptr) scores_out[b * d + s0 + t] = s;
        }
      }
      if (bucketed) {
        // non-negative floats order as their bits
        const unsigned bits = t < ns ? __float_as_uint(dist[s0 + t]) : 0u;
        const unsigned least = __reduce_min_sync(kFull, t < ns ? bits : ~0u);
        const unsigned most = __reduce_max_sync(kFull, bits);
        if ((t & 31) == 0) {
          atomicMin(ctl, least);
          atomicMax(ctl + 1, most);
        }
      }
      team_sync(team, ti);
    }
    if (n > sh.tile) lead = -1;
    if (bucketed) {
      bucket_select(dist, ctl, hist, boundary, n, kept, t, team, ti);
    } else {
      rank_select(dist, n, kept, t, team, ti);
    }
    team_sync(team, ti);
    if constexpr (Src::kIds) {
      // a given score left the tile empty: the sum's rows, as a row that
      // keeps every valid slot copies them
      if (src.score_col >= 0 && n <= sh.tile) {
        copy_rows(src, ids, n, f, tile, t, team);
        lead = 0;
        team_sync(team, ti);
      }
    }
  } else if (kept > 0 && n <= sh.tile) {
    if constexpr (Src::kIds) {
      copy_rows(src, ids, n, f, tile, t, team);
      lead = 0;
    } else {
      lead = copy_tile(x, n * f, tile, t, team);
    }
    team_sync(team, ti);
  }
  if (keep_out != nullptr) {
    uint8_t* kr = keep_out + b * d;
    for (int i = t; i < d; i += team) {
      kr[i] = i < n && kept > 0 && (!choose || dist[i] != 0.0f);
    }
  }
  float* out = num + b * f;
  if (kept == 0) {
    for (int i = t; i < f; i += team) out[i] = 0.0f;
  } else {
    const auto sum = [&](auto from_tile, auto from_memory) {
      if (lead >= 0 && choose) {
        sum_chunks<true>(from_tile, n, f, dist, part, t, team);
      } else if (lead >= 0) {
        sum_chunks<false>(from_tile, n, f, dist, part, t, team);
      } else if (choose) {
        sum_chunks<true>(from_memory, n, f, dist, part, t, team);
      } else {
        sum_chunks<false>(from_memory, n, f, dist, part, t, team);
      }
    };
    if constexpr (Src::kIds) {
      sum([tile, ts = src.ts](int dd, int c) { return tile[dd * ts + c]; },
          [src, ids](int dd, int c) {
            return __ldg(src.xs + int64_t{__ldg(ids + dd)} * src.ld + c);
          });
    } else {
      sum([rowt = tile + lead, f](int dd, int c) {
            return rowt[int64_t{dd} * f + c];
          },
          [x, f](int dd, int c) { return __ldg(x + int64_t{dd} * f + c); });
    }
    team_sync(team, ti);
    const int groups = f <= team ? team / f : 1;
    for (int i = t; i < f; i += team) {
      float s = part[i];
      for (int g = 1; g < groups; ++g) s += part[g * f + i];
      out[i] = s;
    }
  }
  if (t == 0) cnt[b] = static_cast<float>(kept);
}

// The arguments both sources share, as choose_window and choose_window_ids
// take them
struct Args {
  int64_t rows;
  int d, f;
  const float* center;
  const float* w0;
  int64_t w_stride;
  const float* b0;
  const int32_t* deg;
  const int32_t* keff;
  int64_t hub_cap;
  int round_bf16;
  float* num;
  float* cnt;
  uint8_t* keep;
  float* scratch;
  float* scores;
};

// raise a kernel's shared-memory ceiling on a card once, at its first
// launch there that needs more than 48 KB (outside any capture: a captured
// step's first run is eager); each kernel keeps its own ceilings
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  int card = 0;
  cudaError_t e = cudaGetDevice(&card);
  if (e != cudaSuccess) return e;
  if (card >= kMaxCards) return cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && bytes > allowed[card]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    allowed[card] = bytes;
  }
  return cudaSuccess;
}

template <bool kSpill, typename Src>
int launch(const Src& src, const Args& a, const Shape& sh, cudaStream_t s) {
  static size_t allowed[kMaxCards];
  const cudaError_t e =
      allow_smem(choose_window_kernel<kSpill, Src>, sh.smem, allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t per = kThreads / sh.team;
  const auto grid = static_cast<unsigned>((a.rows + per - 1) / per);
  choose_window_kernel<kSpill, Src><<<grid, kThreads, sh.smem, s>>>(
      src, a.rows, a.d, a.f, a.center, a.w0, a.w_stride, a.b0, a.deg,
      a.keff, a.hub_cap, a.round_bf16, sh, a.num, a.cnt, a.keep, a.scratch,
      a.scores);
  return static_cast<int>(cudaGetLastError());
}

template <typename Src>
int launch_either(const Src& src, const Args& a, const Shape& sh,
                  void* stream) {
  if (sh.smem > 232448 || (sh.spill && a.scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return sh.spill ? launch<true>(src, a, sh, s) : launch<false>(src, a, sh, s);
}

// score_rows: out[i * inner + j] = the score of the f values at x + i *
// s_outer + j * s_inner, score_row's arithmetic, 32 rows a warp.  Bound:
// bytes, each row read once (the train positives' [P, 64] float32 table,
// 51 MB at P = 200,000, takes 15 us at 3.35 TB/s).  A lane's own row read
// 16 bytes at a time touches a new line at every read, and the warp's 32
// rows as many lines, so the warp copies its rows kChunk features at a
// time into shared memory (a row every ts floats: 16-byte copies by eight
// lanes to a 128-byte line where rows and f allow, else 4-byte copies by
// 32 lanes to one row), and each lane adds its row's chunk into its chains.
constexpr int kChunk = 32;

template <bool kVec>
__host__ __device__ constexpr int chunk_stride() {
  return kVec ? kChunk + 4 : kChunk + 1;     // ts / 4 odd, or ts odd
}

size_t score_rows_smem(int64_t f, bool vec) {
  const int ts = vec ? chunk_stride<true>() : chunk_stride<false>();
  const int warps = kThreads / 32;
  return sizeof(double) * static_cast<size_t>(round4(f)) +
         sizeof(float) * warps * static_cast<size_t>(round4(32 * ts)) +
         sizeof(const float*) * kThreads;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
score_rows_kernel(const float* __restrict__ x, int64_t inner,
                  int64_t s_outer, int64_t s_inner, int64_t total, int f,
                  const float* __restrict__ w0, int64_t w_stride,
                  const float* __restrict__ b0, float* __restrict__ out) {
  constexpr int ts = chunk_stride<kVec>();
  constexpr int warps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  double* w = reinterpret_cast<double*>(smem);
  for (int i = threadIdx.x; i < f; i += kThreads) {
    w[i] = static_cast<double>(__ldg(w0 + i * w_stride));
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* tiles = reinterpret_cast<float*>(smem + sizeof(double) * round4(f));
  float* tile = tiles + warp * round4(32 * ts);
  const float** rows =
      reinterpret_cast<const float**>(tiles + warps * round4(32 * ts)) +
      warp * 32;
  const int64_t r0 = (int64_t{blockIdx.x} * warps + warp) * 32;
  if (r0 >= total) return;                   // the whole warp
  const int nrow = static_cast<int>(total - r0 < 32 ? total - r0 : 32);
  if (lane < nrow) {
    const int64_t i = (r0 + lane) / inner;
    const int64_t j = r0 + lane - i * inner;
    rows[lane] = x + i * s_outer + j * s_inner;
  }
  __syncwarp();
  const int f4 = f & ~3;
  double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
  for (int c0 = 0; c0 < f; c0 += kChunk) {
    const int width = f - c0 < kChunk ? f - c0 : kChunk;
    if constexpr (kVec) {
      const int v = lane & 7;
      if (4 * v < width) {
        for (int s = lane >> 3; s < nrow; s += 4) {
          copy_async16(tile + s * ts + 4 * v, rows[s] + c0 + 4 * v);
        }
      }
    } else if (lane < width) {
      for (int s = 0; s < nrow; ++s) {
        copy_async4(tile + s * ts + lane, rows[s] + c0 + lane);
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncwarp();
    if (lane < nrow) {
      score_part<kVec>(tile + lane * ts, c0, c0 + width, f4, w, 0, a0, a1,
                       a2, a3);
    }
    __syncwarp();
  }
  if (lane < nrow) {
    out[r0 + lane] =
        score_of(a0, a1, a2, a3, static_cast<double>(__ldg(b0)));
  }
}

template <bool kVec>
int launch_scores(const float* x, int64_t outer, int64_t inner,
                  int64_t s_outer, int64_t s_inner, int f, const float* w0,
                  int64_t w_stride, const float* b0, float* out,
                  cudaStream_t s) {
  static size_t allowed[kMaxCards];
  const size_t smem = score_rows_smem(f, kVec);
  const cudaError_t e = allow_smem(score_rows_kernel<kVec>, smem, allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t total = outer * inner;
  const auto grid = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  score_rows_kernel<kVec><<<grid, kThreads, smem, s>>>(
      x, inner, s_outer, s_inner, total, f, w0, w_stride, b0, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The floats of scratch a row that a launch at (d, f) needs, the rows'
// selection state where a block's would not fit its budget of shared
// memory; 0 where they do, and no scratch is read.  Either source.
extern "C" int64_t choose_window_scratch(int64_t d, int64_t f) {
  const Shape sh = shape_of(d, f);
  return sh.spill ? sh.sel_words : 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue where a block's shared memory would pass the card's
// 227 KB, or a spilling shape comes without scratch.  The caller has
// checked: raw float32, rows of at least d * f values at `stride` floats,
// unit stride within a row, 4-byte aligned; center [rows] float32, deg and
// keff [rows] int32, contiguous; w0 f float32 values at w_stride; b0 one
// float32; num [rows, f] and cnt [rows] float32 contiguous; keep null or
// [rows, d] bool contiguous; scratch null or [rows,
// choose_window_scratch(d, f)] float32, 16-byte aligned; scores null or
// [rows, d] float32 contiguous, which receives the score of each slot the
// kernel scored (the valid slots of rows that choose; a test's view);
// hub_cap -1 for a relation without hubs; 0 < rows, 0 < d < 2^30, 0 < f,
// d * f < 2^31.
extern "C" int choose_window(const float* raw, int64_t stride, int64_t rows,
                             int64_t d, int64_t f, const float* center,
                             const float* w0, int64_t w_stride,
                             const float* b0, const int32_t* deg,
                             const int32_t* keff, int64_t hub_cap,
                             int round_bf16, float* num, float* cnt,
                             uint8_t* keep, float* scratch, float* scores,
                             void* stream) {
  const Args a{rows, static_cast<int>(d), static_cast<int>(f), center, w0,
               w_stride, b0, deg, keff, hub_cap, round_bf16, num, cnt, keep,
               scratch, scores};
  return launch_either(Records{raw, stride}, a, shape_of(d, f), stream);
}

// The ids source: as choose_window, but slot s of row b reads the row
// xs + nbr[b * nbr_stride + s] * ld (f values, unit stride, 4-byte
// aligned; ld >= f) where s < min(deg[b], d) on a row with deg[b] <=
// hub_cap; score_col >= 0 (< ld) takes the slot's score from that column
// of its row, -1 computes it from the row.  nbr int32, unit column
// stride; every valid slot's id indexes a row of xs.  0 < f < 2^20.
extern "C" int choose_window_ids(const float* xs, int64_t ld,
                                 const int32_t* nbr, int64_t nbr_stride,
                                 int64_t score_col, int64_t rows, int64_t d,
                                 int64_t f, const float* center,
                                 const float* w0, int64_t w_stride,
                                 const float* b0, const int32_t* deg,
                                 const int32_t* keff, int64_t hub_cap,
                                 int round_bf16, float* num, float* cnt,
                                 uint8_t* keep, float* scratch,
                                 float* scores, void* stream) {
  const bool vec = f % 4 == 0 && ld % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(xs) & 15) == 0;
  // a row every ts floats of the tile: ts / 4 odd for 16-byte reads (an
  // eighth of a warp on eight distinct bank quads), ts odd for 4-byte ones
  const int64_t ts = vec ? ((f / 4) % 2 ? f : f + 4) : (f | 1);
  const Ids src{xs, ld, nbr, nbr_stride, static_cast<int>(score_col),
                vec ? 1 : 0, static_cast<int>(ts)};
  const Args a{rows, static_cast<int>(d), static_cast<int>(f), center, w0,
               w_stride, b0, deg, keff, hub_cap, round_bf16, num, cnt, keep,
               scratch, scores};
  return launch_either(src, a, shape_of(d, f, ts), stream);
}

// Selection scores of outer * inner rows: out[i * inner + j] (contiguous
// float32) = the score of the f float32 values at x + i * s_outer + j *
// s_inner (unit stride, 4-byte aligned), score_row's arithmetic.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue where w0's float64 copy and
// the tiles would pass a block's shared memory (f past some 24,000).
// 0 < outer, 0 < inner, 0 <= f.
extern "C" int score_rows(const float* x, int64_t outer, int64_t inner,
                          int64_t s_outer, int64_t s_inner, int64_t f,
                          const float* w0, int64_t w_stride, const float* b0,
                          float* out, void* stream) {
  const auto aligned = [](int64_t v) { return v % 4 == 0; };
  const bool vec = f % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (outer == 1 || aligned(s_outer)) &&
                   (inner == 1 || aligned(s_inner));
  if (score_rows_smem(f, vec) > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int fi = static_cast<int>(f);
  return vec ? launch_scores<true>(x, outer, inner, s_outer, s_inner, fi, w0,
                                   w_stride, b0, out, s)
             : launch_scores<false>(x, outer, inner, s_outer, s_inner, fi,
                                    w0, w_stride, b0, out, s);
}

extern "C" const char* choose_window_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
