// The training step's oversampled minors for Hopper (sm_90a), every
// relation of a step in one launch.  For each batch row b whose center is
// fraud-labeled (labels[b] == 1):
//
//     window   = the train positives sorted by selection score (sp, +inf at
//                invalid slots; `order` gives each one's slot): all P in the
//                dense form (chunk 0), else the 2C entries from r0 * C,
//                r0 = clamp(floor((searchsorted(sp, center[b]) - m_max) / C),
//                0, ceil(P / C) - 1), entries past P taken as +inf;
//     key      = (|center[b] - sp| in float32, slot), invalid where the
//                score or the distance is not finite;
//     cand[q]  = the window entry of the q-th smallest key, q < m_max;
//     take_r   = 0 on a hub row of relation r (deg_r > hub_cap_r), else
//                min(floor(float32(ksample_r) * rho), m_max);
//     minors_r = the valid cand[q], q < take_r, whose node id is none of
//                the relation's kept neighbors (keep_r[b, d] of ids nbr_r);
//     num_r[b] += the sum of their rows of `rows` [P, F] (by slot),
//     cnt_r[b] += their count.
//
// Rows of other labels add nothing.  This is, to the bit in its selection
// and its counts, the chain of PyTorch ops it replaces on the training
// step: ops/aggregate.py::oversample_candidates_values (a stable [P] sort,
// a searchsorted, [B, 2C] gathers and two stable [B, 2C] sorts, or a
// [B, P] sort in the dense form), then per relation oversample_keep, the
// hub mask, dedup_minor_keep (a [B, m, D] compare and its .any) and
// minor_sum_compact_multi (a [B, 128, F] gather and an einsum a block):
// some sixty kernels a step.  The plain version,
// ops/aggregate.py::oversample_minor_sums_plain, is that chain.  It
// replaces no Pallas kernel: the JAX package computes the same with XLA
// ops (pcgnn_tpu/ops/aggregate.py:347 oversample_candidates_values, :466
// oversample_keep, :551 dedup_minor_keep, :739 minor_sum_compact_multi).
//
// The caller sorts the train positives' scores once a step (the hub lane
// reads the same sort); everything after that sort is this launch.
//
// Bound: bytes, and few of them.  A fraud row reads its window's scores
// and slots (12 bytes an entry; 2C = 256 entries for the YelpChi and
// stress cells, Amazon's dense P about 330), at most m_max selected rows
// of F floats, each relation's kept ids and flags (5 bytes a slot) and its
// sums, and writes the sums back: about 6 MB a YelpChi step, 2 us at an
// H100 SXM's 3.35 TB/s, and 2 MB (under 1 us) an Amazon step.  Half of
// the rows are fraud centers, so the card holds every row at once, and a
// row's own latency sets the time.  Design:
//   - One block of 256 threads a row; a row that is not a fraud center,
//     or takes no minor in any relation, returns at once.
//   - The window's keys, 64-bit (distance bits, slot) (a non-negative
//     float orders as its bits; slots are distinct, so keys are), go to
//     shared memory; each thread ranks its own entries by counting the
//     smaller keys (broadcast reads, no barrier inside), and the entry of
//     rank q < m writes candidate q.  A sort of the window would take a
//     barrier a step, 36 steps at 256 entries, each some 500 cycles when
//     the SM is full (choose_window.cu); the count takes none.
//   - The dedup: each thread takes kept neighbor slots and clears the flag
//     of each candidate with the same id, relation by relation, over the
//     candidates that the relation takes.
//   - The sums: the block splits the candidates into one contiguous chunk
//     a group of F threads, each thread one feature, reads each candidate
//     row once for every relation, a flag (1.0 or 0.0) multiplying it, and
//     adds the chunks' partial sums in chunk order: no atomics, a fixed
//     order, so a replay repeats every bit.  The sums are added into the
//     relations' choose sums in place.
//   - A row's selection state (keys, candidates, flags) stays in shared
//     memory; where it would pass kStateBytes (windows of thousands of
//     entries), the wrapper gives a scratch row of device memory instead.
//   - slots_out / taken_out are test-only: the card test passes them to
//     hold each row's selected set to the chain's; the training step
//     passes null, and the kernel skips the write.
// One launch takes up to kMaxRel relations; the wrapper launches once for
// every kMaxRel.  Offsets are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRel = 4;
constexpr int kStateBytes = 44 * 1024;  // a row's selection state, at most
constexpr int kRelWords = 11;           // int64 words a relation's record
constexpr uint64_t kNone = ~uint64_t{0};

struct Rel {
  const int32_t* nbr;      // kept-neighbor ids: row batch[b] or b
  int64_t nbr_stride;
  int64_t by_batch;        // 1: nbr is the [N, d] table, read at batch[b]
  int64_t d;
  const uint8_t* keep;     // [B, d] at keep_stride
  int64_t keep_stride;
  const int32_t* ksample;  // [N]
  const int32_t* deg;      // [N]
  int64_t hub_cap;         // -1: no hub rows
  float* num;              // [B, f] contiguous, added into
  float* cnt;              // [B], added into
};

struct Args {
  Rel rel[kMaxRel];
  int nrel;
  int f;
  int m_max;
  float rho;
  int64_t p;
  int64_t chunk;           // C; 0: the dense form, the window is all P
  const float* center;     // [B]
  const int64_t* batch;    // [B]
  const int64_t* labels;   // [B]
  const float* sp;         // [P] scores sorted ascending, +inf at invalid
  const int64_t* order;    // [P] the slot of each sorted entry
  const int64_t* ids;      // [P] node id of each slot
  const float* rows;       // [P, f] at row_stride, by slot
  int64_t row_stride;
  int64_t state_bytes;     // a row's selection state
  int64_t off_ids;         // byte offsets into it: candidate ids,
  int64_t off_slots;       // slots
  int64_t off_flags;       // and flags [kMaxRel][m_max]
  int32_t* slots_out;      // test-only, else null: [B, m_max] slots
  uint8_t* taken_out;      // test-only, else null: [nrel, B, m_max] taken
  int64_t rows_b;          // B
};

__host__ __device__ inline int64_t round8(int64_t v) { return (v + 7) & ~7; }

// the window's widest entry count: all P, or 2C
inline int64_t window_of(int64_t p, int64_t chunk) {
  return chunk > 0 ? (2 * chunk < p ? 2 * chunk : p) : p;
}

template <bool kSpill>
__global__ void __launch_bounds__(kThreads)
oversample_minors_kernel(const Args a, unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  if (__ldg(a.labels + b) != 1) return;
  const int64_t node = __ldg(a.batch + b);
  int take[kMaxRel];
  int most = 0;
#pragma unroll
  for (int r = 0; r < kMaxRel; ++r) {
    take[r] = 0;
    if (r >= a.nrel) continue;
    const Rel& rl = a.rel[r];
    if (rl.hub_cap >= 0 && __ldg(rl.deg + node) > rl.hub_cap) continue;
    // floor(float32(ksample) * rho) in float32, as the plain version
    const float m = floorf(
        __fmul_rn(static_cast<float>(__ldg(rl.ksample + node)), a.rho));
    take[r] = m >= static_cast<float>(a.m_max) ? a.m_max
              : m > 0.0f                       ? static_cast<int>(m)
                                               : 0;
    most = max(most, take[r]);
  }
  if (most == 0) return;

  // the row's window of the sorted scores
  const float c = __ldg(a.center + b);
  int64_t base = 0;
  int64_t w = a.p;
  if (a.chunk > 0) {
    // torch.searchsorted's lower bound: the first entry not below c
    int64_t lo = 0, hi = a.p;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (!(__ldg(a.sp + mid) >= c)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int64_t x = lo - a.m_max;
    const int64_t last = (a.p + a.chunk - 1) / a.chunk - 1;
    const int64_t r0 = x < 0 ? 0 : min(x / a.chunk, last);
    base = r0 * a.chunk;
    w = min(2 * a.chunk, a.p - base);
  }
  const int wn = static_cast<int>(w);

  unsigned char* st = kSpill ? scratch + b * a.state_bytes : smem;
  auto* keys = reinterpret_cast<uint64_t*>(st);
  auto* cid = reinterpret_cast<int64_t*>(st + a.off_ids);
  auto* cslot = reinterpret_cast<int32_t*>(st + a.off_slots);
  auto* flags = reinterpret_cast<float*>(st + a.off_flags);
  auto* part = reinterpret_cast<float*>(smem + (kSpill ? 0 : a.state_bytes));

  int valid = 0;
  for (int i0 = 0; i0 < wn; i0 += kThreads) {
    const int i = i0 + t;
    bool ok = false;
    if (i < wn) {
      const float s = __ldg(a.sp + base + i);
      const float d = fabsf(c - s);
      ok = isfinite(s) && isfinite(d);
      keys[i] = ok ? (uint64_t{__float_as_uint(d)} << 32) |
                         static_cast<uint32_t>(__ldg(a.order + base + i))
                   : kNone;
    }
    valid += __syncthreads_count(ok);
  }
  const int nsel = min(valid, most);
  if (nsel == 0) return;

  // each entry's rank among the window's keys; ranks under nsel are the
  // candidates, in (distance, slot) order
  for (int i = t; i < wn; i += kThreads) {
    const uint64_t k = keys[i];
    if (k == kNone) continue;
    int rank = 0;
#pragma unroll 8
    for (int j = 0; j < wn; ++j) rank += keys[j] < k;
    if (rank < nsel) {
      const auto slot = static_cast<int32_t>(k & 0xffffffffu);
      cslot[rank] = slot;
      cid[rank] = __ldg(a.ids + slot);
    }
  }
  for (int q = t; q < nsel; q += kThreads) {
#pragma unroll
    for (int r = 0; r < kMaxRel; ++r) {
      if (r < a.nrel) flags[r * a.m_max + q] = q < take[r] ? 1.0f : 0.0f;
    }
  }
  __syncthreads();

  // drop each relation's candidates that are kept neighbors of the row
#pragma unroll
  for (int r = 0; r < kMaxRel; ++r) {
    const int lim = min(take[r], nsel);
    if (r >= a.nrel || lim == 0) continue;
    const Rel& rl = a.rel[r];
    const int32_t* ids = rl.nbr + (rl.by_batch ? node : b) * rl.nbr_stride;
    const uint8_t* kept = rl.keep + b * rl.keep_stride;
    float* fr = flags + r * a.m_max;
    for (int64_t i = t; i < rl.d; i += kThreads) {
      if (!__ldg(kept + i)) continue;
      const int64_t id = __ldg(ids + i);
      for (int q = 0; q < lim; ++q) {
        if (cid[q] == id) fr[q] = 0.0f;
      }
    }
  }
  __syncthreads();
  if (a.slots_out != nullptr) {
    // a test's view: each candidate's slot and each relation's flags
    for (int q = t; q < nsel; q += kThreads) {
      a.slots_out[b * a.m_max + q] = cslot[q];
      for (int r = 0; r < a.nrel; ++r) {
        a.taken_out[(r * a.rows_b + b) * a.m_max + q] =
            flags[r * a.m_max + q] != 0.0f;
      }
    }
  }

  // the kept minors' rows, a fixed order: a chunk of candidates a group of
  // f threads, each thread a feature, then the groups' sums in order
  const int f = a.f;
  const bool wide = f > kThreads;
  const int groups = wide ? 1 : kThreads / f;
  const int g = wide ? 0 : t / f;
  if (g < groups) {
    const int chunk = (nsel + groups - 1) / groups;
    const int lo = g * chunk;
    const int hi = min(nsel, lo + chunk);
    for (int col = wide ? t : t % f; col < f; col += wide ? kThreads : f) {
      float acc[kMaxRel] = {};
      for (int q = lo; q < hi; ++q) {
        const float v = __ldg(a.rows + int64_t{cslot[q]} * a.row_stride + col);
#pragma unroll
        for (int r = 0; r < kMaxRel; ++r) {
          if (r < a.nrel) acc[r] = fmaf(v, flags[r * a.m_max + q], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRel; ++r) {
        if (r >= a.nrel) continue;
        if (wide) {
          a.rel[r].num[b * f + col] += acc[r];
        } else {
          part[r * kThreads + g * f + col] = acc[r];
        }
      }
    }
  }
  if (!wide) {
    __syncthreads();
    if (t < f) {
#pragma unroll
      for (int r = 0; r < kMaxRel; ++r) {
        if (r >= a.nrel) continue;
        const float* pr = part + r * kThreads;
        float s = pr[t];
        for (int gg = 1; gg < groups; ++gg) s += pr[gg * f + t];
        a.rel[r].num[b * f + t] += s;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxRel; ++r) {
    if (r >= a.nrel || t != r) continue;
    const float* fr = flags + r * a.m_max;
    const int lim = min(take[r], nsel);
    float n = 0.0f;
    for (int q = 0; q < lim; ++q) n += fr[q];
    a.rel[r].cnt[b] += n;
  }
}

// a row's selection state: keys [w], candidate ids [m] (int64), slots [m]
// (int32), flags [kMaxRel][m] (float32), each region 8-byte aligned
void layout(int64_t w, int64_t m, Args* a) {
  a->off_ids = round8(w * 8);
  a->off_slots = a->off_ids + m * 8;
  a->off_flags = a->off_slots + round8(m * 4);
  a->state_bytes = round8(a->off_flags + int64_t{kMaxRel} * m * 4);
}

}  // namespace

// The bytes of scratch a row that a launch over a window of up to `w`
// entries and m_max candidates needs, where its selection state would not
// fit kStateBytes of shared memory; 0 where it fits, and no scratch is
// read.  `chunk` is C, or 0 for the dense form.
extern "C" int64_t oversample_minors_scratch(int64_t p, int64_t chunk,
                                             int64_t m_max) {
  Args a{};
  layout(window_of(p, chunk), m_max, &a);
  return a.state_bytes > kStateBytes ? a.state_bytes : 0;
}

// The relations a launch takes at most.
extern "C" int oversample_minors_max_relations() { return kMaxRel; }

// Launches on `stream` over `rows` batch rows and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for more than
// kMaxRel relations or a spilling shape without scratch.  `rel_words` holds
// kRelWords int64 words a relation, in Rel's order (pointers as integers).
// The caller has checked: center [rows] float32, batch and labels [rows]
// int64, sp [p] float32 ascending with +inf at invalid slots, order and
// ids [p] int64, all contiguous; table [p, f] float32 with unit column
// stride at row_stride; each relation's nbr int32 with unit column stride
// (rows of the batch, or of the node table read at batch[b]), keep
// [rows, d] bool with unit column stride, ksample and deg [N] int32, num
// [rows, f] and cnt [rows] float32 contiguous; scratch null or [rows,
// oversample_minors_scratch(p, chunk, m_max)] bytes, 8-byte aligned;
// slots null or [rows, m_max] int32 and taken [nrel, rows, m_max] bool,
// contiguous, which receive each worked row's candidates' slots and each
// relation's flags of the minors it took, for q < the candidates the row
// selected (a test's view); 0 < rows, 0 < f, 0 < m_max, p < 2^31.
extern "C" int oversample_minors(const int64_t* rel_words, int nrel,
                                 int64_t rows, int64_t f, const float* center,
                                 const int64_t* batch, const int64_t* labels,
                                 const float* sp, const int64_t* order,
                                 const int64_t* ids, const float* table,
                                 int64_t row_stride, int64_t p, int64_t chunk,
                                 int64_t m_max, float rho,
                                 unsigned char* scratch, int32_t* slots,
                                 uint8_t* taken, void* stream) {
  if (nrel < 1 || nrel > kMaxRel) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  for (int r = 0; r < nrel; ++r) {
    const int64_t* v = rel_words + r * kRelWords;
    Rel& rl = a.rel[r];
    rl.nbr = reinterpret_cast<const int32_t*>(v[0]);
    rl.nbr_stride = v[1];
    rl.by_batch = v[2];
    rl.d = v[3];
    rl.keep = reinterpret_cast<const uint8_t*>(v[4]);
    rl.keep_stride = v[5];
    rl.ksample = reinterpret_cast<const int32_t*>(v[6]);
    rl.deg = reinterpret_cast<const int32_t*>(v[7]);
    rl.hub_cap = v[8];
    rl.num = reinterpret_cast<float*>(v[9]);
    rl.cnt = reinterpret_cast<float*>(v[10]);
  }
  a.nrel = nrel;
  a.f = static_cast<int>(f);
  a.m_max = static_cast<int>(m_max);
  a.rho = rho;
  a.p = p;
  a.chunk = chunk;
  a.center = center;
  a.batch = batch;
  a.labels = labels;
  a.sp = sp;
  a.order = order;
  a.ids = ids;
  a.rows = table;
  a.row_stride = row_stride;
  a.slots_out = slots;
  a.taken_out = taken;
  a.rows_b = rows;
  layout(window_of(p, chunk), m_max, &a);
  const bool spill = a.state_bytes > kStateBytes;
  if (spill && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t part = sizeof(float) * kMaxRel * kThreads;
  const auto grid = static_cast<unsigned>(rows);
  if (spill) {
    oversample_minors_kernel<true><<<grid, kThreads, part, s>>>(a, scratch);
  } else {
    oversample_minors_kernel<false><<<grid, kThreads, a.state_bytes + part,
                                      s>>>(a, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* oversample_minors_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
