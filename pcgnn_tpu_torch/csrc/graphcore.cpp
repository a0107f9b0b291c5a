// graphcore: the port's host-side CSR builder (plain C ABI, loaded with
// ctypes by pcgnn_tpu_torch/native.py).
//
// It computes what native/graphcore.cpp computes for the JAX package, from
// a COO edge list: optional symmetrization and self-loops, ids outside
// [0, N) dropped, duplicate (src, dst) pairs collapsed (the reference's
// adjacency sets), rows sorted.  The numpy version
// (graph/csr.py::csr_arrays_plain) sorts one global key array of E int64
// (src * N + dst) on one core.
//
// Design: a one-level radix partition, so that no pass writes to random
// places in a large array (a scatter straight into rows, as the JAX
// package's core does, takes a cache miss per edge).  Rows are cut into
// blocks of R = 2^k rows, R chosen so that a block holds about 2^16 raw
// entries (512 KB, an L2's worth).
//   1. Each thread counts its slice of the edges per block.
//   2. Each thread appends its edges to each block's region as one packed
//      key, (row - block base) << bits(N) | column, so that a block's keys
//      sort into CSR order.
//   3. Blocks are taken by the threads in turn: sort, dedupe, count each
//      row's distinct columns.
//   4. The prefix sum of the degrees gives indptr; each block writes its
//      columns to its rows' contiguous range of `col`.
// Host C++, not a GPU kernel: g++ -O3 -std=c++20 -fPIC -pthread -shared.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>

namespace {

// Below this many raw entries the build runs on the calling thread.
constexpr int64_t kSerialBelow = int64_t{1} << 16;
// log2 of the raw entries a block aims at.
constexpr int kBlockEntriesLog2 = 16;

int resolve_threads(int requested) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 1;
  return (requested <= 0 || requested > hw) ? hw : requested;
}

// fn(t) for t in [0, threads), one thread each.
template <typename Fn>
void on_threads(int threads, Fn&& fn) {
  if (threads <= 1) {
    fn(0);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back([&fn, t] { fn(t); });
  for (auto& th : pool) th.join();
}

inline bool in_range(int64_t v, int64_t n) { return v >= 0 && v < n; }

}  // namespace

extern "C" {

// Elements the caller must provide for `col` in gc_build_csr.
int64_t gc_csr_capacity(int64_t num_edges, int64_t num_nodes, int symmetrize,
                        int add_self_loops) {
  return num_edges * (symmetrize ? 2 : 1) + (add_self_loops ? num_nodes : 0);
}

// Deduplicated CSR of a COO edge list.
//
//   src, dst        [num_edges] int64; an edge with an end outside
//                   [0, num_nodes) is dropped
//   symmetrize      also insert (dst, src) for every edge
//   add_self_loops  insert (i, i) for every node
//   num_threads     <= 0: every hardware thread
//   indptr          out, [num_nodes + 1]
//   col             out, capacity >= gc_csr_capacity(...); its first
//                   indptr[num_nodes] entries are the column ids, sorted and
//                   distinct within each row
//
// Returns the edge count after deduplication, or -1 on invalid arguments.
int64_t gc_build_csr(const int64_t* src, const int64_t* dst,
                     int64_t num_edges, int64_t num_nodes, int symmetrize,
                     int add_self_loops, int num_threads, int64_t* indptr,
                     int64_t* col) {
  if (num_nodes < 0 || num_nodes > (int64_t{1} << 40) || num_edges < 0 ||
      !indptr || !col || (num_edges > 0 && (!src || !dst)))
    return -1;
  const int64_t n = num_nodes;
  const int64_t raw = gc_csr_capacity(num_edges, n, symmetrize,
                                      add_self_loops);
  const int threads = raw < kSerialBelow ? 1 : resolve_threads(num_threads);

  // key layout: a column takes `bits` bits, the row within its block the
  // `rbits` above them
  int bits = 1;
  while ((int64_t{1} << bits) < n) ++bits;
  int rbits = 0;
  while (rbits < 62 - bits &&
         (int64_t{2} << rbits) * std::max<int64_t>(raw, 1) <=
             (std::max<int64_t>(n, 1) << kBlockEntriesLog2))
    ++rbits;
  const int64_t rows_per_block = int64_t{1} << rbits;
  const int64_t blocks = std::max<int64_t>((n + rows_per_block - 1) >> rbits,
                                           1);
  const uint64_t col_mask = (uint64_t{1} << bits) - 1;
  const int64_t edge_slice = (num_edges + threads - 1) / threads;
  const int64_t node_slice = (n + threads - 1) / threads;

  // every entry of thread t's slice, as (row, column): edges, their reverse
  // copies, then the self-loops of its slice of the nodes
  auto for_entries = [&](int t, auto&& emit) {
    const int64_t lo = t * edge_slice;
    const int64_t hi = std::min(num_edges, lo + edge_slice);
    for (int64_t e = lo; e < hi; ++e) {
      const int64_t s = src[e], d = dst[e];
      if (!in_range(s, n) || !in_range(d, n)) continue;
      emit(s, d);
      if (symmetrize) emit(d, s);
    }
    if (add_self_loops) {
      const int64_t l = t * node_slice, h = std::min(n, l + node_slice);
      for (int64_t i = l; i < h; ++i) emit(i, i);
    }
  };

  // 1. entries per (thread, block)
  std::vector<int64_t> place(static_cast<size_t>(threads) * blocks, 0);
  on_threads(threads, [&](int t) {
    int64_t* c = place.data() + t * blocks;
    for_entries(t, [&](int64_t r, int64_t) { ++c[r >> rbits]; });
  });
  // block-major places: block b's region holds thread 0's entries, then
  // thread 1's, ...
  std::vector<int64_t> block_start(blocks + 1, 0);
  int64_t total = 0;
  for (int64_t b = 0; b < blocks; ++b) {
    block_start[b] = total;
    for (int t = 0; t < threads; ++t) {
      const int64_t k = place[t * blocks + b];
      place[t * blocks + b] = total;
      total += k;
    }
  }
  block_start[blocks] = total;

  // 2. packed keys into their blocks (default-initialized: all written)
  std::unique_ptr<uint64_t[]> keys(
      new uint64_t[static_cast<size_t>(std::max<int64_t>(total, 1))]);
  on_threads(threads, [&](int t) {
    int64_t* c = place.data() + t * blocks;
    uint64_t* k = keys.get();
    for_entries(t, [&](int64_t r, int64_t v) {
      k[c[r >> rbits]++] = (static_cast<uint64_t>(r & (rows_per_block - 1))
                            << bits) | static_cast<uint64_t>(v);
    });
  });

  // 3. per block: sort, dedupe, each row's distinct count into indptr[r+1]
  //    (a block's rows are its own, so blocks write disjoint entries)
  std::vector<int64_t> block_keys(blocks, 0);
  std::fill(indptr, indptr + n + 1, 0);
  std::atomic<int64_t> next{0};
  on_threads(threads, [&](int) {
    for (int64_t b; (b = next.fetch_add(1)) < blocks;) {
      uint64_t* lo = keys.get() + block_start[b];
      uint64_t* hi = keys.get() + block_start[b + 1];
      std::sort(lo, hi);
      uint64_t* end = std::unique(lo, hi);
      block_keys[b] = end - lo;
      int64_t* deg = indptr + (b << rbits) + 1;
      for (const uint64_t* p = lo; p < end; ++p) ++deg[*p >> bits];
    }
  });

  // 4. indptr, then each block's columns into its rows' range of col
  for (int64_t i = 0; i < n; ++i) indptr[i + 1] += indptr[i];
  next = 0;
  on_threads(threads, [&](int) {
    for (int64_t b; (b = next.fetch_add(1)) < blocks;) {
      const uint64_t* k = keys.get() + block_start[b];
      int64_t* out = col + indptr[std::min(n, b << rbits)];
      for (int64_t j = 0; j < block_keys[b]; ++j)
        out[j] = static_cast<int64_t>(k[j] & col_mask);
    }
  });
  return indptr[n];
}

// row[k] = r for indptr[r] <= k < indptr[r + 1].
void gc_expand_rows(const int64_t* indptr, int64_t num_nodes, int num_threads,
                    int64_t* row) {
  const int threads = num_nodes < kSerialBelow
                          ? 1 : resolve_threads(num_threads);
  const int64_t slice = (num_nodes + threads - 1) / threads;
  on_threads(threads, [&](int t) {
    const int64_t lo = t * slice, hi = std::min(num_nodes, lo + slice);
    for (int64_t r = lo; r < hi; ++r)
      std::fill(row + indptr[r], row + indptr[r + 1], r);
  });
}

}  // extern "C"
