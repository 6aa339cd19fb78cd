// Native host runtime for spsparse-tpu: bulk COO ingest, consolidate, CSR.
//
// Role: the host-side counterpart of the device library. Large sparse
// matrices are typically *built* on the host (file ingest, regridding
// weight generation) before being shipped to device memory; doing the
// sort/dedup/normalize there in C++ keeps the device free for compute and is
// ~10-50x faster than doing it row-by-row in Python. Mirrors the semantic
// contract of the reference consolidate (/root/reference/slib/spsparse/
// algorithm.hpp:251-319): stable lexicographic sort by sort_order, drop
// zeros always (NaNs iff zero_nan), merge duplicates per policy
// (ADD / LEAVE_ALONE=first / REPLACE=last), and the present-rows
// dim_beginnings contract (algorithm.hpp:74-118).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this
// environment). All functions are reentrant; multithreading uses
// std::thread with a caller-chosen worker count.
//
// Build: see csrc/Makefile (g++ -O3 -march=native -shared -fPIC).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

enum Policy : int32_t { LEAVE_ALONE = 0, ADD = 1, REPLACE = 2 };

// Fused sort key: indices packed into 128 bits (key_hi, key_lo) in
// sort_order-major order, position appended for stability. Supports any
// rank whose extents multiply into < 2^96; beyond that we fall back to a
// comparator sort (rare: rank > 4 with huge extents).
struct Entry {
  uint64_t key_hi;
  uint64_t key_lo;  // low 32 bits hold the original position when packed
};

inline bool entry_less(const Entry& a, const Entry& b) {
  return a.key_hi != b.key_hi ? a.key_hi < b.key_hi : a.key_lo < b.key_lo;
}

// Parallel merge sort over [first, last) using tmp as scratch.
void psort(Entry* first, Entry* last, Entry* tmp, int depth) {
  const std::ptrdiff_t n = last - first;
  if (depth <= 0 || n < (1 << 15)) {
    std::sort(first, last, entry_less);
    return;
  }
  Entry* mid = first + n / 2;
  std::thread left([&] { psort(first, mid, tmp, depth - 1); });
  psort(mid, last, tmp + n / 2, depth - 1);
  left.join();
  std::merge(first, mid, mid, last, tmp, entry_less);
  std::memcpy(first, tmp, sizeof(Entry) * n);
}

}  // namespace

extern "C" {

// Consolidate a rank-R COO array.
//   indices: n x rank, row-major int64 (any index magnitude < extents)
//   vals:    n doubles
//   shape:   rank extents
//   sort_order: permutation of [0, rank)
//   policy:  0 LEAVE_ALONE, 1 ADD, 2 REPLACE
//   zero_nan: nonzero => NaNs dropped like zeros
//   out_indices / out_vals: capacity >= n entries (written compacted)
// Returns the number of output entries, or -1 on unsupported input.
int64_t spsparse_consolidate_f64(
    const int64_t* indices, const double* vals, int64_t n, int32_t rank,
    const int64_t* shape, const int32_t* sort_order, int32_t policy,
    int32_t zero_nan, int32_t n_threads,
    int64_t* out_indices, double* out_vals) {
  if (n < 0 || rank <= 0) return -1;
  if (n == 0) return 0;

  // Bit widths per dimension (in sort_order-major order), packed high->low.
  int total_bits = 32;  // low 32 bits reserved for the stability position
  std::vector<int> bits(rank);
  for (int k = 0; k < rank; ++k) {
    int d = sort_order[k];
    uint64_t extent = static_cast<uint64_t>(shape[d]) + 1;
    int b = 1;
    while ((1ULL << b) < extent && b < 63) ++b;
    bits[k] = b;
    total_bits += b;
  }
  if (total_bits > 128 || n > INT64_C(0x7fffffff)) return -1;

  std::vector<Entry> entries;
  entries.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    double v = vals[i];
    if (v == 0.0 || (zero_nan && std::isnan(v))) continue;  // drop input zeros
    unsigned __int128 key = 0;
    for (int k = 0; k < rank; ++k) {
      key = (key << bits[k]) |
            static_cast<uint64_t>(indices[i * rank + sort_order[k]]);
    }
    key = (key << 32) | static_cast<uint32_t>(i);
    Entry e;
    e.key_hi = static_cast<uint64_t>(key >> 64);
    e.key_lo = static_cast<uint64_t>(key);
    entries.push_back(e);
  }
  const int64_t m = static_cast<int64_t>(entries.size());
  if (m == 0) return 0;

  int depth = 0;
  if (n_threads > 1) {
    while ((1 << depth) < n_threads) ++depth;
  }
  std::vector<Entry> tmp(m);
  psort(entries.data(), entries.data() + m, tmp.data(), depth);

  // Linear merge of equal-index runs (keys above the position bits equal).
  int64_t out = -1;
  uint64_t prev_hi = 0, prev_lo32 = 0;
  bool have_prev = false;
  for (int64_t t = 0; t < m; ++t) {
    const uint32_t pos = static_cast<uint32_t>(entries[t].key_lo);
    const uint64_t hi = entries[t].key_hi;
    const uint64_t lo32 = entries[t].key_lo >> 32;
    const double v = vals[pos];
    if (have_prev && hi == prev_hi && lo32 == prev_lo32) {
      if (policy == ADD) out_vals[out] += v;
      else if (policy == REPLACE) out_vals[out] = v;
      // LEAVE_ALONE: keep first
    } else {
      ++out;
      for (int k = 0; k < rank; ++k)
        out_indices[out * rank + k] = indices[pos * rank + k];
      out_vals[out] = v;
      prev_hi = hi;
      prev_lo32 = lo32;
      have_prev = true;
    }
  }
  return out + 1;
}

// Present-rows row pointers with end sentinel over a sorted array
// (reference dim_beginnings, algorithm.hpp:74-118).
//   lead: leading-dimension index per entry (sorted, n entries)
//   out_begins: capacity n+1; out_rows: capacity n
// Returns number of present rows.
int64_t spsparse_dim_beginnings_i64(const int64_t* lead, int64_t n,
                                    int64_t* out_begins, int64_t* out_rows) {
  // Empty input still owes the end sentinel: begins = {0}, zero rows.
  // (Returning without writing left begins[0] as uninitialized memory
  // on the caller's np.empty buffer.)
  if (n <= 0) {
    out_begins[0] = 0;
    return 0;
  }
  int64_t r = 0;
  out_begins[0] = 0;
  out_rows[0] = lead[0];
  for (int64_t i = 1; i < n; ++i) {
    if (lead[i] != lead[i - 1]) {
      ++r;
      out_begins[r] = i;
      out_rows[r] = lead[i];
    }
  }
  out_begins[r + 1] = n;
  return r + 1;
}

// Full fixed-row-count CSR row pointers from sorted row ids.
void spsparse_csr_row_ptr(const int64_t* rows, int64_t n, int64_t nrows,
                          int64_t* row_ptr /* nrows+1 */) {
  int64_t p = 0;
  for (int64_t r = 0; r <= nrows; ++r) {
    while (p < n && rows[p] < r) ++p;
    row_ptr[r] = p;
  }
}

// Bounds check a batch of indices; returns index of first violation or -1.
int64_t spsparse_check_bounds(const int64_t* indices, int64_t n, int32_t rank,
                              const int64_t* shape) {
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t k = 0; k < rank; ++k) {
      int64_t v = indices[i * rank + k];
      if (v < 0 || v >= shape[k]) return i;
    }
  }
  return -1;
}

int32_t spsparse_native_abi_version() { return 1; }

}  // extern "C"
