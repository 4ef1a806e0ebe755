// Native host runtime of tmgcn_torch (the port of tmgcn_tpu/native).
//
// The host-side work around the device path, in C++: negative-edge
// rejection sampling for link prediction, windowed chunk packing for the
// segment-matmul kernels, and raw edge-list parsing. A plain C interface,
// loaded with ctypes (tmgcn_torch/native/__init__.py). The C interfaces and
// the streams they produce are those of tmgcn_tpu/native/tmgcn_native.cpp,
// entry point for entry point; the numpy versions in the callers are the
// plain versions that the tests hold these against.
//
// Build: python -m tmgcn_torch.native.build   (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unordered_set>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// splitmix64: small, fast, seedable PRNG (public-domain algorithm).
// ---------------------------------------------------------------------------
static inline uint64_t splitmix64(uint64_t* state) {
  uint64_t z = (*state += 0x9e3779b97f4a7c15ull);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

static inline int64_t uniform_below(uint64_t* state, int64_t n) {
  // Plain modulo: n << 2^64, so the bias is negligible for fake edges.
  return (int64_t)(splitmix64(state) % (uint64_t)n);
}

// ---------------------------------------------------------------------------
// Negative-edge sampling for one time slice.
//
// Draw `to_add` uniform (src, dst) pairs that do not collide with any of
// the `n_real` real edges (given as src * n_nodes + dst keys). Draws
// alternate src and dst; a pair on a real key is rejected. Duplicate fakes
// and self-loops are allowed, as in the reference sampler
// (TensorGCN-master/embedding_help_functions.py:500-526).
// ---------------------------------------------------------------------------
void tmgcn_sample_negatives(const int64_t* real_keys, int64_t n_real,
                            int64_t n_nodes, int64_t to_add, uint64_t seed,
                            int32_t* out_src, int32_t* out_dst) {
  std::unordered_set<int64_t> real(real_keys, real_keys + n_real);
  uint64_t state = seed ^ 0xda3e39cb94b95bdbull;
  int64_t added = 0;
  while (added < to_add) {
    int64_t s = uniform_below(&state, n_nodes);
    int64_t d = uniform_below(&state, n_nodes);
    if (real.find(s * n_nodes + d) == real.end()) {
      out_src[added] = (int32_t)s;
      out_dst[added] = (int32_t)d;
      added++;
    }
  }
}

// ---------------------------------------------------------------------------
// Windowed chunk packing for the segment-matmul kernels.
//
// Input: COO entries whose window ids rows[i] / window never decrease.
// Chunks of at most `chunk` entries are cut so that no chunk crosses a
// `window`-aligned row boundary; every window in [0, n_windows) gets at
// least one chunk (an empty one if no entry falls in it). Two passes:
// count, then fill (out arrays sized n_chunks x chunk).
// ---------------------------------------------------------------------------
int64_t tmgcn_pack_count(const int64_t* rows, int64_t n, int64_t window,
                         int64_t chunk, int64_t n_windows) {
  std::vector<uint8_t> touched((size_t)n_windows, 0);
  int64_t n_chunks = 0;
  int64_t start = 0;
  while (start < n) {
    int64_t w = rows[start] / window;
    touched[(size_t)w] = 1;
    int64_t end = start;
    int64_t limit = start + chunk < n ? start + chunk : n;
    while (end < limit && rows[end] / window == w) end++;
    n_chunks++;
    start = end;
  }
  for (int64_t w = 0; w < n_windows; w++)
    if (!touched[(size_t)w]) n_chunks++;
  return n_chunks;
}

void tmgcn_pack_fill(const int64_t* rows, const int64_t* cols,
                     const double* vals, int64_t n, int64_t window,
                     int64_t chunk, int64_t n_windows, int64_t n_chunks,
                     int32_t* out_rows, int32_t* out_cols, double* out_vals,
                     int32_t* out_wid, int32_t* out_first) {
  // The chunks with entries in stream order (already by window), noting
  // which windows they touch.
  std::vector<uint8_t> touched((size_t)n_windows, 0);
  struct Span { int64_t start, end, wid; };
  std::vector<Span> spans;
  spans.reserve((size_t)n_chunks);
  int64_t start = 0;
  while (start < n) {
    int64_t w = rows[start] / window;
    touched[(size_t)w] = 1;
    int64_t end = start;
    int64_t limit = start + chunk < n ? start + chunk : n;
    while (end < limit && rows[end] / window == w) end++;
    spans.push_back({start, end, w});
    start = end;
  }
  for (int64_t w = 0; w < n_windows; w++)
    if (!touched[(size_t)w]) spans.push_back({0, 0, w});

  // A stable sort by window merges the empty windows' chunks in.
  std::stable_sort(spans.begin(), spans.end(),
                   [](const Span& a, const Span& b) { return a.wid < b.wid; });

  int64_t prev_w = -1;
  for (int64_t j = 0; j < (int64_t)spans.size(); j++) {
    const Span& sp = spans[(size_t)j];
    int64_t base = sp.wid * window;
    int64_t k = sp.end - sp.start;
    for (int64_t i = 0; i < chunk; i++) {
      if (i < k) {
        out_rows[j * chunk + i] = (int32_t)(rows[sp.start + i] - base);
        out_cols[j * chunk + i] = (int32_t)cols[sp.start + i];
        out_vals[j * chunk + i] = vals[sp.start + i];
      } else {
        out_rows[j * chunk + i] = 0;
        out_cols[j * chunk + i] = 0;
        out_vals[j * chunk + i] = 0.0;
      }
    }
    out_wid[j] = (int32_t)sp.wid;
    out_first[j] = sp.wid != prev_w ? 1 : 0;
    prev_w = sp.wid;
  }
}

// ---------------------------------------------------------------------------
// Raw edge-list parsing: delimiter-or-whitespace separated numeric rows.
//
// Selected columns are written row-major into `out` (n_rows x n_sel).
// Pass out = nullptr to count data rows. The first `skiprows` physical
// lines, blank lines and lines starting with `comment` are ignored, and so
// is a row with fewer numeric fields than the largest selected column.
// ---------------------------------------------------------------------------
int64_t tmgcn_parse_edges(const char* path, const int32_t* col_idx,
                          int32_t n_sel, char delimiter, int32_t skiprows,
                          char comment, double* out, int64_t max_rows) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char* line = nullptr;
  size_t cap = 0;
  int64_t n_rows = 0;
  int32_t skipped = 0;
  int32_t max_col = 0;
  for (int32_t i = 0; i < n_sel; i++)
    if (col_idx[i] > max_col) max_col = col_idx[i];
  std::vector<double> fields((size_t)max_col + 1);

  ssize_t len;
  while ((len = getline(&line, &cap, f)) != -1) {
    // skiprows counts physical lines (numpy.loadtxt semantics).
    if (skipped < skiprows) {
      skipped++;
      continue;
    }
    char* p = line;
    while (*p == ' ' || *p == '\t') p++;
    if (*p == '\0' || *p == '\n' || *p == comment) continue;
    // Fields are split by the delimiter and by any whitespace.
    int32_t col = 0;
    char* q = p;
    while (col <= max_col && *q && *q != '\n') {
      char* endp;
      double v = strtod(q, &endp);
      if (endp == q) break;
      fields[(size_t)col++] = v;
      q = endp;
      while (*q == delimiter || *q == ' ' || *q == '\t') q++;
    }
    if (col <= max_col) continue;  // malformed row: skipped
    if (out) {
      if (n_rows >= max_rows) break;
      for (int32_t i = 0; i < n_sel; i++)
        out[n_rows * n_sel + i] = fields[(size_t)col_idx[i]];
    }
    n_rows++;
  }
  free(line);
  fclose(f);
  return n_rows;
}

}  // extern "C"
