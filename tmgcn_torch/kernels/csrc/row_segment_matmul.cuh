// The row-walking kernel of K1 and K3 for Hopper (sm_90a), shared by
// windowed_segment_matmul.cu (K1) and windowed_tiled_segment_matmul.cu (K3).
//
// Both compute, over a windowed chunk packing (tmgcn_torch/kernels/spmm_cuda.py),
//
//   out[w*W + r, f] = sum over chunks j of window w, in chunk order, of
//                     sum over entries c, in entry order, with rows[j,c] == r,
//                     of vals[j,c] * x(j, c, f)
//
// with x(j, c, f) = gathered[j, c, f] (K1) or gathered[j, uidx[j,c], f] (K3,
// the entry's row of its chunk's distinct-tile block). The packer also builds
// a row index of the real entries: entry_order lists their flat slot ids
// j*C + c grouped by global output row, in chunk then entry order within a
// row (the order above), and row r's entries are
// entry_order[row_ptr[r] : row_ptr[r + 1]]. Padding slots (value 0) add 0 to
// no sum and are not indexed.
//
// What bounds it on this card: bytes, in principle. The sums need each real
// entry's index, value and F features once (K3: its tile index too) and each
// output element written once; the arithmetic is one multiply and one add per
// entry and feature. In practice the chess rows are short (mean 4-16 entries,
// longest 83), every entry costs two or three dependent loads (slot id, then
// value and features or tile index), and the longest rows of a launch set its
// time: latency, not bandwidth, is what is left to hide.
//
// Design. The work and the parallelism follow the entries, not the windows:
// one thread owns FT consecutive features of one output row (FT = 4, 2 or 1,
// the widest that divides F, so F = 6 runs as 3 threads a row and nothing is
// padded), and the grid covers every (row, feature group), so even 20,203
// rows put ~14 warps on each SM. The thread walks its row's entries in index
// order, kUnroll at a time: it issues the kUnroll slot-id loads, then their
// value and feature loads, before the first add, so that a long row pays one
// round trip per kUnroll entries rather than one per entry. No load is
// guarded: with guards the compiler put each entry's loads of the bf16 tier
// in a branch with the value's conversion right behind them, which
// serialised the entries' round trips. The adds stay in index order, one
// thread per output element: bitwise repeatable, no float atomics, and the
// same order as K2's window scan, so K2 is K1 transposed bit for bit. Rows
// of a window that owns a chunk are written, 0 where the row has no entry;
// rows of a window without a chunk only when write_empty (else the caller's
// init keeps them). No loop visits a chunk's slots: the work is nnz * F / FT
// loop steps in all, rounded up to kUnroll entries a row.
//
// Tiers (tiers.cuh): float32, and bf16 (the value rounded to bf16, each
// product rounded to bf16, float32 sums and output).
#pragma once

#include <cuda_runtime.h>

#include "tiers.cuh"

namespace row_segment {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

template <int FT, bool kTiled, typename TIn>
__global__ void __launch_bounds__(kThreads) row_segment_matmul_kernel(
    const int* __restrict__ entry_order,  // (nnz,) flat slot ids by output row
    const int* __restrict__ row_ptr,      // (n_rows_out + 1,)
    const int* __restrict__ uidx,         // K3: (J, chunk) rows of the tile block
    const float* __restrict__ vals,       // (J, chunk)
    const TIn* __restrict__ gathered,     // K1 (J, chunk, n_feat); K3 (J, u8, n_feat)
    const int* __restrict__ window_ptr,   // (n_windows + 1) chunk offsets
    float* __restrict__ out,              // (n_rows_out, n_feat)
    int n_rows_out, int chunk, int u8, int n_feat, int window, int write_empty) {
  const int groups = n_feat / FT;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = t / groups;
  if (row >= n_rows_out) return;
  const int f0 = static_cast<int>(t - row * groups) * FT;
  if (!write_empty) {
    const long long w = row / window;
    if (window_ptr[w] == window_ptr[w + 1]) return;  // the caller's init keeps it
  }
  const int lo = row_ptr[row];
  const int hi = row_ptr[row + 1];

  float acc[FT];
#pragma unroll
  for (int k = 0; k < FT; ++k) acc[k] = 0.0f;

  for (int e0 = lo; e0 < hi; e0 += kUnroll) {
    // Every load of the round is issued before any arithmetic, and none is
    // under a branch: past the row's end a slot repeats the row's last entry
    // (a cache hit) and its product is masked to +0, which leaves the sum
    // unchanged (it starts at +0 and, rounding to nearest, is never -0).
    int slot[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) slot[u] = entry_order[min(e0 + u, hi - 1)];
    float v[kUnroll];
    TIn g[kUnroll][FT];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = slot[u];
      size_t src = static_cast<size_t>(s);
      if (kTiled) src = static_cast<size_t>(s / chunk) * u8 + uidx[s];
      v[u] = vals[s];
      const TIn* x = gathered + src * n_feat + f0;
#pragma unroll
      for (int k = 0; k < FT; ++k) g[u][k] = x[k];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = e0 + u < hi;
      const float vu = Tier<TIn>::round(v[u]);  // the value in the gather's type
#pragma unroll
      for (int k = 0; k < FT; ++k) {
        // Product rounded first (to the tier's type), then added: no fused
        // multiply-add, so the sum matches the plain version's
        // scaled-then-summed order.
        const float prod = Tier<TIn>::round(__fmul_rn(vu, Tier<TIn>::load(g[u][k])));
        acc[k] = __fadd_rn(acc[k], live ? prod : 0.0f);
      }
    }
  }
  float* o = out + row * n_feat + f0;
#pragma unroll
  for (int k = 0; k < FT; ++k) o[k] = acc[k];
}

template <int FT, bool kTiled, typename TIn>
cudaError_t launch(const int* entry_order, const int* row_ptr, const int* uidx,
                   const float* vals, const TIn* gathered, const int* window_ptr, float* out,
                   int n_rows_out, int chunk, int u8, int n_feat, int window, int write_empty,
                   cudaStream_t stream) {
  const long long threads = static_cast<long long>(n_rows_out) * (n_feat / FT);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  row_segment_matmul_kernel<FT, kTiled, TIn><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      entry_order, row_ptr, uidx, vals, gathered, window_ptr, out, n_rows_out, chunk, u8,
      n_feat, window, write_empty);
  return cudaGetLastError();
}

// One launch for any F: the widest feature group of 4, 2 or 1 that divides it.
template <bool kTiled, typename TIn>
int dispatch(const void* entry_order, const void* row_ptr, const void* uidx, const void* vals,
             const void* gathered, const void* window_ptr, void* out, int n_rows_out, int chunk,
             int u8, int n_feat, int window, int write_empty, void* stream) {
  if (n_rows_out <= 0) return cudaSuccess;
  if (n_feat <= 0 || window <= 0 || n_rows_out % window != 0 ||
      (kTiled && (chunk <= 0 || u8 <= 0)))
    return cudaErrorInvalidValue;
  const int* eo = static_cast<const int*>(entry_order);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* ui = static_cast<const int*>(uidx);
  const float* v = static_cast<const float*>(vals);
  const TIn* g = static_cast<const TIn*>(gathered);
  const int* wp = static_cast<const int*>(window_ptr);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_feat % 4 == 0)
    return launch<4, kTiled, TIn>(eo, rp, ui, v, g, wp, o, n_rows_out, chunk, u8, n_feat, window,
                                  write_empty, s);
  if (n_feat % 2 == 0)
    return launch<2, kTiled, TIn>(eo, rp, ui, v, g, wp, o, n_rows_out, chunk, u8, n_feat, window,
                                  write_empty, s);
  return launch<1, kTiled, TIn>(eo, rp, ui, v, g, wp, o, n_rows_out, chunk, u8, n_feat, window,
                                write_empty, s);
}

}  // namespace row_segment
