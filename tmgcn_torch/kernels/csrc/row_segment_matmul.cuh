// The row-walking kernel of K1, K2 and K3 for Hopper (sm_90a), shared by
// windowed_segment_matmul.cu (K1, K2) and windowed_tiled_segment_matmul.cu (K3).
//
// All three compute, over a windowed chunk packing (tmgcn_torch/kernels/spmm_cuda.py),
//
//   out[w*W + r, f] = sum over chunks j of window w, in chunk order, of
//                     sum over entries c, in entry order, with rows[j,c] == r,
//                     of vals[j,c] * x(j, c, f)
//
// with x(j, c, f) = gathered[j, c, f] (K1), gathered[j, uidx[j,c], f] (K3,
// the entry's row of its chunk's distinct-tile block) or gathered_t[j, f, c]
// (K2, the lane-major layout, which also stores out transposed:
// out_t[f, w*W + r]). The packer also builds a row index of the real
// entries: entry_order lists their flat slot ids j*C + c grouped by global
// output row, in chunk then entry order within a row (the order above), and
// row r's entries are entry_order[row_ptr[r] : row_ptr[r + 1]]. Padding slots
// (value 0) add 0 to no sum and are not indexed.
//
// What bounds it on this card: bytes, in principle. The sums need each real
// entry's index, value and F features once (K3: its tile index too), row_ptr
// once and each output element written once; the arithmetic is one multiply
// and one add per entry and feature. In practice every entry costs two or
// three dependent loads (slot id, then value and features or tile index)
// after the row's row_ptr load, so latency is what is left to hide: on the
// chess shapes (rows of 4-16 entries, longest 83) the longest rows set a
// launch's time; on the WD-GCN scale plan (K2: 2M entries in 32M rows, ~1 in
// 16 rows holds one) nearly every warp waits for one such chain, and the
// number of warps resident on an SM sets how many chains are in flight.
//
// Design. The work and the parallelism follow the entries, not the windows:
// one thread owns FT features of one output row, and the grid covers every
// (row, feature group), so even 20,203 rows put ~14 warps on each SM. The
// thread walks its row's entries in index order, kRound at a time: it issues
// the kRound slot-id loads, then their value and feature loads, before the
// first add, so that a long row pays one round trip per kRound entries
// rather than one per entry. No load is guarded: with guards the compiler put
// each entry's loads of the bf16 tier in a branch with the value's
// conversion right behind them, which serialised the entries' round trips.
// The adds stay in index order, one thread per output element: bitwise
// repeatable, no float atomics, and the same order in every layout, so K2 is
// K1 transposed bit for bit. Rows of a window that owns a chunk are written,
// 0 where the row has no entry; rows of a window without a chunk only when
// write_empty (else the caller's init keeps them). No loop visits a chunk's
// slots: the work is nnz * F / FT loop steps in all, rounded up to kRound
// entries a row.
//
// The two layouts map threads differently.
//  * Row-major (K1, K3; out (n_rows_out, F)): thread t owns row t / groups
//    and the FT consecutive features (t % groups) * FT, with FT = 4, 2 or 1,
//    the widest that divides F (F = 6 runs as 3 threads a row, unpadded), so
//    a warp's stores cover consecutive bytes. kRound = kUnroll = 8.
//  * Lane-major (K2; gathered_t (J, F, C), out (F, n_rows_out)): that mapping
//    would scatter each warp's stores over the F feature planes. Here
//    consecutive lanes own consecutive rows of one feature group
//    (blockIdx.y), so each feature's store is one coalesced line per warp;
//    FT is the largest divisor of F up to 8, so F <= 8 is one group holding
//    every feature in registers and each entry's slot id and value are read
//    once, not once per group. In the sorted readout plan consecutive rows
//    read near-consecutive slots, and a slot's features sit C apart, so the
//    feature loads coalesce too. Its one user's rows hold at most 4 entries,
//    most none or one, so a round of 8 only costs registers: 64 a thread at
//    F = 6 (half the SM's warps, so half the chains in flight) against 32
//    (all 64 warps) for a round of 1, which also issues no repeated loads
//    past a row's end: kRound = kLaneMajorRound = 1.
//
// Tiers (tiers.cuh), a tag type each: float32; bf16 (the value rounded to
// bf16, each product rounded to bf16, float32 sums and output); and the fast
// tiers of K1 and K3 (float32 input at the TPU's DEFAULT matrix precision),
// which round as tiers.cuh says. K2 has the float32 tier only: its one JAX
// caller, the readout plan (tmgcn_tpu/ops/edge_readout.py:230), runs at
// HIGHEST, so no fast tier exists for it.
#pragma once

#include <cuda_runtime.h>

#include "tiers.cuh"

namespace row_segment {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr int kLaneMajorRound = 1;

template <int FT, bool kTiled, bool kLaneMajor, typename Tier>
__global__ void __launch_bounds__(kThreads) row_segment_matmul_kernel(
    const int* __restrict__ entry_order,  // (nnz,) flat slot ids by output row
    const int* __restrict__ row_ptr,      // (n_rows_out + 1,)
    const int* __restrict__ uidx,         // K3: (J, chunk) rows of the tile block
    const float* __restrict__ vals,       // (J, chunk)
    const typename Tier::In* __restrict__ gathered,  // K1 (J, chunk, n_feat); K3 (J, u8, n_feat);
                                                     // K2 (J, n_feat, chunk)
    const int* __restrict__ window_ptr,   // (n_windows + 1) chunk offsets
    float* __restrict__ out,              // (n_rows_out, n_feat); K2 (n_feat, n_rows_out)
    int n_rows_out, int chunk, int u8, int n_feat, int window, int write_empty) {
  using TIn = typename Tier::In;
  constexpr int kRound = kLaneMajor ? kLaneMajorRound : kUnroll;
  long long row;
  int f0;
  if constexpr (kLaneMajor) {
    row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (row >= n_rows_out) return;
    f0 = blockIdx.y * FT;
  } else {
    const int groups = n_feat / FT;
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    row = t / groups;
    if (row >= n_rows_out) return;
    f0 = static_cast<int>(t - row * groups) * FT;
  }
  if (!write_empty) {
    // row < n_rows_out fits an int: the lane-major grid, one thread per row,
    // takes the cheaper 32-bit division.
    const long long w = kLaneMajor ? static_cast<int>(row) / window : row / window;
    if (window_ptr[w] == window_ptr[w + 1]) return;  // the caller's init keeps it
  }
  const int lo = row_ptr[row];
  const int hi = row_ptr[row + 1];

  float acc[FT];
#pragma unroll
  for (int k = 0; k < FT; ++k) acc[k] = 0.0f;

  for (int e0 = lo; e0 < hi; e0 += kRound) {
    // Every load of the round is issued before any arithmetic, and none is
    // under a branch: past the row's end a slot repeats the row's last entry
    // (a cache hit) and its product is masked to +0, which leaves the sum
    // unchanged (it starts at +0 and, rounding to nearest, is never -0).
    int slot[kRound];
#pragma unroll
    for (int u = 0; u < kRound; ++u) slot[u] = entry_order[min(e0 + u, hi - 1)];
    float v[kRound];
    TIn g[kRound][FT];
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const int s = slot[u];
      if constexpr (kLaneMajor) {
        v[u] = vals[s];
        // Slot s = j*C + c; feature f of it at ((j * n_feat + f) * C + c).
        const int j = s / chunk;
        const TIn* x = gathered + (static_cast<size_t>(j) * n_feat + f0) * chunk + (s - j * chunk);
#pragma unroll
        for (int k = 0; k < FT; ++k) g[u][k] = x[static_cast<size_t>(k) * chunk];
      } else {
        size_t src = static_cast<size_t>(s);
        if (kTiled) src = static_cast<size_t>(s / chunk) * u8 + uidx[s];
        v[u] = vals[s];
        const TIn* x = gathered + src * n_feat + f0;
#pragma unroll
        for (int k = 0; k < FT; ++k) g[u][k] = x[k];
      }
    }
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const bool live = e0 + u < hi;
      const float vu = Tier::value(v[u]);
#pragma unroll
      for (int k = 0; k < FT; ++k) {
        // Product rounded first (as the tier rounds it), then added: no
        // fused multiply-add, so the sum matches the plain version's
        // scaled-then-summed order.
        const float prod = Tier::product(__fmul_rn(vu, Tier::feature(g[u][k])));
        acc[k] = __fadd_rn(acc[k], live ? prod : 0.0f);
      }
    }
  }
  if constexpr (kLaneMajor) {
    float* o = out + static_cast<size_t>(f0) * n_rows_out + row;
#pragma unroll
    for (int k = 0; k < FT; ++k) o[static_cast<size_t>(k) * n_rows_out] = acc[k];
  } else {
    float* o = out + row * n_feat + f0;
#pragma unroll
    for (int k = 0; k < FT; ++k) o[k] = acc[k];
  }
}

template <int FT, bool kTiled, bool kLaneMajor, typename Tier>
cudaError_t launch(const int* entry_order, const int* row_ptr, const int* uidx,
                   const float* vals, const typename Tier::In* gathered, const int* window_ptr,
                   float* out, int n_rows_out, int chunk, int u8, int n_feat, int window,
                   int write_empty, cudaStream_t stream) {
  dim3 grid;
  if constexpr (kLaneMajor) {
    // x: rows, a block of kThreads consecutive rows; y: feature groups.
    grid = dim3((n_rows_out + kThreads - 1) / kThreads, n_feat / FT);
    if (grid.y > 65535) return cudaErrorInvalidValue;
  } else {
    const long long threads = static_cast<long long>(n_rows_out) * (n_feat / FT);
    const long long blocks = (threads + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    grid = dim3(static_cast<unsigned>(blocks));
  }
  row_segment_matmul_kernel<FT, kTiled, kLaneMajor, Tier><<<grid, kThreads, 0, stream>>>(
      entry_order, row_ptr, uidx, vals, gathered, window_ptr, out, n_rows_out, chunk, u8,
      n_feat, window, write_empty);
  return cudaGetLastError();
}

// The lane-major feature group: the largest divisor of n_feat up to 8.
inline int lane_major_group(int n_feat) {
  for (int ft = 8; ft > 1; --ft) {
    if (n_feat % ft == 0) return ft;
  }
  return 1;
}

// One launch for any F. Row-major: the widest feature group of 4, 2 or 1
// that divides F; lane-major: lane_major_group(F).
template <bool kTiled, bool kLaneMajor, typename Tier>
int dispatch(const void* entry_order, const void* row_ptr, const void* uidx, const void* vals,
             const void* gathered, const void* window_ptr, void* out, int n_rows_out, int chunk,
             int u8, int n_feat, int window, int write_empty, void* stream) {
  if (n_rows_out <= 0) return cudaSuccess;
  if (n_feat <= 0 || window <= 0 || n_rows_out % window != 0 ||
      ((kTiled || kLaneMajor) && chunk <= 0) || (kTiled && u8 <= 0))
    return cudaErrorInvalidValue;
  const int* eo = static_cast<const int*>(entry_order);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* ui = static_cast<const int*>(uidx);
  const float* v = static_cast<const float*>(vals);
  const auto* g = static_cast<const typename Tier::In*>(gathered);
  const int* wp = static_cast<const int*>(window_ptr);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ROW_SEGMENT_LAUNCH(FT)                                                                 \
  return launch<FT, kTiled, kLaneMajor, Tier>(eo, rp, ui, v, g, wp, o, n_rows_out, chunk, u8, \
                                             n_feat, window, write_empty, s)
  if constexpr (kLaneMajor) {
    switch (lane_major_group(n_feat)) {
      case 8: ROW_SEGMENT_LAUNCH(8);
      case 7: ROW_SEGMENT_LAUNCH(7);
      case 6: ROW_SEGMENT_LAUNCH(6);
      case 5: ROW_SEGMENT_LAUNCH(5);
      case 4: ROW_SEGMENT_LAUNCH(4);
      case 3: ROW_SEGMENT_LAUNCH(3);
      case 2: ROW_SEGMENT_LAUNCH(2);
      default: ROW_SEGMENT_LAUNCH(1);
    }
  } else {
    if (n_feat % 4 == 0) ROW_SEGMENT_LAUNCH(4);
    if (n_feat % 2 == 0) ROW_SEGMENT_LAUNCH(2);
    ROW_SEGMENT_LAUNCH(1);
  }
#undef ROW_SEGMENT_LAUNCH
}

}  // namespace row_segment
