// K1 and K2: windowed segment matmul for Hopper (sm_90a).
//
// K1 replaces the TPU kernel `windowed_segment_matmul` / `_scatter_kernel` of
// tmgcn_tpu/kernels/spmm_pallas.py:608-721; K2 replaces its lane-major twin
// `windowed_segment_matmul_t` / `_scatter_kernel_t` (:724-824). Both compute
// the same sums over the same packing (tmgcn_torch/kernels/spmm_cuda.py,
// PackedSpmm):
//
//   out[w*W + r, f] = sum over chunks j of window w, in chunk order, of
//                     sum over entries c, in entry order, with rows[j,c] == r,
//                     of vals[j,c] * gathered[j,c,f]
//
// and differ in layout: K1 reads gathered (J, chunk, F) and writes out
// (n_rows_out, F); K2 reads gathered_t (J, F, chunk) and writes out
// (F, n_rows_out). The TPU kernels turn the scatter into a (W, C) one-hot
// product on the matrix unit because the TPU has no fast vector scatter; K2
// exists there only because Mosaic pads an (rows, F~6) array 21x on its lanes.
//
// Both walk the packing's row index (entry_order, row_ptr), one thread per
// output row and feature group, as one kernel template in
// row_segment_matmul.cuh, which says what bounds them, what the design does
// about it, and how the two layouts map threads (K2: consecutive lanes own
// consecutive rows, so its transposed stores coalesce). The sums are taken in
// the same order in both layouts, so K2 is K1 transposed, bit for bit. K1 has
// three tiers (tiers.cuh): float32; the bf16-gather tier of
// tmgcn_tpu/kernels/spmm_pallas.py:827-840 (gathered features in bf16, each
// product rounded to bf16, float32 sums and output), which halves the bytes
// of the gathered features; and the fast tier (`fast=True` on float32
// chunks: the TPU kernel at DEFAULT precision, each float32 product rounded
// to bf16, float32 sums), which reads the same float32 bytes as the first.
// K2 has the float32 tier only: its one JAX caller, the readout plan
// (tmgcn_tpu/ops/edge_readout.py:230), runs at HIGHEST.
//
// write_empty == 0 (the caller passes a zero-initialised `init` as out):
// windows with no chunk are not written. Otherwise they are written as 0.

#include <cuda_runtime.h>

#include "row_segment_matmul.cuh"

// K1: gathered (J, chunk, n_feat) -> out (n_rows_out, n_feat), over the row index.
extern "C" int tmgcn_windowed_segment_matmul_f32(
    const void* entry_order, const void* row_ptr, const void* vals, const void* gathered,
    const void* window_ptr, void* out, int n_rows_out, int n_feat, int window,
    int write_empty, void* stream) {
  return row_segment::dispatch<false, false, tier::F32>(entry_order, row_ptr, nullptr, vals,
                                                        gathered, window_ptr, out, n_rows_out, 0,
                                                        0, n_feat, window, write_empty, stream);
}

// K1, bf16-gather tier: gathered (J, chunk, n_feat) bf16 -> out float32.
extern "C" int tmgcn_windowed_segment_matmul_bf16(
    const void* entry_order, const void* row_ptr, const void* vals, const void* gathered,
    const void* window_ptr, void* out, int n_rows_out, int n_feat, int window,
    int write_empty, void* stream) {
  return row_segment::dispatch<false, false, tier::Bf16>(
      entry_order, row_ptr, nullptr, vals, gathered, window_ptr, out, n_rows_out, 0, 0, n_feat,
      window, write_empty, stream);
}

// K1, fast tier: gathered (J, chunk, n_feat) float32 -> out float32, each
// float32 product rounded to bf16 before the float32 add.
extern "C" int tmgcn_windowed_segment_matmul_fast(
    const void* entry_order, const void* row_ptr, const void* vals, const void* gathered,
    const void* window_ptr, void* out, int n_rows_out, int n_feat, int window,
    int write_empty, void* stream) {
  return row_segment::dispatch<false, false, tier::F32FastK1>(
      entry_order, row_ptr, nullptr, vals, gathered, window_ptr, out, n_rows_out, 0, 0, n_feat,
      window, write_empty, stream);
}

// K2: gathered_t (J, n_feat, chunk) -> out (n_feat, n_rows_out), over the row index.
extern "C" int tmgcn_windowed_segment_matmul_t_f32(
    const void* entry_order, const void* row_ptr, const void* vals, const void* gathered_t,
    const void* window_ptr, void* out, int n_rows_out, int chunk, int n_feat, int window,
    int write_empty, void* stream) {
  return row_segment::dispatch<false, true, tier::F32>(entry_order, row_ptr, nullptr, vals,
                                                       gathered_t, window_ptr, out, n_rows_out,
                                                       chunk, 0, n_feat, window, write_empty,
                                                       stream);
}
