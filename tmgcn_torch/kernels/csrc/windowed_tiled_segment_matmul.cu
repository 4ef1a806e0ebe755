// K3: tile-deduplicated windowed segment matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel `windowed_tiled_segment_matmul` /
// `_tiled_scatter_kernel` of tmgcn_tpu/kernels/spmm_pallas.py:510-605, and
// takes its packing (tmgcn_torch/kernels/spmm_cuda.py, PackedTiled): chunk j
// carries, per entry c, a window-relative output row rows[j,c], a value
// vals[j,c] and uidx[j,c], the entry's row in the chunk's gathered block of
// distinct 8-row tiles, gathered (J, U8, F) with U8 = 8 * ut_cap. It computes
//
//   out[w*W + r, f] = sum over chunks j of window w, in chunk order, of
//                     sum over entries c, in entry order, with rows[j,c] == r,
//                     of vals[j,c] * gathered[j, uidx[j,c], f]
//
// The TPU kernel rebuilds the per-entry rows with a (C, U8) one-hot expand
// on the matrix unit and then runs K1's one-hot scatter; both one-hots have
// one nonzero per row, so each product is rounded once. Here the expand is an
// indexed read of the tile block: same sums, same rounding.
//
// Tiers (tiers.cuh): float32; bf16 (the TPU kernel's bf16 operands: the
// value rounded to bf16, the product rounded to bf16 by `.astype(g_ref.dtype)`
// after the expand, float32 sums and output); and the fast tier (`fast=True`
// on float32 blocks: the TPU kernel at DEFAULT precision, whose expand matmul
// rounds the value and the features to bf16 and whose scatter matmul rounds
// their product to bf16): the bf16 tier's arithmetic, with the float32
// features rounded as they are loaded, so it equals the bf16 tier on the
// same features cast to bf16, bit for bit.
//
// What its function needs on this card: bytes. Each real entry's slot id,
// tile index and value (12 bytes) read once, each distinct tile's 8 rows of F
// features once, and each output element written once; the arithmetic (one
// multiply and one add per entry and feature) is far below the card's rate.
// What sets the kernel's time is the latency of its dependent loads (see the
// design below).
//
// What tile dedup does and does not buy here. A TPU fetches an (8, 128) tile
// for every random row it gathers, whatever F, so gathering each chunk's
// distinct 8-row tiles once (3-5x fewer fetches on graph-local columns)
// saves most of the gather's traffic there. The H100 gathers in 32-byte
// sectors, and its 50 MB L2 serves repeated ones: a random row of F float32
// features costs ceil(F / 8) sectors, an 8-row tile F sectors. At the chess
// shape (F = 2: a row 1 sector, a tile 2) the tile block (always ut_cap
// tiles, padded slots included) saves only the DRAM sectors the L2 would not
// have served anyway, and adds the tile rows no entry reads. Dedup is kept
// for parity with the JAX package; whether it pays on this card is measured
// (chip_smoke.py), not assumed.
//
// Design: K1's (row_segment_matmul.cuh, which says what bounds both and what
// the design does about it), with kTiled: each thread walks one output row's
// real entries through the packing's row index (entry_order, row_ptr), in
// chunk then entry order, and reads each entry's row straight from its
// chunk's tile block, gathered[j, uidx[j,c], :], through the L2: no tile
// block is staged, so tile rows no entry reads are never loaded. Each output
// element is summed by one thread in index order: bitwise deterministic, no
// float atomics. Every window is written (0 where it has no chunk).

#include "row_segment_matmul.cuh"

// K3, float32 tier: gathered (J, u8, n_feat) -> out (n_rows_out, n_feat).
extern "C" int tmgcn_windowed_tiled_segment_matmul_f32(
    const void* entry_order, const void* row_ptr, const void* uidx, const void* vals,
    const void* gathered, const void* window_ptr, void* out, int n_rows_out, int chunk, int u8,
    int n_feat, int window, int write_empty, void* stream) {
  return row_segment::dispatch<true, false, tier::F32>(entry_order, row_ptr, uidx, vals,
                                                       gathered, window_ptr, out, n_rows_out,
                                                       chunk, u8, n_feat, window, write_empty,
                                                       stream);
}

// K3, bf16 tier: gathered (J, u8, n_feat) bf16 -> out float32.
extern "C" int tmgcn_windowed_tiled_segment_matmul_bf16(
    const void* entry_order, const void* row_ptr, const void* uidx, const void* vals,
    const void* gathered, const void* window_ptr, void* out, int n_rows_out, int chunk, int u8,
    int n_feat, int window, int write_empty, void* stream) {
  return row_segment::dispatch<true, false, tier::Bf16>(
      entry_order, row_ptr, uidx, vals, gathered, window_ptr, out, n_rows_out, chunk, u8, n_feat,
      window, write_empty, stream);
}

// K3, fast tier: gathered (J, u8, n_feat) float32 -> out float32, rounded as
// the bf16 tier after each feature is rounded to bf16 on load.
extern "C" int tmgcn_windowed_tiled_segment_matmul_fast(
    const void* entry_order, const void* row_ptr, const void* uidx, const void* vals,
    const void* gathered, const void* window_ptr, void* out, int n_rows_out, int chunk, int u8,
    int n_feat, int window, int write_empty, void* stream) {
  return row_segment::dispatch<true, false, tier::F32FastK3>(
      entry_order, row_ptr, uidx, vals, gathered, window_ptr, out, n_rows_out, chunk, u8, n_feat,
      window, write_empty, stream);
}
