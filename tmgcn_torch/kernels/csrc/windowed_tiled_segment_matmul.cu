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
// indexed read of the staged tile block: same sums, same rounding.
//
// Tiers (tiers.cuh): float32, and bf16 (the TPU kernel's bf16 operands: the
// value rounded to bf16, the product rounded to bf16 by `.astype(g_ref.dtype)`
// after the expand, float32 sums and output).
//
// What bounds it on this card: bytes. Each real entry's row id, tile index
// and value (12 bytes) are read once, each distinct tile's 8 rows of F
// features once, and each output element is written once; the arithmetic
// (one multiply and one add per entry and feature) is far below the card's
// rate.
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
// Design: K1's (csrc/windowed_segment_matmul.cu). One thread block owns one
// output window and one tile of FT features, walks that window's chunks in
// order (window_ptr), stages each chunk's rows, uidx, values and its
// (U8, FT) tile block in shared memory (22.5 KB at chunk 512, U8 512,
// FT 8), and thread r sums output row r in registers, entry by entry:
// bitwise deterministic, no float atomics, each output element written once.
// Windows without a chunk are written as 0. Like K1 it scans every staged
// slot of a chunk per row, padding included: the first thing a faster
// version removes.

#include <cuda_runtime.h>

#include "tiers.cuh"

namespace {

template <int FT, typename TIn>
__global__ void windowed_tiled_segment_matmul_kernel(
    const int* __restrict__ rows,        // (J, chunk) window-relative rows
    const int* __restrict__ uidx,        // (J, chunk) rows of the chunk's tile block
    const float* __restrict__ vals,      // (J, chunk)
    const TIn* __restrict__ gathered,    // (J, u8, n_feat) distinct-tile blocks
    const int* __restrict__ window_ptr,  // (n_windows + 1) chunk offsets
    float* __restrict__ out,             // (n_rows_out, n_feat)
    int chunk, int u8, int n_feat, int window) {
  extern __shared__ unsigned char smem_raw[];
  int* s_rows = reinterpret_cast<int*>(smem_raw);
  int* s_uidx = s_rows + chunk;
  float* s_vals = reinterpret_cast<float*>(s_uidx + chunk);
  float* s_g = s_vals + chunk;  // (u8, FT)

  const int w = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int nf = min(FT, n_feat - f0);
  const int j0 = window_ptr[w];
  const int j1 = window_ptr[w + 1];

  const int r = threadIdx.x;  // the output row this thread owns
  float acc[FT];
#pragma unroll
  for (int k = 0; k < FT; ++k) acc[k] = 0.0f;

  for (int j = j0; j < j1; ++j) {
    __syncthreads();  // the previous chunk is consumed
    const size_t base = static_cast<size_t>(j) * chunk;
    for (int c = threadIdx.x; c < chunk; c += blockDim.x) {
      s_rows[c] = rows[base + c];
      s_uidx[c] = uidx[base + c];
      s_vals[c] = Tier<TIn>::round(vals[base + c]);  // the value in the gather's type
    }
    const size_t slab = static_cast<size_t>(j) * u8 * n_feat;
    for (int i = threadIdx.x; i < u8 * FT; i += blockDim.x) {
      const int u = i / FT;
      const int k = i - u * FT;
      s_g[i] = (k < nf) ? Tier<TIn>::load(gathered[slab + static_cast<size_t>(u) * n_feat + f0 + k])
                        : 0.0f;
    }
    __syncthreads();
    if (r < window) {
      for (int c = 0; c < chunk; ++c) {
        if (s_rows[c] == r) {
          const float v = s_vals[c];
          const float* g = s_g + s_uidx[c] * FT;
#pragma unroll
          for (int k = 0; k < FT; ++k) {
            // The expand's product, rounded to the tier's type, then added.
            acc[k] = __fadd_rn(acc[k], Tier<TIn>::round(__fmul_rn(v, g[k])));
          }
        }
      }
    }
  }
  if (r < window) {
    float* o = out + (static_cast<size_t>(w) * window + r) * n_feat + f0;
#pragma unroll
    for (int k = 0; k < FT; ++k) {
      if (k < nf) o[k] = acc[k];
    }
  }
}

template <int FT, typename TIn>
cudaError_t launch(const int* rows, const int* uidx, const float* vals, const TIn* gathered,
                   const int* window_ptr, float* out, int n_windows, int chunk, int u8,
                   int n_feat, int window, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(chunk) * (2 * sizeof(int) + sizeof(float)) +
                      static_cast<size_t>(u8) * FT * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        windowed_tiled_segment_matmul_kernel<FT, TIn>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_windows, (n_feat + FT - 1) / FT);
  const int threads = ((window + 31) / 32) * 32;
  windowed_tiled_segment_matmul_kernel<FT, TIn><<<grid, threads, smem, stream>>>(
      rows, uidx, vals, gathered, window_ptr, out, chunk, u8, n_feat, window);
  return cudaGetLastError();
}

template <typename TIn>
int dispatch(const void* rows, const void* uidx, const void* vals, const void* gathered,
             const void* window_ptr, void* out, int n_windows, int chunk, int u8, int n_feat,
             int window, void* stream) {
  if (n_windows <= 0) return cudaSuccess;
  if (chunk <= 0 || u8 <= 0 || n_feat <= 0 || window <= 0 || window > 1024)
    return cudaErrorInvalidValue;
  const int* r = static_cast<const int*>(rows);
  const int* u = static_cast<const int*>(uidx);
  const float* v = static_cast<const float*>(vals);
  const TIn* g = static_cast<const TIn*>(gathered);
  const int* p = static_cast<const int*>(window_ptr);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_feat == 1) return launch<1, TIn>(r, u, v, g, p, o, n_windows, chunk, u8, n_feat, window, s);
  if (n_feat == 2) return launch<2, TIn>(r, u, v, g, p, o, n_windows, chunk, u8, n_feat, window, s);
  if (n_feat <= 4) return launch<4, TIn>(r, u, v, g, p, o, n_windows, chunk, u8, n_feat, window, s);
  return launch<8, TIn>(r, u, v, g, p, o, n_windows, chunk, u8, n_feat, window, s);
}

}  // namespace

// K3, float32 tier: gathered (J, u8, n_feat) -> out (n_windows * window, n_feat).
extern "C" int tmgcn_windowed_tiled_segment_matmul_f32(
    const void* rows, const void* uidx, const void* vals, const void* gathered,
    const void* window_ptr, void* out, int n_windows, int chunk, int u8, int n_feat,
    int window, void* stream) {
  return dispatch<float>(rows, uidx, vals, gathered, window_ptr, out, n_windows, chunk, u8,
                         n_feat, window, stream);
}

// K3, bf16 tier: gathered (J, u8, n_feat) bf16 -> out float32.
extern "C" int tmgcn_windowed_tiled_segment_matmul_bf16(
    const void* rows, const void* uidx, const void* vals, const void* gathered,
    const void* window_ptr, void* out, int n_windows, int chunk, int u8, int n_feat,
    int window, void* stream) {
  return dispatch<__nv_bfloat16>(rows, uidx, vals, gathered, window_ptr, out, n_windows, chunk,
                                 u8, n_feat, window, stream);
}
