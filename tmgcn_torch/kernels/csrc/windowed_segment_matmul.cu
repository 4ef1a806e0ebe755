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
// K1 walks the packing's row index (entry_order, row_ptr), one thread per
// output row and feature group: row_segment_matmul.cuh says what bounds it
// and what its design does about that. It has two tiers (tiers.cuh): float32,
// and the bf16-gather tier of tmgcn_tpu/kernels/spmm_pallas.py:827-840
// (gathered features in bf16, each product rounded to bf16, float32 sums and
// output), which halves the bytes of the gathered features.
//
// K2 scans windows: what bounds it on this card is the scan, not its bytes
// (every entry's row id, value and F features, 8 + 4F bytes, read once;
// every output element written once). One thread block owns one output
// window and one tile of FT features: it walks
// that window's chunks in order (window_ptr gives the chunk range, since the
// packer sorts chunks by window), stages each chunk's row ids, values and
// (F, chunk) slab in shared memory, and thread r accumulates output row r in
// registers, scanning every staged slot (W * slots / 32 compares per window,
// padding included). Every output element is summed by one thread in entry
// order: bitwise deterministic, no float atomics, and the same sums in the
// same order as K1, so K2 is K1 transposed, bit for bit. Its loads of a
// chunk's (F, chunk) slab and its stores to out[f * n_rows_out + w*W + r] are
// both coalesced across threads. K2 has the float32 tier only, as its one user
// needs.
//
// write_empty == 0 (the caller passes a zero-initialised `init` as out):
// windows with no chunk are not written. Otherwise they are written as 0.

#include <cuda_runtime.h>

#include "row_segment_matmul.cuh"
#include "tiers.cuh"

namespace {

template <int FT>
__global__ void lane_major_segment_matmul_kernel(
    const int* __restrict__ rows,        // (J, chunk) window-relative rows
    const float* __restrict__ vals,      // (J, chunk)
    const float* __restrict__ gathered,  // (J, n_feat, chunk)
    const int* __restrict__ window_ptr,  // (n_windows + 1) chunk offsets
    float* __restrict__ out,             // (n_feat, n_rows_out)
    int chunk, int n_feat, int window, int write_empty) {
  extern __shared__ unsigned char smem_raw[];
  int* s_rows = reinterpret_cast<int*>(smem_raw);
  float* s_vals = reinterpret_cast<float*>(s_rows + chunk);
  float* s_g = s_vals + chunk;  // (chunk, FT)

  const int w = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int nf = min(FT, n_feat - f0);
  const int j0 = window_ptr[w];
  const int j1 = window_ptr[w + 1];
  if (j0 == j1 && !write_empty) return;  // uniform across the block

  const int r = threadIdx.x;  // the output row this thread owns
  float acc[FT];
#pragma unroll
  for (int k = 0; k < FT; ++k) acc[k] = 0.0f;

  for (int j = j0; j < j1; ++j) {
    __syncthreads();  // the previous chunk is consumed
    const size_t base = static_cast<size_t>(j) * chunk;
    for (int c = threadIdx.x; c < chunk; c += blockDim.x) {
      s_rows[c] = rows[base + c];
      s_vals[c] = vals[base + c];
    }
    // (n_feat, chunk) slab of chunk j: consecutive threads, consecutive c.
    const size_t slab = static_cast<size_t>(j) * n_feat * chunk;
    for (int i = threadIdx.x; i < chunk * FT; i += blockDim.x) {
      const int k = i / chunk;
      const int c = i - k * chunk;
      s_g[c * FT + k] = (k < nf) ? gathered[slab + static_cast<size_t>(f0 + k) * chunk + c] : 0.0f;
    }
    __syncthreads();
    if (r < window) {
      for (int c = 0; c < chunk; ++c) {
        if (s_rows[c] == r) {
          const float v = s_vals[c];
#pragma unroll
          for (int k = 0; k < FT; ++k) {
            // Product rounded first, then added: no fused multiply-add, so
            // the sum matches the plain version's scaled-then-summed order.
            acc[k] = __fadd_rn(acc[k], __fmul_rn(v, s_g[c * FT + k]));
          }
        }
      }
    }
  }
  if (r < window) {
    const size_t row = static_cast<size_t>(w) * window + r;
    const size_t n_rows_out = static_cast<size_t>(gridDim.x) * window;
#pragma unroll
    for (int k = 0; k < FT; ++k) {
      if (k < nf) out[static_cast<size_t>(f0 + k) * n_rows_out + row] = acc[k];
    }
  }
}

template <int FT>
cudaError_t launch_lane_major(const int* rows, const float* vals, const float* gathered,
                              const int* window_ptr, float* out, int n_windows, int chunk,
                              int n_feat, int window, int write_empty, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(chunk) * (sizeof(int) + sizeof(float)) +
                      static_cast<size_t>(chunk) * FT * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lane_major_segment_matmul_kernel<FT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_windows, (n_feat + FT - 1) / FT);
  const int threads = ((window + 31) / 32) * 32;
  lane_major_segment_matmul_kernel<FT><<<grid, threads, smem, stream>>>(
      rows, vals, gathered, window_ptr, out, chunk, n_feat, window, write_empty);
  return cudaGetLastError();
}

}  // namespace

// K1: gathered (J, chunk, n_feat) -> out (n_rows_out, n_feat), over the row index.
extern "C" int tmgcn_windowed_segment_matmul_f32(
    const void* entry_order, const void* row_ptr, const void* vals, const void* gathered,
    const void* window_ptr, void* out, int n_rows_out, int n_feat, int window,
    int write_empty, void* stream) {
  return row_segment::dispatch<false, float>(entry_order, row_ptr, nullptr, vals, gathered,
                                             window_ptr, out, n_rows_out, 0, 0, n_feat, window,
                                             write_empty, stream);
}

// K1, bf16-gather tier: gathered (J, chunk, n_feat) bf16 -> out float32.
extern "C" int tmgcn_windowed_segment_matmul_bf16(
    const void* entry_order, const void* row_ptr, const void* vals, const void* gathered,
    const void* window_ptr, void* out, int n_rows_out, int n_feat, int window,
    int write_empty, void* stream) {
  return row_segment::dispatch<false, __nv_bfloat16>(entry_order, row_ptr, nullptr, vals,
                                                     gathered, window_ptr, out, n_rows_out, 0, 0,
                                                     n_feat, window, write_empty, stream);
}

// K2: gathered_t (J, n_feat, chunk) -> out (n_feat, n_windows * window).
extern "C" int tmgcn_windowed_segment_matmul_t_f32(
    const void* rows, const void* vals, const void* gathered_t,
    const void* window_ptr, void* out, int n_windows, int chunk, int n_feat,
    int window, int write_empty, void* stream) {
  if (n_windows <= 0) return cudaSuccess;
  if (chunk <= 0 || n_feat <= 0 || window <= 0 || window > 1024)
    return cudaErrorInvalidValue;
  const int* r = static_cast<const int*>(rows);
  const float* v = static_cast<const float*>(vals);
  const float* g = static_cast<const float*>(gathered_t);
  const int* p = static_cast<const int*>(window_ptr);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_feat == 1) return launch_lane_major<1>(r, v, g, p, o, n_windows, chunk, n_feat, window, write_empty, s);
  if (n_feat == 2) return launch_lane_major<2>(r, v, g, p, o, n_windows, chunk, n_feat, window, write_empty, s);
  if (n_feat <= 4) return launch_lane_major<4>(r, v, g, p, o, n_windows, chunk, n_feat, window, write_empty, s);
  return launch_lane_major<8>(r, v, g, p, o, n_windows, chunk, n_feat, window, write_empty, s);
}
