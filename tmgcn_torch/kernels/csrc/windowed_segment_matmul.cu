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
// and differ only in layout: K1 reads gathered (J, chunk, F) and writes
// out (n_rows_out, F); K2 reads gathered_t (J, F, chunk) and writes
// out (F, n_rows_out). One kernel template serves both (kLaneMajor).
//
// What bounds them on this card: bytes. Every entry is read once (row id,
// value and F gathered features, 8 + 4F bytes) and every output element is
// written once; the arithmetic is one multiply and one add per entry and
// feature, far below the card's float32 rate.
//
// Design. The TPU kernels turn the scatter into a (W, C) one-hot product on
// the matrix unit because the TPU has no fast vector scatter; K2 exists
// there only because Mosaic pads an (rows, F~6) array 21x on its lanes.
// Here one thread block owns one output window (and one tile of FT
// features): it walks that window's chunks in order (window_ptr gives the
// chunk range, since the packer sorts chunks by window), stages each
// chunk's row ids, values and gathered features in shared memory, and
// thread r accumulates output row r in registers. Every output element is
// therefore summed by one thread in entry order: bitwise deterministic, no
// float atomics, and each output element written exactly once. Rows inside
// a window need not be sorted (column-sorted packings permute them). All
// threads of a warp read the same staged row id at once, so the scan over a
// chunk is a shared memory broadcast; its cost grows with W * slots / 32
// per window, padding slots included, which is the first thing a faster
// version removes. K2's loads of a chunk's (F, chunk) slab and its stores
// to out[f * n_rows_out + w*W + r] are both coalesced across threads.
//
// write_empty == 0 (the caller passes a zero-initialised `init` as out):
// windows with no chunk are not written. Otherwise they are written as 0.
//
// K1 has two tiers (tiers.cuh): float32, and the bf16-gather tier of
// tmgcn_tpu/kernels/spmm_pallas.py:827-840 (gathered features in bf16, each
// product rounded to bf16, float32 sums and output), which halves the bytes
// of the gathered chunks, the largest input. K2 has the float32 tier only,
// as its one user needs.

#include <cuda_runtime.h>

#include "tiers.cuh"

namespace {

template <int FT, bool kLaneMajor, typename TIn>
__global__ void windowed_segment_matmul_kernel(
    const int* __restrict__ rows,        // (J, chunk) window-relative rows
    const float* __restrict__ vals,      // (J, chunk)
    const TIn* __restrict__ gathered,    // K1 (J, chunk, n_feat); K2 (J, n_feat, chunk)
    const int* __restrict__ window_ptr,  // (n_windows + 1) chunk offsets
    float* __restrict__ out,             // K1 (n_rows_out, n_feat); K2 (n_feat, n_rows_out)
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
      s_vals[c] = Tier<TIn>::round(vals[base + c]);  // the value in the gather's type
    }
    if (kLaneMajor) {
      // (n_feat, chunk) slab of chunk j: consecutive threads, consecutive c.
      const size_t slab = static_cast<size_t>(j) * n_feat * chunk;
      for (int i = threadIdx.x; i < chunk * FT; i += blockDim.x) {
        const int k = i / chunk;
        const int c = i - k * chunk;
        s_g[c * FT + k] =
            (k < nf) ? Tier<TIn>::load(gathered[slab + static_cast<size_t>(f0 + k) * chunk + c])
                     : 0.0f;
      }
    } else {
      for (int i = threadIdx.x; i < chunk * FT; i += blockDim.x) {
        const int c = i / FT;
        const int k = i - c * FT;
        s_g[i] = (k < nf) ? Tier<TIn>::load(gathered[(base + c) * n_feat + f0 + k]) : 0.0f;
      }
    }
    __syncthreads();
    if (r < window) {
      for (int c = 0; c < chunk; ++c) {
        if (s_rows[c] == r) {
          const float v = s_vals[c];
#pragma unroll
          for (int k = 0; k < FT; ++k) {
            // Product rounded first (to the tier's type), then added: no
            // fused multiply-add, so the sum matches the plain version's
            // scaled-then-summed order.
            acc[k] = __fadd_rn(acc[k], Tier<TIn>::round(__fmul_rn(v, s_g[c * FT + k])));
          }
        }
      }
    }
  }
  if (r < window) {
    const size_t row = static_cast<size_t>(w) * window + r;
    if (kLaneMajor) {
      const size_t n_rows_out = static_cast<size_t>(gridDim.x) * window;
#pragma unroll
      for (int k = 0; k < FT; ++k) {
        if (k < nf) out[static_cast<size_t>(f0 + k) * n_rows_out + row] = acc[k];
      }
    } else {
      float* o = out + row * n_feat + f0;
#pragma unroll
      for (int k = 0; k < FT; ++k) {
        if (k < nf) o[k] = acc[k];
      }
    }
  }
}

template <int FT, bool kLaneMajor, typename TIn>
cudaError_t launch(const int* rows, const float* vals, const TIn* gathered,
                   const int* window_ptr, float* out, int n_windows, int chunk,
                   int n_feat, int window, int write_empty, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(chunk) * (sizeof(int) + sizeof(float)) +
                      static_cast<size_t>(chunk) * FT * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        windowed_segment_matmul_kernel<FT, kLaneMajor, TIn>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_windows, (n_feat + FT - 1) / FT);
  const int threads = ((window + 31) / 32) * 32;
  windowed_segment_matmul_kernel<FT, kLaneMajor, TIn><<<grid, threads, smem, stream>>>(
      rows, vals, gathered, window_ptr, out, chunk, n_feat, window, write_empty);
  return cudaGetLastError();
}

template <bool kLaneMajor, typename TIn>
int dispatch(const void* rows, const void* vals, const void* gathered,
             const void* window_ptr, void* out, int n_windows, int chunk, int n_feat,
             int window, int write_empty, void* stream) {
  if (n_windows <= 0) return cudaSuccess;
  if (chunk <= 0 || n_feat <= 0 || window <= 0 || window > 1024)
    return cudaErrorInvalidValue;
  const int* r = static_cast<const int*>(rows);
  const float* v = static_cast<const float*>(vals);
  const TIn* g = static_cast<const TIn*>(gathered);
  const int* p = static_cast<const int*>(window_ptr);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_feat == 1)
    return launch<1, kLaneMajor, TIn>(r, v, g, p, o, n_windows, chunk, n_feat, window, write_empty, s);
  if (n_feat == 2)
    return launch<2, kLaneMajor, TIn>(r, v, g, p, o, n_windows, chunk, n_feat, window, write_empty, s);
  if (n_feat <= 4)
    return launch<4, kLaneMajor, TIn>(r, v, g, p, o, n_windows, chunk, n_feat, window, write_empty, s);
  return launch<8, kLaneMajor, TIn>(r, v, g, p, o, n_windows, chunk, n_feat, window, write_empty, s);
}

}  // namespace

// K1: gathered (J, chunk, n_feat) -> out (n_windows * window, n_feat).
extern "C" int tmgcn_windowed_segment_matmul_f32(
    const void* rows, const void* vals, const void* gathered,
    const void* window_ptr, void* out, int n_windows, int chunk, int n_feat,
    int window, int write_empty, void* stream) {
  return dispatch<false, float>(rows, vals, gathered, window_ptr, out, n_windows, chunk,
                         n_feat, window, write_empty, stream);
}

// K2: gathered_t (J, n_feat, chunk) -> out (n_feat, n_windows * window).
extern "C" int tmgcn_windowed_segment_matmul_t_f32(
    const void* rows, const void* vals, const void* gathered_t,
    const void* window_ptr, void* out, int n_windows, int chunk, int n_feat,
    int window, int write_empty, void* stream) {
  return dispatch<true, float>(rows, vals, gathered_t, window_ptr, out, n_windows, chunk,
                        n_feat, window, write_empty, stream);
}

// K1, bf16-gather tier: gathered (J, chunk, n_feat) bf16 -> out float32.
extern "C" int tmgcn_windowed_segment_matmul_bf16(
    const void* rows, const void* vals, const void* gathered,
    const void* window_ptr, void* out, int n_windows, int chunk, int n_feat,
    int window, int write_empty, void* stream) {
  return dispatch<false, __nv_bfloat16>(rows, vals, gathered, window_ptr, out, n_windows,
                                        chunk, n_feat, window, write_empty, stream);
}
