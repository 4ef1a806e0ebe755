// K1: windowed segment matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel `windowed_segment_matmul` / `_scatter_kernel` of
// tmgcn_tpu/kernels/spmm_pallas.py:608-721. Same function, same packing
// (tmgcn_torch/kernels/spmm_cuda.py, PackedSpmm):
//
//   out[w*W + r, f] = sum over chunks j of window w, in chunk order, of
//                     sum over entries c, in entry order, with rows[j,c] == r,
//                     of vals[j,c] * gathered[j,c,f]
//
// What bounds it on this card: bytes. Every entry is read once (row id,
// value and F gathered features, 8 + 4F bytes) and every output row is
// written once; the arithmetic is one multiply and one add per entry and
// feature, far below the card's float32 rate.
//
// Design. The TPU kernel turns the scatter into a (W, C) one-hot product on
// the matrix unit because the TPU has no fast vector scatter. Here one
// thread block owns one output window (and one tile of FT features): it
// walks that window's chunks in order (window_ptr gives the chunk range,
// since the packer sorts chunks by window), stages each chunk's row ids,
// values and gathered features in shared memory, and thread r accumulates
// output row r in registers. Every output element is therefore summed by
// one thread in entry order: bitwise deterministic, no float atomics, and
// each output row written exactly once. Rows inside a window need not be
// sorted (column-sorted packings permute them). All threads of a warp read
// the same staged row id at once, so the scan over a chunk is a shared
// memory broadcast; its cost grows with W * entries / 32 per window, which
// is the first thing a faster version removes.
//
// write_empty == 0 (the caller passes a zero-initialised `init` as out):
// windows with no chunk are not written. Otherwise they are written as 0.

#include <cuda_runtime.h>

namespace {

template <int FT>
__global__ void windowed_segment_matmul_f32_kernel(
    const int* __restrict__ rows,        // (J, chunk) window-relative rows
    const float* __restrict__ vals,      // (J, chunk)
    const float* __restrict__ gathered,  // (J, chunk, n_feat)
    const int* __restrict__ window_ptr,  // (n_windows + 1) chunk offsets
    float* __restrict__ out,             // (n_windows * window, n_feat)
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
    for (int i = threadIdx.x; i < chunk * FT; i += blockDim.x) {
      const int c = i / FT;
      const int k = i - c * FT;
      s_g[i] = (k < nf) ? gathered[(base + c) * n_feat + f0 + k] : 0.0f;
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
    float* o = out + (static_cast<size_t>(w) * window + r) * n_feat + f0;
#pragma unroll
    for (int k = 0; k < FT; ++k) {
      if (k < nf) o[k] = acc[k];
    }
  }
}

template <int FT>
cudaError_t launch(const int* rows, const float* vals, const float* gathered,
                   const int* window_ptr, float* out, int n_windows, int chunk,
                   int n_feat, int window, int write_empty, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(chunk) * (sizeof(int) + sizeof(float)) +
                      static_cast<size_t>(chunk) * FT * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        windowed_segment_matmul_f32_kernel<FT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_windows, (n_feat + FT - 1) / FT);
  const int threads = ((window + 31) / 32) * 32;
  windowed_segment_matmul_f32_kernel<FT><<<grid, threads, smem, stream>>>(
      rows, vals, gathered, window_ptr, out, chunk, n_feat, window, write_empty);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tmgcn_windowed_segment_matmul_f32(
    const void* rows, const void* vals, const void* gathered,
    const void* window_ptr, void* out, int n_windows, int chunk, int n_feat,
    int window, int write_empty, void* stream) {
  if (n_windows <= 0) return cudaSuccess;
  if (chunk <= 0 || n_feat <= 0 || window <= 0 || window > 1024)
    return cudaErrorInvalidValue;
  const int* r = static_cast<const int*>(rows);
  const float* v = static_cast<const float*>(vals);
  const float* g = static_cast<const float*>(gathered);
  const int* p = static_cast<const int*>(window_ptr);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_feat == 1) return launch<1>(r, v, g, p, o, n_windows, chunk, n_feat, window, write_empty, s);
  if (n_feat == 2) return launch<2>(r, v, g, p, o, n_windows, chunk, n_feat, window, write_empty, s);
  if (n_feat <= 4) return launch<4>(r, v, g, p, o, n_windows, chunk, n_feat, window, write_empty, s);
  return launch<8>(r, v, g, p, o, n_windows, chunk, n_feat, window, write_empty, s);
}
