// The LSTM scan of WD-GCN for Hopper (sm_90a): the shared-weight LSTM of
// tmgcn_torch/models/wdgcn.py over all T steps of every node in one launch,
// forward and backward.
//
// It replaces no Pallas kernel: the JAX package scans with `lax.scan`
// (tmgcn_tpu/models/wdgcn.py, lstm_scan), which XLA compiles into one loop.
// Eager PyTorch runs the same scan as a chain of small kernels a step (the
// gate products, sigmoid, tanh, the cell update and their gradients), some
// 2,000 launches in a captured chess step, and those launches and the
// traffic between them are its whole cost: the work is small. At chess
// (T 80, F 6, N 7,301; one (T, F, N) float32 tensor is 14.0 MB) the forward
// reads Y and writes Z and C, 42 MB, and the backward reads Y, Z, C and dZ
// and writes dY, 70 MB: byte bounds of ~12.5 and ~21 us at 3.35 TB/s, where
// the ~0.34 GFLOP of the forward take ~5 us at 67 TFLOP/s. So bytes bound it.
//
// What the design does about it: the state stays on chip and the whole time
// loop runs in one launch, so each byte of Y, Z, C, dZ and dY crosses device
// memory once. A group of G lanes of a warp (F rounded up to a power of two)
// owns one node through all T steps, lane i its feature i: the lane keeps
// feature i's column of W and U for each of the four gates (stacked in the
// order f, j, o, c) and their biases in registers, computes the four gates
// of feature i, its cell state and its output, and takes the node's whole
// state h from the group by shuffle. So no lane repeats another's work, and
// the short serial step leaves many warps in flight to hide its latency.
// Neighbouring nodes sit in neighbouring groups, so the loads and stores
// along the contiguous node axis coalesce; Y and dZ are read through their
// strides (the einsum before the scan and the transpose after it leave
// views), so no copy precedes either launch. Each step's loads are issued
// while the step before computes.
//
// Arithmetic, in the eager scan's order:
//   z = (W^T y + b) + U^T h          the input part first, then the recurrent
//   c = s(z_j) s(z_c) + s(z_f) c     the reference's sigmoid candidate
//   h = s(z_o) tanh(c)
// with s(x) = 1 / (1 + expf(-x)) and tanhf (accurate: no fast math), each
// dot a chain of fmaf in feature order.
//
// The backward scans in reverse from dZ with each feature's dh and dc
// carried in its lane. It recomputes each step's gates from Y[t], Z[t-1] (h0
// at t = 0) and C[t-1] (c0), so nothing of shape (T, 4F, N) is saved: the
// forward writes the cell states C (T, F, N) beside Z only when a gradient is
// needed. dY[t] and the gradient of h_{t-1} are sums over the node's features
// and gates: each lane forms its share for every feature, and a fixed
// reduce-scatter over the group leaves lane i the sums of feature i. Each
// lane sums its columns of dW, dU and db over T in registers; the block then
// sums them in a fixed order (shuffles over the nodes of a warp, then the
// warps in order through shared memory) into its row of a (blocks, 2 F 4F +
// 4F) partials buffer, which a second small kernel sums in a fixed order. No
// float atomics: two runs are bitwise equal. h0 and c0 are frozen buffers in
// every model that scans: no gradient reaches them.
//
// Layouts (float32): Y, dZ (T, F, N) at any strides; Z, C, dY (T, F, N)
// contiguous; W, U (F, 4F) with column g*F + i for gate g, feature i; b (4F);
// h0, c0 (F); the gradients [dW (F, 4F) | dU (F, 4F) | db (4F)].

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace lstm_scan {

constexpr int kGates = 4;  // f, j, o, c
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxF = 8;  // MAX_F in scan_cuda.py
constexpr int kSumCols = 32;   // the reduction's columns a block
constexpr int kSumLanes = 32;  // and row-lanes a column
constexpr unsigned kFull = 0xffffffffu;

// The lanes of a node: F rounded up to a power of two.
__host__ __device__ constexpr int group_width(int F) {
  return F <= 1 ? 1 : F <= 2 ? 2 : F <= 4 ? 4 : 8;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Element strides of a (T, F, N) operand that may be a view: the input Y as
// the GCN layer's einsum leaves it, dZ as the readout's transpose sends it.
struct Strides {
  long long t, f, n;
  __device__ __forceinline__ size_t at(int ti, int fi, size_t ni) const {
    return size_t(ti) * t + size_t(fi) * f + ni * n;
  }
};

// One lane of a node: its feature i (an idle lane past F shadows feature F - 1
// and writes nothing) and its node (a lane past N reads node 0).
template <int F>
struct Lane {
  static constexpr int G = group_width(F);
  int q, i;
  bool active, valid;
  size_t node;
  __device__ __forceinline__ explicit Lane(int N) {
    q = threadIdx.x % G;
    i = q < F ? q : F - 1;
    const int n = blockIdx.x * (kThreads / G) + threadIdx.x / G;
    active = q < F;
    valid = n < N;
    node = valid ? n : 0;
  }
};

// Feature i's column of W and U for each gate, and the gates' biases.
template <int F>
__device__ __forceinline__ void feature_weights(const float* __restrict__ W,
                                                const float* __restrict__ U,
                                                const float* __restrict__ b, int i,
                                                float (&w)[F][kGates], float (&u)[F][kGates],
                                                float (&bias)[kGates]) {
  constexpr int K = kGates * F;
#pragma unroll
  for (int m = 0; m < F; ++m) {
#pragma unroll
    for (int g = 0; g < kGates; ++g) {
      w[m][g] = W[m * K + g * F + i];
      u[m][g] = U[m * K + g * F + i];
    }
  }
#pragma unroll
  for (int g = 0; g < kGates; ++g) bias[g] = b[g * F + i];
}

// Feature i's four gate sigmoids: the input part first, then the recurrent.
template <int F>
__device__ __forceinline__ void gate_sigmoids(const float (&w)[F][kGates],
                                              const float (&u)[F][kGates],
                                              const float (&bias)[kGates], const float (&y)[F],
                                              const float (&h)[F], float (&s)[kGates]) {
#pragma unroll
  for (int g = 0; g < kGates; ++g) {
    float a = 0.0f, r = 0.0f;
#pragma unroll
    for (int m = 0; m < F; ++m) a = fmaf(w[m][g], y[m], a);
#pragma unroll
    for (int m = 0; m < F; ++m) r = fmaf(u[m][g], h[m], r);
    s[g] = sigmoid((a + bias[g]) + r);
  }
}

// Lane q of a group of G gets the sum over the group's lanes of v[q]: a
// reduce-scatter, halving the live entries at each level (v is clobbered).
template <int G>
__device__ __forceinline__ float group_sum_of_own(float (&v)[G], int q) {
#pragma unroll
  for (int o = G / 2; o >= 1; o /= 2) {
    const bool upper = q & o;
#pragma unroll
    for (int k = 0; k < o; ++k) {
      const float keep = upper ? v[k + o] : v[k];
      const float send = upper ? v[k] : v[k + o];
      v[k] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  return v[0];
}

// Y (T, F, N) -> Z (T, F, N), and the cell states C when C is not null.
template <int F>
__global__ void __launch_bounds__(kThreads)
    scan_forward(const float* __restrict__ Y, Strides ys, const float* __restrict__ W,
                 const float* __restrict__ U, const float* __restrict__ b,
                 const float* __restrict__ h0, const float* __restrict__ c0,
                 float* __restrict__ Z, float* __restrict__ C, int T, int N) {
  constexpr int G = group_width(F);
  const Lane<F> lane(N);
  const bool writes = lane.active && lane.valid;
  const size_t plane = size_t(F) * N;
  const size_t own = lane.i * size_t(N) + lane.node;

  float w[F][kGates], u[F][kGates], bias[kGates], h[F], y[F];
  feature_weights<F>(W, U, b, lane.i, w, u, bias);
  float c = c0[lane.i];
#pragma unroll
  for (int m = 0; m < F; ++m) {
    h[m] = h0[m];
    y[m] = Y[ys.at(0, m, lane.node)];
  }
  for (int t = 0; t < T; ++t) {
    float y_next[F];  // the next step's input, loaded while this step computes
#pragma unroll
    for (int m = 0; m < F; ++m) y_next[m] = t + 1 < T ? Y[ys.at(t + 1, m, lane.node)] : 0.0f;
    float s[kGates];
    gate_sigmoids<F>(w, u, bias, y, h, s);
    // Each product and the sum rounded once, as the eager scan's kernels do.
    c = __fadd_rn(__fmul_rn(s[1], s[3]), __fmul_rn(s[0], c));
    const float hi = __fmul_rn(s[2], tanhf(c));
    if (writes) {
      Z[t * plane + own] = hi;
      if (C != nullptr) C[t * plane + own] = c;
    }
#pragma unroll
    for (int m = 0; m < F; ++m) {
      h[m] = __shfl_sync(kFull, hi, m, G);
      y[m] = y_next[m];
    }
  }
}

// dZ (T, F, N) -> dY (T, F, N), and this block's row of the partials of
// [dW | dU | db].
template <int F>
__global__ void __launch_bounds__(kThreads)
    scan_backward(const float* __restrict__ Y, Strides ys, const float* __restrict__ Z,
                  const float* __restrict__ C, const float* __restrict__ dZ, Strides dzs,
                  const float* __restrict__ W, const float* __restrict__ U,
                  const float* __restrict__ b, const float* __restrict__ h0,
                  const float* __restrict__ c0, float* __restrict__ dY,
                  float* __restrict__ partials, int T, int N) {
  constexpr int G = group_width(F);
  constexpr int K = kGates * F;
  constexpr int kSums = 2 * F * kGates + kGates;  // a lane's columns of dW, dU and db
  constexpr int kOut = 2 * F * K + K;
  __shared__ float block_sums[kWarps][G][kSums];
  const Lane<F> lane(N);
  const size_t plane = size_t(F) * N;
  const size_t own = lane.i * size_t(N) + lane.node;

  float w[F][kGates], u[F][kGates], bias[kGates];
  feature_weights<F>(W, U, b, lane.i, w, u, bias);

  // Step t's input and previous state (every feature), and feature i's
  // previous cell state and upstream gradient.
  auto load = [&](int t, float (&y)[F], float (&hp)[F], float& cp, float& dz) {
#pragma unroll
    for (int m = 0; m < F; ++m) {
      y[m] = Y[ys.at(t, m, lane.node)];
      hp[m] = t > 0 ? Z[(t - 1) * plane + m * size_t(N) + lane.node] : h0[m];
    }
    cp = t > 0 ? C[(t - 1) * plane + own] : c0[lane.i];
    dz = dZ[dzs.at(t, lane.i, lane.node)];
  };

  // sums[m*4 + g]: dW[m][g*F + i]; sums[4F + m*4 + g]: dU; sums[8F + g]: db.
  float sums[kSums];
#pragma unroll
  for (int e = 0; e < kSums; ++e) sums[e] = 0.0f;
  float dh = 0.0f, dc = 0.0f, c_t = C[(T - 1) * plane + own];
  float y[F], hp[F], cp, dz;
  load(T - 1, y, hp, cp, dz);
  for (int t = T - 1; t >= 0; --t) {
    float y_next[F], hp_next[F], cp_next = 0.0f, dz_next = 0.0f;
    if (t > 0) load(t - 1, y_next, hp_next, cp_next, dz_next);
    float s[kGates];
    gate_sigmoids<F>(w, u, bias, y, hp, s);

    const float tc = tanhf(c_t);
    const float dhi = dz + dh;
    const float dci = dc + dhi * s[2] * (1.0f - tc * tc);
    // The gradient of each gate's sigmoid (f, j, o, c), then of its
    // pre-activation; an idle lane adds nothing to the node's sums.
    float d[kGates] = {dci * cp, dci * s[3], dhi * tc, dci * s[1]};
#pragma unroll
    for (int g = 0; g < kGates; ++g) d[g] = lane.active ? d[g] * (1.0f - s[g]) * s[g] : 0.0f;
    dc = dci * s[0];

    // dY[t] and the gradient of h_{t-1}: this feature's share for every
    // feature m, then summed over the group, feature i's sums to lane i.
    float py[G], ph[G];
#pragma unroll
    for (int m = 0; m < G; ++m) {
      py[m] = 0.0f;
      ph[m] = 0.0f;
    }
#pragma unroll
    for (int m = 0; m < F; ++m) {
#pragma unroll
      for (int g = 0; g < kGates; ++g) {
        py[m] = fmaf(w[m][g], d[g], py[m]);
        ph[m] = fmaf(u[m][g], d[g], ph[m]);
      }
    }
    const float dy = group_sum_of_own<G>(py, lane.q);
    dh = group_sum_of_own<G>(ph, lane.q);
    if (lane.active && lane.valid) {
      dY[t * plane + own] = dy;
#pragma unroll
      for (int m = 0; m < F; ++m) {
#pragma unroll
        for (int g = 0; g < kGates; ++g) {
          float& sw = sums[m * kGates + g];
          float& su = sums[F * kGates + m * kGates + g];
          sw = fmaf(y[m], d[g], sw);
          su = fmaf(hp[m], d[g], su);
        }
      }
#pragma unroll
      for (int g = 0; g < kGates; ++g) sums[2 * F * kGates + g] += d[g];
    }
    c_t = cp;
    if (t > 0) {
#pragma unroll
      for (int m = 0; m < F; ++m) {
        y[m] = y_next[m];
        hp[m] = hp_next[m];
      }
      cp = cp_next;
      dz = dz_next;
    }
  }

  // The block's sums: over the nodes of a warp (the lanes of one feature) by
  // shuffle, then over the warps in order.
  const int lane_id = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int e = 0; e < kSums; ++e) {
    float v = sums[e];
#pragma unroll
    for (int o = G; o < 32; o *= 2) v += __shfl_xor_sync(kFull, v, o);
    if (lane_id < G) block_sums[warp][lane_id][e] = v;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kOut; e += kThreads) {
    // e indexes [dW (F, K) | dU (F, K) | db (K)], column k = g*F + i: lane
    // i's sum j of its columns.
    int i, j;
    if (e < 2 * F * K) {
      const int part = e / (F * K), m = (e % (F * K)) / K, k = e % K;
      i = k % F;
      j = part * F * kGates + m * kGates + k / F;
    } else {
      i = (e - 2 * F * K) % F;
      j = 2 * F * kGates + (e - 2 * F * K) / F;
    }
    float v = block_sums[0][i][j];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) v += block_sums[k][i][j];
    partials[size_t(blockIdx.x) * kOut + e] = v;
  }
}

// out[e] = the sum over blocks of partials[block][e]: row-lane y of a
// column sums rows y, y + kSumLanes, ... in block order (a warp reads 32
// neighbouring columns of a row), then the lanes' sums meet in a fixed tree.
// At N = 500,000 the partials have 31,250 rows.
__global__ void __launch_bounds__(kSumCols * kSumLanes)
    sum_partials(const float* __restrict__ partials, float* __restrict__ out, int n_blocks,
                 int n_out) {
  __shared__ float lanes[kSumLanes][kSumCols + 1];
  const int x = threadIdx.x % kSumCols, y = threadIdx.x / kSumCols;
  const int e = blockIdx.x * kSumCols + x;
  float v = 0.0f;
  if (e < n_out) {
#pragma unroll 8
    for (int k = y; k < n_blocks; k += kSumLanes) v += partials[size_t(k) * n_out + e];
  }
  lanes[y][x] = v;
  __syncthreads();
#pragma unroll
  for (int o = kSumLanes / 2; o >= 1; o /= 2) {
    if (y < o) lanes[y][x] += lanes[y + o][x];
    __syncthreads();
  }
  if (y == 0 && e < n_out) out[e] = lanes[0][x];
}

// Calls fn with std::integral_constant<int, F>; F outside 1..kMaxF is refused.
template <typename Fn>
cudaError_t with_width(int F, Fn&& fn) {
  if (F < 1 || F > kMaxF) return cudaErrorInvalidValue;
  switch (F) {
    case 1: fn(std::integral_constant<int, 1>{}); break;
    case 2: fn(std::integral_constant<int, 2>{}); break;
    case 3: fn(std::integral_constant<int, 3>{}); break;
    case 4: fn(std::integral_constant<int, 4>{}); break;
    case 5: fn(std::integral_constant<int, 5>{}); break;
    case 6: fn(std::integral_constant<int, 6>{}); break;
    case 7: fn(std::integral_constant<int, 7>{}); break;
    case 8: fn(std::integral_constant<int, 8>{}); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The blocks of a launch over N nodes: kThreads / G nodes a block.
inline int n_blocks_for(int N, int F) {
  const int nodes = kThreads / group_width(F);
  return (N + nodes - 1) / nodes;
}

}  // namespace lstm_scan

// The rows of the backward's partials buffer (its blocks) for N nodes of
// width F; -1 where the kernels do not take them.
extern "C" int tmgcn_lstm_scan_blocks(int N, int F) {
  using namespace lstm_scan;
  return F < 1 || F > kMaxF || N < 1 ? -1 : n_blocks_for(N, F);
}

// The forward: Z, and C unless it is null (no gradient needed). Y is read
// through its element strides (ys_t, ys_f, ys_n).
extern "C" int tmgcn_lstm_scan_forward(const void* Y, const void* W, const void* U, const void* b,
                                       const void* h0, const void* c0, void* Z, void* C,
                                       long long ys_t, long long ys_f, long long ys_n, int T,
                                       int N, int F, void* stream) {
  using namespace lstm_scan;
  if (T < 1 || N < 1) return cudaErrorInvalidValue;
  return with_width(F, [&](auto width) {
    constexpr int kF = decltype(width)::value;
    scan_forward<kF><<<n_blocks_for(N, kF), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(Y), Strides{ys_t, ys_f, ys_n}, static_cast<const float*>(W),
        static_cast<const float*>(U), static_cast<const float*>(b),
        static_cast<const float*>(h0), static_cast<const float*>(c0), static_cast<float*>(Z),
        static_cast<float*>(C), T, N);
  });
}

// The backward scan: dY and the (n_blocks, 2 F 4F + 4F) partials; n_blocks
// must be tmgcn_lstm_scan_blocks(N, F). Y and dZ are read through their
// strides.
extern "C" int tmgcn_lstm_scan_backward(const void* Y, const void* Z, const void* C,
                                        const void* dZ, const void* W, const void* U,
                                        const void* b, const void* h0, const void* c0, void* dY,
                                        void* partials, long long ys_t, long long ys_f,
                                        long long ys_n, long long dzs_t, long long dzs_f,
                                        long long dzs_n, int T, int N, int F, int n_blocks,
                                        void* stream) {
  using namespace lstm_scan;
  if (T < 1 || N < 1 || n_blocks != tmgcn_lstm_scan_blocks(N, F)) return cudaErrorInvalidValue;
  return with_width(F, [&](auto width) {
    constexpr int kF = decltype(width)::value;
    scan_backward<kF><<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(Y), Strides{ys_t, ys_f, ys_n}, static_cast<const float*>(Z),
        static_cast<const float*>(C), static_cast<const float*>(dZ),
        Strides{dzs_t, dzs_f, dzs_n}, static_cast<const float*>(W),
        static_cast<const float*>(U), static_cast<const float*>(b),
        static_cast<const float*>(h0), static_cast<const float*>(c0), static_cast<float*>(dY),
        static_cast<float*>(partials), T, N);
  });
}

// The reduction: the gradients [dW | dU | db], the partials' rows summed in a fixed order.
extern "C" int tmgcn_lstm_scan_sum_partials(const void* partials, void* grads, int n_blocks,
                                            int n_out, void* stream) {
  using namespace lstm_scan;
  if (n_blocks < 1 || n_out < 1) return cudaErrorInvalidValue;
  sum_partials<<<(n_out + kSumCols - 1) / kSumCols, kSumCols * kSumLanes, 0,
                 static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(partials),
                                                      static_cast<float*>(grads), n_blocks,
                                                      n_out);
  return cudaGetLastError();
}
