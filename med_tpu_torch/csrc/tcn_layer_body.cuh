// The body of one dilated residual TCN layer, forward, shared by the kernels
// of tcn_layer.cu (stacks with per-stage operands) and tcn_multistack.cu
// (stacks with operands concatenated on the layer axis).
//
//   y   = relu(b3 + sum_j h[t - s_j] @ w3[j])      taps s = (2d, d, 0) causal,
//                                                   (d, 0, -d) acausal
//   z   = y @ w1 + b1     (times 2*mask when a uint8 dropout mask is given)
//   out = h + z
// Rows outside [0, T) read zero. h, out (T, C) row-major; w3 (3, C, C) and
// w1 (C, C) are [in][out]; b3, b1 (C); mask (T, C) or null. y_out and h_out
// (T, C) or null: a training forward saves y, and where the caller keeps no
// copy of the layer's input also h, for the backward.
//
// A block takes 32 rows and all C output channels. It stages the layer's
// weights (64 KB at C=64, so dynamic shared memory above the 48 KB static
// limit) and the three shifted input tiles in shared memory, writes
// relu(...) into shared memory, then applies w1. Thread (row group, output
// channel o) keeps its rows' sums in registers; a warp reads one input value
// by broadcast and 32 consecutive weights, so shared memory has no bank
// conflicts. The output goes to a buffer other than the input: an in-place
// update would race with the tap reads of neighbouring blocks.

#pragma once

#include <cuda_runtime.h>

namespace tcn {

constexpr int kTile = 32;      // rows of T per block
constexpr int kThreads = 256;

// dynamic shared memory of one block, in bytes
template <int C>
constexpr size_t layer_smem() {
  return (size_t)(4 * C * C + 4 * kTile * C) * sizeof(float);
}

template <int C>
__device__ __forceinline__ void tcn_layer_body(
    const float* __restrict__ h, const float* __restrict__ w3,
    const float* __restrict__ b3, const float* __restrict__ w1,
    const float* __restrict__ b1, const unsigned char* __restrict__ mask,
    float* __restrict__ out, float* __restrict__ y_out,
    float* __restrict__ h_out, int T, int s0, int s1, int s2, float* smem) {
  constexpr int kGroups = kThreads / C;        // row groups
  constexpr int kRows = kTile / kGroups;       // rows per thread
  float* w3s = smem;                 // [3][C][C]
  float* w1s = w3s + 3 * C * C;      // [C][C]
  float* xs = w1s + C * C;           // [3][kTile][C] shifted input tiles
  float* ys = xs + 3 * kTile * C;    // [kTile][C] post-relu activations

  const int t0 = blockIdx.x * kTile;
  for (int i = threadIdx.x; i < 3 * C * C; i += kThreads) w3s[i] = w3[i];
  for (int i = threadIdx.x; i < C * C; i += kThreads) w1s[i] = w1[i];
  const int shift[3] = {s0, s1, s2};
  for (int i = threadIdx.x; i < 3 * kTile * C; i += kThreads) {
    const int j = i / (kTile * C);
    const int r = (i / C) % kTile;
    const int c = i % C;
    const int src = t0 + r - shift[j];
    xs[i] = (src >= 0 && src < T) ? h[(long long)src * C + c] : 0.f;
  }
  __syncthreads();

  const int o = threadIdx.x % C;
  const int g = threadIdx.x / C;
  float acc[kRows];
  const float bias3 = b3[o];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = bias3;
  for (int j = 0; j < 3; ++j) {
    const float* xj = xs + j * kTile * C;
    const float* wj = w3s + j * C * C;
    for (int c = 0; c < C; ++c) {
      const float w = wj[c * C + o];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        acc[i] = fmaf(xj[(g + i * kGroups) * C + c], w, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float y = fmaxf(acc[i], 0.f);
    ys[(g + i * kGroups) * C + o] = y;
    const int t = t0 + g + i * kGroups;
    if (y_out != nullptr && t < T) y_out[(long long)t * C + o] = y;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  for (int c = 0; c < C; ++c) {
    const float w = w1s[c * C + o];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      acc[i] = fmaf(ys[(g + i * kGroups) * C + c], w, acc[i]);
  }
  const float bias1 = b1[o];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = t0 + g + i * kGroups;
    if (t >= T) continue;
    const long long at = (long long)t * C + o;
    float z = acc[i] + bias1;
    if (mask != nullptr) z *= (float)mask[at] * 2.f;
    const float hin = h[at];
    if (h_out != nullptr) h_out[at] = hin;
    out[at] = hin + z;
  }
}

}  // namespace tcn
