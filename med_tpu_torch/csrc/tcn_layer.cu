// One dilated residual TCN layer, forward.
//
// Replaces the layer body of two Pallas TPU kernels of
// med_tpu/ops/tcn_fused.py: _multi_fwd_kernel_s (the merged multi-stage
// stack behind dilated_residual_multistack_stages) and _fwd_kernel (the
// single stack behind dilated_residual_stack). Both run one layer per grid
// step and carry the whole (T, C) activation in VMEM from layer to layer.
//
//   y   = relu(b3 + sum_j h[t - s_j] @ w3[j])      taps s = (2d, d, 0) causal,
//                                                   (d, 0, -d) acausal
//   z   = y @ w1 + b1     (times 2*mask when a uint8 dropout mask is given)
//   out = h + z
// Rows outside [0, T) read zero. h, out (T, C) row-major; w3 (3, C, C) and
// w1 (C, C) are [in][out]; b3, b1 (C); mask (T, C) or null. y_out (T, C) or
// null: a training forward saves y there for the backward
// (csrc/tcn_layer_bwd.cu), as the TPU kernels' save=True variant does.
//
// What bounds it on an H100: operations. A layer is 8*T*C*C flops against
// ~2*T*C*4 bytes of activations plus 16*C*C bytes of weights: at C=64 that
// is ~64 flop/byte, above the fp32 ridge of ~20 (67 TFLOP/s over 3.35 TB/s).
//
// Design: the TPU kernel's layer-to-layer carry does not fit Hopper (one
// (4096, 64) fp32 activation is 1 MB against 227 KB of shared memory, and
// blocks run in no order), so this is one launch per layer. A block takes 32
// rows and all C output channels. It stages the layer's weights (64 KB at
// C=64, so dynamic shared memory above the 48 KB static limit) and the three
// shifted input tiles in shared memory, writes relu(...) into shared memory,
// then applies w1. Thread (row group, output channel o) keeps its rows'
// sums in registers; a warp reads one input value by broadcast and 32
// consecutive weights, so shared memory has no bank conflicts. The output
// goes to a second buffer: an in-place update would race with the tap reads
// of neighbouring blocks, so the host ping-pongs two buffers when serving and
// gives every layer a fresh slot of the saved activations when training.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;      // rows of T per block
constexpr int kThreads = 256;

template <int C>
__global__ void __launch_bounds__(kThreads)
tcn_layer_kernel(const float* __restrict__ h, const float* __restrict__ w3,
                 const float* __restrict__ b3, const float* __restrict__ w1,
                 const float* __restrict__ b1,
                 const unsigned char* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ y_out, int T,
                 int s0, int s1, int s2) {
  constexpr int kGroups = kThreads / C;        // row groups
  constexpr int kRows = kTile / kGroups;       // rows per thread
  extern __shared__ float smem[];
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
    out[at] = h[at] + z;
  }
}

template <int C>
cudaError_t launch(const float* h, const float* w3, const float* b3,
                   const float* w1, const float* b1, const unsigned char* mask,
                   float* out, float* y_out, int T, int s0, int s1, int s2,
                   cudaStream_t stream) {
  constexpr size_t smem = (size_t)(4 * C * C + 4 * kTile * C) * sizeof(float);
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        tcn_layer_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const int blocks = (T + kTile - 1) / kTile;
  tcn_layer_kernel<C><<<blocks, kThreads, smem, stream>>>(
      h, w3, b3, w1, b1, mask, out, y_out, T, s0, s1, s2);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. mask and y_out
// may be null. d is the layer's dilation.
extern "C" int tcn_layer_fwd(const float* h, const float* w3, const float* b3,
                             const float* w1, const float* b1,
                             const unsigned char* mask, float* out,
                             float* y_out, int T, int C, int d, int causal,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int s0 = causal ? 2 * d : d;
  const int s1 = causal ? d : 0;
  const int s2 = causal ? 0 : -d;
  switch (C) {
    case 8: return launch<8>(h, w3, b3, w1, b1, mask, out, y_out, T, s0, s1, s2, s);
    case 16: return launch<16>(h, w3, b3, w1, b1, mask, out, y_out, T, s0, s1, s2, s);
    case 32: return launch<32>(h, w3, b3, w1, b1, mask, out, y_out, T, s0, s1, s2, s);
    case 64: return launch<64>(h, w3, b3, w1, b1, mask, out, y_out, T, s0, s1, s2, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* tcn_layer_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
