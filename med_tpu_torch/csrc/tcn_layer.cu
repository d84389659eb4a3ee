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
// blocks run in no order), so this is one launch per layer; the layer's
// arithmetic and its use of shared memory are in tcn_layer_body.cuh. The
// output goes to a second buffer, so the host ping-pongs two buffers when
// serving and gives every layer a fresh slot of the saved activations when
// training.

#include <cuda_runtime.h>

#include "tcn_layer_body.cuh"

namespace {

using tcn::kThreads;
using tcn::kTile;

template <int C>
__global__ void __launch_bounds__(kThreads)
tcn_layer_kernel(const float* __restrict__ h, const float* __restrict__ w3,
                 const float* __restrict__ b3, const float* __restrict__ w1,
                 const float* __restrict__ b1,
                 const unsigned char* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ y_out, int T,
                 int s0, int s1, int s2) {
  extern __shared__ float smem[];
  tcn::tcn_layer_body<C>(h, w3, b3, w1, b1, mask, out, y_out, nullptr, T, s0, s1,
                         s2, smem);
}

template <int C>
cudaError_t launch(const float* h, const float* w3, const float* b3,
                   const float* w1, const float* b1, const unsigned char* mask,
                   float* out, float* y_out, int T, int s0, int s1, int s2,
                   cudaStream_t stream) {
  constexpr size_t smem = tcn::layer_smem<C>();
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
