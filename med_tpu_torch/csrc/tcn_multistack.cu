// A sequence of dilated residual TCN stacks with the weights of all stacks
// concatenated on the layer axis, forward.
//
// Replaces med_tpu/ops/tcn_fused.py::_multi_fwd_kernel, the Pallas TPU
// kernel behind dilated_residual_multistack: stacks of L0, Lr, Lr, ... layers
// run back to back, Lt layers in all, layer l of the concatenated operands
// belonging to stage l < L0 ? 0 : 1 + (l - L0) / Lr at local index
// l < L0 ? l : (l - L0) % Lr, with dilation 2^local.
//
//   x (T, C); w3 (Lt, 3, C, C); b3 (Lt, C); w1 (Lt, C, C); b1 (Lt, C);
//   mask (Lt, T, C) uint8 keep-mask with scale 2, or null;
//   hs (S, T, C) the stage outputs; h_saved, y_saved (Lt, T, C) every
//   layer's input and post-relu activation, or both null.
//
// What bounds it on an H100: operations, 8*T*C*C flops a layer against
// ~2*T*C*4 bytes of activations (see tcn_layer.cu).
//
// Design: one launch per layer, for the reason given in tcn_layer.cu (the
// activation does not fit shared memory and blocks run in no order); the
// layer's arithmetic is tcn_layer_body.cuh's. The kernel is handed the
// concatenated operands and its layer index and finds its slices by offset,
// so the host splits and copies nothing. The host loop below gives a layer
// the previous layer's output as input, and as output its stage's row of hs
// when it is the stage's last layer, else one of two scratch buffers in turn.

#include <cuda_runtime.h>

#include "tcn_layer_body.cuh"

namespace {

using tcn::kThreads;
using tcn::kTile;

template <int C>
__global__ void __launch_bounds__(kThreads)
tcn_multistack_layer_kernel(const float* __restrict__ src,
                            const float* __restrict__ w3,
                            const float* __restrict__ b3,
                            const float* __restrict__ w1,
                            const float* __restrict__ b1,
                            const unsigned char* __restrict__ mask,
                            float* __restrict__ dst,
                            float* __restrict__ h_saved,
                            float* __restrict__ y_saved, int T, int l, int d,
                            int causal) {
  extern __shared__ float smem[];
  const long long TC = (long long)T * C;
  tcn::tcn_layer_body<C>(
      src, w3 + (long long)l * 3 * C * C, b3 + l * C,
      w1 + (long long)l * C * C, b1 + l * C,
      mask != nullptr ? mask + l * TC : nullptr, dst,
      y_saved != nullptr ? y_saved + l * TC : nullptr,
      h_saved != nullptr ? h_saved + l * TC : nullptr, T,
      causal ? 2 * d : d, causal ? d : 0, causal ? 0 : -d, smem);
}

template <int C>
cudaError_t run(const float* x, const float* w3, const float* b3,
                const float* w1, const float* b1, const unsigned char* mask,
                float* hs, float* h_saved, float* y_saved, float* scratch,
                int T, int Lt, int L0, int Lr, int causal, int* launched,
                cudaStream_t stream) {
  constexpr size_t smem = tcn::layer_smem<C>();
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        tcn_multistack_layer_kernel<C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const long long TC = (long long)T * C;
  const int blocks = (T + kTile - 1) / kTile;
  const float* src = x;
  for (int l = 0; l < Lt; ++l) {
    const int stage = l < L0 ? 0 : 1 + (l - L0) / Lr;
    const int local = l < L0 ? l : (l - L0) % Lr;
    const bool is_end = local == (l < L0 ? L0 : Lr) - 1;
    float* dst = is_end ? hs + stage * TC : scratch + (l & 1) * TC;
    tcn_multistack_layer_kernel<C><<<blocks, kThreads, smem, stream>>>(
        src, w3, b3, w1, b1, mask, dst, h_saved, y_saved, T, l, 1 << local,
        causal);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace

// All Lt layers in one call, Lt launches. scratch is (2, T, C); mask, and
// h_saved with y_saved, may be null. launched is raised by one after each
// launch the runtime accepted. Returns a cudaError_t code: 0 when all were.
extern "C" int tcn_multistack_fwd(const float* x, const float* w3,
                                  const float* b3, const float* w1,
                                  const float* b1, const unsigned char* mask,
                                  float* hs, float* h_saved, float* y_saved,
                                  float* scratch, int T, int C, int Lt, int L0,
                                  int Lr, int causal, int* launched,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return run<8>(x, w3, b3, w1, b1, mask, hs, h_saved, y_saved, scratch, T, Lt, L0, Lr, causal, launched, s);
    case 16: return run<16>(x, w3, b3, w1, b1, mask, hs, h_saved, y_saved, scratch, T, Lt, L0, Lr, causal, launched, s);
    case 32: return run<32>(x, w3, b3, w1, b1, mask, hs, h_saved, y_saved, scratch, T, Lt, L0, Lr, causal, launched, s);
    case 64: return run<64>(x, w3, b3, w1, b1, mask, hs, h_saved, y_saved, scratch, T, Lt, L0, Lr, causal, launched, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* tcn_multistack_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
