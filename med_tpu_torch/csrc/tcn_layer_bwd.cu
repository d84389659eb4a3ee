// Dilated residual TCN layers, backward, and the weight-gradient reduction.
//
// Replaces the layer body of two Pallas TPU kernels of
// med_tpu/ops/tcn_fused.py: _multi_bwd_kernel_s (the merged multi-stage
// backward behind _multi_bwd_call_s) and _bwd_kernel (the single stack's,
// behind _bwd_call). Both walk the layers in reverse, one layer per grid
// step, carrying the whole (T, C) gradient dh in VMEM.
//
// Per layer, from the forward's saved input h and post-relu y (the forward
// in csrc/tcn_stack_fwd.cu writes both when training):
//   dz  = dh * 2*mask                       (dh when there is no mask)
//   dW1 = y^T dz,  db1 = sum_t dz
//   da  = (dz W1^T) * [y > 0],  db3 = sum_t da
//   dW3_j = sum_t h[t - s_j]^T da[t]
//   dh[u] <- dh[u] + sum_j da[u + s_j] W3_j^T
// Taps s = (2d, d, 0) causal or (d, 0, -d) acausal; rows outside [0, T)
// are zero. Layouts as in the forward: h, y, dh (T, C) row-major; w3
// (3, C, C) and w1 (C, C) [in][out].
//
// What bounds it on an H100: operations. A layer is 16*T*C*C flops (four
// products of the forward's two) against ~7*T*C*4 bytes of activations and
// scratch; at C=64 that is ~37 flop/byte, above the fp32 ridge of ~20.
//
// Design. The TPU kernel holds the whole sequence in VMEM; on Hopper blocks
// run in no order, so each layer is two launches (tcn_bwd_da_kernel, then
// tcn_bwd_dh_dw_kernel), whose bodies and reasons are in
// tcn_layer_bwd_body.cuh, and tcn_wgrad_reduce_kernel sums the weight
// partials after the last layer. Stages of Lt layers in all are 2 Lt + 1
// launches, made by one host call (tcn_stages_bwd), which walks the layers
// so Python does not.

#include <cuda_runtime.h>

#include "tcn_layer_bwd_body.cuh"

namespace {

using tcn::entries;
using tcn::kChunk;
using tcn::kThreads;
using tcn::kTile;

template <int C>
__global__ void __launch_bounds__(kThreads)
tcn_bwd_da_kernel(float* __restrict__ dh, const float* __restrict__ gadd,
                  const float* __restrict__ y, const float* __restrict__ w1,
                  const unsigned char* __restrict__ mask,
                  float* __restrict__ dz, float* __restrict__ da, int T) {
  extern __shared__ float smem[];
  tcn::bwd_da_body<C>(dh, gadd, y, w1, mask, dz, da, T, smem);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
tcn_bwd_dh_dw_kernel(float* __restrict__ dh, const float* __restrict__ h,
                     const float* __restrict__ y, const float* __restrict__ w3,
                     const float* __restrict__ dz, const float* __restrict__ da,
                     float* __restrict__ partial, int T, int row_blocks,
                     int s0, int s1, int s2) {
  extern __shared__ float smem[];
  tcn::bwd_dh_dw_body<C>(dh, h, y, w3, dz, da, partial, T, row_blocks, s0, s1,
                         s2, smem);
}

__global__ void tcn_wgrad_reduce_kernel(const float* __restrict__ partial,
                                        float* __restrict__ dw3,
                                        float* __restrict__ db3,
                                        float* __restrict__ dw1,
                                        float* __restrict__ db1, int L, int P,
                                        int C) {
  tcn::wgrad_reduce_body(partial, dw3, db3, dw1, db1, L, P, C);
}

template <int C>
cudaError_t launch_layer(float* dh, const float* gadd, const float* h,
                         const float* y, const float* w3, const float* w1,
                         const unsigned char* mask, float* dz, float* da,
                         float* partial, int T, int s0, int s1, int s2,
                         int* launched, cudaStream_t stream) {
  constexpr size_t smem_da = tcn::bwd_da_smem<C>();
  constexpr size_t smem_dw = tcn::bwd_dh_dw_smem<C>();
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        tcn_bwd_da_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_da);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(tcn_bwd_dh_dw_kernel<C>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_dw);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const int row_blocks = (T + kTile - 1) / kTile;
  const int chunks = (T + kChunk - 1) / kChunk;
  tcn_bwd_da_kernel<C><<<row_blocks, kThreads, smem_da, stream>>>(
      dh, gadd, y, w1, mask, dz, da, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  tcn_bwd_dh_dw_kernel<C><<<row_blocks + 4 * chunks, kThreads, smem_dw, stream>>>(
      dh, h, y, w3, dz, da, partial, T, row_blocks, s0, s1, s2);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

}  // namespace

// The number of 128-row chunks the weight partials of one layer cover: the
// partial buffer of tcn_stages_bwd is (Lt, tcn_wgrad_chunks(T), 4C^2 + 2C).
extern "C" int tcn_wgrad_chunks(int T) { return (T + kChunk - 1) / kChunk; }

// Backward of S stages run back to back, Lt = sum(layers) layers, in one
// call: per layer, in reverse, the two launches of launch_layer; then one
// tcn_wgrad_reduce_kernel. The host loop lives here so that a backward is
// one call from Python. Arguments:
//   dh (T, C)          zeroed by the caller; the gradient at the input on return
//   g (S, T, C)        stage-output cotangents; g[s] enters at stage s's last layer
//   h_saved, y_saved   (Lt, T, C) layer inputs and post-relu activations
//   w3[s], w1[s]       stage s's (L_s, 3, C, C) and (L_s, C, C) weights
//   masks              null, or S pointers to (L_s, T, C) uint8 keep-masks
//   dz, da             (T, C) scratch; partial (Lt, chunks, 4C^2 + 2C) scratch
//   dw3, db3, dw1, db1 (Lt, 3, C, C), (Lt, C), (Lt, C, C), (Lt, C) outputs
//   launched           raised by one after each launch the runtime accepted
// Returns a cudaError_t code: 0 when all 2 Lt + 1 launches were accepted.
extern "C" int tcn_stages_bwd(float* dh, const float* g, const float* h_saved,
                              const float* y_saved, const float* const* w3,
                              const float* const* w1,
                              const unsigned char* const* masks,
                              const int* layers, int S, float* dz, float* da,
                              float* partial, float* dw3, float* db3,
                              float* dw1, float* db1, int T, int C,
                              int causal, int* launched, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long TC = (long long)T * C;
  const int chunks = tcn_wgrad_chunks(T);
  int Lt = 0;
  for (int s = 0; s < S; ++s) Lt += layers[s];
  int l = Lt;
  for (int s = S - 1; s >= 0; --s) {
    for (int i = layers[s] - 1; i >= 0; --i) {
      --l;
      const int d = 1 << i;
      const int s0 = causal ? 2 * d : d;
      const int s1 = causal ? d : 0;
      const int s2 = causal ? 0 : -d;
      const float* gadd = i == layers[s] - 1 ? g + s * TC : nullptr;
      const unsigned char* mask = masks != nullptr ? masks[s] + i * TC : nullptr;
      const float* w3i = w3[s] + (long long)i * 3 * C * C;
      const float* w1i = w1[s] + (long long)i * C * C;
      const float* h = h_saved + l * TC;
      const float* y = y_saved + l * TC;
      float* part = partial + (long long)l * chunks * entries(C);
      cudaError_t err;
      switch (C) {
        case 8: err = launch_layer<8>(dh, gadd, h, y, w3i, w1i, mask, dz, da, part, T, s0, s1, s2, launched, st); break;
        case 16: err = launch_layer<16>(dh, gadd, h, y, w3i, w1i, mask, dz, da, part, T, s0, s1, s2, launched, st); break;
        case 32: err = launch_layer<32>(dh, gadd, h, y, w3i, w1i, mask, dz, da, part, T, s0, s1, s2, launched, st); break;
        case 64: err = launch_layer<64>(dh, gadd, h, y, w3i, w1i, mask, dz, da, part, T, s0, s1, s2, launched, st); break;
        default: return cudaErrorInvalidValue;
      }
      if (err != cudaSuccess) return err;
    }
  }
  const long long n = (long long)Lt * entries(C);
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  tcn_wgrad_reduce_kernel<<<blocks, threads, 0, st>>>(partial, dw3, db3, dw1, db1,
                                                      Lt, chunks, C);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

extern "C" const char* tcn_stages_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
