// A sequence of dilated residual TCN stacks with the weights of all stacks
// concatenated on the layer axis, backward.
//
// Replaces med_tpu/ops/tcn_fused.py::_multi_bwd_kernel, the Pallas TPU
// kernel behind _multi_bwd_call: the Lt layers of tcn_multistack.cu in
// reverse. Layer l belongs to stage l < L0 ? 0 : 1 + (l - L0) / Lr at local
// index l < L0 ? l : (l - L0) % Lr (dilation 2^local); the cotangent g[stage]
// of a stage's output joins dh at the stage's last layer, and dx is dh after
// layer 0.
//
//   g (S, T, C); h_saved, y_saved (Lt, T, C); w3 (Lt, 3, C, C); w1 (Lt, C, C);
//   mask (Lt, T, C) uint8 or null; dx (T, C); dw3 (Lt, 3, C, C); db3 (Lt, C);
//   dw1 (Lt, C, C); db1 (Lt, C).
//
// What bounds it on an H100: operations, 16*T*C*C flops a layer (see
// tcn_layer_bwd.cu).
//
// Design: two launches a layer and one reduction of the weight partials at
// the end, 2 Lt + 1 in all, whose bodies and reasons are in
// tcn_layer_bwd_body.cuh. Each kernel is handed the concatenated operands
// and its layer index and finds its slices by offset; the reduction writes
// the gradients straight into the (Lt, ...) outputs, so the host splits,
// joins and copies nothing. Summation order is fixed: no atomics.

#include <cuda_runtime.h>

#include "tcn_layer_bwd_body.cuh"

namespace {

using tcn::entries;
using tcn::kThreads;
using tcn::kTile;

// stage < 0: no stage output ends at this layer
template <int C>
__global__ void __launch_bounds__(kThreads)
tcn_multistack_bwd_da_kernel(float* __restrict__ dh, const float* __restrict__ g,
                             const float* __restrict__ y_saved,
                             const float* __restrict__ w1,
                             const unsigned char* __restrict__ mask,
                             float* __restrict__ dz, float* __restrict__ da,
                             int T, int l, int stage) {
  extern __shared__ float smem[];
  const long long TC = (long long)T * C;
  tcn::bwd_da_body<C>(dh, stage >= 0 ? g + stage * TC : nullptr,
                      y_saved + l * TC, w1 + (long long)l * C * C,
                      mask != nullptr ? mask + l * TC : nullptr, dz, da, T, smem);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
tcn_multistack_bwd_dh_dw_kernel(float* __restrict__ dh,
                                const float* __restrict__ h_saved,
                                const float* __restrict__ y_saved,
                                const float* __restrict__ w3,
                                const float* __restrict__ dz,
                                const float* __restrict__ da,
                                float* __restrict__ partial, int T, int chunks,
                                int row_blocks, int l, int d, int causal) {
  extern __shared__ float smem[];
  const long long TC = (long long)T * C;
  tcn::bwd_dh_dw_body<C>(dh, h_saved + l * TC, y_saved + l * TC,
                         w3 + (long long)l * 3 * C * C, dz, da,
                         partial + (long long)l * chunks * entries(C), T,
                         row_blocks, causal ? 2 * d : d, causal ? d : 0,
                         causal ? 0 : -d, smem);
}

__global__ void tcn_multistack_wgrad_kernel(const float* __restrict__ partial,
                                            float* __restrict__ dw3,
                                            float* __restrict__ db3,
                                            float* __restrict__ dw1,
                                            float* __restrict__ db1, int Lt,
                                            int chunks, int C) {
  tcn::wgrad_reduce_body(partial, dw3, db3, dw1, db1, Lt, chunks, C);
}

template <int C>
cudaError_t run(float* dx, const float* g, const float* h_saved,
                const float* y_saved, const float* w3, const float* w1,
                const unsigned char* mask, float* dz, float* da, float* partial,
                float* dw3, float* db3, float* dw1, float* db1, int T, int Lt,
                int L0, int Lr, int causal, int* launched, cudaStream_t stream) {
  constexpr size_t smem_da = tcn::bwd_da_smem<C>();
  constexpr size_t smem_dw = tcn::bwd_dh_dw_smem<C>();
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        tcn_multistack_bwd_da_kernel<C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_da);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(tcn_multistack_bwd_dh_dw_kernel<C>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_dw);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const int row_blocks = (T + kTile - 1) / kTile;
  const int chunks = tcn::wgrad_chunks(T);
  for (int l = Lt - 1; l >= 0; --l) {
    const int stage = l < L0 ? 0 : 1 + (l - L0) / Lr;
    const int local = l < L0 ? l : (l - L0) % Lr;
    const bool is_end = local == (l < L0 ? L0 : Lr) - 1;
    tcn_multistack_bwd_da_kernel<C><<<row_blocks, kThreads, smem_da, stream>>>(
        dx, g, y_saved, w1, mask, dz, da, T, l, is_end ? stage : -1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
    tcn_multistack_bwd_dh_dw_kernel<C>
        <<<row_blocks + 4 * chunks, kThreads, smem_dw, stream>>>(
            dx, h_saved, y_saved, w3, dz, da, partial, T, chunks, row_blocks, l,
            1 << local, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  const long long n = (long long)Lt * entries(C);
  const int threads = 256;
  tcn_multistack_wgrad_kernel<<<(int)((n + threads - 1) / threads), threads, 0,
                                stream>>>(partial, dw3, db3, dw1, db1, Lt,
                                          chunks, C);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

}  // namespace

// The number of 128-row chunks the weight partials of one layer cover: the
// partial buffer of tcn_multistack_bwd is (Lt, chunks, 4C^2 + 2C).
extern "C" int tcn_multistack_wgrad_chunks(int T) { return tcn::wgrad_chunks(T); }

// The whole backward in one call, 2 Lt + 1 launches. dx is zeroed by the
// caller and holds the gradient at the input on return; dz, da are (T, C)
// scratch. launched is raised by one after each launch the runtime accepted.
// Returns a cudaError_t code: 0 when all were.
extern "C" int tcn_multistack_bwd(float* dx, const float* g,
                                  const float* h_saved, const float* y_saved,
                                  const float* w3, const float* w1,
                                  const unsigned char* mask, float* dz,
                                  float* da, float* partial, float* dw3,
                                  float* db3, float* dw1, float* db1, int T,
                                  int C, int Lt, int L0, int Lr, int causal,
                                  int* launched, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return run<8>(dx, g, h_saved, y_saved, w3, w1, mask, dz, da, partial, dw3, db3, dw1, db1, T, Lt, L0, Lr, causal, launched, s);
    case 16: return run<16>(dx, g, h_saved, y_saved, w3, w1, mask, dz, da, partial, dw3, db3, dw1, db1, T, Lt, L0, Lr, causal, launched, s);
    case 32: return run<32>(dx, g, h_saved, y_saved, w3, w1, mask, dz, da, partial, dw3, db3, dw1, db1, T, Lt, L0, Lr, causal, launched, s);
    case 64: return run<64>(dx, g, h_saved, y_saved, w3, w1, mask, dz, da, partial, dw3, db3, dw1, db1, T, Lt, L0, Lr, causal, launched, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* tcn_multistack_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
