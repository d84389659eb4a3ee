// The stride-1 bottleneck blocks of a ResNet-50 stage at inference, BN
// folded: one block is three launches of one implicit-GEMM kernel.
//
// Replaces the Pallas TPU kernel med_tpu/ops/resnet_fused.py::_stage_kernel
// (behind fused_bottleneck_stage and resnet50_fused_apply). That kernel runs
// a whole stage for one image a grid step with the activation resident in
// VMEM. Per block, on activations x (B*H*W rows, Cin) row-major:
//
//   y1  = round(relu(x @ w1 + c1))                          1x1 reduce
//   y2  = round(relu(c2 + sum_tap shift_tap(y1) @ w2[tap])) 3x3, 9 taps
//   out = round(relu(y2 @ w3 + c3 + res))                   1x1 expand
//
// res is x itself, or the stride-1 projection x @ wd + cd of a stage's first
// block. Tap (dy, dx) reads y1 at (h + dy, w + dx), zero outside the image:
// no wrap across image rows or between images. round() is the cast to the
// working type (float or bf16); products and sums are fp32, the biases c
// stay fp32 and the residual is added in fp32, as in the TPU kernel.
//
// What bounds it on an H100: operations. At full width a stage is ~1.3
// GFLOP an image against ~2 MB of bf16 activations in and out (~650
// flop/byte, far above the bf16 tensor-core ridge of ~295).
//
// Design: the TPU kernel's one launch per stage does not carry over: stage
// 0's activation is 1.6 MB an image against 227 KB of shared memory, and
// blocks of a grid run in no order. So each of the three products of a block
// is one launch, and y1 and y2 go through device memory (L2 holds much of
// them). Each launch computes C (M, N) = A (M, K) @ B (K, N) with a mode
// that says how A is read: the activation itself (reduce), the 9 shifted
// views of y1 with the image edges masked (K = 9f, k = tap * f + c), or y2
// and x side by side (K = f + Cin) so that the projection shares the expand's
// accumulators. A block of 256 threads owns a 128 x 64 tile of C; per k-step
// of 16 it stages A (transposed, as fp32) and B in shared memory, double
// buffered, with the next step's loads held in registers during the current
// step's products. Each thread keeps an 8 x 4 tile of sums in registers and
// reads its A and B values as float4 from shared memory. Products are fp32
// FMAs on CUDA cores (no tensor cores, so the float instance never sees
// TF32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;       // rows of C per block
constexpr int kBN = 64;        // columns of C per block
constexpr int kBK = 16;        // k per step
constexpr int kThreads = 256;
constexpr int kPad = 4;        // keeps the transposed A stores off one bank
constexpr int kRowsPerThread = kBM / (kThreads / kBK);   // A rows a thread loads

enum Mode { kReduce = 0, kConv3 = 1, kExpand = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// a0: reduce x (M, K0); conv3 y1 (M, K0 = f); expand y2 (M, K0 = f).
// a1: expand with projection, x (M, K1); else unused (K1 = 0).
// b0: (K0, N), or (9 * K0, N) for conv3; b1: (K1, N).
// bias1: the projection's bias or null; res: the identity residual (M, N)
// or null. H, W: image height and width (conv3).
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
stage_gemm_kernel(const T* __restrict__ a0, const T* __restrict__ a1,
                  const T* __restrict__ b0, const T* __restrict__ b1,
                  const float* __restrict__ bias0,
                  const float* __restrict__ bias1, const T* __restrict__ res,
                  T* __restrict__ out, int M, int N, int K0, int K1, int H,
                  int W) {
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int K = MODE == kConv3 ? 9 * K0 : K0 + K1;
  const int steps = (K + kBK - 1) / kBK;

  // A loads: thread -> one k of the step, rows ar + 16 i
  const int ak = tid % kBK;
  const int ar = tid / kBK;
  // image position of each loaded row (conv3), packed h << 16 | w; -1 past M
  int pos[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int m = m0 + ar + i * (kThreads / kBK);
    if (m >= M) {
      pos[i] = -1;
    } else if (MODE == kConv3) {
      const int p = m % (H * W);
      pos[i] = ((p / W) << 16) | (p % W);
    } else {
      pos[i] = 0;
    }
  }
  // B loads: thread -> row bk of the step, 4 consecutive columns
  const int bk = tid / (kBN / 4);
  const int bn = (tid % (kBN / 4)) * 4;

  float a_next[kRowsPerThread];
  float b_next[4];

  auto load = [&](int step) {
    const int k = step * kBK + ak;
    int dy = 0, dx = 0, c = k;
    const T* src = a0;
    int ld = K0;
    if (MODE == kConv3) {
      const int tap = k / K0;
      c = k - tap * K0;
      dy = tap / 3 - 1;
      dx = tap % 3 - 1;
    } else if (MODE == kExpand && k >= K0) {
      src = a1;
      ld = K1;
      c = k - K0;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int m = m0 + ar + i * (kThreads / kBK);
      float v = 0.f;
      if (pos[i] >= 0 && k < K) {
        if (MODE == kConv3) {
          const int h = (pos[i] >> 16) + dy;
          const int w = (pos[i] & 0xffff) + dx;
          if (h >= 0 && h < H && w >= 0 && w < W)
            v = to_float(src[(long long)(m + dy * W + dx) * ld + c]);
        } else {
          v = to_float(src[(long long)m * ld + c]);
        }
      }
      a_next[i] = v;
    }
    const int kb = step * kBK + bk;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + bn + j;
      float v = 0.f;
      if (kb < K && n < N) {
        if (MODE == kExpand && kb >= K0)
          v = to_float(b1[(long long)(kb - K0) * N + n]);
        else
          v = to_float(b0[(long long)kb * N + n]);
      }
      b_next[j] = v;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      As[buf][ak][ar + i * (kThreads / kBK)] = a_next[i];
    *reinterpret_cast<float4*>(&Bs[buf][bk][bn]) =
        make_float4(b_next[0], b_next[1], b_next[2], b_next[3]);
  };

  // each thread: rows ty * 8 .. + 7, columns tx * 4 .. + 3 of the tile
  const int tx = tid % (kBN / 4);
  const int ty = tid / (kBN / 4);
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(0);
  stash(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load(s + 1);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 alo = *reinterpret_cast<const float4*>(&As[buf][k][ty * 8]);
      const float4 ahi = *reinterpret_cast<const float4*>(&As[buf][k][ty * 8 + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float a[8] = {alo.x, alo.y, alo.z, alo.w, ahi.x, ahi.y, ahi.z, ahi.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    // the other buffer was last read before the previous step's barrier
    if (s + 1 < steps) stash(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    if (n >= N) continue;
    float bias = bias0[n];
    if (bias1 != nullptr) bias += bias1[n];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + ty * 8 + i;
      if (m >= M) continue;
      const long long at = (long long)m * N + n;
      float v = acc[i][j] + bias;
      if (res != nullptr) v += to_float(res[at]);
      out[at] = from_float<T>(fmaxf(v, 0.f));
    }
  }
}

template <typename T, int MODE>
cudaError_t launch(const void* a0, const void* a1, const void* b0,
                   const void* b1, const float* bias0, const float* bias1,
                   const void* res, void* out, int M, int N, int K0, int K1,
                   int H, int W, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  stage_gemm_kernel<T, MODE><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a0), static_cast<const T*>(a1),
      static_cast<const T*>(b0), static_cast<const T*>(b1), bias0, bias1,
      static_cast<const T*>(res), static_cast<T*>(out), M, N, K0, K1, H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int mode, const void* a0, const void* a1, const void* b0,
                     const void* b1, const float* bias0, const float* bias1,
                     const void* res, void* out, int M, int N, int K0, int K1,
                     int H, int W, cudaStream_t stream) {
  switch (mode) {
    case kReduce:
      return launch<T, kReduce>(a0, a1, b0, b1, bias0, bias1, res, out, M, N,
                                K0, 0, H, W, stream);
    case kConv3:
      return launch<T, kConv3>(a0, a1, b0, b1, bias0, bias1, res, out, M, N,
                               K0, 0, H, W, stream);
    case kExpand:
      return launch<T, kExpand>(a0, a1, b0, b1, bias0, bias1, res, out, M, N,
                                K0, K1, H, W, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One product of a bottleneck block; returns a cudaError_t code, 0 when the
// launch was accepted. mode: 0 reduce, 1 3x3, 2 expand. bf16: 0 for float
// tensors, 1 for bfloat16. a1, b1, bias1 (the projection) and res (the
// identity residual) may be null; K1 is 0 without a projection.
extern "C" int resnet_stage_gemm(int mode, int bf16, const void* a0,
                                 const void* a1, const void* b0,
                                 const void* b1, const float* bias0,
                                 const float* bias1, const void* res,
                                 void* out, int M, int N, int K0, int K1,
                                 int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K0 <= 0 || K1 < 0 || H <= 0 || W <= 0 ||
      W > 0xffff || H > 0x7fff)
    return cudaErrorInvalidValue;
  if (bf16)
    return dispatch<__nv_bfloat16>(mode, a0, a1, b0, b1, bias0, bias1, res,
                                   out, M, N, K0, K1, H, W, s);
  return dispatch<float>(mode, a0, a1, b0, b1, bias0, bias1, res, out, M, N,
                         K0, K1, H, W, s);
}

extern "C" const char* resnet_stage_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
