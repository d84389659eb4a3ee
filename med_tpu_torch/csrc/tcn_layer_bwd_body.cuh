// The bodies of the dilated residual TCN layer's backward, shared by the
// kernels of tcn_layer_bwd.cu (stacks with per-stage operands) and
// tcn_multistack_bwd.cu (operands concatenated on the layer axis).
//
// Per layer, from the forward's saved input h and post-relu y:
//   dz  = dh * 2*mask                       (dh when there is no mask)
//   dW1 = y^T dz,  db1 = sum_t dz
//   da  = (dz W1^T) * [y > 0],  db3 = sum_t da
//   dW3_j = sum_t h[t - s_j]^T da[t]
//   dh[u] <- dh[u] + sum_j da[u + s_j] W3_j^T
// Taps s = (2d, d, 0) causal or (d, 0, -d) acausal; rows outside [0, T)
// are zero. h, y, dh (T, C) row-major; w3 (3, C, C) and w1 (C, C) [in][out].
//
// Blocks run in no order, so each layer is two launches:
// 1. bwd_da_body, one block per 32 rows: adds the stage cotangent (gadd, at
//    the last layer of a stage) into dh in place, writes dz and da to
//    scratch. W1 is staged transposed in shared memory so the threads of a
//    warp (consecutive channels) read consecutive words.
// 2. bwd_dh_dw_body, two kinds of blocks in one grid:
//    - row blocks update dh in place from the three shifted da tiles: dh[u]
//      needs da at rows u + s_j that other blocks own, which is why da went
//      to device memory in launch 1 (the cross-block dependency);
//    - weight blocks, one per (128-row chunk p, product k): k = 0 makes
//      y^T dz and sum dz, k = 1..3 make h[t - s_j]^T da (and k = 1 sum da),
//      as partial sums for chunk p.
// No atomics: the partials of every layer land in their own slots, and
// wgrad_reduce_body sums them over the chunks in a fixed order after the
// last layer, so the gradients are the same from run to run.

#pragma once

#include <cuda_runtime.h>

#include "tcn_layer_body.cuh"

namespace tcn {

constexpr int kChunk = 128;    // rows of T per weight-gradient partial

__host__ __device__ constexpr int entries(int C) { return 4 * C * C + 2 * C; }

// Launch 1 of a layer: adds gadd (or nothing, when null) into dh in place,
// writes dz = dh * 2*mask and da = (dz W1^T) * [y > 0].
template <int C>
__device__ __forceinline__ void bwd_da_body(
    float* __restrict__ dh, const float* __restrict__ gadd,
    const float* __restrict__ y, const float* __restrict__ w1,
    const unsigned char* __restrict__ mask, float* __restrict__ dz,
    float* __restrict__ da, int T, float* smem) {
  constexpr int kGroups = kThreads / C;
  constexpr int kRows = kTile / kGroups;
  float* w1t = smem;              // [C][C]: w1t[b][a] = w1[a][b]
  float* dzs = w1t + C * C;       // [kTile][C]

  const int t0 = blockIdx.x * kTile;
  for (int i = threadIdx.x; i < C * C; i += kThreads)
    w1t[(i % C) * C + i / C] = w1[i];
  for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
    const int t = t0 + i / C;
    float v = 0.f;
    if (t < T) {
      const long long at = (long long)t * C + i % C;
      v = dh[at];
      if (gadd != nullptr) {
        v += gadd[at];
        dh[at] = v;
      }
      if (mask != nullptr) v *= (float)mask[at] * 2.f;
      dz[at] = v;
    }
    dzs[i] = v;
  }
  __syncthreads();

  const int a = threadIdx.x % C;
  const int g = threadIdx.x / C;
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  for (int b = 0; b < C; ++b) {
    const float w = w1t[b * C + a];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      acc[i] = fmaf(dzs[(g + i * kGroups) * C + b], w, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = t0 + g + i * kGroups;
    if (t >= T) continue;
    const long long at = (long long)t * C + a;
    da[at] = y[at] > 0.f ? acc[i] : 0.f;
  }
}

template <int C>
__device__ void dh_rows(float* __restrict__ dh, const float* __restrict__ da,
                        const float* __restrict__ w3, int T, const int* shift,
                        float* smem) {
  constexpr int kGroups = kThreads / C;
  constexpr int kRows = kTile / kGroups;
  float* w3t = smem;                 // [3][C][C]: w3t[j][o][c] = w3[j][c][o]
  float* das = w3t + 3 * C * C;      // [3][kTile][C]: das[j][r] = da[t0 + r + s_j]

  const int t0 = blockIdx.x * kTile;
  for (int i = threadIdx.x; i < 3 * C * C; i += kThreads) {
    const int j = i / (C * C);
    const int r = i % (C * C);
    w3t[j * C * C + (r % C) * C + r / C] = w3[i];
  }
  for (int i = threadIdx.x; i < 3 * kTile * C; i += kThreads) {
    const int j = i / (kTile * C);
    const int r = (i / C) % kTile;
    const int src = t0 + r + shift[j];
    das[i] = (src >= 0 && src < T) ? da[(long long)src * C + i % C] : 0.f;
  }
  __syncthreads();

  const int c = threadIdx.x % C;
  const int g = threadIdx.x / C;
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  for (int j = 0; j < 3; ++j) {
    const float* dj = das + j * kTile * C;
    const float* wj = w3t + j * C * C;
    for (int o = 0; o < C; ++o) {
      const float w = wj[o * C + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        acc[i] = fmaf(dj[(g + i * kGroups) * C + o], w, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = t0 + g + i * kGroups;
    if (t < T) dh[(long long)t * C + c] += acc[i];
  }
}

// Partial sums of one product over one chunk of rows: out[a][b] =
// sum_t A[t][a] B[t][b], and colsum[b] = sum_t B[t][b] when wanted. Each of
// the first C*C/16 threads keeps a 4x4 tile of out in registers: per row it
// reads 4 values of A (a broadcast within the warp) and 4 of B, for 16 FMAs.
template <int C>
__device__ void weight_chunk(const float* __restrict__ A, int a_shift,
                             const float* __restrict__ B, int T, int r0, int r1,
                             float* __restrict__ out,
                             float* __restrict__ colsum, float* smem) {
  constexpr int kTiles = C / 4;   // 4x4 tiles along each side
  float* As = smem;               // [kTile][C]
  float* Bs = As + kTile * C;     // [kTile][C]
  const bool tiler = threadIdx.x < kTiles * kTiles;
  const int a0 = 4 * (threadIdx.x / kTiles);
  const int b0 = 4 * (threadIdx.x % kTiles);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float cs = 0.f;
  for (int base = r0; base < r1; base += kTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
      const int t = base + i / C;
      const int src = t - a_shift;
      const bool row = t < r1;
      As[i] = (row && src >= 0 && src < T) ? A[(long long)src * C + i % C] : 0.f;
      Bs[i] = row ? B[(long long)t * C + i % C] : 0.f;
    }
    __syncthreads();
    if (tiler) {
      for (int r = 0; r < kTile; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(As + r * C + a0);
        const float4 bv = *reinterpret_cast<const float4*>(Bs + r * C + b0);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
    if (colsum != nullptr && threadIdx.x < C)
      for (int r = 0; r < kTile; ++r) cs += Bs[r * C + threadIdx.x];
  }
  if (tiler) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(out + (a0 + i) * C + b0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  if (colsum != nullptr && threadIdx.x < C) colsum[threadIdx.x] = cs;
}

// Blocks [0, row_blocks) update dh; the rest make the weight partials of
// chunk p = wb / 4, product k = wb % 4, into partial[p] laid out
// [dW3 (3, C, C) | db3 (C) | dW1 (C, C) | db1 (C)].
template <int C>
__device__ __forceinline__ void bwd_dh_dw_body(
    float* __restrict__ dh, const float* __restrict__ h,
    const float* __restrict__ y, const float* __restrict__ w3,
    const float* __restrict__ dz, const float* __restrict__ da,
    float* __restrict__ partial, int T, int row_blocks, int s0, int s1, int s2,
    float* smem) {
  const int shift[3] = {s0, s1, s2};
  if ((int)blockIdx.x < row_blocks) {
    dh_rows<C>(dh, da, w3, T, shift, smem);
    return;
  }
  const int wb = blockIdx.x - row_blocks;
  const int p = wb / 4;
  const int k = wb % 4;
  const int r0 = p * kChunk;
  const int r1 = min(T, r0 + kChunk);
  float* part = partial + (long long)p * entries(C);
  if (k == 0) {
    weight_chunk<C>(y, 0, dz, T, r0, r1, part + 3 * C * C + C,
                    part + 4 * C * C + C, smem);
  } else {
    const int j = k - 1;
    weight_chunk<C>(h, shift[j], da, T, r0, r1, part + j * C * C,
                    j == 0 ? part + 3 * C * C : nullptr, smem);
  }
}

// Sums the partials of L layers over their P chunks, in chunk order, into
// the (L, ...) gradients; one thread per output entry.
__device__ __forceinline__ void wgrad_reduce_body(
    const float* __restrict__ partial, float* __restrict__ dw3,
    float* __restrict__ db3, float* __restrict__ dw1, float* __restrict__ db1,
    int L, int P, int C) {
  const int E = entries(C);
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)L * E) return;
  const int l = (int)(idx / E);
  const int e = (int)(idx % E);
  const float* src = partial + (long long)l * P * E + e;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += src[(long long)p * E];
  const int c2 = C * C;
  if (e < 3 * c2) dw3[(long long)l * 3 * c2 + e] = s;
  else if (e < 3 * c2 + C) db3[(long long)l * C + e - 3 * c2] = s;
  else if (e < 4 * c2 + C) dw1[(long long)l * c2 + e - 3 * c2 - C] = s;
  else db1[(long long)l * C + e - 4 * c2 - C] = s;
}

// dynamic shared memory of one block of each launch, in bytes
template <int C>
constexpr size_t bwd_da_smem() {
  return (size_t)(C * C + kTile * C) * sizeof(float);
}
template <int C>
constexpr size_t bwd_dh_dw_smem() {
  return (size_t)(3 * C * C + 3 * kTile * C) * sizeof(float);
}

inline int wgrad_chunks(int T) { return (T + kChunk - 1) / kChunk; }

}  // namespace tcn
