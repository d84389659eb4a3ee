// Banded sliding-window attention, forward, in the head-major layout.
//
// Replaces med_tpu/ops/attention.py::_swa_kernel, the Pallas TPU kernel
// behind sliding_window_attention_pallas.
//
// Layout, as at the Python function:
//   q    (H, T, M, D)  M query tokens a frame; token n = t*M + j of frame t
//   k, v (H, T, D)     one key and one value row per frame
//   out  (H, T, M, D)
// Query n attends the keys of frames t-W+1 .. t. Frames before 0 are zero
// keys: they score exactly 0 and stay inside the softmax (there is no mask),
// which is how the reference zero-pads its windows. The zero halo is made
// here, in shared memory: the host pads and copies nothing.
//
// What bounds it on an H100: memory. Per query it reads D floats of q and
// writes D of out (8*D bytes) against 16 FMAs and one exp a (query, key)
// pair; at COG's D=8, W=30 that is ~15 flop/byte, under the card's fp32
// ridge of ~20 flop/byte (67 TFLOP/s over 3.35 TB/s).
//
// Design: the packed forward's (swa_packed_fwd.cu, K1), in this layout.
// One pass over the keys: a thread holds R query slots of one frame (R = 2
// for D <= 8, else 1), so each key row read from shared memory feeds R
// queries, and holds their scores of a chunk of 16 keys in registers, with
// an online max and sum across chunks (swa_common.cuh). Blocks of 128
// threads cover fpb whole frames of one head (a slice of one frame's slots
// where M is large) and stage the K/V rows of the padded frames
// [t0-W+1, t0+fpb+Wc-1), Wc = W rounded up to whole chunks, zero-filled
// outside [0, T), by cp.async while the threads load their q. Here a
// token's D features are contiguous, and so are the K/V rows: where every
// pointer is 16-byte aligned the copies and the loads and stores of q and
// out move 16 bytes, else 4 (the instance the C entry picks and reports).
// No stats are written.

#include <cuda_runtime.h>
#include <math.h>

#include "swa_common.cuh"

namespace {

using swa::kChunk;

constexpr int kThreads = 128;
constexpr size_t kMaxSmem = 227 * 1024;

// Block (tile * nsb + sb, h): frames t0 = tile*fpb .. +fpb-1, slots sb*spb ..
// +spb-1 of each; thread (frame lt, slot group) = (tid / tpf, tid % tpf).
template <int D, int R, bool V>
__global__ void __launch_bounds__(kThreads)
swa_headmajor_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out, int T, int m,
                         int W, int fpb, int spb, int tpf, int nsb) {
  extern __shared__ __align__(16) float smem[];
  const int rows = fpb + (W + kChunk - 1) / kChunk * kChunk - 1;
  float* ks = smem;              // [rows][D], row r: frame t0 - (W-1) + r
  float* vs = smem + rows * D;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x / nsb * fpb;
  const int sb = blockIdx.x % nsb;
  const float* kh = k + (long long)h * T * D;
  const float* vh = v + (long long)h * T * D;
  // the rows lie back to back in device memory: consecutive threads copy
  // consecutive 16-byte pieces
  for (int u = threadIdx.x; u < rows * (D / 4); u += blockDim.x) {
    const int f = t0 - (W - 1) + u / (D / 4);
    const bool in = f >= 0 && f < T;
    const long long at = in ? (long long)f * D + 4 * (u % (D / 4)) : 0;
    swa::copy4<V>(ks + 4 * u, kh + at, in);
    swa::copy4<V>(vs + 4 * u, vh + at, in);
  }
  swa::cp_async_commit();

  const int lt = threadIdx.x / tpf;
  const int t = t0 + lt;
  const int j = sb * spb + threadIdx.x % tpf * R;       // the thread's first slot
  const int j_end = min(m, (sb + 1) * spb);
  const bool live = lt < fpb && t < T && j < j_end;
  const float scale = 1.f / sqrtf((float)D);
  const long long n = ((long long)h * T + t) * m + j;   // token of the first slot
  float qr[R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (live && j + r < j_end) {
      swa::load_row<D, V>(qr[r], q + (n + r) * D);
#pragma unroll
      for (int d = 0; d < D; ++d) qr[r][d] *= scale;
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) qr[r][d] = 0.f;
    }
  }
  swa::cp_async_wait_all();
  __syncthreads();
  if (!live) return;

  // key w of frame t sits at local row lt + w
  float mx[R], sum[R], acc[R][D];
  swa::band_attend<D, R>(qr, ks, vs, lt, W, mx, sum, acc);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (j + r >= j_end) break;
    const float rs = 1.f / sum[r];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[r][d] *= rs;
    swa::store_row<D, V>(out + (n + r) * D, acc[r]);
  }
}

template <int D, bool V>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, int H, int T,
                   int m, int W, cudaStream_t stream) {
  constexpr int R = D <= 8 ? 2 : 1;
  const int slot_threads = (m + R - 1) / R;
  int tpf, spb, nsb, fpb;
  if (slot_threads <= kThreads) {
    tpf = slot_threads, spb = m, nsb = 1, fpb = kThreads / slot_threads;
  } else {
    tpf = kThreads, spb = kThreads * R, nsb = (m + spb - 1) / spb, fpb = 1;
  }
  const int wc = (W + kChunk - 1) / kChunk * kChunk;
  auto smem_of = [&](int frames) { return 2 * (size_t)(frames + wc - 1) * D * sizeof(float); };
  while (fpb > 1 && smem_of(fpb) > kMaxSmem) fpb /= 2;
  const size_t smem = smem_of(fpb);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = swa_headmajor_fwd_kernel<D, R, V>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = (fpb * tpf + 31) / 32 * 32;
  const dim3 grid((T + fpb - 1) / fpb * nsb, H);
  kernel<<<grid, threads, smem, stream>>>(q, k, v, out, T, m, W, fpb, spb, tpf, nsb);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, int H, int T,
                   int m, int W, bool vec, cudaStream_t stream) {
  return vec ? launch<D, true>(q, k, v, out, H, T, m, W, stream)
             : launch<D, false>(q, k, v, out, H, T, m, W, stream);
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. One launch.
// *instance receives the accesses the launch makes to device memory: 0 for
// 16 bytes (every pointer 16-byte aligned), 1 for 4 bytes.
extern "C" int swa_headmajor_fwd(const float* q, const float* k, const float* v,
                                 float* out, int H, int D, int T, int m, int W,
                                 int* instance, void* stream) {
  if (H < 1 || T < 1 || m < 1 || W < 1) return cudaErrorInvalidValue;
  const bool vec = swa::aligned16(q) && swa::aligned16(k) && swa::aligned16(v) &&
                   swa::aligned16(out);
  *instance = vec ? 0 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 4: return launch<4>(q, k, v, out, H, T, m, W, vec, s);
    case 8: return launch<8>(q, k, v, out, H, T, m, W, vec, s);
    case 16: return launch<16>(q, k, v, out, H, T, m, W, vec, s);
    case 32: return launch<32>(q, k, v, out, H, T, m, W, vec, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* swa_headmajor_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
