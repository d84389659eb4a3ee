// Banded sliding-window attention, forward, in the packed layout.
//
// Replaces med_tpu/ops/attention.py::_swa_packed_fwd_kernel, the Pallas TPU
// kernel behind sliding_window_attention_packed_fwd.
//
// Layout, as at the Python function:
//   q     (H, D, N)  N = T*m query tokens; token n = t*m + j belongs to frame t
//   k, v  (H, D, T)  one key and one value row per frame
//   out   (H, D, N)
//   stats (H, 2, N)  row 0 the logsumexp of each query's banded scores,
//                    row 1 the reciprocal of its softmax sum
// Query n attends the keys of frames t-W+1 .. t. Frames before 0 are zero
// keys: they score exactly 0 and stay inside the softmax (there is no mask),
// which is how the reference zero-pads its windows.
//
// What bounds it on an H100: memory. Per query it reads D floats of q and
// writes D of out and 2 of stats (4*(2D+2) bytes), against 16 FMAs and one
// exp a (query, key) pair; at COG's D=8, W=30 that is ~13 flop/byte, under
// the card's fp32 ridge of ~20 flop/byte (67 TFLOP/s over 3.35 TB/s). The
// K/V rows are tiny (D floats a frame) and are shared by the m queries of a
// frame and by W frames.
//
// Design: one pass over the keys. A thread holds R query slots of one frame
// (R = 4 for D = 2, 2 for D <= 8, else 1), so each key row read from
// shared memory feeds R queries, and holds their scores of a chunk of 16
// keys in registers: the chunk's max, one expf a score, the sum and the
// weighted sum of values, with an online rescale between chunks (COG's
// W=30: two chunks).
// Each score is computed once: D FMAs for the score and D for the values a
// pair. Blocks of 128 threads at ~100 registers a thread (D=8): five
// blocks an SM. A block covers fpb whole frames of one head (a slice of one
// frame's slots where m is large) and stages the K/V rows of the padded
// frames [t0-W+1, t0+fpb+Wc-1), Wc = W rounded up to whole chunks, with
// 4-byte cp.async, zero-filled outside [0, T), while the threads load their
// q; consecutive threads fill consecutive words, so the stores meet no bank
// conflict. expf and logf, not the fast intrinsics, keep the parity with
// the reference.
//
// D = 2 (TransSVNet's head width: its model width is the 2 classes, its
// m = W = 30 window positions attend their window): a pair is 4 FMAs and
// one exp, so the kernel is bound by the query tokens' bytes. Key rows are
// 8 bytes, read from shared memory as float2 (swa_common.cuh), and a thread
// takes 4 slots (8 threads and 32 slots a frame at m = 30, 16 frames a
// block), so a key row feeds 4 queries.

#include <cuda_runtime.h>
#include <math.h>

#include "swa_common.cuh"

namespace {

using swa::kChunk;

constexpr int kThreads = 128;
constexpr size_t kMaxSmem = 227 * 1024;

// Block (tile * nsb + sb, h): frames t0 = tile*fpb .. +fpb-1, slots sb*spb ..
// +spb-1 of each; thread (frame lt, slot group) = (tid / tpf, tid % tpf).
template <int D, int R>
__global__ void __launch_bounds__(kThreads)
swa_packed_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ stats, int T, int m, int W, int fpb, int spb,
                      int tpf, int nsb) {
  extern __shared__ __align__(16) float smem[];
  const int rows = fpb + (W + kChunk - 1) / kChunk * kChunk - 1;
  float* ks = smem;              // [rows][D], row r: frame t0 - (W-1) + r
  float* vs = smem + rows * D;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x / nsb * fpb;
  const int sb = blockIdx.x % nsb;
  const long long N = (long long)T * m;
  const float* kh = k + (long long)h * D * T;
  const float* vh = v + (long long)h * D * T;
  for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x) {
    const int d = idx % D;
    const int f = t0 - (W - 1) + idx / D;
    const bool in = f >= 0 && f < T;
    const long long at = in ? (long long)d * T + f : 0;
    swa::cp_async4(ks + idx, kh + at, in ? 4 : 0);
    swa::cp_async4(vs + idx, vh + at, in ? 4 : 0);
  }
  swa::cp_async_commit();

  const int lt = threadIdx.x / tpf;
  const int t = t0 + lt;
  const int j = sb * spb + threadIdx.x % tpf * R;       // the thread's first slot
  const int j_end = min(m, (sb + 1) * spb);
  const bool live = lt < fpb && t < T && j < j_end;
  const float scale = 1.f / sqrtf((float)D);
  const float* qh = q + (long long)h * D * N + (long long)t * m + j;
  float qr[R][D];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int d = 0; d < D; ++d)
      qr[r][d] = live && j + r < j_end ? qh[(long long)d * N + r] * scale : 0.f;
  swa::cp_async_wait_all();
  __syncthreads();
  if (!live) return;

  // key w of frame t sits at local row lt + w
  float mx[R], sum[R], acc[R][D];
  swa::band_attend<D, R>(qr, ks, vs, lt, W, mx, sum, acc);
  float* oh = out + (long long)h * D * N + (long long)t * m + j;
  float* sh = stats + (long long)h * 2 * N + (long long)t * m + j;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (j + r >= j_end) break;
    const float rs = 1.f / sum[r];
#pragma unroll
    for (int d = 0; d < D; ++d) oh[(long long)d * N + r] = acc[r][d] * rs;
    sh[r] = mx[r] + logf(sum[r]);
    sh[N + r] = rs;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   float* stats, int H, int T, int m, int W, cudaStream_t stream) {
  constexpr int R = D <= 2 ? 4 : D <= 8 ? 2 : 1;
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
  auto kernel = swa_packed_fwd_kernel<D, R>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = (fpb * tpf + 31) / 32 * 32;
  const dim3 grid((T + fpb - 1) / fpb * nsb, H);
  kernel<<<grid, threads, smem, stream>>>(q, k, v, out, stats, T, m, W, fpb, spb, tpf, nsb);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. One launch.
extern "C" int swa_packed_fwd(const float* q, const float* k, const float* v,
                              float* out, float* stats, int H, int D, int T,
                              int m, int W, void* stream) {
  if (H < 1 || T < 1 || m < 1 || W < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 2: return launch<2>(q, k, v, out, stats, H, T, m, W, s);
    case 4: return launch<4>(q, k, v, out, stats, H, T, m, W, s);
    case 8: return launch<8>(q, k, v, out, stats, H, T, m, W, s);
    case 16: return launch<16>(q, k, v, out, stats, H, T, m, W, s);
    case 32: return launch<32>(q, k, v, out, stats, H, T, m, W, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* swa_packed_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
