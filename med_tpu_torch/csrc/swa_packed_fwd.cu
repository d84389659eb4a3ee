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
// writes D of out and 2 of stats (4*(2D+2) bytes), against 4*W*D flops; at
// COG's D=8, W=30 that is ~13 flop/byte, under the card's fp32 ridge of
// ~20 flop/byte (67 TFLOP/s over 3.35 TB/s). The K/V rows are tiny (D floats a
// frame) and are shared by the m queries of a frame and by W frames.
//
// Design: one thread per (head, query token), so the threads of a warp read
// q and write out/stats at consecutive addresses along N. A block covers fpb
// whole frames of one head and stages the K/V rows of the padded frames
// [t0, t0+fpb+W-1) in shared memory, zeros left of frame 0, so every key a
// thread needs is read once from device memory per block. Each thread makes
// two passes over its W keys in shared memory: the max, then exp, sum and
// the weighted sum of values (expf, not __expf, to stay within the parity
// tolerance of the reference).

#include <cuda_runtime.h>
#include <math.h>

namespace {

template <int D>
__global__ void swa_packed_fwd_kernel(const float* __restrict__ q,
                                      const float* __restrict__ k,
                                      const float* __restrict__ v,
                                      float* __restrict__ out,
                                      float* __restrict__ stats,
                                      int T, int m, int W, int fpb) {
  extern __shared__ float smem[];
  const int rows = fpb + W - 1;
  float* ks = smem;              // [rows][D]
  float* vs = smem + rows * D;   // [rows][D]
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * fpb;
  const long long N = (long long)T * m;
  const float* kh = k + (long long)h * D * T;
  const float* vh = v + (long long)h * D * T;

  // row r holds original frame t0 - (W-1) + r; consecutive threads take
  // consecutive frames of one feature row, so the loads coalesce
  for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x) {
    const int r = idx % rows;
    const int d = idx / rows;
    const int f = t0 - (W - 1) + r;
    const bool inside = f >= 0 && f < T;
    ks[r * D + d] = inside ? kh[(long long)d * T + f] : 0.f;
    vs[r * D + d] = inside ? vh[(long long)d * T + f] : 0.f;
  }
  __syncthreads();

  const int lt = threadIdx.x / m;   // frame within the block
  const int t = t0 + lt;
  if (lt >= fpb || t >= T) return;
  const long long n = (long long)t * m + threadIdx.x % m;

  const float scale = 1.f / sqrtf((float)D);
  const float* qh = q + (long long)h * D * N;
  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = qh[(long long)d * N + n] * scale;

  // key w of frame t sits at local row lt + w
  float mx = -INFINITY;
  for (int w = 0; w < W; ++w) {
    const float* kr = ks + (lt + w) * D;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
    mx = fmaxf(mx, s);
  }
  float sum = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int w = 0; w < W; ++w) {
    const float* kr = ks + (lt + w) * D;
    const float* vr = vs + (lt + w) * D;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
    const float p = expf(s - mx);
    sum += p;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
  }
  const float rs = 1.f / sum;
  float* oh = out + (long long)h * D * N;
#pragma unroll
  for (int d = 0; d < D; ++d) oh[(long long)d * N + n] = acc[d] * rs;
  stats[(long long)h * 2 * N + n] = mx + logf(sum);
  stats[(long long)h * 2 * N + N + n] = rs;
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   float* stats, int H, int T, int m, int W, cudaStream_t stream) {
  const int fpb = m >= 256 ? 1 : 256 / m;
  const int threads = (fpb * m + 31) / 32 * 32;
  if (threads > 1024) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)(fpb + W - 1) * D * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        swa_packed_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((T + fpb - 1) / fpb, H);
  swa_packed_fwd_kernel<D><<<grid, threads, smem, stream>>>(q, k, v, out, stats,
                                                           T, m, W, fpb);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int swa_packed_fwd(const float* q, const float* k, const float* v,
                              float* out, float* stats, int H, int D, int T,
                              int m, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
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
