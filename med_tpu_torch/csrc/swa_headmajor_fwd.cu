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
// writes D of out (8*D bytes) against 4*W*D flops; at COG's D=8, W=30 that
// is 15 flop/byte, under the card's fp32 ridge of ~20 flop/byte (67 TFLOP/s
// over 3.35 TB/s).
//
// Design: as the packed kernel (swa_packed_fwd.cu), one thread per (head,
// query token), a block covering fpb whole frames of one head with the K/V
// rows of the padded frames [t0-W+1, t0+fpb) staged in shared memory. What
// differs is the addressing: here a token's D features are contiguous, so a
// thread reads its query and writes its output as float4 vectors, and a
// warp covers 32*D consecutive floats. No stats are written. expf (not
// __expf) keeps parity with the reference.

#include <cuda_runtime.h>
#include <math.h>

namespace {

template <int D>
__global__ void swa_headmajor_fwd_kernel(const float* __restrict__ q,
                                         const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         float* __restrict__ out, int T, int m,
                                         int W, int fpb) {
  extern __shared__ float smem[];
  const int rows = fpb + W - 1;
  float* ks = smem;              // [rows][D]
  float* vs = smem + rows * D;   // [rows][D]
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * fpb;
  const float* kh = k + (long long)h * T * D;
  const float* vh = v + (long long)h * T * D;

  // row r holds original frame t0 - (W-1) + r; the rows are contiguous in
  // device memory, so consecutive threads load consecutive words
  for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x) {
    const int f = t0 - (W - 1) + idx / D;
    const bool inside = f >= 0 && f < T;
    ks[idx] = inside ? kh[(long long)f * D + idx % D] : 0.f;
    vs[idx] = inside ? vh[(long long)f * D + idx % D] : 0.f;
  }
  __syncthreads();

  const int lt = threadIdx.x / m;   // frame within the block
  const int t = t0 + lt;
  if (lt >= fpb || t >= T) return;
  const long long n = ((long long)h * T + t) * m + threadIdx.x % m;

  const float scale = 1.f / sqrtf((float)D);
  float qr[D];
  const float4* q4 = reinterpret_cast<const float4*>(q + n * D);
#pragma unroll
  for (int d = 0; d < D / 4; ++d) {
    const float4 x = q4[d];
    qr[4 * d] = x.x * scale;
    qr[4 * d + 1] = x.y * scale;
    qr[4 * d + 2] = x.z * scale;
    qr[4 * d + 3] = x.w * scale;
  }

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
  float4* o4 = reinterpret_cast<float4*>(out + n * D);
#pragma unroll
  for (int d = 0; d < D / 4; ++d)
    o4[d] = make_float4(acc[4 * d] * rs, acc[4 * d + 1] * rs,
                        acc[4 * d + 2] * rs, acc[4 * d + 3] * rs);
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   int H, int T, int m, int W, cudaStream_t stream) {
  const int fpb = m >= 256 ? 1 : 256 / m;
  const int threads = (fpb * m + 31) / 32 * 32;
  if (threads > 1024) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)(fpb + W - 1) * D * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        swa_headmajor_fwd_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((T + fpb - 1) / fpb, H);
  swa_headmajor_fwd_kernel<D><<<grid, threads, smem, stream>>>(q, k, v, out, T,
                                                              m, W, fpb);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. One launch.
extern "C" int swa_headmajor_fwd(const float* q, const float* k, const float* v,
                                 float* out, int H, int D, int T, int m, int W,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 4: return launch<4>(q, k, v, out, H, T, m, W, s);
    case 8: return launch<8>(q, k, v, out, H, T, m, W, s);
    case 16: return launch<16>(q, k, v, out, H, T, m, W, s);
    case 32: return launch<32>(q, k, v, out, H, T, m, W, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* swa_headmajor_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
