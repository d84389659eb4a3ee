// Banded sliding-window attention with a start mask and per-head sinks,
// forward, in the packed layout: the wide-head instance behind
// ops/attention.py::sliding_window_attention_packed (MiMo-V2-Flash's
// windowed layers; K1, csrc/swa_packed_fwd.cu, keeps COG's narrow heads).
//
// Layout, as at the Python function:
//   q     (H, D, N)   N = T*m query tokens; token n = t*m + j of frame t
//   k     (H, D, T)   v (H, DV, T): one key and value row per frame
//   sinks (H, m)      one logit a query slot, or null
//   out   (H, DV, N)
//   stats (H, 2, N)   row 0 the logsumexp of each query's scores and its
//                     sink, row 1 the reciprocal of its softmax sum
// Query n of frame t attends the keys of frames t-W+1 .. t. With `exclude`
// the frames before 0 are left out of the softmax; without, they are zero
// keys that score 0 (COG's zero padding). A sink adds exp(sink) to the
// denominator and nothing to the output.
//
// What bounds it on an H100: operations. At D = 192, DV = 128, W = 128 a
// (query, key) pair costs 2*(D + DV) = 640 flop against 4*(D + DV) bytes a
// query and a frame's key row shared by m*W pairs: far above the card's
// fp32 ridge. The work is two small matrix products a tile, so the kernel
// is a CUDA-core GEMM: float32 FMAs, no TF32.
//
// Design: a block takes TF = 128 / m frames of one head (Q = 128 queries)
// and the NB = W + TF keys their windows span (frames t0-W+1 .. t0+TF; the
// last is always masked, it pads NB to a multiple of 16). 256 threads.
// 1. S = Q K^T over D in chunks of 16 staged in shared memory; a thread
//    holds 8 query rows x 9 keys (rows ty + 16r, keys tx + 16c), so a row's
//    144 scores lie in 16 lanes of one warp: max and sum by shuffles.
// 2. P = exp(S - max) / (sum + exp(sink - max)) into a shared band
//    (Q x NB), the statistics out.
// 3. O = P V over the band in chunks of 16 keys; a thread holds 8 queries x
//    8 channels with the query on the fast lane index (rows tx + 16r), so
//    16 lanes write 16 consecutive floats of out.
// ~92 KB of shared memory: two blocks an SM. expf and logf, not the fast
// intrinsics, keep the parity with the plain version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;

template <int D, int DV, int M, int W>
struct Shape {
  static constexpr int TF = 128 / M;        // frames a tile
  static constexpr int Q = TF * M;          // queries a tile: 128
  static constexpr int NB = W + TF;         // keys a tile's windows span (+1 pad)
  static constexpr int LD = NB + 1;         // the band's row stride
  static constexpr int RQ = Q / 16;         // query rows a thread
  static constexpr int RK = NB / 16;        // keys a thread
  static constexpr int RV = DV / 16;        // value channels a thread
  static_assert(Q == 128 && NB % 16 == 0 && D % kChunk == 0 && DV % kChunk == 0, "tile");
  static constexpr size_t smem_floats =
      (size_t)Q * LD + (size_t)kChunk * Q + (size_t)kChunk * (DV + 1 > NB ? DV + 1 : NB);
};

template <int D, int DV, int M, int W>
__global__ void __launch_bounds__(kThreads)
swa_sink_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ sinks,
                    float* __restrict__ out, float* __restrict__ stats, int T, int exclude) {
  using S = Shape<D, DV, M, W>;
  extern __shared__ __align__(16) float smem[];
  float* band = smem;                        // Q x LD: P
  float* sa = band + S::Q * S::LD;           // kChunk x Q: a q chunk
  float* sb = sa + kChunk * S::Q;            // kChunk x NB: a k chunk; kChunk x (DV+1): v

  const int h = blockIdx.y;
  const int t0 = blockIdx.x * S::TF;
  const int n0 = t0 * M;
  const int s0 = t0 - (W - 1);
  const int N = T * M;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* qh = q + (size_t)h * D * N;
  const float* kh = k + (size_t)h * D * T;
  const float* vh = v + (size_t)h * DV * T;

  // 1. scores
  float acc[S::RQ][S::RK];
#pragma unroll
  for (int r = 0; r < S::RQ; ++r)
#pragma unroll
    for (int c = 0; c < S::RK; ++c) acc[r][c] = 0.f;
  for (int d0 = 0; d0 < D; d0 += kChunk) {
    __syncthreads();
    for (int e = tid; e < kChunk * S::Q; e += kThreads) {
      const int dd = e / S::Q, i = e % S::Q, n = n0 + i;
      sa[e] = n < N ? qh[(size_t)(d0 + dd) * N + n] : 0.f;
    }
    for (int e = tid; e < kChunk * S::NB; e += kThreads) {
      const int dd = e / S::NB, kk = e % S::NB, s = s0 + kk;
      sb[e] = (s >= 0 && s < T) ? kh[(size_t)(d0 + dd) * T + s] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int dd = 0; dd < kChunk; ++dd) {
      float a[S::RQ], b[S::RK];
#pragma unroll
      for (int r = 0; r < S::RQ; ++r) a[r] = sa[dd * S::Q + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < S::RK; ++c) b[c] = sb[dd * S::NB + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < S::RQ; ++r)
#pragma unroll
        for (int c = 0; c < S::RK; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }

  // 2. the softmax with the sink, into the band
  const float scale = 1.0f / sqrtf((float)D);
#pragma unroll
  for (int r = 0; r < S::RQ; ++r) {
    const int i = ty + 16 * r, f = i / M, j = i % M, t = t0 + f;
    const bool live = t < T;
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < S::RK; ++c) {
      const int kk = tx + 16 * c, s = s0 + kk;
      const bool ok = live && kk >= f && kk <= f + W - 1 && (!exclude || s >= 0);
      acc[r][c] = ok ? acc[r][c] * scale : -INFINITY;
      mx = fmaxf(mx, acc[r][c]);
    }
#pragma unroll
    for (int o = 8; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o, 16));
    const float sink = (sinks != nullptr && live) ? sinks[h * M + j] : -INFINITY;
    mx = fmaxf(mx, sink);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < S::RK; ++c) {
      const float p = acc[r][c] == -INFINITY ? 0.f : expf(acc[r][c] - mx);
      acc[r][c] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 8; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o, 16);
    if (sinks != nullptr && live) sum += expf(sink - mx);
    const float rs = live ? 1.0f / sum : 0.f;
#pragma unroll
    for (int c = 0; c < S::RK; ++c) band[i * S::LD + tx + 16 * c] = acc[r][c] * rs;
    if (tx == 0 && live) {
      stats[(size_t)h * 2 * N + n0 + i] = mx + logf(sum);
      stats[(size_t)h * 2 * N + N + n0 + i] = rs;
    }
  }

  // 3. out = P V
  float o[S::RQ][S::RV];
#pragma unroll
  for (int r = 0; r < S::RQ; ++r)
#pragma unroll
    for (int c = 0; c < S::RV; ++c) o[r][c] = 0.f;
  constexpr int LV = DV + 1;
  for (int k0 = 0; k0 < S::NB; k0 += kChunk) {
    __syncthreads();
    for (int e = tid; e < kChunk * DV; e += kThreads) {
      const int kk = e % kChunk, c = e / kChunk, s = s0 + k0 + kk;
      sb[kk * LV + c] = (s >= 0 && s < T) ? vh[(size_t)c * T + s] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      float a[S::RQ], b[S::RV];
#pragma unroll
      for (int r = 0; r < S::RQ; ++r) a[r] = band[(tx + 16 * r) * S::LD + k0 + kk];
#pragma unroll
      for (int c = 0; c < S::RV; ++c) b[c] = sb[kk * LV + ty + 16 * c];
#pragma unroll
      for (int r = 0; r < S::RQ; ++r)
#pragma unroll
        for (int c = 0; c < S::RV; ++c) o[r][c] = fmaf(a[r], b[c], o[r][c]);
    }
  }
  float* oh = out + (size_t)h * DV * N;
#pragma unroll
  for (int r = 0; r < S::RQ; ++r) {
    const int n = n0 + tx + 16 * r;
    if (n >= N) continue;
#pragma unroll
    for (int c = 0; c < S::RV; ++c) oh[(size_t)(ty + 16 * c) * N + n] = o[r][c];
  }
}

template <int D, int DV, int M, int W>
cudaError_t launch(const float* q, const float* k, const float* v, const float* sinks,
                   float* out, float* stats, int H, int T, int exclude, cudaStream_t stream) {
  using S = Shape<D, DV, M, W>;
  const size_t smem = S::smem_floats * sizeof(float);
  auto kernel = swa_sink_fwd_kernel<D, DV, M, W>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + S::TF - 1) / S::TF, H);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, sinks, out, stats, T, exclude);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. One launch.
// The one instance: D = 192, DV = 128, m = 8, W = 128 (MiMo-V2-Flash's
// windowed layers); other shapes return cudaErrorInvalidValue.
extern "C" int swa_sink_fwd(const float* q, const float* k, const float* v,
                            const float* sinks, float* out, float* stats, int H, int D,
                            int DV, int T, int m, int W, int exclude, void* stream) {
  if (H < 1 || T < 1 || (long long)T * m >= (1LL << 31)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 192 && DV == 128 && m == 8 && W == 128)
    return launch<192, 128, 8, 128>(q, k, v, sinks, out, stats, H, T, exclude, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* swa_sink_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
