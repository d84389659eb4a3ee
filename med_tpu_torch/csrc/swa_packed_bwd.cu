// Banded sliding-window attention, backward, in the packed layout.
//
// Replaces med_tpu/ops/attention.py::_swa_packed_bwd_kernel, the Pallas TPU
// kernel behind sliding_window_attention_packed_bwd.
//
// Layout, as at the Python function and the forward (swa_packed_fwd.cu):
//   q, g, dq   (H, D, N)  N = T*m query tokens, token n = t*m + j of frame t
//   k, v       (H, D, T)  dk, dv (H, D, T)
//   stats      (H, 2, N)  row 0 the forward's logsumexp (row 1 unused here)
//   delta      (H, N)     out_n . g_n, computed by the caller
// Query n attends the keys of frames t-W+1 .. t; frames before 0 are the
// forward's zero keys, which get no gradient. With q^ = q / sqrt(D):
//   a   = exp(q^ . k_f - lse_n)        (the softmax, from the saved stats)
//   ds  = a * (g_n . v_f - delta_n)
//   dq_n = sum_f ds k_f / sqrt(D),  dk_f = sum_n ds q^_n,  dv_f = sum_n a g_n
//
// What bounds it on an H100: memory. Per query it reads q, g (2D floats),
// lse and delta, and writes dq (D floats), about 4*(3D+2) bytes, against
// ~2 * 8*W*D flops (the products are made once for dq and once for dk/dv);
// at COG's D=8, W=30 that is ~37 flop/byte, near the fp32 ridge of ~20.
//
// Design: queries gather their W keys, but each key scatters to the m*W
// queries of frames f .. f+W-1 (450 at COG's m=15, W=30). One launch holds
// two kinds of blocks, so nothing is summed across blocks and no atomics
// are needed:
// - query blocks (blockIdx.x < nb): one thread per (head, query token), as
//   in the forward; the block stages the K/V rows of its frames and the
//   zero halo in shared memory, and each thread walks its W keys once,
//   accumulating dq in registers;
// - key blocks: one thread per (head, key frame f, query slot j); it walks
//   the W query frames f .. f+W-1 at slot j, recomputing a and ds from lse
//   and delta, and keeps partial dk_f, dv_f; the m slot partials of a key
//   are then summed in a fixed order through shared memory. The block's
//   keys share their query frames, so q, g, lse and delta of those frames
//   are staged in shared memory once (in chunks of frames when m is large)
//   and each token is read from device memory once per block, not W times.
// expf (not __expf) keeps parity with the reference.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

template <int D>
__device__ void query_block(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ g,
                            const float* __restrict__ stats,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int T, int m, int W,
                            int fpb, int blk, float* smem) {
  const int rows = fpb + W - 1;
  float* ks = smem;              // [rows][D]
  float* vs = smem + rows * D;   // [rows][D]
  const int h = blockIdx.y;
  const int t0 = blk * fpb;
  const long long N = (long long)T * m;
  const float* kh = k + (long long)h * D * T;
  const float* vh = v + (long long)h * D * T;
  for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x) {
    const int r = idx % rows;
    const int d = idx / rows;
    const int f = t0 - (W - 1) + r;
    const bool inside = f >= 0 && f < T;
    ks[r * D + d] = inside ? kh[(long long)d * T + f] : 0.f;
    vs[r * D + d] = inside ? vh[(long long)d * T + f] : 0.f;
  }
  __syncthreads();

  const int lt = threadIdx.x / m;
  const int t = t0 + lt;
  if (lt >= fpb || t >= T) return;
  const long long n = (long long)t * m + threadIdx.x % m;
  const float scale = 1.f / sqrtf((float)D);
  const float* qh = q + (long long)h * D * N;
  const float* gh = g + (long long)h * D * N;
  float qr[D], gr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = qh[(long long)d * N + n] * scale;
    gr[d] = gh[(long long)d * N + n];
    acc[d] = 0.f;
  }
  const float lse = stats[(long long)h * 2 * N + n];
  const float dl = delta[(long long)h * N + n];
  for (int w = 0; w < W; ++w) {
    const float* kr = ks + (lt + w) * D;
    const float* vr = vs + (lt + w) * D;
    float s = 0.f, da = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      s = fmaf(qr[d], kr[d], s);
      da = fmaf(gr[d], vr[d], da);
    }
    const float ds = expf(s - lse) * (da - dl);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, kr[d], acc[d]);
  }
  float* dqh = dq + (long long)h * D * N;
#pragma unroll
  for (int d = 0; d < D; ++d) dqh[(long long)d * N + n] = acc[d] * scale;
}

template <int D>
__device__ void key_block(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ g,
                          const float* __restrict__ stats,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int T, int m, int W, int fpb, int chunk, int blk,
                          float* smem) {
  const int nq = chunk * m;
  float* red = smem;                    // [fpb * m][2D] slot partials
  float* qs = red + fpb * m * 2 * D;    // [D][nq] q^ of the staged query frames
  float* gs = qs + D * nq;              // [D][nq] g
  float* ls = gs + D * nq;              // [nq] lse
  float* dls = ls + nq;                 // [nq] delta
  const int h = blockIdx.y;
  const int f0 = blk * fpb;
  const long long N = (long long)T * m;
  const int lf = threadIdx.x / m;
  const int j = threadIdx.x % m;
  const int f = f0 + lf;
  const bool active = lf < fpb && f < T;
  const float scale = 1.f / sqrtf((float)D);
  const float* qh = q + (long long)h * D * N;
  const float* gh = g + (long long)h * D * N;
  const float* sh = stats + (long long)h * 2 * N;
  const float* dh = delta + (long long)h * N;
  float kr[D], vr[D], dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = active ? k[((long long)h * D + d) * T + f] : 0.f;
    vr[d] = active ? v[((long long)h * D + d) * T + f] : 0.f;
    dka[d] = dva[d] = 0.f;
  }
  // the block's keys serve query frames [f0, f0 + fpb + W - 1); they pass
  // through shared memory `chunk` frames at a time
  const int q_end = min(f0 + fpb + W - 1, T);
  for (int c0 = f0; c0 < q_end; c0 += chunk) {
    const int c1 = min(c0 + chunk, q_end);
    const int cnt = (c1 - c0) * m;
    const long long n0 = (long long)c0 * m;
    __syncthreads();
    for (int idx = threadIdx.x; idx < cnt * D; idx += blockDim.x) {
      const int d = idx / cnt;
      const int r = idx % cnt;
      qs[d * nq + r] = qh[(long long)d * N + n0 + r] * scale;
      gs[d * nq + r] = gh[(long long)d * N + n0 + r];
    }
    for (int r = threadIdx.x; r < cnt; r += blockDim.x) {
      ls[r] = sh[n0 + r];
      dls[r] = dh[n0 + r];
    }
    __syncthreads();
    if (!active) continue;
    const int t1 = min(min(f + W, T), c1);
    for (int t = max(f, c0); t < t1; ++t) {
      const int r = (t - c0) * m + j;
      float qr[D], gr[D];
      float s = 0.f, da = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        qr[d] = qs[d * nq + r];
        gr[d] = gs[d * nq + r];
        s = fmaf(qr[d], kr[d], s);
        da = fmaf(gr[d], vr[d], da);
      }
      const float a = expf(s - ls[r]);
      const float ds = a * (da - dls[r]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dka[d] = fmaf(ds, qr[d], dka[d]);
        dva[d] = fmaf(a, gr[d], dva[d]);
      }
    }
  }
  if (lf < fpb) {
    float* mine = red + (long long)threadIdx.x * 2 * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      mine[d] = dka[d];
      mine[D + d] = dva[d];
    }
  }
  __syncthreads();
  // thread i sums output e = i / fpb of key frame f0 + i % fpb over the m
  // slots, so neighbouring threads write neighbouring frames
  for (int i = threadIdx.x; i < fpb * 2 * D; i += blockDim.x) {
    const int e = i / fpb;
    const int kf = i % fpb;
    const int fo = f0 + kf;
    if (fo >= T) continue;
    float sum = 0.f;
    for (int jj = 0; jj < m; ++jj) sum += red[(long long)(kf * m + jj) * 2 * D + e];
    float* dst = e < D ? dk : dv;
    const int d = e < D ? e : e - D;
    dst[((long long)h * D + d) * T + fo] = sum;
  }
}

constexpr int kMaxThreads = 512;   // caps registers at 128 a thread
constexpr size_t kStageBytes = 96 * 1024;

template <int D>
__global__ void __launch_bounds__(kMaxThreads)
swa_packed_bwd_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ g,
                      const float* __restrict__ stats,
                      const float* __restrict__ delta,
                      float* __restrict__ dq,
                      float* __restrict__ dk,
                      float* __restrict__ dv, int T, int m,
                      int W, int fpb, int chunk, int nb) {
  extern __shared__ float smem[];
  if ((int)blockIdx.x < nb)
    query_block<D>(q, k, v, g, stats, delta, dq, T, m, W, fpb, blockIdx.x, smem);
  else
    key_block<D>(q, k, v, g, stats, delta, dk, dv, T, m, W, fpb, chunk,
                 blockIdx.x - nb, smem);
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* g, const float* stats, const float* delta,
                   float* dq, float* dk, float* dv, int H, int T, int m, int W,
                   cudaStream_t stream) {
  const int fpb = m >= 256 ? 1 : 256 / m;
  const int threads = (fpb * m + 31) / 32 * 32;
  if (threads > kMaxThreads) return cudaErrorInvalidValue;
  const size_t smem_q = 2 * (size_t)(fpb + W - 1) * D * sizeof(float);
  // key blocks stage query frames in chunks that take up to ~96 KB
  const size_t frame_bytes = (size_t)m * (2 * D + 2) * sizeof(float);
  const int chunk = (int)std::min<size_t>(fpb + W - 1,
                                          std::max<size_t>(1, kStageBytes / frame_bytes));
  const size_t smem_k = (size_t)fpb * m * 2 * D * sizeof(float) + chunk * frame_bytes;
  const size_t smem = smem_q > smem_k ? smem_q : smem_k;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        swa_packed_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int nb = (T + fpb - 1) / fpb;
  const dim3 grid(2 * nb, H);
  swa_packed_bwd_kernel<D><<<grid, threads, smem, stream>>>(
      q, k, v, g, stats, delta, dq, dk, dv, T, m, W, fpb, chunk, nb);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. One launch.
extern "C" int swa_packed_bwd(const float* q, const float* k, const float* v,
                              const float* g, const float* stats,
                              const float* delta, float* dq, float* dk,
                              float* dv, int H, int D, int T, int m, int W,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 4: return launch<4>(q, k, v, g, stats, delta, dq, dk, dv, H, T, m, W, s);
    case 8: return launch<8>(q, k, v, g, stats, delta, dq, dk, dv, H, T, m, W, s);
    case 16: return launch<16>(q, k, v, g, stats, delta, dq, dk, dv, H, T, m, W, s);
    case 32: return launch<32>(q, k, v, g, stats, delta, dq, dk, dv, H, T, m, W, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* swa_packed_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
