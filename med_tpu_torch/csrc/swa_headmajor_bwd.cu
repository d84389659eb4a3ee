// Banded sliding-window attention, backward, in the head-major layout, with
// the softmax recomputed from q, k and v.
//
// Replaces med_tpu/ops/attention.py::_swa_bwd_kernel, the Pallas TPU kernel
// behind sliding_window_attention_bwd_pallas.
//
// Layout, as at the Python function and the forward (swa_headmajor_fwd.cu):
//   q, g, dq   (H, T, M, D)  token n = t*M + j of frame t
//   k, v       (H, T, D)     dk, dv (H, T, D)
// Query n attends the keys of frames t-W+1 .. t; frames before 0 are the
// forward's zero keys, which sit in the softmax and get no gradient. The
// kernel is given neither the forward's output nor any statistics of it.
// With q^ = q / sqrt(D), over a query's W keys f:
//   s_f = q^ . k_f,  a_f = exp(s_f - max s) / sum exp(s - max s)
//   da_f = g_n . v_f,  delta = sum_f a_f da_f,  ds_f = a_f (da_f - delta)
//   dq_n = sum_f ds_f k_f / sqrt(D),  dk_f = sum_n ds_f q^_n,  dv_f = sum_n a_f g_n
//
// What bounds it on an H100: operations. Per query it reads q and g and
// writes dq (12*D bytes); a query block spends ~10*W*D flops on it (three
// passes over the window) and the key blocks ~8*W*D on their products plus
// ~8*W*D*(fpb+W-1)/fpb on recomputing the softmax of every query frame they
// stage. At COG's D=8, W=30, fpb=17 that is ~95 flop/byte, above the fp32
// ridge of ~20 (67 TFLOP/s over 3.35 TB/s).
//
// Design: one launch holds two kinds of blocks, as the packed backward
// (swa_packed_bwd.cu), so nothing is summed across blocks and no atomics are
// needed:
// - query blocks (blockIdx.x < nb): one thread per (head, query token); the
//   block stages the K/V rows of its frames and the zero halo in shared
//   memory; a thread walks its W keys three times (max; sum and delta; ds)
//   and keeps dq in registers;
// - key blocks: one thread per (head, key frame f, query slot j). The block
//   stages q^, g of the query frames [f0, f0+fpb+W-1) its keys serve (in
//   chunks of frames when M is large) and the K/V rows those queries attend,
//   [c0-W+1, c1) with the zero halo. Its threads first recompute (max,
//   1/sum, delta) of every staged query into shared memory, a query a thread
//   in turn; then each thread walks the W query frames f .. f+W-1 at slot j
//   and keeps partial dk_f, dv_f; the M slot partials of a key are summed in
//   a fixed order through shared memory.
// expf (not __expf) keeps parity with the reference.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

// rows r of ks/vs hold frames first + r of head h, zero outside [0, T)
template <int D>
__device__ __forceinline__ void stage_kv(const float* __restrict__ kh,
                                         const float* __restrict__ vh,
                                         float* ks, float* vs, int first,
                                         int rows, int T) {
  for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x) {
    const int f = first + idx / D;
    const bool inside = f >= 0 && f < T;
    ks[idx] = inside ? kh[(long long)f * D + idx % D] : 0.f;
    vs[idx] = inside ? vh[(long long)f * D + idx % D] : 0.f;
  }
}

// The banded softmax of one query over the W rows at ks/vs: its max, the
// reciprocal of its sum, and delta = sum_f a_f (g . v_f).
template <int D>
__device__ __forceinline__ void band_stats(const float* qr, const float* gr,
                                           const float* ks, const float* vs,
                                           int W, float* mx_out, float* rs_out,
                                           float* delta_out) {
  float mx = -INFINITY;
  for (int w = 0; w < W; ++w) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[w * D + d], s);
    mx = fmaxf(mx, s);
  }
  float sum = 0.f, pda = 0.f;
  for (int w = 0; w < W; ++w) {
    float s = 0.f, da = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      s = fmaf(qr[d], ks[w * D + d], s);
      da = fmaf(gr[d], vs[w * D + d], da);
    }
    const float p = expf(s - mx);
    sum += p;
    pda = fmaf(p, da, pda);
  }
  const float rs = 1.f / sum;
  *mx_out = mx;
  *rs_out = rs;
  *delta_out = pda * rs;
}

template <int D>
__device__ void query_block(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ g,
                            float* __restrict__ dq, int T, int m, int W,
                            int fpb, int blk, float* smem) {
  const int rows = fpb + W - 1;
  float* ks = smem;              // [rows][D]
  float* vs = smem + rows * D;   // [rows][D]
  const int h = blockIdx.y;
  const int t0 = blk * fpb;
  stage_kv<D>(k + (long long)h * T * D, v + (long long)h * T * D, ks, vs,
              t0 - (W - 1), rows, T);
  __syncthreads();

  const int lt = threadIdx.x / m;
  const int t = t0 + lt;
  if (lt >= fpb || t >= T) return;
  const long long n = ((long long)h * T + t) * m + threadIdx.x % m;
  const float scale = 1.f / sqrtf((float)D);
  float qr[D], gr[D], acc[D];
  const float4* q4 = reinterpret_cast<const float4*>(q + n * D);
  const float4* g4 = reinterpret_cast<const float4*>(g + n * D);
#pragma unroll
  for (int d = 0; d < D / 4; ++d) {
    const float4 x = q4[d];
    const float4 y = g4[d];
    qr[4 * d] = x.x * scale;
    qr[4 * d + 1] = x.y * scale;
    qr[4 * d + 2] = x.z * scale;
    qr[4 * d + 3] = x.w * scale;
    gr[4 * d] = y.x;
    gr[4 * d + 1] = y.y;
    gr[4 * d + 2] = y.z;
    gr[4 * d + 3] = y.w;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float mx, rs, dl;
  band_stats<D>(qr, gr, ks + lt * D, vs + lt * D, W, &mx, &rs, &dl);
  for (int w = 0; w < W; ++w) {
    const float* kr = ks + (lt + w) * D;
    const float* vr = vs + (lt + w) * D;
    float s = 0.f, da = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      s = fmaf(qr[d], kr[d], s);
      da = fmaf(gr[d], vr[d], da);
    }
    const float ds = expf(s - mx) * rs * (da - dl);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, kr[d], acc[d]);
  }
  float4* o4 = reinterpret_cast<float4*>(dq + n * D);
#pragma unroll
  for (int d = 0; d < D / 4; ++d)
    o4[d] = make_float4(acc[4 * d] * scale, acc[4 * d + 1] * scale,
                        acc[4 * d + 2] * scale, acc[4 * d + 3] * scale);
}

template <int D>
__device__ void key_block(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ g, float* __restrict__ dk,
                          float* __restrict__ dv, int T, int m, int W, int fpb,
                          int chunk, int blk, float* smem) {
  const int nq = chunk * m;
  const int kv_rows = chunk + W - 1;
  float* red = smem;                    // [fpb * m][2D] slot partials
  float* qs = red + fpb * m * 2 * D;    // [D][nq] q^ of the staged query frames
  float* gs = qs + D * nq;              // [D][nq] g
  float* mxs = gs + D * nq;             // [nq] max of the banded scores
  float* rss = mxs + nq;                // [nq] 1 / softmax sum
  float* dls = rss + nq;                // [nq] delta
  float* ks = dls + nq;                 // [kv_rows][D] keys the staged queries attend
  float* vs = ks + kv_rows * D;         // [kv_rows][D]
  const int h = blockIdx.y;
  const int f0 = blk * fpb;
  const int lf = threadIdx.x / m;
  const int j = threadIdx.x % m;
  const int f = f0 + lf;
  const bool active = lf < fpb && f < T;
  const float scale = 1.f / sqrtf((float)D);
  const float* qh = q + (long long)h * T * m * D;
  const float* gh = g + (long long)h * T * m * D;
  const float* kh = k + (long long)h * T * D;
  const float* vh = v + (long long)h * T * D;
  float kr[D], vr[D], dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = active ? kh[(long long)f * D + d] : 0.f;
    vr[d] = active ? vh[(long long)f * D + d] : 0.f;
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
    // the chunk's tokens are contiguous in device memory
    for (int idx = threadIdx.x; idx < cnt * D; idx += blockDim.x) {
      const int r = idx / D;
      const int d = idx % D;
      qs[d * nq + r] = qh[n0 * D + idx] * scale;
      gs[d * nq + r] = gh[n0 * D + idx];
    }
    stage_kv<D>(kh, vh, ks, vs, c0 - (W - 1), c1 - c0 + W - 1, T);
    __syncthreads();
    // query r of frame c0 + r / m attends rows r / m .. r / m + W - 1
    for (int r = threadIdx.x; r < cnt; r += blockDim.x) {
      float qr[D], gr[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        qr[d] = qs[d * nq + r];
        gr[d] = gs[d * nq + r];
      }
      band_stats<D>(qr, gr, ks + (r / m) * D, vs + (r / m) * D, W, mxs + r,
                    rss + r, dls + r);
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
      const float a = expf(s - mxs[r]) * rss[r];
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
  // thread i sums output e = i % 2D of key frame f0 + i / 2D over the m
  // slots, so neighbouring threads write neighbouring words
  for (int i = threadIdx.x; i < fpb * 2 * D; i += blockDim.x) {
    const int kf = i / (2 * D);
    const int e = i % (2 * D);
    const int fo = f0 + kf;
    if (fo >= T) continue;
    float sum = 0.f;
    for (int jj = 0; jj < m; ++jj) sum += red[(long long)(kf * m + jj) * 2 * D + e];
    float* dst = e < D ? dk : dv;
    const int d = e < D ? e : e - D;
    dst[((long long)h * T + fo) * D + d] = sum;
  }
}

constexpr int kMaxThreads = 512;   // caps registers at 128 a thread
constexpr size_t kStageBytes = 96 * 1024;

template <int D>
__global__ void __launch_bounds__(kMaxThreads)
swa_headmajor_bwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ g, float* __restrict__ dq,
                         float* __restrict__ dk, float* __restrict__ dv, int T,
                         int m, int W, int fpb, int chunk, int nb) {
  extern __shared__ float smem[];
  if ((int)blockIdx.x < nb)
    query_block<D>(q, k, v, g, dq, T, m, W, fpb, blockIdx.x, smem);
  else
    key_block<D>(q, k, v, g, dk, dv, T, m, W, fpb, chunk, blockIdx.x - nb, smem);
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* g, float* dq, float* dk, float* dv, int H,
                   int T, int m, int W, cudaStream_t stream) {
  const int fpb = m >= 256 ? 1 : 256 / m;
  const int threads = (fpb * m + 31) / 32 * 32;
  if (threads > kMaxThreads) return cudaErrorInvalidValue;
  const size_t smem_q = 2 * (size_t)(fpb + W - 1) * D * sizeof(float);
  // key blocks stage query frames in chunks that take up to ~96 KB: a frame
  // is m tokens of q^, g and three statistics, and one K and one V row
  const size_t frame_bytes = ((size_t)m * (2 * D + 3) + 2 * D) * sizeof(float);
  const int chunk = (int)std::min<size_t>(fpb + W - 1,
                                          std::max<size_t>(1, kStageBytes / frame_bytes));
  const size_t smem_k = ((size_t)fpb * m * 2 * D + 2 * (size_t)(W - 1) * D) * sizeof(float)
                        + chunk * frame_bytes;
  const size_t smem = smem_q > smem_k ? smem_q : smem_k;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        swa_headmajor_bwd_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int nb = (T + fpb - 1) / fpb;
  const dim3 grid(2 * nb, H);
  swa_headmajor_bwd_kernel<D><<<grid, threads, smem, stream>>>(
      q, k, v, g, dq, dk, dv, T, m, W, fpb, chunk, nb);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. One launch.
extern "C" int swa_headmajor_bwd(const float* q, const float* k, const float* v,
                                 const float* g, float* dq, float* dk,
                                 float* dv, int H, int D, int T, int m, int W,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 4: return launch<4>(q, k, v, g, dq, dk, dv, H, T, m, W, s);
    case 8: return launch<8>(q, k, v, g, dq, dk, dv, H, T, m, W, s);
    case 16: return launch<16>(q, k, v, g, dq, dk, dv, H, T, m, W, s);
    case 32: return launch<32>(q, k, v, g, dq, dk, dv, H, T, m, W, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* swa_headmajor_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
