// Banded sliding-window attention with a start mask and per-head sinks,
// backward, in the packed layout: the wide-head instance behind
// ops/attention.py::sliding_window_attention_packed_bwd (MiMo-V2-Flash's
// windowed layers; K3, csrc/swa_packed_bwd.cu, keeps COG's narrow heads).
//
// Given q (H, D, N), k (H, D, T), v (H, DV, T), the output cotangent g and
// the forward's out (H, DV, N) and stats (H, 2, N), and the sinks (H, m) or
// null: dq (H, D, N), dk (H, D, T), dv (H, DV, T) and dsinks (H, m), with
//   P = exp(S - lse)          (lse includes the sink)
//   delta = g . out           (per query)
//   dS = P (g V^T - delta),   dq = dS K / sqrt(D),  dk = dS^T Q / sqrt(D)
//   dv = P^T g,               dsink = -sum over the slot's queries of
//                             exp(sink - lse) delta
// (the sink's value is zero, so it adds nothing to dv).
//
// Design: two launches. The first takes the forward's tiles (TF = 128 / m
// frames of one head, Q = 128 queries, the NB = W + TF keys their windows
// span; 256 threads) and runs five small CUDA-core products in fp32 over a
// shared band of Q x NB floats: S and P (queries on ty); dv's tile partial
// P^T g; g V^T, turned into dS in place; dq = dS K, written where it
// belongs (each query is one tile's); dk's tile partial dS^T Q. The tile
// partials of dk and dv (NB keys each) and of the sinks go to a scratch
// buffer the wrapper allocates. The second launch sums, for each key frame,
// the partials of the (at most ceil(NB / TF)) tiles whose band holds it, in
// tile order, and each sink's over all tiles: no atomics, so every run gives
// the same bits. Operand chunks are staged so that 16 lanes read 16
// consecutive floats of global memory; the outputs a thread writes put the
// query (or key) on the fast lane index.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;

template <int D, int DV, int M, int W>
struct Shape {
  static constexpr int TF = 128 / M;
  static constexpr int Q = TF * M;
  static constexpr int NB = W + TF;
  static constexpr int LD = NB + 1;
  static constexpr int RQ = Q / 16;
  static constexpr int RK = NB / 16;
  static constexpr int RD = D / 16;
  static constexpr int RV = DV / 16;
  static_assert(Q == 128 && NB % 16 == 0 && D % kChunk == 0 && DV % kChunk == 0, "tile");
  static constexpr int SB = kChunk * (D + 1 > NB ? D + 1 : NB);
  static constexpr size_t smem_floats =
      (size_t)Q * LD + (size_t)kChunk * Q + SB + 3 * Q;
};

template <int D, int DV, int M, int W>
__global__ void __launch_bounds__(kThreads)
swa_sink_bwd_tiles(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ g,
                   const float* __restrict__ out, const float* __restrict__ stats,
                   const float* __restrict__ sinks, float* __restrict__ dq,
                   float* __restrict__ part_k, float* __restrict__ part_v,
                   float* __restrict__ part_s, int T, int exclude) {
  using S = Shape<D, DV, M, W>;
  extern __shared__ __align__(16) float smem[];
  float* band = smem;                        // Q x LD: P, then dS
  float* sa = band + S::Q * S::LD;           // kChunk x Q
  float* sb = sa + kChunk * S::Q;            // SB
  float* s_lse = sb + S::SB;                 // Q
  float* s_delta = s_lse + S::Q;             // Q (two halves summed into it)
  float* s_sink = s_delta + S::Q;            // Q

  const int h = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int t0 = tile * S::TF;
  const int n0 = t0 * M;
  const int s0 = t0 - (W - 1);
  const int N = T * M;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* qh = q + (size_t)h * D * N;
  const float* kh = k + (size_t)h * D * T;
  const float* vh = v + (size_t)h * DV * T;
  const float* gh = g + (size_t)h * DV * N;
  const float* oh = out + (size_t)h * DV * N;
  const float scale = 1.0f / sqrtf((float)D);

  // 0. lse and delta = g . out of each query
  {
    const int i = tid % S::Q, half = tid / S::Q, n = n0 + i;
    float d = 0.f;
    if (n < N) {
      for (int c = half * (DV / 2); c < (half + 1) * (DV / 2); ++c)
        d = fmaf(oh[(size_t)c * N + n], gh[(size_t)c * N + n], d);
    }
    if (half == 1) s_sink[i] = d;
    if (half == 0) s_lse[i] = n < N ? stats[(size_t)h * 2 * N + n] : 0.f;
    __syncthreads();
    if (half == 0) s_delta[i] = d + s_sink[i];
  }

  // 1. S, then P = exp(S - lse) into the band (queries on ty)
  {
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
#pragma unroll
    for (int r = 0; r < S::RQ; ++r) {
      const int i = ty + 16 * r, f = i / M, j = i % M, t = t0 + f;
      const bool live = t < T;
      const float lse = s_lse[i];
#pragma unroll
      for (int c = 0; c < S::RK; ++c) {
        const int kk = tx + 16 * c, s = s0 + kk;
        const bool ok = live && kk >= f && kk <= f + W - 1 && (!exclude || s >= 0);
        band[i * S::LD + kk] = ok ? expf(acc[r][c] * scale - lse) : 0.f;
      }
      if (tx == 0)
        s_sink[i] = (sinks != nullptr && live) ? -expf(sinks[h * M + j] - lse) * s_delta[i]
                                               : 0.f;
    }
  }
  __syncthreads();
  if (tid < M) {
    float acc = 0.f;
    for (int f = 0; f < S::TF; ++f) acc += s_sink[f * M + tid];
    part_s[((size_t)h * tiles + tile) * M + tid] = acc;
  }

  // 2. dv's tile partial: P^T g (keys on tx, channels on ty), over queries
  {
    constexpr int LV = DV + 1;
    float acc[S::RK][S::RV];
#pragma unroll
    for (int a = 0; a < S::RK; ++a)
#pragma unroll
      for (int c = 0; c < S::RV; ++c) acc[a][c] = 0.f;
    for (int i0 = 0; i0 < S::Q; i0 += kChunk) {
      __syncthreads();
      for (int e = tid; e < kChunk * DV; e += kThreads) {
        const int ii = e % kChunk, c = e / kChunk, n = n0 + i0 + ii;
        sb[ii * LV + c] = n < N ? gh[(size_t)c * N + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int ii = 0; ii < kChunk; ++ii) {
        float a[S::RK], b[S::RV];
#pragma unroll
        for (int r = 0; r < S::RK; ++r) a[r] = band[(i0 + ii) * S::LD + tx + 16 * r];
#pragma unroll
        for (int c = 0; c < S::RV; ++c) b[c] = sb[ii * LV + ty + 16 * c];
#pragma unroll
        for (int r = 0; r < S::RK; ++r)
#pragma unroll
          for (int c = 0; c < S::RV; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
    }
    float* pv = part_v + ((size_t)h * tiles + tile) * DV * S::NB;
#pragma unroll
    for (int r = 0; r < S::RK; ++r)
#pragma unroll
      for (int c = 0; c < S::RV; ++c) pv[(size_t)(ty + 16 * c) * S::NB + tx + 16 * r] = acc[r][c];
  }

  // 3. dP = g V^T over channels (queries on ty), then dS = P (dP - delta) in place
  {
    float acc[S::RQ][S::RK];
#pragma unroll
    for (int r = 0; r < S::RQ; ++r)
#pragma unroll
      for (int c = 0; c < S::RK; ++c) acc[r][c] = 0.f;
    for (int c0 = 0; c0 < DV; c0 += kChunk) {
      __syncthreads();
      for (int e = tid; e < kChunk * S::Q; e += kThreads) {
        const int cc = e / S::Q, i = e % S::Q, n = n0 + i;
        sa[e] = n < N ? gh[(size_t)(c0 + cc) * N + n] : 0.f;
      }
      for (int e = tid; e < kChunk * S::NB; e += kThreads) {
        const int cc = e / S::NB, kk = e % S::NB, s = s0 + kk;
        sb[e] = (s >= 0 && s < T) ? vh[(size_t)(c0 + cc) * T + s] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int cc = 0; cc < kChunk; ++cc) {
        float a[S::RQ], b[S::RK];
#pragma unroll
        for (int r = 0; r < S::RQ; ++r) a[r] = sa[cc * S::Q + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < S::RK; ++c) b[c] = sb[cc * S::NB + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < S::RQ; ++r)
#pragma unroll
          for (int c = 0; c < S::RK; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < S::RQ; ++r) {
      const int i = ty + 16 * r;
      const float delta = s_delta[i];
#pragma unroll
      for (int c = 0; c < S::RK; ++c) {
        float* p = &band[i * S::LD + tx + 16 * c];
        *p = *p * (acc[r][c] - delta);
      }
    }
  }

  // 4. dq = dS K / sqrt(D) (queries on tx, dims on ty), over the band's keys
  {
    constexpr int LK = D + 1;
    float acc[S::RQ][S::RD];
#pragma unroll
    for (int r = 0; r < S::RQ; ++r)
#pragma unroll
      for (int c = 0; c < S::RD; ++c) acc[r][c] = 0.f;
    for (int k0 = 0; k0 < S::NB; k0 += kChunk) {
      __syncthreads();
      for (int e = tid; e < kChunk * D; e += kThreads) {
        const int kk = e % kChunk, d = e / kChunk, s = s0 + k0 + kk;
        sb[kk * LK + d] = (s >= 0 && s < T) ? kh[(size_t)d * T + s] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        float a[S::RQ], b[S::RD];
#pragma unroll
        for (int r = 0; r < S::RQ; ++r) a[r] = band[(tx + 16 * r) * S::LD + k0 + kk];
#pragma unroll
        for (int c = 0; c < S::RD; ++c) b[c] = sb[kk * LK + ty + 16 * c];
#pragma unroll
        for (int r = 0; r < S::RQ; ++r)
#pragma unroll
          for (int c = 0; c < S::RD; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
    }
    float* dqh = dq + (size_t)h * D * N;
#pragma unroll
    for (int r = 0; r < S::RQ; ++r) {
      const int n = n0 + tx + 16 * r;
      if (n >= N) continue;
#pragma unroll
      for (int c = 0; c < S::RD; ++c) dqh[(size_t)(ty + 16 * c) * N + n] = acc[r][c] * scale;
    }
  }

  // 5. dk's tile partial: dS^T Q / sqrt(D) (keys on tx, dims on ty), over queries
  {
    constexpr int LK = D + 1;
    float acc[S::RK][S::RD];
#pragma unroll
    for (int r = 0; r < S::RK; ++r)
#pragma unroll
      for (int c = 0; c < S::RD; ++c) acc[r][c] = 0.f;
    for (int i0 = 0; i0 < S::Q; i0 += kChunk) {
      __syncthreads();
      for (int e = tid; e < kChunk * D; e += kThreads) {
        const int ii = e % kChunk, d = e / kChunk, n = n0 + i0 + ii;
        sb[ii * LK + d] = n < N ? qh[(size_t)d * N + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int ii = 0; ii < kChunk; ++ii) {
        float a[S::RK], b[S::RD];
#pragma unroll
        for (int r = 0; r < S::RK; ++r) a[r] = band[(i0 + ii) * S::LD + tx + 16 * r];
#pragma unroll
        for (int c = 0; c < S::RD; ++c) b[c] = sb[ii * LK + ty + 16 * c];
#pragma unroll
        for (int r = 0; r < S::RK; ++r)
#pragma unroll
          for (int c = 0; c < S::RD; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
    }
    float* pk = part_k + ((size_t)h * tiles + tile) * D * S::NB;
#pragma unroll
    for (int r = 0; r < S::RK; ++r)
#pragma unroll
      for (int c = 0; c < S::RD; ++c)
        pk[(size_t)(ty + 16 * c) * S::NB + tx + 16 * r] = acc[r][c] * scale;
  }
}

// Block (x, row, h): key frames s = x*256 + tid of row `row` (dk's D rows,
// then dv's DV); the last row of blocks sums the sinks' partials.
template <int D, int DV, int M, int W>
__global__ void __launch_bounds__(kThreads)
swa_sink_bwd_sum(const float* __restrict__ part_k, const float* __restrict__ part_v,
                 const float* __restrict__ part_s, float* __restrict__ dk,
                 float* __restrict__ dv, float* __restrict__ dsinks, int T, int tiles) {
  using S = Shape<D, DV, M, W>;
  const int row = blockIdx.y, h = blockIdx.z, tid = threadIdx.x;
  if (row == D + DV) {
    if (blockIdx.x == 0 && tid < M && dsinks != nullptr) {
      float acc = 0.f;
      for (int i = 0; i < tiles; ++i) acc += part_s[((size_t)h * tiles + i) * M + tid];
      dsinks[h * M + tid] = acc;
    }
    return;
  }
  const int s = blockIdx.x * kThreads + tid;
  if (s >= T) return;
  const bool is_k = row < D;
  const int r = is_k ? row : row - D;
  const int rows = is_k ? D : DV;
  const float* part = is_k ? part_k : part_v;
  // tile i's band holds key frames i*TF - (W-1) .. i*TF - (W-1) + NB - 1
  int lo = s + (W - 1) - (S::NB - 1);
  lo = lo <= 0 ? 0 : (lo + S::TF - 1) / S::TF;
  int hi = (s + W - 1) / S::TF;
  if (hi > tiles - 1) hi = tiles - 1;
  float acc = 0.f;
  for (int i = lo; i <= hi; ++i) {
    const int kk = s - (i * S::TF - (W - 1));
    acc += part[(((size_t)h * tiles + i) * rows + r) * S::NB + kk];
  }
  (is_k ? dk : dv)[((size_t)h * rows + r) * T + s] = acc;
}

template <int D, int DV, int M, int W>
cudaError_t launch(const float* q, const float* k, const float* v, const float* g,
                   const float* out, const float* stats, const float* sinks, float* dq,
                   float* dk, float* dv, float* dsinks, float* scratch, int H, int T,
                   int exclude, cudaStream_t stream) {
  using S = Shape<D, DV, M, W>;
  const int tiles = (T + S::TF - 1) / S::TF;
  float* part_k = scratch;
  float* part_v = part_k + (size_t)H * tiles * D * S::NB;
  float* part_s = part_v + (size_t)H * tiles * DV * S::NB;
  const size_t smem = S::smem_floats * sizeof(float);
  auto kernel = swa_sink_bwd_tiles<D, DV, M, W>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles, H), kThreads, smem, stream>>>(q, k, v, g, out, stats, sinks, dq,
                                                     part_k, part_v, part_s, T, exclude);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kThreads - 1) / kThreads, D + DV + 1, H);
  swa_sink_bwd_sum<D, DV, M, W><<<grid, kThreads, 0, stream>>>(part_k, part_v, part_s, dk,
                                                               dv, dsinks, T, tiles);
  return cudaGetLastError();
}

bool supported(int D, int DV, int m, int W) {
  return D == 192 && DV == 128 && m == 8 && W == 128;
}

}  // namespace

// The scratch the launch for these shapes needs, in floats, into *floats.
// Returns a cudaError_t code: cudaErrorInvalidValue for a shape without an
// instance.
extern "C" int swa_sink_bwd_scratch(int H, int D, int DV, int T, int m, int W,
                                    long long* floats) {
  if (!supported(D, DV, m, W) || H < 1 || T < 1) return cudaErrorInvalidValue;
  using S = Shape<192, 128, 8, 128>;
  const long long tiles = (T + S::TF - 1) / S::TF;
  *floats = (long long)H * tiles * ((D + DV) * (long long)S::NB + m);
  return cudaSuccess;
}

// Returns a cudaError_t code: 0 when the launches were accepted. Two
// launches; scratch holds at least swa_sink_bwd_scratch's floats; sinks and
// dsinks are both null or both given.
extern "C" int swa_sink_bwd(const float* q, const float* k, const float* v, const float* g,
                            const float* out, const float* stats, const float* sinks,
                            float* dq, float* dk, float* dv, float* dsinks, float* scratch,
                            int H, int D, int DV, int T, int m, int W, int exclude,
                            void* stream) {
  if (H < 1 || T < 1 || (long long)T * m >= (1LL << 31)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (supported(D, DV, m, W))
    return launch<192, 128, 8, 128>(q, k, v, g, out, stats, sinks, dq, dk, dv, dsinks,
                                    scratch, H, T, exclude, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* swa_sink_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
