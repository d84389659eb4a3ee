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
// The TPU kernel's one launch per stage does not carry over: stage 0's
// activation is 1.6 MB an image against 227 KB of shared memory, and blocks
// of a grid run in no order. So each of the three products of a block is
// one launch, and y1 and y2 go through device memory. Each launch computes
// C (M, N) = A (M, K) @ B (K, N) with a mode that says how A is read: the
// activation itself (reduce), the 9 shifted views of y1 with the image edges
// masked (conv3), or y2 and then x (expand; the projection's K-steps follow
// y2's and share its accumulators).
//
// What bounds it on an H100, bf16, full width, B = 128, stages 0 + 1: 338.7
// GFLOP is 0.34 ms on the tensor cores; the three launches a block read
// their inputs and write their outputs once, 3.39 GB, 1.01 ms at 3.35 TB/s.
// So bytes, the larger: the reduce and expand launches sit far below the
// ridge (~48 and ~43 flop/byte at stage 0, ridge ~295), the 3x3 at it (~288).
//
// bf16: tensor cores (stage_mma_kernel), against the three causes that held
// the CUDA-core design at 22 TFLOP/s, 3x slower than cuDNN:
// - Products: mma.sync m16n8k16 bf16 -> fp32, fragments from ldmatrix
//   (.trans for the row-major B), sums in registers. A block of 8 warps
//   (4 along M x 2 along N) owns a 256 x 64 tile of C where N is 64 and a
//   128 x 128 tile where N is a multiple of 128: each warp 64 x 32 or 32 x 64
//   sums either way, 128 registers a thread, 2 blocks an SM.
// - Staging: 16-byte cp.async.cg copies of bf16 as it lies, into a 4-stage
//   ring in dynamic shared memory, no widening, no transposes, no register
//   round trip. A k-step is 32 deep and lies in one source (one tap of the
//   3x3, y2 or x of the expand), each source zero-padded to the step on its
//   own. Each staged row's valid taps are a 9-bit mask made once, so a copy
//   costs a shift, a test and an address; one past M or outside the image
//   zero-fills (src-size 0) from a clamped address. Rows are padded (A 80
//   bytes, B BN + 8 elements) so that ldmatrix reads are conflict-free.
// - y1 and y2 still go through device memory (the floor above). The
//   epilogue adds the biases to the sums in registers, stages them in
//   shared memory as fp32, issues all of a thread's residual reads (16
//   bytes each) before the barrier, then adds, applies relu, rounds and
//   stores 16 bytes at a time.
// This instance needs every channel count a multiple of 8 and every bf16
// pointer 16-byte aligned; where one is not, the guarded instance stages the
// same tiles with checked 2-byte loads and runs the same mma body
// (resnet_stage_gemm reports which one a call takes). The grid is
// one-dimensional, N tiles fastest, so that the tiles that share A rows run
// together and no 65,535 limit applies to rows. Measured on an H100 it sits
// at ~225 TFLOP/s in the 3x3 and 2.0-2.3 TB/s in the others, short of both
// sides: wgmma with TMA, and a persistent grid that overlaps one tile's
// epilogue with the next tile's loads, are the next steps (PERF.md).
//
// float: the CUDA-core kernel (stage_gemm_kernel). A block of 256 threads
// owns a 128 x 64 tile of C; per k-step of 16 it stages A (transposed, as
// fp32) and B in shared memory, double buffered, with the next step's loads
// held in registers during the current step's products. Each thread keeps
// an 8 x 4 tile of sums in registers. Products are fp32 FMAs: no tensor
// cores, so the float instance never sees TF32. Its grid covers 128 rows a
// block in y (at most 65,535 x 128 rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kBM = 128;       // rows of C per block
constexpr int kBN = 64;        // columns of C per block
constexpr int kBK = 16;        // k per step
constexpr int kThreads = 256;
constexpr int kPad = 4;        // keeps the transposed A stores off one bank
constexpr int kRowsPerThread = kBM / (kThreads / kBK);   // A rows a thread loads

enum Mode { kReduce = 0, kConv3 = 1, kExpand = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBK = 32;           // k per step (bf16)
constexpr int kStages = 4;        // depth of the cp.async ring
constexpr int kThreads = 256;     // 8 warps: 4 along M x 2 along N
constexpr int kAPitch = kBK + 8;  // 80-byte A rows: ldmatrix's 8 rows hit 8 bank groups

// A block's tile of C: BN columns and 16384 / BN rows (256 x 64 or 128 x
// 128), so that each warp holds 64 x 32 or 32 x 64 sums either way.
template <int BN>
struct Tile {
  static constexpr int kBM = 16384 / BN;
  static constexpr int kBPitch = BN + 8;        // bf16; rows 16 bytes apart mod 128
  static constexpr int kCPitch = BN + 8;        // fp32 epilogue staging
  static constexpr int kAStage = kBM * kAPitch; // bf16 elements a ring slot
  static constexpr int kBStage = kBK * kBPitch;
  static constexpr int kRing = kStages * (kAStage + kBStage) * 2;
  static constexpr int kEpilogue = kBM * kCPitch * 4;
  static constexpr int kSmem = kRing > kEpilogue ? kRing : kEpilogue;
};

struct Args {
  const bf16* a0;      // reduce: x (M, K0); conv3: y1 (M, K0 = f); expand: y2 (M, K0 = f)
  const bf16* a1;      // expand with projection: x (M, K1); else null (K1 = 0)
  const bf16* b0;      // (K0, N), or (9, K0, N) for conv3
  const bf16* b1;      // (K1, N)
  const float* bias0;  // (N)
  const float* bias1;  // (N) or null
  const bf16* res;     // identity residual (M, N) or null
  bf16* out;           // (M, N)
  int M, N, K0, K1, H, W;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 zero-fills the 16
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) @ b (16 x 8, col), bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 bf16 from src[0..7], each where ok(e), else 0, as one 16-byte value
template <typename Ok>
__device__ __forceinline__ uint4 load8_guarded(const bf16* src, Ok ok) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  unsigned v[4];
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    const unsigned lo = ok(e) ? s[e] : 0u;
    const unsigned hi = ok(e + 1) ? s[e + 1] : 0u;
    v[e / 2] = lo | (hi << 16);
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// MODE: kReduce, kConv3, kExpand. ALIGNED: the 16-byte cp.async instance
// (channel counts multiples of 8, pointers 16-byte aligned); else the
// guarded one (2-byte loads, any shape).
template <int MODE, int BN, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, 2) stage_mma_kernel(const Args p) {
  using T = Tile<BN>;
  constexpr int kBM = T::kBM;
  constexpr int kWM = kBM / 4;      // rows of C per warp
  constexpr int kWN = BN / 2;       // columns of C per warp
  constexpr int kMT = kWM / 16;     // m16 tiles a warp
  constexpr int kARows = kBM / 64;  // A rows a thread stages
  constexpr int kNT = kWN / 8;      // n8 tiles a warp
  constexpr int kBChunks = kBK * BN / 8 / kThreads;   // B 16-byte chunks a thread
  static_assert(kNT % 2 == 0 && kBChunks >= 1, "tile shape");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kStages * T::kAStage;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n_tiles = (p.N + BN - 1) / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m0 = (blockIdx.x / n_tiles) * kBM;

  // k-steps: each source (a tap of the 3x3, y2 or x of the expand) padded
  // to kBK on its own
  const int per0 = (p.K0 + kBK - 1) / kBK;
  const int steps = MODE == kConv3 ? 9 * per0 : per0 + (p.K1 + kBK - 1) / kBK;

  // A staging: rows a_row + 64 i, channels a_col .. a_col + 7 of a step.
  // Each row's taps that fall inside the image, bit 3 (dy + 1) + dx + 1
  // (conv3; else bit 0), none past M: a step then costs each copy a shift,
  // a test and an address.
  const int a_row = tid >> 2, a_col = (tid & 3) * 8;
  unsigned a_taps[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const int m = m0 + a_row + 64 * i;
    a_taps[i] = m < p.M ? 1u : 0u;
    if (MODE == kConv3 && m < p.M) {
      const int q = m % (p.H * p.W), h = q / p.W, w = q % p.W;
      a_taps[i] = 0;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int hh = h + tap / 3 - 1, ww = w + tap % 3 - 1;
        if (hh >= 0 && hh < p.H && ww >= 0 && ww < p.W) a_taps[i] |= 1u << tap;
      }
    }
  }

  auto load = [&](int step, int slot) {
    int c0 = step * kBK, tap = 0, shift = 0;
    const bf16* A = p.a0;
    const bf16* Bm = p.b0;
    int lda = p.K0;
    if (MODE == kConv3) {
      tap = step / per0;
      c0 = (step - tap * per0) * kBK;
      shift = (tap / 3 - 1) * p.W + tap % 3 - 1;
      Bm = p.b0 + (long long)tap * p.K0 * p.N;
    } else if (MODE == kExpand && step >= per0) {
      c0 = (step - per0) * kBK;
      A = p.a1;
      Bm = p.b1;
      lda = p.K1;
    }
    bf16* as = As + slot * T::kAStage;
    bf16* bs = Bs + slot * T::kBStage;
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int r = a_row + 64 * i;
      const int c = c0 + a_col;
      bool ok = (a_taps[i] >> tap) & 1u;
      bf16* dst = as + r * kAPitch + a_col;
      const bf16* src = A + (long long)(m0 + r + shift) * lda + c;
      if (ALIGNED) {
        ok = ok && c < lda;
        cp_async16(dst, ok ? src : A, ok ? 16 : 0);
      } else {
        *reinterpret_cast<uint4*>(dst) =
            load8_guarded(src, [&](int e) { return ok && c + e < lda; });
      }
    }
#pragma unroll
    for (int j = 0; j < kBChunks; ++j) {
      const int idx = tid + j * kThreads;
      const int kr = idx / (BN / 8), nc = (idx % (BN / 8)) * 8;
      const int k = c0 + kr, n = n0 + nc;
      bf16* dst = bs + kr * T::kBPitch + nc;
      const bf16* src = Bm + (long long)k * p.N + n;
      if (ALIGNED) {
        const bool ok = k < lda && n < p.N;
        cp_async16(dst, ok ? src : Bm, ok ? 16 : 0);
      } else {
        *reinterpret_cast<uint4*>(dst) =
            load8_guarded(src, [&](int e) { return k < lda && n + e < p.N; });
      }
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    // step's tiles have landed, and every warp is done with the slot that
    // the next load overwrites (read in step - 1)
    __syncthreads();
    const int next = step + kStages - 1;
    if (next < steps) load(next, next % kStages);
    cp_async_commit();

    const bf16* as = As + (step % kStages) * T::kAStage;
    const bf16* bs = Bs + (step % kStages) * T::kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned a[kMT][4], b[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldmatrix_x4(a[i], as + (wm * kWM + i * 16 + (lane & 15)) * kAPitch + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        unsigned r[4];
        ldmatrix_x4_trans(r, bs + (kk + (lane & 15)) * T::kBPitch + wn * kWN + j * 8 +
                                 (lane >> 4) * 8);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the epilogue stages C in it

  // sums + biases, fp32, into shared memory
  float* Cs = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = wn * kWN + j * 8 + 2 * t;
    float bias[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + col + e;
      bias[e] = 0.f;
      if (n < p.N) {
        bias[e] = p.bias0[n];
        if (p.bias1 != nullptr) bias[e] += p.bias1[n];
      }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int row = wm * kWM + i * 16 + g;
      *reinterpret_cast<float2*>(&Cs[row * T::kCPitch + col]) =
          make_float2(acc[i][j][0] + bias[0], acc[i][j][1] + bias[1]);
      *reinterpret_cast<float2*>(&Cs[(row + 8) * T::kCPitch + col]) =
          make_float2(acc[i][j][2] + bias[0], acc[i][j][3] + bias[1]);
    }
  }

  // + residual, relu, round; 8 columns a thread at a time, the residual's
  // reads all issued before the barrier
  constexpr int kChunks = BN / 8;
  constexpr int kIters = kBM * kChunks / kThreads;
  uint4 rq[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int idx = tid + it * kThreads;
    const int m = m0 + idx / kChunks, n = n0 + (idx % kChunks) * 8;
    const long long at = (long long)m * p.N + n;
    rq[it] = make_uint4(0, 0, 0, 0);
    if (p.res != nullptr && m < p.M && n < p.N)
      rq[it] = ALIGNED ? *reinterpret_cast<const uint4*>(p.res + at)
                       : load8_guarded(p.res + at, [&](int e) { return n + e < p.N; });
  }
  __syncthreads();

#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int idx = tid + it * kThreads;
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m >= p.M || n >= p.N) continue;
    const float4 lo = *reinterpret_cast<const float4*>(&Cs[r * T::kCPitch + c]);
    const float4 hi = *reinterpret_cast<const float4*>(&Cs[r * T::kCPitch + c + 4]);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const long long at = (long long)m * p.N + n;
    if (p.res != nullptr) {
      const bf16* rv = reinterpret_cast<const bf16*>(&rq[it]);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += __bfloat162float(rv[e]);
    }
    uint4 oq;
    bf16* ov = reinterpret_cast<bf16*>(&oq);
#pragma unroll
    for (int e = 0; e < 8; ++e) ov[e] = __float2bfloat16(fmaxf(v[e], 0.f));
    if (ALIGNED) {
      *reinterpret_cast<uint4*>(p.out + at) = oq;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (n + e < p.N) p.out[at + e] = ov[e];
    }
  }
}

template <int MODE, int BN, bool ALIGNED>
cudaError_t launch_mma(const Args& p, cudaStream_t stream) {
  auto kernel = stage_mma_kernel<MODE, BN, ALIGNED>;
  constexpr int smem = Tile<BN>::kSmem;
  // dynamic shared memory above 48 KB; set at every launch, since the
  // attribute belongs to the device that is current
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  constexpr int bm = Tile<BN>::kBM;
  const long long tiles = (long long)((p.M + bm - 1) / bm) * ((p.N + BN - 1) / BN);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch_mma(bool aligned, const Args& p, cudaStream_t stream) {
  if (!aligned) return launch_mma<MODE, 64, false>(p, stream);
  if (p.N % 128 == 0) return launch_mma<MODE, 128, true>(p, stream);
  return launch_mma<MODE, 64, true>(p, stream);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace tc

// Which instance a call takes: 0 the float CUDA-core kernel, 1 the bf16
// 16-byte cp.async instance, 2 the bf16 guarded instance.
int instance_of(int bf16, const void* a0, const void* a1, const void* b0,
                const void* b1, const void* res, const void* out, int N, int K0,
                int K1) {
  if (!bf16) return 0;
  const bool aligned = N % 8 == 0 && K0 % 8 == 0 && K1 % 8 == 0 &&
                       tc::aligned16(a0) && tc::aligned16(a1) &&
                       tc::aligned16(b0) && tc::aligned16(b1) &&
                       tc::aligned16(res) && tc::aligned16(out);
  return aligned ? 1 : 2;
}

}  // namespace

// One product of a bottleneck block; returns a cudaError_t code, 0 when the
// launch was accepted. mode: 0 reduce, 1 3x3, 2 expand. bf16: 0 for float
// tensors (the CUDA-core kernel), 1 for bfloat16 (the tensor cores). a1, b1,
// bias1 (the projection) and res (the identity residual) may be null; K1 is
// 0 without a projection. *instance is set to the instance the call takes:
// 0 the float kernel, 1 the bf16 16-byte cp.async one, 2 the bf16 guarded one.
extern "C" int resnet_stage_gemm(int mode, int bf16, const void* a0,
                                 const void* a1, const void* b0,
                                 const void* b1, const float* bias0,
                                 const float* bias1, const void* res,
                                 void* out, int M, int N, int K0, int K1,
                                 int H, int W, int* instance, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K0 <= 0 || K1 < 0 || H <= 0 || W <= 0 ||
      W > 0xffff || H > 0x7fff)
    return cudaErrorInvalidValue;
  *instance = instance_of(bf16, a0, a1, b0, b1, res, out, N, K0, K1);
  if (!bf16)
    return dispatch<float>(mode, a0, a1, b0, b1, bias0, bias1, res, out, M, N,
                           K0, K1, H, W, s);
  using B16 = __nv_bfloat16;
  const tc::Args p{static_cast<const B16*>(a0), static_cast<const B16*>(a1),
                   static_cast<const B16*>(b0), static_cast<const B16*>(b1),
                   bias0, bias1, static_cast<const B16*>(res),
                   static_cast<B16*>(out), M, N, K0, K1, H, W};
  const bool aligned = *instance == 1;
  switch (mode) {
    case kReduce:
      return tc::dispatch_mma<kReduce>(aligned, p, s);
    case kConv3:
      return tc::dispatch_mma<kConv3>(aligned, p, s);
    case kExpand:
      return tc::dispatch_mma<kExpand>(aligned, p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* resnet_stage_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
