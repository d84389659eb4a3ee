// int8 x int8 -> int32 implicit-GEMM convolution with a fused fp32 epilogue:
// the products of the int8 post-training-quantized serving path (the
// ResNet-50 trunk's 53 convs and the FeatureExtractor's three dense layers).
//
// Not a TPU kernel: it replaces XLA's int8 convs and dots in
// med_tpu/ops/quant.py (_conv_i8 :77 and _dense_i8 :218, each with
// preferred_element_type=int32), which have no pallas_call. PyTorch has no
// int8 convolution on CUDA, and im2col + torch._int_mm would write every
// patch matrix to device memory (230 MB for one 3x3 of stage 1 at B = 128)
// and take separate launches for the epilogue.
//
// What it computes, on NHWC int8 activations x (B, H, W, Cin) and weights
// w (N, kh*kw*Cin) laid out (o, dy, dx, c), K = kh*kw*Cin:
//
//   acc[m, o] = sum_k patch(x)[m, k] * w[o, k]        int32, exact
//   y = acc * (s_in * wscale[o]) + bias[o]             fp32
//   y = y + res   (optional: fp32, or int8 * res_scale)
//   y = relu(y)   (optional)
//   out = y (fp32), or clip(rint(y * inv_out), -127, 127) (int8),
//         or acc itself (int32; the check of the products)
//
// rows m = (b, ho, wo), ho = (h + 2 pad - kh) / stride + 1; a dense layer is
// the 1x1 case over (M, 1, 1, K). The epilogue is med_tpu's arithmetic,
// with the product s_in * wscale formed first as _dequant_epilogue forms
// it, and every multiply and add written __fmul_rn/__fadd_rn, so that nvcc
// does not contract them into an FMA that XLA does not form.
//
// What bounds it on an H100: int8 tensor cores at 1,979 TOP/s dense, HBM at
// 3.35 TB/s. A trunk at B = 128, 224x224, width 64 is ~1.05 TOP (0.53 ms)
// against ~2 GB of int8 activations read and written (~0.6 ms): near the
// ridge, so both. The FE's first layer at M = 5120 is 10.7 GOP against a
// 10.5 MB int8 input: operations.
//
// Design (a simple, right kernel first; wgmma and TMA are later work):
// - mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32. A block of 8 warps
//   (4 along M x 2 along N) owns a 128 x 64 tile of the output; each warp
//   32 x 32 (2 x 4 mma tiles, 32 int32 accumulators a thread).
// - k-steps of 64 bytes staged in a 3-stage ring in shared memory, rows
//   padded to 80 bytes so that the 32-bit fragment reads hit 32 banks.
// - The 16-byte instance: Cin a multiple of 16 and x, w, res and out
//   16-byte aligned. A 16-byte chunk of a patch row then lies in one tap,
//   contiguous in NHWC memory: one cp.async.cg, zero-filled (src-size 0)
//   outside the image, past M or past K.
// - The guarded instance (conv1's Cin = 3 with K = 147; a view off a
//   16-byte boundary): each thread gathers its 32 bytes of a patch row
//   byte by byte, walking (dy, dx, c) without a division per byte, and stores
//   them as words; the same ring and mma body.
// - Epilogue from the accumulator registers: pairs of columns, 2-byte int8,
//   8-byte fp32 or int32 stores (scalar in the guarded instance).
// int8_conv reports the instance it took through an int* out-parameter.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kBM = 128;        // output rows a block
constexpr int kBN = 64;         // output channels a block
constexpr int kBK = 64;         // bytes of K a stage
constexpr int kPitch = 80;      // a staged row's bytes: kBK + 16 of padding
constexpr int kStages = 3;
constexpr int kThreads = 256;

enum Out { kOutI32 = 0, kOutF32 = 1, kOutI8 = 2 };
enum Res { kResNone = 0, kResF32 = 1, kResI8 = 2 };

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* wscale;
  const float* bias;
  const void* res;
  void* out;
  int res_kind, out_kind, relu;
  float s_in, res_scale, inv_out;
  int B, H, W, Cin, Ho, Wo, N, kh, kw, stride, pad;
  int M, K;
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

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One output row's place in the input: its image's first byte, and the
// top-left input pixel of its window (hi0, wi0); valid false past M.
struct Row {
  long long base;
  int hi0, wi0;
  bool valid;
};

__device__ __forceinline__ Row row_of(const Args& p, int m) {
  Row r{0, 0, 0, m < p.M};
  if (r.valid) {
    const int hw = p.Ho * p.Wo;
    const int b = m / hw, rem = m - b * hw;
    const int ho = rem / p.Wo, wo = rem - ho * p.Wo;
    r.base = (long long)b * p.H * p.W * p.Cin;
    r.hi0 = ho * p.stride - p.pad;
    r.wi0 = wo * p.stride - p.pad;
  }
  return r;
}

// The byte offset in x of channel c of tap (dy, dx) of row r's patch, or -1
// where the patch reads padding (outside the image) or r is past M.
__device__ __forceinline__ long long patch_at(const Args& p, const Row& r, int dy, int dx,
                                              int c) {
  const int hi = r.hi0 + dy, wi = r.wi0 + dx;
  if (!r.valid || hi < 0 || hi >= p.H || wi < 0 || wi >= p.W) return -1;
  return r.base + ((long long)hi * p.W + wi) * p.Cin + c;
}

template <bool ALIGNED>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(const Args p) {
  __shared__ __align__(16) int8_t As[kStages][kBM * kPitch];
  __shared__ __align__(16) int8_t Bs[kStages][kBN * kPitch];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int n_tiles = (p.N + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / n_tiles) * kBM, n0 = (blockIdx.x % n_tiles) * kBN;
  const int k_tiles = (p.K + kBK - 1) / kBK;

  // staging assignment. 16-byte instance: A rows tid/4 and tid/4 + 64,
  // chunk tid%4 of each; B row tid/4, chunk tid%4. Guarded: A row tid/2,
  // bytes (tid%2)*32..+32; B row tid/4, bytes (tid%4)*16..+16.
  Row arow[2];
  if (ALIGNED) {
    arow[0] = row_of(p, m0 + tid / 4);
    arow[1] = row_of(p, m0 + tid / 4 + 64);
  } else {
    arow[0] = row_of(p, m0 + tid / 2);
  }
  const int bn = n0 + tid / 4;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    if (ALIGNED) {
      const int kk = k0 + (tid & 3) * 16;
      const int tap = kk / p.Cin, c = kk - tap * p.Cin;
      const int dy = tap / p.kw, dx = tap - dy * p.kw;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long at = kk < p.K ? patch_at(p, arow[i], dy, dx, c) : -1;
        int8_t* dst = &As[stage][(tid / 4 + 64 * i) * kPitch + (tid & 3) * 16];
        cp_async16(dst, at >= 0 ? p.x + at : p.x, at >= 0 ? 16 : 0);
      }
      const bool ok = bn < p.N && kk < p.K;
      cp_async16(&Bs[stage][(tid / 4) * kPitch + (tid & 3) * 16],
                 ok ? p.w + (long long)bn * p.K + kk : p.w, ok ? 16 : 0);
    } else {
      // A: 32 bytes of row tid/2, walking (dy, dx, c) from the first
      int kk = k0 + (tid & 1) * 32;
      const int tap = kk / p.Cin;
      int c = kk - tap * p.Cin, dy = tap / p.kw, dx = tap - dy * p.kw;
      unsigned* dst = reinterpret_cast<unsigned*>(
          &As[stage][(tid / 2) * kPitch + (tid & 1) * 32]);
#pragma unroll
      for (int wd = 0; wd < 8; ++wd) {
        unsigned word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kk < p.K) {
            const long long at = patch_at(p, arow[0], dy, dx, c);
            if (at >= 0) word |= (unsigned)(uint8_t)p.x[at] << (8 * e);
          }
          ++kk;
          if (++c == p.Cin) {
            c = 0;
            if (++dx == p.kw) {
              dx = 0;
              ++dy;
            }
          }
        }
        dst[wd] = word;
      }
      // B: 16 bytes of weight row tid/4
      const int kb = k0 + (tid & 3) * 16;
      unsigned* bdst = reinterpret_cast<unsigned*>(
          &Bs[stage][(tid / 4) * kPitch + (tid & 3) * 16]);
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
        unsigned word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = kb + wd * 4 + e;
          if (bn < p.N && k < p.K)
            word |= (unsigned)(uint8_t)p.w[(long long)bn * p.K + k] << (8 * e);
        }
        bdst[wd] = word;
      }
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // the stage read in step kt - 1 is free: every thread passed the barrier
    const int next = kt + kStages - 1;
    if (next < k_tiles) load(next % kStages, next);
    cp_async_commit();

    const int8_t* A = As[kt % kStages];
    const int8_t* Bt = Bs[kt % kStages];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp_m * 32 + i * 16 + g;
        a[i][0] = *reinterpret_cast<const unsigned*>(&A[r * kPitch + ks + t * 4]);
        a[i][1] = *reinterpret_cast<const unsigned*>(&A[(r + 8) * kPitch + ks + t * 4]);
        a[i][2] = *reinterpret_cast<const unsigned*>(&A[r * kPitch + ks + 16 + t * 4]);
        a[i][3] =
            *reinterpret_cast<const unsigned*>(&A[(r + 8) * kPitch + ks + 16 + t * 4]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = warp_n * 32 + j * 8 + g;
        b[j][0] = *reinterpret_cast<const unsigned*>(&Bt[n * kPitch + ks + t * 4]);
        b[j][1] = *reinterpret_cast<const unsigned*>(&Bt[n * kPitch + ks + 16 + t * 4]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: thread (g, t) holds rows g and g + 8 of each 16 x 8 tile,
  // columns 2t and 2t + 1
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + warp_n * 32 + j * 8 + 2 * t;
    if (n >= p.N) continue;
    const bool pair = n + 1 < p.N;
    float mult[2], bias[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = e == 0 || pair;
      mult[e] = in ? __fmul_rn(p.s_in, p.wscale[n + e]) : 0.f;
      bias[e] = in ? p.bias[n + e] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + warp_m * 32 + i * 16 + g + 8 * h;
        if (m >= p.M) continue;
        const long long at = (long long)m * p.N + n;
        const int a0 = acc[i][j][2 * h], a1 = acc[i][j][2 * h + 1];
        if (p.out_kind == kOutI32) {
          int* o = static_cast<int*>(p.out) + at;
          if (ALIGNED && pair) {
            *reinterpret_cast<int2*>(o) = make_int2(a0, a1);
          } else {
            o[0] = a0;
            if (pair) o[1] = a1;
          }
          continue;
        }
        float y[2];
        const int av[2] = {a0, a1};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // (float)acc rounds to nearest as XLA's convert does
          y[e] = __fadd_rn(__fmul_rn(__int2float_rn(av[e]), mult[e]), bias[e]);
        }
        if (p.res_kind == kResF32) {
          const float* r = static_cast<const float*>(p.res) + at;
          y[0] = __fadd_rn(y[0], r[0]);
          if (pair) y[1] = __fadd_rn(y[1], r[1]);
        } else if (p.res_kind == kResI8) {
          const int8_t* r = static_cast<const int8_t*>(p.res) + at;
          y[0] = __fadd_rn(y[0], __fmul_rn((float)r[0], p.res_scale));
          if (pair) y[1] = __fadd_rn(y[1], __fmul_rn((float)r[1], p.res_scale));
        }
        if (p.relu) {
          y[0] = fmaxf(y[0], 0.f);
          y[1] = fmaxf(y[1], 0.f);
        }
        if (p.out_kind == kOutF32) {
          float* o = static_cast<float*>(p.out) + at;
          if (ALIGNED && pair) {
            *reinterpret_cast<float2*>(o) = make_float2(y[0], y[1]);
          } else {
            o[0] = y[0];
            if (pair) o[1] = y[1];
          }
        } else {
          int8_t q[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // round half to even, as jnp.round; then clip to +-127
            const float r = rintf(__fmul_rn(y[e], p.inv_out));
            q[e] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
          }
          int8_t* o = static_cast<int8_t*>(p.out) + at;
          if (ALIGNED && pair) {
            char2 v;
            v.x = q[0];
            v.y = q[1];
            *reinterpret_cast<char2*>(o) = v;
          } else {
            o[0] = q[0];
            if (pair) o[1] = q[1];
          }
        }
      }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// One int8 convolution (or dense layer: H = W = kh = kw = 1); returns a
// cudaError_t code, 0 when the launch was accepted. res_kind: 0 none, 1 fp32
// (B, Ho, Wo, N), 2 int8 (B, Ho, Wo, N) times res_scale. out_kind: 0 the
// int32 accumulators, 1 fp32, 2 int8 requantized by inv_out. *instance is
// set to 0 for the 16-byte cp.async instance, 1 for the guarded one.
extern "C" int int8_conv(const void* x, const void* w, const float* wscale,
                         const float* bias, float s_in, const void* res,
                         int res_kind, float res_scale, void* out, int out_kind,
                         float inv_out, int relu, int B, int H, int W, int Cin,
                         int N, int kh, int kw, int stride, int pad,
                         int* instance, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || N <= 0 || kh <= 0 ||
      kw <= 0 || stride <= 0 || pad < 0 || res_kind < 0 || res_kind > 2 ||
      out_kind < 0 || out_kind > 2)
    return cudaErrorInvalidValue;
  const int Ho = (H + 2 * pad - kh) / stride + 1;
  const int Wo = (W + 2 * pad - kw) / stride + 1;
  if (Ho <= 0 || Wo <= 0) return cudaErrorInvalidValue;
  const long long M = (long long)B * Ho * Wo;
  const long long K = (long long)kh * kw * Cin;
  if (M > INT_MAX || K > INT_MAX) return cudaErrorInvalidValue;
  const Args p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
               wscale, bias, res, out, res_kind, out_kind, relu, s_in,
               res_scale, inv_out, B, H, W, Cin, Ho, Wo, N, kh, kw, stride, pad,
               static_cast<int>(M), static_cast<int>(K)};
  const bool aligned = Cin % 16 == 0 && N % 2 == 0 && aligned16(x) &&
                       aligned16(w) && aligned16(out) &&
                       (res == nullptr || aligned16(res));
  *instance = aligned ? 0 : 1;
  const long long tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned)
    int8_conv_kernel<true><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(p);
  else
    int8_conv_kernel<false><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

extern "C" const char* int8_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
