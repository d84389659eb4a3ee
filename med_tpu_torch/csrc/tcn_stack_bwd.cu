// Dilated residual TCN stacks run back to back, backward: every layer of
// every stack and the weight gradients in one persistent launch.
//
// Replaces three Pallas TPU kernels of med_tpu/ops/tcn_fused.py, each of
// which walks the layers in reverse, one layer per grid step, carrying the
// whole (T, C) gradient dh in VMEM: _multi_bwd_kernel_s (the merged
// multi-stage backward behind _multi_bwd_call_s), _bwd_kernel (the single
// stack's, behind _bwd_call) and _multi_bwd_kernel (the stacks with their
// operands concatenated on the layer axis, behind _multi_bwd_call).
//
// Per layer l, in reverse, from the forward's saved input h and post-relu y
// (tcn_stack_fwd.cu writes both when training):
//   dz  = dh * scale*mask                   (dh when there is no mask; scale =
//                                            1 / (1 - dropout rate))
//   dW1 = y^T dz,  db1 = sum_t dz
//   da  = (dz W1^T) * [y > 0],  db3 = sum_t da
//   dW3_j = sum_t h[t - s_j]^T da[t]
//   dh[u] <- dh[u] + sum_j da[u + s_j] W3_j^T
// Taps s = (2d, d, 0) causal or (d, 0, -d) acausal, d = 2^(index in the
// stack); rows outside [0, T) are zero. The cotangent g[s] of stage s's
// output joins dh at the stage's last layer; dx is dh after layer 0.
// Layouts as in the forward: h, y, dh (T, C) row-major; w3 (3, C, C) and
// w1 (C, C) [in][out].
//
// What bounds it on an H100: operations, 16*T*C*C flops a layer against
// ~7*T*C*4 bytes (h, y, dz, da, mask); 0.1655 ms for COG's 41 layers at
// T=4096, C=64. The design adds one grid barrier a layer
// (tcn_stack_bwd_barriers times them alone). Measured, both phases issue
// FMAs at well under the card's rate: the chain's steps cost what the
// forward's layers do, and the weight-gradient items, at one block of 8
// warps an SM, run at about half the FMA rate (PERF.md).
//
// Design:
// - One cooperative launch (cudaLaunchCooperativeKernel) for up to 16
//   stacks, the last group of 16 first when there are more. The grid and
//   the tile height (16 or 32 rows at C=64) are chosen as the forward's:
//   at most the blocks the card runs at once, never more than row tiles;
//   block b owns tiles b, b + gridDim.x, ... in every phase.
// - The chain, steps k = Lt .. 0, one grid barrier after each but the last:
//   step k is B(k) then A(k - 1) on each of the block's tiles.
//   A(l) is row-local: dh (+ g at a stage's last layer), dz, and
//   da = (dz W1^T) * [y > 0]; dz and da go to layer l's slot of two
//   (Lt, T, C) buffers. B(l) adds sum_j da_l[u + s_j] W3_j^T to the
//   block's own dh rows; the da rows at u + s_j were written by other
//   blocks before the barrier, so they come in through cp.async.cg, which
//   bypasses L1 (a line there could be stale). dh is row-owned: a thread
//   reads back the dh values it wrote itself. A tap whose rows all lie
//   outside [0, T) is neither loaded nor multiplied.
// - Both products of a step read the weights as stored, W[out][in] seen
//   from the backward, so no transposed copy is made: a thread keeps RM
//   rows x 4 output channels in registers and per 4 input channels reads
//   RM + 4 float4 from shared memory for 16 RM FMAs. The weights' 16-byte
//   column groups are XOR-swizzled by row, so the 8 threads of a quarter
//   warp, which read 8 different rows, hit 8 different bank groups.
// - Step k - 1's W3 and W1 (64 KB at C=64) are copied with cp.async into
//   the second of two shared buffers while step k runs.
// - Weight gradients leave the chain: after the last step every dz_l and
//   da_l is in device memory, so the items (layer, 256-row chunk) are
//   independent. An item makes all four products of its rows in one pass,
//   y^T dz and h[t - s_j]^T da for the three taps, with the sums of dz and
//   da, so dz and da are read once, not once a product. Blocks take items round
//   robin; each item's partial goes to its own slot, and after one more
//   barrier the partials are summed in chunk order. One chunk (T <= 256)
//   writes the gradients directly and skips that barrier. No atomics: the
//   gradients are the same from run to run and whatever the grid.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kStagesPerLaunch = 16;   // see run()
constexpr int kMaxLayers = 30;   // a stack's widest tap, 2 * 2^29 rows, is an int
constexpr int kMaxDevices = 64;
constexpr int kChunk = 256;      // rows of T a weight-gradient item sums
constexpr int kItemRows = 16;    // rows an item stages in shared memory at a time
constexpr int kItemStages = 4;   // an item's ring of row buffers

// Per-stage operands: layer i of stage s has w3[s] + i*3*C*C, w1[s] +
// i*C*C, mask[s] + i*T*C.
struct Stages {
  const float* w3[kStagesPerLaunch];
  const float* w1[kStagesPerLaunch];
  const unsigned char* mask[kStagesPerLaunch];   // null: no mask
  float scale;   // a kept element's factor, 1 / (1 - dropout rate)
  int layers[kStagesPerLaunch];
  int S;
};

struct Buffers {
  const float* g;         // (S, T, C) stage-output cotangents
  const float* h_saved;   // (Lt, T, C)
  const float* y_saved;   // (Lt, T, C)
  float* dh;              // (T, C): the gradient at the input on return
  float* dz;              // (Lt, T, C) scratch
  float* da;              // (Lt, T, C) scratch
  float* partial;         // (Lt, P, 4C^2 + 2C) scratch when P > 1
  float* dw3;             // (Lt, 3, C, C)
  float* db3;             // (Lt, C)
  float* dw1;             // (Lt, C, C)
  float* db1;             // (Lt, C)
  unsigned long long* marks;   // null, or 4 times (ns) block 0 passes: see mark()
  int T;
  int causal;
  int fresh;              // dh starts at 0 (else: as an earlier launch left it)
  int P;                  // weight-gradient chunks, ceil(T / kChunk)
};

// One step's weights in shared memory: W3 of the B layer | W1 of the A layer.
template <int C>
struct Weights {
  static constexpr int kW1 = 3 * C * C;
  static constexpr int kSize = 4 * C * C;
};

// Thread (row group, channel group) holds rows RM*group .. +RM-1 of a tile
// and output channels 4*channel group .. +3.
template <int C, int RM>
struct Tile {
  static constexpr int kColGroups = C / 4;
  static constexpr int kRowGroups = kThreads / kColGroups;
  static constexpr int kRows = kRowGroups * RM;
  // two weight buffers; da at the three taps' rows, dh, y, dz
  static constexpr size_t kSmem =
      (size_t)(2 * Weights<C>::kSize + 6 * kRows * C) * sizeof(float);
};

// Row r of a weight matrix keeps its 16-byte column group q at q ^ swizzle(r).
template <int C>
__device__ __forceinline__ int swizzle(int row) {
  constexpr int kMask = (C / 4 < 8 ? C / 4 : 8) - 1;
  return (row >> 2) & kMask;
}

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

// Block 0 records the device clock at the launch's start (0), the chain's
// end (1), the weight-gradient items' end everywhere (2: after the last
// barrier; with one chunk, its own items' end) and its own end (3).
__device__ __forceinline__ void mark(unsigned long long* marks, int i) {
  if (marks != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    marks[i] = t;
  }
}

// Stage s and index i within it of layer l (numbered over the launch's
// stages in forward order).
__device__ __forceinline__ void locate(const Stages& st, int l, int& s, int& i) {
  s = 0;
  while (l >= st.layers[s]) l -= st.layers[s++];
  i = l;
}

// n consecutive C x C matrices, swizzled, into dst.
template <int C>
__device__ __forceinline__ void stage_matrices(float* dst, const float* src, int n) {
  for (int k = threadIdx.x; k < n * C * C / 4; k += kThreads) {
    const int row = k / (C / 4);
    cp_async16(dst + row * C + 4 * ((k % (C / 4)) ^ swizzle<C>(row)), src + 4 * k, 16);
  }
}

// Step k's weights: W3 of layer k (B) unless k = Lt, W1 of layer k - 1 (A)
// unless k = 0.
template <int C>
__device__ __forceinline__ void stage_step(float* dst, const Stages& st, int k, int Lt) {
  int s, i;
  if (k < Lt) {
    locate(st, k, s, i);
    stage_matrices<C>(dst, st.w3[s] + (long long)i * 3 * C * C, 3);
  }
  if (k > 0) {
    locate(st, k - 1, s, i);
    stage_matrices<C>(dst + Weights<C>::kW1, st.w1[s] + (long long)i * C * C, 1);
  }
}

// Whether a tap shifted by `shift` reads any row of [0, T) for the tile's
// rows t0 .. t_last; a tap that reads none adds nothing.
__device__ __forceinline__ bool tap_live(int t0, int t_last, int shift, int T) {
  return t0 - shift < T && t_last - shift >= 0;
}

// acc[r][q] += sum_i rows[r][i] * m[c0 + q][i] for the thread's output
// channels c0 .. c0+3: rows RM rows of C values in shared memory, m a
// swizzled C x C matrix.
template <int C, int RM>
__device__ __forceinline__ void product(float (&acc)[RM][4], const float* rows,
                                        const float* m, int c0) {
  const int sw = swizzle<C>(c0);
  const float* mr = m + c0 * C;
#pragma unroll 4
  for (int g = 0; g < C / 4; ++g) {
    float4 a[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) a[r] = *reinterpret_cast<const float4*>(rows + r * C + 4 * g);
    const int col = 4 * (g ^ sw);
    float4 w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = *reinterpret_cast<const float4*>(mr + q * C + col);
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[r][q] = fmaf(a[r].x, w[q].x, acc[r][q]);
        acc[r][q] = fmaf(a[r].y, w[q].y, acc[r][q]);
        acc[r][q] = fmaf(a[r].z, w[q].z, acc[r][q]);
        acc[r][q] = fmaf(a[r].w, w[q].w, acc[r][q]);
      }
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  store4(p, v[0], v[1], v[2], v[3]);
}

// One weight-gradient item, layer l's rows [r0, r1): the four products
// dW3_j = sum_t h[t - s_j]^T da[t] (j = 0, 1, 2) and dW1 = sum_t y^T dz,
// with the sums of da (db3) and dz (db1), from one pass over the rows.
// Shared memory feeds 128 bytes a clock against 128 FMAs, so a thread keeps
// an 8x8 tile of one product in registers: per row it reads 8 values of
// its A operand (y or h_j, a broadcast) and 8 of its B (dz or da) for 64
// FMAs. (C/8)^2 threads make each product (64 at C=64, all 256 for the
// four); a thread's rows and columns are 4p.. and C/2 + 4p.., so the 8
// threads of a quarter warp read 8 consecutive float4. Rows come in
// kItemRows at a time through cp.async.cg (dz and da were written in this
// launch), a ring of kItemStages buffers keeping kItemStages - 1 loads in
// flight: one block an SM has nothing else to hide their latency with. A
// tap whose rows all lie outside [0, T) is neither loaded nor multiplied.
template <int C>
__device__ void weight_item(const float* y, const float* h, const float* dz, const float* da,
                            const int (&shift)[3], int T, int r0, int r1, float* dw3,
                            float* db3, float* dw1, float* db1, float* smem) {
  constexpr int kSide = C / 8;            // a product's threads along each side
  constexpr int kBuf = kItemRows * C;     // one operand's rows
  constexpr int kSet = 6 * kBuf;          // y, h_0, h_1, h_2, dz, da of a step
  const int m = threadIdx.x / (kSide * kSide);   // 0-2: dW3_m, 3: dW1; 4+: idle
  const int p = threadIdx.x % (kSide * kSide) / kSide;
  const int q = threadIdx.x % kSide;
  const int steps = (r1 - r0 + kItemRows - 1) / kItemRows;
  bool live[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) live[j] = r0 - shift[j] < T && r1 - 1 - shift[j] >= 0;
  const bool works = m < 4 && (m == 3 || live[m]);
  // the threads of p = 0 also sum their 8 columns of dz (dW1) or da (dW3_0)
  const bool sums = p == 0 && (m == 0 || m == 3);

  // step s's rows into ring slot s % kItemStages; one commit group a step
  const auto load = [&](int s) {
    if (s < steps) {
      float* set = smem + (s % kItemStages) * kSet;
      for (int k = threadIdx.x; k < kBuf / 4; k += kThreads) {
        const int t = r0 + s * kItemRows + k / (C / 4);
        const long long at = (long long)t * C + 4 * (k % (C / 4));
        const bool row = t < r1;
        cp_async16(set + 4 * k, row ? y + at : y, row ? 16 : 0);
        cp_async16(set + 4 * kBuf + 4 * k, row ? dz + at : dz, row ? 16 : 0);
        cp_async16(set + 5 * kBuf + 4 * k, row ? da + at : da, row ? 16 : 0);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          if (!live[j]) continue;
          const int src = t - shift[j];
          const bool in = row && src >= 0 && src < T;
          cp_async16(set + (1 + j) * kBuf + 4 * k, in ? h + at - (long long)shift[j] * C : h,
                     in ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float cs[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int a_off = (m < 3 ? 1 + m : 0) * kBuf + 4 * p;   // A: h_m or y
  const int b_off = (m < 3 ? 5 : 4) * kBuf + 4 * q;       // B: da or dz
  __syncthreads();      // shared memory is free
  for (int s = 0; s < kItemStages - 1; ++s) load(s);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kItemStages - 2>();   // step s's group has landed
    __syncthreads();                    // ... for every thread; step s - 1 is done
    load(s + kItemStages - 1);          // into the slot step s - 1 used
    const float* set = smem + (s % kItemStages) * kSet;
    if (works || sums) {
#pragma unroll 4
      for (int r = 0; r < kItemRows; ++r) {
        const float4 a0 = *reinterpret_cast<const float4*>(set + a_off + r * C);
        const float4 a1 = *reinterpret_cast<const float4*>(set + a_off + r * C + C / 2);
        const float4 b0 = *reinterpret_cast<const float4*>(set + b_off + r * C);
        const float4 b1 = *reinterpret_cast<const float4*>(set + b_off + r * C + C / 2);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        if (works) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        if (sums) {
#pragma unroll
          for (int j = 0; j < 8; ++j) cs[j] += b[j];
        }
      }
    }
  }
  cp_async_wait<0>();   // only empty groups are left
  if (m < 4) {
    // a dead tap's product is zero
    float* out = m < 3 ? dw3 + m * C * C : dw1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* row = out + (4 * p + (i & 3) + (i >> 2) * (C / 2)) * C + 4 * q;
      store4(row, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      store4(row + C / 2, acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  if (sums) {
    float* col = (m == 3 ? db1 : db3) + 4 * q;
    store4(col, cs[0], cs[1], cs[2], cs[3]);
    store4(col + C / 2, cs[4], cs[5], cs[6], cs[7]);
  }
}

// The weight gradients of the launch's Lt layers from the dz and da slots:
// one item a (layer l, chunk p); with more than one chunk, partials
// [dW3 (3, C, C) | db3 | dW1 | db1] per (l, p), then, after a barrier,
// their sums in chunk order.
template <int C>
__device__ void weight_gradients(const Stages& st, const Buffers& io, int Lt, int center,
                                 float* smem) {
  constexpr int E = 4 * C * C + 2 * C;
  constexpr int C2 = C * C;
  const int T = io.T;
  const int P = io.P;
  const long long TC = (long long)T * C;
  for (int it = blockIdx.x; it < Lt * P; it += gridDim.x) {
    const int l = it / P;
    const int p = it % P;
    int s, i;
    locate(st, l, s, i);
    const int shift[3] = {center << i, (center - 1) << i, (center - 2) * (1 << i)};
    float* part = io.partial + ((long long)l * P + p) * E;
    const bool direct = P == 1;
    weight_item<C>(io.y_saved + l * TC, io.h_saved + l * TC, io.dz + l * TC, io.da + l * TC,
                   shift, T, p * kChunk, min(T, (p + 1) * kChunk),
                   direct ? io.dw3 + (long long)l * 3 * C2 : part,
                   direct ? io.db3 + l * C : part + 3 * C2,
                   direct ? io.dw1 + (long long)l * C2 : part + 3 * C2 + C,
                   direct ? io.db1 + l * C : part + 4 * C2 + C, smem);
  }
  if (P > 1) cg::this_grid().sync();
  mark(io.marks, 2);
  if (P == 1) return;
  // four consecutive entries a thread, never across a gradient's boundary
  // (3C^2, 3C^2 + C and 4C^2 + C are multiples of 4); the partials of a
  // group of 8 chunks are loaded before they are added, in chunk order
  for (long long e = 4 * ((long long)blockIdx.x * kThreads + threadIdx.x);
       e < (long long)Lt * E; e += 4LL * gridDim.x * kThreads) {
    const int l = (int)(e / E);
    const int x = (int)(e % E);
    const float* src = io.partial + (long long)l * P * E + x;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p0 = 0; p0 < P; p0 += 8) {
      float4 v[8];
#pragma unroll
      for (int p = 0; p < 8; ++p)
        if (p0 + p < P) v[p] = __ldcg(reinterpret_cast<const float4*>(src + (long long)(p0 + p) * E));
#pragma unroll
      for (int p = 0; p < 8; ++p)
        if (p0 + p < P) {
          sum.x += v[p].x; sum.y += v[p].y; sum.z += v[p].z; sum.w += v[p].w;
        }
    }
    float* dst = x < 3 * C2 ? io.dw3 + (long long)l * 3 * C2 + x
               : x < 3 * C2 + C ? io.db3 + (long long)l * C + x - 3 * C2
               : x < 4 * C2 + C ? io.dw1 + (long long)l * C2 + x - 3 * C2 - C
               : io.db1 + (long long)l * C + x - 4 * C2 - C;
    *reinterpret_cast<float4*>(dst) = sum;
  }
}

template <int C, int RM>
__global__ void __launch_bounds__(kThreads, 1) tcn_bwd_kernel(Stages st, Buffers io) {
  using Tl = Tile<C, RM>;
  using Wt = Weights<C>;
  constexpr int R = Tl::kRows;
  static_assert(6 * kItemStages * kItemRows * C * sizeof(float) <= Tl::kSmem,
                "the weight-gradient ring must fit the chain's shared memory");
  extern __shared__ __align__(16) float smem[];
  float* das = smem + 2 * Wt::kSize;   // [3][R][C] da_k at the taps' rows
  float* dhs = das + 3 * R * C;        // [R][C] dh
  float* ys = dhs + R * C;             // [R][C] y of layer k - 1
  float* dzs = ys + R * C;             // [R][C] dz of layer k - 1

  cg::grid_group grid = cg::this_grid();
  const int T = io.T;
  const long long TC = (long long)T * C;
  const int tiles = (T + R - 1) / R;
  const int o = 4 * (threadIdx.x % Tl::kColGroups);
  const int r0 = (threadIdx.x / Tl::kColGroups) * RM;
  const int center = io.causal ? 2 : 1;       // the tap with shift 0
  int Lt = 0;
  for (int s = 0; s < st.S; ++s) Lt += st.layers[s];

  mark(io.marks, 0);
  stage_step<C>(smem + (Lt & 1) * Wt::kSize, st, Lt, Lt);
  cp_async_commit();
  for (int k = Lt; k >= 0; --k) {
    // step k: B(k) unless k = Lt, then A(k - 1) unless k = 0
    const bool has_b = k < Lt, has_a = k > 0;
    const float* w = smem + (k & 1) * Wt::kSize;
    int sb = 0, ib = 0, sa = 0, ia = 0;
    if (has_b) locate(st, k, sb, ib);
    if (has_a) locate(st, k - 1, sa, ia);
    const int d = 1 << ib;                   // B's tap j reads da row u + (center - j) d
    const float* da_b = io.da + k * TC;
    const long long a_off = (long long)(k - 1) * TC;
    const bool load_dh = has_b || !io.fresh;
    const float* g = has_a && ia + 1 == st.layers[sa] ? io.g + sa * TC : nullptr;
    const unsigned char* mask =
        has_a && st.mask[sa] != nullptr ? st.mask[sa] + ia * TC : nullptr;
    bool prefetched = false;

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int t0 = tile * R;
      const int t_last = min(t0 + R, T) - 1;
      if (has_b) {
        for (int q = threadIdx.x; q < 3 * R * C / 4; q += kThreads) {
          const int j = q / (R * C / 4);
          const int shift = (center - j) * d;
          if (!tap_live(t0, t_last, -shift, T)) continue;
          const int row = t0 + (q / (C / 4)) % R + shift;
          const bool in = row >= 0 && row < T;
          cp_async16(das + 4 * q, in ? da_b + (long long)row * C + 4 * (q % (C / 4)) : da_b,
                     in ? 16 : 0);
        }
      }
      for (int q = threadIdx.x; q < R * C / 4; q += kThreads) {
        const int t = t0 + q / (C / 4);
        const long long at = (long long)t * C + 4 * (q % (C / 4));
        const bool in = t < T;
        if (load_dh) cp_async16(dhs + 4 * q, in ? io.dh + at : io.dh, in ? 16 : 0);
        if (has_a)
          cp_async16(ys + 4 * q, in ? io.y_saved + a_off + at : io.y_saved, in ? 16 : 0);
      }
      cp_async_commit();
      if (!prefetched) {
        // the next step's weights, into the buffer that step k + 1 used
        if (k > 0) stage_step<C>(smem + ((k - 1) & 1) * Wt::kSize, st, k - 1, Lt);
        cp_async_commit();
        prefetched = true;
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      float acc[RM][4];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float4 v = load_dh ? *reinterpret_cast<const float4*>(dhs + (r0 + r) * C + o)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[r][0] = v.x; acc[r][1] = v.y; acc[r][2] = v.z; acc[r][3] = v.w;
      }
      if (has_b) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
          if (tap_live(t0, t_last, -(center - j) * d, T))
            product<C, RM>(acc, das + (j * R + r0) * C, w + j * C * C, o);
      }
      if (!has_a) {
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const int t = t0 + r0 + r;
          if (t < T) store4(io.dh + (long long)t * C + o, acc[r]);
        }
        __syncthreads();   // shared memory is free for the next tile
        continue;
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int t = t0 + r0 + r;
        float dz[4] = {0.f, 0.f, 0.f, 0.f};
        if (t < T) {
          const long long at = (long long)t * C + o;
          if (g != nullptr) {
            const float4 gv = __ldg(reinterpret_cast<const float4*>(g + at));
            acc[r][0] += gv.x; acc[r][1] += gv.y; acc[r][2] += gv.z; acc[r][3] += gv.w;
          }
          store4(io.dh + at, acc[r]);
#pragma unroll
          for (int q = 0; q < 4; ++q) dz[q] = acc[r][q];
          if (mask != nullptr) {
            const uchar4 m = __ldg(reinterpret_cast<const uchar4*>(mask + at));
            dz[0] *= (float)m.x * st.scale; dz[1] *= (float)m.y * st.scale;
            dz[2] *= (float)m.z * st.scale; dz[3] *= (float)m.w * st.scale;
          }
          store4(io.dz + a_off + at, dz);
        }
        store4(dzs + (r0 + r) * C + o, dz);
      }
      __syncwarp();   // a row group's threads share one warp

#pragma unroll
      for (int r = 0; r < RM; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      product<C, RM>(acc, dzs + r0 * C, w + Wt::kW1, o);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int t = t0 + r0 + r;
        if (t >= T) continue;
        const float4 y = *reinterpret_cast<const float4*>(ys + (r0 + r) * C + o);
        const float da[4] = {y.x > 0.f ? acc[r][0] : 0.f, y.y > 0.f ? acc[r][1] : 0.f,
                             y.z > 0.f ? acc[r][2] : 0.f, y.w > 0.f ? acc[r][3] : 0.f};
        store4(io.da + a_off + (long long)t * C + o, da);
      }
      __syncthreads();   // shared memory is free for the next tile
    }
    if (!prefetched) {
      // a block with no tile in this step still loads the next weights
      if (k > 0) stage_step<C>(smem + ((k - 1) & 1) * Wt::kSize, st, k - 1, Lt);
      cp_async_commit();
    }
    cp_async_wait<0>();
    if (k > 0) grid.sync();
  }
  mark(io.marks, 1);
  weight_gradients<C>(st, io, Lt, center, smem);
  mark(io.marks, 3);
}

// The barrier floor: the same grid, n grid barriers and no work.
__global__ void __launch_bounds__(kThreads, 1) tcn_bwd_barrier_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < n; ++k) grid.sync();
}

struct Launch {
  const void* kernel;
  int grid;
  int rows;
  size_t smem;
};

// Blocks of one instance the card runs at once, for the current device.
template <int C, int RM>
cudaError_t candidate(int T, Launch* out) {
  using Tl = Tile<C, RM>;
  static int resident[kMaxDevices] = {0};   // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(tcn_bwd_kernel<C, RM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::kSmem);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tcn_bwd_kernel<C, RM>,
                                                        kThreads, Tl::kSmem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  const int tiles = (T + Tl::kRows - 1) / Tl::kRows;
  *out = Launch{reinterpret_cast<const void*>(tcn_bwd_kernel<C, RM>),
                tiles < resident[dev] ? tiles : resident[dev], Tl::kRows, Tl::kSmem};
  return cudaSuccess;
}

long long rows_per_block(int T, const Launch& c) {
  const long long tiles = (T + c.rows - 1) / c.rows;
  return (tiles + c.grid - 1) / c.grid * c.rows;
}

// The instance for T rows: fewest rows per block, then the taller tile.
template <int C>
cudaError_t choose(int T, Launch* best) {
  Launch one, two;
  cudaError_t err = candidate<C, 1>(T, &one);
  if (err == cudaSuccess) err = candidate<C, 2>(T, &two);
  if (err != cudaSuccess) return err;
  *best = rows_per_block(T, two) <= rows_per_block(T, one) ? two : one;
  return cudaSuccess;
}

cudaError_t choose(int T, int C, Launch* best) {
  if (T < 1) return cudaErrorInvalidValue;
  switch (C) {
    case 8: return choose<8>(T, best);
    case 16: return choose<16>(T, best);
    case 32: return choose<32>(T, best);
    case 64: return choose<64>(T, best);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int chunks(int T) { return (T + kChunk - 1) / kChunk; }

// One stage's operands as the caller lays them out.
struct StageOperands {
  const float* w3;
  const float* w1;
  const unsigned char* mask;
  int layers;
};

// The backward of S stages run back to back, operands(s) giving stage s:
// one launch for every kStagesPerLaunch stages, the last group first, each
// launch continuing the dh the one before left. launched is raised by one
// for every launch the runtime accepted; blocks and rows receive the grid
// and tile height they ran with.
template <class Operands>
int run(int S, Operands operands, float scale, Buffers io, int C, int* launched, int* blocks,
        int* rows, void* stream) {
  if (S < 1) return cudaErrorInvalidValue;
  bool aligned = aligned16(io.g) && aligned16(io.h_saved) && aligned16(io.y_saved) &&
                 aligned16(io.dh) && aligned16(io.dz) && aligned16(io.da) &&
                 aligned16(io.partial) && aligned16(io.dw3) && aligned16(io.db3) &&
                 aligned16(io.dw1) && aligned16(io.db1);
  long long Lt = 0;
  for (int s = 0; s < S; ++s) {
    const StageOperands o = operands(s);
    if (o.layers < 1 || o.layers > kMaxLayers) return cudaErrorInvalidValue;
    aligned = aligned && aligned16(o.w3) && aligned16(o.w1) &&
              (reinterpret_cast<uintptr_t>(o.mask) & 3) == 0;
    Lt += o.layers;
  }
  if (!aligned) return cudaErrorMisalignedAddress;
  Launch cfg;
  cudaError_t err = choose(io.T, C, &cfg);
  if (err != cudaSuccess) return err;
  io.P = chunks(io.T);
  if (io.P > 1 && io.partial == nullptr) return cudaErrorInvalidValue;
  const long long TC = (long long)io.T * C;
  long long layer_end = Lt;   // layers before the current group's end
  bool fresh = true;
  for (int a = (S - 1) / kStagesPerLaunch * kStagesPerLaunch; a >= 0; a -= kStagesPerLaunch) {
    Stages st{};
    st.S = S - a < kStagesPerLaunch ? S - a : kStagesPerLaunch;
    st.scale = scale;
    long long n = 0;
    for (int s = 0; s < st.S; ++s) {
      const StageOperands o = operands(a + s);
      st.w3[s] = o.w3;
      st.w1[s] = o.w1;
      st.mask[s] = o.mask;
      st.layers[s] = o.layers;
      n += o.layers;
    }
    const long long layer0 = layer_end - n;
    Buffers part = io;
    part.g = io.g + a * TC;
    part.h_saved = io.h_saved + layer0 * TC;
    part.y_saved = io.y_saved + layer0 * TC;
    part.dz = io.dz + layer0 * TC;
    part.da = io.da + layer0 * TC;
    part.dw3 = io.dw3 + layer0 * 3 * C * C;
    part.db3 = io.db3 + layer0 * C;
    part.dw1 = io.dw1 + layer0 * C * C;
    part.db1 = io.db1 + layer0 * C;
    part.fresh = fresh;
    void* args[] = {&st, &part};
    err = cudaLaunchCooperativeKernel(cfg.kernel, dim3(cfg.grid), dim3(kThreads), args,
                                      cfg.smem, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    ++*launched;
    fresh = false;
    layer_end = layer0;
  }
  *blocks = cfg.grid;
  *rows = cfg.rows;
  return cudaSuccess;
}

// Dynamic shared memory of the backward instance whose tiles hold `rows`
// rows at C channels; 0 when there is none.
template <int C>
size_t smem_for_rows(int rows) {
  return rows == Tile<C, 1>::kRows ? Tile<C, 1>::kSmem
       : rows == Tile<C, 2>::kRows ? Tile<C, 2>::kSmem : 0;
}

}  // namespace

// Weight-gradient chunks of a backward over T rows: the partial buffer is
// (Lt, P, 4C^2 + 2C) floats when P > 1, and not used when P = 1.
extern "C" int tcn_stack_bwd_chunks(int T) { return chunks(T); }

// Backward of stages run back to back with per-stage operands, Lt =
// sum(layers) layers. g (S, T, C); h_saved, y_saved (Lt, T, C); w3[s]
// (L_s, 3, C, C), w1[s] (L_s, C, C); masks null or S pointers to (L_s, T,
// C) uint8; dx (T, C) out; dz, da (Lt, T, C) scratch; partial see
// tcn_stack_bwd_chunks; dw3 (Lt, 3, C, C), db3 (Lt, C), dw1 (Lt, C, C),
// db1 (Lt, C) out; marks null or 4 device words (see mark(); the last
// launch's); scale the forward's factor of a kept element. One launch for every 16 stages. launched is raised by
// one for every launch the runtime accepted; blocks and rows receive the
// grid and the tile height. Returns a cudaError_t code.
extern "C" int tcn_stages_bwd(const float* g, const float* h_saved, const float* y_saved,
                              const float* const* w3, const float* const* w1,
                              const unsigned char* const* masks, const int* layers, int S,
                              float* dx, float* dz, float* da, float* partial, float* dw3,
                              float* db3, float* dw1, float* db1,
                              unsigned long long* marks, int T, int C, int causal,
                              float scale, int* launched, int* blocks, int* rows,
                              void* stream) {
  const auto operands = [&](int s) {
    return StageOperands{w3[s], w1[s], masks != nullptr ? masks[s] : nullptr, layers[s]};
  };
  const Buffers io{g, h_saved, y_saved, dx, dz, da, partial, dw3, db3, dw1, db1, marks, T,
                   causal, 1, 0};
  return run(S, operands, scale, io, C, launched, blocks, rows, stream);
}

// Stacks of L0, Lr, Lr, ... layers (Lt in all) with their operands
// concatenated on the layer axis: w3 (Lt, 3, C, C), w1 (Lt, C, C), mask
// (Lt, T, C) or null; each stage's slices are found by offset, so stage s
// ends at layer L0 - 1 + s Lr. Other arguments and launches as
// tcn_stages_bwd.
extern "C" int tcn_multistack_bwd(const float* g, const float* h_saved, const float* y_saved,
                                  const float* w3, const float* w1, const unsigned char* mask,
                                  float* dx, float* dz, float* da, float* partial, float* dw3,
                                  float* db3, float* dw1, float* db1,
                                  unsigned long long* marks, int T, int C, int Lt, int L0,
                                  int Lr, int causal, float scale, int* launched, int* blocks,
                                  int* rows, void* stream) {
  if (L0 < 1 || Lr < 1 || Lt < L0 || (Lt - L0) % Lr != 0) return cudaErrorInvalidValue;
  const auto operands = [&](int s) {
    const long long off = s == 0 ? 0 : L0 + (long long)(s - 1) * Lr;
    return StageOperands{w3 + off * 3 * C * C, w1 + off * C * C,
                         mask != nullptr ? mask + off * T * C : nullptr, s == 0 ? L0 : Lr};
  };
  const Buffers io{g, h_saved, y_saved, dx, dz, da, partial, dw3, db3, dw1, db1, marks, T,
                   causal, 1, 0};
  return run(1 + (Lt - L0) / Lr, operands, scale, io, C, launched, blocks, rows, stream);
}

// The floor of the design: a backward's grid (blocks of the instance with
// `rows`-row tiles at C channels: same threads and shared memory) running
// n grid barriers and nothing else.
extern "C" int tcn_stack_bwd_barriers(int blocks, int rows, int C, int n, void* stream) {
  const size_t smem = C == 8 ? smem_for_rows<8>(rows)
                    : C == 16 ? smem_for_rows<16>(rows)
                    : C == 32 ? smem_for_rows<32>(rows)
                    : C == 64 ? smem_for_rows<64>(rows) : 0;
  if (smem == 0 || blocks < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tcn_bwd_barrier_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&n};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(tcn_bwd_barrier_kernel),
                                     dim3(blocks), dim3(kThreads), args, smem,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" const char* tcn_stack_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
