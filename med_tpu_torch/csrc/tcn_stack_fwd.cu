// Dilated residual TCN stacks run back to back, forward: every layer of
// every stack in one persistent launch.
//
// Replaces the layer loop of three Pallas TPU kernels of
// med_tpu/ops/tcn_fused.py, each of which runs one layer per grid step and
// carries the (T, C) activation in VMEM from layer to layer:
// _multi_fwd_kernel_s (the merged multi-stage stack behind
// dilated_residual_multistack_stages), _fwd_kernel (the single stack behind
// dilated_residual_stack) and _multi_fwd_kernel (the stacks with their
// operands concatenated on the layer axis, behind dilated_residual_multistack).
//
// Layer i of a stack, at dilation d = 2^i:
//   y   = relu(b3 + sum_j h[t - s_j] @ w3[j])      taps s = (2d, d, 0) causal,
//                                                   (d, 0, -d) acausal
//   z   = y @ w1 + b1     (times scale*mask when a uint8 keep-mask is given;
//                          scale = 1 / (1 - dropout rate), 2 at rate 0.5)
//   out = h + z
// Rows outside [0, T) read zero. x, h, out (T, C) row-major; w3 (3, C, C) and
// w1 (C, C) [in][out]; b3, b1 (C); mask (T, C). The output of a stack's last
// layer is its row of hs (S, T, C) and the input of the next stack. A
// training forward also writes every layer's input h and post-relu y to
// h_saved and y_saved (Lt, T, C), the layout the backward kernel reads
// (tcn_stack_bwd.cu).
//
// What bounds it on an H100: operations. A layer is 8*T*C*C flops against
// ~2*T*C*4 bytes of activations, ~64 flop/byte at C=64, above the fp32 ridge
// of ~20 (67 TFLOP/s over 3.35 TB/s): 0.0828 ms for COG's 41 layers at
// T=4096. The design adds a floor of its own, one grid barrier between
// layers: a layer's taps reach up to 2 * 2^10 rows back, rows that other
// blocks wrote in the layer before (tcn_stack_barriers times it alone).
//
// Design:
// - One cooperative launch (cudaLaunchCooperativeKernel) runs all the
//   layers of up to 16 stacks (more take one launch per 16);
//   cooperative_groups' grid.sync() separates them. The grid holds
//   at most as many blocks as the card runs at once (occupancy x SMs) and
//   no more than there are row tiles. Block b takes the tiles b,
//   b + gridDim.x, ... of every layer, and every block reaches every
//   barrier. A refused launch returns its error; there is no other path.
// - The tile height is chosen per call between two instances (16 or 32
//   rows at C=64) so that the tiles spread over the SMs: fewest rows per
//   block, then the taller tile.
// - Activations ping-pong between two (T, C) scratch buffers that stay in
//   L2. Other blocks wrote them earlier in the same launch, so the tap rows
//   come in through cp.async.cg, which bypasses L1 (a line there could be
//   stale); weights and masks are never written and may take any path. A
//   tap whose rows all lie outside [0, T) is neither loaded nor multiplied.
// - A thread keeps RM rows x 4 output channels of sums in registers. Per 4
//   input channels it reads RM + 4 float4 from shared memory for 16 RM
//   FMAs; a quarter warp reads one activation row by broadcast and 128
//   consecutive bytes of weights, so no bank conflicts.
// - The next layer's w3, w1, b3, b1 (66 KB at C=64) are copied with
//   cp.async into the second of two shared buffers while this layer runs.
// - y stays in shared memory between the two products; the threads that
//   read a row of it are the warp that wrote it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kStagesPerLaunch = 16;   // see run()
constexpr int kMaxLayers = 30;   // a stack's widest tap, 2 * 2^29 rows, is an int
constexpr int kMaxDevices = 64;

// Per-stage operands: layer i of stage s has w3[s] + i*3*C*C, ...,
// mask[s] + i*T*C.
struct Stages {
  const float* w3[kStagesPerLaunch];
  const float* b3[kStagesPerLaunch];
  const float* w1[kStagesPerLaunch];
  const float* b1[kStagesPerLaunch];
  const unsigned char* mask[kStagesPerLaunch];   // null: no mask
  float scale;   // a kept element's factor, 1 / (1 - dropout rate)
  int layers[kStagesPerLaunch];
  int S;
};

struct Buffers {
  const float* x;     // (T, C)
  float* hs;          // (S, T, C)
  float* scratch;     // (2, T, C)
  float* h_saved;     // (Lt, T, C) or null
  float* y_saved;     // (Lt, T, C) or null
  int T;
  int causal;
};

// One layer's weights in shared memory: w3 | w1 | b3 | b1, in floats.
template <int C>
struct Weights {
  static constexpr int kW1 = 3 * C * C;
  static constexpr int kB3 = 4 * C * C;
  static constexpr int kB1 = 4 * C * C + C;
  static constexpr int kSize = 4 * C * C + 2 * C;
};

// Thread (row group, channel group) holds rows RM*group .. +RM-1 of a tile
// and output channels 4*channel group .. +3.
template <int C, int RM>
struct Tile {
  static constexpr int kColGroups = C / 4;
  static constexpr int kRowGroups = kThreads / kColGroups;
  static constexpr int kRows = kRowGroups * RM;
  // two weight buffers, three tap tiles, the y tile
  static constexpr size_t kSmem =
      (size_t)(2 * Weights<C>::kSize + 4 * kRows * C) * sizeof(float);
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

template <int C>
__device__ __forceinline__ void stage_weights(float* dst, const Stages& st, int s, int i) {
  constexpr int n3 = 3 * C * C / 4, n1 = C * C / 4, nb = C / 4;
  const float* w3 = st.w3[s] + (long long)i * 3 * C * C;
  const float* w1 = st.w1[s] + (long long)i * C * C;
  const float* b3 = st.b3[s] + i * C;
  const float* b1 = st.b1[s] + i * C;
  for (int k = threadIdx.x; k < n3 + n1 + 2 * nb; k += kThreads) {
    const float* src = k < n3 ? w3 + 4 * k
                     : k < n3 + n1 ? w1 + 4 * (k - n3)
                     : k < n3 + n1 + nb ? b3 + 4 * (k - n3 - n1)
                     : b1 + 4 * (k - n3 - n1 - nb);
    cp_async16(dst + 4 * k, src, 16);
  }
}

// Whether a tap shifted by `shift` reads any row of [0, T) for the tile's
// rows t0 .. t_last; a tap that reads none adds nothing.
__device__ __forceinline__ bool tap_live(int t0, int t_last, int shift, int T) {
  return t0 - shift < T && t_last - shift >= 0;
}

__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <int RM>
__device__ __forceinline__ void fma4(float (&acc)[RM][4], const float4 (&a)[RM], int k,
                                     const float4& w) {
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const float v = lane(a[r], k);
    acc[r][0] = fmaf(v, w.x, acc[r][0]);
    acc[r][1] = fmaf(v, w.y, acc[r][1]);
    acc[r][2] = fmaf(v, w.z, acc[r][2]);
    acc[r][3] = fmaf(v, w.w, acc[r][3]);
  }
}

// acc[r] += rows[r] (C values from shared memory) @ w (C, C) for the
// thread's 4 output channels: w points at column o of row 0.
template <int C, int RM>
__device__ __forceinline__ void product(float (&acc)[RM][4], const float* rows,
                                        const float* w) {
#pragma unroll 4
  for (int c = 0; c < C; c += 4) {
    float4 a[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) a[r] = *reinterpret_cast<const float4*>(rows + r * C + c);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      fma4<RM>(acc, a, k, *reinterpret_cast<const float4*>(w + (c + k) * C));
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

template <int C, int RM>
__global__ void __launch_bounds__(kThreads, 1) tcn_stack_kernel(Stages st, Buffers io) {
  using Tl = Tile<C, RM>;
  using Wt = Weights<C>;
  constexpr int R = Tl::kRows;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem + 2 * Wt::kSize;   // [3][R][C] the taps' input rows
  float* ys = xs + 3 * R * C;         // [R][C] post-relu activations

  cg::grid_group grid = cg::this_grid();
  const int T = io.T;
  const long long TC = (long long)T * C;
  const int tiles = (T + R - 1) / R;
  const int o = 4 * (threadIdx.x % Tl::kColGroups);
  const int r0 = (threadIdx.x / Tl::kColGroups) * RM;
  const int center = io.causal ? 2 : 1;       // the tap with shift 0
  int Lt = 0;
  for (int s = 0; s < st.S; ++s) Lt += st.layers[s];

  stage_weights<C>(smem, st, 0, 0);
  cp_async_commit();
  const float* src = io.x;
  int l = 0;
  for (int s = 0; s < st.S; ++s) {
    for (int i = 0; i < st.layers[s]; ++i, ++l) {
      const float* w = smem + (l & 1) * Wt::kSize;
      const bool stage_end = i + 1 == st.layers[s];
      const int d = 1 << i;   // tap j reads row t - (center - j) * d
      float* dst = stage_end ? io.hs + s * TC : io.scratch + (l & 1) * TC;
      const unsigned char* mask = st.mask[s] != nullptr ? st.mask[s] + i * TC : nullptr;
      float* y_out = io.y_saved != nullptr ? io.y_saved + l * TC : nullptr;
      float* h_out = io.h_saved != nullptr ? io.h_saved + l * TC : nullptr;
      bool prefetched = false;

      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int t0 = tile * R;
        const int t_last = min(t0 + R, T) - 1;
        for (int k = threadIdx.x; k < 3 * R * C / 4; k += kThreads) {
          const int j = k / (R * C / 4);
          const int shift = (center - j) * d;
          if (!tap_live(t0, t_last, shift, T)) continue;
          const int r = (k / (C / 4)) % R;
          const int row = t0 + r - shift;
          const bool in = row >= 0 && row < T;
          cp_async16(xs + 4 * k, in ? src + (long long)row * C + 4 * (k % (C / 4)) : src,
                     in ? 16 : 0);
        }
        cp_async_commit();
        if (!prefetched) {
          // the next layer's weights, into the buffer that layer l - 1 used
          if (l + 1 < Lt) stage_weights<C>(smem + ((l + 1) & 1) * Wt::kSize, st,
                                           stage_end ? s + 1 : s, stage_end ? 0 : i + 1);
          cp_async_commit();
          prefetched = true;
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();

        float acc[RM][4];
        const float4 bias3 = *reinterpret_cast<const float4*>(w + Wt::kB3 + o);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          acc[r][0] = bias3.x; acc[r][1] = bias3.y; acc[r][2] = bias3.z; acc[r][3] = bias3.w;
        }
#pragma unroll
        for (int j = 0; j < 3; ++j)
          if (tap_live(t0, t_last, (center - j) * d, T))
            product<C, RM>(acc, xs + (j * R + r0) * C, w + j * C * C + o);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float y0 = fmaxf(acc[r][0], 0.f), y1 = fmaxf(acc[r][1], 0.f);
          const float y2 = fmaxf(acc[r][2], 0.f), y3 = fmaxf(acc[r][3], 0.f);
          store4(ys + (r0 + r) * C + o, y0, y1, y2, y3);
          const int t = t0 + r0 + r;
          if (y_out != nullptr && t < T) store4(y_out + (long long)t * C + o, y0, y1, y2, y3);
        }
        __syncwarp();   // a row group's threads share one warp

#pragma unroll
        for (int r = 0; r < RM; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
        product<C, RM>(acc, ys + r0 * C, w + Wt::kW1 + o);
        const float4 bias1 = *reinterpret_cast<const float4*>(w + Wt::kB1 + o);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const int t = t0 + r0 + r;
          if (t >= T) continue;
          const long long at = (long long)t * C + o;
          float z[4] = {acc[r][0] + bias1.x, acc[r][1] + bias1.y, acc[r][2] + bias1.z,
                        acc[r][3] + bias1.w};
          if (mask != nullptr) {
            const uchar4 m = __ldg(reinterpret_cast<const uchar4*>(mask + at));
            z[0] *= (float)m.x * st.scale; z[1] *= (float)m.y * st.scale;
            z[2] *= (float)m.z * st.scale; z[3] *= (float)m.w * st.scale;
          }
          const float4 h = *reinterpret_cast<const float4*>(xs + (center * R + r0 + r) * C + o);
          if (h_out != nullptr) store4(h_out + at, h.x, h.y, h.z, h.w);
          store4(dst + at, h.x + z[0], h.y + z[1], h.z + z[2], h.w + z[3]);
        }
        __syncthreads();   // xs and ys are free for the next tile
      }
      if (!prefetched) {
        // a block with no tile in this layer still loads the next weights
        if (l + 1 < Lt) stage_weights<C>(smem + ((l + 1) & 1) * Wt::kSize, st,
                                         stage_end ? s + 1 : s, stage_end ? 0 : i + 1);
        cp_async_commit();
      }
      cp_async_wait<0>();
      if (l + 1 < Lt) grid.sync();
      src = dst;
    }
  }
}

// The barrier floor: the same grid, n grid barriers and no work.
__global__ void __launch_bounds__(kThreads, 1) tcn_barrier_kernel(int n) {
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
  const void* kernel = reinterpret_cast<const void*>(tcn_stack_kernel<C, RM>);
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(tcn_stack_kernel<C, RM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::kSmem);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tcn_stack_kernel<C, RM>,
                                                        kThreads, Tl::kSmem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  const int tiles = (T + Tl::kRows - 1) / Tl::kRows;
  *out = Launch{kernel, tiles < resident[dev] ? tiles : resident[dev], Tl::kRows, Tl::kSmem};
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

// One stage's operands as the caller lays them out.
struct StageOperands {
  const float* w3;
  const float* b3;
  const float* w1;
  const float* b1;
  const unsigned char* mask;
  int layers;
};

// Runs S stages back to back, operands(s) giving stage s: one launch for
// every kStagesPerLaunch stages (a launch's operands travel as its
// parameters), each launch reading the output of the stage before it.
// launched is raised by one for every launch the runtime accepted; blocks
// and rows receive the grid and tile height they ran with.
template <class Operands>
int run(int S, Operands operands, float scale, Buffers io, int C, int* launched, int* blocks,
        int* rows, void* stream) {
  if (S < 1) return cudaErrorInvalidValue;
  bool aligned = aligned16(io.x) && aligned16(io.hs) && aligned16(io.scratch) &&
                 aligned16(io.h_saved) && aligned16(io.y_saved);
  for (int s = 0; s < S; ++s) {
    const StageOperands o = operands(s);
    if (o.layers < 1 || o.layers > kMaxLayers) return cudaErrorInvalidValue;
    aligned = aligned && aligned16(o.w3) && aligned16(o.b3) && aligned16(o.w1) &&
              aligned16(o.b1) && (reinterpret_cast<uintptr_t>(o.mask) & 3) == 0;
  }
  if (!aligned) return cudaErrorMisalignedAddress;
  Launch cfg;
  cudaError_t err = choose(io.T, C, &cfg);
  if (err != cudaSuccess) return err;
  const long long TC = (long long)io.T * C;
  long long layer0 = 0;   // layers run by earlier launches
  for (int a = 0; a < S; a += kStagesPerLaunch) {
    Stages st{};
    st.S = S - a < kStagesPerLaunch ? S - a : kStagesPerLaunch;
    st.scale = scale;
    for (int s = 0; s < st.S; ++s) {
      const StageOperands o = operands(a + s);
      st.w3[s] = o.w3;
      st.b3[s] = o.b3;
      st.w1[s] = o.w1;
      st.b1[s] = o.b1;
      st.mask[s] = o.mask;
      st.layers[s] = o.layers;
    }
    Buffers part = io;
    if (a > 0) part.x = io.hs + (a - 1) * TC;
    part.hs = io.hs + a * TC;
    if (io.h_saved != nullptr) {
      part.h_saved = io.h_saved + layer0 * TC;
      part.y_saved = io.y_saved + layer0 * TC;
    }
    void* args[] = {&st, &part};
    err = cudaLaunchCooperativeKernel(cfg.kernel, dim3(cfg.grid), dim3(kThreads), args,
                                      cfg.smem, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    ++*launched;
    for (int s = 0; s < st.S; ++s) layer0 += st.layers[s];
  }
  *blocks = cfg.grid;
  *rows = cfg.rows;
  return cudaSuccess;
}

// Dynamic shared memory of the forward instance whose tiles hold `rows`
// rows at C channels; 0 when there is none.
template <int C>
size_t smem_for_rows(int rows) {
  return rows == Tile<C, 1>::kRows ? Tile<C, 1>::kSmem
       : rows == Tile<C, 2>::kRows ? Tile<C, 2>::kSmem : 0;
}

}  // namespace

// Stages back to back with per-stage operands: w3[s] (L_s, 3, C, C), b3[s]
// (L_s, C), w1[s] (L_s, C, C), b1[s] (L_s, C), masks[s] (L_s, T, C) uint8;
// masks, and h_saved with y_saved, may be null; scale multiplies a kept
// element (1 / (1 - dropout rate)). One launch for every 16 stages. launched is raised by one for every launch the runtime accepted;
// blocks and rows receive the grid and the tile height. Returns a
// cudaError_t code.
extern "C" int tcn_stages_fwd(const float* x, const float* const* w3,
                              const float* const* b3, const float* const* w1,
                              const float* const* b1, const unsigned char* const* masks,
                              const int* layers, int S, float* hs, float* h_saved,
                              float* y_saved, float* scratch, int T, int C, int causal,
                              float scale, int* launched, int* blocks, int* rows,
                              void* stream) {
  const auto operands = [&](int s) {
    return StageOperands{w3[s], b3[s], w1[s], b1[s],
                         masks != nullptr ? masks[s] : nullptr, layers[s]};
  };
  return run(S, operands, scale, Buffers{x, hs, scratch, h_saved, y_saved, T, causal}, C,
             launched, blocks, rows, stream);
}

// Stacks of L0, Lr, Lr, ... layers (Lt in all) with their operands
// concatenated on the layer axis: w3 (Lt, 3, C, C), b3 (Lt, C), w1 (Lt, C, C),
// b1 (Lt, C), mask (Lt, T, C) or null. Each stage's slices are found by
// offset. Launches as tcn_stages_fwd.
extern "C" int tcn_multistack_fwd(const float* x, const float* w3, const float* b3,
                                  const float* w1, const float* b1,
                                  const unsigned char* mask, float* hs, float* h_saved,
                                  float* y_saved, float* scratch, int T, int C, int Lt,
                                  int L0, int Lr, int causal, float scale, int* launched,
                                  int* blocks, int* rows, void* stream) {
  if (L0 < 1 || Lr < 1 || Lt < L0 || (Lt - L0) % Lr != 0) return cudaErrorInvalidValue;
  const auto operands = [&](int s) {
    const long long off = s == 0 ? 0 : L0 + (long long)(s - 1) * Lr;
    return StageOperands{w3 + off * 3 * C * C, b3 + off * C, w1 + off * C * C, b1 + off * C,
                         mask != nullptr ? mask + off * T * C : nullptr, s == 0 ? L0 : Lr};
  };
  return run(1 + (Lt - L0) / Lr, operands, scale,
             Buffers{x, hs, scratch, h_saved, y_saved, T, causal}, C, launched, blocks, rows,
             stream);
}

// The floor of the design: a forward's grid (blocks of the instance with
// `rows`-row tiles at C channels: same threads and shared memory) running
// n grid barriers and nothing else.
extern "C" int tcn_stack_barriers(int blocks, int rows, int C, int n, void* stream) {
  const size_t smem = C == 8 ? smem_for_rows<8>(rows)
                    : C == 16 ? smem_for_rows<16>(rows)
                    : C == 32 ? smem_for_rows<32>(rows)
                    : C == 64 ? smem_for_rows<64>(rows) : 0;
  if (smem == 0 || blocks < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tcn_barrier_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&n};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(tcn_barrier_kernel),
                                     dim3(blocks), dim3(kThreads), args, smem,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" const char* tcn_stack_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
