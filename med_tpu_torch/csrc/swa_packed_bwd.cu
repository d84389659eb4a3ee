// Banded sliding-window attention, backward, in the packed layout.
//
// Replaces med_tpu/ops/attention.py::_swa_packed_bwd_kernel, the Pallas TPU
// kernel behind sliding_window_attention_packed_bwd, and the delta pass that
// the JAX side runs before it (delta = einsum("hdn,hdn->hn", out, g)).
//
// Layout, as at the Python function and the forward (swa_packed_fwd.cu):
//   q, g, out, dq  (H, D, N)  N = T*m query tokens, token n = t*m + j of frame t
//   k, v, dk, dv   (H, D, T)
//   stats          (H, 2, N)  row 0 the forward's logsumexp (row 1 unused here)
// Query n attends the keys of frames t-W+1 .. t; frames before 0 are the
// forward's zero keys, which get no gradient. With q^ = q / sqrt(D):
//   delta_n = out_n . g_n
//   a   = exp(q^_n . k_f - lse_n)       (the softmax, from the saved stats)
//   ds  = a * (g_n . v_f - delta_n)
//   dq_n = sum_f ds k_f / sqrt(D),  dk_f = sum_n ds q^_n,  dv_f = sum_n a g_n
//
// What bounds it on an H100: memory, just. Per query it reads q, g, out (3D
// floats) and lse and writes dq (D floats); per (query, key) pair it needs
// 40 FMAs (score, g.v, dq, dk, dv) and one exp. At COG's D=8, W=30 that is
// ~19 flop/byte against the card's fp32 ridge of ~20.
//
// Design: every (query, key) pair is computed once, and nothing is summed
// with atomics. One cooperative launch; each block walks tiles (head, F
// frames, MB query slots of each frame) in a grid-stride loop:
// - staging: the tile's F+W-1 K/V rows and zero halo come by 4-byte cp.async
//   (zero-filled outside [0, T)) into one of two buffers, and each thread's
//   first query (q, g, out, lse) by plain loads into registers, both issued
//   while the previous tile computes; q^, g and (lse, delta), delta formed
//   there from out and g, go to shared rows with a stride of D+4 floats
//   (16-byte stores without bank conflicts);
// - phase 1, one thread per (frame, window position w, slot group): the key
//   row in registers, it walks the frame's query slots, computes s, a, g.v
//   and ds once a pair, writes ds to a (query, w) band in shared memory and
//   keeps its key's dk, dv partial over those slots in registers; the
//   partials land in shared memory P[frame][slot group][2D][w];
// - phase 2: one thread per query sums dq = ds . k over its W keys from the
//   band (16-byte loads; the band's row stride is 4 mod 8 floats, so a
//   quarter warp's rows fall in distinct banks), nothing recomputed; and one
//   thread per (output, key row) of the tile sums P over the slot groups and
//   frames in a fixed order into the tile's slot of a scratch buffer (the
//   tile's keys f0-W+1 .. f0+F-1, which the tiles before and after share);
// - after one grid barrier, tile (h, i) sums the partials of its own keys
//   i*F .. i*F+F-1 in tile order into dk / dv.
// The order of every sum is fixed by the shapes, so runs give the same bits
// whatever the grid. A tile holds F = 16 frames where that fits two blocks
// an SM (COG: ~96 KB); fewer frames, then fewer slots a tile (large m),
// where it does not. Where no tiling of the whole window fits (large W * D),
// the tile walks its window in chunks of WC positions: each chunk stages its
// F+WC-1 key rows, adds its dq terms to the dq the chunk before wrote, and
// adds the partials of the F-1 key rows it shares with the chunk before to
// that chunk's scratch rows, so the sums keep a fixed order. expf (not
// __expf) keeps parity with the reference.
//
// D = 2 (TransSVNet): the staged rows are 8 bytes. K/V, q^ and g rows go
// between shared memory and registers as float2 (row stride D,
// swa_common.cuh), the ds band stays 16-byte aligned for its float4 reads
// (every region before it is a multiple of 4 floats), and the (lse, delta)
// pairs 8-byte aligned; a tile of 16 frames of 30 slots takes ~88 KB, two
// blocks an SM.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include <initializer_list>

#include "swa_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 16;
constexpr size_t kTwoBlocks = 110 * 1024;     // two blocks an SM
constexpr size_t kMaxSmem = 227 * 1024;       // one block an SM

// A launch's tiling, from the shapes alone, so that the scratch the caller
// allocates and the launch agree.
struct Plan {
  int F;        // frames a tile
  int MB;       // query slots a tile (m unless m is large)
  int nc;       // slot blocks a frame: ceil(m / MB)
  int S;        // slot groups of a phase-1 item
  int WC;       // window positions a chunk (W unless W * D is large)
  int KR;       // key rows a tile touches: F + W - 1
  int KC;       // key rows a chunk stages: F + WC - 1
  int n_tiles;  // frame tiles: ceil(T / F)
  int DP;       // row stride of the staged q^ and g (floats)
  int WP;       // row stride of the ds band (floats)
  size_t smem;
  long long scratch;   // floats
};

int row_stride(int D) { return D % 8 == 0 ? D + 4 : D; }

int band_stride(int W) {
  const int wp = (W + 3) / 4 * 4;
  return wp % 8 == 0 ? wp + 4 : wp;
}

__host__ __device__ int round4(int x) { return (x + 3) / 4 * 4; }

size_t smem_floats(int D, int WC, int F, int MB, int S) {
  const int QT = F * MB;
  return 4 * (size_t)(F + WC - 1) * D                  // ks, vs, two buffers each
         + 2 * (size_t)QT * row_stride(D)              // qs, gs
         + round4(2 * QT)                              // (lse, delta)
         + (size_t)QT * band_stride(WC)                // ds band
         + (size_t)F * S * 2 * D * WC;                 // P
}

bool fits(int H, int D, int T, int m, int W, int WC, int F, int nc, size_t budget,
          Plan* p) {
  const int MB = (m + nc - 1) / nc;
  const int fw = F * WC;                  // phase-1 items of one slot group
  int S = (kThreads + fw - 1) / fw;
  if (S > MB) S = MB;
  const size_t bytes = smem_floats(D, WC, F, MB, S) * sizeof(float);
  if (bytes > budget) return false;
  p->F = F;
  p->MB = MB;
  p->nc = (m + MB - 1) / MB;
  p->S = S;
  p->WC = WC;
  p->KR = F + W - 1;
  p->KC = F + WC - 1;
  p->n_tiles = (T + F - 1) / F;
  p->DP = row_stride(D);
  p->WP = band_stride(WC);
  p->smem = bytes;
  p->scratch = (long long)H * p->n_tiles * p->nc * 2 * D * p->KR;
  return true;
}

// The whole window first: F = 16, 8, .. 1 frames of all m slots, then one
// frame of m/2, m/4, .. slots, within two blocks an SM and then within one.
// Where none fits, the same order of (F, slots), each with the largest of
// WC = W/2, W/4, .. 1 that fits, so a tile keeps as many frames (and the
// scratch as few key rows a frame) as it can. One frame, one slot and
// WC = 1 always fit.
bool plan(int H, int D, int T, int m, int W, Plan* p) {
  if (H < 1 || T < 1 || m < 1 || W < 1) return false;
  // tiles and owners are counted in 32-bit integers
  if ((long long)H * T * m >= INT_MAX) return false;
  for (int chunked = 0; chunked < 2; ++chunked) {
    for (size_t budget : {kTwoBlocks, kMaxSmem}) {
      for (int F = 16, nc = 1;;) {
        if (!chunked) {
          if (fits(H, D, T, m, W, W, F, nc, budget, p)) return true;
        } else {
          for (int WC = (W + 1) / 2; WC < W; WC = (WC + 1) / 2) {
            if (fits(H, D, T, m, W, WC, F, nc, budget, p)) return true;
            if (WC == 1) break;
          }
        }
        if (F > 1) F /= 2;
        else if ((m + nc - 1) / nc > 1) nc *= 2;
        else break;
      }
    }
  }
  return false;
}

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* g;
  const float* out;
  const float* stats;
  float* dq;
  float* dk;
  float* dv;
  float* scratch;
  int H, T, m, W;
  Plan p;
};

using swa::cp_async4;
using swa::load_row;
using swa::store_row;

// One query's operands, fetched into registers ahead of its tile's staging.
template <int D>
struct Fetched {
  float q[D], g[D], o[D];
  float lse;
};

template <int D>
__device__ __forceinline__ void fetch(Fetched<D>& x, const Args& a, int h, long long n) {
  const long long N = (long long)a.T * a.m;
  const long long at = (long long)h * D * N + n;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    x.q[d] = a.q[at + d * N];
    x.g[d] = a.g[at + d * N];
    x.o[d] = a.out[at + d * N];
  }
  x.lse = a.stats[(long long)h * 2 * N + n];
}

// The tile of block-loop index id: head h, frame tile i, slot block c.
struct TileAt {
  int h, i, c, f0, j0, nf, mb;
  __device__ TileAt(const Args& a, int id) {
    const Plan& p = a.p;
    c = id % p.nc;
    i = id / p.nc % p.n_tiles;
    h = id / (p.nc * p.n_tiles);
    f0 = i * p.F;
    j0 = c * p.MB;
    nf = min(p.F, a.T - f0);
    mb = min(p.MB, a.m - j0);
  }
};

// A chunk's K/V rows, frames f0-W+1+w0 .. f0+w0+KC-W (zero outside
// [0, T)), into dst[0][KC][D] and dst[1][KC][D] by 4-byte cp.async, one
// commit group.
template <int D>
__device__ __forceinline__ void stage_kv(float* dst, const Args& a, const TileAt& t, int w0,
                                         int KC) {
  const float* kh = a.k + (long long)t.h * D * a.T;
  const float* vh = a.v + (long long)t.h * D * a.T;
  for (int idx = threadIdx.x; idx < KC * D; idx += kThreads) {
    const int d = idx % D;
    const int f = t.f0 - (a.W - 1) + w0 + idx / D;
    const bool in = f >= 0 && f < a.T;
    const long long at = in ? (long long)d * a.T + f : 0;
    cp_async4(dst + idx, kh + at, in ? 4 : 0);
    cp_async4(dst + KC * D + idx, vh + at, in ? 4 : 0);
  }
  swa::cp_async_commit();
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 8 ? 2 : 1) swa_packed_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const Plan& p = a.p;
  const int T = a.T, m = a.m, W = a.W;
  const int F = p.F, MB = p.MB, S = p.S, WC = p.WC, KR = p.KR, KC = p.KC, DP = p.DP,
            WP = p.WP;
  const int QT = F * MB;
  float* kv = smem;                         // [2][2][KC][D]: (buffer, k|v, key row r)
                                            // row r: frame f0-W+1+w0+r
  float* qs = kv + 4 * KC * D;              // [QT][DP]  q^ of query (frame lt, slot jl)
  float* gs = qs + QT * DP;                 // [QT][DP]  g
  float2* ls = reinterpret_cast<float2*>(gs + QT * DP);   // [QT] (lse, delta)
  float* band = gs + QT * DP + round4(2 * QT);             // [QT][WP] ds
  float* P = band + QT * WP;                // [F][S][2D][WC] dk, dv partials
  const long long N = (long long)T * m;
  const float scale = 1.f / sqrtf((float)D);
  const int tiles = a.H * p.n_tiles * p.nc;

  // the first query of each thread comes in through registers, fetched
  // while the previous tile computes
  Fetched<D> next;
  if ((int)blockIdx.x < tiles) {
    const TileAt t(a, blockIdx.x);
    stage_kv<D>(kv, a, t, 0, KC);
    if (threadIdx.x < t.nf * t.mb)
      fetch<D>(next, a, t.h, (long long)(t.f0 + threadIdx.x / t.mb) * m + t.j0 +
                                 threadIdx.x % t.mb);
  }
  int buf = 0;
  for (int id = blockIdx.x; id < tiles; id += gridDim.x) {
    const TileAt t(a, id);
    const int f0 = t.f0, j0 = t.j0, nf = t.nf, mb = t.mb, h = t.h;
    for (int r = threadIdx.x; r < nf * mb; r += kThreads) {
      const int lt = r / mb, jl = r % mb;
      Fetched<D> x;
      if (r == threadIdx.x) x = next;
      else fetch<D>(x, a, h, (long long)(f0 + lt) * m + j0 + jl);
      float qv[D], dl = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        qv[d] = x.q[d] * scale;
        dl = fmaf(x.o[d], x.g[d], dl);
      }
      const int nl = lt * MB + jl;
      store_row<D>(qs + nl * DP, qv);
      store_row<D>(gs + nl * DP, x.g);
      ls[nl] = make_float2(x.lse, dl);
    }
    // window chunks w0 = 0, WC, ..; one chunk (w0 = 0, wc = W) unless W * D
    // is large
    for (int w0 = 0; w0 < W; w0 += WC, buf ^= 1) {
      const int wc = min(WC, W - w0);
      const float* ks = kv + buf * 2 * KC * D;
      const float* vs = ks + KC * D;
      swa::cp_async_wait_all();   // this chunk's K/V rows
      __syncthreads();

      // the next chunk's K/V rows (the next tile's, with its first query a
      // thread) in flight while this one computes (the other K/V buffer was
      // last read before the barrier that ended the previous chunk)
      if (w0 + WC < W) {
        stage_kv<D>(kv + (buf ^ 1) * 2 * KC * D, a, t, w0 + WC, KC);
      } else if (id + (int)gridDim.x < tiles) {
        const TileAt u(a, id + gridDim.x);
        stage_kv<D>(kv + (buf ^ 1) * 2 * KC * D, a, u, 0, KC);
        if (threadIdx.x < u.nf * u.mb)
          fetch<D>(next, a, u.h, (long long)(u.f0 + threadIdx.x / u.mb) * m + u.j0 +
                                     threadIdx.x % u.mb);
      }
      // phase 1: item (frame lt, slot group sg, window position w0 + w), w
      // fastest; its key is row lt + w of the chunk
      for (int it = threadIdx.x; it < nf * S * wc; it += kThreads) {
        const int w = it % wc;
        const int sg = it / wc % S;
        const int lt = it / (wc * S);
        float kr[D], vr[D], dka[D], dva[D];
        load_row<D>(kr, ks + (lt + w) * D);
        load_row<D>(vr, vs + (lt + w) * D);
#pragma unroll
        for (int d = 0; d < D; ++d) dka[d] = dva[d] = 0.f;
#pragma unroll 4
        for (int jl = sg; jl < mb; jl += S) {
          const int nl = lt * MB + jl;
          float qv[D], gv[D];
          load_row<D>(qv, qs + nl * DP);
          load_row<D>(gv, gs + nl * DP);
          const float2 st = ls[nl];
          float s = 0.f, da = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            s = fmaf(qv[d], kr[d], s);
            da = fmaf(gv[d], vr[d], da);
          }
          const float av = expf(s - st.x);
          const float ds = av * (da - st.y);
          band[nl * WP + w] = ds;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            dka[d] = fmaf(ds, qv[d], dka[d]);
            dva[d] = fmaf(av, gv[d], dva[d]);
          }
        }
        float* pp = P + (lt * S + sg) * 2 * D * WC + w;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          pp[d * WC] = dka[d];
          pp[(D + d) * WC] = dva[d];
        }
      }
      __syncthreads();

      // phase 2a: dq, one thread per query, from the band and the key rows
      // (two accumulators: even and odd window positions); a later chunk
      // adds to what the chunk before wrote (the same thread, the same query)
      float* dqh = a.dq + (long long)h * D * N;
      for (int r = threadIdx.x; r < nf * mb; r += kThreads) {
        const int lt = r / mb, jl = r % mb;
        const float* br = band + (lt * MB + jl) * WP;
        float acc0[D], acc1[D];
#pragma unroll
        for (int d = 0; d < D; ++d) acc0[d] = acc1[d] = 0.f;
        int w = 0;
        for (; w + 4 <= wc; w += 4) {
          const float4 b = *reinterpret_cast<const float4*>(br + w);
          float k0[D], k1[D], k2[D], k3[D];
          load_row<D>(k0, ks + (lt + w) * D);
          load_row<D>(k1, ks + (lt + w + 1) * D);
          load_row<D>(k2, ks + (lt + w + 2) * D);
          load_row<D>(k3, ks + (lt + w + 3) * D);
#pragma unroll
          for (int d = 0; d < D; ++d) {
            acc0[d] = fmaf(b.x, k0[d], acc0[d]);
            acc1[d] = fmaf(b.y, k1[d], acc1[d]);
            acc0[d] = fmaf(b.z, k2[d], acc0[d]);
            acc1[d] = fmaf(b.w, k3[d], acc1[d]);
          }
        }
        for (; w < wc; ++w) {
          float kw[D];
          load_row<D>(kw, ks + (lt + w) * D);
#pragma unroll
          for (int d = 0; d < D; ++d) acc0[d] = fmaf(br[w], kw[d], acc0[d]);
        }
        float* dqn = dqh + (long long)(f0 + lt) * m + j0 + jl;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float x = (acc0[d] + acc1[d]) * scale;
          dqn[(long long)d * N] = w0 == 0 ? x : dqn[(long long)d * N] + x;
        }
      }
      // phase 2b: the chunk's dk, dv partial of each of its key rows into
      // the tile's scratch slot [tile id][2D][KR]
      swa::sum_chunk_partials<D, kThreads>(P, a.scratch + (long long)id * 2 * D * KR, F, S,
                                           WC, wc, nf, KR, w0);
      __syncthreads();   // the next chunk's staging overwrites shared memory
    }
  }

  cg::this_grid().sync();
  swa::sum_tile_partials<D, kThreads, false>(a.scratch, a.dk, a.dv, a.H, T, W, F, p.nc,
                                             p.n_tiles, KR);
}

template <int D>
cudaError_t launch(const Args& args, cudaStream_t stream) {
  static int attribute_set[kMaxDevices] = {0};
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!attribute_set[dev]) {
    err = cudaFuncSetAttribute(swa_packed_bwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    attribute_set[dev] = 1;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, swa_packed_bwd_kernel<D>,
                                                      kThreads, args.p.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (long long)args.H * args.p.n_tiles * args.p.nc;
  const long long resident = (long long)per_sm * sms[dev];
  const int grid = (int)(tiles < resident ? tiles : resident);
  void* params[] = {const_cast<Args*>(&args)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(swa_packed_bwd_kernel<D>),
                                    dim3(grid), dim3(kThreads), params, args.p.smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The scratch the launch for these shapes needs, in floats, into *floats.
// Returns a cudaError_t code: cudaErrorInvalidValue where no tiling fits.
extern "C" int swa_packed_bwd_scratch(int H, int D, int T, int m, int W, long long* floats) {
  Plan p;
  if ((D != 2 && D != 4 && D != 8 && D != 16 && D != 32) || !plan(H, D, T, m, W, &p))
    return cudaErrorInvalidValue;
  *floats = p.scratch;
  return cudaSuccess;
}

// Returns a cudaError_t code: 0 when the launch was accepted. One launch;
// scratch holds at least swa_packed_bwd_scratch's floats.
extern "C" int swa_packed_bwd(const float* q, const float* k, const float* v,
                              const float* g, const float* out, const float* stats,
                              float* dq, float* dk, float* dv, float* scratch, int H,
                              int D, int T, int m, int W, void* stream) {
  Args args{q, k, v, g, out, stats, dq, dk, dv, scratch, H, T, m, W, {}};
  if (!plan(H, D, T, m, W, &args.p)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 2: return launch<2>(args, s);
    case 4: return launch<4>(args, s);
    case 8: return launch<8>(args, s);
    case 16: return launch<16>(args, s);
    case 32: return launch<32>(args, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* swa_packed_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
