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
// writes dq (12*D bytes) against 10*D flops and an exp a (query, key) pair;
// at COG's D=8, W=30 that is ~210 flop/byte, far above the fp32 ridge of
// ~20 (67 TFLOP/s over 3.35 TB/s).
//
// Design: the score and g.v of each (query, key) pair are computed once
// wherever the window fits a tile, and nothing is summed with atomics. One
// cooperative launch; each block walks tiles (head, F frames, MB query
// slots of each frame) in a grid-stride loop:
// - staging: the tile's q and g (F*MB*D floats, contiguous where MB = M)
//   and its F+W-1 K/V rows with the zero halo come by cp.async, 16 bytes
//   where every pointer is 16-byte aligned and 4 bytes where one is not
//   (the instance the C entry picks and reports), into the second of two
//   buffers while the tile before computes;
// - phase 0: G lanes of one warp a query (G a power of two that fills the
//   block; COG: 2), each taking window positions h, h+G, ..: pass 1 writes
//   the scores s and da = g.v into two shared bands, the lanes' max
//   combined by shuffles; pass 2 turns s into exp(s - max), one exp a
//   pair, and sums it and its product with da; pass 3 writes a and ds into
//   the bands and sums dq = sum ds k (D FMAs a pair), the lanes' sums
//   combined in a fixed order by shuffles. Passes 2 and 3 read a batch of
//   positions before they write any (a store to a band holds back the
//   loads after it); pass 1 takes one position at a time, which keeps its
//   registers under the cap. A band's row stride is an odd multiple of G,
//   so the warp's lanes fall in distinct banks;
// - phase 1: threads (frame, slot group, window position) walk the frame's
//   slots of their group, keep their key's dk += ds q and dv += a g in
//   registers (2D FMAs a pair) and write them to shared partials P;
// - phase 2: each of the tile's key rows sums P over the slot groups and
//   frames in a fixed order into the tile's slot of a scratch buffer that
//   the wrapper allocates;
// - after one grid barrier, each tile sums its own keys' slots over the
//   tiles that touch them, in tile order (swa_common.cuh, as K3).
// So a pair costs 5D FMAs and one exp. Every phase waits on latency, so
// D <= 8 runs three blocks (24 warps) an SM at 80 registers a thread: a
// tile holds F = 16, 8, .. frames where that fits three blocks an SM (COG:
// 8 frames, 66 KB), then two, then one; fewer slots a tile (large m) where
// even one frame does not. Where no tiling holds the whole window (W * D
// large), the window goes in chunks of WC positions: a first walk over the
// chunks keeps an online (max, sum, sum a da) a lane, merged across the
// lanes and the chunks into per-query statistics; a second walk computes
// each pair again from them (7D FMAs and two exp a pair), adding each
// chunk's dq and the partials of the F-1 key rows two chunks share to what
// the chunk before wrote. The order of every sum is fixed by the shapes, so
// runs give the same bits on any grid. Scores are kept in base 2 (q^ scaled
// by log2(e)) and exponentiated by exp2f, which is accurate (not the fast
// intrinsic) and shorter than expf: parity with the reference holds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include <algorithm>
#include <initializer_list>

#include "swa_common.cuh"

namespace cg = cooperative_groups;

namespace {

using swa::load_row;
using swa::store_row;

constexpr int kThreads = 256;
constexpr int kMaxDevices = 16;
constexpr size_t kThreeBlocks = 74 * 1024;    // three blocks an SM
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
  int nchunks;  // ceil(W / WC)
  int G;        // phase-0 lanes a query, a power of two
  int KR;       // key rows a tile touches: F + W - 1
  int KC;       // key rows a chunk stages: F + WC - 1
  int n_tiles;  // frame tiles: ceil(T / F)
  int WP;       // row stride of the bands (floats): an odd multiple of G
  size_t smem;
  long long scratch;   // floats
};

// G: phase-0 lanes a query, a power of two up to 32 that fills the block
// with the tile's queries, each lane with a window position
int lanes(int QT, int WC) {
  int G = 1;
  while (G < 32 && 2 * G * QT <= kThreads && 2 * G <= WC) G *= 2;
  return G;
}

// An odd multiple of G, at least WC: the lanes of a warp's queries then
// fall in distinct banks
int band_stride(int WC, int G) {
  int n = (WC + G - 1) / G;
  if (n % 2 == 0) ++n;
  return n * G;
}

size_t smem_floats(int D, int WC, int F, int MB, int S, int WP) {
  const int QT = F * MB;
  return 4 * (size_t)(F + WC - 1) * D          // k, v rows, two buffers
         + 4 * (size_t)QT * D                  // q, g, two buffers
         + 4 * (size_t)QT                      // per-query statistics (chunked windows)
         + 2 * (size_t)QT * WP                 // the two bands
         + (size_t)F * S * 2 * D * WC;         // P
}

bool fits(int H, int D, int T, int m, int W, int WC, int F, int nc, size_t budget,
          Plan* p) {
  const int MB = (m + nc - 1) / nc;
  // phase-1 items of one slot group: F * WC; as many groups as fit in one
  // round of the block's threads
  const int S = std::max(1, std::min(MB, kThreads / (F * WC)));
  const int G = lanes(F * MB, WC);
  const int WP = band_stride(WC, G);
  const size_t bytes = smem_floats(D, WC, F, MB, S, WP) * sizeof(float);
  if (bytes > budget) return false;
  p->F = F;
  p->MB = MB;
  p->nc = (m + MB - 1) / MB;
  p->S = S;
  p->WC = WC;
  p->nchunks = (W + WC - 1) / WC;
  p->G = G;
  p->KR = F + W - 1;
  p->KC = F + WC - 1;
  p->n_tiles = (T + F - 1) / F;
  p->WP = WP;
  p->smem = bytes;
  p->scratch = (long long)H * p->n_tiles * p->nc * 2 * D * p->KR;
  return true;
}

// The whole window first: F = 16, 8, .. 1 frames of all m slots, then one
// frame of m/2, m/4, .. slots, within three blocks an SM (D <= 8, whose
// registers allow three), then two, then one. Where none fits, the same
// order of (F, slots), each with the largest of WC = W/2, W/4, .. 1 that
// fits. One frame, one slot and WC = 1 always fit.
bool plan(int H, int D, int T, int m, int W, Plan* p) {
  if (H < 1 || T < 1 || m < 1 || W < 1) return false;
  // tiles and owners are counted in 32-bit integers
  if ((long long)H * T * m >= INT_MAX) return false;
  const size_t most = D <= 8 ? kThreeBlocks : kTwoBlocks;
  for (int chunked = 0; chunked < 2; ++chunked) {
    for (size_t budget : {most, kTwoBlocks, kMaxSmem}) {
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
  float* dq;
  float* dk;
  float* dv;
  float* scratch;
  int H, T, m, W;
  Plan p;
};

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

// A chunk's K/V rows, frames f0-W+1+w0 .. f0+w0+KC-W (zero outside [0, T)),
// into dst[0][KC][D] and dst[1][KC][D]. The rows lie back to back in device
// memory.
template <int D, bool V>
__device__ __forceinline__ void stage_kv(float* dst, const Args& a, const TileAt& t, int w0,
                                         int KC) {
  const float* kh = a.k + (long long)t.h * a.T * D;
  const float* vh = a.v + (long long)t.h * a.T * D;
  const int first = t.f0 - (a.W - 1) + w0;
  for (int u = threadIdx.x; u < KC * (D / 4); u += kThreads) {
    const int f = first + u / (D / 4);
    const bool in = f >= 0 && f < a.T;
    const long long at = in ? (long long)f * D + 4 * (u % (D / 4)) : 0;
    swa::copy4<V>(dst + 4 * u, kh + at, in);
    swa::copy4<V>(dst + KC * D + 4 * u, vh + at, in);
  }
}

// The tile's q and g rows: query (lt, jl) into row lt*MB + jl of dst[0] and
// dst[1] ([QT][D] each).
template <int D, bool V>
__device__ __forceinline__ void stage_qg(float* dst, const Args& a, const TileAt& t, int MB,
                                         int QT) {
  const long long base = (((long long)t.h * a.T + t.f0) * a.m + t.j0) * D;
  for (int u = threadIdx.x; u < t.nf * t.mb * (D / 4); u += kThreads) {
    const int r = u / (D / 4), c = u % (D / 4);
    const int lt = r / t.mb, jl = r % t.mb;
    const long long at = base + ((long long)lt * a.m + jl) * D + 4 * c;
    float* to = dst + (lt * MB + jl) * D + 4 * c;
    swa::copy4<V>(to, a.q + at, true);
    swa::copy4<V>(to + QT * D, a.g + at, true);
  }
}

// the G lanes of a query (consecutive lanes of one warp) combine their values
__device__ __forceinline__ float group_max(float x, int G) {
  for (int o = 1; o < G; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x, int G) {
  for (int o = 1; o < G; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// (mx, sum, pd) merged with (m2, s2, p2): sums of 2^(s - mx) and of
// 2^(s - mx) * da over two sets of base-2 scores; an empty set has mx = -inf
__device__ __forceinline__ void merge_stats(float& mx, float& sum, float& pd, float m2,
                                            float s2, float p2) {
  const float nm = fmaxf(mx, m2);
  const float c1 = mx == -INFINITY ? 0.f : exp2f(mx - nm);
  const float c2 = m2 == -INFINITY ? 0.f : exp2f(m2 - nm);
  sum = sum * c1 + s2 * c2;
  pd = pd * c1 + p2 * c2;
  mx = nm;
}

template <int D>
__device__ __forceinline__ float dot(const float (&x)[D], const float (&y)[D]) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s = fmaf(x[d], y[d], s);
  return s;
}

template <int D, bool V>
__global__ void __launch_bounds__(kThreads, D <= 8 ? 3 : 1)
swa_headmajor_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const Plan& p = a.p;
  const int T = a.T, m = a.m, W = a.W;
  const int F = p.F, MB = p.MB, S = p.S, WC = p.WC, G = p.G, KR = p.KR, KC = p.KC,
            WP = p.WP, nchunks = p.nchunks;
  const int QT = F * MB;
  float* kv = smem;                         // [2][2][KC][D]: (buffer, k|v, key row r)
                                            // row r: frame f0-W+1+w0+r
  float* qg = kv + 4 * KC * D;              // [2][2][QT][D]: (buffer, q|g, query)
  float4* st = reinterpret_cast<float4*>(qg + 4 * QT * D);   // [QT] chunked statistics
  float* b1 = qg + 4 * QT * D + 4 * QT;     // [QT][WP]: s, then 2^(s - max), then a
  float* b2 = b1 + QT * WP;                 // [QT][WP]: da, then ds
  float* P = b2 + QT * WP;                  // [F][S][2D][WC] dk, dv partials
  const float scale = 1.f / sqrtf((float)D);
  // phase 0 keeps its scores in base 2: s log2(e), whose exp2 is exp(s)
  const float scale_log2e = scale * 1.4426950408889634f;
  const int tiles = a.H * p.n_tiles * p.nc;
  const bool chunked = nchunks > 1;
  const int steps = chunked ? 2 * nchunks : 1;   // chunked: statistics, then gradients

  if ((int)blockIdx.x < tiles) {
    const TileAt t0(a, blockIdx.x);
    stage_kv<D, V>(kv, a, t0, 0, KC);
    stage_qg<D, V>(qg, a, t0, MB, QT);
    swa::cp_async_commit();
  }
  int kb = 0, qb = 0;
  for (int id = blockIdx.x; id < tiles; id += gridDim.x, qb ^= 1) {
    const TileAt t(a, id);
    const int nf = t.nf, mb = t.mb, nq = t.nf * t.mb;
    const float* qs = qg + qb * 2 * QT * D;
    const float* gs = qs + QT * D;
    for (int s = 0; s < steps; ++s, kb ^= 1) {
      const int w0 = s % nchunks * WC, wc = min(WC, W - w0);
      const bool stats_pass = chunked && s < nchunks;
      const float* ks = kv + kb * 2 * KC * D;
      const float* vs = ks + KC * D;
      swa::cp_async_wait_all();   // this step's rows
      __syncthreads();

      // the next step's K/V rows (and the next tile's q, g) in flight while
      // this one computes: the other buffers were last read before the
      // barrier above
      if (s + 1 < steps) {
        stage_kv<D, V>(kv + (kb ^ 1) * 2 * KC * D, a, t, (s + 1) % nchunks * WC, KC);
        swa::cp_async_commit();
      } else if (id + (int)gridDim.x < tiles) {
        const TileAt u(a, id + gridDim.x);
        stage_kv<D, V>(kv + (kb ^ 1) * 2 * KC * D, a, u, 0, KC);
        stage_qg<D, V>(qg + (qb ^ 1) * 2 * QT * D, a, u, MB, QT);
        swa::cp_async_commit();
      }

      // phase 0: lane h of G takes window positions h, h+G, ..; every lane
      // of a warp runs every round, so the shuffles see the whole group.
      // Passes 2 and 3 read a batch of positions before they write any (a
      // store to a band would hold back the loads after it); pass 1 takes
      // one at a time, which keeps its registers from spilling
      for (int base = 0; base < nq * G; base += kThreads) {
        const int item = base + threadIdx.x;
        const int r = item / G, h = item % G;
        const bool live = r < nq;
        const int lt = live ? r / mb : 0, jl = live ? r % mb : 0;
        const int nl = lt * MB + jl;
        float qv[D], gv[D];
        if (live) {
          load_row<D>(qv, qs + nl * D);
          load_row<D>(gv, gs + nl * D);
#pragma unroll
          for (int d = 0; d < D; ++d) qv[d] *= scale_log2e;
        }
        float* r1 = b1 + nl * WP;
        float* r2 = b2 + nl * WP;
        float mx = -INFINITY, sum = 0.f, pd = 0.f;
        if (stats_pass) {
          // the chunk's online (max, sum, sum of p da), merged over the
          // lanes and with the chunks before; the last chunk leaves (max,
          // 1/sum, delta)
          if (live) {
            for (int w = h; w < wc; w += G) {
              float kr[D], vr[D];
              load_row<D>(kr, ks + (lt + w) * D);
              load_row<D>(vr, vs + (lt + w) * D);
              const float x = dot<D>(qv, kr), da = dot<D>(gv, vr);
              if (x > mx) {
                const float c = exp2f(mx - x);
                sum = fmaf(sum, c, 1.f);
                pd = fmaf(pd, c, da);
                mx = x;
              } else {
                const float e = exp2f(x - mx);
                sum += e;
                pd = fmaf(e, da, pd);
              }
            }
          }
          for (int o = 1; o < G; o <<= 1) {
            const float m2 = __shfl_xor_sync(0xffffffffu, mx, o);
            const float s2 = __shfl_xor_sync(0xffffffffu, sum, o);
            const float p2 = __shfl_xor_sync(0xffffffffu, pd, o);
            merge_stats(mx, sum, pd, m2, s2, p2);
          }
          if (live && h == 0) {
            if (w0 > 0) {
              const float4 o = st[nl];
              merge_stats(mx, sum, pd, o.x, o.y, o.z);
            }
            st[nl] = w0 + wc < W ? make_float4(mx, sum, pd, 0.f)
                                 : make_float4(mx, 1.f / sum, pd / sum, 0.f);
          }
          continue;
        }
        float rs, delta;
        if (chunked) {
          const float4 o = st[nl];
          mx = o.x, rs = o.y, delta = o.z;
        }
        // pass 1 (the whole window): s and da into the bands; chunked: the
        // statistics are known, and s, da become a, ds at once
        if (live) {
          for (int w = h; w < wc; w += G) {
            float kr[D], vr[D];
            load_row<D>(kr, ks + (lt + w) * D);
            load_row<D>(vr, vs + (lt + w) * D);
            float x = dot<D>(qv, kr), y = dot<D>(gv, vr);
            if (chunked) {
              x = exp2f(x - mx) * rs;
              y = x * (y - delta);
            } else {
              mx = fmaxf(mx, x);
            }
            r1[w] = x;
            r2[w] = y;
          }
        }
        if (!chunked) {
          // pass 2: 2^(s - max), the lanes' max; its sum and sum with da
          mx = group_max(mx, G);
          if (live) {
            for (int w = h; w < wc; w += 4 * G) {
              float x[4], y[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const bool in = w + u * G < wc;
                x[u] = in ? r1[w + u * G] : 0.f;
                y[u] = in ? r2[w + u * G] : 0.f;
              }
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                if (w + u * G >= wc) break;
                const float e = exp2f(x[u] - mx);
                r1[w + u * G] = e;
                sum += e;
                pd = fmaf(e, y[u], pd);
              }
            }
          }
          sum = group_sum(sum, G);
          rs = 1.f / sum;
          delta = group_sum(pd, G) * rs;
        }
        // pass 3: a and ds into the bands (the whole window), dq = sum ds k
        float acc[D];
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = 0.f;
        if (live) {
          for (int w = h; w < wc; w += 2 * G) {
            const int w2 = w + G;
            const bool two = w2 < wc;
            float k0[D], k1[D];
            load_row<D>(k0, ks + (lt + w) * D);
            float x0 = r1[w], y0 = r2[w], x1 = 0.f, y1 = 0.f;
            if (two) {
              load_row<D>(k1, ks + (lt + w2) * D);
              x1 = r1[w2];
              y1 = r2[w2];
            }
            if (!chunked) {   // y: da -> ds
              x0 *= rs;
              y0 = x0 * (y0 - delta);
              r1[w] = x0;
              r2[w] = y0;
              if (two) {
                x1 *= rs;
                y1 = x1 * (y1 - delta);
                r1[w2] = x1;
                r2[w2] = y1;
              }
            }
#pragma unroll
            for (int d = 0; d < D; ++d) acc[d] = fmaf(y0, k0[d], acc[d]);
            if (two) {
#pragma unroll
              for (int d = 0; d < D; ++d) acc[d] = fmaf(y1, k1[d], acc[d]);
            }
          }
        }
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = group_sum(acc[d], G) * scale;
        if (live && h == 0) {
          // a later chunk adds to what the chunk before wrote (the same
          // thread, the same query)
          float* dqn = a.dq + (((long long)t.h * T + t.f0 + lt) * m + t.j0 + jl) * D;
          if (w0 > 0) {
            float old[D];
            load_row<D, V>(old, dqn);
#pragma unroll
            for (int d = 0; d < D; ++d) acc[d] += old[d];
          }
          store_row<D, V>(dqn, acc);
        }
      }
      if (stats_pass) continue;
      __syncthreads();

      // phase 1: item (frame lt, slot group sg, window position w), w
      // fastest; its key is row lt + w of the chunk
      for (int it = threadIdx.x; it < nf * S * wc; it += kThreads) {
        const int w = it % wc;
        const int sg = it / wc % S;
        const int lt = it / (wc * S);
        float dka[D], dva[D];
#pragma unroll
        for (int d = 0; d < D; ++d) dka[d] = dva[d] = 0.f;
#pragma unroll 2
        for (int jl = sg; jl < mb; jl += S) {
          const int nl = lt * MB + jl;
          float qv[D], gv[D];
          load_row<D>(qv, qs + nl * D);
          load_row<D>(gv, gs + nl * D);
          const float av = b1[nl * WP + w], ds = b2[nl * WP + w];
#pragma unroll
          for (int d = 0; d < D; ++d) {
            dka[d] = fmaf(ds, qv[d], dka[d]);
            dva[d] = fmaf(av, gv[d], dva[d]);
          }
        }
        float* pp = P + (lt * S + sg) * 2 * D * WC + w;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          pp[d * WC] = dka[d] * scale;
          pp[(D + d) * WC] = dva[d];
        }
      }
      __syncthreads();

      // phase 2: each key row's partial into the tile's scratch slot
      swa::sum_chunk_partials<D, kThreads>(P, a.scratch + (long long)id * 2 * D * KR, F, S,
                                           WC, wc, nf, KR, w0);
    }
  }

  cg::this_grid().sync();
  swa::sum_tile_partials<D, kThreads, true>(a.scratch, a.dk, a.dv, a.H, T, W, F, p.nc,
                                            p.n_tiles, KR);
}

template <int D, bool V>
cudaError_t launch(const Args& args, cudaStream_t stream) {
  static int attribute_set[kMaxDevices] = {0};
  static int sms[kMaxDevices] = {0};
  auto kernel = swa_headmajor_bwd_kernel<D, V>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!attribute_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    attribute_set[dev] = 1;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      args.p.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (long long)args.H * args.p.n_tiles * args.p.nc;
  const long long resident = (long long)per_sm * sms[dev];
  const int grid = (int)(tiles < resident ? tiles : resident);
  void* params[] = {const_cast<Args*>(&args)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kThreads), params, args.p.smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& args, bool vec, cudaStream_t stream) {
  return vec ? launch<D, true>(args, stream) : launch<D, false>(args, stream);
}

}  // namespace

// The scratch the launch for these shapes needs, in floats, into *floats.
// Returns a cudaError_t code: cudaErrorInvalidValue where no tiling fits.
extern "C" int swa_headmajor_bwd_scratch(int H, int D, int T, int m, int W,
                                         long long* floats) {
  Plan p;
  if ((D != 4 && D != 8 && D != 16 && D != 32) || !plan(H, D, T, m, W, &p))
    return cudaErrorInvalidValue;
  *floats = p.scratch;
  return cudaSuccess;
}

// Returns a cudaError_t code: 0 when the launch was accepted. One launch;
// scratch holds at least swa_headmajor_bwd_scratch's floats. *instance
// receives the copies the launch makes: 0 for 16 bytes (every pointer
// 16-byte aligned), 1 for 4 bytes.
extern "C" int swa_headmajor_bwd(const float* q, const float* k, const float* v,
                                 const float* g, float* dq, float* dk, float* dv,
                                 float* scratch, int H, int D, int T, int m, int W,
                                 int* instance, void* stream) {
  Args args{q, k, v, g, dq, dk, dv, scratch, H, T, m, W, {}};
  if (!plan(H, D, T, m, W, &args.p)) return cudaErrorInvalidValue;
  const bool vec = swa::aligned16(q) && swa::aligned16(k) && swa::aligned16(v) &&
                   swa::aligned16(g) && swa::aligned16(dq);
  *instance = vec ? 0 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 4: return launch<4>(args, vec, s);
    case 8: return launch<8>(args, vec, s);
    case 16: return launch<16>(args, vec, s);
    case 32: return launch<32>(args, vec, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* swa_headmajor_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
