// Device code shared by the four banded-attention kernels: the packed
// forward and backward (swa_packed_fwd.cu K1, swa_packed_bwd.cu K3) and the
// head-major ones (swa_headmajor_fwd.cu K8, swa_headmajor_bwd.cu K9).
//
// - copies from device to shared memory by cp.async, 4 or 16 bytes, zero
//   where the source lies outside the sequence;
// - rows of D floats between registers and shared memory as float4, or
//   float2 at D = 2;
// - the forward's pass over a query's W keys, a chunk of kChunk scores in
//   registers with an online max and sum (K1, K8);
// - the backward's two fixed-order sums of per-tile dk/dv partials: a
//   window chunk's partials of a tile into its scratch rows, and after the
//   grid barrier each key's rows over the tiles that touch it (K3, K9).
// expf, not __expf, keeps the parity with the reference.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace swa {

constexpr int kChunk = 16;   // keys whose scores a forward thread holds at once

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared; src_bytes 0 writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 16 bytes global -> shared (both 16-byte aligned); src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four consecutive floats global -> shared: one 16-byte copy where V (the
// caller checked the pointers' alignment), else four 4-byte ones. Where
// !in, zeros, and src is only a valid address.
template <bool V>
__device__ __forceinline__ void copy4(float* dst, const float* src, bool in) {
  if (V) {
    cp_async16(dst, src, in ? 16 : 0);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) cp_async4(dst + i, in ? src + i : src, in ? 4 : 0);
  }
}

// A row of D floats between registers and shared memory: float4 accesses
// where V and D is a multiple of 4 (such rows are 16-byte aligned), float2
// where V and D = 2 (8-byte rows, 8-byte aligned), else one float at a time.
// A width that is neither (D = 1, 3, 5, ..) must take V = false: D / 4
// would be 0 (or leave floats out) on the vector paths.
template <int D, bool V>
__device__ __forceinline__ void check_row_width() {
  static_assert(!V || D % 4 == 0 || D == 2,
                "vector row access takes D a multiple of 4, or D = 2");
}

template <int D, bool V = true>
__device__ __forceinline__ void load_row(float (&x)[D], const float* src) {
  check_row_width<D, V>();
  if constexpr (V && D % 4 == 0) {
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      const float4 t = reinterpret_cast<const float4*>(src)[c];
      x[4 * c] = t.x;
      x[4 * c + 1] = t.y;
      x[4 * c + 2] = t.z;
      x[4 * c + 3] = t.w;
    }
  } else if constexpr (V && D == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    x[0] = t.x;
    x[1] = t.y;
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = src[d];
  }
}

template <int D, bool V = true>
__device__ __forceinline__ void store_row(float* dst, const float (&x)[D]) {
  check_row_width<D, V>();
  if constexpr (V && D % 4 == 0) {
#pragma unroll
    for (int c = 0; c < D / 4; ++c)
      reinterpret_cast<float4*>(dst)[c] =
          make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
  } else if constexpr (V && D == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) dst[d] = x[d];
  }
}

// The forward's pass over the W keys of R query slots of one frame: key w
// is row lt + w of ks and vs (rows are staged up to W rounded up to whole
// chunks). qr holds q^ = q / sqrt(D). Returns each slot's max score mx,
// softmax sum and sum of exp(s - mx) * v, each score computed once: kChunk
// scores in registers, their max, one expf a score, and an online rescale
// between chunks.
template <int D, int R>
__device__ __forceinline__ void band_attend(const float (&qr)[R][D], const float* ks,
                                            const float* vs, int lt, int W, float (&mx)[R],
                                            float (&sum)[R], float (&acc)[R][D]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mx[r] = -INFINITY;
    sum[r] = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[r][d] = 0.f;
  }
  for (int c0 = 0; c0 < W; c0 += kChunk) {
    float s[R][kChunk];
#pragma unroll
    for (int w = 0; w < kChunk; ++w) {
      float kv[D];
      load_row<D>(kv, ks + (lt + c0 + w) * D);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float x = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) x = fmaf(qr[r][d], kv[d], x);
        s[r][w] = c0 + w < W ? x : -INFINITY;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float cm = s[r][0];
#pragma unroll
      for (int w = 1; w < kChunk; ++w) cm = fmaxf(cm, s[r][w]);
      const float nm = fmaxf(mx[r], cm);
      if (c0 > 0) {   // rescale what the earlier chunks summed
        const float alpha = expf(mx[r] - nm);
        sum[r] *= alpha;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[r][d] *= alpha;
      }
      mx[r] = nm;
    }
#pragma unroll
    for (int w = 0; w < kChunk; ++w) {
      float vv[D];
      load_row<D>(vv, vs + (lt + c0 + w) * D);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float e = expf(s[r][w] - mx[r]);
        sum[r] += e;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[r][d] = fmaf(e, vv[d], acc[r][d]);
      }
    }
  }
}

// A backward tile's dk, dv partial of each key row r of a window chunk
// (tile row w0 + r), slot groups then frames in order, into the tile's
// scratch rows sc[2D][KR]. P[lt][sg][e][r - lt] lies at lt * step +
// (sg * 2D + e) * WC + r: every thread walks all the tile's frames, so a
// warp reads consecutive words at each step, and drops the terms outside
// its band (the words it reads there lie inside P, and a select discards
// them). The first F-1 rows of a later chunk are the last of the chunk
// before, and add to what it wrote.
template <int D, int kThreads>
__device__ __forceinline__ void sum_chunk_partials(const float* P, float* sc, int F, int S,
                                                   int WC, int wc, int nf, int KR, int w0) {
  const int rows = F + wc - 1;
  const int step = S * 2 * D * WC - 1;
  for (int it = threadIdx.x; it < 2 * D * rows; it += kThreads) {
    const int r = it % rows, e = it / rows;
    float sum = 0.f;
    for (int sg = 0; sg < S; ++sg) {
      const float* pp = P + (sg * 2 * D + e) * WC + r;
#pragma unroll 4
      for (int lt = 0; lt < nf; ++lt) {
        const float x = pp[lt * step];
        sum += (unsigned)(r - lt) < (unsigned)wc ? x : 0.f;
      }
    }
    float* dst = sc + e * KR + w0 + r;
    *dst = w0 > 0 && r < F - 1 ? *dst + sum : sum;
  }
}

// After the grid barrier: dk, dv of every key, the sum of its rows in the
// scratch of the tiles that touch it (scratch [head][tile][slot block][2D]
// [KR]; key f of tile i + k sits at row f - (i+k)*F + W - 1), in tile order
// and slot blocks in order, so runs give the same bits on any grid. Tile
// (h, i) owns keys i*F .. i*F+F-1, 2D*F outputs; a block takes as many
// owners at once as fill its threads (B), and a thread one output of four
// owners at a time, issuing the loads of up to four tiles each before it
// adds any. dk/dv are (H, D, T) where !HeadMajor, (H, T, D) where HeadMajor.
template <int D, int kThreads, bool HeadMajor>
__device__ __forceinline__ void sum_tile_partials(const float* scratch, float* dk, float* dv,
                                                  int H, int T, int W, int F, int nc,
                                                  int n_tiles, int KR) {
  const int owners = H * n_tiles;
  const int outputs = 2 * D * F;
  const int B = max(1, kThreads / outputs);        // owners a block takes at once
  const int sub = threadIdx.x / outputs;
  if (sub >= B) return;
  const int step = B * gridDim.x;                   // owner o -> the u-th next
  const long long tile_step = (long long)nc * 2 * D * KR - F;   // tile i+k -> i+k+1
  const long long slot_step = (long long)2 * D * KR;            // slot block c -> c+1
  for (int o0 = blockIdx.x * B + sub; o0 < owners; o0 += 4 * step) {
    for (int r = threadIdx.x % outputs; r < outputs; r += kThreads) {
      const int e = r / F, kf = r % F;
      float v[4][4];
      int n[4];
      const float* src[4];
      float* dst[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        n[u] = 0;
        dst[u] = nullptr;
        src[u] = scratch;
        const int o = o0 + u * step;
        if (o >= owners) continue;
        const int h = o / n_tiles, i = o % n_tiles;
        const int f = i * F + kf;
        if (f >= T) continue;
        n[u] = min(n_tiles - 1, (f + W - 1) / F) - i + 1;
        src[u] += ((long long)(h * n_tiles + i) * nc * 2 * D + e) * KR + kf + W - 1;
        const long long at = HeadMajor ? ((long long)h * T + f) * D + e % D
                                       : (long long)(h * D + e % D) * T + f;
        dst[u] = (e < D ? dk : dv) + at;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[u][k] = k < n[u] ? __ldcg(src[u] + k * tile_step) : 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (dst[u] == nullptr) continue;
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k >= n[u]) break;
          float part = v[u][k];
          for (int c = 1; c < nc; ++c) part += __ldcg(src[u] + k * tile_step + c * slot_step);
          sum += part;
        }
        for (int k = 4; k < n[u]; ++k) {
          float part = 0.f;
          for (int c = 0; c < nc; ++c) part += __ldcg(src[u] + k * tile_step + c * slot_step);
          sum += part;
        }
        *dst[u] = sum;
      }
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace swa
