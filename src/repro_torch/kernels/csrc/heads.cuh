// Shared device code of the surrogate-head kernels (mlp_heads.cu and
// network_tick.cu): the canonical head stack, staging heads into shared
// memory in a padded layout, and evaluating one head on a tile of rows as
// (rows x units) products spread over a block's threads.
//
// A stack holds P heads, each as the reference's canonical arrays
// (tick_megakernel._canonical / Surrogate stacked MLP heads):
// x_mu, x_sd (P, F); y_mu, y_sd, b2, scale (P, 1); w0 (P, F, H1);
// b0 (P, H1); w1 (P, H1, H2); b1 (P, H2); w2 (P, H2, 1). A kernel stages
// the first FS <= F feature columns of the heads it reads (a circuit kind
// in a cross-kind pack evaluates only its own columns; the rest are the
// pack's zero padding).
//
// Numerics: every output of a layer is one index-order chain of
// __fmaf_rn from 0 over its inputs, then + bias and relu; the output layer
// chains its units the same way, then + b2, * y_sd + y_mu, / scale. The
// sources are built with --fmad=false, so nothing else is contracted, and
// the outputs do not depend on how the rows and units are spread over
// threads, on the row tile, or on how the weights are sliced.

#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

namespace repro {

constexpr int kMaxSmem = 232448; // dynamic shared memory a block may use

enum Family { kMean = 0, kLinear = 1, kMlp = 2 };

struct Stack {
  const float* x_mu;
  const float* x_sd;
  const float* y_mu;
  const float* y_sd;
  const float* w0;
  const float* b0;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  const float* scale;  // null: every head's scale is 1
                       // x_mu, x_sd, y_mu, y_sd null: the identity
                       // standardizer (means 0, deviations 1)
  int p, f, h1, h2;    // heads and widths as the arrays hold them
  int fs;              // feature columns staged and evaluated (<= f)
};

__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }

// A stack's heads staged for the row-tiled products: head j at j * per
// floats, every part on a 16-byte boundary, w0 and w1 rows padded to h1p
// and h2p columns (the padding is never read into a stored output).
struct Pad {
  int fs, h1, h2, h1p, h2p;
  int x_sd, w0, b0, w1, b1, w2, tail, per;   // offsets in floats; x_mu at 0
};

__host__ __device__ inline Pad make_pad(int fs, int h1, int h2) {
  Pad p;
  p.fs = fs;
  p.h1 = h1;
  p.h2 = h2;
  p.h1p = up4(h1);
  p.h2p = up4(h2);
  p.x_sd = up4(fs);
  p.w0 = p.x_sd + up4(fs);
  p.b0 = p.w0 + fs * p.h1p;
  p.w1 = p.b0 + p.h1p;
  p.b1 = p.w1 + h1 * p.h2p;
  p.w2 = p.b1 + p.h2p;
  p.tail = p.w2 + p.h2p;
  p.per = p.tail + 4;
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// W floats (4 W bytes, both addresses aligned to that) into shared memory
template <int W = 1>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "n"(4 * W) : "memory");
}

// copy `count` floats into `dst`, or fill with `value` where src is null
__device__ inline void stage_part(float* dst, const float* src, int count,
                                  float value) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    if (src) cp_async(dst + i, src + i);
    else dst[i] = value;
  }
}

// an (rows, cols) row-major block into rows padded to `ld` columns, a
// warp per row, W floats a copy
template <int W>
__device__ inline void stage_rows_w(float* dst, const float* src, int rows,
                                    int cols, int ld) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += warps)
    for (int c = W * lane; c < cols; c += 32 * W)
      cp_async<W>(dst + r * ld + c, src + r * cols + c);
}

// stage_rows_w with the widest copy (16, 8 or 4 bytes) that the source's
// alignment and both row strides allow (dst is 16-byte aligned)
__device__ inline void stage_rows(float* dst, const float* src, int rows,
                                  int cols, int ld) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  if (a % 16 == 0 && cols % 4 == 0 && ld % 4 == 0)
    stage_rows_w<4>(dst, src, rows, cols, ld);
  else if (a % 8 == 0 && cols % 2 == 0 && ld % 2 == 0)
    stage_rows_w<2>(dst, src, rows, cols, ld);
  else
    stage_rows_w<1>(dst, src, rows, cols, ld);
}

// head h's y_mu, y_sd, b2 and scale into tail[0..4)
__device__ inline void stage_tail(const Stack& s, int h, float* tail) {
  if (threadIdx.x == 0) {
    tail[0] = s.y_mu ? s.y_mu[h] : 0.0f;
    tail[1] = s.y_sd ? s.y_sd[h] : 1.0f;
    tail[2] = s.b2[h];
    tail[3] = s.scale ? s.scale[h] : 1.0f;
  }
}

// Heads h0 .. h0+count-1 of s at width pd.fs into smem (Pad layout);
// the whole block calls it, then waits with stage_wait().
__device__ inline void stage_padded(const Stack& s, int h0, int count,
                                    const Pad& pd, float* smem) {
  for (int j = 0; j < count; ++j) {
    const int h = h0 + j;
    float* d = smem + j * pd.per;
    stage_part(d, s.x_mu ? s.x_mu + h * s.f : nullptr, pd.fs, 0.0f);
    stage_part(d + pd.x_sd, s.x_sd ? s.x_sd + h * s.f : nullptr, pd.fs, 1.0f);
    stage_rows(d + pd.w0, s.w0 + h * s.f * s.h1, pd.fs, s.h1, pd.h1p);
    stage_part(d + pd.b0, s.b0 + h * s.h1, s.h1, 0.0f);
    stage_rows(d + pd.w1, s.w1 + h * s.h1 * s.h2, s.h1, s.h2, pd.h2p);
    stage_part(d + pd.b1, s.b1 + h * s.h2, s.h2, 0.0f);
    stage_part(d + pd.w2, s.w2 + h * s.h2, s.h2, 0.0f);
    stage_tail(s, h, d + pd.tail);
  }
}

__device__ inline void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// out[u][r] = relu(sum_k a[k][r] w[k][u] + b[u]) for r < n_rows, u < n_u:
// each sum in index order from 0 by __fmaf_rn. A thread holds an RM x 4
// block of outputs (rows x units); a is [k][stride], w is [k][ld], out is
// [u][stride]. SLICED: the k range is one slice of a longer sum; unless
// `first`, each chain goes on from the partial sum the previous slice left
// in out, and unless `last`, the partial sum is stored without bias and
// relu (an fp32 store and load are exact, so the chain is unchanged).
template <int LDC, int RM, bool SLICED = false>
__device__ inline void dense_relu_rm(const float* a, const float* w,
                                     const float* b, int n_k, int n_u, int ld,
                                     int stride, int n_rows, float* out,
                                     bool first = true, bool last = true) {
  if (LDC) stride = LDC;
  const int nrg = (n_rows + RM - 1) / RM, nug = (n_u + 3) >> 2;
  for (int m = threadIdx.x; m < nrg * nug; m += blockDim.x) {
    const int rg = m % nrg, ug = m / nrg;
    const float* ap = a + RM * rg;
    const float* wp = w + 4 * ug;
    float acc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    if constexpr (SLICED) {
      if (!first) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = 4 * ug + j;
          if (u >= n_u) break;
#pragma unroll
          for (int i = 0; i < RM; ++i)
            acc[i][j] = out[u * stride + RM * rg + i];
        }
      }
    }
#pragma unroll 4
    for (int k = 0; k < n_k; ++k) {
      float ar[RM];
      if constexpr (RM == 4) {
        const float4 av = *reinterpret_cast<const float4*>(ap + k * stride);
        ar[0] = av.x;
        ar[1] = av.y;
        ar[2] = av.z;
        ar[3] = av.w;
      } else {
        const float2 av = *reinterpret_cast<const float2*>(ap + k * stride);
        ar[0] = av.x;
        ar[1] = av.y;
      }
      const float4 wv = *reinterpret_cast<const float4*>(wp + k * ld);
      const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fmaf_rn(ar[i], wr[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = 4 * ug + j;
      if (u >= n_u) break;
      const float bu = (!SLICED || last) ? b[u] : 0.0f;
      float* dst = out + u * stride + RM * rg;
#pragma unroll
      for (int i = 0; i < RM; ++i)
        if (RM * rg + i < n_rows) {
          if (!SLICED || last) dst[i] = fmaxf(acc[i][j] + bu, 0.0f);
          else dst[i] = acc[i][j];
        }
    }
  }
}

// dense_relu_rm with 2 rows a thread where that keeps all the blocks of
// outputs in one pass of the block's threads, else 4
template <int LDC, bool SLICED = false>
__device__ inline void dense_relu(const float* a, const float* w,
                                  const float* b, int n_k, int n_u, int ld,
                                  int stride, int n_rows, float* out,
                                  bool first = true, bool last = true) {
  const int nug = (n_u + 3) >> 2;
  if (((n_rows + 1) >> 1) * nug <= static_cast<int>(blockDim.x))
    dense_relu_rm<LDC, 2, SLICED>(a, w, b, n_k, n_u, ld, stride, n_rows, out,
                                  first, last);
  else
    dense_relu_rm<LDC, 4, SLICED>(a, w, b, n_k, n_u, ld, stride, n_rows, out,
                                  first, last);
}

// A tile's work area, as the head functions read it (W: any struct with
// these members): ld, the stride of xs and hid (rows per tile it holds, a
// multiple of 4); xs, standardized features (then the second hidden
// layer) as [k][ld]; hid, the first hidden layer as [unit][ld]; feat, the
// listed rows' feature rows as [column][ld + 1]; list, the tile rows the
// n slots stand for.

// standardize the n listed rows' first f feature columns into wk.xs, a
// warp per column; the caller syncs
template <int LDC, class W>
__device__ inline void tile_standardize(const float* mu, const float* sd,
                                        int f, int n, const W& wk) {
  const int tid = threadIdx.x, ld = LDC ? LDC : wk.ld;
  for (int k = tid >> 5; k < f; k += blockDim.x >> 5) {
    const float m = mu[k], s = sd[k];
    for (int slot = tid & 31; slot < n; slot += 32)
      wk.xs[k * ld + slot] = (wk.feat[k * (ld + 1) + slot] - m) / s;
  }
}

// the output layer of slot tid (< n) from the second hidden layer in
// wk.xs, destandardized: ((sum_u h[u] w2[u]) + b2) * y_sd + y_mu) / scale
template <int LDC, class W>
__device__ __forceinline__ float tile_out(const float* w2, int h2,
                                          const float* tail, const W& wk) {
  const int tid = threadIdx.x, ld = LDC ? LDC : wk.ld;
  float y = 0.0f;
#pragma unroll 8
  for (int u = 0; u < h2; ++u) y = __fmaf_rn(wk.xs[u * ld + tid], w2[u], y);
  y = y + tail[2];
  return (y * tail[1] + tail[0]) / tail[3];
}

// One staged head (at hb) on the n listed rows' feature rows in wk.feat,
// f columns: dest[list[slot]] = (y * y_sd + y_mu) / scale, y at the head's
// family cost (a mean head is b2, a linear head one dot). The whole block
// calls it; it ends with a barrier.
template <int LDC, class W>
__device__ void tile_head(const float* hb, const Pad& pd, int fam, int f,
                          int n, const W& wk, float* dest) {
  const int tid = threadIdx.x, ld = LDC ? LDC : wk.ld;
  const float* tail = hb + pd.tail;
  if (fam == kMean) {
    if (tid < n) dest[wk.list[tid]] = (tail[2] * tail[1] + tail[0]) / tail[3];
    __syncthreads();
    return;
  }
  tile_standardize<LDC>(hb, hb + pd.x_sd, f, n, wk);
  __syncthreads();
  if (fam == kLinear) {
    if (tid < n) {
      float y = 0.0f;
#pragma unroll 8
      for (int k = 0; k < f; ++k)
        y = __fmaf_rn(wk.xs[k * ld + tid], hb[pd.w0 + k * pd.h1p], y);
      y = y + tail[2];
      dest[wk.list[tid]] = (y * tail[1] + tail[0]) / tail[3];
    }
    __syncthreads();
    return;
  }
  dense_relu<LDC>(wk.xs, hb + pd.w0, hb + pd.b0, f, pd.h1, pd.h1p, ld, n,
                  wk.hid);
  __syncthreads();
  // the second hidden layer overwrites the standardized features
  dense_relu<LDC>(wk.hid, hb + pd.w1, hb + pd.b1, pd.h1, pd.h2, pd.h2p, ld,
                  n, wk.xs);
  __syncthreads();
  if (tid < n) dest[wk.list[tid]] = tile_out<LDC>(hb + pd.w2, pd.h2, tail, wk);
  __syncthreads();
}

// One wave of a persistent kernel: the shared-memory limit and the grid's
// size (resident blocks per SM times SMs), queried when the bytes or the
// device change (the host enqueues these kernels every tick, and the
// occupancy query is slow). A launcher keeps one Wave per kernel.
struct Wave {
  size_t bytes = 0;
  int device = -1, blocks = 0;
};

template <class K>
cudaError_t wave(K kernel, int threads, size_t bytes, int device, Wave& w) {
  if (bytes == w.bytes && device == w.device) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, bytes);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  w.blocks = (per_sm > 1 ? per_sm : 1) * sms;
  w.bytes = bytes;
  w.device = device;
  return cudaSuccess;
}

// rows per tile: the fewest (a multiple of 4, at most cap) that let one
// wave of `blocks` cover all n rows, but at least min_rows where the cap
// allows, so that a small N does not make every SM stage its heads for a
// few rows
__host__ inline int tile_rows(int n, int blocks, int cap, int min_rows) {
  const int per_block = up4((n + blocks - 1) / blocks);
  const int rows = per_block < min_rows ? min_rows : per_block;
  return rows < cap ? rows : cap;
}

}  // namespace repro

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
