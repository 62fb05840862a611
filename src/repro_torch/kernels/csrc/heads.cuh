// Shared device code of the surrogate-head kernels (mlp_heads.cu and
// network_tick.cu): the canonical head layout, staging heads of a stack
// into shared memory, and evaluating one head for one row in a thread.
//
// A stack holds P heads, each as the reference's canonical arrays
// (tick_megakernel._canonical / Surrogate stacked MLP heads):
// x_mu, x_sd (P, F); y_mu, y_sd, b2, scale (P, 1); w0 (P, F, H1);
// b0 (P, H1); w1 (P, H1, H2); b1 (P, H2); w2 (P, H2, 1). A kernel stages
// the first FS <= F feature columns of the heads it reads (a circuit kind
// in a cross-kind pack evaluates only its own columns; the rest are the
// pack's zero padding), and staged, head h occupies head_floats(FS, H1,
// H2) contiguous floats of shared memory:
//   x_mu[FS] x_sd[FS] w0[FS*H1] b0[H1] w1[H1*H2] b1[H2] w2[H2]
//   y_mu y_sd b2 scale
// unpadded: no dimension is rounded up to a tile or lane width.
//
// A thread keeps one row's features in an array of KF floats, a template
// parameter: 16 for the LIF rows (10 or 12 columns, kept in registers),
// 72 for the crossbar rows (68 or 70 columns, which spill to local
// memory).

#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kNarrowF = 16;     // LIF feature rows
constexpr int kWideF = 72;       // crossbar feature rows
constexpr int kMaxH1 = 128;      // first hidden layer a thread keeps (local)
constexpr int kTileH2 = 8;       // second-layer units accumulated at once
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

struct Head {
  const float* x_mu;
  const float* x_sd;
  const float* w0;
  const float* b0;
  const float* w1;
  const float* b1;
  const float* w2;
  float y_mu, y_sd, b2, scale;
};

__host__ __device__ inline int head_floats(int f, int h1, int h2) {
  return 2 * f + f * h1 + h1 + h1 * h2 + 2 * h2 + 4;
}

__device__ inline void copy_block(float* dst, const float* src, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

// copy_block, or fill with `value` where the source is null
__device__ inline void fill_block(float* dst, const float* src, int count,
                                  float value) {
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    dst[i] = src ? src[i] : value;
}

// Stage heads h0 .. h0+count-1 of s into smem at width s.fs; the whole
// block calls it, then syncs. w0's first fs rows are its first fs*h1
// floats, so every part is one contiguous copy.
__device__ inline void stage(const Stack& s, int h0, int count, float* smem) {
  const int per = head_floats(s.fs, s.h1, s.h2);
  for (int j = 0; j < count; ++j) {
    const int h = h0 + j;
    float* d = smem + j * per;
    fill_block(d, s.x_mu ? s.x_mu + h * s.f : nullptr, s.fs, 0.0f);
    d += s.fs;
    fill_block(d, s.x_sd ? s.x_sd + h * s.f : nullptr, s.fs, 1.0f);
    d += s.fs;
    copy_block(d, s.w0 + h * s.f * s.h1, s.fs * s.h1);
    d += s.fs * s.h1;
    copy_block(d, s.b0 + h * s.h1, s.h1);
    d += s.h1;
    copy_block(d, s.w1 + h * s.h1 * s.h2, s.h1 * s.h2);
    d += s.h1 * s.h2;
    copy_block(d, s.b1 + h * s.h2, s.h2);
    d += s.h2;
    copy_block(d, s.w2 + h * s.h2, s.h2);
    d += s.h2;
    if (threadIdx.x == 0) {
      d[0] = s.y_mu ? s.y_mu[h] : 0.0f;
      d[1] = s.y_sd ? s.y_sd[h] : 1.0f;
      d[2] = s.b2[h];
      d[3] = s.scale ? s.scale[h] : 1.0f;
    }
  }
}

// The j-th staged head (0-based within what stage() copied).
__device__ inline Head head_at(const float* smem, const Stack& s, int j) {
  const float* b = smem + j * head_floats(s.fs, s.h1, s.h2);
  Head hd;
  hd.x_mu = b;
  hd.x_sd = b + s.fs;
  hd.w0 = b + 2 * s.fs;
  hd.b0 = hd.w0 + s.fs * s.h1;
  hd.w1 = hd.b0 + s.h1;
  hd.b1 = hd.w1 + s.h1 * s.h2;
  hd.w2 = hd.b1 + s.h2;
  const float* tail = hd.w2 + s.h2;
  hd.y_mu = tail[0];
  hd.y_sd = tail[1];
  hd.b2 = tail[2];
  hd.scale = tail[3];
  return hd;
}

// (feat - x_mu) / x_sd over the first f columns, zero beyond
template <int KF>
__device__ __forceinline__ void standardize(const Head& hd,
                                            const float (&feat)[KF], int f,
                                            float (&xs)[KF]) {
#pragma unroll
  for (int k = 0; k < KF; ++k)
    xs[k] = k < f ? (feat[k] - hd.x_mu[k]) / hd.x_sd[k] : 0.0f;
}

// xs @ w0[:, 0] + b2: a linear head, summed in index order
template <int KF>
__device__ __forceinline__ float linear(const Head& hd, const float (&xs)[KF],
                                        int f, int h1) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < KF; ++k)
    if (k < f) acc = __fmaf_rn(xs[k], hd.w0[k * h1], acc);
  return acc + hd.b2;
}

// relu(relu(xs @ w0 + b0) @ w1 + b1) @ w2 + b2, in standardized units.
// Each dot product sums its terms in index order with one fused
// multiply-add per term; the first hidden layer lives in local memory,
// the second is accumulated kTileH2 units at a time in registers.
template <int KF>
__device__ __forceinline__ float mlp3(const Head& hd, const float (&xs)[KF],
                                      int f, int h1, int h2) {
  float hid[kMaxH1];
  for (int j = 0; j < h1; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < KF; ++k)
      if (k < f) acc = __fmaf_rn(xs[k], hd.w0[k * h1 + j], acc);
    hid[j] = fmaxf(acc + hd.b0[j], 0.0f);
  }
  float y = 0.0f;
  for (int k0 = 0; k0 < h2; k0 += kTileH2) {
    float acc[kTileH2];
#pragma unroll
    for (int q = 0; q < kTileH2; ++q) acc[q] = 0.0f;
    for (int j = 0; j < h1; ++j) {
      const float hj = hid[j];
      const float* row = hd.w1 + j * h2 + k0;
#pragma unroll
      for (int q = 0; q < kTileH2; ++q)
        if (k0 + q < h2) acc[q] = __fmaf_rn(hj, row[q], acc[q]);
    }
#pragma unroll
    for (int q = 0; q < kTileH2; ++q)
      if (k0 + q < h2)
        y = __fmaf_rn(fmaxf(acc[q] + hd.b1[k0 + q], 0.0f), hd.w2[k0 + q], y);
  }
  return y + hd.b2;
}

}  // namespace repro

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
