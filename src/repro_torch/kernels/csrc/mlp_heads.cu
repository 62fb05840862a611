// P stacked 3-layer MLP surrogate heads over N feature rows -> (P, N),
// and the single unstandardized head (N, F) -> (N,).
//
// Replaces: src/repro/kernels/mlp_surrogate.py:mlp_surrogate_heads (the
// pallas_call with every head's weights VMEM-resident), reached through
// Surrogate.predict_heads -> _predict_mlp_stacked; and
// mlp_surrogate.py:mlp_surrogate (one head, no standardizers), which is
// the same kernel at P = 1 with the identity standardizer (null pointers
// in the Stack: x - 0, / 1, * 1 + 0, / 1, each exact in fp32).
//
// Bound on the H100: operations. On the LIF path (F = 10 or 12, H1 = 100,
// H2 = 50, P <= 3) a row costs ~6,250 multiply-adds per head against
// ~50 bytes of input and 4 bytes of output per head; on the crossbar path
// (F = 68 or 70) ~12,000 against ~280 bytes. Both sit far right of the
// fp32 ridge point.
//
// Design: network_tick's row tiles without the tick. A persistent grid of
// 512-thread blocks, one wave of them; each block stages as many heads as
// fit beside a row tile of at least kMinRows rows (all P at the main
// path's widths: ~53 KB for two F = 12 heads, ~100 KB for two F = 70
// heads) with cp.async into heads.cuh's padded layout, then walks row
// tiles sized at launch from the shared memory the heads leave (at most
// 128 rows). Per tile it loads the x rows coalesced into shared memory as
// [column][row], and per head runs heads.cuh:tile_head: standardize a
// warp per column, the two hidden layers as (rows x units) products from
// shared memory, 2 or 4 rows x 4 units a thread, the output layer and
// the destandardizer one row per thread, stored along the row so that
// (P, N) is written coalesced. Where not all P heads fit, the block stages
// a group of them, walks its tiles, and stages the next group. Where not
// even one head fits (its w0 or w1 is larger than shared memory beside a
// tile), the block stages the head's vectors once and, per tile, its w0
// and w1 in slices of rows: each product goes on from the partial sums
// the previous slice left in shared memory, so every output is still one
// index-order chain. The one limit left is a 4-row tile of activations
// beside the head's vectors and one row of each matrix: H1 up to ~9,600
// at H2 = 50, H1 = H2 up to ~4,800, F up to ~5,200 at MLP(100, 50).
//
// Numerics: every sum is the index-order __fmaf_rn chain from 0 (see
// heads.cuh), built with --fmad=false, so the outputs equal the first
// design's (one thread per row, the hidden layer in local memory) bit for
// bit, at any P, width, tile and slice. fp32 on the CUDA cores: tensor
// cores would need TF32.

#include "heads.cuh"

namespace {

using repro::Pad;

constexpr int kThreads = 512;
constexpr int kMinRows = 32;    // rows per tile a grouped launch keeps
constexpr int kMaxRows = 128;   // rows per tile at the most

// A tile's work area at stride ld (see heads.cuh): xs [max(F, H2)][ld],
// hid [H1][ld], feat [F][ld + 1] (the x rows), list [ld] (the identity).
struct HeadsWork {
  int ld;
  float *xs, *hid, *feat;
  int* list;
};

__host__ __device__ inline int work_floats(int ld, int f, int h1, int h2) {
  return ld * ((f > h2 ? f : h2) + h1) + f * (ld + 1) + ld;
}

__device__ inline HeadsWork carve(float* w, int ld, int f, int h1, int h2) {
  HeadsWork k;
  k.ld = ld;
  k.xs = w;
  w += ld * (f > h2 ? f : h2);
  k.hid = w;
  w += ld * h1;
  k.feat = w;
  w += f * (ld + 1);
  k.list = reinterpret_cast<int*>(w);
  return k;
}

// A head's vectors without its matrices (the sliced layout): x_mu, x_sd,
// b0, b1, w2 and the tail, at Pad's offsets with w0 and w1 of no rows
__host__ __device__ inline Pad make_vectors(int f, int h1, int h2) {
  Pad p = repro::make_pad(f, h1, h2);
  p.b0 = p.w0;
  p.w1 = p.b0 + p.h1p;
  p.b1 = p.w1;
  p.w2 = p.b1 + p.h2p;
  p.tail = p.w2 + p.h2p;
  p.per = p.tail + 4;
  return p;
}

// Shared memory of a launch, in floats: the stage, then the work area.
struct HeadsPlan {
  int group;    // heads staged at once; 0: one head, matrices in slices
  int stage;    // floats of the stage (the work area's offset)
  int cap;      // rows per tile the work area holds (a multiple of 4), its
                // stride; 0: refused
  int k0, k1;   // sliced: rows of w0 / w1 a slice holds
  int total;    // floats in all
};

// The most heads (at most p) that fit beside kMinRows rows, and the most
// rows beside them; else one head's vectors, its matrices in slices, and
// the most rows whose work area takes at most half the room (at least 4).
__host__ inline HeadsPlan plan(int p, int f, int h1, int h2) {
  const Pad pd = repro::make_pad(f, h1, h2);
  const int room = repro::kMaxSmem / 4;
  HeadsPlan pl{};
  int g = p;
  while (g > 0 && g * pd.per + work_floats(kMinRows, f, h1, h2) > room) --g;
  if (g > 0) {
    pl.group = g;
    pl.stage = g * pd.per;
    pl.cap = kMaxRows;
    while (pl.stage + work_floats(pl.cap, f, h1, h2) > room) pl.cap -= 4;
  } else {
    const int vec = make_vectors(f, h1, h2).per;
    pl.cap = kMaxRows;
    while (pl.cap > 4 && vec + work_floats(pl.cap, f, h1, h2) > room / 2)
      pl.cap -= 4;
    const int left = room - vec - work_floats(pl.cap, f, h1, h2);
    pl.k0 = left / pd.h1p < f ? left / pd.h1p : f;
    pl.k1 = left / pd.h2p < h1 ? left / pd.h2p : h1;
    if (pl.k0 < 1 || pl.k1 < 1) pl.cap = 0;
    const int w0 = pl.k0 * pd.h1p, w1 = pl.k1 * pd.h2p;
    pl.stage = vec + (w0 > w1 ? w0 : w1);
  }
  pl.total = pl.stage + work_floats(pl.cap > 0 ? pl.cap : 4, f, h1, h2);
  return pl;
}

// head h's vectors at width pv.fs into smem (make_vectors layout)
__device__ inline void stage_vectors(const repro::Stack& s, int h,
                                     const Pad& pv, float* smem) {
  repro::stage_part(smem, s.x_mu ? s.x_mu + h * s.f : nullptr, pv.fs, 0.0f);
  repro::stage_part(smem + pv.x_sd, s.x_sd ? s.x_sd + h * s.f : nullptr,
                    pv.fs, 1.0f);
  repro::stage_part(smem + pv.b0, s.b0 + h * s.h1, s.h1, 0.0f);
  repro::stage_part(smem + pv.b1, s.b1 + h * s.h2, s.h2, 0.0f);
  repro::stage_part(smem + pv.w2, s.w2 + h * s.h2, s.h2, 0.0f);
  repro::stage_tail(s, h, smem + pv.tail);
}

// the n rows from r0 into wk.feat as [column][ld + 1], read coalesced
__device__ inline void load_rows(const float* __restrict__ x, int f, int r0,
                                 int n, const HeadsWork& wk) {
  const float* src = x + static_cast<size_t>(r0) * f;
  for (int i = threadIdx.x; i < n * f; i += blockDim.x) {
    const int row = i / f;
    wk.feat[(i - row * f) * (wk.ld + 1) + row] = src[i];
  }
}

// tile_head for a head whose matrices are staged slice by slice: its
// vectors at vec (make_vectors layout), each slice through wbuf. The whole
// block calls it; it ends with a barrier.
template <int LDC>
__device__ void tile_head_sliced(const repro::Stack& s, int h,
                                 const float* vec, const Pad& pv,
                                 const Pad& pd, const HeadsPlan& pl,
                                 float* wbuf, int n, const HeadsWork& wk,
                                 float* dest) {
  const int ld = LDC ? LDC : wk.ld;
  repro::tile_standardize<LDC>(vec, vec + pv.x_sd, s.f, n, wk);
  for (int k0 = 0; k0 < s.f; k0 += pl.k0) {
    const int kk = pl.k0 < s.f - k0 ? pl.k0 : s.f - k0;
    __syncthreads();              // the previous slice's reads are done
    repro::stage_rows(wbuf, s.w0 + (static_cast<size_t>(h) * s.f + k0) * s.h1,
                      kk, s.h1, pd.h1p);
    repro::stage_wait();
    repro::dense_relu<LDC, true>(wk.xs + k0 * ld, wbuf, vec + pv.b0, kk,
                                 s.h1, pd.h1p, ld, n, wk.hid, k0 == 0,
                                 k0 + kk == s.f);
  }
  // the second hidden layer overwrites the standardized features
  for (int j0 = 0; j0 < s.h1; j0 += pl.k1) {
    const int kk = pl.k1 < s.h1 - j0 ? pl.k1 : s.h1 - j0;
    __syncthreads();
    repro::stage_rows(wbuf,
                      s.w1 + (static_cast<size_t>(h) * s.h1 + j0) * s.h2, kk,
                      s.h2, pd.h2p);
    repro::stage_wait();
    repro::dense_relu<LDC, true>(wk.hid + j0 * ld, wbuf, vec + pv.b1, kk,
                                 s.h2, pd.h2p, ld, n, wk.xs, j0 == 0,
                                 j0 + kk == s.h1);
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < n)
    dest[wk.list[threadIdx.x]] =
        repro::tile_out<LDC>(vec + pv.w2, s.h2, vec + pv.tail, wk);
  __syncthreads();
}

template <int LDC>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_heads_tiled(const float* __restrict__ x, repro::Stack s,
                    float* __restrict__ out, int n, HeadsPlan pl, int rows) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Pad pd = repro::make_pad(s.f, s.h1, s.h2);
  const Pad pv = make_vectors(s.f, s.h1, s.h2);
  const HeadsWork wk = carve(smem + pl.stage, LDC ? LDC : pl.cap, s.f, s.h1,
                             s.h2);
  for (int i = threadIdx.x; i < wk.ld; i += blockDim.x) wk.list[i] = i;
  const int tiles = (n + rows - 1) / rows;
  const int group = pl.group > 0 ? pl.group : 1;
  for (int h0 = 0; h0 < s.p; h0 += group) {
    const int count = group < s.p - h0 ? group : s.p - h0;
    __syncthreads();              // every read of the last group is done
    if (pl.group > 0) repro::stage_padded(s, h0, count, pd, smem);
    else stage_vectors(s, h0, pv, smem);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int r0 = tile * rows;
      const int m = rows < n - r0 ? rows : n - r0;
      load_rows(x, s.f, r0, m, wk);
      repro::stage_wait();        // the stage (first tile) and the rows
      for (int j = 0; j < count; ++j) {
        float* dest = out + static_cast<size_t>(h0 + j) * n + r0;
        if (pl.group > 0)
          repro::tile_head<LDC>(smem + j * pd.per, pd, repro::kMlp, s.f, m,
                                wk, dest);
        else
          tile_head_sliced<LDC>(s, h0 + j, smem, pv, pd, pl, smem + pv.per, m,
                                wk, dest);
      }
    }
  }
}

template <int LDC>
cudaError_t launch_tiled(const float* x, const repro::Stack& s, float* out,
                         int n, const HeadsPlan& pl, int device,
                         cudaStream_t stream) {
  const size_t bytes = sizeof(float) * pl.total;
  static repro::Wave w;
  cudaError_t err =
      repro::wave(mlp_heads_tiled<LDC>, kThreads, bytes, device, w);
  if (err != cudaSuccess) return err;
  const int rows = repro::tile_rows(n, w.blocks, pl.cap, kMinRows);
  const int tiles = (n + rows - 1) / rows;
  mlp_heads_tiled<LDC><<<tiles < w.blocks ? tiles : w.blocks, kThreads,
                         bytes, stream>>>(x, s, out, n, pl, rows);
  return cudaGetLastError();
}

// the stride compiled in where the main path's heads leave room for
// kMaxRows rows (LIF and crossbar rows at MLP(100, 50)); other widths
// take it at run time
cudaError_t launch(const float* x, const repro::Stack& s, float* out, int n,
                   int device, cudaStream_t stream) {
  const HeadsPlan pl = plan(s.p, s.f, s.h1, s.h2);
  if (pl.cap == 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (pl.cap == kMaxRows)
    return launch_tiled<kMaxRows>(x, s, out, n, pl, device, stream);
  return launch_tiled<0>(x, s, out, n, pl, device, stream);
}

}  // namespace

extern "C" int mlp_heads_launch(const float* x, const float* const* arrays,
                                float* out, int n, int p, int f, int h1,
                                int h2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const repro::Stack s{arrays[0], arrays[1], arrays[2], arrays[3], arrays[4],
                       arrays[5], arrays[6], arrays[7], arrays[8], arrays[9],
                       nullptr, p, f, h1, h2, f};
  return launch(x, s, out, n, device, static_cast<cudaStream_t>(stream));
}

extern "C" int mlp_surrogate_launch(const float* x, const float* const* arrays,
                                    float* out, int n, int f, int h1, int h2,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // arrays: w1 (F, H1), b1 (H1), w2 (H1, H2), b2 (H2), w3 (H2, 1), b3 (1)
  const repro::Stack s{nullptr, nullptr, nullptr, nullptr, arrays[0],
                       arrays[1], arrays[2], arrays[3], arrays[4], arrays[5],
                       nullptr, 1, f, h1, h2, f};
  return launch(x, s, out, n, device, static_cast<cudaStream_t>(stream));
}

// The launch layout of P heads at (F, H1, H2): plan[0..5) = heads staged
// at once (0: one head, its matrices in slices), rows per tile at the
// most (0: refused), rows of w0 and of w1 a slice holds, bytes of shared
// memory a block takes.
extern "C" void mlp_heads_plan(int p, int f, int h1, int h2, int* out) {
  const HeadsPlan pl = plan(p, f, h1, h2);
  out[0] = pl.group;
  out[1] = pl.cap;
  out[2] = pl.k0;
  out[3] = pl.k1;
  out[4] = static_cast<int>(sizeof(float) * pl.total);
}
