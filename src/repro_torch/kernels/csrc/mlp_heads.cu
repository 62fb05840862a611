// P stacked 3-layer MLP surrogate heads over N feature rows -> (P, N),
// and the single unstandardized head (N, F) -> (N,).
//
// Replaces: src/repro/kernels/mlp_surrogate.py:mlp_surrogate_heads (the
// pallas_call with every head's weights VMEM-resident), reached through
// Surrogate.predict_heads -> _predict_mlp_stacked; and
// mlp_surrogate.py:mlp_surrogate (one head, no standardizers), a kernel of
// its own (mlp_single, below) where the head fits beside a tile, else the
// heads' kernel at P = 1 with the identity standardizer (null pointers in
// the Stack: x - 0, / 1, * 1 + 0, / 1, each exact in fp32).
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
//
// The single head (mlp_single): the same row tiles without the
// standardizer and with the first layer started early. At (12,800, 41) a
// 512-thread block a SM takes a 100-row tile; measured on an H100 80GB
// HBM3 (700 W, kernel_sweep.py's probes), an empty launch of it is ~5.1
// us, staging the head and reading the rows ~2.9 us, and the two
// products ~4.2 and ~5.6 us, so the products are what the design works
// on:
// - the head is staged in two cp.async groups (w0, b0; then w1, b1, w2,
//   b2), and layer 1 starts once the first has landed;
// - the rows go straight into the first layer's operand (no standardize
//   pass), fp32 or bf16 read as they are and converted in the kernel
//   (exactly), 16 loads a thread in flight, with no division per element;
// - each product gives a thread 4 rows x 8 units and reads k + 1's
//   operands before k's multiply-adds (dense_tile): 0.01818 ms against
//   0.0192 for heads.cuh's 2 or 4 x 4 and 0.01904 unpipelined, where
//   8 x 8 leaves too few warps (0.02074);
// - two 256-thread blocks a SM were slower (0.02269 against 0.01946 in
//   an earlier build). The earlier design took 0.02157 ms (fp32) and,
//   with the wrapper's cast of bf16 rows, 0.02592.
// Its outputs are (sum + b2) + 0: the first design's (y * 1 + 0) / 1, of
// which only the + 0 changes a value (-0 becomes +0), so they keep its
// bits (chip_smoke.py HEADS_DIGESTS).

#include <cuda_bf16.h>

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

// --- the single unstandardized head (mlp_surrogate) ------------------------

constexpr int kSingleThreads = 512;   // threads of a single-head block
// the stride of its work area, compiled in: 4 mod 32, so that a warp's
// transposing stores of a row's columns fall on 8 banks, and a multiple of
// 4 for the products' 128-bit reads; a tile takes up to kSingleLd - 4 rows
constexpr int kSingleLd = 132;
constexpr int kLoadBatch = 16;  // row elements a thread loads at once
// a thread's block of a layer's outputs: kTileRows rows x kTileUnits units
constexpr int kTileRows = 4, kTileUnits = 8;

// Shared memory of the single head, in floats: the head in the Pad layout
// (its x_mu / x_sd slots unused), then xs [max(F, H2)][kSingleLd] (the
// rows, then the second hidden layer) and hid [H1][kSingleLd].
__host__ __device__ inline int single_floats(int f, int h1, int h2) {
  return repro::make_pad(f, h1, h2).per + kSingleLd * ((f > h2 ? f : h2) + h1);
}

// Whether the single-head kernel takes the head; where it does not, the
// head runs through mlp_heads_tiled at P = 1 (groups or slices).
__host__ inline bool single_takes(int f, int h1, int h2) {
  return single_floats(f, h1, h2) <= repro::kMaxSmem / 4;
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  __syncthreads();
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);   // exact
}

// count elements of a tile's rows (f columns each) from src into xs as
// [column][LD], read coalesced and converted to fp32, kLoadBatch loads a
// thread in flight at once; each thread walks its elements' (row,
// column) by the block's stride, with no division per element
template <int LD, class T>
__device__ inline void load_tile(const T* __restrict__ src, int count, int f,
                                 float* xs) {
  const int step = blockDim.x, step_r = step / f, step_c = step - step_r * f;
  int i = threadIdx.x, row = i / f, col = i - row * f;
  while (i < count) {
    float v[kLoadBatch];
    int at[kLoadBatch];
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      const bool in = i < count;
      v[b] = in ? to_float(src[i]) : 0.0f;
      at[b] = in ? col * LD + row : -1;
      i += step;
      row += step_r;
      col += step_c;
      if (col >= f) {
        col -= f;
        ++row;
      }
    }
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b)
      if (at[b] >= 0) xs[at[b]] = v[b];
  }
}

// A thread's operands of one k: RM rows of a and RN units of w, as
// 128-bit reads
template <int LD, int RM, int RN>
__device__ __forceinline__ void tile_load(const float* ap, const float* wp,
                                          int k, int ldw, float (&ar)[RM],
                                          float (&wr)[RN]) {
#pragma unroll
  for (int i = 0; i < RM; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(ap + k * LD + i);
    ar[i] = v.x;
    ar[i + 1] = v.y;
    ar[i + 2] = v.z;
    ar[i + 3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < RN; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(wp + k * ldw + j);
    wr[j] = v.x;
    wr[j + 1] = v.y;
    wr[j + 2] = v.z;
    wr[j + 3] = v.w;
  }
}

template <int RM, int RN>
__device__ __forceinline__ void tile_fma(const float (&ar)[RM],
                                         const float (&wr)[RN],
                                         float (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j)
      acc[i][j] = __fmaf_rn(ar[i], wr[j], acc[i][j]);
}

// out[u][r] = relu(sum_k a[k][r] w[k][u] + b[u]) for r < n_rows, u < n_u,
// as heads.cuh's dense_relu (each sum the index-order __fmaf_rn chain
// from 0, so the same bits) with an RM x RN block of outputs a thread,
// k + 1's operands read before k's products: a is [k][LD], w is
// [k][ldw], out is [u][LD]. A block's last units read up to RN - 4
// floats past a row of w (into the next row, or the bias after it);
// those sums are never stored.
template <int LD, int RM, int RN>
__device__ inline void dense_tile(const float* a, const float* w,
                                  const float* b, int n_k, int n_u, int ldw,
                                  int, int n_rows, float* out) {
  static_assert(RM % 4 == 0 && RN % 4 == 0, "128-bit reads");
  const int nrg = (n_rows + RM - 1) / RM, nug = (n_u + RN - 1) / RN;
  for (int m = threadIdx.x; m < nrg * nug; m += blockDim.x) {
    const int rg = m % nrg, ug = m / nrg;
    const float* ap = a + RM * rg;
    const float* wp = w + RN * ug;
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;
    float a0[RM], w0[RN], a1[RM], w1[RN];
    tile_load<LD>(ap, wp, 0, ldw, a0, w0);
    int k = 0;
    for (; k + 2 <= n_k; k += 2) {
      tile_load<LD>(ap, wp, k + 1, ldw, a1, w1);
      tile_fma(a0, w0, acc);
      if (k + 2 < n_k) tile_load<LD>(ap, wp, k + 2, ldw, a0, w0);
      tile_fma(a1, w1, acc);
    }
    if (k < n_k) tile_fma(a0, w0, acc);
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int u = RN * ug + j;
      if (u >= n_u) break;
      const float bu = b[u];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        if (RM * rg + i < n_rows)
          out[u * LD + RM * rg + i] = fmaxf(acc[i][j] + bu, 0.0f);
    }
  }
}

// One MLP head on fp32 or bf16 rows (replaces mlp_surrogate.py:
// mlp_surrogate; the design is in the note at the top): the persistent
// row tiles of mlp_heads_tiled without the standardizer.
template <class T>
__global__ void __launch_bounds__(kSingleThreads, 1)
    mlp_single(const T* __restrict__ x, repro::Stack s,
               float* __restrict__ out, int n, int rows) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int ld = kSingleLd;
  const Pad pd = repro::make_pad(s.f, s.h1, s.h2);
  float* xs = smem + pd.per;
  float* hid = xs + ld * (s.f > s.h2 ? s.f : s.h2);
  const int tid = threadIdx.x;
  repro::stage_rows(smem + pd.w0, s.w0, s.f, s.h1, pd.h1p);
  repro::stage_part(smem + pd.b0, s.b0, s.h1, 0.0f);
  commit_group();
  repro::stage_rows(smem + pd.w1, s.w1, s.h1, s.h2, pd.h2p);
  repro::stage_part(smem + pd.b1, s.b1, s.h2, 0.0f);
  repro::stage_part(smem + pd.w2, s.w2, s.h2, 0.0f);
  repro::stage_part(smem + pd.tail + 2, s.b2, 1, 0.0f);
  commit_group();
  const int tiles = (n + rows - 1) / rows;
  bool staged = false;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * rows;
    const int m = rows < n - r0 ? rows : n - r0;
    load_tile<ld>(x + static_cast<size_t>(r0) * s.f, m * s.f, s.f, xs);
    if (!staged) wait_group<1>();   // w0 and b0
    else __syncthreads();
    dense_tile<ld, kTileRows, kTileUnits>(xs, smem + pd.w0, smem + pd.b0, s.f,
                                          s.h1, pd.h1p, ld, m, hid);
    if (!staged) wait_group<0>();   // w1, b1, w2 and b2
    else __syncthreads();
    staged = true;
    // the second hidden layer overwrites the rows
    dense_tile<ld, kTileRows, kTileUnits>(hid, smem + pd.w1, smem + pd.b1,
                                          s.h1, s.h2, pd.h2p, ld, m, xs);
    __syncthreads();
    if (tid < m) {
      const float* w2 = smem + pd.w2;
      float y = 0.0f;
#pragma unroll 8
      for (int u = 0; u < s.h2; ++u) y = __fmaf_rn(xs[u * ld + tid], w2[u], y);
      out[r0 + tid] = (y + smem[pd.tail + 2]) + 0.0f;
    }
    __syncthreads();              // xs is read before the next tile's rows
  }
  if (!staged) wait_group<0>();   // a block with no tile
}

template <class T>
cudaError_t launch_single(const T* x, const repro::Stack& s, float* out,
                          int n, int device, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * single_floats(s.f, s.h1, s.h2);
  static repro::Wave w;
  cudaError_t err =
      repro::wave(mlp_single<T>, kSingleThreads, bytes, device, w);
  if (err != cudaSuccess) return err;
  const int rows = repro::tile_rows(n, w.blocks, kSingleLd - 4, kMinRows);
  const int tiles = (n + rows - 1) / rows;
  mlp_single<T><<<tiles < w.blocks ? tiles : w.blocks, kSingleThreads, bytes,
                  stream>>>(x, s, out, n, rows);
  return cudaGetLastError();
}

// The calling thread's device, switched only when it differs: the launch
// path is host-bound, and cudaSetDevice is not free.
cudaError_t use_device(int device) {
  int cur = -1;
  const cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

}  // namespace

extern "C" int mlp_heads_launch(const float* x, const float* const* arrays,
                                float* out, int n, int p, int f, int h1,
                                int h2, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const repro::Stack s{arrays[0], arrays[1], arrays[2], arrays[3], arrays[4],
                       arrays[5], arrays[6], arrays[7], arrays[8], arrays[9],
                       nullptr, p, f, h1, h2, f};
  return launch(x, s, out, n, device, static_cast<cudaStream_t>(stream));
}

extern "C" int mlp_surrogate_launch(const void* x, int x_bf16,
                                    const float* const* arrays, float* out,
                                    int n, int f, int h1, int h2, int device,
                                    void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  // arrays: w1 (F, H1), b1 (H1), w2 (H1, H2), b2 (H2), w3 (H2, 1), b3 (1)
  const repro::Stack s{nullptr, nullptr, nullptr, nullptr, arrays[0],
                       arrays[1], arrays[2], arrays[3], arrays[4], arrays[5],
                       nullptr, 1, f, h1, h2, f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return cudaSuccess;
  if (single_takes(f, h1, h2)) {
    if (x_bf16)
      return launch_single(static_cast<const __nv_bfloat16*>(x), s, out, n,
                           device, st);
    return launch_single(static_cast<const float*>(x), s, out, n, device, st);
  }
  // the head's tiled path reads fp32 rows only
  if (x_bf16) return cudaErrorInvalidValue;
  return launch(static_cast<const float*>(x), s, out, n, device, st);
}

// Rows per tile of the single-head kernel at (F, H1, H2) (0: it does not
// take the head, which runs through the heads' kernel at P = 1) and the
// bytes of shared memory a block takes.
extern "C" void mlp_surrogate_plan(int f, int h1, int h2, int* out) {
  const bool takes = single_takes(f, h1, h2);
  out[0] = takes ? kSingleLd - 4 : 0;
  out[1] = takes ? static_cast<int>(sizeof(float) * single_floats(f, h1, h2))
                 : 0;
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
