// GBDT inference: (N, F) feature rows through T complete trees of depth D
// -> (N,), base + the sum of each tree's leaf.
//
// Replaces: no TPU kernel. The JAX package walks a GBDT head in plain jnp
// (src/repro/core/surrogate.py:136 _predict_gbdt), and the port walked it
// in eager PyTorch (kernels/gbdt_walk.py:gbdt_plain, its plain version
// here): ~8 ops a level over (N, T) int64 node tensors, ~940 bytes of
// device traffic a (row, tree). This kernel walks each (row, tree) in
// registers and reads and writes nothing but the rows, the tables and
// the output.
//
// Bound on the H100: neither HBM nor the fp32 pipes. At the main path's
// shape (1.28 M rows of F = 10, 44 depth-8 trees) the rows are 51 MB
// (~15 us at 3.35 TB/s), but the walk is 450 M dependent lookups: per
// (row, tree, level) a feature index and a threshold at the node, then
// the row's value at that feature, then the next node. What bounds it is
// shared-memory latency and its load throughput (one warp-wide load a
// clock an SM).
//
// Design:
// - The head's whole forest is staged into dynamic shared memory once per
//   block: thresholds (fp32), leaves (fp32) and feature indices, a byte
//   each (F <= 256): 101 KB for lif_unpackable's 44 trees, 71 KB for
//   crossbar_unpackable's 31. A persistent grid (as many blocks as are
//   resident, queried once per shape) walks tiles of rows, so the staging
//   is paid once a block. Where the tables do not fit (or F > 256) the
//   same walk reads them from global memory through the read-only cache.
// - A tile is one row a thread, its rows copied coalesced into shared
//   memory as [feature][row]: the threads of a warp read their rows at
//   any features without a bank conflict. The nodes a warp reads at one
//   level of one tree lie in 2^level consecutive words (level order), so
//   the tables' loads conflict little too.
// - Trees in the outer loop, four at a time (four independent chains of
//   lookups a thread), depth in the inner loop, compiled in at depth 8
//   (both artifacts) and at run time otherwise. The node index is int32:
//   node = 2 * node + 1 + (x[f] > thr). The comparison is exactly x > thr,
//   so a NaN feature and the +inf thresholds that pad a tree go left, as
//   in the plain version: every (row, tree) reaches the plain version's
//   leaf.
// - The leaves are added in tree order 0..T-1 into an fp64 accumulator,
//   then base, and the sum rounds once to fp32: an order fixed by the
//   forest alone, whatever the launch.
//
// One launch a head call on the caller's stream; no allocation, no
// synchronisation; the launch's error code is returned.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use
constexpr int kDepth = 8;         // the depth compiled in
constexpr int kChains = 4;        // trees a thread walks at once
constexpr int kMaxThreads = 1024;
constexpr int kMinThreads = 32;

// The tables as the kernel takes them (kernels/gbdt_walk.py:forest):
// feature indices int32 in [0, F) (checked on the host), thresholds and
// leaves fp32, all (T, nodes) / (T, nodes + 1) in level order, base a
// 0-d fp32 on the card.
struct Forest {
  const int* feat;
  const float* thr;
  const float* leaf;
  const float* base;
  int trees, depth;
};

__host__ __device__ inline int table_bytes(int trees, int depth) {
  const int nodes = (1 << depth) - 1;
  return trees * nodes * 4 + trees * (nodes + 1) * 4 + trees * nodes;
}

__host__ inline bool tables_fit(int f, int trees, int depth) {
  return f <= 256 &&
         table_bytes(trees, depth) + f * kMinThreads * 4 <= kMaxSmem;
}

// Reads of the tables: shared memory (feature indices as bytes) or global
// memory through the read-only cache (int32).
template <bool kShared>
struct Tables {
  const float* thr;
  const float* leaf;
  const void* feat;
  __device__ int feat_at(int i) const {
    if (kShared) return static_cast<const unsigned char*>(feat)[i];
    return __ldg(static_cast<const int*>(feat) + i);
  }
  __device__ float thr_at(int i) const {
    return kShared ? thr[i] : __ldg(thr + i);
  }
  __device__ float leaf_at(int i) const {
    return kShared ? leaf[i] : __ldg(leaf + i);
  }
};

// K trees from `t` on for the row whose features lie at xr[f * ld]; their
// leaves added to acc in tree order.
template <int K, int D, bool kShared>
__device__ __forceinline__ void walk(const Tables<kShared>& tb,
                                     const float* xr, int ld, int t,
                                     int depth, int nodes, double& acc) {
  int node[K];
#pragma unroll
  for (int k = 0; k < K; ++k) node[k] = 0;
  const int levels = D > 0 ? D : depth;
#pragma unroll
  for (int l = 0; l < levels; ++l) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = (t + k) * nodes + node[k];
      const float v = xr[tb.feat_at(i) * ld];
      node[k] = 2 * node[k] + 1 + (v > tb.thr_at(i) ? 1 : 0);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    acc += static_cast<double>(tb.leaf_at((t + k) * (nodes + 1) +
                                          node[k] - nodes));
}

template <int D, bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
    gbdt_walk_kernel(const float* __restrict__ x, Forest fo,
                     float* __restrict__ out, int n, int f) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int depth = D > 0 ? D : fo.depth;
  const int nodes = (1 << depth) - 1;
  const int tn = fo.trees * nodes, tl = fo.trees * (nodes + 1);
  const int rows = blockDim.x;
  // shared layout: thresholds, leaves, the row tile, feature bytes
  float* s_thr = reinterpret_cast<float*>(smem);
  float* s_leaf = s_thr + (kShared ? tn : 0);
  float* xs = s_leaf + (kShared ? tl : 0);
  unsigned char* s_feat = reinterpret_cast<unsigned char*>(xs + f * rows);
  Tables<kShared> tb;
  if (kShared) {
    for (int i = threadIdx.x; i < tn; i += rows) {
      s_thr[i] = fo.thr[i];
      s_feat[i] = static_cast<unsigned char>(fo.feat[i]);
    }
    for (int i = threadIdx.x; i < tl; i += rows) s_leaf[i] = fo.leaf[i];
    tb = Tables<kShared>{s_thr, s_leaf, s_feat};
  } else {
    tb = Tables<kShared>{fo.thr, fo.leaf, fo.feat};
  }
  const double base = static_cast<double>(__ldg(fo.base));
  const int tiles = (n + rows - 1) / rows;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * rows;
    const int m = min(rows, n - r0);
    __syncthreads();  // the tables staged; the last tile's rows read
    const float* xg = x + static_cast<size_t>(r0) * f;
    for (int i = threadIdx.x; i < m * f; i += rows) {
      const int r = i / f;
      xs[(i - r * f) * rows + r] = xg[i];
    }
    __syncthreads();
    if (threadIdx.x < m) {
      const float* xr = xs + threadIdx.x;
      double acc = 0.0;
      int t = 0;
      for (; t + kChains <= fo.trees; t += kChains)
        walk<kChains, D, kShared>(tb, xr, rows, t, depth, nodes, acc);
      for (; t < fo.trees; ++t)
        walk<1, D, kShared>(tb, xr, rows, t, depth, nodes, acc);
      out[r0 + threadIdx.x] = __double2float_rn(acc + base);
    }
  }
}

// A launch's shape: threads a block (rows a tile), the grid of one
// resident wave, the shared-memory bytes of a block.
struct Plan {
  int threads, blocks, bytes;
};

template <int D, bool kShared>
cudaError_t occupancy(int threads, int bytes, int& per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      gbdt_walk_kernel<D, kShared>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gbdt_walk_kernel<D, kShared>, threads, bytes);
}

// The block size (1024 down to 32 threads) that keeps the most threads
// resident an SM, the fewer threads on a tie (a finer last wave). Queried
// once per (instance, bytes of tables, F, device): the host enqueues this
// kernel every tick, and the occupancy query is slow.
template <int D, bool kShared>
cudaError_t plan_for(int tables, int f, int device, Plan& p) {
  struct Cached {
    int tables = -1, f = -1, device = -1;
    Plan plan{};
  };
  static Cached cached;
  if (cached.tables == tables && cached.f == f && cached.device == device) {
    p = cached.plan;
    return cudaSuccess;
  }
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  Plan best{0, 0, 0};
  int best_resident = 0;
  for (int threads = kMaxThreads; threads >= kMinThreads; threads /= 2) {
    const int bytes = tables + f * threads * 4;
    if (bytes > kMaxSmem) continue;
    int per_sm = 0;
    err = occupancy<D, kShared>(threads, bytes, per_sm);
    if (err != cudaSuccess) return err;
    if (best.threads == 0 || per_sm * threads >= best_resident) {
      best_resident = per_sm * threads;
      best = Plan{threads, (per_sm > 1 ? per_sm : 1) * sms, bytes};
    }
  }
  if (best.threads == 0) return cudaErrorInvalidValue;
  // the loop left the attribute at the last size it tried: set the
  // chosen one
  int per_sm = 0;
  err = occupancy<D, kShared>(best.threads, best.bytes, per_sm);
  if (err != cudaSuccess) return err;
  cached = Cached{tables, f, device, best};
  p = best;
  return cudaSuccess;
}

template <int D, bool kShared>
cudaError_t launch(const float* x, const Forest& fo, float* out, int n,
                   int f, int device, cudaStream_t stream) {
  Plan p;
  const int tables = kShared ? table_bytes(fo.trees, fo.depth) : 0;
  cudaError_t err = plan_for<D, kShared>(tables, f, device, p);
  if (err != cudaSuccess) return err;
  const int tiles = (n + p.threads - 1) / p.threads;
  gbdt_walk_kernel<D, kShared>
      <<<tiles < p.blocks ? tiles : p.blocks, p.threads, p.bytes, stream>>>(
          x, fo, out, n, f);
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

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Whether the tables of `trees` depth-`depth` trees over F features are
// staged in shared memory (1) or read from global memory (0).
int gbdt_walk_shared(int f, int trees, int depth) {
  return tables_fit(f, trees, depth) ? 1 : 0;
}

int gbdt_walk_launch(const float* x, const int* feat, const float* thr,
                     const float* leaf, const float* base, float* out, int n,
                     int f, int trees, int depth, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (n <= 0 || f < 1 || trees < 0 || depth < 0 || depth > 20)
    return cudaErrorInvalidValue;
  const Forest fo{feat, thr, leaf, base, trees, depth};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool shared = tables_fit(f, trees, depth);
  if (depth == kDepth)
    return shared ? launch<kDepth, true>(x, fo, out, n, f, device, st)
                  : launch<kDepth, false>(x, fo, out, n, f, device, st);
  return shared ? launch<0, true>(x, fo, out, n, f, device, st)
                : launch<0, false>(x, fo, out, n, f, device, st);
}

}  // extern "C"
