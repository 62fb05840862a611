// Causal flash attention forward: (BH, S, D) query rows against a
// G-shared (BH / G, S, D) key and value, fp32 online softmax.
//
// Replaces: src/repro/kernels/flash_attn.py:flash_attention (the
// pallas_call over _make_kernel, :23-50), its wrapper kernels/ops.py:305
// and oracle kernels/ref.py:29. The function is the TPU kernel's: q in
// fp32 scaled by 1/sqrt(D) before the product, fp32 logits masked to
// -1e30 where k_pos > q_pos, an online softmax with a running max and
// sum, an fp32 accumulator of p @ v, and acc / max(l, 1e-30) cast to q's
// type. Three departures from its interface, none a new function: a
// kv-group factor G maps query row bh to KV row bh / G (GQA without
// copying K/V; G = 1 is the TPU kernel's signature), S need not be a
// multiple of the tile (the ragged tail is masked), and D is one of
// 8/16/32/64/128.
//
// Bound on the H100: bytes. At the serve path's shape (q 96 x 512 x 128
// bf16, k/v 8 x 512 x 128) the causal work is ~6.45 GFLOP, 6.5 us at the
// bf16 tensor-core peak, against ~27 MB of q, o, k and v, 8.2 us at
// 3.35 TB/s. This simple design is far from either: it runs the products
// on the fp32 cores out of shared memory.
//
// Design: one block of 256 threads per (bh, 64-query tile), the heaviest
// tiles (the last along S) launched first. The scaled Q tile sits in
// shared memory as fp32; a loop over 64-key tiles up to the causal
// frontier stages each K and V tile as fp32 (K rows padded to D + 1
// floats against bank conflicts). Per tile: each thread computes a 4 x 4
// block of logits (sequential __fmaf_rn over d in index order) into
// shared memory; four threads per query row take the row max, precise
// expf, the row sum (fixed shuffle order) and the rescale; each of the
// four then owns D / 4 columns of the row's fp32 accumulator in registers
// and adds p @ v (index order over the tile's keys). Built with
// --fmad=false, so every other multiply and add rounds on its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile (== BQ: tile j <= q tile)
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * D + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int bh_n,
                      int s, int groups, float scale) {
  constexpr int LDK = D + 1;    // padded K row
  constexpr int LDP = BK + 1;   // padded logits row
  constexpr int NA = D / 4;     // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][D]   scaled query tile
  float* ks = qs + BQ * D;      // [BK][LDK] key tile
  float* vs = ks + BK * LDK;    // [BK][D]   value tile
  float* ps = vs + BK * D;      // [BQ][LDP] logits, then p

  const int nq = (s + BQ - 1) / BQ;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x / bh_n);
  const int bh = static_cast<int>(blockIdx.x % bh_n);
  const int q0 = qi * BQ;
  const size_t q_off = static_cast<size_t>(bh) * s * D;
  const size_t kv_off = static_cast<size_t>(bh / groups) * s * D;
  const int tid = threadIdx.x;

  // the scaled query tile; rows past s are zeros and never stored
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int row = q0 + i / D;
    qs[i] = row < s ? __fmul_rn(to_float(q[q_off + static_cast<size_t>(row) * D
                                           + i % D]), scale)
                    : 0.0f;
  }

  const int ty = tid / 16, tx = tid % 16;   // logits: rows 4ty.., cols tx+16b
  const int ar = tid / 4, al = tid % 4;     // softmax / accumulator: row ar
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
  float m_run = NEG_INF, l_run = 0.0f;

  for (int j = 0; j <= qi; ++j) {           // up to the causal frontier
    const int k0 = j * BK;
    __syncthreads();   // the last tile's readers are done (Q staged, first)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int key = k0 + r;
      const size_t g = kv_off + static_cast<size_t>(key) * D + c;
      ks[r * LDK + c] = key < s ? to_float(k[g]) : 0.0f;
      vs[r * D + c] = key < s ? to_float(v[g]) : 0.0f;
    }
    __syncthreads();

    float sacc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) sacc[a][b] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = qs[(4 * ty + a) * D + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kv[b] = ks[(tx + 16 * b) * LDK + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          sacc[a][b] = __fmaf_rn(qv[a], kv[b], sacc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = 4 * ty + a, c = tx + 16 * b;
        ps[r * LDP + c] = (k0 + c <= q0 + r) ? sacc[a][b] : NEG_INF;
      }
    __syncthreads();

    // online softmax of row ar over this tile: four lanes of one warp
    float* prow = ps + ar * LDP;
    float mx = NEG_INF;
    for (int c = al; c < BK; c += 4) mx = fmaxf(mx, prow[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    float psum = 0.0f;
    for (int c = al; c < BK; c += 4) {
      const float p = expf(prow[c] - m_new);
      prow[c] = p;
      psum = psum + p;
    }
    psum = psum + __shfl_xor_sync(0xffffffffu, psum, 1);
    psum = psum + __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    __syncwarp();      // the row's p, written by its four lanes, is visible

    float pv[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) pv[i] = 0.0f;
    for (int kk = 0; kk < BK; ++kk) {
      const float p = prow[kk];
#pragma unroll
      for (int i = 0; i < NA; ++i)
        pv[i] = __fmaf_rn(p, vs[kk * D + al + 4 * i], pv[i]);
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = acc[i] * alpha + pv[i];
  }

  const int row = q0 + ar;
  if (row < s) {
    const float l = fmaxf(l_run, 1e-30f);
    T* out = o + q_off + static_cast<size_t>(row) * D;
#pragma unroll
    for (int i = 0; i < NA; ++i) store(out + al + 4 * i, acc[i] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int s, int groups, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((s + BQ - 1) / BQ) *
                          static_cast<unsigned>(bh);
  flash_attn_kernel<T, D><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bh, s, groups, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int bh, int s, int d, int groups, float scale,
                     cudaStream_t stream) {
  switch (d) {
    case 8: return launch<T, 8>(q, k, v, o, bh, s, groups, scale, stream);
    case 16: return launch<T, 16>(q, k, v, o, bh, s, groups, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, bh, s, groups, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, s, groups, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, s, groups, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, o: (bh, s, d); k, v: (bh / groups, s, d), all contiguous, bf16 when
// is_bf16 else fp32. Launches on ``stream`` and returns the CUDA error code.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int bh, int s, int d, int groups,
                           int is_bf16, float scale, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, bh, s, d, groups,
                                          scale, st)
                : launch_d<float>(q, k, v, o, bh, s, d, groups, scale, st);
  return err;
}

}  // extern "C"
