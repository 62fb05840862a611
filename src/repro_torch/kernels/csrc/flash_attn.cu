// Causal flash attention forward: (BH, S, D) query rows against a
// G-shared (BH / G, S, D) key and value, fp32 online softmax. Two routes,
// chosen by the wrapper from (dtype, D) alone
// (kernels/flash_attn.py:route): bf16 with D in 16/32/64/128 runs on the
// tensor cores (flash_attention_tc_launch), fp32 and D = 8 on the fp32
// cores (flash_attention_simt_launch).
//
// Replaces: src/repro/kernels/flash_attn.py:flash_attention (the
// pallas_call over _make_kernel, :23-50), its wrapper kernels/ops.py:305
// and oracle kernels/ref.py:29. The function is the TPU kernel's: fp32
// logits masked to -1e30 where k_pos > q_pos, an online softmax with a
// running max and sum, an fp32 accumulator of p @ v, and acc / max(l,
// 1e-30) cast to q's type. Three departures from its interface, none a
// new function: a kv-group factor G maps query row bh to KV row bh / G
// (GQA without copying K/V; G = 1 is the TPU kernel's signature), S need
// not be a multiple of the tile (the ragged tail is masked), and D is one
// of 8/16/32/64/128.
//
// Bound on the H100: bytes at S = 512, operations from S ~ 640 up (G =
// 12). At the serve path's shape (q 192 x 512 x 128 bf16, k/v 16 x 512 x
// 128) the causal work is 12.9 GFLOP, 13 us at the bf16 tensor-core peak,
// against 54.5 MB of q, o, k and v, 16 us at 3.35 TB/s; at S = 4,096 (bh
// 96) it is 412 GFLOP, 0.42 ms at the peak.
//
// Tensor-core route (bf16). One block of two consumer warpgroups and one
// producer warp per (bh, 128-query tile); the heaviest tiles (the last
// along S) launch first, and the G query heads that read one KV row sit
// next to each other in the grid, so their K/V tiles are read from L2.
// The producer issues TMA loads: each warpgroup's 64-row Q tile once,
// then 64-key K and V tiles into a two-stage ring, each stage behind a
// "full" mbarrier (transaction bytes) and an "empty" one (one arrival per
// consumer warp). Tensor maps are 3-D (D, S, rows) so that rows past S
// are out of bounds and arrive as zeros; each tile is stored as chunks of
// min(D, 64) columns in TMA's 128/64/32-byte swizzle, which the wgmma
// descriptors name. Per K/V tile a consumer warpgroup
//   1. computes S = Q K^T with wgmma m64n64k16 from shared memory (bf16
//      products are exact in fp32; the sums are fp32), then multiplies by
//      1/sqrt(D) in fp32 (the TPU kernel scales q first: ~1 ulp of a
//      logit apart), masking keys above the row on the diagonal tile
//      only (a key past S is above every row < S there);
//   2. runs the online softmax in the accumulator registers: the row max
//      and sum over a quad of lanes by shuffles, precise expf;
//   3. splits P into bf16 hi = bf16(p) and lo = bf16(p - hi) in registers
//      and adds both P_hi V and P_lo V into the fp32 O accumulator with
//      wgmma (A from registers, V's tile MN-major from shared memory), so
//      that p @ v keeps p to ~2^-16 relative, where one bf16 P (as SDPA
//      uses) would round each weight by up to 2^-9.
// The epilogue divides by max(l, 1e-30) and stores bf16 pairs.
//
// fp32 / D = 8 route: the first design, on the fp32 cores. One block of
// 256 threads per (bh, 64-query tile), heaviest tiles first. The scaled Q
// tile sits in shared memory as fp32; a loop over 64-key tiles up to the
// causal frontier stages each K and V tile as fp32 (K rows padded to D +
// 1 floats against bank conflicts). Per tile: each thread computes a 4 x 4
// block of logits (sequential __fmaf_rn over d in index order) into
// shared memory; four threads per query row take the row max, precise
// expf, the row sum (fixed shuffle order) and the rescale; each of the
// four then owns D / 4 columns of the row's fp32 accumulator in registers
// and adds p @ v (index order over the tile's keys). Built with
// --fmad=false, so every other multiply and add rounds on its own.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
    flash_attn_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o,
                   int bh, int s, int groups, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_simt_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((s + BQ - 1) / BQ) *
                          static_cast<unsigned>(bh);
  flash_attn_simt_kernel<T, D><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bh, s, groups, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simt_d(const void* q, const void* k, const void* v, void* o,
                     int bh, int s, int d, int groups, float scale,
                     cudaStream_t stream) {
  switch (d) {
    case 8: return launch_simt<T, 8>(q, k, v, o, bh, s, groups, scale, stream);
    case 16: return launch_simt<T, 16>(q, k, v, o, bh, s, groups, scale, stream);
    case 32: return launch_simt<T, 32>(q, k, v, o, bh, s, groups, scale, stream);
    case 64: return launch_simt<T, 64>(q, k, v, o, bh, s, groups, scale, stream);
    case 128: return launch_simt<T, 128>(q, k, v, o, bh, s, groups, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace


namespace tc {

constexpr int BM = 64;          // query rows per consumer warpgroup
constexpr int BN = 64;          // keys per K/V tile
constexpr int CONSUMERS = 2;    // a block covers BM * CONSUMERS query rows
constexpr int STAGES = 2;       // K/V ring depth
constexpr int THREADS = 128 * CONSUMERS + 32;   // + one producer warp
constexpr float NEG_INF = -1e30f;
constexpr int kEncodeFailed = 100000;   // + CUresult, see repro_error_string

template <int D>
struct Tile {
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;  // swizzle bytes
  static constexpr int CW = SW / 2;       // columns per chunk (one TMA box)
  static constexpr int NCH = D / CW;      // chunks per row
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
  static constexpr size_t SMEM = 1024 + CONSUMERS * Q_BYTES
                                 + 2 * STAGES * KV_BYTES + 128;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// until the phase of parity `parity` has completed; a wait of ~10 s (2^34
// cycles) means a copy or an arrival was lost, and traps rather than hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// shared-memory matrix descriptor: start, leading and stride byte offsets
// (16-byte units), swizzle layout (1: 128 B, 2: 64 B, 3: 32 B)
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32)
         | (Tile<D>::LAYOUT << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads of accumulators above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d += A (shared, K-major) * B (shared, K-major), m64n64k16
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A (registers) * B (shared, MN-major), m64n16k16
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A (registers) * B (shared, MN-major), m64n32k16
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A (registers) * B (shared, MN-major), m64n64k16
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n16(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n32(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attn_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         __nv_bfloat16* __restrict__ o, int bh_n, int s,
                         int groups, float scale) {
  using T = Tile<D>;
  constexpr int SW = T::SW, CW = T::CW, NCH = T::NCH;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles need 1024-byte alignment; SMEM holds the slack
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;                              // [CONSUMERS]
  const uint32_t k_s = q_s + CONSUMERS * T::Q_BYTES;      // [STAGES]
  const uint32_t v_s = k_s + STAGES * T::KV_BYTES;        // [STAGES]
  const uint32_t bars = v_s + STAGES * T::KV_BYTES;
  const uint32_t q_full = bars;                           // [CONSUMERS]
  const uint32_t kv_full = q_full + 8 * CONSUMERS;        // [STAGES]
  const uint32_t kv_empty = kv_full + 8 * STAGES;         // [STAGES]

  const int nq = (s + BM * CONSUMERS - 1) / (BM * CONSUMERS);
  const int qi = nq - 1 - static_cast<int>(blockIdx.x / bh_n);
  const int bh = static_cast<int>(blockIdx.x % bh_n);
  const int q0 = qi * BM * CONSUMERS;
  // key tiles up to the block's causal frontier, none wholly past s
  const int n_kv = min(CONSUMERS * (qi + 1), (s + BN - 1) / BN);

  if (threadIdx.x == 0) {
    for (int w = 0; w < CONSUMERS; ++w) mbar_init(q_full + 8 * w, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(kv_full + 8 * st, 1);
      mbar_init(kv_empty + 8 * st, 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // producer: one thread issues every copy
    if (threadIdx.x != 128 * CONSUMERS) return;
    for (int w = 0; w < CONSUMERS; ++w) {
      mbar_expect_tx(q_full + 8 * w, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        tma_load(q_s + w * T::Q_BYTES + c * BM * SW, &qmap, q_full + 8 * w,
                 c * CW, q0 + BM * w, bh);
    }
    const int kvh = bh / groups;
    for (int j = 0; j < n_kv; ++j) {
      const int st = j % STAGES;
      mbar_wait(kv_empty + 8 * st, ((j / STAGES) & 1) ^ 1);
      mbar_expect_tx(kv_full + 8 * st, 2 * T::KV_BYTES);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        tma_load(k_s + st * T::KV_BYTES + c * BN * SW, &kmap,
                 kv_full + 8 * st, c * CW, BN * j, kvh);
        tma_load(v_s + st * T::KV_BYTES + c * BN * SW, &vmap,
                 kv_full + 8 * st, c * CW, BN * j, kvh);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg .. + 63
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row_a = 16 * (t / 32) + lane / 4;   // and row_a + 8
  const int quad_col = 2 * (lane % 4);
  const int diag = CONSUMERS * qi + wg;         // key tile on the diagonal
  const int last = min(diag, n_kv - 1);
  const uint32_t q_tile = q_s + wg * T::Q_BYTES;

  float acc[NCH][CW / 2];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) acc[c][i] = 0.0f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.0f, 0.0f};

  mbar_wait(q_full + 8 * wg, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int st = j % STAGES;
    mbar_wait(kv_full + 8 * st, (j / STAGES) & 1);
    if (j <= last) {
      const uint32_t k_tile = k_s + st * T::KV_BYTES;
      const uint32_t v_tile = v_s + st * T::KV_BYTES;
      float sc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 / CW, within = (kk * 16 % CW) * 2;
        wgmma_ss_n64(sc, desc<D>(q_tile + c * BM * SW + within, 0, 8 * SW),
                     desc<D>(k_tile + c * BN * SW + within, 0, 8 * SW), 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);

      // scale after the product; causal mask on the diagonal tile only
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int h = (i % 4) / 2;            // row_a or row_a + 8
        const int key = 8 * (i / 4) + quad_col + (i % 2);
        float x = __fmul_rn(sc[i], scale);
        if (j == diag && key > row_a + 8 * h) x = NEG_INF;
        sc[i] = x;
        mx[h] = fmaxf(mx[h], x);
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h]);
        alpha[h] = expf(m_run[h] - m_new);
        m_run[h] = m_new;
      }
      float psum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int h = (i % 4) / 2;
        sc[i] = expf(sc[i] - m_run[h]);
        psum[h] = psum[h] + sc[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        psum[h] = psum[h] + __shfl_xor_sync(0xffffffffu, psum[h], 1);
        psum[h] = psum[h] + __shfl_xor_sync(0xffffffffu, psum[h], 2);
        l_run[h] = l_run[h] * alpha[h] + psum[h];
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int i = 0; i < CW / 2; ++i)
          acc[c][i] = acc[c][i] * alpha[(i % 4) / 2];

      // P as bf16 hi + lo A fragments: keys 16 kk .. 16 kk + 15
      uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = sc[8 * kk + 2 * r], y = sc[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
          p_hi[kk][r] = bf16x2_bits(hi);
          p_lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(
              x - __low2float(hi), y - __high2float(hi)));
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const uint64_t dv = desc<D>(v_tile + c * BN * SW + kk * 16 * SW,
                                      8 * SW, 8 * SW);
          wgmma_rs<CW>(acc[c], p_hi[kk], dv);
          wgmma_rs<CW>(acc[c], p_lo[kk], dv);
        }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int c = 0; c < NCH; ++c) fence_regs(acc[c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(kv_empty + 8 * st);
  }

  const float den[2] = {fmaxf(l_run[0], 1e-30f), fmaxf(l_run[1], 1e-30f)};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + BM * wg + row_a + 8 * h;
    if (row >= s) continue;
    __nv_bfloat16* out = o + (static_cast<size_t>(bh) * s + row) * D;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int g = 0; g < CW / 8; ++g) {
        const int i = 4 * g + 2 * h;
        *reinterpret_cast<__nv_bfloat162*>(out + c * CW + 8 * g + quad_col) =
            __floats2bfloat162_rn(acc[c][i] / den[h], acc[c][i + 1] / den[h]);
      }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime's
// entry-point query (no link against libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (rows, s, D) bf16, boxes of CW columns x box_rows rows of one row
template <int D>
CUresult encode(CUtensorMap* map, const void* ptr, int rows, int s,
                int box_rows) {
  using T = Tile<D>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return CUDA_ERROR_NOT_SUPPORTED;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(s) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(T::CW),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : T::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);   // out of bounds: zeros
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s, int groups, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  CUresult r = encode<D>(&qm, q, bh, s, BM);
  if (r == CUDA_SUCCESS) r = encode<D>(&km, k, bh / groups, s, BN);
  if (r == CUDA_SUCCESS) r = encode<D>(&vm, v, bh / groups, s, BN);
  if (r != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(r);
  constexpr size_t smem = Tile<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>((s + BM * CONSUMERS - 1) / (BM * CONSUMERS)) *
      static_cast<unsigned>(bh);
  flash_attn_tc_kernel<D><<<blocks, THREADS, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), bh, s, groups, scale);
  return cudaGetLastError();
}

}  // namespace tc

extern "C" {

const char* repro_error_string(int code) {
  if (code >= tc::kEncodeFailed)
    return "cuTensorMapEncodeTiled failed (a CUDA library without TMA, or "
           "a tensor it cannot map)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, o: (bh, s, d); k, v: (bh / groups, s, d), all contiguous bf16 with
// 16-byte aligned bases, d in 16/32/64/128. Launches on ``stream`` and
// returns the CUDA error code (or tc::kEncodeFailed + CUresult).
int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                              void* o, int bh, int s, int d, int groups,
                              float scale, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return tc::launch<16>(q, k, v, o, bh, s, groups, scale, st);
    case 32: return tc::launch<32>(q, k, v, o, bh, s, groups, scale, st);
    case 64: return tc::launch<64>(q, k, v, o, bh, s, groups, scale, st);
    case 128: return tc::launch<128>(q, k, v, o, bh, s, groups, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// q, o: (bh, s, d); k, v: (bh / groups, s, d), all contiguous, bf16 when
// is_bf16 else fp32. Launches on ``stream`` and returns the CUDA error code.
int flash_attention_simt_launch(const void* q, const void* k, const void* v,
                                void* o, int bh, int s, int d, int groups,
                                int is_bf16, float scale, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? launch_simt_d<__nv_bfloat16>(q, k, v, o, bh, s, d, groups,
                                               scale, st)
                : launch_simt_d<float>(q, k, v, o, bh, s, d, groups, scale,
                                       st);
  return err;
}

}  // extern "C"
