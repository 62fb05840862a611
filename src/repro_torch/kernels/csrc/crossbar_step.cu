// Golden crossbar rows: the DC target of each row, alone or fused with the
// clock period that settles the row's output toward it.
//
// Replaces: src/repro/kernels/crossbar_mvm.py:crossbar_target (the
// pallas_call computing v_sat * tanh(-R_f * G * (w . v + b * V_bias) /
// v_sat) and tau0 * (1 + 0.5 * mean|w|) per row). The second entry point,
// crossbar_step, fuses that target with the 64-substep settling loop of
// repro.core.circuits.CrossbarRow.step (capacitor + resistive energy, the
// 90% settling marker), which the reference runs as plain XLA.
//
// Bound on the H100: bytes. A row reads 32 inputs and 33 weights (260 B)
// and writes 8-13 B; its sums are ~260 operations and the settling loop
// ~15 per substep with no fused multiply-add, ~1,300 in all, about 5 per
// byte, left of the unfused fp32 ridge point (33.5 T operations/s over
// 3.35 TB/s = 10). At N = 312,000 that is 86 MB (26 us) against ~20 us of
// operations, so the operations have to hide under the copies. On an
// H100 80GB HBM3 (700 W) the fused period there takes ~46 us: the target
// alone (the copies) ~34 us plus ~12 us of settle that does not hide yet.
//
// Design:
// - A persistent grid: each block walks row tiles (one thread a row; 128
//   rows, or 32 when N is small, as crossbar_mvm.plan sizes them at
//   launch), so the grid is sized once to the card, with no second wave
//   of blocks, and small N spreads over every SM.
// - Tile k+1's rows of v and w arrive by 16-byte cp.async while tile k
//   settles: a tile's buffer is free once its rows' dot products and
//   resistive sums are in registers, and the settle loop needs only
//   registers. The tile starts are 16-byte aligned (tiles are 32 or
//   128 rows and the wrapper checks the bases).
// - No integer division in the staging: the width is compiled in (n_in =
//   32, CrossbarRow's); v rows go to a pitch of 36 floats, so the float4
//   reads of a quarter warp's rows fall on 8 different bank groups; w's
//   33-float rows are copied densely, a stride that is already free of
//   bank conflicts. A generic instance takes narrower rows (dense).
// - The 64 substeps are compiled in (a loop of constant trip count
//   unrolled by 8), the settling marker kept as a substep index, and the
//   capacitor power's division by dt_s runs through quot_nonneg()
//   (quot.cuh: the card's own division sequence without its per-quotient
//   branch), so the division and the energy adds issue beside the v
//   chain (subtract, multiply, add) instead of behind a branch.
// - Built with --fmad=false and precise tanhf/expf/division: every sum
//   runs in index order and every operation rounds as the plain version
//   (kernels/crossbar_mvm.py) does, so the redesign keeps the first
//   design's bits (chip_smoke.py XBAR_DIGESTS).

#include <cuda_runtime.h>
#include <stdint.h>

#include "quot.cuh"

struct XbarConsts {  // mirrored by crossbar_mvm._XbarConsts (ctypes)
  int n_substeps;
  float g_unit, g_leak, neg_r_f, v_sat, c_load, tau_base, v_bias;
  float neg_dt, dt, dt_s, clock_ns;
};

namespace {

constexpr int kMaxIn = 32;          // CrossbarRow's n_inputs, compiled in
constexpr int kSubsteps = 64;       // CrossbarRow's n_substeps, compiled in
constexpr int kMaxTile = 128;       // rows per tile at most
constexpr int kPitchV = kMaxIn + 4; // v rows in shared memory

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// `count` contiguous floats from a 16-byte-aligned source to a
// 16-byte-aligned shared buffer.
__device__ __forceinline__ void copy_dense(const float* src, int count,
                                           float* dst) {
  const int body = count >> 2;
  for (int q = threadIdx.x; q < body; q += blockDim.x)
    cp_async16(dst + 4 * q, src + 4 * q);
  for (int e = 4 * body + threadIdx.x; e < count; e += blockDim.x)
    cp_async4(dst + e, src + e);
}

// Start the copies of rows r0 .. r0 + rows - 1 of v (width IN, or n_in
// when IN = 0) and w (one column more) into the block's buffers.
template <int IN>
__device__ __forceinline__ void copy_tile(const float* v, const float* w,
                                          int r0, int rows, int n_in,
                                          float* sv, float* sw) {
  const int wv = IN > 0 ? IN : n_in;
  copy_dense(w + static_cast<size_t>(r0) * (wv + 1), rows * (wv + 1), sw);
  const float* src = v + static_cast<size_t>(r0) * wv;
  if (IN == kMaxIn) {
    constexpr int kChunks = kMaxIn / 4;  // 16-byte chunks a row
    for (int q = threadIdx.x; q < rows * kChunks; q += blockDim.x)
      cp_async16(sv + (q / kChunks) * kPitchV + (q % kChunks) * 4,
                 src + 4 * q);
  } else {
    copy_dense(src, rows * wv, sv);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// One row's sums, each in index order: the dot product w . v, sum |w|
// and (fused only) the resistive power sum v^2 (|w| G + G_leak).
template <int IN, bool kFused>
__device__ __forceinline__ void row_sums(const float* vr, const float* wr,
                                         int n_in, const XbarConsts& c,
                                         float& acc, float& load,
                                         float& p_res) {
  acc = 0.0f;
  load = 0.0f;
  p_res = 0.0f;
  if (IN == kMaxIn) {
#pragma unroll
    for (int q = 0; q < kMaxIn / 4; ++q) {
      const float4 v4 = reinterpret_cast<const float4*>(vr)[q];
      const float vk[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float wk = wr[4 * q + j];
        acc = acc + wk * vk[j];
        load = load + fabsf(wk);
        if (kFused) {
          const float g_row = fabsf(wk) * c.g_unit + c.g_leak;
          p_res = p_res + (vk[j] * vk[j]) * g_row;
        }
      }
    }
  } else {
    for (int k = 0; k < n_in; ++k) {
      const float wk = wr[k], vk = vr[k];
      acc = acc + wk * vk;
      load = load + fabsf(wk);
      if (kFused) {
        const float g_row = fabsf(wk) * c.g_unit + c.g_leak;
        p_res = p_res + (vk * vk) * g_row;
      }
    }
  }
}

// The row's settled target and pole from its sums.
__device__ __forceinline__ void row_target(float acc, float load, float bias,
                                           int n_in, const XbarConsts& c,
                                           float& v_tgt, float& tau) {
  const float i_sig = c.g_unit * (acc + bias * c.v_bias);
  const float v_lin = c.neg_r_f * i_sig;
  v_tgt = c.v_sat * tanhf(v_lin / c.v_sat);
  tau = c.tau_base * (1.0f + 0.5f * (load / static_cast<float>(n_in)));
}

// One clock period settling from v0 toward v_tgt with pole tau: new
// output, energy, latency (the first substep within 10% of the swing) and
// the spike flag. S > 0 compiles the substep count in.
template <int S>
__device__ __forceinline__ void settle(float v0, float v_tgt, float tau,
                                       float p_res, const XbarConsts& c,
                                       float& v_out, float& energy_o,
                                       float& latency_o, bool& spiked_o) {
  const float a = expf(c.neg_dt / tau);
  const float band = 0.1f * fabsf(v_tgt - v0) + 1e-6f;
  const int n_sub = S > 0 ? S : c.n_substeps;
  // the capacitor power's c_load |dv| / dt_s by quot_nonneg (its dividend
  // is >= +0 when c_load > 0); where quot declines, the period again with
  // `/`
  const float d = c.dt_s, r = rcp_newton(d);
  bool ok = divisor_ok(d) && d > 0.0f && c.c_load > 0.0f;
  float vv = v0, energy = 0.0f;
  int first = 0;  // 1 + the first settled substep, 0 for none
#pragma unroll 8
  for (int i = 0; i < n_sub; ++i) {
    const float v_new = v_tgt + (vv - v_tgt) * a;
    const float p_cap =
        quot_nonneg(c.c_load * fabsf(v_new - vv), d, r, ok) * fabsf(v_new);
    energy = energy + (p_cap + p_res) * c.dt * 1e-9f;
    first = (first == 0 && fabsf(v_new - v_tgt) <= band) ? i + 1 : first;
    vv = v_new;
  }
  if (!ok) {
    vv = v0;
    energy = 0.0f;
    first = 0;
    for (int i = 0; i < n_sub; ++i) {
      const float v_new = v_tgt + (vv - v_tgt) * a;
      const float p_cap =
          c.c_load * fabsf(v_new - vv) / c.dt_s * fabsf(v_new);
      energy = energy + (p_cap + p_res) * c.dt * 1e-9f;
      first = (first == 0 && fabsf(v_new - v_tgt) <= band) ? i + 1 : first;
      vv = v_new;
    }
  }
  v_out = vv;
  energy_o = energy;
  latency_o = first == 0 ? c.clock_ns : static_cast<float>(first) * c.dt;
  spiked_o = fabsf(vv - v0) > 0.02f;
}

// Both entry points: kFused runs the whole period (outputs new_state,
// energy, latency, spiked), else the target alone (v_tgt in out0, tau in
// out1). The block walks tiles blockIdx.x, blockIdx.x + gridDim.x, ...
template <int IN, int S, bool kFused>
__global__ void __launch_bounds__(kMaxTile)
    crossbar_kernel(const float* __restrict__ state,
                    const float* __restrict__ v, const float* __restrict__ w,
                    float* __restrict__ out0, float* __restrict__ out1,
                    float* __restrict__ latency_o,
                    bool* __restrict__ spiked_o, int n, int n_in,
                    int tile_rows, XbarConsts c) {
  extern __shared__ __align__(16) float smem[];
  const int wv = IN > 0 ? IN : n_in;
  const int pv = IN == kMaxIn ? kPitchV : wv;
  float* sw = smem;                            // tile_rows x (wv + 1)
  float* sv = smem + tile_rows * (wv + 1);     // tile_rows x pv
  const int n_tiles = (n + tile_rows - 1) / tile_rows;
  const int t = threadIdx.x;
  int tile = blockIdx.x;
  if (tile >= n_tiles) return;
  copy_tile<IN>(v, w, tile * tile_rows, min(tile_rows, n - tile * tile_rows),
                n_in, sv, sw);
  for (; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * tile_rows;
    const int rows = min(tile_rows, n - r0);
    const int r = r0 + t;
    const float v0 = (kFused && t < rows) ? state[r] : 0.0f;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    float acc = 0.0f, load = 0.0f, p_res = 0.0f, bias = 0.0f;
    if (t < rows) {
      row_sums<IN, kFused>(sv + t * pv, sw + t * (wv + 1), n_in, c, acc,
                           load, p_res);
      bias = sw[t * (wv + 1) + wv];
    }
    __syncthreads();  // every row's sums in registers: the buffer is free
    const int next = tile + gridDim.x;
    if (next < n_tiles)
      copy_tile<IN>(v, w, next * tile_rows,
                    min(tile_rows, n - next * tile_rows), n_in, sv, sw);
    if (t < rows) {
      float v_tgt, tau;
      row_target(acc, load, bias, wv, c, v_tgt, tau);
      if (kFused) {
        settle<S>(v0, v_tgt, tau, p_res, c, out0[r], out1[r], latency_o[r],
                  spiked_o[r]);
      } else {
        out0[r] = v_tgt;
        out1[r] = tau;
      }
    }
  }
}

template <int IN, int S, bool kFused>
cudaError_t launch(const float* state, const float* v, const float* w,
                   float* out0, float* out1, float* latency, bool* spiked,
                   int n, int n_in, int tile_rows, int grid,
                   const XbarConsts& c, void* stream) {
  const int wv = IN > 0 ? IN : n_in;
  const size_t smem = sizeof(float) * tile_rows *
                      ((wv + 1) + (IN == kMaxIn ? kPitchV : wv));
  crossbar_kernel<IN, S, kFused>
      <<<grid, tile_rows, smem, static_cast<cudaStream_t>(stream)>>>(
          state, v, w, out0, out1, latency, spiked, n, n_in, tile_rows, c);
  return cudaGetLastError();
}

// What the kernels take: n_in in 1..32, tiles of 32..128 rows in steps of
// 32 (one thread a row), 16-byte-aligned v and w.
bool takes(const float* v, const float* w, int n_in, int tile_rows,
           int grid) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(w);
  return n_in >= 1 && n_in <= kMaxIn && tile_rows >= 32 &&
         tile_rows <= kMaxTile && tile_rows % 32 == 0 && grid >= 1 &&
         (bases & 15) == 0;
}

// The calling thread's device, switched only when it differs.
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

int crossbar_target_launch(const float* v, const float* w, float* v_tgt,
                           float* tau, int n, int n_in, int tile_rows,
                           int grid, int device, const XbarConsts* c,
                           void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (!takes(v, w, n_in, tile_rows, grid)) return cudaErrorInvalidValue;
  if (n_in == kMaxIn)
    return launch<kMaxIn, 0, false>(nullptr, v, w, v_tgt, tau, nullptr,
                                    nullptr, n, n_in, tile_rows, grid, *c,
                                    stream);
  return launch<0, 0, false>(nullptr, v, w, v_tgt, tau, nullptr, nullptr, n,
                             n_in, tile_rows, grid, *c, stream);
}

int crossbar_step_launch(const float* state, const float* v, const float* w,
                         float* new_state, float* energy, float* latency,
                         bool* spiked, int n, int n_in, int tile_rows,
                         int grid, int device, const XbarConsts* c,
                         void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (!takes(v, w, n_in, tile_rows, grid)) return cudaErrorInvalidValue;
  const bool wide = n_in == kMaxIn, fixed = c->n_substeps == kSubsteps;
  if (wide && fixed)
    return launch<kMaxIn, kSubsteps, true>(state, v, w, new_state, energy,
                                           latency, spiked, n, n_in,
                                           tile_rows, grid, *c, stream);
  if (wide)
    return launch<kMaxIn, 0, true>(state, v, w, new_state, energy, latency,
                                   spiked, n, n_in, tile_rows, grid, *c,
                                   stream);
  if (fixed)
    return launch<0, kSubsteps, true>(state, v, w, new_state, energy,
                                      latency, spiked, n, n_in, tile_rows,
                                      grid, *c, stream);
  return launch<0, 0, true>(state, v, w, new_state, energy, latency, spiked,
                            n, n_in, tile_rows, grid, *c, stream);
}

}  // extern "C"
