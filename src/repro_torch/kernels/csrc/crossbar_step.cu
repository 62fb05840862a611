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
// and writes 8-13 B; its 32-term dot is ~100 operations and the settling
// loop ~15 per substep, ~1,100 in all, about 4 operations per byte, far
// left of the fp32 ridge point (67 TFLOP/s over 3.35 TB/s = 20).
//
// Design: one thread per row, 128 rows per block. The block first copies
// its rows of v and w into shared memory with consecutive threads on
// consecutive addresses (the rows are 128 and 132 bytes long, so a thread
// reading its own row straight from device memory would touch a new cache
// line at every step); the tiles keep a pitch of 33 floats, so a warp
// reading one column hits 32 different banks. Each thread then sums its
// row in index order, one rounding per term, which is the order of the
// reference's XLA reduction, and runs the settling loop in registers.
// Built with --fmad=false and precise tanhf/expf, so every operation rounds
// as the plain version (kernels/crossbar_mvm.py) does.

#include <cuda_runtime.h>

struct XbarConsts {  // mirrored by crossbar_mvm._XbarConsts (ctypes)
  int n_substeps;
  float g_unit, g_leak, neg_r_f, v_sat, c_load, tau_base, v_bias;
  float neg_dt, dt, dt_s, clock_ns;
};

namespace {

constexpr int kMaxIn = 32;        // inputs per row the tiles hold
constexpr int kRows = 128;        // rows per block, one per thread
constexpr int kPitch = kMaxIn + 1;

// rows r0 .. r0+rows-1 of a (N, width) matrix into a kPitch-strided tile
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int r0, int rows, int width,
                                          float* tile) {
  const size_t base = static_cast<size_t>(r0) * width;
  const int count = rows * width;
  for (int e = threadIdx.x; e < count; e += blockDim.x)
    tile[(e / width) * kPitch + e % width] = src[base + e];
}

__device__ __forceinline__ void row_target(const float* v, const float* w,
                                           int n_in, const XbarConsts& c,
                                           float& v_tgt, float& tau) {
  float acc = 0.0f, load = 0.0f;
  for (int k = 0; k < n_in; ++k) {
    acc = acc + w[k] * v[k];
    load = load + fabsf(w[k]);
  }
  const float i_sig = c.g_unit * (acc + w[n_in] * c.v_bias);
  const float v_lin = c.neg_r_f * i_sig;
  v_tgt = c.v_sat * tanhf(v_lin / c.v_sat);
  tau = c.tau_base * (1.0f + 0.5f * (load / static_cast<float>(n_in)));
}

__global__ void crossbar_target_kernel(const float* __restrict__ v,
                                       const float* __restrict__ w,
                                       float* __restrict__ v_tgt,
                                       float* __restrict__ tau, int n,
                                       int n_in, XbarConsts c) {
  __shared__ float tv[kRows * kPitch];
  __shared__ float tw[kRows * kPitch];
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - r0);
  load_tile(v, r0, rows, n_in, tv);
  load_tile(w, r0, rows, n_in + 1, tw);
  __syncthreads();
  if (threadIdx.x >= rows) return;
  const int r = r0 + threadIdx.x;
  float t, p;
  row_target(tv + threadIdx.x * kPitch, tw + threadIdx.x * kPitch, n_in, c,
             t, p);
  v_tgt[r] = t;
  tau[r] = p;
}

__global__ void crossbar_step_kernel(const float* __restrict__ state,
                                     const float* __restrict__ v,
                                     const float* __restrict__ w,
                                     float* __restrict__ new_state,
                                     float* __restrict__ energy_o,
                                     float* __restrict__ latency_o,
                                     bool* __restrict__ spiked_o, int n,
                                     int n_in, XbarConsts c) {
  __shared__ float tv[kRows * kPitch];
  __shared__ float tw[kRows * kPitch];
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - r0);
  load_tile(v, r0, rows, n_in, tv);
  load_tile(w, r0, rows, n_in + 1, tw);
  __syncthreads();
  if (threadIdx.x >= rows) return;
  const int r = r0 + threadIdx.x;
  const float* vr = tv + threadIdx.x * kPitch;
  const float* wr = tw + threadIdx.x * kPitch;
  float v_tgt, tau;
  row_target(vr, wr, n_in, c, v_tgt, tau);
  // resistive power: signal path + parasitic leak (W), summed in order
  float p_res = 0.0f;
  for (int k = 0; k < n_in; ++k) {
    const float g_row = fabsf(wr[k]) * c.g_unit + c.g_leak;
    p_res = p_res + (vr[k] * vr[k]) * g_row;
  }
  const float v0 = state[r];
  const float a = expf(c.neg_dt / tau);
  const float band = 0.1f * fabsf(v_tgt - v0) + 1e-6f;
  float vv = v0, energy = 0.0f, t90 = -1.0f;
  for (int i = 0; i < c.n_substeps; ++i) {
    const float v_new = v_tgt + (vv - v_tgt) * a;
    const float p_cap = c.c_load * fabsf(v_new - vv) / c.dt_s * fabsf(v_new);
    energy = energy + (p_cap + p_res) * c.dt * 1e-9f;
    if (t90 < 0.0f && fabsf(v_new - v_tgt) <= band)
      t90 = static_cast<float>(i + 1) * c.dt;
    vv = v_new;
  }
  new_state[r] = vv;
  energy_o[r] = energy;
  latency_o[r] = t90 < 0.0f ? c.clock_ns : t90;
  spiked_o[r] = fabsf(vv - v0) > 0.02f;
}

int blocks_for(int n) { return (n + kRows - 1) / kRows; }

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int crossbar_target_launch(const float* v, const float* w, float* v_tgt,
                           float* tau, int n, int n_in, int device,
                           const XbarConsts* c, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_in < 1 || n_in > kMaxIn) return cudaErrorInvalidValue;
  crossbar_target_kernel<<<blocks_for(n), kRows, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      v, w, v_tgt, tau, n, n_in, *c);
  return cudaGetLastError();
}

int crossbar_step_launch(const float* state, const float* v, const float* w,
                         float* new_state, float* energy, float* latency,
                         bool* spiked, int n, int n_in, int device,
                         const XbarConsts* c, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_in < 1 || n_in > kMaxIn) return cudaErrorInvalidValue;
  crossbar_step_kernel<<<blocks_for(n), kRows, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      state, v, w, new_state, energy, latency, spiked, n, n_in, *c);
  return cudaGetLastError();
}

}  // extern "C"
