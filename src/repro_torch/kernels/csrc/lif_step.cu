// Golden LIF clock periods: one per launch (lif_step) or a chunk of T
// (lif_chunk).
//
// Replaces: src/repro/kernels/lif_scan.py:lif_step (the pallas_call over
// _period_math), the same math as repro.core.circuits.LIFNeuron.step, and
// lif_scan.py:lif_chunk (its time-looped variant, state resident across
// the chunk).
//
// Bound on the H100: operations. Each neuron reads 40 bytes and writes
// 25, but runs 64 dependent substeps of about 30 fp32 operations each, so
// at 12,800 neurons the work is ~25 MFLOP against ~0.8 MB of traffic; the
// sequential substep chain (and, at these sizes, the launch) is what
// takes the time, not memory.
//
// Design: one thread per neuron, the whole substep loop in registers, the
// per-neuron constants (input current, leak decay, refractory time,
// threshold, adaptation gain) hoisted out of the loop as _period_math
// does. Built with --fmad=false and precise expf, so every multiply and
// add rounds on its own in the order of circuits.py:249-271 and the plain
// PyTorch version (lif_scan._period_math) matches it. lif_chunk wraps the
// same period function in a loop over ticks with the state in registers.

#include <cuda_runtime.h>

namespace {

struct LifConsts {
  int n_substeps;
  float dt, clock_ns, g_syn, c_mem, leak0, ut, vdd, g_static, e_spike;
};

// One clock period of one neuron: the state (v, adap, ref) advances in
// place and the period's observables come out. Both kernels below call
// this one function, so a chunk of T periods equals T lif_step launches
// bit for bit.
__device__ __forceinline__ void lif_period(const LifConsts& c, float& v,
                                           float& adap, float& ref,
                                           const float* xin, const float* p,
                                           float& out_o, float& energy_o,
                                           float& latency_o, bool& spiked_o) {
  const float dt = c.dt;
  const float w = xin[0], x = xin[1], n_spk = xin[2];
  const float v_leak = p[0], v_th_knob = p[1];
  const float v_adap = p[2], v_ref = p[3];

  const float i_in = c.g_syn * w * x * n_spk / 5.0f;
  const float leak_rate = c.leak0 * expf((v_leak - 0.5f) / c.ut) * 1e-9f;
  const float tau_ref_ns = 2.0f + 10.0f * (v_ref - 0.5f);
  const float thresh = 0.8f + 1.0f * (v_th_knob - 0.5f);
  const float adap_gain = 0.15f * (1.0f + 2.0f * (v_adap - 0.5f));
  const float dv = i_in / c.c_mem * 1e-9f * dt;
  const float decay = expf(-leak_rate * dt);
  const float adap_decay = expf(-dt / 8.0f);
  const float abs_i = fabsf(i_in);

  float out = 0.0f, energy = 0.0f, t_spk = -1.0f;
  for (int s = 0; s < c.n_substeps; ++s) {
    const bool in_ref = ref > 0.0f;
    float v_new = in_ref ? 0.0f : (v + dv) * decay;
    v_new = fminf(fmaxf(v_new, 0.0f), c.vdd);
    const float eff_th = thresh + adap * 1.0f;
    const bool fire = (v_new >= eff_th) && !in_ref;
    if (fire) v_new = 0.0f;
    ref = fire ? tau_ref_ns : fmaxf(ref - dt, 0.0f);
    adap = adap * adap_decay + (fire ? adap_gain : 0.0f);
    if (fire) out = c.vdd;
    const float t_now = (float)(s + 1) * dt;
    if (fire && t_spk < 0.0f) t_spk = t_now;
    const float sv = v_leak + v_new * 0.3f;
    float e_sub = c.g_static * (sv * sv) * dt * 1e-9f;
    e_sub = e_sub + abs_i * fabsf(v_new) * dt * 1e-9f * 0.5f;
    energy = energy + e_sub + (fire ? c.e_spike : 0.0f);
    v = v_new;
  }
  const bool spiked = t_spk > 0.0f;
  out_o = out;
  energy_o = energy;
  latency_o = spiked ? t_spk : c.clock_ns;
  spiked_o = spiked;
}

__global__ void lif_step_kernel(const float* __restrict__ state,
                                const float* __restrict__ xin,
                                const float* __restrict__ params,
                                float* __restrict__ new_state,
                                float* __restrict__ out_o,
                                float* __restrict__ energy_o,
                                float* __restrict__ latency_o,
                                bool* __restrict__ spiked_o, int n,
                                LifConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = state[3 * i], adap = state[3 * i + 1], ref = state[3 * i + 2];
  lif_period(c, v, adap, ref, xin + 3 * i, params + 4 * i, out_o[i],
             energy_o[i], latency_o[i], spiked_o[i]);
  new_state[3 * i] = v;
  new_state[3 * i + 1] = adap;
  new_state[3 * i + 2] = ref;
}

// T periods in one launch (replaces lif_scan.py:lif_chunk): the neuron's
// state stays in registers across the chunk, x_seq is (T, N, 3) and the
// observables (T, N). Each tick reads 12 bytes and writes 13 per neuron;
// the 64-substep chain per tick is what bounds it, as for lif_step.
__global__ void lif_chunk_kernel(const float* __restrict__ state,
                                 const float* __restrict__ x_seq,
                                 const float* __restrict__ params,
                                 float* __restrict__ new_state,
                                 float* __restrict__ out_o,
                                 float* __restrict__ energy_o,
                                 float* __restrict__ latency_o,
                                 bool* __restrict__ spiked_o, int n,
                                 int t_steps, LifConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = state[3 * i], adap = state[3 * i + 1], ref = state[3 * i + 2];
  float p[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) p[k] = params[4 * i + k];
  for (int t = 0; t < t_steps; ++t) {
    const size_t r = static_cast<size_t>(t) * n + i;
    lif_period(c, v, adap, ref, x_seq + 3 * r, p, out_o[r], energy_o[r],
               latency_o[r], spiked_o[r]);
  }
  new_state[3 * i] = v;
  new_state[3 * i + 1] = adap;
  new_state[3 * i + 2] = ref;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int lif_step_launch(const float* state, const float* xin, const float* params,
                    float* new_state, float* out, float* energy,
                    float* latency, bool* spiked, int n, int n_substeps,
                    int device, float dt, float clock_ns, float g_syn,
                    float c_mem, float leak0, float ut, float vdd,
                    float g_static, float e_spike, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  LifConsts c{n_substeps, dt, clock_ns, g_syn, c_mem, leak0, ut, vdd,
              g_static, e_spike};
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  lif_step_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      state, xin, params, new_state, out, energy, latency, spiked, n, c);
  return cudaGetLastError();
}

int lif_chunk_launch(const float* state, const float* x_seq,
                     const float* params, float* new_state, float* out,
                     float* energy, float* latency, bool* spiked, int n,
                     int t_steps, int n_substeps, int device, float dt,
                     float clock_ns, float g_syn, float c_mem, float leak0,
                     float ut, float vdd, float g_static, float e_spike,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  LifConsts c{n_substeps, dt, clock_ns, g_syn, c_mem, leak0, ut, vdd,
              g_static, e_spike};
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  lif_chunk_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      state, x_seq, params, new_state, out, energy, latency, spiked, n,
      t_steps, c);
  return cudaGetLastError();
}

}  // extern "C"
