// One golden LIF clock period per neuron.
//
// Replaces: src/repro/kernels/lif_scan.py:lif_step (the pallas_call over
// _period_math), the same math as repro.core.circuits.LIFNeuron.step.
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
// PyTorch version (lif_scan._period_math) matches it.

#include <cuda_runtime.h>

namespace {

struct LifConsts {
  int n_substeps;
  float dt, clock_ns, g_syn, c_mem, leak0, ut, vdd, g_static, e_spike;
};

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
  const float dt = c.dt;
  float v = state[3 * i], adap = state[3 * i + 1], ref = state[3 * i + 2];
  const float w = xin[3 * i], x = xin[3 * i + 1], n_spk = xin[3 * i + 2];
  const float v_leak = params[4 * i], v_th_knob = params[4 * i + 1];
  const float v_adap = params[4 * i + 2], v_ref = params[4 * i + 3];

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
  new_state[3 * i] = v;
  new_state[3 * i + 1] = adap;
  new_state[3 * i + 2] = ref;
  out_o[i] = out;
  energy_o[i] = energy;
  latency_o[i] = spiked ? t_spk : c.clock_ns;
  spiked_o[i] = spiked;
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

}  // extern "C"
