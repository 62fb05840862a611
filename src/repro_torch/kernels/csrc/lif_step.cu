// Golden LIF clock periods: one per launch (lif_step) or a chunk of T
// (lif_chunk).
//
// Replaces: src/repro/kernels/lif_scan.py:lif_step (the pallas_call over
// _period_math), the same math as repro.core.circuits.LIFNeuron.step, and
// lif_scan.py:lif_chunk (its time-looped variant, state resident across
// the chunk).
//
// Bound on the H100: one warp's instruction stream. Each neuron reads 40
// bytes and writes 25 a period, and its 64 substeps are ~1,800
// operations, so even 12,800 neurons are ~23 MFLOP (under a microsecond
// of the card's unfused fp32 rate) against ~0.8 MB of traffic. Every
// substep depends on the last, so a neuron's periods run in order in one
// thread, and a warp's time is its instruction stream: ~19 fp32
// operations a substep (the energy terms are 14 of them) on the fp32 pipe
// and ~10 min / max / compare / select operations on the pipe that
// issues a warp every other cycle, ~40 cycles a substep, well above the
// dependent chain (v + dv) * decay -> clamp -> threshold -> select. An
// empty launch between two CUDA events takes ~5 us on an H100 80GB HBM3
// (700 W), most of a lif_step launch.
//
// Design:
// - A period is a per-neuron setup (lif_setup: everything that depends
//   on the params and the circuit: the leak exponent and its two expf,
//   the thresholds, the reciprocals), a per-tick drive (lif_drive: i_in
//   and the voltage step) and the substeps (lif_period); lif_step runs
//   each once, lif_chunk the setup once a launch.
// - The substep count is compiled in (LIFNeuron().n_substeps = 64), in
//   unrolled groups of kGroup = 32 substeps, each group's spikes a bit
//   mask whose lowest bit is the first spike. A generic instance runs any
//   other count.
// - The substep spends as few min / max / compare / select operations as
//   the reference's values allow (lif_period): the refractory time runs
//   without its clamp, and the spike energy is a predicated add.
// - lif_chunk loads tick t + 1's drive before tick t's substeps, and runs
//   in blocks of one warp. On an H100 80GB HBM3 (700 W) kernel_sweep.py
//   measured 0.0870 ms at N = 12,800, T = 64 and 0.1612 ms at N = 2,000,
//   T = 125, against 0.1265 / 0.2405 for the earlier design (128-thread
//   blocks, the whole period a tick, the first spike kept as an index).
//   The same warps two or four to a block took 0.0965-0.134 /
//   0.182-0.26 ms across development builds, though at N = 12,800
//   one-warp blocks put three or four warps on an SM too. Splitting a
//   neuron's period over a chain warp and an energy warp (32-substep
//   groups through shared memory, named barriers) took 0.161 / 0.273 ms
//   and is not kept: the energy work is not what holds a warp back.
//   Neither is the chain: computing the next substep's (v + dv) * decay
//   beside the threshold test (two operations off the chain) moved
//   neither shape.
// - The prologue's divisions go through quot() (quot.cuh): the card's own
//   division sequence without its per-quotient branch, each quotient
//   under its own range guard.
// - Built with --fmad=false and precise expf: every multiply and add
//   rounds on its own in the order of circuits.py:249-271 and of the plain
//   version (lif_scan._period_math), so each design keeps the first
//   design's bits (chip_smoke.py LIF_DIGESTS). lif_chunk runs the same
//   functions in a loop over ticks, so a chunk equals T lif_step launches
//   bit for bit.

#include <cuda_runtime.h>

#include "quot.cuh"

struct LifConsts {
  int n_substeps;
  float dt, clock_ns, g_syn, c_mem, leak0, ut, vdd, g_static, e_spike;
};

namespace {

constexpr int kSubsteps = 64;     // LIFNeuron().n_substeps, compiled in
constexpr int kThreads = 128;     // rows per block of lif_step
constexpr int kChunkThreads = 32; // rows per block of lif_chunk
constexpr int kGroup = 32;        // substeps unrolled, their spikes a mask
static_assert(kGroup <= 32, "a group's spikes fit a 32-bit mask");

// A neuron's period constants: what depends on its params and the
// circuit, not on the tick's drive. lif_setup computes them once a launch.
struct LifNeuron {
  float v_leak, decay, adap_decay, tau_ref_ns, thresh, adap_gain, c0;
  float r5, r_cmem;     // rcp_newton(5), rcp_newton(c_mem)
  bool ok_cmem;         // divisor_ok(c_mem)
};

// A tick's drive: the substep's voltage step and |i_in|.
struct LifDrive {
  float dv, abs_i;
};

__device__ __forceinline__ LifNeuron lif_setup(const LifConsts& c, float4 p) {
  const float v_leak = p.x, v_th_knob = p.y, v_adap = p.z, v_ref = p.w;
  LifNeuron k;
  k.v_leak = v_leak;
  // the leak exponent (v_leak - 0.5) / ut by quot() or, where it
  // declines, by `/`: either way the IEEE quotient
  bool ok = divisor_ok(c.ut);
  float lr_arg = quot(v_leak - 0.5f, c.ut, rcp_newton(c.ut), ok);
  if (!ok) lr_arg = (v_leak - 0.5f) / c.ut;
  const float leak_rate = c.leak0 * expf(lr_arg) * 1e-9f;
  k.tau_ref_ns = 2.0f + 10.0f * (v_ref - 0.5f);
  k.thresh = 0.8f + 1.0f * (v_th_knob - 0.5f);
  k.adap_gain = 0.15f * (1.0f + 2.0f * (v_adap - 0.5f));
  k.decay = expf(-leak_rate * c.dt);
  k.adap_decay = expf(-c.dt / 8.0f);
  // the clamp of a refractory neuron's 0: the reference clamps after the
  // refractory select, so a refractory neuron ends the substep at c0
  k.c0 = fminf(fmaxf(0.0f, 0.0f), c.vdd);
  k.r5 = rcp_newton(5.0f);
  k.r_cmem = rcp_newton(c.c_mem);
  k.ok_cmem = divisor_ok(c.c_mem);
  return k;
}

// i_in = g_syn w x n / 5 and i_in / c_mem, by quot() or, where it
// declines, by `/`
__device__ __forceinline__ LifDrive lif_drive(const LifConsts& c,
                                              const LifNeuron& k, float w,
                                              float x, float n_spk) {
  const float num = c.g_syn * w * x * n_spk;
  bool ok = k.ok_cmem;
  float i_in = quot(num, 5.0f, k.r5, ok);
  float dv0 = quot(i_in, c.c_mem, k.r_cmem, ok);
  if (!ok) {
    i_in = num / 5.0f;
    dv0 = i_in / c.c_mem;
  }
  return {dv0 * 1e-9f * c.dt, fabsf(i_in)};
}

// A substep's energy from its v_new and fire, added to `energy`. The
// reference adds (fire ? e_spike : 0); the sum of a period starts at +0
// and a sum is -0 only where both terms are, so it is never -0, and adding
// +0 leaves it as it is: only a firing substep adds.
__device__ __forceinline__ void lif_energy(const LifConsts& c,
                                           const LifNeuron& k, float abs_i,
                                           float v_new, bool fire,
                                           float& energy) {
  const float dt = c.dt;
  const float sv = k.v_leak + v_new * 0.3f;
  float e_sub = c.g_static * (sv * sv) * dt * 1e-9f;
  e_sub = e_sub + abs_i * fabsf(v_new) * dt * 1e-9f * 0.5f;
  energy = energy + e_sub;
  if (fire) energy = energy + c.e_spike;
}

// first: 1 + the substep of the first spike, 0 for none; its time is
// (first) * dt, the reference's t_now = (s + 1) * dt at that substep
__device__ __forceinline__ void lif_observe(const LifConsts& c, int first,
                                            float energy, float& out_o,
                                            float& energy_o, float& latency_o,
                                            bool& spiked_o) {
  const bool spiked = first > 0;
  out_o = spiked ? c.vdd : 0.0f;
  energy_o = energy;
  latency_o = spiked ? static_cast<float>(first) * c.dt : c.clock_ns;
  spiked_o = spiked;
}

// One clock period of one neuron in one thread: the state (v, adap, ref)
// advances in place and the period's observables come out. S > 0
// compiles the substep count in; S = 0 reads it from c.
//
// The substep is issue-bound on one warp, and the min / max / compare /
// select pipe issues a warp every other cycle, so the loop spends as few
// of those as the reference's values allow: the refractory time runs as
// r = fire ? tau_ref : r - dt without its clamp at 0 (with dt > 0, r > 0
// exactly when the reference's max(ref - dt, 0) > 0, and r only falls
// between spikes), clamped once at the end of the period; and the spike
// energy is added where a substep fires (lif_energy).
template <int S>
__device__ __forceinline__ void lif_period(const LifConsts& c,
                                           const LifNeuron& k,
                                           const LifDrive& d, float& v,
                                           float& adap, float& ref,
                                           float& out_o, float& energy_o,
                                           float& latency_o, bool& spiked_o) {
  float energy = 0.0f;
  int first = 0;
  float r = ref;
  bool fired = false;     // the last substep fired: ref = tau_ref, unclamped
  static_assert(S % kGroup == 0, "a compiled-in count fills whole groups");
  const int n_sub = S > 0 ? S : c.n_substeps;
#pragma unroll 1
  for (int s0 = 0; s0 < n_sub; s0 += kGroup) {
    unsigned spikes = 0;  // bit j: substep s0 + j fired
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (S == 0 && s0 + j >= n_sub) break;
      const bool in_ref = r > 0.0f;
      const float vc = fminf(fmaxf((v + d.dv) * k.decay, 0.0f), c.vdd);
      const float eff_th = k.thresh + adap * 1.0f;
      const bool fire = (vc >= eff_th) && !in_ref;
      v = fire ? 0.0f : (in_ref ? k.c0 : vc);
      r = fire ? k.tau_ref_ns : r - c.dt;
      adap = adap * k.adap_decay + (fire ? k.adap_gain : 0.0f);
      spikes |= fire ? 1u << j : 0u;
      lif_energy(c, k, d.abs_i, v, fire, energy);
      fired = fire;
    }
    if (first == 0 && spikes != 0u) first = s0 + __ffs(spikes);
  }
  ref = fired ? r : fmaxf(r, 0.0f);
  lif_observe(c, first, energy, out_o, energy_o, latency_o, spiked_o);
}

__device__ __forceinline__ float4 load_params(const float* params, int i) {
  return make_float4(params[4 * i], params[4 * i + 1], params[4 * i + 2],
                     params[4 * i + 3]);
}

template <int S>
__global__ void __launch_bounds__(kThreads)
    lif_step_kernel(const float* __restrict__ state,
                    const float* __restrict__ xin,
                    const float* __restrict__ params,
                    float* __restrict__ new_state, float* __restrict__ out_o,
                    float* __restrict__ energy_o,
                    float* __restrict__ latency_o,
                    bool* __restrict__ spiked_o, int n, LifConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = state[3 * i], adap = state[3 * i + 1], ref = state[3 * i + 2];
  const LifNeuron k = lif_setup(c, load_params(params, i));
  const LifDrive d = lif_drive(c, k, xin[3 * i], xin[3 * i + 1],
                               xin[3 * i + 2]);
  lif_period<S>(c, k, d, v, adap, ref, out_o[i], energy_o[i], latency_o[i],
                spiked_o[i]);
  new_state[3 * i] = v;
  new_state[3 * i + 1] = adap;
  new_state[3 * i + 2] = ref;
}

// T periods in one launch, one thread a neuron (replaces
// lif_scan.py:lif_chunk): the state and the period constants stay in
// registers across the chunk; tick t + 1's drive is loaded before tick
// t's substeps start. With kRecordV, each tick also stores its
// end-of-period V_mem to v_seq[t * n + i] (the golden simulation's
// exposed state); without it the instance is the kernel as it was.
template <int S, bool kRecordV>
__global__ void __launch_bounds__(kChunkThreads)
    lif_chunk_kernel(const float* __restrict__ state,
                     const float* __restrict__ x_seq,
                     const float* __restrict__ params,
                     float* __restrict__ new_state,
                     float* __restrict__ out_o, float* __restrict__ energy_o,
                     float* __restrict__ latency_o,
                     bool* __restrict__ spiked_o, float* __restrict__ v_seq,
                     int n, int t_steps, LifConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = state[3 * i], adap = state[3 * i + 1], ref = state[3 * i + 2];
  const LifNeuron k = lif_setup(c, load_params(params, i));
  float w = x_seq[3 * i], x = x_seq[3 * i + 1], n_spk = x_seq[3 * i + 2];
  for (int t = 0; t < t_steps; ++t) {
    const LifDrive d = lif_drive(c, k, w, x, n_spk);
    if (t + 1 < t_steps) {
      const float* xr = x_seq + 3 * (static_cast<size_t>(t + 1) * n + i);
      w = xr[0];
      x = xr[1];
      n_spk = xr[2];
    }
    const size_t r = static_cast<size_t>(t) * n + i;
    lif_period<S>(c, k, d, v, adap, ref, out_o[r], energy_o[r], latency_o[r],
                  spiked_o[r]);
    if (kRecordV) v_seq[r] = v;
  }
  new_state[3 * i] = v;
  new_state[3 * i + 1] = adap;
  new_state[3 * i + 2] = ref;
}

// quot() and quot_nonneg() (quot.cuh) as the kernels call them, each with
// the `/` its caller falls back to where `ok` is cleared, for
// chip_smoke.py to hold against IEEE division: q = x / d, qn = |x| / d,
// and per pair whether quot (bit 0) and quot_nonneg (bit 1) kept `ok`.
__global__ void quot_check_kernel(const float* __restrict__ x,
                                  const float* __restrict__ d,
                                  float* __restrict__ q,
                                  float* __restrict__ qn,
                                  unsigned char* __restrict__ took, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i], di = d[i], ax = fabsf(xi), r = rcp_newton(di);
  bool ok = divisor_ok(di), ok_n = ok;
  const float a = quot(xi, di, r, ok);
  const float b = quot_nonneg(ax, di, r, ok_n);
  q[i] = ok ? a : xi / di;
  qn[i] = ok_n ? b : ax / di;
  took[i] = static_cast<unsigned char>((ok ? 1 : 0) | (ok_n ? 2 : 0));
}

// The calling thread's device, switched only when it differs: the launch
// path is host-bound, and cudaSetDevice is not free.
cudaError_t use_device(int device) {
  int cur = -1;
  const cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

template <int S>
void lif_chunk_enqueue(const float* state, const float* x_seq,
                       const float* params, float* new_state, float* out,
                       float* energy, float* latency, bool* spiked,
                       float* v_seq, int n, int t_steps, LifConsts c,
                       cudaStream_t s) {
  const int blocks = (n + kChunkThreads - 1) / kChunkThreads;
  if (v_seq)
    lif_chunk_kernel<S, true><<<blocks, kChunkThreads, 0, s>>>(
        state, x_seq, params, new_state, out, energy, latency, spiked,
        v_seq, n, t_steps, c);
  else
    lif_chunk_kernel<S, false><<<blocks, kChunkThreads, 0, s>>>(
        state, x_seq, params, new_state, out, energy, latency, spiked,
        nullptr, n, t_steps, c);
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
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  LifConsts c{n_substeps, dt, clock_ns, g_syn, c_mem, leak0, ut, vdd,
              g_static, e_spike};
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_substeps == kSubsteps)
    lif_step_kernel<kSubsteps><<<blocks, kThreads, 0, s>>>(
        state, xin, params, new_state, out, energy, latency, spiked, n, c);
  else
    lif_step_kernel<0><<<blocks, kThreads, 0, s>>>(
        state, xin, params, new_state, out, energy, latency, spiked, n, c);
  return cudaGetLastError();
}

// v_seq: null, or (t_steps, n) floats for each tick's end-of-period V_mem
int lif_chunk_launch(const float* state, const float* x_seq,
                     const float* params, float* new_state, float* out,
                     float* energy, float* latency, bool* spiked,
                     float* v_seq, int n, int t_steps, int n_substeps,
                     int device, float dt, float clock_ns, float g_syn,
                     float c_mem, float leak0, float ut, float vdd,
                     float g_static, float e_spike, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  LifConsts c{n_substeps, dt, clock_ns, g_syn, c_mem, leak0, ut, vdd,
              g_static, e_spike};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_substeps == kSubsteps)
    lif_chunk_enqueue<kSubsteps>(state, x_seq, params, new_state, out, energy,
                                 latency, spiked, v_seq, n, t_steps, c, s);
  else
    lif_chunk_enqueue<0>(state, x_seq, params, new_state, out, energy,
                         latency, spiked, v_seq, n, t_steps, c, s);
  return cudaGetLastError();
}

int quot_check_launch(const float* x, const float* d, float* q, float* qn,
                      unsigned char* took, int n, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  quot_check_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, d, q, qn, took,
                                                           n);
  return cudaGetLastError();
}

}  // extern "C"
