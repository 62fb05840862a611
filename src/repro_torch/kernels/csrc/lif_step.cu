// Golden LIF clock periods: one per launch (lif_step) or a chunk of T
// (lif_chunk).
//
// Replaces: src/repro/kernels/lif_scan.py:lif_step (the pallas_call over
// _period_math), the same math as repro.core.circuits.LIFNeuron.step, and
// lif_scan.py:lif_chunk (its time-looped variant, state resident across
// the chunk).
//
// Bound on the H100: the launch and the serial chain. Each neuron reads
// 40 bytes and writes 25, and its 64 substeps are ~1,800 operations, so
// even 12,800 neurons are ~23 MFLOP (under a microsecond of the card's
// unfused fp32 rate) against ~0.8 MB of traffic. An empty launch between
// two CUDA events already takes ~5 us on an H100 80GB HBM3 (700 W); the
// rest is one warp's instruction stream, since every substep depends on
// the last: (v + dv) * decay -> clamp -> threshold -> select is 6
// dependent fp32 operations, and the substep issues ~32 instructions in
// all (the energy terms, refractory and adaptation updates), so a period
// is ~2,000 cycles (~1 us) whatever N is.
//
// Design:
// - The substep count is compiled in (LIFNeuron().n_substeps = 64): a
//   loop of constant trip count unrolled by 4, the branches written as
//   selects and the first spike kept as a substep index, so the energy
//   work of one substep issues beside the chain of the next. A generic
//   instance runs any other count.
// - The chain is one operation shorter than the reference's text: the
//   refractory zero is selected after the clamp (its clamp, c0, is taken
//   once), so (v + dv) * decay -> clamp -> threshold -> select. Every
//   value is the one circuits.py:249-271 computes.
// - The prologue's three divisions go through quot() (quot.cuh): the
//   card's own division sequence without its per-quotient branch.
// - One thread per neuron in blocks of 128: at N = 12,800 and below
//   every warp has a warp scheduler to itself at any block size, and a
//   development build that took the block size as an argument found 32
//   and 64 no faster at any main-path shape. Each thread reads its own
//   rows; a block-wide staging of the 12-byte rows through shared memory
//   cost more in synchronisation than it saved.
// - Built with --fmad=false and precise expf: every multiply and add
//   rounds on its own in the order of circuits.py:249-271 and of the plain
//   version (lif_scan._period_math), so the redesign keeps the first
//   design's bits (chip_smoke.py LIF_DIGESTS).
// lif_chunk runs the same period function in a loop over ticks with the
// state in registers, so a chunk equals T lif_step launches bit for bit.

#include <cuda_runtime.h>

#include "quot.cuh"

struct LifConsts {
  int n_substeps;
  float dt, clock_ns, g_syn, c_mem, leak0, ut, vdd, g_static, e_spike;
};

namespace {

constexpr int kSubsteps = 64;     // LIFNeuron().n_substeps, compiled in
constexpr int kThreads = 128;     // rows per block

// One clock period of one neuron: the state (v, adap, ref) advances in
// place and the period's observables come out. S > 0 compiles the
// substep count in; S = 0 reads it from c.
template <int S>
__device__ __forceinline__ void lif_period(const LifConsts& c, float& v,
                                           float& adap, float& ref, float w,
                                           float x, float n_spk, float4 p,
                                           float& out_o, float& energy_o,
                                           float& latency_o, bool& spiked_o) {
  const float dt = c.dt;
  const float v_leak = p.x, v_th_knob = p.y, v_adap = p.z, v_ref = p.w;

  // i_in = g_syn w x n / 5, the leak exponent (v_leak - 0.5) / ut and
  // i_in / c_mem, by quot() or, where it declines, by `/`
  const float num = c.g_syn * w * x * n_spk;
  bool ok = divisor_ok(c.ut) && divisor_ok(c.c_mem);
  float i_in = quot(num, 5.0f, rcp_newton(5.0f), ok);
  float lr_arg = quot(v_leak - 0.5f, c.ut, rcp_newton(c.ut), ok);
  float dv0 = quot(i_in, c.c_mem, rcp_newton(c.c_mem), ok);
  if (!ok) {
    i_in = num / 5.0f;
    lr_arg = (v_leak - 0.5f) / c.ut;
    dv0 = i_in / c.c_mem;
  }
  const float leak_rate = c.leak0 * expf(lr_arg) * 1e-9f;
  const float tau_ref_ns = 2.0f + 10.0f * (v_ref - 0.5f);
  const float thresh = 0.8f + 1.0f * (v_th_knob - 0.5f);
  const float adap_gain = 0.15f * (1.0f + 2.0f * (v_adap - 0.5f));
  const float dv = dv0 * 1e-9f * dt;
  const float decay = expf(-leak_rate * dt);
  const float adap_decay = expf(-dt / 8.0f);
  const float abs_i = fabsf(i_in);

  // the clamp of a refractory neuron's 0: the reference clamps after the
  // refractory select, so a refractory neuron ends the substep at c0
  const float c0 = fminf(fmaxf(0.0f, 0.0f), c.vdd);

  // first: 1 + the substep of the first spike, 0 for none; its time is
  // (first) * dt, the reference's t_now = (s + 1) * dt at that substep
  float energy = 0.0f;
  int first = 0;
  const int n_sub = S > 0 ? S : c.n_substeps;
#pragma unroll 4
  for (int s = 0; s < n_sub; ++s) {
    const bool in_ref = ref > 0.0f;
    const float vc = fminf(fmaxf((v + dv) * decay, 0.0f), c.vdd);
    const float eff_th = thresh + adap * 1.0f;
    const bool fire = (vc >= eff_th) && !in_ref;
    const float v_new = fire ? 0.0f : (in_ref ? c0 : vc);
    ref = fire ? tau_ref_ns : fmaxf(ref - dt, 0.0f);
    adap = adap * adap_decay + (fire ? adap_gain : 0.0f);
    first = (fire && first == 0) ? s + 1 : first;
    const float sv = v_leak + v_new * 0.3f;
    float e_sub = c.g_static * (sv * sv) * dt * 1e-9f;
    e_sub = e_sub + abs_i * fabsf(v_new) * dt * 1e-9f * 0.5f;
    energy = energy + e_sub + (fire ? c.e_spike : 0.0f);
    v = v_new;
  }
  const bool spiked = first > 0;
  out_o = spiked ? c.vdd : 0.0f;
  energy_o = energy;
  latency_o = spiked ? static_cast<float>(first) * dt : c.clock_ns;
  spiked_o = spiked;
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
  const float4 p = make_float4(params[4 * i], params[4 * i + 1],
                               params[4 * i + 2], params[4 * i + 3]);
  lif_period<S>(c, v, adap, ref, xin[3 * i], xin[3 * i + 1], xin[3 * i + 2],
                p, out_o[i], energy_o[i], latency_o[i], spiked_o[i]);
  new_state[3 * i] = v;
  new_state[3 * i + 1] = adap;
  new_state[3 * i + 2] = ref;
}

// T periods in one launch (replaces lif_scan.py:lif_chunk): the neuron's
// state stays in registers across the chunk, x_seq is (T, N, 3) and the
// observables (T, N). Each tick reads 12 bytes and writes 13 per neuron;
// the 64-substep chain per tick is what bounds it, as for lif_step.
template <int S>
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
  const float4 p = make_float4(params[4 * i], params[4 * i + 1],
                               params[4 * i + 2], params[4 * i + 3]);
  for (int t = 0; t < t_steps; ++t) {
    const size_t r = static_cast<size_t>(t) * n + i;
    const float* xr = x_seq + 3 * r;
    lif_period<S>(c, v, adap, ref, xr[0], xr[1], xr[2], p, out_o[r],
                  energy_o[r], latency_o[r], spiked_o[r]);
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

int lif_chunk_launch(const float* state, const float* x_seq,
                     const float* params, float* new_state, float* out,
                     float* energy, float* latency, bool* spiked, int n,
                     int t_steps, int n_substeps, int device, float dt,
                     float clock_ns, float g_syn, float c_mem, float leak0,
                     float ut, float vdd, float g_static, float e_spike,
                     void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  LifConsts c{n_substeps, dt, clock_ns, g_syn, c_mem, leak0, ut, vdd,
              g_static, e_spike};
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_substeps == kSubsteps)
    lif_chunk_kernel<kSubsteps><<<blocks, kThreads, 0, s>>>(
        state, x_seq, params, new_state, out, energy, latency, spiked, n,
        t_steps, c);
  else
    lif_chunk_kernel<0><<<blocks, kThreads, 0, s>>>(
        state, x_seq, params, new_state, out, energy, latency, spiked, n,
        t_steps, c);
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
