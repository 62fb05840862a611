// One whole LASANA tick (Algorithm 1: idle catch-up -> active heads ->
// output resolution -> transition heads -> record tail) in one launch.
//
// Replaces: src/repro/kernels/tick_megakernel.py:network_tick (the
// pallas_call over _tick_arrays), reached through wrapper.lasana_step
// whenever the surrogate's five heads pack (mean / linear / 3-layer MLP).
//
// Bound on the H100: operations. With every head an MLP(100, 50), a
// changed row that catches up and emits an event evaluates seven heads,
// ~43 K multiply-adds, against ~70 bytes of state in and out; idle rows
// cost nothing but their copy-through.
//
// Design: the same tiling as mlp_heads.cu. Both head stacks (A: M_ES,
// M_V, M_O at the idle/active width; T: M_ED, M_L at the transition
// width) are staged into shared memory, unpadded, for the whole block
// (~75 KB + ~51 KB for MLP heads). One thread carries one row through the
// tick, evaluating each head at its own family's cost (a mean head is a
// constant, a linear head one dot, an MLP head three layers). The
// reference's lax.cond(any(...)) skips become control flow on the device,
// never a host sync: a block with no changed row copies its rows through
// before staging anything, and inside a block a row runs the idle heads
// only when stale and the transition heads only when its output changed —
// the rows the record tail (_finish_tick) reads them for. Built with
// --fmad=false: everything outside the dot products rounds in the
// reference's order.

#include "heads.cuh"

struct TickIO {
  const float* v;
  const float* o;
  const float* t_last;
  const float* params;  // (N, 4)
  const bool* changed;
  const float* x;       // (N, 3)
  const float* t;       // device scalar: this tick's time
  const float* known;   // annotation mode: behavioral outputs, else null
  float* v_out;
  float* o_out;
  float* tl_out;
  float* e_out;
  float* l_out;
};

// Mirrored field for field by tick_megakernel._TickScalars (ctypes).
struct TickScalars {
  int n, a_heads, t_heads, f_a, f_t, h1, h2;
  int a_off, t_off, a_fam[3], t_fam[2];
  int spiking, annotate, device;
  float clock, out_eps, vdd, half_vdd;
};

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float eval_head(const float* smem,
                                           const repro::Stack& s, int h,
                                           int fam,
                                           const float (&feat)[repro::kMaxF]) {
  const repro::Head hd = repro::head_at(smem, s, h);
  float y;
  if (fam == repro::kMean) {
    y = hd.b2;
  } else {
    float xs[repro::kMaxF];
    repro::standardize(hd, feat, s.f, xs);
    if (fam == repro::kLinear) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < repro::kMaxF; ++k)
        if (k < s.f) acc = __fmaf_rn(xs[k], hd.w0[k * s.h1], acc);
      y = acc + hd.b2;
    } else {
      y = repro::mlp3(hd, xs, s.f, s.h1, s.h2);
    }
  }
  return (y * hd.y_sd + hd.y_mu) / hd.scale;
}

// LIF feature row (x0..x2, v, tau, p0..p3[, o_prev, o_new], drive),
// zero-padded to the stack width: the reference's _features, the
// transition splice, then circuits.augment_features' derived column
// drive = x0 * x1 * x2 / 5, computed from x.
constexpr int kLifIn = 3, kLifP = 4;

__device__ __forceinline__ void lif_features(float (&feat)[repro::kMaxF],
                                             const float (&x)[kLifIn], float v,
                                             float tau, const float (&p)[kLifP],
                                             bool transition, float o_prev,
                                             float o_new) {
#pragma unroll
  for (int k = 0; k < repro::kMaxF; ++k) feat[k] = 0.0f;
  feat[0] = x[0];
  feat[1] = x[1];
  feat[2] = x[2];
  feat[3] = v;
  feat[4] = tau;
#pragma unroll
  for (int k = 0; k < kLifP; ++k) feat[5 + k] = p[k];
  const float drive = x[0] * x[1] * x[2] / 5.0f;
  if (transition) {
    feat[9] = o_prev;
    feat[10] = o_new;
    feat[11] = drive;
  } else {
    feat[9] = drive;
  }
}

__global__ void network_tick_kernel(repro::Stack sa, repro::Stack st,
                                    TickIO io, TickScalars sc) {
  extern __shared__ float smem[];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = r < sc.n;
  const bool changed = valid && io.changed[r];
  if (!__syncthreads_or(changed)) {        // no event in this block
    if (valid) {
      io.v_out[r] = io.v[r];
      io.o_out[r] = io.o[r];
      io.tl_out[r] = io.t_last[r];
      io.e_out[r] = 0.0f;
      io.l_out[r] = 0.0f;
    }
    return;
  }
  float* smem_a = smem;
  float* smem_t = smem + sa.p * repro::head_floats(sa.f, sa.h1, sa.h2);
  repro::stage(sa, smem_a);
  repro::stage(st, smem_t);
  __syncthreads();
  if (!valid) return;
  const float v = io.v[r], o = io.o[r], t_last = io.t_last[r];
  if (!changed) {
    io.v_out[r] = v;
    io.o_out[r] = o;
    io.tl_out[r] = t_last;
    io.e_out[r] = 0.0f;
    io.l_out[r] = 0.0f;
    return;
  }
  const float t = *io.t;
  float x[kLifIn], zero_x[kLifIn] = {0.0f, 0.0f, 0.0f}, p[kLifP];
#pragma unroll
  for (int k = 0; k < kLifIn; ++k) x[k] = io.x[(size_t)r * kLifIn + k];
#pragma unroll
  for (int k = 0; k < kLifP; ++k) p[k] = io.params[(size_t)r * kLifP + k];
  float feat[repro::kMaxF];

  // idle stage (Algorithm 1 lines 3-9): one merged catch-up event
  const bool stale = t_last < t - sc.clock;
  float e_s_idle = 0.0f, v_hat = 0.0f;
  if (stale) {
    const float tau_idle = fmaxf(t - t_last - sc.clock, 0.0f);
    lif_features(feat, zero_x, v, tau_idle, p, false, 0.0f, 0.0f);
    e_s_idle = eval_head(smem_a, sa, sc.a_off, sc.a_fam[0], feat);
    if (!sc.annotate)
      v_hat = eval_head(smem_a, sa, sc.a_off + 1, sc.a_fam[1], feat);
  }

  // active stage (lines 10-22) on the caught-up state
  const float v_cur = (!sc.annotate && stale) ? v_hat : v;
  lif_features(feat, x, v_cur, sc.clock, p, false, 0.0f, 0.0f);
  const float e_s = eval_head(smem_a, sa, sc.a_off, sc.a_fam[0], feat);
  float v_new, o_hat;
  if (sc.annotate) {
    v_new = v_cur;
    o_hat = io.known[r];
  } else {
    v_new = eval_head(smem_a, sa, sc.a_off + 1, sc.a_fam[1], feat);
    o_hat = eval_head(smem_a, sa, sc.a_off + 2, sc.a_fam[2], feat);
  }

  // output resolution (lines 23-25)
  bool out_changed;
  float o_res;
  if (sc.spiking) {
    out_changed = o_hat > sc.half_vdd;
    o_res = out_changed ? sc.vdd : 0.0f;
  } else {
    out_changed = fabsf(o_hat - o) > sc.out_eps;
    o_res = o_hat;
  }

  // transition stage (lines 23-29), only where its heads are read
  float e_d = 0.0f, lat = 0.0f;
  if (out_changed) {
    lif_features(feat, x, v_cur, sc.clock, p, true, o, o_res);
    e_d = eval_head(smem_t, st, sc.t_off, sc.t_fam[0], feat);
    lat = eval_head(smem_t, st, sc.t_off + 1, sc.t_fam[1], feat);
  }

  // record tail (wrapper._finish_tick) for a changed row
  const float e = (stale ? e_s_idle : 0.0f) + (out_changed ? e_d : e_s);
  io.e_out[r] = e;
  io.l_out[r] = out_changed ? lat : 0.0f;
  io.o_out[r] = sc.spiking ? (out_changed ? sc.vdd : 0.0f) : o_hat;
  io.v_out[r] = v_new;
  io.tl_out[r] = t;
}

}  // namespace

extern "C" int network_tick_launch(const float* const* a_stack,
                                   const float* const* t_stack,
                                   const void* const* io_ptrs,
                                   const TickScalars* sc, void* stream) {
  cudaError_t err = cudaSetDevice(sc->device);
  if (err != cudaSuccess) return err;
  if (sc->f_a > repro::kMaxF || sc->f_t > repro::kMaxF ||
      sc->f_a < 10 || sc->f_t < 12 || sc->h1 > repro::kMaxH1)
    return cudaErrorInvalidValue;
  const repro::Stack sa{a_stack[0], a_stack[1], a_stack[2], a_stack[3],
                        a_stack[4], a_stack[5], a_stack[6], a_stack[7],
                        a_stack[8], a_stack[9], a_stack[10], sc->a_heads,
                        sc->f_a, sc->h1, sc->h2};
  const repro::Stack st{t_stack[0], t_stack[1], t_stack[2], t_stack[3],
                        t_stack[4], t_stack[5], t_stack[6], t_stack[7],
                        t_stack[8], t_stack[9], t_stack[10], sc->t_heads,
                        sc->f_t, sc->h1, sc->h2};
  TickIO io;
  io.v = static_cast<const float*>(io_ptrs[0]);
  io.o = static_cast<const float*>(io_ptrs[1]);
  io.t_last = static_cast<const float*>(io_ptrs[2]);
  io.params = static_cast<const float*>(io_ptrs[3]);
  io.changed = static_cast<const bool*>(io_ptrs[4]);
  io.x = static_cast<const float*>(io_ptrs[5]);
  io.t = static_cast<const float*>(io_ptrs[6]);
  io.known = static_cast<const float*>(io_ptrs[7]);
  io.v_out = static_cast<float*>(const_cast<void*>(io_ptrs[8]));
  io.o_out = static_cast<float*>(const_cast<void*>(io_ptrs[9]));
  io.tl_out = static_cast<float*>(const_cast<void*>(io_ptrs[10]));
  io.e_out = static_cast<float*>(const_cast<void*>(io_ptrs[11]));
  io.l_out = static_cast<float*>(const_cast<void*>(io_ptrs[12]));
  const size_t bytes =
      sizeof(float) * (sc->a_heads * repro::head_floats(sc->f_a, sc->h1, sc->h2) +
                       sc->t_heads * repro::head_floats(sc->f_t, sc->h1, sc->h2));
  if (bytes > repro::kMaxSmem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(network_tick_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int blocks = (sc->n + kThreads - 1) / kThreads;
  network_tick_kernel<<<blocks, kThreads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(sa, st, io, *sc);
  return cudaGetLastError();
}
