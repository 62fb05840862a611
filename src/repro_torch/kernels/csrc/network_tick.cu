// One whole LASANA tick (Algorithm 1: idle catch-up -> active heads ->
// output resolution -> transition heads -> record tail) in one launch,
// and a chunk of T such ticks in one launch.
//
// Replaces: src/repro/kernels/tick_megakernel.py:network_tick (the
// pallas_call over _tick_arrays), reached through wrapper.lasana_step
// whenever the surrogate's five heads pack (mean / linear / 3-layer MLP);
// and tick_megakernel.py:network_tick_chunk (its time-looped variant, v /
// o / t_last resident across the chunk), reached through the engine's
// single-LIF-layer fast path (network.NetworkEngine._chunk_fast_path).
//
// Bound on the H100: operations. With every head an MLP(100, 50), a
// changed row that catches up and emits an event evaluates seven heads,
// ~43 K multiply-adds for a LIF row (F = 10/12) and ~55 K for a crossbar
// row (F = 68/70), against ~70 bytes of LIF state in and out or ~330 bytes
// of crossbar inputs and weights; idle rows cost nothing but their
// copy-through.
//
// Design: one thread carries one row through the tick, evaluating each
// head at its own family's cost (a mean head is a constant, a linear head
// one dot, an MLP head three layers). The circuit kind is a template
// parameter (LIF: 3 inputs, 4 parameters, drive = x0 x1 x2 / 5; crossbar:
// 32 inputs, 33 weights, i_sig = w . x + bias * v_bias), so the feature
// row's layout is known at compile time; a LIF row's features stay in
// registers, a crossbar row's spill to local memory. Only the launching
// kind's own heads are staged, at its own width (a cross-kind pack pads
// every head to the widest kind; those columns are zero weights and are
// skipped). When both stacks fit in a block's shared memory (LIF: 75 KB
// + 51 KB) they are staged together up front; when they do not (crossbar
// MLP heads: 146 KB + 99 KB) they go through ONE buffer in two phases:
// the A stack (M_ES, M_V, M_O) for the idle and active stages, then,
// after a block-wide barrier, the T stack (M_ED, M_L) for the transition
// stage. The reference's
// lax.cond(any(...)) skips become control flow on the device, never a
// host sync: a block with no changed row copies its rows through before
// staging anything, a two-phase block in which no row's output changed
// never stages the T stack, and a row runs the idle heads only when stale and the
// transition heads only when its output changed — the rows the record
// tail (_finish_tick) reads them for. Built with --fmad=false: everything
// outside the dot products rounds in the reference's order.

#include "heads.cuh"

struct TickIO {
  const float* v;
  const float* o;
  const float* t_last;
  const float* params;  // (N, n_p)
  const bool* changed;
  const float* x;       // (N, n_in)
  const float* t;       // device scalar: this tick's time
  const float* known;   // annotation mode: behavioral outputs, else null
  float* v_out;
  float* o_out;
  float* tl_out;
  float* e_out;
  float* l_out;
};

struct ChunkIO {
  const float* v;
  const float* o;
  const float* t_last;
  const float* params;  // (N, n_p)
  const bool* changed;  // (T, N)
  const float* x;       // (T, N, n_in)
  const float* t;       // (T,) tick times
  float* v_out;
  float* o_out;
  float* tl_out;
  float* o_seq;         // (T, N)
  float* e_seq;
  float* l_seq;
};

// Mirrored field for field by tick_megakernel._TickScalars (ctypes).
struct TickScalars {
  int n, a_heads, t_heads, f_a, f_t, h1, h2;
  int a_off, t_off, a_fam[3], t_fam[2];
  int circuit, n_in, n_p;
  int spiking, annotate, device;
  float clock, out_eps, vdd, half_vdd, v_bias;
};

namespace {

constexpr int kThreads = 128;
constexpr int kAHeads = 3;  // M_ES, M_V, M_O
constexpr int kTHeads = 2;  // M_ED, M_L

// Feature rows (x[0..kIn), v, tau, p[0..kP)[, o_prev, o_new], derived): the
// reference's _features, the transition splice, then
// circuits.augment_features' derived column, computed from x and p.
struct LifRow {
  static constexpr int kCode = 0, kIn = 3, kP = 4, kF = repro::kNarrowF;
  static constexpr int kFa = kIn + 2 + kP + 1;  // idle/active width
  __device__ static float derived(const float* x, const float* p, float) {
    return x[0] * x[1] * x[2] / 5.0f;
  }
};

struct XbarRow {
  static constexpr int kCode = 1, kIn = 32, kP = 33, kF = repro::kWideF;
  static constexpr int kFa = kIn + 2 + kP + 1;
  // w . x + bias * v_bias, summed in index order (no g_unit)
  __device__ static float derived(const float* x, const float* p,
                                  float v_bias) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kIn; ++k) acc = acc + p[k] * x[k];
    return acc + p[kIn] * v_bias;
  }
};

template <class Row>
__device__ __forceinline__ void features(float (&feat)[Row::kF],
                                         const float* x, const float* p,
                                         float v, float tau, bool transition,
                                         float o_prev, float o_new,
                                         float v_bias) {
  constexpr int base = Row::kIn + 2 + Row::kP;
#pragma unroll
  for (int k = 0; k < Row::kF; ++k) feat[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < Row::kIn; ++k) feat[k] = x[k];
  feat[Row::kIn] = v;
  feat[Row::kIn + 1] = tau;
#pragma unroll
  for (int k = 0; k < Row::kP; ++k) feat[Row::kIn + 2 + k] = p[k];
  const float d = Row::derived(x, p, v_bias);
  if (transition) {
    feat[base] = o_prev;
    feat[base + 1] = o_new;
    feat[base + 2] = d;
  } else {
    feat[base] = d;
  }
}

template <int KF>
__device__ __forceinline__ float eval_head(const float* smem,
                                           const repro::Stack& s, int j,
                                           int fam, int f,
                                           const float (&feat)[KF]) {
  const repro::Head hd = repro::head_at(smem, s, j);
  float y;
  if (fam == repro::kMean) {
    y = hd.b2;
  } else {
    float xs[KF];
    repro::standardize(hd, feat, f, xs);
    y = fam == repro::kLinear ? repro::linear(hd, xs, f, s.h1)
                              : repro::mlp3(hd, xs, f, s.h1, s.h2);
  }
  return (y * hd.y_sd + hd.y_mu) / hd.scale;
}

// What the idle, active and output-resolution stages leave for the
// transition stage and the record tail, for one changed row.
struct RowTick {
  float v_cur, v_new, o_hat, o_res, e_s_idle, e_s;
  bool stale, out_changed;
};

// Algorithm 1 lines 3-25 for one changed row: the idle catch-up (merged
// E2 event), the active heads on the caught-up state and the output
// resolution. The A stack's heads are staged at smem.
template <class Row>
__device__ __forceinline__ RowTick active_stage(const float* smem,
                                                const repro::Stack& sa,
                                                const TickScalars& sc,
                                                const float* x, const float* p,
                                                float v, float o, float t_last,
                                                float t, float known) {
  constexpr int FA = Row::kFa;
  float feat[Row::kF];
  RowTick rt;
  rt.e_s_idle = 0.0f;
  // idle stage (Algorithm 1 lines 3-9): one merged catch-up event
  rt.stale = t_last < t - sc.clock;
  float v_hat = 0.0f;
  if (rt.stale) {
    const float zero_x[Row::kIn] = {};
    const float tau_idle = fmaxf(t - t_last - sc.clock, 0.0f);
    features<Row>(feat, zero_x, p, v, tau_idle, false, 0.0f, 0.0f,
                  sc.v_bias);
    rt.e_s_idle = eval_head(smem, sa, 0, sc.a_fam[0], FA, feat);
    if (!sc.annotate) v_hat = eval_head(smem, sa, 1, sc.a_fam[1], FA, feat);
  }

  // active stage (lines 10-22) on the caught-up state
  rt.v_cur = (!sc.annotate && rt.stale) ? v_hat : v;
  features<Row>(feat, x, p, rt.v_cur, sc.clock, false, 0.0f, 0.0f,
                sc.v_bias);
  rt.e_s = eval_head(smem, sa, 0, sc.a_fam[0], FA, feat);
  if (sc.annotate) {
    rt.v_new = rt.v_cur;
    rt.o_hat = known;
  } else {
    rt.v_new = eval_head(smem, sa, 1, sc.a_fam[1], FA, feat);
    rt.o_hat = eval_head(smem, sa, 2, sc.a_fam[2], FA, feat);
  }

  // output resolution (lines 23-25)
  if (sc.spiking) {
    rt.out_changed = rt.o_hat > sc.half_vdd;
    rt.o_res = rt.out_changed ? sc.vdd : 0.0f;
  } else {
    rt.out_changed = fabsf(rt.o_hat - o) > sc.out_eps;
    rt.o_res = rt.o_hat;
  }
  return rt;
}

// Transition heads (lines 23-29) of a row whose output changed; the T
// stack's heads are staged at smem_t. Returns (e_d, latency).
template <class Row>
__device__ __forceinline__ void transition_stage(const float* smem_t,
                                                 const repro::Stack& st,
                                                 const TickScalars& sc,
                                                 const float* x, const float* p,
                                                 float o, const RowTick& rt,
                                                 float& e_d, float& lat) {
  constexpr int FT = Row::kFa + 2;
  float feat[Row::kF];
  features<Row>(feat, x, p, rt.v_cur, sc.clock, true, o, rt.o_res,
                sc.v_bias);
  e_d = eval_head(smem_t, st, 0, sc.t_fam[0], FT, feat);
  lat = eval_head(smem_t, st, 1, sc.t_fam[1], FT, feat);
}

// Record tail (wrapper._finish_tick) of a changed row: its new v, o,
// t_last and this tick's energy and latency.
__device__ __forceinline__ void record_tail(const TickScalars& sc,
                                            const RowTick& rt, float e_d,
                                            float lat, float t, float& v,
                                            float& o, float& t_last, float& e,
                                            float& l) {
  e = (rt.stale ? rt.e_s_idle : 0.0f) + (rt.out_changed ? e_d : rt.e_s);
  l = rt.out_changed ? lat : 0.0f;
  o = sc.spiking ? (rt.out_changed ? sc.vdd : 0.0f) : rt.o_hat;
  v = rt.v_new;
  t_last = t;
}

template <class Row>
__global__ void network_tick_kernel(repro::Stack sa, repro::Stack st,
                                    TickIO io, TickScalars sc, int t_base) {
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
  // t_base > 0: the T stack sits after the A stack, staged now
  repro::stage(sa, sc.a_off, kAHeads, smem);
  if (t_base > 0) repro::stage(st, sc.t_off, kTHeads, smem + t_base);
  __syncthreads();

  float v = 0.0f, o = 0.0f, t_last = 0.0f, t = 0.0f;
  const float* x = io.x + static_cast<size_t>(r) * Row::kIn;
  const float* p = io.params + static_cast<size_t>(r) * Row::kP;
  if (valid) {
    v = io.v[r];
    o = io.o[r];
    t_last = io.t_last[r];
  }
  RowTick rt{};
  if (changed) {
    t = *io.t;
    rt = active_stage<Row>(smem, sa, sc, x, p, v, o, t_last, t,
                           sc.annotate ? io.known[r] : 0.0f);
  }

  // transition stage (lines 23-29), only where its heads are read; in
  // two phases the barrier also ends every read of the A stack before T
  // overwrites it (t_base is the same for the whole block)
  float e_d = 0.0f, lat = 0.0f;
  if (t_base > 0 || __syncthreads_or(rt.out_changed)) {
    if (t_base == 0) {
      repro::stage(st, sc.t_off, kTHeads, smem);
      __syncthreads();
    }
    if (rt.out_changed)
      transition_stage<Row>(smem + t_base, st, sc, x, p, o, rt, e_d, lat);
  }
  if (!valid) return;
  float e = 0.0f, l = 0.0f;
  if (changed) record_tail(sc, rt, e_d, lat, t, v, o, t_last, e, l);
  io.v_out[r] = v;
  io.o_out[r] = o;
  io.tl_out[r] = t_last;
  io.e_out[r] = e;
  io.l_out[r] = l;
}

// T ticks of network_tick_kernel in one launch (replaces
// tick_megakernel.py:network_tick_chunk), LIF rows, standalone mode. Both
// stacks are staged once, up front; v, o and t_last stay in registers
// across the chunk, and each tick runs the same stage functions as
// network_tick_kernel, so the chunk equals T network_tick launches bit for
// bit. With both stacks staged before the tick loop, no barrier sits
// inside it: a row with no event this tick writes the copy-through that
// network_tick writes for it (o, e = 0, l = 0), and padding rows past N
// only helped stage.
template <class Row>
__global__ void network_tick_chunk_kernel(repro::Stack sa, repro::Stack st,
                                          ChunkIO io, TickScalars sc,
                                          int t_base, int t_steps) {
  extern __shared__ float smem[];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = r < sc.n;
  repro::stage(sa, sc.a_off, kAHeads, smem);
  repro::stage(st, sc.t_off, kTHeads, smem + t_base);
  __syncthreads();

  float v = 0.0f, o = 0.0f, t_last = 0.0f;
  float p[Row::kP];
#pragma unroll
  for (int k = 0; k < Row::kP; ++k)
    p[k] = valid ? io.params[static_cast<size_t>(r) * Row::kP + k] : 0.0f;
  if (valid) {
    v = io.v[r];
    o = io.o[r];
    t_last = io.t_last[r];
  }
  for (int k = 0; k < t_steps; ++k) {
    const size_t i = static_cast<size_t>(k) * sc.n + r;
    const bool changed = valid && io.changed[i];
    float e = 0.0f, l = 0.0f;
    if (changed) {
      const float t = io.t[k];
      const float* x = io.x + i * Row::kIn;
      const RowTick rt = active_stage<Row>(smem, sa, sc, x, p, v, o, t_last,
                                           t, 0.0f);
      float e_d = 0.0f, lat = 0.0f;
      if (rt.out_changed)
        transition_stage<Row>(smem + t_base, st, sc, x, p, o, rt, e_d, lat);
      record_tail(sc, rt, e_d, lat, t, v, o, t_last, e, l);
    }
    if (valid) {
      io.o_seq[i] = o;
      io.e_seq[i] = e;
      io.l_seq[i] = l;
    }
  }
  if (valid) {
    io.v_out[r] = v;
    io.o_out[r] = o;
    io.tl_out[r] = t_last;
  }
}

template <class Row>
cudaError_t launch(const repro::Stack& sa, const repro::Stack& st,
                   const TickIO& io, const TickScalars& sc,
                   cudaStream_t stream) {
  constexpr int FA = Row::kFa;
  if (sc.n_in != Row::kIn || sc.n_p != Row::kP || sc.f_a < FA ||
      sc.f_t < FA + 2 || sc.h1 > repro::kMaxH1 ||
      sc.a_off + kAHeads > sc.a_heads || sc.t_off + kTHeads > sc.t_heads)
    return cudaErrorInvalidValue;
  repro::Stack a = sa, t = st;
  a.fs = FA;
  t.fs = FA + 2;
  const size_t per_a = kAHeads * repro::head_floats(a.fs, sc.h1, sc.h2);
  const size_t per_t = kTHeads * repro::head_floats(t.fs, sc.h1, sc.h2);
  const bool together = sizeof(float) * (per_a + per_t) <= repro::kMaxSmem;
  const size_t bytes = sizeof(float) * (together ? per_a + per_t
                                        : (per_a > per_t ? per_a : per_t));
  if (bytes > repro::kMaxSmem) return cudaErrorInvalidValue;
  const int t_base = together ? static_cast<int>(per_a) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      network_tick_kernel<Row>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int blocks = (sc.n + kThreads - 1) / kThreads;
  network_tick_kernel<Row><<<blocks, kThreads, bytes, stream>>>(a, t, io, sc,
                                                                 t_base);
  return cudaGetLastError();
}

template <class Row>
cudaError_t launch_chunk(const repro::Stack& sa, const repro::Stack& st,
                         const ChunkIO& io, const TickScalars& sc,
                         int t_steps, cudaStream_t stream) {
  constexpr int FA = Row::kFa;
  if (sc.n_in != Row::kIn || sc.n_p != Row::kP || sc.f_a < FA ||
      sc.f_t < FA + 2 || sc.h1 > repro::kMaxH1 || sc.annotate ||
      sc.a_off + kAHeads > sc.a_heads || sc.t_off + kTHeads > sc.t_heads)
    return cudaErrorInvalidValue;
  repro::Stack a = sa, t = st;
  a.fs = FA;
  t.fs = FA + 2;
  const size_t per_a = kAHeads * repro::head_floats(a.fs, sc.h1, sc.h2);
  const size_t per_t = kTHeads * repro::head_floats(t.fs, sc.h1, sc.h2);
  const size_t bytes = sizeof(float) * (per_a + per_t);
  if (bytes > repro::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      network_tick_chunk_kernel<Row>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int blocks = (sc.n + kThreads - 1) / kThreads;
  network_tick_chunk_kernel<Row><<<blocks, kThreads, bytes, stream>>>(
      a, t, io, sc, static_cast<int>(per_a), t_steps);
  return cudaGetLastError();
}

repro::Stack make_stack(const float* const* arr, int p, int f, int h1,
                        int h2) {
  return repro::Stack{arr[0], arr[1], arr[2], arr[3], arr[4], arr[5],
                      arr[6], arr[7], arr[8], arr[9], arr[10], p, f, h1, h2,
                      f};
}

}  // namespace

extern "C" int network_tick_chunk_launch(const float* const* a_stack,
                                         const float* const* t_stack,
                                         const void* const* io_ptrs,
                                         const TickScalars* sc, int t_steps,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(sc->device);
  if (err != cudaSuccess) return err;
  if (sc->circuit != LifRow::kCode) return cudaErrorInvalidValue;
  const repro::Stack sa = make_stack(a_stack, sc->a_heads, sc->f_a, sc->h1,
                                     sc->h2);
  const repro::Stack st = make_stack(t_stack, sc->t_heads, sc->f_t, sc->h1,
                                     sc->h2);
  ChunkIO io;
  io.v = static_cast<const float*>(io_ptrs[0]);
  io.o = static_cast<const float*>(io_ptrs[1]);
  io.t_last = static_cast<const float*>(io_ptrs[2]);
  io.params = static_cast<const float*>(io_ptrs[3]);
  io.changed = static_cast<const bool*>(io_ptrs[4]);
  io.x = static_cast<const float*>(io_ptrs[5]);
  io.t = static_cast<const float*>(io_ptrs[6]);
  io.v_out = static_cast<float*>(const_cast<void*>(io_ptrs[7]));
  io.o_out = static_cast<float*>(const_cast<void*>(io_ptrs[8]));
  io.tl_out = static_cast<float*>(const_cast<void*>(io_ptrs[9]));
  io.o_seq = static_cast<float*>(const_cast<void*>(io_ptrs[10]));
  io.e_seq = static_cast<float*>(const_cast<void*>(io_ptrs[11]));
  io.l_seq = static_cast<float*>(const_cast<void*>(io_ptrs[12]));
  return launch_chunk<LifRow>(sa, st, io, *sc, t_steps,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int network_tick_launch(const float* const* a_stack,
                                   const float* const* t_stack,
                                   const void* const* io_ptrs,
                                   const TickScalars* sc, void* stream) {
  cudaError_t err = cudaSetDevice(sc->device);
  if (err != cudaSuccess) return err;
  const repro::Stack sa = make_stack(a_stack, sc->a_heads, sc->f_a, sc->h1,
                                     sc->h2);
  const repro::Stack st = make_stack(t_stack, sc->t_heads, sc->f_t, sc->h1,
                                     sc->h2);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sc->circuit == LifRow::kCode) return launch<LifRow>(sa, st, io, *sc, s);
  if (sc->circuit == XbarRow::kCode) return launch<XbarRow>(sa, st, io, *sc, s);
  return cudaErrorInvalidValue;
}
