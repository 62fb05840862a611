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
// Design of the one-tick kernel (network_tick_tiled): a persistent grid,
// as many blocks of 512 threads as fit on the card's SMs (one per SM with
// MLP stacks), each walking row tiles of as many rows as the shared memory
// beside the stacks holds (at most 128: 128 LIF rows or 80 crossbar rows
// at MLP(100, 50), down to 4 for the widest heads), fewer, down to 32,
// where that lets one wave of blocks cover N. A
// block stages the launching kind's heads once, with 4-byte cp.async into
// a padded layout (rows of w0 / w1 on 16-byte boundaries), at the kind's
// own width (a cross-kind pack pads every head to the widest kind; those
// columns are zero weights and are skipped). Per tile it compacts, by
// block-wide ballots, the rows that need each head set — stale rows for
// the idle heads, changed rows for the active heads, rows whose output
// changed for the transition heads — builds their feature rows once per
// set in shared memory, and evaluates each head on them at its family's
// cost: a mean head is a constant, a linear head one index-order dot per
// row, an MLP head three products over (rows x units) — two register-
// tiled from shared memory, 2 or 4 rows x 4 units a thread, and the
// output layer one thread per row (heads.cuh:tile_head). Every sum is an
// index-order __fmaf_rn chain from 0, then + bias, relu, and the feature
// row, standardizer, destandardizer and record tail round in the
// reference's order, so the outputs equal the first design's (one thread
// per row) bit for bit: the work is spread over threads, the arithmetic
// is unchanged (tensor cores would need TF32). When both stacks fit in
// shared memory beside the tile's work area (LIF: 77 + 53 KB) they are
// staged together; when they do not (crossbar MLP heads: 148 + 100 KB)
// the block runs two phases: the A stack (M_ES, M_V, M_O) over all its
// tiles, parking the rows whose output changed in a device scratch, then,
// only if there are such rows, the T stack (M_ED, M_L) in A's place for
// their transition heads and record tails. The reference's
// lax.cond(any(...)) skips become control flow on the device, never a
// host sync: a tile with no changed row is copied through, a block with
// no changed row stages nothing, and a two-phase block in which no row's
// output changed never stages the T stack. Built with --fmad=false:
// everything outside the dot products rounds in the reference's order.
//
// The chunk kernel (network_tick_chunk_tiled) is the same persistent
// grid with the time loop inside the row tile: a block stages both LIF
// stacks once per launch, and each thread keeps its row's v, o and t_last
// in registers across the T ticks; every tick runs the one-tick kernel's
// tile functions (compaction, feature rows, heads, record tail) on the
// tile and writes the tile's o / e / l rows of the sequences. A
// standalone single-LIF-layer row depends only on its own history, so no
// barrier spans the grid, and a chunk equals T one-tick launches bit for
// bit. It takes the packs whose two stacks fit together beside kMinRows
// rows (LIF MLP(100, 50): 77 + 53 KB); tick_megakernel.chunk_takes
// routes the others to one-tick launches.

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

using repro::Pad;
using repro::make_pad;
using repro::stage_padded;
using repro::stage_wait;
using repro::tile_head;
using repro::up4;

constexpr int kAHeads = 3;  // M_ES, M_V, M_O
constexpr int kTHeads = 2;  // M_ED, M_L

// Feature rows (x[0..kIn), v, tau, p[0..kP)[, o_prev, o_new], derived): the
// reference's _features, the transition splice, then
// circuits.augment_features' derived column, computed from x and p.
struct LifRow {
  static constexpr int kCode = 0, kIn = 3, kP = 4;
  static constexpr int kFa = kIn + 2 + kP + 1;  // idle/active width
  __device__ static float derived(const float* x, const float* p, float) {
    return x[0] * x[1] * x[2] / 5.0f;
  }
};

struct XbarRow {
  static constexpr int kCode = 1, kIn = 32, kP = 33;
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

// What the idle, active and output-resolution stages leave for the
// transition stage and the record tail, for one changed row.
struct RowTick {
  float v_cur, v_new, o_hat, o_res, e_s_idle, e_s;
  bool stale, out_changed;
};

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

// --- the one-tick kernel: a persistent grid of row-tiled blocks -------------
//
// See the design note at the top of the file.

constexpr int kTickThreads = 512;
constexpr int kMinRows = 32;       // rows per tile a small N still gets
constexpr int kMaxRows = 128;      // rows per tile at the most
constexpr int kMaxH1 = 128;        // the widest first hidden layer it takes

// Rows per tile are set at launch and are the work area's stride: as many
// as the shared memory beside the stacks holds, at most kMaxRows (the LIF
// MLP(100, 50) stacks leave room for 128, the crossbar's A stack for 80;
// wider heads leave fewer, down to 4), fewer where one wave of blocks
// covers N with fewer.

// Shared memory of a block, in floats: the stage (A and T stacks, or
// either in turn), then the tile's work area.
struct TickSmem {
  int t_base;      // T stack's offset; 0 when T replaces A (two phases)
  int work;        // work area's offset
  int total;       // floats in all, for `cap` rows a tile
  int cap;         // rows per tile the work area holds (a multiple of 4),
                   // and its stride
  int rows;        // rows per tile of this launch (<= cap), set at launch
};

// floats of the work area at `rows` rows per tile (see carve)
__host__ inline int work_floats(int rows, int f_t, int h1, int h2) {
  return rows * ((f_t > h2 ? f_t : h2) + h1 + 12) + f_t * (rows + 1) + rows
         + 8;
}

// The stacks together when they fit beside kMinRows rows, else in two
// phases; then the most rows (a multiple of 4, at most kMaxRows) whose
// work area fits beside the stage. cap == 0: not even 4 rows fit.
__host__ inline TickSmem tick_smem(const Pad& pa, const Pad& pt, int f_t,
                                   int h1, int h2) {
  const int a = 3 * pa.per, t = 2 * pt.per;
  const int room = repro::kMaxSmem / 4;
  const bool together = a + t + work_floats(kMinRows, f_t, h1, h2) <= room;
  TickSmem s;
  s.t_base = together ? a : 0;
  s.work = together ? a + t : (a > t ? a : t);
  s.cap = kMaxRows;
  while (s.cap > 0 && s.work + work_floats(s.cap, f_t, h1, h2) > room)
    s.cap -= 4;
  s.total = s.work + work_floats(s.cap > 0 ? s.cap : 4, f_t, h1, h2);
  s.rows = s.cap;
  return s;
}

// The work area at stride ld (the rows per tile it holds, a multiple of
// 4): standardized features (then the second hidden layer) and the first
// hidden layer as [unit][ld], the listed rows' feature rows as [column][ld
// + 1] (padded: written along a row, read along a column, both without
// bank conflicts), the tile's per-row values that other threads read, and
// the compacted row list.
struct Work {
  int ld;
  float *xs, *hid, *feat;
  float *v, *t_last, *v_cur, *o, *o_res;                    // inputs
  float *e_idle, *v_hat, *e_s, *v_new, *o_hat, *e_d, *lat;  // head outputs
  int *list, *ballot;
};

__device__ inline Work carve(float* w, int ld, int f_t, int h1, int h2) {
  Work k;
  k.ld = ld;
  k.xs = w;
  w += ld * (f_t > h2 ? f_t : h2);
  k.hid = w;
  w += ld * h1;
  k.v = w;
  k.t_last = w + ld;
  k.v_cur = w + 2 * ld;
  k.o = w + 3 * ld;
  k.o_res = w + 4 * ld;
  k.e_idle = w + 5 * ld;
  k.v_hat = w + 6 * ld;
  k.e_s = w + 7 * ld;
  k.v_new = w + 8 * ld;
  k.o_hat = w + 9 * ld;
  k.e_d = w + 10 * ld;
  k.lat = w + 11 * ld;
  k.feat = w + 12 * ld;
  k.list = reinterpret_cast<int*>(k.feat + f_t * (ld + 1));
  k.ballot = k.list + ld;
  return k;
}

// wk.list <- the tile rows (0..wk.ld-1) where `pred` holds, in row order;
// returns their count. The whole block calls it; threads >= wk.ld pass
// false.
template <int LDC>
__device__ inline int compact(bool pred, const Work& wk) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = ((LDC ? LDC : wk.ld) + 31) >> 5;
  const unsigned b = __ballot_sync(0xffffffffu, pred);
  if (lane == 0 && warp < warps) wk.ballot[warp] = static_cast<int>(b);
  __syncthreads();
  int n = 0, off = 0;
  for (int i = 0; i < warps; ++i) {
    const int c = __popc(static_cast<unsigned>(wk.ballot[i]));
    n += c;
    if (i < warp) off += c;
  }
  if (pred) wk.list[off + __popc(b & ((1u << lane) - 1u))] = tid;
  __syncthreads();
  return n;
}

enum FeatureKind { kIdle = 0, kActive = 1, kTransition = 2 };

// Feature k < f - 1 of tile row `row` (global row r) in features<Row>'s
// layout; the last column, the derived one, comes from the others
template <class Row>
__device__ __forceinline__ float feature_at(int kind, int k, int row, int r,
                                            const Work& wk,
                                            const TickIO& io, float t,
                                            const TickScalars& sc) {
  constexpr int base = Row::kIn + 2 + Row::kP;
  if (k < Row::kIn)
    return kind == kIdle ? 0.0f : io.x[static_cast<size_t>(r) * Row::kIn + k];
  if (k == Row::kIn) return kind == kIdle ? wk.v[row] : wk.v_cur[row];
  if (k == Row::kIn + 1)
    return kind == kIdle ? fmaxf(t - wk.t_last[row] - sc.clock, 0.0f)
                         : sc.clock;
  if (k < base)
    return io.params[static_cast<size_t>(r) * Row::kP + k - Row::kIn - 2];
  return k == base ? wk.o[row] : wk.o_res[row];      // transition only
}

// wk.feat <- the `kind` feature rows of the n listed rows: a warp takes
// four rows at a time, its lanes the columns (a row's x and params are
// read coalesced, all of a warp's loads issued before its stores); then
// each row's derived column from its own x and params, as Row::derived.
template <class Row, int LDC>
__device__ void tile_features(int kind, int n, const Work& wk,
                              const TickIO& io, int r0, float t,
                              const TickScalars& sc) {
  constexpr int NC = (Row::kFa + 1 + 31) / 32, NR = 4;
  const int LD = (LDC ? LDC : wk.ld) + 1;
  const int tid = threadIdx.x, lane = tid & 31, warps = blockDim.x >> 5;
  const int f = kind == kTransition ? Row::kFa + 2 : Row::kFa;
  for (int s0 = (tid >> 5) * NR; s0 < n; s0 += warps * NR) {
    float val[NR][NC];
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int slot = s0 + j, k = lane + 32 * c;
        val[j][c] = slot < n && k < f - 1
                        ? feature_at<Row>(kind, k, wk.list[slot],
                                          r0 + wk.list[slot], wk, io, t, sc)
                        : 0.0f;
      }
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int slot = s0 + j, k = lane + 32 * c;
        if (slot < n && k < f - 1) wk.feat[k * LD + slot] = val[j][c];
      }
  }
  __syncthreads();
  if (tid < n) {
    float x[Row::kIn], p[Row::kP];
#pragma unroll
    for (int k = 0; k < Row::kIn; ++k) x[k] = wk.feat[k * LD + tid];
#pragma unroll
    for (int k = 0; k < Row::kP; ++k)
      p[k] = wk.feat[(Row::kIn + 2 + k) * LD + tid];
    wk.feat[(f - 1) * LD + tid] = Row::derived(x, p, sc.v_bias);
  }
  __syncthreads();
}

__device__ __forceinline__ void copy_through(const TickIO& io, int r) {
  io.v_out[r] = io.v[r];
  io.o_out[r] = io.o[r];
  io.tl_out[r] = io.t_last[r];
  io.e_out[r] = 0.0f;
  io.l_out[r] = 0.0f;
}

__device__ __forceinline__ void write_row(const TickIO& io, int r, float v,
                                          float o, float t_last, float e,
                                          float l) {
  io.v_out[r] = v;
  io.o_out[r] = o;
  io.tl_out[r] = t_last;
  io.e_out[r] = e;
  io.l_out[r] = l;
}

// the transition heads on the listed rows (n of them): e_d, latency
template <class Row, int LDC>
__device__ inline void tile_transition(const float* t_stage, const Pad& pt,
                                       int n, const Work& wk,
                                       const TickIO& io, int r0, float t,
                                       const TickScalars& sc) {
  constexpr int FT = Row::kFa + 2;
  tile_features<Row, LDC>(kTransition, n, wk, io, r0, t, sc);
  tile_head<LDC>(t_stage, pt, sc.t_fam[0], FT, n, wk, wk.e_d);
  tile_head<LDC>(t_stage + pt.per, pt, sc.t_fam[1], FT, n, wk, wk.lat);
}

// Algorithm 1 lines 3-25 on one tile: the idle catch-up of the stale rows
// (one merged E2 event), the active heads of the changed rows on their
// caught-up state, and the output resolution. Thread tid owns tile row
// tid and passes in its state (v, o, t_last, and the behavioral output in
// annotation mode) where the row changed; the A stack's heads are staged
// at a_stage. The whole block calls it.
template <class Row, int LDC>
__device__ __forceinline__ RowTick tile_active(const float* a_stage,
                                               const Pad& pa,
                                               const TickScalars& sc,
                                               const Work& wk,
                                               const TickIO& io, int r0,
                                               float t, bool changed, float v,
                                               float o, float t_last,
                                               float known) {
  constexpr int FA = Row::kFa;
  const int tid = threadIdx.x;
  RowTick rt{};
  if (changed) {
    rt.stale = t_last < t - sc.clock;
    wk.v[tid] = v;
    wk.t_last[tid] = t_last;
    wk.o[tid] = o;
  }
  // idle stage (Algorithm 1 lines 3-9) on the stale rows
  const int n_idle = compact<LDC>(rt.stale, wk);
  if (n_idle) {
    tile_features<Row, LDC>(kIdle, n_idle, wk, io, r0, t, sc);
    tile_head<LDC>(a_stage, pa, sc.a_fam[0], FA, n_idle, wk, wk.e_idle);
    if (!sc.annotate)
      tile_head<LDC>(a_stage + pa.per, pa, sc.a_fam[1], FA, n_idle, wk,
                     wk.v_hat);
  }
  if (changed) {
    rt.e_s_idle = rt.stale ? wk.e_idle[tid] : 0.0f;
    rt.v_cur = (!sc.annotate && rt.stale) ? wk.v_hat[tid] : v;
    wk.v_cur[tid] = rt.v_cur;
  }
  // active stage (lines 10-22) on the changed rows
  const int n_act = compact<LDC>(changed, wk);
  tile_features<Row, LDC>(kActive, n_act, wk, io, r0, t, sc);
  tile_head<LDC>(a_stage, pa, sc.a_fam[0], FA, n_act, wk, wk.e_s);
  if (!sc.annotate) {
    tile_head<LDC>(a_stage + pa.per, pa, sc.a_fam[1], FA, n_act, wk,
                   wk.v_new);
    tile_head<LDC>(a_stage + 2 * pa.per, pa, sc.a_fam[2], FA, n_act, wk,
                   wk.o_hat);
  }
  if (changed) {
    rt.e_s = wk.e_s[tid];
    rt.v_new = sc.annotate ? rt.v_cur : wk.v_new[tid];
    rt.o_hat = sc.annotate ? known : wk.o_hat[tid];
    // output resolution (lines 23-25)
    if (sc.spiking) {
      rt.out_changed = rt.o_hat > sc.half_vdd;
      rt.o_res = rt.out_changed ? sc.vdd : 0.0f;
    } else {
      rt.out_changed = fabsf(rt.o_hat - o) > sc.out_eps;
      rt.o_res = rt.o_hat;
    }
    wk.o_res[tid] = rt.o_res;
  }
  return rt;
}

// Algorithm 1 on a persistent grid. `t_base` > 0: both stacks staged
// together, T at t_base, and each tile runs to its record tail. t_base ==
// 0 (the crossbar's MLP stacks, which do not fit together): phase A runs
// every tile of the block to its output resolution and writes the record
// of each changed row whose output did not change; it parks each changed
// row in `park` (8 floats a row: v_cur, v_new, o_hat, o_res, then
// e_s_idle, e_s, stale, out_changed; the first four only where the output
// changed). Then, only if some row's output changed, the T stack replaces
// A and phase T finishes those rows.
template <class Row, int LDC>
__global__ void __launch_bounds__(kTickThreads, 1)
    network_tick_tiled(repro::Stack sa, repro::Stack st, TickIO io,
                       TickScalars sc, Pad pa, Pad pt, TickSmem layout,
                       float4* __restrict__ park) {
  constexpr int FA = Row::kFa;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const bool together = layout.t_base > 0;
  float* a_stage = smem;
  float* t_stage = smem + layout.t_base;
  const Work wk = carve(smem + layout.work, LDC ? LDC : layout.cap, FA + 2,
                        sc.h1, sc.h2);
  const int tid = threadIdx.x;
  const int rows = layout.rows;
  const int tiles = (sc.n + rows - 1) / rows;
  const float t = *io.t;
  bool staged = false, any_out = false;   // uniform across the block

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * rows, r = r0 + tid;
    const bool valid = tid < rows && r < sc.n;
    const bool changed = valid && io.changed[r];
    if (!__syncthreads_or(changed)) {        // no event in this tile
      if (valid) copy_through(io, r);
      continue;
    }
    if (!staged) {
      stage_padded(sa, sc.a_off, kAHeads, pa, a_stage);
      if (together) stage_padded(st, sc.t_off, kTHeads, pt, t_stage);
      stage_wait();
      staged = true;
    }
    // the tile's rows: thread tid owns row tid
    float v = 0.0f, o = 0.0f, t_last = 0.0f, known = 0.0f;
    if (changed) {
      v = io.v[r];
      o = io.o[r];
      t_last = io.t_last[r];
      if (sc.annotate) known = io.known[r];
    }
    const RowTick rt = tile_active<Row, LDC>(a_stage, pa, sc, wk, io, r0, t,
                                             changed, v, o, t_last, known);
    const int n_tr = compact<LDC>(rt.out_changed, wk);
    if (together) {
      // transition stage (lines 23-29) and record tail
      if (n_tr)
        tile_transition<Row, LDC>(t_stage, pt, n_tr, wk, io, r0, t, sc);
      if (valid) {
        float e = 0.0f, l = 0.0f;
        if (changed) {
          record_tail(sc, rt, rt.out_changed ? wk.e_d[tid] : 0.0f,
                      rt.out_changed ? wk.lat[tid] : 0.0f, t, v, o, t_last,
                      e, l);
          write_row(io, r, v, o, t_last, e, l);
        } else {
          copy_through(io, r);
        }
      }
    } else {
      any_out = any_out || n_tr > 0;
      if (changed) {
        park[2 * r + 1] = make_float4(rt.e_s_idle, rt.e_s,
                                      rt.stale ? 1.0f : 0.0f,
                                      rt.out_changed ? 1.0f : 0.0f);
      }
      if (rt.out_changed) {
        park[2 * r] = make_float4(rt.v_cur, rt.v_new, rt.o_hat, rt.o_res);
      } else if (changed) {
        float e = 0.0f, l = 0.0f;
        record_tail(sc, rt, 0.0f, 0.0f, t, v, o, t_last, e, l);
        write_row(io, r, v, o, t_last, e, l);
      } else if (valid) {
        copy_through(io, r);
      }
    }
  }
  if (together || !any_out) return;

  // phase T: every read of the A stack is done (tile_head ends with a
  // barrier); the T stack replaces it, and the parked rows finish
  __syncthreads();
  stage_padded(st, sc.t_off, kTHeads, pt, t_stage);
  stage_wait();
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * rows, r = r0 + tid;
    const bool valid = tid < rows && r < sc.n;
    RowTick rt{};
    if (valid && io.changed[r]) {
      const float4 b = park[2 * r + 1];
      rt.out_changed = b.w != 0.0f;
      if (rt.out_changed) {
        const float4 a = park[2 * r];
        rt.v_cur = a.x;
        rt.v_new = a.y;
        rt.o_hat = a.z;
        rt.o_res = a.w;
        rt.e_s_idle = b.x;
        rt.e_s = b.y;
        rt.stale = b.z != 0.0f;
        wk.v_cur[tid] = rt.v_cur;
        wk.o[tid] = io.o[r];
        wk.o_res[tid] = rt.o_res;
      }
    }
    const int n_tr = compact<LDC>(rt.out_changed, wk);
    if (!n_tr) continue;
    tile_transition<Row, LDC>(t_stage, pt, n_tr, wk, io, r0, t, sc);
    if (rt.out_changed) {
      float v = 0.0f, o = 0.0f, t_last = 0.0f, e = 0.0f, l = 0.0f;
      record_tail(sc, rt, wk.e_d[tid], wk.lat[tid], t, v, o, t_last, e, l);
      write_row(io, r, v, o, t_last, e, l);
    }
  }
}

// T standalone ticks of LIF rows on the persistent grid, the time loop
// inside the row tile (see the design note at the top of the file). Both
// stacks are staged together (t_base > 0), once, before the first tick
// of the block that has an event. A tick with no event in the tile writes
// the copy-through that network_tick writes (o, e = 0, l = 0).
template <class Row, int LDC>
__global__ void __launch_bounds__(kTickThreads, 1)
    network_tick_chunk_tiled(repro::Stack sa, repro::Stack st, ChunkIO io,
                             TickScalars sc, Pad pa, Pad pt, TickSmem layout,
                             int t_steps) {
  constexpr int FA = Row::kFa;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* a_stage = smem;
  float* t_stage = smem + layout.t_base;
  const Work wk = carve(smem + layout.work, LDC ? LDC : layout.cap, FA + 2,
                        sc.h1, sc.h2);
  const int tid = threadIdx.x;
  const int rows = layout.rows;
  const int tiles = (sc.n + rows - 1) / rows;
  bool staged = false;                     // uniform across the block
  TickIO tick{};                           // what the tile functions read
  tick.params = io.params;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * rows, r = r0 + tid;
    const bool valid = tid < rows && r < sc.n;
    // the row's state, in registers across the chunk
    float v = 0.0f, o = 0.0f, t_last = 0.0f;
    if (valid) {
      v = io.v[r];
      o = io.o[r];
      t_last = io.t_last[r];
    }
    for (int k = 0; k < t_steps; ++k) {
      const size_t i = static_cast<size_t>(k) * sc.n + r;
      const bool changed = valid && io.changed[i];
      float e = 0.0f, l = 0.0f;
      if (__syncthreads_or(changed)) {
        if (!staged) {
          stage_padded(sa, sc.a_off, kAHeads, pa, a_stage);
          stage_padded(st, sc.t_off, kTHeads, pt, t_stage);
          stage_wait();
          staged = true;
        }
        const float t = io.t[k];
        tick.x = io.x + static_cast<size_t>(k) * sc.n * Row::kIn;
        const RowTick rt = tile_active<Row, LDC>(
            a_stage, pa, sc, wk, tick, r0, t, changed, v, o, t_last, 0.0f);
        const int n_tr = compact<LDC>(rt.out_changed, wk);
        if (n_tr)
          tile_transition<Row, LDC>(t_stage, pt, n_tr, wk, tick, r0, t, sc);
        if (changed)
          record_tail(sc, rt, rt.out_changed ? wk.e_d[tid] : 0.0f,
                      rt.out_changed ? wk.lat[tid] : 0.0f, t, v, o, t_last,
                      e, l);
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
}

template <class Row>
bool tick_widths_ok(const TickScalars& sc) {
  return sc.n_in == Row::kIn && sc.n_p == Row::kP && sc.f_a >= Row::kFa &&
         sc.f_t >= Row::kFa + 2 && sc.h1 <= kMaxH1 &&
         sc.a_off + kAHeads <= sc.a_heads && sc.t_off + kTHeads <= sc.t_heads;
}

template <class Row>
TickSmem tick_layout(const TickScalars& sc, Pad* pa, Pad* pt) {
  *pa = make_pad(Row::kFa, sc.h1, sc.h2);
  *pt = make_pad(Row::kFa + 2, sc.h1, sc.h2);
  return tick_smem(*pa, *pt, Row::kFa + 2, sc.h1, sc.h2);
}

// floats of `park` a row needs: 8 when the stacks go in two phases, else
// 0; -1 where the kernel refuses the widths (H1 above kMaxH1, or not even
// 4 rows fit beside the stacks)
template <class Row>
int park_floats(int h1, int h2) {
  TickScalars sc{};
  sc.h1 = h1;
  sc.h2 = h2;
  Pad pa, pt;
  const TickSmem layout = tick_layout<Row>(sc, &pa, &pt);
  if (h1 > kMaxH1 || layout.cap == 0) return -1;
  return layout.t_base == 0 ? 8 : 0;
}

// Whether the chunk kernel takes stacks of MLP(h1, h2) heads: the widths
// the one-tick kernel takes, with both stacks together in shared memory
// beside kMinRows rows
template <class Row>
bool chunk_takes(int h1, int h2) {
  return park_floats<Row>(h1, h2) == 0;
}

// network_tick_tiled<Row, LDC> on one wave of blocks
template <class Row, int LDC>
cudaError_t launch_tiled(const repro::Stack& a, const repro::Stack& t,
                         const TickIO& io, const TickScalars& sc,
                         const Pad& pa, const Pad& pt, TickSmem layout,
                         float4* park, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * layout.total;
  static repro::Wave w;
  cudaError_t err = repro::wave(network_tick_tiled<Row, LDC>, kTickThreads,
                                bytes, sc.device, w);
  if (err != cudaSuccess) return err;
  layout.rows = repro::tile_rows(sc.n, w.blocks, layout.cap, kMinRows);
  const int tiles = (sc.n + layout.rows - 1) / layout.rows;
  network_tick_tiled<Row, LDC><<<tiles < w.blocks ? tiles : w.blocks,
                                 kTickThreads, bytes, stream>>>(
      a, t, io, sc, pa, pt, layout, park);
  return cudaGetLastError();
}

// network_tick_chunk_tiled<Row, LDC> on one wave of blocks
template <class Row, int LDC>
cudaError_t launch_chunk_tiled(const repro::Stack& a, const repro::Stack& t,
                               const ChunkIO& io, const TickScalars& sc,
                               const Pad& pa, const Pad& pt, TickSmem layout,
                               int t_steps, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * layout.total;
  static repro::Wave w;
  cudaError_t err = repro::wave(network_tick_chunk_tiled<Row, LDC>,
                                kTickThreads, bytes, sc.device, w);
  if (err != cudaSuccess) return err;
  layout.rows = repro::tile_rows(sc.n, w.blocks, layout.cap, kMinRows);
  const int tiles = (sc.n + layout.rows - 1) / layout.rows;
  network_tick_chunk_tiled<Row, LDC><<<tiles < w.blocks ? tiles : w.blocks,
                                       kTickThreads, bytes, stream>>>(
      a, t, io, sc, pa, pt, layout, t_steps);
  return cudaGetLastError();
}

// The work area's stride compiled in for the kind's MLP(100, 50) heads
// (the products' addresses then fold into immediates, and the crossbar
// kernel keeps its registers without spilling); other widths take the
// stride at run time.
template <class Row> struct CommonStride;
template <> struct CommonStride<LifRow> { static constexpr int kLd = 128; };
template <> struct CommonStride<XbarRow> { static constexpr int kLd = 80; };

template <class Row>
cudaError_t launch(const repro::Stack& sa, const repro::Stack& st,
                   const TickIO& io, const TickScalars& sc, float4* park,
                   cudaStream_t stream) {
  if (!tick_widths_ok<Row>(sc)) return cudaErrorInvalidValue;
  repro::Stack a = sa, t = st;
  a.fs = Row::kFa;
  t.fs = Row::kFa + 2;
  Pad pa, pt;
  const TickSmem layout = tick_layout<Row>(sc, &pa, &pt);
  if (layout.cap == 0 || (layout.t_base == 0 && park == nullptr))
    return cudaErrorInvalidValue;
  constexpr int kLd = CommonStride<Row>::kLd;
  if (layout.cap == kLd)
    return launch_tiled<Row, kLd>(a, t, io, sc, pa, pt, layout, park, stream);
  return launch_tiled<Row, 0>(a, t, io, sc, pa, pt, layout, park, stream);
}

// T standalone LIF ticks in one launch: the one-tick kernel's layout,
// which must stage both stacks together
template <class Row>
cudaError_t launch_chunk(const repro::Stack& sa, const repro::Stack& st,
                         const ChunkIO& io, const TickScalars& sc,
                         int t_steps, cudaStream_t stream) {
  if (!tick_widths_ok<Row>(sc) || sc.annotate) return cudaErrorInvalidValue;
  repro::Stack a = sa, t = st;
  a.fs = Row::kFa;
  t.fs = Row::kFa + 2;
  Pad pa, pt;
  const TickSmem layout = tick_layout<Row>(sc, &pa, &pt);
  if (layout.cap == 0 || layout.t_base == 0) return cudaErrorInvalidValue;
  constexpr int kLd = CommonStride<Row>::kLd;
  if (layout.cap == kLd)
    return launch_chunk_tiled<Row, kLd>(a, t, io, sc, pa, pt, layout,
                                        t_steps, stream);
  return launch_chunk_tiled<Row, 0>(a, t, io, sc, pa, pt, layout, t_steps,
                                    stream);
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

// floats of park a row of `circuit` needs at hidden widths h1, h2 (0:
// none), or -1 for an unknown circuit or widths network_tick refuses
extern "C" int network_tick_park_floats(int circuit, int h1, int h2) {
  if (circuit == LifRow::kCode) return park_floats<LifRow>(h1, h2);
  if (circuit == XbarRow::kCode) return park_floats<XbarRow>(h1, h2);
  return -1;
}

// 1 where network_tick_chunk takes `circuit` rows with stacks of MLP(h1,
// h2) heads, else 0 (LIF rows only)
extern "C" int network_tick_chunk_takes(int circuit, int h1, int h2) {
  return circuit == LifRow::kCode && chunk_takes<LifRow>(h1, h2) ? 1 : 0;
}

// park: (n, network_tick_park_floats) float32, 16-byte aligned, or null
// when that is 0
extern "C" int network_tick_launch(const float* const* a_stack,
                                   const float* const* t_stack,
                                   const void* const* io_ptrs,
                                   const TickScalars* sc, void* park,
                                   void* stream) {
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
  float4* pk = static_cast<float4*>(park);
  if (sc->circuit == LifRow::kCode)
    return launch<LifRow>(sa, st, io, *sc, pk, s);
  if (sc->circuit == XbarRow::kCode)
    return launch<XbarRow>(sa, st, io, *sc, pk, s);
  return cudaErrorInvalidValue;
}
