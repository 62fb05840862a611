"""Shared fixtures and factories for the ``repro_torch`` parity tests.

Both packages get the same numbers: inputs come from a seed through numpy,
and the surrogate artifacts, SNN weights and reference record are the
committed files under ``src/repro_torch/artifacts/``, which the JAX
package produced on the CPU. Regenerate all of them with::

    PYTHONPATH=src python tests/test_torch_fixtures.py --regen

or only the crossbar and mixed-graph files (the LIF four stay as they
are) with ``--regen-crossbar``, only the stream record with
``--regen-stream``, only the LM record with ``--regen-lm``, only the
LM training record with ``--regen-lm-train``, or only
the wide-surrogate artifact and its record with ``--regen-wide``, or
only the training record with ``--regen-train``, or only the layer
record with ``--regen-layer``, or only the DSE record with
``--regen-dse``, or only the wire record with ``--regen-serve``.

Seeds: ``lif_packable`` is ``lasana.train("lif", TrainConfig(n_runs=600,
n_steps=100, families=("linear", "mlp"), seed=0))``; ``lif_unpackable`` is
a default-family ``PredictorBank`` fit on the same testbench with M_ES
forced to its ``gbdt`` fit (so ``pack_heads`` refuses it while the four
other heads stay 3-layer MLPs); the SNN weights are
``examples/snn_mnist.py:train_ann()`` (seed 0); the record runs the
chip-smoke workload (``make_digits(100, size=28, seed=777)``, Poisson seed
5, 100 ticks) through ``repro.lasana.simulate``.

Crossbar and mixed-graph files: ``crossbar_packable`` is
``lasana.train("crossbar", TrainConfig(n_runs=200, n_steps=100,
families=("linear", "mlp"), seed=0))``; ``crossbar_unpackable`` is the
default-family ``PredictorBank("crossbar")`` on the same testbench with
the same family choice as ``lif_unpackable``; ``xbar_400_120_84_10`` holds
``examples/mnist_crossbar.py:train_ternary_net(seed=0)`` as int8;
``mixed_144_24_10`` holds ``examples/mixed_menage.py:
train_front_and_readout(seed=0)``; ``xbar_ref_record`` runs the crossbar
MNIST wave (``make_digits(200, size=20, seed=999)`` as DAC volts, T = 1)
and ``mixed_ref_record`` the mixed net (``make_digits(64, size=12,
seed=777)`` held for 30 ticks) through ``repro.lasana.simulate``.

The LM record (``--regen-lm``, ``starcoder2_3b_ref_record.npz``) runs the
reference ``Model`` of StarCoder2-3B at full width, cut to
:data:`LM_RECORD_LAYERS` layers, on the CPU with ``lm_numpy_params(cfg,
0)`` (the first layers of the full model's parity weights) and the
4 x 512 prompt ``SyntheticCorpus(49152, seed=0).batch(0, 4, 512)``: the
prefill's last-position logits of the 4 rows, the 8 greedy tokens fed to
8 decode steps, and rows 0-1's logits of those steps (float16, exact for
the bf16 values the logits are).

The stream record (``--regen-stream``) runs the SNN's hidden layer alone
(784 -> 128 LIF, B = 100) over :func:`stream_blocks`' 2,000 ticks through
the reference's chunk body with ``fused_kernel=True`` — the jnp body of
``_chunk_fast_path`` for the packable surrogate — and keeps per-neuron
spike counts, per-tick energy / latency / events, the flush and the final
``v`` of the golden and lasana runs.

The wide surrogate (``--regen-wide``, ``lif_wide_200_50.npz``) is
``lasana.train("lif", TrainConfig(n_runs=300, n_steps=100,
families=("mlp",), seed=0))`` with every head an MLP(200, 50): wider
than the one-tick kernel takes, so the engine evaluates it through the
stacked-dispatch tick. Its record (``snn_wide_ref_record.npz``) runs the
784-128-10 SNN on the first :data:`WIDE_IMAGES` chip-smoke digits for 100
ticks through ``repro.lasana.simulate``.

The training record (``--regen-train``, ``train_lif_ref_record.npz``) is
``lasana.train("lif", TrainConfig())`` taken apart: the testbench
``generate_testbench(LIFNeuron(), TestbenchConfig(n_runs=1000,
n_steps=125, alpha=0.8, seed=0))`` (``active``, ``inputs``, ``params``),
the dataset ``build_dataset`` makes from it (the run-wise split seeded 0:
``count/{kind}`` and ``energy/{kind}``, the event count and the energy
sum per event kind over all three splits, and ``split_count/{split}``),
and the five-family ``PredictorBank("lif")`` fit on it
(``val_mse/{predictor}/{family}``, ``test_mse/...`` and
``selected/{predictor}``). Every family's own seed is its default, 0.
``gbdt_band/{predictor}`` holds the reference GBDT's own validation MSE
over :data:`GBDT_BAND_REFITS` refits on the same rows with 1% of the
training targets nudged by one ULP (nudge seeds 0, 1, ...): how far a
fit moves when its inputs move by rounding, as a port's golden
simulation moves them.

The layer record (``--regen-layer``, ``layer_ref_record.npz``) runs the
reference's layer runners (``repro.core.simulate``) on its own
``make_stimulus("lif", 1000, 100, seed=123)`` and ``make_stimulus(
"crossbar", 128, 30, seed=1)``, kept as they were drawn (``active`` as
packed bits): for LIF golden, behavioral, LASANA-P, LASANA-O (golden
states) and annotation (behavioral states and outputs) with
``lif_packable`` and LASANA-P with ``lif_unpackable``; for crossbar rows
golden, behavioral and LASANA-P with ``crossbar_packable``. A LIF run
keeps its spikes as packed bits, its energy, latency and state summed per
neuron and per tick, and the first :data:`LAYER_SUB` neurons' records
whole (each neuron runs on its own, so a subset reruns alone); a crossbar
run keeps every record whole.

The DSE record (``--regen-dse``, ``dse_ref_record.npz``) is
``DSEEngine().evaluate(CandidateSpec.sample(4096, seed=0),
crossbar_unpackable)``: the engine's base rows (``base_x``, ``base_p``,
``base_o``, n_samples 256), the candidates' ``v_dd`` and ``tile``, every
``DSEReport`` array (``report/...``) and its Pareto indices; and
``explore_arch`` of all ten configs with the same surrogate
(``arch/{arch}/...``, ``tiles_by_component`` as JSON) beside the 2,048
rows ``tile_energy_latency`` prices (``tile_x``, ``tile_p``,
``tile_o``: ``jax.random`` key 0, as it draws them).

The LM training record (``--regen-lm-train``,
``starcoder2_3b_train_ref_record.npz``) runs the reference's
``make_train_step`` on StarCoder2-3B at full width, cut to
:data:`LM_TRAIN_LAYERS` layers, in fp32 (:func:`fp32_reference`, the
weights ``lm_numpy_params(cfg, 0)`` unrounded), for
:data:`LM_TRAIN_STEPS` steps of AdamW (:data:`LM_TRAIN_OPT`) on the
launcher's batches ``make_train_batch(SyntheticCorpus(49152, seed=0), step,
global_batch=2, seq=128)``: each step's ``loss``, ``grad_norm`` and
``lr``, every leaf's gradient L2 norm at step 0 (``grad_norm/<path>``)
and every leaf's update L2 norm after the last step (``update_norm/<path>``,
the norm of the parameter's change); ~2 minutes and ~12 GB.

The wire record (``--regen-serve``, ``serve_wire_record.json``) holds the
op script :func:`wire_script` (register ``lif_packable.npz`` by path, the
784-128-10 SNN as an ``snn`` spec, one ``simulate_batch`` of 8 requests of
100 ticks x 1-8 rows of Bernoulli(0.2) spikes seeded 0-7, one
``simulate`` pinned to ``lif@1``, ``stats``, ``shutdown``) with the
artifact and the weights named by file, and the reference's responses to
it: ``repro.serve.run_stdio`` over ``repro.lasana.serve(slot_widths=(32,),
chunk_ticks=16)`` on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARTIFACTS = ROOT / "src" / "repro_torch" / "artifacts"
PACKABLE = ARTIFACTS / "lif_packable.npz"
UNPACKABLE = ARTIFACTS / "lif_unpackable.npz"
SNN_WEIGHTS = ARTIFACTS / "snn_784_128_10.npz"
REF_RECORD = ARTIFACTS / "snn_ref_record.npz"
XBAR_PACKABLE = ARTIFACTS / "crossbar_packable.npz"
XBAR_UNPACKABLE = ARTIFACTS / "crossbar_unpackable.npz"
XBAR_WEIGHTS = ARTIFACTS / "xbar_400_120_84_10.npz"
MIXED_WEIGHTS = ARTIFACTS / "mixed_144_24_10.npz"
XBAR_RECORD = ARTIFACTS / "xbar_ref_record.npz"
MIXED_RECORD = ARTIFACTS / "mixed_ref_record.npz"
STREAM_RECORD = ARTIFACTS / "stream_784_128_ref_record.npz"
WIDE = ARTIFACTS / "lif_wide_200_50.npz"
WIDE_RECORD = ARTIFACTS / "snn_wide_ref_record.npz"
WIDE_HIDDEN = (200, 50)                # MLP widths of every wide head
WIDE_IMAGES = 20                       # digits of the wide record

# the unpackable artifact: every head an MLP(100, 50) except this one
UNPACKABLE_FAMILIES = {"M_ED": "mlp", "M_ES": "gbdt", "M_L": "mlp",
                       "M_O": "mlp", "M_V": "mlp"}
LIF_KNOBS = (0.58, 0.5, 0.5, 0.5)      # examples/snn_mnist.py's per-layer knobs
T_STEPS = 100
N_IMAGES = 100
RECORD_FIELDS = ("outputs", "out_spikes", "events", "energy", "latency",
                 "flush_energy")
# record key -> (surrogate artifact or None for golden, reference fused_kernel)
RECORD_RUNS = {"golden": (None, None), "lasana": (PACKABLE, True),
               "lasana_unpackable": (UNPACKABLE, False)}
# crossbar MNIST: record key -> (crossbar artifact or None, fused_kernel)
XBAR_RECORD_RUNS = {"golden": (None, None), "lasana": (XBAR_PACKABLE, True),
                    "lasana_unpackable": (XBAR_UNPACKABLE, False)}
# mixed net: record key -> backend (lasana runs the {crossbar, lif} pack)
MIXED_RECORD_RUNS = ("golden", "behavioral", "lasana")
XBAR_IMAGES = 200
MIXED_IMAGES = 64
MIXED_TICKS = 30
MIXED_INHIBIT = -0.4                   # examples/mixed_menage.py lateral weight


def chip_workload(n_images: int = N_IMAGES, t_steps: int = T_STEPS):
    """The chip-smoke stimulus and labels: (T, B, 784) V_dd spikes (the
    first ``t_steps`` ticks of the first ``n_images`` items)."""
    from repro_torch.data.mnist import make_digits, poisson_encode
    imgs, labels = make_digits(N_IMAGES, size=28, seed=777)
    spikes = poisson_encode(imgs, T_STEPS, seed=5) * 1.5
    return (spikes[:t_steps, :n_images].astype(np.float32),
            labels[:n_images])


# the LM record: StarCoder2-3B at full width, depth cut to 4 of 30 layers
LM_RECORD = ARTIFACTS / "starcoder2_3b_ref_record.npz"
# the LM training record: StarCoder2-3B at full width, 2 layers, fp32
LM_TRAIN_RECORD = ARTIFACTS / "starcoder2_3b_train_ref_record.npz"
LM_TRAIN_LAYERS = 2
LM_TRAIN_BATCH = (2, 128)    # global batch, sequence length
LM_TRAIN_STEPS = 3
LM_TRAIN_OPT = dict(lr=1e-4, warmup_steps=2, total_steps=10)
LM_RECORD_LAYERS = 4
LM_PROMPT = (4, 512)         # batch, prompt length
LM_DECODE_STEPS = 8
LM_DECODE_ROWS = 2           # rows whose decode logits the record keeps
TRAIN_RECORD = ARTIFACTS / "train_lif_ref_record.npz"
# the zoo records: the six other families at full width, depth cut;
# arch -> (record depth, batch, prompt tokens). deepseek-v3-671b keeps its
# three dense MLA layers (one MoE layer at full width is 11.3 B parameters,
# 45 GB of fp32 draws); whisper-base is whole (6 + 6 layers, 1,500
# frames); pixtral's 1,536 positions are 1,024 patches and 512 tokens;
# recurrentgemma's 2,048 fill its ring buffer, which wraps while decoding
ZOO_RECORDS = {"deepseek-moe-16b": (2, 2, 512),
               "deepseek-v3-671b": (3, 2, 256),
               "mamba2-1.3b": (4, 2, 512),
               "recurrentgemma-2b": (3, 2, 2048),
               "whisper-base": (6, 2, 256),
               "pixtral-12b": (2, 2, 1536)}
ZOO_COLUMNS = 16384          # vocab columns a record keeps of a wider row
ZOO_FULL_ROWS = 65536        # rows up to this vocab are kept whole
ZOO_INPUT_SEED = 1           # numpy seed of the frames / patches
PREDICTORS = ("M_O", "M_V", "M_ED", "M_ES", "M_L")
FAMILIES = ("mean", "table", "linear", "gbdt", "mlp")
GBDT_BAND_REFITS = 8

# the layer record: the quickstart's layers through repro.core.simulate
LAYER_RECORD = ARTIFACTS / "layer_ref_record.npz"
LAYER_LIF = (1000, 100, 123)          # N, T, make_stimulus seed
LAYER_XBAR = (128, 30, 1)
LAYER_SUB = 64                        # neurons whose records are kept whole
# run name -> (surrogate artifact or None, mode): golden / behavioral, or
# run_lasana as LASANA-P ("p"), LASANA-O ("o") or annotation ("annotate")
LAYER_LIF_RUNS = {"golden": (None, "golden"),
                  "behavioral": (None, "behavioral"),
                  "lasana_p": (PACKABLE, "p"), "lasana_o": (PACKABLE, "o"),
                  "annotation": (PACKABLE, "annotate"),
                  "lasana_p_unpackable": (UNPACKABLE, "p")}
LAYER_XBAR_RUNS = {"golden": (None, "golden"),
                   "behavioral": (None, "behavioral"),
                   "lasana_p": (XBAR_PACKABLE, "p")}
# the DSE record: lasana.explore at bench_dse.py's full candidate count
DSE_RECORD = ARTIFACTS / "dse_ref_record.npz"
DSE_CANDIDATES = 4096
DSE_SAMPLES = 256                     # DSEEngine's default n_samples
DSE_ARCHS = ("starcoder2-3b", "granite-3-8b", "deepseek-67b",
             "mistral-large-123b", "deepseek-v3-671b", "deepseek-moe-16b",
             "whisper-base", "pixtral-12b", "mamba2-1.3b",
             "recurrentgemma-2b")
DSE_REPORT_FIELDS = ("n_tiles", "analog_params", "total_params",
                     "analog_flop_fraction", "energy_per_token_j",
                     "latency_critical_ns", "tile_energy_j",
                     "tile_latency_ns")
ARCH_FIELDS = ("n_matrices", "n_tiles", "analog_params", "total_params",
               "analog_flop_fraction", "energy_per_token_j",
               "latency_critical_ns", "tile_energy_j")

STREAM_TICKS = 2000          # the stream phase's horizon
STREAM_BLOCK = 250           # ticks per host block
STREAM_CHUNK = 512           # ticks per chunk (three full + one of 464)


def stream_blocks(n_images: int = N_IMAGES, t_steps: int = STREAM_TICKS):
    """The stream phase's host generator: block j is the chip-smoke digits
    Poisson-encoded for 250 ticks with seed 5 + j, in V_dd spikes."""
    from repro_torch.data.mnist import make_digits, poisson_encode
    imgs, _ = make_digits(N_IMAGES, size=28, seed=777)
    for j in range(-(-t_steps // STREAM_BLOCK)):
        blk = poisson_encode(imgs[:n_images], STREAM_BLOCK, seed=5 + j) * 1.5
        yield blk[:t_steps - j * STREAM_BLOCK].astype(np.float32)


def snn_weights():
    """(weights [w0 (784, 128), w1 (128, 10)], per-layer knob rows)."""
    with np.load(SNN_WEIGHTS) as z:
        ws = [z["w0"], z["w1"]]
    return ws, [np.asarray(LIF_KNOBS, np.float32)] * len(ws)


def xbar_workload(n_images: int = XBAR_IMAGES):
    """Crossbar MNIST: (ternary weights [400x120, 120x84, 84x10] f32,
    DAC volts (B, 400), labels) — one combinational wave."""
    from repro_torch.data.mnist import make_digits
    with np.load(XBAR_WEIGHTS) as z:
        ws = [z[f"w{i}"].astype(np.float32) for i in range(3)]
    imgs, labels = make_digits(XBAR_IMAGES, size=20, seed=999)
    volts = (imgs * 1.6 - 0.8).astype(np.float32)
    return ws, volts[:n_images], labels[:n_images]


def mixed_workload(n_images: int = MIXED_IMAGES, t_steps: int = MIXED_TICKS):
    """The mixed net: (w1 (144, 24) ternary, w2 (24, 10), LIF knobs, the
    (10, 10) lateral-inhibition edge, DAC volts held (T, B, 144), labels)."""
    from repro_torch.data.mnist import make_digits
    with np.load(MIXED_WEIGHTS) as z:
        w1, w2 = z["w1"].astype(np.float32), z["w2"].astype(np.float32)
    inhib = (MIXED_INHIBIT * (1.0 - np.eye(10))).astype(np.float32)
    imgs, labels = make_digits(MIXED_IMAGES, size=12, seed=777)
    volts = (imgs * 1.6 - 0.8).astype(np.float32)[:n_images]
    seq = np.ascontiguousarray(
        np.broadcast_to(volts, (t_steps, *volts.shape)))
    return (w1, w2, np.asarray(LIF_KNOBS, np.float32), inhib, seq,
            labels[:n_images])


def small_net(seed: int = 0, t_steps: int = 20, batch: int = 3):
    """The 12-8-4 LIF SNN and a Bernoulli(0.2) V_dd spike stimulus, from
    numpy: (weights, knob rows, stimulus (T, B, 12))."""
    rng = np.random.default_rng(seed)
    ws = [(rng.normal(0, 1, (12, 8)) * 0.8).astype(np.float32),
          (rng.normal(0, 1, (8, 4)) * 0.8).astype(np.float32)]
    x = ((rng.random((t_steps, batch, 12)) < 0.2) * 1.5).astype(np.float32)
    return ws, [np.asarray(LIF_KNOBS, np.float32)] * 2, x


def tick_inputs(n: int, seed: int, n_in: int = 3, n_p: int = 4):
    """One tick's numpy inputs: (v, o, t_last, params, changed, x, known)."""
    rng = np.random.default_rng(seed)
    params = rng.uniform(0.3, 0.7, (n, n_p)).astype(np.float32)
    v = rng.uniform(0, 1, n).astype(np.float32)
    o = (rng.random(n) < 0.3).astype(np.float32) * 1.5
    t_last = rng.choice([0.0, 5.0, 25.0], n).astype(np.float32)
    changed = rng.random(n) < 0.6
    x = rng.uniform(-1, 1, (n, n_in)).astype(np.float32)
    known = (rng.random(n) < 0.4).astype(np.float32) * 1.5
    return v, o, t_last, params, changed, x, known


def layer_stimulus(rec, kind: str):
    """The layer record's stimulus ``(active (T, N) bool, x, params)`` of
    ``kind`` ("lif" | "xbar") as numpy."""
    x = rec[f"{kind}/x"]
    t_steps, n = x.shape[:2]
    active = np.unpackbits(rec[f"{kind}/active"], axis=-1,
                           count=n).astype(bool)
    return active, x, rec[f"{kind}/params"].astype(np.float32)


def layer_summary(run, kind: str, prefix: str) -> dict:
    """A ``LayerRun``'s record entries: crossbar rows whole; LIF spikes as
    packed bits, energy / latency / state sums per neuron and per tick
    (float64) and the first :data:`LAYER_SUB` neurons' records whole."""
    fields = {f: np.asarray(getattr(run, f), np.float32)
              for f in ("outputs", "states", "energy", "latency")}
    if kind == "xbar":
        return {f"{prefix}/{f}": a for f, a in fields.items()}
    out = {f"{prefix}/spikes": np.packbits(fields["outputs"] > 0.75,
                                           axis=-1)}
    for f in ("states", "energy", "latency"):
        a = fields[f].astype(np.float64)
        out[f"{prefix}/{f}_by_neuron"] = a.sum(axis=0)
        out[f"{prefix}/{f}_by_tick"] = a.sum(axis=1)
    for f, a in fields.items():
        out[f"{prefix}/sub/{f}"] = a[:, :LAYER_SUB]
    return out


def jax_run_fields(run) -> dict:
    """A NetworkRun's record fields as numpy, spikes as uint8."""
    out = {f: np.asarray(getattr(run, f)) for f in RECORD_FIELDS}
    out["out_spikes"] = (out["out_spikes"] > 0.75).astype(np.uint8)
    return out


RTOL = 1e-5


def assert_close(got, want, name, rtol=RTOL, atol_scale=1e-6):
    """Continuous records: rtol 1e-5 (the reference's own tolerance between
    its fused and per-call paths), with an atol at ``atol_scale`` (1e-6)
    of the field's scale so values that cancel to ~0 compare on the
    field's magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.max(np.abs(want), initial=0.0))
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * scale, err_msg=name)


def assert_runs_match(got, want):
    """Discrete records identical, continuous ones within :data:`RTOL`."""
    for f in ("outputs", "out_spikes", "events"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)
    if want.layer_spikes is not None:
        for i, (g, w) in enumerate(zip(got.layer_spikes, want.layer_spikes)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=f"layer_spikes[{i}]")
    for f in ("energy", "latency", "flush_energy"):
        assert_close(getattr(got, f), getattr(want, f), f)


# --- serving: request mixes, graphs of both packages, the lane loop ---------

WIRE_RECORD = ARTIFACTS / "serve_wire_record.json"
WIRE_SLOT_WIDTHS = (32,)
WIRE_CHUNK = 16


def wire_script() -> list:
    """The wire record's op script, its files named by basename (see
    :func:`wire_ops`): the SNN served over the JSON-lines protocol."""
    knobs = [float(k) for k in np.asarray(LIF_KNOBS, np.float32)]
    spikes = lambda t, b, seed: {"t": t, "b": b, "rate": 0.2, "seed": seed}
    return [
        {"op": "register_surrogate", "name": "lif",
         "path": PACKABLE.name},
        {"op": "register_spec", "name": "snn",
         "snn": {"weights": SNN_WEIGHTS.name, "params": [knobs, knobs]}},
        {"op": "simulate_batch", "requests": [
            {"id": f"b{i}", "spec": "snn", "surrogate": "lif",
             "tenant": f"t{i % 3}",
             "stimulus_spikes": spikes(T_STEPS, i + 1, i)}
            for i in range(8)]},
        {"op": "simulate", "id": "pinned", "spec": "snn",
         "surrogate": "lif@1", "stimulus_spikes": spikes(T_STEPS, 4, 8)},
        {"op": "stats"},
        {"op": "shutdown"},
    ]


def wire_ops(script, art_dir=ARTIFACTS) -> list:
    """``script`` as the protocol's ops: the artifact's basename becomes
    its path under ``art_dir``, the weights file's the SNN's weights as
    nested lists."""
    ops = []
    for op in script:
        op = dict(op)
        if "path" in op:
            op["path"] = str(pathlib.Path(art_dir) / op["path"])
        if isinstance(op.get("snn", {}).get("weights"), str):
            with np.load(pathlib.Path(art_dir) / op["snn"]["weights"]) as z:
                ws = [z[f"w{i}"] for i in range(len(z.files))]
            op["snn"] = dict(op["snn"], weights=[
                np.asarray(w, np.float32).tolist() for w in ws])
        ops.append(op)
    return ops


SERVE_CHUNK = 8                      # tests/test_serve.py's chunk ticks
SERVE_JOBS = [(24, 2), (9, 1), (5, 1), (16, 2), (24, 1), (9, 1), (16, 1)]


def serve_stimuli(jobs, seed: int, n_in: int = 12, rate: float = 0.2):
    """One Bernoulli(``rate``) V_dd spike block (T, b, n_in) per (T, b) job,
    from one numpy generator."""
    rng = np.random.default_rng(seed)
    return [((rng.random((t, b, n_in)) < rate) * 1.5).astype(np.float32)
            for t, b in jobs]


def mixed_serve_net(jobs=((20, 2), (11, 1)), seed: int = 3):
    """tests/test_serve.py's mixed graph from numpy: a 20-8 crossbar front
    end feeding 6 LIF neurons with lateral inhibition; (description, DAC
    volt blocks)."""
    rng = np.random.default_rng(seed)
    xw = rng.integers(-1, 2, (20, 8)).astype(np.float32)
    lw = (rng.normal(0, 0.5, (8, 6)) * 2.2).astype(np.float32)
    inhib = (-0.6 * (1 - np.eye(6))).astype(np.float32)
    seqs = [(rng.integers(-1, 2, (t, b, 20)) * 0.8).astype(np.float32)
            for t, b in jobs]
    return {"layers": [{"circuit": "crossbar", "weight": xw},
                       {"circuit": "lif", "weight": lw,
                        "params": np.asarray(LIF_KNOBS, np.float32)}],
            "edges": [(1, 1, inhib)]}, seqs


def small_net_desc(seed: int = 0, n_layers: int = 2):
    """:func:`small_net`'s weights as a graph description (the first
    ``n_layers`` layers)."""
    ws, knobs, _ = small_net(seed)
    return {"layers": [{"circuit": "lif", "weight": w, "params": p}
                       for w, p in list(zip(ws, knobs))[:n_layers]],
            "edges": []}


def jax_graph_spec(desc):
    """The reference's NetworkSpec of a graph description."""
    import jax.numpy as jnp
    from repro.core.network import (crossbar_layer, graph_spec, lif_layer,
                                    recurrent_edge)
    layers = [crossbar_layer(jnp.asarray(d["weight"], jnp.float32))
              if d["circuit"] == "crossbar" else
              lif_layer(jnp.asarray(d["weight"]), jnp.asarray(d["params"]))
              for d in desc["layers"]]
    return graph_spec(layers, edges=[recurrent_edge(s, d, jnp.asarray(w))
                                     for s, d, w in desc["edges"]])


def port_graph_spec(desc):
    """The port's NetworkSpec of a graph description."""
    from repro_torch.convert import graph_spec_from_numpy
    return graph_spec_from_numpy(desc["layers"], desc["edges"])


def scaled_surrogate(sur, factor, jax_side=False):
    """A copy of ``sur`` with every MLP weight matrix scaled by
    ``factor`` (same structure: a weight swap), for the reference
    (``jax_side``) or the port."""
    import jax.numpy as jnp
    import torch
    params = {}
    for p, d in sur.params.items():
        params[p] = {}
        for k, a in d.items():
            a = np.asarray(a)
            if sur.manifest.family_of(p) == "mlp" and k.startswith("w"):
                a = (a * np.float32(factor)).astype(a.dtype)
            params[p][k] = jnp.asarray(a) if jax_side else torch.as_tensor(a)
    return type(sur)(sur.manifest, params, sur.fit_info)


class Queued:
    """What a lane admits: a request's handle and its host stimulus."""

    def __init__(self, handle, stimulus):
        self.handle = handle
        self.stimulus = stimulus


def drive_lane(lane, handle_cls, stims, on_chunk=None, max_rounds=200):
    """Submit ``stims`` to ``lane`` in order, admitting as slots free, and
    step until every request has left (the admit-then-step loop of the
    reference's ``SimServer.run_until_idle``). Returns the handles;
    ``on_chunk`` maps a request index to its callback."""
    queue = [Queued(handle_cls(i, f"t{i % 3}", (on_chunk or {}).get(i)), x)
             for i, x in enumerate(stims)]
    handles = [q.handle for q in queue]
    for _ in range(max_rounds):
        while queue and lane.admit(queue[0]):
            queue.pop(0)
        if not lane.active and not queue:
            return handles
        lane.step()
    raise RuntimeError(f"lane not idle after {max_rounds} rounds")


def assert_request_parity(solo, served, *, hidden=False):
    """tests/test_serve.py's solo-vs-served equivalence: discrete records
    identical; energy and flush at rtol 1e-5, latency at rtol 1e-5 with
    atol 1e-6."""
    np.testing.assert_array_equal(np.asarray(solo.outputs),
                                  np.asarray(served.outputs))
    np.testing.assert_array_equal(np.asarray(solo.events),
                                  np.asarray(served.events))
    if solo.out_spikes is not None:
        np.testing.assert_array_equal(np.asarray(solo.out_spikes),
                                      np.asarray(served.out_spikes))
    if hidden and solo.layer_spikes is not None:
        for a, b in zip(solo.layer_spikes, served.layer_spikes):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(np.asarray(solo.energy), served.energy,
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(np.asarray(solo.latency), served.latency,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(solo.flush_energy),
                               served.flush_energy, rtol=1e-5, atol=0)


def zoo_record_path(arch: str) -> pathlib.Path:
    return ARTIFACTS / (arch.replace("-", "_").replace(".", "") +
                        "_ref_record.npz")


def zoo_record_config(cfg, arch: str):
    """The record's cut of a full config (either package's dataclass): its
    first layers, no multi-token-prediction head (prefill and decode never
    run it), and for deepseek-v3-671b no MoE stack (the three dense MLA
    layers alone)."""
    import dataclasses
    depth = ZOO_RECORDS[arch][0]
    kw = {"n_layers": depth, "mtp_depth": 0}
    if cfg.moe is not None and cfg.moe.first_dense >= depth:
        kw["moe"] = None
    return dataclasses.replace(cfg, **kw)


def zoo_inputs(cfg, batch: int, seed: int = ZOO_INPUT_SEED) -> dict:
    """A prefill's inputs beside the tokens, float32 numpy drawn from
    ``seed``: an encoder-decoder's ``frames`` (B, encoder_seq, d) standard
    normal, a VLM's ``patches`` (B, n_frontend_tokens, d) at the
    embedding's std 0.02. Each package rounds them to bf16."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.encdec is not None:
        out["frames"] = rng.standard_normal(
            (batch, cfg.encdec.encoder_seq, cfg.d_model), np.float32)
    if cfg.n_frontend_tokens:
        out["patches"] = np.float32(0.02) * rng.standard_normal(
            (batch, cfg.n_frontend_tokens, cfg.d_model), np.float32)
    return out


def zoo_columns(vocab: int, seed: int = 0) -> np.ndarray:
    """The vocab columns a zoo record keeps: all of a row up to
    ZOO_FULL_ROWS wide, else ZOO_COLUMNS of them, seeded and sorted."""
    if vocab <= ZOO_FULL_ROWS:
        return np.arange(vocab, dtype=np.int32)
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(vocab, ZOO_COLUMNS, replace=False)).astype(
        np.int32)


def row_stats(logits) -> dict:
    """Full-row statistics of (..., V) logits that a column subset loses:
    the argmax, the top-2 gap and the std."""
    a = np.asarray(logits, np.float32)
    top2 = np.sort(a, axis=-1)[..., -2:]
    return {"argmax": np.argmax(a, -1).astype(np.int32),
            "gap": (top2[..., 1] - top2[..., 0]).astype(np.float32),
            "std": a.std(axis=-1).astype(np.float32)}


def jax_lm_params(jcfg, arrays):
    """The JAX ``Model``'s parameter tree from numpy float32 arrays, each
    leaf cast to its spec's dtype (bf16 to nearest even, the fp32 leaves
    as they are)."""
    import jax
    import jax.numpy as jnp

    from repro.models.model import Model as JaxModel
    from repro.models.params import ParamSpec as JaxSpec
    return jax.tree.map(lambda s, a: jnp.asarray(a).astype(s.dtype),
                        JaxModel(jcfg).param_specs(), arrays,
                        is_leaf=lambda x: isinstance(x, JaxSpec))


ZOO_MODEL_REL_L2 = 1.5e-2
ZOO_MOE = ("deepseek-moe-16b", "deepseek-v3-671b")


def rel_l2(got, want) -> float:
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    n = np.linalg.norm(w)
    return float(np.linalg.norm(g - w) / n) if n else float(np.abs(g).max())


def assert_model_matches_reference(arch: str):
    """The reduced config of ``arch`` through both packages' ``Model`` in
    bf16 (tests/test_torch_zoo.py's docstring says what and why): a
    prefill of 16 tokens, 4 decode steps, the forward over 20, logits and
    every cache leaf within ZOO_MODEL_REL_L2, ``kpos`` and ``pos`` equal.
    The MoE configs' routers are zeroed."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro import configs as jconfigs
    from repro.models.model import Model as JaxModel
    from repro_torch import configs
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    from repro_torch.models import params as prm
    from repro_torch.models.model import Model

    def host(t):
        return t.float().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t, np.float32)

    cfg, jcfg = configs.reduced_config(arch), jconfigs.reduced_config(arch)
    arr = lm_numpy_params(cfg, 0)
    if arch in ZOO_MOE:
        for path, a in prm.leaves(arr):
            if path.endswith("/router"):
                a[...] = 0.0
    params = lm_params_from_numpy(cfg, arr, "cpu")
    jparams = jax_lm_params(jcfg, arr)
    model, jmodel = Model(cfg), JaxModel(jcfg)
    b, s, max_seq = 2, 16, 24
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (b, s + 4)) \
        .astype(np.int32)
    extra = zoo_inputs(cfg, b)
    tb = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in extra.items()}
    jb = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in extra.items()}
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :s]), **tb}, max_seq=max_seq)
    jlogits, jcache = jax.jit(lambda p, bt: jmodel.prefill(
        p, bt, max_seq=max_seq))(jparams, {"tokens": toks[:, :s], **jb})
    assert logits.dtype == torch.float32 and logits.shape == jlogits.shape
    errs = {"prefill": rel_l2(host(logits), host(jlogits))}

    def caches_match(tag):
        got = dict(prm.leaves(cache["stacks"]))
        want = dict(prm.leaves(jcache["stacks"]))
        assert sorted(got) == sorted(want)
        for path, t in got.items():
            w = np.asarray(want[path])
            assert tuple(t.shape) == w.shape, path
            assert str(t.dtype).split(".")[-1] == w.dtype.name, path
            if path.endswith("kpos"):
                assert np.array_equal(t.numpy(), w), path
            else:
                errs[f"{tag}/{path}"] = rel_l2(host(t), host(w))
        assert cache["pos"] == int(jcache["pos"])

    caches_match("prefill")
    dec = jax.jit(jmodel.decode)
    for i in range(4):
        tok = toks[:, s + i:s + i + 1]
        logits, cache = model.decode(params, cache, torch.from_numpy(tok))
        jlogits, jcache = dec(jparams, jcache, tok)
        errs[f"decode_{i}"] = rel_l2(host(logits), host(jlogits))
        caches_match(f"decode_{i}")
    h, aux = model.forward(params, {"tokens": torch.from_numpy(toks), **tb})
    jh, jaux = jax.jit(jmodel.forward)(jparams, {"tokens": toks, **jb})
    assert h.dtype == torch.bfloat16 and h.shape == jh.shape
    errs["forward"] = rel_l2(host(h), host(jh))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-2,
                               atol=1e-6)
    bad = {k: v for k, v in errs.items() if not v < ZOO_MODEL_REL_L2}
    assert not bad, bad


@pytest.fixture(scope="session")
def surrogate_pairs():
    """{"packable"|"unpackable": (JAX Surrogate, port Surrogate on CPU)},
    both loaded from the committed artifacts."""
    from repro.core.surrogate import Surrogate as JaxSurrogate
    from repro_torch.core.surrogate import Surrogate
    return {name: (JaxSurrogate.load(str(path)),
                   Surrogate.load(str(path), device="cpu"))
            for name, path in (("packable", PACKABLE),
                               ("unpackable", UNPACKABLE))}


# --- LM training: an fp32 reference, train steps of both packages ---------

TRAIN_BATCH = (2, 16)          # global batch, sequence length
TRAIN_REL = 1e-4               # fp32: loss, its parts, grad norm, each grad
TRAIN_BF16_REL = 2e-2          # bf16: the loss (the reference's sharded bound)


class _F32Jnp:
    """``jax.numpy`` as the reference's model module sees it in an fp32
    run: ``bfloat16`` names float32. The reference's ``cfg.dtype`` is
    inert (its model casts activations to bf16 by name), so its fp32 model
    is this module swap, made for the test's duration; no file of the JAX
    package changes."""

    def __init__(self):
        import jax.numpy as jnp
        self._jnp = jnp
        self.bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(self._jnp, name)


@contextlib.contextmanager
def fp32_reference():
    import repro.models.model as jmm
    old = jmm.jnp
    jmm.jnp = _F32Jnp()
    try:
        yield
    finally:
        jmm.jnp = old


def train_batches(cfg, steps: int, *, num_microbatches: int = 1,
                  batch=TRAIN_BATCH, seed: int = 0) -> list:
    """The launcher's batches ``make_train_batch(SyntheticCorpus(vocab,
    seed), step, ...)`` for steps 0 .. steps-1, with the zoo's frames /
    patches (fp32) where the config takes them."""
    from repro_torch.data.lm_data import SyntheticCorpus, make_train_batch
    corpus = SyntheticCorpus(cfg.vocab, seed=seed)
    extras = zoo_inputs(cfg, batch[0])
    return [make_train_batch(corpus, i, global_batch=batch[0], seq=batch[1],
                             num_microbatches=num_microbatches,
                             extras=extras) for i in range(steps)]


def train_opt_kw() -> dict:
    return dict(lr=1e-3, warmup_steps=2, total_steps=10)


def train_models(arch: str, dtype: str = "float32"):
    """(port Model, JAX Model, port params, JAX params) of the reduced
    ``arch`` from ``lm_numpy_params(cfg, 0)``: fp32 leaves for both, or
    each leaf rounded to its spec's dtype (bf16)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models.model import Model as JaxModel
    from repro_torch import configs
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(configs.reduced_config(arch), dtype=dtype)
    jcfg = jconfigs.reduced_config(arch)
    arr = lm_numpy_params(cfg, 0)
    params = lm_params_from_numpy(cfg, arr, "cpu")
    jparams = (jax.tree.map(jnp.asarray, arr) if dtype == "float32"
               else jax_lm_params(jcfg, arr))
    return Model(cfg), JaxModel(jcfg), params, jparams


def train_rel(got, want) -> float:
    return rel_l2(np.asarray(got, np.float64), np.asarray(want, np.float64))


def assert_grads_match(arch: str, grads, jgrads, rel=TRAIN_REL):
    """Every leaf's gradient within relative L2 ``rel``."""
    import jax

    from repro_torch import tree as tr
    got, want = tr.leaves(grads), jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    bad = {}
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape
        err = train_rel(g.float().numpy(), w)
        if not err < rel:
            bad[i] = err
    assert not bad, (arch, bad)


def assert_train_matches_reference(arch: str, steps: int = 3):
    """fp32 training of the reduced ``arch`` through both packages from
    the same weights and batches: the gradient of every leaf at step 0,
    then ``steps`` train steps (AdamW, warmup 2) — each step's loss, ce,
    aux, mtp_ce, tokens, grad_norm and lr within TRAIN_REL, and every
    parameter after the last step within relative L2 TRAIN_REL."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.optim import AdamW as JaxAdamW, AdamWConfig as JaxAdamWConfig
    from repro.train import step as jstep
    from repro_torch import tree as tr
    from repro_torch.data.lm_data import to_device
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.train import step as step_mod

    model, jmodel, params, jparams = train_models(arch)
    batches = train_batches(model.cfg, steps)
    jopt = JaxAdamW(JaxAdamWConfig(**train_opt_kw()))
    opt = AdamW(AdamWConfig(**train_opt_kw()))
    with fp32_reference():
        jgrad = jax.jit(jax.grad(lambda p, b: jmodel.loss(p, b)[0]))(
            jparams, batches[0])
        jtrain = jax.jit(jstep.make_train_step(jmodel, jopt))
        jstate = {"step": jnp.zeros((), jnp.int32), "params": jparams,
                  "opt": jopt.init(jparams)}
        jmets = []
        for b in batches:
            jstate, m = jtrain(jstate, b)
            jmets.append(m)
    _, _, grads = step_mod.loss_and_grads(model, params,
                                          to_device(batches[0], "cpu"))
    assert_grads_match(arch, grads, jgrad)
    train = step_mod.make_train_step(model, opt)
    state = {"step": torch.zeros((), dtype=torch.int32), "params": params,
             "opt": opt.init(params)}
    for i, b in enumerate(batches):
        state, met = train(state, b)
        want = jmets[i]
        assert sorted(met) == sorted(want), (sorted(met), sorted(want))
        for k, v in met.items():
            np.testing.assert_allclose(float(v), float(want[k]),
                                       rtol=TRAIN_REL, atol=1e-7,
                                       err_msg=f"{arch} step {i} {k}")
    assert int(state["step"]) == steps
    bad = {}
    for i, (p, w) in enumerate(zip(tr.leaves(state["params"]),
                                   jax.tree.leaves(jstate["params"]))):
        err = train_rel(p.numpy(), w)
        if not err < TRAIN_REL:
            bad[i] = err
    assert not bad, (arch, bad)


def assert_bf16_step_matches_reference(arch: str):
    """One bf16 train step of the reduced ``arch`` (the configs' own
    dtypes) in both packages: the loss within TRAIN_BF16_REL."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.optim import AdamW as JaxAdamW, AdamWConfig as JaxAdamWConfig
    from repro.train import step as jstep
    from repro_torch import tree as tr
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.train import step as step_mod

    model, jmodel, params, jparams = train_models(arch, "bfloat16")
    batch = train_batches(model.cfg, 1)[0]
    jopt = JaxAdamW(JaxAdamWConfig(**train_opt_kw()))
    opt = AdamW(AdamWConfig(**train_opt_kw()))
    _, jm = jax.jit(jstep.make_train_step(jmodel, jopt))(
        {"step": jnp.zeros((), jnp.int32), "params": jparams,
         "opt": jopt.init(jparams)}, batch)
    state = {"step": torch.zeros((), dtype=torch.int32), "params": params,
             "opt": opt.init(params)}
    _, met = step_mod.make_train_step(model, opt)(state, batch)
    assert all(p.dtype == s.dtype for p, s in zip(
        tr.leaves(params), tr.leaves(model.abstract_params())))
    np.testing.assert_allclose(float(met["loss"]), float(jm["loss"]),
                               rtol=TRAIN_BF16_REL)
    assert np.isfinite(float(met["grad_norm"]))


# --- regeneration (JAX package, CPU) ------------------------------------------


def _regen():
    import importlib.util

    import jax.numpy as jnp

    import repro.lasana as lasana
    from repro.core.dataset import TestbenchConfig, build_dataset
    from repro.core.network import snn_spec
    from repro.core.predictors import PredictorBank
    from repro.core.surrogate import Surrogate
    from repro.kernels import tick_megakernel as mk

    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    print("training lif_packable", flush=True)
    packable = lasana.train("lif", lasana.TrainConfig(
        n_runs=600, n_steps=100, families=("linear", "mlp"), seed=0))
    packable.save(str(PACKABLE))

    print("training lif_unpackable", flush=True)
    ds = build_dataset("lif", TestbenchConfig(n_runs=600, n_steps=100,
                                              seed=0))
    bank = PredictorBank("lif").fit(ds)
    for pname, fam in UNPACKABLE_FAMILIES.items():
        bank.selected[pname] = bank.results[pname][fam].model
    unpackable = Surrogate.from_bank(bank)
    assert dict(unpackable.manifest.families) == UNPACKABLE_FAMILIES
    assert mk.pack_heads(unpackable) == (None, None)
    unpackable.save(str(UNPACKABLE))

    print("training the 784-128-10 ANN", flush=True)
    spec_ = importlib.util.spec_from_file_location(
        "snn_mnist", ROOT / "examples" / "snn_mnist.py")
    snn_mnist = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(snn_mnist)
    ws = [np.asarray(w, np.float32) for w in snn_mnist.train_ann(seed=0)]
    np.savez_compressed(SNN_WEIGHTS, w0=ws[0], w1=ws[1])

    print("recording the reference run", flush=True)
    weights, knobs = snn_weights()
    spec = snn_spec([jnp.asarray(w) for w in weights],
                    [jnp.asarray(p) for p in knobs])
    x, _ = chip_workload()
    record = {}
    for name, (path, fused_kernel) in RECORD_RUNS.items():
        kw = {"backend": "golden"} if path is None else {
            "surrogates": Surrogate.load(str(path)),
            "fused_kernel": fused_kernel}
        run = lasana.simulate(spec, jnp.asarray(x), **kw)
        for f, a in jax_run_fields(run).items():
            record[f"{name}/{f}"] = a
    np.savez_compressed(REF_RECORD, **record)
    for p in (PACKABLE, UNPACKABLE, SNN_WEIGHTS, REF_RECORD):
        print(p.name, os.path.getsize(p), "bytes")


def _load_example(name):
    import importlib.util
    spec_ = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def _regen_crossbar():
    """Write the crossbar and mixed-graph files only."""
    import time

    import jax.numpy as jnp

    import repro.lasana as lasana
    from repro.core.dataset import TestbenchConfig, build_dataset
    from repro.core.network import (crossbar_layer, crossbar_mlp_spec,
                                    graph_spec, lif_layer, recurrent_edge)
    from repro.core.predictors import PredictorBank
    from repro.core.surrogate import Surrogate
    from repro.kernels import tick_megakernel as mk

    t0 = time.time()
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    print("training crossbar_packable", flush=True)
    packable = lasana.train("crossbar", lasana.TrainConfig(
        n_runs=200, n_steps=100, families=("linear", "mlp"), seed=0))
    assert mk.pack_heads(packable)[0] is not None
    packable.save(str(XBAR_PACKABLE))

    print("training crossbar_unpackable", flush=True)
    ds = build_dataset("crossbar", TestbenchConfig(n_runs=200, n_steps=100,
                                                   seed=0))
    bank = PredictorBank("crossbar").fit(ds)
    for pname, fam in UNPACKABLE_FAMILIES.items():
        bank.selected[pname] = bank.results[pname][fam].model
    unpackable = Surrogate.from_bank(bank)
    assert dict(unpackable.manifest.families) == UNPACKABLE_FAMILIES
    assert mk.pack_heads(unpackable) == (None, None)
    unpackable.save(str(XBAR_UNPACKABLE))

    print("training the ternary 400-120-84-10 net", flush=True)
    tern = _load_example("mnist_crossbar").train_ternary_net(seed=0)
    np.savez_compressed(XBAR_WEIGHTS, **{f"w{i}": np.asarray(w, np.int8)
                                         for i, w in enumerate(tern)})
    print("training the 144-24-10 mixed net", flush=True)
    w1, w2 = _load_example("mixed_menage").train_front_and_readout(seed=0)
    np.savez_compressed(MIXED_WEIGHTS, w1=np.asarray(w1, np.int8), w2=w2)

    print("recording the crossbar MNIST runs", flush=True)
    ws, volts, _ = xbar_workload()
    spec = crossbar_mlp_spec([jnp.asarray(w) for w in ws])
    record = {}
    for name, (path, fused_kernel) in XBAR_RECORD_RUNS.items():
        kw = {"backend": "golden"} if path is None else {
            "surrogates": Surrogate.load(str(path)),
            "fused_kernel": fused_kernel}
        run = lasana.simulate(spec, jnp.asarray(volts), **kw)
        for f in RECORD_FIELDS:
            if f != "out_spikes":
                record[f"{name}/{f}"] = np.asarray(getattr(run, f))
    np.savez_compressed(XBAR_RECORD, **record)

    print("recording the mixed-net runs", flush=True)
    w1, w2, knobs, inhib, seq, _ = mixed_workload()
    spec = graph_spec([crossbar_layer(jnp.asarray(w1)),
                       lif_layer(jnp.asarray(w2), jnp.asarray(knobs))],
                      edges=[recurrent_edge(1, 1, inhib)])
    library = lasana.SurrogateLibrary({
        "crossbar": Surrogate.load(str(XBAR_PACKABLE)),
        "lif": Surrogate.load(str(PACKABLE))})
    record = {}
    for name in MIXED_RECORD_RUNS:
        kw = ({"surrogates": library, "fused_kernel": True}
              if name == "lasana" else {"backend": name})
        run = lasana.simulate(spec, jnp.asarray(seq), **kw)
        for f, a in jax_run_fields(run).items():
            record[f"{name}/{f}"] = a
    np.savez_compressed(MIXED_RECORD, **record)
    for p in (XBAR_PACKABLE, XBAR_UNPACKABLE, XBAR_WEIGHTS, MIXED_WEIGHTS,
              XBAR_RECORD, MIXED_RECORD):
        print(p.name, os.path.getsize(p), "bytes")
    print(f"crossbar regen took {time.time() - t0:.0f} s")


def _regen_stream():
    """Write the stream record only: the reference's chunk body
    (``NetworkEngine._scan_chunk``) over 512-tick chunks of
    :func:`stream_blocks`, carries passed from chunk to chunk as its
    stream passes them, then the flush at the stream's end."""
    import time

    import jax
    import jax.numpy as jnp

    from repro.core.network import (NetworkEngine, _iter_chunks, graph_spec,
                                    lif_layer)
    from repro.core.surrogate import Surrogate

    t0 = time.time()
    weights, knobs = snn_weights()
    spec = graph_spec([lif_layer(jnp.asarray(weights[0]),
                                 jnp.asarray(knobs[0]))])
    record = {}
    for name, kw in (("golden", {"backend": "golden"}),
                     ("lasana", {"surrogates": Surrogate.load(str(PACKABLE)),
                                 "fused_kernel": True})):
        eng = NetworkEngine(spec, record_hidden=False, **kw)
        assert eng._chunk_eligible() == (name == "lasana")
        banks = eng._runtime_banks(None)
        cascade = eng._make_cascade()

        @jax.jit
        def body(x, k0, carries, prev, banks):
            ks = k0 + jnp.arange(x.shape[0], dtype=jnp.float32)
            return eng._scan_chunk(cascade, banks, carries, prev, x, ks)

        carries = [eng._init_carry(0, N_IMAGES)]
        prev = [jnp.zeros((N_IMAGES, 128), jnp.float32)]
        counts, es, ls, evs, k0 = 0, [], [], [], 0
        for x in _iter_chunks(stream_blocks(), STREAM_CHUNK, 784):
            (carries, prev), (out_seq, _, e, l, ev) = body(
                jnp.asarray(x), jnp.float32(k0), carries, prev, banks)
            counts = counts + np.asarray(jnp.sum(out_seq > 0.75, axis=0))
            es.append(np.asarray(e)[:, 0])
            ls.append(np.asarray(l)[:, 0])
            evs.append(np.asarray(ev)[:, 0])
            k0 += x.shape[0]
            print(name, k0, f"{time.time() - t0:.0f} s", flush=True)
        t_end = float(np.float32(k0 * eng.circs[0].clock_ns))
        flush = eng._flush(carries[0], 0, jnp.float32(t_end),
                           banks.get("lif"))
        v = carries[0][0][:, 0] if name == "golden" else carries[0].v
        record.update({f"{name}/counts": counts.astype(np.int16),
                       f"{name}/energy": np.concatenate(es),
                       f"{name}/latency": np.concatenate(ls),
                       f"{name}/events": np.concatenate(evs),
                       f"{name}/flush_energy": np.asarray([flush],
                                                         np.float32),
                       f"{name}/v": np.asarray(v, np.float32)})
    np.savez_compressed(STREAM_RECORD, **record)
    print(STREAM_RECORD.name, os.path.getsize(STREAM_RECORD), "bytes,",
          f"{time.time() - t0:.0f} s")


def _regen_wide():
    """Write the wide-surrogate artifact and its SNN record only."""
    import functools
    import time

    import jax.numpy as jnp

    import repro.lasana as lasana
    from repro.core import predictors
    from repro.core.models import MLPModel
    from repro.core.network import snn_spec

    t0 = time.time()
    mlp = predictors.MODEL_FAMILIES["mlp"]
    predictors.MODEL_FAMILIES["mlp"] = functools.partial(
        MLPModel, hidden=WIDE_HIDDEN)
    try:
        wide = lasana.train("lif", lasana.TrainConfig(
            n_runs=300, n_steps=100, families=("mlp",), seed=0))
    finally:
        predictors.MODEL_FAMILIES["mlp"] = mlp
    for p in ("M_ES", "M_V", "M_O", "M_ED", "M_L"):
        assert wide.params[p]["w0"].shape[1] == WIDE_HIDDEN[0]
        assert wide.params[p]["w1"].shape[1] == WIDE_HIDDEN[1]
    wide.save(str(WIDE))
    print(f"trained in {time.time() - t0:.0f} s", flush=True)
    weights, knobs = snn_weights()
    spec = snn_spec([jnp.asarray(w) for w in weights],
                    [jnp.asarray(p) for p in knobs])
    x, _ = chip_workload(WIDE_IMAGES)
    run = lasana.simulate(spec, jnp.asarray(x),
                          surrogates=lasana.load(str(WIDE)))
    np.savez_compressed(WIDE_RECORD, **{
        f"lasana_wide/{f}": a for f, a in jax_run_fields(run).items()})
    for p in (WIDE, WIDE_RECORD):
        print(p.name, os.path.getsize(p), "bytes")
    print(f"wide regen took {time.time() - t0:.0f} s")


def _regen_train():
    """Write the LIF training record only (JAX on the CPU, ~5 min)."""
    import time

    from repro.core.circuits import LIFNeuron
    from repro.core.dataset import (CircuitDataset, TestbenchConfig,
                                    generate_testbench, simulate_golden)
    from repro.core.events import EventKind, extract_events, split_runwise
    from repro.core.models import GBDTModel
    from repro.core.predictors import (PREDICTOR_DEFS, PredictorBank,
                                       build_features, build_target)

    t0 = time.time()
    cfg = TestbenchConfig(n_runs=1000, n_steps=125, alpha=0.8, seed=0)
    circ = LIFNeuron()
    active, inputs, params = generate_testbench(circ, cfg)
    trace = simulate_golden(circ, active, inputs, params)
    events = extract_events(trace)
    train, test, val = split_runwise(events, cfg.n_runs, seed=cfg.seed)
    ds = CircuitDataset("lif", train=train, test=test, val=val,
                        gen_seconds=0.0, n_runs=cfg.n_runs)
    record = {"active": np.asarray(active), "inputs": np.asarray(inputs),
              "params": np.asarray(params), "n_runs": np.int32(cfg.n_runs),
              "n_steps": np.int32(cfg.n_steps),
              "alpha": np.float32(cfg.alpha), "seed": np.int32(cfg.seed)}
    for k in EventKind:
        sel = events.kind == int(k)
        record[f"count/{k.name}"] = np.int64(sel.sum())
        record[f"energy/{k.name}"] = np.float64(events.energy[sel].sum())
    for name, split in (("train", train), ("test", test), ("val", val)):
        record[f"split_count/{name}"] = np.int64(len(split))
    t_data = time.time() - t0
    bank = PredictorBank("lif", families=FAMILIES).fit(ds, verbose=True)
    for p, fams in bank.results.items():
        for f, r in fams.items():
            record[f"val_mse/{p}/{f}"] = np.float64(r.val_mse)
            record[f"test_mse/{p}/{f}"] = np.float64(r.test_mse)
        best = min(fams.values(), key=lambda r: r.val_mse)
        record[f"selected/{p}"] = np.array(best.family)
        d = PREDICTOR_DEFS[p]
        rows = []
        for split in (ds.train, ds.val):
            ev = split.of_kind(*d["kinds"])
            rows.append(np.asarray(bank.augment_features(build_features(
                ev, prev_out=d["prev_out"],
                chain_out=d.get("chain_out", False)))))
            rows.append(build_target(ev, d["target"], d["scale"]))
        band = []
        for k in range(GBDT_BAND_REFITS):
            y = rows[1].copy()
            nudge = np.random.default_rng(k).random(len(y)) < 0.01
            y[nudge] = np.nextafter(y[nudge], np.float32(np.inf))
            m = GBDTModel().fit(rows[0], y, rows[2], rows[3])
            band.append(float(np.mean((m.predict(rows[2]) - rows[3]) ** 2)))
        record[f"gbdt_band/{p}"] = np.asarray(band, np.float64)
        print(p, "gbdt band", min(band), max(band), flush=True)
    np.savez_compressed(TRAIN_RECORD, **record)
    print(TRAIN_RECORD.name, os.path.getsize(TRAIN_RECORD), "bytes;",
          f"dataset {t_data:.0f} s, total {time.time() - t0:.0f} s")


def _regen_lm():
    """Write the LM record only (JAX on the CPU)."""
    import dataclasses
    import time

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models.model import Model
    from repro_torch import configs
    from repro_torch.convert import lm_numpy_params
    from repro_torch.data.lm_data import SyntheticCorpus

    t0 = time.time()
    n = LM_RECORD_LAYERS
    cfg = dataclasses.replace(configs.get_config("starcoder2-3b"), n_layers=n)
    arrays = lm_numpy_params(cfg, 0)
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                          arrays)
    del arrays
    t_draw = time.time() - t0
    model = Model(dataclasses.replace(get_config("starcoder2-3b"), n_layers=n))
    b, s = LM_PROMPT
    tokens = SyntheticCorpus(cfg.vocab, seed=0).batch(0, b, s)
    max_seq = s + LM_DECODE_STEPS
    logits, cache = jax.jit(lambda p, t: model.prefill(
        p, {"tokens": t}, max_seq=max_seq))(params, tokens)
    prefill = np.asarray(logits[:, 0], np.float32)
    t_prefill = time.time() - t0 - t_draw
    decode = jax.jit(model.decode)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    fed, dec_logits = [], []
    for _ in range(LM_DECODE_STEPS):
        fed.append(np.asarray(tok)[:, 0])
        logits, cache = decode(params, cache, tok)
        dec_logits.append(np.asarray(logits[:LM_DECODE_ROWS, 0], np.float32))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for a in (prefill, *dec_logits):
        # bf16 values fit float16 exactly down to its subnormals (6e-8)
        err = np.abs(a.astype(np.float16).astype(np.float32) - a)
        assert float(err.max()) <= 2.0 ** -25 and np.abs(a).max() < 6e4
    np.savez_compressed(
        LM_RECORD, tokens=tokens, prefill_logits=prefill.astype(np.float16),
        decode_tokens=np.stack(fed, 1).astype(np.int32),
        decode_logits=np.stack(dec_logits).astype(np.float16),
        n_layers=np.int32(n), seed=np.int32(0))
    print(LM_RECORD.name, os.path.getsize(LM_RECORD), "bytes;",
          f"weights {t_draw:.1f} s, prefill {t_prefill:.1f} s, total "
          f"{time.time() - t0:.1f} s")


def _regen_zoo(arch: str):
    """Write one zoo record (JAX on the CPU): the reference ``Model`` of
    ``arch`` at full width cut to its record depth (:func:`zoo_record_config`)
    with ``lm_numpy_params(cut, 0)``, each leaf rounded to its dtype and
    freed from float32 one at a time."""
    import time

    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from repro.configs import get_config
    from repro.models.model import Model
    from repro.models.params import ParamSpec as JaxSpec
    from repro_torch import configs
    from repro_torch.convert import lm_numpy_params
    from repro_torch.data.lm_data import SyntheticCorpus

    t0 = time.time()
    cut = zoo_record_config(configs.get_config(arch), arch)
    jcut = zoo_record_config(get_config(arch), arch)
    arrays = lm_numpy_params(cut, 0)
    t_draw = time.time() - t0

    def to_jax(spec, holder, key):
        a = holder[key]
        holder[key] = None
        if np.dtype(spec.dtype) == np.dtype(ml_dtypes.bfloat16):
            a = a.astype(ml_dtypes.bfloat16)
        return jnp.asarray(a)

    def walk(specs, holder):
        keys = range(len(specs)) if isinstance(specs, list) else specs
        for k in keys:
            if isinstance(specs[k], JaxSpec):
                holder[k] = to_jax(specs[k], holder, k)
            else:
                walk(specs[k], holder[k])
    model = Model(jcut)
    walk(model.param_specs(), arrays)
    params = arrays
    _, b, s = ZOO_RECORDS[arch]
    tokens = SyntheticCorpus(cut.vocab, seed=0).batch(0, b, s)
    batch = {"tokens": tokens}
    for k, v in zoo_inputs(cut, b).items():
        batch[k] = jnp.asarray(v).astype(jnp.bfloat16)
    max_seq = s + LM_DECODE_STEPS
    logits, cache = jax.jit(lambda p, bt: model.prefill(
        p, bt, max_seq=max_seq))(params, batch)
    prefill = np.asarray(logits[:, 0], np.float32)
    t_prefill = time.time() - t0 - t_draw
    decode = jax.jit(model.decode)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    fed, dec_logits = [], []
    for _ in range(LM_DECODE_STEPS):
        fed.append(np.asarray(tok)[:, 0])
        logits, cache = decode(params, cache, tok)
        dec_logits.append(np.asarray(logits[:, 0], np.float32))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    dec = np.stack(dec_logits)
    for a in (prefill, dec):
        # bf16 values fit float16 exactly down to its subnormals (6e-8)
        err = np.abs(a.astype(np.float16).astype(np.float32) - a)
        assert float(err.max()) <= 2.0 ** -25 and np.abs(a).max() < 6e4
    cols = zoo_columns(cut.vocab)
    record = {"tokens": tokens.astype(np.int32), "columns": cols,
              "prefill_logits": prefill[:, cols].astype(np.float16),
              "decode_tokens": np.stack(fed, 1).astype(np.int32),
              "decode_logits": dec[..., cols].astype(np.float16),
              "n_layers": np.int32(cut.n_layers), "seed": np.int32(0),
              "input_seed": np.int32(ZOO_INPUT_SEED),
              "vocab": np.int32(cut.vocab)}
    for name, a in (("prefill", prefill), ("decode", dec)):
        for k, v in row_stats(a).items():
            record[f"{name}_{k}"] = v
    path = zoo_record_path(arch)
    np.savez_compressed(path, **record)
    print(path.name, os.path.getsize(path), "bytes;",
          f"weights {t_draw:.1f} s, prefill {t_prefill:.1f} s, total "
          f"{time.time() - t0:.1f} s", flush=True)


def _regen_layer():
    """Write the layer record only (JAX on the CPU)."""
    import time

    from repro.core.simulate import (make_stimulus, run_behavioral,
                                     run_golden, run_lasana)
    from repro.core.surrogate import Surrogate

    t0 = time.time()
    record = {}
    for kind, circuit, (n, t_steps, seed), runs in (
            ("lif", "lif", LAYER_LIF, LAYER_LIF_RUNS),
            ("xbar", "crossbar", LAYER_XBAR, LAYER_XBAR_RUNS)):
        active, x, params = (np.asarray(a) for a in make_stimulus(
            circuit, n, t_steps, seed=seed))
        record[f"{kind}/active"] = np.packbits(active, axis=-1)
        record[f"{kind}/x"] = x.astype(np.float32)
        record[f"{kind}/params"] = (params.astype(np.int8) if kind == "xbar"
                                    else params.astype(np.float32))
        golden = run_golden(circuit, active, x, params)
        beh = run_behavioral(circuit, active, x, params)
        for name, (path, mode) in runs.items():
            if mode == "golden":
                run = golden
            elif mode == "behavioral":
                run = beh
            else:
                sur = Surrogate.load(str(path))
                kw = {"p": {}, "o": {"oracle_states": golden.states},
                      "annotate": {"oracle_states": beh.states,
                                   "annotate_outputs": beh.outputs}}[mode]
                run = run_lasana(sur, circuit, active, x, params, **kw)
            record.update(layer_summary(run, kind, f"{kind}/{name}"))
    np.savez_compressed(LAYER_RECORD, **record)
    print(LAYER_RECORD.name, os.path.getsize(LAYER_RECORD), "bytes;",
          f"{time.time() - t0:.0f} s")


def _regen_serve():
    """Write the wire record only (the reference's server on the CPU)."""
    import io
    import json
    import time

    import repro.lasana as lasana
    from repro.serve import run_stdio

    t0 = time.time()
    script = wire_script()
    fin = io.StringIO("".join(json.dumps(o) + "\n"
                              for o in wire_ops(script)))
    fout = io.StringIO()
    with lasana.serve(slot_widths=WIRE_SLOT_WIDTHS,
                      chunk_ticks=WIRE_CHUNK) as srv:
        run_stdio(srv, fin, fout)
    record = {"slot_widths": list(WIRE_SLOT_WIDTHS),
              "chunk_ticks": WIRE_CHUNK, "script": script,
              "responses": [json.loads(l)
                            for l in fout.getvalue().splitlines()]}
    WIRE_RECORD.write_text(json.dumps(record, indent=1) + "\n")
    print(WIRE_RECORD.name, os.path.getsize(WIRE_RECORD), "bytes;",
          f"{time.time() - t0:.0f} s")


def _regen_dse():
    """Write the DSE record only (JAX on the CPU)."""
    import json
    import time

    import jax

    from repro.configs import get_config
    from repro.core.circuits import CrossbarRow
    from repro.core.explore import CandidateSpec, DSEEngine, explore_arch
    from repro.core.surrogate import Surrogate

    t0 = time.time()
    sur = Surrogate.load(str(XBAR_UNPACKABLE))
    cands = CandidateSpec.sample(DSE_CANDIDATES, seed=0)
    eng = DSEEngine(n_samples=DSE_SAMPLES)
    rep = eng.evaluate(cands, sur)
    record = {"base_x": np.asarray(eng._base_x, np.float32),
              "base_p": np.asarray(eng._base_p).astype(np.int8),
              "base_o": np.asarray(eng._base_o, np.float32),
              "v_dd": cands.v_dd, "tile": cands.tile,
              "pareto": rep.pareto()}
    for f in DSE_REPORT_FIELDS:
        record[f"report/{f}"] = getattr(rep, f)
    # tile_energy_latency's rows (seed 0, 2,048 samples), as it draws them
    circ = CrossbarRow()
    kx, kp, ko = jax.random.split(jax.random.PRNGKey(0), 3)
    record["tile_x"] = np.asarray(circ.sample_inputs(kx, (2048,)),
                                  np.float32)
    record["tile_p"] = np.asarray(circ.sample_params(kp, 2048)).astype(
        np.int8)
    record["tile_o"] = np.asarray(jax.random.uniform(
        ko, (2048,), np.float32, -2, 2), np.float32)
    for arch in DSE_ARCHS:
        tr = explore_arch(get_config(arch), sur)
        for f in ARCH_FIELDS:
            record[f"arch/{arch}/{f}"] = np.asarray(getattr(tr, f))
        record[f"arch/{arch}/tiles_by_component"] = np.array(
            json.dumps(tr.tiles_by_component))
    np.savez_compressed(DSE_RECORD, **record)
    print(DSE_RECORD.name, os.path.getsize(DSE_RECORD), "bytes;",
          f"{time.time() - t0:.0f} s")


def _regen_lm_train():
    """Write the LM training record only (JAX on the CPU)."""
    import dataclasses
    import time

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models.model import Model
    from repro.optim import AdamW, AdamWConfig
    from repro.train import step as jstep
    from repro_torch import configs
    from repro_torch.convert import lm_numpy_params
    from repro_torch.models import params as prm

    t0 = time.time()
    n = LM_TRAIN_LAYERS
    cfg = dataclasses.replace(configs.get_config("starcoder2-3b"),
                              n_layers=n, dtype="float32")
    arrays = lm_numpy_params(cfg, 0)
    paths = [path for path, _ in prm.leaves(arrays)]
    params = jax.tree.map(jnp.asarray, arrays)
    model = Model(dataclasses.replace(get_config("starcoder2-3b"),
                                      n_layers=n))
    opt = AdamW(AdamWConfig(**LM_TRAIN_OPT))
    batches = train_batches(cfg, LM_TRAIN_STEPS, batch=LM_TRAIN_BATCH)
    out = {}
    with fp32_reference():
        grads = jax.jit(jax.grad(lambda p, b: model.loss(p, b)[0]))(
            params, batches[0])
        gflat = dict(prm.leaves(jax.tree.map(np.asarray, grads)))
        for path in paths:
            out[f"grad_norm/{path}"] = np.float64(
                np.linalg.norm(gflat[path].astype(np.float64)))
        del grads, gflat
        train = jax.jit(jstep.make_train_step(model, opt))
        state = {"step": jnp.zeros((), jnp.int32), "params": params,
                 "opt": opt.init(params)}
        mets = []
        for b in batches:
            state, m = train(state, b)
            mets.append({k: float(v) for k, v in m.items()})
    for k in ("loss", "grad_norm", "lr"):
        out[k] = np.asarray([m[k] for m in mets], np.float64)
    after = dict(prm.leaves(jax.tree.map(np.asarray, state["params"])))
    before = dict(prm.leaves(arrays))
    for path in paths:
        out[f"update_norm/{path}"] = np.float64(np.linalg.norm(
            after[path].astype(np.float64) - before[path]))
    out["n_layers"] = np.int64(n)
    out["batch"] = np.asarray(LM_TRAIN_BATCH, np.int64)
    np.savez(LM_TRAIN_RECORD, **out)
    print(f"wrote {LM_TRAIN_RECORD.name}: losses {out['loss']}, "
          f"{time.time() - t0:.0f} s")


if __name__ == "__main__":
    if sys.argv[1:] == ["--regen"]:
        _regen()
        _regen_crossbar()
        _regen_stream()
        _regen_lm()
        _regen_lm_train()
        for arch in ZOO_RECORDS:
            _regen_zoo(arch)
        _regen_wide()
        _regen_train()
        _regen_layer()
        _regen_dse()
        _regen_serve()
    elif sys.argv[1:] == ["--regen-crossbar"]:
        _regen_crossbar()
    elif sys.argv[1:] == ["--regen-stream"]:
        _regen_stream()
    elif sys.argv[1:] == ["--regen-lm"]:
        _regen_lm()
    elif sys.argv[1:] == ["--regen-lm-train"]:
        _regen_lm_train()
    elif sys.argv[1:2] == ["--regen-zoo"] and len(sys.argv) <= 3:
        for arch in sys.argv[2:] or ZOO_RECORDS:
            _regen_zoo(arch)
    elif sys.argv[1:] == ["--regen-wide"]:
        _regen_wide()
    elif sys.argv[1:] == ["--regen-train"]:
        _regen_train()
    elif sys.argv[1:] == ["--regen-layer"]:
        _regen_layer()
    elif sys.argv[1:] == ["--regen-dse"]:
        _regen_dse()
    elif sys.argv[1:] == ["--regen-serve"]:
        _regen_serve()
    else:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_fixtures.py "
                 "--regen | --regen-crossbar | --regen-stream | --regen-lm | "
                 "--regen-lm-train | "
                 "--regen-zoo [ARCH] | --regen-wide | --regen-train | "
                 "--regen-layer | --regen-dse | --regen-serve")
