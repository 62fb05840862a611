#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one output line each (JSON where it helps):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at a ragged N, and time both on the device
   (CUDA events, median of 25 calls after warm-up); the time-looped
   kernels (``network_tick_chunk``, ``lif_chunk``, T = 64) also against 64
   launches of their one-tick kernels, bit for bit, and ``lif_chunk`` at
   the golden simulations' N = 2,000 and 1,000 x T = 125 too (digested,
   timed, against 125 ``lif_step`` launches; at 1,000, training's shape,
   also the per-tick V_mem output ``v_seq`` against the state of 125
   chained ``lif_step`` launches, bit for bit); ``network_tick``'s,
   the head kernels' and the golden kernels' outputs digested (SHA-256)
   case by case and held to the committed digests of their first designs
   (``TICK_DIGESTS``, ``HEADS_DIGESTS``, ``LIF_DIGESTS``,
   ``XBAR_DIGESTS``), ``network_tick`` also at the widest heads it takes;
   the golden kernels (``lif_step``, ``crossbar_target``) timed at every
   main-path shape beside an empty launch, and their generic instances
   (other substep counts, rows narrower than 32) held against the plain
   versions too; the branch-free division they share (``quot.cuh``) held
   to IEEE division bit for bit over some 25 million operand pairs;
   ``mlp_surrogate_heads`` / ``mlp_surrogate`` also at widths the first
   design refused (F = 100 with MLP(200, 50), and F = 80 with MLP(512,
   256) heads larger than shared memory, staged in slices),
   ``mlp_surrogate`` timed on fp32 and bf16 rows and its wrapper's cast
   of fp16 rows checked; the Python
   copies of ``network_tick``'s routing rules (``kernel_takes``,
   ``chunk_takes``) against the compiled rules over a sweep of widths;
   ``flash_attention``'s tensor-core route at q 96 x 512 x 128 and the
   serve run's q 192 x 512 x 128 (bf16, G = 12), S = 4,096 on its first
   KV group and a ragged S = 500, each within 3e-2, within about one bf16
   ulp and with few outputs off the plain version's; G = 12 equal to G =
   1 on repeated K/V and causality; each timed shape beside one library
   call (``scaled_dot_product_attention``, never called by the port); and
   its fp32-core route on the reference test's fp32 shapes (2e-5) and at
   D = 8, counted apart; and at the other zoo configs' serve prefills
   (deepseek-moe-16b q 128 x 512 x 128, pixtral-12b 256 x 1,536 x 128 G =
   4, whisper-base 64 x 512 x 64), each timed beside the plain version
   and SDPA; ``gbdt_walk`` on the unpackable artifacts' M_ES heads at
   1.28 M x 10 and 312,000 x 68 rows (and ragged N) against the plain
   version, timed beside it, and on integer-leaf forests bit for bit in
   its shared-memory and global-table instances; then the program audit
   (``audit`` lines): every entrypoint of
   ``repro_torch.analysis.jaxpr_audit`` built on the card and run at 1, 2
   and 3 ticks under sync debug mode "error", free of findings, its
   launches per tick and fixed equal to the frozen ``kernels`` row of
   ``program_budgets.json`` and its dispatches to the CPU's, with the
   CUDA kernels per tick that ``torch.profiler`` sees beside the frozen
   CPU count of aten ops;
4. drive the main paths through ``repro_torch.lasana.simulate``, each run
   with the kernel launch counters reset before it and read after it, a
   second (steady) run enqueued with host synchronisation forbidden, and
   its records compared with the JAX reference record committed beside
   the artifacts:
   - the 784-128-10 spiking-MNIST SNN on 100 synthetic digits for 100
     ticks: golden, lasana with a packable and with an unpackable
     surrogate; and on the first 20 digits lasana with a surrogate whose
     five heads are all MLP(200, 50), wider than ``network_tick`` takes
     (the stacked-dispatch tick, through ``mlp_surrogate_heads``);
   - the ternary 400-120-84-10 crossbar MNIST net on 200 digits as one
     combinational wave (385,200 crossbar rows): golden, lasana packable,
     lasana unpackable;
   - the 144-24-10 crossbar -> LIF net with lateral inhibition on 64
     digits held for 30 ticks: golden, behavioral, lasana with the
     {crossbar, lif} library (one cross-kind head pack);
5. stream through ``repro_torch.lasana.simulate_stream`` / ``stream`` /
   ``resume`` over 2,000 ticks of a host generator (250-tick blocks, 512-
   tick chunks): the SNN (golden, lasana packable) and its hidden layer
   alone (one ``lif_chunk`` / ``network_tick_chunk`` launch per chunk),
   each equal to its monolithic run bit for bit, the hidden layer also
   held against its committed JAX record; a killed stream resumed from a
   saved checkpoint; a surrogate hot swap per chunk; peak device memory
   against the monolithic run and a 1,024-tick stream; then batch
   parallelism (``mesh=``): the SNN's 100 digits on a one-shard mesh
   (equal to the unsharded run bit for bit) and on a 2-shard mesh of this
   card (identical spikes, outputs and events, energy, latency and flush
   within rtol 1e-5, the JAX record's limits), the sharded stream, and
   ``make_distributed_step`` at N = 12,800 against ``lasana_step``;
6. the LM zoo's serve path, StarCoder2-3B (30 layers, d 3072, 24 heads
   over 2 KV heads) at full width: numpy-seeded parity weights
   (``convert.lm_numpy_params``), the committed JAX record's 4 x 512
   prefill and 8 teacher-forced decode steps at the record's depth (its
   first 4 layers; per-row relative L2 of the logits <= 3e-2, argmax
   equal where the top-2 gap is decided), the full-depth prefill (30
   ``flash_attention`` launches), two decode steps against ``forward``,
   then ``repro_torch.launch.serve`` with ``Model.init``'s weights at
   batch 8 x 512 + 64 (first and steady prefill / decode times, tokens/s,
   peak device bytes, finite logits); then the other six configs at full
   width, one after another, each freed before the next: (a) its
   committed JAX record at the record's depth (deepseek-moe-16b 2 layers,
   deepseek-v3-671b its 3 dense MLA layers, mamba2-1.3b 4, recurrentgemma-
   2b 3, whisper-base all 6 + 6 on 1,500 frames, pixtral-12b 2 on 1,024
   patches + 512 tokens; parity weights, prefill and 8 teacher-forced
   decode steps, the same limits as StarCoder2-3B's over the record's
   vocab columns, the argmax over the full row), (c)
   ``repro_torch.launch.serve`` with ``Model.init``'s weights at batch 8
   x 512 + 64 (pixtral 1,536, recurrentgemma 2,048) at the serve depth
   (``ZOO_SERVE_LAYERS``: whisper's whole 6 + 6; V3's 3 dense MLA layers
   + 1 MoE layer of 256 experts; the deeper stacks' first 8 layers), (b)
   decode against forward over prompt + 2 at that depth on weights of the
   parity distribution drawn on the card (the MoE configs at capacity
   factor 4, no assignment dropped), and (d) V3's full-width MoE layer:
   router logits against the CPU's, top-8 ids and the capacity drop set
   against the same selection on the CPU, the output at ample capacity
   against the dense mixture; ``flash_attention`` launched exactly by the
   causal self-attention layers of deepseek-moe-16b, pixtral-12b and
   whisper-base's decoder; then LM training: StarCoder2-3B at full width
   cut to 2 layers, fp32 with TF32 off, against the committed JAX record
   of the reference's ``make_train_step`` (``starcoder2_3b_train_ref_
   record.npz``: 3 steps' loss and grad norm within 1e-4, every leaf's
   step-0 gradient norm within 1e-3 and > 0, every leaf's update norm
   within 1e-2), ``repro_torch.launch.train`` at full width and depth in
   bf16 (batch 8 x 128, 12 steps, the final ~30 GB checkpoint on the
   disk with the most room: finite losses falling, steady step seconds,
   tokens/s, peak device bytes, the idle share of two traced steps, no
   ``flash_attention`` launch), and at 4 layers a crash at step 6 and a
   resume from the step-4 checkpoint against the uninterrupted run
   (losses within 1e-2); then tensor parallelism (the tp phase), each
   sharded run against the port's own unsharded one on the same weights:
   StarCoder2-3B at full width and depth through ``launch.serve
   --model-parallel 2`` on a (1, 2) mesh of the card (parity-distribution
   weights, the sharded decode fed the unsharded run's greedy tokens:
   prefill logits within 5e-2 of max |logit|, every decided token equal,
   ``flash_attention`` once per shard per layer, each entry's parameter
   bytes equal to ``params.shard_bytes``), 4 layers on (1, 4) and with
   ``--kv-seq`` on (1, 2), and in fp32 with TF32 off the (1, 2) serve
   path and one AdamW step on a (2, 2) mesh (logits, loss, grad and
   update norms, each leaf's gradient and values within 1e-5);
7. train at the reference's scale (``TrainConfig()``: 1,000 runs x 125
   steps, all five families): LIF on the committed JAX record's own
   testbench (``train_lif_ref_record.npz``) through ``simulate_golden``
   (one ``lif_chunk`` launch recording V_mem), ``extract_events``,
   ``split_runwise`` and a ``PredictorBank`` on the card, its event
   counts, energies, every family's validation MSE and the selection held
   to the record; crossbar through ``repro_torch.lasana.train`` (125
   ``crossbar_step`` launches, counted as ``crossbar_target``; the MLP
   heads' validation passes and predictions through ``mlp_surrogate``);
   the port's LIF testbench's distribution; one GBDT fit on the card
   against the CPU (nodes differing, validation MSE); the trained
   surrogates on the SNN and the crossbar MNIST wave against the port's
   golden runs, beside the committed JAX-trained artifacts; and
   ``mlp_surrogate`` timed at the training shapes;
8. the layer runners (``repro_torch.core.simulate``) and design-space
   exploration (``repro_torch.lasana.explore``): the quickstart's layers
   (LIF N = 1,000 x T = 100, crossbar rows N = 128 x T = 30) on the
   committed JAX record's stimulus through golden, behavioral, LASANA-P,
   LASANA-O and annotation (``layer_ref_record.npz``: spike or ADC-code
   agreement, energy and latency sums; the LASANA-P tick loop also
   enqueued with host synchronisation forbidden); Table IV's scaling (N =
   10 ... 200,000 x 100 ticks: the four runners' walls and LASANA-P's
   speedups); Table III's propagation (N = 20,000: LASANA-O against
   LASANA-P against golden); ``lasana.explore`` over 4,096 candidates x
   256 samples against ``dse_ref_record.npz`` (tile table, pricing within
   rtol 1e-5, the Pareto set, ``explore_arch`` of all ten configs)
   with a hot swap that sets nothing up; and ``lif_chunk``,
   ``network_tick`` and ``mlp_surrogate_heads`` against their plain
   versions at these runs' shapes, timed beside their bounds;
9. serve through ``repro_torch.serve.scheduler.Lane`` (continuous
   batching over ``NetworkEngine.slot_programs``, every slot step enqueued
   with host synchronisation forbidden): the SNN's 100 digits x 100 ticks
   as 12 requests of 1-16 digits on one 32-slot lane at 16 ticks a chunk,
   admitted as slots free (most join mid-stream and leave mid-chunk),
   each digit's spikes against the JAX record (>= 99%, energy within 1%)
   and each request against its solo ``simulate`` (outputs, spikes and
   events bit for bit, energy / flush / latency at rtol 1e-5), timed
   (events/s and requests/s against the solo runs, host time per step);
   eight requests of 5-100 ticks and 1-4 digits on 16 slots; the
   one-LIF-layer 784-128 spec (``network_tick_chunk``), the unpackable
   surrogate (``mlp_surrogate_heads``), the mixed net and a behavioral
   lane (handles flagged ``degraded``), each request against its solo
   run; a second lane with M_ES weights x 1.001 that builds nothing;
   ``surrogate.nan``, ``lane.step`` and ``chunk.stall`` fault plans; and
   ``network_tick``, ``network_tick_chunk`` and ``mlp_surrogate_heads``
   against their plain versions at a 32-slot lane's shapes;
10. serve through the server (``repro_torch.lasana.serve``: the
   ``SimServer`` driver thread, the artifact store, the JSON-lines
   protocol): the same 12 requests of the SNN submitted by three client
   threads as three tenants, the artifact registered by path (loaded once,
   on the card) and the spec by name, each request against its solo run
   and the spikes against the JAX record, the build count against one
   lane's, then timed again on the warm server (requests/s, events/s,
   p50 / p99 latency from submit to the last chunk, host ms per
   ``SimServer.step`` and ``Lane.step``, occupancy) beside the ``Lane``
   run and the solo runs of phase 9; a hot swap to ``lif`` version 2
   while version-1 requests are in flight (builds nothing); ``lane.step``
   retried, ``surrogate.nan`` degrading the spec to the behavioral
   backend, ``chunk.stall`` past the watchdog's limit, a truncated artifact
   and an expired deadline, each ending as the reference's server ends it;
   and ``python -m repro_torch.serve`` as a subprocess fed the committed
   wire record's script (``serve_wire_record.json``) on stdin, its
   responses against the same script run in this process and against the
   reference's recorded responses;
11. the dry run (``repro_torch.launch.dryrun``): ``run_cell`` of
   StarCoder2-3B decode_32k on the (16, 16) production mesh of meta
   entries and ``dryrun_lasana.run`` of one Algorithm-1 tick of 2^20 LIF
   circuits on it with the committed artifact, their per-device numbers,
   roofline terms and seconds, the card's allocated bytes unchanged and
   no kernel launched across them (``dryrun``); then the dry run held to
   the card (``dryrun_check``): StarCoder2-3B at full width and depth in
   bf16 on a (1, 1) mesh, the prefill at batch 8 x 512 and one decode
   step against an 8 x 512 cache, and one tick of 2^20 LIF circuits on
   one entry: argument bytes equal to the tensors placed on the card, the
   peak live bytes within 20% of ``max_memory_allocated`` over the step
   with the arguments resident, the roofline's time beside the step's
   and ``network_tick``'s (reported);
12. a ``{"kernels": [...]}`` line: per kernel its launches on the main
   paths (summed, and by run), its largest difference from the plain
   version, its time, the plain version's time, its lower bound on
   this card (reckoned by the kernel's ``work`` function, as the dry run
   reckons it) and, where one exists, a library call's time
   (crossbar-width times of the head kernels beside the LIF ones);
13. ``{"ok": true, "device": {...}}`` as the last line.

``--profile`` adds, to each main-path line, the device time by kernel of
one more steady run under ``torch.profiler`` (for the stream phase: one
more steady stream of the SNN and of its hidden layer; for the LM phase:
one more prefill and decode loop of the serve run; for the train phase:
one more LIF training on a fifth of the testbench; for the layer phases:
golden and LASANA-P at N = 200,000, LASANA-O at N = 20,000 and one more
exploration sweep; for the serve phase: one more served run of the SNN's
12 requests).

``--digests`` only prints the digests of the head, tick and golden
(``lif_step``, ``lif_chunk``, ``crossbar_target``) kernels' outputs on the
check cases and the golden kernels' and ``mlp_surrogate``'s times at the
main path's shapes; with ``--src DIR`` they come from the ``repro_torch``
under DIR (another commit's kernels on the same inputs), which is how the
committed digests were taken. ``--parent DIR`` runs that in a subprocess
and puts the other commit's times beside this tree's in the ``kernels``
line.

Any failed phase raises, and the script exits non-zero. It needs CUDA and
the repository's ``src/``; without either it fails before printing a
result. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
ART = ROOT / "src" / "repro_torch" / "artifacts"
sys.path.insert(0, str(ROOT / "src"))

# the H100's published peaks and clock, and each kernel's work, come from
# the port (launch/roofline.py, the kernels' ``work`` functions): the
# kernels' bound columns and the dry run reckon from one source

N_MAIN = 12800          # layer-1 neurons on the main path (100 x 128)
N_RAGGED = 12837        # not a multiple of any block size
N_XBAR = 312000         # crossbar MNIST layer-1 rows (200 x 120 x 13)
N_XBAR_RAGGED = 312037
N_MIXED_XBAR = 7680     # mixed-net crossbar rows per tick (64 x 24 x 5)
# every shape the golden kernels take on the main paths: lif_step per
# tick (SNN layers 100 x 128 and 100 x 10, the mixed net's 64 x 10) and
# crossbar_target per layer (crossbar MNIST 200 x 120 x 13, 200 x 84 x 4,
# 200 x 10 x 3 rows; the mixed net's 64 x 24 x 5 per tick)
LIF_SHAPES = (N_MAIN, 1000, 640)
XBAR_SHAPES = (N_XBAR, 67200, 6000, N_MIXED_XBAR)
LIF_OBS = ("output", "energy", "latency", "spiked")
# the golden kernels' generic instances (a runtime substep count, rows
# narrower than CrossbarRow's 32): their circuits' fields and row counts,
# ragged at both of crossbar_mvm.plan's tile sizes
LIF_GENERIC = ({"n_substeps": 32},)
XBAR_GENERIC = ({"n_inputs": 16}, {"n_substeps": 32},
                {"n_inputs": 16, "n_substeps": 32})
N_GENERIC_LIF = (1000, N_RAGGED)
N_GENERIC_XBAR = (7699, N_XBAR_RAGGED)
T_GENERIC = 8           # ticks of the generic lif_chunk case
QUOT_PAIRS = 1 << 22    # operand pairs per random part of the quot check
N_WIDE = 4099           # rows of the widest-heads network_tick cases
N_GBDT = 1_280_000      # the GBDT cell's layer-1 rows (10,000 x 128)
N_GBDT_RAGGED = 100_003
XBAR_IMAGES = 200
MIXED_IMAGES = 64
MIXED_TICKS = 30
LIF_KNOBS = (0.58, 0.5, 0.5, 0.5)   # examples/snn_mnist.py's per-layer knobs
RTOL = 1e-5
# timed calls a kernel time's median takes; each rides behind ~50 ms of
# spinning (BUSY_CYCLES), so the reps cost the run ~0.05 s each
REPS = 25
BUSY_CYCLES = 100_000_000   # ~50 ms of spinning at the H100's clocks
T_STEPS = 100
N_IMAGES = 100
T_CHUNK_CHECK = 64      # ticks of the time-looped kernel checks
# lif_chunk at the golden simulation of training data, one launch over
# (steps, runs): build_dataset(circuit) with no config simulates 2,000
# LIF runs x 125 steps (src/repro/core/dataset.py:133-135); lasana.train
# simulates TrainConfig()'s 1,000 runs x 125 steps (src/repro/lasana.py:
# 91-109), recording each step's V_mem (v_seq)
N_GOLDEN_SIM = 2000
T_GOLDEN_SIM = 125
N_TRAIN = 1000
T_TRAIN = 125
LIF_CHUNK_SHAPES = ((N_MAIN, T_CHUNK_CHECK), (N_RAGGED, T_CHUNK_CHECK),
                    (N_GOLDEN_SIM, T_GOLDEN_SIM), (N_TRAIN, T_TRAIN))
# the entry point each lif_chunk case stands for
LIF_CHUNK_LABELS = {
    (N_MAIN, T_CHUNK_CHECK): "simulate_stream: the SNN's hidden layer, "
                             "one 64-tick chunk",
    (N_RAGGED, T_CHUNK_CHECK): "a ragged N",
    (N_GOLDEN_SIM, T_GOLDEN_SIM): "build_dataset(circuit) with no config",
    (N_TRAIN, T_TRAIN): "lasana.train(circuit, TrainConfig()), with v_seq"}
# the train phase: limits against the JAX record of lasana.train("lif",
# TrainConfig()) on its own testbench (train_lif_ref_record.npz)
TRAIN_COUNT_REL = 1e-3       # events per kind (a spike may flip in a ULP)
TRAIN_ENERGY_REL = 1e-4      # energy sum per kind
TRAIN_VAL_MSE_REL = {"mean": 1e-3, "linear": 1e-3, "table": 1e-3,
                     "gbdt": 1e-2}
# gbdt: the 1e-2 around the record's own band of refits on its rows with
# 1% of the targets nudged one ULP (``gbdt_band/{predictor}``). Trees
# amplify rounding: the reference's M_ES fit moves from 13.51 to 13.92
# under such nudges, and on the port's rows (ULPs from its golden
# simulation) it gives the port's value exactly (my CPU probe, PR 19)
TRAIN_MLP_FACTOR = 1.5       # mlp val_mse either way (its own init)
TRAIN_TIE = 0.10             # the record's two best families this close:
                             # either may be selected
TRAIN_GBDT_NODES = 0.01      # gbdt on the card vs the CPU: nodes differing
TRAIN_GBDT_VAL = 1e-4        # and its val_mse gap, relative
TRAIN_ALPHA_TOL = 0.01       # the testbench's active share against alpha
TRAIN_SPIKE_POINTS = 0.01    # spike mismatch / argmax agreement vs golden
TRAIN_ENERGY_FACTOR = 1.5    # energy error vs golden: 1.5x the artifact's
TRAIN_ENERGY_FLOOR = 0.02    # or 2%, the larger
STREAM_TICKS = 2000     # the stream phase's horizon
STREAM_BLOCK = 250      # ticks per host block
STREAM_CHUNK = 512      # ticks per chunk: three full, one of 464
SWAP_SCALE = 1.0 + 1e-3
# the LM phase: StarCoder2-3B at full width and depth
LM_ARCH = "starcoder2-3b"
LM_DECODE_STEPS = 8          # teacher-forced steps held against the record
LM_REL_L2 = 3e-2             # per-row relative L2 of logits vs the record
LM_ARGMAX_GAP = 0.1          # argmax must agree where top-2 gap > 0.1 std
# max |decode - forward| / max |forward| over the last position: the
# reference's own test allows 0.15 on its reduced configs; the full-depth
# model measured 0.0105 on the H100 (NVIDIA H100 80GB HBM3, 700 W)
LM_DECODE_VS_FORWARD = 0.05
SERVE_ARGS = ("--arch", LM_ARCH, "--batch", "8", "--prompt-len", "512",
              "--gen", "64")
# the LM phase's other six configs, one after another after StarCoder2-3B:
# each one's JAX record at its depth (tests/test_torch_fixtures.py
# ZOO_RECORDS), decode against forward and launch.serve at the serve depth
ZOO_ARCHS = ("whisper-base", "mamba2-1.3b", "recurrentgemma-2b",
             "deepseek-moe-16b", "pixtral-12b", "deepseek-v3-671b")
# the serve depth (the config's own where not named): DeepSeek-V3's 3
# dense MLA + 1 MoE layer; the deep stacks cut to 8 layers, which keeps
# every layer kind (recurrentgemma's pattern twice and a third period's
# first two) and the run inside its time limit
ZOO_SERVE_LAYERS = {"deepseek-v3-671b": 4, "mamba2-1.3b": 8,
                    "recurrentgemma-2b": 8, "deepseek-moe-16b": 8,
                    "pixtral-12b": 8}
ZOO_SERVE_PROMPT = {"pixtral-12b": 1536, "recurrentgemma-2b": 2048}
ZOO_SERVE_BATCH, ZOO_SERVE_PROMPT_LEN, ZOO_SERVE_GEN = 8, 512, 64
# configs whose every (decoder) layer's attention is the kernel's function
# (causal self-attention, no window shorter than S, D in HEAD_DIMS); the
# others' attention is plain: MLA's qk 192 / v 128, recurrentgemma's D 256
ZOO_FLASH = {"deepseek-moe-16b": (16, 1, 128), "pixtral-12b": (32, 4, 128),
             "whisper-base": (8, 1, 64)}          # heads, G, D
# DeepSeek-V3's full-width MoE layer on the card (phase 6d): routing and
# the capacity drop set at the config's factor over 8 x 512 tokens, and
# the output against the dense mixture at ample capacity over 512 tokens
V3_MOE_TOKENS = (8, 512)
V3_MOE_AMPLE_TOKENS = (1, 512)
V3_ROUTER_RTOL = 1e-5        # fp32 router logits, card vs CPU
MOE_DENSE_REL = 1e-2         # relative L2, dispatch vs dense mixture, bf16
# decode against forward, per config where LM_DECODE_VS_FORWARD is not the
# limit: Mamba-2's full-sequence path sums its causal conv in bf16 and its
# one-token path in fp32 (the reference's arithmetic), a gap that grows
# with depth in the reference itself (tools/lm_decode_gap.py on the CPU:
# 0.0118 at 4 layers, 0.0318 at 16 of the full width, the port within 1%
# of it); the 48-layer model measured 0.0598 on the H100 (NVIDIA H100 80GB
# HBM3, 700 W). The reference's own test allows 0.15
# (tests/test_arch_smoke.py:74)
ZOO_DECODE_VS_FORWARD = {"mamba2-1.3b": 0.15}
# The MoE configs are held to it with their routers zeroed and every
# expert's capacity the whole batch (factor E / K): with their own routers
# the two runs route a row's last token apart at some layer (every row of
# deepseek-moe's 27 MoE layers did on the H100: a bf16 rounding apart flips
# a top-k choice of smaller margin, a different function; the line reports
# that gap too); tied scores route every token to the lowest-index experts
# in both. V3 at batch 2: its one MoE layer's (E, C, d) buffers at C = 8 x
# 514 would not fit beside its weights
ZOO_DVF_BATCH = {"deepseek-v3-671b": 2}
FLASH_BH, FLASH_G, FLASH_S, FLASH_D = 96, 12, 512, 128   # 4 x 24 heads
FLASH_SERVE_BH = 192             # the serve run's prefill: 8 x 24 heads
# the tp phase's per-shard prefill: (mesh, query heads a shard, G)
TP_FLASH = (("(1, 2)", 12, 12), ("(1, 4)", 6, 6))
FLASH_LONG_S = 4096              # StarCoder2's sliding window
FLASH_TOL = {"bf16": 3e-2, "fp32": 2e-5}   # tests/test_kernels.py:199
# the tensor-core route against bf16 resolution: |got - want| <= 2^-7
# |want| + 2^-9 (one output ulp, an absolute floor near zero), and at most
# FLASH_OFF_ULP of the outputs differ from the plain version's at all.
# With P split into bf16 hi + lo the kernel's fp32 result sits ~1e-6 from
# the plain version's, so only the outputs whose value lies that close to
# a rounding boundary round apart. tests/test_torch_flash_attn.py emulates
# the route on the CPU at S = 256 / 512: 0.23-0.24% of outputs apart; one
# bf16 P leaves 41% apart, and a lost K/V tile exceeds the ulp limit 60-
# 226 times over
FLASH_ULP = (2.0 ** -7, 2.0 ** -9)
FLASH_OFF_ULP = 0.05
# network_tick's five outputs per case (check_network_tick), SHA-256: the
# first design's kernel (one thread a row) printed these for the same
# seeded inputs, and every later design must reproduce them bit for bit
TICK_DIGESTS = {
    "network_tick lif packable n=12800 annotate=False":
        "9bb11632be456885ed28fc0e056c268016e4fad7b52899e2fc141e823bcf8478",
    "network_tick lif packable n=12837 annotate=False":
        "0b66dc0e9e3b3dbdeaba6d63e2c128abc210da4ff7f56ae9d6bc419ce2295ab4",
    "network_tick lif packable n=12800 annotate=True":
        "ffc4afc067eee790d8d962ebf15c1bf7e858b912f96975b6e8253ba8881695cf",
    "network_tick lif packable n=12837 annotate=True":
        "410607bd302e189b19b0bbffa27fd70945d5d2773bc0cbb2eb1393113a9c37e3",
    "network_tick lif mean_linear n=12800 annotate=False":
        "4ff7cd8a10cc0962d3c7cf97752fd367dc9b4f8a6c07ae82969401a60cab8316",
    "network_tick lif mean_linear n=12837 annotate=False":
        "c2dd11268811460bd521c67c44c0e6f43d5213fe191ab4892f508f104b6dd07f",
    "network_tick lif mean_linear n=12800 annotate=True":
        "3e86c0bf4feea306daf6caa198e738bd474f3d10592f4481a02d80fece1e86a8",
    "network_tick lif mean_linear n=12837 annotate=True":
        "047af8e5ea1d73a076b74fd5a905cedc11d9f257f1118312f908abb658200488",
    "network_tick crossbar packable n=312000 annotate=False":
        "3f3ba7cffc3c7a42f90737d3001fd8894df0240eb9b7bb7e583607a003130f01",
    "network_tick crossbar packable n=312037 annotate=False":
        "56e6fbd3b991984ff3d04ee7139826d29b29b0a6c4b9f3b266fc89cff84092b7",
    "network_tick crossbar packable n=312000 annotate=True":
        "cb68ce15cf5c234b59a4ff116def68fcf4fcb075301b5f7ad60801039181f683",
    "network_tick crossbar packable n=312037 annotate=True":
        "c9bf97a35068b47bc2e2ae99d614c2d6b6fff6ad7c12d30981c96d83a4c88e29",
    "network_tick lif in {crossbar, lif} n=12800 annotate=False":
        "9bb11632be456885ed28fc0e056c268016e4fad7b52899e2fc141e823bcf8478",
    "network_tick lif in {crossbar, lif} n=12837 annotate=False":
        "0b66dc0e9e3b3dbdeaba6d63e2c128abc210da4ff7f56ae9d6bc419ce2295ab4",
    "network_tick lif in {crossbar, lif} n=12800 annotate=True":
        "ffc4afc067eee790d8d962ebf15c1bf7e858b912f96975b6e8253ba8881695cf",
    "network_tick lif in {crossbar, lif} n=12837 annotate=True":
        "410607bd302e189b19b0bbffa27fd70945d5d2773bc0cbb2eb1393113a9c37e3",
    "network_tick crossbar in {crossbar, lif} n=7680 annotate=False":
        "a1bde6989beea48d5a4474de89c7cc64a5fa175bc1c8a1aeeabec641ed14135c",
    "network_tick crossbar in {crossbar, lif} n=7699 annotate=False":
        "aa341e0b268ea6223d2383f23fa72ae27a05c8a17f2172b8f67c25c248417cfb",
    "network_tick crossbar in {crossbar, lif} n=7680 annotate=True":
        "e7b806bb4500f9833bb373cc9dee4f9eb0da2f2abaaed72c9c9e65c3d8ee485c",
    "network_tick crossbar in {crossbar, lif} n=7699 annotate=True":
        "91072b7e345764f4b57b9d2a217bbf388890a18323893be0f9c458fadcb5277b",
    "network_tick lif MLP(128, 128) n=4099 annotate=False":
        "9abdd27d95dd75da5d711aeb36acc5b03b60364b6d7aa2fc1e16a802ad180409",
    "network_tick lif MLP(128, 128) n=4099 annotate=True":
        "551e20c212c975ef7067e9115e72e0cea3a9fd3a1bd7366af6d3e53101d2abac",
    "network_tick crossbar MLP(128, 50) n=4099 annotate=False":
        "2f54bafb2b77b7e7881f8134f45a7d06e15b8c61f1108a5989559aed41a9ac56",
    "network_tick crossbar MLP(128, 50) n=4099 annotate=True":
        "7027a90fd0d2fd9e4baa4e0c982fb3629f30ea548c2ec344d9cf88e18b039cf7",
    "network_tick crossbar MLP(100, 64) n=4099 annotate=False":
        "fa44165e8c898edcb36624eeb42a541339d577e28a19dd1d4a414312a1ea299b",
    "network_tick crossbar MLP(100, 64) n=4099 annotate=True":
        "404d5c19771235be66dc7a34752b6d531cd2a54a6b62160798e671f0947ebeb3",
}
# the head kernels' outputs per case (heads_cases), SHA-256: the first
# design's kernel (one thread a row) printed these for the same seeded
# inputs (``chip_smoke.py --digests --src <its src>``), and every later
# design must reproduce them bit for bit
HEADS_DIGESTS = {
    "mlp_surrogate_heads lif ('M_O', 'M_V') n=12800":
        "74f3b94441ae6edaf8f4b7cb56318f8ff8c9dc8a36e41f664061ea187fe14000",
    "mlp_surrogate_heads lif ('M_O', 'M_V') n=12837":
        "20c415bbb49f70193ead2f4793e2a7e2d63504fe4d90134b59cdebb62536c1ca",
    "mlp_surrogate_heads lif ('M_ED', 'M_L') n=12800":
        "0b9d99659024c14ff1c1b0c45cd1ee575127e05b7a89f6d8209221d09c63ed77",
    "mlp_surrogate_heads lif ('M_ED', 'M_L') n=12837":
        "782e1d13880082a565277607418398ec60b70e2a817f50d4fb7e9e6056bd20e9",
    "mlp_surrogate_heads crossbar ('M_O', 'M_V') n=312000":
        "c16e9a3b8f2ee25e3cd804160828c5e001a3025b076723a595ca0026857eeb6c",
    "mlp_surrogate_heads crossbar ('M_O', 'M_V') n=312037":
        "15fb766eaf8637bc8a44cba3a6ecd87fac958f92a24c64ea9cbb93a894a4ccc9",
    "mlp_surrogate_heads crossbar ('M_ED', 'M_L') n=312000":
        "f9a0b2a946fe0025e8946fcfefa5d3f94ae8958c63e50bc30930e9797a9449d7",
    "mlp_surrogate_heads crossbar ('M_ED', 'M_L') n=312037":
        "b91e373c18176fbbfcc05a0903272655566f17ac32ec6972bae849d8c624a075",
    "mlp_surrogate F=41 n=12800 torch.float32":
        "79490bd9ea7b3e169305ddc5bd6978be6804d6e95124a1998c27eeac46c36fcb",
    "mlp_surrogate F=41 n=12800 torch.bfloat16":
        "8a0ecaa9b9b85ecbd1ce68a716dd8aafafbc6ad66dbcfa33b43a5838e7637275",
    "mlp_surrogate F=41 n=12837 torch.float32":
        "4d58a23c6ba1a099e078d6b33731ae5c391bd56cc3f6bda746cf860ada62a6e9",
    "mlp_surrogate F=41 n=12837 torch.bfloat16":
        "734dffa23752dbeac4f337c80f3e414ad38b27bd70cdaf544195fb6d312b26d3",
    "mlp_surrogate F=67 n=12800 torch.float32":
        "a92cbc6d39b41b451f6ae0bf09cc5b694e4bfecc65c8a2866cd60111d75f9e81",
    "mlp_surrogate F=67 n=12800 torch.bfloat16":
        "8988604b6e515fdcd0d01fd82c71cc6e0911560f1be726c9f505d2731d82b342",
    "mlp_surrogate F=67 n=12837 torch.float32":
        "e184fb4013c9e39cfd0c218259b4d4d5e4c5e1674607e259fb2e6250d8195564",
    "mlp_surrogate F=67 n=12837 torch.bfloat16":
        "6a61911ba696f7c9409c4554644da116a7a02d62d329a32337b1ecd9e3060a56",
}
# the golden kernels' outputs per case and output (lif_cases, xbar_cases),
# SHA-256, first 12 hex digits: the first designs' kernels (one thread a
# row, runtime substep loops; commit e55fc13) printed these on the same
# seeded inputs on an NVIDIA H100 80GB HBM3, 700.00 W (``chip_smoke.py
# --digests --src <its src>``), and every later design must reproduce
# them bit for bit
LIF_DIGESTS = {
    "lif_step n=12800 new_state": "d857758a7370",
    "lif_step n=12800 output": "bae2e6fa63be",
    "lif_step n=12800 energy": "4b5d618d9cee",
    "lif_step n=12800 latency": "c49dd02434ef",
    "lif_step n=12800 spiked": "d5fae5e4a507",
    "lif_step n=1000 new_state": "c81732f178ba",
    "lif_step n=1000 output": "175d67f0bf09",
    "lif_step n=1000 energy": "8805247492da",
    "lif_step n=1000 latency": "221cd29c11bc",
    "lif_step n=1000 spiked": "7d851bb2cb7f",
    "lif_step n=640 new_state": "cfaefa7e2525",
    "lif_step n=640 output": "eff3444d558d",
    "lif_step n=640 energy": "bf469588f91e",
    "lif_step n=640 latency": "d560b42d5c13",
    "lif_step n=640 spiked": "4177e91f8d33",
    "lif_step n=12837 new_state": "d0d8239af942",
    "lif_step n=12837 output": "997a9c28c744",
    "lif_step n=12837 energy": "bcf3ee5aae44",
    "lif_step n=12837 latency": "4faa3ae70126",
    "lif_step n=12837 spiked": "0a918111a38c",
    "lif_chunk T=64 n=12800 new_state": "447558867704",
    "lif_chunk T=64 n=12800 output": "f1075c0c5e70",
    "lif_chunk T=64 n=12800 energy": "f7de4750f315",
    "lif_chunk T=64 n=12800 latency": "5db9730c1e5c",
    "lif_chunk T=64 n=12800 spiked": "828f92b418fc",
    "lif_chunk T=64 n=12837 new_state": "39051d7eccda",
    "lif_chunk T=64 n=12837 output": "ff4205d885e1",
    "lif_chunk T=64 n=12837 energy": "944e27849852",
    "lif_chunk T=64 n=12837 latency": "d294fa660f67",
    "lif_chunk T=64 n=12837 spiked": "a5d1e18d715e",
    # the golden simulation's shape, from the parent's kernel (commit
    # b65b4c0, its first redesign's period) on the same card
    "lif_chunk T=125 n=2000 new_state": "de80a71e65ed",
    "lif_chunk T=125 n=2000 output": "ae6c751689a9",
    "lif_chunk T=125 n=2000 energy": "b83256ae953d",
    "lif_chunk T=125 n=2000 latency": "a57b59cf57b3",
    "lif_chunk T=125 n=2000 spiked": "ec2d25a06505",
    # lasana.train's shape, from the parent's kernel (commit ff9b155,
    # before v_seq) on the same card
    "lif_chunk T=125 n=1000 new_state": "1d59318bb696",
    "lif_chunk T=125 n=1000 output": "af58b745c81d",
    "lif_chunk T=125 n=1000 energy": "1b28e69c0c91",
    "lif_chunk T=125 n=1000 latency": "c65c3d07ad85",
    "lif_chunk T=125 n=1000 spiked": "a9d44ac6db09",
}
XBAR_DIGESTS = {
    "crossbar_target n=312000 v_tgt": "62667af90fe5",
    "crossbar_target n=312000 tau": "406c16c6d9a5",
    "crossbar_target n=312037 v_tgt": "89cc05413b96",
    "crossbar_target n=312037 tau": "c3606ceb229a",
    "crossbar_target n=7680 v_tgt": "8cc4dc9f73c4",
    "crossbar_target n=7680 tau": "c967c6d7b8da",
    "crossbar_step n=312000 state": "d11bb0dc2e89",
    "crossbar_step n=312000 energy": "b6ca0cbcc8fe",
    "crossbar_step n=312000 latency": "e344bc7d417f",
    "crossbar_step n=312000 spiked": "8873aa072e67",
    "crossbar_step n=67200 state": "1cc47dca2938",
    "crossbar_step n=67200 energy": "5f1477cc650b",
    "crossbar_step n=67200 latency": "d401c2e6eb07",
    "crossbar_step n=67200 spiked": "ccb07033ea1c",
    "crossbar_step n=6000 state": "8598504a0e61",
    "crossbar_step n=6000 energy": "353a9047c7d4",
    "crossbar_step n=6000 latency": "75901b4c7d4c",
    "crossbar_step n=6000 spiked": "a8ea3712993c",
    "crossbar_step n=7680 state": "abbbaf44b481",
    "crossbar_step n=7680 energy": "b6add0a15798",
    "crossbar_step n=7680 latency": "f67f5ecf6bfc",
    "crossbar_step n=7680 spiked": "a61c5a810fdd",
    "crossbar_step n=312037 state": "8f973f82965e",
    "crossbar_step n=312037 energy": "2b33375c33f1",
    "crossbar_step n=312037 latency": "f92c9c6b3f62",
    "crossbar_step n=312037 spiked": "3b91eb9200fc",
}
# (h1, h2) of the routing-rule sweep, for both row kinds: across the band
# network_tick refuses (crossbar H1 >= 94 with H2 near 128), its H1 limit
# and the widths where the chunk kernel's two stacks stop fitting together
ROUTE_H1 = (1, 8, 50, 64, 90, 94, 100, 110, 120, 124, 127, 128, 129, 200, 512)
ROUTE_H2 = (1, 16, 50, 64, 100, 120, 125, 128, 200, 256)
WIDE_IMAGES = 20        # digits of the wide-surrogate run (its JAX record)
# ULPs of 0.5 * vdd within which a spike may flip: M_O's kernel and plain
# outputs differ by up to ~1e-6 (~17 ULPs at 0.75 V), summed in two orders
HALF_VDD_BAND = 64
# absolute band around a crossbar threshold (|o_hat - o| = out_eps, the
# settle test, |v_end - v0| = 0.02) within which kernel and plain version
# may decide differently: values reach 2 V (ULP 2.4e-7), and a head's dot
# products differ by up to ~1e-6 between the two summation orders
XBAR_BAND = 1e-5


def fail(msg: str):
    raise RuntimeError(msg)


T_START = time.perf_counter()


def line(obj) -> None:
    """One output line; a phase's line also says when it was printed
    (``t_s``, seconds since the script started)."""
    if isinstance(obj, dict) and "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T_START, 2)}
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def time_ms(fn, torch, reps: int = REPS) -> float:
    """Median device time of ``reps`` calls of ``fn``, each between two
    CUDA events, after warm-up. A spin kernel ahead of the start event
    keeps the stream busy while the host enqueues the call, so the events
    time the device's work and not the host's (a call that enqueues more
    launches than the stream's queue holds still shows some host time)."""
    for _ in range(min(3, reps)):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(BUSY_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(got, want, name, mask=None):
    """rtol 1e-5 with an atol at 1e-5 of the field's scale; returns the
    largest absolute difference. ``mask`` selects the rows compared.

    The kernels sum each dot product in index order with fused
    multiply-adds, the plain versions in cuBLAS's blocked order, so a head
    output that cancels to near zero differs by the rounding of its
    unit-scale partial sums (~1e-6), not by 1e-5 of itself; the
    reference's own kernel tests allow atol 1e-5 at unit scale for the
    same reason (tests/test_kernels.py)."""
    import numpy as np
    g = got.detach().double().cpu().numpy()
    w = want.detach().double().cpu().numpy()
    if mask is not None:
        g, w = g[mask], w[mask]
    err = np.abs(g - w)
    atol = 1e-5 * float(np.max(np.abs(w), initial=0.0))
    bad = err > atol + RTOL * np.abs(w)
    if bad.any():
        fail(f"{name}: {int(bad.sum())} values off by more than rtol "
             f"{RTOL} (max abs err {err.max():.3e})")
    return float(err.max(initial=0.0))


def bound(work):
    """``(ms, "bytes" | "operations")``: the least time the card could take
    for a kernel's ``ops.Work`` (``launch/roofline.py:bound_ms``)."""
    from repro_torch.launch import roofline
    return roofline.bound_ms(work)


def sm_clock_hz() -> float:
    from repro_torch.launch import roofline
    return roofline.SM_CLOCK_HZ


def heads_bound(x, stacks):
    """The bound of one ``mlp_surrogate_heads`` call on ``x`` (N, F) and
    its ten stacked arrays."""
    from repro_torch.kernels import mlp_surrogate
    n, f = x.shape
    p, _, h1 = stacks[4].shape
    return bound(mlp_surrogate.heads_work(n, f, p, h1, stacks[6].shape[2],
                                          sum(a.numel() for a in stacks)))


# the LIF substep's serial chain: (v + dv) * decay, clamp (2), the
# threshold compare and the reset select, ~4 cycles each on the card's
# fp32 pipes (an estimate beside the bound, not a bound)
LIF_CHAIN_OPS = 6
FP32_LATENCY_CYCLES = 4


# --- phase 3: each kernel against its plain version -------------------------

def lif_inputs(torch, np, dev, n):
    """One period's (state (N, 3), x (N, 3), params (N, 4)) on the card,
    seeded by N: membranes, adaptation and 30% of rows refractory, drives
    as the engine gives them (w in [-1, 1], V_dd, 5 spikes)."""
    rng = np.random.default_rng(n)
    state = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 0.3, n),
                      rng.uniform(0, 3, n) * (rng.random(n) < 0.3)], 1)
    x = np.stack([rng.uniform(-1, 1, n), np.full(n, 1.5),
                  np.full(n, 5.0)], 1)
    params = rng.uniform(0.5, 0.8, (n, 4))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (state, x, params)]


def lif_cases(torch, np, dev):
    """The LIF kernels' digest cases, ``(tag, fn, args)`` with ``fn(*args)``
    returning the named outputs: ``lif_step`` at every main-path shape and
    a ragged N, ``lif_chunk`` at LIF_CHUNK_SHAPES (T = 64 at N = 12,800
    and 12,837; T = 125 at N = 2,000 and 1,000, the golden simulations
    of ``build_dataset`` with no config and of ``lasana.train``; each
    labelled in LIF_CHUNK_LABELS)."""
    from repro_torch.core.circuits import LIFNeuron
    from repro_torch.kernels import lif_scan
    circ = LIFNeuron()

    def named(res):
        new_state, obs = res
        return {"new_state": new_state, **{k: obs[k] for k in LIF_OBS}}

    cases = [(f"lif_step n={n}",
              lambda *a: named(lif_scan.lif_step(*a, circ=circ)),
              lif_inputs(torch, np, dev, n))
             for n in (*LIF_SHAPES, N_RAGGED)]
    cases += [(f"lif_chunk T={t} n={n}",
               lambda *a: named(lif_scan.lif_chunk(*a, circ=circ)),
               lif_chunk_inputs(torch, np, dev, n, t, n))
              for n, t in LIF_CHUNK_SHAPES]
    return cases


def xbar_inputs(torch, np, dev, n):
    """``xbar_rows`` seeded by N, on the card: (v, w, state)."""
    return [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in xbar_rows(np, n, n)]


def xbar_cases(torch, np, dev):
    """The crossbar kernels' digest cases, as :func:`lif_cases`:
    ``crossbar_target`` at the layer-1 rows, a ragged N and the mixed net's
    rows; ``crossbar_step`` (the fused period) at every main-path shape and
    the ragged N."""
    from repro_torch.core.circuits import CrossbarRow
    from repro_torch.kernels import crossbar_mvm
    circ = CrossbarRow()

    def target(v, w, state):
        v_tgt, tau = crossbar_mvm.crossbar_target(v, w, circ=circ)
        return {"v_tgt": v_tgt, "tau": tau}

    def step(v, w, state):
        new_state, obs = crossbar_mvm.crossbar_step(state, v, w, circ=circ)
        return {"state": new_state, **{k: obs[k] for k in LIF_OBS[1:]}}

    cases = [(f"crossbar_target n={n}", target, xbar_inputs(torch, np, dev, n))
             for n in (N_XBAR, N_XBAR_RAGGED, N_MIXED_XBAR)]
    cases += [(f"crossbar_step n={n}", step, xbar_inputs(torch, np, dev, n))
              for n in (*XBAR_SHAPES, N_XBAR_RAGGED)]
    return cases


def golden_digests(torch, cases, want):
    """Run each case, digest each output (SHA-256, 12 hex digits) and, with
    ``want`` (the committed digests), fail on any difference. Returns
    ``({tag output: digest}, {tag: outputs})``."""
    got, outs = {}, {}
    for tag, fn, args in cases:
        outs[tag] = fn(*args)
        torch.cuda.synchronize()
        for name, t in outs[tag].items():
            got[f"{tag} {name}"] = digest([t])[:12]
    if want is not None:
        bad = sorted(k for k in got if got[k] != want.get(k))
        if bad:
            fail(f"golden kernels: {len(bad)} outputs differ from the "
                 f"committed digests, e.g. {bad[:4]}")
    return got, outs


def shape_times(torch, np, dev):
    """Device ms per call of ``lif_step``, ``crossbar_step`` and
    ``crossbar_target`` at every main-path shape (``crossbar_step`` also
    at training's N = 1,000), ``lif_chunk`` at T = 64, N = 12,800 and at
    T = 125, N = 2,000 and 1,000, ``mlp_surrogate`` at (12,800,
    41) on fp32 and bf16 rows, and an empty launch
    (``torch.cuda._sleep(0)``) between the same events: the launch floor.
    Keys are N (``lif_chunk``) and the row dtype (``mlp_surrogate``)."""
    from repro_torch.core.circuits import CrossbarRow, LIFNeuron
    from repro_torch.kernels import crossbar_mvm, lif_scan, mlp_surrogate
    lif, xbar = LIFNeuron(), CrossbarRow()
    out = {"launch_floor": time_ms(lambda: torch.cuda._sleep(0), torch),
           "lif_step": {}, "crossbar_step": {}, "crossbar_target": {}}
    for n in LIF_SHAPES:
        args = lif_inputs(torch, np, dev, n)
        out["lif_step"][n] = time_ms(
            lambda: lif_scan.lif_step(*args, circ=lif), torch)
    for n in (*XBAR_SHAPES, N_TRAIN):
        v, w, state = xbar_inputs(torch, np, dev, n)
        out["crossbar_step"][n] = time_ms(
            lambda: crossbar_mvm.crossbar_step(state, v, w, circ=xbar), torch)
        if n in (N_XBAR, N_MIXED_XBAR):
            out["crossbar_target"][n] = time_ms(
                lambda: crossbar_mvm.crossbar_target(v, w, circ=xbar), torch)
    out["lif_chunk"] = {}
    for n, t in LIF_CHUNK_SHAPES:
        if n == N_RAGGED:
            continue
        args = lif_chunk_inputs(torch, np, dev, n, t, n)
        out["lif_chunk"][n] = time_ms(
            lambda: lif_scan.lif_chunk(*args, circ=lif), torch)
    x, w = single_case(torch, np, dev, 41)
    out["mlp_surrogate"] = {str(xx.dtype): time_ms(
        lambda: mlp_surrogate.mlp_surrogate(xx, *w), torch)
        for xx in (x, x.bfloat16())}
    return out


def lif_against_plain(torch, circ, tag, got, args, out):
    """Hold one ``lif_step`` case's outputs against ``_period_math``:
    spiked equal, the rest within RTOL; widens ``out["max_abs_err"]``."""
    from repro_torch.kernels import lif_scan
    want = dict(zip(("new_state", *LIF_OBS),
                    lif_scan._period_math(circ, *args)))
    torch.cuda.synchronize()
    if not torch.equal(got["spiked"], want["spiked"]):
        fail(f"{tag}: spiked differs on "
             f"{int((got['spiked'] != want['spiked']).sum())} neurons")
    for name in ("new_state", *LIF_OBS[:3]):
        out["max_abs_err"] = max(out["max_abs_err"], compare(
            got[name], want[name], f"{tag} {name}"))


def check_lif(torch, np, dev, times):
    """``lif_step``: each output of :func:`lif_cases`'s ``lif_step`` cases
    digested and held to LIF_DIGESTS; against the plain version at every
    main-path shape and the ragged N, and the generic instance (a runtime
    substep count, LIF_GENERIC) at N_GENERIC_LIF; ``times``
    (:func:`shape_times`) at each shape beside its bound and the
    serial-chain estimate."""
    from repro_torch.core.circuits import LIFNeuron
    from repro_torch.kernels import lif_scan
    circ = LIFNeuron()
    cases = [c for c in lif_cases(torch, np, dev) if c[0].startswith(
        "lif_step")]
    digests, outs = golden_digests(torch, cases, LIF_DIGESTS)
    out = {"shape": f"state ({N_MAIN}, 3), x ({N_MAIN}, 3), "
                    f"params ({N_MAIN}, 4)", "max_abs_err": 0.0,
           "digests_held": len(digests), "ms_by_shape": times["lif_step"],
           "bound_ms_by_shape": {}, "launch_floor_ms": times["launch_floor"],
           "generic_cases": []}
    for (tag, _, args), n in zip(cases, (*LIF_SHAPES, N_RAGGED)):
        got = outs[tag]
        lif_against_plain(torch, circ, tag, got, args, out)
        if n == N_RAGGED:
            continue
        ms, by = bound(lif_scan.work(n, circ.n_substeps))
        out["bound_ms_by_shape"][n] = ms
        if n == N_MAIN:
            out["spiking_share"] = float(got["spiked"].float().mean())
            out["ms"] = times["lif_step"][n]
            out["plain_ms"] = time_ms(
                lambda: lif_scan._period_math(circ, *args), torch)
            out["bound_ms"], out["bound_by"] = ms, by
    for fields in LIF_GENERIC:
        gen = LIFNeuron(**fields)
        for n in N_GENERIC_LIF:
            tag = f"lif_step {fields} n={n}"
            args = lif_inputs(torch, np, dev, n)
            new_state, obs = lif_scan.lif_step(*args, circ=gen)
            lif_against_plain(torch, gen, tag, {"new_state": new_state,
                                                **obs}, args, out)
            out["generic_cases"].append(tag)
    # an estimate, not a bound and not a reading: the dependent fp32 chain
    # of one period, any N (left out of the kernels line)
    out["chain_ms"] = (circ.n_substeps * LIF_CHAIN_OPS * FP32_LATENCY_CYCLES
                       / sm_clock_hz() * 1e3)
    return out


def check_quot(torch, np, dev):
    """``quot`` / ``quot_nonneg`` (csrc/quot.cuh), each with the ``/`` its
    caller falls back to where it declines, against IEEE fp32 division on
    the host, bit for bit: every significand of a divisor in [1, 2) (all
    ones included) against a random dividend; random operands with
    exponents in [-62, 62] (some quotients beyond the 2^100 guard) and in
    [-100, 100] (the guard's edges; quotients that overflow or are
    subnormal, where the callers' `/` runs); the 512 significands nearest
    all ones and 1.0 at random exponents; the
    divisors the kernels use (5, LIFNeuron's ut and c_mem, CrossbarRow's
    dt_s); signed zero dividends. Also fails where the guard declined a
    pair it should take, which would leave the kernels' path unchecked."""
    from repro_torch.core.circuits import CrossbarRow, LIFNeuron
    from repro_torch.kernels import _build, crossbar_mvm
    rng = np.random.default_rng(17)
    u32 = np.uint32

    def floats(n, e_lo, e_hi, sig=None):
        """Random signs, exponents in [e_lo, e_hi] and significand bits
        (or the given ones)."""
        bits = rng.integers(0, 1 << 23, n, dtype=u32) if sig is None else sig
        exp = rng.integers(127 + e_lo, 127 + e_hi + 1, n, dtype=u32)
        sign = rng.integers(0, 2, n, dtype=u32) << u32(31)
        return (sign | (exp << u32(23)) | bits).view(np.float32)

    every = np.arange(1 << 23, dtype=u32)
    ends = np.concatenate([np.arange(256, dtype=u32),
                           (1 << 23) - 1 - np.arange(256, dtype=u32)])
    lif, xbar = LIFNeuron(), CrossbarRow()
    used = np.array([5.0, lif.ut, lif.c_mem, crossbar_mvm._consts(xbar).dt_s],
                    np.float32)
    parts = [
        (floats(every.size, -40, 40), (u32(127 << 23) | every).view(
            np.float32)),
        (floats(QUOT_PAIRS, -62, 62), floats(QUOT_PAIRS, -62, 62)),
        (floats(QUOT_PAIRS, -100, 100), floats(QUOT_PAIRS, -100, 100)),
        (floats(QUOT_PAIRS, -62, 62),
         floats(QUOT_PAIRS, -62, 62, rng.choice(ends, QUOT_PAIRS))),
        (floats(QUOT_PAIRS, -62, 62), rng.choice(used, QUOT_PAIRS)),
        (np.repeat(np.array([0.0, -0.0], np.float32), 4096),
         floats(8192, -62, 62)),
    ]
    x = np.concatenate([p[0] for p in parts])
    d = np.concatenate([p[1] for p in parts])
    n = x.size
    xt = torch.as_tensor(x, device=dev)
    dt = torch.as_tensor(d, device=dev)
    q, qn = torch.empty_like(xt), torch.empty_like(xt)
    took = torch.empty(n, dtype=torch.uint8, device=dev)
    lib = _build.library("lif_step")
    fn = lib.quot_check_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    code = fn(xt.data_ptr(), dt.data_ptr(), q.data_ptr(), qn.data_ptr(),
              took.data_ptr(), n, dev.index or 0,
              torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(lib, code, "quot_check")
    torch.cuda.synchronize()
    with np.errstate(over="ignore", under="ignore"):
        want = x / d
        want_n = np.abs(x) / d
    took = took.cpu().numpy()
    out = {"pairs": int(n)}
    for name, got, ref, bit in (("quot", q, want, 1),
                                ("quot_nonneg", qn, want_n, 2)):
        got = got.cpu().numpy()
        bad = got.view(u32) != ref.view(u32)
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            fail(f"{name}: {int(bad.sum())} of {n} quotients differ from "
                 f"IEEE division, e.g. {x[i]!r} / {d[i]!r}: "
                 f"{got[i]!r} against {ref[i]!r}")
        num = np.abs(x) if bit == 2 else x
        inside = [np.abs(a) for a in (num, d, ref)]
        guard = ((inside[0] == 0) | ((inside[0] >= 2.0 ** -100)
                                     & (inside[0] <= 2.0 ** 100)))
        for a in inside[1:]:
            guard &= (a >= 2.0 ** -100) & (a <= 2.0 ** 100)
        kept = (took & bit) > 0
        if (guard & ~kept).any():
            fail(f"{name}: declined {int((guard & ~kept).sum())} pairs "
                 f"inside its range guard")
        out[f"{name}_kept"] = int(kept.sum())
    return out


def xbar_rows(np, n, seed):
    """Crossbar rows as the engine drives them: DAC volts (70% analog
    levels, 30% full-swing digital), ternary weights with a zero bias
    column, previous outputs in [-2, 2] V."""
    rng = np.random.default_rng(seed)
    uni = rng.uniform(-0.8, 0.8, (n, 32))
    dig = rng.integers(-1, 2, (n, 32)) * 0.8
    v = np.where(rng.random((n, 1)) < 0.3, dig, uni)
    w = np.concatenate([rng.integers(-1, 2, (n, 32)), np.zeros((n, 1))], 1)
    state = rng.uniform(-2, 2, (n, 1))
    return v, w, state


def settle_margin(torch, circ, state, v, w):
    """Per row, the least distance over the substeps between |v - v_tgt|
    and the 90% settling band, and |v_end - v0| from 0.02: how far each
    discrete decision of ``CrossbarRow.step`` sits from its threshold."""
    from repro_torch.kernels import crossbar_mvm
    v_tgt, tau = crossbar_mvm.target_plain(circ, v, w)
    dt = circ.clock_ns / circ.n_substeps
    a = torch.exp(tau.new_full((), -dt) / tau)
    v0 = state[:, 0]
    band = 0.1 * torch.abs(v_tgt - v0) + 1e-6
    vv, margin = v0, torch.full_like(v0, float("inf"))
    for _ in range(circ.n_substeps):
        vv = v_tgt + (vv - v_tgt) * a
        margin = torch.minimum(margin, torch.abs(torch.abs(vv - v_tgt) - band))
    return margin, torch.abs(torch.abs(vv - v0) - 0.02)


def xbar_bound(n, fused=True):
    """(bound ms, by) of ``n`` crossbar rows of 32 inputs: the fused
    period or the target alone (``crossbar_mvm.work``)."""
    from repro_torch.core.circuits import CrossbarRow
    from repro_torch.kernels import crossbar_mvm
    return bound(crossbar_mvm.work(n, 32, CrossbarRow().n_substeps, fused))


def narrow_rows(torch, v, w, state, n_in):
    """The first ``n_in`` inputs of crossbar rows and their bias column,
    each contiguous: rows of a CrossbarRow(n_inputs=n_in)."""
    return (v[:, :n_in].contiguous(),
            torch.cat([w[:, :n_in], w[:, -1:]], 1).contiguous(), state)


def xbar_against_plain(torch, circ, tag, got, v, w, state, out):
    """Hold one crossbar case's outputs against ``target_plain`` (v_tgt,
    tau) or ``step_plain`` (spiked / t90 may differ only at rows within
    XBAR_BAND of a threshold, the rest within RTOL); widens
    ``out["max_abs_err"]`` and counts ``out["threshold_rows"]``."""
    from repro_torch.kernels import crossbar_mvm
    if "v_tgt" in got:
        for name, p in zip(("v_tgt", "tau"),
                           crossbar_mvm.target_plain(circ, v, w)):
            out["max_abs_err"] = max(out["max_abs_err"], compare(
                got[name], p, f"{tag} {name}"))
        return
    plain = crossbar_mvm.step_plain(circ, state, v, w)
    torch.cuda.synchronize()
    margin, spike_margin = settle_margin(torch, circ, state, v, w)
    flip = (got["spiked"] != plain[4]) | (got["latency"] != plain[3])
    near = (margin <= XBAR_BAND) | (spike_margin <= XBAR_BAND)
    if (flip & ~near).any():
        fail(f"{tag}: spiked or t90 differs on "
             f"{int((flip & ~near).sum())} rows away from a threshold")
    out["threshold_rows"] += int(flip.sum())
    keep = (~flip).cpu().numpy()
    for name, p in (("state", plain[1]), ("energy", plain[2])):
        g = got[name][:, 0] if name == "state" else got[name]
        out["max_abs_err"] = max(out["max_abs_err"], compare(
            g, p, f"{tag} {name}", mask=keep))


def check_crossbar(torch, np, dev, times):
    """Both entry points of crossbar_step.cu: each output of
    :func:`xbar_cases` digested and held to XBAR_DIGESTS; against the plain
    versions at every case and on the generic instances (XBAR_GENERIC at
    N_GENERIC_XBAR); ``times`` (:func:`shape_times`) at each shape beside
    their bounds."""
    from repro_torch.core.circuits import CrossbarRow
    from repro_torch.kernels import crossbar_mvm
    circ = CrossbarRow()
    cases = xbar_cases(torch, np, dev)
    digests, outs = golden_digests(torch, cases, XBAR_DIGESTS)
    out = {"shape": f"v ({N_XBAR}, 32), w ({N_XBAR}, 33), state "
                    f"({N_XBAR}, 1): the fused period", "max_abs_err": 0.0,
           "threshold_rows": 0, "digests_held": len(digests),
           "ms_by_shape": times["crossbar_step"], "bound_ms_by_shape": {},
           "target_ms_by_shape": times["crossbar_target"],
           "target_bound_ms_by_shape": {},
           "launch_floor_ms": times["launch_floor"], "generic_cases": []}
    for tag, _, (v, w, state) in cases:
        n = v.shape[0]
        xbar_against_plain(torch, circ, tag, outs[tag], v, w, state, out)
        if n == N_XBAR_RAGGED:
            continue
        if tag.startswith("crossbar_target"):
            out["target_bound_ms_by_shape"][n] = xbar_bound(n, False)[0]
            continue
        out["bound_ms_by_shape"][n] = xbar_bound(n)[0]
        if n == N_XBAR:
            out["spiked_share"] = float(outs[tag]["spiked"].float().mean())
            out["ms"] = times["crossbar_step"][n]
            out["plain_ms"] = time_ms(
                lambda: crossbar_mvm.step_plain(circ, state, v, w), torch)
            out["target_plain_ms"] = time_ms(
                lambda: crossbar_mvm.target_plain(circ, v, w), torch)
            out["bound_ms"], out["bound_by"] = xbar_bound(n)
    # lasana.train's golden simulation: one fused period a step over its
    # 1,000 runs, timed only (its rows are xbar_rows, as every case's)
    out["bound_ms_by_shape"][N_TRAIN] = xbar_bound(N_TRAIN)[0]
    for fields in XBAR_GENERIC:
        gen = CrossbarRow(**fields)
        for n in N_GENERIC_XBAR:
            v, w, state = narrow_rows(torch, *xbar_inputs(torch, np, dev, n),
                                      gen.n_inputs)
            tag = f"crossbar {fields} n={n}"
            v_tgt, tau = crossbar_mvm.crossbar_target(v, w, circ=gen)
            xbar_against_plain(torch, gen, f"{tag} target",
                               {"v_tgt": v_tgt, "tau": tau}, v, w, state, out)
            new_state, obs = crossbar_mvm.crossbar_step(state, v, w, circ=gen)
            xbar_against_plain(torch, gen, f"{tag} step",
                               {"state": new_state, **obs}, v, w, state, out)
            out["generic_cases"].append(tag)
    return out


def heads_cases(torch, np, dev, surs):
    """The head kernels' cases at the widths the first design took, each
    ``(tag, kind, fn, args, timed)``: the stacked groups the unpackable
    artifacts launch on the main paths, (M_O, M_V) at the active width and
    (M_ED, M_L) at the transition width, for LIF rows (F = 10/12, N =
    12,800 timed, 12,837) and crossbar rows (F = 68/70, N = 312,000 timed,
    312,037); then ``mlp_surrogate`` at (F, H1, H2) = (41, 100, 50) and
    (67, 100, 50), N = 12,800 and 12,837, fp32 and bf16 inputs. The inputs
    are seeded, so a kernel that agrees with the first design bit for bit
    prints the same digests (HEADS_DIGESTS)."""
    from repro_torch.kernels import mlp_surrogate
    keys = ("x_mu", "x_sd", "y_mu", "y_sd", "w0", "b0", "w1", "b1", "w2",
            "b2")
    cases = []
    for kind, sizes in (("lif", (N_MAIN, N_RAGGED)),
                        ("crossbar", (N_XBAR, N_XBAR_RAGGED))):
        sur = surs[f"{kind}_unpackable"]
        for pnames in (("M_O", "M_V"), ("M_ED", "M_L")):
            s = sur._stacked(pnames)
            stacks = [s[k] for k in keys]
            f = s["w0"].shape[1]
            for n in sizes:
                x = torch.as_tensor(np.random.default_rng(n + f).normal(
                    0, 1, (n, f)), dtype=torch.float32, device=dev)
                cases.append((f"mlp_surrogate_heads {kind} {pnames} n={n}",
                              kind, mlp_surrogate.mlp_surrogate_heads,
                              (x, *stacks), n == sizes[0]))
    for f in (41, 67):
        rng = np.random.default_rng(f)
        w = single_head(torch, np, dev, rng, f, 100, 50)
        for n in (N_MAIN, N_RAGGED):
            x = torch.as_tensor(rng.normal(0, 1, (n, f)), dtype=torch.float32,
                                device=dev)
            for xx in (x, x.bfloat16()):
                cases.append((f"mlp_surrogate F={f} n={n} {xx.dtype}",
                              "single", mlp_surrogate.mlp_surrogate,
                              (xx, *w), n == N_MAIN and xx is x))
    return cases


def single_head(torch, np, dev, rng, f, h1, h2, scale=0.1):
    """One unstandardized head's (w1, b1, w2, b2, w3, b3), N(0, scale)."""
    return [torch.as_tensor((rng.normal(0, 1, s) * scale).astype(np.float32),
                            device=dev)
            for s in ((f, h1), (h1,), (h1, h2), (h2,), (h2, 1), (1,))]


def single_case(torch, np, dev, f):
    """``heads_cases``' ``mlp_surrogate`` inputs at F and N = 12,800: x
    (fp32) and the head's six arrays."""
    rng = np.random.default_rng(f)
    w = single_head(torch, np, dev, rng, f, 100, 50)
    x = torch.as_tensor(rng.normal(0, 1, (N_MAIN, f)), dtype=torch.float32,
                        device=dev)
    return x, w


def wide_heads(torch, np, dev, p, f, h1, h2, seed):
    """P standardized MLP(h1, h2) heads at F columns from a seed, as
    ``mlp_surrogate_heads`` takes them, and x (N_MAIN, F)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    stacks = [f32(rng.normal(0, 0.5, (p, f))),
              f32(rng.uniform(0.5, 2, (p, f))),
              f32(rng.normal(0, 1, (p, 1))), f32(rng.uniform(0.5, 2, (p, 1)))]
    for shape, fan in (((p, f, h1), f), ((p, h1), None), ((p, h1, h2), h1),
                       ((p, h2), None), ((p, h2, 1), h2), ((p, 1), None)):
        stacks.append(f32(rng.normal(0, fan ** -0.5 if fan else 0.1, shape)))
    x = f32(rng.normal(0, 1, (N_MAIN, f)))
    return x, stacks


# widths the first design refused: (P, F, H1, H2); the last has heads
# larger than shared memory (w1 alone 512 KB), so its w0 / w1 go in slices
WIDE_HEADS = ((2, 100, 200, 50), (3, 12, 200, 50), (2, 80, 512, 256))


def check_mlp_heads(torch, np, dev, surs, times):
    """``mlp_surrogate_heads`` and ``mlp_surrogate``: every case of
    :func:`heads_cases` digested and held to HEADS_DIGESTS and to the
    plain version; the main path's groups timed (LIF: the line's entry;
    crossbar rows: ``crossbar``), ``mlp_surrogate`` at F = 67 (F = 41 on
    fp32 and bf16 rows from ``times``, :func:`shape_times`); then the
    widths of WIDE_HEADS, and ``mlp_surrogate`` at F = 100 with MLP(200,
    50), against the plain version at N = 12,800, each with the kernel's
    launch plan. Returns (the heads' entry, the single head's entry)."""
    from repro_torch.kernels import mlp_surrogate, ops
    heads = {"lif": {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0},
             "crossbar": {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}}
    single = {"max_abs_err": 0.0,
              "main_path": "lasana.train: the mlp family's validation "
                           "pass every epoch and its predictions"}
    digests = {}
    plain = {mlp_surrogate.mlp_surrogate_heads: mlp_surrogate.mlp_heads_plain,
             mlp_surrogate.mlp_surrogate: mlp_surrogate.mlp_plain}
    work = {"lif": [0.0, 0.0, []], "crossbar": [0.0, 0.0, []]}
    before = ops.LAUNCHES["mlp_surrogate"]
    for tag, kind, fn, args, timed in heads_cases(torch, np, dev, surs):
        got = fn(*args)
        want = plain[fn](*args)
        torch.cuda.synchronize()
        digests[tag] = digest([got])
        if digests[tag] != HEADS_DIGESTS.get(tag):
            fail(f"{tag}: outputs differ from the committed digest "
                 f"{HEADS_DIGESTS.get(tag)}")
        out = single if kind == "single" else heads[kind]
        out["max_abs_err"] = max(out["max_abs_err"], compare(got, want, tag))
        if not timed:
            continue
        x = args[0]
        n, f = x.shape
        if kind == "single":
            key = "" if f == 41 else "_f67"
            w = args[1:]
            h1, h2 = w[0].shape[1], w[2].shape[1]
            single[f"ms{key}"] = times["mlp_surrogate"][str(x.dtype)] \
                if f == 41 else time_ms(lambda: fn(*args), torch)
            single[f"plain_ms{key}"] = time_ms(lambda: plain[fn](*args),
                                               torch)
            if f == 41:
                single["ms_bf16"] = times["mlp_surrogate"]["torch.bfloat16"]
                single["plan"] = mlp_surrogate.single_plan(f, h1, h2)
            single[f"bound_ms{key}"], single["bound_by"] = bound(
                mlp_surrogate.single_work(n, f, h1, h2,
                                          sum(a.numel() for a in w)))
            if not key:
                single["shape"] = f"x ({n}, {f}), H1={h1}, H2={h2}"
            continue
        p, _, h1 = args[5].shape
        h2 = args[7].shape[2]
        out["ms"] += time_ms(lambda: fn(*args), torch)
        out["plain_ms"] += time_ms(lambda: plain[fn](*args), torch)
        w = mlp_surrogate.heads_work(n, f, p, h1, h2,
                                     sum(a.numel() for a in args[1:]))
        work[kind][0] += w.flops
        work[kind][1] += w.bytes
        work[kind][2].append(f"x ({n}, {f}), P={p}, H1={h1}, H2={h2}")
    for kind, (flops, n_bytes, shapes) in work.items():
        heads[kind]["shape"] = "; ".join(shapes) + \
            " (one launch each, times summed)"
        heads[kind]["bound_ms"], heads[kind]["bound_by"] = bound(
            ops.Work(flops, n_bytes))
    heads["lif"]["digests"] = {k: v[:12] for k, v in digests.items()}
    wide = {}
    for p, f, h1, h2 in WIDE_HEADS:
        x, stacks = wide_heads(torch, np, dev, p, f, h1, h2, p + f + h1 + h2)
        tag = f"P={p} F={f} MLP({h1}, {h2})"
        got = mlp_surrogate.mlp_surrogate_heads(x, *stacks)
        want = mlp_surrogate.mlp_heads_plain(x, *stacks)
        torch.cuda.synchronize()
        res = {"plan": mlp_surrogate.plan(p, f, h1, h2),
               "max_abs_err": compare(got, want, f"mlp_surrogate_heads {tag}"),
               "ms": time_ms(lambda: mlp_surrogate.mlp_surrogate_heads(
                   x, *stacks), torch),
               "plain_ms": time_ms(lambda: mlp_surrogate.mlp_heads_plain(
                   x, *stacks), torch)}
        res["bound_ms"], res["bound_by"] = heads_bound(x, stacks)
        heads["lif"]["max_abs_err"] = max(heads["lif"]["max_abs_err"],
                                          res["max_abs_err"])
        wide[tag] = res
    if wide["P=2 F=80 MLP(512, 256)"]["plan"]["group"] != 0:
        fail("mlp_surrogate_heads: the F=80 MLP(512, 256) heads were not "
             "staged in slices")
    rng = np.random.default_rng(100)
    w = single_head(torch, np, dev, rng, 100, 200, 50)
    x = torch.as_tensor(rng.normal(0, 1, (N_MAIN, 100)), dtype=torch.float32,
                        device=dev)
    got = mlp_surrogate.mlp_surrogate(x, *w)
    want = mlp_surrogate.mlp_plain(x, *w)
    torch.cuda.synchronize()
    single["max_abs_err"] = max(single["max_abs_err"], compare(
        got, want, "mlp_surrogate F=100 MLP(200, 50)"))
    single["wide"] = {"F=100 MLP(200, 50)": {
        "plan": mlp_surrogate.plan(1, 100, 200, 50),
        "single_plan": mlp_surrogate.single_plan(100, 200, 50),
        "ms": time_ms(lambda: mlp_surrogate.mlp_surrogate(x, *w), torch),
        "plain_ms": time_ms(lambda: mlp_surrogate.mlp_plain(x, *w), torch)}}
    # rows of a dtype the kernel does not read: the wrapper casts them
    x, w = single_case(torch, np, dev, 41)
    got = mlp_surrogate.mlp_surrogate(x.half(), *w)
    same = torch.equal(got, mlp_surrogate.mlp_surrogate(x.half().float(), *w))
    single["max_abs_err"] = max(single["max_abs_err"], compare(
        got, mlp_surrogate.mlp_plain(x.half(), *w), "mlp_surrogate float16"))
    if not same:
        fail("mlp_surrogate: float16 rows differ from their fp32 cast")
    single["kernel_check_launches"] = ops.LAUNCHES["mlp_surrogate"] - before
    lif = heads.pop("lif")
    lif["max_abs_err"] = max(lif["max_abs_err"],
                             heads["crossbar"].pop("max_abs_err"))
    lif["wide"] = wide
    return {**lif, **heads}, single


def gbdt_rows(np, a, n, f, seed):
    """(n, f) rows around a GBDT head's own thresholds: each feature drawn
    from the finite thresholds that split on it (ties), a third of them
    nudged off, and one NaN feature a hundred rows."""
    rng = np.random.default_rng(seed)
    feat = a["feat"].cpu().numpy().ravel()
    thr = a["thr"].cpu().numpy().ravel()
    x = rng.normal(0, 1, (n, f)).astype(np.float32)
    for j in range(f):
        cand = thr[(feat == j) & np.isfinite(thr)]
        if cand.size:
            col = rng.choice(cand, n)
            nudge = rng.random(n) < 1 / 3
            col[nudge] = col[nudge] * np.float32(1 + 1e-3)
            x[:, j] = col
    x[rng.random(n) < 0.01, rng.integers(0, f)] = np.nan
    return x


def int_forest(torch, np, dev, trees, depth, f, seed):
    """A random complete forest with integer leaves and base (sums exact
    in any order), thresholds of small integers with a tenth +inf."""
    rng = np.random.default_rng(seed)
    nodes = (1 << depth) - 1
    thr = rng.integers(-2, 3, (trees, nodes)).astype(np.float32)
    thr[rng.random((trees, nodes)) < 0.1] = np.inf
    arrays = (rng.integers(0, f, (trees, nodes)).astype(np.int32), thr,
              rng.integers(-1000, 1000, (trees, nodes + 1)).astype(
                  np.float32), np.float32(7))
    return [torch.as_tensor(a, device=dev) for a in arrays]


def check_gbdt_walk(torch, np, dev, surs):
    """``gbdt_walk``: the M_ES heads of ``lif_unpackable`` at the GBDT
    cell's layer-1 rows (1.28 M, F = 10; the line's entry) and of
    ``crossbar_unpackable`` at crossbar MNIST's (312,000, F = 68), each
    at a ragged N too, against the plain version on the card (rtol 1e-5),
    timed beside the plain version and the bound; integer-leaf forests
    bit for bit (every leaf the plain version's) in the shared-memory and
    the global-table instance; one launch a call."""
    from repro_torch.kernels import gbdt_walk, ops
    out = {"max_abs_err": 0.0, "shapes": {}, "int_leaves": {}}
    before = ops.LAUNCHES["gbdt_walk"]
    calls = 0
    for name, f, ns in (("lif_unpackable", 10, (N_GBDT, N_GBDT_RAGGED)),
                        ("crossbar_unpackable", 68,
                         (N_XBAR, N_XBAR_RAGGED))):
        a = surs[name].params["M_ES"]
        tables = gbdt_walk.forest(a["feat"], a["thr"], a["leaf"], a["base"],
                                  f)
        trees, depth = a["feat"].shape[0], gbdt_walk.depth_of(a["feat"])
        for n in ns:
            x = torch.as_tensor(gbdt_rows(np, a, n, f, n), device=dev)
            tag = f"gbdt_walk {name} M_ES n={n}"
            got = ops.gbdt_walk(x, *tables)
            want = gbdt_walk.gbdt_plain(x, a["feat"], a["thr"], a["leaf"],
                                        a["base"])
            torch.cuda.synchronize()
            calls += 1
            res = {"max_abs_err": compare(got, want, tag),
                   "shared": gbdt_walk.shared(f, trees, depth)}
            if n in (N_GBDT, N_XBAR):
                res["ms"] = time_ms(lambda: ops.gbdt_walk(x, *tables), torch)
                res["plain_ms"] = time_ms(lambda: gbdt_walk.gbdt_plain(
                    x, a["feat"], a["thr"], a["leaf"], a["base"]), torch)
                res["bound_ms"], res["bound_by"] = bound(
                    gbdt_walk.work(n, f, trees, depth))
                calls += 3 + REPS
            out["max_abs_err"] = max(out["max_abs_err"], res["max_abs_err"])
            out["shapes"][f"x ({n}, {f}), {trees} trees of depth {depth}"] \
                = res
    for trees, depth, f, n in ((44, 8, 10, N_GBDT_RAGGED),
                               (44, 8, 300, 30_011),
                               (300, 8, 10, N_GBDT_RAGGED),
                               (9, 3, 7, 4_099)):
        feat, thr, leaf, base = int_forest(torch, np, dev, trees, depth, f,
                                           trees + f)
        x = torch.as_tensor(gbdt_rows(np, {"feat": feat, "thr": thr}, n, f,
                                      n), device=dev)
        got = ops.gbdt_walk(x, *gbdt_walk.forest(feat, thr, leaf, base, f))
        want = gbdt_walk.gbdt_plain(x, feat, thr, leaf, base)
        calls += 1
        tag = f"T={trees} D={depth} F={f} n={n}"
        if not torch.equal(got, want):
            fail(f"gbdt_walk {tag}: integer leaves differ from the plain "
                 "version's (a row reached another leaf)")
        out["int_leaves"][tag] = {"shared": gbdt_walk.shared(f, trees,
                                                             depth),
                                  "equal": True}
    main = out["shapes"][f"x ({N_GBDT}, 10), 44 trees of depth 8"]
    out.update({k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by")})
    out["kernel_check_launches"] = ops.LAUNCHES["gbdt_walk"] - before
    if out["kernel_check_launches"] != calls:
        fail(f"gbdt_walk: {out['kernel_check_launches']} launches for "
             f"{calls} calls")
    return out


def mean_linear_surrogate(np, dev):
    """A packable LIF surrogate of mean and linear heads with random
    weights from a seed, so the kernel's native-cost mean and linear
    paths run on the card too (the trained artifacts are linear + MLP)."""
    from repro_torch.convert import surrogate_from_numpy
    from repro_torch.core.surrogate import FORMAT_VERSION
    rng = np.random.default_rng(11)
    fams = {"M_ES": "mean", "M_V": "linear", "M_O": "linear",
            "M_ED": "linear", "M_L": "mean"}
    arrays = {}
    for p, fam in fams.items():
        f = 12 if p in ("M_ED", "M_L") else 10      # transition / active
        arrays[p] = ({"mu": np.asarray(rng.uniform(0.5, 2.0), np.float32)}
                     if fam == "mean" else
                     {"w": rng.normal(0, 0.5, f + 1).astype(np.float32),
                      "mu": rng.normal(0, 0.3, f).astype(np.float32),
                      "sd": rng.uniform(0.5, 2.0, f).astype(np.float32)})
    meta = {"format_version": FORMAT_VERSION, "circuit": "lif",
            "families": fams, "scales": {p: 1.0 for p in fams},
            "features": [], "fit_info": None}
    return surrogate_from_numpy(meta, arrays, dev)


def tick_inputs(torch, np, dev, n, seed, vdd):
    """One tick's inputs on the card: (v, o, t_last, params, changed, x,
    known); the first block of 128 rows has no event."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    changed = rng.random(n) < 0.7
    changed[:128] = False
    return (f32(rng.uniform(0, 1, n)), f32((rng.random(n) < 0.3) * vdd),
            f32(rng.choice([0.0, 20.0, 25.0], n)),
            f32(rng.uniform(0.5, 0.8, (n, 4))),
            torch.as_tensor(changed, device=dev),
            f32(np.stack([rng.uniform(-1, 1, n), np.full(n, 1.5),
                          np.full(n, 5.0)], 1)),
            f32((rng.random(n) < 0.4) * vdd))


def xbar_tick_inputs(torch, np, dev, n, seed):
    """One crossbar tick's inputs on the card, as ``tick_inputs``: DAC
    volts, ternary row weights, outputs in [-2, 2] V; the first block of
    128 rows has no event."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    changed = rng.random(n) < 0.7
    changed[:128] = False
    v, w, _ = xbar_rows(np, n, seed)
    return (f32(rng.uniform(-2, 2, n)), f32(rng.uniform(-2, 2, n)),
            f32(rng.choice([0.0, 20.0, 24.0], n)), f32(w),
            torch.as_tensor(changed, device=dev), f32(v),
            f32(rng.uniform(-2, 2, n)))


def tick_case(torch, np, dev, circuit, n, seed):
    """(inputs, t, clock, kwargs) of one network_tick check."""
    if circuit == "lif":
        vdd, clock, t_now = 1.5, 5.0, 30.0
        ins = tick_inputs(torch, np, dev, n, seed, vdd)
        kw = dict(spiking=True, vdd=vdd)
    else:
        clock, t_now = 4.0, 28.0
        ins = xbar_tick_inputs(torch, np, dev, n, seed)
        kw = dict(spiking=False, vdd=1.5)
    return ins, torch.full((), t_now, device=dev), clock, kw


def digest(tensors) -> str:
    """SHA-256 of the tensors' bytes, in order, as the card left them."""
    import hashlib
    h = hashlib.sha256()
    for a in tensors:
        h.update(a.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def wide_pack(torch, np, dev, pk, h1, h2, seed):
    """``pk``'s standardizers and scales with random MLP(h1, h2) heads from
    a seed: widths near the most that network_tick takes, where its row
    tiles are fewest."""
    from repro_torch.kernels.tick_megakernel import PackLayout
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    out = {}
    for name, st in pk.items():
        p, f, _ = st["w0"].shape
        new = {k: st[k] for k in ("x_mu", "x_sd", "y_mu", "y_sd", "scale")}
        for k, shape, fan in (("w0", (p, f, h1), f), ("w1", (p, h1, h2), h1),
                              ("w2", (p, h2, 1), h2)):
            new[k] = f32(rng.normal(0.0, fan ** -0.5, shape))
        for k, shape in (("b0", (p, h1)), ("b1", (p, h2)), ("b2", (p, 1))):
            new[k] = f32(rng.normal(0.0, 0.1, shape))
        out[name] = new
    return out, PackLayout(("mlp",) * 3, ("mlp",) * 2)


def tick_cases(torch, np, dev, surs):
    """check_network_tick's cases: the trained packable artifacts, a
    mean/linear pack, both kinds of a {crossbar, lif} pack, and random
    heads at the widths that leave the kernel least shared memory."""
    from repro_torch.core.surrogate import SurrogateLibrary
    from repro_torch.kernels import tick_megakernel as mk
    lib_pack, lib_layouts = mk.pack_library(SurrogateLibrary(
        {"crossbar": surs["crossbar"], "lif": surs["lif"]}))
    lif, xbar = mk.pack_heads(surs["lif"]), mk.pack_heads(surs["crossbar"])
    return [
        ("lif packable", "lif", *lif, (N_MAIN, N_RAGGED), "lif"),
        ("lif mean_linear", "lif",
         *mk.pack_heads(mean_linear_surrogate(np, dev)),
         (N_MAIN, N_RAGGED), None),
        ("crossbar packable", "crossbar", *xbar, (N_XBAR, N_XBAR_RAGGED),
         "crossbar"),
        ("lif in {crossbar, lif}", "lif", lib_pack, lib_layouts["lif"],
         (N_MAIN, N_RAGGED), None),
        ("crossbar in {crossbar, lif}", "crossbar", lib_pack,
         lib_layouts["crossbar"], (N_MIXED_XBAR, N_MIXED_XBAR + 19),
         "crossbar_in_unified_pack"),
    ] + [(f"{circuit} MLP({h1}, {h2})", circuit,
          *wide_pack(torch, np, dev, pk[0], h1, h2, h1 + h2), (N_WIDE,), None)
         for circuit, pk, h1, h2 in (("lif", lif, 128, 128),
                                     ("crossbar", xbar, 128, 50),
                                     ("crossbar", xbar, 100, 64))]


def check_network_tick(torch, np, dev, cases):
    """Standalone and annotation ticks for each ``(label, circuit, pack,
    layout, sizes, timed_as)`` case: the trained packable artifacts
    (timed at the first size), a mean/linear pack, and both kinds of a
    unified {crossbar, lif} pack, whose lif heads sit at nonzero offsets.
    Each case's five outputs are digested and held to TICK_DIGESTS: the
    inputs are seeded, so a kernel that agrees with the first design bit
    for bit prints the same digests."""
    from repro_torch.kernels import tick_megakernel as mk
    out = {"max_abs_err": 0.0, "threshold_rows": 0, "digests": {}}
    ulp = float(np.spacing(np.float32(0.75)))
    for label, circuit, pk, ly, sizes, timed_as in cases:
        for annotate in (False, True):
            for n in sizes:
                ins, t, clock, ckw = tick_case(torch, np, dev, circuit, n,
                                               n + annotate)
                v, o, t_last, params, ch, x, known = ins
                kw = dict(circuit=circuit, clock_ns=clock, layout=ly,
                          out_eps=0.02, annotate=annotate, **ckw)
                args = (pk, v, o, t_last, params, ch, x, t, known)
                tag = f"network_tick {label} n={n} annotate={annotate}"
                got = mk.network_tick(*args, **kw)
                out["digests"][tag] = digest(got)
                if out["digests"][tag] != TICK_DIGESTS.get(tag):
                    fail(f"{tag}: outputs differ from the committed digest "
                         f"{TICK_DIGESTS.get(tag)}")
                *want, o_hat = mk._tick_arrays(
                    pk["a"], pk["t"], v, o, t_last, params, ch, x, t,
                    known_out=known if annotate else None, **kw)
                torch.cuda.synchronize()
                if circuit == "lif":
                    # spikes resolve at 0.5 * vdd
                    flip = (got[1] != want[1]).cpu().numpy()
                    near = (torch.abs(o_hat - 0.75) <= HALF_VDD_BAND * ulp
                            ).cpu().numpy()
                else:
                    # an event where |o_hat - o| > out_eps: its class
                    # shows in which energy head was read
                    ev_g = ch & (torch.abs(got[1] - o) > 0.02)
                    ev_w = ch & (torch.abs(want[1] - o) > 0.02)
                    flip = (ev_g != ev_w).cpu().numpy()
                    near = (torch.abs(torch.abs(o_hat - o) - 0.02)
                            <= XBAR_BAND).cpu().numpy()
                    out["max_abs_err"] = max(out["max_abs_err"], compare(
                        got[1], want[1], f"{tag} o"))
                if (flip & ~near).any():
                    fail(f"{tag}: output event differs on "
                         f"{int((flip & ~near).sum())} rows away from its "
                         "threshold")
                out["threshold_rows"] += int(flip.sum())
                if not torch.equal(got[2], want[2]):
                    fail(f"{tag}: t_last differs")
                for name, g, w in zip(("v", "e", "l"),
                                      (got[0], got[3], got[4]),
                                      (want[0], want[3], want[4])):
                    out["max_abs_err"] = max(out["max_abs_err"], compare(
                        g, w, f"{tag} {name}", mask=~flip))
                if timed_as is None or n != sizes[0] or annotate:
                    continue
                res = tick_timing(torch, mk, args, kw, o_hat)
                if timed_as == "lif":
                    out.update(res)
                else:
                    out[timed_as] = res
    return out


def tick_timing(torch, mk, args, kw, o_hat):
    """One standalone ``network_tick`` on ``args`` (pack, v, o, t_last,
    params, changed, x, t, known) timed beside its plain version and its
    bound; ``o_hat`` is the plain version's M_O prediction."""
    pk, v, o, t_last, params, ch, x, t, _ = args
    circuit, clock, ly = kw["circuit"], kw["clock_ns"], kw["layout"]
    n = v.shape[0]
    p_a, f_a, h1 = pk["a"]["w0"].shape
    p_t, f_t, _ = pk["t"]["w0"].shape
    h2 = pk["a"]["w1"].shape[2]
    res = {"shape": f"N={n}, {circuit} rows, A stack "
                    f"{p_a}x({f_a},{h1},{h2}), T stack "
                    f"{p_t}x({f_t},{h1},{h2})"}
    res["ms"] = time_ms(lambda: mk.network_tick(*args, **kw), torch)
    res["plain_ms"] = time_ms(lambda: mk._tick_arrays(
        pk["a"], pk["t"], v, o, t_last, params, ch, x, t,
        known_out=None, **kw), torch)
    # the work this data needs: active heads on changed rows, idle heads
    # on stale ones, transition heads where the output changed; idle rows
    # are copied through
    stale = ch & (t_last < float(t) - clock)
    if circuit == "lif":
        fired = ch & (o_hat > 0.75)
    else:
        fired = ch & (torch.abs(o_hat - o) > 0.02)
    n_ch, n_st, n_tr = (int(m.sum()) for m in (ch, stale, fired))
    res["bound_ms"], res["bound_by"] = bound(mk.work(
        pk, ly, circuit, n, x.shape[1], params.shape[1],
        rows=(n_ch, n_st, n_tr)))
    res["rows"] = {"changed": n_ch, "stale": n_st, "output_changed": n_tr}
    return res


def lif_chunk_inputs(torch, np, dev, n, t_steps, seed):
    """(state (N, 3), x_seq (T, N, 3), params (N, 4)) on the card, drives
    as the engine gives them (w in [-1, 1], V_dd, 5 spikes)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    state = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 0.3, n),
                      rng.uniform(0, 3, n) * (rng.random(n) < 0.3)], 1)
    x = np.stack([rng.uniform(-1, 1, (t_steps, n)),
                  np.full((t_steps, n), 1.5), np.full((t_steps, n), 5.0)],
                 -1)
    return f32(state), f32(x), f32(rng.uniform(0.5, 0.8, (n, 4)))


def chunk_against_plain(torch, circ, tag, got, state, x, params, out,
                        v_seq=None):
    """Hold one ``lif_chunk`` case's outputs (new_state then LIF_OBS)
    against its plain version (T chained periods; spiked equal, the rest
    within RTOL) and against T ``lif_step`` launches, bit for bit; and
    ``v_seq`` (``record_v=True``), where given, against the V_mem of those
    launches' states, bit for bit, and the plain version's within RTOL."""
    from repro_torch.kernels import lif_scan
    t_steps = x.shape[0]
    want = lif_scan.chunk_plain(circ, state, x, params, v_seq is not None)
    s, steps, v_mem = state, [], []
    for k in range(t_steps):
        s, o = lif_scan.lif_step(s, x[k], params, circ=circ)
        steps.append(o)
        v_mem.append(s[:, 0])
    torch.cuda.synchronize()
    if v_seq is not None:
        if not all(torch.equal(v_seq[k], v_mem[k]) for k in range(t_steps)):
            fail(f"{tag}: v_seq differs from the V_mem of {t_steps} "
                 "lif_step launches")
        out["max_abs_err"] = max(out["max_abs_err"],
                                 compare(v_seq, want[5], f"{tag} v_seq"))
    if not torch.equal(got[4], want[4]):
        fail(f"{tag}: spiked differs from the plain version on "
             f"{int((got[4] != want[4]).sum())} neuron-ticks")
    for name, g, w in zip(("state", "output", "energy", "latency"),
                          got[:4], want[:4]):
        out["max_abs_err"] = max(out["max_abs_err"],
                                 compare(g, w, f"{tag} {name}"))
    obs = dict(zip(LIF_OBS, got[1:]))
    same = torch.equal(got[0], s) and all(
        torch.equal(obs[f][k], steps[k][f]) for k in range(t_steps)
        for f in ("output", "energy", "latency", "spiked"))
    if not same:
        fail(f"{tag}: differs from {t_steps} lif_step launches")


def check_lif_chunk(torch, np, dev, times):
    """``lif_chunk``: each output of :func:`lif_cases`'s ``lif_chunk``
    cases digested and held to LIF_DIGESTS; against its plain version (T
    chained periods) and against T ``lif_step`` launches, both bit for
    bit, there and on the generic instance (LIF_GENERIC, T_GENERIC ticks
    at N_GENERIC_LIF); at training's shape (N_TRAIN, T_TRAIN) also with
    ``record_v``: its other outputs equal to the call without it, and
    ``v_seq`` held by :func:`chunk_against_plain`; ``times``
    (:func:`shape_times`) at N = 12,800, T = 64 (the line's entry) and at
    T = 125, N = 2,000 and 1,000 (there with ``v_seq`` too), each beside
    its bound and the serial-chain estimate."""
    from repro_torch.core.circuits import LIFNeuron
    from repro_torch.kernels import lif_scan
    circ = LIFNeuron()
    cases = [c for c in lif_cases(torch, np, dev) if c[0].startswith(
        "lif_chunk")]
    digests, outs = golden_digests(torch, cases, LIF_DIGESTS)
    out = {"shape": f"state ({N_MAIN}, 3), x_seq ({T_CHUNK_CHECK}, {N_MAIN}, "
                    f"3), params ({N_MAIN}, 4)", "max_abs_err": 0.0,
           "digests_held": len(digests), "ms_by_shape": {},
           "bound_ms_by_shape": {}, "chain_ms_by_shape": {},
           "generic_cases": [],
           "cases": {f"n={n} T={t}": label
                     for (n, t), label in LIF_CHUNK_LABELS.items()}}
    for (tag, _, (state, x, params)), (n, t_steps) in zip(cases,
                                                          LIF_CHUNK_SHAPES):
        got = tuple(outs[tag][k] for k in ("new_state", *LIF_OBS))
        chunk_against_plain(torch, circ, tag, got, state, x, params, out)
        out[f"equals_{t_steps}_lif_step_launches"] = True
        if n == N_RAGGED:
            continue
        key = f"n={n} T={t_steps}"
        out["ms_by_shape"][key] = times["lif_chunk"][n]
        if (n, t_steps) == (N_TRAIN, T_TRAIN):
            run_v = lambda: lif_scan.lif_chunk(state, x, params, circ=circ,
                                               record_v=True)
            new_state, obs = run_v()
            if not (torch.equal(new_state, got[0]) and all(
                    torch.equal(obs[k], g) for k, g in zip(LIF_OBS,
                                                           got[1:]))):
                fail(f"{tag}: record_v changed the other outputs")
            chunk_against_plain(torch, circ, f"{tag} record_v", got, state,
                                x, params, out, v_seq=obs["v_seq"])
            out["v_seq_equals_lif_step_states"] = True
            vkey = f"{key} v_seq"
            out["ms_by_shape"][vkey] = time_ms(run_v, torch)
            out["bound_ms_by_shape"][vkey] = bound(lif_scan.work(
                n, circ.n_substeps, t_steps, record_v=True))[0]
        ms, by = bound(lif_scan.work(n, circ.n_substeps, t_steps))
        out["bound_ms_by_shape"][key] = ms
        # an estimate, not a bound and not a reading: the dependent fp32
        # chain of T periods, any N (left out of the kernels line)
        out["chain_ms_by_shape"][key] = (
            t_steps * circ.n_substeps * LIF_CHAIN_OPS * FP32_LATENCY_CYCLES
            / sm_clock_hz() * 1e3)
        if n == N_MAIN:
            out["spiking_share"] = float(got[4].float().mean())
            out["ms"] = times["lif_chunk"][n]
            # 64 x 64 substeps of small PyTorch ops: over a second a call
            out["plain_ms"] = time_ms(
                lambda: lif_scan.chunk_plain(circ, state, x, params), torch,
                reps=3)
            out["ms_per_tick"] = out["ms"] / t_steps
            out["lif_step_x64_ms"] = time_ms(lambda: [
                lif_scan.lif_step(state, x[k], params, circ=circ)
                for k in range(t_steps)], torch)
            out["bound_ms"], out["bound_by"] = ms, by
            out["chain_ms"] = out["chain_ms_by_shape"][key]
    for fields in LIF_GENERIC:
        gen = LIFNeuron(**fields)
        for n in N_GENERIC_LIF:
            tag = f"lif_chunk {fields} T={T_GENERIC} n={n}"
            args = lif_chunk_inputs(torch, np, dev, n, T_GENERIC, n)
            new_state, obs = lif_scan.lif_chunk(*args, circ=gen)
            chunk_against_plain(torch, gen, tag, (new_state, *(
                obs[k] for k in LIF_OBS)), *args, out)
            out["generic_cases"].append(tag)
    return out


def check_network_tick_chunk(torch, np, dev, cases, ns=(N_MAIN, N_RAGGED),
                             t_steps=T_CHUNK_CHECK):
    """``network_tick_chunk`` (T = 64, LIF rows; or ``t_steps`` over rows
    ``ns``, the first timed) on each ``(label, pack, layout, timed)`` case
    against its plain version (T plain ticks) and against T
    ``network_tick`` launches: o, t_last and the event class identical to
    the launches (and v, e, l too: the same device code)."""
    from repro_torch.core.wrapper import LasanaState
    from repro_torch.kernels import tick_megakernel as mk
    clock, vdd = 5.0, 1.5
    ulp = float(np.spacing(np.float32(0.75)))
    out = {"max_abs_err": 0.0, "threshold_rows": 0}
    for label, pk, ly, timed in cases:
        for n in ns:
            v, o, t_last, params, _, _, _ = tick_inputs(torch, np, dev, n,
                                                        n + 5, vdd)
            rng = np.random.default_rng(n + 6)
            changed = rng.random((t_steps, n)) < 0.7
            changed[:, :128] = False
            ch = torch.as_tensor(changed, device=dev)
            _, x, _ = lif_chunk_inputs(torch, np, dev, n, t_steps, n + 7)
            ts = torch.as_tensor(
                (np.arange(t_steps, dtype=np.float32) + 7.0) * clock,
                device=dev)
            kw = dict(circuit="lif", clock_ns=clock, layout=ly,
                      spiking=True, vdd=vdd)
            got = mk.network_tick_chunk(pk, v, o, t_last, params, ch, x, ts,
                                        **kw)
            st, seq = (v, o, t_last), []
            for k in range(t_steps):
                r = mk.network_tick(pk, *st, params, ch[k], x[k], ts[k],
                                    None, **kw)
                st, seq = r[:3], seq + [r]
            tag = f"network_tick_chunk {label} n={n}"
            torch.cuda.synchronize()
            launches = (torch.equal(got[0], st[0]), torch.equal(got[1], st[1]),
                        torch.equal(got[2], st[2]),
                        all(torch.equal(got[3][k], seq[k][1])
                            and torch.equal(got[4][k], seq[k][3])
                            and torch.equal(got[5][k], seq[k][4])
                            for k in range(t_steps)))
            if not all(launches):
                fail(f"{tag}: differs from {t_steps} network_tick launches "
                     f"(v, o, t_last, per-tick records equal: {launches})")
            # the plain version, tick by tick from the kernel's own state,
            # so that a threshold flip in one tick does not carry over
            state = LasanaState(v, o, t_last, params)
            for k in range(t_steps):
                pv, po, ptl, pe, pl_, o_hat = mk._tick_arrays(
                    pk["a"], pk["t"], state.v, state.o, state.t_last,
                    params, ch[k], x[k], ts[k], circuit="lif",
                    clock_ns=clock, out_eps=0.02, spiking=True, vdd=vdd,
                    annotate=False, known_out=None, layout=ly)
                g = seq[k]
                flip = (g[1] != po).cpu().numpy()
                near = (torch.abs(o_hat - 0.75) <= HALF_VDD_BAND * ulp
                        ).cpu().numpy()
                if (flip & ~near).any():
                    fail(f"{tag} tick {k}: spike differs from the plain "
                         f"version on {int((flip & ~near).sum())} rows away "
                         "from the threshold")
                out["threshold_rows"] += int(flip.sum())
                if not torch.equal(g[2], ptl):
                    fail(f"{tag} tick {k}: t_last differs from the plain "
                         "version")
                for name, a, b in (("v", g[0], pv), ("e", g[3], pe),
                                   ("l", g[4], pl_)):
                    out["max_abs_err"] = max(out["max_abs_err"], compare(
                        a, b, f"{tag} tick {k} {name}", mask=~flip))
                state = LasanaState(*g[:3], params)
            out[f"{label}: equals_{t_steps}_network_tick_launches"] = True
            if not timed or n != ns[0]:
                continue
            args = (pk, v, o, t_last, params, ch, x, ts)
            out["shape"] = (f"N={n}, T={t_steps}, LIF rows, A stack "
                            f"{tuple(pk['a']['w0'].shape)}, T stack "
                            f"{tuple(pk['t']['w0'].shape)}")
            out["ms"] = time_ms(lambda: mk.network_tick_chunk(*args, **kw),
                                torch)
            out["plain_ms"] = time_ms(lambda: mk.chunk_plain(
                pk, "lif", LasanaState(v, o, t_last, params), ch, x, ts,
                clock, layout=ly), torch, reps=5)
            out["ms_per_tick"] = out["ms"] / t_steps
            out[f"network_tick_x{t_steps}_ms"] = time_ms(lambda: seq_launch(
                mk, pk, v, o, t_last, params, ch, x, ts, kw), torch)
            # the work this data needs, tick by tick from the launches
            rows, prev_tl = [], t_last
            for k in range(t_steps):
                rows.append((int(ch[k].sum()),
                             int((ch[k] & (prev_tl < ts[k] - clock)).sum()),
                             int((ch[k] & (seq[k][1] > 0.75)).sum())))
                prev_tl = seq[k][2]
            out["bound_ms"], out["bound_by"] = bound(
                mk.chunk_work(pk, ly, n, t_steps, rows=rows))
    return out


def seq_launch(mk, pk, v, o, t_last, params, ch, x, ts, kw):
    """T ``network_tick`` launches, state passed from tick to tick."""
    st = (v, o, t_last)
    for k in range(ch.shape[0]):
        st = mk.network_tick(pk, *st, params, ch[k], x[k], ts[k], None,
                             **kw)[:3]


def check_routing_rule():
    """``tick_megakernel.kernel_takes`` / ``chunk_takes``, the Python
    copies of network_tick's layout rule that route every pack, against
    the compiled rule (``network_tick_park_floats`` >= 0,
    ``network_tick_chunk_takes``) on (circuit, h1, h2) over ROUTE_H1 x
    ROUTE_H2 for both row kinds."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import tick_megakernel as mk
    fn = _build.library("network_tick").network_tick_chunk_takes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    out = {"cases": 0, "kernel_takes": 0, "chunk_takes": 0}
    for circuit, code in mk._CIRCUIT_CODE.items():
        fa = mk._row_width(circuit)
        for h1 in ROUTE_H1:
            for h2 in ROUTE_H2:
                py = (mk.kernel_takes(circuit, fa, fa + 2, h1, h2),
                      mk.chunk_takes(circuit, fa, fa + 2, h1, h2))
                cu = (mk._park_floats(circuit, h1, h2) >= 0,
                      bool(fn(code, h1, h2)))
                if py != cu:
                    fail(f"routing rule {circuit} MLP({h1}, {h2}): "
                         f"(kernel_takes, chunk_takes) {py}, compiled {cu}")
                out["cases"] += 1
                out["kernel_takes"] += py[0]
                out["chunk_takes"] += py[1]
    return out


def print_digests(torch, np, dev, surs):
    """The digests of every heads_cases, tick_cases, lif_cases and
    xbar_cases output and the golden kernels' :func:`shape_times`, from the
    kernels of whichever ``repro_torch`` is imported (``--src``)."""
    from repro_torch.kernels import tick_megakernel as mk
    out = {}
    for tag, _, fn, args, _ in heads_cases(torch, np, dev, surs):
        out[tag] = digest([fn(*args)])
    for label, circuit, pk, ly, sizes, _ in tick_cases(torch, np, dev, surs):
        for annotate in (False, True):
            for n in sizes:
                ins, t, clock, ckw = tick_case(torch, np, dev, circuit, n,
                                               n + annotate)
                v, o, t_last, params, ch, x, known = ins
                out[f"network_tick {label} n={n} annotate={annotate}"] = \
                    digest(mk.network_tick(
                        pk, v, o, t_last, params, ch, x, t, known,
                        circuit=circuit, clock_ns=clock, layout=ly,
                        out_eps=0.02, annotate=annotate, **ckw))
    golden = {}
    for cases in (lif_cases(torch, np, dev), xbar_cases(torch, np, dev)):
        golden.update(golden_digests(torch, cases, None)[0])
    line({"phase": "digests", "src": str(sys.path[0]), "digests": out,
          "golden_digests": golden,
          "golden_ms": shape_times(torch, np, dev)})


def parent_times(src: str) -> dict:
    """:func:`shape_times` of the kernels under another commit's ``src``
    directory, from ``chip_smoke.py --digests --src`` in a subprocess (the
    same seeded inputs, the same card)."""
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--digests", "--src", src], capture_output=True,
                         text=True, timeout=900, check=False)
    for ln in res.stdout.splitlines():
        if ln.startswith('{"phase": "digests"'):
            return json.loads(ln)["golden_ms"]
    fail(f"--parent {src}: no digests line (exit {res.returncode}):\n"
         f"{res.stderr[-2000:]}")


def flash_inputs(torch, dev, bh, g, s, d, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((n, s, d), generator=gen, device=dev).to(dtype)
            for n in (bh, bh // g, bh // g)]


def flash_err(got, want, tol, name, res=None):
    """assert_allclose(rtol=tol, atol=tol), as the reference's test;
    returns the largest absolute difference. With ``res`` (a dict) the
    bf16 output is also held to FLASH_ULP element by element and to
    FLASH_OFF_ULP's share of outputs that differ at all; ``res`` gets the
    largest |err| / ulp limit and that share."""
    g, w = got.double(), want.double()
    err = (g - w).abs()
    if bool((err > tol + tol * w.abs()).any()) or not bool(
            got.isfinite().all()):
        fail(f"flash_attention {name}: max abs err {float(err.max()):.3e} "
             f"beyond {tol}")
    if res is not None:
        ulp = float((err / (FLASH_ULP[0] * w.abs() + FLASH_ULP[1])).max())
        off = float((got != want).double().mean())
        if ulp > 1.0 or off > FLASH_OFF_ULP:
            fail(f"flash_attention {name}: {ulp:.3f} of the bf16 ulp limit "
                 f"{FLASH_ULP}, {off:.4f} of outputs off the plain "
                 f"version's (at most {FLASH_OFF_ULP})")
        res[name] = {"of_ulp_limit": ulp, "share_off": off}
    return float(err.max())


def flash_timing(torch, flash_attn, q, k, v, g, heads=24, plain=False):
    """Kernel, plain and SDPA times and the bound of one bf16 shape of
    ``heads`` query heads a batch row; K/V repeated to the query heads for
    SDPA beforehand (yardstick only: the port never calls it). The plain
    version is timed up to S = 512, or at any S with ``plain``."""
    bh, s, d = q.shape
    out = {"shape": f"q ({bh}, {s}, {d}), k/v ({bh // g}, {s}, {d}), bf16, "
                    f"G = {g}"}
    out["ms"] = time_ms(lambda: flash_attn.flash_attention(q, k, v,
                                                           groups=g), torch)
    if s <= FLASH_S or plain:
        out["plain_ms"] = time_ms(
            lambda: flash_attn.attention_plain(q, k, v, g), torch)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k_rep, v_rep = (t.repeat_interleave(g, dim=0) for t in (k, v))
    q4, k4, v4 = (t.view(bh // heads, heads, s, d)
                  for t in (q, k_rep, v_rep))
    out["library_ms"] = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True),
                                torch)
    out["bound_ms"], out["bound_by"] = bound(flash_attn.work(
        tuple(q.shape), tuple(k.shape), q.dtype, g))
    return out


def check_flash_attention(torch, np, dev):
    """The tensor-core route (bf16, D = 128, G = 12) at the check shape
    (q 96 x 512 x 128; timed), the serve run's prefill shape (q 192 x 512
    x 128; timed), S = 4,096 (timed; held against the plain version on its
    first KV group, 12 query rows), a ragged S = 500, G = 12 against G = 1
    on repeated K/V and causality; the fp32 / D = 8 route on the reference
    test's fp32 shapes and at D = 8, counted apart."""
    from repro_torch.kernels import flash_attn, ops
    bh, g, s, d = FLASH_BH, FLASH_G, FLASH_S, FLASH_D
    before = dict(ops.LAUNCHES)
    q, k, v = flash_inputs(torch, dev, bh, g, s, d, torch.bfloat16, 1)
    got = flash_attn.flash_attention(q, k, v, groups=g)
    want = flash_attn.attention_plain(q, k, v, g)
    torch.cuda.synchronize()
    res = {}                # the tensor-core route against bf16 resolution
    out = {"max_abs_err": flash_err(got, want, FLASH_TOL["bf16"], "bf16",
                                    res)}
    k_rep, v_rep = (t.repeat_interleave(g, dim=0) for t in (k, v))
    if not torch.equal(got, flash_attn.flash_attention(q, k_rep, v_rep)):
        fail("flash_attention: G = 12 differs from G = 1 on repeated K/V")
    k2, v2 = k.clone(), v.clone()
    k2[:, 401:] = 99.0
    v2[:, 401:] = -99.0
    got2 = flash_attn.flash_attention(q, k2, v2, groups=g)
    if not torch.equal(got[:, :401], got2[:, :401]) or torch.equal(got,
                                                                   got2):
        fail("flash_attention: K/V past position 400 moved earlier outputs")
    rq, rk, rv = flash_inputs(torch, dev, bh, g, 500, d, torch.bfloat16, 2)
    ragged = flash_err(flash_attn.flash_attention(rq, rk, rv, groups=g),
                       flash_attn.attention_plain(rq, rk, rv, g),
                       FLASH_TOL["bf16"], "bf16 ragged S=500", res)
    sq, sk, sv = flash_inputs(torch, dev, FLASH_SERVE_BH, g, s, d,
                              torch.bfloat16, 3)
    serve = flash_err(flash_attn.flash_attention(sq, sk, sv, groups=g),
                      flash_attn.attention_plain(sq, sk, sv, g),
                      FLASH_TOL["bf16"], "bf16 serve shape", res)
    lq, lk, lv = flash_inputs(torch, dev, bh, g, FLASH_LONG_S, d,
                              torch.bfloat16, 4)
    long_got = flash_attn.flash_attention(lq, lk, lv, groups=g)
    long_err = flash_err(long_got[:g], flash_attn.attention_plain(
        lq[:g], lk[:1], lv[:1], g), FLASH_TOL["bf16"], "bf16 S=4096", res)
    if not bool(long_got.isfinite().all()):
        fail("flash_attention: non-finite output at S=4096")
    tc_launches = ops.LAUNCHES["flash_attention"] - before["flash_attention"]
    # the fp32 / D = 8 route
    simt_before = ops.LAUNCHES["flash_attention_simt"]
    fp32 = 0.0
    for ss, dd in ((256, 64), (512, 64), (256, 128), (512, 128), (500, 64)):
        args = flash_inputs(torch, dev, 2, 1, ss, dd, torch.float32, ss + dd)
        fp32 = max(fp32, flash_err(flash_attn.flash_attention(*args),
                                   flash_attn.attention_plain(*args),
                                   FLASH_TOL["fp32"], f"fp32 S={ss} D={dd}"))
    d8 = 0.0
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        args = flash_inputs(torch, dev, 24, 12, 500, 8, dtype, 5)
        d8 = max(d8, flash_err(flash_attn.flash_attention(*args, groups=12),
                               flash_attn.attention_plain(*args, 12),
                               FLASH_TOL[name], f"{name} D=8"))
    simt = ops.LAUNCHES["flash_attention_simt"] - simt_before
    if simt != 7 or ops.LAUNCHES["flash_attention"] != before[
            "flash_attention"] + tc_launches:
        fail(f"flash_attention: the fp32 / D = 8 checks made {simt} "
             "launches of the fp32-core route, expected 7, and none of the "
             "tensor-core route")
    out.update({"route": "tensor cores (wgmma, TMA) for bf16 with D in "
                         f"{flash_attn.TC_HEAD_DIMS}; fp32 cores otherwise",
                "max_abs_err_ragged_500": ragged,
                "max_abs_err_serve_shape": serve,
                "max_abs_err_s4096_first_kv_group": long_err,
                "bf16_resolution": res,
                "g12_equals_repeated_kv": True, "causal_past_400": True,
                "simt_route": {"max_abs_err_fp32": fp32,
                               "max_abs_err_d8": d8,
                               "launches_in_check": simt},
                "tolerance": FLASH_TOL, "ulp_limit": FLASH_ULP,
                "share_off_limit": FLASH_OFF_ULP})
    out.update(flash_timing(torch, flash_attn, q, k, v, g))
    out["library"] = "scaled_dot_product_attention(is_causal=True), K/V " \
                     "repeated to 24 heads"
    out["serve_shape"] = flash_timing(torch, flash_attn, sq, sk, sv, g)
    out["s4096"] = flash_timing(torch, flash_attn, lq, lk, lv, g)
    # the other zoo configs' serve prefills (phase 6): against the plain
    # version and timed beside it and SDPA
    zoo = {}
    for i, (arch, (h, zg, zd)) in enumerate(ZOO_FLASH.items()):
        zs = ZOO_SERVE_PROMPT.get(arch, ZOO_SERVE_PROMPT_LEN)
        zq, zk, zv = flash_inputs(torch, dev, ZOO_SERVE_BATCH * h, zg, zs,
                                  zd, torch.bfloat16, 10 + i)
        err = flash_err(flash_attn.flash_attention(zq, zk, zv, groups=zg),
                        flash_attn.attention_plain(zq, zk, zv, zg),
                        FLASH_TOL["bf16"], f"bf16 {arch} serve shape", res)
        zoo[arch] = {"max_abs_err": err, **flash_timing(
            torch, flash_attn, zq, zk, zv, zg, heads=h, plain=True)}
        out["max_abs_err"] = max(out["max_abs_err"], err)
        del zq, zk, zv
    out["zoo_serve_shapes"] = zoo
    # the tp phase's per-shard prefill shapes: StarCoder2-3B's 24 heads
    # over 2 shards (12 heads on 1 kv head a shard) and over 4 (6 heads on
    # the one kv head they use), batch 8 x 512, on the tensor-core route
    tp = {}
    for i, (name, heads, tg) in enumerate(TP_FLASH):
        tq, tk, tv = flash_inputs(torch, dev, ZOO_SERVE_BATCH * heads, tg,
                                  FLASH_S, FLASH_D, torch.bfloat16, 20 + i)
        if flash_attn.route(tq.dtype, FLASH_D) != "flash_attention":
            fail(f"flash_attention: tp shape {name} off the tensor cores")
        err = flash_err(flash_attn.flash_attention(tq, tk, tv, groups=tg),
                        flash_attn.attention_plain(tq, tk, tv, tg),
                        FLASH_TOL["bf16"], f"bf16 tp {name} shard shape", res)
        tp[name] = {"max_abs_err": err, **flash_timing(
            torch, flash_attn, tq, tk, tv, tg, heads=heads, plain=True)}
        out["max_abs_err"] = max(out["max_abs_err"], err)
        del tq, tk, tv
    out["tp_shard_shapes"] = tp
    return out


# --- phase 3b: the static gates on the card ----------------------------------

@contextlib.contextmanager
def no_sync(torch):
    """Host synchronisation forbidden inside: any synchronising call
    raises (sync debug mode "error")."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def device_kernels(torch, build) -> dict:
    """CUDA operations per tick and fixed of one audit entrypoint in
    ``torch.profiler``: every device event (kernels, copies, fills) of
    its runs at 1, 2 and 3 ticks, each profiled alone. A session has been
    seen to lose events now and then, so counts that are not affine in
    the ticks are measured once more, then reported as they are."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def once(n):
        entry = build(n)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            entry.fn(*entry.args)
            torch.cuda.synchronize()
        return sum(ev.count for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA)

    for _ in range(2):
        k1, k2, k3 = (once(n) for n in (1, 2, 3))
        if k3 - k2 == k2 - k1 and k1 >= k2 - k1:
            return {"cuda_kernels_per_tick": k2 - k1,
                    "cuda_kernels_fixed": 2 * k1 - k2}
    return {"cuda_kernels_per_tick": "not measured",
            "cuda_kernels_at_1_2_3_ticks": [k1, k2, k3]}


def audit_runs(torch, dev, smi):
    """The program audit on the card: every entrypoint registered by
    ``repro_torch.analysis.jaxpr_audit``, built on the card and run at 1,
    2 and 3 ticks (b = 2), each run under sync debug mode "error", with
    ``ops.LAUNCHES`` read just before and just after it. Fails on any
    finding (dispatch and kernel ceilings, a write to the
    caller's carries, an fp64 output, a host sync, counts not linear in
    the ticks), unless ``ops.LAUNCHES`` per tick and fixed equal the
    frozen ``kernels`` row exactly, and on any drift that
    ``jaxpr_audit.compare_budgets`` finds on the card (the dispatches,
    kernel calls and writes of the CPU's frozen rows). Each entry's line
    reports, beside the frozen CPU count of aten ops per tick, the card's
    own count and the CUDA kernels per tick in ``torch.profiler``
    (reported, not held). These are fixtures, not a main path: their
    launches stay on the ``audit`` lines and out of the ``kernels`` line."""
    from repro_torch.analysis import jaxpr_audit as ja
    t0 = time.perf_counter()
    frozen = ja.load_budgets()
    registered = ja.registered_entrypoints()
    if set(registered) != set(frozen):
        fail(f"audit: registered {sorted(registered)} != frozen "
             f"{sorted(frozen)}")
    with ja.pinned_env():
        ctx = ja.build_context(dev)
        for name, builder in sorted(registered.items()):
            build = functools.partial(builder, ctx)
            m, findings = ja.audit_entry(name, build,
                                         around=lambda: no_sync(torch))
            want = frozen[name]
            findings += ja.compare_budgets({name: m.budget_row()},
                                           {name: want}, dev)
            if findings:
                fail(f"audit {name}: " + "; ".join(map(str, findings)))
            if m.launches != want["kernels"]:
                fail(f"audit {name}: launches {m.launches}, frozen "
                     f"{want['kernels']}")
            line({"phase": "audit", "entry": name, "launches": m.launches,
                  "dispatches": m.dispatches, "writes": m.writes,
                  "cpu_ops_per_tick_frozen": want["ops"],
                  "card_ops_per_tick": m.ops,
                  **device_kernels(torch, build),
                  "sync_debug_mode": "error", "nvidia_smi": smi})
    line({"phase": "audit_done", "entries": len(frozen),
          "seconds": time.perf_counter() - t0})


# --- phase 4: the main path -------------------------------------------------

def profile_run(torch, fn) -> dict:
    """Device time by kernel over one more steady run, ``fn()``
    (``torch.profiler``): the device's busy and idle share of the run's
    wall time (the profiler adds host time of its own) and the five
    kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies, fills): a host op's
        # own entry carries its kernels' time again
        us = getattr(ev, "self_device_time_total", 0)
        if ev.device_type == DeviceType.CUDA and us > 0:
            rows.append((us, ev.key[:60], ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    if not rows:
        return {"wall_s": wall, "device_busy_s": "not measured"}
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "top": [{"kernel": k, "ms": us / 1e3, "calls": c}
                    for us, k, c in rows[:5]]}


def drive(torch, spec, x, kw, profile):
    """One main-path run through ``lasana.simulate`` with the launch
    counters reset just before it and read just after it, then a steady
    run of the same engine enqueued with host syncs forbidden. Returns
    (first run, launch counts, the line's common fields)."""
    import repro_torch.lasana as lasana
    from repro_torch.kernels import ops
    ops.reset_launches()
    run = lasana.simulate(spec, x, **kw)
    counts = dict(ops.LAUNCHES)
    eng = lasana.engine(spec, **{k: v for k, v in kw.items()
                                 if k != "surrogates"})
    # steady state: the whole tick loop enqueued with host syncs
    # forbidden; any synchronising call in it raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = eng.dispatch(x, surrogates=kw.get("surrogates"))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rep = pending.result().report()["network"]
    res = {"phase": "main_path", "launches": counts,
           "wall_s": rep["wall_seconds"],
           "events_per_s": rep["events_per_sec"], "events": rep["events"],
           "sync_debug_mode": "error"}
    if profile:
        res["profile"] = profile_run(torch, lambda: eng.dispatch(
            x, surrogates=kw.get("surrogates")).result())
    return run, counts, res


def energy_diff(np, run, rec, key):
    """Total energy (ticks + flush) of the port's run and its relative
    difference from the reference record's."""
    e_port = float(run.energy.sum() + run.flush_energy.sum())
    e_ref = float(rec[f"{key}/energy"].sum() + rec[f"{key}/flush_energy"].sum())
    return e_port, abs(e_port - e_ref) / max(abs(e_ref), 1e-30)


def check_launches(name, counts, want):
    """``want``: kernel -> exact count, or (">=", count)."""
    for kernel, n in want.items():
        got = counts[kernel]
        ok = got >= n[1] if isinstance(n, tuple) else got == n
        if not ok:
            fail(f"{name}: {kernel} launched {got} times, expected {n}")


def snn_workload(torch, np, dev):
    """The 784-128-10 SNN's spec, its 100 digits x 100 ticks of V_dd
    spikes (T, B, 784) on the card, and their labels."""
    from repro_torch.convert import spec_from_numpy
    from repro_torch.data.mnist import make_digits, poisson_encode
    with np.load(ART / "snn_784_128_10.npz") as z:
        ws = [z["w0"], z["w1"]]
    knobs = [np.array(LIF_KNOBS, np.float32)] * 2
    imgs, labels = make_digits(N_IMAGES, size=28, seed=777)
    x = torch.as_tensor(poisson_encode(imgs, T_STEPS, seed=5) * 1.5,
                        dtype=torch.float32, device=dev)
    return spec_from_numpy(ws, knobs), x, labels


def snn_runs(torch, np, dev, surs, profile):
    """The 784-128-10 SNN, 100 digits x 100 ticks (slice 1's main path)."""
    spec, x, labels = snn_workload(torch, np, dev)
    rec = dict(np.load(ART / "snn_ref_record.npz"))
    total = {}
    runs = (("golden", dict(backend="golden"), {"lif_step": 2 * T_STEPS}),
            ("lasana", dict(surrogates=surs["lif"]),
             {"network_tick": 2 * T_STEPS}),
            ("lasana_unpackable", dict(surrogates=surs["lif_unpackable"]),
             # M_ES a GBDT: the idle and the active walk a layer a tick,
             # and one a layer for the end-of-run flush
             {"mlp_surrogate_heads": (">=", T_STEPS),
              "gbdt_walk": 4 * T_STEPS + 2}))
    for name, kw, want in runs:
        run, counts, res = drive(torch, spec, x, kw, profile)
        check_launches(f"snn {name}", counts, want)
        spikes = (run.out_spikes > 0.75).astype(np.uint8)
        agree = float(np.mean(spikes == rec[f"{name}/out_spikes"]))
        e_port, e_diff = energy_diff(np, run, rec, name)
        if not np.isfinite(run.energy).all() or run.outputs.shape != (
                N_IMAGES, 10):
            fail(f"snn {name}: non-finite energy or outputs of shape "
                 f"{run.outputs.shape}")
        line({**res, "workload": "snn_784_128_10", "run": name,
              "accuracy": float(np.mean(np.argmax(run.outputs, -1)
                                        == labels)),
              "spike_agreement_vs_ref": agree, "energy_j": e_port,
              "energy_rel_diff_vs_ref": e_diff})
        if agree < 0.99 or e_diff > 0.01:
            fail(f"snn {name}: spike agreement {agree:.4f} (< 0.99) or "
                 f"energy difference {e_diff:.4%} (> 1%) against the "
                 "reference")
        add_counts(total, f"snn/{name}", counts)
    return total


def wide_runs(torch, np, dev, surs, profile):
    """The 784-128-10 SNN with a surrogate whose five LIF heads are all
    MLP(200, 50), wider than network_tick takes, on the first 20 digits x
    100 ticks: the engine takes the stacked-dispatch tick, whose MLP
    groups launch ``mlp_surrogate_heads``; held to its JAX record."""
    spec, x, labels = snn_workload(torch, np, dev)
    x = x[:, :WIDE_IMAGES].contiguous()
    rec = dict(np.load(ART / "snn_wide_ref_record.npz"))
    run, counts, res = drive(torch, spec, x,
                             dict(surrogates=surs["lif_wide"]), profile)
    check_launches("snn wide", counts, {
        "mlp_surrogate_heads": (">=", T_STEPS), "network_tick": 0})
    spikes = (run.out_spikes > 0.75).astype(np.uint8)
    agree = float(np.mean(spikes == rec["lasana_wide/out_spikes"]))
    e_port, e_diff = energy_diff(np, run, rec, "lasana_wide")
    if not np.isfinite(run.energy).all() or run.outputs.shape != (
            WIDE_IMAGES, 10):
        fail(f"snn wide: non-finite energy or outputs of shape "
             f"{run.outputs.shape}")
    line({**res, "workload": "snn_784_128_10", "run": "lasana_wide",
          "surrogate": "lif_wide_200_50: every head MLP(200, 50)",
          "accuracy": float(np.mean(np.argmax(run.outputs, -1)
                                    == labels[:WIDE_IMAGES])),
          "spike_agreement_vs_ref": agree, "energy_j": e_port,
          "energy_rel_diff_vs_ref": e_diff})
    if agree < 0.99 or e_diff > 0.01:
        fail(f"snn wide: spike agreement {agree:.4f} (< 0.99) or energy "
             f"difference {e_diff:.4%} (> 1%) against the reference")
    total = {}
    add_counts(total, "snn/lasana_wide", counts)
    return total


def xbar_runs(torch, np, dev, surs, profile):
    """The ternary 400-120-84-10 crossbar MNIST net, 200 digits as one
    combinational wave of DAC volts."""
    from repro_torch.convert import crossbar_spec_from_numpy
    from repro_torch.core.circuits import CrossbarRow
    from repro_torch.data.mnist import make_digits
    with np.load(ART / "xbar_400_120_84_10.npz") as z:
        ws = [z[f"w{i}"].astype(np.float32) for i in range(3)]
    spec = crossbar_spec_from_numpy(ws)
    imgs, labels = make_digits(XBAR_IMAGES, size=20, seed=999)
    x = torch.as_tensor(imgs * 1.6 - 0.8, dtype=torch.float32, device=dev)
    rec = dict(np.load(ART / "xbar_ref_record.npz"))
    circ = CrossbarRow()
    # one ADC step of a row, in the output's gain-compensated units: two
    # outputs whose codes agree differ by float rounding only
    step = 2 * circ.v_sat / 255 / (circ.r_f * circ.g_unit)
    n_layers = len(ws)
    total = {}
    runs = (("golden", dict(backend="golden"),
             {"crossbar_target": n_layers}),
            ("lasana", dict(surrogates=surs["crossbar"]),
             {"network_tick": n_layers}),
            ("lasana_unpackable", dict(surrogates=surs["crossbar_unpackable"]),
             {"mlp_surrogate_heads": 2 * n_layers,
              "gbdt_walk": 2 * n_layers}))
    for name, kw, want in runs:
        run, counts, res = drive(torch, spec, x, kw, profile)
        check_launches(f"xbar {name}", counts, want)
        ref = rec[f"{name}/outputs"]
        if not np.isfinite(run.outputs).all() or run.outputs.shape != (
                XBAR_IMAGES, 10) or not np.isfinite(run.energy).all():
            fail(f"xbar {name}: non-finite records or outputs of shape "
                 f"{run.outputs.shape}")
        codes = float(np.mean(np.abs(run.outputs - ref) < 0.5 * step))
        argmax = float(np.mean(np.argmax(run.outputs, -1)
                               == np.argmax(ref, -1)))
        e_port, e_diff = energy_diff(np, run, rec, name)
        line({**res, "workload": "xbar_400_120_84_10", "run": name,
              "accuracy": float(np.mean(np.argmax(run.outputs, -1)
                                        == labels)),
              "argmax_agreement_vs_ref": argmax,
              "code_agreement_vs_ref": codes,
              "events_equal_ref": bool(np.array_equal(
                  run.events, rec[f"{name}/events"])),
              "energy_j": e_port, "energy_rel_diff_vs_ref": e_diff})
        if argmax < 0.99 or codes < 0.99 or e_diff > 0.01:
            fail(f"xbar {name}: argmax agreement {argmax:.4f}, code "
                 f"agreement {codes:.4f} (< 0.99) or energy difference "
                 f"{e_diff:.4%} (> 1%) against the reference")
        add_counts(total, f"xbar/{name}", counts)
    return total


def mixed_runs(torch, np, dev, surs, profile):
    """The 144-24-10 crossbar -> LIF net with lateral inhibition, 64
    digits held for 30 ticks."""
    from repro_torch.convert import graph_spec_from_numpy
    from repro_torch.core.surrogate import SurrogateLibrary
    from repro_torch.data.mnist import make_digits
    with np.load(ART / "mixed_144_24_10.npz") as z:
        w1, w2 = z["w1"].astype(np.float32), z["w2"].astype(np.float32)
    inhib = -0.4 * (1.0 - np.eye(10, dtype=np.float32))
    spec = graph_spec_from_numpy(
        [{"circuit": "crossbar", "weight": w1},
         {"circuit": "lif", "weight": w2, "params": LIF_KNOBS}],
        edges=[(1, 1, inhib)])
    imgs, labels = make_digits(MIXED_IMAGES, size=12, seed=777)
    volts = torch.as_tensor(imgs * 1.6 - 0.8, dtype=torch.float32,
                            device=dev)
    x = volts[None].expand(MIXED_TICKS, *volts.shape).contiguous()
    rec = dict(np.load(ART / "mixed_ref_record.npz"))
    library = SurrogateLibrary({"crossbar": surs["crossbar"],
                                "lif": surs["lif"]})
    total = {}
    runs = (("golden", dict(backend="golden"),
             {"crossbar_target": MIXED_TICKS, "lif_step": MIXED_TICKS}),
            ("behavioral", dict(backend="behavioral"),
             {"crossbar_target": MIXED_TICKS}),
            ("lasana", dict(surrogates=library),
             {"network_tick": 2 * MIXED_TICKS}))
    for name, kw, want in runs:
        run, counts, res = drive(torch, spec, x, kw, profile)
        check_launches(f"mixed {name}", counts, want)
        spikes = (run.out_spikes > 0.75).astype(np.uint8)
        agree = float(np.mean(spikes == rec[f"{name}/out_spikes"]))
        e_port, e_diff = energy_diff(np, run, rec, name)
        if not np.isfinite(run.energy).all() or run.outputs.shape != (
                MIXED_IMAGES, 10):
            fail(f"mixed {name}: non-finite energy or outputs of shape "
                 f"{run.outputs.shape}")
        line({**res, "workload": "mixed_144_24_10", "run": name,
              "accuracy": float(np.mean(np.argmax(run.outputs, -1)
                                        == labels)),
              "spike_agreement_vs_ref": agree, "energy_j": e_port,
              "energy_rel_diff_vs_ref": e_diff})
        if agree < 0.99 or (name != "behavioral" and e_diff > 0.01):
            fail(f"mixed {name}: spike agreement {agree:.4f} (< 0.99) or "
                 f"energy difference {e_diff:.4%} (> 1%) against the "
                 "reference")
        add_counts(total, f"mixed/{name}", counts)
    return total


# --- the train phase -------------------------------------------------------------

def counted(torch, fn):
    """``fn()`` with the launch counters reset just before it and read just
    after it: (result, counts)."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    res = fn()
    torch.cuda.synchronize()
    return res, dict(ops.LAUNCHES)


def selection_ok(rec, pname, families, selected):
    """The port's selected family against the record's: the same, or the
    record's runner-up where it lies within TRAIN_TIE of the best."""
    ranked = sorted(families, key=lambda f: float(rec[f"val_mse/{pname}/{f}"]))
    best = float(rec[f"val_mse/{pname}/{ranked[0]}"])
    allowed = {ranked[0]} | {f for f in ranked[1:2] if float(
        rec[f"val_mse/{pname}/{f}"]) <= (1 + TRAIN_TIE) * best}
    return selected in allowed, sorted(allowed)


def train_record_check(np, rec, ds, bank):
    """Dataset counts and energies per event kind, and every family's
    val_mse and the selection, against the JAX record."""
    from repro_torch.core.events import EventKind, EventSet
    full = EventSet.concat([ds.train, ds.test, ds.val])
    out = {"events": {}, "val_mse": {}, "selected": {}}
    for k in EventKind:
        sel = full.kind == int(k)
        n, e = int(sel.sum()), float(full.energy[sel].sum())
        n_ref, e_ref = int(rec[f"count/{k.name}"]), float(rec[f"energy/{k.name}"])
        out["events"][k.name] = {"count": n, "count_ref": n_ref, "energy_j": e,
                                 "energy_ref_j": e_ref}
        if abs(n - n_ref) > TRAIN_COUNT_REL * n_ref or abs(
                e - e_ref) > TRAIN_ENERGY_REL * abs(e_ref):
            fail(f"train record: {k.name} count {n} (record {n_ref}) or "
                 f"energy {e:.6e} (record {e_ref:.6e}) off its limit")
    for p, fams in bank.results.items():
        out["val_mse"][p] = {}
        for f, r in fams.items():
            ref = float(rec[f"val_mse/{p}/{f}"])
            out["val_mse"][p][f] = {"port": r.val_mse, "record": ref}
            if f == "mlp":
                ok = ref / TRAIN_MLP_FACTOR <= r.val_mse <= TRAIN_MLP_FACTOR * ref
            elif f == "gbdt":
                band = [ref, *rec[f"gbdt_band/{p}"].tolist()]
                out["val_mse"][p][f]["record_band"] = [min(band), max(band)]
                ok = (min(band) * (1 - TRAIN_VAL_MSE_REL[f]) <= r.val_mse
                      <= max(band) * (1 + TRAIN_VAL_MSE_REL[f]))
            else:
                ok = abs(r.val_mse - ref) <= TRAIN_VAL_MSE_REL[f] * ref
            if not ok:
                fail(f"train record: {p} {f} val_mse {r.val_mse:.6g} against "
                     f"the record's {ref:.6g}")
        got = min(fams.values(), key=lambda r: r.val_mse).family
        ok, allowed = selection_ok(rec, p, tuple(fams), got)
        out["selected"][p] = {"port": got,
                              "record": str(rec[f"selected/{p}"]),
                              "allowed": allowed}
        if not ok:
            fail(f"train record: {p} selected {got}, allowed {allowed}")
    return out


def gbdt_cpu_vs_card(torch, np, dev, ds, pname):
    """One predictor's GBDT fit on CPU tensors (one thread: the histograms
    summed in row order, as numpy's add.at) and on the card, on the same
    rows: the share of internal nodes of the first min(kept) trees whose
    (feature, threshold) differ, and the val_mse gap."""
    from repro_torch.core.models import GBDTModel
    from repro_torch.core.predictors import (PREDICTOR_DEFS, PredictorBank,
                                             build_features, build_target)
    d = PREDICTOR_DEFS[pname]
    bank = PredictorBank("lif", device="cpu")
    rows = []
    for split in (ds.train, ds.val):
        ev = split.of_kind(*d["kinds"])
        rows.append(bank.augment_features(build_features(
            ev, prev_out=d["prev_out"], chain_out=d.get("chain_out", False))))
        rows.append(build_target(ev, d["target"], d["scale"]))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.perf_counter()
        cpu = GBDTModel(device="cpu").fit(*rows)
        t_cpu = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    t0 = time.perf_counter()
    card = GBDTModel(device=dev).fit(*rows)
    t_card = time.perf_counter() - t0
    k = min(cpu._kept, card._kept)
    differ = (cpu.feat[:k] != card.feat[:k]) | (cpu.thr[:k] != card.thr[:k])
    mse = [float(np.mean((m.predict(rows[2]) - rows[3]) ** 2))
           for m in (cpu, card)]
    res = {"predictor": pname, "rows": len(rows[1]), "kept_cpu": cpu._kept,
           "kept_card": card._kept, "nodes_compared": int(differ.size),
           "nodes_differing_share": float(differ.mean()),
           "val_mse_cpu": mse[0], "val_mse_card": mse[1],
           "val_mse_gap": abs(mse[1] - mse[0]) / mse[0],
           "fit_s_cpu_one_thread": t_cpu, "fit_s_card": t_card}
    if res["nodes_differing_share"] > TRAIN_GBDT_NODES or \
            res["val_mse_gap"] > TRAIN_GBDT_VAL:
        fail(f"gbdt on the card vs the CPU: {res}")
    return res


def mlp_train_shapes(torch, np, dev, bank, ds, smi):
    """``mlp_surrogate`` at the training shapes: the LIF bank's trained
    M_V (F = 10) and M_ED (F = 12) heads on their validation rows, and
    MLP(100, 50) heads from a seed at the crossbar's F = 68 / 70 on as
    many rows; kernel against the plain version, each timed beside its
    bound."""
    from repro_torch.core.predictors import (PREDICTOR_DEFS, build_features)
    from repro_torch.kernels import mlp_surrogate
    out = {}
    for pname in ("M_V", "M_ED"):
        d = PREDICTOR_DEFS[pname]
        ev = ds.val.of_kind(*d["kinds"])
        model = bank.results[pname]["mlp"].model
        x = model.sx.apply_t(torch.as_tensor(bank.augment_features(
            build_features(ev, prev_out=d["prev_out"],
                           chain_out=d.get("chain_out", False))), device=dev))
        w = [torch.as_tensor(lyr[k], device=dev) for lyr in model.params
             for k in ("w", "b")]
        out[f"lif {pname}"] = (x.contiguous(), w)
    n = out["lif M_V"][0].shape[0]
    rng = np.random.default_rng(68)
    for f in (68, 70):
        x = torch.as_tensor(rng.normal(0, 1, (n, f)), dtype=torch.float32,
                            device=dev)
        out[f"crossbar F={f}"] = (x, single_head(torch, np, dev, rng, f, 100,
                                                 50))
    res = {}
    for tag, (x, w) in out.items():
        n, f = x.shape
        h1, h2 = w[0].shape[1], w[2].shape[1]
        got = mlp_surrogate.mlp_surrogate(x, *w)
        err = compare(got, mlp_surrogate.mlp_plain(x, *w), f"{tag} mlp")
        ms, by = bound(mlp_surrogate.single_work(
            n, f, h1, h2, sum(a.numel() for a in w)))
        res[f"{tag} x ({n}, {f})"] = {
            "ms": time_ms(lambda: mlp_surrogate.mlp_surrogate(x, *w), torch),
            "plain_ms": time_ms(lambda: mlp_surrogate.mlp_plain(x, *w),
                                torch),
            "bound_ms": ms, "bound_by": by, "max_abs_err": err,
            "plan": mlp_surrogate.single_plan(f, h1, h2)}
    line({"phase": "train_kernel_shapes", "kernel": "mlp_surrogate",
          "nvidia_smi": smi, "shapes": res})
    return res


def trained_on_workloads(torch, np, dev, surs, sur_lif, sur_x, total):
    """The port-trained surrogates on the SNN (100 digits x 100 ticks) and
    the crossbar MNIST wave (200 digits), each against the port's golden
    run of the same workload beside the committed JAX-trained artifact."""
    import repro_torch.lasana as lasana
    from repro_torch.convert import crossbar_spec_from_numpy
    from repro_torch.data.mnist import make_digits
    spec, x, _ = snn_workload(torch, np, dev)
    with np.load(ART / "xbar_400_120_84_10.npz") as z:
        ws = [z[f"w{i}"].astype(np.float32) for i in range(3)]
    xspec = crossbar_spec_from_numpy(ws)
    imgs, _ = make_digits(XBAR_IMAGES, size=20, seed=999)
    volts = torch.as_tensor(imgs * 1.6 - 0.8, dtype=torch.float32, device=dev)
    res = {}
    for wl, sp, stim, arts in (
            ("snn_784_128_10", spec, x, (("jax_trained", surs["lif"]),
                                         ("port_trained", sur_lif))),
            ("xbar_400_120_84_10", xspec, volts,
             (("jax_trained", surs["crossbar"]),
              ("port_trained", sur_x)))):
        runs = {}
        for name, kw in (("golden", dict(backend="golden")),
                         *((n, dict(surrogates=s)) for n, s in arts)):
            torch.cuda.reset_peak_memory_stats(dev)
            run, counts = counted(torch, lambda: lasana.simulate(sp, stim,
                                                                 **kw))
            runs[name] = run
            add_counts(total, f"train/{wl}/{name}", counts)
            e = float(run.energy.sum() + run.flush_energy.sum())
            entry = {"energy_j": e, "launches": counts,
                     "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
                     "route": ("golden" if name == "golden" else
                               "packed network_tick" if counts["network_tick"]
                               else "stacked heads (mlp_surrogate_heads)"
                               if counts["mlp_surrogate_heads"] else
                               "per-head predictions (single-head groups "
                               "and gbdt walks, no head kernel)")}
            if not np.isfinite(run.energy).all() or not np.isfinite(
                    run.outputs).all():
                fail(f"train {wl} {name}: non-finite records")
            if name != "golden":
                g = runs["golden"]
                eg = float(g.energy.sum() + g.flush_energy.sum())
                entry["energy_err_vs_golden"] = abs(e - eg) / abs(eg)
                if g.out_spikes is not None:
                    entry["spike_mismatch_vs_golden"] = float(np.mean(
                        (run.out_spikes > 0.75) != (g.out_spikes > 0.75)))
                entry["argmax_agreement_vs_golden"] = float(np.mean(
                    np.argmax(run.outputs, -1) == np.argmax(g.outputs, -1)))
            res[f"{wl} {name}"] = entry
        jax_, port = res[f"{wl} jax_trained"], res[f"{wl} port_trained"]
        e_lim = max(TRAIN_ENERGY_FACTOR * jax_["energy_err_vs_golden"],
                    TRAIN_ENERGY_FLOOR)
        if wl.startswith("snn"):
            bad = port["spike_mismatch_vs_golden"] > \
                jax_["spike_mismatch_vs_golden"] + TRAIN_SPIKE_POINTS
        else:
            bad = port["argmax_agreement_vs_golden"] < \
                jax_["argmax_agreement_vs_golden"] - TRAIN_SPIKE_POINTS
        if bad or port["energy_err_vs_golden"] > e_lim:
            fail(f"train {wl}: the port-trained surrogate {port} against "
                 f"the JAX-trained artifact's {jax_} (energy limit {e_lim})")
    return res


def train_runs(torch, np, dev, surs, profile, smi):
    """The training pipeline at the reference's scale (TrainConfig():
    1,000 runs x 125 steps, five families): LIF from the JAX record's own
    testbench through simulate_golden / extract_events / split_runwise and
    a PredictorBank on the card, held to the record; crossbar through
    ``lasana.train`` with the port's own testbench; the port's LIF
    testbench's distribution; one GBDT on the card against the CPU; the
    trained surrogates on the SNN and crossbar MNIST workloads. Returns
    (launches by run, ``mlp_surrogate``'s times at the training shapes)."""
    import repro_torch.lasana as lasana
    from repro_torch.core.dataset import (CircuitDataset, TestbenchConfig,
                                          generate_testbench,
                                          simulate_golden)
    from repro_torch.core.events import extract_events, split_runwise
    from repro_torch.core.predictors import PredictorBank
    t_phase = time.perf_counter()
    cfg = lasana.TrainConfig()
    if (cfg.n_runs, cfg.n_steps) != (N_TRAIN, T_TRAIN):
        fail(f"TrainConfig() is {cfg}, the phase expects {N_TRAIN} x "
             f"{T_TRAIN}")
    total = {}
    rec = dict(np.load(ART / "train_lif_ref_record.npz"))

    def lif_from_record():
        seconds = {}
        t0 = time.perf_counter()
        trace = simulate_golden("lif", rec["active"], rec["inputs"],
                                rec["params"], device=dev)
        seconds["golden"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tr, te, va = split_runwise(extract_events(trace), cfg.n_runs,
                                   seed=cfg.seed)
        ds = CircuitDataset("lif", tr, te, va, 0.0, cfg.n_runs)
        seconds["events"] = time.perf_counter() - t0
        bank = PredictorBank("lif", families=cfg.families, device=dev)
        bank.fit(ds)
        t0 = time.perf_counter()
        sur = bank.to_surrogate()
        seconds.update(bank.seconds)
        seconds["freeze"] = time.perf_counter() - t0
        return ds, bank, sur, seconds

    t0 = time.perf_counter()
    (ds, bank, sur_lif, seconds), counts = counted(torch, lif_from_record)
    wall = time.perf_counter() - t0
    check_launches("train lif", counts, {
        "lif_chunk": 1, "lif_step": 0, "crossbar_target": 0,
        "mlp_surrogate": (">=", 1)})
    add_counts(total, "train/lif_record", counts)
    line({"phase": "train_record", "circuit": "lif", "nvidia_smi": smi,
          **train_record_check(np, rec, ds, bank)})
    line({"phase": "train", "circuit": "lif",
          "testbench": "the JAX record's (train_lif_ref_record.npz)",
          "wall_s": wall, "seconds": seconds, "events": ds.counts(),
          "selected": dict(sur_lif.manifest.families), "launches": counts,
          "nvidia_smi": smi})

    t0 = time.perf_counter()
    sur_x, counts = counted(torch, lambda: lasana.train("crossbar", cfg))
    wall = time.perf_counter() - t0
    check_launches("train crossbar", counts, {
        "crossbar_target": T_TRAIN, "lif_chunk": 0, "lif_step": 0,
        "mlp_surrogate": (">=", 1)})
    add_counts(total, "train/crossbar", counts)
    line({"phase": "train", "circuit": "crossbar",
          "testbench": "the port's (seed 0)", "wall_s": wall,
          "seconds": sur_x.train_report["seconds"],
          "events": sur_x.train_report["events"],
          "selected": dict(sur_x.manifest.families),
          "val_mse": {p: {f: r["val_mse"] for f, r in d.items()}
                      for p, d in sur_x.fit_info.items()},
          "launches": counts, "nvidia_smi": smi})

    active, inputs, _ = generate_testbench("lif", TestbenchConfig(
        n_runs=cfg.n_runs, n_steps=cfg.n_steps, alpha=cfg.alpha,
        seed=cfg.seed), dev)
    share = float(active[:, 1:].float().mean())
    idle_zero = bool((inputs[~active] == 0).all())
    if abs(share - cfg.alpha) > TRAIN_ALPHA_TOL or not bool(
            active[:, 0].all()) or not idle_zero:
        fail(f"generate_testbench(lif): active share {share}, first step "
             f"{bool(active[:, 0].all())}, idle inputs zero {idle_zero}")
    testbench = {"active_share": share, "first_step_active": True,
                 "idle_inputs_zero": idle_zero}
    gbdt = gbdt_cpu_vs_card(torch, np, dev, ds, "M_O")
    workloads = trained_on_workloads(torch, np, dev, surs, sur_lif, sur_x,
                                     total)
    times = mlp_train_shapes(torch, np, dev, bank, ds, smi)
    res = {"phase": "train_checks", "testbench_lif_on_card": testbench,
           "gbdt_cpu_vs_card": gbdt, "workloads": workloads,
           "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi}
    if profile:
        # the same code on a fifth of the testbench: every family's fit
        # of every predictor, traced
        res["profile"] = profile_run(torch, lambda: lasana.train(
            "lif", lasana.TrainConfig(n_runs=cfg.n_runs // 5)))
        res["profile"]["cut"] = f"TrainConfig(n_runs={cfg.n_runs // 5})"
    line(res)
    return total, times


# --- phase 5: streaming --------------------------------------------------------

RECORD_FIELDS = ("outputs", "out_spikes", "energy", "latency", "events",
                 "flush_energy")


def stream_blocks(np, t_steps=STREAM_TICKS):
    """The host generator: block j is the 100 digits Poisson-encoded for
    250 ticks with seed 5 + j, in V_dd spikes."""
    from repro_torch.data.mnist import make_digits, poisson_encode
    imgs, _ = make_digits(N_IMAGES, size=28, seed=777)
    for j in range(-(-t_steps // STREAM_BLOCK)):
        blk = poisson_encode(imgs, STREAM_BLOCK, seed=5 + j) * 1.5
        yield blk[:t_steps - j * STREAM_BLOCK].astype(np.float32)


def same_record(np, got, want, name):
    """Every record field equal bit for bit, else fail."""
    for f in RECORD_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if (g is None) != (w is None) or (
                w is not None and not np.array_equal(g, w)):
            fail(f"{name}: {f} differs")


def scaled_surrogate(sur, factor):
    """A copy of ``sur`` with its MLP weight matrices scaled by
    ``factor``: a same-structure weight swap."""
    from repro_torch.core.surrogate import Surrogate
    params = {p: {k: a * factor if sur.manifest.family_of(p) == "mlp"
                  and k.startswith("w") else a for k, a in d.items()}
              for p, d in sur.params.items()}
    return Surrogate(sur.manifest, params, sur.fit_info)


def stream_runs(torch, np, dev, surs, profile):
    """The stream phase: the 784-128-10 SNN and its hidden layer alone
    through ``simulate_stream`` (each against its monolithic run, bit for
    bit; the hidden layer also against its JAX record), kill and resume,
    a per-chunk hot swap, and peak device memory."""
    import repro_torch.lasana as lasana
    from repro_torch.convert import graph_spec_from_numpy, spec_from_numpy
    from repro_torch.kernels import ops
    with np.load(ART / "snn_784_128_10.npz") as z:
        ws = [z["w0"], z["w1"]]
    knobs = np.array(LIF_KNOBS, np.float32)
    specs = {"snn_784_128_10": lambda: spec_from_numpy(ws, [knobs] * 2),
             "hidden_784_128": lambda: graph_spec_from_numpy(
                 [{"circuit": "lif", "weight": ws[0], "params": knobs}])}
    t0 = time.perf_counter()
    x_host = np.concatenate(list(stream_blocks(np)))
    host_s = time.perf_counter() - t0       # the generator alone, on the host
    rec = dict(np.load(ART / "stream_784_128_ref_record.npz"))
    chunks = -(-STREAM_TICKS // STREAM_CHUNK)
    runs = {
        ("snn_784_128_10", "golden"): (dict(backend="golden"),
                                       {"lif_step": 2 * STREAM_TICKS}),
        ("snn_784_128_10", "lasana"): (dict(surrogates=surs["lif"]),
                                       {"network_tick": 2 * STREAM_TICKS}),
        ("hidden_784_128", "golden"): (dict(backend="golden"),
                                       {"lif_chunk": chunks, "lif_step": 0}),
        ("hidden_784_128", "lasana"): (dict(surrogates=surs["lif"]),
                                       {"network_tick_chunk": chunks,
                                        "network_tick": 0}),
    }
    total, streamed, built = {}, {}, {}
    smi = nvidia_smi()
    for (wl, name), (kw, want) in runs.items():
        spec = specs[wl]()
        ekw = {k: v for k, v in kw.items() if k != "surrogates"}
        mono = lasana.simulate(spec, torch.as_tensor(x_host, device=dev),
                               record_hidden=False, **kw)
        eng = lasana.engine(spec, record_hidden=False, **ekw)
        ops.reset_launches()
        first = lasana.simulate_stream(spec, stream_blocks(np),
                                       chunk_ticks=STREAM_CHUNK, **kw)
        counts = dict(ops.LAUNCHES)
        check_launches(f"stream {wl} {name}", counts, want)
        # steady: the whole stream with host syncs forbidden but the
        # wait on each chunk's copy event
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            run = lasana.simulate_stream(spec, stream_blocks(np),
                                         chunk_ticks=STREAM_CHUNK, **kw)
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
        same_record(np, first, mono, f"stream {wl} {name} vs monolithic")
        same_record(np, run, mono, f"steady stream {wl} {name}")
        events = int(run.events.sum())
        res = {"phase": "stream", "workload": wl, "run": name,
               "ticks": STREAM_TICKS, "chunk_ticks": STREAM_CHUNK,
               "launches": counts, "wall_s": wall,
               "events_per_s": events / wall, "events": events,
               "runners_built": eng.compile_count,
               "host_stimulus_s": host_s,
               "equals_monolithic_bitwise": True,
               "sync_debug_mode": "error", "card": smi}
        if wl == "hidden_784_128":
            counts_port = (run.out_spikes > 0.75).sum(0)
            agree = float(np.mean(counts_port == rec[f"{name}/counts"]))
            e_port = float(run.energy.sum() + run.flush_energy.sum())
            e_ref = float(rec[f"{name}/energy"].sum()
                          + rec[f"{name}/flush_energy"].sum())
            e_diff = abs(e_port - e_ref) / max(abs(e_ref), 1e-30)
            res.update({"count_agreement_vs_ref": agree,
                        "events_equal_ref": bool(np.array_equal(
                            run.events[:, 0], rec[f"{name}/events"])),
                        "energy_j": e_port, "energy_rel_diff_vs_ref": e_diff})
            if agree < 0.99 or e_diff > 0.01 or not np.isfinite(
                    run.energy).all():
                fail(f"stream {wl} {name}: spike-count agreement {agree:.4f}"
                     f" (< 0.99) or energy difference {e_diff:.4%} (> 1%) "
                     "against the JAX record")
        if profile:
            res["profile"] = profile_run(
                torch, lambda: lasana.simulate_stream(
                    spec, stream_blocks(np), chunk_ticks=STREAM_CHUNK, **kw))
        line(res)
        add_counts(total, f"stream/{wl}/{name}", counts)
        streamed[(wl, name)], built[(wl, name)] = (spec, run), eng
    stream_checks(torch, np, dev, surs, specs, x_host, streamed, built)
    return total


def stream_checks(torch, np, dev, surs, specs, x_host, streamed, built):
    """Kill and resume, hot swap and bounded memory on the SNN's lasana
    stream."""
    import itertools
    import repro_torch.lasana as lasana
    from repro_torch.core.network import StreamingRun
    sur = surs["lif"]
    spec, full = streamed[("snn_784_128_10", "lasana")]
    eng = built[("snn_784_128_10", "lasana")]
    kw = dict(chunk_ticks=STREAM_CHUNK, surrogates=sur)

    # kill after chunk 2, save its checkpoint, resume on a fresh engine
    acc, ckpt = StreamingRun(), None
    gen = lasana.stream(spec, stream_blocks(np), checkpoint_every=2, **kw)
    for i, chunk in enumerate(gen):
        acc.update(chunk)
        if i == 1:
            ckpt = chunk.checkpoint
            break
    gen.close()
    if ckpt is None or ckpt.k0 != 2 * STREAM_CHUNK:
        fail("stream: chunk 2 carries no checkpoint at tick 1024")
    path = ROOT / "build" / "chip_smoke" / "snn_lasana_ckpt.npz"
    ckpt.save(str(path))
    fresh = specs["snn_784_128_10"]()
    resumed = lasana.resume(str(path), fresh, stream_blocks(np),
                            surrogates=sur)
    same_record(np, resumed, full, "resume on a fresh engine")
    warm = lasana.engine(fresh, record_hidden=False)
    builds = warm.compile_count
    again = lasana.resume(str(path), fresh, stream_blocks(np), surrogates=sur)
    same_record(np, again, full, "resume on a warm engine")
    if warm.compile_count != builds:
        fail(f"resume on a warm engine built "
             f"{warm.compile_count - builds} runners")

    # hot swap: the artifact and a 1e-3-scaled copy, chunk by chunk
    builds = eng.compile_count
    swapped = lasana.simulate_stream(
        spec, stream_blocks(np), chunk_ticks=STREAM_CHUNK,
        surrogates=itertools.cycle([sur, scaled_surrogate(sur, SWAP_SCALE)]))
    if eng.compile_count != builds:
        fail(f"hot swap built {eng.compile_count - builds} runners")
    e_full, e_swap = float(full.energy.sum()), float(swapped.energy.sum())
    if e_swap == e_full:
        fail("hot swap: energy equals the unswapped stream's")

    # bounded memory: peak device memory of the 2,000- and 1,024-tick
    # streams against the monolithic run (stimulus upload included)
    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    mem = {
        "monolithic_2000": peak(lambda: lasana.simulate(
            spec, x_host, surrogates=sur, record_hidden=False)),
        "stream_2000": peak(lambda: lasana.simulate_stream(
            spec, stream_blocks(np), **kw)),
        "stream_1024": peak(lambda: lasana.simulate_stream(
            spec, stream_blocks(np, 1024), **kw)),
    }
    if not (mem["stream_2000"] < mem["monolithic_2000"]
            and abs(mem["stream_2000"] - mem["stream_1024"])
            <= 0.05 * mem["stream_1024"]):
        fail(f"stream memory not bounded: {mem}")
    line({"phase": "stream_checks", "workload": "snn_784_128_10",
          "run": "lasana", "resume_equals_uninterrupted_bitwise": True,
          "resume_k0": ckpt.k0, "warm_resume_runners_built": 0,
          "hot_swap_runners_built": 0, "hot_swap_energy_j": e_swap,
          "unswapped_energy_j": e_full,
          "peak_device_bytes": mem, "card": nvidia_smi()})


# --- phase 6: the LM zoo's serve path ---------------------------------------

def row_errors(np, got, want):
    """Per-row relative L2 of (R, V) logits, and whether the argmax agrees
    on every row whose record top-2 gap exceeds LM_ARGMAX_GAP of its std."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    rel = np.linalg.norm(g - w, axis=-1) / np.linalg.norm(w, axis=-1)
    top2 = np.sort(w, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > LM_ARGMAX_GAP * w.std(axis=-1)
    same = np.argmax(g, -1) == np.argmax(w, -1)
    return rel, bool(np.all(same | ~decided)), int(decided.sum())


def lm_config():
    from repro_torch.configs import get_config
    return get_config(LM_ARCH)


def lm_runs(torch, np, dev, surs, profile):
    """StarCoder2-3B at full width and depth: the JAX record's prefill and
    8 teacher-forced decode steps (at the record's depth, the first layers
    of the same parity weights), the full-depth prefill, decode against
    forward, then ``repro_torch.launch.serve`` with ``Model.init``'s
    weights at batch 8 x 512 + 64."""
    import dataclasses
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import params as prm
    from repro_torch.models.layers import unembed
    from repro_torch.models.model import Model
    cfg = lm_config()
    rec = dict(np.load(ART / "starcoder2_3b_ref_record.npz"))
    n_rec = int(rec["n_layers"])
    t0 = time.perf_counter()
    params = lm_params_from_numpy(cfg, lm_numpy_params(cfg, 0), dev)
    t_weights = time.perf_counter() - t0
    total = {}
    tokens = torch.as_tensor(rec["tokens"], device=dev)
    fed = torch.as_tensor(rec["decode_tokens"], device=dev)
    b, s = tokens.shape
    max_seq = s + LM_DECODE_STEPS

    # the record's depth: layers 0 .. n_rec-1 of the same weights (views)
    cut = Model(dataclasses.replace(cfg, n_layers=n_rec))
    cut_params = {**params, "layers": prm.tree_map(lambda t: t[:n_rec],
                                                   params["layers"])}
    ops.reset_launches()
    logits, cache = cut.prefill(cut_params, {"tokens": tokens},
                                max_seq=max_seq)
    counts = dict(ops.LAUNCHES)
    check_launches("lm record prefill", counts, {"flash_attention": n_rec,
                                                  "flash_attention_simt": 0})
    add_counts(total, "lm/record_prefill", counts)
    rel, argmax_ok, decided = row_errors(np, logits[:, 0].cpu(),
                                         rec["prefill_logits"])
    errs = {"prefill": rel.tolist()}
    bad = [] if argmax_ok and rel.max() <= LM_REL_L2 else ["prefill"]
    n_rows = rec["decode_logits"].shape[1]
    for i in range(LM_DECODE_STEPS):
        logits, cache = cut.decode(cut_params, cache, fed[:, i:i + 1])
        rel, ok, _ = row_errors(np, logits[:n_rows, 0].cpu(),
                                rec["decode_logits"][i])
        errs[f"decode_{i}"] = rel.tolist()
        if not ok or rel.max() > LM_REL_L2:
            bad.append(f"decode_{i}")
    del cache
    line({"phase": "lm_record", "arch": cfg.name, "layers": n_rec,
          "width": cfg.d_model, "tokens": [b, s],
          "weights_host_s": t_weights, "rel_l2_by_row": errs,
          "argmax_decided_rows_prefill": decided, "limit": LM_REL_L2,
          "launches": counts})
    if bad:
        fail(f"lm record: {bad} beyond relative L2 {LM_REL_L2} or argmax "
             "differs on a decided row")

    # full depth, same weights: prefill, two decode steps, forward
    model = Model(cfg)
    ops.reset_launches()
    logits, cache = model.prefill(params, {"tokens": tokens},
                                  max_seq=s + 4)
    counts = dict(ops.LAUNCHES)
    check_launches("lm prefill", counts, {"flash_attention": cfg.n_layers,
                                          "flash_attention_simt": 0})
    add_counts(total, "lm/prefill", counts)
    finite = bool(logits.isfinite().all())
    for i in range(2):
        logits, cache = model.decode(params, cache, fed[:, i:i + 1])
    del cache
    ops.reset_launches()
    h, _ = model.forward(params, {"tokens": torch.cat([tokens, fed[:, :2]],
                                                      1)})
    counts = dict(ops.LAUNCHES)
    check_launches("lm forward", counts, {"flash_attention": cfg.n_layers,
                                          "flash_attention_simt": 0})
    add_counts(total, "lm/forward", counts)
    want = unembed(params["embed"], h[:, -1:], cfg)
    dec_fwd = float((logits - want).abs().max() / want.abs().max())
    line({"phase": "lm_full_depth", "arch": cfg.name,
          "layers": cfg.n_layers, "prefill_logits_finite": finite,
          "decode_vs_forward": dec_fwd, "limit": LM_DECODE_VS_FORWARD,
          "forward_tokens": s + 2})
    if not finite or not dec_fwd < LM_DECODE_VS_FORWARD:
        fail(f"lm full depth: finite {finite}, decode vs forward "
             f"{dec_fwd:.4f} (limit {LM_DECODE_VS_FORWARD})")
    del params, h, logits, want, model, cut, cut_params
    torch.cuda.empty_cache()

    # the serve entry point, Model.init's seeded weights
    args = serve.parser().parse_args(list(SERVE_ARGS))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = serve.serve(args)
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # every prefill launch on the tensor-core route
    check_launches("serve", counts, {"flash_attention": cfg.n_layers,
                                     "flash_attention_simt": 0})
    add_counts(total, "lm/serve", counts)
    out = {"phase": "lm_serve", "args": " ".join(SERVE_ARGS),
           "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
           "tokens_per_s": res["tokens_per_s"],
           "logits_finite": res["logits_finite"],
           "generated_shape": list(res["generated"].shape),
           "peak_device_bytes": peak, "launches": counts,
           "card": nvidia_smi()}
    if not res["logits_finite"]:
        fail("serve: non-finite logits")
    del res
    # a second generate on a fresh model: the steady numbers
    model, params, prompts, max_seq = serve.setup(args)
    gen = int(args.gen)
    steady = serve.generate(model, params, prompts, gen=gen, max_seq=max_seq)
    out["steady"] = {k: steady[k] for k in ("prefill_s", "decode_s",
                                            "tokens_per_s")}
    if profile:
        out["profile"] = profile_run(torch, lambda: serve.generate(
            model, params, prompts, gen=gen, max_seq=max_seq))
    line(out)
    del model, params
    torch.cuda.empty_cache()
    return total


# --- batch parallelism: the mesh phase ----------------------------------------

MESH_SHARDS = 2              # shards of the 2-shard mesh, both on the card
MESH_STREAM_CHUNK = 32       # ticks per chunk of the sharded stream
MESH_TICK_N = N_MAIN         # circuits of the sharded Algorithm-1 tick


def mesh_runs(torch, np, dev, surs, profile):
    """The 784-128-10 SNN's 100 digits through ``lasana.simulate`` on a
    one-shard mesh (equal to the unsharded run bit for bit) and on a
    2-shard mesh of this card (identical spikes, outputs and events,
    energy / latency / flush within rtol 1e-5, and the JAX record's
    limits), the sharded stream, and ``make_distributed_step`` at N =
    12,800 against ``lasana_step``."""
    import repro_torch.lasana as lasana
    from repro_torch.core.distributed import make_distributed_step
    from repro_torch.core.wrapper import LasanaState, lasana_step
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    spec, x, labels = snn_workload(torch, np, dev)
    rec = dict(np.load(ART / "snn_ref_record.npz"))
    kw = dict(surrogates=surs["lif"])
    base = lasana.simulate(spec, x, **kw)
    total = {}
    one = make_mesh((1,), ("data",))
    two = make_mesh((MESH_SHARDS,), ("data",), [dev] * MESH_SHARDS)
    ops.reset_launches()
    run1 = lasana.simulate(spec, x, mesh=one, **kw)
    counts1 = dict(ops.LAUNCHES)
    check_launches("mesh 1 shard", counts1, {"network_tick": 2 * T_STEPS})
    add_counts(total, "mesh/one_shard", counts1)
    same_record(np, run1, base, "mesh 1 shard")
    ops.reset_launches()
    t0 = time.perf_counter()
    run2 = lasana.simulate(spec, x, mesh=two, **kw)
    wall2 = time.perf_counter() - t0
    counts2 = dict(ops.LAUNCHES)
    check_launches("mesh 2 shards", counts2,
                   {"network_tick": MESH_SHARDS * 2 * T_STEPS})
    add_counts(total, "mesh/two_shards", counts2)
    rel = mesh_record_diff(np, run2, base, "mesh 2 shards")
    spikes = (run2.out_spikes > 0.75).astype(np.uint8)
    agree = float(np.mean(spikes == rec["lasana/out_spikes"]))
    e_port, e_diff = energy_diff(np, run2, rec, "lasana")
    if agree < 0.99 or e_diff > 0.01:
        fail(f"mesh 2 shards: spike agreement {agree:.4f} (< 0.99) or "
             f"energy difference {e_diff:.4%} (> 1%) against the reference")
    # the sharded stream, against the monolithic run
    ops.reset_launches()
    streamed = lasana.simulate_stream(spec, x, chunk_ticks=MESH_STREAM_CHUNK,
                                      mesh=two, record_hidden=True, **kw)
    counts3 = dict(ops.LAUNCHES)
    check_launches("mesh stream", counts3,
                   {"network_tick": MESH_SHARDS * 2 * T_STEPS})
    add_counts(total, "mesh/stream", counts3)
    rel_stream = mesh_record_diff(np, streamed, base, "mesh stream")
    # one Algorithm-1 tick on the mesh, against the local step
    v, o, t_last, params, changed, xin, _ = tick_inputs(
        torch, np, dev, MESH_TICK_N, 7, 1.5)
    state = LasanaState(v=v, o=o, t_last=t_last, params=params)
    step = make_distributed_step(two, clock_ns=5.0, spiking=True)
    t = torch.tensor([30.0], device=dev)
    ops.reset_launches()
    st_d, e_tot, n_out = step(surs["lif"], state, changed, xin, t)
    counts4 = dict(ops.LAUNCHES)
    check_launches("distributed step", counts4, {"network_tick": MESH_SHARDS})
    add_counts(total, "mesh/distributed_step", counts4)
    st_l, e_l, _, o_l = lasana_step(surs["lif"], state, changed, xin, t[0],
                                    5.0, spiking=True)
    v_err = float((st_d.v - st_l.v).abs().max())
    same_rest = all(torch.equal(getattr(st_d, f), getattr(st_l, f))
                    for f in ("o", "t_last", "params"))
    e_rel = abs(float(e_tot) - float(e_l.sum())) / abs(float(e_l.sum()))
    spikes_ok = int(n_out) == int((o_l > 0.75).sum())
    line({"phase": "mesh", "workload": "snn_784_128_10",
          "shards": MESH_SHARDS, "one_shard_bitwise": True,
          "two_shards_rel_energy_latency_flush": rel,
          "two_shards_wall_s": wall2,
          "accuracy": float(np.mean(np.argmax(run2.outputs, -1) == labels)),
          "spike_agreement_vs_ref": agree, "energy_j": e_port,
          "energy_rel_diff_vs_ref": e_diff,
          "stream_chunk": MESH_STREAM_CHUNK, "stream_rel": rel_stream,
          "distributed_step": {"n": MESH_TICK_N, "v_max_abs_err": v_err,
                               "o_t_last_params_equal": same_rest,
                               "energy_rel": e_rel,
                               "spikes": int(n_out),
                               "spikes_exact": spikes_ok},
          "launches": {"one_shard": counts1, "two_shards": counts2,
                       "stream": counts3, "distributed_step": counts4}})
    if not (same_rest and spikes_ok and e_rel <= RTOL
            and v_err <= 1e-5 * float(st_l.v.abs().max())):
        fail(f"distributed step: v err {v_err:.3e}, o/t_last/params equal "
             f"{same_rest}, energy rel {e_rel:.3e}, spikes exact {spikes_ok}")
    return total


def mesh_record_diff(np, got, want, name) -> dict:
    """Discrete fields identical, else fail; the continuous ones within
    rtol 1e-5 (atol 1e-6 of the field's scale). Returns each continuous
    field's largest relative difference."""
    for f in ("outputs", "out_spikes", "events"):
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            fail(f"{name}: {f} differs from the unsharded run")
    if want.layer_spikes is not None:
        for i, (g, w) in enumerate(zip(got.layer_spikes, want.layer_spikes)):
            if not np.array_equal(g, w):
                fail(f"{name}: layer {i} spikes differ")
    out = {}
    for f in ("energy", "latency", "flush_energy"):
        g = np.asarray(getattr(got, f), np.float64)
        w = np.asarray(getattr(want, f), np.float64)
        scale = float(np.max(np.abs(w), initial=0.0))
        err = np.abs(g - w)
        if (err > RTOL * np.abs(w) + 1e-6 * scale).any():
            fail(f"{name}: {f} beyond rtol {RTOL}")
        out[f] = float(np.max(err / np.maximum(np.abs(w), 1e-30),
                              initial=0.0))
    return out


# --- LM training: the JAX record, the launcher at full depth --------------------

LM_TRAIN_REL = 1e-4           # loss and grad_norm against the JAX record
LM_TRAIN_GRAD_REL = 1e-3      # each leaf's gradient norm at step 0
LM_TRAIN_UPDATE_REL = 1e-2    # each leaf's update norm after the 3 steps
LM_TRAIN_STEPS = 12           # steps of the full-depth launcher run
LM_TRAIN_TAIL = 5             # steps averaged at each end of the run
LM_RESUME_LAYERS = 4          # the crash-and-resume run's depth
LM_RESUME_REL = 1e-2          # resumed losses vs the uninterrupted run's
LM_PROFILE_STEPS = 2          # steady steps traced for the idle share
# beyond the launcher's defaults: the parity weights' distribution (from
# Model.init's the clipped updates sit below Adam's eps and a bf16 model
# does not move; ROADMAP caveat 4) and a 2-step warmup, with which the
# steps fall (the defaults' 20-step warmup moved the means by 0.03)
LM_TRAIN_ARGS = ("--init", "parity", "--warmup", "2")
# the record's AdamW (tests/test_torch_fixtures.py LM_TRAIN_OPT)
LM_TRAIN_OPT = dict(lr=1e-4, warmup_steps=2, total_steps=10)


def lm_train_record(torch, np, dev):
    """StarCoder2-3B at full width, cut to the record's 2 layers, fp32
    with TF32 off: the step-0 gradient of every leaf (its L2 norm, > 0)
    and 3 AdamW steps on the launcher's batches against the JAX record
    (``starcoder2_3b_train_ref_record.npz``, the reference's
    ``make_train_step``). A leaf whose norm is 0 or off — attention's
    ``wq`` / ``wk`` / ``wv`` through a kernel without a backward — fails."""
    import dataclasses
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    from repro_torch.data.lm_data import (SyntheticCorpus, make_train_batch,
                                          to_device)
    from repro_torch.kernels import ops
    from repro_torch.models import params as prm
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.train import step as step_mod
    rec = dict(np.load(ART / "starcoder2_3b_train_ref_record.npz"))
    n = int(rec["n_layers"])
    b, s = (int(v) for v in rec["batch"])
    steps = len(rec["loss"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(lm_config(), n_layers=n, dtype="float32")
    t0 = time.perf_counter()
    params = lm_params_from_numpy(cfg, lm_numpy_params(cfg, 0), dev)
    t_weights = time.perf_counter() - t0
    before = {p: t.clone() for p, t in prm.leaves(params)}
    model = Model(cfg)
    corpus = SyntheticCorpus(cfg.vocab, seed=0)
    batches = [make_train_batch(corpus, i, global_batch=b, seq=s)
               for i in range(steps)]
    ops.reset_launches()
    _, _, grads = step_mod.loss_and_grads(model, params,
                                          to_device(batches[0], dev))
    gnorm = {p: float(g.double().norm()) for p, g in prm.leaves(grads)}
    del grads
    opt = AdamW(AdamWConfig(**LM_TRAIN_OPT))
    train = step_mod.make_train_step(model, opt)
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "params": params, "opt": opt.init(params)}
    mets = []
    for batch in batches:
        state, m = train(state, batch)
        mets.append({k: float(v) for k, v in m.items()})
    counts = dict(ops.LAUNCHES)
    check_launches("lm train record", counts, {"flash_attention": 0,
                                               "flash_attention_simt": 0})
    upd = {p: float((t.double() - before[p].double()).norm())
           for p, t in prm.leaves(state["params"])}
    rel = lambda g, w: abs(g - w) / abs(w)
    errs = {k: [rel(m[k], float(w)) for m, w in zip(mets, rec[k])]
            for k in ("loss", "grad_norm", "lr")}
    grad_errs = {p: rel(v, float(rec[f"grad_norm/{p}"]))
                 for p, v in gnorm.items()}
    upd_errs = {p: rel(v, float(rec[f"update_norm/{p}"]))
                for p, v in upd.items()}
    zero = sorted(p for p, v in gnorm.items() if not v > 0)
    line({"phase": "lm_train_record", "arch": cfg.name, "layers": n,
          "width": cfg.d_model, "dtype": "float32", "tf32": False,
          "batch": [b, s], "steps": steps, "weights_host_s": t_weights,
          "loss": [m["loss"] for m in mets], "rel": errs,
          "grad_norm_rel_max": max(grad_errs.values()),
          "update_norm_rel_max": max(upd_errs.values()),
          "zero_grad_leaves": zero, "leaves": len(gnorm),
          "limits": {"loss_grad_norm": LM_TRAIN_REL,
                     "leaf_grad_norm": LM_TRAIN_GRAD_REL,
                     "leaf_update_norm": LM_TRAIN_UPDATE_REL},
          "launches": counts})
    bad = [k for k in ("loss", "grad_norm", "lr")
           if max(errs[k]) > LM_TRAIN_REL]
    bad += [p for p, e in grad_errs.items() if e > LM_TRAIN_GRAD_REL]
    bad += [f"update {p}" for p, e in upd_errs.items()
            if e > LM_TRAIN_UPDATE_REL]
    if zero or bad:
        fail(f"lm train record: zero-gradient leaves {zero}, beyond the "
             f"limits {bad}")
    del params, state, before, model, train, opt
    torch.cuda.empty_cache()


def train_args(ckpt_dir, *extra):
    from repro_torch.launch import train as launcher
    return launcher.parse_args(["--arch", LM_ARCH, "--ckpt-dir",
                                str(ckpt_dir), "--log-every", "1",
                                *extra])


def ckpt_root(torch, np, need_bytes):
    """The directory with the most free disk of the temporary directory
    and the checkout's ``build/``; fails with the numbers where even that
    holds less than ``need_bytes``."""
    import shutil
    import tempfile
    cands = [pathlib.Path(tempfile.gettempdir()), ROOT / "build"]
    (ROOT / "build").mkdir(exist_ok=True)
    free = {str(c): shutil.disk_usage(c).free for c in cands}
    best = max(cands, key=lambda c: free[str(c)])
    line({"phase": "lm_train_disk", "free_bytes": free,
          "need_bytes": need_bytes, "chosen": str(best)})
    if free[str(best)] < need_bytes:
        fail(f"lm train: {free[str(best)]} bytes free at {best}, the final "
             f"checkpoint needs {need_bytes}")
    return pathlib.Path(tempfile.mkdtemp(prefix="lm_train_", dir=best))


def lm_train_runs(torch, np, dev, surs, profile):
    """The training record, then ``repro_torch.launch.train`` at full
    depth and the crash and resume at 4 layers, in a temporary directory
    on the disk with the most room (removed after)."""
    import shutil
    from repro_torch.models import params as prm
    from repro_torch.models.model import Model
    lm_train_record(torch, np, dev)
    n_params = prm.param_count(Model(lm_config()).param_specs())
    # the final checkpoint: bf16 params, fp32 m and v, and some room
    root = ckpt_root(torch, np, int(n_params * (2 + 4 + 4) * 1.05))
    try:
        lm_train_full(torch, np, dev, root / "full")
        lm_train_resume(torch, np, dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return {}


def lm_train_full(torch, np, dev, ckpt_dir):
    """``repro_torch.launch.train``'s ``train()`` on StarCoder2-3B at full
    width and depth, bf16, batch 8 x 128 (the launcher's defaults, with
    ``LM_TRAIN_ARGS``' weights and warmup), ``LM_TRAIN_STEPS`` steps into
    ``ckpt_dir``
    (the final save ~30 GB): finite losses falling, steady step seconds, tokens/s,
    peak device bytes, the idle share of two traced steady steps, no
    ``flash_attention`` launch."""
    import shutil
    from repro_torch.data.lm_data import (SyntheticCorpus, make_train_batch,
                                          to_device)
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    from repro_torch.models import params as prm
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.train import step as step_mod
    cfg = lm_config()
    args = train_args(ckpt_dir, "--steps", str(LM_TRAIN_STEPS),
                      "--ckpt-every", str(10 * LM_TRAIN_STEPS),
                      *LM_TRAIN_ARGS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = launcher.train(args)
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses, secs = out["losses"], out["step_seconds"]
    steady = statistics.median(secs[2:])
    tokens = args.batch * args.seq
    saved = sum(f.stat().st_size for f in pathlib.Path(ckpt_dir).rglob("*")
                if f.is_file())
    head = float(np.mean(losses[:LM_TRAIN_TAIL]))
    tail = float(np.mean(losses[-LM_TRAIN_TAIL:]))
    res = {"phase": "lm_train", "arch": cfg.name, "layers": cfg.n_layers,
           "params": prm.param_count(Model(cfg).param_specs()),
           "dtype": args.dtype, "batch": [args.batch, args.seq],
           "lr": args.lr, "warmup": args.warmup,
           "steps": LM_TRAIN_STEPS, "losses": losses,
           "first_mean": head, "last_mean": tail,
           "first_step_s": secs[0], "steady_step_s": steady,
           "tokens_per_s": tokens / steady, "peak_device_bytes": peak,
           "wall_s": wall, "steps_s": sum(secs), "checkpoint_bytes": saved,
           "launches": counts, "card": nvidia_smi()}
    check_launches("lm train", counts, {"flash_attention": 0,
                                        "flash_attention_simt": 0})
    # two more steady steps of the trained state, traced
    opt = AdamW(AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                            total_steps=args.steps))
    step = step_mod.make_train_step(Model(cfg), opt)
    corpus = SyntheticCorpus(cfg.vocab, seed=args.seed)
    state = out.pop("state")
    batches = [to_device(make_train_batch(
        corpus, LM_TRAIN_STEPS + i, global_batch=args.batch, seq=args.seq),
        dev) for i in range(LM_PROFILE_STEPS)]

    def steps():
        nonlocal state
        for bt in batches:
            state, _ = step(state, bt)
    res["profile"] = profile_run(torch, steps)
    del state, out, step, batches
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    line(res)
    if not (np.isfinite(losses).all() and tail < head):
        fail(f"lm train: losses finite {np.isfinite(losses).all()}, last "
             f"{LM_TRAIN_TAIL} mean {tail:.4f} not below the first "
             f"{LM_TRAIN_TAIL}' {head:.4f}")


def lm_train_resume(torch, np, dev, root):
    """At full width and 4 layers: an uninterrupted 10-step run, then a
    run that crashes at step 6 (``--fail-at-step``) after its step-4
    checkpoint and a rerun that resumes from it; the resumed steps 4-9
    against the uninterrupted run's losses."""
    import contextlib
    import io
    from repro_torch.launch import train as launcher
    common = ("--layers", str(LM_RESUME_LAYERS), "--steps", "10",
              *LM_TRAIN_ARGS)
    ref = launcher.train(train_args(root / "ref", *common,
                                    "--ckpt-every", "100"))
    ref.pop("state")
    argv = ["--arch", LM_ARCH, "--ckpt-dir", str(root / "run"),
            "--log-every", "1", *common, "--ckpt-every", "4"]
    crashed = False
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            launcher.main(argv + ["--fail-at-step", "6"])
        except RuntimeError as e:
            crashed = "injected failure (test)" in str(e)
        launcher.main(argv)
    text = buf.getvalue()
    resumed = [float(ln.split()[4]) for ln in text.splitlines()
               if ln.startswith("[train] step ")][-6:]
    rel = [abs(a - b) / abs(b) for a, b in zip(resumed, ref["losses"][4:])]
    ok = (crashed and "resumed from step 4" in text and "done" in text
          and len(rel) == 6 and max(rel) <= LM_RESUME_REL)
    line({"phase": "lm_train_resume", "layers": LM_RESUME_LAYERS,
          "crashed_at_6": crashed,
          "resumed_from_4": "resumed from step 4" in text,
          "resumed_losses": resumed,
          "uninterrupted_losses": ref["losses"][4:], "rel": rel,
          "limit": LM_RESUME_REL})
    if not ok:
        fail(f"lm train resume: crashed {crashed}, output {text[-400:]!r}, "
             f"rel {rel}")


# --- tensor parallelism: the tp phase ----------------------------------------

TP_LOGIT_LIMIT = 5e-2      # of max |logit|: tests/test_kvseq.py's limit
TP_FP32_LIMIT = 1e-5       # fp32 runs: logits, loss, grad / update norms
TP_LAYERS = 4              # depth of the (1, 4), kv_seq and fp32 runs
TP_DECODE_STEPS = 8        # teacher-forced steps of the 4-layer runs
TP_TRAIN_BATCH = (8, 128)  # the fp32 train step's batch, sequence


def tp_forced(torch, model, params, prompts, steps, max_seq, fed=None):
    """A prefill and ``steps`` decode steps, fed ``fed`` (teacher
    forcing) or the greedy tokens: (each step's logits (B, V) fp32 on the
    host, the fed tokens, the prefill's launch counts, seconds)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        ops.reset_launches()
        logits, cache = model.prefill(params, {"tokens": prompts},
                                      max_seq=max_seq)
        counts = dict(ops.LAUNCHES)
        outs, toks = [logits[:, -1].float().cpu()], []
        for i in range(steps):
            tok = fed[:, i:i + 1] if fed is not None else torch.argmax(
                logits[:, -1:], -1).to(torch.int32)
            toks.append(tok)
            logits, cache = model.decode(params, cache, tok)
            outs.append(logits[:, -1].float().cpu())
    del cache
    torch.cuda.synchronize()
    return outs, torch.cat(toks, 1), counts, time.perf_counter() - t0


def tp_setup(torch, argv):
    """``launch.serve.setup`` for ``argv``, the weights redrawn from the
    parity distribution (``convert.lm_parity_specs``, seed 0, placed on the
    model's mesh). ``Model.init``'s distribution (std 1/sqrt(heads) on the
    attention weights, ROADMAP caveat 4) makes the bf16 model chaotic: a
    reordered sum moves its logits by tens of percent within a few
    layers, which no comparison of two bf16 runs could see past."""
    from repro_torch.convert import lm_parity_specs
    from repro_torch.launch import serve
    from repro_torch.models import params as prm
    model, params, prompts, max_seq = serve.setup(
        serve.parser().parse_args(argv))
    dev = prompts.device
    del params
    params = prm.materialize(
        torch.Generator(device=dev).manual_seed(0),
        lm_parity_specs(model.cfg), dev,
        placements=model.param_placements() if model.mesh else None)
    return model, params, prompts, max_seq


def tp_compare(torch, got, want, limit, every_step=False) -> dict:
    """Each step's max |diff| / max |logit| — the prefill's (or with
    ``every_step`` every step's) held to ``limit`` — and the greedy
    tokens: equal on every row whose top-2 gap in the unsharded run
    exceeds twice that row's max |diff|."""
    rel, decided, agree, bad = [], 0, 0, []
    for i, (g, w) in enumerate(zip(got, want)):
        diff = (g - w).abs().max(dim=-1).values
        rel.append(float(diff.max() / w.abs().max()))
        top2 = torch.topk(w, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * diff
        same = torch.argmax(g, -1) == torch.argmax(w, -1)
        decided += int(sure.sum())
        agree += int((same & sure).sum())
        if bool((sure & ~same).any()) or (rel[-1] > limit
                                           and (every_step or i == 0)):
            bad.append(i)
    return {"max_rel_by_step": rel, "limit": limit, "decided_rows": decided,
            "decided_rows_equal": agree, "failed_steps": bad}


TP_ALLOC_SLACK = 2 << 20   # the caching allocator's rounding, per tensor


def tp_reckon_bytes(model) -> list:
    """Each mesh entry's parameter bytes from the specs alone: a leaf's
    whole bytes divided by the product of the mesh axes its resolved spec
    (``ShardingRules.spec_for_shape``) names."""
    import math
    from repro_torch import tree as tr
    mesh, per = model.mesh, 0
    for s in tr.leaves(model.param_specs()):
        spec = model.rules.spec_for_shape(mesh, s.logical, s.shape)
        cut = math.prod(mesh.shape[a] for e in spec if e is not None
                        for a in ((e,) if isinstance(e, str) else e))
        nbytes = math.prod(s.shape) * s.dtype.itemsize
        if nbytes % cut:
            fail(f"tp: a leaf of {nbytes} bytes does not split {cut} ways")
        per += nbytes // cut
    return [per] * mesh.size


def tp_serve(torch, np, dev, total):
    """(a), (e), (f): StarCoder2-3B at full width and depth through
    ``launch.serve`` with the lm_serve phase's arguments, unsharded and on
    a (1, 2) mesh of the card; the sharded run fed the unsharded run's
    greedy tokens."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import params as prm
    from repro_torch import tree as tr
    cfg = lm_config()
    gen = int(serve.parser().parse_args(list(SERVE_ARGS)).gen)
    model, params, prompts, max_seq = tp_setup(torch, list(SERVE_ARGS))
    want, fed, _, t_plain = tp_forced(torch, model, params, prompts,
                                      gen - 1, max_seq)
    del model, params
    torch.cuda.empty_cache()
    tp_argv = list(SERVE_ARGS) + ["--model-parallel", "2"]
    model, params, prompts, max_seq = tp_setup(torch, tp_argv)
    got, _, counts, t_tp = tp_forced(torch, model, params, prompts, gen - 1,
                                     max_seq, fed=fed)
    # (f) the flash kernel once per shard per layer of the prefill
    check_launches("tp prefill (1, 2)", counts, {
        "flash_attention": 2 * cfg.n_layers, "flash_attention_simt": 0})
    add_counts(total, "tp/prefill_1x2", counts)
    res = tp_compare(torch, got, want, TP_LOGIT_LIMIT)
    # (e) each entry's parameter bytes against a reckoning from the specs'
    # shapes and resolved specs alone (a leaf's bytes over the mesh
    # entries its spec cuts it into), and the card's allocated bytes
    # that the placed parameters free
    held = [sum(x.shards[i].numel() * x.shards[i].element_size()
                for x in tr.leaves(params)) for i in range(model.mesh.size)]
    reckoned = tp_reckon_bytes(model)
    whole = prm.param_bytes(model.param_specs())
    wq = params["layers"]["attn"]["wq"].placement
    wk = params["layers"]["attn"]["wk"].placement
    n_tensors = sum(len(x.shards) for x in tr.leaves(params))
    before = torch.cuda.memory_allocated()
    del params
    freed = before - torch.cuda.memory_allocated()
    del model
    torch.cuda.empty_cache()
    # the entry point itself, on the mesh (Model.init's weights): its
    # numbers and launches
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    run = serve.serve(serve.parser().parse_args(tp_argv))
    counts = dict(ops.LAUNCHES)
    check_launches("tp serve (1, 2)", counts, {
        "flash_attention": 2 * cfg.n_layers, "flash_attention_simt": 0})
    add_counts(total, "tp/serve_1x2", counts)
    line({"phase": "tp_serve", "arch": cfg.name, "layers": cfg.n_layers,
          "mesh": "(1, 2) of one card", "args": " ".join(tp_argv),
          "forced_runs_weights": "parity distribution, seed 0",
          "prefill_logits_max_rel": res["max_rel_by_step"][0],
          "decode_max_rel": max(res["max_rel_by_step"][1:]), **res,
          "forced_run_s": {"unsharded": t_plain, "sharded": t_tp},
          "serve": {k: run[k] for k in ("prefill_s", "decode_s",
                                        "tokens_per_s", "logits_finite")},
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "param_bytes_per_entry": held,
          "param_bytes_reckoned": reckoned, "param_bytes_whole": whole,
          "param_bytes_freed": freed,
          "wq_spec": list(map(str, wq.spec)),
          "wk_spec": list(map(str, wk.spec)),
          "launches": counts, "card": nvidia_smi()})
    if held != reckoned:
        fail(f"tp: entries hold {held} parameter bytes, the specs reckon "
             f"{reckoned}")
    if not sum(held) <= freed <= sum(held) + n_tensors * TP_ALLOC_SLACK:
        fail(f"tp: the placed parameters freed {freed} bytes of the card, "
             f"their {n_tensors} tensors hold {sum(held)}")
    if res["failed_steps"] or not run["logits_finite"]:
        fail(f"tp (1, 2): steps {res['failed_steps']}: the prefill beyond "
             f"{TP_LOGIT_LIMIT} or a decided token differs")
    del run
    torch.cuda.empty_cache()


def tp_cut(torch, np, dev, total):
    """(b): the first TP_LAYERS layers on (1, 4), where StarCoder2's two
    kv heads do not divide the axis and stay whole (each shard attends
    with the one its six query heads use, G = 6), and with ``--kv-seq`` on
    (1, 2)."""
    base = list(SERVE_ARGS) + ["--layers", str(TP_LAYERS)]
    model, params, prompts, max_seq = tp_setup(torch, base)
    want, fed, _, _ = tp_forced(torch, model, params, prompts,
                                TP_DECODE_STEPS, max_seq)
    del model, params
    out = {}
    for name, extra, flash in (
            ("1x4", ["--model-parallel", "4"], 4 * TP_LAYERS),
            ("kvseq_1x2", ["--model-parallel", "2", "--kv-seq"],
             2 * TP_LAYERS)):
        model, params, prompts, max_seq = tp_setup(torch, base + extra)
        got, _, counts, secs = tp_forced(torch, model, params, prompts,
                                         TP_DECODE_STEPS, max_seq, fed=fed)
        check_launches(f"tp prefill {name}", counts, {
            "flash_attention": flash, "flash_attention_simt": 0})
        add_counts(total, f"tp/prefill_{name}", counts)
        res = tp_compare(torch, got, want, TP_LOGIT_LIMIT)
        wk = params["layers"]["attn"]["wk"].placement
        out[name] = {**res, "seconds": secs, "launches": counts,
                     "wk_spec": list(map(str, wk.spec))}
        if name == "1x4" and wk.splits("model"):
            fail("tp (1, 4): two kv heads split over four shards")
        del model, params
        torch.cuda.empty_cache()
    line({"phase": "tp_cut", "layers": TP_LAYERS, **out,
          "card": nvidia_smi()})
    bad = {k: v["failed_steps"] for k, v in out.items() if v["failed_steps"]}
    if bad:
        fail(f"tp cut runs: {bad}")


def tp_fp32(torch, np, dev, total):
    """(c) and (d): fp32 with TF32 off at TP_LAYERS layers — the serve
    path on (1, 2) against the unsharded model, and one AdamW step on a
    (2, 2) mesh of the card against the unsharded step."""
    import dataclasses
    from repro_torch import sharding as shd
    from repro_torch import tree as tr
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.convert import lm_parity_specs
    from repro_torch.data.lm_data import (SyntheticCorpus, make_train_batch,
                                          to_device)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import params as prm
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.train import step as step_mod
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = dataclasses.replace(lm_config(), n_layers=TP_LAYERS,
                                  mtp_depth=0, dtype="float32")
        b, s = 8, 512
        corpus = SyntheticCorpus(cfg.vocab, seed=0)
        prompts = torch.as_tensor(corpus.batch(0, b, s), device=dev)
        model = Model(cfg)
        params = prm.materialize(torch.Generator(device=dev).manual_seed(0),
                                 lm_parity_specs(cfg), dev)
        want, fed, _, _ = tp_forced(torch, model, params, prompts,
                                    TP_DECODE_STEPS, s + TP_DECODE_STEPS + 1)
        mesh = make_mesh((1, 2), ("data", "model"), [dev] * 2)
        tp = Model(cfg, mesh=mesh, rules=shd.serve_rules(mesh))
        placed = shd.place_tree(params, tp.param_placements())
        del params
        got, _, counts, _ = tp_forced(torch, tp, placed, prompts,
                                      TP_DECODE_STEPS,
                                      s + TP_DECODE_STEPS + 1, fed=fed)
        add_counts(total, "tp/fp32_prefill_1x2", counts)
        serve_res = tp_compare(torch, got, want, TP_FP32_LIMIT,
                               every_step=True)
        del placed, tp
        torch.cuda.empty_cache()
        # (d) one train step, (2, 2)
        params = prm.materialize(torch.Generator(device=dev).manual_seed(0),
                                 lm_parity_specs(cfg), dev)
        opt = AdamW(AdamWConfig(**LM_TRAIN_OPT))
        batch = to_device(make_train_batch(
            corpus, 0, global_batch=TP_TRAIN_BATCH[0],
            seq=TP_TRAIN_BATCH[1]), dev)
        state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
                 "params": tr.tree_map(torch.clone, params),
                 "opt": opt.init(params)}
        mesh = make_mesh((2, 2), ("data", "model"), [dev] * 4)
        rules = shd.train_rules(mesh)
        placed = shd.place_tree(
            state, step_mod.train_state_shardings(model, opt, mesh, rules))
        step = step_mod.jit_train_step(
            model, opt, mesh, rules,
            ShapeConfig("tp", TP_TRAIN_BATCH[1], TP_TRAIN_BATCH[0],
                        "train"))
        # every leaf's gradient first (Adam's first step is nearly sign(g),
        # so the update alone would not show a gradient's scale)
        _, _, g_plain = step_mod.loss_and_grads(model, state["params"], batch)
        _, _, g_tp = step_mod.placed_loss_and_grads(
            step_mod.on_mesh(model, mesh, rules), placed["params"], batch)
        grad_rel = max(float((a.double() - b.double()).norm()
                             / b.double().norm())
                       for a, b in zip(tr.leaves(shd.gather_tree(g_tp)),
                                       tr.leaves(g_plain)))
        del g_tp
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step_mod.make_train_step(model, opt)(state, batch)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        t0 = time.perf_counter()
        placed, met_tp = step(placed, batch)
        torch.cuda.synchronize()
        t_tp = time.perf_counter() - t0
        whole = shd.gather_tree(placed["params"])
        lr = float(met["lr"])
        # the updated values as the CPU tests hold them: Adam's first step
        # moves an element by ~lr * g / (|g| + eps), so an element whose
        # gradient sits at rounding level (below 1e-4 of its leaf's
        # largest) may step anywhere within 2 lr; the rest stay within
        # the limit of the leaf's largest value
        leaf_rel, elem_rel, live_rel, step_max = 0.0, 0.0, 0.0, 0.0
        upd_tp, upd = 0.0, 0.0
        for g, w, p0, gr in zip(tr.leaves(whole), tr.leaves(state["params"]),
                                tr.leaves(params), tr.leaves(g_plain)):
            d = (g.double() - w.double())
            leaf_rel = max(leaf_rel, float(d.norm() / w.double().norm()))
            elem_rel = max(elem_rel, float(d.abs().max() / w.abs().max()))
            live = d.abs()[gr.abs() > 1e-4 * gr.abs().max()]
            if live.numel():
                live_rel = max(live_rel, float(live.max() / w.abs().max()))
            step_max = max(step_max, float(d.abs().max()))
            upd_tp += float(torch.sum(torch.square(g.double() - p0.double())))
            upd += float(torch.sum(torch.square(w.double() - p0.double())))
        # Adam's moments (the update's inputs), each leaf by relative L2
        moment_rel = 0.0
        for key in ("m", "v"):
            for g, w in zip(tr.leaves(shd.gather_tree(placed["opt"][key])),
                            tr.leaves(state["opt"][key])):
                moment_rel = max(moment_rel, float(
                    (g.double() - w.double()).norm() / w.double().norm()))
        del g_plain
        train = {
            "loss": float(met_tp["loss"]),
            "loss_unsharded": float(met["loss"]),
            "grad_norm": float(met_tp["grad_norm"]),
            "grad_norm_unsharded": float(met["grad_norm"]),
            "update_norm": upd_tp ** 0.5, "update_norm_unsharded": upd ** 0.5,
            "grad_leaf_max_rel_l2": grad_rel,
            "leaf_max_rel_l2": leaf_rel, "element_max_rel": elem_rel,
            "live_element_max_rel": live_rel,
            "moment_leaf_max_rel_l2": moment_rel,
            "element_max_abs": step_max, "lr": lr,
            "first_call_seconds": {"unsharded": t_plain, "sharded": t_tp}}
        rels = {"loss": abs(train["loss"] / train["loss_unsharded"] - 1),
                "grad_norm": abs(train["grad_norm"]
                                 / train["grad_norm_unsharded"] - 1),
                "update_norm": abs(train["update_norm"]
                                   / train["update_norm_unsharded"] - 1),
                "leaf": leaf_rel, "grad_leaf": grad_rel,
                "live_element": live_rel, "moment_leaf": moment_rel}
        train["rel"] = rels
        del placed, state, params, whole
        torch.cuda.empty_cache()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    line({"phase": "tp_fp32", "layers": TP_LAYERS, "tf32": False,
          "serve_1x2": {**serve_res, "launches": counts},
          "train_2x2": train, "limit": TP_FP32_LIMIT, "card": nvidia_smi()})
    if serve_res["failed_steps"] or max(rels.values()) > TP_FP32_LIMIT \
            or step_max > 2 * lr:
        fail(f"tp fp32: serve steps {serve_res['failed_steps']}, train "
             f"{rels} (limit {TP_FP32_LIMIT}), an element "
             f"{step_max:.3g} off (limit 2 lr = {2 * lr:.3g})")


def tp_runs(torch, np, dev, surs, profile):
    """The tp phase: tensor-parallel placement on (1, 2), (1, 4) and
    (2, 2) meshes of the one card, each against the port's own unsharded
    run."""
    total = {}
    t0 = time.perf_counter()
    tp_serve(torch, np, dev, total)
    tp_cut(torch, np, dev, total)
    tp_fp32(torch, np, dev, total)
    line({"phase": "tp_done", "seconds": time.perf_counter() - t0})
    return total


# --- phase 6, continued: the rest of the LM zoo ------------------------------

def zoo_record_config(cfg, depth: int):
    """A zoo record's cut of a full config (tests/test_torch_fixtures.py
    ``zoo_record_config``): its first ``depth`` layers, no MTP head, and no
    MoE stack when the dense layers fill the depth."""
    import dataclasses
    kw = {"n_layers": depth, "mtp_depth": 0}
    if cfg.moe is not None and cfg.moe.first_dense >= depth:
        kw["moe"] = None
    return dataclasses.replace(cfg, **kw)


def zoo_inputs(torch, np, cfg, batch: int, seed: int, dev) -> dict:
    """A prefill's frames / patches, drawn as tests/test_torch_fixtures.py
    ``zoo_inputs`` draws them (numpy ``seed``), in bf16 on ``dev``."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.encdec is not None:
        out["frames"] = rng.standard_normal(
            (batch, cfg.encdec.encoder_seq, cfg.d_model), np.float32)
    if cfg.n_frontend_tokens:
        out["patches"] = np.float32(0.02) * rng.standard_normal(
            (batch, cfg.n_frontend_tokens, cfg.d_model), np.float32)
    return {k: torch.as_tensor(v, device=dev).to(torch.bfloat16)
            for k, v in out.items()}


def zoo_row_errors(np, got, rec, name, step=None):
    """A zoo record's rows: per-row relative L2 over the record's columns,
    and whether the full row's argmax agrees where the record's top-2 gap
    exceeds LM_ARGMAX_GAP of its std."""
    cols = rec["columns"]
    g = np.asarray(got, np.float64)
    pick = (lambda a: a) if step is None else (lambda a: a[step])
    w = pick(rec[f"{name}_logits"]).astype(np.float64)
    rel = np.linalg.norm(g[:, cols] - w, axis=-1) / np.linalg.norm(w, axis=-1)
    decided = pick(rec[f"{name}_gap"]) > LM_ARGMAX_GAP * pick(
        rec[f"{name}_std"])
    same = np.argmax(g, -1) == pick(rec[f"{name}_argmax"])
    return rel, bool(np.all(same | ~decided)), int(decided.sum())


def flash_layers(arch, cfg) -> int:
    return cfg.n_layers if arch in ZOO_FLASH else 0


def ample_cf(cfg) -> str:
    """A capacity factor that gives every expert room for every token."""
    return repr(cfg.moe.n_experts / cfg.moe.top_k)


def zoo_record(torch, np, dev, arch, total):
    """(a): the JAX record at its depth with the parity weights, prefill
    and 8 teacher-forced decode steps at the config's capacity factor."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    rec_path = ART / (arch.replace("-", "_").replace(".", "") +
                      "_ref_record.npz")
    rec = dict(np.load(rec_path))
    cut = zoo_record_config(get_config(arch), int(rec["n_layers"]))
    t0 = time.perf_counter()
    params = lm_params_from_numpy(cut, lm_numpy_params(cut, 0), dev)
    t_weights = time.perf_counter() - t0
    model = Model(cut)
    tokens = torch.as_tensor(rec["tokens"], device=dev)
    fed = torch.as_tensor(rec["decode_tokens"], device=dev)
    b, s = tokens.shape
    extra = zoo_inputs(torch, np, cut, b, int(rec["input_seed"]), dev)
    ops.reset_launches()
    logits, cache = model.prefill(params, {"tokens": tokens, **extra},
                                  max_seq=s + LM_DECODE_STEPS)
    counts = dict(ops.LAUNCHES)
    check_launches(f"{arch} record prefill", counts, {
        "flash_attention": flash_layers(arch, cut),
        "flash_attention_simt": 0})
    add_counts(total, f"zoo/{arch}/record_prefill", counts)
    rel, ok, decided = zoo_row_errors(np, logits[:, 0].float().cpu(), rec,
                                      "prefill")
    errs = {"prefill": rel.tolist()}
    bad = [] if ok and rel.max() <= LM_REL_L2 else ["prefill"]
    for i in range(LM_DECODE_STEPS):
        logits, cache = model.decode(params, cache, fed[:, i:i + 1])
        rel, ok, _ = zoo_row_errors(np, logits[:, 0].float().cpu(), rec,
                                    "decode", i)
        errs[f"decode_{i}"] = rel.tolist()
        if not ok or rel.max() > LM_REL_L2:
            bad.append(f"decode_{i}")
    line({"phase": "zoo_record", "arch": arch, "layers": cut.n_layers,
          "width": cut.d_model, "tokens": [b, s], "inputs": sorted(extra),
          "columns": int(rec["columns"].size), "vocab": cut.vocab,
          "weights_host_s": t_weights, "rel_l2_by_row": errs,
          "max_rel_l2": max(max(v) for v in errs.values()),
          "argmax_decided_rows_prefill": decided, "limit": LM_REL_L2,
          "launches": counts})
    if bad:
        fail(f"{arch} record: {bad} beyond relative L2 {LM_REL_L2} or "
             "argmax differs on a decided row")
    del params, cache, logits, model
    torch.cuda.empty_cache()


def zoo_decode_vs_forward(torch, np, dev, arch, model, params, total):
    """(b): a prefill of B x P tokens and two decode steps against the
    forward over all P + 2. The MoE configs run it at a capacity that holds
    the whole batch (no assignment dropped, counted) twice: with their own
    routers (reported, not held: the two runs route apart) and with the
    routers zeroed (held; restored after)."""
    from repro_torch.data.lm_data import SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models import params as prm
    from repro_torch.models.layers import unembed
    cfg = model.cfg
    p = ZOO_SERVE_PROMPT.get(arch, ZOO_SERVE_PROMPT_LEN)
    b = ZOO_DVF_BATCH.get(arch, ZOO_SERVE_BATCH)
    toks = torch.as_tensor(SyntheticCorpus(cfg.vocab, seed=1).batch(
        0, b, p + 2), device=dev)
    extra = zoo_inputs(torch, np, cfg, b, 2, dev)
    drops = []

    def gap():
        _, cache = model.prefill(params, {"tokens": toks[:, :p], **extra},
                                 max_seq=p + 4)
        for i in range(2):
            logits, cache = model.decode(params, cache,
                                         toks[:, p + i:p + i + 1])
        del cache
        ops.reset_launches()
        h, _ = model.forward(params, {"tokens": toks, **extra})
        counts = dict(ops.LAUNCHES)
        want = unembed(params["embed"], h[:, -1:], cfg)
        finite = bool(logits.isfinite().all() and want.isfinite().all())
        return float((logits - want).abs().max() / want.abs().max()), \
            finite, counts

    def counted_dispatch(ids, n_experts, cap):
        dest, ok = real_dispatch(ids, n_experts, cap)
        drops.append(int((~ok).sum()))
        return dest, ok
    own = None
    if cfg.moe is None:
        dec_fwd, finite, counts = gap()
    else:
        real_dispatch = moe._dispatch_indices
        routers = [t for path, t in prm.leaves(params)
                   if path.endswith("/router")]
        saved = [t.clone() for t in routers]
        moe._dispatch_indices = counted_dispatch
        try:
            with ops.env_override({"REPRO_MOE_CF": ample_cf(cfg)}):
                own = gap()[0]
                for t in routers:
                    t.zero_()
                dec_fwd, finite, counts = gap()
        finally:
            for t, keep in zip(routers, saved):
                t.copy_(keep)
            moe._dispatch_indices = real_dispatch
    if any(drops):
        fail(f"{arch} decode vs forward: capacity factor {ample_cf(cfg)} "
             f"dropped {sum(drops)} assignments")
    check_launches(f"{arch} forward", counts, {
        "flash_attention": flash_layers(arch, cfg),
        "flash_attention_simt": 0})
    add_counts(total, f"zoo/{arch}/forward", counts)
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "forward_tokens": [b, p + 2],
            "decode_vs_forward": dec_fwd,
            "limit": ZOO_DECODE_VS_FORWARD.get(arch, LM_DECODE_VS_FORWARD),
            "routers": None if cfg.moe is None else "zeroed (tied scores)",
            "own_routers_decode_vs_forward": own,
            "capacity_factor": None if cfg.moe is None else ample_cf(cfg),
            "moe_dispatches": len(drops), "finite": finite}


def v3_moe_layer(torch, np, dev, cfg, params):
    """(d): DeepSeek-V3's full-width MoE layer (256 experts, top-8,
    sigmoid routing, 1 shared) on the card: the fp32 router logits against
    the same product on the CPU; the top-8 ids and the capacity drop set
    at the config's factor against the same selection and dispatch run on
    the CPU on the card's scores (equal); and the output at ample capacity
    against the dense mixture of the selected experts' FFNs."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    p = {k: v[0] for k, v in params["moe_layers"]["moe"].items()}
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((*V3_MOE_TOKENS, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    m = cfg.moe
    x_flat = x.reshape(1, -1, cfg.d_model)
    logits = torch.einsum("gtd,de->gte", x_flat.float(), p["router"])
    cpu_logits = torch.einsum("gtd,de->gte", x_flat.float().cpu(),
                              p["router"].cpu())
    router_err = float((logits.cpu() - cpu_logits).abs().max()
                       / cpu_logits.abs().max())
    scores = torch.sigmoid(logits) + p["router_bias"]
    _, ids = moe.top_k(scores, m.top_k)
    _, cpu_ids = moe.top_k(scores.cpu(), m.top_k)
    w, ids_fn, _ = moe._routing(p, x_flat, cfg)
    tokens = x_flat.shape[1]
    cap = moe.capacity(tokens, cfg)
    dest, ok = moe._dispatch_indices(ids[0].reshape(-1), m.n_experts, cap)
    cdest, cok = moe._dispatch_indices(cpu_ids[0].reshape(-1), m.n_experts,
                                       cap)
    same_ids = bool(torch.equal(ids.cpu(), cpu_ids)
                    and torch.equal(ids_fn, ids))
    same_drops = bool(torch.equal(dest.cpu(), cdest)
                      and torch.equal(ok.cpu(), cok))
    dropped = int((~ok).sum())
    # ample capacity: the dispatch against the dense mixture
    xs = x.reshape(-1, cfg.d_model)[:V3_MOE_AMPLE_TOKENS[1]].reshape(
        *V3_MOE_AMPLE_TOKENS, cfg.d_model)
    with ops.env_override({"REPRO_MOE_CF": ample_cf(cfg)}):
        y, _ = moe.moe_ffn(p, xs, cfg)
        xs_flat = xs.reshape(1, -1, cfg.d_model)
        w2, ids2, _ = moe._routing(p, xs_flat, cfg)
        dropped_ample = int((~moe._dispatch_indices(
            ids2[0].reshape(-1), m.n_experts, moe.capacity(
                xs_flat.shape[1], cfg))[1]).sum())
    t = xs_flat[0]
    contrib = torch.zeros((t.shape[0], m.top_k, cfg.d_model),
                          dtype=t.dtype, device=dev)
    for e in range(m.n_experts):
        rows, slots = torch.nonzero(ids2[0] == e, as_tuple=True)
        if rows.numel():
            xe = t[rows]
            h = torch.nn.functional.silu((xe @ p["w_gate"][e]).float()).to(
                t.dtype) * (xe @ p["w_up"][e])
            contrib[rows, slots] = (h @ p["w_down"][e]) * w2[0, rows, slots,
                                                             None].to(t.dtype)
    dense = contrib[:, 0]
    for j in range(1, m.top_k):
        dense = dense + contrib[:, j]
    sh = torch.nn.functional.silu((t @ p["shared_gate"]).float()).to(
        t.dtype) * (t @ p["shared_up"])
    dense = dense + sh @ p["shared_down"]
    rel = float((y.reshape(dense.shape).double() - dense.double()).norm()
                / dense.double().norm())
    res = {"phase": "zoo_v3_moe_layer", "experts": m.n_experts,
           "top_k": m.top_k, "width": cfg.d_model,
           "d_ff_expert": m.d_ff_expert, "tokens": tokens,
           "capacity": cap, "dropped_assignments": dropped,
           "router_rel_err_vs_cpu": router_err,
           "router_limit": V3_ROUTER_RTOL, "ids_equal_cpu": same_ids,
           "drop_set_equal_cpu": same_drops,
           "ample_tokens": xs_flat.shape[1],
           "ample_dropped": dropped_ample,
           "dense_mixture_rel_l2": rel, "dense_limit": MOE_DENSE_REL}
    line(res)
    if not (same_ids and same_drops and dropped_ample == 0
            and router_err <= V3_ROUTER_RTOL and rel <= MOE_DENSE_REL):
        fail(f"deepseek-v3 MoE layer: {res}")


def zoo_runs(torch, np, dev, surs, profile):
    """The six configs beyond StarCoder2-3B, one after another, each freed
    before the next: (a) the JAX record; (c) ``repro_torch.launch.serve``
    with ``Model.init``'s weights at batch 8 x P + 64, at full width and
    the serve depth; (b) decode against forward at that depth on weights
    of the parity distribution drawn on the card; (d) DeepSeek-V3's MoE
    layer."""
    from repro_torch.convert import lm_parity_specs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import params as prm
    total = {}
    for arch in ZOO_ARCHS:
        t_arch = time.perf_counter()
        zoo_record(torch, np, dev, arch, total)
        p = ZOO_SERVE_PROMPT.get(arch, ZOO_SERVE_PROMPT_LEN)
        argv = ["--arch", arch, "--batch", str(ZOO_SERVE_BATCH),
                "--prompt-len", str(p), "--gen", str(ZOO_SERVE_GEN)]
        if arch in ZOO_SERVE_LAYERS:
            argv += ["--layers", str(ZOO_SERVE_LAYERS[arch])]
        args = serve.parser().parse_args(argv)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        res = serve.serve(args)
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        model, params, prompts, max_seq = serve.setup(args)
        cfg = model.cfg
        check_launches(f"{arch} serve", counts, {
            "flash_attention": flash_layers(arch, cfg),
            "flash_attention_simt": 0})
        add_counts(total, f"zoo/{arch}/serve", counts)
        out = {"phase": "zoo_serve", "arch": arch, "args": " ".join(argv),
               "layers": cfg.n_layers, "width": cfg.d_model,
               "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
               "tokens_per_s": res["tokens_per_s"],
               "logits_finite": res["logits_finite"],
               "generated_shape": list(res["generated"].shape),
               "peak_device_bytes": peak,
               "flash_attention_launches": counts["flash_attention"],
               "launches": counts, "card": nvidia_smi()}
        del res
        steady = serve.generate(model, params, prompts,
                                gen=ZOO_SERVE_GEN, max_seq=max_seq)
        out["steady"] = {k: steady[k] for k in ("prefill_s", "decode_s",
                                                "tokens_per_s",
                                                "logits_finite")}
        if profile:
            out["profile"] = profile_run(torch, lambda: serve.generate(
                model, params, prompts, gen=ZOO_SERVE_GEN, max_seq=max_seq))
        line(out)
        if not (out["logits_finite"] and steady["logits_finite"]):
            fail(f"{arch} serve: non-finite logits")
        del params, prompts, steady
        torch.cuda.empty_cache()
        # (b) and (d) on well-conditioned weights drawn on the card (the
        # parity weights' distribution, convert.lm_parity_specs)
        params = prm.materialize(torch.Generator(device=dev).manual_seed(0),
                                 lm_parity_specs(cfg), dev)
        dvf = zoo_decode_vs_forward(torch, np, dev, arch, model, params,
                                    total)
        line({"phase": "zoo_decode_vs_forward", "arch": arch,
              "weights": "lm_parity_specs, seed 0", **dvf})
        if not dvf["finite"] or not dvf["decode_vs_forward"] < dvf["limit"]:
            fail(f"{arch} decode vs forward: {dvf}")
        if arch == "deepseek-v3-671b":
            v3_moe_layer(torch, np, dev, cfg, params)
        del model, params
        torch.cuda.empty_cache()
        line({"phase": "zoo_done", "arch": arch,
              "seconds": time.perf_counter() - t_arch})
    return total


# --- phase 8: the layer runners and design-space exploration -----------------

LAYER_SUB = 64                 # neurons whose LIF records the JAX record keeps
# against the JAX record; first set at 0.999 / 1e-4 (golden, behavioral)
# and PERF.md §2's network limits 0.99 / 1% (LASANA), tightened once the
# card agreed on every entry with sums within 6.1e-8 (PERF.md §2, §6)
LAYER_AGREE_EXACT = 0.9999     # golden / behavioral: spikes or output codes
LAYER_SUM_REL = 1e-6           # golden / behavioral: energy, latency sums
LAYER_AGREE = 0.999            # LASANA runs: spikes or output codes
LAYER_ENERGY_REL = 1e-5        # LASANA runs: total energy
LAYER_T = {"lif": 100, "xbar": 30}
# run -> (surrogate key or None, mode, launches); modes as in
# tests/test_torch_fixtures.py: golden, behavioral, or run_lasana as
# LASANA-P ("p"), LASANA-O ("o", golden states) or annotation
LAYER_RUNS = {
    "lif": {"golden": (None, "golden", {"lif_chunk": 1, "lif_step": 0}),
            "behavioral": (None, "behavioral", {"lif_chunk": 0,
                                                "network_tick": 0}),
            "lasana_p": ("lif", "p", {"network_tick": 100}),
            "lasana_o": ("lif", "o", {"network_tick": 100}),
            "annotation": ("lif", "annotate", {"network_tick": 100}),
            "lasana_p_unpackable": ("lif_unpackable", "p", {
                "mlp_surrogate_heads": (">=", 100), "network_tick": 0})},
    "xbar": {"golden": (None, "golden", {"crossbar_target": 30}),
             "behavioral": (None, "behavioral", {"crossbar_target": 30}),
             "lasana_p": ("crossbar", "p", {"network_tick": 30})}}
SCALING_NS = (10, 100, 1000, 5000, 20000, 200000)   # benchmarks FULL_SCALE
SCALING_T = 100
PROP_N, PROP_T, PROP_SEED = 20000, 100, 42
PROP_O_OVER_P = 1.2            # tests/test_system.py::test_oracle_state_mode
PROP_SPIKE_ACC = 0.92          # ::test_lasana_matches_golden_spikes
DSE_CANDIDATES = 4096          # benchmarks/bench_dse.py N_CANDIDATES_FULL
DSE_RTOL = 1e-5
DSE_TIE = 1e-5                 # a Pareto difference needs a tie this close
DSE_ARCHS = ("starcoder2-3b", "granite-3-8b", "deepseek-67b",
             "mistral-large-123b", "deepseek-v3-671b", "deepseek-moe-16b",
             "whisper-base", "pixtral-12b", "mamba2-1.3b",
             "recurrentgemma-2b")


def layer_run(torch, sim, sur, circuit, stim, mode, golden=None, beh=None):
    """One layer-runner call: golden, behavioral, or ``run_lasana`` in
    ``mode`` (LASANA-O on ``golden``'s states, annotation on ``beh``'s)."""
    if mode == "golden":
        return sim.run_golden(circuit, *stim)
    if mode == "behavioral":
        return sim.run_behavioral(circuit, *stim)
    kw = {}
    if mode == "o":
        kw = {"oracle_states": golden.states}
    elif mode == "annotate":
        kw = {"oracle_states": beh.states, "annotate_outputs": beh.outputs}
    return sim.run_lasana(sur, circuit, *stim, **kw)


def rel_diff(got, want):
    return abs(got - want) / abs(want) if want else abs(got)


def layer_record_checks(np, kind, name, run, rec):
    """A run against the JAX record: spike (LIF) or ADC-code (crossbar)
    agreement over every (tick, circuit), and the energy and latency sums."""
    key = f"{kind}/{name}"
    if kind == "lif":
        want = np.unpackbits(rec[f"{key}/spikes"], axis=-1,
                             count=run.outputs.shape[1]).astype(bool)
        agree = float(np.mean((run.outputs > 0.75) == want))
        e_ref = float(rec[f"{key}/energy_by_neuron"].sum())
        l_ref = float(rec[f"{key}/latency_by_neuron"].sum())
        sub = {f: float(np.max(np.abs(getattr(run, f)[:, :LAYER_SUB]
                                      - rec[f"{key}/sub/{f}"])))
               for f in ("states", "energy", "latency")}
    else:
        # half an 8-bit ADC step of the row output over [-2, 2] V
        step = 4.0 / 255
        agree = float(np.mean(np.abs(run.outputs - rec[f"{key}/outputs"])
                              < 0.5 * step))
        e_ref = float(rec[f"{key}/energy"].astype(np.float64).sum())
        l_ref = float(rec[f"{key}/latency"].astype(np.float64).sum())
        sub = {f: float(np.max(np.abs(getattr(run, f) - rec[f"{key}/{f}"])))
               for f in ("outputs", "states", "energy", "latency")}
    e_port = float(run.energy.astype(np.float64).sum())
    l_port = float(run.latency.astype(np.float64).sum())
    return {"agreement_vs_ref": agree, "energy_j": e_port,
            "energy_rel_diff_vs_ref": rel_diff(e_port, e_ref),
            "latency_sum_rel_diff_vs_ref": rel_diff(l_port, l_ref),
            "max_abs_diff_vs_ref_kept_records": sub}


def no_sync_ticks(torch, np, sim, sur, circuit, stim, want):
    """The LASANA-P tick loop enqueued with host synchronisation
    forbidden; its records equal ``want``'s (the timed run's) bit for
    bit."""
    step, dev, _ = sim._lasana_program(
        sur, circuit, *stim, oracle_states=None, annotate_outputs=None,
        fused=True, fused_kernel=None, device=None)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = [t.cpu().numpy() for t in out]
    for f, g in zip(("outputs", "states", "energy", "latency"), got):
        if not np.array_equal(g, getattr(want, f)):
            fail(f"{circuit} LASANA-P: the tick loop under sync debug mode "
                 f"'error' gave other {f} than the timed run")


def layer_record(torch, np, dev, surs, smi):
    """The quickstart's layers against the JAX record
    (``layer_ref_record.npz``): LIF N = 1,000 x T = 100 and crossbar rows
    N = 128 x T = 30 on the record's own stimulus, every runner."""
    from repro_torch.core import simulate as sim
    rec = dict(np.load(ART / "layer_ref_record.npz"))
    total = {}
    for kind, circuit in (("lif", "lif"), ("xbar", "crossbar")):
        x = rec[f"{kind}/x"]
        n = x.shape[1]
        active = np.unpackbits(rec[f"{kind}/active"], axis=-1,
                               count=n).astype(bool)
        stim = tuple(torch.as_tensor(a, device=dev) for a in (
            active, x, rec[f"{kind}/params"].astype(np.float32)))
        runs = {}
        for name, (skey, mode, want) in LAYER_RUNS[kind].items():
            run, counts = counted(torch, lambda: layer_run(
                torch, sim, surs.get(skey), circuit, stim, mode,
                runs.get("golden"), runs.get("behavioral")))
            check_launches(f"layer {kind} {name}", counts, want)
            runs[name] = run
            res = layer_record_checks(np, kind, name, run, rec)
            exact = mode in ("golden", "behavioral")
            ok = (res["agreement_vs_ref"] >= LAYER_AGREE_EXACT
                  and res["energy_rel_diff_vs_ref"] <= LAYER_SUM_REL
                  and res["latency_sum_rel_diff_vs_ref"] <= LAYER_SUM_REL
                  ) if exact else (
                res["agreement_vs_ref"] >= LAYER_AGREE
                and res["energy_rel_diff_vs_ref"] <= LAYER_ENERGY_REL)
            finite = all(np.isfinite(getattr(run, f)).all() for f in (
                "outputs", "states", "energy", "latency"))
            line({"phase": "layer_record", "layer": kind, "run": name,
                  "shape": list(run.outputs.shape), "launches": counts,
                  "wall_s": run.wall_seconds,
                  "compile_s": run.compile_seconds, **res,
                  "limits": ({"agreement": LAYER_AGREE_EXACT,
                              "sums_rel": LAYER_SUM_REL} if exact else
                             {"agreement": LAYER_AGREE,
                              "energy_rel": LAYER_ENERGY_REL}),
                  "card": smi})
            if not ok or not finite or run.outputs.shape != (
                    LAYER_T[kind], n):
                fail(f"layer {kind} {name}: {res} outside its limits, "
                     f"non-finite records or shape {run.outputs.shape}")
            add_counts(total, f"layer/{kind}/{name}", counts)
        no_sync_ticks(torch, np, sim, surs[LAYER_RUNS[kind]["lasana_p"][0]],
                      circuit, stim, runs["lasana_p"])
    return total


def layer_scaling(torch, np, dev, surs, profile, smi):
    """Table IV at FULL_SCALE: N LIF neurons x 100 ticks (the port's
    ``make_stimulus(seed=N)``), golden / behavioral / LASANA-P /
    annotation walls (no build, no pack) and LASANA-P's speedups."""
    from repro_torch.core import simulate as sim
    sur = surs["lif"]
    total = {}
    for n in SCALING_NS:
        stim = sim.make_stimulus("lif", n, SCALING_T, seed=n, device=dev)
        runs, launches = {}, {}
        for name, mode in (("golden", "golden"), ("behavioral", "behavioral"),
                           ("lasana_p", "p"), ("annotation", "annotate")):
            runs[name], launches[name] = counted(torch, lambda: layer_run(
                torch, sim, sur, "lif", stim, mode,
                beh=runs.get("behavioral")))
            add_counts(total, f"scaling/n={n}/{name}", launches[name])
        check_launches(f"scaling n={n} golden", launches["golden"],
                       {"lif_chunk": 1})
        for name in ("lasana_p", "annotation"):
            check_launches(f"scaling n={n} {name}", launches[name],
                           {"network_tick": SCALING_T})
        if not all(np.isfinite(r.energy).all() and r.outputs.shape == (
                SCALING_T, n) for r in runs.values()):
            fail(f"scaling n={n}: non-finite records or wrong shapes")
        wall = {k: r.wall_seconds for k, r in runs.items()}
        row = {"phase": "layer_scaling", "n": n, "ticks": SCALING_T,
               "wall_s": wall,
               "compile_s": {k: r.compile_seconds for k, r in runs.items()},
               "speedup_vs_golden": wall["golden"] / wall["lasana_p"],
               "speedup_vs_behavioral": wall["behavioral"]
               / wall["lasana_p"],
               "annotation_over_behavioral": wall["annotation"]
               / wall["behavioral"],
               "spikes": int((runs["golden"].outputs > 0.75).sum()),
               "launches": launches, "card": smi}
        if profile and n == SCALING_NS[-1]:
            row["profile"] = {
                name: profile_run(torch, lambda: layer_run(
                    torch, sim, sur, "lif", stim, mode,
                    beh=runs["behavioral"]))
                for name, mode in (("golden", "golden"), ("lasana_p", "p"))}
        line(row)
    return total, stim


def propagation_metrics(np, golden, run):
    """``benchmarks/bench_propagation.py``'s ``_metrics``: the run against
    golden (dynamic events are golden's spikes)."""
    spikes_g = golden.outputs > 0.75
    e1 = spikes_g
    out = {"state_mse": float(np.mean((golden.states - run.states) ** 2)),
           "output_mse": float(np.mean((golden.outputs - run.outputs) ** 2)),
           "spike_acc": float(np.mean(spikes_g == (run.outputs > 0.75)))}
    if e1.any():
        le = np.abs(run.latency - golden.latency)[e1]
        out["latency_mse"] = float(np.mean(
            (run.latency - golden.latency)[e1] ** 2))
        out["latency_mape"] = float(np.mean(
            le / np.maximum(golden.latency[e1], 1e-3)) * 100)
        ed = (run.energy - golden.energy)[e1] * 1e12
        out["dyn_energy_mse_pJ2"] = float(np.mean(ed ** 2))
        out["dyn_energy_mape"] = float(np.mean(
            np.abs(ed) / np.maximum(golden.energy[e1] * 1e12, 1e-6)) * 100)
    es = (run.energy - golden.energy)[~e1] * 1e12
    out["stat_energy_mse_pJ2"] = float(np.mean(es ** 2))
    return out


def layer_propagation(torch, np, dev, surs, profile, smi):
    """Table III at FULL_SCALE: LASANA-O against LASANA-P on N = 20,000 x
    100 ticks (seed 42), and Fig. 8's drift ratio."""
    from repro_torch.core import simulate as sim
    sur = surs["lif"]
    stim = sim.make_stimulus("lif", PROP_N, PROP_T, seed=PROP_SEED,
                             device=dev)
    total = {}
    golden, counts = counted(torch, lambda: sim.run_golden("lif", *stim))
    add_counts(total, "propagation/golden", counts)
    lp, counts = counted(torch, lambda: sim.run_lasana(sur, "lif", *stim))
    check_launches("propagation LASANA-P", counts,
                   {"network_tick": PROP_T})
    add_counts(total, "propagation/lasana_p", counts)
    lo, counts = counted(torch, lambda: sim.run_lasana(
        sur, "lif", *stim, oracle_states=golden.states))
    check_launches("propagation LASANA-O", counts,
                   {"network_tick": PROP_T})
    add_counts(total, "propagation/lasana_o", counts)
    m_o, m_p = (propagation_metrics(np, golden, r) for r in (lo, lp))
    mse_t = np.mean((golden.states - lp.states) ** 2, axis=1)
    third = PROP_T // 3
    drift = float(np.mean(mse_t[-third:])) / max(
        float(np.mean(mse_t[:third])), 1e-12)
    res = {"phase": "layer_propagation", "n": PROP_N, "ticks": PROP_T,
           "seed": PROP_SEED, "LASANA-O": m_o, "LASANA-P": m_p,
           "mse_drift_ratio_last_over_first": drift,
           "energy_rel_diff_p_vs_golden": rel_diff(
               float(lp.energy.sum()), float(golden.energy.sum())),
           "wall_s": {"golden": golden.wall_seconds,
                      "lasana_p": lp.wall_seconds,
                      "lasana_o": lo.wall_seconds},
           "limits": {"o_state_mse_over_p": PROP_O_OVER_P,
                      "p_spike_acc": PROP_SPIKE_ACC}, "card": smi}
    if profile:
        res["profile"] = profile_run(torch, lambda: sim.run_lasana(
            sur, "lif", *stim, oracle_states=golden.states))
    line(res)
    finite = all(np.isfinite(v) for m in (m_o, m_p) for v in m.values()) \
        and np.isfinite(drift)
    if not finite or m_o["state_mse"] > PROP_O_OVER_P * m_p["state_mse"] \
            or m_p["spike_acc"] < PROP_SPIKE_ACC:
        fail(f"propagation: LASANA-O state MSE {m_o['state_mse']:.4g} vs "
             f"LASANA-P {m_p['state_mse']:.4g} (limit x{PROP_O_OVER_P}), "
             f"LASANA-P spike accuracy {m_p['spike_acc']:.4f} (limit "
             f"{PROP_SPIKE_ACC}) or a non-finite metric")
    return total


def pareto_ties(np, got, want):
    """Where the Pareto sets of objective rows ``got`` and ``want`` (C, K)
    differ: for each candidate i whose membership differs, each candidate
    j that dominates i under one set and not the other, as ``[i, j, k]``
    with k an objective on which i and j tie within DSE_TIE (relative) —
    the rounding of a tie decides such a pair — or None where they tie
    on none."""
    from repro_torch.core.explore import pareto_mask
    pairs = []
    for i in np.flatnonzero(pareto_mask(got) != pareto_mask(want)):
        dom = [np.all(o <= o[i], axis=1) & np.any(o < o[i], axis=1)
               for o in (got, want)]
        for j in np.flatnonzero(dom[0] != dom[1]):
            tie = np.flatnonzero(np.abs(want[j] - want[i]) <= DSE_TIE
                                 * np.maximum(np.abs(want[j]),
                                              np.abs(want[i])))
            pairs.append([int(i), int(j), int(tie[0]) if tie.size
                          else None])
    return pairs


def dse_objectives(np, energy, latency, frac):
    return np.stack([energy, latency, -frac], axis=1)


def dse_runs(torch, np, dev, surs, profile, smi):
    """``lasana.explore(CandidateSpec.sample(4096, seed=0),
    crossbar_unpackable)`` on the process-wide engine, its base rows set
    from the JAX record (``dse_ref_record.npz``); a hot swap; and
    ``explore_arch`` of the four dense configs on the record's tile rows.
    Returns (launches by run, the heads kernel at the sweep's shape)."""
    import json

    import repro_torch.lasana as lasana
    from repro_torch import configs
    from repro_torch.core import explore
    rec = dict(np.load(ART / "dse_ref_record.npz"))
    sur = surs["crossbar_unpackable"]
    eng = explore.dse_engine()
    eng._base_x, eng._base_p, eng._base_o = (torch.as_tensor(
        rec[k].astype(np.float32), device=dev)
        for k in ("base_x", "base_p", "base_o"))
    cands = lasana.CandidateSpec.sample(DSE_CANDIDATES, seed=0)
    if not (np.array_equal(cands.v_dd, rec["v_dd"])
            and np.array_equal(cands.tile, rec["tile"])):
        fail("dse: CandidateSpec.sample(4096, seed=0) differs from the "
             "record's candidates")
    total = {}
    rep, counts = counted(torch, lambda: lasana.explore(cands, sur))
    check_launches("dse first", counts, {"mlp_surrogate_heads": 1})
    add_counts(total, "dse/first", counts)
    steady, counts = counted(torch, lambda: lasana.explore(cands, sur))
    check_launches("dse steady", counts, {"mlp_surrogate_heads": 1})
    add_counts(total, "dse/steady", counts)
    for f in ("n_tiles", "analog_params", "total_params",
              "analog_flop_fraction"):
        if not np.array_equal(getattr(rep, f), rec[f"report/{f}"]):
            fail(f"dse: tile table {f} differs from the record")
    errs = {}
    for f in ("tile_energy_j", "tile_latency_ns", "energy_per_token_j",
              "latency_critical_ns"):
        got, want = getattr(rep, f), rec[f"report/{f}"]
        if got.dtype != np.float64 or not np.isfinite(got).all():
            fail(f"dse: {f} is {got.dtype} or not finite")
        bad = np.abs(got - want) > DSE_RTOL * np.abs(want)
        nz = want != 0
        errs[f] = float(np.max(np.abs(got[nz] - want[nz])
                               / np.abs(want[nz]), initial=0.0))
        if bad.any():
            fail(f"dse: {f} off the record beyond rtol {DSE_RTOL} on "
                 f"{int(bad.sum())} candidates (max {errs[f]:.3e})")
    want_objs = dse_objectives(np, *(rec[f"report/{f}"] for f in (
        "energy_per_token_j", "latency_critical_ns",
        "analog_flop_fraction")))
    from repro_torch.core.explore import pareto_mask
    if not np.array_equal(np.flatnonzero(pareto_mask(want_objs)),
                          rec["pareto"]):
        fail("dse: pareto_mask over the record's objectives is not the "
             "record's Pareto set")
    ties = pareto_ties(np, dse_objectives(
        np, rep.energy_per_token_j, rep.latency_critical_ns,
        rep.analog_flop_fraction), want_objs)
    if any(k is None for _, _, k in ties):
        fail(f"dse: Pareto membership differs from the record without a "
             f"tie: {[p for p in ties if p[2] is None]}")
    swapped = scaled_surrogate(sur, SWAP_SCALE)
    rep2, counts = counted(torch, lambda: lasana.explore(cands, swapped))
    check_launches("dse hot swap", counts, {"mlp_surrogate_heads": 1})
    add_counts(total, "dse/hot_swap", counts)
    if not (rep.compile_count == steady.compile_count
            == rep2.compile_count == 1):
        fail(f"dse: compile_count {rep.compile_count} / "
             f"{steady.compile_count} / {rep2.compile_count} (want 1)")
    if np.array_equal(rep2.tile_energy_j, rep.tile_energy_j):
        fail("dse: the hot-swapped surrogate priced the same tile energies")
    rows = tuple(torch.as_tensor(rec[k].astype(np.float32), device=dev)
                 for k in ("tile_x", "tile_p", "tile_o"))
    e_tile, l_tile = explore._price_rows(sur, *rows)
    archs = {}
    for arch in DSE_ARCHS:
        cfg = configs.get_config(arch)
        got = explore._arch_report(cfg, e_tile, l_tile)
        comps = json.loads(str(rec[f"arch/{arch}/tiles_by_component"]))
        if got.tiles_by_component != comps or any(
                getattr(got, f) != int(rec[f"arch/{arch}/{f}"])
                for f in ("n_tiles", "n_matrices", "analog_params",
                          "total_params")):
            fail(f"dse explore_arch {arch}: tile counts differ from the "
                 "record")
        rel = {f: rel_diff(getattr(got, f), float(rec[f"arch/{arch}/{f}"]))
               for f in ("energy_per_token_j", "latency_critical_ns",
                         "tile_energy_j", "analog_flop_fraction")}
        if max(rel.values()) > DSE_RTOL:
            fail(f"dse explore_arch {arch}: {rel} (limit {DSE_RTOL})")
        own = explore.explore_arch(cfg, sur)
        archs[arch] = {"n_tiles": got.n_tiles, "rel_diff_vs_ref": rel,
                       "energy_per_token_j": got.energy_per_token_j,
                       "own_draws_energy_per_token_j":
                           own.energy_per_token_j}
    res = {"phase": "dse", "candidates": DSE_CANDIDATES,
           "n_samples": eng.n_samples,
           "rows": DSE_CANDIDATES * eng.n_samples,
           "first_wall_s": rep.wall_seconds,
           "steady_wall_s": steady.wall_seconds,
           "candidates_per_s": DSE_CANDIDATES / steady.wall_seconds,
           "hot_swap_wall_s": rep2.wall_seconds,
           "compile_count": rep2.compile_count,
           "max_rel_diff_vs_ref": errs, "pareto": int(rep.pareto().size),
           "pareto_differences": len({p[0] for p in ties}),
           "pareto_tie_pairs": ties, "explore_arch": archs,
           "limits": {"rtol": DSE_RTOL, "pareto_tie": DSE_TIE},
           "card": smi}
    if profile:
        res["profile"] = profile_run(torch, lambda: lasana.explore(cands,
                                                                   sur))
    line(res)
    return total, heads_at_dse_shape(torch, np, sur, eng)


def heads_at_dse_shape(torch, np, sur, eng):
    """``mlp_surrogate_heads`` at the sweep's shape: M_ED and M_L (P = 2)
    over the engine's transition matrix (4,096 x 256 rows, F = 70),
    against the plain version, timed beside its bound."""
    from repro_torch.kernels import mlp_surrogate
    (ws,) = eng._programs.values()
    s = sur._stacked(("M_ED", "M_L"))
    args = (ws.tr, s["x_mu"], s["x_sd"], s["y_mu"], s["y_sd"], s["w0"],
            s["b0"], s["w1"], s["b1"], s["w2"], s["b2"])
    got = mlp_surrogate.mlp_surrogate_heads(*args)
    want = mlp_surrogate.mlp_heads_plain(*args)
    torch.cuda.synchronize()
    n, f = ws.tr.shape
    p, _, h1 = s["w0"].shape
    h2 = s["w1"].shape[2]
    ms, by = heads_bound(ws.tr, args[1:])
    return {"shape": f"x ({n}, {f}), P={p}, H1={h1}, H2={h2}",
            "plan": mlp_surrogate.plan(p, f, h1, h2),
            "max_abs_err": compare(got, want, "mlp_surrogate_heads dse"),
            "ms": time_ms(lambda: mlp_surrogate.mlp_surrogate_heads(*args),
                          torch),
            "plain_ms": time_ms(lambda: mlp_surrogate.mlp_heads_plain(
                *args), torch),
            "bound_ms": ms, "bound_by": by}


def layer_kernel_shapes(torch, np, dev, surs, stim, smi):
    """The golden and tick kernels at the layer runners' shapes:
    ``lif_chunk`` (with ``v_seq``) over the scaling run's N = 200,000 x
    100 ticks and ``network_tick`` on LIF rows at N = 20,000 and 200,000,
    each against its plain version, timed beside its bound."""
    from repro_torch.core.circuits import LIFNeuron
    from repro_torch.kernels import lif_scan
    circ = LIFNeuron()
    _, x, params = stim
    t_steps, n = x.shape[:2]
    state = circ.init_state(n, device=dev)
    run = lambda: lif_scan.lif_chunk(state, x, params, circ=circ,
                                     record_v=True)
    new_state, obs = run()
    want = lif_scan.chunk_plain(circ, state, x, params, True)
    torch.cuda.synchronize()
    if not torch.equal(obs["spiked"], want[4]):
        fail(f"lif_chunk n={n} T={t_steps}: spiked differs from the plain "
             "version")
    err = max(compare(g, w, f"lif_chunk n={n} T={t_steps} {k}")
              for k, g, w in zip(("state", "output", "energy", "latency",
                                  "v_seq"),
                                 (new_state, obs["output"], obs["energy"],
                                  obs["latency"], obs["v_seq"]),
                                 (want[0], *want[1:4], want[5])))
    ms, by = bound(lif_scan.work(n, circ.n_substeps, t_steps, record_v=True))
    chunk = {f"n={n} T={t_steps} v_seq": {
        "max_abs_err": err, "ms": time_ms(run, torch),
        # 100 x 64 substeps of PyTorch ops at 200,000 rows: one call
        "plain_ms": time_ms(lambda: lif_scan.chunk_plain(
            circ, state, x, params, True), torch, reps=1),
        "bound_ms": ms, "bound_by": by,
        "main_path": "simulate.run_golden('lif'), one launch a run"}}
    tick = tick_at_shapes(torch, np, dev, surs["lif"],
                          (PROP_N, SCALING_NS[-1]),
                          "simulate.run_lasana('lif'), one launch a tick")
    line({"phase": "layer_kernel_shapes", "lif_chunk": chunk,
          "network_tick": tick, "card": smi})
    return chunk, tick


def tick_at_shapes(torch, np, dev, sur, ns, main_path):
    """``network_tick`` on LIF rows with ``sur``'s pack at each N of
    ``ns`` against its plain version (spikes may differ only within
    HALF_VDD_BAND ULPs of the threshold), timed beside its bound."""
    from repro_torch.kernels import tick_megakernel as mk
    pk, ly = mk.pack_heads(sur)
    tick = {}
    for n_t in ns:
        ins, t, clock, ckw = tick_case(torch, np, dev, "lif", n_t, n_t)
        v, o, t_last, params_t, ch, x_t, _ = ins
        kw = dict(circuit="lif", clock_ns=clock, layout=ly, out_eps=0.02,
                  annotate=False, **ckw)
        args = (pk, v, o, t_last, params_t, ch, x_t, t, None)
        got = mk.network_tick(*args, **kw)
        *want_t, o_hat = mk._tick_arrays(pk["a"], pk["t"], v, o, t_last,
                                         params_t, ch, x_t, t,
                                         known_out=None, **kw)
        torch.cuda.synchronize()
        ulp = float(np.spacing(np.float32(0.75)))
        flip = (got[1] != want_t[1]).cpu().numpy()
        near = (torch.abs(o_hat - 0.75) <= HALF_VDD_BAND * ulp).cpu().numpy()
        if (flip & ~near).any() or not torch.equal(got[2], want_t[2]):
            fail(f"network_tick n={n_t}: spikes or t_last differ from the "
                 "plain version away from the threshold")
        res = tick_timing(torch, mk, args, kw, o_hat)
        res["max_abs_err"] = max(
            compare(g, w, f"network_tick n={n_t} {name}", mask=~flip)
            for name, g, w in zip(("v", "e", "l"), (got[0], got[3], got[4]),
                                  (want_t[0], want_t[3], want_t[4])))
        res["main_path"] = main_path
        tick[f"n={n_t}"] = res
    return tick


# --- the serve phase -------------------------------------------------------------

SERVE_SLOTS = 32        # the served SNN's lane: 32 slots
SERVE_CHUNK = 16        # ticks per scheduling round
# the 100 digits cut into 12 requests of 1-16 digits, in order
SERVE_SIZES = (16, 3, 9, 1, 12, 5, 14, 7, 2, 11, 4, 16)
# (ticks, digits) of the heterogeneous requests on a 16-slot lane
SERVE_HETERO = ((100, 4), (37, 2), (5, 1), (64, 3), (88, 1), (23, 4),
                (50, 2), (71, 3))
SERVE_UNPACKABLE = ((100, 8), (45, 5), (100, 7))      # the first 20 digits
SERVE_MIXED = ((30, 16), (12, 10), (30, 20), (25, 18))   # 64 held digits
SERVE_SWAP_SCALE = 1.001     # the hot swap's M_ES weights


class _Queued:
    """What a lane admits: a request's handle and host stimulus."""

    def __init__(self, handle, stimulus):
        self.handle = handle
        self.stimulus = stimulus


def split_requests(np, x_host, jobs):
    """Host stimuli of (ticks, digits) jobs over consecutive digits of
    ``x_host`` (T, B, fan_in), wrapping around B."""
    out, lo = [], 0
    b_all = x_host.shape[1]
    for t, b in jobs:
        idx = [(lo + j) % b_all for j in range(b)]
        out.append(np.ascontiguousarray(x_host[:t, idx]))
        lo += b
    return out


def no_sync_step(torch, step):
    """``step`` run with host synchronisation forbidden: any synchronising
    call inside a slot step raises."""
    def run(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return step(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return run


def serve_lane(torch, spec, sur, width, stims, kw=None, metrics=None,
               done_at=None):
    """Serve host ``stims`` on a fresh lane of ``lasana.engine(spec,
    record_hidden=False, **kw)``, every ``programs.step`` under sync debug
    mode "error": admit requests in order as slots free, step until idle
    (the reference's ``SimServer.run_until_idle`` loop). Returns (lane,
    handles, host seconds per ``Lane.step``, join ticks, quarantined);
    ``done_at``, a dict, gets each request's ``perf_counter`` time at the
    end of the step that finished it."""
    import dataclasses

    import repro_torch.lasana as lasana
    from repro_torch.serve import Bucket, Lane, RequestHandle
    eng = lasana.engine(spec, record_hidden=False, **(kw or {}))
    lane = Lane(eng, spec, Bucket("chip", width, SERVE_CHUNK), sur,
                metrics=metrics)
    lane.programs = dataclasses.replace(
        lane.programs, step=no_sync_step(torch, lane.programs.step))
    queue = [_Queued(RequestHandle(i, "chip"), x) for i, x in enumerate(stims)]
    handles = [q.handle for q in queue]
    walls, joins, quarantined = [], [], []
    while queue or lane.active:
        while queue and lane.admit(queue[0]):
            joins.append(lane.g)
            queue.pop(0)
        t0 = time.perf_counter()
        stats = lane.step()
        walls.append(time.perf_counter() - t0)
        quarantined += stats.get("quarantined", [])
        if done_at is not None:
            for h in handles:
                if h.done and h.id not in done_at:
                    done_at[h.id] = t0 + walls[-1]
    return lane, handles, walls, joins, quarantined


def request_parity(np, solo, served, name):
    """A served request against its solo run: outputs, spikes and events
    bit for bit; energy and flush at rtol 1e-5, latency at rtol 1e-5 with
    atol 1e-6. Returns the largest relative energy difference."""
    for f in ("outputs", "out_spikes", "events"):
        a, b = getattr(solo, f), getattr(served, f)
        if (a is None) != (b is None) or (
                a is not None and not np.array_equal(a, b)):
            fail(f"{name}: {f} differs from the solo run")
    for f, atol in (("energy", 0.0), ("flush_energy", 0.0),
                    ("latency", 1e-6)):
        a = np.asarray(getattr(solo, f), np.float64)
        b = np.asarray(getattr(served, f), np.float64)
        if a.shape != b.shape or not np.allclose(b, a, rtol=1e-5, atol=atol):
            fail(f"{name}: {f} differs from the solo run beyond rtol 1e-5")
    a, b = solo.energy.astype(np.float64), served.energy.astype(np.float64)
    return float(np.max(np.abs(b - a) / np.maximum(np.abs(a), 1e-30),
                        initial=0.0))


def solo_parity(torch, np, dev, spec, handles, stims, name, **kw):
    """Every served request against ``lasana.simulate`` of its stimulus
    alone on the card; the largest relative energy difference."""
    import repro_torch.lasana as lasana
    worst = 0.0
    for i, (h, x) in enumerate(zip(handles, stims)):
        solo = lasana.simulate(spec, torch.as_tensor(x, device=dev),
                               record_hidden=False, **kw)
        worst = max(worst, request_parity(np, solo, h.result(),
                                          f"{name} request {i}"))
    return worst


def served_lane_line(torch, np, dev, name, spec, sur, width, stims, want,
                     kw=None, smi=None):
    """One lane's run with the launch counters reset just before it and
    read just after it, each request held to its solo run. Returns (lane,
    handles, counts, the line)."""
    from repro_torch.kernels import ops
    skw = dict(kw or {})
    ops.reset_launches()
    lane, handles, walls, joins, _ = serve_lane(torch, spec, sur, width,
                                                stims, skw)
    counts = dict(ops.LAUNCHES)
    check_launches(f"serve {name}", counts,
                   {k: v(len(walls)) for k, v in want.items()})
    if sur is not None:
        skw["surrogates"] = sur
    worst = solo_parity(torch, np, dev, spec, handles, stims,
                        f"serve {name}", **skw)
    res = {"phase": "serve", "lane": name, "slots": width,
           "chunk_ticks": SERVE_CHUNK, "requests": len(stims),
           "steps": len(walls), "join_ticks": joins, "launches": counts,
           "equal_to_solo": True, "energy_max_rel_diff_vs_solo": worst,
           "degraded": [h.degraded for h in handles], "card": smi}
    return lane, handles, counts, res


def serve_snn(torch, np, dev, surs, profile, smi):
    """The 784-128-10 SNN served: 100 digits x 100 ticks as 12 requests of
    1-16 digits on one 32-slot lane at 16 ticks a chunk, admitted as slots
    free. Each digit's spikes against the JAX record, the energy total
    within 1%, each request against its solo run; then a steady run timed
    beside the solo runs of the same requests. Returns (launch counts by
    run, the engine, the requests' stimuli)."""
    import repro_torch.lasana as lasana
    from repro_torch.serve import ServerMetrics
    spec, x_dev, _ = snn_workload(torch, np, dev)
    x_host = x_dev.cpu().numpy()
    stims = split_requests(np, x_host, [(T_STEPS, b) for b in SERVE_SIZES])
    sur = surs["lif"]
    lane, handles, counts, res = served_lane_line(
        torch, np, dev, "snn_784_128_10", spec, sur, SERVE_SLOTS, stims,
        {"network_tick": lambda steps: 2 * SERVE_CHUNK * steps}, smi=smi)
    runs = [h.result() for h in handles]
    rec = dict(np.load(ART / "snn_ref_record.npz"))
    spikes = np.concatenate([(r.out_spikes > 0.75) for r in runs], axis=1)
    agree = float(np.mean(spikes.astype(np.uint8)
                          == rec["lasana/out_spikes"]))
    e_served = float(sum(r.energy.sum() + r.flush_energy.sum()
                         for r in runs))
    e_ref = float(rec["lasana/energy"].sum()
                  + rec["lasana/flush_energy"].sum())
    e_diff = abs(e_served - e_ref) / abs(e_ref)
    if agree < 0.99 or e_diff > 0.01 or not all(
            np.isfinite(r.energy).all() for r in runs):
        fail(f"serve snn: spike agreement {agree:.4f} (< 0.99) or energy "
             f"difference {e_diff:.4%} (> 1%) against the JAX record")
    if sum(g > 0 for g in res["join_ticks"]) <= len(stims) // 2:
        fail(f"serve snn: joins at {res['join_ticks']}: most requests "
             "should join mid-stream")
    # steady: the same requests on a fresh lane of the warm engine, and
    # the same requests run alone
    metrics = ServerMetrics()
    done_at = {}
    t0 = time.perf_counter()
    _, steady, walls, _, _ = serve_lane(torch, spec, sur, SERVE_SLOTS, stims,
                                        metrics=metrics, done_at=done_at)
    served_s = time.perf_counter() - t0
    events = sum(int(h.result().events.sum()) for h in steady)
    x_solo = [torch.as_tensor(x, device=dev) for x in stims]
    solo_walls, solo_events = [], 0
    for x in x_solo:
        t1 = time.perf_counter()
        solo_events += int(lasana.simulate(spec, x, surrogates=sur,
                                           record_hidden=False).events.sum())
        solo_walls.append(time.perf_counter() - t1)
    solo_s = sum(solo_walls)
    lane_lat = [done_at[h.id] - t0 for h in steady]
    snap = metrics.snapshot()
    eng = lane.engine
    res["drive_rows_differing_from_a_32_row_product"] = drive_rows_by_batch(
        torch, eng._weights[0], x_dev[0, :SERVE_SLOTS])
    res.update({"workload": "snn_784_128_10", "digits": N_IMAGES,
                "ticks": T_STEPS, "spike_agreement_vs_ref": agree,
                "energy_j": e_served, "energy_rel_diff_vs_ref": e_diff,
                "steady_s": served_s, "events": events,
                "events_per_s": events / served_s,
                "requests_per_s": len(stims) / served_s,
                "solo_s": solo_s, "solo_events_per_s": solo_events / solo_s,
                "solo_requests_per_s": len(stims) / solo_s,
                "latency_ms_p50": 1e3 * percentile(np, lane_lat, 50),
                "latency_ms_p99": 1e3 * percentile(np, lane_lat, 99),
                "solo_latency_ms_p50": 1e3 * percentile(np, solo_walls, 50),
                "solo_latency_ms_p99": 1e3 * percentile(np, solo_walls, 99),
                "step_ms_first": 1e3 * walls[0],
                "step_ms_median": 1e3 * statistics.median(walls),
                "step_ms_mean": 1e3 * statistics.mean(walls),
                "batch_occupancy": snap["batch_occupancy"],
                "sync_debug_mode": "error"})
    if profile:
        res["profile"] = profile_run(torch, lambda: serve_lane(
            torch, spec, sur, SERVE_SLOTS, stims))
    line(res)
    return {"serve/snn_784_128_10": counts}, lane.engine, stims, res


def percentile(np, values, q):
    """The ``q``-th percentile of ``values`` (numpy's linear rule)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def drive_rows_by_batch(torch, w, u):
    """Rows of the drive product ``u[:m] @ w`` that differ from the same
    rows of the whole ``u @ w``, by m (only the m where some row differs):
    whether a lane's product rounds its rows as a smaller solo batch's."""
    full = u @ w
    out = {}
    for m in range(1, u.shape[0]):
        n = int((u[:m] @ w != full[:m]).any(1).sum())
        if n:
            out[m] = n
    return out


def m_es_scaled(sur, factor):
    """A copy of ``sur`` with its M_ES MLP weight matrices scaled by
    ``factor``: the same structure, other weights."""
    from repro_torch.core.surrogate import Surrogate
    params = {p: {k: a * factor if p == "M_ES" and k.startswith("w") else a
                  for k, a in d.items()} for p, d in sur.params.items()}
    return Surrogate(sur.manifest, params, sur.fit_info)


def serve_hot_swap(torch, np, dev, surs, eng, stims, smi):
    """A second lane of the served SNN's engine with the M_ES weights
    scaled by 1.001: the slot step is built once for both lanes, and
    neither the new lane nor its joins and flushes build anything."""
    slot_keys = lambda: [k for k in eng._runners if k[0] == "slot"]
    builds = eng.compile_count
    swap = m_es_scaled(surs["lif"], SERVE_SWAP_SCALE)
    lane, handles, _, _, _ = serve_lane(torch, eng.spec, swap, SERVE_SLOTS,
                                        stims[:4])
    if len(slot_keys()) != 1 or eng.compile_count != builds \
            or lane.programs.compile_seconds != 0.0:
        fail(f"serve hot swap: {len(slot_keys())} slot steps, "
             f"{eng.compile_count - builds} runners built by the swap")
    worst = solo_parity(torch, np, dev, eng.spec, handles, stims[:4],
                        "serve hot swap", surrogates=swap)
    line({"phase": "serve", "lane": "hot_swap",
          "slot_steps_built": len(slot_keys()),
          "runners_built_by_swap": eng.compile_count - builds,
          "energy_max_rel_diff_vs_solo": worst, "equal_to_solo": True,
          "card": smi})


def serve_other_lanes(torch, np, dev, surs, smi):
    """Heterogeneous lengths on a 16-slot lane, the one-LIF-layer 784-128
    spec (``network_tick_chunk``), the unpackable surrogate
    (``mlp_surrogate_heads``), the mixed crossbar -> LIF net with its
    recurrent edge and a behavioral lane, each request against its solo
    run. Returns launch counts by run."""
    from repro_torch.convert import graph_spec_from_numpy
    from repro_torch.core.surrogate import SurrogateLibrary
    from repro_torch.data.mnist import make_digits
    spec, x_dev, _ = snn_workload(torch, np, dev)
    x_host = x_dev.cpu().numpy()
    with np.load(ART / "snn_784_128_10.npz") as z:
        w0 = z["w0"]
    hidden = graph_spec_from_numpy(
        [{"circuit": "lif", "weight": w0, "params": LIF_KNOBS}])
    with np.load(ART / "mixed_144_24_10.npz") as z:
        w1, w2 = z["w1"].astype(np.float32), z["w2"].astype(np.float32)
    mixed = graph_spec_from_numpy(
        [{"circuit": "crossbar", "weight": w1},
         {"circuit": "lif", "weight": w2, "params": LIF_KNOBS}],
        edges=[(1, 1, -0.4 * (1.0 - np.eye(10, dtype=np.float32)))])
    imgs, _ = make_digits(MIXED_IMAGES, size=12, seed=777)
    volts = (imgs * 1.6 - 0.8).astype(np.float32)
    x_mixed = np.ascontiguousarray(np.broadcast_to(
        volts, (MIXED_TICKS, *volts.shape)))
    library = SurrogateLibrary({"crossbar": surs["crossbar"],
                                "lif": surs["lif"]})
    tick2 = lambda steps: 2 * SERVE_CHUNK * steps
    lanes = (
        ("hetero", spec, surs["lif"], 16,
         split_requests(np, x_host, SERVE_HETERO), {"network_tick": tick2},
         None),
        ("hidden_784_128", hidden, surs["lif"], SERVE_SLOTS,
         split_requests(np, x_host, [(T_STEPS, b) for b in SERVE_SIZES]),
         {"network_tick_chunk": lambda steps: steps,
          "network_tick": lambda steps: 0}, None),
        ("lasana_unpackable", spec, surs["lif_unpackable"], 16,
         split_requests(np, x_host, SERVE_UNPACKABLE),
         {"mlp_surrogate_heads": lambda steps: (">=", SERVE_CHUNK * steps),
          "network_tick": lambda steps: 0}, None),
        ("mixed_144_24_10", mixed, library, SERVE_SLOTS,
         split_requests(np, x_mixed, SERVE_MIXED), {"network_tick": tick2},
         None),
        ("behavioral", spec, None, 16,
         split_requests(np, x_host, SERVE_HETERO[:3]), {},
         dict(backend="behavioral")),
    )
    total = {}
    for name, sp, sur, width, stims, want, kw in lanes:
        _, handles, counts, res = served_lane_line(
            torch, np, dev, name, sp, sur, width, stims, want, kw, smi)
        if any(h.degraded != (name == "behavioral") for h in handles):
            fail(f"serve {name}: handles' degraded flags {res['degraded']}")
        line(res)
        total[f"serve/{name}"] = counts
    return total


def serve_faults(torch, np, dev, surs, eng, stims, smi):
    """Injected faults on the card: a ``surrogate.nan`` burst quarantines
    exactly one request while its co-tenants equal their solo runs and
    the victim, re-admitted alone, equals its own; a ``lane.step`` fire
    raises before any launch and the next step proceeds; ``chunk.stall``
    leaves a stream equal to the monolithic run."""
    import repro_torch.lasana as lasana
    from repro_torch.kernels import ops
    from repro_torch.resilience import FaultInjected, FaultPlan, faults
    spec, sur = eng.spec, surs["lif"]
    reqs = stims[:4]
    plan = FaultPlan(0, {"surrogate.nan": {"at": [2]}})
    with faults.use_plan(plan):
        lane, handles, _, _, quarantined = serve_lane(
            torch, spec, sur, SERVE_SLOTS, reqs)
    if plan.fired["surrogate.nan"] != 1 or len(quarantined) != 1:
        fail(f"serve nan: {len(quarantined)} requests quarantined")
    victim = quarantined[0]
    spared = [(h, x) for h, x in zip(handles, reqs) if h is not victim.handle]
    solo_parity(torch, np, dev, spec, [h for h, _ in spared],
                [x for _, x in spared], "serve nan co-tenant", surrogates=sur)
    victim.handle._reset_for_retry()
    lane.admit(victim.q)
    while lane.active:
        lane.step()
    solo_parity(torch, np, dev, spec, [victim.handle],
                [reqs[victim.handle.id]], "serve nan victim",
                surrogates=sur)
    # lane.step: the first step raises before it launches anything
    import dataclasses

    from repro_torch.serve import Bucket, Lane, RequestHandle
    plan = FaultPlan(0, {"lane.step": {"at": [0]}})
    lane = Lane(eng, spec, Bucket("chip", SERVE_SLOTS, SERVE_CHUNK), sur)
    lane.programs = dataclasses.replace(
        lane.programs, step=no_sync_step(torch, lane.programs.step))
    hs = [RequestHandle(i, "chip") for i in range(2)]
    for h, x in zip(hs, reqs[:2]):
        lane.admit(_Queued(h, x))
    before = sum(ops.LAUNCHES.values())
    with faults.use_plan(plan):
        try:
            lane.step()
            fail("serve lane.step: the planned fault did not fire")
        except FaultInjected:
            pass
        if sum(ops.LAUNCHES.values()) != before or lane.g != 0:
            fail("serve lane.step: the faulted step launched or advanced")
        while lane.active:
            lane.step()
    solo_parity(torch, np, dev, spec, hs, reqs[:2], "serve lane.step",
                surrogates=sur)
    # chunk.stall on the stream: stalls, never changes a record
    x = torch.as_tensor(np.concatenate(reqs[:2], axis=1), device=dev)
    mono = lasana.simulate(spec, x, surrogates=sur, record_hidden=False)
    plan_s = FaultPlan(0, {"chunk.stall": {"rate": 1.0, "max_fires": 3}},
                       stall_seconds=0.01)
    with faults.use_plan(plan_s):
        streamed = lasana.simulate_stream(spec, x, chunk_ticks=SERVE_CHUNK,
                                          surrogates=sur, record_hidden=False)
    same_record(np, streamed, mono, "serve chunk.stall stream")
    if plan_s.fired["chunk.stall"] != 3:
        fail(f"serve chunk.stall fired {plan_s.fired['chunk.stall']} times")
    line({"phase": "serve", "lane": "faults",
          "surrogate_nan": {"quarantined": [victim.handle.id],
                            "co_tenants_equal_solo": True,
                            "victim_readmitted_equal_solo": True},
          "lane_step": {"raised_before_launch": True,
                        "next_steps_equal_solo": True},
          "chunk_stall": {"fired": plan_s.fired["chunk.stall"],
                          "calls": plan_s.calls["chunk.stall"],
                          "stream_equals_monolithic_bitwise": True},
          "card": smi})


def heads_at_serve_shapes(torch, np, dev, sur):
    """``mlp_surrogate_heads`` with the unpackable artifact's stacked
    groups, (M_O, M_V) and (M_ED, M_L), at a 32-slot lane's LIF rows (N
    = 4,096 and 320) against the plain version, timed beside the bound."""
    from repro_torch.kernels import mlp_surrogate
    keys = ("x_mu", "x_sd", "y_mu", "y_sd", "w0", "b0", "w1", "b1", "w2",
            "b2")
    out = {"max_abs_err": 0.0}
    for pnames in (("M_O", "M_V"), ("M_ED", "M_L")):
        s = sur._stacked(pnames)
        stacks = [s[k] for k in keys]
        p, f, h1 = s["w0"].shape
        h2 = s["w1"].shape[2]
        for n in (SERVE_SLOTS * 128, SERVE_SLOTS * 10):
            x = torch.as_tensor(np.random.default_rng(n + f).normal(
                0, 1, (n, f)), dtype=torch.float32, device=dev)
            args = (x, *stacks)
            tag = f"{pnames} n={n}"
            got = mlp_surrogate.mlp_surrogate_heads(*args)
            want = mlp_surrogate.mlp_heads_plain(*args)
            torch.cuda.synchronize()
            err = compare(got, want, f"mlp_surrogate_heads serve {tag}")
            out["max_abs_err"] = max(out["max_abs_err"], err)
            ms, by = heads_bound(x, stacks)
            out[tag] = {
                "shape": f"x ({n}, {f}), P={p}, H1={h1}, H2={h2}",
                "max_abs_err": err,
                "ms": time_ms(lambda: mlp_surrogate.mlp_surrogate_heads(
                    *args), torch),
                "plain_ms": time_ms(lambda: mlp_surrogate.mlp_heads_plain(
                    *args), torch),
                "bound_ms": ms, "bound_by": by}
    return out


def serve_kernel_shapes(torch, np, dev, surs, smi):
    """The three kernels a served lane launches, at a 32-slot lane's
    shapes: ``network_tick`` on the SNN's LIF rows (N = 4,096 and 320),
    ``network_tick_chunk`` on the hidden layer's (N = 4,096, T = 16; also
    against 16 ``network_tick`` launches, bit for bit) and
    ``mlp_surrogate_heads`` (the unpackable artifact's groups), each
    against its plain version, timed beside its bound."""
    from repro_torch.kernels import tick_megakernel as mk
    tick = tick_at_shapes(torch, np, dev, surs["lif"],
                          (SERVE_SLOTS * 128, SERVE_SLOTS * 10),
                          "serve lanes of the SNN, one launch a layer a tick")
    chunk = check_network_tick_chunk(
        torch, np, dev, [("lif packable", *mk.pack_heads(surs["lif"]), True)],
        ns=(SERVE_SLOTS * 128,), t_steps=SERVE_CHUNK)
    heads = heads_at_serve_shapes(torch, np, dev, surs["lif_unpackable"])
    line({"phase": "serve_kernel_shapes", "network_tick": tick,
          "network_tick_chunk": chunk, "mlp_surrogate_heads": heads,
          "card": smi})
    return tick, chunk, heads


def serve_runs(torch, np, dev, surs, profile, smi):
    """The serve phase (``repro_torch.serve.scheduler.Lane`` on the card);
    returns (launch counts by run, the kernels at the lanes' shapes)."""
    total, eng, stims, lane_res = serve_snn(torch, np, dev, surs, profile, smi)
    serve_hot_swap(torch, np, dev, surs, eng, stims, smi)
    total.update(serve_other_lanes(torch, np, dev, surs, smi))
    serve_faults(torch, np, dev, surs, eng, stims, smi)
    return total, serve_kernel_shapes(torch, np, dev, surs, smi), lane_res


# --- the server phase -------------------------------------------------------------

SERVER_TENANTS = 3        # client threads, one tenant each
SERVER_TIMEOUT = 300.0    # seconds any one wait may take
SERVER_HANG = 1.0         # hang_timeout_s of the watchdog case
SERVER_STALL = 3.0        # seconds the stalled chunk sleeps past it
WIRE_TIMEOUT = 600        # seconds the wire subprocess may take
WIRE_RECORD = ART / "serve_wire_record.json"
# stats() entries the driver thread's interleaving cannot move
WIRE_COUNTERS = ("requests_submitted", "requests_completed",
                 "requests_rejected", "requests_failed", "requests_retried",
                 "requests_deadline_exceeded", "requests_degraded",
                 "requests_in_flight", "numerical_faults", "lane_hangs",
                 "ticks_live_total", "events_total", "queue_depth_by_bucket",
                 "degraded_specs", "compile_count", "surrogates")


def run_bounded(fn, timeout, name):
    """``fn()`` on a daemon thread joined with ``timeout``; fail if it is
    still running or raised."""
    import threading
    out = {}

    def target():
        try:
            out["value"] = fn()
        except Exception as err:          # reported below
            out["error"] = err
    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        fail(f"{name}: still running after {timeout} s")
    if "error" in out:
        fail(f"{name}: {type(out['error']).__name__}: {out['error']}")
    return out.get("value")


def submit_clients(srv, stims, sur_ref="lif"):
    """Submit ``stims`` to ``srv`` from :data:`SERVER_TENANTS` client
    threads (request i from thread i % 3, tenant "t<k>"), each then
    waiting for its own results. Returns (handles in request order, submit
    times, times of each request's last chunk)."""
    import threading
    n = len(stims)
    handles, t_sub, t_done, errors = [None] * n, [0.0] * n, [0.0] * n, []

    def client(k):
        try:
            for i in range(k, n, SERVER_TENANTS):
                def on_chunk(rec, i=i):
                    t_done[i] = time.perf_counter()
                t_sub[i] = time.perf_counter()
                handles[i] = srv.submit("snn", stims[i], surrogates=sur_ref,
                                        tenant=f"t{k}", on_chunk=on_chunk)
            for i in range(k, n, SERVER_TENANTS):
                handles[i].result(timeout=SERVER_TIMEOUT)
        except Exception as err:          # reported below
            errors.append(err)
    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(SERVER_TENANTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(SERVER_TIMEOUT)
    if any(t.is_alive() for t in threads) or errors:
        fail(f"server clients: {errors or 'a client thread hung'}")
    return handles, t_sub, t_done


def time_steps(srv, srv_steps, lane_steps):
    """Time each working ``SimServer.step`` of ``srv`` and each
    ``Lane.step`` on the host, and count the kernel libraries loaded and
    the runners built inside lane steps (none may be); returns the undo."""
    from repro_torch.kernels import _build
    from repro_torch.serve import Lane
    srv_step, lane_step = srv.step, Lane.step

    def step():
        t0 = time.perf_counter()
        worked = srv_step()
        if worked:
            srv_steps.append(time.perf_counter() - t0)
        return worked

    def lane_timed(lane):
        libs, builds = _build.n_loaded(), lane.engine.compile_count
        t0 = time.perf_counter()
        out = lane_step(lane)
        lane_steps.append((time.perf_counter() - t0,
                           _build.n_loaded() - libs,
                           lane.engine.compile_count - builds))
        return out
    srv.step = step                       # the driver looks it up a round
    Lane.step = lane_timed

    def undo():
        Lane.step = lane_step
        del srv.step
    return undo


def spikes_vs_record(np, runs, key="lasana"):
    """The served SNN's spikes against the JAX record: (agreement, energy
    total, its relative difference)."""
    rec = dict(np.load(ART / "snn_ref_record.npz"))
    spikes = np.concatenate([(r.out_spikes > 0.75) for r in runs], axis=1)
    agree = float(np.mean(spikes.astype(np.uint8) == rec[f"{key}/out_spikes"]))
    e = float(sum(r.energy.sum() + r.flush_energy.sum() for r in runs))
    e_ref = float(rec[f"{key}/energy"].sum() + rec[f"{key}/flush_energy"].sum())
    return agree, e, abs(e - e_ref) / abs(e_ref)


def server_snn(torch, np, dev, smi, lane_res):
    """(a) The served SNN's 12 requests through ``lasana.serve`` on the
    card, submitted by three client threads as three tenants, the
    artifact registered by path (loaded once, on the card) and the spec by
    name: each request against its solo run, the spikes against the JAX
    record, the build count against one lane's; then the same requests
    again on the warm server, timed beside the ``Lane``-only run and the
    solo runs of the serve phase; then once more on an unthreaded server
    (``run_until_idle`` on this thread, every slot step under sync debug
    mode "error", as the ``Lane``-only run's): what the driver thread
    costs. Returns (launch counts, spec, stimuli, the loaded
    surrogate)."""
    import dataclasses

    import repro_torch.lasana as lasana
    from repro_torch.convert import spec_from_numpy
    from repro_torch.core.network import NetworkEngine
    from repro_torch.kernels import ops
    from repro_torch.serve import Bucket, Lane, ServeConfig, SimServer
    spec, x_dev, _ = snn_workload(torch, np, dev)
    stims = split_requests(np, x_dev.cpu().numpy(),
                           [(T_STEPS, b) for b in SERVE_SIZES])
    srv_steps, lane_steps = [], []
    ops.reset_launches()
    srv = lasana.serve(slot_widths=(SERVE_SLOTS,), chunk_ticks=SERVE_CHUNK)
    undo = time_steps(srv, srv_steps, lane_steps)
    try:
        srv.register_surrogate_path("lif", str(ART / "lif_packable.npz"))
        srv.register_spec("snn", spec)
        t0 = time.perf_counter()
        handles, _, _ = submit_clients(srv, stims)
        cold_s = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        cold = srv.stats()
        cold_steps, cold_lane = list(srv_steps), list(lane_steps)
        builds = srv.compile_count()
        m = srv.metrics
        occ0, chunks0, events0 = m.occupancy_sum, m.chunks_total, m.events_total
        del srv_steps[:], lane_steps[:]
        t0 = time.perf_counter()
        steady, t_sub, t_done = submit_clients(srv, stims)
        steady_s = time.perf_counter() - t0
        occupancy = (m.occupancy_sum - occ0) / (m.chunks_total - chunks0)
        events = m.events_total - events0
        sur = srv.store.get("lif")
    finally:
        undo()
        srv.close(timeout=60)
    eng = lasana.engine(spec, record_hidden=False)     # the server's engine
    slot_programs = eng.slot_programs

    def checked(*args, **kw):
        programs = slot_programs(*args, **kw)
        return dataclasses.replace(programs,
                                   step=no_sync_step(torch, programs.step))
    eng.slot_programs = checked
    local = SimServer(ServeConfig(slot_widths=(SERVE_SLOTS,),
                                  chunk_ticks=SERVE_CHUNK))
    local.register_surrogate("lif", sur)
    local.register_spec("snn", spec)
    local_steps, local_lane = [], []
    undo = time_steps(local, local_steps, local_lane)
    try:
        unthreaded = [local.submit("snn", x, surrogates="lif",
                                   tenant=f"t{i % SERVER_TENANTS}")
                      for i, x in enumerate(stims)]
        t0 = time.perf_counter()
        local.run_until_idle()
        local_s = time.perf_counter() - t0
    finally:
        undo()
        del eng.slot_programs
    check_launches("server snn", counts,
                   {"network_tick": 2 * SERVE_CHUNK * cold["chunks_total"]})
    if any(libs or built for _, libs, built in cold_lane + lane_steps):
        fail("server snn: a lane step loaded a kernel library or built a "
             "runner")
    if sur.device != dev:
        fail(f"server snn: the artifact loaded onto {sur.device}")
    with np.load(ART / "snn_784_128_10.npz") as z:
        probe_spec = spec_from_numpy([z["w0"], z["w1"]],
                                     [np.array(LIF_KNOBS, np.float32)] * 2)
    probe = NetworkEngine(probe_spec, record_hidden=False)
    Lane(probe, probe_spec, Bucket("probe", SERVE_SLOTS, SERVE_CHUNK), sur)
    if builds != probe.compile_count or cold["n_lanes"] != 1:
        fail(f"server snn: compile_count {builds} against one lane's "
             f"{probe.compile_count}, {cold['n_lanes']} lanes")
    worst = solo_parity(torch, np, dev, spec, handles, stims, "server snn",
                        surrogates=sur)
    solo_parity(torch, np, dev, spec, steady, stims, "server snn steady",
                surrogates=sur)
    solo_parity(torch, np, dev, spec, unthreaded, stims,
                "server snn unthreaded", surrogates=sur)
    agree, e_served, e_diff = spikes_vs_record(np, [h.result()
                                                    for h in handles])
    if agree < 0.99 or e_diff > 0.01:
        fail(f"server snn: spike agreement {agree:.4f} (< 0.99) or energy "
             f"difference {e_diff:.4%} (> 1%) against the JAX record")
    lat = [d - s for s, d in zip(t_sub, t_done)]
    steps_ms = [1e3 * s for s in srv_steps]
    lane_ms = [1e3 * s for s, _, _ in lane_steps]
    res = {"phase": "server", "part": "snn_784_128_10",
           "slots": SERVE_SLOTS, "chunk_ticks": SERVE_CHUNK,
           "requests": len(stims), "tenants": SERVER_TENANTS,
           "launches": counts, "equal_to_solo": True,
           "energy_max_rel_diff_vs_solo": worst,
           "spike_agreement_vs_ref": agree, "energy_j": e_served,
           "energy_rel_diff_vs_ref": e_diff, "compile_count": builds,
           "one_lane_builds": probe.compile_count,
           "first_round": {
               "wall_s": cold_s, "chunks": cold["chunks_total"],
               "server_step_ms_first": 1e3 * cold_steps[0],
               "lane_step_ms_first": 1e3 * cold_lane[0][0],
               "lane_step_ms_mean": 1e3 * statistics.mean(
                   s for s, _, _ in cold_lane)},
           "steady": {
               "wall_s": steady_s, "events": events,
               "requests_per_s": len(stims) / steady_s,
               "events_per_s": events / steady_s,
               "latency_ms_p50": percentile(np, lat, 50) * 1e3,
               "latency_ms_p99": percentile(np, lat, 99) * 1e3,
               "server_step_ms_first": steps_ms[0],
               "server_step_ms_mean": statistics.mean(steps_ms),
               "server_steps": len(steps_ms),
               "lane_step_ms_mean": statistics.mean(lane_ms),
               "batch_occupancy": occupancy},
           "unthreaded": {
               "wall_s": local_s, "requests_per_s": len(stims) / local_s,
               "events_per_s": events / local_s,
               "server_step_ms_mean": 1e3 * statistics.mean(local_steps),
               "server_steps": len(local_steps),
               "lane_step_ms_mean": 1e3 * statistics.mean(
                   s for s, _, _ in local_lane),
               "sync_debug_mode": "error"},
           "lane_only": {k: lane_res[k] for k in (
               "steady_s", "requests_per_s", "events_per_s",
               "latency_ms_p50", "latency_ms_p99", "step_ms_first",
               "step_ms_mean", "batch_occupancy")},
           "solo": {k: lane_res[k] for k in (
               "solo_s", "solo_requests_per_s", "solo_events_per_s",
               "solo_latency_ms_p50", "solo_latency_ms_p99")},
           "card": smi}
    line(res)
    return {"server/snn_784_128_10": counts}, spec, stims, sur


def server_hot_swap(torch, np, dev, spec, stims, sur, smi):
    """(b) ``lif`` version 2 (M_ES weights x 1.001) registered while
    version-1 requests are in flight: they keep version 1, new requests
    resolve to version 2, each equal to its version's solo run, and the
    swap builds no runner."""
    import threading

    import repro_torch.lasana as lasana
    eng = lasana.engine(spec, record_hidden=False)
    srv = lasana.serve(slot_widths=(SERVE_SLOTS,), chunk_ticks=SERVE_CHUNK)
    try:
        srv.register_surrogate("lif", sur)
        srv.register_spec("snn", spec)
        started = threading.Event()
        v1 = [srv.submit("snn", x, surrogates="lif",
                         on_chunk=lambda rec: started.set())
              for x in stims[:4]]
        if not started.wait(SERVER_TIMEOUT):
            fail("server hot swap: no version-1 chunk arrived")
        builds = eng.compile_count
        v2_sur = m_es_scaled(sur, SERVE_SWAP_SCALE)
        if srv.register_surrogate("lif", v2_sur) != 2:
            fail("server hot swap: the swap did not mint version 2")
        in_flight = sum(not h.done for h in v1)
        v2 = [srv.submit("snn", x, surrogates="lif") for x in stims[4:8]]
        for h in v1 + v2:
            h.result(timeout=SERVER_TIMEOUT)
        st = srv.stats()
    finally:
        srv.close(timeout=60)
    if in_flight == 0:
        fail("server hot swap: no version-1 request was in flight")
    if any(h.surrogate_ref != ("lif", 1) for h in v1) or any(
            h.surrogate_ref != ("lif", 2) for h in v2):
        fail("server hot swap: requests resolved to the wrong versions")
    if st["surrogates"] != {"lif": [1, 2]} or eng.compile_count != builds:
        fail(f"server hot swap: surrogates {st['surrogates']}, "
             f"{eng.compile_count - builds} runners built by the swap")
    w1 = solo_parity(torch, np, dev, spec, v1, stims[:4],
                     "server hot swap v1", surrogates=sur)
    w2 = solo_parity(torch, np, dev, spec, v2, stims[4:8],
                     "server hot swap v2", surrogates=v2_sur)
    line({"phase": "server", "part": "hot_swap",
          "v1_in_flight_at_swap": in_flight,
          "runners_built_by_swap": eng.compile_count - builds,
          "surrogates": st["surrogates"], "n_lanes": st["n_lanes"],
          "energy_max_rel_diff_vs_solo": max(w1, w2), "equal_to_solo": True,
          "card": smi})


def server_faults(torch, np, dev, spec, stims, sur, smi):
    """(c) One fault plan each, at the SNN's width, unthreaded
    (``run_until_idle``): a ``lane.step`` retry, a ``surrogate.nan``
    quarantine that degrades the spec to the behavioral backend, a
    ``chunk.stall`` past the watchdog's limit, a truncated artifact
    registered by path and an already-expired deadline."""
    import repro_torch.lasana as lasana
    from repro_torch.resilience import FaultPlan, faults
    from repro_torch.serve import (ArtifactError, DeadlineExceeded,
                                   ServeConfig, SimServer)

    def server(**cfg):
        srv = SimServer(ServeConfig(slot_widths=(SERVE_SLOTS,),
                                    chunk_ticks=SERVE_CHUNK,
                                    retry_backoff_ms=0.0, **cfg))
        srv.register_surrogate("lif", sur)
        return srv

    def behavioral(h, x, name):
        solo = lasana.simulate(spec, torch.as_tensor(x, device=dev),
                               backend="behavioral", record_hidden=False)
        request_parity(np, solo, h.result(timeout=5), name)

    res = {"phase": "server", "part": "faults", "card": smi}
    a, b, c = stims[1], stims[3], stims[5]          # 3, 1 and 5 digits
    # lane.step: the retried request replays from scratch
    srv = server(max_retries=1)
    with faults.use_plan(FaultPlan(0, {"lane.step": {"at": [0]}})):
        h = srv.submit(spec, a, surrogates="lif")
        srv.run_until_idle()
    st = srv.stats()
    if st["requests_retried"] != 1 or h.attempts != 2:
        fail(f"server lane.step: {st['requests_retried']} retried, "
             f"{h.attempts} attempts")
    solo_parity(torch, np, dev, spec, [h], [a], "server lane.step",
                surrogates=sur)
    res["lane_step"] = {"requests_retried": 1, "attempts": 2,
                        "equal_to_solo": True}
    # surrogate.nan: the victim is retried on the behavioral fallback
    srv = server(max_retries=1, degrade_after=1)
    with faults.use_plan(FaultPlan(0, {"surrogate.nan": {"at": [0]}})):
        hs = [srv.submit(spec, x, surrogates="lif") for x in (a, b)]
        srv.run_until_idle()
        hc = srv.submit(spec, c, surrogates="lif")
        srv.run_until_idle()
    st = srv.stats()
    victims = [i for i, h in enumerate(hs) if h.attempts == 2]
    if len(victims) != 1 or not st["degraded_specs"] or not hc.degraded \
            or st["numerical_faults"] != 1:
        fail(f"server surrogate.nan: victims {victims}, degraded_specs "
             f"{st['degraded_specs']}, later request degraded {hc.degraded}")
    (v,) = victims
    if not hs[v].degraded or hs[1 - v].degraded:
        fail("server surrogate.nan: the retried victim should be degraded "
             "and its co-tenant not")
    behavioral(hs[v], (a, b)[v], "server surrogate.nan victim")
    behavioral(hc, c, "server surrogate.nan later request")
    solo_parity(torch, np, dev, spec, [hs[1 - v]], [(a, b)[1 - v]],
                "server surrogate.nan co-tenant", surrogates=sur)
    res["surrogate_nan"] = {"victim": v, "requests_degraded":
                            st["requests_degraded"],
                            "degraded_specs": st["degraded_specs"],
                            "degraded_equal_to_behavioral_solo": True}
    # chunk.stall past hang_timeout_s: the watchdog fails the lane's request
    srv = server(hang_timeout_s=SERVER_HANG)
    plan = FaultPlan(0, {"chunk.stall": {"at": [0], "max_fires": 1}},
                     stall_seconds=SERVER_STALL)
    t0 = time.perf_counter()
    with faults.use_plan(plan):
        h1 = srv.submit(spec, a, surrogates="lif")
        srv.run_until_idle()
        h2 = srv.submit(spec, b, surrogates="lif")
        srv.run_until_idle()
    stall_s = time.perf_counter() - t0
    try:
        h1.result(timeout=5)
        fail("server chunk.stall: the stalled request completed")
    except RuntimeError as err:
        if "watchdog" not in str(err):
            fail(f"server chunk.stall: {err}")
    st = srv.stats()
    if st["lane_hangs"] != 1 or st["requests_failed"] != 1:
        fail(f"server chunk.stall: {st['lane_hangs']} hangs, "
             f"{st['requests_failed']} failed")
    solo_parity(torch, np, dev, spec, [h2], [b], "server chunk.stall next",
                surrogates=sur)
    res["chunk_stall"] = {"hang_timeout_s": SERVER_HANG,
                          "stall_seconds": SERVER_STALL, "lane_hangs": 1,
                          "next_request_equal_to_solo": True,
                          "seconds": stall_s}
    # a truncated copy of the artifact: only its requester fails
    cut = ROOT / "build" / "chip_smoke" / "lif_truncated.npz"
    cut.parent.mkdir(parents=True, exist_ok=True)
    data = (ART / "lif_packable.npz").read_bytes()
    cut.write_bytes(data[:len(data) // 2])
    srv = server()
    srv.register_surrogate_path("cut", str(cut))
    try:
        srv.submit(spec, a, surrogates="cut")
        fail("server truncated artifact: the request was accepted")
    except ArtifactError as err:
        message = str(err)
    h = srv.submit(spec, b, surrogates="lif")
    srv.run_until_idle()
    solo_parity(torch, np, dev, spec, [h], [b], "server truncated artifact",
                surrogates=sur)
    res["truncated_artifact"] = {"error": message[:160],
                                 "other_request_equal_to_solo": True}
    # an already-expired deadline: fails in the queue, takes no slot
    srv = server()
    h = srv.submit(spec, a, surrogates="lif", deadline_ms=1e-3)
    time.sleep(0.01)
    srv.run_until_idle()
    st = srv.stats()
    try:
        h.result(timeout=5)
        fail("server deadline: the expired request completed")
    except DeadlineExceeded:
        pass
    if st["n_lanes"] != 0 or st["requests_deadline_exceeded"] != 1 \
            or st["chunks_total"] != 0:
        fail(f"server deadline: {st['n_lanes']} lanes, "
             f"{st['chunks_total']} chunks")
    res["deadline"] = {"requests_deadline_exceeded": 1, "n_lanes": 0}
    line(res)


def wire_ops(np, script):
    """The wire record's script as protocol ops: the artifact's basename
    becomes its path under ``ART``, the weights file's the SNN's weights as
    nested lists (``tests/test_torch_fixtures.py:wire_ops``)."""
    ops = []
    for op in script:
        op = dict(op)
        if "path" in op:
            op["path"] = str(ART / op["path"])
        if isinstance(op.get("snn", {}).get("weights"), str):
            with np.load(ART / op["snn"]["weights"]) as z:
                ws = [z[f"w{i}"] for i in range(len(z.files))]
            op["snn"] = dict(op["snn"], weights=[
                np.asarray(w, np.float32).tolist() for w in ws])
        ops.append(op)
    return ops


def wire_rows(resp):
    return resp["results"] if "results" in resp else [resp]


def compare_wire(np, got, want, name, energy_rtol, agree):
    """Response by response: ``ok``, ``ticks`` (and ``id``, ``events``,
    names and versions, ``degraded``) equal; ``energy_j`` within
    ``energy_rtol``; output spike counts equal on at least ``agree`` of
    them all; ``stats`` with the same keys and :data:`WIRE_COUNTERS`.
    Returns (agreement, the largest relative energy difference)."""
    if len(got) != len(want):
        fail(f"{name}: {len(got)} responses, expected {len(want)}")
    same = total = 0
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("ok", "id", "name", "version", "shutdown"):
            if g.get(k) != w.get(k):
                fail(f"{name}: response {i} {k} {g.get(k)} != {w.get(k)}")
        if "stats" in w:
            if set(g["stats"]) != set(w["stats"]) or any(
                    g["stats"][k] != w["stats"][k] for k in WIRE_COUNTERS):
                fail(f"{name}: stats differ")
        if "ticks" not in w and "results" not in w:
            continue
        for a, b in zip(wire_rows(w), wire_rows(g)):
            for k in ("ok", "id", "ticks", "events", "degraded"):
                if a[k] != b[k]:
                    fail(f"{name}: {a['id']} {k} {b[k]} != {a[k]}")
            oa, ob = np.asarray(a["outputs"]), np.asarray(b["outputs"])
            if oa.shape != ob.shape:
                fail(f"{name}: {a['id']} outputs of shape {ob.shape}")
            same += int((oa == ob).sum())
            total += oa.size
            d = abs(b["energy_j"] - a["energy_j"]) / abs(a["energy_j"])
            worst = max(worst, d)
            if d > energy_rtol:
                fail(f"{name}: {a['id']} energy differs by {d:.3e}")
    if same < agree * total:
        fail(f"{name}: output spike counts agree on {same} of {total}")
    return same / total, worst


def server_wire(torch, np, dev, smi):
    """(d) ``python -m repro_torch.serve --slot-widths 32 --chunk-ticks
    16`` as a subprocess on the card, fed the wire record's script on
    stdin: exits 0; every response equal to the same script run in this
    process (discrete fields equal, energy rtol 1e-5) and to the committed
    JAX record of the reference's responses (output spike counts >= 99%
    equal, energy within 1%, ``ticks`` and ``ok`` equal)."""
    import io

    import repro_torch.lasana as lasana
    from repro_torch.kernels import ops
    from repro_torch.serve import run_stdio
    rec = json.loads(WIRE_RECORD.read_text())
    text = "".join(json.dumps(o) + "\n" for o in wire_ops(np, rec["script"]))
    widths = ",".join(str(w) for w in rec["slot_widths"])
    env = ops.child_env(ROOT / "src")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--slot-widths", widths,
         "--chunk-ticks", str(rec["chunk_ticks"])], input=text,
        capture_output=True, text=True, timeout=WIRE_TIMEOUT, env=env,
        cwd=ROOT)
    wire_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"server wire: exit {proc.returncode}: {proc.stderr[-2000:]}")
    wire = [json.loads(l) for l in proc.stdout.splitlines()]
    ops.reset_launches()
    out = io.StringIO()
    srv = lasana.serve(slot_widths=tuple(rec["slot_widths"]),
                       chunk_ticks=rec["chunk_ticks"])
    try:
        t0 = time.perf_counter()
        run_bounded(lambda: run_stdio(srv, io.StringIO(text), out),
                    SERVER_TIMEOUT, "server wire in process")
        local_s = time.perf_counter() - t0
    finally:
        srv.close(timeout=60)
    counts = dict(ops.LAUNCHES)
    local = [json.loads(l) for l in out.getvalue().splitlines()]
    _, local_diff = compare_wire(np, wire, local, "server wire vs in process",
                                 1e-5, 1.0)
    agree, ref_diff = compare_wire(np, wire, rec["responses"],
                                   "server wire vs the JAX record", 0.01,
                                   0.99)
    line({"phase": "server", "part": "wire", "ops": len(wire),
          "exit_code": proc.returncode, "subprocess_s": wire_s,
          "in_process_s": local_s,
          "energy_max_rel_diff_vs_in_process": local_diff,
          "output_agreement_vs_ref": agree,
          "energy_max_rel_diff_vs_ref": ref_diff,
          "stderr_tail": proc.stderr.strip().splitlines()[-1:],
          "launches_in_process": counts, "card": smi})
    return {"server/wire_in_process": counts}


def server_runs(torch, np, dev, smi, lane_res):
    """The server phase (``repro_torch.serve.SimServer`` on the card);
    returns launch counts by run."""
    total, spec, stims, sur = server_snn(torch, np, dev, smi, lane_res)
    server_hot_swap(torch, np, dev, spec, stims, sur, smi)
    server_faults(torch, np, dev, spec, stims, sur, smi)
    total.update(server_wire(torch, np, dev, smi))
    return total


# --- the dry run and its reckoning against the card -----------------------

DRYRUN_CELL = ("starcoder2-3b", "decode_32k")   # a production cell, (16, 16)
DRYRUN_TICK_N = 1 << 20      # dryrun_lasana's circuits
DRYRUN_PEAK_REL = 0.2        # the dry run's peak against the card's
DRYRUN_PROMPT = 512          # the lm_serve phase's batch 8 x 512
DRYRUN_BATCH = 8


def tensor_bytes(tensors) -> int:
    """Bytes of ``tensors`` (each distinct tensor once)."""
    seen = {}
    for t in tensors:
        seen[(t.data_ptr(), tuple(t.shape))] = t.numel() * t.element_size()
    return sum(seen.values())


def dryrun_phase(torch, dev, surs, smi):
    """Phase dryrun: ``run_cell`` of a production cell (StarCoder2-3B
    decode_32k on the (16, 16) meta mesh) and ``dryrun_lasana.run`` of one
    tick of 2^20 LIF circuits on it with the committed artifact: each
    record's per-device numbers, roofline terms and seconds; the card's
    allocation unchanged across the phase, its peak never above it, and
    no kernel launched."""
    import gc
    import tempfile
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, dryrun_lasana
    # earlier phases' garbage is collected first: a collection inside the
    # phase would free card memory the dry run never held
    gc.collect()
    torch.cuda.synchronize(dev)
    alloc = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        rec = dryrun.run_cell(*DRYRUN_CELL, multi_pod=False, out_dir=out,
                              force=True)
    if rec["status"] != "ok":
        fail(f"dryrun {rec['cell']}: {rec.get('error')}")
    t_cell = time.perf_counter() - t0
    t1 = time.perf_counter()
    tick = dryrun_lasana.run(surs["lif"], n=DRYRUN_TICK_N, out_dir=None)
    t_tick = time.perf_counter() - t1
    gc.collect()
    torch.cuda.synchronize(dev)
    after, peak = (torch.cuda.memory_allocated(dev),
                   torch.cuda.max_memory_allocated(dev))
    if after != alloc or peak != alloc:
        fail(f"dryrun: the card's allocation moved from {alloc} to "
             f"{after} bytes (peak {peak})")
    if ops.LAUNCHES != before:
        fail(f"dryrun launched kernels: {before} -> {ops.LAUNCHES}")

    def brief(r):
        return {"cell": r["cell"], "n_devices": r["n_devices"],
                "memory": r["memory"], "cost": r["cost"],
                "collectives": r["collectives"], "kernels": r["kernels"],
                "roofline": r["roofline"], "lower_s": r["lower_s"]}
    return {"cell": {**brief(rec), "runs": rec["runs"],
                     "model_flops_total": rec["model_flops_total"],
                     "seconds": t_cell},
            "tick": {**brief(tick), "seconds": t_tick},
            "allocated_bytes": alloc, "peak_bytes": peak,
            "allocation_unchanged": True,
            "launches_unchanged": True, "card": smi}


def dryrun_lm_check(torch, dev, kind):
    """The dry run of StarCoder2-3B at full width and depth (bf16) on a
    (1, 1) mesh against the same step on the card: prefill at batch 8 x
    512, or one decode step against an 8 x 512 cache (the prompt's 511
    tokens prefilled, the step at position 511, as the dry run's decode
    cell steps at its last slot)."""
    from repro_torch import tree as tr
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.sharding import train_rules
    cfg = lm_config()
    mesh = make_mesh((1, 1), ("data", "model"), ["meta"])
    shape = ShapeConfig(kind, DRYRUN_PROMPT, DRYRUN_BATCH, kind)
    lw = dryrun.lower(cfg, shape, mesh, train_rules(mesh))
    d = lw.device
    model = Model(cfg)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(26)
    params = model.init(gen, dev)
    tokens = torch.randint(0, cfg.vocab, (DRYRUN_BATCH, DRYRUN_PROMPT),
                           dtype=torch.int32, device=dev, generator=gen)
    with torch.no_grad():
        if kind == "prefill":
            args = [*tr.leaves(params), tokens]
            step = lambda: model.prefill(               # noqa: E731
                params, {"tokens": tokens}, max_seq=DRYRUN_PROMPT)
        else:
            _, cache = model.prefill(params, {"tokens": tokens[:, :-1]},
                                     max_seq=DRYRUN_PROMPT)
            tok = tokens[:, -1:].contiguous()
            del tokens
            args = [*tr.leaves(params), *tr.leaves(cache["stacks"]), tok]
            step = lambda: model.decode(                # noqa: E731
                params, {"stacks": cache["stacks"],
                         "pos": DRYRUN_PROMPT - 1}, tok)
        arg_bytes = tensor_bytes(args)
        step()                           # warm: the timed call builds nothing
        torch.cuda.synchronize(dev)
        resident = torch.cuda.memory_allocated(dev) - base
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base
        del out
        if kind == "decode":
            cache["stacks"] = None
    if arg_bytes != d.argument_bytes:
        fail(f"dryrun_check {kind}: argument bytes {d.argument_bytes} "
             f"reckoned, {arg_bytes} placed on the card")
    rel = abs(d.peak_live_bytes - peak) / peak
    if rel > DRYRUN_PEAK_REL:
        fail(f"dryrun_check {kind}: peak {d.peak_live_bytes} reckoned, "
             f"{peak} on the card ({rel:.3f} > {DRYRUN_PEAK_REL})")
    from repro_torch.launch import roofline as rf
    roof = rf.roofline(d.cost.cost_analysis(),
                       rf.CollectiveStats({}, {}, d.cost.wire_bytes),
                       model_flops_total=rf.model_flops(cfg, shape),
                       n_devices=1)
    bound_s = max(roof.compute_s, roof.memory_s, roof.collective_s)
    del params, args
    return {"shape": f"batch {DRYRUN_BATCH} x {DRYRUN_PROMPT}",
            "argument_bytes": d.argument_bytes, "placed_bytes": arg_bytes,
            "allocated_for_arguments": resident,
            "peak_live_bytes": d.peak_live_bytes, "card_peak_bytes": peak,
            "peak_rel": rel, "flops": d.cost.flops, "bytes": d.cost.bytes,
            "roofline": roof.as_dict(), "roofline_s": bound_s,
            "step_s": wall, "share_of_roofline": bound_s / wall,
            "dry_run_s": lw.trace_s}


def dryrun_tick_check(torch, dev, surs):
    """One Algorithm-1 tick of 2^20 LIF circuits on one mesh entry: the
    dry run (``lower_distributed_step``) against the same tick on the
    card, and the tick's roofline beside ``network_tick``'s time."""
    from repro_torch.core.distributed import (_tick_body,
                                              lower_distributed_step)
    from repro_torch.core.wrapper import LasanaState
    from repro_torch.kernels import tick_megakernel as mk
    from repro_torch.launch import hlo_cost
    from repro_torch.launch import roofline as rf
    from repro_torch.launch.mesh import make_mesh
    n, sur = DRYRUN_TICK_N, surs["lif"]
    mesh = make_mesh((1, 1), ("data", "model"), ["meta"])
    d = hlo_cost.per_device(lower_distributed_step(
        sur, mesh, n, 3, 4, clock_ns=5.0, spiking=True))
    gen = torch.Generator(device=dev).manual_seed(27)
    state = LasanaState(
        v=torch.rand(n, device=dev, generator=gen),
        o=torch.zeros(n, device=dev),
        t_last=torch.zeros(n, device=dev),
        params=torch.rand(n, 4, device=dev, generator=gen))
    changed = torch.rand(n, device=dev, generator=gen) < 0.5
    x = torch.rand(n, 3, device=dev, generator=gen)
    t = torch.full((1,), 10.0, device=dev)
    sur_arrays = [a for p in sur.params.values() for a in p.values()]
    arg_bytes = tensor_bytes([*state, changed, x, t, *sur_arrays])
    body = _tick_body(clock_ns=5.0, spiking=True)
    with torch.no_grad():
        # a warm call grows network_tick's cached park scratch: the step's
        # peak is its arguments plus what it allocates above them
        body(sur, state, changed, x, t)
        torch.cuda.synchronize(dev)
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = body(sur, state, changed, x, t)
        torch.cuda.synchronize(dev)
        peak = arg_bytes + torch.cuda.max_memory_allocated(dev) - start
        del out
        pack, layout = mk.pack_heads(sur)
        kernel_ms = time_ms(lambda: mk.network_tick(
            pack, state.v, state.o, state.t_last, state.params, changed, x,
            t[0], None, circuit="lif", clock_ns=5.0, layout=layout,
            spiking=True), torch)
    if arg_bytes != d.argument_bytes:
        fail(f"dryrun_check tick: argument bytes {d.argument_bytes} "
             f"reckoned, {arg_bytes} placed on the card")
    rel = abs(d.peak_live_bytes - peak) / peak
    if rel > DRYRUN_PEAK_REL:
        fail(f"dryrun_check tick: peak {d.peak_live_bytes} reckoned, {peak} "
             f"on the card ({rel:.3f} > {DRYRUN_PEAK_REL})")
    roof = rf.roofline(d.cost.cost_analysis(),
                       rf.CollectiveStats({}, {}, d.cost.wire_bytes),
                       model_flops_total=1.0, n_devices=1)
    tick_bound = bound(mk.work(pack, layout, "lif", n, 3, 4))
    return {"n": n, "argument_bytes": d.argument_bytes,
            "placed_bytes": arg_bytes, "peak_live_bytes": d.peak_live_bytes,
            "card_peak_bytes": peak, "peak_rel": rel,
            "roofline": roof.as_dict(),
            "roofline_s": max(roof.compute_s, roof.memory_s),
            "network_tick_ms": kernel_ms,
            "network_tick_bound_ms": tick_bound[0],
            "network_tick_bound_by": tick_bound[1]}


def dryrun_check(torch, dev, surs, smi):
    """Phase dryrun_check: the dry run's reckoning held to the card on
    cells one H100 runs: argument bytes equal, peak within 20%; the
    roofline's time beside the measured one (reported)."""
    out = {kind: dryrun_lm_check(torch, dev, kind)
           for kind in ("prefill", "decode")}
    out["tick"] = dryrun_tick_check(torch, dev, surs)
    return {**out, "limit_peak_rel": DRYRUN_PEAK_REL, "card": smi}


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def add_counts(total, run_name, counts):
    """Fold one run's launch counts into ``{kernel: {run: n}}``."""
    for kernel, n in counts.items():
        if n:
            total.setdefault(kernel, {})[run_name] = n


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one steady run of each main-path "
                         "simulation and print device time by kernel")
    ap.add_argument("--digests", action="store_true",
                    help="only print the digests of the head and tick "
                         "kernels' outputs on the check cases")
    ap.add_argument("--src", help="with --digests: import repro_torch from "
                                  "this src directory (another commit's "
                                  "kernels on the same inputs)")
    ap.add_argument("--parent", help="a src directory of another commit: "
                                     "its golden kernels' times at the main "
                                     "path's shapes (--digests --src in a "
                                     "subprocess) go beside this tree's")
    args = ap.parse_args()
    if args.src:
        sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import tick_megakernel as mk
    from repro_torch.lasana import load

    smi = nvidia_smi()
    line(smi)
    dev = ops.resolve_device("cuda")
    line({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi})

    secs = _build.build_all()
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in _build.SOURCES}
    line({"phase": "build", "seconds": secs, "ptxas": ptxas})

    surs = {name: load(str(ART / f"{file}.npz")) for name, file in (
        ("lif", "lif_packable"), ("lif_unpackable", "lif_unpackable"),
        ("crossbar", "crossbar_packable"),
        ("crossbar_unpackable", "crossbar_unpackable"),
        ("lif_wide", "lif_wide_200_50"))}
    if args.digests:
        print_digests(torch, np, dev, surs)
        return 0
    line({"phase": "routing_rule", **check_routing_rule()})
    line({"phase": "quot_check", **check_quot(torch, np, dev)})
    parent = parent_times(args.parent) if args.parent else None
    times = shape_times(torch, np, dev)
    cases = tick_cases(torch, np, dev, surs)
    heads, single = check_mlp_heads(torch, np, dev, surs, times)
    checks = {
        "crossbar_target": check_crossbar(torch, np, dev, times),
        "lif_step": check_lif(torch, np, dev, times),
        "mlp_surrogate_heads": heads,
        "network_tick": check_network_tick(torch, np, dev, cases),
        "network_tick_chunk": check_network_tick_chunk(torch, np, dev, [
            ("lif packable", *mk.pack_heads(surs["lif"]), True),
            ("lif mean_linear",
             *mk.pack_heads(mean_linear_surrogate(np, dev)), False)]),
        "lif_chunk": check_lif_chunk(torch, np, dev, times),
        "mlp_surrogate": single,
        "flash_attention": check_flash_attention(torch, np, dev),
        "gbdt_walk": check_gbdt_walk(torch, np, dev, surs),
    }
    if parent:
        checks["lif_step"]["parent_ms_by_shape"] = parent["lif_step"]
        checks["lif_chunk"]["parent_ms"] = parent["lif_chunk"][str(N_MAIN)]
        checks["lif_chunk"]["parent_ms_by_shape"] = {
            f"n={n} T={t}": parent["lif_chunk"].get(str(n))
            for n, t in LIF_CHUNK_SHAPES if n != N_RAGGED}
        checks["mlp_surrogate"]["parent_ms"] = \
            parent["mlp_surrogate"]["torch.float32"]
        checks["mlp_surrogate"]["parent_ms_bf16"] = \
            parent["mlp_surrogate"]["torch.bfloat16"]
        checks["crossbar_target"].update({
            "parent_ms_by_shape": parent["crossbar_step"],
            "parent_target_ms_by_shape": parent["crossbar_target"],
            "parent_launch_floor_ms": parent["launch_floor"]})
    for name, c in checks.items():
        line({"phase": "kernel_check", "kernel": name, **c})

    audit_runs(torch, dev, smi)
    launches = {}
    for runs in (snn_runs, wide_runs, xbar_runs, mixed_runs, stream_runs,
                 mesh_runs, lm_runs, zoo_runs, lm_train_runs, tp_runs):
        for kernel, by_run in runs(torch, np, dev, surs,
                                   args.profile).items():
            launches.setdefault(kernel, {}).update(by_run)
    by_kernel, train_shapes = train_runs(torch, np, dev, surs, args.profile,
                                         smi)
    for kernel, by_run in by_kernel.items():
        launches.setdefault(kernel, {}).update(by_run)
    checks["mlp_surrogate"]["train_shapes"] = train_shapes

    t_layer = time.perf_counter()
    parts = [layer_record(torch, np, dev, surs, smi)]
    by_kernel, stim = layer_scaling(torch, np, dev, surs, args.profile, smi)
    parts.append(by_kernel)
    parts.append(layer_propagation(torch, np, dev, surs, args.profile, smi))
    by_kernel, heads_dse = dse_runs(torch, np, dev, surs, args.profile, smi)
    parts.append(by_kernel)
    for part in parts:
        for kernel, by_run in part.items():
            launches.setdefault(kernel, {}).update(by_run)
    chunk_shapes, tick_shapes = layer_kernel_shapes(torch, np, dev, surs,
                                                    stim, smi)
    checks["lif_chunk"]["layer_shapes"] = chunk_shapes
    checks["network_tick"]["layer_shapes"] = tick_shapes
    checks["mlp_surrogate_heads"]["dse_shape"] = heads_dse
    line({"phase": "layer_and_dse_done",
          "seconds": time.perf_counter() - t_layer})

    t_serve = time.perf_counter()
    by_kernel, (tick_serve, chunk_serve, heads_serve), lane_res = serve_runs(
        torch, np, dev, surs, args.profile, smi)
    for run_name, counts in by_kernel.items():
        add_counts(launches, run_name, counts)
    for name, shapes in (("network_tick", tick_serve),
                         ("network_tick_chunk", chunk_serve),
                         ("mlp_surrogate_heads", heads_serve)):
        checks[name]["serve_shapes"] = shapes
        errs = [shapes["max_abs_err"]] if "max_abs_err" in shapes else [
            r["max_abs_err"] for r in shapes.values()]
        checks[name]["max_abs_err"] = max(checks[name]["max_abs_err"], *errs)
    line({"phase": "serve_done", "seconds": time.perf_counter() - t_serve})

    t_server = time.perf_counter()
    for run_name, counts in server_runs(torch, np, dev, smi,
                                        lane_res).items():
        add_counts(launches, run_name, counts)
    line({"phase": "server_done",
          "seconds": time.perf_counter() - t_server})

    t_dry = time.perf_counter()
    line({"phase": "dryrun", **dryrun_phase(torch, dev, surs, smi)})
    line({"phase": "dryrun_check", **dryrun_check(torch, dev, surs, smi),
          "seconds": time.perf_counter() - t_dry})

    meta = {
        "crossbar_target": ("src/repro_torch/kernels/csrc/crossbar_step.cu",
                            "src/repro/kernels/crossbar_mvm.py:35"),
        "lif_step": ("src/repro_torch/kernels/csrc/lif_step.cu",
                     "src/repro/kernels/lif_scan.py:154"),
        "mlp_surrogate_heads": ("src/repro_torch/kernels/csrc/mlp_heads.cu",
                                "src/repro/kernels/mlp_surrogate.py:89"),
        "network_tick": ("src/repro_torch/kernels/csrc/network_tick.cu",
                         "src/repro/kernels/tick_megakernel.py:508"),
        "network_tick_chunk": ("src/repro_torch/kernels/csrc/network_tick.cu",
                               "src/repro/kernels/tick_megakernel.py:604"),
        "lif_chunk": ("src/repro_torch/kernels/csrc/lif_step.cu",
                      "src/repro/kernels/lif_scan.py:114"),
        "mlp_surrogate": ("src/repro_torch/kernels/csrc/mlp_heads.cu",
                          "src/repro/kernels/mlp_surrogate.py:36"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                            "src/repro/kernels/flash_attn.py:53"),
        "gbdt_walk": ("src/repro_torch/kernels/csrc/gbdt_walk.cu",
                      "none: replaces the eager _predict_gbdt"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        c = checks[name]
        by_run = launches.get(name, {})
        if not by_run:
            fail(f"{name}: no main-path run launched it")
        extra = {k: v for k, v in c.items()
                 if k not in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "digests",
                              "chain_ms", "chain_ms_by_shape")}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_run.values()),
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c.get("library_ms"),
            "launches_by_run": by_run, **extra})
    line({"phase": "done", "seconds": time.perf_counter() - t_start})
    line({"kernels": kernels})
    line({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
