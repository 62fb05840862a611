"""The port's dry run against the reference's lowering. A subprocess runs
the reference with eight forced host devices, as
``tests/test_torch_tp_reference.py`` does: it lowers and compiles reduced
granite-3-8b (dense GQA), deepseek-moe-16b (MoE) and mamba2-1.3b (SSM) on
a (2, 4) mesh with ``train_rules`` — a train step of two microbatches, a
prefill and a decode — and reports each program's per-device argument
bytes (``memory_analysis()``), its dot flops (``hlo_cost.HloCostModel``
subclassed here so that only ``dot`` contributes flops; nothing in the
reference changes) and its ``model_flops``. The port's dry run of the
same cells on a (2, 4) meta mesh is held to three things: per-device
argument bytes equal (the one difference named below), dot flops within
5%, ``model_flops`` equal.

Four products are partitioned differently by the two programs, and
their difference is reckoned from the shapes and named (``_named``)
before the 5% is held; the raw figures are printed:

- U, the logits product of a train step where the vocab does not divide
  the model axis: the port computes ceil(V / n) columns a shard in the
  forward and both backward products; the reference's partitioner
  replicates all V columns in the forward and the input gradient and
  cuts the weight gradient's rows over the data axis (FSDP).
- A, a prefill's causal attention scores: the port runs them in the
  flash kernel, whose work (the causal half) counts as kernel work, not
  as dots; the reference's XLA path computes the dense S x S products.
- R, a MoE layer whose dispatch groups do not fall on the data rows
  (prefill and decode, one group): the port routes the whole batch on
  row 0 (``Model._ffn_rows``), whose device then does every row's router,
  expert and shared-expert products; the reference's device does its
  row's share.
- K, a decode step's k and v projections where the kv heads do not
  divide the model axis: the port projects the replicated kv heads whole
  on every shard (one token's product is too small for two gathers a
  layer to pay for); the reference's partitioner cuts them over the
  shards.

Collective counts, wire bytes and temp bytes are printed side by side and
not held: the reference's SPMD partitioner and the port's explicit
collectives place them differently."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.sharding import train_rules  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("granite-3-8b", "deepseek-moe-16b", "mamba2-1.3b")
SHAPES = {"train": (32, 16, 2), "prefill": (32, 4, 1), "decode": (32, 4, 1)}
DOT_REL = 0.05

_SCRIPT = textwrap.dedent(f"""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro.configs import reduced_config
    from repro.configs.shapes import ShapeConfig
    from repro.launch import hlo_cost
    from repro.launch import roofline as rf
    from repro.launch.dryrun import _opt_for
    from repro.models.model import Model
    from repro.sharding import train_rules
    from repro.train import step as step_mod

    class DotOnly(hlo_cost.HloCostModel):
        # flops of the dots alone: every other op's flops dropped, loops,
        # fusions and calls still summed over their bodies
        def _op_cost(self, op, comp):
            t = super()._op_cost(op, comp)
            if op.op not in ("dot", "fusion", "call", "async-start",
                             "while", "conditional"):
                t.flops = 0.0
            return t

    if hasattr(jax.sharding, "AxisType"):
        mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(
            jax.sharding.AxisType.Auto,) * 2)
    else:
        mesh = jax.make_mesh((2, 4), ("data", "model"))
    rules = train_rules(mesh)
    out = {{}}
    for arch in {ARCHS!r}:
        cfg = reduced_config(arch)
        model = Model(cfg, mesh=mesh, rules=rules)
        for kind, (s, b, m) in {SHAPES!r}.items():
            shape = ShapeConfig(kind, s, b, kind, num_microbatches=m)
            with mesh:
                if kind == "train":
                    opt = _opt_for(cfg)
                    jitted = step_mod.jit_train_step(model, opt, mesh, rules,
                                                     shape, n_moe_groups=2)
                    lowered = jitted.lower(
                        step_mod.abstract_train_state(model, opt),
                        model.input_specs(shape))
                elif kind == "prefill":
                    jitted = step_mod.jit_prefill(model, mesh, rules, shape)
                    lowered = jitted.lower(model.abstract_params(),
                                           model.input_specs(shape))
                else:
                    jitted = step_mod.jit_decode_step(model, mesh, rules,
                                                      shape)
                    lowered = jitted.lower(
                        model.abstract_params(), model.cache_specs(b, s),
                        model.input_specs(shape)["tokens"])
                compiled = lowered.compile()
            mem = compiled.memory_analysis()
            totals = DotOnly(compiled.as_text()).entry_cost()
            out[arch + "/" + kind] = {{
                "argument_bytes": int(mem.argument_size_in_bytes),
                "temp_bytes": int(mem.temp_size_in_bytes),
                "dot_flops": float(totals.flops),
                "wire_bytes": float(totals.wire_bytes),
                "counts": totals.collective_counts,
                "model_flops": rf.model_flops(cfg, shape)}}
    print("REFERENCE-JSON" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(_ROOT, "src")
    env.pop("XLA_FLAGS", None)
    script = tmp_path_factory.mktemp("dryrun_ref") / "reference_dryrun.py"
    script.write_text(_SCRIPT)
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, env=env, cwd=_ROOT, timeout=900)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-3000:]
    return json.loads(out.split("REFERENCE-JSON", 1)[1].splitlines()[0])


def _port(arch, kind):
    s, b, m = SHAPES[kind]
    shape = ShapeConfig(kind, s, b, kind, num_microbatches=m)
    mesh = make_mesh((2, 4), ("data", "model"), ["meta"] * 8)
    cfg = reduced_config(arch)
    lw = dryrun.lower(cfg, shape, mesh, train_rules(mesh),
                      n_moe_groups=2 if kind == "train" else 1)
    return lw.device, rf.model_flops(cfg, shape)


# Where the two programs' per-device arguments differ, leaf by leaf
# (bytes the port's arguments hold beyond the reference's): a decode
# cache's ``pos`` is a replicated int32 argument in the reference and a
# Python int in the port.
ARG_DIFF = {"decode": -4}
ROWS, SHARDS = 2, 4


def _named(cfg, kind) -> int:
    """The port's device's dot flops minus the reference's on the products
    named U, A, R and K in the module docstring."""
    s, b, m = SHAPES[kind]
    d, v, n, rows = cfg.d_model, cfg.vocab, SHARDS, ROWS
    out = 0
    if kind == "train" and v % n:                                   # U
        t = b // m // rows * s
        c = -(-v // n)
        out += m * (3 * t * d * c * 2 - (2 * t * d * v * 2
                                          + t * (d // rows) * v * 2))
    if kind == "prefill" and cfg.family.value != "ssm":            # A
        layers = cfg.n_layers
        out -= 2 * layers * (b // rows) * (cfg.n_heads // n) * s * s \
            * cfg.head_dim * 2
    if kind != "train" and cfg.moe is not None:                     # R
        from repro_torch.models.moe import capacity
        mo = cfg.moe
        tokens = b * (s if kind == "prefill" else 1)
        f = mo.d_ff_expert or cfg.d_ff
        cap = capacity(tokens, cfg)
        per_layer = (tokens * d * mo.n_experts * 2
                     + 3 * (mo.n_experts // n) * cap * d * f * 2
                     + 3 * tokens * d * (mo.n_shared * f // n) * 2)
        out += (rows - 1) * per_layer * (cfg.n_layers - mo.first_dense) \
            // rows
    if kind == "decode" and cfg.family.value != "ssm" \
            and cfg.n_kv_heads % n and cfg.head_dim % n == 0:       # K
        kv = cfg.n_kv_heads * cfg.head_dim
        out += 2 * cfg.n_layers * (b // rows) * d * kv * 2 * (n - 1) // n
    return out


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_against_the_reference_lowering(reference, arch, kind):
    ref = reference[f"{arch}/{kind}"]
    got, mf = _port(arch, kind)
    print(f"{arch} {kind}: argument bytes {got.argument_bytes} / "
          f"{ref['argument_bytes']}, dot flops {got.cost.dot_flops} / "
          f"{ref['dot_flops']:.0f}, wire {float(got.cost.wire_bytes):.0f} / "
          f"{ref['wire_bytes']:.0f}, temp {got.temp_bytes} / "
          f"{ref['temp_bytes']}, counts {got.cost.collective_counts} / "
          f"{ref['counts']}")
    assert got.argument_bytes - ARG_DIFF.get(kind, 0) == ref["argument_bytes"]
    named = _named(reduced_config(arch), kind)
    print(f"  named U/A/R/K {named}, raw ratio "
          f"{got.cost.dot_flops / ref['dot_flops']:.4f}")
    assert abs(got.cost.dot_flops - named - ref["dot_flops"]) \
        <= DOT_REL * ref["dot_flops"]
    assert mf == ref["model_flops"]
