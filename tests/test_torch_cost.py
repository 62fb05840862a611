"""The dry run's cost model (``repro_torch/launch/hlo_cost.py``): the
port's counterparts of ``tests/test_hlo_cost.py``'s four cases, each
collective's count and wire bytes against a hand count, each kernel's
dry-run route, and every scaling of the dry run — repeated loop bodies,
microbatches, layer stacks and one row standing for the mesh's equal
rows — held to the full, unscaled run, integer for integer."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.launch.hlo_cost import analyze  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.core.circuits import CrossbarRow, LIFNeuron  # noqa: E402
from repro_torch.core.surrogate import Surrogate  # noqa: E402
from repro_torch.kernels import (crossbar_mvm, flash_attn, lif_scan,  # noqa: E402
                                 mlp_surrogate, ops)
from repro_torch.kernels import tick_megakernel as mk  # noqa: E402
from repro_torch.launch import dryrun, hlo_cost  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.sharding import train_rules  # noqa: E402

import test_torch_fixtures as fx  # noqa: E402

N = 128


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def _count(fn, *args):
    """``fn(*args)`` under a counter, its arguments on entry 0 ->
    EntryStats of entry 0."""
    with hlo_cost.counting() as c:
        c.arguments((a, 0) for a in args)
        out = fn(*args)
    return c.stats([(out, 0)] if isinstance(out, torch.Tensor) else [])[0]


def _same(a: hlo_cost.EntryStats, b: hlo_cost.EntryStats):
    assert a.cost == b.cost
    assert (a.argument_bytes, a.output_bytes, a.alias_bytes,
            a.peak_live_bytes) == (b.argument_bytes, b.output_bytes,
                                   b.alias_bytes, b.peak_live_bytes)


def _loop(x, c, steps):
    for _ in range(steps):
        x = torch.tanh(x @ c)
    return x


# --- the reference's four cases ------------------------------------------------

def test_loop_free_flops_within_5_percent_of_the_reference():
    def f(a, b):
        return jnp.sum(jax.nn.relu(a @ b))
    hlo = jax.jit(f).lower(jax.ShapeDtypeStruct((512, 256), jnp.float32),
                           jax.ShapeDtypeStruct((256, 1024), jnp.float32)
                           ).compile().as_text()
    want = analyze(hlo).flops
    got = _count(lambda a, b: torch.relu(a @ b).sum(), _meta(512, 256),
                 _meta(256, 1024))
    assert abs(got.cost.flops - want) / want < 0.05
    assert got.cost.dot_flops == 2 * 512 * 256 * 1024


def test_loop_counted_once_and_scaled_equals_the_full_loop():
    x, c = _meta(N, N), _meta(N, N)
    runs = {(k,): {0: _count(lambda a, b, k=k: _loop(a, b, k), x, c)}
            for k in (2, 3)}
    scaled = hlo_cost.extrapolate(runs, [(10, 2, False)])
    _same(scaled, _count(lambda a, b: _loop(a, b, 10), x, c))
    assert scaled.cost.dot_flops == 10 * 2 * N ** 3
    assert scaled.cost.transcendentals == 10 * N * N


def _grad_loop(steps):
    def f(x, c):
        y = _loop(x, c, steps).sum()
        return torch.autograd.grad(y, (x, c))[0]
    return _count(f, _meta(N, N, grad=True), _meta(N, N, grad=True))


def test_grad_loop_counts_forward_and_both_backward_products():
    scaled = hlo_cost.extrapolate({(k,): {0: _grad_loop(k)} for k in (2, 3)},
                                  [(10, 2, False)])
    assert scaled.cost.dot_flops == 10 * 3 * 2 * N ** 3
    assert scaled.cost == _grad_loop(10).cost


def _nested(outer, inner):
    def f(x, c):
        for _ in range(outer):
            x = _loop(x, c, inner)
        return x
    return _count(f, _meta(N, N), _meta(N, N))


def test_nested_loops_multiply():
    runs = {(o, i): {0: _nested(o, i)} for o in (2, 3) for i in (2, 3)}
    scaled = hlo_cost.extrapolate(runs, [(5, 2, False), (4, 2, False)])
    _same(scaled, _nested(5, 4))
    assert scaled.cost.dot_flops == 20 * 2 * N ** 3


# --- collectives ------------------------------------------------------------------

def _parts(shape, grad=False):
    return [_meta(*shape, grad=grad) for _ in range(4)]


@pytest.mark.parametrize("kind,run,out_shape,wire", [
    ("all-reduce", lambda ps: collectives.all_reduce_sum(ps), (8, 16),
     2 * 512 * 3 / 4),
    ("all-reduce", lambda ps: collectives.all_max(ps), (8, 16),
     2 * 512 * 3 / 4),
    ("all-gather", lambda ps: collectives.all_gather(
        [p[:, :4] for p in ps], 1), (8, 16), 512 * 3 / 4),
    ("reduce-scatter", lambda ps: collectives.reduce_scatter(ps, 0), (2, 16),
     128 * 3),
    ("collective-permute", lambda ps: collectives.broadcast(
        ps[0], ["meta"] * 4, at=[0, 1, 2, 3]), (8, 16), 512),
])
def test_each_collective_counts_once_per_device_on_a_1x4_mesh(
        kind, run, out_shape, wire):
    """Four participants, fp32 (8, 16) parts (512 bytes): each device
    counts the collective once, with its output bytes and ring traffic;
    each output is a tensor of its own on its destination's entry."""
    parts = _parts((8, 16))
    with hlo_cost.counting() as c:
        c.arguments((p, e) for e, p in enumerate(parts))
        outs = run(parts)
    assert [tuple(o.shape) for o in outs] == [out_shape] * 4
    assert len({id(o.untyped_storage()) for o in outs}) == 4
    assert [c.entry_of(o) for o in outs] == [0, 1, 2, 3]
    at = [0] if kind == "collective-permute" else range(4)
    stats = c.stats()
    for e in range(4):
        cost = stats[e].cost
        want = 1 if e in at else 0
        assert cost.collective_counts[kind] == want
        assert cost.wire_bytes == want * wire
        assert sum(cost.collective_counts.values()) == want
        assert cost.flops == 0            # the simulated exchange is free


def test_a_gathers_backward_is_one_reduce_scatter_a_device():
    parts = _parts((8, 4), grad=True)
    with hlo_cost.counting() as c:
        c.arguments((p, e) for e, p in enumerate(parts))
        outs = collectives.all_gather(parts, 1)
        loss = sum((o * o).sum() for o in outs)
        grads = torch.autograd.grad(loss, parts)
    assert [tuple(g.shape) for g in grads] == [(8, 4)] * 4
    assert [c.entry_of(g) for g in grads] == [0, 1, 2, 3]
    for e, st in c.stats().items():
        assert st.cost.collective_counts["all-gather"] == 1
        assert st.cost.collective_counts["reduce-scatter"] == 1
        assert st.cost.wire_bytes == 512 * 3 / 4 + 128 * 3


# --- the kernels' dry-run route -----------------------------------------------------

def _lif_args(n):
    return (torch.zeros(n, 3), torch.rand(n, 3), torch.rand(n, 4))


def _tick_args():
    sur = Surrogate.load(str(fx.ARTIFACTS / "lif_packable.npz"),
                         device="cpu")
    pack, layout = mk.pack_heads(sur)
    n = 40
    args = (pack, torch.zeros(n), torch.zeros(n), torch.zeros(n),
            torch.rand(n, 4), torch.ones(n, dtype=torch.bool),
            torch.rand(n, 3), torch.tensor(5.0), None)
    return args, dict(circuit="lif", clock_ns=5.0, layout=layout)


def _chunk_args():
    (pack, v, o, tl, params, *_), kw = _tick_args()
    t_steps, n = 3, v.shape[0]
    kw.pop("circuit")
    kw.pop("clock_ns")
    return ((pack, v, o, tl, params, torch.ones(t_steps, n, dtype=torch.bool),
             torch.rand(t_steps, n, 3), torch.arange(t_steps) * 5.0),
            dict(circuit="lif", clock_ns=5.0, **kw))


def _heads_args(p=3, n=50, f=10, h1=16, h2=8):
    return (torch.rand(n, f), torch.rand(p, f), torch.rand(p, f) + 1,
            torch.rand(p, 1), torch.rand(p, 1), torch.rand(p, f, h1),
            torch.rand(p, h1), torch.rand(p, h1, h2), torch.rand(p, h2),
            torch.rand(p, h2, 1), torch.rand(p, 1))


def _single_args(n=50, f=10, h1=16, h2=8):
    return (torch.rand(n, f), torch.rand(f, h1), torch.rand(h1),
            torch.rand(h1, h2), torch.rand(h2), torch.rand(h2, 1),
            torch.rand(1))


def _flash_args(dtype):
    return (torch.rand(6, 32, 16).to(dtype), torch.rand(3, 32, 16).to(dtype),
            torch.rand(3, 32, 16).to(dtype))


KERNELS = {
    "lif_step": (lambda: (_lif_args(N), {}),
                 lambda a, kw: lif_scan.lif_step(*a, **kw),
                 lambda a, kw: lif_scan.work(N, LIFNeuron().n_substeps)),
    "lif_chunk": (lambda: ((torch.zeros(N, 3), torch.rand(5, N, 3),
                            torch.rand(N, 4)), {"record_v": True}),
                  lambda a, kw: lif_scan.lif_chunk(*a, **kw),
                  lambda a, kw: lif_scan.work(N, LIFNeuron().n_substeps, 5,
                                              True)),
    "crossbar_target": (lambda: ((torch.rand(N, 32), torch.rand(N, 33)), {}),
                        lambda a, kw: crossbar_mvm.crossbar_target(*a),
                        lambda a, kw: crossbar_mvm.work(
                            N, 32, CrossbarRow().n_substeps, False)),
    "crossbar_step": (lambda: ((torch.zeros(N, 1), torch.rand(N, 32),
                                torch.rand(N, 33)), {}),
                      lambda a, kw: crossbar_mvm.crossbar_step(*a),
                      lambda a, kw: crossbar_mvm.work(
                          N, 32, CrossbarRow().n_substeps)),
    "mlp_surrogate_heads": (lambda: (_heads_args(), {}),
                            lambda a, kw: mlp_surrogate.mlp_surrogate_heads(
                                *a),
                            lambda a, kw: mlp_surrogate.heads_work(
                                50, 10, 3, 16, 8,
                                sum(x.numel() for x in a[1:]))),
    "mlp_surrogate": (lambda: (_single_args(), {}),
                      lambda a, kw: mlp_surrogate.mlp_surrogate(*a),
                      lambda a, kw: mlp_surrogate.single_work(
                          50, 10, 16, 8, sum(x.numel() for x in a[1:]))),
    "network_tick": (_tick_args,
                     lambda a, kw: mk.network_tick(*a, **kw),
                     lambda a, kw: mk.work(a[0], kw["layout"], "lif", 40, 3,
                                           4)),
    "network_tick_chunk": (_chunk_args,
                           lambda a, kw: mk.network_tick_chunk(*a, **kw),
                           lambda a, kw: mk.chunk_work(a[0], kw["layout"],
                                                       40, 3)),
    "flash_attention": (lambda: (_flash_args(torch.bfloat16), {}),
                        lambda a, kw: flash_attn.flash_attention(
                            *a, groups=2),
                        lambda a, kw: flash_attn.work(
                            (6, 32, 16), (3, 32, 16), torch.bfloat16, 2)),
    "flash_attention_simt": (lambda: (_flash_args(torch.float32), {}),
                             lambda a, kw: flash_attn.flash_attention(
                                 *a, groups=2),
                             lambda a, kw: flash_attn.work(
                                 (6, 32, 16), (3, 32, 16), torch.float32,
                                 2)),
}


def _structure(out):
    if isinstance(out, dict):
        return {k: _structure(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return [_structure(v) for v in out]
    return (tuple(out.shape), out.dtype)


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    if isinstance(x, dict):
        return {k: _to_meta(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_to_meta(v) for v in x)
    return x


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_each_kernels_dry_run_route(name):
    """Meta outputs of the plain version's shapes and dtypes, the work of
    the work function recorded under the kernel's counter name, no launch
    and no plain version run; outside ``ops.dry_run`` the same meta call
    is refused."""
    make, call, work = KERNELS[name]
    args, kw = make()
    want = _structure(call(args, kw))          # the plain version, CPU
    margs, mkw = _to_meta(args), dict(kw)
    seen = []
    before = dict(ops.LAUNCHES)
    with ops.dry_run(lambda k, w: seen.append((k, w))):
        got = call(margs, mkw)
    assert _structure(got) == want
    assert all(t.device.type == "meta" for t in _leaves(got))
    # every launch of crossbar_step.cu counts as one crossbar_target
    counter = "crossbar_target" if name == "crossbar_step" else name
    assert seen == [(counter, work(args, kw))]
    assert ops.LAUNCHES == before
    with pytest.raises((ValueError, RuntimeError)):
        call(margs, mkw)
    assert ops.LAUNCHES == before


def _leaves(x):
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [x]


def test_flops_are_kept_by_the_rate_they_run_at():
    """A bf16 dot's flops run on the tensor cores, an fp32 dot's and every
    elementwise op's on the fp32 cores; the rates sum to the flops."""
    a16 = _meta(64, 32, dtype=torch.bfloat16)
    b16 = _meta(32, 16, dtype=torch.bfloat16)
    got = _count(lambda a, b: torch.relu(a @ b), a16, b16).cost
    assert got.flops_by_rate["bf16"] == 2 * 64 * 32 * 16
    assert got.flops_by_rate["fp32"] == 64 * 16          # the relu
    assert sum(got.flops_by_rate.values()) == got.flops
    got = _count(lambda a, b: torch.relu(a @ b), _meta(64, 32),
                 _meta(32, 16)).cost
    assert got.flops_by_rate["bf16"] == 0
    assert got.flops_by_rate["fp32"] == got.flops


def test_kernel_work_reaches_the_counter():
    args, kw = _tick_args()
    margs = _to_meta(args)
    with hlo_cost.counting() as c:
        c.arguments([(margs[1], 0)])
        mk.network_tick(*margs, **kw)
    st = c.stats()[0]
    w = mk.work(args[0], kw["layout"], "lif", 40, 3, 4)
    assert st.kernels == {"network_tick": 1}
    assert st.cost.flops >= w.flops and st.cost.bytes >= w.bytes
    assert st.cost.flops_by_rate[w.rate] >= w.flops
    assert rf.bound_ms(w)[1] in ("bytes", "operations")
    # the roofline of the tick takes the kernel's work at its own peak:
    # it is no shorter than the kernel's bound
    roof = rf.roofline(st.cost.cost_analysis(),
                       rf.CollectiveStats({}, {}, st.cost.wire_bytes),
                       model_flops_total=1.0, n_devices=1)
    assert max(roof.compute_s, roof.memory_s) * 1e3 >= rf.bound_ms(w)[0]


# --- the dry run's scalings against the full run ------------------------------------

MESH = (2, 4)


def _mesh():
    return make_mesh(MESH, ("data", "model"), ["meta"] * 8)


def _fields(lw):
    d = lw.device
    return (d.cost, d.argument_bytes, d.output_bytes, d.alias_bytes,
            d.peak_live_bytes, d.kernels)


def _deep(arch):
    cfg = reduced_config(arch)
    if cfg.hybrid is not None:
        return dataclasses.replace(cfg, n_layers=4 * len(cfg.hybrid.pattern)
                                   + 1)
    if cfg.moe is not None and cfg.moe.first_dense:
        return dataclasses.replace(cfg, n_layers=8, moe=dataclasses.replace(
            cfg.moe, first_dense=4))
    cfg = dataclasses.replace(cfg, n_layers=4)
    if cfg.encdec is not None:
        cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
            cfg.encdec, n_encoder_layers=4))
    return cfg


CASES = {
    "train": ShapeConfig("t", 32, 20, "train", num_microbatches=5),
    "prefill": ShapeConfig("p", 32, 4, "prefill"),
    "decode": ShapeConfig("d", 32, 4, "decode"),
}


@pytest.mark.parametrize("arch,kind", [
    ("granite-3-8b", "train"), ("deepseek-moe-16b", "prefill"),
    ("recurrentgemma-2b", "decode"), ("whisper-base", "prefill")])
def test_scaled_counts_equal_the_full_run(arch, kind):
    """Microbatches (train), the layer stacks (dense, MoE, a hybrid's
    pattern, an encoder) extended from 2 and 3 equal the step run at full
    depth: costs, arguments, outputs, aliases, the peak and the kernels."""
    cfg, shape, mesh = _deep(arch), CASES[kind], _mesh()
    rules = train_rules(mesh)
    mb = 2 if kind == "train" else 1
    scaled = dryrun.lower(cfg, shape, mesh, rules, n_moe_groups=mb)
    assert len(scaled.runs) > 1
    assert all(max(r["counts"].values()) <= 3 for r in scaled.runs)
    full = dryrun.lower(cfg, shape, mesh, rules, scale=False,
                        n_moe_groups=mb)
    assert len(full.runs) == 1
    assert _fields(scaled) == _fields(full)


@pytest.mark.parametrize("arch,fsdp", [
    ("granite-3-8b", False), ("granite-3-8b", True),
    ("deepseek-moe-16b", True), ("mamba2-1.3b", True),
    ("whisper-base", True)])
def test_one_row_standing_for_the_mesh_equals_every_row_run(arch, fsdp):
    """One data row computing for both (``Model.rows.live``, the real
    train step updating its entries) gives the device the costs, the
    arguments, the aliases and the kernels of the run where every row
    computes, integer for integer, with FSDP off or on (each row's gather
    adjoint then hands the live entry one gradient piece from each
    stand-in row, ``model._gather_over_rows``).

    Named difference: the peak, and the outputs of the entry that holds
    it. Where every row computes, autograd takes the rows' nodes in the
    order they were made, so the rows' entries peak at different moments
    with different tensors live, and the step's 0-d scalars (the loss, its
    parts and their gradients, the metrics: 4 bytes each) lie at row 0's
    entries; the one computing row's entry holds what the busiest row
    holds and those scalars too. Its peak lies above the full run's by at
    most one row's residual-stream block of a microbatch (B / M / rows x S
    x d in the model's dtype) and 16 scalars, its outputs by at most 16
    scalars."""
    cfg, mesh = reduced_config(arch), _mesh()
    shape = ShapeConfig("t", 32, 8, "train", num_microbatches=2)
    rules = train_rules(mesh, fsdp=fsdp)
    one = dryrun.lower(cfg, shape, mesh, rules, n_moe_groups=2).device
    every = dryrun.lower(cfg, shape, mesh, rules, one_row=False,
                         n_moe_groups=2).device
    assert one.cost == every.cost
    assert one.argument_bytes == every.argument_bytes
    assert one.alias_bytes == every.alias_bytes
    assert one.kernels == every.kernels
    rows = MESH[0]
    block = (shape.global_batch // shape.num_microbatches // rows
             * shape.seq_len * cfg.d_model * torch.finfo(
                 getattr(torch, cfg.dtype)).bits // 8)
    d_peak = one.peak_live_bytes - every.peak_live_bytes
    d_out = one.output_bytes - every.output_bytes
    assert 0 <= d_peak <= block + 16 * 4 and d_peak % 4 == 0
    assert 0 <= d_out <= 16 * 4 and d_out % 4 == 0


def test_memoized_signatures_change_nothing():
    """The equal-signature cache (every mesh entry's and layer's meta
    kernels run once) gives the counts of the run without it."""
    cfg, shape, mesh = reduced_config("granite-3-8b"), CASES["decode"], \
        _mesh()
    rules = train_rules(mesh)
    a = dryrun.lower(cfg, shape, mesh, rules, scale=False)
    b = dryrun.lower(cfg, shape, mesh, rules, scale=False, memo=False)
    assert _fields(a) == _fields(b)
