"""Batch parallelism in the port: ``repro_torch.launch.mesh``,
``repro_torch.core.distributed``, ``NetworkEngine(..., mesh=)`` and the
facade's ``mesh=``, against the unsharded port run and the JAX package.

A mesh of 1, 2 and 4 CPU shards (one device listed several times, the
port's counterpart of the reference tests' forced host devices) runs the
784-128-10 SNN (golden and LASANA through the megakernel path) and a
crossbar MLP graph (golden and LASANA) through ``simulate``,
``simulate_stream``, ``stream`` and ``resume``: outputs, spikes and
events are identical to the unsharded run's, energy, latency and flush
within rtol 1e-5 (summed shard by shard, tests/test_distributed.py's
limit), and the unsharded run equals the reference's as
tests/test_torch_network.py / test_torch_graph.py hold it. Also the
refusals (an indivisible batch, slot programs on a mesh, a device that
disagrees with the mesh), the engine cache keying meshes by value, the
build counter, the sharding rule tables against ``repro.sharding``, and
``make_distributed_step`` against ``lasana_step`` as
tests/test_distributed.py holds it."""

import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import test_torch_fixtures as fx  # noqa: E402
from test_torch_fixtures import assert_runs_match, surrogate_pairs  # noqa: E402,F401

GAIN = 40e3 * 12e-6          # |-R_f * G_unit| of the crossbar row
STEP = 2 * 2.0 / 255         # one 8-bit ADC step over [-v_sat, v_sat]


def _mesh(n):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((n,), ("data",), ["cpu"] * n)


@pytest.fixture(scope="module")
def xbar_pair():
    from repro.core.surrogate import Surrogate as JaxSurrogate
    from repro_torch.core.surrogate import Surrogate
    return (JaxSurrogate.load(str(fx.XBAR_PACKABLE)),
            Surrogate.load(str(fx.XBAR_PACKABLE), device="cpu"))


def _snn(batch=4, t_steps=20):
    from repro.core.network import snn_spec
    from repro_torch.convert import spec_from_numpy
    ws, knobs = fx.snn_weights()
    x, _ = fx.chip_workload(n_images=batch, t_steps=t_steps)
    jspec = snn_spec([jnp.asarray(w) for w in ws],
                     [jnp.asarray(p) for p in knobs])
    return spec_from_numpy(ws, knobs), jspec, x


def _xbar(batch=4):
    from repro.core.network import crossbar_mlp_spec
    from repro_torch.convert import crossbar_spec_from_numpy
    rng = np.random.default_rng(12)
    ws = [rng.integers(-1, 2, (70, 12)).astype(np.float32),
          rng.integers(-1, 2, (12, 4)).astype(np.float32)]
    x = rng.uniform(-0.8, 0.8, (3, batch, 70)).astype(np.float32)
    return (crossbar_spec_from_numpy(ws),
            crossbar_mlp_spec([jnp.asarray(w) for w in ws]), x)


def _codes(y, n_seg):
    return np.rint((np.asarray(y, np.float64) * -GAIN + 2.0 * n_seg)
                   / STEP).astype(np.int64)


def _kw(workload, path, pairs, xbar_pair):
    if path == "golden":
        return dict(backend="golden"), dict(backend="golden")
    jsur, tsur = (pairs["packable"] if workload == "snn" else xbar_pair)
    return (dict(surrogates=jsur, fused_kernel=True),
            dict(surrogates=tsur, fused_kernel=True))


def _reference_matches(workload, got, want):
    if workload == "snn":
        assert_runs_match(got, want)
        return
    np.testing.assert_array_equal(got.events, np.asarray(want.events))
    np.testing.assert_array_equal(_codes(got.outputs, 1),
                                  _codes(want.outputs, 1))
    for f in ("energy", "latency", "flush_energy"):
        fx.assert_close(getattr(got, f), np.asarray(getattr(want, f)), f)


WORKLOADS = {"snn": _snn, "xbar": _xbar}


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("path", ["golden", "lasana"])
@pytest.mark.parametrize("workload", ["snn", "xbar"])
def test_simulate_on_mesh_equals_unsharded_and_reference(
        surrogate_pairs, xbar_pair, workload, path, n):
    import repro.lasana as jax_lasana
    import repro_torch.lasana as lasana
    spec, jspec, x = WORKLOADS[workload]()
    jkw, tkw = _kw(workload, path, surrogate_pairs, xbar_pair)
    base = lasana.simulate(spec, x, device="cpu", **tkw)
    got = lasana.simulate(spec, x, mesh=_mesh(n), **tkw)
    assert_runs_match(got, base)
    want = jax_lasana.simulate(jspec, jnp.asarray(x), **jkw)
    _reference_matches(workload, got, want)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("workload", ["snn", "xbar"])
def test_stream_on_mesh_equals_monolithic(surrogate_pairs, xbar_pair,
                                          workload, n):
    import repro_torch.lasana as lasana
    spec, _, x = WORKLOADS[workload]()
    _, tkw = _kw(workload, "lasana", surrogate_pairs, xbar_pair)
    base = lasana.simulate(spec, x, device="cpu", record_hidden=False, **tkw)
    got = lasana.simulate_stream(spec, x, chunk_ticks=7 if workload == "snn"
                                 else 2, mesh=_mesh(n), **tkw)
    assert_runs_match(got, base)
    chunks = list(lasana.stream(spec, x, chunk_ticks=2, mesh=_mesh(n),
                                **tkw))
    assert len(chunks) == -(-x.shape[0] // 2)
    from repro_torch.core.network import NetworkRun
    assert_runs_match(NetworkRun.merge(chunks), base)


def test_resume_on_another_mesh(surrogate_pairs, tmp_path):
    """A stream checkpointed on 4 shards resumes on 2 shards and on none,
    and both equal the uninterrupted run: checkpoints hold whole-batch
    carries."""
    import repro_torch.lasana as lasana
    spec, _, x = _snn(batch=4, t_steps=20)
    sur = surrogate_pairs["packable"][1]
    base = lasana.simulate(spec, x, surrogates=sur, device="cpu",
                           record_hidden=False)
    runs = list(lasana.stream(spec, x, chunk_ticks=5, surrogates=sur,
                              mesh=_mesh(4), checkpoint_every=1))
    ckpt = runs[1].checkpoint
    assert ckpt is not None and ckpt.k0 == 10 and ckpt.batch == 4
    ckpt.save(str(tmp_path / "c.npz"))
    for mesh in (_mesh(2), None):
        got = lasana.resume(str(tmp_path / "c.npz"), spec, x,
                            surrogates=sur, mesh=mesh,
                            device=None if mesh else "cpu")
        assert_runs_match(got, base)


def test_indivisible_batch_raises(surrogate_pairs):
    import repro_torch.lasana as lasana
    spec, _, x = _snn(batch=3, t_steps=4)
    sur = surrogate_pairs["packable"][1]
    for run in (lambda: lasana.simulate(spec, x, surrogates=sur,
                                        mesh=_mesh(2)),
                lambda: lasana.simulate_stream(spec, x, chunk_ticks=2,
                                               surrogates=sur,
                                               mesh=_mesh(2))):
        with pytest.raises(ValueError, match="not divisible by mesh size 2"):
            run()


def test_slot_programs_refuse_a_mesh(surrogate_pairs):
    import repro_torch.lasana as lasana
    spec, _, _ = _snn()
    eng = lasana.engine(spec, mesh=_mesh(2))
    with pytest.raises(ValueError, match="mesh"):
        eng.slot_programs(4, 8, surrogate_pairs["packable"][1])


def test_device_must_agree_with_the_mesh():
    import repro_torch.lasana as lasana
    from repro_torch.core.network import NetworkEngine
    spec, _, _ = _snn()
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        NetworkEngine(spec, backend="golden", mesh=_mesh(2), device="meta")
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        lasana.engine(spec, backend="golden", mesh=_mesh(2), device="meta")
    eng = NetworkEngine(spec, backend="golden", mesh=_mesh(2), device="cpu")
    assert eng.device == torch.device("cpu")


def test_engine_cache_keys_meshes_by_value(surrogate_pairs):
    """Equal meshes (new objects) share one engine and its runner; a
    different mesh gets its own; the build counter counts what the
    reference's does, however many shards."""
    import repro_torch.lasana as lasana
    spec, _, x = _snn(batch=4, t_steps=6)
    sur = surrogate_pairs["packable"][1]
    a = lasana.engine(spec, mesh=_mesh(4))
    assert lasana.engine(spec, mesh=_mesh(4)) is a
    assert lasana.engine(spec, mesh=_mesh(2)) is not a
    assert lasana.engine(spec, device="cpu") is not a
    lasana.simulate(spec, x, surrogates=sur, mesh=_mesh(4))
    lasana.simulate(spec, x, surrogates=sur, mesh=_mesh(4))
    assert a.compile_count == 1
    list(lasana.stream(spec, x, chunk_ticks=4, surrogates=sur,
                       mesh=_mesh(4), record_hidden=True))
    assert a.compile_count == 3          # + the full and remainder chunks


def test_mesh_is_a_value():
    from repro_torch.launch.mesh import (Mesh, make_host_mesh, make_mesh,
                                         mesh_info)
    m = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    assert m == make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    assert hash(m) == hash(make_mesh((2, 2), ("data", "model"),
                                     ["cpu"] * 4))
    assert m != make_mesh((4, 1), ("data", "model"), ["cpu"] * 4)
    assert m != make_mesh((2, 2), ("a", "b"), ["cpu"] * 4)
    assert m.shape == {"data": 2, "model": 2} and m.size == 4
    assert m.devices.shape == (2, 2) and m.axis_names == ("data", "model")
    assert mesh_info(m) == {"shape": {"data": 2, "model": 2},
                            "n_devices": 4, "axis_names": ["data", "model"]}
    h = make_host_mesh(model=2, devices=["cpu"] * 5)
    assert h.shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ("data", "model"), ["cpu"] * 3)
    with pytest.raises(ValueError):
        Mesh(np.array(["cpu", "cpu"], dtype=object), ("a", "b"))


def test_specs_and_shard_over_batch():
    from repro_torch.core import distributed as dist
    m = _mesh(4)
    assert dist.circuit_spec(m) == (("data",),)
    assert dist.batch_spec(m, ndim=3, axis=1) == (None, ("data",), None)
    assert dist.shard_bounds(8, m) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    seen = []

    def body(x, scale):
        seen.append(tuple(x.shape))
        return x * scale, x.sum(), x.max()
    fn = dist.shard_over_batch(body, m, in_specs=(0, None),
                               out_specs=(0, "sum", "max"))
    x = torch.arange(8.0)
    y, s, mx = fn(x, 2.0)
    assert seen == [(2,)] * 4
    assert torch.equal(y, x * 2) and float(s) == 28.0 and float(mx) == 7.0
    with pytest.raises(ValueError, match="not divisible"):
        fn(torch.arange(6.0), 1.0)


def test_sharding_rules_match_reference():
    import repro.sharding as jshd
    from repro_torch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    rules = shd.ShardingRules(rules={"a": "x", "b": "x", "c": ("x", "y")})
    jrules = jshd.ShardingRules(rules={"a": "x", "b": "x", "c": ("x", "y")})
    assert rules.spec(("a", "b", "c")) == tuple(jrules.spec(("a", "b", "c")))
    mesh = make_mesh((4, 2), ("data", "model"), ["cpu"] * 8)
    fake = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((4, 2)))
    for fsdp in (True, False):
        got = shd.train_rules(mesh, fsdp=fsdp)
        want = jshd.train_rules(fake, fsdp=fsdp)
        assert dict(got.rules) == dict(want.rules)
        for logical, shape in ((("embed", "mlp"), (64, 128)),
                               (("batch", None, "vocab"), (8, 3, 10)),
                               (("kv_heads", "heads"), (2, 6)),
                               (("layers", "embed", "heads", None),
                                (3, 6, 4, 8)), ((None, None), (3, 3))):
            assert got.spec(logical) == tuple(want.spec(logical))
            assert got.spec_for_shape(mesh, logical, shape) == tuple(
                want.spec_for_shape(fake, logical, shape))
    assert dict(shd.serve_rules(mesh, kv_seq_sharding=True).rules) == dict(
        jshd.serve_rules(fake, kv_seq_sharding=True).rules)
    assert shd.num_devices(mesh) == 8
    one = make_mesh((1, 1), ("data", "model"), ["cpu"])
    assert shd.train_rules(one).sharding(one, ("embed", "mlp")).devices \
        == [torch.device("cpu")]
    t = torch.zeros(3)
    assert shd.constraint(t, one, shd.train_rules(one), ("batch",)) is t


# --- the sharded Algorithm-1 tick --------------------------------------------------

def _tick_state(n=64):
    from repro_torch.convert import state_from_numpy
    v, o, t_last, params, changed, x, _ = fx.tick_inputs(n, seed=5)
    return (state_from_numpy(v, o, t_last, params, "cpu"),
            torch.from_numpy(changed), torch.from_numpy(x))


@pytest.mark.parametrize("fused_kernel", [True, False])
def test_distributed_step_matches_lasana_step(surrogate_pairs, fused_kernel):
    """8 CPU shards of one tick against the local ``lasana_step``
    (tests/test_distributed.py:62-86): v within rtol 1e-5, the energy sum
    within rtol 1e-5, the int32 spike count exact."""
    from repro_torch.core.distributed import make_distributed_step
    from repro_torch.core.wrapper import lasana_step
    sur = surrogate_pairs["packable"][1]
    state, changed, x = _tick_state()
    step = make_distributed_step(_mesh(8), clock_ns=5.0, spiking=True,
                                 fused_kernel=fused_kernel)
    st_d, e_tot, n_out = step(sur, state, changed, x, torch.tensor([5.0]))
    st_l, e_l, _, o_l = lasana_step(sur, state, changed, x, 5.0, 5.0,
                                    spiking=True, fused_kernel=fused_kernel)
    np.testing.assert_allclose(st_d.v.numpy(), st_l.v.numpy(), rtol=1e-5,
                               atol=1e-6)
    for f in ("o", "t_last", "params"):
        assert torch.equal(getattr(st_d, f), getattr(st_l, f))
    np.testing.assert_allclose(float(e_tot), float(e_l.sum()), rtol=1e-5,
                               atol=1e-18)
    assert n_out.dtype == torch.int32
    assert int(n_out) == int((o_l > 0.75).sum())


def test_distributed_step_legacy_call_and_type_errors(surrogate_pairs):
    from repro_torch.core.distributed import make_distributed_step
    sur = surrogate_pairs["packable"][1]
    state, changed, x = _tick_state(16)
    with pytest.raises(TypeError, match="Mesh"):
        make_distributed_step(sur, clock_ns=5.0)
    with pytest.raises(TypeError, match="second argument"):
        make_distributed_step(sur, "not a mesh", clock_ns=5.0)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        legacy = make_distributed_step(sur, _mesh(2), clock_ns=5.0,
                                       spiking=True)
    assert any(issubclass(r.category, DeprecationWarning) for r in w)
    new = make_distributed_step(_mesh(2), clock_ns=5.0, spiking=True)
    a = legacy(state, changed, x, 5.0)
    b = new(sur, state, changed, x, 5.0)
    assert torch.equal(a[0].v, b[0].v) and torch.equal(a[2], b[2])
