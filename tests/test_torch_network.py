"""Port parity: whole-network simulation (``repro_torch.lasana.simulate``
vs ``repro.lasana.simulate``).

Two workloads — the 12-8-4 ``small_net`` and the first 4 items x 20 ticks
of the chip-smoke workload (the 784-128-10 SNN on synthetic digits) — run
through every path of the LIF slice on both packages: golden, behavioral,
the megakernel tick, the fused 3-dispatch tick, the per-call tick and
annotation mode. Discrete records (outputs, spike trains, event counts,
per-layer spikes) must be identical; energy, latency and flush energy
agree to rtol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import test_torch_fixtures as fx  # noqa: E402
from test_torch_fixtures import assert_runs_match, surrogate_pairs  # noqa: E402,F401

PATHS = {
    "golden": (None, dict(backend="golden")),
    "behavioral": (None, dict(backend="behavioral")),
    "megakernel": ("packable", dict(fused_kernel=True)),
    "fused": ("packable", dict(fused_kernel=False)),
    "percall": ("packable", dict(fused=False)),
    "annotation": ("packable", dict(mode="annotation", fused_kernel=True)),
    "unpackable": ("unpackable", dict(fused_kernel=True)),
}


def _workload(name):
    if name == "small_net":
        ws, knobs, x = fx.small_net()
        x[-3:] = 0.0                  # trailing idle ticks: a flush to charge
        return ws, knobs, x
    ws, knobs = fx.snn_weights()
    x, _ = fx.chip_workload(n_images=4, t_steps=20)
    return ws, knobs, x


def _simulate_both(workload, path, pairs):
    import repro.lasana as jax_lasana
    from repro.core.network import snn_spec
    import repro_torch.lasana as lasana
    from repro_torch.convert import spec_from_numpy
    ws, knobs, x = _workload(workload)
    which, kw = PATHS[path]
    jkw, tkw = dict(kw), dict(kw)
    if which is not None:
        jkw["surrogates"], tkw["surrogates"] = pairs[which]
    fused = jkw.pop("fused", True)
    jspec = snn_spec([jnp.asarray(w) for w in ws],
                     [jnp.asarray(p) for p in knobs])
    want = jax_lasana.engine(
        jspec, fused=fused, **{k: v for k, v in jkw.items()
                               if k != "surrogates"}
    ).run(jnp.asarray(x), surrogates=jkw.get("surrogates"))
    got = lasana.simulate(spec_from_numpy(ws, knobs), x, device="cpu",
                          **tkw)
    return got, want


@pytest.mark.parametrize("path", list(PATHS))
def test_small_net_matches_reference(surrogate_pairs, path):
    got, want = _simulate_both("small_net", path, surrogate_pairs)
    assert_runs_match(got, want)
    if path == "megakernel":
        assert want.flush_energy.sum() > 0        # the flush is exercised
        rg, rw = got.report(), want.report()
        assert rg["network"]["events"] == rw["network"]["events"]
        fx.assert_close(rg["network"]["energy_j"], rw["network"]["energy_j"],
                        "energy_j")


@pytest.mark.parametrize("path", ["golden", "megakernel", "fused", "percall",
                                  "annotation"])
def test_chip_workload_slice_matches_reference(surrogate_pairs, path):
    got, want = _simulate_both("chip_slice", path, surrogate_pairs)
    assert got.outputs.sum() > 0
    assert_runs_match(got, want)


def test_port_paths_agree(surrogate_pairs):
    """megakernel == fused 3-dispatch == per-call inside the port."""
    import repro_torch.lasana as lasana
    from repro_torch.convert import spec_from_numpy
    ws, knobs, x = _workload("small_net")
    spec = spec_from_numpy(ws, knobs)
    sur = surrogate_pairs["packable"][1]
    runs = {name: lasana.simulate(spec, x, surrogates=sur, device="cpu",
                                  **kw)
            for name, kw in (("megakernel", dict(fused_kernel=True)),
                             ("fused", dict(fused_kernel=False)),
                             ("percall", dict(fused=False)))}
    for name in ("megakernel", "percall"):
        assert_runs_match(runs[name], runs["fused"])


def test_hot_swap_keeps_one_runner(surrogate_pairs):
    """A retrained artifact of the same structure is a weight swap: the
    engine reuses its runner (compile_count stays 1) and the records
    follow the new weights."""
    import repro_torch.lasana as lasana
    from repro_torch.convert import spec_from_numpy
    from repro_torch.core.surrogate import Surrogate
    ws, knobs, x = _workload("small_net")
    spec = spec_from_numpy(ws, knobs)
    sur = surrogate_pairs["packable"][1]
    swapped = Surrogate(sur.manifest, {
        p: {k: (a * 1.5 if p == "M_ES" and k == "b2" else a)
            for k, a in d.items()} for p, d in sur.params.items()})
    a = lasana.simulate(spec, x, surrogates=sur, device="cpu")
    b = lasana.simulate(spec, x, surrogates=swapped, device="cpu")
    assert lasana.engine(spec, device="cpu").compile_count == 1
    assert not np.array_equal(a.energy, b.energy)
    np.testing.assert_array_equal(a.events, b.events)


def test_digit_workload_matches_reference():
    """The port's numpy copy of the digit generator and Poisson encoder
    gives the reference's arrays, so the chip-smoke stimulus is the one
    ``examples/snn_mnist.py`` builds."""
    from repro.data import mnist as jmnist
    from repro_torch.data import mnist
    imgs, labels = mnist.make_digits(12, size=28, seed=777)
    jimgs, jlabels = jmnist.make_digits(12, size=28, seed=777)
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(mnist.poisson_encode(imgs, 6, seed=5),
                                  jmnist.poisson_encode(jimgs, 6, seed=5))


def test_record_matches_jax_on_first_items():
    """The committed reference record: JAX re-run on batch items 0-3 of
    the chip-smoke workload gives the record's per-item fields."""
    import repro.lasana as jax_lasana
    from repro.core.network import snn_spec
    from repro.core.surrogate import Surrogate
    ws, knobs = fx.snn_weights()
    x, _ = fx.chip_workload(n_images=4)
    spec = snn_spec([jnp.asarray(w) for w in ws],
                    [jnp.asarray(p) for p in knobs])
    with np.load(fx.REF_RECORD) as rec:
        for name, (path, fused_kernel) in fx.RECORD_RUNS.items():
            kw = {"backend": "golden"} if path is None else {
                "surrogates": Surrogate.load(str(path)),
                "fused_kernel": fused_kernel}
            run = fx.jax_run_fields(jax_lasana.simulate(
                spec, jnp.asarray(x), **kw))
            np.testing.assert_array_equal(run["outputs"],
                                          rec[f"{name}/outputs"][:4])
            np.testing.assert_array_equal(run["out_spikes"],
                                          rec[f"{name}/out_spikes"][:, :4])


def test_merge_matches_reference_stream(surrogate_pairs):
    """NetworkRun.merge of per-chunk records == the reference's merge."""
    import repro.lasana as jax_lasana
    from repro.core.network import NetworkRun as JaxNetworkRun
    from repro.core.network import snn_spec
    from repro_torch.core.network import NetworkRun
    ws, knobs, x = _workload("small_net")
    spec = snn_spec([jnp.asarray(w) for w in ws],
                    [jnp.asarray(p) for p in knobs])
    jsur = surrogate_pairs["packable"][0]
    chunks = list(jax_lasana.stream(spec, jnp.asarray(x), chunk_ticks=7,
                                    surrogates=jsur, record_hidden=True))
    fields = ("backend", "mode", "outputs", "out_spikes", "layer_spikes",
              "energy", "latency", "events", "flush_energy", "n_circuits",
              "clock_ns", "wall_seconds", "circuits", "compile_seconds")
    merged = NetworkRun.merge(
        NetworkRun(**{f: getattr(c, f) for f in fields}) for c in chunks)
    assert_runs_match(merged, JaxNetworkRun.merge(chunks))
