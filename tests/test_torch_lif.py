"""Port parity: the golden LIF integrator (``repro_torch`` vs ``repro``).

The port's ``LIFNeuron.step`` runs ``ops.lif_step``, whose plain PyTorch
version (``lif_scan._period_math``) is what a CPU tensor gets. It is held
against the JAX ``LIFNeuron.step`` and against the JAX Pallas ``lif_step``
in interpret mode on the same numpy inputs: spike flags and outputs
identical, state / energy / latency to rtol 1e-5 (XLA and PyTorch round
some fp32 ``exp`` results 1 ULP apart).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_fixtures import assert_close  # noqa: E402

N_CASES = [5, 256, 300]


def _inputs(n: int, seed: int):
    """(state, x, params) numpy rows that make a good share of neurons
    spike within the period, some of them from refractory state."""
    rng = np.random.default_rng(seed)
    state = np.stack([rng.uniform(0, 1.0, n), rng.uniform(0, 0.3, n),
                      rng.uniform(0, 3.0, n) * (rng.random(n) < 0.3)],
                     axis=1).astype(np.float32)
    x = np.stack([rng.uniform(-1, 1, n), rng.uniform(0, 1.5, n),
                  rng.integers(0, 6, n)], axis=1).astype(np.float32)
    params = rng.uniform(0.5, 0.8, (n, 4)).astype(np.float32)
    return state, x, params


def _port_step(state, x, params):
    from repro_torch.core.circuits import LIFNeuron
    t = lambda a: torch.as_tensor(a)
    new_state, obs = LIFNeuron().step(t(state), t(x), t(params))
    return new_state.numpy(), {k: v.numpy() for k, v in obs.items()}


def _assert_step_match(got, want):
    (gs, go), (ws, wo) = got, want
    np.testing.assert_array_equal(go["spiked"], np.asarray(wo["spiked"]))
    np.testing.assert_array_equal(go["output"], np.asarray(wo["output"]))
    assert_close(gs, ws, "state")
    assert_close(go["energy"], wo["energy"], "energy")
    assert_close(go["latency"], wo["latency"], "latency")


@pytest.mark.parametrize("n", N_CASES)
def test_lif_step_matches_circuit_step(n):
    from repro.core.circuits import LIFNeuron
    state, x, params = _inputs(n, seed=n)
    got = _port_step(state, x, params)
    assert got[1]["spiked"].any() and not got[1]["spiked"].all()
    ws, wo = jax.jit(LIFNeuron().step)(jnp.asarray(state), jnp.asarray(x),
                                       jnp.asarray(params))
    _assert_step_match(got, (np.asarray(ws),
                             {k: np.asarray(v) for k, v in wo.items()}))


@pytest.mark.parametrize("n", N_CASES)
def test_plain_lif_step_matches_pallas_interpret(n):
    from repro.kernels import ops as jax_ops
    from repro_torch.kernels import ops
    state, x, params = _inputs(n, seed=1000 + n)
    ns, obs = ops.lif_step(torch.as_tensor(state), torch.as_tensor(x),
                           torch.as_tensor(params))
    assert obs["spiked"].dtype == torch.bool
    ws, wo = jax_ops.lif_step(jnp.asarray(state), jnp.asarray(x),
                              jnp.asarray(params), interpret=True)
    _assert_step_match((ns.numpy(), {k: v.numpy() for k, v in obs.items()}),
                       (np.asarray(ws), {k: np.asarray(v)
                                         for k, v in wo.items()}))


@pytest.mark.parametrize("n", N_CASES)
def test_behavioral_step_matches(n):
    from repro.core.circuits import LIFNeuron as JaxLIF
    from repro_torch.core.circuits import LIFNeuron
    state, x, params = _inputs(n, seed=2000 + n)
    v = state[:, 0]
    gv, go = LIFNeuron().behavioral_step(torch.as_tensor(v),
                                         torch.as_tensor(x),
                                         torch.as_tensor(params))
    wv, wo = JaxLIF().behavioral_step(jnp.asarray(v), jnp.asarray(x),
                                      jnp.asarray(params))
    np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
    assert_close(gv.numpy(), wv, "v")


def test_surrogate_features_match():
    from repro.core.circuits import LIFNeuron as JaxLIF
    from repro.core.circuits import augment_features as jax_augment
    from repro_torch.core.circuits import LIFNeuron, augment_features
    rng = np.random.default_rng(3)
    feats = rng.normal(0, 1, (40, 9)).astype(np.float32)
    got = augment_features(LIFNeuron(), torch.as_tensor(feats)).numpy()
    want = np.asarray(jax_augment(JaxLIF(), jnp.asarray(feats)))
    assert got.shape == (40, 10)
    assert_close(got, want, "augmented")


def test_lif_step_on_a_non_cpu_tensor_never_falls_back():
    """A tensor that is not on the CPU goes to the kernel launcher, which
    refuses anything but one CUDA device — it never takes the plain
    version instead."""
    from repro_torch.kernels import ops
    meta = [torch.empty((4, k), device="meta") for k in (3, 3, 4)]
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        ops.lif_step(*meta)
    assert ops.LAUNCHES == before


def test_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.kernels import ops
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.resolve_device("cuda")
    assert ops.resolve_device("cpu") == torch.device("cpu")


def test_fused_kernel_switch_resolution(monkeypatch):
    """Keyword wins, then REPRO_FUSED_KERNEL, then on."""
    from repro_torch.kernels import ops
    monkeypatch.delenv("REPRO_FUSED_KERNEL", raising=False)
    assert ops.fused_kernel_enabled() is True
    assert ops.fused_kernel_enabled(False) is False
    monkeypatch.setenv("REPRO_FUSED_KERNEL", "0")
    assert ops.fused_kernel_enabled() is False
    assert ops.fused_kernel_enabled(True) is True
    monkeypatch.setenv("REPRO_FUSED_KERNEL", "1")
    assert ops.fused_kernel_enabled() is True
