"""The legacy bank shims (``repro_torch.core.persist``) against the
reference's (``repro.core.persist``).

``save_bank`` freezes a bank into the versioned ``Surrogate`` artifact
(which loads in both packages); ``load_bank`` reads that format and the
pre-facade one (a manifest with a ``predictors`` key and no
``format_version``, scalar model state in the manifest), which it
migrates in memory. Pre-facade files are built as the reference's own
test builds them (``tests/test_persist.py``), from a reference bank and
from a committed artifact's mean / gbdt / mlp heads; the port's migrated
surrogate predicts what the reference's ``load_bank`` predicts, within
rtol 1e-5.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_fixtures as fx  # noqa: E402
from test_torch_fixtures import assert_close  # noqa: E402


def _features(pname, seed, n=64):
    """Raw LIF feature rows (x, v, tau, params[, o_prev, o_new])."""
    from repro.core.predictors import PREDICTOR_DEFS
    d = PREDICTOR_DEFS[pname]
    width = 3 + 2 + 4 + (1 if d["prev_out"] else 0) + \
        (1 if d.get("chain_out") else 0)
    return np.random.default_rng(seed).uniform(
        0, 1, (n, width)).astype(np.float32)


@functools.cache
def _ref_bank():
    """A reference mean+linear LIF bank (the reference test's kind)."""
    from repro.core.dataset import TestbenchConfig, build_dataset
    from repro.core.predictors import PredictorBank
    ds = build_dataset("lif", TestbenchConfig(n_runs=40, n_steps=30, seed=1))
    return PredictorBank("lif", families=("mean", "linear")).fit(ds)


@functools.cache
def _port_bank():
    from repro_torch.core.dataset import (CircuitDataset, TestbenchConfig,
                                          generate_testbench,
                                          simulate_golden)
    from repro_torch.core.events import extract_events, split_runwise
    from repro_torch.core.predictors import PredictorBank
    cfg = TestbenchConfig(n_runs=40, n_steps=30, seed=2)
    trace = simulate_golden("lif", *generate_testbench("lif", cfg, "cpu"))
    splits = split_runwise(extract_events(trace), cfg.n_runs, seed=0)
    return PredictorBank("lif", families=("mean", "linear"),
                         device="cpu").fit(CircuitDataset(
                             "lif", *splits, 0.0, cfg.n_runs))


def _write_legacy(path, circuit, predictors, arrays):
    arrays = dict(arrays)
    arrays["__manifest__"] = np.frombuffer(json.dumps(
        {"circuit": circuit, "predictors": predictors}).encode(),
        dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _assert_predicts_as_reference(port_sur, ref_sur, seed):
    assert port_sur.manifest.predictors == ref_sur.manifest.predictors
    assert port_sur.manifest.families == ref_sur.manifest.families
    assert port_sur.manifest.scales == ref_sur.manifest.scales
    assert port_sur.manifest.features == ref_sur.manifest.features
    for pname in port_sur.manifest.predictors:
        x = _features(pname, seed)
        assert_close(port_sur.predict_np(pname, x),
                     np.asarray(ref_sur.predict(pname, x)), pname)


def test_save_bank_freezes_the_bank_and_warns(tmp_path):
    from repro.core.surrogate import Surrogate as JaxSurrogate
    from repro_torch.core.persist import load_bank, save_bank
    from repro_torch.core.surrogate import Surrogate
    bank = _port_bank()
    path = str(tmp_path / "bank.npz")
    with pytest.deprecated_call():
        save_bank(bank, path)
    sur = Surrogate.load(path, device="cpu")
    with pytest.deprecated_call():
        again = load_bank(path, device="cpu")
    assert sur.manifest == again.manifest
    for pname in bank.selected:
        x = _features(pname, 3)
        want = bank.predict_np(pname, x)
        np.testing.assert_array_equal(again.predict_np(pname, x),
                                      sur.predict_np(pname, x))
        assert_close(sur.predict_np(pname, x), want, pname)
    # the frozen bank crosses to the reference
    _assert_predicts_as_reference(sur, JaxSurrogate.load(path), 4)


def test_load_bank_reads_the_current_format():
    from repro.core.persist import load_bank as ref_load
    from repro_torch.core.persist import load_bank
    with pytest.deprecated_call():
        got = load_bank(str(fx.UNPACKABLE), device="cpu")
    with pytest.deprecated_call():
        want = ref_load(str(fx.UNPACKABLE))
    assert got.device.type == "cpu"
    _assert_predicts_as_reference(got, want, 5)


def test_load_bank_reads_the_prefacade_format(tmp_path):
    """A pre-facade file of a reference mean+linear bank, written as the
    reference's test writes one: the port migrates it to what the
    reference's ``load_bank`` migrates it to."""
    from repro.core.models import LinearModel, MeanModel
    from repro.core.persist import load_bank as ref_load
    from repro_torch.core.persist import load_bank
    from repro_torch.core.surrogate import Surrogate
    bank = _ref_bank()
    predictors, arrays = {}, {}
    for pname, m in bank.selected.items():
        if isinstance(m, MeanModel):
            predictors[pname] = {"family": "mean", "mu": m.mu}
        else:
            assert isinstance(m, LinearModel), type(m)
            predictors[pname] = {"family": "linear"}
            arrays[f"{pname}/w"] = np.asarray(m.w)
            arrays[f"{pname}/mu"] = np.asarray(m.sx.mu)
            arrays[f"{pname}/sd"] = np.asarray(m.sx.sd)
    path = str(tmp_path / "legacy.npz")
    _write_legacy(path, bank.circuit_name, predictors, arrays)
    with pytest.deprecated_call():
        migrated = load_bank(path, device="cpu")
    with pytest.deprecated_call():
        want = ref_load(path)
    assert isinstance(migrated, Surrogate)
    _assert_predicts_as_reference(migrated, want, 6)
    for pname in bank.selected:
        x = _features(pname, 7)
        assert_close(migrated.predict_np(pname, x),
                     np.asarray(bank.predict(pname, x)), pname)


def test_load_bank_migrates_gbdt_and_mlp_heads(tmp_path):
    """A pre-facade file of a mean / gbdt / mlp bank (the gbdt's ``base``
    and the mean's ``mu`` in the manifest, the gbdt's training-only
    ``edges`` beside its trees): migrated as the reference migrates it,
    scales from ``PREDICTOR_DEFS``, the edges dropped."""
    from repro.core.persist import load_bank as ref_load
    from repro_torch.core.persist import load_bank
    with np.load(fx.UNPACKABLE) as z:
        meta = json.loads(bytes(z["__manifest__"].tobytes()).decode())
        stored = {k: z[k] for k in z.files if k != "__manifest__"}
    predictors, arrays = {}, {}
    for pname, fam in meta["families"].items():
        a = {k.split("/", 1)[1]: v for k, v in stored.items()
             if k.startswith(pname + "/")}
        if pname == "M_O":                       # a mean head, old style
            predictors[pname] = {"family": "mean", "mu": 0.25}
            continue
        entry = {"family": fam}
        if fam == "gbdt":
            entry["base"] = float(a.pop("base"))
            a["edges"] = np.linspace(0, 1, 9, dtype=np.float32)
        predictors[pname] = entry
        arrays.update({f"{pname}/{k}": v for k, v in a.items()})
    path = str(tmp_path / "legacy_mixed.npz")
    _write_legacy(path, "lif", predictors, arrays)
    with pytest.deprecated_call():
        got = load_bank(path, device="cpu")
    with pytest.deprecated_call():
        want = ref_load(path)
    assert got.manifest.family_of("M_ES") == "gbdt"
    assert "edges" not in got.params["M_ES"]
    assert got.manifest.scale_of("M_ES") == 1e15
    _assert_predicts_as_reference(got, want, 8)


def test_load_bank_needs_a_card_unless_asked_for_the_cpu():
    from repro_torch.core.persist import load_bank
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.deprecated_call(), pytest.raises(RuntimeError,
                                                 match="device='cpu'"):
        load_bank(str(fx.PACKABLE))
