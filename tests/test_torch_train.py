"""The training pipeline against the reference: the five model families,
the predictor bank, the facade's ``train`` and the artifact crossing both
ways.

Models are fit on the same feature rows in both packages, built from a
small reference dataset (LIF, 120 runs x 50 steps). The host statistics
(standardizers, the table's rows, the linear least-squares solve) and the
CPU GBDT's trees are equal bit for bit; predictions within rtol 1e-5.
The MLP starts from the reference's initial weights (its own draws come
from a ``torch.Generator``) and is held after 1 and 2 epochs.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_fixtures as fx  # noqa: E402
from test_torch_fixtures import assert_close, assert_runs_match  # noqa: E402

N_RUNS, N_STEPS = 120, 50
REDUCED_GBDT = dict(n_trees=8, max_depth=4)


@pytest.fixture(scope="module")
def ref_dataset():
    from repro.core.dataset import TestbenchConfig, build_dataset
    return build_dataset("lif", TestbenchConfig(n_runs=N_RUNS,
                                                n_steps=N_STEPS, seed=0))


def _rows(ds, pname):
    """(xtr, ytr, xva, yva) of predictor ``pname``, augmented as the
    reference's bank builds them at fit time."""
    from repro.core.predictors import (PREDICTOR_DEFS, PredictorBank,
                                       build_features, build_target)
    d = PREDICTOR_DEFS[pname]
    bank = PredictorBank("lif")
    out = []
    for split in (ds.train, ds.val):
        ev = split.of_kind(*d["kinds"])
        out.append(np.asarray(bank.augment_features(build_features(
            ev, prev_out=d["prev_out"], chain_out=d.get("chain_out", False)))))
        out.append(build_target(ev, d["target"], d["scale"]))
    return out


def _families():
    from repro.core import models as ref
    from repro_torch.core import models
    return ref, models


def test_bank_features_equal_reference(ref_dataset):
    """The port's fit-time rows (host numpy, the derived feature with
    numpy's reductions) equal the reference's, bit for bit."""
    from repro.core.predictors import PREDICTOR_DEFS
    from repro_torch.core.predictors import (PredictorBank, build_features,
                                             build_target)
    bank = PredictorBank("lif", device="cpu")
    for pname, d in PREDICTOR_DEFS.items():
        xtr, ytr, _, _ = _rows(ref_dataset, pname)
        ev = ref_dataset.train.of_kind(*d["kinds"])
        got = bank.augment_features(build_features(
            ev, prev_out=d["prev_out"], chain_out=d.get("chain_out", False)))
        np.testing.assert_array_equal(got, xtr)
        np.testing.assert_array_equal(
            build_target(ev, d["target"], d["scale"]), ytr)


@pytest.mark.parametrize("circuit", ["lif", "crossbar"])
def test_augment_np_equals_reference_bank(circuit):
    from repro.core.predictors import PredictorBank as RefBank
    from repro_torch.core.predictors import PredictorBank
    n_in, n_p = (3, 4) if circuit == "lif" else (32, 33)
    rng = np.random.default_rng(0)
    feats = rng.uniform(-1, 1, (257, n_in + 2 + n_p)).astype(np.float32)
    np.testing.assert_array_equal(
        PredictorBank(circuit, device="cpu").augment_features(feats),
        np.asarray(RefBank(circuit).augment_features(feats)))


def test_standardizer_equals_reference(ref_dataset):
    ref, models = _families()
    xtr = _rows(ref_dataset, "M_ED")[0]
    want = ref.Standardizer.fit(xtr)
    got = models.Standardizer.fit(xtr)
    np.testing.assert_array_equal(got.mu, want.mu)
    np.testing.assert_array_equal(got.sd, want.sd)
    assert (got.sd == 1.0).any()          # tau: constant on E1 rows
    np.testing.assert_array_equal(got.apply_t(torch.as_tensor(xtr)).numpy(),
                                  want.apply(xtr))


@pytest.mark.parametrize("family", ["mean", "table", "linear"])
@pytest.mark.parametrize("pname", ["M_V", "M_ED"])
def test_host_statistic_families_equal_reference(ref_dataset, family, pname):
    """mean / table / linear: the fitted arrays bit for bit (M_ED's rows
    carry a constant tau column, so its least-squares system is
    rank-deficient), predictions within rtol 1e-5."""
    ref, models = _families()
    xtr, ytr, xva, yva = _rows(ref_dataset, pname)
    cls = {"mean": "MeanModel", "table": "TableModel",
           "linear": "LinearModel"}[family]
    want = getattr(ref, cls)().fit(xtr, ytr, xva, yva)
    got = getattr(models, cls)(device="cpu").fit(xtr, ytr, xva, yva)
    if family == "mean":
        assert got.mu == want.mu
    else:
        np.testing.assert_array_equal(got.sx.mu, want.sx.mu)
        np.testing.assert_array_equal(got.sx.sd, want.sx.sd)
    if family == "table":
        np.testing.assert_array_equal(got.tx, want.tx)
        np.testing.assert_array_equal(got.ty, want.ty)
    if family == "linear":
        np.testing.assert_array_equal(got.w, want.w)
    assert_close(got.predict(xva), want.predict(xva), f"{family} predict")


@pytest.mark.parametrize("max_depth", [4, 8])
@pytest.mark.parametrize("pname", ["M_O", "M_ES"])
def test_gbdt_cpu_trees_equal_reference(ref_dataset, pname, max_depth):
    """On CPU tensors the histograms sum in row order: feat, thr and the
    kept trees equal the reference's numpy fit, leaves within rtol 1e-6."""
    ref, models = _families()
    xtr, ytr, xva, yva = _rows(ref_dataset, pname)
    kw = dict(n_trees=10, max_depth=max_depth)
    want = ref.GBDTModel(**kw).fit(xtr, ytr, xva, yva)
    got = models.GBDTModel(device="cpu", **kw).fit(xtr, ytr, xva, yva)
    assert got._kept == want._kept
    np.testing.assert_array_equal(got.edges, want.edges)
    assert got.base == want.base
    assert got.feat.dtype == want.feat.dtype
    np.testing.assert_array_equal(got.feat, want.feat)
    np.testing.assert_array_equal(got.thr, want.thr)
    np.testing.assert_allclose(got.leaf, want.leaf, rtol=1e-6, atol=0)
    assert np.isfinite(got.thr).any()
    assert_close(got.predict(xva), want.predict(xva), "gbdt predict")


def test_gbdt_keeps_the_reference_early_stopping_rule():
    """A validation set the later trees overfit: _kept stops before
    n_trees, equal to the reference's."""
    ref, models = _families()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(600, 4)).astype(np.float32)
    y = (x[:, 0] + rng.normal(size=600)).astype(np.float32)
    xva = rng.normal(size=(200, 4)).astype(np.float32)
    yva = xva[:, 0].astype(np.float32)
    kw = dict(n_trees=30, max_depth=6, lr=0.5)
    want = ref.GBDTModel(**kw).fit(x, y, xva, yva)
    got = models.GBDTModel(device="cpu", **kw).fit(x, y, xva, yva)
    assert 0 < want._kept < 30
    assert got._kept == want._kept
    assert got.feat.shape == want.feat.shape


def _ref_init(ref_model, dims):
    params = ref_model._init(jax.random.PRNGKey(ref_model.seed), dims)
    return [{k: torch.as_tensor(np.array(v)) for k, v in lyr.items()}
            for lyr in params]


@pytest.mark.parametrize("epochs", [1, 2])
def test_mlp_epochs_from_the_reference_init(ref_dataset, monkeypatch, epochs):
    """Given the reference's initial weights, the port's Adam lands on the
    reference's parameters, within an absolute part scaled by the largest
    distance Adam can move a weight (lr x steps: where a gradient is near
    zero, Adam's normalized step turns its rounding into a step of order
    lr): after 1 epoch rtol 1e-5 + 1e-4 of it, after 2 rtol 1e-4 + 1e-2 of
    it. The validation MSE within 1e-4 relative."""
    ref, models = _families()
    xtr, ytr, xva, yva = _rows(ref_dataset, "M_V")
    assert len(ytr) >= 3 * 1024
    want = ref.MLPModel(max_epochs=epochs).fit(xtr, ytr, xva, yva)
    got = models.MLPModel(max_epochs=epochs, device="cpu")
    monkeypatch.setattr(got, "_init",
                        lambda gen, dims: _ref_init(want, dims))
    got.fit(xtr, ytr, xva, yva)
    steps = epochs * (len(ytr) // got.batch)
    for g, w in zip(got.params, want.params):
        for k in ("w", "b"):
            rtol, share = (1e-5, 1e-4) if epochs == 1 else (1e-4, 1e-2)
            np.testing.assert_allclose(g[k], np.asarray(w[k]), rtol=rtol,
                                       atol=share * got.lr * steps)
    mse_got = float(np.mean((got.predict(xva) - yva) ** 2))
    mse_want = float(np.mean((want.predict(xva) - yva) ** 2))
    assert abs(mse_got - mse_want) <= 1e-4 * mse_want


def test_mlp_init_is_he_normal_from_the_generator():
    _, models = _families()
    m = models.MLPModel(device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = m._init(gen, (12, 100, 50, 1))
    assert [tuple(p["w"].shape) for p in params] == [(12, 100), (100, 50),
                                                     (50, 1)]
    assert all((p["b"] == 0).all() for p in params)
    std = float(params[1]["w"].std())
    assert abs(std - np.sqrt(2.0 / 100)) < 0.01
    again = m._init(torch.Generator().manual_seed(0), (12, 100, 50, 1))
    assert torch.equal(params[0]["w"], again[0]["w"])


def test_mlp_learns_nonlinearity():
    """The reference's test_mlp_learns_nonlinearity, on the port: the same
    target, the same bar (MSE below half the target's variance)."""
    _, models = _families()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4000, 8)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.5 * x[:, 1] * x[:, 2] + 0.2 * x[:, 3]
         + 0.05 * rng.normal(size=4000)).astype(np.float32)
    xtr, ytr, xte, yte = x[:2000], y[:2000], x[2000:], y[2000:]
    m = models.MLPModel(max_epochs=60, patience=10, device="cpu").fit(
        xtr, ytr, xte[:500], yte[:500])
    mse = float(np.mean((m.predict(xte) - yte) ** 2))
    assert mse < 0.5 * float(np.var(yte)), mse


def test_mlp_predict_goes_through_mlp_surrogate(ref_dataset, monkeypatch):
    """Validation passes and predictions call kernels.mlp_surrogate (its
    plain version on CPU tensors)."""
    from repro_torch.core import models
    calls = []
    real = models.mlp_surrogate
    monkeypatch.setattr(models, "mlp_surrogate",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    xtr, ytr, xva, yva = _rows(ref_dataset, "M_ED")
    m = models.MLPModel(max_epochs=3, device="cpu").fit(xtr, ytr, xva, yva)
    assert calls == [xva.shape] * 3
    m.predict(xva[:10])
    assert calls[-1] == (10, xva.shape[1])


def _reduced_gbdt(monkeypatch):
    """Both packages' bank fit the reduced GBDT."""
    from repro.core import models as ref_models
    from repro.core import predictors as ref_pred
    from repro_torch.core import models, predictors
    monkeypatch.setitem(ref_pred.MODEL_FAMILIES, "gbdt", functools.partial(
        ref_models.GBDTModel, **REDUCED_GBDT))
    monkeypatch.setitem(predictors.MODEL_FAMILIES, "gbdt", functools.partial(
        models.GBDTModel, **REDUCED_GBDT))


@pytest.fixture
def banks(ref_dataset, monkeypatch):
    """(port bank on the CPU, reference bank), ("mean", "linear",
    "gbdt") with the reduced GBDT, fit on the same dataset."""
    from repro.core.predictors import PredictorBank as RefBank
    from repro_torch.core.predictors import PredictorBank
    _reduced_gbdt(monkeypatch)
    fams = ("mean", "linear", "gbdt")
    got = PredictorBank("lif", families=fams, device="cpu").fit(ref_dataset)
    want = RefBank("lif", families=fams).fit(ref_dataset)
    return got, want


def test_bank_selects_as_the_reference(banks):
    got, want = banks
    assert set(got.results) == set(want.results)
    for p, fams in want.results.items():
        for f, r in fams.items():
            g = got.results[p][f]
            for k in ("val_mse", "test_mse", "test_mape"):
                np.testing.assert_allclose(getattr(g, k), getattr(r, k),
                                           rtol=1e-5, err_msg=f"{p} {f} {k}")
        assert (type(got.selected[p]).__name__
                == type(want.selected[p]).__name__)
    rows = got.table_rows()
    assert len(rows) == 15 and sum(r["selected"] for r in rows) == 5


def test_bank_predict_in_physical_units(banks):
    got, want = banks
    rng = np.random.default_rng(0)
    feats = np.concatenate([rng.uniform(0, 1, (64, 3)), rng.uniform(0, 1, (
        64, 1)), np.full((64, 1), 5.0), rng.uniform(0.5, 0.8, (64, 4)),
        rng.uniform(0, 1.5, (64, 2))], axis=1).astype(np.float32)
    for p in ("M_ES", "M_V", "M_ED"):
        f = feats if p == "M_ED" else feats[:, :9]
        assert_close(got.predict_np(p, f), want.predict_np(p, f), p)
        assert_close(got.predict(p, f).numpy(), want.predict_np(p, f), p)


def test_artifact_crosses_to_the_reference(banks, tmp_path):
    """A port-trained surrogate saves, loads in repro.lasana.load with its
    fit_info, and the reference's simulate with it equals the port's on
    the 12-8-4 SNN (discrete records identical, continuous within rtol
    1e-5)."""
    import repro.lasana as jax_lasana
    import repro_torch.lasana as lasana
    from repro.core.network import snn_spec
    from repro_torch.convert import spec_from_numpy
    from repro_torch.core.surrogate import Surrogate, as_surrogate
    got, want = banks
    sur = Surrogate.from_bank(got)
    assert as_surrogate(got).manifest == sur.manifest
    path = str(tmp_path / "lif_port.npz")
    sur.save(path)
    ref_sur = jax_lasana.load(path)
    ref_own = want.to_surrogate()
    assert ref_sur.manifest == ref_own.manifest
    assert ref_sur.fit_info == sur.fit_info
    assert set(ref_sur.fit_info["M_O"]) == {"mean", "linear", "gbdt"}
    for p in sur.params:
        assert set(sur.params[p]) == set(ref_own.params[p])
    back = lasana.load(path, device="cpu")
    assert back.fit_info == sur.fit_info
    ws, knobs, x = fx.small_net()
    x[-3:] = 0.0
    jspec = snn_spec([jnp.asarray(w) for w in ws],
                     [jnp.asarray(p) for p in knobs])
    want_run = jax_lasana.simulate(jspec, jnp.asarray(x), surrogates=ref_sur)
    got_run = lasana.simulate(spec_from_numpy(ws, knobs), x, surrogates=sur,
                              device="cpu")
    assert_runs_match(got_run, want_run)


def test_train_on_the_cpu_returns_a_surrogate():
    import repro_torch.lasana as lasana
    cfg = lasana.TrainConfig(n_runs=40, n_steps=30, families=("mean",
                                                             "linear"))
    sur = lasana.train("lif", cfg, device="cpu")
    assert isinstance(sur, lasana.Surrogate) and sur.circuit == "lif"
    assert sur.device.type == "cpu"
    assert set(sur.fit_info) == {"M_O", "M_V", "M_ED", "M_ES", "M_L"}
    assert set(sur.fit_info["M_V"]) == {"mean", "linear"}
    assert set(sur.train_report["seconds"]) == {
        "testbench", "golden", "events", "features", "mean", "linear",
        "freeze"}
    counts = sur.train_report["events"]
    assert set(counts) == {"E1", "E2", "E3"} and counts["E1"] + counts[
        "E3"] > 0
    assert {f for _, f in sur.manifest.families} <= {"mean", "linear"}
    assert sur.manifest.features[:3] == ("x0", "x1", "x2")


def test_train_needs_a_card_unless_asked_for_the_cpu():
    import repro_torch.lasana as lasana
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lasana.train("lif", lasana.TrainConfig(n_runs=4, n_steps=3,
                                               families=("mean",)))


def _surface_block(name, obj):
    """``tools/check_api.py``'s snapshot lines of one facade symbol: its
    signature, and each public member's with its kind."""
    import inspect
    kind = "class" if inspect.isclass(obj) else "function"
    lines = [f"{name} [{kind}]{inspect.signature(obj)}"]
    if inspect.isclass(obj):
        for mname, member in sorted(vars(obj).items()):
            if mname.startswith("_"):
                continue
            tag, target = "method", member
            if isinstance(member, property):
                tag, target = "property", member.fget
            elif isinstance(member, classmethod):
                tag, target = "classmethod", member.__func__
            lines.append(f"  .{mname} [{tag}]{inspect.signature(target)}"
                         if callable(target) else f"  .{mname} [attribute]")
    return lines


def test_facade_names_are_the_reference_s():
    import repro_torch.lasana as lasana
    surface = (fx.ROOT / "tests" / "data" / "api_surface.txt").read_text()
    assert "TrainConfig" in lasana.__all__ and "train" in lasana.__all__
    for name in lasana.__all__:
        assert name in surface, name
    # the exploration surface, signature for signature
    snapshot = surface.splitlines()
    for name in ("explore", "CandidateSpec", "DSEReport"):
        assert name in lasana.__all__
        block = _surface_block(name, getattr(lasana, name))
        start = snapshot.index(block[0])
        assert snapshot[start:start + len(block)] == block
        nxt = start + len(block)
        assert nxt == len(snapshot) or not snapshot[nxt].startswith("  .")
    # every name of the surface is in the port's facade (the mesh=
    # argument is still to come), serve with the reference's signature
    missing = {line.split(" ", 1)[0] for line in snapshot
               if not line.startswith(" ")} - set(lasana.__all__)
    assert missing == set()
    assert _surface_block("serve", lasana.serve) == [
        next(line for line in snapshot if line.startswith("serve "))]
    import repro.lasana as jax_lasana
    assert lasana.TrainConfig() == lasana.TrainConfig(
        **{f: getattr(jax_lasana.TrainConfig(), f) for f in (
            "n_runs", "n_steps", "alpha", "seed", "families")})


def test_train_record_loads_at_the_facade_shapes():
    """The committed JAX record of lasana.train("lif", TrainConfig()):
    the testbench at TrainConfig()'s shapes, the dataset's counts and the
    five families' fits per predictor."""
    import repro_torch.lasana as lasana
    cfg = lasana.TrainConfig()
    with np.load(fx.TRAIN_RECORD) as z:
        rec = {k: z[k] for k in z.files}
    assert rec["active"].shape == (cfg.n_runs, cfg.n_steps)
    assert rec["active"].dtype == bool and rec["active"][:, 0].all()
    assert rec["inputs"].shape == (cfg.n_runs, cfg.n_steps, 3)
    assert rec["params"].shape == (cfg.n_runs, 4)
    assert int(rec["seed"]) == cfg.seed
    assert float(rec["alpha"]) == np.float32(cfg.alpha)
    n = sum(int(rec[f"count/{k}"]) for k in ("E1", "E2", "E3"))
    assert n == sum(int(rec[f"split_count/{s}"]) for s in
                    ("train", "test", "val"))
    assert int(rec["count/E1"]) + int(rec["count/E3"]) == int(
        rec["active"].sum())
    for p in fx.PREDICTORS:
        assert str(rec[f"selected/{p}"]) in fx.FAMILIES
        for f in fx.FAMILIES:
            assert np.isfinite(rec[f"val_mse/{p}/{f}"])
        band = rec[f"gbdt_band/{p}"]
        assert band.shape == (fx.GBDT_BAND_REFITS,) and np.isfinite(
            band).all()
        # a one-ULP nudge moves the fit by rounding-scale or tree-flip
        # amounts, never by an order of magnitude
        assert (np.abs(band / rec[f"val_mse/{p}/gbdt"] - 1) < 0.25).all()
