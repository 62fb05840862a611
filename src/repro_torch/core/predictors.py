"""The five LASANA predictors (paper §IV-B) and model selection.

Port of ``repro.core.predictors``:

  M_O   output predictor        — E1+E3 events (input-change events)
  M_V   state predictor         — all events
  M_E_D dynamic energy          — E1 only; + previous and new output
  M_E_S static energy           — E2+E3
  M_L   latency                 — E1 only; + previous and new output

All take features (x, v', tau, p); energies are trained in femtojoules.
Every family in ``families`` is fit per predictor on the bank's device
and the best validation-MSE model is selected; the validation and test
errors are computed on the host in numpy, as the reference computes them.
Feature rows are built on the host; the circuit's derived interface
feature is appended there with numpy's own reductions, which is what the
reference's bank computes at fit time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.circuits import (CrossbarRow, LIFNeuron,
                                       augment_features, get_circuit)
from repro_torch.core.events import EventKind, EventSet
from repro_torch.core.models import MODEL_FAMILIES, SurrogateModel
from repro_torch.kernels import ops

FJ = 1e15      # joules -> femtojoules

PREDICTOR_DEFS: dict[str, dict] = {
    "M_O": dict(kinds=(EventKind.E1, EventKind.E3), target="o_end",
                prev_out=False, scale=1.0),
    "M_V": dict(kinds=(EventKind.E1, EventKind.E2, EventKind.E3),
                target="v_end", prev_out=False, scale=1.0),
    "M_ED": dict(kinds=(EventKind.E1,), target="energy", prev_out=True,
                 scale=FJ, chain_out=True),
    "M_ES": dict(kinds=(EventKind.E2, EventKind.E3), target="energy",
                 prev_out=False, scale=FJ),
    "M_L": dict(kinds=(EventKind.E1,), target="latency", prev_out=True,
                scale=1.0, chain_out=True),
}
# chain_out: M_ED / M_L also take the NEW output as a feature (teacher-
# forced with the golden output at fit time, M_O's prediction at serving
# time), as in the reference.


def build_features(events: EventSet, *, prev_out: bool,
                   chain_out: bool = False) -> np.ndarray:
    cols = [events.x, events.v_start[:, None], events.tau[:, None],
            events.params]
    if prev_out:
        cols.append(events.o_prev[:, None])
    if chain_out:
        cols.append(events.o_end[:, None])   # teacher forcing at fit time
    return np.concatenate(cols, axis=1).astype(np.float32)


def build_target(events: EventSet, name: str, scale: float) -> np.ndarray:
    return (getattr(events, name) * scale).astype(np.float32)


def feature_dim(n_inputs: int, n_params: int, *, prev_out: bool,
                chain_out: bool = False) -> int:
    return (n_inputs + 1 + 1 + n_params + (1 if prev_out else 0)
            + (1 if chain_out else 0))


def augment_features_np(circuit, feats: np.ndarray) -> np.ndarray:
    """Host rows plus the circuit's derived interface feature, computed
    with numpy's reductions (the crossbar's ``w . x`` pairwise): what the
    reference's bank appends at fit time. Serving appends it on the device
    (``circuits.augment_features``, index-order sums, as the reference's
    compiled serving does)."""
    if circuit is None:
        return feats
    n_in, n_p = circuit.n_inputs, circuit.n_params
    x = feats[:, :n_in]
    p = feats[:, n_in + 2: n_in + 2 + n_p]
    if isinstance(circuit, LIFNeuron):
        extra = x[..., 0] * x[..., 1] * x[..., 2] / 5.0
    elif isinstance(circuit, CrossbarRow):
        w, bias = p[..., :n_in], p[..., n_in]
        extra = (w * x).sum(axis=-1) + bias * circuit.v_bias
    else:
        return feats
    return np.concatenate([feats, extra[:, None]], axis=1)


@dataclasses.dataclass
class FitResult:
    model: SurrogateModel
    family: str
    val_mse: float
    test_mse: float
    test_mape: float
    train_time: float
    test_time: float


def _mape(y, yh, floor=None):
    denom = np.abs(y)
    if floor is None:
        floor = max(np.percentile(denom, 10), 1e-9)
    return float(np.mean(np.abs(yh - y) / np.maximum(denom, floor)) * 100)


class PredictorBank:
    """Trains, selects, and serves the five predictors for one circuit, on
    ``device`` (default ``cuda``)."""

    def __init__(self, circuit_name: str,
                 families: tuple[str, ...] = ("mean", "table", "linear",
                                              "gbdt", "mlp"),
                 device=None):
        self.circuit_name = circuit_name
        self.families = families
        self.device = ops.resolve_device(device)
        self.results: dict[str, dict[str, FitResult]] = {}
        self.selected: dict[str, SurrogateModel] = {}
        self.scales = {k: d["scale"] for k, d in PREDICTOR_DEFS.items()}
        # host seconds: feature building, and each family's fit + predict
        self.seconds = {"features": 0.0}
        try:
            self._circuit = get_circuit(circuit_name)
        except KeyError:
            self._circuit = None

    def augment_features(self, feats):
        """Append the circuit's derived interface features: host rows as
        the reference's bank does at fit time (:func:`augment_features_np`),
        tensors as serving does (``circuits.augment_features``)."""
        if isinstance(feats, torch.Tensor):
            return augment_features(self._circuit, feats)
        return augment_features_np(self._circuit, feats)

    def fit(self, dataset, *, families: Optional[tuple[str, ...]] = None,
            verbose: bool = False) -> "PredictorBank":
        families = families or self.families
        for pname, d in PREDICTOR_DEFS.items():
            t0 = time.time()
            chain = d.get("chain_out", False)
            split = {}
            for name in ("train", "val", "test"):
                ev = getattr(dataset, name).of_kind(*d["kinds"])
                split[name] = (
                    self.augment_features(build_features(
                        ev, prev_out=d["prev_out"], chain_out=chain)),
                    build_target(ev, d["target"], d["scale"]))
            (xtr, ytr), (xva, yva), (xte, yte) = (
                split["train"], split["val"], split["test"])
            self.seconds["features"] += time.time() - t0
            self.results[pname] = {}
            for fam in families:
                t0 = time.time()
                model = MODEL_FAMILIES[fam](device=self.device)
                model.fit(xtr, ytr, xva, yva)
                t1 = time.time()
                yh_va = model.predict(xva)
                yh_te = model.predict(xte)
                t_test = time.time() - t1
                res = FitResult(
                    model=model, family=fam,
                    val_mse=float(np.mean((yh_va - yva) ** 2)),
                    test_mse=float(np.mean((yh_te - yte) ** 2)),
                    test_mape=_mape(yte, yh_te),
                    train_time=model.train_time, test_time=t_test)
                self.results[pname][fam] = res
                self.seconds[fam] = self.seconds.get(fam, 0.0) + (
                    time.time() - t0)
                if verbose:
                    print(f"  {pname:5s} {fam:7s} val_mse={res.val_mse:.4g} "
                          f"test_mse={res.test_mse:.4g} mape={res.test_mape:.2f}% "
                          f"({res.train_time:.1f}s train)")
            best = min(self.results[pname].values(), key=lambda r: r.val_mse)
            self.selected[pname] = best.model
            if verbose:
                print(f"  {pname}: selected {best.family}")
        return self

    def to_surrogate(self):
        """Freeze the selected predictors into a
        :class:`repro_torch.core.surrogate.Surrogate` on the bank's device."""
        from repro_torch.core.surrogate import Surrogate
        return Surrogate.from_bank(self)

    # --- inference (the deployable form is to_surrogate()) -------------------

    def predict(self, pname: str, feats):
        """Device prediction in physical units (energy back to joules) on
        raw (x, v, tau, params[, ...]) rows."""
        feats = torch.as_tensor(feats, dtype=torch.float32,
                                device=self.device)
        y = self.selected[pname].predict_t(self.augment_features(feats))
        return ops.div(y, self.scales[pname])

    def predict_np(self, pname: str, feats: np.ndarray) -> np.ndarray:
        return (self.selected[pname].predict(self.augment_features(
            np.asarray(feats, np.float32))) / self.scales[pname])

    # --- reporting ------------------------------------------------------------

    def table_rows(self) -> list[dict]:
        rows = []
        for pname, fams in self.results.items():
            for fam, r in fams.items():
                rows.append(dict(circuit=self.circuit_name, predictor=pname,
                                 family=fam, val_mse=r.val_mse,
                                 test_mse=r.test_mse, test_mape=r.test_mape,
                                 train_s=r.train_time, test_s=r.test_time,
                                 selected=self.selected[pname] is r.model))
        return rows
