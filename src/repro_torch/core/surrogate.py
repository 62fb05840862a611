"""The deployable LASANA artifact (port of ``repro.core.surrogate``).

A :class:`Surrogate` is a static :class:`Manifest` plus one dict of
tensors per selected predictor, on one device. It reads and writes the
reference's ``.npz`` layout unchanged — arrays keyed ``{pname}/{key}``
plus a JSON ``__manifest__`` carrying :data:`FORMAT_VERSION` — so an
artifact trained by the JAX package runs here and one saved here loads
there.

Per-family array schemas::

    mean    mu ()                       constant
    linear  w (F+1,), mu (F,), sd (F,)  standardized affine
    table   tx (R,F), ty (R,), mu, sd   1-nearest-neighbor
    gbdt    feat (T,N), thr (T,N), leaf (T,L), base ()   complete trees
    mlp     w0,b0,...  x_mu,x_sd (F,), y_mu,y_sd (1,)    MLP(100, 50)

Treat instances as immutable: :meth:`predict_heads` caches the stacks of
same-family heads it builds (the reference builds them at trace time),
and ``NetworkEngine`` keys its runners on the arrays' shapes.
:meth:`Surrogate.from_bank` freezes a fitted ``PredictorBank``'s selected
models into these arrays, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.core.circuits import augment_features, get_circuit
from repro_torch.kernels import gbdt_walk, ops

FORMAT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Manifest:
    """Static (hashable) description of a :class:`Surrogate`: circuit kind,
    format version, ((predictor, family), ...), ((predictor, scale), ...)
    and the raw feature column names."""

    circuit: str
    format_version: int
    families: tuple
    scales: tuple
    features: tuple

    def family_of(self, pname: str) -> str:
        """Model family serving predictor ``pname``."""
        return dict(self.families)[pname]

    def scale_of(self, pname: str) -> float:
        """Training-unit scale of predictor ``pname`` (1.0 = physical)."""
        return dict(self.scales)[pname]

    @property
    def predictors(self) -> tuple:
        """Predictor names carried by this surrogate, sorted."""
        return tuple(p for p, _ in self.families)


def _npz_path(path: str) -> str:
    """``save("foo")`` and ``load("foo")`` both mean ``foo.npz``."""
    return path if path.endswith(".npz") else path + ".npz"


# --- per-family inference (pure functions of (arrays, features)) -------------

def _predict_mean(a, x):
    return a["mu"].reshape(()).expand(x.shape[0])


def _predict_linear(a, x):
    xs = (x - a["mu"]) / a["sd"]
    return xs @ a["w"][:-1] + a["w"][-1]


def _predict_table(a, x):
    xs = (x - a["mu"]) / a["sd"]
    tx = a["tx"]
    d = (tx * tx).sum(-1)[None, :] - 2.0 * (xs @ tx.T)
    return a["ty"][torch.argmin(d, dim=1)]


def _predict_gbdt(a, x, fused_kernel, forests: dict):
    """One ``gbdt_walk`` launch on the card (its plain version on the
    CPU) on the head's tables as ``gbdt_walk.forest`` converts them,
    cached in ``forests`` by row width; with the fused-kernel switch off,
    the eager walk."""
    if not ops.fused_kernel_enabled(fused_kernel):
        return gbdt_walk.gbdt_plain(x, a["feat"], a["thr"], a["leaf"],
                                    a["base"])
    f = x.shape[1]
    if f not in forests:
        forests[f] = gbdt_walk.forest(a["feat"], a["thr"], a["leaf"],
                                      a["base"], f)
    return ops.gbdt_walk(x, *forests[f])


def _predict_mlp(a, x):
    h = (x - a["x_mu"]) / a["x_sd"]
    n_layers = sum(1 for k in a if k.startswith("w"))
    for i in range(n_layers):
        h = h @ a[f"w{i}"] + a[f"b{i}"]
        if i < n_layers - 1:
            h = torch.relu(h)
    return h[..., 0] * a["y_sd"][0] + a["y_mu"][0]


FAMILY_PREDICT = {
    "mean": _predict_mean,
    "linear": _predict_linear,
    "table": _predict_table,
    "mlp": _predict_mlp,
    # gbdt: _predict_gbdt, on tables Surrogate._head caches per head
}


# --- stacked (multi-head) family inference ------------------------------------
#
# predict_heads evaluates every same-family head that shares one feature
# matrix in ONE batched pass over (P, ...) stacks of the heads' arrays.
# Batched products reassociate reductions, so stacked results may differ
# from the per-head functions by a few ULPs (rtol 1e-5); single-head groups
# stay on the per-head functions.

def _predict_mean_stacked(s, x):
    return s["mu"].reshape(-1, 1).expand(-1, x.shape[0])


def _predict_linear_stacked(s, x):
    xs = (x[None] - s["mu"][:, None]) / s["sd"][:, None]
    return torch.einsum("pnf,pf->pn", xs, s["w"][:, :-1]) + s["w"][:, -1:]


def _predict_table_stacked(s, x):
    xs = (x[None] - s["mu"][:, None]) / s["sd"][:, None]
    d = (s["tx"] * s["tx"]).sum(-1)[:, None, :] \
        - 2.0 * torch.einsum("pnf,prf->pnr", xs, s["tx"])
    return torch.take_along_dim(s["ty"], torch.argmin(d, dim=2), dim=1)


def _predict_mlp_stacked(s, x, fused_kernel=None):
    n_layers = sum(1 for k in s if k.startswith("w"))
    if n_layers == 3 and ops.fused_kernel_enabled(fused_kernel):
        # 3-layer heads of any widths: all P heads in one
        # mlp_surrogate_heads launch on the card (its plain version on
        # the CPU)
        return ops.mlp_surrogate_heads(
            x, s["x_mu"], s["x_sd"], s["y_mu"], s["y_sd"],
            s["w0"], s["b0"], s["w1"], s["b1"], s["w2"], s["b2"])
    h = (x[None] - s["x_mu"][:, None]) / s["x_sd"][:, None]
    for i in range(n_layers):
        h = torch.einsum("pnf,pfh->pnh", h, s[f"w{i}"]) + s[f"b{i}"][:, None]
        if i < n_layers - 1:
            h = torch.relu(h)
    return h[..., 0] * s["y_sd"][:, :1] + s["y_mu"][:, :1]


FAMILY_PREDICT_STACKED = {
    "mean": _predict_mean_stacked,
    "linear": _predict_linear_stacked,
    "table": _predict_table_stacked,
    "mlp": _predict_mlp_stacked,
    # gbdt: per-head traversal only, as in the reference
}

# the Algorithm-1 head schedule: which predictors read which of the three
# per-tick feature variants (wrapper.lasana_step builds exactly these)
ALG1_HEADS = {
    "idle": ("M_ES", "M_V"),
    "act": ("M_O", "M_V", "M_ES"),
    "tr": ("M_ED", "M_L"),
}


def _augment(circuit_name: str, feats):
    """Append the circuit's derived interface features (the fit-time
    ``circuits.augment_features`` call)."""
    try:
        circ = get_circuit(circuit_name)
    except KeyError:
        circ = None
    return augment_features(circ, feats)


def _feature_names(circuit_name: str) -> tuple:
    try:
        circ = get_circuit(circuit_name)
    except KeyError:
        return ()
    return (tuple(f"x{i}" for i in range(circ.n_inputs)) + ("v", "tau")
            + tuple(f"p{i}" for i in range(circ.n_params)))


def _model_arrays(model) -> tuple:
    """Freeze a fitted ``models.SurrogateModel`` -> (family, host arrays):
    inference state only (the GBDT's bin edges are dropped), under the
    reference's family names and keys."""
    from repro_torch.core.models import (GBDTModel, LinearModel, MLPModel,
                                         MeanModel, TableModel)
    if isinstance(model, MeanModel):
        return "mean", {"mu": np.float32(model.mu)}
    if isinstance(model, LinearModel):
        return "linear", {"w": model.w, "mu": model.sx.mu, "sd": model.sx.sd}
    if isinstance(model, TableModel):
        return "table", {"tx": model.tx, "ty": model.ty,
                         "mu": model.sx.mu, "sd": model.sx.sd}
    if isinstance(model, GBDTModel):
        return "gbdt", {"feat": model.feat, "thr": model.thr,
                        "leaf": model.leaf, "base": np.float32(model.base)}
    if isinstance(model, MLPModel):
        arrays = {}
        for i, lyr in enumerate(model.params):
            arrays[f"w{i}"] = np.asarray(lyr["w"])
            arrays[f"b{i}"] = np.asarray(lyr["b"])
        arrays.update({"x_mu": model.sx.mu, "x_sd": model.sx.sd,
                       "y_mu": model.sy.mu, "y_sd": model.sy.sd})
        return "mlp", arrays
    raise TypeError(f"cannot freeze {type(model).__name__} into a Surrogate")


# --- the artifact -------------------------------------------------------------

@dataclasses.dataclass(eq=False, repr=False)
class Surrogate:
    """Immutable inference artifact: selected-predictor tensors + manifest.

    ``fit_info`` carries the optional training metrics persisted in the
    manifest JSON; ``train_report``, set by ``lasana.train`` and not
    persisted, the seconds of each training stage and the dataset's event
    counts."""

    manifest: Manifest
    params: dict
    fit_info: Optional[dict] = None
    train_report: Optional[dict] = dataclasses.field(default=None,
                                                     repr=False)
    _stacks: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False)
    _forests: dict = dataclasses.field(default_factory=dict, init=False,
                                       repr=False)

    @classmethod
    def from_bank(cls, bank) -> "Surrogate":
        """Freeze a fitted ``PredictorBank``'s selected models onto the
        bank's device, with every family's fit metrics as ``fit_info``."""
        families, scales, params = [], [], {}
        for pname in sorted(bank.selected):
            fam, arrays = _model_arrays(bank.selected[pname])
            families.append((pname, fam))
            scales.append((pname, float(bank.scales[pname])))
            params[pname] = {k: torch.as_tensor(np.array(v),
                                                device=bank.device)
                             for k, v in arrays.items()}
        fit_info = None
        if bank.results:
            fit_info = {
                p: {f: {"val_mse": r.val_mse, "test_mse": r.test_mse,
                        "test_mape": r.test_mape}
                    for f, r in fams.items()}
                for p, fams in bank.results.items()}
        manifest = Manifest(
            circuit=bank.circuit_name, format_version=FORMAT_VERSION,
            families=tuple(families), scales=tuple(scales),
            features=_feature_names(bank.circuit_name))
        return cls(manifest=manifest, params=params, fit_info=fit_info)

    @property
    def circuit(self) -> str:
        """Registered circuit kind this surrogate was trained for."""
        return self.manifest.circuit

    @property
    def device(self) -> torch.device:
        """The device every parameter array of this surrogate lies on."""
        return next(iter(next(iter(self.params.values())).values())).device

    def to(self, device) -> "Surrogate":
        """This surrogate on ``device`` (itself when already there)."""
        device = torch.device(device)
        if self.device == device:
            return self
        params = {p: {k: a.to(device) for k, a in d.items()}
                  for p, d in self.params.items()}
        return Surrogate(self.manifest, params, self.fit_info)

    # -- inference ----------------------------------------------------------
    def predict(self, pname: str, feats):
        """Prediction of head ``pname`` in physical units (energies in
        joules) on raw ``(x, v, tau, params[, o_prev, o_new])`` rows."""
        ops.record_dispatch("predict")
        feats = _augment(self.manifest.circuit, torch.as_tensor(
            feats, dtype=torch.float32, device=self.device))
        return ops.div(self._head(pname, feats),
                       self.manifest.scale_of(pname))

    def _head(self, pname: str, x, fused_kernel=None):
        """Head ``pname`` alone on augmented rows ``x``, in training
        units; a GBDT walks on its tables converted at its first walk."""
        fam = self.manifest.family_of(pname)
        if fam == "gbdt":
            return _predict_gbdt(self.params[pname], x, fused_kernel,
                                 self._forests.setdefault(pname, {}))
        return FAMILY_PREDICT[fam](self.params[pname], x)

    def _stacked(self, pnames: tuple) -> dict:
        """The (P, ...) stacks of same-shape heads ``pnames``, built once."""
        s = self._stacks.get(pnames)
        if s is None:
            heads = [self.params[p] for p in pnames]
            s = {k: torch.stack([h[k] for h in heads]) for k in heads[0]}
            self._stacks[pnames] = s
        return s

    def predict_heads(self, feats_idle=None, feats_act=None, feats_tr=None,
                      *, heads=None, augmented: bool = False,
                      fused_kernel=None) -> dict:
        """Fused multi-head inference: one feature build and one batched
        pass per (variant, family) group instead of one :meth:`predict`
        per head.

        feats_idle / feats_act  ``(N, F)`` idle catch-up / active rows
        feats_tr    ``(N, F+2)`` transition rows (``o_prev``/``o_new``)
        heads       variant -> predictor tuple; defaults to
                    :data:`ALG1_HEADS` restricted to this surrogate
        augmented   the matrices already carry the derived features

        Same-family heads whose arrays share shapes stack and evaluate in
        one pass (``gbdt`` walks per head); a stacked ``table`` head whose
        query sits within rounding distance of two table rows may resolve
        to the other, equally near row. Returns ``{variant: {pname: (N,)
        predictions}}`` in physical units."""
        ops.record_dispatch("predict_heads")
        mats = {"idle": feats_idle, "act": feats_act, "tr": feats_tr}
        mats = {v: torch.as_tensor(m, dtype=torch.float32, device=self.device)
                for v, m in mats.items() if m is not None}
        if not mats:
            raise ValueError("predict_heads needs at least one of "
                             "feats_idle / feats_act / feats_tr")
        avail = set(self.manifest.predictors)
        if heads is None:
            heads = {v: tuple(p for p in ALG1_HEADS[v] if p in avail)
                     for v in mats}
        unknown = [(v, p) for v, ps in heads.items() for p in ps
                   if p not in avail]
        if unknown:
            raise ValueError(f"predict_heads: unknown predictor(s) "
                             f"{unknown}; this surrogate carries "
                             f"{sorted(avail)}")
        missing = [v for v in heads if v not in mats]
        if missing:
            raise ValueError(f"predict_heads: heads requested for variant"
                             f"(s) {missing} but no matching feature "
                             "matrix was given")
        if not augmented:
            mats = {v: _augment(self.manifest.circuit, m)
                    for v, m in mats.items()}

        groups: dict = {}
        for v, pnames in heads.items():
            for p in pnames:
                fam = self.manifest.family_of(p)
                if fam in FAMILY_PREDICT_STACKED:
                    sig = tuple(sorted((k, tuple(a.shape))
                                       for k, a in self.params[p].items()))
                    key = (v, fam, sig)
                else:
                    key = (v, fam, p)
                groups.setdefault(key, []).append(p)

        out: dict = {v: {} for v in heads}
        for (v, fam, _), pnames in groups.items():
            x = mats[v]
            if len(pnames) == 1 or fam not in FAMILY_PREDICT_STACKED:
                for p in pnames:
                    out[v][p] = ops.div(self._head(p, x, fused_kernel),
                                        self.manifest.scale_of(p))
                continue
            s = self._stacked(tuple(pnames))
            if fam == "mlp":
                ys = _predict_mlp_stacked(s, x, fused_kernel=fused_kernel)
            else:
                ys = FAMILY_PREDICT_STACKED[fam](s, x)
            for i, p in enumerate(pnames):
                out[v][p] = ops.div(ys[i], self.manifest.scale_of(p))
        return out

    def predict_np(self, pname: str, feats) -> np.ndarray:
        """Host-side convenience wrapper around :meth:`predict`."""
        return self.predict(pname, np.asarray(feats, np.float32)).cpu().numpy()

    def __repr__(self):
        fams = ", ".join(f"{p}:{f}" for p, f in self.manifest.families)
        return f"Surrogate({self.manifest.circuit!r}, {fams})"

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        """Write one versioned ``.npz``: arrays + JSON ``__manifest__`` (the
        reference's layout; ``path`` may omit the extension)."""
        path = _npz_path(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        arrays = {f"{p}/{k}": v.cpu().numpy()
                  for p, d in self.params.items() for k, v in d.items()}
        manifest = {
            "format_version": self.manifest.format_version,
            "circuit": self.manifest.circuit,
            "families": dict(self.manifest.families),
            "scales": dict(self.manifest.scales),
            "features": list(self.manifest.features),
            "fit_info": self.fit_info,
        }
        arrays["__manifest__"] = np.frombuffer(
            json.dumps(manifest).encode(), dtype=np.uint8)
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str, device=None) -> "Surrogate":
        """Load an artifact written by :meth:`save` (either package's) onto
        ``device`` (default ``cuda``; see ``ops.resolve_device``).

        Raises ``FileNotFoundError`` naming every path tried, and
        ``ValueError`` on a foreign file or another format version."""
        device = ops.resolve_device(device)
        if not os.path.isfile(path):
            alt = _npz_path(path)
            if alt == path or not os.path.isfile(alt):
                tried = sorted({path, alt})
                raise FileNotFoundError(
                    "no surrogate artifact at "
                    + " or ".join(repr(p) for p in tried)
                    + " (expected an .npz written by Surrogate.save)")
            path = alt
        with np.load(path) as z:
            if "__manifest__" not in z.files:
                raise ValueError(f"{path}: not a Surrogate artifact "
                                 "(missing __manifest__)")
            meta = json.loads(bytes(z["__manifest__"].tobytes()).decode())
            arrays = {}
            for pname in meta.get("families", {}):
                arrays[pname] = {k.split("/", 1)[1]: z[k] for k in z.files
                                 if k.startswith(pname + "/")}
        return from_manifest(meta, arrays, device, source=path)


def from_manifest(meta: dict, arrays: dict, device, *, source="artifact"):
    """Build a :class:`Surrogate` from a manifest dict (the ``.npz`` JSON
    schema) and ``{pname: {key: ndarray}}`` arrays, on ``device``."""
    version = meta.get("format_version")
    if version != FORMAT_VERSION:
        raise ValueError(
            f"{source}: surrogate format version {version!r} is not "
            f"supported (this build reads version {FORMAT_VERSION}); "
            "regenerate the artifact with Surrogate.save")
    params = {p: {k: torch.as_tensor(np.array(a), device=device)
                  for k, a in arrays[p].items()}
              for p in meta["families"]}
    manifest = Manifest(
        circuit=meta["circuit"], format_version=version,
        families=tuple(sorted(meta["families"].items())),
        scales=tuple(sorted(meta["scales"].items())),
        features=tuple(meta.get("features", ())))
    return Surrogate(manifest=manifest, params=params,
                     fit_info=meta.get("fit_info"))


def structure_key(surrogates) -> tuple:
    """Hashable structure key of a surrogate (or library): manifests plus
    every array's shape and dtype. Equal keys are weight swaps of one
    another and share one engine runner."""
    if isinstance(surrogates, SurrogateLibrary):
        return tuple((k, structure_key(s)) for k, s in surrogates.items())
    return (surrogates.manifest,
            tuple((p, k, tuple(a.shape), str(a.dtype))
                  for p, d in sorted(surrogates.params.items())
                  for k, a in sorted(d.items())))


def as_surrogate(obj) -> Surrogate:
    """Pass a :class:`Surrogate` through, or freeze a fitted
    ``PredictorBank``; anything else is refused."""
    if isinstance(obj, Surrogate):
        return obj
    from repro_torch.core.predictors import PredictorBank
    if isinstance(obj, PredictorBank):
        return Surrogate.from_bank(obj)
    raise ValueError(
        f"cannot use {type(obj).__name__!r} as a surrogate; pass a "
        "repro_torch Surrogate (or a fitted PredictorBank)")


class SurrogateLibrary:
    """Circuit kind -> :class:`Surrogate` mapping."""

    def __init__(self, surrogates=()):
        self._by_kind = dict(surrogates)
        for kind, s in self._by_kind.items():
            if isinstance(s, Surrogate) and s.circuit != kind:
                raise ValueError(
                    f"surrogate trained for circuit {s.circuit!r} registered "
                    f"under kind {kind!r}")

    def __getitem__(self, kind: str) -> Surrogate:
        return self._by_kind[kind]

    def get(self, kind: str, default=None):
        """Surrogate registered for ``kind``, or ``default``."""
        return self._by_kind.get(kind, default)

    def __contains__(self, kind: str) -> bool:
        return kind in self._by_kind

    def __len__(self) -> int:
        return len(self._by_kind)

    def kinds(self) -> tuple:
        """Registered circuit kinds, sorted."""
        return tuple(sorted(self._by_kind))

    def items(self):
        """(kind, surrogate) pairs, sorted by kind."""
        return tuple((k, self._by_kind[k]) for k in sorted(self._by_kind))

    def to(self, device) -> "SurrogateLibrary":
        """This library with every surrogate on ``device``."""
        return SurrogateLibrary({k: s.to(device) for k, s in self.items()})

    def __repr__(self):
        return f"SurrogateLibrary({', '.join(self.kinds()) or 'empty'})"

    def save(self, directory: str) -> None:
        """Write one ``{kind}.npz`` per surrogate into ``directory``."""
        os.makedirs(directory, exist_ok=True)
        for kind, s in self._by_kind.items():
            s.save(os.path.join(directory, f"{kind}.npz"))

    @classmethod
    def load(cls, directory: str, device=None) -> "SurrogateLibrary":
        """Load every ``*.npz`` in ``directory`` saved by :meth:`save`."""
        lib = {}
        for name in sorted(os.listdir(directory)):
            if name.endswith(".npz"):
                lib[name[:-4]] = Surrogate.load(
                    os.path.join(directory, name), device=device)
        return cls(lib)
