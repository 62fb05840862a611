"""Deprecated predictor-bank persistence shims (port of
``repro.core.persist``).

The deployable artifact is :class:`repro_torch.core.surrogate.Surrogate`
(one versioned ``.npz`` of arrays + a JSON manifest), created by
``repro_torch.lasana.train`` and persisted with ``Surrogate.save`` /
``Surrogate.load``.

:func:`save_bank` / :func:`load_bank` remain as thin shims: saving freezes
the bank into a surrogate first, and loading returns a :class:`Surrogate`
(drop-in at inference time: the same ``predict`` / ``predict_np``
surface the bank had). ``load_bank`` also reads artifacts written by the
PRE-facade ``save_bank`` of the reference (manifest with a ``predictors``
key and no ``format_version``), migrating them to a :class:`Surrogate` in
memory — re-``save`` to upgrade the file on disk.
"""

from __future__ import annotations

import json
import warnings

import numpy as np

from repro_torch.core.surrogate import (FORMAT_VERSION, Surrogate,
                                        _feature_names, as_surrogate,
                                        from_manifest)
from repro_torch.kernels import ops


def save_bank(bank, path: str) -> None:
    """Deprecated: freeze ``bank`` into a Surrogate and save that."""
    warnings.warn("persist.save_bank is deprecated; use "
                  "Surrogate.from_bank(bank).save(path) (repro_torch.lasana)",
                  DeprecationWarning, stacklevel=2)
    as_surrogate(bank).save(path)


def _load_legacy(z, meta: dict, device) -> Surrogate:
    """Migrate a pre-facade ``save_bank`` npz into a :class:`Surrogate` on
    ``device``.

    The old manifest stored per-predictor family metadata under
    ``predictors`` and no unit scales (the old loader rebuilt them from
    ``PREDICTOR_DEFS``, as here); scalar model state (mean ``mu``, gbdt
    ``base``) lived in the manifest instead of the arrays. ``z`` is the
    already-open npz file."""
    from repro_torch.core.predictors import PREDICTOR_DEFS

    families, scales, arrays = {}, {}, {}
    for pname, m in sorted(meta["predictors"].items()):
        a = {k.split("/", 1)[1]: z[k] for k in z.files
             if k.startswith(pname + "/")}
        if m["family"] == "mean":
            a = {"mu": np.float32(m["mu"])}
        elif m["family"] == "gbdt":
            a["base"] = np.float32(m["base"])
            a.pop("edges", None)                   # training-only state
        families[pname] = m["family"]
        scales[pname] = float(PREDICTOR_DEFS[pname]["scale"])
        arrays[pname] = a
    manifest = {"format_version": FORMAT_VERSION, "circuit": meta["circuit"],
                "families": families, "scales": scales,
                "features": list(_feature_names(meta["circuit"]))}
    return from_manifest(manifest, arrays, device, source="legacy bank")


def load_bank(path: str, device=None) -> Surrogate:
    """Deprecated: load the artifact at ``path`` as a :class:`Surrogate` on
    ``device`` (default ``cuda``, as ``lasana.load``).

    Reads both current-format surrogates and legacy ``save_bank`` files."""
    warnings.warn("persist.load_bank is deprecated; use "
                  "Surrogate.load(path) (repro_torch.lasana)",
                  DeprecationWarning, stacklevel=2)
    device = ops.resolve_device(device)
    with np.load(path) as z:
        meta = (json.loads(bytes(z["__manifest__"].tobytes()).decode())
                if "__manifest__" in z.files else {})
        if "predictors" in meta and "format_version" not in meta:
            return _load_legacy(z, meta, device)
    return Surrogate.load(path, device=device)
