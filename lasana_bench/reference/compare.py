"""The comparison that decides ``correct``: the program's records against
the plain reference's, as named gaps, each held to a limit.

Every gap is 0 for identical records and grows with the disagreement.
The limits live in each cell's traffic file (``limits``); PERF.md gives
the readings each was set from.
"""

from __future__ import annotations

import numpy as np


def rel_gap(got, want, floor: float = 0.0) -> float:
    """Largest ``|got - want| / max(|want|, floor)`` over all entries."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    den = np.maximum(np.abs(want), floor)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(den > 0, np.abs(got - want) / np.where(den > 0, den, 1),
                     np.where(got == want, 0.0, np.inf))
    return float(r.max()) if r.size else 0.0


def mismatch(got, want) -> float:
    """Share of entries that differ (spikes as fired / not fired)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return 1.0
    return float(np.mean(got != want)) if got.size else 0.0


def tick_records(prog: dict, ref: dict) -> dict:
    """Gaps of the per-tick (T, L) records and the flush: energy and
    latency relative to the reference entry, events relative to
    ``max(reference, 1)``."""
    out = {
        "energy": rel_gap(prog["energy"], ref["energy"], 1e-30),
        "latency": rel_gap(prog["latency"], ref["latency"], 1e-6),
        "events": rel_gap(prog["events"], ref["events"], 1.0),
    }
    if "flush" in prog:
        out["flush"] = rel_gap(prog["flush"], ref["flush"], 1e-30)
    return out


def snn_gaps(prog: dict, ref: dict) -> dict:
    """The SNN's gaps: the share of spikes (fired / not fired, every tick)
    that differ over every recorded layer and over the output layer
    alone, where the program's spikes were kept; the output spike counts
    (largest difference per digit and class); and the per-tick records."""
    out = {}
    if "spikes" in prog:
        got, want = prog["spikes"], ref["spikes"]
        if len(got) != len(want):
            out["spikes"] = out["out_spikes"] = 1.0
        else:
            n = sum(w.size for w in want) or 1
            out["spikes"] = sum(mismatch(g, w) * w.size
                                for g, w in zip(got, want)) / n
            out["out_spikes"] = mismatch(got[-1], want[-1])
    counts = np.abs(np.asarray(prog["counts"], np.int64)
                    - np.asarray(ref["counts"], np.int64))
    out["counts"] = float(counts.max()) if counts.size else 0.0
    out.update(tick_records(prog, ref))
    return out


def worst(per_call) -> dict:
    """Each gap's largest value over several calls' gaps."""
    out = {}
    for g in per_call:
        for k, v in g.items():
            out[k] = max(out.get(k, v), v) if v == v else float("nan")
    return out


def xbar_gaps(prog: dict, ref: dict, step: float) -> dict:
    """The crossbar's gaps: the share of every layer's outputs that differ
    by half an ADC step or more, and the per-tick records. ``step`` is
    one ADC step in the outputs' gain-compensated units."""
    off, n = 0, 0
    for g, w in zip(prog["layers"], ref["layers"]):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if g.shape != w.shape:
            off, n = 1, 1
            break
        off += int(np.sum(np.abs(g - w) >= 0.5 * step))
        n += w.size
    return {"codes": off / max(n, 1), **tick_records(prog, ref)}


def judge(gaps: dict, limits: dict, partial: bool = False) -> tuple:
    """``(correct, checks)``: every limited gap at or under its limit (a
    NaN or a missing gap fails, unless ``partial``, where a missing gap is
    not judged); ``checks`` maps each name to its value and limit, in the
    limits' order."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        if partial and name not in gaps:
            continue
        v = gaps.get(name, float("nan"))
        checks[name] = {"value": v, "limit": limit}
        if not (v <= limit):
            ok = False
    return ok, checks
