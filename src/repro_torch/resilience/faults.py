"""Deterministic fault injection: seeded site -> trigger schedules (port of
``repro.resilience.faults``; pure host code).

Every recoverable failure mode the stack defends against has a *named
injection site* — a host-side hook at the exact layer where the real
fault would surface. A :class:`FaultPlan` maps sites to trigger
schedules (explicit invocation indices and/or a seeded Bernoulli rate),
so a failure observed once is replayable exactly: same seed + same
invocation order -> same fires.

Sites (see docs/resilience.md for the code locations):

==================  ==========================================================
``artifact.load``   surrogate artifact bytes corrupt on load
                    (the server's artifact store)
``lane.step``       a serve lane's step raises mid-chunk
                    (``serve.scheduler.Lane.step``)
``surrogate.nan``   NaN/Inf burst in one request's surrogate head outputs
                    (host copy of the fetched lane-step records)
``chunk.stall``     a chunk dispatch stalls for ``stall_seconds``
                    (streaming ``_stream_gen`` and ``Lane.step``)
``callback.explode``  a consumer ``on_chunk`` callback raises
                    (``serve.scheduler.RequestHandle._push``)
==================  ==========================================================

All hooks live on the HOST side of the dispatch boundary: compiled
programs are never touched, so injection can never change program cache
keys or recompile anything.

The ambient plan comes from ``REPRO_FAULT_PLAN`` (a JSON file path,
resolved through :func:`repro_torch.kernels.ops.fault_plan_path` — ops
stays the only env reader). Tests override it in-process with
:func:`use_plan`. With no plan active every hook is a cheap no-op.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
import zlib
from typing import Optional

import numpy as np

FAULT_SITES = (
    "artifact.load",
    "lane.step",
    "surrogate.nan",
    "chunk.stall",
    "callback.explode",
)

PLAN_FORMAT_VERSION = 1


class FaultInjected(RuntimeError):
    """Raised by a firing injection site (site name + fire ordinal)."""

    def __init__(self, site: str, ordinal: int):
        super().__init__(f"injected fault at site {site!r} "
                         f"(fire #{ordinal})")
        self.site = site
        self.ordinal = ordinal


@dataclasses.dataclass(frozen=True)
class SiteSchedule:
    """When one site fires: explicit invocation indices and/or a rate.

    ``at``        0-based invocation indices that always fire.
    ``rate``      additionally fire each invocation with this probability
                  (seeded per-site stream; deterministic given order).
    ``max_fires`` stop firing after this many fires (None = unbounded) —
                  bounds ambient disruption when a plan rides along an
                  entire test suite.
    """

    at: tuple = ()
    rate: float = 0.0
    max_fires: Optional[int] = None

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1]: {self.rate}")
        if any(int(i) < 0 for i in self.at):
            raise ValueError(f"'at' indices must be >= 0: {self.at}")


class FaultPlan:
    """A seeded, replayable schedule of injected faults.

    ``sites`` maps site names (from :data:`FAULT_SITES`) to
    :class:`SiteSchedule`s (or plain dicts with the same keys). Each
    site owns an independent ``numpy`` Generator derived from
    ``(seed, crc32(site))``, consuming exactly one draw per invocation —
    firing is a pure function of the seed and the per-site invocation
    ordinal, never of wall clock or cross-site interleaving.

    Thread-safe: serve loops, stream generators, and client threads
    hit sites concurrently; counters advance under one lock.
    """

    def __init__(self, seed: int = 0, sites=None, *,
                 stall_seconds: float = 0.02):
        self.seed = int(seed)
        self.stall_seconds = float(stall_seconds)
        self.sites = {}
        for name, sched in dict(sites or {}).items():
            if name not in FAULT_SITES:
                raise ValueError(f"unknown fault site {name!r}; known "
                                 f"sites: {FAULT_SITES}")
            if isinstance(sched, dict):
                sched = SiteSchedule(
                    at=tuple(int(i) for i in sched.get("at", ())),
                    rate=float(sched.get("rate", 0.0)),
                    max_fires=sched.get("max_fires"))
            self.sites[name] = sched
        self._lock = threading.Lock()
        self._rngs = {name: np.random.default_rng(
            [self.seed, zlib.crc32(name.encode())])
            for name in self.sites}
        self.calls = {name: 0 for name in FAULT_SITES}
        self.fired = {name: 0 for name in FAULT_SITES}

    def should_fire(self, site: str) -> bool:
        """Consume one invocation at ``site``; True if the fault fires."""
        if site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {site!r}")
        sched = self.sites.get(site)
        with self._lock:
            n = self.calls[site]
            self.calls[site] += 1
            if sched is None:
                return False
            # the rate draw is consumed unconditionally so explicit 'at'
            # hits never shift the stream — schedules stay independent
            u = self._rngs[site].random() if sched.rate > 0.0 else 1.0
            fire = n in sched.at or u < sched.rate
            if fire and sched.max_fires is not None \
                    and self.fired[site] >= sched.max_fires:
                fire = False
            if fire:
                self.fired[site] += 1
            return fire

    def draw(self, site: str) -> float:
        """One extra uniform from ``site``'s stream (victim selection)."""
        with self._lock:
            rng = self._rngs.get(site)
            if rng is None:
                rng = self._rngs[site] = np.random.default_rng(
                    [self.seed, zlib.crc32(site.encode())])
            return float(rng.random())

    # --- (de)serialization ----------------------------------------------------

    def to_json(self) -> dict:
        sites = {}
        for name, s in self.sites.items():
            d = {}
            if s.at:
                d["at"] = list(s.at)
            if s.rate:
                d["rate"] = s.rate
            if s.max_fires is not None:
                d["max_fires"] = s.max_fires
            sites[name] = d
        return {"format_version": PLAN_FORMAT_VERSION, "seed": self.seed,
                "stall_seconds": self.stall_seconds, "sites": sites}

    @classmethod
    def from_json(cls, obj: dict) -> "FaultPlan":
        version = obj.get("format_version", PLAN_FORMAT_VERSION)
        if version > PLAN_FORMAT_VERSION:
            raise ValueError(f"fault plan format v{version} is newer than "
                             f"supported v{PLAN_FORMAT_VERSION}")
        return cls(seed=obj.get("seed", 0), sites=obj.get("sites"),
                   stall_seconds=obj.get("stall_seconds", 0.02))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(json.load(f))


# --- the active plan ----------------------------------------------------------
#
# Resolution order: an in-process override (use_plan — tests, benchmarks)
# shadows the ambient env plan (REPRO_FAULT_PLAN via ops.fault_plan_path).
# The env plan is loaded once per path and kept as a live singleton so
# fire counters accumulate across an entire suite run.

_STATE_LOCK = threading.Lock()
_OVERRIDE: Optional[FaultPlan] = None
_OVERRIDE_ACTIVE = False
_ENV_PLAN: Optional[FaultPlan] = None
_ENV_PATH: Optional[str] = None


def active_plan() -> Optional[FaultPlan]:
    """The plan injection sites consult right now (or None)."""
    global _ENV_PLAN, _ENV_PATH
    with _STATE_LOCK:
        if _OVERRIDE_ACTIVE:
            return _OVERRIDE
        from repro_torch.kernels import ops
        path = ops.fault_plan_path()
        if path != _ENV_PATH:
            _ENV_PLAN = FaultPlan.load(path) if path else None
            _ENV_PATH = path
        return _ENV_PLAN


@contextlib.contextmanager
def use_plan(plan: Optional[FaultPlan]):
    """Scope an in-process plan override (``None`` disables injection
    entirely inside the scope, shadowing any ambient env plan)."""
    global _OVERRIDE, _OVERRIDE_ACTIVE
    with _STATE_LOCK:
        prev, prev_active = _OVERRIDE, _OVERRIDE_ACTIVE
        _OVERRIDE, _OVERRIDE_ACTIVE = plan, True
    try:
        yield plan
    finally:
        with _STATE_LOCK:
            _OVERRIDE, _OVERRIDE_ACTIVE = prev, prev_active


# --- site hooks (what instrumented code calls) --------------------------------


def should_fire(site: str) -> bool:
    """Does ``site`` fire on this invocation? No-op False with no plan."""
    plan = active_plan()
    return plan is not None and plan.should_fire(site)


def check(site: str) -> None:
    """Raise :class:`FaultInjected` when ``site`` fires (exception sites:
    ``lane.step``, ``callback.explode``, ``artifact.load``)."""
    plan = active_plan()
    if plan is not None and plan.should_fire(site):
        raise FaultInjected(site, plan.fired[site])


def stall(site: str = "chunk.stall") -> float:
    """Sleep ``stall_seconds`` when ``site`` fires; returns the stall."""
    plan = active_plan()
    if plan is not None and plan.should_fire(site):
        time.sleep(plan.stall_seconds)
        return plan.stall_seconds
    return 0.0


def draw(site: str) -> float:
    """Deterministic uniform from the active plan's ``site`` stream."""
    plan = active_plan()
    return plan.draw(site) if plan is not None else 0.0
