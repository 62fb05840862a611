"""Port parity: the simulation server (``repro_torch.serve.SimServer``,
``ArtifactStore``, ``lasana.serve``) against the reference's
(``repro.serve``).

tests/test_serve.py's and tests/test_resilience.py's server cases run
through both packages' servers on the same requests — the committed
``lif_packable`` artifact on both sides, tests/test_serve.py's 12-8-4
SNN from numpy — and every request ends the same way on both: a result
equal to its solo ``simulate`` in the port and to the reference's served
record (``assert_request_parity``), or an error of the same type. The
``stats()`` reports have the same keys and equal counters. Everything
counted runs unthreaded through ``run_until_idle``; a threaded test
waits on handles with a timeout and closes its server in ``finally``.
The port's thread lint (``repro_torch.analysis.thread_lint``, the
reference's lint with torch's host syncs among its blocking calls) runs
over the port's server, scheduler and store with its own tables.
"""

import copy
import gc
import math
import pathlib
import time
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_fixtures as fx  # noqa: E402
from test_torch_fixtures import (assert_request_parity,  # noqa: E402,F401
                                 surrogate_pairs)

CHUNK = fx.SERVE_CHUNK
CI_PLAN = fx.ROOT / "tests" / "data" / "fault_plan_ci.json"
TIMEOUT = 120.0
# stats() entries that are not timings: equal between the packages under
# the same unthreaded schedule
COUNTERS = ("requests_submitted", "requests_completed", "requests_rejected",
            "requests_failed", "requests_retried",
            "requests_deadline_exceeded", "requests_degraded",
            "requests_in_flight", "numerical_faults", "lane_hangs",
            "lanes_retired", "chunks_total", "ticks_live_total",
            "events_total", "batch_occupancy", "wait_chunks_max",
            "queue_depth_by_bucket", "degraded_specs", "compile_count",
            "n_lanes", "surrogates")
LANE_FIELDS = ("bucket", "occupancy", "active_requests", "global_tick",
               "degraded")


class Side:
    """One package's serving surface on one spec and surrogate."""

    def __init__(self, name, desc, sur):
        self.name = name
        if name == "jax":
            import repro.lasana as lasana
            import repro.serve as serve
            from repro.resilience import FaultPlan, faults
            self.spec_of, self.dev = fx.jax_graph_spec, {}
        else:
            import repro_torch.lasana as lasana
            import repro_torch.serve as serve
            from repro_torch.resilience import FaultPlan, faults
            self.spec_of, self.dev = fx.port_graph_spec, {"device": "cpu"}
        self.lasana, self.serve = lasana, serve
        self.FaultPlan, self.faults = FaultPlan, faults
        self.spec = self.spec_of(desc)
        # solo runs on a content-equal spec of their own: the served
        # spec's engines (and their build counts) see the server alone
        self.solo_spec = self.spec_of(desc)
        self.sur = sur

    def server(self, **cfg):
        return self.serve.SimServer(self.serve.ServeConfig(
            slot_widths=cfg.pop("slot_widths", (4,)),
            chunk_ticks=cfg.pop("chunk_ticks", CHUNK), **cfg, **self.dev))

    def started(self, **cfg):
        return self.lasana.serve(slot_widths=(4,), chunk_ticks=CHUNK,
                                 **cfg, **self.dev)

    def solo(self, x, spec=None, surrogates="default", **kw):
        sur = self.sur if surrogates == "default" else surrogates
        if sur is not None:
            kw["surrogates"] = sur
        return self.lasana.simulate(spec or self.solo_spec, x,
                                    record_hidden=kw.pop("record_hidden",
                                                         False),
                                    **kw, **self.dev)

    def load(self, path):
        return self.lasana.load(str(path), **self.dev)


@pytest.fixture(scope="module")
def sides(surrogate_pairs):
    """(reference side, port side) on the shared 12-8-4 SNN: one spec per
    package for the whole module, so each engine is built once."""
    jsur, tsur = surrogate_pairs["packable"]
    desc = fx.small_net_desc()
    return Side("jax", desc, jsur), Side("port", desc, tsur)


@pytest.fixture(autouse=True)
def _no_ambient_faults():
    """Each test opts into its own plan, on both packages' sites."""
    from repro.resilience import faults as jax_faults
    from repro_torch.resilience import faults
    with jax_faults.use_plan(None), faults.use_plan(None):
        yield


def _stims(jobs, seed):
    return fx.serve_stimuli(jobs, seed=seed)


def _outcome(h, timeout=TIMEOUT):
    """("ok", record) or (error type name, message) of a finished handle."""
    try:
        return "ok", h.result(timeout=timeout)
    except Exception as err:             # noqa: BLE001 - compared by type
        return type(err).__name__, str(err)


def assert_same_outcomes(jhandles, thandles, solos=None, hidden=False):
    """Handle by handle: the same outcome on both sides; a port record
    equal to its solo run (``solos``, port records) and to the
    reference's served record."""
    for i, (jh, th) in enumerate(zip(jhandles, thandles)):
        (jk, jv), (tk, tv) = _outcome(jh), _outcome(th)
        assert tk == jk, (i, jv, tv)
        if tk != "ok":
            continue
        if solos is not None:
            assert_request_parity(solos[i], tv, hidden=hidden)
        assert_request_parity(jv, tv, hidden=hidden)


def assert_same_stats(js, ts, timed=()):
    """The same report keys, equal counters and equal lane rows. ``timed``
    names counters that depend on the wall clock in this test (the rounds
    a request waits out a retry backoff, and the lanes that retire
    meanwhile; with ``n_lanes`` the lane rows are skipped too)."""
    assert set(ts) == set(js)
    for k in COUNTERS:
        if k not in timed:
            assert ts[k] == js[k], k
    if "n_lanes" not in timed:
        assert [{f: l[f] for f in LANE_FIELDS} for l in ts["lanes"]] == \
            [{f: l[f] for f in LANE_FIELDS} for l in js["lanes"]]


def both(sides, fn):
    """``fn(side)`` on the reference's side, then the port's."""
    return [fn(s) for s in sides]


# --- parity (tests/test_serve.py) ---------------------------------------------

def test_single_request_matches_simulate(sides):
    """One request IS a solo simulate, hidden spike traces included, and
    streams ceil(T / chunk) partial records."""
    x = _stims([(20, 2)], seed=0)[0]

    def run(side):
        srv = side.server(record_hidden=True)
        seen = []
        h = srv.submit(side.spec, x, surrogates=side.sur,
                       on_chunk=seen.append)
        assert not h.done
        srv.run_until_idle()
        assert h.done and len(h.chunks()) == math.ceil(20 / CHUNK) \
            == len(seen)
        return srv.stats(), h

    (jst, jh), (tst, th) = both(sides, run)
    assert_same_stats(jst, tst)
    solo = sides[1].solo(x, record_hidden=True)
    assert_same_outcomes([jh], [th], [solo], hidden=True)


def test_multiplexed_join_leave_parity(sides):
    """7 concurrent requests of heterogeneous length and batch on 4 slots,
    three tenants: later requests join mid-stream as earlier ones leave."""
    stims = _stims(fx.SERVE_JOBS, seed=1)

    def run(side):
        srv = side.server()
        hs = [srv.submit(side.spec, x, surrogates=side.sur,
                         tenant=f"t{i % 3}") for i, x in enumerate(stims)]
        srv.run_until_idle()
        for (t, _), h in zip(fx.SERVE_JOBS, hs):
            assert len(h.chunks()) == math.ceil(t / CHUNK)
        return srv, hs, srv.stats()

    (js, jh, jst), (ts, th, tst) = both(sides, run)
    assert tst["requests_completed"] == len(stims)
    assert tst["batch_occupancy"] > 0.3
    assert_same_stats(jst, tst)
    assert_same_outcomes(jh, th, [sides[1].solo(x) for x in stims])


def test_versions_share_compiled_programs(sides):
    """Two registered versions (one registered mid-workload) serve from two
    lanes through ONE slot step; each request equals a solo run with the
    version it resolved, and the swap changed the weights in flight."""
    desc = fx.small_net_desc(seed=7)             # a fresh spec: clean engine
    stims = _stims([(16, 1)] * 4, seed=2)

    def run(side):
        s1 = side.sur
        s2 = fx.scaled_surrogate(s1, 1.05, jax_side=side.name == "jax")
        spec = side.spec_of(desc)
        srv = side.server()
        assert srv.register_surrogate("lif", s1) == 1
        h_pin = srv.submit(spec, stims[0], surrogates="lif@1")
        h_old = srv.submit(spec, stims[1], surrogates="lif")
        srv.run_until_idle()
        assert srv.register_surrogate("lif", s2) == 2
        h_new = srv.submit(spec, stims[2], surrogates="lif")
        h_pin2 = srv.submit(spec, stims[3], surrogates="lif@1")
        srv.run_until_idle()
        assert srv.compile_count() == 1
        assert srv.stats()["n_lanes"] == 2
        assert h_pin.surrogate_ref == h_old.surrogate_ref == ("lif", 1)
        assert h_new.surrogate_ref == ("lif", 2)
        assert h_pin2.surrogate_ref == ("lif", 1)
        solos = [side.solo(x, spec, s) for x, s in
                 zip(stims, (s1, s1, s2, s1))]
        return srv.stats(), [h_pin, h_old, h_new, h_pin2], solos

    (jst, jh, _), (tst, th, tsolo) = both(sides, run)
    assert_same_stats(jst, tst)
    assert_same_outcomes(jh, th, tsolo)
    assert th[1].result().energy.sum() != th[2].result().energy.sum()


def test_mixed_recurrent_graph_parity(sides):
    """The crossbar front end -> LIF readout with recurrent inhibition,
    with a {crossbar, lif} library."""
    desc, seqs = fx.mixed_serve_net()

    def run(side):
        x = side.load(fx.XBAR_PACKABLE)
        lib = {"crossbar": x, "lif": side.sur}
        spec = side.spec_of(desc)
        srv = side.server()
        hs = [srv.submit(spec, s, surrogates=lib) for s in seqs]
        srv.run_until_idle()
        return srv, hs, [side.solo(s, spec, lib) for s in seqs]

    (js, jh, _), (ts, th, tsolo) = both(sides, run)
    assert_same_outcomes(jh, th, tsolo)
    assert_same_stats(js.stats(), ts.stats())


def test_annotation_mode_parity(sides):
    x = _stims([(13, 2)], seed=4)[0]

    def run(side):
        srv = side.server()
        h = srv.submit(side.spec, x, surrogates=side.sur, mode="annotation")
        srv.run_until_idle()
        return srv.stats(), h

    (jst, jh), (tst, th) = both(sides, run)
    assert_same_stats(jst, tst)
    assert_same_outcomes([jh], [th], [sides[1].solo(x, mode="annotation")])


# --- admission control ------------------------------------------------------------

def test_round_robin_tenants_no_starvation(sides):
    """A chatty tenant (6 queued requests) cannot starve another: the
    polite tenant's two requests finish ahead of chatty's third."""
    stims = _stims([(CHUNK, 1)] * 8, seed=5)

    def run(side):
        srv = side.server(slot_widths=(2,), max_in_flight=2)
        order = []

        def submit(x, tenant):
            h = srv.submit(side.spec, x, surrogates=side.sur, tenant=tenant)
            h._on_chunk = lambda rec, hid=h.id: order.append(hid)
            return h
        chatty = [submit(x, "chatty") for x in stims[:6]]
        polite = [submit(x, "polite") for x in stims[6:]]
        srv.run_until_idle()
        assert all(h.done for h in chatty + polite)
        for p in polite:
            assert order.index(p.id) < order.index(chatty[2].id)
        assert srv.stats()["wait_chunks_max"] >= 1
        return srv.stats(), order, chatty + polite

    (jst, jorder, jh), (tst, torder, th) = both(sides, run)
    assert torder == jorder
    assert_same_stats(jst, tst)
    assert_same_outcomes(jh, th)


def test_backpressure_and_validation(sides):
    """ServerBusy past max_queue; oversize batches, wrong widths, unknown
    specs and surrogates fail in submit with the reference's errors."""
    stims = _stims([(CHUNK, 1)] * 3 + [(CHUNK, 8)], seed=6)

    def run(side):
        srv = side.server(max_queue=2)
        ok = [srv.submit(side.spec, x, surrogates=side.sur)
              for x in stims[:2]]
        errors = []
        for args, kw in (
                ((side.spec, stims[2]), {}),
                ((side.spec, stims[3]), {}),
                ((side.spec, np.zeros((4, 1, 5), np.float32)), {}),
                (("nope", stims[0]), {}),
                ((side.spec, stims[0]), {"surrogates": "ghost"})):
            kw.setdefault("surrogates", side.sur)
            with pytest.raises(Exception) as err:
                srv.submit(*args, **kw)
            errors.append((type(err.value).__name__, str(err.value)))
        srv.run_until_idle()
        assert all(h.done for h in ok)
        assert srv.stats()["requests_rejected"] == 1
        return srv.stats(), errors, ok

    (jst, jerr, jh), (tst, terr, th) = both(sides, run)
    assert [k for k, _ in terr] == ["ServerBusy", "ValueError", "ValueError",
                                    "KeyError", "KeyError"]
    assert terr == jerr
    assert_same_stats(jst, tst)
    assert_same_outcomes(jh, th)


def test_invalid_mode_rejected_synchronously(sides):
    def run(side):
        srv = side.server()
        with pytest.raises(ValueError, match="mode must be one of") as err:
            srv.submit(side.spec, np.zeros((4, 1, 12), np.float32),
                       surrogates=side.sur, mode="bogus")
        return str(err.value), srv.stats()

    (jmsg, jst), (tmsg, tst) = both(sides, run)
    assert tmsg == jmsg
    assert_same_stats(jst, tst)


def test_bad_request_does_not_kill_server(sides):
    """On a started server, a request whose lane the engine rejects fails
    its own handle; the driver thread keeps serving."""
    x, x_bad = _stims([(12, 1), (12, 1)], seed=11)

    def run(side):
        srv = side.started()
        try:
            good1 = srv.submit(side.spec, x, surrogates=side.sur, tenant="a")
            bad = srv.submit(side.spec, x_bad,
                             surrogates={"not-a-kind": object()},
                             tenant="b")
            good1.result(timeout=TIMEOUT)
            with pytest.raises(Exception) as err:
                bad.result(timeout=TIMEOUT)
            good2 = srv.submit(side.spec, x, surrogates=side.sur,
                               tenant="c")
            served = good2.result(timeout=TIMEOUT)
            st = srv.stats()
        finally:
            srv.close(timeout=30)
        assert st["requests_failed"] == 1 and st["requests_in_flight"] == 0
        return type(err.value).__name__, served, st

    (jerr, jrun, jst), (terr, trun, tst) = both(sides, run)
    assert terr == jerr
    assert_request_parity(sides[1].solo(x), trun)
    assert_request_parity(jrun, trun)
    for k in ("requests_submitted", "requests_completed", "requests_failed",
              "requests_in_flight"):
        assert tst[k] == jst[k], k


def test_on_chunk_error_fails_only_that_request(sides):
    x_bad, x = _stims([(12, 1), (12, 1)], seed=14)

    def boom(rec):
        raise RuntimeError("chunk consumer exploded")

    def run(side):
        srv = side.server()
        h_bad = srv.submit(side.spec, x_bad, surrogates=side.sur,
                           on_chunk=boom)
        h_good = srv.submit(side.spec, x, surrogates=side.sur)
        srv.run_until_idle()
        with pytest.raises(RuntimeError, match="chunk consumer exploded"):
            h_bad.result(timeout=5)
        return srv.stats(), [h_bad, h_good]

    (jst, jh), (tst, th) = both(sides, run)
    assert _outcome(th[0])[0] == _outcome(jh[0])[0] == "RuntimeError"
    assert_same_outcomes(jh[1:], th[1:], [sides[1].solo(x)])
    assert_same_stats(jst, tst)


def test_idle_lane_retirement_and_surrogate_liveness(sides):
    """The lane pins a directly passed surrogate (its id() is in the lane
    key); idle lanes retire after lane_idle_rounds, dropping key and
    reference together, and re-creation builds nothing."""
    x = _stims([(CHUNK, 1)], seed=12)[0]

    def run(side):
        srv = side.server(lane_idle_rounds=3)
        dup = copy.copy(side.sur)
        wr = weakref.ref(dup)
        h = srv.submit(side.spec, x, surrogates=dup)
        del dup
        srv.run_until_idle()
        h.result(timeout=5)
        gc.collect()
        assert wr() is not None
        assert srv.stats()["n_lanes"] == 1
        solo = side.solo(x)
        compiles = srv.compile_count()
        for _ in range(3):
            assert not srv.step()
        gc.collect()
        assert wr() is None
        st = srv.stats()
        assert st["n_lanes"] == 0 and st["lanes_retired"] == 1
        h2 = srv.submit(side.spec, x, surrogates=side.sur)
        srv.run_until_idle()
        assert srv.compile_count() == compiles
        return srv.stats(), [h, h2], solo

    (jst, jh, _), (tst, th, tsolo) = both(sides, run)
    assert_same_outcomes(jh, th, [tsolo, tsolo])
    assert_same_stats(jst, tst)


def test_lifecycle_guards(sides):
    def run(side):
        srv = side.server()
        srv.start()
        try:
            with pytest.raises(RuntimeError, match="driver thread") as e1:
                srv.run_until_idle()
        finally:
            srv.close(timeout=30)
        with pytest.raises(RuntimeError, match="closed") as e2:
            srv.submit(side.spec, np.zeros((1, 1, 12), np.float32),
                       surrogates="lif")
        return str(e1.value), str(e2.value)

    jgot, tgot = both(sides, run)
    assert tgot == jgot


# --- the store and the report -------------------------------------------------------

def test_artifact_store_versioning(sides):
    def run(side):
        from importlib import import_module
        store_mod = import_module(side.serve.__name__ + ".store")
        store, sur = side.serve.ArtifactStore(), side.sur
        got = [store.register("lif", sur), store.register("lif", sur),
               store.register("lif", sur, version=9),
               store.register("lif", sur)]
        got += [store.resolve("lif")[0], store.resolve("lif@2")[0],
                store.names(), store.versions("lif")]
        assert store.get("lif", 2) is store.get("lif", 1)
        errors = []
        for fn in (lambda: store.register("lif", sur, version=2),
                   lambda: store.register("a@b", sur),
                   lambda: store.resolve("lif@3"),
                   lambda: store.resolve("ghost"),
                   lambda: store_mod.parse_ref("a@b"),
                   lambda: store_mod.parse_ref("@3")):
            with pytest.raises(Exception) as err:
                fn()
            errors.append((type(err.value).__name__, str(err.value)))
        got += [store_mod.parse_ref("a@3"), store_mod.parse_ref("a")]
        return got, errors

    (jgot, jerr), (tgot, terr) = both(sides, run)
    assert tgot == jgot
    assert tgot[:4] == [1, 2, 9, 10] and tgot[4] == ("lif", 10)
    assert terr == jerr


def test_stats_report(sides):
    stims = _stims([(CHUNK, 1)] * 3, seed=8)

    def run(side):
        srv = side.server()
        srv.register_surrogate("lif", side.sur)
        hs = [srv.submit(side.spec, x, surrogates="lif") for x in stims]
        queued = srv.stats()
        srv.run_until_idle()
        st = srv.stats()
        assert sum(queued["queue_depth_by_bucket"].values()) == 3
        assert st["requests_submitted"] == st["requests_completed"] == 3
        assert st["surrogates"] == {"lif": [1]}
        assert 0.0 < st["batch_occupancy"] <= 1.0
        assert st["requests_per_sec"] > 0 and st["events_per_sec"] >= 0
        assert isinstance(st["compile_count"], int)
        return queued, st, hs

    (jq, jst, jh), (tq, tst, th) = both(sides, run)
    assert_same_stats(jq, tq)
    assert_same_stats(jst, tst)
    assert [l["surrogate"] for l in tst["lanes"]] == \
        [l["surrogate"] for l in jst["lanes"]]
    assert_same_outcomes(jh, th, [sides[1].solo(x) for x in stims])


# --- deadlines, retries, quarantine, degradation (tests/test_resilience.py) ---

def test_deadline_expired_fails_fast_without_a_slot(sides):
    x = _stims([(8, 1)], seed=0)[0]

    def run(side):
        srv = side.server()
        h = srv.submit(side.spec, x, surrogates=side.sur, deadline_ms=1.0)
        time.sleep(0.02)
        srv.step()
        with pytest.raises(side.serve.DeadlineExceeded):
            h.result(timeout=5)
        assert srv.compile_count() == 0
        return srv.stats()

    jst, tst = both(sides, run)
    assert tst["requests_deadline_exceeded"] == tst["requests_failed"] == 1
    assert tst["requests_in_flight"] == tst["requests_completed"] == 0
    assert_same_stats(jst, tst)


def test_deadline_validation(sides):
    def run(side):
        srv = side.server()
        with pytest.raises(ValueError, match="deadline_ms") as err:
            srv.submit(side.spec, np.zeros((2, 1, 12), np.float32),
                       surrogates=side.sur, deadline_ms=-5)
        return str(err.value)

    jgot, tgot = both(sides, run)
    assert tgot == jgot


@pytest.mark.parametrize("retries,backoff_ms", [(2, 0.0), (2, 5.0), (0, 0.0)])
def test_lane_step_fault_retry_or_fail(sides, retries, backoff_ms):
    """One injected lane-step failure: with retries the request replays on
    a fresh lane (nothing built) and equals its solo run; without, it
    fails with FaultInjected. A retry backoff makes the scheduling rounds
    depend on the wall clock, so those counters compare only without
    one (the other tests retry with no backoff, for the same reason)."""
    x = _stims([(12, 2)], seed=8)[0]

    def run(side):
        plan = side.FaultPlan(0, {"lane.step": {"at": [0]}})
        srv = side.server(max_retries=retries, retry_backoff_ms=backoff_ms)
        with side.faults.use_plan(plan):
            h = srv.submit(side.spec, x, surrogates=side.sur)
            srv.run_until_idle()
        assert plan.fired["lane.step"] == 1
        return srv.stats(), h

    (jst, jh), (tst, th) = both(sides, run)
    assert_same_outcomes([jh], [th], [sides[1].solo(x)])
    assert_same_stats(jst, tst, timed=("wait_chunks_max", "lanes_retired",
                                       "n_lanes", "compile_count")
                      if backoff_ms else ())
    assert tst["requests_in_flight"] == 0
    if retries:
        assert tst["requests_retried"] == 1 and th.attempts == 2
    else:
        assert _outcome(th)[0] == "FaultInjected"


def test_nan_quarantine_spares_cotenants(sides):
    xa, xb = _stims([(20, 2), (20, 2)], seed=10)

    def run(side):
        plan = side.FaultPlan(0, {"surrogate.nan": {"at": [0]}})
        srv = side.server(max_retries=2, retry_backoff_ms=0.0)
        with side.faults.use_plan(plan):
            ha = srv.submit(side.spec, xa, surrogates=side.sur)
            hb = srv.submit(side.spec, xb, surrogates=side.sur)
            srv.run_until_idle()
        assert plan.fired["surrogate.nan"] == 1
        return srv.stats(), [ha, hb]

    (jst, jh), (tst, th) = both(sides, run)
    assert_same_outcomes(jh, th, [sides[1].solo(x) for x in (xa, xb)])
    assert tst["numerical_faults"] == tst["requests_retried"] == 1
    assert {h.attempts for h in th} == {1, 2}
    assert [h.attempts for h in th] == [h.attempts for h in jh]
    assert_same_stats(jst, tst)


def test_degrades_to_behavioral_after_fault_budget(sides):
    """After degrade_after surrogate faults, new admissions of the spec
    serve on the behavioral backend: flagged, listed, and equal to a solo
    behavioral run."""
    x1, x2 = _stims([(12, 1), (12, 1)], seed=11)

    def run(side):
        plan = side.FaultPlan(0, {"surrogate.nan": {"at": [0]}})
        srv = side.server(max_retries=0, degrade_after=1)
        with side.faults.use_plan(plan):
            h1 = srv.submit(side.spec, x1, surrogates=side.sur)
            srv.run_until_idle()
            with pytest.raises(RuntimeError, match="quarantined"):
                h1.result(timeout=5)
            h2 = srv.submit(side.spec, x2, surrogates=side.sur)
            srv.run_until_idle()
        assert h2.degraded and not h1.degraded
        return srv.stats(), [h1, h2]

    (jst, jh), (tst, th) = both(sides, run)
    solo = sides[1].solo(x2, backend="behavioral", surrogates=None)
    assert_same_outcomes(jh[1:], th[1:], [solo])
    assert _outcome(th[0])[0] == _outcome(jh[0])[0] == "RuntimeError"
    assert tst["requests_degraded"] == 1 and tst["degraded_specs"]
    assert any(l["degraded"] for l in tst["lanes"])
    assert_same_stats(jst, tst)


def test_watchdog_fails_hung_lane_only(sides):
    """A lane step stalled past hang_timeout_s fails its requests with the
    watchdog's error; the server serves the next request. The limit is
    tests/test_resilience.py's 0.05 s x 10 and the stall its 0.6 s x 2.5:
    the port's lane step on the CPU runs the kernels' plain versions in
    eager PyTorch, and on a loaded test machine an unstalled step of it
    can pass 0.05 s."""
    x1, x2 = _stims([(8, 1), (8, 1)], seed=12)

    def run(side):
        plan = side.FaultPlan(0, {"chunk.stall": {"at": [0],
                                                  "max_fires": 1}},
                              stall_seconds=1.5)
        srv = side.server(hang_timeout_s=0.5)
        with side.faults.use_plan(plan):
            h1 = srv.submit(side.spec, x1, surrogates=side.sur)
            srv.run_until_idle()
            with pytest.raises(RuntimeError, match="watchdog"):
                h1.result(timeout=5)
            h2 = srv.submit(side.spec, x2, surrogates=side.sur)
            srv.run_until_idle()
        h2.result(timeout=5)
        return srv.stats(), [h1, h2]

    (jst, jh), (tst, th) = both(sides, run)
    assert tst["lane_hangs"] == tst["requests_failed"] == 1
    assert tst["requests_completed"] == 1 and tst["requests_in_flight"] == 0
    assert _outcome(th[0])[0] == _outcome(jh[0])[0] == "RuntimeError"
    assert "watchdog" in _outcome(th[0])[1]
    assert_same_outcomes(jh[1:], th[1:], [sides[1].solo(x2)])
    assert_same_stats(jst, tst)


# --- artifacts registered by path ---------------------------------------------

def test_corrupt_artifact_fails_only_requester(sides, tmp_path):
    corrupt = tmp_path / "bad.npz"
    corrupt.write_bytes(b"PK\x03\x04 truncated garbage")
    x = _stims([(8, 1)], seed=13)[0]

    def run(side):
        srv = side.server()
        srv.register_surrogate("good", side.sur)
        assert srv.register_surrogate_path("bad", str(corrupt)) == 1
        with pytest.raises(side.serve.ArtifactError, match="bad@1") as err:
            srv.submit(side.spec, np.zeros((2, 1, 12), np.float32),
                       surrogates="bad")
        assert "bad.npz" in str(err.value)
        h = srv.submit(side.spec, x, surrogates="good")
        srv.run_until_idle()
        return srv.stats(), h

    (jst, jh), (tst, th) = both(sides, run)
    assert_same_outcomes([jh], [th], [sides[1].solo(x)])
    assert_same_stats(jst, tst)


def test_truncated_artifact_fails_only_requester(sides, tmp_path):
    """A real artifact cut short (as a half-written copy would be) fails
    only its requester with ArtifactError; the valid version beside it
    serves."""
    data = fx.PACKABLE.read_bytes()
    cut = tmp_path / "cut.npz"
    cut.write_bytes(data[:len(data) // 2])
    x = _stims([(8, 1)], seed=19)[0]

    def run(side):
        srv = side.server()
        srv.register_surrogate_path("lif", str(fx.PACKABLE))
        srv.register_surrogate_path("lif", str(cut))
        with pytest.raises(side.serve.ArtifactError, match="lif@2"):
            srv.submit(side.spec, x, surrogates="lif")
        h = srv.submit(side.spec, x, surrogates="lif@1")
        srv.run_until_idle()
        return srv.stats(), h

    (jst, jh), (tst, th) = both(sides, run)
    assert_same_outcomes([jh], [th], [sides[1].solo(x)])
    assert_same_stats(jst, tst)


def test_valid_artifact_roundtrips_through_path_registration(sides):
    """A path-registered artifact loads once, on its first resolve, onto
    the server's device; the lane's banks hold that same object."""
    x = _stims([(12, 2)], seed=14)[0]

    def run(side):
        srv = side.server()
        srv.register_surrogate_path("lif", str(fx.PACKABLE))
        h = srv.submit(side.spec, x, surrogates="lif")
        srv.run_until_idle()
        assert h.surrogate_ref == ("lif", 1)
        return srv, srv.stats(), h

    (js, jst, jh), (ts, tst, th) = both(sides, run)
    assert_same_stats(jst, tst)
    assert_same_outcomes([jh], [th], [sides[1].solo(x)])
    loaded = ts.store.get("lif")
    assert loaded is ts.store.get("lif@1")
    assert loaded.device == torch.device("cpu")
    (lane,) = ts._lanes.values()
    assert lane.surrogates is loaded and lane._banks["lif"] is loaded


def test_artifact_load_fault_site_wrapped(sides):
    def run(side):
        from importlib import import_module
        load_artifact = import_module(
            side.serve.__name__ + ".store").load_artifact
        plan = side.FaultPlan(0, {"artifact.load": {"at": [0]}})
        with side.faults.use_plan(plan):
            with pytest.raises(side.serve.ArtifactError):
                load_artifact(str(fx.PACKABLE), name="ok", version=1,
                              **side.dev)
            load_artifact(str(fx.PACKABLE), name="ok", version=1, **side.dev)
        return plan.fired["artifact.load"]

    assert both(sides, run) == [1, 1]


def test_missing_artifact_keeps_raw_file_not_found(sides, tmp_path):
    def run(side):
        from importlib import import_module
        load_artifact = import_module(
            side.serve.__name__ + ".store").load_artifact
        with pytest.raises(FileNotFoundError) as err:
            load_artifact(str(tmp_path / "never_saved"), **side.dev)
        return str(err.value)

    jgot, tgot = both(sides, run)
    assert tgot == jgot


# --- callbacks, accounting, the canned plan -------------------------------------

def test_callback_explosion_fails_only_its_request(sides):
    xa, xb = _stims([(12, 1), (12, 1)], seed=15)

    def run(side):
        plan = side.FaultPlan(0, {"callback.explode": {"at": [0]}})
        srv = side.server()
        with side.faults.use_plan(plan):
            ha = srv.submit(side.spec, xa, surrogates=side.sur,
                            on_chunk=lambda c: None)
            hb = srv.submit(side.spec, xb, surrogates=side.sur)
            srv.run_until_idle()
        return srv.stats(), [ha, hb]

    (jst, jh), (tst, th) = both(sides, run)
    assert _outcome(th[0])[0] == _outcome(jh[0])[0] == "FaultInjected"
    assert_same_outcomes(jh[1:], th[1:], [sides[1].solo(xb)])
    assert_same_stats(jst, tst)


def test_in_flight_never_negative_across_outcomes(sides):
    """in_flight = submitted - completed - failed, never negative, across
    completion, rejection, deadline expiry, injected faults with retries
    and quarantine."""
    stims = _stims([(10, 1)] * 4, seed=16)

    def run(side):
        plan = side.FaultPlan(0, {"lane.step": {"at": [0]},
                                  "surrogate.nan": {"at": [1]}})
        srv = side.server(max_queue=2, max_retries=3, retry_backoff_ms=0.0)

        def check():
            s = srv.stats()
            assert s["requests_in_flight"] >= 0
            assert s["requests_in_flight"] == (s["requests_submitted"]
                                               - s["requests_completed"]
                                               - s["requests_failed"])
            return s

        with side.faults.use_plan(plan):
            hs = [srv.submit(side.spec, x, surrogates=side.sur,
                             max_retries=3) for x in stims[:2]]
            with pytest.raises(side.serve.ServerBusy):
                srv.submit(side.spec, stims[2], surrogates=side.sur)
            check()
            srv.run_until_idle()
            assert check()["requests_completed"] == 2
            h = srv.submit(side.spec, stims[3], surrogates=side.sur,
                           deadline_ms=1.0)
            time.sleep(0.02)
            srv.run_until_idle()
            assert check()["requests_deadline_exceeded"] == 1
        with pytest.raises(side.serve.DeadlineExceeded):
            h.result(timeout=5)
        s = check()
        assert s["requests_retried"] >= 1 and s["requests_rejected"] == 1
        return s, hs

    (jst, jh), (tst, th) = both(sides, run)
    assert_same_outcomes(jh, th, [sides[1].solo(x) for x in stims[:2]])
    assert_same_stats(jst, tst)


def test_metrics_snapshot_has_resilience_counters(sides):
    def run(side):
        return side.server().stats()

    jst, tst = both(sides, run)
    for key in ("requests_retried", "requests_deadline_exceeded",
                "requests_degraded", "numerical_faults", "lane_hangs",
                "degraded_specs"):
        assert key in tst
    assert_same_stats(jst, tst)


def test_canned_plan_fires_every_site(sides, tmp_path):
    """The CI fault plan over a small workload fires every site at least
    once; nothing leaks or hangs, and every completed record is exact."""
    stims = _stims([(20, 1)] * 3, seed=17)

    def run(side):
        plan = side.FaultPlan.load(str(CI_PLAN))
        sites = side.faults.FAULT_SITES
        solos = [side.solo(x) for x in stims]
        srv = side.server(max_retries=4, retry_backoff_ms=0.0)
        srv.register_surrogate_path("lif", str(fx.PACKABLE))
        with side.faults.use_plan(plan):
            with pytest.raises(side.serve.ArtifactError):
                srv.submit(side.spec, stims[0], surrogates="lif")
            boom = srv.submit(side.spec, stims[0], surrogates="lif",
                              on_chunk=lambda c: None)
            hs = [srv.submit(side.spec, x, surrogates="lif")
                  for x in stims[1:]]
            srv.run_until_idle()
            side.lasana.simulate_stream(side.spec, stims[0],
                                        surrogates=side.sur,
                                        chunk_ticks=CHUNK, **side.dev)
        for site in sites:
            assert plan.fired[site] >= 1, (site, plan.fired)
        assert _outcome(boom)[0] == "FaultInjected"
        assert all(h.done for h in hs)
        assert srv.stats()["requests_in_flight"] == 0
        return srv.stats(), hs, solos[1:], dict(plan.fired)

    (jst, jh, _, jfired), (tst, th, tsolo, tfired) = both(sides, run)
    assert tfired == jfired
    assert_same_outcomes(jh, th, tsolo)
    assert_same_stats(jst, tst)


# --- the port's own rules -------------------------------------------------------------

def test_threaded_submitters_lose_no_update(sides):
    """More client threads than cores submit to one started server under a
    shortened switch interval: request ids stay unique, the counters
    balance and every request equals its solo run."""
    import os
    import sys
    import threading
    side = sides[1]
    n_threads = len(os.sched_getaffinity(0)) + 2
    n = 2 * n_threads
    stims = _stims([(5 + 3 * (i % 4), 1 + i % 2) for i in range(n)], seed=31)
    handles, errors = [None] * n, []

    def client(k):
        try:
            for i in range(k, n, n_threads):
                handles[i] = srv.submit(side.spec, stims[i],
                                        surrogates=side.sur, tenant=f"t{k}")
        except Exception as err:          # noqa: BLE001 - asserted below
            errors.append(err)
    interval = sys.getswitchinterval()
    srv = side.started(max_in_flight=8)
    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads) and not errors
        runs = [h.result(timeout=TIMEOUT) for h in handles]
        st = srv.stats()
    finally:
        sys.setswitchinterval(interval)
        srv.close(timeout=30)
    assert sorted(h.id for h in handles) == list(range(1, n + 1))
    assert st["requests_submitted"] == st["requests_completed"] == n
    assert st["requests_in_flight"] == 0
    for x, run in zip(stims, runs):
        assert_request_parity(side.solo(x), run)


def test_server_refuses_cuda_without_a_card(monkeypatch, sides):
    """No card and no device="cpu": SimServer and lasana.serve raise in
    the constructor, on the caller's thread, and start no driver thread."""
    import threading

    import repro_torch.lasana as lasana
    from repro_torch.serve import ServeConfig, SimServer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = threading.active_count()
    for make in (lambda: SimServer(ServeConfig()),
                 lambda: SimServer(),
                 lambda: lasana.serve(),
                 lambda: lasana.serve(ServeConfig(device="cuda"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert threading.active_count() == before
    assert ServeConfig().device is None


def test_slot_programs_load_the_route_libraries(monkeypatch,
                                                surrogate_pairs):
    """A lane on the card loads, at construction, exactly the kernel
    libraries its routes launch (``_route_libraries``), so its first step
    builds nothing; with them loaded, a lane of the same bucket counts no
    build seconds."""
    from repro_torch.core.network import NetworkEngine
    from repro_torch.kernels import _build
    from repro_torch.serve import Bucket, Lane
    loaded = []
    monkeypatch.setattr(_build, "library", loaded.append)
    monkeypatch.setattr(_build, "n_loaded", lambda: len(set(loaded)))
    spec = fx.port_graph_spec(fx.small_net_desc())
    cases = {"packable": ({}, ("network_tick",)),
             "unpackable": ({}, ("mlp_heads",)),
             "einsum": ({"fused_kernel": False}, ()),
             "behavioral": ({"backend": "behavioral"}, ())}
    for case, (kw, want) in cases.items():
        sur = None if case == "behavioral" else surrogate_pairs[
            "unpackable" if case == "unpackable" else "packable"][1]
        eng = NetworkEngine(spec, record_hidden=False, device="cpu", **kw)
        assert eng._route_libraries(eng._runtime_banks(sur)) == want, case
        Lane(eng, spec, Bucket("k", 4, CHUNK), sur)   # builds on the CPU
        del loaded[:]
        banks = eng._runtime_banks(sur)
        monkeypatch.setattr(eng, "_runtime_banks", lambda s, b=banks: b)
        eng.device = torch.device("cuda")             # the card's branch
        programs = eng.slot_programs(4, CHUNK, sur)
        assert tuple(loaded) == want, case
        assert (programs.compile_seconds > 0) == bool(want)
        again = eng.slot_programs(4, CHUNK, sur)
        assert again.compile_seconds == 0.0


# --- the thread lint --------------------------------------------------------------------

def _lint(source, module, filename):
    from repro_torch.analysis import thread_lint
    return thread_lint.lint_source(
        source, thread_lint.LINT_TABLE[f"src/repro_torch/serve/{module}"],
        filename)


@pytest.mark.parametrize("module", ["server.py", "scheduler.py",
                                    "store.py"])
def test_thread_lint_finds_nothing_in_the_port(module):
    """The locking-discipline tables hold for the port's classes, with
    torch's host syncs counted as blocking calls."""
    path = fx.ROOT / "src" / "repro_torch" / "serve" / module
    assert _lint(path.read_text(), module, str(path)) == []


def test_thread_lint_flags_a_host_sync_under_the_lock():
    """The gate bites: a port-style server that synchronises the card
    while holding its lock is flagged."""
    src = pathlib.Path(fx.ROOT / "src" / "repro_torch" / "serve" /
                       "server.py").read_text()
    bad = src.replace(
        "        with self._lock:\n"
        "            depth = sum(len(q) for q in self._queues.values())\n",
        "        with self._lock:\n"
        "            torch.cuda.synchronize()\n"
        "            depth = sum(len(q) for q in self._queues.values())\n")
    assert bad != src
    findings = _lint(bad, "server.py", "server.py")
    assert [f.check for f in findings] == ["blocking-under-lock"]
    assert "synchronize" in findings[0].message
