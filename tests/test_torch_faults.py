"""Port parity: fault injection, the watchdog, buckets and metrics
(``repro_torch.resilience.faults``, ``repro_torch.ft``,
``repro_torch.serve.buckets`` / ``metrics`` vs ``repro``).

A plan fires at the same invocations and draws the same numbers as the
reference's for the same seed and order, and plans cross between the
packages. On a lane, ``surrogate.nan`` quarantines the reference's victim
and spares its co-tenants, ``lane.step`` and ``callback.explode`` fail only
what they should, and ``chunk.stall`` leaves a stream equal to the
monolithic run. Content keys are the reference's digests; the counters of
a lane run are the reference's.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import test_torch_fixtures as fx  # noqa: E402
from test_torch_fixtures import (assert_request_parity,  # noqa: E402,F401
                                 surrogate_pairs)

SCHEDULES = [{"at": [0, 5, 999]}, {"rate": 0.1},
             {"at": [3], "rate": 0.05, "max_fires": 7},
             {"rate": 1.0, "max_fires": 2}]


def _plans(sites, seed=0, **kw):
    """(reference FaultPlan, port FaultPlan) of one description."""
    from repro.resilience.faults import FaultPlan as JaxPlan
    from repro_torch.resilience.faults import FaultPlan
    return JaxPlan(seed, sites, **kw), FaultPlan(seed, sites, **kw)


def _trace(plan, site, n=1000):
    """``n`` invocations of ``site``, with one extra draw every 10th."""
    out = []
    for i in range(n):
        out.append(plan.should_fire(site))
        if i % 10 == 9:
            out.append(plan.draw(site))
    return out


# --- the plan against the reference's ----------------------------------------

@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("site", ["surrogate.nan", "lane.step"])
def test_plan_fires_and_draws_as_the_reference(sched, site):
    jp, tp = _plans({site: sched}, seed=11)
    assert _trace(tp, site) == _trace(jp, site)
    assert tp.fired == jp.fired and tp.calls == jp.calls
    assert tp.draw("chunk.stall") == jp.draw("chunk.stall")  # unscheduled


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_plan_files_cross_both_ways(tmp_path, writer):
    from repro.resilience.faults import FaultPlan as JaxPlan
    from repro_torch.resilience.faults import FaultPlan
    sites = {"lane.step": {"at": [1, 4]},
             "surrogate.nan": {"rate": 0.2, "max_fires": 3},
             "chunk.stall": {"rate": 1.0}}
    jp, tp = _plans(sites, seed=3, stall_seconds=0.5)
    path = str(tmp_path / "plan.json")
    (jp if writer == "reference" else tp).save(path)
    reader = FaultPlan if writer == "reference" else JaxPlan
    loaded = reader.load(path)
    assert loaded.to_json() == jp.to_json() == tp.to_json()
    for site in sites:
        assert _trace(loaded, site, 200) == _trace(
            (tp if writer == "reference" else jp), site, 200)


def test_plan_rejects_what_the_reference_rejects():
    from repro_torch.resilience.faults import FaultPlan, SiteSchedule
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan(0, {"disk.full": {"at": [0]}})
    with pytest.raises(ValueError, match="newer than"):
        FaultPlan.from_json({"format_version": 99})
    with pytest.raises(ValueError, match="rate"):
        SiteSchedule(rate=1.5)
    with pytest.raises(ValueError, match="'at'"):
        SiteSchedule(at=(-1,))


def test_env_plan_read_through_ops(tmp_path, monkeypatch):
    """``REPRO_FAULT_PLAN`` reaches the active plan through
    ``ops.fault_plan_path`` (an empty value is no plan), and no module of
    the port but ``kernels/ops.py`` touches the environment (the
    program auditor's ``check_env_discipline``)."""
    from repro_torch.kernels import ops
    from repro_torch.resilience import faults
    path = _plans({"lane.step": {"at": [0]}})[1].save(
        str(tmp_path / "p.json"))
    monkeypatch.setenv("REPRO_FAULT_PLAN", path)
    assert ops.fault_plan_path() == path
    plan = faults.active_plan()
    assert plan.to_json()["sites"] == {"lane.step": {"at": [0]}}
    with pytest.raises(faults.FaultInjected):
        faults.check("lane.step")
    assert faults.active_plan() is plan            # one live plan per path
    with faults.use_plan(None):                    # an override shadows it
        assert faults.active_plan() is None
    monkeypatch.setenv("REPRO_FAULT_PLAN", "")
    assert ops.fault_plan_path() is None and faults.active_plan() is None
    from repro_torch.analysis import jaxpr_audit
    assert jaxpr_audit.check_env_discipline() == []


def test_hooks_do_nothing_without_a_plan():
    from repro_torch.resilience import faults
    with faults.use_plan(None):
        assert faults.should_fire("lane.step") is False
        faults.check("lane.step")
        assert faults.stall() == 0.0 and faults.draw("surrogate.nan") == 0.0


# --- faults on a lane ---------------------------------------------------------

def _lane_pair(surs, desc=None, width=4):
    from repro.serve.buckets import Bucket as JaxBucket
    from repro.serve.metrics import ServerMetrics as JaxMetrics
    from repro.serve.scheduler import Lane as JaxLane
    from repro_torch.serve import Bucket, Lane, ServerMetrics
    from repro.core.network import NetworkEngine as JaxEngine
    from repro_torch.core.network import NetworkEngine
    desc = desc or fx.small_net_desc()
    jeng = JaxEngine(fx.jax_graph_spec(desc), record_hidden=False,
                     fused_kernel=True)
    teng = NetworkEngine(fx.port_graph_spec(desc), record_hidden=False,
                         fused_kernel=True, device="cpu")
    return (JaxLane(jeng, jeng.spec, JaxBucket("k", width, fx.SERVE_CHUNK),
                    surs[0], metrics=JaxMetrics()),
            Lane(teng, teng.spec, Bucket("k", width, fx.SERVE_CHUNK),
                 surs[1], metrics=ServerMetrics()))


def _drive_faulty(lane, handle_cls, stims, faults, plan, on_chunk=None):
    """``fx.drive_lane`` under ``plan``, carrying on past a step that
    raised: returns (handles, quarantined requests, step errors)."""
    queue = [fx.Queued(handle_cls(i, "t", (on_chunk or {}).get(i)), x)
             for i, x in enumerate(stims)]
    handles = [q.handle for q in queue]
    quarantined, errors = [], []
    with faults.use_plan(plan):
        for _ in range(100):
            while queue and lane.admit(queue[0]):
                queue.pop(0)
            if not lane.active and not queue:
                break
            g = lane.g
            try:
                quarantined += lane.step().get("quarantined", [])
            except faults.FaultInjected as err:
                errors.append(err)
                assert lane.g == g        # raised before any dispatch
    return handles, quarantined, errors


def test_nan_quarantine_picks_the_reference_victim(surrogate_pairs):
    """A ``surrogate.nan`` burst on the second step quarantines the
    request the reference's lane quarantines under the same plan; its
    co-tenants equal their solo runs, and the victim, re-admitted alone,
    equals its solo run too."""
    from repro.resilience import faults as jax_faults
    from repro.serve.scheduler import RequestHandle as JaxHandle
    from repro_torch.resilience import faults
    from repro_torch.serve import RequestHandle
    stims = fx.serve_stimuli([(20, 2), (20, 1), (12, 1)], seed=10)
    jp, tp = _plans({"surrogate.nan": {"at": [1]}})
    jlane, tlane = _lane_pair(surrogate_pairs["packable"])
    jh, jq, _ = _drive_faulty(jlane, JaxHandle, stims, jax_faults, jp)
    th, tq, _ = _drive_faulty(tlane, RequestHandle, stims, faults, tp)
    assert tp.fired == jp.fired and tp.fired["surrogate.nan"] == 1
    assert [a.handle.id for a in tq] == [a.handle.id for a in jq]
    assert len(tq) == 1
    victim = tq[0]
    assert tlane.metrics.snapshot()["numerical_faults"] == 1
    eng, sur = tlane.engine, surrogate_pairs["packable"][1]
    for i, (x, h) in enumerate(zip(stims, th)):
        if i != victim.handle.id:
            assert_request_parity(eng.run(x, surrogates=sur), h.result())
    assert not victim.handle.done
    victim.handle._reset_for_retry()
    assert tlane.admit(victim.q) and victim.handle.attempts == 2
    while tlane.active:
        tlane.step()
    x = stims[victim.handle.id]
    assert_request_parity(eng.run(x, surrogates=sur), victim.handle.result())


def test_lane_step_and_callback_faults_fail_only_their_target(
        surrogate_pairs):
    """``lane.step`` raises before the step dispatches anything and the
    next step proceeds (every record still equals its solo run);
    ``callback.explode`` fails the one request whose callback it hit."""
    from repro_torch.resilience import faults
    from repro_torch.resilience.faults import FaultPlan
    from repro_torch.serve import RequestHandle
    stims = fx.serve_stimuli([(12, 1), (12, 1), (9, 2)], seed=15)
    _, lane = _lane_pair(surrogate_pairs["packable"])
    plan = FaultPlan(0, {"lane.step": {"at": [1]},
                         "callback.explode": {"at": [0]}})
    handles, quarantined, errors = _drive_faulty(
        lane, RequestHandle, stims, faults, plan,
        on_chunk={0: lambda chunk: None})
    assert [e.site for e in errors] == ["lane.step"] and not quarantined
    assert plan.fired["callback.explode"] == 1
    with pytest.raises(faults.FaultInjected, match="callback.explode"):
        handles[0].result()
    eng, sur = lane.engine, surrogate_pairs["packable"][1]
    for x, h in zip(stims[1:], handles[1:]):
        assert_request_parity(eng.run(x, surrogates=sur), h.result())


def test_stall_leaves_stream_equal_to_monolithic(surrogate_pairs):
    """``chunk.stall`` in the port's stream only slows chunks: the stream
    equals the monolithic run bit for bit, and the site is consumed and
    fires as often as in the reference's stream."""
    from repro.resilience import faults as jax_faults
    from repro_torch.resilience import faults
    import repro.lasana as jax_lasana
    import repro_torch.lasana as lasana
    jsur, tsur = surrogate_pairs["packable"]
    desc = fx.small_net_desc()
    jspec, tspec = fx.jax_graph_spec(desc), fx.port_graph_spec(desc)
    x = fx.serve_stimuli([(16, 2)], seed=6)[0]
    mono = lasana.simulate(tspec, x, surrogates=tsur, device="cpu")
    jp, tp = _plans({"chunk.stall": {"rate": 1.0, "max_fires": 2}},
                    stall_seconds=0.01)
    with jax_faults.use_plan(jp):
        jax_lasana.simulate_stream(jspec, jnp.asarray(x), surrogates=jsur,
                                   chunk_ticks=5)
    t0 = time.monotonic()
    with faults.use_plan(tp):
        run = lasana.simulate_stream(tspec, x, surrogates=tsur,
                                     chunk_ticks=5, device="cpu")
    assert time.monotonic() - t0 >= 0.02
    assert tp.fired == jp.fired and tp.calls == jp.calls
    assert tp.fired["chunk.stall"] == 2 and tp.calls["chunk.stall"] == 4
    for f in ("outputs", "out_spikes", "events", "energy", "latency",
              "flush_energy"):
        np.testing.assert_array_equal(getattr(run, f), getattr(mono, f),
                                      err_msg=f)


def test_metrics_counters_match_reference(surrogate_pairs):
    """The counters of ``ServerMetrics.snapshot()`` after the same lane run
    (the seconds and the rates per second left out)."""
    from repro.serve.scheduler import RequestHandle as JaxHandle
    from repro_torch.serve import RequestHandle
    stims = fx.serve_stimuli([(10, 1), (17, 2), (5, 1), (9, 1)], seed=16)
    jlane, tlane = _lane_pair(surrogate_pairs["packable"], width=3)
    fx.drive_lane(jlane, JaxHandle, stims)
    fx.drive_lane(tlane, RequestHandle, stims)
    timed = {"uptime_seconds", "requests_per_sec", "events_per_sec",
             "compile_seconds", "steady_seconds"}
    want = {k: v for k, v in jlane.metrics.snapshot().items()
            if k not in timed}
    got = tlane.metrics.snapshot()
    assert set(got) == set(want) | timed
    assert {k: got[k] for k in want} == want
    assert got["events_total"] > 0 and got["requests_completed"] == 4


# --- the step watchdog (tests/test_ft.py's four cases) -----------------------

def test_watchdog_flags_straggler():
    from repro_torch.ft import StepWatchdog
    wd = StepWatchdog(threshold=2.0, hang_timeout=1e9)
    for _ in range(5):
        wd.step_begin()
        time.sleep(0.01)
        wd.step_end(0)
    wd.step_begin()
    time.sleep(0.1)
    out = wd.step_end(5)
    assert out["straggler"]
    assert wd.stragglers == 1


def test_watchdog_uses_monotonic_clock(monkeypatch):
    from repro_torch.ft import StepWatchdog

    def _wall_clock_banned():
        raise AssertionError("watchdog read time.time()")

    monkeypatch.setattr(time, "time", _wall_clock_banned)
    wd = StepWatchdog(hang_timeout=1e9)
    wd.step_begin()
    out = wd.step_end(0)
    assert out["step_seconds"] >= 0.0


def test_watchdog_hang_fires_once_for_real_hang():
    from repro_torch.ft import StepWatchdog
    fired = []
    wd = StepWatchdog(hang_timeout=0.02, on_hang=lambda: fired.append(1))
    wd.step_begin()
    time.sleep(0.15)                 # the step overruns the limit
    assert fired == [1]
    assert wd.hangs == 1
    wd.step_end(0)                   # completion after the fire is fine


def test_watchdog_never_fires_after_completion():
    """A timer thread past its wait when cancel lands sees the step closed
    (generation and open flag re-checked under the lock) and stays
    silent; a stale generation is inert while a new step is open."""
    from repro_torch.ft import StepWatchdog
    fired = []
    wd = StepWatchdog(hang_timeout=60.0, on_hang=lambda: fired.append(1))
    wd.step_begin()
    gen = wd._gen
    wd.step_end(0)
    wd._fire(gen)
    assert fired == [] and wd.hangs == 0
    wd.step_begin()
    wd._fire(gen)
    assert fired == [] and wd.hangs == 0
    wd.step_end(1)


# --- buckets ------------------------------------------------------------------

def _key_cases():
    rng = np.random.default_rng(21)
    xbar = {"layers": [{"circuit": "crossbar",
                        "weight": rng.integers(-1, 2, (70, 12))},
                       {"circuit": "crossbar",
                        "weight": rng.integers(-1, 2, (12, 4)),
                        "activation": "none", "adc_bits": 6}],
            "edges": []}
    return {"snn": fx.small_net_desc(), "crossbar_mlp": xbar,
            "recurrent": fx.mixed_serve_net()[0]}


@pytest.mark.parametrize("case", ["snn", "crossbar_mlp", "recurrent"])
def test_spec_content_key_is_the_reference_digest(case):
    from repro.serve.buckets import spec_content_key as jax_key
    from repro_torch.serve import spec_content_key
    desc = _key_cases()[case]
    if case == "crossbar_mlp":
        from repro.core.network import crossbar_layer, graph_spec
        jspec = graph_spec([crossbar_layer(
            jnp.asarray(d["weight"], jnp.float32),
            **{k: v for k, v in d.items() if k not in ("circuit", "weight")})
            for d in desc["layers"]])
    else:
        jspec = fx.jax_graph_spec(desc)
    assert spec_content_key(fx.port_graph_spec(desc)) == jax_key(jspec)


def test_bucket_policy_quantization():
    """tests/test_serve.py::test_bucket_policy_quantization on the port."""
    from repro_torch.core.network import snn_spec
    from repro_torch.serve import BucketPolicy, spec_content_key
    pol = BucketPolicy(slot_widths=(8, 2), chunk_ticks=4)   # sorts
    assert pol.slot_widths == (2, 8) and pol.max_width == 8
    assert [pol.width_for(b) for b in (1, 2, 3, 8)] == [2, 2, 8, 8]
    with pytest.raises(ValueError, match="exceeds the widest"):
        pol.width_for(9)
    with pytest.raises(ValueError, match="slot_widths"):
        BucketPolicy(slot_widths=())
    with pytest.raises(ValueError, match="chunk_ticks"):
        BucketPolicy(chunk_ticks=0)
    spec = fx.port_graph_spec(fx.small_net_desc(0))
    key = spec_content_key(spec)
    assert pol.bucket_for(key, 2).key == (key, 2, 4)
    assert spec_content_key(fx.port_graph_spec(fx.small_net_desc(0))) == key
    assert spec_content_key(fx.port_graph_spec(fx.small_net_desc(1))) != key
    perturbed = snn_spec([np.asarray(l.weight) * 1.01 for l in spec.layers],
                         [l.params for l in spec.layers])
    assert spec_content_key(perturbed) != key
