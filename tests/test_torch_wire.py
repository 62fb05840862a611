"""Port parity: the JSON-lines protocol (``repro_torch.serve.protocol``) and
its stdin driver (``python -m repro_torch.serve``) against the
reference's.

The same op script — tests/test_serve.py's round trip plus a hot swap
registered by path, a simulate pinned to ``lif@1`` and a
``simulate_batch`` whose middle entry fails — goes through both packages'
``run_stdio`` over started servers, and the responses agree field by
field: ``ok``, ``id``, ``ticks``, ``events`` and ``outputs`` equal,
``energy_j`` within rtol 1e-5, the same error type, ``stats`` with the
same keys and equal counters (those the driver thread's timing cannot
move). The committed wire record (``serve_wire_record.json``, the
reference's responses to the chip's wire script) is replayed through the
port on the CPU. Every session runs in a helper thread joined with a
timeout, and every server is closed in ``finally``.
"""

import io
import json
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_fixtures as fx  # noqa: E402
from test_torch_fixtures import surrogate_pairs  # noqa: E402,F401

CHUNK = fx.SERVE_CHUNK
KNOBS = [float(k) for k in np.asarray(fx.LIF_KNOBS, np.float32)]
TIMEOUT = 300.0
# stats() entries the driver thread's interleaving cannot move (chunk
# counts, occupancy and queue waits depend on when each submit lands)
WIRE_COUNTERS = ("requests_submitted", "requests_completed",
                 "requests_rejected", "requests_failed", "requests_retried",
                 "requests_deadline_exceeded", "requests_degraded",
                 "requests_in_flight", "numerical_faults", "lane_hangs",
                 "lanes_retired", "ticks_live_total", "events_total",
                 "queue_depth_by_bucket", "degraded_specs", "compile_count",
                 "n_lanes", "surrogates")


def _packages(side):
    if side == "jax":
        import repro.lasana as lasana
        from repro.serve import run_stdio
        return lasana, run_stdio, {}
    import repro_torch.lasana as lasana
    from repro_torch.serve import run_stdio
    return lasana, run_stdio, {"device": "cpu"}


def _bounded(fn, timeout=TIMEOUT):
    """``fn()`` on a daemon thread, joined with ``timeout``: a session that
    hangs fails the test instead of blocking it."""
    out = {}

    def target():
        try:
            out["value"] = fn()
        except BaseException as err:         # noqa: BLE001 - re-raised
            out["error"] = err
    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"session still running after {timeout} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _session(side, ops, register=None, **cfg):
    """Feed ``ops`` (one JSON line each) to ``side``'s ``run_stdio`` over a
    started server; ``register(server)`` runs first. Returns (ops
    handled, responses)."""
    lasana, run_stdio, dev = _packages(side)
    cfg = {"slot_widths": (4,), "chunk_ticks": CHUNK, **cfg, **dev}
    fin = io.StringIO("".join(json.dumps(o) + "\n" for o in ops))
    fout = io.StringIO()
    srv = lasana.serve(**cfg)
    try:
        if register is not None:
            register(srv)
        handled = _bounded(lambda: run_stdio(srv, fin, fout))
    finally:
        srv.close(timeout=60)
    return handled, [json.loads(l) for l in fout.getvalue().splitlines()]


def _result_rows(resp):
    return resp["results"] if "results" in resp else [resp]


def assert_same_responses(jresps, tresps, energy_rtol=1e-5, agree=None):
    """Response by response: the same keys; ``ok``, ``id``, ``ticks``,
    ``events``, ``outputs``, names and versions equal; ``energy_j`` within
    ``energy_rtol``; errors of the same type; ``stats`` with the same keys
    and equal counters. With ``agree``, the output spike counts of all
    responses together need only agree on that share."""
    assert len(tresps) == len(jresps)
    same = total = 0
    for i, (j, t) in enumerate(zip(jresps, tresps)):
        assert set(t) == set(j), i
        for k in ("ok", "id", "name", "version", "shutdown"):
            assert t.get(k) == j.get(k), (i, k)
        if "error" in j:
            assert t["error"].split(":")[0] == j["error"].split(":")[0], i
        if "stats" in j:
            assert set(t["stats"]) == set(j["stats"])
            for k in WIRE_COUNTERS:
                assert t["stats"][k] == j["stats"][k], (i, k)
        if "results" in j or "ticks" in j:
            rows_j, rows_t = _result_rows(j), _result_rows(t)
            assert len(rows_t) == len(rows_j), i
            for a, b in zip(rows_j, rows_t):
                assert set(b) == set(a)
                for k in ("ok", "id", "ticks", "events", "degraded"):
                    assert b[k] == a[k], (i, k)
                if agree is None:
                    assert b["outputs"] == a["outputs"], (i, a["id"])
                out_a, out_b = np.asarray(a["outputs"]), np.asarray(
                    b["outputs"])
                assert out_b.shape == out_a.shape
                same += int((out_a == out_b).sum())
                total += out_a.size
                np.testing.assert_allclose(b["energy_j"], a["energy_j"],
                                           rtol=energy_rtol, atol=0)
    if agree is not None:
        assert same >= agree * total, (same, total)


def _roundtrip_ops(swap_path):
    """tests/test_serve.py's protocol script, then a hot swap registered
    by path, the latest and a pinned ``lif@1``, and a batch whose middle
    entry names an unknown spec."""
    rng = np.random.default_rng(9)
    w1 = rng.normal(0, 0.8, (6, 5)).astype(np.float32)
    w2 = rng.normal(0, 0.8, (5, 3)).astype(np.float32)
    sim = lambda rid, t, b, seed, sur="lif", **kw: dict(
        {"op": "simulate", "id": rid, "spec": "net", "surrogate": sur,
         "stimulus_spikes": {"t": t, "b": b, "rate": 0.25, "seed": seed}},
        **kw)
    return [
        {"op": "register_spec", "name": "net",
         "snn": {"weights": [w1.tolist(), w2.tolist()],
                 "params": [KNOBS, KNOBS]}},
        sim("r0", 12, 2, 5),
        {"op": "simulate_batch", "requests": [
            {"id": f"b{i}", "spec": "net", "surrogate": "lif",
             "tenant": f"t{i}",
             "stimulus_spikes": {"t": 6 + 3 * i, "b": 1, "seed": i}}
            for i in range(3)]},
        {"op": "simulate", "id": "bad", "spec": "ghost",
         "surrogate": "lif", "stimulus_spikes": {"t": 4, "b": 1}},
        {"op": "register_surrogate", "name": "lif", "path": str(swap_path)},
        sim("v2", 12, 2, 5),
        sim("pinned", 12, 2, 5, sur="lif@1"),
        {"op": "simulate_batch", "requests": [
            {"id": "ok", "spec": "net", "surrogate": "lif",
             "stimulus_spikes": {"t": 8, "b": 1, "seed": 4}},
            {"id": "ghost", "spec": "ghost", "surrogate": "lif",
             "stimulus_spikes": {"t": 8, "b": 1}},
            {"id": "never", "spec": "net", "surrogate": "lif",
             "stimulus_spikes": {"t": 8, "b": 1}}]},
        {"op": "simulate", "id": "late", "spec": "net", "surrogate": "lif",
         "deadline_ms": 60000, "max_retries": 1, "tenant": "x",
         "stimulus_spikes": {"t": 9, "b": 3, "rate": 0.3, "seed": 2}},
        {"op": "bogus", "id": "u"},
        {"op": "stats"},
        {"op": "shutdown"},
        {"op": "never_reached"},
    ]


@pytest.fixture(scope="module")
def swap_artifact(tmp_path_factory, surrogate_pairs):
    """The packable artifact with its MLP weights x 1.05, saved by the
    port (the reference's format): the hot swap's version 2."""
    path = tmp_path_factory.mktemp("wire") / "lif_v2.npz"
    fx.scaled_surrogate(surrogate_pairs["packable"][1], 1.05).save(str(path))
    return path


def test_wire_script_matches_reference(swap_artifact):
    ops = _roundtrip_ops(swap_artifact)
    register = lambda srv: srv.register_surrogate_path("lif",
                                                       str(fx.PACKABLE))
    cfg = dict(lane_idle_rounds=10 ** 6)       # lanes live to the stats op
    jn, jresps = _session("jax", ops, register, **cfg)
    tn, tresps = _session("port", ops, register, **cfg)
    assert tn == jn == len(ops) - 1            # shutdown stops the loop
    assert_same_responses(jresps, tresps)
    assert [r["ok"] for r in tresps] == [True, True, True, False, True,
                                         True, True, False, True, False,
                                         True, True]
    r0, v2, pinned = tresps[1], tresps[5], tresps[6]
    assert r0["ticks"] == 12 and np.asarray(r0["outputs"]).shape == (2, 3)
    assert pinned["energy_j"] == r0["energy_j"]
    assert v2["energy_j"] != r0["energy_j"]    # the swap is in effect
    assert [r["ticks"] for r in tresps[2]["results"]] == [6, 9, 12]
    assert tresps[3]["id"] == "bad" and "no spec" in tresps[3]["error"]
    assert tresps[4] == {"ok": True, "name": "lif", "version": 2}
    partial = tresps[7]
    assert "ghost" in partial["error"]
    assert [r["id"] for r in partial["results"]] == ["ok"]
    assert tresps[9]["id"] == "u" and "unknown op" in tresps[9]["error"]
    st = tresps[10]["stats"]
    assert st["requests_completed"] == 8 and st["surrogates"] == {
        "lif": [1, 2]}


def test_protocol_spec_registry_survives_reconnect(surrogate_pairs):
    """Spec names registered on one connection resolve on the next (the
    server-side registry), and a batch that fails partway keeps the
    results of what it submitted."""
    rng = np.random.default_rng(13)
    w = rng.normal(0, 0.8, (6, 3)).astype(np.float32)
    conn1 = [{"op": "register_spec", "name": "net",
              "snn": {"weights": [w.tolist()], "params": [KNOBS]}}]
    conn2 = [
        {"op": "simulate", "id": "r", "spec": "net", "surrogate": "lif",
         "stimulus_spikes": {"t": 8, "b": 1, "seed": 3}},
        {"op": "simulate_batch", "requests": [
            {"id": "ok", "spec": "net", "surrogate": "lif",
             "stimulus_spikes": {"t": 8, "b": 1, "seed": 4}},
            {"id": "bad", "spec": "ghost", "surrogate": "lif",
             "stimulus_spikes": {"t": 8, "b": 1}}]},
    ]
    out = {}
    for side, sur in zip(("jax", "port"), surrogate_pairs["packable"]):
        lasana, run_stdio, dev = _packages(side)
        srv = lasana.serve(slot_widths=(4,), chunk_ticks=CHUNK, **dev)
        try:
            srv.register_surrogate("lif", sur)
            resps = []
            for ops in (conn1, conn2):        # two connections, one server
                fin = io.StringIO("".join(json.dumps(o) + "\n"
                                          for o in ops))
                fout = io.StringIO()
                _bounded(lambda: run_stdio(srv, fin, fout))
                resps += [json.loads(l) for l in
                          fout.getvalue().splitlines()]
        finally:
            srv.close(timeout=60)
        out[side] = resps
    assert_same_responses(out["jax"], out["port"])
    r = out["port"]
    assert r[0]["ok"] and r[1]["ok"] and r[1]["ticks"] == 8
    assert not r[2]["ok"] and "ghost" in r[2]["error"]
    assert [x["id"] for x in r[2]["results"]] == ["ok"]


def _main_session(monkeypatch, capsys, module, argv, ops):
    """``module.main()`` with ``argv`` and ``ops`` on stdin: (responses,
    the driver's summary line on stderr)."""
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "".join(json.dumps(o) + "\n" for o in ops)))
    _bounded(module.main)
    out, err = capsys.readouterr()
    return [json.loads(l) for l in out.splitlines()], err


def test_main_serves_stdin_like_the_reference(monkeypatch, capsys):
    """``python -m repro_torch.serve --device cpu`` on a stdin script (an
    artifact registered by path) answers as ``python -m repro.serve``."""
    import repro.serve.__main__ as jax_main
    import repro_torch.serve.__main__ as port_main
    rng = np.random.default_rng(21)
    w = rng.normal(0, 0.8, (12, 4)).astype(np.float32)
    ops = [{"op": "register_surrogate", "name": "lif",
            "path": str(fx.PACKABLE)},
           {"op": "register_spec", "name": "n",
            "snn": {"weights": [w.tolist()], "params": [KNOBS]}},
           {"op": "simulate_batch", "requests": [
               {"id": f"q{i}", "spec": "n", "surrogate": "lif",
                "stimulus_spikes": {"t": 10 + i, "b": 1 + i, "seed": i}}
               for i in range(3)]},
           {"op": "stats"}, {"op": "shutdown"}]
    argv = ["--slot-widths", "2,4", "--chunk-ticks", "8",
            "--max-in-flight", "8"]
    jresps, jerr = _main_session(monkeypatch, capsys, jax_main, argv, ops)
    tresps, terr = _main_session(monkeypatch, capsys, port_main,
                                 argv + ["--device", "cpu"], ops)
    assert_same_responses(jresps, tresps)
    assert len(tresps) == len(ops) and all(r["ok"] for r in tresps)
    assert "[serve] handled 5 ops, 3 requests" in terr
    assert terr.split(" compiled")[0] == jerr.split(" compiled")[0]


def test_main_without_a_card_raises(monkeypatch, capsys):
    """The driver's default ``--device cuda`` raises where there is no
    card, before reading a line."""
    import repro_torch.serve.__main__ as port_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _main_session(monkeypatch, capsys, port_main, [], [{"op": "stats"}])


def test_train_op_trains_on_the_server_device():
    """``register_surrogate`` with ``train`` fits on the server's device
    (the CPU here) and registers the result as the next version."""
    ops = [{"op": "register_surrogate", "name": "x",
            "train": {"circuit": "crossbar", "n_runs": 12, "n_steps": 10}},
           {"op": "stats"}, {"op": "shutdown"}]
    captured = {}

    def register(srv):
        captured["srv"] = srv
    n, resps = _session("port", ops, register)
    assert n == 3 and resps[0] == {"ok": True, "name": "x", "version": 1}
    assert resps[1]["stats"]["surrogates"] == {"x": [1]}
    sur = captured["srv"].store.get("x")
    assert sur.circuit == "crossbar" and sur.device == torch.device("cpu")
    assert dict(sur.manifest.families).keys() == {"M_O", "M_V", "M_ED",
                                                  "M_ES", "M_L"}


# --- the committed wire record ---------------------------------------------------

def _record():
    return json.loads(fx.WIRE_RECORD.read_text())


def test_wire_record_holds_the_wire_script():
    """The record's script is :func:`wire_script` and its responses are
    the reference's: every op answered, 8 + 1 requests of 100 ticks."""
    rec = _record()
    assert rec["script"] == fx.wire_script()
    assert tuple(rec["slot_widths"]) == fx.WIRE_SLOT_WIDTHS
    assert rec["chunk_ticks"] == fx.WIRE_CHUNK
    resps = rec["responses"]
    assert len(resps) == len(rec["script"]) and all(r["ok"] for r in resps)
    batch = resps[2]["results"]
    assert [r["id"] for r in batch] == [f"b{i}" for i in range(8)]
    assert [np.asarray(r["outputs"]).shape for r in batch] == [
        (i + 1, 10) for i in range(8)]
    assert all(r["ticks"] == fx.T_STEPS for r in batch + [resps[3]])
    assert resps[4]["stats"]["requests_completed"] == 9
    ops = fx.wire_ops(rec["script"])
    assert ops[0]["path"] == str(fx.PACKABLE)
    w = ops[1]["snn"]["weights"]
    assert np.asarray(w[0]).shape == (784, 128)
    assert np.asarray(w[1]).shape == (128, 10)


def test_wire_record_replays_on_the_port():
    """The wire script through the port's ``run_stdio`` on the CPU answers
    as the reference's recorded responses within the SNN's limits (the
    chip replays it on the card through ``python -m repro_torch.serve``):
    output spike counts >= 99% equal and energy within 1% — as the
    reference's own paths differ: its served request b4 (its fused tick)
    and its default ``simulate`` of the same digits differ by one spike
    on 2 of the 400 counts, and the port's runs give the latter's."""
    rec = _record()
    ops = fx.wire_ops(rec["script"])
    n, resps = _session("port", ops, slot_widths=tuple(rec["slot_widths"]),
                        chunk_ticks=rec["chunk_ticks"])
    assert n == len(ops)
    assert_same_responses(rec["responses"], resps, energy_rtol=0.01,
                          agree=0.99)
