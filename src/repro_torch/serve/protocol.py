"""Minimal JSON-lines request/response protocol for the server (port of
``repro.serve.protocol``; the same ops and the same responses, field for
field).

One op object per line in, one response object per line out — the same
loop serves stdin/stdout (``python -m repro_torch.serve``), a TCP socket
(``--port``), and in-process tests (any file-like pair). Ops:

``{"op": "register_surrogate", "name": N, "path": P}``
    register a saved artifact (``lasana.load``, on the server's device, at
    its first use) in the store; or train one in place on the server's
    device with ``"train": {"circuit": "lif", "n_runs": ..,
    "families": [..]}``. Response: ``{"ok": true, "version": v}``.
``{"op": "register_spec", "name": N, "snn": {"weights": [...],
   "params": [...]}}``
    register a feed-forward SNN spec under a name (the in-process API
    accepts arbitrary ``NetworkSpec`` objects; the wire protocol covers
    the homogeneous case).
``{"op": "simulate", "spec": N, "surrogate": "name[@ver]",
   "stimulus": [[[...]]]}``
    submit one request and stream until done. Response carries the
    merged record's headline numbers (outputs, energy, events, ticks)
    plus a ``"degraded"`` flag (True when served by the behavioral
    fallback). Optional ``"deadline_ms"`` / ``"max_retries"`` map to the
    same-named ``submit`` arguments (see docs/resilience.md).
    Spec names resolve from this connection's registrations first, then
    the server-wide registry (names survive reconnects).
    ``"stimulus_spikes": {"t": T, "b": B, "rate": p, "seed": s}``
    generates a Bernoulli spike train server-side instead of shipping
    the array.
``{"op": "simulate_batch", "requests": [...]}``
    submit every entry (same fields as ``simulate``) BEFORE collecting
    any result — this is the op that exercises continuous batching over
    the wire. If a later submit is rejected (bad entry, ``ServerBusy``),
    the already-submitted requests are still collected: the response is
    ``{"ok": false, "error": msg, "results": [...partials...]}``.
``{"op": "stats"}`` / ``{"op": "shutdown"}``
    the ``/stats`` report; drain and stop.

Every response echoes the request ``"id"`` when given; errors come back
as ``{"ok": false, "error": msg}`` without killing the session.
"""

from __future__ import annotations

import json

import numpy as np


def _build_spec(obj: dict):
    from repro_torch.core.network import snn_spec
    if "snn" not in obj:
        raise ValueError("register_spec needs an 'snn' description: "
                         "{'weights': [...], 'params': [...]}")
    snn = obj["snn"]
    weights = [np.asarray(w, np.float32) for w in snn["weights"]]
    params = [np.asarray(p, np.float32) for p in snn["params"]]
    return snn_spec(weights, params,
                    spike_amp=float(snn.get("spike_amp", 1.5)))


def _stimulus(req: dict, spec) -> np.ndarray:
    if "stimulus" in req:
        return np.asarray(req["stimulus"], np.float32)
    gen = req.get("stimulus_spikes")
    if gen is None:
        raise ValueError("simulate needs 'stimulus' (nested lists) or "
                         "'stimulus_spikes' ({t, b, rate, seed})")
    rng = np.random.default_rng(int(gen.get("seed", 0)))
    amp = float(getattr(spec, "spike_amp", 1.5))
    shape = (int(gen["t"]), int(gen["b"]), spec.layers[0].fan_in)
    return (rng.random(shape) < float(gen.get("rate", 0.2))
            ).astype(np.float32) * amp


def _summarize(handle, req_id) -> dict:
    run = handle.result()
    rep = run.report()["network"]
    out = {"ok": True,
           "outputs": np.asarray(run.outputs).tolist(),
           "energy_j": rep["energy_j"],
           "events": rep["events"],
           "ticks": rep["ticks"],
           "degraded": bool(handle.degraded)}
    if req_id is not None:
        out["id"] = req_id
    return out


def _submit(server, req: dict, specs: dict):
    name = req.get("spec")
    spec = specs.get(name)
    if spec is None and isinstance(name, str):
        # fall back to the server-side registry so a reconnecting client
        # can keep using names registered on an earlier connection
        spec = server.spec(name)
    if spec is None:
        raise KeyError(f"no spec registered under {name!r}")
    kw = {}
    if req.get("deadline_ms") is not None:
        kw["deadline_ms"] = float(req["deadline_ms"])
    if req.get("max_retries") is not None:
        kw["max_retries"] = int(req["max_retries"])
    return server.submit(
        spec, _stimulus(req, spec), surrogates=req["surrogate"],
        tenant=str(req.get("tenant", "default")),
        mode=str(req.get("mode", "standalone")), **kw), req.get("id")


def handle_op(server, obj: dict, specs: dict):
    """Execute one protocol op; returns (response dict, keep_going)."""
    op = obj.get("op")
    if op == "register_surrogate":
        import repro_torch.lasana as lasana
        if "path" in obj:
            # lazy: the artifact loads on first resolve, so a corrupt
            # file fails the requesting simulate (ArtifactError naming
            # name@version + path), never this registration
            version = server.register_surrogate_path(obj["name"],
                                                     obj["path"])
            return ({"ok": True, "name": obj["name"],
                     "version": version}, True)
        if "train" in obj:
            t = dict(obj["train"])
            circuit = t.pop("circuit", "lif")
            t.setdefault("families", ("mean", "linear"))
            t["families"] = tuple(t["families"])
            artifact = lasana.train(circuit, lasana.TrainConfig(**t),
                                    device=server.config.device)
        else:
            raise ValueError("register_surrogate needs 'path' or 'train'")
        version = server.register_surrogate(obj["name"], artifact)
        return {"ok": True, "name": obj["name"], "version": version}, True
    if op == "register_spec":
        spec = _build_spec(obj)
        specs[obj["name"]] = spec
        server.register_spec(obj["name"], spec)
        return {"ok": True, "name": obj["name"]}, True
    if op == "simulate":
        handle, req_id = _submit(server, obj, specs)
        return _summarize(handle, req_id), True
    if op == "simulate_batch":
        handles, error = [], None
        for r in obj["requests"]:
            try:
                handles.append(_submit(server, r, specs))
            except Exception as err:   # collect what WAS submitted — the
                error = f"{type(err).__name__}: {err}"   # work is in
                break                                    # flight either way
        results = [_summarize(h, rid) for h, rid in handles]
        if error is not None:
            return {"ok": False, "error": error, "results": results}, True
        return {"ok": True, "results": results}, True
    if op == "stats":
        return {"ok": True, "stats": server.stats()}, True
    if op == "shutdown":
        return {"ok": True, "shutdown": True}, False
    raise ValueError(f"unknown op {op!r}")


def run_stdio(server, infile, outfile) -> int:
    """Serve JSON-lines ops from ``infile`` to ``outfile`` until EOF or
    ``shutdown``; returns the number of ops handled. The server must be
    started (driver thread) — this loop only parses, submits, and
    blocks on results, exactly like a remote client."""
    handled = 0
    specs: dict = {}
    for line in infile:
        line = line.strip()
        if not line:
            continue
        keep, obj = True, None
        try:
            obj = json.loads(line)
            resp, keep = handle_op(server, obj, specs)
        except Exception as err:         # malformed op != dead session
            resp = {"ok": False, "error": f"{type(err).__name__}: {err}"}
            if isinstance(obj, dict) and obj.get("id") is not None:
                resp["id"] = obj.get("id")
        outfile.write(json.dumps(resp) + "\n")
        outfile.flush()
        handled += 1
        if not keep:
            break
    return handled
