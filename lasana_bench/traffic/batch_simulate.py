"""Traffic kind ``batch_simulate``: one caller, whole-batch calls of
``lasana.simulate`` back to back (a closed loop).

Parameters (the cell's traffic file): ``batch`` digits a call, the
``surrogate`` the configuration names, ``profile_calls`` whole calls in
the traced slice, and ``sample_calls``: the program's spikes of one call
drawn from the seed among the first ``sample_calls`` are compared whole;
every call's outputs and per-tick records are compared.

Each call is ``lasana.engine(spec).dispatch(x, surrogates=...)`` then
``.result()``, which is the body of ``lasana.simulate``, so that the host
spans ``dispatch`` and ``result`` stand apart. The stimulus is made on
the device from the seed once; every call simulates it anew.
"""

from __future__ import annotations

import time

import numpy as np


class Workload:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.traffic
        self.net = ctx.net
        self.calls = []          # per call: its records (spikes if sampled)
        self.sample = int(np.random.default_rng(ctx.seed % (1 << 63))
                          .integers(0, self.tr["sample_calls"]))

    # --- set-up ------------------------------------------------------------
    def setup(self, warm: bool = True):
        import repro_torch.lasana as lasana
        ctx = self.ctx
        t0 = time.perf_counter()
        self.spec, self.sur = self.net.program(
            ctx.cfg, ctx.surrogate_path, ctx.device)
        self.eng = lasana.engine(self.spec, device=ctx.device)
        t1 = time.perf_counter()
        self.x = self.net.stimulus(ctx.cfg, self.tr["batch"], ctx.gen)
        self.x.sum().item()                   # made, not only enqueued
        t2 = time.perf_counter()
        self.ticks = 1 if self.x.dim() == 2 else self.x.shape[0]
        if warm:
            self.run_once()                   # builds, loads, warms
            self.calls.clear()
        self.setup_parts = {"program_s": t1 - t0, "stimulus_s": t2 - t1,
                            "warm_s": time.perf_counter() - t2}

    def run_once(self, keep: bool = False):
        sp = self.ctx.spans
        t0 = time.perf_counter()
        with sp("dispatch"):
            pend = self.eng.dispatch(self.x, surrogates=self.sur)
        with sp("result"):
            run = pend.result()
        t1 = time.perf_counter()
        self.calls.append({"run": run if keep else None,
                           "rec": self.net.program_records(run, False)})
        self.last = run
        return {"t0": t0, "t1": t1, "events": int(run.events.sum()),
                "ticks": self.ticks}

    # --- the measured window -------------------------------------------------
    def window(self, seconds: float) -> list:
        """Whole calls from the first call's start until a call ends past
        ``seconds``; no call is cut."""
        units = []
        start = time.perf_counter()
        while not units or units[-1]["t1"] - start < seconds:
            units.append(self.run_once(keep=len(units) == self.sample))
        self._settle()
        return units

    def traced(self, profiler) -> list:
        """The traced run: ``profile_calls`` whole calls under the
        profiler, the first of them sampled for the check."""
        self.sample = 0
        profiler.start()
        units = [self.run_once(keep=i == 0)
                 for i in range(self.tr["profile_calls"])]
        profiler.stop()
        self._settle()
        return units

    def _settle(self):
        """The sampled call's spikes, taken from its host records after
        the window (the last call stands in where the window was
        shorter)."""
        kept = [c for c in self.calls if c["run"] is not None]
        c = kept[0] if kept else self.calls[-1]
        c["rec"] = self.net.program_records(c["run"] or self.last, True)
        c["run"] = self.last = None

    def release(self):
        """Drop the program's state before the reference runs."""
        self.eng = self.spec = self.sur = None

    # --- the check ---------------------------------------------------------
    def reference_run(self, precision: str = "fp32") -> tuple:
        """``(records, rows)``: the reference over the calls' stimulus (one
        record, as every call simulates the same), and its (changed, stale,
        output changed) rows of a call, (T, L, 3)."""
        ctx = self.ctx
        ref = self.net.reference(ctx.cfg, ctx.surrogate_path, ctx.device,
                                 precision)
        want = self.net.reference_records(ref, self.x)
        rows = np.stack([want["changed"], want["stale"],
                         want["out_changed"]], axis=-1)
        return [want], rows

    def check(self) -> tuple:
        """``(gaps a call, rows)``: every call's records against the
        reference's run of the same stimulus."""
        want, rows = self.reference_run()
        return self.compare([c["rec"] for c in self.calls], want), rows

    def compare(self, got: list, want: list) -> list:
        """Each call's gaps against the one reference record; calls whose
        records are equal to an earlier call's, array for array, share
        its gaps."""
        seen, per = [], []
        for rec in got:
            g = next((g for r, g in seen if _equal(r, rec)), None)
            if g is None:
                g = self.net.gaps(rec, want[0])
                seen.append((rec, g))
            per.append(g)
        return per

    def slice_rows(self, rows):
        """The traced slice's rows: the profiled calls' ticks in turn."""
        return np.concatenate([rows] * self.tr["profile_calls"])


def _equal(a: dict, b: dict) -> bool:
    """Two calls' records hold the same keys and equal arrays."""
    if a.keys() != b.keys():
        return False
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, list):
            if len(x) != len(y) or not all(
                    np.array_equal(p, q) for p, q in zip(x, y)):
                return False
        elif not np.array_equal(x, y):
            return False
    return True
