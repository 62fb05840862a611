"""Continuous-batching scheduler: lanes of slot-multiplexed requests (port
of ``repro.serve.scheduler``).

A :class:`Lane` is one live instance of an engine's slot runners (one
:class:`~repro_torch.serve.buckets.Bucket` x one surrogate artifact x one
engine mode): a persistent ``width``-slot batch on the engine's device
whose global tick counter ``g`` advances one ``chunk_ticks`` quantum per
:meth:`Lane.step`. Concurrent requests own disjoint slot sets inside the
batch; they

  * JOIN at a chunk boundary — the ``join`` runner re-initialises their
    slots with ``t_last = g`` in each layer's own clock, which by
    time-translation invariance gives the slot the tau sequence (and so
    every surrogate prediction) of a request started at tick 0;
  * RUN under a per-slot live mask — each tick only slots whose request
    still has stimulus are simulated, so co-batched requests of different
    lengths never touch each other and padding is frozen, not computed;
  * LEAVE mid-chunk — on the chunk where a request's stimulus ends, the
    ``flush`` runner charges ITS trailing idle energy (per-slot end
    times; every other slot charges exactly zero) and the slots return to
    the free list for the next joiner.

A step uploads the chunk's host stimulus block once, enqueues the chunk
with no host synchronisation inside it, and fetches the per-slot records
``(T, L, width)`` once, through the engine's pinned copies behind a CUDA
event. They are sliced back into per-request chunk :class:`NetworkRun`
records and pushed to each request's :class:`RequestHandle`; their merge
is the request's whole-run record, equal to a solo ``lasana.simulate`` bit
for bit on discrete records (rtol 1e-5 on f32 energy sums, whose
slot-wise reduction reassociates float addition; latency maxes also carry
a one-ULP absolute epsilon).

Different surrogate *versions* cannot share a lane — the surrogate is one
argument of the batched runner — but lanes of equal structure share the
engine's runners, so a version rollout builds nothing.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from repro_torch.core.network import NetworkRun
from repro_torch.resilience import faults


class RequestHandle:
    """Caller-facing future for one submitted simulation request.

    Chunk records stream in as the scheduler retires them (``on_chunk``
    fires from the driving thread); :meth:`result` blocks for — and
    merges — the complete per-request :class:`NetworkRun`."""

    def __init__(self, req_id: int, tenant: str, on_chunk=None):
        self.id = req_id
        self.tenant = tenant
        self._on_chunk = on_chunk
        self._chunks: list = []
        self._done = threading.Event()
        self._error = None
        self._result = None
        self.wait_chunks = 0          # scheduler rounds spent queued
        self.surrogate_ref = None     # (name, version) when store-resolved
        self.degraded = False         # served on the behavioral fallback
        self.attempts = 0             # admissions consumed (1 + retries)

    def _push(self, chunk: NetworkRun):
        self._chunks.append(chunk)
        if self._on_chunk is not None:
            try:
                faults.check("callback.explode")
                self._on_chunk(chunk)
            except Exception as err:   # a user callback raising must fail
                self._on_chunk = None  # ITS request, not the serving loop
                self._fail(err)

    def _reset_for_retry(self):
        """Drop partial chunk records so that a re-admission replays the
        whole request: chunks of a faulted attempt never mix into it."""
        self._chunks = []

    def _finish(self):
        self._result = NetworkRun.merge(self._chunks)
        self._done.set()

    def _fail(self, err: Exception):
        self._error = err
        self._done.set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def chunks(self) -> list:
        """Per-chunk records received so far (complete once ``done``)."""
        return list(self._chunks)

    def result(self, timeout=None) -> NetworkRun:
        """Block until the request completes; the merged NetworkRun."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} still in flight "
                               f"after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


class _Active:
    """One seated request: its queue entry, slots, and tick window.

    Keeps the whole queue entry (``.handle``, ``.stimulus``) so that a
    server can requeue a quarantined or fault-hit request."""

    def __init__(self, q, slots: list, g0: int):
        self.q = q
        self.handle = q.handle
        self.x = q.stimulus              # (T, b_req, fan_in) host array
        self.slots = slots
        self.g0 = g0                     # global join tick
        self.t_total = self.x.shape[0]

    @property
    def g_end(self) -> int:
        return self.g0 + self.t_total


class Lane:
    """One live continuous batch driving an engine's slot runners."""

    def __init__(self, engine, spec, bucket, surrogates, *,
                 metrics=None):
        self.engine = engine
        self.spec = spec
        self.bucket = bucket
        self.width = bucket.width
        self.chunk_ticks = bucket.chunk_ticks
        self.metrics = metrics
        # a strong reference: a server keys lanes by id(surrogates) for
        # directly passed artifacts, stable only while the object lives
        self.surrogates = surrogates
        # behavioral lanes are the graceful-degradation fallback: every
        # request they complete is flagged ``handle.degraded``
        self.degraded = engine.backend == "behavioral"
        # set by a watchdog (timer thread) when this lane's step overran
        # the hang limit: the step must not push records or count
        # completions — its requests were already failed
        self._poison = threading.Event()
        self.idle_rounds = 0             # rounds with no active requests
        self.programs = engine.slot_programs(self.width, self.chunk_ticks,
                                             surrogates)
        if metrics is not None and self.programs.compile_seconds:
            metrics.add(compile_seconds=self.programs.compile_seconds)
        self._banks = engine._runtime_banks(surrogates)
        self._carries = [engine._init_carry(i, self.width)
                         for i in range(spec.n_layers)]
        self._prev = [torch.zeros((self.width, l.n_out), dtype=torch.float32,
                                  device=engine.device)
                      for l in spec.layers]
        self._end_ks = np.zeros(self.width, np.float32)
        self._clocks = [c.clock_ns for c in engine.circs]
        self._last_lif = spec.circuits[-1] == "lif"
        self.g = 0                       # global tick at next chunk start
        self.free = list(range(self.width))
        self.active: list = []

    @property
    def free_width(self) -> int:
        return len(self.free)

    @property
    def occupancy(self) -> float:
        return 1.0 - len(self.free) / self.width

    def admit(self, q) -> bool:
        """Seat a queued request (any object with ``.handle`` and
        ``.stimulus``) at the NEXT chunk boundary; False if full."""
        b_req = q.stimulus.shape[1]
        if b_req > len(self.free):
            return False
        slots = [self.free.pop(0) for _ in range(b_req)]
        self.active.append(_Active(q, slots, self.g))
        q.handle.attempts += 1
        q.handle.degraded = self.degraded
        return True

    def step(self) -> dict:
        """Advance every seated request one chunk; returns step stats.

        One scheduling round: join-reset newly seated slots, advance the
        whole batch ``chunk_ticks`` ticks under the live mask, slice each
        tenant's rows out of the shared per-slot records, flush and free
        the slots of requests that ended inside this chunk."""
        if not self.active:
            return {}
        faults.check("lane.step")        # injected step failure
        faults.stall("chunk.stall")      # injected slow chunk (watchdog)
        if self._poison.is_set():        # the watchdog killed this lane
            return {}                    # while we were stuck above
        t0 = time.perf_counter()
        eng = self.engine
        tc, width = self.chunk_ticks, self.width
        g = self.g
        joiners = [a for a in self.active if a.g0 == g]
        if joiners:
            mask = np.zeros(width, bool)
            for a in joiners:
                mask[a.slots] = True
                self._end_ks[a.slots] = np.float32(a.g_end)
            g0 = torch.full((), float(g), dtype=torch.float32,
                            device=eng.device)
            self._carries, self._prev = self.programs.join(
                self._carries, self._prev,
                eng._upload(mask, dtype=torch.bool), g0)

        fan_in = self.spec.layers[0].fan_in
        x = np.zeros((tc, width, fan_in), np.float32)
        live_ticks = 0
        for a in self.active:
            rows = min(tc, a.g_end - g)
            lo = g - a.g0
            x[:rows, a.slots, :] = a.x[lo:lo + rows]
            live_ticks += rows * len(a.slots)

        outs = self.programs.step(
            eng._upload(x), float(g), eng._upload(self._end_ks),
            self._carries, self._prev, self._banks)
        primary, out_seq, hidden, e_tl, l_tl, ev_tl = outs[:6]
        self._carries, self._prev, self._banks = outs[6], outs[7], outs[8]
        # requests whose stimulus ends in this chunk: their trailing idle
        # energy is flushed from the new carries, enqueued before the one
        # fetch (a slot's flush reads only its own end time, so a leaver
        # quarantined below changes no other slot's value)
        leaving = [a for a in self.active if a.g_end <= g + tc]
        flush_dev = None
        if leaving:
            t_ends = np.zeros((self.spec.n_layers, width), np.float32)
            for a in leaving:
                for i, clock in enumerate(self._clocks):
                    t_ends[i, a.slots] = np.float32(a.g_end * clock)
            flush_dev = self.programs.flush(
                self._carries, eng._upload(t_ends), self._banks)
        (host,), event = eng._to_host([primary, out_seq, e_tl, l_tl, ev_tl,
                                       flush_dev, *hidden])
        if event is not None:
            event.synchronize()          # this chunk's copies
        primary, out_seq, e_tlb, l_tlb, ev_tlb, flushes, *hidden = [
            None if h is None else h.numpy() for h in host]
        if self._poison.is_set():
            # the watchdog failed this lane's requests mid-step: records
            # of a hung step are dead — push and count nothing
            return {}

        if faults.should_fire("surrogate.nan"):
            # host-side NaN burst into the fetched head outputs of ONE
            # deterministic victim; device carries stay clean, so what is
            # under test is the sentinel + quarantine + requeue path (a
            # replay from scratch is exact), not NaN laundering
            victim = self.active[int(faults.draw("surrogate.nan")
                                     * len(self.active))
                                 % len(self.active)]
            e_tlb = np.array(e_tlb)      # pinned host buffers: copy before
            l_tlb = np.array(l_tlb)      # writing
            e_tlb[:, :, victim.slots] = np.nan
            l_tlb[:, :, victim.slots] = np.inf
        quarantined = self._quarantine(primary, out_seq, e_tlb, l_tlb)

        leavers = [a for a in self.active if a.g_end <= g + tc]
        events = 0
        for a in self.active:
            rows = min(tc, a.g_end - g)
            flush = np.zeros((self.spec.n_layers,), np.float32)
            if a.g_end <= g + tc:
                flush = flushes[:, a.slots].sum(axis=1)
            rec = self._slice(a, rows, primary, out_seq, hidden,
                              e_tlb, l_tlb, ev_tlb, flush)
            events += int(rec.events.sum())
            a.handle._push(rec)

        for a in leavers:
            self.active.remove(a)
            self.free.extend(a.slots)
            self.free.sort()
            a.handle._finish()
        self.g = g + tc
        stats = {"live_ticks": live_ticks, "events": events,
                 "occupancy": live_ticks / (tc * width),
                 "completed": len(leavers),
                 "quarantined": quarantined,
                 "steady_seconds": time.perf_counter() - t0}
        if self.metrics is not None:
            self.metrics.add(chunks_total=1, ticks_live_total=live_ticks,
                             events_total=events,
                             occupancy_sum=stats["occupancy"],
                             steady_seconds=stats["steady_seconds"],
                             requests_completed=len(leavers),
                             requests_degraded=(len(leavers)
                                                if self.degraded else 0))
        return stats

    def _quarantine(self, primary, out_seq, e_tlb, l_tlb) -> list:
        """Evict requests whose OWN slot outputs went non-finite.

        The NaN/Inf sentinel on the fetched records attributes a burst per
        request over its disjoint slot set: only offending requests are
        unseated (slots freed, their end ticks zeroed so that the live
        mask goes dead next chunk) and returned for a server to requeue or
        fail — no record is pushed for them, and co-tenants' slices are
        untouched, so their merged records stay identical to a solo run.
        The whole-batch finiteness check is the fast path: on clean
        chunks it is one reduction per array, no per-request work."""
        arrs = [e_tlb, l_tlb, out_seq]
        if self._last_lif:
            arrs.append(primary)
        if all(np.isfinite(v).all() for v in arrs):
            return []
        quarantined: list = []
        for a in list(self.active):
            S = a.slots
            bad = (not np.isfinite(e_tlb[:, :, S]).all()
                   or not np.isfinite(l_tlb[:, :, S]).all()
                   or not np.isfinite(out_seq[:, S]).all()
                   or (self._last_lif
                       and not np.isfinite(primary[S]).all()))
            if not bad:
                continue
            self.active.remove(a)
            self.free.extend(S)
            self._end_ks[S] = np.float32(0.0)   # live mask: dead next chunk
            quarantined.append(a)
        self.free.sort()
        if quarantined and self.metrics is not None:
            self.metrics.add(numerical_faults=len(quarantined))
        return quarantined

    def _slice(self, a: _Active, rows: int, primary, out_seq, hidden,
               e_tlb, l_tlb, ev_tlb, flush) -> NetworkRun:
        """Cut one request's per-chunk record out of the shared batch.

        Slot sums / maxes over the request's own slots reproduce the solo
        record's whole-layer reductions: energy and events sum over
        disjoint circuit sets, latency is a max, and dead ticks and slots
        contribute exact zeros (the live mask froze them)."""
        S = a.slots
        spec = self.spec
        if self._last_lif:
            # per-chunk spike counts: ticks past the request's end emit no
            # spike under the live mask, so whole-chunk counts are exact;
            # merge sums the integer partials
            outputs = primary[S]
            out_spikes = out_seq[:rows][:, S]
        else:
            outputs = out_seq[rows - 1][S]
            out_spikes = None
        layer_spikes = None
        if self.engine.record_hidden:
            layer_spikes = [h[:rows][:, S] for h in hidden]
        return NetworkRun(
            backend=self.engine.backend, mode=self.engine.mode,
            outputs=outputs, out_spikes=out_spikes,
            layer_spikes=layer_spikes,
            energy=e_tlb[:rows][:, :, S].sum(axis=2),
            latency=l_tlb[:rows][:, :, S].max(axis=2),
            events=ev_tlb[:rows][:, :, S].sum(axis=2).astype(np.int64),
            flush_energy=flush,
            n_circuits=np.asarray([l.n_circuits(len(S))
                                   for l in spec.layers]),
            clock_ns=self.engine.clock_ns, wall_seconds=0.0,
            circuits=spec.circuits,
            compile_seconds=0.0)
