"""Traffic kind ``stream``: one live consumer of ``lasana.stream`` over an
unbounded horizon, taking each chunk's record as it is yielded and
dropping it.

Parameters (the cell's traffic file): ``batch`` digits watched,
``chunk_ticks`` ticks a chunk, ``pool_blocks`` device-resident blocks of
one chunk each that the stimulus cycles through (Poisson spikes of the
same digits, drawn from the seed), ``check_chunks`` leading chunks of the
window that the reference follows from the stream's start, and
``profile_chunks`` = [first, end) the chunks in the traced slice (inside
the checked ones, past the pipeline's start).
"""

from __future__ import annotations

import time

import numpy as np


class CyclicBlocks:
    """A (horizon, B, fan_in) stimulus whose chunk-aligned slices are the
    pool's blocks in turn; what ``lasana.stream`` slices as an array."""

    def __init__(self, pool, horizon_chunks: int):
        self.pool = pool
        self.tc = pool[0].shape[0]
        self.shape = (self.tc * horizon_chunks, *pool[0].shape[1:])
        self.ndim = 3

    def __getitem__(self, sl):
        start = sl.start or 0
        if start == 0 and sl.stop is None:
            return self
        if start % self.tc or sl.stop - start != self.tc:
            raise IndexError("CyclicBlocks is sliced a whole chunk at a time")
        return self.pool[(start // self.tc) % len(self.pool)]


class Workload:
    HORIZON_CHUNKS = 1 << 16

    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.traffic
        self.net = ctx.net
        self.chunks = []         # the checked chunks (their records)

    def setup(self, warm: bool = True):
        import repro_torch.lasana as lasana
        ctx, tr = self.ctx, self.tr
        self.lasana = lasana
        t0 = time.perf_counter()
        self.spec, self.sur = self.net.program(
            ctx.cfg, ctx.surrogate_path, ctx.device)
        t1 = time.perf_counter()
        imgs = self.net.images(ctx.cfg, tr["batch"], ctx.gen)
        self.pool = [self.net.encode(ctx.cfg, imgs, tr["chunk_ticks"],
                                     ctx.gen)
                     for _ in range(tr["pool_blocks"])]
        self.pool[-1].sum().item()            # made, not only enqueued
        t2 = time.perf_counter()
        if warm:
            # a short stream builds the chunk runner and its kernels
            gen = self._open()
            for _ in range(3):
                next(gen)
            gen.close()
        self.setup_parts = {"program_s": t1 - t0, "stimulus_s": t2 - t1,
                            "warm_s": time.perf_counter() - t2}

    def _open(self):
        return self.lasana.stream(
            self.spec, CyclicBlocks(self.pool, self.HORIZON_CHUNKS),
            chunk_ticks=self.tr["chunk_ticks"], surrogates=self.sur,
            device=self.ctx.device)

    def _take(self, gen, i: int) -> dict:
        t0 = time.perf_counter()
        with self.ctx.spans("next"):
            chunk = next(gen)
        t1 = time.perf_counter()
        if i < self.tr["check_chunks"]:
            self.chunks.append(chunk)
        return {"t0": t0, "t1": t1, "events": int(chunk.events.sum()),
                "ticks": int(chunk.energy.shape[0])}

    def window(self, seconds: float) -> list:
        """Chunks from the stream's first ``next()`` until one arrives past
        ``seconds`` (and at least the checked chunks)."""
        gen = self._open()
        units = []
        start = time.perf_counter()
        while (len(units) < self.tr["check_chunks"]
               or units[-1]["t1"] - start < seconds):
            units.append(self._take(gen, len(units)))
        gen.close()
        return units

    def traced(self, profiler) -> list:
        first, end = self.tr["profile_chunks"]
        gen = self._open()
        units = []
        for i in range(max(end, self.tr["check_chunks"])):
            if i == first:
                profiler.start()
            units.append(self._take(gen, i))
            if i == end - 1:
                profiler.stop()
        gen.close()
        return units[first:end]

    def release(self):
        self.spec = self.sur = None

    def reference_run(self, precision: str = "fp32") -> tuple:
        """``(records a chunk, rows)``: the reference following the stream
        from its start over the checked chunks, and its (changed, stale,
        output changed) rows of those ticks, (T, L, 3)."""
        ctx = self.ctx
        ref = self.net.reference(ctx.cfg, ctx.surrogate_path, ctx.device,
                                 precision)
        ref.start(self.tr["batch"])
        recs, rows = [], []
        for i in range(self.tr["check_chunks"]):
            block = self.pool[i % len(self.pool)]
            want = self.net.reference_records(ref, block, start=False,
                                              flush=False, hidden=False)
            recs.append(want)
            rows.append(np.stack([want["changed"], want["stale"],
                                  want["out_changed"]], axis=-1))
        return recs, np.concatenate(rows)

    def check(self) -> tuple:
        """``(gaps a chunk, rows)``: the checked chunks against the
        reference, chunk by chunk across the boundaries."""
        recs, rows = self.reference_run()
        got = []
        for chunk in self.chunks:
            rec = self.net.program_records(chunk, True)
            rec.pop("flush")
            got.append(rec)
        return self.compare(got, recs), rows

    def compare(self, got: list, want: list) -> list:
        """Each chunk's gaps; ``counts`` is taken over the output spike
        counts accumulated across the checked chunks, as a live monitor
        holds them (a spike that a rounding flip moves over a chunk
        boundary then counts once), and sits with the last chunk."""
        per = []
        for g, w in zip(got, want):
            gaps = self.net.gaps(g, w)
            gaps.pop("counts")
            per.append(gaps)
        total = lambda recs: sum(np.asarray(r["counts"], np.int64)
                                 for r in recs)
        per[-1]["counts"] = float(np.abs(total(got) - total(want)).max())
        return per

    def slice_rows(self, rows):
        """The traced slice's rows: its chunks' ticks."""
        first, end = self.tr["profile_chunks"]
        tc = self.tr["chunk_ticks"]
        return rows[first * tc:end * tc]
