"""Server observability: counters behind the ``/stats`` report (port of
``repro.serve.metrics``).

One :class:`ServerMetrics` per server, updated by the scheduler under its
own lock (cheap increments; never holds up the device's work). ``snapshot()``
freezes the counters plus the derived rates — requests/s, events/s, mean
batch occupancy, compile vs steady seconds — into the plain dict the
serving layer reports.
"""

from __future__ import annotations

import threading
import time


class ServerMetrics:
    """Thread-safe counter block for one server instance."""

    def __init__(self):
        self._lock = threading.Lock()
        self.started_at = time.time()
        self.requests_submitted = 0
        self.requests_completed = 0
        self.requests_rejected = 0      # backpressure (ServerBusy)
        self.requests_failed = 0        # per-request errors after submit
        self.requests_retried = 0       # re-queued after a recoverable fault
        self.requests_deadline_exceeded = 0   # expired in queue (subset of
                                        # requests_failed: every expiry is
                                        # terminal)
        self.requests_degraded = 0      # completed on the behavioral
                                        # fallback (subset of completed)
        self.numerical_faults = 0       # NaN/Inf bursts quarantined
        self.lane_hangs = 0             # watchdog-detected hung lane steps
        self.lanes_retired = 0          # idle lanes freed (or poisoned)
        self.chunks_total = 0           # lane steps executed
        self.ticks_live_total = 0       # live slot-ticks simulated
        self.events_total = 0           # input events across all tenants
        self.compile_seconds = 0.0      # slot program + engine compiles
        self.steady_seconds = 0.0       # lane-step execute + fetch wall
        self.occupancy_sum = 0.0        # live-tick fraction per lane step
        self.wait_chunks_max = 0        # worst queue wait (chunk rounds)

    def add(self, **deltas):
        with self._lock:
            for name, d in deltas.items():
                setattr(self, name, getattr(self, name) + d)

    def note_wait(self, wait_chunks: int):
        with self._lock:
            self.wait_chunks_max = max(self.wait_chunks_max, wait_chunks)

    def snapshot(self, *, queue_depth_by_bucket=None, lanes=None) -> dict:
        """The ``/stats`` report (see docs/serving.md "Observability")."""
        with self._lock:
            wall = max(time.time() - self.started_at, 1e-9)
            chunks = max(self.chunks_total, 1)
            out = {
                "uptime_seconds": wall,
                "requests_submitted": self.requests_submitted,
                "requests_completed": self.requests_completed,
                "requests_rejected": self.requests_rejected,
                "requests_failed": self.requests_failed,
                "requests_retried": self.requests_retried,
                "requests_deadline_exceeded":
                    self.requests_deadline_exceeded,
                "requests_degraded": self.requests_degraded,
                # derived, never stored: every submitted request ends in
                # exactly one of completed/failed (retries are neither —
                # the request stays in flight), so this cannot go
                # negative while that accounting holds (tested in
                # tests/test_serve.py)
                "requests_in_flight": (self.requests_submitted
                                       - self.requests_completed
                                       - self.requests_failed),
                "requests_per_sec": self.requests_completed / wall,
                "numerical_faults": self.numerical_faults,
                "lane_hangs": self.lane_hangs,
                "lanes_retired": self.lanes_retired,
                "chunks_total": self.chunks_total,
                "ticks_live_total": self.ticks_live_total,
                "events_total": self.events_total,
                "events_per_sec": self.events_total / wall,
                "batch_occupancy": self.occupancy_sum / chunks,
                "compile_seconds": self.compile_seconds,
                "steady_seconds": self.steady_seconds,
                "wait_chunks_max": self.wait_chunks_max,
            }
        out["queue_depth_by_bucket"] = dict(queue_depth_by_bucket or {})
        out["lanes"] = list(lanes or [])
        return out
