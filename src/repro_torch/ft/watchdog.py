"""Step-time watchdog: straggler and hang detection (port of
``repro.ft.watchdog``; pure host code).

EWMA of step walltimes; a step exceeding ``threshold x ewma`` flags a
straggler (on a real cluster this triggers the controller to profile /
cordon the slow host; here it logs and counts). A hard ``hang_timeout``
arms a timer per step — if a step never completes, the registered callback
fires (the server fails the hung lane's requests; a launcher would
abort + restart from the last checkpoint).

Two hardening guarantees (tested in tests/test_torch_faults.py):

- all timing uses ``time.monotonic()`` — a wall-clock jump (NTP slew,
  manual reset) can neither false-fire ``on_hang`` nor corrupt the EWMA;
- ``on_hang`` can NEVER fire for a step that already completed: firing
  and completion race through one lock, and the timer callback re-checks
  the step generation + open flag under it before calling out
  (``Timer.cancel()`` alone cannot close that window — the timer thread
  may already be past its wait when cancel lands).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class StepWatchdog:
    def __init__(self, *, ewma_alpha: float = 0.2, threshold: float = 3.0,
                 hang_timeout: float = 600.0,
                 on_hang: Optional[Callable[[], None]] = None):
        self.ewma: Optional[float] = None
        self.alpha = ewma_alpha
        self.threshold = threshold
        self.hang_timeout = hang_timeout
        self.on_hang = on_hang
        self.stragglers = 0
        self.hangs = 0
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._timer: Optional[threading.Timer] = None
        self._t0: Optional[float] = None
        self._gen = 0                  # step generation the armed timer is for
        self._open = False             # a step is currently in flight

    def step_begin(self):
        with self._lock:
            self._t0 = time.monotonic()
            self._gen += 1
            self._open = True
            gen = self._gen
            if self.on_hang is not None:
                self._timer = threading.Timer(self.hang_timeout,
                                              self._fire, args=(gen,))
                self._timer.daemon = True
                self._timer.start()

    def _fire(self, gen: int):
        """Timer body: fire ``on_hang`` only if step ``gen`` is STILL
        open — checked under the lock, so a completion that won the race
        (even one that landed after ``Timer.cancel`` was too late)
        silences the hang for good."""
        with self._lock:
            if gen != self._gen or not self._open:
                return
            self.hangs += 1
            cb = self.on_hang
        if cb is not None:
            cb()                       # outside the lock: the callback may
                                       # grab its own locks (the server's)

    def step_end(self, step: int) -> dict:
        with self._lock:
            dt = time.monotonic() - self._t0
            self._open = False         # from here _fire(gen) is inert
            timer, self._timer = self._timer, None
            slow = self.ewma is not None and dt > self.threshold * self.ewma
            if slow:
                self.stragglers += 1
                self.events.append({"step": step, "seconds": dt,
                                    "ewma": self.ewma})
            self.ewma = dt if self.ewma is None else (
                self.alpha * dt + (1 - self.alpha) * self.ewma)
            ewma = self.ewma
        if timer is not None:
            timer.cancel()
        return {"step_seconds": dt, "straggler": slow, "ewma": ewma}
