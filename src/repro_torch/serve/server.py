"""The persistent multi-tenant simulation server (LASANA-as-a-service;
port of ``repro.serve.server``).

:class:`SimServer` glues the serving subsystem together around one
driver thread that owns all work on the device (``ServeConfig.device``,
``cuda`` unless the caller asks for another):

  * an :class:`~repro_torch.serve.store.ArtifactStore` of named, versioned
    surrogates (register/hot-swap; in-flight requests keep the version
    they resolved at submit);
  * a canonical-spec table + the facade's bounded per-spec engine cache:
    content-equal :class:`NetworkSpec`s from different clients collapse
    onto ONE engine and its runner cache, so the number of built slot
    runners is bounded by the number of shape buckets — not by request
    count, tenant count, or surrogate versions;
  * a :class:`~repro_torch.serve.buckets.BucketPolicy` quantizing request
    shapes, and one :class:`~repro_torch.serve.scheduler.Lane` per (bucket,
    surrogate version, mode) continuously batching its requests;
  * admission control: a bounded submit queue (``ServerBusy``
    backpressure), a global in-flight cap, and round-robin per-tenant
    fairness so one chatty tenant cannot starve another's queue;
  * fault isolation + bounded device memory: a request the engine
    rejects at lane creation (or whose ``on_chunk`` callback raises)
    fails ITS OWN handle while the driver keeps serving everyone else,
    and lanes idle for ``lane_idle_rounds`` rounds are retired — device
    state is pinned by live work, not by every (bucket, surrogate
    version, mode) the server ever saw;
  * :class:`~repro_torch.serve.metrics.ServerMetrics` behind :meth:`stats`.

Threading contract: ``submit``/``register_*``/``stats`` are safe from any
thread and touch no device memory (``submit`` keeps the stimulus on the
host); simulation itself — every kernel launch and device copy — happens
on the driver thread (``start()``) or under the caller of
``run_until_idle()``, never both at once. Lane construction builds the
slot runners and loads the kernel libraries their routes launch, outside
the server lock and outside the watchdog's window, so a lane's first step
builds nothing.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Optional

import numpy as np

from repro_torch.core.network import MODES, NetworkSpec
from repro_torch.ft.watchdog import StepWatchdog
from repro_torch.kernels import ops
from repro_torch.serve.buckets import BucketPolicy, spec_content_key
from repro_torch.serve.metrics import ServerMetrics
from repro_torch.serve.scheduler import Lane, RequestHandle
from repro_torch.serve.store import ArtifactStore


class ServerBusy(RuntimeError):
    """Backpressure: the submit queue is at capacity — retry later."""


class DeadlineExceeded(RuntimeError):
    """The request's ``deadline_ms`` expired before it could be seated.

    Raised from ``handle.result()``. Expiry is checked at admission (and
    re-checked on every retry requeue), so an expired request fails fast
    in the queue — it never occupies a lane slot, and never displaces
    work that can still meet its own deadline."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Server shape/capacity knobs (see docs/serving.md).

    device          where lanes run and path-registered artifacts load
                    (default ``cuda``; ``"cpu"`` runs the plain versions);
                    the server's constructor raises when it names a CUDA
                    device and there is none

    slot_widths     batch-width ladder of the bucket policy
    chunk_ticks     continuous-batching quantum (join/leave granularity)
    max_in_flight   seated (admitted, unfinished) request cap
    max_queue       submit-queue cap beyond which submit raises
                    :class:`ServerBusy`
    record_hidden   keep per-layer spike traces in request records
                    (parity tests); default off — serving unbounded
                    streams of hidden traces defeats bounded memory
    poll_seconds    driver-thread sleep when idle
    lane_idle_rounds  scheduling rounds a lane may sit with no active
                    requests before it is retired, freeing its
                    device-resident carries and surrogate banks (the
                    runners stay cached on the engine, so a later
                    request for the same key re-creates the lane with
                    zero builds) — without retirement every (bucket,
                    surrogate version, mode) ever served would pin device
                    memory forever

    Resilience knobs (see docs/resilience.md):

    default_deadline_ms  per-request deadline when ``submit`` gives none;
                    None = requests wait in queue indefinitely
    max_retries     default re-admission budget after a recoverable fault
                    (lane-step failure, NaN/Inf quarantine); a retried
                    request replays from scratch so its merged record is
                    exact. 0 = any fault is terminal for the request
    retry_backoff_ms  delay before a faulted request may be re-admitted,
                    doubled per attempt (the queue is never slept on —
                    the request is simply skipped until its time)
    degrade_after   surrogate faults on one spec before NEW admissions of
                    that spec fall back to the behavioral backend
                    (``handle.degraded`` + ``/stats`` flag them); None
                    disables degradation
    hang_timeout_s  watchdog limit on one lane step; a step exceeding it
                    fails the lane's requests and drops the lane while
                    the server keeps serving. None disables the watchdog
    """

    slot_widths: tuple = (4,)
    chunk_ticks: int = 16
    max_in_flight: int = 32
    max_queue: int = 256
    record_hidden: bool = False
    poll_seconds: float = 0.01
    lane_idle_rounds: int = 50
    default_deadline_ms: Optional[float] = None
    max_retries: int = 0
    retry_backoff_ms: float = 10.0
    degrade_after: Optional[int] = 3
    hang_timeout_s: Optional[float] = None
    device: Optional[str] = None


class _Queued:
    """A submitted-but-not-yet-seated request."""

    def __init__(self, handle, spec_key, spec, stimulus, surrogates,
                 sur_token, mode, *, deadline=None, retries_left=0,
                 backoff_s=0.0):
        self.handle = handle
        self.spec_key = spec_key
        self.spec = spec
        self.stimulus = stimulus
        self.surrogates = surrogates
        self.sur_token = sur_token      # lane-identity of the artifact
        self.mode = mode
        self.deadline = deadline        # monotonic seconds, or None
        self.retries_left = retries_left
        self.backoff_s = backoff_s      # next retry delay (doubles)
        self.not_before = 0.0           # monotonic gate after a requeue


class SimServer:
    """Persistent simulation server over the slot-program engine layer."""

    def __init__(self, config: Optional[ServeConfig] = None):
        self.config = config or ServeConfig()
        # raises here, on the caller's thread, when the device is CUDA
        # and there is no card: never later inside the driver thread
        ops.resolve_device(self.config.device)
        self.policy = BucketPolicy(slot_widths=self.config.slot_widths,
                                   chunk_ticks=self.config.chunk_ticks)
        self.store = ArtifactStore()
        self.metrics = ServerMetrics()
        self._lock = threading.Lock()          # queues + tables
        self._wake = threading.Condition(self._lock)
        self._queues: dict = collections.OrderedDict()  # tenant -> deque
        self._specs: dict = {}                 # spec_key -> canonical spec
        self._spec_names: dict = {}            # name -> canonical spec
        self._lanes: dict = {}                 # lane key -> Lane
        self._in_flight = 0                    # seated, unfinished
        self._next_id = 0
        self._fault_counts: dict = {}          # spec_key -> surrogate faults
        self._degraded: set = set()            # spec_keys on the fallback
        self._hung: set = set()                # lane keys killed by watchdog
        self._stepping_lane = None             # lane key inside lane.step()
        self._step_count = 0                   # watchdog step generation
        self._watchdog = None
        if self.config.hang_timeout_s is not None:
            self._watchdog = StepWatchdog(
                hang_timeout=self.config.hang_timeout_s,
                on_hang=self._on_hang)
        self._thread = None
        self._stop = threading.Event()
        self._closed = False

    # --- registration ---------------------------------------------------------

    def register_surrogate(self, name: str, surrogate, *,
                           version=None) -> int:
        """Store a surrogate under ``name``; returns its new version."""
        return self.store.register(name, surrogate, version=version)

    def register_surrogate_path(self, name: str, path: str, *,
                                version=None) -> int:
        """Register an on-disk artifact lazily; returns its new version.

        The file is read on first resolve, not here — a truncated or
        corrupt artifact fails only the request that forced the load
        (with :class:`~repro_torch.serve.store.ArtifactError`), never the
        registration or the server."""
        return self.store.register_path(name, path, version=version)

    def register_spec(self, name: str, spec: NetworkSpec) -> str:
        """Name a spec for by-reference submission (wire protocol)."""
        with self._lock:
            self._spec_names[name] = self._canonical(spec)
        return spec_content_key(spec)

    def _canonical(self, spec: NetworkSpec):
        """Collapse content-equal specs onto one engine-owning object."""
        key = spec_content_key(spec)
        return self._specs.setdefault(key, spec)

    def spec(self, name: str):
        """The :meth:`register_spec`-registered spec, or None.

        The server-side registry outlives wire connections: a client that
        reconnects can keep submitting against names registered earlier."""
        with self._lock:
            return self._spec_names.get(name)

    # --- submission -----------------------------------------------------------

    def submit(self, spec, stimulus, *, surrogates, tenant: str = "default",
               mode: str = "standalone", on_chunk=None,
               deadline_ms: Optional[float] = None,
               max_retries: Optional[int] = None) -> RequestHandle:
        """Queue one simulation request; returns its handle immediately.

        spec        a :class:`NetworkSpec` or the name of a
                    :meth:`register_spec`-registered one
        stimulus    (T, B, fan_in) drive in the first layer's native
                    units ((B, fan_in) promotes to one tick)
        surrogates  a store ref (``"name"`` = latest, ``"name@ver"`` =
                    pinned) or a direct surrogate object
        tenant      fairness domain: queued requests are admitted
                    round-robin across tenants, FIFO per lane within
                    one (a full lane never blocks queued requests
                    bound for other lanes)
        on_chunk    optional callback fired (from the driver thread) per
                    streamed chunk record
        deadline_ms admission deadline: if the request is still queued
                    when it expires, it fails fast with
                    :class:`DeadlineExceeded` and never takes a slot
                    (default: ``config.default_deadline_ms``)
        max_retries re-admissions allowed after a recoverable fault; a
                    retried request replays from scratch, so its merged
                    record is exact (default: ``config.max_retries``)

        Raises :class:`ServerBusy` when the queue is full (backpressure)
        and ``ValueError`` for malformed requests — both synchronously,
        never parked on the queue."""
        if self._closed:
            raise RuntimeError("server is closed")
        if isinstance(spec, str):
            with self._lock:
                got = self._spec_names.get(spec)
            if got is None:
                raise KeyError(f"no spec registered under {spec!r}")
            spec = got
        x = np.asarray(stimulus, np.float32)
        if x.ndim == 2:
            x = x[None]
        if x.ndim != 3:
            raise ValueError(f"stimulus must be (T, B, n_in) or (B, n_in), "
                             f"got shape {tuple(x.shape)}")
        if x.shape[-1] != spec.layers[0].fan_in:
            raise ValueError(f"input width {x.shape[-1]} != layer-0 "
                             f"fan_in {spec.layers[0].fan_in}")
        if mode not in MODES:                  # engine() would reject it on
            raise ValueError(                  # the driver thread otherwise
                f"mode must be one of {MODES}: {mode}")
        self.policy.width_for(x.shape[1])      # reject oversize batches now
        if isinstance(surrogates, str):
            ref, sur = self.store.resolve(surrogates,
                                          device=self.config.device)
            sur_token = ref                     # (name, version)
        else:
            sur, sur_token = surrogates, ("<direct>", id(surrogates))
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be positive: {deadline_ms}")
        deadline = (None if deadline_ms is None
                    else time.monotonic() + deadline_ms / 1000.0)
        if max_retries is None:
            max_retries = self.config.max_retries

        with self._lock:
            depth = sum(len(q) for q in self._queues.values())
            if depth >= self.config.max_queue:
                self.metrics.add(requests_rejected=1)
                raise ServerBusy(
                    f"submit queue full ({depth}/{self.config.max_queue})")
            self._next_id += 1
            handle = RequestHandle(self._next_id, tenant,
                                   on_chunk=on_chunk)
            handle.surrogate_ref = sur_token
            spec_c = self._canonical(spec)
            self._queues.setdefault(tenant, collections.deque()).append(
                _Queued(handle, spec_content_key(spec_c), spec_c, x, sur,
                        sur_token, mode, deadline=deadline,
                        retries_left=int(max_retries),
                        backoff_s=self.config.retry_backoff_ms / 1000.0))
            self.metrics.add(requests_submitted=1)
            self._wake.notify_all()
        return handle

    # --- scheduling -----------------------------------------------------------

    def _lane_for(self, q: _Queued) -> Lane:
        """The (existing or new) lane serving one queued request.

        Engine resolution and lane construction — which build the slot
        runners and load the kernel libraries the lane's routes launch,
        for seconds on first touch — run WITHOUT the server lock, so
        submitters and stats readers never stall behind a build; only
        the lane-table lookups take the lock. The lane keeps a strong
        reference to the surrogate object (``Lane.surrogates``), so a
        directly-passed surrogate's ``id()`` — part of the lane key —
        cannot be recycled onto a different object while the key is
        live; retirement drops the key and the reference together."""
        import repro_torch.lasana as lasana
        bucket = self.policy.bucket_for(q.spec_key, q.stimulus.shape[1])
        with self._lock:
            # graceful degradation: once a spec has burned through its
            # surrogate-fault budget, NEW admissions go to a behavioral-
            # backend lane (annotation substrate, no surrogate) — the
            # flag is part of the lane key so degraded and healthy lanes
            # never share carries or programs
            degraded = q.spec_key in self._degraded
        key = (bucket.key, q.sur_token, q.mode, degraded)
        with self._lock:
            lane = self._lanes.get(key)
        if lane is None:
            if degraded:
                eng = lasana.engine(
                    q.spec, backend="behavioral", mode=q.mode,
                    record_hidden=self.config.record_hidden,
                    device=self.config.device)
                lane = Lane(eng, q.spec, bucket, None,
                            metrics=self.metrics)
            else:
                eng = lasana.engine(
                    q.spec, mode=q.mode,
                    record_hidden=self.config.record_hidden,
                    device=self.config.device)
                lane = Lane(eng, q.spec, bucket, q.surrogates,
                            metrics=self.metrics)
            lane.sur_token = q.sur_token
            with self._lock:
                lane = self._lanes.setdefault(key, lane)
        return lane

    def _admit(self) -> bool:
        """One round-robin admission sweep across tenant queues.

        A request whose lane is full does NOT block the requests queued
        behind it that target OTHER lanes (classic head-of-line blocking
        would cap occupancy across a mixed-bucket workload); once a lane
        rejects, later same-tenant requests for that lane are skipped
        too, so per-lane FIFO order within a tenant is preserved.

        A request whose LANE CREATION fails (e.g. a directly-passed
        surrogate the engine rejects — submit cannot validate those
        cheaply) fails ITS OWN handle and the sweep continues: one bad
        request must never kill the driver thread or other tenants'
        work. The lock is dropped around :meth:`_lane_for` (first-touch
        builds run unlocked; admission itself is driver-thread-only,
        other threads only append to queues)."""
        admitted = False
        with self._lock:
            tenants = list(self._queues)
        for tenant in tenants:
            blocked: set = set()           # lanes that rejected this sweep
            skipped: list = []
            while True:
                with self._lock:
                    queue = self._queues.get(tenant)
                    if (not queue
                            or self._in_flight >= self.config.max_in_flight):
                        break
                    q = queue.popleft()
                now = time.monotonic()
                if q.deadline is not None and now > q.deadline:
                    # fail fast IN the queue: an expired request never
                    # takes a slot from work that can still make it
                    self.metrics.add(requests_failed=1,
                                     requests_deadline_exceeded=1)
                    q.handle._fail(DeadlineExceeded(
                        f"request {q.handle.id} missed its deadline "
                        f"after {q.handle.wait_chunks} queued rounds"))
                    continue
                if q.not_before > now:
                    skipped.append(q)      # retry backoff: not yet — the
                    continue               # sweep never sleeps on it
                try:
                    lane = self._lane_for(q)
                except Exception as err:   # per-request failure, contained
                    self.metrics.add(requests_failed=1)
                    q.handle._fail(err)
                    continue
                if id(lane) in blocked or not lane.admit(q):
                    blocked.add(id(lane))
                    skipped.append(q)
                    continue
                lane.idle_rounds = 0
                with self._lock:
                    self._in_flight += 1
                admitted = True
            with self._lock:
                if skipped:
                    queue = self._queues.setdefault(tenant,
                                                    collections.deque())
                    queue.extendleft(reversed(skipped))
                elif not self._queues.get(tenant):
                    self._queues.pop(tenant, None)
        with self._lock:
            # rotate start tenant so admission order is fair over rounds
            if self._queues:
                first = next(iter(self._queues))
                self._queues.move_to_end(first)
                for q in [r for dq in self._queues.values() for r in dq]:
                    q.handle.wait_chunks += 1
                    self.metrics.note_wait(q.handle.wait_chunks)
        return admitted

    def _requeue(self, q: _Queued, error: Exception) -> bool:
        """Give a faulted request another attempt, if budget remains.

        Clears the handle's partial chunks (a retry replays the request
        from scratch, so the merged record stays exact), arms the
        exponential backoff gate, and puts the request back at the FRONT
        of its tenant's queue — bypassing ``max_queue``, which governs
        NEW work, not work the server already accepted. With the retry
        budget exhausted the handle fails with ``error``; returns whether
        the request was requeued."""
        if q.retries_left <= 0:
            self.metrics.add(requests_failed=1)
            q.handle._fail(error)
            return False
        q.retries_left -= 1
        q.handle._reset_for_retry()
        q.not_before = time.monotonic() + q.backoff_s
        q.backoff_s *= 2.0
        with self._lock:
            self._queues.setdefault(q.handle.tenant,
                                    collections.deque()).appendleft(q)
        self.metrics.add(requests_retried=1)
        return True

    def _note_fault(self, spec_key: str):
        """Count one surrogate fault against a spec; trip degradation.

        At ``degrade_after`` faults the spec key joins ``_degraded``:
        from then on NEW admissions of that spec build behavioral-backend
        lanes (see :meth:`_lane_for`) — results stay available, flagged
        ``degraded`` on handles and in ``/stats``."""
        after = self.config.degrade_after
        with self._lock:
            n = self._fault_counts.get(spec_key, 0) + 1
            self._fault_counts[spec_key] = n
            if after is not None and n >= after:
                self._degraded.add(spec_key)

    def _on_hang(self):
        """Watchdog callback (timer thread): a lane step blew past
        ``hang_timeout_s``. Fail the hung lane's requests and drop the
        lane NOW so their waiters unblock; the driver thread — still
        stuck inside ``lane.step`` — finds the key in ``_hung`` when
        (if) the step finally returns and discards its results."""
        key = self._stepping_lane       # driver-write field; a racy read
        if key is None:                 # at worst misses one borderline
            return                      # hang, never fingers a wrong lane
        with self._lock:
            lane = self._lanes.pop(key, None)
            if lane is None:
                return
            self._hung.add(key)
            actives = list(lane.active)
            self._in_flight -= len(actives)
            self._wake.notify_all()
        # poison before failing handles: if the stuck step eventually
        # limps home it must push no records and count no completions
        # (the requests below are already failed)
        lane._poison.set()
        self.metrics.add(lane_hangs=1, requests_failed=len(actives))
        for a in actives:
            a.handle._fail(RuntimeError(
                f"request {a.handle.id} failed by the watchdog: lane "
                f"step exceeded hang_timeout_s="
                f"{self.config.hang_timeout_s}"))

    def step(self) -> bool:
        """One scheduling round: admit, advance live lanes, retire idle.

        Returns True when any work happened — the driver loop (or an
        external caller in un-threaded mode) idles when it returns
        False. A lane whose step fails mid-chunk has corrupted carries
        for everyone seated in it: its requests are requeued for a fresh
        attempt (or failed once out of retries) and the lane is dropped,
        but OTHER lanes (and the driver) keep serving. Requests the
        NaN/Inf sentinel quarantined follow the same retry path, and
        count toward their spec's degradation budget. A lane idle for
        ``lane_idle_rounds`` consecutive rounds is retired, releasing
        its device-resident carries and banks; the engine's runners
        survive, so re-creation builds nothing."""
        worked = self._admit()
        with self._lock:
            lanes = list(self._lanes.items())
        retired: list = []
        for key, lane in lanes:
            if not lane.active:
                lane.idle_rounds += 1
                if lane.idle_rounds >= self.config.lane_idle_rounds:
                    retired.append(key)
                continue
            lane.idle_rounds = 0
            hung = False
            try:
                try:
                    if self._watchdog is not None:
                        self._stepping_lane = key
                        self._watchdog.step_begin()
                    stats = lane.step()
                finally:
                    if self._watchdog is not None:
                        self._step_count += 1
                        self._watchdog.step_end(self._step_count)
                        self._stepping_lane = None
                    with self._lock:
                        hung = key in self._hung
                        self._hung.discard(key)
            except Exception as err:       # lane poisoned, server survives
                if hung:                   # watchdog already failed these
                    worked = True          # requests and dropped the lane
                    continue
                actives = list(lane.active)
                with self._lock:
                    self._in_flight -= len(actives)
                    self._lanes.pop(key, None)
                    self._wake.notify_all()
                for a in actives:
                    self._requeue(a.q, err)
                continue
            if hung:
                worked = True              # results of a hung step are
                continue                   # dead: requests already failed
            if stats:
                worked = True
                with self._lock:
                    self._in_flight -= (stats["completed"]
                                        + len(stats["quarantined"]))
                    if stats["completed"]:
                        self._wake.notify_all()
                for a in stats["quarantined"]:
                    self._note_fault(a.q.spec_key)
                    self._requeue(a.q, RuntimeError(
                        f"request {a.handle.id}: non-finite surrogate "
                        "outputs (NaN/Inf burst) quarantined by the "
                        "lane sentinel"))
        if retired:
            with self._lock:
                for key in retired:
                    if self._lanes.pop(key, None) is not None:
                        self.metrics.add(lanes_retired=1)
        return worked

    def run_until_idle(self, *, max_rounds: int = 100000) -> None:
        """Drive scheduling on the CALLING thread until no work remains."""
        if self._thread is not None:
            raise RuntimeError("driver thread is running; use handles "
                               "or stats() instead")
        for _ in range(max_rounds):
            if not self.step():
                with self._lock:
                    if not self._queues and self._in_flight == 0:
                        return
        raise RuntimeError(f"not idle after {max_rounds} rounds")

    # --- lifecycle ------------------------------------------------------------

    def start(self) -> "SimServer":
        """Spawn the driver thread (idempotent); returns self."""
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._drive,
                                            name="lasana-serve",
                                            daemon=True)
            self._thread.start()
        return self

    def _drive(self):
        while not self._stop.is_set():
            try:
                worked = self.step()
            except Exception as err:        # fail loudly per request
                self._fail_all(err)
                raise
            if not worked:
                # also parks when queued work is only backoff-gated
                # retries: submissions and completions notify _wake, so
                # the wait never delays genuinely admissible work
                with self._wake:
                    self._wake.wait(self.config.poll_seconds)

    def _fail_all(self, err: Exception):
        with self._lock:
            for queue in self._queues.values():
                for q in queue:
                    q.handle._fail(err)
            self._queues.clear()
            for lane in self._lanes.values():
                for a in list(lane.active):
                    a.handle._fail(err)

    def close(self, *, drain: bool = True, timeout: float = 60.0):
        """Stop the driver thread; ``drain`` finishes in-flight work."""
        if drain and self._thread is not None:
            import time as _time
            deadline = _time.time() + timeout
            while _time.time() < deadline and self._thread.is_alive():
                with self._lock:
                    if not self._queues and self._in_flight == 0:
                        break
                _time.sleep(0.005)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        self._closed = True

    def __enter__(self) -> "SimServer":
        return self

    def __exit__(self, *exc):
        self.close(drain=exc[0] is None)

    # --- observability --------------------------------------------------------

    def compile_count(self) -> int:
        """Tick-loop runners built across the live lanes' engines."""
        with self._lock:
            engines = {id(l.engine): l.engine for l in self._lanes.values()}
        return sum(e.compile_count for e in engines.values())

    def stats(self) -> dict:
        """The ``/stats`` report: counters, rates, queues, lanes."""
        with self._lock:
            by_bucket: dict = {}
            for queue in self._queues.values():
                for q in queue:
                    b = self.policy.bucket_for(q.spec_key,
                                               q.stimulus.shape[1])
                    name = f"{b.spec_key[:8]}/w{b.width}/c{b.chunk_ticks}"
                    by_bucket[name] = by_bucket.get(name, 0) + 1
            lanes = [{
                "bucket": f"{l.bucket.spec_key[:8]}/w{l.width}"
                          f"/c{l.chunk_ticks}",
                "surrogate": str(getattr(l, "sur_token", key[1])),
                "occupancy": l.occupancy,
                "active_requests": len(l.active),
                "global_tick": l.g,
                "degraded": l.degraded,
            } for key, l in self._lanes.items()]
            degraded_specs = sorted(self._degraded)
        out = self.metrics.snapshot(queue_depth_by_bucket=by_bucket,
                                    lanes=lanes)
        out["degraded_specs"] = degraded_specs
        out["compile_count"] = self.compile_count()
        out["n_lanes"] = len(lanes)
        out["surrogates"] = {n: self.store.versions(n)
                             for n in self.store.names()}
        return out
