"""The traced slice: ``torch.profiler`` over a few whole calls or chunks,
reduced to aggregates (no trace file is written).

Device busy time is the union of the device operations' intervals inside
the slice (merged, not summed, so that overlapping streams count once);
the idle gaps between them are named by the benchmark's host span the
host was in at the gap's middle.
"""

from __future__ import annotations

import dataclasses

# the port's hand-written kernels, by the names of their __global__
# functions (csrc/*.cu)
PORT_KERNELS = ("network_tick_tiled", "network_tick_chunk_tiled",
                "mlp_heads_tiled", "mlp_single", "crossbar_kernel",
                "lif_step_kernel", "lif_chunk_kernel", "flash_attn")


@dataclasses.dataclass
class Trace:
    window_s: float              # the slice, first enqueue to last sync
    busy_s: float                # union of device intervals in it
    ops: list                    # (name, seconds, start_s, end_s) a device op
    gaps: list                   # (span name, seconds) idle gaps, longest first

    def seconds(self, pred) -> float:
        return sum(o[1] for o in self.ops if pred(o[0]))

    def count(self, pred) -> int:
        return sum(1 for o in self.ops if pred(o[0]))


def is_port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy")


def is_dtoh(name: str) -> bool:
    return name.startswith("Memcpy DtoH")


class Slice:
    """A profiler the workload starts and stops around its slice."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.marker = None

    def _sync(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    def start(self):
        from torch.profiler import record_function
        self._sync()
        self.prof.start()
        self.marker = record_function("bench.slice")
        self.marker.__enter__()

    def stop(self):
        self._sync()
        self.marker.__exit__(None, None, None)
        self.prof.stop()

    def reduce(self) -> Trace:
        from torch.autograd import DeviceType
        events = self.prof.events()
        host = [e for e in events if e.device_type != DeviceType.CUDA]
        win = [e for e in host if e.name == "bench.slice"]
        if not win:
            raise RuntimeError("the profiler recorded no bench.slice range")
        w0, w1 = win[0].time_range.start, win[0].time_range.end
        ops = []
        for e in events:
            # the host ranges are mirrored on the device's timeline as
            # annotations: no device operation
            if e.device_type != DeviceType.CUDA or e.name.startswith("bench."):
                continue
            a = max(e.time_range.start, w0)
            b = min(e.time_range.end, w1)
            if b > a:
                ops.append((e.name, (b - a) / 1e6, a, b))
        ops.sort(key=lambda o: o[2])
        merged = []
        for _, _, a, b in ops:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy = sum(b - a for a, b in merged) / 1e6
        spans = [(e.name[len("bench."):], e.time_range.start,
                  e.time_range.end) for e in host
                 if e.name.startswith("bench.") and e.name != "bench.slice"]
        edges = [w0] + [x for ab in merged for x in ab] + [w1]
        gaps = []
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                mid = (a + b) / 2
                inside = [s for s in spans if s[1] <= mid <= s[2]]
                gaps.append((f"host:{inside[-1][0]}" if inside
                             else "host:harness", (b - a) / 1e6))
        gaps.sort(key=lambda g: -g[1])
        return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy,
                     ops=[(n, s, a / 1e6, b / 1e6) for n, s, a, b in ops],
                     gaps=gaps)


def top_ops(trace: Trace, k: int = 10) -> list:
    """The ``k`` device operations that took the most time, by name."""
    tot = {}
    for name, s, _, _ in trace.ops:
        tot[name] = tot.get(name, 0.0) + s
    return [[n[:120], s] for n, s in
            sorted(tot.items(), key=lambda kv: -kv[1])[:k]]
