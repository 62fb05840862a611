"""The benchmark's plumbing: the manifest and its checks, finding a cell's
configuration, traffic and metric readers by name, host spans, and the
result line.

Everything a configuration, a traffic mix or a per-layer metric owns is a
file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``kind``
names ``traffic/<kind>.py``), the configuration's ``network`` naming
``networks/<network>.py``, and ``metrics/<metric>.py`` with a
``read(ctx)`` that returns a number or None.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import pathlib
import re
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
E2E_SOURCES = ("device_trace", "host_clock")
# top-level modules no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class ManifestError(ValueError):
    pass


def load_manifest(path=None) -> dict:
    path = pathlib.Path(path) if path else ROOT / "BENCHMARK.json"
    with open(path) as f:
        return json.load(f)


def _text(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def check_manifest(m: dict, bench=BENCH) -> list:
    """Problems with a manifest, as readable lines (empty when sound):
    names and units from the allowed characters, every cell on one chip,
    its configuration, traffic file and every metric's reader present,
    and every per-layer metric's ``moves`` reported wherever it is."""
    bad = []
    names = [c["name"] for c in m.get("configs", [])] \
        + [w["name"] for w in m.get("workloads", [])] \
        + [x["name"] for x in m.get("end_to_end", [])] \
        + [x["name"] for x in m.get("per_layer", [])]
    for n in names:
        if not isinstance(n, str) or not NAME.match(n):
            bad.append(f"name {n!r}: letters, digits, _ . - only, at most "
                       "64, not starting with . or -")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in m.get(kind, [])]
        if len(seen) != len(set(seen)):
            bad.append(f"{kind}: duplicate names")
    configs = {c["name"]: c for c in m.get("configs", [])}
    for c in configs.values():
        for k in c.get("reduced", []):
            if not NAME.match(k):
                bad.append(f"config {c['name']}: reduced key {k!r}")
        if not _text(c.get("source")) or not _text(c.get("why")):
            bad.append(f"config {c['name']}: source / why of 1-200 "
                       "characters on one line")
        if not (bench.parent / c.get("file", "")).is_file():
            bad.append(f"config {c['name']}: no file {c.get('file')}")
    cells = {w["name"]: w for w in m.get("workloads", [])}
    pairs = set()
    for w in cells.values():
        if w.get("chips") != 1:
            bad.append(f"cell {w['name']}: chips must be 1")
        if w.get("config") not in configs:
            bad.append(f"cell {w['name']}: unknown config {w.get('config')}")
        if not NAME.match(str(w.get("traffic"))):
            bad.append(f"cell {w['name']}: traffic {w.get('traffic')!r}")
        elif not (bench / "traffic" / f"{w['traffic']}.json").is_file():
            bad.append(f"cell {w['name']}: no traffic/{w['traffic']}.json")
        if not _text(w.get("why")):
            bad.append(f"cell {w['name']}: why of 1-200 characters")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            bad.append(f"cell {w['name']}: config and traffic repeat")
        pairs.add(pair)
    e2e = {x["name"]: x for x in m.get("end_to_end", [])}
    if "setup_s" not in e2e:
        bad.append("end_to_end: setup_s is missing")
    for kind in ("end_to_end", "per_layer"):
        for x in m.get(kind, []):
            if not isinstance(x.get("unit"), str) or not UNIT.match(x["unit"]):
                bad.append(f"metric {x['name']}: unit {x.get('unit')!r}")
            if x.get("better") not in ("lower", "higher"):
                bad.append(f"metric {x['name']}: better lower|higher")
            ok = E2E_SOURCES if kind == "end_to_end" else SOURCES
            if x.get("source") not in ok:
                bad.append(f"metric {x['name']}: source {x.get('source')}")
            for c in x.get("workloads", cells):
                if c not in cells:
                    bad.append(f"metric {x['name']}: unknown cell {c}")
            if not reader_path(x["name"], bench).is_file():
                bad.append(f"metric {x['name']}: no metrics/{x['name']}.py")
    for x in m.get("end_to_end", []):
        b = x.get("bound")
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            bad.append(f"metric {x['name']}: bound {b} outside [0.01, 0.25]")
    for x in m.get("per_layer", []):
        if not _text(x.get("layer")):
            bad.append(f"metric {x['name']}: layer of 1-200 characters")
        if x.get("moves") not in e2e:
            bad.append(f"metric {x['name']}: moves {x.get('moves')!r}, "
                       "not an end-to-end metric")
            continue
        for c in x.get("workloads", list(cells)):
            if c in cells and c not in reporting(m, x["moves"]):
                bad.append(f"metric {x['name']}: cell {c} does not report "
                           f"{x['moves']}")
    for w in cells:
        if not any(w in reporting(m, x["name"]) for x in e2e.values()
                   if x["name"] != "setup_s"):
            bad.append(f"cell {w}: no end-to-end metric besides setup_s")
        if not metrics_for(m, w, trace=True):
            bad.append(f"cell {w}: no per-layer metric")
    return bad


def reporting(m: dict, metric: str) -> list:
    """The cells that report ``metric``."""
    cells = [w["name"] for w in m["workloads"]]
    for x in m["end_to_end"] + m["per_layer"]:
        if x["name"] == metric:
            return list(x.get("workloads", cells))
    return []


def metrics_for(m: dict, cell: str, trace: bool) -> list:
    """The metrics (their manifest entries) a run of ``cell`` prints."""
    kind = "per_layer" if trace else "end_to_end"
    return [x for x in m[kind] if cell in reporting(m, x["name"])]


def reader_path(name: str, bench=BENCH) -> pathlib.Path:
    return bench / "metrics" / f"{name}.py"


def load_module(path: pathlib.Path, name: str):
    """The module at ``path``, imported under ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, bench=BENCH):
    """The ``read(ctx)`` of metric ``name``."""
    return load_module(reader_path(name, bench),
                       "lasana_bench.metrics." + name.replace(".", "_")
                       .replace("-", "_")).read


def resolve_cell(m: dict, cell: str, bench=BENCH) -> tuple:
    """``(workload entry, config dict, traffic dict)``; the configuration's
    ``weights`` and surrogate files resolved to paths beside it."""
    w = next((x for x in m["workloads"] if x["name"] == cell), None)
    if w is None:
        raise ManifestError(f"no workload {cell!r} in BENCHMARK.json")
    centry = next(c for c in m["configs"] if c["name"] == w["config"])
    cpath = bench.parent / centry["file"]
    cfg = json.loads(cpath.read_text())
    cfg["weights_path"] = str(cpath.parent / cfg["weights"])
    cfg["surrogate_paths"] = {k: str(cpath.parent / v)
                              for k, v in cfg["surrogates"].items()}
    traffic = json.loads(
        (bench / "traffic" / f"{w['traffic']}.json").read_text())
    return w, cfg, traffic


def network(cfg: dict, bench=BENCH):
    return load_module(bench / "networks" / f"{cfg['network']}.py",
                       f"lasana_bench.networks.{cfg['network']}")


def traffic_kind(traffic: dict, bench=BENCH):
    return load_module(bench / "traffic" / f"{traffic['kind']}.py",
                       f"lasana_bench.traffic.{traffic['kind']}")


def forbidden_modules(names=None) -> list:
    """Top-level names of ``sys.modules`` (or of ``names``) that no run may
    hold, compared whole (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else names
    tops = {k.split(".", 1)[0] for k in names}
    return sorted(tops & set(FORBIDDEN))


class Spans:
    """The benchmark's own host spans around its calls into the program:
    ``(name, start, end)`` on ``time.perf_counter``; while a profiler
    records (``profiled=True``), each is also a ``bench.<name>`` range in
    its trace."""

    def __init__(self):
        self.spans = []
        self.profiled = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = contextlib.nullcontext()
        if self.profiled:
            from torch.profiler import record_function
            rf = record_function(f"bench.{name}")
        t0 = time.perf_counter()
        with rf:
            yield
        self.spans.append((name, t0, time.perf_counter()))


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown=None, **extra) -> str:
    """The last line of standard output: the required keys, then extras,
    then the compared numbers beside their limits under ``checks``."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out.update(extra)
    out["checks"] = checks
    return json.dumps(out)
