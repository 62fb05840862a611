"""The port's static gates (``repro_torch.analysis``): each seeded defect
is caught and named, the tree is clean, and the audit agrees with the
reference's frozen budgets.

Three parts, as ``tests/test_analysis.py`` has them for the JAX package:
seeded defects (a runner, source snippet or snapshot with exactly one
planted violation, and a finding naming its entrypoint, cache, field or
file), the repo clean (what ``python -m repro_torch.analysis`` enforces),
and parity: under the reference's pinned environment each of its 13
entrypoints makes, per tick plus fixed, exactly the surrogate dispatches
frozen in ``tests/data/program_budgets.json`` (read as JSON; no JAX
here)."""

import json
import pathlib
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.analysis import api_surface, jaxpr_audit, thread_lint  # noqa: E402,E501
from repro_torch.analysis.jaxpr_audit import TracedEntry  # noqa: E402
from repro_torch.analysis.thread_lint import ClassDiscipline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
REFERENCE_ENTRIES = (
    "explore_pricing", "network_mono", "network_stream_chunk",
    "network_stream_flush", "serve_slot_flush", "serve_slot_join",
    "serve_slot_step", "serve_slot_step_behavioral",
    "tick_fused_annotation", "tick_fused_standalone", "tick_megakernel",
    "tick_percall", "tick_xbar_fused")


def _checks(findings):
    return [f.check for f in findings]


@pytest.fixture(scope="module")
def audited():
    """{name: (metrics, findings)} of every registered entrypoint under the
    pinned environment, on the CPU (one audit per worker)."""
    with jaxpr_audit.pinned_env():
        return jaxpr_audit._audit_all(jaxpr_audit.build_context("cpu"))


def _ticks(n, body):
    """``fn(x)`` running ``body(x)`` ``n`` times, chained."""
    def fn(x):
        for _ in range(n):
            x = body(x)
        return x
    return fn


# --- seeded defects: the program auditor ----------------------------------------


def test_dispatch_budget_excess_caught():
    """A tick making four stacked dispatches against a ceiling of three
    fails, naming the entrypoint: a regen cannot lift ceilings."""
    def fat(x):
        for _ in range(4):
            ops.record_dispatch("predict_heads")
            x = x + 1.0
        return x

    metrics, findings = jaxpr_audit.audit_entry(
        "fat_tick", lambda n: TracedEntry(
            fn=_ticks(n, fat), args=(torch.zeros(3),),
            max_dispatch={"predict_heads": 3}))
    assert metrics.dispatches == {"predict_heads": 4}
    assert _checks(findings) == ["dispatch-budget"]
    assert findings[0].entry == "fat_tick"
    assert "4" in findings[0].message and "3" in findings[0].message


def test_carry_write_caught():
    """A stream runner that writes its caller's carries in place (what a
    checkpoint snapshots) is flagged with the number of tensors written."""
    ctx = jaxpr_audit.build_context("cpu")

    def build(n):
        entry = jaxpr_audit._entry_stream_chunk(ctx, n)
        step = entry.fn

        def leaky(x, k0, carries, prev, banks):
            out = step(x, k0, carries, prev, banks)
            for old, new in zip(carries, out[6]):
                old.v.copy_(new.v)
            return out
        entry.fn = leaky
        return entry

    with jaxpr_audit.pinned_env():
        metrics, findings = jaxpr_audit.audit_entry("leaky_stream", build)
    assert metrics.writes == ctx.spec.n_layers
    assert _checks(findings) == ["carry-write"]
    assert findings[0].entry == "leaky_stream"


def test_clean_runner_writes_nothing(audited):
    assert all(m.writes == 0 for m, _ in audited.values())


def test_fp64_output_caught():
    """A float64 output anywhere on the hot path is a finding."""
    _, findings = jaxpr_audit.audit_entry(
        "wide_tick", lambda n: TracedEntry(
            fn=_ticks(n, lambda x: (x.double() * 2.0).float()),
            args=(torch.zeros(3),)))
    assert _checks(findings) == ["fp64-promotion"]
    assert "float64" in findings[0].message


def test_item_in_tick_loop_caught():
    """``.item()`` every tick syncs with the host every tick: reported as
    inside the tick loop; one read after the loop as the fixed part."""
    def chatty(x):
        x = x + 1.0
        x.sum().item()
        return x

    _, findings = jaxpr_audit.audit_entry(
        "chatty_ticks", lambda n: TracedEntry(fn=_ticks(n, chatty),
                                              args=(torch.zeros(3),)))
    assert _checks(findings) == ["host-sync"]
    assert "inside the tick loop" in findings[0].message
    assert "_local_scalar_dense" in findings[0].message

    def tail(n):
        run = _ticks(n, lambda x: x + 1.0)
        return TracedEntry(fn=lambda x: bool(run(x).sum() > 0),
                           args=(torch.zeros(3),))
    _, findings = jaxpr_audit.audit_entry("tail_read", tail)
    assert _checks(findings) == ["host-sync"]
    assert "fixed part" in findings[0].message


def test_packed_tick_launching_network_tick_twice_caught():
    """A packed tick that launches ``network_tick`` twice breaks the
    kernel route's exact count, naming the kernel."""
    from repro_torch.core import wrapper
    ctx = jaxpr_audit.build_context("cpu")

    def build(n):
        entry = jaxpr_audit._entry_tick_megakernel(ctx, n)

        def twice(sur, state, changed, x, ts):
            for k in range(n):
                for _ in range(2):
                    state, _, _, _ = wrapper.lasana_step(
                        sur, state, changed, x, ts[k], 4.0, spiking=True,
                        fused=True, fused_kernel=True)
            return state
        entry.fn = twice
        entry.max_dispatch = {}
        return entry

    metrics, findings = jaxpr_audit.audit_entry("double_tick", build)
    assert metrics.kernels["per_tick"] == {"network_tick": 2}
    assert _checks(findings) == ["kernel-budget"]
    assert "network_tick: 2 calls per tick" in findings[0].message


def test_stacked_heads_over_their_ceiling_caught():
    def four(x):
        for _ in range(4):
            ops.record_dispatch("kernel:mlp_surrogate_heads")
        return x + 1.0

    _, findings = jaxpr_audit.audit_entry(
        "wide_heads", lambda n: TracedEntry(
            fn=_ticks(n, four), args=(torch.zeros(3),),
            max_kernels={"mlp_surrogate_heads": 3}))
    assert _checks(findings) == ["kernel-budget"]
    assert "4 mlp_surrogate_heads calls per tick" in findings[0].message


def test_counts_not_linear_in_the_ticks_caught():
    """A dispatch count that grows with the square of the ticks is neither
    per tick nor fixed."""
    def build(n):
        def fn(x):
            for _ in range(n * n):
                ops.record_dispatch("predict")
            return x
        return TracedEntry(fn=fn, args=(torch.zeros(3),))

    _, findings = jaxpr_audit.audit_entry("quadratic", build)
    assert _checks(findings) == ["nonlinear-count"]
    assert "dispatches predict 1, 4, 9" in findings[0].message


def test_id_keyed_cache_caught():
    src = textwrap.dedent("""
        def _key(self, surrogate, b):
            return (id(surrogate), b)
    """)
    findings = jaxpr_audit.check_cache_key_source(
        src, required=("b",), name="bad-cache")
    assert _checks(findings) == ["cache-key"]
    assert "id(" in findings[0].message
    assert findings[0].entry == "bad-cache"


def test_missing_cache_key_field_caught():
    src = "def _key(self, b):\n    return (b,)\n"
    findings = jaxpr_audit.check_cache_key_source(
        src, required=("b", "structure_key"), name="narrow-cache")
    assert len(findings) == 1
    assert "structure_key" in findings[0].message


def test_runner_key_blind_to_a_knob_caught(monkeypatch):
    """The dynamic check: a runner key that forgets the fused flag lets a
    stale runner serve the other path."""
    from repro_torch.core.network import NetworkEngine
    from repro_torch.core.surrogate import structure_key

    def narrow(self, kind, b, t_steps, banks):
        return (kind, ops.fused_kernel_enabled(self.fused_kernel), b,
                t_steps, structure_key(banks))
    monkeypatch.setattr(NetworkEngine, "_program_key", narrow)
    with jaxpr_audit.pinned_env():
        findings = jaxpr_audit.check_program_key_sensitivity(
            jaxpr_audit.build_context("cpu"))
    assert _checks(findings) == ["cache-key"]
    assert "'fused'" in findings[0].message


def test_env_read_outside_ops_caught(tmp_path):
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    (pkg / "rogue.py").write_text(
        "import os\n"
        "SMOKE = os.environ.get('REPRO_BENCH_SMOKE')\n"
        "DIR = os.environ['REPRO_BENCH_DIR']\n"
        "os.environ['REPRO_MOE_CF'] = '4'\n")  # a write: only ops.py
    (tmp_path / "chip_smoke.py").write_text(
        "import os\nfrom os import environ\n"
        "PATH = os.getenv('PYTHONPATH')\n")
    (pkg / "kernels").mkdir()
    (pkg / "kernels" / "ops.py").write_text(
        "import os\nFLAG = os.environ.get('REPRO_FUSED_KERNEL')\n")
    findings = jaxpr_audit.check_env_discipline(root=tmp_path)
    assert _checks(findings) == ["env-discipline"] * 5
    assert sorted(f.entry for f in findings) == ["chip_smoke.py"] * 2 \
        + ["src/repro_torch/rogue.py"] * 3
    said = " ".join(f.message for f in findings)
    for what in ("os.environ.get(...) at line 2",
                 "os.environ[...] read at line 3",
                 "os.environ[...] written at line 4",
                 "from os import environ", "os.getenv(...)"):
        assert what in said


# --- seeded defects: the thread lint ---------------------------------------------

_LANE_TABLE = {"Lane": ClassDiscipline(
    lock="_lock",
    driver=frozenset({"_carries"}),
    driver_write=frozenset({"g"}),
    locked=frozenset({"_queue"}),
    init=frozenset({"engine"}),
    driver_methods=frozenset({"step"}),
)}


def _lint(src, table=None):
    return thread_lint.lint_source(textwrap.dedent(src),
                                   table or _LANE_TABLE, "fixture.py")


@pytest.mark.parametrize("src, check, needle", [
    ("""
        class Lane:
            def submit(self, req):
                self._carries = req      # driver-only state, wrong thread
            def step(self):
                self._carries = None     # fine: driver method
    """, "thread-affinity", "_carries"),
    ("""
        class Lane:
            def submit(self, req):
                self._queue.append(req)
            def drain(self):
                with self._lock:
                    return list(self._queue)
    """, "unguarded-state", "_queue"),
    ("""
        class Lane:
            def step(self):
                with self._lock:
                    self.engine.slot_programs(4, 8)
    """, "blocking-under-lock", "slot_programs"),
    ("""
        class Lane:
            def step(self):
                with self._lock:
                    handle._push(chunk)
    """, "blocking-under-lock", "_push"),
    ("""
        class Lane:
            def step(self):
                with self._lock:
                    torch.cuda.synchronize()
    """, "blocking-under-lock", "synchronize"),
    ("""
        class Lane:
            def step(self):
                with self._lock:
                    n = self.engine.count.item()
    """, "blocking-under-lock", "item"),
    ("""
        class Lane:
            def step(self):
                self.scratch = 1
    """, "unannotated-field", "scratch"),
    ("""
        class Lane:
            def stats(self):
                return self.g            # racy read: tolerated
            def submit(self):
                self.g = 2.0             # foreign write: flagged
    """, "thread-affinity", "'self.g'"),
    ("""
        class Lane:
            def submit(self, lane):
                lane.g = 1.0
    """, "thread-affinity", "'g'"),
])
def test_thread_lint_seeded_defect_caught(src, check, needle):
    findings = _lint(src)
    assert _checks(findings) == [check]
    assert needle in findings[0].message
    assert findings[0].entry.startswith("fixture.py:Lane.")


def test_condition_wait_exempt_under_lock():
    table = {"Srv": ClassDiscipline(
        lock="_lock", lock_aliases=frozenset({"_wake"}),
        locked=frozenset({"_queues"}))}
    findings = _lint("""
        class Srv:
            def _drive(self):
                with self._wake:
                    if not self._queues:
                        self._wake.wait(0.1)
    """, table)
    assert findings == []


# --- the repo itself is clean ---------------------------------------------------


def test_repo_thread_lint_clean():
    assert thread_lint.run_lint() == []
    assert set(thread_lint.LINT_TABLE) == {
        f"src/repro_torch/serve/{m}.py" for m in ("server", "scheduler",
                                                   "store")}


def test_repo_cache_keys_clean():
    assert jaxpr_audit.check_cache_keys() == []


def test_repo_env_discipline_clean():
    assert jaxpr_audit.check_env_discipline() == []


def test_repo_entrypoints_clean_and_frozen(audited):
    """Every entrypoint free of findings and equal to its frozen row; the
    frozen file covers exactly the registry."""
    findings = [f for _, fs in audited.values() for f in fs]
    assert findings == [], "\n".join(map(str, findings))
    rows = {name: m.budget_row() for name, (m, _) in audited.items()}
    assert jaxpr_audit.compare_budgets(rows, jaxpr_audit.load_budgets(),
                                       "cpu") == []
    assert set(jaxpr_audit.registered_entrypoints()) == set(
        jaxpr_audit.load_budgets())


def test_budget_drift_held_per_device(audited):
    """The frozen rows are CPU counts: on the CPU every field is held,
    on the card only the dispatches, kernel calls and writes (its aten
    ops around the same kernels differ)."""
    name = "network_stream_chunk_kernel"
    frozen = {name: jaxpr_audit.load_budgets()[name]}
    row = audited[name][0].budget_row()
    more_ops = {name: {**row, "ops": row["ops"] + 1}}
    assert _checks(jaxpr_audit.compare_budgets(more_ops, frozen, "cpu")) \
        == ["program-budget"]
    assert jaxpr_audit.compare_budgets(more_ops, frozen, "cuda") == []
    twice = {name: {**row, "kernels": {"per_tick": {},
                                       "fixed": {"network_tick_chunk": 2}}}}
    findings = jaxpr_audit.compare_budgets(twice, frozen, "cuda")
    assert _checks(findings) == ["program-budget"]
    assert findings[0].entry == name


def test_audit_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Like every entry point of the port, the audit defaults to CUDA and
    raises where there is none; the CLI's default is the card too."""
    from repro_torch.analysis.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jaxpr_audit.build_context()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jaxpr_audit.synthetic_surrogate("lif")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--programs"])


def test_cli_runs_every_gate_clean(capsys):
    """``python -m repro_torch.analysis`` with no gate named: the program
    audit against the frozen budgets, the thread lint and the API gate."""
    from repro_torch.analysis.__main__ import main
    assert main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "program audit (17 entrypoints on cpu)" in out
    assert "thread lint (3 files)" in out and "api surface" in out


def test_cli_exits_one_on_a_finding(monkeypatch, capsys):
    from repro_torch.analysis.__main__ import main
    monkeypatch.setattr(thread_lint, "run_lint", lambda: [
        jaxpr_audit.Finding("thread-affinity", "x.py:Lane.submit", "m")])
    assert main(["--threads"]) == 1
    assert "[thread-affinity] x.py:Lane.submit: m" in capsys.readouterr().err


# --- parity with the reference's frozen budgets and the kernel routes -------------


@pytest.mark.parametrize("name", REFERENCE_ENTRIES)
def test_dispatches_equal_the_reference_budget(audited, name):
    """Under the reference's pinned environment (fused kernel off, no
    fault plan) each of its entrypoints dispatches exactly what its
    frozen budget says: per tick plus fixed, the trace count."""
    ref = json.loads((ROOT / "tests" / "data" /
                      "program_budgets.json").read_text())["entries"]
    assert set(ref) == set(REFERENCE_ENTRIES)
    assert audited[name][0].dispatches == ref[name]["dispatches"]


@pytest.mark.parametrize("name, per_tick, fixed", [
    ("tick_megakernel", {"network_tick": 1}, {}),
    ("tick_xbar_kernel", {"network_tick": 1}, {}),
    ("network_mono_kernel", {"network_tick": 2}, {}),
    ("network_stream_chunk_kernel", {}, {"network_tick_chunk": 1}),
    ("tick_unpackable_kernel", {"gbdt_walk": 2, "mlp_surrogate_heads": 2},
     {}),
    ("serve_slot_step_behavioral", {}, {}),
    ("tick_percall", {}, {}),
])
def test_kernel_routes_meet_their_ceilings(audited, name, per_tick, fixed):
    """The kernel routes on the CPU: one ``network_tick`` per packed layer
    a tick, one ``network_tick_chunk`` a chunk, at most 3 head kernels a
    stacked tick and one ``gbdt_walk`` for each GBDT head a variant reads
    (the idle and the active M_ES), none on the behavioral or per-call
    tick."""
    kernels = audited[name][0].kernels
    assert kernels == {"per_tick": per_tick, "fixed": fixed}
    assert kernels == jaxpr_audit.load_budgets()[name]["kernels"]


def test_dispatch_scope_nests_and_restores():
    with ops.dispatch_scope() as outer:
        ops.record_dispatch("a")
        with ops.dispatch_scope() as inner:
            ops.record_dispatch("b")
        ops.record_dispatch("a")
    assert outer == ["a", "a"] and inner == ["b"]
    ops.record_dispatch("dropped")  # no active scope: a no-op
    assert ops._DISPATCH_SCOPE is None


def test_kernel_entry_points_record_only_inside_a_scope():
    """A kernel entry point records ``kernel:<name>`` and marks its body
    as the kernel's inside a scope, and records nothing outside one."""
    x = torch.zeros((2, 4))
    seen = []
    real = ops.mlp_surrogate.__wrapped__

    def spy(*args):
        seen.append(ops.in_kernel())
        return real(*args)
    wrapped = ops._kernel_entry(spy)
    w = [torch.zeros(s) for s in ((4, 3), (3,), (3, 2), (2,), (2, 1), (1,))]
    wrapped(x, *w)
    with ops.dispatch_scope() as log:
        wrapped(x, *w)
        ops.mlp_surrogate(x, *w)
    assert seen == [False, True]
    assert log == ["kernel:spy", "kernel:mlp_surrogate"]
    assert not ops.in_kernel()


# --- the API gate --------------------------------------------------------------

# the port's additions to the reference's surface (ROADMAP §A item 3):
# ``device=`` on every entry point that places tensors, ``fused=`` on
# ``simulate``, and the port's own members of ``Surrogate`` and
# ``SurrogateLibrary``
PORT_ONLY = {("Surrogate.device", "property"), ("Surrogate.to", "method"),
             ("Surrogate.train_report", "attribute"),
             ("SurrogateLibrary.to", "method")}
ADDED_PARAMETERS = {
    "Surrogate": [", train_report: 'Optional[dict]' = None"],
    "simulate": ["fused: 'bool' = True, "],
}
# JAX's pytree hooks, which a torch module has no use for
REFERENCE_ONLY = {("Surrogate.tree_flatten", "method"),
                  ("Surrogate.tree_unflatten", "classmethod"),
                  ("SurrogateLibrary.tree_flatten", "method"),
                  ("SurrogateLibrary.tree_unflatten", "classmethod")}


def _surface(lines):
    """{(qualified name, kind): signature} of a surface's lines."""
    out, cls = {}, None
    for ln in lines:
        head, _, sig = ln.strip().partition("]")
        name, kind = head.split(" [")
        if ln.startswith("  ."):
            name = f"{cls}{name}"
        else:
            cls = name
        out[(name, kind)] = sig
    return out


def test_api_surface_documented_and_frozen():
    lines, missing = api_surface.build_surface()
    assert missing == []
    assert api_surface.check_api() == []


def test_api_surface_covers_the_reference():
    """Every line of the reference's frozen surface is on the port's, by
    name and kind, and with its signature once the port's named additions
    are taken out; the only differences are the ones named above."""
    ref = _surface((ROOT / "tests" / "data" /
                    "api_surface.txt").read_text().splitlines())
    port = _surface(api_surface.build_surface()[0])
    assert set(ref) - set(port) == REFERENCE_ONLY
    assert set(port) - set(ref) == PORT_ONLY
    for key in set(ref) & set(port):
        sig = port[key].replace(", device=None", "")
        for extra in ADDED_PARAMETERS.get(key[0], ()):
            sig = sig.replace(extra, "")
        assert sig == ref[key], key


def test_api_drift_and_missing_docstring_caught(tmp_path, monkeypatch):
    snap = tmp_path / "api_surface.txt"
    snap.write_text(api_surface.surface_text().replace(
        "  .kinds [method]", "  .kinds [property]"))
    findings = api_surface.check_api(snap)
    assert _checks(findings) == ["api-surface"]
    assert ".kinds [property]" in findings[0].message
    from repro_torch.core.surrogate import SurrogateLibrary
    monkeypatch.setattr(SurrogateLibrary.to, "__doc__", None)
    findings = api_surface.check_api()
    assert ("api-docstring", "repro_torch.lasana.SurrogateLibrary.to") in [
        (f.check, f.entry) for f in findings]
