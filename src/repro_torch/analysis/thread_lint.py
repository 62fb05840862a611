"""AST concurrency lint for the threaded serve subsystem, the JAX
package's ``analysis/thread_lint.py`` (``:1-344``) with the port's tables.

The serve layer has exactly one interesting concurrency contract:
request threads enqueue under ``SimServer._lock`` while a single driver
thread owns every tensor on the card, and nothing slow or user-visible
may ever run while the lock is held. That contract lives in per-class
locking-discipline tables (:data:`LINT_TABLE`, keyed by the port's
``serve/server.py``, ``scheduler.py`` and ``store.py``): every
``self.<field>`` of an annotated class is declared *locked* (touch only
under ``with self._lock``), *driver* (driver-thread methods only),
*driver_write* (driver writes, racy reads tolerated for observability),
*init* (immutable after ``__init__``), *control* (lifecycle methods
only), or *safe* (internally synchronized, e.g. ``ServerMetrics``).

The lint walks each annotated class method-by-method, tracking lock
depth through ``with self._lock:`` / ``with self._wake:`` (a Condition
wraps the same lock), and flags:

  * guarded-state access outside the lock (or any *unannotated* field —
    the table must stay complete, so a new field without a category is
    itself an error);
  * blocking work under the lock — runner builds, the card's host syncs
    (``synchronize``, ``item``, ``cpu``, ``tolist``),
    ``time.sleep``/``join``/``result``, lane construction — which would
    stall every request thread on one admission;
  * user-callback invocation under the lock (``RequestHandle._push``
    fires ``on_chunk``; user code re-entering ``submit`` would deadlock);
  * cross-object violations: writing another object's driver-only field,
    or calling another annotated class's driver-thread method, from a
    method not itself annotated as driver-side.

Known blind spots (documented, deliberate — this is a lint, not an
escape analysis): aliasing guarded state into a local and mutating the
alias, and ``driver_write`` mutations spelled as method calls
(``lane.active.append(...)`` parses as a Load).
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib

from repro_torch.analysis.jaxpr_audit import Finding, REPO_ROOT

# Calls that stall the calling thread: builds, the card's host syncs and
# copies to the host, sleeps/joins, runner-set construction, and the user
# chunk callback. None may run while holding a server/store lock.
BLOCKING_CALLS = frozenset({
    "compile", "lower", "block_until_ready", "device_get",
    "slot_programs", "sleep", "join", "result", "_push", "wait",
    "load_artifact", "stall", "synchronize", "item", "cpu", "tolist",
})
# Constructing a Lane builds its engine runners — same ban.
BLOCKING_CONSTRUCTORS = frozenset({"Lane"})


@dataclasses.dataclass(frozen=True)
class ClassDiscipline:
    """The locking table for one class: which lock guards it, and the
    category of every ``self.<field>`` it owns."""

    lock: str = "_lock"
    # context managers that imply the lock (a Condition wrapping it)
    lock_aliases: frozenset = frozenset()
    locked: frozenset = frozenset()        # only under the lock
    driver: frozenset = frozenset()        # driver methods only (strict)
    driver_write: frozenset = frozenset()  # driver stores; racy loads ok
    init: frozenset = frozenset()          # stores in __init__ only
    control: frozenset = frozenset()       # lifecycle methods only
    safe: frozenset = frozenset()          # internally synchronized
    driver_methods: frozenset = frozenset()
    control_methods: frozenset = frozenset()
    # methods whose contract is "caller already holds the lock"
    lock_held_methods: frozenset = frozenset()

    def all_fields(self):
        return (self.locked | self.driver | self.driver_write | self.init
                | self.control | self.safe | {self.lock}
                | self.lock_aliases)


LINT_TABLE = {
    "src/repro_torch/serve/server.py": {
        "SimServer": ClassDiscipline(
            lock="_lock",
            lock_aliases=frozenset({"_wake"}),
            locked=frozenset({"_queues", "_specs", "_spec_names",
                              "_lanes", "_in_flight", "_next_id",
                              "_fault_counts", "_degraded", "_hung"}),
            init=frozenset({"config", "policy", "store", "metrics",
                            "_watchdog"}),
            control=frozenset({"_thread"}),
            safe=frozenset({"_stop", "_closed"}),
            # _stepping_lane: driver stores the key around each lane.step;
            # the watchdog timer thread's racy read is tolerated by design
            # (worst case it misses one borderline hang, never fingers a
            # wrong lane — the key is popped + re-checked under the lock)
            driver=frozenset({"_step_count"}),
            driver_write=frozenset({"_stepping_lane"}),
            driver_methods=frozenset({"_lane_for", "_admit", "step",
                                      "run_until_idle", "_drive",
                                      "_fail_all", "_requeue",
                                      "_note_fault"}),
            control_methods=frozenset({"start", "close",
                                       "run_until_idle"}),
            lock_held_methods=frozenset({"_canonical"}),
        ),
    },
    "src/repro_torch/serve/scheduler.py": {
        "Lane": ClassDiscipline(
            lock="_lock",
            init=frozenset({"engine", "spec", "bucket", "width",
                            "chunk_ticks", "metrics", "surrogates",
                            "programs", "_clocks", "_last_lif",
                            "degraded"}),
            driver=frozenset({"_banks", "_carries", "_prev", "_end_ks"}),
            driver_write=frozenset({"g", "free", "active", "idle_rounds",
                                    "sur_token"}),
            safe=frozenset({"_poison"}),   # threading.Event: watchdog
                                           # timer thread sets, driver reads
            driver_methods=frozenset({"admit", "step", "_slice",
                                      "_quarantine"}),
        ),
    },
    "src/repro_torch/serve/store.py": {
        "ArtifactStore": ClassDiscipline(
            lock="_lock",
            locked=frozenset({"_artifacts"}),
        ),
    },
}


def _self_attr(node):
    """'field' if node is ``self.field``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _class_level_names(cls_node: ast.ClassDef):
    """Names defined on the class body (methods, properties, class vars)
    — ``self.<name>`` hitting one of these is a method/property access,
    not instance state."""
    names = set()
    for stmt in cls_node.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(stmt.name)
        elif isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        elif isinstance(stmt, ast.AnnAssign):
            if isinstance(stmt.target, ast.Name):
                names.add(stmt.target.id)
    return names


class _MethodLinter(ast.NodeVisitor):
    def __init__(self, cls_name, method, disc: ClassDiscipline,
                 table, rel, class_names, findings):
        self.cls = cls_name
        self.method = method.name
        self.disc = disc
        self.table = table      # merged {class -> discipline} over files
        self.rel = rel
        self.class_names = class_names
        self.findings = findings
        self.lock_depth = 1 if method.name in disc.lock_held_methods else 0
        self.in_init = method.name == "__init__"
        self.is_driver = (self.in_init
                          or method.name in disc.driver_methods)
        self.is_control = (self.in_init
                           or method.name in disc.control_methods)

    def _flag(self, check, node, msg):
        self.findings.append(Finding(
            check, f"{self.rel}:{self.cls}.{self.method}",
            f"line {node.lineno}: {msg}"))

    # -- lock tracking ---------------------------------------------------

    def _is_lock_expr(self, expr):
        field = _self_attr(expr)
        return field == self.disc.lock or field in self.disc.lock_aliases

    def visit_With(self, node):
        holds = any(self._is_lock_expr(item.context_expr)
                    for item in node.items)
        for item in node.items:
            self.visit(item.context_expr)
        if holds:
            self.lock_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if holds:
            self.lock_depth -= 1

    # -- field-category rules --------------------------------------------

    def visit_Attribute(self, node):
        field = _self_attr(node)
        if field is None or field in self.class_names:
            self.generic_visit(node)
            return
        d = self.disc
        is_store = isinstance(node.ctx, (ast.Store, ast.Del))
        if field == d.lock or field in d.lock_aliases or field in d.safe:
            pass
        elif field in d.locked:
            if self.lock_depth == 0 and not self.in_init:
                self._flag("unguarded-state", node,
                           f"access to lock-guarded field "
                           f"'self.{field}' outside 'with "
                           f"self.{d.lock}'")
        elif field in d.driver:
            if not self.is_driver:
                self._flag("thread-affinity", node,
                           f"driver-thread-only field 'self.{field}' "
                           f"accessed from non-driver method")
        elif field in d.driver_write:
            if is_store and not self.is_driver:
                self._flag("thread-affinity", node,
                           f"driver-owned field 'self.{field}' written "
                           f"from non-driver method (racy reads are "
                           f"tolerated, writes are not)")
        elif field in d.init:
            if is_store and not self.in_init:
                self._flag("init-immutability", node,
                           f"immutable-after-init field 'self.{field}' "
                           f"written outside __init__")
        elif field in d.control:
            if not self.is_control:
                self._flag("thread-affinity", node,
                           f"lifecycle field 'self.{field}' accessed "
                           f"outside control methods")
        else:
            self._flag("unannotated-field", node,
                       f"'self.{field}' has no category in the "
                       f"locking-discipline table — annotate it in "
                       f"repro_torch/analysis/thread_lint.py:LINT_TABLE")
        self.generic_visit(node)

    # -- call rules ------------------------------------------------------

    def visit_Call(self, node):
        callee = None
        if isinstance(node.func, ast.Attribute):
            callee = node.func.attr
        elif isinstance(node.func, ast.Name):
            callee = node.func.id

        # blocking work / user callbacks under the lock
        if self.lock_depth > 0 and callee is not None:
            exempt = False
            if isinstance(node.func, ast.Attribute):
                # Condition.wait/notify on the lock's own condition is
                # the one sanctioned "slow" call under the lock (it
                # RELEASES the lock while waiting).
                owner = _self_attr(node.func.value)
                if (owner in self.disc.lock_aliases
                        and callee in ("wait", "notify", "notify_all")):
                    exempt = True
            if not exempt and (callee in BLOCKING_CALLS
                               or callee in BLOCKING_CONSTRUCTORS):
                self._flag("blocking-under-lock", node,
                           f"'{callee}' invoked while holding "
                           f"self.{self.disc.lock} — blocking/callback "
                           f"work must run after the lock is released")

        # self._method() where _method requires the lock already held
        if (isinstance(node.func, ast.Attribute)
                and _self_attr(node.func) in self.disc.lock_held_methods
                and self.lock_depth == 0):
            self._flag("unguarded-state", node,
                       f"'self.{node.func.attr}' requires the caller to "
                       f"hold self.{self.disc.lock}")

        # cross-object: <expr>.driver_method(...) on another annotated
        # class, from a method not itself driver-side
        if (isinstance(node.func, ast.Attribute)
                and _self_attr(node.func) is None
                and not self.is_driver):
            for other in self.table.values():
                if (callee in other.driver_methods
                        and callee not in self.disc.driver_methods
                        and callee not in self.disc.control_methods):
                    self._flag("thread-affinity", node,
                               f"'{callee}' is a driver-thread method of "
                               f"an annotated class, called from a "
                               f"non-driver method")
                    break
        self.generic_visit(node)

    def visit_Assign(self, node):
        # cross-object driver-field stores: lane.g = ..., lane._carries = ...
        for target in node.targets:
            if (isinstance(target, ast.Attribute)
                    and _self_attr(target) is None
                    and not self.is_driver):
                for other in self.table.values():
                    if target.attr in (other.driver | other.driver_write):
                        self._flag(
                            "thread-affinity", target,
                            f"store to '{target.attr}', a driver-owned "
                            f"field of an annotated class, from a "
                            f"non-driver method")
                        break
        self.generic_visit(node)


def lint_source(src: str, table: dict, filename: str = "<string>"):
    """Lint one file's source against {class_name: ClassDiscipline}.
    Returns a list of :class:`Finding`."""
    findings = []
    tree = ast.parse(src)
    merged = {}
    for classes in LINT_TABLE.values():
        merged.update(classes)
    merged.update(table)
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef) or node.name not in table:
            continue
        disc = table[node.name]
        class_names = _class_level_names(node)
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _MethodLinter(node.name, stmt, disc, merged, filename,
                              class_names, findings).visit(stmt)
    return findings


def lint_file(rel_path: str, root=REPO_ROOT):
    path = pathlib.Path(root) / rel_path
    return lint_source(path.read_text(), LINT_TABLE[rel_path], rel_path)


def run_lint(root=REPO_ROOT):
    """Lint every file in LINT_TABLE; returns all findings."""
    findings = []
    for rel in sorted(LINT_TABLE):
        findings.extend(lint_file(rel, root=root))
    return findings
