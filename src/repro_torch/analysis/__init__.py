"""Static gates for the port's hot paths: the JAX package's ``analysis``
(docs/analysis.md) and its three CI tools, run together by ``python -m
repro_torch.analysis``.

``jaxpr_audit``
    runs every hot-path entrypoint registered with its
    ``register_entrypoint`` under a dispatch mode and checks
    per-tick dispatch and kernel budgets (fused <= 3 stacked dispatches,
    a packed tick one ``network_tick`` per layer), product and aten-op
    counts frozen in ``program_budgets.json``, that no runner writes its
    caller's carries, no fp64 output and no host sync, cache-key
    completeness (with the ``id(...)`` ban), and that ``kernels/ops.py``
    is the only module that touches the environment.

``thread_lint``
    an AST lint of the threaded serve subsystem driven by per-class
    locking-discipline tables.

``api_surface``
    the facade's public surface (``repro_torch.lasana.__all__``): every
    public member documented, and the surface equal to its frozen
    snapshot ``api_surface.txt``.
"""

from repro_torch.analysis.jaxpr_audit import (Finding, ProgramMetrics,
                                              audit_entry, collect_budgets,
                                              run_audit, synthetic_surrogate)
from repro_torch.analysis.thread_lint import (ClassDiscipline, LINT_TABLE,
                                              lint_file, lint_source,
                                              run_lint)

__all__ = [
    "ClassDiscipline",
    "Finding",
    "LINT_TABLE",
    "ProgramMetrics",
    "audit_entry",
    "collect_budgets",
    "lint_file",
    "lint_source",
    "run_audit",
    "run_lint",
    "synthetic_surrogate",
]
