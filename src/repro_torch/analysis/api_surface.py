"""The public-API gate of the port's facade, the JAX package's
``tools/check_api.py`` over ``repro_torch.lasana``.

A finding names a symbol of ``repro_torch.lasana.__all__`` (or a public
method or property of an exported class) that has no docstring, or says
that the generated surface differs from the frozen snapshot
``api_surface.txt`` beside this module. The snapshot is one line per
symbol, ``name [kind] signature``, class members indented; an intended
API change ships with a regenerated snapshot
(``python -m repro_torch.analysis --api --regen``), so that API diffs show
in review.
"""

from __future__ import annotations

import difflib
import inspect
import pathlib

from repro_torch.analysis.jaxpr_audit import Finding

SNAPSHOT = pathlib.Path(__file__).resolve().parent / "api_surface.txt"


def _signature(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return ""


def _class_members(cls):
    for name, member in sorted(vars(cls).items()):
        if not name.startswith("_"):
            yield name, member


def build_surface():
    """-> (lines, missing_docstrings) for ``repro_torch.lasana.__all__``."""
    import repro_torch.lasana as facade
    lines, missing = [], []
    for name in sorted(facade.__all__):
        obj = getattr(facade, name)
        if inspect.isclass(obj):
            kind = "class"
        elif inspect.isfunction(obj):
            kind = "function"
        else:
            kind = type(obj).__name__
        doc = inspect.getdoc(obj) if (inspect.isclass(obj) or callable(obj)) \
            else True
        if not doc:
            missing.append(f"repro_torch.lasana.{name}")
        lines.append(f"{name} [{kind}]"
                     f"{_signature(obj) if kind != 'int' else ''}")
        if inspect.isclass(obj):
            for mname, member in _class_members(obj):
                target, tag = member, "method"
                if isinstance(member, property):
                    target, tag = member.fget, "property"
                elif isinstance(member, staticmethod):
                    target, tag = member.__func__, "staticmethod"
                elif isinstance(member, classmethod):
                    target, tag = member.__func__, "classmethod"
                if callable(target):
                    if not inspect.getdoc(target):
                        missing.append(f"repro_torch.lasana.{name}.{mname}")
                    lines.append(f"  .{mname} [{tag}]{_signature(target)}")
                else:                            # dataclass field default etc.
                    lines.append(f"  .{mname} [attribute]")
    return lines, missing


def surface_text() -> str:
    return "\n".join(build_surface()[0]) + "\n"


def check_api(snapshot=SNAPSHOT) -> list:
    """Findings: undocumented public symbols, then drift from the frozen
    snapshot (a missing snapshot is drift)."""
    lines, missing = build_surface()
    findings = [Finding("api-docstring", m, "public symbol without a "
                        "docstring") for m in missing]
    snapshot = pathlib.Path(snapshot)
    text = "\n".join(lines) + "\n"
    frozen = snapshot.read_text() if snapshot.is_file() else ""
    if frozen != text:
        diff = [d for d in difflib.unified_diff(
            frozen.splitlines(), text.splitlines(), lineterm="", n=0)
            if d[:1] in "+-" and d[:3] not in ("+++", "---")]
        findings.append(Finding(
            "api-surface", snapshot.name,
            "repro_torch.lasana's surface drifted from the frozen snapshot "
            "(intentional? regen with python -m repro_torch.analysis --api "
            "--regen and review the diff): " + "; ".join(diff)))
    return findings


def save_surface(snapshot=SNAPSHOT) -> None:
    pathlib.Path(snapshot).write_text(surface_text())
