"""Trees of tensors (nested dicts, lists and tuples) flattened in the JAX
package's order: ``jax.tree.flatten`` visits dict keys sorted, lists and
tuples in order, and ``None`` is an empty subtree. The optimizer's
norms, the train state and the checkpoint files follow that order, so a
checkpoint's ``leaf_%05d`` files mean the same leaves in both packages.
"""

from __future__ import annotations

_LEAF = "*"


def flatten(tree):
    """``(leaves, treedef)``: the leaves in ``jax.tree.flatten`` order and
    a structure that :func:`unflatten` fills back."""
    leaves: list = []
    return leaves, _walk(tree, leaves)


# module-level recursions: a nested recursive closure refers to itself,
# and the cycle would hold the leaves until the cyclic collector ran
def _walk(t, leaves: list):
    if t is None:
        return ("none",)
    if isinstance(t, dict):
        keys = sorted(t)
        return ("dict", keys, [_walk(t[k], leaves) for k in keys])
    if isinstance(t, (list, tuple)):
        return (type(t), [_walk(v, leaves) for v in t])
    leaves.append(t)
    return _LEAF


def unflatten(treedef, leaves):
    """The tree of ``treedef`` with ``leaves`` in flatten order."""
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree has")
    return out


def _build(d, it):
    if d == _LEAF:
        return next(it)
    if d[0] == "none":
        return None
    if d[0] == "dict":
        return {k: _build(c, it) for k, c in zip(d[1], d[2])}
    kind, children = d
    vals = [_build(c, it) for c in children]
    if kind is list:
        return vals
    return kind(*vals) if hasattr(kind, "_fields") else kind(vals)


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of its structure)."""
    flat, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])


def describe(treedef) -> str:
    """A readable one-line form of a treedef (checkpoint metadata)."""
    if treedef == _LEAF:
        return "*"
    if treedef[0] == "none":
        return "None"
    if treedef[0] == "dict":
        return "{" + ", ".join(f"'{k}': {describe(c)}"
                               for k, c in zip(treedef[1], treedef[2])) + "}"
    kind, children = treedef
    inner = ", ".join(describe(c) for c in children)
    return f"[{inner}]" if kind is list else f"({inner})"
