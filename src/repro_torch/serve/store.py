"""Surrogate artifact store: named, versioned, hot-swappable (port of
``repro.serve.store``).

The serving counterpart of ``lasana.save``/``lasana.load``: a process-
local registry mapping ``name -> {version -> surrogate}`` so requests
reference predictor artifacts by a stable string (``"lif"`` or pinned
``"lif@2"``) instead of shipping arrays. Registering a retrained artifact
under an existing name mints the next version and becomes the default for
new requests — in-flight requests keep the version they resolved at
submit, so a hot-swap never changes a running simulation's results. Same-
structure versions share the engine's runners (surrogates are arguments
of every runner), which is what makes version rollout free of builds.

A path-registered artifact loads once, on its first resolve, onto the
device that resolve names (the server's), and is never moved again.
"""

from __future__ import annotations

import threading

from repro_torch.core.surrogate import as_surrogate
from repro_torch.resilience import faults


class ArtifactError(RuntimeError):
    """A surrogate artifact failed to load or validate.

    Raised (in place of raw ``zipfile``/``ValueError`` internals) when a
    path-registered artifact turns out truncated or corrupt, naming the
    ``name@version`` identity and the file path. Only the request that
    forced the load sees it — the store entry stays resolvable-but-
    broken, other names/versions are untouched."""


def load_artifact(path: str, *, name=None, version=None, device=None):
    """``lasana.load`` onto ``device`` with corruption wrapped in
    :class:`ArtifactError`.

    ``name``/``version`` give the error its artifact identity (lazy
    path-registered entries resolve through here). A missing file keeps
    its raw ``FileNotFoundError`` (it already names every path tried);
    everything else — bad zip, short read, version mismatch, missing
    manifest — becomes one clean ArtifactError with the cause chained.
    Injection site ``artifact.load`` fires here."""
    ref = name if version is None else f"{name}@{version}"
    import repro_torch.lasana as lasana
    try:
        faults.check("artifact.load")
        return lasana.load(path, device=device)
    except FileNotFoundError:
        raise
    except Exception as err:
        who = f"artifact {ref!r} " if name else "artifact "
        raise ArtifactError(
            f"{who}at {path!r} is corrupt or unreadable "
            f"({type(err).__name__}: {err}); re-save it with "
            "lasana.save / Surrogate.save") from err


class _LazyArtifact:
    """A path-registered artifact not yet loaded (see
    :meth:`ArtifactStore.register_path`)."""

    __slots__ = ("path",)

    def __init__(self, path: str):
        self.path = path


def parse_ref(ref: str) -> tuple:
    """``"name"`` -> (name, None); ``"name@3"`` -> (name, 3)."""
    if "@" not in ref:
        return ref, None
    name, _, ver = ref.rpartition("@")
    if not name:
        raise ValueError(f"bad surrogate ref {ref!r}: expected "
                         "'name' or 'name@version'")
    try:
        return name, int(ver)
    except ValueError:
        raise ValueError(f"bad surrogate ref {ref!r}: version "
                         f"{ver!r} is not an integer") from None


class ArtifactStore:
    """Thread-safe ``name@version`` registry of surrogate artifacts.

    Values are whatever the engine accepts as ``surrogates=``: a
    :class:`Surrogate`, a :class:`SurrogateLibrary`, or a ``{circuit:
    Surrogate}`` mapping (mixed graphs); single artifacts are normalized
    through ``as_surrogate`` at registration so fitted ``PredictorBank``
    values freeze exactly once."""

    def __init__(self):
        self._lock = threading.Lock()
        self._artifacts: dict = {}      # name -> {version: object}

    def register(self, name: str, surrogate, *, version=None) -> int:
        """Register ``surrogate`` under ``name``; returns its version.

        Versions auto-increment from 1 per name; an explicit ``version``
        may fill gaps but never overwrite (hot-swap means *new* version,
        old results must stay reproducible)."""
        if not name or "@" in name:
            raise ValueError(f"artifact name must be non-empty and "
                             f"'@'-free: {name!r}")
        if not isinstance(surrogate, dict) and not hasattr(surrogate,
                                                           "kinds"):
            surrogate = as_surrogate(surrogate)
        with self._lock:
            versions = self._artifacts.setdefault(name, {})
            if version is None:
                version = max(versions, default=0) + 1
            version = int(version)
            if version in versions:
                raise ValueError(
                    f"{name}@{version} already registered; surrogate "
                    "versions are immutable — register a new version")
            versions[version] = surrogate
        return version

    def register_path(self, name: str, path: str, *, version=None) -> int:
        """Register an on-disk ``.npz`` artifact lazily; returns version.

        The file is NOT read here: the first request that resolves this
        version loads it (through :func:`load_artifact`), so a truncated
        or corrupt file fails only that requesting caller — with a clean
        :class:`ArtifactError` naming ``name@version`` and the path —
        and never the registration, the server, or other artifacts. A
        successful load is cached in place; later resolves are free."""
        if not name or "@" in name:
            raise ValueError(f"artifact name must be non-empty and "
                             f"'@'-free: {name!r}")
        with self._lock:
            versions = self._artifacts.setdefault(name, {})
            if version is None:
                version = max(versions, default=0) + 1
            version = int(version)
            if version in versions:
                raise ValueError(
                    f"{name}@{version} already registered; surrogate "
                    "versions are immutable — register a new version")
            versions[version] = _LazyArtifact(path)
        return version

    def resolve(self, ref: str, *, device=None) -> tuple:
        """``"name[@version]"`` -> ((name, version), surrogate).

        A bare name resolves to the LATEST version at call time — the
        hot-swap default — while the pinned identity is returned so a
        request's records stay attributed to the exact artifact that
        produced them. Path-registered entries load on first resolve
        (outside the store lock; see :meth:`register_path`) onto
        ``device`` (default ``cuda``) and raise :class:`ArtifactError` to
        THIS caller when the file is corrupt."""
        name, version = parse_ref(ref)
        with self._lock:
            versions = self._artifacts.get(name)
            if not versions:
                raise KeyError(f"no surrogate registered under {name!r}")
            if version is None:
                version = max(versions)
            if version not in versions:
                raise KeyError(f"{name}@{version} not registered "
                               f"(have {sorted(versions)})")
            entry = versions[version]
        if isinstance(entry, _LazyArtifact):
            loaded = load_artifact(entry.path, name=name, version=version,
                                   device=device)
            with self._lock:
                # another resolver may have raced the load; first one wins
                # so every request sees ONE loaded object
                entry = self._artifacts[name][version]
                if isinstance(entry, _LazyArtifact):
                    self._artifacts[name][version] = entry = loaded
        return (name, version), entry

    def get(self, name: str, version=None, *, device=None):
        ref = name if version is None else f"{name}@{version}"
        return self.resolve(ref, device=device)[1]

    def names(self) -> list:
        with self._lock:
            return sorted(self._artifacts)

    def versions(self, name: str) -> list:
        with self._lock:
            return sorted(self._artifacts.get(name, ()))
