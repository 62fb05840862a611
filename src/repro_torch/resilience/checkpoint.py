"""Stream checkpoint/resume: chunk-boundary carry snapshots (port of
``repro.resilience.checkpoint``).

A :class:`StreamCheckpoint` holds what a killed stream needs to continue
bit-identically: the per-layer carries and previous outputs at a chunk
boundary, the tick offset ``k0``, and every chunk already emitted folded
into one partial :class:`~repro_torch.core.network.NetworkRun`. It saves as
one versioned ``.npz`` — arrays plus a JSON ``__manifest__`` — with the
reference's keys and manifest, and its carry leaves in the reference's
pytree flatten order (layer by layer: ``(state, params)`` golden,
``(v, params)`` behavioral, ``LasanaState(v, o, t_last, params)`` lasana),
so a checkpoint taken by either package resumes in the other.

Checkpoints sit at chunk boundaries, so a resumed tail re-chunks exactly
and reuses the engine's stream and flush runners: kill, ``lasana.resume``
on a warm engine, and the merged record equals the uninterrupted run bit
for bit with nothing built.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List

import numpy as np

from repro_torch.core.network import NetworkRun

CKPT_FORMAT_VERSION = 1


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def spec_key_of(spec) -> str:
    """Content hash binding a checkpoint to its NetworkSpec: the serving
    layer's :func:`~repro_torch.serve.buckets.spec_content_key`, the same
    digest the reference's checkpoints carry."""
    from repro_torch.serve.buckets import spec_content_key
    return spec_content_key(spec)


@dataclasses.dataclass
class StreamCheckpoint:
    """Resumable snapshot of a streaming run at a chunk boundary.

    k0            ticks consumed when the snapshot was taken
    chunk_ticks   the stream's chunk size (resume must reuse it so the
                  tail re-chunks identically)
    batch         stimulus batch width
    spec_key      content hash of the NetworkSpec (resume validates it)
    backend/mode/record_hidden  engine configuration at snapshot time
    carry_leaves  flattened per-layer carry pytree leaves (host arrays)
    prev_ys       per-layer previous-output buffers (host arrays)
    acc_run       ticks ``[0, k0)`` folded to one partial NetworkRun
                  (its ``flush_energy`` is zero — flush charges once, at
                  the true stream end, on the resumed side)
    """

    k0: int
    chunk_ticks: int
    batch: int
    spec_key: str
    backend: str
    mode: str
    record_hidden: bool
    carry_leaves: List[np.ndarray]
    prev_ys: List[np.ndarray]
    acc_run: NetworkRun

    # --- persistence ----------------------------------------------------------

    def save(self, path: str) -> str:
        """Write one versioned ``.npz`` (path may omit the extension)."""
        path = _npz_path(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        run = self.acc_run
        arrays = {f"carry/{i}": np.asarray(a)
                  for i, a in enumerate(self.carry_leaves)}
        for i, p in enumerate(self.prev_ys):
            arrays[f"prev/{i}"] = np.asarray(p)
        arrays["acc/outputs"] = np.asarray(run.outputs)
        if run.out_spikes is not None:
            arrays["acc/out_spikes"] = np.asarray(run.out_spikes)
        if run.layer_spikes is not None:
            for i, h in enumerate(run.layer_spikes):
                arrays[f"acc/hidden/{i}"] = np.asarray(h)
        arrays["acc/energy"] = np.asarray(run.energy)
        arrays["acc/latency"] = np.asarray(run.latency)
        arrays["acc/events"] = np.asarray(run.events)
        arrays["acc/flush_energy"] = np.asarray(run.flush_energy)
        arrays["acc/n_circuits"] = np.asarray(run.n_circuits)
        manifest = {
            "format_version": CKPT_FORMAT_VERSION,
            "kind": "stream_checkpoint",
            "k0": int(self.k0),
            "chunk_ticks": int(self.chunk_ticks),
            "batch": int(self.batch),
            "spec_key": self.spec_key,
            "backend": self.backend,
            "mode": self.mode,
            "record_hidden": bool(self.record_hidden),
            "n_carry_leaves": len(self.carry_leaves),
            "n_layers": len(self.prev_ys),
            "n_hidden": (len(run.layer_spikes)
                         if run.layer_spikes is not None else -1),
            "has_out_spikes": run.out_spikes is not None,
            "circuits": list(run.circuits),
            "clock_ns": float(run.clock_ns),
            "wall_seconds": float(run.wall_seconds),
            "compile_seconds": float(run.compile_seconds),
        }
        arrays["__manifest__"] = np.frombuffer(
            json.dumps(manifest).encode(), dtype=np.uint8)
        np.savez_compressed(path, **arrays)
        return path

    @classmethod
    def load(cls, path: str) -> "StreamCheckpoint":
        """Load a checkpoint saved by :meth:`save` (extension optional).

        Raises ``FileNotFoundError`` naming every path tried, and
        ``ValueError`` on a format-version mismatch or a non-checkpoint
        artifact — never a silent reinterpretation of arrays."""
        if not os.path.isfile(path):
            alt = _npz_path(path)
            if alt == path or not os.path.isfile(alt):
                tried = sorted({path, alt})
                raise FileNotFoundError(
                    "no stream checkpoint at "
                    + " or ".join(repr(p) for p in tried)
                    + " (expected an .npz written by StreamCheckpoint.save)")
            path = alt
        with np.load(path) as z:
            if "__manifest__" not in z.files:
                raise ValueError(f"{path}: not a StreamCheckpoint artifact "
                                 "(missing __manifest__)")
            meta = json.loads(bytes(z["__manifest__"].tobytes()).decode())
            if meta.get("kind") != "stream_checkpoint":
                raise ValueError(f"{path}: artifact kind "
                                 f"{meta.get('kind')!r} is not a "
                                 "stream checkpoint")
            version = meta.get("format_version")
            if version != CKPT_FORMAT_VERSION:
                raise ValueError(
                    f"{path}: checkpoint format version {version!r} is not "
                    f"supported (this build reads version "
                    f"{CKPT_FORMAT_VERSION}); re-checkpoint the stream")
            carry = [np.asarray(z[f"carry/{i}"])
                     for i in range(meta["n_carry_leaves"])]
            prev = [np.asarray(z[f"prev/{i}"])
                    for i in range(meta["n_layers"])]
            hidden = None
            if meta["n_hidden"] >= 0:
                hidden = [np.asarray(z[f"acc/hidden/{i}"])
                          for i in range(meta["n_hidden"])]
            run = NetworkRun(
                backend=meta["backend"], mode=meta["mode"],
                outputs=np.asarray(z["acc/outputs"]),
                out_spikes=(np.asarray(z["acc/out_spikes"])
                            if meta["has_out_spikes"] else None),
                layer_spikes=hidden,
                energy=np.asarray(z["acc/energy"]),
                latency=np.asarray(z["acc/latency"]),
                events=np.asarray(z["acc/events"]),
                flush_energy=np.asarray(z["acc/flush_energy"]),
                n_circuits=np.asarray(z["acc/n_circuits"]),
                clock_ns=meta["clock_ns"],
                wall_seconds=meta["wall_seconds"],
                circuits=tuple(meta["circuits"]),
                compile_seconds=meta["compile_seconds"])
        return cls(
            k0=meta["k0"], chunk_ticks=meta["chunk_ticks"],
            batch=meta["batch"], spec_key=meta["spec_key"],
            backend=meta["backend"], mode=meta["mode"],
            record_hidden=meta["record_hidden"],
            carry_leaves=carry, prev_ys=prev, acc_run=run)

    # --- validation -----------------------------------------------------------

    def verify_engine(self, engine, spec) -> None:
        """Fail loudly when a checkpoint is resumed against the wrong
        spec or a differently-configured engine (silent mismatch would
        surface as bitwise divergence much later)."""
        key = spec_key_of(spec)
        if key != self.spec_key:
            raise ValueError(
                f"checkpoint was taken on spec {self.spec_key[:12]}…, "
                f"resume target is {key[:12]}… — not the same network")
        if engine.backend != self.backend or engine.mode != self.mode:
            raise ValueError(
                f"checkpoint backend/mode {self.backend}/{self.mode} != "
                f"engine {engine.backend}/{engine.mode}")
        if bool(engine.record_hidden) != bool(self.record_hidden):
            raise ValueError(
                f"checkpoint record_hidden={self.record_hidden} != engine "
                f"record_hidden={engine.record_hidden}: the resumed tail "
                "would record different fields than the prefix")
