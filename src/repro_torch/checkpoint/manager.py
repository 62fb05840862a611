"""Atomic, asynchronous checkpoints of train states, the JAX package's
``checkpoint/manager.py`` (``:50-191``) in PyTorch, in its directory
format::

    step_0000100.tmp/         written first
      meta.json               treedef, shapes, dtypes, codec, user metadata
      leaf_00000.zst ...      one file per leaf: zstd-compressed bytes, or
                              ``.raw`` where ``zstandard`` is not installed
    -> renamed to step_0000100/   (the commit point)

Leaves are whole tensors in ``jax.tree.flatten`` order (dict keys sorted,
lists in order; ``repro_torch.tree``) with the reference's dtype strings,
so a checkpoint written by either package restores in the other. A
placed leaf (``sharding.Sharded``) is gathered whole before it is
written, and :meth:`CheckpointManager.restore` splits a leaf onto a mesh
where ``shardings`` gives it a ``sharding.Placement``: a checkpoint
crosses between sharded and unsharded states, and between meshes. A
bfloat16 leaf is stored as its 16-bit words under the dtype string
``"bfloat16"``, and read back as those words viewed as
``torch.bfloat16``: no ``ml_dtypes`` is needed on either side.

``save(..., blocking=False)`` copies the leaves to host memory on the
caller's thread (the train step updates its tensors in place, so the
copy must be taken before the next step) and writes them on a writer
thread; a write error is raised at the next :meth:`wait` or save. Half
written ``.tmp`` directories are ignored and removed; ``keep`` bounds the
committed steps.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.sharding import Placement, Sharded

try:                                    # optional: fall back to raw chunks
    import zstandard as zstd
except ImportError:                     # pragma: no cover - env dependent
    zstd = None


def _host(t) -> tuple:
    """``(numpy array, dtype string)`` of a leaf on the host; a bf16 tensor
    becomes its 16-bit words; a placed leaf is gathered whole."""
    if isinstance(t, Sharded):
        t = t.gather("cpu")
    if isinstance(t, torch.Tensor):
        # a copy even on the CPU: the step overwrites its tensors in place
        t = t.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(t)
    return a, str(a.dtype)


def _read_leaf(fname: str, dtype: str, shape, dctx) -> torch.Tensor:
    """One leaf file as a CPU tensor (raw bytes read in place)."""
    words = dtype == "bfloat16"
    npdt = np.dtype(np.int16) if words else np.dtype(dtype)
    with open(fname, "rb") as f:
        if dctx is None:
            a = np.empty(shape, dtype=npdt)
            f.readinto(memoryview(a.reshape(-1)).cast("B"))
        else:
            a = np.frombuffer(dctx.decompress(f.read()),
                              dtype=npdt).reshape(shape).copy()
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if words else t


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # --- discovery --------------------------------------------------------

    def steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # --- save ---------------------------------------------------------------

    def save(self, step: int, tree, *, metadata: Optional[dict] = None,
             blocking: bool = True):
        """Checkpoint a tree of tensors (or numpy arrays) at ``step``."""
        self.wait()
        leaves, treedef = tr.flatten(tree)
        host = [_host(x) for x in leaves]     # before the next step writes
        codec = "zstd" if zstd is not None else "raw"
        meta = {
            "step": step,
            "treedef": tr.describe(treedef),
            "n_leaves": len(host),
            "shapes": [list(a.shape) for a, _ in host],
            "dtypes": [d for _, d in host],
            "codec": codec,
            "user": metadata or {},
            "time": time.time(),
        }

        def write():
            try:
                tmp = os.path.join(self.dir, f"step_{step:07d}.tmp")
                final = os.path.join(self.dir, f"step_{step:07d}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                cctx = zstd.ZstdCompressor(level=3) if codec == "zstd" \
                    else None
                ext = "zst" if codec == "zstd" else "raw"
                for i, (arr, _) in enumerate(host):
                    raw = np.ascontiguousarray(arr).data
                    if cctx is not None:
                        raw = cctx.compress(raw)
                    with open(os.path.join(tmp, f"leaf_{i:05d}.{ext}"),
                              "wb") as f:
                        f.write(raw)
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)            # commit point
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._last_error = e

        if blocking:
            write()
            self._raise_if_failed()
        else:
            self._writer = threading.Thread(target=write, daemon=True)
            self._writer.start()

    def wait(self):
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise RuntimeError(f"async checkpoint write failed: {err}") from err

    def _gc(self):
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:07d}"),
                          ignore_errors=True)
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    # --- restore -----------------------------------------------------------

    def restore(self, step: int, like, *, shardings=None):
        """``(tree, user metadata)``: the checkpoint in the structure of
        ``like`` (tensors or meta tensors). Each leaf lands where
        ``shardings`` (a matching tree of devices and
        ``sharding.Placement`` s) says — split onto a mesh for a
        placement — else on its ``like`` leaf's device (the CPU for a meta
        tensor)."""
        path = os.path.join(self.dir, f"step_{step:07d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        leaves_like, treedef = tr.flatten(like)
        if len(leaves_like) != meta["n_leaves"]:
            raise ValueError(
                f"checkpoint has {meta['n_leaves']} leaves; target structure "
                f"has {len(leaves_like)}")
        codec = meta.get("codec", "zstd")
        if codec == "zstd" and zstd is None:
            raise RuntimeError(
                f"checkpoint {path} is zstd-compressed but the zstandard "
                "module is not installed")
        dctx = zstd.ZstdDecompressor() if codec == "zstd" else None
        ext = "zst" if codec == "zstd" else "raw"
        devices = tr.leaves(shardings) if shardings is not None else [
            getattr(x, "device", None) for x in leaves_like]
        out = []
        for i, dev in enumerate(devices):
            t = _read_leaf(os.path.join(path, f"leaf_{i:05d}.{ext}"),
                           meta["dtypes"][i], meta["shapes"][i], dctx)
            if isinstance(dev, Placement):
                t = dev.place(t)
            elif dev is not None and torch.device(dev).type != "meta":
                t = t.to(dev)
            out.append(t)
        return tr.unflatten(treedef, out), meta["user"]

    def restore_latest(self, like, *, shardings=None):
        step = self.latest_step()
        if step is None:
            return None
        tree, user = self.restore(step, like, shardings=shardings)
        return step, tree, user
