"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on its own, at first use, into
``build/repro_torch/<name>-<hash>/lib<name>.so`` under the repository
root, where ``<hash>`` covers the source and the flags — an edited source
rebuilds, an unchanged one is loaded as built. The sources have a plain C
interface (no PyTorch headers), so a build takes seconds; the hash also
covers the shared ``csrc/*.cuh`` headers. :func:`build_all`
starts one ``nvcc`` per source at once; :func:`library` builds or loads one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("crossbar_step", "flash_attn", "gbdt_walk", "lif_step",
           "mlp_heads", "network_tick")

# --fmad=false: a multiply and an add are never contracted into an FMA, so
# each kernel rounds its separate fp32 operations in the order of its plain
# version (the dot products use explicit __fmaf_rn, which stays fused)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ on a machine with the CUDA toolkit")


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}" / f"lib{name}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; None when it is built already."""
    so = _target(name)
    if so.exists():
        return None
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish(name: str, job) -> None:
    proc, tmp, so = job
    log, _ = proc.communicate()
    (so.parent / "nvcc.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, so)          # atomic: a reader never sees a partial .so


def build_all() -> float:
    """Build every source in parallel (one ``nvcc`` each); returns seconds."""
    t0 = time.time()
    with _LOCK:
        jobs = {n: _start(n) for n in SOURCES}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
    return time.time() - t0


def build_log(name: str) -> str:
    """The compiler's output for ``name`` (registers, shared memory,
    spills from ``-Xptxas -v``), or "" when it was built elsewhere."""
    log = _target(name).parent / "nvcc.log"
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return _LIBS[name]


def n_loaded() -> int:
    """How many kernel libraries this process has loaded (a call that
    raised it built or loaded one)."""
    return len(_LIBS)


def raise_on_error(lib: ctypes.CDLL, code: int, kernel: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        lib.repro_error_string.restype = ctypes.c_char_p
        lib.repro_error_string.argtypes = [ctypes.c_int]
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({code})")
