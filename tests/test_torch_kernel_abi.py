"""The golden and head kernels' C interface and launch plan, checked on
the CPU.

``lif_step.cu``, ``crossbar_step.cu`` and ``mlp_heads.cu`` are compiled
only where there is a card; their wrappers pass arguments through
``ctypes``. These tests
parse the sources and hold the wrappers' ctypes signatures and constants
to them, pin the crossbar's launch plan at the main path's shapes, and
check that a tensor the kernels do not take is refused before any launch.
The kernels' generic instances (a runtime substep count, rows narrower
than 32) are held on the card against the plain versions at those
circuits; here the plain versions at those circuits are held against the
JAX circuits, at the tolerances of ``test_torch_lif.py`` /
``test_torch_crossbar.py``.
"""

from __future__ import annotations

import ctypes
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core.circuits import CrossbarRow, LIFNeuron  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    crossbar_mvm, lif_scan, mlp_surrogate, ops)
from test_torch_crossbar import (  # noqa: E402
    BAND, _rows as _xbar_rows, _settle_margins)
from test_torch_fixtures import assert_close  # noqa: E402
from test_torch_lif import _assert_step_match, _inputs  # noqa: E402

CSRC = pathlib.Path(lif_scan.__file__).resolve().parent / "csrc"
C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


def _source(name):
    return (CSRC / f"{name}.cu").read_text()


def _params(src, fn):
    """ctypes of each parameter of ``int fn(...)``: pointers c_void_p."""
    m = re.search(rf"\bint {fn}\(([^)]*)\)", src)
    assert m, f"{fn} not found"
    out = []
    for param in m.group(1).split(","):
        ctype = param.strip().rsplit(" ", 1)[0]
        out.append(ctypes.c_void_p if "*" in param else C_TYPES[ctype])
    return out


def _constexpr(src, name):
    return int(re.search(rf"constexpr int {name} = (\w+)", src).group(1))


@pytest.mark.parametrize("name", ["lif_step", "lif_chunk"])
def test_lif_argtypes_match_the_source(name):
    want = lif_scan.ARGTYPES[name]
    assert _params(_source("lif_step"), f"{name}_launch") == want
    # the nine floats are _consts, in order
    assert want.count(ctypes.c_float) == len(lif_scan._consts(LIFNeuron()))


def test_lif_chunk_launch_takes_v_seq_after_the_observables():
    """lif_chunk_launch's ninth pointer is v_seq (null: not recorded), the
    order ``_launch_chunk`` passes it in; the kernel stores it only in its
    recording instance."""
    src = _source("lif_step")
    m = re.search(r"\bint lif_chunk_launch\(([^)]*)\)", src)
    names = [p.strip().rsplit(" ", 1)[1].lstrip("*")
             for p in m.group(1).split(",")]
    assert names[:9] == ["state", "x_seq", "params", "new_state", "out",
                         "energy", "latency", "spiked", "v_seq"]
    assert "if (kRecordV) v_seq[r] = v;" in src
    assert "lif_chunk_kernel<S, false>" in src and "nullptr" in src


@pytest.mark.parametrize("fn, want", [
    ("crossbar_target_launch", crossbar_mvm.TARGET_ARGTYPES),
    ("crossbar_step_launch", crossbar_mvm.STEP_ARGTYPES)])
def test_crossbar_argtypes_match_the_source(fn, want):
    assert _params(_source("crossbar_step"), fn) == want


@pytest.mark.parametrize("name", ["mlp_heads", "mlp_surrogate"])
def test_mlp_argtypes_match_the_source(name):
    """mlp_surrogate_launch takes x as fp32 or bf16 rows and a flag that
    says which; the wrapper's ctypes signature follows the source."""
    assert (_params(_source("mlp_heads"), f"{name}_launch")
            == mlp_surrogate.ARGTYPES[name])


def test_xbar_consts_match_the_source():
    body = re.search(r"struct XbarConsts \{(.*?)\};", _source("crossbar_step"),
                     re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if decl:
            ctype, names = decl.split(" ", 1)
            fields += [(n.strip(), C_TYPES[ctype]) for n in names.split(",")]
    assert crossbar_mvm._XbarConsts._fields_ == fields


def test_python_constants_match_the_sources():
    lif, xbar = _source("lif_step"), _source("crossbar_step")
    assert _constexpr(lif, "kSubsteps") == LIFNeuron().n_substeps
    assert _constexpr(xbar, "kMaxIn") == crossbar_mvm.MAX_IN
    assert _constexpr(xbar, "kMaxTile") == crossbar_mvm.TILE_ROWS
    assert _constexpr(xbar, "kSubsteps") == CrossbarRow().n_substeps
    # BLOCKS_PER_SM blocks of 128-row tiles (w dense at 33 floats, v at a
    # pitch of 36) fit in an SM's 228 KB with 1 KB reserved per block
    pitch = crossbar_mvm.MAX_IN + 4
    assert "kPitchV = kMaxIn + 4" in xbar
    tile = crossbar_mvm.TILE_ROWS * (crossbar_mvm.MAX_IN + 1 + pitch) * 4
    assert crossbar_mvm.BLOCKS_PER_SM * (tile + 1024) <= 228 * 1024


@pytest.mark.parametrize("n, want", [
    # the main path's shapes: crossbar MNIST's three layers, the mixed net
    (312000, (128, 132 * 6)), (67200, (128, 525)), (6000, (32, 188)),
    (7680, (32, 240)),
    # 128-row tiles once every SM gets one, 32 below; at most 6 blocks of
    # 128 rows an SM (as many warps in 32-row blocks); at least one block
    (312037, (128, 132 * 6)), (16896, (128, 132)), (16895, (32, 528)),
    (12837, (32, 402)), (12800, (32, 400)), (1000, (32, 32)),
    (640, (32, 20)), (7, (32, 1)), (1, (32, 1)), (0, (32, 1))])
def test_crossbar_plan_sizes_tiles_by_n(n, want):
    tile_rows, grid = crossbar_mvm.plan(n, 132)
    assert (tile_rows, grid) == want
    # what crossbar_step.cu's takes() admits, and no block without a tile
    assert tile_rows in (crossbar_mvm.SMALL_TILE_ROWS, crossbar_mvm.TILE_ROWS)
    assert 1 <= grid <= max(1, -(-n // tile_rows))
    assert grid * tile_rows <= 132 * crossbar_mvm.BLOCKS_PER_SM * 128


@pytest.mark.parametrize("entry", ["crossbar_target", "crossbar_step"])
def test_crossbar_on_a_non_cpu_tensor_never_falls_back(entry):
    """A tensor that is not on the CPU goes to the kernel launcher, which
    refuses anything but one CUDA device and counts no launch."""
    n = 4
    v = torch.empty((n, 32), device="meta")
    w = torch.empty((n, 33), device="meta")
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        if entry == "crossbar_target":
            ops.crossbar_target(v, w)
        else:
            ops.crossbar_step(torch.empty((n, 1), device="meta"), v, w)
    assert ops.LAUNCHES == before


def _rows(n, offset=0):
    """(v (n, 32), w (n, 33)), contiguous, each ``offset`` floats past the
    start of its own allocation."""
    return tuple(torch.zeros(n * k + offset)[offset:].view(n, k)
                 for k in (32, 33))


def test_crossbar_checks_take_aligned_contiguous_rows():
    v, w = _rows(8)
    assert crossbar_mvm._check_rows(CrossbarRow(), v, w) == (8, 32)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_crossbar_checks_refuse_misaligned_rows(offset):
    """v or w starting 4, 8 or 12 bytes past a 16-byte boundary: the
    kernels' 16-byte asynchronous copies cannot take it, and the wrapper
    says so before any launch."""
    v, w = _rows(8, offset)
    good_v, good_w = _rows(8)
    assert v.data_ptr() % 16 == w.data_ptr() % 16 == 4 * offset
    for args in ((v, good_w), (good_v, w)):
        with pytest.raises(ValueError, match="16-byte-aligned"):
            crossbar_mvm._check_rows(CrossbarRow(), *args)


def test_crossbar_checks_refuse_non_contiguous_rows():
    v, w = _rows(8)
    with pytest.raises(ValueError, match="contiguous"):
        crossbar_mvm._check_rows(CrossbarRow(), torch.zeros(32, 8).t(), w)
    with pytest.raises(ValueError, match="contiguous"):
        crossbar_mvm._check_rows(CrossbarRow(), v, torch.zeros(33, 8).t())


def test_crossbar_checks_refuse_rows_wider_than_the_kernel():
    wide = CrossbarRow(n_inputs=33)
    with pytest.raises(ValueError, match="n_in <= 32"):
        crossbar_mvm._check_rows(wide, torch.zeros(4, 33),
                                 torch.zeros(4, 34))


def _lif_circuit_step(circ, state, x, params):
    from repro.core.circuits import LIFNeuron as JaxNeuron
    ws, wo = jax.jit(JaxNeuron(n_substeps=circ.n_substeps).step)(
        jnp.asarray(state), jnp.asarray(x), jnp.asarray(params))
    return np.asarray(ws), {k: np.asarray(v) for k, v in wo.items()}


@pytest.mark.parametrize("n", [5, 300])
def test_lif_generic_substeps_match_circuit_step(n):
    """LIFNeuron(n_substeps=32), which the kernels run through their
    generic instance: the plain period against the JAX circuit."""
    circ = LIFNeuron(n_substeps=32)
    state, x, params = _inputs(n, seed=2000 + n)
    ns, obs = ops.lif_step(*map(torch.as_tensor, (state, x, params)),
                           circ=circ)
    got = (ns.numpy(), {k: v.numpy() for k, v in obs.items()})
    assert got[1]["spiked"].any()
    _assert_step_match(got, _lif_circuit_step(circ, state, x, params))


@pytest.mark.parametrize("n", [5, 517])
@pytest.mark.parametrize("fields", [
    {"n_inputs": 16}, {"n_substeps": 32}, {"n_inputs": 16, "n_substeps": 32}],
    ids=["n_in16", "sub32", "n_in16_sub32"])
def test_crossbar_generic_rows_match_circuit(fields, n):
    """The crossbar circuits only the kernels' generic instances take:
    the plain target and period against the JAX circuit's, rows of
    ``n_inputs`` inputs and their bias column."""
    from repro.core.circuits import CrossbarRow as JaxRow
    circ, jrow = CrossbarRow(**fields), JaxRow(**fields)
    state, v, w = _xbar_rows(n, seed=3000 + n)
    k = circ.n_inputs
    v = np.ascontiguousarray(v[:, :k])
    w = np.ascontiguousarray(np.concatenate([w[:, :k], w[:, -1:]], 1))
    tgt, tau = ops.crossbar_target(*map(torch.as_tensor, (v, w)), circ=circ)
    want_tgt, want_tau = jax.jit(jrow._target)(jnp.asarray(v), jnp.asarray(w))
    assert_close(tgt.numpy(), want_tgt, "v_tgt")
    assert_close(tau.numpy(), want_tau, "tau")
    new_state, obs = ops.crossbar_step(*map(torch.as_tensor, (state, v, w)),
                                       circ=circ)
    ws, wo = jax.jit(jrow.step)(jnp.asarray(state), jnp.asarray(v),
                                jnp.asarray(w))
    margin, spike_margin = _settle_margins(state, v, w, circ)
    for name, near in (("spiked", spike_margin <= BAND),
                       ("latency", margin <= BAND)):
        diff = obs[name].numpy() != np.asarray(wo[name])
        assert not (diff & ~near).any(), (name, np.flatnonzero(diff & ~near))
    assert_close(new_state.numpy(), ws, "state")
    assert_close(obs["energy"].numpy(), wo["energy"], "energy")
    assert (obs["latency"].numpy() < circ.clock_ns).any()
