"""The GBDT walk kernel (``kernels/gbdt_walk.py``, ``csrc/gbdt_walk.cu``).

On the CPU: the entry point's plain route against the eager walk it
replaced (``surrogate._predict_gbdt`` with the fused-kernel switch off),
bit for bit, on both committed artifacts' M_ES heads and on random
forests of depth 1-8 with ties, padded ``+inf`` thresholds and NaN
features; the dry route; the switch; the table conversion's range check
and cache; and the C interface against the wrapper's ctypes signature.

On the card (marked ``cuda``, skipped without one): the kernel against
the plain version, bit for bit where the leaves are integers (such sums
are exact in any order, so equal outputs mean equal leaves), and at the
head tolerance on the artifacts at the main path's shapes, through both
the shared-memory and the global-table instance.
"""

from __future__ import annotations

import ctypes
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import surrogate as sur_mod  # noqa: E402
from repro_torch.kernels import gbdt_walk, ops  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ART = ROOT / "src" / "repro_torch" / "artifacts"
CSRC = pathlib.Path(gbdt_walk.__file__).resolve().parent / "csrc"
# the artifacts' M_ES rows: LIF idle / active rows, crossbar rows
ARTIFACT_F = {"lif_unpackable": 10, "crossbar_unpackable": 68}
RTOL = 1e-5


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return ops.resolve_device("cuda")


def _forest(seed, trees, depth, f, *, leaves="normal"):
    """A complete random forest as numpy arrays, thresholds drawn from a
    few small integers (so rows tie them) with a tenth of them +inf (a
    padded split; the last node of tree 0 always); leaves normal, or
    integers where ``leaves="int"``."""
    rng = np.random.default_rng(seed)
    nodes = (1 << depth) - 1
    feat = rng.integers(0, f, (trees, nodes)).astype(np.int32)
    thr = rng.integers(-2, 3, (trees, nodes)).astype(np.float32)
    thr[rng.random((trees, nodes)) < 0.1] = np.inf
    thr[0, -1] = np.inf
    if leaves == "int":
        leaf = rng.integers(-1000, 1000, (trees, nodes + 1))
    else:
        leaf = rng.normal(0, 1, (trees, nodes + 1))
    return {"feat": feat, "thr": thr, "leaf": leaf.astype(np.float32),
            "base": np.float32(rng.normal())}


def _rows(seed, n, f):
    """Rows of small integers and halves (many tie a threshold exactly)
    with NaN features."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-6, 7, (n, f)) / 2).astype(np.float32)
    x[rng.random((n, f)) < 0.05] = np.nan
    return x


def _torch(arrays, device="cpu"):
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in arrays.items()}


def _artifact(name, device="cpu"):
    from repro_torch.core.surrogate import Surrogate
    return Surrogate.load(str(ART / f"{name}.npz"), device=device)


def _artifact_rows(a, n, f, seed):
    """Rows around the head's own thresholds: each feature drawn from the
    finite thresholds that split on it, a third of them nudged off."""
    rng = np.random.default_rng(seed)
    feat = a["feat"].cpu().numpy().ravel()
    thr = a["thr"].cpu().numpy().ravel()
    x = rng.normal(0, 1, (n, f)).astype(np.float32)
    for j in range(f):
        cand = thr[(feat == j) & np.isfinite(thr)]
        if cand.size:
            col = rng.choice(cand, n)
            nudge = rng.random(n) < 1 / 3
            col[nudge] = col[nudge] * np.float32(1 + 1e-3)
            x[:, j] = col
    return x


def _walk(x, tables):
    return ops.gbdt_walk(x, *gbdt_walk.forest(
        tables["feat"], tables["thr"], tables["leaf"], tables["base"],
        x.shape[1]))


# --- the CPU: the plain route, the dry route, the switch ----------------------

@pytest.mark.parametrize("name", sorted(ARTIFACT_F))
@pytest.mark.parametrize("n", [0, 1, 257])
def test_plain_route_equals_the_eager_walk_on_the_artifacts(name, n):
    a = _artifact(name).params["M_ES"]
    f = ARTIFACT_F[name]
    x = torch.as_tensor(_artifact_rows(a, n, f, seed=n + f))
    if n:
        x[0, 0] = float("nan")
    want = sur_mod._predict_gbdt(a, x, False, {})
    got = _walk(x, a)
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert torch.equal(got, want)


@pytest.mark.parametrize("depth", range(1, 9))
@pytest.mark.parametrize("n", [0, 1, 257])
def test_plain_route_equals_the_eager_walk_on_random_forests(depth, n):
    f = 7
    a = _torch(_forest(depth, trees=5 + depth, depth=depth, f=f))
    x = torch.as_tensor(_rows(100 * depth + n, n, f))
    want = sur_mod._predict_gbdt(a, x, False, {})
    assert torch.equal(_walk(x, a), want)
    # the cases the comparison must route as the eager walk does: ties,
    # +inf thresholds and NaN features all go left
    if n == 257:
        assert torch.isnan(x).any() and torch.isinf(a["thr"]).any()
        assert torch.isin(x, a["thr"]).any()


def test_ties_nan_and_inf_go_left():
    """One depth-1 tree: right only where the row exceeds the threshold."""
    a = _torch({"feat": np.zeros((2, 1), np.int32),
                "thr": np.array([[0.5], [np.inf]], np.float32),
                "leaf": np.array([[1, 10], [100, 1000]], np.float32),
                "base": np.float32(0)})
    x = torch.tensor([[0.5], [0.75], [np.nan], [np.inf], [-np.inf]])
    assert _walk(x, a).tolist() == [101.0, 110.0, 101.0, 110.0, 101.0]


def test_dry_route_records_work_and_moves_no_counter():
    a = _artifact("lif_unpackable").params["M_ES"]
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in a.items()}
    tables = gbdt_walk.forest(meta["feat"], meta["thr"], meta["leaf"],
                              meta["base"], 10)
    x = torch.empty((1_280_000, 10), device="meta")
    seen, before = [], dict(ops.LAUNCHES)
    with ops.dry_run(lambda name, w: seen.append((name, w))):
        out = ops.gbdt_walk(x, *tables)
    assert out.device.type == "meta" and out.shape == (1_280_000,)
    assert ops.LAUNCHES == before
    want = gbdt_walk.work(1_280_000, 10, 44, 8)
    assert seen == [("gbdt_walk", want)]
    assert want.flops == 1_280_000 * 44 * 9
    assert want.bytes == (1_280_000 * 11 * 4 + 44 * 255 * 8 + 44 * 256 * 4
                          + 4)


def _predict_heads_kernels(sur, x, fused_kernel):
    with ops.dispatch_scope() as log:
        out = sur.predict_heads(feats_idle=x, heads={"idle": ("M_ES",)},
                                augmented=True, fused_kernel=fused_kernel)
    return out["idle"]["M_ES"], [n for n in log if n.startswith("kernel:")]


def test_switch_off_keeps_the_eager_walk():
    """``fused_kernel=False`` walks eagerly (no kernel entry, no launch);
    on, one ``gbdt_walk`` a head call; the CPU's answers are the same."""
    sur = _artifact("lif_unpackable")
    x = torch.as_tensor(_artifact_rows(sur.params["M_ES"], 300, 10, 3))
    before = dict(ops.LAUNCHES)
    off, k_off = _predict_heads_kernels(sur, x, False)
    on, k_on = _predict_heads_kernels(sur, x, True)
    assert k_off == [] and k_on == ["kernel:gbdt_walk"]
    assert ops.LAUNCHES == before
    assert torch.equal(off, on)
    assert sur._forests["M_ES"].keys() == {10}


def test_tables_convert_once_a_head(monkeypatch):
    """The head's tables are converted at its first walk and reused by
    every later one, through ``predict`` and ``predict_heads`` alike."""
    sur = _artifact("lif_unpackable")
    calls = []
    real = gbdt_walk.forest
    monkeypatch.setattr(gbdt_walk, "forest",
                        lambda *a: calls.append(a[-1]) or real(*a))
    x = torch.as_tensor(_artifact_rows(sur.params["M_ES"], 20, 10, 4))
    for _ in range(3):
        sur.predict_heads(feats_idle=x, heads={"idle": ("M_ES",)},
                          augmented=True)
    sur.predict("M_ES", x[:, :9])
    assert calls == [10]
    feat, thr, leaf, base = sur._forests["M_ES"][10]
    assert feat.dtype == torch.int32 and feat.is_contiguous()
    assert (thr.dtype, leaf.dtype, base.shape) == (torch.float32,
                                                   torch.float32, ())


@pytest.mark.parametrize("bad", [-1, 10])
def test_feature_index_outside_the_row_is_refused(bad):
    a = _artifact("lif_unpackable").params["M_ES"]
    feat = a["feat"].clone()
    feat[3, 17] = bad
    with pytest.raises(ValueError, match="outside rows of 10 features"):
        gbdt_walk.forest(feat, a["thr"], a["leaf"], a["base"], 10)
    # and through the head: rows narrower than its widest feature
    with pytest.raises(ValueError, match="outside rows of 9 features"):
        sur_mod._predict_gbdt(a, torch.zeros((4, 9)), True, {})


def test_incomplete_trees_are_refused():
    a = _torch(_forest(0, trees=3, depth=3, f=4))
    with pytest.raises(ValueError, match="complete tree"):
        gbdt_walk.forest(a["feat"][:, :6], a["thr"][:, :6], a["leaf"],
                         a["base"], 4)


def test_launch_signature_matches_the_source():
    """``gbdt_walk_launch``'s parameters, parsed from the source, against
    the wrapper's ctypes ``argtypes`` (pointers c_void_p)."""
    src = (CSRC / "gbdt_walk.cu").read_text()
    m = re.search(r"\bint gbdt_walk_launch\(([^)]*)\)", src)
    assert m, "gbdt_walk_launch not found"
    params = [p.strip() for p in m.group(1).split(",")]
    got = [ctypes.c_void_p if "*" in p else
           {"int": ctypes.c_int}[p.rsplit(" ", 1)[0]] for p in params]
    assert got == gbdt_walk.ARGTYPES
    names = [p.rsplit(" ", 1)[1].lstrip("*") for p in params]
    assert names == ["x", "feat", "thr", "leaf", "base", "out", "n", "f",
                     "trees", "depth", "device", "stream"]
    assert "constexpr int kDepth = 8;" in src


def test_a_cpu_route_needs_every_argument_on_the_cpu():
    """A tensor off the CPU sends the call to the launcher, which refuses
    anything but one CUDA device and counts no launch."""
    a = _torch(_forest(1, trees=2, depth=2, f=3))
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        ops.gbdt_walk(torch.empty((4, 3), device="meta"), a["feat"],
                      a["thr"], a["leaf"], a["base"])
    assert ops.LAUNCHES == before


# --- the card -----------------------------------------------------------------

def _kernel_vs_plain(dev, a, x):
    tables = gbdt_walk.forest(a["feat"], a["thr"], a["leaf"], a["base"],
                              x.shape[1])
    before = ops.LAUNCHES["gbdt_walk"]
    got = ops.gbdt_walk(x, *tables)
    torch.cuda.synchronize(dev)
    assert ops.LAUNCHES["gbdt_walk"] == before + (1 if x.shape[0] else 0)
    want = gbdt_walk.gbdt_plain(x, a["feat"], a["thr"], a["leaf"], a["base"])
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("trees, depth, f, n, shared", [
    (44, 8, 10, 100_003, True), (31, 8, 68, 20_011, True),
    (5, 1, 3, 257, True), (9, 3, 7, 1, True), (13, 5, 12, 4_099, True),
    (44, 8, 300, 3_001, False), (300, 8, 10, 50_001, False),
    (7, 6, 300, 1_025, False)])
def test_kernel_equals_plain_on_integer_leaves(card, trees, depth, f, n,
                                               shared):
    """Integer leaves sum exactly in any order, so equal outputs mean every
    (row, tree) reached the plain version's leaf; ties, +inf thresholds
    and NaN features included, in both instances."""
    assert gbdt_walk.shared(f, trees, depth) is shared
    arrays = _forest(trees + depth + f, trees, depth, f, leaves="int")
    arrays["base"] = np.float32(round(float(arrays["base"])))
    a = _torch(arrays, card)
    x = torch.as_tensor(_rows(n, n, f), device=card)
    got, want = _kernel_vs_plain(card, a, x)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name, n", [
    ("lif_unpackable", 1_280_000), ("lif_unpackable", 312_000),
    ("crossbar_unpackable", 1_280_000), ("crossbar_unpackable", 312_000)])
def test_kernel_matches_plain_on_the_artifacts(card, name, n):
    """The artifacts' M_ES at the main path's row counts, at the head
    tolerance: rtol 1e-5 with an atol at 1e-5 of the field's scale (the
    kernel sums in fp64 and rounds once, the plain version in fp32)."""
    a = _artifact(name, card).params["M_ES"]
    f = ARTIFACT_F[name]
    x = torch.as_tensor(_artifact_rows(a, n, f, seed=n), device=card)
    got, want = _kernel_vs_plain(card, a, x)
    g, w = got.double().cpu().numpy(), want.double().cpu().numpy()
    atol = 1e-5 * float(np.max(np.abs(w)))
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol)


@pytest.mark.cuda
def test_empty_rows_launch_nothing(card):
    a = _torch(_forest(2, trees=4, depth=3, f=5), card)
    got, want = _kernel_vs_plain(card, a, torch.empty((0, 5), device=card))
    assert got.shape == want.shape == (0,)
