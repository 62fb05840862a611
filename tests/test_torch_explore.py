"""Design-space exploration (``repro_torch.core.explore`` and
``repro_torch.lasana.explore``) against the reference's
(``repro.core.explore``).

``CandidateSpec`` draws with numpy in both packages, so the candidates are
identical; the tile table is exact int64 host math, equal bit for bit. The
surrogate pass runs on the same base rows in both packages (the
reference engine's ``_base_*`` arrays set on the port's engine) at C = 64
candidates x 32 samples; tile energies, latencies and energies per token
agree within rtol 1e-5 and the Pareto masks are identical. ``explore_arch``
walks the port's ``Model(cfg).param_specs()`` in the reference's key
order for all ten configs. The committed DSE record
(``dse_ref_record.npz``) is checked at the chip phase's shapes and its
first candidates and the ten full configs are priced again in the port.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_fixtures as fx  # noqa: E402
from repro_torch.core.explore import _CANDIDATE_FIELDS  # noqa: E402
from test_torch_fixtures import assert_close  # noqa: E402

C, N_SAMPLES = 64, 32
ARCHS = fx.DSE_ARCHS
FIELDS = [name for name, _, _ in _CANDIDATE_FIELDS]


@functools.cache
def _surrogates(path=fx.XBAR_UNPACKABLE):
    from repro.core.surrogate import Surrogate as JaxSurrogate
    from repro_torch.core.surrogate import Surrogate
    return JaxSurrogate.load(str(path)), Surrogate.load(str(path),
                                                        device="cpu")


@functools.cache
def _record():
    with np.load(fx.DSE_RECORD) as z:
        return {k: z[k] for k in z.files}


def _tile_rows():
    """tile_energy_latency's 2,048 rows as the reference draws them."""
    rec = _record()
    return (torch.as_tensor(rec["tile_x"]),
            torch.as_tensor(rec["tile_p"].astype(np.float32)),
            torch.as_tensor(rec["tile_o"]))


def _engines(n_samples=N_SAMPLES):
    """(reference engine, port engine on the CPU with its base rows)."""
    from repro.core.explore import DSEEngine as RefEngine
    from repro_torch.core.explore import DSEEngine
    ref = RefEngine(n_samples=n_samples)
    eng = DSEEngine(n_samples=n_samples, device="cpu")
    eng._base_x, eng._base_p, eng._base_o = (
        torch.as_tensor(np.array(a, np.float32))
        for a in (ref._base_x, ref._base_p, ref._base_o))
    return ref, eng


def assert_same_candidates(got, want):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# --- CandidateSpec ------------------------------------------------------------

def test_candidate_spec_constructors_equal_reference():
    from repro.core.explore import CandidateSpec as Ref
    from repro_torch.core.explore import CandidateSpec
    assert_same_candidates(CandidateSpec.of(), Ref.of())
    assert_same_candidates(CandidateSpec.of(d_model=[128, 256, 512],
                                            v_dd=1.0, tile=64),
                           Ref.of(d_model=[128, 256, 512], v_dd=1.0,
                                  tile=64))
    grid = dict(d_model=[256, 512], tile=[16, 32, 64], v_dd=[0.9, 1.2])
    g, rg = CandidateSpec.grid(**grid), Ref.grid(**grid)
    assert len(g) == 12
    assert_same_candidates(g, rg)
    assert_same_candidates(g.take([0, 5, 11]), rg.take([0, 5, 11]))
    assert g.row(7) == rg.row(7)
    for kw in (dict(seed=0), dict(seed=7, moe_fraction=0.9,
                                  v_dd_range=(1.0, 1.1))):
        s = CandidateSpec.sample(257, **kw)
        assert_same_candidates(s, Ref.sample(257, **kw))
        assert len(s) == 257


@pytest.mark.parametrize("bad,err", [
    (dict(d_model=[[128, 256]]), ValueError),
    (dict(d_model=[128, 256], n_layers=[2, 4, 6]), ValueError),
    (dict(d_model=0), ValueError),
    (dict(tile=[32, 0]), ValueError),
    (dict(v_dd=[1.0, -0.1]), ValueError),
    (dict(n_experts=8, top_k=16), ValueError),
    (dict(n_experts=8, top_k=0), ValueError),
    (dict(d_modell=128), TypeError),
])
def test_candidate_spec_validation_equals_reference(bad, err):
    from repro.core.explore import CandidateSpec as Ref
    from repro_torch.core.explore import CandidateSpec
    with pytest.raises(err) as want:
        Ref.of(**bad)
    with pytest.raises(err) as got:
        CandidateSpec.of(**bad)
    assert str(got.value) == str(want.value)


# --- the tile table -------------------------------------------------------------

def test_tile_table_matches_hand_formula():
    from repro_torch.core.explore import CandidateSpec, _tile_table
    c = CandidateSpec.of(d_model=96, d_ff=200, n_layers=3, n_heads=3,
                         n_kv_heads=1, tile=32, vocab=1000)
    tt = _tile_table(c)
    dh = 96 // 3
    td, tf, tkv = 3, 7, 1                       # ceil(96/32), ceil(200/32)
    attn = 2 * td * td + 2 * td * tkv
    ffn = 3 * td * tf
    assert tt["n_tiles"][0] == 3 * (attn + ffn)
    assert tt["stages"][0] == 3 * 4
    p_attn = 2 * 96 * 96 + 2 * 96 * (1 * dh)
    p_ffn = 3 * 96 * 200
    assert tt["analog_params"][0] == 3 * (p_attn + p_ffn)
    assert tt["total_params"][0] == 3 * (p_attn + p_ffn) + 2 * 1000 * 96


def test_tile_table_moe_utilization():
    from repro_torch.core.explore import CandidateSpec, _tile_table
    dense = CandidateSpec.of(d_model=64, d_ff=64, n_layers=2)
    moe = CandidateSpec.of(d_model=64, d_ff=64, n_layers=2, n_experts=8,
                           top_k=2)
    td, tm = _tile_table(dense), _tile_table(moe)
    attn_tiles = 2 * (2 * 2 * 2 + 2 * 2 * 2)
    ffn_dense = 2 * (3 * 2 * 2)
    assert td["n_tiles"][0] == attn_tiles + ffn_dense
    assert tm["n_tiles"][0] == attn_tiles + 8 * ffn_dense
    np.testing.assert_allclose(
        tm["tiles_token"][0], attn_tiles + 8 * ffn_dense * (2 / 8))
    np.testing.assert_allclose(td["tiles_token"][0], td["n_tiles"][0])


def test_tile_size_scales_counts_not_total_area():
    from repro_torch.core.explore import TILE, CandidateSpec, _tile_table
    c = CandidateSpec.of(d_model=[512, 512], d_ff=[2048, 2048],
                         tile=[32, 128])
    tt = _tile_table(c)
    assert tt["n_tiles"][1] < tt["n_tiles"][0]
    area32 = tt["tiles_token"][0] * (32 / TILE) ** 2
    area128 = tt["tiles_token"][1] * (128 / TILE) ** 2
    np.testing.assert_allclose(area128, area32, rtol=0.05)


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_table_equals_reference(seed):
    from repro.core.explore import CandidateSpec as Ref
    from repro.core.explore import _tile_table as ref_table
    from repro_torch.core.explore import CandidateSpec, _tile_table
    got = _tile_table(CandidateSpec.sample(2048, seed=seed))
    want = ref_table(Ref.sample(2048, seed=seed))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_matrix_dims_expert_axis_multiplies_count():
    from repro_torch.core.explore import _matrix_dims
    from repro_torch.models.params import ParamSpec
    assert _matrix_dims(ParamSpec((4, 64, 96), ("experts", "embed",
                                                "mlp"))) == (4, 64, 96)
    assert _matrix_dims(ParamSpec((2, 4, 64, 96), (
        "layers", "experts", "embed", "mlp"))) == (8, 64, 96)
    assert _matrix_dims(ParamSpec((3, 64, 96), ("layers", "embed",
                                                "mlp"))) == (3, 64, 96)
    assert _matrix_dims(ParamSpec((64, 4, 24), (
        "embed", "heads", "head_dim"))) == (1, 64, 96)


# --- the engine -------------------------------------------------------------------

@pytest.mark.parametrize("artifact", ["unpackable", "packable"])
def test_dse_matches_reference(artifact):
    """C = 64 candidates x 32 samples on the reference's base rows: tile
    table identical, pricing within rtol 1e-5, Pareto set identical."""
    from repro.core.explore import CandidateSpec as Ref
    from repro_torch.core.explore import CandidateSpec
    path = fx.XBAR_UNPACKABLE if artifact == "unpackable" else \
        fx.XBAR_PACKABLE
    jsur, tsur = _surrogates(path)
    ref, eng = _engines()
    want = ref.evaluate(Ref.sample(C, seed=5), jsur)
    got = eng.evaluate(CandidateSpec.sample(C, seed=5), tsur)
    for f in ("n_tiles", "analog_params", "total_params",
              "analog_flop_fraction"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in ("tile_energy_j", "tile_latency_ns", "energy_per_token_j",
              "latency_critical_ns"):
        assert getattr(got, f).dtype == np.float64
        assert_close(getattr(got, f), getattr(want, f), f)
    np.testing.assert_array_equal(got.pareto(), want.pareto())
    assert got.compile_count == 1 and len(got) == C
    assert got.summary(3) == want.summary(3)
    assert got.as_dict(got.pareto()).keys() == want.as_dict(
        want.pareto()).keys()


def test_one_heads_launch_per_evaluate(monkeypatch):
    """M_ED and M_L go through one ``mlp_surrogate_heads`` call per
    evaluation; M_O, a single-head group, through the per-head MLP."""
    from repro_torch.core.explore import CandidateSpec
    from repro_torch.kernels import ops
    calls = []
    real = ops.mlp_surrogate_heads

    def spy(x, *arrays):
        calls.append((tuple(x.shape), arrays[4].shape[0]))
        return real(x, *arrays)

    monkeypatch.setattr(ops, "mlp_surrogate_heads", spy)
    _, eng = _engines(16)
    eng.evaluate(CandidateSpec.sample(8, seed=1), _surrogates()[1])
    assert calls == [((8 * 16, 70), 2)]


def test_compile_count_across_hot_swaps():
    """An equal-structure surrogate (scaled weights) sets nothing up again
    and prices differently; another C or another structure is a new
    program; ``compiled=False`` is counted nowhere."""
    from repro_torch.core.explore import CandidateSpec
    from repro_torch.core.surrogate import Surrogate
    sur = _surrogates()[1]
    swapped = Surrogate(sur.manifest, {
        p: {k: a * 1.001 if a.is_floating_point() else a
            for k, a in d.items()} for p, d in sur.params.items()})
    _, eng = _engines(16)
    cands = CandidateSpec.sample(32, seed=2)
    r1 = eng.evaluate(cands, sur)
    r2 = eng.evaluate(cands, swapped)
    assert r1.compile_count == r2.compile_count == eng.compile_count == 1
    assert not np.array_equal(r1.tile_energy_j, r2.tile_energy_j)
    again = eng.evaluate(cands, sur)
    np.testing.assert_array_equal(again.tile_energy_j, r1.tile_energy_j)
    eager = eng.evaluate(cands, sur, compiled=False)
    np.testing.assert_array_equal(eager.tile_energy_j, r1.tile_energy_j)
    assert eng.compile_count == 1
    eng.evaluate(cands.take(np.arange(16)), sur)
    assert eng.compile_count == 2
    eng.evaluate(cands, _surrogates(fx.XBAR_PACKABLE)[1])
    assert eng.compile_count == 3


def test_pareto_mask_equals_reference():
    from repro.core.explore import pareto_mask as ref
    from repro_torch.core.explore import pareto_mask
    rng = np.random.default_rng(3)
    objs = rng.integers(0, 6, (300, 3)).astype(np.float64)   # many ties
    np.testing.assert_array_equal(pareto_mask(objs), ref(objs))
    objs = rng.normal(size=(200, 2))
    mask = pareto_mask(objs)
    np.testing.assert_array_equal(mask, ref(objs))
    assert mask.any() and not mask.all()


def test_legacy_bank_prices_as_its_surrogate():
    """A fitted ``PredictorBank`` (and a library around the surrogate) is
    resolved as the reference resolves it, and prices identically."""
    from repro_torch.core.dataset import (CircuitDataset, TestbenchConfig,
                                          generate_testbench,
                                          simulate_golden)
    from repro_torch.core.events import extract_events, split_runwise
    from repro_torch.core.explore import CandidateSpec
    from repro_torch.core.predictors import PredictorBank
    from repro_torch.core.surrogate import SurrogateLibrary
    cfg = TestbenchConfig(n_runs=24, n_steps=12, seed=0)
    trace = simulate_golden("crossbar", *generate_testbench("crossbar", cfg,
                                                            "cpu"))
    splits = split_runwise(extract_events(trace), cfg.n_runs, seed=0)
    bank = PredictorBank("crossbar", families=("mean", "linear"),
                         device="cpu").fit(CircuitDataset(
                             "crossbar", *splits, 0.0, cfg.n_runs))
    sur = bank.to_surrogate()
    _, eng = _engines(16)
    cands = CandidateSpec.sample(8, seed=4)
    want = eng.evaluate(cands, sur).tile_energy_j
    for form in (bank, {"crossbar": sur}, SurrogateLibrary({"crossbar":
                                                            sur})):
        np.testing.assert_array_equal(eng.evaluate(cands, form)
                                      .tile_energy_j, want)
    with pytest.raises(ValueError, match="crossbar"):
        eng.evaluate(cands, {"lif": sur})
    lif = _lif_surrogate()
    with pytest.raises(ValueError, match="crossbar"):
        eng.evaluate(cands, lif)


@functools.cache
def _lif_surrogate():
    from repro_torch.core.surrogate import Surrogate
    return Surrogate.load(str(fx.PACKABLE), device="cpu")


def test_facade_explore():
    import repro_torch.lasana as lasana
    from repro_torch.core.explore import DSEEngine
    eng = DSEEngine(n_samples=16, device="cpu")
    cands = lasana.CandidateSpec.grid(d_model=[256, 1024], tile=[32, 64],
                                      v_dd=[0.9, 1.3])
    rep = lasana.explore(cands, _surrogates()[1], engine=eng)
    assert isinstance(rep, lasana.DSEReport) and len(rep) == 8
    assert rep.compile_count == 1 and np.isfinite(
        rep.energy_per_token_j).all()
    assert set(rep.pareto()) <= set(range(8)) and rep.pareto().size
    # a higher rail drives the macro harder: energy moves with v_dd
    assert not np.allclose(rep.tile_energy_j[::2], rep.tile_energy_j[1::2],
                           rtol=1e-3, atol=0.0)


def test_explore_needs_a_card_unless_asked_for_the_cpu():
    from repro_torch.core import explore
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        explore.DSEEngine()


# --- explore_arch ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_explore_arch_matches_reference(arch):
    """All ten reduced configs: the tile walk in the reference's key order
    (tile counts and components identical — the Griffin interleave's list
    of layers, the expert banks and the ``encoder`` / ``mtp`` subtrees
    included), priced on the reference's rows (rtol 1e-5); the port's own
    draws price the same tiles."""
    from repro.configs import reduced_config as ref_reduced
    from repro.core.explore import explore_arch as ref_explore
    from repro_torch import configs
    from repro_torch.core.explore import (_arch_report, _price_rows,
                                          explore_arch)
    jsur, tsur = _surrogates()
    want = ref_explore(ref_reduced(arch), jsur)
    cfg = configs.reduced_config(arch)
    got = _arch_report(cfg, *_price_rows(tsur, *_tile_rows()))
    assert list(got.tiles_by_component) == list(want.tiles_by_component)
    assert got.tiles_by_component == want.tiles_by_component
    for f in ("arch", "n_matrices", "n_tiles", "analog_params",
              "total_params", "analog_flop_fraction"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("energy_per_token_j", "latency_critical_ns", "tile_energy_j"):
        assert_close(getattr(got, f), getattr(want, f), f)
    own = explore_arch(cfg, {"crossbar": tsur})
    assert own.n_tiles == want.n_tiles and own.tile_energy_j > 0
    assert own.summary().startswith(cfg.name)


# --- the committed DSE record --------------------------------------------------------

def test_dse_record_loads_at_the_chip_shapes():
    """The JAX record of ``explore(CandidateSpec.sample(4096, seed=0),
    crossbar_unpackable)`` at n_samples 256: the port draws the same
    candidates, its tile table equals the record's, its Pareto mask over
    the record's objectives is the record's, and the ten configs'
    ``explore_arch`` reports are there."""
    from repro_torch.core.explore import CandidateSpec, _tile_table
    rec = _record()
    cands = CandidateSpec.sample(fx.DSE_CANDIDATES, seed=0)
    np.testing.assert_array_equal(cands.v_dd, rec["v_dd"])
    np.testing.assert_array_equal(cands.tile, rec["tile"])
    assert rec["base_x"].shape == (fx.DSE_SAMPLES, 32)
    assert rec["base_p"].shape == (fx.DSE_SAMPLES, 33)
    assert rec["base_o"].shape == (fx.DSE_SAMPLES,)
    assert rec["tile_x"].shape == (2048, 32)
    tt = _tile_table(cands)
    for f in ("n_tiles", "analog_params", "total_params",
              "analog_flop_fraction"):
        np.testing.assert_array_equal(tt[f], rec[f"report/{f}"])
    from repro_torch.core.explore import DSEReport
    rep = DSEReport(candidates=cands, **{
        f: rec[f"report/{f}"] for f in fx.DSE_REPORT_FIELDS})
    np.testing.assert_array_equal(rep.pareto(), rec["pareto"])
    assert 0 < rec["pareto"].size < fx.DSE_CANDIDATES
    for arch in ARCHS:
        comps = json.loads(str(rec[f"arch/{arch}/tiles_by_component"]))
        assert sum(comps.values()) == int(rec[f"arch/{arch}/n_tiles"])


def test_dse_record_reprices_in_the_port():
    """The record's first 64 candidates on its base rows, and the ten
    full-size configs on its tile rows, priced in the port."""
    from repro_torch import configs
    from repro_torch.core.explore import (CandidateSpec, DSEEngine,
                                          _arch_report, _price_rows)
    rec = _record()
    sur = _surrogates()[1]
    eng = DSEEngine(n_samples=fx.DSE_SAMPLES, device="cpu")
    eng._base_x, eng._base_p, eng._base_o = (torch.as_tensor(
        rec[k].astype(np.float32)) for k in ("base_x", "base_p", "base_o"))
    first = CandidateSpec.sample(fx.DSE_CANDIDATES, seed=0).take(
        np.arange(64))
    got = eng.evaluate(first, sur)
    for f in ("tile_energy_j", "tile_latency_ns", "energy_per_token_j",
              "latency_critical_ns"):
        assert_close(getattr(got, f), rec[f"report/{f}"][:64], f)
    e_tile, l_tile = _price_rows(sur, *_tile_rows())
    for arch in ARCHS:
        rep = _arch_report(configs.get_config(arch), e_tile, l_tile)
        assert rep.tiles_by_component == json.loads(
            str(rec[f"arch/{arch}/tiles_by_component"]))
        for f in fx.ARCH_FIELDS:
            want = rec[f"arch/{arch}/{f}"]
            if want.dtype.kind == "i":
                assert getattr(rep, f) == int(want), (arch, f)
            else:
                assert_close(getattr(rep, f), want, f"{arch} {f}")
