"""Port parity: the Surrogate artifact and the stacked MLP heads.

Artifacts cross both ways (a JAX-saved ``.npz`` loads in the port, a
port-saved one in JAX); every model family predicts what the reference
predicts to rtol 1e-5, per head and stacked; and the plain
``mlp_surrogate_heads`` matches the JAX Pallas kernel in interpret mode.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from test_torch_fixtures import (PACKABLE, assert_close,  # noqa: E402,F401
                                 surrogate_pairs)

# one predictor per family: a single surrogate covers the whole registry
FAMILY_PER_PREDICTOR = {"M_O": "mlp", "M_V": "linear", "M_ED": "gbdt",
                        "M_ES": "table", "M_L": "mean"}
FAMILIES = ("mean", "linear", "table", "gbdt", "mlp")


@pytest.fixture(scope="module")
def all_family_surrogate(lif_dataset, tmp_path_factory):
    """The all-family artifact built as tests/test_persist.py builds it,
    saved by JAX and loaded by both packages: (path, jax, port)."""
    from repro.core.models import (GBDTModel, LinearModel, MLPModel,
                                   MeanModel, TableModel)
    from repro.core.predictors import (PREDICTOR_DEFS, PredictorBank,
                                       build_features)
    from repro.core.surrogate import Surrogate as JaxSurrogate
    from repro_torch.core.surrogate import Surrogate
    mk = {"mean": MeanModel, "linear": LinearModel,
          "table": lambda: TableModel(max_rows=500),
          "gbdt": lambda: GBDTModel(n_trees=6, max_depth=3),
          "mlp": lambda: MLPModel(hidden=(8,), max_epochs=2)}
    bank = PredictorBank("lif", families=())
    for pname, fam in FAMILY_PER_PREDICTOR.items():
        d = PREDICTOR_DEFS[pname]
        chain = d.get("chain_out", False)
        tr = lif_dataset.train.of_kind(*d["kinds"])
        va = lif_dataset.val.of_kind(*d["kinds"])
        xtr = bank.augment_features(
            build_features(tr, prev_out=d["prev_out"], chain_out=chain))
        xva = bank.augment_features(
            build_features(va, prev_out=d["prev_out"], chain_out=chain))
        ytr = (getattr(tr, d["target"]) * d["scale"]).astype(np.float32)
        yva = (getattr(va, d["target"]) * d["scale"]).astype(np.float32)
        model = mk[fam]()
        model.fit(xtr, ytr, xva, yva)
        bank.selected[pname] = model
    path = str(tmp_path_factory.mktemp("allfam") / "sur.npz")
    JaxSurrogate.from_bank(bank).save(path)
    return path, JaxSurrogate.load(path), Surrogate.load(path, device="cpu")


def _features(pname, seed, n=48):
    """Raw lif rows: 3 inputs + v + tau + 4 params (+ o_prev, o_new)."""
    dim = 11 if pname in ("M_ED", "M_L") else 9
    return np.random.default_rng(seed).normal(0, 1, (n, dim)).astype(
        np.float32)


def test_jax_saved_artifact_loads_in_port(all_family_surrogate):
    _, jsur, tsur = all_family_surrogate
    assert tsur.manifest.families == jsur.manifest.families
    assert tsur.manifest.scales == jsur.manifest.scales
    assert tsur.manifest.features == jsur.manifest.features
    assert tsur.fit_info == jsur.fit_info
    for p, arrays in jsur.params.items():
        for k, a in arrays.items():
            np.testing.assert_array_equal(tsur.params[p][k].numpy(),
                                          np.asarray(a), err_msg=f"{p}/{k}")


def test_port_saved_artifact_loads_in_jax(all_family_surrogate, tmp_path):
    from repro.core.surrogate import Surrogate as JaxSurrogate
    _, jsur, tsur = all_family_surrogate
    path = str(tmp_path / "port")             # extension added, as in JAX
    tsur.save(path)
    back = JaxSurrogate.load(path + ".npz")
    assert back.manifest == jsur.manifest
    assert back.fit_info == json.loads(json.dumps(jsur.fit_info))
    for p, arrays in jsur.params.items():
        for k, a in arrays.items():
            got = np.asarray(back.params[p][k])
            assert got.dtype == np.asarray(a).dtype, (p, k)
            np.testing.assert_array_equal(got, np.asarray(a))


def test_committed_artifacts_load_in_both(surrogate_pairs):
    for name, (jsur, tsur) in surrogate_pairs.items():
        assert tsur.manifest == tsur.manifest.__class__(
            **{f: getattr(jsur.manifest, f) for f in
               ("circuit", "format_version", "families", "scales",
                "features")}), name


def test_format_version_mismatch_refuses_to_load(tmp_path):
    from repro_torch.core.surrogate import FORMAT_VERSION, Surrogate
    with np.load(PACKABLE) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["__manifest__"].tobytes()).decode())
    meta["format_version"] = FORMAT_VERSION + 1
    arrays["__manifest__"] = np.frombuffer(json.dumps(meta).encode(),
                                           dtype=np.uint8)
    path = str(tmp_path / "future.npz")
    np.savez_compressed(path, **arrays)
    with pytest.raises(ValueError, match="format version"):
        Surrogate.load(path, device="cpu")
    junk = str(tmp_path / "junk.npz")
    np.savez(junk, a=np.zeros(3))
    with pytest.raises(ValueError, match="__manifest__"):
        Surrogate.load(junk, device="cpu")
    with pytest.raises(FileNotFoundError, match="nowhere"):
        Surrogate.load(str(tmp_path / "nowhere"), device="cpu")


@pytest.mark.parametrize("pname", sorted(FAMILY_PER_PREDICTOR))
def test_predict_matches_every_family(all_family_surrogate, pname):
    _, jsur, tsur = all_family_surrogate
    x = _features(pname, seed=7)
    want = np.asarray(jsur.predict(pname, jnp.asarray(x)))
    got = tsur.predict(pname, torch.as_tensor(x)).numpy()
    assert_close(got, want, pname)


def _synthetic_surrogate(family: str, seed: int):
    """A manifest + arrays whose five heads all use ``family`` (random
    weights of the reference's array schemas), so predict_heads stacks."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    arrays = {}
    for p in ("M_ED", "M_ES", "M_L", "M_O", "M_V"):
        f = 12 if p in ("M_ED", "M_L") else 10
        if family == "mean":
            a = {"mu": np.float32(rng.normal())}
        elif family == "linear":
            a = {"w": f32(f + 1), "mu": f32(f), "sd": 0.5 + rng.random(
                f).astype(np.float32)}
        elif family == "table":
            a = {"tx": f32(64, f), "ty": f32(64), "mu": f32(f),
                 "sd": 0.5 + rng.random(f).astype(np.float32)}
        elif family == "gbdt":
            a = {"feat": rng.integers(0, f, (5, 7)).astype(np.int32),
                 "thr": f32(5, 7), "leaf": f32(5, 8),
                 "base": np.float32(rng.normal())}
        else:
            a = {"w0": f32(f, 100) * 0.3, "b0": f32(100) * 0.1,
                 "w1": f32(100, 50) * 0.1, "b1": f32(50) * 0.1,
                 "w2": f32(50, 1) * 0.1, "b2": f32(1),
                 "x_mu": f32(f), "x_sd": 0.5 + rng.random(f).astype(
                     np.float32), "y_mu": f32(1), "y_sd": f32(1) ** 2 + 0.5}
        arrays[p] = a
    meta = {"format_version": 1, "circuit": "lif",
            "families": {p: family for p in arrays},
            "scales": {p: (1e15 if p in ("M_ED", "M_ES") else 1.0)
                       for p in arrays},
            "features": [], "fit_info": None}
    return meta, arrays


def _jax_from_numpy(meta, arrays):
    from repro.core.surrogate import Manifest, Surrogate as JaxSurrogate
    man = Manifest(circuit=meta["circuit"],
                   format_version=meta["format_version"],
                   families=tuple(sorted(meta["families"].items())),
                   scales=tuple(sorted(meta["scales"].items())),
                   features=tuple(meta["features"]))
    return JaxSurrogate(man, {p: {k: jnp.asarray(v) for k, v in a.items()}
                              for p, a in arrays.items()})


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("fused_kernel", [False, True])
def test_predict_heads_matches_every_family(family, fused_kernel):
    """Algorithm 1's three variants through predict_heads: stacked groups
    (every family but gbdt) and the per-head gbdt walk."""
    from repro_torch.convert import surrogate_from_numpy
    meta, arrays = _synthetic_surrogate(family, seed=FAMILIES.index(family))
    jsur = _jax_from_numpy(meta, arrays)
    tsur = surrogate_from_numpy(meta, arrays, device="cpu")
    rng = np.random.default_rng(11)
    fi, fa = (rng.normal(0, 1, (37, 9)).astype(np.float32) for _ in range(2))
    ft = rng.normal(0, 1, (37, 11)).astype(np.float32)
    want = jsur.predict_heads(feats_idle=fi, feats_act=fa, feats_tr=ft,
                              fused_kernel=fused_kernel)
    got = tsur.predict_heads(feats_idle=torch.as_tensor(fi),
                             feats_act=torch.as_tensor(fa),
                             feats_tr=torch.as_tensor(ft),
                             fused_kernel=fused_kernel)
    assert got.keys() == want.keys()
    for v, heads in want.items():
        assert got[v].keys() == heads.keys()
        for p, y in heads.items():
            g, w = got[v][p].numpy(), np.asarray(y)
            if family == "table":
                # an exact nearest-neighbour tie may resolve to the other,
                # equally near row (surrogate.py:409-415); no tie here
                np.testing.assert_array_equal(g, w, err_msg=f"{v}/{p}")
            else:
                assert_close(g, w, f"{v}/{p}")


def _mlp_stacks(sur, pnames):
    """The stacked MLP arrays predict_heads hands mlp_surrogate_heads."""
    keys = ("x_mu", "x_sd", "y_mu", "y_sd", "w0", "b0", "w1", "b1", "w2",
            "b2")
    return [np.stack([np.asarray(sur.params[p][k]) for p in pnames])
            for k in keys]


def _wide_stacks(p, f, h1, h2, seed):
    """P standardized MLP(h1, h2) heads at F columns from a seed."""
    rng = np.random.default_rng(seed)
    shapes = ((p, f), (p, f), (p, 1), (p, 1), (p, f, h1), (p, h1),
              (p, h1, h2), (p, h2), (p, h2, 1), (p, 1))
    stacks = [rng.normal(0, 0.3, s).astype(np.float32) for s in shapes]
    for i in (1, 3):                                    # x_sd, y_sd
        stacks[i] = np.abs(stacks[i]) + 0.5
    for i, fan in ((4, f), (6, h1), (8, h2)):
        stacks[i] *= np.float32(fan ** -0.5 / 0.3)
    return stacks


@pytest.mark.parametrize("variant", ["act", "tr", "wide"])
@pytest.mark.parametrize("n", [300, 7])
def test_plain_mlp_heads_match_pallas_interpret(surrogate_pairs, variant, n):
    """The stacked groups of the packable artifact, and (``wide``) two
    F = 100, MLP(200, 50) heads, wider than the first CUDA design took."""
    from repro.kernels import ops as jax_ops
    from repro_torch.kernels import ops
    jsur, _ = surrogate_pairs["packable"]
    if variant == "wide":
        pnames = ("M_ED", "M_L")
        stacks = _wide_stacks(len(pnames), 100, 200, 50, n)
    else:
        pnames = (("M_O", "M_V", "M_ES") if variant == "act"
                  else ("M_ED", "M_L"))
        stacks = _mlp_stacks(jsur, pnames)
    f = stacks[0].shape[1]
    x = np.random.default_rng(n).normal(0, 1, (n, f)).astype(np.float32)
    want = np.asarray(jax_ops.mlp_surrogate_heads(
        jnp.asarray(x), *map(jnp.asarray, stacks), interpret=True))
    got = ops.mlp_surrogate_heads(torch.as_tensor(x),
                                  *map(torch.as_tensor, stacks)).numpy()
    assert got.shape == (len(pnames), n)
    assert_close(got, want, "mlp heads")


def test_mlp_heads_padded_x_sd_columns_are_ones(surrogate_pairs):
    """Feature columns padded onto the heads carry x_sd = 1 and zero
    weights, and change nothing; a zero x_sd pad would turn every output
    into NaN (0 / 0 in the standardizer)."""
    from repro_torch.kernels import ops
    jsur, _ = surrogate_pairs["packable"]
    stacks = [torch.as_tensor(a) for a in _mlp_stacks(jsur, ("M_O", "M_V"))]
    x_mu, x_sd, y_mu, y_sd, w0, *rest = stacks
    x = torch.as_tensor(np.random.default_rng(0).normal(
        0, 1, (50, x_mu.shape[1])).astype(np.float32))
    base = ops.mlp_surrogate_heads(x, *stacks)
    pad = 3
    xp = torch.nn.functional.pad(x, (0, pad))
    x_mu_p = torch.nn.functional.pad(x_mu, (0, pad))
    x_sd_p = torch.nn.functional.pad(x_sd, (0, pad), value=1.0)
    w0_p = torch.nn.functional.pad(w0, (0, 0, 0, pad))
    assert torch.all(x_sd_p[:, -pad:] == 1.0)
    padded = ops.mlp_surrogate_heads(xp, x_mu_p, x_sd_p, y_mu, y_sd, w0_p,
                                     *rest)
    np.testing.assert_allclose(padded.numpy(), base.numpy(), rtol=1e-6)
    zero_sd = torch.nn.functional.pad(x_sd, (0, pad))
    bad = ops.mlp_surrogate_heads(xp, x_mu_p, zero_sd, y_mu, y_sd, w0_p,
                                  *rest)
    assert torch.isnan(bad).all()


def test_structure_key_is_a_weight_swap_key(surrogate_pairs):
    from repro_torch.core.surrogate import Surrogate, structure_key
    _, tsur = surrogate_pairs["packable"]
    _, other = surrogate_pairs["unpackable"]
    swapped = Surrogate(tsur.manifest, {p: {k: a * 1.01 for k, a in d.items()}
                                        for p, d in tsur.params.items()})
    assert structure_key(swapped) == structure_key(tsur)
    assert structure_key(other) != structure_key(tsur)
