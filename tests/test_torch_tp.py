"""Tensor-parallel placement in the port (``repro_torch/sharding.py``,
``core/collectives.py``, ``models/params.py``): every leaf's resolved
spec and shard shape against the reference's ``spec_for_shape``, split /
gather, the sharded init, the dry run's two switches, and
the collectives."""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import sharding as shd  # noqa: E402
from repro_torch import tree as tr  # noqa: E402
from repro_torch.configs import ARCH_IDS, reduced_config  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

MESHES = ((1, 2), (2, 2), (1, 4))


def _mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     ["cpu"] * int(np.prod(shape)))


def _fake(shape):
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty(shape))


def _want_shard(spec, shape, sizes):
    out = list(shape)
    for k, entry in enumerate(spec):
        for a in shd._entry_axes(entry):
            out[k] //= sizes[a]
    return tuple(out)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_leaf_resolves_as_the_reference(arch, shape):
    """Params under the training rules, caches under the serving rules
    with ``kv_seq``: the port's placement has the reference's resolved
    spec, and its shard shape is the shape cut by that spec."""
    import repro.sharding as jshd
    from repro import configs as jconfigs
    from repro.models.model import Model as JaxModel

    mesh, fake = _mesh(shape), _fake(shape)
    sizes = mesh.shape
    model = Model(reduced_config(arch))
    jmodel = JaxModel(jconfigs.reduced_config(arch))
    jspecs = dict(prm.leaves(jmodel.param_specs()))
    rules, jrules = shd.train_rules(mesh), jshd.train_rules(fake)
    placements = dict(prm.leaves(prm.shardings(model.param_specs(), mesh,
                                               rules)))
    for path, spec in prm.leaves(model.param_specs()):
        js = jspecs[path]
        assert (tuple(js.shape), tuple(js.logical)) == (spec.shape,
                                                         spec.logical)
        want = tuple(jrules.spec_for_shape(fake, js.logical, js.shape))
        pl = placements[path]
        assert pl.spec == want, path
        assert pl.shard_shape == _want_shard(want, spec.shape, sizes), path
    srules = shd.serve_rules(mesh, kv_seq_sharding=True)
    jsrules = jshd.serve_rules(fake, kv_seq_sharding=True)
    serve_model = Model(model.cfg, mesh=mesh, rules=srules)
    specs = dict(prm.leaves(model.cache_specs(4, 24)["stacks"]))
    logical = dict(_logical_leaves(model.cache_logical()["stacks"]))
    cpl = dict(prm.leaves(serve_model.cache_placements(4, 24)))
    assert sorted(cpl) == sorted(specs)
    for path, sp in specs.items():
        want = tuple(jsrules.spec_for_shape(fake, logical[path], sp.shape))
        assert cpl[path].spec == want, path
        assert cpl[path].shard_shape == _want_shard(want, sp.shape, sizes)


def _logical_leaves(tree, prefix=""):
    """(path, logical tuple) pairs of a tree of logical specs."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _logical_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _logical_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("shape", MESHES)
def test_split_then_gather_is_the_identity(shape):
    """Contiguous, two-axis and segmented placements: each entry's block
    is the slice its coordinates name, and gather restores the whole."""
    mesh = _mesh(shape)
    rules = shd.train_rules(mesh)
    g = torch.Generator().manual_seed(0)
    cases = [(("embed", "mlp"), (8, 12), None),
             (("layers", "embed", "heads", None), (3, 8, 4, 2), None),
             (("vocab", None), (12, 5), None),
             (("embed", "ssm_inner"), (8, 4 + 4 + 4 + 4 + 4),
              (4, 4, 4, 4, 4)),
             ((None, "ssm_inner"), (3, 12), (4, 4, 4)),
             (("batch", None, "kv_heads", None), (4, 6, 2, 3), None)]
    for logical, size, seg in cases:
        t = torch.randn(size, generator=g)
        pl = rules.sharding(mesh, logical, size, segments=seg)
        shards = pl.split(t)
        assert all(tuple(s.shape) == pl.shard_shape for s in shards)
        assert torch.equal(pl.gather(shards), t)
        placed = pl.place(t)
        assert isinstance(placed, shd.Sharded)
        assert torch.equal(shd.whole(placed), t)
    # segments: every shard holds its block of each segment
    pl = rules.sharding(mesh, (None, "ssm_inner"), (2, 20),
                        segments=(8, 8, 4))
    t = torch.arange(40.0).reshape(2, 20)
    m = mesh.shape["model"]
    for i, s in enumerate(pl.split(t)):
        j = pl.coords(i)["model"]
        want = torch.cat([t[:, j * 8 // m:(j + 1) * 8 // m],
                          t[:, 8 + j * 8 // m:8 + (j + 1) * 8 // m],
                          t[:, 16 + j * 4 // m:16 + (j + 1) * 4 // m]], 1)
        assert torch.equal(s, want)
    with pytest.raises(ValueError, match="split"):
        rules.sharding(mesh, ("embed", "ssm_inner"), (2, 20),
                       segments=(9, 7, 4))


def test_one_entry_mesh_places_plain_tensors():
    one = _mesh((1, 1))
    rules = shd.train_rules(one)
    t = torch.zeros(3)
    assert shd.constraint(t, one, rules, ("batch",)) is t
    assert rules.sharding(one, ("embed", "mlp"), (4, 4)).place(t) is t


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ["starcoder2-3b", "mamba2-1.3b",
                                  "deepseek-v3-671b", "whisper-base"])
def test_sharded_init_is_the_unsharded_init(arch, shape):
    """The same seed gives the same numbers, leaf for leaf, placed; each
    entry's parameter bytes are what ``params.shard_bytes`` reckons."""
    cfg = reduced_config(arch)
    mesh = _mesh(shape)
    model = Model(cfg, mesh=mesh)
    placed = model.init(torch.Generator().manual_seed(3))
    plain = Model(cfg).init(torch.Generator().manual_seed(3))
    for (path, a), (_, b) in zip(prm.leaves(placed), prm.leaves(plain)):
        assert isinstance(a, shd.Sharded), path
        assert torch.equal(a.gather(), b), path
    got = [sum(x.shards[i].numel() * x.shards[i].element_size()
               for x in tr.leaves(placed)) for i in range(mesh.size)]
    assert got == prm.shard_bytes(model.param_specs(), mesh, model.rules)
    assert sum(got) > prm.param_bytes(model.param_specs()) // mesh.size


def test_dry_run_switches_raise_by_name():
    """The dry run's two switches place what they name: ``qk_dim`` takes
    the model axis where the heads do not divide it, ``attn_q_seq`` the
    query rows; a model takes either. The one combination attention does
    not take, kv_seq-sharded caches with head_dim split, raises by name."""
    mesh = _mesh((1, 2))
    cfg = reduced_config("starcoder2-3b")
    for switch in ("qk_dim_fallback", "seq_parallel_attn"):
        Model(cfg, mesh=mesh, rules=shd.train_rules(mesh, **{switch: True}))
    rules = shd.train_rules(mesh, qk_dim_fallback=True)
    # three heads do not divide the model axis: qk_dim takes it
    pl = rules.sharding(mesh, ("embed", "heads", "qk_dim"), (8, 3, 4))
    assert pl.spec == ("data", None, "model") and pl.shard_shape == (8, 3, 2)
    rules = shd.train_rules(mesh, seq_parallel_attn=True)
    pl = rules.sharding(mesh, ("batch", "attn_q_seq", None), (2, 8, 4))
    assert pl.spec == ("data", "model") and pl.shard_shape == (2, 4, 4)
    # on a one-entry model axis neither switch splits anything
    one = _mesh((2, 1))
    Model(cfg, mesh=one, rules=shd.train_rules(one, qk_dim_fallback=True,
                                               seq_parallel_attn=True))
    wide = _mesh((1, 4))
    rules = shd.train_rules(wide, qk_dim_fallback=True, kv_seq_sharding=True)
    qk = dataclasses.replace(cfg, d_model=48, n_heads=6, n_kv_heads=2,
                             dtype="float32")
    model = Model(qk, mesh=wide, rules=rules)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, qk.vocab, (2, 8), dtype=torch.int32)
    _, cache = model.prefill(params, {"tokens": tokens}, max_seq=12)
    with pytest.raises(NotImplementedError, match="kv_seq_sharding"):
        model.decode(params, cache, tokens[:, :1])


def test_collectives_sum_in_shard_order_and_their_adjoints():
    """Sums in shard order on the first participant's device, one result
    per device shared by its participants; autograd's backward of a
    gather is a reduce-scatter, of an all-reduce an all-reduce."""
    parts = [torch.tensor([1e8, 1.0]), torch.tensor([-1e8, 1.0]),
             torch.tensor([1.0, 1.0])]
    out = collectives.all_reduce_sum(parts)
    assert out[0] is out[1] is out[2]
    assert torch.equal(out[0], (parts[0] + parts[1]) + parts[2])
    assert torch.equal(collectives.all_max(parts)[0],
                       torch.tensor([1e8, 1.0]))
    a = torch.arange(6.0).reshape(2, 3)
    b = -a
    assert torch.equal(collectives.all_gather([a, b], 0)[1],
                       torch.cat([a, b]))
    rs = collectives.reduce_scatter([a, b + 1, a], 1)
    assert [tuple(r.shape) for r in rs] == [(2, 1)] * 3
    assert torch.equal(torch.cat(rs, 1), a + b + 1 + a)
    with pytest.raises(ValueError, match="blocks"):
        collectives.reduce_scatter([a, a], 1)
    # adjoints
    xs = [torch.randn(2, 3, requires_grad=True) for _ in range(2)]
    gathered = collectives.all_gather(xs, 1, ["cpu", "cpu"])
    w = [torch.randn(2, 6), torch.randn(2, 6)]
    sum((g * wi).sum() for g, wi in zip(gathered, w)).backward()
    want = collectives.reduce_scatter(w, 1)
    for x, g in zip(xs, want):
        assert torch.allclose(x.grad, g)
    ys = [torch.randn(3, requires_grad=True) for _ in range(3)]
    red = collectives.all_reduce_sum(ys)
    cs = [torch.randn(3) for _ in range(3)]
    sum((r * c).sum() for r, c in zip(red, cs)).backward()
    for y in ys:
        assert torch.allclose(y.grad, cs[0] + cs[1] + cs[2])
    grp = collectives.Group(["cpu", "cpu"])
    assert grp.reduce([a, b], split=False)[1] is b
    assert torch.equal(grp.reduce([a, b], split=True)[0], a + b)
