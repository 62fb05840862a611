"""The port's train-state checkpoints (``repro_torch.checkpoint``): the
reference's tests/test_checkpoint.py through the port, the snapshot an
asynchronous save takes before the next in-place step, and checkpoints
crossing between the packages both ways — with ``zstandard`` hidden
(the ``raw`` codec, as on a machine without it), bf16 leaves as 16-bit
words, a whole LM train state, and the port reading the reference's
files in a process where ``ml_dtypes`` and JAX cannot be imported."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.checkpoint.manager as jmanager  # noqa: E402
import repro_torch.checkpoint.manager as manager  # noqa: E402
from repro_torch import tree as tr  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"step": torch.tensor(7, dtype=torch.int32),
            "params": {"a": torch.randn((16, 8), generator=g),
                       "b": torch.randn((3,), generator=g).to(
                           torch.bfloat16)},
            "opt": [torch.zeros((4, 4)), torch.ones((2,))]}


def _equal(got, want):
    g, w = tr.leaves(got), tr.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_roundtrip_identity(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    mgr.save(10, tree, metadata={"loss": 1.5})
    got, user = mgr.restore(10, tree)
    assert user["loss"] == 1.5
    _equal(got, tree)


def test_restore_into_abstract(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree)
    abstract = tr.tree_map(lambda t: t.to("meta"), tree)
    got, _ = mgr.restore(1, abstract)
    assert got["params"]["a"].device.type == "cpu"
    _equal(got, tree)
    # placed by a tree of devices
    got, _ = mgr.restore(1, abstract, shardings=tr.tree_map(
        lambda _: torch.device("cpu"), tree))
    _equal(got, tree)


def test_restore_refuses_another_structure(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(1, {"only": torch.zeros(2)})


def test_gc_keeps_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.steps() == [3, 4]


def test_half_written_dir_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(5, tree)
    os.makedirs(tmp_path / "step_0000009.tmp")
    assert mgr.latest_step() == 5


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(3, tree, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 3
    got, _ = mgr.restore(3, tree)
    assert torch.equal(got["opt"][1], tree["opt"][1])


def test_async_save_snapshots_before_the_next_step(tmp_path):
    """The train step updates its tensors in place: a save must hold the
    values of the moment it was called, even on the CPU."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    want = tr.tree_map(torch.clone, tree)
    mgr.save(2, tree, blocking=False)
    for t in tr.leaves(tree):
        t.add_(1)
    mgr.wait()
    got, _ = mgr.restore(2, want)
    _equal(got, want)


def test_async_write_error_raises_at_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))

    def broken(*a, **k):
        raise OSError("disk gone")
    monkeypatch.setattr(manager.os, "rename", broken)
    mgr.save(1, _tree(), blocking=False)
    with pytest.raises(RuntimeError, match="disk gone"):
        mgr.wait()
    assert mgr.latest_step() is None


def test_restore_latest_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_latest(_tree()) is None


def test_codec_recorded(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, _tree())
    with open(tmp_path / "step_0000002" / "meta.json") as f:
        meta = json.load(f)
    assert meta["codec"] == ("zstd" if manager.zstd is not None else "raw")
    assert meta["dtypes"] == ["float32", "float32", "float32", "bfloat16",
                              "int32"]
    assert meta["shapes"] == [[4, 4], [2], [16, 8], [3], []]


@pytest.mark.skipif(manager.zstd is None, reason="zstandard not installed")
def test_zstd_roundtrip_and_compression(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"a": torch.zeros((256, 256))}
    mgr.save(4, tree)
    leaf = tmp_path / "step_0000004" / "leaf_00000.zst"
    assert leaf.exists() and leaf.stat().st_size < 256 * 256 * 4
    got, _ = mgr.restore(4, tree)
    assert torch.equal(got["a"], tree["a"])


# --- across the packages ----------------------------------------------------------

@pytest.fixture
def raw_codec(monkeypatch):
    """Both managers as on a machine without ``zstandard``."""
    monkeypatch.setattr(manager, "zstd", None)
    monkeypatch.setattr(jmanager, "zstd", None)


def _jax_tree():
    key = jax.random.PRNGKey(3)
    return {"step": jnp.asarray(7, jnp.int32),
            "params": {"a": jax.random.normal(key, (16, 8)),
                       "b": jax.random.normal(key, (5,)).astype(
                           jnp.bfloat16)},
            "opt": [jnp.zeros((4, 4)), jnp.ones((2,))]}


def _same_bits(port_leaves, jax_leaves):
    assert len(port_leaves) == len(jax_leaves)
    for t, a in zip(port_leaves, jax_leaves):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
        else:
            assert str(t.dtype).split(".")[-1] == a.dtype.name
            assert np.array_equal(t.numpy(), a)


def test_reference_checkpoint_restores_in_the_port(tmp_path, raw_codec):
    tree = _jax_tree()
    jmanager.CheckpointManager(str(tmp_path)).save(4, tree,
                                                   metadata={"arch": "x"})
    assert (tmp_path / "step_0000004" / "leaf_00000.raw").exists()
    like = tr.unflatten(tr.flatten(tree)[1], [
        torch.empty(np.shape(a), device="meta") for a in jax.tree.leaves(
            tree)])
    got, user = CheckpointManager(str(tmp_path)).restore(4, like)
    assert user == {"arch": "x"}
    _same_bits(tr.leaves(got), jax.tree.leaves(tree))


def test_port_checkpoint_restores_in_the_reference(tmp_path, raw_codec):
    tree = _tree(1)
    CheckpointManager(str(tmp_path)).save(6, tree)
    like = jax.tree.map(lambda t: jax.ShapeDtypeStruct(
        tuple(t.shape), jnp.bfloat16 if t.dtype == torch.bfloat16
        else jnp.dtype(str(t.dtype).split(".")[-1])),
        tr.tree_map(lambda t: t, tree))
    got, _ = jmanager.CheckpointManager(str(tmp_path)).restore(6, like)
    _same_bits(tr.leaves(tree), jax.tree.leaves(got))


def test_train_states_cross_both_ways(tmp_path, raw_codec):
    """A reduced StarCoder2 train state (bf16 params, fp32 m / v, the 0-d
    step) written by each package restores in the other into its own
    abstract train state, leaf for leaf."""
    from repro import configs as jconfigs
    from repro.models.model import Model as JaxModel
    from repro.optim import AdamW as JaxAdamW, AdamWConfig as JaxAdamWConfig
    from repro.train import step as jstep
    from repro_torch import configs
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.train import step as step_mod

    arch = "starcoder2-3b"
    model, opt = Model(configs.reduced_config(arch)), AdamW(AdamWConfig())
    state = step_mod.init_train_state(
        model, opt, torch.Generator().manual_seed(0), "cpu")
    for t in tr.leaves(state["opt"]):
        t.normal_()
    jmodel = JaxModel(jconfigs.reduced_config(arch))
    jopt = JaxAdamW(JaxAdamWConfig())
    jabstract = jstep.abstract_train_state(jmodel, jopt)
    CheckpointManager(str(tmp_path / "port")).save(3, state)
    got, _ = jmanager.CheckpointManager(str(tmp_path / "port")).restore(
        3, jabstract)
    for a, s in zip(jax.tree.leaves(got), jax.tree.leaves(jabstract)):
        assert a.shape == s.shape and a.dtype == s.dtype
    _same_bits(tr.leaves(state), jax.tree.leaves(got))
    # and back: the reference's state restores into the port's abstract one
    jstate = jstep.init_train_state(jmodel, jopt, jax.random.PRNGKey(1))
    jmanager.CheckpointManager(str(tmp_path / "ref")).save(5, jstate)
    abstract = step_mod.abstract_train_state(model, opt)
    back, _ = CheckpointManager(str(tmp_path / "ref")).restore(5, abstract)
    for t, a in zip(tr.leaves(back), tr.leaves(abstract)):
        assert t.shape == a.shape and t.dtype == a.dtype
    _same_bits(tr.leaves(back), jax.tree.leaves(jstate))


def test_port_reads_reference_bf16_without_ml_dtypes(tmp_path, raw_codec):
    """A process where neither ``ml_dtypes`` nor JAX imports restores the
    reference's bf16 leaves as the same 16-bit words."""
    tree = _jax_tree()
    jmanager.CheckpointManager(str(tmp_path)).save(2, tree)
    words = np.asarray(tree["params"]["b"]).view(np.int16).tolist()
    script = textwrap.dedent(f"""
        import sys
        for name in ("ml_dtypes", "jax", "jaxlib", "repro"):
            sys.modules[name] = None
        import torch
        from repro_torch.checkpoint import CheckpointManager
        like = {{"step": torch.empty((), dtype=torch.int32, device="meta"),
                 "params": {{"a": torch.empty((16, 8), device="meta"),
                             "b": torch.empty((5,), device="meta")}},
                 "opt": [torch.empty((4, 4), device="meta"),
                         torch.empty((2,), device="meta")]}}
        got, _ = CheckpointManager({str(tmp_path)!r}).restore(2, like)
        b = got["params"]["b"]
        assert b.dtype == torch.bfloat16
        assert b.view(torch.int16).tolist() == {words!r}
        assert int(got["step"]) == 7
        print("NO-ML-DTYPES-OK")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, timeout=120)
    assert "NO-ML-DTYPES-OK" in r.stdout, r.stdout + r.stderr
