"""Port parity: stream checkpoints (``repro_torch`` vs ``repro``).

A checkpoint taken at any chunk boundary, saved and resumed on a fresh
engine, merges to the uninterrupted run bit for bit; on a warm engine the
resume builds nothing. The ``.npz`` format is the reference's, so a
checkpoint crosses both ways: a JAX-taken one resumes in the port and a
port-taken one in the reference, each within the reference's tolerances
of the other package's uninterrupted run.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import test_torch_fixtures as fx  # noqa: E402
from test_torch_fixtures import assert_close, surrogate_pairs  # noqa: E402,F401
from test_torch_stream import (_jax_spec, _lif_net, _mixed_net,  # noqa: E402
                               _port_spec, assert_identical)

CHUNK = 5


@pytest.fixture(scope="module")
def libraries(surrogate_pairs):
    """kind -> (JAX, port) surrogates for the LIF and mixed graphs."""
    from repro.core.surrogate import Surrogate as JaxSurrogate
    from repro.core.surrogate import SurrogateLibrary as JaxLibrary
    from repro_torch.core.surrogate import Surrogate, SurrogateLibrary
    jl, tl = surrogate_pairs["packable"]
    jx = JaxSurrogate.load(str(fx.XBAR_PACKABLE))
    tx = Surrogate.load(str(fx.XBAR_PACKABLE), device="cpu")
    return {"lif": (jl, tl),
            "mixed": (JaxLibrary({"crossbar": jx, "lif": jl}),
                      SurrogateLibrary({"crossbar": tx, "lif": tl}))}


def _case(name, libraries):
    """(description, stimulus, JAX keywords, port keywords)."""
    graph, backend = name.split("/")
    desc, x = (_lif_net if graph == "lif" else _mixed_net)()
    if backend == "lasana":
        j, t = libraries[graph]
        return desc, x, {"surrogates": j}, {"surrogates": t}
    return desc, x, {"backend": backend}, {"backend": backend}


def _assert_matches_reference(got, want):
    """Discrete fields identical, continuous ones to rtol 1e-5."""
    for f in ("outputs", "out_spikes", "events"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("energy", "latency", "flush_energy"):
        assert_close(getattr(got, f), np.asarray(getattr(want, f)), f)


@pytest.mark.parametrize("name", ["lif/lasana", "lif/golden",
                                  "mixed/lasana", "mixed/golden"])
def test_kill_and_resume_is_bitwise(libraries, name, tmp_path):
    """Cut the stream at every checkpoint, save, resume on a fresh engine:
    the merged record equals the uninterrupted run bit for bit. Resuming
    again on the now warm engine builds nothing."""
    import repro_torch.lasana as lasana
    desc, x, _, kw = _case(name, libraries)
    spec = _port_spec(desc)
    full = lasana.simulate(spec, x, record_hidden=False, device="cpu", **kw)
    chunks = list(lasana.stream(spec, x, chunk_ticks=CHUNK,
                                checkpoint_every=1, device="cpu", **kw))
    ckpts = [c.checkpoint for c in chunks]
    assert ckpts[-1] is None and all(c is not None for c in ckpts[:-1])
    for i, ckpt in enumerate(ckpts[:-1]):
        assert ckpt.k0 == (i + 1) * CHUNK
        path = ckpt.save(str(tmp_path / f"ck{i}"))
        fresh = _port_spec(desc)            # a new spec: a fresh engine
        assert_identical(lasana.resume(path, fresh, x, device="cpu",
                                       surrogates=kw.get("surrogates")),
                         full)
    eng = lasana.engine(spec, backend=ckpts[0].backend, record_hidden=False,
                        device="cpu")
    builds = eng.compile_count
    again = lasana.resume(ckpts[1], spec, x, device="cpu",
                          surrogates=kw.get("surrogates"))
    assert_identical(again, full)
    assert eng.compile_count == builds


def test_checkpoint_every_n_and_rearmed_resume(libraries):
    import repro_torch.lasana as lasana
    desc, x, _, kw = _case("lif/lasana", libraries)
    spec = _port_spec(desc)
    chunks = list(lasana.stream(spec, x, chunk_ticks=CHUNK,
                                checkpoint_every=2, device="cpu", **kw))
    assert [c.checkpoint is not None for c in chunks] == [
        False, True, False, True, False]
    ckpt = chunks[1].checkpoint
    assert ckpt.k0 == 2 * CHUNK
    np.testing.assert_array_equal(ckpt.acc_run.energy, np.concatenate(
        [c.energy for c in chunks[:2]]))
    tail = list(lasana.engine(spec, record_hidden=False, device="cpu").stream(
        x, resume_from=ckpt, checkpoint_every=1, **kw))
    assert [c.checkpoint.k0 for c in tail[:-1]] == [15, 20]
    assert tail[-1].checkpoint is None


def test_save_load_round_trip(libraries, tmp_path):
    import repro_torch.lasana as lasana
    from repro_torch.resilience import CKPT_FORMAT_VERSION, StreamCheckpoint
    desc, x, _, kw = _case("lif/lasana", libraries)
    chunks = list(lasana.stream(_port_spec(desc), x, chunk_ticks=CHUNK,
                                checkpoint_every=1, record_hidden=True,
                                device="cpu", **kw))
    ckpt = chunks[2].checkpoint
    path = ckpt.save(str(tmp_path / "ck"))          # extension added
    assert path.endswith(".npz")
    back = StreamCheckpoint.load(str(tmp_path / "ck"))
    for f in ("k0", "chunk_ticks", "batch", "spec_key", "backend", "mode",
              "record_hidden"):
        assert getattr(back, f) == getattr(ckpt, f), f
    assert len(back.carry_leaves) == 8      # two layers' LasanaState leaves
    for a, b in zip(back.carry_leaves + back.prev_ys,
                    ckpt.carry_leaves + ckpt.prev_ys):
        np.testing.assert_array_equal(a, b)
    assert_identical(back.acc_run, ckpt.acc_run)
    assert back.acc_run.layer_spikes is not None
    with np.load(path) as z:
        meta = json.loads(bytes(z["__manifest__"].tobytes()).decode())
        keys = set(z.files)
    assert meta["format_version"] == CKPT_FORMAT_VERSION == 1
    assert meta["kind"] == "stream_checkpoint"
    assert {"carry/0", "carry/7", "prev/0", "prev/1", "acc/outputs",
            "acc/out_spikes", "acc/hidden/1", "acc/energy", "acc/latency",
            "acc/events", "acc/flush_energy", "acc/n_circuits"} <= keys


@pytest.mark.parametrize("name", ["lif", "xbar", "mixed"])
def test_spec_key_matches_reference(name):
    from repro.serve.buckets import spec_content_key
    from repro_torch.resilience.checkpoint import spec_key_of
    from test_torch_stream import WORKLOADS
    desc, _ = WORKLOADS[name]()
    assert spec_key_of(_port_spec(desc)) == spec_content_key(_jax_spec(desc))
    other = dict(desc, edges=[(len(desc["layers"]) - 1,
                               len(desc["layers"]) - 1,
                               np.eye(desc["layers"][-1]["weight"].shape[1],
                                      dtype=np.float32))])
    assert spec_key_of(_port_spec(other)) != spec_key_of(_port_spec(desc))


@pytest.mark.parametrize("name", ["lif/lasana", "mixed/golden"])
def test_jax_checkpoint_resumes_in_the_port(libraries, name, tmp_path):
    import repro.lasana as jax_lasana
    import repro_torch.lasana as lasana
    desc, x, jkw, kw = _case(name, libraries)
    jspec = _jax_spec(desc)
    want = jax_lasana.simulate(jspec, jnp.asarray(x), record_hidden=False,
                               **jkw)
    chunks = list(jax_lasana.stream(jspec, jnp.asarray(x), chunk_ticks=CHUNK,
                                    checkpoint_every=1, **jkw))
    path = chunks[1].checkpoint.save(str(tmp_path / "jax_ck"))
    got = lasana.resume(path, _port_spec(desc), x, device="cpu",
                        surrogates=kw.get("surrogates"))
    _assert_matches_reference(got, want)


@pytest.mark.parametrize("name", ["lif/lasana", "mixed/golden"])
def test_port_checkpoint_resumes_in_the_reference(libraries, name, tmp_path):
    import repro.lasana as jax_lasana
    import repro_torch.lasana as lasana
    from repro.resilience import StreamCheckpoint as JaxCheckpoint
    desc, x, jkw, kw = _case(name, libraries)
    spec = _port_spec(desc)
    full = lasana.simulate(spec, x, record_hidden=False, device="cpu", **kw)
    chunks = list(lasana.stream(spec, x, chunk_ticks=CHUNK,
                                checkpoint_every=1, device="cpu", **kw))
    path = chunks[2].checkpoint.save(str(tmp_path / "port_ck"))
    jck = JaxCheckpoint.load(path)
    assert jck.k0 == 3 * CHUNK
    got = jax_lasana.resume(jck, _jax_spec(desc), jnp.asarray(x),
                            surrogates=jkw.get("surrogates"))
    _assert_matches_reference(full, got)


def test_resume_validates_checkpoint_and_engine(libraries, tmp_path):
    import repro_torch.lasana as lasana
    from repro_torch.core.network import NetworkEngine
    from repro_torch.resilience import StreamCheckpoint
    desc, x, _, kw = _case("lif/lasana", libraries)
    spec = _port_spec(desc)
    sur = kw["surrogates"]
    chunks = list(lasana.stream(spec, x, chunk_ticks=CHUNK,
                                checkpoint_every=1, device="cpu", **kw))
    ckpt = chunks[0].checkpoint
    other, _ = _mixed_net()
    with pytest.raises(ValueError, match="not the same network"):
        lasana.resume(ckpt, _port_spec(other), x, device="cpu",
                      surrogates=sur)
    with pytest.raises(ValueError, match="backend/mode"):
        NetworkEngine(spec, backend="golden", record_hidden=False,
                      device="cpu").stream(x, resume_from=ckpt)
    with pytest.raises(ValueError, match="record_hidden"):
        NetworkEngine(spec, device="cpu").stream(x, resume_from=ckpt,
                                                 surrogates=sur)
    eng = NetworkEngine(spec, record_hidden=False, device="cpu")
    with pytest.raises(ValueError, match="re-chunk exactly"):
        eng.stream(x, chunk_ticks=CHUNK + 1, resume_from=ckpt,
                   surrogates=sur)
    with pytest.raises(ValueError, match="checkpoint batch"):
        next(eng.stream(x[:, :2], resume_from=ckpt, surrogates=sur))
    with pytest.raises(ValueError, match="past the checkpoint offset"):
        next(eng.stream(x[:CHUNK], resume_from=ckpt, surrogates=sur))
    with pytest.raises(FileNotFoundError, match="no stream checkpoint"):
        StreamCheckpoint.load(str(tmp_path / "missing"))
    path = ckpt.save(str(tmp_path / "ck.npz"))
    with np.load(path) as z:
        arrays = dict(z)
    meta = json.loads(bytes(arrays["__manifest__"].tobytes()).decode())
    for field, value, match in (("format_version", 2, "format version"),
                                ("kind", "surrogate", "not a stream")):
        bad = dict(meta, **{field: value})
        arrays["__manifest__"] = np.frombuffer(json.dumps(bad).encode(),
                                               np.uint8)
        np.savez(str(tmp_path / "bad.npz"), **arrays)
        with pytest.raises(ValueError, match=match):
            StreamCheckpoint.load(str(tmp_path / "bad.npz"))
