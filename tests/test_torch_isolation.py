"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and
``kernel_sweep.py`` import neither JAX nor the JAX package (``repro``),
and the port runs with both made unimportable."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_imports_in_the_port():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "kernel_sweep.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


@pytest.mark.parametrize("module", [
    "core/network.py", "kernels/tick_megakernel.py", "kernels/lif_scan.py",
    "kernels/mlp_surrogate.py", "resilience/checkpoint.py",
    "resilience/__init__.py", "lasana.py",
    # the LM serve slice
    "configs/__init__.py", "configs/base.py", "configs/shapes.py",
    "configs/starcoder2_3b.py", "models/params.py", "models/layers.py",
    "models/attention.py", "models/transformer.py", "models/model.py",
    # the rest of the LM zoo
    "models/moe.py", "models/ssm.py", "models/rglru.py",
    "configs/deepseek_v3_671b.py", "configs/deepseek_moe_16b.py",
    "configs/mamba2_13b.py", "configs/recurrentgemma_2b.py",
    "configs/whisper_base.py", "configs/pixtral_12b.py",
    "data/lm_data.py", "launch/serve.py", "kernels/flash_attn.py",
    "kernels/ops.py", "convert.py",
    # the training slice
    "core/circuits.py", "core/events.py", "core/dataset.py",
    "core/models.py", "core/predictors.py", "core/surrogate.py",
    # the layer runners, the legacy bank shims and exploration
    "core/simulate.py", "core/persist.py", "core/explore.py",
    # serving, the engine side: faults, the watchdog, buckets, metrics,
    # the scheduler
    "resilience/faults.py", "ft/__init__.py", "ft/watchdog.py",
    "serve/__init__.py", "serve/buckets.py", "serve/metrics.py",
    "serve/scheduler.py",
    # serving, the server: the store, the server, the protocol, the driver
    "serve/store.py", "serve/server.py", "serve/protocol.py",
    "serve/__main__.py",
    # batch parallelism and LM training
    "launch/mesh.py", "core/distributed.py", "sharding.py", "ft/elastic.py",
    "optim.py", "tree.py", "train/step.py",
    "checkpoint/__init__.py", "checkpoint/manager.py", "launch/train.py",
    # tensor-parallel placement
    "core/collectives.py",
    # the dry run, its cost model and the roofline
    "launch/hlo_cost.py", "launch/roofline.py", "launch/dryrun.py",
    "launch/dryrun_lasana.py",
    # the static gates
    "analysis/__init__.py", "analysis/__main__.py",
    "analysis/jaxpr_audit.py", "analysis/thread_lint.py",
    "analysis/api_surface.py"])
def test_streaming_modules_import_neither_jax_nor_reference(module):
    """The modules of the streaming, LM serve (the whole zoo), training,
    layer-runner, exploration, serving, batch-parallel and LM-training
    slices, the collectives of tensor-parallel placement, the dry run's
    modules and the static gates (``repro_torch.analysis``), one by one
    (``core/events.py`` keeps its own copy of the reference's pure
    numpy module, whose package would import jax): no
    ``jax`` and no ``repro`` import, not even a lazy one inside a function
    (the reference imports ``repro.serve.buckets`` for the checkpoint's
    spec hash; the port keeps its own copy)."""
    mods = set(_imported_modules(PORT / module))
    assert not {m for m in mods if m.split(".")[0] in ("jax", "jaxlib",
                                                       "repro")}
    assert mods


def test_port_runs_with_jax_and_reference_unimportable():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import pkgutil, importlib, repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        import repro_torch.lasana as lasana
        from repro_torch.convert import spec_from_numpy
        rng = np.random.default_rng(0)
        ws = [rng.normal(0, 1, (6, 5)).astype(np.float32),
              rng.normal(0, 1, (5, 3)).astype(np.float32)]
        spec = spec_from_numpy(ws, [np.array([0.58, 0.5, 0.5, 0.5])] * 2)
        x = ((rng.random((4, 2, 6)) < 0.4) * 1.5).astype(np.float32)
        sur = lasana.load(sys.argv[1], device="cpu")
        run = lasana.simulate(spec, x, surrogates=sur, device="cpu")
        assert run.outputs.shape == (2, 3)
        from repro_torch.convert import crossbar_spec_from_numpy
        xspec = crossbar_spec_from_numpy([rng.integers(-1, 2, (40, 3))])
        volts = rng.uniform(-0.8, 0.8, (2, 40)).astype(np.float32)
        xrun = lasana.simulate(xspec, volts, backend="golden", device="cpu")
        assert xrun.outputs.shape == (2, 3) and xrun.out_spikes is None
        assert xrun.events.sum() == 2 * 3 * 2
        chunks = list(lasana.stream(spec, x, chunk_ticks=2, surrogates=sur,
                                    checkpoint_every=1, device="cpu"))
        full = lasana.simulate_stream(spec, x, chunk_ticks=2,
                                      surrogates=sur, device="cpu")
        res = lasana.resume(chunks[0].checkpoint, spec, x, surrogates=sur,
                            device="cpu")
        assert np.array_equal(res.energy, full.energy)
        assert np.array_equal(full.outputs, run.outputs)
        trained = lasana.train("crossbar", lasana.TrainConfig(
            n_runs=12, n_steps=10, families=("mean", "linear")),
            device="cpu")
        assert set(trained.fit_info) == {"M_O", "M_V", "M_ED", "M_ES", "M_L"}
        from repro_torch.core import simulate
        stim = simulate.make_stimulus("lif", 6, 5, seed=0, device="cpu")
        golden = simulate.run_golden("lif", *stim)
        lz = simulate.run_lasana(sur, "lif", *stim,
                                 oracle_states=golden.states)
        assert lz.outputs.shape == golden.states.shape == (5, 6)
        from repro_torch.core.explore import DSEEngine
        rep = lasana.explore(lasana.CandidateSpec.sample(4, seed=0), trained,
                             engine=DSEEngine(n_samples=8, device="cpu"))
        assert rep.compile_count == 1 and len(rep.pareto()) >= 1
        import tempfile, warnings
        from repro_torch.core import persist
        with tempfile.TemporaryDirectory() as d, warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            persist.save_bank(trained, d + "/x.npz")
            assert persist.load_bank(d + "/x.npz", device="cpu").circuit \
                == "crossbar"
        import contextlib, io
        from repro_torch.launch import serve
        with contextlib.redirect_stdout(io.StringIO()):
            res = serve.serve(serve.parser().parse_args(
                ["--arch", "starcoder2-3b", "--reduced", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "8", "--gen", "3"]))
        assert res["generated"].shape == (2, 3) and res["logits_finite"]
        for arch in ("deepseek-v3-671b", "mamba2-1.3b", "recurrentgemma-2b",
                     "whisper-base", "pixtral-12b"):
            with contextlib.redirect_stdout(io.StringIO()):
                res = serve.serve(serve.parser().parse_args(
                    ["--arch", arch, "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--gen", "2"]))
            assert res["logits_finite"], arch
        from repro_torch.serve import Bucket, Lane, RequestHandle
        lane = Lane(lasana.engine(spec, record_hidden=False, device="cpu"),
                    spec, Bucket("k", 2, 3), sur)
        q = type("Q", (), {"handle": RequestHandle(0, "t"),
                           "stimulus": x[:, 1:]})()
        assert lane.admit(q)
        while lane.active:
            lane.step()
        solo = lasana.simulate(spec, x[:, 1:], surrogates=sur, device="cpu")
        assert np.array_equal(q.handle.result().events, solo.events)
        from repro_torch.serve import run_stdio
        with lasana.serve(slot_widths=(2,), chunk_ticks=3,
                          device="cpu") as srv:
            srv.register_surrogate_path("lif", sys.argv[1])
            h = srv.submit(spec, x[:, 1:], surrogates="lif")
            assert np.array_equal(h.result(timeout=120).events, solo.events)
            import json
            out = io.StringIO()
            run_stdio(srv, io.StringIO(json.dumps({"op": "stats"}) + "\\n"),
                      out)
            assert json.loads(out.getvalue())["stats"]["surrogates"] == {
                "lif": [1]}
        from repro_torch.analysis import api_surface, jaxpr_audit
        from repro_torch.analysis import thread_lint
        assert thread_lint.run_lint() == [] and api_surface.check_api() == []
        with jaxpr_audit.pinned_env():
            _, found = jaxpr_audit.audit_entry(
                "network_mono_kernel", lambda n: jaxpr_audit.
                _entry_network_mono_kernel(jaxpr_audit.build_context("cpu"), n))
        assert found == []
        assert not any(k == "jax" or k.startswith(("jax.", "repro."))
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-c", code,
         str(PORT / "artifacts" / "lif_packable.npz")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
