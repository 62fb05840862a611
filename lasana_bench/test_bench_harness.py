"""The harness on the CPU: the manifest's checks, finding what a cell owns
by name in new files, and refusing to run without a card or a program."""

import copy
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from lasana_bench import harness, run

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = {"batch": 4, "sample_calls": 1, "profile_calls": 1}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest(ROOT / "BENCHMARK.json")


def test_manifest_is_sound(manifest):
    assert harness.check_manifest(manifest) == []
    assert all(w["chips"] == 1 for w in manifest["workloads"])


@pytest.mark.parametrize("edit, want", [
    (lambda m: m["workloads"][0].update(chips=4), "chips must be 1"),
    (lambda m: m["end_to_end"][0].update(unit="events per s"), "unit"),
    (lambda m: m["per_layer"][0].update(moves="nothing"), "moves"),
    (lambda m: m["per_layer"][0].update(name="no such/metric"), "name"),
    (lambda m: m["end_to_end"][0].update(unit="x" * 17), "unit"),
    (lambda m: m["workloads"][0].update(traffic="missing"), "traffic"),
    (lambda m: m["end_to_end"].pop(), "setup_s"),
    (lambda m: m["end_to_end"][0].update(bound=0.3), "bound"),
])
def test_manifest_faults_are_refused(manifest, edit, want):
    m = copy.deepcopy(manifest)
    edit(m)
    bad = harness.check_manifest(m)
    assert any(want in b for b in bad), bad


def test_moves_must_be_reported_where_the_metric_is(manifest):
    m = copy.deepcopy(manifest)
    m["per_layer"].append({
        "name": "p95_only", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "engine",
        "moves": "chunk_p95_ms"})          # no workloads: every cell
    bad = harness.check_manifest(m)
    assert any("does not report chunk_p95_ms" in b for b in bad), bad


def _new_files(tmp_path):
    """A copy of the benchmark's folder with a configuration, a traffic
    mix and a per-layer metric added as new files under new names."""
    bench = tmp_path / "lasana_bench"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    cfg = json.loads((bench / "configs" / "snn_784_128_10.json").read_text())
    cfg["name"] = "tmp_cfg_x1"
    (bench / "configs" / "tmp_cfg_x1.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "mnist10k_packable.json")
                    .read_text())
    tr.update(TINY)
    (bench / "traffic" / "tmp_traffic_x1.json").write_text(json.dumps(tr))
    (bench / "metrics" / "tmp_metric_x1.py").write_text(
        "def read(ctx):\n    return 42.0 + ctx.slice_ticks * 0\n")
    return bench


def test_new_cell_config_and_metric_need_only_new_files(manifest, tmp_path):
    bench = _new_files(tmp_path)
    m = copy.deepcopy(manifest)
    m["configs"].append({"name": "tmp_cfg_x1", "source": "https://x.org/y",
                         "file": "lasana_bench/configs/tmp_cfg_x1.json",
                         "reduced": [], "why": "a new configuration"})
    m["workloads"].append({"name": "tmp_cell_x1", "config": "tmp_cfg_x1",
                           "traffic": "tmp_traffic_x1", "chips": 1,
                           "why": "a new cell"})
    m["per_layer"].append({"name": "tmp_metric_x1", "unit": "ops/tick",
                           "better": "lower", "source": "device_trace",
                           "layer": "engine", "moves": "events_per_s",
                           "workloads": ["tmp_cell_x1"]})
    assert harness.check_manifest(m, bench) == []
    w, cfg, tr = harness.resolve_cell(m, "tmp_cell_x1", bench)
    assert cfg["name"] == "tmp_cfg_x1" and tr["batch"] == TINY["batch"]
    cfg = dict(cfg, ticks=8)
    res, lines = run.run_cell(m, "tmp_cell_x1", 7, 0.0, True,
                              device="cpu", cfg=cfg, traffic=tr, bench=bench)
    assert res["metrics"]["tmp_metric_x1"]["value"] == 42.0
    assert res["correct"], lines
    line = json.loads(harness.result_line(**res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"] and list(line)[-1] == "checks"


def test_no_result_without_a_card_or_the_program(tmp_path):
    """The CLI in a copy holding only BENCHMARK.json and the benchmark's
    folder (no program, no card here) exits non-zero and prints no
    result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH, tmp_path / "lasana_bench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    r = subprocess.run(
        [sys.executable, "lasana_bench/run.py", "--workload",
         "snn_mnist10k_packable", "--seed", str(2 ** 33 + 5), "--seconds",
         "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_forbidden_modules_compare_whole_names():
    names = ["repro_torch", "repro_torch.lasana", "jaxtyping", "torch"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["repro.core.network",
                                              "jax"]) == ["jax", "repro"]
