"""The plain reference against the port run on the CPU (``device="cpu"``,
the kernels' plain versions) through a whole run of each traffic kind at a
tiny size: every cell comes out correct, with spikes to compare."""

import pathlib

import pytest

from lasana_bench import harness, run

ROOT = pathlib.Path(__file__).resolve().parents[1]


def tiny(cell: str):
    """``(manifest, cfg, traffic)`` of ``cell`` cut to a CPU test's size:
    4 digits, 10 ticks a call, or 4-tick chunks."""
    m = harness.load_manifest(ROOT / "BENCHMARK.json")
    _, cfg, tr = harness.resolve_cell(m, cell)
    tr = dict(tr, batch=4)
    if tr["kind"] == "stream":
        tr.update(chunk_ticks=4, pool_blocks=2, check_chunks=3,
                  profile_chunks=[1, 3])
    else:
        tr.update(sample_calls=2, profile_calls=1)
        cfg = dict(cfg, ticks=min(cfg["ticks"], 10))
    return m, cfg, tr


def run_tiny(cell: str, trace: bool = False, seed: int = 2 ** 40 + 3):
    m, cfg, tr = tiny(cell)
    return run.run_cell(m, cell, seed, 0.0, trace, device="cpu", cfg=cfg,
                        traffic=tr)


def cells():
    return [w["name"] for w in
            harness.load_manifest(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("cell", cells())
def test_port_on_cpu_matches_the_reference(cell):
    res, lines = run_tiny(cell)
    assert res["correct"], lines
    assert res["failed"] == 0 and res["attempted"] >= 1
    gaps = {k: c["value"] for k, c in res["checks"].items()}
    assert all(v <= 1e-5 for v in gaps.values()), gaps


@pytest.mark.parametrize("cell", cells())
def test_reference_has_work_to_compare(cell):
    from lasana_bench import control
    m, cfg, tr = tiny(cell)
    wl, _ = control.workload(m, cell, 11, "cpu", cfg=cfg, traffic=tr)
    wl.setup(warm=False)
    recs, rows = wl.reference_run()
    changed, out_changed = rows[..., 0].sum(0), rows[..., 2].sum(0)
    assert (changed > 0).all() and (out_changed > 0).all(), rows.sum(0)
    assert all(r["energy"].sum() > 0 for r in recs)
