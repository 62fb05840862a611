"""The port's dry run (``repro_torch/launch/dryrun.py``,
``dryrun_lasana.py``, ``launch/mesh.py:make_production_mesh``): the
production meshes, a cell's record with the reference's keys, skipped
cells, the LASANA tick's arguments against a hand count, and that no dry
run allocates anywhere but on the meta device or launches a kernel."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.shapes import skip_reason as ref_skip  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.core.distributed import abstract_sim_inputs  # noqa: E402
from repro_torch.core.surrogate import Surrogate  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun, dryrun_lasana, hlo_cost  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402

import test_torch_fixtures as fx  # noqa: E402

# the reference's record of an "ok" cell (launch/dryrun.py:112-147), less
# the keys with no counterpart in the port (no XLA compile, no XLA cost
# analysis)
REF_KEYS = {"cell", "arch", "shape", "mesh", "status", "skip_reason",
            "lower_s", "compile_s", "n_devices", "memory", "cost",
            "collectives", "roofline", "model_flops_total"}
REF_MEMORY = {"argument_bytes_per_device", "output_bytes_per_device",
              "temp_bytes_per_device", "alias_bytes_per_device",
              "peak_live_bytes_per_device"}
REF_COST = {"flops_per_device", "bytes_per_device",
            "transcendentals_per_device", "xla_flops_uncorrected",
            "xla_bytes_uncorrected"}
NO_COUNTERPART = {"compile_s", "xla_flops_uncorrected",
                  "xla_bytes_uncorrected"}


def _small_mesh(*, multi_pod=False):
    if multi_pod:
        return mesh_mod.make_mesh((2, 1, 4), ("pod", "data", "model"),
                                  ["meta"] * 8)
    return mesh_mod.make_mesh((2, 4), ("data", "model"), ["meta"] * 8)


@pytest.mark.parametrize("multi_pod,shape,axes", [
    (False, (16, 16), ("data", "model")),
    (True, (2, 16, 16), ("pod", "data", "model"))])
def test_production_mesh_is_the_references_on_meta(multi_pod, shape, axes):
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    assert mesh.devices.shape == shape and mesh.axis_names == axes
    assert {d.type for d in mesh.flat()} == {"meta"}
    info = mesh_mod.mesh_info(mesh)
    assert info == {"shape": dict(zip(axes, shape)),
                    "n_devices": int(np.prod(shape)),
                    "axis_names": list(axes)}


@pytest.fixture
def small_cells(monkeypatch):
    """run_cell on each arch's reduced config over a (2, 4) meta mesh (a
    (2, 1, 4) one for --multi-pod), at the cells' own shapes."""
    monkeypatch.setattr(dryrun, "get_config", reduced_config)
    monkeypatch.setattr(dryrun, "make_production_mesh", _small_mesh)


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("starcoder2-3b", "decode_32k", False),
    ("granite-3-8b", "decode_32k", True),
    ("mamba2-1.3b", "long_500k", False)])
def test_run_cell_writes_the_reference_keys(small_cells, tmp_path, arch,
                                            shape, multi_pod):
    before = dict(ops.LAUNCHES)
    rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                          out_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("traceback")
    assert ops.LAUNCHES == before
    assert REF_KEYS - NO_COUNTERPART <= set(rec)
    assert not NO_COUNTERPART & set(rec)
    assert set(rec["memory"]) == REF_MEMORY
    assert REF_COST - NO_COUNTERPART <= set(rec["cost"])
    assert not NO_COUNTERPART & set(rec["cost"])
    assert set(rec["collectives"]) == {"counts", "wire_bytes_per_device"}
    assert rec["n_devices"] == 8
    m = rec["memory"]
    assert m["peak_live_bytes_per_device"] == (
        m["argument_bytes_per_device"] + m["output_bytes_per_device"]
        + m["temp_bytes_per_device"] - m["alias_bytes_per_device"])
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["roofline"]["flops"] == rec["cost"]["flops_per_device"]
    mesh_tag = "multipod" if multi_pod else "singlepod"
    path = tmp_path / f"{arch}__{shape}__{mesh_tag}.json"
    assert json.loads(path.read_text())["cell"] == rec["cell"]
    # a written cell is read back, not run again
    again = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                            out_dir=str(tmp_path))
    assert again == json.loads(path.read_text())


@pytest.mark.parametrize("arch", ["starcoder2-3b", "deepseek-v3-671b",
                                  "pixtral-12b"])
def test_skipped_cells_write_the_references_reason(tmp_path, arch):
    rec = dryrun.run_cell(arch, "long_500k", multi_pod=False,
                          out_dir=str(tmp_path))
    assert rec["status"] == "skip"
    assert rec["skip_reason"] == ref_skip(ref_config(arch), "long_500k")
    assert rec["skip_reason"]
    stored = json.loads((tmp_path / f"{rec['cell']}.json").read_text())
    assert stored == rec


def test_lower_allocates_only_meta_and_launches_nothing():
    cfg = reduced_config("deepseek-v3-671b")
    mesh = _small_mesh()
    before = dict(ops.LAUNCHES)
    for shape in dryrun.SHAPES.values():
        if shape.kind == "train":
            continue
        lw = dryrun.lower(cfg, ShapeConfig(
            shape.name, 64, 8, shape.kind), mesh, dryrun.train_rules(mesh))
        assert lw.devices == {"meta"}
    assert ops.LAUNCHES == before


def test_lasana_tick_arguments_are_the_inputs_and_the_surrogate():
    """One tick of 1,024 LIF circuits on a (2, 4) meta mesh: each device's
    arguments are its block of abstract_sim_inputs plus the whole
    surrogate; the tick is one network_tick a device, launched nowhere."""
    sur = Surrogate.load(str(fx.ARTIFACTS / "lif_packable.npz"),
                         device="cpu")
    mesh = _small_mesh()
    n = 1024
    state, changed, x, t = abstract_sim_inputs(n // 8, 3, 4)
    want = sum(a.numel() * a.element_size()
               for a in (*state, changed, x, t))
    want += sum(a.numel() * a.element_size()
                for d in sur.params.values() for a in d.values())
    before = dict(ops.LAUNCHES)
    rec = dryrun_lasana.run(sur, n=n, mesh=mesh, out_dir=None)
    assert ops.LAUNCHES == before
    assert rec["memory"]["argument_bytes_per_device"] == want
    assert rec["kernels"] == {"network_tick": 1}
    assert rec["collectives"]["counts"]["all-reduce"] == 2
    assert rec["n_devices"] == 8 and rec["status"] == "ok"
    useful = dryrun_lasana.INVOCATIONS * dryrun_lasana.MLP_FLOPS * n
    assert rec["roofline"]["model_flops_per_device"] == useful / 8


def test_lasana_tick_dry_run_allocates_no_device_memory():
    """Every op of the tick's dry run lands on the meta device, but for
    ``pack_heads``' width probes: (1, F) zeros on the host."""
    sur = Surrogate.load(str(fx.ARTIFACTS / "lif_packable.npz"),
                         device="cpu")
    from repro_torch.core.distributed import lower_distributed_step
    counter_devices = []
    orig = hlo_cost.Counter.stats

    def stats(self, outputs=()):
        counter_devices.append(set(self.devices))
        return orig(self, outputs)
    hlo_cost.Counter.stats = stats
    try:
        lower_distributed_step(sur, _small_mesh(), 256, 3, 4, clock_ns=5.0,
                               spiking=True)
    finally:
        hlo_cost.Counter.stats = orig
    assert counter_devices == [{"meta", "cpu"}]
