"""The port's roofline (``repro_torch/launch/roofline.py``): ``model_flops``
equal to the reference's for every config and applicable shape, the three
terms on hand numbers, the ring factors of the wire model, a kernel's
bound, and the H100 constants with their source."""

import inspect

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES  # noqa: E402
from repro.launch import roofline as ref_rf  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES, applicable_shapes,  # noqa: E402
                                 get_config)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402

CELLS = [(a, s) for a in ARCH_IDS for s in applicable_shapes(get_config(a))]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_reference(arch, shape):
    got = rf.model_flops(get_config(arch), SHAPES[shape])
    want = ref_rf.model_flops(ref_config(arch), REF_SHAPES[shape])
    assert got == want and got > 0


def test_roofline_terms_on_hand_numbers():
    colls = rf.CollectiveStats(counts={"all-reduce": 2}, operand_bytes={},
                               wire_bytes=9e9)
    r = rf.roofline({"flops": 989e12, "bytes accessed": 6.7e12}, colls,
                    model_flops_total=8 * 494.5e12, n_devices=8)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(0.02)
    assert r.dominant == "memory"
    assert r.model_flops_per_device == pytest.approx(494.5e12)
    assert r.useful_ratio == pytest.approx(0.5)
    assert set(r.as_dict()) == {f.name for f in
                                ref_rf.Roofline.__dataclass_fields__.values()}
    zero = rf.roofline({}, colls, model_flops_total=1.0, n_devices=1)
    assert zero.useful_ratio == 0.0 and zero.dominant == "collective"


def test_roofline_compute_term_takes_each_rate_at_its_peak():
    """Given the flops by rate, each rate's flops run at its own peak: a
    second of bf16 tensor-core work and a second of fp32 work take two."""
    colls = rf.CollectiveStats(counts={}, operand_bytes={}, wire_bytes=0)
    by_rate = {"bf16": 989e12, "fp32": 67e12, "fp32_unfused": 0}
    r = rf.roofline({"flops": 1056e12, "bytes accessed": 0.0,
                     "flops by rate": by_rate}, colls,
                    model_flops_total=1.0, n_devices=1)
    assert r.compute_s == pytest.approx(2.0)
    assert r.flops == 1056e12 and r.dominant == "compute"


@pytest.mark.parametrize("kind,factor", [
    ("all-gather", 3 / 4), ("all-reduce", 2 * 3 / 4), ("reduce-scatter", 3),
    ("all-to-all", 3 / 4), ("collective-permute", 1)])
def test_wire_bytes_use_the_reference_ring_factors(kind, factor):
    assert rf.wire_bytes(kind, 1024, 4) == factor * 1024
    # the reference's parse_collectives on one op of that kind agrees
    name = kind
    line = (f"%x = f32[256]{{0}} {name}(f32[64]{{0}} %p), "
            "replica_groups=[1,4]<=[4]")
    stats = ref_rf.parse_collectives(line)
    assert stats.wire_bytes == pytest.approx(float(rf.wire_bytes(
        kind, 1024, 4)))


def test_kernel_bound_is_the_larger_time():
    by_bytes = ops.Work(flops=10, bytes=int(3.35e12), rate="fp32")
    assert rf.bound_ms(by_bytes) == (pytest.approx(1e3), "bytes")
    by_ops = ops.Work(flops=int(989e12), bytes=1, rate="bf16")
    assert rf.bound_ms(by_ops) == (pytest.approx(1e3), "operations")
    unfused = ops.Work(flops=int(rf.PEAK_FP32_UNFUSED_OPS), bytes=1,
                       rate="fp32_unfused")
    assert rf.bound_ms(unfused)[0] == pytest.approx(1e3)


def test_constants_are_the_h100_data_sheet_figures():
    assert rf.PEAK_FLOPS == 989e12
    assert rf.PEAK_FP32_FLOPS == 67e12
    assert rf.HBM_BW == 3.35e12
    assert rf.LINK_BW == 450e9
    assert rf.PEAK_FP32_UNFUSED_OPS == 132 * 128 * 1.98e9
    src = inspect.getsource(rf)
    # each constant is named with its source on the line(s) above it
    for name in ("PEAK_FLOPS", "PEAK_FP32_FLOPS", "HBM_BW", "LINK_BW",
                 "PEAK_FP32_UNFUSED_OPS"):
        head = src.split(f"\n{name} = ", 1)[0].rsplit("\n\n", 1)[-1]
        assert "#" in head, name
    assert "H100" in src and "data sheet" in src
