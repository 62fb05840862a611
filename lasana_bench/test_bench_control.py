"""The control of ``correct``: the plain reference with every matrix
product's operands rounded to TF32 (one precision below the
configurations' fp32), put in the program's place, comes out not correct
against the fp32 reference under each cell's limits, on three seeds, at a
size a test run holds; ``control.py`` reads the same at the cells' own
sizes on the card. The program on the same seeds comes out correct."""

import pytest

from lasana_bench import control
from lasana_bench.test_bench_reference import cells, tiny


@pytest.mark.parametrize("seed", [3, 2 ** 35 + 17, 2 ** 62 + 1])
@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct(cell, seed):
    m, cfg, tr = tiny(cell)
    low = control.control_reading(m, cell, seed, "cpu", cfg=cfg, traffic=tr)
    assert not low["correct"], low
    prog = control.program_reading(m, cell, seed, "cpu", cfg=cfg, traffic=tr)
    assert prog["correct"], prog


def test_tf32_rounding_keeps_ten_mantissa_bits():
    import torch
    from lasana_bench.reference.lasana_ref import tf32_round
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -12,
                      1.0 + 2 ** -12, -3.0])
    assert tf32_round(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10,
                                      1.0, -3.0]
