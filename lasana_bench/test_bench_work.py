"""The frozen operation and byte counts against values worked out by hand
at a tiny shape."""

import numpy as np
import pytest

from lasana_bench.work import counts

TINY_MLP = {"w0": np.zeros((4, 3)), "w1": np.zeros((3, 2))}


def tiny_shapes(fam_es="mlp"):
    fams = {p: "mlp" for p in ("M_ES", "M_V", "M_O", "M_ED", "M_L")}
    fams["M_ES"] = fam_es
    arrays = {p: TINY_MLP for p in fams}
    if fam_es == "gbdt":
        arrays["M_ES"] = {"feat": np.zeros((44, 255))}
    return counts.head_shapes(fams, arrays)


def test_head_flops_by_hand():
    # 2f standardise + 2(f h1 + h1 h2 + h2) products + 2(h1 + h2) bias and
    # relu + 4 destandardise
    assert counts.mlp_head_flops(4, 3, 2) == 8 + 40 + 10 + 4
    assert counts.mlp_head_flops(12, 100, 50) == 12828
    assert counts.head_flops("linear", 4, 3, 2) == 20
    assert counts.head_flops("mean", 4, 3, 2) == 3


def test_network_tick_by_hand():
    # LIF row: 3 inputs, v, tau, 4 params, the derived column = 10 wide
    assert counts.row_width("lif") == 10
    assert counts.row_width("crossbar") == 32 + 2 + 33 + 1
    shapes = tiny_shapes()
    # active heads 3 x 110 on 4 changed rows, idle 2 x 110 on 1 stale row,
    # transition 2 x 126 (two columns wider) on 2 output-changed rows
    flops, nbytes = counts.network_tick("lif", shapes, 10, (4, 1, 2))
    assert flops == 4 * 330 + 220 + 2 * 252
    # 10 rows x (v, o, t_last, 3 inputs, 4 params, the mask) read and 5
    # outputs written, plus the pack: 3 heads of 5 x 10 + 17 floats and 2
    # of 5 x 12 + 17
    assert nbytes == 10 * 41 + 10 * 20 + (3 * 67 + 2 * 77) * 4


def test_mlp_heads_and_least_time_by_hand():
    assert counts.mlp_heads(5, 4, 2, 3, 2) == (5 * 2 * 62,
                                               (20 + 2 * 36 + 10) * 4)
    assert counts.least_seconds(counts.PEAK_FP32_FLOPS, 0) == 1.0
    assert counts.least_seconds(0, counts.PEAK_HBM_BYTES) == 1.0
    assert counts.least_seconds(counts.PEAK_FP32_FLOPS,
                                2 * counts.PEAK_HBM_BYTES) == 2.0


@pytest.mark.parametrize("fam, per_row", [("mlp", 110), ("gbdt", 44 * 9)])
def test_simulate_flops_by_hand(fam, per_row):
    shapes = tiny_shapes(fam)
    # M_ES is the only head that changes: once active, once idle
    got = counts.simulate_flops("lif", shapes, (4, 1, 2), drive_flops=7)
    assert got == 4 * (per_row + 220) + (per_row + 110) + 2 * 252 + 7
