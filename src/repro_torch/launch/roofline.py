"""Roofline accounting of the dry run, the JAX package's
``launch/roofline.py`` (``:1-174``) in PyTorch, with the H100's peaks.

Three terms per (arch x shape x mesh) cell, all **per device** (a mesh
entry of the dry run stands for one card):

    compute    = flops          / PEAK_FLOPS   (or, given the flops by
                                               rate, each over RATES[rate])
    memory     = bytes accessed / HBM_BW
    collective = bytes on wire  / LINK_BW

The flops, bytes and wire bytes come from ``launch/hlo_cost.py``, which
counts the traced aten ops of the step on meta tensors. The reference's
``parse_collectives`` reads collectives out of the partitioned HLO text;
the port has no HLO, so its counterpart is the counter in
``core/collectives.py``: every collective records its kind, group size
and per-device output bytes while ``hlo_cost`` counts, with the ring
factors of :func:`wire_bytes` (the reference's ``:36-44``).

Hardware model: one NVIDIA H100 SXM5 (80 GB HBM3, 700 W), from NVIDIA's
H100 Tensor Core GPU data sheet — dense (no sparsity) peaks. NVLink's
bytes per second in one direction take the place of the reference's ICI
link.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM5 data sheet: BF16 tensor-core peak, dense (1,979 TFLOP/s
# is the 2:4-sparse figure)
PEAK_FLOPS = 989e12
# the same sheet's FP32 peak (non-tensor core; a fused multiply-add counts
# two operations)
PEAK_FP32_FLOPS = 67e12
# the same sheet's HBM3 bandwidth
HBM_BW = 3.35e12
# fourth-generation NVLink: 900 GB/s a GPU, 450 GB/s in each direction
LINK_BW = 450e9
# unfused fp32 operations: 132 SMs x 128 fp32 lanes x 1.98 GHz (the boost
# clock), one operation a lane a cycle — the rate of kernels built with
# --fmad=false, which have no fused multiply-add
SM_CLOCK_HZ = 1.98e9
PEAK_FP32_UNFUSED_OPS = 132 * 128 * SM_CLOCK_HZ

# the peak each kind of operation runs at (``ops.Work.rate``)
RATES = {"bf16": PEAK_FLOPS, "fp32": PEAK_FP32_FLOPS,
         "fp32_unfused": PEAK_FP32_UNFUSED_OPS}

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def wire_bytes(kind: str, out_bytes, n: int):
    """Ring-algorithm bytes one device puts on the wire for a collective
    of ``kind`` over ``n`` participants with ``out_bytes`` of output on
    that device (the reference's ``parse_collectives`` factors):
    all-gather out(n-1)/n, all-reduce 2 out(n-1)/n, reduce-scatter
    out(n-1), all-to-all out(n-1)/n, collective-permute out."""
    from fractions import Fraction
    if kind == "all-gather" or kind == "all-to-all":
        return Fraction(out_bytes * (n - 1), n)
    if kind == "all-reduce":
        return Fraction(2 * out_bytes * (n - 1), n)
    if kind == "reduce-scatter":
        return Fraction(out_bytes * (n - 1))
    if kind == "collective-permute":
        return Fraction(out_bytes)
    raise ValueError(f"unknown collective {kind!r}")


def bound_ms(work) -> tuple:
    """``(ms, "bytes" | "operations")``: the least time one card could
    take for a kernel's ``ops.Work`` — the larger of its bytes over the
    memory rate and its operations over the peak of their kind."""
    t_b = work.bytes / HBM_BW
    t_f = work.flops / RATES[work.rate]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    operand_bytes: dict       # per kind, per-device operand bytes
    wire_bytes: float         # per-device ring-traffic bytes

    def total_operand_bytes(self) -> float:
        return float(sum(self.operand_bytes.values()))


@dataclasses.dataclass
class Roofline:
    flops: float              # per-device
    hbm_bytes: float          # per-device
    wire_bytes: float         # per-device
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_per_device: float
    useful_ratio: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline(cost_analysis: dict, colls: CollectiveStats, *,
             model_flops_total: float, n_devices: int) -> Roofline:
    """The three terms of one cell (the reference's ``roofline``,
    ``launch/roofline.py:148``): ``cost_analysis`` holds per-device
    ``"flops"`` and ``"bytes accessed"``, and may hold ``"flops by
    rate"`` (``hlo_cost.CostTotals.flops_by_rate``): then each rate's
    flops run at its own peak (:data:`RATES`), else all at the bf16
    tensor-core peak, as the reference's one peak."""
    flops = float(cost_analysis.get("flops", 0.0))
    hbm = float(cost_analysis.get("bytes accessed", 0.0))
    wire = float(colls.wire_bytes)
    by_rate = cost_analysis.get("flops by rate")
    t_c = flops / PEAK_FLOPS if by_rate is None else sum(
        float(f) / RATES[r] for r, f in by_rate.items())
    t_m = hbm / HBM_BW
    t_n = wire / LINK_BW
    dom = max((("compute", t_c), ("memory", t_m), ("collective", t_n)),
              key=lambda kv: kv[1])[0]
    mf = model_flops_total / n_devices
    return Roofline(
        flops=flops, hbm_bytes=hbm, wire_bytes=wire,
        compute_s=t_c, memory_s=t_m, collective_s=t_n, dominant=dom,
        model_flops_per_device=mf,
        useful_ratio=(mf / flops) if flops else 0.0,
    )


def model_flops(cfg, shape) -> float:
    """6*N*D (train) / 2*N*D (prefill) / 2*N*B (decode), N = active params
    (the reference's ``:167``)."""
    n = cfg.active_param_count() if cfg.moe is not None else cfg.param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: one token per seq
