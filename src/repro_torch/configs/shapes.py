"""Assigned input-shape suites (same four for every LM arch).

``train_*``   -> lowers train_step
``prefill_*`` -> lowers serve prefill
``decode_*``/``long_*`` -> lower serve_step: ONE new token against a KV/state
cache of ``seq_len`` (the cache for SSM/RG-LRU archs is O(1)/window-bounded;
that asymmetry is the point of the long_500k cell).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import Family, ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"
    # grad-accum microbatches for train cells (memory control at batch 256)
    num_microbatches: int = 1


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train", num_microbatches=8),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """long_500k needs sub-quadratic attention; skips recorded in DESIGN.md."""
    out = []
    for name in SHAPE_ORDER:
        if name == "long_500k" and not cfg.sub_quadratic:
            continue  # full-attention archs skip the 500k decode cell
        out.append(name)
    return out


def skip_reason(cfg: ModelConfig, shape_name: str) -> str | None:
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return "full-attention arch: O(S^2) at 524288 infeasible by design (see DESIGN.md)"
    return None
