"""Stream checkpoints (port of ``repro.resilience``)."""

from repro_torch.resilience.checkpoint import (CKPT_FORMAT_VERSION,
                                               StreamCheckpoint, spec_key_of)

__all__ = ["CKPT_FORMAT_VERSION", "StreamCheckpoint", "spec_key_of"]
