"""Tensor-parallel runs of the five reduced configs with other mixers —
MoE with GQA or MLA (DeepSeekMoE-16B, DeepSeek-V3 with its MTP head),
the encoder-decoder (Whisper), Mamba-2 and the Griffin hybrid
(RecurrentGemma) — in fp32, as ``tests/test_torch_tp_zoo.py`` runs the
dense ones: loss, gradients, prefill and 3 decode steps (``kv_seq``
too) on ``(1, 2)``, ``(2, 2)`` and ``(1, 4)`` against the unsharded port
and the reference. Plus Mamba-2's gated norm: a per-shard norm (no
cross-shard sum of squares) is caught."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_tp_zoo as tz  # noqa: E402

ARCHS = ("deepseek-moe-16b", "deepseek-v3-671b", "whisper-base",
         "mamba2-1.3b", "recurrentgemma-2b")


@pytest.mark.parametrize("shape", tz.MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_mixer_config_sharded_matches(arch, shape):
    tz.check_arch(arch, shape)


def test_mamba2_gated_norm_needs_the_cross_shard_sum(monkeypatch):
    """The gated RMSNorm averages over all of d_inner. With each shard's
    own mean of squares in place of the all-reduced one, the sharded
    prefill is off by far more than the tolerance; with the sum it is
    within it."""
    import torch.nn.functional as F

    from repro_torch.models import ssm
    ref = tz.unsharded("mamba2-1.3b")
    got = tz.run_sharded("mamba2-1.3b", (1, 2), kv_seq=False)
    tz.close(got["logits"][0], ref["logits"][0], "prefill")

    def per_shard(ws, ys, zs, d_inner, eps, group):
        gs = [y * F.silu(z.float()).to(y.dtype) for y, z in zip(ys, zs)]
        return [((g.float() * torch.rsqrt(torch.mean(
            torch.square(g.float()), dim=-1, keepdim=True) + eps))
            * w.float()).to(g.dtype) for g, w in zip(gs, ws)]
    monkeypatch.setattr(ssm, "gated_norm_tp", per_shard)
    bad = tz.run_sharded("mamba2-1.3b", (1, 2), kv_seq=False)
    g = bad["logits"][0].double()
    w = ref["logits"][0].double()
    err = float((g - w).abs().max() / w.abs().max())
    assert err > 100 * tz.TP_REL, err
    assert np.isfinite(err)
