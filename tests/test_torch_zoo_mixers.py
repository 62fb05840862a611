"""Port parity at the model level (tests/test_torch_zoo.py's check and
limits) for the configs with other mixers: MoE (DeepSeekMoE-16B's GQA,
DeepSeek-V3's MLA, both with zeroed routers as that file says), Mamba-2
and the Griffin interleave."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_fixtures as fx  # noqa: E402


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b",
                                  "mamba2-1.3b", "recurrentgemma-2b"])
def test_prefill_decode_and_forward_match_reference(arch):
    fx.assert_model_matches_reference(arch)
