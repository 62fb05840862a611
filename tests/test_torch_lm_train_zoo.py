"""LM training parity in fp32 for the five configs beside the dense
decoders: the two MoE configs (routers as drawn: in fp32 the top-k
choices agree), DeepSeek-V3 with its multi-token-prediction head
(``mtp_ce``), the encoder-decoder, Mamba-2 and the Griffin hybrid. The
limits are tests/test_torch_lm_train.py's."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

import test_torch_fixtures as fx  # noqa: E402

ZOO = ["deepseek-moe-16b", "deepseek-v3-671b", "mamba2-1.3b",
       "recurrentgemma-2b"]


@pytest.mark.parametrize("arch", ZOO)
def test_fp32_train_steps_match_reference(arch):
    fx.assert_train_matches_reference(arch)

