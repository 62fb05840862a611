"""One bf16 train step of the MoE, MLA + MTP, encoder-decoder, Mamba-2
and Griffin configs through both packages, the loss within 2e-2 (the
limit of tests/test_torch_lm_train_bf16.py). The MoE routers are as
drawn: a top-k choice that bf16 rounding flips moves one token's loss,
not the batch's beyond the bound."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

import test_torch_fixtures as fx  # noqa: E402

ZOO = ["deepseek-moe-16b", "deepseek-v3-671b", "whisper-base",
       "mamba2-1.3b", "recurrentgemma-2b"]


@pytest.mark.parametrize("arch", ZOO)
def test_bf16_train_step_matches_reference(arch):
    fx.assert_bf16_step_matches_reference(arch)
