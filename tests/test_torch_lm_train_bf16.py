"""One bf16 train step of the dense decoders and the VLM (their own
dtypes: bf16 parameters and activations) through both packages from the
same rounded weights and batch: the loss within 2e-2, the reference's own
bound between its sharded and single-device steps
(tests/test_distributed.py); tests/test_torch_lm_train_bf16_zoo.py holds
the other five configs. Also the encoder-decoder's fp32 steps (the
limits of tests/test_torch_lm_train.py), here for the files' run times."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

import test_torch_fixtures as fx  # noqa: E402

DENSE = ["starcoder2-3b", "granite-3-8b", "deepseek-67b",
         "mistral-large-123b", "pixtral-12b"]


@pytest.mark.parametrize("arch", DENSE)
def test_bf16_train_step_matches_reference(arch):
    fx.assert_bf16_step_matches_reference(arch)


@pytest.mark.parametrize("arch", ["whisper-base"])
def test_fp32_train_steps_match_reference(arch):
    fx.assert_train_matches_reference(arch)
