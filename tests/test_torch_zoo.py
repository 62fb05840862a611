"""Port parity: the LM zoo at the model level
(``repro_torch.models.model.Model`` against the JAX package's ``Model``)
for the attention-only configs — the four dense decoders, the VLM and the
encoder-decoder; tests/test_torch_zoo_mixers.py holds the other four. Each
runs its reduced config in bf16 with ``lm_numpy_params`` weights rounded
alike by both packages: a prefill of 16 tokens (logits and every cache
leaf), 4 decode steps continuing it (logits and caches), and the forward
over 20 tokens, each within relative L2 1.5e-2 (tests/test_torch_lm.py's
limit: the port's ``flash_attention`` keeps its logits in fp32 where the
reference's chunked attention rounds them to bf16, and ``exp`` rounds 1
ulp apart; the largest measured here is 1.44e-2, recurrentgemma).

The two MoE configs run with their routers zeroed. With real routers a
bf16 rounding difference of ~1% in a token's hidden state flips a top-k
choice whose margin is smaller (the reduced configs' margins go down to
1e-4), and one token's flipped expert moves its logits by 10-30%: a
discrete result that no rounding tolerance covers. With every score tied,
both packages route every token to the lowest-index experts (the tie
rule) and capacity drops the same late tokens, so the model-level
comparison holds the stacks, the caches, the shared experts and the drops;
the routing itself is held exactly in fp32 by tests/test_torch_moe.py.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_fixtures as fx  # noqa: E402


@pytest.mark.parametrize("arch", ["starcoder2-3b", "granite-3-8b",
                                  "deepseek-67b", "mistral-large-123b",
                                  "pixtral-12b", "whisper-base"])
def test_prefill_decode_and_forward_match_reference(arch):
    fx.assert_model_matches_reference(arch)
