"""Deterministic synthetic LM corpus: the JAX package's
``data/lm_data.py:SyntheticCorpus``, copied (it is pure numpy), so the
port's prompts equal the reference's token for token.

The stream is a seeded Zipf-ish Markov token process, reproducible from
(seed, step) alone. ``make_train_batch`` and the ``Prefetcher`` wait for
the LM training slice (ROADMAP §A item 6, training).
"""

from __future__ import annotations

import numpy as np


class SyntheticCorpus:
    """Seeded Markov stream over ``vocab`` tokens."""

    def __init__(self, vocab: int, seed: int = 0, order_decay: float = 0.7):
        self.vocab = vocab
        self.seed = seed
        self.order_decay = order_decay

    def batch(self, step: int, batch: int, seq: int, *,
              host_id: int = 0, n_hosts: int = 1) -> np.ndarray:
        """Tokens (batch, seq) for this host at this step — pure function."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + host_id)
        base = rng.integers(0, self.vocab, (batch, seq), dtype=np.int64)
        # local correlation: with p=decay, copy previous token + small drift
        keep = rng.random((batch, seq)) < self.order_decay
        drift = rng.integers(-3, 4, (batch, seq))
        out = base.copy()
        for t in range(1, seq):
            out[:, t] = np.where(keep[:, t],
                                 (out[:, t - 1] + drift[:, t]) % self.vocab,
                                 base[:, t])
        return out.astype(np.int32)
