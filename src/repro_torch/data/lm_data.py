"""Deterministic synthetic LM corpus and its training pipeline: the JAX
package's ``data/lm_data.py``, copied (it is pure numpy), so the port's
prompts and training batches equal the reference's token for token.

The stream is a seeded Zipf-ish Markov token process, reproducible from
(seed, step) alone: restart and elastic resume re-derive the stream at
the resumed step (no data state in the checkpoint). Batches are dealt
microbatch-major (M, B/M, S) when M > 1, the train step's contract. The
:class:`Prefetcher` keeps numpy batches ready on a thread; the train step
copies them to the card from pinned memory (:func:`to_device`).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch


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


def make_train_batch(corpus: SyntheticCorpus, step: int, *, global_batch: int,
                     seq: int, num_microbatches: int = 1, host_id: int = 0,
                     n_hosts: int = 1, extras: Optional[dict] = None) -> dict:
    """Next-token-prediction batch of numpy arrays; leaves are (M, B/M, S)
    when M > 1."""
    per_host = global_batch // n_hosts
    toks = corpus.batch(step, per_host, seq + 1, host_id=host_id,
                        n_hosts=n_hosts)
    tokens, labels = toks[:, :-1], toks[:, 1:].copy()
    batch = {"tokens": tokens, "labels": labels}
    if extras:
        batch.update(extras)
    if num_microbatches > 1:
        m = num_microbatches
        batch = {k: v.reshape(m, v.shape[0] // m, *v.shape[1:])
                 for k, v in batch.items()}
    return batch


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``: on the card, each leaf is
    staged in pinned host memory and copied asynchronously."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        else:
            t = t.to(dev)
        out[k] = t
    return out


class Prefetcher:
    """Background thread that keeps ``depth`` batches ready."""

    def __init__(self, make_batch, *, depth: int = 2, start_step: int = 0):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
