"""Synthetic MNIST-like digits + Poisson rate spike encoding (numpy copy of
``repro.data.mnist``, kept here so the port imports nothing of ``repro``).

No dataset files ship with the repo, so the case studies (paper §V-E)
run on a *procedural* digit set: each class is a deterministic stroke
prototype rendered at 20x20 or 28x28, jittered per sample. Classes are
linearly separable enough that a small BNN/SNN trains to high accuracy —
the role MNIST plays in the paper (a workload generator for the
golden-vs-surrogate comparison, not a vision benchmark).
"""

from __future__ import annotations

import numpy as np

_SEGS = {
    # seven-segment-ish strokes in a unit square: (x0, y0, x1, y1)
    0: [(.2, .1, .8, .1), (.2, .9, .8, .9), (.2, .1, .2, .9), (.8, .1, .8, .9)],
    1: [(.5, .1, .5, .9)],
    2: [(.2, .1, .8, .1), (.8, .1, .8, .5), (.2, .5, .8, .5), (.2, .5, .2, .9),
        (.2, .9, .8, .9)],
    3: [(.2, .1, .8, .1), (.2, .5, .8, .5), (.2, .9, .8, .9), (.8, .1, .8, .9)],
    4: [(.2, .1, .2, .5), (.2, .5, .8, .5), (.8, .1, .8, .9)],
    5: [(.8, .1, .2, .1), (.2, .1, .2, .5), (.2, .5, .8, .5), (.8, .5, .8, .9),
        (.8, .9, .2, .9)],
    6: [(.8, .1, .2, .1), (.2, .1, .2, .9), (.2, .9, .8, .9), (.8, .9, .8, .5),
        (.8, .5, .2, .5)],
    7: [(.2, .1, .8, .1), (.8, .1, .5, .9)],
    8: [(.2, .1, .8, .1), (.2, .5, .8, .5), (.2, .9, .8, .9), (.2, .1, .2, .9),
        (.8, .1, .8, .9)],
    9: [(.2, .5, .2, .1), (.2, .1, .8, .1), (.8, .1, .8, .9), (.8, .5, .2, .5)],
}


def _render(cls: int, size: int, rng) -> np.ndarray:
    img = np.zeros((size, size), np.float32)
    jx, jy = rng.uniform(-.06, .06, 2)
    scale = rng.uniform(0.85, 1.1)
    for (x0, y0, x1, y1) in _SEGS[cls]:
        n = 2 * size
        ts = np.linspace(0, 1, n)
        xs = ((x0 + (x1 - x0) * ts) * scale + jx) * (size - 1)
        ys = ((y0 + (y1 - y0) * ts) * scale + jy) * (size - 1)
        xi = np.clip(np.round(xs).astype(int), 0, size - 1)
        yi = np.clip(np.round(ys).astype(int), 0, size - 1)
        img[yi, xi] = 1.0
    # stroke width + blur-ish
    img = np.maximum(img, np.roll(img, 1, 0) * 0.9)
    img = np.maximum(img, np.roll(img, 1, 1) * 0.9)
    img += rng.normal(0, 0.05, img.shape).astype(np.float32)
    return np.clip(img, 0, 1)


def make_digits(n: int, *, size: int = 20, seed: int = 0):
    """-> (images (n, size*size) float32 in [0,1], labels (n,) int32)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    imgs = np.stack([_render(int(c), size, rng) for c in labels])
    return imgs.reshape(n, -1).astype(np.float32), labels.astype(np.int32)


def poisson_encode(images: np.ndarray, t_steps: int, *, max_rate: float = 0.6,
                   seed: int = 0) -> np.ndarray:
    """Rate coding: spike (T, N, D) with P(spike) ∝ pixel intensity."""
    rng = np.random.default_rng(seed)
    p = np.clip(images * max_rate, 0, 1)
    return (rng.random((t_steps, *images.shape)) < p[None]).astype(np.float32)
