"""Procedural digits and their encodings, made on the device from a seed.

The strokes are the port's procedural digit set (``repro_torch/data/
mnist.py``, a seven-segment-like prototype per class, jittered in place
and scale, two-pixel strokes, Gaussian noise): the repository ships no
dataset, and the case studies' weights were fitted to these digits. The
rendering is vectorised over the batch and drawn from a
``torch.Generator`` on the device, so 10,000 digits take milliseconds;
its random stream differs from numpy's, its distribution does not.
"""

from __future__ import annotations

import torch

SEGS = {
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
MAX_SEGS = max(len(s) for s in SEGS.values())


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any integer up to
    2**64 - 1)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def make_digits(n: int, size: int, gen: torch.Generator):
    """``(images (n, size*size) fp32 in [0, 1], labels (n,) int64)`` on
    the generator's device."""
    dev = gen.device
    table = torch.zeros((10, MAX_SEGS, 4))
    used = torch.zeros((10, MAX_SEGS), dtype=torch.bool)
    for c, segs in SEGS.items():
        table[c, :len(segs)] = torch.tensor(segs)
        used[c, :len(segs)] = True
    table, used = table.to(dev), used.to(dev)
    labels = torch.randint(0, 10, (n,), generator=gen, device=dev)
    jx, jy = (torch.rand((2, n, 1, 1), generator=gen, device=dev) * 0.12
              - 0.06)
    scale = torch.rand((n, 1, 1), generator=gen, device=dev) * 0.25 + 0.85
    seg = table[labels]                                   # (n, S, 4)
    ts = torch.linspace(0, 1, 2 * size, device=dev)       # (P,)
    x0, y0, x1, y1 = (seg[..., i:i + 1] for i in range(4))
    xs = ((x0 + (x1 - x0) * ts) * scale + jx) * (size - 1)
    ys = ((y0 + (y1 - y0) * ts) * scale + jy) * (size - 1)
    xi = torch.clamp(torch.round(xs), 0, size - 1).long()
    yi = torch.clamp(torch.round(ys), 0, size - 1).long()
    img = torch.zeros((n, size, size), device=dev)
    row = torch.arange(n, device=dev)[:, None, None].expand_as(xi)
    keep = used[labels][..., None].expand_as(xi)
    img[row[keep], yi[keep], xi[keep]] = 1.0
    img = torch.maximum(img, torch.roll(img, 1, 1) * 0.9)
    img = torch.maximum(img, torch.roll(img, 1, 2) * 0.9)
    img = img + torch.randn((n, size, size), generator=gen, device=dev) * 0.05
    return torch.clamp(img, 0, 1).reshape(n, -1), labels


def poisson_spikes(images, t_steps: int, gen: torch.Generator, *,
                   max_rate: float = 0.6, amplitude: float = 1.5,
                   block: int = 10):
    """Rate coding: (T, n, D) spikes of ``amplitude`` with P(spike) =
    ``max_rate`` x pixel intensity, drawn ``block`` ticks at a time."""
    p = torch.clamp(images * max_rate, 0, 1)
    out = torch.empty((t_steps, *images.shape), device=images.device)
    for a in range(0, t_steps, block):
        k = min(block, t_steps - a)
        u = torch.rand((k, *images.shape), generator=gen,
                       device=images.device)
        torch.mul(u < p, amplitude, out=out[a:a + k])
    return out
