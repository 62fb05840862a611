"""Request shape-bucketing for the simulation server (port of
``repro.serve.buckets``).

The server's compiled-program budget is the heart of its cost model: every
distinct (spec structure, batch width, chunk ticks) triple is one AOT
compile, and everything else — request count, stimulus lengths, surrogate
versions, tenants — must map onto that bounded set. Two pieces implement
the quantization:

:func:`spec_content_key`
    a stable digest of a :class:`NetworkSpec`'s full CONTENT (layer kinds,
    shapes, knobs, weight/param/edge values, spike amplitude). Layer
    weights live in the engine built for the spec, so two specs share an
    engine and its programs only when their values match — identity
    (``id(spec)``) is the wrong equivalence because clients rebuild
    structurally-equal specs per request. The server keeps ONE canonical
    spec object (and therefore one facade engine + program cache) per
    content key.

:class:`BucketPolicy`
    quantizes a request's batch size onto a small ladder of slot widths
    (the compiled batch axis) and fixes the chunk length all requests
    stream in. A bucket — :class:`Bucket`, ``(spec_key, width,
    chunk_ticks)`` — names one compiled slot-program family; requests in
    the same bucket co-batch along its slot axis regardless of their
    stimulus length, which is handled by per-slot live masks inside the
    program (see ``NetworkEngine.slot_programs``).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch


def spec_content_key(spec) -> str:
    """Stable hex digest of a :class:`NetworkSpec`'s structure AND values.

    Everything the compiled network program bakes in as constants
    participates: per-layer circuit kind, crossbar knobs, weight and
    param values, every edge, and the spike amplitude. Equal keys imply
    the specs compile to interchangeable programs (one canonical engine
    serves both); unequal keys get separate buckets. Values are hashed as
    float32 bytes of a host copy, so a spec whose weights lie on the card
    gives the digest the same spec gives on the CPU and in the reference."""
    h = hashlib.sha1()
    for layer in spec.layers:
        h.update(repr((layer.circuit, layer.seg_width, layer.adc_bits,
                       layer.activation,
                       tuple(np.shape(layer.weight)))).encode())
        h.update(np.ascontiguousarray(
            _np32(layer.weight)).tobytes())
        if layer.params is not None:
            h.update(np.ascontiguousarray(
                _np32(layer.params)).tobytes())
    for edge in spec.edges:
        h.update(repr((edge.src, edge.dst,
                       tuple(np.shape(edge.weight)))).encode())
        h.update(np.ascontiguousarray(
            _np32(edge.weight)).tobytes())
    h.update(np.float32(spec.spike_amp).tobytes())
    return h.hexdigest()


def _np32(a) -> np.ndarray:
    """A weight as float32 numpy, from the CPU copy of a tensor."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One compiled-program class: requests in the same bucket co-batch."""

    spec_key: str          # spec_content_key of the canonical spec
    width: int             # slot count = the program's batch axis
    chunk_ticks: int       # ticks per scheduling round

    @property
    def key(self) -> tuple:
        return (self.spec_key, self.width, self.chunk_ticks)


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """How heterogeneous requests quantize onto compiled programs.

    slot_widths   ascending ladder of batch widths; a request with batch
                  ``b`` lands in the smallest width >= b (requests wider
                  than the ladder's top are rejected at submit — they
                  would mint an unbounded program per odd batch size)
    chunk_ticks   the continuous-batching quantum: every request streams
                  in ``chunk_ticks``-tick chunks and joins/leaves only at
                  chunk boundaries; stimulus lengths that are not a
                  multiple ride the per-slot live mask (dead padding ticks
                  are frozen, not simulated)
    """

    slot_widths: tuple = (4,)
    chunk_ticks: int = 16

    def __post_init__(self):
        widths = tuple(sorted(int(w) for w in self.slot_widths))
        if not widths or widths[0] < 1:
            raise ValueError(f"slot_widths must be positive: "
                             f"{self.slot_widths}")
        if self.chunk_ticks < 1:
            raise ValueError(f"chunk_ticks must be positive: "
                             f"{self.chunk_ticks}")
        object.__setattr__(self, "slot_widths", widths)

    @property
    def max_width(self) -> int:
        return self.slot_widths[-1]

    def width_for(self, batch: int) -> int:
        """Smallest ladder width that fits a ``batch``-wide request."""
        for w in self.slot_widths:
            if batch <= w:
                return w
        raise ValueError(
            f"request batch {batch} exceeds the widest slot bucket "
            f"{self.max_width}; widen BucketPolicy.slot_widths or split "
            "the request")

    def bucket_for(self, spec_key: str, batch: int) -> Bucket:
        return Bucket(spec_key=spec_key, width=self.width_for(batch),
                      chunk_ticks=self.chunk_ticks)
