"""LASANA-as-a-service: persistent multi-tenant simulation serving (port of
``repro.serve``).

A long-lived :class:`SimServer` owns a versioned surrogate
:class:`ArtifactStore`, a bounded set of slot runners quantized by
:class:`BucketPolicy` shape buckets, and the continuous-batching scheduler
(:mod:`repro_torch.serve.scheduler`), which packs concurrent requests
along the batch axis of an engine's slot runners
(``NetworkEngine.slot_programs``): requests join and leave at chunk
boundaries, per-slot live masks keep every tenant's records what a solo
``lasana.simulate`` would produce, and partial records stream back per
chunk. :func:`spec_content_key` names a spec by its content and
:class:`ServerMetrics` holds the counters behind ``SimServer.stats``.
``lasana.serve()`` is the facade entry; ``python -m repro_torch.serve``
is the stdin/socket driver of the JSON-lines protocol (:func:`run_stdio`).
"""

from repro_torch.serve.buckets import Bucket, BucketPolicy, spec_content_key
from repro_torch.serve.metrics import ServerMetrics
from repro_torch.serve.protocol import run_stdio
from repro_torch.serve.scheduler import Lane, RequestHandle
from repro_torch.serve.server import (DeadlineExceeded, ServeConfig,
                                      ServerBusy, SimServer)
from repro_torch.serve.store import ArtifactError, ArtifactStore

__all__ = [
    "ArtifactError",
    "ArtifactStore",
    "Bucket",
    "BucketPolicy",
    "DeadlineExceeded",
    "Lane",
    "RequestHandle",
    "ServeConfig",
    "ServerBusy",
    "ServerMetrics",
    "SimServer",
    "run_stdio",
    "spec_content_key",
]
