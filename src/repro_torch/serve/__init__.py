"""LASANA-as-a-service, the engine side (port of ``repro.serve``).

The continuous-batching scheduler (:mod:`repro_torch.serve.scheduler`)
packs concurrent requests along the batch axis of an engine's slot
runners (``NetworkEngine.slot_programs``): requests join and leave at
chunk boundaries, per-slot live masks keep every tenant's records what a
solo ``lasana.simulate`` would produce, and partial records stream back
per chunk. :class:`BucketPolicy` quantises requests onto slot widths and
one chunk length, :func:`spec_content_key` names a spec by its content,
and :class:`ServerMetrics` holds the counters a lane writes. The server
(artifact store, wire protocol, ``lasana.serve``) builds on these.
"""

from repro_torch.serve.buckets import Bucket, BucketPolicy, spec_content_key
from repro_torch.serve.metrics import ServerMetrics
from repro_torch.serve.scheduler import Lane, RequestHandle

__all__ = [
    "Bucket",
    "BucketPolicy",
    "Lane",
    "RequestHandle",
    "ServerMetrics",
    "spec_content_key",
]
