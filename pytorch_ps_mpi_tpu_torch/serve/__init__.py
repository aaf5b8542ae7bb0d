"""The serve tier on a single PS: the read path of a PS that trains.

Counterpart of `pytorch_ps_mpi_tpu/serve`, but for its fleet reader
(``FleetSubscriber``, which waits for the sharded fleet):

* `subscribe.Subscriber` — a versioned snapshot subscription over the
  ``SUBS``/``DELT`` frames: a full snapshot at a consistent version
  served from the server's encode-once PARM cache, then conditional
  reads (head-only "unchanged" at the served version, a full snapshot
  or, from a ``delta_parm`` server, a sparse diff on a version advance),
  READ-class end to end (`transport.Session.send_read` and the server's
  per-version read-token budget), so a reader flood sheds reads and
  never stalls gradients;
* `infer.InferenceFrontend` — a continuous-batching greedy decoder on
  the port's `models.transformer.TransformerLM`: bounded admission with
  a typed `errors.InferShedError` at overload, per-request p50/p95
  (`utils.timing.RequestLatency`), and parameter hot-swap from a live
  subscription with no dropped request.
"""

from .infer import InferenceFrontend, InferRequest
from .subscribe import Subscriber

__all__ = [
    "Subscriber",
    "InferenceFrontend",
    "InferRequest",
]
