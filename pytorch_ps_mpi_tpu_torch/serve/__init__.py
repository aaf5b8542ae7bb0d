"""The serve tier: the read path of a PS (or a PS fleet) that trains.

Counterpart of `pytorch_ps_mpi_tpu/serve`:

* `subscribe.Subscriber` — a versioned snapshot subscription over the
  ``SUBS``/``DELT`` frames: a full snapshot at a consistent version
  served from the server's encode-once PARM cache, then conditional
  reads (head-only "unchanged" at the served version, a full snapshot
  or, from a ``delta_parm`` server, a sparse diff on a version advance),
  READ-class end to end (`transport.Session.send_read` and the server's
  per-version read-token budget), so a reader flood sheds reads and
  never stalls gradients;
* `subscribe.FleetSubscriber` — the same over every shard of a fleet:
  the plan from shard 0, the full tree assembled from the per-shard
  slices, per-shard versions;
* `infer.InferenceFrontend` — a continuous-batching greedy decoder on
  the port's `models.transformer.TransformerLM`: bounded admission with
  a typed `errors.InferShedError` at overload, per-request p50/p95
  (`utils.timing.RequestLatency`), and parameter hot-swap from a live
  subscription with no dropped request.
"""

from .infer import InferenceFrontend, InferRequest
from .subscribe import FleetSubscriber, Subscriber

__all__ = [
    "Subscriber",
    "FleetSubscriber",
    "InferenceFrontend",
    "InferRequest",
]
