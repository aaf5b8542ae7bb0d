"""Per-step metrics keys.

Counterpart of `pytorch_ps_mpi_tpu/utils/timing.py`: the reference's
``step()`` returns a per-phase wall-clock dict, and every step of the port
returns the same keys.
"""

from __future__ import annotations

# Canonical metric keys, matching the reference step() dict (`ps.py:193`).
STEP_METRIC_KEYS = (
    "code_wait",              # encode phase (host wall-clock or phase-split)
    "iallgather_prepare_time",  # trace+compile of the SPMD program (one-time)
    "isend_time",             # collective dispatch latency
    "comm_wait",              # block_until_ready on the synced grads
    "decode_time",            # decode phase
    "optim_step_time",        # parameter update phase
    "msg_bytes",              # encoded payload bytes per rank
    "packaged_bytes",         # on-wire bytes (after codec packaging)
)
