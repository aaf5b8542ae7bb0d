"""Continuous-batching inference front-end on the port's transformer LM.

Counterpart of `pytorch_ps_mpi_tpu/serve/infer.py`, with its API,
messages, counters and `stats()` keys.  Requests enter a BOUNDED
admission queue, and an engine loop assembles a fresh batch EVERY decode
step:

* **continuous batching**: the batch is ``max_batch`` slots; a request
  joins the running batch the step after it is admitted and leaves the
  step it finishes, and freed slots re-fill from the queue at step
  granularity;
* **greedy decode, full forward**: one function runs
  `models.transformer.TransformerLM` over the fixed ``[max_batch,
  buf_len]`` token buffer and emits each active row's next token, the
  argmax of the logits at its own ``lengths - 1``.  Lengths are data,
  not shapes; there is no KV cache (the reference has none), and a row's
  padded tail lies after ``lengths - 1`` under causal attention, so it
  cannot change that row's logits;
* **typed shed at overload**: a full admission queue refuses the
  request with `errors.InferShedError` (counted ``infer_shed``);
* **per-request p50/p95** via `utils.timing.RequestLatency`;
* **hot swap with no dropped request**: between steps the engine polls
  a ``params_source`` (a `serve.subscribe.Subscriber`, or anything with
  ``poll() -> (version, params, changed)``); a version advance builds a
  NEW device tree for the next step — nothing is copied into the
  tensors a step reads, and the old tree stays referenced until the
  step's tokens are on the host.  A transport blip in the source is
  swallowed: the front-end keeps serving its last snapshot while the
  subscriber heals (construct it with ``nonblock_heal=True``).

The step runs under `torch.inference_mode()` on ``device``: the visible
card when None (raising without one), or the CPU when the caller asks.
The model carries its attention: ``attn=functools.partial(
flash_attention, causal=True)`` runs the flash kernel on the card.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any

import numpy as np
import torch
from torch.func import functional_call

from ..errors import InferShedError
from ..models import per_thread
from ..multihost_async import tree_to_device
from ..parallel.mesh import resolve_device
from ..transport import TRANSPORT_ERRORS
from ..utils.timing import RequestLatency


class InferRequest:
    """One admitted inference request: prompt tokens in, greedily
    decoded continuation out.  ``result(timeout)`` blocks until the
    engine retires the request (or the timeout) and returns the
    generated token list; ``latency_s`` is the submit-to-finish wall
    span the front-end's p50/p95 aggregates."""

    __slots__ = ("prompt", "max_new", "generated", "done", "t0",
                 "latency_s")

    def __init__(self, prompt, max_new: int):
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.generated: "list[int]" = []
        self.done = threading.Event()
        self.t0 = time.perf_counter()
        self.latency_s: "float | None" = None

    def result(self, timeout: "float | None" = None) -> "list[int]":
        if not self.done.wait(timeout):
            raise TimeoutError(
                f"inference request not finished within {timeout}s")
        return list(self.generated)

    @property
    def tokens(self) -> "list[int]":
        return self.prompt + self.generated


def decode_step(module, params, tokens, positions, lengths):
    """The greedy step over the whole buffer: each row's argmax (first
    maximum, as ``jnp.argmax``) of the logits at ``lengths - 1``."""
    logits = functional_call(module, params, (tokens, positions))
    idx = torch.clamp(lengths.long() - 1, 0, tokens.shape[1] - 1)
    last = logits[torch.arange(tokens.shape[0], device=logits.device), idx]
    return torch.argmax(last, dim=-1).to(torch.int32)


class InferenceFrontend:
    """Bounded-admission, continuous-batching greedy decoder.

    Usage::

        fe = InferenceFrontend(model, params, max_batch=4, buf_len=64,
                               max_queue=16, params_source=subscriber)
        req = fe.submit([1, 2, 3], max_new=8)   # InferShedError at overload
        while fe.pending:
            fe.step()
        print(req.result(0), fe.stats())

    ``params`` is a host tree named as ``model.named_parameters()``
    (numpy or CPU tensors).  ``submit`` is thread-safe; ``step`` and
    ``drain`` belong to ONE engine thread (the decode buffers are
    engine-local state).
    """

    def __init__(self, model, params, *, max_batch: int = 4,
                 buf_len: int = 64, max_queue: int = 16,
                 params_source=None, device=None,
                 latency_window: int = 128):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if buf_len < 2:
            raise ValueError(f"buf_len must be >= 2, got {buf_len}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.model = model
        self.max_batch = int(max_batch)
        self.buf_len = int(buf_len)
        self.max_queue = int(max_queue)
        self._queue: "queue.Queue[InferRequest]" = queue.Queue(
            maxsize=max_queue)
        self._slots: "list[InferRequest | None]" = [None] * max_batch
        self._tokens = np.zeros((max_batch, buf_len), np.int32)
        self._lengths = np.ones((max_batch,), np.int32)
        self.latency = RequestLatency(window=latency_window)
        self.steps = 0
        # Admission counters (`format_fault_stats` vocabulary).
        self.fault_stats: "dict[str, int]" = {
            "infer_requests": 0, "infer_shed": 0, "param_swaps": 0}
        self._stats_lock = threading.Lock()
        self._device = resolve_device("cuda" if device is None else device)
        self._module = per_thread(model)
        self._positions = torch.arange(
            buf_len, dtype=torch.int32, device=self._device).expand(
                max_batch, buf_len).contiguous()
        self._dev_params = self._to_device(params)
        self._params_source = params_source

    def _to_device(self, params):
        """A new device tree of ``params`` (one copy; fresh memory on the
        CPU too, so it never aliases the source's tree)."""
        return tree_to_device(dict(params), self._device)

    # -- admission (thread-safe) ----------------------------------------------

    def submit(self, prompt, max_new: int = 8) -> InferRequest:
        """Admit one request, or shed it with typed `InferShedError`
        when the bounded queue is full — graceful overload degradation:
        the refusal is immediate and costs the caller a retry, while an
        unbounded queue would cost every queued request its latency
        bound."""
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_new > self.buf_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds "
                f"the decode buffer ({self.buf_len})")
        req = InferRequest(prompt, max_new)
        with self._stats_lock:
            self.fault_stats["infer_requests"] += 1
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            with self._stats_lock:
                self.fault_stats["infer_shed"] += 1
            raise InferShedError(
                f"inference admission queue full ({self.max_queue} "
                f"pending): request shed — back off and retry (the "
                f"bounded queue is what keeps admitted requests' "
                f"p50/p95 meaningful under overload)") from None
        return req

    @property
    def pending(self) -> int:
        """Requests not yet retired: queued + active batch slots."""
        return (self._queue.qsize()
                + sum(1 for s in self._slots if s is not None))

    # -- the engine loop (single engine thread) -------------------------------

    def _maybe_swap(self) -> None:
        """Parameter hot swap between steps: poll the subscription; a
        version advance installs a new device tree for the NEXT step (the
        previous step's tokens are already on the host).  Transport
        blips are swallowed: the subscriber heals itself, and serving the
        last snapshot beats refusing every request meanwhile."""
        src = self._params_source
        if src is None:
            return
        try:
            _version, params, changed = src.poll()
        except TRANSPORT_ERRORS:
            return
        if changed and params is not None:
            self._dev_params = self._to_device(params)
            with self._stats_lock:
                self.fault_stats["param_swaps"] += 1

    def _admit_into_slots(self) -> None:
        for i in range(self.max_batch):
            if self._slots[i] is not None:
                continue
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            self._slots[i] = req
            n = len(req.prompt)
            self._tokens[i, :] = 0
            self._tokens[i, :n] = req.prompt
            self._lengths[i] = n

    def _decode(self) -> np.ndarray:
        """One step on the device; the tokens come back to the host."""
        dev = self._device
        with torch.inference_mode():
            nxt = decode_step(self._module(), self._dev_params,
                              torch.from_numpy(self._tokens).to(dev),
                              self._positions,
                              torch.from_numpy(self._lengths).to(dev))
            return nxt.cpu().numpy()

    def step(self) -> int:
        """One continuous-batching decode step: swap params if the
        subscription advanced, admit queued requests into free slots,
        run the step, append each active row's next token, and retire
        finished requests (latency observed at retirement).  Returns the
        number of active requests this step served."""
        self._maybe_swap()
        self._admit_into_slots()
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return 0
        nxt = self._decode()
        self.steps += 1
        for i in active:
            req = self._slots[i]
            tok = int(nxt[i])
            req.generated.append(tok)
            n = int(self._lengths[i])
            if n < self.buf_len:
                self._tokens[i, n] = tok
                self._lengths[i] = n + 1
            if (len(req.generated) >= req.max_new
                    or int(self._lengths[i]) >= self.buf_len):
                req.latency_s = time.perf_counter() - req.t0
                self.latency.observe(req.latency_s)
                req.done.set()
                self._slots[i] = None
        return len(active)

    def drain(self, max_steps: int = 100000) -> int:
        """Run steps until every admitted request retired (or the step
        budget — a loud bound, never a hang).  Returns steps run.

        A blown budget raises ``TimeoutError`` (the type
        `InferRequest.result` uses), NOT `InferShedError`: a wedged
        engine is the opposite of a healthy-but-full admission queue,
        and a caller retrying on the typed shed must not retry against
        a wedge."""
        ran = 0
        while self.pending and ran < max_steps:
            if self.step() == 0:
                # Queue raced empty between pending and admit: yield.
                time.sleep(0.001)
            ran += 1
        if self.pending:
            raise TimeoutError(
                f"drain() exceeded its {max_steps}-step budget with "
                f"{self.pending} request(s) still pending — the engine "
                f"is wedged or the budget is too small for the queue")
        return ran

    def stats(self) -> "dict[str, Any]":
        """One report dict: admission counters + the p50/p95 request-
        latency window (`RequestLatency.snapshot`) + engine gauges."""
        with self._stats_lock:
            out: "dict[str, Any]" = dict(self.fault_stats)
        out["steps"] = self.steps
        out["queued"] = self._queue.qsize()
        out["active"] = sum(1 for s in self._slots if s is not None)
        out["request_latency"] = self.latency.snapshot()
        return out
