"""Deterministic fault injection (chaos harness) — the sync trainer's part.

Counterpart of `pytorch_ps_mpi_tpu/utils/faults.py`: `FaultPlan` is copied
whole — every field, every predicate and the JSON the CLI carries it as —
so the port's CLI parses a plan, and refuses the faults it cannot honor,
exactly as the JAX CLI does.  The sync trainer honors the sync faults
(``preempt_at_step``, ``spike_at_step``, ``sdc_at_step``);
`corrupt_replica` flips one bit of one rank's own copy of a parameter.
The in-process async PS honors ``kill_ps_at`` (`SimulatedCrash`), the
straggler, Byzantine (``byzantine_transform``: maps on trees of tensors)
and overload faults; the multihost server and worker honor those and
the wire faults (`WireMangler`, on a worker's outbound GRAD frames) and
the non-finite injection (`poison_nonfinite`, on its host codes); the
hierarchy honors the aggregator faults (``kill_agg_at``, ``slow_agg``,
and ``agg_byzantine_transform`` on the group's reduced gradient).
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from .flatten import tree_flatten, tree_map, tree_unflatten

# The transport's frame header (u32 length + u32 crc32): the mangler's
# corruption lands past it so a flipped bit costs the frame, not the
# stream's alignment.
_WIRE_HDR_SIZE = 8


class SimulatedCrash(RuntimeError):
    """A fault-injection hook killing the process it fired in.

    Raised out of the worker loop (worker death) or the PS serve loop (PS
    death) when the `FaultPlan` says so — the in-process analogue of
    ``kill -9`` that lets a single test own both sides of a crash."""


@dataclasses.dataclass
class FaultPlan:
    """A seeded, declarative schedule of faults.

    Targeted (deterministic single-shot) faults::

        kill_worker_at = {rank: iteration}   # worker dies before that pull
        kill_ps_at     = update_index        # PS dies before that update
        kill_shard_at  = {shard: update}     # shard k of a PS FLEET dies
                                             # before its update u; the
                                             # fleet supervisor restores
                                             # it from its auto-checkpoint
                                             # (shard.PSFleet)
        kill_agg_at    = {group: fill}       # group g's LOCAL AGGREGATOR
                                             # (shard.hierarchy) dies
                                             # before forwarding fill f;
                                             # the hierarchy supervisor
                                             # restarts it (same port,
                                             # same upstream rank) or its
                                             # workers fail over to
                                             # DIRECT root connections
        nonfinite_at   = {(rank, iteration)} # that gradient push is NaN'd

    Sync-trainer faults (the elastic resilience layer's chaos hooks; the
    training loop consults them between steps)::

        preempt_at_step = s   # a REAL SIGTERM to this process before step
                              # s+1 — drives the signal-safe checkpoint
                              # path end to end, not a simulation of it
        spike_at_step   = s   # that step's batch is scaled by spike_scale,
                              # genuinely diverging the loss (the rollback
                              # guardrail's injector)
        sdc_at_step     = s   # parameter bytes on replica sdc_rank are
                              # bit-flipped while the sharding still claims
                              # replication — silent data corruption, the
                              # consensus guard's injector

    Wire-level faults apply to outbound GRAD frames on the worker
    transport.  ``*_every=k`` hits every k-th frame (deterministic);
    ``*_p`` hits each frame with that probability from the per-worker
    seeded stream.  Both compose.

    Robustness-layer faults (the straggler/Byzantine injectors the quorum
    and robust-aggregation defenses are proven against)::

        slow_rank / slow_delay_s    # that worker sleeps slow_delay_s
                                    # before every gradient computation —
                                    # a deterministic straggler
        byzantine_rank / byzantine_mode / byzantine_scale
                                    # that worker's GRADIENTS (pre-encode,
                                    # so every codec carries the attack
                                    # faithfully) are mangled: "sign_flip"
                                    # (g -> -g), "scale" (g -> scale*g),
                                    # or "constant" (g -> all-ones).  All
                                    # FINITE — skip_nonfinite cannot catch
                                    # them; only robust aggregation /
                                    # anomaly quarantine can.

    Aggregator-tier faults (the two-level hierarchy's injectors,
    consulted by `shard.hierarchy.LocalAggregator`)::

        slow_agg / slow_agg_delay_s # group g's aggregator sleeps before
                                    # every forward — a straggling
                                    # AGGREGATOR, absorbed by the ROOT's
                                    # quorum/fill-deadline policy
        byzantine_agg               # group g's aggregator mangles its
                                    # REDUCED gradient pre-encode (modes/
                                    # scale shared with byzantine_rank):
                                    # an adversarial mid-tier only the
                                    # root-level robust policy can catch
                                    # — group containment cannot help
                                    # when the container itself lies

    Overload faults (the flow-control layer's injectors, honored by the
    worker loops (`flood_rank`/`burst_at`) and the PS consumer loops
    (`slow_consumer`))::

        flood_rank / flood_factor / flood_stop
                                    # that worker pushes EVERY gradient
                                    # flood_factor times (fresh seqs —
                                    # genuine extra wire/queue load, not
                                    # dedup-dropped duplicates) until
                                    # iteration flood_stop (None =
                                    # forever): a sender running at
                                    # flood_factor x the sustainable
                                    # rate, the scenario credit-based
                                    # flow control must absorb by
                                    # counted shedding, never by
                                    # unbounded queues/staleness or by
                                    # starved heartbeats
        burst_at = {iteration: n}   # EVERY rank pushes n extra frames
                                    # at that iteration — a synchronized
                                    # burst (quota-wide incast)
        slow_consumer               # the PS sleeps this many seconds
                                    # per consumed frame — an overloaded
                                    # consumer, the pressure that turns
                                    # on credit starvation and
                                    # pre-decode admission shedding

    Link-partition faults (the sharded fleet's degraded-mode injector,
    honored by `shard.ShardRouter`)::

        partition_links = [[rank, shard, start, heal], ...]
                                    # the (worker rank <-> fleet shard)
                                    # link is black-holed for worker
                                    # iterations start <= it < heal:
                                    # pulls/pushes/heartbeats on that one
                                    # link are silently swallowed (the
                                    # socket stays up — an asymmetric
                                    # network partition, not a crash).
                                    # The router rides it in bounded
                                    # degraded mode (reuse the last
                                    # pulled slice, counted) and the link
                                    # re-admits on the SAME rank at heal.
    """

    seed: int = 0
    kill_worker_at: dict = dataclasses.field(default_factory=dict)
    kill_ps_at: "int | None" = None
    kill_shard_at: dict = dataclasses.field(default_factory=dict)
    kill_agg_at: dict = dataclasses.field(default_factory=dict)
    nonfinite_at: set = dataclasses.field(default_factory=set)
    # Asymmetric link partitions: [rank, shard, start_it, heal_it] rows
    # (worker-iteration indexed, end-exclusive; heal >= a run's length =
    # never heals).  Empty = off.
    partition_links: list = dataclasses.field(default_factory=list)
    # Straggler / Byzantine injectors (None/0 = off).
    slow_rank: "int | None" = None
    slow_delay_s: float = 0.0
    byzantine_rank: "int | None" = None
    byzantine_mode: str = "sign_flip"
    byzantine_scale: float = 100.0
    # Aggregator-tier injectors (None/0 = off; group-indexed).
    slow_agg: "int | None" = None
    slow_agg_delay_s: float = 0.0
    byzantine_agg: "int | None" = None
    # Overload injectors (None/0/{} = off).
    flood_rank: "int | None" = None
    flood_factor: int = 4
    flood_stop: "int | None" = None
    burst_at: dict = dataclasses.field(default_factory=dict)
    slow_consumer: float = 0.0
    # Sync-trainer targeted faults (all single-shot; None/unset = off).
    preempt_at_step: "int | None" = None
    spike_at_step: "int | None" = None
    spike_scale: float = 1e4
    sdc_at_step: "int | None" = None
    sdc_rank: int = 1
    sdc_param: "str | None" = None
    # Periodic wire faults (every k-th outbound GRAD frame; 0 = off).
    corrupt_every: int = 0
    dup_every: int = 0
    drop_every: int = 0
    truncate_every: int = 0
    delay_every: int = 0
    # Probabilistic wire faults (per-frame, seeded per worker; 0.0 = off).
    corrupt_p: float = 0.0
    dup_p: float = 0.0
    drop_p: float = 0.0
    truncate_p: float = 0.0
    delay_p: float = 0.0
    delay_s: float = 0.01

    # -- targeted faults ---------------------------------------------------

    def should_kill_worker(self, rank: int, it: int) -> bool:
        return self.kill_worker_at.get(rank) == it

    def should_kill_ps(self, update: int) -> bool:
        return self.kill_ps_at == update

    def should_kill_shard(self, shard: int, update: int) -> bool:
        return self.kill_shard_at.get(shard) == update

    def should_kill_agg(self, group: int, fill: int) -> bool:
        return self.kill_agg_at.get(group) == fill

    def shard_view(self, shard: int) -> "FaultPlan":
        """The plan as PS shard ``shard`` of a fleet consults it: the
        shard's own planned death (``kill_shard_at[shard]``) becomes its
        ``kill_ps_at`` — a shard IS a PS, so shard death reuses the
        crash machinery the single PS already proves — and the
        fleet-level map is cleared (one shard must not fire another's
        kill).  Worker-side faults pass through unchanged."""
        return dataclasses.replace(
            self, kill_ps_at=self.kill_shard_at.get(shard),
            kill_shard_at={})

    def inject_nonfinite(self, rank: int, it: int) -> bool:
        return (rank, it) in self.nonfinite_at

    def should_partition(self, rank: int, shard: int, it: int) -> bool:
        """True while the (worker ``rank`` <-> fleet ``shard``) link is
        black-holed at worker iteration ``it`` (start-inclusive,
        heal-exclusive)."""
        return any(int(r) == rank and int(s) == shard
                   and int(start) <= it < int(heal)
                   for r, s, start, heal in self.partition_links)

    def any_partitions(self) -> bool:
        return bool(self.partition_links)

    # -- straggler / Byzantine faults --------------------------------------

    def should_slow(self, rank: int) -> bool:
        return (self.slow_rank is not None and self.slow_rank == rank
                and self.slow_delay_s > 0)

    def should_slow_agg(self, group: int) -> bool:
        return (self.slow_agg is not None and self.slow_agg == group
                and self.slow_agg_delay_s > 0)

    # -- overload faults ---------------------------------------------------

    def should_flood(self, rank: "int | None", it: int) -> bool:
        """True while ``rank`` is the flooding sender at iteration
        ``it`` (start-at-0, ``flood_stop``-exclusive; None = the flood
        never ends)."""
        return (self.flood_rank is not None and self.flood_rank == rank
                and self.flood_factor > 1
                and (self.flood_stop is None or it < self.flood_stop))

    def burst_extra(self, it: int) -> int:
        """Extra frames EVERY rank injects at iteration ``it``."""
        return int(self.burst_at.get(it, 0))

    def overload_extras(self, rank: "int | None",
                        it: int) -> "tuple[int, int]":
        """(flood_extra, burst_extra) frames for ``rank`` at iteration
        ``it`` — THE one place the injector arithmetic lives, so the
        three deployments' loops (in-process worker body, TCP worker,
        shard router) cannot drift on what a flood means."""
        flood = (self.flood_factor - 1
                 if self.should_flood(rank, it) else 0)
        return flood, self.burst_extra(it)

    def any_overload_worker_faults(self) -> bool:
        """Sender-side overload injectors — the CLI refuses them on
        roles with no gradient-pushing loop to flood."""
        return self.flood_rank is not None or bool(self.burst_at)

    def any_overload_faults(self) -> bool:
        return (self.any_overload_worker_faults()
                or self.slow_consumer > 0)

    def _byzantine_fn(self):
        """The configured attack as a map on a tree of tensors."""
        mode, scale = self.byzantine_mode, self.byzantine_scale
        if mode not in ("sign_flip", "scale", "constant"):
            raise ValueError(
                f"unknown byzantine_mode {mode!r}; have "
                f"['sign_flip', 'scale', 'constant']")
        if mode == "sign_flip":
            return lambda grads: tree_map(lambda g: -g, grads)
        if mode == "scale":
            # The scale in the gradient's dtype first, as the JAX map's
            # ``g * jnp.asarray(scale, g.dtype)``.
            return lambda grads: tree_map(
                lambda g: g * torch.tensor(scale, dtype=g.dtype,
                                           device=g.device), grads)
        return lambda grads: tree_map(torch.ones_like, grads)

    def byzantine_transform(self, rank: int):
        """The gradient-tree transform for ``rank``, or None for honest
        ranks.  Applied to the RAW gradients before encoding (inside the
        worker's step), so the attack survives any codec — a sign-flipped
        gradient quantizes to a sign-flipped code.  Every mode produces
        finite values by construction."""
        if self.byzantine_rank is None or self.byzantine_rank != rank:
            return None
        return self._byzantine_fn()

    def agg_byzantine_transform(self, group: int):
        """The reduced-gradient transform for an adversarial aggregator of
        ``group`` (None for honest groups).  Applied to the group's
        reduced gradient before it is re-encoded, so the attack rides the
        AGGR frame through any codec: the injector proving that group
        containment cannot defend against the container itself (only the
        root's robust policy and scoreboard can)."""
        if self.byzantine_agg is None or self.byzantine_agg != group:
            return None
        return self._byzantine_fn()

    # -- sync-trainer faults ----------------------------------------------

    def should_preempt(self, step: int) -> bool:
        return self.preempt_at_step == step

    def should_spike(self, step: int) -> bool:
        return self.spike_at_step == step

    def should_corrupt_replica(self, step: int) -> bool:
        return self.sdc_at_step == step

    def any_sync_faults(self) -> bool:
        return (self.preempt_at_step is not None
                or self.spike_at_step is not None
                or self.sdc_at_step is not None)

    def any_async_faults(self) -> bool:
        return bool(self.kill_worker_at or self.kill_ps_at is not None
                    or self.kill_shard_at or self.kill_agg_at
                    or self.partition_links
                    or self.nonfinite_at or self.any_wire_faults()
                    or self.slow_rank is not None
                    or self.byzantine_rank is not None
                    or self.slow_agg is not None
                    or self.byzantine_agg is not None
                    or self.any_overload_faults())

    def any_agg_faults(self) -> bool:
        """Faults that only a hierarchy's aggregator tier can honor — the
        CLI refuses them on any role without one (a chaos plan that can
        never fire tests nothing)."""
        return bool(self.kill_agg_at or self.slow_agg is not None
                    or self.byzantine_agg is not None)

    # -- wire faults -------------------------------------------------------

    def wire_mangler(self, rank: int) -> "WireMangler":
        return WireMangler(self, rank)

    def any_wire_faults(self) -> bool:
        return bool(self.corrupt_every or self.dup_every or self.drop_every
                    or self.truncate_every or self.delay_every
                    or self.corrupt_p or self.dup_p or self.drop_p
                    or self.truncate_p or self.delay_p)

    # -- (de)serialization — the CLI carries plans as JSON -----------------

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["kill_worker_at"] = {str(k): v
                               for k, v in self.kill_worker_at.items()}
        d["kill_shard_at"] = {str(k): v
                              for k, v in self.kill_shard_at.items()}
        d["kill_agg_at"] = {str(k): v
                            for k, v in self.kill_agg_at.items()}
        d["burst_at"] = {str(k): v for k, v in self.burst_at.items()}
        d["nonfinite_at"] = sorted(list(t) for t in self.nonfinite_at)
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        d = json.loads(s)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown FaultPlan fields: {sorted(unknown)}")
        if "kill_worker_at" in d:
            d["kill_worker_at"] = {int(k): int(v)
                                   for k, v in d["kill_worker_at"].items()}
        if "kill_shard_at" in d:
            d["kill_shard_at"] = {int(k): int(v)
                                  for k, v in d["kill_shard_at"].items()}
        if "kill_agg_at" in d:
            d["kill_agg_at"] = {int(k): int(v)
                                for k, v in d["kill_agg_at"].items()}
        if "burst_at" in d:
            d["burst_at"] = {int(k): int(v)
                             for k, v in d["burst_at"].items()}
        if "nonfinite_at" in d:
            d["nonfinite_at"] = {(int(r), int(i))
                                 for r, i in d["nonfinite_at"]}
        if "partition_links" in d:
            d["partition_links"] = [[int(v) for v in row]
                                    for row in d["partition_links"]]
        return cls(**d)


class WireMangler:
    """Per-worker stateful frame mangler: owns the frame counter and the
    seeded RNG stream, so fault schedules are reproducible per (plan, rank)
    no matter how threads interleave."""

    def __init__(self, plan: FaultPlan, rank: int):
        self.plan = plan
        self.rank = rank
        self.seq = 0
        self.rng = np.random.default_rng(
            np.random.SeedSequence([plan.seed, rank]))

    def _hit(self, every: int, prob: float) -> bool:
        # Short-circuit keeps the RNG stream identical for plans that never
        # configure the probabilistic knobs.
        if every and self.seq % every == 0:
            return True
        return bool(prob) and float(self.rng.random()) < prob

    def __call__(self, wire: bytes) -> "tuple[list[bytes], bool]":
        """Mangle one outbound wire frame (header + payload bytes).

        Returns ``(byte_chunks_to_send, close_connection_after)``.  An
        empty chunk list drops the frame entirely."""
        p = self.plan
        self.seq += 1
        if self._hit(p.delay_every, p.delay_p):
            time.sleep(p.delay_s)
        if self._hit(p.drop_every, p.drop_p):
            return [], False
        if self._hit(p.truncate_every, p.truncate_p):
            # A prefix then a dead socket: what the receiver of a real
            # mid-send crash observes ("peer closed mid-frame").
            lo = min(_WIRE_HDR_SIZE, len(wire) - 1)
            cut = lo + int(self.rng.integers(0, max(len(wire) - lo, 1)))
            return [wire[:max(cut, 1)]], True
        frames = [wire]
        if self._hit(p.corrupt_every, p.corrupt_p) \
                and len(wire) > _WIRE_HDR_SIZE:
            b = bytearray(wire)
            i = _WIRE_HDR_SIZE + int(
                self.rng.integers(0, len(wire) - _WIRE_HDR_SIZE))
            b[i] ^= 1 << int(self.rng.integers(0, 8))
            frames = [bytes(b)]
        if self._hit(p.dup_every, p.dup_p):
            frames = frames * 2
        return frames, False


def corrupt_replica(opt, rank: int, name: "str | None" = None, *,
                    bit: "int | None" = None, index: int = 0) -> str:
    """Flip one bit of parameter ``name`` on data-parallel replica ``rank``
    only — silent data corruption: rank ``rank`` changes its own copy and
    every other rank keeps its own, so the replicas differ while the step
    treats them as one.  The replica-consensus guard
    (`MPI_PS.check_consensus`) is the only thing that can see it.  Every
    rank calls it; returns the corrupted leaf's name.

    ``bit`` indexes from the low end of the element's bit pattern (reduced
    mod the element width); ``index`` picks the flat element.  The default
    (``bit=None``) picks, deterministically, the highest bit whose flip
    yields a finite, moderate value (the JAX package's rule): a flip to
    inf would NaN every replica alike on the next step, and one into the
    denormals is rounded away before a periodic check can see it."""
    name = name if name is not None else next(iter(opt.params))
    if name not in opt.params:
        raise KeyError(f"no parameter {name!r}; have {list(opt.params)}")
    if not 0 <= rank < opt.world_size:
        raise ValueError(
            f"replica {rank} out of range for {opt.world_size} device "
            f"copies")
    if opt.rank != rank:
        return name
    p = opt.params[name]
    width = p.element_size()
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[width]
    host = p.detach().cpu().reshape(-1).contiguous()
    view = host.view(ints).numpy().view(f"<u{width}")  # shares host's bytes
    flat_i = index % max(view.size, 1)
    nbits = 8 * width
    candidates = ([bit % nbits] if bit is not None
                  else range(nbits - 2, -1, -1))  # skip the sign bit
    old = float(host[flat_i])

    def as_float(bits) -> float:
        one = torch.from_numpy(bits.view(f"<i{width}")
                               if width > 1 else bits).view(p.dtype)
        return float(one[0])

    for b in candidates:
        trial = view[flat_i:flat_i + 1].copy()
        trial ^= np.array(1 << b, dtype=view.dtype)
        newf = as_float(trial)
        if (np.isfinite(newf) and abs(newf) < 1e6
                and abs(newf - old) > 1e-3 * (1.0 + abs(old))):
            view[flat_i] = trial[0]
            break
    else:  # pathological dtype/value: the top exponent-ish bit
        view[flat_i] ^= np.array(1 << (nbits - 2), dtype=view.dtype)
    opt.params[name] = host.view(p.shape).to(p.device)
    return name


def poison_nonfinite(tree):
    """A copy of a host-side code tree with a NaN planted in its first
    float leaf — the injected non-finite gradient the PS-side quarantine
    must catch.  Leaves are numpy arrays or (for a bf16 wire) CPU
    tensors; non-float trees (integer codecs) pass through unchanged:
    there is nothing representable to poison."""
    leaves, treedef = tree_flatten(tree)
    out = []
    poisoned = False
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            floating = leaf.is_floating_point()
            size = leaf.numel()
        else:
            leaf = np.asarray(leaf)
            floating = np.issubdtype(leaf.dtype, np.floating)
            size = leaf.size
        if not poisoned and floating and size:
            leaf = leaf.clone() if isinstance(leaf, torch.Tensor) \
                else leaf.copy()
            leaf.reshape(-1)[0] = float("nan")
            poisoned = True
        out.append(leaf)
    return tree_unflatten(treedef, out)
