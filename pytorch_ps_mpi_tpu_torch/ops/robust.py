"""Byzantine-robust stacked-gradient reducers + per-rank anomaly scoring.

Counterpart of `pytorch_ps_mpi_tpu/ops/robust.py`, in plain PyTorch on
the PS's device.  A gradient that is finite, well-formed and **wrong** — a
sign-flipped, a 100x-scaled or a constant gradient from a compromised or
silently broken worker — sails through a plain (staleness-weighted) sum;
robust aggregation replaces the sum with a statistic whose breakdown point
is above zero (Blanchard et al., *Krum*, NeurIPS 2017; Yin et al.,
coordinate-wise trimmed mean / median, ICML 2018).

* `robust_reduce`: reducers over a stack of **decoded dense**
  contributions (leading dim = contributor), composing with
  per-contribution weights (staleness damping x quarantine
  down-weighting) and the quorum renormalization (``n_target``): every
  reducer returns a gradient at **sum scale** — the per-contributor
  statistic times the fill target — so the optimizer sees the magnitude
  of the reference's ``sum(grads)`` whatever the fill's size;
* `RankScoreboard`, the host-side per-rank anomaly policy (rolling robust
  z-score of each rank's gradient norm, reversible ok -> suspect ->
  quarantined lifecycle), copied with the JAX package's numbers.

The scale contract: with ``aggregate="mean"``, weights ``w`` and a full
fill (``n == n_target``), `robust_reduce` equals ``sum_i w_i * g_i`` —
the async PS's linear path.  Weights damp contributions *before* the
robust statistic.

Two traps of a literal translation: ``torch.median`` returns the lower of
the two middle values of an even count, where ``jnp.median`` averages
them (`_median0` sorts and averages the middle pair as JAX does, NaN
propagating); and a bf16 leaf times an f32 0-d tensor stays bf16 in torch
but promotes to f32 in JAX (`_promote` widens first).
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Any

import numpy as np
import torch

ROBUST_REDUCERS = ("mean", "trimmed_mean", "median", "norm_clip")

# Reducers that are coordinate-wise: the statistic at each coordinate
# depends only on that coordinate's stack of contributions, so reducing
# bucket sub-trees independently composes to exactly the whole-tree
# statistic (what the hierarchy's per-bucket pre-reduce relies on).
# norm_clip is not: its clip factor is each contribution's global norm
# across every leaf, which no single bucket can see.
COORDINATEWISE_REDUCERS = frozenset(("mean", "trimmed_mean", "median"))


def bucket_streamable(aggregate: str, *,
                      anomaly_scoring: bool = False) -> bool:
    """Whether ``aggregate`` may be applied per bucket with results that
    compose bitwise to the whole-tree reduce: coordinate-wise reducers
    qualify, ``norm_clip`` does not, and anomaly scoring disqualifies any
    reducer (the scoreboard scores whole-gradient norms).  A caller (the
    hierarchy's `LocalAggregator`) keeps the whole-tree reduce and only
    splits the result for sending when this is False."""
    if aggregate not in ROBUST_REDUCERS:
        raise ValueError(
            f"unknown aggregate {aggregate!r}; have {list(ROBUST_REDUCERS)}")
    return aggregate in COORDINATEWISE_REDUCERS and not anomaly_scoring


class ReducerCodecError(TypeError):
    """A non-linear robust reducer was combined with a codec that cannot
    decode individual contributions (``itemwise_decode = False``: its only
    decode path is the fused ``decode_sum``).  Trimming, median and
    clipping need each contribution separately; the linear fast path
    would silently apply un-reduced gradients, so this is refused when the
    step is compiled."""


def check_reducer_codec(aggregate: str, code, *,
                        anomaly_scoring: bool = False) -> bool:
    """The compile-time compatibility gate.  Returns True when the
    itemwise decode path is needed (a non-linear reducer, or anomaly
    scoring, which needs per-contribution norms even under ``mean``);
    raises the typed `ReducerCodecError` when that path is needed but the
    codec cannot decode single contributions."""
    itemwise_needed = aggregate != "mean" or anomaly_scoring
    if itemwise_needed and not getattr(code, "itemwise_decode", True):
        why = (f"aggregate={aggregate!r}" if aggregate != "mean"
               else "anomaly scoring")
        raise ReducerCodecError(
            f"codec {code.name!r} decodes only the cross-contributor SUM "
            f"(itemwise_decode=False, a decode_sum-only sketch-style "
            f"codec); {why} needs each contribution decoded separately. "
            f"Use a codec with per-contribution decode, or aggregate="
            f"'mean' without anomaly scoring.")
    return itemwise_needed


def tree_contrib_norms(stacked_tree: "OrderedDict[str, torch.Tensor]"):
    """Global L2 norm of each stacked contribution across EVERY leaf of the
    tree: ``[n]`` f32 for leaves shaped ``[n, ...]`` (the whole-gradient
    norm, not per-leaf norms: a per-leaf clip would let an attacker
    spread its energy across leaves under each leaf's threshold)."""
    sq = None
    for leaf in stacked_tree.values():
        s = torch.sum(leaf.to(torch.float32).reshape(leaf.shape[0], -1)
                      ** 2, dim=1)
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def _trim_k_eff(k: "int | None", n: int) -> int:
    """Effective per-side trim count: the requested ``k`` (default 1)
    clamped so at least one contribution survives (``2k < n``)."""
    want = 1 if k is None else int(k)
    return max(0, min(want, (n - 1) // 2))


def _promote(x: torch.Tensor) -> torch.Tensor:
    """``x`` widened to at least float32: JAX promotes a bf16 array times
    an f32 scalar array to f32, where torch keeps the array's dtype."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _median0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median(x, axis=0)``: any NaN along the axis gives NaN; else
    the sorted middle pair ``(lo + hi) * 0.5`` in ``x``'s dtype (the
    middle value twice for an odd count)."""
    n = x.shape[0]
    x = torch.where(torch.isnan(x).any(dim=0, keepdim=True),
                    torch.full_like(x, float("nan")), x)
    s = torch.sort(x, dim=0).values
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def robust_reduce(aggregate: str, stacked_tree, weights, *, n_target,
                  trim_k: "int | None" = None, clip_norm=None):
    """Reduce a stack of decoded contributions to one sum-scale gradient.

    ``stacked_tree``: name -> dense tensor ``[n, *shape]`` (n
    contributors).  ``weights``: ``[n]`` per-contribution damping.
    ``n_target``: the fill target the result renormalizes to, so a quorum
    short-fill takes a full-magnitude step.  ``clip_norm`` (norm_clip
    only): the rolling median norm from the host; NaN (or None) falls
    back to this fill's median.

    Returns ``(reduced_tree, info)`` with ``info = {"contrib_norms": [n]
    raw (pre-weight) norms, "clipped": count of clipped contributions}``
    (0-d tensors on the device; the caller reads them)."""
    if aggregate not in ROBUST_REDUCERS:
        raise ValueError(
            f"unknown aggregate {aggregate!r}; have {list(ROBUST_REDUCERS)}")
    names = list(stacked_tree)
    first = stacked_tree[names[0]]
    n, device = first.shape[0], first.device
    f32 = dict(dtype=torch.float32, device=device)
    w = torch.as_tensor(weights).to(**f32)
    scale_to_target = torch.as_tensor(n_target).to(**f32)
    # A tensor divisor: on the card, a division by a Python number is a
    # multiply by its reciprocal.
    count = torch.tensor(float(n), **f32)
    raw_norms = tree_contrib_norms(stacked_tree)
    clipped = torch.zeros((), dtype=torch.int32, device=device)

    def per_contrib(v, leaf):
        return v.reshape((n,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)

    def weighted(leaf):
        return leaf * per_contrib(w, leaf)

    out = OrderedDict()
    if aggregate == "mean":
        # sum x (target/n): equals the linear weighted sum on a full fill.
        renorm = scale_to_target / count
        for name in names:
            out[name] = _promote(torch.sum(weighted(stacked_tree[name]),
                                           dim=0)) * renorm
    elif aggregate == "trimmed_mean":
        k = _trim_k_eff(trim_k, n)
        for name in names:
            c = torch.sort(weighted(stacked_tree[name]), dim=0).values
            kept = c[k:n - k] if k else c
            # jnp.mean: an f32 (at least) sum over a true division by the
            # count, back in the leaf's dtype.
            mean = (torch.sum(_promote(kept), dim=0)
                    / torch.tensor(float(kept.shape[0]), **f32)).to(
                        kept.dtype)
            out[name] = _promote(mean) * scale_to_target
    elif aggregate == "median":
        for name in names:
            out[name] = (_promote(_median0(weighted(stacked_tree[name])))
                         * scale_to_target)
    else:  # norm_clip
        # Clip each WEIGHTED contribution's global norm to the rolling
        # median norm (host-fed), then take the renormalized mean.
        wnorms = raw_norms * w
        batch_median = _median0(wnorms)
        clip = torch.tensor(float("nan") if clip_norm is None
                            else float(clip_norm), **f32)
        thresh = torch.where(torch.isnan(clip), batch_median, clip)
        factor = torch.minimum(
            torch.ones((), **f32),
            thresh / torch.clamp_min(wnorms, 1e-12))
        clipped = torch.sum((factor < 1.0).to(torch.int32))
        renorm = scale_to_target / count
        for name in names:
            leaf = weighted(stacked_tree[name])
            out[name] = _promote(torch.sum(leaf * per_contrib(factor, leaf),
                                           dim=0)) * renorm
    return out, {"contrib_norms": raw_norms, "clipped": clipped}


# ---------------------------------------------------------------------------
# Per-rank anomaly scoring + quarantine (host-side policy)
# ---------------------------------------------------------------------------

class RankScoreboard:
    """Rolling gradient-norm z-score per rank, with a reversible
    down-weight -> quarantine lifecycle.

    Each observed contribution's global norm is scored in LOG space
    (norms decay by orders of magnitude as training converges).  Each
    rank keeps an EMA of its log-norm; the score is the robust z of that
    EMA against a fleet-wide rolling window's median/MAD, computed
    LEAVE-ONE-RANK-OUT (a rank is judged against the other ranks' norms
    only, so a prolific attacker cannot inflate the spread it is measured
    against; a single-rank fleet scores 0).  Every NON-quarantined
    observation feeds the window, breaching ones included, so the
    baseline follows the fleet's drift.  ``downweight_after`` consecutive
    out-of-band observations make a rank suspect (submissions weighted by
    ``suspect_weight``), ``quarantine_after`` quarantine it (submissions
    dropped + counted, but still *scored*); ``recover_after`` consecutive
    in-band observations reinstate it.  No verdict before ``min_history``
    fleet observations."""

    OK, SUSPECT, QUARANTINED = "ok", "suspect", "quarantined"

    def __init__(self, z_threshold: float = 4.0, *, window: int = 48,
                 min_history: int = 8, ema_alpha: float = 0.3,
                 downweight_after: int = 3, quarantine_after: int = 6,
                 recover_after: int = 3, suspect_weight: float = 0.25):
        if z_threshold <= 0:
            raise ValueError(f"z_threshold must be > 0, got {z_threshold}")
        if not 0 < downweight_after <= quarantine_after:
            raise ValueError("need 0 < downweight_after <= quarantine_after")
        self.z_threshold = float(z_threshold)
        self.min_history = int(min_history)
        self.ema_alpha = float(ema_alpha)
        self.downweight_after = int(downweight_after)
        self.quarantine_after = int(quarantine_after)
        self.recover_after = int(recover_after)
        self.suspect_weight = float(suspect_weight)
        self._window: deque = deque(maxlen=int(window))
        self._ema: dict[int, float] = {}
        self._score: dict[int, float] = {}
        self._breaches: dict[int, int] = {}
        self._calm: dict[int, int] = {}
        self._state: dict[int, str] = {}
        self.quarantine_events = 0
        self.recoveries = 0

    # -- scoring -----------------------------------------------------------

    def _robust_z(self, rank: int, value: float) -> float:
        others = [v for r, v in self._window if r != rank]
        if len(others) < self.min_history:
            return 0.0
        arr = np.asarray(others, np.float64)
        med = float(np.median(arr))
        mad = float(np.median(np.abs(arr - med)))
        # 1.4826*MAD ~ sigma for a normal core; the floor (log space: 0.05
        # ~ 5% relative) keeps a near-constant norm stream from turning
        # numerical noise into "anomalies".
        sigma = max(1.4826 * mad, 0.05)
        return (value - med) / sigma

    def observe(self, rank: int, norm: float) -> float:
        """Record one contribution's norm for ``rank``; returns the updated
        score and advances the lifecycle."""
        value = float(np.log(max(float(norm), 1e-12)))
        prev = self._ema.get(rank)
        ema = value if prev is None else (self.ema_alpha * value
                                          + (1 - self.ema_alpha) * prev)
        self._ema[rank] = ema
        score = self._robust_z(rank, ema)
        self._score[rank] = score
        state = self._state.get(rank, self.OK)
        if abs(score) > self.z_threshold:
            self._breaches[rank] = self._breaches.get(rank, 0) + 1
            self._calm[rank] = 0
            b = self._breaches[rank]
            if b >= self.quarantine_after:
                if state != self.QUARANTINED:
                    self.quarantine_events += 1
                state = self.QUARANTINED
            elif b >= self.downweight_after and state == self.OK:
                state = self.SUSPECT
        else:
            self._calm[rank] = self._calm.get(rank, 0) + 1
            if state != self.OK and self._calm[rank] >= self.recover_after:
                state = self.OK
                self._breaches[rank] = 0
                self.recoveries += 1
        if state != self.QUARANTINED:
            self._window.append((rank, value))
        self._state[rank] = state
        return score

    # -- policy reads ------------------------------------------------------

    def state(self, rank: int) -> str:
        return self._state.get(rank, self.OK)

    def weight(self, rank: "int | None") -> float:
        """Admission weight multiplier for a rank's next contribution (a
        quarantined rank's submissions are dropped before weighting; 0.0
        is the honest answer if asked)."""
        if rank is None:
            return 1.0
        s = self.state(rank)
        if s == self.SUSPECT:
            return self.suspect_weight
        if s == self.QUARANTINED:
            return 0.0
        return 1.0

    def is_quarantined(self, rank: "int | None") -> bool:
        return rank is not None and self.state(rank) == self.QUARANTINED

    def quarantined_ranks(self) -> "list[int]":
        return sorted(r for r, s in self._state.items()
                      if s == self.QUARANTINED)

    def snapshot(self) -> "dict[str, Any]":
        return {
            "rank_scores": {r: round(s, 3)
                            for r, s in sorted(self._score.items())},
            "rank_states": dict(sorted(self._state.items())),
            "quarantined_ranks": self.quarantined_ranks(),
            "quarantine_events": self.quarantine_events,
            "recoveries": self.recoveries,
        }
