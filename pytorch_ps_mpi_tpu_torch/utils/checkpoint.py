"""Checkpoint / resume on disk — atomic files over the native serializer.

Counterpart of `pytorch_ps_mpi_tpu/utils/checkpoint.py`: optimizer
checkpoints (`save_optimizer` / `load_optimizer` around
`MPI_PS.state_dict` / `load_state_dict`, or `AsyncPS`'s, whose state is
the same plain data with an empty ``aux``), pytree checkpoints (`save` /
`load`), step-tagged siblings with keep-last-K retention, and the
RESUMABLE marker a preemption leaves.  The bytes go through the port's
copy of the native serializer (`native.serializer`), whose buffer frames
are the JAX package's; its tree frame describes the tree in plain data,
so a file holds this package's own ``state_dict`` (its names and layouts:
conv kernels OIHW, Dense kernels ``(out, in)``; tensors as host numpy,
bfloat16 widened to float32).

A file the JAX package wrote is refused with a `CheckpointError` that
names the way across: read it with the JAX package, convert its
``state_dict`` with `utils.interop.state_from_jax`, load that into this
package's optimizer and save it again here.  ZeRO raw shards
(``raw_shards=True``) stay within one package.

`MPI_PS.state_dict` is collective: at a world of more than one rank every
rank calls `dump_optimizer_bytes` (or `save_optimizer` with
``write=False``), and one rank writes.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import re
import struct
import tempfile
from typing import Any

import numpy as np
import torch

from ..native import serializer
from .bytes import host_numpy
from .flatten import tree_leaves, tree_map

FORMAT_VERSION = 1

# Sidecar marker for a checkpoint written by the preemption path: it is
# the resume point a relaunch should pick up, and retention GC must never
# delete it.  A sidecar (not in-band metadata) so GC and resume-resolution
# can test it without decoding the checkpoint.
RESUMABLE_SUFFIX = ".RESUMABLE"


class CheckpointError(ValueError):
    """A checkpoint file that cannot be read: truncated, bit-flipped,
    wrong format version, written by the JAX package, or not an optimizer
    checkpoint at all.  `load` either returns a fully decoded,
    crc-verified tree or raises this."""


def _atomic_write(path: str, blob) -> None:
    """tmp file + rename: a crash mid-write never corrupts the previous
    file at ``path``."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save(path: str | os.PathLike, tree, *, meta: dict | None = None,
         level: int = 1) -> None:
    """Atomically write a tree checkpoint (numpy or host-tensor leaves)."""
    blob = serializer.dumps(_to_numpy(tree), level=level,
                            meta={"format_version": FORMAT_VERSION,
                                  **(meta or {})})
    _atomic_write(os.fspath(path), blob)


def loads_tree(blob: bytes, *, with_meta: bool = False,
               source: str = "<bytes>"):
    """`load` over in-memory bytes; ``source`` names the origin in the
    typed error."""
    try:
        tree, meta = serializer.loads(blob, with_meta=True)
    except serializer.ForeignTreeFrameError as exc:
        raise CheckpointError(f"cannot read checkpoint {source}: {exc}") \
            from exc
    except (ValueError, pickle.UnpicklingError, struct.error, EOFError,
            KeyError, IndexError, TypeError) as exc:
        raise CheckpointError(
            f"corrupt or unreadable checkpoint {source}: {exc}") from exc
    version = (meta or {}).get("format_version")
    if version != FORMAT_VERSION:
        raise CheckpointError(
            f"unsupported checkpoint format version {version!r} "
            f"(this build reads version {FORMAT_VERSION})")
    return (tree, meta) if with_meta else tree


def load(path: str | os.PathLike, *, with_meta: bool = False):
    """Read a checkpoint written by `save` or `save_optimizer` (numpy
    leaves).  The metadata is unpickled through a restricted loader."""
    with open(os.fspath(path), "rb") as f:
        blob = f.read()
    return loads_tree(blob, with_meta=with_meta,
                      source=repr(os.fspath(path)))


def file_digest(path: str | os.PathLike) -> str:
    """sha256 hex digest of a file's bytes: what a fleet manifest records
    per shard checkpoint, so a resume restores exactly the slices the
    coordinated snapshot cut (a swapped, tampered or re-written sibling
    fails the comparison)."""
    h = hashlib.sha256()
    with open(os.fspath(path), "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Periodic-checkpoint retention: step-tagged paths, keep-last-K GC, and
# RESUMABLE markers.
# ---------------------------------------------------------------------------


def step_path(base: str | os.PathLike, step: int) -> str:
    """The step-tagged sibling of ``base`` a periodic save writes to:
    ``ckpt.psz`` → ``ckpt.step00000010.psz``."""
    root, ext = os.path.splitext(os.fspath(base))
    return f"{root}.step{int(step):08d}{ext}"


def list_step_checkpoints(base: str | os.PathLike) -> "list[tuple[int, str]]":
    """All step-tagged siblings of ``base`` on disk, sorted by step."""
    base = os.fspath(base)
    d = os.path.dirname(os.path.abspath(base))
    root, ext = os.path.splitext(os.path.basename(base))
    pat = re.compile(re.escape(root) + r"\.step(\d+)" + re.escape(ext) + "$")
    try:
        names = os.listdir(d)
    except OSError:
        return []
    out = [(int(m.group(1)), os.path.join(d, f))
           for f in names for m in [pat.match(f)] if m]
    return sorted(out)


def mark_resumable(path: str | os.PathLike, info: dict | None = None) -> None:
    """Stamp ``path`` as the resume point (see `RESUMABLE_SUFFIX`)."""
    with open(os.fspath(path) + RESUMABLE_SUFFIX, "w") as f:
        json.dump(info or {}, f)
        f.write("\n")


def is_resumable(path: str | os.PathLike) -> bool:
    return os.path.exists(os.fspath(path) + RESUMABLE_SUFFIX)


def clear_resumable(path: str | os.PathLike) -> None:
    """Consume the marker (after a successful resume)."""
    try:
        os.unlink(os.fspath(path) + RESUMABLE_SUFFIX)
    except OSError:
        pass


def gc_step_checkpoints(base: str | os.PathLike,
                        keep_last: int = 3) -> "list[str]":
    """Delete step-tagged checkpoints beyond the newest ``keep_last``;
    never the newest and never a RESUMABLE-marked one.  Returns the
    deleted paths."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    deleted = []
    for _step, p in list_step_checkpoints(base)[:-keep_last]:
        if is_resumable(p):
            continue
        try:
            os.unlink(p)
            deleted.append(p)
        except OSError:
            pass
    return deleted


def latest_checkpoint(base: str | os.PathLike) -> "str | None":
    """Resolve a resume or rollback target: the path itself when it
    exists, else the newest step-tagged sibling, else None."""
    base = os.fspath(base)
    if os.path.exists(base):
        return base
    entries = list_step_checkpoints(base)
    return entries[-1][1] if entries else None


# ---------------------------------------------------------------------------
# Optimizer checkpoints
# ---------------------------------------------------------------------------


def _is_array(leaf) -> bool:
    return isinstance(leaf, (np.ndarray, torch.Tensor))


def _to_numpy(tree):
    """Host numpy leaves (a tensor's bfloat16 widened to float32)."""
    return tree_map(lambda leaf: host_numpy(leaf)
                    if isinstance(leaf, torch.Tensor) else leaf, tree)


def optimizer_payload(opt, *, step: int | None = None,
                      extra: dict | None = None, raw_shards: bool = False,
                      wire_encode=None) -> "tuple[dict, dict]":
    """``(arrays, meta)`` of a PS optimizer checkpoint: every array-bearing
    entry of ``opt.state_dict()`` as host numpy, the rest (optim, hyper,
    topology) with ``step`` and the user's ``extra`` as metadata — what
    `dump_optimizer_bytes` serializes, and what the hot-standby
    replication stream (``REPL`` frames) sends as segments.

    ``raw_shards=True`` keeps ZeRO state in its live ``(world, chunk)``
    rows (readable by this package only).  ``wire_encode`` (replication
    only): a tree -> tree transform of the array payload, the server's
    wire codec (`ops.codecs.encode_wire_tree`); the metadata stays exact
    and the receiver applies `ops.codecs.decode_wire_tree` before
    `apply_optimizer`.  Files on disk never take it.  Collective: every
    rank of the optimizer's group must call it."""
    sd = opt.state_dict(raw_shards=True) if raw_shards else opt.state_dict()
    # Partition by content, not by a key list, so a future array-bearing
    # state_dict entry routes itself into the payload.
    arrays = {k: _to_numpy(sd.pop(k)) for k in list(sd)
              if any(_is_array(x) for x in tree_leaves(sd[k]))}
    if wire_encode is not None:
        arrays = wire_encode(arrays)
    return arrays, {"format_version": FORMAT_VERSION,
                    "state_dict_meta": sd, "step": step, "extra": extra}


def dump_optimizer_bytes(opt, *, step: int | None = None,
                         extra: dict | None = None, level: int = 1,
                         raw_shards: bool = False) -> bytes:
    """Serialize a PS optimizer checkpoint (`optimizer_payload`) to
    bytes."""
    arrays, meta = optimizer_payload(opt, step=step, extra=extra,
                                     raw_shards=raw_shards)
    return serializer.dumps(arrays, level=level, meta=meta)


def save_optimizer(path: str | os.PathLike, opt, *, step: int | None = None,
                   extra: dict | None = None, level: int = 1,
                   raw_shards: bool = False, write: bool = True) -> None:
    """Checkpoint a PS optimizer atomically: its full ``state_dict`` plus a
    user ``extra`` dict (e.g. the data loader's position).  At a world of
    more than one rank every rank calls it (the state gathers are
    collective) and only the ranks with ``write=True`` write the file."""
    blob = dump_optimizer_bytes(opt, step=step, extra=extra, level=level,
                                raw_shards=raw_shards)
    if write:
        _atomic_write(os.fspath(path), blob)


def apply_optimizer(opt, arrays, meta, *, min_step: int | None = None,
                    source: str = "<bytes>") -> dict[str, Any]:
    """Apply an already decoded optimizer checkpoint.  ``min_step``
    refuses a checkpoint whose recorded step is behind it, before any
    state is touched.  Returns ``{"step": ..., "extra": ...}``."""
    if not isinstance(meta, dict) or "state_dict_meta" not in meta:
        raise CheckpointError(
            f"{source} is a valid pytree checkpoint but not an optimizer "
            f"checkpoint (no state_dict metadata; was it written by "
            f"save() instead of save_optimizer()?)")
    if min_step is not None and int(meta.get("step") or 0) < int(min_step):
        raise CheckpointError(
            f"checkpoint {source} records step "
            f"{meta.get('step')!r}, behind the expected minimum "
            f"{min_step} — refusing to silently rewind training")
    sd = dict(meta["state_dict_meta"])
    sd.update(arrays)
    opt.load_state_dict(sd)
    return {"step": meta.get("step"), "extra": meta.get("extra")}


def load_optimizer_bytes(blob: bytes, opt, *, min_step: int | None = None,
                         source: str = "<bytes>") -> dict[str, Any]:
    """Restore a PS optimizer in place from `dump_optimizer_bytes`
    output (see `apply_optimizer`)."""
    arrays, meta = loads_tree(blob, with_meta=True, source=source)
    return apply_optimizer(opt, arrays, meta, min_step=min_step,
                           source=source)


def load_optimizer(path: str | os.PathLike, opt, *,
                   min_step: int | None = None) -> dict[str, Any]:
    """Restore a PS optimizer in place from `save_optimizer` output."""
    with open(os.fspath(path), "rb") as f:
        blob = f.read()
    return load_optimizer_bytes(blob, opt, min_step=min_step,
                                source=repr(os.fspath(path)))
