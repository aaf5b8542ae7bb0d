"""Prefetching, resumable data loader over the native row gather.

Counterpart of `pytorch_ps_mpi_tpu/data/loader.py`.  Pipeline per batch:
draw the row indices (a per-epoch shuffle) → the native multi-threaded
row gather (`gather_rows`, GIL released) into a contiguous buffer → with
``device=`` a card, that buffer is pinned host memory and a
``non_blocking`` copy puts it on the card, all on a background thread that
keeps ``prefetch`` batches in flight.  The JAX loader's ``sharding=``
becomes ``device=``: the step shards the global batch itself
(`MPI_PS._shard_batch`).

The index stream, the positions and the `load_state_dict` refusals are
the JAX loader's, so the same seed gives the same batches in the same
order in both packages, also after a resume.
"""

from __future__ import annotations

import ctypes
import queue
import threading
from typing import Iterator

import numpy as np
import torch


def gather_rows(src: np.ndarray, idx: np.ndarray, *,
                out: np.ndarray | None = None,
                n_threads: int = 4) -> np.ndarray:
    """``src[idx]`` via the native parallel gather (equivalent to numpy
    fancy indexing, multi-threaded for large rows)."""
    from ..native import lib

    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.ndim != 1:
        raise ValueError("idx must be 1-D")
    if len(idx) and (len(src) == 0 or idx.min() < 0 or idx.max() >= len(src)):
        raise IndexError("gather index out of range")
    row_bytes = src.nbytes // max(len(src), 1)
    shape = (len(idx),) + src.shape[1:]
    if out is None:
        out = np.empty(shape, src.dtype)
    elif (out.shape != shape or out.dtype != src.dtype
          or not out.flags["C_CONTIGUOUS"]):
        raise ValueError("out buffer shape/dtype mismatch")
    if len(idx):
        lib().ps_gather_rows(
            ctypes.c_void_p(src.ctypes.data),
            ctypes.c_void_p(idx.ctypes.data),
            len(idx), row_bytes,
            ctypes.c_void_p(out.ctypes.data), n_threads)
    return out


class DataLoader:
    """Iterate global batches with background prefetch.

    ``arrays``: ``{name: np.ndarray}`` with equal leading dims.
    ``device``: None keeps batches on the host as numpy arrays; a device
    (``"cuda"``, ``"cuda:1"``, ``"cpu"``) gives tensors there — for a card
    gathered into pinned host memory and copied with ``non_blocking`` on
    the prefetch thread.  ``epochs``: how many passes (None = infinite),
    counted in absolute epochs, including any skipped by a resumed
    position.

    Resumable: `state_dict` captures the stream position in consumed
    batches — ``(epoch, batch_index)`` counted when a batch is yielded, so
    prefetched but undelivered batches never count — and `load_state_dict`
    fast-forwards the next iterator to that point.  Each epoch's order is
    a pure function of ``seed + epoch``, so a resumed run replays the same
    batch sequence bitwise.  The loader is a stream with a persistent
    position: a second ``iter()`` continues where the first stopped.
    Closing an iterator (or dropping it) stops and joins its prefetch
    thread."""

    def __init__(self, arrays: dict, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2,
                 device=None, n_threads: int = 4,
                 epochs: int | None = 1):
        if not arrays:
            raise ValueError("arrays must not be empty")
        lens = {k: len(v) for k, v in arrays.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"leading dims differ: {lens}")
        self.arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
        self.n = next(iter(lens.values()))
        if batch_size < 1 or (drop_last and batch_size > self.n):
            raise ValueError(f"bad batch_size {batch_size} for {self.n} rows")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = max(1, prefetch)
        self.device = None if device is None else torch.device(device)
        if (self.device is not None and self.device.type == "cuda"
                and self.device.index is None):
            # The prefetch thread's current card is card 0, whatever the
            # caller's is: name it.
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.n_threads = n_threads
        self.epochs = epochs
        # Stream position: where the next iterator starts (set by
        # load_state_dict) and where the consumer currently is (updated as
        # batches are yielded; state_dict reads it).
        self._epoch = 0
        self._batch_index = 0

    # -- resume ------------------------------------------------------------

    def state_dict(self) -> dict:
        """Position of the next undelivered batch: absolute ``epoch``,
        ``batch_index`` within it, plus the shuffle identity (seed /
        batch_size) a resume must match for bitwise replay."""
        return {"epoch": int(self._epoch),
                "batch_index": int(self._batch_index),
                "seed": int(self.seed), "batch_size": int(self.batch_size),
                "shuffle": bool(self.shuffle)}

    def load_state_dict(self, sd: dict) -> None:
        """Fast-forward the next iterator to a `state_dict` position.
        Refuses a position whose shuffle identity differs: replaying a
        different sequence while claiming to resume would be silent data
        skew."""
        for key in ("seed", "batch_size", "shuffle"):
            if key in sd and sd[key] != getattr(self, key):
                raise ValueError(
                    f"loader resume mismatch: checkpoint {key}={sd[key]!r} "
                    f"vs this loader's {getattr(self, key)!r} — the resumed "
                    f"stream would not replay the same batches")
        self._epoch = int(sd["epoch"])
        self._batch_index = int(sd["batch_index"])

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if self.shuffle:
            return np.random.RandomState(self.seed + epoch).permutation(self.n)
        return np.arange(self.n)

    def _index_stream(self):
        """Yield ``(epoch, batch_index, row_indices)`` from the current
        resume position."""
        epoch, skip = self._epoch, self._batch_index
        while self.epochs is None or epoch < self.epochs:
            order = self._epoch_order(epoch)
            stop = (self.n - self.batch_size + 1 if self.drop_last
                    else self.n)
            starts = range(0, max(stop, 0), self.batch_size)
            for b, i in enumerate(starts):
                if b < skip:
                    continue
                yield epoch, b, order[i:i + self.batch_size]
            epoch, skip = epoch + 1, 0

    def __len__(self) -> int:
        if self.epochs is None:
            raise TypeError("infinite DataLoader (epochs=None) has no len()")
        per = (self.n // self.batch_size if self.drop_last
               else -(-self.n // self.batch_size))
        return per * self.epochs

    def _assemble(self, idx):
        if self.device is None:
            return {k: gather_rows(v, idx, n_threads=self.n_threads)
                    for k, v in self.arrays.items()}
        pin = self.device.type == "cuda"
        batch = {}
        for k, v in self.arrays.items():
            host = torch.empty((len(idx),) + v.shape[1:],
                               dtype=torch.from_numpy(v[:0]).dtype,
                               pin_memory=pin)
            gather_rows(v, idx, out=host.numpy(), n_threads=self.n_threads)
            batch[k] = host.to(self.device, non_blocking=pin)
        return batch

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _END = object()
        error: list = []
        stop = threading.Event()

        def _put(item) -> bool:
            # A bounded put that gives up when the consumer is gone: an
            # abandoned iterator must not leak a thread holding buffers.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for epoch, b, idx in self._index_stream():
                    if stop.is_set() \
                            or not _put((epoch, b, self._assemble(idx))):
                        return
            except Exception as exc:  # surface in the consumer, don't hang
                error.append(exc)
            finally:
                _put(_END)

        t = threading.Thread(target=produce, daemon=True,
                             name="dataloader-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    if error:
                        raise error[0]
                    return
                epoch, b, batch = item
                # The position advances only when the batch is delivered.
                self._epoch, self._batch_index = epoch, b + 1
                yield batch
        finally:
            # Runs on break and close too: release the producer and wait
            # for it (at most the batch it is assembling), so no thread
            # outlives the iterator inside torch or the native gather —
            # a daemon thread stopped there at interpreter exit aborts
            # the process.
            stop.set()
            t.join()
