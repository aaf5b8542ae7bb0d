"""The port's resumable `DataLoader` and native row gather against the JAX
package's.

The index stream is part of the contract: the same seed gives the same
batches in the same order in both packages, and a position saved in one
resumes in the other.  Every comparison here is bitwise.  The native
library is the port's own build of the copied ``ps_loader.cpp``.
"""

import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu.data import loader as jloader
from pytorch_ps_mpi_tpu_torch.data import loader as tloader


def _arrays(n=50):
    rng = np.random.RandomState(0)
    return {"x": rng.randn(n, 3, 4).astype(np.float32),
            "y": rng.randint(0, 10, n).astype(np.int32)}


def _take(it, k):
    return [next(it) for _ in range(k)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_three_epochs_match_jax_bitwise(drop_last, shuffle):
    """Batches and positions over 3 epochs (each epoch's order a function
    of ``seed + epoch``; a ragged last batch without ``drop_last``)."""
    arrays = _arrays()
    kw = dict(batch_size=16, seed=7, shuffle=shuffle, drop_last=drop_last,
              epochs=3)
    jl, tl = jloader.DataLoader(arrays, **kw), tloader.DataLoader(arrays, **kw)
    assert len(tl) == len(jl) == (9 if drop_last else 12)
    got, want, positions = [], [], []
    for g, w in zip(tl, jl):
        got.append(g)
        want.append(w)
        assert tl.state_dict() == jl.state_dict()
        positions.append(tl.state_dict()["batch_index"])
    _assert_same(got, want)
    assert len(got) == len(jl)
    assert positions[:4] == ([1, 2, 3, 1] if drop_last else [1, 2, 3, 4])


def test_resume_mid_epoch_matches_jax_bitwise():
    """A position taken mid-epoch (prefetched batches not counted) resumes
    a fresh loader of either package onto the same stream; a second
    ``iter()`` continues where the first stopped."""
    arrays = _arrays()
    kw = dict(batch_size=8, seed=3, epochs=None)
    straight = _take(iter(jloader.DataLoader(arrays, **kw)), 14)

    tl = tloader.DataLoader(arrays, prefetch=4, **kw)
    it = iter(tl)
    head = _take(it, 4)
    sd = tl.state_dict()
    assert sd == {"epoch": 0, "batch_index": 4, "seed": 3, "batch_size": 8,
                  "shuffle": True}
    it.close()
    _assert_same(head + _take(iter(tl), 3), straight[:7])

    for make in (jloader.DataLoader, tloader.DataLoader):
        resumed = make(arrays, **kw)
        resumed.load_state_dict(sd)
        _assert_same(_take(iter(resumed), 10), straight[4:])
    mid_next_epoch = dict(sd, epoch=1, batch_index=2)
    j, t = (make(arrays, **kw) for make in (jloader.DataLoader,
                                              tloader.DataLoader))
    j.load_state_dict(mid_next_epoch)
    t.load_state_dict(mid_next_epoch)
    _assert_same(_take(iter(t), 5), _take(iter(j), 5))
    _assert_same(_take(iter(t), 1), straight[6 + 2 + 5:6 + 2 + 6])


@pytest.mark.parametrize("key,value", [("seed", 4), ("batch_size", 16),
                                       ("shuffle", False)])
def test_resume_refusals_match_jax(key, value):
    arrays = _arrays()
    sd = {"epoch": 1, "batch_index": 2, "seed": 3, "batch_size": 8,
          "shuffle": True, key: value}
    msgs = []
    for make in (jloader.DataLoader, tloader.DataLoader):
        with pytest.raises(ValueError, match="loader resume mismatch") as e:
            make(arrays, batch_size=8, seed=3).load_state_dict(sd)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_gather_rows_matches_numpy():
    rng = np.random.RandomState(1)
    src = rng.randn(33, 5, 7).astype(np.float32)
    idx = rng.randint(0, 33, 20)
    np.testing.assert_array_equal(tloader.gather_rows(src, idx), src[idx])
    np.testing.assert_array_equal(tloader.gather_rows(src, idx),
                                  jloader.gather_rows(src, idx))
    out = np.empty((20, 5, 7), np.float32)
    assert tloader.gather_rows(src, idx, out=out) is out
    assert tloader.gather_rows(src, idx[:0]).shape == (0, 5, 7)
    with pytest.raises(IndexError):
        tloader.gather_rows(src, np.array([33]))
    with pytest.raises(ValueError, match="mismatch"):
        tloader.gather_rows(src, idx, out=np.empty((20, 5, 6), np.float32))


def test_device_batches_are_tensors_of_the_same_rows():
    """``device=`` gives tensors on that device (the CPU here; on a card,
    from pinned host memory by a non-blocking copy) holding the host
    loader's rows; ``device=None`` keeps numpy."""
    arrays = _arrays()
    host = _take(iter(tloader.DataLoader(arrays, batch_size=16, seed=2,
                                         epochs=None)), 5)
    dev = _take(iter(tloader.DataLoader(arrays, batch_size=16, seed=2,
                                        epochs=None, device="cpu")), 5)
    assert isinstance(host[0]["x"], np.ndarray)
    assert isinstance(dev[0]["x"], torch.Tensor)
    assert dev[0]["y"].dtype == torch.int32
    _assert_same(dev, host)


def test_producer_errors_surface_and_bad_configs_raise():
    with pytest.raises(ValueError, match="leading dims differ"):
        tloader.DataLoader({"x": np.zeros(4), "y": np.zeros(5)}, 2)
    with pytest.raises(ValueError, match="bad batch_size"):
        tloader.DataLoader({"x": np.zeros(4)}, 5)
    with pytest.raises(TypeError, match="infinite"):
        len(tloader.DataLoader({"x": np.zeros(4)}, 2, epochs=None))
    bad = tloader.DataLoader({"x": np.zeros(4)}, 2)
    bad._assemble = lambda idx: 1 / 0
    with pytest.raises(ZeroDivisionError):
        next(iter(bad))
