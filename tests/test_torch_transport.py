"""The port's transport layer against the JAX package's.

`pytorch_ps_mpi_tpu_torch/transport.py`, `utils/crc.py::crc32_combine`
and `utils/backoff.py` are copies of the JAX package's framework-free
modules.  The frame bytes are the contract between the two packages'
peers, so the framing helpers are held bitwise against the JAX functions
on the same seeded bytes, and `Session`'s flow-control scenarios (after
`tests/test_flow.py`) run against both packages' modules with the same
expected counts.
"""

import socket
import zlib

import numpy as np
import pytest

import pytorch_ps_mpi_tpu.transport as jtransport
import pytorch_ps_mpi_tpu_torch.transport as ttransport
from pytorch_ps_mpi_tpu import errors as jerrors
from pytorch_ps_mpi_tpu.utils import backoff as jbackoff
from pytorch_ps_mpi_tpu.utils import crc as jcrc
from pytorch_ps_mpi_tpu_torch import errors as terrors
from pytorch_ps_mpi_tpu_torch.utils import backoff as tbackoff
from pytorch_ps_mpi_tpu_torch.utils import crc as tcrc

PACKAGES = {"jax": (jtransport, jerrors), "torch": (ttransport, terrors)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _seeded_segments(seed: int):
    rng = np.random.default_rng(seed)
    sizes = [4, 24, 0, 300, 70_000, 1, 4096, 5]
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in sizes]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_framing_helpers_match_jax_bitwise(seed):
    segs = _seeded_segments(seed)
    whole = b"".join(segs)
    assert ttransport.frame_header(whole) == jtransport.frame_header(whole)
    assert (ttransport.segments_crc(segs) == jtransport.segments_crc(segs)
            == zlib.crc32(whole))
    assert ([bytes(x) for x in ttransport.frame_iovec(segs)]
            == [bytes(x) for x in jtransport.frame_iovec(segs)])
    # The cached-suffix form: the crc of the last k bytes is declared
    # known, the head is checksummed, and one combine gives the frame's.
    k = len(segs[-1]) + len(segs[-2]) + len(segs[-3])
    cached = (zlib.crc32(whole[-k:]), k)
    assert ([bytes(x) for x in ttransport.frame_iovec(segs, cached)]
            == [bytes(x) for x in jtransport.frame_iovec(segs, cached)]
            == [ttransport.frame_header(whole), *segs])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_crc32_combine_matches_jax_and_zlib(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        a = rng.integers(0, 256, int(rng.integers(0, 5000)),
                         dtype=np.uint8).tobytes()
        b = rng.integers(0, 256, int(rng.integers(0, 70000)),
                         dtype=np.uint8).tobytes()
        ca, cb = zlib.crc32(a), zlib.crc32(b)
        got = tcrc.crc32_combine(ca, cb, len(b))
        assert got == jcrc.crc32_combine(ca, cb, len(b))
        assert got == zlib.crc32(a + b)
        assert tcrc.fast_crc32(a + b) == zlib.crc32(a + b)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_backoff_ladder_matches_jax(seed):
    kw = dict(base=0.1, maximum=1.0, retries=7, seed=seed)
    got = list(tbackoff.Backoff(**kw).delays())
    assert got == list(jbackoff.Backoff(**kw).delays())
    assert len(got) == 7
    for k, d in enumerate(got):
        raw = min(1.0, 0.1 * 2 ** k)
        assert 0.5 * raw <= d <= 1.5 * raw
    # A spent deadline cuts the ladder short; retries=-1 is refused.
    spent = ttransport.Deadline(0.0)
    assert list(tbackoff.Backoff(retries=50, deadline=spent).delays()) == []
    with pytest.raises(ValueError, match="retries must be >= 0"):
        tbackoff.Backoff(retries=-1)


def test_deadline_never_and_restart():
    never = ttransport.Deadline.never()
    assert never.budget is None and not never.expired()
    assert never.timeout() is None and never.timeout(cap=0.5) == 0.5
    d = ttransport.Deadline(0.0)
    assert d.expired()
    d.budget = 60.0
    assert d.restart() is d and not d.expired()


def test_recv_arena_counts_crc_failed_frames_as_rotations(pkg):
    transport, _ = pkg
    a, b = socket.socketpair()
    a.settimeout(5.0)
    arena = transport.RecvArena(nbufs=3)
    assert arena.window == 2
    try:
        b.sendall(transport.frame_header(b"good1") + b"good1")
        assert bytes(arena.recv_frame(a)) == b"good1"
        assert arena.frames == 1
        # A payload corrupted after its header crc: the slot rotates, the
        # frame fails its check.
        b.sendall(transport.frame_header(b"good2") + b"BAD-2")
        with pytest.raises(transport.FrameCRCError):
            arena.recv_frame(a)
        assert arena.frames == 2
        b.sendall(transport.frame_header(b"good3") + b"good3")
        assert bytes(arena.recv_frame(a)) == b"good3"
        assert arena.frames == 3
    finally:
        a.close()
        b.close()


def _session_pair(transport, **kw):
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return transport.Session(a, **kw), b


def test_session_control_frames_bypass_credit_gate(pkg):
    transport, _ = pkg
    sess, peer = _session_pair(transport)
    try:
        sess.replenish(0)
        assert sess.send(b"GRADxxxx") is False
        assert sess.send(b"BEAT") is True
        assert transport.recv_frame(peer) == b"BEAT"
        assert sess.stats["credits_stalled"] == 1
    finally:
        sess.close()
        peer.close()


def test_session_credits_consume_replenish_and_flush(pkg):
    transport, _ = pkg
    sess, peer = _session_pair(transport)
    try:
        sess.replenish(2)
        assert sess.send_data(b"GRADa") is True
        assert sess.send_data(b"GRADb") is True
        assert sess.credits() == 0
        assert sess.send_data(b"GRADc") is False
        assert sess.pending_count() == 1
        sess.replenish(5)
        assert sess.pending_count() == 0
        got = [transport.recv_frame(peer) for _ in range(3)]
        assert got == [b"GRADa", b"GRADb", b"GRADc"]
        assert sess.credits() == 4
    finally:
        sess.close()
        peer.close()


def test_session_sheds_oldest_first_and_caps_credits(pkg):
    transport, _ = pkg
    sess, peer = _session_pair(transport, max_pending=2, credit_cap=3)
    try:
        sess.replenish(0)
        for tag in (b"1", b"2", b"3", b"4"):
            sess.send_data(b"GRAD" + tag)
        assert sess.stats["shed_data_frames"] == 2
        assert sess.stats["credits_stalled"] == 4
        sess.replenish(1000)
        assert transport.recv_frame(peer) == b"GRAD3"
        assert transport.recv_frame(peer) == b"GRAD4"
        assert sess.credits() == 1  # the cap of 3, less the two flushed
    finally:
        sess.close()
        peer.close()


def test_session_pace_epochs_and_open_valve(pkg):
    transport, _ = pkg
    stalls = []
    sess, peer = _session_pair(transport, pace_hook=lambda: stalls.append(1))
    try:
        sess.set_pace(1)
        assert sess.send_data(b"AGGRa") is True
        assert sess.send_data(b"AGGRb") is False
        assert len(stalls) == 1
        assert sess.stats["credits_stalled"] == 0
        sess.new_epoch()
        assert transport.recv_frame(peer) == b"AGGRa"
        assert transport.recv_frame(peer) == b"AGGRb"
        assert sess.send_data(b"AGGRc") is False
        assert sess.pending_count() == 1
        sess.open_pace()
        assert sess.pending_count() == 0
        assert transport.recv_frame(peer) == b"AGGRc"
    finally:
        sess.close()
        peer.close()


def test_session_multipart_parks_as_one_entry(pkg):
    """A multipart gradient consumes one credit and parks (and sheds) as
    one entry, flushed as its consecutive frames."""
    transport, _ = pkg
    sess, peer = _session_pair(transport, max_pending=1)
    try:
        sess.replenish(1)
        assert sess.begin_data_parts() is True
        sess.send_data_part([b"GRAD", b"p0"])
        sess.send_data_parts([([b"GRAD", b"p1"], None),
                              ([b"GRAD", b"p2"], None)])
        assert [transport.recv_frame(peer) for _ in range(3)] \
            == [b"GRADp0", b"GRADp1", b"GRADp2"]
        assert sess.begin_data_parts() is False  # no credit left
        sess.park_data_parts([[b"GRAD", b"old"]])
        sess.park_data_parts([[b"GRAD", b"q0"], [b"GRAD", b"q1"]])
        assert sess.pending_count() == 1
        assert sess.stats["shed_data_frames"] == 1  # the older gradient
        sess.replenish(1)
        assert [transport.recv_frame(peer) for _ in range(2)] \
            == [b"GRADq0", b"GRADq1"]
    finally:
        sess.close()
        peer.close()


def test_session_read_class_has_its_own_gate(pkg):
    """READ frames ride their own credits: a zeroed read window parks and
    sheds SUBS frames oldest-first while the DATA gate stays open."""
    transport, _ = pkg
    sess, peer = _session_pair(transport, max_pending=2)
    try:
        sess.replenish_read(0)
        for tag in (b"1", b"2", b"3"):
            assert sess.send(b"SUBS" + tag) is False
        assert sess.stats["reads_stalled"] == 3
        assert sess.stats["read_shed"] == 1
        assert sess.read_pending_count() == 2
        assert sess.send(b"GRADd") is True  # data untouched
        assert transport.recv_frame(peer) == b"GRADd"
        spent = transport.Deadline(0.0)
        assert sess.send_read(b"SUBSx", deadline=spent) is False
        assert sess.stats["read_shed"] == 2
        sess.open_read()
        assert transport.recv_frame(peer) == b"SUBS2"
        sess.reset_read()
        assert transport.recv_frame(peer) == b"SUBS3"
        assert sess.read_credits() is None
    finally:
        sess.close()
        peer.close()


def test_session_sentinel_and_race_checks(pkg):
    """Copy-on-park: a parked frame flushes the bytes handed off; a
    seeded mutation of the parked copy trips the typed error; the race
    sanitizer probes every gate helper."""
    transport, errors = pkg
    sess, peer = _session_pair(transport, sentinel=True,
                               race_sanitizer=True)
    try:
        sess.replenish(0)
        leaf = bytearray(b"\x11" * 4096)
        assert sess.send_data_segments([b"GRADhdr!", memoryview(leaf)]) \
            is False
        leaf[:] = b"\xee" * 4096
        sess.replenish(1)
        assert transport.recv_frame(peer) == b"GRADhdr!" + b"\x11" * 4096
        assert sess.stats["sentinel_checks"] == 1
        assert sess.stats["race_checks"] > 0
        assert sess.stats["race_trips"] == 0
        sess.replenish(0)
        assert sess.send_data(b"GRAD" + b"\x22" * 8) is False
        sess._pending[0] = b"GRAD" + b"\x66" * 8
        with pytest.raises(errors.BufferMutatedError, match="GRAD"):
            sess.replenish(4)
        assert sess.stats["sentinel_trips"] == 1
        with pytest.raises(errors.RaceDetectedError, match="_gate_open"):
            sess._gate_open()  # called without the session lock
        assert sess.stats["race_trips"] == 1
    finally:
        sess.close()
        peer.close()


def test_session_recv_deadline_expires_as_transport_error(pkg):
    transport, _ = pkg
    sess, peer = _session_pair(transport)
    try:
        with pytest.raises(transport.DeadlineExpired):
            sess.recv(transport.Deadline(0.05))
        assert issubclass(transport.DeadlineExpired, OSError)
        assert sess.sock.gettimeout() == pytest.approx(sess.io_timeout)
    finally:
        sess.close()
        peer.close()


def test_frame_classes_match_jax():
    assert ttransport.DATA_FRAME_KINDS == jtransport.DATA_FRAME_KINDS
    assert ttransport.READ_FRAME_KINDS == jtransport.READ_FRAME_KINDS
    assert ttransport._CONTROL_RANK == jtransport._CONTROL_RANK
    assert ttransport._NO_REPLICA == jtransport._NO_REPLICA
