"""The helper for spawned CLI roles (``procs.py``), on planted children."""

import sys
import time

import pytest
from procs import first_line, reap, spawn

# The leftover-worker fixture (conftest.py) knows a spawned role by this
# flag in its command line: a planted child that outlives its test fails
# the test.
ROLE = "--serve"


def _child(code):
    return spawn([sys.executable, "-c", code, ROLE])


def test_first_line_comes_after_300_kb_of_stderr():
    proc = _child("import sys; sys.stderr.write('E' * 300_000 + '\\n'); "
                  "print('serving on port 1234', flush=True); "
                  "print('after the line')")
    t0 = time.monotonic()
    assert first_line(proc, "serving on port ", 20) == "serving on port 1234"
    assert time.monotonic() - t0 < 20
    (rc, out, err), = reap([proc], 20)
    assert rc == 0 and out == "after the line\n"
    assert len(err) == 300_001


def test_first_line_fails_by_its_deadline_on_a_silent_child():
    proc = _child("import sys, time; sys.stderr.write('still loading\\n'); "
                  "sys.stderr.flush(); time.sleep(600)")
    t0 = time.monotonic()
    with pytest.raises(AssertionError) as e:
        first_line(proc, "serving on port ", 2)
    assert time.monotonic() - t0 < 10
    assert "no 'serving on port ' line within 2 s" in str(e.value)
    assert "still loading" in str(e.value)
    assert proc.poll() == -9  # killed, so nothing is left behind
    (rc, _, err), = reap([proc], 1)
    assert rc == -9 and err == "still loading\n"


def test_first_line_fails_at_once_on_a_child_that_exits():
    proc = _child("import sys; sys.stderr.write('bad flag\\n'); sys.exit(2)")
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="exit code 2") as e:
        first_line(proc, "serving on port ", 30)
    assert time.monotonic() - t0 < 20
    assert "bad flag" in str(e.value)
    (rc, _, _), = reap([proc], 1)
    assert rc == 2


def test_reap_kills_a_wedged_child_and_joins_the_rest():
    wedged = _child("import time; print('up', flush=True); time.sleep(600)")
    done = _child("print('done')")
    t0 = time.monotonic()
    (rc1, out1, _), (rc2, out2, _) = reap([wedged, done], 2)
    assert time.monotonic() - t0 < 15
    assert rc1 == -9 and out1 == "up\n"
    assert rc2 == 0 and out2 == "done\n"
