"""Child processes for the tests that run the CLI's roles as processes.

``spawn`` starts a child with its stdout on a pipe and its stderr in a
temporary file, never on a pipe that nobody reads while the test waits on
something else: a child that writes more than a pipe holds (64 KiB) to
stderr blocks in that write.  A JAX server does so before its first
stdout line when XLA loads its programs from a warm persistent cache, one
AOT-loader error line of about 3 KB for each.  ``first_line`` reads the
next stdout line up to a deadline, and ``reap`` joins the children and
returns what each wrote.  Every child is reaped, also after a failed
``first_line``, which kills it first.  Each child runs in a session of
its own, so a kill takes whatever it started with it.
"""

import os
import select
import signal
import subprocess
import tempfile
import time

TIMEOUT = 60


def spawn(argv, **popen_kw):
    """Start ``argv`` with stdout on a pipe and stderr in a temporary
    file, in a session of its own."""
    err = tempfile.TemporaryFile()
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=err,
                            text=True, start_new_session=True, **popen_kw)
    proc.err_file = err
    return proc


def stderr_of(proc) -> str:
    """What the child has written to stderr so far."""
    proc.err_file.seek(0)
    return proc.err_file.read().decode(errors="replace")


def first_line(proc, prefix, timeout=TIMEOUT) -> str:
    """The child's next stdout line, stripped, which must start with
    ``prefix`` and come within ``timeout`` seconds; if it does not, the
    child is killed.  Reads the pipe a byte at a time, so what follows
    the line stays for ``reap``."""
    fd = proc.stdout.fileno()
    line = b""
    end = time.monotonic() + timeout
    while not line.endswith(b"\n"):
        left = end - time.monotonic()
        if left <= 0 or not select.select([fd], [], [], left)[0]:
            break
        byte = os.read(fd, 1)
        if not byte:  # the child closed its stdout: it has exited
            break
        line += byte
    text = line.decode(errors="replace").strip()
    came = line.endswith(b"\n") and text.startswith(prefix)
    if not came:
        _kill(proc)
        proc.wait()
    assert came, (
        f"no {prefix!r} line within {timeout} s: {text!r}, exit code "
        f"{proc.returncode}; the tail of its stderr:\n"
        f"{stderr_of(proc)[-3000:]}")
    return text


def _kill(proc):
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def reap(procs, timeout=TIMEOUT):
    """Join every child in turn, killing any that outlives ``timeout`` so
    that one wedged child leaves none of the rest unreaped:
    ``(returncode, stdout, stderr)`` for each."""
    outs = []
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            _kill(proc)
            out, _ = proc.communicate()
        outs.append((proc.returncode, out, stderr_of(proc)))
        proc.err_file.close()
    return outs
