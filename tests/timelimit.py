"""A time limit for one test that holds even while the test is inside native code.

At the limit, SIGALRM fails the test by name with every thread's stack. A
test stuck in native code (an XLA execution, a torch kernel) never gets back
to the interpreter, so that handler cannot run: ``grace_s`` later,
faulthandler's own thread, which needs no interpreter lock, writes every
thread's stack to ``stream`` and ends the process. Under pytest-xdist the
controller then reports the test as crashed, by name, and starts a new
worker; without xdist the run ends there, after the dump.
"""

import contextlib
import faulthandler
import signal
import tempfile

import pytest


def _stacks():
    with tempfile.TemporaryFile("w+") as f:
        faulthandler.dump_traceback(f, all_threads=True)
        f.seek(0)
        return f.read()


@contextlib.contextmanager
def time_limit(limit_s, name, stream, grace_s=30):
    """Fail ``name`` if the block outlives ``limit_s``; end the process at
    ``limit_s + grace_s`` after dumping the stacks to ``stream`` (a file
    descriptor or a file)."""

    def expire(signum, frame):
        pytest.fail(f"{name} still running after {limit_s} s; every thread's "
                    f"stack:\n{_stacks()}", pytrace=False)

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit_s)
    faulthandler.dump_traceback_later(limit_s + grace_s, exit=True, file=stream)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
