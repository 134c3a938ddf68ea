"""The per-test time limit (`timelimit.py`, armed by the root conftest.py)
ends a test that runs too long."""

import os
import subprocess
import sys
import textwrap
import time

import pytest

_SCRIPT = textwrap.dedent("""
    import signal, sys, time
    import pytest
    from timelimit import time_limit

    def stuck_in_sleep():
        if sys.argv[1] == "native":
            # Native code never returns to the interpreter, so the SIGALRM
            # handler never runs; a blocked signal stands in for that.
            signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
        time.sleep(30)

    try:
        with time_limit(1, "tests/stuck.py::test_stuck", sys.stderr, grace_s=1):
            stuck_in_sleep()
    except pytest.fail.Exception as e:
        print(e.msg, file=sys.stderr)
        sys.exit(3)
""")


@pytest.mark.parametrize("where", ["python", "native"])
def test_time_limit_ends_a_stuck_test_with_every_stack(where):
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-c", _SCRIPT, where], capture_output=True,
                       text=True, timeout=25, cwd=os.path.dirname(__file__))
    assert time.monotonic() - t0 < 10, r.stderr
    # In Python code the test fails by name; in native code faulthandler ends
    # the process after the dump (exit status 1).
    assert r.returncode == (3 if where == "python" else 1), r.stderr
    if where == "python":
        assert "tests/stuck.py::test_stuck still running after 1 s" in r.stderr
    assert "most recent call first" in r.stderr
    assert "in stuck_in_sleep" in r.stderr
