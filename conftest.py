"""Settings for the CPU test tier that must be in place before tests/conftest.py.

pytest loads this file first (run it from the repository root), so the XLA
flags below are set before tests/conftest.py imports jax; that file adds
its own `--xla_force_host_platform_device_count=8` after them.
"""

import contextlib
import os
import sys

import pytest

# XLA:CPU's fusion emitters hang on the reference's jitted field inverse
# (gf.inv, one 26,385-line HLO chain of uint32 ops): on 80 elements it
# compiles in 17 s and then runs for over 100 s without ending, and so does
# every reference proof (DEEP inverts its denominators with it). With the
# emitters off the same program compiles in 19 s and runs in no time;
# backend optimization level 0 then cuts a file of reference proofs from
# 349 s to 241 s. Only code generation changes: the tests compare exact u64s.
# A value already in XLA_FLAGS wins.
_flags = os.environ.get("XLA_FLAGS", "")
for _flag in ("--xla_cpu_use_fusion_emitters=false",
              "--xla_backend_optimization_level=0"):
    if _flag.split("=")[0] not in _flags:
        _flags += " " + _flag
os.environ["XLA_FLAGS"] = _flags.strip()

_TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
sys.path.insert(0, _TESTS)

from timelimit import time_limit  # noqa: E402

# Seconds each test of tests/ that is not `slow` may take, setup and teardown
# included: half as much again as the slowest such test (315 s, six workers
# on 8 cores, cold caches), so that a test that hangs costs one failure, not
# a worker. `slow` tests (run with --runslow) take up to hours and have none.
TEST_TIME_LIMIT_S = 480

# Reference proofs that take over ~5 min each on the CPU with cold caches:
# `slow`, so that tier-1 ends well inside its clock. Node ids, or their
# prefixes up to a class.
SLOW = (
    "tests/test_arithmetic_table.py::TestDivModShiftProveVerify::test_byte_roundtrip",
    "tests/test_arithmetic_table.py::TestDivModShiftProveVerify::test_wrong_byte_rejected",
    "tests/test_arithmetic_table.py::TestDivModShiftProveVerify::test_byte_validity_forgery_rejected",
    "tests/test_evm_e2e.py::TestEvmE2E::",
    "tests/test_parallel.py::TestShardedStarkProve::test_mesh_proof_bit_identical",
    "tests/test_recursion_root.py::TestTxRoot::",
    "tests/test_transfer_e2e.py::TestTransferE2E::",
    "tests/test_transfer_e2e.py::TestTransferSevenTables::",
    "tests/test_transfer_e2e.py::TestOverlapTransfers::test_miner_is_sender_proof",
    "tests/test_transfer_e2e.py::TestDynamicSizing::test_prove_with_circuit_config",
    "tests/test_typed_tx.py::TestFeeSplit::test_1559_proof",
)

_STDERR_FD = pytest.StashKey[int]()


def pytest_configure(config):
    # A dump from a process that is about to end must reach the real stderr,
    # not the capture file that dies with it.
    capman = config.pluginmanager.getplugin("capturemanager")
    with capman.global_and_fixture_disabled() if capman else contextlib.nullcontext():
        config.stash[_STDERR_FD] = os.dup(2)


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    # First, so that tests/conftest.py's hook skips these without --runslow.
    for item in items:
        if item.nodeid.startswith(SLOW):
            item.add_marker(pytest.mark.slow)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    if "slow" in item.keywords or not str(item.path).startswith(_TESTS + os.sep):
        return (yield)
    with time_limit(TEST_TIME_LIMIT_S, item.nodeid, item.config.stash[_STDERR_FD]):
        return (yield)
