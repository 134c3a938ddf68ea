"""The distributed leader/worker runtime over localhost TCP
(runtime/distributed.py): tests/test_distributed.py's cases against the
port, with in-process worker threads on the CPU and one real
`python -m ethproof_tpu_torch.cli worker --device cpu` subprocess.

Results come back in task order; a fatal error aborts the job; a transient
one retries, then fails; a lost worker's task is redelivered; the worker
subprocess exits 0 at shutdown; the empty block goes through `prove_block`
over two workers (witnesses and proofs cross the wire pickled).
"""

import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from ethproof_tpu_torch.runtime.distributed import DistributedRuntime, worker_main_loop
from ethproof_tpu_torch.runtime.ops import FatalError

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn_worker_thread(addr, **kw):
    t = threading.Thread(target=worker_main_loop, args=(addr,),
                         kwargs=dict(device="cpu", **kw), daemon=True)
    t.start()
    return t


@pytest.fixture
def runtime():
    rt = DistributedRuntime(listen=("127.0.0.1", 0))
    yield rt
    rt.close()


def test_results_in_task_order(runtime):
    for _ in range(2):
        _spawn_worker_thread(runtime.address)
    runtime.wait_for_workers(2, timeout=10)
    tasks = [("echo", {"value": i}) for i in range(7)]
    assert runtime.run_tasks(tasks) == list(range(7))


def test_fatal_aborts(runtime):
    _spawn_worker_thread(runtime.address)
    runtime.wait_for_workers(1, timeout=10)
    with pytest.raises(FatalError, match="boom"):
        runtime.run_tasks([("echo", {"fatal": True, "msg": "boom"})])


def test_transient_retries_then_fails(runtime):
    _spawn_worker_thread(runtime.address)
    runtime.wait_for_workers(1, timeout=10)
    with pytest.raises(RuntimeError, match="after 3 attempts"):
        runtime.run_tasks([("echo", {"fail": True})])


def test_worker_loss_redelivers(runtime):
    """A worker that takes one task and dies without answering: its task
    is requeued to the worker that joins after it."""

    def dying_worker(addr):
        from multiprocessing.connection import Client

        from ethproof_tpu_torch.runtime.distributed import _authkey

        conn = Client(addr, authkey=_authkey())
        conn.recv()  # swallow the task
        conn.close()  # die

    threading.Thread(target=dying_worker, args=(runtime.address,), daemon=True).start()
    runtime.wait_for_workers(1, timeout=10)
    results = {}

    def run():
        results["r"] = runtime.run_tasks([("echo", {"value": 42, "sleep": 0.05})])

    t = threading.Thread(target=run, daemon=True)
    t.start()
    time.sleep(0.3)
    _spawn_worker_thread(runtime.address)
    t.join(timeout=15)
    assert not t.is_alive()
    assert results.get("r") == [42]


def test_cli_worker_subprocess(runtime):
    """`python -m ethproof_tpu_torch.cli worker --device cpu` starts, serves
    tasks and exits 0 when the leader shuts down."""
    host, port = runtime.address
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ethproof_tpu_torch.cli", "worker",
         "--leader", f"{host}:{port}", "--reconnect", "1", "--device", "cpu",
         "--persistence", "none"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    try:
        runtime.wait_for_workers(1, timeout=60)
        assert runtime.run_tasks([("echo", {"value": "hi"})]) == ["hi"]
        runtime.close()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def test_prove_block_over_workers():
    from test_torch_scheduler import T_CFG, empty_block_ir

    from ethproof_tpu_torch.runtime.ops import verify_block
    from ethproof_tpu_torch.runtime.scheduler import prove_block

    rt = DistributedRuntime(listen=("127.0.0.1", 0))
    try:
        for _ in range(2):
            _spawn_worker_thread(rt.address)
        rt.wait_for_workers(2, timeout=10)
        bp = prove_block(empty_block_ir(), T_CFG, runtime=rt, device="cpu")
        assert verify_block(bp, T_CFG, device="cpu")
    finally:
        rt.close()
