"""Multi-process distributed runtime: leader/worker over authenticated TCP.

Counterpart: ethproof_tpu/runtime/distributed.py:1 (the op registry,
`execute_task`, `worker_main_loop`, `DistributedRuntime`). The leader is
the queue: workers dial it over authenticated TCP
(`multiprocessing.connection`, HMAC challenge on connect) and run a main
loop of recv(op, payload) -> execute -> send(result). Properties:

- location-transparent ops: the same REGISTRY on both sides;
- at-least-once delivery: a dropped connection requeues the task for
  another worker;
- fatal-vs-transient split: `FatalError` aborts the whole job; other
  exceptions retry up to a budget;
- single-tenant workers: one outstanding task per worker at a time.

A worker runs its tasks on the device its own process was given (the CLI's
`worker --device`, None: the CUDA card). Tasks and results cross processes
pickled, so they hold no torch tensor (a proof's arrays are numpy):
`execute_task` checks both and raises `FatalError` on a tensor, which
pickling would otherwise carry across as device memory.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from multiprocessing.connection import Client, Listener
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from .ops import FatalError
from .tracing import logger, span

Task = Tuple[str, dict]  # (op name, payload kwargs)

DEFAULT_AUTHKEY = b"ethproof"


def _authkey() -> bytes:
    return os.environ.get("ETHPROOF_AUTHKEY", "").encode() or DEFAULT_AUTHKEY


def _find_tensor(obj) -> Optional[str]:
    """The path of the first torch tensor inside `obj` (dataclasses, lists,
    tuples, dicts and attribute objects walked), or None."""
    stack = [("", obj)]
    seen = set()
    while stack:
        path, v = stack.pop()
        if v is None or isinstance(v, (bytes, str, int, float, bool, np.ndarray, np.generic)):
            continue
        if isinstance(v, torch.Tensor):
            return path or "."
        if id(v) in seen:
            continue
        seen.add(id(v))
        if isinstance(v, dict):
            stack.extend((f"{path}[{k!r}]", u) for k, u in v.items())
        elif isinstance(v, (list, tuple)):
            stack.extend((f"{path}[{i}]", u) for i, u in enumerate(v))
        elif dataclasses.is_dataclass(v):
            stack.extend((f"{path}.{f.name}", getattr(v, f.name))
                         for f in dataclasses.fields(v))
        elif hasattr(v, "__dict__"):
            stack.extend((f"{path}.{k}", u) for k, u in vars(v).items())
    return None


def _recursion_state(payload: dict, device):
    from ..recursion.state import recursion_state

    return recursion_state(
        payload["sizes"], payload["config"],
        binding_shape=payload.get("binding_shape"),
        evm_shapes=payload.get("evm_shapes"),
        wd_counts=payload.get("wd_counts"),
        device=device,
    )


# -- op registry ----------------------------------------------------------------


def _op_tx_proof(payload: dict, device):
    from . import ops

    rstate = _recursion_state(payload, device) if payload.get("recursion") else None
    return ops.tx_proof(
        payload["gi"], payload["config"], payload["sizes"], recursion=rstate,
        device=device,
    )


def _op_agg_combine(payload: dict, device):
    from . import ops

    return ops.agg_combine(payload["left"], payload["right"])


def _op_agg_machine(payload: dict, device):
    """One recursion-ladder aggregation: two child machine proofs -> one."""
    rstate = _recursion_state(payload, device)
    agg = rstate.ladder.agg(payload["level"])
    return agg.prove(payload["left"], payload["right"], payload["config"], rstate.device)


def _op_echo(payload: dict, device):
    """Test op (dispatch/retry semantics without proving)."""
    if payload.get("fatal"):
        raise FatalError(payload.get("msg", "fatal"))
    if payload.get("fail"):
        raise RuntimeError(payload.get("msg", "transient"))
    if payload.get("sleep"):
        time.sleep(payload["sleep"])
    return payload.get("value")


REGISTRY = {
    "tx_proof": _op_tx_proof,
    "agg_combine": _op_agg_combine,
    "agg_machine": _op_agg_machine,
    "echo": _op_echo,
}


def execute_task(task: Task, device=None):
    """Run one registry task on `device` (None: the CUDA card)."""
    op, payload = task
    where = _find_tensor(payload)
    if where is not None:
        raise FatalError(f"task {op}: payload holds a torch tensor at {where}")
    result = REGISTRY[op](payload, device)
    where = _find_tensor(result)
    if where is not None:
        raise FatalError(f"task {op}: result holds a torch tensor at {where}")
    return result


# -- worker side -----------------------------------------------------------------


def worker_main_loop(
    address: Tuple[str, int],
    authkey: Optional[bytes] = None,
    reconnect: int = 5,
    backoff_s: float = 5.0,
    device=None,
) -> int:
    """Dial the leader and run its tasks on `device` (None: the CUDA card)
    until it hangs up. A lost leader is redialled `reconnect` times with a
    fixed backoff (a service manager restarts the worker beyond that)."""
    dev = resolve_device(device)
    attempts = 0
    while True:
        try:
            conn = Client(address, authkey=authkey or _authkey())
        except (ConnectionError, OSError) as e:
            attempts += 1
            if attempts > reconnect:
                logger.error("worker: leader unreachable (%s); giving up", e)
                return 1
            logger.warning(
                "worker: connect failed (%s); retry %d/%d in %.0fs",
                e, attempts, reconnect, backoff_s,
            )
            time.sleep(backoff_s)
            continue
        attempts = 0
        logger.info("worker: connected to leader %s (device %s)", address, dev)
        try:
            while True:
                msg = conn.recv()
                if msg[0] == "shutdown":
                    logger.info("worker: shutdown from leader")
                    return 0
                assert msg[0] == "task", msg[0]
                _, op, payload = msg
                with span("worker_task", op=op):
                    try:
                        result = execute_task((op, payload), dev)
                        conn.send(("ok", result))
                    except FatalError as e:
                        conn.send(("fatal", str(e)))
                    except Exception as e:  # transient: the leader decides
                        logger.warning("worker: task %s failed: %r", op, e)
                        conn.send(("err", repr(e)))
        except EOFError:
            logger.info("worker: leader hung up")
            return 0
        except (ConnectionError, OSError) as e:
            logger.warning("worker: connection lost (%s); redialing", e)
        finally:
            conn.close()


# -- leader side ------------------------------------------------------------------


class DistributedRuntime:
    """Leader: accept workers, dispatch tasks, gather results in order.

    The same `run_tasks` surface as the in-memory `scheduler.Runtime`, so
    `prove_block` is runtime-agnostic."""

    def __init__(
        self,
        listen: Tuple[str, int] = ("0.0.0.0", 9041),
        authkey: Optional[bytes] = None,
        max_retries: int = 2,
    ):
        self._listener = Listener(listen, authkey=authkey or _authkey())
        self.address = self._listener.address
        self.max_retries = max_retries
        self._conns: List = []
        self._lock = threading.Condition()
        self._closed = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True
        )
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                return  # listener closed
            except Exception as e:  # auth failure etc.
                logger.warning("leader: rejected connection (%s)", e)
                continue
            with self._lock:
                self._conns.append(conn)
                self._lock.notify_all()
            logger.info(
                "leader: worker joined (%d connected)", len(self._conns)
            )

    def wait_for_workers(self, n: int, timeout: float = 300.0) -> None:
        deadline = time.time() + timeout
        with self._lock:
            while len(self._conns) < n:
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError(
                        f"only {len(self._conns)}/{n} workers joined"
                    )
                self._lock.wait(remaining)

    @property
    def num_workers(self) -> int:
        with self._lock:
            return len(self._conns)

    def _take_worker(self):
        with self._lock:
            while not self._conns:
                if self._closed:
                    raise RuntimeError("runtime closed")
                self._lock.wait(1.0)
            return self._conns.pop()

    def _return_worker(self, conn) -> None:
        with self._lock:
            self._conns.append(conn)
            self._lock.notify_all()

    def run_tasks(self, tasks: Sequence[Task], device=None) -> List:
        """Dispatch tasks to the fleet; results in task order. `device`
        names the leader's device and is not sent: each worker runs on its
        own.

        At-least-once: a worker that dies mid-task gets its task requeued.
        A task failing `max_retries` transient times, or any FatalError,
        aborts the job."""
        pending: "queue.Queue[Tuple[int, Task, int]]" = queue.Queue()
        for i, t in enumerate(tasks):
            pending.put((i, t, 0))
        results: Dict[int, object] = {}
        errors: List[BaseException] = []
        done = threading.Event()

        def dispatcher():
            active = [0]
            active_lock = threading.Lock()

            def run_on_worker(idx: int, task: Task, attempt: int):
                try:
                    try:
                        conn = self._take_worker()
                    except RuntimeError as e:
                        errors.append(e)
                        done.set()
                        return
                    try:
                        conn.send(("task", task[0], task[1]))
                        status, value = conn.recv()
                    except (EOFError, ConnectionError, OSError) as e:
                        # worker died: drop it, requeue (at-least-once)
                        logger.warning(
                            "leader: worker lost mid-task (%s); requeueing", e
                        )
                        try:
                            conn.close()
                        except OSError:
                            pass
                        pending.put((idx, task, attempt))
                        return
                    self._return_worker(conn)
                    if status == "ok":
                        results[idx] = value
                    elif status == "fatal":
                        errors.append(FatalError(value))
                        done.set()
                    else:  # transient error on the worker
                        if attempt + 1 > self.max_retries:
                            errors.append(
                                RuntimeError(
                                    f"task {task[0]}[{idx}] failed after "
                                    f"{attempt + 1} attempts: {value}"
                                )
                            )
                            done.set()
                        else:
                            pending.put((idx, task, attempt + 1))
                finally:
                    with active_lock:
                        active[0] -= 1
                    if len(results) == len(tasks):
                        done.set()

            while not done.is_set():
                try:
                    idx, task, attempt = pending.get(timeout=0.1)
                except queue.Empty:
                    with active_lock:
                        if active[0] == 0 and len(results) == len(tasks):
                            done.set()
                    continue
                with active_lock:
                    active[0] += 1
                threading.Thread(
                    target=run_on_worker, args=(idx, task, attempt), daemon=True
                ).start()

        t = threading.Thread(target=dispatcher, daemon=True)
        t.start()
        done.wait()
        if errors:
            raise errors[0]
        return [results[i] for i in range(len(tasks))]

    def map(self, fn, items: Sequence):
        raise NotImplementedError(
            "DistributedRuntime ships registry ops, not closures; "
            "use run_tasks (prove_block does)"
        )

    def close(self) -> None:
        self._closed = True
        with self._lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            try:
                conn.send(("shutdown",))
                conn.close()
            except (OSError, EOFError):
                pass
        try:
            self._listener.close()
        except OSError:
            pass
