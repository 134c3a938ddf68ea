"""The proving pipeline: map over txs, tree-fold, block step.

Counterpart: ethproof_tpu/runtime/scheduler.py:1 (`Runtime`, `tree_fold`,
`_fit_block_sizes`, `prove_block`, `_fold_machine_proofs`), with `device`
threaded through (None: the CUDA card; `prove_block` raises without one
unless the caller names the CPU). The fold is an order-preserving binary
tree over adjacent pairs, scheduled level by level.

Runtimes: `Runtime(num_workers)` runs the registry tasks in-process on
`prove_block`'s device (host threads overlap trace generation; device work
serialises); `distributed.DistributedRuntime` ships the same tasks to
worker processes, each of which runs them on its own device.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

from .. import resolve_device
from ..fri.config import StarkConfig
from ..tables.all import TableSizes
from ..witness.types import GenerationInputs
from . import ops
from .prover_state import CircuitConfig
from .tracing import logger, span


class Runtime:
    """In-memory runtime (the counterpart's --runtime in-memory).

    Transient failures retry with backoff, `max_retries` times; a
    `FatalError` aborts the job at once."""

    def __init__(self, num_workers: int = 1, max_retries: int = 2):
        self.num_workers = max(1, num_workers)
        self.max_retries = max_retries

    def _run_one(self, fn: Callable, item):
        delay = 1.0
        for attempt in range(self.max_retries + 1):
            try:
                return fn(item)
            except ops.FatalError:
                raise
            except Exception as e:
                if attempt == self.max_retries:
                    raise
                logger.warning(
                    "task failed (%s); retry %d/%d in %.0fs",
                    e, attempt + 1, self.max_retries, delay,
                )
                time.sleep(delay)
                delay *= 2

    def map(self, fn: Callable, items: Sequence):
        def one(x):
            return self._run_one(fn, x)

        if self.num_workers == 1 or len(items) <= 1:
            return [one(x) for x in items]
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            return list(pool.map(one, items))

    def run_tasks(self, tasks: Sequence, device=None):
        """Execute (op, payload) registry tasks in this process on `device`:
        the same tasks `DistributedRuntime` ships to its workers."""
        from .distributed import execute_task

        dev = resolve_device(device)
        return self.map(lambda task: execute_task(task, dev), tasks)

    def close(self) -> None:
        pass


def tree_fold(combine: Callable, leaves: List) -> object:
    """Order-preserving binary-tree fold (adjacent pairs, level by level)."""
    assert leaves, "fold over zero leaves"
    level = list(leaves)
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            nxt.append(combine(level[i], level[i + 1]))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def _fit_block_sizes(
    gen_inputs: List[GenerationInputs], circuit_config, binding_shape=None
) -> TableSizes:
    """Uniform per-block table sizes: fit the MAX demand over all real
    txs within the configured ranges. Uniformity is what lets one
    recursion ladder (one leaf vkey set) cover the whole block.

    With `binding_shape`, transfer kernels are sized for their BOUND
    form (in-circuit MPT binding adds program steps and keccak demand).
    The keccak table pair is dropped only when no tx needs it."""
    from ..evm.transfer import build_kernel, derive_pi_words, overlap_pattern
    from ..tables.all import evm_table_counts, kernel_counts

    merged: dict = {}
    with_keccak = binding_shape is not None
    for gi in gen_inputs:
        if gi.signed_txn is None:
            # withdrawal dummies prove a credit kernel (evm/withdrawal.py)
            if gi.withdrawals and binding_shape is not None:
                from ..evm.withdrawal import (
                    build_withdrawal_kernel,
                    build_withdrawal_witness,
                    expected_wd_pi,
                    wd_dummy_provable,
                )

                if wd_dummy_provable(gi, binding_shape):
                    pi = expected_wd_pi(gi)
                    bw = build_withdrawal_witness(gi, pi, binding_shape)
                    kasm = build_withdrawal_kernel(
                        len(gi.withdrawals), binding_shape, pi, bw
                    )
                    counts = kernel_counts(kasm.prog, kasm.hash_requests())
                    for k, v in counts.items():
                        merged[k] = max(merged.get(k, 1), v)
            continue
        if ops._callee_has_code(gi):
            from ..evm.contract import machine_inputs_for_tx

            frames: list = []
            shape, _, res = machine_inputs_for_tx(gi, frames_out=frames)
            counts = evm_table_counts(shape, res)
            # inner call frames prove at the same block sizes: their
            # demand joins the max
            for fr in frames:
                fc = evm_table_counts(fr.shape, fr.result)
                counts = {
                    k: max(counts.get(k, 1), fc.get(k, 1))
                    for k in set(counts) | set(fc)
                }
            with_keccak = True
        else:
            pi, s, r, m = derive_pi_words(gi)
            overlap = overlap_pattern(s, r, m)
            if binding_shape is not None:
                from ..evm.binding import build_binding_witness
                from ..evm.transfer import _binding_finals

                bw = build_binding_witness(
                    gi.tries.state_trie,
                    _binding_finals(gi, pi, s, r, m),
                    binding_shape,
                )
                kasm = build_kernel(overlap, binding_shape, pi, bw)
                counts = kernel_counts(kasm.prog, kasm.hash_requests())
            else:
                counts = kernel_counts(build_kernel(overlap).prog)
        for k, v in counts.items():
            merged[k] = max(merged.get(k, 1), v)
    return TableSizes.fit(circuit_config, merged, with_keccak=with_keccak)


def prove_block(
    gen_inputs: List[GenerationInputs],
    config: StarkConfig,
    sizes: "Optional[TableSizes | CircuitConfig]" = None,
    runtime: Optional[Runtime] = None,
    prev: Optional[ops.GeneratedBlockProof] = None,
    recursion: bool = False,
    binding_shape: Optional[object] = None,  # evm.binding.KernelShape
    block_wrap: bool = False,
    device=None,
) -> ops.GeneratedBlockProof:
    """witness payloads -> block proof, on `device` (None: the CUDA card).

    Each payload is a `tx_proof` task on `runtime` (in-process on
    `device`, or on a worker's own device), the leaves are folded with
    `agg_combine` and closed by `block_proof`. recursion=True: per-tx root
    machine proofs and the aggregation ladder's fold (`agg_machine` tasks)
    give a succinct block proof; with `block_wrap` the top proof is wrapped
    in-circuit onto the parent's wrap (proved here, on `device`).
    `binding_shape` fixes the transfer kernels' in-circuit MPT binding under
    recursion (required for every transfer when set: the root circuit
    variants embed it); None proves transfers with the host-checked
    binding."""
    dev = resolve_device(device)
    assert len(gen_inputs) >= 2, "padding guarantees >= 2 payloads"
    runtime = runtime or Runtime()
    with span("prove_block", txs=len(gen_inputs)):
        if recursion:
            if isinstance(sizes, CircuitConfig):
                sizes = _fit_block_sizes(gen_inputs, sizes, binding_shape)
            elif sizes is None:
                sizes = TableSizes()
        # pre-scan: contract-call txs register their machine shapes (and
        # withdrawal dummies their credit counts) as recursion leaf
        # variants (ordered, deduped) BEFORE any proving: every worker
        # rebuilds the identical variant set from the lists
        evm_shapes: list = []
        wd_counts: list = []
        if recursion:
            from ..evm.contract import machine_inputs_for_tx
            from ..evm.withdrawal import wd_dummy_provable

            for gi in gen_inputs:
                if gi.signed_txn is not None and ops._callee_has_code(gi):
                    shape, _, _ = machine_inputs_for_tx(gi)
                    if shape not in evm_shapes:
                        evm_shapes.append(shape)
                elif (
                    gi.signed_txn is None
                    and gi.withdrawals
                    and binding_shape is not None
                ):
                    n = len(gi.withdrawals)
                    if n not in wd_counts and wd_dummy_provable(gi, binding_shape):
                        wd_counts.append(n)
        # registry tasks, not closures: the same descriptors execute
        # in-process (Runtime) or on the worker fleet (DistributedRuntime)
        leaves = runtime.run_tasks(
            [
                ("tx_proof", dict(gi=gi, config=config, sizes=sizes,
                                  recursion=recursion,
                                  binding_shape=binding_shape,
                                  evm_shapes=evm_shapes or None,
                                  wd_counts=wd_counts or None))
                for gi in gen_inputs
            ],
            device=dev,
        )
        agg = tree_fold(ops.agg_combine, leaves)
        if not isinstance(agg, ops.AggProof):
            raise ops.FatalError("fold must end in an aggregate (>=2 leaves)")
        bp = ops.block_proof(agg, prev)
        if recursion:
            mproofs = [
                leaf.root_proof for leaf in leaves if getattr(leaf, "root_proof", None)
            ]
            if mproofs:
                with span("p_fold", leaves=len(mproofs)):
                    top, level = _fold_machine_proofs(
                        runtime, mproofs, sizes, config, evm_shapes,
                        binding_shape, wd_counts, dev,
                    )
                bp.succinct = ops.SuccinctBlockProof(
                    top=top, level=level, sizes=sizes,
                    binding_shape=binding_shape,
                    evm_shapes=evm_shapes or None,
                    wd_counts=wd_counts or None,
                )
                if block_wrap:
                    # in-circuit parent chaining: wrap the top agg proof;
                    # chain to the parent's wrap when present
                    from ..recursion.block import build_block_wraps
                    from ..recursion.state import recursion_state

                    rstate = recursion_state(
                        sizes, config, binding_shape=binding_shape,
                        evm_shapes=evm_shapes or None,
                        wd_counts=wd_counts or None, device=dev,
                    )
                    wraps = build_block_wraps(rstate.ladder, level, config)
                    parent_wrap = (
                        prev.succinct.block_wrap
                        if prev is not None and prev.succinct is not None
                        else None
                    )
                    with span("p_blockwrap"):
                        bp.succinct.block_wrap = (
                            wraps.prove_step(top, parent_wrap)
                            if parent_wrap is not None
                            else wraps.prove_base(top)
                        )
        return bp


def _fold_machine_proofs(
    runtime, leaves: List, sizes, config, evm_shapes=None,
    binding_shape=None, wd_counts=None, device=None,
):
    """Runtime-parallel balanced fold over the recursion ladder: each
    level's pairwise agg proofs are independent tasks. Pads to a power of
    two by repeating the last proof (`aggregate.fold_proofs` semantics; the
    verifier replays the padding in its digest tree)."""
    proofs = list(leaves)
    while len(proofs) & (len(proofs) - 1):
        proofs.append(proofs[-1])
    level = 0
    while len(proofs) > 1:
        level += 1
        proofs = runtime.run_tasks(
            [
                ("agg_machine", dict(level=level, left=proofs[i],
                                     right=proofs[i + 1], sizes=sizes,
                                     config=config,
                                     binding_shape=binding_shape,
                                     evm_shapes=evm_shapes or None,
                                     wd_counts=wd_counts or None))
                for i in range(0, len(proofs), 2)
            ],
            device=device,
        )
    return proofs[0], level
