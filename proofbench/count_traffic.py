"""Count the Arithmetic and Keccak tables' work in the program's own
transaction proofs: the source of the traffic files' mix, fill and
permutation counts.

For the seeded transfer and the seeded ERC-20 call that the program's
smoke test proves (`witness.synthetic.seeded_transfer(1000, seed=5)` and
`seeded_erc20_transfer(1000, 1000, seed=5)`), it builds each proof's
kernel or machine run on the host, as `evm.transfer.prove_transfer` and
`evm.contract.prove_contract_call` do before they prove, and prints, for
each multi-proof, the Arithmetic requests by op, the lengths of their
operands in 16-bit limbs by op, the rows they fill and the table's rows,
and the Keccak permutations and the table's rows. It proves nothing and
needs no card (about a minute on one core):

    python3 proofbench/count_traffic.py
"""

from __future__ import annotations

import collections
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_ACCOUNTS, N_HOLDERS, SEED = 1000, 1000, 5


def _limbs(v: int) -> int:
    return (v.bit_length() + 15) // 16


def _ops(requests) -> tuple:
    """-> ({op: count}, {op: {"a": {limbs: count}, "b": {limbs: count}}}):
    an operand's limbs are its 16-bit limbs up to the highest nonzero one."""
    from ethproof_tpu_torch.tables import arithmetic as ar

    names = {getattr(ar, k): k[3:] for k in dir(ar) if k.startswith("OP_")}
    by = collections.defaultdict(list)
    for r in requests:
        by[names[r[0]]].append(r)
    counts = {op: len(rs) for op, rs in sorted(by.items())}
    limbs = {op: {side: {str(k): n for k, n in sorted(collections.Counter(
        _limbs(r[i]) for r in rs).items())} for side, i in (("a", 1), ("b", 2))}
        for op, rs in sorted(by.items())}
    return counts, limbs


def _entry(arith_requests, arith_log, perms, keccak_log) -> dict:
    ops, limbs = _ops(arith_requests)
    return {"arithmetic": {"ops": ops, "operand_limbs": limbs, "rows": len(arith_requests),
                           "table_rows": 1 << arith_log},
            "keccak": {"permutations": perms, "rows": 24 * perms,
                       "table_rows": None if keccak_log is None else 1 << keccak_log}}


def _blocks(hash_requests) -> int:
    from ethproof_tpu_torch.tables.keccak_sponge import RATE_BYTES

    return sum(len(r.message) // RATE_BYTES + 1 for r in hash_requests)


def _kernel_run(kasm, fitted, pi):
    from ethproof_tpu_torch.tables.cpu import execute

    return execute(kasm.prog, pi, 1 << fitted.cpu, kasm.witness)


def transfer() -> dict:
    from ethproof_tpu_torch.evm import transfer as tf
    from ethproof_tpu_torch.evm.binding import PRODUCTION_SHAPE
    from ethproof_tpu_torch.runtime.prover_state import CircuitConfig
    from ethproof_tpu_torch.tables.all import TableSizes, kernel_counts
    from ethproof_tpu_torch.witness import synthetic

    gi = synthetic.seeded_transfer(N_ACCOUNTS, seed=SEED)
    pi, sender, recipient, miner = tf.derive_pi_words(gi)
    bw = tf.build_binding_witness(gi.tries.state_trie,
                                  tf._binding_finals(gi, pi, sender, recipient, miner),
                                  PRODUCTION_SHAPE)
    kasm = tf.build_kernel(tf.overlap_pattern(sender, recipient, miner), PRODUCTION_SHAPE, pi, bw)
    fitted = TableSizes.fit(CircuitConfig(), kernel_counts(kasm.prog, kasm.hash_requests()))
    res = _kernel_run(kasm, fitted, pi)
    return _entry(res.arith_requests, fitted.arithmetic, _blocks(kasm.hash_requests()),
                  fitted.keccak)


def erc20() -> dict:
    from ethproof_tpu_torch.evm import cbinding as CB
    from ethproof_tpu_torch.evm import contract as ct
    from ethproof_tpu_torch.evm.binding import PRODUCTION_SHAPE
    from ethproof_tpu_torch.evm.tx import decode_tx
    from ethproof_tpu_torch.tables.all import evm_table_counts, kernel_counts
    from ethproof_tpu_torch.witness import synthetic

    gi = synthetic.seeded_erc20_transfer(N_ACCOUNTS, N_HOLDERS, seed=SEED)
    frames = []
    shape, _, res = ct.machine_inputs_for_tx(gi, frames_out=frames)
    counts = evm_table_counts(shape, res)
    machine = _entry(res.arith_requests, 16, _blocks(res.hash_requests),
                     max(5, (counts["keccak"] - 1).bit_length()))
    tx = decode_tx(gi.signed_txn)
    miner = gi.block_metadata.block_beneficiary
    gas_used = gi.gas_used_after - gi.gas_used_before
    pi = CB.expected_cb_pi(gi, res.pi_words, shape, tx.sender(), tx.to, miner, gas_used)
    bw = CB.build_contract_binding_witness(gi, res.pi_words, shape, tx.sender(), tx.to, miner,
                                           pi, PRODUCTION_SHAPE)
    kasm = CB.build_contract_kernel(len(bw.slots), PRODUCTION_SHAPE, pi, bw)
    fitted = ct._binding_table_sizes(kernel_counts(kasm.prog, kasm.hash_requests()))
    bres = _kernel_run(kasm, fitted, pi)
    binding = _entry(bres.arith_requests, fitted.arithmetic, _blocks(kasm.hash_requests()),
                     fitted.keccak)
    return {"machine": machine, "binding": binding, "inner_frames": len(frames)}


def main() -> None:
    print(json.dumps({"transfer": transfer(), "erc20": erc20()}, indent=1))


if __name__ == "__main__":
    main()
