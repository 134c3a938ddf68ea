"""Proofs as plain data: numpy u64 arrays and ints, one key per field.

`proof_to_numpy(StarkProof)` gives a dict with the fields of the JAX
package's `StarkProof` (ethproof_tpu/stark/prove.py:228), `StarkOpenings`
(:203), `TreeOpenings` (:191), `FriProof` and `FriQueryRound`
(ethproof_tpu/fri/prove.py:49-65), nested as they are there. With it a
caller can build the reference's dataclasses and run the reference
verifier on a proof made by the port. `multi_proof_to_numpy` gives one
such dict per table of a `MultiProof` (ethproof_tpu/stark/multi.py:46);
`tx_proof_to_numpy` adds the statement of a transfer's `TxProof`
(ethproof_tpu/evm/transfer.py:216): its PI words, the three parties and
the binding shape (`{"levels", "node_words"}` of its `KernelShape`, or None
for a host-checked binding). `contract_call_to_numpy` gives the fields of a
`ContractCallProof` (ethproof_tpu/evm/contract.py:87): the machine's and
the binding's multi-proofs, the inner frames', the machine's shape
(`dataclasses.asdict` of its `EvmShape`) and statement, and the binding's
statement (`cb_pi`, `cb_n_slots`, `cb_kshape` as above).
`machine_proof_to_numpy` gives the fields of a recursion `MachineProof`
(ethproof_tpu/recursion/wrap.py:34): its `StarkProof` as above, `log_n`,
`variant`, `seam` and `digest`; a transfer's or a contract call's
`root_proof` (its tx root machine proof under recursion, when `multi` is
None) is one such dict. `block_wrap_proof_to_numpy` gives the fields of a
`BlockWrapProof` (ethproof_tpu/recursion/block.py:68): its machine proof
as above and its statement preimage.
The witness is not converted: a caller rebuilds it with either package's
constructors. Uses numpy only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np


def _u64(arr) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(arr, dtype=np.uint64))


def _tree(t) -> Optional[Dict[str, np.ndarray]]:
    if t is None:
        return None
    return {"values": _u64(t.values), "paths": _u64(t.paths)}


def proof_to_numpy(proof) -> Dict[str, Any]:
    o = proof.openings
    f = proof.fri_proof
    return {
        "degree_bits": int(proof.degree_bits),
        "public_inputs": [int(x) for x in proof.public_inputs],
        "trace_cap": _u64(proof.trace_cap),
        "aux_cap": None if proof.aux_cap is None else _u64(proof.aux_cap),
        "quotient_cap": _u64(proof.quotient_cap),
        "ctl_totals": [int(x) for x in proof.ctl_totals],
        "openings": {
            name: _u64(getattr(o, name))
            for name in (
                "trace_at_zeta", "trace_at_gzeta", "aux_at_zeta", "aux_at_gzeta",
                "quotient_at_zeta", "fixed_at_zeta", "fixed_at_gzeta",
            )
        },
        "fri_proof": {
            "commit_caps": [_u64(c) for c in f.commit_caps],
            "query_rounds": [
                {"leaf_values": _u64(q.leaf_values), "merkle_paths": _u64(q.merkle_paths)}
                for q in f.query_rounds
            ],
            "final_poly": _u64(f.final_poly),
            "pow_witness": int(f.pow_witness),
            "degree_bits": int(f.degree_bits),
            "query_indices": (
                None if f.query_indices is None
                else np.asarray(f.query_indices, dtype=np.int64)),
        },
        "trace_query_openings": _tree(proof.trace_query_openings),
        "aux_query_openings": _tree(proof.aux_query_openings),
        "quotient_query_openings": _tree(proof.quotient_query_openings),
        "fixed_query_openings": _tree(proof.fixed_query_openings),
    }


def machine_proof_to_numpy(mp) -> Dict[str, Any]:
    def words(v):
        return None if v is None else [int(w) for w in v]

    return {
        "proof": proof_to_numpy(mp.proof),
        "log_n": int(mp.log_n),
        "variant": int(mp.variant),
        "seam": words(mp.seam),
        "digest": words(mp.digest),
    }


def block_wrap_proof_to_numpy(bw) -> Dict[str, Any]:
    return {
        "mp": machine_proof_to_numpy(bw.mp),
        "seam": [int(w) for w in bw.seam],
        "digest": [int(w) for w in bw.digest],
        "e_parent": [int(w) for w in bw.e_parent],
        "is_base": int(bw.is_base),
    }


def multi_proof_to_numpy(multi) -> List[Dict[str, Any]]:
    return [proof_to_numpy(p) for p in multi.proofs]


def _multi(m) -> Optional[List[Dict[str, Any]]]:
    return None if m is None else multi_proof_to_numpy(m)


def _root(mp) -> Optional[Dict[str, Any]]:
    return None if mp is None else machine_proof_to_numpy(mp)


def _kshape(shape) -> Optional[Dict[str, int]]:
    if shape is None:
        return None
    return {"levels": int(shape.levels), "node_words": int(shape.node_words)}


def tx_proof_to_numpy(tx) -> Dict[str, Any]:
    return {
        "multi": _multi(tx.multi),
        "root_proof": _root(tx.root_proof),
        "pi_words": [int(w) for w in tx.pi_words],
        "sender": bytes(tx.sender),
        "recipient": bytes(tx.recipient),
        "miner": bytes(tx.miner),
        "binding_shape": _kshape(tx.binding_shape),
    }


def contract_call_to_numpy(proof) -> Dict[str, Any]:
    return {
        "multi": _multi(proof.multi),
        "root_proof": _root(proof.root_proof),
        "shape": dataclasses.asdict(proof.shape),
        "machine_pi": [int(w) for w in proof.machine_pi],
        "sender": bytes(proof.sender),
        "to": bytes(proof.to),
        "miner": bytes(proof.miner),
        "gas_used": int(proof.gas_used),
        "binding_multi": _multi(proof.binding_multi),
        "cb_pi": None if proof.cb_pi is None else [int(w) for w in proof.cb_pi],
        "cb_n_slots": int(proof.cb_n_slots),
        "cb_kshape": _kshape(proof.cb_kshape),
        "inner_frames": [
            {"address": bytes(f.address), "shape": dataclasses.asdict(f.shape),
             "machine_pi": [int(w) for w in f.machine_pi], "multi": _multi(f.multi),
             "root_proof": _root(f.root_proof)}
            for f in proof.inner_frames or []
        ],
    }
