"""Proof (de)serialization to JSON.

Counterpart: ethproof_tpu/runtime/serde.py:1. The wire format is the
counterpart's, key for key and in the same order: u64 field elements are
decimal ints, 256-bit PI words are decimal strings, bytes are hex. A proof
file written by either package is read by the other.

Every array is written as its canonical u64 values, whatever its dtype
(an int64 array holding u64 bit patterns is cast, never written signed).
`FriProof.query_indices` is not on the wire (it is re-derived by the
verifier's transcript); a decoded proof has None there, as the
counterpart's has.

One addition, a fault of the counterpart fixed here: the counterpart drops
the fixed-column (vkey) oracle's openings (`StarkOpenings.fixed_at_zeta`,
`fixed_at_gzeta`, `StarkProof.fixed_query_openings`), so a decoded proof of
any table with fixed columns (CPU, Arithmetic, BytePacking, Keccak, the
recursion machines) fails its verifier. This module writes them under
those names, after the counterpart's keys, for a table that has fixed
columns; a table without them gives the counterpart's bytes exactly. The
counterpart's reader ignores the added keys; this reader takes a file
without them as a proof without fixed openings. Arrays are read back at
their shapes (`(k, 2)` extension vectors, `(q, len, 4)` Merkle paths), so
an empty vector keeps its shape through JSON.
"""

from __future__ import annotations

import numpy as np

from ..evm.binding import KernelShape
from ..evm.contract import ContractCallProof, InnerFrameProof
from ..evm.transfer import TxProof
from ..fri.prove import FriProof, FriQueryRound
from ..recursion.block import BlockWrapProof
from ..recursion.wrap import MachineProof
from ..stark.multi import MultiProof
from ..stark.prove import StarkOpenings, StarkProof, TreeOpenings
from ..tables.all import TableSizes
from ..tables.evm import EvmShape
from ..witness.types import GenerationInputs
from .ops import AggProof, DummyProof, GeneratedBlockProof, SuccinctBlockProof

_MASK64 = (1 << 64) - 1


def _arr(a) -> list:
    """Canonical u64 values of an array (int64 bit patterns included)."""
    a = np.asarray(a)
    if a.dtype != np.uint64:
        a = a.astype(np.uint64)
    return a.tolist()


def _u64(x) -> int:
    return int(x) & _MASK64


def _words(xs) -> list:
    return [_u64(x) for x in xs]


def _unarr(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64)


def _ext(x) -> np.ndarray:
    """An extension-field vector, (k, 2), k possibly 0."""
    return _unarr(x).reshape(-1, 2)


def _paths(x) -> np.ndarray:
    """Merkle paths, (num_q, path_len, 4), path_len possibly 0."""
    return _unarr(x).reshape(len(x), -1, 4)


def _multi_to_json(m):
    return [stark_proof_to_json(sp) for sp in m.proofs] if m is not None else None


def _multi_from_json(d):
    return MultiProof(proofs=[stark_proof_from_json(x) for x in d]) if d is not None else None


def fri_proof_to_json(p: FriProof) -> dict:
    return {
        "commit_caps": [_arr(c) for c in p.commit_caps],
        "query_rounds": [
            {"leaf_values": _arr(q.leaf_values), "merkle_paths": _arr(q.merkle_paths)}
            for q in p.query_rounds
        ],
        "final_poly": _arr(p.final_poly),
        "pow_witness": _u64(p.pow_witness),
        "degree_bits": int(p.degree_bits),
    }


def fri_proof_from_json(d: dict) -> FriProof:
    return FriProof(
        commit_caps=[_unarr(c) for c in d["commit_caps"]],
        query_rounds=[
            FriQueryRound(
                _unarr(q["leaf_values"]).reshape(len(q["leaf_values"]), -1, 2),
                _paths(q["merkle_paths"]),
            )
            for q in d["query_rounds"]
        ],
        final_poly=_ext(d["final_poly"]),
        pow_witness=d["pow_witness"],
        degree_bits=d["degree_bits"],
        query_indices=None,
    )


def _tree_openings_to_json(t: TreeOpenings) -> dict:
    return {"values": _arr(t.values), "paths": _arr(t.paths)}


def _tree_openings_from_json(d) -> TreeOpenings:
    return TreeOpenings(
        values=_unarr(d["values"]).reshape(len(d["values"]), -1), paths=_paths(d["paths"])
    )


def stark_proof_to_json(p: StarkProof) -> dict:
    o = p.openings
    openings = {
        "trace_at_zeta": _arr(o.trace_at_zeta),
        "trace_at_gzeta": _arr(o.trace_at_gzeta),
        "aux_at_zeta": _arr(o.aux_at_zeta),
        "aux_at_gzeta": _arr(o.aux_at_gzeta),
        "quotient_at_zeta": _arr(o.quotient_at_zeta),
    }
    if len(o.fixed_at_zeta) or len(o.fixed_at_gzeta):
        openings["fixed_at_zeta"] = _arr(o.fixed_at_zeta)
        openings["fixed_at_gzeta"] = _arr(o.fixed_at_gzeta)
    out = {
        "degree_bits": int(p.degree_bits),
        "public_inputs": _words(p.public_inputs),
        "trace_cap": _arr(p.trace_cap),
        "aux_cap": _arr(p.aux_cap) if p.aux_cap is not None else None,
        "quotient_cap": _arr(p.quotient_cap),
        "ctl_totals": _words(p.ctl_totals),
        "openings": openings,
        "fri_proof": fri_proof_to_json(p.fri_proof),
        "trace_query_openings": _tree_openings_to_json(p.trace_query_openings),
        "aux_query_openings": (
            _tree_openings_to_json(p.aux_query_openings)
            if p.aux_query_openings is not None
            else None
        ),
        "quotient_query_openings": _tree_openings_to_json(p.quotient_query_openings),
    }
    if p.fixed_query_openings is not None:
        out["fixed_query_openings"] = _tree_openings_to_json(p.fixed_query_openings)
    return out


def stark_proof_from_json(d: dict) -> StarkProof:
    o = d["openings"]
    fixed = {}
    if "fixed_at_zeta" in o:
        fixed = dict(fixed_at_zeta=_ext(o["fixed_at_zeta"]),
                     fixed_at_gzeta=_ext(o["fixed_at_gzeta"]))
    return StarkProof(
        degree_bits=d["degree_bits"],
        public_inputs=list(d["public_inputs"]),
        trace_cap=_unarr(d["trace_cap"]),
        aux_cap=_unarr(d["aux_cap"]) if d["aux_cap"] is not None else None,
        quotient_cap=_unarr(d["quotient_cap"]),
        ctl_totals=list(d["ctl_totals"]),
        openings=StarkOpenings(
            trace_at_zeta=_ext(o["trace_at_zeta"]),
            trace_at_gzeta=_ext(o["trace_at_gzeta"]),
            aux_at_zeta=_ext(o["aux_at_zeta"]),
            aux_at_gzeta=_ext(o["aux_at_gzeta"]),
            quotient_at_zeta=_ext(o["quotient_at_zeta"]),
            **fixed,
        ),
        fri_proof=fri_proof_from_json(d["fri_proof"]),
        trace_query_openings=_tree_openings_from_json(d["trace_query_openings"]),
        aux_query_openings=(
            _tree_openings_from_json(d["aux_query_openings"])
            if d["aux_query_openings"] is not None
            else None
        ),
        quotient_query_openings=_tree_openings_from_json(d["quotient_query_openings"]),
        fixed_query_openings=(
            _tree_openings_from_json(d["fixed_query_openings"])
            if d.get("fixed_query_openings") is not None
            else None
        ),
    )


def machine_proof_to_json(mp) -> dict:
    return {
        "proof": stark_proof_to_json(mp.proof),
        "log_n": int(mp.log_n),
        "variant": int(mp.variant),
        # statement preimage: needed by parent agg provers (fleet tasks
        # ship child proofs over the wire); verifiers re-derive it
        "seam": _words(mp.seam) if mp.seam is not None else None,
        "digest": _words(mp.digest) if mp.digest is not None else None,
    }


def machine_proof_from_json(d: dict) -> MachineProof:
    return MachineProof(
        proof=stark_proof_from_json(d["proof"]),
        log_n=int(d["log_n"]),
        variant=int(d["variant"]),
        seam=[int(x) for x in d["seam"]] if d.get("seam") is not None else None,
        digest=(
            [int(x) for x in d["digest"]] if d.get("digest") is not None else None
        ),
    )


def _root_to_json(mp):
    return machine_proof_to_json(mp) if mp is not None else None


def _root_from_json(d):
    return machine_proof_from_json(d) if d is not None else None


def _kshape_to_json(sh):
    if sh is None:
        return None
    return {"levels": int(sh.levels), "node_words": int(sh.node_words)}


def _kshape_from_json(d):
    if d is None:
        return None
    return KernelShape(levels=int(d["levels"]), node_words=int(d["node_words"]))


def tx_proof_to_json(p: TxProof) -> dict:
    out = {
        "kind": "txn",
        # under recursion the multi-STARK is dropped after wrapping and
        # the succinct machine proof travels instead
        "multi": _multi_to_json(p.multi),
        "root_proof": _root_to_json(p.root_proof),
        "pi_words": [str(int(w)) for w in p.pi_words],  # 256-bit ints as strings
        "gen_inputs": p.gen_inputs.to_json(),
        "sender": p.sender.hex(),
        "recipient": p.recipient.hex(),
        "miner": p.miner.hex(),
    }
    if p.binding_shape is not None:
        out["binding_shape"] = _kshape_to_json(p.binding_shape)
    return out


def tx_proof_from_json(d: dict) -> TxProof:
    return TxProof(
        multi=_multi_from_json(d["multi"]),
        pi_words=[int(w) for w in d["pi_words"]],
        gen_inputs=GenerationInputs.from_json(d["gen_inputs"]),
        sender=bytes.fromhex(d["sender"]),
        recipient=bytes.fromhex(d["recipient"]),
        miner=bytes.fromhex(d["miner"]),
        binding_shape=_kshape_from_json(d.get("binding_shape")),
        root_proof=_root_from_json(d.get("root_proof")),
    )


def _evm_shape_to_json(sh) -> dict:
    return {
        "code_len": int(sh.code_len),
        "calldata_len": int(sh.calldata_len),
        "n_skeys": int(sh.n_skeys),
        "log_rows": int(sh.log_rows),
        "n_queries": int(sh.n_queries),
        "call_shapes": [[int(v) for v in x] for x in sh.call_shapes],
        "log_shapes": [[int(v) for v in x] for x in sh.log_shapes],
    }


def _evm_shape_from_json(d: dict) -> EvmShape:
    return EvmShape(
        code_len=int(d["code_len"]),
        calldata_len=int(d["calldata_len"]),
        n_skeys=int(d["n_skeys"]),
        log_rows=int(d["log_rows"]),
        n_queries=int(d.get("n_queries", 0)),
        call_shapes=tuple(
            tuple(int(v) for v in x) for x in d.get("call_shapes", [])
        ),
        log_shapes=tuple(tuple(x) for x in d.get("log_shapes", [])),
    )


def contract_proof_to_json(p: ContractCallProof) -> dict:
    return {
        "kind": "contract",
        "multi": _multi_to_json(p.multi),
        "root_proof": _root_to_json(p.root_proof),
        "shape": _evm_shape_to_json(p.shape),
        "machine_pi": [str(int(w)) for w in p.machine_pi],
        "gen_inputs": p.gen_inputs.to_json(),
        "sender": p.sender.hex(),
        "to": p.to.hex(),
        "miner": p.miner.hex(),
        "gas_used": int(p.gas_used),
        "binding_multi": _multi_to_json(p.binding_multi),
        "cb_pi": [str(int(w)) for w in p.cb_pi] if p.cb_pi is not None else None,
        "cb_n_slots": int(p.cb_n_slots),
        "cb_kshape": _kshape_to_json(p.cb_kshape),
        "inner_frames": [
            {
                "address": f.address.hex(),
                "shape": _evm_shape_to_json(f.shape),
                "machine_pi": [str(int(w)) for w in f.machine_pi],
                "multi": _multi_to_json(f.multi),
                "root_proof": _root_to_json(f.root_proof),
            }
            for f in (p.inner_frames or [])
        ],
    }


def _inner_frame_from_json(f: dict) -> InnerFrameProof:
    return InnerFrameProof(
        address=bytes.fromhex(f["address"]),
        shape=_evm_shape_from_json(f["shape"]),
        machine_pi=[int(w) for w in f["machine_pi"]],
        multi=_multi_from_json(f.get("multi")),
        root_proof=_root_from_json(f.get("root_proof")),
    )


def contract_proof_from_json(d: dict) -> ContractCallProof:
    return ContractCallProof(
        multi=_multi_from_json(d.get("multi")),
        shape=_evm_shape_from_json(d["shape"]),
        machine_pi=[int(w) for w in d["machine_pi"]],
        gen_inputs=GenerationInputs.from_json(d["gen_inputs"]),
        sender=bytes.fromhex(d["sender"]),
        to=bytes.fromhex(d["to"]),
        miner=bytes.fromhex(d["miner"]),
        gas_used=int(d["gas_used"]),
        root_proof=_root_from_json(d.get("root_proof")),
        binding_multi=_multi_from_json(d.get("binding_multi")),
        cb_pi=(
            [int(w) for w in d["cb_pi"]] if d.get("cb_pi") is not None else None
        ),
        cb_n_slots=int(d.get("cb_n_slots", 0)),
        cb_kshape=_kshape_from_json(d.get("cb_kshape")),
        inner_frames=[
            _inner_frame_from_json(f) for f in d.get("inner_frames", [])
        ],
    )


def aggregatable_to_json(p) -> dict:
    if isinstance(p, ContractCallProof):
        return contract_proof_to_json(p)
    if isinstance(p, AggProof):
        return {
            "kind": "agg",
            "left": aggregatable_to_json(p.left),
            "right": aggregatable_to_json(p.right),
            "txn_number_before": int(p.txn_number_before),
            "txn_number_after": int(p.txn_number_after),
            "gas_used_before": int(p.gas_used_before),
            "gas_used_after": int(p.gas_used_after),
            "state_root_before": p.state_root_before.hex(),
            "state_root_after": p.state_root_after.hex(),
        }
    if isinstance(p, DummyProof):
        return {
            "kind": "dummy",
            "gen_inputs": p.gen_inputs.to_json(),
            "root_proof": _root_to_json(p.root_proof),
        }
    return tx_proof_to_json(p)


def aggregatable_from_json(d: dict):
    kind = d["kind"]
    if kind == "agg":
        return AggProof(
            left=aggregatable_from_json(d["left"]),
            right=aggregatable_from_json(d["right"]),
            txn_number_before=d["txn_number_before"],
            txn_number_after=d["txn_number_after"],
            gas_used_before=d["gas_used_before"],
            gas_used_after=d["gas_used_after"],
            state_root_before=bytes.fromhex(d["state_root_before"]),
            state_root_after=bytes.fromhex(d["state_root_after"]),
        )
    if kind == "dummy":
        return DummyProof(
            gen_inputs=GenerationInputs.from_json(d["gen_inputs"]),
            root_proof=_root_from_json(d.get("root_proof")),
        )
    if kind == "contract":
        return contract_proof_from_json(d)
    return tx_proof_from_json(d)


def block_wrap_to_json(bw: BlockWrapProof) -> dict:
    return {
        "mp": machine_proof_to_json(bw.mp),
        "seam": _words(bw.seam),
        "digest": _words(bw.digest),
        "e_parent": _words(bw.e_parent),
        "is_base": int(bw.is_base),
    }


def block_wrap_from_json(w: dict) -> BlockWrapProof:
    return BlockWrapProof(
        mp=machine_proof_from_json(w["mp"]),
        seam=[int(x) for x in w["seam"]],
        digest=[int(x) for x in w["digest"]],
        e_parent=[int(x) for x in w["e_parent"]],
        is_base=int(w["is_base"]),
    )


def block_proof_to_json(bp: GeneratedBlockProof) -> dict:
    out = {
        "b_height": int(bp.block_number),
        "state_root_before": bp.state_root_before.hex(),
        "state_root_after": bp.state_root_after.hex(),
        "agg": aggregatable_to_json(bp.agg),
        "parent": block_proof_to_json(bp.parent) if bp.parent else None,
    }
    if bp.succinct is not None:
        s = bp.succinct
        out["succinct"] = {
            "top": machine_proof_to_json(s.top),
            "level": int(s.level),
            "sizes": vars(s.sizes) if s.sizes is not None else None,
            "wd_counts": [int(n) for n in s.wd_counts] if s.wd_counts else None,
            "evm_shapes": (
                [_evm_shape_to_json(sh) for sh in s.evm_shapes]
                if s.evm_shapes
                else None
            ),
            "binding_shape": _kshape_to_json(s.binding_shape),
            "block_wrap": (
                block_wrap_to_json(s.block_wrap) if s.block_wrap is not None else None
            ),
        }
    return out


def block_proof_from_json(d: dict) -> GeneratedBlockProof:
    succinct = None
    if d.get("succinct") is not None:
        s = d["succinct"]
        succinct = SuccinctBlockProof(
            top=machine_proof_from_json(s["top"]),
            level=int(s["level"]),
            sizes=TableSizes(**s["sizes"]) if s.get("sizes") is not None else None,
            binding_shape=_kshape_from_json(s.get("binding_shape")),
            evm_shapes=(
                [_evm_shape_from_json(e) for e in s["evm_shapes"]]
                if s.get("evm_shapes")
                else None
            ),
            block_wrap=(
                block_wrap_from_json(s["block_wrap"])
                if s.get("block_wrap") is not None
                else None
            ),
            wd_counts=(
                [int(x) for x in s["wd_counts"]] if s.get("wd_counts") else None
            ),
        )
    return GeneratedBlockProof(
        block_number=d["b_height"],
        state_root_before=bytes.fromhex(d["state_root_before"]),
        state_root_after=bytes.fromhex(d["state_root_after"]),
        agg=aggregatable_from_json(d["agg"]),
        parent=block_proof_from_json(d["parent"]) if d["parent"] else None,
        succinct=succinct,
    )
