"""Proof JSON (runtime/serde.py): the port vs the JAX package.

Every proof type is built from a seed in the port's dataclasses, and the
reference's instance from it (through `interop` where it has a converter).
Both packages' `*_to_json` give the same JSON, key for key (compared as
`json.dumps(sort_keys=True)`, and as written for the block proof, whose
key order the CLI's stdout keeps); each package's `*_from_json` reads the
other's JSON back into equal fields; values of 2^63 and more survive.

One difference is pinned: the reference's serde drops the fixed-column
openings (`fixed_at_zeta`, `fixed_at_gzeta`, `fixed_query_openings`), so a
decoded proof of a table with fixed columns fails its verifier; the port
writes them after the reference's keys. A table without fixed columns gives
the reference's bytes exactly.
"""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from ethproof_tpu.evm import binding as jbind
from ethproof_tpu.evm import contract as jcontract
from ethproof_tpu.evm import transfer as jtr
from ethproof_tpu.recursion import block as jblock
from ethproof_tpu.recursion import wrap as jwrap
from ethproof_tpu.runtime import ops as jops
from ethproof_tpu.runtime import serde as jserde
from ethproof_tpu.stark.multi import MultiProof as JMultiProof
from ethproof_tpu.tables import all as jall
from ethproof_tpu.tables import evm as jevm
from ethproof_tpu.witness import types as jtypes
from ethproof_tpu_torch import interop
from ethproof_tpu_torch.evm import binding as tbind
from ethproof_tpu_torch.evm import contract as tcontract
from ethproof_tpu_torch.evm import transfer as ttr
from ethproof_tpu_torch.fri import prove as tfri
from ethproof_tpu_torch.recursion import block as tblock
from ethproof_tpu_torch.recursion import wrap as twrap
from ethproof_tpu_torch.runtime import ops as tops
from ethproof_tpu_torch.runtime import serde as tserde
from ethproof_tpu_torch.stark import prove as tprove
from ethproof_tpu_torch.stark.multi import MultiProof as TMultiProof
from ethproof_tpu_torch.tables import all as tall
from ethproof_tpu_torch.tables import evm as tevm
from ethproof_tpu_torch.witness import synthetic
from test_torch_stark import to_reference

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)

FIXED_OPENINGS = ("fixed_at_zeta", "fixed_at_gzeta")


# -- seeded port instances ------------------------------------------------------


class Gen:
    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def u64(self, *shape):
        """uniform u64 values: half of them 2^63 or more."""
        return self.rng.integers(0, 1 << 64, size=shape, dtype=np.uint64, endpoint=False)

    def word(self):
        return int(self.u64())

    def words(self, n):
        return [self.word() for _ in range(n)]

    def pi(self, n):
        """256-bit PI words, written as decimal strings."""
        return [int.from_bytes(self.rng.bytes(32), "big") for _ in range(n)]

    def tree(self, q, k, path_len):
        return tprove.TreeOpenings(values=self.u64(q, k), paths=self.u64(q, path_len, 4))

    def stark(self, fixed=True, aux=True, q=3):
        ext = tprove._empty_ext
        openings = tprove.StarkOpenings(
            trace_at_zeta=self.u64(4, 2), trace_at_gzeta=self.u64(4, 2),
            aux_at_zeta=self.u64(2, 2) if aux else ext(),
            aux_at_gzeta=self.u64(2, 2) if aux else ext(),
            quotient_at_zeta=self.u64(4, 2),
            **({"fixed_at_zeta": self.u64(3, 2), "fixed_at_gzeta": self.u64(3, 2)}
               if fixed else {}),
        )
        fri = tfri.FriProof(
            commit_caps=[self.u64(2, 4), self.u64(2, 4)],
            query_rounds=[tfri.FriQueryRound(self.u64(q, 4, 2), self.u64(q, 3 - r, 4))
                          for r in range(2)],
            final_poly=self.u64(4, 2), pow_witness=self.word(), degree_bits=7,
        )
        return tprove.StarkProof(
            degree_bits=5, public_inputs=self.words(4), trace_cap=self.u64(2, 4),
            aux_cap=self.u64(2, 4) if aux else None, quotient_cap=self.u64(2, 4),
            ctl_totals=self.words(2) if aux else [], openings=openings, fri_proof=fri,
            trace_query_openings=self.tree(q, 4, 5),
            aux_query_openings=self.tree(q, 2, 5) if aux else None,
            quotient_query_openings=self.tree(q, 4, 5),
            fixed_query_openings=self.tree(q, 3, 5) if fixed else None,
        )

    def multi(self, n=2):
        return TMultiProof(proofs=[self.stark(fixed=i % 2 == 0) for i in range(n)])

    def machine(self, statement=True):
        return twrap.MachineProof(
            proof=self.stark(), log_n=16, variant=int(self.rng.integers(0, 5)),
            seam=self.words(36) if statement else None,
            digest=self.words(4) if statement else None,
        )

    def shape(self):
        return tevm.EvmShape(code_len=37, calldata_len=68, n_skeys=2, log_rows=10,
                             n_queries=1, call_shapes=((0xF1, 0, 68, 32, 32),),
                             log_shapes=((3, 32),))

    def tx(self, gi, recursion=False):
        return ttr.TxProof(
            multi=None if recursion else self.multi(),
            pi_words=self.pi(5), gen_inputs=gi,
            sender=self.rng.bytes(20), recipient=self.rng.bytes(20), miner=self.rng.bytes(20),
            binding_shape=tbind.KernelShape(levels=10, node_words=20),
            root_proof=self.machine() if recursion else None,
        )

    def contract(self, gi, recursion=False):
        frame = tcontract.InnerFrameProof(
            address=self.rng.bytes(20), shape=self.shape(), machine_pi=self.pi(3),
            multi=None if recursion else self.multi(1),
            root_proof=self.machine() if recursion else None,
        )
        return tcontract.ContractCallProof(
            multi=None if recursion else self.multi(), shape=self.shape(),
            machine_pi=self.pi(6), gen_inputs=gi, sender=self.rng.bytes(20),
            to=self.rng.bytes(20), miner=self.rng.bytes(20), gas_used=51234,
            root_proof=self.machine() if recursion else None,
            binding_multi=None if recursion else self.multi(1),
            cb_pi=None if recursion else self.pi(4), cb_n_slots=0 if recursion else 2,
            cb_kshape=None if recursion else tbind.KernelShape(levels=10, node_words=20),
            inner_frames=[frame],
        )

    def block_wrap(self, is_base=1):
        return tblock.BlockWrapProof(mp=self.machine(statement=False), seam=self.words(36),
                                     digest=self.words(4), e_parent=self.words(4),
                                     is_base=is_base)


def _agg(left, right):
    return tops.AggProof(left=left, right=right, txn_number_before=3, txn_number_after=5,
                         gas_used_before=21000, gas_used_after=72468,
                         state_root_before=b"\x01" * 32, state_root_after=b"\x02" * 32)


def port_block(g, recursion):
    """A block with a transfer, a contract call and a dummy, and a parent."""
    gi = synthetic.small_transfer()
    dummy = tops.DummyProof(gen_inputs=synthetic.noop_dummy(1),
                            root_proof=g.machine() if recursion else None)
    agg = _agg(_agg(g.tx(gi, recursion), g.contract(gi, recursion)), dummy)
    parent = tops.GeneratedBlockProof(block_number=6, state_root_before=b"\x00" * 32,
                                      state_root_after=b"\x01" * 32, agg=agg)
    bp = tops.GeneratedBlockProof(block_number=7, state_root_before=b"\x01" * 32,
                                  state_root_after=b"\x02" * 32, agg=agg, parent=parent)
    if recursion:
        bp.succinct = tops.SuccinctBlockProof(
            top=g.machine(), level=2, sizes=tall.TableSizes(keccak=None),
            binding_shape=tbind.KernelShape(levels=10, node_words=20),
            evm_shapes=[g.shape()], block_wrap=g.block_wrap(is_base=0), wd_counts=[1, 2])
    return bp


# -- the reference's instances, from the port's -----------------------------------


def ref_multi(m):
    return None if m is None else JMultiProof(
        proofs=[to_reference(d) for d in interop.multi_proof_to_numpy(m)])


def ref_machine(mp):
    if mp is None:
        return None
    d = interop.machine_proof_to_numpy(mp)
    return jwrap.MachineProof(proof=to_reference(d["proof"]), log_n=d["log_n"],
                              variant=d["variant"], seam=d["seam"], digest=d["digest"])


def ref_kshape(d):
    return None if d is None else jbind.KernelShape(**d)


def ref_gi(gi):
    return jtypes.GenerationInputs.from_json(gi.to_json())


def ref_leaf(p):
    if isinstance(p, tops.AggProof):
        return jops.AggProof(**{f.name: getattr(p, f.name) for f in dataclasses.fields(p)
                                if f.name not in ("left", "right")},
                             left=ref_leaf(p.left), right=ref_leaf(p.right))
    if isinstance(p, tops.DummyProof):
        return jops.DummyProof(gen_inputs=ref_gi(p.gen_inputs), root_proof=ref_machine(p.root_proof))
    if isinstance(p, tcontract.ContractCallProof):
        d = interop.contract_call_to_numpy(p)
        return jcontract.ContractCallProof(
            multi=ref_multi(p.multi), shape=jevm.EvmShape(**d["shape"]),
            machine_pi=d["machine_pi"], gen_inputs=ref_gi(p.gen_inputs), sender=d["sender"],
            to=d["to"], miner=d["miner"], gas_used=d["gas_used"],
            root_proof=ref_machine(p.root_proof), binding_multi=ref_multi(p.binding_multi),
            cb_pi=d["cb_pi"], cb_n_slots=d["cb_n_slots"], cb_kshape=ref_kshape(d["cb_kshape"]),
            inner_frames=[jcontract.InnerFrameProof(
                address=f["address"], shape=jevm.EvmShape(**f["shape"]),
                machine_pi=f["machine_pi"], multi=ref_multi(tf.multi),
                root_proof=ref_machine(tf.root_proof))
                for f, tf in zip(d["inner_frames"], p.inner_frames)],
        )
    d = interop.tx_proof_to_numpy(p)
    return jtr.TxProof(multi=ref_multi(p.multi), pi_words=d["pi_words"],
                       gen_inputs=ref_gi(p.gen_inputs), sender=d["sender"],
                       recipient=d["recipient"], miner=d["miner"],
                       binding_shape=ref_kshape(d["binding_shape"]),
                       root_proof=ref_machine(p.root_proof))


def ref_block(bp):
    if bp is None:
        return None
    out = jops.GeneratedBlockProof(
        block_number=bp.block_number, state_root_before=bp.state_root_before,
        state_root_after=bp.state_root_after, agg=ref_leaf(bp.agg), parent=ref_block(bp.parent))
    s = bp.succinct
    if s is not None:
        w = interop.block_wrap_proof_to_numpy(s.block_wrap)
        out.succinct = jops.SuccinctBlockProof(
            top=ref_machine(s.top), level=s.level, sizes=jall.TableSizes(**vars(s.sizes)),
            binding_shape=jbind.KernelShape(s.binding_shape.levels, s.binding_shape.node_words),
            evm_shapes=[jevm.EvmShape(**dataclasses.asdict(sh)) for sh in s.evm_shapes],
            block_wrap=jblock.BlockWrapProof(
                mp=ref_machine(s.block_wrap.mp), seam=w["seam"], digest=w["digest"],
                e_parent=w["e_parent"], is_base=w["is_base"]),
            wd_counts=list(s.wd_counts))
    return out


# -- field-by-field comparison ----------------------------------------------------


def fields(o, wire=False):
    """A dataclass tree as plain data: class name and fields, arrays as
    (shape, u64 values), the witness as its JSON. `wire=True` keeps what the
    reference's format carries: no fixed-column openings, and an empty
    array without its shape (the reference reads [] back as shape (0,))."""
    if isinstance(o, np.ndarray):
        assert o.dtype == np.uint64, o.dtype
        return ("u64", "empty" if wire and o.size == 0 else o.shape, o.tolist())
    if type(o).__name__ == "GenerationInputs":
        return o.to_json()
    if dataclasses.is_dataclass(o):
        # the reference's TxProof has an `is_dummy` flag that is not on the
        # wire (always False there) and that the port's has not
        skip = {"is_dummy"}
        if wire and type(o).__name__ == "StarkOpenings":
            skip |= set(FIXED_OPENINGS)
        if wire and type(o).__name__ == "StarkProof":
            skip |= {"fixed_query_openings"}
        return (type(o).__name__, {f.name: fields(getattr(o, f.name), wire)
                                   for f in dataclasses.fields(o) if f.name not in skip})
    if isinstance(o, (list, tuple)):
        return [fields(v, wire) for v in o]
    return o


def dumps(d):
    return json.dumps(d, sort_keys=True)


def strip_fixed(d):
    """The port's JSON less the keys the reference's format does not have."""
    if isinstance(d, dict):
        out = {k: strip_fixed(v) for k, v in d.items() if k != "fixed_query_openings"}
        if "quotient_at_zeta" in out:
            for k in FIXED_OPENINGS:
                out.pop(k, None)
        return out
    if isinstance(d, list):
        return [strip_fixed(v) for v in d]
    return d


def has_negative(d):
    if isinstance(d, dict):
        return any(has_negative(v) for v in d.values())
    if isinstance(d, list):
        return any(has_negative(v) for v in d)
    return isinstance(d, int) and d < 0


# -- the tests --------------------------------------------------------------------


@pytest.mark.parametrize("fixed", [False, True], ids=["no_fixed_columns", "fixed_columns"])
@pytest.mark.parametrize("aux", [True, False], ids=["aux", "no_aux"])
def test_stark_proof_json_equals_reference(fixed, aux):
    t = Gen(1).stark(fixed=fixed, aux=aux)
    j = to_reference(interop.proof_to_numpy(t))
    t_json, j_json = tserde.stark_proof_to_json(t), jserde.stark_proof_to_json(j)
    if fixed:
        assert dumps(strip_fixed(t_json)) == dumps(j_json)
        assert t_json["fixed_query_openings"] == tserde._tree_openings_to_json(
            t.fixed_query_openings)
        assert set(t_json["openings"]) - set(j_json["openings"]) == set(FIXED_OPENINGS)
    else:
        assert dumps(t_json) == dumps(j_json)
    assert not has_negative(t_json)
    assert max(t_json["trace_cap"][0] + t_json["trace_cap"][1]) >= 1 << 63

    # the port reads both files; the reference's lacks the fixed openings
    assert fields(tserde.stark_proof_from_json(json.loads(dumps(t_json)))) == fields(t)
    assert (fields(tserde.stark_proof_from_json(json.loads(dumps(j_json))), True)
            == fields(t, True))
    # the reference reads the port's file as its own
    assert (fields(jserde.stark_proof_from_json(json.loads(dumps(t_json))), True)
            == fields(t, True))


def test_reference_serde_drops_the_fixed_openings_and_empty_shapes():
    """The reference fault: a decoded proof of a table with fixed columns
    has none of its fixed openings, and an empty opening vector (a table
    without aux columns) comes back with shape (0,) instead of (0, 2); its
    verifier requires both shapes (ethproof_tpu/stark/verify.py:130-133,
    :197). The port's round trip keeps them."""
    t = Gen(2).stark(fixed=True, aux=False)
    j = to_reference(interop.proof_to_numpy(t))
    back = jserde.stark_proof_from_json(json.loads(json.dumps(jserde.stark_proof_to_json(j))))
    assert back.fixed_query_openings is None and back.openings.fixed_at_zeta.shape == (0, 2)
    assert j.openings.fixed_at_zeta.shape == (3, 2)
    assert back.openings.aux_at_zeta.shape == (0,) and j.openings.aux_at_zeta.shape == (0, 2)
    kept = tserde.stark_proof_from_json(json.loads(json.dumps(tserde.stark_proof_to_json(t))))
    assert fields(kept) == fields(t)
    assert kept.openings.aux_at_zeta.shape == (0, 2)
    np.testing.assert_array_equal(kept.openings.fixed_at_gzeta, t.openings.fixed_at_gzeta)
    np.testing.assert_array_equal(kept.fixed_query_openings.paths, t.fixed_query_openings.paths)


def test_int64_bit_patterns_are_written_as_u64():
    """A field held as int64 (the port's tensors' dtype) is written as its
    canonical u64 value, never as a negative number."""
    t = Gen(3).stark()
    signed = copy.deepcopy(t)
    signed.trace_cap = t.trace_cap.view(np.int64)
    signed.fri_proof.query_rounds[0].merkle_paths = \
        t.fri_proof.query_rounds[0].merkle_paths.view(np.int64)
    signed.public_inputs = [int(v) for v in np.asarray(t.public_inputs, np.uint64).view(np.int64)]
    signed.fri_proof.pow_witness = int(np.uint64(t.fri_proof.pow_witness).view(np.int64))
    assert (signed.trace_cap < 0).any() and min(signed.public_inputs) < 0
    got = tserde.stark_proof_to_json(signed)
    assert dumps(got) == dumps(tserde.stark_proof_to_json(t))
    assert not has_negative(got)


def test_fri_proof_json_equals_reference_and_drops_query_indices():
    t = Gen(4).stark().fri_proof
    t.query_indices = np.arange(3, dtype=np.int64)
    j = to_reference(interop.proof_to_numpy(Gen(4).stark())).fri_proof
    t_json = tserde.fri_proof_to_json(t)
    assert dumps(t_json) == dumps(jserde.fri_proof_to_json(j))
    assert "query_indices" not in t_json
    back = tserde.fri_proof_from_json(json.loads(dumps(t_json)))
    assert back.query_indices is None
    t.query_indices = None
    assert fields(back) == fields(t)
    assert fields(jserde.fri_proof_from_json(json.loads(dumps(t_json)))) == fields(t)


@pytest.mark.parametrize("statement", [True, False])
def test_machine_proof_json_equals_reference(statement):
    t = Gen(5).machine(statement)
    j = ref_machine(t)
    t_json, j_json = tserde.machine_proof_to_json(t), jserde.machine_proof_to_json(j)
    assert dumps(strip_fixed(t_json)) == dumps(j_json)
    assert fields(tserde.machine_proof_from_json(json.loads(dumps(t_json)))) == fields(t)
    assert (fields(jserde.machine_proof_from_json(json.loads(dumps(t_json))), True)
            == fields(t, True))
    assert (fields(tserde.machine_proof_from_json(json.loads(dumps(j_json))), True)
            == fields(t, True))


@pytest.mark.parametrize("kind", ["txn", "contract", "dummy"])
@pytest.mark.parametrize("recursion", [False, True], ids=["multi", "root_proof"])
def test_leaf_json_equals_reference(kind, recursion):
    g, gi = Gen(6), synthetic.small_transfer()
    t = {"txn": lambda: g.tx(gi, recursion), "contract": lambda: g.contract(gi, recursion),
         "dummy": lambda: tops.DummyProof(
             gen_inputs=synthetic.noop_dummy(1),
             root_proof=g.machine() if recursion else None)}[kind]()
    j = ref_leaf(t)
    t_json, j_json = tserde.aggregatable_to_json(t), jserde.aggregatable_to_json(j)
    assert t_json["kind"] == kind
    assert dumps(strip_fixed(t_json)) == dumps(j_json)
    assert fields(tserde.aggregatable_from_json(json.loads(dumps(t_json)))) == fields(t)
    assert (fields(jserde.aggregatable_from_json(json.loads(dumps(t_json))), True)
            == fields(t, True))
    assert (fields(tserde.aggregatable_from_json(json.loads(dumps(j_json))), True)
            == fields(t, True))


@pytest.mark.parametrize("recursion", [False, True], ids=["aggregate", "succinct"])
def test_block_proof_json_equals_reference(recursion):
    """AggProof, the parent chain and (succinct) SuccinctBlockProof with its
    sizes, binding shape, EVM shapes, withdrawal counts and block wrap; the
    JSON as written (key order kept) equals the reference's."""
    t = port_block(Gen(7), recursion)
    j = ref_block(t)
    t_json, j_json = tserde.block_proof_to_json(t), jserde.block_proof_to_json(j)
    assert json.dumps(strip_fixed(t_json)) == json.dumps(j_json)
    assert not has_negative(t_json)
    assert fields(tserde.block_proof_from_json(json.loads(json.dumps(t_json)))) == fields(t)
    assert (fields(jserde.block_proof_from_json(json.loads(json.dumps(t_json))), True)
            == fields(t, True))
    assert (fields(tserde.block_proof_from_json(json.loads(json.dumps(j_json))), True)
            == fields(t, True))
