"""The recursion ladder: the port vs the JAX package.

Tx roots, the no-op dummy root, the aggregation circuits and the block
wraps, held against `ethproof_tpu/recursion/{root,aggregate,block}.py` on
the same inputs with exact u64 equality: circuits gate for gate through
`circuit_to_arrays`, witness streams and `interpret` values value for
value, and every host mirror of a statement. The fixtures are the
reference tests': the succinct configuration TINY and the CPU tier's
five-table sizes (tests/test_succinct_block.py:42-53), the block-wrap
tests' statement-leaf circuit under their CFG (tests/test_block_wrap.py:
33-65), and the tamper cases of tests/test_recursion_root.py and
tests/test_dummy_proofs.py.

Where the reference's compiler needs a child's vkey, it gets the port's
(`fixed_cap` of `ethproof_tpu.stark.prove` patched for the test; no file
of the JAX package changes), after `test_vkey_cap_equals_reference` has
held the two equal on the Memory table (the reference's commit on XLA:CPU
is ~20 s there, and minutes for a machine's 75 fixed columns). The block
wraps verify a 2^15-row agg machine whose vkey takes minutes of plain
Poseidon on the CPU in either package, so both compilers are given the
same stand-in cap for it. Machine proofs of roots, aggregations and
blocks (2^15-2^16 rows: hours on the CPU) are `slow`, as the reference's
are (tests/test_succinct_block.py:36-51).
"""

import copy
import dataclasses
import hashlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
from ethproof_tpu.evm import transfer as jtr
from ethproof_tpu.fri.config import FriConfig as JFriConfig
from ethproof_tpu.fri.config import StarkConfig as JStarkConfig
from ethproof_tpu.recursion import aggregate as jagg
from ethproof_tpu.recursion import block as jblock
from ethproof_tpu.recursion import circuit as jc
from ethproof_tpu.recursion import machine as jm
from ethproof_tpu.recursion import root as jroot
from ethproof_tpu.recursion import state as jstate
from ethproof_tpu.recursion import verifier_circuit as jvc
from ethproof_tpu.recursion import wrap as jw
from ethproof_tpu.stark import prove as jprove
from ethproof_tpu.stark.multi import MultiProof as JMultiProof
from ethproof_tpu.tables import memory as jmem
from ethproof_tpu.tables.all import TableSizes as JTableSizes
from ethproof_tpu.tables.cpu import pi_limbs as j_pi_limbs
from ethproof_tpu.witness.types import GenerationInputs as JGenerationInputs
from ethproof_tpu_torch.evm import transfer as ttr
from ethproof_tpu_torch.fri.config import FriConfig as TFriConfig
from ethproof_tpu_torch.fri.config import StarkConfig as TStarkConfig
from ethproof_tpu_torch.interop import machine_proof_to_numpy, multi_proof_to_numpy
from ethproof_tpu_torch.recursion import aggregate as tagg
from ethproof_tpu_torch.recursion import block as tblock
from ethproof_tpu_torch.recursion import circuit as tc
from ethproof_tpu_torch.recursion import machine as tm
from ethproof_tpu_torch.recursion import persist as tpersist
from ethproof_tpu_torch.recursion import root as troot
from ethproof_tpu_torch.recursion import state as tstate
from ethproof_tpu_torch.recursion import verifier_circuit as tvc
from ethproof_tpu_torch.recursion import wrap as tw
from ethproof_tpu_torch.runtime import ops as tops
from ethproof_tpu_torch.stark import prove as tprove
from ethproof_tpu_torch.tables import memory as tmem
from ethproof_tpu_torch.tables.all import TableSizes as TTableSizes
from ethproof_tpu_torch.tables.cpu import pi_limbs as t_pi_limbs
from ethproof_tpu_torch.witness import synthetic
from test_torch_fixes import fixed_reference  # noqa: F401  (a fixture)
from test_torch_stark import to_reference

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)

P = tc.P
# tests/test_succinct_block.py's configuration and sizes
TINY_KW = dict(rate_bits=2, cap_height=0, proof_of_work_bits=0, num_query_rounds=1,
               arity_bits=3, final_poly_bits=3)
J_TINY = JStarkConfig(num_challenges=1, fri_config=JFriConfig(**TINY_KW))
T_TINY = TStarkConfig(num_challenges=1, fri_config=TFriConfig(**TINY_KW))
SIZES_KW = dict(cpu=5, arithmetic=6, logic=4, bytepacking=9, memory=7, keccak=None)
J_SIZES = JTableSizes(**SIZES_KW)
T_SIZES = TTableSizes(**SIZES_KW)
# tests/test_block_wrap.py's configuration
W_KW = dict(rate_bits=2, cap_height=1, proof_of_work_bits=2, num_query_rounds=3,
            arity_bits=2, final_poly_bits=2)
J_CFG = JStarkConfig(num_challenges=1, fri_config=JFriConfig(**W_KW))
T_CFG = TStarkConfig(num_challenges=1, fri_config=TFriConfig(**W_KW))


def assert_circuits_equal(got, want):
    a, b = tc.circuit_to_arrays(got), jc.circuit_to_arrays(want)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def port_cap(stark, n, config):
    """The reference's `fixed_cap` signature, computed by the port on the CPU."""
    return tprove.fixed_cap(stark, n, config, "cpu")


@pytest.fixture
def port_caps(monkeypatch):
    monkeypatch.setattr(jprove, "fixed_cap", port_cap)


def stand_in_cap(stark, n, config, device=None):
    """A deterministic (4, 2^cap_height) cap that is not a commitment: the
    digest of the circuit's gate arrays and n, for compilers that only
    embed a child's vkey as constants."""
    mod = tc if isinstance(stark, tm.RecursionStark) else jc
    h = hashlib.sha256(repr(n).encode())
    for k, v in sorted(mod.circuit_to_arrays(stark.circuit).items()):
        h.update(k.encode() + np.ascontiguousarray(v).tobytes())
    words = np.frombuffer(h.digest() * 2, dtype=np.uint64) % np.uint64(P)
    return words[: 4 << config.fri_config.cap_height].reshape(4, -1)


# -- host mirrors of the statements -------------------------------------------


def seam_of(i):
    """tests/test_block_wrap.py's `_seam`."""
    return [i, i + 1, 100 * i, 100 * (i + 1)] + [i] * 16 + [i + 1] * 16


def chained_parts(k):
    return [(seam_of(i), [i + 10] * 4) for i in range(k)]


MIRRORS = {
    "tx_statement_digest": lambda m: m["root"].tx_statement_digest(list(range(208))),
    "leaf_statement": lambda m: m["root"].leaf_statement(seam_of(3), [7, 8, 9, P - 1]),
    "dummy_statement_digest": lambda m: (m["root"].DUMMY_TAG,
                                         m["root"].dummy_statement_digest()),
    "combine_digests": lambda m: m["agg"].combine_digests([1, 2, 3, 4], [5, 6, 7, P - 1]),
    "chain_seams": lambda m: [m["agg"].chain_seams(seam_of(1), seam_of(2), pad)
                              for pad in (False, True)],
    "seams_chain": lambda m: [m["agg"].seams_chain(seam_of(a), seam_of(b))
                              for a, b in ((1, 2), (1, 3), (2, 1))],
    "expected_statement": lambda m: [m["agg"].expected_statement(chained_parts(k))
                                     for k in (1, 2, 3, 4, 5)],
    "expected_statement_broken": lambda m: m["agg"].expected_statement(
        chained_parts(2) + [(seam_of(7), [1] * 4)]),
    "block_statement": lambda m: [m["block"].block_statement(seam_of(0), [1] * 4, [0] * 4,
                                                             [5] * 8, base)
                                  for base in (0, 1)],
}
PORT = {"root": troot, "agg": tagg, "block": tblock}
REF = {"root": jroot, "agg": jagg, "block": jblock}


@pytest.mark.parametrize("name", sorted(MIRRORS))
def test_host_mirror_equals_reference(name):
    assert MIRRORS[name](PORT) == MIRRORS[name](REF)


def test_expected_statement_padding_and_broken_chain():
    """Three leaves pad to four by repeating the last (its pair keeps the
    left seam); a broken seam anywhere gives None."""
    parts = chained_parts(3)
    top = tagg.expected_statement(parts)
    l01 = (tagg.chain_seams(parts[0][0], parts[1][0], False),
           tagg.combine_digests(parts[0][1], parts[1][1]))
    l22 = (parts[2][0], tagg.combine_digests(parts[2][1], parts[2][1]))
    assert top == (tagg.chain_seams(l01[0], l22[0], False),
                   tagg.combine_digests(l01[1], l22[1]))
    assert top[0][:4] == [0, 3, 0, 300]
    assert tagg.expected_statement(chained_parts(2) + [(seam_of(7), [1] * 4)]) is None
    assert jagg.expected_statement(chained_parts(2) + [(seam_of(7), [1] * 4)]) is None


@pytest.mark.parametrize("kind", ["tx", "dummy"])
def test_seams_equal_reference(kind):
    gis = synthetic.transfer_chain(2) + [synthetic.noop_dummy(2)]
    for gi in gis:
        j_gi = JGenerationInputs.from_json(gi.to_json())
        f = f"{kind}_seam"
        assert getattr(troot, f)(gi) == getattr(jroot, f)(j_gi)


def test_witness_fixtures_equal_the_reference_tests():
    from test_succinct_block import make_transfer_chain

    assert [g.to_json() for g in synthetic.transfer_chain(3)] == [
        g.to_json() for g in make_transfer_chain(3)]
    assert synthetic.noop_dummy(2).tries.state_trie.hash() == \
        make_transfer_chain(3)[2].tries.state_trie.hash()


# -- vkeys and the disk caches -------------------------------------------------


def test_vkey_cap_equals_reference(monkeypatch):
    """The port's `fixed_cap` against the reference's own (its commit on
    XLA:CPU) on the Memory table at 2^7 rows under TINY."""
    from ethproof_tpu.gf import field as jgf

    monkeypatch.setattr(jgf, "_inv_jit", jgf._inv_impl)
    want = jprove.fixed_cap(jmem.MemoryStark(), 128, J_TINY)
    np.testing.assert_array_equal(tprove.fixed_cap(tmem.MemoryStark(), 128, T_TINY, "cpu"), want)


def test_vkey_disk_cache(tmp_path, monkeypatch):
    """With an artifact dir the cap is written once, keyed by the fixed
    columns' bytes, and read back by a fresh stark without committing; a
    corrupt file is rebuilt; without one nothing is written."""
    monkeypatch.setenv("ETHPROOF_ARTIFACT_DIR", str(tmp_path))
    want = tprove.fixed_cap(tmem.MemoryStark(), 32, T_TINY, "cpu")
    files = list(tmp_path.glob("vkcap_*.npy"))
    assert len(files) == 1 and not list(tmp_path.glob("*.tmp*"))

    def no_commit(*args, **kwargs):
        raise AssertionError("committed although the disk cache holds the cap")

    monkeypatch.setattr(tprove, "fixed_commitment", no_commit)
    np.testing.assert_array_equal(tprove.fixed_cap(tmem.MemoryStark(), 32, T_TINY, "cpu"), want)
    monkeypatch.undo()
    monkeypatch.setenv("ETHPROOF_ARTIFACT_DIR", str(tmp_path))
    files[0].write_bytes(b"garbage")
    np.testing.assert_array_equal(tprove.fixed_cap(tmem.MemoryStark(), 32, T_TINY, "cpu"), want)
    np.testing.assert_array_equal(np.load(files[0]), want)
    monkeypatch.delenv("ETHPROOF_ARTIFACT_DIR")
    tprove.fixed_cap(tmem.MemoryStark(), 64, T_TINY, "cpu")
    assert len(list(tmp_path.iterdir())) == 1


def test_vkey_reuses_a_committed_oracle(monkeypatch):
    """A cap after a full fixed commitment of the same size reads it, on
    another device argument too: one circuit's fixed columns are committed
    once in a process."""
    monkeypatch.delenv("ETHPROOF_ARTIFACT_DIR", raising=False)
    stark = tmem.MemoryStark()
    cm = tprove.fixed_commitment(stark, 32, T_TINY, "cpu")
    monkeypatch.setattr(tprove, "fixed_commitment", None)
    assert tprove.fixed_cap(stark, 32, T_TINY, None) is cm.cap


def toy_circuit():
    """tests/test_persist.py's `_toy_circuit`, on the port's builder."""
    b = tc.CBuilder()
    x = b.wit("x")
    inv = b.inverse(x)
    b.decompose_bits(x, 8)
    e = b.ext_wit("e")
    b.ext_inverse(e)
    h = b.poseidon([x, inv] + [b.const(0)] * 10)
    for k in range(4):
        b.expose(h[k], k)
    return b.build()


def test_persist_round_trip_corrupt_and_no_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("ETHPROOF_ARTIFACT_DIR", str(tmp_path))
    c = toy_circuit()
    path = tpersist.circ_path("test", ("k",))
    assert path is not None and str(tmp_path) in path
    tpersist.save_circuit(path, c, {"log_n": 9})
    c2, ex = tpersist.load_circuit(path)
    assert int(ex["log_n"]) == 9
    assert_circuits_equal(c2, jc.circuit_from_arrays(tc.circuit_to_arrays(c)))
    s1, s2 = tm.RecursionStark(c), tm.RecursionStark(c2)
    np.testing.assert_array_equal(s1.fixed_columns(64), s2.fixed_columns(64))
    bad = tpersist.circ_path("test", ("k2",))
    with open(bad, "wb") as f:
        f.write(b"garbage")
    assert tpersist.load_circuit(bad) is None
    monkeypatch.delenv("ETHPROOF_ARTIFACT_DIR")
    assert tpersist.circ_path("test", ("k",)) is None
    tpersist.save_circuit(None, c, {})
    assert tpersist.load_circuit(None) is None
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [path.split("/")[-1], bad.split("/")[-1]])


def test_circuit_salt_digests_the_port_sources():
    """The port's salt digests its own circuit modules, so a circuit the
    JAX package wrote under the same key is never read."""
    from ethproof_tpu.recursion import persist as jpersist

    h = hashlib.sha256()
    for mod in (tc, tm, tvc, troot, tagg, tblock):
        with open(mod.__file__, "rb") as f:
            h.update(f.read())
    assert tpersist.circuit_salt() == h.hexdigest()[:16]
    assert tpersist.circuit_salt() != jpersist.circuit_salt()


# -- the recursion state's variant registry ------------------------------------------


def test_variant_indices_follow_the_reference():
    """Overlaps, then EVM shapes, then the no-op dummy, then withdrawal
    counts, for the same lists (no circuit is built)."""
    kw = dict(overlaps=list(tstate.OVERLAP_VARIANTS), evm_shapes=["e0", "e1"],
              wd_counts=[1, 3])
    t = tstate.RecursionState(sizes=T_SIZES, config=T_TINY, **kw)
    j = jstate.RecursionState(sizes=J_SIZES, config=J_TINY, **kw)
    assert tstate.OVERLAP_VARIANTS == jstate.OVERLAP_VARIANTS
    for mod_state in (t, j):
        assert [mod_state.variant_of(o) for o in tstate.OVERLAP_VARIANTS] == [0, 1, 2, 3, 4]
        assert [mod_state.variant_of_evm(s) for s in ("e0", "e1")] == [5, 6]
        assert mod_state.variant_of_dummy() == 7
        assert [mod_state.variant_of_wd(n) for n in (1, 3)] == [8, 9]


def test_default_overlaps_fit_the_cpu_table(port_caps):
    """The reference registers all five overlap variants whatever the sizes;
    at its own succinct fixture (cpu = 2^5) the s_eq_r kernel has 33
    instructions and its root cannot be built (ROADMAP Queue 3). The port's
    default keeps the variants whose kernel fits: here the distinct one."""
    assert [len(jtr.transfer_cpu_stark(o).program) for o in jstate.OVERLAP_VARIANTS] == [
        31, 33, 33, 33, 35]
    with pytest.raises(AssertionError):
        jroot.build_tx_root(jtr.transfer_cpu_stark(jtr.OVERLAP_S_EQ_R), J_SIZES, J_TINY)
    assert tstate.fitting_overlaps(T_SIZES) == [ttr.OVERLAP_DISTINCT]
    assert tstate.fitting_overlaps(dataclasses.replace(T_SIZES, cpu=6)) == \
        tstate.OVERLAP_VARIANTS
    st = tstate.recursion_state(T_SIZES, T_TINY, device="cpu")
    assert st.overlaps == [ttr.OVERLAP_DISTINCT] and st.variant_of_dummy() == 1


# -- the no-op dummy root ----------------------------------------------------------


class Fill:
    def __init__(self, seam):
        self.seam = seam


def test_dummy_root_equals_reference():
    got, want = troot.build_dummy_root(T_TINY), jroot.build_dummy_root(J_TINY)
    assert_circuits_equal(got.stark.circuit, want.stark.circuit)
    assert got.log_n == want.log_n
    seam = troot.dummy_seam(synthetic.withdrawal_dummy())
    pis = troot.leaf_statement(seam, troot.dummy_statement_digest())
    stream = got.vc.stream(Fill(seam))
    assert stream == want.vc.stream(Fill(seam))
    assert tc.interpret(got.stark.circuit, stream, pis, check=True) == jc.interpret(
        want.stark.circuit, stream, pis, check=True)


@pytest.mark.parametrize("tamper", ["root_change", "txn_increment"])
def test_dummy_root_refuses(tamper):
    """tests/test_dummy_proofs.py's cases: a no-op dummy claiming another
    post root, or advancing the txn number."""
    root = troot.build_dummy_root(T_TINY)
    gi = synthetic.withdrawal_dummy(tamper_root=tamper == "root_change")
    seam = troot.dummy_seam(gi)
    if tamper == "txn_increment":
        seam[1] += 1
    pis = troot.leaf_statement(seam, troot.dummy_statement_digest())
    with pytest.raises(AssertionError):
        tc.interpret(root.stark.circuit, root.vc.stream(Fill(seam)), pis, check=True)


# -- the transfer root at the succinct fixture ------------------------------------------


def root_statement(gi, proof):
    return troot.tx_seam(gi), troot.tx_statement_digest(t_pi_limbs(proof.pi_words))


def j_multi(multi):
    return JMultiProof(proofs=[to_reference(p) for p in multi_proof_to_numpy(multi)])


def _wrong_statement(seam, multi):
    return seam, multi, True


def _txn_increment(seam, multi):
    seam = list(seam)
    seam[1] += 1
    return seam, multi, False


def _seam_root(seam, multi):
    seam = list(seam)
    seam[20] ^= 1  # first limb of root_post
    return seam, multi, False


def _table_opening(seam, multi):
    bad = copy.deepcopy(multi)
    o = bad.proofs[0].openings.trace_at_zeta
    o[0][0] = (int(o[0][0]) + 1) % P
    return seam, bad, False


def _ctl(seam, multi):
    bad = copy.deepcopy(multi)
    bad.proofs[0].aux_cap, bad.proofs[1].aux_cap = bad.proofs[1].aux_cap, bad.proofs[0].aux_cap
    return seam, bad, False


ROOT_TAMPERS = (_wrong_statement, _txn_increment, _seam_root, _table_opening, _ctl)


def test_tx_root_equals_reference_and_refuses_tampers(port_caps):
    """The distinct-overlap transfer root at the succinct fixture, gate for
    gate. Its witness stream over the port's proof of the chain's first
    transfer (TINY, on the CPU, binding None as the recursion state's)
    equals the reference root's over the same proof in the reference's
    dataclasses; `interpret` gives the same values and accepts; the
    statement's host mirrors agree on the reference's witness. Then
    tests/test_recursion_root.py's cases, refused by the port's
    `interpret`: a wrong statement, a broken txn increment, a changed seam
    root, a tampered table opening, swapped aux caps (the CTL products).
    (One test: its transfer proof is ~40 s of the CPU plain path, which
    the suite's workers would each repeat for a test of their own.)"""
    t_root = troot.build_tx_root(ttr.transfer_cpu_stark(ttr.OVERLAP_DISTINCT), T_SIZES, T_TINY,
                                 device="cpu")
    j_root = jroot.build_tx_root(jtr.transfer_cpu_stark(jtr.OVERLAP_DISTINCT), J_SIZES, J_TINY)
    assert_circuits_equal(t_root.stark.circuit, j_root.stark.circuit)
    assert (t_root.log_n, t_root.seam_root_slices) == (j_root.log_n, j_root.seam_root_slices)
    assert t_root.log_n == 16 and len(t_root.stark.circuit.gates) == 196098
    assert t_root.stark.num_rows == j_root.stark.num_rows

    torch.set_num_threads(4)
    try:
        gi = synthetic.transfer_chain(2)[0]
        proof = ttr.prove_transfer(gi, T_TINY, T_SIZES, binding=None, device="cpu")
    finally:
        torch.set_num_threads(1)
    seam, digest = root_statement(gi, proof)
    j_gi = JGenerationInputs.from_json(gi.to_json())
    assert (seam, digest) == (jroot.tx_seam(j_gi),
                              jroot.tx_statement_digest(j_pi_limbs(proof.pi_words)))
    stream = t_root.vc.stream(troot._RootFill(multi=proof.multi, seam=seam))
    assert stream == j_root.vc.stream(jroot._RootFill(multi=j_multi(proof.multi), seam=seam))
    pis = troot.leaf_statement(seam, digest)
    assert tc.interpret(t_root.stark.circuit, stream, pis, check=True) == jc.interpret(
        j_root.stark.circuit, stream, pis, check=True)

    for tamper in ROOT_TAMPERS:
        bad_seam, multi, flip = tamper(seam, proof.multi)
        bad_pis = troot.leaf_statement(bad_seam, digest)
        if flip:
            bad_pis = [bad_pis[0] ^ 1] + bad_pis[1:]
        bad_stream = t_root.vc.stream(troot._RootFill(multi=multi, seam=bad_seam))
        with pytest.raises(AssertionError):
            tc.interpret(t_root.stark.circuit, bad_stream, bad_pis, check=True)


def test_leaves_are_proved_at_the_common_degree(monkeypatch):
    """The agg circuit verifies every leaf at the state's common degree. The
    reference's `tx_proof` proves a no-op dummy made before the ladder
    exists at the dummy circuit's own degree (2^8, not the transfer roots'
    2^16: ROADMAP Queue 3); the port's fixes the common degree first. Both
    provers are stopped before proving; the transfer root is a stand-in of
    degree 16 (building it is the test above's work)."""
    from ethproof_tpu.runtime import ops as jops

    class Stop(Exception):
        pass

    seen = {}

    def record(name):
        def prove(self, seam, config, *args, **kwargs):
            seen[name] = self.log_n
            raise Stop

        return prove

    monkeypatch.setattr(troot.DummyRootCircuit, "prove", record("port"))
    monkeypatch.setattr(jroot.DummyRootCircuit, "prove", record("ref"))
    stand_in = SimpleNamespace(log_n=16)
    t_state = tstate.RecursionState(sizes=T_SIZES, config=T_TINY, overlaps=[ttr.OVERLAP_DISTINCT],
                                    roots={ttr.OVERLAP_DISTINCT: stand_in}, device="cpu")
    j_state = jstate.RecursionState(sizes=J_SIZES, config=J_TINY, overlaps=[jtr.OVERLAP_DISTINCT],
                                    roots={jtr.OVERLAP_DISTINCT: stand_in})
    gi = synthetic.noop_dummy(2)
    with pytest.raises(Stop):
        tops.tx_proof(gi, T_TINY, T_SIZES, recursion=t_state, device="cpu")
    with pytest.raises(Stop):
        jops.tx_proof(JGenerationInputs.from_json(gi.to_json()), J_TINY, J_SIZES,
                      recursion=j_state)
    assert seen == {"port": 16, "ref": 8}
    assert t_state.root_log_n == 16 and t_state.dummy_root().log_n == 16


# -- aggregation over tests/test_block_wrap.py's statement-leaf circuit ----------------------


def statement_leaf_circuit(mod, vc_mod, extra=0):
    """tests/test_block_wrap.py's `_statement_leaf_circuit` (`extra` more
    assertions give a second leaf variant: other fixed columns, the same
    degree)."""
    b = mod.CBuilder()
    ins = [b.wit(f"s{i}") for i in range(troot.SEAM_WORDS + 4)]
    for _ in range(extra):
        b.assert_eq(ins[0], ins[0])
    out = vc_mod.sponge_hash(b, ins, 4)
    for k in range(4):
        b.expose(out[k], k)
    return b.build()


def j_machine(mp):
    d = machine_proof_to_numpy(mp)
    return jw.MachineProof(proof=to_reference(d["proof"]), log_n=d["log_n"],
                           variant=d["variant"], seam=d["seam"], digest=d["digest"])


def test_agg_and_block_wraps_equal_reference(port_caps, tmp_path, monkeypatch):
    """Over tests/test_block_wrap.py's statement-leaf circuit under its CFG
    (and a second leaf variant: three more assertions, other fixed columns,
    the same degree 2^8), with port machine proofs of the chained leaves
    i = 0, 1 (variant 0) and 2 (variant 1):
    - `build_agg` over one variant and over both (the vkey mux), gate for
      gate;
    - the agg witness stream and `interpret` values over a chained pair and
      the fold's repeat padding, for each, equal the reference's; the
      statement is the host mirror's; a broken chain is refused;
    - an `AggLadder`'s disk cache writes the circuit once, and a new ladder
      loads it and rebuilds its prover once it must prove;
    - `fold_proofs` over three leaves pads to four and pairs them as
      `expected_statement` does (its agg proofs stubbed);
    - the block base and step circuits over the one-variant agg machine,
      gate for gate (both compilers given one stand-in vkey for it).
    (One test: the leaves' vkeys and proofs are ~15 s of the CPU plain
    path, which the suite's workers would each repeat.)"""
    starks = [tm.RecursionStark(statement_leaf_circuit(tc, tvc, e)) for e in (0, 3)]
    jstarks = [jm.RecursionStark(statement_leaf_circuit(jc, jvc, e)) for e in (0, 3)]
    leaves = {}
    for i, v in ((0, 0), (1, 0), (2, 1)):
        seam, digest = seam_of(i), [i + 10] * 4
        mp = tw.prove_circuit(starks[v], seam + digest, troot.leaf_statement(seam, digest),
                              T_CFG, device="cpu")
        mp.seam, mp.digest, mp.variant = seam, digest, v
        leaves[i] = mp
    assert leaves[0].log_n == leaves[2].log_n == 8

    aggs = {k: (tagg.build_agg(starks[:k], 8, T_CFG, "cpu"), jagg.build_agg(jstarks[:k], 8, J_CFG))
            for k in (1, 2)}
    for got, want in aggs.values():
        assert_circuits_equal(got.stark.circuit, want.stark.circuit)
        assert got.log_n == want.log_n == 15

    for variants, pair in ((1, (0, 1)), (1, (1, 1)), (2, (1, 2)), (2, (2, 2))):
        got, want = aggs[variants]
        left, right = (leaves[i] for i in pair)
        pad = tagg._is_pad(left, right)
        assert pad == (pair[0] == pair[1])
        seam = tagg.chain_seams(left.seam, right.seam, pad)
        pis = troot.leaf_statement(seam, tagg.combine_digests(left.digest, right.digest))
        stream = got.vc.stream((left, right))
        assert stream == want.vc.stream((j_machine(left), j_machine(right)))
        assert tc.interpret(got.stark.circuit, stream, pis, check=True) == jc.interpret(
            want.stark.circuit, stream, pis, check=True)
    got = aggs[1][0]
    left, right = leaves[1], leaves[0]  # 1's after is not 0's before
    pis = troot.leaf_statement(tagg.chain_seams(left.seam, right.seam, False),
                               tagg.combine_digests(left.digest, right.digest))
    with pytest.raises(AssertionError):
        tc.interpret(got.stark.circuit, got.vc.stream((left, right)), pis, check=True)

    monkeypatch.setenv("ETHPROOF_ARTIFACT_DIR", str(tmp_path))
    built = tagg.AggLadder(starks[0], 8, T_CFG, cache_tag="t", device="cpu").agg(1)
    assert len(list(tmp_path.glob("agg_*.npz"))) == 1
    loaded = tagg.AggLadder(starks[0], 8, T_CFG, cache_tag="t", device="cpu").agg(1)
    assert loaded.vc is None and loaded.log_n == built.log_n
    assert_circuits_equal(loaded.stark.circuit,
                          jc.circuit_from_arrays(tc.circuit_to_arrays(built.stark.circuit)))
    loaded._ensure_vc()
    assert len(loaded.vc.accessors) == len(built.vc.accessors)
    monkeypatch.delenv("ETHPROOF_ARTIFACT_DIR")

    ladder = tagg.AggLadder(got.stark, 8, T_CFG, device="cpu")
    ladder._agg.update({1: got, 2: got})
    ladder._shape[1] = ([got.stark], got.log_n)
    calls = []

    def fake_prove(self, left, right, config, device=None, phase_times=None):
        calls.append((left.seam[:4], right.seam[:4]))
        seam = tagg.chain_seams(left.seam, right.seam, tagg._is_pad(left, right))
        digest = tagg.combine_digests(left.digest, right.digest)
        return tw.MachineProof(
            proof=SimpleNamespace(public_inputs=troot.leaf_statement(seam, digest)),
            log_n=got.log_n, seam=seam, digest=digest)

    with monkeypatch.context() as mp:
        mp.setattr(tagg.AggCircuit, "prove", fake_prove)
        top, level = tagg.fold_proofs(ladder, [leaves[0], leaves[1], leaves[2]], T_CFG)
    assert level == 2 and len(calls) == 3
    assert calls[1] == (seam_of(2)[:4], seam_of(2)[:4])  # the repeat padding
    assert (top.seam, top.digest) == tagg.expected_statement(
        [(leaves[i].seam, leaves[i].digest) for i in range(3)])

    got, want = aggs[1]
    monkeypatch.setattr(jprove, "fixed_cap", stand_in_cap)
    monkeypatch.setattr(tprove, "fixed_cap", stand_in_cap)
    t_base = tblock._build_base(got.stark, got.log_n, T_CFG, "cpu")
    j_base = jblock._build_base(want.stark, want.log_n, J_CFG)
    d = max(t_base.log_n, got.log_n)
    base_cap = stand_in_cap(t_base.stark, 1 << d, T_CFG)
    t_step = tblock._build_step(got.stark, got.log_n, T_CFG, base_cap, d, "cpu")
    j_step = jblock._build_step(want.stark, want.log_n, J_CFG, base_cap, d)
    for t_w, j_w in ((t_base, j_base), (t_step, j_step)):
        assert_circuits_equal(t_w.stark.circuit, j_w.stark.circuit)
        assert t_w.log_n == j_w.log_n


def test_block_statement_binds_base_and_w():
    """tests/test_block_wrap.py's statement algebra."""
    seam, dig, ep = seam_of(0), [1] * 4, [0] * 4
    assert tblock.block_statement(seam, dig, ep, [5] * 8, 1) != tblock.block_statement(
        seam, dig, ep, [5] * 8, 0)
    assert tblock.block_statement(seam, dig, ep, [5] * 8, 1) != tblock.block_statement(
        seam, dig, ep, [6] * 8, 1)


# -- slow: machine proofs and the other roots --------------------------------------------


@pytest.mark.slow
def test_succinct_block_on_the_cpu():
    """The machine-proved block of the reference's succinct fixtures:
    `transfer_chain(2)` plus the no-op dummy through
    `tx_proof(recursion=...)`, the fold to level 2, the block base wrap;
    `verify_block(recursion=...)` accepts it and rejects a changed leaf
    statement, a flipped top-proof opening and a changed top statement."""
    state = tstate.recursion_state(T_SIZES, T_TINY, device="cpu")
    gis = synthetic.transfer_chain(2) + [synthetic.noop_dummy(2)]
    leaves = [tops.tx_proof(gi, T_TINY, T_SIZES, recursion=state, device="cpu") for gi in gis]
    assert [leaf.root_proof.variant for leaf in leaves] == [0, 0, 1]
    bp = tops.block_proof(tops.agg_combine(tops.agg_combine(leaves[0], leaves[1]), leaves[2]))
    top, level = tagg.fold_proofs(state.ladder, [leaf.root_proof for leaf in leaves], T_TINY)
    assert level == 2
    bp.succinct = tops.SuccinctBlockProof(top=top, level=level, sizes=T_SIZES)
    wraps = tblock.build_block_wraps(state.ladder, level, T_TINY)
    bp.succinct.block_wrap = wraps.prove_base(top)
    assert tops.verify_block(bp, T_TINY, recursion=state, device="cpu")
    bad = copy.deepcopy(bp)
    bad.agg.left.left.gen_inputs.trie_roots_after.state_root = b"\x01" * 32
    assert not tops.verify_block(bad, T_TINY, recursion=state, device="cpu")
    bad = copy.deepcopy(bp)
    bad.succinct.top.proof.trace_query_openings.values[0, 0] ^= 1
    assert not tops.verify_block(bad, T_TINY, recursion=state, device="cpu")
    bad = copy.deepcopy(bp)
    bad.succinct.top.proof.public_inputs[0] = (int(top.proof.public_inputs[0]) + 1) % P
    assert not tops.verify_block(bad, T_TINY, recursion=state, device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("overlap", [o for o in tstate.OVERLAP_VARIANTS
                                     if o != ttr.OVERLAP_DISTINCT])
def test_other_overlap_roots_equal_reference(port_caps, overlap):
    sizes = dict(SIZES_KW, cpu=6)
    got = troot.build_tx_root(ttr.transfer_cpu_stark(overlap), TTableSizes(**sizes), T_TINY,
                              device="cpu")
    want = jroot.build_tx_root(jtr.transfer_cpu_stark(overlap), JTableSizes(**sizes), J_TINY)
    assert_circuits_equal(got.stark.circuit, want.stark.circuit)


@pytest.mark.slow
def test_evm_root_equals_the_fixed_reference(port_caps, fixed_reference):
    """The contract-call leaf: the port's machine declares the KECCAK256
    sponge request at its KDIG row (ROADMAP Queue 3), so its root equals the
    reference's with that fix patched in (tests/test_torch_fixes.py)."""
    from ethproof_tpu.tables import evm as jevm
    from ethproof_tpu_torch.evm import contract as tcon
    from ethproof_tpu_torch.tables import evm as tevm

    shape, _, _ = tcon.machine_inputs_for_tx(synthetic.small_erc20_transfer())
    j_shape = jevm.EvmShape(**{k: tuple(map(tuple, v)) if k == "log_shapes" else v
                               for k, v in dataclasses.asdict(shape).items()})
    sizes = dict(SIZES_KW, keccak=7, keccak_sponge=8)
    got = troot.build_evm_root(tevm.EvmStark(shape), TTableSizes(**sizes), T_TINY, "cpu")
    want = jroot.build_evm_root(jevm.EvmStark(j_shape), JTableSizes(**sizes), J_TINY)
    assert_circuits_equal(got.stark.circuit, want.stark.circuit)


@pytest.mark.slow
def test_withdrawal_root_equals_reference(port_caps):
    from ethproof_tpu.evm import binding as jbind
    from ethproof_tpu_torch.evm import binding as tbind

    # the kernel for one credit at KernelShape(3, 20) is 4,580 instructions
    sizes = dict(SIZES_KW, cpu=13, keccak=7, keccak_sponge=8)
    got = troot.build_withdrawal_root(1, tbind.KernelShape(3, 20), TTableSizes(**sizes), T_TINY,
                                      "cpu")
    want = jroot.build_withdrawal_root(1, jbind.KernelShape(3, 20), JTableSizes(**sizes),
                                       J_TINY)
    assert_circuits_equal(got.stark.circuit, want.stark.circuit)
