"""The recursion core: the port vs the JAX package.

The circuit IR and its interpreter, the verifier machine (`_layout`, fixed
columns, trace, the wire-bus columns `custom_aux_columns`, the recorded
constraint program), the verifier compiler and the wrap, each held against
`ethproof_tpu/recursion/` on the same inputs with exact u64 equality:
circuits gate for gate through `circuit_to_arrays`, witness streams and
`interpret` values value for value. Small circuits come from the
reference's tests/test_recursion_machine.py (`_hash_circuit`,
`_gadget_circuit`, under its configuration) and
tests/test_recursion_wrap.py (the leaf circuit and its wrap, under its
configuration), built by each package's `CBuilder`.

A machine proof of the port passes the reference's `stark_verify` through
`interop.machine_proof_to_numpy`; its field-for-field equality with the
reference's own proof (eager JAX on the CPU: minutes) and every wrap
*proof* are `slow`, as the reference's proving tier is
(tests/test_recursion_wrap.py:214).
"""

import copy

import numpy as np
import pytest
import torch

from ethproof_tpu.fri.config import FriConfig as JFriConfig
from ethproof_tpu.fri.config import StarkConfig as JStarkConfig
from ethproof_tpu.gf import field as jgf
from ethproof_tpu.recursion import circuit as jc
from ethproof_tpu.recursion import machine as jm
from ethproof_tpu.recursion import verifier_circuit as jvc
from ethproof_tpu.recursion import wrap as jw
from ethproof_tpu.stark import ir as jir
from ethproof_tpu.stark import prove as jprove
from ethproof_tpu.tables import memory as jmem
from ethproof_tpu_torch.fri.config import FriConfig as TFriConfig
from ethproof_tpu_torch.fri.config import StarkConfig as TStarkConfig
from ethproof_tpu_torch.gf import field as tgf
from ethproof_tpu_torch.hash import poseidon as tps
from ethproof_tpu_torch.interop import machine_proof_to_numpy, proof_to_numpy
from ethproof_tpu_torch.recursion import circuit as tc
from ethproof_tpu_torch.recursion import machine as tm
from ethproof_tpu_torch.recursion import verifier_circuit as tvc
from ethproof_tpu_torch.recursion import wrap as tw
from ethproof_tpu_torch.stark import ir as tir
from ethproof_tpu_torch.stark.prove import stark_prove as t_stark_prove
from ethproof_tpu_torch.stark.verify import stark_verify as t_stark_verify
from ethproof_tpu_torch.tables import memory as tmem
from test_torch_stark import OPS, assert_same, to_reference

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)

P = tc.P
# tests/test_recursion_machine.py's configuration
M_KW = dict(rate_bits=2, cap_height=1, proof_of_work_bits=4, num_query_rounds=12,
            arity_bits=2, final_poly_bits=2)
M_CFG = TStarkConfig(num_challenges=2, fri_config=TFriConfig(**M_KW))
# tests/test_recursion_wrap.py's configuration
W_KW = dict(rate_bits=2, cap_height=1, proof_of_work_bits=2, num_query_rounds=3,
            arity_bits=2, final_poly_bits=2)
J_CFG = JStarkConfig(num_challenges=1, fri_config=JFriConfig(**W_KW))
T_CFG = TStarkConfig(num_challenges=1, fri_config=TFriConfig(**W_KW))


def hash_circuit(mod):
    """PI = poseidon digest of y where y = x^2 + 3x + 5, x witnessed (the
    reference's `_hash_circuit`, and its wrap test's leaf circuit)."""
    b = mod.CBuilder()
    x = b.wit("x")
    y = b.add(b.add(b.mul(x, x), b.mulc(3, x)), b.const(5))
    out = b.poseidon([y] + [b.const(0)] * 11)
    for k in range(4):
        b.expose(out[k], k)
    return b.build()


def gadget_circuit(mod):
    """bool/select/inverse/bit-decomposition gadgets (the reference's
    `_gadget_circuit`)."""
    b = mod.CBuilder()
    bit = b.bool_check(b.wit("bit"))
    x = b.wit("x")
    y = b.wit("y")
    sel = b.select(bit, x, y)
    inv = b.inverse(sel)
    b.assert_eq(b.mul(sel, inv), b.const(1))
    bits = b.decompose_bits(x, 64)
    out = b.poseidon([sel, bits[0]] + [b.const(0)] * 10)
    for k in range(4):
        b.expose(out[k], k)
    return b.build()


def hash_inputs():
    x = 7
    y = (x * x + 3 * x + 5) % P
    return [x], tps.permute_host([y] + [0] * 11)[:4]


def gadget_inputs():
    x, y, bit = 0xDEADBEEF, 12345, 1
    sel = x if bit else y
    wit = [bit, x, y, pow(sel, P - 2, P)] + [(x >> i) & 1 for i in range(64)]
    return wit, tps.permute_host([sel, x & 1] + [0] * 10)[:4]


CIRCUITS = {"hash": (hash_circuit, hash_inputs), "gadget": (gadget_circuit, gadget_inputs)}


def machine_rows(circuit) -> int:
    return 1 << max(circuit.num_rows - 1, 1).bit_length()


def layout_of(stark):
    return [(tuple(r.coeffs), r.pose, r.pose_first, r.pose_last, r.slots, r.qpi)
            for r in stark._rows]


def assert_circuits_equal(got, want):
    a, b = tc.circuit_to_arrays(got), jc.circuit_to_arrays(want)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_circuit_equals_reference(name):
    build, _ = CIRCUITS[name]
    got, want = build(tc), build(jc)
    assert_circuits_equal(got, want)
    assert got.num_rows == want.num_rows
    assert got.consumption_counts() == want.consumption_counts()
    back = tc.circuit_from_arrays(tc.circuit_to_arrays(got))
    assert [(g.op, g.a, g.b, g.out, g.c, g.ins, g.outs, g.hint) for g in back.gates] == [
        (g.op, g.a, g.b, g.out, g.c, g.ins, g.outs, g.hint) for g in want.gates]


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_interpret_equals_reference(name):
    build, inputs = CIRCUITS[name]
    wit, pis = inputs()
    assert tc.interpret(build(tc), wit, pis) == jc.interpret(build(jc), wit, pis)
    bad = list(pis)
    bad[0] ^= 1
    with pytest.raises(AssertionError):
        tc.interpret(build(tc), wit, bad)


def test_interpret_catches_bad_witness():
    wit = [2, 5, 6, 1] + [0] * 64  # bit = 2 violates bool
    for mod in (tc, jc):
        with pytest.raises(AssertionError):
            mod.interpret(gadget_circuit(mod), wit, [0] * 4)


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_layout_fixed_columns_and_trace_equal_reference(name):
    build, inputs = CIRCUITS[name]
    wit, pis = inputs()
    ts, js = tm.RecursionStark(build(tc)), jm.RecursionStark(build(jc))
    assert ts.num_rows == js.num_rows
    assert layout_of(ts) == layout_of(js)
    n = machine_rows(ts.circuit)
    np.testing.assert_array_equal(ts.fixed_columns(n), js.fixed_columns(n))
    vals = jc.interpret(js.circuit, wit, pis)
    np.testing.assert_array_equal(tm.generate_trace(ts, vals, n),
                                  jm.generate_trace(js, vals, n))
    # a longer trace: the rows past the layout stay dead
    np.testing.assert_array_equal(ts.fixed_columns(2 * n), js.fixed_columns(2 * n))
    np.testing.assert_array_equal(tm.generate_trace(ts, vals, 2 * n),
                                  jm.generate_trace(js, vals, 2 * n))


def test_custom_aux_columns_equal_reference(monkeypatch):
    """The wire bus of the hash machine for two (beta, gamma) pairs, the
    port's PyTorch against the reference's JAX function on the CPU."""
    monkeypatch.setattr(jgf, "_inv_jit", jgf._inv_impl)
    wit, pis = hash_inputs()
    ts, js = tm.RecursionStark(hash_circuit(tc)), jm.RecursionStark(hash_circuit(jc))
    n = machine_rows(ts.circuit)
    trace = tm.generate_trace(ts, tc.interpret(ts.circuit, wit, pis), n)
    fixed = ts.fixed_columns(n)
    rng = np.random.default_rng(11)
    challenges = [int(v) for v in rng.integers(0, P, size=4, dtype=np.uint64)]
    got = tgf.to_u64(ts.custom_aux_columns(tgf.from_u64(trace, "cpu"),
                                           tgf.from_u64(fixed, "cpu"), challenges))
    want = jgf.to_u64(js.custom_aux_columns(jgf.from_u64(trace), jgf.from_u64(fixed),
                                            challenges))
    assert got.shape == (ts.num_custom_aux(2), n)
    np.testing.assert_array_equal(got, want)
    # the running sums close to zero: the bus balances
    for i in range(2):
        assert int(got[i * (tm.NUM_SLOTS + 1) + tm.NUM_SLOTS, -1]) == 0


@pytest.mark.parametrize("num_challenges", [1, 2])
def test_ir_program_equals_reference(num_challenges):
    """The recorded sweep program of RecursionStark (its eval and the bus
    constraints of eval_custom), instruction for instruction."""
    ts, js = tm.RecursionStark(hash_circuit(tc)), jm.RecursionStark(hash_circuit(jc))
    got = tir.sweep_program(ts, (), num_challenges, 0, True)
    want = jir.sweep_program(js, (), num_challenges, 0, True)
    assert got.input_keys == want.input_keys
    assert got.instrs == want.instrs
    assert got.outputs == want.outputs
    assert got.meta == want.meta
    assert ("auxch", 2 * num_challenges - 1) in got.input_keys


def machine_proof(name, config, mutate=None, pis=None):
    build, inputs = CIRCUITS[name]
    wit, digest = inputs()
    stark = tm.RecursionStark(build(tc))
    n = machine_rows(stark.circuit)
    trace = tm.generate_trace(stark, tc.interpret(stark.circuit, wit, digest), n)
    if mutate is not None:
        mutate(stark, trace, n)
    proof = t_stark_prove(stark, trace, digest if pis is None else pis, config, device="cpu")
    return stark, proof


def test_machine_proof_verifies():
    stark, proof = machine_proof("hash", M_CFG)
    assert t_stark_verify(stark, proof, M_CFG, device="cpu")


def test_machine_rejects_a_wrong_public_input():
    _, digest = hash_inputs()
    stark, proof = machine_proof("hash", M_CFG, pis=[digest[0] ^ 1] + digest[1:])
    assert not t_stark_verify(stark, proof, M_CFG, device="cpu")


def test_machine_rejects_a_tampered_wire():
    """Forge one bus value: routing must catch it."""

    def forge(stark, trace, n):
        row = int(np.nonzero(stark.fixed_columns(n)[tm.F_QPOSE_FIRST])[0][0])
        trace[tm.V[0], row] = (int(trace[tm.V[0], row]) + 1) % P

    stark, proof = machine_proof("hash", M_CFG, mutate=forge)
    assert not t_stark_verify(stark, proof, M_CFG, device="cpu")


def test_both_sweeps_make_the_same_machine_proof(monkeypatch):
    """eval_custom reaches the quotient under ETHPROOF_SWEEP=ir (the
    recorded program) and eager (direct eval), with equal proofs; the
    verifier's replay and its direct evaluation accept alike."""
    from ethproof_tpu_torch.stark import verify as tverify

    proofs = {}
    for mode in ("ir", "eager"):
        monkeypatch.setenv("ETHPROOF_SWEEP", mode)
        proofs[mode] = machine_proof("hash", M_CFG)
    assert_same(proof_to_numpy(proofs["eager"][1]), proof_to_numpy(proofs["ir"][1]))
    stark, proof = proofs["ir"]
    monkeypatch.setattr(tverify, "_replay_accs", tverify._direct_accs)
    assert t_stark_verify(stark, proof, M_CFG, device="cpu")
    bad = copy.deepcopy(proof)
    bad.openings.aux_at_zeta[0, 0] ^= 1
    assert not t_stark_verify(stark, bad, M_CFG, device="cpu")


# -- the leaf machine proof and its wrap (tests/test_recursion_wrap.py) ----------


@pytest.fixture(scope="module")
def leaf():
    """(port stark, port MachineProof, digest) of the leaf circuit."""
    wit, digest = hash_inputs()
    stark = tm.RecursionStark(hash_circuit(tc))
    mp = tw.prove_circuit(stark, wit, digest, T_CFG, device="cpu")
    assert mp.log_n == (machine_rows(stark.circuit) - 1).bit_length()
    return stark, mp, digest


@pytest.fixture(scope="module")
def j_leaf_stark():
    """The reference's stark of the leaf circuit: its vkey (the reference's
    own fixed-column commitment on XLA:CPU) is cached on it for the tests
    that share it."""
    return jm.RecursionStark(hash_circuit(jc))


@pytest.fixture(scope="module")
def wrap(leaf):
    stark, mp, _ = leaf
    return tw.build_wrap(stark, mp.log_n, T_CFG, device="cpu")


def test_leaf_proof_passes_the_reference_verifier(leaf, j_leaf_stark):
    stark, mp, digest = leaf
    d = machine_proof_to_numpy(mp)
    assert (d["log_n"], d["variant"], d["seam"], d["digest"]) == (mp.log_n, 0, None, None)
    assert d["proof"]["public_inputs"] == [int(v) for v in digest]
    assert tw.verify_machine(stark, mp, T_CFG, device="cpu")
    ref = jw.MachineProof(proof=to_reference(d["proof"]), log_n=d["log_n"])
    assert jw.verify_machine(j_leaf_stark, ref, J_CFG)
    bad = copy.deepcopy(mp)
    bad.proof.openings.aux_at_zeta[3, 1] ^= 1
    assert not tw.verify_machine(stark, bad, T_CFG, device="cpu")
    ref = jw.MachineProof(proof=to_reference(machine_proof_to_numpy(bad)["proof"]),
                          log_n=d["log_n"])
    assert not jw.verify_machine(j_leaf_stark, ref, J_CFG)


def test_wrap_equals_reference(leaf, j_leaf_stark, wrap):
    """The compiled wrap of the leaf's machine proof gate for gate, its
    witness stream and interpreted values, and its machine's layout, fixed
    columns and trace."""
    _, mp, digest = leaf
    want = jw.build_wrap(j_leaf_stark, mp.log_n, J_CFG)
    assert_circuits_equal(wrap.compiled.circuit, want.compiled.circuit)
    assert wrap.log_n == want.log_n
    assert wrap.compiled.child_pi_wires == want.compiled.child_pi_wires
    stream = wrap.compiled.witness(mp.proof)
    assert stream == want.compiled.witness(to_reference(proof_to_numpy(mp.proof)))
    vals = tc.interpret(wrap.compiled.circuit, stream, digest)
    assert vals == jc.interpret(want.compiled.circuit, stream, digest)
    assert layout_of(wrap.stark) == layout_of(want.stark)
    n = 1 << wrap.log_n
    np.testing.assert_array_equal(wrap.stark.fixed_columns(n), want.stark.fixed_columns(n))
    np.testing.assert_array_equal(tm.generate_trace(wrap.stark, vals, n),
                                  jm.generate_trace(want.stark, vals, n))


def test_wrap_interprets_clean(leaf, wrap):
    _, mp, digest = leaf
    pis = [int(v) for v in mp.proof.public_inputs]
    tc.interpret(wrap.compiled.circuit, wrap.compiled.witness(mp.proof), pis, check=True)
    assert pis == [int(v) for v in digest]


def _trace_opening(p):
    p.openings.trace_at_zeta[0][0] ^= 1


def _trace_cap(p):
    p.trace_cap = p.trace_cap.copy()
    p.trace_cap[0, 0] ^= 1


def _pow_witness(p):
    p.fri_proof.pow_witness = (p.fri_proof.pow_witness + 1) % P


def _leaf_value(p):
    p.trace_query_openings.values[0, 0] ^= 1


@pytest.mark.parametrize("tamper", [_trace_opening, _trace_cap, _pow_witness, _leaf_value])
def test_wrap_interpreter_rejects_a_tampered_child(leaf, wrap, tamper):
    _, mp, _ = leaf
    bad = copy.deepcopy(mp.proof)
    tamper(bad)
    pis = [int(v) for v in mp.proof.public_inputs]
    with pytest.raises(AssertionError):
        tc.interpret(wrap.compiled.circuit, wrap.compiled.witness(bad), pis, check=True)


def test_wrap_interpreter_rejects_wrong_public_inputs(leaf, wrap):
    _, mp, digest = leaf
    bad_pis = [int(digest[0]) ^ 1] + [int(v) for v in digest[1:]]
    with pytest.raises(AssertionError):
        tc.interpret(wrap.compiled.circuit, wrap.compiled.witness(mp.proof), bad_pis,
                     check=True)


# -- a table with lookups and fixed columns: the Memory verifier ----------------


@pytest.fixture(scope="module")
def memory_proof():
    trace = tmem.generate_trace([tmem.MemoryOp(*op) for op in OPS], 64)
    return t_stark_prove(tmem.MemoryStark(), trace, [], T_CFG, device="cpu")


def test_memory_verifier_equals_reference(memory_proof, monkeypatch):
    """compile_stark_verifier(MemoryStark(), 6, CFG): the logUp range check
    and the fixed F_COUNTER column in the compiled verifier, gate for gate;
    the witness stream and interpreted values of a port Memory proof; a
    tampered opened value refused by `interpret`."""
    got = tvc.compile_stark_verifier(tmem.MemoryStark(), 6, T_CFG, device="cpu")
    want = jvc.compile_stark_verifier(jmem.MemoryStark(), 6, J_CFG)
    assert_circuits_equal(got.circuit, want.circuit)
    stream = got.witness(memory_proof)
    assert stream == want.witness(to_reference(proof_to_numpy(memory_proof)))
    assert tc.interpret(got.circuit, stream, []) == jc.interpret(want.circuit, stream, [])
    bad = copy.deepcopy(memory_proof)
    bad.fixed_query_openings.values[0, 0] ^= 1
    with pytest.raises(AssertionError):
        tc.interpret(got.circuit, got.witness(bad), [], check=True)


def test_memory_wrap_pads_the_public_inputs(memory_proof, monkeypatch):
    """MemoryStark has no public inputs and the machine always has four: the
    port's wrap proves with four zeros, where the reference's
    `WrapCircuit.prove` passes the child's empty list and its `stark_prove`
    refuses it (ethproof_tpu/recursion/wrap.py:95-96, stark/prove.py:518).
    The machine proof itself is not made here (see the slow test below)."""
    j_wrap = jw.build_wrap(jmem.MemoryStark(), 6, J_CFG)
    with pytest.raises(AssertionError) as refused:
        j_wrap.prove(to_reference(proof_to_numpy(memory_proof)), J_CFG)
    assert refused.traceback[-1].name == "stark_prove"
    seen = {}

    def record(stark, trace, public_inputs, config, device=None, phase_times=None):
        seen["pis"], seen["shape"] = list(public_inputs), trace.shape
        raise RuntimeError("stop before proving")

    wrap = tw.build_wrap(tmem.MemoryStark(), 6, T_CFG, device="cpu")
    monkeypatch.setattr(tw, "stark_prove", record)
    with pytest.raises(RuntimeError, match="stop before proving"):
        wrap.prove(memory_proof, T_CFG)
    assert seen == {"pis": [0, 0, 0, 0], "shape": (tm.NUM_COLUMNS, 1 << wrap.log_n)}


# -- slow: the reference's proofs and the wrap proofs -------------------------------


@pytest.mark.slow
def test_gadget_machine_proof_verifies():
    stark, proof = machine_proof("gadget", M_CFG)
    assert t_stark_verify(stark, proof, M_CFG, device="cpu")


@pytest.mark.slow
def test_leaf_machine_proof_equals_reference(leaf, monkeypatch):
    monkeypatch.setattr(jgf, "_inv_jit", jgf._inv_impl)
    stark, mp, digest = leaf
    wit, _ = hash_inputs()
    js = jm.RecursionStark(hash_circuit(jc))
    vals = jc.interpret(js.circuit, wit, digest)
    want = jprove.stark_prove(js, jm.generate_trace(js, vals, 1 << mp.log_n), digest, J_CFG,
                              mesh=False)
    assert_same(proof_to_numpy(mp.proof), proof_to_numpy(want))


@pytest.mark.slow
def test_wrap_proves_and_verifies(leaf, wrap):
    """The wrap of the leaf proof, proved and verified by the port; a
    changed trace cap rejected. (The reference's verifier of a machine
    proof is held above on the leaf: its vkey commit of the wrap's 2^14-row
    machine on XLA:CPU ran past 20 minutes.)"""
    _, mp, digest = leaf
    times = {}
    wp = wrap.prove(mp.proof, T_CFG, phase_times=times)
    assert set(times["host"]) == {"witness", "interpret", "generate_trace"}
    assert [int(v) for v in wp.proof.public_inputs] == [int(v) for v in digest]
    assert tw.verify_machine(wrap.stark, wp, T_CFG, device="cpu")
    bad = copy.deepcopy(wp)
    bad.proof.trace_cap[0, 0] ^= 1
    assert not tw.verify_machine(wrap.stark, bad, T_CFG, device="cpu")


@pytest.mark.slow
def test_memory_wrap_proves_and_verifies(memory_proof):
    wrap = tw.build_wrap(tmem.MemoryStark(), 6, T_CFG, device="cpu")
    wp = wrap.prove(memory_proof, T_CFG)
    assert [int(v) for v in wp.proof.public_inputs] == [0, 0, 0, 0]
    assert tw.verify_machine(wrap.stark, wp, T_CFG, device="cpu")
    bad = copy.deepcopy(wp)
    bad.proof.openings.trace_at_zeta[0, 0] ^= 1
    assert not tw.verify_machine(wrap.stark, bad, T_CFG, device="cpu")
