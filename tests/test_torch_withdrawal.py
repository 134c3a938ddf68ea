"""The withdrawal-credit kernel (evm/withdrawal.py): the port vs the JAX
package, on tests/test_dummy_proofs.py's cases at its `KernelShape(3, 20)`.

The expected PI words, the update witnesses, `wd_dummy_provable` and the
kernel's program (instruction for instruction, with and without the
concrete witness) equal the reference's; the concrete build of a forged
credit fails in both, and a tampered post root is not provable in either.
The root circuit that verifies the kernel's seven-table proof is held gate
for gate in tests/test_torch_ladder.py (`slow`).
"""

import dataclasses
import sys

import numpy as np
import pytest

sys.path.insert(0, "tests")
from test_dummy_proofs import make_dummy

from ethproof_tpu.evm import binding as jbind
from ethproof_tpu.evm import withdrawal as jwd
from ethproof_tpu.tables import cpu as jcpu
from ethproof_tpu_torch.evm import binding as tbind
from ethproof_tpu_torch.evm import withdrawal as twd
from ethproof_tpu_torch.tables import cpu as tcpu
from ethproof_tpu_torch.witness import synthetic

J_SHAPE = jbind.KernelShape(levels=3, node_words=20)
T_SHAPE = tbind.KernelShape(levels=3, node_words=20)

CASES = {
    "one": [(b"\xbb" * 20, 11)],
    "two": [(b"\xbb" * 20, 11), (b"\xcc" * 20, 5)],
    "same_account_twice": [(b"\xaa" * 20, 1), (b"\xaa" * 20, 2)],
}


def witnesses(withdrawals, tamper_root=False):
    return (synthetic.withdrawal_dummy(withdrawals, tamper_root),
            make_dummy(withdrawals, tamper_root))


def program(kasm):
    return [dataclasses.astuple(i) for i in kasm.prog]


def test_withdrawal_dummy_equals_the_reference_fixture():
    for withdrawals in ([], *CASES.values()):
        for tamper in (False, True):
            t_gi, j_gi = witnesses(withdrawals, tamper)
            assert t_gi.to_json() == j_gi.to_json()


@pytest.mark.parametrize("case", sorted(CASES))
def test_pi_witness_and_program_equal_reference(case):
    t_gi, j_gi = witnesses(CASES[case])
    n = len(CASES[case])
    pi = twd.expected_wd_pi(t_gi)
    assert pi == jwd.expected_wd_pi(j_gi)
    assert len(pi) == twd.wd_num_pi_words(n) == jwd.wd_num_pi_words(n)
    assert twd.wd_dummy_provable(t_gi, T_SHAPE) and jwd.wd_dummy_provable(j_gi, J_SHAPE)
    t_bw = twd.build_withdrawal_witness(t_gi, pi, T_SHAPE)
    j_bw = jwd.build_withdrawal_witness(j_gi, pi, J_SHAPE)
    assert dataclasses.asdict(t_bw) == dataclasses.asdict(j_bw)
    t_k = twd.build_withdrawal_kernel(n, T_SHAPE, pi, t_bw)
    j_k = jwd.build_withdrawal_kernel(n, J_SHAPE, pi, j_bw)
    assert program(t_k) == program(j_k)
    # the program is a function of (n, kshape) alone: the verifier's build
    assert program(twd.build_withdrawal_kernel(n, T_SHAPE)) == program(t_k)
    assert program(jwd.build_withdrawal_kernel(n, J_SHAPE)) == program(t_k)
    # the kernel runs clean on its witness, as the reference's does
    rows = 1 << (len(t_k.prog) - 1).bit_length()
    got = tcpu.execute(t_k.prog, pi, rows, witness=t_k.witness)
    want = jcpu.execute(j_k.prog, pi, rows, witness=j_k.witness)
    np.testing.assert_array_equal(got.trace, want.trace)
    assert got.arith_requests == want.arith_requests
    assert got.logic_requests == want.logic_requests


def test_test_dummy_proofs_pi_values():
    t_gi, _ = witnesses(CASES["two"])
    pi = twd.expected_wd_pi(t_gi)
    assert pi[2:] == [30, 41, 11, 7, 12, 5]


@pytest.mark.parametrize("mod,shape", [(twd, T_SHAPE), (jwd, J_SHAPE)], ids=["port", "ref"])
def test_forged_credit_rejected(mod, shape):
    t_gi, j_gi = witnesses(CASES["one"])
    gi = t_gi if mod is twd else j_gi
    pi = mod.expected_wd_pi(gi)
    pi[3] += 1  # claim a bigger post balance
    with pytest.raises(Exception):
        bw = mod.build_withdrawal_witness(gi, pi, shape)
        mod.build_withdrawal_kernel(1, shape, pi, bw)


def test_tampered_root_not_provable():
    t_gi, j_gi = witnesses(CASES["one"], tamper_root=True)
    assert not twd.wd_dummy_provable(t_gi, T_SHAPE)
    assert not jwd.wd_dummy_provable(j_gi, J_SHAPE)
    with pytest.raises(tbind.Unsupported):
        twd.expected_wd_pi(t_gi)

