"""The Poseidon table: the port vs the JAX package.

`tables/poseidon_table.py` (one round per row, 30 rows a permutation) is
the arithmetization the verifier machine reuses for its Poseidon blocks.
Its trace and fixed columns must equal the reference's bit for bit; a
port proof passes the port's verifier and a corrupted output or mid-round
state fails it. The reference's own proof of the table (eager JAX on the
CPU: minutes of per-shape compiles) is compared field for field, and the
port's proof run through the reference's `stark_verify`, in a `slow` test.
Tolerance: exact u64 equality.
"""

import copy

import numpy as np
import pytest
import torch

from ethproof_tpu.fri.config import FriConfig as JFriConfig
from ethproof_tpu.fri.config import StarkConfig as JStarkConfig
from ethproof_tpu.gf import field as jgf
from ethproof_tpu.stark import prove as jprove
from ethproof_tpu.stark.verify import stark_verify as j_stark_verify
from ethproof_tpu.tables import poseidon_table as jpt
from ethproof_tpu_torch.fri.config import FriConfig as TFriConfig
from ethproof_tpu_torch.fri.config import StarkConfig as TStarkConfig
from ethproof_tpu_torch.hash import poseidon as tps
from ethproof_tpu_torch.interop import proof_to_numpy
from ethproof_tpu_torch.stark.prove import stark_prove as t_stark_prove
from ethproof_tpu_torch.stark.verify import stark_verify as t_stark_verify
from ethproof_tpu_torch.tables import poseidon_table as tpt
from test_torch_stark import assert_same, to_reference

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)

P = tpt.C.P
# tests/test_poseidon_table.py's configuration
KW = dict(rate_bits=2, cap_height=1, proof_of_work_bits=4, num_query_rounds=10,
          arity_bits=2, final_poly_bits=2)
J_CFG = JStarkConfig(num_challenges=2, fri_config=JFriConfig(**KW))
T_CFG = TStarkConfig(num_challenges=2, fri_config=TFriConfig(**KW))


def _inputs(seed: int, count: int):
    rng = np.random.default_rng(seed)
    return [[int(v) for v in rng.integers(0, P, size=12, dtype=np.uint64)]
            for _ in range(count)]


@pytest.mark.parametrize("count,n_rows", [(1, 32), (2, 64), (3, 128), (0, 32)])
def test_trace_equals_reference(count, n_rows):
    """Active blocks, zero-state padding blocks and a cut last block."""
    perms = _inputs(count, count)
    got = tpt.generate_trace(perms, n_rows)
    np.testing.assert_array_equal(got, jpt.generate_trace(perms, n_rows))
    for k, state in enumerate(perms):
        last = 30 * k + tpt.N_ROUNDS - 1
        assert [int(got[tpt.OUT[i], last]) for i in range(12)] == tps.permute_host(state)


@pytest.mark.parametrize("n_rows", [32, 64, 256])
def test_fixed_columns_equal_reference(n_rows):
    np.testing.assert_array_equal(tpt.PoseidonStark().fixed_columns(n_rows),
                                  jpt.PoseidonStark().fixed_columns(n_rows))


def test_layout_constants_equal_reference():
    for name in ("ACTIVE", "FIRST_FILTER", "LAST_FILTER", "PERM_ID", "STATE", "X3", "OUT",
                 "NUM_COLUMNS"):
        assert getattr(tpt, name) == getattr(jpt, name), name
    t, j = tpt.PoseidonStark(), jpt.PoseidonStark()
    assert (t.num_fixed_columns, t.F_RC) == (j.num_fixed_columns, j.F_RC)
    for spec in ("input_ctl_spec", "output_ctl_spec"):
        ts, js = getattr(t, spec)(), getattr(j, spec)()
        assert (ts.columns, ts.filter_col) == (js.columns, js.filter_col), spec


def test_proof_verifies_and_rejects_corruption():
    trace = tpt.generate_trace(_inputs(7, 1), 32)
    proof = t_stark_prove(tpt.PoseidonStark(), trace, [], T_CFG, device="cpu")
    assert t_stark_verify(tpt.PoseidonStark(), proof, T_CFG, device="cpu")
    bad = trace.copy()
    bad[tpt.OUT[0], tpt.N_ROUNDS - 1] ^= 1
    proof = t_stark_prove(tpt.PoseidonStark(), bad, [], T_CFG, device="cpu")
    assert not t_stark_verify(tpt.PoseidonStark(), proof, T_CFG, device="cpu")
    bad = trace.copy()
    bad[tpt.STATE[5], 11] = (int(bad[tpt.STATE[5], 11]) + 1) % P
    proof = t_stark_prove(tpt.PoseidonStark(), bad, [], T_CFG, device="cpu")
    assert not t_stark_verify(tpt.PoseidonStark(), proof, T_CFG, device="cpu")


@pytest.mark.slow
def test_proof_equals_reference_and_passes_its_verifier(monkeypatch):
    monkeypatch.setattr(jgf, "_inv_jit", jgf._inv_impl)
    trace = tpt.generate_trace(_inputs(7, 1), 32)
    got = t_stark_prove(tpt.PoseidonStark(), trace, [], T_CFG, device="cpu")
    want = jprove.stark_prove(jpt.PoseidonStark(), trace, [], J_CFG, mesh=False)
    assert_same(proof_to_numpy(got), proof_to_numpy(want))
    assert j_stark_verify(jpt.PoseidonStark(), to_reference(proof_to_numpy(got)), J_CFG)
    bad = copy.deepcopy(got)
    bad.openings.trace_at_zeta[0, 0] ^= 1
    assert not j_stark_verify(jpt.PoseidonStark(), to_reference(proof_to_numpy(bad)), J_CFG)
