"""The Keccak and KeccakSponge tables: the port vs the JAX package.

`keccak_f_trace`, the Keccak table's fixed columns, CTL specs and trace
generator, and the sponge's trace generator, memory ops, logic requests and
permutation inputs, on the same seeded numpy inputs. Exact u64 equality.
"""

import numpy as np
import pytest
import torch

from ethproof_tpu.hash import keccak as jhk
from ethproof_tpu.tables import keccak as jk
from ethproof_tpu.tables import keccak_sponge as js
from ethproof_tpu_torch.hash import keccak as thk
from ethproof_tpu_torch.tables import keccak as tk
from ethproof_tpu_torch.tables import keccak_sponge as ts

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)


def _states(rng, k):
    return [rng.integers(0, 1 << 64, size=(5, 5), dtype=np.uint64) for _ in range(k)]


def test_keccak_f_trace_equals_reference():
    rng = np.random.default_rng(40)
    for state in _states(rng, 3) + [np.zeros((5, 5), dtype=np.uint64)]:
        want = jhk.keccak_f_trace(state)
        got = thk.keccak_f_trace(state)
        assert len(got) == len(want) == 25
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_keccak_stark_specs_and_fixed_columns_equal_reference():
    j, t = jk.KeccakStark(), tk.KeccakStark()
    assert (t.num_columns, t.num_fixed_columns, t.constraint_degree) == (
        j.num_columns, j.num_fixed_columns, j.constraint_degree)
    assert repr(t.input_ctl_spec()) == repr(j.input_ctl_spec())
    assert repr(t.output_ctl_spec()) == repr(j.output_ctl_spec())
    for n in (32, 100):
        np.testing.assert_array_equal(t.fixed_columns(n), j.fixed_columns(n))


@pytest.mark.parametrize("n_states,n_rows", [(0, 64), (1, 64), (3, 128), (1, 32)])
def test_keccak_trace_equals_reference(n_states, n_rows):
    """Random input states; 32 rows cut the second (padding) block."""
    states = _states(np.random.default_rng(41 + n_states), n_states)
    np.testing.assert_array_equal(tk.generate_trace(states, n_rows),
                                  jk.generate_trace(states, n_rows))


def test_sponge_specs_and_fixed_columns_equal_reference():
    assert ts.NUM_COLUMNS == js.NUM_COLUMNS
    for name in ("memory_ctl_specs", "logic_ctl_specs", "keccak_input_ctl_spec",
                 "keccak_output_ctl_spec", "digest_ctl_spec", "first_ctl_spec"):
        assert repr(getattr(ts, name)()) == repr(getattr(js, name)())
    assert repr(ts.KeccakSpongeStark.lookups) == repr(js.KeccakSpongeStark.lookups)
    np.testing.assert_array_equal(ts.KeccakSpongeStark().fixed_columns(300),
                                  js.KeccakSpongeStark().fixed_columns(300))


@pytest.mark.parametrize("staged", [True, False])
def test_sponge_trace_equals_reference(staged):
    """Messages of 0, 1, 135, 136, 137, 271 and 272 bytes: one request each."""
    rng = np.random.default_rng(42)
    lengths = (0, 1, 135, 136, 137, 271, 272)
    reqs = [(0, 3, 10 + 40 * i, 5 + i, rng.bytes(n)) for i, n in enumerate(lengths)]
    want = js.generate_trace([js.HashRequest(*r, staged=staged) for r in reqs], 256)
    got = ts.generate_trace([ts.HashRequest(*r, staged=staged) for r in reqs], 256)
    np.testing.assert_array_equal(got.trace, want.trace)
    assert ([(o.key, o.is_read, o.value) for o in got.mem_ops]
            == [(o.key, o.is_read, o.value) for o in want.mem_ops])
    assert got.logic_requests == want.logic_requests
    assert len(got.perm_inputs) == len(want.perm_inputs) == 12
    for g, w in zip(got.perm_inputs, want.perm_inputs):
        np.testing.assert_array_equal(g, w)
    assert got.digests == want.digests
