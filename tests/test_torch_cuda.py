"""Port kernels on the CUDA card against their plain PyTorch versions.

These need an NVIDIA card with the CUDA toolkit and skip elsewhere. They
import no JAX, so on a card host without JAX they run with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q`.
"""

import numpy as np
import pytest
import torch

from ethproof_tpu_torch.evm.transfer import prove_transfer, verify_transfer
from ethproof_tpu_torch.fri.config import FriConfig, StarkConfig
from ethproof_tpu_torch.gf import field as gfp
from ethproof_tpu_torch.interop import proof_to_numpy, tx_proof_to_numpy
from ethproof_tpu_torch.poly import base_dft as bd
from ethproof_tpu_torch.poly import four_step
from ethproof_tpu_torch.stark.prove import stark_prove
from ethproof_tpu_torch.stark.verify import stark_verify
from ethproof_tpu_torch.tables import memory as mem
from ethproof_tpu_torch.tables.all import TableSizes
from ethproof_tpu_torch.witness import synthetic

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _assert_same(x, y):
    if isinstance(x, dict):
        assert x.keys() == y.keys()
        for k in x:
            _assert_same(x[k], y[k])
    elif isinstance(x, list):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            _assert_same(u, v)
    elif isinstance(x, np.ndarray):
        np.testing.assert_array_equal(x, y)
    else:
        assert x == y


def _vals(shape, seed):
    return np.random.default_rng(seed).integers(0, gfp.P, size=shape, dtype=np.uint64)


# every i8 data digit -128; seven of eight bytes 0xFF (i8 digits +127, the
# largest bf16 chunk dots); p - 1
ADVERSARIAL = (0, 0xFFFFFFFEFFFFFFFF, gfp.P - 1)


def _vals_adv(shape, seed):
    x = _vals(shape, seed)
    x[: len(ADVERSARIAL)] = np.asarray(ADVERSARIAL, dtype=np.uint64)[:, None]
    return x


def _check_kernel(card, encoding, log_n, inverse, seed):
    """The encoding's kernel against base_dft_plain and its own plain
    version: on a ragged row count (the partial last row tile) whose first
    rows are the adversarial values, and on 37 rows that are all one
    adversarial value (each bf16 chain at its largest sum, each i8 digit at
    an end of its range), the plain version with TF32 allowed (its digit
    matmuls run in float64); one launch counted per call, and the launcher
    refuses a misaligned tensor (a slice a[1:] of a flat tensor, reshaped)
    without launching."""
    name = bd.KERNELS[encoding]
    plain = bd.base_dft_i8_plain if encoding == "i8" else bd.base_dft_bf16_plain
    n = 1 << log_n
    a = gfp.from_u64(_vals_adv((1000 + log_n, n), seed), card)
    before = bd.LAUNCHES[name]
    census = bd.CENSUS[(name, 1000 + log_n, n, inverse)]
    got = bd.base_dft(a, log_n, inverse, encoding)
    assert bd.LAUNCHES[name] == before + 1
    assert bd.CENSUS[(name, 1000 + log_n, n, inverse)] == census + 1
    assert torch.equal(got, bd.base_dft_plain(a, log_n, inverse))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert torch.equal(got, plain(a, log_n, inverse))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for value in ADVERSARIAL:
        c = torch.full((37, n), gfp.to_i64(value), dtype=torch.int64, device=card)
        assert torch.equal(bd.base_dft(c, log_n, inverse, encoding),
                           bd.base_dft_plain(c, log_n, inverse)), value
    misaligned = a.flatten()[1 : 1 + 64 * n].view(64, n)
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16 == 8
    before = bd.LAUNCHES[name]
    with pytest.raises(ValueError, match="16-byte aligned"):
        bd.base_dft(misaligned, log_n, inverse, encoding)
    assert bd.LAUNCHES[name] == before


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", range(1, 9))
def test_base_dft_kernel_equals_plain(card, log_n, inverse):
    """The int8 tensor-core kernel (see _check_kernel)."""
    _check_kernel(card, "i8", log_n, inverse, log_n)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", range(1, 9))
def test_base_dft_bf16_kernel_equals_plain(card, log_n, inverse):
    """The bf16 tensor-core kernel (see _check_kernel)."""
    _check_kernel(card, "bf16", log_n, inverse, 50 + log_n)


def test_four_step_with_kernel_equals_cpu(card):
    x = _vals((3, 1 << 12), 7)
    on_card = four_step.best_coset_lde(four_step.best_intt(gfp.from_u64(x, card)), 2, 7)
    on_cpu = four_step.best_coset_lde(four_step.best_intt(gfp.from_u64(x, "cpu")), 2, 7)
    np.testing.assert_array_equal(gfp.to_u64(on_card), gfp.to_u64(on_cpu))


def test_small_memory_proof_on_card_equals_cpu_and_verifies(card):
    cfg = StarkConfig(num_challenges=2, fri_config=FriConfig(
        rate_bits=2, cap_height=1, proof_of_work_bits=4, num_query_rounds=12,
        arity_bits=2, final_poly_bits=2))
    ops = [mem.MemoryOp(0, 1, 5, 1, 0, 1234), mem.MemoryOp(0, 1, 5, 2, 1, 1234),
           mem.MemoryOp(0, 2, 0, 4, 1, 0)]
    trace = mem.generate_trace(ops, 1 << 8)
    got = stark_prove(mem.MemoryStark(), trace, [], cfg, device=card)
    want = stark_prove(mem.MemoryStark(), trace, [], cfg, device="cpu")
    _assert_same(proof_to_numpy(got), proof_to_numpy(want))
    assert stark_verify(mem.MemoryStark(), got, cfg, device=card)


@pytest.mark.parametrize("encoding", ["i8", "bf16"])
def test_base_dft_on_a_second_card(card, encoding):
    """A mesh shard may lie on another card than the current one: the
    kernel launches on its tensor's card (cuda:1 while cuda:0 is current),
    equal to the plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    name = bd.KERNELS[encoding]
    x = _vals((300, 64), 80)
    with torch.cuda.device(0):
        before = bd.LAUNCHES[name]
        got = bd.base_dft(gfp.from_u64(x, "cuda:1"), 6, False, encoding)
        torch.cuda.synchronize(1)
    assert got.device == torch.device("cuda", 1)
    assert bd.LAUNCHES[name] == before + 1
    np.testing.assert_array_equal(gfp.to_u64(got),
                                  gfp.to_u64(bd.base_dft_plain(gfp.from_u64(x, "cpu"), 6, False)))


def test_small_memory_proof_on_a_card_mesh_equals_cpu(card):
    """A virtual 4-wide mesh on one card (every shard on cuda:0): the proof
    of the CPU tier's Memory trace equals the one-device CPU proof."""
    from ethproof_tpu_torch.parallel.mesh import make_mesh

    cfg = StarkConfig(num_challenges=2, fri_config=FriConfig(
        rate_bits=2, cap_height=1, proof_of_work_bits=4, num_query_rounds=12,
        arity_bits=2, final_poly_bits=2))
    ops = [mem.MemoryOp(0, 1, 5, 1, 0, 1234), mem.MemoryOp(0, 2, 0, 4, 1, 0)]
    trace = mem.generate_trace(ops, 1 << 8)
    got = stark_prove(mem.MemoryStark(), trace, [], cfg, device=card,
                      mesh=make_mesh(devices=["cuda:0"] * 4))
    want = stark_prove(mem.MemoryStark(), trace, [], cfg, device="cpu")
    _assert_same(proof_to_numpy(got), proof_to_numpy(want))


@pytest.mark.parametrize("encoding", ["i8", "bf16"])
def test_small_transfer_proof_on_card_equals_cpu(card, monkeypatch, encoding):
    """The five-table transfer at the CPU tier's sizes: made on the card
    under each encoding, every table proof equals the CPU plain path's."""
    cfg = StarkConfig(num_challenges=2, fri_config=FriConfig(
        rate_bits=2, cap_height=1, proof_of_work_bits=4, num_query_rounds=12,
        arity_bits=2, final_poly_bits=2))
    sizes = TableSizes(cpu=5, arithmetic=6, logic=4, bytepacking=9, memory=7, keccak=None)
    gi = synthetic.small_transfer()
    want = prove_transfer(gi, cfg, sizes, device="cpu")
    monkeypatch.setattr(bd, "ENCODING", encoding)
    before = bd.LAUNCHES[bd.KERNELS[encoding]]
    got = prove_transfer(gi, cfg, sizes, device=card)
    assert bd.LAUNCHES[bd.KERNELS[encoding]] > before
    _assert_same(tx_proof_to_numpy(got), tx_proof_to_numpy(want))
    assert verify_transfer(got, cfg, device=card)


@pytest.mark.parametrize("encoding", ["i8", "bf16"])
def test_seven_table_transfer_on_card_equals_cpu(card, monkeypatch, encoding):
    """The seven-table transfer at the CPU tier's sizes (`SIZES7` of
    tests/test_transfer_e2e.py: the Keccak pair on, the binding dropped by
    the cpu < 2^11 pre-guard): made on the card under each encoding, every
    table proof equals the CPU plain path's, and the port verifies it."""
    cfg = StarkConfig(num_challenges=2, fri_config=FriConfig(
        rate_bits=2, cap_height=1, proof_of_work_bits=4, num_query_rounds=12,
        arity_bits=2, final_poly_bits=2))
    sizes = TableSizes(cpu=5, arithmetic=6, logic=4, bytepacking=9, memory=7)
    gi = synthetic.small_transfer()
    want = prove_transfer(gi, cfg, sizes, device="cpu")
    monkeypatch.setattr(bd, "ENCODING", encoding)
    before = bd.LAUNCHES[bd.KERNELS[encoding]]
    got = prove_transfer(gi, cfg, sizes, device=card)
    assert bd.LAUNCHES[bd.KERNELS[encoding]] > before
    assert len(got.multi.proofs) == 7
    _assert_same(tx_proof_to_numpy(got), tx_proof_to_numpy(want))
    assert verify_transfer(got, cfg, device=card)


def test_ir_sweep_on_card_equals_cpu_direct_sweep(card):
    """The machine's IR sweep on the card (one chunk, then several under a
    small ETHPROOF_SWEEP_BUDGET) equals the CPU's direct evaluation on
    seeded LDE columns with its CTL instances."""
    import os

    from ethproof_tpu_torch.evm import erc20
    from ethproof_tpu_torch.stark import multi
    from ethproof_tpu_torch.stark import prove as sp
    from ethproof_tpu_torch.tables import all as tall
    from ethproof_tpu_torch.tables import evm

    shape, inputs = erc20.transfer_inputs(1, 2, 3, {1: 5})
    shape, _, _ = evm.discover_and_execute(inputs.code, inputs.calldata, 1, 0,
                                           inputs.storage_pre, 9)
    machine = evm.EvmStark(shape)
    inst = multi._instances_for_table(0, tall.build_ctls_evm(machine), [(3, 5), (7, 11)])[0]
    log_n, rate_bits = 9, 2
    m = 1 << (log_n + rate_bits)
    rng = np.random.default_rng(40)
    n_aux = len(inst)

    def rand(*s):
        return rng.integers(0, gfp.P, size=s, dtype=np.uint64)

    host = (rand(machine.num_columns, m), rand(machine.num_fixed_columns, m), rand(n_aux, m))
    scalars = ([int(v) for v in rand(len(inst))], [], [int(v) for v in rand(
        machine.num_public_inputs)], [int(v) for v in rand(2)])

    def args(dev):
        t, f, a = (gfp.from_u64(x, dev) for x in host)
        totals, lookups, pis, alphas = scalars
        return (machine, t, f, a, inst, totals, lookups, pis, alphas, log_n, rate_bits, 7)

    want = gfp.to_u64(sp._sweep(*args("cpu")))
    for budget in (None, 1 << 22):
        if budget is not None:
            os.environ["ETHPROOF_SWEEP_BUDGET"] = str(budget)
        try:
            got = gfp.to_u64(sp._ir_sweep(*args(card)))
        finally:
            os.environ.pop("ETHPROOF_SWEEP_BUDGET", None)
        np.testing.assert_array_equal(got, want)


def test_machine_proof_on_card_equals_cpu(card):
    """A machine program with a KECCAK256 (the one of tests/test_evm_e2e.py,
    `TableSizes(9, 8, 9, 9, 13, 6, 8)`: an ERC-20 call needs the 2^16-row
    Arithmetic table, hours of plain Poseidon on the CPU): its multi-proof
    made on the card equals the CPU plain path's table by table, and the
    port verifies it."""
    from ethproof_tpu_torch.interop import multi_proof_to_numpy
    from ethproof_tpu_torch.tables import all as tall
    from ethproof_tpu_torch.tables import evm as E

    cfg = StarkConfig(num_challenges=2, fri_config=FriConfig(
        rate_bits=2, cap_height=1, proof_of_work_bits=4, num_query_rounds=12,
        arity_bits=2, final_poly_bits=2))
    sizes = TableSizes(cpu=9, arithmetic=8, logic=9, bytepacking=9, memory=13, keccak=6,
                       keccak_sponge=8)
    code = E.asm(
        ("push", 4), E.CALLDATALOAD, ("push", 0xBEEF), E.SLOAD, E.ADD,
        ("push", 0xBEEF), E.SSTORE, E.CALLER, ("push", 0), E.MSTORE,
        ("push", 0xBEEF), ("push", 32), E.MSTORE,
        ("push", 64), ("push", 0), E.KECCAK256, E.POP,
        ("push", 1), ("push", 0), E.MSTORE, ("push", 32), ("push", 0), E.RETURN,
    )
    calldata = bytes([0xA9, 0x05, 0x9C, 0xBB]) + (7).to_bytes(32, "big")
    shape, _, res = E.discover_and_execute(code, calldata, 0xC0FFEE, 0, {0xBEEF: 35}, 9)
    machine = E.EvmStark(shape)
    want = tall.prove_evm_tables(machine, res, sizes, cfg, device="cpu")
    got = tall.prove_evm_tables(machine, res, sizes, cfg, device=card)
    _assert_same(multi_proof_to_numpy(got), multi_proof_to_numpy(want))
    assert tall.verify_evm_tables(machine, res.pi_words, got, cfg, device=card)


def _leaf_machine():
    """The wrap tests' leaf circuit (PI = Poseidon digest of x^2 + 3x + 5)
    as a verifier-machine stark, its trace and its public inputs."""
    from ethproof_tpu_torch.hash import poseidon
    from ethproof_tpu_torch.recursion import CBuilder, RecursionStark, generate_trace, interpret

    b = CBuilder()
    x = b.wit("x")
    y = b.add(b.add(b.mul(x, x), b.mulc(3, x)), b.const(5))
    out = b.poseidon([y] + [b.const(0)] * 11)
    for k in range(4):
        b.expose(out[k], k)
    circuit = b.build()
    digest = poseidon.permute_host([(7 * 7 + 3 * 7 + 5) % gfp.P] + [0] * 11)[:4]
    stark = RecursionStark(circuit)
    n = 1 << max(circuit.num_rows - 1, 1).bit_length()
    return stark, generate_trace(stark, interpret(circuit, [7], digest), n), digest


def test_custom_aux_columns_on_card_equal_cpu(card):
    """The machine's wire-bus columns (two (beta, gamma) pairs) on the card
    equal the CPU's, on the trace's device."""
    stark, trace, _ = _leaf_machine()
    fixed = stark.fixed_columns(trace.shape[1])
    challenges = [int(v) for v in _vals(4, 12)]
    got = stark.custom_aux_columns(gfp.from_u64(trace, card), gfp.from_u64(fixed, card),
                                   challenges)
    want = stark.custom_aux_columns(gfp.from_u64(trace, "cpu"), gfp.from_u64(fixed, "cpu"),
                                    challenges)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(gfp.to_u64(got), gfp.to_u64(want))


def test_small_machine_proof_on_card_equals_cpu(card):
    """A verifier-machine proof (custom aux columns) made on the card equals
    the CPU plain path's field for field, and the port verifies it."""
    from ethproof_tpu_torch.interop import machine_proof_to_numpy
    from ethproof_tpu_torch.recursion import MachineProof, verify_machine

    cfg = StarkConfig(num_challenges=2, fri_config=FriConfig(
        rate_bits=2, cap_height=1, proof_of_work_bits=4, num_query_rounds=12,
        arity_bits=2, final_poly_bits=2))
    stark, trace, digest = _leaf_machine()
    log_n = trace.shape[1].bit_length() - 1
    got = MachineProof(stark_prove(stark, trace, digest, cfg, device=card), log_n)
    want = MachineProof(stark_prove(stark, trace, digest, cfg, device="cpu"), log_n)
    _assert_same(machine_proof_to_numpy(got), machine_proof_to_numpy(want))
    assert verify_machine(stark, got, cfg, device=card)


def test_dummy_root_proof_on_card_equals_cpu(card):
    """The no-op dummy's root (the recursion ladder's leaf circuit) proved
    at its own degree under the succinct configuration (one query) on the
    card equals the CPU plain path's proof field for field, statement
    preimage included, and the port verifies it."""
    from ethproof_tpu_torch.interop import machine_proof_to_numpy
    from ethproof_tpu_torch.recursion import build_dummy_root, dummy_seam, verify_machine

    tiny = StarkConfig(num_challenges=1, fri_config=FriConfig(
        rate_bits=2, cap_height=0, proof_of_work_bits=0, num_query_rounds=1,
        arity_bits=3, final_poly_bits=3))
    root = build_dummy_root(tiny)
    seam = dummy_seam(synthetic.noop_dummy(2))
    got = root.prove(seam, tiny, device=card)
    want = root.prove(seam, tiny, device="cpu")
    assert got.log_n == root.log_n == 8
    _assert_same(machine_proof_to_numpy(got), machine_proof_to_numpy(want))
    assert verify_machine(root.stark, got, tiny, device=card)
