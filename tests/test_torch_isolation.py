"""The port imports neither JAX nor the JAX package, and its entry points
refuse to run off the card unless the caller asks for the CPU."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "ethproof_tpu_torch",
    "ethproof_tpu_torch.interop",
    "ethproof_tpu_torch.kernels",
    "ethproof_tpu_torch.gf.field_host",
    "ethproof_tpu_torch.gf.field",
    "ethproof_tpu_torch.gf.extension",
    "ethproof_tpu_torch.poly.ntt",
    "ethproof_tpu_torch.poly.base_dft",
    "ethproof_tpu_torch.poly.four_step",
    "ethproof_tpu_torch.hash.constants",
    "ethproof_tpu_torch.hash.poseidon",
    "ethproof_tpu_torch.hash.merkle",
    "ethproof_tpu_torch.fri.config",
    "ethproof_tpu_torch.fri.challenger",
    "ethproof_tpu_torch.fri.prove",
    "ethproof_tpu_torch.fri.verify",
    "ethproof_tpu_torch.stark.stark",
    "ethproof_tpu_torch.stark.prove",
    "ethproof_tpu_torch.stark.verify",
    "ethproof_tpu_torch.tables.common",
    "ethproof_tpu_torch.tables.memory",
    "ethproof_tpu_torch.runtime.tracing",
    "ethproof_tpu_torch.hash.keccak",
    "ethproof_tpu_torch.trie",
    "ethproof_tpu_torch.trie.rlp",
    "ethproof_tpu_torch.trie.nibbles",
    "ethproof_tpu_torch.trie.trie",
    "ethproof_tpu_torch.witness",
    "ethproof_tpu_torch.witness.types",
    "ethproof_tpu_torch.witness.mpt",
    "ethproof_tpu_torch.witness.synthetic",
    "ethproof_tpu_torch.evm",
    "ethproof_tpu_torch.evm.secp256k1",
    "ethproof_tpu_torch.evm.tx",
    "ethproof_tpu_torch.evm.gas",
    "ethproof_tpu_torch.evm.kasm",
    "ethproof_tpu_torch.evm.transfer",
    "ethproof_tpu_torch.stark.multi",
    "ethproof_tpu_torch.tables",
    "ethproof_tpu_torch.tables.keccak_sponge",
    "ethproof_tpu_torch.tables.logic",
    "ethproof_tpu_torch.tables.arithmetic",
    "ethproof_tpu_torch.tables.bytepacking",
    "ethproof_tpu_torch.tables.cpu",
    "ethproof_tpu_torch.tables.all",
    "ethproof_tpu_torch.tables.keccak",
    "ethproof_tpu_torch.runtime.parsing",
    "ethproof_tpu_torch.runtime.prover_state",
    "ethproof_tpu_torch.evm.binding",
    "ethproof_tpu_torch.stark.ir",
    "ethproof_tpu_torch.tables.evm",
    "ethproof_tpu_torch.evm.erc20",
    "ethproof_tpu_torch.evm.cbinding",
    "ethproof_tpu_torch.evm.contract",
    "ethproof_tpu_torch.runtime.ops",
    "ethproof_tpu_torch.tables.poseidon_table",
    "ethproof_tpu_torch.recursion",
    "ethproof_tpu_torch.recursion.circuit",
    "ethproof_tpu_torch.recursion.ops_circuit",
    "ethproof_tpu_torch.recursion.machine",
    "ethproof_tpu_torch.recursion.verifier_circuit",
    "ethproof_tpu_torch.recursion.wrap",
    "ethproof_tpu_torch.parallel",
    "ethproof_tpu_torch.parallel.mesh",
    "ethproof_tpu_torch.recursion.persist",
    "ethproof_tpu_torch.recursion.root",
    "ethproof_tpu_torch.recursion.aggregate",
    "ethproof_tpu_torch.recursion.block",
    "ethproof_tpu_torch.recursion.state",
    "ethproof_tpu_torch.evm.withdrawal",
    "ethproof_tpu_torch.witness.padding",
    "ethproof_tpu_torch.witness.gather",
    "ethproof_tpu_torch.runtime.serde",
    "ethproof_tpu_torch.runtime.scheduler",
    "ethproof_tpu_torch.runtime.distributed",
    "ethproof_tpu_torch.cli",
]


def test_imports_without_jax_or_reference_package():
    code = textwrap.dedent(
        f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["ethproof_tpu"] = None
        for name in {MODULES!r}:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "ethproof_tpu") and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
        """
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _cuda_absent():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid")


def test_default_device_raises_without_cuda():
    _cuda_absent()
    from ethproof_tpu_torch import resolve_device
    from ethproof_tpu_torch.gf import field as gfp

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gfp.from_u64(np.arange(4, dtype=np.uint64))
    assert gfp.from_u64(np.arange(4, dtype=np.uint64), "cpu").device.type == "cpu"


def test_stark_prove_and_grind_refuse_the_cpu_by_default():
    _cuda_absent()
    from ethproof_tpu_torch.fri.config import StarkConfig
    from ethproof_tpu_torch.fri.prove import grind_pow
    from ethproof_tpu_torch.stark.prove import stark_prove
    from ethproof_tpu_torch.tables import memory as mem

    trace = mem.generate_trace([mem.MemoryOp(0, 1, 2, 1, 0, 5)], 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stark_prove(mem.MemoryStark(), trace, [], StarkConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        grind_pow(123, 2)


def test_base_dft_rejects_what_the_kernel_does_not_take():
    from ethproof_tpu_torch.poly.base_dft import base_dft

    a = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError):
        base_dft(a, 9, False)
    with pytest.raises(ValueError):
        base_dft(a, 2, False)
    with pytest.raises(TypeError):
        base_dft(a.to(torch.int32), 3, False)
    # the kernels read 16 bytes a lane: the launcher refuses a contiguous
    # tensor whose data does not start on a 16-byte boundary (a slice a[1:]
    # of a flat tensor, reshaped), and a non-contiguous one, before it
    # builds or loads anything
    from ethproof_tpu_torch.poly import base_dft as bd

    misaligned = torch.zeros(1 + 4 * 8, dtype=torch.int64)[1:].view(4, 8)
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16 == 8
    before = dict(bd.LAUNCHES)
    for encoding in bd.ENCODINGS:
        with pytest.raises(ValueError, match="16-byte aligned"):
            bd._launch(misaligned, 3, False, encoding)
        with pytest.raises(ValueError, match="contiguous"):
            bd._launch(torch.zeros((8, 4), dtype=torch.int64).T, 3, False, encoding)
    assert bd.LAUNCHES == before


def test_prove_transfer_refuses_the_cpu_by_default():
    _cuda_absent()
    from ethproof_tpu_torch.evm.transfer import prove_transfer
    from ethproof_tpu_torch.fri.config import StarkConfig
    from ethproof_tpu_torch.tables.all import TableSizes
    from ethproof_tpu_torch.witness import synthetic
    
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prove_transfer(synthetic.small_transfer(), StarkConfig(), TableSizes(keccak=None))


def test_contract_call_entry_points_refuse_the_cpu_by_default():
    """`tx_proof` (a transfer and a contract call), `prove_contract_call`
    and `verify_contract_call` raise before any work without a card unless
    the caller passes device="cpu"."""
    _cuda_absent()
    from ethproof_tpu_torch.evm import contract
    from ethproof_tpu_torch.fri.config import StarkConfig
    from ethproof_tpu_torch.runtime import ops
    from ethproof_tpu_torch.witness import synthetic

    call = synthetic.small_erc20_transfer()
    for gi in (synthetic.small_transfer(), call):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ops.tx_proof(gi, StarkConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        contract.prove_contract_call(call, StarkConfig())
    shape, _, res = contract.machine_inputs_for_tx(call)
    unproved = contract.ContractCallProof(
        multi=None, shape=shape, machine_pi=list(res.pi_words), gen_inputs=call,
        sender=b"", to=b"", miner=b"", gas_used=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        contract.verify_contract_call(unproved, StarkConfig())


def test_recursion_entry_points_refuse_the_cpu_by_default():
    """`recursion_state`, `tx_proof(recursion=...)` and `verify_block` raise
    before any work without a card unless the caller passes device="cpu";
    a state made for the CPU is its own cache entry."""
    _cuda_absent()
    from ethproof_tpu_torch.recursion.state import recursion_state
    from ethproof_tpu_torch.runtime import ops
    from ethproof_tpu_torch.fri.config import StarkConfig
    from ethproof_tpu_torch.tables.all import TableSizes
    from ethproof_tpu_torch.witness import synthetic

    sizes = TableSizes(keccak=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        recursion_state(sizes, StarkConfig())
    state = recursion_state(sizes, StarkConfig(), device="cpu")
    assert state.device == torch.device("cpu") and not state.roots
    assert recursion_state(sizes, StarkConfig(), device="cpu") is state
    for gi in (synthetic.transfer_chain(1)[0], synthetic.noop_dummy(1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ops.tx_proof(gi, StarkConfig(), sizes, recursion=state)
    assert not state.roots and state._dummy_root is None
    gi = synthetic.noop_dummy(1)
    bp = ops.block_proof(ops.agg_combine(ops.DummyProof(gi), ops.DummyProof(gi)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.verify_block(bp, StarkConfig(), recursion=state)
    assert ops.verify_block(bp, StarkConfig(), device="cpu")


def test_block_pipeline_refuses_the_cpu_by_default():
    """prove_block, verify_block and a worker take device=None as the card."""
    _cuda_absent()
    from ethproof_tpu_torch.fri.config import StarkConfig
    from ethproof_tpu_torch.runtime import ops, scheduler
    from ethproof_tpu_torch.runtime.distributed import worker_main_loop
    from ethproof_tpu_torch.witness import synthetic

    gi = synthetic.noop_dummy(1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scheduler.prove_block([gi, gi], StarkConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scheduler.Runtime().run_tasks([("echo", {"value": 1})])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        worker_main_loop(("127.0.0.1", 1), reconnect=0)
    bp = scheduler.prove_block([gi, gi], StarkConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.verify_block(bp, StarkConfig())
    assert ops.verify_block(bp, StarkConfig(), device="cpu")


def test_unknown_ntt_encoding_raises():
    """ETHPROOF_NTT_ENCODING takes "i8" (the default) or "bf16", as the JAX
    package's switch does; any other value fails when the module loads."""
    code = "import ethproof_tpu_torch.poly.base_dft as b; print(b.ENCODING)"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    for value, ok in (("bf16", True), ("i8", True), ("fp8", False)):
        env["ETHPROOF_NTT_ENCODING"] = value
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert (out.returncode == 0) == ok, out.stderr
        if ok:
            assert out.stdout.strip() == value
        else:
            assert "fp8" in out.stderr
    env.pop("ETHPROOF_NTT_ENCODING")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "i8", out.stderr
