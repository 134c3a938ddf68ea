"""The CLI (`python -m ethproof_tpu_torch.cli`): the port vs the JAX
package's `ethproof_tpu.cli`.

The parsers have the same subcommands and flags, plus `--device {cuda,cpu}`
on `prove`, `verify` and `worker`; `.env` and environment variables resolve
as the reference's; `rpc` over tests/test_witness.py's fake chain prints the
same witness; `prove --device cpu` of tests/test_runtime.py's empty block
prints the same proof as the reference's `prove`; `verify` accepts it and
refuses a tampered file; without a card and without `--device cpu`, `prove`
exits non-zero and prints no proof. Marked `slow` (a seven-table proof at
`standard_fast_config` on the CPU): `prove --device cpu` of a padded CPU-tier
transfer, whose decoded proof equals the port's own `tx_proof` of it field
for field and which `verify --device cpu` accepts.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from ethproof_tpu import cli as jcli
from ethproof_tpu.runtime import prover_state as jps
from ethproof_tpu.witness import gather as jgather
from ethproof_tpu.witness.types import witness_to_json as j_witness_to_json
from ethproof_tpu_torch import cli as tcli
from ethproof_tpu_torch.runtime import prover_state as tps
from ethproof_tpu_torch.witness import gather as tgather
from test_runtime import _empty_block_ir
from test_witness import FakeRpc

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)

DEVICE_CMDS = ("prove", "verify", "worker")


@pytest.fixture
def fresh_states():
    """Both packages' once-initialized prover states, reset around a test."""
    tps.reset_prover_state()
    jps.reset_prover_state()
    yield
    tps.reset_prover_state()
    jps.reset_prover_state()


def _flags(parser):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {
        name: {tuple(a.option_strings): (a.dest, a.default, a.choices, a.required,
                                         type(a).__name__)
               for a in p._actions if a.option_strings and a.dest != "help"}
        for name, p in sub.choices.items()
    }


def test_parser_matches_reference_plus_device():
    got, want = _flags(tcli.build_parser()), _flags(jcli.build_parser())
    assert got.keys() == want.keys() == {"rpc", "prove", "verify", "worker"}
    for name in want:
        extra = {k: v for k, v in got[name].items() if k not in want[name]}
        assert {k: got[name][k] for k in want[name]} == want[name], name
        if name in DEVICE_CMDS:
            assert extra == {("--device",): ("device", "cuda", ["cuda", "cpu"], False,
                                             "_StoreAction")}
        else:
            assert extra == {}


def test_dotenv_and_env_resolution(tmp_path, monkeypatch):
    for key in ("CPU_CIRCUIT_SIZE", "LOGIC_CIRCUIT_SIZE", "MEMORY_CIRCUIT_SIZE"):
        monkeypatch.setenv(key, "0..1")  # recorded, so the test restores the environment
        monkeypatch.delenv(key)
    monkeypatch.setenv("MEMORY_CIRCUIT_SIZE", "18..20")
    (tmp_path / ".env").write_text(
        "# circuit sizes\nCPU_CIRCUIT_SIZE = 5..9\nLOGIC_CIRCUIT_SIZE=6..8\n"
        "MEMORY_CIRCUIT_SIZE=19..21\nnot a setting\n")
    monkeypatch.chdir(tmp_path)
    tcli._load_dotenv()
    # .env fills what the environment does not set, and no more
    assert os.environ["CPU_CIRCUIT_SIZE"] == "5..9"
    assert os.environ["MEMORY_CIRCUIT_SIZE"] == "18..20"
    argv = ["prove", "-i", "w.json", "--logic-circuit-size", "7..9"]
    got = tcli._resolve_config(tcli.build_parser().parse_args(argv))
    want = jcli._resolve_config(jcli.build_parser().parse_args(argv))
    assert got.ranges == want.ranges
    # flag, then env (.env included), then the default
    assert got.ranges["logic"] == range(7, 9)
    assert got.ranges["cpu"] == range(5, 9)
    assert got.ranges["memory"] == range(18, 20)
    assert got.ranges["keccak"] == tps.DEFAULT_RANGES["keccak"]
    assert got.digest() == want.digest()


def test_rpc_prints_the_reference_witness(monkeypatch, capsys):
    chain = FakeRpc()
    for mod in (tgather, jgather):
        cls = mod.RpcClient
        monkeypatch.setattr(mod, "RpcClient",
                            lambda url, cls=cls: cls(url, transport=chain.transport))
    argv = ["rpc", "-u", "fake://", "-t", chain.tx_hash]
    assert tcli.main(argv) == 0
    got = capsys.readouterr().out
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert got == want and len(json.loads(got)) == 2


def _write_empty_block_witness(tmp_path):
    path = tmp_path / "witness.json"
    path.write_text(json.dumps(j_witness_to_json(_empty_block_ir())))
    return str(path)


def test_prove_and_verify_the_empty_block(tmp_path, capsys, fresh_states):
    witness = _write_empty_block_witness(tmp_path)
    argv = ["prove", "-i", witness, "--persistence", "none"]
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert got == want
    assert not list(tmp_path.glob("prover_state_*"))

    proof = tmp_path / "proof.json"
    proof.write_text(got)
    assert tcli.main(["verify", "-i", str(proof), "--device", "cpu"]) == 0
    assert "valid" in capsys.readouterr().err
    d = json.loads(got)
    d["agg"]["state_root_after"] = "00" * 32
    proof.write_text(json.dumps(d))
    assert tcli.main(["verify", "-i", str(proof), "--device", "cpu"]) == 1
    assert "INVALID" in capsys.readouterr().err


def test_prove_without_a_card_exits_nonzero(tmp_path, capsys, fresh_states):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid")
    witness = _write_empty_block_witness(tmp_path)
    for argv in (["prove", "-i", witness, "--persistence", "none"],
                 ["verify", "-i", witness]):
        assert tcli.main(argv) != 0
        out, err = capsys.readouterr()
        assert out == "" and "--device cpu" in err
    with pytest.raises(RuntimeError, match="before initialization"):
        tps.p_state()  # the command stopped before initializing anything


# the CPU tier's seven-table sizes (tests/test_transfer_e2e.py:SIZES7),
# given as ranges whose floor each table fits
SIZE_FLAGS = ["--cpu-circuit-size", "5..7", "--arithmetic-circuit-size", "6..8",
              "--logic-circuit-size", "4..6", "--byte-packing-circuit-size", "9..11",
              "--memory-circuit-size", "7..9", "--keccak-circuit-size", "5..7",
              "--keccak-sponge-circuit-size", "8..10"]


@pytest.mark.slow
def test_prove_a_padded_transfer_on_the_cpu(tmp_path, capsys, fresh_states):
    from ethproof_tpu_torch.fri.config import standard_fast_config
    from ethproof_tpu_torch.interop import multi_proof_to_numpy
    from ethproof_tpu_torch.runtime import ops, serde
    from ethproof_tpu_torch.witness import padding, synthetic
    from ethproof_tpu_torch.witness.types import witness_to_json
    from test_torch_stark import assert_same

    torch.set_num_threads(4)
    gi = synthetic.small_transfer()
    tries = padding.PartialTrieState(state=gi.tries.state_trie)
    extra = padding.ExtraBlockData(checkpoint_state_trie_root=gi.checkpoint_state_trie_root)
    ir = [gi]
    padding.pad_gen_inputs_with_dummy_inputs_if_needed(
        ir, gi.block_metadata, gi.block_hashes, extra, extra, tries, tries, False)
    assert [g.signed_txn is None for g in ir] == [True, False]
    witness = tmp_path / "witness.json"
    witness.write_text(json.dumps(witness_to_json(ir)))

    assert tcli.main(["prove", "-i", str(witness), "--persistence", "none", "--device", "cpu"]
                     + SIZE_FLAGS) == 0
    text = capsys.readouterr().out
    bp = serde.block_proof_from_json(json.loads(text))
    leaf = bp.agg.right
    config = tcli._resolve_config(tcli.build_parser().parse_args(
        ["prove", "-i", "-"] + SIZE_FLAGS))
    want = ops.tx_proof(gi, standard_fast_config(), config, device="cpu")
    assert len(want.multi.proofs) == 7 and want.binding_shape is None
    for p in want.multi.proofs:
        p.fri_proof.query_indices = None  # not on the wire
    assert_same(multi_proof_to_numpy(leaf.multi), multi_proof_to_numpy(want.multi))
    assert leaf.pi_words == want.pi_words
    assert np.all([p.degree_bits for p in leaf.multi.proofs] == np.array([5, 6, 4, 9, 7, 5, 8]))

    proof = tmp_path / "proof.json"
    proof.write_text(text)
    assert tcli.main(["verify", "-i", str(proof), "--device", "cpu"]) == 0
