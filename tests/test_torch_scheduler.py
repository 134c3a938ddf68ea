"""The block pipeline and the prover state: the port vs the JAX package.

`CircuitConfig.digest` and the prover state (once-init, reset, the order in
which `artifact_dir` resolves), `tree_fold`, `Runtime`'s retry and fatal
semantics, and `prove_block` on tests/test_runtime.py's empty block (two
padding dummies, no STARK): both packages give the same proof JSON, it
verifies, a seam mismatch is rejected, discontinuous payloads raise
`FatalError` and blocks chain. `_fit_block_sizes` equals the reference's on
the CPU tier's transfers (without a binding shape).
"""

import json

import pytest
import torch

from ethproof_tpu.runtime import prover_state as jps
from ethproof_tpu.runtime import scheduler as jsch
from ethproof_tpu.runtime import serde as jserde
from ethproof_tpu.witness.types import witness_to_json as j_witness_to_json
from ethproof_tpu_torch.fri.config import standard_fast_config
from ethproof_tpu_torch.hash.keccak import keccak256
from ethproof_tpu_torch.runtime import distributed as tdist
from ethproof_tpu_torch.runtime import ops as tops
from ethproof_tpu_torch.runtime import prover_state as tps
from ethproof_tpu_torch.runtime import scheduler as tsch
from ethproof_tpu_torch.runtime import serde as tserde
from ethproof_tpu_torch.witness import synthetic
from ethproof_tpu_torch.witness.types import witness_from_json
from test_runtime import CFG, _empty_block_ir

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)

T_CFG = standard_fast_config()
ENV = {"MEMORY_CIRCUIT_SIZE": "17..30", "CPU_CIRCUIT_SIZE": "5..9"}


def empty_block_ir():
    """tests/test_runtime.py's empty block, in the port's types."""
    return witness_from_json(json.loads(json.dumps(j_witness_to_json(_empty_block_ir()))))


@pytest.fixture
def fresh_state():
    tps.reset_prover_state()
    yield
    tps.reset_prover_state()


@pytest.mark.parametrize("env", [{}, ENV])
def test_circuit_config_digest_equals_reference(env):
    t, j = tps.CircuitConfig.from_env(env), jps.CircuitConfig.from_env(env)
    assert t.ranges == j.ranges
    assert t.digest() == j.digest()
    assert len(t.digest()) == 16


def test_prover_state_once_init_reset_and_artifact_dir(fresh_state, tmp_path, monkeypatch):
    env_dir = tmp_path / "env"
    monkeypatch.setenv("ETHPROOF_ARTIFACT_DIR", str(env_dir))
    with pytest.raises(RuntimeError, match="before initialization"):
        tps.p_state()
    # no state: the environment's directory, created on first use
    assert tps.artifact_dir() == str(env_dir) and env_dir.is_dir()
    # persistence "none": no cache dir, so the environment's still applies
    st = tps.set_prover_state_from_config(tps.CircuitConfig(), "none", str(tmp_path))
    assert st.cache_dir is None and tps.p_state() is st
    assert tps.artifact_dir() == str(env_dir)
    tps.reset_prover_state()
    # persistence "disk": <base>/prover_state_<digest>, ahead of the environment
    cfg = tps.CircuitConfig.from_env(ENV)
    st = tps.set_prover_state_from_config(cfg, "disk", str(tmp_path))
    want = tmp_path / f"prover_state_{cfg.digest()}"
    assert st.cache_dir == str(want) and want.is_dir()
    assert tps.artifact_dir() == str(want)
    # once-init: a second call returns the first state
    assert tps.set_prover_state_from_config(tps.CircuitConfig(), "none", str(tmp_path)) is st
    tps.reset_prover_state()
    monkeypatch.delenv("ETHPROOF_ARTIFACT_DIR")
    assert tps.artifact_dir() is None
    with pytest.raises(ValueError):
        tps.set_prover_state_from_config(cfg, "xla", str(tmp_path))


def test_tree_fold_order_equals_reference():
    def combine(a, b):
        return f"({a}{b})"

    for n in range(1, 10):
        leaves = [chr(ord("a") + i) for i in range(n)]
        got = tsch.tree_fold(combine, leaves)
        assert got == jsch.tree_fold(combine, leaves)
        assert got.replace("(", "").replace(")", "") == "".join(leaves)
    assert tsch.tree_fold(combine, list("abcde")) == "(((ab)(cd))e)"


def test_runtime_retries_transient_failures_and_not_fatal_ones(monkeypatch):
    sleeps = []
    monkeypatch.setattr(tsch.time, "sleep", sleeps.append)
    calls = []

    def flaky(x):
        calls.append(x)
        if calls.count(x) <= 2:
            raise RuntimeError("transient")
        return 10 * x

    assert tsch.Runtime(max_retries=2).map(flaky, [1, 2]) == [10, 20]
    assert calls == [1, 1, 1, 2, 2, 2] and sleeps == [1.0, 2.0, 1.0, 2.0]

    calls.clear()
    with pytest.raises(RuntimeError, match="transient"):
        tsch.Runtime(max_retries=1).map(flaky, [3])
    assert calls == [3, 3]

    calls.clear()
    with pytest.raises(RuntimeError, match="transient"):
        tsch.Runtime(max_retries=0).map(flaky, [4])
    assert calls == [4]

    def fatal(x):
        calls.append(x)
        raise tops.FatalError("deterministic")

    calls.clear()
    with pytest.raises(tops.FatalError):
        tsch.Runtime(num_workers=2, max_retries=5).map(fatal, [5, 6])
    # no retry (the pool may cancel the second task once the first raised)
    assert calls.count(5) == 1 and calls.count(6) <= 1

    # registry tasks in-process, results in task order, over two threads
    tasks = [("echo", {"value": i}) for i in range(7)]
    assert tsch.Runtime(num_workers=2).run_tasks(tasks, device="cpu") == list(range(7))
    with pytest.raises(tops.FatalError, match="boom"):
        tsch.Runtime().run_tasks([("echo", {"fatal": True, "msg": "boom"})], device="cpu")


def test_run_tasks_refuse_torch_tensors(monkeypatch):
    """Tasks cross processes pickled: a tensor in a payload or a result is
    a fault, raised as FatalError (not retried)."""
    with pytest.raises(tops.FatalError, match=r"payload holds a torch tensor at \['value'\]"):
        tsch.Runtime().run_tasks([("echo", {"value": torch.zeros(2)})], device="cpu")
    monkeypatch.setitem(tdist.REGISTRY, "tensor", lambda payload, device: [1, torch.zeros(2)])
    with pytest.raises(tops.FatalError, match=r"result holds a torch tensor at \[1\]"):
        tsch.Runtime().run_tasks([("tensor", {})], device="cpu")


def test_empty_block_equals_reference():
    j_bp = jsch.prove_block(_empty_block_ir(), CFG, runtime=jsch.Runtime(num_workers=2))
    t_bp = tsch.prove_block(empty_block_ir(), T_CFG, runtime=tsch.Runtime(num_workers=2),
                            device="cpu")
    t_json = json.dumps(tserde.block_proof_to_json(t_bp))
    assert t_json == json.dumps(jserde.block_proof_to_json(j_bp))
    assert tops.verify_block(t_bp, T_CFG, device="cpu")
    assert t_bp.state_root_before == t_bp.state_root_after
    back = tserde.block_proof_from_json(json.loads(t_json))
    assert tops.verify_block(back, T_CFG, device="cpu")


def test_seam_mismatch_rejected():
    bp = tsch.prove_block(empty_block_ir(), T_CFG, device="cpu")
    bp.agg.right.gen_inputs.trie_roots_after.state_root = keccak256(b"x")
    assert not tops.verify_block(bp, T_CFG, device="cpu")


def test_prover_rejects_discontinuous_payloads():
    bad = empty_block_ir()
    bad[0].trie_roots_after.state_root = keccak256(b"y")
    with pytest.raises(tops.FatalError):
        tsch.prove_block(bad, T_CFG, device="cpu")


def test_block_chaining():
    bp1 = tsch.prove_block(empty_block_ir(), T_CFG, device="cpu")
    bp2 = tsch.prove_block(empty_block_ir(), T_CFG, prev=bp1, device="cpu")
    assert bp2.parent is bp1
    assert tops.verify_block(bp2, T_CFG, device="cpu")
    bp1.state_root_after = keccak256(b"z")
    assert not tops.verify_block(bp2, T_CFG, device="cpu")


@pytest.mark.parametrize("env", [{}, {"CPU_CIRCUIT_SIZE": "5..9", "MEMORY_CIRCUIT_SIZE": "7..9",
                                     "ARITHMETIC_CIRCUIT_SIZE": "6..9", "LOGIC_CIRCUIT_SIZE": "4..9",
                                     "BYTE_PACKING_CIRCUIT_SIZE": "9..12"}])
def test_fit_block_sizes_equals_reference(env):
    gis = [synthetic.small_transfer()] + synthetic.transfer_chain(2) + [synthetic.noop_dummy(2)]
    j_gis = [type(_empty_block_ir()[0]).from_json(gi.to_json()) for gi in gis]
    t = tsch._fit_block_sizes(gis, tps.CircuitConfig.from_env(env))
    j = jsch._fit_block_sizes(j_gis, jps.CircuitConfig.from_env(env))
    assert vars(t) == vars(j)
