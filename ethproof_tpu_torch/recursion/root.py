"""The tx ROOT circuit: verify a whole multi-table proof in one machine.

Counterpart: ethproof_tpu/recursion/root.py:1 (a copy). Every builder and
prover takes `device` (None: the CUDA card): a builder commits the
children's vkeys there (`stark.prove.fixed_cap`), a prover proves the
machine there. `phase_times`, when given, receives host seconds per step
under "host" ("compile" and "layout" for a builder; "witness",
"interpret" and "generate_trace" for a prover) and the machine proof's
phases under "machine".

Reference equivalent: proof_gen's `root` circuit — a plonky2 circuit that
verifies all 7 shrunk table proofs plus cross-table-lookup consistency,
producing the per-transaction `AggregatableProof::Txn`
(ops/src/lib.rs:52, circuit built at
common/src/prover_state/circuit.rs:200-206 [dep: from
knowledge of proof_gen 0.1.3]). The re-design compiles
`stark/multi.verify_multi` monolithically: the shared-challenger
pre-phase, each table's full STARK verification (via the shared
`Stark.eval` traced over wires), and the cross-table grand-product
consistency check all become one machine circuit whose 4-element public
digest D_tx = sponge(cpu table public inputs) is the transaction
statement fed to the aggregation ladder (recursion/aggregate.py).

A root circuit is determined by (cpu program shape, table sizes, stark
config) — the same parameters that key the reference's cached prover
state (common/src/prover_state/circuit.rs:177-197).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..fri.config import StarkConfig
from ..gf import field_host as fh
from ..hash import poseidon
from ..stark.multi import MultiProof, _instances_for_table
from ..tables.all import TableSizes, all_starks, build_ctls
from ..tables.cpu import CpuStark
from .machine import RecursionStark
from .verifier_circuit import (
    CircuitChallenger,
    VerifierCompiler,
    add_stark_verify,
    sponge_hash,
)
from .wrap import MachineProof, _elapsed, machine_degree, prove_circuit

P = fh.P


def tx_statement_digest(pi_limbs: List[int]) -> List[int]:
    """Host mirror of the root circuit's inner kernel digest D_tx."""
    return poseidon.hash_n_to_m_no_pad_host([int(x) % P for x in pi_limbs], 4)


# seam layout: (txn_before, txn_after, gas_before, gas_after,
#               root_pre limbs[16], root_post limbs[16]) — 36 words.
# This is the public-value sextuple the reference's aggregation circuit
# chains (ops/src/lib.rs:67-82); roots use the kernel's
# 16x16-bit little-endian limb encoding (tables/common.py) so the leaf
# circuit can equate them with the cpu table's own PI wires.
SEAM_WORDS = 4 + 16 + 16


def tx_seam(gi) -> List[int]:
    """Seam words for one real transaction, from its GenerationInputs."""
    from ..evm.kasm import le_word
    from ..tables.common import int_to_limbs

    return (
        [
            gi.txn_number_before,
            gi.txn_number_before + 1,
            gi.gas_used_before,
            gi.gas_used_after,
        ]
        + int_to_limbs(le_word(gi.tries.state_trie.hash()))
        + int_to_limbs(le_word(gi.trie_roots_after.state_root))
    )


def dummy_seam(gi) -> List[int]:
    """Seam words for a padding dummy: txn/gas FLAT (no increment);
    roots move only for the withdrawal-carrying dummy (reference
    padding_and_withdrawals.rs:89-134 credits balances in the final
    payload's trie state)."""
    from ..evm.kasm import le_word
    from ..tables.common import int_to_limbs

    return (
        [
            gi.txn_number_before,
            gi.txn_number_before,
            gi.gas_used_before,
            gi.gas_used_after,
        ]
        + int_to_limbs(le_word(gi.tries.state_trie.hash()))
        + int_to_limbs(le_word(gi.trie_roots_after.state_root))
    )


# domain tag distinguishing the no-op dummy's statement digest from any
# kernel digest (both are 4-word sponges)
DUMMY_TAG = int.from_bytes(b"ethproof-dummy-leaf", "big") % P


def dummy_statement_digest() -> List[int]:
    """Host mirror of the no-op dummy leaf's inner digest."""
    return poseidon.hash_n_to_m_no_pad_host([DUMMY_TAG], 4)


def leaf_statement(seam: List[int], digest: List[int]) -> List[int]:
    """Host mirror of the root circuit's exposed statement
    E = sponge(seam ++ D_tx)."""
    assert len(seam) == SEAM_WORDS and len(digest) == 4
    return poseidon.hash_n_to_m_no_pad_host(
        [int(x) % P for x in seam] + [int(x) % P for x in digest], 4
    )


def prove_filled(
    vc: VerifierCompiler,
    stark: RecursionStark,
    fill,
    public_inputs: List[int],
    config: StarkConfig,
    log_n: int,
    device=None,
    phase_times: Optional[Dict[str, Dict[str, float]]] = None,
) -> MachineProof:
    """The witness stream of `fill` (its host seconds under "witness"),
    then `prove_circuit` on `device`."""
    t0 = time.perf_counter()
    witness = vc.stream(fill)
    if phase_times is not None:
        _elapsed(phase_times.setdefault("host", {}), "witness", t0)
    return prove_circuit(stark, witness, public_inputs, config, log_n, device, phase_times)


def finish_build(vc: VerifierCompiler, t0: float, phase_times=None) -> Tuple[RecursionStark, int]:
    """Build the circuit compiled since `t0` and lay out its machine ->
    (stark, its machine degree); host seconds of "compile" and "layout"."""
    circuit = vc.b.build()
    host: Dict[str, float] = {}
    _elapsed(host, "compile", t0)
    t1 = time.perf_counter()
    stark = RecursionStark(circuit)
    _elapsed(host, "layout", t1)
    if phase_times is not None:
        phase_times.setdefault("host", {}).update(host)
    return stark, machine_degree(stark)


@dataclass
class _RootFill:
    """Fill context for a root circuit's witness stream."""

    multi: MultiProof
    seam: List[int]


@dataclass
class TxRootCircuit:
    """Compiled root: machine circuit verifying one MultiProof, exposing
    E = sponge(seam ++ D_tx). `seam_root_slices` records which cpu PI
    limb ranges the seam roots were wired to (None: witnessed — the EVM
    leaf until the binding proof is folded in).

    vc may be None for DISK-LOADED circuits (recursion/persist.py —
    the serialized program has no witness accessors); proving then
    lazily re-runs `rebuild` (the deterministic builder) once."""

    vc: Optional[VerifierCompiler]
    stark: RecursionStark
    log_n: int
    seam_root_slices: "Optional[Tuple[slice, slice]]" = None
    rebuild: Optional[object] = None  # () -> TxRootCircuit (full)

    def _ensure_vc(self) -> None:
        if self.vc is None:
            assert self.rebuild is not None, "loaded circuit without builder"
            self.vc = self.rebuild().vc

    def prove(
        self, multi: MultiProof, seam: List[int], config: StarkConfig, device=None,
        phase_times: Optional[Dict[str, Dict[str, float]]] = None,
    ) -> MachineProof:
        self._ensure_vc()
        digest = tx_statement_digest(multi.proofs[0].public_inputs)
        mp = prove_filled(
            self.vc, self.stark, _RootFill(multi=multi, seam=seam),
            leaf_statement(seam, digest), config, self.log_n, device, phase_times,
        )
        mp.seam = list(seam)
        mp.digest = digest
        return mp


def build_tx_root(
    cpu: CpuStark, sizes: TableSizes, config: StarkConfig, device=None,
    phase_times: Optional[Dict[str, Dict[str, float]]] = None,
) -> TxRootCircuit:
    """Compile the circuit verifying `prove_all_tables(cpu, ., sizes, .)`
    proofs. Mirrors verify_multi (stark/multi.py) exactly. The seam's
    state roots are wired to the transfer kernel's own root PI limbs
    (PI_STATE_ROOT_PRE/POST), so the exposed statement's roots are
    STARK-bound, not claimed."""
    from ..evm.transfer import PI_STATE_ROOT_POST, PI_STATE_ROOT_PRE
    from ..tables.common import N_LIMBS

    with_keccak = sizes.keccak is not None
    starks = all_starks(cpu, with_keccak)
    ctls = build_ctls(cpu, with_keccak)
    log_ns = sizes.degree_bits(with_keccak)
    slices = (
        slice(PI_STATE_ROOT_PRE * N_LIMBS, (PI_STATE_ROOT_PRE + 1) * N_LIMBS),
        slice(PI_STATE_ROOT_POST * N_LIMBS, (PI_STATE_ROOT_POST + 1) * N_LIMBS),
    )
    return _build_root(starks, ctls, log_ns, config, seam_root_slices=slices,
                       device=device, phase_times=phase_times)


def build_evm_root(
    machine, sizes: TableSizes, config: StarkConfig, device=None,
    phase_times: Optional[Dict[str, Dict[str, float]]] = None,
) -> TxRootCircuit:
    """Root circuit for the EVM machine's 7-table proofs
    (tables/evm.py + tables/all.build_ctls_evm): verifies a
    prove_evm_tables MultiProof and exposes the statement digest over
    the machine's public inputs (caller/callvalue/calldata/codehash/
    storage journal/success)."""
    from ..tables.all import build_ctls_evm

    starks = all_starks(machine, with_keccak=True)
    ctls = build_ctls_evm(machine)
    log_ns = [machine.shape.log_rows] + sizes.degree_bits(True)[1:]
    return _build_root(starks, ctls, log_ns, config, device=device,
                       phase_times=phase_times)


@dataclass
class _DummyFill:
    seam: List[int]


@dataclass
class DummyRootCircuit:
    """Leaf circuit for the NO-OP padding dummy: no inner proof at all —
    the statement E = sponge(seam ++ sponge(DUMMY_TAG)) with txn/gas
    FLAT and root_post == root_pre constrained in-circuit (the claim
    verify_dummy host-checks, reference padding_and_withdrawals.rs:
    170-178, now proved)."""

    vc: Optional[VerifierCompiler]
    stark: RecursionStark
    log_n: int
    rebuild: Optional[object] = None

    def _ensure_vc(self) -> None:
        if self.vc is None:
            assert self.rebuild is not None
            self.vc = self.rebuild().vc

    def prove(
        self, seam: List[int], config: StarkConfig, device=None,
        phase_times: Optional[Dict[str, Dict[str, float]]] = None,
    ) -> MachineProof:
        self._ensure_vc()
        digest = dummy_statement_digest()
        mp = prove_filled(
            self.vc, self.stark, _DummyFill(seam=seam), leaf_statement(seam, digest),
            config, self.log_n, device, phase_times,
        )
        mp.seam = list(seam)
        mp.digest = digest
        return mp


def build_dummy_root(
    config: StarkConfig, phase_times: Optional[Dict[str, Dict[str, float]]] = None
) -> DummyRootCircuit:
    t0 = time.perf_counter()
    vc = VerifierCompiler()
    b = vc.b
    seam = [
        vc.inp(lambda c, i=i: int(c.seam[i]) % P, f"seam[{i}]")
        for i in range(SEAM_WORDS)
    ]
    b.assert_eq(seam[1], seam[0], "txn-flat")
    b.assert_eq(seam[3], seam[2], "gas-flat")
    for i in range(16):
        b.assert_eq(seam[20 + i], seam[4 + i], f"root-flat[{i}]")
    dig = sponge_hash(b, [b.const(DUMMY_TAG)], 4)
    out = sponge_hash(b, seam + dig, 4)
    for k in range(4):
        b.expose(out[k], k, f"pi[{k}]")
    stark, log_n = finish_build(vc, t0, phase_times)
    return DummyRootCircuit(vc=vc, stark=stark, log_n=log_n)


def build_withdrawal_root(
    n: int, kshape, sizes: TableSizes, config: StarkConfig, device=None,
    phase_times: Optional[Dict[str, Dict[str, float]]] = None,
) -> TxRootCircuit:
    """Root circuit for a withdrawal-carrying dummy: verifies the
    withdrawal kernel's multi-proof (evm/withdrawal.py) and exposes the
    dummy statement with seam roots WIRED to the kernel's own root PI
    limbs — withdrawal credits leave the host tier."""
    from ..evm.withdrawal import (
        WD_ROOT_POST,
        WD_ROOT_PRE,
        build_withdrawal_kernel,
        wd_num_pi_words,
    )
    from ..tables.common import N_LIMBS

    kasm = build_withdrawal_kernel(n, kshape)
    cpu = CpuStark(kasm.prog, wd_num_pi_words(n))
    with_keccak = sizes.keccak is not None
    assert with_keccak, "the withdrawal kernel hashes MPT nodes"
    starks = all_starks(cpu, with_keccak)
    ctls = build_ctls(cpu, with_keccak)
    log_ns = sizes.degree_bits(with_keccak)
    slices = (
        slice(WD_ROOT_PRE * N_LIMBS, (WD_ROOT_PRE + 1) * N_LIMBS),
        slice(WD_ROOT_POST * N_LIMBS, (WD_ROOT_POST + 1) * N_LIMBS),
    )
    return _build_root(
        starks, ctls, log_ns, config, seam_root_slices=slices,
        flat_seam=True, device=device, phase_times=phase_times,
    )


def _build_root(
    starks, ctls, log_ns, config: StarkConfig, seam_root_slices=None,
    flat_seam: bool = False, device=None,
    phase_times: Optional[Dict[str, Dict[str, float]]] = None,
) -> TxRootCircuit:
    assert len(log_ns) == len(starks)
    nc = config.num_challenges

    t0 = time.perf_counter()
    vc = VerifierCompiler()
    b = vc.b
    ch = CircuitChallenger(b)
    zero = b.const(0)

    # --- pre-phase (multi.py _pre_phase) ---
    ch.observe(b.const(len(starks)))
    table_pis: List[List] = []
    table_caps: List = []
    for t, (stark, log_n) in enumerate(zip(starks, log_ns)):
        pis_t = [
            vc.inp(
                lambda c, t=t, k=k: int(c.multi.proofs[t].public_inputs[k]) % P,
                f"pis[{t}][{k}]",
            )
            for k in range(stark.num_public_inputs)
        ]
        ch.observe_many(pis_t)
        ch.observe(b.const(log_n))
        cap_t = vc.inp_cap(
            lambda c, t=t: c.multi.proofs[t].trace_cap,
            config.fri_config.cap_height,
            f"cap[{t}]",
        )
        ch.observe_cap(cap_t)
        table_pis.append(pis_t)
        table_caps.append(cap_t)

    challenges = [(ch.get_challenge(), ch.get_challenge()) for _ in range(nc)]
    challenges_ext = [((bt, zero), (gm, zero)) for bt, gm in challenges]

    # --- per-table verification on the shared challenger ---
    looking_prod: Dict[Tuple[int, int], object] = {}
    looked_val: Dict[Tuple[int, int], object] = {}
    for t, (stark, log_n) in enumerate(zip(starks, log_ns)):
        instances, labels = _instances_for_table(t, ctls, challenges_ext)
        spec_ch = [(i.spec, i.beta, i.gamma) for i in instances]
        wires = add_stark_verify(
            vc, stark, log_n, config, ch, table_pis[t],
            proof_of=lambda c, t=t: c.multi.proofs[t],
            ctl_specs_with_challenges=spec_ch or None,
            trace_cap=table_caps[t],
            device=device,
        )
        for (ci, hi, role, _pos, _t), total in zip(labels, wires.ctl_totals):
            key = (ci, hi)
            if role == "looking":
                prev = looking_prod.get(key)
                looking_prod[key] = total if prev is None else b.mul(prev, total)
            else:
                looked_val[key] = total

    # --- cross-table multiset equality (multi.py verify_multi tail) ---
    one = b.const(1)
    for ci in range(len(ctls)):
        for hi in range(nc):
            key = (ci, hi)
            b.assert_eq(
                looking_prod.get(key, one),
                looked_val.get(key, one),
                f"ctl-product[{ci}][{hi}]",
            )

    # --- leaf statement: E = sponge(seam ++ D_tx) ---
    # D_tx digests the kernel's public inputs; the seam carries the
    # aggregation sextuple. txn/gas words are witnessed (bound into E;
    # re-derived from the witness by the host verifier); t_after is
    # constrained = t_before + 1 (a real tx); the roots are the kernel's
    # own root PI limb wires when seam_root_slices names them (transfer),
    # else witnessed (EVM leaf — binding-proof fold pending).
    digest = sponge_hash(b, table_pis[0], 4)
    seam_scalars = [
        vc.inp(lambda c, i=i: int(c.seam[i]) % P, f"seam[{i}]")
        for i in range(4)
    ]
    if flat_seam:
        # padding dummy: no txn, no gas (withdrawal credits only)
        b.assert_eq(seam_scalars[1], seam_scalars[0], "txn-flat")
        b.assert_eq(seam_scalars[3], seam_scalars[2], "gas-flat")
    else:
        b.assert_eq(
            seam_scalars[1], b.add(seam_scalars[0], b.const(1)),
            "txn-increment",
        )
    if seam_root_slices is not None:
        pre_sl, post_sl = seam_root_slices
        root_wires = list(table_pis[0][pre_sl]) + list(table_pis[0][post_sl])
    else:
        root_wires = [
            vc.inp(lambda c, i=i: int(c.seam[4 + i]) % P, f"seam_root[{i}]")
            for i in range(32)
        ]
    statement = sponge_hash(b, seam_scalars + root_wires + digest, 4)
    for k in range(4):
        b.expose(statement[k], k, f"pi[{k}]")

    stark, log_n = finish_build(vc, t0, phase_times)
    return TxRootCircuit(
        vc=vc, stark=stark, log_n=log_n, seam_root_slices=seam_root_slices,
    )
