"""Aggregation ladder: per-level agg circuits over machine proofs.

Counterpart: ethproof_tpu/recursion/aggregate.py:1 (a copy). An
`AggLadder` holds the `device` (None: the CUDA card) on which its circuits
commit their children's vkeys and prove; `build_agg`, `AggCircuit.prove`
take `device` and `phase_times` (see recursion/root.py), and
`fold_proofs` records each agg proof's times by level.

Reference equivalent: proof_gen's aggregation circuit — verify two child
(root-or-agg) proofs in one plonky2 circuit — and the leader's binary
tree fold over it (ops/src/lib.rs:67-82, leader/src/prover.rs:26-36). The
re-design avoids plonky2's cyclic self-verification: the ladder is a
PER-LEVEL family of circuits (level k verifies two level k-1 machine
proofs), built lazily and cached — the direct analogue of the reference's
per-degree circuit ladders living in the cached prover state
(common/src/prover_state/circuit.rs:77-100).

Leaf lists are padded to a power of two by REPEATING the last leaf proof
(the analogue of the reference's dummy-padding to >= 2 leaves,
leader/src/padding_and_withdrawals.rs:38-80 — repeating an already-proven
statement needs no dummy circuits, and the verifier replays the padding
in its host digest computation).

Statement algebra (recursion/root.py layout; E = sponge(seam ++ D)):
  leaf:  E_tx = sponge(seam_tx ++ D_tx)       (exposed by the root circuit)
  agg:   seam = chain(seam_L, seam_R), D = two_to_one(D_L, D_R),
         E = sponge(seam ++ D)
where chain REQUIRES, in-circuit, left.after == right.before for
(txn number, gas, state root) — the reference aggregation circuit's
public-value continuity (ops/src/lib.rs:67-82). A witnessed, bool-checked
`pad` bit handles the fold's repeat-padding: pad=1 instead requires
E_L == E_R (the right child replays the left's statement) and carries the
left seam through. Both children's (seam, D) preimages enter as witness
wires bound to the child proofs by recomputing each child's exposed E
in-circuit.

A block verifier therefore checks ONE machine proof and re-derives the
expected statement tree from the per-tx statements by host hashing —
cost independent of transaction count beyond O(#tx) host Poseidon calls,
and proof size constant in the number of transactions.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..fri.config import StarkConfig
from ..gf import field_host as fh
from ..hash import poseidon
from .machine import RecursionStark
from .root import SEAM_WORDS, finish_build, leaf_statement, prove_filled
from .verifier_circuit import (
    CircuitChallenger,
    VerifierCompiler,
    add_stark_verify,
    sponge_hash,
)
from .wrap import MachineProof, verify_machine

P = fh.P
NUM_PI = 4


def combine_digests(left: Sequence[int], right: Sequence[int]) -> List[int]:
    """Host mirror of the agg circuit's inner-digest combination."""
    return poseidon.two_to_one_host(list(left), list(right))


def _is_pad(left: MachineProof, right: MachineProof) -> bool:
    """The fold's repeat-padding is detectable by statement equality
    (a real pair can never share a statement: every leaf increments the
    txn number, so no subtree has before == after)."""
    return [int(x) % P for x in right.proof.public_inputs] == [
        int(x) % P for x in left.proof.public_inputs
    ]


def chain_seams(ls: List[int], rs: List[int], pad: bool) -> List[int]:
    """Host mirror of the agg circuit's seam combination (pad=1 keeps
    the left seam; else (left.before, right.after))."""
    if pad:
        return list(ls)
    return [ls[0], rs[1], ls[2], rs[3]] + ls[4:20] + rs[20:36]


def seams_chain(ls: List[int], rs: List[int]) -> bool:
    """left.after == right.before on (txn, gas, root)."""
    return ls[1] == rs[0] and ls[3] == rs[2] and ls[20:36] == rs[4:20]


@dataclass
class AggCircuit:
    """Level-k aggregation: verifies two level-(k-1) machine proofs,
    chains their seams in-circuit, and exposes the combined statement.

    vc may be None for disk-loaded circuits (recursion/persist.py);
    proving lazily re-runs `rebuild` once."""

    vc: "VerifierCompiler | None"
    stark: RecursionStark
    log_n: int
    rebuild: "object | None" = None  # () -> AggCircuit (full)

    def _ensure_vc(self) -> None:
        if self.vc is None:
            assert self.rebuild is not None, "loaded circuit without builder"
            self.vc = self.rebuild().vc

    def prove(
        self, left: MachineProof, right: MachineProof, config: StarkConfig, device=None,
        phase_times: Optional[Dict[str, Dict[str, float]]] = None,
    ) -> MachineProof:
        self._ensure_vc()
        assert left.seam is not None and right.seam is not None, (
            "agg children must carry their statement preimages"
        )
        pad = _is_pad(left, right)
        seam = chain_seams(left.seam, right.seam, pad)
        digest = combine_digests(left.digest, right.digest)
        mp = prove_filled(
            self.vc, self.stark, (left, right), leaf_statement(seam, digest), config,
            self.log_n, device, phase_times,
        )
        mp.seam = seam
        mp.digest = digest
        return mp


def _variant_cap_wires(vc, child_starks, n: int, config: StarkConfig, side: int, device=None):
    """Child vkey cap as wires. One registered child shape: constants.
    Several (same machine shape, same log_n, different fixed columns —
    e.g. per-overlap tx root circuits): mux the K constant caps by a
    witnessed, bool-checked variant selector. Soundness: the selector
    only picks WHICH vkey the proof must verify against; the statement
    digest itself is recomputed by the outer verifier from the witness,
    so a wrong-variant proof cannot carry the forced public inputs."""
    from ..stark.prove import fixed_cap
    from .verifier_circuit import mux

    b = vc.b
    caps = [fixed_cap(s, n, config, device) for s in child_starks]
    if len(caps) == 1:
        vk = caps[0]
        return [
            [b.const(int(vk[r, i])) for r in range(4)] for i in range(vk.shape[1])
        ]
    k_bits = max(len(caps) - 1, 1).bit_length()
    while len(caps) & (len(caps) - 1):
        caps.append(caps[-1])
    sel = [
        vc.inp(
            lambda c, side=side, j=j: (int(c[side].variant) >> j) & 1,
            f"variant[{side}][{j}]",
        )
        for j in range(k_bits)
    ]
    for s in sel:
        b.bool_check(s)
    cap_w = caps[0].shape[1]
    return [
        [
            mux(b, [b.const(int(vk[r, i])) for vk in caps], sel)
            for r in range(4)
        ]
        for i in range(cap_w)
    ]


def build_agg(
    child_starks: "RecursionStark | List[RecursionStark]",
    child_log_n: int,
    config: StarkConfig,
    device=None,
    phase_times: Optional[Dict[str, Dict[str, float]]] = None,
) -> AggCircuit:
    if not isinstance(child_starks, list):
        child_starks = [child_starks]
    t0 = time.perf_counter()
    vc = VerifierCompiler()
    b = vc.b
    zero = b.const(0)
    one = b.const(1)
    n = 1 << child_log_n

    def side(s: int):
        """Witness one child's (seam, D) preimage; its recomputed E is
        the public-input vector the child proof must verify against —
        binding the witnessed preimage to the proved statement."""
        seam = [
            vc.inp(lambda c, s=s, i=i: int(c[s].seam[i]) % P, f"seam[{s}][{i}]")
            for i in range(SEAM_WORDS)
        ]
        dig = [
            vc.inp(lambda c, s=s, k=k: int(c[s].digest[k]) % P, f"dig[{s}][{k}]")
            for k in range(NUM_PI)
        ]
        return seam, dig, sponge_hash(b, seam + dig, NUM_PI)

    l_seam, l_dig, l_e = side(0)
    r_seam, r_dig, r_e = side(1)
    add_stark_verify(
        vc, child_starks[0], child_log_n, config,
        CircuitChallenger(b), l_e, proof_of=lambda c: c[0].proof,
        fixed_cap=_variant_cap_wires(vc, child_starks, n, config, 0, device),
        device=device,
    )
    add_stark_verify(
        vc, child_starks[0], child_log_n, config,
        CircuitChallenger(b), r_e, proof_of=lambda c: c[1].proof,
        fixed_cap=_variant_cap_wires(vc, child_starks, n, config, 1, device),
        device=device,
    )

    # seam continuity (left.after == right.before), or — under the
    # witnessed pad bit — right replays left's exact statement
    pad = vc.inp(lambda c: int(_is_pad(c[0], c[1])), "pad")
    b.bool_check(pad)
    not_pad = b.sub(one, pad)
    b.assert_zero(b.mul(not_pad, b.sub(l_seam[1], r_seam[0])), "txn-seam")
    b.assert_zero(b.mul(not_pad, b.sub(l_seam[3], r_seam[2])), "gas-seam")
    for i in range(16):
        b.assert_zero(
            b.mul(not_pad, b.sub(l_seam[20 + i], r_seam[4 + i])),
            f"root-seam[{i}]",
        )
    for k in range(NUM_PI):
        b.assert_zero(b.mul(pad, b.sub(l_e[k], r_e[k])), f"pad-dup[{k}]")

    comb_seam = (
        [
            l_seam[0],
            b.select(pad, l_seam[1], r_seam[1]),
            l_seam[2],
            b.select(pad, l_seam[3], r_seam[3]),
        ]
        + l_seam[4:20]
        + [b.select(pad, l_seam[20 + i], r_seam[20 + i]) for i in range(16)]
    )
    comb_dig = b.poseidon(l_dig + r_dig + [zero] * 4, "combine")[:NUM_PI]
    out = sponge_hash(b, comb_seam + comb_dig, NUM_PI)
    for k in range(NUM_PI):
        b.expose(out[k], k, f"pi[{k}]")
    stark, log_n = finish_build(vc, t0, phase_times)
    return AggCircuit(vc=vc, stark=stark, log_n=log_n)


class AggLadder:
    """Lazy per-level circuit cache over a fixed leaf machine shape.

    Level 0: the leaf (tx root) machine circuit, given at construction.
    Level k >= 1: the agg circuit whose children are level k-1 proofs.
    Building a level costs one verifier compilation + one fixed-column
    commitment (on `device`, None: the CUDA card); both are cached for the
    process lifetime (the analogue of the reference's prover_state disk
    cache). `build_times[level]` holds each built level's host seconds
    ("compile", "layout"; empty for a circuit loaded from disk).
    """

    def __init__(
        self,
        leaf_starks: "RecursionStark | List[RecursionStark]",
        leaf_log_n: int,
        config: StarkConfig,
        cache_tag: "str | None" = None,
        device=None,
    ):
        if not isinstance(leaf_starks, list):
            leaf_starks = [leaf_starks]
        self.config = config
        self.device = device
        # disk-persistence key prefix for this ladder's agg circuits
        # (recursion/persist.py); None disables the disk cache
        self.cache_tag = cache_tag
        self._shape: Dict[int, Tuple[List[RecursionStark], int]] = {
            0: (leaf_starks, leaf_log_n)
        }
        self._agg: Dict[int, AggCircuit] = {}
        self.build_times: Dict[int, Dict[str, Dict[str, float]]] = {}

    def agg(self, level: int) -> AggCircuit:
        assert level >= 1
        if level not in self._agg:
            cs, cn = self.level_shape(level - 1)
            times: Dict[str, Dict[str, float]] = {}

            def build(cs=cs, cn=cn, times=None):
                return build_agg(cs, cn, self.config, self.device, times)

            a = None
            if self.cache_tag is not None:
                from .persist import circ_path, load_circuit, save_circuit

                path = circ_path("agg", (self.cache_tag, level))
                hit = load_circuit(path)
                if hit is not None:
                    circ, ex = hit
                    a = AggCircuit(
                        vc=None, stark=RecursionStark(circ), log_n=int(ex["log_n"]),
                        rebuild=build,
                    )
                else:
                    a = build(times=times)
                    a.rebuild = build
                    save_circuit(
                        path, a.stark.circuit, {"log_n": a.log_n}
                    )
            if a is None:
                a = build(times=times)
            self._agg[level] = a
            self._shape[level] = ([a.stark], a.log_n)
            self.build_times[level] = times
        return self._agg[level]

    def level_shape(self, level: int) -> Tuple[List[RecursionStark], int]:
        if level not in self._shape:
            self.agg(level)
        return self._shape[level]


def fold_proofs(
    ladder: AggLadder, leaves: List[MachineProof], config: StarkConfig,
    phase_times: Optional[Dict[int, List[Dict[str, Dict[str, float]]]]] = None,
) -> Tuple[MachineProof, int]:
    """Balanced binary fold of leaf proofs -> (top proof, top level), proved
    on the ladder's device. `phase_times`, when given, receives per level a
    list of each agg proof's times (`AggCircuit.prove`'s, with its seconds
    under "wall")."""
    assert leaves, "need at least one leaf"
    proofs = list(leaves)
    while len(proofs) & (len(proofs) - 1):
        proofs.append(proofs[-1])  # pad to pow2 (verifier replays this)
    level = 0
    while len(proofs) > 1:
        level += 1
        agg = ladder.agg(level)
        nxt = []
        for i in range(0, len(proofs), 2):
            times: Optional[Dict[str, Dict[str, float]]] = (
                {} if phase_times is not None else None
            )
            t0 = time.perf_counter()
            nxt.append(agg.prove(proofs[i], proofs[i + 1], config, ladder.device, times))
            if times is not None:
                times["wall"] = time.perf_counter() - t0
                phase_times.setdefault(level, []).append(times)
        proofs = nxt
    return proofs[0], level


def expected_statement(
    leaf_parts: List[Tuple[List[int], List[int]]],
) -> "Tuple[List[int], List[int]] | None":
    """Host replay of the fold's statement algebra (incl. padding):
    -> the top (seam, digest), or None if the leaf seams do not chain
    (left.after != right.before anywhere in the tree)."""
    nodes = [
        ([int(x) % P for x in s], [int(x) % P for x in d])
        for s, d in leaf_parts
    ]
    while len(nodes) & (len(nodes) - 1):
        nodes.append(nodes[-1])
    while len(nodes) > 1:
        nxt = []
        for i in range(0, len(nodes), 2):
            (ls, ld), (rs, rd) = nodes[i], nodes[i + 1]
            pad = ls == rs and ld == rd
            if not pad and not seams_chain(ls, rs):
                return None
            nxt.append((chain_seams(ls, rs, pad), combine_digests(ld, rd)))
        nodes = nxt
    return nodes[0]


def verify_fold(
    ladder: AggLadder,
    top: MachineProof,
    top_level: int,
    leaf_parts: List[Tuple[List[int], List[int]]],
    config: StarkConfig,
) -> bool:
    """Succinct verification: ONE machine proof + host statement replay.
    `leaf_parts`: per real tx, the (seam, digest) pair re-derived from
    the WITNESS (not from the proof) — matching it against the proved
    top statement is what ties the machine proof to this block."""
    starks, log_n = ladder.level_shape(top_level)
    if top.log_n != log_n:
        return False
    if top.variant >= len(starks):
        return False
    want = expected_statement(leaf_parts)
    if want is None:
        return False
    seam, digest = want
    if [int(x) % P for x in top.proof.public_inputs] != leaf_statement(
        seam, digest
    ):
        return False
    return verify_machine(starks[top.variant], top, config, ladder.device)
