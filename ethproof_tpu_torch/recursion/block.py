"""Block wrap circuits: parent-block chaining IN-CIRCUIT.

Counterpart: ethproof_tpu/recursion/block.py:1 (a copy). `BlockWraps`
carries the ladder's `device` (None: the CUDA card), where its vkeys are
committed and its proofs made; `prove_base`/`prove_step` take
`phase_times` (see recursion/root.py), and `build_times` holds the host
seconds of each circuit's build.

Reference equivalent: proof_gen's `block` circuit — one plonky2 circuit
verifying the block's aggregated proof AND (cyclically) the parent
block proof, chaining state roots across blocks
(ops/src/lib.rs:84-101 [dep: from knowledge of proof_gen 0.1.3 cyclic
recursion]). Without it, parent chaining is one host equality between two
proved statements (runtime/ops.py block_proof); this module closes it.

Re-design (no plonky2 cyclic gadget): two machine circuits over the
uniform-row recursion machine —

  BASE  verifies the first block's top aggregation proof; no parent.
  STEP  verifies the current block's top aggregation proof AND the
        parent BLOCK proof (base or step).

The cyclic vkey problem (STEP must verify a proof of its OWN shape) is
solved with plonky2's vkey-in-public-inputs pattern re-expressed for
this machine: STEP verifies its parent against a WITNESSED vkey cap W
and binds W into its exposed statement; the parent's own statement
preimage (recomputed in-circuit) carries the SAME W wires, so one W
rides the whole chain; the outermost verifier pins W to the step
circuit's actual cap with one host equality. A bool `is_base` muxes the
parent vkey between const(base cap) and W.

Degree fixed point: the STEP circuit verifies a parent proof at its own
degree D. `build_block_wraps` iterates D (gate count grows only with
log D via FRI paths) until machine_degree(step) <= D, then both BASE
and STEP prove padded to exactly 2^D so parent proofs have one shape.

Statement layout (preimage; E = sponge(preimage)):
  seam(36) ++ digest(4) ++ E_parent(4) ++ W_flat ++ [is_base]
with E_parent = 0^4 for BASE. STEP constrains in-circuit:
  parent.seam.root_post == seam.root_pre   (the cross-block chain).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..fri.config import StarkConfig
from ..gf import field_host as fh
from ..hash import poseidon
from .aggregate import AggLadder, expected_statement
from .root import SEAM_WORDS, finish_build, prove_filled
from .verifier_circuit import (
    CircuitChallenger,
    VerifierCompiler,
    add_stark_verify,
    sponge_hash,
)
from .wrap import MachineProof, machine_degree, verify_machine

P = fh.P
NUM_PI = 4


@dataclass
class BlockWrapProof:
    """A block-chain wrap proof plus its statement preimage (prover-side
    plumbing, like MachineProof.seam/digest): the NEXT step witnesses
    these to recompute this proof's E in-circuit."""

    mp: MachineProof
    seam: List[int]  # this block's agg seam (36)
    digest: List[int]  # this block's agg inner digest (4)
    e_parent: List[int]  # parent wrap statement (4; zeros for base)
    is_base: int


def _cap_flat(cap: np.ndarray) -> List[int]:
    """(4, w) u64 cap -> flat word list [digest0..., digest1...]."""
    return [int(cap[r, i]) % P for i in range(cap.shape[1]) for r in range(4)]


def block_statement(
    seam: Sequence[int], digest: Sequence[int], e_parent: Sequence[int],
    w_flat: Sequence[int], is_base: int,
) -> List[int]:
    """Host mirror of the wrap circuits' exposed statement."""
    return poseidon.hash_n_to_m_no_pad_host(
        [int(x) % P for x in seam]
        + [int(x) % P for x in digest]
        + [int(x) % P for x in e_parent]
        + [int(x) % P for x in w_flat]
        + [int(is_base) % P],
        NUM_PI,
    )


@dataclass
class _WrapFill:
    """Witness-fill context for base/step proving."""

    agg: MachineProof  # this block's top aggregation proof
    w_cap: np.ndarray  # the chain vkey cap W (step circuit's cap)
    parent: Optional[BlockWrapProof] = None  # step only


class _WrapCircuit:
    def __init__(self, vc, stark, log_n):
        self.vc, self.stark, self.log_n = vc, stark, log_n


@dataclass
class BlockWraps:
    """Compiled base+step pair for one (agg stark, agg degree) shape."""

    base: _WrapCircuit
    step: _WrapCircuit
    log_n: int  # common wrap proof degree D (fixed point)
    config: StarkConfig
    device: object = None  # where vkeys are committed and proofs made
    # host seconds per built circuit ("base", "step/<D>")
    build_times: Dict[str, Dict[str, Dict[str, float]]] = field(default_factory=dict)

    @property
    def chain_cap(self) -> np.ndarray:
        """W — the step circuit's vkey cap; rides the whole chain."""
        from ..stark.prove import fixed_cap

        return fixed_cap(self.step.stark, 1 << self.log_n, self.config, self.device)

    def prove_base(
        self, agg: MachineProof,
        phase_times: Optional[Dict[str, Dict[str, float]]] = None,
    ) -> BlockWrapProof:
        assert agg.seam is not None and agg.digest is not None
        fill = _WrapFill(agg=agg, w_cap=self.chain_cap)
        e_parent = [0] * NUM_PI
        pis = block_statement(
            agg.seam, agg.digest, e_parent, _cap_flat(fill.w_cap), 1
        )
        mp = prove_filled(
            self.base.vc, self.base.stark, fill, pis, self.config, self.log_n,
            self.device, phase_times,
        )
        return BlockWrapProof(
            mp=mp, seam=list(agg.seam), digest=list(agg.digest),
            e_parent=e_parent, is_base=1,
        )

    def prove_step(
        self, agg: MachineProof, parent: BlockWrapProof,
        phase_times: Optional[Dict[str, Dict[str, float]]] = None,
    ) -> BlockWrapProof:
        assert agg.seam is not None and agg.digest is not None
        fill = _WrapFill(agg=agg, w_cap=self.chain_cap, parent=parent)
        e_parent = block_statement(
            parent.seam, parent.digest, parent.e_parent,
            _cap_flat(fill.w_cap), parent.is_base,
        )
        pis = block_statement(
            agg.seam, agg.digest, e_parent, _cap_flat(fill.w_cap), 0
        )
        mp = prove_filled(
            self.step.vc, self.step.stark, fill, pis, self.config, self.log_n,
            self.device, phase_times,
        )
        return BlockWrapProof(
            mp=mp, seam=list(agg.seam), digest=list(agg.digest),
            e_parent=e_parent, is_base=0,
        )


def _agg_side(vc, b, agg_stark, agg_log_n, config, device=None):
    """Witness the block's agg (seam, digest) preimage, recompute E_agg,
    and verify the agg top proof against it (aggregate.build_agg's
    `side`, single-variant)."""
    seam = [
        vc.inp(lambda c, i=i: int(c.agg.seam[i]) % P, f"aseam[{i}]")
        for i in range(SEAM_WORDS)
    ]
    dig = [
        vc.inp(lambda c, k=k: int(c.agg.digest[k]) % P, f"adig[{k}]")
        for k in range(NUM_PI)
    ]
    e_agg = sponge_hash(b, seam + dig, NUM_PI)
    add_stark_verify(
        vc, agg_stark, agg_log_n, config, CircuitChallenger(b), e_agg,
        proof_of=lambda c: c.agg.proof, device=device,
    )
    return seam, dig


def _w_wires(vc, config, wrap_log_n):
    """The chain vkey cap W as witness wires (the cyclic vkey)."""
    return vc.inp_cap(
        lambda c: c.w_cap, config.fri_config.cap_height, "W"
    )


def _flat(cap_wires):
    return [w for digest in cap_wires for w in digest]


def _build_base(
    agg_stark, agg_log_n, config, device=None,
    phase_times: Optional[Dict[str, Dict[str, float]]] = None,
) -> _WrapCircuit:
    t0 = time.perf_counter()
    vc = VerifierCompiler()
    b = vc.b
    zero = b.const(0)
    seam, dig = _agg_side(vc, b, agg_stark, agg_log_n, config, device)
    w = _w_wires(vc, config, None)
    one = b.const(1)
    out = sponge_hash(
        b, seam + dig + [zero] * NUM_PI + _flat(w) + [one], NUM_PI
    )
    for k in range(NUM_PI):
        b.expose(out[k], k, f"pi[{k}]")
    stark, log_n = finish_build(vc, t0, phase_times)
    return _WrapCircuit(vc, stark, log_n)


def _build_step(
    agg_stark, agg_log_n, config, base_cap: np.ndarray, wrap_log_n: int, device=None,
    phase_times: Optional[Dict[str, Dict[str, float]]] = None,
) -> _WrapCircuit:
    t0 = time.perf_counter()
    vc = VerifierCompiler()
    b = vc.b
    zero = b.const(0)
    seam, dig = _agg_side(vc, b, agg_stark, agg_log_n, config, device)
    w = _w_wires(vc, config, wrap_log_n)

    # parent statement preimage (witnessed; bound by recomputing E)
    pseam = [
        vc.inp(lambda c, i=i: int(c.parent.seam[i]) % P, f"pseam[{i}]")
        for i in range(SEAM_WORDS)
    ]
    pdig = [
        vc.inp(lambda c, k=k: int(c.parent.digest[k]) % P, f"pdig[{k}]")
        for k in range(NUM_PI)
    ]
    pe_par = [
        vc.inp(lambda c, k=k: int(c.parent.e_parent[k]) % P, f"pepar[{k}]")
        for k in range(NUM_PI)
    ]
    p_base = vc.inp(lambda c: int(c.parent.is_base), "p_is_base")
    b.bool_check(p_base)
    e_parent = sponge_hash(
        b, pseam + pdig + pe_par + _flat(w) + [p_base], NUM_PI
    )
    # parent vkey: base cap (constants) when p_base, else the chain W
    parent_cap = [
        [
            b.select(p_base, b.const(int(base_cap[r, i])), w[i][r])
            for r in range(4)
        ]
        for i in range(base_cap.shape[1])
    ]
    add_stark_verify(
        vc, agg_stark, wrap_log_n, config, CircuitChallenger(b), e_parent,
        proof_of=lambda c: c.parent.mp.proof,
        fixed_cap=parent_cap, device=device,
    )

    # cross-block chain: parent.root_post == this block's root_pre
    for i in range(16):
        b.assert_eq(pseam[20 + i], seam[4 + i], f"block-chain[{i}]")

    out = sponge_hash(
        b, seam + dig + e_parent + _flat(w) + [zero], NUM_PI
    )
    for k in range(NUM_PI):
        b.expose(out[k], k, f"pi[{k}]")
    stark, log_n = finish_build(vc, t0, phase_times)
    return _WrapCircuit(vc, stark, log_n)


def build_block_wraps(
    ladder: AggLadder, top_level: int, config: StarkConfig
) -> BlockWraps:
    """Compile (base, step) for blocks whose agg fold tops out at
    `top_level`, on the ladder's device. Degree fixed point: iterate the
    assumed wrap degree D until the step machine fits it (gate count grows
    ~log D, so this converges in a couple of rounds). Cached on the ladder
    (one compilation per process per level, like the agg circuits)."""
    cache = ladder.__dict__.setdefault("_block_wraps", {})
    if top_level in cache:
        return cache[top_level]
    wraps = _build_block_wraps(ladder, top_level, config)
    cache[top_level] = wraps
    return wraps


def _build_block_wraps(
    ladder: AggLadder, top_level: int, config: StarkConfig
) -> BlockWraps:
    agg_starks, agg_log_n = ladder.level_shape(top_level)
    assert len(agg_starks) == 1, "block wrap expects the (single) agg shape"
    agg_stark = agg_starks[0]
    device = ladder.device
    times: Dict[str, Dict[str, Dict[str, float]]] = {"base": {}}
    base = _build_base(agg_stark, agg_log_n, config, device, times["base"])
    d = max(base.log_n, agg_log_n)
    for _ in range(4):
        times[f"step/{d}"] = {}
        step = _build_step(
            agg_stark, agg_log_n, config,
            _wrap_cap(base, d, config, device), d, device, times[f"step/{d}"],
        )
        need = machine_degree(step.stark)
        if need <= d:
            step.log_n = d
            base.log_n = d  # both wrap kinds prove padded to 2^D
            return BlockWraps(base=base, step=step, log_n=d, config=config,
                              device=device, build_times=times)
        d = need
    raise AssertionError("block wrap degree fixed point did not converge")


def _wrap_cap(circ: _WrapCircuit, d: int, config: StarkConfig, device=None) -> np.ndarray:
    from ..stark.prove import fixed_cap

    return fixed_cap(circ.stark, 1 << d, config, device)


def verify_block_chain(
    wraps: BlockWraps,
    top: BlockWrapProof,
    blocks_leaf_parts: List[List[Tuple[List[int], List[int]]]],
    config: StarkConfig,
) -> bool:
    """Succinct chain verification: ONE machine proof + host statement
    replay over every block's witness-derived leaf parts (oldest block
    first). Pins the chain vkey W to the step circuit's actual cap —
    the one host equality that closes the cyclic loop."""
    if not blocks_leaf_parts:
        return False
    w_flat = _cap_flat(wraps.chain_cap)
    e_prev: Optional[List[int]] = None
    want_root_post = None
    for bi, parts in enumerate(blocks_leaf_parts):
        node = expected_statement(parts)
        if node is None:
            return False
        seam, digest = node
        if bi == 0:
            e_prev = block_statement(seam, digest, [0] * NUM_PI, w_flat, 1)
        else:
            if seam[4:20] != want_root_post:
                return False  # cross-block root chain broken
            e_prev = block_statement(seam, digest, e_prev, w_flat, 0)
        want_root_post = seam[20:36]
    if [int(x) % P for x in top.mp.proof.public_inputs] != e_prev:
        return False
    circ = wraps.base if len(blocks_leaf_parts) == 1 else wraps.step
    if top.mp.log_n != wraps.log_n:
        return False
    return verify_machine(circ.stark, top.mp, config, wraps.device)
