"""Multi-table STARK proving with cross-table lookups.

Counterpart: ethproof_tpu/stark/multi.py:1 (`CrossTableLookup`,
`MultiProof`, `_instances_for_table`, `_pre_phase`, `prove_multi`,
`verify_multi`). The protocol is the same; `device`, `phase_times` and
`mesh` are passed through to the per-table commit and `stark_prove`.

Protocol:
  pre-phase: observe (num_tables, each table's public inputs, degree bits,
  trace cap) — binds every table before any challenge is drawn;
  draw num_challenges (beta, gamma) CTL challenge pairs;
  per table (in order): a full `stark_prove` transcript continues on the
  SAME challenger, with that table's CtlInstances bound to the shared
  challenges;
  final consistency: for every lookup and challenge,
  prod(looking totals) == looked total (multiset equality under the
  grand-product argument).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import resolve_device
from ..fri.challenger import Challenger
from ..fri.config import StarkConfig
from ..gf import field_host as fh
from ..parallel import mesh as pmesh
from ..runtime.tracing import phase
from .prove import StarkProof, commit_trace, stark_prove
from .stark import CtlInstance, CtlSpec, Stark
from .verify import stark_verify

P = fh.P


@dataclass(frozen=True)
class CrossTableLookup:
    """Multiset equality: union of looking rows == looked rows."""

    looking: Tuple[Tuple[int, CtlSpec], ...]  # (table_index, spec)
    looked: Tuple[int, CtlSpec]


@dataclass
class MultiProof:
    proofs: List[StarkProof]


def _instances_for_table(
    t: int,
    ctls: List[CrossTableLookup],
    challenges: List[Tuple[int, int]],
) -> Tuple[List[CtlInstance], List[Tuple[int, int, str, int, int]]]:
    """Canonical per-table instance list + global labels.

    Label: (ctl_idx, challenge_idx, role, position, table). Ordering is
    ctl-major, then looking-position / looked, then challenge — identical
    in prover and verifier.
    """
    instances: List[CtlInstance] = []
    labels: List[Tuple[int, int, str, int, int]] = []
    for ci, ctl in enumerate(ctls):
        for pos, (tt, spec) in enumerate(ctl.looking):
            if tt == t:
                for hi, (beta, gamma) in enumerate(challenges):
                    instances.append(CtlInstance(spec, beta, gamma))
                    labels.append((ci, hi, "looking", pos, t))
        tt, spec = ctl.looked
        if tt == t:
            for hi, (beta, gamma) in enumerate(challenges):
                instances.append(CtlInstance(spec, beta, gamma))
                labels.append((ci, hi, "looked", 0, t))
    return instances, labels


def _pre_phase(
    challenger: Challenger,
    public_inputs: List[List[int]],
    degree_bits: List[int],
    caps: List[np.ndarray],
) -> None:
    challenger.observe_element(len(caps))
    for pis, db, cap in zip(public_inputs, degree_bits, caps):
        challenger.observe_elements([x % P for x in pis])
        challenger.observe_element(db)
        challenger.observe_cap(cap)


def prove_multi(
    starks: List[Stark],
    traces: List[np.ndarray],
    public_inputs: List[List[int]],
    ctls: List[CrossTableLookup],
    config: StarkConfig,
    device=None,
    phase_times: Optional[List[Dict[str, float]]] = None,
    mesh=None,
) -> MultiProof:
    """Prove every table under one transcript on `device` (None: the CUDA
    card). `mesh` as in `stark_prove`: None takes the default mesh (a
    multi-card host shards every commit with no flag), False forces one
    device. `phase_times`, when given, receives one dict per table: the
    seconds of its trace commit (`commit`) and of `stark_prove`'s phases."""
    assert len(starks) == len(traces) == len(public_inputs)
    dev = resolve_device(device)
    mesh = pmesh.resolve_mesh(mesh, dev)
    if mesh is not None:
        dev = mesh.leader
    times: List[Dict[str, float]] = [{} for _ in starks]
    challenger = Challenger()
    # one commit per table, reused by stark_prove (no duplicate LDE/tree)
    commitments = []
    for tr, tt in zip(traces, times):
        with phase("commit", tt, dev):
            commitments.append(commit_trace(tr, config, dev, mesh))
    caps = [cm.cap for cm in commitments]
    degree_bits = [tr.shape[1].bit_length() - 1 for tr in traces]
    _pre_phase(challenger, public_inputs, degree_bits, caps)
    challenges = [
        (challenger.get_challenge(), challenger.get_challenge())
        for _ in range(config.num_challenges)
    ]
    proofs = []
    for t, (stark, trace, pis) in enumerate(zip(starks, traces, public_inputs)):
        instances, _ = _instances_for_table(t, ctls, challenges)
        proofs.append(
            stark_prove(
                stark, trace, pis, config,
                challenger=challenger,
                ctl_instances=instances or None,
                commitment=commitments[t],
                device=dev,
                phase_times=times[t],
                mesh=mesh if mesh is not None else False,
            )
        )
        commitments[t] = None  # the table's LDE and tree are no longer needed
    if phase_times is not None:
        phase_times[:] = times
    return MultiProof(proofs=proofs)


def verify_multi(
    starks: List[Stark],
    multi: MultiProof,
    ctls: List[CrossTableLookup],
    config: StarkConfig,
    device=None,
) -> bool:
    """Host verification; `device` is where fixed-column caps are committed."""
    proofs = multi.proofs
    if len(proofs) != len(starks):
        return False
    challenger = Challenger()
    _pre_phase(
        challenger,
        [p.public_inputs for p in proofs],
        [p.degree_bits for p in proofs],
        [p.trace_cap for p in proofs],
    )
    challenges = [
        (challenger.get_challenge(), challenger.get_challenge())
        for _ in range(config.num_challenges)
    ]
    # per-table proofs + collect totals by (ctl, challenge, role)
    looking_prod: Dict[Tuple[int, int], int] = {}
    looked_val: Dict[Tuple[int, int], int] = {}
    for t, (stark, proof) in enumerate(zip(starks, proofs)):
        instances, labels = _instances_for_table(t, ctls, challenges)
        if not stark_verify(
            stark, proof, config,
            challenger=challenger,
            ctl_instances=instances or None,
            device=device,
        ):
            return False
        if len(proof.ctl_totals) != len(instances):
            return False
        for (ci, hi, role, _pos, _t), total in zip(labels, proof.ctl_totals):
            key = (ci, hi)
            if role == "looking":
                looking_prod[key] = looking_prod.get(key, 1) * total % P
            else:
                looked_val[key] = total
    # cross-table multiset equality
    for ci in range(len(ctls)):
        for hi in range(config.num_challenges):
            key = (ci, hi)
            if looking_prod.get(key, 1) != looked_val.get(key, 1):
                return False
    return True
