"""Recursion prover state: the AllRecursiveCircuits analogue.

Counterpart: ethproof_tpu/recursion/state.py:1 (a copy). A state holds
the `device` its circuits commit their vkeys and prove on (None: the CUDA
card, which `recursion_state` requires unless the caller names the CPU);
the device enters the process-wide cache key but not the disk cache's (a
vkey's bits are the same on every device). `build_times` holds the host
seconds of each root circuit's build.

Reference equivalent: `AllRecursiveCircuits` built once per circuit
config and cached (common/src/prover_state/circuit.rs:200-206,
persistence.rs:40-88). Here the expensive artifacts are (a) the compiled
per-overlap tx ROOT circuits, (b) the per-level AGG circuits, and (c) each
circuit's fixed-column (vkey) commitment — all deterministic functions of
(TableSizes, StarkConfig), built lazily and cached for the process
lifetime, and on disk under `runtime.prover_state.artifact_dir()`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import resolve_device

# ordered registry of overlap variants; index == MachineProof.variant
from ..evm.transfer import (
    OVERLAP_ALL,
    OVERLAP_DISTINCT,
    OVERLAP_R_EQ_M,
    OVERLAP_S_EQ_M,
    OVERLAP_S_EQ_R,
    transfer_cpu_stark,
)
from ..fri.config import StarkConfig
from ..tables.all import TableSizes
from .aggregate import AggLadder
from .persist import circ_path, load_circuit, save_circuit
from .root import TxRootCircuit, build_evm_root, build_tx_root

OVERLAP_VARIANTS: List[str] = [
    OVERLAP_DISTINCT,
    OVERLAP_S_EQ_R,
    OVERLAP_S_EQ_M,
    OVERLAP_R_EQ_M,
    OVERLAP_ALL,
]
VARIANT_INDEX: Dict[str, int] = {o: i for i, o in enumerate(OVERLAP_VARIANTS)}


@dataclass
class RecursionState:
    """Root circuits (per overlap variant) + the aggregation ladder, for
    one (sizes, config, binding shape). All variants are padded to one
    machine degree so the level-1 agg circuit can vkey-mux over them."""

    sizes: TableSizes
    config: StarkConfig
    overlaps: List[str]
    binding_shape: Optional[object] = None  # evm.binding.KernelShape
    roots: Dict[str, TxRootCircuit] = field(default_factory=dict)
    # EVM-machine leaf variants: contract-call root circuits keyed by
    # EvmShape, registered BEFORE the ladder is materialized (the shape
    # list is part of the block proof's statement — the verifier
    # rebuilds the same variant set)
    evm_shapes: List[object] = field(default_factory=list)  # tables/evm.EvmShape
    evm_roots: Dict[object, TxRootCircuit] = field(default_factory=dict)
    # padding-dummy leaf variants: the no-op dummy (always present in
    # the variant list) and withdrawal kernels keyed by count
    # (registered pre-ladder like evm shapes; identity travels in the
    # block proof)
    wd_counts: List[int] = field(default_factory=list)
    wd_roots: Dict[int, TxRootCircuit] = field(default_factory=dict)
    # identity string for the disk circuit cache (recursion/persist.py);
    # None disables persistence
    cache_key: Optional[str] = None
    device: object = None  # where vkeys are committed and proofs made
    # host seconds per built root circuit ("txroot/<overlap>", "dummy",
    # "evmroot/<shape>", "wdroot/<n>"); empty for one loaded from disk
    build_times: Dict[str, Dict[str, Dict[str, float]]] = field(default_factory=dict)
    _ladder: Optional[AggLadder] = None
    _root_log_n: Optional[int] = None
    _dummy_root: Optional[object] = None

    def _load_or_build_root(self, kind: str, key, build) -> TxRootCircuit:
        from .machine import RecursionStark

        path = (
            circ_path(kind, (self.cache_key, key))
            if self.cache_key is not None
            else None
        )
        hit = load_circuit(path)
        if hit is not None:
            circ, ex = hit
            slices = None
            if int(ex.get("has_slices", 0)):
                slices = (
                    slice(int(ex["s0"]), int(ex["s1"])),
                    slice(int(ex["s2"]), int(ex["s3"])),
                )
            return TxRootCircuit(
                vc=None, stark=RecursionStark(circ), log_n=int(ex["log_n"]),
                seam_root_slices=slices, rebuild=build,
            )
        times: Dict[str, Dict[str, float]] = {}
        rc = build(times)
        self.build_times[f"{kind}/{key}"] = times
        rc.rebuild = build
        ex = {"log_n": rc.log_n, "has_slices": int(rc.seam_root_slices is not None)}
        if rc.seam_root_slices is not None:
            pre, post = rc.seam_root_slices
            ex.update(s0=pre.start, s1=pre.stop, s2=post.start, s3=post.stop)
        save_circuit(path, rc.stark.circuit, ex)
        return rc

    def root(self, overlap: str) -> TxRootCircuit:
        assert overlap in self.overlaps, f"overlap {overlap} not registered"
        if overlap not in self.roots:
            def build(times=None, overlap=overlap):
                return build_tx_root(
                    transfer_cpu_stark(overlap, self.binding_shape),
                    self.sizes,
                    self.config,
                    self.device,
                    times,
                )

            self.roots[overlap] = self._load_or_build_root(
                "txroot", overlap, build
            )
            if self._root_log_n is not None:
                # ladder already fixed the common degree; later-compiled
                # variants must fit under it (they differ by a few gates)
                r = self.roots[overlap]
                assert r.log_n <= self._root_log_n, (
                    f"variant {overlap} needs 2^{r.log_n} > common "
                    f"2^{self._root_log_n}"
                )
                r.log_n = self._root_log_n
        return self.roots[overlap]

    def register_evm(self, shape) -> None:
        """Register a contract-call leaf variant. Must happen before the
        ladder is materialized (a block prover pre-scans witnesses); a new
        shape after that is a deterministic failure — the reference
        analogue of a trace outside the configured circuit ranges."""
        if shape in self.evm_roots:
            return

        def build(times=None, shape=shape):
            from ..tables.evm import EvmStark

            return build_evm_root(EvmStark(shape), self.sizes, self.config, self.device,
                                  times)

        root = self._load_or_build_root("evmroot", repr(shape), build)
        if self._root_log_n is not None:
            assert self._ladder is None or shape in self.evm_roots, (
                f"evm shape {shape} registered after ladder materialization"
            )
            assert root.log_n <= self._root_log_n, (
                f"evm root needs 2^{root.log_n} > common 2^{self._root_log_n}"
            )
            root.log_n = self._root_log_n
        self.evm_shapes.append(shape)
        self.evm_roots[shape] = root

    def evm_root(self, shape) -> TxRootCircuit:
        assert shape in self.evm_roots, (
            "contract-call shape not registered with the recursion state "
            "(a block prover pre-scans witnesses and registers shapes)"
        )
        return self.evm_roots[shape]

    def variant_of_evm(self, shape) -> int:
        return len(self.overlaps) + self.evm_shapes.index(shape)

    def dummy_root(self):
        """The no-op padding-dummy leaf circuit (always in the variant
        list; tiny, so never disk-cached)."""
        if self._dummy_root is None:
            from .root import build_dummy_root

            times: Dict[str, Dict[str, float]] = {}
            r = build_dummy_root(self.config, times)
            self.build_times["dummy"] = times
            if self._root_log_n is not None:
                assert r.log_n <= self._root_log_n
                r.log_n = self._root_log_n
            self._dummy_root = r
        return self._dummy_root

    def register_withdrawals(self, n: int) -> None:
        """Register a withdrawal-dummy leaf variant (n credits). Must
        happen before ladder materialization, like register_evm."""
        if n in self.wd_roots:
            return
        assert self.binding_shape is not None, (
            "withdrawal kernels need a binding KernelShape"
        )

        def build(times=None, n=n):
            from .root import build_withdrawal_root

            return build_withdrawal_root(
                n, self.binding_shape, self.sizes, self.config, self.device, times
            )

        root = self._load_or_build_root("wdroot", n, build)
        if self._root_log_n is not None:
            assert self._ladder is None or n in self.wd_roots, (
                f"withdrawal count {n} registered after ladder materialization"
            )
            assert root.log_n <= self._root_log_n
            root.log_n = self._root_log_n
        self.wd_counts.append(n)
        self.wd_roots[n] = root

    def variant_of_dummy(self) -> int:
        return len(self.overlaps) + len(self.evm_shapes)

    def variant_of_wd(self, n: int) -> int:
        return self.variant_of_dummy() + 1 + self.wd_counts.index(n)

    def _materialize_all(self) -> None:
        for o in self.overlaps:
            if o not in self.roots:
                self.root(o)

    @property
    def root_log_n(self) -> int:
        if self._root_log_n is None:
            self._materialize_all()
            all_roots = (
                list(self.roots.values())
                + list(self.evm_roots.values())
                + [self.dummy_root()]
                + list(self.wd_roots.values())
            )
            self._root_log_n = max(r.log_n for r in all_roots)
            for r in all_roots:
                r.log_n = self._root_log_n
        return self._root_log_n

    @property
    def ladder(self) -> AggLadder:
        if self._ladder is None:
            n = self.root_log_n  # materializes + pads all variants
            leaf_starks = [self.roots[o].stark for o in self.overlaps]
            leaf_starks += [self.evm_roots[s].stark for s in self.evm_shapes]
            leaf_starks.append(self._dummy_root.stark)
            leaf_starks += [self.wd_roots[n_].stark for n_ in self.wd_counts]
            self._ladder = AggLadder(
                leaf_starks, n, self.config, cache_tag=self.cache_key,
                device=self.device,
            )
        return self._ladder

    def variant_of(self, overlap: str) -> int:
        return self.overlaps.index(overlap)


_STATES: Dict[tuple, RecursionState] = {}


def fitting_overlaps(sizes: TableSizes, binding_shape: Optional[object] = None) -> List[str]:
    """The default overlap variants: those of OVERLAP_VARIANTS whose kernel
    program fits the CPU table (2^sizes.cpu rows), in registry order. The
    counterpart registers all five whatever the sizes, so at its own
    succinct fixture (cpu = 2^5: the distinct kernel has 31 instructions,
    the others 33-35) the ladder fails building the second root (ROADMAP
    Queue 3); where every variant fits, as at the default sizes, the two
    lists are the same."""
    return [o for o in OVERLAP_VARIANTS
            if len(transfer_cpu_stark(o, binding_shape).program) <= 1 << sizes.cpu]


def recursion_state(
    sizes: TableSizes,
    config: StarkConfig,
    overlaps: Optional[List[str]] = None,
    binding_shape: Optional[object] = None,
    evm_shapes: Optional[List[object]] = None,
    wd_counts: Optional[List[int]] = None,
    device=None,
) -> RecursionState:
    """Process-wide cache keyed by (sizes, config identity, overlap set,
    binding shape, evm shapes, withdrawal counts, device). The overlap set
    defaults to `fitting_overlaps(sizes, binding_shape)`. The evm shape
    and wd count lists are ORDERED — they assign leaf variant indices, so
    prover and verifier must pass the same lists (they travel in the
    block proof). `device` (None: the CUDA card; raises without one unless
    the caller names the CPU) is where the state's circuits commit their
    vkeys and prove."""
    dev = resolve_device(device)
    if overlaps is None:
        overlaps = fitting_overlaps(sizes, binding_shape)
    evm_shapes = list(evm_shapes or [])
    wd_counts = list(wd_counts or [])
    key = (
        tuple(sorted(vars(sizes).items())),
        config.num_challenges,
        tuple(sorted(vars(config.fri_config).items())),
        tuple(overlaps),
        binding_shape,
        tuple(evm_shapes),
        tuple(wd_counts),
    )
    if key + (str(dev),) not in _STATES:
        st = RecursionState(
            sizes=sizes, config=config, overlaps=overlaps,
            binding_shape=binding_shape, cache_key=repr(key), device=dev,
        )
        for sh in evm_shapes:
            st.register_evm(sh)
        for n in wd_counts:
            st.register_withdrawals(n)
        _STATES[key + (str(dev),)] = st
    return _STATES[key + (str(dev),)]
