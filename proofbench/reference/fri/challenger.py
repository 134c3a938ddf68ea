"""[The benchmark's frozen copy of ethproof_tpu_torch/fri/challenger.py.]

Fiat-Shamir challenger: Poseidon duplex sponge over Goldilocks.

Counterpart: ethproof_tpu/fri/challenger.py:1 (a copy, on the port's own
host Poseidon).

Semantics follow plonky2's `iop::challenger::Challenger`:

- `observe_element` clears the output buffer, pushes to the input buffer,
  and duplexes when RATE (8) inputs have accumulated.
- `duplexing` overwrites the first len(input) state lanes with the buffered
  inputs, permutes, and refills the output buffer with state[0..8].
- `get_challenge` duplexes if there are pending inputs or no buffered
  outputs, then pops from the END of the output buffer (Vec::pop), i.e.
  challenges stream as state[7], state[6], ...

Transcript order is soundness-critical: every
observation/squeeze in prover and verifier must pair up exactly. The
challenger runs HOST-side on python ints — per proof phase only a handful
of field elements cross the host/device boundary (a Merkle cap, a few
challenges), so this costs nothing and keeps transcript code trivially
auditable against the device kernels it drives.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

from ..gf import field_host as fh
from ..hash import poseidon

RATE = poseidon.SPONGE_RATE
WIDTH = poseidon.SPONGE_WIDTH


class Challenger:
    def __init__(self) -> None:
        self.state: List[int] = [0] * WIDTH
        self.input_buffer: List[int] = []
        self.output_buffer: List[int] = []

    # -- observations -------------------------------------------------------

    def observe_element(self, x: int) -> None:
        assert 0 <= x < fh.P
        self.output_buffer.clear()
        self.input_buffer.append(x)
        if len(self.input_buffer) == RATE:
            self._duplex()

    def observe_elements(self, xs: Iterable[int]) -> None:
        for x in xs:
            self.observe_element(int(x))

    def observe_extension(self, x: Tuple[int, int]) -> None:
        self.observe_element(x[0])
        self.observe_element(x[1])

    def observe_cap(self, cap) -> None:
        """cap: iterable of 4-element digests (or a (4, n) array)."""
        import numpy as np

        arr = np.asarray(cap, dtype=np.uint64)
        if arr.ndim == 2:  # (4, n) device layout -> digest-major order
            for i in range(arr.shape[1]):
                self.observe_elements(int(v) for v in arr[:, i])
        else:
            self.observe_elements(int(v) for v in arr.ravel())

    # -- challenges ---------------------------------------------------------

    def get_challenge(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> List[int]:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self) -> Tuple[int, int]:
        return (self.get_challenge(), self.get_challenge())

    # -- internals ----------------------------------------------------------

    def _duplex(self) -> None:
        for i, x in enumerate(self.input_buffer):
            self.state[i] = x
        self.input_buffer.clear()
        self.state = poseidon.permute_host(self.state)
        self.output_buffer = list(self.state[:RATE])
