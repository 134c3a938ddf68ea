"""Consensus gas accounting (Berlin/London/Shanghai rules).

Counterpart: ethproof_tpu/evm/gas.py:1 (a copy).

Reference equivalent: evm_arithmetization's kernel charges gas inside
the CPU table and exposes gas_used in the public values
[dep: from knowledge; the reference's GenerationInputs carries
gas_used_before/after consumed by proof_gen]. Here the host
interpreter (tables/evm.py execute_evm) meters every cycle with this
module, the tx kernel (evm/contract.py) adds the intrinsic cost and
applies the refund cap, and the result must MATCH the witness's
gas_used_after - gas_used_before — gas becomes a re-derived quantity
instead of a trusted one. The machine STARK additionally tracks the
frame gas in-circuit (tables/evm.py GAS column) so the total is
proof-bound, not merely host-checked.

Covered (the machine's envelope): intrinsic gas (EIP-2028 calldata,
EIP-2930 access lists), static opcode costs, memory expansion
(quadratic), KECCAK256 word cost, LOG costs, EIP-2929 cold/warm
storage access, EIP-2200 net-metered SSTORE with EIP-3529 refunds
(cap gas/5). Not modelled: running out of gas mid-frame (the witness
gas limit is assumed sufficient — a tx that OOGs is outside the
envelope), the EIP-2200 gas-left > 2300 SSTORE sentinel.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Set

# -- intrinsic ------------------------------------------------------------------

G_TX = 21000
G_TXDATA_ZERO = 4
G_TXDATA_NONZERO = 16  # EIP-2028
G_ACCESS_LIST_ADDRESS = 2400  # EIP-2930
G_ACCESS_LIST_STORAGE_KEY = 1900

# -- opcode static costs ----------------------------------------------------------

G_BASE = 2
G_VERYLOW = 3
G_LOW = 5
G_MID = 8
G_HIGH = 10
G_JUMPDEST = 1

G_KECCAK256 = 30
G_KECCAK256_WORD = 6

G_LOG = 375
G_LOG_TOPIC = 375
G_LOG_DATA = 8

# -- EIP-2929 / EIP-2200 / EIP-3529 storage -------------------------------------

G_COLD_SLOAD = 2100
G_WARM_ACCESS = 100
G_SSTORE_SET = 20000
G_SSTORE_RESET = 5000 - G_COLD_SLOAD  # 2900
R_SSTORE_CLEARS = 4800  # EIP-3529
MAX_REFUND_QUOTIENT = 5  # refund cap = gas_used // 5 (EIP-3529)


def intrinsic_gas(tx) -> int:
    """Tx intrinsic cost: base + calldata + access list (EIP-2930).
    Contract creation (+32000) is outside the envelope."""
    g = G_TX
    for b in tx.data:
        g += G_TXDATA_ZERO if b == 0 else G_TXDATA_NONZERO
    for _addr, keys in tx.access_list:
        g += G_ACCESS_LIST_ADDRESS + G_ACCESS_LIST_STORAGE_KEY * len(keys)
    return g


def memory_cost(words: int) -> int:
    """C(a) = 3a + floor(a^2/512) for a words of touched memory."""
    return 3 * words + words * words // 512


def words_for(offset: int, length: int) -> int:
    """Word-count high-water mark for touching [offset, offset+length)."""
    if length == 0:
        return 0
    return (offset + length + 31) // 32


@dataclass
class GasMeter:
    """Per-frame execution gas: static costs + memory expansion +
    net-metered storage. `warm` starts from the tx access list's keys
    for the executing contract (EIP-2929 pre-warming)."""

    original: Dict[int, int]  # slot -> pre-tx value (net metering base)
    warm: Set[int] = field(default_factory=set)
    used: int = 0
    refund: int = 0
    mem_words: int = 0

    def charge(self, amount: int) -> None:
        self.used += amount

    def charge_mem(self, offset: int, length: int) -> None:
        """Memory expansion to cover [offset, offset+length)."""
        new = words_for(offset, length)
        if new > self.mem_words:
            self.charge(memory_cost(new) - memory_cost(self.mem_words))
            self.mem_words = new

    def charge_keccak(self, length: int) -> None:
        self.charge(G_KECCAK256 + G_KECCAK256_WORD * ((length + 31) // 32))

    def charge_log(self, n_topics: int, data_len: int) -> None:
        self.charge(G_LOG + G_LOG_TOPIC * n_topics + G_LOG_DATA * data_len)

    def charge_sload(self, key: int) -> None:
        if key in self.warm:
            self.charge(G_WARM_ACCESS)
        else:
            self.warm.add(key)
            self.charge(G_COLD_SLOAD)

    def charge_sstore(self, key: int, current: int, value: int) -> None:
        """EIP-2929 cold surcharge + EIP-2200 net metering + EIP-3529
        refunds. `current` is the slot value before this store."""
        if key not in self.warm:
            self.warm.add(key)
            self.charge(G_COLD_SLOAD)
        original = self.original.get(key, 0)
        if value == current:
            self.charge(G_WARM_ACCESS)
            return
        if current == original:
            self.charge(G_SSTORE_SET if original == 0 else G_SSTORE_RESET)
            if original != 0 and value == 0:
                self.refund += R_SSTORE_CLEARS
            return
        # dirty slot
        self.charge(G_WARM_ACCESS)
        if original != 0:
            if current == 0:
                self.refund -= R_SSTORE_CLEARS
            elif value == 0:
                self.refund += R_SSTORE_CLEARS
        if value == original:
            if original == 0:
                self.refund += G_SSTORE_SET - G_WARM_ACCESS
            else:
                self.refund += G_SSTORE_RESET - G_WARM_ACCESS


def tx_gas_used(
    intrinsic: int, frame_used: int, frame_refund: int, success: int
) -> int:
    """Total tx gas: intrinsic + execution, minus the capped refund.
    A reverted frame keeps its spent gas but forfeits refunds."""
    total = intrinsic + frame_used
    if not success:
        return total
    refund = min(max(frame_refund, 0), total // MAX_REFUND_QUOTIENT)
    return total - refund
