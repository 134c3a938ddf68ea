"""Intrinsic transaction gas (Berlin/London rules).

Counterpart: ethproof_tpu/evm/gas.py:29-71 (`intrinsic_gas` and its
constants, copied). The opcode metering of that module serves the EVM
machine, which is not ported.
"""

from __future__ import annotations

G_TX = 21000
G_TXDATA_ZERO = 4
G_TXDATA_NONZERO = 16  # EIP-2028
G_ACCESS_LIST_ADDRESS = 2400  # EIP-2930
G_ACCESS_LIST_STORAGE_KEY = 1900


def intrinsic_gas(tx) -> int:
    """Tx intrinsic cost: base + calldata + access list (EIP-2930).
    Contract creation (+32000) is outside the envelope."""
    g = G_TX
    for b in tx.data:
        g += G_TXDATA_ZERO if b == 0 else G_TXDATA_NONZERO
    for _addr, keys in tx.access_list:
        g += G_ACCESS_LIST_ADDRESS + G_ACCESS_LIST_STORAGE_KEY * len(keys)
    return g
