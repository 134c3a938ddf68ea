"""Reference ERC-20 token runtime for the EVM machine.

Counterpart: ethproof_tpu/evm/erc20.py:1 (a copy).

A hand-assembled `transfer(address,uint256)` implementation using the
STANDARD Solidity storage layout (balances mapping at slot 0, so
balance slot = keccak256(pad32(holder) ++ pad32(0))) and ABI:

  - selector dispatch on calldata[0:4] (0xa9059cbb), unknown -> REVERT;
  - `to` is masked to 160 bits, `amount` read at calldata offset 36;
  - requires balance[caller] >= amount, else REVERT;
  - balance updates via SLOAD/SSTORE on the keccak-derived slots;
  - emits Transfer(address,address,uint256) via LOG3 (topic0 = the
    event signature hash, from/to as topics, amount as data);
  - returns abi-encoded true.

This is the flagship workload for the machine table (tables/evm.py):
it exercises dispatch, masking, mapping-slot hashing, storage, events,
control flow, and the require/revert path — the same shape solc emits.
Reference equivalent: any mainnet token transfer handled by
evm_arithmetization's kernel (SURVEY.md §2b evm_arithmetization row).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..hash.keccak import keccak256
from ..tables import evm as E

TRANSFER_SELECTOR = 0xA9059CBB  # keccak("transfer(address,uint256)")[:4]
TRANSFER_TOPIC = int.from_bytes(
    keccak256(b"Transfer(address,address,uint256)"), "big"
)
BALANCES_SLOT = 0


def balance_slot(holder: int, slot: int = BALANCES_SLOT) -> int:
    """Solidity mapping slot: keccak256(pad32(key) ++ pad32(slot))."""
    return int.from_bytes(
        keccak256(holder.to_bytes(32, "big") + slot.to_bytes(32, "big")), "big"
    )


def assemble(items: List) -> bytes:
    """Two-pass label assembler over evm.asm items plus:
    ("label", name) and ("goto", name[, n]) — a PUSHn of the label's pc."""
    # pass 1: sizes (gotos use fixed 2-byte pushes)
    pcs: Dict[str, int] = {}
    pc = 0
    for it in items:
        if isinstance(it, tuple) and it[0] == "label":
            pcs[it[1]] = pc
            pc += 1  # JUMPDEST
        elif isinstance(it, tuple) and it[0] == "goto":
            pc += 3  # PUSH2 hi lo
        elif isinstance(it, int):
            pc += 1
        elif isinstance(it, tuple) and it[0] == "push":
            val = it[1]
            n = it[2] if len(it) > 2 else max((val.bit_length() + 7) // 8, 1)
            pc += 1 + n
        else:
            raise ValueError(f"bad item {it!r}")
    # pass 2: emit
    out: List = []
    for it in items:
        if isinstance(it, tuple) and it[0] == "label":
            out.append(E.JUMPDEST)
        elif isinstance(it, tuple) and it[0] == "goto":
            out.append(("push", pcs[it[1]], 2))
        else:
            out.append(it)
    return E.asm(*out)


def transfer_runtime() -> bytes:
    """The token's runtime bytecode (transfer entrypoint only)."""
    ADDR_MASK = (1 << 160) - 1
    return assemble([
        # -- dispatch
        ("push", 0), E.CALLDATALOAD, ("push", 224), E.SHR,
        ("push", TRANSFER_SELECTOR, 4), E.EQ,
        ("goto", "transfer"), E.JUMPI,
        ("push", 0), ("push", 0), E.REVERT,

        ("label", "transfer"),
        # to = calldataload(4) & ADDR_MASK ; amount = calldataload(36)
        ("push", 4), E.CALLDATALOAD, ("push", ADDR_MASK, 20), E.AND_,
        ("push", 36), E.CALLDATALOAD,
        # stack: [to, amount]
        # slotFrom = keccak256(pad32(caller) ++ pad32(0))
        E.CALLER, ("push", 0), E.MSTORE,
        ("push", BALANCES_SLOT), ("push", 32), E.MSTORE,
        ("push", 64), ("push", 0), E.KECCAK256,
        # stack: [to, amount, slotFrom]
        DUP(1), E.SLOAD,
        # stack: [to, amount, slotFrom, balFrom]
        # require(balFrom >= amount): balFrom < amount -> revert
        DUP(3), DUP(2), E.LT,  # balFrom < amount
        ("goto", "insufficient"), E.JUMPI,
        # balance[slotFrom] = balFrom - amount
        DUP(3), DUP(2), E.SUB,  # balFrom - amount
        # stack: [to, amount, slotFrom, balFrom, newFrom]
        SWAP(1), E.POP,  # drop balFrom
        SWAP(1), E.SSTORE,  # sstore(slotFrom, newFrom)
        # stack: [to, amount]
        # slotTo = keccak256(pad32(to) ++ pad32(0))
        DUP(2), ("push", 0), E.MSTORE,
        ("push", BALANCES_SLOT), ("push", 32), E.MSTORE,
        ("push", 64), ("push", 0), E.KECCAK256,
        # stack: [to, amount, slotTo]
        DUP(1), E.SLOAD,
        # balance[slotTo] = balTo + amount
        DUP(3), E.ADD,
        # stack: [to, amount, slotTo, newTo]
        SWAP(1), E.SSTORE,
        # stack: [to, amount]
        # emit Transfer(caller, to, amount): LOG3(0, 32, topic, from, to)
        DUP(1), ("push", 0), E.MSTORE,  # data = amount at mem[0:32]
        DUP(2),  # topic3 = to
        E.CALLER,  # topic2 = from
        ("push", TRANSFER_TOPIC, 32),  # topic1 = event sig
        ("push", 32), ("push", 0),
        E.LOG0 + 3,
        # return true
        ("push", 1), ("push", 0), E.MSTORE,
        ("push", 32), ("push", 0), E.RETURN,

        ("label", "insufficient"),
        ("push", 0), ("push", 0), E.REVERT,
    ])


def router_runtime(token: bytes, fwd_gas: int = 60000) -> bytes:
    """A forwarding router: copies its calldata into memory, CALLs the
    token with it (the inner-frame flagship shape: EOA -> router ->
    ERC-20), requires success, and bubbles up the 32-byte result."""
    return assemble([
        # memcpy(0, calldata[0:cds])
        E.CALLDATASIZE, ("push", 0), ("push", 0), E.CALLDATACOPY,
        # CALL(gas, token, value=0, args=[0, cds], ret=[0x80, 32])
        ("push", 32), ("push", 0x80),
        E.CALLDATASIZE, ("push", 0),
        ("push", 0),
        ("push", int.from_bytes(token, "big"), 20),
        ("push", fwd_gas, 3),
        E.CALL,
        ("goto", "ok"), E.JUMPI,
        ("push", 0), ("push", 0), E.REVERT,
        ("label", "ok"),
        ("push", 32), ("push", 0x80), E.RETURN,
    ])


def DUP(n: int) -> int:
    return E.DUP1 + n - 1


def SWAP(n: int) -> int:
    return E.SWAP1 + n - 1


def transfer_calldata(to: int, amount: int) -> bytes:
    return (
        TRANSFER_SELECTOR.to_bytes(4, "big")
        + to.to_bytes(32, "big")
        + amount.to_bytes(32, "big")
    )


def transfer_inputs(
    caller: int, to: int, amount: int, balances: Dict[int, int]
) -> Tuple[E.EvmShape, E.EvmInputs]:
    """Build machine inputs for `transfer(to, amount)` from `caller`
    given pre-state balances {holder: amount}. Touched storage keys are
    the two balance slots (caller and recipient)."""
    code = transfer_runtime()
    calldata = transfer_calldata(to, amount)
    storage_pre = {
        balance_slot(caller): balances.get(caller, 0),
        balance_slot(to): balances.get(to, 0),
    }
    shape = E.EvmShape(
        code_len=len(code),
        calldata_len=len(calldata),
        n_skeys=len(storage_pre),
        log_rows=9,
    )
    return shape, E.EvmInputs(code, calldata, caller, 0, storage_pre)
