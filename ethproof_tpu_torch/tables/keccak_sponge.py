"""The KeccakSponge table's shared names: its request type and op ids.

Counterpart: ethproof_tpu/tables/keccak_sponge.py:38-42, :125 and :250-262
(`RATE_BYTES`, `OP_KECCAK_DIGEST`, `OP_SPONGE_INIT`, `HashRequest`,
copied). The CPU table and the kernel assembler name these; the table
itself (`KeccakSpongeStark`, its trace generator and CTL specs) comes with
the seven-table transfer, beside the Keccak table.
"""

from __future__ import annotations

from dataclasses import dataclass

RATE_BYTES = 136
OP_KECCAK_DIGEST = 13
OP_SPONGE_INIT = 14


@dataclass
class HashRequest:
    ctx: int
    seg: int
    virt: int  # word index where the message's staged words begin
    ts: int
    message: bytes
    # True: this table emits the companion staging writes (self-contained
    # request). False: the words were already written by the CPU kernel
    # (OP_WIT / computed splices) — only reads are emitted, and memory
    # consistency binds the absorbed words to the kernel's cells.
    staged: bool = True
