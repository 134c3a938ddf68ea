"""Nibble keys + hex-prefix (compact) encoding for MPT paths.

Counterpart: ethproof_tpu/trie/nibbles.py:1 (a copy).

Reference equivalent: `mpt_trie::nibbles::Nibbles` (pin
Cargo.lock:2846) and the hex-prefix handling in
leader/src/mpt.rs:88-123 (odd/even first-byte cases).
"""

from __future__ import annotations

from typing import Tuple


class Nibbles:
    """An immutable sequence of 4-bit values (trie path)."""

    __slots__ = ("vals",)

    def __init__(self, vals: Tuple[int, ...] = ()):  # each in [0, 16)
        self.vals = tuple(vals)

    @classmethod
    def from_bytes(cls, b: bytes) -> "Nibbles":
        out = []
        for byte in b:
            out.append(byte >> 4)
            out.append(byte & 0xF)
        return cls(tuple(out))

    @classmethod
    def from_hex_prefix(cls, b: bytes) -> Tuple["Nibbles", bool]:
        """Decode compact encoding -> (nibbles, is_leaf)."""
        if not b:
            return cls(), False
        flag = b[0] >> 4
        is_leaf = flag >= 2
        odd = flag & 1
        out = []
        if odd:
            out.append(b[0] & 0xF)
        for byte in b[1:]:
            out.append(byte >> 4)
            out.append(byte & 0xF)
        return cls(tuple(out)), is_leaf

    def to_hex_prefix(self, is_leaf: bool) -> bytes:
        flag = 2 if is_leaf else 0
        vals = self.vals
        if len(vals) % 2:
            first = ((flag + 1) << 4) | vals[0]
            rest = vals[1:]
        else:
            first = flag << 4
            rest = vals
        out = [first]
        for i in range(0, len(rest), 2):
            out.append((rest[i] << 4) | rest[i + 1])
        return bytes(out)

    # -- sequence-ish helpers ------------------------------------------------

    def __len__(self) -> int:
        return len(self.vals)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return Nibbles(self.vals[i])
        return self.vals[i]

    def __add__(self, other: "Nibbles") -> "Nibbles":
        return Nibbles(self.vals + other.vals)

    def __eq__(self, other) -> bool:
        return isinstance(other, Nibbles) and self.vals == other.vals

    def __hash__(self):
        return hash(self.vals)

    def __repr__(self):
        return "Nibbles(" + "".join(f"{v:x}" for v in self.vals) + ")"

    def common_prefix_len(self, other: "Nibbles") -> int:
        n = 0
        for a, b in zip(self.vals, other.vals):
            if a != b:
                break
            n += 1
        return n

    def starts_with(self, other: "Nibbles") -> bool:
        return self.vals[: len(other.vals)] == other.vals
