"""RLP encoding/decoding (Ethereum wire format).

Counterpart: ethproof_tpu/trie/rlp.py:1 (a copy).

Reference equivalent: the `rlp` crate used throughout
leader/src/mpt.rs (e.g. rlp::decode_list at mpt.rs:47-125).
"""

from __future__ import annotations

from typing import List, Union

Item = Union[bytes, List["Item"]]


def encode(item: Item) -> bytes:
    if isinstance(item, (bytes, bytearray)):
        b = bytes(item)
        if len(b) == 1 and b[0] < 0x80:
            return b
        return _len_prefix(len(b), 0x80) + b
    if isinstance(item, int):
        # ints encode as big-endian minimal bytes (0 -> empty string)
        return encode(int_to_bytes(item))
    payload = b"".join(encode(x) for x in item)
    return _len_prefix(len(payload), 0xC0) + payload


def _len_prefix(n: int, offset: int) -> bytes:
    if n < 56:
        return bytes([offset + n])
    nb = int_to_bytes(n)
    return bytes([offset + 55 + len(nb)]) + nb


def int_to_bytes(v: int) -> bytes:
    assert v >= 0
    if v == 0:
        return b""
    out = []
    while v:
        out.append(v & 0xFF)
        v >>= 8
    return bytes(reversed(out))


def bytes_to_int(b: bytes) -> int:
    return int.from_bytes(b, "big")


def decode(data: bytes) -> Item:
    item, rest = _decode_one(memoryview(data))
    if rest:
        raise ValueError(f"trailing RLP bytes: {len(rest)}")
    return item


def _decode_one(data):
    if not len(data):
        raise ValueError("empty RLP input")
    b0 = data[0]
    if b0 < 0x80:
        return bytes(data[:1]), data[1:]
    if b0 < 0xB8:  # short string
        n = b0 - 0x80
        return bytes(data[1 : 1 + n]), data[1 + n :]
    if b0 < 0xC0:  # long string
        ln = b0 - 0xB7
        n = bytes_to_int(bytes(data[1 : 1 + ln]))
        return bytes(data[1 + ln : 1 + ln + n]), data[1 + ln + n :]
    if b0 < 0xF8:  # short list
        n = b0 - 0xC0
        return _decode_list(data[1 : 1 + n]), data[1 + n :]
    ln = b0 - 0xF7
    n = bytes_to_int(bytes(data[1 : 1 + ln]))
    return _decode_list(data[1 + ln : 1 + ln + n]), data[1 + ln + n :]


def _decode_list(payload):
    out = []
    while len(payload):
        item, payload = _decode_one(payload)
        out.append(item)
    return out
