"""Range parsing: "16..23" -> range(16, 23).

Counterpart: ethproof_tpu/runtime/parsing.py:1 (a copy): the `start..end`
syntax of every `*_CIRCUIT_SIZE` environment variable, with the same typed
errors (missing delimiter, missing bound, bad integer).
"""

from __future__ import annotations


class RangeParseError(ValueError):
    pass


class MissingDelimiter(RangeParseError):
    def __init__(self) -> None:
        super().__init__("range must contain '..' (e.g. '16..23')")


class MissingBound(RangeParseError):
    def __init__(self, side: str) -> None:
        super().__init__(f"range is missing its {side} bound")


class InvalidBound(RangeParseError):
    def __init__(self, text: str) -> None:
        super().__init__(f"invalid range bound: {text!r}")


def parse_range(text: str) -> range:
    if ".." not in text:
        raise MissingDelimiter()
    lhs, _, rhs = text.partition("..")
    if not lhs.strip():
        raise MissingBound("lower")
    if not rhs.strip():
        raise MissingBound("upper")
    try:
        lo = int(lhs.strip())
    except ValueError:
        raise InvalidBound(lhs.strip()) from None
    try:
        hi = int(rhs.strip())
    except ValueError:
        raise InvalidBound(rhs.strip()) from None
    return range(lo, hi)
