"""Goldilocks field GF(p), p = 2^64 - 2^32 + 1, on int64 tensors.

Counterpart: ethproof_tpu/gf/__init__.py:1.
"""

from . import extension, field, field_host  # noqa: F401
