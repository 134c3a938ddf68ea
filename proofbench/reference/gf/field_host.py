"""[The benchmark's frozen copy of ethproof_tpu_torch/gf/field_host.py, without
the host NTT and the u32-pair conversions.]

Exact host-side (python int / numpy) Goldilocks arithmetic.

Counterpart: ethproof_tpu/gf/field_host.py:1 (a copy; the port imports nothing of the JAX package).

Used for twiddle and root-table precomputation, Poseidon constants, and
anywhere the host needs exact field math. Python ints are arbitrary
precision, so this module is trivially correct; the tensor implementation
in field.py is tested against it.

Reference equivalent: `plonky2_field::goldilocks_field`.
"""

from __future__ import annotations

P = (1 << 64) - (1 << 32) + 1
EPSILON = (1 << 32) - 1  # 2^64 mod p

# Generator of the full multiplicative group (order p-1).
MULT_GROUP_GEN = 7
TWO_ADICITY = 32


def add(a: int, b: int) -> int:
    return (a + b) % P


def sub(a: int, b: int) -> int:
    return (a - b) % P


def mul(a: int, b: int) -> int:
    return (a * b) % P


def neg(a: int) -> int:
    return (-a) % P


def inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of zero in GF(p)")
    return pow(a, P - 2, P)


def exp(a: int, e: int) -> int:
    return pow(a, e, P)


def primitive_root_of_unity(n_log: int) -> int:
    """Generator of the order-2^n_log subgroup (matches plonky2's
    `power_of_two_generator` derivation: g^((p-1) / 2^n_log))."""
    if n_log > TWO_ADICITY:
        raise ValueError(f"two-adicity exceeded: {n_log} > {TWO_ADICITY}")
    return pow(MULT_GROUP_GEN, (P - 1) >> n_log, P)
