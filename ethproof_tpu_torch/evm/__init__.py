"""EVM front-end: transaction parsing, sender recovery, the transfer kernel.

Counterpart: ethproof_tpu/evm/__init__.py:1. Host-side, except for
`transfer.prove_transfer`, which proves on the device.
"""

from . import secp256k1, tx  # noqa: F401
