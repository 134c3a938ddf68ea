"""zkEVM tables. Counterpart: ethproof_tpu/tables/__init__.py:1.

The seven tables of the transfer proof (CPU, Arithmetic, Logic,
BytePacking, Memory, Keccak, KeccakSponge) and `all`, their wiring. The
EVM machine table (`tables/evm.py`) is not ported yet.
"""
