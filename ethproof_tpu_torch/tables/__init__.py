"""zkEVM tables. Counterpart: ethproof_tpu/tables/__init__.py:1.

The five tables of the transfer proof (CPU, Arithmetic, Logic,
BytePacking, Memory) and `all`, their wiring; the Keccak/KeccakSponge pair
is not ported yet (`keccak_sponge` holds only the names the CPU table and
the kernel assembler use).
"""
