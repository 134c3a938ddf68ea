"""zkEVM tables. Counterpart: ethproof_tpu/tables/__init__.py:1.

The seven tables of the transfer proof (CPU, Arithmetic, Logic,
BytePacking, Memory, Keccak, KeccakSponge) and `all`, their wiring; the
EVM machine table (`evm`); the Poseidon table (`poseidon_table`), whose
arithmetization the verifier machine reuses.
"""
