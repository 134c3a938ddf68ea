"""Poseidon hashing and Merkle trees. Counterpart: ethproof_tpu/hash/__init__.py:1."""
