"""STARK engine: table interface, prover and host verifier.

Counterpart: ethproof_tpu/stark/__init__.py:1.
"""
