"""FRI: configuration, Fiat-Shamir challenger, prover and host verifier.

Counterpart: ethproof_tpu/fri/__init__.py:1.
"""
