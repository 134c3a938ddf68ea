"""The benchmark of `ethproof_tpu_torch`: single-table proofs on one H100.

See README.md. Nothing here imports JAX or the JAX package.
"""
