"""Runtime helpers. Counterpart: ethproof_tpu/runtime/__init__.py:1."""
