"""zkEVM tables. Counterpart: ethproof_tpu/tables/__init__.py:1 (Memory only so far)."""
