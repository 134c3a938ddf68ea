"""Multi-device proving: the mesh and the sharded commit and sweep.

Counterpart: ethproof_tpu/parallel/__init__.py:1. A single-controller
mesh of indexed torch devices with a `tx` axis (transactions side by side)
and a `col` axis (trace columns through the NTTs, then domain blocks
through Merkle hashing and the constraint sweep); see `mesh`.
"""

from . import mesh  # noqa: F401
