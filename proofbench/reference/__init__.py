"""The benchmark's plain reference prover: what `correct` is decided against.

A frozen copy of the plain PyTorch parts of `ethproof_tpu_torch` that one
single-table `stark_prove` reaches, taken when the benchmark was written
and kept apart so that later changes to the program do not move it. It
imports nothing of the program (nor JAX). Where it departs from the
program, it takes the plainest route to the same bits:
- every NTT is the radix-2 transform of `poly/ntt.py` (no four-step, no
  base-DFT kernel: `poly/transform.py`);
- the constraint sweep evaluates `stark.eval` directly over the whole LDE
  domain (the program's "eager" oracle), never a recorded IR program;
- one device, no mesh, no disk caches, no phase timers.

`hash.poseidon.MATMUL_DTYPE` selects the float type of the Poseidon MDS
matmul: float64 (exact, the reference) or float32 (the control, see
`proofbench/control.py`).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device named (None: the CUDA card)."""
    return torch.device("cuda" if device is None else device)
