"""PyTorch/CUDA port of the `ethproof_tpu` STARK prover.

Counterpart: ethproof_tpu/__init__.py:1. The JAX package stays the
reference; this package imports neither JAX nor anything of
`ethproof_tpu`. Field elements are `torch.int64` tensors holding the
canonical u64 bit pattern of a Goldilocks value.

Entry points take `device=None`, which means the CUDA card. They raise when
no card is present unless the caller passes `device="cpu"` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the CUDA card; raises when CUDA is absent.

    The CPU is used only when a caller names it (`device="cpu"`)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ethproof_tpu_torch runs on a CUDA card and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
