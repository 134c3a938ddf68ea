"""Polynomial transforms: radix-2 NTT, the CUDA base DFT, the four-step NTT.

Counterpart: ethproof_tpu/poly/__init__.py:1.
"""
