"""Matmul precision of the port: the strict lane only.

The JAX package's ``strict`` lane runs every contraction at
``Precision.HIGHEST`` -- true float32 (``ops/distance.py``).  On the card
the counterpart is IEEE float32 matmuls with TF32 off, for cuBLAS and
cuDNN alike; importing this module sets both.  The mixed and fast lanes
(split-bf16 grams, 3-pass linalg) are not ported.
"""

from __future__ import annotations

import torch


def active_lane() -> str:
    """The precision lane in effect: ``"strict"``, the port's only one."""
    return "strict"


def use_strict_lane() -> None:
    """Turn TF32 off for matmuls and convolutions (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


use_strict_lane()
