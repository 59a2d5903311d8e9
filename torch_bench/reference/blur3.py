"""Reference of ``blur3``: the reference program's 3x3 binomial blur."""

import torch

from reference.stencils import gaussian3


def apply(planes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(N, H, W) uint8 -> (N, H, W) uint8."""
    return gaussian3(planes, dtype)
