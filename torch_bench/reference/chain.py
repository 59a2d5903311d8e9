"""Reference of ``chain``: blur3, then sharpen, then edge, each stage
stored as saturated uint8 before the next reads it."""

import torch

from reference.stencils import edge, gaussian3, sharpen


def apply(planes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(N, H, W) uint8 -> (N, H, W) uint8."""
    return edge(sharpen(gaussian3(planes, dtype), dtype), dtype)
