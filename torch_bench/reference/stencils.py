"""Plain PyTorch stencils of the reference: clamp-to-edge 3x3 windows.

The reference program's kernel (``gaussian_kernel.cl``) accumulates in
float32 and stores with a truncating uint8 conversion; every sum here is
of integers under 2^24, so float32 gives the exact integers. ``dtype`` is
the arithmetic's type: ``torch.float32`` for the reference, a narrower one
(``torch.bfloat16``) for the control that has to fail the comparison.
Planes are (N, H, W) uint8 and filtered one by one.
"""

from __future__ import annotations

import torch


def pad_edge(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) -> (N, H + 2, W + 2), each border row and column repeated."""
    x = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
    return torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)


def to_uint8(v: torch.Tensor) -> torch.Tensor:
    """Saturate to [0, 255] and truncate, as a uint8 store of the kernel does."""
    return torch.floor(v.clamp(0, 255)).to(torch.uint8)


def gaussian3(x: torch.Tensor, dtype) -> torch.Tensor:
    """The 3x3 binomial blur: sum of taps (1 2 1)x(1 2 1) times pixels, / 16."""
    p = pad_edge(x).to(dtype)
    row = p[:, :, :-2] + 2 * p[:, :, 1:-1] + p[:, :, 2:]
    acc = row[:, :-2] + 2 * row[:, 1:-1] + row[:, 2:]
    return to_uint8(acc / 16)


def sharpen(x: torch.Tensor, dtype) -> torch.Tensor:
    """[[0,-1,0],[-1,5,-1],[0,-1,0]], saturated."""
    p = pad_edge(x).to(dtype)
    acc = (5 * p[:, 1:-1, 1:-1] - p[:, :-2, 1:-1] - p[:, 2:, 1:-1]
           - p[:, 1:-1, :-2] - p[:, 1:-1, 2:])
    return to_uint8(acc)


def edge(x: torch.Tensor, dtype) -> torch.Tensor:
    """Sobel |gx| + |gy|, saturated."""
    p = pad_edge(x).to(dtype)
    h, w = x.shape[1:]

    def at(dy, dx):
        return p[:, dy:dy + h, dx:dx + w]

    gx = (at(0, 2) + 2 * at(1, 2) + at(2, 2)) - (at(0, 0) + 2 * at(1, 0) + at(2, 0))
    gy = (at(2, 0) + 2 * at(2, 1) + at(2, 2)) - (at(0, 0) + 2 * at(0, 1) + at(0, 2))
    return to_uint8(gx.abs() + gy.abs())
