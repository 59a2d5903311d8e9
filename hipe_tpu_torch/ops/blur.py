"""Integer-exact binomial blur in plain PyTorch (counterpart of ``hipe_tpu.ops.blur``).

These are the plain tensor versions of the blur: uint8 in, int32
accumulate, ``>> 4r``, uint8 out, clamp-to-edge borders. They are what the
CUDA kernel in :mod:`hipe_tpu_torch.ops.cuda_blur` is held against, and
what its wrapper runs for a tensor that lies on the CPU. They work on any
layout where H and W are identifiable axes (NHWC, HWC, planar ``(N, H, W)``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from hipe_tpu_torch.ops.reference import binomial_taps as _np_binomial_taps


def binomial_taps(radius: int) -> tuple[tuple[int, ...], int]:
    """Integer binomial taps and per-axis shift (see ops.reference)."""
    taps, shift = _np_binomial_taps(radius)
    return tuple(int(t) for t in taps), shift


def _edge_pad_axis(x: torch.Tensor, axis: int, r: int) -> torch.Tensor:
    """Pad ``x`` by ``r`` along ``axis`` by replicating the edge slices."""
    n = x.shape[axis]
    first = x.narrow(axis, 0, 1)
    last = x.narrow(axis, n - 1, 1)
    reps = [1] * x.dim()
    reps[axis] = r
    return torch.cat([first.repeat(reps), x, last.repeat(reps)], dim=axis)


def _conv1d(x: torch.Tensor, axis: int, taps: Sequence[int], pad: bool) -> torch.Tensor:
    """1-D integer correlation along ``axis``.

    With ``pad=True`` the borders clamp to the edge (output length == input
    length); with ``pad=False`` only the valid interior is computed (output
    length == input - 2*radius), for inputs that carry their halo rows.
    """
    r = (len(taps) - 1) // 2
    xp = _edge_pad_axis(x, axis, r) if pad else x
    n = xp.shape[axis] - 2 * r
    if n < 1:
        raise ValueError(
            f"valid mode needs more than {2 * r} entries along axis {axis}, "
            f"got {xp.shape[axis]}"
        )
    acc = None
    for j, t in enumerate(taps):
        sl = xp.narrow(axis, j, n)
        term = sl if t == 1 else sl * t
        acc = term if acc is None else acc + term
    return acc


def gaussian_blur(
    x: torch.Tensor,
    radius: int = 1,
    *,
    h_axis: int = -3,
    w_axis: int = -2,
    h_pad: bool = True,
) -> torch.Tensor:
    """Separable binomial Gaussian blur, integer-exact.

    radius=1 is the reference 3x3 kernel (``gaussian_kernel.cl:36-41,70``);
    radius 2-4 are the 5x5/7x7/9x9 separable variants. Default axes assume
    channels-last layouts (..., H, W, C). W always clamps at its edges; H
    clamps only with ``h_pad`` — ``h_pad=False`` treats H as carrying
    ``radius`` halo rows per side and returns ``H - 2*radius`` rows.
    """
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {x.dtype}")
    taps, shift = binomial_taps(radius)
    acc = x.to(torch.int32)
    acc = _conv1d(acc, w_axis % x.dim(), taps, pad=True)
    acc = _conv1d(acc, h_axis % x.dim(), taps, pad=h_pad)
    return (acc >> (2 * shift)).to(torch.uint8)


def gaussian_blur3x3(x: torch.Tensor, **kw) -> torch.Tensor:
    """The reference kernel: 3x3 binomial blur (``gaussian_kernel.cl:19-72``)."""
    return gaussian_blur(x, radius=1, **kw)


def gaussian_blur_planar(x: torch.Tensor, radius: int = 1, *,
                         h_pad: bool = True) -> torch.Tensor:
    """Blur for planar layouts (..., H, W) — one plane per (image, channel)."""
    return gaussian_blur(x, radius, h_axis=-2, w_axis=-1, h_pad=h_pad)


# Pipeline stage name -> blur radius (the gaussian rows of hipe_tpu's
# FILTER_RADIUS; the other stages are still to be ported).
FILTER_RADIUS = {"gaussian3": 1, "gaussian5": 2, "gaussian7": 3, "gaussian9": 4}
