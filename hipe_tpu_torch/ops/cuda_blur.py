"""The binomial blur on the card: wrappers of kernel K1 (``csrc/blur_planar.cu``).

The counterpart of ``hipe_tpu.ops.pallas_blur``'s blur kernels: K1 computes
what ``_blur_mxu_kernel`` (``path="mxu"``), ``_blur_kernel`` (``path="vpu"``)
and ``_chain_mxu_kernel`` on a one-stage gaussian chain compute, as an exact
integer stencil written for Hopper, on planar ``(N, H, W)`` planes
(:func:`gaussian_blur_planar_cuda`) and on interleaved rows ``(B, H, W*C)``
(:func:`gaussian_blur_rows_cuda`, ``gaussian_blur_rows_pallas``'s
counterpart). Every other chain runs K2-K5, as
:func:`hipe_tpu_torch.ops.planar.filter_planar` routes it.

For a CUDA tensor each wrapper launches K1 or raises; for a CPU tensor it
runs the plain PyTorch version (:func:`hipe_tpu_torch.ops.blur.gaussian_blur_planar`,
:func:`hipe_tpu_torch.ops.blur.gaussian_blur_rows`), which is also what the
kernel is held against on the card.
"""

from __future__ import annotations

import torch

from hipe_tpu_torch.ops import _build
from hipe_tpu_torch.ops._build import I, P
from hipe_tpu_torch.ops.blur import GAUSSIANS, gaussian_blur_planar, gaussian_blur_rows
from hipe_tpu_torch.ops.chain_program import check_planar_call

# Output rows of a warp's band when the caller names none; the runner's
# autotune sweeps the alternatives.
DEFAULT_ROWS_PER_BLOCK = 16


def out_rows(h: int, radius: int, h_pad: bool) -> int:
    """Rows of the blurred plane: H with clamping, H - 2r in valid mode."""
    return h if h_pad else h - 2 * radius


def _check_call(x: torch.Tensor, radius: int, h_pad: bool,
                rows_per_block: int | None, out: torch.Tensor | None) -> tuple[int, int]:
    """Check a K1 call on a 3-D uint8 tensor; returns the output rows and
    rows_per_block."""
    if not 1 <= radius <= 4:
        raise ValueError(f"radius must be 1-4, got {radius}")
    rpb = DEFAULT_ROWS_PER_BLOCK if rows_per_block is None else rows_per_block
    _, ho, rpb = check_planar_call(x, (GAUSSIANS[radius - 1],), h_pad, rpb, out)
    return ho, rpb


@_build.entry("hipe_blur_planar_u8", P, P, I, I, I, I, I, I)
def gaussian_blur_planar_cuda(
    x: torch.Tensor,
    radius: int = 1,
    *,
    h_pad: bool = True,
    rows_per_block: int | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Binomial blur of planar ``(N, H, W)`` uint8 planes, radius 1-4.

    W clamps at its edges; H clamps with ``h_pad`` (output ``(N, H, W)``)
    and is valid-only without it (output ``(N, H - 2r, W)``). ``out``, if
    given, receives the result and must not share memory with ``x``.
    ``rows_per_block`` is K1's launch knob (output rows of the band a warp
    walks; at least the plane's rows means one band per plane).
    """
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise TypeError(
            f"expected a 3-D uint8 tensor, got {x.dtype} of shape {tuple(x.shape)}")
    ho, rpb = _check_call(x, radius, h_pad, rows_per_block, out)
    n, h, w = x.shape
    if x.device.type == "cpu":
        y = gaussian_blur_planar(x, radius, h_pad=h_pad)
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty((n, ho, w), dtype=torch.uint8, device=x.device)
    gaussian_blur_planar_cuda.launch(
        x, lambda: f"blur_planar_u8 launch failed for {(n, h, w)} r={radius} "
                   f"h_pad={h_pad} rows_per_block={rpb}",
        x.data_ptr(), out.data_ptr(), n, h, w, radius, int(h_pad), rpb)
    return out


@_build.entry("hipe_blur_rows_u8", P, P, I, I, I, I, I, I, I)
def gaussian_blur_rows_cuda(
    rows: torch.Tensor,
    channels: int,
    radius: int = 1,
    *,
    h_pad: bool = True,
    rows_per_block: int | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Binomial blur of interleaved rows ``(B, H, W*C)`` uint8, radius 1-4.

    The counterpart of ``gaussian_blur_rows_pallas``: each row is W pixels
    of ``channels`` interleaved bytes, and the W edge clamps a whole pixel.
    H clamps with ``h_pad`` (output ``(B, H, W*C)``) and is valid-only
    without it (``(B, H - 2r, W*C)``). ``out`` and ``rows_per_block`` as in
    :func:`gaussian_blur_planar_cuda`.
    """
    ho, rpb = _check_call(rows, radius, h_pad, rows_per_block, out)
    b, h, lanes = rows.shape
    if channels < 1 or lanes % channels:
        raise ValueError(f"row length {lanes} is not a multiple of {channels} channels")
    if rows.device.type == "cpu":
        y = gaussian_blur_rows(rows, channels, radius, h_pad=h_pad)
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty((b, ho, lanes), dtype=torch.uint8, device=rows.device)
    gaussian_blur_rows_cuda.launch(
        rows, lambda: f"blur_rows_u8 launch failed for {(b, h, lanes)} C={channels} "
                      f"r={radius} h_pad={h_pad} rows_per_block={rpb}",
        rows.data_ptr(), out.data_ptr(), b, h, lanes // channels, channels, radius,
        int(h_pad), rpb)
    return out


def gaussian_blur_nhwc_cuda(x: torch.Tensor, radius: int = 1, **kw) -> torch.Tensor:
    """``(B, H, W, C)`` wrapper of :func:`gaussian_blur_rows_cuda`, the
    counterpart of ``gaussian_blur_nhwc_pallas``: a free reshape to rows."""
    b, h, w, c = x.shape
    out = kw.pop("out", None)
    if out is not None:
        out = out.view(b, out.shape[1], w * c)
    y = gaussian_blur_rows_cuda(x.reshape(b, h, w * c), c, radius, out=out, **kw)
    return y.view(b, y.shape[1], w, c)
