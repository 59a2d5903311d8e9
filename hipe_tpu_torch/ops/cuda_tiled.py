"""Large planes on the card: wrappers of kernels K4 (``csrc/tiled_blur_planar.cu``)
and K5 (``csrc/tiled_stage_planar.cu``).

The counterpart of ``hipe_tpu.ops.pallas_blur``'s halo-tiled path for planes
too large for the fused kernels (``gaussian_blur_planar_tiled_pallas``,
``filter_chain_planar_tiled_pallas``): K4 stands for ``_tiled_blur_kernel``
and K5 for ``_tiled_point_kernel``. Both run one stage over 2-D tiles of
``tile = (TH, TW)`` output pixels, ``TW`` rounded up to a multiple of 8
inside the kernels (a run of 8 outputs a thread). Each block stages its
tile's padded window (``csrc/tiled_lanes.cuh``): the rows and columns the
stage reads, clamped at the true plane edges in both axes as they are
staged, so that no tap clamps.

:func:`filter_chain_planar_tiled_cuda` runs a chain stage by stage, as
``hipe_tpu`` does on this path: gaussian stages on K4, every other stage on
K5, each clamping at the true edges, the intermediates in at most two
buffers of the call's own. Valid mode (``h_pad=False``) is
clamp-then-trim: the last stage writes rows ``[R, H - R)``, R the chain's
total radius, which equals ``hipe_tpu``'s per-stage valid chain.

For a CUDA tensor each wrapper launches its kernels or raises; for a CPU
tensor it runs the plain PyTorch version (:mod:`hipe_tpu_torch.ops.blur`),
which is also what the kernels are held against on the card.
"""

from __future__ import annotations

from typing import Sequence

import torch

from hipe_tpu_torch.ops import _build
from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops._build import I, P
from hipe_tpu_torch.ops.chain_program import check_planar_call, device_program, table_args

# Output tile (rows, columns) of one thread block when the caller names none;
# the runner's autotune sweeps the alternatives.
DEFAULT_TILE = (32, 256)


def check_tile(tile) -> tuple[int, int]:
    """``tile`` as ``(TH, TW)`` positive ints; ``None`` is :data:`DEFAULT_TILE`."""
    th, tw = DEFAULT_TILE if tile is None else (int(tile[0]), int(tile[1]))
    if th < 1 or tw < 1:
        raise ValueError(f"tile must be two positive ints (rows, columns), got {tile!r}")
    return th, tw


def _stage_by_stage(x: torch.Tensor, names: tuple, ho: int, tile: tuple,
                    out: torch.Tensor | None) -> torch.Tensor:
    """``names`` over ``x`` on the card, one launch a stage (K4 for a
    gaussian, K5 for any other); the last stage writes the ``ho`` rows
    centred in H into ``out`` (new if None), the others whole planes into
    at most two buffers of this call."""
    n, h, w = x.shape
    if out is None:
        out = torch.empty((n, ho, w), dtype=torch.uint8, device=x.device)
    scratch = [torch.empty((n, h, w), dtype=torch.uint8, device=x.device)
               for _ in range(min(2, len(names) - 1))]
    src = x
    for k, name in enumerate(names):
        last = k == len(names) - 1
        dst = out if last else scratch[k % 2]
        trim, rows = ((h - ho) // 2, ho) if last else (0, h)
        if name in tblur.GAUSSIANS:
            r = tblur.FILTER_RADIUS[name]
            gaussian_blur_planar_tiled_cuda.launch(
                src, lambda: f"tiled_blur_planar_u8 launch failed for {(n, h, w)} r={r} "
                             f"rows [{trim}, {trim + rows}) tile={tile}",
                src.data_ptr(), dst.data_ptr(), n, h, w, r, trim, rows, *tile)
        else:
            prog, luts, taps = device_program((name,), x.device)
            filter_stage_planar_tiled_cuda.launch(
                src, lambda: f"tiled_stage_planar_u8 launch failed for {(n, h, w)} {name} "
                             f"rows [{trim}, {trim + rows}) tile={tile}",
                src.data_ptr(), dst.data_ptr(), n, h, w, prog[0], prog[1], prog[2],
                *table_args(luts), *table_args(taps), trim, rows, *tile)
        src = dst
    return out


@_build.entry("hipe_tiled_blur_planar_u8", P, P, I, I, I, I, I, I, I, I)
def gaussian_blur_planar_tiled_cuda(
    x: torch.Tensor,
    radius: int = 1,
    *,
    tile=None,
    h_pad: bool = True,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """One binomial blur (radius 1-4) over planar ``(N, H, W)`` uint8 on K4.

    The counterpart of ``gaussian_blur_planar_tiled_pallas``. W clamps at
    its edges; H clamps with ``h_pad`` (output ``(N, H, W)``) and is
    valid-only without it (``(N, H - 2r, W)``). ``tile`` is K4's launch
    knob, ``(TH, TW)`` output pixels a block; ``out``, if given, must not
    share memory with ``x``.
    """
    if not 1 <= radius <= 4:
        raise ValueError(f"radius must be 1-4, got {radius}")
    _, ho, _ = check_planar_call(x, (tblur.GAUSSIANS[radius - 1],), h_pad, None, out)
    tile = check_tile(tile)
    if x.device.type == "cpu":
        y = tblur.gaussian_blur_planar(x, radius, h_pad=h_pad)
        return y if out is None else out.copy_(y)
    return _stage_by_stage(x, (tblur.GAUSSIANS[radius - 1],), ho, tile, out)


@_build.entry("hipe_tiled_stage_planar_u8", P, P, I, I, I, I, I, I, P, I, P, I, I, I, I, I)
def filter_stage_planar_tiled_cuda(
    x: torch.Tensor,
    name: str,
    *,
    tile=None,
    h_pad: bool = True,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """One stage of any kind but gaussian over planar ``(N, H, W)`` uint8 on K5.

    The counterpart of one ``_tiled_point_kernel`` pass: sharpen, edge,
    median, erode, dilate, rank stages (size 3-9), registered kernel stages
    and point stages (LUTs included). ``h_pad``, ``tile`` and ``out`` as in
    :func:`gaussian_blur_planar_tiled_cuda`.
    """
    if name in tblur.GAUSSIANS:
        raise ValueError(f"{name} runs on K4: gaussian_blur_planar_tiled_cuda")
    _, ho, _ = check_planar_call(x, (name,), h_pad, None, out)
    tile = check_tile(tile)
    if x.device.type == "cpu":
        y = tblur.FILTERS[name](x, h_axis=-2, w_axis=-1, h_pad=h_pad)
        return y if out is None else out.copy_(y)
    return _stage_by_stage(x, (name,), ho, tile, out)


def filter_chain_planar_tiled_cuda(
    x: torch.Tensor,
    names: Sequence[str],
    *,
    tile=None,
    h_pad: bool = True,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """A chain over planar ``(N, H, W)`` uint8, stage by stage on K4 and K5.

    The counterpart of ``filter_chain_planar_tiled_pallas``, with
    ``hipe_tpu``'s valid mode too: with ``h_pad`` the output is ``(N, H,
    W)``, without it ``(N, H - 2R, W)``, R the chain's total radius. Every
    stage clamps at the true edges of its own input. ``tile`` is the
    kernels' launch knob; ``out``, if given, must not share memory with
    ``x``. Intermediates alternate between at most two buffers of this
    call, taken from torch's caching allocator on the current stream: no
    other call or stream shares them, and in steady state they come from
    its cache, not from a device allocation.
    """
    names, ho, _ = check_planar_call(x, names, h_pad, None, out)
    tile = check_tile(tile)
    if x.device.type == "cpu":
        y = tblur.filter_chain(x, names, h_axis=-2, w_axis=-1, h_pad=h_pad)
        return y if out is None else out.copy_(y)
    return _stage_by_stage(x, names, ho, tile, out)
