"""Fused chains on the card: wrapper of kernel K2 (``csrc/chain_planar.cu``).

The counterpart of ``hipe_tpu.ops.pallas_blur.filter_chain_planar_pallas``.
K2 stands for its fused kernel ``_chain_mxu_kernel`` (both band forms): it
runs a chain of gaussian3/5/7/9, sharpen, edge and point stages (invert,
solarize, posterize1-8, registered LUTs) over planar ``(N, H, W)`` uint8
with one read and one write, every stage an exact integer op. It takes no
other chain: one with a rank-family or registered-kernel stage runs K3
(:mod:`hipe_tpu_torch.ops.cuda_rank_chain`), as ``hipe_tpu`` sends it to
``_chain_kernel``; :func:`hipe_tpu_torch.ops.planar.filter_planar` routes
each chain.

:func:`filter_chain_rows_cuda` is K2's rows entry, the counterpart of
``filter_chain_rows_pallas``: the same band and point chains over
interleaved rows ``(B, H, W*C)``, a whole pixel clamped at the W edges.

For a CUDA tensor each wrapper launches its kernel or raises; for a CPU
tensor it runs the plain PyTorch chain
(:func:`hipe_tpu_torch.ops.blur.filter_chain`,
:func:`hipe_tpu_torch.ops.blur.filter_chain_rows`), which is also what the
kernels are held against on the card.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from hipe_tpu_torch.ops import _build
from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops._build import I, P
from hipe_tpu_torch.ops.chain_program import (check_planar_call, device_program, is_band_chain,
                                              table_args)


def _check_band_chain(names: tuple, entry: str, others: str) -> None:
    if not is_band_chain(names):
        raise ValueError(f"K2's {entry} entry takes band and point chains only, not "
                         f"{names}; other chains run {others}")


@_build.entry("hipe_chain_planar_u8", P, P, I, I, I, P, I, P, I, I, I)
def filter_chain_planar_cuda(
    x: torch.Tensor,
    names: Sequence[str],
    *,
    h_pad: bool = True,
    rows_per_block: int | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused band/point chain over planar ``(N, H, W)`` uint8.

    Every stage clamps at the edges of its own input; with ``h_pad`` the
    output is ``(N, H, W)``, without it ``(N, H - 2R, W)`` with R the
    chain's total radius (the valid interior). ``out``, if given, receives
    the result and must not share memory with ``x``. ``rows_per_block`` is
    the kernel's launch knob (output rows per thread block). K2 takes band
    chains only (:func:`~hipe_tpu_torch.ops.chain_program.is_band_chain`).
    """
    names, ho, rpb = check_planar_call(x, names, h_pad, rows_per_block, out)
    _check_band_chain(names, "planar", "K3 (Pipeline.apply_planar)")
    if x.device.type == "cpu":
        y = tblur.filter_chain(x, names, h_axis=-2, w_axis=-1, h_pad=h_pad)
        return y if out is None else out.copy_(y)
    n, h, w = x.shape
    prog, luts, _ = device_program(names, x.device, band=True)
    if out is None:
        out = torch.empty((n, ho, w), dtype=torch.uint8, device=x.device)
    filter_chain_planar_cuda.launch(
        x, lambda: f"chain_planar_u8 launch failed for {(n, h, w)} {names} "
                   f"h_pad={h_pad} rows_per_block={rpb}",
        x.data_ptr(), out.data_ptr(), n, h, w, ctypes.addressof(prog), len(names),
        *table_args(luts), int(h_pad), rpb)
    return out


@_build.entry("hipe_chain_rows_u8", P, P, I, I, I, I, P, I, P, I, I, I)
def filter_chain_rows_cuda(
    rows: torch.Tensor,
    channels: int,
    names: Sequence[str],
    *,
    h_pad: bool = True,
    rows_per_block: int | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused band/point chain over interleaved rows ``(B, H, W*C)`` uint8.

    K2's rows entry, the counterpart of ``filter_chain_rows_pallas``: it
    takes band chains only, as that entry does.
    Every stage clamps at the edges of its own input, a whole pixel at the
    W edges; ``h_pad``, ``rows_per_block`` and ``out`` as in
    :func:`filter_chain_planar_cuda`.
    """
    names, ho, rpb = check_planar_call(rows, names, h_pad, rows_per_block, out)
    _check_band_chain(names, "rows", "planar (Pipeline.apply_rows)")
    if channels < 1 or rows.shape[2] % channels:
        raise ValueError(f"rows {tuple(rows.shape)} are not (B, H, W*{channels})")
    if rows.device.type == "cpu":
        y = tblur.filter_chain_rows(rows, channels, names, h_pad=h_pad)
        return y if out is None else out.copy_(y)
    b, h, lanes = rows.shape
    prog, luts, _ = device_program(names, rows.device, band=True)
    if out is None:
        out = torch.empty((b, ho, lanes), dtype=torch.uint8, device=rows.device)
    filter_chain_rows_cuda.launch(
        rows, lambda: f"chain_rows_u8 launch failed for {(b, h, lanes)} C={channels} "
                      f"{names} h_pad={h_pad} rows_per_block={rpb}",
        rows.data_ptr(), out.data_ptr(), b, h, lanes // channels, channels,
        ctypes.addressof(prog), len(names), *table_args(luts), int(h_pad), rpb)
    return out
