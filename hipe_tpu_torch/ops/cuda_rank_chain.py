"""Rank-family and registered-kernel chains on the card: wrapper of kernel K3
(``csrc/rank_chain_planar.cu``).

The counterpart of ``hipe_tpu.ops.pallas_blur.filter_chain_planar_pallas``'s
non-MXU branch and its kernel ``_chain_kernel`` (both ``int16_ranks``
settings: a TPU packing knob that computes the same integers). K3 runs any
chain of stages over planar ``(N, H, W)`` uint8 with one read and one
write: median, erode, dilate, registered rank stages (``median5/7/9``,
``erode5``, ``dilate5``, ``--rank``), registered kernel stages (the
``pil_*`` presets, ``--kernel``), and every band and point stage of K2.
:func:`hipe_tpu_torch.ops.planar.filter_planar` sends it every chain that is
not a band chain. Its stage program is
:func:`hipe_tpu_torch.ops.chain_program.encode_program`'s.

For a CUDA tensor :func:`rank_chain_planar_cuda` launches K3 or raises; for
a CPU tensor it runs the plain PyTorch chain
(:func:`hipe_tpu_torch.ops.blur.filter_chain`), which is also what the
kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from hipe_tpu_torch.ops import _build
from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops._build import I, P
from hipe_tpu_torch.ops.chain_program import check_planar_call, device_program, table_args


@_build.entry("hipe_rank_chain_planar_u8", P, P, I, I, I, P, I, P, I, P, I, I, I)
def rank_chain_planar_cuda(
    x: torch.Tensor,
    names: Sequence[str],
    *,
    h_pad: bool = True,
    rows_per_block: int | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused chain of any stages over planar ``(N, H, W)`` uint8, through K3.

    The same call as :func:`hipe_tpu_torch.ops.cuda_chain.filter_chain_planar_cuda`:
    every stage clamps at the edges of its own input; with ``h_pad`` the
    output is ``(N, H, W)``, without it ``(N, H - 2R, W)``, R the chain's
    total radius. ``out``, if given, must not share memory with ``x``;
    ``rows_per_block`` is K3's launch knob.
    """
    names, ho, rpb = check_planar_call(x, names, h_pad, rows_per_block, out)
    if x.device.type == "cpu":
        y = tblur.filter_chain(x, names, h_axis=-2, w_axis=-1, h_pad=h_pad)
        return y if out is None else out.copy_(y)
    n, h, w = x.shape
    prog, luts, taps = device_program(names, x.device)
    if out is None:
        out = torch.empty((n, ho, w), dtype=torch.uint8, device=x.device)
    rank_chain_planar_cuda.launch(
        x, lambda: f"rank_chain_planar_u8 launch failed for {(n, h, w)} {names} "
                   f"h_pad={h_pad} rows_per_block={rpb}",
        x.data_ptr(), out.data_ptr(), n, h, w, ctypes.addressof(prog), len(names),
        *table_args(luts), *table_args(taps), int(h_pad), rpb)
    return out
